"""Per-device cost of one run of a program: flops, HBM bytes, collectives.

The counterpart of the reference's ``launch/hlo_analysis.py``.  The
reference parses the compiled, partitioned HLO and charges each instruction
(``_instr_cost``), multiplying loop bodies by their trip counts.  The port
compiles nothing: :func:`count_cost` runs a function once under a
``TorchDispatchMode`` and charges each aten op as it is dispatched, by the
same rules.  Eager ops run once each, so a Python loop is counted by its
trips, as the reference's trip-count rule counts a ``while``.

  ============================================  ========================  =============================
  ops                                           flops                     bytes
  ============================================  ========================  =============================
  ``mm``/``bmm``/``addmm``/``baddbmm``/conv      2 x numel(out) x K        result + operands
  elementwise (``pointwise``-tagged and kin)    numel(out)                result + operands
  reductions, scatters, gathers, ``index_*``    max(numel in, numel out)  result + operands; gathers and
                                                                          slices read what they write
                                                                          (2 x result); an in-place
                                                                          update (``index_add_``,
                                                                          ``index_put_``, ``copy_``)
                                                                          twice the update, and its
                                                                          work is the update's elements
  sorts (``sort``, ``topk``, ``unique``)        n x ceil(log2 n), n the   result + operands
                                                input's elements
  views, allocations, scalar reads              free                      free
  fills (``zeros``, ``fill_``, ``arange``)      0                         result
  anything else (``cat``, ``clone``, ...)       0                         result + operands
  ============================================  ========================  =============================

A copy between the host and the card moves no HBM bytes of the program and
is free, so a program counts the same on the card and on the CPU, where
such a copy does not happen.  The three hand-written kernels are ``ctypes``
launches, which the mode cannot see: each wrapper charges its own bytes and
work (the figures its roofline bound is computed from) through
:func:`kernel_cost`, and the mode charges nothing inside it, so the plain
version a CPU tensor takes counts the same as the kernel.

A collective (a ``c10d`` op, as ``torch.distributed`` dispatches it on
gloo and NCCL alike) is charged, besides its bytes, to ``collectives`` by
its result bytes under the reference's names (``analyze_hlo``):
``allreduce_`` as ``all-reduce``, ``_allgather_base_`` as ``all-gather``, ``_reduce_scatter_base_`` as ``reduce-scatter``,
``alltoall_base_`` as ``all-to-all``.  Only a group of more than one rank is
charged, as XLA elides a one-device collective; with no mesh, nothing is
collective and ``collectives`` stays empty.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves

__all__ = ["ProgramCost", "CostCounter", "collective_cost", "count_cost", "kernel_cost", "op_cost"]


@dataclasses.dataclass
class ProgramCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, other: "ProgramCost", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        for k, v in other.collectives.items():
            self.collectives[k] = self.collectives.get(k, 0.0) + v * mult

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())


_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot", "convolution"}
_SORT = {"sort", "argsort", "msort", "topk", "kthvalue", "_unique2", "unique_dim", "unique_consecutive"}
# in-place updates: the position of the update among the op's arguments
_UPDATES = {"index_add_": 3, "index_copy_": 3, "index_reduce_": 3, "scatter_": 3, "scatter_add_": 3,
            "scatter_reduce_": 3, "index_put_": 2, "_index_put_impl_": 2, "masked_scatter_": 2, "copy_": 1}
_GATHERS = {"index_select", "gather", "index", "take", "take_along_dim", "embedding", "masked_select",
            "narrow_copy", "slice_copy", "select_copy", "diagonal_copy"}
_REDUCTIONS = {"_softmax", "_log_softmax", "cumsum", "cumprod", "logcumsumexp", "cummax", "cummin",
               "nll_loss_forward", "nll_loss_backward", "embedding_dense_backward", "_embedding_bag",
               "_embedding_bag_forward_only", "scatter", "scatter_add", "scatter_reduce", "index_add",
               "index_reduce", "index_copy", "index_fill", "searchsorted", "bucketize", "bincount", "histc",
               "native_layer_norm", "native_layer_norm_backward", "native_group_norm", "native_batch_norm"}
_ELEMENTWISE = {"leaky_relu_backward", "elu_backward", "gelu_backward", "_softmax_backward_data",
                "_log_softmax_backward_data", "normal", "uniform", "random", "bernoulli", "exponential",
                "masked_fill", "clamp", "clip", "lerp", "addcmul", "addcdiv"}
_FILLS = {"fill", "zero", "zeros", "ones", "full", "zeros_like", "ones_like", "full_like", "new_zeros",
          "new_ones", "new_full", "arange", "linspace", "scalar_tensor", "eye"}
_FREE = {"detach", "alias", "lift_fresh", "_unsafe_view", "_reshape_alias", "empty", "empty_like",
         "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense", "_pin_memory", "set",
         "resize", "record_stream", "_conj", "_neg_view", "is_pinned"}
_COPIES = {"clone", "copy", "lift_fresh_copy", "_to_copy"}


_COLLECTIVES = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
                "_reduce_scatter_base_": "reduce-scatter", "alltoall_base_": "all-to-all"}


def collective_cost(func, args: tuple) -> tuple[str, float] | None:
    """(the reference's name, result bytes) of a ``c10d`` collective over a
    group of more than one rank; None for anything else."""
    if func.namespace != "c10d":
        return None
    name = func.overloadpacket.__name__
    if name not in _COLLECTIVES:
        return None
    import torch.distributed as dist

    size = None
    for a in args:
        if isinstance(a, torch._C.ScriptObject):
            try:
                size = dist.ProcessGroup.unbox(a).size()
                break
            except RuntimeError:  # another custom class (a ReduceOp)
                continue
    if size is None or size <= 1:
        return None
    # each writes its result into its first argument
    return _COLLECTIVES[name], float(_nbytes(_tensors(args[0])))


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _tensors(x) -> list[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _kind(func) -> str:
    name = func.overloadpacket.__name__
    base = name[:-1] if name.endswith("_") and not name.endswith("__") else name
    if func.is_view or base in _FREE:
        return "free"
    if base in _MATMUL:
        return "matmul"
    if base in _SORT:
        return "sort"
    if name in _UPDATES:
        return "update"
    if base in _GATHERS:
        return "gather"
    if base in _REDUCTIONS or torch.Tag.reduction in func.tags:
        return "reduction"
    if base in _FILLS:
        return "fill"
    if base in _COPIES:
        return "copy"
    if base in _ELEMENTWISE or torch.Tag.pointwise in func.tags:
        return "elementwise"
    return "other"


_KINDS: dict[Any, str] = {}


def _contraction(base: str, ins: list[torch.Tensor]) -> int:
    """K of a product: the first operand's last dimension (``addmm`` and
    ``baddbmm`` take the bias first), a convolution's weight per output
    channel, a dot product's length."""
    if base == "convolution":
        w = ins[1]
        return w.numel() // w.shape[0]
    if base in ("dot", "vdot"):
        return ins[0].numel()
    lhs = ins[1] if base in ("addmm", "baddbmm", "addbmm", "addmv") else ins[0]
    return lhs.shape[-1]


def op_cost(func, args: tuple, kwargs: dict, out: Any) -> tuple[float, float]:
    """(flops, HBM bytes) of one dispatched aten op (see the module
    docstring)."""
    kind = _KINDS.get(func)
    if kind is None:
        kind = _KINDS[func] = _kind(func)
    if kind == "free":
        return 0.0, 0.0
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    if kind == "copy" or kind == "update" and func.overloadpacket.__name__ == "copy_":
        src = ins[1] if kind == "update" else ins[0]
        dst = outs[0] if outs else src
        if src.dtype != dst.dtype:
            kind = "elementwise"  # a conversion, on whichever device
        elif src.device != dst.device:
            return 0.0, 0.0  # host <-> card: no HBM traffic of the program
        elif kind == "copy":
            return 0.0, float(_nbytes(outs) + _nbytes(ins))
    n_out = sum(t.numel() for t in outs)
    if kind == "matmul":
        name = func.overloadpacket.__name__
        return 2.0 * n_out * _contraction(name.rstrip("_"), ins), float(_nbytes(outs) + _nbytes(ins))
    if kind == "elementwise":
        return float(n_out), float(_nbytes(outs) + _nbytes(ins))
    if kind == "sort":
        n = ins[0].numel()
        return float(n * max(1, math.ceil(math.log2(max(n, 2))))), float(_nbytes(outs) + _nbytes(ins))
    if kind == "update":
        pos = _UPDATES[func.overloadpacket.__name__]
        upd = args[pos] if pos < len(args) else None
        if not isinstance(upd, torch.Tensor):  # a scalar written at every index
            upd = args[2] if len(args) > 2 and isinstance(args[2], torch.Tensor) else outs[0]
        flops = 0.0 if func.overloadpacket.__name__ == "copy_" else float(upd.numel())
        return flops, 2.0 * _nbytes([upd])
    if kind == "gather":
        return float(max(n_out, ins[0].numel() if ins else 0)), 2.0 * _nbytes(outs)
    if kind == "reduction":
        return float(max(n_out, ins[0].numel() if ins else 0)), float(_nbytes(outs) + _nbytes(ins))
    if kind == "fill":
        return 0.0, float(_nbytes(outs))
    return 0.0, float(_nbytes(outs) + _nbytes(ins))


class CostCounter(TorchDispatchMode):
    """Charges every aten op dispatched while it is active to ``cost``;
    nothing while a kernel wrapper charges its own (``kernel_cost``).
    ``by_op`` keeps the charges by op name (the kernels' under
    ``"kernels"``): ``[calls, flops, bytes]``."""

    def __init__(self):
        super().__init__()
        self.cost = ProgramCost()
        self.by_op: dict[str, list[float]] = {}
        self.suspended = 0

    def charge(self, name: str, flops: float, nbytes: float) -> None:
        self.cost.flops += flops
        self.cost.hbm_bytes += nbytes
        entry = self.by_op.setdefault(name, [0, 0.0, 0.0])
        entry[0] += 1
        entry[1] += flops
        entry[2] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.suspended:
            self.charge(str(func), *op_cost(func, args, kwargs, out))
            coll = collective_cost(func, args)
            if coll is not None:
                self.cost.collectives[coll[0]] = self.cost.collectives.get(coll[0], 0.0) + coll[1]
        return out


def _active() -> CostCounter | None:
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCounter):
            return mode
    return None


@contextlib.contextmanager
def kernel_cost(figures: Callable[[], tuple[float, float]]):
    """Inside a hand-written kernel's wrapper: when a counter is active,
    charge it ``figures()`` (flops, bytes) once, and nothing else the
    wrapper dispatches (the launch's own set-up, or the plain version a CPU
    tensor takes); no-op otherwise."""
    counter = _active()
    if counter is None:
        yield
        return
    counter.suspended += 1
    try:
        counter.charge("kernels", *figures())
        yield
    finally:
        counter.suspended -= 1


def count_cost(fn: Callable, *args, **kwargs) -> tuple[Any, ProgramCost]:
    """``fn(*args, **kwargs)`` run once under a :class:`CostCounter`: its
    result and the program's cost on the device its tensors lie on."""
    counter = CostCounter()
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.cost
