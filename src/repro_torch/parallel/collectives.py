"""The collectives of the sharded paths, over a mesh's axes.

The reference's collectives are XLA's: ``psum``/``all_gather`` inside a
``shard_map``, or the ones GSPMD inserts.  The port's are
``torch.distributed``'s (NCCL on the card, gloo on the CPU), called on the
process group of a :class:`~repro_torch.launch.mesh.DeviceMesh`'s axes.  A
collective over a group of one rank is skipped, as XLA elides a one-device
collective, so a world of one rank runs exactly the ops of no mesh.

Gathers and scatters keep the group's rank order, which is the axes'
coordinate order.  The autograd operators are the two of Megatron-LM's
tensor parallelism and the FSDP gather:

* :func:`copy_to` (Megatron's ``f``) — forward identity, backward all-reduce:
  where a tensor replicated on an axis enters work that differs along it;
* :func:`reduce_from` (``g``) — forward all-reduce, backward identity: where
  that work's partial results are summed into a replicated tensor;
* :func:`gather_from` — forward all-gather, backward this rank's slice: a
  replicated result assembled from per-rank pieces;
* :func:`fsdp_gather` — forward all-gather, backward reduce-scatter: a
  weight sharded over ``data`` gathered at use (ZeRO's per-layer gather;
  the reduce-scatter sums the data ranks' gradients).

``torch.distributed.nn.functional.all_reduce`` all-reduces in its backward
too, which on a row-parallel output would multiply the gradient by the
axis's size; :func:`reduce_from` does not.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = [
    "all_reduce",
    "all_gather",
    "reduce_scatter",
    "copy_to",
    "reduce_from",
    "gather_from",
    "fsdp_gather",
]


def all_reduce(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``axes`` (a new tensor; ``x`` is not written)."""
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=mesh.group(axes))
    return out


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in coordinate order."""
    n = 1 if mesh is None else mesh.axis_size(axes)
    if n == 1:
        return x
    dim = dim % x.dim()
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * front.shape[0], *front.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, front, group=mesh.group(axes))
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """``x`` summed over ``axes``, and this rank's block of it along ``dim``
    (``dim``'s extent divided by the axes' size)."""
    n = 1 if mesh is None else mesh.axis_size(axes)
    if n == 1:
        return x
    dim = dim % x.dim()
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((front.shape[0] // n, *front.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, front, group=mesh.group(axes))
    return out.movedim(0, dim)


def _slice(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    n = mesh.axis_size(axes)
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.coord(axes) * size, size).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def _trivial(mesh, axes) -> bool:
    return mesh is None or mesh.axis_size(axes) == 1


def copy_to(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    return x if _trivial(mesh, axes) else _CopyTo.apply(x, mesh, axes)


def reduce_from(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    return x if _trivial(mesh, axes) else _ReduceFrom.apply(x, mesh, axes)


def gather_from(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    return x if _trivial(mesh, axes) else _GatherFrom.apply(x, mesh, axes, dim % x.dim())


def fsdp_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    return x if _trivial(mesh, axes) else _FsdpGather.apply(x, mesh, axes, dim % x.dim())
