"""Mixture-of-Experts FFN with the reference's dispatch strategies.

The reference's ``repro/models/moe.py`` as torch ops:

* ``einsum``  — GShard-style one-hot dispatch/combine tensors ``[T, E, C]``;
  each expert's slots fill slot-major (slot 0 of every token first).
* ``sort``    — scatter dispatch: a stable argsort of the flattened ``[T*k]``
  experts, position-in-expert from segment arithmetic, unique-destination
  scatter into expert buffers; each expert's slots fill token-major.
* ``local``   — replicated-activation expert parallelism over the mesh's
  ``model`` axis: activations are data-sharded and replicated across
  ``model``, so the column that owns an expert already holds every token;
  each column routes its tokens locally, packs only its own experts' tokens
  (``_pack_local``) and the partial outputs are all-reduced over ``model``
  (the one collective).  The aux loss comes from each rank's own tokens,
  averaged over the data ranks, and the capacity is a column's, from its
  rank's token count, so drops depend on the mesh, as in the reference.
  With no mesh, a mesh of one rank, or the reference's other fall-back
  conditions, it is ``_moe_sort``.

Under a mesh of more than one rank, ``einsum`` and ``sort`` compute what
GSPMD computes for the reference: over every rank's tokens (gathered over
the data axes; each rank keeps its own rows, the gradient of the gathered
tokens reduce-scattered) with every expert (gathered over ``model``).

All share capacity semantics: per-expert buffer ``C = ceil(T*k/E * cf)``
(rounded up to a multiple of 8, at least 8); overflow tokens are dropped.
Under overflow the two orders drop different (token, slot) pairs;
``dropped_slots`` says which.  The top-k keeps ``jax.lax.top_k``'s order: a
stable descending sort, so on ties the lower expert index comes first.
Products of the model dtype with float32 results follow
``layers._dot_f32``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Literal, NamedTuple

import torch
import torch.nn.functional as F

from ..launch.mesh import current_mesh
from ..parallel.collectives import all_gather, all_reduce, copy_to, fsdp_gather, gather_from, reduce_from
from ..parallel.sharding import data_axes
from .layers import _dot_f32, dense_init

__all__ = ["MoEConfig", "init_moe_params", "moe_ffn", "dropped_slots"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    dispatch: Literal["einsum", "sort", "local"] = "einsum"


def moe_layout(d_model: int, cfg: MoEConfig, lead: tuple[int, ...] = ()) -> dict:
    """The MoE parameter tree as ``("dense", shape, scale, dtype)`` entries
    (``dtype`` None: the model's), each shape after the ``lead`` axes: the
    router in float32, the experts in the model dtype."""
    e, d, f = cfg.n_experts, d_model, cfg.d_ff
    p = {
        "router": ("dense", (*lead, d, e), None, torch.float32),
        "w_gate": ("dense", (*lead, e, d, f), None, None),
        "w_up": ("dense", (*lead, e, d, f), None, None),
        "w_down": ("dense", (*lead, e, f, d), None, None),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": ("dense", (*lead, d, fs), None, None),
            "w_up": ("dense", (*lead, d, fs), None, None),
            "w_down": ("dense", (*lead, fs, d), None, None),
        }
    return p


def init_moe_params(gen: torch.Generator, d_model: int, cfg: MoEConfig, dtype=torch.bfloat16) -> dict:
    """Random MoE parameters from ``gen`` (on its device): N(0, fan_in **
    -0.5); the router in float32, the experts in ``dtype``."""

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        _, shape, scale, dt = node
        return dense_init(gen, shape, dt or dtype, scale=scale)

    return build(moe_layout(d_model, cfg))


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, (c + 7) // 8 * 8)


def _router(x2d: torch.Tensor, params) -> tuple[torch.Tensor, torch.Tensor]:
    """Softmax gates [T, E] in float32, and their mean over the tokens (the
    Switch load-balancing loss's ``me``)."""
    gates = torch.softmax(x2d.float() @ params["router"], dim=-1)
    return gates, gates.mean(dim=0)


def _top_k(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` (lower index first on ties), the weights
    renormalised over the k: ``(w_topk, e_topk)``, each [T, k]."""
    w, e = torch.sort(gates, dim=-1, descending=True, stable=True)
    w, e = w[:, :k], e[:, :k]
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9), e


def _einsum_slots(e_topk: torch.Tensor, n_experts: int):
    """Per slot ``s``: the [T, E] one-hot of its experts and each token's
    position in its expert, filling slot-major (every token's slot 0 first)."""
    base = torch.zeros((n_experts,), dtype=torch.float32, device=e_topk.device)
    for s in range(e_topk.shape[1]):  # static unroll over slots
        onehot = F.one_hot(e_topk[:, s], n_experts).float()
        pos = torch.cumsum(onehot, dim=0) - 1.0 + base[None, :]
        base = base + onehot.sum(dim=0)
        yield s, onehot, (pos * onehot).sum(dim=-1)


def _sort_slots(keys: torch.Tensor, n: int, c: int):
    """The stable argsort of the flat [T*k] expert ids ``keys`` (ids >= ``n``
    sort last and are never kept): ``(order, valid, dest)`` in sorted
    order, ``dest`` the row of each kept pair in the ``[n*C, D]`` buffer
    (0 for the dropped)."""
    order = torch.argsort(keys, stable=True)
    k_s = keys[order]
    counts = torch.bincount(keys, minlength=n + 1)
    seg_start = torch.cumsum(counts, dim=0) - counts  # exclusive
    pos_in_e = torch.arange(keys.numel(), device=keys.device) - seg_start[k_s]
    valid = (pos_in_e < c) & (k_s < n)
    return order, valid, torch.where(valid, k_s * c + pos_in_e, 0)


def _experts(bufe: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU of each expert over its [C, D] buffer: [E, C, D] in float32."""
    g = _dot_f32(bufe, w_gate)
    u = _dot_f32(bufe, w_up)
    h = (F.silu(g) * u).to(bufe.dtype)
    return _dot_f32(h, w_down)


def _sorted_pass(x2d, tok_s, w_s, valid, dest, w_gate, w_up, w_down, c: int) -> torch.Tensor:
    """Pack the kept (token, slot) pairs into the experts' buffers, run the
    experts, and add each pair's weighted output back to its token: [T, D]
    in float32.  Dropped pairs add zeros to buffer row 0 and nothing to
    their token."""
    t, d = x2d.shape
    n_e = w_gate.shape[0]
    vals = x2d[tok_s] * valid[:, None].to(x2d.dtype)
    buf = torch.zeros((n_e * c, d), dtype=x2d.dtype, device=x2d.device).index_add(0, dest, vals)
    ye = _experts(buf.view(n_e, c, d), w_gate, w_up, w_down)
    y_s = ye.reshape(n_e * c, d)[dest] * (valid * w_s)[:, None]
    return torch.zeros((t, d), dtype=torch.float32, device=x2d.device).index_add(0, tok_s, y_s)


def _moe_einsum(x2d: torch.Tensor, params, cfg: MoEConfig):
    t, d = x2d.shape
    e, c = cfg.n_experts, _capacity(t, cfg)
    gates, me = _router(x2d, params)
    # identical selection + normalization across all dispatch strategies
    w_topk, e_topk = _top_k(gates, cfg.top_k)
    dispatch = torch.zeros((t, e, c), dtype=x2d.dtype, device=x2d.device)
    combine = torch.zeros((t, e, c), dtype=torch.float32, device=x2d.device)
    ce = torch.zeros((e,), dtype=torch.float32, device=x2d.device)
    for s, onehot, pos_tok in _einsum_slots(e_topk, e):
        ce = ce + onehot.mean(dim=0)
        valid = pos_tok < c
        # a position past the capacity is masked by ``valid`` (jax's
        # one_hot of it is all zeros)
        pos_oh = F.one_hot(pos_tok.long().clamp(max=c - 1), c).float()
        slot = onehot[:, :, None] * pos_oh[:, None, :] * valid[:, None, None]
        dispatch = dispatch + slot.to(x2d.dtype)
        combine = combine + slot * w_topk[:, s, None, None]

    xe = torch.einsum("tec,td->ecd", dispatch, x2d)
    ye = _experts(xe, params["w_gate"], params["w_up"], params["w_down"])
    y = combine.to(x2d.dtype).reshape(t, e * c) @ ye.to(x2d.dtype).reshape(e * c, d)
    aux = cfg.n_experts * torch.sum(me * (ce / cfg.top_k))
    return y.to(x2d.dtype), aux


def _moe_sort(x2d: torch.Tensor, params, cfg: MoEConfig):
    t, _ = x2d.shape
    e, k = cfg.n_experts, cfg.top_k
    c = _capacity(t, cfg)
    gates, me = _router(x2d, params)
    w_topk, e_topk = _top_k(gates, k)

    e_flat = e_topk.reshape(-1)  # [T*k]
    tok_flat = torch.arange(t, device=x2d.device).repeat_interleave(k)
    order, valid, dest = _sort_slots(e_flat, e, c)
    y = _sorted_pass(x2d, tok_flat[order], w_topk.reshape(-1)[order], valid, dest,
                     params["w_gate"], params["w_up"], params["w_down"], c)

    ce = torch.bincount(e_flat, minlength=e).float() / (t * k)
    aux = cfg.n_experts * torch.sum(me * ce)
    return y.to(x2d.dtype), aux


def _pack_local(x_loc, w_gate, w_up, w_down, gates, cfg: MoEConfig, col: int, n_cols: int) -> torch.Tensor:
    """One model column's expert compute: pack the tokens of the column's
    experts (``w_gate.shape[0]`` of them, from expert ``col *
    w_gate.shape[0]``), run them, and scatter back.  Returns the column's
    partial output [T, D] in float32; the reference sums it over the
    ``n_cols`` columns (``psum``).  The reference reads ``col`` from the
    mesh (``axis_index``)."""
    t_loc, _ = x_loc.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc = w_gate.shape[0]  # experts owned by this column
    lo = col * e_loc
    w_topk, e_topk = _top_k(gates, k)
    e_flat = e_topk.reshape(-1)
    tok_flat = torch.arange(t_loc, device=x_loc.device).repeat_interleave(k)
    mine = (e_flat >= lo) & (e_flat < lo + e_loc)
    le = torch.where(mine, e_flat - lo, e_loc)  # sentinel e_loc sorts last
    c = max(8, int(t_loc * k / e * cfg.capacity_factor + 7) // 8 * 8)
    order, valid, dest = _sort_slots(le, e_loc, c)
    return _sorted_pass(x_loc, tok_flat[order], w_topk.reshape(-1)[order], valid, dest, w_gate, w_up, w_down, c)


class _ScaleGrad(torch.autograd.Function):
    """Forward identity, backward the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _Mesh(NamedTuple):
    mesh: Any
    da: Any  # the data axes
    n_data: int
    n_cols: int  # the model axis's size


def _mesh_of() -> _Mesh | None:
    """The current mesh and its data and model sizes; None with no mesh or
    a mesh of one rank."""
    mesh = current_mesh()
    if mesh is None or mesh.size == 1:
        return None
    da = data_axes(mesh)
    n_cols = mesh.axis_size("model") if "model" in mesh.axis_names else 1
    return _Mesh(mesh, da, mesh.axis_size(da), n_cols)


def _local_columns(cfg: MoEConfig, m) -> bool:
    """The reference's conditions for the ``shard_map`` path: a ``model``
    axis, and experts that tile it.  (Its third, tokens that tile the data
    axes, always holds here: a rank's tokens are its share of a batch the
    step splits evenly.)"""
    if m is None or "model" not in m.mesh.axis_names:
        return False
    return cfg.n_experts % m.n_cols == 0


def _moe_local(x2d: torch.Tensor, params, cfg: MoEConfig):
    """Replicated-activation EP: route locally, all-reduce the partial
    outputs over ``model``."""
    m = _mesh_of()
    if m is None:
        return _moe_sort(x2d, params, cfg)  # single-device fallback
    if not _local_columns(cfg, m):
        return _global(_moe_sort, x2d, params, cfg, m)
    mesh, da, n_data, n_cols = m
    col = mesh.coord("model") if n_cols > 1 else 0
    gates = torch.softmax(x2d.float() @ params["router"], dim=-1)
    # the column's work differs along `model`: its inputs' gradients are
    # summed over the columns
    y = _pack_local(copy_to(x2d, mesh, "model"), params["w_gate"], params["w_up"], params["w_down"],
                    copy_to(gates, mesh, "model"), cfg, col, n_cols)
    # the ONLY collective: combine per-column partial outputs
    y = reduce_from(y, mesh, "model")
    # Switch aux loss from local statistics (identical in expectation); the
    # columns' are equal (replicated activations), so its mean over `model`
    # is itself, and it is averaged over the data ranks
    me = gates.mean(dim=0)
    _, e_topk = _top_k(gates, cfg.top_k)
    ce = torch.bincount(e_topk.reshape(-1), minlength=cfg.n_experts).float() / (x2d.shape[0] * cfg.top_k)
    aux = cfg.n_experts * torch.sum(me * ce)
    aux = reduce_from(aux, mesh, da) / n_data
    return y.to(x2d.dtype), aux


def _global(fn, x2d: torch.Tensor, params, cfg: MoEConfig, m):
    """``fn`` (``_moe_sort`` or ``_moe_einsum``) as GSPMD runs it for the
    reference under a mesh: over every data rank's tokens with every
    expert; this rank's rows of the output.  The aux loss, computed alike on
    every data rank, has its gradient divided among them."""
    mesh, da, n_data, n_cols = m
    if params["w_gate"].shape[0] < cfg.n_experts:  # experts split over `model`
        params = {**params, **{k: gather_from(params[k], mesh, "model", 0) for k in ("w_gate", "w_up", "w_down")}}
    if n_data == 1:
        return fn(x2d, params, cfg)
    t = x2d.shape[0]
    y, aux = fn(fsdp_gather(x2d, mesh, da, 0), params, cfg)
    return y[mesh.coord(da) * t:(mesh.coord(da) + 1) * t], _ScaleGrad.apply(aux, 1.0 / n_data)


def dropped_slots(x: torch.Tensor, params, cfg: MoEConfig) -> torch.Tensor:
    """The (token, slot) pairs ``moe_ffn`` drops for overflowing their
    expert's capacity: a [B*S, k] bool, True where dropped, in the order
    ``cfg.dispatch`` fills the slots (``local``: ``sort``'s, per column
    under a mesh).  Under a mesh, of this rank's tokens, for the mesh it
    runs under."""
    x2d = x.reshape(-1, x.shape[-1])
    m = _mesh_of()
    with torch.no_grad():
        if cfg.dispatch == "local" and _local_columns(cfg, m):
            mesh, _, _, n_cols = m
            t, k = x2d.shape[0], cfg.top_k
            e_loc = cfg.n_experts // n_cols
            lo = (mesh.coord("model") if n_cols > 1 else 0) * e_loc
            _, e_topk = _top_k(_router(x2d, params)[0], k)
            e_flat = e_topk.reshape(-1)
            mine = (e_flat >= lo) & (e_flat < lo + e_loc)
            c = max(8, int(t * k / cfg.n_experts * cfg.capacity_factor + 7) // 8 * 8)
            order, valid, _ = _sort_slots(torch.where(mine, e_flat - lo, e_loc), e_loc, c)
            dropped = torch.empty_like(valid)
            dropped[order] = ~valid
            # each pair is its expert's column's to judge
            mine_dropped = (dropped & mine).to(torch.int32)
            return all_reduce(mine_dropped, mesh, "model").bool().view(t, k)
        if m is not None and m.n_data > 1:
            mesh, da = m.mesh, m.da
            t = x2d.shape[0]
            full = _dropped_single(all_gather(x2d, mesh, da, 0), params, cfg)
            return full[mesh.coord(da) * t:(mesh.coord(da) + 1) * t]
        return _dropped_single(x2d, params, cfg)


def _dropped_single(x2d: torch.Tensor, params, cfg: MoEConfig) -> torch.Tensor:
    t = x2d.shape[0]
    c = _capacity(t, cfg)
    _, e_topk = _top_k(_router(x2d, params)[0], cfg.top_k)
    if cfg.dispatch == "einsum":
        return torch.stack([pos >= c for _, _, pos in _einsum_slots(e_topk, cfg.n_experts)], dim=1)
    order, valid, _ = _sort_slots(e_topk.reshape(-1), cfg.n_experts, c)
    dropped = torch.empty_like(valid)
    dropped[order] = ~valid
    return dropped.view(t, cfg.top_k)


def _shared(x2d: torch.Tensor, sp, cfg: MoEConfig, m) -> torch.Tensor:
    """The shared experts' output (float32): column- then row-split over
    ``model`` when their hidden dim is split."""
    tp = m is not None and sp["w_gate"].shape[-1] < cfg.d_ff * cfg.n_shared_experts
    xin = copy_to(x2d, m.mesh, "model") if tp else x2d
    g = _dot_f32(xin, sp["w_gate"])
    u = _dot_f32(xin, sp["w_up"])
    h = (F.silu(g) * u).to(x2d.dtype)
    y = _dot_f32(h, sp["w_down"])
    return reduce_from(y, m.mesh, "model") if tp else y


def moe_ffn(x: torch.Tensor, params, cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y, aux_loss)."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    m = _mesh_of()
    if cfg.dispatch == "local":
        y, aux = _moe_local(x2d, params, cfg)
    else:
        fn = _moe_sort if cfg.dispatch == "sort" else _moe_einsum
        y, aux = fn(x2d, params, cfg) if m is None else _global(fn, x2d, params, cfg, m)
    if cfg.n_shared_experts:
        y = y + _shared(x2d, params["shared"], cfg, m).to(x2d.dtype)
    return y.reshape(b, s, d), aux
