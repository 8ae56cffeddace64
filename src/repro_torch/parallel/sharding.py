"""Per-architecture sharding rules, and the slices they give each rank.

The reference's ``repro/parallel/sharding.py`` (and ``sanitize_specs`` of
its ``launch/steps.py``).  Conventions (DESIGN.md §4):

* ``data``  — batch / tokens / edges / queries; gradient all-reduce axis.
* ``model`` — TP: attention heads & FFN hidden; EP: MoE experts; embedding-
  table rows (recsys); head-dim for KV caches (uniform across kv-head counts).
* ``pod``   — outermost DP axis (multi-pod); composed with ``data`` for batch
  dims via ``("pod", "data")``.

A spec is a :class:`P`: per dim an axis name, a tuple of names, or ``None``
(the reference's ``PartitionSpec``).  Rules are name-keyed over the param
tree by the reference's path strings (``layers/moe/w_gate``; a list's
entries by index), so they survive arbitrary nesting; anything unmatched is
replicated.  The reference hands specs to GSPMD (``named_tree``); the port
cuts each rank's slice of a full tree with :func:`shard_tree` and puts it
back together with :func:`gather_tree`.  A mesh here is anything with
``axis_names`` and ``shape`` (a ``DeviceMesh`` or a ``MeshLayout``).
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from ..tree import tree_flatten, tree_leaves, tree_unflatten
from .collectives import all_gather, fsdp_gather

__all__ = [
    "P",
    "lm_param_specs",
    "lm_cache_spec",
    "recsys_param_specs",
    "gnn_specs",
    "batch_specs",
    "opt_state_specs",
    "data_axes",
    "sanitize_specs",
    "spec_axes",
    "shard_tree",
    "gather_tree",
    "fsdp_gather_layer",
    "map_with_path",
]


class P:
    """A partition spec: one entry per leading dim (an axis name, a tuple of
    names, or ``None``); dims past its length are replicated."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        self.dims = tuple(tuple(d) if isinstance(d, list) else d for d in dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self) -> int:
        return len(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.dims == other.dims

    def __hash__(self) -> int:
        return hash(self.dims)

    def __repr__(self) -> str:
        return f"P{self.dims!r}"


def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: P) -> set[str]:
    """Every mesh axis the spec shards some dim over."""
    return {a for d in spec for a in _axes_of(d)}


def data_axes(mesh):
    """Batch axis spec: ('pod','data') on the multi-pod mesh, else 'data'."""
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """``jax.tree_util.tree_map_with_path`` with the reference's path
    strings: ``fn(path, leaf)`` over dicts (keys), lists and tuples
    (indices)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


# ---------------------------------------------------------------------------
# LM transformer
# ---------------------------------------------------------------------------


def _lm_rule(name: str, ndim: int, kv_shardable: bool = True, fsdp: bool = True) -> P:
    """TP over `model`; FSDP/ZeRO over `data` on a second dim (the layer's
    weights are gathered at use, ``fsdp_gather_layer``)."""
    dp = "data" if fsdp else None
    # stacked layer params carry a leading L axis (never sharded)
    if name.endswith("embed"):  # [V, D] -> rows on data, D on model
        return P(dp, "model")
    if name.endswith("unembed"):  # [D, V] -> V on model (sharded logits)
        return P(dp, "model")
    if name.endswith("wq"):  # [L, D, Hq*Dh]
        return P(None, dp, "model")
    if name.endswith("wk") or name.endswith("wv"):  # [L, D, Hkv*Dh]
        # replicate KV projections over `model` when Hkv doesn't divide the
        # TP axis (each rank computes the kv heads of its own q heads)
        return P(None, dp, "model") if kv_shardable else P(None, dp, None)
    if name.endswith("wo"):  # [L, H*Dh, D]
        return P(None, "model", dp)
    if name.endswith("w_gate") or name.endswith("w_up"):
        if ndim == 4:  # moe experts [L, E, D, F] -> expert parallel + FSDP
            return P(None, "model", dp, None)
        if ndim == 3:  # dense [L, D, F] -> tensor parallel + FSDP
            return P(None, dp, "model")
        return P(dp, "model")  # shared expert [D, F]
    if name.endswith("w_down"):
        if ndim == 4:  # [L, E, F, D]
            return P(None, "model", dp, None)
        if ndim == 3:  # [L, F, D]
            return P(None, "model", dp)
        return P("model", dp)  # shared expert [F, D]
    if name.endswith("router"):  # [L, D, E]
        return P()
    return P()  # norms etc. replicated


def lm_param_specs(param_shapes: Any, kv_shardable: bool = True, fsdp: bool = True) -> Any:
    return map_with_path(lambda path, leaf: _lm_rule(path, len(leaf.shape), kv_shardable, fsdp), param_shapes)


def lm_cache_spec() -> P:
    """KV cache [L, B, S, Hkv, Dh]: batch on data, head-dim on model
    (uniform: every assigned arch has Dh % 16 == 0, unlike Hkv)."""
    return P(None, "data", None, None, "model")


def fsdp_gather_layer(layer: Any, specs: Any, mesh) -> Any:
    """Per-layer FSDP all-gather at use (inside the layer's checkpoint).

    Each leaf of one layer (no leading L dim) sharded over ``data`` is
    all-gathered over ``data`` on that dim (only ``data``: the weights are
    replicated across pods); the gather's backward is the reduce-scatter of
    the gradient — exactly ZeRO.  ``specs`` are the layer's specs as the
    leaves are sharded (the stacked specs with the L dim dropped, after
    :func:`sanitize_specs`, where the reference re-derives them from the
    rule), over ``mesh``."""

    def fix(x: torch.Tensor, spec: P) -> torch.Tensor:
        dims = _dims(spec, x.dim())
        if "data" not in dims:
            return x
        return fsdp_gather(x, mesh, "data", dims.index("data"))

    leaves, treedef = tree_flatten(layer)
    return tree_unflatten(treedef, [fix(x, s) for x, s in zip(leaves, tree_leaves(specs))])


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------


def _recsys_rule(name: str, ndim: int) -> P:
    if name.endswith("table"):  # [V, D] — THE memory: row-sharded
        return P("model", None)
    if name.endswith("w_linear"):  # FM [V]
        return P("model")
    if name.endswith("cross_w"):  # [C, X, X]
        return P(None, None, "model")
    if name.endswith("/w") or name.endswith("w_out"):  # MLP [in, out]
        return P(None, "model") if ndim == 2 else P()
    return P()


def recsys_param_specs(param_shapes: Any) -> Any:
    return map_with_path(lambda path, leaf: _recsys_rule(path, len(leaf.shape)), param_shapes)


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------


def gnn_specs(batch_shapes: dict[str, Any], mesh, shard_nodes: bool) -> dict[str, P]:
    """Edges always shard over (data, model) flattened; node tensors shard
    over data only on the large graphs (ogbn-products), else replicate."""
    da = data_axes(mesh)
    edge_axes = (*da, "model") if isinstance(da, tuple) else ("data", "model")
    out: dict[str, P] = {}
    for k in batch_shapes:
        if k in ("src", "dst", "edge_mask"):
            out[k] = P(edge_axes)
        elif k in ("x",):
            out[k] = P("data", None) if shard_nodes else P()
        elif k in ("labels", "label_mask", "graph_ids"):
            out[k] = P("data") if shard_nodes else P()
        else:
            out[k] = P()
    return out


# ---------------------------------------------------------------------------
# generic helpers
# ---------------------------------------------------------------------------


def batch_specs(batch_shapes: Any, mesh) -> Any:
    """Default data-parallel batch sharding: leading dim on (pod, data)."""
    da = data_axes(mesh)

    def rule(_path, leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return P()
        return P(da, *([None] * (nd - 1)))

    return map_with_path(rule, batch_shapes)


def opt_state_specs(param_specs: Any) -> Any:
    """Adam moments + fp32 master copy inherit the param specs (scalars
    replicated)."""
    return param_specs


def _axis_size(mesh, entry) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    return math.prod(sizes[a] for a in _axes_of(entry))


def sanitize_specs(spec_tree: Any, shape_tree: Any, mesh) -> Any:
    """Drop the mesh axes that do not divide their dim (the reference's
    ``launch/steps.sanitize_specs``): such a dim is replicated."""

    def fix(spec: P, leaf) -> P:
        dims = leaf.shape
        new = []
        for i in range(len(dims)):
            axis = spec[i] if i < len(spec) else None
            new.append(axis if axis is not None and dims[i] % _axis_size(mesh, axis) == 0 else None)
        return P(*new)

    specs, treedef = tree_flatten(spec_tree)
    return tree_unflatten(treedef, [fix(s, x) for s, x in zip(specs, tree_leaves(shape_tree))])


def _dims(spec: P, ndim: int) -> list:
    return list(spec)[:ndim] + [None] * max(0, ndim - len(spec))


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """This rank's slice of every leaf of ``tree`` (full tensors) under
    ``specs``: along each dim sharded over some axes, the block at this
    rank's coordinate on them (a copy, so the full tensor can be freed)."""

    def cut(x: torch.Tensor, spec: P) -> torch.Tensor:
        for d, entry in enumerate(_dims(spec, x.dim())):
            n = _axis_size(mesh, entry) if entry is not None else 1
            if n > 1:
                size = x.shape[d] // n
                x = x.narrow(d, mesh.coord(entry) * size, size)
        return x.clone()

    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [cut(x, s) for x, s in zip(leaves, tree_leaves(specs))])


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """The inverse of :func:`shard_tree`: every leaf whole again, on every
    rank (a collective: every rank of the mesh calls it)."""

    def join(x: torch.Tensor, spec: P) -> torch.Tensor:
        for d, entry in enumerate(_dims(spec, x.dim())):
            if entry is not None:
                x = all_gather(x, mesh, entry, d)
        return x.contiguous()

    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [join(x, s) for x, s in zip(leaves, tree_leaves(specs))])
