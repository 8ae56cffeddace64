"""Cell builder: (architecture, shape) -> step function + abstract inputs +
partition specs.

The reference's ``launch/steps.py`` for the LM cells (train, prefill,
decode; dense and MoE), the GNN train cells, the recsys cells (train,
score, retrieval) and the ``paper_search`` cells; the dry-run and the
trainer share it.  The abstract inputs are ``device="meta"`` tensors,
which carry the reference's shapes and dtypes and allocate nothing (the
counterpart of ``jax.ShapeDtypeStruct``); every cell's are at its global
batch.  Each cell carries the reference's ``in_specs`` (``sanitize_specs``
of the rules in ``parallel/sharding.py``) over the mesh it runs under.

``mesh`` is the production layout, whose size is the number of cluster
shards (NS) a serve cell folds into one program.  ``dmesh``, a
``DeviceMesh``, runs the cell in a world of ranks: every argument of
``fn`` is then this rank's slice under ``in_specs`` (``shard_tree``).  A
serve cell's ranks each cover their NS/W shards and all-gather the top-k
lists; an LM train or prefill cell runs data, tensor and expert
parallelism, with FSDP where the config asks (``models/transformer.py``),
the gradients of every leaf replicated over a data axis all-reduced over
it, AdamW on the shards; an LM decode cell under a model axis of more than
one rank is context-parallel, each rank holding its slice of the cache's
positions where the model axis divides them.  A recsys cell row-shards its
tables and column-splits its MLP weights over ``model`` where the rules and
``sanitize_specs`` say so, splits its batch (or a retrieval cell's
candidates) over the data axes, and trains on the global mean with
MIND's negatives from the whole global batch (``models/recsys.py``).  A GNN
cell's ranks each hold a block of the edges (and, with ``shard_nodes``, of
the nodes over ``data``); the segment max, ``denom`` and ``msg`` combine
over the edge axes, so every rank's gradient of the replicated GAT params
is the whole graph's (``models/gnn.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.common import ArchSpec, ShapeCell
from ..models import gnn, recsys, transformer
from ..optim import AdamWConfig, adamw_init, adamw_update, cast_like, global_norm
from ..parallel.collectives import all_reduce
from ..parallel.sharding import (
    P,
    batch_specs,
    data_axes,
    gnn_specs,
    lm_param_specs,
    recsys_param_specs,
    sanitize_specs,
    spec_axes,
)
from ..search.serving_step import build_step, serve_step_sharded
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .mesh import DeviceMesh, MeshLayout, use_mesh

__all__ = ["Cell", "build_cell", "input_specs", "sanitize_specs", "sync_grads"]


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    step: str
    fn: Callable  # positional args match `abstract_args`
    abstract_args: tuple
    model_flops_fn: Callable[[], float]  # useful-work model
    notes: str = ""
    in_specs: tuple = ()  # one spec tree per argument, over the mesh it runs under


def _rep_like(tree: Any) -> Any:
    return tree_map(lambda _: P(), tree)


def sync_grads(grads: Any, specs: Any, mesh: DeviceMesh | None) -> Any:
    """Each leaf's gradient summed over the data axes (``pod``, ``data``)
    that do not shard it: those ranks ran other rows of the batch on the
    same weights.  A leaf sharded over ``data`` (FSDP) got its sum from the
    gather's reduce-scatter."""
    if mesh is None or mesh.size == 1:
        return grads
    da = tuple(a for a in mesh.axis_names if a in ("pod", "data"))

    def one(g, spec):
        axes = tuple(a for a in da if a not in spec_axes(spec))
        return all_reduce(g, mesh, axes) if axes else g

    return tree_map(one, grads, specs)


def _world(dmesh: DeviceMesh | None) -> DeviceMesh | None:
    return dmesh if dmesh is not None and dmesh.size > 1 else None


def _value_and_grad(loss_fn, params, batch, cfg, **kwargs):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: (loss, metrics), and
    the gradients as a tree like ``params``; ``params`` is not modified."""
    leaves, treedef = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = loss_fn(tree_unflatten(treedef, live), batch, cfg, **kwargs)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree_unflatten(treedef, list(grads))


def _lm_cell(spec: ArchSpec, cell: ShapeCell, mesh: MeshLayout, dmesh: DeviceMesh | None = None) -> Cell:
    cfg: transformer.TransformerConfig = spec.cfg_for(cell.name)
    if "sliding_window" in cell.kwargs:
        cfg = dataclasses.replace(cfg, sliding_window=cell.kwargs["sliding_window"])
    seq = cell.kwargs["seq_len"]
    batch = cell.kwargs["global_batch"]
    p_shapes = transformer.param_shapes(cfg)
    n_tok = batch * seq
    n_active = cfg.active_param_count()
    m = dmesh if dmesh is not None else mesh
    da = data_axes(m)
    tp = dict(zip(m.axis_names, m.shape))["model"]
    p_specs = sanitize_specs(lm_param_specs(p_shapes, kv_shardable=(cfg.n_kv_heads % tp == 0), fsdp=cfg.fsdp),
                             p_shapes, m)
    world = _world(dmesh)

    if cell.step == "train":
        opt_cfg = AdamWConfig()
        o_shapes = adamw_init(p_shapes)
        o_specs = {"m": p_specs, "v": p_specs, "master": p_specs, "step": P()}
        b_shapes = {k: _meta((batch, seq), torch.int32) for k in ("tokens", "targets", "mask")}
        b_specs = sanitize_specs(batch_specs(b_shapes, m), b_shapes, m)
        n_micro = max(1, cfg.microbatches)

        def train_fn(params, opt_state, bat):
            with use_mesh(dmesh):
                if n_micro > 1:
                    # gradient accumulation over contiguous row blocks (of
                    # this rank's rows): peak activation memory scales with
                    # B/n_micro instead of B
                    mbs = [{k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])[i] for k, v in bat.items()}
                           for i in range(n_micro)]
                    gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
                    dev = next(iter(bat.values())).device
                    nll = torch.zeros((), dtype=torch.float32, device=dev)
                    aux = torch.zeros((), dtype=torch.float32, device=dev)
                    for mb in mbs:
                        _, metrics, grads = _value_and_grad(transformer.loss_fn, params, mb, cfg)
                        for a, g in zip(tree_leaves(gacc), tree_leaves(grads)):
                            a.add_(g)  # in float32: the accumulator is this step's own
                        del grads
                        nll = nll + metrics["nll"]
                        aux = aux + metrics["aux"]
                    grads = tree_map(lambda g: g / n_micro, gacc)
                    nll, aux = nll / n_micro, aux / n_micro
                    loss = nll + cfg.aux_loss_weight * aux
                else:
                    loss, metrics, grads = _value_and_grad(transformer.loss_fn, params, bat, cfg)
                    nll, aux = metrics["nll"], metrics["aux"]
                grads = sync_grads(grads, p_specs, world)
                master, new_state = adamw_update(grads, opt_state, opt_cfg, specs=p_specs, mesh=world)
                out_metrics = {"loss": loss, "nll": nll, "aux": aux,
                               "grad_norm": global_norm(grads, specs=p_specs, mesh=world)}
                return cast_like(master, params), new_state, out_metrics

        return Cell(
            arch_id=spec.arch_id, shape_name=cell.name, step="train",
            fn=train_fn, abstract_args=(p_shapes, o_shapes, b_shapes),
            model_flops_fn=lambda: 6.0 * n_active * n_tok,
            in_specs=(p_specs, o_specs, b_specs),
        )

    if cell.step == "prefill":
        tok = {"tokens": _meta((batch, seq), torch.int32)}

        @torch.no_grad()
        def prefill_fn(params, bat):
            with use_mesh(dmesh):
                return transformer.prefill_step(params, bat["tokens"], cfg)

        return Cell(
            arch_id=spec.arch_id, shape_name=cell.name, step="prefill",
            fn=prefill_fn, abstract_args=(p_shapes, tok),
            model_flops_fn=lambda: 2.0 * n_active * n_tok,
            in_specs=(p_specs, sanitize_specs(batch_specs(tok, m), tok, m)),
        )

    # decode (decode_32k / long_500k)
    dh = cfg.d_head
    cache_shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, dh)
    args = (
        p_shapes,
        {"k": _meta(cache_shape, cfg.torch_dtype), "v": _meta(cache_shape, cfg.torch_dtype)},
        _meta((batch, 1), torch.int32),
        _meta((), torch.int32),
    )
    # context-parallel decode in the reference: the cache's sequence dim
    # over `model`
    cache_spec = P(None, da, "model", None, None)
    in_specs = (
        p_specs,
        sanitize_specs({"k": cache_spec, "v": cache_spec}, args[1], m),
        sanitize_specs(P(da, None), args[2], m),
        P(),
    )

    # a world's ranks each hold their slice of the positions where the
    # model axis divides them (else the cache whole)
    seq_split = world is not None and in_specs[1]["k"][2] == "model"

    @torch.no_grad()
    def decode_fn(params, cache, tokens, cache_len):
        with use_mesh(dmesh):
            return transformer.decode_step(params, cache, tokens, cache_len, cfg, seq_split=seq_split)

    # useful work for one decoded token: active params + KV reads
    attended = min(seq, cfg.sliding_window or seq)
    flops = 2.0 * n_active * batch + 4.0 * batch * attended * cfg.n_heads * dh * cfg.n_layers

    return Cell(
        arch_id=spec.arch_id, shape_name=cell.name, step="decode",
        fn=decode_fn, abstract_args=args,
        model_flops_fn=lambda: flops,
        notes=f"sliding_window={cfg.sliding_window}",
        in_specs=in_specs,
    )


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def _gnn_cell(spec: ArchSpec, cell: ShapeCell, mesh: MeshLayout, dmesh: DeviceMesh | None = None) -> Cell:
    cfg: gnn.GATConfig = spec.cfg_for(cell.name)
    kw = cell.kwargs
    n, e, f = kw["n_nodes"], kw["n_edges"], kw["d_feat"]
    task_graph = kw["task"] == "graph"
    n_graphs = kw.get("batch_graphs", 1)
    p_shapes = gnn.gat_param_shapes(cfg)
    opt_cfg = AdamWConfig(lr=5e-3, weight_decay=5e-4)
    o_shapes = adamw_init(p_shapes)
    n_labels = n_graphs if task_graph else n
    b_shapes: dict[str, Any] = {
        "x": _meta((n, f), torch.float32),
        "src": _meta((e,), torch.int32),
        "dst": _meta((e,), torch.int32),
        "edge_mask": _meta((e,), torch.int32),
        "labels": _meta((n_labels,), torch.int32),
        "label_mask": _meta((n_labels,), torch.int32),
    }
    if task_graph:
        b_shapes["graph_ids"] = _meta((n,), torch.int32)

    # SpMM-ish useful work: per edge per layer, gather+reduce over head dims
    flops = 0.0
    for fi, do in cfg.layer_dims():
        flops += 2.0 * n * fi * cfg.n_heads * do  # dense projections
        flops += 6.0 * e * cfg.n_heads * do  # edge score + weighted aggregate
    flops *= 3  # fwd + bwd(2x)

    m = dmesh if dmesh is not None else mesh
    b_specs = gnn_specs(b_shapes, m, shard_nodes=kw.get("shard_nodes", False))
    if task_graph:
        b_specs["labels"] = P()
        b_specs["label_mask"] = P()
    b_specs = sanitize_specs(b_specs, b_shapes, m)
    world = _world(dmesh)
    # a rank's blocks of the batch: the edges over the axes that divide
    # them, the nodes over data where it divides them
    shards = None if world is None else gnn.GATShards(world, b_specs["src"][0], b_specs["x"][0] == "data")

    def train_fn(params, opt_state, bat):
        # the params are replicated and every rank's gradient is the whole
        # graph's (``gnn.GATShards``): no sum over the data axes
        loss, metrics, grads = _value_and_grad(gnn.gat_loss, params, bat, cfg, n_graphs=n_graphs, shards=shards)
        master, new_state = adamw_update(grads, opt_state, opt_cfg)
        return cast_like(master, params), new_state, {"loss": loss, "acc": metrics["acc"]}

    return Cell(
        arch_id=spec.arch_id, shape_name=cell.name, step="train",
        fn=train_fn, abstract_args=(p_shapes, o_shapes, b_shapes),
        model_flops_fn=lambda: flops,
        # GAT params are tiny: replicate
        in_specs=(_rep_like(p_shapes), _rep_like(o_shapes), b_specs),
    )


# the most candidates a retrieval cell scores in one forward: serve_bulk's
# batch (262,144 rows).  AutoInt's activations at 1,000,000 candidates are
# about 70 GB in float32.
RETRIEVAL_CHUNK = 262_144


def _recsys_batch_shapes(cfg: recsys.RecsysConfig, cell: ShapeCell) -> dict[str, Any]:
    b = cell.kwargs["batch"]
    if cfg.model == "mind":
        out = {"hist_ids": _meta((b, cfg.hist_len), torch.int32), "target_id": _meta((b,), torch.int32)}
    else:
        out = {"sparse_ids": _meta((b, cfg.n_sparse), torch.int32)}
        if cfg.n_dense:
            out["dense"] = _meta((b, cfg.n_dense), torch.float32)
    if cell.step == "train" and cfg.model != "mind":
        out["label"] = _meta((b,), torch.float32)
    return out


def _recsys_flops(cfg: recsys.RecsysConfig, batch: int) -> float:
    d = cfg.embed_dim
    if cfg.model == "fm":
        per = 4.0 * cfg.n_sparse * d
    elif cfg.model == "autoint":
        da, h, f = cfg.d_attn, cfg.n_attn_heads, cfg.n_sparse
        per = cfg.n_attn_layers * (6.0 * f * d * h * da + 4.0 * f * f * h * da)
    elif cfg.model == "dcn_v2":
        x0 = cfg.x0_dim
        per = cfg.n_cross_layers * 2.0 * x0 * x0
        fan = x0
        for m in cfg.mlp_dims:
            per += 2.0 * fan * m
            fan = m
    else:  # mind
        per = cfg.capsule_iters * 6.0 * cfg.hist_len * cfg.n_interests * d + 2.0 * cfg.hist_len * d * d
    return per * batch


def _recsys_cell(spec: ArchSpec, cell: ShapeCell, mesh: MeshLayout, dmesh: DeviceMesh | None = None) -> Cell:
    cfg: recsys.RecsysConfig = spec.cfg_for(cell.name)
    m = dmesh if dmesh is not None else mesh
    world = _world(dmesh)
    p_shapes = recsys.recsys_param_shapes(cfg)
    p_specs = sanitize_specs(recsys_param_specs(p_shapes), p_shapes, m)
    b_shapes = _recsys_batch_shapes(cfg, cell)
    b_specs = sanitize_specs(batch_specs(b_shapes, m), b_shapes, m)

    if cell.step == "train":
        opt_cfg = AdamWConfig(lr=1e-3, weight_decay=1e-5)
        o_shapes = adamw_init(p_shapes)
        # the axes the batch rows split over (None where they do not divide)
        rows = next(iter(b_specs.values()))[0]

        def train_fn(params, opt_state, bat):
            with use_mesh(dmesh):
                loss, _, grads = _value_and_grad(recsys.recsys_loss, params, bat, cfg, rows=rows)
                grads = sync_grads(grads, p_specs, world)
                master, new_state = adamw_update(grads, opt_state, opt_cfg, specs=p_specs, mesh=world)
                return cast_like(master, params), new_state, {"loss": loss}

        bsz = cell.kwargs["batch"]
        o_specs = {"m": p_specs, "v": p_specs, "master": p_specs, "step": P()}
        return Cell(
            arch_id=spec.arch_id, shape_name=cell.name, step="train",
            fn=train_fn, abstract_args=(p_shapes, o_shapes, b_shapes),
            model_flops_fn=lambda: 3.0 * _recsys_flops(cfg, bsz),
            in_specs=(p_specs, o_specs, b_specs),
        )

    if cell.step == "score":
        @torch.no_grad()
        def score_fn(params, bat):
            with use_mesh(dmesh):
                return recsys.recsys_score(params, bat, cfg)

        bsz = cell.kwargs["batch"]
        return Cell(
            arch_id=spec.arch_id, shape_name=cell.name, step="score",
            fn=score_fn, abstract_args=(p_shapes, b_shapes),
            model_flops_fn=lambda: _recsys_flops(cfg, bsz),
            in_specs=(p_specs, b_specs),
        )

    # retrieval: one context vs n_candidates
    c = cell.kwargs["n_candidates"]
    b_shapes["cand_ids"] = _meta((c,), torch.int32)

    @torch.no_grad()
    def retrieval_fn(params, bat):
        # one card holds what the reference spreads over its data ranks:
        # each chunk of candidates is one batched forward (every
        # candidate's score depends on it and the context alone); in a
        # world, of this rank's candidates
        chunks = bat["cand_ids"].split(RETRIEVAL_CHUNK)
        with use_mesh(dmesh):
            return torch.cat([recsys.recsys_retrieval_score(params, {**bat, "cand_ids": ch}, cfg) for ch in chunks])

    r_specs = {k: P() for k in b_shapes}
    r_specs["cand_ids"] = P(data_axes(m))
    return Cell(
        arch_id=spec.arch_id, shape_name=cell.name, step="retrieval",
        fn=retrieval_fn, abstract_args=(p_shapes, b_shapes),
        model_flops_fn=lambda: _recsys_flops(cfg, c),
        in_specs=(p_specs, sanitize_specs(r_specs, b_shapes, m)),
    )


def _search_cell(spec: ArchSpec, cell: ShapeCell, mesh: MeshLayout, dmesh: DeviceMesh | None = None) -> Cell:
    cfg = spec.model_cfg
    m = dmesh if dmesh is not None else mesh
    world = _world(dmesh)
    if cell.step == "serve":
        b = cell.kwargs["batch"]
        p = cell.kwargs["postings"]
        c = cell.kwargs["clusters"]
        l, n, d = cfg.n_lemmas, cfg.window_len, cfg.max_distance
        # document/cluster-sharded layout (§Perf-3): every shard owns one
        # cluster shard's postings end-to-end
        ns = mesh.size
        c_loc = max(1, -(-max(c, ns) // ns))
        p_loc = max(1, -(-p // ns))
        args = (
            _meta((ns, b, p_loc, 3), torch.int32),
            _meta((ns, b, c_loc), torch.int32),
            _meta((b, l), torch.int32),
        )

        # the cluster-shard axis over every axis of the mesh the cell runs
        # under: a rank covers its NS/W shards
        shard_axes = tuple(m.axis_names)
        in_specs = (P(shard_axes, None, None, None), P(shard_axes, None, None), P())

        def fn(postings, cluster_doc, mult):
            return serve_step_sharded(
                postings, cluster_doc, mult,
                max_distance=d, n_clusters=c_loc, window_len=n, top_k=cfg.top_k, mesh=world,
            )

        # useful work: the window cover — (2D+1) window steps x L lemmas x N
        flops = float(b) * ns * c_loc * (2 * d + 1) * l * n * 4.0
        return Cell(
            arch_id=spec.arch_id, shape_name=cell.name, step="serve",
            fn=fn, abstract_args=args, model_flops_fn=lambda: flops, in_specs=in_specs,
        )

    docs, doc_len = cell.kwargs["docs"], cell.kwargs["doc_len"]
    d = cfg.max_distance
    args = (_meta((docs, doc_len), torch.int32), _meta((docs, doc_len), torch.bool))

    da = data_axes(m)
    in_specs = (sanitize_specs(P(da, None), args[0], m), sanitize_specs(P(da, None), args[1], m))
    # documents over the data axes: each rank's histogram, summed
    sum_axes = in_specs[0][0] if world is not None else None

    def fn(tokens, is_stop):
        out = build_step(tokens, is_stop, max_distance=d, n_buckets=cfg.build_buckets)
        if sum_axes is None:
            return out
        return {k: all_reduce(v, world, sum_axes) for k, v in out.items()}

    n_off = d * (2 * d - 1)
    flops = float(docs) * doc_len * n_off * 6.0
    return Cell(
        arch_id=spec.arch_id, shape_name=cell.name, step="build",
        fn=fn, abstract_args=args, model_flops_fn=lambda: flops, in_specs=in_specs,
    )


def build_cell(spec: ArchSpec, shape_name: str, mesh: MeshLayout, dmesh: DeviceMesh | None = None) -> Cell:
    cell = spec.shapes[shape_name]
    build = {"lm": _lm_cell, "recsys": _recsys_cell, "gnn": _gnn_cell, "search": _search_cell}.get(spec.family)
    if build is None:
        raise ValueError(spec.family)
    return build(spec, cell, mesh, dmesh)


def input_specs(arch_id: str, shape_name: str, mesh: MeshLayout | None = None) -> tuple[Any, ...]:
    """Public helper (dry-run contract): ``device="meta"`` stand-ins for every
    input of the (architecture x shape) cell — the reference's shapes and
    dtypes, no allocation."""
    from ..configs import get_spec
    from .mesh import make_production_mesh

    if mesh is None:
        mesh = make_production_mesh()
    return build_cell(get_spec(arch_id), shape_name, mesh).abstract_args
