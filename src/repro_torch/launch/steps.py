"""Cell builder: (architecture, shape) -> step function + abstract inputs.

The reference's ``launch/steps.py`` for the LM cells (train, prefill,
decode; dense and MoE), the GNN train cells, the recsys cells (train,
score, retrieval) and the ``paper_search`` cells; the dry-run and the
trainer share it.  The abstract
inputs are ``device="meta"`` tensors, which carry the reference's shapes and
dtypes and allocate nothing (the counterpart of ``jax.ShapeDtypeStruct``);
every cell's are at its global batch.  The reference also gives each cell
partition specs over its device mesh; on one card there is no mesh, and the
layout's size only sets the number of cluster shards a serve cell folds into
one program (``search/serving_step.serve_step_sharded``); a GNN cell's
``shard_nodes`` (the reference's node-sharded batch specs) has no effect.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.common import ArchSpec, ShapeCell
from ..models import gnn, recsys, transformer
from ..optim import AdamWConfig, adamw_init, adamw_update, cast_like, global_norm
from ..search.serving_step import build_step, serve_step_sharded
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .mesh import MeshLayout

__all__ = ["Cell", "build_cell", "input_specs"]


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


def _value_and_grad(loss_fn, params, batch, cfg, **kwargs):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: (loss, metrics), and
    the gradients as a tree like ``params``; ``params`` is not modified."""
    leaves, treedef = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = loss_fn(tree_unflatten(treedef, live), batch, cfg, **kwargs)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree_unflatten(treedef, list(grads))


def _lm_cell(spec: ArchSpec, cell: ShapeCell, mesh: MeshLayout) -> Cell:
    cfg: transformer.TransformerConfig = spec.cfg_for(cell.name)
    if "sliding_window" in cell.kwargs:
        cfg = dataclasses.replace(cfg, sliding_window=cell.kwargs["sliding_window"])
    seq = cell.kwargs["seq_len"]
    batch = cell.kwargs["global_batch"]
    p_shapes = transformer.param_shapes(cfg)
    n_tok = batch * seq
    n_active = cfg.active_param_count()

    if cell.step == "train":
        opt_cfg = AdamWConfig()
        o_shapes = adamw_init(p_shapes)
        b_shapes = {k: _meta((batch, seq), torch.int32) for k in ("tokens", "targets", "mask")}
        n_micro = max(1, cfg.microbatches)

        def train_fn(params, opt_state, bat):
            if n_micro > 1:
                # gradient accumulation over contiguous row blocks: peak
                # activation memory scales with B/n_micro instead of B
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
            master, new_state = adamw_update(grads, opt_state, opt_cfg)
            out_metrics = {"loss": loss, "nll": nll, "aux": aux, "grad_norm": global_norm(grads)}
            return cast_like(master, params), new_state, out_metrics

        return Cell(
            arch_id=spec.arch_id, shape_name=cell.name, step="train",
            fn=train_fn, abstract_args=(p_shapes, o_shapes, b_shapes),
            model_flops_fn=lambda: 6.0 * n_active * n_tok,
        )

    if cell.step == "prefill":
        tok = {"tokens": _meta((batch, seq), torch.int32)}

        @torch.no_grad()
        def prefill_fn(params, bat):
            return transformer.prefill_step(params, bat["tokens"], cfg)

        return Cell(
            arch_id=spec.arch_id, shape_name=cell.name, step="prefill",
            fn=prefill_fn, abstract_args=(p_shapes, tok),
            model_flops_fn=lambda: 2.0 * n_active * n_tok,
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

    @torch.no_grad()
    def decode_fn(params, cache, tokens, cache_len):
        return transformer.decode_step(params, cache, tokens, cache_len, cfg)

    # useful work for one decoded token: active params + KV reads
    attended = min(seq, cfg.sliding_window or seq)
    flops = 2.0 * n_active * batch + 4.0 * batch * attended * cfg.n_heads * dh * cfg.n_layers

    return Cell(
        arch_id=spec.arch_id, shape_name=cell.name, step="decode",
        fn=decode_fn, abstract_args=args,
        model_flops_fn=lambda: flops,
        notes=f"sliding_window={cfg.sliding_window}",
    )


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def _gnn_cell(spec: ArchSpec, cell: ShapeCell, mesh: MeshLayout) -> Cell:
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

    def train_fn(params, opt_state, bat):
        loss, metrics, grads = _value_and_grad(gnn.gat_loss, params, bat, cfg, n_graphs=n_graphs)
        master, new_state = adamw_update(grads, opt_state, opt_cfg)
        return cast_like(master, params), new_state, {"loss": loss, "acc": metrics["acc"]}

    # SpMM-ish useful work: per edge per layer, gather+reduce over head dims
    flops = 0.0
    for fi, do in cfg.layer_dims():
        flops += 2.0 * n * fi * cfg.n_heads * do  # dense projections
        flops += 6.0 * e * cfg.n_heads * do  # edge score + weighted aggregate
    flops *= 3  # fwd + bwd(2x)

    return Cell(
        arch_id=spec.arch_id, shape_name=cell.name, step="train",
        fn=train_fn, abstract_args=(p_shapes, o_shapes, b_shapes),
        model_flops_fn=lambda: flops,
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


def _recsys_cell(spec: ArchSpec, cell: ShapeCell, mesh: MeshLayout) -> Cell:
    cfg: recsys.RecsysConfig = spec.cfg_for(cell.name)
    p_shapes = recsys.recsys_param_shapes(cfg)
    b_shapes = _recsys_batch_shapes(cfg, cell)

    if cell.step == "train":
        opt_cfg = AdamWConfig(lr=1e-3, weight_decay=1e-5)
        o_shapes = adamw_init(p_shapes)

        def train_fn(params, opt_state, bat):
            loss, _, grads = _value_and_grad(recsys.recsys_loss, params, bat, cfg)
            master, new_state = adamw_update(grads, opt_state, opt_cfg)
            return cast_like(master, params), new_state, {"loss": loss}

        bsz = cell.kwargs["batch"]
        return Cell(
            arch_id=spec.arch_id, shape_name=cell.name, step="train",
            fn=train_fn, abstract_args=(p_shapes, o_shapes, b_shapes),
            model_flops_fn=lambda: 3.0 * _recsys_flops(cfg, bsz),
        )

    if cell.step == "score":
        @torch.no_grad()
        def score_fn(params, bat):
            return recsys.recsys_score(params, bat, cfg)

        bsz = cell.kwargs["batch"]
        return Cell(
            arch_id=spec.arch_id, shape_name=cell.name, step="score",
            fn=score_fn, abstract_args=(p_shapes, b_shapes),
            model_flops_fn=lambda: _recsys_flops(cfg, bsz),
        )

    # retrieval: one context vs n_candidates
    c = cell.kwargs["n_candidates"]
    b_shapes["cand_ids"] = _meta((c,), torch.int32)

    @torch.no_grad()
    def retrieval_fn(params, bat):
        # one card holds what the reference spreads over its data ranks:
        # each chunk of candidates is one batched forward (every
        # candidate's score depends on it and the context alone)
        chunks = bat["cand_ids"].split(RETRIEVAL_CHUNK)
        return torch.cat([recsys.recsys_retrieval_score(params, {**bat, "cand_ids": ch}, cfg) for ch in chunks])

    return Cell(
        arch_id=spec.arch_id, shape_name=cell.name, step="retrieval",
        fn=retrieval_fn, abstract_args=(p_shapes, b_shapes),
        model_flops_fn=lambda: _recsys_flops(cfg, c),
    )


def _search_cell(spec: ArchSpec, cell: ShapeCell, mesh: MeshLayout) -> Cell:
    cfg = spec.model_cfg
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

        def fn(postings, cluster_doc, mult):
            return serve_step_sharded(
                postings, cluster_doc, mult,
                max_distance=d, n_clusters=c_loc, window_len=n, top_k=cfg.top_k,
            )

        # useful work: the window cover — (2D+1) window steps x L lemmas x N
        flops = float(b) * ns * c_loc * (2 * d + 1) * l * n * 4.0
        return Cell(
            arch_id=spec.arch_id, shape_name=cell.name, step="serve",
            fn=fn, abstract_args=args, model_flops_fn=lambda: flops,
        )

    docs, doc_len = cell.kwargs["docs"], cell.kwargs["doc_len"]
    d = cfg.max_distance
    args = (_meta((docs, doc_len), torch.int32), _meta((docs, doc_len), torch.bool))

    def fn(tokens, is_stop):
        return build_step(tokens, is_stop, max_distance=d, n_buckets=cfg.build_buckets)

    n_off = d * (2 * d - 1)
    flops = float(docs) * doc_len * n_off * 6.0
    return Cell(
        arch_id=spec.arch_id, shape_name=cell.name, step="build",
        fn=fn, abstract_args=args, model_flops_fn=lambda: flops,
    )


def build_cell(spec: ArchSpec, shape_name: str, mesh: MeshLayout) -> Cell:
    cell = spec.shapes[shape_name]
    if spec.family == "lm":
        return _lm_cell(spec, cell, mesh)
    if spec.family == "recsys":
        return _recsys_cell(spec, cell, mesh)
    if spec.family == "gnn":
        return _gnn_cell(spec, cell, mesh)
    if spec.family == "search":
        return _search_cell(spec, cell, mesh)
    raise ValueError(spec.family)


def input_specs(arch_id: str, shape_name: str, mesh: MeshLayout | None = None) -> tuple[Any, ...]:
    """Public helper (dry-run contract): ``device="meta"`` stand-ins for every
    input of the (architecture x shape) cell — the reference's shapes and
    dtypes, no allocation."""
    from ..configs import get_spec
    from .mesh import make_production_mesh

    if mesh is None:
        mesh = make_production_mesh()
    return build_cell(get_spec(arch_id), shape_name, mesh).abstract_args
