"""RecSys / ranking models: FM, AutoInt, DCN-v2, MIND.

The reference's ``repro/models/recsys.py`` as torch ops.  The shared
substrate is a single concatenated sparse-feature embedding table
(``[total_vocab, dim]``, per-field row offsets added to the field-local
ids).  Padding is ``-1``, which ``torch.nn.functional.embedding_bag``'s
``padding_idx`` cannot express, so :func:`embedding_bag` gathers at the
clamped id and masks, as the reference does.  Ids must lie in range: the
reference's ``jnp.take`` fills out-of-range reads, torch raises.

Every model exposes:
  * ``loss``            — pointwise BCE (CTR models) / in-batch sampled
                          softmax (MIND retrieval), for ``train_batch``;
  * ``score``           — forward scores, for ``serve_p99`` / ``serve_bulk``;
  * ``retrieval_score`` — one context against ``n_candidates`` items as a
                          single batched forward (no loops), for
                          ``retrieval_cand``.

Under a device mesh (``launch.mesh.use_mesh``) of more than one rank every
parameter is this rank's slice under the reference's rules
(``parallel.sharding.recsys_param_specs``, sanitized for the mesh): a table
whose rows split over ``model`` (``table``, FM's ``w_linear``) is looked up
by :func:`lookup` (each rank its own rows, summed over ``model``), a matrix
whose columns split over ``model`` (DCN-v2's ``mlp/*/w``; ``cross_w`` where
``model`` divides its width) multiplies behind ``copy_to`` and its columns
are gathered.  The batch rows split over the data axes: the loss is the
global mean (sums and counts all-reduced), and MIND's in-batch negatives
are the whole global batch's targets, gathered (``fsdp_gather``: every
rank's logits read every target, so their gradients are reduce-scattered).
With no mesh, or a mesh of one rank, every op is the one-card model's.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from ..launch.mesh import current_mesh
from ..parallel.collectives import all_reduce, copy_to, fsdp_gather, gather_from, reduce_from
from ..parallel.sharding import data_axes, map_with_path, recsys_param_specs, sanitize_specs
from .layers import dense_init

__all__ = [
    "RecsysConfig",
    "embedding_bag",
    "embedding_bag_gather",
    "lookup",
    "init_recsys_params",
    "recsys_param_shapes",
    "recsys_loss",
    "recsys_score",
    "recsys_retrieval_score",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _own_rows(table: torch.Tensor, ids: torch.Tensor, mesh) -> torch.Tensor:
    """``table``'s rows at ``ids`` (``>= 0``); under ``mesh``, where
    ``table`` is this rank's block of rows over ``model``, the ids outside
    it give zeros (to be summed over ``model``)."""
    if mesh is None:
        return F.embedding(ids, table) if table.dim() == 2 else table[ids]
    v = table.shape[0]
    local = ids - mesh.coord("model") * v
    own = (local >= 0) & (local < v)
    rows = F.embedding(local.clamp(0, v - 1), table) if table.dim() == 2 else table[local.clamp(0, v - 1)]
    return torch.where(own.view(*own.shape, *([1] * (table.dim() - 1))), rows, 0.0)


def lookup(table: torch.Tensor, ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """Rows of ``table`` (``[V, D]``, or ``[V]``) at ``ids`` (``>= 0``).
    ``mesh``: ``table``'s rows split over its ``model`` axis, this rank
    holding rows ``[r V/tp, (r+1) V/tp)``; each rank takes its own rows and
    the lookup is summed over ``model`` (``reduce_from``: the gradient of a
    row reaches only the rank that holds it).  Without it, ``F.embedding``
    (or an index, for ``[V]``)."""
    return reduce_from(_own_rows(table, ids, mesh), mesh, "model")


def embedding_bag(
    table: torch.Tensor,  # [V, D]
    ids: torch.Tensor,  # [B, K] int, pad = -1
    weights: torch.Tensor | None = None,  # [B, K]
    mode: str = "sum",
    *,
    mesh=None,
) -> torch.Tensor:
    """``torch.nn.EmbeddingBag`` (sum/mean) with ``-1`` padding, built from
    a gather and a masked reduce; ``mesh`` as :func:`lookup` (each rank's
    bags summed over ``model``)."""
    ok = ids >= 0
    emb = _own_rows(table, torch.clamp(ids, min=0), mesh)  # [B, K, D]
    w = ok.to(table.dtype)
    if weights is not None:
        w = w * weights.to(table.dtype)
    out = reduce_from((emb * w[..., None]).sum(dim=1), mesh, "model")
    if mode == "mean":
        out = out / torch.clamp(ok.sum(dim=1, keepdim=True).to(table.dtype), min=1.0)
    return out


def embedding_bag_gather(table: torch.Tensor, ids: torch.Tensor, *, mesh=None) -> torch.Tensor:
    """Masked gather (pad = -1 -> zero rows); keeps the T axis; ``mesh`` as
    :func:`lookup`."""
    ok = (ids >= 0)[..., None]
    return lookup(table, torch.clamp(ids, min=0), mesh) * ok.to(table.dtype)


def _cols(x: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """``x @ w``; ``mesh``: ``w`` is this rank's block of columns over
    ``model`` (``x`` enters through ``copy_to``, the columns are gathered)."""
    if mesh is None:
        return x @ w
    return gather_from(copy_to(x, mesh, "model") @ w, mesh, "model", -1)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    model: str  # "fm" | "autoint" | "dcn_v2" | "mind"
    n_sparse: int
    embed_dim: int
    field_vocab: tuple[int, ...]  # per-field vocabulary sizes
    n_dense: int = 0
    # autoint
    n_attn_layers: int = 3
    n_attn_heads: int = 2
    d_attn: int = 32
    # dcn-v2
    n_cross_layers: int = 3
    mlp_dims: tuple[int, ...] = (1024, 1024, 512)
    # mind
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def total_vocab(self) -> int:
        return int(sum(self.field_vocab))

    @property
    def field_offsets(self) -> tuple[int, ...]:
        off, acc = [], 0
        for v in self.field_vocab:
            off.append(acc)
            acc += v
        return tuple(off)

    @property
    def x0_dim(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim

    def param_count(self) -> int:
        d = self.embed_dim
        n = self.total_vocab * d
        if self.model == "fm":
            n += self.total_vocab + 1
        elif self.model == "autoint":
            da = self.d_attn * self.n_attn_heads
            fan = d
            for _ in range(self.n_attn_layers):
                n += 3 * fan * da + fan * da  # qkv + residual proj
                fan = da
            n += self.n_sparse * fan
        elif self.model == "dcn_v2":
            x0 = self.x0_dim
            n += self.n_cross_layers * (x0 * x0 + x0)
            fan = x0
            for m in self.mlp_dims:
                n += fan * m + m
                fan = m
            n += (x0 + self.mlp_dims[-1]) + 1
        elif self.model == "mind":
            n += d * d + self.n_interests * d  # bilinear + interest init
        return n


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layout(cfg: RecsysConfig) -> dict[str, Any]:
    """Every parameter's shape and init: ``("zeros", shape)`` or ``("dense",
    shape, scale)``; ``attn_layers`` and ``mlp`` are lists, as in the
    reference's tree."""
    d = cfg.embed_dim
    p: dict[str, Any] = {"table": ("dense", (cfg.total_vocab, d), 0.01)}
    if cfg.model == "fm":
        p["w_linear"] = ("dense", (cfg.total_vocab,), 0.01)
        p["w0"] = ("zeros", ())
    elif cfg.model == "autoint":
        da, h = cfg.d_attn, cfg.n_attn_heads
        fan = d
        layers = []
        for _ in range(cfg.n_attn_layers):
            layers.append({
                "wq": ("dense", (fan, h, da), None),
                "wk": ("dense", (fan, h, da), None),
                "wv": ("dense", (fan, h, da), None),
                "w_res": ("dense", (fan, h * da), None),
            })
            fan = h * da
        p["attn_layers"] = layers
        p["w_out"] = ("dense", (cfg.n_sparse * fan, 1), None)
    elif cfg.model == "dcn_v2":
        x0 = cfg.x0_dim
        p["cross_w"] = ("dense", (cfg.n_cross_layers, x0, x0), None)
        p["cross_b"] = ("zeros", (cfg.n_cross_layers, x0))
        mlp = []
        fan = x0
        for m in cfg.mlp_dims:
            mlp.append({"w": ("dense", (fan, m), None), "b": ("zeros", (m,))})
            fan = m
        p["mlp"] = mlp
        p["w_out"] = ("dense", (x0 + cfg.mlp_dims[-1], 1), None)
    elif cfg.model == "mind":
        p["bilinear"] = ("dense", (d, d), None)
    return p


def _build(node, make):
    if isinstance(node, dict):
        return {k: _build(v, make) for k, v in node.items()}
    if isinstance(node, list):
        return [_build(v, make) for v in node]
    return make(*node)


def init_recsys_params(key: int | torch.Generator, cfg: RecsysConfig, *, device="cuda") -> dict[str, Any]:
    """Random parameters from ``key`` (a seed, or a ``torch.Generator`` on
    ``device``): the table N(0, 0.01), FM's linear weights N(0, 0.01),
    matrices N(0, fan_in ** -0.5) (the fan-in being ``shape[-2]``, as in
    the reference), biases and ``w0`` zeros, in ``cfg.dtype``.  The
    reference draws from ``jax.random``: ``models/convert.py`` carries its
    parameters across."""
    dev = torch.device(device)
    gen = key if isinstance(key, torch.Generator) else torch.Generator(device=dev).manual_seed(key)
    dt = cfg.torch_dtype

    def make(kind, shape, scale=None):
        if kind == "zeros":
            return torch.zeros(shape, dtype=dt, device=dev)
        return dense_init(gen, shape, dt, scale=scale)

    return _build(_layout(cfg), make)


def recsys_param_shapes(cfg: RecsysConfig) -> dict[str, Any]:
    """``init_recsys_params``'s tree as ``device="meta"`` tensors."""
    dt = cfg.torch_dtype
    return _build(_layout(cfg), lambda kind, shape, scale=None: torch.empty(shape, dtype=dt, device="meta"))


@dataclasses.dataclass(frozen=True)
class _Par:
    """The sharding of a config's params on a mesh: for each param path,
    the mesh when its rows (``table``, ``w_linear``) or its columns (a
    matrix on ``P(..., "model")``) split over ``model``, else ``None``."""

    mesh: Any
    split: dict


@functools.lru_cache(maxsize=32)
def _par_for(cfg: RecsysConfig, mesh) -> _Par:
    shapes = recsys_param_shapes(cfg)
    specs = sanitize_specs(recsys_param_specs(shapes), shapes, mesh)
    split = {}
    map_with_path(lambda path, s: split.__setitem__(path, mesh if "model" in s.dims else None), specs)
    return _Par(mesh, split)


def _par(cfg: RecsysConfig) -> _Par | None:
    """The current mesh's sharding of ``cfg``; None with no mesh or a mesh
    of one rank (which runs the ops of no mesh)."""
    mesh = current_mesh()
    if mesh is None or mesh.size == 1:
        return None
    return _par_for(cfg, mesh)


def _split(par: _Par | None, path: str):
    """The mesh ``path``'s param splits over, or ``None`` (whole)."""
    return None if par is None else par.split.get(path)


# ---------------------------------------------------------------------------
# model forwards
# ---------------------------------------------------------------------------


def _field_ids(cfg: RecsysConfig, sparse_ids: torch.Tensor) -> torch.Tensor:
    """[B, F] field-local ids -> rows of the concatenated table."""
    off = torch.tensor(cfg.field_offsets, dtype=sparse_ids.dtype, device=sparse_ids.device)
    return sparse_ids + off[None, :]


def _field_embeddings(params, cfg: RecsysConfig, sparse_ids: torch.Tensor, par: _Par | None) -> torch.Tensor:
    """[B, F] per-field ids -> [B, F, D]."""
    return lookup(params["table"], _field_ids(cfg, sparse_ids), _split(par, "table"))


def _fm_logit(params, cfg: RecsysConfig, sparse_ids: torch.Tensor, par: _Par | None) -> torch.Tensor:
    """Rendle's O(nk) sum-square trick: ½((Σv)² − Σv²)."""
    idx = _field_ids(cfg, sparse_ids)
    v = lookup(params["table"], idx, _split(par, "table"))  # [B, F, K]
    lin = lookup(params["w_linear"], idx, _split(par, "w_linear")).sum(dim=-1)  # [B]
    s = v.sum(dim=1)  # [B, K]
    pair = 0.5 * (s * s - (v * v).sum(dim=1)).sum(dim=-1)
    return params["w0"] + lin + pair


def _autoint_logit(params, cfg: RecsysConfig, sparse_ids: torch.Tensor, par: _Par | None) -> torch.Tensor:
    x = _field_embeddings(params, cfg, sparse_ids, par)  # [B, F, D]
    for layer in params["attn_layers"]:
        q = torch.einsum("bfd,dhk->bfhk", x, layer["wq"])
        k = torch.einsum("bfd,dhk->bfhk", x, layer["wk"])
        v = torch.einsum("bfd,dhk->bfhk", x, layer["wv"])
        s = torch.einsum("bfhk,bghk->bhfg", q, k) / math.sqrt(cfg.d_attn)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhfg,bghk->bfhk", a, v)
        o = o.reshape(*o.shape[:2], -1)  # [B, F, H*K]
        x = torch.relu(o + x @ layer["w_res"])
    flat = x.reshape(x.shape[0], -1)
    return _cols(flat, params["w_out"], _split(par, "w_out"))[:, 0]


def _dcn_logit(params, cfg: RecsysConfig, sparse_ids: torch.Tensor, dense: torch.Tensor,
               par: _Par | None) -> torch.Tensor:
    emb = _field_embeddings(params, cfg, sparse_ids, par).reshape(sparse_ids.shape[0], -1)
    x0 = torch.cat([dense.to(emb.dtype), emb], dim=-1)  # [B, X]
    x = x0
    for i in range(cfg.n_cross_layers):
        xw = _cols(x, params["cross_w"][i], _split(par, "cross_w")) + params["cross_b"][i]
        x = x0 * xw + x  # DCN-v2 cross
    h = x0
    for j, layer in enumerate(params["mlp"]):
        # the bias after the gather: it is whole on every rank
        h = torch.relu(_cols(h, layer["w"], _split(par, f"mlp/{j}/w")) + layer["b"])
    cat = torch.cat([x, h], dim=-1)
    return _cols(cat, params["w_out"], _split(par, "w_out"))[:, 0]


def _squash(x: torch.Tensor) -> torch.Tensor:
    n2 = (x * x).sum(dim=-1, keepdim=True)
    return x * (n2 / (1.0 + n2)) / torch.sqrt(torch.clamp(n2, min=1e-9))


def _mind_interests(params, cfg: RecsysConfig, hist_ids: torch.Tensor, par: _Par | None) -> torch.Tensor:
    """Behavior-to-Interest dynamic routing -> [B, n_interests, D].  The
    routing has no stop-gradient: its three unrolled iterations carry
    gradients, as in the reference."""
    e = embedding_bag_gather(params["table"], hist_ids, mesh=_split(par, "table"))  # [B, T, D] w/ mask 0
    mask = (hist_ids >= 0).to(e.dtype)[..., None]
    eh = (e @ params["bilinear"]) * mask
    b = torch.zeros((*hist_ids.shape, cfg.n_interests), dtype=e.dtype, device=e.device)  # routing logits
    for _ in range(cfg.capsule_iters):  # static unroll (§MIND routing)
        c = torch.softmax(b, dim=-1) * mask  # [B, T, I]
        s = torch.einsum("bti,btd->bid", c, eh)
        u = _squash(s)  # [B, I, D]
        b = b + torch.einsum("bid,btd->bti", u, eh)
    return u


# ---------------------------------------------------------------------------
# public API: loss / score / retrieval
# ---------------------------------------------------------------------------


def recsys_score(params, batch: dict[str, torch.Tensor], cfg: RecsysConfig) -> torch.Tensor:
    par = _par(cfg)
    if cfg.model == "fm":
        return _fm_logit(params, cfg, batch["sparse_ids"], par)
    if cfg.model == "autoint":
        return _autoint_logit(params, cfg, batch["sparse_ids"], par)
    if cfg.model == "dcn_v2":
        return _dcn_logit(params, cfg, batch["sparse_ids"], batch["dense"], par)
    if cfg.model == "mind":
        interests = _mind_interests(params, cfg, batch["hist_ids"], par)  # [B, I, D]
        target = lookup(params["table"], batch["target_id"], _split(par, "table"))  # [B, D]
        return torch.einsum("bid,bd->bi", interests, target).amax(dim=-1)
    raise ValueError(cfg.model)


def _global_mean(total: torch.Tensor, rows: int, par: _Par) -> torch.Tensor:
    """The mean over the global batch: this rank's ``total`` over its
    ``rows``, both summed over the data axes (a batch whole on every data
    rank counts once per rank in both)."""
    da = data_axes(par.mesh)
    count = torch.tensor(float(rows), device=total.device)
    return reduce_from(total, par.mesh, da) / all_reduce(count, par.mesh, da)


def recsys_loss(params, batch: dict[str, torch.Tensor], cfg: RecsysConfig, *,
                rows=None) -> tuple[torch.Tensor, dict]:
    """The mean loss over the global batch.  ``rows``: the mesh axes this
    rank's batch rows are a block of (``None``: every rank holds the whole
    batch); MIND takes its in-batch negatives from every such block."""
    par = _par(cfg)
    if cfg.model == "mind":
        # in-batch sampled softmax with label-aware attention (p=2)
        interests = _mind_interests(params, cfg, batch["hist_ids"], par)
        targets = lookup(params["table"], batch["target_id"], _split(par, "table"))  # [B, D]
        att = torch.softmax(2.0 * torch.einsum("bid,bd->bi", interests, targets), dim=-1)
        user = torch.einsum("bi,bid->bd", att, interests)  # [B, D]
        labels = torch.arange(user.shape[0], device=user.device)
        if par is not None and rows is not None:
            # the global batch's targets; this rank's rows sit at its offset
            labels = labels + par.mesh.coord(rows) * user.shape[0]
            targets = fsdp_gather(targets, par.mesh, rows, 0)
        logits = user @ targets.T  # in-batch negatives
        # the mean of logsumexp(row) - row[label]: one [B, B] tensor in the
        # backward (at train_batch's 65,536 rows each is 17.2 GB)
        if par is None:
            loss = F.cross_entropy(logits, labels)
        else:
            loss = _global_mean(F.cross_entropy(logits, labels, reduction="sum"), user.shape[0], par)
        return loss, {"loss": loss}
    logit = recsys_score(params, batch, cfg).float()
    y = batch["label"].float()
    per = torch.clamp(logit, min=0.0) - logit * y + torch.log1p(torch.exp(-torch.abs(logit)))
    loss = torch.mean(per) if par is None else _global_mean(per.sum(), per.shape[0], par)
    return loss, {"loss": loss}


def recsys_retrieval_score(params, batch: dict[str, torch.Tensor], cfg: RecsysConfig) -> torch.Tensor:
    """One context vs n_candidates as one batched forward (no loops).

    ``batch["cand_ids"]``: [C] candidate item ids (field 0 for CTR models).
    """
    par = _par(cfg)
    cand = batch["cand_ids"]  # [C]
    if cfg.model == "mind":
        interests = _mind_interests(params, cfg, batch["hist_ids"], par)  # [1, I, D]
        cand_emb = lookup(params["table"], cand, _split(par, "table"))  # [C, D]
        return torch.einsum("bid,cd->bci", interests, cand_emb).amax(dim=-1)[0]
    # CTR models: broadcast the context row across candidates (item = field 0)
    ctx = batch["sparse_ids"]  # [1, F]
    c = cand.shape[0]
    ids = ctx.expand(c, ctx.shape[1]).clone()
    ids[:, 0] = cand
    b2 = {"sparse_ids": ids}
    if cfg.model == "dcn_v2":
        b2["dense"] = batch["dense"].expand(c, batch["dense"].shape[1])
    return recsys_score(params, b2, cfg)
