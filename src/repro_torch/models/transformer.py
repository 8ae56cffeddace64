"""Decoder-only transformer family (dense / GQA / MoE / sliding-window).

The reference's ``repro/models/transformer.py`` as torch ops: one code path
for the five LM architectures, parameters stacked along a leading layer axis
(the reference's scanned layout, so checkpoint leaves match in order and
shape), a per-layer (or per-``remat_block``-layers) activation checkpoint
through ``torch.utils.checkpoint``, chunked online-softmax attention
(``layers.flash_attention``) and a full or sliding-window KV cache.

Step functions (run by the dry-run and the trainer):
  * ``loss_fn``       — next-token cross-entropy (+ MoE aux), for train_4k
  * ``prefill_step``  — full-sequence forward, emits the KV cache + last logits
  * ``decode_step``   — one token against a KV cache, for decode_32k/long_500k

A config with ``moe`` set gives every layer an MoE FFN (``models/moe.py``) in
place of the dense one; with ``moe_interleave`` 2 as well, the stack is one
of blocks, each a dense sublayer then an MoE sublayer (``{"dense_sub",
"moe_sub"}``, stacked over ``n_layers // moe_interleave`` blocks), and cache
layer ``2i`` is block i's dense sublayer, ``2i + 1`` its MoE sublayer.
Under a device mesh (``launch.mesh.use_mesh``) of more than one rank, the
parameters are this rank's shards by ``parallel.sharding.lm_param_specs``
(after ``sanitize_specs``: a dim the model axis does not divide is
replicated) and the batch its ``data`` share, and the collectives GSPMD
inserts for the reference are written out (``parallel.collectives``):
Megatron tensor parallelism over ``model`` — ``wq``/``wk``/``wv``/
``w_gate``/``w_up`` column-split behind ``copy_to``, ``wo``/``w_down``
row-split into ``reduce_from`` (the bf16 payload), ``embed`` split on D
(gathered after the lookup), ``unembed`` on V (vocab-parallel logits: the
max and the sum of ``logsumexp`` all-reduced, the gold logit from the rank
that owns it); ``wk``/``wv`` replicated when ``n_kv_heads`` does not divide
the model axis, each rank taking the kv heads of its own q heads.  Where
``wq``'s columns split mid-head (or its heads do not map onto whole kv
heads), the q columns are all-gathered (their gradient reduce-scattered),
every rank attends with every head and feeds its own columns of the output
to its ``wo`` rows.  A weight that does not split (``wq``/``wo``, the FFN,
``embed``, ``unembed``) runs whole on every rank.  Decode under a model
axis is context-parallel where the cache's sequence dim splits (the
reference's ``P(None, data, "model", None, None)``): each rank holds S / tp
positions of every layer, the token's q (every head) and K/V are gathered,
the rank holding the token's row writes it, and the softmax statistics are
merged over ``model`` (``layers.decode_attention_merged``).  With ``fsdp``
each layer's weights, sharded over ``data`` on a second dim, are gathered
inside its checkpoint (``fsdp_gather_layer``: the backward re-gathers and
reduce-scatters the gradient), and so are ``embed`` and ``unembed``.  The
loss is the global masked mean.  A mesh of one rank runs the ops of no
mesh.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

import torch.distributed as dist

from ..launch.mesh import current_mesh
from ..parallel.collectives import all_gather, all_reduce, copy_to, fsdp_gather, gather_from, reduce_from
from ..parallel.sharding import P, data_axes, fsdp_gather_layer, lm_param_specs, sanitize_specs
from ..tree import tree_flatten, tree_unflatten
from .layers import _dot_f32, decode_attention_merged, dense_init, flash_attention, rms_norm, rope
from .moe import MoEConfig, moe_ffn, moe_layout

__all__ = [
    "TransformerConfig",
    "init_params",
    "param_shapes",
    "forward",
    "loss_fn",
    "prefill_step",
    "decode_step",
]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    moe: MoEConfig | None = None
    moe_interleave: int = 1  # 2 = alternate dense/MoE FFNs (Llama-4 style)
    rope_theta: float = 10000.0
    sliding_window: int | None = None
    remat: bool = True
    remat_block: int = 1  # sqrt-remat: checkpoint every `remat_block` layers
    microbatches: int = 1  # gradient-accumulation chunks per train step
    fsdp: bool = False  # ZeRO-3: params+opt sharded over `data`, gathered per layer
    q_chunk: int = 1024
    kv_chunk: int = 1024
    aux_loss_weight: float = 0.01
    dtype: str = "bfloat16"

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def n_moe_layers(self) -> int:
        if self.moe is None:
            return 0
        return self.n_layers // self.moe_interleave

    def _attn_params(self) -> int:
        d, dh = self.d_model, self.d_head
        return d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh + self.n_heads * dh * d

    def param_count(self) -> int:
        """Total parameters N (for MODEL_FLOPS = 6*N*D bookkeeping)."""
        d = self.d_model
        attn = self._attn_params()
        n_moe = self.n_moe_layers
        n_dense = self.n_layers - n_moe
        ffn_dense = 3 * d * self.d_ff
        total = n_dense * (attn + ffn_dense + 2 * d)
        if self.moe is not None:
            ffn_moe = 3 * d * self.moe.d_ff * self.moe.n_experts + d * self.moe.n_experts
            if self.moe.n_shared_experts:
                ffn_moe += 3 * d * self.moe.d_ff * self.moe.n_shared_experts
            total += n_moe * (attn + ffn_moe + 2 * d)
        return total + 2 * self.vocab * d + d

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        attn = self._attn_params()
        n_moe = self.n_moe_layers
        n_dense = self.n_layers - n_moe
        ffn_moe = 3 * d * self.moe.d_ff * (self.moe.top_k + self.moe.n_shared_experts)
        total = n_dense * (attn + 3 * d * self.d_ff + 2 * d)
        total += n_moe * (attn + ffn_moe + 2 * d)
        return total + 2 * self.vocab * d + d


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_layout(cfg: TransformerConfig, n: int, use_moe: bool) -> dict[str, Any]:
    """One layer's parameters, stacked ``n`` deep: ``("ones", shape)`` or
    ``("dense", shape, scale[, dtype])`` entries."""
    d, dh = cfg.d_model, cfg.d_head
    p: dict[str, Any] = {
        "ln1": ("ones", (n, d)),
        "ln2": ("ones", (n, d)),
        "wq": ("dense", (n, d, cfg.n_heads * dh), None),
        "wk": ("dense", (n, d, cfg.n_kv_heads * dh), None),
        "wv": ("dense", (n, d, cfg.n_kv_heads * dh), None),
        "wo": ("dense", (n, cfg.n_heads * dh, d), None),
    }
    if use_moe:
        p["moe"] = moe_layout(d, cfg.moe, (n,))
    else:
        p["ffn"] = {
            "w_gate": ("dense", (n, d, cfg.d_ff), None),
            "w_up": ("dense", (n, d, cfg.d_ff), None),
            "w_down": ("dense", (n, cfg.d_ff, d), None),
        }
    return p


def _interleaved(cfg: TransformerConfig) -> bool:
    return cfg.moe is not None and cfg.moe_interleave > 1


def _layout(cfg: TransformerConfig) -> dict[str, Any]:
    """Every parameter's shape and init; layer leaves carry the leading
    layer (or block) axis."""
    d = cfg.d_model
    if _interleaved(cfg):
        # blocks of (dense layer, moe layer)
        n_blocks = cfg.n_layers // cfg.moe_interleave
        layers = {"dense_sub": _layer_layout(cfg, n_blocks, False), "moe_sub": _layer_layout(cfg, n_blocks, True)}
    else:
        layers = _layer_layout(cfg, cfg.n_layers, cfg.moe is not None)
    return {
        "embed": ("dense", (cfg.vocab, d), 0.02),
        "layers": layers,
        "final_norm": ("ones", (d,)),
        "unembed": ("dense", (d, cfg.vocab), None),
    }


def _build(layout: dict[str, Any], make) -> dict[str, Any]:
    return {k: _build(v, make) if isinstance(v, dict) else make(*v) for k, v in layout.items()}


def init_params(key: int | torch.Generator, cfg: TransformerConfig, *, device="cuda") -> dict[str, Any]:
    """Random parameters from ``key`` (a seed, or a ``torch.Generator`` on
    ``device``): embeddings N(0, 0.02), matrices N(0, fan_in ** -0.5), norms
    ones, in ``cfg.dtype`` (MoE routers in float32).  The reference draws
    from ``jax.random``, which torch cannot reproduce: ``models/convert.py``
    carries its parameters across."""
    dev = torch.device(device)
    gen = key if isinstance(key, torch.Generator) else torch.Generator(device=dev).manual_seed(key)
    dt = cfg.torch_dtype

    def make(kind, shape, scale=None, dtype=None):
        if kind == "ones":
            return torch.ones(shape, dtype=dt, device=dev)
        return dense_init(gen, shape, dtype or dt, scale=scale)

    return _build(_layout(cfg), make)


def param_shapes(cfg: TransformerConfig) -> dict[str, Any]:
    """``init_params``'s tree as ``device="meta"`` tensors (no allocation)."""
    dt = cfg.torch_dtype
    return _build(_layout(cfg), lambda kind, shape, scale=None, dtype=None: torch.empty(
        shape, dtype=dtype or dt, device="meta"))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class _Par:
    """How the current mesh shards a config: the model axis's size ``tp``
    and this rank's index on it, the data axes and their size, and the
    param specs (``sanitize_specs`` of ``lm_param_specs``)."""

    mesh: Any
    tp: int
    col: int
    da: Any
    n_data: int
    kv_split: bool
    specs: dict
    # "heads": each rank attends with its own q heads; "columns": wq's
    # columns split, but not into heads that map onto whole kv heads, so
    # every rank attends with every head; "whole": wq and wo replicated
    attn: str
    ffn_split: bool  # the dense FFN's hidden dim over `model`
    embed_split: bool  # embed's D over `model`
    vocab_split: bool  # unembed's V over `model`

    def split(self, spec: P, dim: int, axis: str) -> bool:
        dims = list(spec)
        return dim < len(dims) and dims[dim] == axis


def _tp_size(mesh=None) -> int:
    """The model axis's size of ``mesh`` (default the current one); 1 with
    no mesh."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return mesh.axis_size("model")


@functools.lru_cache(maxsize=32)
def _par_for(cfg: TransformerConfig, mesh) -> _Par:
    tp = _tp_size(mesh)
    kv_shardable = cfg.n_kv_heads % tp == 0
    shapes = param_shapes(cfg)
    specs = sanitize_specs(lm_param_specs(shapes, kv_shardable=kv_shardable, fsdp=cfg.fsdp), shapes, mesh)
    layer = specs["layers"]["dense_sub"] if _interleaved(cfg) else specs["layers"]

    def split(spec: P, dim: int) -> bool:
        return tp > 1 and dim < len(spec) and spec[dim] == "model"

    hq_loc, group = cfg.n_heads // tp, cfg.n_heads // cfg.n_kv_heads
    if not split(layer["wq"], 2):
        attn = "whole"
    elif cfg.n_heads % tp == 0 and (kv_shardable or hq_loc % group == 0 or group % hq_loc == 0):
        attn = "heads"
    else:
        attn = "columns"
    da = data_axes(mesh)
    return _Par(mesh, tp, mesh.coord("model") if tp > 1 else 0, da, mesh.axis_size(da),
                kv_shardable and tp > 1, specs, attn, "ffn" in layer and split(layer["ffn"]["w_gate"], 2),
                split(specs["embed"], 1), split(specs["unembed"], 1))


def _par(cfg: TransformerConfig) -> _Par | None:
    """The current mesh's sharding of ``cfg``; None with no mesh or a mesh
    of one rank (which runs the ops of no mesh)."""
    mesh = current_mesh()
    if mesh is None or mesh.size == 1:
        return None
    return _par_for(cfg, mesh)


def _layer_specs(par: _Par | None, cfg: TransformerConfig) -> list:
    """The specs of one entry of the stack with its L dim dropped: one tree
    per sublayer (``_sublayers``' order)."""
    if par is None:
        return [None, None] if _interleaved(cfg) else [None]

    def drop(tree):
        return {k: drop(v) if isinstance(v, dict) else P(*v.dims[1:]) for k, v in tree.items()}

    layers = par.specs["layers"]
    return [drop(layers["dense_sub"]), drop(layers["moe_sub"])] if _interleaved(cfg) else [drop(layers)]


def _gathered(w: torch.Tensor, spec: P | None, par: _Par | None) -> torch.Tensor:
    """A top-level weight FSDP-sharded over ``data`` on dim 0, gathered."""
    if par is None or not par.split(spec, 0, "data"):
        return w
    return fsdp_gather(w, par.mesh, "data", 0)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _kv_slice(cfg: TransformerConfig, par: _Par) -> tuple[int, int]:
    """The kv heads this rank's q heads read when ``wk``/``wv`` are
    replicated over the model axis."""
    hq_loc, group = cfg.n_heads // par.tp, cfg.n_heads // cfg.n_kv_heads
    lo = par.col * hq_loc // group
    return lo, (par.col * hq_loc + hq_loc - 1) // group + 1


def _qkv(h: torch.Tensor, layer, cfg: TransformerConfig, positions: torch.Tensor, par: _Par | None = None):
    """(q, k, v) of the heads this rank attends with, and the layer's
    cache entries (k, v) of the heads it holds."""
    b, s, _ = h.shape
    dh = cfg.d_head
    x = rms_norm(h, layer["ln1"])
    if par is None or par.attn == "whole":
        q = (x @ layer["wq"]).view(b, s, -1, dh)
        k = (x @ layer["wk"]).view(b, s, -1, dh)
        v = (x @ layer["wv"]).view(b, s, -1, dh)
        k = rope(k, positions, cfg.rope_theta)
        return rope(q, positions, cfg.rope_theta), k, v, (k, v)
    x = copy_to(x, par.mesh, "model")
    q = x @ layer["wq"]
    if par.attn == "columns":
        # this rank's columns end mid-head: every rank attends with every
        # head (RoPE rotates whole heads), and the gather's backward sums
        # the ranks' shares of the gradient into each rank's columns
        q = fsdp_gather(q, par.mesh, "model", -1)
    q = rope(q.view(b, s, -1, dh), positions, cfg.rope_theta)
    if par.kv_split:
        k = rope((x @ layer["wk"]).view(b, s, -1, dh), positions, cfg.rope_theta)
        v = (x @ layer["wv"]).view(b, s, -1, dh)
        return q, k, v, (k, v)
    # replicated kv projections: every rank computes every kv head (the
    # cache's) and attends with those of its q heads; the weights' gradient
    # is summed over the model axis
    wk, wv = copy_to(layer["wk"], par.mesh, "model"), copy_to(layer["wv"], par.mesh, "model")
    k = rope((x @ wk).view(b, s, -1, dh), positions, cfg.rope_theta)
    v = (x @ wv).view(b, s, -1, dh)
    if par.attn == "columns":
        return q, k, v, (k, v)
    lo, hi = _kv_slice(cfg, par)
    return q, k[:, :, lo:hi], v[:, :, lo:hi], (k, v)


def _ffn(x: torch.Tensor, layer, cfg: TransformerConfig, par: _Par | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer's FFN and its MoE aux loss (0 for a dense FFN)."""
    if "moe" in layer:
        return moe_ffn(x, layer["moe"], cfg.moe)
    f = layer["ffn"]
    tp = par is not None and par.ffn_split
    xin = copy_to(x, par.mesh, "model") if tp else x
    g = _dot_f32(xin, f["w_gate"])
    u = _dot_f32(xin, f["w_up"])
    # w_down crosses the TP boundary: the all-reduce payload is bf16
    y = (F.silu(g) * u).to(x.dtype) @ f["w_down"]
    if tp:
        y = reduce_from(y, par.mesh, "model")
    return y, torch.zeros((), dtype=torch.float32, device=x.device)


def _attn_out(attn: torch.Tensor, layer, h: torch.Tensor, par: _Par | None, every_head: bool = False) -> torch.Tensor:
    """``h`` plus the attention output ``attn`` (the heads this rank
    attended with, or ``every_head``'s) through ``wo``: this rank's columns
    into its row split of ``wo``, summed over ``model``, where ``wo``
    splits."""
    if par is None or par.attn == "whole":
        return h + (attn @ layer["wo"]).to(h.dtype)
    if every_head:
        c = attn.shape[-1] // par.tp
        attn = attn[..., par.col * c:(par.col + 1) * c]
    return h + reduce_from(attn @ layer["wo"], par.mesh, "model").to(h.dtype)


def _layer_fwd(h: torch.Tensor, layer, cfg: TransformerConfig, positions: torch.Tensor,
               par: _Par | None = None, spec=None):
    b, s, _ = h.shape
    if par is not None and cfg.fsdp:
        layer = fsdp_gather_layer(layer, spec, par.mesh)
    q, k, v, kv = _qkv(h, layer, cfg, positions, par)
    attn = flash_attention(
        q, k, v,
        causal=True,
        q_chunk=cfg.q_chunk,
        kv_chunk=cfg.kv_chunk,
        sliding_window=cfg.sliding_window,
    ).reshape(b, s, -1)
    h = _attn_out(attn, layer, h, par, every_head=par is not None and par.attn == "columns")
    x = rms_norm(h, layer["ln2"])
    y, aux = _ffn(x, layer, cfg, par)
    return h + y, kv, aux


def _sublayers(layer, cfg: TransformerConfig) -> list:
    """One entry of the stack as the layers it runs in order: a block's
    dense then MoE sublayer, or the layer itself."""
    return [layer["dense_sub"], layer["moe_sub"]] if _interleaved(cfg) else [layer]


def _unstack(layers: dict[str, Any]) -> list[dict[str, Any]]:
    """The stacked layer tree as one tree per layer (views; the gradients
    flow back to the stacked leaves as one stack)."""
    leaves, treedef = tree_flatten(layers)
    per_leaf = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [p[i] for p in per_leaf]) for i in range(len(per_leaf[0]))]


def _embed(params, tokens: torch.Tensor, par: _Par | None) -> torch.Tensor:
    spec = par.specs["embed"] if par is not None else None
    h = F.embedding(tokens, _gathered(params["embed"], spec, par))
    if par is not None and par.embed_split:
        h = gather_from(h, par.mesh, "model", -1)  # D was split over the model axis
    return h


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig, collect_cache: bool = False):
    """tokens [B, S] -> (hidden [B, S, D], aux, optional cache [L,B,S,Hkv,Dh]x2)."""
    par = _par(cfg)
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None, :]
    h = _embed(params, tokens, par)
    layers = _unstack(params["layers"])
    specs = _layer_specs(par, cfg)
    n_stack = len(layers)
    rb = max(1, cfg.remat_block)
    if not (cfg.remat and rb > 1 and n_stack % rb == 0):
        rb = 1

    def block(hh, *block_layers):
        kvs, aux = [], torch.zeros((), dtype=torch.float32, device=hh.device)
        for layer in block_layers:
            a = 0.0
            for sub, spec in zip(_sublayers(layer, cfg), specs):
                hh, kv, a_sub = _layer_fwd(hh, sub, cfg, positions, par, spec)
                kvs.append(kv)
                a = a + a_sub
            aux = aux + a
        return hh, kvs, aux

    remat = cfg.remat and torch.is_grad_enabled()
    kvs = []
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, n_stack, rb):
        group = layers[i:i + rb]
        if remat:
            # sqrt-remat with rb > 1: the backward keeps one input per block
            h, kv, a = checkpoint(block, h, *group, use_reentrant=False)
        else:
            h, kv, a = block(h, *group)
        aux = aux + a
        if collect_cache:
            kvs.extend(kv)
    cache = None
    if collect_cache:
        cache = (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))
    h = rms_norm(h, params["final_norm"])
    return h, aux, cache


def _logits(h: torch.Tensor, params, par: _Par | None) -> torch.Tensor:
    """``h @ unembed`` in float32: this rank's vocabulary slice where the
    vocabulary splits over a model axis."""
    spec = par.specs["unembed"] if par is not None else None
    un = _gathered(params["unembed"], spec, par)
    if par is not None and par.vocab_split:
        h = copy_to(h, par.mesh, "model")
    return _dot_f32(h, un)


def loss_fn(params, batch: dict[str, torch.Tensor], cfg: TransformerConfig) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy; ``batch`` = {"tokens", "targets", "mask"}.
    Under a mesh, the masked mean over the global batch (every rank's
    share)."""
    par = _par(cfg)
    h, aux, _ = forward(params, batch["tokens"], cfg)
    logits = _logits(h, params, par)
    targets = batch["targets"].long()
    if par is None or not par.vocab_split:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    else:
        # vocab-parallel: the max and the sum over every rank's slice
        m = all_reduce(logits.detach().amax(dim=-1), par.mesh, "model", dist.ReduceOp.MAX)
        se = reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1), par.mesh, "model")
        logz = m + torch.log(se)
        v_loc = logits.shape[-1]
        local = targets - par.col * v_loc
        own = (local >= 0) & (local < v_loc)
        gold_loc = torch.gather(logits, -1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
        gold = reduce_from(torch.where(own, gold_loc, 0.0), par.mesh, "model")
    nll = logz - gold
    mask = batch["mask"].float()
    num, den = (nll * mask).sum(), mask.sum()
    if par is not None and par.n_data > 1:
        num = reduce_from(num, par.mesh, par.da)
        den = all_reduce(den, par.mesh, par.da)
    loss = num / torch.clamp(den, min=1.0)
    total = loss + cfg.aux_loss_weight * aux
    return total, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _full_logits(h: torch.Tensor, params, par: _Par | None) -> torch.Tensor:
    logits = _logits(h, params, par)
    if par is not None and par.vocab_split:
        logits = all_gather(logits, par.mesh, "model", -1)
    return logits


def prefill_step(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """Full-sequence forward; returns (last-token logits [B,V], kv cache).
    Under a mesh, of this rank's batch share, the logits and the cache
    whole over the model axis."""
    par = _par(cfg)
    h, _, (k_cache, v_cache) = forward(params, tokens, cfg, collect_cache=True)
    if par is not None and par.kv_split:
        k_cache = all_gather(k_cache, par.mesh, "model", 3)
        v_cache = all_gather(v_cache, par.mesh, "model", 3)
    return _full_logits(h[:, -1], params, par), {"k": k_cache, "v": v_cache}


def _sublayer_decode(hh, layer, kc, vc, cfg: TransformerConfig, positions, cache_len: int,
                     par: _Par | None = None, seq_split: bool = False):
    """One layer of ``decode_step``; writes the token's K and V into ``kc``
    and ``vc`` (this layer's [B, S, Hkv, Dh] views of the new cache, or
    with ``seq_split`` this rank's [B, S / tp, Hkv, Dh] slice of it)."""
    b = hh.shape[0]
    q, _, _, (k, v) = _qkv(hh, layer, cfg, positions, par)
    if par is not None and par.kv_split:
        k, v = (all_gather(t, par.mesh, "model", 2) for t in (k, v))  # the cache holds every kv head
    s_loc = kc.shape[1]
    off, s_cache = (par.col * s_loc, par.tp * s_loc) if seq_split else (0, s_loc)
    # lax.dynamic_update_slice: the start is clamped so the update fits
    row = min(max(cache_len, 0), s_cache - 1) - off
    if 0 <= row < s_loc:
        kc[:, row] = k[:, 0]
        vc[:, row] = v[:, 0]
    # the valid positions [lo, hi): for a sliding window shorter than the
    # cache, the last w positions — O(w) compute against an O(S) cache
    # (DESIGN.md §6) — with the slice's start clamped into the cache
    w = cfg.sliding_window
    if w is not None and s_cache > w:
        lo = min(max(cache_len + 1 - w, 0), s_cache - w)
        hi = lo + min(cache_len + 1, w)
    else:
        lo, hi = max(cache_len + 1 - w, 0) if w is not None else 0, min(cache_len + 1, s_cache)
    heads, reduce = slice(None), None
    own_heads = par is not None and par.attn == "heads"
    if seq_split:
        # context parallel: every head over this rank's run of the valid
        # positions, the softmax statistics merged over `model`
        lo, hi = min(max(lo - off, 0), s_loc), min(max(hi - off, 0), s_loc)
        reduce = functools.partial(_merge, par)
        q = all_gather(q, par.mesh, "model", 2) if own_heads else q
    elif own_heads:
        heads = slice(*_kv_slice(cfg, par))  # the rank's own heads, as train and prefill
    attn = decode_attention_merged(q, kc[:, lo:max(lo, hi), heads], vc[:, lo:max(lo, hi), heads], reduce)
    every_head = par is not None and (par.attn == "columns" or seq_split and own_heads)
    hh = _attn_out(attn.reshape(b, 1, -1), layer, hh, par, every_head)
    x = rms_norm(hh, layer["ln2"])
    return hh + _ffn(x, layer, cfg, par)[0]


def _merge(par: _Par, x: torch.Tensor, op: str) -> torch.Tensor:
    return all_reduce(x, par.mesh, "model", dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)


def decode_step(
    params,
    cache: dict[str, torch.Tensor],  # {"k","v"}: [L, B, S, Hkv, Dh]
    tokens: torch.Tensor,  # [B, 1]
    cache_len: torch.Tensor | int,  # scalar: filled prefix length
    cfg: TransformerConfig,
    *,
    seq_split: bool = False,
):
    """One new token with a KV cache of length ``cache_len``; returns (logits
    [B, V], the new cache).  The input cache is not written to.  Under a
    mesh, of this rank's batch share; under a model axis of more than one
    rank with ``seq_split``, ``cache`` is this rank's slice of the cache's
    positions (S / tp of them, in coordinate order: the reference's
    context-parallel layout) and so is the new cache it returns, else every
    rank holds the cache whole."""
    par = _par(cfg)
    seq_split = seq_split and par is not None and par.tp > 1
    n = int(cache_len)
    b = tokens.shape[0]
    positions = torch.full((b, 1), n, dtype=torch.int32, device=tokens.device)
    h = _embed(params, tokens, par)  # [B, 1, D]
    k_new, v_new = cache["k"].clone(), cache["v"].clone()
    specs = _layer_specs(par, cfg)
    subs = [(sub, spec) for layer in _unstack(params["layers"]) for sub, spec in zip(_sublayers(layer, cfg), specs)]
    for i, (sub, spec) in enumerate(subs):
        if par is not None and cfg.fsdp:
            sub = fsdp_gather_layer(sub, spec, par.mesh)
        h = _sublayer_decode(h, sub, k_new[i], v_new[i], cfg, positions, n, par, seq_split)
    h = rms_norm(h, params["final_norm"])
    return _full_logits(h[:, -1], params, par), {"k": k_new, "v": v_new}
