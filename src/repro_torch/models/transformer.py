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
``fsdp`` shards parameters over a device mesh in the reference; on one card
it changes nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..tree import tree_flatten, tree_unflatten
from .layers import _dot_f32, decode_attention, dense_init, flash_attention, rms_norm, rope
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
    fsdp: bool = False  # ZeRO-3 over a mesh's `data` axis; no effect on one card
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
# forward
# ---------------------------------------------------------------------------


def _qkv(h: torch.Tensor, layer, cfg: TransformerConfig, positions: torch.Tensor):
    b, s, _ = h.shape
    dh = cfg.d_head
    x = rms_norm(h, layer["ln1"])
    q = (x @ layer["wq"]).view(b, s, cfg.n_heads, dh)
    k = (x @ layer["wk"]).view(b, s, cfg.n_kv_heads, dh)
    v = (x @ layer["wv"]).view(b, s, cfg.n_kv_heads, dh)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _ffn(x: torch.Tensor, layer, cfg: TransformerConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer's FFN and its MoE aux loss (0 for a dense FFN)."""
    if "moe" in layer:
        return moe_ffn(x, layer["moe"], cfg.moe)
    f = layer["ffn"]
    g = _dot_f32(x, f["w_gate"])
    u = _dot_f32(x, f["w_up"])
    return (F.silu(g) * u).to(x.dtype) @ f["w_down"], torch.zeros((), dtype=torch.float32, device=x.device)


def _layer_fwd(h: torch.Tensor, layer, cfg: TransformerConfig, positions: torch.Tensor):
    b, s, _ = h.shape
    q, k, v = _qkv(h, layer, cfg, positions)
    attn = flash_attention(
        q, k, v,
        causal=True,
        q_chunk=cfg.q_chunk,
        kv_chunk=cfg.kv_chunk,
        sliding_window=cfg.sliding_window,
    ).reshape(b, s, cfg.n_heads * cfg.d_head)
    h = h + (attn @ layer["wo"]).to(h.dtype)
    x = rms_norm(h, layer["ln2"])
    y, aux = _ffn(x, layer, cfg)
    return h + y, (k, v), aux


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


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig, collect_cache: bool = False):
    """tokens [B, S] -> (hidden [B, S, D], aux, optional cache [L,B,S,Hkv,Dh]x2)."""
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None, :]
    h = F.embedding(tokens, params["embed"])
    layers = _unstack(params["layers"])
    n_stack = len(layers)
    rb = max(1, cfg.remat_block)
    if not (cfg.remat and rb > 1 and n_stack % rb == 0):
        rb = 1

    def block(hh, *block_layers):
        kvs, aux = [], torch.zeros((), dtype=torch.float32, device=hh.device)
        for layer in block_layers:
            a = 0.0
            for sub in _sublayers(layer, cfg):
                hh, kv, a_sub = _layer_fwd(hh, sub, cfg, positions)
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


def loss_fn(params, batch: dict[str, torch.Tensor], cfg: TransformerConfig) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy; ``batch`` = {"tokens", "targets", "mask"}."""
    h, aux, _ = forward(params, batch["tokens"], cfg)
    logits = _dot_f32(h, params["unembed"])
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["targets"].long()[..., None])[..., 0]
    nll = logz - gold
    mask = batch["mask"].float()
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    total = loss + cfg.aux_loss_weight * aux
    return total, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def prefill_step(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """Full-sequence forward; returns (last-token logits [B,V], kv cache)."""
    h, _, (k_cache, v_cache) = forward(params, tokens, cfg, collect_cache=True)
    logits = _dot_f32(h[:, -1], params["unembed"])
    return logits, {"k": k_cache, "v": v_cache}


def _sublayer_decode(hh, layer, kc, vc, cfg: TransformerConfig, positions, cache_len: int):
    """One layer of ``decode_step``; writes the token's K and V into ``kc``
    and ``vc`` (this layer's [B, S, Hkv, Dh] views of the new cache)."""
    b = hh.shape[0]
    q, k, v = _qkv(hh, layer, cfg, positions)
    s_cache = kc.shape[1]
    # lax.dynamic_update_slice: the start is clamped so the update fits
    row = min(max(cache_len, 0), s_cache - 1)
    kc[:, row] = k[:, 0]
    vc[:, row] = v[:, 0]
    w = cfg.sliding_window
    if w is not None and s_cache > w:
        # sub-quadratic long-context decode: attend only over the last
        # window — O(w) compute against an O(S) cache (DESIGN.md §6)
        start = min(max(cache_len + 1 - w, 0), s_cache - w)
        attn = decode_attention(q, kc[:, start:start + w], vc[:, start:start + w], min(cache_len + 1, w))
    else:
        attn = decode_attention(q, kc, vc, cache_len + 1, sliding_window=w)
    attn = attn.reshape(b, 1, cfg.n_heads * cfg.d_head)
    hh = hh + (attn @ layer["wo"]).to(hh.dtype)
    x = rms_norm(hh, layer["ln2"])
    return hh + _ffn(x, layer, cfg)[0]


def decode_step(
    params,
    cache: dict[str, torch.Tensor],  # {"k","v"}: [L, B, S, Hkv, Dh]
    tokens: torch.Tensor,  # [B, 1]
    cache_len: torch.Tensor | int,  # scalar: filled prefix length
    cfg: TransformerConfig,
):
    """One new token with a KV cache of length ``cache_len``; returns (logits
    [B, V], the new cache).  The input cache is not written to."""
    n = int(cache_len)
    b = tokens.shape[0]
    positions = torch.full((b, 1), n, dtype=torch.int32, device=tokens.device)
    h = F.embedding(tokens, params["embed"])  # [B, 1, D]
    k_new, v_new = cache["k"].clone(), cache["v"].clone()
    subs = [sub for layer in _unstack(params["layers"]) for sub in _sublayers(layer, cfg)]
    for i, sub in enumerate(subs):
        h = _sublayer_decode(h, sub, k_new[i], v_new[i], cfg, positions, n)
    h = rms_norm(h, params["final_norm"])
    logits = _dot_f32(h[:, -1], params["unembed"])
    return logits, {"k": k_new, "v": v_new}
