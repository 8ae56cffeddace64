"""Shared transformer layers: RMSNorm, RoPE, GQA attention (chunked
flash-style with causal and sliding-window masks, decode), SwiGLU MLP.

The reference's (``repro/models/layers.py``) pure functions as torch ops, in
its order of operations: statistics in float32 and cast back, RoPE on split
halves in float32, attention with a float32 online softmax.

Where the reference asks a bfloat16 ``einsum`` for a float32 result
(``preferred_element_type=float32``), the port multiplies in the operands'
dtype and casts the product to float32: on a bfloat16 model that product is
rounded to bfloat16 first (cuBLAS and the CPU both accumulate in float32,
then round).  On a float32 model the two are the same computation.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "rms_norm",
    "rope",
    "flash_attention",
    "attention_plain",
    "decode_attention",
    "decode_attention_merged",
    "swiglu",
    "dense_init",
]


def dense_init(gen: torch.Generator, shape: tuple[int, ...], dtype=torch.bfloat16,
               scale: float | None = None) -> torch.Tensor:
    """Normal(0, 1) x ``scale`` (default fan-in ** -0.5, the fan-in being
    ``shape[-2]``) drawn in float32 from ``gen`` on its device, cast to
    ``dtype``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device) * s).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * gamma.float()).to(x.dtype)


def _rope_angles(positions: torch.Tensor, d_head: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    half = d_head // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs  # [..., S, half]
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    cos = cos[..., None, :]  # head axis
    sin = sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as float32 (see the module docstring)."""
    return torch.matmul(a, b).float()


def _tile_mask(q_lo: int, kv_lo: int, q_chunk: int, kv_chunk: int, causal: bool,
               sliding_window: int | None, device) -> torch.Tensor | None:
    """The [Cq, Ckv] mask of the tile whose first query and key sit at
    absolute positions ``q_lo`` and ``kv_lo``; None when it keeps every
    score."""
    q_hi, kv_hi = q_lo + q_chunk - 1, kv_lo + kv_chunk - 1
    if (not causal or kv_hi <= q_lo) and (sliding_window is None or kv_lo > q_hi - sliding_window):
        return None
    q_pos = q_lo + torch.arange(q_chunk, device=device)
    kv_pos = kv_lo + torch.arange(kv_chunk, device=device)
    mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if sliding_window is not None:
        mask &= kv_pos[None, :] > q_pos[:, None] - sliding_window
    return mask


def _tile_is_dead(q_lo: int, kv_lo: int, q_chunk: int, kv_chunk: int, causal: bool,
                  sliding_window: int | None) -> bool:
    """Every score of the tile masked: the reference's update is then the
    identity (``corr`` 1, ``p`` 0), so the tile is skipped."""
    if causal and kv_lo > q_lo + q_chunk - 1:
        return True
    return sliding_window is not None and kv_lo + kv_chunk - 1 <= q_lo - sliding_window


def flash_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,  # [B, Skv, Hkv, D]
    *,
    causal: bool = True,
    q_offset: int = 0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    sliding_window: int | None = None,
) -> torch.Tensor:
    """Online-softmax (FlashAttention-style) chunked attention.

    Per q-chunk, the KV tiles in order, each updating float32 row maxima
    ``m``, sums ``l`` and the accumulator ``acc``, with the reference's
    guards for rows masked so far.  Query head ``h`` reads KV head
    ``h // n_rep``: a q-chunk is viewed as ``[B, Hkv, n_rep * Cq, D]`` so
    each KV tile is multiplied once, never repeated.  A chunk that does not
    divide its sequence falls back to the largest common divisor.

    The tiles walked are the reference's: under its balanced causal pairing
    (causal, no window, an even number >= 2 of equal q and KV chunks) q-chunk
    ``qi`` reads tiles ``0..qi``; otherwise it reads every tile, and the port
    skips those masked for every query of the chunk, whose update is the
    identity.  Masks compare absolute positions (``q_offset`` shifts the
    queries); a tile no score of which is masked skips the mask ops.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    n_rep = hq // hkv
    scale = d ** -0.5

    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    if sq % q_chunk:  # degrade to the largest divisor (odd smoke shapes)
        q_chunk = math.gcd(sq, q_chunk)
    if skv % kv_chunk:
        kv_chunk = math.gcd(skv, kv_chunk)
    nq, nkv = sq // q_chunk, skv // kv_chunk
    balanced = causal and sliding_window is None and nq >= 2 and nq % 2 == 0 and q_chunk == kv_chunk

    qt = q.transpose(1, 2)  # [B, Hq, Sq, D]
    kt = k.permute(0, 2, 3, 1)  # [B, Hkv, D, Skv]
    vt = v.transpose(1, 2)  # [B, Hkv, Skv, D]
    dev = q.device
    rows = (b, hkv, n_rep, q_chunk)  # query head h = kv * n_rep + r
    outs = []
    for qi in range(nq):
        q_lo = q_offset + qi * q_chunk
        q_tile = qt[:, :, qi * q_chunk:(qi + 1) * q_chunk].reshape(b, hkv, n_rep * q_chunk, d)
        m = torch.full(rows, -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((*rows, d), dtype=torch.float32, device=dev)
        for ki in range(qi + 1 if balanced else nkv):
            kv_lo = ki * kv_chunk
            if not balanced and _tile_is_dead(q_lo, kv_lo, q_chunk, kv_chunk, causal, sliding_window):
                continue
            mask = _tile_mask(q_lo, kv_lo, q_chunk, kv_chunk, causal, sliding_window, dev)
            k_tile = kt[..., kv_lo:kv_lo + kv_chunk]
            v_tile = vt[:, :, kv_lo:kv_lo + kv_chunk]
            s = (_dot_f32(q_tile, k_tile) * scale).view(*rows, kv_chunk)
            if mask is not None:
                s = torch.where(mask, s, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows
            m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            if mask is not None:
                p = torch.where(mask, p, 0.0)
            corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
            l = l * corr + p.sum(dim=-1)
            pv = _dot_f32(p.to(v_tile.dtype).view(b, hkv, n_rep * q_chunk, kv_chunk), v_tile)
            acc = acc * corr[..., None] + pv.view(*rows, d)
            m = m_new
        out = (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)
        outs.append(out.view(b, hq, q_chunk, d))
    # [B, Hq, Sq, D] -> [B, Sq, Hq, D]
    return torch.cat(outs, dim=2).transpose(1, 2).contiguous()


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    sliding_window: int | None = None,
) -> torch.Tensor:
    """The function ``flash_attention`` computes, as one masked softmax in
    float32 over every key (GQA by repeating KV heads).  A plain version for
    tests; the model never calls it."""
    b, sq, hq, d = q.shape
    n_rep = hq // k.shape[2]
    kf = k.float().repeat_interleave(n_rep, dim=2)
    vf = v.float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * d ** -0.5
    q_pos = q_offset + torch.arange(sq, device=q.device)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if sliding_window is not None:
        mask &= kv_pos[None, :] > q_pos[:, None] - sliding_window
    s = torch.where(mask, s, -math.inf)
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)  # a row with no key reads 0
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, D]
    k_cache: torch.Tensor,  # [B, S, Hkv, D]
    v_cache: torch.Tensor,  # [B, S, Hkv, D]
    cache_len: torch.Tensor | int,  # valid prefix length
    sliding_window: int | None = None,
) -> torch.Tensor:
    """Single-token attention against a KV cache, GQA-aware (query heads
    ``kv * n_rep + r`` read KV head ``kv``; the cache is never repeated)."""
    b, s, hkv, d = k_cache.shape
    hq = q.shape[2]
    n_rep = hq // hkv
    q2 = q.reshape(b, hkv, n_rep, d)
    scale = d ** -0.5
    scores = _dot_f32(q2, k_cache.permute(0, 2, 3, 1)) * scale  # [B, Hkv, r, S]
    pos = torch.arange(s, device=q.device)
    n = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    mask = pos[None, :] < n
    if sliding_window is not None:
        mask &= pos[None, :] >= n - sliding_window
    scores = torch.where(mask[:, None, None, :], scores, -math.inf)
    p = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = _dot_f32(p, v_cache.transpose(1, 2))  # [B, Hkv, r, D]
    return out.reshape(b, 1, hq, d).to(q.dtype)


def decode_attention_merged(
    q: torch.Tensor,  # [B, 1, Hq, D]
    k_cache: torch.Tensor,  # [B, s, Hkv, D]: the valid positions this rank holds (s may be 0)
    v_cache: torch.Tensor,  # [B, s, Hkv, D]
    reduce=None,
) -> torch.Tensor:
    """``decode_attention`` over the valid positions alone, where a cache
    split along its positions between ranks gives each rank a run of them (a
    rank with none passes an empty run).  ``reduce(x, op)`` merges the
    ranks' tensors: ``"max"`` of the score maxima (-inf from a rank with no
    position), then ``"sum"`` of the sums of exps and of the products with
    V, each product rounded to the model dtype as ``decode_attention``
    rounds its one.  With ``reduce=None`` (one rank holding every valid
    position) it is ``decode_attention`` on that run."""
    b, s, hkv, d = k_cache.shape
    hq = q.shape[2]
    n_rep = hq // hkv
    reduce = reduce or (lambda x, op: x)
    q2 = q.reshape(b, hkv, n_rep, d)
    scores = _dot_f32(q2, k_cache.permute(0, 2, 3, 1)) * d ** -0.5  # [B, Hkv, r, s]
    m_loc = scores.amax(dim=-1) if s else torch.full((b, hkv, n_rep), -math.inf, device=q.device)
    m = reduce(m_loc, "max")  # finite: some rank holds the token's own position
    e = torch.exp(scores - m[..., None])
    l = reduce(e.sum(dim=-1), "sum")
    p = (e / l[..., None]).to(v_cache.dtype)
    out = reduce(_dot_f32(p, v_cache.transpose(1, 2)).to(q.dtype), "sum")  # [B, Hkv, r, D]
    return out.reshape(b, 1, hq, d)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    g = _dot_f32(x, w_gate)
    u = _dot_f32(x, w_up)
    h = (F.silu(g) * u).to(x.dtype)
    return _dot_f32(h, w_down).to(x.dtype)
