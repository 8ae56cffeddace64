"""Device-side, fixed-shape serving & index-build steps for ``paper_search``.

These are the programs the dry-run runs for the paper's own architecture —
the full query pipeline after host-side key lookup:

  ``serve_step``:  postings -> (scatter) per-cluster occupancy -> parallel
                   window cover -> §14 relevance -> per-query top-k docs.
  ``build_step``:  token streams -> windowed stop-lemma triple extraction
                   (the (f,s,t) index build cost model) -> key histogram.

Shapes: B queries x P postings x C candidate clusters x L lemmas x N window
positions — all static budgets (real serving packs variable work into these,
exactly like padded batching in LM serving).

Stage 2 of ``serve_step`` is ``kernels.proximity.proximity_window``: on a
CUDA tensor the cover kernel, one launch per call; on a CPU tensor its plain
version.  ``serve_step_plain`` and ``serve_step_sharded_plain`` are the same
functions with the plain cover on any device, for holding the kernel path to
it.  Scores are float32 sums taken in another order than the reference's, so
they agree within rtol 1e-5; every integer output is identical, and the
top-k keeps ``jax.lax.top_k``'s order (a stable descending sort: on ties the
lower cluster first).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels.proximity import COMPUTE_DTYPES, proximity_window, proximity_window_plain
from ..launch.mesh import current_mesh
from ..parallel.collectives import all_gather

__all__ = [
    "serve_step",
    "serve_step_plain",
    "serve_step_sharded",
    "serve_step_sharded_plain",
    "build_step",
]

_U32 = 0xFFFFFFFF


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 ``x`` reduced to int32's range (two's-complement wraparound),
    kept in int64: the value the reference's int32 arithmetic gives."""
    return ((x + (1 << 31)) & _U32) - (1 << 31)


def _stage_scatter(
    postings: torch.Tensor,  # [B, P, 3] int32: (cluster, rel_pos, lemma) pad=-1
    n_lemmas: int,
    n_clusters: int,
    window_len: int,
    cdt: torch.dtype,
) -> torch.Tensor:
    """Stage 1: the ``[B, C, L, N]`` occupancy in ``cdt``.

    The reference scatters with ``.at[flat].max(ok)`` per query over a flat
    ``C*L*N`` row: ``flat`` is int32 (wrapping), a negative index counts once
    from the end, an index past the end is dropped, and a posting that is not
    ``ok`` writes a 0, which changes nothing.  ``ok`` does not check
    ``cl < C`` or ``lem < L``, so ``lem >= L`` lands in the next cluster's
    rows.  Here the same per-row index is formed, the rule applied, and the
    row's int64 offset added; dropped postings write one spare slot past the
    end, so the scatter needs no host synchronization.
    """
    b = postings.shape[0]
    l, c, n = n_lemmas, n_clusters, window_len
    row_size = c * l * n
    cl, pos, lem = (postings[..., i].to(torch.int64) for i in range(3))
    ok = (cl >= 0) & (pos >= 0) & (pos < n) & (lem >= 0)
    flat = _wrap_i32((cl.clamp_min(0) * l + lem.clamp_min(0)) * n + pos.clamp_min(0))
    flat = torch.where(flat < 0, flat + row_size, flat)
    keep = ok & (flat >= 0) & (flat < row_size)
    row = torch.arange(b, dtype=torch.int64, device=postings.device)[:, None] * row_size
    spare = b * row_size
    index = torch.where(keep, row + flat, spare)
    occ = torch.zeros(spare + 1, dtype=cdt, device=postings.device)
    occ.index_fill_(0, index.reshape(-1), 1)
    return occ[:spare].view(b, c, l, n)


def _stage_score(
    emit: torch.Tensor,  # [B*C, N] bool
    start: torch.Tensor,  # [B*C, N] int32
    cluster_doc: torch.Tensor,  # [B, C] int32 (pad=-1)
    top_k: int,
) -> dict[str, torch.Tensor]:
    """Stage 3: §14 relevance ``1/(span+1)^2`` per emitted fragment, summed
    per cluster; padded clusters score -1.0; per-query top-k clusters."""
    b, c = cluster_doc.shape
    n = emit.shape[-1]
    span = torch.arange(n, dtype=torch.float32, device=emit.device)[None, :] - start.to(torch.float32)
    contrib = torch.where(emit, 1.0 / (span + 1.0) ** 2, 0.0)
    scores = contrib.sum(dim=-1).reshape(b, c)
    scores = torch.where(cluster_doc >= 0, scores, -1.0)
    top_scores, top_idx = _top_k(scores, min(top_k, c))
    return {
        "top_docs": torch.gather(cluster_doc, 1, top_idx),
        "top_scores": top_scores,
        "n_fragments": emit.reshape(b, c * n).sum(dim=1, dtype=torch.int32),
    }


def _top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: on ties the lower index first."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _serve(
    cover: Callable,
    postings: torch.Tensor,
    cluster_doc: torch.Tensor,
    mult: torch.Tensor,
    max_distance: int,
    n_clusters: int,
    window_len: int,
    top_k: int,
    compute_dtype: str,
) -> dict[str, torch.Tensor]:
    cdt = COMPUTE_DTYPES[compute_dtype]
    b, l = mult.shape
    occ = _stage_scatter(postings, l, n_clusters, window_len, cdt)
    occ2 = occ.view(b * n_clusters, l, window_len)
    mult2 = mult.repeat_interleave(n_clusters, dim=0).to(cdt)
    emit, start = cover(occ2, mult2, max_distance, compute_dtype=compute_dtype)
    return _stage_score(emit, start, cluster_doc, top_k)


def serve_step(
    postings: torch.Tensor,  # [B, P, 3] int32: (cluster, rel_pos, lemma) pad=-1
    cluster_doc: torch.Tensor,  # [B, C] int32 doc id per cluster (pad=-1)
    mult: torch.Tensor,  # [B, L] int32 subquery multiplicities
    *,
    max_distance: int,
    n_clusters: int,
    window_len: int,
    top_k: int = 16,
    compute_dtype: str = "uint8",  # §Perf-3: occupancy/prefix counts fit u8
) -> dict[str, torch.Tensor]:
    """One fixed-shape serving step: scatter §10.4 posting events into
    per-cluster occupancy, run the vectorized §10.2 window cover (the cover
    kernel on CUDA tensors), score §14 relevance and select per-query top-k
    docs.  Returns ``top_docs`` int32 ``[B, K]``, ``top_scores`` float32
    ``[B, K]`` and ``n_fragments`` int32 ``[B]``, K = ``min(top_k, C)``."""
    return _serve(proximity_window, postings, cluster_doc, mult, max_distance,
                  n_clusters, window_len, top_k, compute_dtype)


# elements of occupancy per plain-cover call: the plain version holds a few
# int64 copies of its input, about 6 GiB at this size
_PLAIN_CHUNK = 1 << 27


def _cover_plain(occ: torch.Tensor, mult: torch.Tensor, max_distance: int, compute_dtype: str):
    """``proximity_window_plain`` over blocks of rows (each row is
    independent), so a serving shape's plain cover fits beside the rest."""
    rows = max(1, _PLAIN_CHUNK // max(1, occ.shape[1] * occ.shape[2]))
    parts = [proximity_window_plain(occ[i:i + rows], mult[i:i + rows], max_distance, compute_dtype)
             for i in range(0, max(occ.shape[0], 1), rows)]
    if len(parts) == 1:
        return parts[0]
    return torch.cat([e for e, _ in parts]), torch.cat([s for _, s in parts])


def serve_step_plain(
    postings: torch.Tensor,
    cluster_doc: torch.Tensor,
    mult: torch.Tensor,
    *,
    max_distance: int,
    n_clusters: int,
    window_len: int,
    top_k: int = 16,
    compute_dtype: str = "uint8",
) -> dict[str, torch.Tensor]:
    """:func:`serve_step` with the cover's plain version on any device."""
    return _serve(_cover_plain, postings, cluster_doc, mult, max_distance,
                  n_clusters, window_len, top_k, compute_dtype)


def _serve_sharded(
    step: Callable,
    postings: torch.Tensor,
    cluster_doc: torch.Tensor,
    mult: torch.Tensor,
    max_distance: int,
    n_clusters: int,
    window_len: int,
    top_k: int,
    compute_dtype: str,
    mesh,
) -> dict[str, torch.Tensor]:
    ns, b, p_loc, _ = postings.shape
    kk = min(top_k, n_clusters)
    # the shard axis folded into the batch axis: one program (one cover
    # launch) over every shard's postings; shard s's query q is row s*B + q
    out = step(
        postings.reshape(ns * b, p_loc, 3),
        cluster_doc.reshape(ns * b, n_clusters),
        mult.repeat(ns, 1),
        max_distance=max_distance, n_clusters=n_clusters,
        window_len=window_len, top_k=kk, compute_dtype=compute_dtype,
    )
    docs = out["top_docs"].reshape(ns, b, kk)
    scores = out["top_scores"].reshape(ns, b, kk)
    nfrag = out["n_fragments"].reshape(ns, b)
    if mesh is not None and mesh.size > 1:
        # the tiny all-gather: every rank's [NS/W, B, K] lists (scores as
        # their bits) and fragment counts, in shard order, in one collective
        packed = torch.cat([docs.to(torch.int32), scores.contiguous().view(torch.int32),
                            nfrag.to(torch.int32)[..., None]], dim=-1)
        packed = all_gather(packed, mesh, mesh.axis_names, 0).contiguous()
        ns = packed.shape[0]
        docs = packed[..., :kk].to(out["top_docs"].dtype)
        scores = packed[..., kk:2 * kk].contiguous().view(scores.dtype)
        nfrag = packed[..., 2 * kk]
    # tree merge: [NS, B, K] -> global top-k per query
    docs_t = docs.transpose(0, 1).reshape(b, ns * kk)
    scores_t = scores.transpose(0, 1).reshape(b, ns * kk)
    top_scores, idx = _top_k(scores_t, min(top_k, ns * kk))
    return {
        "top_docs": torch.gather(docs_t, 1, idx),
        "top_scores": top_scores,
        "n_fragments": nfrag.sum(dim=0, dtype=torch.int32),
    }


def serve_step_sharded(
    postings: torch.Tensor,  # [NS, B, P_loc, 3] int32, cluster ids shard-local
    cluster_doc: torch.Tensor,  # [NS, B, C_loc] int32
    mult: torch.Tensor,  # [B, L]
    *,
    max_distance: int,
    n_clusters: int,  # C_loc (per shard)
    window_len: int,
    top_k: int = 16,
    compute_dtype: str = "uint8",
    mesh=None,
) -> dict[str, torch.Tensor]:
    """Document-sharded serving (§Perf-3 iteration 3, the deployed layout).

    Each shard owns one cluster shard's postings end-to-end: local scatter,
    local cover, local top-k, then a tree merge of the per-shard top-k
    lists.  The shard axis is folded into the batch axis, so a program's
    shards run in one :func:`serve_step` (one cover launch).  Under a mesh
    of W ranks (``mesh``, default the current one), ``postings`` and
    ``cluster_doc`` are this rank's block of NS/W shards (the reference's
    ``in_specs``: the shard axis over every mesh axis), and the per-shard
    lists of every rank are all-gathered in shard order before the merge —
    the reference's "tiny all-gather"; every rank returns the whole result.
    """
    mesh = current_mesh() if mesh is None else mesh
    return _serve_sharded(serve_step, postings, cluster_doc, mult, max_distance,
                          n_clusters, window_len, top_k, compute_dtype, mesh)


def serve_step_sharded_plain(
    postings: torch.Tensor,
    cluster_doc: torch.Tensor,
    mult: torch.Tensor,
    *,
    max_distance: int,
    n_clusters: int,
    window_len: int,
    top_k: int = 16,
    compute_dtype: str = "uint8",
    mesh=None,
) -> dict[str, torch.Tensor]:
    """:func:`serve_step_sharded` with the cover's plain version."""
    mesh = current_mesh() if mesh is None else mesh
    return _serve_sharded(serve_step_plain, postings, cluster_doc, mult, max_distance,
                          n_clusters, window_len, top_k, compute_dtype, mesh)


def _mul_u32(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x * k mod 2**32`` for int64 ``x`` in [0, 2**32): two 16-bit halves,
    so no int64 product overflows."""
    lo = (x & 0xFFFF) * k
    hi = ((x >> 16) * k) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def build_step(
    tokens: torch.Tensor,  # [B, N] int32 lemma FL-numbers
    is_stop: torch.Tensor,  # [B, N] bool
    *,
    max_distance: int,
    n_buckets: int = 65536,
) -> dict[str, torch.Tensor]:
    """Windowed (f,s,t) co-occurrence extraction over token streams.

    For every center position and offset pair (d1, d2), d1 < d2, both within
    ±MaxDistance: a triple posting exists when all three positions hold stop
    lemmas (a neighbour outside the stream is not one).  Postings are
    hash-bucketed (the shard-local histogram a real builder uses to size
    posting lists before the big segmented sort).  The reference's uint32
    hash runs in int64 reduced mod 2**32 after each product.
    """
    b, n = tokens.shape
    d = max_distance
    t32 = tokens.to(torch.int64) & _U32  # the uint32 view of int32 tokens
    stop = is_stop.to(torch.int32)

    def at(x: torch.Tensor, o: int) -> torch.Tensor:
        """``x[:, p + o]``, 0 where ``p + o`` is outside the stream."""
        out = torch.zeros_like(x)
        if o >= 0:
            out[:, : max(n - o, 0)] = x[:, o:]
        else:
            out[:, -o:] = x[:, : max(n + o, 0)]
        return out

    hist = torch.zeros((n_buckets,), dtype=torch.int32, device=tokens.device)
    total = torch.zeros((), dtype=torch.int64, device=tokens.device)
    h0 = _mul_u32(t32, 2654435761)
    offsets = [
        (d1, d2)
        for d1 in range(-d, d + 1)
        for d2 in range(-d, d + 1)
        if d1 != 0 and d2 != 0 and d1 < d2
    ]
    for d1, d2 in offsets:  # |offsets| = D*(2D-1)
        valid = stop * at(stop, d1) * at(stop, d2)
        h = (h0 ^ _mul_u32(at(t32, d1), 40503) ^ at(t32, d2)) % n_buckets
        hist.index_add_(0, h.reshape(-1), valid.reshape(-1))
        total += valid.sum()
    return {"bucket_histogram": hist, "n_postings": total.to(torch.int32)}
