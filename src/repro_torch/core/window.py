"""Vectorized reformulation of the Combiner's Step 3, on torch tensors.

The paper's Position-table machinery is sequential (queues, Bit Scan
Forward).  The vectorized form uses the same two invariants the paper does —

  (1) every reportable fragment has span ``<= 2 * MaxDistance`` (the Step-2
      gate), and
  (2) occurrences can be represented as *occupancy* over document positions
      (the Position table's 64-bit masks),

— and evaluates **all candidate windows in parallel** instead of walking a
queue:

  For local lemma ``l`` let ``occ[l, p] ∈ {0,1}`` be the occupancy and
  ``C[l, p] = Σ_{q<=p} occ[l, q]`` its prefix count.  The window ``[q, e]``
  covers the subquery iff  ``C[l,e] - C[l,q] + occ[l,q] >= mult[l]`` for all
  ``l``.  A fragment is emitted at every event position ``e`` where some
  ``q >= e - 2D`` covers; its start is the *largest* covering ``q`` — exactly
  the §10.2 shrink result.

This is the plain version of the CUDA cover kernel in
``kernels/proximity.py``; both compute the same function.
:func:`window_cover_rank_batch` is the same cover in O(L*N), and the
``results_from_cover*`` helpers read fragments out of an emission mask.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "window_cover",
    "window_cover_batch",
    "window_cover_rank_batch",
    "events_to_occupancy",
    "results_from_cover",
    "results_from_cover_batch",
]


def _wrap(x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Reduce int64 ``x`` to the value range of ``cdt`` (two's-complement
    wraparound), kept in int64 so every later op is exact."""
    if cdt == torch.int32:
        return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return x & ((1 << torch.iinfo(cdt).bits) - 1)


def window_cover_batch(
    occ: torch.Tensor,  # [B, L, N] occupancy per local lemma
    mult: torch.Tensor,  # [B, L] required multiplicity (0 = unused slot)
    window: int,  # 2*MaxDistance + 1 candidate window width
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position emission mask and fragment starts over a document batch.

    Returns ``(emit bool [B, N], start int32 [B, N])``: ``emit[b, e]`` is
    True where a minimal fragment ends at ``e``; ``start`` is its start
    position (``e`` where nothing covers).
    """
    # narrow compute dtype (§Perf-3): the cover test only ever looks at
    # *differences* of prefix counts over one candidate window, so unsigned
    # wraparound cancels — ``c - cq + oq`` is exact whenever the true window
    # count (<= window) fits the dtype, regardless of document length.  The
    # arithmetic runs in int64 reduced to the compute dtype's range after
    # every step, which is the compute dtype's own modular arithmetic.
    if occ.dtype in (torch.uint8, torch.uint16) and window <= torch.iinfo(occ.dtype).max:
        cdt = occ.dtype
    else:
        cdt = torch.int32
    occ = _wrap(occ.to(torch.int64), cdt)
    mult = _wrap(mult.to(torch.int64), cdt)[..., None]  # [B, L, 1]
    n = occ.shape[-1]
    active = mult > 0
    c = _wrap(torch.cumsum(occ, dim=-1), cdt)  # C[l, p]
    is_event = ((occ > 0) & active).any(dim=1)  # [B, N]

    def shifted(x: torch.Tensor, o: int) -> torch.Tensor:
        """x[..., p] -> x[..., p-o] with zero fill."""
        if o == 0:
            return x
        out = torch.zeros_like(x)
        if o < n:
            out[..., o:] = x[..., : n - o]
        return out

    pos = torch.arange(n, device=occ.device, dtype=torch.int32)
    found = torch.zeros(is_event.shape, dtype=torch.bool, device=occ.device)
    o_star = torch.zeros(is_event.shape, dtype=torch.int32, device=occ.device)
    for o in range(window):
        cnt = _wrap(c - shifted(c, o) + shifted(occ, o), cdt)  # occurrences in [e-o, e]
        cover = ((cnt >= mult) | ~active).all(dim=1)
        # a window must start inside the document
        cover &= pos >= o
        o_star = torch.where(cover & ~found, o, o_star)
        found |= cover
    return found & is_event, pos - o_star


def window_cover(
    occ: torch.Tensor,  # [L, N]
    mult: torch.Tensor,  # [L]
    window: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`window_cover_batch` for one document: ``([N], [N])``."""
    emit, start = window_cover_batch(occ[None], mult[None], window)
    return emit[0], start[0]


def window_cover_rank_batch(
    occ: torch.Tensor,  # [B, L, N] occupancy (any integer dtype)
    mult: torch.Tensor,  # [B, L]
    window: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank-based cover: same (emit, start) as :func:`window_cover_batch`
    in O(L*N) instead of O(window*L*N), on ``occ``'s device.

    ``[q, e]`` covers lemma ``l`` iff ``q <= p_l(e)``, where ``p_l(e)`` is
    the position of the ``mult[l]``-th latest occurrence of ``l`` at or
    before ``e``.  So the §10.2 shrink result is closed-form:

        start[e] = min over active l of p_l(e)          (largest covering q)
        emit[e]  = event(e)  and  e - start[e] < window

    ``p_l(e)`` is one gather: scatter occurrence positions by their prefix
    rank, then index with ``C[l, e] - mult[l]``.
    """
    b, l, n = occ.shape
    dev = occ.device
    m = b * l
    occ2 = (occ > 0).reshape(m, n)
    mult2 = mult.reshape(m, 1).to(torch.int32)
    active = mult2 > 0
    c = torch.cumsum(occ2, dim=-1, dtype=torch.int32)  # exact ranks, no wrap

    # P[row, r] = position of the (r+1)-th occurrence in the row; lanes
    # without an occurrence all write the one padding slot m * n
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    row = torch.arange(m, dtype=torch.int64, device=dev)[:, None] * n
    flat_rank = torch.where(occ2, row + (c - 1), m * n)
    p_table = torch.full((m * n + 1,), -1, dtype=torch.int32, device=dev)
    p_table[flat_rank.reshape(-1)] = pos.expand(m, n).reshape(-1)

    idx = c - mult2  # rank of the mult-th latest occurrence at/before e
    valid = (idx >= 0) | ~active
    # an active row's idx is at most n - 1; an inactive row's gather (its
    # idx may pass n for a negative mult) is masked out below
    p_le = p_table[row + idx.clamp(0, n - 1)]  # [M, N]
    p_le = torch.where(active & (idx >= 0), p_le, n)  # inactive -> +inf for min

    start = p_le.reshape(b, l, n).amin(dim=1)  # [B, N] largest covering q
    all_valid = valid.reshape(b, l, n).all(dim=1)
    is_event = (occ2.reshape(b, l, n) & active.reshape(b, l, 1)).any(dim=1)
    emit = is_event & all_valid & (start < n) & (pos - start < window)
    # match window_cover's convention: start defaults to e where no cover
    return emit, torch.where(emit, start, pos)


def events_to_occupancy(
    events_pos,  # [E] positions (pad = -1)
    events_lem,  # [E] local lemma ids
    n_lemmas: int,
    doc_len: int,
    device="cuda",
) -> torch.Tensor:
    """Scatter of (pos, lemma) events into dense int32 occupancy
    ``[n_lemmas, doc_len]`` on ``device``."""
    pos = torch.as_tensor(np.asarray(events_pos), device=device).long()
    lem = torch.as_tensor(np.asarray(events_lem), device=device).long()
    occ = torch.zeros((n_lemmas, doc_len), dtype=torch.int32, device=device)
    ok = pos >= 0
    occ[lem[ok], pos[ok]] = 1
    return occ


def results_from_cover(
    doc_id: int, emit: torch.Tensor, start: torch.Tensor
) -> list[tuple[int, int, int]]:
    """(doc, start, end) triples from the emission mask."""
    ends = torch.nonzero(torch.as_tensor(emit)).reshape(-1)
    starts = torch.as_tensor(start)[ends]
    return [(doc_id, int(s), int(e)) for s, e in zip(starts.tolist(), ends.tolist())]


def results_from_cover_batch(
    doc_ids: torch.Tensor,  # [B] global doc id per row (pad = -1)
    emit: torch.Tensor,  # [B, N] emission mask
    start: torch.Tensor,  # [B, N] fragment starts
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fragment readout over a whole emit batch, on the batch's device.

    One ``nonzero`` replaces the per-document loop: returns ``(rows, docs,
    starts, ends)`` — ``rows`` is the batch row of each fragment (callers map
    rows back to queries/segments), the other three are the fragment triples
    (``starts`` int64).  Padding rows (``doc_ids < 0``) emit nothing.
    """
    rows, ends = torch.nonzero(emit.bool() & (doc_ids >= 0)[:, None], as_tuple=True)
    return rows, doc_ids[rows], start[rows, ends].long(), ends
