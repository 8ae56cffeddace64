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
"""

from __future__ import annotations

import torch

__all__ = ["window_cover", "window_cover_batch"]


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
