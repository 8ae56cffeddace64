"""Vectorized (batched, device-side) subquery execution.

This is the serving-path implementation of the Combiner: identical result
semantics to ``core/combiner.py`` (validated in tests), expressed through the
fused query-at-a-time pipeline in ``search/fused.py`` — compact (doc_slot,
pos, lemma) event transport, on-device scatter + window cover + §14 scoring +
per-query top-k in ONE device program per query batch, and a single
fragment readout.

This port serves plain ``IndexSet`` sources on ``device`` (``"cuda"`` unless
the caller asks for ``"cpu"``); incremental sources raise
``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..core.keys import SelectedKey, Subquery
from ..core.postings import QueryStats, SearchResult
from ..index.builder import IndexSet
from .fused import (
    FusedBatchResult,
    bucket_pow2,
    extract_segment_events,
    serve_query_batch,
)
from .planner import INCREMENTAL_NOT_PORTED, generation_token

__all__ = ["VectorizedEngine", "PackedEvents", "pack_subquery_events"]


@dataclass
class PackedEvents:
    """Compact fixed-shape event transport for one subquery (DESIGN.md §9.1).

    ``events`` replaces a dense ``[B, L, doc_len]`` host occupancy: the
    device scatter rebuilds occupancy on-chip from E event triples, so host
    transport is O(events), not O(docs * lemmas * doc_len).
    """

    events: np.ndarray  # [E, 3] int32 (doc_slot, pos, lemma), pad = -1
    doc_ids: np.ndarray  # [B] int32 (pad = -1)
    mult: np.ndarray  # [L] int32
    lemmas: list[str]  # local lemma id -> lemma


def pack_subquery_events(
    subquery: Subquery,
    index: IndexSet,
    keys: Sequence[SelectedKey] | None = None,
    doc_len: int = 512,
    stats: QueryStats | None = None,
    device="cuda",
) -> PackedEvents | None:
    """Host-side: key postings -> compact event triples (§10.4's Set calls,
    batched).  Dedup is free: the on-device occupancy scatter is idempotent.
    ``device`` runs the Step-1 intersects of long lists.

    Returns ``None`` for an empty subquery — callers short-circuit before the
    device call instead of dispatching an all-padding batch (the skip is
    counted in ``QueryStats.empty_subqueries``).  Budgets are padded to
    powers of two, as the fused program buckets its shapes.
    """
    seg = extract_segment_events(
        subquery, index, keys=keys, doc_len=doc_len, stats=stats, device=device
    )
    if seg is None:
        return None
    e_budget = bucket_pow2(len(seg.slot), lo=64)
    b_budget = bucket_pow2(len(seg.doc_ids), lo=8)
    events = np.full((e_budget, 3), -1, np.int32)
    events[: len(seg.slot), 0] = seg.slot
    events[: len(seg.slot), 1] = seg.pos
    events[: len(seg.slot), 2] = seg.lem
    doc_ids = np.full((b_budget,), -1, np.int32)
    doc_ids[: len(seg.doc_ids)] = seg.doc_ids
    return PackedEvents(
        events=events, doc_ids=doc_ids, mult=seg.mult, lemmas=seg.lemmas
    )


class VectorizedEngine:
    """Batched Combiner over one index shard (the DESIGN.md §9 fused serving
    pipeline) on ``device``; fragment sets identical to the scalar §10
    Combiner."""

    def __init__(
        self,
        index: IndexSet,
        use_kernel: bool = False,
        doc_len: int = 512,
        compute_dtype: str = "uint8",
        arena=None,
        device="cuda",
    ):
        if generation_token(index) != 0:
            raise NotImplementedError(INCREMENTAL_NOT_PORTED)
        self.index = index
        self.use_kernel = use_kernel
        self.doc_len = doc_len
        self.compute_dtype = compute_dtype
        # optional device-resident posting arena (DESIGN.md §13): resident
        # keys gather/pack on device, others fall back to the host path
        self.arena = arena
        self.device = device

    def search_query_batch(
        self,
        batch: Sequence[Sequence[Subquery]],
        top_k: int = 16,
        per_query_stats: Sequence[QueryStats] | None = None,
    ) -> tuple[FusedBatchResult, QueryStats]:
        """Serve a whole query batch with ONE device program.

        ``batch[qi]`` lists query ``qi``'s subqueries; the result carries the
        exact (deduplicated) fragment union per query plus the device-side
        slot-level top-k ranking.  ``per_query_stats`` (one accumulator per
        query) splits the I/O accounting per query; the returned stats stay
        batch-level either way.
        """
        stats = QueryStats()
        view = self.index
        work = [[(sub, view) for sub in subs] for subs in batch]
        residencies = None
        if self.arena is not None:
            residencies = {id(view): self.arena.acquire(view, generation_token(view))}
        result = serve_query_batch(
            work,
            max_distance=view.max_distance,
            top_k=top_k,
            doc_len=self.doc_len,
            use_kernel=self.use_kernel,
            compute_dtype=self.compute_dtype,
            stats=per_query_stats if per_query_stats is not None else stats,
            batch_stats=stats,
            residencies=residencies,
            device=self.device,
        )
        if per_query_stats is not None:
            for st in per_query_stats:
                st.device_dispatches = stats.device_dispatches
                stats.postings_read += st.postings_read
                stats.bytes_read += st.bytes_read
                stats.empty_subqueries += st.empty_subqueries
        # offset arithmetic, not len(per_query[qi]): counting must not force
        # the lazy SearchResult materialization of the §15.1 device readout
        stats.results = sum(result.n_results(qi) for qi in range(len(batch)))
        return result, stats

    def search_subquery(
        self, subquery: Subquery
    ) -> tuple[list[SearchResult], QueryStats]:
        result, stats = self.search_query_batch([[subquery]])
        return result.per_query[0], stats
