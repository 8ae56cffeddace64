"""Posting-list iterators (paper §4) and per-query accounting.

A posting array for a key of arity ``a`` has rows ``(doc, P, D1 .. D_{a-1})``
sorted lexicographically — the §4 record order.  ``KeyIterator`` exposes the
paper's iterator protocol: ``Next()``, ``Value`` (current record) and ``Key``
(canonical components, plus the §6 ``*`` marks).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from .keys import SelectedKey

__all__ = ["KeyIterator", "QueryStats", "SearchResult"]

_RECORD_BYTES = 4  # int32 per field


class SearchResult(NamedTuple):
    """A minimal text fragment containing every subquery lemma (§10.2).

    A ``NamedTuple`` rather than a dataclass so batch readout can
    materialize thousands of fragments per batch via ``SearchResult._make``
    without ``__init__``/``__setattr__`` overhead dominating the readout
    phase (§15.1); field order ``(doc_id, start, end)`` matches both the
    dense device result-buffer columns and the order-by-(doc, start)
    contract the merge paths rely on.
    """

    doc_id: int
    start: int
    end: int

    @property
    def span(self) -> int:
        return self.end - self.start


@dataclass
class QueryStats:
    """Per-query accounting: the paper's three reported metrics (§11 —
    postings read, data read size, results) plus the serving-layer counters
    added by the fused pipeline and the planner/frontend (arXiv 2009.03679's
    response-time-guarantee reporting).

    ``partial`` is True when the deadline-aware frontend early-exited: the
    returned top-k is exact over the *executed* subqueries (every reported
    fragment and score is exact; skipped subqueries could only add docs or
    raise scores) — see ``search/frontend.py``.
    """

    postings_read: int = 0
    bytes_read: int = 0
    intermediate_records: int = 0  # SE2.2/SE2.3 stream materialization
    heap_ops: int = 0
    results: int = 0
    empty_subqueries: int = 0  # subqueries short-circuited before dispatch
    device_dispatches: int = 0  # device programs issued for this query/batch
    elapsed_sec: float = 0.0
    # ---- planner / frontend counters (PR 3) -------------------------------
    cache_hits: int = 0  # whole-query result-cache hits
    cache_misses: int = 0  # planned + executed (not served from cache)
    posting_cache_hits: int = 0  # hot posting-slice reuse during planning
    pruned_subqueries: int = 0  # planner-proved-empty (exact, no work lost)
    skipped_subqueries: int = 0  # deadline admission dropped (partial result)
    partial: bool = False  # deadline early-exit happened
    deadline_sec: float = 0.0  # the request's admission budget (0 = none)
    # ---- posting-arena counters (PR 5, DESIGN.md §13) ---------------------
    arena_hits: int = 0  # keys served from device-resident extents
    arena_misses: int = 0  # keys that fell back to the host-pack path
    h2d_bytes: int = 0  # bytes actually shipped host->device this query/batch
    # ---- resilience counters (PR 6, DESIGN.md §14) ------------------------
    # batch-level like device_dispatches: the probe barrier runs once per
    # batch, so every response in the batch reports the same values.
    # Fault-free traffic leaves ALL of them at zero (pinned by tests).
    retries: int = 0  # transient-crash probe retries (RestartPolicy backoff)
    hedges: int = 0  # straggler probes raced against a hedged second attempt
    shards_degraded: int = 0  # shards excluded from this response's fan-out
    recoveries: int = 0  # shards re-restored from snapshot for this batch
    shed: int = 0  # request load-shed to the admission-control budget

    def merge(self, other: "QueryStats") -> None:
        self.postings_read += other.postings_read
        self.bytes_read += other.bytes_read
        self.intermediate_records += other.intermediate_records
        self.heap_ops += other.heap_ops
        self.results += other.results
        self.empty_subqueries += other.empty_subqueries
        self.device_dispatches += other.device_dispatches
        self.elapsed_sec += other.elapsed_sec
        self.cache_hits += other.cache_hits
        self.cache_misses += other.cache_misses
        self.posting_cache_hits += other.posting_cache_hits
        self.pruned_subqueries += other.pruned_subqueries
        self.skipped_subqueries += other.skipped_subqueries
        self.partial = self.partial or other.partial
        self.deadline_sec = max(self.deadline_sec, other.deadline_sec)
        self.arena_hits += other.arena_hits
        self.arena_misses += other.arena_misses
        self.h2d_bytes += other.h2d_bytes
        self.retries += other.retries
        self.hedges += other.hedges
        self.shards_degraded = max(self.shards_degraded, other.shards_degraded)
        self.recoveries += other.recoveries
        self.shed = max(self.shed, other.shed)


class KeyIterator:
    """Sequential reader over one key's posting array.

    Reading is *accounted*: every ``Next`` charges one posting and the record
    byte size to ``stats`` — this is the "data read size"/"postings per
    query" measure of §11 (our in-memory analogue of the paper's disk reads).
    """

    __slots__ = ("key", "rows", "idx", "stats", "_n", "_width")

    def __init__(self, key: SelectedKey, rows: np.ndarray, stats: QueryStats):
        self.key = key
        self.rows = rows
        self.idx = 0
        self.stats = stats
        self._n = rows.shape[0]
        self._width = rows.shape[1] if rows.ndim == 2 else 0
        if self._n:  # the first record is materialized by opening the iterator
            stats.postings_read += 1
            stats.bytes_read += self._width * _RECORD_BYTES

    # -- paper protocol ----------------------------------------------------
    @property
    def exhausted(self) -> bool:
        return self.idx >= self._n

    @property
    def doc(self) -> int:
        return int(self.rows[self.idx, 0])

    @property
    def pos(self) -> int:
        return int(self.rows[self.idx, 1])

    def distances(self) -> tuple[int, ...]:
        return tuple(int(x) for x in self.rows[self.idx, 2:])

    def next(self) -> None:
        self.idx += 1
        if self.idx < self._n:
            self.stats.postings_read += 1
            self.stats.bytes_read += self._width * _RECORD_BYTES

    def skip_to_doc(self, doc_id: int) -> None:
        """Galloping skip used by Step 1 (doc alignment)."""
        lo = np.searchsorted(self.rows[:, 0], doc_id, side="left")
        if lo > self.idx:
            # charge skipped block reads conservatively: sequential readers
            # in the paper fetch pages; we charge each skipped record once.
            n_skipped = int(lo) - self.idx
            self.stats.postings_read += min(n_skipped, 1)
            self.stats.bytes_read += self._width * _RECORD_BYTES
            self.idx = int(lo)

    def events(self, honor_stars: bool = True) -> list[tuple[int, str]]:
        """(pos, lemma) events of the current record.

        With ``honor_stars`` (SE2.4, §10.4) the ``*``-marked components are
        skipped; the pre-Combiner algorithms (SE2.1–SE2.3) lack that
        optimization and emit every component — the duplicate work §12
        measures on "to be or not to be".
        """
        row = self.rows[self.idx]
        p = int(row[1])
        out = []
        comps, stars = self.key.components, self.key.starred
        if not (honor_stars and stars[0]):
            out.append((p, comps[0]))
        for slot in range(1, len(comps)):
            if not (honor_stars and stars[slot]):
                out.append((p + int(row[1 + slot]), comps[slot]))
        return out
