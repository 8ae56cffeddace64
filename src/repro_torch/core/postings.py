"""Search results and per-query accounting (paper §10.2, §11)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

__all__ = ["QueryStats", "SearchResult"]


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
