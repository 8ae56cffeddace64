"""Query pipeline (paper §5, Figures 2–3).

1) Lemmatization            — multi-lemma dictionary expansion.
2) Building subqueries      — cartesian product over lemma alternatives.
3) Processing subqueries    — key selection + one of the §4 algorithms.
4) Combining results        — union of fragments, §14 proximity relevance.

The host algorithms (``se1`` .. ``se2.4``) run one subquery at a time on the
host; the ``fused`` algorithm routes a whole query *batch* into one device
program (``search/fused.py``) on ``device``, over a device-resident posting
arena when one is given (``search/arena.py``).

Exactness contract: every algorithm choice returns the identical fragment
union for a query; they differ only in work and dispatch shape.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Literal, Sequence

from ..core.baselines import (
    se1_ordinary,
    se21_main_cell,
    se22_intermediate,
    se23_optimized,
)
from ..core.combiner import se24_combiner
from ..core.keys import Subquery, expand_subqueries
from ..core.lemma import Lemmatizer
from ..core.postings import QueryStats, SearchResult
from ..index.builder import IndexSet
from ..index.incremental import as_index_set, generation_token
from .relevance import rank_documents
from .vectorized import VectorizedEngine

__all__ = ["SearchEngine", "RankedDoc", "QueryResponse", "ALGORITHMS"]

Algorithm = Literal["se1", "se2.1", "se2.2", "se2.3", "se2.4", "fused"]

ALGORITHMS: dict[str, Callable[[Subquery, IndexSet], tuple[list[SearchResult], QueryStats]]] = {
    "se1": se1_ordinary,
    "se2.1": se21_main_cell,
    "se2.2": se22_intermediate,
    "se2.3": se23_optimized,
    "se2.4": se24_combiner,
}


@dataclass
class RankedDoc:
    """One ranked document: §14 proximity score plus its minimal fragments
    (sorted ``(start, end)`` — the ``rank_documents`` ordering spec)."""

    doc_id: int
    score: float
    fragments: list[SearchResult]


@dataclass
class QueryResponse:
    """A served query: §14-ranked docs plus the §11 per-query accounting
    (``QueryStats`` — postings/bytes read, cache and deadline counters)."""

    query: str
    docs: list[RankedDoc]
    stats: QueryStats
    n_subqueries: int = 0


class SearchEngine:
    """Front door over one index shard: the §5 pipeline end to end
    (lemmatize -> subqueries -> §4 algorithm -> §14 rank).  ``index`` is a
    plain ``IndexSet`` or an ``IncrementalIndexer``, whose live view is
    resolved on every call.  ``fused`` runs on ``device``; with ``arena`` (a
    ``search.arena.PostingArena``) its batches acquire the index's residency
    first, and resident keys are served by the arena program.  The host
    algorithms never touch the device."""

    def __init__(
        self,
        index: IndexSet,
        lemmatizer: Lemmatizer | None = None,
        algorithm: Algorithm = "se2.4",
        use_kernel: bool = False,
        doc_len: int = 512,
        arena=None,
        device="cuda",
    ):
        if algorithm != "fused" and algorithm not in ALGORITHMS:
            raise KeyError(algorithm)
        # ``index`` may be a plain IndexSet or an IncrementalIndexer; the
        # live multi-segment view is resolved per call, so commits, deletes
        # and compactions are picked up without rebuilding the engine.
        self._index_source = index
        self.lemmatizer = lemmatizer or Lemmatizer()
        self.algorithm = algorithm
        self.use_kernel = use_kernel
        self.doc_len = doc_len
        self.arena = arena
        self.device = device
        self._vec = VectorizedEngine(
            index, use_kernel=use_kernel, doc_len=doc_len, arena=arena, device=device
        )

    @property
    def index(self) -> IndexSet:
        """The live view of the source, resolved on every call."""
        return as_index_set(self._index_source)

    def search(self, query: str, top_k: int = 10) -> QueryResponse:
        return self.search_batch([query], top_k=top_k)[0]

    # ---- planned path (§5 made explicit; see search/planner.py) -----------

    def plan(self, query: str):
        """Build a :class:`~repro_torch.search.planner.QueryPlan` for
        ``query``: §5 lemma classification, §6 key selection, §3
        index-family bindings and live-view cost estimates."""
        from .planner import QueryPlanner

        return QueryPlanner(self._index_source, lemmatizer=self.lemmatizer).plan(
            query
        )

    def search_planned(self, plan, top_k: int = 10) -> QueryResponse:
        """Execute a pre-built plan through the fused pipeline (one device
        program); fragment-identical to ``search`` with
        ``algorithm="fused"``."""
        from .planner import execute_plans

        view = self.index
        residencies = None
        if self.arena is not None:
            # keyed by the SOURCE's token: a segmented view has none of its own
            res = self.arena.acquire(view, generation_token(self._index_source))
            residencies = {id(view): res}
        return execute_plans(
            [plan],
            [view],
            max_distance=view.max_distance,
            top_k=top_k,
            doc_len=self.doc_len,
            use_kernel=self.use_kernel,
            residencies=residencies,
            device=self.device,
        )[0]

    def search_batch(
        self, queries: Sequence[str], top_k: int = 10
    ) -> list[QueryResponse]:
        """Serve a batch of queries.

        With ``algorithm="fused"`` the whole batch — every subquery of every
        query — is one device program; host algorithms run the
        per-subquery loop.
        """
        if self.algorithm == "fused":
            return self._search_batch_fused(queries, top_k)
        return [self._search_host(q, top_k) for q in queries]

    # ---- host per-subquery path -------------------------------------------

    def _search_host(self, query: str, top_k: int) -> QueryResponse:
        t0 = time.perf_counter()
        fn = ALGORITHMS[self.algorithm]
        subqueries = expand_subqueries(query, self.lemmatizer)
        view = self.index
        total = QueryStats()
        all_results: set[SearchResult] = set()
        for sub in subqueries:
            results, stats = fn(sub, view)
            total.merge(stats)
            all_results.update(results)
        ranked = [
            RankedDoc(doc_id=d, score=s, fragments=f)
            for d, s, f in rank_documents(all_results, top_k=top_k)
        ]
        total.results = len(all_results)
        total.elapsed_sec = time.perf_counter() - t0
        return QueryResponse(
            query=query, docs=ranked, stats=total, n_subqueries=len(subqueries)
        )

    # ---- fused batched path ------------------------------------------------

    def _search_batch_fused(
        self, queries: Sequence[str], top_k: int
    ) -> list[QueryResponse]:
        t0 = time.perf_counter()
        per_query_subs = [expand_subqueries(q, self.lemmatizer) for q in queries]
        per_stats = [QueryStats() for _ in queries]
        result, _ = self._vec.search_query_batch(
            per_query_subs, top_k=top_k, per_query_stats=per_stats
        )
        elapsed = time.perf_counter() - t0
        responses = []
        for qi, query in enumerate(queries):
            docs = [
                RankedDoc(doc_id=d, score=s, fragments=f)
                for d, s, f in rank_documents(result.per_query[qi], top_k=top_k)
            ]
            qstats = per_stats[qi]
            qstats.results = len(result.per_query[qi])
            qstats.elapsed_sec = elapsed  # batch wall time (shared dispatch)
            responses.append(
                QueryResponse(
                    query=query,
                    docs=docs,
                    stats=qstats,
                    n_subqueries=len(per_query_subs[qi]),
                )
            )
        return responses
