"""Query pipeline (paper §5, Figures 2–3).

1) Lemmatization            — multi-lemma dictionary expansion.
2) Building subqueries      — cartesian product over lemma alternatives.
3) Processing subqueries    — key selection + the fused device program.
4) Combining results        — union of fragments, §14 proximity relevance.

This port serves the ``fused`` algorithm: a whole query batch — every
subquery of every query — is one device program (``search/fused.py``).
The reference's host algorithms (``se1`` .. ``se2.4``) are not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Sequence

from ..core.keys import expand_subqueries
from ..core.lemma import Lemmatizer
from ..core.postings import QueryStats, SearchResult
from ..index.builder import IndexSet
from .fused import ARENA_NOT_PORTED, serve_query_batch
from .relevance import rank_documents

__all__ = ["SearchEngine", "RankedDoc", "QueryResponse"]

HOST_ALGORITHMS_NOT_PORTED = (
    "the host algorithms se1..se2.4 are not ported yet (ROADMAP.md: "
    "engine.py's host algorithms, combiner/baselines/oracle)"
)


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
    (lemmatize -> subqueries -> fused device program -> §14 rank), on
    ``device``."""

    def __init__(
        self,
        index: IndexSet,
        lemmatizer: Lemmatizer | None = None,
        algorithm: str = "fused",
        use_kernel: bool = False,
        doc_len: int = 512,
        arena=None,
        device="cuda",
    ):
        if algorithm != "fused":
            raise NotImplementedError(HOST_ALGORITHMS_NOT_PORTED)
        if arena is not None:
            raise NotImplementedError(ARENA_NOT_PORTED)
        self.index = index
        self.lemmatizer = lemmatizer or Lemmatizer()
        self.algorithm = algorithm
        self.use_kernel = use_kernel
        self.doc_len = doc_len
        self.device = device

    def search(self, query: str, top_k: int = 10) -> QueryResponse:
        return self.search_batch([query], top_k=top_k)[0]

    # ---- planned path (§5 made explicit; see search/planner.py) -----------

    def plan(self, query: str):
        """Build a :class:`~repro_torch.search.planner.QueryPlan` for
        ``query``: §5 lemma classification, §6 key selection, §3
        index-family bindings and live-view cost estimates."""
        from .planner import QueryPlanner

        return QueryPlanner(self.index, lemmatizer=self.lemmatizer).plan(query)

    def search_planned(self, plan, top_k: int = 10) -> QueryResponse:
        """Execute a pre-built plan through the fused pipeline (one device
        program); fragment-identical to ``search``."""
        from .planner import execute_plans

        return execute_plans(
            [plan],
            [self.index],
            max_distance=self.index.max_distance,
            top_k=top_k,
            doc_len=self.doc_len,
            use_kernel=self.use_kernel,
            device=self.device,
        )[0]

    def search_batch(
        self, queries: Sequence[str], top_k: int = 10
    ) -> list[QueryResponse]:
        """Serve a batch of queries: every subquery of every query is one
        device program."""
        t0 = time.perf_counter()
        per_query_subs = [expand_subqueries(q, self.lemmatizer) for q in queries]
        per_stats = [QueryStats() for _ in queries]
        batch_stats = QueryStats()
        result = serve_query_batch(
            [[(sub, self.index) for sub in subs] for subs in per_query_subs],
            max_distance=self.index.max_distance,
            top_k=top_k,
            doc_len=self.doc_len,
            use_kernel=self.use_kernel,
            stats=per_stats,
            batch_stats=batch_stats,
            device=self.device,
        )
        elapsed = time.perf_counter() - t0
        responses = []
        for qi, query in enumerate(queries):
            docs = [
                RankedDoc(doc_id=d, score=s, fragments=f)
                for d, s, f in rank_documents(result.per_query[qi], top_k=top_k)
            ]
            qstats = per_stats[qi]
            qstats.device_dispatches = batch_stats.device_dispatches
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
