"""Document-sharded search (the paper's §1 system at cluster scale; layout
in DESIGN.md §4), on torch.

The proximity-search workload is embarrassingly document-parallel: every
shard owns a document subset's §3 indexes; a query fans out to all shards,
each answers it locally, and the per-shard results merge.  On one card the
shards are a list: a fused batch packs the whole (query x subquery x shard)
cross product into one device program on ``device``.

Exactness contract: shards hold disjoint documents indexed under ONE
corpus-global FL-list, so the cross-shard fragment union is identical to a
single-index build over the same documents.

This port serves static shards.  The incremental index with its snapshots
and write-ahead log, and the resilience layer, are not ported yet: the
options that reach them raise ``NotImplementedError`` naming their item.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

from ..core.keys import Subquery, expand_subqueries
from ..core.lemma import FLList
from ..core.postings import QueryStats, SearchResult
from ..index.builder import IndexSet, build_indexes
from ..index.corpus import DocumentStore
from .engine import ALGORITHMS, QueryResponse, RankedDoc
from .fused import serve_query_batch
from .relevance import rank_documents

__all__ = ["ShardedSearchService", "shard_documents", "device_topk_merge"]

INCREMENTAL_NOT_PORTED = (
    "incremental shards, snapshots, the write-ahead log and bulk ingest are "
    "not ported yet (ROADMAP.md: incremental/store/wal/checkpoint)"
)
RESILIENCE_NOT_PORTED = (
    "dead shards, fault injection and shard supervision are not ported yet "
    "(ROADMAP.md: resilience/service)"
)


def shard_documents(store: DocumentStore, n_shards: int) -> list[DocumentStore]:
    """Round-robin document partitioning (doc ids stay global) — the §3
    document axis split of DESIGN.md §4's document-parallel serving layout."""
    shards: list[list] = [[] for _ in range(n_shards)]
    for doc in store.documents:
        shards[doc.doc_id % n_shards].append(doc)
    return [DocumentStore(documents=s, lemmatizer=store.lemmatizer) for s in shards]


class ShardedSearchService:
    """N-shard search service (DESIGN.md §4; §5 serving over per-shard §3
    indexes, fragment-exact across shards).

    Each shard builds ITS OWN indexes over its documents but shares the
    global FL-list (lemma typing must agree across shards), computed once
    over the full store.  ``algorithm`` is a host algorithm of
    ``engine.ALGORITHMS`` or ``"fused"``, the device program on ``device``;
    ``arena`` (a ``search.arena.PostingArena``) serves resident keys of the
    fused path from the card.
    """

    def __init__(
        self,
        store: DocumentStore,
        n_shards: int,
        sw_count: int,
        fu_count: int,
        max_distance: int = 5,
        algorithm: str = "se2.4",
        use_kernel: bool = False,
        doc_len: int = 512,
        incremental: bool = False,
        arena=None,
        resilience=None,
        injector=None,
        device="cuda",
    ):
        if incremental:
            raise NotImplementedError(INCREMENTAL_NOT_PORTED)
        if resilience is not None or injector is not None:
            raise NotImplementedError(RESILIENCE_NOT_PORTED)
        self.algorithm = algorithm
        self.use_kernel = use_kernel
        self.doc_len = doc_len
        self.arena = arena
        self.device = device
        self.max_distance = max_distance
        self.n_shards = n_shards
        self.sw_count = sw_count
        self.fu_count = fu_count
        self.lemmatizer = store.lemmatizer
        self.fl = FLList.from_frequencies(
            store.lemma_frequencies(), sw_count=sw_count, fu_count=fu_count
        )
        # every shard indexes with the GLOBAL FL-list (lemma typing and
        # canonical key order must agree across shards)
        self._static_shards: list[IndexSet] = [
            build_indexes(sub, sw_count=sw_count, fu_count=fu_count,
                          max_distance=max_distance, fl=self.fl)
            for sub in shard_documents(store, n_shards)
        ]

    @property
    def shards(self) -> list[IndexSet]:
        """The per-shard index views."""
        return self._static_shards

    @property
    def generation_token(self) -> tuple:
        """Cache-invalidation token across every shard (DESIGN.md §11).
        Static services are immutable and return a constant."""
        return ("static",)

    def enable_wal(self, directory, injector=None):
        raise NotImplementedError(INCREMENTAL_NOT_PORTED)

    def snapshot(self, directory, keep: int = 2):
        raise NotImplementedError(INCREMENTAL_NOT_PORTED)

    @classmethod
    def restore(cls, directory, use_mmap: bool = True, verify: bool = True, lemmatizer=None):
        raise NotImplementedError(INCREMENTAL_NOT_PORTED)

    @classmethod
    def bulk_ingest(cls, store, directory, n_shards, sw_count, fu_count, **kwargs):
        raise NotImplementedError(INCREMENTAL_NOT_PORTED)

    def enable_resilience(self, policy=None, injector=None, clock=None):
        raise NotImplementedError(RESILIENCE_NOT_PORTED)

    def search(
        self, query: str, top_k: int = 10, dead_shards: Sequence[int] = ()
    ) -> QueryResponse:
        """Fan out to every shard and merge ranked results."""
        return self.search_batch([query], top_k=top_k, dead_shards=dead_shards)[0]

    def search_batch(
        self,
        queries: Sequence[str],
        top_k: int = 10,
        dead_shards: Sequence[int] = (),
    ) -> list[QueryResponse]:
        """Serve a query batch across every shard.

        With ``algorithm="fused"`` the full (query x subquery x shard) work
        cross product packs into ONE device program (``search/fused.py``).
        Host algorithms keep the per-subquery loop over the shards.
        ``dead_shards`` must be empty until resilience/service is ported.
        """
        if len(dead_shards):
            raise NotImplementedError(RESILIENCE_NOT_PORTED)
        t0 = time.perf_counter()
        per_query_subs = [expand_subqueries(q, self.lemmatizer) for q in queries]
        live = list(self.shards)
        if self.algorithm == "fused":
            return self._search_batch_fused(queries, per_query_subs, live, top_k, t0)
        return [
            self._search_host(q, subs, live, top_k)
            for q, subs in zip(queries, per_query_subs)
        ]

    def _search_host(
        self,
        query: str,
        subqueries: Sequence[Subquery],
        live: Sequence[IndexSet],
        top_k: int,
    ) -> QueryResponse:
        t0 = time.perf_counter()
        fn = ALGORITHMS[self.algorithm]
        total = QueryStats()
        all_results: set[SearchResult] = set()
        for idx in live:
            for sub in subqueries:
                results, stats = fn(sub, idx)
                total.merge(stats)
                all_results.update(results)
        docs = [
            RankedDoc(doc_id=d, score=s, fragments=f)
            for d, s, f in rank_documents(all_results, top_k=top_k)
        ]
        total.results = len(all_results)
        total.elapsed_sec = time.perf_counter() - t0
        return QueryResponse(query=query, docs=docs, stats=total,
                             n_subqueries=len(subqueries))

    def _search_batch_fused(
        self,
        queries: Sequence[str],
        per_query_subs: Sequence[Sequence[Subquery]],
        live: Sequence[IndexSet],
        top_k: int,
        t0: float,
    ) -> list[QueryResponse]:
        # segments = the (subquery x live shard) cross product per query;
        # doc ids are global, so shards just contribute disjoint candidates
        work = [
            [(sub, idx) for idx in live for sub in subs]
            for subs in per_query_subs
        ]
        per_stats = [QueryStats() for _ in queries]
        residencies = None
        if self.arena is not None:
            live_ids = {id(v) for v in live}
            specs = [
                (idx, "static", shard_id)
                for shard_id, idx in enumerate(self.shards)
                if id(idx) in live_ids
            ]
            residencies = {
                id(spec[0]): res
                for spec, res in zip(specs, self.arena.acquire_many(specs))
            }
        batch_stats = QueryStats()
        result = serve_query_batch(
            work,
            max_distance=self.max_distance,
            top_k=top_k,
            doc_len=self.doc_len,
            use_kernel=self.use_kernel,
            stats=per_stats,
            batch_stats=batch_stats,
            residencies=residencies,
            device=self.device,
        )
        for st in per_stats:
            # batch-level: one shared dispatch/transfer, assigned per query
            st.device_dispatches = batch_stats.device_dispatches
            st.h2d_bytes = batch_stats.h2d_bytes
        elapsed = time.perf_counter() - t0
        responses = []
        for qi, query in enumerate(queries):
            fragments = result.per_query[qi]
            docs = [
                RankedDoc(doc_id=d, score=s, fragments=f)
                for d, s, f in rank_documents(fragments, top_k=top_k)
            ]
            st = per_stats[qi]
            st.results = len(fragments)
            st.elapsed_sec = elapsed  # batch wall time (one shared dispatch)
            responses.append(
                QueryResponse(query=query, docs=docs, stats=st,
                              n_subqueries=len(per_query_subs[qi]))
            )
        return responses


# ---------------------------------------------------------------------------
# top-k merge of per-shard lists
# ---------------------------------------------------------------------------


def device_topk_merge(
    scores: torch.Tensor,  # [S, K] per-shard top scores
    doc_ids: torch.Tensor,  # [S, K] per-shard doc ids
    k: int,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-k lists into a global top-k, on the tensors'
    device — the only collective of DESIGN.md §4's document-parallel
    serving layout.

    Ties keep the lower flat index first, as ``jax.lax.top_k`` does: a
    stable descending sort, not ``torch.topk``, whose tie order is
    unspecified.  On one card the shards are rows of one tensor, so there is
    no mesh: ``mesh`` must be ``None``.
    """
    if mesh is not None:
        raise ValueError("device_topk_merge runs on one card: mesh must be None")
    flat_scores = scores.reshape(-1)
    flat_docs = doc_ids.reshape(-1)
    top_scores, idx = torch.sort(flat_scores, descending=True, stable=True)
    idx = idx[: min(k, flat_scores.shape[0])]
    return top_scores[: idx.shape[0]], flat_docs[idx]
