"""Document-sharded search (the paper's §1 system at cluster scale; layout
in DESIGN.md §4), on torch.

The proximity-search workload is embarrassingly document-parallel: every
shard owns a document subset's §3 indexes; a query fans out to all shards,
each answers it locally, and the per-shard results merge.  Here the shards
are a list: a fused batch packs the whole (query x subquery x shard) cross
product into one device program on ``device``.  ``device_topk_merge`` also
merges per-rank lists under a device mesh (``launch/mesh.py``).

Exactness contract: shards hold disjoint documents indexed under ONE
corpus-global FL-list, so the cross-shard fragment union is identical to a
single-index build over the same documents.

With ``incremental=True`` every shard is an ``IncrementalIndexer`` and the
service grows mutation endpoints, snapshots and a write-ahead log, in the
reference's on-disk format; ``bulk_ingest`` writes the same tree through
the external-memory pipeline (``index/ingest.py``).  ``enable_resilience``
puts the §14 probe barrier (``search/resilience.py``) in front of every
batch: it decides which shards serve, and the survivors still pack into one
device program.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Sequence

import torch

from ..checkpoint import fsync_json, retain_latest
from ..core.keys import Subquery, expand_subqueries
from ..core.lemma import FLList, Lemmatizer
from ..core.postings import QueryStats, SearchResult
from ..index.builder import IndexSet, build_indexes
from ..index.corpus import DocumentStore
from ..index.incremental import IncrementalIndexer
from ..index.store import FORMAT_VERSION, SNAPSHOT_PREFIX, _load_manifest
from ..launch.mesh import DeviceMesh
from ..parallel.collectives import all_gather
from .engine import ALGORITHMS, QueryResponse, RankedDoc
from .fused import serve_query_batch
from .relevance import rank_documents

__all__ = ["ShardedSearchService", "shard_documents", "device_topk_merge"]

def shard_documents(store: DocumentStore, n_shards: int) -> list[DocumentStore]:
    """Round-robin document partitioning (doc ids stay global) — the §3
    document axis split of DESIGN.md §4's document-parallel serving layout."""
    shards: list[list] = [[] for _ in range(n_shards)]
    for doc in store.documents:
        shards[doc.doc_id % n_shards].append(doc)
    return [DocumentStore(documents=s, lemmatizer=store.lemmatizer) for s in shards]


@dataclasses.dataclass
class ShardStats:
    postings_read: int
    results: int
    elapsed_sec: float


class ShardedSearchService:
    """N-shard search service (DESIGN.md §4; §5 serving over per-shard §3
    indexes, fragment-exact across shards).

    Each shard builds ITS OWN indexes over its documents but shares the
    global FL-list (lemma typing must agree across shards), computed once
    over the full store.  ``algorithm`` is a host algorithm of
    ``engine.ALGORITHMS`` or ``"fused"``, the device program on ``device``;
    ``arena`` (a ``search.arena.PostingArena``) serves resident keys of the
    fused path from the card.

    With ``incremental=True`` every shard is an ``IncrementalIndexer``: the
    serving loop reads each shard's live multi-segment view, and the service
    grows mutation endpoints — ``add_documents`` routes new docs to shards,
    ``delete_document`` tombstones, ``commit`` runs the corpus-level FL
    reduce and broadcasts ONE new FL-list to every shard's generation commit
    (canonical key order must agree across shards), ``compact`` merges
    per-shard segments under a memory budget.
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
        self.algorithm = algorithm
        self.use_kernel = use_kernel
        self.doc_len = doc_len
        # runtime accelerator state: never part of snapshots
        self.arena = arena
        self.device = device
        self.max_distance = max_distance
        self.n_shards = n_shards
        self.sw_count = sw_count
        self.fu_count = fu_count
        self.lemmatizer = store.lemmatizer
        self.indexers: list[IncrementalIndexer] | None = None
        self._static_shards: list[IndexSet] = []
        # resilience layer (DESIGN.md §14): detection/recovery instead of a
        # caller-supplied dead list; None until enable_resilience (the
        # legacy dead_shards= argument enables it lazily)
        self.supervisor = None
        self.injector = injector
        self.last_snapshot_dir = None
        if incremental:
            self.indexers = [
                IncrementalIndexer(
                    sw_count=sw_count,
                    fu_count=fu_count,
                    max_distance=max_distance,
                    lemmatizer=store.lemmatizer,
                )
                for _ in range(n_shards)
            ]
            self._next_doc_id = 1 + max(
                (doc.doc_id for doc in store.documents), default=-1
            )
            # the store's documents are already lemmatized: ingest the
            # per-shard batches as-is, no re-lemmatization
            for shard_id, sub in enumerate(shard_documents(store, n_shards)):
                self.indexers[shard_id].add_prelemmatized(sub.documents)
            self.commit()
        else:
            self.fl = FLList.from_frequencies(
                store.lemma_frequencies(), sw_count=sw_count, fu_count=fu_count
            )
            # every shard indexes with the GLOBAL FL-list (lemma typing and
            # canonical key order must agree across shards)
            self._static_shards = [
                build_indexes(sub, sw_count=sw_count, fu_count=fu_count,
                              max_distance=max_distance, fl=self.fl)
                for sub in shard_documents(store, n_shards)
            ]
        if resilience is not None or injector is not None:
            self.enable_resilience(policy=resilience, injector=injector)

    @property
    def shards(self) -> list[IndexSet]:
        """Live per-shard index views (static builds or segment unions)."""
        if self.indexers is not None:
            return [ix.index for ix in self.indexers]
        return self._static_shards

    @property
    def generation_token(self) -> tuple:
        """Cache-invalidation token across every shard (DESIGN.md §11).

        The tuple of per-shard mutation tokens: any shard's ``commit`` /
        ``delete`` / ``compact`` changes it, so a ``ServingFrontend`` over
        this service invalidates exactly when the corpus-visible state can
        change.  Static services are immutable and return a constant.
        """
        if self.indexers is None:
            return ("static",)
        return tuple(ix.generation_token for ix in self.indexers)

    # ---- incremental mutation endpoints -----------------------------------

    def add_documents(self, texts: Sequence[str]) -> list[int]:
        """Route new documents to shards (round-robin on global doc id);
        they become searchable at the next ``commit``."""
        self._require_incremental()
        per_shard: dict[int, tuple[list[str], list[int]]] = {}
        out = []
        for text in texts:
            doc_id = self._next_doc_id
            self._next_doc_id += 1
            batch = per_shard.setdefault(doc_id % self.n_shards, ([], []))
            batch[0].append(text)
            batch[1].append(doc_id)
            out.append(doc_id)
        for shard_id, (shard_texts, ids) in per_shard.items():
            self.indexers[shard_id].add_documents(shard_texts, doc_ids=ids)
        return out

    def delete_document(self, doc_id: int) -> None:
        """Tombstone on the owning shard — effective immediately."""
        self._require_incremental()
        self.indexers[doc_id % self.n_shards].delete_document(doc_id)

    def commit(self) -> dict:
        """Corpus-level FL reduce + broadcast generation commit.

        The global FL-list is recomputed over every shard's surviving
        frequencies and pinned into each shard's commit, so per-shard FL
        drift re-keying happens against ONE shared lemma typing.
        """
        self._require_incremental()
        global_freq: dict[str, int] = {}
        for ix in self.indexers:
            for l, n in ix.surviving_frequencies().items():
                global_freq[l] = global_freq.get(l, 0) + n
        self.fl = FLList.from_frequencies(
            global_freq, sw_count=self.sw_count, fu_count=self.fu_count
        )
        reports = []
        for i, ix in enumerate(self.indexers):
            if self.supervisor is not None:
                # §14 injection point: a crash here leaves a torn commit
                # (some shards on the new generation, this one not) — the
                # next batch's probe barrier recovers the crashed shard
                # from its snapshot under a fresh §12.5 epoch
                self.supervisor.guard_commit(i)
            reports.append(ix.commit(fl=self.fl))
        return {
            "new_docs": sum(r["new_docs"] for r in reports),
            "rekeyed_docs": sum(r["rekeyed_docs"] for r in reports),
            "segments": sum(r["segments"] for r in reports),
        }

    def compact(self, memory_budget_bytes: int | None = None) -> dict:
        self._require_incremental()
        reports = [ix.compact(memory_budget_bytes) for ix in self.indexers]
        return {
            "segments": sum(r["segments"] for r in reports),
            "collected": sum(r["collected"] for r in reports),
        }

    def _require_incremental(self) -> None:
        if self.indexers is None:
            raise RuntimeError(
                "service was built with incremental=False; mutation endpoints "
                "need ShardedSearchService(..., incremental=True)"
            )

    # ---- durability (DESIGN.md §12.2 / §18: one store and log per shard) --

    def enable_wal(self, directory, injector=None):
        """Attach a §18 write-ahead log to every shard under
        ``<directory>/shard_<i>/wal`` — the same per-shard lineage dirs
        ``snapshot``/``restore`` use.  From this point every routed
        ``add``/``delete`` and every shard commit of the corpus-level FL
        reduce is durably logged before it applies, and ``restore`` replays
        the tails, so restored shards come back ``index_sets_equal`` to the
        live ones *including post-snapshot commits*.  ``injector`` (defaults
        to the service's §14 injector) arms each log's
        ``wal.append``/``wal.torn_tail`` fault points."""
        self._require_incremental()
        directory = Path(directory)
        inj = injector if injector is not None else self.injector
        for i, ix in enumerate(self.indexers):
            ix.enable_wal(directory / f"shard_{i:02d}", injector=inj, shard=i)
        return [ix.wal for ix in self.indexers]

    def enable_resilience(self, policy=None, injector=None, clock=None):
        """Switch the fan-out onto the §14 failure path (DESIGN.md §14).

        Installs a :class:`~repro_torch.search.resilience.ShardSupervisor`:
        every ``search_batch`` then runs the probe barrier (circuit
        breakers, retries/hedges, snapshot recovery) before packing the
        surviving shards into the usual single fused dispatch.  Calling
        again replaces the supervisor but keeps an existing injector unless
        a new one is passed; the arena shares the injector (its
        ``arena.acquire`` point).  ``clock=`` (§16.4) threads an injectable
        clock through the supervisor, its breakers and the injector's
        straggler delays.  Returns the supervisor.  Fragments are
        exact-or-flagged either way — the supervisor decides *which shards*
        serve, never what a shard returns.
        """
        from .resilience import FaultInjector, ShardSupervisor

        if injector is not None:
            self.injector = injector
        elif self.injector is None:
            self.injector = FaultInjector()
        self.supervisor = ShardSupervisor(self, policy=policy, injector=self.injector,
                                          clock=clock)
        if self.arena is not None:
            self.arena.injector = self.injector
        return self.supervisor

    def resilience_metrics(self) -> dict:
        """Supervisor/health/injector counters (DESIGN.md §14) or ``{}``
        when the resilience layer is off — read by the frontend's
        ``metrics()`` and the launcher's report."""
        return {} if self.supervisor is None else self.supervisor.metrics()

    def snapshot(self, directory, keep: int = 2):
        """Snapshot every shard's indexer into ``<directory>/shard_<i>/``
        plus a fsync'd ``service.json`` naming the topology (DESIGN.md
        §12.2).  Per-shard writes are individually atomic; the service
        manifest is written last, so a reader that finds it finds complete
        shard snapshots.  Returns the snapshot root directory."""
        self._require_incremental()
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        # shards snapshot with retention OFF: GC only runs after the new
        # manifest is durably published, so a crash-looping snapshotter can
        # never collect a snapshot the live service.json still pins
        shard_snapshots = []
        for i, ix in enumerate(self.indexers):
            path = ix.snapshot(directory / f"shard_{i:02d}", keep=0)
            shard_snapshots.append(int(path.name.rsplit("_", 1)[1]))
        # written LAST and published atomically (fsync tmp -> rename).  The
        # keys and values are the reference's exactly (``device`` is not one
        # of them), so the manifest is byte-identical across packages
        manifest_tmp = directory / "service.json.tmp"
        fsync_json(manifest_tmp, {
            "format_version": FORMAT_VERSION,
            "kind": "service",
            "shard_snapshots": shard_snapshots,
            "n_shards": self.n_shards,
            "sw_count": self.sw_count,
            "fu_count": self.fu_count,
            "max_distance": self.max_distance,
            "algorithm": self.algorithm,
            "use_kernel": self.use_kernel,
            "doc_len": self.doc_len,
        })
        manifest_tmp.replace(directory / "service.json")
        for i, ix in enumerate(self.indexers):
            retain_latest(directory / f"shard_{i:02d}", SNAPSHOT_PREFIX, keep)
            if ix.wal is not None:
                # snapshots are WAL checkpoints: sealed segments whose replay
                # the retained snapshots no longer need go with them
                ix.wal.prune(keep)
        # the §14 supervisor recovers crashed shards from here unless its
        # policy pins another root
        self.last_snapshot_dir = directory
        return directory

    @classmethod
    def restore(
        cls,
        directory,
        use_mmap: bool = True,
        verify: bool = True,
        lemmatizer: Lemmatizer | None = None,
        device="cuda",
    ) -> "ShardedSearchService":
        """Warm-start a sharded service from a ``snapshot`` directory
        (DESIGN.md §12.2): every shard restores its latest snapshot lazily
        (``mmap``-backed segments), the shared FL-list and doc-id router
        resume from the stored state, and shards with a §18 WAL replay the
        operation tail logged after their snapshots — so the restored
        service returns the fragments of the live one it was snapshotted
        from, post-snapshot commits included.  ``device`` is where it
        serves (it is not stored).  Raises ``StoreError`` on corruption."""
        directory = Path(directory)
        m = _load_manifest(directory / "service.json", expect_kind="service")

        svc = cls.__new__(cls)
        svc.algorithm = m["algorithm"]
        svc.arena = None  # runtime accelerator state, not snapshotted
        svc.device = device
        svc.use_kernel = m["use_kernel"]
        svc.doc_len = m["doc_len"]
        svc.max_distance = m["max_distance"]
        svc.n_shards = m["n_shards"]
        svc.sw_count = m["sw_count"]
        svc.fu_count = m["fu_count"]
        svc.lemmatizer = lemmatizer or Lemmatizer()
        svc._static_shards = []
        shard_snapshots = m.get("shard_snapshots") or [None] * svc.n_shards
        svc.indexers = [
            IncrementalIndexer.restore(
                directory / f"shard_{i:02d}",
                snapshot_id=shard_snapshots[i],
                use_mmap=use_mmap,
                verify=verify,
                lemmatizer=svc.lemmatizer,
            )
            for i in range(svc.n_shards)
        ]
        for i, ix in enumerate(svc.indexers):
            if ix.wal is not None:
                # re-tag re-attached WALs with their shard ids (the fault
                # points key per-shard arrival counters by it)
                ix.wal.shard = i
        svc.supervisor = None
        svc.injector = None
        svc.last_snapshot_dir = directory
        svc.fl = svc.indexers[0].fl
        svc._next_doc_id = max(ix._next_id for ix in svc.indexers)
        return svc

    @classmethod
    def bulk_ingest(
        cls,
        store: DocumentStore,
        directory,
        n_shards: int,
        sw_count: int,
        fu_count: int,
        max_distance: int = 5,
        algorithm: str = "se2.4",
        workers: int = 1,
        docs_per_spill: int = 64,
        resume: bool = False,
        injector=None,
        device="cuda",
    ) -> tuple["ShardedSearchService", list]:
        """External-memory cold start (DESIGN.md §17): SPIMI bulk-build every
        shard straight to its ``shard_<i>/snap_<N>`` store, then publish
        ``service.json`` and warm-start from disk on ``device``.

        The FL-list is the same corpus-level reduce ``commit()`` broadcasts,
        pinned into every shard's build, so the published tree is
        byte-identical to ``ShardedSearchService(store, ...,
        incremental=True).snapshot(directory)`` and to the reference
        package's bulk tree (the §17.4 determinism contract).  The build is
        host work; spill workers never touch the card.  Returns
        ``(service, [BulkBuildStats per shard])``.
        """
        from ..index.ingest import bulk_build

        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        fl = FLList.from_frequencies(
            store.lemma_frequencies(), sw_count=sw_count, fu_count=fu_count
        )
        stats = []
        shard_snapshots = []
        for i, sub in enumerate(shard_documents(store, n_shards)):
            st = bulk_build(
                out_dir=directory / f"shard_{i:02d}",
                sw_count=sw_count,
                fu_count=fu_count,
                max_distance=max_distance,
                documents=sub.documents,
                fl=fl,
                docs_per_spill=docs_per_spill,
                workers=workers,
                resume=resume,
                injector=injector,
            )
            stats.append(st)
            shard_snapshots.append(
                int(Path(st.snapshot_path).name.rsplit("_", 1)[1])
            )
        # same publish order as snapshot(): manifest LAST, atomically — a
        # reader that finds service.json finds complete shard stores
        manifest_tmp = directory / "service.json.tmp"
        fsync_json(manifest_tmp, {
            "format_version": FORMAT_VERSION,
            "kind": "service",
            "shard_snapshots": shard_snapshots,
            "n_shards": n_shards,
            "sw_count": sw_count,
            "fu_count": fu_count,
            "max_distance": max_distance,
            "algorithm": algorithm,
            "use_kernel": False,
            "doc_len": 512,
        })
        manifest_tmp.replace(directory / "service.json")
        return cls.restore(directory, lemmatizer=store.lemmatizer, device=device), stats

    def search(
        self, query: str, top_k: int = 10, dead_shards: Sequence[int] = ()
    ) -> QueryResponse:
        """Fan out to all live shards and merge ranked results.

        ``dead_shards`` holds those shards down in the §14 fault injector
        for this call (ONE failure path with the detected-failure case):
        documents on dead shards are absent, the response is flagged
        degraded, and what it does cover is exactly ranked.
        """
        return self.search_batch([query], top_k=top_k, dead_shards=dead_shards)[0]

    def search_batch(
        self,
        queries: Sequence[str],
        top_k: int = 10,
        dead_shards: Sequence[int] = (),
    ) -> list[QueryResponse]:
        """Serve a query batch across all live shards.

        With ``algorithm="fused"`` the full (query x live subquery x shard)
        work cross product packs into ONE device program
        (``search/fused.py``).  Host algorithms keep the per-subquery loop
        over the live shards.

        Liveness comes from the §14 probe barrier when the resilience layer
        is on (``enable_resilience``): the supervisor detects, retries,
        hedges and recovers, and the surviving shards still pack into the
        single fused dispatch.  ``dead_shards=`` routes through the same
        path — it holds those shards down in the
        :class:`~repro_torch.search.resilience.FaultInjector` for this call.
        Degraded responses are flagged (``QueryStats.shards_degraded`` /
        ``partial``) and exactly ranked over the shards they cover.
        """
        t0 = time.perf_counter()
        per_query_subs = [expand_subqueries(q, self.lemmatizer) for q in queries]
        dead = frozenset(int(s) for s in dead_shards)
        if dead and self.supervisor is None:
            self.enable_resilience()
        rstats = None
        if self.supervisor is not None:
            if dead:
                self.injector.hold_down(dead)
            try:
                rstats = QueryStats()
                live_ids = self.supervisor.probe_live_shards(rstats)
            finally:
                if dead:
                    self.injector.release(dead)
            # resolve AFTER the barrier: recovery may have replaced indexers
            shards = self.shards
            live = [shards[i] for i in live_ids]
        else:
            live = list(self.shards)
        if self.algorithm == "fused":
            responses = self._search_batch_fused(
                queries, per_query_subs, live, top_k, t0
            )
        else:
            responses = [
                self._search_host(q, subs, live, top_k)
                for q, subs in zip(queries, per_query_subs)
            ]
        if rstats is not None and (
            rstats.shards_degraded or rstats.retries
            or rstats.hedges or rstats.recoveries
        ):
            for resp in responses:
                st = resp.stats
                # batch-level, like device_dispatches: one probe barrier
                st.retries = rstats.retries
                st.hedges = rstats.hedges
                st.recoveries = rstats.recoveries
                st.shards_degraded = rstats.shards_degraded
                if rstats.shards_degraded:
                    st.partial = True
        return responses

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
                (
                    idx,
                    self.indexers[shard_id].generation_token
                    if self.indexers is not None
                    else "static",
                    shard_id,
                )
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
    unspecified.  With no mesh the shards are rows of one tensor.  Under a
    mesh (``launch.mesh.DeviceMesh``) each rank passes its own shards'
    rows; they are all-gathered over every mesh axis, in shard (rank)
    order, and every rank returns the global top-k.
    """
    if mesh is not None:
        if not isinstance(mesh, DeviceMesh):
            raise ValueError(f"mesh must be a launch.mesh.DeviceMesh, not {type(mesh).__name__}")
        axes = mesh.axis_names
        scores = all_gather(scores.contiguous(), mesh, axes, 0)
        doc_ids = all_gather(doc_ids.contiguous(), mesh, axes, 0)
    flat_scores = scores.reshape(-1)
    flat_docs = doc_ids.reshape(-1)
    top_scores, idx = torch.sort(flat_scores, descending=True, stable=True)
    idx = idx[: min(k, flat_scores.shape[0])]
    return top_scores[: idx.shape[0]], flat_docs[idx]
