"""Deadline-aware serving front-end (arXiv 2009.03679's guarantee, §5 serving).

The missing layer between "a library of engines" and "a servable system":
:class:`ServingFrontend` sits in front of an index source and adds the
three things heavy traffic needs (ROADMAP north star):

* **Micro-batching** — concurrent requests are admitted into batches of at
  most ``max_batch`` and each admitted batch is ONE fused device dispatch
  (``search/fused.py``); per-request latency amortizes the dispatch exactly
  like LM serving batches decode steps.  Consecutive chunks run as a
  two-deep pipeline (DESIGN.md §15.2): chunk N+1's plan/pack/H2D overlaps
  chunk N's device compute, riding CUDA's asynchronous execution —
  responses stay in admission order and byte-identical to the serial loop.
* **Caching** — two LRU caches keyed by the index source's generation token
  (``planner.generation_token``): a whole-query result cache and a
  hot posting-slice cache that the planner's cost probe warms (plan-time
  reads ARE the prefetch).  A mutation of the source bumps the token, so
  stale entries become unreachable without any explicit flush.
* **Arena residency** (DESIGN.md §13, opt-in via ``arena_budget_mb`` or a
  shared ``arena=``) — hot posting columns upload to the device once per
  generation token and batches then gather/pack on the device from
  descriptors (``search/arena.py``).  Fragments are identical with the
  arena on or off.
* **Deadlines** — per-request response-time budgets enforced at *admission*
  (the 2009.03679 approach: bound the work before dispatch, don't abort
  mid-kernel).  Estimated cost is the plan's exact posting counts divided by
  a calibrated throughput (EWMA over observed batches); subqueries are
  admitted cheapest-first until the budget is spent.  An early-exited
  response is **partial but still correctly ranked**: every returned
  fragment and score is exact for the executed subqueries (skipped
  subqueries could only add fragments), and it is flagged via
  ``QueryStats.partial`` / ``skipped_subqueries``.

Exactness contract: with no deadline pressure, frontend responses are
fragment-identical to the reference package's frontend and to its scalar
Combiner on the same index (``tests/test_torch_frontend.py``).

This port serves a plain ``IndexSet`` or a static ``ShardedSearchService``
on ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``); an arena
the frontend builds lives on the same device.  Incremental sources raise
``NotImplementedError`` (see ``planner.resolve_index_views``).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..core.lemma import Lemmatizer
from ..core.postings import QueryStats
from ..index.builder import IndexSet
from ..runtime.clock import SystemClock
from .planner import (
    QueryPlan,
    QueryPlanner,
    SubqueryPlan,
    execute_plans,
    generation_token,
    resolve_index_views,
)

__all__ = ["SearchRequest", "ServingFrontend", "PostingCache"]


@dataclass(frozen=True)
class SearchRequest:
    """One serving request: a word query plus its §5 serving parameters.

    ``deadline_sec`` is the response-time budget (arXiv 2009.03679); ``None``
    falls back to the frontend default, and 0 (or negative) admits no work —
    an immediate empty *partial* response.
    """

    query: str
    top_k: int = 10
    deadline_sec: float | None = None


class PostingCache:
    """Byte-budgeted LRU over merged posting slices (§4 sorted arrays).

    Entries are keyed ``(generation token, shard, canonical key)`` — a
    generation bump strands old entries, which age out by LRU; the arrays
    themselves are the immutable merge outputs of the live view, shared (not
    copied) with execution, so a hit saves the ``SegmentedIndexSet`` k-way
    merge *and* keeps plan cost == execution cost exact.
    """

    def __init__(self, capacity_bytes: int = 64 << 20):
        self.capacity_bytes = capacity_bytes
        self._entries: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple):
        arr = self._entries.get(key)
        if arr is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return arr

    def put(self, key: tuple, arr) -> None:
        nbytes = int(getattr(arr, "nbytes", 0))
        if nbytes > self.capacity_bytes:
            return  # one slice larger than the whole budget: never cache
        old = self._entries.pop(key, None)
        if old is not None:
            self._bytes -= int(getattr(old, "nbytes", 0))
        self._entries[key] = arr
        self._bytes += nbytes
        while self._bytes > self.capacity_bytes and self._entries:
            _, evicted = self._entries.popitem(last=False)
            self._bytes -= int(getattr(evicted, "nbytes", 0))

    @property
    def size_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)


class _CachedView:
    """A posting-cache wrapper around one live shard view.

    Duck-compatible with the slice of the ``IndexSet`` surface the planned
    execution path touches (``n_docs``, ``fl``, ``max_distance``,
    ``key_postings``); lookups go through the frontend's :class:`PostingCache`
    keyed by (generation, shard), so planner probes and execution reads share
    one fetch of each hot slice.
    """

    __slots__ = ("_base", "_cache", "_key_prefix")

    def __init__(self, base: IndexSet, cache: PostingCache, key_prefix: tuple):
        self._base = base
        self._cache = cache
        self._key_prefix = key_prefix

    @property
    def n_docs(self) -> int:
        return self._base.n_docs

    @property
    def fl(self):
        return self._base.fl

    @property
    def max_distance(self) -> int:
        return self._base.max_distance

    def key_postings(self, key: tuple):
        ck = self._key_prefix + (key,)
        arr = self._cache.get(ck)
        if arr is None:
            arr = self._base.key_postings(key)
            self._cache.put(ck, arr)
        return arr


class ServingFrontend:
    """Micro-batching, caching, deadline-aware serving front door (§5).

    Wraps any index source the engines accept and serves whole requests:
    plan (classify + bind + cost, ``search/planner.py``) -> admit under the
    deadline budget -> micro-batch -> ONE fused dispatch per admitted batch
    -> exact rank -> cache.  See the module docstring for the exactness and
    partial-result contracts.
    """

    def __init__(
        self,
        source,
        *,
        lemmatizer: Lemmatizer | None = None,
        max_batch: int = 16,
        result_cache_entries: int = 512,
        posting_cache_bytes: int = 64 << 20,
        default_deadline_sec: float | None = None,
        postings_per_sec: float = 2e6,
        calibrate: bool = True,
        use_kernel: bool = False,
        doc_len: int = 512,
        compute_dtype: str = "uint8",
        arena_budget_mb: float = 0.0,
        arena=None,
        max_inflight: int | None = None,
        shed_deadline_sec: float = 0.0,
        pipeline: bool = True,
        clock=None,
        device="cuda",
    ):
        self._source = source
        self.device = device
        # injectable clock (DESIGN.md §16.4): every deadline/EWMA timing in
        # this frontend reads it, so tests drive a ManualClock to exact
        # tick boundaries while production (SystemClock) is unchanged
        self.clock = clock or SystemClock()
        self.max_batch = max(1, int(max_batch))
        # two-deep micro-batch pipeline (DESIGN.md §15.2): overlap batch
        # N+1's plan/pack/H2D with batch N's device compute.  Responses are
        # byte-identical with it on or off; off = the serial reference.
        self.pipeline = bool(pipeline)
        # admission-control load shedding (DESIGN.md §14): at most
        # max_inflight planned misses per slate run at full budget; the
        # overflow re-admits under shed_deadline_sec -> flagged partial
        self.max_inflight = max_inflight if max_inflight is None else max(0, int(max_inflight))
        self.shed_deadline_sec = float(shed_deadline_sec)
        self.default_deadline_sec = default_deadline_sec
        self.postings_per_sec = float(postings_per_sec)
        self.calibrate = calibrate
        self.use_kernel = use_kernel
        self.doc_len = doc_len
        self.compute_dtype = compute_dtype
        # device-resident posting arena (DESIGN.md §13): opt-in via a byte
        # budget (or an externally shared PostingArena).  Resident keys
        # gather/pack on the device; non-resident keys keep the host path,
        # so the arena never changes fragments, only locality.  Only an
        # arena this frontend CREATED is attached to the source and released
        # by ``close()``; a shared arena's lifecycle belongs to its owner.
        self._owns_arena = False
        if arena is None and arena_budget_mb and arena_budget_mb > 0:
            from .arena import PostingArena

            arena = PostingArena(budget_bytes=int(arena_budget_mb * (1 << 20)), device=device)
            arena.attach(source)
            self._owns_arena = True
        self.arena = arena
        self.planner = QueryPlanner(source, lemmatizer=lemmatizer)
        self.posting_cache = PostingCache(capacity_bytes=posting_cache_bytes)
        self._result_cache: OrderedDict[tuple, object] = OrderedDict()
        self._result_cache_entries = max(1, int(result_cache_entries))
        self._result_hits = 0
        self._result_misses = 0
        self._partials = 0
        self._served = 0
        self._sheds = 0

    # ---- public serving API ----------------------------------------------

    def search(self, query: str, top_k: int = 10, deadline_sec: float | None = None):
        """Serve one request (a batch of one — see ``search_many``)."""
        return self.search_many(
            [SearchRequest(query=query, top_k=top_k, deadline_sec=deadline_sec)]
        )[0]

    def search_many(self, requests: Sequence[SearchRequest | str]) -> list:
        """Serve a slate of concurrent requests.

        Result-cache hits are answered immediately; duplicate no-deadline
        misses within the slate coalesce into one planned execution; the
        remaining misses are planned, deadline-admitted, micro-batched into
        chunks of ``max_batch`` and each chunk runs as ONE fused device
        dispatch.  Responses come back in request order, each trimmed to its
        own request's ``top_k``.
        """
        return self.submit_many(requests)()

    def submit_many(self, requests: Sequence[SearchRequest | str]):
        """Submit a slate and return a zero-arg ``finalize`` callable.

        The continuous-batching hook (DESIGN.md §16.2): ALL pre-dispatch
        work — cache lookups, planning, deadline admission, shedding —
        runs now, and the
        first micro-batch chunk is SUBMITTED to the device without being
        awaited (``pipeline=True``; with ``pipeline=False`` it runs to
        completion, the serial reference).  Calling the returned finalize
        performs the blocking readout (plus any remaining chunks, two-deep
        pipelined) and returns the responses.  ``search_many`` is exactly
        ``submit_many(requests)()`` — responses are byte-identical, in
        request order — which is what lets ``search/service.py`` admit new
        requests into its queue while this slate's device program is in
        flight.  Not thread-safe per frontend: one submitted slate must be
        finalized before the next is submitted (the daemon serializes).
        """
        reqs = [
            r if isinstance(r, SearchRequest) else SearchRequest(query=r)
            for r in requests
        ]
        token, views, shard_ids, cached_views, max_distance = self._live_views()

        responses: list = [None] * len(reqs)
        miss_idx: list[int] = []
        miss_plans: list[QueryPlan] = []
        miss_admitted: list[list[SubqueryPlan]] = []
        miss_budget: list[float] = []
        miss_shed: list[bool] = []
        pending: dict[tuple, int] = {}  # (query, top_k) -> first miss index
        aliases: list[tuple[int, int]] = []  # (dup index, first index)
        for i, req in enumerate(reqs):
            ck = (token, req.query, req.top_k, self.use_kernel)
            hit = self._result_cache.get(ck)
            if hit is not None:
                self._result_cache.move_to_end(ck)
                self._result_hits += 1
                responses[i] = self._from_cache(hit)
                continue
            budget = (
                req.deadline_sec
                if req.deadline_sec is not None
                else self.default_deadline_sec
            )
            # coalesce duplicate no-deadline misses: plan + execute once,
            # fan the single response out (deadlined requests keep their own
            # admission, so they are never coalesced)
            dk = (req.query, req.top_k)
            if budget is None and dk in pending:
                aliases.append((i, pending[dk]))
                continue
            self._result_misses += 1
            p_hits0 = self.posting_cache.hits
            plan = self.planner.plan(req.query, views=cached_views, generation=token)
            p_hits = self.posting_cache.hits - p_hits0
            admitted, _skipped = self._admit(plan, budget)
            if budget is None:
                pending[dk] = i
            miss_idx.append(i)
            miss_plans.append(plan)
            miss_admitted.append(admitted)
            miss_budget.append(0.0 if budget is None else float(budget))
            miss_shed.append(False)
            # stash plan-time accounting to merge into the response stats
            plan._posting_cache_hits = p_hits  # type: ignore[attr-defined]

        # admission-control load shedding (DESIGN.md §14): misses beyond
        # max_inflight re-admit under the shed budget — they degrade to
        # flagged, exactly-ranked partial responses instead of erroring or
        # queueing unboundedly (request order decides who sheds:
        # deterministic, and earlier requests are older)
        if self.max_inflight is not None and len(miss_idx) > self.max_inflight:
            for j in range(self.max_inflight, len(miss_idx)):
                admitted, _ = self._admit(miss_plans[j], self.shed_deadline_sec)
                miss_admitted[j] = admitted
                miss_budget[j] = self.shed_deadline_sec
                miss_shed[j] = True
                self._sheds += 1

        # arena residencies are acquired only when something will actually
        # execute: a fully cache-served slate must never pay acquire work
        # (a cold acquire uploads whole families)
        residencies = (
            self._acquire_residencies(views, cached_views, token, shard_ids)
            if miss_idx
            else None
        )

        # micro-batch the misses: one fused dispatch per admitted batch.
        # Ranking runs at the chunk-wide max top_k; each response is trimmed
        # to its own request's top_k afterwards — rank_documents is a total
        # deterministic order, so the prefix equals a direct top_k ranking.
        #
        # With ``pipeline=True`` the chunks run as a two-deep pipeline
        # (DESIGN.md §15.2): chunk c is SUBMITTED (plan/pack/H2D + dispatch,
        # no barrier), then chunk c-1 — whose device program has been
        # computing meanwhile — is finalized (readout + response build).
        # Exactly one batch is ever in flight, chunks finalize in admission
        # order, and responses land by ``miss_idx`` — byte-identical to the
        # serial loop (``tests/test_readout.py``).
        def _submit(lo: int):
            hi = lo + self.max_batch
            chunk_plans = miss_plans[lo:hi]
            chunk_admitted = miss_admitted[lo:hi]
            chunk_reqs = [reqs[i] for i in miss_idx[lo:hi]]
            top_k = max((r.top_k for r in chunk_reqs), default=10)
            t0 = self.clock.now()
            out = execute_plans(
                chunk_plans,
                cached_views,
                max_distance=max_distance,
                top_k=top_k,
                doc_len=self.doc_len,
                use_kernel=self.use_kernel,
                compute_dtype=self.compute_dtype,
                admitted=chunk_admitted,
                residencies=residencies,
                defer=self.pipeline,
                device=self.device,
            )
            return lo, chunk_plans, chunk_admitted, t0, out

        def _finish(state) -> None:
            lo, chunk_plans, chunk_admitted, t0, out = state
            if self.pipeline:
                out = out()  # blocking readout + response build
            elapsed = self.clock.now() - t0
            self._calibrate(chunk_admitted, elapsed)
            for j, resp in enumerate(out):
                i = miss_idx[lo + j]
                resp.docs = resp.docs[: reqs[i].top_k]
                resp.stats.cache_misses = 1
                resp.stats.posting_cache_hits = getattr(
                    chunk_plans[j], "_posting_cache_hits", 0
                )
                resp.stats.deadline_sec = miss_budget[lo + j]
                if miss_shed[lo + j]:
                    resp.stats.shed = 1
                self._served += 1
                if resp.stats.partial:
                    self._partials += 1
                else:
                    # only complete responses are cacheable (a partial result
                    # is an artifact of one request's budget, not the corpus)
                    ck = (token, resp.query, reqs[i].top_k, self.use_kernel)
                    self._result_cache[ck] = resp
                    self._result_cache.move_to_end(ck)
                    while len(self._result_cache) > self._result_cache_entries:
                        self._result_cache.popitem(last=False)
                responses[i] = resp

        chunk_los = list(range(0, len(miss_idx), self.max_batch))
        # submit the FIRST chunk now (enqueue-only under pipeline=True): by
        # the time submit_many returns, the device is already computing it
        inflight = _submit(chunk_los[0]) if chunk_los else None

        done = False

        def finalize() -> list:
            nonlocal inflight, done
            if done:  # idempotent, like PendingBatch.result()
                return responses
            for lo in chunk_los[1:]:
                state = _submit(lo)
                _finish(inflight)
                inflight = state
            if inflight is not None:
                _finish(inflight)
                inflight = None
            for dup, first in aliases:
                responses[dup] = self._from_cache(responses[first])
            done = True
            return responses

        return finalize

    def close(self) -> None:
        """Release this frontend's hold on long-lived state (DESIGN.md
        §13.2): if the frontend created its own posting arena, detach it
        from the index source and drop its device buffers.  Idempotent.
        Shared arenas (``arena=`` passed in) are untouched — their owner
        closes them."""
        if self._owns_arena and self.arena is not None:
            self.arena.detach()
            self.arena.release()

    def _live_views(self):
        """``(token, views, shard_ids, cached_views, max_distance)`` of the
        source as it stands.  Posting-cache keys carry each view's TRUE shard
        id.  Every shard is live: there is no probe barrier until
        resilience/service is ported."""
        token = generation_token(self._source)
        views, _, max_distance, _ = resolve_index_views(self._source)
        shard_ids = list(range(len(views)))
        cached_views = [
            _CachedView(v, self.posting_cache, (token, shard))
            for shard, v in zip(shard_ids, views)
        ]
        return token, views, shard_ids, cached_views, max_distance

    def _acquire_residencies(self, views, cached_views, token, shard_ids):
        """Posting-arena residencies per live shard view (DESIGN.md §13).

        Keyed by ``id(cached_view)`` because that is the view object
        ``execute_plans`` packs into work items; uploads read the RAW view
        (the arena walks family dicts, which the cache wrapper does not
        carry), so entries stay keyed by the raw view's identity stamp and
        every frontend over one index shares them.  A sharded source's tuple
        token splits into per-shard tokens, so one shard's change only
        invalidates its own buffers; ``shard_ids`` names each view's TRUE
        shard.
        """
        if self.arena is None:
            return None
        # the token is a per-shard tuple exactly when the source is a sharded
        # service with one token entry per shard
        n_shards = getattr(self._source, "n_shards", None)
        per_shard = (
            [token[s] for s in shard_ids]
            if isinstance(token, tuple) and n_shards is not None
            and len(token) == n_shards
            else [token] * len(views)
        )
        all_res = self.arena.acquire_many(
            [(raw, per_shard[i], shard_ids[i]) for i, raw in enumerate(views)]
        )
        return {id(cached): res for cached, res in zip(cached_views, all_res)}

    def warmup(
        self,
        shapes: Sequence[tuple] | None = None,
        queries: Sequence[str] | None = None,
        top_k: int = 10,
    ) -> dict:
        """Run the device programs once before serving, so the first served
        requests do not pay one-time device set-up (CUDA context, kernel
        library load, allocator growth).

        ``queries`` plans and executes representative queries through the
        real serving path (the arena and its gather kernel included, result
        cache untouched).  ``shapes`` lists
        explicit buckets ``(events, rows, lemmas, table_depth, queries,
        window)`` run on all-padding inputs.  With neither argument, one
        default bucket at the frontend's ``max_batch``/``doc_len`` runs.
        Returns ``{"seconds", "programs"}``.
        """
        from .fused import bucket_pow2, fused_serve_batch

        t0 = time.perf_counter()
        programs = 0
        if shapes is None and queries is None:
            shapes = [
                (4096, 512, 4, 64, bucket_pow2(self.max_batch),
                 bucket_pow2(self.doc_len, lo=64))
            ]
        dev = torch.device(self.device)
        for e, r, l, k, q, n in shapes or ():
            out = fused_serve_batch(
                torch.full((e, 3), -1, dtype=torch.int32, device=dev),
                torch.zeros((e,), dtype=torch.int8, device=dev),
                torch.full((r, l, k), n, dtype=torch.int32, device=dev),
                torch.full((r,), -1, dtype=torch.int32, device=dev),
                torch.full((r,), -1, dtype=torch.int32, device=dev),
                torch.zeros((r, l), dtype=torch.int32, device=dev),
                max_distance=resolve_index_views(self._source)[2],
                query_budget=q,
                window_len=n,
                top_k=top_k,
                compute_dtype=self.compute_dtype,
                use_kernel=self.use_kernel,
            )
            out["res"].cpu()  # wait for the program
            programs += 1
        if queries:
            token, views, shard_ids, cached_views, max_distance = self._live_views()
            residencies = self._acquire_residencies(views, cached_views, token, shard_ids)
            plans = [
                self.planner.plan(q, views=cached_views, generation=token)
                for q in queries
            ]
            for lo in range(0, len(plans), self.max_batch):
                execute_plans(
                    plans[lo : lo + self.max_batch],
                    cached_views,
                    max_distance=max_distance,
                    top_k=top_k,
                    doc_len=self.doc_len,
                    use_kernel=self.use_kernel,
                    compute_dtype=self.compute_dtype,
                    residencies=residencies,
                    device=self.device,
                )
                programs += 1
        return {"seconds": time.perf_counter() - t0, "programs": programs}

    def _from_cache(self, resp):
        """A cache-hit response: shared docs, fresh hit-marked stats."""
        from .engine import QueryResponse

        st = QueryStats()
        st.cache_hits = 1
        st.results = resp.stats.results
        self._served += 1
        return QueryResponse(
            query=resp.query,
            docs=resp.docs,
            stats=st,
            n_subqueries=resp.n_subqueries,
        )

    def _admit(
        self, plan: QueryPlan, budget_sec: float | None
    ) -> tuple[list[SubqueryPlan], int]:
        """Deadline admission: cheapest-first under the estimated budget.

        With no budget every executable subquery is admitted (plan order).
        With a budget, subqueries are admitted in ascending estimated cost
        while the cumulative estimate ``postings / postings_per_sec`` fits;
        a non-positive budget admits nothing.  Admission is monotone in the
        budget, and the executed subset's results are exact (module
        docstring) — the response-time guarantee trades recall, never
        correctness.
        """
        execs = plan.executable()
        if budget_sec is None:
            return execs, 0
        if budget_sec <= 0:
            return [], len(execs)
        admitted: list[SubqueryPlan] = []
        cum = 0
        for sp in sorted(execs, key=lambda sp: sp.est_postings):
            if admitted and (cum + sp.est_postings) / self.postings_per_sec > budget_sec:
                continue
            admitted.append(sp)
            cum += sp.est_postings
        return admitted, len(execs) - len(admitted)

    def _calibrate(self, chunk_admitted, elapsed: float) -> None:
        """EWMA throughput update from the observed batch (postings/sec)."""
        if not self.calibrate or elapsed <= 0:
            return
        postings = sum(
            sp.est_postings for subs in chunk_admitted for sp in subs
        )
        if postings <= 0:
            return
        observed = postings / elapsed
        self.postings_per_sec = 0.5 * self.postings_per_sec + 0.5 * observed

    def metrics(self) -> dict:
        """Serving counters for dashboards and the bench harness."""
        n_lookups = self._result_hits + self._result_misses
        p_lookups = self.posting_cache.hits + self.posting_cache.misses
        arena = self.arena.metrics() if self.arena is not None else {}
        return {
            **arena,
            "served": self._served,
            "result_cache_hits": self._result_hits,
            "result_cache_misses": self._result_misses,
            "result_cache_hit_rate": (
                self._result_hits / n_lookups if n_lookups else 0.0
            ),
            "posting_cache_hits": self.posting_cache.hits,
            "posting_cache_misses": self.posting_cache.misses,
            "posting_cache_hit_rate": (
                self.posting_cache.hits / p_lookups if p_lookups else 0.0
            ),
            "posting_cache_bytes": self.posting_cache.size_bytes,
            "posting_cache_entries": len(self.posting_cache),
            "partial_responses": self._partials,
            "postings_per_sec_estimate": self.postings_per_sec,
            "sheds": self._sheds,
        }
