"""The port's §14 resilience layer (``search/resilience.py``, its wiring in
``search/distributed.py``, ``search/frontend.py`` and ``search/arena.py``,
and ``runtime/fault_tolerance.py``) against the reference's.

Every scenario runs twice on the same seeded inputs, once through each
package (the port on ``device="cpu"``), on stacks and directories of their
own.  Fault schedules must be equal event for event; every response of the
port must be exact (the SE2.4 oracle over the whole corpus) or flagged
``DEGRADED`` and exact over its live shards; and the port's responses,
flags and fired-fault logs must equal the reference's — documents and
fragments identical, scores within rtol 1e-5.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import repro.index as ref_index
import repro.runtime.clock as ref_clock
import repro.runtime.fault_tolerance as ref_ft
import repro.search.arena as ref_arena
import repro.search.distributed as ref_dist
import repro.search.frontend as ref_frontend
import repro.search.resilience as ref_res
import repro_torch.index as port_index
import repro_torch.runtime.clock as port_clock
import repro_torch.runtime.fault_tolerance as port_ft
import repro_torch.search.arena as port_arena
import repro_torch.search.distributed as port_dist
import repro_torch.search.frontend as port_frontend
import repro_torch.search.resilience as port_res
from repro_torch.core.keys import expand_subqueries, select_keys
from repro_torch.core.oracle import oracle_search
from repro_torch.core.postings import SearchResult
from repro_torch.search.relevance import rank_documents
from tests.strategies import make_corpus, make_queries


def _package(index, clock, ft, arena, dist, frontend, res, **device):
    return SimpleNamespace(
        DocumentStore=index.DocumentStore,
        IncrementalIndexer=index.IncrementalIndexer,
        index_sets_equal=index.index_sets_equal,
        StoreError=index.StoreError,
        ManualClock=clock.ManualClock,
        RestartPolicy=ft.RestartPolicy,
        StragglerMonitor=ft.StragglerMonitor,
        run_with_restarts=ft.run_with_restarts,
        PostingArena=lambda **kw: arena.PostingArena(**kw, **device),
        ShardedSearchService=lambda *a, **kw: dist.ShardedSearchService(*a, **kw, **device),
        restore=lambda path: dist.ShardedSearchService.restore(path, **device),
        ServingFrontend=lambda *a, **kw: frontend.ServingFrontend(*a, **kw, **device),
        SearchRequest=frontend.SearchRequest,
        FaultEvent=res.FaultEvent,
        FaultInjector=res.FaultInjector,
        HealthMonitor=res.HealthMonitor,
        ResiliencePolicy=res.ResiliencePolicy,
        ShardCrash=res.ShardCrash,
        mad_stragglers=res.mad_stragglers,
    )


REF = _package(ref_index, ref_clock, ref_ft, ref_arena, ref_dist, ref_frontend, ref_res)
PORT = _package(port_index, port_clock, port_ft, port_arena, port_dist, port_frontend,
                port_res, device="cpu")
PACKAGES = {"ref": REF, "port": PORT}

# the reference's chaos seeds (tests/test_chaos.py) and its WAL seeds
CHAOS_SEEDS = (101, 202, 303)
WAL_SEEDS = CHAOS_SEEDS + (404, 505)
N_SHARDS = 3
CORPUS_SEED = 17
TOP_K = 1000  # >= any corpus size here: responses carry every ranked doc
SCORE_RTOL = 1e-5


# ---------------------------------------------------------------------------
# helpers shared with tests/test_torch_service.py
# ---------------------------------------------------------------------------


def response_frags(resp):
    return {(d.doc_id, f.start, f.end) for d in resp.docs for f in d.fragments}


def wire(resp) -> dict:
    """Everything a response says: documents, fragments, scores, flags."""
    st = resp.stats
    return {
        "query": resp.query,
        "docs": [(d.doc_id, sorted((f.doc_id, f.start, f.end) for f in d.fragments))
                 for d in resp.docs],
        "scores": [float(d.score) for d in resp.docs],
        "flags": (bool(st.partial), int(st.shed), int(st.shards_degraded), int(st.retries),
                  int(st.hedges), int(st.recoveries), int(st.cache_hits)),
    }


def assert_same_responses(port, ref, ctx=""):
    """Port responses (``wire`` dicts, nested in lists) == the reference's:
    documents, fragments and flags identical, scores within rtol 1e-5."""
    if isinstance(ref, dict):
        assert port.keys() == ref.keys(), ctx
        assert {k: v for k, v in port.items() if k != "scores"} == \
            {k: v for k, v in ref.items() if k != "scores"}, ctx
        np.testing.assert_allclose(port["scores"], ref["scores"], rtol=SCORE_RTOL, err_msg=ctx)
        return
    assert len(port) == len(ref), ctx
    for i, (p, r) in enumerate(zip(port, ref)):
        assert_same_responses(p, r, f"{ctx}[{i}]")


def oracle_union(query, index, lemmatizer):
    """The SE2.4 oracle over one index (the port's own copy of §10)."""
    union = set()
    for sub in expand_subqueries(query, lemmatizer):
        keys = select_keys(sub, index.fl)
        postings = {k: index.key_postings(k.components) for k in keys}
        union |= {(r.doc_id, r.start, r.end)
                  for r in oracle_search(sub, keys, postings, index.max_distance)}
    return union


def ranking(frags, top_k=TOP_K):
    results = [SearchResult(doc_id=d, start=s, end=e) for d, s, e in frags]
    return [(doc, score) for doc, score, _ in rank_documents(results, top_k=top_k)]


def fast_policy(pkg, **kw):
    kw.setdefault("restart", pkg.RestartPolicy(max_restarts=2, min_backoff_s=0.0))
    kw.setdefault("breaker_cooldown_s", 0.0)
    return pkg.ResiliencePolicy(**kw)


def corpus(max_docs=10, n_queries=5):
    spec = make_corpus(CORPUS_SEED, max_docs=max_docs)
    queries = make_queries(CORPUS_SEED, spec, n_queries=n_queries)
    return spec, queries


def oracles_for(spec, queries):
    store = port_index.DocumentStore.from_texts(spec.texts)
    full = port_index.build_indexes(store, sw_count=spec.sw_count, fu_count=spec.fu_count,
                                    max_distance=spec.max_distance)
    return {q: oracle_union(q, full, store.lemmatizer) for q in queries}


def build_stack(pkg, tmp_path, chaos_seed=None, snapshot=True, clock=None, **policy_kw):
    """The reference chaos harness's stack in package ``pkg``: a 3-shard
    incremental fused service over the strategies corpus, snapshotted, with
    the resilience layer on (a seeded schedule when ``chaos_seed`` is set)."""
    spec, queries = corpus()
    store = pkg.DocumentStore.from_texts(spec.texts)
    svc = pkg.ShardedSearchService(
        store, n_shards=N_SHARDS, sw_count=spec.sw_count, fu_count=spec.fu_count,
        max_distance=spec.max_distance, algorithm="fused", incremental=True,
    )
    if snapshot:
        svc.snapshot(tmp_path / "snap")
    injector = (pkg.FaultInjector.from_seed(chaos_seed, n_shards=N_SHARDS)
                if chaos_seed is not None else None)
    svc.enable_resilience(policy=fast_policy(pkg, **policy_kw), injector=injector, clock=clock)
    return svc, queries


def assert_exact_or_flagged(svc, resp, oracle, n_shards=N_SHARDS):
    """The §14 invariant for one port response: exact, or flagged partial
    and exactly the oracle over the shards the last barrier kept, ranked
    exactly."""
    got = response_frags(resp)
    if resp.stats.shards_degraded == 0:
        assert not resp.stats.partial, resp.query
        assert got == oracle, (resp.query, "exact path diverged from the oracle")
    else:
        assert resp.stats.partial, resp.query
        dead = svc.supervisor.last_excluded
        expected = {f for f in oracle if f[0] % n_shards not in dead}
        assert got == expected, (resp.query, sorted(dead), "degraded coverage")
        assert [(d.doc_id, d.score) for d in resp.docs] == ranking(expected), resp.query


def fired(svc):
    return [(e["point"], e["kind"], e.get("shard")) for e in svc.injector.log]


def counters(metrics: dict) -> dict:
    """Resilience metrics without ``stragglers``: on the system clock the
    MAD rule reads real probe latencies, which differ run to run."""
    return {k: v for k, v in metrics.items() if k != "stragglers"}


def both(scenario, tmp_path):
    """Run ``scenario(pkg, directory)`` in each package; return the results
    ``(port, ref)``."""
    out = {}
    for name, pkg in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = scenario(pkg, d)
    return out["port"], out["ref"]


# ---------------------------------------------------------------------------
# the fault schedule, the straggler rule and the breakers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wal", [False, True])
def test_from_seed_schedules_equal_reference(wal):
    """Equal seeds draw equal schedules in both packages, event for event,
    over a range of seeds and shard counts."""
    for seed in [*range(60), *CHAOS_SEEDS, 404, 505, 2**31 - 1]:
        for n_shards in (1, 3, 4):
            got = port_res.FaultInjector.from_seed(seed, n_shards=n_shards, wal=wal)
            want = ref_res.FaultInjector.from_seed(seed, n_shards=n_shards, wal=wal)
            assert [dataclasses.astuple(e) for e in got.schedule] == \
                [dataclasses.astuple(e) for e in want.schedule], (seed, n_shards)
            assert got.seed == want.seed == seed
    # the wal draws come after the base draws: base schedules do not move
    base = port_res.FaultInjector.from_seed(101, n_shards=3).schedule
    assert port_res.FaultInjector.from_seed(101, n_shards=3, wal=True).schedule[:len(base)] == base


def test_mad_stragglers_and_straggler_monitor_equal_reference():
    rng = np.random.default_rng(7)
    for trial in range(40):
        n = int(rng.integers(1, 7))
        times = [list(rng.gamma(2.0, 0.01, int(rng.integers(0, 6)))) for _ in range(n)]
        if trial % 3 == 0 and n > 2:
            times[int(rng.integers(n))] = [1.0] * 3  # a clear straggler
        thr = float(rng.choice([1.0, 3.0, 5.0]))
        assert port_res.mad_stragglers(times, thr) == ref_res.mad_stragglers(times, thr)
        mons = [m.StragglerMonitor(n, window=4, mad_threshold=thr) for m in (port_ft, ref_ft)]
        for w, ts in enumerate(times):
            for t in ts:
                for mon in mons:
                    mon.record(w, t)
        assert mons[0].stragglers() == mons[1].stragglers()


def test_health_monitor_breaker_transitions_equal_reference():
    """CLOSED -> OPEN -> cooldown -> HALF_OPEN -> CLOSED/OPEN on the same
    event sequence and the same virtual time, state by state."""
    rng = np.random.default_rng(3)
    clocks = [port_clock.ManualClock(), ref_clock.ManualClock()]
    mons = [m.HealthMonitor(3, breaker_errors=2, cooldown_s=0.05, clock=c)
            for m, c in zip((port_res, ref_res), clocks)]
    trace = [[], []]
    for _ in range(300):
        op, shard = int(rng.integers(3)), int(rng.integers(3))
        dt = float(rng.choice([0.0, 0.01, 0.06]))
        for k, (mon, clock) in enumerate(zip(mons, clocks)):
            if op == 0:
                trace[k].append(("ok", mon.record_success(shard, dt)))
            elif op == 1:
                trace[k].append(("err", mon.record_error(shard)))
            else:
                clock.advance(dt)
            trace[k].append((mon.allows(shard), [mon.state(i) for i in range(3)]))
        if rng.random() < 0.05:
            for mon in mons:
                mon.note_recovered(shard)
    assert trace[0] == trace[1]
    assert mons[0].metrics() == mons[1].metrics()
    assert mons[0].stragglers() == mons[1].stragglers()
    assert {"closed", "open", "half_open"} <= {s for _, states in trace[0][1::2]
                                                if isinstance(states, list) for s in states}


class _Manager:
    """An in-memory checkpoint manager: ``restore_latest`` / ``save_async``
    / ``wait``, as ``run_with_restarts`` drives one."""

    def __init__(self):
        self.saved = {}

    def restore_latest(self, template):
        if not self.saved:
            return None
        step = max(self.saved)
        return self.saved[step], step

    def save_async(self, step, state):
        self.saved[step] = state

    def wait(self):
        pass


def test_run_with_restarts_equals_reference():
    def run(ft):
        calls = []

        def step(state, i):
            calls.append(i)
            if i in (3, 7) and calls.count(i) == 1:
                raise RuntimeError(f"injected failure at step {i}")
            return state + i

        policy = ft.RestartPolicy(max_restarts=3, min_backoff_s=0.0)
        state, stats = ft.run_with_restarts(lambda: 0, step, 10, _Manager(), policy=policy,
                                            checkpoint_every=2)
        return state, stats, calls

    assert run(port_ft) == run(ref_ft)
    assert run(port_ft)[1]["restarts"] == 2
    assert port_ft.RestartPolicy(min_backoff_s=0.5).backoff(3) == \
        ref_ft.RestartPolicy(min_backoff_s=0.5).backoff(3)


# ---------------------------------------------------------------------------
# chaos differentials: exact or flagged, and equal to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chaos_seed", CHAOS_SEEDS)
def test_chaos_service_exact_or_flagged_and_equal_reference(chaos_seed, tmp_path):
    spec, queries = corpus()
    oracles = oracles_for(spec, queries)

    def scenario(pkg, d):
        svc, queries = build_stack(pkg, d, chaos_seed=chaos_seed)
        trace = []
        # 12 rounds: 12 probe arrivals per shard, past every at_call a seeded
        # schedule draws (at most 9), so the kill fires
        for _ in range(12):
            resps = svc.search_batch(queries, top_k=TOP_K)
            if pkg is PORT:
                for q, resp in zip(queries, resps):
                    assert_exact_or_flagged(svc, resp, oracles[q])
            trace.append([wire(r) for r in resps])
        return trace, fired(svc), counters(svc.resilience_metrics())

    (trace, log, metrics), (ref_trace, ref_log, ref_metrics) = both(scenario, tmp_path)
    assert log == ref_log and log, "the schedule fired no fault"
    assert_same_responses(trace, ref_trace, f"seed {chaos_seed}")
    assert metrics == ref_metrics
    assert any(r["flags"][2] or r["flags"][3] or r["flags"][5] for rnd in trace for r in rnd)


@pytest.mark.parametrize("chaos_seed", CHAOS_SEEDS)
def test_chaos_frontend_exact_or_flagged_and_equal_reference(chaos_seed, tmp_path):
    """Through the planner/frontend: cache hits are exact complete
    responses, misses exact or flagged, partials never cached."""
    spec, queries = corpus()
    oracles = oracles_for(spec, queries)

    def scenario(pkg, d):
        svc, queries = build_stack(pkg, d, chaos_seed=chaos_seed)
        frontend = pkg.ServingFrontend(svc)
        trace = []
        for _ in range(4):
            resps = frontend.search_many([pkg.SearchRequest(q, top_k=TOP_K) for q in queries])
            if pkg is PORT:
                for q, resp in zip(queries, resps):
                    if resp.stats.cache_hits:
                        assert response_frags(resp) == oracles[q], (q, "stale cache")
                    else:
                        assert_exact_or_flagged(svc, resp, oracles[q])
            trace.append([wire(r) for r in resps])
        return trace, fired(svc), counters(frontend.metrics()["resilience"])

    (trace, log, m), (ref_trace, ref_log, ref_m) = both(scenario, tmp_path)
    assert log == ref_log
    assert_same_responses(trace, ref_trace, f"seed {chaos_seed}")
    assert m == ref_m


@pytest.mark.parametrize("chaos_seed", CHAOS_SEEDS)
def test_chaos_frontend_with_arena_exact_or_flagged(chaos_seed, tmp_path):
    """A 64 MiB arena attached before the crashes: a recovered shard's new
    indexer gets fresh tokens, so stale residencies (aging out by LRU only)
    never answer — every response exact or flagged, and the reference's."""
    spec, queries = corpus()
    oracles = oracles_for(spec, queries)

    def scenario(pkg, d):
        svc, queries = build_stack(pkg, d, chaos_seed=chaos_seed)
        frontend = pkg.ServingFrontend(svc, arena_budget_mb=64)
        trace = []
        for _ in range(10):
            resps = frontend.search_many([pkg.SearchRequest(q, top_k=TOP_K) for q in queries])
            if pkg is PORT:
                for q, resp in zip(queries, resps):
                    if not resp.stats.cache_hits:
                        assert_exact_or_flagged(svc, resp, oracles[q])
                    else:
                        assert response_frags(resp) == oracles[q]
            trace.append([wire(r) for r in resps])
        m = frontend.metrics()
        return trace, fired(svc), counters(m["resilience"]), m["arena_pressure_events"], m["arena_hits"]

    port, ref = both(scenario, tmp_path)
    assert port[1] == ref[1]
    assert_same_responses(port[0], ref[0], f"seed {chaos_seed}")
    assert port[2:] == ref[2:]


def test_chaos_schedule_replays_deterministically(tmp_path):
    def run(d):
        svc, queries = build_stack(PORT, d, chaos_seed=CHAOS_SEEDS[0])
        trace = [[wire(r) for r in svc.search_batch(queries, top_k=TOP_K)] for _ in range(5)]
        return trace, fired(svc)

    assert run(tmp_path / "a") == run(tmp_path / "b")


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------


def test_recovery_restores_byte_identical_state(tmp_path):
    spec, queries = corpus()
    oracles = oracles_for(spec, queries)

    def scenario(pkg, d):
        svc, queries = build_stack(pkg, d)
        replica = pkg.restore(d / "snap")  # an uncrashed replica of the lineage
        victim = 1
        pre_epoch = svc.indexers[victim]._restore_epoch
        svc.injector.schedule = (pkg.FaultEvent("shard.search", "kill", shard=victim, at_call=0),)
        resp = svc.search_batch(queries[:1], top_k=TOP_K)[0]
        assert resp.stats.recoveries == 1 and resp.stats.shards_degraded == 0
        eq, why = pkg.index_sets_equal(svc.indexers[victim].index.to_index_set(),
                                       replica.indexers[victim].index.to_index_set())
        assert eq, f"recovered shard != uncrashed replica: {why}"
        assert svc.indexers[victim]._restore_epoch > pre_epoch
        assert svc.indexers[victim]._restore_epoch != replica.indexers[victim]._restore_epoch
        if pkg is PORT:
            assert_exact_or_flagged(svc, resp, oracles[queries[0]])
        return wire(resp), fired(svc)

    port, ref = both(scenario, tmp_path)
    assert_same_responses(port[0], ref[0])
    assert port[1] == ref[1]


def test_corrupt_latest_snapshot_falls_back_to_older(tmp_path):
    spec, queries = corpus()
    oracles = oracles_for(spec, queries)

    def scenario(pkg, d):
        svc, queries = build_stack(pkg, d)
        svc.commit()
        svc.snapshot(d / "snap")  # snap_0 and snap_1
        svc.injector.schedule = (
            pkg.FaultEvent("shard.search", "kill", shard=2, at_call=0),
            pkg.FaultEvent("store.load_snapshot", "bitflip", at_call=0, param=0.5),
        )
        resp = svc.search_batch(queries[:1], top_k=TOP_K)[0]
        assert "bitflip" in [e["kind"] for e in svc.injector.log]
        assert resp.stats.recoveries == 1 and resp.stats.shards_degraded == 0
        if pkg is PORT:
            assert_exact_or_flagged(svc, resp, oracles[queries[0]])
        return wire(resp), svc.injector.log

    port, ref = both(scenario, tmp_path)
    assert_same_responses(port[0], ref[0])
    assert [{k: v for k, v in e.items() if k != "path"} for e in port[1]] == \
        [{k: v for k, v in e.items() if k != "path"} for e in ref[1]]


def test_unrecoverable_shard_degrades_gracefully(tmp_path):
    spec, queries = corpus()
    oracles = oracles_for(spec, queries)

    def scenario(pkg, d):
        svc, queries = build_stack(pkg, d)
        svc.injector.schedule = (
            pkg.FaultEvent("shard.search", "kill", shard=0, at_call=0),
            pkg.FaultEvent("store.load_snapshot", "bitflip", at_call=0, count=50, param=0.3),
        )
        trace = []
        for _ in range(3):
            resps = svc.search_batch(queries, top_k=TOP_K)
            for q, resp in zip(queries, resps):
                assert resp.stats.shards_degraded == 1 and resp.stats.partial
                assert resp.stats.recoveries == 0
                if pkg is PORT:
                    assert_exact_or_flagged(svc, resp, oracles[q])
            trace.append([wire(r) for r in resps])
        assert svc.supervisor.recoveries == 0 and svc.supervisor.health.errors[0] > 0
        return trace, fired(svc)

    port, ref = both(scenario, tmp_path)
    assert_same_responses(port[0], ref[0])
    assert port[1] == ref[1]


# ---------------------------------------------------------------------------
# transient faults: retries, hedges, arena pressure
# ---------------------------------------------------------------------------


def test_transient_crash_retries_then_serves_exact(tmp_path):
    spec, queries = corpus()
    oracles = oracles_for(spec, queries)

    def scenario(pkg, d):
        svc, queries = build_stack(pkg, d)
        svc.injector.schedule = (pkg.FaultEvent("shard.search", "crash", shard=1, at_call=0, count=1),)
        resp = svc.search_batch(queries[:1], top_k=TOP_K)[0]
        assert resp.stats.retries == 1 and resp.stats.shards_degraded == 0
        assert not resp.stats.partial
        return wire(resp)

    port, ref = both(scenario, tmp_path)
    assert_same_responses(port, ref)
    assert {(d, f[1], f[2]) for d, frs in port["docs"] for f in frs} == oracles[queries[0]]


@pytest.mark.parametrize("delay_s, hedges", [(0.2, 1), (0.01, 0)])
def test_straggler_hedge_on_the_virtual_clock(delay_s, hedges, tmp_path):
    """A straggler delay above the 0.02 s threshold hedges, one below does
    not; virtual time advances by exactly the injected delay."""
    spec, queries = corpus()
    oracles = oracles_for(spec, queries)

    def scenario(pkg, d):
        clock = pkg.ManualClock()
        svc, queries = build_stack(pkg, d, snapshot=False, hedge_after_s=0.02, clock=clock)
        svc.injector.schedule = (
            pkg.FaultEvent("shard.straggler", "delay", shard=2, at_call=0, delay_s=delay_s),
        )
        resp = svc.search_batch(queries[:1], top_k=TOP_K)[0]
        assert resp.stats.hedges == hedges and resp.stats.shards_degraded == 0
        assert clock.peek() == delay_s
        assert svc.supervisor.health.probes > 0
        return wire(resp), clock.peek(), svc.supervisor.health.metrics()

    port, ref = both(scenario, tmp_path)
    assert_same_responses(port[0], ref[0])
    assert port[1:] == ref[1:]
    assert {(d, f[1], f[2]) for d, frs in port[0]["docs"] for f in frs} == oracles[queries[0]]


def test_arena_pressure_falls_back_to_host_exactly(tmp_path):
    spec, queries = corpus(n_queries=3)

    def scenario(pkg, d):
        store = pkg.DocumentStore.from_texts(spec.texts)
        kw = dict(n_shards=N_SHARDS, sw_count=spec.sw_count, fu_count=spec.fu_count,
                  max_distance=spec.max_distance, algorithm="fused", incremental=True)
        want = [response_frags(r) for r in
                pkg.ShardedSearchService(store, **kw).search_batch(queries, top_k=TOP_K)]
        arena = pkg.PostingArena(budget_bytes=32 << 20)
        svc = pkg.ShardedSearchService(store, arena=arena, **kw)
        svc.enable_resilience(policy=fast_policy(pkg), injector=pkg.FaultInjector(
            schedule=[pkg.FaultEvent("arena.acquire", "overflow", at_call=0, count=1)]))
        trace = []
        # round 1 under injected pressure (host pack), round 2 resident
        for _ in range(2):
            resps = svc.search_batch(queries, top_k=TOP_K)
            assert [response_frags(r) for r in resps] == want, "arena pressure changed fragments"
            trace.append([wire(r) for r in resps])
        assert arena.pressure_events == 1
        return trace, arena.metrics()["arena_pressure_events"], arena.hits

    port, ref = both(scenario, tmp_path)
    assert_same_responses(port[0], ref[0])
    assert port[1:] == ref[1:]


# ---------------------------------------------------------------------------
# fault-free traffic, load shedding, legacy dead_shards
# ---------------------------------------------------------------------------


def test_fault_free_traffic_leaves_counters_zero(tmp_path):
    def scenario(pkg, d):
        svc, queries = build_stack(pkg, d)
        frontend = pkg.ServingFrontend(svc, max_inflight=None)
        trace = []
        for _ in range(2):
            for resps in (svc.search_batch(queries, top_k=TOP_K), frontend.search_many(queries)):
                for resp in resps:
                    st = resp.stats
                    assert (st.retries, st.hedges, st.shards_degraded, st.recoveries, st.shed) == \
                        (0, 0, 0, 0, 0)
                    assert not st.partial
                trace.append([wire(r) for r in resps])
        m = frontend.metrics()
        assert m["sheds"] == 0 and m["resilience"]["recoveries"] == 0
        assert m["resilience"]["fired"] == 0
        assert all(s == "closed" for s in m["resilience"]["breaker_states"])
        return trace, counters(m["resilience"])

    port, ref = both(scenario, tmp_path)
    assert_same_responses(port[0], ref[0])
    assert port[1] == ref[1]


def test_load_shedding_is_flagged_and_exactly_ranked(tmp_path):
    spec, queries = corpus()
    oracles = oracles_for(spec, queries)

    def scenario(pkg, d):
        svc, queries = build_stack(pkg, d)
        frontend = pkg.ServingFrontend(svc, max_inflight=1, shed_deadline_sec=0.0)
        unique = list(dict.fromkeys(queries))
        assert len(unique) >= 2
        reqs = [pkg.SearchRequest(q, top_k=TOP_K) for q in unique]
        out = frontend.search_many(reqs)
        assert [r.stats.shed for r in out] == [0] + [1] * (len(unique) - 1)
        for q, resp in zip(unique[1:], out[1:]):
            assert resp.stats.cache_hits == 0 and resp.docs == []
            if oracles[q]:
                assert resp.stats.partial
        assert response_frags(out[0]) == oracles[unique[0]]
        assert frontend.metrics()["sheds"] == len(unique) - 1
        trace = [wire(r) for r in out]
        dropped = [(i, q) for i, q in enumerate(unique) if i > 0 and oracles[q]]
        if dropped:
            i, q = dropped[0]
            again = frontend.search_many([reqs[i]])[0]
            assert again.stats.cache_hits == 0 and again.stats.shed == 0
            assert response_frags(again) == oracles[q]
            trace.append(wire(again))
        return trace

    port, ref = both(scenario, tmp_path)
    assert_same_responses(port, ref)


def test_legacy_dead_shards_routes_through_injector(tmp_path):
    spec, queries = corpus()
    oracles = oracles_for(spec, queries)

    def scenario(pkg, d):
        svc, queries = build_stack(pkg, d, snapshot=False)
        q = queries[0]
        resp = svc.search_batch([q], top_k=TOP_K, dead_shards=(1,))[0]
        assert resp.stats.shards_degraded == 1 and resp.stats.partial
        assert svc.supervisor.last_excluded == frozenset({1})
        if pkg is PORT:
            assert_exact_or_flagged(svc, resp, oracles[q])
        assert not svc.injector.is_down(1), "the hold must not outlive the call"
        clean = svc.search_batch([q], top_k=TOP_K)[0]
        assert clean.stats.shards_degraded == 0
        assert response_frags(clean) == oracles[q]
        return [wire(resp), wire(clean)]

    port, ref = both(scenario, tmp_path)
    assert_same_responses(port, ref)


def test_dead_shards_on_a_plain_service_enables_resilience(tmp_path):
    """A static service with no resilience layer: ``dead_shards`` turns it
    on lazily, and every algorithm's degraded response is the reference's."""
    spec, queries = corpus()

    def scenario(pkg, d):
        store = pkg.DocumentStore.from_texts(spec.texts)
        svc = pkg.ShardedSearchService(store, n_shards=N_SHARDS, sw_count=spec.sw_count,
                                       fu_count=spec.fu_count, max_distance=spec.max_distance)
        out = []
        for alg in ("se2.4", "fused", "se1"):
            svc.algorithm = alg
            out.append([wire(r) for r in svc.search_batch(queries, top_k=TOP_K, dead_shards=[0, 2])])
        assert svc.supervisor is not None and svc.resilience_metrics()["held"] == []
        return out

    port, ref = both(scenario, tmp_path)
    assert_same_responses(port, ref)
    assert all(r["flags"][2] == 2 and r["flags"][0] for alg in port for r in alg)


# ---------------------------------------------------------------------------
# §18: WAL recovery under fire
# ---------------------------------------------------------------------------


def build_wal_stack(pkg, d, chaos_seed=None, wal_faults=False):
    spec, queries = corpus()
    store = pkg.DocumentStore.from_texts(spec.texts)
    svc = pkg.ShardedSearchService(
        store, n_shards=N_SHARDS, sw_count=spec.sw_count, fu_count=spec.fu_count,
        max_distance=spec.max_distance, algorithm="fused", incremental=True,
    )
    svc.enable_wal(d / "snap")
    svc.snapshot(d / "snap")
    injector = (pkg.FaultInjector.from_seed(chaos_seed, n_shards=N_SHARDS, wal=wal_faults)
                if chaos_seed is not None else None)
    svc.enable_resilience(policy=fast_policy(pkg), injector=injector)
    svc.enable_wal(d / "snap")  # re-arm the logs with the service's injector
    return svc, store, queries


def restore_lineage(pkg, path, lemmatizer):
    ids = sorted(int(p.name.rsplit("_", 1)[1]) for p in path.glob("snap_*")
                 if p.is_dir() and p.name.rsplit("_", 1)[1].isdigit())
    last_err = None
    for sid in reversed(ids):
        try:
            return pkg.IncrementalIndexer.restore(path, snapshot_id=sid, lemmatizer=lemmatizer)
        except pkg.StoreError as e:
            last_err = e
    raise last_err if last_err else FileNotFoundError(path)


def assert_durable_equals_live(pkg, svc, store, d, ctx=""):
    """§18.2, per shard: a fresh restore of the durable lineage (snapshot +
    WAL tail) is ``index_sets_equal`` to the live shard."""
    for i, live in enumerate(svc.indexers):
        replica = restore_lineage(pkg, d / "snap" / f"shard_{i:02d}", store.lemmatizer)
        eq, why = pkg.index_sets_equal(live.index.to_index_set(), replica.index.to_index_set())
        assert eq, f"{ctx}: shard {i} durable state != live: {why}"
        assert live.documents.keys() == replica.documents.keys(), (ctx, i)
        assert live.tombstones == replica.tombstones, (ctx, i)
        assert sorted(live._buffer) == sorted(replica._buffer), (ctx, i)


def test_wal_recovery_restores_post_snapshot_commits(tmp_path):
    def scenario(pkg, d):
        svc, store, queries = build_wal_stack(pkg, d)
        svc.add_documents(["zeta omega gamma delta epsilon"])
        svc.commit()
        victim = 1
        pre_epoch = svc.indexers[victim]._restore_epoch
        want_docs = set(svc.indexers[victim].documents)
        svc.injector.schedule = (pkg.FaultEvent("shard.search", "kill", shard=victim, at_call=0),)
        resp = svc.search_batch(queries[:1], top_k=TOP_K)[0]
        assert resp.stats.recoveries == 1 and resp.stats.shards_degraded == 0
        assert svc.supervisor.metrics()["wal_records_replayed"] > 0
        assert set(svc.indexers[victim].documents) == want_docs
        assert_durable_equals_live(pkg, svc, store, d, "post-recovery")
        assert svc.indexers[victim]._restore_epoch > pre_epoch
        return wire(resp), svc.supervisor.wal_records_replayed

    port, ref = both(scenario, tmp_path)
    assert_same_responses(port[0], ref[0])
    assert port[1] == ref[1]


def test_crash_mid_commit_loses_nothing_acked(tmp_path):
    def scenario(pkg, d):
        svc, store, _ = build_wal_stack(pkg, d)
        svc.add_documents(["first acked doc alpha beta"])
        svc.commit()
        victim = 0
        svc.injector.schedule = (pkg.FaultEvent("wal.torn_tail", "kill", shard=victim, at_call=0),)
        svc.injector._arrivals.clear()
        before = set(svc.indexers[victim].documents)
        with pytest.raises(pkg.ShardCrash):
            svc.commit()
        assert set(svc.indexers[victim].documents) == before
        assert [e for e in svc.injector.log if e["point"] == "wal.torn_tail"]
        assert_durable_equals_live(pkg, svc, store, d, "after torn commit")
        return fired(svc), sorted(svc.injector.down)

    port, ref = both(scenario, tmp_path)
    assert port == ref


def test_wal_append_crash_aborts_before_any_mutation(tmp_path):
    def scenario(pkg, d):
        svc, store, _ = build_wal_stack(pkg, d)
        victim = 2
        svc.injector.schedule = (pkg.FaultEvent("wal.append", "crash", shard=victim, at_call=0, count=1),)
        n_records = len(svc.indexers[victim].wal.records())
        with pytest.raises(pkg.ShardCrash):
            svc.commit()
        assert len(svc.indexers[victim].wal.records()) == n_records
        assert_durable_equals_live(pkg, svc, store, d, "after aborted append")
        svc.commit()
        assert len(svc.indexers[victim].wal.records()) == n_records + 1
        assert_durable_equals_live(pkg, svc, store, d, "after retried commit")
        return fired(svc), n_records

    port, ref = both(scenario, tmp_path)
    assert port == ref


@pytest.mark.parametrize("chaos_seed", WAL_SEEDS)
def test_wal_chaos_durable_equals_live_and_reference(chaos_seed, tmp_path):
    """Rounds of mutation and serving under ``wal.*`` faults and shard
    kills: crashed mutations are unacknowledged no-ops, every shard's
    durable lineage replays to the live state after every round, and the
    port's responses and fired faults are the reference's."""

    def scenario(pkg, d):
        svc, store, queries = build_wal_stack(pkg, d, chaos_seed=chaos_seed, wal_faults=True)
        trace = []
        for rnd in range(4):
            try:
                svc.add_documents([f"round {rnd} mutation doc alpha beta gamma"])
                svc.commit()
            except pkg.ShardCrash:
                pass
            try:
                svc.snapshot(d / "snap")
            except pkg.ShardCrash:
                pass
            trace.append([wire(r) for r in svc.search_batch(queries, top_k=TOP_K)])
            assert_durable_equals_live(pkg, svc, store, d, f"seed {chaos_seed} round {rnd}")
        assert [e for e in svc.injector.log if e["point"].startswith("wal.")]
        return trace, fired(svc)

    port, ref = both(scenario, tmp_path)
    assert_same_responses(port[0], ref[0], f"seed {chaos_seed}")
    assert port[1] == ref[1]
