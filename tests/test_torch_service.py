"""The port's continuous-batching daemon, its replicated failover and its
JSON-lines transport (``search/service.py``) against the reference's.

Deterministic runs (a virtual clock, ``replay``/``drain``/``pump``) are
held to the reference's run of the same schedule: the same batches, queue
waits, effective deadlines, replicas and responses (documents and flags
identical, scores within rtol 1e-5).  Threaded and socket runs are held to
a serial frontend and to the SE2.4 oracle.  A daemon with slates in flight
on two replicas is held to a serial ``search_many`` byte for byte.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest

from repro.index import DocumentStore as RefDocumentStore
from repro.index import build_indexes as ref_build_indexes
from repro.runtime.clock import ManualClock as RefManualClock
from repro.search.frontend import SearchRequest as RefRequest
from repro.search.frontend import ServingFrontend as RefFrontend
from repro.search.resilience import FaultEvent as RefFaultEvent
from repro.search.resilience import FaultInjector as RefFaultInjector
from repro.search.service import ReplicatedServiceDaemon as RefReplicated
from repro.search.service import ServiceDaemon as RefDaemon
from repro.search.service import response_to_wire as ref_response_to_wire
from repro_torch.index import DocumentStore, IncrementalIndexer, build_indexes, synthesize_corpus
from repro_torch.runtime.clock import ManualClock
from repro_torch.search import SearchRequest, ServingFrontend, ShardedSearchService
from repro_torch.search.arena import PostingArena
from repro_torch.search.resilience import FaultEvent, FaultInjector
from repro_torch.search.service import (
    ReplicatedServiceDaemon,
    ServiceDaemon,
    request_over_tcp,
    response_to_wire,
    serve_tcp,
)
from tests._hypothesis_compat import given, settings
from tests.strategies import make_arrival_schedule, make_corpus, make_queries, seeds
from tests.test_torch_resilience import (
    CHAOS_SEEDS,
    N_SHARDS,
    PACKAGES,
    PORT,
    TOP_K,
    assert_same_responses,
    build_stack,
    oracles_for,
    corpus,
    ranking,
    response_frags,
    wire,
)

MAX_BATCH = 4


def _assert_wire_equal(got: dict, want: dict, ctx=""):
    """Two ``response_to_wire`` dicts: everything identical but the scores,
    which agree within rtol 1e-5."""
    def strip(w):
        return {**w, "docs": [{**d, "score": None} for d in w["docs"]]}

    assert strip(got) == strip(want), ctx
    np.testing.assert_allclose([d["score"] for d in got["docs"]],
                               [d["score"] for d in want["docs"]], rtol=1e-5, err_msg=ctx)


def _assert_exact_or_flagged_frags(resp, oracle):
    """The §14 invariant without the live excluded set: the whole oracle,
    or flagged partial and the oracle minus whole shards, ranked exactly."""
    got = response_frags(resp)
    if got == oracle:
        return
    assert resp.stats.partial, (resp.query, "divergent response not flagged")
    dead = {s for s in range(N_SHARDS)
            if any(f[0] % N_SHARDS == s for f in oracle)
            and not any(f[0] % N_SHARDS == s for f in got)}
    expected = {f for f in oracle if f[0] % N_SHARDS not in dead}
    assert got == expected, (resp.query, sorted(dead), "not whole-shard coverage")
    assert [(d.doc_id, d.score) for d in resp.docs] == ranking(expected), resp.query


# ---------------------------------------------------------------------------
# the daemon under chaos (the reference's tests/test_service.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chaos_seed", CHAOS_SEEDS)
def test_concurrent_clients_under_chaos_exact_or_flagged(chaos_seed, tmp_path):
    spec, queries = corpus()
    oracles = oracles_for(spec, queries)
    svc, queries = build_stack(PORT, tmp_path, chaos_seed=chaos_seed)
    daemon = ServiceDaemon(ServingFrontend(svc, device="cpu"), max_queue=512).start()
    n_clients, rounds = 4, 3
    results: list[list] = [[] for _ in range(n_clients)]
    errors: list[BaseException] = []

    def client(c: int) -> None:
        try:
            for _ in range(rounds):
                tickets = [daemon.submit(SearchRequest(q, top_k=TOP_K)) for q in queries]
                for q, t in zip(queries, tickets):
                    results[c].append((q, t.result(timeout=120.0)))
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300.0)
    daemon.stop()
    assert not errors, errors
    served = [pair for per_client in results for pair in per_client]
    assert len(served) == n_clients * rounds * len(queries)
    for q, resp in served:
        _assert_exact_or_flagged_frags(resp, oracles[q])
    m = daemon.metrics()
    assert m["submitted"] == m["completed"] + m["shed_queue"] and m["shed_queue"] == 0


def test_deterministic_chaos_replay_through_daemon_equals_reference(tmp_path):
    """One seed on the virtual clock: two port runs and the reference's run
    give the same batches and responses."""

    def run(pkg, d):
        clock = pkg.ManualClock()
        svc, queries = build_stack(pkg, d, chaos_seed=CHAOS_SEEDS[0], clock=clock)
        daemon_cls = ServiceDaemon if pkg is PORT else RefDaemon
        daemon = daemon_cls(pkg.ServingFrontend(svc, clock=clock), clock=clock, max_queue=512)
        schedule = [(i * 0.001, pkg.SearchRequest(q, top_k=TOP_K))
                    for i, q in enumerate(queries * 6)]
        tickets = daemon.replay(schedule, service_time_sec=0.004)
        return [(wire(t.result(timeout=0)), t.batch_size, t.replica, t.queue_wait_sec)
                for t in tickets], daemon.metrics()

    port_a = run(PORT, tmp_path / "a")
    port_b = run(PORT, tmp_path / "b")
    ref = run(PACKAGES["ref"], tmp_path / "ref")
    assert [t[1:] for t in port_a[0]] == [t[1:] for t in port_b[0]] == [t[1:] for t in ref[0]]
    assert port_a[1] == ref[1]
    assert_same_responses([t[0] for t in port_a[0]], [t[0] for t in port_b[0]])
    assert_same_responses([t[0] for t in port_a[0]], [t[0] for t in ref[0]])


def test_replica_routing_consistent_across_commit_and_compact():
    store = synthesize_corpus(n_docs=50, doc_len=100, vocab_size=600, seed=11)
    ix = IncrementalIndexer(sw_count=60, fu_count=150, max_distance=5, lemmatizer=store.lemmatizer)
    ix.add_documents([d.text for d in store.documents])
    ix.commit()
    clock = ManualClock()
    replicas = [ServingFrontend(ix, lemmatizer=store.lemmatizer, max_batch=2, clock=clock,
                                device="cpu") for _ in range(2)]
    daemon = ServiceDaemon(replicas, clock=clock, max_queue=64)
    queries = ["who are you who", "to be or not to be", "the who", "you do"]

    def serve_all():
        tickets = [daemon.submit(SearchRequest(q, top_k=50)) for q in queries]
        daemon.drain()
        return [t.result(timeout=0) for t in tickets]

    def reference():
        fe = ServingFrontend(ix, lemmatizer=store.lemmatizer, device="cpu")
        return {q: fe.search(q, top_k=50) for q in queries}

    def frags(resp):
        return sorted((d.doc_id, f.start, f.end) for d in resp.docs for f in d.fragments)

    for resp, (q, want) in zip(serve_all(), reference().items()):
        assert frags(resp) == frags(want), q
    ix.add_documents(["who are you who are you", "to be or not to be at all"])
    ix.commit()
    want = reference()
    got = serve_all() + serve_all()
    for resp in got:
        assert frags(resp) == frags(want[resp.query]), (resp.query, "stale post-commit")
    victim = next(r for r in got if r.docs).docs[0].doc_id
    ix.delete_document(victim)
    ix.compact()
    want = reference()
    for resp in serve_all() + serve_all():
        assert frags(resp) == frags(want[resp.query]), (resp.query, "stale post-compact")
        assert victim not in [d.doc_id for d in resp.docs]
    assert all(n > 0 for n in daemon.metrics()["per_replica_batches"])


# ---------------------------------------------------------------------------
# slates in flight on two replicas == a serial frontend, byte for byte
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sharded():
    store = synthesize_corpus(n_docs=60, doc_len=100, vocab_size=500, seed=5)
    svc = ShardedSearchService(store, n_shards=4, sw_count=40, fu_count=100, device="cpu")
    queries = ["who are you who", "to be or not to be", "what do you do all day",
               "the time of war", "to be who you are", "one at a time", "i need you",
               "time and time again"]
    return svc, queries


@pytest.mark.parametrize("arena", ["none", "own", "shared"])
def test_two_replicas_with_slates_in_flight_equal_serial_frontend(sharded, arena):
    """Both replicas hold a launched, unfinalized slate before either is
    read out (the daemon launches onto every idle replica first); no
    buffer one slate's readout sees may belong to the other — over the host
    route, an arena per replica, and one arena both replicas share."""
    svc, queries = sharded
    shared = PostingArena(budget_bytes=64 << 20, device="cpu") if arena == "shared" else None

    def frontend():
        kw = {"own": dict(arena_budget_mb=64), "shared": dict(arena=shared)}.get(arena, {})
        return ServingFrontend(svc, max_batch=3, use_kernel=True, device="cpu", **kw)

    clock = ManualClock()
    daemon = ServiceDaemon([frontend(), frontend()], clock=clock, max_queue=64)
    requests = [SearchRequest(q, top_k=7) for q in queries * 2]
    tickets = [daemon.submit(r) for r in requests]
    assert daemon._launch_ready()
    assert len(daemon._inflight) == 2 and all(daemon._busy)  # two slates in flight
    daemon.drain()
    # one serial frontend per replica: each replica's result cache sees its
    # own batches in order, and so does its serial twin
    serial = [frontend(), frontend()]
    batches: dict[int, list] = {}
    for t in tickets:
        assert t.batch_size == min(3, len(tickets) - t.seq // 3 * 3)
        batches.setdefault(t.seq // 3, []).append(t)
    for _, batch in sorted(batches.items()):
        want = serial[batch[0].replica].search_many([t.request for t in batch])
        for t, w in zip(batch, want):
            got = t.result(timeout=0)
            assert json.dumps(response_to_wire(got)) == json.dumps(response_to_wire(w)), t.seq
    assert daemon.metrics()["per_replica_batches"][1] > 0


# ---------------------------------------------------------------------------
# queue properties on the virtual clock (tests/test_queue_properties.py)
# ---------------------------------------------------------------------------


def _queue_stack(seed):
    spec = make_corpus(seed, max_docs=8)
    queries = make_queries(seed, spec, n_queries=4)
    kw = dict(sw_count=spec.sw_count, fu_count=spec.fu_count, max_distance=spec.max_distance)
    port = build_indexes(DocumentStore.from_texts(spec.texts), **kw)
    ref = ref_build_indexes(RefDocumentStore.from_texts(spec.texts), **kw)
    return port, ref, queries


def _daemons(port_index, ref_index, **kw):
    kw.setdefault("max_queue", 64)
    pc, rc = ManualClock(), RefManualClock()
    port = ServiceDaemon(ServingFrontend(port_index, max_batch=MAX_BATCH, clock=pc, device="cpu"),
                         clock=pc, **kw)
    ref = RefDaemon(RefFrontend(ref_index, max_batch=MAX_BATCH, clock=rc), clock=rc, **kw)
    return port, ref


def _replay(daemon, request_cls, spec):
    schedule = [(t, request_cls(query=q, top_k=k, deadline_sec=d)) for t, q, k, d in spec.events]
    return daemon.replay(schedule, service_time_sec=spec.service_time_sec)


def _tickets(tickets):
    return [(t.seq, t.batch_size, t.replica, t.shed_at_queue, t.queue_wait_sec,
             t.effective_deadline_sec, t.latency_sec) for t in tickets]


def _batches(tickets):
    served = sorted((t for t in tickets if not t.shed_at_queue), key=lambda t: t.seq)
    out, i = [], 0
    while i < len(served):
        size = served[i].batch_size
        assert size >= 1
        out.append(served[i:i + size])
        i += size
    return out


@given(seeds)
@settings(max_examples=5, deadline=None, derandomize=True)
def test_daemon_replay_equals_reference_and_serial_frontend(seed):
    """Any arrival schedule: the port's replay makes the reference's
    batching decisions, and each response is a serial ``search_many`` of
    its batch with the recorded effective deadlines."""
    port_index, ref_index, queries = _queue_stack(seed)
    spec = make_arrival_schedule(seed, queries, max_events=14)
    port, ref = _daemons(port_index, ref_index)
    got, want = _replay(port, SearchRequest, spec), _replay(ref, RefRequest, spec)
    assert _tickets(got) == _tickets(want)
    assert_same_responses([wire(t.result(timeout=0)) for t in got],
                          [wire(t.result(timeout=0)) for t in want], f"seed {seed}")
    serial = ServingFrontend(port_index, max_batch=MAX_BATCH, clock=ManualClock(), device="cpu")
    for batch in _batches(got):
        expected = serial.search_many([
            SearchRequest(query=t.request.query, top_k=t.request.top_k,
                          deadline_sec=t.effective_deadline_sec) for t in batch])
        for t, w in zip(batch, expected):
            assert response_to_wire(t.result(timeout=0)) == response_to_wire(w), t.seq


@given(seeds)
@settings(max_examples=5, deadline=None, derandomize=True)
def test_admission_order_no_starvation_and_conservation(seed):
    port_index, ref_index, queries = _queue_stack(seed)
    spec = make_arrival_schedule(seed, queries, max_events=18)
    port, ref = _daemons(port_index, ref_index, max_queue=6)
    tickets = _replay(port, SearchRequest, spec)
    assert _tickets(tickets) == _tickets(_replay(ref, RefRequest, spec))
    assert all(t.done() for t in tickets)
    cursor = -1
    for batch in _batches(tickets):
        seqs = [t.seq for t in batch]
        assert seqs == sorted(seqs) and seqs[0] > cursor
        cursor = seqs[-1]
        assert len(batch) <= port.batch_limit
        assert all(t.replica == batch[0].replica for t in batch)
    m = port.metrics()
    assert m == ref.metrics()
    assert m["submitted"] == len(tickets) == m["completed"] + m["shed_queue"]
    assert m["queued"] == 0 and m["inflight_requests"] == 0
    assert m["batched_requests"] == m["completed"]


@given(seeds)
@settings(max_examples=5, deadline=None, derandomize=True)
def test_sheds_and_partials_are_flagged_and_never_cached(seed):
    port_index, ref_index, queries = _queue_stack(seed)
    spec = make_arrival_schedule(seed, queries, max_events=18)
    port, ref = _daemons(port_index, ref_index, max_queue=3)
    tickets = _replay(port, SearchRequest, spec)
    assert_same_responses([wire(t.result(timeout=0)) for t in tickets],
                          [wire(t.result(timeout=0)) for t in _replay(ref, RefRequest, spec)])
    for t in tickets:
        resp = t.result(timeout=0)
        if t.shed_at_queue:
            assert resp.stats.shed == 1 and resp.stats.partial
            assert resp.docs == [] and resp.stats.cache_hits == 0
        if resp.stats.partial:
            assert resp.stats.cache_hits == 0
    flagged = [t for t in tickets if t.result(timeout=0).stats.partial]
    if flagged:
        q, top_k = flagged[0].request.query, flagged[0].request.top_k
        again = port.submit(SearchRequest(query=q, top_k=top_k))
        port.drain()
        resp = again.result(timeout=0)
        want = ServingFrontend(port_index, max_batch=MAX_BATCH, clock=ManualClock(),
                               device="cpu").search(q, top_k=top_k)
        assert resp.stats.shed == 0 and not resp.stats.partial
        assert response_to_wire(resp)["docs"] == response_to_wire(want)["docs"]


def test_saturating_burst_batches_continuously():
    port_index, ref_index, queries = _queue_stack(7)
    port, ref = _daemons(port_index, ref_index)
    tickets = []
    for daemon, req in ((port, SearchRequest), (ref, RefRequest)):
        schedule = [(i * 0.001, req(query=queries[i % len(queries)], top_k=10)) for i in range(12)]
        tickets.append(daemon.replay(schedule, service_time_sec=0.010))
    assert _tickets(tickets[0]) == _tickets(tickets[1])
    m = port.metrics()
    assert m["mean_batch_occupancy"] > 1.0 and m["batches"] < len(tickets[0])
    assert tickets[0][1].queue_wait_sec == 0.010 - 0.001


def test_multi_replica_round_robin_serves_all_exactly():
    port_index, _, queries = _queue_stack(11)
    clock = ManualClock()
    replicas = [ServingFrontend(port_index, max_batch=2, clock=clock, device="cpu")
                for _ in range(2)]
    daemon = ServiceDaemon(replicas, clock=clock, max_queue=64)
    schedule = [(i * 0.0005, SearchRequest(query=queries[i % len(queries)], top_k=10))
                for i in range(10)]
    tickets = daemon.replay(schedule, service_time_sec=0.002)
    reference = ServingFrontend(port_index, max_batch=2, clock=ManualClock(), device="cpu")
    for t in tickets:
        want = reference.search(t.request.query, top_k=10)
        assert response_to_wire(t.result(timeout=0))["docs"] == response_to_wire(want)["docs"]
    assert all(n > 0 for n in daemon.metrics()["per_replica_batches"])


# ---------------------------------------------------------------------------
# replicated failover (tests/test_chaos.py §18.3), against the reference
# ---------------------------------------------------------------------------


def _serving_stacks():
    spec = make_corpus(17, max_docs=8)
    kw = dict(n_shards=N_SHARDS, sw_count=spec.sw_count, fu_count=spec.fu_count,
              max_distance=spec.max_distance, algorithm="fused", incremental=True)
    port = ShardedSearchService(DocumentStore.from_texts(spec.texts), **kw, device="cpu")
    from repro.search.distributed import ShardedSearchService as RefService

    ref = RefService(RefDocumentStore.from_texts(spec.texts), **kw)
    queries = list(dict.fromkeys(make_queries(17, spec, n_queries=6)))
    return port, ref, queries


def _replicated(pkg_svc, port: bool, n=2, injector=None, lease_sec=0.05):
    clock = ManualClock() if port else RefManualClock()
    fe = (lambda: ServingFrontend(pkg_svc, device="cpu")) if port else (lambda: RefFrontend(pkg_svc))
    daemon_cls, rep_cls = (ServiceDaemon, ReplicatedServiceDaemon) if port else (RefDaemon, RefReplicated)
    return rep_cls([daemon_cls([fe()], clock=clock) for _ in range(n)], clock=clock,
                   lease_sec=lease_sec, injector=injector)


def _both_replicated(scenario):
    port_svc, ref_svc, queries = _serving_stacks()
    port = scenario(port_svc, True, queries)
    ref = scenario(ref_svc, False, queries)
    return port, ref, port_svc, queries


def test_replicated_failover_readmits_exactly_once_byte_identical():
    def scenario(svc, port, queries):
        req = SearchRequest if port else RefRequest
        rep = _replicated(svc, port)
        handles = [rep.submit(req(q, top_k=TOP_K), request_id=f"req-{i}")
                   for i, q in enumerate(queries)]
        assert rep.crash_primary() == 0
        rep.drain()
        m = rep.metrics()
        assert m["failovers"] == 1 and m["primary"] == 1
        assert m["readmitted"] == len(handles) == m["completed"] == m["requests"]
        assert [h.readmissions for h in handles] == [1] * len(handles)
        to_wire = response_to_wire if port else ref_response_to_wire
        return [to_wire(h.result()) for h in handles], m

    (got, m), (want, ref_m), svc, queries = _both_replicated(scenario)
    assert {k: v for k, v in m.items() if k != "primary_metrics"} == \
        {k: v for k, v in ref_m.items() if k != "primary_metrics"}
    for g, w in zip(got, want):
        _assert_wire_equal(g, w)
    serial = ServingFrontend(svc, device="cpu").search_many([SearchRequest(q, top_k=TOP_K)
                                                            for q in queries])
    assert [json.dumps(g) for g in got] == [json.dumps(response_to_wire(s)) for s in serial]


def test_replicated_lease_window_parks_then_serves_exactly():
    def scenario(svc, port, queries):
        req = SearchRequest if port else RefRequest
        rep = _replicated(svc, port)
        assert rep.crash_primary() == 0
        h = rep.submit(req(queries[0], top_k=TOP_K), request_id="parked")
        assert not h.done(), "the lease window must park, not shed"
        rep.drain()
        m = rep.metrics()
        assert m["failovers"] == 1 and m["readmitted"] == 0 and h.readmissions == 0
        return (response_to_wire if port else ref_response_to_wire)(h.result())

    got, want, _, _ = _both_replicated(scenario)
    _assert_wire_equal(got, want)


def test_replicated_dedup_returns_recorded_response_verbatim():
    port_svc, _, queries = _serving_stacks()
    rep = _replicated(port_svc, True)
    h1 = rep.submit(SearchRequest(queries[0], top_k=TOP_K), request_id="dup")
    rep.drain()
    first = h1.result()
    h2 = rep.submit(SearchRequest(queries[0], top_k=TOP_K), request_id="dup")
    assert h2 is h1 and h2.result() is first
    assert rep.metrics()["dedup_hits"] == 1


def test_replicated_daemon_crash_fault_point_and_down_set_isolation():
    def scenario(svc, port, queries):
        req = SearchRequest if port else RefRequest
        event, injector_cls = (FaultEvent, FaultInjector) if port else (RefFaultEvent, RefFaultInjector)
        injector = injector_cls(schedule=[event("daemon.crash", "kill", shard=0, at_call=0)])
        rep = _replicated(svc, port, n=3, injector=injector)
        handles = [rep.submit(req(q, top_k=TOP_K), request_id=f"r{i}")
                   for i, q in enumerate(queries[:3])]
        rep.drain()
        assert [e["point"] for e in injector.log] == ["daemon.crash"]
        assert not injector.down, "a daemon replica kill leaked into the shard down-set"
        m = rep.metrics()
        assert m["failovers"] == 1 and m["alive"] == [False, True, True]
        return [(response_to_wire if port else ref_response_to_wire)(h.result()) for h in handles]

    got, want, _, _ = _both_replicated(scenario)
    for g, w in zip(got, want):
        _assert_wire_equal(g, w)


def test_replicated_all_dead_sheds_flagged_never_errors():
    port_svc, _, queries = _serving_stacks()
    rep = _replicated(port_svc, True, n=1)
    assert rep.crash_primary() == 0
    h = rep.submit(SearchRequest(queries[0], top_k=TOP_K), request_id="doomed")
    assert h.done()
    resp = h.result()
    assert resp.stats.shed == 1 and resp.stats.partial and resp.docs == []
    assert rep.metrics()["primary"] is None


# ---------------------------------------------------------------------------
# the wire: response_to_wire and the TCP transport
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_indexes():
    from repro.index import synthesize_corpus as ref_synthesize_corpus

    kw = dict(n_docs=50, doc_len=100, vocab_size=600, seed=11)
    store, ref_store = synthesize_corpus(**kw), ref_synthesize_corpus(**kw)
    index = build_indexes(store, sw_count=60, fu_count=150, max_distance=5)
    ref_index = ref_build_indexes(ref_store, sw_count=60, fu_count=150, max_distance=5)
    return index, store.lemmatizer, ref_index, ref_store.lemmatizer


def test_response_to_wire_equals_reference(small_indexes):
    index, lem, ref_index, ref_lem = small_indexes
    queries = ["who are you who", "to be or not to be", "what do you do all day",
               "the who", "zzz unknown"]
    port_fe = ServingFrontend(index, lemmatizer=lem, device="cpu")
    ref_fe = RefFrontend(ref_index, lemmatizer=ref_lem)
    for deadline in (None, 0.0):
        reqs = [(q, 8, deadline) for q in queries] * 2  # the repeat hits the cache
        got = port_fe.search_many([SearchRequest(*r) for r in reqs])
        want = ref_fe.search_many([RefRequest(*r) for r in reqs])
        for g, w in zip(got, want):
            _assert_wire_equal(response_to_wire(g), ref_response_to_wire(w), g.query)


def test_tcp_round_trip_is_lossless_and_concurrent(small_indexes):
    index, lem, ref_index, ref_lem = small_indexes
    daemon = ServiceDaemon(ServingFrontend(index, lemmatizer=lem, max_batch=8, device="cpu"),
                           max_queue=64)
    server = serve_tcp(daemon)
    try:
        queries = ["who are you who", "to be or not to be", "what do you do all day"]
        reference = ServingFrontend(index, lemmatizer=lem, device="cpu")
        want = {q: response_to_wire(reference.search(q, top_k=8)) for q in queries}
        ref_fe = RefFrontend(ref_index, lemmatizer=ref_lem)
        outs: dict[str, dict] = {}
        errors: list[BaseException] = []

        def client(q: str) -> None:
            try:
                outs[q] = request_over_tcp(server.address, {"query": q, "top_k": 8})
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=client, args=(q,)) for q in queries]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not errors, errors
        for q in queries:
            got = outs[q]
            assert got["docs"] == want[q]["docs"], q
            assert not got["partial"] and not got["shed"] and got["batch_size"] >= 1
            ref_docs = ref_response_to_wire(ref_fe.search(q, top_k=8))["docs"]
            assert [(d["doc_id"], d["fragments"]) for d in got["docs"]] == \
                [(d["doc_id"], d["fragments"]) for d in ref_docs]
        m = request_over_tcp(server.address, {"op": "metrics"})["metrics"]
        assert m["completed"] == len(queries) == m["submitted"] - m["shed_queue"]
        assert request_over_tcp(server.address, {"op": "ping"}) == {"pong": True}
        assert "error" in request_over_tcp(server.address, {"op": "kill_primary"})
    finally:
        server.shutdown()
        server.server_close()
        daemon.stop()


def test_tcp_deadline_and_bad_requests(small_indexes):
    index, lem, _, _ = small_indexes
    daemon = ServiceDaemon(ServingFrontend(index, lemmatizer=lem, device="cpu"), max_queue=16)
    server = serve_tcp(daemon)
    try:
        out = request_over_tcp(server.address,
                               {"query": "who are you who", "top_k": 8, "deadline_ms": 0})
        assert out["partial"] and out["docs"] == []
        assert "error" in request_over_tcp(server.address, {"op": "nope"})
    finally:
        server.shutdown()
        server.server_close()
        daemon.stop()


def test_tcp_replicated_kill_primary_fails_over(small_indexes):
    """A threaded 2-replica daemon over TCP: ``kill_primary`` then searches
    — the successor answers every request once, equal to a serial frontend."""
    index, lem, _, _ = small_indexes
    fronts = [ServingFrontend(index, lemmatizer=lem, device="cpu") for _ in range(2)]
    daemon = ReplicatedServiceDaemon([ServiceDaemon([f]) for f in fronts])
    server = serve_tcp(daemon)
    try:
        killed = request_over_tcp(server.address, {"op": "kill_primary"})
        assert killed["killed"] == 0
        reference = ServingFrontend(index, lemmatizer=lem, device="cpu")
        for q in ["who are you who", "to be or not to be"]:
            out = request_over_tcp(server.address, {"query": q, "top_k": 8, "request_id": q})
            assert out["docs"] == response_to_wire(reference.search(q, top_k=8))["docs"]
            assert out["request_id"] == q and out["replica"] == 0
        again = request_over_tcp(server.address, {"query": "x", "request_id": "who are you who"})
        assert again["query"] == "who are you who"  # the recorded response, by id
        m = request_over_tcp(server.address, {"op": "metrics"})["metrics"]
        assert m["failovers"] == 1 and m["alive"] == [False, True] and m["dedup_hits"] == 1
    finally:
        server.shutdown()
        server.server_close()
        daemon.stop()
