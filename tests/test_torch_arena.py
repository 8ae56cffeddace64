"""The port's device-resident posting arena (``repro_torch.search.arena``)
against the reference's (``repro.search.arena``, jax on the CPU, the Pallas
gather in interpret mode), on the same indexes.

Uploads, descriptor plans and every integer output of the arena program
must be equal bit for bit; float32 scores are summed in the reference's own
order, so they are held to rtol 1e-6 and the ranked rows behind them must
be equal.  Served fragment sets must equal the reference's, the port's host
route and the reference's scalar Combiner under full, partial (mixed),
overflow and shared-arena residency.  The doc-id spaces that select the
``argsort`` tier and ``ArenaOverflow`` come from the reference's
incremental indexer with explicit doc ids, carried into the port with
``index_set_from_arrays``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.combiner import se24_combiner
from repro.core.keys import expand_subqueries as ref_expand
from repro.core.keys import select_keys as ref_select_keys
from repro.core.postings import QueryStats as RefStats
from repro.index import build_indexes as ref_build_indexes
from repro.index import synthesize_corpus as ref_synthesize
from repro.index.incremental import IncrementalIndexer
from repro.search import arena as ref_arena
from repro.search import fused as ref_fused
from repro.search.frontend import SearchRequest as RefRequest
from repro.search.frontend import ServingFrontend as RefFrontend
from repro_torch.core.keys import Subquery, expand_subqueries, select_keys
from repro_torch.core.postings import QueryStats
from repro_torch.index import build_indexes, index_set_from_arrays, synthesize_corpus
from repro_torch.search import SearchEngine, SearchRequest, ServingFrontend, arena, fused

QUERIES = [
    "who are you who",
    "to be or not to be",
    "what do you do all day",
    "the time of war",
    "i need you",
    "time and time again",
]
SCORE_RTOL = 1e-6  # the reference's float32 summation order is repeated
CPU = torch.device("cpu")
FAMILIES = ("stop_single", "stop_pair", "pair", "triple")


def _port_index(ix):
    """A reference ``IndexSet`` carried into the port."""
    return index_set_from_arrays(
        lemmas=ix.fl.lemmas, frequency=ix.fl.frequency, sw_count=ix.fl.sw_count,
        fu_count=ix.fl.fu_count, max_distance=ix.max_distance, n_docs=ix.n_docs,
        ordinary=ix.ordinary, pair=ix.pair, triple=ix.triple, stop_single=ix.stop_single,
        stop_pair=ix.stop_pair,
        nsw={l: (r.offsets, r.stop_lemma, r.distance) for l, r in ix.nsw.items()},
    )


def _wide_index(lemmatizer, texts, doc_ids):
    """The reference's incremental index over ``texts`` under explicit
    (wide) doc ids, flattened to a plain ``IndexSet``."""
    ix = IncrementalIndexer(sw_count=60, fu_count=120, max_distance=5, lemmatizer=lemmatizer)
    ix.add_documents(texts, doc_ids=doc_ids)
    ix.commit()
    return ix.index.to_index_set()


@pytest.fixture(scope="module")
def corpora():
    kw = dict(n_docs=60, doc_len=120, vocab_size=500, seed=7)
    ref_store, store = ref_synthesize(**kw), synthesize_corpus(**kw)
    ref_small = ref_build_indexes(ref_store, sw_count=60, fu_count=120, max_distance=5)
    small = build_indexes(store, sw_count=60, fu_count=120, max_distance=5)
    # 17-bit doc ids: too wide for one fused sort, narrow enough for argsort
    texts = [d.text for d in ref_store.documents[:12]]
    ref_wide = _wide_index(ref_store.lemmatizer, texts, [3 + 11_000 * i for i in range(12)])
    # 29-bit doc ids: no int32 composite holds them
    ref_over = _wide_index(
        ref_store.lemmatizer,
        ["who are you who and what do you do", "to be or not to be"] + texts[:2],
        [7, 2**28, 11, 12],
    )
    return {
        "lemmatizers": (ref_store.lemmatizer, store.lemmatizer),
        "pack32": (ref_small, small),
        "argsort": (ref_wide, _port_index(ref_wide)),
        "overflow": (ref_over, _port_index(ref_over)),
    }


def _work(corpora, name, queries=QUERIES):
    ref_lem, lem = corpora["lemmatizers"]
    ref_idx, idx = corpora[name]
    return (
        [[(s, ref_idx) for s in ref_expand(q, ref_lem)] for q in queries],
        [[(s, idx) for s in expand_subqueries(q, lem)] for q in queries],
    )


def _arena_items(work, res, select):
    """The work items ``serve_query_batch`` sends to the arena program."""
    items = []
    for qi, its in enumerate(work):
        for sub, view in its:
            keys = select(sub, view.fl)
            exts = [res.lookup(k.components) for k in keys]
            if not keys or any(e is None for e in exts):
                continue
            if all(e.n_rows == 0 for e in exts) or (len(keys) >= 2 and any(e.n_rows == 0 for e in exts)):
                continue
            items.append((qi, sub, keys, exts, res))
    return items


def _items(corpora, name):
    ref_work, work = _work(corpora, name)
    ref_idx, idx = corpora[name]
    ref_res = ref_arena.PostingArena().acquire(ref_idx, 0)
    res = arena.PostingArena(device="cpu").acquire(idx, 0)
    return _arena_items(ref_work, ref_res, ref_select_keys), _arena_items(work, res, select_keys)


def _plans(corpora, name):
    ref_items, items = _items(corpora, name)
    return (
        ref_arena.plan_arena_batch(ref_items, n_queries=len(QUERIES)),
        arena.plan_arena_batch(items, n_queries=len(QUERIES)),
    )


# ---------------------------------------------------------------------------
# (a) uploads: family buffers and key extents
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["pack32", "argsort"])
def test_acquire_uploads_equal_reference(corpora, name):
    ref_idx, idx = corpora[name]
    ref_res = ref_arena.PostingArena().acquire(ref_idx, 0)
    res = arena.PostingArena(device="cpu").acquire(idx, 0)
    assert set(res.families) == set(ref_res.families) == set(FAMILIES)
    for fname in FAMILIES:
        want, got = ref_res.families[fname], res.families[fname]
        assert got.buf.dtype == torch.int32 and got.buf.device == CPU
        np.testing.assert_array_equal(got.buf.numpy(), np.asarray(want.buf), err_msg=fname)
        assert got.nbytes == want.nbytes
        assert got.extents == want.extents, fname
    for key in [("zzz",), ("zzz", "qqq"), ("a", "b", "c")]:
        assert res.lookup(key) == ref_res.lookup(key)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_family_uploads_equal_reference_on_edge_rows(seed):
    """The upload's one sort a slot over the whole family against the
    reference's key-by-key ``np.unique``: keys with no rows (first, last
    and between), rows repeating a (doc, pos) event within a slot, events
    shared by two slots, single-row keys, streams longer than a block and
    a family with no key at all; buffers and extents equal."""
    import types

    from repro.index.builder import POSTING_WIDTH

    rng = np.random.default_rng(seed)
    views = {}
    for fname in FAMILIES:
        width = POSTING_WIDTH[fname]
        mapping = {}
        for i in range(int(rng.integers(0, 40))):
            n = int(rng.choice([0, 1, 3, 150, 400]))
            doc = np.sort(rng.integers(0, 6, n))
            cols = [doc, rng.integers(0, 40, n)] + [rng.integers(-3, 4, n) for _ in range(width - 2)]
            a = np.stack(cols, axis=1).astype(np.int32) if n else np.empty((0, width), np.int32)
            if n > 2:
                a[1] = a[0]  # a repeated event
            mapping[tuple(f"k{i}_{j}" for j in range(width - 1))] = a
        views[fname] = mapping
    view = types.SimpleNamespace(**views)
    ref, port = ref_arena.PostingArena(), arena.PostingArena(device="cpu")
    for fname in FAMILIES:
        want, got = ref._upload_family(view, fname), port._upload_family(view, fname)
        np.testing.assert_array_equal(got.buf.numpy(), np.asarray(want.buf), err_msg=fname)
        assert got.nbytes == want.nbytes and got.extents == want.extents, fname
        assert all(type(v) is int for e in got.extents.values() for v in (e.n_rows, e.n_docs, e.max_doc))


# ---------------------------------------------------------------------------
# (b) descriptor plans, budgets and tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["pack32", "argsort"])
def test_plan_arena_batch_equals_reference(corpora, name):
    ref_plan, plan = _plans(corpora, name)
    assert plan.tier == ref_plan.tier == name
    for field in ("families", "e_budget", "n_queries", "query_budget", "n_budget", "row_budget",
                  "lemma_budget", "key_budget", "doc_bits", "block", "n_events"):
        assert getattr(plan, field) == getattr(ref_plan, field), field
    for field in ("n_keys", "mult", "seg_query"):
        np.testing.assert_array_equal(getattr(plan, field), getattr(ref_plan, field), err_msg=field)
    for field in ("src", "nv", "blk_meta", "d_src", "d_n", "d_dest", "d_meta"):
        assert len(getattr(plan, field)) == len(plan.families)
        for got, want in zip(getattr(plan, field), getattr(ref_plan, field)):
            np.testing.assert_array_equal(got, want, err_msg=field)
    for got, want in zip(plan.buffers, ref_plan.buffers):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plan_overflow_and_empty(corpora):
    ref_items, items = _items(corpora, "overflow")
    assert items
    with pytest.raises(ref_arena.ArenaOverflow, match="row-group bits"):
        ref_arena.plan_arena_batch(ref_items, n_queries=len(QUERIES))
    with pytest.raises(arena.ArenaOverflow, match="row-group bits"):
        arena.plan_arena_batch(items, n_queries=len(QUERIES))
    assert arena.plan_arena_batch([], n_queries=1) is None


# ---------------------------------------------------------------------------
# (c) the arena device program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", ["pack32", "argsort"])
def test_arena_serve_batch_equals_reference(corpora, name, use_kernel):
    ref_plan, plan = _plans(corpora, name)
    kw = dict(max_distance=5, top_k=16, use_kernel=use_kernel)
    ref_args, ref_h2d = ref_arena._device_args(ref_plan, use_kernel)
    want = ref_arena.arena_serve_batch(*ref_args, **ref_arena._static_kwargs(ref_plan, interpret=True, **kw))
    want = {k: np.asarray(v) for k, v in want.items()}
    args, h2d = arena._device_args(plan, use_kernel, CPU)
    got = {k: v.numpy() for k, v in arena.arena_serve_batch(*args, **arena._static_kwargs(plan, **kw)).items()}
    assert h2d == ref_h2d
    assert want["emit"].any()
    for key in ("res", "emit", "start", "comp", "row_doc", "row_query", "top_docs", "n_fragments"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["top_scores"], want["top_scores"], rtol=SCORE_RTOL)


@pytest.mark.parametrize("n", [1, 5, 16, 100, 1000, 4096])
@pytest.mark.parametrize("right", [False, True])
def test_binary_search_equals_reference(n, right):
    """Sorted int32 streams ending in the int32 sentinel, as the program
    searches them (pow2 and other lengths, duplicates)."""
    rng = np.random.default_rng(n)
    a = np.sort(rng.integers(0, 50, n)).astype(np.int32)
    a[-max(1, n // 8):] = np.iinfo(np.int32).max
    v = rng.integers(-2, 60, (7, 3)).astype(np.int32)
    want = np.asarray(ref_arena._binary_search(ref_arena.jnp.asarray(a), ref_arena.jnp.asarray(v), right))
    got = arena._binary_search(torch.from_numpy(a), torch.from_numpy(v), right)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_float_prefix_sums_in_reference_order():
    """The scores' prefix sums repeat the reference's float32 summation
    order bit for bit, across chunk boundaries."""
    rng = np.random.default_rng(5)
    for n in (1, 16, 17, 255, 4097, 70000):
        x = np.where(rng.random(n) < 0.5, 1 / rng.integers(1, 12, n) ** 2, 0).astype(np.float32)
        want = np.asarray(ref_arena.jnp.cumsum(ref_arena.jnp.asarray(x)))
        np.testing.assert_array_equal(arena._cumsum_f32(torch.from_numpy(x)).numpy(), want)


# ---------------------------------------------------------------------------
# (d) routing: serve_query_batch with residencies
# ---------------------------------------------------------------------------


def _sets(result):
    return [set(p) for p in result.per_query]


def _combiner(ref_work):
    out = []
    for items in ref_work:
        frags = set()
        for sub, idx in items:
            frags.update(se24_combiner(sub, idx)[0])
        out.append(frags)
    return out


def _residencies(corpora, name, budget=1 << 30):
    ref_idx, idx = corpora[name]
    return (
        {id(ref_idx): ref_arena.PostingArena(budget_bytes=budget).acquire(ref_idx, 0)},
        {id(idx): arena.PostingArena(budget_bytes=budget, device="cpu").acquire(idx, 0)},
    )


def _partial_budget(corpora):
    """Room for every family but the largest (the slate's triples)."""
    full = arena.PostingArena(device="cpu")
    full.acquire(corpora["pack32"][1], 0)
    return sum(sorted(fb.nbytes for fb in full._entries.values())[:3]) + 1


def _serve_both(corpora, name, budget=1 << 30, queries=QUERIES, **kw):
    ref_work, work = _work(corpora, name, queries)
    ref_res, res = _residencies(corpora, name, budget)
    ref_stats, stats = [RefStats() for _ in queries], [QueryStats() for _ in queries]
    ref_batch, batch = RefStats(), QueryStats()
    ref_fused.reset_dispatch_count()
    want = ref_fused.serve_query_batch(ref_work, max_distance=5, residencies=ref_res,
                                       stats=ref_stats, batch_stats=ref_batch, **kw)
    ref_dispatches = ref_fused.dispatch_count()
    fused.reset_dispatch_count()
    got = fused.serve_query_batch(work, max_distance=5, residencies=res, stats=stats,
                                  batch_stats=batch, device="cpu", **kw)
    assert fused.dispatch_count() == ref_dispatches
    if kw.get("defer"):
        want, got = want.result(), got.result()
    host = fused.serve_query_batch(work, max_distance=5, device="cpu")
    assert _sets(got) == _sets(want) == _sets(host) == _combiner(ref_work)
    np.testing.assert_array_equal(got.n_fragments, want.n_fragments)
    np.testing.assert_allclose(got.top_scores, want.top_scores, rtol=SCORE_RTOL)
    fields = ("postings_read", "bytes_read", "arena_hits", "arena_misses", "empty_subqueries")
    for g, w in zip(stats, ref_stats):
        assert [getattr(g, f) for f in fields] == [getattr(w, f) for f in fields]
    assert (batch.device_dispatches, batch.h2d_bytes) == (ref_batch.device_dispatches, ref_batch.h2d_bytes)
    return ref_dispatches, stats


@pytest.mark.parametrize("readout", ["device", "host"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", ["pack32", "argsort"])
def test_fully_resident_batch_is_one_arena_dispatch(corpora, name, use_kernel, readout):
    dispatches, stats = _serve_both(corpora, name, use_kernel=use_kernel, readout=readout)
    assert dispatches == 1
    assert sum(s.arena_hits for s in stats) > 0 and sum(s.arena_misses for s in stats) == 0


def test_budget_forced_partial_residency_is_mixed(corpora):
    # one- and two-word stop queries read the resident stop families, the
    # slate's (f,s,t) keys the non-resident triple family
    queries = QUERIES + ["who", "you who", "to be"]
    dispatches, stats = _serve_both(corpora, "pack32", budget=_partial_budget(corpora), queries=queries)
    assert dispatches == 2, "a mixed batch runs the arena and the host program"
    assert sum(s.arena_hits for s in stats) > 0 and sum(s.arena_misses for s in stats) > 0


def test_overflow_falls_back_and_charges_once(corpora):
    _, stats = _serve_both(corpora, "overflow")
    _, work = _work(corpora, "overflow")
    host_stats = [QueryStats() for _ in QUERIES]
    fused.serve_query_batch(work, max_distance=5, stats=host_stats, device="cpu")
    assert [s.postings_read for s in stats] == [s.postings_read for s in host_stats]
    assert sum(s.arena_misses for s in stats) > 0


def test_deferred_arena_batch(corpora):
    dispatches, _ = _serve_both(corpora, "pack32", defer=True)
    assert dispatches == 1


def test_empty_subquery_short_circuits(corpora):
    _, idx = corpora["pack32"]
    res = {id(idx): arena.PostingArena(device="cpu").acquire(idx, 0)}
    stats = QueryStats()
    fused.reset_dispatch_count()
    got = fused.serve_query_batch([[(Subquery(("zzzunknown", "qqqmissing")), idx)]],
                                  max_distance=5, residencies=res, stats=stats, device="cpu")
    assert got.per_query == [[]] and fused.dispatch_count() == 0
    assert stats.empty_subqueries == 1


def test_shared_arena_keeps_sources_apart(corpora):
    """Two plain indexes (both token 0) in one arena: each view's queries
    are served from its own buffers."""
    ref_lem, lem = corpora["lemmatizers"]
    shared = arena.PostingArena(device="cpu")
    pairs = [corpora["pack32"], corpora["argsort"]]
    res = [{id(idx): shared.acquire(idx, 0)} for _, idx in pairs]
    assert len(shared) == 8 and shared.metrics()["arena_uploads"] == 8
    for (ref_idx, idx), r in zip(pairs, res):
        for q in QUERIES[:3]:
            for ref_sub, sub in zip(ref_expand(q, ref_lem), expand_subqueries(q, lem)):
                got = fused.serve_query_batch([[(sub, idx)]], max_distance=5, residencies=r, device="cpu")
                assert set(got.per_query[0]) == set(se24_combiner(ref_sub, ref_idx)[0]), q


# ---------------------------------------------------------------------------
# (e) arena counters
# ---------------------------------------------------------------------------


def test_arena_metrics_equal_reference_after_the_same_acquires(corpora):
    # fresh view objects: no identity stamp from an earlier arena
    (ref_a, a), (ref_b, b) = (
        tuple(dataclasses.replace(v) for v in corpora[name]) for name in ("pack32", "argsort")
    )
    budget = _partial_budget(corpora)
    ref_pa = ref_arena.PostingArena(budget_bytes=budget)
    pa = arena.PostingArena(budget_bytes=budget, device="cpu")
    for ref_view, view, token in ((ref_a, a, 0), (ref_a, a, 0), (ref_b, b, 0), (ref_a, a, 1)):
        ref_r = ref_pa.acquire(ref_view, token)
        r = pa.acquire(view, token)
        assert set(r.families) == set(ref_r.families)
        assert pa.metrics() == ref_pa.metrics()
    assert pa.metrics()["arena_evictions"] > 0
    pa.release()
    ref_pa.release()
    assert pa.metrics() == ref_pa.metrics() and len(pa) == 0


def test_view_identities_are_unique_across_arenas(corpora):
    """Views first stamped by two different arenas keep apart in a third,
    shared one (each arena numbering its own views would give both the
    same identity there)."""
    a, b = (dataclasses.replace(corpora[name][1]) for name in ("pack32", "argsort"))
    arena.PostingArena(device="cpu").acquire(a, 0)
    arena.PostingArena(device="cpu").acquire(b, 0)
    shared = arena.PostingArena(device="cpu")
    ra, rb = shared.acquire(a, 0), shared.acquire(b, 0)
    assert shared.metrics()["arena_uploads"] == 8 and shared.metrics()["arena_hits"] == 0
    assert not torch.equal(ra.buffer("triple"), rb.buffer("triple"))


def test_unported_arena_hooks_raise(corpora):
    """Every hook of the reference arena's is ported: attaching a plain
    ``IndexSet`` is a no-op, an incremental indexer is subscribed to and
    unsubscribed from, and an injected ``arena.acquire`` overflow refuses
    one round (empty residencies, counted) as the reference's does."""
    from repro_torch.index import IncrementalIndexer

    _, idx = corpora["pack32"]
    pa = arena.PostingArena(device="cpu")
    pa.attach(idx)  # a plain IndexSet never mutates: a no-op
    pa.detach()
    ix = IncrementalIndexer(sw_count=5, fu_count=5)
    pa.attach(ix)
    assert len(ix._listeners) == 1
    pa.detach()
    assert not ix._listeners
    from repro_torch.search.resilience import FaultEvent, FaultInjector

    pa.injector = FaultInjector([FaultEvent("arena.acquire", "overflow", at_call=0)])
    refused, resident = pa.acquire(idx, 0), pa.acquire(idx, 0)
    assert not refused.families and resident.families
    assert pa.pressure_events == pa.metrics()["arena_pressure_events"] == 1


# ---------------------------------------------------------------------------
# (f) frontend and engine
# ---------------------------------------------------------------------------


def _docs(resp):
    return [(d.doc_id, [(f.start, f.end) for f in d.fragments]) for d in resp.docs]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_frontend_arena_equals_reference_and_host_route(corpora, use_kernel):
    ref_lem, lem = corpora["lemmatizers"]
    ref_idx, idx = corpora["pack32"]
    top_k = 1000
    ref_fe = RefFrontend(ref_idx, lemmatizer=ref_lem, arena_budget_mb=64, use_kernel=use_kernel)
    want = ref_fe.search_many([RefRequest(q, top_k=top_k) for q in QUERIES])
    fe = ServingFrontend(idx, lemmatizer=lem, arena_budget_mb=64, use_kernel=use_kernel, device="cpu")
    got = fe.search_many([SearchRequest(q, top_k=top_k) for q in QUERIES])
    host = ServingFrontend(idx, lemmatizer=lem, device="cpu").search_many(
        [SearchRequest(q, top_k=top_k) for q in QUERIES])
    for g, w, h in zip(got, want, host):
        assert _docs(g) == _docs(w) == _docs(h)
        np.testing.assert_allclose([d.score for d in g.docs], [d.score for d in w.docs], rtol=1e-9)
        assert (g.stats.arena_hits, g.stats.arena_misses) == (w.stats.arena_hits, w.stats.arena_misses)
        assert (g.stats.postings_read, g.stats.bytes_read) == (w.stats.postings_read, w.stats.bytes_read)
    arena_keys = [k for k in ref_fe.metrics() if k.startswith("arena_")]
    assert {k: fe.metrics()[k] for k in arena_keys} == {k: ref_fe.metrics()[k] for k in arena_keys}
    assert fe.arena.device == CPU and fe.metrics()["arena_hits"] == 0  # one cold acquire
    # a fully cache-served slate acquires nothing
    fe.search_many([SearchRequest(q, top_k=top_k) for q in QUERIES])
    assert fe.metrics()["arena_misses"] == ref_fe.metrics()["arena_misses"]
    fe.close()
    assert len(fe.arena) == 0 and fe.metrics()["arena_evictions"] == 4


def test_frontends_share_one_arena_and_warmup_uses_it(corpora):
    _, lem = corpora["lemmatizers"]
    _, idx = corpora["pack32"]
    shared = arena.PostingArena(budget_bytes=64 << 20, device="cpu")
    first = ServingFrontend(idx, lemmatizer=lem, arena=shared, device="cpu")
    assert first.warmup(queries=QUERIES[:2])["programs"] == 1
    uploads = shared.metrics()["arena_uploads"]
    for _ in range(2):
        fe = ServingFrontend(idx, lemmatizer=lem, arena=shared, device="cpu")
        resps = fe.search_many(QUERIES)
        assert sum(r.stats.arena_hits for r in resps) > 0
        fe.close()  # a shared arena is its owner's to release
    assert shared.metrics()["arena_uploads"] == uploads and len(shared) == 4


def test_engine_arena_equals_host_route(corpora):
    _, lem = corpora["lemmatizers"]
    _, idx = corpora["pack32"]
    eng = SearchEngine(idx, lemmatizer=lem, algorithm="fused",
                       arena=arena.PostingArena(device="cpu"), device="cpu")
    host = SearchEngine(idx, lemmatizer=lem, algorithm="fused", device="cpu")
    fused.reset_dispatch_count()
    got = eng.search_batch(QUERIES, top_k=1000)
    assert fused.dispatch_count() == 1
    assert all(r.stats.arena_hits > 0 for r in got if r.stats.results)
    assert [_docs(r) for r in got] == [_docs(r) for r in host.search_batch(QUERIES, top_k=1000)]
    assert [_docs(eng.search_planned(eng.plan(q), top_k=1000)) for q in QUERIES] == [_docs(r) for r in got]
