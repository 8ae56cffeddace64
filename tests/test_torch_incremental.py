"""The port's incremental index (``index/incremental.py``,
``index/fastbuild.py``) against the reference's, op sequence for op sequence,
and the port's engines, frontend and posting arena over an incremental
source that mutates between searches.

Every comparison is exact: views family by family and key by key, NSW
records, FL-lists, generation tokens and every ``commit()``/``compact()``
report dict.  Served fragment sets must equal the reference's scalar
Combiner over the same live view; scores are float sums over the same
fragments in the same order, compared with rtol 1e-9.
"""

import gc
import weakref

import numpy as np
import pytest

from repro.core.combiner import se24_combiner as ref_se24
from repro.core.keys import expand_subqueries as ref_expand
from repro.core.lemma import FLList as RefFLList
from repro.index import DocumentStore as RefDocumentStore
from repro.index import IncrementalIndexer as RefIncrementalIndexer
from repro.index import synthesize_corpus as ref_synthesize_corpus
from repro.index.builder import build_segment as ref_build_segment
from repro.index.fastbuild import _candidates as ref_candidates
from repro.index.fastbuild import build_segment_fast as ref_build_segment_fast
from repro.search.frontend import SearchRequest as RefRequest
from repro.search.frontend import ServingFrontend as RefFrontend
from repro_torch.core.keys import expand_subqueries, lemma_order_signature
from repro_torch.core.lemma import FLList, Lemmatizer
from repro_torch.index import (
    DocumentStore,
    IncrementalIndexer,
    build_indexes,
    generation_token,
    index_sets_equal,
    synthesize_corpus,
)
from repro_torch.index.builder import build_segment
from repro_torch.index.fastbuild import _candidates, build_segment_fast
from repro_torch.index.incremental import merge_posting_arrays
from repro_torch.search import SearchEngine, SearchRequest, ServingFrontend, ShardedSearchService
from repro_torch.search import planner
from repro_torch.search.arena import PostingArena
from repro_torch.search.vectorized import VectorizedEngine
from tests.strategies import make_corpus, make_op_sequence, make_queries

SW, FU, D = 40, 80, 5
FAMILIES = ("ordinary", "pair", "triple", "stop_single", "stop_pair")
OP_SEEDS = [3, 11, 2024, 77]
QUERIES = ["who are you who", "to be or not to be", "what do you do all day", "to be who you are"]

def _texts(n=24, seed=11):
    store = synthesize_corpus(n_docs=n, doc_len=50, vocab_size=250, seed=seed)
    return [d.text for d in store.documents]


def _assert_views_equal(a, b, ctx=""):
    """Two live views (either package, lazy or materialized), family by
    family and key by key, NSW records and FL-list included."""
    assert (a.max_distance, a.n_docs) == (b.max_distance, b.n_docs), ctx
    assert a.fl.lemmas == b.fl.lemmas and a.fl.frequency == b.fl.frequency, ctx
    assert (a.fl.sw_count, a.fl.fu_count) == (b.fl.sw_count, b.fl.fu_count), ctx
    for name in FAMILIES:
        fa, fb = getattr(a, name), getattr(b, name)
        assert set(fa) == set(fb), (ctx, name)
        for key in fa:
            ra, rb = fa[key], fb[key]
            assert ra.dtype == rb.dtype, (ctx, name, key)
            np.testing.assert_array_equal(ra, rb, err_msg=f"{ctx} {name}[{key}]")
    assert set(a.nsw) == set(b.nsw), ctx
    for key in a.nsw:
        for field in ("offsets", "stop_lemma", "distance"):
            np.testing.assert_array_equal(getattr(a.nsw[key], field), getattr(b.nsw[key], field))
    eq, why = index_sets_equal(a.to_index_set(), b.to_index_set())
    assert eq, f"{ctx}: {why}"


def _assert_equal_rebuild(ix, ctx=""):
    eq, why = index_sets_equal(ix.index.to_index_set(), ix.rebuild_index_set())
    assert eq, f"{ctx}: {why}"


# ---------------------------------------------------------------------------
# op sequences, run on both packages
# ---------------------------------------------------------------------------


def _run_ops(cls, spec, ops_seed):
    """The differential harness' randomized add/delete/commit/compact
    sequence; returns the indexer, every report and every token."""
    seq = make_op_sequence(ops_seed, spec)
    ix = cls(sw_count=spec.sw_count, fu_count=spec.fu_count, max_distance=spec.max_distance)
    rng = np.random.default_rng(ops_seed)
    live: list[int] = []
    reports, tokens = [], []
    for batch, step in zip(seq.batches, seq.ops):
        live += ix.add_documents(batch)
        reports.append(ix.commit())
        tokens.append(ix.generation_token)
        for op in step:
            if op[0] == "delete" and live:
                for _ in range(max(1, int(len(live) * op[1]))):
                    ix.delete_document(live.pop(int(rng.integers(len(live)))))
                tokens.append(ix.generation_token)
            elif op[0] == "compact":
                reports.append(ix.compact(memory_budget_bytes=op[1]))
                tokens.append(ix.generation_token)
    reports.append(ix.commit())
    reports.append(ix.compact())
    tokens.append(ix.generation_token)
    return ix, reports, tokens


@pytest.mark.parametrize("seed", OP_SEEDS)
def test_random_op_sequences_equal_reference(seed):
    spec = make_corpus(seed)
    ix, reports, tokens = _run_ops(IncrementalIndexer, spec, seed)
    ref, ref_reports, ref_tokens = _run_ops(RefIncrementalIndexer, spec, seed)
    assert reports == ref_reports
    assert tokens == ref_tokens
    _assert_views_equal(ix.index, ref.index, f"seed {seed}")
    _assert_equal_rebuild(ix, f"seed {seed}")


def _multi_batch(cls, fl_cls, texts, lem):
    ix = cls(sw_count=SW, fu_count=FU, max_distance=D, lemmatizer=lem)
    out = []
    for i in range(0, len(texts), 6):
        ix.add_documents(texts[i : i + 6])
        out.append(ix.commit())
    assert sum(r["rekeyed_docs"] for r in out) > 0  # Zipf growth moves classes
    return ix, out


def _delete_then_commit(cls, fl_cls, texts, lem):
    ix = cls(sw_count=SW, fu_count=FU, max_distance=D, lemmatizer=lem)
    ids = ix.add_documents(texts)
    out = [ix.commit()]
    ix.delete_document(ids[3])
    view = ix.index
    for name in FAMILIES:
        for key in getattr(view, name):
            assert ids[3] not in set(getattr(view, name)[key][:, 0].tolist())
    out.append(ix.commit())
    return ix, out


def _buffered_delete(cls, fl_cls, texts, lem):
    ix = cls(sw_count=SW, fu_count=FU, lemmatizer=lem)
    with pytest.raises(KeyError):
        ix.delete_document(99)
    ids = ix.add_documents(texts[:4])
    ix.delete_document(ids[0])  # still buffered: dropped, never indexed
    out = [ix.commit()]
    assert ids[0] not in ix.documents and ids[0] not in ix.tombstones
    return ix, out


def _budgeted_compact(cls, fl_cls, texts, lem):
    ix = cls(sw_count=SW, fu_count=FU, max_distance=D, lemmatizer=lem)
    for i in range(0, len(texts), 4):
        ix.add_documents(texts[i : i + 4])
        ix.commit()
    n_before = len(ix.segments)
    victims = sorted(ix.documents)[::5]
    for victim in victims:
        ix.delete_document(victim)
    total = sum(seg.live_bytes() for seg in ix.segments)
    out = [ix.compact(memory_budget_bytes=total // 2 + 1)]
    assert 1 < out[0]["segments"] < n_before and out[0]["collected"] == len(victims)
    out.append(ix.commit())
    out.append(ix.compact())
    assert len(ix.segments) == 1
    return ix, out


def _pinned_fl(cls, fl_cls, texts, lem):
    ix = cls(sw_count=SW, fu_count=FU, max_distance=D, lemmatizer=lem)
    ix.add_documents(texts[:12])
    out = [ix.commit()]
    pinned = ix.fl
    ix.add_documents(texts[12:])
    out.append(ix.commit(refresh_fl=False))
    assert out[-1]["rekeyed_docs"] == 0 and ix.fl is pinned
    return ix, out


def _class_flip(cls, fl_cls, texts, lem):
    ix = cls(sw_count=2, fu_count=2, max_distance=D)
    ix.add_documents(["alpha beta gamma"] * 3 + ["delta epsilon zeta"] * 3)
    out = [ix.commit()]
    ix.add_documents(["zeta " * 30])  # zeta climbs into the stop class
    out.append(ix.commit())
    assert 0 < out[-1]["rekeyed_docs"] < 7
    return ix, out


def _lemma_enters_fl(cls, fl_cls, texts, lem):
    fl0 = fl_cls.from_frequencies({"the": 100, "walk": 50}, sw_count=1, fu_count=1)
    ix = cls(sw_count=1, fu_count=1, max_distance=D)
    ix.add_documents(["walk qux zebra"])
    out = [ix.commit(fl=fl0)]
    fl1 = fl_cls.from_frequencies(
        {"the": 100, "walk": 50, "qux": 2, "zebra": 1}, sw_count=1, fu_count=1
    )
    out.append(ix.commit(fl=fl1))
    assert out[-1]["rekeyed_docs"] == 0, "signature-invariant doc was re-keyed"
    return ix, out


def _exact_rekey_set(cls, fl_cls, texts, lem):
    ix = cls(sw_count=SW, fu_count=FU, max_distance=D, lemmatizer=lem)
    ix.add_documents(texts[:16])
    out = [ix.commit()]
    old_fl = ix.fl
    ix.add_documents(texts[16:] + ["zeta " * 40])  # force drift
    new_fl = fl_cls.from_frequencies(ix.surviving_frequencies(), sw_count=SW, fu_count=FU)
    expected = sum(
        lemma_order_signature(ix._doc_lemmas[d], old_fl)
        != lemma_order_signature(ix._doc_lemmas[d], new_fl)
        for d in ix.documents
    )
    out.append(ix.commit(fl=new_fl))
    assert out[-1]["rekeyed_docs"] == expected and 0 < expected < len(ix.documents)
    return ix, out


SCENARIOS = {
    "multi-batch-fl-drift": _multi_batch,
    "delete-then-commit": _delete_then_commit,
    "buffered-delete": _buffered_delete,
    "budgeted-compact": _budgeted_compact,
    "pinned-fl": _pinned_fl,
    "class-flip": _class_flip,
    "lemma-enters-fl": _lemma_enters_fl,
    "exact-rekey-set": _exact_rekey_set,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_equals_reference_and_rebuild(name):
    texts = _texts()
    store, ref_store = DocumentStore.from_texts(texts), RefDocumentStore.from_texts(texts)
    ix, reports = SCENARIOS[name](IncrementalIndexer, FLList, texts, store.lemmatizer)
    ref, ref_reports = SCENARIOS[name](RefIncrementalIndexer, RefFLList, texts, ref_store.lemmatizer)
    assert reports == ref_reports
    assert ix.generation_token == ref.generation_token
    _assert_views_equal(ix.index, ref.index, name)
    if name in ("pinned-fl", "lemma-enters-fl"):
        rebuild = build_indexes(ix.surviving_store(), sw_count=ix.sw_count, fu_count=ix.fu_count,
                                max_distance=D, fl=ix.fl)
        eq, why = index_sets_equal(ix.index.to_index_set(), rebuild)
        assert eq, why
    else:
        _assert_equal_rebuild(ix, name)


def test_materialized_view_survives_fl_drift():
    """A ``to_index_set()`` snapshot may share arrays with segments; a
    later drift commit must not rewrite its NSW stop ids."""
    texts = _texts()
    ix = IncrementalIndexer(sw_count=SW, fu_count=FU, max_distance=D)
    ix.add_documents(texts[:10])
    ix.commit()
    snap = ix.index.to_index_set()
    payload = {l: r.stop_lemma.copy() for l, r in snap.nsw.items()}
    rebuild_old = build_indexes(ix.surviving_store(), sw_count=SW, fu_count=FU, max_distance=D)
    ix.add_documents(texts[10:])
    assert ix.commit()["drifted_lemmas"] > 0
    for l, before in payload.items():
        np.testing.assert_array_equal(snap.nsw[l].stop_lemma, before)
    eq, why = index_sets_equal(snap, rebuild_old)
    assert eq, why


def test_merge_posting_arrays_order():
    a = np.array([[0, 3], [2, 1]], dtype=np.int32)
    b = np.array([[1, 0], [1, 9], [3, 2]], dtype=np.int32)
    assert merge_posting_arrays([a, b], width=2).tolist() == [[0, 3], [1, 0], [1, 9], [2, 1], [3, 2]]


@pytest.mark.parametrize("seed", [3, 11, 2024])
def test_build_segment_fast_equals_scalar_and_reference(seed):
    spec = make_corpus(seed)
    store, ref_store = DocumentStore.from_texts(spec.texts), RefDocumentStore.from_texts(spec.texts)
    fl = FLList.from_frequencies(store.lemma_frequencies(), sw_count=spec.sw_count,
                                 fu_count=spec.fu_count)
    ref_fl = RefFLList.from_frequencies(ref_store.lemma_frequencies(), sw_count=spec.sw_count,
                                        fu_count=spec.fu_count)
    docs, ref_docs = list(store.documents), list(ref_store.documents)
    fast = build_segment_fast(docs, fl, max_distance=spec.max_distance)
    eq, why = index_sets_equal(fast, build_segment(docs, fl, max_distance=spec.max_distance))
    assert eq, why
    for builder in (ref_build_segment_fast, ref_build_segment):
        eq, why = index_sets_equal(fast, builder(ref_docs, ref_fl, max_distance=spec.max_distance))
        assert eq, why
    # the candidate generation bulk ingest will share, under its own name
    args = (spec.max_distance, True, True, None)
    _assert_same_tree(_candidates(docs, fl, *args), ref_candidates(ref_docs, ref_fl, *args))


def _assert_same_tree(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for key in a:
            _assert_same_tree(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_generation_token_lives_in_incremental_and_planner_reexports_it():
    assert planner.generation_token is generation_token
    ix = IncrementalIndexer(sw_count=5, fu_count=5)
    assert generation_token(ix) == 0 and generation_token(object()) == 0
    ix.add_documents(["who are you"])
    ix.commit()
    assert generation_token(ix) == 1


# ---------------------------------------------------------------------------
# serving over a source that mutates between searches
# ---------------------------------------------------------------------------


def _frags(resp):
    return {(d.doc_id, f.start, f.end) for d in resp.docs for f in d.fragments}


def _ref_union(ref_ix, query):
    out = set()
    view = ref_ix.index
    for sub in ref_expand(query, ref_ix.lemmatizer):
        out |= {(r.doc_id, r.start, r.end) for r in ref_se24(sub, view)[0]}
    return out


ROUTES = {
    "engine-se2.4": lambda ix: SearchEngine(ix, device="cpu"),
    "engine-fused": lambda ix: SearchEngine(ix, algorithm="fused", device="cpu"),
    "engine-fused-arena": lambda ix: SearchEngine(
        ix, algorithm="fused", arena=PostingArena(device="cpu"), device="cpu"),
    "engine-planned-arena": lambda ix: SearchEngine(
        ix, algorithm="fused", arena=PostingArena(device="cpu"), device="cpu"),
    "vectorized-arena": lambda ix: VectorizedEngine(ix, arena=PostingArena(device="cpu"), device="cpu"),
    "frontend-host": lambda ix: ServingFrontend(ix, device="cpu"),
    "frontend-arena": lambda ix: ServingFrontend(ix, arena_budget_mb=64, device="cpu"),
}


def _serve(name, obj, query):
    if name == "engine-planned-arena":
        return _frags(obj.search_planned(obj.plan(query), top_k=64))
    if name == "vectorized-arena":
        result, _ = obj.search_query_batch([expand_subqueries(query, Lemmatizer())])
        return {(r.doc_id, r.start, r.end) for r in result.per_query[0]}
    return _frags(obj.search(query, top_k=64))


@pytest.mark.parametrize("route", list(ROUTES))
def test_one_engine_sees_a_commit_made_between_two_searches(route):
    """The engine is built once over the indexer; the second search must
    see the commit (and the third the delete), not the view the engine
    first resolved, on the host route and on the arena route."""
    ix = IncrementalIndexer(sw_count=10, fu_count=5, max_distance=5)
    ix.add_documents(["who are you is the album by the who"])
    ix.commit()
    engine = ROUTES[route](ix)
    query = "who are you"

    def fresh():  # a new engine over the view as it stands now
        return _frags(SearchEngine(ix.index.to_index_set(), device="cpu").search(query, top_k=64))

    first = _serve(route, engine, query)
    assert {d for d, _, _ in first} == {0} and first == fresh()
    ix.add_documents(["who are you who said the caterpillar"])
    assert _serve(route, engine, query) == first  # buffered, not committed
    ix.commit()
    second = _serve(route, engine, query)
    assert {d for d, _, _ in second} == {0, 1} and second == fresh()
    ix.delete_document(0)
    third = _serve(route, engine, query)
    assert {d for d, _, _ in third} == {1} and third == fresh()


@pytest.mark.parametrize("arena", [False, True], ids=["host", "arena"])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_frontend_over_a_mutating_indexer_equals_reference(arena, use_kernel):
    """Slates between commits, deletes and a compaction: fragments equal the
    reference's scalar Combiner over its own indexer driven through the
    same ops, and the attached arena evicts exactly as the reference's."""
    spec = make_corpus(11)
    queries = make_queries(11, spec) + QUERIES
    texts = list(spec.texts) + ["who are you who to be or not to be"] * 2
    kw = dict(sw_count=spec.sw_count, fu_count=spec.fu_count, max_distance=spec.max_distance)
    ix, ref = IncrementalIndexer(**kw), RefIncrementalIndexer(**kw)
    budget = dict(arena_budget_mb=64) if arena else {}
    half = len(texts) // 2
    for x in (ix, ref):
        x.add_documents(texts[:half])
        x.commit()
    fe = ServingFrontend(ix, use_kernel=use_kernel, device="cpu", **budget)
    ref_fe = RefFrontend(ref, **budget)

    def slate(tag):
        got = fe.search_many([SearchRequest(q, top_k=64) for q in queries])
        want = ref_fe.search_many([RefRequest(q, top_k=64) for q in queries])
        for q, g, w in zip(queries, got, want):
            assert _frags(g) == _ref_union(ref, q) == _frags(w), (tag, q)
            np.testing.assert_allclose([d.score for d in g.docs], [d.score for d in w.docs], rtol=1e-9)
        if arena:
            m, rm = fe.arena.metrics(), ref_fe.arena.metrics()
            for k in ("arena_evictions", "arena_uploads", "arena_hits", "arena_misses", "arena_bytes"):
                assert m[k] == rm[k], (tag, k)

    slate("first")
    for x in (ix, ref):
        x.add_documents(texts[half:])
        x.commit()
    slate("post-commit")
    for x in (ix, ref):
        x.delete_document(sorted(x.documents)[2])
    slate("post-delete")
    for x in (ix, ref):
        x.compact()
    slate("post-compact")
    assert fe.metrics()["result_cache_misses"] == ref_fe.metrics()["result_cache_misses"]
    if arena:
        assert fe.arena.evictions > 0
    fe.close()
    assert not ix._listeners


def test_attached_arena_drops_its_last_reference_to_evicted_buffers():
    """On a card an eviction must lower ``torch.cuda.memory_allocated()``:
    no object but the arena may hold an evicted family buffer.  Here the
    same is shown by reference counting: after a commit every buffer of the
    stale generation is garbage once the arena has evicted it."""
    ix = IncrementalIndexer(sw_count=10, fu_count=20, max_distance=5)
    ix.add_documents(_texts(n=12))
    ix.commit()
    fe = ServingFrontend(ix, arena_budget_mb=64, device="cpu")
    fe.search_many(QUERIES)
    stale = [weakref.ref(fb.buf) for fb in fe.arena._entries.values()]
    assert stale and fe.arena.evictions == 0
    ix.add_documents(["who are you who"])
    ix.commit()
    assert fe.arena.evictions == len(stale) and len(fe.arena) == 0
    gc.collect()
    assert all(r() is None for r in stale), "an evicted buffer is still referenced"
    fe.search_many(QUERIES)  # the new generation uploads again
    assert fe.arena.uploads == 2 * len(stale)
    fe.close()


def test_arena_attach_subscribes_and_detach_unsubscribes():
    ix = IncrementalIndexer(sw_count=10, fu_count=20)
    ix.add_documents(["who are you who"])
    ix.commit()
    arena = PostingArena(device="cpu")
    arena.attach(ix)
    assert len(ix._listeners) == 1
    arena.detach()
    arena.detach()  # idempotent
    assert not ix._listeners


def test_sharded_incremental_service_matches_static_and_reference():
    store = ref_synthesize_corpus(n_docs=40, doc_len=60, vocab_size=300, seed=7)
    texts = [d.text for d in store.documents]
    kw = dict(n_shards=3, sw_count=30, fu_count=60)
    port_store = DocumentStore.from_texts(texts[:30])
    svc = ShardedSearchService(port_store, **kw, incremental=True, device="cpu")
    from repro.search.distributed import ShardedSearchService as RefService

    ref = RefService(RefDocumentStore.from_texts(texts[:30]), **kw, incremental=True)
    static = ShardedSearchService(port_store, **kw, device="cpu")
    for a, b in zip(svc.shards, static.shards):
        eq, why = index_sets_equal(a.to_index_set(), b)
        assert eq, why
    for s in (svc, ref):
        s.add_documents(texts[30:])
        s.delete_document(5)
    assert svc.commit() == ref.commit()
    assert svc.compact(memory_budget_bytes=100_000) == ref.compact(memory_budget_bytes=100_000)
    assert svc.generation_token == ref.generation_token
    for a, b in zip(svc.shards, ref.shards):
        _assert_views_equal(a, b, "shard")
    survivors = DocumentStore.from_texts(texts).subset([i for i in range(len(texts)) if i != 5])
    rebuilt = ShardedSearchService(survivors, **kw, device="cpu")
    fused = ShardedSearchService.__new__(ShardedSearchService)
    fused.__dict__.update(svc.__dict__, algorithm="fused")
    for query in QUERIES:
        want = _frags(rebuilt.search(query, top_k=16))
        assert _frags(svc.search(query, top_k=16)) == want == _frags(ref.search(query, top_k=16))
        assert _frags(fused.search(query, top_k=16)) == want
    with pytest.raises(RuntimeError):
        static.add_documents(["nope"])


def test_attached_arena_over_shards_evicts_as_the_reference():
    """Eviction compares token values across shards, in the reference too:
    after shard tokens diverge, a shard whose stale token equals another
    shard's live token keeps its entries until LRU.  The port evicts the
    same entries (ROADMAP.md §C records the reference's fault)."""
    from repro.search.distributed import ShardedSearchService as RefService

    texts = _texts(n=30)
    kw = dict(n_shards=2, sw_count=20, fu_count=40, incremental=True)
    svc = ShardedSearchService(DocumentStore.from_texts(texts), **kw, device="cpu")
    ref = RefService(RefDocumentStore.from_texts(texts), **kw)
    fe = ServingFrontend(svc, arena_budget_mb=64, device="cpu")
    ref_fe = RefFrontend(ref, arena_budget_mb=64)
    for s in (svc, ref):
        for doc_id in (1, 2, 7):  # shard 1 deletes twice, shard 0 once
            s.delete_document(doc_id)
        s.commit()
    assert svc.generation_token == ref.generation_token == (3, 4)
    for f in (fe, ref_fe):
        f.search_many(QUERIES)
    entries = len(fe.arena)
    for s in (svc, ref):
        s.add_documents(["who are you who"])
        s.commit()
    m, rm = fe.arena.metrics(), ref_fe.arena.metrics()
    assert m["arena_evictions"] == rm["arena_evictions"] and m["arena_bytes"] == rm["arena_bytes"]
    assert 0 < m["arena_evictions"] < entries  # shard 1's token-4 entries stay
