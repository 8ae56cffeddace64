"""The port's ``ServingFrontend(device="cpu")`` against the reference's
frontend and its scalar Combiner, over the ``tests/strategies.py`` corpora,
plus the port's index build against the reference's.

Fragment lists and ranked documents must be identical; scores are float
sums over the same fragments in the same order (``rank_documents``), so
they agree within rtol 1e-9 (they are in fact equal).
"""

import numpy as np
import pytest

from repro.core.combiner import se24_combiner
from repro.core.keys import expand_subqueries as ref_expand
from repro.index import DocumentStore as RefDocumentStore
from repro.index import build_indexes as ref_build_indexes
from repro.search.frontend import SearchRequest as RefRequest
from repro.search.frontend import ServingFrontend as RefFrontend
from repro_torch.index import DocumentStore, build_indexes, index_set_from_arrays
from repro_torch.search import (
    SearchEngine,
    SearchRequest,
    ServingFrontend,
    ShardedSearchService,
    fused,
)
from tests.strategies import make_corpus, make_queries

PROBE = "to be who you are"
SEEDS = [3, 11, 2024]
FAMILIES = ("ordinary", "pair", "triple", "stop_single", "stop_pair")


def _index_sets_equal(a, b):
    """Every family, the NSW records and the FL-list, array for array."""
    assert (a.max_distance, a.n_docs) == (b.max_distance, b.n_docs)
    assert a.fl.lemmas == b.fl.lemmas and a.fl.frequency == b.fl.frequency
    assert (a.fl.sw_count, a.fl.fu_count) == (b.fl.sw_count, b.fl.fu_count)
    for name in FAMILIES:
        fa, fb = getattr(a, name), getattr(b, name)
        assert set(fa) == set(fb), name
        for key in fa:
            np.testing.assert_array_equal(fa[key], fb[key], err_msg=f"{name}[{key}]")
    assert set(a.nsw) == set(b.nsw)
    for key, rec in a.nsw.items():
        for field in ("offsets", "stop_lemma", "distance"):
            np.testing.assert_array_equal(getattr(rec, field), getattr(b.nsw[key], field))


def _build(seed):
    spec = make_corpus(seed)
    kw = dict(sw_count=spec.sw_count, fu_count=spec.fu_count, max_distance=spec.max_distance)
    ref_store = RefDocumentStore.from_texts(spec.texts)
    store = DocumentStore.from_texts(spec.texts)
    queries = make_queries(seed, spec) + [PROBE]
    return spec, ref_store, ref_build_indexes(ref_store, **kw), store, build_indexes(store, **kw), queries


@pytest.fixture(scope="module", params=SEEDS)
def corpus(request):
    return _build(request.param)


def _docs(resp):
    return [(d.doc_id, [(f.start, f.end) for f in d.fragments]) for d in resp.docs]


def test_build_indexes_equals_reference(corpus):
    _, _, ref_idx, _, idx, _ = corpus
    _index_sets_equal(idx, ref_idx)


def _from_fields(ix):
    return index_set_from_arrays(
        lemmas=ix.fl.lemmas, frequency=ix.fl.frequency, sw_count=ix.fl.sw_count,
        fu_count=ix.fl.fu_count, max_distance=ix.max_distance, n_docs=ix.n_docs,
        ordinary=ix.ordinary, pair=ix.pair, triple=ix.triple, stop_single=ix.stop_single,
        stop_pair=ix.stop_pair,
        nsw={l: (r.offsets, r.stop_lemma, r.distance) for l, r in ix.nsw.items()},
    )


def test_index_set_from_arrays_round_trips(corpus):
    _, _, ref_idx, _, idx, _ = corpus
    _index_sets_equal(_from_fields(ref_idx), idx)
    _index_sets_equal(_from_fields(idx), idx)


def test_frontend_equals_reference_frontend_and_combiner(corpus):
    _, ref_store, ref_idx, store, idx, queries = corpus
    top_k = 1000  # every matching document
    want = RefFrontend(ref_idx, lemmatizer=ref_store.lemmatizer).search_many(
        [RefRequest(q, top_k=top_k) for q in queries]
    )
    got = ServingFrontend(idx, lemmatizer=store.lemmatizer, device="cpu").search_many(
        [SearchRequest(q, top_k=top_k) for q in queries]
    )
    for q, g, w in zip(queries, got, want):
        assert g.query == w.query == q
        assert _docs(g) == _docs(w), q
        np.testing.assert_allclose([d.score for d in g.docs], [d.score for d in w.docs], rtol=1e-9)
        combiner = set()
        for sub in ref_expand(q, ref_store.lemmatizer):
            combiner.update(se24_combiner(sub, ref_idx)[0])
        assert {(d.doc_id, f.start, f.end) for d in g.docs for f in d.fragments} == {
            (r.doc_id, r.start, r.end) for r in combiner
        }, q
        assert g.stats.results == w.stats.results
        assert (g.stats.postings_read, g.stats.bytes_read) == (w.stats.postings_read, w.stats.bytes_read)


def test_arena_frontend_equals_reference_and_combiner(corpus):
    """``arena_budget_mb=64`` (the reference launcher's default budget):
    the same responses and §11 accounting as the reference's arena frontend,
    and the Combiner's fragments."""
    _, ref_store, ref_idx, store, idx, queries = corpus
    top_k = 1000
    ref_fe = RefFrontend(ref_idx, lemmatizer=ref_store.lemmatizer, arena_budget_mb=64)
    want = ref_fe.search_many([RefRequest(q, top_k=top_k) for q in queries])
    fe = ServingFrontend(idx, lemmatizer=store.lemmatizer, arena_budget_mb=64, device="cpu")
    got = fe.search_many([SearchRequest(q, top_k=top_k) for q in queries])
    for q, g, w in zip(queries, got, want):
        assert _docs(g) == _docs(w), q
        combiner = set()
        for sub in ref_expand(q, ref_store.lemmatizer):
            combiner.update(se24_combiner(sub, ref_idx)[0])
        assert {(d.doc_id, f.start, f.end) for d in g.docs for f in d.fragments} == {
            (r.doc_id, r.start, r.end) for r in combiner
        }, q
        for field in ("postings_read", "bytes_read", "arena_hits", "arena_misses", "device_dispatches"):
            assert getattr(g.stats, field) == getattr(w.stats, field), (q, field)
    assert fe.metrics()["arena_uploads"] == ref_fe.metrics()["arena_uploads"] > 0
    fe.close()
    assert fe.metrics()["arena_entries"] == 0


@pytest.mark.parametrize("use_kernel", [False, True])
def test_pipeline_on_off_identical_one_dispatch_per_chunk(corpus, use_kernel):
    _, _, _, store, idx, queries = corpus
    requests = [SearchRequest(q, top_k=16) for q in queries]
    out = {}
    for pipeline in (False, True):
        fe = ServingFrontend(idx, lemmatizer=store.lemmatizer, max_batch=2,
                             pipeline=pipeline, use_kernel=use_kernel, device="cpu")
        fused.reset_dispatch_count()
        out[pipeline] = fe.search_many(requests)
        chunks = [out[pipeline][lo : lo + 2] for lo in range(0, len(requests), 2)]
        # one fused program per micro-batch that has work (no list here is
        # long enough for a device intersect)
        assert fused.dispatch_count() == sum(
            any(r.stats.device_dispatches for r in c) for c in chunks
        )
        assert all(r.stats.device_dispatches <= 1 for r in out[pipeline])
    assert [_docs(r) for r in out[True]] == [_docs(r) for r in out[False]]
    assert [r.query for r in out[True]] == [r.query for r in requests]
    cached = fe.search_many(requests)
    assert all(r.stats.cache_hits == 1 for r in cached)


def test_engine_equals_frontend(corpus):
    _, _, _, store, idx, queries = corpus
    eng = SearchEngine(idx, lemmatizer=store.lemmatizer, algorithm="fused", device="cpu")
    fe = ServingFrontend(idx, lemmatizer=store.lemmatizer, device="cpu")
    assert [_docs(r) for r in eng.search_batch(queries, top_k=1000)] == [
        _docs(fe.search(q, top_k=1000)) for q in queries
    ]
    assert [_docs(eng.search_planned(eng.plan(q), top_k=1000)) for q in queries] == [
        _docs(r) for r in eng.search_batch(queries, top_k=1000)
    ]


def test_warmup_runs_the_serving_programs(corpus):
    _, _, _, store, idx, queries = corpus
    fe = ServingFrontend(idx, lemmatizer=store.lemmatizer, use_kernel=True, device="cpu")
    assert fe.warmup()["programs"] == 1
    assert fe.warmup(queries=queries[:2])["programs"] == 1
    assert fe.metrics()["result_cache_misses"] == 0  # the result cache is untouched


def test_sources_and_options_outside_the_slice_raise():
    _, _, _, store, idx, _ = _build(SEEDS[0])
    with pytest.raises(NotImplementedError, match="incremental/store/wal/checkpoint"):
        ServingFrontend(type("Ix", (), {"generation_token": 3})(), device="cpu")
    with pytest.raises(NotImplementedError, match="incremental/store/wal/checkpoint"):
        SearchEngine(type("Ix", (), {"generation_token": 3, "fl": idx.fl})(), device="cpu")
    with pytest.raises(NotImplementedError, match="incremental/store/wal/checkpoint"):
        ShardedSearchService(store, n_shards=2, sw_count=5, fu_count=5, incremental=True,
                             device="cpu")
    svc = ShardedSearchService(store, n_shards=2, sw_count=5, fu_count=5, device="cpu")
    with pytest.raises(NotImplementedError, match="resilience/service"):
        svc.search("who are you who", dead_shards=[1])
    with pytest.raises(KeyError):
        SearchEngine(idx, algorithm="se3", device="cpu")
