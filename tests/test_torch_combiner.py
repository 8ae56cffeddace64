"""The port's host algorithms — the scalar §10 Combiner ``se24_combiner``,
the baselines SE1 and SE2.1-SE2.3, their oracle and ``KeyIterator`` —
against the reference's, over the ``tests/strategies.py`` corpora, plus the
paper's worked examples.

Both packages get the same texts; fragment lists (in the order each
algorithm emits them) and the §11 counters must be identical on these
corpora, and
``SearchEngine`` with each host algorithm must rank the same documents with
the same scores (float sums over the same fragments in the same order:
rtol 1e-9, in fact equal).  The port's Combiner gates Step 2 wider than
the reference's (ROADMAP §C): on the random corpora of the reference's own
tests it returns fragments the reference misses, and its counts differ
there; those inputs are pinned at the end.
"""

import numpy as np
import pytest

from repro.core.combiner import CombinerState as RefCombinerState
from repro.core.keys import expand_subqueries as ref_expand
from repro.core.keys import select_keys as ref_select_keys
from repro.core.oracle import key_events as ref_key_events
from repro.core.oracle import oracle_search as ref_oracle_search
from repro.core.oracle import ordinary_events as ref_ordinary_events
from repro.core.oracle import sweep_events as ref_sweep_events
from repro.core.postings import KeyIterator as RefKeyIterator
from repro.core.postings import QueryStats as RefQueryStats
from repro.index import DocumentStore as RefDocumentStore
from repro.index import build_indexes as ref_build_indexes
from repro.search.engine import ALGORITHMS as REF_ALGORITHMS
from repro.search.engine import SearchEngine as RefSearchEngine
from repro_torch.core.baselines import simple_key_cover
from repro_torch.core.combiner import CombinerState, se24_combiner
from repro_torch.core.keys import Subquery, expand_subqueries, select_keys
from repro_torch.core.oracle import key_events, oracle_search, ordinary_events, sweep_events
from repro_torch.core.postings import KeyIterator, QueryStats
from repro_torch.index import PAPER_EXAMPLE_DOCS, DocumentStore, build_indexes
from repro_torch.search import ALGORITHMS, SearchEngine, VectorizedEngine
from tests.strategies import make_corpus, make_queries

PROBE = "to be who you are"  # "are" is the lemmas are+be at one position
SEEDS = [3, 11, 2024]
STAT_FIELDS = ("postings_read", "bytes_read", "intermediate_records", "heap_ops", "results")


@pytest.fixture(scope="module", params=SEEDS)
def corpus(request):
    spec = make_corpus(request.param)
    kw = dict(sw_count=spec.sw_count, fu_count=spec.fu_count, max_distance=spec.max_distance)
    ref_store = RefDocumentStore.from_texts(spec.texts)
    store = DocumentStore.from_texts(spec.texts)
    queries = make_queries(request.param, spec) + [PROBE, "to be or not to be"]
    return ref_store, ref_build_indexes(ref_store, **kw), store, build_indexes(store, **kw), queries


def _triples(results):
    return [(r.doc_id, r.start, r.end) for r in results]


def _stats(st):
    return tuple(getattr(st, f) for f in STAT_FIELDS)


def _subquery_pairs(corpus):
    """(port subquery, reference subquery) for every subquery of every
    query; both packages expand a query into the same lemma tuples."""
    ref_store, _, store, _, queries = corpus
    for q in queries:
        subs, ref_subs = expand_subqueries(q, store.lemmatizer), ref_expand(q, ref_store.lemmatizer)
        assert [s.lemmas for s in subs] == [s.lemmas for s in ref_subs], q
        yield from zip(subs, ref_subs)


def test_algorithm_table_names_the_reference_algorithms():
    assert list(ALGORITHMS) == list(REF_ALGORITHMS)


@pytest.mark.parametrize("algorithm", list(ALGORITHMS))
def test_host_algorithm_equals_reference(corpus, algorithm):
    """Each host algorithm: the reference's fragments in its order and its
    §11 counters, subquery by subquery."""
    _, ref_idx, _, idx, _ = corpus
    fn, ref_fn = ALGORITHMS[algorithm], REF_ALGORITHMS[algorithm]
    for sub, ref_sub in _subquery_pairs(corpus):
        got, st = fn(sub, idx)
        want, ref_st = ref_fn(ref_sub, ref_idx)
        assert _triples(got) == _triples(want), (algorithm, sub.lemmas)
        assert _stats(st) == _stats(ref_st), (algorithm, sub.lemmas)


@pytest.mark.parametrize("algorithm", list(ALGORITHMS))
def test_search_engine_host_algorithm_equals_reference(corpus, algorithm):
    ref_store, ref_idx, store, idx, queries = corpus
    got = SearchEngine(idx, lemmatizer=store.lemmatizer, algorithm=algorithm,
                       device="cpu").search_batch(queries, top_k=1000)
    want = RefSearchEngine(ref_idx, lemmatizer=ref_store.lemmatizer,
                           algorithm=algorithm).search_batch(queries, top_k=1000)
    for g, w in zip(got, want):
        assert [(d.doc_id, _triples(d.fragments)) for d in g.docs] == [
            (d.doc_id, _triples(d.fragments)) for d in w.docs
        ], (algorithm, g.query)
        np.testing.assert_allclose([d.score for d in g.docs], [d.score for d in w.docs], rtol=1e-9)
        assert _stats(g.stats) == _stats(w.stats) and g.n_subqueries == w.n_subqueries


def test_default_engine_is_the_combiner_and_equals_the_fused_program(corpus):
    """``SearchEngine(index)`` runs ``se2.4`` as the reference's does; the
    fused program returns the same fragment union."""
    _, _, store, idx, queries = corpus
    eng = SearchEngine(idx, lemmatizer=store.lemmatizer, device="cpu")
    assert eng.algorithm == "se2.4"
    fused = SearchEngine(idx, lemmatizer=store.lemmatizer, algorithm="fused", device="cpu")
    for h, f in zip(eng.search_batch(queries, top_k=1000), fused.search_batch(queries, top_k=1000)):
        assert sorted(_triples(x for d in h.docs for x in d.fragments)) == sorted(
            _triples(x for d in f.docs for x in d.fragments)
        ), h.query


def test_oracle_equals_reference(corpus):
    """``key_events``, ``ordinary_events``, ``sweep_events`` and
    ``oracle_search`` on the same postings; the Combiner equals the oracle
    over its keys, SE2.2 over the simple key cover."""
    _, ref_idx, _, idx, _ = corpus
    for sub, ref_sub in _subquery_pairs(corpus):
        keys, ref_keys = select_keys(sub, idx.fl), ref_select_keys(ref_sub, ref_idx.fl)
        assert [k.components for k in keys] == [k.components for k in ref_keys]
        post = {k: idx.key_postings(k.components) for k in keys}
        ref_post = {k: ref_idx.key_postings(k.components) for k in ref_keys}
        for honor in (True, False):
            got = key_events(keys, post, honor_stars=honor)
            assert got == ref_key_events(ref_keys, ref_post, honor_stars=honor)
        assert ordinary_events(sub.lemmas, idx.ordinary) == ref_ordinary_events(
            ref_sub.lemmas, ref_idx.ordinary
        )
        mult = sub.multiplicity()
        for doc, events in key_events(keys, post).items():
            for span in (None, 2 * idx.max_distance):
                assert _triples(sweep_events(doc, events, mult, span)) == _triples(
                    ref_sweep_events(doc, events, mult, span)
                )
        oracle = oracle_search(sub, keys, post, idx.max_distance)
        assert _triples(oracle) == _triples(ref_oracle_search(ref_sub, ref_keys, ref_post, idx.max_distance))
        assert sorted(_triples(se24_combiner(sub, idx)[0])) == sorted(_triples(oracle)), sub.lemmas
        cover = simple_key_cover(sub, idx.fl)
        post22 = {k: idx.key_postings(k.components) for k in cover}
        assert sorted(_triples(ALGORITHMS["se2.2"](sub, idx)[0])) == sorted(
            _triples(oracle_search(sub, cover, post22, idx.max_distance))
        ), sub.lemmas


def test_key_iterator_equals_reference(corpus):
    """The paper's iterator protocol — records, events with and without the
    §6 star marks, galloping skips — and its read accounting."""
    _, ref_idx, _, idx, _ = corpus
    for sub, ref_sub in _subquery_pairs(corpus):
        for key, ref_key in zip(select_keys(sub, idx.fl), ref_select_keys(ref_sub, ref_idx.fl)):
            st, ref_st = QueryStats(), RefQueryStats()
            it = KeyIterator(key, idx.key_postings(key.components), st)
            ref_it = RefKeyIterator(ref_key, ref_idx.key_postings(ref_key.components), ref_st)
            while not ref_it.exhausted:
                assert not it.exhausted
                assert (it.doc, it.pos, it.distances()) == (ref_it.doc, ref_it.pos, ref_it.distances())
                for honor in (True, False):
                    assert it.events(honor) == ref_it.events(honor)
                if it.pos % 3 == 0:  # a skip past the current document
                    it.skip_to_doc(it.doc + 1)
                    ref_it.skip_to_doc(ref_it.doc + 1)
                else:
                    it.next()
                    ref_it.next()
            assert it.exhausted
            assert (st.postings_read, st.bytes_read) == (ref_st.postings_read, ref_st.bytes_read)


def test_paper_trace_section_13():
    """§13's incremental example: MaxDistance=7, WindowSize=14, Start=4;
    query [who][i][need][you]; the first result is (15, 21), in both
    packages."""
    results = []
    for cls in (CombinerState, RefCombinerState):
        state = cls(Subquery(("who", "i", "need", "you")), window_size=14, max_distance=7)
        state.shift(4)
        for p, lem in ((19, "i"), (20, "need"), (15, "who"), (21, "you"), (21, "you"),
                       (22, "you"), (22, "you")):
            state.set(p, lem)
        state.process_source(doc_id=0)
        assert state.results == []
        state.switch()
        state.process_source(doc_id=0)
        results.append(_triples(state.results))
    assert results[0] == results[1] and results[0][0] == (0, 15, 21)


GOLDEN_QUERY_FRAGMENTS = {
    "who are you": [(0, 0, 2), (0, 0, 3), (0, 2, 8)],
    "who are you who": [(0, 0, 8)],
}


@pytest.mark.parametrize("query,expected", sorted(GOLDEN_QUERY_FRAGMENTS.items()))
def test_golden_engine_fragments(query, expected):
    """The reference's golden literals over the paper's documents D0/D1
    (``tests/test_golden.py``): every host algorithm of the shared result
    semantics, the fused program and the vectorized engine."""
    store = DocumentStore.from_texts(list(PAPER_EXAMPLE_DOCS) + ["is is is is is is"])
    index = build_indexes(store, sw_count=10_000, fu_count=0, max_distance=5)
    for algorithm in ("se2.2", "se2.3", "se2.4", "fused"):
        resp = SearchEngine(index, lemmatizer=store.lemmatizer, algorithm=algorithm,
                            device="cpu").search(query, top_k=10)
        assert sorted(_triples(f for d in resp.docs for f in d.fragments)) == expected, algorithm
    vec = VectorizedEngine(index, device="cpu")
    union = set()
    for sub in expand_subqueries(query, store.lemmatizer):
        union |= set(_triples(vec.search_subquery(sub)[0]))
    assert sorted(union) == expected


# The reference's Step 2 gate (``maxP - minP < 2*MaxDistance`` over key
# positions) advances past records whose events a fragment needs: a
# record's events lie up to MaxDistance either side of its key position.
# The port gates on ``<= 4*MaxDistance`` (ROADMAP §C).  Each case is the
# input a reference test draws at one of its random seeds
# (``tests/test_fused.py::test_fused_random_corpus_random_subqueries`` at
# 3003 and 3936, ``tests/test_arena.py::
# test_arena_random_corpora_random_subqueries`` at 6670, which draws
# subqueries of 1-4 lemmas where the other draws 2-4): the subquery of the
# draw and the fragment the reference's Combiner misses.
SE24_MISSES = {
    "test_fused-3003": (3003, 2, 0, (0, 24, 32)),
    "test_fused-3936": (3936, 2, 2, (7, 24, 32)),
    "test_arena-6670": (6670, 1, 1, (0, 12, 20)),
}
DRAWS = {"test_fused": 2, "test_arena": 1}  # the least subquery length each test draws

# Every seed of 0-10,000 at which the reference's Combiner misses a
# fragment of the oracle on a draw of those two tests (a scan of both
# draws over every seed; the port's Combiner equals the oracle on all).
SCAN_FAILING_SEEDS = {
    "test_fused": [54, 139, 203, 328, 389, 392, 553, 558, 860, 998, 1042, 1403, 1682, 1708, 1840, 1884, 2033,
                   2065, 2188, 2417, 2646, 2667, 3003, 3006, 3122, 3149, 3205, 3866, 3936, 4134, 4210, 4439,
                   4547, 4553, 4759, 4993, 5047, 5053, 5133, 5174, 5231, 5387, 5411, 5458, 5592, 5858, 5913,
                   5969, 6170, 6319, 6416, 6670, 6937, 7102, 7238, 7263, 7288, 7306, 7319, 7415, 7735, 7882,
                   7898, 8123, 8359, 8631, 8769, 8785, 8790, 8792, 8950, 8967, 9230, 9791],
    "test_arena": [54, 203, 389, 553, 860, 1682, 1708, 1840, 2033, 2099, 2417, 3003, 3205, 3645, 4134, 4188,
                   4409, 4439, 4547, 4759, 4951, 4966, 5047, 5231, 5276, 5404, 5411, 5458, 5575, 5954, 5969,
                   6033, 6102, 6170, 6319, 6416, 6670, 6671, 6802, 7288, 7319, 7525, 7882, 7898, 8359, 8631,
                   8769, 8785, 8950],
}
RANDOM_KW = dict(sw_count=10_000, fu_count=0, max_distance=4)


def _random_corpus_draw(seed: int, min_lemmas: int):
    """The texts and subqueries those reference tests draw from ``seed``."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(15)]
    probs = np.array([1 / (i + 1) ** 1.1 for i in range(15)])
    probs /= probs.sum()
    texts = [" ".join(rng.choice(vocab, size=60, p=probs)) for _ in range(8)]
    subs = [tuple(str(x) for x in rng.choice(vocab[:6], size=int(rng.integers(min_lemmas, 5)), replace=True))
            for _ in range(3)]
    return texts, subs


def _oracle(sub, idx):
    keys = select_keys(sub, idx.fl)
    return set(_triples(oracle_search(sub, keys, {k: idx.key_postings(k.components) for k in keys},
                                      idx.max_distance)))


@pytest.mark.parametrize("case", list(SE24_MISSES))
def test_se24_combiner_misses_a_fragment_in_both_packages(case):
    """The reference's Combiner misses the fragment; the port's returns it
    and equals the §10 oracle and the fused program of both packages."""
    from repro.core.combiner import se24_combiner as ref_se24_combiner
    from repro.core.keys import Subquery as RefSubquery
    from repro.search.vectorized import VectorizedEngine as RefVectorizedEngine

    seed, min_lemmas, which, missed = SE24_MISSES[case]
    texts, subs = _random_corpus_draw(seed, min_lemmas)
    ref_idx = ref_build_indexes(RefDocumentStore.from_texts(texts), **RANDOM_KW)
    idx = build_indexes(DocumentStore.from_texts(texts), **RANDOM_KW)
    sub, ref_sub = Subquery(subs[which]), RefSubquery(subs[which])
    combiner = set(_triples(se24_combiner(sub, idx)[0]))
    ref_combiner = set(_triples(ref_se24_combiner(ref_sub, ref_idx)[0]))
    assert missed in combiner and missed not in ref_combiner
    assert ref_combiner == combiner - {missed}
    oracle = _oracle(sub, idx)
    ref_keys = ref_select_keys(ref_sub, ref_idx.fl)
    assert oracle == set(_triples(ref_oracle_search(ref_sub, ref_keys, {k: ref_idx.key_postings(k.components)
                                                                      for k in ref_keys}, ref_idx.max_distance)))
    fused = set(_triples(VectorizedEngine(idx, device="cpu").search_query_batch([[sub]])[0].per_query[0]))
    ref_fused = set(_triples(RefVectorizedEngine(ref_idx).search_query_batch([[ref_sub]])[0].per_query[0]))
    assert fused == ref_fused == oracle == combiner


@pytest.mark.parametrize("draw,seed", [(d, s) for d, seeds in SCAN_FAILING_SEEDS.items() for s in seeds])
def test_se24_combiner_equals_the_oracle_where_the_reference_misses(draw, seed):
    """Every subquery of the draw: the port's Combiner returns exactly the
    oracle's fragments over its keys."""
    texts, subs = _random_corpus_draw(seed, DRAWS[draw])
    idx = build_indexes(DocumentStore.from_texts(texts), **RANDOM_KW)
    for lemmas in subs:
        sub = Subquery(lemmas)
        assert set(_triples(se24_combiner(sub, idx)[0])) == _oracle(sub, idx), lemmas


# (draw, seed, subquery index): the port's then the reference's §11 counts
# (postings_read, bytes_read, heap_ops, results).  The wider gate runs fewer
# Step-2 rounds (heap_ops) and Step 3 reads records the reference skipped
# (postings_read), with the same fragments or with the fragment recovered.
SE24_COUNTS = {
    "test_fused-54": ((54, 2, 0), (14, 224, 8, 5), (14, 224, 9, 4)),
    "test_fused-6": ((6, 2, 2), (77, 1232, 17, 36), (77, 1232, 22, 36)),
    "test_arena-57": ((57, 1, 2), (26, 416, 7, 3), (13, 208, 8, 3)),
}


@pytest.mark.parametrize("case", list(SE24_COUNTS))
def test_se24_section_11_counts_where_the_step2_gate_differs(case):
    from repro.core.combiner import se24_combiner as ref_se24_combiner
    from repro.core.keys import Subquery as RefSubquery

    (seed, min_lemmas, which), want, ref_want = SE24_COUNTS[case]
    texts, subs = _random_corpus_draw(seed, min_lemmas)
    fields = ("postings_read", "bytes_read", "heap_ops", "results")
    got, st = se24_combiner(Subquery(subs[which]), build_indexes(DocumentStore.from_texts(texts), **RANDOM_KW))
    ref_got, ref_st = ref_se24_combiner(RefSubquery(subs[which]),
                                        ref_build_indexes(RefDocumentStore.from_texts(texts), **RANDOM_KW))
    assert tuple(getattr(st, f) for f in fields) == want
    assert tuple(getattr(ref_st, f) for f in fields) == ref_want
    assert set(_triples(ref_got)) <= set(_triples(got))


@pytest.mark.parametrize("max_distance,window_size,raises", [(4, 64, False), (16, 64, False), (17, 64, True),
                                                              (4, 16, False), (4, 8, True), (7, 14, True)])
def test_se24_combiner_refuses_a_window_narrower_than_four_max_distances(max_distance, window_size, raises):
    """The wider Step-2 gate hands Step 3 records up to 4*MaxDistance apart,
    so the Combiner needs that much window: the window is widened to
    2*MaxDistance (as in the reference), at most 64, and a window still
    narrower than 4*MaxDistance refuses; otherwise the Combiner equals the
    oracle."""
    texts, subs = _random_corpus_draw(54, DRAWS["test_fused"])
    idx = build_indexes(DocumentStore.from_texts(texts), **{**RANDOM_KW, "max_distance": max_distance})
    sub = Subquery(subs[0])
    if raises:
        with pytest.raises(ValueError, match="4\\*MaxDistance"):
            se24_combiner(sub, idx, window_size=window_size)
    else:
        assert set(_triples(se24_combiner(sub, idx, window_size=window_size)[0])) == _oracle(sub, idx)
