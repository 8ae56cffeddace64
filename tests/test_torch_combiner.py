"""The port's host algorithms — the scalar §10 Combiner ``se24_combiner``,
the baselines SE1 and SE2.1-SE2.3, their oracle and ``KeyIterator`` —
against the reference's, over the ``tests/strategies.py`` corpora, plus the
paper's worked examples.

Both packages get the same texts; fragment lists (in the order each
algorithm emits them) and the §11 counters must be identical, and
``SearchEngine`` with each host algorithm must rank the same documents with
the same scores (float sums over the same fragments in the same order:
rtol 1e-9, in fact equal).
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


# A fault both packages share, pinned: on these inputs ``se24_combiner``
# misses a fragment that the §10 oracle over its own keys and the fused
# program both return.  Each case is the input a reference test draws at one
# of its random seeds (``tests/test_fused.py::
# test_fused_random_corpus_random_subqueries`` at 3003 and 3936,
# ``tests/test_arena.py::test_arena_random_corpora_random_subqueries`` at
# 6670, which draws subqueries of 1-4 lemmas where the other draws 2-4): the
# subquery of the draw that fails and the fragment the Combiner misses.
SE24_MISSES = {
    "test_fused-3003": (3003, 2, 0, (0, 24, 32)),
    "test_fused-3936": (3936, 2, 2, (7, 24, 32)),
    "test_arena-6670": (6670, 1, 1, (0, 12, 20)),
}


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


@pytest.mark.parametrize("case", list(SE24_MISSES))
def test_se24_combiner_misses_a_fragment_in_both_packages(case):
    from repro.core.combiner import se24_combiner as ref_se24_combiner
    from repro.core.keys import Subquery as RefSubquery
    from repro.search.vectorized import VectorizedEngine as RefVectorizedEngine

    seed, min_lemmas, which, missed = SE24_MISSES[case]
    texts, subs = _random_corpus_draw(seed, min_lemmas)
    kw = dict(sw_count=10_000, fu_count=0, max_distance=4)
    ref_idx = ref_build_indexes(RefDocumentStore.from_texts(texts), **kw)
    idx = build_indexes(DocumentStore.from_texts(texts), **kw)
    sub, ref_sub = Subquery(subs[which]), RefSubquery(subs[which])
    combiner = set(_triples(se24_combiner(sub, idx)[0]))
    assert combiner == set(_triples(ref_se24_combiner(ref_sub, ref_idx)[0]))
    assert missed not in combiner
    keys = select_keys(sub, idx.fl)
    oracle = set(_triples(oracle_search(sub, keys, {k: idx.key_postings(k.components) for k in keys},
                                        idx.max_distance)))
    ref_keys = ref_select_keys(ref_sub, ref_idx.fl)
    assert oracle == set(_triples(ref_oracle_search(ref_sub, ref_keys, {k: ref_idx.key_postings(k.components)
                                                                      for k in ref_keys}, ref_idx.max_distance)))
    fused = set(_triples(VectorizedEngine(idx, device="cpu").search_query_batch([[sub]])[0].per_query[0]))
    ref_fused = set(_triples(RefVectorizedEngine(ref_idx).search_query_batch([[ref_sub]])[0].per_query[0]))
    assert fused == ref_fused == oracle == combiner | {missed}
