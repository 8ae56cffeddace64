"""The port's ``search/vectorized.py`` (``VectorizedEngine``,
``pack_subquery_events``) and the rest of ``core/window.py`` (the rank
cover and the cover readouts) against the reference's, on the same numpy
inputs.

Integer outputs — fragment lists, packed events, emit masks, starts — must
be identical; the device top-k scores are float32 sums taken in the
reference's order, so they are equal too (checked with rtol 1e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.combiner import se24_combiner as ref_se24_combiner
from repro.core.keys import expand_subqueries as ref_expand
from repro.core.window import events_to_occupancy as ref_events_to_occupancy
from repro.core.window import results_from_cover as ref_results_from_cover
from repro.core.window import results_from_cover_batch as ref_results_from_cover_batch
from repro.core.window import window_cover_rank_batch as ref_window_cover_rank_batch
from repro.index import DocumentStore as RefDocumentStore
from repro.index import build_indexes as ref_build_indexes
from repro.search.vectorized import VectorizedEngine as RefVectorizedEngine
from repro.search.vectorized import pack_subquery_events as ref_pack_subquery_events
from repro_torch.core.keys import expand_subqueries
from repro_torch.core.oracle import sweep_events
from repro_torch.core.window import (
    events_to_occupancy,
    results_from_cover,
    results_from_cover_batch,
    window_cover,
    window_cover_batch,
    window_cover_rank_batch,
)
from repro_torch.index import DocumentStore, build_indexes
from repro_torch.search import VectorizedEngine, fused, pack_subquery_events
from repro_torch.search.arena import PostingArena
from tests.strategies import make_corpus, make_queries

SEEDS = [3, 11, 2024]


@pytest.fixture(scope="module", params=SEEDS)
def corpus(request):
    spec = make_corpus(request.param)
    kw = dict(sw_count=spec.sw_count, fu_count=spec.fu_count, max_distance=spec.max_distance)
    ref_store = RefDocumentStore.from_texts(spec.texts)
    store = DocumentStore.from_texts(spec.texts)
    queries = make_queries(request.param, spec) + ["to be who you are", "who are you who"]
    return ref_store, ref_build_indexes(ref_store, **kw), store, build_indexes(store, **kw), queries


def _triples(results):
    return [(r.doc_id, r.start, r.end) for r in results]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_vectorized_engine_equals_reference(corpus, use_kernel):
    """One batch of every query: the same fragment lists, device top-k and
    §11 accounting as the reference's engine; every subquery alone equals
    the scalar Combiner."""
    ref_store, ref_idx, store, idx, queries = corpus
    batch = [expand_subqueries(q, store.lemmatizer) for q in queries]
    ref_batch = [ref_expand(q, ref_store.lemmatizer) for q in queries]
    eng = VectorizedEngine(idx, use_kernel=use_kernel, device="cpu")
    ref_eng = RefVectorizedEngine(ref_idx, use_kernel=use_kernel)
    fused.reset_dispatch_count()
    got, st = eng.search_query_batch(batch)
    assert fused.dispatch_count() == st.device_dispatches <= 1
    want, ref_st = ref_eng.search_query_batch(ref_batch)
    assert [_triples(r) for r in got.per_query] == [_triples(r) for r in want.per_query]
    np.testing.assert_array_equal(got.top_docs, np.asarray(want.top_docs))
    np.testing.assert_allclose(got.top_scores, np.asarray(want.top_scores), rtol=1e-6)
    for field in ("postings_read", "bytes_read", "results", "empty_subqueries", "device_dispatches"):
        assert getattr(st, field) == getattr(ref_st, field), field
    for subs, ref_subs in zip(batch, ref_batch):
        for sub, ref_sub in zip(subs, ref_subs):
            assert set(_triples(eng.search_subquery(sub)[0])) == set(
                _triples(ref_se24_combiner(ref_sub, ref_idx)[0])
            ), sub.lemmas


def test_vectorized_engine_over_an_arena_equals_host_pack(corpus):
    _, _, store, idx, queries = corpus
    batch = [expand_subqueries(q, store.lemmatizer) for q in queries]
    plain, _ = VectorizedEngine(idx, device="cpu").search_query_batch(batch)
    res, st = VectorizedEngine(idx, arena=PostingArena(device="cpu"), device="cpu").search_query_batch(batch)
    assert [_triples(r) for r in res.per_query] == [_triples(r) for r in plain.per_query]
    assert st.device_dispatches <= 1


def test_pack_subquery_events_equals_reference(corpus):
    ref_store, ref_idx, store, idx, queries = corpus
    for q in queries:
        for sub, ref_sub in zip(expand_subqueries(q, store.lemmatizer), ref_expand(q, ref_store.lemmatizer)):
            got = pack_subquery_events(sub, idx, device="cpu")
            want = ref_pack_subquery_events(ref_sub, ref_idx)
            assert (got is None) == (want is None), sub.lemmas
            if got is None:
                continue
            for field in ("events", "doc_ids", "mult"):
                np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
            assert got.lemmas == want.lemmas


def test_vectorized_engine_refuses_incremental_sources():
    with pytest.raises(NotImplementedError, match="incremental/store/wal/checkpoint"):
        VectorizedEngine(type("Ix", (), {"generation_token": (0, 1)})(), device="cpu")


def _cover_inputs(seed):
    """0/1 and arbitrary-count occupancy in uint8 or int32; multiplicities
    with 0 (inactive), negative values and values above any window."""
    rng = np.random.default_rng(seed)
    b, l, n = int(rng.integers(1, 6)), int(rng.integers(1, 6)), int(rng.choice([1, 17, 96, 128, 300]))
    occ = (rng.random((b, l, n)) < rng.choice([0.05, 0.2, 0.5])).astype(np.int64)
    if seed % 3 == 0:
        occ *= rng.integers(1, 200, occ.shape)
    occ = occ.astype(np.uint8 if seed % 2 else np.int32)
    mult = rng.choice([-2, 0, 1, 1, 2, 3, 40], (b, l)).astype(np.int32)
    return occ, mult, 2 * int(rng.integers(0, 9)) + 1


@pytest.mark.parametrize("seed", range(12))
def test_window_cover_rank_batch_equals_reference_bitwise(seed):
    """The rank cover's emit and start everywhere, bit for bit, and the
    dense cover's emit (and start where it emits)."""
    occ, mult, window = _cover_inputs(seed)
    e, s = window_cover_rank_batch(torch.from_numpy(occ), torch.from_numpy(mult), window)
    re_, rs = ref_window_cover_rank_batch(jnp.asarray(occ), jnp.asarray(mult), window)
    assert e.dtype == torch.bool and s.dtype == torch.int32
    np.testing.assert_array_equal(e.numpy(), np.asarray(re_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    de, ds = window_cover_batch(torch.from_numpy((occ > 0).astype(np.int32)), torch.from_numpy(mult), window)
    assert torch.equal(de, e)
    assert torch.equal(torch.where(e, ds, 0), torch.where(e, s, 0))


@pytest.mark.parametrize("seed", range(6))
def test_cover_readouts_equal_reference(seed):
    """``events_to_occupancy``, ``results_from_cover`` and
    ``results_from_cover_batch`` on the reference's inputs; the fragments
    equal the §10 sweep over the same events."""
    rng = np.random.default_rng(100 + seed)
    n_lemmas, doc_len, n_events = int(rng.integers(1, 5)), 96, int(rng.integers(0, 40))
    pos = rng.integers(-1, doc_len, n_events).astype(np.int32)
    lem = rng.integers(0, n_lemmas, n_events).astype(np.int32)
    occ = events_to_occupancy(pos, lem, n_lemmas, doc_len, device="cpu")
    np.testing.assert_array_equal(occ.numpy(), ref_events_to_occupancy(pos, lem, n_lemmas, doc_len))
    mult = rng.integers(1, 3, n_lemmas).astype(np.int32)
    emit, start = window_cover(occ, torch.from_numpy(mult), window=9)
    got = results_from_cover(7, emit, start)
    assert got == ref_results_from_cover(7, emit.numpy(), start.numpy())
    events = sorted({(int(p), f"l{l}") for p, l in zip(pos, lem) if p >= 0})
    sweep = sweep_events(7, events, {f"l{l}": int(m) for l, m in enumerate(mult)}, max_span=8)
    assert set(got) == set(_triples(sweep))

    occ_b, mult_b, window = _cover_inputs(seed)
    emit, start = window_cover_rank_batch(torch.from_numpy(occ_b), torch.from_numpy(mult_b), window)
    doc_ids = rng.integers(-1, 50, occ_b.shape[0]).astype(np.int32)
    got = results_from_cover_batch(torch.from_numpy(doc_ids), emit, start)
    want = ref_results_from_cover_batch(doc_ids, emit.numpy(), start.numpy())
    assert got[2].dtype == torch.int64
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
