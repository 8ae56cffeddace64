"""The port's fused serving program (``repro_torch.search.fused``) against
the reference's (``repro.search.fused``, jax on the CPU, Pallas in
interpret mode), on the same plans.

Integer outputs must be equal: the §15.1 result buffer ``res``,
``n_fragments``, ``emit``, and ``start`` where ``emit``.  ``top_scores`` are
float32 sums taken in another order, so they agree within rtol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.keys import expand_subqueries as ref_expand
from repro.index import build_indexes as ref_build_indexes
from repro.index import synthesize_corpus as ref_synthesize
from repro.search import fused as ref_fused
from repro_torch.core.keys import expand_subqueries
from repro_torch.index import build_indexes, synthesize_corpus
from repro_torch.search import fused

QUERIES = [
    "who are you who",
    "to be or not to be",
    "what do you do all day",
    "the time of war",
    "i need you",
    "time and time again",
]
SCORE_RTOL = 1e-6  # float32 sums of at most a few hundred terms per row


@pytest.fixture(scope="module")
def indexes():
    kw = dict(n_docs=60, doc_len=120, vocab_size=500, seed=7)
    ref_store, store = ref_synthesize(**kw), synthesize_corpus(**kw)
    ref_idx = ref_build_indexes(ref_store, sw_count=60, fu_count=120, max_distance=5)
    idx = build_indexes(store, sw_count=60, fu_count=120, max_distance=5)
    ref_work = [[(s, ref_idx) for s in ref_expand(q, ref_store.lemmatizer)] for q in QUERIES]
    work = [[(s, idx) for s in expand_subqueries(q, store.lemmatizer)] for q in QUERIES]
    return ref_work, work


@pytest.fixture(scope="module")
def ref_plan(indexes):
    return ref_fused.plan_query_batch(indexes[0])


def test_plan_equals_reference_plan(indexes, ref_plan):
    plan = fused.plan_query_batch(indexes[1], device="cpu")
    for name in ("events", "primary", "postab", "row_doc", "row_query", "mult"):
        np.testing.assert_array_equal(getattr(plan, name), getattr(ref_plan, name), err_msg=name)
    for name in ("n_queries", "query_budget", "doc_len"):
        assert getattr(plan, name) == getattr(ref_plan, name), name


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("compute_dtype", ["uint8", "int32"])
def test_fused_serve_batch_equals_reference(ref_plan, use_kernel, compute_dtype):
    arrays = [ref_plan.events, ref_plan.primary, ref_plan.postab,
              ref_plan.row_doc, ref_plan.row_query, ref_plan.mult]
    kw = dict(max_distance=5, query_budget=ref_plan.query_budget, window_len=ref_plan.doc_len,
              top_k=16, compute_dtype=compute_dtype, use_kernel=use_kernel)
    want = {k: np.asarray(v) for k, v in ref_fused.fused_serve_batch(*map(jnp.asarray, arrays), **kw).items()}
    got = {k: v.numpy() for k, v in fused.fused_serve_batch(*map(torch.from_numpy, arrays), **kw).items()}
    assert want["emit"].any()
    for name in ("res", "n_fragments", "emit"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_array_equal(
        np.where(want["emit"], got["start"], 0), np.where(want["emit"], want["start"], 0)
    )
    np.testing.assert_allclose(got["top_scores"], want["top_scores"], rtol=SCORE_RTOL)
    # the rows behind each score: same doc wherever the score is not tied
    finite = np.isfinite(want["top_scores"])
    np.testing.assert_array_equal(got["top_docs"] >= 0, finite)
    for qs, want_docs, got_docs in zip(want["top_scores"], want["top_docs"], got["top_docs"]):
        for i, s in enumerate(qs):
            if np.isfinite(s) and np.isclose(qs, s, rtol=1e-5).sum() == 1:
                assert got_docs[i] == want_docs[i]


@pytest.mark.parametrize("readout", ["device", "host"])
def test_serve_query_batch_equals_reference(indexes, readout):
    ref_work, work = indexes
    want = ref_fused.serve_query_batch(ref_work, max_distance=5, readout=readout)
    got = fused.serve_query_batch(work, max_distance=5, readout=readout, device="cpu")
    assert [sorted(p) for p in got.per_query] == [sorted(p) for p in want.per_query]
    assert got.per_query == [sorted(set(p)) for p in got.per_query]
    np.testing.assert_array_equal(got.n_fragments, want.n_fragments)
    np.testing.assert_allclose(got.top_scores, want.top_scores, rtol=SCORE_RTOL)


def test_deferred_equals_eager_and_readouts_agree(indexes):
    work = indexes[1]
    eager = fused.serve_query_batch(work, max_distance=5, device="cpu")
    host = fused.serve_query_batch(work, max_distance=5, readout="host", device="cpu")
    pending = fused.serve_query_batch(work, max_distance=5, defer=True, device="cpu")
    assert isinstance(pending, fused.PendingBatch)
    got = pending.result()
    assert pending.result() is got
    assert got.per_query == eager.per_query == host.per_query
    with pytest.raises(ValueError, match="readout"):
        fused.serve_query_batch(work, max_distance=5, readout="dma", device="cpu")


def test_one_dispatch_per_batch_and_empty_short_circuit(indexes):
    work = indexes[1]
    fused.reset_dispatch_count()
    fused.serve_query_batch(work, max_distance=5, device="cpu")
    assert fused.dispatch_count() == 1
    fused.reset_dispatch_count()
    res = fused.serve_query_batch([[]], max_distance=5, device="cpu")
    assert fused.dispatch_count() == 0 and res.per_query == [[]]
    assert fused.compile_count() is None


def test_merge_results_equals_single_batch(indexes):
    """Each query's subqueries split over two batches, merged: the same
    fragment sets as one batch."""
    work = indexes[1]
    halves = [[items[i::2] for items in work] for i in (0, 1)]
    parts = [fused.serve_query_batch(h, max_distance=5, device="cpu") for h in halves]
    merged = fused._merge_results(parts, len(work), 16)
    whole = fused.serve_query_batch(work, max_distance=5, device="cpu")
    assert merged.per_query == whole.per_query
    np.testing.assert_array_equal(merged.n_fragments, whole.n_fragments)


def test_arena_residencies_not_ported(indexes):
    with pytest.raises(NotImplementedError, match="arena"):
        fused.serve_query_batch(indexes[1], max_distance=5, residencies={1: object()}, device="cpu")


def test_intersect_candidates_tile_path_equals_host():
    rng = np.random.default_rng(2)
    lists = [
        np.unique(rng.integers(0, 4000, size=rng.integers(50, 1500)).astype(np.int32))
        for _ in range(3)
    ]
    host = fused.intersect_candidates(lists, device_threshold=10**9, device="cpu")
    fused.reset_dispatch_count()
    dev = fused.intersect_candidates(lists, device_threshold=1, device="cpu")
    assert fused.dispatch_count() == 2
    np.testing.assert_array_equal(host, dev)
    np.testing.assert_array_equal(dev, ref_fused.intersect_candidates(lists, device_threshold=1))
    np.testing.assert_array_equal(host, np.intersect1d(np.intersect1d(lists[0], lists[1]), lists[2]))


def _dedup_reference(q, d, s, e):
    uniq = sorted(set(zip(q, d, s, e)))
    cols = list(zip(*uniq)) if uniq else [[], [], [], []]
    return [list(c) for c in cols]


@pytest.mark.parametrize("tier", ["packed", "lexsort"])
def test_dedup_fragments_both_tiers(tier):
    rng = np.random.default_rng(3)
    q = rng.integers(0, 7, 200).astype(np.int64)
    d = rng.integers(0, 50, 200).astype(np.int64)
    s = rng.integers(0, 30, 200).astype(np.int64)
    e = s + rng.integers(0, 5, 200).astype(np.int64)
    if tier == "lexsort":  # doc ids near 2^58: the packed key cannot hold them
        d = d + (1 << 58)
        mods = [int(c.max()) + 1 for c in (q, d, s, e)]
        assert (mods[0] * mods[1] * mods[2] * mods[3] - 1).bit_length() > 63
    got = [c.tolist() for c in fused._dedup_fragments(q, d, s, e)]
    assert got == _dedup_reference(q.tolist(), d.tolist(), s.tolist(), e.tolist())
    assert got == [c.tolist() for c in ref_fused._dedup_fragments(q, d, s, e)]
    empty = np.empty(0, np.int64)
    assert all(len(c) == 0 for c in fused._dedup_fragments(empty, empty, empty, empty))
