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
from repro.core.postings import QueryStats as RefStats
from repro.index import build_indexes as ref_build_indexes
from repro.index import synthesize_corpus as ref_synthesize
from repro.search import fused as ref_fused
from repro_torch.core.keys import expand_subqueries
from repro_torch.core.postings import QueryStats
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


@pytest.mark.parametrize("use_kernel", [False, True])
def test_arena_residencies_route_through_the_arena(indexes, use_kernel):
    """Work items of a resident view run in ONE arena program, with the
    host route's fragments; views without a residency keep the host path."""
    from repro_torch.search.arena import PostingArena

    work = indexes[1]
    view = work[0][0][1]
    res = {id(view): PostingArena(device="cpu").acquire(view, 0)}
    host = fused.serve_query_batch(work, max_distance=5, device="cpu")
    stats = [QueryStats() for _ in work]
    fused.reset_dispatch_count()
    got = fused.serve_query_batch(work, max_distance=5, residencies=res, use_kernel=use_kernel,
                                  stats=stats, device="cpu")
    assert fused.dispatch_count() == 1
    assert got.per_query == host.per_query
    assert sum(s.arena_hits for s in stats) > 0 and sum(s.arena_misses for s in stats) == 0
    stats = [QueryStats() for _ in work]
    other = fused.serve_query_batch(work, max_distance=5, residencies={id(object()): res[id(view)]},
                                    stats=stats, device="cpu")
    assert other.per_query == host.per_query and sum(s.arena_hits for s in stats) == 0


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


def _fold_items(seed):
    """Multi-list items sharing a core of docs (every fold stays live to its
    end; the deepest is 3 steps), one item of disjoint lists (its fold ends
    early on an empty result) and one single-list item."""
    rng = np.random.default_rng(seed)
    core = rng.choice(4000, 40, replace=False)

    def doc_list(lo=0, hi=4000, with_core=True):
        docs = rng.integers(lo, hi, size=rng.integers(50, 1500))
        return np.unique(np.concatenate([core, docs]) if with_core else docs).astype(np.int32)

    items = [[doc_list() for _ in range(n)] for n in (2, 4, 3, 2)]
    items.append([doc_list(0, 2000, False), doc_list(2000, 4000, False), doc_list()])
    items.append([doc_list()])
    return items


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("threshold", [1, 200])
def test_intersect_candidates_many_folds_in_rounds(seed, threshold):
    """Every item's fold equals the reference's intersect_candidates; all
    device steps of a round are one dispatch, so the batch counts at most
    one per round (one per round at threshold 1, where every live step
    runs on the device; at 200 only the steps of long lists do) instead of
    the reference's one per pair."""
    items = _fold_items(seed)
    fused.reset_dispatch_count()
    got = fused.intersect_candidates_many(items, device_threshold=threshold, device="cpu")
    dispatches = fused.dispatch_count()
    ref_fused.reset_dispatch_count()
    want = [ref_fused.intersect_candidates(lists, device_threshold=threshold) for lists in items]
    pairs = ref_fused.dispatch_count()
    assert len(got) == len(items)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"item {i}")
    rounds = max(len(lists) for lists in items) - 1
    assert 0 < dispatches <= rounds < pairs
    if threshold == 1:
        assert dispatches == rounds
    assert len(got[-2]) == 0  # the disjoint fold ended early


def test_plan_with_device_intersects_equals_reference(indexes):
    """At a threshold low enough for the 60-doc corpus's lists, the plan
    (Step-1 folds run in rounds) equals the reference's (one intersect per
    pair), array for array, with equal read and empty-subquery counts."""
    ref_work, work = indexes
    ref_stats, stats = [RefStats() for _ in QUERIES], [QueryStats() for _ in QUERIES]
    ref_fused.reset_dispatch_count()
    want = ref_fused.plan_query_batch(ref_work, stats=ref_stats, intersect_device_threshold=16)
    pairs = ref_fused.dispatch_count()
    fused.reset_dispatch_count()
    plan = fused.plan_query_batch(work, stats=stats, intersect_device_threshold=16, device="cpu")
    assert 0 < fused.dispatch_count() <= pairs
    for name in ("events", "primary", "postab", "row_doc", "row_query", "mult"):
        np.testing.assert_array_equal(getattr(plan, name), getattr(want, name), err_msg=name)
    for name in ("n_queries", "query_budget", "doc_len"):
        assert getattr(plan, name) == getattr(want, name), name
    for st, ref in zip(stats, ref_stats):
        assert (st.postings_read, st.bytes_read, st.empty_subqueries) == (
            ref.postings_read, ref.bytes_read, ref.empty_subqueries)


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
