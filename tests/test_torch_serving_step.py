"""The port's ``search/serving_step.py`` (``serve_step``,
``serve_step_sharded``, ``build_step``) against the reference's jitted
functions, on the same numpy inputs from a seed, on the CPU.

Tolerances: integer outputs (``n_fragments``, the build histogram and its
total) identical; ``top_scores`` within rtol 1e-5 (float32 sums over a
cluster's positions, taken in another order); ``top_docs`` identical, except
inside runs of scores equal within that tolerance, where they compare as
sets (two clusters whose sums differ only in rounding may swap).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.combiner import se24_combiner as ref_se24_combiner
from repro.core.keys import expand_subqueries as ref_expand
from repro.search.serving_step import build_step as ref_build_step
from repro.search.serving_step import serve_step as ref_serve_step
from repro.search.serving_step import serve_step_sharded as ref_serve_step_sharded
from repro.search.vectorized import pack_subquery_events as ref_pack_subquery_events
from repro_torch.configs import get_reduced_spec
from repro_torch.core.combiner import se24_combiner
from repro_torch.core.keys import expand_subqueries
from repro_torch.core.lemma import Lemmatizer
from repro_torch.index import build_indexes, synthesize_corpus
from repro_torch.search import pack_subquery_events, rank_documents
from repro_torch.search.serving_step import (
    build_step,
    serve_step,
    serve_step_plain,
    serve_step_sharded,
    serve_step_sharded_plain,
)

RTOL = 1e-5
CFG = get_reduced_spec("paper_search").model_cfg
L, N, D = CFG.n_lemmas, CFG.window_len, CFG.max_distance
# reduced_spec's serve_online: B 4, P 128, C 8
B, P, C = (get_reduced_spec("paper_search").shapes["serve_online"].kwargs[k]
           for k in ("batch", "postings", "clusters"))


def _inputs(rng, b, p, c, l=L, n=N, d=D, wild=1 / 16, pad=0.1):
    """Postings in bursts narrower than the window (one posting per lemma
    occurrence of the query's multiset, 3-5 active lemmas of multiplicity
    1-2), a ``wild`` share of postings with any field out of range, a
    ``pad`` share of padded clusters."""
    mult = np.zeros((b, l), np.int32)
    for q in range(b):
        act = rng.choice(l, size=min(l, rng.integers(3, 6)), replace=False)
        mult[q, act] = rng.integers(1, 3, len(act))
    post = np.full((b, p, 3), -1, np.int32)
    for q in range(b):
        multiset = np.repeat(np.arange(l), mult[q])
        j = 0
        while j + len(multiset) <= p:
            cl, centre = rng.integers(0, c), rng.integers(0, n - 2 * d + 1)
            for lem in multiset:
                post[q, j] = (cl, centre + rng.integers(0, 2 * d), lem)
                j += 1
            j += rng.integers(0, 3)  # padding between bursts
    wild_mask = rng.random((b, p)) < wild
    wild_vals = np.stack([rng.integers(-3, c + 3, (b, p)), rng.integers(-3, n + 3, (b, p)),
                          rng.integers(-3, l + 3, (b, p))], axis=-1)
    post[wild_mask] = wild_vals[wild_mask]
    cluster_doc = rng.integers(0, 10_000, (b, c)).astype(np.int32)
    cluster_doc[rng.random((b, c)) < pad] = -1
    return post, cluster_doc, mult


def _ref(fn, *arrays, **kw):
    return {k: np.asarray(v) for k, v in fn(*(jnp.asarray(a) for a in arrays), **kw).items()}


def _port(fn, *arrays, **kw):
    return {k: v.numpy() for k, v in fn(*(torch.from_numpy(a) for a in arrays), **kw).items()}


def assert_topk_agree(got, want):
    """``n_fragments`` identical; ``top_scores`` within rtol; ``top_docs``
    identical outside runs of (within-rtol) equal scores, sets inside."""
    np.testing.assert_array_equal(got["n_fragments"], want["n_fragments"])
    assert got["n_fragments"].dtype == np.int32
    np.testing.assert_allclose(got["top_scores"], want["top_scores"], rtol=RTOL)
    assert got["top_docs"].shape == want["top_docs"].shape
    for docs, ref_docs, scores in zip(got["top_docs"], want["top_docs"], want["top_scores"]):
        i = 0
        while i < len(scores):
            j = i + 1
            while j < len(scores) and np.isclose(scores[j], scores[i], rtol=RTOL, atol=0):
                j += 1
            assert sorted(docs[i:j].tolist()) == sorted(ref_docs[i:j].tolist()), (i, j, docs, ref_docs)
            i = j


def _serve_kw(c, top_k=CFG.top_k, **extra):
    return dict(max_distance=D, n_clusters=c, window_len=N, top_k=top_k, **extra)


@pytest.mark.parametrize("compute_dtype", ["uint8", "int32"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serve_step_equals_reference(seed, compute_dtype):
    """reduced_spec's serve_online widths, with out-of-range postings and
    padded clusters: covers fire, and every output equals the reference."""
    post, cd, mult = _inputs(np.random.default_rng(seed), B, P, C)
    kw = _serve_kw(C, compute_dtype=compute_dtype)
    want = _ref(ref_serve_step, post, cd, mult, **kw)
    got = _port(serve_step, post, cd, mult, **kw)
    assert want["n_fragments"].sum() > 0
    assert_topk_agree(got, want)
    np.testing.assert_array_equal(got["top_docs"], _port(serve_step_plain, post, cd, mult, **kw)["top_docs"])


def _edge_postings(case):
    """One query's postings exercising the reference's scatter index rule
    (C 4, L 4, N 32: a row of 512 slots)."""
    c, l, n = 4, 4, 32
    base = [(1, 5, 0), (1, 7, 1), (1, 9, 2), (2, 0, 0), (2, 2, 1), (2, 3, 2)]
    extra = {
        # negative fields are not ``ok``: they write nothing
        "negative": [(-1, 6, 0), (1, -1, 1), (1, 8, -1), (-5, -5, -5)],
        # cl >= C is dropped; lem >= L aliases into the next cluster's rows;
        # pos >= N is not ``ok``
        "past-end": [(c, 6, 0), (c + 7, 0, 0), (0, 6, l), (0, 4, l + 1), (3, 6, l), (1, n, 0), (1, n + 9, 2)],
        # an int32 index that wraps negative counts once from the end; one
        # that wraps below -(C*L*N) is dropped
        "wrap-negative": [((1 << 25) - 1, 27, 3), ((1 << 25) - 1, 28, 3), ((1 << 24), 0, 0),
                          ((1 << 25) - 1, 31, 3)],
        # a huge lemma index: (cl*L + lem)*N wraps as well
        "lemma-wrap": [(0, 3, (1 << 26) - 1), (1, 4, (1 << 26)), (3, 5, (1 << 27) - 3)],
    }[case]
    # query 1 (lemmas 0 and 3) has lemma 0 beside the slots the aliased and
    # wrapped indices reach, so each of them decides a fragment
    base1 = [(3, 26, 0), (3, 30, 0), (1, 2, 0), (1, 8, 0), (2, 5, 0), (0, 1, 3)]
    post = np.full((2, 16, 3), -1, np.int32)
    post[0, : len(base)] = base
    post[0, len(base): len(base) + len(extra)] = extra
    post[1, : len(base1)] = base1
    post[1, len(base1): len(base1) + len(extra)] = extra
    cd = np.array([[10, 11, 12, 13], [20, -1, 22, 23]], np.int32)
    mult = np.array([[1, 1, 1, 0], [1, 0, 0, 1]], np.int32)
    return post, cd, mult, c


@pytest.mark.parametrize("case", ["negative", "past-end", "wrap-negative", "lemma-wrap"])
def test_serve_step_index_rule_equals_reference(case):
    post, cd, mult, c = _edge_postings(case)
    kw = dict(max_distance=2, n_clusters=c, window_len=32, top_k=4)
    want = _ref(ref_serve_step, post, cd, mult, **kw)
    got = _port(serve_step, post, cd, mult, **kw)
    assert_topk_agree(got, want)
    np.testing.assert_array_equal(got["top_docs"], want["top_docs"])


def test_all_padded_and_empty_queries_keep_the_reference_tie_order():
    """Padded clusters all score -1.0 and empty ones 0.0: ``lax.top_k``
    puts the lower cluster first, and so does the port."""
    rng = np.random.default_rng(5)
    post, cd, mult = _inputs(rng, 4, 64, 8)
    cd[0] = -1  # every cluster padded
    post[1] = -1  # no postings: every live cluster scores 0.0
    cd[2, ::2] = -1
    post[2] = -1
    kw = _serve_kw(8, top_k=8)
    want = _ref(ref_serve_step, post, cd, mult, **kw)
    got = _port(serve_step, post, cd, mult, **kw)
    np.testing.assert_array_equal(got["top_docs"], want["top_docs"])
    np.testing.assert_array_equal(got["top_scores"], want["top_scores"])
    assert (got["top_scores"][0] == -1.0).all() and (got["top_scores"][1] == 0.0).all()
    np.testing.assert_array_equal(got["top_docs"][2], np.r_[cd[2, 1::2], cd[2, ::2]])


@pytest.mark.parametrize("ns", [1, 2, 4])
def test_serve_step_sharded_equals_reference(ns):
    """reduced_spec's serve_online cut into NS shards as ``launch/steps``
    cuts it (C_loc = ceil(max(C, NS)/NS), P_loc = ceil(P/NS)); the
    reference runs its vmap fallback."""
    c_loc, p_loc = max(1, -(-max(C, ns) // ns)), max(1, -(-P // ns))
    rng = np.random.default_rng(10 + ns)
    parts = [_inputs(rng, B, p_loc, c_loc) for _ in range(ns)]
    post = np.stack([p[0] for p in parts])
    cd = np.stack([p[1] for p in parts])
    mult = parts[0][2]
    kw = _serve_kw(c_loc)
    want = _ref(ref_serve_step_sharded, post, cd, mult, **kw)
    got = _port(serve_step_sharded, post, cd, mult, **kw)
    assert want["n_fragments"].sum() > 0
    assert_topk_agree(got, want)
    plain = _port(serve_step_sharded_plain, post, cd, mult, **kw)
    for k in got:
        np.testing.assert_array_equal(got[k], plain[k])


@pytest.mark.parametrize("top_k", [3, 16])
def test_sharded_fold_equals_a_per_shard_loop(top_k):
    """One folded program over every shard equals serve_step run shard by
    shard and the per-shard top-k lists merged by a stable sort."""
    ns, c_loc = 4, 5
    rng = np.random.default_rng(top_k)
    parts = [_inputs(rng, 3, 40, c_loc) for _ in range(ns)]
    post = np.stack([p[0] for p in parts])
    cd = np.stack([p[1] for p in parts])
    cd[1, :, :2] = cd[0, :, :2]  # the same docs on two shards: ties across shards
    mult = parts[0][2]
    kw = _serve_kw(c_loc, top_k=top_k)
    got = _port(serve_step_sharded, post, cd, mult, **kw)
    kk = min(top_k, c_loc)
    per = [_port(serve_step, post[s], cd[s], mult, **{**kw, "top_k": kk}) for s in range(ns)]
    docs = np.concatenate([o["top_docs"] for o in per], axis=1)
    scores = np.concatenate([o["top_scores"] for o in per], axis=1)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :min(top_k, ns * kk)]
    np.testing.assert_array_equal(got["top_docs"], np.take_along_axis(docs, order, axis=1))
    np.testing.assert_array_equal(got["top_scores"], np.take_along_axis(scores, order, axis=1))
    np.testing.assert_array_equal(got["n_fragments"], sum(o["n_fragments"] for o in per))


def test_serving_step_sharded_host_fallback():
    """The reference's own sharded test (``tests/test_system.py``), through
    the port: shapes, descending scores, and equal to the reference."""
    rng = np.random.default_rng(4)
    ns, b, p, c, l, n = 4, 2, 64, 8, 4, 128
    postings = np.full((ns, b, p, 3), -1, np.int32)
    for s in range(ns):
        for q in range(b):
            k = 24
            postings[s, q, :k, 0] = rng.integers(0, c, k)
            postings[s, q, :k, 1] = rng.integers(0, n, k)
            postings[s, q, :k, 2] = rng.integers(0, 2, k)
    cluster_doc = rng.integers(0, 500, (ns, b, c)).astype(np.int32)
    mult = np.tile([1, 1, 0, 0], (b, 1)).astype(np.int32)
    kw = dict(max_distance=5, n_clusters=c, window_len=n, top_k=8)
    got = _port(serve_step_sharded, postings, cluster_doc, mult, **kw)
    assert got["top_docs"].shape == (b, 8)
    assert got["top_scores"].shape == (b, 8)
    assert (np.diff(got["top_scores"], axis=1) <= 1e-9).all()  # sorted descending
    assert_topk_agree(got, _ref(ref_serve_step_sharded, postings, cluster_doc, mult, **kw))


@pytest.mark.parametrize("n_buckets", [1024, 1000])
@pytest.mark.parametrize("max_distance", [1, 3, 5])
def test_build_step_equals_reference(max_distance, n_buckets):
    """Bit-equal histogram and total, with negative tokens (the uint32 view
    wraps them), a bucket count that is not a power of two (so every bit of
    the uint32 hash counts) and a stream shorter than a window."""
    seed = max_distance
    rng = np.random.default_rng(seed)
    toks = rng.integers(-(2**31), 2**31 - 1, (5, 96)).astype(np.int32)
    toks[:, ::3] = rng.integers(-5, 60, (5, 32))
    stop = (toks < 30) & (toks > -(2**30)) | (rng.random(toks.shape) < 0.3)
    for t, s in ((toks, stop), (toks[:, : max_distance + 1], stop[:, : max_distance + 1])):
        want = _ref(ref_build_step, t, s, max_distance=max_distance, n_buckets=n_buckets)
        got = _port(build_step, t, s, max_distance=max_distance, n_buckets=n_buckets)
        np.testing.assert_array_equal(got["bucket_histogram"], want["bucket_histogram"])
        assert got["bucket_histogram"].dtype == np.int32
        assert int(got["n_postings"]) == int(want["n_postings"])


def test_build_step_counts_match_bruteforce():
    """The reference's brute-force count (``tests/test_system.py``)."""
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 50, (3, 64)).astype(np.int32)
    stop = toks < 20
    out = build_step(torch.from_numpy(toks), torch.from_numpy(stop), max_distance=3, n_buckets=256)
    cnt = 0
    d = 3
    for b in range(3):
        for p in range(64):
            if not stop[b, p]:
                continue
            for d1 in range(-d, d + 1):
                for d2 in range(-d, d + 1):
                    if d1 == 0 or d2 == 0 or not d1 < d2:
                        continue
                    if 0 <= p + d1 < 64 and 0 <= p + d2 < 64 and stop[b, p + d1] and stop[b, p + d2]:
                        cnt += 1
    assert int(out["n_postings"]) == cnt
    assert int(out["bucket_histogram"].sum()) == cnt


@pytest.fixture(scope="module")
def port_small_index():
    """The port's index over ``conftest.small_corpus``'s documents and
    parameters."""
    store = synthesize_corpus(n_docs=50, doc_len=100, vocab_size=600, seed=11)
    return build_indexes(store, sw_count=60, fu_count=150, max_distance=5)


@pytest.mark.parametrize("query", ["who are you who", "what do you do all day"])
def test_serve_step_matches_engine_ranking(query, port_small_index, small_index, lemmatizer):
    """The port of ``tests/test_serving_integration.py``: clusters ==
    documents, the packed events are serve_step's postings; the top docs and
    scores equal §14 ranking of the scalar Combiner's fragments, and the
    outputs equal the reference's serve_step on the reference's packing."""
    sub = expand_subqueries(query, Lemmatizer())[0]
    packed = pack_subquery_events(sub, port_small_index, doc_len=128, device="cpu")
    ref_packed = ref_pack_subquery_events(ref_expand(query, lemmatizer)[0], small_index, doc_len=128)
    assert packed is not None
    np.testing.assert_array_equal(packed.events, ref_packed.events)
    n_docs = len(packed.doc_ids)
    arrays = (packed.events[None], packed.doc_ids[None].astype(np.int32), packed.mult[None])
    kw = dict(max_distance=port_small_index.max_distance, n_clusters=n_docs, window_len=128,
              top_k=min(8, n_docs))
    out = _port(serve_step, *arrays, **kw)
    top_docs = [int(d) for d in out["top_docs"][0] if d >= 0]
    top_scores = out["top_scores"][0]

    results, _ = se24_combiner(sub, port_small_index)
    ranked = rank_documents(results, top_k=len(top_docs))
    exp_docs = [d for d, _, _ in ranked]
    exp_scores = np.array([s for _, s, _ in ranked])
    k = min(len(exp_docs), len(top_docs))
    assert k > 0
    assert top_docs[:k] == exp_docs[:k]
    np.testing.assert_allclose(top_scores[:k], exp_scores[:k], rtol=RTOL)
    assert_topk_agree(out, _ref(ref_serve_step, *arrays, **kw))


def test_serve_step_fragment_counts(port_small_index, small_index, lemmatizer):
    """``n_fragments`` equals the scalar Combiner's fragment count, in both
    packages."""
    sub = expand_subqueries("who are you who", Lemmatizer())[0]
    packed = pack_subquery_events(sub, port_small_index, doc_len=128, device="cpu")
    arrays = (packed.events[None], packed.doc_ids[None].astype(np.int32), packed.mult[None])
    kw = dict(max_distance=port_small_index.max_distance, n_clusters=len(packed.doc_ids),
              window_len=128, top_k=4)
    out = _port(serve_step, *arrays, **kw)
    results, _ = se24_combiner(sub, port_small_index)
    ref_results, _ = ref_se24_combiner(ref_expand("who are you who", lemmatizer)[0], small_index)
    assert int(out["n_fragments"][0]) == len(results) == len(ref_results) > 0
