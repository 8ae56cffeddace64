"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the serving path's shapes, and the port's serving path on the card (the
host route and the posting arena) against the host route on the CPU.

Every test here needs a CUDA device: each is marked ``gpu`` and skips (in a
fixture, at run time) where there is none.  This file imports neither jax
nor the reference package, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.index import build_indexes, synthesize_corpus
from repro_torch.kernels import (
    ARENA_BLOCK,
    PAD,
    gather_blocks,
    gather_blocks_plain,
    intersect_sorted,
    intersect_sorted_plain,
    intersect_sorted_segments,
    pack_segments,
    proximity_window,
    proximity_window_plain,
)
from repro_torch.search import SearchRequest, ServingFrontend
from repro_torch.search.arena import PostingArena
from repro_torch.search import fused
from repro_torch.search.fused import intersect_inputs

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["uint8", "int32"])
def test_proximity_kernel_equals_plain_at_serving_shape(cuda, dtype):
    rng = np.random.default_rng(0)
    occ = torch.from_numpy((rng.random((32768, 8, 512)) < 0.1).astype(np.uint8)).to(cuda)
    mult = torch.from_numpy(rng.integers(0, 3, (32768, 8)).astype(np.int32)).to(cuda)
    launches = proximity_window.launches
    emit, start = proximity_window(occ, mult, 5, compute_dtype=dtype)
    assert proximity_window.launches == launches + 1
    p_emit, p_start = proximity_window_plain(occ, mult, 5, compute_dtype=dtype)
    assert torch.equal(emit, p_emit)
    assert torch.equal(torch.where(p_emit, start, 0), torch.where(p_emit, p_start, 0))


def _mixed_cover_inputs(rng, b, l, n, window, dtype):
    """Rows cycling through sparse 0/1, dense 0/1, 0/1 with events only at
    e < window, and arbitrary values that wrap in the compute type; awkward
    multiplicities (0, negative, above the window, 256)."""
    occ = (rng.random((b, l, n)) < np.array([0.1, 0.5, 0.3, 0.0])[np.arange(b) % 4, None, None])
    occ = occ.astype(np.int64)
    occ[2::4, :, window:] = 0
    if dtype == "uint8":
        wild = rng.integers(0, 256, (b, l, n))
    else:
        wild = rng.choice([-(2**31), -3, -1, 0, 1, 2, 3, 2**31 - 1], (b, l, n))
    occ[3::4] = wild[3::4]
    mult = rng.choice([0, 1, 1, 1, 2, 2, 3, -1, -5, window, window + 1, 64, 65, 255, 256],
                      (b, l))
    return occ.astype(np.int32), mult.astype(np.int32)


@pytest.mark.parametrize("dtype", ["uint8", "int32"])
@pytest.mark.parametrize("n", [1, 7, 128, 200, 513, 520, 1030, 4096])
def test_proximity_kernel_equals_plain_on_any_input(cuda, dtype, n):
    """Both branches of the kernel in one launch (0/1 rows take the bit
    path, rows with other values the general path), ragged N, windows 1 to
    63: emit and start equal everywhere."""
    rng = np.random.default_rng(n)
    for max_distance in (0, 1, 2, 5, 15, 31):
        for l in (1, 3, 8):
            occ_np, mult_np = _mixed_cover_inputs(rng, 8, l, n, 2 * max_distance + 1, dtype)
            occ, mult = torch.from_numpy(occ_np).to(cuda), torch.from_numpy(mult_np).to(cuda)
            emit, start = proximity_window(occ, mult, max_distance, compute_dtype=dtype)
            p_emit, p_start = proximity_window_plain(occ, mult, max_distance, compute_dtype=dtype)
            assert torch.equal(emit, p_emit), (max_distance, l)
            assert torch.equal(start, p_start), (max_distance, l)


@pytest.mark.parametrize("n_chunks", [1, 2, 32])
def test_intersect_kernel_equals_plain_at_serving_shape(cuda, n_chunks):
    rng = np.random.default_rng(1)
    a_docs = np.sort(rng.choice(8192, 5500, replace=False)).astype(np.int32)
    b_docs = np.sort(rng.choice(8192, 5600, replace=False)).astype(np.int32)
    a_p, b_p, off_p, _ = intersect_inputs(a_docs, b_docs)
    a, b, off = (torch.from_numpy(x).to(cuda) for x in (a_p, b_p, off_p))
    launches = intersect_sorted.launches
    got = intersect_sorted(a, b, off, n_chunks=n_chunks)
    assert intersect_sorted.launches == launches + 1
    assert torch.equal(got, intersect_sorted_plain(a, b, off, n_chunks=n_chunks))


def _any_offsets(na, nb, n_chunks):
    """``tests/test_torch_kernels.py``'s ``_model_inputs("any-offsets", ...)``
    (same seed): sorted a and b padded with PAD, block offsets anywhere —
    -1 and -257 first (floor and truncating division differ there, and a
    negative first tile wraps to the end), below 0, past the end,
    unaligned."""
    rng = np.random.default_rng(na + nb + n_chunks)
    a = np.sort(rng.integers(0, 3 * nb, na)).astype(np.int32)
    a[-rng.integers(1, 40):] = PAD
    b = np.sort(rng.integers(0, 3 * nb, nb)).astype(np.int32)
    b[-rng.integers(1, 64):] = PAD
    off = rng.integers(-3 * 256, nb + 3 * 256, na // 128).astype(np.int32)
    off[:2] = -1, -257
    return a, b, off, n_chunks


def _serving_segments(rng, kind):
    """Pairs of 4,100-6,000 docs out of 8,192, padded as the planner pads
    them, with mixed n_chunks: the planner's own, 1 (partial), twice it and
    the whole list.  "unsorted" reverses a span of one b; "global" adds a
    16,384-element b searched whole, a window above the kernel's
    shared-memory budget, sorted and unsorted.  "any-offsets" is the CPU
    tests' arbitrary-offset pairs instead."""
    if kind == "any-offsets":
        return [_any_offsets(*shape) for shape in
                ((512, 1024, 1), (1024, 2048, 2), (256, 2048, 3), (384, 256, 2), (1024, 4096, 16))]
    n = {"round1": 6, "round2": 3, "unsorted": 4, "global": 2}[kind]
    segments = []
    for k in range(n):
        a_docs, b_docs = (np.sort(rng.choice(8192, rng.integers(4100, 6000), replace=False))
                          .astype(np.int32) for _ in range(2))
        a_p, b_p, off_p, n_chunks = intersect_inputs(a_docs, b_docs)
        n_chunks = (n_chunks, 1, 2 * n_chunks, len(b_p) // 256)[k % 4]
        segments.append((a_p, b_p, off_p, n_chunks))
    if kind == "unsorted":
        b_p = segments[1][1].copy()
        b_p[:1500] = b_p[:1500][::-1]
        segments[1] = (segments[1][0], b_p, segments[1][2], segments[1][3])
    if kind == "global":
        for reverse in (False, True):
            b_docs = np.sort(rng.choice(20000, 16000, replace=False)).astype(np.int32)
            a_docs = np.sort(rng.choice(20000, 5000, replace=False)).astype(np.int32)
            a_p, b_p, off_p, _ = intersect_inputs(a_docs, b_docs)
            if reverse:
                b_p[100:9000] = b_p[100:9000][::-1]
            segments.append((a_p, b_p, off_p, len(b_p) // 256))
    return segments


@pytest.mark.parametrize("kind", ["round1", "round2", "unsorted", "global", "any-offsets"])
def test_intersect_segments_kernel_equals_plain(cuda, kind):
    """One launch over every segment, each equal to the plain version of
    that segment alone with its own n_chunks."""
    segments = _serving_segments(np.random.default_rng(len(kind)), kind)
    buf, pack = pack_segments(segments)
    buf = buf.to(cuda)
    launches = intersect_sorted.launches
    got = intersect_sorted_segments(buf, pack)
    assert intersect_sorted.launches == launches + 1
    for s, mask in enumerate(pack.split(got)):
        a, b, off = pack.segment(buf, s)
        assert torch.equal(mask, intersect_sorted_plain(a, b, off, n_chunks=pack.n_chunks[s])), s


def test_intersect_candidates_many_on_card_equals_cpu(cuda):
    """The batch's folds in rounds on the card: the CPU's candidates, one
    launch per round."""
    rng = np.random.default_rng(5)
    core = rng.choice(8192, 64, replace=False)
    items = [
        [np.unique(np.concatenate([core, rng.choice(8192, rng.integers(4100, 6000), replace=False)]))
         .astype(np.int32) for _ in range(n)]
        for n in (2, 3, 2, 4, 3, 2)
    ]
    want = fused.intersect_candidates_many(items, device_threshold=1, device="cpu")
    launches = intersect_sorted.launches
    fused.reset_dispatch_count()
    got = fused.intersect_candidates_many(items, device_threshold=1, device=cuda)
    assert fused.dispatch_count() == intersect_sorted.launches - launches == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_gather_kernel_equals_plain_at_serving_shape(cuda):
    """8,192 output blocks over a 16,384-block arena: repeated sources,
    padded blocks, sources past either end, every n_valid kind."""
    rng = np.random.default_rng(2)
    g, nb = 8192, 16384
    arena = torch.from_numpy(rng.integers(-1, 1 << 20, (nb * ARENA_BLOCK, 2)).astype(np.int32)).to(cuda)
    src = rng.integers(0, nb, g).astype(np.int32)
    src[::7] = src[0]
    src[-64:] = 0
    src[1], src[2] = -5, nb + 5
    nv = rng.choice([0, 1, 63, 64, 127, ARENA_BLOCK, ARENA_BLOCK + 3], g).astype(np.int32)
    nv[-64:] = 0
    src_t, nv_t = torch.from_numpy(src).to(cuda), torch.from_numpy(nv).to(cuda)
    launches = gather_blocks.launches
    got = gather_blocks(arena, src_t, nv_t)
    assert gather_blocks.launches == launches + 1
    assert torch.equal(got, gather_blocks_plain(arena, src_t, nv_t))


def test_frontend_on_card_equals_cpu(cuda):
    store = synthesize_corpus(n_docs=120, doc_len=150, vocab_size=600, seed=3)
    index = build_indexes(store, sw_count=60, fu_count=150, max_distance=5)
    requests = [SearchRequest(q, top_k=1000) for q in
                ("who are you who", "to be or not to be", "time and time again")]

    def run(**kw):
        resps = ServingFrontend(index, lemmatizer=store.lemmatizer, **kw).search_many(requests)
        return [[(d.doc_id, d.score, [(f.start, f.end) for f in d.fragments]) for d in r.docs]
                for r in resps]

    want = run(device="cpu")
    for use_kernel, with_arena in ((False, False), (True, False), (False, True), (True, True)):
        kw = {"arena": PostingArena(device="cuda")} if with_arena else {}
        launches = gather_blocks.launches
        got = run(device="cuda", use_kernel=use_kernel, **kw)
        if with_arena and use_kernel:
            assert gather_blocks.launches > launches
        assert [[(d, f) for d, _, f in r] for r in got] == [[(d, f) for d, _, f in r] for r in want]
        for g, w in zip(got, want):
            # float32 row sums never reach the ranking: rank_documents sums
            # the same fragments in the same order on both devices
            assert [s for _, s, _ in g] == [s for _, s, _ in w]
