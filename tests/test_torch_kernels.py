"""The port's kernels (``repro_torch.kernels``) against the reference's Pallas
kernels (interpret mode) and jnp oracles, on the same numpy inputs.

On the CPU each wrapper takes its plain PyTorch version, so these tests hold
the plain versions to the TPU kernels' semantics bit for bit: emit equal and
start equal where emit, the intersect tiles' partial coverage included.
The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.window import window_cover as ref_window_cover
from repro.kernels.gather import gather_blocks as ref_gather_blocks
from repro.kernels.gather import gather_blocks_ref as ref_gather_blocks_ref
from repro.kernels.intersect import block_offsets as ref_block_offsets
from repro.kernels.intersect import intersect_sorted as ref_intersect_sorted
from repro.kernels.ops import proximity_search_scores as ref_search_scores
from repro.kernels.proximity import proximity_window as ref_proximity_window
from repro.kernels.ref import fragment_scores_ref as ref_fragment_scores
from repro.kernels.ref import intersect_ref as ref_intersect_ref
from repro_torch.core.window import window_cover
from repro_torch.kernels import (
    ARENA_BLOCK,
    PAD,
    block_offsets,
    fragment_scores_ref,
    gather_blocks,
    gather_blocks_plain,
    intersect_ref,
    intersect_sorted,
    intersect_sorted_plain,
    intersect_sorted_segments,
    pack_segments,
    proximity_search_scores,
    proximity_window,
)


def _assert_cover_equal(emit, start, ref_emit, ref_start):
    emit, start = emit.numpy(), start.numpy()
    ref_emit, ref_start = np.asarray(ref_emit), np.asarray(ref_start)
    np.testing.assert_array_equal(emit, ref_emit)
    np.testing.assert_array_equal(np.where(ref_emit, start, 0), np.where(ref_emit, ref_start, 0))


@pytest.mark.parametrize("b,l,n", [(1, 4, 128), (3, 8, 256), (2, 2, 512), (5, 8, 128)])
@pytest.mark.parametrize("max_distance", [2, 5, 7])
@pytest.mark.parametrize("dtype", ["int32", "uint8"])
def test_proximity_plain_equals_pallas_kernel(b, l, n, max_distance, dtype):
    rng = np.random.default_rng(b * 1000 + l * 10 + max_distance)
    occ = (rng.random((b, l, n)) < 0.1).astype(np.int32)
    mult = np.zeros((b, l), np.int32)
    active = rng.integers(1, l + 1)
    mult[:, :active] = rng.integers(1, 3, (b, active))
    ref_emit, ref_start = ref_proximity_window(
        jnp.asarray(occ), jnp.asarray(mult), max_distance, compute_dtype=dtype
    )
    emit, start = proximity_window(
        torch.from_numpy(occ), torch.from_numpy(mult), max_distance, compute_dtype=dtype
    )
    assert emit.dtype == torch.bool and start.dtype == torch.int32
    _assert_cover_equal(emit, start, ref_emit, ref_start)


@pytest.mark.parametrize("dtype", ["int32", "uint8"])
def test_proximity_plain_wraps_like_pallas_kernel(dtype):
    """Occupancy values beyond 0/1 and multiplicities beyond the compute
    dtype: both sides count modulo the dtype's width."""
    rng = np.random.default_rng(17)
    if dtype == "uint8":
        occ = rng.integers(0, 256, (3, 4, 128)).astype(np.int32)
    else:
        occ = rng.integers(-(2**31), 2**31, (3, 4, 128), dtype=np.int64).astype(np.int32)
    mult = rng.integers(-2, 300, (3, 4)).astype(np.int32)
    ref_emit, ref_start = ref_proximity_window(
        jnp.asarray(occ), jnp.asarray(mult), 5, compute_dtype=dtype
    )
    emit, start = proximity_window(torch.from_numpy(occ), torch.from_numpy(mult), 5, compute_dtype=dtype)
    assert np.asarray(ref_emit).any()
    _assert_cover_equal(emit, start, ref_emit, ref_start)


@pytest.mark.parametrize("dtype", [np.int32, np.uint8])
def test_window_cover_equals_jnp_reference(dtype):
    rng = np.random.default_rng(9)
    occ = (rng.random((3, 200)) < 0.15).astype(dtype)
    mult = np.array([1, 2, 1], np.int32)
    emit, start = window_cover(torch.from_numpy(occ), torch.from_numpy(mult), 9)
    ref_emit, ref_start = ref_window_cover(jnp.asarray(occ), jnp.asarray(mult), 9)
    assert np.asarray(ref_emit).any()
    _assert_cover_equal(emit, start, ref_emit, ref_start)


def test_proximity_rejects_what_the_kernel_cannot_hold():
    occ = torch.zeros((1, 2, 64), dtype=torch.uint8)
    mult = torch.ones((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot hold"):
        proximity_window(occ, mult, 200, compute_dtype="uint8")
    with pytest.raises(ValueError, match="compute_dtype"):
        proximity_window(occ, mult, 5, compute_dtype="uint16")
    with pytest.raises(ValueError, match="cuda or cpu"):
        proximity_window(occ.to("meta"), mult.to("meta"), 5)


# ---- a numpy model of the cover kernel's bit path ---------------------------
# The CUDA kernel takes this path on tiles whose occupancy is all 0/1.  The
# model mirrors it step for step — words of 32 positions (bit i <-> position
# base + i) after a 64-position zero halo; per position, a 32-bit window
# (window <= 32) or a 64-bit one from the word holding e and the words
# before it by funnel shift, e at the top bit and e - o at o bits below;
# o_l = the offset of the lemma's m-th occurrence counting down from e: for
# m <= 2 from the unmasked window at the first of each thread's 8
# positions, followed along the rest (_nearest_m); for m > 2 the
# leading-zero count of the window masked to o < window after dropping its
# m - 1 highest set bits, or the window's width where the popcount is below
# m; o* = max over active lemmas covers where it is below the window — and
# is held to the reference's Pallas kernel and its jnp cover, emit and
# start at every position.

_HALO = 64
_U32 = np.uint64(0xFFFFFFFF)


def _clz(x, n_bits):
    """Leading zeros of the ``n_bits``-bit values ``x`` (uint64)."""
    out = np.zeros(x.shape, np.int64)
    for i in range(n_bits):
        out += (x >> np.uint64(i)) == 0
    return out


def _nearest_m(r, here, m, n_bits):
    """The offset of the m-th occurrence counting back from each position:
    at the first of each thread's 8 positions from its unmasked window (the
    nearer occurrences shifted out; n_bits or more where it holds fewer),
    at the later ones an occurrence there becomes the nearest and moves the
    others one rank back, all offsets growing by one."""
    out = np.zeros(len(r), np.int64)
    full = (1 << n_bits) - 1
    for e in range(len(r)):
        if e % 8 == 0:
            o, used, rest = [], 0, int(r[e])
            for _ in range(m):
                z = n_bits - rest.bit_length()
                o.append(used + z)
                used += z + 1
                rest = (rest << (z + 1)) & full if z + 1 < n_bits else 0
        else:
            o = [0 if here[e] else o[0] + 1] + [(o[k - 1] if here[e] else o[k]) + 1 for k in range(1, m)]
        out[e] = o[m - 1]
    return out


def _bit_path_model(occ, mult, max_distance, dtype):
    window = 2 * max_distance + 1
    n_bits = 32 if window <= 32 else 64
    top = np.uint64(1 << (n_bits - 1))
    b, n_lemmas, n = occ.shape
    m_all = mult.astype(np.int64)
    if dtype == "uint8":
        m_all = m_all & 0xFF  # mult in the compute type, as the kernel reads it
    n_words = (_HALO + n + 31) // 32
    pos = np.arange(n)
    j = _HALO + pos
    wi, sh = j >> 5, (31 - (j & 31)).astype(np.uint64)
    wmask = np.uint64(((1 << window) - 1) << (n_bits - window))  # the top `window` bits
    emit = np.zeros((b, n), bool)
    start = np.zeros((b, n), np.int64)
    for row in range(b):
        o_star = np.zeros(n, np.int64)
        event = np.zeros(n, bool)
        for lem in range(n_lemmas):
            m = int(m_all[row, lem])
            if m <= 0:
                continue  # inactive lemma slot
            bits = np.zeros(n_words * 32, np.uint64)
            bits[_HALO:_HALO + n] = occ[row, lem] != 0
            words = (bits.reshape(n_words, 32) << np.arange(32, dtype=np.uint64)).sum(axis=1)
            wa, wb, wc = words[wi - 2], words[wi - 1], words[wi]
            r = ((wc << np.uint64(32) | wb) << sh >> np.uint64(32)) & _U32  # funnel shift left
            if n_bits == 64:
                r = r << np.uint64(32) | (((wb << np.uint64(32) | wa) << sh >> np.uint64(32)) & _U32)
            event |= (r & top) != 0
            if m <= 2:
                o_l = _nearest_m(r, occ[row, lem] != 0, m, n_bits)
            else:
                r &= wmask
                ok = np.bitwise_count(r) >= m
                for _ in range(min(m, n_bits + 1) - 1):  # drop the m - 1 nearest occurrences
                    nearest = top >> np.minimum(_clz(r, n_bits), n_bits - 1).astype(np.uint64)
                    r = np.where(ok, r ^ nearest, r)
                o_l = np.where(ok, _clz(r, n_bits), n_bits)
            o_star = np.maximum(o_star, o_l)
        cover = o_star < window
        emit[row] = cover & event
        start[row] = pos - np.where(cover, o_star, 0)
    return emit, start


_AWKWARD_MULT = [0, 1, 1, 2, 3, -1, -7, 64, 65, 255, 256, 300]


def _bit_path_inputs(n, max_distance, n_lemmas, seed):
    """Four rows of 0/1 occupancy: sparse, dense, events only at e < window,
    very sparse; row 0 has one active lemma of multiplicity 1, the others
    draw multiplicities from 0, negative values, values above the window
    and 256."""
    window = 2 * max_distance + 1
    rng = np.random.default_rng(seed)
    density = np.array([0.1, 0.4, 0.5, 0.03])[:, None, None]
    occ = (rng.random((4, n_lemmas, n)) < density).astype(np.int32)
    occ[2, :, window:] = 0
    mult = rng.choice(_AWKWARD_MULT, (4, n_lemmas)).astype(np.int32)
    mult[:, 0] = rng.integers(1, 3, 4)
    mult[1, -1] = window + 1  # above the window: never covers
    mult[0] = 0
    mult[0, 0] = 1
    return occ, mult


_BIT_PATH_CASES = [
    (n, md, (1, 3, 8)[i % 3], ("uint8", "int32")[i % 2])
    for i, (n, md) in enumerate((n, md) for n in (128, 200, 520, 4096) for md in (0, 1, 5, 31))
] + [
    (128, 31, 8, "uint8"), (200, 5, 8, "uint8"), (520, 0, 3, "int32"), (520, 31, 1, "uint8"),
    (4096, 5, 3, "uint8"), (200, 1, 1, "int32"), (128, 5, 3, "int32"), (520, 5, 8, "int32"),
]


@pytest.mark.parametrize("n,max_distance,n_lemmas,dtype", _BIT_PATH_CASES)
def test_bit_path_model_equals_reference(n, max_distance, n_lemmas, dtype):
    occ, mult = _bit_path_inputs(n, max_distance, n_lemmas, seed=n * 100 + max_distance * 10 + n_lemmas)
    emit, start = _bit_path_model(occ, mult, max_distance, dtype)
    ref_emit, ref_start = ref_proximity_window(
        jnp.asarray(occ), jnp.asarray(mult), max_distance, compute_dtype=dtype
    )
    assert np.asarray(ref_emit)[0].any()
    np.testing.assert_array_equal(emit, np.asarray(ref_emit))
    np.testing.assert_array_equal(start, np.asarray(ref_start))
    occ_c = occ.astype(np.uint8) if dtype == "uint8" else occ
    cover = jax.jit(ref_window_cover, static_argnums=2)
    for row in range(occ.shape[0]):
        w_emit, w_start = cover(jnp.asarray(occ_c[row]), jnp.asarray(mult[row]), 2 * max_distance + 1)
        np.testing.assert_array_equal(emit[row], np.asarray(w_emit))
        np.testing.assert_array_equal(start[row], np.asarray(w_start))
    p_emit, p_start = proximity_window(
        torch.from_numpy(occ), torch.from_numpy(mult), max_distance, compute_dtype=dtype
    )
    np.testing.assert_array_equal(p_emit.numpy(), emit)
    np.testing.assert_array_equal(p_start.numpy(), start)


def _sorted_lists(na, nb, univ, seed):
    rng = np.random.default_rng(seed)
    a_real = np.sort(rng.choice(univ, min(na - 16, univ - 1), replace=False)).astype(np.int32)
    b_real = np.sort(rng.choice(univ, min(nb - 32, univ - 1), replace=False)).astype(np.int32)
    a = np.concatenate([a_real, np.full(na - len(a_real), PAD, np.int32)])
    b = np.concatenate([b_real, np.full(nb - len(b_real), PAD, np.int32)])
    return a, b


@pytest.mark.parametrize(
    "na,nb,univ", [(128, 256, 1000), (512, 512, 800), (256, 1024, 10**6), (1024, 2048, 2500)]
)
@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_intersect_plain_equals_pallas_kernel_bitwise(na, nb, univ, n_chunks):
    """Same tile semantics as the TPU kernel: equal bit for bit, partial
    coverage (n_chunks * 256 < len(b)) included."""
    a, b = _sorted_lists(na, nb, univ, na + nb)
    off = block_offsets(a, b, 128, 256)
    np.testing.assert_array_equal(off, ref_block_offsets(a, b, 128, 256))
    want = np.asarray(
        ref_intersect_sorted(jnp.asarray(a), jnp.asarray(b), jnp.asarray(off), n_chunks=n_chunks)
    )
    got = intersect_sorted(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(off), n_chunks=n_chunks)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    full = intersect_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(full, np.asarray(ref_intersect_ref(jnp.asarray(a), jnp.asarray(b))))
    assert (got.numpy() <= full).all()  # never a false positive
    if n_chunks * 256 >= nb:
        np.testing.assert_array_equal(got.numpy(), full)


def test_intersect_rejects_unaligned_inputs():
    a = torch.zeros(100, dtype=torch.int32)
    b = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="len"):
        intersect_sorted(a, b, torch.zeros(1, dtype=torch.int32))
    a = torch.zeros(128, dtype=torch.int32)
    with pytest.raises(ValueError, match="n_chunks"):
        intersect_sorted(a, b, torch.zeros(1, dtype=torch.int32), n_chunks=0)


# segments of mixed sizes and n_chunks (1, 2, 4 and the full list) in one
# pack: (na, nb, universe, n_chunks); nb == 256 is a single-tile b, and
# n_chunks above nb / 256 clamps every window at the last tile
_SEGMENT_CASES = {
    "mixed": [(128, 256, 1000, 1), (512, 512, 800, 2), (256, 1024, 10**6, 4),
              (1024, 2048, 2500, "full"), (128, 256, 300, 4)],
    "partial": [(1024, 2048, 2500, 1), (512, 4096, 6000, 2), (2048, 1024, 3000, 1),
                (128, 512, 700, 4)],
    "single-tile": [(256, 256, 400, 1), (128, 256, 200, 2), (512, 256, 600, "full")],
}


@pytest.mark.parametrize("case", sorted(_SEGMENT_CASES))
def test_intersect_segments_plain_equals_pallas_kernel_bitwise(case):
    """One pack of segments, each with its own n_chunks: every segment's
    mask equals the TPU kernel's on that segment alone, bit for bit."""
    segments, want = [], []
    for k, (na, nb, univ, n_chunks) in enumerate(_SEGMENT_CASES[case]):
        a, b = _sorted_lists(na, nb, univ, 31 * k + na + nb)
        n_chunks = nb // 256 if n_chunks == "full" else n_chunks
        off = block_offsets(a, b, 128, 256)
        segments.append((a, b, off, n_chunks))
        want.append(np.asarray(
            ref_intersect_sorted(jnp.asarray(a), jnp.asarray(b), jnp.asarray(off), n_chunks=n_chunks)
        ))
    buf, pack = pack_segments(segments)
    out = intersect_sorted_segments(buf, pack)
    assert out.dtype == torch.int32 and tuple(out.shape) == (sum(pack.na),)
    for s, (got, ref) in enumerate(zip(pack.split(out), want)):
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"segment {s}")


def test_segment_pack_rejects_bad_layouts():
    a, b = _sorted_lists(128, 256, 300, 0)
    off = block_offsets(a, b, 128, 256)
    with pytest.raises(ValueError, match="len"):
        pack_segments([(a, b[:200], off, 1)])
    with pytest.raises(ValueError, match="offsets"):
        pack_segments([(a, b, off[:0], 1)])
    with pytest.raises(ValueError, match="n_chunks"):
        pack_segments([(a, b, off, 0)])
    buf, pack = pack_segments([(a, b, off, 1)])
    with pytest.raises(ValueError, match="buffer"):
        intersect_sorted_segments(buf[:-1], pack)
    assert intersect_sorted_segments(*pack_segments([])).numel() == 0


# ---- a numpy model of the segmented intersect kernel ------------------------
# Per a block, as csrc/intersect.cu runs it: the tile spans of the block's
# window (floor division of the offset; a negative first tile wraps to the
# end, so the window may be two spans in index order); the CTA's vote on
# whether every adjacent pair of the window is in order; a lower-bound
# binary search of each value over a sorted window (duplicates and PAD runs
# included), a linear compare over an unsorted one; PAD in a never hits.
# Held to the plain version on sorted and unsorted windows and any offsets.


def _window_spans(off, n_chunks, n_tiles, block_b):
    """The kernel's tile spans ``[(lo1, hi1), (lo2, hi2)]``; the second is
    empty (``hi2 < lo2``) unless a negative first tile wraps to the end."""
    first, last = off // block_b, n_tiles - 1
    end = first + n_chunks - 1
    if first >= 0:
        return [(min(first, last), min(end, last)), (0, -1)]
    w_lo, w_hi = max(first + n_tiles, 0), max(min(end, -1) + n_tiles, 0)
    if end < 0:
        return [(w_lo, w_hi), (0, -1)]
    if w_lo <= min(end, last) + 1:
        return [(0, last), (0, -1)]
    return [(0, min(end, last)), (w_lo, w_hi)]


def _intersect_model(a, b, offsets, n_chunks, block_a=128, block_b=256):
    out = np.zeros(len(a), np.int32)
    unsorted_blocks = 0
    for blk, off in enumerate(offsets.tolist()):
        spans = _window_spans(off, n_chunks, len(b) // block_b, block_b)
        w = np.concatenate([b[lo * block_b : (hi + 1) * block_b] for lo, hi in spans]).astype(np.int64)
        v = a[blk * block_a : (blk + 1) * block_a].astype(np.int64)
        if (w[:-1] <= w[1:]).all():
            at, left = np.zeros(len(v), np.int64), np.full(len(v), len(w))
            while (left > 0).any():
                half = left >> 1
                right = (left > 0) & (w[np.minimum(at + half, len(w) - 1)] < v)
                at = np.where(right, at + half + 1, at)
                left = np.where(right, left - half - 1, half)
            hit = (at < len(w)) & (w[np.minimum(at, len(w) - 1)] == v)
        else:
            unsorted_blocks += 1
            hit = (v[:, None] == w[None, :]).any(axis=1)
        out[blk * block_a : (blk + 1) * block_a] = hit & (v != int(PAD))
    return out, unsorted_blocks


def _model_inputs(kind, na, nb, seed):
    """Sorted lists; duplicates and PAD runs inside b; offsets anywhere
    (below 0, past the end, unaligned); b with reversed and shuffled spans
    (unsorted windows)."""
    rng = np.random.default_rng(seed)
    a = np.sort(rng.integers(0, 3 * nb, na)).astype(np.int32)
    a[-rng.integers(1, 40):] = PAD
    b = np.sort(rng.integers(0, 3 * nb, nb)).astype(np.int32)
    if kind == "duplicates":
        b = np.sort(np.repeat(b[: nb // 4], 4))
        b[nb // 2 : nb // 2 + 300] = PAD
        b = np.sort(b)
    elif kind == "unsorted":
        b[: nb // 3] = b[: nb // 3][::-1]
        span = slice(nb // 2, nb // 2 + 200)
        b[span] = rng.permutation(b[span])
    b[-rng.integers(1, 64):] = PAD
    if kind == "any-offsets":
        off = rng.integers(-3 * 256, nb + 3 * 256, na // 128).astype(np.int32)
        off[:2] = -1, -257  # floor and truncating division differ here
    else:
        off = block_offsets(a, np.sort(b), 128, 256)
    return a, b.astype(np.int32), off


_MODEL_SHAPES = [(512, 1024, 1), (1024, 2048, 2), (256, 2048, 3), (384, 256, 2), (1024, 4096, 16)]


@pytest.mark.parametrize("kind", ["sorted", "duplicates", "unsorted", "any-offsets"])
@pytest.mark.parametrize("na,nb,n_chunks", _MODEL_SHAPES)
def test_intersect_kernel_model_equals_plain(kind, na, nb, n_chunks):
    a, b, off = _model_inputs(kind, na, nb, na + nb + n_chunks)
    got, unsorted_blocks = _intersect_model(a, b, off, n_chunks)
    want = intersect_sorted_plain(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(off),
                                  n_chunks=n_chunks)
    np.testing.assert_array_equal(got, want.numpy())
    if kind == "unsorted":
        assert unsorted_blocks > 0  # the linear-compare branch ran
    else:
        assert unsorted_blocks == 0


def test_fragment_scores_equal_jnp_oracle():
    rng = np.random.default_rng(4)
    emit = rng.random((4, 64)) < 0.3
    start = np.arange(64)[None, :] - rng.integers(0, 11, (4, 64))
    got = fragment_scores_ref(torch.from_numpy(emit), torch.from_numpy(start.astype(np.int32)))
    want = ref_fragment_scores(jnp.asarray(emit), jnp.asarray(start.astype(np.int32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_search_scores_equal_reference(use_kernel):
    rng = np.random.default_rng(7)
    occ = (rng.random((4, 8, 128)) < 0.12).astype(np.int32)
    mult = np.tile([1, 1, 2, 0, 0, 0, 0, 0], (4, 1)).astype(np.int32)
    emit, start, scores = proximity_search_scores(
        torch.from_numpy(occ), torch.from_numpy(mult), 5, use_kernel=use_kernel
    )
    r_emit, r_start, r_scores = ref_search_scores(
        jnp.asarray(occ), jnp.asarray(mult), 5, use_kernel=use_kernel
    )
    _assert_cover_equal(emit, start, r_emit, r_start)
    # float32 sums over 128 positions, in another order: rounding only
    np.testing.assert_allclose(scores.numpy(), np.asarray(r_scores), rtol=1e-6)


@pytest.mark.parametrize("g", [1, 4, 33])
@pytest.mark.parametrize("valid", ["none", "partial", "full", "mixed"])
def test_gather_plain_equals_pallas_kernel_bitwise(g, valid):
    """Repeated and padded source blocks (src 0, n_valid 0), sources past
    either end of the arena (clamped per row), and every n_valid kind."""
    rng = np.random.default_rng(g * 10 + len(valid))
    nb = 8
    arena = rng.integers(-5, 1000, (nb * ARENA_BLOCK, 2)).astype(np.int32)
    src = rng.integers(0, nb, g).astype(np.int32)
    src[::3] = src[0]  # repeated sources
    src[-1] = 0  # a padded block
    nv = {
        "none": np.zeros(g),
        "partial": rng.integers(1, ARENA_BLOCK, g),
        "full": np.full(g, ARENA_BLOCK),
        "mixed": rng.choice([0, 1, 77, ARENA_BLOCK, ARENA_BLOCK + 9, -3], g),
    }[valid].astype(np.int32)
    if g > 4:
        src[1], src[2] = -2, nb + 3  # out of range: rows clamp to the arena
    want = np.asarray(ref_gather_blocks(jnp.asarray(arena), jnp.asarray(src), jnp.asarray(nv)))
    want_ref = np.asarray(ref_gather_blocks_ref(jnp.asarray(arena), jnp.asarray(src), jnp.asarray(nv)))
    got = gather_blocks(torch.from_numpy(arena), torch.from_numpy(src), torch.from_numpy(nv))
    assert got.dtype == torch.int32 and got.shape == (g * ARENA_BLOCK, 2)
    np.testing.assert_array_equal(got.numpy(), want_ref)
    np.testing.assert_array_equal(gather_blocks_plain(
        torch.from_numpy(arena), torch.from_numpy(src), torch.from_numpy(nv)).numpy(), want_ref)
    # the Pallas kernel agrees wherever its one-DMA-per-block fetch is in range
    in_range = np.repeat((src >= 0) & (src < nb), ARENA_BLOCK)
    np.testing.assert_array_equal(got.numpy()[in_range], want[in_range])


def test_gather_rejects_what_the_kernel_cannot_take():
    arena = torch.zeros((4 * ARENA_BLOCK, 2), dtype=torch.int32)
    src = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of block"):
        gather_blocks(arena[:100], src, src)
    with pytest.raises(ValueError, match="multiple of block"):
        gather_blocks(arena[:0], src, src)
    with pytest.raises(ValueError, match=r"\[rows, 2\]"):
        gather_blocks(torch.zeros((ARENA_BLOCK, 3), dtype=torch.int32), src, src)
    with pytest.raises(ValueError, match="even"):
        gather_blocks(arena, src, src, block=3)
    with pytest.raises(ValueError, match="n_valid"):
        gather_blocks(arena, src, src[:1])
    with pytest.raises(ValueError, match="cuda device"):
        gather_blocks(arena.to("meta"), src.to("meta"), src.to("meta"))


@pytest.mark.parametrize("na,nb,n_chunks", _MODEL_SHAPES)
def test_intersect_plain_equals_pallas_kernel_on_any_offsets(na, nb, n_chunks):
    """Offsets below 0 (-1 and -257 among them), past the end and unaligned:
    the plain version reads the tiles the TPU kernel reads in interpret mode
    (a negative tile counts once from the end, then clamps at 0), bit for
    bit; the kernel's window spans cover exactly those tiles."""
    a, b, off = _model_inputs("any-offsets", na, nb, na + nb + n_chunks)
    want = np.asarray(
        ref_intersect_sorted(jnp.asarray(a), jnp.asarray(b), jnp.asarray(off), n_chunks=n_chunks)
    )
    got = intersect_sorted_plain(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(off),
                                 n_chunks=n_chunks)
    np.testing.assert_array_equal(got.numpy(), want)
    n_tiles = nb // 256
    for o in off.tolist():
        tiles = {min(max(t + n_tiles if t < 0 else t, 0), n_tiles - 1)
                 for t in range(o // 256, o // 256 + n_chunks)}
        spans = _window_spans(o, n_chunks, n_tiles, 256)
        assert tiles == {t for lo, hi in spans for t in range(lo, hi + 1)}, o
