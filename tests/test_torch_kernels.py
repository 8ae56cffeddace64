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

import jax.numpy as jnp

from repro.core.window import window_cover as ref_window_cover
from repro.kernels.intersect import block_offsets as ref_block_offsets
from repro.kernels.intersect import intersect_sorted as ref_intersect_sorted
from repro.kernels.ops import proximity_search_scores as ref_search_scores
from repro.kernels.proximity import proximity_window as ref_proximity_window
from repro.kernels.ref import fragment_scores_ref as ref_fragment_scores
from repro.kernels.ref import intersect_ref as ref_intersect_ref
from repro_torch.core.window import window_cover
from repro_torch.kernels import (
    PAD,
    block_offsets,
    fragment_scores_ref,
    intersect_ref,
    intersect_sorted,
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
