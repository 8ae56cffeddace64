"""The port's transformer layers (``repro_torch.models.layers``) against the
reference's (``repro.models.layers``) on the CPU: the same numpy inputs, in
float32 and bfloat16, at the tolerances of ``tests/_lm_compare.py``.
``flash_attention`` is also held to ``attention_plain`` (one masked softmax)
and differentiated against ``jax.grad`` of the reference."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import layers as ref
from repro_torch.models import layers as port
from tests._lm_compare import FWD, GRAD, assert_close, np32

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(rng, shape, dtype, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, _JNP[dtype]), torch.from_numpy(x).to(_TORCH[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_equal_the_reference(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, (2, 24, 4, 16), dtype)
    jg, tg = _pair(rng, (16,), dtype)
    got = port.rms_norm(tx, tg)
    assert got.dtype == tx.dtype
    assert_close(got, ref.rms_norm(jx, jg), dtype, what="rms_norm")
    pos = np.arange(24)[None, :] + 5
    got = port.rope(tx, torch.from_numpy(pos), 10000.0)
    assert got.dtype == tx.dtype
    assert_close(got, ref.rope(jx, jnp.asarray(pos), 10000.0), dtype, what="rope")
    got = port.rope(tx, torch.from_numpy(pos), 1_000_000.0)
    assert_close(got, ref.rope(jx, jnp.asarray(pos), 1_000_000.0), dtype, what="rope theta 1e6")


# (sq, skv, hq, hkv, d, q_chunk, kv_chunk, causal, window, q_offset)
ATTN_CASES = {
    "causal-balanced": (128, 128, 8, 2, 16, 32, 32, True, None, 0),
    "causal-mha": (64, 64, 4, 4, 16, 32, 32, True, None, 0),
    "causal-odd-chunks": (96, 96, 6, 2, 16, 40, 36, True, None, 0),
    "causal-unequal-chunks": (64, 64, 8, 2, 16, 32, 16, True, None, 0),
    "causal-one-chunk": (48, 48, 8, 1, 16, 1024, 1024, True, None, 0),
    "sliding-window": (128, 128, 8, 2, 16, 32, 32, True, 24, 0),
    "sliding-window-odd": (96, 96, 4, 2, 16, 20, 28, True, 17, 0),
    "not-causal": (40, 56, 8, 2, 16, 16, 16, False, None, 0),
    "q-offset": (32, 96, 8, 4, 16, 16, 32, True, None, 64),
    "q-offset-window": (32, 96, 8, 4, 16, 16, 32, True, 40, 64),
}


def _attn_inputs(case, dtype, seed=0):
    sq, skv, hq, hkv, d = ATTN_CASES[case][:5]
    rng = np.random.default_rng(seed)
    return (_pair(rng, (2, sq, hq, d), dtype), _pair(rng, (2, skv, hkv, d), dtype),
            _pair(rng, (2, skv, hkv, d), dtype))


def _attn_kw(case):
    qc, kc, causal, window, off = ATTN_CASES[case][5:]
    return dict(causal=causal, q_chunk=qc, kv_chunk=kc, sliding_window=window, q_offset=off)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_equals_the_reference_and_the_plain_softmax(case, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(case, dtype)
    kw = _attn_kw(case)
    got = port.flash_attention(tq, tk, tv, **kw)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    want = jax.jit(lambda q, k, v: ref.flash_attention(q, k, v, **kw))(jq, jk, jv)
    assert_close(got, want, dtype, what=f"{case} vs reference")
    plain = port.attention_plain(tq, tk, tv, causal=kw["causal"], q_offset=kw["q_offset"],
                                 sliding_window=kw["sliding_window"])
    assert_close(got, plain, dtype, what=f"{case} vs attention_plain")


@pytest.mark.parametrize("case", ["causal-balanced", "causal-odd-chunks", "sliding-window", "q-offset-window"])
def test_flash_attention_gradients_equal_the_reference(case):
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(case, "float32", seed=1)
    kw = _attn_kw(case)
    rng = np.random.default_rng(2)
    w = rng.standard_normal(tuple(tq.shape)).astype(np.float32)

    def ref_loss(q, k, v):
        return jnp.sum(ref.flash_attention(q, k, v, **kw) * w)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    (port.flash_attention(*leaves, **kw) * torch.from_numpy(w)).sum().backward()
    for name, leaf, g in zip("qkv", leaves, want):
        np.testing.assert_allclose(np32(leaf.grad), np32(g), err_msg=f"d{name}", **GRAD)


def test_flash_attention_skips_only_tiles_masked_for_every_query():
    """A window that masks whole KV tiles: the skipped tiles' update is the
    identity, so the result equals a run over every tile (the plain
    softmax) to float32 rounding."""
    (_, tq), (_, tk), (_, tv) = _attn_inputs("sliding-window", "float32")
    got = port.flash_attention(tq, tk, tv, q_chunk=16, kv_chunk=16, sliding_window=8)
    plain = port.attention_plain(tq, tk, tv, sliding_window=8)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **FWD)
    assert port._tile_is_dead(64, 32, 16, 16, True, 8) and not port._tile_is_dead(64, 48, 16, 16, True, 8)
    assert port._tile_is_dead(0, 16, 16, 16, True, None) and port._tile_mask(32, 0, 16, 16, True, None, "cpu") is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("cache_len", [1, 9, 24])
def test_decode_attention_equals_the_reference(dtype, window, cache_len):
    rng = np.random.default_rng(cache_len)
    jq, tq = _pair(rng, (3, 1, 8, 16), dtype)
    jk, tk = _pair(rng, (3, 24, 2, 16), dtype)
    jv, tv = _pair(rng, (3, 24, 2, 16), dtype)
    got = port.decode_attention(tq, tk, tv, cache_len, sliding_window=window)
    assert got.shape == (3, 1, 8, 16) and got.dtype == tq.dtype
    want = ref.decode_attention(jq, jk, jv, jnp.asarray(cache_len, jnp.int32), sliding_window=window)
    assert_close(got, want, dtype, what="decode_attention")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_equals_the_reference(dtype):
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng, (2, 8, 32), dtype)
    ws = [_pair(rng, shape, dtype, 0.2) for shape in ((32, 48), (32, 48), (48, 32))]
    got = port.swiglu(tx, *(t for _, t in ws))
    assert got.dtype == tx.dtype
    assert_close(got, ref.swiglu(jx, *(j for j, _ in ws)), dtype, what="swiglu")


def test_dense_init_draws_from_its_generator():
    a = port.dense_init(torch.Generator().manual_seed(5), (4, 256, 512))
    b = port.dense_init(torch.Generator().manual_seed(5), (4, 256, 512))
    assert a.dtype == torch.bfloat16 and a.shape == (4, 256, 512) and torch.equal(a, b)
    # the fan-in is shape[-2]: std 256 ** -0.5 over 524,288 draws
    assert abs(float(a.float().std()) * 16 - 1) < 0.01
    e = port.dense_init(torch.Generator().manual_seed(5), (1000, 64), torch.float32, scale=0.02)
    assert e.dtype == torch.float32 and abs(float(e.std()) / 0.02 - 1) < 0.01


def _merged_over_slices(tq, tk, tv, lo: int, hi: int, cuts: list[int]):
    """``decode_attention_merged`` as the ranks of a cache cut at ``cuts``
    run it, one thread a rank: each passes its run of the valid positions
    [lo, hi) (empty where its slice holds none), and ``reduce`` combines the
    ranks' tensors behind a barrier."""
    import threading

    bounds = list(zip([0, *cuts], [*cuts, tk.shape[1]]))
    n = len(bounds)
    barrier, posted, outs = threading.Barrier(n), [None] * n, [None] * n

    def rank(r):
        def reduce(x, op):
            posted[r] = x
            barrier.wait()
            stack = torch.stack(list(posted))
            barrier.wait()  # every rank has read before the next round posts
            return stack.amax(dim=0) if op == "max" else stack.sum(dim=0)

        a, z = min(max(lo, bounds[r][0]), bounds[r][1]), min(max(hi, bounds[r][0]), bounds[r][1])
        outs[r] = port.decode_attention_merged(tq, tk[:, a:max(a, z)], tv[:, a:max(a, z)], reduce)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("cache_len", [1, 9, 24])
def test_decode_attention_merged_over_slices_equals_the_reference(dtype, window, cache_len):
    """Three ranks holding positions [0, 8), [8, 16) and [16, 24) of the
    cache (some with no valid position, none producing a NaN): every rank's
    merged output is the reference's ``decode_attention`` over the whole
    cache."""
    rng = np.random.default_rng(cache_len)
    jq, tq = _pair(rng, (3, 1, 8, 16), dtype)
    jk, tk = _pair(rng, (3, 24, 2, 16), dtype)
    jv, tv = _pair(rng, (3, 24, 2, 16), dtype)
    lo = max(cache_len - window, 0) if window is not None else 0
    want = ref.decode_attention(jq, jk, jv, jnp.asarray(cache_len, jnp.int32), sliding_window=window)
    for got in _merged_over_slices(tq, tk, tv, lo, min(cache_len, 24), [8, 16]):
        assert got.shape == (3, 1, 8, 16) and got.dtype == tq.dtype and bool(torch.isfinite(got).all())
        assert_close(got, want, dtype, what="decode_attention_merged")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("cache_len", [1, 9, 24])
def test_decode_attention_merged_on_one_rank_equals_the_reference(dtype, window, cache_len):
    """With no ``reduce`` (one rank holds every valid position), the merged
    form over the valid run is the reference's ``decode_attention`` over
    the whole masked cache: the form every ``decode_step`` attends with."""
    rng = np.random.default_rng(100 + cache_len)
    jq, tq = _pair(rng, (3, 1, 8, 16), dtype)
    jk, tk = _pair(rng, (3, 24, 2, 16), dtype)
    jv, tv = _pair(rng, (3, 24, 2, 16), dtype)
    lo = max(cache_len - window, 0) if window is not None else 0
    want = ref.decode_attention(jq, jk, jv, jnp.asarray(cache_len, jnp.int32), sliding_window=window)
    got = port.decode_attention_merged(tq, tk[:, lo:cache_len], tv[:, lo:cache_len])
    assert got.shape == (3, 1, 8, 16) and got.dtype == tq.dtype
    assert_close(got, want, dtype, what="decode_attention_merged, one rank")
    assert_close(got, port.decode_attention(tq, tk, tv, cache_len, sliding_window=window), dtype,
                 what="decode_attention_merged against the port's decode_attention")
