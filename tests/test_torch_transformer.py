"""The port's transformer (``repro_torch.models.transformer``) against the
reference's on the CPU: the reduced configs of the three dense
architectures, in float32 and bfloat16, with the reference's weights carried
across by ``models/convert.py`` (``jax.random`` cannot be drawn in torch).
Loss and gradients, prefill logits and cache, and decode steps with the cache
written at ``cache_len`` 0, in the middle and at or past its end, with and
without a sliding window.  Tolerances: ``tests/_lm_compare.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_spec as ref_get_spec
from repro.models import transformer as ref_tf
from repro_torch.configs import get_spec
from repro_torch.models import transformer as port_tf
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.tree import tree_leaves
from tests._lm_compare import (
    DENSE_ARCHS,
    DTYPES,
    GRAD,
    assert_close,
    lm_batch,
    np32,
    port_cfg,
    ref_cfg,
    ref_params,
    rel_err,
    to_port,
    torch_batch,
)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_loss_and_hidden_equal_the_reference(arch, dtype):
    rcfg = ref_cfg(arch, dtype)
    cfg = port_cfg(rcfg)
    rp = ref_params(rcfg)
    pp = to_port(rp)
    batch = lm_batch(rcfg.vocab, 2, 96)
    want_loss, want_m = jax.jit(lambda p, b: ref_tf.loss_fn(p, b, rcfg))(rp, batch)
    loss, m = port_tf.loss_fn(pp, torch_batch(batch), cfg)
    assert_close(loss, want_loss, dtype, what="loss")
    assert_close(m["nll"], want_m["nll"], dtype, what="nll")
    assert float(m["aux"]) == float(want_m["aux"]) == 0.0
    want_h = jax.jit(lambda p, t: ref_tf.forward(p, t, rcfg)[0])(rp, batch["tokens"])
    h = port_tf.forward(pp, torch.from_numpy(batch["tokens"]), cfg)[0]
    assert h.dtype == cfg.torch_dtype
    assert_close(h, want_h, dtype, what="hidden")


@pytest.mark.parametrize("remat,remat_block", [(True, 1), (True, 2), (False, 1)])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_float32_gradients_equal_the_reference(arch, remat, remat_block):
    rcfg = ref_cfg(arch, "float32", remat=remat, remat_block=remat_block)
    cfg = port_cfg(rcfg)
    rp = ref_params(rcfg, seed=1)
    batch = lm_batch(rcfg.vocab, 2, 64, seed=1)
    want = jax.jit(jax.grad(lambda p: ref_tf.loss_fn(p, batch, rcfg)[0]))(rp)
    pp = to_port(rp)
    leaves = [t.requires_grad_(True) for t in tree_leaves(pp)]
    port_tf.loss_fn(pp, torch_batch(batch), cfg)[0].backward()
    for got, g in zip(leaves, jax.tree.leaves(want)):
        np.testing.assert_allclose(np32(got.grad), np32(g), **GRAD)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_equals_the_reference(arch, dtype):
    rcfg = ref_cfg(arch, dtype)
    cfg = port_cfg(rcfg)
    rp = ref_params(rcfg, seed=2)
    tokens = lm_batch(rcfg.vocab, 2, 80, seed=2)["tokens"]
    want_logits, want_cache = jax.jit(lambda p, t: ref_tf.prefill_step(p, t, rcfg))(rp, tokens)
    with torch.no_grad():
        logits, cache = port_tf.prefill_step(to_port(rp), torch.from_numpy(tokens), cfg)
    assert logits.dtype == torch.float32 and logits.shape == (2, cfg.vocab)
    assert_close(logits, want_logits, dtype, what="logits")
    for k in ("k", "v"):
        assert cache[k].shape == (cfg.n_layers, 2, 80, cfg.n_kv_heads, cfg.d_head)
        assert_close(cache[k], want_cache[k], dtype, what=f"cache {k}")


# (cache length S, cache_len, sliding window): the write at 0, in the middle,
# at the last row and past the end (clamped to row S-1); the window branch
# (S > w) at the start, the middle and the end
DECODE_CASES = {
    "empty": (24, 0, None),
    "mid": (24, 11, None),
    "last": (24, 23, None),
    "past-end": (24, 30, None),
    "window-covers": (24, 11, 32),
    "swa-start": (48, 3, 16),
    "swa-mid": (48, 27, 16),
    "swa-end": (48, 47, 16),
    "swa-past-end": (48, 60, 16),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(DECODE_CASES))
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_step_equals_the_reference(arch, case, dtype):
    s, cache_len, window = DECODE_CASES[case]
    rcfg = ref_cfg(arch, dtype, sliding_window=window)
    cfg = port_cfg(rcfg)
    rp = ref_params(rcfg, seed=3)
    rng = np.random.default_rng(s + cache_len)
    shape = (rcfg.n_layers, 2, s, rcfg.n_kv_heads, rcfg.d_head)
    cache = {k: jnp.asarray(rng.standard_normal(shape).astype(np.float32), rcfg.jdtype) for k in ("k", "v")}
    tokens = rng.integers(0, rcfg.vocab, (2, 1)).astype(np.int32)
    want_logits, want_cache = jax.jit(lambda p, c, t, n: ref_tf.decode_step(p, c, t, n, rcfg))(
        rp, cache, tokens, jnp.asarray(cache_len, jnp.int32))
    port_cache = to_port(cache)
    before = {k: v.clone() for k, v in port_cache.items()}
    with torch.no_grad():
        logits, new = port_tf.decode_step(to_port(rp), port_cache, torch.from_numpy(tokens),
                                          torch.tensor(cache_len, dtype=torch.int32), cfg)
    assert all(torch.equal(before[k], port_cache[k]) for k in before), "the input cache was written"
    assert_close(logits, want_logits, dtype, what="logits")
    row = min(cache_len, s - 1)
    for k in ("k", "v"):
        assert new[k].shape == shape and new[k].dtype == cfg.torch_dtype
        # every row but the written one is the input's, bit for bit
        keep = torch.ones(s, dtype=torch.bool)
        keep[row] = False
        assert torch.equal(new[k][:, :, keep], port_cache[k][:, :, keep])
        assert_close(new[k][:, :, row], np.asarray(want_cache[k], np.float32)[:, :, row], dtype,
                     what=f"written row of {k}")


def test_prefill_then_decode_equals_prefill_of_one_more_token():
    """The port against itself: a decode step after a prefill of S tokens
    gives the logits a prefill of the S + 1 tokens gives."""
    cfg = port_cfg(ref_cfg("tinyllama-1.1b", "float32"))
    params = port_tf.init_params(4, cfg, device="cpu")
    tokens = torch.from_numpy(lm_batch(cfg.vocab, 2, 41, seed=4)["tokens"])
    with torch.no_grad():
        _, cache = port_tf.prefill_step(params, tokens[:, :40], cfg)
        padded = {k: torch.cat([v, torch.zeros_like(v[:, :, :8])], dim=2) for k, v in cache.items()}
        logits, _ = port_tf.decode_step(params, padded, tokens[:, 40:], 40, cfg)
        want, _ = port_tf.prefill_step(params, tokens, cfg)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_params_has_the_reference_tree(dtype):
    rcfg = ref_cfg("mistral-large-123b", dtype)
    cfg = port_cfg(rcfg)
    rp = ref_params(rcfg)
    pp = port_tf.init_params(0, cfg, device="cpu")
    assert jax.tree.structure(rp) == jax.tree.structure(to_reference(pp))
    for got, want in zip(tree_leaves(pp), jax.tree.leaves(rp)):
        assert tuple(got.shape) == want.shape and got.dtype == cfg.torch_dtype
    shapes = port_tf.param_shapes(cfg)
    assert all(t.device.type == "meta" for t in tree_leaves(shapes))
    assert [t.shape for t in tree_leaves(shapes)] == [t.shape for t in tree_leaves(pp)]
    # norms start at one; matrices at N(0, fan_in ** -0.5), embeddings N(0, 0.02)
    assert bool((pp["final_norm"] == 1).all()) and bool((pp["layers"]["ln1"] == 1).all())
    assert abs(float(pp["embed"].float().std()) / 0.02 - 1) < 0.1
    # the same seed, the same params; round trip through the converter
    again = port_tf.init_params(0, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pp), tree_leaves(again)))
    back = from_reference(to_reference(pp), device="cpu")
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(tree_leaves(pp), tree_leaves(back)))
    # the port's weights carried to the reference give the reference the port's loss
    ref_pp = to_reference(pp, bfloat16=jnp.bfloat16)
    assert all(a.dtype == jnp.dtype(rcfg.jdtype) for a in jax.tree.leaves(ref_pp))
    batch = lm_batch(rcfg.vocab, 2, 32)
    want = jax.jit(lambda p, b: ref_tf.loss_fn(p, b, rcfg)[0])(ref_pp, batch)
    assert_close(port_tf.loss_fn(pp, torch_batch(batch), cfg)[0], want, dtype, what="loss on the port's init")


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_param_counts_equal_the_reference(arch):
    cfg, rcfg = get_spec(arch).model_cfg, ref_get_spec(arch).model_cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.param_count() == rcfg.param_count() and cfg.active_param_count() == rcfg.active_param_count()
    n = sum(t.numel() for t in tree_leaves(port_tf.param_shapes(cfg)))
    assert n == cfg.param_count()


def test_moe_configs_raise():
    """MoE configs no longer raise: a narrowed olmoe config builds, counts
    the reference's parameters and runs forward, prefill and decode."""
    moe_cfg = ref_get_spec("olmoe-1b-7b").model_cfg
    small = dataclasses.replace(moe_cfg, n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, vocab=64)
    cfg = port_cfg(small)
    assert cfg.param_count() == small.param_count()
    params = port_tf.init_params(0, cfg, device="cpu")
    assert sum(t.numel() for t in tree_leaves(params)) == cfg.param_count()
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    h, aux, _ = port_tf.forward(params, tokens, cfg)
    assert h.shape == (1, 4, 32) and float(aux) > 0
    with torch.no_grad():
        logits, cache = port_tf.prefill_step(params, tokens, cfg)
        step, _ = port_tf.decode_step(params, cache, tokens[:, :1], 3, cfg)
    assert logits.shape == step.shape == (1, 64) and bool(torch.isfinite(step).all())


def test_bfloat16_decode_vs_prefill_gap_is_the_references():
    """In bfloat16, a decode step after a prefill of S tokens and a prefill
    of S + 1 tokens round their products apart, and the residual stream
    carries the difference through the layers.  At tinyllama-1.1b's full
    depth (22 layers; its head layout and d_head, width cut to d_model 512
    so the check stays small on the CPU) the reference shows the gap the
    port shows (1.6e-2 and 1.8e-2 on this input): a property of bfloat16,
    not of the port.  float32 closes it."""
    full = ref_get_spec("tinyllama-1.1b").model_cfg
    s = 64
    gaps = {}
    for dtype in ("float32", "bfloat16"):
        rcfg = dataclasses.replace(full, d_model=512, n_heads=8, n_kv_heads=1, d_ff=1408, dtype=dtype)
        assert rcfg.n_layers == 22 and rcfg.d_head == full.d_head
        cfg = port_cfg(rcfg)
        rp = ref_params(rcfg)
        toks = np.random.default_rng(0).integers(0, rcfg.vocab, (2, s + 1)).astype(np.int32)
        prefill = jax.jit(lambda p, t: ref_tf.prefill_step(p, t, rcfg))
        _, cache = prefill(rp, toks[:, :s])
        cache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))) for k, v in cache.items()}
        ref_step, _ = jax.jit(lambda p, c, t: ref_tf.decode_step(p, c, t, jnp.int32(s), rcfg))(rp, cache, toks[:, s:])
        ref_gap = rel_err(ref_step, prefill(rp, toks)[0])
        pp = to_port(rp)
        with torch.no_grad():
            _, pc = port_tf.prefill_step(pp, torch.from_numpy(toks[:, :s]), cfg)
            pc = {k: torch.cat([v, torch.zeros_like(v[:, :, :1])], dim=2) for k, v in pc.items()}
            step, _ = port_tf.decode_step(pp, pc, torch.from_numpy(toks[:, s:]), s, cfg)
            port_gap = rel_err(step, port_tf.prefill_step(pp, torch.from_numpy(toks), cfg)[0])
        gaps[dtype] = (ref_gap, port_gap)
    assert max(gaps["float32"]) < 1e-5
    ref_gap, port_gap = gaps["bfloat16"]
    assert 5e-3 < ref_gap < 5e-2 and port_gap < 1.5 * ref_gap, gaps
