"""The port's AdamW (``repro_torch.optim``) against the reference's on the
CPU: the cosine schedule over steps 0-12,000, the global norm, init, and
three updates of float32 and bfloat16 parameter trees (clipped and not),
compared leaf for leaf (params, ``m``, ``v``, ``master``, ``step``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim import optimizer as ref
from repro_torch.models.convert import from_reference
from repro_torch.optim import optimizer as port
from repro_torch.tree import tree_leaves


def test_cosine_schedule_equals_the_reference_over_steps_0_to_12000():
    steps = np.arange(0, 12001, dtype=np.int32)
    for cfg in (port.AdamWConfig(), port.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=500)):
        rcfg = ref.AdamWConfig(**cfg.__dict__)
        got = port.cosine_schedule(torch.from_numpy(steps), cfg).numpy()
        want = np.asarray(ref.cosine_schedule(jnp.asarray(steps), rcfg))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert float(port.cosine_schedule(1, port.AdamWConfig())) == pytest.approx(3e-6, rel=1e-6)


def _tree(rng, dtype):
    def leaf(shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32), dtype)

    return {"b": leaf((7,)), "a": {"w": leaf((3, 5)), "z": leaf((2, 2, 4))}, "s": leaf(())}


@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_three_adamw_updates_equal_the_reference(dtype, clip_norm):
    rng = np.random.default_rng(0)
    params = _tree(rng, dtype)
    rcfg = ref.AdamWConfig(clip_norm=clip_norm, warmup_steps=2)
    cfg = port.AdamWConfig(clip_norm=clip_norm, warmup_steps=2)
    rstate, state = ref.adamw_init(params), port.adamw_init(from_reference(params, device="cpu"))
    for want, got in zip(jax.tree.leaves(rstate), tree_leaves(state)):
        assert np.array_equal(np.asarray(want, np.float32), got.float().numpy()) and got.dtype == {
            "float32": torch.float32, "int32": torch.int32}[str(want.dtype)]
    rparams, pparams = params, from_reference(params, device="cpu")
    for step in range(3):
        grads = _tree(rng, dtype)
        pgrads = from_reference(grads, device="cpu")
        before = [g.clone() for g in tree_leaves(pgrads)] + [s.clone() for s in tree_leaves(state)]
        np.testing.assert_allclose(float(port.global_norm(pgrads)), float(ref.global_norm(grads)), rtol=1e-6)
        rmaster, rstate = ref.adamw_update(grads, rstate, rcfg)
        master, new_state = port.adamw_update(pgrads, state, cfg)
        # the inputs are left as they were
        after = tree_leaves(pgrads) + tree_leaves(state)
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        state = new_state
        rparams = ref.cast_like(rmaster, rparams)
        pparams = port.cast_like(master, pparams)
        assert int(state["step"]) == int(rstate["step"]) == step + 1 and state["step"].dtype == torch.int32
        for name in ("m", "v", "master"):
            for got, want in zip(tree_leaves(state[name]), jax.tree.leaves(rstate[name])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-9, err_msg=name)
        for got, want in zip(tree_leaves(pparams), jax.tree.leaves(rparams)):
            assert got.dtype == {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
            # bf16: equal, or one bf16 step apart where the f32 masters round differently
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       rtol=1e-5 if dtype == jnp.float32 else 8e-3, atol=1e-9)
