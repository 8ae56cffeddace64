"""Shared helpers of the LM port tests (dense and MoE): the same configs,
weights and inputs in both packages, and the tolerances the tests hold the
port to.

Tolerances (float32 model / bfloat16 model):
  * forward (logits, loss): rtol 1e-4, atol 1e-5 / relative error 2e-2;
  * gradients: rtol 1e-3, atol 1e-6 (float32 only);
  * params after 3 train steps: atol 1e-5 (float32; a near-zero gradient
    that flips sign moves a weight by at most 2 lr, and lr is 3e-6 at step
    1) / relative error 2e-2.
The relative error of a bfloat16 result is ``||port - ref|| / ||ref||``
(Frobenius norms): the two packages round bfloat16 products at different
points (``repro_torch/models/layers.py``), so single elements near zero
differ by more than their size while the tensor agrees.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced_spec as ref_get_reduced_spec
from repro_torch.models import moe as port_moe
from repro_torch.models import transformer as port_tf
from repro_torch.models.convert import from_reference

# these tests run in parallel workers beside timing-sensitive ones: two
# intra-op threads a worker keep torch from oversubscribing the cores
torch.set_num_threads(2)

DENSE_ARCHS = ["tinyllama-1.1b", "stablelm-3b", "mistral-large-123b"]
MOE_ARCHS = ["olmoe-1b-7b", "llama4-maverick-400b-a17b"]
DTYPES = ["float32", "bfloat16"]
FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-6)
BF16_REL = 2e-2


def ref_cfg(arch: str, dtype: str, **changes):
    return dataclasses.replace(ref_get_reduced_spec(arch).model_cfg, dtype=dtype, **changes)


def port_moe_cfg(rmoe) -> port_moe.MoEConfig:
    return port_moe.MoEConfig(**dataclasses.asdict(rmoe))


def port_cfg(rcfg) -> port_tf.TransformerConfig:
    """The port's config with every field of the reference's ``rcfg``."""
    fields = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)}
    if fields["moe"] is not None:
        fields["moe"] = port_moe_cfg(fields["moe"])
    return port_tf.TransformerConfig(**fields)


def ref_params(rcfg, seed: int = 0):
    from repro.models import transformer as ref_tf

    return jax.jit(ref_tf.init_params, static_argnums=1)(jax.random.key(seed), rcfg)


def to_port(tree):
    return from_reference(jax.tree.map(np.asarray, tree), device="cpu")


def np32(x) -> np.ndarray:
    """A jax array or tensor of any float dtype as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def rel_err(got, want) -> float:
    got, want = np32(got), np32(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def assert_close(got, want, dtype: str, kind=FWD, what: str = ""):
    if dtype == "float32":
        np.testing.assert_allclose(np32(got), np32(want), err_msg=what, **kind)
    else:
        assert rel_err(got, want) < BF16_REL, (what, rel_err(got, want))


def lm_batch(vocab: int, b: int, s: int, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.9).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}


def torch_batch(batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in batch.items()}
