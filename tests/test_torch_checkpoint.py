"""Train-state checkpoints across packages (``repro_torch.checkpoint``
against ``repro.checkpoint``) on the CPU: the port writes the reference's
``.npy`` entries byte for byte and its manifest key for key (``time``
aside); each package restores the other's; a reference checkpoint of a
reduced trainer state resumes in the port, whose next step equals the
reference's; and the reference's own restore returns bfloat16 leaves as raw
``V2`` words, where the port's returns ``torch.bfloat16``."""

import dataclasses
import json
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import checkpoint as ref_ck
from repro.configs import get_reduced_spec as ref_get_reduced_spec
from repro.data.pipeline import LMTokenPipeline
from repro.launch.mesh import make_smoke_mesh as ref_smoke_mesh
from repro.launch.steps import build_cell as ref_build_cell
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import get_reduced_spec
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.models.convert import from_reference
from repro_torch.tree import tree_leaves
from tests._lm_compare import BF16_REL, port_cfg, rel_err


def _ref_trainer_state(dtype: str, steps: int = 1):
    """The reduced tinyllama trainer's payload after ``steps`` reference
    steps, its jitted step function and its pipeline."""
    spec = ref_get_reduced_spec("tinyllama-1.1b")
    spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(spec.model_cfg, dtype=dtype))
    cfg = spec.model_cfg
    from repro.models import transformer

    params = transformer.init_params(jax.random.key(0), cfg)
    opt = ref_adamw_init(params)
    pipe = LMTokenPipeline(cfg.vocab, 32, 2, seed=0)
    mesh = ref_smoke_mesh()
    with mesh:
        cell = ref_build_cell(spec, "train_4k", mesh)
        step_fn = jax.jit(cell.fn)
        for _ in range(steps):
            params, opt, _ = step_fn(params, opt, pipe.next_batch())
    return {"params": params, "opt": opt, "pipe": pipe.state.as_tree()}, step_fn, pipe, spec


def _entries(path):
    with zipfile.ZipFile(path / "arrays.npz") as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_is_the_reference_format(tmp_path, dtype):
    payload, _, _, _ = _ref_trainer_state(dtype)
    ref_dir = ref_ck.save_checkpoint(tmp_path / "ref", 1, payload)
    port_dir = save_checkpoint(tmp_path / "port", 1, from_reference(payload, device="cpu"))
    want, got = _entries(ref_dir), _entries(port_dir)
    assert sorted(got) == sorted(want) == sorted(f"a{i}.npy" for i in range(len(want)))
    assert all(got[n] == want[n] for n in want), [n for n in want if got[n] != want[n]]
    m_ref = json.loads((ref_dir / "manifest.json").read_text())
    m_port = json.loads((port_dir / "manifest.json").read_text())
    m_ref.pop("time"), m_port.pop("time")
    assert m_port == m_ref
    assert ("bfloat16" in m_port["leaf_dtypes"]) == (dtype == "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_each_package_restores_the_others_checkpoint(tmp_path, dtype):
    payload, _, _, _ = _ref_trainer_state(dtype)
    port_payload = from_reference(payload, device="cpu")
    ref_ck.save_checkpoint(tmp_path / "ref", 1, payload)
    save_checkpoint(tmp_path / "port", 1, port_payload)
    # the port reads the reference's checkpoint, bfloat16 leaves as bfloat16
    restored, step = restore_checkpoint(tmp_path / "ref", port_payload, device="cpu")
    assert step == 1
    for got, want in zip(tree_leaves(restored), tree_leaves(port_payload)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    # the reference reads the port's checkpoint as it reads its own
    own, _ = ref_ck.restore_checkpoint(tmp_path / "ref", payload)
    other, _ = ref_ck.restore_checkpoint(tmp_path / "port", payload)
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(other)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_reference_restores_bfloat16_leaves_as_raw_void_words(tmp_path):
    """A fault of the reference, pinned: its restore returns a bfloat16 leaf
    as a ``|V2`` array, so it cannot restore its own trainer's bf16 params.
    The port reads ``leaf_dtypes`` and restores ``torch.bfloat16``."""
    tree = {"w": jnp.ones((2, 3), jnp.bfloat16)}
    ref_ck.save_checkpoint(tmp_path, 0, tree)
    restored, _ = ref_ck.restore_checkpoint(tmp_path, tree)
    assert restored["w"].dtype == np.dtype("V2") and restored["w"].dtype.str == "|V2"
    port, _ = restore_checkpoint(tmp_path, {"w": torch.zeros(2, 3, dtype=torch.bfloat16)}, device="cpu")
    assert port["w"].dtype == torch.bfloat16 and torch.equal(port["w"], torch.ones(2, 3, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_resumes_in_the_port(tmp_path, dtype):
    """Reference: one step, a checkpoint, one more step.  Port: restore that
    checkpoint and its pipeline state, one step.  The two second steps agree
    (float32 within atol 1e-5, bfloat16 within 2e-2 relative)."""
    payload, step_fn, pipe, spec = _ref_trainer_state(dtype)
    ref_ck.save_checkpoint(tmp_path, 1, payload)
    with ref_smoke_mesh():
        want_params, want_opt, want_m = step_fn(payload["params"], payload["opt"], pipe.next_batch())

    template = from_reference(payload, device="cpu")
    restored, step = restore_checkpoint(tmp_path, template, device="cpu")
    from repro_torch.data.pipeline import LMTokenPipeline as PortPipeline, PipelineState

    port_pipe = PortPipeline(spec.model_cfg.vocab, 32, 2, seed=123)
    port_pipe.state = PipelineState.from_tree(restored["pipe"])
    batch = {k: torch.from_numpy(v) for k, v in port_pipe.next_batch().items()}
    port_spec = dataclasses.replace(get_reduced_spec("tinyllama-1.1b"), model_cfg=port_cfg(spec.model_cfg))
    cell = build_cell(port_spec, "train_4k", make_smoke_mesh())
    params, opt, metrics = cell.fn(restored["params"], restored["opt"], batch)
    assert step == 1 and int(opt["step"]) == int(want_opt["step"]) == 2
    for got, want in zip(tree_leaves(params), jax.tree.leaves(want_params)):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        else:
            assert rel_err(got, want) < BF16_REL
    np.testing.assert_allclose(float(metrics["loss"]), float(want_m["loss"]),
                               rtol=1e-4 if dtype == "float32" else BF16_REL)


def test_checkpoint_manager_writes_async_keeps_the_latest_and_restores(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"w": torch.arange(6, dtype=torch.float32).view(2, 3), "b": torch.ones(4, dtype=torch.bfloat16),
            "pipe": {"step": np.int64(3), "seed": np.int64(0)}}
    for step in (1, 2, 3):
        tree["w"] += 1
        mgr.save_async(step, tree)
    mgr.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_3"] and latest_step(tmp_path) == 3
    restored, step = mgr.restore_latest(tree, device="cpu")
    assert step == 3 and torch.equal(restored["w"], tree["w"]) and restored["b"].dtype == torch.bfloat16
    assert int(restored["pipe"]["step"]) == 3 and restored["pipe"]["step"].dtype == torch.int64
    # the host copy is taken on the calling thread: later writes do not leak in
    mgr.save_async(4, tree)
    tree["w"] += 100
    mgr.wait()
    assert float(restore_checkpoint(tmp_path, tree, step=4, device="cpu")[0]["w"].max()) == 8.0
    assert restore_checkpoint(tmp_path / "empty", tree, device="cpu") is None
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(tmp_path, {"w": tree["w"]}, device="cpu")
    # a failed write surfaces on wait()
    (tmp_path / "blocked").write_text("a file, not a directory")
    bad = CheckpointManager(tmp_path / "blocked")
    bad.save_async(1, tree)
    with pytest.raises(OSError):
        bad.wait()
