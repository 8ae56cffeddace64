"""The port's train step (``launch/steps._lm_cell``) and training launcher
(``python -m repro_torch.launch.train``) against the reference's on the CPU:
three steps of the reduced configs of the three dense architectures, in
float32 and bfloat16, with 1 and 2 microbatches, from the reference's
weights (``models/convert.py``) on the pipeline's batches; and the
launcher's printed lines at the reduced config.  Tolerances:
``tests/_lm_compare.py``."""

import dataclasses
import re
import sys

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_reduced_spec as ref_get_reduced_spec
from repro.data.pipeline import LMTokenPipeline
from repro.launch import train as ref_train
from repro.launch.steps import build_cell as ref_build_cell
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import get_reduced_spec
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.models import transformer as port_tf
from repro_torch.models.convert import from_reference
from repro_torch.tree import tree_leaves, treedef_str
from tests._lm_compare import (
    BF16_REL,
    DENSE_ARCHS,
    DTYPES,
    GRAD,
    assert_close,
    np32,
    port_cfg,
    ref_params,
    rel_err,
)


def _specs(arch, dtype, microbatches):
    ref_spec = ref_get_reduced_spec(arch)
    rcfg = dataclasses.replace(ref_spec.model_cfg, dtype=dtype, microbatches=microbatches)
    ref_spec = dataclasses.replace(ref_spec, model_cfg=rcfg)
    return ref_spec, dataclasses.replace(get_reduced_spec(arch), model_cfg=port_cfg(rcfg))


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_three_train_steps_equal_the_reference(arch, dtype, microbatches):
    ref_spec, spec = _specs(arch, dtype, microbatches)
    rcfg = ref_spec.model_cfg
    # the reference's microbatch split constrains its sharding, which a
    # mesh of jax's default (explicit) axis types refuses
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with mesh:
        ref_cell = ref_build_cell(ref_spec, "train_4k", mesh)
        ref_step = jax.jit(ref_cell.fn)
    cell = build_cell(spec, "train_4k", make_smoke_mesh())
    rparams = ref_params(rcfg, seed=5)
    ropt = ref_adamw_init(rparams)
    params, opt = from_reference(rparams, device="cpu"), from_reference(ropt, device="cpu")
    pipe = LMTokenPipeline(rcfg.vocab, 64, 4, seed=5)
    for step in range(3):
        batch = pipe.next_batch()
        with mesh:
            rparams, ropt, rm = ref_step(rparams, ropt, batch)
        inputs = [t.clone() for t in tree_leaves((params, opt))]
        new_params, new_opt, m = cell.fn(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
        # the step returns new tensors and leaves its inputs as they were
        assert all(torch.equal(a, b) for a, b in zip(inputs, tree_leaves((params, opt))))
        params, opt = new_params, new_opt
        assert sorted(m) == sorted(rm) == ["aux", "grad_norm", "loss", "nll"]
        assert int(opt["step"]) == int(ropt["step"]) == step + 1 and opt["step"].dtype == torch.int32
        for k in ("loss", "nll"):
            assert_close(m[k], rm[k], dtype, what=f"step {step} {k}")
        assert float(m["aux"]) == float(rm["aux"]) == 0.0
        if dtype == "float32":
            np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), **GRAD)
    for got, want in zip(tree_leaves(params), jax.tree.leaves(rparams)):
        assert got.dtype == port_cfg(rcfg).torch_dtype
        if dtype == "float32":
            np.testing.assert_allclose(np32(got), np32(want), rtol=0, atol=1e-5)
        else:
            assert rel_err(got, want) < BF16_REL
    if dtype == "float32":
        for name, tol in (("m", GRAD), ("v", dict(rtol=2e-3, atol=1e-9)), ("master", dict(rtol=0, atol=1e-5))):
            for got, want in zip(tree_leaves(opt[name]), jax.tree.leaves(ropt[name])):
                np.testing.assert_allclose(np32(got), np32(want), err_msg=name, **tol)


_STEP_LINE = re.compile(r"^step +(\d+) aux=(\S+) grad_norm=(\S+) loss=(\S+) nll=(\S+)$")
_DONE_LINE = re.compile(r"^done: 6 steps in \d+\.\ds \(\d+ ms/step\)$")


def test_cli_prints_the_reference_lines(monkeypatch, capsys):
    """``--arch tinyllama-1.1b --steps 6`` at the reduced config: the
    reference's lines, their numbers within the bfloat16 tolerance, with the
    port started from the reference's initial weights."""
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "tinyllama-1.1b", "--steps", "6"])
    ref_train.main()
    want = capsys.readouterr().out.splitlines()
    rcfg = ref_get_reduced_spec("tinyllama-1.1b").model_cfg
    init = from_reference(jax.tree.map(np.asarray, ref_params(rcfg, seed=0)), device="cpu")
    monkeypatch.setattr(port_tf, "init_params", lambda key, cfg, device: init)
    port_train.main(["--arch", "tinyllama-1.1b", "--steps", "6", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 3 and _DONE_LINE.match(got[-1]) and _DONE_LINE.match(want[-1])
    for g, w in zip(got[:-1], want[:-1]):
        gm, wm = _STEP_LINE.match(g), _STEP_LINE.match(w)
        assert gm and wm and gm.group(1) == wm.group(1), (g, w)
        assert float(gm.group(2)) == float(wm.group(2)) == 0.0
        for i in (3, 4, 5):  # grad_norm, loss, nll
            assert abs(float(gm.group(i)) / float(wm.group(i)) - 1) < BF16_REL, (g, w)


def test_cli_checkpoints_in_the_reference_format(tmp_path, capsys):
    port_train.main(["--arch", "stablelm-3b", "--steps", "4", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_4"]
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in out[:-1]] == ["0", "3"] and out[-1].startswith("done: 4 steps")
    cfg = get_reduced_spec("stablelm-3b").model_cfg
    params = port_tf.init_params(0, cfg, device="cpu")
    from repro_torch.optim import adamw_init

    template = {"params": params, "opt": adamw_init(params), "pipe": {"seed": np.int64(0), "step": np.int64(0)}}
    restored, step = restore_checkpoint(tmp_path, template, device="cpu")
    assert step == 4 and int(restored["opt"]["step"]) == 4 and int(restored["pipe"]["step"]) == 4
    ref_template = {"params": ref_params(ref_get_reduced_spec("stablelm-3b").model_cfg)}
    ref_template["opt"] = ref_adamw_init(ref_template["params"])
    ref_template["pipe"] = LMTokenPipeline(8, 4, 1).state.as_tree()
    manifest = (tmp_path / "step_4" / "manifest.json").read_text()
    assert str(jax.tree.flatten(ref_template)[1]) == treedef_str(template) and treedef_str(template) in manifest


@pytest.mark.parametrize("arch,item", [("gat-cora", "GNN models"), ("fm", None), ("olmoe-1b-7b", None)])
def test_cli_refuses_the_families_not_ported(arch, item, capsys):
    """No family refuses any more: the GNN (two steps), recsys and MoE
    families train."""
    steps = 2 if item is not None else 1
    port_train.main(["--arch", arch, "--steps", str(steps), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == steps + 1 and out[-1].startswith(f"done: {steps} steps")
    assert [ln.split()[:2] for ln in out[:-1]] == [["step", str(i)] for i in range(steps)]
    assert ("aux=" in out[0]) == (arch == "olmoe-1b-7b") and "loss=" in out[0]
    assert ("acc=" in out[0]) == (arch == "gat-cora")
