"""The port's recsys models (``repro_torch.models.recsys``), their cells and
the trainer's recsys branch against the reference's, on the CPU.

FM, AutoInt, DCN-v2 and MIND at their reduced configs, with the reference's
weights carried across by ``models/convert.py``: score, loss, retrieval and
gradients (MIND's unrolled routing carries gradients: no stop-gradient),
three AdamW steps of the train cell, the trainer's printed lines, on the
batches the reference trainer draws; ``embedding_bag`` with ``-1`` padding
and its oracle; the cells' full-scale abstract inputs and useful-work
models; each reduced cell through the dry-run's ``run_cell``.  float32
throughout: forward rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-6,
params after three steps atol 1e-5.
"""

import dataclasses
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced_spec as ref_get_reduced_spec
from repro.configs import get_spec as ref_get_spec
from repro.kernels.ref import embedding_bag_ref as ref_embedding_bag_ref
from repro.launch import steps as ref_steps
from repro.launch import train as ref_train
from repro.launch.mesh import make_smoke_mesh as ref_make_smoke_mesh
from repro.models import recsys as ref_rs
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.configs import get_reduced_spec, get_spec
from repro_torch.kernels.ref import embedding_bag_ref
from repro_torch.launch import dryrun, steps
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import recsys
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.tree import tree_leaves

# these tests run in parallel workers beside timing-sensitive ones
torch.set_num_threads(2)

MODELS = ["fm", "autoint", "dcn-v2", "mind"]
SHAPES = ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]
FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-6)
_DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32}


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _setup(arch, rows=32, seed=0):
    """The reduced config in both packages, the reference's params (and
    the port's copy), and the reference trainer's first batch."""
    rcfg = ref_get_reduced_spec(arch).model_cfg
    cfg = get_reduced_spec(arch).model_cfg
    rp = jax.jit(ref_rs.init_recsys_params, static_argnums=1)(jax.random.key(seed), rcfg)
    batch, _ = dryrun.recsys_batch(cfg, rows, seed)
    return rcfg, cfg, rp, from_reference(jax.tree.map(np.asarray, rp), device="cpu"), batch


def _retrieval_batch(cfg, batch, n=40, seed=0):
    rng = np.random.default_rng(seed)
    out = {k: v[:1] for k, v in batch.items() if k not in ("label", "target_id")}
    out["cand_ids"] = rng.integers(0, cfg.field_vocab[0], n).astype(np.int32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_equals_the_reference(mode, weighted):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ids = rng.integers(-1, 50, (6, 5)).astype(np.int32)
    ids[2] = -1  # an empty bag
    w = rng.random((6, 5)).astype(np.float32) if weighted else None
    want = ref_rs.embedding_bag(jnp.asarray(table), jnp.asarray(ids), None if w is None else jnp.asarray(w), mode)
    got = recsys.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                               None if w is None else torch.from_numpy(w), mode)
    np.testing.assert_allclose(_np(got), _np(want), **FWD)
    assert not got[2].any()
    if mode == "sum":
        oracle = embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(ids),
                                   None if w is None else torch.from_numpy(w))
        want_oracle = ref_embedding_bag_ref(jnp.asarray(table), jnp.asarray(ids), None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(_np(oracle), _np(want_oracle), **FWD)
        np.testing.assert_allclose(_np(oracle), _np(got), **FWD)
    gathered = recsys.embedding_bag_gather(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_allclose(_np(gathered), _np(ref_rs.embedding_bag_gather(jnp.asarray(table), jnp.asarray(ids))))


@pytest.mark.parametrize("arch", MODELS)
def test_init_has_the_reference_tree(arch):
    rcfg, cfg, rp, _, _ = _setup(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    full, ref_full = get_spec(arch).model_cfg, ref_get_spec(arch).model_cfg
    assert dataclasses.asdict(full) == dataclasses.asdict(ref_full)
    pp = recsys.init_recsys_params(0, cfg, device="cpu")
    assert jax.tree.structure(to_reference(pp)) == jax.tree.structure(rp)
    for got, want in zip(tree_leaves(pp), jax.tree.leaves(rp)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert abs(float(pp["table"].std()) / 0.01 - 1) < 0.1
    shapes = recsys.recsys_param_shapes(full)
    assert all(t.device.type == "meta" for t in tree_leaves(shapes))
    # the reference's own tree, not its param_count (which also counts
    # MIND's interest init, a leaf its tree does not hold)
    assert full.param_count() == ref_full.param_count()
    ref_shapes = jax.eval_shape(lambda k: ref_rs.init_recsys_params(k, ref_full), jax.random.key(0))
    assert [tuple(t.shape) for t in tree_leaves(shapes)] == [s.shape for s in jax.tree.leaves(ref_shapes)]
    again = recsys.init_recsys_params(0, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pp), tree_leaves(again)))


@pytest.mark.parametrize("arch", MODELS)
def test_score_loss_and_retrieval_equal_the_reference(arch):
    rcfg, cfg, rp, pp, batch = _setup(arch, seed=1)
    want = jax.jit(lambda p, b: ref_rs.recsys_score(p, b, rcfg))(rp, batch)
    np.testing.assert_allclose(_np(recsys.recsys_score(pp, _t(batch), cfg)), _np(want), **FWD)
    want_loss, _ = jax.jit(lambda p, b: ref_rs.recsys_loss(p, b, rcfg))(rp, batch)
    loss, metrics = recsys.recsys_loss(pp, _t(batch), cfg)
    np.testing.assert_allclose(float(loss), float(want_loss), **FWD)
    assert sorted(metrics) == ["loss"]
    rb = _retrieval_batch(cfg, batch)
    want_r = jax.jit(lambda p, b: ref_rs.recsys_retrieval_score(p, b, rcfg))(rp, rb)
    got_r = recsys.recsys_retrieval_score(pp, _t(rb), cfg)
    assert got_r.shape == (40,)
    np.testing.assert_allclose(_np(got_r), _np(want_r), **FWD)


@pytest.mark.parametrize("arch", MODELS)
def test_retrieval_cell_scores_candidates_in_chunks_as_one_forward(arch, monkeypatch):
    """The retrieval cell scores its candidates in chunks (one card holds
    what the reference spreads over its data ranks): the same scores as
    one forward over all of them, and as the reference's."""
    rcfg, cfg, rp, pp, batch = _setup(arch, seed=4)
    rb = _retrieval_batch(cfg, batch, n=500, seed=4)
    spec = get_reduced_spec(arch)
    cell = steps.build_cell(spec, "retrieval_cand", make_smoke_mesh())
    monkeypatch.setattr(steps, "RETRIEVAL_CHUNK", 128)
    got = cell.fn(pp, _t(rb))
    whole = recsys.recsys_retrieval_score(pp, _t(rb), cfg)
    # float32 products blocked by another batch size: sums in another order
    assert got.shape == (500,) and torch.allclose(got, whole, rtol=1e-5, atol=1e-7)
    want = jax.jit(lambda p, b: ref_rs.recsys_retrieval_score(p, b, rcfg))(rp, rb)
    np.testing.assert_allclose(_np(got), _np(want), **FWD)


@pytest.mark.parametrize("arch", MODELS)
def test_gradients_equal_the_reference(arch):
    rcfg, cfg, rp, pp, batch = _setup(arch, seed=2)
    want = jax.jit(jax.grad(lambda p, b: ref_rs.recsys_loss(p, b, rcfg)[0]))(rp, batch)
    leaves = [t.requires_grad_(True) for t in tree_leaves(pp)]
    recsys.recsys_loss(pp, _t(batch), cfg)[0].backward()
    for got, g in zip(leaves, jax.tree.leaves(want)):
        assert got.grad is not None
        np.testing.assert_allclose(_np(got.grad), _np(g), **GRAD)


@pytest.mark.parametrize("arch", MODELS)
def test_three_train_steps_equal_the_reference(arch):
    rspec, spec = ref_get_reduced_spec(arch), get_reduced_spec(arch)
    ref_step = jax.jit(ref_steps.build_cell(rspec, "train_batch", ref_make_smoke_mesh()).fn)
    cell = steps.build_cell(spec, "train_batch", make_smoke_mesh())
    rcfg, cfg, rp, pp, batch = _setup(arch, rows=spec.shapes["train_batch"].kwargs["batch"], seed=3)
    ropt = ref_adamw_init(rp)
    opt = from_reference(jax.tree.map(np.asarray, ropt), device="cpu")
    _, pipe = dryrun.recsys_batch(cfg, spec.shapes["train_batch"].kwargs["batch"], seed=3)
    for step in range(3):
        if step:
            batch = pipe.next_batch()
        rp, ropt, rm = ref_step(rp, ropt, batch)
        inputs = [t.clone() for t in tree_leaves((pp, opt))]
        new_p, new_opt, m = cell.fn(pp, opt, _t(batch))
        assert all(torch.equal(a, b) for a, b in zip(inputs, tree_leaves((pp, opt))))
        pp, opt = new_p, new_opt
        assert sorted(m) == sorted(rm) == ["loss"] and int(opt["step"]) == step + 1
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), **FWD)
    for got, want in zip(tree_leaves(pp), jax.tree.leaves(rp)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", MODELS)
def test_recsys_batch_is_the_reference_trainers_batch(arch):
    spec, rspec = get_reduced_spec(arch), ref_get_reduced_spec(arch)
    want, want_pipe = ref_train._concrete_batch(rspec, "train_batch", None)
    got, pipe = dryrun.recsys_batch(spec.model_cfg, spec.shapes["train_batch"].kwargs["batch"])
    assert sorted(got) == sorted(want)
    assert all(got[k].dtype == want[k].dtype and (got[k] == want[k]).all() for k in want)
    nxt, want_nxt = pipe.next_batch(), want_pipe.next_batch()
    assert all((nxt[k] == want_nxt[k]).all() for k in want_nxt)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", MODELS)
def test_cells_equal_the_reference_cells(arch, shape):
    """Full-scale abstract args (params, AdamW state, batch) and useful-work
    models against the reference's ``_recsys_cell``; ``_recsys_flops``."""
    ref = ref_steps.build_cell(ref_get_spec(arch), shape, ref_make_smoke_mesh())
    cell = steps.build_cell(get_spec(arch), shape, make_smoke_mesh())
    assert (cell.step, cell.shape_name, cell.arch_id) == (ref.step, ref.shape_name, ref.arch_id)
    got, want = tree_leaves(cell.abstract_args), jax.tree.leaves(ref.abstract_args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta" and tuple(g.shape) == tuple(w.shape) and g.dtype == _DTYPES[w.dtype.type]
    assert cell.model_flops_fn() == ref.model_flops_fn()
    cfg = get_spec(arch).model_cfg
    for n in (1, 512, 65_536):
        assert steps._recsys_flops(cfg, n) == ref_steps._recsys_flops(ref_get_spec(arch).model_cfg, n)


@pytest.mark.parametrize("arch", MODELS)
def test_run_cell_on_the_cpu_reduced_spec(arch, monkeypatch):
    """Every reduced cell runs its whole batch through ``run_cell``."""
    monkeypatch.setattr(dryrun, "get_spec", get_reduced_spec)
    spec = get_reduced_spec(arch)
    for shape, meta in spec.shapes.items():
        rec = dryrun.run_cell(arch, shape, False, verbose=False, device="cpu", repeats=1)
        assert rec["status"] == "ok", rec.get("traceback")
        assert "model_flops_share" not in rec and rec["model_flops_global"] > 0
        if meta.step == "train":
            assert np.isfinite(rec["result"]["loss"])
            rows = meta.kwargs["batch"]
        else:
            assert np.isfinite(rec["result"]["scores_absmax"])
            rows = meta.kwargs.get("n_candidates", meta.kwargs["batch"])
        shapes = rec["input_shapes"][-1]
        assert (shapes["cand_ids"] if "cand_ids" in shapes else next(iter(shapes.values())))[0] == rows


_STEP_LINE = re.compile(r"^step +(\d+) loss=(\S+)$")


@pytest.mark.parametrize("arch", MODELS)
def test_cli_prints_the_reference_lines(arch, monkeypatch, capsys):
    """``--arch <recsys> --steps 6`` at the reduced config: the reference's
    lines, from the reference's initial weights on its batches."""
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--steps", "6"])
    ref_train.main()
    want = capsys.readouterr().out.splitlines()
    rcfg = ref_get_reduced_spec(arch).model_cfg
    init = from_reference(jax.tree.map(np.asarray, ref_rs.init_recsys_params(jax.random.key(0), rcfg)), device="cpu")
    monkeypatch.setattr(recsys, "init_recsys_params", lambda key, cfg, device: init)
    port_train.main(["--arch", arch, "--steps", "6", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 3 and got[-1].startswith("done: 6 steps")
    for g, w in zip(got[:-1], want[:-1]):
        gm, wm = _STEP_LINE.match(g), _STEP_LINE.match(w)
        assert gm and wm and gm.group(1) == wm.group(1), (g, w)
        np.testing.assert_allclose(float(gm.group(2)), float(wm.group(2)), rtol=1e-3, atol=1e-4)
