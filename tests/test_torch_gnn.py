"""The port's graph attention network (``repro_torch.models.gnn``), its cells
and the trainer's gnn branch against the reference's, on the CPU.

``gat-cora`` at the reduced spec's shapes (both cells: node and graph
task), with the reference's weights carried across by
``models/convert.py``, on batches built from numpy seeds that hold padded
edges (``src = dst = 0``, mask 0), a node with no incoming edge and a node
(node 0) whose only incoming edges are padding: forward, loss, accuracy and
gradients with the aggregate in one chunk and in several forced chunks;
three AdamW steps of the train cell; the trainer's batch and printed lines;
the four full-scale cells' abstract inputs and useful-work models.  float32
throughout: the port's ``index_add`` sums in another order than
``segment_sum``, so forward rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 /
atol 1e-6, params after three steps atol 1e-5.
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
from repro.launch import steps as ref_steps
from repro.launch import train as ref_train
from repro.launch.mesh import make_smoke_mesh as ref_make_smoke_mesh
from repro.models import gnn as ref_gnn
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.configs import get_reduced_spec, get_spec
from repro_torch.launch import dryrun, steps
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import gnn
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.tree import tree_leaves

# these tests run in parallel workers beside timing-sensitive ones
torch.set_num_threads(2)

SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]
REDUCED = ["full_graph_sm", "molecule"]
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
_DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32}


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _cfgs(shape):
    rspec, spec = ref_get_reduced_spec("gat-cora"), get_reduced_spec("gat-cora")
    return rspec.cfg_for(shape), spec.cfg_for(shape), spec.shapes[shape].kwargs


def _params(rcfg, seed=0):
    rp = jax.jit(ref_gnn.init_gat_params, static_argnums=1)(jax.random.key(seed), rcfg)
    return rp, from_reference(jax.tree.map(np.asarray, rp), device="cpu")


def _batch(cfg, kw, seed=0, n_pad=None):
    """A graph of the cell's shape from a numpy seed: real edges first,
    then ``n_pad`` padded ones (``src = dst = 0``, mask 0); no real edge
    ends at node 0 (its only incoming edges are padding) or at the last
    node (no incoming edge at all)."""
    rng = np.random.default_rng(seed)
    n, e = kw["n_nodes"], kw["n_edges"]
    n_pad = e // 4 if n_pad is None else n_pad
    real = e - n_pad
    src = np.zeros(e, np.int32)
    dst = np.zeros(e, np.int32)
    src[:real] = rng.integers(0, n, real)
    dst[:real] = rng.integers(1, n - 1, real)
    mask = np.zeros(e, np.int32)
    mask[:real] = 1
    out = {"x": rng.normal(size=(n, cfg.d_feat)).astype(np.float32), "src": src, "dst": dst, "edge_mask": mask}
    ng = kw.get("batch_graphs", 1)
    nl = ng if cfg.task == "graph" else n
    out["labels"] = rng.integers(0, cfg.n_classes, nl).astype(np.int32)
    out["label_mask"] = (rng.random(nl) < 0.8).astype(np.int32)
    if cfg.task == "graph":
        out["graph_ids"] = np.repeat(np.arange(ng), n // ng).astype(np.int32)
    return out, ng


@pytest.mark.parametrize("shape", REDUCED)
def test_init_has_the_reference_tree(shape):
    rcfg, cfg, _ = _cfgs(shape)
    rp = ref_gnn.init_gat_params(jax.random.key(0), rcfg)
    pp = gnn.init_gat_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert len(pp) == len(rp) == cfg.n_layers
    for got, want in zip(tree_leaves(pp), jax.tree.leaves(rp)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        # dense_init's scale: fan-in = shape[-2] (the heads, for w)
        np.testing.assert_allclose(float(got.std()), float(np.asarray(want).std()), rtol=0.5)
    shapes = gnn.gat_param_shapes(cfg)
    assert [tuple(t.shape) for t in tree_leaves(shapes)] == [tuple(t.shape) for t in tree_leaves(pp)]
    assert cfg.param_count() == rcfg.param_count() == sum(t.numel() for t in tree_leaves(pp))
    back = to_reference(pp)
    assert all(isinstance(a, np.ndarray) and np.array_equal(a, _np(t)) for a, t in zip(tree_leaves(back),
                                                                                     tree_leaves(pp)))


@pytest.mark.parametrize("chunk", [None, 1, 7, 64])
@pytest.mark.parametrize("shape", REDUCED)
def test_forward_loss_and_accuracy_equal_the_reference(shape, chunk):
    """Padded edges, a node with no incoming edge and one whose only
    incoming edges are padding; the aggregate in ``chunk`` edges a chunk
    (None: one chunk here)."""
    rcfg, cfg, kw = _cfgs(shape)
    rp, pp = _params(rcfg, seed=1)
    batch, ng = _batch(cfg, kw, seed=2)
    want = ref_gnn.gat_forward(rp, batch, rcfg, n_graphs=ng)
    got = gnn.gat_forward(pp, _t(batch), cfg, n_graphs=ng, edge_chunk=chunk)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
    rl, rm = ref_gnn.gat_loss(rp, batch, rcfg, n_graphs=ng)
    loss, m = gnn.gat_loss(pp, _t(batch), cfg, n_graphs=ng, edge_chunk=chunk)
    np.testing.assert_allclose(float(loss), float(rl), **FWD)
    assert float(m["acc"]) == float(rm["acc"])
    if cfg.task == "node":
        # the last node has no incoming edge: every head's message is 0
        assert float(got[-1].abs().max()) == float(np.abs(np.asarray(want)[-1]).max()) == 0.0


@pytest.mark.parametrize("chunk", [None, 5])
@pytest.mark.parametrize("shape", REDUCED)
def test_gradients_equal_the_reference(shape, chunk):
    rcfg, cfg, kw = _cfgs(shape)
    rp, pp = _params(rcfg, seed=3)
    batch, ng = _batch(cfg, kw, seed=4)
    want = jax.grad(lambda p: ref_gnn.gat_loss(p, batch, rcfg, n_graphs=ng)[0])(rp)
    live = [t.clone().requires_grad_(True) for t in tree_leaves(pp)]
    params = [dict(zip(sorted(layer), live[3 * i: 3 * i + 3])) for i, layer in enumerate(pp)]
    loss, _ = gnn.gat_loss(params, _t(batch), cfg, n_graphs=ng, edge_chunk=chunk)
    grads = torch.autograd.grad(loss, live)
    for g, w in zip(grads, jax.tree.leaves(want)):
        np.testing.assert_allclose(_np(g), np.asarray(w), **GRAD)


def test_ties_and_all_padding_rows():
    """Equal edge scores into one node (a tie in the segment max), a
    destination reached only by padding, and a graph of padding alone."""
    rcfg, cfg, kw = _cfgs("full_graph_sm")
    rp, pp = _params(rcfg)
    n, e = kw["n_nodes"], 12
    rng = np.random.default_rng(5)
    x = np.repeat(rng.normal(size=(1, cfg.d_feat)), n, axis=0).astype(np.float32)  # every node alike
    src = np.array([1, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0], np.int32)
    dst = np.array([4, 4, 4, 5, 5, 0, 0, 0, 0, 0, 0, 0], np.int32)
    mask = np.array([1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], np.int32)
    labels = rng.integers(0, cfg.n_classes, n).astype(np.int32)
    for m in (mask, np.zeros(e, np.int32)):
        batch = {"x": x, "src": src, "dst": dst, "edge_mask": m, "labels": labels,
                 "label_mask": np.ones(n, np.int32)}
        want = jax.grad(lambda p: ref_gnn.gat_loss(p, batch, rcfg)[0])(rp)
        live = [t.clone().requires_grad_(True) for t in tree_leaves(pp)]
        params = [dict(zip(sorted(layer), live[3 * i: 3 * i + 3])) for i, layer in enumerate(pp)]
        out = gnn.gat_forward(params, _t(batch), cfg, edge_chunk=2)
        np.testing.assert_allclose(_np(out), np.asarray(ref_gnn.gat_forward(rp, batch, rcfg)), **FWD)
        loss, _ = gnn.gat_loss(params, _t(batch), cfg, edge_chunk=2)
        for g, w in zip(torch.autograd.grad(loss, live), jax.tree.leaves(want)):
            np.testing.assert_allclose(_np(g), np.asarray(w), **GRAD)


@pytest.mark.parametrize("chunk", [1, 3, 1000])
def test_chunked_aggregate_equals_the_unchunked_form(chunk):
    """``aggregate`` in chunks against ``aggregate_plain``: values and
    gradients in ``ex`` and ``h``."""
    gen = torch.Generator().manual_seed(6)
    n, e, nh, d = 11, 40, 3, 5
    src = torch.randint(0, n, (e,), generator=gen)
    dst = torch.randint(0, n, (e,), generator=gen)
    ex = torch.rand(e, nh, generator=gen, requires_grad=True)
    h = torch.randn(n, nh, d, generator=gen, requires_grad=True)
    g_out = torch.randn(n, nh, d, generator=gen)
    got = gnn.aggregate(ex, h, src, dst, chunk)
    want = gnn.aggregate_plain(ex, h, src, dst)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for a, b in zip(torch.autograd.grad(got, (ex, h), g_out), torch.autograd.grad(want, (ex, h), g_out)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_edge_chunk_follows_the_memory_budget():
    assert gnn.edge_chunk(10, 8, 47, "cpu") == 10
    # one [chunk, 8, 47] float32 tensor within 256 MiB on the host
    assert gnn.edge_chunk(61_859_140, 8, 47, "cpu") == (256 << 20) // (8 * 47 * 4)
    assert gnn.edge_chunk(5, 10**9, 10**9, "cpu") == 1


@pytest.mark.parametrize("shape", REDUCED)
def test_three_train_steps_equal_the_reference(shape):
    """The train cell (AdamW lr 5e-3, weight decay 5e-4) from the
    reference's weights on the reference trainer's batch."""
    rspec, spec = ref_get_reduced_spec("gat-cora"), get_reduced_spec("gat-cora")
    ref_step = jax.jit(ref_steps.build_cell(rspec, shape, ref_make_smoke_mesh()).fn)
    cell = steps.build_cell(spec, shape, make_smoke_mesh())
    rp, pp = _params(rspec.cfg_for(shape), seed=7)
    ropt = ref_adamw_init(rp)
    opt = from_reference(jax.tree.map(np.asarray, ropt), device="cpu")
    batch, _ = ref_train._concrete_batch(rspec, shape, None, seed=7)
    for step in range(3):
        rp, ropt, rm = ref_step(rp, ropt, batch)
        inputs = [t.clone() for t in tree_leaves((pp, opt))]
        new_p, new_opt, m = cell.fn(pp, opt, _t(batch))
        assert all(torch.equal(a, b) for a, b in zip(inputs, tree_leaves((pp, opt))))
        pp, opt = new_p, new_opt
        assert sorted(m) == sorted(rm) == ["acc", "loss"] and int(opt["step"]) == step + 1
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), **FWD)
        assert float(m["acc"]) == float(rm["acc"])
    for got, want in zip(tree_leaves(pp), jax.tree.leaves(rp)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", REDUCED)
def test_gnn_batch_is_the_reference_trainers_batch(shape):
    spec, rspec = get_reduced_spec("gat-cora"), ref_get_reduced_spec("gat-cora")
    kw = spec.shapes[shape].kwargs
    want, pipe = ref_train._concrete_batch(rspec, shape, None, seed=3)
    got = dryrun.gnn_batch(spec.cfg_for(shape), kw["n_nodes"], kw["n_edges"], kw.get("batch_graphs", 1), seed=3)
    assert pipe is None and sorted(got) == sorted(want)
    assert all(got[k].dtype == want[k].dtype and got[k].shape == want[k].shape and (got[k] == want[k]).all()
               for k in want)


@pytest.mark.parametrize("shape", SHAPES)
def test_cells_equal_the_reference_cells(shape):
    """Full-scale abstract args (params, AdamW state, batch) and useful-work
    models against the reference's ``_gnn_cell``."""
    ref = ref_steps.build_cell(ref_get_spec("gat-cora"), shape, ref_make_smoke_mesh())
    cell = steps.build_cell(get_spec("gat-cora"), shape, make_smoke_mesh())
    assert (cell.step, cell.shape_name, cell.arch_id) == (ref.step, ref.shape_name, ref.arch_id) == (
        "train", shape, "gat-cora")
    got, want = tree_leaves(cell.abstract_args), jax.tree.leaves(ref.abstract_args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta" and tuple(g.shape) == tuple(w.shape) and g.dtype == _DTYPES[w.dtype.type]
    assert sorted(cell.abstract_args[2]) == sorted(ref.abstract_args[2])
    assert cell.model_flops_fn() == ref.model_flops_fn()


@pytest.mark.parametrize("shape", REDUCED)
def test_run_cell_on_the_cpu_reduced_spec(shape, monkeypatch):
    monkeypatch.setattr(dryrun, "get_spec", get_reduced_spec)
    rec = dryrun.run_cell("gat-cora", shape, False, verbose=False, device="cpu", repeats=1)
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec["result"]) == {"loss", "acc"} and np.isfinite(rec["result"]["loss"])
    assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
    assert rec["collective_bytes_per_device"] == {} and rec["collective_total_per_device"] == 0
    kw = get_reduced_spec("gat-cora").shapes[shape].kwargs
    assert rec["input_shapes"][2]["src"] == [kw["n_edges"]] and rec["input_shapes"][2]["x"] == [
        kw["n_nodes"], kw["d_feat"]]


_STEP_LINE = re.compile(r"^step +(\d+) acc=(\S+) loss=(\S+)$")


def test_cli_prints_the_reference_lines(monkeypatch, capsys):
    """``--arch gat-cora --steps 6`` at the reduced config: the reference's
    lines, from the reference's initial weights on its batch."""
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "gat-cora", "--steps", "6"])
    ref_train.main()
    want = capsys.readouterr().out.splitlines()
    rcfg = ref_get_reduced_spec("gat-cora").cfg_for("full_graph_sm")
    init = from_reference(jax.tree.map(np.asarray, ref_gnn.init_gat_params(jax.random.key(0), rcfg)),
                          device="cpu")
    monkeypatch.setattr(gnn, "init_gat_params", lambda key, cfg, device: init)
    port_train.main(["--arch", "gat-cora", "--steps", "6", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 3 and got[-1].startswith("done: 6 steps")
    for g, w in zip(got[:-1], want[:-1]):
        gm, wm = _STEP_LINE.match(g), _STEP_LINE.match(w)
        assert gm and wm and gm.group(1) == wm.group(1), (g, w)
        assert gm.group(2) == wm.group(2), (g, w)
        np.testing.assert_allclose(float(gm.group(3)), float(wm.group(3)), rtol=1e-4, atol=1e-5)
