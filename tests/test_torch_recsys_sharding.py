"""The recsys cells in worlds of gloo CPU ranks against the reference's
unsharded run: row-sharded tables, column-split MLP weights, the batch over
the data axes and MIND's negatives from the whole global batch.

FM, AutoInt, DCN-v2 and MIND at their reduced configs (every table's rows
divide 2, so each is row-sharded over ``model``; DCN-v2's ``mlp/*/w``
column-split), each cell (train, score, retrieval) on meshes ``1x2``,
``2x1`` (a world of two) and ``2x2`` (a world of four), and in the world of
four FM under ``1x4`` (its 2,000 rows a quarter a rank) and MIND under
``4x1`` (its negatives from four data ranks' rows), with the
reference's weights carried across and cut per rank by the cell's
``in_specs``; the reference runs unsharded in a jax subprocess
(``run_reference``, one device).  float32: forward (loss, scores) rtol 1e-4 / atol 1e-5,
gradients (gathered) and the params after one AdamW step rtol 1e-3 / atol
1e-6.  The ``in_specs`` are the reference's on a forced host mesh of the
same shape, and a world of two saves a row-sharded train state as the one
rank save, byte for byte.
"""

import json

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_worlds import reference_in_specs, run_reference, run_world, spec_key
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_reduced_spec
from repro_torch.launch import dryrun
from repro_torch.models import recsys
from repro_torch.models.convert import from_reference
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_flatten, tree_unflatten

MODELS = ["fm", "autoint", "dcn-v2", "mind"]
CELLS = ["train_batch", "serve_p99", "retrieval_cand"]
MESHES = [(1, 2), (2, 1), (2, 2)]
FOUR = {"fm": (1, 4), "mind": (4, 1)}  # the further meshes of the world of four
FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-6)

# the reference's unsharded runs, in a jax subprocess (one device, one
# compute thread, nice 10): each model's params from key i, and on the
# inputs of each (model, cell) its scores, or its loss, gradients and one
# step of its train cell (new params and AdamW state); MIND's loss on each
# half of its batch alone.  Trees go out as their leaves in jax's order.
_REFERENCE = r"""
import numpy as np, jax
from repro.configs import get_reduced_spec
from repro.launch import steps
from repro.launch.mesh import make_smoke_mesh
from repro.models import recsys
from repro.optim import adamw_init
z = dict(np.load(INPUTS))
res = {}
def put(prefix, tree):
    for j, leaf in enumerate(jax.tree.leaves(tree)):
        res[f"{prefix}/{j}"] = np.asarray(leaf)
for i, arch in enumerate(%r):
    spec = get_reduced_spec(arch)
    cfg = spec.model_cfg
    params = jax.jit(recsys.init_recsys_params, static_argnums=1)(jax.random.key(i), cfg)
    put(f"{arch}/init", params)
    for cell in %r:
        pre = f"{arch} {cell}/"
        batch = {k[len(pre):]: v for k, v in z.items() if k.startswith(pre)}
        if cell == "serve_p99":
            res[pre + "scores"] = np.asarray(jax.jit(lambda p, b: recsys.recsys_score(p, b, cfg))(params, batch))
        elif cell == "retrieval_cand":
            res[pre + "scores"] = np.asarray(
                jax.jit(lambda p, b: recsys.recsys_retrieval_score(p, b, cfg))(params, batch))
        else:
            (loss, _), grads = jax.jit(jax.value_and_grad(lambda p, b: recsys.recsys_loss(p, b, cfg),
                                                          has_aux=True))(params, batch)
            step = jax.jit(steps.build_cell(spec, "train_batch", make_smoke_mesh()).fn)
            new, opt, m = step(params, adamw_init(params), batch)
            res[pre + "loss"], res[pre + "step_loss"] = np.asarray(loss), np.asarray(m["loss"])
            put(pre + "grads", grads)
            put(pre + "params", new)
            put(pre + "opt", opt)
            if arch == "mind":
                n = len(batch["target_id"]) // 2
                res[pre + "halves"] = np.asarray([recsys.recsys_loss(params, {k: v[h * n:(h + 1) * n]
                                                                         for k, v in batch.items()}, cfg)[0]
                                                  for h in range(2)])
np.savez(OUT, **res)
""" % (MODELS, CELLS)


def _inputs(arch: str, cell: str, seed: int) -> dict:
    """The reduced cell's batch from numpy seeds: the reference trainer's
    draw at the cell's rows (MIND with ``-1`` padding in its histories);
    a retrieval cell's one context and candidates over the item field."""
    cfg = get_reduced_spec(arch).model_cfg
    kw = get_reduced_spec(arch).shapes[cell].kwargs
    batch, _ = dryrun.recsys_batch(cfg, kw["batch"], seed)
    if cell == "retrieval_cand":
        rng = np.random.default_rng(seed)
        batch = {k: v[:1] for k, v in batch.items() if k not in ("label", "target_id")}
        batch["cand_ids"] = rng.integers(0, cfg.field_vocab[0], kw["n_candidates"]).astype(np.int32)
    elif cell != "train_batch":
        batch.pop("label", None)
    return batch


def _leaves(out: dict, prefix: str) -> list:
    n = sum(1 for k in out if k.startswith(prefix + "/"))
    return [out[f"{prefix}/{j}"] for j in range(n)]


def _tree(template, leaves: list):
    """``leaves`` (jax's order, which the port's trees keep) in the shape of
    the port's tree ``template``."""
    return tree_unflatten(tree_flatten(template)[1], leaves)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = {f"{arch} {cell}": _inputs(arch, cell, seed=7 + i) for i, arch in enumerate(MODELS) for cell in CELLS}
    out = run_reference(_REFERENCE, 1, tmp_path_factory.mktemp("reference"),
                        inputs={f"{key}/{k}": v for key, b in inputs.items() for k, v in b.items()})
    shapes = {arch: recsys.recsys_param_shapes(get_reduced_spec(arch).model_cfg) for arch in MODELS}
    params = {arch: _tree(shapes[arch], _leaves(out, f"{arch}/init")) for arch in MODELS}
    ref = {}
    for key in inputs:
        if key.endswith("train_batch"):
            arch = key.split(" ")[0]
            ref[key] = {"loss": float(out[f"{key}/loss"]), "step_loss": float(out[f"{key}/step_loss"]),
                        "grads": _leaves(out, f"{key}/grads"), "params": _leaves(out, f"{key}/params"),
                        "opt": _tree(adamw_init(shapes[arch]), _leaves(out, f"{key}/opt"))}
            if arch == "mind":
                ref[key]["halves"] = out[f"{key}/halves"]
        else:
            ref[key] = {"scores": out[f"{key}/scores"]}
    cases = {shape: {f"{key} {shape[0]}x{shape[1]}": {"arch": key.split(" ")[0], "shape": key.split(" ")[1],
                                                      "mesh": shape, "params": key.split(" ")[0], "inputs": key}
                     for key in inputs} for shape in MESHES}
    root = tmp_path_factory.mktemp("ckpt")
    state = {"params": _tree(shapes["fm"], ref["fm train_batch"]["params"]), "opt": ref["fm train_batch"]["opt"]}
    save_checkpoint(root / "world1", 1, {k: from_reference(v, device="cpu") for k, v in state.items()})
    two = run_world(2, "_torch_world_cases:family_case",
                    {"cases": {**cases[(1, 2)], **cases[(2, 1)]}, "params": params, "inputs": inputs,
                     "save_case": "fm train_batch 1x2", "save": str(root / "world2"), "state": state},
                    tmp_path_factory.mktemp("two"), timeout=900)
    further = {f"{arch} {cell} {shape[0]}x{shape[1]}": {"arch": arch, "shape": cell, "mesh": shape, "params": arch,
                                                         "inputs": f"{arch} {cell}"}
               for arch, shape in FOUR.items() for cell in CELLS}
    four = run_world(4, "_torch_world_cases:family_case", {"cases": {**cases[(2, 2)], **further}, "params": params,
                                                           "inputs": inputs},
                     tmp_path_factory.mktemp("four"), timeout=900)
    specs = reference_in_specs([(shape, arch, cell, {}) for shape in MESHES for arch in MODELS for cell in CELLS]
                               + [(shape, arch, cell, {}) for arch, shape in FOUR.items() for cell in CELLS], 4,
                               tmp_path_factory.mktemp("specs"))
    return ref, two + four, specs, root


@pytest.mark.parametrize("mesh", [f"{a}x{b}" for a, b in MESHES])
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", MODELS)
def test_sharded_cell_equals_the_unsharded_reference(world, arch, cell, mesh):
    """Every rank of the world: the loss, the gradients (gathered) and the
    params after one step, or the scores gathered over the rows' axes."""
    _check_cell(world, arch, cell, mesh)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", list(FOUR))
def test_four_rank_cell_equals_the_unsharded_reference(world, arch, cell):
    """FM under ``1x4`` and MIND under ``4x1``, as the meshes above."""
    _check_cell(world, arch, cell, "x".join(map(str, FOUR[arch])))


@pytest.mark.parametrize("arch", list(FOUR))
def test_four_rank_in_specs_equal_the_reference_forced_mesh(world, arch):
    """FM's table and ``w_linear`` row-sharded four ways, MIND's batch over
    four data ranks: each cell's ``in_specs`` are the reference's on a
    forced host mesh of four devices."""
    _, ranks, specs, _ = world
    shape = FOUR[arch]
    for cell in CELLS:
        want = specs[spec_key(shape, arch, cell, {})]
        got = [r[f"{arch} {cell} {shape[0]}x{shape[1]}"]["in_specs"] for r in ranks
               if f"{arch} {cell} {shape[0]}x{shape[1]}" in r]
        assert len(got) == 4
        for g in got:
            assert [{k: list(v) for k, v in t.items()} for t in g] == want, cell
    fm = [r["fm train_batch 1x4"]["in_specs"][0] for r in ranks if "fm train_batch 1x4" in r]
    assert len(fm) == 4 and all(g["table"] == ("model", None) and g["w_linear"] == ("model",) for g in fm)


def _check_cell(world, arch, cell, mesh):
    ref, ranks, _, _ = world
    want = ref[f"{arch} {cell}"]
    key = f"{arch} {cell} {mesh}"
    got_ranks = [r[key] for r in ranks if key in r]
    assert len(got_ranks) == int(mesh[0]) * int(mesh[2])
    for got in got_ranks:
        if cell != "train_batch":
            assert got["scores"].shape == want["scores"].shape
            np.testing.assert_allclose(got["scores"], want["scores"], **FWD)
            continue
        np.testing.assert_allclose(got["loss"], want["loss"], **FWD)
        np.testing.assert_allclose(got["step"]["loss"], want["step_loss"], **FWD)
        assert len(jax.tree.leaves(got["grads"])) == len(want["grads"]) == len(want["params"])
        for g, w in zip(jax.tree.leaves(got["grads"]), want["grads"]):
            np.testing.assert_allclose(g, w, **GRAD)
        for g, w in zip(jax.tree.leaves(got["params"]), want["params"]):
            np.testing.assert_allclose(g, w, **GRAD)


@pytest.mark.parametrize("mesh", MESHES)
def test_in_specs_equal_the_reference_forced_mesh(world, mesh):
    """Each built cell's ``in_specs`` (every rank's) are the reference's on a
    forced host mesh of the same shape; the tables are row-sharded."""
    _, ranks, specs, _ = world
    for arch in MODELS:
        for cell in CELLS:
            want = specs[spec_key(mesh, arch, cell, {})]
            for r in ranks:
                got = r.get(f"{arch} {cell} {mesh[0]}x{mesh[1]}")
                if got is not None:
                    assert [{k: list(v) for k, v in t.items()} for t in got["in_specs"]] == want, (arch, cell)
                    assert got["in_specs"][0]["table"] == ("model", None)


@pytest.mark.parametrize("mesh", [f"{a}x{b}" for a, b in MESHES])
def test_mind_loss_is_the_global_in_batch_loss(world, mesh):
    """MIND's loss takes its negatives from the whole global batch: it is
    the reference's loss over all 64 rows, not the mean of each data rank's
    own in-batch losses (which differ from it)."""
    ref, ranks, _, _ = world
    key = "mind train_batch"
    per_rank = float(np.mean(ref[key]["halves"]))
    assert abs(per_rank - ref[key]["loss"]) > 1e-3
    for r in ranks:
        got = r.get(f"{key} {mesh}")
        if got is not None:
            np.testing.assert_allclose(got["loss"], ref[key]["loss"], **FWD)
            assert abs(got["loss"] - per_rank) > 1e-3


def test_a_world_save_of_a_row_sharded_table_is_the_one_rank_file(world):
    """fm's train state (its table and ``w_linear`` row-sharded on ``1x2``)
    saved by a world of two is the one-rank checkpoint, byte for byte."""
    root = world[3]
    a, b = root / "world2" / "step_1", root / "world1" / "step_1"
    assert (a / "arrays.npz").read_bytes() == (b / "arrays.npz").read_bytes()
    ma, mb = json.loads((a / "manifest.json").read_text()), json.loads((b / "manifest.json").read_text())
    ma.pop("time"), mb.pop("time")
    assert ma == mb


@pytest.mark.parametrize("shape", [(6, 3), (6,)])
def test_lookup_with_no_mesh_is_the_one_card_gather(shape):
    """``recsys.lookup`` without a mesh is ``F.embedding`` (a ``[V]``
    table: an index), bit for bit; ``embedding_bag`` is unchanged."""
    g = torch.Generator().manual_seed(0)
    table = torch.randn(shape, generator=g)
    ids = torch.randint(0, 6, (4, 5), generator=g)
    want = F.embedding(ids, table) if len(shape) == 2 else table[ids]
    assert torch.equal(recsys.lookup(table, ids), want)
    if len(shape) == 2:
        bag_ids = torch.where(ids > 3, -1, ids)
        want = (F.embedding(bag_ids.clamp(min=0), table) * (bag_ids >= 0)[..., None]).sum(1)
        assert torch.equal(recsys.embedding_bag(table, bag_ids), want)
