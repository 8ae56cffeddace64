"""The GNN train cells in worlds of gloo CPU ranks against the reference's
unsharded run: edges over the flattened ``(data, model)`` axes, nodes over
``data`` (``shard_nodes``).

``gat-cora``'s two reduced cells (``full_graph_sm``, a node task;
``molecule``, a graph task) and a cut of ``ogb_products`` with
``shard_nodes=True`` (64 nodes, 256 edges: both divide 2 and 4), on meshes
``1x2``, ``2x1`` (a world of two), ``2x2`` and ``1x4`` (a world of four:
under ``1x4`` the edges split four ways over ``model`` and the nodes stay
whole), with the
reference's weights carried across and the batch cut per rank by the
cell's ``in_specs``.  The batches hold padded edges (``src = dst = 0``,
mask 0, all at the end: the last rank's block is mostly padding) and
labels under a partial mask; in the cut, destination 5 has one incoming
edge in each rank's block, from sources whose features are scaled 4, 1,
1/4 and 1/16, so the ranks' segment maxima differ.  float32: loss and
accuracy rtol 1e-4 / atol 1e-5, gradients (every rank's, whole) and the
params after one AdamW step rtol 1e-3 / atol 1e-6; the reference runs
unsharded in a jax subprocess (``run_reference``, one device).  The
``in_specs`` are the reference's cell's on a mesh of the same shape.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest

from _torch_world_cases import _cell_spec
from _torch_worlds import run_reference, run_world
from repro.configs import get_reduced_spec as ref_get_reduced_spec
from repro.configs.common import ShapeCell as RefShapeCell
from repro.launch import steps as ref_steps
from repro.parallel import sharding as ref_sh
from jax.sharding import PartitionSpec as JP
from repro_torch.models import gnn
from repro_torch.tree import tree_flatten, tree_unflatten

CELLS = ["full_graph_sm", "molecule", "ogb_cut"]
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
# ogb_products cut to a size the CPU runs, its task and widths kept
OGB_CUT = {"n_nodes": 64, "n_edges": 256, "d_feat": 100, "n_classes": 47, "task": "node", "shard_nodes": True,
           "self_loops": False}
HUB = 5  # the cut's destination with an edge in every rank's block
FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-6)

# the reference's unsharded runs, in a jax subprocess (one device, one
# compute thread, nice 10): each cell's params from key i, and on its
# inputs the loss, accuracy and gradients, and one step of its train cell
# (metrics and new params); trees go out as their leaves in jax's order
_REFERENCE = r"""
import dataclasses
import numpy as np, jax
from repro.configs import get_reduced_spec
from repro.configs.common import ShapeCell
from repro.launch import steps
from repro.launch.mesh import make_smoke_mesh
from repro.models import gnn
from repro.optim import adamw_init
z = dict(np.load(INPUTS))
spec = get_reduced_spec("gat-cora")
spec = dataclasses.replace(spec, shapes={**spec.shapes, "ogb_cut": ShapeCell(name="ogb_cut", step="train",
                                                                           kind="cut", kwargs=%r)})
res = {}
def put(prefix, tree):
    for j, leaf in enumerate(jax.tree.leaves(tree)):
        res[f"{prefix}/{j}"] = np.asarray(leaf)
for i, cell in enumerate(%r):
    cfg = spec.cfg_for(cell)
    ng = spec.shapes[cell].kwargs.get("batch_graphs", 1)
    params = jax.jit(gnn.init_gat_params, static_argnums=1)(jax.random.key(i), cfg)
    batch = {k[len(cell) + 1:]: v for k, v in z.items() if k.startswith(cell + "/")}
    (loss, m), grads = jax.jit(jax.value_and_grad(lambda p, b: gnn.gat_loss(p, b, cfg, n_graphs=ng),
                                                  has_aux=True))(params, batch)
    new, _, sm = jax.jit(steps.build_cell(spec, cell, make_smoke_mesh()).fn)(params, adamw_init(params), batch)
    res[cell + "/metrics"] = np.asarray([loss, m["acc"], sm["loss"], sm["acc"]])
    put(cell + "/init", params)
    put(cell + "/grads", grads)
    put(cell + "/params", new)
np.savez(OUT, **res)
""" % (OGB_CUT, CELLS)


def _ref_spec():
    spec = ref_get_reduced_spec("gat-cora")
    cut = RefShapeCell(name="ogb_cut", step="train", kind="cut", kwargs=OGB_CUT)
    return dataclasses.replace(spec, shapes={**spec.shapes, "ogb_cut": cut})


def _batch(cfg, kw, seed: int) -> dict:
    """Real edges first, then a quarter padded; labels under a mask of
    about 0.8; for the cut, ``HUB``'s edges placed one in each quarter of
    the list from sources scaled 4, 1, 1/4 and 1/16."""
    rng = np.random.default_rng(seed)
    n, e = kw["n_nodes"], kw["n_edges"]
    real = e - e // 4
    src, dst = np.zeros(e, np.int32), np.zeros(e, np.int32)
    src[:real] = rng.integers(0, n, real)
    dst[:real] = rng.integers(1, n - 1, real)
    dst[:real][dst[:real] == HUB] = HUB + 1
    mask = np.zeros(e, np.int32)
    mask[:real] = 1
    x = rng.normal(size=(n, cfg.d_feat)).astype(np.float32)
    if "shard_nodes" in kw and kw["shard_nodes"]:
        for q, (s, scale) in enumerate(zip((10, 20, 30, 40), (4.0, 1.0, 0.25, 0.0625))):
            at = q * e // 4 + 1
            src[at], dst[at], mask[at] = s, HUB, 1
            x[s] *= scale
    out = {"x": x, "src": src, "dst": dst, "edge_mask": mask}
    ng = kw.get("batch_graphs", 1)
    nl = ng if cfg.task == "graph" else n
    out["labels"] = rng.integers(0, cfg.n_classes, nl).astype(np.int32)
    out["label_mask"] = (rng.random(nl) < 0.8).astype(np.int32)
    if cfg.task == "graph":
        out["graph_ids"] = np.repeat(np.arange(ng), n // ng).astype(np.int32)
    return out


def _leaves(out: dict, prefix: str) -> list:
    n = sum(1 for k in out if k.startswith(prefix + "/"))
    return [out[f"{prefix}/{j}"] for j in range(n)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    spec = _cell_spec("gat-cora", "ogb_cut", OGB_CUT)
    inputs = {cell: _batch(spec.cfg_for(cell), spec.shapes[cell].kwargs, seed=11 + i) for i, cell in enumerate(CELLS)}
    out = run_reference(_REFERENCE, 1, tmp_path_factory.mktemp("reference"),
                        inputs={f"{cell}/{k}": v for cell, b in inputs.items() for k, v in b.items()})
    params, ref = {}, {}
    for cell in CELLS:
        treedef = tree_flatten(gnn.gat_param_shapes(spec.cfg_for(cell)))[1]
        params[cell] = tree_unflatten(treedef, _leaves(out, f"{cell}/init"))
        loss, acc, step_loss, step_acc = (float(v) for v in out[f"{cell}/metrics"])
        ref[cell] = {"loss": loss, "acc": acc, "step": {"loss": step_loss, "acc": step_acc},
                     "grads": _leaves(out, f"{cell}/grads"), "params": _leaves(out, f"{cell}/params")}
    cases = {shape: {f"{cell} {shape[0]}x{shape[1]}": {
        "arch": "gat-cora", "shape": cell, "mesh": shape, "params": cell, "inputs": cell,
        "cut": OGB_CUT if cell == "ogb_cut" else None} for cell in CELLS} for shape in MESHES}
    base = {"params": params, "inputs": inputs}
    two = run_world(2, "_torch_world_cases:family_case", {"cases": {**cases[(1, 2)], **cases[(2, 1)]}, **base},
                    tmp_path_factory.mktemp("two"), timeout=900)
    four = run_world(4, "_torch_world_cases:family_case", {"cases": {**cases[(2, 2)], **cases[(1, 4)]}, **base},
                     tmp_path_factory.mktemp("four"), timeout=900)
    return ref, two + four, inputs


@pytest.mark.parametrize("mesh", [f"{a}x{b}" for a, b in MESHES])
@pytest.mark.parametrize("cell", CELLS)
def test_sharded_train_step_equals_the_unsharded_reference(world, cell, mesh):
    """Every rank: the loss and accuracy of the whole graph, every
    parameter's gradient whole (no sum over data after it), and the params
    after one step."""
    ref, ranks, _ = world
    want = ref[cell]
    key = f"{cell} {mesh}"
    got_ranks = [r[key] for r in ranks if key in r]
    assert len(got_ranks) == int(mesh[0]) * int(mesh[2])
    for got in got_ranks:
        np.testing.assert_allclose(got["loss"], want["loss"], **FWD)
        np.testing.assert_allclose(got["metrics"]["acc"], want["acc"], **FWD)
        for k in ("loss", "acc"):
            np.testing.assert_allclose(got["step"][k], want["step"][k], **FWD)
        assert len(jax.tree.leaves(got["grads"])) == len(want["grads"]) == len(want["params"])
        for g, w in zip(jax.tree.leaves(got["grads"]), want["grads"]):
            np.testing.assert_allclose(g, w, **GRAD)
        for g, w in zip(jax.tree.leaves(got["params"]), want["params"]):
            np.testing.assert_allclose(g, w, **GRAD)


@pytest.mark.parametrize("mesh", MESHES)
def test_in_specs_equal_the_references(world, mesh):
    """Each built cell's ``in_specs`` are the reference's cell's on a mesh
    of the same shape: the edges split over ``(data, model)``, and the
    cut's nodes over ``data``."""
    _, ranks, _ = world
    spec = _ref_spec()
    stand_in = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty(mesh, dtype=object))
    for cell in CELLS:
        flat, _ = jax.tree_util.tree_flatten_with_path(ref_steps.build_cell(spec, cell, stand_in).in_specs[2],
                                                       is_leaf=lambda x: isinstance(x, JP) or x is None)
        want = {ref_sh._path_str(p): tuple(s) for p, s in flat}
        for r in ranks:
            got = r.get(f"{cell} {mesh[0]}x{mesh[1]}")
            if got is not None:
                assert got["in_specs"][2] == want, cell
                assert got["in_specs"][2]["src"] == (("data", "model"),)
                assert got["in_specs"][2]["x"] == (("data" if cell == "ogb_cut" else None), None)


def test_the_cut_splits_a_destinations_edges_across_ranks_with_scores_apart(world):
    """Each quarter of the cut's edge list (a rank's block on 2x2) holds one
    real edge into ``HUB``, from sources whose feature norms lie more than
    ten times apart."""
    _, _, inputs = world
    b = inputs["ogb_cut"]
    e = len(b["src"])
    quarters = [np.flatnonzero((b["dst"][q * e // 4:(q + 1) * e // 4] == HUB)
                               & (b["edge_mask"][q * e // 4:(q + 1) * e // 4] > 0)) for q in range(4)]
    assert [len(q) for q in quarters] == [1, 1, 1, 1]
    norms = [float(np.linalg.norm(b["x"][b["src"][q * e // 4 + idx[0]]])) for q, idx in enumerate(quarters)]
    assert max(norms) / min(norms) > 10
