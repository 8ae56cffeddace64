"""``repro_torch.parallel.sharding`` against the reference's rules, spec for
spec, and ``shard_tree`` / ``gather_tree`` in a gloo world of four.

The reference's rules and its cells' ``in_specs`` are computed over the
production meshes' shapes (a stand-in mesh object with their axis names and
shapes: the rules read nothing else), over the param trees of every LM,
recsys and GNN config; the port's must be the same specs at the same paths.
"""

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_worlds import run_world
from repro.configs import ARCH_IDS
from repro.configs import get_spec as ref_get_spec
from repro.launch.steps import build_cell as ref_build_cell
from repro.launch.steps import sanitize_specs as ref_sanitize
from repro.parallel import sharding as ref_sh
from repro_torch.configs import get_spec
from repro_torch.launch.mesh import MeshLayout, make_production_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.models import recsys, transformer
from repro_torch.parallel import sharding as sh

MESHES = {"single": ((16, 16), ("data", "model")), "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, dtype=object))


def _ref_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP) or x is None)
    return {ref_sh._path_str(path): None if s is None else tuple(s) for path, s in flat}


def _port_specs(tree) -> dict:
    out = {}

    def put(path, s):
        out[path] = tuple(s)
        return s

    sh.map_with_path(put, tree)
    return out


def _family(arch):
    return ref_get_spec(arch).family


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if _family(a) == "lm"])
@pytest.mark.parametrize("kv_shardable", [True, False])
@pytest.mark.parametrize("fsdp", [True, False])
def test_lm_param_specs_equal_the_reference(arch, kv_shardable, fsdp):
    from repro.models import transformer as ref_tf

    cfg = ref_get_spec(arch).model_cfg
    ref_shapes = jax.eval_shape(lambda k: ref_tf.init_params(k, cfg), jax.random.key(0))
    want = _ref_specs(ref_sh.lm_param_specs(ref_shapes, kv_shardable, fsdp))
    got = _port_specs(sh.lm_param_specs(transformer.param_shapes(get_spec(arch).model_cfg), kv_shardable, fsdp))
    assert got == want


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if _family(a) == "recsys"])
def test_recsys_param_specs_equal_the_reference(arch):
    from repro.models import recsys as ref_rs

    cfg = ref_get_spec(arch).model_cfg
    ref_shapes = jax.eval_shape(lambda k: ref_rs.init_recsys_params(k, cfg), jax.random.key(0))
    want = _ref_specs(ref_sh.recsys_param_specs(ref_shapes))
    assert _port_specs(sh.recsys_param_specs(recsys.recsys_param_shapes(get_spec(arch).model_cfg))) == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shard_nodes", [True, False])
def test_gnn_batch_and_opt_specs_equal_the_reference(mesh, shard_nodes):
    shapes = {k: types.SimpleNamespace(shape=(8,)) for k in ("x", "src", "dst", "edge_mask", "labels", "label_mask",
                                                             "graph_ids", "other")}
    layout = MeshLayout(*MESHES[mesh])
    want = _ref_specs(ref_sh.gnn_specs(shapes, _ref_mesh(mesh), shard_nodes))
    assert _port_specs(sh.gnn_specs(shapes, layout, shard_nodes)) == want
    nested = {"a": types.SimpleNamespace(shape=(4, 3)), "b": [types.SimpleNamespace(shape=())]}
    assert _port_specs(sh.batch_specs(nested, layout)) == _ref_specs(ref_sh.batch_specs(nested, _ref_mesh(mesh)))
    assert sh.data_axes(layout) == ref_sh.data_axes(_ref_mesh(mesh))
    assert tuple(sh.lm_cache_spec()) == tuple(ref_sh.lm_cache_spec())
    specs = {"w": sh.P("data", None)}
    assert sh.opt_state_specs(specs) is specs


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_cells_in_specs_equal_the_reference_on_the_production_meshes(arch):
    """``sanitize_specs`` of every rule, as each cell carries them, on the
    single- and multi-pod meshes."""
    ref_spec, spec = ref_get_spec(arch), get_spec(arch)
    for mesh in sorted(MESHES):
        layout = make_production_mesh(multi_pod=mesh == "multi")
        for shape in ref_spec.shapes:
            want = _ref_specs(ref_build_cell(ref_spec, shape, _ref_mesh(mesh)).in_specs)
            got = _port_specs(build_cell(spec, shape, layout).in_specs)
            assert got == want, (mesh, shape)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sanitize_specs_equals_the_reference(mesh):
    shapes = {"a": types.SimpleNamespace(shape=(32, 24)), "b": types.SimpleNamespace(shape=(5, 16, 2)),
              "c": types.SimpleNamespace(shape=())}
    ref_in = {"a": JP(("pod", "data") if mesh == "multi" else "data", "model"), "b": JP(None, "model", "data"),
              "c": JP()}
    port_in = {k: sh.P(*v) for k, v in ref_in.items()}
    want = _ref_specs(ref_sanitize(ref_in, shapes, _ref_mesh(mesh)))
    assert _port_specs(sh.sanitize_specs(port_in, shapes, MeshLayout(*MESHES[mesh]))) == want


def _world(payload):
    """shard_tree then gather_tree on each mesh; the slices' shapes."""
    import dataclasses

    from repro_torch.configs import get_reduced_spec
    from repro_torch.launch.mesh import make_device_mesh

    out = {}
    for shape, axes in payload["meshes"]:
        mesh = make_device_mesh(shape, axes, backend="gloo", device="cpu")
        for arch in ("tinyllama-1.1b", "olmoe-1b-7b", "llama4-maverick-400b-a17b"):
            cfg = dataclasses.replace(get_reduced_spec(arch).model_cfg, fsdp=True)
            full = transformer.init_params(0, cfg, device="cpu")
            tp = dict(zip(mesh.axis_names, mesh.shape))["model"]
            specs = sh.sanitize_specs(sh.lm_param_specs(full, cfg.n_kv_heads % tp == 0), full, mesh)
            local = sh.shard_tree(full, specs, mesh)
            back = sh.gather_tree(local, specs, mesh)
            from repro_torch.tree import tree_leaves

            out[(shape, arch)] = {
                "identity": all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(full))),
                "local_numel": sum(x.numel() for x in tree_leaves(local)),
                "full_numel": sum(x.numel() for x in tree_leaves(full)),
            }
        if shape == (2, 2):
            from repro_torch.launch import dryrun

            for cell in ("decode_32k", "long_500k[swa]"):
                spec = get_reduced_spec("tinyllama-1.1b")
                rec = dryrun.run_cell("tinyllama-1.1b", cell, verbose=False, device="cpu", repeats=0, spec=spec,
                                      dmesh=mesh)
                out[("decode", cell)] = {k: rec.get(k) for k in ("status", "error", "input_shapes")}
                out[("decode", cell)]["seq_len"] = spec.shapes[cell].kwargs["seq_len"]
        import torch.distributed as dist

        out[(shape, "groups")] = {axes: (g is dist.group.WORLD, dist.get_world_size(g))
                                  for axes, g in mesh._groups.items()}
        batch = {"tokens": torch.arange(8 * 3).reshape(8, 3)}
        bspecs = sh.batch_specs(batch, mesh)
        out[(shape, "batch")] = {"rows": sh.shard_tree(batch, bspecs, mesh)["tokens"][:, 0].tolist(),
                                 "coord": mesh.coord(sh.data_axes(mesh))}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    meshes = [((2, 2), ("data", "model")), ((2, 1, 2), ("pod", "data", "model")), ((4, 1), ("data", "model"))]
    return meshes, run_world(4, "test_torch_sharding:_world", {"meshes": meshes}, tmp_path_factory.mktemp("world"))


def test_shard_tree_then_gather_tree_is_the_identity(world):
    meshes, ranks = world
    for res in ranks:
        for key, row in res.items():
            if key[0] != "decode" and key[1] not in ("batch", "groups"):
                assert row["identity"], key
                assert row["local_numel"] < row["full_numel"], key


def test_batch_rows_split_over_the_data_axes_in_coordinate_order(world):
    meshes, ranks = world
    for shape, _ in meshes:
        n_data = int(np.prod(shape[:-1]))
        for res in ranks:
            row = res[(shape, "batch")]
            per = 8 // n_data
            assert row["rows"] == [3 * i for i in range(row["coord"] * per, (row["coord"] + 1) * per)]


def test_groups_of_the_whole_world_are_the_default_group(world):
    """Every mesh's group over all of the world's ranks (its every axis, or
    an axis as large as the world) is the default group, so NCCL holds one
    communicator for them all; every smaller group is a group of its own."""
    meshes, ranks = world
    for shape, axes in meshes:
        for res in ranks:
            groups = res[(shape, "groups")]
            assert len(groups) == 2 ** len(axes) - 1
            assert groups[axes] == (True, 4)
            for names, (is_world, size) in groups.items():
                want = int(np.prod([shape[axes.index(a)] for a in names]))
                assert size == want and is_world == (want == 4), (shape, names)


def _stand_in_world(shape):
    """A ``DeviceMesh`` of ``shape`` with no process group: enough to build
    a cell (rank 0's view)."""
    from repro_torch.launch.mesh import DeviceMesh

    return DeviceMesh(shape, ("data", "model"), "gloo", torch.device("cpu"), 0, None)


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)])
@pytest.mark.parametrize("arch,shape", [
    ("dcn-v2", "train_batch"),
    ("gat-cora", "molecule"),
    ("fm", "retrieval_cand"),
    ("gat-cora", "ogb_products"),
])
def test_recsys_and_gnn_cells_build_in_a_world_with_the_references_specs(arch, shape, mesh):
    """Under a world of two (formerly refused as the "recsys row-sharded
    tables" and "GNN edge and node sharding"), at full size: the cell builds
    and its ``in_specs`` are the reference's cell's on a mesh of that
    shape."""
    cell = build_cell(get_spec(arch), shape, make_production_mesh(), _stand_in_world(mesh))
    ref_mesh = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty(mesh, dtype=object))
    assert _port_specs(cell.in_specs) == _ref_specs(ref_build_cell(ref_get_spec(arch), shape, ref_mesh).in_specs)


@pytest.mark.parametrize("arch,shape,mesh", [
    ("tinyllama-1.1b", "decode_32k", (1, 2)),
    ("tinyllama-1.1b", "long_500k[swa]", (2, 2)),
])
def test_decode_cells_under_a_model_axis_build_and_run(world, arch, shape, mesh):
    """The context-parallel decode cells (formerly refused as the
    "sequence-sharded decode cache"): built at full size under a world of
    the mesh, the cache's positions split over ``model``; run reduced in the
    gloo world of four (2x2), every rank's record ok with its slice of the
    cache."""
    cell = build_cell(get_spec(arch), shape, make_production_mesh(), _stand_in_world(mesh))
    assert tuple(cell.in_specs[1]["k"])[2] == "model"
    _, ranks = world
    seq = get_spec(arch).shapes[shape].kwargs["seq_len"]
    for res in ranks:
        rec = res[("decode", shape)]
        assert rec["status"] == "ok", rec.get("error")
        assert rec["input_shapes"][1]["k"][2] == rec["seq_len"] // 2 and seq > rec["seq_len"]


def test_mesh_axes_equal_the_reference():
    from repro.launch.mesh import MESH_AXES as REF_MESH_AXES
    from repro_torch.launch.mesh import MESH_AXES

    assert MESH_AXES == REF_MESH_AXES == ("pod", "data", "model")
