"""The LM train step on meshes of four gloo ranks against the reference's
unsharded run, the MoE ``local`` dispatch against the reference's
``shard_map`` on a forced host mesh (drops included), and the collectives
the cost counter charges against ``analyze_hlo``'s for the reduced cells
(train, prefill and the two context-parallel decode cells).

Meshes ``2x2`` (data x tensor/expert parallelism), ``2x2`` with ``fsdp``,
``1x4`` (tinyllama's 2 kv heads do not split 4 ways: ``wk`` and ``wv``
are replicated and each rank takes the kv head of its q heads), and ``4x1``
with and without ``fsdp`` (a row of the batch a rank; each layer gathered
over four data ranks), each cell's ``in_specs`` the reference's on a
forced host mesh of four devices.  The
variants: tinyllama, olmoe with a shared expert (its FFN column- and
row-split over ``model``), and llama4-maverick (dense and MoE sublayers
interleaved); MoE experts split over ``model`` (gathered for the
``einsum`` dispatch, which GSPMD runs over every expert and token for the
reference).  Tolerances as ``tests/test_torch_tensor_parallel.py``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _lm_compare import ref_cfg, ref_params
from _torch_worlds import reference_in_specs, run_reference, run_world, spec_key
from test_torch_tensor_parallel import check, run_cases

MESHES = [((2, 2), False), ((2, 2), True), ((1, 4), False), ((4, 1), False), ((4, 1), True)]
SHARED = {"moe": {"n_experts": 8, "top_k": 2, "d_ff": 64, "n_shared_experts": 1, "capacity_factor": 1.25,
                  "dispatch": "einsum"}}
VARIANTS = {"tinyllama-1.1b": ("tinyllama-1.1b", {}), "olmoe-shared": ("olmoe-1b-7b", SHARED),
            "llama4-maverick-400b-a17b": ("llama4-maverick-400b-a17b", {})}
MOE_CFG = {"n_experts": 8, "top_k": 2, "d_ff": 32, "n_shared_experts": 0, "dispatch": "local"}
CAPACITY = [8.0, 0.5]  # no drops; drops
CELLS = [("tinyllama-1.1b", "train_4k"), ("tinyllama-1.1b", "prefill_32k"), ("tinyllama-1.1b", "decode_32k"),
         ("tinyllama-1.1b", "long_500k[swa]"), ("fm", "train_batch"), ("gat-cora", "full_graph_sm")]

_REFERENCE = r"""
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models.moe import MoEConfig, init_moe_params, moe_ffn
from repro.configs import get_reduced_spec
from repro.launch.steps import build_cell
from repro.launch.hlo_analysis import analyze_hlo
z = dict(np.load(INPUTS))
mesh = jax.make_mesh((2, 2), ("data", "model"))
res = {}
params = {k[2:]: jnp.asarray(v) for k, v in z.items() if k.startswith("p_")}
x = jnp.asarray(z["x"])
for cf in %r:
    cfg = MoEConfig(capacity_factor=cf, **%r)
    with jax.set_mesh(mesh):
        y, aux = jax.jit(lambda x, p: moe_ffn(x, p, cfg))(x, params)
    res[f"y{cf}"], res[f"aux{cf}"] = np.asarray(y), np.asarray(aux)
# the reduced cells' collectives on the (2, 2) mesh, as the dry-run compiles them
# (a decode cell's dynamic_update_slice does not trace on jax 0.9's explicit
# axes: those cells compile on Auto axes)
auto = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
for i, (arch, shape) in enumerate(%r):
    spec = get_reduced_spec(arch)
    if spec.model_cfg is not None:  # gat-cora's config follows its cell
        spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(spec.model_cfg, dtype="float32"))
    m = auto if spec.shapes[shape].step == "decode" else mesh
    cell = build_cell(spec, shape, m)
    def sh(tree):
        return jax.tree.map(lambda s: NamedSharding(m, s) if isinstance(s, P) else s, tree,
                            is_leaf=lambda v: isinstance(v, P) or v is None)
    with jax.set_mesh(m):
        c = jax.jit(cell.fn, in_shardings=sh(cell.in_specs)).lower(*cell.abstract_args).compile()
    coll = analyze_hlo(c.as_text()).collectives
    res[f"coll{i}"] = np.asarray(sum(coll.values()))
np.savez(OUT, **res)
""" % (CAPACITY, MOE_CFG, CELLS)


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    return run_cases(4, MESHES, VARIANTS, tmp_path_factory.mktemp("lm"))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh", [f"{s[0]}x{s[1]}{' fsdp' if f else ''}" for s, f in MESHES])
def test_sharded_train_step_on_four_ranks_equals_the_unsharded_reference(lm, variant, mesh):
    ref, cases, params_of, ranks = lm
    check(ref, params_of, ranks, f"{variant} {mesh}")


@pytest.fixture(scope="module")
def lm_specs(tmp_path_factory):
    """The reference's train cell's ``in_specs`` for each (variant, mesh) on a
    forced host mesh of four devices."""
    cells = [(shape, arch, "train_4k", {**changes, "fsdp": fsdp}) for arch, changes in VARIANTS.values()
             for shape, fsdp in MESHES]
    return reference_in_specs(cells, 4, tmp_path_factory.mktemp("specs"))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh", [f"{s[0]}x{s[1]}{' fsdp' if f else ''}" for s, f in MESHES])
def test_train_in_specs_on_four_ranks_equal_the_reference_forced_mesh(lm, lm_specs, variant, mesh):
    """Every rank's train cell shards params, optimizer state and batch as
    the reference's cell does on a forced host mesh of the same shape."""
    _, cases, _, ranks = lm
    arch, shape, fsdp, changes = cases[f"{variant} {mesh}"]
    want = lm_specs[spec_key(shape, arch, "train_4k", {**changes, "fsdp": fsdp})]
    for r in ranks:
        assert [{k: list(v) for k, v in t.items()} for t in r[f"{variant} {mesh}"]["in_specs"]] == want


@pytest.fixture(scope="module")
def moe_and_collectives(tmp_path_factory):
    from repro.models.moe import MoEConfig, init_moe_params

    params = init_moe_params(jax.random.key(3), 16, MoEConfig(**MOE_CFG), jnp.float32)
    params = {k: np.asarray(v) for k, v in params.items()}
    x = np.random.default_rng(3).normal(size=(4, 64, 16)).astype(np.float32)
    ref = run_reference(_REFERENCE, 4, tmp_path_factory.mktemp("reference"),
                        inputs={"x": x, **{f"p_{k}": v for k, v in params.items()}})
    port = run_world(4, "_torch_world_cases:moe_local_case",
                     {"mesh": (2, 2), "params": params, "x": x, "cfg": MOE_CFG, "capacity_factors": CAPACITY},
                     tmp_path_factory.mktemp("moe"))
    from repro.configs import get_reduced_spec as ref_get_reduced_spec
    from repro.models import gnn as ref_gnn
    from repro.models import recsys as ref_rs
    from repro_torch.configs import get_reduced_spec
    from repro_torch.launch import dryrun

    gat = ref_get_reduced_spec("gat-cora").cfg_for("full_graph_sm")
    lm_params = {"tinyllama-1.1b": jax.tree.map(np.asarray, ref_params(ref_cfg("tinyllama-1.1b", "float32"))),
                 "fm": jax.tree.map(np.asarray, ref_rs.init_recsys_params(jax.random.key(0),
                                                                          ref_get_reduced_spec("fm").model_cfg)),
                 "gat-cora": jax.tree.map(np.asarray, ref_gnn.init_gat_params(jax.random.key(0), gat))}
    rng = np.random.default_rng(0)
    batch = {"train_4k": {"tokens": rng.integers(0, 256, (4, 128)).astype(np.int32),
                          "targets": rng.integers(0, 256, (4, 128)).astype(np.int32),
                          "mask": np.ones((4, 128), np.int32)},
             "prefill_32k": {"tokens": rng.integers(0, 256, (2, 256)).astype(np.int32)}}
    for shape, (rows, seq) in {"decode_32k": (4, 256), "long_500k[swa]": (1, 512)}.items():
        cache = (2, rows, seq, 2, 8)  # the reduced tinyllama's [L, B, S, Hkv, Dh]
        batch[shape] = {"k": rng.standard_normal(cache).astype(np.float32),
                        "v": rng.standard_normal(cache).astype(np.float32),
                        "tokens": rng.integers(0, 256, (rows, 1)).astype(np.int32), "cache_len": np.int32(seq - 1)}
    fm = get_reduced_spec("fm")
    batch["train_batch"], _ = dryrun.recsys_batch(fm.model_cfg, fm.shapes["train_batch"].kwargs["batch"])
    kw = get_reduced_spec("gat-cora").shapes["full_graph_sm"].kwargs
    batch["full_graph_sm"] = dryrun.gnn_batch(get_reduced_spec("gat-cora").cfg_for("full_graph_sm"), kw["n_nodes"],
                                              kw["n_edges"])
    coll = run_world(4, "_torch_world_cases:collectives_case",
                     {"mesh": (2, 2), "cells": CELLS, "params": lm_params, "batch": batch},
                     tmp_path_factory.mktemp("collectives"))
    return ref, port, coll


@pytest.mark.parametrize("cf", CAPACITY)
def test_moe_local_on_2x2_equals_the_reference_forced_mesh(moe_and_collectives, cf):
    ref, port, _ = moe_and_collectives
    for res in port:
        np.testing.assert_allclose(res[cf]["y"], ref[f"y{cf}"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res[cf]["aux"], float(ref[f"aux{cf}"]), rtol=1e-5)


def test_moe_local_drops_are_the_meshs(moe_and_collectives):
    """At a capacity factor of 0.5 a column's capacity (from its rank's
    tokens) drops pairs; a token whose every pair is dropped gets zeros, and
    at 8.0 nothing drops."""
    ref, port, _ = moe_and_collectives
    for res in port:
        assert not res[8.0]["dropped"].any()
        dropped = res[0.5]["dropped"]
        assert dropped.any()
        all_dropped = dropped.all(axis=-1)
        assert np.all(res[0.5]["y"][all_dropped] == 0)
        assert not np.allclose(res[0.5]["y"], res[8.0]["y"])


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_counted_collectives_of_the_reduced_cells_against_the_reference(moe_and_collectives, i, capsys):
    """The port's collective bytes a rank of the 2x2 mesh, over the
    reference's ``analyze_hlo`` of the same cell compiled for a forced 2x2
    host mesh: the same order of magnitude (GSPMD chooses its own
    collectives; the ratio is printed), but for the windowed decode
    (``RATIO``); for the recsys and GNN cells both counts present and
    finite, the ratio recorded (``RATIO`` None)."""
    ref, _, coll = moe_and_collectives
    arch, shape = CELLS[i]
    got = sum(coll[0][(arch, shape)].values())
    want = float(ref[f"coll{i}"])
    assert all(r[(arch, shape)] == coll[0][(arch, shape)] for r in coll)
    assert got > 0 and want > 0 and np.isfinite(got) and np.isfinite(want)
    ratio = got / want
    with capsys.disabled():
        print(f"\n{arch} {shape} on 2x2: port {coll[0][(arch, shape)]} B, reference {want:.0f} B, ratio {ratio:.4f}")
    bounds = RATIO.get(shape, (0.1, 10))
    if bounds is not None:
        assert bounds[0] < ratio < bounds[1]


# long_500k[swa]'s window is a dynamic slice of the position-split cache:
# GSPMD all-gathers the cache's halves to take it (O(S) bytes a layer),
# where the port merges each rank's softmax statistics in place (O(B H Dh)):
# 0.054 of the reference's bytes on this mesh.  The recsys and GNN cells
# are gated on their counts alone: GSPMD gathers the reduced gat-cora's
# edge list and runs the graph whole on every device (3,072 B), where the
# port sums each rank's partial messages over the edge axes; fm's table
# lookups and gradients move through other collectives than the port's.
# Every other cell within 10x.
RATIO = {"long_500k[swa]": (0.01, 0.1), "train_batch": None, "full_graph_sm": None}
