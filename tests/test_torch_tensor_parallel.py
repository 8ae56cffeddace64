"""Data, tensor and fully-sharded data parallelism of the LM train step, in
a gloo world of two CPU ranks, against the reference's unsharded run.

Meshes ``1x2`` (tensor parallelism: Megatron column and row splits, the
vocab-parallel loss), ``2x1`` (data parallelism: the global masked mean,
gradients all-reduced over ``data``) and ``2x1`` with ``fsdp`` (each layer
gathered at use, gradients reduce-scattered).  The reduced dense and MoE
configs in float32, weights carried across by ``models/convert.py`` and cut
per rank by ``shard_tree``, on batches whose masks differ between the data
ranks.  Tolerances (``tests/_lm_compare.py``): loss and metrics rtol 1e-4 /
atol 1e-5, gradients (gathered) rtol 1e-3 / atol 1e-6, params after three
AdamW steps atol 1e-5.  ``global_norm`` is tested alone: a wrong norm moves
every step through the clip.

The four-card smoke's scaled-share spec (``chip_smoke.world_lm_spec``: one
production data rank's share a rank, the cell's global batch scaled by the
world's data size) in a gloo world of four under ``4x1`` and ``2x2``: each
rank's rows of the batch ``run_cell`` draws are the rows the reference's
cell puts on the same device of a forced host mesh of that shape, given the
same global batch.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from _lm_compare import FWD, GRAD, lm_batch, ref_cfg, ref_params
from _torch_worlds import run_reference, run_world
from repro.configs import get_reduced_spec as ref_get_reduced_spec
from repro.launch.steps import build_cell as ref_build_cell
from repro.models import transformer as ref_tf
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import global_norm as ref_global_norm

ARCHS = ["tinyllama-1.1b", "olmoe-1b-7b"]
MESHES = [((1, 2), False), ((2, 1), False), ((2, 1), True)]
B, S = 4, 32
SHARE_MESHES = [(4, 1), (2, 2)]
SHARE_ROWS = 2  # a data rank's rows

# the reference's train cell on a forced host mesh of each shape, given the
# global batch a world drew: each device's rows of its tokens
_PER_DEVICE = r"""
import dataclasses, json
import numpy as np, jax
from jax.sharding import NamedSharding
from repro.configs import get_reduced_spec
from repro.launch.steps import build_cell
z = dict(np.load(INPUTS))
res = {}
for shape in json.loads(%r):
    key = "x".join(map(str, shape))
    tokens = z[key]
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), devices=jax.devices()[:4])
    spec = get_reduced_spec("tinyllama-1.1b")
    c = spec.shapes["train_4k"]
    c = dataclasses.replace(c, kwargs={**c.kwargs, "global_batch": tokens.shape[0]})
    cell = build_cell(dataclasses.replace(spec, shapes={**spec.shapes, "train_4k": c}), "train_4k", mesh)
    put = jax.device_put(tokens, NamedSharding(mesh, cell.in_specs[2]["tokens"]))
    order = list(mesh.devices.flat)
    for sh in put.addressable_shards:
        res[f"{key}/{order.index(sh.device)}"] = np.asarray(sh.data)
np.savez(OUT, **res)
"""


def reference_runs(cases: dict, batches: list) -> dict:
    """The reference's unsharded run of each (arch, changes): loss, metrics
    and gradients on the first batch; metrics of three train steps and the
    params after them."""
    out = {}
    from repro.models.moe import MoEConfig

    for name, (arch, changes) in cases.items():
        changes = {k: MoEConfig(**v) if k == "moe" else v for k, v in changes.items()}
        rcfg = ref_cfg(arch, "float32", **changes)
        params = ref_params(rcfg)
        (loss, metrics), grads = jax.value_and_grad(ref_tf.loss_fn, has_aux=True)(params, batches[0], rcfg)
        spec = dataclasses.replace(ref_get_reduced_spec(arch), model_cfg=rcfg)
        mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
        with mesh:
            step = jax.jit(ref_build_cell(spec, "train_4k", mesh).fn)
            p, opt, steps = params, ref_adamw_init(params), []
            for b in batches:
                p, opt, m = step(p, opt, b)
                steps.append({k: float(v) for k, v in m.items()})
        out[name] = {"params0": jax.tree.map(np.asarray, params), "loss": float(loss),
                     "metrics": {k: float(v) for k, v in metrics.items()},
                     "grads": jax.tree.map(np.asarray, grads), "steps": steps,
                     "params": jax.tree.map(lambda x: np.asarray(x, np.float32), p)}
    return out


def run_cases(world: int, meshes, variants: dict, tmp_path):
    """Every (variant, mesh) case of ``world`` ranks against the reference;
    ``variants`` maps a name to (arch, config changes)."""
    batches = [lm_batch(256, B, S, seed=s) for s in range(3)]
    ref = reference_runs(variants, batches)
    cases, params_of = {}, {}
    for name, (arch, changes) in variants.items():
        for shape, fsdp in meshes:
            key = f"{name} {shape[0]}x{shape[1]}{' fsdp' if fsdp else ''}"
            cases[key] = (arch, shape, fsdp, changes)
            params_of[key] = name
    payload = {"cases": cases, "params_of": params_of, "batches": batches,
               "params": {name: r["params0"] for name, r in ref.items()}}
    ranks = run_world(world, "_torch_world_cases:lm_case", payload, tmp_path, timeout=900)
    return ref, cases, params_of, ranks


def check(ref, params_of, ranks, key):
    want = ref[params_of[key]]
    for res in ranks:
        got = res[key]
        np.testing.assert_allclose(got["loss"], want["loss"], **FWD)
        for k in ("nll", "aux"):
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], **FWD)
        for g, w in zip(jax.tree.leaves(got["grads"]), jax.tree.leaves(want["grads"])):
            np.testing.assert_allclose(g, w, **GRAD)
        assert got["opt_step"] == 3
        for sg, sw in zip(got["steps"], want["steps"]):
            assert sorted(sg) == sorted(sw)
            for k in ("loss", "nll", "aux"):
                np.testing.assert_allclose(sg[k], sw[k], **FWD)
            np.testing.assert_allclose(sg["grad_norm"], sw["grad_norm"], **GRAD)
        for g, w in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(want["params"])):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    variants = {arch: (arch, {}) for arch in ARCHS}
    lm = run_cases(2, MESHES, variants, tmp_path_factory.mktemp("lm"))
    norm = run_world(2, "_torch_world_cases:global_norm_case", {"meshes": [(1, 2), (2, 1)]},
                     tmp_path_factory.mktemp("norm"))
    return lm, norm


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The trainer's command line in a world of two (1x2) and in one
    process, each writing a checkpoint after its second step."""
    from repro_torch.launch import train

    ckpt = tmp_path_factory.mktemp("ckpt")
    argv = ["--arch", "tinyllama-1.1b", "--steps", "2", "--device", "cpu", "--ckpt-every", "2"]
    ranks = run_world(2, "_torch_world_cases:train_cli_case",
                      {"argv": argv + ["--mesh", "1x2", "--backend", "gloo", "--ckpt-dir", str(ckpt / "world")]},
                      tmp_path_factory.mktemp("cli"))
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv + ["--ckpt-dir", str(ckpt / "one")])
    return ckpt, ranks, buf.getvalue()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", [f"{s[0]}x{s[1]}{' fsdp' if f else ''}" for s, f in MESHES])
def test_sharded_train_step_equals_the_unsharded_reference(world, arch, mesh):
    (ref, cases, params_of, ranks), _ = world
    check(ref, params_of, ranks, f"{arch} {mesh}")


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_global_norm_of_shards_counts_each_leaf_once(world, shape):
    _, norm = world
    for res in norm:
        np.testing.assert_allclose(res[shape]["sharded"], res["whole"], rtol=1e-6)
        assert abs(res[shape]["naive"] - res["whole"]) > 1e-3  # the copies a replicated leaf has
    # the whole tree's norm is the reference's
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(4, 6)).astype(np.float32), "b": rng.normal(size=(8,)).astype(np.float32),
            "c": rng.normal(size=(2, 4, 2)).astype(np.float32), "d": rng.normal(size=(3,)).astype(np.float32)}
    np.testing.assert_allclose(norm[0]["whole"], float(ref_global_norm(tree)), rtol=1e-6)


def test_trainer_cli_in_a_world_prints_on_rank_zero_and_checkpoints_the_whole_state(cli):
    """Rank 0 prints the one-process run's lines (the bfloat16 reduced
    config: values within 2e-2), rank 1 nothing; the checkpoint a world
    writes has the one-process checkpoint's leaves, shapes and dtypes."""
    ckpt, ranks, one = cli
    assert ranks[1]["stdout"] == ""
    got = [ln.split() for ln in ranks[0]["stdout"].splitlines()]
    want = [ln.split() for ln in one.splitlines()]
    assert [g[:2] for g in got] == [w[:2] for w in want] == [["step", "0"], ["step", "1"], ["done:", "2"]]
    for g, w in zip(got[:2], want[:2]):
        for gv, wv in zip(g[2:], w[2:]):
            assert gv.split("=")[0] == wv.split("=")[0]
            assert abs(float(gv.split("=")[1]) - float(wv.split("=")[1])) <= 2e-2 * max(1.0, abs(float(wv.split("=")[1])))
    import json

    a = json.loads((ckpt / "world" / "step_2" / "manifest.json").read_text())
    b = json.loads((ckpt / "one" / "step_2" / "manifest.json").read_text())
    for k in ("n_leaves", "treedef", "leaf_shapes", "leaf_dtypes"):
        assert a[k] == b[k], k


@pytest.fixture(scope="module")
def share(tmp_path_factory):
    ranks = run_world(4, "_torch_world_cases:share_case", {"meshes": SHARE_MESHES, "rows": SHARE_ROWS},
                      tmp_path_factory.mktemp("share"), timeout=600)
    drawn = {"x".join(map(str, m)): ranks[0][m]["global_tokens"] for m in SHARE_MESHES}
    ref = run_reference(_PER_DEVICE % (json.dumps([list(m) for m in SHARE_MESHES]),), 4,
                        tmp_path_factory.mktemp("reference"), inputs=drawn)
    return ranks, ref


@pytest.mark.parametrize("mesh", SHARE_MESHES)
def test_scaled_share_gives_each_rank_the_reference_devices_rows(share, mesh):
    """Each rank runs one data rank's share (``SHARE_ROWS`` rows), its rows
    of the world's batch are the reference's rows on the same device, every
    rank drew the same batch, and the step's metrics are the unsharded
    step's on that batch."""
    ranks, ref = share
    key = "x".join(map(str, mesh))
    want_rows = SHARE_ROWS * mesh[0]
    for r, res in enumerate(ranks):
        got = res[mesh]
        assert got["global_tokens"].shape[0] == want_rows
        np.testing.assert_array_equal(got["global_tokens"], ranks[0][mesh]["global_tokens"])
        assert got["tokens"].shape[0] == SHARE_ROWS
        np.testing.assert_array_equal(got["tokens"], ref[f"{key}/{r}"])
        for k, w in got["metrics_unsharded"].items():
            np.testing.assert_allclose(got["metrics"][k], w, **(GRAD if k == "grad_norm" else FWD))
