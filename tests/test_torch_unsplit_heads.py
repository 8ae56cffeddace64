"""Layouts whose q heads, FFN or vocabulary do not split over ``model``:
train, prefill and decode in gloo worlds of three (1x3) and four (1x4) CPU
ranks, against the reference's unsharded runs.

The reference replicates a dim the model axis does not divide
(``sanitize_specs``) and GSPMD runs whatever layout results.  On 1x3 the
reduced llama4-maverick splits nothing over ``model`` (64 ``wq`` columns,
a 128-wide FFN, a 256-entry vocabulary, 8 experts, 256 cache positions):
every rank runs the whole model.  On 1x4 a cut config (6 q heads, 2 kv
heads, d_head 16) splits ``wq`` into 24 columns, a head and a half a rank:
the q columns are gathered, every rank attends with every head and feeds
its own columns to its rows of ``wo``; its cache's 256 positions split 64
a rank.  Each cell's ``in_specs`` equal the reference's on a forced host
mesh.  Tolerances (``tests/_lm_compare.py``): float32 forward rtol 1e-4 /
atol 1e-5, gradients rtol 1e-3 / atol 1e-6, params after three AdamW steps
atol 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _lm_compare import lm_batch, ref_params
from _torch_worlds import reference_in_specs, run_world, spec_key
from repro.models import transformer as ref_tf
from repro_torch.configs import get_reduced_spec
from repro_torch.launch.mesh import MeshLayout
from repro_torch.launch.steps import build_cell
from repro_torch.parallel.sharding import map_with_path
from test_torch_context_parallel import S, _inputs, _ref_cfg
from test_torch_tensor_parallel import B, check, reference_runs
from test_torch_tensor_parallel import S as TRAIN_S

CUT = {"n_heads": 6, "n_kv_heads": 2, "d_model": 96}  # d_head 16: 24 wq columns on 4 ranks
WORLDS = {
    (1, 3): ("llama4-maverick-400b-a17b", {}, {"decode_32k": [0, 128, 255], "long_500k[swa]": [290]}),
    (1, 4): ("tinyllama-1.1b", CUT, {"decode_32k": [0, 63, 64, 255], "long_500k[swa]": [255, 290]}),
}
PREFILL_ROWS, PREFILL_S = 2, 64
WORLD_TIMEOUT = 120  # seconds a world may take: 8-12 s alone, at a lower priority under the suite's load about 3x that


def _name(mesh) -> str:
    arch, changes, _ = WORLDS[mesh]
    return f"{arch}{'-cut' if changes else ''}"


def reference_and_world(mesh, tmp_path):
    arch, changes, lens = WORLDS[mesh]
    name = _name(mesh)
    world = mesh[0] * mesh[1]
    batches = [lm_batch(256, B, TRAIN_S, seed=s) for s in range(3)]
    train_ref = reference_runs({name: (arch, changes)}, batches)
    train = {"cases": {f"{name} {mesh[0]}x{mesh[1]}": (arch, mesh, False, changes)},
             "params_of": {f"{name} {mesh[0]}x{mesh[1]}": name}, "batches": batches,
             "params": {name: train_ref[name]["params0"]}}
    serve_ref, inputs, cases = {}, {}, {}
    rcfg = _ref_cfg(arch, changes, "float32", "prefill_32k")
    rp = ref_params(rcfg, seed=5)
    params = {name: jax.tree.map(lambda x: np.asarray(x, np.float32), rp)}
    tokens = np.random.default_rng(1).integers(0, rcfg.vocab, (PREFILL_ROWS, PREFILL_S)).astype(np.int32)
    logits, cache = jax.jit(lambda p, t: ref_tf.prefill_step(p, t, rcfg))(rp, tokens)
    serve_ref["prefill"] = {"logits": np.asarray(logits), "cache": {k: np.asarray(cache[k]) for k in ("k", "v")}}
    inputs["prefill"] = {"tokens": tokens}
    cases["prefill"] = {"arch": arch, "changes": changes, "dtype": "float32", "mesh": mesh, "shape": "prefill_32k",
                        "inputs": "prefill", "params": name}
    for cell, ns in lens.items():
        rcfg = _ref_cfg(arch, changes, "float32", cell)
        step = jax.jit(lambda p, c, t, n, rcfg=rcfg: ref_tf.decode_step(p, c, t, n, rcfg))
        for n in ns:
            key = f"{cell} {n}"
            inputs[key] = _inputs(rcfg, cell, n)
            logits, new = step(rp, {k: jnp.asarray(inputs[key][k]) for k in ("k", "v")}, inputs[key]["tokens"],
                               jnp.int32(n))
            serve_ref[key] = {"logits": np.asarray(logits), "cache": {k: np.asarray(new[k]) for k in ("k", "v")}}
            cases[key] = {"arch": arch, "changes": changes, "dtype": "float32", "mesh": mesh, "shape": cell,
                          "inputs": key, "params": name}
    ranks = run_world(world, "_torch_world_cases:train_and_serve_case",
                      {"train": train, "serve": {"cases": cases, "params": params, "inputs": inputs}},
                      tmp_path / "world", timeout=WORLD_TIMEOUT)
    cells = ["train_4k", "prefill_32k", *lens]
    specs = reference_in_specs([(mesh, arch, c, changes) for c in cells], world, tmp_path / "reference")
    return train_ref, serve_ref, ranks, specs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {mesh: reference_and_world(mesh, tmp_path_factory.mktemp(f"w{mesh[0]}x{mesh[1]}")) for mesh in WORLDS}


@pytest.mark.parametrize("mesh", list(WORLDS), ids=[f"{m[0]}x{m[1]}" for m in WORLDS])
def test_train_step_equals_the_unsharded_reference(worlds, mesh):
    train_ref, _, ranks, _ = worlds[mesh]
    key = f"{_name(mesh)} {mesh[0]}x{mesh[1]}"
    check(train_ref, {key: _name(mesh)}, [r["train"] for r in ranks], key)


SERVE = [(mesh, "prefill") for mesh in WORLDS] + [(mesh, f"{cell} {n}") for mesh in WORLDS
                                                  for cell, ns in WORLDS[mesh][2].items() for n in ns]


@pytest.mark.parametrize("mesh,key", SERVE, ids=[f"{m[0]}x{m[1]} {k}" for m, k in SERVE])
def test_prefill_and_decode_equal_the_unsharded_reference(worlds, mesh, key):
    _, serve_ref, ranks, _ = worlds[mesh]
    want = serve_ref[key]
    for res in ranks:
        got = res["serve"][key]
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-4, atol=1e-5)
        for k in ("k", "v"):
            np.testing.assert_allclose(got["cache"][k], want["cache"][k], rtol=1e-4, atol=1e-5)
        if key != "prefill":
            cell = key.split()[0]
            # the positions split over `model` where the axis divides them
            split = S[cell] % mesh[1] == 0
            assert got["local_cache_rows"] == (S[cell] // mesh[1] if split else S[cell])


def _port_specs(tree) -> dict:
    out = {}
    map_with_path(lambda path, s: out.__setitem__(path, list(s)), tree)
    return out


CELLS = [(mesh, cell) for mesh in WORLDS for cell in ["train_4k", "prefill_32k", *WORLDS[mesh][2]]]


@pytest.mark.parametrize("mesh,cell", CELLS, ids=[f"{m[0]}x{m[1]} {c}" for m, c in CELLS])
def test_in_specs_equal_the_reference_forced_mesh(worlds, mesh, cell):
    """The world's cells carry the reference's in_specs; so does the cell
    built over the layout alone (no world)."""
    import dataclasses

    _, _, ranks, specs = worlds[mesh]
    arch, changes, _ = WORLDS[mesh]
    want = specs[spec_key(mesh, arch, cell, changes)]
    spec = get_reduced_spec(arch)
    spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(spec.model_cfg, **changes))
    built = build_cell(spec, cell, MeshLayout(mesh, ("data", "model")))
    assert [_port_specs(t) for t in built.in_specs] == want
    if cell != "train_4k":
        key = "prefill" if cell == "prefill_32k" else next(k for k in ranks[0]["serve"] if k.startswith(cell + " "))
        for res in ranks:
            assert json.loads(json.dumps(res["serve"][key]["in_specs"])) == want
