"""Context-parallel decode: the LM decode cells under a ``model`` axis of two
ranks, each holding its half of the KV cache's positions (the reference's
``P(None, data, "model", None, None)``), in gloo worlds of two (1x2) and
four (2x2) CPU ranks.

Held against the reference's unsharded ``decode_step`` on the same weights
(``ref_params``, carried across) and the same cache, token and
``cache_len``: the logits (gathered over the data ranks) and the whole new
cache (``gather_tree`` of the ranks' slices).  The ``cache_len`` values
walk the split: 0, mid-slice, the last row of rank 0's slice, the first of
rank 1's and S - 1; ``long_500k[swa]`` (a window of 64 over 512 positions)
adds windows that straddle the two slices.  The reduced tinyllama (kv heads
split over ``model``), olmoe with its ``local`` dispatch (``_moe_local``
over ``model``) and llama4-maverick (dense and MoE sublayers interleaved).
Each cell's ``in_specs`` equal the reference's built on a forced host mesh
of the same shape.  Tolerances (``tests/_lm_compare.py``): float32 rtol
1e-4 / atol 1e-5, bfloat16 2e-2 relative; every cache row but the written
one is the input's, bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _lm_compare import ref_cfg, ref_params
from _torch_worlds import reference_in_specs, run_world, spec_key
from repro.models import transformer as ref_tf

S = {"decode_32k": 256, "long_500k[swa]": 512}
ROWS = {"decode_32k": 4, "long_500k[swa]": 1}
WINDOW = {"decode_32k": None, "long_500k[swa]": 64}
LENS = {"decode_32k": [0, 64, 127, 128, 255], "long_500k[swa]": [0, 100, 255, 256, 290, 511]}
LOCAL = {"moe": {"dispatch": "local"}}
# (arch, config changes, dtype, cell, cache_len values) a mesh runs
CASES = {
    (1, 2): [("tinyllama-1.1b", {}, "float32", "decode_32k", LENS["decode_32k"]),
             ("tinyllama-1.1b", {}, "float32", "long_500k[swa]", LENS["long_500k[swa]"]),
             ("tinyllama-1.1b", {}, "bfloat16", "decode_32k", [127, 128]),
             ("tinyllama-1.1b", {}, "bfloat16", "long_500k[swa]", [290]),
             ("olmoe-1b-7b", LOCAL, "float32", "decode_32k", [0, 127, 128, 255]),
             ("llama4-maverick-400b-a17b", {}, "float32", "decode_32k", [64, 127, 128, 255]),
             ("llama4-maverick-400b-a17b", {}, "float32", "long_500k[swa]", [256, 290])],
    (2, 2): [("tinyllama-1.1b", {}, "float32", "decode_32k", LENS["decode_32k"]),
             ("tinyllama-1.1b", {}, "float32", "long_500k[swa]", [0, 255, 256, 290, 511]),
             ("tinyllama-1.1b", {}, "bfloat16", "decode_32k", [128]),
             ("olmoe-1b-7b", LOCAL, "float32", "decode_32k", [127, 128]),
             ("llama4-maverick-400b-a17b", {}, "float32", "decode_32k", [127, 128])],
}
# (arch, dtype, cell, S, cache_len values) of 1x2 whose cache positions S
# do not divide the model axis: the cache is whole on every rank (as the
# reference's spec is replicated there) and each rank attends with its own
# heads, as train and prefill do
WHOLE = {(1, 2): [("tinyllama-1.1b", "float32", "decode_32k", 255, [0, 127, 128, 254, 300]),
                  ("tinyllama-1.1b", "float32", "long_500k[swa]", 511, [255, 290, 510])]}
WORLD_TIMEOUT = 120  # seconds a world may take: 8-12 s alone, at a lower priority under the suite's load about 3x that


def _key(arch, changes, dtype, cell, n, mesh):
    return f"{arch}{'-local' if changes else ''} {dtype} {cell} {n} {mesh[0]}x{mesh[1]}"


def _ref_cfg(arch, changes, dtype, cell):
    """The reference's reduced config of ``arch`` with ``changes`` (a
    ``moe`` entry merged into its ``MoEConfig``) and the cell's window."""
    import dataclasses

    kw = {**changes, "sliding_window": WINDOW.get(cell)}
    if "moe" in changes:
        kw["moe"] = dataclasses.replace(ref_cfg(arch, dtype).moe, **changes["moe"])
    return ref_cfg(arch, dtype, **kw)


def _whole_key(arch, dtype, cell, seq, n, mesh):
    return f"{arch} {dtype} {cell} S={seq} {n} {mesh[0]}x{mesh[1]}"


def _inputs(rcfg, cell, n, seq=None):
    seq = seq or S[cell]
    rng = np.random.default_rng(seq + n)
    shape = (rcfg.n_layers, ROWS[cell], seq, rcfg.n_kv_heads, rcfg.d_head)
    # float32 values of the config's dtype: the ranks cast them exactly
    cache = {k: np.asarray(jnp.asarray(rng.standard_normal(shape), rcfg.jdtype), np.float32) for k in ("k", "v")}
    tokens = rng.integers(0, rcfg.vocab, (ROWS[cell], 1)).astype(np.int32)
    return {**cache, "tokens": tokens, "cache_len": np.int32(n)}


def reference_and_world(world: int, mesh, tmp_path):
    """The reference's unsharded decode of every case of ``mesh``; the
    ranks' runs of them; the reference's in_specs on a forced host mesh."""
    cases, ref, params, inputs = {}, {}, {}, {}
    runs = [(arch, changes, dtype, cell, [(_key(arch, changes, dtype, cell, n, mesh), n) for n in lens], None)
            for arch, changes, dtype, cell, lens in CASES[mesh]]
    runs += [(arch, {}, dtype, cell, [(_whole_key(arch, dtype, cell, seq, n, mesh), n) for n in lens], seq)
             for arch, dtype, cell, seq, lens in WHOLE.get(mesh, [])]
    for arch, changes, dtype, cell, keys, seq in runs:
        rcfg = _ref_cfg(arch, changes, dtype, cell)
        pname = f"{arch} {dtype}"
        rp = ref_params(rcfg, seed=5)
        params[pname] = jax.tree.map(lambda x: np.asarray(x, np.float32), rp)
        step = jax.jit(lambda p, c, t, n, rcfg=rcfg: ref_tf.decode_step(p, c, t, n, rcfg))
        for key, n in keys:
            inputs[key] = _inputs(rcfg, cell, n, seq)
            cache = {k: jnp.asarray(inputs[key][k], rcfg.jdtype) for k in ("k", "v")}
            logits, new = step(rp, cache, inputs[key]["tokens"], jnp.int32(n))
            ref[key] = {"logits": np.asarray(logits, np.float32),
                        "cache": {k: np.asarray(new[k], np.float32) for k in ("k", "v")}}
            cases[key] = {"arch": arch, "changes": changes, "dtype": dtype, "mesh": mesh, "shape": cell,
                          "inputs": key, "params": pname, **({"seq_len": seq} if seq else {})}
    ranks = run_world(world, "_torch_world_cases:serve_case", {"cases": cases, "params": params, "inputs": inputs},
                      tmp_path / "world", timeout=WORLD_TIMEOUT)
    specs = reference_in_specs([(mesh, arch, cell, {}) for arch, cell in {(c[0], c[3]) for c in CASES[mesh]}], 4,
                               tmp_path / "reference")
    return ref, inputs, ranks, specs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {mesh: reference_and_world(mesh[0] * mesh[1], mesh, tmp_path_factory.mktemp(f"w{mesh[0]}x{mesh[1]}"))
            for mesh in CASES}


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


PARAMS = [(mesh, arch, changes, dtype, cell, n) for mesh, cases in CASES.items()
          for arch, changes, dtype, cell, lens in cases for n in lens]


@pytest.mark.parametrize("mesh,arch,changes,dtype,cell,n", PARAMS,
                         ids=[_key(a, c, d, cl, n, m) for m, a, c, d, cl, n in PARAMS])
def test_context_parallel_decode_equals_the_unsharded_reference(worlds, mesh, arch, changes, dtype, cell, n):
    ref, inputs, ranks, _ = worlds[mesh]
    key = _key(arch, changes, dtype, cell, n, mesh)
    want, inp = ref[key], inputs[key]
    row = min(n, S[cell] - 1)
    for res in ranks:
        got = res[key]
        assert got["local_cache_rows"] == S[cell] // mesh[1]  # the positions split over `model`
        if dtype == "float32":
            np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-4, atol=1e-5)
        else:
            assert _rel(got["logits"], want["logits"]) < 2e-2
        for k in ("k", "v"):
            keep = np.ones(S[cell], bool)
            keep[row] = False
            assert np.array_equal(got["cache"][k][:, :, keep], inp[k][:, :, keep])
            if dtype == "float32":
                np.testing.assert_allclose(got["cache"][k][:, :, row], want["cache"][k][:, :, row],
                                           rtol=1e-4, atol=1e-5)
            else:
                assert _rel(got["cache"][k][:, :, row], want["cache"][k][:, :, row]) < 2e-2
        # the merge's collectives: a max, two sums and the gathers of q/K/V
        assert got["collectives"].get("all-reduce", 0) > 0


SPEC_PARAMS = sorted({(mesh, arch, cell) for mesh, cases in CASES.items() for arch, _, _, cell, _ in cases})


@pytest.mark.parametrize("mesh,arch,cell", SPEC_PARAMS, ids=[f"{m[0]}x{m[1]} {a} {c}" for m, a, c in SPEC_PARAMS])
def test_decode_in_specs_equal_the_reference_forced_mesh(worlds, mesh, arch, cell):
    _, _, ranks, specs = worlds[mesh]
    want = specs[spec_key(mesh, arch, cell, {})]
    key = next(k for k in ranks[0] if k.split()[0].startswith(arch) and f" {cell} " in k)
    for res in ranks:
        got = json.loads(json.dumps(res[key]["in_specs"]))
        assert got == want
    cache = want[1]["k"]
    assert cache[2] == "model"  # the positions split over `model`, as the reference's


WHOLE_PARAMS = [(mesh, arch, dtype, cell, seq, n) for mesh, cases in WHOLE.items()
                for arch, dtype, cell, seq, lens in cases for n in lens]


@pytest.mark.parametrize("mesh,arch,dtype,cell,seq,n", WHOLE_PARAMS,
                         ids=[_whole_key(a, d, c, s, n, m) for m, a, d, c, s, n in WHOLE_PARAMS])
def test_decode_with_the_cache_whole_under_split_heads_equals_the_unsharded_reference(worlds, mesh, arch, dtype,
                                                                                      cell, seq, n):
    """A cache whose positions do not divide the model axis stays whole on
    every rank; each rank attends with its own heads over it and sums its
    share of ``wo`` over ``model``.  The logits and the new cache against
    the reference's unsharded step (float32 rtol 1e-4 / atol 1e-5), every
    other row the input's, bit for bit."""
    ref, inputs, ranks, _ = worlds[mesh]
    key = _whole_key(arch, dtype, cell, seq, n, mesh)
    want, inp = ref[key], inputs[key]
    row = min(n, seq - 1)
    keep = np.ones(seq, bool)
    keep[row] = False
    for res in ranks:
        got = res[key]
        assert got["local_cache_rows"] == seq and got["in_specs"][1]["k"][2] is None  # whole on every rank
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-4, atol=1e-5)
        for k in ("k", "v"):
            assert np.array_equal(got["cache"][k][:, :, keep], inp[k][:, :, keep])
            np.testing.assert_allclose(got["cache"][k][:, :, row], want["cache"][k][:, :, row], rtol=1e-4, atol=1e-5)
        assert got["collectives"].get("all-reduce", 0) > 0  # the row-split wo and w_down sums
