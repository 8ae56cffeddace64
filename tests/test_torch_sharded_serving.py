"""Document-sharded serving in worlds of ranks: ``serve_step_sharded``
under a mesh of 2 and 4 gloo ranks against the reference's ``shard_map``
on a forced host mesh of as many devices, and ``device_topk_merge`` with a
mesh.

Each rank passes its block of NS/W cluster shards (the reference's
``in_specs``); the per-shard top-k lists are all-gathered in shard order.
Integer outputs are identical to the reference's; ``top_scores`` within
rtol 1e-5 and ``top_docs`` identical outside runs of equal scores
(``assert_topk_agree``); every rank's result is identical, and equal bit
for bit to the port's one-program fold over all NS shards.

The reference's ``shard_map`` runs one shard a device (its ``local`` reads
``post[0]`` of the device's block, so with more shards than devices it
serves only the first of each block): it is the reference where NS equals
the world's size.  With more shards than ranks, the reference is its
all-shard fold (``serve_step_sharded`` with no mesh, its ``vmap``).
"""

import numpy as np
import pytest
import torch

from _torch_worlds import run_reference, run_world
from test_torch_serving_step import B, C, D, N, P, _inputs, assert_topk_agree

# (world, NS, top_k): NS cluster shards over W ranks
CASES = [(2, 2, 16), (2, 2, 3), (2, 8, 3), (4, 4, 16), (4, 4, 3), (4, 8, 16)]
MESH = {2: (1, 2), 4: (2, 2)}


def _case_inputs(ns: int, seed: int):
    c_loc, p_loc = max(1, -(-max(C, ns) // ns)), max(1, -(-P // ns))
    rng = np.random.default_rng(seed)
    parts = [_inputs(rng, B, p_loc, c_loc) for _ in range(ns)]
    return (np.stack([p[0] for p in parts]), np.stack([p[1] for p in parts]), parts[0][2], c_loc)


def _all_inputs() -> dict:
    out = {}
    for i, (w, ns, k) in enumerate(CASES):
        post, cd, mult, c_loc = _case_inputs(ns, 100 + i)
        out.update({f"post{i}": post, f"cd{i}": cd, f"mult{i}": mult, f"c_loc{i}": np.int64(c_loc)})
    rng = np.random.default_rng(7)
    out["merge_scores"] = rng.integers(0, 5, (8, 6)).astype(np.float32)  # ties across shards
    out["merge_docs"] = np.arange(48, dtype=np.int32).reshape(8, 6)
    return out


_REFERENCE = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.search.serving_step import serve_step_sharded
from repro.search.distributed import device_topk_merge
CASES = %r
MESH = %r
z = dict(np.load(INPUTS))
res = {}
for i, (w, ns, k) in enumerate(CASES):
    devs = np.array(jax.devices()[:w]).reshape(MESH[w])
    mesh = jax.sharding.Mesh(devs, ("data", "model"))
    kw = dict(max_distance=%d, n_clusters=int(z[f"c_loc{i}"]), window_len=%d, top_k=k)
    args = (jnp.asarray(z[f"post{i}"]), jnp.asarray(z[f"cd{i}"]), jnp.asarray(z[f"mult{i}"]))
    if ns == w:  # one shard a device: the shard_map path
        with jax.set_mesh(mesh):
            out = serve_step_sharded(*args, **kw)
    else:
        out = serve_step_sharded(*args, **kw)
    for name, v in out.items():
        res[f"{name}{i}"] = np.asarray(v)
s, d = device_topk_merge(jnp.asarray(z["merge_scores"]), jnp.asarray(z["merge_docs"]), 10)
res["merge_top_scores"], res["merge_top_docs"] = np.asarray(s), np.asarray(d)
np.savez(OUT, **res)
""" % (CASES, MESH, D, N)


def _port(payload):
    """Every case of one world size in one rank: the rank's outputs, and
    the port's fold over all the shards (no mesh)."""
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.search.distributed import device_topk_merge
    from repro_torch.search.serving_step import serve_step_sharded

    w = payload["world"]
    mesh = make_device_mesh(MESH[w], ("data", "model"), backend="gloo", device="cpu")
    r = mesh.rank
    res = {}
    for i, (cw, ns, k) in enumerate(CASES):
        if cw != w:
            continue
        post, cd, mult = (torch.from_numpy(payload[f"{x}{i}"]) for x in ("post", "cd", "mult"))
        kw = dict(max_distance=D, n_clusters=int(payload[f"c_loc{i}"]), window_len=N, top_k=k)
        blk = ns // w
        res[i] = {"world": serve_step_sharded(post[r * blk:(r + 1) * blk], cd[r * blk:(r + 1) * blk], mult, mesh=mesh,
                                              **kw),
                  "fold": serve_step_sharded(post, cd, mult, **kw)}
    scores, docs = torch.from_numpy(payload["merge_scores"]), torch.from_numpy(payload["merge_docs"])
    rows = scores.shape[0] // w
    res["merge"] = device_topk_merge(scores[r * rows:(r + 1) * rows], docs[r * rows:(r + 1) * rows], 10, mesh=mesh)
    res["merge_fold"] = device_topk_merge(scores, docs, 10)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = _all_inputs()
    ref = run_reference(_REFERENCE, 4, tmp_path_factory.mktemp("reference"), inputs=inputs)
    port = {w: run_world(w, "test_torch_sharded_serving:_port", {**inputs, "world": w},
                         tmp_path_factory.mktemp(f"world{w}")) for w in (2, 4)}
    return ref, port


@pytest.mark.parametrize("i", range(len(CASES)))
def test_world_serve_step_sharded_equals_the_reference(runs, i):
    """The reference's shard_map where NS equals the world, else its fold."""
    ref, port = runs
    w, ns, k = CASES[i]
    want = {name: ref[f"{name}{i}"] for name in ("top_docs", "top_scores", "n_fragments")}
    assert want["n_fragments"].sum() > 0
    for res in port[w]:
        got = {name: v.numpy() for name, v in res[i]["world"].items()}
        np.testing.assert_array_equal(got["n_fragments"], want["n_fragments"])
        assert_topk_agree(got, want)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_world_serve_step_sharded_equals_the_one_program_fold_on_every_rank(runs, i):
    _, port = runs
    w = CASES[i][0]
    for res in port[w]:
        for name, v in res[i]["world"].items():
            assert torch.equal(v, res[i]["fold"][name]), name


@pytest.mark.parametrize("w", [2, 4])
def test_device_topk_merge_with_a_mesh_equals_the_merge_of_every_row(runs, w):
    ref, port = runs
    for res in port[w]:
        for got, want in zip(res["merge"], res["merge_fold"]):
            assert torch.equal(got, want)
        np.testing.assert_array_equal(res["merge"][0].numpy(), ref["merge_top_scores"])
        np.testing.assert_array_equal(res["merge"][1].numpy(), ref["merge_top_docs"])
