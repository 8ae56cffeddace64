"""``repro_torch.optim.grad_compression`` against the reference's
``shard_map`` on a forced host mesh, and the cost counter's collectives
against ``analyze_hlo``'s on the same mesh.

One gloo world of four CPU processes (``tests/_torch_worlds.py``) runs every
case of the port; one jax subprocess runs the reference's.
"""

import numpy as np
import pytest
import torch

from _torch_worlds import run_reference, run_world

N = 4

_REFERENCE = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.optim.grad_compression import compressed_psum, compressed_grad_allreduce
from repro.launch.hlo_analysis import analyze_hlo
mesh = jax.make_mesh((4,), ("pod",))
rng = np.random.default_rng(0)
g = jnp.asarray(rng.normal(size=(4, 64)), jnp.float32)  # the reference test's case
err = jnp.zeros((4, 64), jnp.float32)
f = jax.jit(jax.shard_map(lambda g, e: compressed_psum(g, e, "pod"), mesh=mesh, in_specs=(P("pod"), P("pod")),
                          out_specs=(P("pod"), P("pod")), check_vma=False))
out, new_err = f(g, err)
# a second round, with the residual carried
out2, err2 = f(g * 0.5, new_err)
# the int32 sums themselves
def qsum(g, e):
    x = g + e
    scale = jnp.maximum(jnp.max(jnp.abs(x)), 1e-12) / 127.0
    q = jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
    return jax.lax.psum(q.astype(jnp.int32), "pod")
sums = jax.jit(jax.shard_map(qsum, mesh=mesh, in_specs=(P("pod"), P("pod")), out_specs=P("pod"),
                             check_vma=False))(g, err)
# the tree-wide form on a mixed-dtype tree, replicated inputs
tree = {"a": jnp.asarray(rng.normal(size=(3, 5)), jnp.float32), "b": jnp.asarray(rng.normal(size=(7,)), jnp.bfloat16)}
etree = {"a": jnp.zeros((3, 5), jnp.float32), "b": jnp.zeros((7,), jnp.float32)}
tout, terr = jax.jit(lambda t, e: compressed_grad_allreduce(t, e, mesh, "pod"))(tree, etree)
# single-collective programs: their collective bytes per device
def hlo_bytes(fn, x, spec_in, spec_out):
    c = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=spec_in, out_specs=spec_out, check_vma=False)).lower(x).compile()
    return analyze_hlo(c.as_text()).collectives
x = jnp.asarray(rng.normal(size=(4, 64)), jnp.float32)
ar = hlo_bytes(lambda v: jax.lax.psum(v, "pod"), x, P("pod"), P("pod"))
ag = hlo_bytes(lambda v: jax.lax.all_gather(v, "pod", axis=0, tiled=True), x, P("pod"), P())
rs = hlo_bytes(lambda v: jax.lax.psum_scatter(v, "pod", scatter_dimension=0, tiled=True), jnp.tile(x, (4, 1)), P("pod"), P("pod"))
np.savez(OUT, g=np.asarray(g), out=np.asarray(out), new_err=np.asarray(new_err), out2=np.asarray(out2),
         err2=np.asarray(err2), sums=np.asarray(sums), ta=np.asarray(tout["a"]),
         tb=np.asarray(tout["b"].astype(jnp.float32)), tea=np.asarray(terr["a"]), teb=np.asarray(terr["b"]),
         tree_a=np.asarray(tree["a"]), tree_b=np.asarray(tree["b"].astype(jnp.float32)),
         coll=np.asarray([ar.get("all-reduce", 0.0), ag.get("all-gather", 0.0), rs.get("reduce-scatter", 0.0)]))
"""


def _port(payload):
    """Every case of the port in one rank of the world of four."""
    from repro_torch.launch.cost_analysis import count_cost
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.optim.grad_compression import _quantize, compressed_grad_allreduce, compressed_psum
    from repro_torch.parallel.collectives import all_gather, all_reduce, reduce_scatter

    mesh = make_device_mesh((N,), ("pod",), backend="gloo", device="cpu")
    r = mesh.rank
    g = torch.from_numpy(payload["g"][r:r + 1])
    err = torch.zeros_like(g)
    out, new_err = compressed_psum(g, err, mesh, "pod")
    out2, err2 = compressed_psum(g * 0.5, new_err, mesh, "pod")
    q, _ = _quantize(g + err)
    sums = all_reduce(q.to(torch.int32), mesh, "pod")
    tree = {"a": torch.from_numpy(payload["tree_a"]), "b": torch.from_numpy(payload["tree_b"]).to(torch.bfloat16)}
    etree = {"a": torch.zeros(3, 5), "b": torch.zeros(7)}
    tout, terr = compressed_grad_allreduce(tree, etree, mesh, "pod")
    x = torch.ones(1, 64)
    coll = [count_cost(all_reduce, x, mesh, "pod")[1].collectives,
            count_cost(all_gather, x, mesh, "pod", 0)[1].collectives,
            count_cost(reduce_scatter, torch.ones(4, 64), mesh, "pod", 0)[1].collectives]
    one = make_device_mesh((1, N), ("data", "model"), backend="gloo", device="cpu")
    trivial = count_cost(all_reduce, x, one, "data")[1].collectives  # a group of one rank
    return {"out": out, "new_err": new_err, "out2": out2, "err2": err2, "sums": sums, "ta": tout["a"],
            "tb": tout["b"], "tea": terr["a"], "teb": terr["b"], "coll": coll, "trivial": trivial}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    ref = run_reference(_REFERENCE, N, tmp_path_factory.mktemp("reference"))
    port = run_world(N, "test_torch_grad_compression:_port", {k: ref[k] for k in ("g", "tree_a", "tree_b")},
                     tmp_path_factory.mktemp("world"))
    return ref, port


@pytest.mark.parametrize("key", ["out", "new_err", "out2", "err2"])
def test_compressed_psum_equals_the_reference_shard_map(worlds, key):
    ref, port = worlds
    for r, res in enumerate(port):
        np.testing.assert_allclose(res[key].numpy(), ref[key][r:r + 1], rtol=0, atol=1e-6)


def test_compressed_psum_int32_sums_are_identical(worlds):
    ref, port = worlds
    for r, res in enumerate(port):
        assert res["sums"].dtype == torch.int32
        np.testing.assert_array_equal(res["sums"].numpy(), ref["sums"][r:r + 1])


def test_compressed_psum_recovers_the_mean_and_keeps_a_residual(worlds):
    """The reference test's own checks (tests/test_runtime.py), on the
    port: one round lands near the mean; the residual is not zero."""
    ref, port = worlds
    mean = ref["g"].mean(axis=0)
    got = port[0]["out"].numpy()[0]
    assert np.abs(got - mean).max() / (np.abs(mean).max() + 1e-9) < 0.3
    assert float(port[0]["new_err"].abs().max()) > 0


@pytest.mark.parametrize("key", ["ta", "tb", "tea", "teb"])
def test_compressed_grad_allreduce_tree_equals_the_reference(worlds, key):
    ref, port = worlds
    for res in port:
        np.testing.assert_allclose(res[key].float().numpy(), ref[key], rtol=0, atol=1e-6 if key != "tb" else 1e-2)


@pytest.mark.parametrize("i,name", [(0, "all-reduce"), (1, "all-gather"), (2, "reduce-scatter")])
def test_counted_collective_bytes_equal_analyze_hlo(worlds, i, name):
    """A program of one collective: the counter charges its result bytes
    under the reference's name, as ``analyze_hlo`` charges the compiled
    collective on the forced host mesh."""
    ref, port = worlds
    for res in port:
        assert res["coll"][i] == {name: float(ref["coll"][i])}


def test_a_group_of_one_rank_charges_nothing(worlds):
    _, port = worlds
    assert all(res["trivial"] == {} for res in port)
