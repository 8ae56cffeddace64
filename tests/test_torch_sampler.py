"""The port's copy of the GNN graph utilities (``repro_torch.data.sampler``)
against the reference's ``repro/data/sampler.py``: ``random_graph`` and
``NeighborSampler`` give identical arrays, key for key and dtype for dtype,
from the same seeds (numpy only, no tolerance); the sampler's static
budgets and the reference test's invariants; a sampled subgraph through the
port's GAT on the CPU."""

import numpy as np
import pytest
import torch

from repro.data import sampler as ref_sampler
from repro_torch.configs import get_reduced_spec
from repro_torch.data import sampler
from repro_torch.models import gnn


def _same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), k


@pytest.mark.parametrize("n,deg,f,c,seed", [(500, 6, 8, 5, 1), (64, 4, 24, 5, 0), (3, 1, 2, 2, 9)])
def test_random_graph_equals_the_reference(n, deg, f, c, seed):
    got, want = sampler.random_graph(n, deg, f, c, seed=seed), ref_sampler.random_graph(n, deg, f, c, seed=seed)
    for name in ("indptr", "indices", "features", "labels"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert (got.n_nodes, got.n_edges) == (want.n_nodes, want.n_edges)
    assert all(np.array_equal(got.neighbors(u), want.neighbors(u)) for u in range(min(n, 20)))


@pytest.mark.parametrize("batch_nodes,fanout,seed", [(16, (4, 3), 2), (8, (15, 10), 0), (5, (2,), 7),
                                                     (32, (3, 3, 2), 11)])
def test_neighbor_sampler_equals_the_reference(batch_nodes, fanout, seed):
    """Several rounds from the sampler's own draws, then explicit seeds."""
    g, rg = (m.random_graph(500, avg_degree=6, d_feat=8, n_classes=5, seed=1) for m in (sampler, ref_sampler))
    s = sampler.NeighborSampler(g, batch_nodes=batch_nodes, fanout=fanout, seed=seed)
    rs = ref_sampler.NeighborSampler(rg, batch_nodes=batch_nodes, fanout=fanout, seed=seed)
    assert (s.max_nodes, s.max_edges) == (rs.max_nodes, rs.max_edges)
    for _ in range(3):
        _same(s.sample(), rs.sample())
    seeds = np.arange(batch_nodes) * 3
    _same(s.sample(seeds), rs.sample(seeds))


def test_sampler_skips_nodes_without_neighbors():
    """A CSR graph whose seeds have empty neighbour lists (which
    ``random_graph`` never makes): the same relabelling and padding."""
    indptr = np.array([0, 0, 2, 2, 5, 5], np.int64)
    indices = np.array([3, 4, 0, 1, 2], np.int32)
    feats = np.arange(10, dtype=np.float32).reshape(5, 2)
    labels = np.arange(5, dtype=np.int32)
    got = sampler.NeighborSampler(sampler.CSRGraph(indptr, indices, feats, labels), 3, (2, 2), seed=4)
    want = ref_sampler.NeighborSampler(ref_sampler.CSRGraph(indptr, indices, feats, labels), 3, (2, 2), seed=4)
    for seeds in (np.array([0, 2, 4]), np.array([1, 3, 0])):
        _same(got.sample(seeds), want.sample(seeds))


def test_sampled_subgraph_invariants_and_a_gat_forward():
    """The reference test's invariants, and a padded sampled subgraph
    through the port's GAT: finite logits of the padded shape."""
    g = sampler.random_graph(500, avg_degree=6, d_feat=24, n_classes=5, seed=1)
    s = sampler.NeighborSampler(g, batch_nodes=16, fanout=(4, 3), seed=2)
    out = s.sample()
    n_real, e_real = int(out["n_real_nodes"]), int(out["n_real_edges"])
    assert out["x"].shape == (s.max_nodes, 24) and out["src"].shape == (s.max_edges,)
    assert 16 <= n_real <= s.max_nodes and out["label_mask"].sum() == 16
    assert (out["src"][:e_real] < n_real).all() and (out["dst"][:e_real] < n_real).all()
    assert out["edge_mask"][:e_real].all() and not out["edge_mask"][e_real:].any()
    cfg = get_reduced_spec("gat-cora").cfg_for("full_graph_sm")
    params = gnn.init_gat_params(0, cfg, device="cpu")
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}
    logits = gnn.gat_forward(params, batch, cfg, edge_chunk=17)
    assert logits.shape == (s.max_nodes, cfg.n_classes) and bool(torch.isfinite(logits).all())
