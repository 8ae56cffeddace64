"""GNN graph utilities: CSR storage and a real fanout neighbor sampler
(GraphSAGE-style), producing padded static-shape subgraphs.

A copy of the reference's numpy-only ``repro/data/sampler.py``: the same
seed gives the same arrays, key for key and bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CSRGraph", "NeighborSampler", "random_graph"]


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # [N+1]
    indices: np.ndarray  # [E]
    features: np.ndarray  # [N, F]
    labels: np.ndarray  # [N]

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u] : self.indptr[u + 1]]


def random_graph(n_nodes: int, avg_degree: int, d_feat: int, n_classes: int, seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    deg = rng.poisson(avg_degree, n_nodes).clip(1)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n_nodes, int(indptr[-1])).astype(np.int32)
    return CSRGraph(
        indptr=indptr,
        indices=indices,
        features=rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
        labels=rng.integers(0, n_classes, n_nodes).astype(np.int32),
    )


class NeighborSampler:
    """Uniform fanout sampling with relabeling and static padding.

    Output arrays have fixed shapes derived from (batch, fanout) budgets, so
    a train step sees one shape: nodes beyond the sampled count
    are padding (mask 0), edges likewise.
    """

    def __init__(self, graph: CSRGraph, batch_nodes: int, fanout: tuple[int, ...], seed: int = 0):
        self.g = graph
        self.batch_nodes = batch_nodes
        self.fanout = fanout
        self.rng = np.random.default_rng(seed)
        # static budgets
        n = batch_nodes
        self.max_nodes = batch_nodes
        self.max_edges = 0
        for f in fanout:
            self.max_edges += n * f
            n = n * f
            self.max_nodes += n

    def sample(self, seeds: np.ndarray | None = None) -> dict[str, np.ndarray]:
        g = self.g
        if seeds is None:
            seeds = self.rng.choice(g.n_nodes, self.batch_nodes, replace=False)
        node_of: dict[int, int] = {int(u): i for i, u in enumerate(seeds)}
        nodes: list[int] = [int(u) for u in seeds]
        src: list[int] = []
        dst: list[int] = []
        frontier = list(seeds)
        for f in self.fanout:
            nxt: list[int] = []
            for u in frontier:
                nb = g.neighbors(int(u))
                if len(nb) == 0:
                    continue
                pick = self.rng.choice(nb, min(f, len(nb)), replace=False)
                for v in pick:
                    v = int(v)
                    if v not in node_of:
                        node_of[v] = len(nodes)
                        nodes.append(v)
                        nxt.append(v)
                    # message flows neighbor -> center
                    src.append(node_of[v])
                    dst.append(node_of[int(u)])
            frontier = nxt

        n_real, e_real = len(nodes), len(src)
        nn, ee = self.max_nodes, self.max_edges
        node_ids = np.zeros(nn, np.int64)
        node_ids[:n_real] = nodes
        x = np.zeros((nn, g.features.shape[1]), np.float32)
        x[:n_real] = g.features[nodes]
        labels = np.zeros(nn, np.int32)
        labels[:n_real] = g.labels[nodes]
        label_mask = np.zeros(nn, np.int32)
        label_mask[: len(seeds)] = 1  # loss on seed nodes only
        src_a = np.zeros(ee, np.int32)
        dst_a = np.zeros(ee, np.int32)
        emask = np.zeros(ee, np.int32)
        src_a[:e_real] = src
        dst_a[:e_real] = dst
        emask[:e_real] = 1
        return {
            "x": x, "src": src_a, "dst": dst_a, "edge_mask": emask,
            "labels": labels, "label_mask": label_mask,
            "n_real_nodes": np.int32(n_real), "n_real_edges": np.int32(e_real),
        }
