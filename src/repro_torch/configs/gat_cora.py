"""gat-cora [gnn] n_layers=2 d_hidden=8 n_heads=8 aggregator=attn.
[arXiv:1710.10903; paper]

The four assigned shape cells are different graphs, so the GATConfig varies
per cell (feature width / class count follow the dataset):

  full_graph_sm — Cora          (2708 N, 10556 E, 1433 f, 7 cls, full-batch)
  minibatch_lg  — Reddit        (232965 N, 114.6M E; sampled 1024 @ 15-10)
  ogb_products  — ogbn-products (2.44M N, 61.86M E, 100 f, 47 cls, full-batch)
  molecule      — batched small graphs (30 N, 64 E, batch 128, graph-level)
"""

from __future__ import annotations

import dataclasses

from ..models.gnn import GATConfig
from .common import ArchSpec, ShapeCell

BASE = GATConfig(name="gat-cora", n_layers=2, d_hidden=8, n_heads=8)

SHAPES = {
    "full_graph_sm": ShapeCell(
        name="full_graph_sm", step="train", kind="full-batch",
        kwargs={
            "n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_classes": 7,
            "task": "node", "shard_nodes": False, "self_loops": True,
        },
    ),
    "minibatch_lg": ShapeCell(
        name="minibatch_lg", step="train", kind="sampled-training",
        kwargs={
            # padded sampled-subgraph budget: 1024 seeds, fanout 15 then 10
            # (1024 * (1 + 15 + 150) = 169,984 nodes / edges upper bound)
            "n_nodes": 169984, "n_edges": 169984,
            "batch_nodes": 1024, "fanout": (15, 10),
            "graph_nodes": 232965, "graph_edges": 114615892,
            "d_feat": 602, "n_classes": 41,
            "task": "node", "shard_nodes": False, "self_loops": True,
        },
    ),
    "ogb_products": ShapeCell(
        name="ogb_products", step="train", kind="full-batch-large",
        kwargs={
            "n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
            "n_classes": 47, "task": "node", "shard_nodes": True,
            "self_loops": False,
        },
    ),
    "molecule": ShapeCell(
        name="molecule", step="train", kind="batched-small-graphs",
        kwargs={
            "n_nodes": 30 * 128, "n_edges": 64 * 128, "batch_graphs": 128,
            "d_feat": 16, "n_classes": 2, "task": "graph",
            "shard_nodes": False, "self_loops": False,
        },
    ),
}


def _cfg_for(cell: ShapeCell) -> GATConfig:
    return dataclasses.replace(
        BASE,
        d_feat=cell.kwargs["d_feat"],
        n_classes=cell.kwargs["n_classes"],
        task=cell.kwargs["task"],
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="gat-cora",
        family="gnn",
        source="arXiv:1710.10903; paper",
        shapes=SHAPES,
        model_cfg_fn=_cfg_for,
    )


def reduced_spec() -> ArchSpec:
    shapes = {
        "full_graph_sm": ShapeCell(
            name="full_graph_sm", step="train", kind="full-batch",
            kwargs={
                "n_nodes": 64, "n_edges": 256, "d_feat": 24, "n_classes": 5,
                "task": "node", "shard_nodes": False, "self_loops": True,
            },
        ),
        "molecule": ShapeCell(
            name="molecule", step="train", kind="batched-small-graphs",
            kwargs={
                "n_nodes": 8 * 4, "n_edges": 16 * 4, "batch_graphs": 4,
                "d_feat": 8, "n_classes": 2, "task": "graph",
                "shard_nodes": False, "self_loops": False,
            },
        ),
    }
    return ArchSpec(
        arch_id="gat-cora", family="gnn", source="arXiv:1710.10903; paper",
        shapes=shapes, model_cfg_fn=_cfg_for,
    )
