"""Shared RecSys shape set (the assignment's batch grid)."""

from __future__ import annotations

from .common import ShapeCell


def recsys_shapes() -> dict[str, ShapeCell]:
    return {
        "train_batch": ShapeCell(
            name="train_batch", step="train", kind="training",
            kwargs={"batch": 65536},
        ),
        "serve_p99": ShapeCell(
            name="serve_p99", step="score", kind="online-inference",
            kwargs={"batch": 512},
        ),
        "serve_bulk": ShapeCell(
            name="serve_bulk", step="score", kind="offline-scoring",
            kwargs={"batch": 262144},
        ),
        "retrieval_cand": ShapeCell(
            name="retrieval_cand", step="retrieval", kind="retrieval-scoring",
            kwargs={"batch": 1, "n_candidates": 1_000_000},
        ),
    }


def reduced_recsys_shapes() -> dict[str, ShapeCell]:
    return {
        "train_batch": ShapeCell(
            name="train_batch", step="train", kind="training",
            kwargs={"batch": 64},
        ),
        "serve_p99": ShapeCell(
            name="serve_p99", step="score", kind="online-inference",
            kwargs={"batch": 16},
        ),
        "retrieval_cand": ShapeCell(
            name="retrieval_cand", step="retrieval", kind="retrieval-scoring",
            kwargs={"batch": 1, "n_candidates": 512},
        ),
    }
