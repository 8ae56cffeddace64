"""Deterministic, checkpointable data pipelines.

Every pipeline's full state is a small pytree (counter + rng key), stored in
the training checkpoint, so restarts replay the exact batch sequence — the
property the fault-tolerance tests assert.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["PipelineState", "LMTokenPipeline", "RecsysBatchPipeline"]


@dataclasses.dataclass
class PipelineState:
    step: int = 0
    seed: int = 0

    def as_tree(self) -> dict:
        return {"step": np.int64(self.step), "seed": np.int64(self.seed)}

    @classmethod
    def from_tree(cls, tree: dict) -> "PipelineState":
        return cls(step=int(tree["step"]), seed=int(tree["seed"]))


class LMTokenPipeline:
    """Synthetic-corpus next-token batches (Zipf tokens, document packing)."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0, zipf_a: float = 1.1):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.state = PipelineState(seed=seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = ranks ** -zipf_a
        self._p = p / p.sum()

    def next_batch(self) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.state.seed, self.state.step))
        toks = rng.choice(self.vocab, size=(self.batch, self.seq_len + 1), p=self._p)
        self.state.step += 1
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
            "mask": np.ones((self.batch, self.seq_len), np.int32),
        }


class RecsysBatchPipeline:
    """Synthetic CTR batches with Zipf-distributed ids (hot-key skew)."""

    def __init__(self, field_vocab: tuple[int, ...], batch: int, n_dense: int = 0,
                 hist_len: int = 0, seed: int = 0):
        self.field_vocab = field_vocab
        self.batch = batch
        self.n_dense = n_dense
        self.hist_len = hist_len
        self.state = PipelineState(seed=seed)

    def next_batch(self) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.state.seed, self.state.step))
        self.state.step += 1
        if self.hist_len:
            v = self.field_vocab[0]
            hist = rng.zipf(1.2, size=(self.batch, self.hist_len)) % v
            nvalid = rng.integers(1, self.hist_len + 1, self.batch)
            mask = np.arange(self.hist_len)[None, :] < nvalid[:, None]
            hist = np.where(mask, hist, -1)
            return {
                "hist_ids": hist.astype(np.int32),
                "target_id": (rng.zipf(1.2, self.batch) % v).astype(np.int32),
            }
        ids = np.stack(
            [rng.zipf(1.2, self.batch) % v for v in self.field_vocab], axis=1
        ).astype(np.int32)
        out = {
            "sparse_ids": ids,
            "label": rng.integers(0, 2, self.batch).astype(np.float32),
        }
        if self.n_dense:
            out["dense"] = rng.normal(size=(self.batch, self.n_dense)).astype(np.float32)
        return out
