"""Config-registry plumbing shared by every architecture."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

__all__ = ["ShapeCell", "ArchSpec", "zipf_vocab_split"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (architecture x input-shape) cell."""

    name: str
    step: str  # "train" | "prefill" | "decode" | "score" | "retrieval" | "serve" | "build"
    kind: str  # reporting label from the assignment ("training", ...)
    kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    skip_reason: str | None = None  # e.g. long_500k on pure full-attention
    variant: str | None = None  # e.g. "swa" bonus rows


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # "lm" | "gnn" | "recsys" | "search"
    source: str  # provenance note from the assignment
    shapes: dict[str, ShapeCell]
    # model config; GNN archs vary per-cell (different graphs), hence a fn
    model_cfg: Any = None
    model_cfg_fn: Callable[[ShapeCell], Any] | None = None

    def cfg_for(self, shape_name: str) -> Any:
        cell = self.shapes[shape_name]
        if self.model_cfg_fn is not None:
            return self.model_cfg_fn(cell)
        return self.model_cfg

    def cells(self, include_skipped: bool = False) -> list[ShapeCell]:
        return [
            c for c in self.shapes.values() if include_skipped or c.skip_reason is None
        ]


def zipf_vocab_split(total: int, n_fields: int, alpha: float = 1.1, min_rows: int = 4) -> tuple[int, ...]:
    """Deterministic Zipf-ish split of a total vocabulary across fields —
    mimics real CTR datasets (a few huge ID fields, many small ones)."""
    weights = [(i + 1) ** -alpha for i in range(n_fields)]
    s = sum(weights)
    sizes = [max(min_rows, int(total * w / s)) for w in weights]
    # fix rounding drift on the largest field
    sizes[0] += total - sum(sizes)
    return tuple(sizes)
