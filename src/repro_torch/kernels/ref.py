"""Plain PyTorch oracles for the kernels of this package.

The kernels' tests compare against these; they are the torch counterparts
of the reference package's jnp oracles and run on any device.
"""

from __future__ import annotations

import torch

from ..core.window import window_cover_batch

__all__ = ["proximity_window_ref", "intersect_ref", "embedding_bag_ref", "fragment_scores_ref"]


def proximity_window_ref(
    occ: torch.Tensor, mult: torch.Tensor, max_distance: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched minimal-fragment cover; see ``core/window.py``."""
    return window_cover_batch(occ, mult, window=2 * max_distance + 1)


def intersect_ref(
    a: torch.Tensor, b: torch.Tensor, pad_value: int = 2**31 - 1
) -> torch.Tensor:
    """Membership of each element of sorted ``a`` in sorted ``b`` (1/0)."""
    idx = torch.searchsorted(b, a).clamp(0, b.shape[0] - 1)
    return ((b[idx] == a) & (a != pad_value)).to(torch.int32)


def embedding_bag_ref(
    table: torch.Tensor,  # [V, D]
    indices: torch.Tensor,  # [B, K] (pad = -1)
    weights: torch.Tensor | None = None,  # [B, K]
) -> torch.Tensor:
    """Sum-mode embedding bag with padding; the RecSys gather-reduce op."""
    ok = (indices >= 0).to(table.dtype)[..., None]
    gathered = table[torch.clamp(indices, min=0)] * ok
    if weights is not None:
        gathered = gathered * weights[..., None].to(table.dtype)
    return gathered.sum(dim=1)


def fragment_scores_ref(emit: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """§14 proximity relevance: sum of 1/(span+1)^2 over emitted fragments."""
    n = emit.shape[-1]
    span = torch.arange(n, dtype=torch.float32, device=emit.device) - start.float()
    contrib = torch.where(emit, 1.0 / (span + 1.0) ** 2, 0.0)
    return contrib.sum(dim=-1)
