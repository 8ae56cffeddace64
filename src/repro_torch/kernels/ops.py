"""Public entry points over the kernels of this package."""

from __future__ import annotations

import torch

from .proximity import COMPUTE_DTYPES, proximity_window
from .ref import fragment_scores_ref, proximity_window_ref

__all__ = ["proximity_search_scores"]


def proximity_search_scores(
    occ: torch.Tensor,  # [B, L, N] occupancy per candidate window
    mult: torch.Tensor,  # [B, L]
    max_distance: int,
    use_kernel: bool = False,
    compute_dtype: str = "int32",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused cover + §14 relevance: returns (emit, start, scores[B]).

    ``compute_dtype`` narrows the occupancy/prefix-count rows (kernel and
    plain version agree — §Perf-3); int32 reproduces the historical
    behaviour exactly.
    """
    if use_kernel:
        emit, start = proximity_window(occ, mult, max_distance, compute_dtype=compute_dtype)
    else:
        emit, start = proximity_window_ref(
            occ.to(COMPUTE_DTYPES[compute_dtype]), mult, max_distance
        )
    return emit, start, fragment_scores_ref(emit, start)
