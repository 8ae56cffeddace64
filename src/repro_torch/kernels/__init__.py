"""Hand-written CUDA kernels (``csrc/``) and their plain PyTorch versions.

Nothing here builds or loads a kernel at import time; see ``_build.py``.
"""

from .gather import ARENA_BLOCK, gather_blocks, gather_blocks_plain
from .intersect import (
    PAD,
    SegmentPack,
    block_offsets,
    intersect_sorted,
    intersect_sorted_plain,
    intersect_sorted_segments,
    pack_segments,
)
from .ops import proximity_search_scores
from .proximity import proximity_window, proximity_window_plain
from .ref import fragment_scores_ref, intersect_ref, proximity_window_ref

__all__ = [
    "ARENA_BLOCK",
    "PAD",
    "SegmentPack",
    "block_offsets",
    "fragment_scores_ref",
    "gather_blocks",
    "gather_blocks_plain",
    "intersect_ref",
    "intersect_sorted",
    "intersect_sorted_plain",
    "intersect_sorted_segments",
    "pack_segments",
    "proximity_search_scores",
    "proximity_window",
    "proximity_window_plain",
    "proximity_window_ref",
]
