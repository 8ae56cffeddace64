"""Shared LM shape set (the assignment's seq_len x global_batch grid).

``long_500k`` is skipped for the pure full-attention assigned archs (noted in
DESIGN.md §6); a sliding-window-attention bonus variant ``long_500k[swa]``
exercises the sub-quadratic long-context path anyway.
"""

from __future__ import annotations

from .common import ArchSpec, ShapeCell

FULL_ATTN_SKIP = (
    "pure full-attention arch: 524k-token decode requires sub-quadratic "
    "attention (DESIGN.md §6); see the long_500k[swa] bonus variant"
)


def lm_shapes(swa_window: int = 4096) -> dict[str, ShapeCell]:
    return {
        "train_4k": ShapeCell(
            name="train_4k", step="train", kind="training",
            kwargs={"seq_len": 4096, "global_batch": 256},
        ),
        "prefill_32k": ShapeCell(
            name="prefill_32k", step="prefill", kind="inference-prefill",
            kwargs={"seq_len": 32768, "global_batch": 32},
        ),
        "decode_32k": ShapeCell(
            name="decode_32k", step="decode", kind="inference-decode",
            kwargs={"seq_len": 32768, "global_batch": 128},
        ),
        "long_500k": ShapeCell(
            name="long_500k", step="decode", kind="long-context-decode",
            kwargs={"seq_len": 524288, "global_batch": 1},
            skip_reason=FULL_ATTN_SKIP,
        ),
        "long_500k[swa]": ShapeCell(
            name="long_500k[swa]", step="decode", kind="long-context-decode",
            kwargs={
                "seq_len": 524288,
                "global_batch": 1,
                "sliding_window": swa_window,
            },
            variant="swa",
        ),
    }


def reduced_lm_shapes() -> dict[str, ShapeCell]:
    """CPU-runnable smoke shapes (same step kinds, tiny extents)."""
    return {
        "train_4k": ShapeCell(
            name="train_4k", step="train", kind="training",
            kwargs={"seq_len": 128, "global_batch": 4},
        ),
        "prefill_32k": ShapeCell(
            name="prefill_32k", step="prefill", kind="inference-prefill",
            kwargs={"seq_len": 256, "global_batch": 2},
        ),
        "decode_32k": ShapeCell(
            name="decode_32k", step="decode", kind="inference-decode",
            kwargs={"seq_len": 256, "global_batch": 4},
        ),
        "long_500k[swa]": ShapeCell(
            name="long_500k[swa]", step="decode", kind="long-context-decode",
            kwargs={"seq_len": 512, "global_batch": 1, "sliding_window": 64},
            variant="swa",
        ),
    }
