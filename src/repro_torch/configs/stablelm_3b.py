"""stablelm-3b [dense] 32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""

from __future__ import annotations

from ..models.transformer import TransformerConfig
from .common import ArchSpec
from .lm_common import lm_shapes, reduced_lm_shapes

CONFIG = TransformerConfig(
    name="stablelm-3b",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
    microbatches=4,
)

REDUCED = TransformerConfig(
    name="stablelm-3b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    q_chunk=32,
    kv_chunk=32,
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="stablelm-3b",
        family="lm",
        source="hf:stabilityai/stablelm-2-1_6b; unverified",
        shapes=lm_shapes(),
        model_cfg=CONFIG,
    )


def reduced_spec() -> ArchSpec:
    s = spec()
    return ArchSpec(
        arch_id=s.arch_id, family=s.family, source=s.source,
        shapes=reduced_lm_shapes(), model_cfg=REDUCED,
    )
