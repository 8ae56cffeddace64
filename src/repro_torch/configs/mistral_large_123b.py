"""mistral-large-123b [dense] 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""

from __future__ import annotations

from ..models.transformer import TransformerConfig
from .common import ArchSpec
from .lm_common import lm_shapes, reduced_lm_shapes

CONFIG = TransformerConfig(
    name="mistral-large-123b",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    rope_theta=1_000_000.0,
    microbatches=16,
    fsdp=True,
)

REDUCED = TransformerConfig(
    name="mistral-large-smoke",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=192,
    vocab=256,
    q_chunk=32,
    kv_chunk=32,
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="mistral-large-123b",
        family="lm",
        source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
        shapes=lm_shapes(),
        model_cfg=CONFIG,
    )


def reduced_spec() -> ArchSpec:
    s = spec()
    return ArchSpec(
        arch_id=s.arch_id, family=s.family, source=s.source,
        shapes=reduced_lm_shapes(), model_cfg=REDUCED,
    )
