"""tinyllama-1.1b [dense] 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 — llama2-arch small.  [arXiv:2401.02385; hf]"""

from __future__ import annotations

from ..models.transformer import TransformerConfig
from .common import ArchSpec
from .lm_common import lm_shapes, reduced_lm_shapes

CONFIG = TransformerConfig(
    name="tinyllama-1.1b",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    microbatches=2,
)

REDUCED = TransformerConfig(
    name="tinyllama-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab=256,
    q_chunk=32,
    kv_chunk=32,
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="tinyllama-1.1b",
        family="lm",
        source="arXiv:2401.02385; hf",
        shapes=lm_shapes(),
        model_cfg=CONFIG,
    )


def reduced_spec() -> ArchSpec:
    s = spec()
    return ArchSpec(
        arch_id=s.arch_id, family=s.family, source=s.source,
        shapes=reduced_lm_shapes(), model_cfg=REDUCED,
    )
