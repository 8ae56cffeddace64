"""llama4-maverick-400b-a17b [moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128e top-1 — MoE, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Notes (DESIGN.md §Arch-applicability):
* Llama-4 interleaves dense and MoE FFNs (every other layer); we model that
  with ``moe_interleave=2`` (24 dense + 24 MoE layers), landing ~400B total /
  ~20B active with the assigned per-expert d_ff=8192.
* "early fusion" refers to the VLM frontend — per the assignment the modality
  frontend is a STUB: ``input_specs()`` feeds token/patch-embedding ids.
"""

from __future__ import annotations

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .common import ArchSpec
from .lm_common import lm_shapes, reduced_lm_shapes

CONFIG = TransformerConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,  # dense (non-MoE) layers
    vocab=202048,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff=8192, n_shared_experts=0,
                  dispatch="local"),
    moe_interleave=2,
    microbatches=16,
    fsdp=True,
)

REDUCED = TransformerConfig(
    name="llama4-maverick-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    moe=MoEConfig(n_experts=8, top_k=1, d_ff=128),
    moe_interleave=2,
    q_chunk=32,
    kv_chunk=32,
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="llama4-maverick-400b-a17b",
        family="lm",
        source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
        shapes=lm_shapes(),
        model_cfg=CONFIG,
    )


def reduced_spec() -> ArchSpec:
    s = spec()
    return ArchSpec(
        arch_id=s.arch_id, family=s.family, source=s.source,
        shapes=reduced_lm_shapes(), model_cfg=REDUCED,
    )
