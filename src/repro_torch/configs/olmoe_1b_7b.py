"""olmoe-1b-7b [moe] 16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304,
MoE 64e top-8.  [arXiv:2409.02060; hf]"""

from __future__ import annotations

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .common import ArchSpec
from .lm_common import lm_shapes, reduced_lm_shapes

CONFIG = TransformerConfig(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    # dispatch="local": replicated-activation EP (EXPERIMENTS.md §Perf-1);
    # baselines "einsum"/"sort" remain selectable for comparison
    moe=MoEConfig(n_experts=64, top_k=8, d_ff=1024, dispatch="local"),
    microbatches=4,
)

REDUCED = TransformerConfig(
    name="olmoe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=64),
    q_chunk=32,
    kv_chunk=32,
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="olmoe-1b-7b",
        family="lm",
        source="arXiv:2409.02060; hf",
        shapes=lm_shapes(),
        model_cfg=CONFIG,
    )


def reduced_spec() -> ArchSpec:
    s = spec()
    return ArchSpec(
        arch_id=s.arch_id, family=s.family, source=s.source,
        shapes=reduced_lm_shapes(), model_cfg=REDUCED,
    )
