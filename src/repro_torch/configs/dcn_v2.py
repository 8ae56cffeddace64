"""dcn-v2 [recsys] n_dense=13 n_sparse=26 embed_dim=16 n_cross_layers=3
mlp=1024-1024-512 interaction=cross.  [arXiv:2008.13535; paper]

Full-vocabulary Criteo scale: ~33.76M embedding rows across 26 fields —
the table IS the memory footprint; rows shard across the ``model`` axis.
"""

from __future__ import annotations

import dataclasses

from ..models.recsys import RecsysConfig
from .common import ArchSpec, zipf_vocab_split
from .recsys_common import recsys_shapes, reduced_recsys_shapes

CONFIG = RecsysConfig(
    name="dcn-v2",
    model="dcn_v2",
    n_dense=13,
    n_sparse=26,
    embed_dim=16,
    field_vocab=zipf_vocab_split(33_762_577, 26),
    n_cross_layers=3,
    mlp_dims=(1024, 1024, 512),
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="dcn-v2-smoke",
    field_vocab=zipf_vocab_split(2_000, 26),
    mlp_dims=(64, 64, 32),
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="dcn-v2", family="recsys", source="arXiv:2008.13535; paper",
        shapes=recsys_shapes(), model_cfg=CONFIG,
    )


def reduced_spec() -> ArchSpec:
    return ArchSpec(
        arch_id="dcn-v2", family="recsys", source="arXiv:2008.13535; paper",
        shapes=reduced_recsys_shapes(), model_cfg=REDUCED,
    )
