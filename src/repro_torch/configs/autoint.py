"""autoint [recsys] n_sparse=39 embed_dim=16 n_attn_layers=3 n_heads=2
d_attn=32 interaction=self-attn.  [arXiv:1810.11921; paper]

AutoInt's Criteo setup discretizes the 13 numeric fields, giving 39 sparse
fields over ~1M feature values total.
"""

from __future__ import annotations

import dataclasses

from ..models.recsys import RecsysConfig
from .common import ArchSpec, zipf_vocab_split
from .recsys_common import recsys_shapes, reduced_recsys_shapes

CONFIG = RecsysConfig(
    name="autoint",
    model="autoint",
    n_sparse=39,
    embed_dim=16,
    field_vocab=zipf_vocab_split(998_960, 39),
    n_attn_layers=3,
    n_attn_heads=2,
    d_attn=32,
)

REDUCED = dataclasses.replace(
    CONFIG, name="autoint-smoke", field_vocab=zipf_vocab_split(2_000, 39)
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="autoint", family="recsys", source="arXiv:1810.11921; paper",
        shapes=recsys_shapes(), model_cfg=CONFIG,
    )


def reduced_spec() -> ArchSpec:
    return ArchSpec(
        arch_id="autoint", family="recsys", source="arXiv:1810.11921; paper",
        shapes=reduced_recsys_shapes(), model_cfg=REDUCED,
    )
