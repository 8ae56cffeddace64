"""mind [recsys] embed_dim=64 n_interests=4 capsule_iters=3
interaction=multi-interest.  [arXiv:1904.08030; unverified]

Multi-Interest Network with Dynamic routing: behavior-sequence capsule
routing into 4 interest vectors; retrieval scores = max over interests.
Item vocabulary sized to the paper's Taobao setting (~3.7M items).
"""

from __future__ import annotations

import dataclasses

from ..models.recsys import RecsysConfig
from .common import ArchSpec
from .recsys_common import recsys_shapes, reduced_recsys_shapes

CONFIG = RecsysConfig(
    name="mind",
    model="mind",
    n_sparse=1,  # the item-id space
    embed_dim=64,
    field_vocab=(3_706_119,),
    n_interests=4,
    capsule_iters=3,
    hist_len=50,
)

REDUCED = dataclasses.replace(
    CONFIG, name="mind-smoke", field_vocab=(4_000,), hist_len=16
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="mind", family="recsys", source="arXiv:1904.08030; unverified",
        shapes=recsys_shapes(), model_cfg=CONFIG,
    )


def reduced_spec() -> ArchSpec:
    return ArchSpec(
        arch_id="mind", family="recsys", source="arXiv:1904.08030; unverified",
        shapes=reduced_recsys_shapes(), model_cfg=REDUCED,
    )
