"""fm [recsys] n_sparse=39 embed_dim=10 interaction=fm-2way — pairwise
<v_i, v_j> x_i x_j via the O(nk) sum-square trick.  [ICDM'10 (Rendle); paper]"""

from __future__ import annotations

import dataclasses

from ..models.recsys import RecsysConfig
from .common import ArchSpec, zipf_vocab_split
from .recsys_common import recsys_shapes, reduced_recsys_shapes

CONFIG = RecsysConfig(
    name="fm",
    model="fm",
    n_sparse=39,
    embed_dim=10,
    field_vocab=zipf_vocab_split(998_960, 39),
)

REDUCED = dataclasses.replace(
    CONFIG, name="fm-smoke", field_vocab=zipf_vocab_split(2_000, 39)
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="fm", family="recsys", source="ICDM'10 (Rendle); paper",
        shapes=recsys_shapes(), model_cfg=CONFIG,
    )


def reduced_spec() -> ArchSpec:
    return ArchSpec(
        arch_id="fm", family="recsys", source="ICDM'10 (Rendle); paper",
        shapes=reduced_recsys_shapes(), model_cfg=REDUCED,
    )
