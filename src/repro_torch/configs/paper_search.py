"""paper_search — the paper's own architecture as an 11th config.

Multi-component key proximity search serving (document-sharded) and index
building, with the vectorized Combiner as the device compute.  Shapes are
fixed serving budgets: B queries x P postings x C candidate clusters x
L lemmas x N window positions.
"""

from __future__ import annotations

import dataclasses

from .common import ArchSpec, ShapeCell


@dataclasses.dataclass(frozen=True)
class SearchServeConfig:
    name: str
    max_distance: int = 5
    n_lemmas: int = 8  # max unique lemmas per subquery (queries are 3-5 words)
    window_len: int = 128  # positions per candidate cluster window
    top_k: int = 16
    build_buckets: int = 65536

    def param_count(self) -> int:
        return 0  # index structures, not learned parameters


CONFIG = SearchServeConfig(name="paper_search")

SHAPES = {
    "serve_online": ShapeCell(
        name="serve_online", step="serve", kind="online-search",
        kwargs={"batch": 256, "postings": 8192, "clusters": 256},
    ),
    "serve_bulk": ShapeCell(
        name="serve_bulk", step="serve", kind="bulk-search",
        kwargs={"batch": 4096, "postings": 8192, "clusters": 256},
    ),
    "score_1m": ShapeCell(
        name="score_1m", step="serve", kind="candidate-scoring",
        kwargs={"batch": 8, "postings": 262144, "clusters": 131072},
    ),
    "build_chunk": ShapeCell(
        name="build_chunk", step="build", kind="index-build",
        kwargs={"docs": 4096, "doc_len": 1024},
    ),
}


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="paper_search", family="search",
        source="Veretennikov, IntelliSys 2020 (this paper)",
        shapes=SHAPES, model_cfg=CONFIG,
    )


def reduced_spec() -> ArchSpec:
    shapes = {
        "serve_online": ShapeCell(
            name="serve_online", step="serve", kind="online-search",
            kwargs={"batch": 4, "postings": 128, "clusters": 8},
        ),
        "build_chunk": ShapeCell(
            name="build_chunk", step="build", kind="index-build",
            kwargs={"docs": 4, "doc_len": 128},
        ),
    }
    return ArchSpec(
        arch_id="paper_search", family="search",
        source="Veretennikov, IntelliSys 2020 (this paper)",
        shapes=shapes,
        model_cfg=dataclasses.replace(CONFIG, build_buckets=1024),
    )
