"""Architecture registry: ``--arch <id>`` resolves here.

The reference registers ten assigned architectures and the paper's own
``paper_search`` system.  The port holds all of them: ``paper_search`` (the
search system's fixed-shape device steps), the five LMs (three dense, two
MoE), ``gat-cora`` (GNN) and the four recsys models.  An unknown id raises
``KeyError``.
"""

from __future__ import annotations

from . import (
    autoint,
    dcn_v2,
    fm,
    gat_cora,
    llama4_maverick,
    mind,
    mistral_large_123b,
    olmoe_1b_7b,
    paper_search,
    stablelm_3b,
    tinyllama_1_1b,
)
from .common import ArchSpec, ShapeCell

_MODULES = {
    "stablelm-3b": stablelm_3b,
    "mistral-large-123b": mistral_large_123b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "llama4-maverick-400b-a17b": llama4_maverick,
    "olmoe-1b-7b": olmoe_1b_7b,
    "gat-cora": gat_cora,
    "autoint": autoint,
    "mind": mind,
    "dcn-v2": dcn_v2,
    "fm": fm,
    "paper_search": paper_search,
}

# the reference's registry order
ARCH_IDS = (
    "stablelm-3b",
    "mistral-large-123b",
    "tinyllama-1.1b",
    "llama4-maverick-400b-a17b",
    "olmoe-1b-7b",
    "gat-cora",
    "autoint",
    "mind",
    "dcn-v2",
    "fm",
    "paper_search",
)
ASSIGNED_ARCH_IDS = tuple(a for a in ARCH_IDS if a != "paper_search")
PORTED_ARCH_IDS = tuple(a for a in ARCH_IDS if a in _MODULES)


def get_spec(arch_id: str) -> ArchSpec:
    return _MODULES[arch_id].spec()


def get_reduced_spec(arch_id: str) -> ArchSpec:
    return _MODULES[arch_id].reduced_spec()


__all__ = [
    "ArchSpec",
    "ShapeCell",
    "ARCH_IDS",
    "ASSIGNED_ARCH_IDS",
    "PORTED_ARCH_IDS",
    "get_spec",
    "get_reduced_spec",
]
