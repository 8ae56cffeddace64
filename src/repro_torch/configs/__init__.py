"""Architecture registry: ``--arch <id>`` resolves here.

The reference registers ten assigned architectures and the paper's own
``paper_search`` system.  The port holds ``paper_search`` (the search
system's fixed-shape device steps) and the three dense LMs
(``stablelm-3b``, ``mistral-large-123b``, ``tinyllama-1.1b``).  The other
ids are known, and asking for their specs raises ``NotImplementedError``
naming what they need and the port lacks: MoE layers, the recsys models or
the GNN models.  An unknown id raises ``KeyError``.
"""

from __future__ import annotations

from . import mistral_large_123b, paper_search, stablelm_3b, tinyllama_1_1b
from .common import ArchSpec, ShapeCell

_MODULES = {
    "stablelm-3b": stablelm_3b,
    "mistral-large-123b": mistral_large_123b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "paper_search": paper_search,
}

# the reference's ids the port does not hold, and what each needs
_NOT_PORTED = {
    "llama4-maverick-400b-a17b": "MoE layers",
    "olmoe-1b-7b": "MoE layers",
    "gat-cora": "GNN models",
    "autoint": "recsys models",
    "mind": "recsys models",
    "dcn-v2": "recsys models",
    "fm": "recsys models",
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


def _module(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(f"{arch_id!r} needs {_NOT_PORTED[arch_id]}: not ported to repro_torch")
    return _MODULES[arch_id]


def get_spec(arch_id: str) -> ArchSpec:
    return _module(arch_id).spec()


def get_reduced_spec(arch_id: str) -> ArchSpec:
    return _module(arch_id).reduced_spec()


__all__ = [
    "ArchSpec",
    "ShapeCell",
    "ARCH_IDS",
    "ASSIGNED_ARCH_IDS",
    "PORTED_ARCH_IDS",
    "get_spec",
    "get_reduced_spec",
]
