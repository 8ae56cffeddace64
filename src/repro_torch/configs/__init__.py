"""Architecture registry: ``--arch <id>`` resolves here.

The reference registers ten assigned architectures and the paper's own
``paper_search`` system.  The port holds ``paper_search``, whose cells are
the search system's fixed-shape device steps; the other ten ids are known,
and asking for their specs raises ``NotImplementedError``: they are seed
scaffolding off the search path.  An unknown id raises ``KeyError``.
"""

from __future__ import annotations

from . import paper_search
from .common import ArchSpec, ShapeCell

_MODULES = {"paper_search": paper_search}

# the reference's assigned architectures, in its registry's order
_SCAFFOLDING = (
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
)

ARCH_IDS = _SCAFFOLDING + ("paper_search",)
ASSIGNED_ARCH_IDS = _SCAFFOLDING
PORTED_ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id in _SCAFFOLDING:
        raise NotImplementedError(
            f"{arch_id!r} is seed scaffolding off the search path: not ported to repro_torch"
        )
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
