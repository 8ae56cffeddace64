"""Production layouts, without devices.

The reference builds ``jax.make_mesh`` meshes over 256 or 512 TPU chips and
shards the ``paper_search`` serve cells' cluster axis over every device.  The
port runs on one card, so a layout here is only its shape, axis names and
size: ``launch/steps.py`` reads the size as the number of cluster shards
(NS), and ``serving_step.serve_step_sharded`` folds those shards into the
batch axis of one device program.

Single pod: (data=16, model=16) — 256 shards.
Multi-pod:  (pod=2, data=16, model=16) — 512 shards.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["MeshLayout", "make_production_mesh", "make_smoke_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's shape and axis names; ``size`` is its number of shards."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    if multi_pod:
        return MeshLayout((2, 16, 16), ("pod", "data", "model"))
    return MeshLayout((16, 16), ("data", "model"))


def make_smoke_mesh() -> MeshLayout:
    """One-shard layout with the production axis names (CPU tests)."""
    return MeshLayout((1, 1), ("data", "model"))
