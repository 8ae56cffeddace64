"""Elastic topology: recompute the mesh when pods join or leave.

Checkpoints are layout-free (see ``checkpoint.py``), so resuming on a
different chip count only requires a new mesh + re-derived shardings.  The
policy here picks the largest (pods x data x model) grid that (a) fits the
surviving chips, (b) keeps the model axis unchanged (TP degree is baked into
layer shapes' divisibility), and (c) keeps the global batch divisible.

Scope (DESIGN.md §14): this planner is TRAINING-only — it
remaps the accelerator mesh for offline jobs driven by
``fault_tolerance.run_with_restarts``.  Serving-side failure handling
(shard health, snapshot recovery, degraded fan-out) deliberately does NOT
remap topology; it lives in ``search/resilience.py``, where a crashed
document shard recovers from its §12.2 snapshot in place.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ElasticTopology"]


@dataclasses.dataclass(frozen=True)
class ElasticTopology:
    chips_per_pod: int = 256
    model_parallel: int = 16
    global_batch: int = 256

    def plan(self, healthy_pods: int) -> dict:
        if healthy_pods < 1:
            raise RuntimeError("no healthy pods")
        chips = healthy_pods * self.chips_per_pod
        data = chips // self.model_parallel // healthy_pods
        # shrink data-parallel degree until the global batch divides
        while data > 1 and self.global_batch % (data * healthy_pods):
            data -= 1
        shape = (
            (healthy_pods, data, self.model_parallel)
            if healthy_pods > 1
            else (data, self.model_parallel)
        )
        axes = ("pod", "data", "model") if healthy_pods > 1 else ("data", "model")
        return {
            "mesh_shape": shape,
            "mesh_axes": axes,
            "chips": healthy_pods * self.chips_per_pod,
            "per_device_batch": self.global_batch // (data * healthy_pods),
        }
