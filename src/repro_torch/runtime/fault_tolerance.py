"""Fault tolerance: checkpoint/restart loop and straggler mitigation.

A copy of the reference's host-only module (no device code).  This is the
TRAINING-loop side of fault tolerance: ``run_with_restarts`` drives offline
index-build / calibration jobs against a checkpoint manager, restarting
from the latest durable checkpoint on failure.  The SERVING side lives in
``search/resilience.py``, which wires :class:`RestartPolicy` into the shard
probe barrier (retry backoff for transient crashes) and owns the canonical
MAD straggler rule (``mad_stragglers``); :class:`StragglerMonitor` keeps its
training-loop interface but delegates the math there, so the two layers
can never disagree on what a straggler is.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

__all__ = ["RestartPolicy", "run_with_restarts", "StragglerMonitor"]


@dataclasses.dataclass
class RestartPolicy:
    """Exponential-backoff restart budget, shared by the training loop
    below and the serving probe barrier (``search/resilience.py``, DESIGN.md
    §14) — one retry policy for both layers."""

    max_restarts: int = 10
    min_backoff_s: float = 0.0  # 0 for tests; seconds in production
    backoff_factor: float = 2.0
    max_backoff_s: float = 300.0

    def backoff(self, attempt: int) -> float:
        return min(self.max_backoff_s, self.min_backoff_s * self.backoff_factor ** attempt)


def run_with_restarts(
    make_state: Callable[[], Any],
    step_fn: Callable[[Any, int], Any],
    n_steps: int,
    manager,  # CheckpointManager
    policy: RestartPolicy = RestartPolicy(),
    checkpoint_every: int = 10,
    on_restart: Callable[[int, BaseException], None] | None = None,
) -> tuple[Any, dict]:
    """Run ``step_fn`` for ``n_steps``, checkpointing and restarting on
    failure.  Returns (final_state, stats).  Deterministic: the state pytree
    includes the data cursor, so a restarted run replays identically."""
    stats = {"restarts": 0, "steps_run": 0, "recovered_from": []}
    attempt = 0
    while True:
        try:
            ckpt = manager.restore_latest(make_state())
        except Exception:
            ckpt = None
        if ckpt is not None:
            state, start = ckpt
            stats["recovered_from"].append(start)
        else:
            state = make_state()
            start = 0
        try:
            for step in range(start, n_steps):
                state = step_fn(state, step)
                stats["steps_run"] += 1
                if (step + 1) % checkpoint_every == 0 or step + 1 == n_steps:
                    manager.save_async(step + 1, state)
            manager.wait()
            return state, stats
        except KeyboardInterrupt:
            raise
        except BaseException as e:
            stats["restarts"] += 1
            attempt += 1
            if on_restart is not None:
                on_restart(attempt, e)
            if attempt > policy.max_restarts:
                raise
            time.sleep(policy.backoff(attempt))
            try:
                manager.wait()
            except BaseException:
                pass  # a failed async save must not block recovery


class StragglerMonitor:
    """Detect slow pods from per-step durations and recommend remapping.

    At scale, persistent stragglers (bad HBM, thermal throttling) show up as
    one pod's step time sitting k MADs above the fleet median.  The runtime
    swaps the straggler with a spare pod (topology remap) at the next
    checkpoint boundary rather than killing the job.

    The MAD rule itself is owned by ``search.resilience.mad_stragglers``
    (DESIGN.md §14) — the serving ``HealthMonitor`` applies the identical
    criterion to shard probe latencies, so training and serving agree on
    what a straggler is.  This class keeps the training-loop interface
    (``record``/``stragglers``) and delegates.
    """

    def __init__(self, n_workers: int, window: int = 20, mad_threshold: float = 5.0):
        self.n_workers = n_workers
        self.window = window
        self.mad_threshold = mad_threshold
        self._times: list[list[float]] = [[] for _ in range(n_workers)]

    def record(self, worker: int, step_time_s: float) -> None:
        t = self._times[worker]
        t.append(step_time_s)
        if len(t) > self.window:
            t.pop(0)

    def stragglers(self) -> list[int]:
        from ..search.resilience import mad_stragglers

        return mad_stragglers(self._times, self.mad_threshold)
