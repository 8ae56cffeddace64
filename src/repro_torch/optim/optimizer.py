"""AdamW with fp32 master weights, global-norm clipping and cosine schedule.

The reference's ``repro/optim/optimizer.py`` on trees of torch tensors.  The
optimizer state mirrors the params: fp32 ``m``/``v`` moments, an fp32
``master`` copy (params themselves may live in bf16) and an int32 ``step``.
Weight decay applies to every leaf, gradients are clipped by their pre-clip
global norm, bias correction reads the int32 step, and the new params are
the new master cast to each param's dtype.  ``adamw_update`` returns new
tensors and leaves its inputs as they were.

On a mesh every leaf is this rank's shard (``parallel.sharding``): the
moments and the master copy live on the param shards
(``opt_state_specs``), the update is elementwise, and only the global norm
that sets the clip scale needs the other ranks (``global_norm(...,
specs=, mesh=)``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..parallel.collectives import all_reduce
from ..parallel.sharding import spec_axes
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule", "global_norm", "cast_like"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000


def cosine_schedule(step: torch.Tensor | int, cfg: AdamWConfig) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0,
        1.0,
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Any, *, specs: Any = None, mesh=None) -> torch.Tensor:
    """sqrt of the sum, over the leaves in tree order, of each leaf's sum of
    squares in float32.

    With ``mesh`` (and ``specs``, the leaves' partition specs), the leaves
    are shards: the sums of the leaves sharded over the same axes are
    all-reduced over those axes alone, so a leaf replicated on an axis is
    counted once, not once for each of its copies."""
    if mesh is None or mesh.size == 1:
        total = None
        for leaf in tree_leaves(tree):
            sq = torch.sum(leaf.float() ** 2)
            total = sq if total is None else total + sq
        return torch.sqrt(total)
    by_axes: dict[tuple[str, ...], torch.Tensor] = {}
    for leaf, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        axes = tuple(a for a in mesh.axis_names if a in spec_axes(spec))
        sq = torch.sum(leaf.float() ** 2)
        by_axes[axes] = sq if axes not in by_axes else by_axes[axes] + sq
    total = None
    for axes, sq in by_axes.items():
        sq = all_reduce(sq, mesh, axes) if axes else sq
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_init(params: Any) -> dict[str, Any]:
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        "master": tree_map(lambda p: p.to(torch.float32, copy=True), params),
        "step": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
    }


def adamw_update(grads: Any, state: dict[str, Any], cfg: AdamWConfig, *, specs: Any = None,
                 mesh=None) -> tuple[Any, dict[str, Any]]:
    """Returns (new fp32 master weights, new state); on a mesh, of this
    rank's shards (``specs`` the params')."""
    step = state["step"] + 1
    lr = cosine_schedule(step, cfg)
    gnorm = global_norm(grads, specs=specs, mesh=mesh)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1c = 1.0 - torch.pow(cfg.beta1, step.to(torch.float32))
    b2c = 1.0 - torch.pow(cfg.beta2, step.to(torch.float32))

    def upd(g, m, v, master):
        g = g.float() * scale
        m_new = cfg.beta1 * m + (1 - cfg.beta1) * g
        v_new = cfg.beta2 * v + (1 - cfg.beta2) * g * g
        mh = m_new / b1c
        vh = v_new / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * master
        master_new = master - lr * delta
        return m_new, v_new, master_new

    flat_g, treedef = tree_flatten(grads)
    out = [upd(*xs) for xs in zip(flat_g, *(tree_leaves(state[k]) for k in ("m", "v", "master")))]
    new_m, new_v, new_w = (tree_unflatten(treedef, [o[i] for o in out]) for i in range(3))
    return new_w, {"m": new_m, "v": new_v, "master": new_w, "step": step}


def cast_like(master: Any, params_template: Any) -> Any:
    return tree_map(lambda w, p: w.to(p.dtype), master, params_template)
