"""Int8 gradient compression with error feedback for cross-pod all-reduce.

The reference's ``repro/optim/grad_compression.py`` on ``torch.distributed``.
At multi-pod scale the ``pod`` axis crosses the slow links between pods;
compressing gradients 4x (fp32 -> int8 with a per-tensor scale) cuts that
traffic proportionally.  Error feedback (Seide et al., 1-bit SGD;
Karimireddy et al. 2019) keeps convergence: the quantization residual is
carried into the next step, making the compression unbiased in the long
run.  The reference writes the quantize -> psum -> dequantize pipeline as
an explicit ``shard_map``; here it is three all-reduces over the axis's
process group: the int8 values widened to int32, the scales, and the rank
count.
"""

from __future__ import annotations

from typing import Any

import torch

from ..parallel.collectives import all_reduce
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = ["init_error_feedback", "compressed_psum", "compressed_grad_allreduce"]


def init_error_feedback(grads_template: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_template)


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(g: torch.Tensor, err: torch.Tensor, mesh, axis_name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 psum of one tensor along ``axis_name`` of
    ``mesh``.

    Returns (mean-reduced gradient, new error residual).
    """
    x = g.to(torch.float32) + err
    q, scale = _quantize(x)
    new_err = x - q.to(torch.float32) * scale
    # int8 payload crosses the wire; accumulate in int32 to avoid overflow
    summed = all_reduce(q.to(torch.int32), mesh, axis_name)
    scale_sum = all_reduce(scale, mesh, axis_name)  # scales are cheap (1 scalar)
    n = all_reduce(torch.ones((), dtype=torch.float32, device=g.device), mesh, axis_name)
    # each shard contributed ~q*scale; use the mean scale for dequantization
    out = summed.to(torch.float32) * (scale_sum / n) / n
    return out.to(g.dtype), new_err


def compressed_grad_allreduce(grads: Any, err_state: Any, mesh, axis_name: str = "pod") -> tuple[Any, Any]:
    """Tree-wide compressed all-reduce over one mesh axis: (the reduced
    gradients, the new residuals), trees like ``grads``."""
    flat_g, treedef = tree_flatten(grads)
    outs = [compressed_psum(g, e, mesh, axis_name) for g, e in zip(flat_g, tree_leaves(err_state))]
    return tree_unflatten(treedef, [o[0] for o in outs]), tree_unflatten(treedef, [o[1] for o in outs])
