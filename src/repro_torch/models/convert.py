"""Carry parameters and optimizer state between the reference and the port.

The reference keeps its trees as jax arrays, which read as numpy arrays
(``np.asarray``); bfloat16 leaves are numpy arrays of ml_dtypes'
``bfloat16``, or raw 2-byte words (void ``V2``) where they come from a
checkpoint file.  ``from_reference`` turns any such tree into torch tensors
on a device, bit for bit; ``to_reference`` turns a port tree back into numpy
arrays.  Trees keep their structure: a parameter tree (a dict of dicts, or
the GAT's list of ``{w, a_src, a_dst}``, one a layer), an AdamW state
(``m``, ``v``, ``master``, ``step``) or a trainer checkpoint payload.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..tree import tree_map

__all__ = ["from_reference", "to_reference", "leaf_from_numpy", "leaf_to_numpy"]


def _is_bf16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16" or (dtype.kind == "V" and dtype.itemsize == 2)


def leaf_from_numpy(a: Any, device="cuda") -> torch.Tensor:
    """One numpy array (or scalar) as a tensor on ``device``; a bfloat16 or
    raw 2-byte leaf becomes ``torch.bfloat16`` with the same bits."""
    a = np.asarray(a)
    if _is_bf16(a.dtype):
        return torch.from_numpy(np.array(a, order="C").view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def leaf_to_numpy(t: Any, bfloat16: Any = None) -> np.ndarray:
    """One tensor (or numpy leaf) as a numpy array on the host.  A
    ``torch.bfloat16`` tensor becomes ``bfloat16`` (a numpy dtype the caller
    passes, e.g. ``jnp.bfloat16``) or, by default, raw 2-byte words
    (``V2``), as a checkpoint file holds them."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2") if bfloat16 is None else bfloat16)
    return t.numpy()


def from_reference(tree: Any, *, device="cuda") -> Any:
    """The reference's tree (jax or numpy arrays) as the port's, on
    ``device``."""
    return tree_map(lambda a: leaf_from_numpy(a, device), tree)


def to_reference(tree: Any, *, bfloat16: Any = None) -> Any:
    """The port's tree as numpy arrays (see ``leaf_to_numpy``)."""
    return tree_map(lambda t: leaf_to_numpy(t, bfloat16), tree)
