"""Sorted posting-list block intersection (the Combiner's Step 1): CUDA
kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/intersect.py::
intersect_sorted``.  The host computes, per 128-element block of the probe
list ``a``, the tile offset into the build list ``b`` that could hold its
matches (:func:`block_offsets`, a ``searchsorted`` — the galloping skip of
the paper's iterators).  Each block then compares against ``n_chunks``
consecutive ``b`` tiles from that offset, clamped at the last tile, and ORs
the hits.  The kernel (``csrc/intersect.cu``) runs one CTA per ``a`` block
and stages each ``b`` tile in shared memory; at the serving path's list
sizes its time is the launch.

Both forms keep the TPU kernel's tile semantics exactly: when the tiles do
not cover a block's match span they under-report, and they never report a
false positive.  :func:`intersect_sorted` runs the kernel for CUDA tensors
and :func:`intersect_sorted_plain` for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

__all__ = ["PAD", "block_offsets", "intersect_sorted", "intersect_sorted_plain"]

PAD = np.int32(2**31 - 1)


def block_offsets(a: np.ndarray, b: np.ndarray, block_a: int, block_b: int) -> np.ndarray:
    """Host-side indirection: for each ``a`` block, the aligned start tile
    in ``b`` (rounded down to a ``block_b`` multiple)."""
    starts = a[::block_a]
    off = np.searchsorted(b, starts, side="left")
    off = (off // block_b) * block_b
    max_off = max(0, len(b) - block_b)
    return np.minimum(off, max_off).astype(np.int32)


def _check_shapes(a, b, offsets, block_a, block_b, n_chunks) -> None:
    na, nb = a.shape[0], b.shape[0]
    if a.dim() != 1 or b.dim() != 1 or na % block_a or nb % block_b or nb < block_b:
        raise ValueError(
            f"need 1-D a, b with len(a) % {block_a} == 0 and len(b) a positive "
            f"multiple of {block_b}, got {tuple(a.shape)} and {tuple(b.shape)}"
        )
    if offsets.shape != (na // block_a,):
        raise ValueError(f"need offsets [{na // block_a}], got {tuple(offsets.shape)}")
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")


def intersect_sorted_plain(
    a: torch.Tensor,  # [NA] sorted, padded with PAD
    b: torch.Tensor,  # [NB] sorted, padded with PAD
    offsets: torch.Tensor,  # [NA / block_a] from `block_offsets`
    block_a: int = 128,
    block_b: int = 256,
    n_chunks: int = 2,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather each block's clamped
    ``b`` tiles, then compare.  Returns int32 ``[NA]`` 1/0."""
    _check_shapes(a, b, offsets, block_a, block_b, n_chunks)
    n_blocks = a.shape[0] // block_a
    last_tile = b.shape[0] // block_b - 1
    chunk = torch.arange(n_chunks, device=a.device)
    tiles = (offsets.long()[:, None] // block_b + chunk).clamp(0, last_tile)
    cols = tiles[..., None] * block_b + torch.arange(block_b, device=a.device)
    btiles = b[cols].reshape(n_blocks, 1, n_chunks * block_b)
    a_blk = a.reshape(n_blocks, block_a)
    hit = (a_blk[..., None] == btiles).any(dim=-1) & (a_blk != int(PAD))
    return hit.reshape(-1).to(torch.int32)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("intersect")
    fn = lib.intersect_sorted_i32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def intersect_sorted(
    a: torch.Tensor,  # [NA] sorted int32, padded with PAD
    b: torch.Tensor,  # [NB] sorted int32, padded with PAD
    offsets: torch.Tensor,  # [NA / block_a] int32 from `block_offsets`
    block_a: int = 128,
    block_b: int = 256,
    n_chunks: int = 2,
) -> torch.Tensor:
    """1/0 int32 membership of each ``a`` element in ``b``, over the
    ``n_chunks`` tiles after each block's offset (see the module docstring).

    CUDA tensors launch the kernel (``intersect_sorted.launches`` counts the
    launches); CPU tensors take :func:`intersect_sorted_plain`.
    """
    _check_shapes(a, b, offsets, block_a, block_b, n_chunks)
    if a.device.type == "cpu":
        return intersect_sorted_plain(a, b, offsets, block_a, block_b, n_chunks)
    if a.device.type != "cuda" or b.device != a.device or offsets.device != a.device:
        raise ValueError(f"a, b and offsets must share one cuda device, got {a.device}, {b.device}, {offsets.device}")
    if not all(t.dtype == torch.int32 for t in (a, b, offsets)):
        raise ValueError("the intersect kernel takes int32 a, b and offsets")
    if block_a > 1024:
        raise ValueError(f"block_a {block_a} exceeds 1024 threads per CTA")
    a, b, offsets = a.contiguous(), b.contiguous(), offsets.contiguous()
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        status = _lib().intersect_sorted_i32(
            a.data_ptr(), b.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            a.shape[0], b.shape[0], block_a, block_b, n_chunks,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "intersect_sorted")
    intersect_sorted.launches += 1
    return out


intersect_sorted.launches = 0
