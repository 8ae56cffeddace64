"""Arena block gather (stage 0 of the arena serving program): CUDA kernel
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/gather.py::
gather_blocks``.  The device-resident posting arena (``search/arena.py``)
keeps each §3 posting family's event streams as ``(doc, pos)`` int32 rows
in one device buffer, every extent aligned to a ``block``-row boundary.  A
batch slices it with a per-output-block indirection table: output block
``i`` is arena block ``src_block[i]``, rows at or past ``n_valid[i]`` are
the ``-1`` sentinel.  The kernel (``csrc/gather.cu``) is a plain indexed
copy, one thread per 16-byte pair of rows; its bound is the bytes it moves.

:func:`gather_blocks` runs the kernel for CUDA tensors and
:func:`gather_blocks_plain` for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["ARENA_BLOCK", "gather_blocks", "gather_blocks_plain"]

# Arena extent alignment (rows), the reference's: 128 rows of (doc, pos).
ARENA_BLOCK = 128


def _check_shapes(arena, src_block, n_valid, block) -> None:
    if block < 2 or block % 2:
        raise ValueError(f"block must be even and >= 2, got {block}")
    if arena.dim() != 2 or arena.shape[1] != 2:
        raise ValueError(f"need arena [rows, 2] (doc, pos), got {tuple(arena.shape)}")
    if arena.shape[0] == 0 or arena.shape[0] % block:
        raise ValueError(f"arena rows {arena.shape[0]} must be a positive multiple of block {block}")
    if src_block.dim() != 1 or n_valid.shape != src_block.shape:
        raise ValueError(
            f"need src_block [G] and n_valid [G], got {tuple(src_block.shape)} and {tuple(n_valid.shape)}"
        )


def gather_blocks_plain(
    arena: torch.Tensor,  # [NB * block, 2] int32 (doc, pos) rows
    src_block: torch.Tensor,  # [G] int32 arena block per output block
    n_valid: torch.Tensor,  # [G] int32 live rows per output block
    block: int = ARENA_BLOCK,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the reference's
    ``gather_blocks_ref``): ``[G * block, 2]`` int32."""
    _check_shapes(arena, src_block, n_valid, block)
    g = src_block.shape[0]
    idx = torch.arange(g * block, device=arena.device)
    within, blk = idx % block, idx // block
    src = src_block.to(torch.int64)[blk] * block + within
    rows = arena[src.clamp(0, arena.shape[0] - 1)]
    live = within < n_valid[blk]
    return torch.where(live[:, None], rows, -1).to(torch.int32)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gather")
    fn = lib.gather_blocks_i32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def gather_blocks(
    arena: torch.Tensor,  # [NB * block, 2] int32 (doc, pos) rows
    src_block: torch.Tensor,  # [G] int32 arena block per output block
    n_valid: torch.Tensor,  # [G] int32 live rows per output block
    block: int = ARENA_BLOCK,
) -> torch.Tensor:
    """Copy arena block ``src_block[i]`` into output block ``i`` (``[G *
    block, 2]`` int32), masking rows at or past ``n_valid[i]`` with ``-1``;
    a live row's source index is clamped to the arena.

    CUDA tensors launch the kernel (``gather_blocks.launches`` counts the
    launches); CPU tensors take :func:`gather_blocks_plain`.
    """
    _check_shapes(arena, src_block, n_valid, block)
    if arena.device.type == "cpu":
        return gather_blocks_plain(arena, src_block, n_valid, block)
    if arena.device.type != "cuda" or src_block.device != arena.device or n_valid.device != arena.device:
        raise ValueError(
            f"arena, src_block and n_valid must share one cuda device, got "
            f"{arena.device}, {src_block.device}, {n_valid.device}"
        )
    if not all(t.dtype == torch.int32 for t in (arena, src_block, n_valid)):
        raise ValueError("the gather kernel takes int32 arena, src_block and n_valid")
    if not all(t.is_contiguous() for t in (arena, src_block, n_valid)):
        raise ValueError("the gather kernel takes contiguous arena, src_block and n_valid")
    if arena.data_ptr() % 16:
        raise ValueError("the gather kernel reads the arena as 16-byte vectors: it must be 16-byte aligned")
    g = src_block.shape[0]
    out = torch.empty((g * block, 2), dtype=torch.int32, device=arena.device)
    if g == 0:
        return out
    with torch.cuda.device(arena.device):
        status = _lib().gather_blocks_i32(
            arena.data_ptr(), src_block.data_ptr(), n_valid.data_ptr(), out.data_ptr(),
            arena.shape[0], g, block, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "gather_blocks")
    gather_blocks.launches += 1
    return out


gather_blocks.launches = 0
