"""Sorted posting-list block intersection (the Combiner's Step 1): CUDA
kernel and its plain PyTorch version, for one list pair or for many
independent pairs (segments) in one launch.

Replaces the Pallas TPU kernel ``src/repro/kernels/intersect.py::
intersect_sorted``.  The host computes, per 128-element block of the probe
list ``a``, the tile offset into the build list ``b`` that could hold its
matches (:func:`block_offsets`, a ``searchsorted`` — the galloping skip of
the paper's iterators).  Each block then looks for its values in
``n_chunks`` consecutive ``b`` tiles from that offset (the floor of the
offset over the tile width), each clamped at the last tile.  A tile index
below 0 counts once from the end, as an index into the tiles does, and
clamps at the first tile: what the TPU kernel reads in interpret mode for a
negative offset (``block_offsets`` never gives one).  The kernel
(``csrc/intersect.cu``) runs one CTA per ``a`` block of any segment, stages
the block's window asynchronously in shared memory and binary-searches it
(a linear compare where the window is not sorted).

Both forms keep the TPU kernel's tile semantics exactly, per segment: when
the tiles do not cover a block's match span they under-report, and they
never report a false positive.  :func:`intersect_sorted` (one pair) and
:func:`intersect_sorted_segments` (a :class:`SegmentPack` of pairs) run the
kernel for CUDA tensors and :func:`intersect_sorted_plain` per segment for
CPU tensors only; under ``launch.cost_analysis.count_cost`` either charges
the bound's figures (``_cost``, ``_segments_cost``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..launch.cost_analysis import kernel_cost
from . import _build

__all__ = [
    "PAD",
    "SegmentPack",
    "block_offsets",
    "intersect_sorted",
    "intersect_sorted_plain",
    "intersect_sorted_segments",
    "pack_segments",
]

PAD = np.int32(2**31 - 1)


def block_offsets(a: np.ndarray, b: np.ndarray, block_a: int, block_b: int) -> np.ndarray:
    """Host-side indirection: for each ``a`` block, the aligned start tile
    in ``b`` (rounded down to a ``block_b`` multiple)."""
    starts = a[::block_a]
    off = np.searchsorted(b, starts, side="left")
    off = (off // block_b) * block_b
    max_off = max(0, len(b) - block_b)
    return np.minimum(off, max_off).astype(np.int32)


def _check_shapes(a_shape, b_shape, off_shape, block_a, block_b, n_chunks) -> None:
    a_shape, b_shape, off_shape = tuple(a_shape), tuple(b_shape), tuple(off_shape)
    na, nb = a_shape[0], b_shape[0]
    if len(a_shape) != 1 or len(b_shape) != 1 or na % block_a or nb % block_b or nb < block_b:
        raise ValueError(
            f"need 1-D a, b with len(a) % {block_a} == 0 and len(b) a positive "
            f"multiple of {block_b}, got {a_shape} and {b_shape}"
        )
    if off_shape != (na // block_a,):
        raise ValueError(f"need offsets [{na // block_a}], got {off_shape}")
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
    _check_shapes(a.shape, b.shape, offsets.shape, block_a, block_b, n_chunks)
    n_blocks = a.shape[0] // block_a
    n_tiles = b.shape[0] // block_b
    chunk = torch.arange(n_chunks, device=a.device)
    tiles = offsets.long()[:, None] // block_b + chunk
    tiles = torch.where(tiles < 0, tiles + n_tiles, tiles).clamp(0, n_tiles - 1)
    cols = tiles[..., None] * block_b + torch.arange(block_b, device=a.device)
    btiles = b[cols].reshape(n_blocks, 1, n_chunks * block_b)
    a_blk = a.reshape(n_blocks, block_a)
    hit = (a_blk[..., None] == btiles).any(dim=-1) & (a_blk != int(PAD))
    return hit.reshape(-1).to(torch.int32)


@dataclass(frozen=True)
class SegmentPack:
    """Layout of a batch of segments packed into one int32 buffer, so a
    batch is one host-to-device copy and one launch::

        [a_0 | a_1 | ... | b_0 | b_1 | ... | offsets_0 | offsets_1 | ...
         | segment id of each a block | (b base, nb, n_chunks) per segment]

    Each segment keeps its own ``n_chunks``.  The output of
    :func:`intersect_sorted_segments` is the segments' masks concatenated
    in the order of their ``a``; :meth:`split` cuts it.
    """

    na: tuple[int, ...]
    nb: tuple[int, ...]
    n_chunks: tuple[int, ...]
    block_a: int = 128
    block_b: int = 256

    @property
    def n_blocks(self) -> int:
        return sum(self.na) // self.block_a

    @property
    def window_max(self) -> int:
        """The widest ``b`` window any block searches."""
        return max(
            (min(c, nb // self.block_b) * self.block_b for nb, c in zip(self.nb, self.n_chunks)),
            default=0,
        )

    def _bounds(self) -> list[int]:
        s = len(self.na)
        sizes = [sum(self.na), sum(self.nb), self.n_blocks, self.n_blocks, 3 * s]
        return np.cumsum([0, *sizes]).tolist()

    @property
    def size(self) -> int:
        return self._bounds()[-1]

    def __post_init__(self):
        if not len(self.na) == len(self.nb) == len(self.n_chunks):
            raise ValueError("na, nb and n_chunks need one entry per segment")
        for na, nb, n_chunks in zip(self.na, self.nb, self.n_chunks):
            _check_shapes((na,), (nb,), (na // self.block_a,), self.block_a, self.block_b, n_chunks)

    def views(self, buf):
        """``(a, b, offsets, blk_seg, table)`` views of a packed buffer."""
        at = self._bounds()
        return tuple(buf[at[k] : at[k + 1]] for k in range(5))

    def segment(self, buf, s: int):
        """``(a, b, offsets)`` views of segment ``s`` of a packed buffer."""
        a, b, offsets, _, _ = self.views(buf)
        a_at, b_at = (np.cumsum([0, *n]).tolist() for n in (self.na, self.nb))
        blk = [x // self.block_a for x in a_at]
        return (a[a_at[s] : a_at[s + 1]], b[b_at[s] : b_at[s + 1]],
                offsets[blk[s] : blk[s + 1]])

    def split(self, out):
        """Per-segment masks of a concatenated output (views)."""
        at = np.cumsum([0, *self.na]).tolist()
        return [out[at[k] : at[k + 1]] for k in range(len(self.na))]


def pack_segments(
    segments: Sequence[tuple[np.ndarray, np.ndarray, np.ndarray, int]],
    block_a: int = 128,
    block_b: int = 256,
    pinned: bool = False,
) -> tuple[torch.Tensor, SegmentPack]:
    """Pack ``(a, b, offsets, n_chunks)`` segments (numpy, as
    ``fused.intersect_inputs`` returns them) into one int32 CPU tensor —
    page-locked with ``pinned=True``, so its copy to the card can be
    asynchronous — and its :class:`SegmentPack`."""
    for a, b, offsets, n_chunks in segments:
        _check_shapes(a.shape, b.shape, offsets.shape, block_a, block_b, n_chunks)
    pack = SegmentPack(
        tuple(len(s[0]) for s in segments),
        tuple(len(s[1]) for s in segments),
        tuple(int(s[3]) for s in segments),
        block_a,
        block_b,
    )
    buf = torch.empty(pack.size, dtype=torch.int32, pin_memory=pinned)
    a_all, b_all, off_all, blk_seg, table = pack.views(buf.numpy())
    a_at = b_at = blk = 0
    for s, (a, b, offsets, n_chunks) in enumerate(segments):
        n_blk = len(offsets)
        a_all[a_at : a_at + len(a)] = a
        b_all[b_at : b_at + len(b)] = b
        off_all[blk : blk + n_blk] = offsets
        blk_seg[blk : blk + n_blk] = s
        table[3 * s : 3 * s + 3] = (b_at, len(b), n_chunks)
        a_at, b_at, blk = a_at + len(a), b_at + len(b), blk + n_blk
    return buf, pack


def _search_ops(na: int, nb: int, block_b: int, n_chunks: int) -> int:
    """One binary search per ``a`` element over its block's window of
    ``min(n_chunks, nb // block_b) * block_b`` sorted ``b`` elements."""
    window = min(n_chunks, nb // block_b) * block_b
    return na * math.ceil(math.log2(max(window, 1)))


def _cost(na: int, nb: int, block_a: int, block_b: int, n_chunks: int) -> tuple[float, float]:
    """(operations, bytes) of one pair, as its roofline bound counts them:
    ``a``, ``b`` and the offsets read once, the mask written once; a binary
    search per ``a`` element."""
    return float(_search_ops(na, nb, block_b, n_chunks)), float(4 * (na + nb + na // block_a + na))


def _segments_cost(pack: "SegmentPack") -> tuple[float, float]:
    """(operations, bytes) of one segmented launch: the packed buffer read
    once, the masks written once, a search per ``a`` element over its
    segment's window."""
    ops = sum(_search_ops(na, nb, pack.block_b, c) for na, nb, c in zip(pack.na, pack.nb, pack.n_chunks))
    return float(ops), float(4 * (pack.size + sum(pack.na)))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("intersect")
    fn = lib.intersect_sorted_segments_i32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch(a, b, offsets, blk_seg, table, n_blocks, block_a, block_b, nb, n_chunks, window_max):
    """One launch of the kernel; ``blk_seg``/``table`` None for one segment."""
    if block_a > 1024:
        raise ValueError(f"block_a {block_a} exceeds 1024 threads per CTA")
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        status = _lib().intersect_sorted_segments_i32(
            a.data_ptr(), b.data_ptr(), offsets.data_ptr(),
            None if blk_seg is None else blk_seg.data_ptr(),
            None if table is None else table.data_ptr(),
            out.data_ptr(), n_blocks, block_a, block_b, nb, n_chunks, window_max,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "intersect_sorted")
    intersect_sorted.launches += 1
    return out


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
    launches of both wrappers); CPU tensors take
    :func:`intersect_sorted_plain`.
    """
    _check_shapes(a.shape, b.shape, offsets.shape, block_a, block_b, n_chunks)
    with kernel_cost(lambda: _cost(a.shape[0], b.shape[0], block_a, block_b, n_chunks)):
        if a.device.type == "cpu":
            return intersect_sorted_plain(a, b, offsets, block_a, block_b, n_chunks)
        return _launch_pair(a, b, offsets, block_a, block_b, n_chunks)


def _launch_pair(a, b, offsets, block_a, block_b, n_chunks):
    if a.device.type != "cuda" or b.device != a.device or offsets.device != a.device:
        raise ValueError(f"a, b and offsets must share one cuda device, got {a.device}, {b.device}, {offsets.device}")
    if not all(t.dtype == torch.int32 for t in (a, b, offsets)):
        raise ValueError("the intersect kernel takes int32 a, b and offsets")
    a, b, offsets = a.contiguous(), b.contiguous(), offsets.contiguous()
    nb = b.shape[0]
    window = min(n_chunks, nb // block_b) * block_b
    return _launch(a, b, offsets, None, None, a.shape[0] // block_a, block_a, block_b, nb, n_chunks, window)


def intersect_sorted_segments(buf: torch.Tensor, pack: SegmentPack) -> torch.Tensor:
    """:func:`intersect_sorted` of every segment of a packed buffer (see
    :func:`pack_segments`), each with its own ``n_chunks``: the masks
    concatenated, int32 ``[sum(pack.na)]``; ``pack.split`` cuts them.

    A CUDA buffer is ONE launch of the kernel over every segment (counted in
    ``intersect_sorted.launches``); a CPU buffer takes
    :func:`intersect_sorted_plain` segment by segment.
    """
    if buf.dim() != 1 or buf.shape[0] != pack.size or buf.dtype != torch.int32:
        raise ValueError(f"need a 1-D int32 buffer of {pack.size} elements, got {tuple(buf.shape)} {buf.dtype}")
    with kernel_cost(lambda: _segments_cost(pack)):
        if buf.device.type == "cpu":
            if not pack.na:
                return buf[:0]
            return torch.cat([
                intersect_sorted_plain(*pack.segment(buf, s), pack.block_a, pack.block_b, pack.n_chunks[s])
                for s in range(len(pack.na))
            ])
        return _launch_segments(buf, pack)


def _launch_segments(buf: torch.Tensor, pack: SegmentPack) -> torch.Tensor:
    if buf.device.type != "cuda":
        raise ValueError(f"the packed buffer must lie on a cuda device or the cpu, got {buf.device}")
    buf = buf.contiguous()
    a, b, offsets, blk_seg, table = pack.views(buf)
    return _launch(a, b, offsets, blk_seg, table, pack.n_blocks, pack.block_a, pack.block_b,
                   0, 1, pack.window_max)


intersect_sorted.launches = 0
