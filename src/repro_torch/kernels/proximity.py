"""Dense minimal-fragment cover (the Combiner's Step 3): CUDA kernel and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/proximity.py::
proximity_window``.  The kernel (``csrc/proximity.cu``) gives one CTA a tile
of 512 positions of one row, stages the active lemmas' occupancy of the
tile and a 64-position halo in shared memory, and picks one of two branches
per tile from the data: where every staged value is 0 or 1 (the serving
path's occupancy) it packs the occupancy into bit words and finds each
lemma's covering offset with leading-zero and population counts; elsewhere
it sums each candidate window in the compute type's wrapping arithmetic.
Both branches compute the plain version's function for any input.  Its
roofline bound is the bytes of the active occupancy rows it reads and the
emit/start rows it writes (the source's note says more; ``PERF.md`` has its
times on the H100).

:func:`proximity_window` runs the kernel for CUDA tensors and the plain
version (``core.window.window_cover_batch``) for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.window import window_cover_batch
from . import _build

__all__ = ["proximity_window", "proximity_window_plain", "COMPUTE_DTYPES"]

COMPUTE_DTYPES = {"uint8": torch.uint8, "int32": torch.int32}
MAX_WINDOW = 64  # one bit per window offset in the kernel's 64-bit masks


def _compute_dtype(compute_dtype: str, window: int) -> torch.dtype:
    cdt = COMPUTE_DTYPES.get(compute_dtype)
    if cdt is None:
        raise ValueError(
            f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {compute_dtype!r}"
        )
    if cdt != torch.int32 and window > torch.iinfo(cdt).max:
        raise ValueError(
            f"compute_dtype {compute_dtype} cannot hold window counts up to {window}"
        )
    return cdt


def proximity_window_plain(
    occ: torch.Tensor,  # [B, L, N] occupancy (any integer dtype)
    mult: torch.Tensor,  # [B, L]
    max_distance: int,
    compute_dtype: str = "int32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: ``(emit bool [B, N], start
    int32 [B, N])`` with occupancy and multiplicities cast to
    ``compute_dtype`` first, as the kernel casts them."""
    window = 2 * max_distance + 1
    cdt = _compute_dtype(compute_dtype, window)
    return window_cover_batch(occ.to(cdt), mult.to(cdt), window)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("proximity")
    for fn in (lib.proximity_window_u8, lib.proximity_window_i32):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def proximity_window(
    occ: torch.Tensor,  # [B, L, N] occupancy (any integer dtype)
    mult: torch.Tensor,  # [B, L]
    max_distance: int,
    compute_dtype: str = "int32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched minimal-fragment cover: ``(emit bool [B, N], start int32
    [B, N])``, the semantics of ``kernels.ref.proximity_window_ref``.

    CUDA tensors launch the kernel (``proximity_window.launches`` counts
    the launches); CPU tensors take :func:`proximity_window_plain`.
    ``compute_dtype`` (``"uint8"`` or ``"int32"``) narrows the occupancy the
    kernel reads; it must hold the window length.
    """
    window = 2 * max_distance + 1
    cdt = _compute_dtype(compute_dtype, window)
    if occ.dim() != 3 or mult.shape != occ.shape[:2]:
        raise ValueError(f"need occ [B, L, N] and mult [B, L], got {tuple(occ.shape)} and {tuple(mult.shape)}")
    if occ.device.type == "cpu":
        return proximity_window_plain(occ, mult, max_distance, compute_dtype)
    if occ.device.type != "cuda":
        raise ValueError(f"proximity_window runs on cuda or cpu, not {occ.device}")
    if window > MAX_WINDOW:
        raise ValueError(f"window {window} exceeds the kernel's {MAX_WINDOW}")
    b, l, n = occ.shape
    occ_c = occ.to(cdt).contiguous()
    mult_c = mult.to(device=occ.device, dtype=cdt).contiguous()
    emit = torch.empty((b, n), dtype=torch.bool, device=occ.device)
    start = torch.empty((b, n), dtype=torch.int32, device=occ.device)
    lib = _lib()
    launch = lib.proximity_window_u8 if cdt == torch.uint8 else lib.proximity_window_i32
    with torch.cuda.device(occ.device):
        status = launch(
            occ_c.data_ptr(), mult_c.data_ptr(), emit.data_ptr(), start.data_ptr(),
            b, l, n, window, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "proximity_window")
    proximity_window.launches += 1
    return emit, start


proximity_window.launches = 0
