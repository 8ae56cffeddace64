"""Train-state checkpoints and durable-write primitives (DESIGN.md §12.4).

The durable-write helpers are shared by the index store (``index/store.py``),
the write-ahead log (``index/wal.py``) and the train-state checkpoints.
Writes go to a temporary name and are published by a rename only after the
manifest fsyncs, so a crash mid-write never corrupts the latest artifact;
retention deletes old entries only after a newer one is durable.

A train-state checkpoint is the reference's on-disk format: ``step_<n>/``
holds ``arrays.npz`` (leaves ``a0``, ``a1``, ... in ``jax.tree.flatten``
order: dict keys sorted) and ``manifest.json`` (``step``, ``n_leaves``, the
``PyTreeDef(...)`` string, ``time``, ``leaf_shapes``, ``leaf_dtypes``).  A
bfloat16 leaf is stored as raw 2-byte words under the reference's header
(``'<V2'``) and named ``bfloat16`` in the manifest, so every ``.npy`` entry
is the reference's byte for byte and no ml_dtypes is needed to read it back.
Unlike the reference, whose restore returns such leaves as raw ``V2`` arrays,
``restore_checkpoint`` reads ``leaf_dtypes`` and returns ``torch.bfloat16``.

Checkpoints are layout-free (elastic resume, DESIGN.md §12.4).  A save in a
world of ranks (``mesh=`` and ``specs=``, the payload's partition specs)
gathers every leaf whole (``parallel.sharding.gather_tree``) and rank 0
writes it, so the files are those a one-rank save of the same state
writes; a restore with ``mesh=`` and ``specs=`` gives each rank its slices
of the leaves under the current mesh, whatever the world that saved them.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..models.convert import leaf_from_numpy, leaf_to_numpy
from ..parallel.sharding import gather_tree, shard_tree
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten, treedef_str

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "CheckpointManager",
    "fsync_json",
    "append_durable",
    "replace_dir",
    "retain_latest",
    "latest_numbered",
]

_MANIFEST = "manifest.json"


def fsync_json(path: str | Path, obj: Any) -> None:
    """Dump ``obj`` as JSON and fsync before returning (DESIGN.md §12.4).

    The manifest fsync is the durability point of every atomic directory
    write: once it returns, a rename of the enclosing directory publishes a
    complete, self-consistent artifact.
    """
    with open(path, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())


def append_durable(path: str | Path, data: bytes) -> int:
    """Append ``data`` to ``path`` and fsync before returning (DESIGN.md
    §12.4 / §18.1) — the durability point of every write-ahead log frame:
    once this returns, the bytes survive any crash, so an operation logged
    through it may be acknowledged.  Returns the byte offset the frame was
    written at (the file length before the append).  The file is opened and
    closed per call so crashed writers never hold a recovered-over handle.
    The appended bytes are identical to ``data`` (framing/CRC is the
    caller's job — see ``index/wal.py``)."""
    with open(path, "ab") as f:
        offset = f.tell()
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    return offset


def replace_dir(tmp: str | Path, final: str | Path) -> None:
    """Publish ``tmp`` as ``final`` without ever exposing a partial artifact
    (DESIGN.md §12.4).

    Directories cannot be renamed over on POSIX, so an existing ``final``
    is first renamed aside to ``<final>.old`` (atomic), then ``tmp`` is
    renamed into place (atomic), then the old copy is deleted.  No reader
    ever sees a half-written directory under the final name; a crash
    between the two renames loses only the *name* — the complete previous
    artifact survives as ``<final>.old`` (and numbered readers like
    ``latest_numbered`` simply fall back to the previous entry).
    """
    tmp, final = Path(tmp), Path(final)
    old = final.with_name(final.name + ".old")
    if old.exists():
        shutil.rmtree(old)
    had_old = False
    if final.exists():
        final.rename(old)
        had_old = True
    tmp.rename(final)
    if had_old:
        shutil.rmtree(old, ignore_errors=True)


def retain_latest(directory: str | Path, prefix: str, keep: int) -> None:
    """Delete all but the ``keep`` highest-numbered ``<prefix>_<N>`` dirs
    (DESIGN.md §12.4 retention; ``keep <= 0`` retains everything)."""
    if keep <= 0:
        return
    entries = sorted(_numbered(Path(directory), prefix))
    for _, p in entries[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_numbered(directory: str | Path, prefix: str) -> int | None:
    """Highest N among complete ``<prefix>_<N>`` dirs — complete means the
    manifest exists, i.e. the §12.4 rename happened (``None`` if none)."""
    entries = _numbered(Path(directory), prefix)
    return max((n for n, _ in entries), default=None)


def _numbered(directory: Path, prefix: str) -> list[tuple[int, Path]]:
    out: list[tuple[int, Path]] = []
    for p in directory.glob(f"{prefix}_*"):
        if not p.is_dir() or p.name.endswith(".tmp"):
            continue
        if not (p / _MANIFEST).exists():
            continue
        try:
            out.append((int(p.name.rsplit("_", 1)[1]), p))
        except ValueError:
            continue
    return out


def _savez(path: Path, leaves: list[np.ndarray], bf16: list[bool]) -> None:
    """``np.savez(path, a0=..., a1=...)``, with each bfloat16 leaf (raw
    2-byte words) under the header ml_dtypes' bfloat16 gives (``'<V2'``)."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for i, (leaf, is_bf16) in enumerate(zip(leaves, bf16)):
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as fid:
                if not is_bf16:
                    np.lib.format.write_array(fid, leaf, allow_pickle=False)
                    continue
                header = np.lib.format.header_data_from_array_1_0(leaf)
                header["descr"] = "<V2"
                np.lib.format.write_array_header_1_0(fid, header)
                fid.write(leaf.tobytes(order="C"))


def _whole(payload: Any, mesh, specs: Any) -> Any:
    """Every tensor leaf of ``payload`` gathered whole under ``specs``."""
    if mesh is None or mesh.size == 1:
        return payload
    return tree_map(lambda x, s: gather_tree(x, s, mesh) if isinstance(x, torch.Tensor) else x, payload, specs)


def _barrier(mesh) -> None:
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist

        dist.barrier(group=mesh.group(mesh.axis_names))


def save_checkpoint(directory: str | Path, step: int, payload: Any, keep: int = 3, *, mesh=None,
                    specs: Any = None) -> Path:
    """Atomic synchronous save of a tree ``payload`` of tensors and numpy
    arrays (DESIGN.md §12.4 write protocol: tmp dir -> manifest fsync ->
    rename).  In a world (``mesh``), ``payload`` is this rank's shards
    under ``specs`` (a tree like it): every rank calls it, the leaves are
    gathered and rank 0 writes them; every rank returns once they are
    durable."""
    if mesh is not None and mesh.size > 1:
        whole = _whole(payload, mesh, specs)
        path = Path(directory) / f"step_{step}"
        if mesh.rank == 0:
            path = save_checkpoint(directory, step, whole, keep)
        _barrier(mesh)
        return path
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"step_{step}.tmp"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    raw = tree_leaves(payload)
    bf16 = [isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16 for x in raw]
    leaves = [leaf_to_numpy(x) for x in raw]
    _savez(tmp / "arrays.npz", leaves, bf16)
    meta = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": treedef_str(payload),
        "time": time.time(),
        "leaf_shapes": [list(x.shape) for x in leaves],
        "leaf_dtypes": ["bfloat16" if b else str(x.dtype) for x, b in zip(leaves, bf16)],
    }
    fsync_json(tmp / _MANIFEST, meta)
    replace_dir(tmp, final)
    retain_latest(directory, "step", keep)
    return final


def latest_step(directory: str | Path) -> int | None:
    """Highest durable checkpoint step in ``directory`` (DESIGN.md §12.4)."""
    return latest_numbered(directory, "step")


def restore_checkpoint(
    directory: str | Path,
    template: Any,
    step: int | None = None,
    *,
    device="cuda",
    mesh=None,
    specs: Any = None,
) -> tuple[Any, int] | None:
    """Restore the checkpoint at ``step`` (default the latest) into the
    structure of ``template``, every leaf a tensor on ``device`` (bfloat16
    where the manifest says so); ``None`` when there is none.  With
    ``mesh`` and ``specs`` (a tree like ``template``), each leaf is this
    rank's slice of it under the current mesh (elastic resume)."""
    directory = Path(directory)
    step = step if step is not None else latest_step(directory)
    if step is None:
        return None
    path = directory / f"step_{step}"
    meta = json.loads((path / _MANIFEST).read_text())
    with np.load(path / "arrays.npz") as z:
        arrays = [z[f"a{i}"] for i in range(len(z.files))]
    _, treedef = tree_flatten(template)
    if len(arrays) != meta["n_leaves"] or len(arrays) != len(tree_leaves(template)):
        raise ValueError(f"{path}: {len(arrays)} leaves, the manifest says {meta['n_leaves']}, "
                         f"the template has {len(tree_leaves(template))}")
    leaves = []
    for a, dtype in zip(arrays, meta["leaf_dtypes"]):
        if (dtype == "bfloat16") != (a.dtype.kind == "V" and a.dtype.itemsize == 2):
            raise ValueError(f"{path}: a leaf of dtype {a.dtype} named {dtype} in the manifest")
        leaves.append(leaf_from_numpy(a, device))
    tree = tree_unflatten(treedef, leaves)
    if mesh is not None and mesh.size > 1:
        tree = shard_tree(tree, specs, mesh)
    return tree, step


class CheckpointManager:
    """Async double-buffered manager (DESIGN.md §12.4: one write in flight,
    errors surfaced on ``wait``)."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save_async(self, step: int, payload: Any, *, mesh=None, specs: Any = None) -> None:
        """Copy ``payload`` to host memory on the calling thread, then write
        it on a background thread.  In a world (``mesh``, ``specs`` as for
        ``save_checkpoint``), every rank calls it: the leaves are gathered
        on the calling thread and rank 0 writes them."""
        self.wait()  # one in flight at a time (double buffering)
        payload = _whole(payload, mesh, specs)
        if mesh is not None and mesh.size > 1 and mesh.rank != 0:
            return
        host = tree_map(
            lambda x: x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else np.array(x), payload)

        def _write():
            try:
                save_checkpoint(self.directory, step, host, keep=self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, template: Any, *, device="cuda", mesh=None, specs: Any = None):
        return restore_checkpoint(self.directory, template, device=device, mesh=mesh, specs=specs)
