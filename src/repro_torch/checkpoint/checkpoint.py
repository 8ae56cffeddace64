"""Durable-write primitives (DESIGN.md §12.4), shared by the index store
(``index/store.py``) and the write-ahead log (``index/wal.py``).

Writes go to a temporary name and are published by a rename only after the
manifest fsyncs, so a crash mid-write never corrupts the latest artifact;
retention deletes old entries only after a newer one is durable.  The bytes
these helpers write are the reference package's, byte for byte: a snapshot
or log written by either package reads in the other.

The reference module's train-state half (``save_checkpoint``,
``restore_checkpoint``, ``CheckpointManager``) is not ported yet.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any

__all__ = [
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
