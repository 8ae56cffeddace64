"""Write-ahead operation log for the incremental indexer (DESIGN.md §18).

Durability model (§18.1): every mutating operation on a WAL-attached
:class:`~repro_torch.index.incremental.IncrementalIndexer` — ``add`` /
``delete`` / ``commit`` / ``compact`` — appends one CRC-framed, fsync'd
record *before* the live indexer mutates.  Records carry pre-lemmatized
payloads and are monotonically sequence-numbered; snapshots append
``checkpoint`` records that anchor replay (§18.2) and let the shared
``retain_latest`` primitive truncate replayed prefixes.  The on-disk
layout is numbered segment directories under ``<lineage>/wal/``::

    wal/
      wal_0/records.bin  manifest.json   # sealed at checkpoint time
      wal_1/records.bin                  # active tail (no manifest yet)

A sealed segment gets a fsync'd ``manifest.json`` (first/last sequence
number, sealing snapshot id), which is exactly the completeness marker
``retain_latest`` / ``latest_numbered`` key on (DESIGN.md §12.4) — the
active tail is invisible to retention and can never be collected.

Frame format (§18.1)::

    magic u16 | seq u64 | type u8 | payload_len u32 | crc u32 | payload

All little-endian; ``crc`` is ``zlib.crc32`` over ``seq | type | payload``.
A torn tail (crash mid-append) or a bitflipped record fails the magic /
length / CRC / monotonic-seq checks and the reader truncates the file at
the last valid frame — replay then reproduces exactly the prefix of
operations whose ``append`` returned (i.e. everything that could have
been acknowledged).

Exactness contract: restoring the latest snapshot and replaying the WAL
tail after its checkpoint record yields an indexer ``index_sets_equal``
to the uncrashed live indexer — *including commits after the snapshot*
(the §18.2 zero-data-loss invariant the chaos harness pins).  Replay of a
``commit`` record re-applies the logged resolved FL, so single-shard
recovery reproduces a corpus-level FL reduce without the other shards.

Fault points (§14 ABI): ``wal.append`` fires before a frame is written
(``crash``/``kill`` abort the append — the operation is lost but was
never acknowledged); ``wal.torn_tail`` fires between serialization and
the durable write — when it raises, a *partial* frame is flushed to disk
first, producing a real torn tail for the reader to truncate.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import TYPE_CHECKING, Iterable, Sequence

from ..checkpoint import append_durable, fsync_json, latest_numbered, retain_latest

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, typing only
    from .incremental import IncrementalIndexer

_MAGIC = 0xA11E
_HEADER = struct.Struct("<HQBI I")  # magic, seq, type, payload_len, crc
WAL_PREFIX = "wal"
_RECORDS = "records.bin"
_MANIFEST = "manifest.json"

# record types (§18.1): the complete set of mutating indexer operations
# plus the checkpoint anchor snapshots append
RT_ADD = 1
RT_DELETE = 2
RT_COMMIT = 3
RT_COMPACT = 4
RT_CHECKPOINT = 5
RT_BULK_BUILD = 6

_TYPE_NAMES = {
    RT_ADD: "add",
    RT_DELETE: "delete",
    RT_COMMIT: "commit",
    RT_COMPACT: "compact",
    RT_CHECKPOINT: "checkpoint",
    RT_BULK_BUILD: "bulk_build",
}
_TYPE_IDS = {v: k for k, v in _TYPE_NAMES.items()}


class WalError(RuntimeError):
    """Unrecoverable WAL protocol violation (§18) — corruption is NOT one
    (torn/bitflipped tails are truncated, not raised); this fires only on
    misuse, e.g. replaying against a state the log does not anchor."""


@dataclass(frozen=True)
class WalRecord:
    """One decoded §18.1 frame: ``rtype`` is the symbolic record type
    (``add``/``delete``/``commit``/``compact``/``checkpoint``/``bulk_build``)
    and ``payload`` the JSON-decoded operation body — byte-exact round-trip
    of what :meth:`WriteAheadLog.append` logged (identical after any number
    of reopen cycles)."""

    seq: int
    rtype: str
    payload: dict


def encode_frame(seq: int, rtype: str, payload: dict) -> bytes:
    """Serialize one §18.1 frame (exact inverse of the reader: decoding the
    returned bytes yields an identical :class:`WalRecord`)."""
    body = json.dumps(payload, sort_keys=True).encode("utf-8")
    tid = _TYPE_IDS[rtype]
    crc = zlib.crc32(struct.pack("<QB", seq, tid) + body) & 0xFFFFFFFF
    return _HEADER.pack(_MAGIC, seq, tid, len(body), crc) + body


def read_frames(path: str | Path, truncate: bool = True) -> list[WalRecord]:
    """Scan ``records.bin`` and return every valid frame in order (§18.1
    torn-tail rule).  Scanning stops at the first invalid frame — bad
    magic, short header, truncated payload, CRC mismatch or non-monotonic
    sequence number — and with ``truncate`` the file is physically cut
    back to the last valid frame so subsequent appends extend a clean
    tail.  The returned records are exactly the acknowledged prefix."""
    path = Path(path)
    if not path.exists():
        return []
    data = path.read_bytes()
    records: list[WalRecord] = []
    off = 0
    last_seq = -1
    valid_end = 0
    while off + _HEADER.size <= len(data):
        magic, seq, tid, plen, crc = _HEADER.unpack_from(data, off)
        body_end = off + _HEADER.size + plen
        if magic != _MAGIC or tid not in _TYPE_NAMES or body_end > len(data):
            break
        body = data[off + _HEADER.size : body_end]
        if zlib.crc32(struct.pack("<QB", seq, tid) + body) & 0xFFFFFFFF != crc:
            break
        if seq <= last_seq:
            break
        try:
            payload = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            break
        records.append(WalRecord(seq=seq, rtype=_TYPE_NAMES[tid], payload=payload))
        last_seq = seq
        off = valid_end = body_end
    if truncate and valid_end < len(data):
        with open(path, "r+b") as f:
            f.truncate(valid_end)
            f.flush()
            os.fsync(f.fileno())
    return records


class WriteAheadLog:
    """CRC-framed, fsync'd operation log over one snapshot lineage
    (DESIGN.md §18.1-§18.2).

    Exactness: ``records()`` after any crash returns exactly the prefix of
    operations whose :meth:`append` returned (durable-before-acknowledge),
    and :func:`replay` of that prefix onto the anchoring snapshot is
    ``index_sets_equal`` to the uncrashed indexer.

    ``injector`` is the §14 fault hook (points ``wal.append`` and
    ``wal.torn_tail``); ``shard`` keys its per-shard arrival counters.
    """

    def __init__(self, directory: str | Path, injector=None, shard=None):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.injector = injector
        self.shard = shard
        self._segment = self._open_tail()
        tail = read_frames(self._segment / _RECORDS)
        self._next_seq = (tail[-1].seq + 1) if tail else self._sealed_next_seq()

    # -- segments -----------------------------------------------------------

    def _segments(self) -> list[tuple[int, Path]]:
        out = []
        for p in self.directory.glob(f"{WAL_PREFIX}_*"):
            if not p.is_dir():
                continue
            try:
                out.append((int(p.name.rsplit("_", 1)[1]), p))
            except ValueError:
                continue
        return sorted(out)

    def _open_tail(self) -> Path:
        segs = self._segments()
        # the active tail is the highest-numbered UNSEALED segment (no
        # manifest); if every segment is sealed, start a fresh one after it
        if segs and not (segs[-1][1] / _MANIFEST).exists():
            return segs[-1][1]
        n = (segs[-1][0] + 1) if segs else 0
        seg = self.directory / f"{WAL_PREFIX}_{n}"
        seg.mkdir(parents=True, exist_ok=True)
        return seg

    def _sealed_next_seq(self) -> int:
        sealed = latest_numbered(self.directory, WAL_PREFIX)
        if sealed is None:
            return 0
        m = json.loads((self.directory / f"{WAL_PREFIX}_{sealed}" / _MANIFEST).read_text())
        return int(m["last_seq"]) + 1

    # -- append path --------------------------------------------------------

    def append(self, rtype: str, payload: dict) -> int:
        """Durably log one operation BEFORE it mutates the indexer (§18.1);
        returns the record's sequence number.  Crash semantics: if this
        raises, the operation was never acknowledged and recovery does not
        replay it; if it returns, the record survives any crash."""
        if self.injector is not None:
            # crash/kill here aborts the append before any byte is written:
            # the op is lost but was never acknowledged (no durability hole)
            self.injector.fire("wal.append", shard=self.shard)
        seq = self._next_seq
        frame = encode_frame(seq, rtype, payload)
        path = self._segment / _RECORDS
        if self.injector is not None:
            try:
                self.injector.fire("wal.torn_tail", shard=self.shard, path=path)
            except Exception:
                # simulate a crash mid-write: flush a PARTIAL frame so the
                # reader finds a real torn tail to truncate (§18.1)
                append_durable(path, frame[: max(1, len(frame) // 2)])
                raise
        append_durable(path, frame)
        self._next_seq = seq + 1
        return seq

    def checkpoint(self, snapshot_id: int, mutations: int, rtype: str = "checkpoint") -> int:
        """Anchor an about-to-publish snapshot in the log (§18.2): appends a
        ``checkpoint`` (or ``bulk_build``) record carrying the snapshot id
        and mutation counter, then seals the active segment with a fsync'd
        manifest.  Replay-after-restore starts strictly after this record.
        Call BEFORE publishing ``snap_<id>``: if the snapshot publish then
        crashes, restore falls back to the previous snapshot and the
        dangling checkpoint record replays as a no-op."""
        seq = self.append(rtype, {"snapshot_id": int(snapshot_id), "mutations": int(mutations)})
        self._seal(snapshot_id)
        return seq

    def _seal(self, snapshot_id: int) -> None:
        records = read_frames(self._segment / _RECORDS)
        fsync_json(
            self._segment / _MANIFEST,
            {
                "kind": "wal_segment",
                "first_seq": records[0].seq if records else self._next_seq,
                "last_seq": records[-1].seq if records else self._next_seq - 1,
                "sealed_by_snapshot": int(snapshot_id),
            },
        )
        self._segment = self._open_tail()

    def prune(self, keep: int = 2) -> None:
        """Truncate replayed prefixes (§18.2): drop all but the ``keep``
        newest *sealed* segments via the shared ``retain_latest`` primitive
        — the unsealed active tail has no manifest and is never collected.
        Mirrors snapshot retention: with ``keep`` matching the snapshot
        ``keep``, every retained snapshot keeps its replay tail."""
        retain_latest(self.directory, WAL_PREFIX, keep)

    # -- read / replay path -------------------------------------------------

    def records(self) -> list[WalRecord]:
        """All surviving records across sealed segments + the active tail,
        in sequence order, with torn/bitflipped tails truncated (§18.1)."""
        out: list[WalRecord] = []
        for _, seg in self._segments():
            out.extend(read_frames(seg / _RECORDS))
        return out

    def tail_after_snapshot(self, snapshot_id: int) -> list[WalRecord]:
        """The replay suffix for a restore of ``snap_<snapshot_id>`` (§18.2):
        every record strictly after that snapshot's checkpoint record.
        Returns ``[]`` when the snapshot is not anchored in the log (a WAL
        attached after the snapshot existed — nothing to replay is the safe
        answer: recovery degrades to the §12 snapshot-only RPO)."""
        records = self.records()
        anchor = None
        for i, rec in enumerate(records):
            if (
                rec.rtype in ("checkpoint", "bulk_build")
                and rec.payload.get("snapshot_id") == snapshot_id
            ):
                anchor = i
        if anchor is None:
            return []
        return records[anchor + 1 :]

    def close(self) -> None:
        """No-op for API symmetry: appends open/fsync/close per frame, so a
        crashed holder never pins a file handle recovery must steal."""


# ---------------------------------------------------------------------------
# replay (§18.2)
# ---------------------------------------------------------------------------


def fl_to_payload(fl) -> dict | None:
    """JSON form of an FL list for ``commit`` records (§18.1) — round-trips
    exactly (``fl_from_payload(fl_to_payload(fl))`` has identical lemmas,
    numbering, frequencies and class splits, hence equal
    ``fl_signature``), so single-shard replay reproduces the §18.2
    corpus-level FL reduce without the other shards."""
    if fl is None:
        return None
    return {
        "lemmas": fl.lemmas,
        "frequency": fl.frequency,
        "sw_count": fl.sw_count,
        "fu_count": fl.fu_count,
    }


def fl_from_payload(payload: dict | None):
    """Inverse of :func:`fl_to_payload` (§18.1; exact round-trip, see
    there)."""
    from ..core.lemma import FLList

    if payload is None:
        return None
    lemmas = list(payload["lemmas"])
    return FLList(
        lemmas=lemmas,
        fl_number={l: i for i, l in enumerate(lemmas)},
        frequency={l: int(n) for l, n in payload["frequency"].items()},
        sw_count=payload["sw_count"],
        fu_count=payload["fu_count"],
    )


def docs_to_payload(docs: Sequence) -> list[dict]:
    """Pre-lemmatized document payload for ``add`` records (§18.1) — the
    same ``{doc_id, text, lemmas}`` row shape as the §12.2 snapshot
    ``documents.jsonl``, so replay never re-lemmatizes (exact
    lemma-stream round-trip)."""
    return [
        {
            "doc_id": d.doc_id,
            "text": d.text,
            "lemmas": [list(position) for position in d.lemma_stream],
        }
        for d in docs
    ]


def docs_from_payload(rows: Iterable[dict]) -> list:
    """Inverse of :func:`docs_to_payload` (§18.1; exact round-trip, see
    there)."""
    from .corpus import Document

    return [
        Document(
            doc_id=int(r["doc_id"]),
            text=r["text"],
            lemma_stream=[tuple(p) for p in r["lemmas"]],
        )
        for r in rows
    ]


def replay(indexer: "IncrementalIndexer", records: Sequence[WalRecord]) -> int:
    """Re-apply a WAL suffix onto a restored indexer (§18.2); returns the
    number of mutating records applied.

    Exactness contract: for a suffix produced by
    :meth:`WriteAheadLog.tail_after_snapshot`, the replayed indexer is
    ``index_sets_equal`` to the uncrashed live indexer that executed the
    same operations — including post-snapshot commits — because every
    record carries its full pre-resolved inputs (pre-lemmatized documents,
    the resolved FL of each commit) and the segment builders are
    deterministic.  ``checkpoint``/``bulk_build`` anchors replay as no-ops.
    WAL appends are suppressed during replay (the records are already
    durable; re-logging them would double the tail)."""
    wal = getattr(indexer, "wal", None)
    indexer.wal = None  # suppress re-logging while replaying
    applied = 0
    try:
        for rec in records:
            if rec.rtype == "add":
                indexer.add_prelemmatized(docs_from_payload(rec.payload["docs"]))
            elif rec.rtype == "delete":
                indexer.delete_document(int(rec.payload["doc_id"]))
            elif rec.rtype == "commit":
                indexer.commit(fl=fl_from_payload(rec.payload["fl"]))
            elif rec.rtype == "compact":
                indexer.compact(memory_budget_bytes=rec.payload["memory_budget_bytes"])
            elif rec.rtype in ("checkpoint", "bulk_build"):
                continue
            else:  # pragma: no cover - reader only yields known types
                raise WalError(f"unknown WAL record type {rec.rtype!r}")
            applied += 1
    finally:
        indexer.wal = wal
    return applied
