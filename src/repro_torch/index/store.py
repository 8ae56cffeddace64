"""Durable on-disk segment store: snapshot/restore for the §3 indexes
(DESIGN.md §12; byte-level format in §12.1–§12.2).

The companion construction paper (arXiv 2006.07954) treats index
materialization and storage as first-class, and the response-time-guarantee
work (arXiv 2009.03679) assumes a server that *restarts against an existing
index* instead of re-lemmatizing the corpus.  This module is that layer:

* **Columnar codec** (§12.1) — each §3 posting family stores the rows of
  ALL its keys concatenated (keys in sorted order), column-wise: the doc
  column is delta-encoded with the chain *reset to an absolute value at
  every key boundary* (so any key's slice decodes independently), every
  column is zigzag-mapped and bit-packed to the narrowest of
  uint8/uint16/uint32 that fits the column.  NSW records store ragged-slice
  *lengths* (not int64 offsets) plus packed payload columns.  Encoding is
  one vectorized pass per column; per-key decode is offset arithmetic into
  the packed column.  The codec is lossless: decoded slices are
  byte-identical (dtype, shape, values) to the in-memory arrays — the
  differential harness gates this.

* **Segment stores** (§12.2) — one directory per immutable
  :class:`~repro_torch.index.incremental.Segment`: two blob files
  (``postings.bin``, ``nsw.bin``), a binary key table (``keys.npz``:
  per-key row extents), and a fsync'd ``manifest.json`` with the format
  version, per-column pack codes and offsets, doc ids, superseded set,
  CRC32s and the FL signature of the generation the segment was keyed
  under.

* **Snapshots** (§12.2) — ``save_snapshot`` freezes a whole
  ``IncrementalIndexer`` (segments + surviving documents + tombstones + FL
  state + generation token) into an atomically published ``snap_<N>``
  directory, reusing the checkpoint layer's write/retention primitives
  (``repro_torch.checkpoint``: tmp dir -> manifest fsync -> rename, keep-latest
  GC).  ``load_snapshot`` restores a fully functional indexer whose
  segments serve straight from ``mmap``-ed disk pages via
  :class:`StoredIndexSet` — postings decode on first touch and every engine
  works unchanged.

Exactness contract: a restored index is *indistinguishable* from the live
one it was snapshotted from — ``restore(snapshot(ix)).index.to_index_set()``
is ``index_sets_equal``-identical to ``ix.index.to_index_set()``, every
decoded posting slice is byte-identical to its in-memory original, and the
restored indexer keeps committing/deleting/compacting exactly
(``tests/test_torch_store.py``).  Generation
tokens resume across restarts under a bumped restore epoch, so a serving
cache can never confuse pre- and post-restart index states (§12.5).
"""

from __future__ import annotations

import json
import mmap
import os
import shutil
import zlib
from collections.abc import MutableMapping
from pathlib import Path
from typing import Sequence

import numpy as np

from ..checkpoint import fsync_json, latest_numbered, replace_dir, retain_latest
from ..core.lemma import FLList
from .builder import IndexSet, NSWRecords, POSTING_WIDTH, family_rows
from .corpus import Document

__all__ = [
    "FORMAT_VERSION",
    "StoreError",
    "StoredIndexSet",
    "family_rows",
    "fl_signature",
    "latest_snapshot",
    "load_snapshot",
    "open_segment_store",
    "save_snapshot",
    "write_segment_store",
]

FORMAT_VERSION = 1

SNAPSHOT_PREFIX = "snap"
_MANIFEST = "manifest.json"
_POSTINGS_BLOB = "postings.bin"
_NSW_BLOB = "nsw.bin"
_KEYS_FILE = "keys.npz"
_DOCUMENTS = "documents.jsonl"
_KEY_SEP = "\x1f"  # joins tuple-key components in the key table

# §3 posting families and their §4 row widths — the builder's canonical
# table, so a family added there cannot be silently missing from snapshots
FAMILY_WIDTH = POSTING_WIDTH
_FAMILIES = tuple(FAMILY_WIDTH)


def _savez_deterministic(buf, arrays: dict) -> None:
    """``np.savez`` with pinned zip metadata: fixed DOS timestamp, fixed
    permissions, no compression.  Equal arrays -> equal bytes, which is the
    property the §17.4 determinism contract (bulk-ingest runs with different
    worker counts produce byte-identical snapshots) rests on — stock
    ``np.savez`` stamps each member with the wall clock."""
    import io
    import zipfile

    from numpy.lib import format as npformat

    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        for name, arr in arrays.items():
            member = io.BytesIO()
            npformat.write_array(member, np.asanyarray(arr), allow_pickle=False)
            info = zipfile.ZipInfo(name + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.external_attr = 0o600 << 16
            zf.writestr(info, member.getvalue())


def _write_durable(path: Path, data: bytes) -> None:
    """Write + flush + fsync one data file (§12.4): every payload file is
    durable BEFORE the manifest fsync that publishes it, so a
    manifest-complete snapshot never points at torn data pages."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


class StoreError(RuntimeError):
    """A snapshot/segment store is unreadable (DESIGN.md §12.2): missing or
    malformed manifest, format-version mismatch, truncated blob, CRC or FL
    signature mismatch.  Restores fail loudly instead of serving a corrupt
    index — exactness is the §12 contract."""


# ---------------------------------------------------------------------------
# §12.1 columnar codec: boundary-reset delta + zigzag + byte-width packing
# ---------------------------------------------------------------------------

_PACK_DTYPES = (np.uint8, np.uint16, np.uint32)
_PACK_MAX = (0xFF, 0xFFFF, 0xFFFFFFFF)


def _zigzag(v: np.ndarray) -> np.ndarray:
    # int64 -> non-negative int64: 0,-1,1,-2,... -> 0,1,2,3,...
    return (v << 1) ^ (v >> 63)


def _unzigzag(u: np.ndarray) -> np.ndarray:
    return (u >> 1) ^ -(u & 1)


def _pack(values: np.ndarray) -> tuple[int, bytes]:
    """Narrowest-uint packing of non-negative int64 values."""
    m = int(values.max()) if len(values) else 0
    for code, top in enumerate(_PACK_MAX):
        if m <= top:
            return code, values.astype(_PACK_DTYPES[code]).tobytes()
    raise StoreError(f"packed value {m} exceeds uint32 range")


def _encode_family(
    arrays: Sequence[np.ndarray], starts: np.ndarray, width: int
) -> tuple[list[bytes], list[int], list[int]]:
    """Encode one family's concatenated rows column-wise (§12.1): returns
    (per-column packed bytes, per-column pack codes, per-column byte sizes).
    ``starts`` are the key-boundary row indices where the doc-delta chain
    resets to the absolute doc id."""
    concat = (
        np.concatenate(arrays).astype(np.int64)
        if arrays
        else np.empty((0, width), dtype=np.int64)
    )
    blobs: list[bytes] = []
    codes: list[int] = []
    sizes: list[int] = []
    n = len(concat)
    boundary = starts[starts < n] if n else starts[:0]
    for c in range(width):
        col = concat[:, c]
        if c == 0 and n:
            dv = np.diff(col, prepend=np.int64(0))
            dv[boundary] = col[boundary]  # absolute at each key's first row
            col = dv
        code, raw = _pack(_zigzag(col))
        blobs.append(raw)
        codes.append(code)
        sizes.append(len(raw))
    return blobs, codes, sizes


def _decode_rows(
    blob, codes: Sequence[int], offsets: Sequence[int], start: int, n: int, width: int
) -> np.ndarray:
    """Decode one key's ``(n, width)`` int32 row slice from globally packed
    columns (§12.1) — byte-identical to the array that was encoded."""
    if n == 0:
        return np.empty((0, width), dtype=np.int32)
    cols = []
    for c in range(width):
        dt = _PACK_DTYPES[codes[c]]
        try:
            raw = np.frombuffer(
                blob, dtype=dt, count=n, offset=offsets[c] + start * np.dtype(dt).itemsize
            )
        except ValueError as e:
            raise StoreError(f"truncated posting column: {e}") from e
        vals = _unzigzag(raw.astype(np.int64))
        if c == 0:
            vals = np.cumsum(vals)  # slice starts with its absolute doc id
        cols.append(vals.astype(np.int32))
    return np.stack(cols, axis=1)


def _decode_scalar_col(blob, code: int, offset: int, start: int, n: int) -> np.ndarray:
    dt = _PACK_DTYPES[code]
    try:
        raw = np.frombuffer(
            blob, dtype=dt, count=n, offset=offset + start * np.dtype(dt).itemsize
        )
    except ValueError as e:
        raise StoreError(f"truncated NSW column: {e}") from e
    return _unzigzag(raw.astype(np.int64))


def fl_signature(fl: FLList | None) -> int:
    """CRC32 signature of an FL generation (DESIGN.md §12.2): the lemma
    *order* plus the stop/FU thresholds — exactly the FL state §3 row
    generation depends on (§10.2).  Segment manifests embed the signature
    they were keyed under; a snapshot whose segments disagree with its FL
    state is rejected at restore instead of serving mis-keyed postings."""
    if fl is None:
        return 0
    payload = json.dumps([fl.lemmas, fl.sw_count, fl.fu_count]).encode()
    return zlib.crc32(payload)


# ---------------------------------------------------------------------------
# §12.3 lazy mmap-backed views: decode on first touch
# ---------------------------------------------------------------------------


class _LazyPostings(MutableMapping):
    """One posting family served straight from its packed columns: a key's
    array is decoded on first access and cached (DESIGN.md §12.3).  Even the
    key table itself materializes lazily (first family access), so restore
    does no per-key work at all.  Mutable so in-place overrides
    (e.g. the §10.2 NSW remap pattern) stay possible."""

    __slots__ = ("_blob", "_codes", "_offsets", "_raw", "_fname", "_entries",
                 "_width", "_cache")  # key table builds on first family access

    def __init__(self, blob, codes, offsets, raw_table, fname: str, width: int):
        self._blob = blob
        self._codes = codes
        self._offsets = offsets
        self._raw = raw_table  # (keys, starts, rows) arrays, or None
        self._fname = fname
        self._entries: dict | None = None  # key -> (row_start, n_rows)
        self._width = width
        self._cache: dict = {}

    def _table(self) -> dict:
        if self._entries is None:
            keys, starts, rows = self._raw
            self._entries = {
                _key_from_table(self._fname, k): (s, r)
                for k, s, r in zip(keys.tolist(), starts.tolist(), rows.tolist())
            }
            self._raw = None
        return self._entries

    def __getitem__(self, key):
        try:
            return self._cache[key]
        except KeyError:
            pass
        start, n = self._table()[key]
        arr = _decode_rows(self._blob, self._codes, self._offsets, start, n, self._width)
        self._cache[key] = arr
        return arr

    def __setitem__(self, key, value):
        self._cache[key] = value
        if key not in self._table():
            self._table()[key] = (0, 0)  # placeholder: cache always wins

    def __delitem__(self, key):
        found = key in self._table() or key in self._cache
        self._table().pop(key, None)
        self._cache.pop(key, None)
        if not found:
            raise KeyError(key)

    def __iter__(self):
        return iter(self._table())

    def __len__(self):
        return len(self._table())

    def __contains__(self, key):
        return key in self._table()


class _LazyNSW(MutableMapping):
    """NSW records served from ``nsw.bin``, decoded on first touch
    (DESIGN.md §12.3); mutable for the §10.2 stop-id bulk remap."""

    __slots__ = ("_blob", "_codes", "_offsets", "_raw", "_entries", "_cache")

    def __init__(self, blob, codes, offsets, raw_table):
        self._blob = blob
        self._codes = codes  # (counts, stop_lemma, distance) pack codes
        self._offsets = offsets  # matching byte offsets into the blob
        self._raw = raw_table  # (lemmas, post_start, n_post, pay_start, total)
        self._entries: dict | None = None
        self._cache: dict = {}

    def _table(self) -> dict:
        if self._entries is None:
            lemmas, post_starts, n_posts, pay_starts, totals = self._raw
            self._entries = {
                l: (ps, np_, ys, t)
                for l, ps, np_, ys, t in zip(
                    lemmas.tolist(), post_starts.tolist(), n_posts.tolist(),
                    pay_starts.tolist(), totals.tolist(),
                )
            }
            self._raw = None
        return self._entries

    def __getitem__(self, lemma):
        try:
            return self._cache[lemma]
        except KeyError:
            pass
        post_start, n_post, pay_start, total = self._table()[lemma]
        counts = _decode_scalar_col(
            self._blob, self._codes[0], self._offsets[0], post_start, n_post
        )
        offsets = np.zeros(n_post + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        rec = NSWRecords(
            offsets=offsets,
            stop_lemma=_decode_scalar_col(
                self._blob, self._codes[1], self._offsets[1], pay_start, total
            ).astype(np.int32),
            distance=_decode_scalar_col(
                self._blob, self._codes[2], self._offsets[2], pay_start, total
            ).astype(np.int32),
        )
        self._cache[lemma] = rec
        return rec

    def __setitem__(self, lemma, rec):
        self._cache[lemma] = rec
        if lemma not in self._table():
            self._table()[lemma] = (0, 0, 0, 0)

    def __delitem__(self, lemma):
        found = lemma in self._table() or lemma in self._cache
        self._table().pop(lemma, None)
        self._cache.pop(lemma, None)
        if not found:
            raise KeyError(lemma)

    def __iter__(self):
        return iter(self._table())

    def __len__(self):
        return len(self._table())

    def __contains__(self, lemma):
        return lemma in self._table()


class StoredIndexSet(IndexSet):
    """A complete §3 ``IndexSet`` served from an on-disk segment store
    (DESIGN.md §12.3): posting dicts are lazy ``mmap``-backed mappings that
    decode on first touch, so a restored index pays NO decode cost at boot
    (with the default ``verify=True`` the boot does one sequential CRC read
    of the blobs — still no decode, no dict builds) and decodes only the
    keys queries actually hit.

    Exactness: every decoded slice is byte-identical to the in-memory array
    it was encoded from, so ``SegmentedIndexSet`` merges, all engines, FL
    drift re-keying and compaction work over stored segments unchanged —
    the differential harness pins restored == live fragment sets.
    """

    def __init__(
        self,
        fl: FLList,
        max_distance: int,
        n_docs: int,
        ordinary: _LazyPostings,
        nsw: _LazyNSW,
        pair: _LazyPostings,
        triple: _LazyPostings,
        stop_single: _LazyPostings,
        stop_pair: _LazyPostings,
        totals: dict | None = None,
    ):
        # manifest row totals: {family: n_rows, "nsw": (n_lemmas, n_counts,
        # n_payload)} — lets size_bytes() answer without touching the tables
        self._totals = totals or {}
        IndexSet.__init__(
            self,
            fl=fl,
            max_distance=max_distance,
            ordinary=ordinary,
            nsw=nsw,
            pair=pair,
            triple=triple,
            stop_single=stop_single,
            stop_pair=stop_pair,
            n_docs=n_docs,
        )

    def size_bytes(self) -> dict[str, int]:
        """In-memory footprint *as if decoded*, computed from the key-table
        row counts without touching a single blob page — identical numbers
        to ``IndexSet.size_bytes()`` on the materialized arrays (int32
        rows, int64 NSW offsets), so §10 compaction budgeting and the §12
        compression-ratio bench see the same denominators either way."""
        out = {}
        for fname, width in FAMILY_WIDTH.items():
            out[fname] = self._totals.get(fname, 0) * width * 4
        n_lemmas, n_counts, n_payload = self._totals.get("nsw", (0, 0, 0))
        nsw = (n_counts + n_lemmas) * 8 + n_payload * 4 + n_payload * 4
        return {
            "ordinary": out["ordinary"],
            "nsw": nsw,
            "pair": out["pair"],
            "triple": out["triple"],
            "stop_degenerate": out["stop_single"] + out["stop_pair"],
            "total": out["ordinary"] + nsw + out["pair"] + out["triple"]
            + out["stop_single"] + out["stop_pair"],
        }


# ---------------------------------------------------------------------------
# §12.2 segment stores
# ---------------------------------------------------------------------------


def _key_to_table(key) -> str:
    return key if isinstance(key, str) else _KEY_SEP.join(key)


def _key_from_table(fname: str, key: str):
    return key if fname == "ordinary" else tuple(key.split(_KEY_SEP))


def write_segment_store(
    index: IndexSet,
    path: str | Path,
    fl_crc: int,
    doc_ids: Sequence[int] = (),
    superseded: Sequence[int] = (),
) -> None:
    """Serialize one immutable segment ``IndexSet`` into ``path`` (DESIGN.md
    §12.2): ``postings.bin`` + ``nsw.bin`` packed column blobs (§12.1 codec,
    keys in sorted order for determinism), a binary ``keys.npz`` row-extent
    table, and a fsync'd manifest with pack codes, column offsets, CRC32s
    and the FL signature the rows were keyed under.  Works over plain and
    :class:`StoredIndexSet` segments alike (re-snapshotting a restored
    index decodes lazily and re-encodes identically)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    blob = bytearray()
    families_meta: dict[str, dict] = {}
    key_table: dict[str, np.ndarray] = {}
    for fname in _FAMILIES:
        width = FAMILY_WIDTH[fname]
        keys, arrays, rows, starts = family_rows(getattr(index, fname), width)
        col_blobs, codes, sizes = _encode_family(arrays, starts, width)
        offsets = []
        for raw in col_blobs:
            offsets.append(len(blob))
            blob += raw
        families_meta[fname] = {
            "n_rows": int(rows.sum()) if len(rows) else 0,
            "codes": codes,
            "offsets": offsets,
            "sizes": sizes,
        }
        key_table[f"{fname}_keys"] = np.asarray(
            [_key_to_table(k) for k in keys], dtype=str
        )
        key_table[f"{fname}_start"] = starts
        key_table[f"{fname}_rows"] = rows

    nsw_blob = bytearray()
    lemmas = sorted(index.nsw.keys())
    recs = [index.nsw[l] for l in lemmas]
    counts_cols = [np.diff(r.offsets.astype(np.int64)) for r in recs]
    n_posts = np.asarray([len(c) for c in counts_cols], dtype=np.int64)
    totals = np.asarray([len(r.stop_lemma) for r in recs], dtype=np.int64)
    post_starts = np.zeros(len(lemmas), dtype=np.int64)
    pay_starts = np.zeros(len(lemmas), dtype=np.int64)
    if len(lemmas):
        np.cumsum(n_posts[:-1], out=post_starts[1:])
        np.cumsum(totals[:-1], out=pay_starts[1:])
    nsw_meta = {"codes": [], "offsets": [], "sizes": [],
                "n_counts": int(n_posts.sum()) if len(lemmas) else 0,
                "n_payload": int(totals.sum()) if len(lemmas) else 0}
    for col in (
        np.concatenate(counts_cols) if counts_cols else np.empty(0, np.int64),
        np.concatenate([r.stop_lemma for r in recs]).astype(np.int64)
        if recs else np.empty(0, np.int64),
        np.concatenate([r.distance for r in recs]).astype(np.int64)
        if recs else np.empty(0, np.int64),
    ):
        code, raw = _pack(_zigzag(col))
        nsw_meta["codes"].append(code)
        nsw_meta["offsets"].append(len(nsw_blob))
        nsw_meta["sizes"].append(len(raw))
        nsw_blob += raw
    key_table["nsw_lemmas"] = np.asarray(lemmas, dtype=str)
    key_table["nsw_post_start"] = post_starts
    key_table["nsw_n_post"] = n_posts
    key_table["nsw_pay_start"] = pay_starts
    key_table["nsw_total"] = totals

    import io

    _write_durable(path / _POSTINGS_BLOB, bytes(blob))
    _write_durable(path / _NSW_BLOB, bytes(nsw_blob))
    keys_buf = io.BytesIO()
    _savez_deterministic(keys_buf, key_table)
    keys_bytes = keys_buf.getvalue()
    _write_durable(path / _KEYS_FILE, keys_bytes)
    manifest = {
        "format_version": FORMAT_VERSION,
        "kind": "segment",
        "n_docs": int(index.n_docs),
        "doc_ids": [int(d) for d in sorted(doc_ids)],
        "superseded": [int(d) for d in sorted(superseded)],
        "max_distance": int(index.max_distance),
        "fl_crc32": int(fl_crc),
        "families": families_meta,
        "nsw": nsw_meta,
        "postings": {"bytes": len(blob), "crc32": zlib.crc32(bytes(blob))},
        "nsw_blob": {"bytes": len(nsw_blob), "crc32": zlib.crc32(bytes(nsw_blob))},
        "keys_file": {"bytes": len(keys_bytes), "crc32": zlib.crc32(keys_bytes)},
    }
    fsync_json(path / _MANIFEST, manifest)


def _load_manifest(path: Path, expect_kind: str) -> dict:
    try:
        with open(path) as f:
            m = json.load(f)
    except FileNotFoundError as e:
        raise StoreError(f"missing manifest {path}") from e
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise StoreError(f"corrupt manifest {path}: {e}") from e
    if not isinstance(m, dict) or m.get("kind") != expect_kind:
        raise StoreError(f"{path} is not a {expect_kind} manifest")
    if m.get("format_version") != FORMAT_VERSION:
        raise StoreError(
            f"{path}: format version {m.get('format_version')} "
            f"not supported (this build reads {FORMAT_VERSION})"
        )
    return m


def _open_blob(path: Path, declared: dict, use_mmap: bool, verify: bool):
    try:
        size = os.path.getsize(path)
    except OSError as e:
        raise StoreError(f"missing blob {path}") from e
    if size != declared["bytes"]:
        raise StoreError(
            f"truncated blob {path}: {size} bytes on disk, "
            f"manifest says {declared['bytes']}"
        )
    if size == 0:
        return b""
    if use_mmap:
        with open(path, "rb") as f:
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    else:
        buf = path.read_bytes()
    if verify and zlib.crc32(buf) != declared["crc32"]:
        raise StoreError(f"CRC mismatch in {path}")
    return buf


def open_segment_store(
    path: str | Path,
    fl: FLList,
    use_mmap: bool = True,
    verify: bool = True,
    expect_fl_crc: int | None = None,
) -> tuple[StoredIndexSet, frozenset, set]:
    """Open one §12.2 segment directory as a lazy :class:`StoredIndexSet`
    plus its ``(doc_ids, superseded)`` liveness sets.  ``verify`` checks the
    blob and key-table CRC32s up front (one sequential read; decode stays
    lazy either way); truncation, version and FL-signature mismatches
    always raise :class:`StoreError` — a restored segment is exact or
    refused."""
    path = Path(path)
    m = _load_manifest(path / _MANIFEST, expect_kind="segment")
    if expect_fl_crc is not None and m["fl_crc32"] != expect_fl_crc:
        raise StoreError(
            f"{path}: segment keyed under FL signature {m['fl_crc32']}, "
            f"snapshot expects {expect_fl_crc}"
        )
    postings = _open_blob(path / _POSTINGS_BLOB, m["postings"], use_mmap, verify)
    nsw_blob = _open_blob(path / _NSW_BLOB, m["nsw_blob"], use_mmap, verify)
    keys_path = path / _KEYS_FILE
    try:
        keys_bytes = keys_path.read_bytes()  # one read: CRC + parse
    except OSError as e:
        raise StoreError(f"missing key table {keys_path}") from e
    if len(keys_bytes) != m["keys_file"]["bytes"]:
        raise StoreError(f"truncated key table {keys_path}")
    if verify and zlib.crc32(keys_bytes) != m["keys_file"]["crc32"]:
        raise StoreError(f"CRC mismatch in {keys_path}")
    try:
        import io

        with np.load(io.BytesIO(keys_bytes)) as kt:
            table = {name: kt[name] for name in kt.files}
    except Exception as e:  # zipfile/format errors on corrupt npz
        raise StoreError(f"corrupt key table {keys_path}: {e}") from e

    lazy: dict[str, _LazyPostings] = {}
    totals: dict = {}
    for fname in _FAMILIES:
        fm = m["families"][fname]
        if fm["sizes"] and fm["offsets"][-1] + fm["sizes"][-1] > m["postings"]["bytes"]:
            raise StoreError(f"{path}: {fname} columns overrun postings.bin")
        raw = (table[f"{fname}_keys"], table[f"{fname}_start"], table[f"{fname}_rows"])
        lazy[fname] = _LazyPostings(
            postings, fm["codes"], fm["offsets"], raw, fname, FAMILY_WIDTH[fname]
        )
        totals[fname] = fm["n_rows"]
    nm = m["nsw"]
    if nm["sizes"] and nm["offsets"][-1] + nm["sizes"][-1] > m["nsw_blob"]["bytes"]:
        raise StoreError(f"{path}: NSW columns overrun nsw.bin")
    nsw_raw = (
        table["nsw_lemmas"],
        table["nsw_post_start"],
        table["nsw_n_post"],
        table["nsw_pay_start"],
        table["nsw_total"],
    )
    totals["nsw"] = (len(table["nsw_lemmas"]), nm["n_counts"], nm["n_payload"])
    stored = StoredIndexSet(
        fl=fl,
        max_distance=m["max_distance"],
        n_docs=m["n_docs"],
        ordinary=lazy["ordinary"],
        nsw=_LazyNSW(nsw_blob, nm["codes"], nm["offsets"], nsw_raw),
        pair=lazy["pair"],
        triple=lazy["triple"],
        stop_single=lazy["stop_single"],
        stop_pair=lazy["stop_pair"],
        totals=totals,
    )
    return stored, frozenset(m["doc_ids"]), set(m["superseded"])


# ---------------------------------------------------------------------------
# §12.2 whole-indexer snapshots
# ---------------------------------------------------------------------------


def _claim_restore_epoch(directory: Path, stored_epoch: int) -> int:
    """Hand out a restore epoch no other boot of this snapshot lineage has
    used (§12.5).  Claiming is race-free across concurrent restores: each
    boot creates an empty ``restore_epoch.<E>`` claim file with
    ``O_CREAT|O_EXCL`` (atomic claim-or-exists on POSIX), starting above
    both the snapshot's stored epoch and every existing claim, and walking
    E upward past collisions.  Claim files are tiny, one per boot, and
    never pruned — they ARE the lineage's boot history, so two sibling
    restores of the SAME snapshot always get distinct epochs and can never
    mint the same token for different post-restore states.  Best-effort on
    read-only media: if nothing can be written the epoch still advances
    past the stored epoch and existing claims for THIS boot, but
    cross-boot uniqueness then needs a writable lineage directory
    (documented §12.5 restriction)."""
    claimed = [0]
    try:
        for p in directory.glob("restore_epoch.*"):
            suffix = p.name.rsplit(".", 1)[1]
            if suffix.isdigit():
                claimed.append(int(suffix))
    except OSError:
        pass
    epoch = max(max(claimed), stored_epoch) + 1
    while True:
        try:
            fd = os.open(
                directory / f"restore_epoch.{epoch}",
                os.O_CREAT | os.O_EXCL | os.O_WRONLY,
            )
            os.close(fd)
            return epoch
        except FileExistsError:
            epoch += 1  # lost the race for this epoch: claim the next
        except OSError:
            return epoch  # read-only lineage dir: best effort (docstring)


def latest_snapshot(directory: str | Path) -> int | None:
    """Highest durable ``snap_<N>`` id in ``directory`` (``None`` if none) —
    durable means its manifest exists, i.e. the §12.4 atomic rename
    happened; half-written ``.tmp`` dirs are never visible."""
    return latest_numbered(directory, SNAPSHOT_PREFIX)


def save_snapshot(indexer, directory: str | Path, keep: int = 2) -> Path:
    """Freeze an ``IncrementalIndexer`` into ``<directory>/snap_<N>``
    (DESIGN.md §12.2): every segment as a §12.2 segment store, surviving +
    buffered documents as pre-lemmatized JSONL (restarts never re-lemmatize
    — the arXiv 2006.07954 concern), tombstones, FL state and the §12.5
    generation token.  The write is atomic (tmp dir -> manifest fsync ->
    rename, via ``repro_torch.checkpoint``) and the ``keep`` newest snapshots are
    retained.  Returns the published snapshot path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    latest = latest_snapshot(directory)
    n = 0 if latest is None else latest + 1
    tmp = directory / f"{SNAPSHOT_PREFIX}_{n}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    fl = indexer.fl
    fl_crc = fl_signature(fl)
    seg_names = []
    for i, seg in enumerate(indexer.segments):
        name = f"seg_{i:03d}"
        write_segment_store(
            seg.index,
            tmp / name,
            fl_crc=fl_crc,
            doc_ids=sorted(seg.doc_ids),
            superseded=sorted(seg.superseded),
        )
        seg_names.append(name)

    with open(tmp / _DOCUMENTS, "w") as f:
        for doc_id in sorted(indexer.documents):
            doc = indexer.documents[doc_id]
            f.write(json.dumps({
                "doc_id": doc_id,
                "text": doc.text,
                "lemmas": [list(t) for t in doc.lemma_stream],
            }) + "\n")
        for doc_id in sorted(indexer._buffer):
            doc = indexer._buffer[doc_id]
            f.write(json.dumps({
                "doc_id": doc_id,
                "text": doc.text,
                "lemmas": [list(t) for t in doc.lemma_stream],
                "buffered": True,
            }) + "\n")
        f.flush()
        os.fsync(f.fileno())  # durable before the manifest publishes it

    manifest = {
        "format_version": FORMAT_VERSION,
        "kind": "snapshot",
        "sw_count": indexer.sw_count,
        "fu_count": indexer.fu_count,
        "max_distance": indexer.max_distance,
        "build_pair": indexer.build_pair,
        "build_degenerate": indexer.build_degenerate,
        "fl": None if fl is None else {
            "lemmas": fl.lemmas,
            "frequency": fl.frequency,
            "sw_count": fl.sw_count,
            "fu_count": fl.fu_count,
        },
        "fl_crc32": fl_crc,
        "tombstones": sorted(indexer.tombstones),
        "generation": indexer.generation,
        "mutations": indexer._mutations,
        "epoch": indexer._restore_epoch,
        "next_id": indexer._next_id,
        "segments": seg_names,
        "n_documents": len(indexer.documents),
        "n_buffered": len(indexer._buffer),
    }
    fsync_json(tmp / _MANIFEST, manifest)
    final = directory / f"{SNAPSHOT_PREFIX}_{n}"
    replace_dir(tmp, final)
    retain_latest(directory, SNAPSHOT_PREFIX, keep)
    return final


def load_snapshot(
    directory: str | Path,
    snapshot_id: int | None = None,
    use_mmap: bool = True,
    verify: bool = True,
    lemmatizer=None,
    injector=None,
):
    """Restore an ``IncrementalIndexer`` from a §12.2 snapshot — warm start:
    no re-lemmatization, no index rebuild, no replay; segments serve lazily
    from ``mmap`` pages (:class:`StoredIndexSet`).  The restored indexer is
    exact (``index_sets_equal`` vs the snapshotted live view) and fully
    mutable: commits, FL-drift re-keying, deletes and compaction continue
    from the stored generation.  Its generation token resumes under a
    bumped restore epoch (§12.5), so cached results keyed by pre-restart
    tokens can never be served against post-restart states.  Raises
    :class:`StoreError` on any corruption (see ``open_segment_store``).

    ``injector`` is the §14 (DESIGN.md) fault-injection hook: a scheduled
    ``bitflip`` event physically corrupts a blob of THIS snapshot on disk
    before it is read, so the CRC verify below rejects it for real and
    recovery walks back to an older snapshot — the detection path under
    test is the production one, not a mock."""
    from .incremental import IncrementalIndexer, Segment

    directory = Path(directory)
    sid = snapshot_id if snapshot_id is not None else latest_snapshot(directory)
    if sid is None:
        raise StoreError(f"no snapshot found in {directory}")
    path = directory / f"{SNAPSHOT_PREFIX}_{sid}"
    if injector is not None:
        injector.fire("store.load_snapshot", path=path)
    m = _load_manifest(path / _MANIFEST, expect_kind="snapshot")

    fl = None
    if m["fl"] is not None:
        mf = m["fl"]
        fl = FLList(
            lemmas=list(mf["lemmas"]),
            fl_number={l: i for i, l in enumerate(mf["lemmas"])},
            frequency={l: int(n) for l, n in mf["frequency"].items()},
            sw_count=mf["sw_count"],
            fu_count=mf["fu_count"],
        )
    if fl_signature(fl) != m["fl_crc32"]:
        raise StoreError(f"{path}: FL state does not match its recorded signature")

    ix = IncrementalIndexer(
        sw_count=m["sw_count"],
        fu_count=m["fu_count"],
        max_distance=m["max_distance"],
        lemmatizer=lemmatizer,
        build_pair=m["build_pair"],
        build_degenerate=m["build_degenerate"],
    )
    ix.fl = fl
    try:
        with open(path / _DOCUMENTS) as f:
            for line in f:
                rec = json.loads(line)
                doc = Document(
                    doc_id=rec["doc_id"],
                    text=rec["text"],
                    lemma_stream=[tuple(t) for t in rec["lemmas"]],
                )
                if rec.get("buffered"):
                    ix._buffer[doc.doc_id] = doc
                else:
                    ix.documents[doc.doc_id] = doc
                ix._doc_lemmas[doc.doc_id] = frozenset(
                    l for t in doc.lemma_stream for l in t
                )
                ix._freq.update(l for t in doc.lemma_stream for l in t)
    except FileNotFoundError as e:
        raise StoreError(f"missing document store {path / _DOCUMENTS}") from e
    except (json.JSONDecodeError, KeyError) as e:
        raise StoreError(f"corrupt document store in {path}: {e}") from e
    if len(ix.documents) != m["n_documents"] or len(ix._buffer) != m["n_buffered"]:
        raise StoreError(
            f"truncated document store in {path}: "
            f"{len(ix.documents)}+{len(ix._buffer)} docs, manifest says "
            f"{m['n_documents']}+{m['n_buffered']}"
        )

    ix.tombstones = set(m["tombstones"])
    ix.generation = m["generation"]
    ix._mutations = m["mutations"]
    ix._restore_epoch = _claim_restore_epoch(directory, m["epoch"])
    ix._next_id = m["next_id"]
    segments = []
    for name in m["segments"]:
        stored, doc_ids, superseded = open_segment_store(
            path / name,
            fl=fl,
            use_mmap=use_mmap,
            verify=verify,
            expect_fl_crc=m["fl_crc32"],
        )
        segments.append(Segment(index=stored, doc_ids=doc_ids, superseded=superseded))
    ix.segments = segments
    return ix
