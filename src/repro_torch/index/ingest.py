"""SPIMI-style external-memory bulk ingestion (DESIGN.md §17).

Host code only (numpy, files and spawn workers), a copy of the reference's
pipeline over the port's store codec: a bulk tree written here is byte for
byte the reference's, and restores in either package.  Spill workers import
this module alone and never touch the card.

The companion construction paper (arXiv 2006.07954) argues index
*construction* is the engineering bottleneck of the multi-component key
scheme; the classic answer is SPIMI — single-pass in-memory indexing over
corpus blocks with immutable on-disk spill segments and a k-way merge.
This module is that pipeline on top of the repo's existing pieces:

* **Chunking (phase L)** — the corpus is split at FIXED document
  boundaries (``docs_per_spill``; never dependent on worker count or
  scheduling).  Each chunk is lemmatized (batched/memoized §2 lemmatizer)
  and persisted as ``chunk_XXXX/docs.jsonl`` plus a fsync'd ``chunk.json``
  carrying the chunk's lemma frequencies and a CRC32 of the doc file —
  the durable unit of resume.
* **FL reduce** — chunk frequency counters merge into the global FL-list
  (or an explicit ``fl=`` is used, e.g. the shard-global FL of
  ``serve.py --bulk-ingest``); identical corpus -> identical FL.
* **Spill (phase S)** — each chunk builds its §3 families with the
  vectorized ``build_segment_fast`` and writes an immutable §12.2 segment
  store at ``chunk_XXXX/seg_000``.  The store's manifest is written last
  (fsync'd), so a crash mid-spill leaves a spill that simply fails
  validation and is rebuilt on resume — §12.4 ordering, no new machinery.
* **Merge** — a single deterministic pass streams every family from the
  spill stores into one final segment: per family the sorted key UNION is
  split into row-budgeted batches; each spill contributes one contiguous
  mmap'd column slice per batch (its keys are sorted, so a union key range
  is one row range), slices are merged with ONE stable ``np.lexsort``
  (batch-key rank major, §4 row columns minor — exactly
  ``merge_posting_arrays`` / ``_merge_ordinary_nsw`` semantics, NSW
  payloads gathered under the same permutation), and re-encoded with the
  §12.1 codec through bounded temp-file column spools.  Peak memory is
  one batch, never the corpus.

The merged segment + concatenated document store are published atomically
as a normal ``snap_<N>`` snapshot (``repro_torch.checkpoint`` tmp -> fsync ->
rename), so ``load_snapshot``/``IncrementalIndexer.restore`` serve a bulk
build exactly like any other snapshot and a crash mid-merge publishes
nothing.

Determinism contract (§17.4): chunk boundaries are worker-independent,
every spill is a pure function of (chunk docs, FL, params), the merge is
single-process over sorted key unions, and all artifacts use pinned zip
metadata — so two bulk builds of the same corpus with ANY worker counts
produce byte-identical snapshot directories.  Exactness: the merged index
is ``index_sets_equal``-identical to ``build_indexes`` over the same
corpus (property-tested, CI-gated).

Fault injection (§14 ABI, honored inline): ``ingest.lemmatize`` and
``ingest.spill`` fire per chunk before the phase work (``crash``/``kill``
abort the run mid-phase), ``ingest.merge`` fires per chunk as the merge
opens its spill (``bitflip`` physically corrupts that chunk's spill so
the CRC verify rejects it for real).
"""

from __future__ import annotations

import json
import multiprocessing
import os
import shutil
import time
import zlib
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Sequence

import numpy as np

from ..checkpoint import fsync_json, replace_dir, retain_latest
from ..core.lemma import FLList, Lemmatizer
from .builder import IndexSet, POSTING_WIDTH
from .corpus import Document
from .fastbuild import _STOP, _candidates, build_segment_fast
from .store import (
    FORMAT_VERSION,
    SNAPSHOT_PREFIX,
    StoreError,
    _KEY_SEP,
    _load_manifest,
    _open_blob,
    _PACK_DTYPES,
    _PACK_MAX,
    _pack,
    _savez_deterministic,
    _unzigzag,
    _write_durable,
    _zigzag,
    fl_signature,
    latest_snapshot,
    write_segment_store,
)

__all__ = ["BulkBuildStats", "bulk_build"]

_FAMILIES = tuple(POSTING_WIDTH)
_RUN_DIR = "ingest_run"
_SPILL = "seg_000"  # matches the §14 bitflip glob (seg_*/postings.bin)
_DOCS = "docs.jsonl"
_CHUNK_META = "chunk.json"
_RUN_META = "run.json"

# default rows decoded per merge batch; tests shrink this to force many
# batches on tiny corpora
DEFAULT_MERGE_BATCH_ROWS = 1 << 19


@dataclass
class BulkBuildStats:
    """Outcome of one :func:`bulk_build` run (DESIGN.md §17; the BENCH
    ingest section)."""

    snapshot_path: str
    n_docs: int
    n_chunks: int
    workers: int
    docs_per_spill: int
    chunks_reused: int      # valid chunks carried over by resume
    spills_reused: int      # valid spills carried over by resume
    lemmatize_s: float
    spill_s: float
    merge_s: float
    total_s: float
    docs_per_sec: float
    spill_bytes: int
    timings: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# chunk layout + phase L (lemmatize)
# ---------------------------------------------------------------------------


def _chunk_dir(run_dir: Path, cid: int) -> Path:
    return run_dir / f"chunk_{cid:04d}"


def _corpus_crc(doc_ids: Sequence[int], texts: Sequence[str]) -> int:
    payload = json.dumps([[int(i), t] for i, t in zip(doc_ids, texts)])
    return zlib.crc32(payload.encode())


def _doc_line(doc: Document) -> str:
    # identical record shape to store.save_snapshot, so the merged
    # documents.jsonl is byte-identical to a live-indexer snapshot's
    return json.dumps({
        "doc_id": doc.doc_id,
        "text": doc.text,
        "lemmas": [list(t) for t in doc.lemma_stream],
    }) + "\n"


def _write_chunk(cdir: Path, docs: Sequence[Document]) -> None:
    # No fsync: a chunk is only ever trusted after its docs.jsonl bytes
    # match the CRC recorded in chunk.json (see _chunk_meta), so a torn
    # write is indistinguishable from an absent chunk and simply redone —
    # durability lives in the published snapshot, not the run directory.
    cdir.mkdir(parents=True, exist_ok=True)
    payload = "".join(_doc_line(d) for d in docs).encode()
    (cdir / _DOCS).write_bytes(payload)
    freq = Counter(
        l for d in docs for t in d.lemma_stream for l in t
    )
    with open(cdir / _CHUNK_META, "w") as f:
        json.dump({
            "n_docs": len(docs),
            "doc_ids": [int(d.doc_id) for d in docs],
            "freq": dict(freq),
            "docs_crc32": zlib.crc32(payload),
        }, f)


def _chunk_meta(cdir: Path) -> dict | None:
    """The chunk's fsync'd metadata iff the chunk is intact (docs.jsonl
    bytes match the recorded CRC) — resume's validity test."""
    try:
        with open(cdir / _CHUNK_META) as f:
            meta = json.load(f)
        payload = (cdir / _DOCS).read_bytes()
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None
    if not isinstance(meta, dict) or zlib.crc32(payload) != meta.get("docs_crc32"):
        return None
    return meta


def _read_chunk_docs(cdir: Path) -> list[Document]:
    docs = []
    with open(cdir / _DOCS) as f:
        for line in f:
            rec = json.loads(line)
            docs.append(Document(
                doc_id=rec["doc_id"],
                text=rec["text"],
                lemma_stream=[tuple(t) for t in rec["lemmas"]],
            ))
    return docs


def _lemmatize_chunk(args) -> None:
    """Phase-L worker (top-level for multiprocessing): lemmatize one chunk
    and persist it.  Pure per-chunk -> identical output for any worker
    count."""
    run_dir, cid, pairs = args
    lem = Lemmatizer()
    docs = [
        Document(doc_id=i, text=t, lemma_stream=lem.lemmatize_text(t))
        for i, t in pairs
    ]
    _write_chunk(_chunk_dir(Path(run_dir), cid), docs)


# ---------------------------------------------------------------------------
# phase S (spill)
# ---------------------------------------------------------------------------


def _spill_chunk(args, docs: Sequence[Document] | None = None) -> None:
    """Phase-S worker: build one chunk's §3 families (vectorized) and write
    the immutable §12.2 spill store.  The store manifest lands last, so an
    interrupted spill is invalid, not torn.  Spills are CRC-validated
    caches (any torn/corrupt state fails ``_SpillReader`` and is rebuilt on
    resume), so the writer skips fsync — durability comes from the chunk
    files and the final snapshot, not the spills.

    Pool workers read the chunk docs back from disk; the single-process
    path passes them via ``docs`` (same values — the chunk file was either
    just written from them or CRC+corpus-crc validated against them), so
    spill output is byte-identical either way (§17.4)."""
    run_dir, cid, fl, max_distance, build_pair, build_degenerate, fl_crc = args
    cdir = _chunk_dir(Path(run_dir), cid)
    if docs is None:
        docs = _read_chunk_docs(cdir)
    spill = cdir / _SPILL
    if spill.exists():
        shutil.rmtree(spill)
    _write_spill_fast(
        docs, fl, spill, fl_crc=fl_crc,
        doc_ids=[d.doc_id for d in docs], max_distance=max_distance,
        build_pair=build_pair, build_degenerate=build_degenerate,
    )


def _shrunk_keys(strings) -> np.ndarray:
    """Key-table string array built exactly like ``write_segment_store``'s
    (``np.asarray(list, dtype=str)``), so the dtype width — and therefore
    the ``keys.npz`` bytes — match the generic writer."""
    if not isinstance(strings, list):
        strings = strings.tolist()
    return np.asarray(strings, dtype=str)


def _write_spill_fast(
    docs: Sequence[Document],
    fl: FLList,
    path: Path,
    fl_crc: int,
    doc_ids: Sequence[int],
    max_distance: int,
    build_pair: bool,
    build_degenerate: bool,
) -> None:
    """Encode one chunk's §3 families straight from the vectorized
    candidate arrays to a §12.2 segment store — byte-identical to
    ``write_segment_store(build_segment_fast(...), ...)`` (property-tested)
    but without materializing the key->rows dicts: vocabulary ids are
    mapped to lexicographic ranks, ONE packed stable sort per family yields
    the final on-disk key order, and columns are delta/zigzag/width-packed
    directly from the sorted int64 arrays.  Files are written without
    fsync (spills are CRC-validated caches, see ``_spill_chunk``)."""
    D = int(max_distance)
    cand = _candidates(docs, fl, D, build_pair, build_degenerate, None)
    if cand is None:
        # no occurrences: the generic writer handles the all-empty layout
        write_segment_store(
            build_segment_fast(docs, fl, max_distance=D,
                               build_pair=build_pair,
                               build_degenerate=build_degenerate),
            path, fl_crc=fl_crc, doc_ids=doc_ids,
        )
        return

    n = cand["n"]
    vlist = cand["vlist"]
    V = len(vlist)
    varr = np.asarray(vlist)
    order_v = np.argsort(varr, kind="stable")  # rank -> vocab id
    vrank = np.empty(V, dtype=np.int64)
    vrank[order_v] = np.arange(V, dtype=np.int64)
    svlist = varr[order_v]                      # lemma string by rank
    svtyp = cand["vtyp"][order_v]

    path.mkdir(parents=True, exist_ok=True)
    blob = bytearray()
    families_meta: dict[str, dict] = {}
    key_table: dict[str, np.ndarray] = {}

    def add_family(fname, keys, starts, rows, cols):
        width = POSTING_WIDTH[fname]
        nrows = len(cols[0]) if cols else 0
        boundary = starts[starts < nrows] if nrows else starts[:0]
        codes, offsets, sizes = [], [], []
        for c in range(width):
            col = (
                cols[c].astype(np.int64) if nrows
                else np.empty(0, dtype=np.int64)
            )
            if c == 0 and nrows:
                dv = np.diff(col, prepend=np.int64(0))
                dv[boundary] = col[boundary]  # absolute at each key start
                col = dv
            code, raw = _pack(_zigzag(col))
            codes.append(code)
            offsets.append(len(blob))
            sizes.append(len(raw))
            blob.extend(raw)
        families_meta[fname] = {
            "n_rows": int(rows.sum()) if len(rows) else 0,
            "codes": codes,
            "offsets": offsets,
            "sizes": sizes,
        }
        key_table[f"{fname}_keys"] = _shrunk_keys(keys)
        key_table[f"{fname}_start"] = starts.astype(np.int64)
        key_table[f"{fname}_rows"] = rows.astype(np.int64)

    def ranked_family(fname, kcols, rcols):
        """Sort candidate rows by (packed key RANKS, row columns): packed
        rank order == sorted-tuple key order, so groups come out in the
        generic writer's on-disk order."""
        kranks = [vrank[k] for k in kcols]
        packed = kranks[0].astype(np.int64, copy=True)
        for k in kranks[1:]:
            packed *= V
            packed += k
        perm = _sort_perm(packed, rcols)
        packed_s = packed[perm]
        m = len(packed_s)
        b = np.concatenate(
            ([0], np.flatnonzero(packed_s[1:] != packed_s[:-1]) + 1, [m])
        )
        rows_f = np.diff(b)
        head = packed_s[b[:-1]]
        comps = []
        for _ in range(len(kcols)):
            comps.append(head % V)
            head = head // V
        comps.reverse()
        strs = svlist[comps[0]]
        for cr in comps[1:]:
            strs = np.char.add(np.char.add(strs, _KEY_SEP), svlist[cr])
        add_family(fname, strs, _cumsum0(rows_f)[:-1], rows_f,
                   [r[perm] for r in rcols])

    empty_i64 = np.zeros(0, dtype=np.int64)

    # ---- ordinary (+ NSW riding the same permutation) --------------------
    lid, doc, pos = cand["lid"], cand["doc"], cand["pos"]
    rank = vrank[lid]
    perm = _sort_perm(rank, (doc, pos))
    rank_s = rank[perm]
    doc_s = doc[perm]
    pos_s = pos[perm]
    counts_s = cand["nsw_counts"][perm]
    src = _ragged_take(cand["pay_starts"][perm], counts_s)
    stop_s = cand["nsw_stop_flat"][src]
    dist_s = cand["nsw_dist_flat"][src]
    bnd = np.concatenate(
        ([0], np.flatnonzero(rank_s[1:] != rank_s[:-1]) + 1, [n])
    )
    gs = np.diff(bnd)             # rows per present key, in rank order
    heads = rank_s[bnd[:-1]]      # present ranks (ascending)
    group_stop = svtyp[heads] == _STOP
    add_family("ordinary", svlist[heads], _cumsum0(gs)[:-1], gs,
               [doc_s, pos_s])

    # ---- stop_single: a stop lemma's rows ARE its ordinary rows ----------
    if build_degenerate and bool(group_stop.any()):
        row_mask = np.repeat(group_stop, gs)
        rows_ss = gs[group_stop]
        add_family("stop_single", svlist[heads[group_stop]],
                   _cumsum0(rows_ss)[:-1], rows_ss,
                   [doc_s[row_mask], pos_s[row_mask]])
    else:
        add_family("stop_single", [], empty_i64, empty_i64,
                   [empty_i64, empty_i64])

    # ---- pair / stop_pair / triple ---------------------------------------
    for fname in ("pair", "stop_pair", "triple"):
        c = cand[fname]
        if c is not None and len(c[1][0]):
            ranked_family(fname, c[0], c[1])
        else:
            width = POSTING_WIDTH[fname]
            add_family(fname, [], empty_i64, empty_i64,
                       [empty_i64] * width)

    # ---- NSW table: non-stop ordinary groups, same row order -------------
    nonstop = ~group_stop
    row_nonstop = np.repeat(nonstop, gs)
    counts_col = counts_s[row_nonstop]
    pay_mask = np.repeat(row_nonstop, counts_s)
    nsw_blob = bytearray()
    nsw_meta = {"codes": [], "offsets": [], "sizes": [],
                "n_counts": len(counts_col),
                "n_payload": int(counts_col.sum())}
    for col in (counts_col, stop_s[pay_mask], dist_s[pay_mask]):
        code, raw = _pack(_zigzag(col.astype(np.int64)))
        nsw_meta["codes"].append(code)
        nsw_meta["offsets"].append(len(nsw_blob))
        nsw_meta["sizes"].append(len(raw))
        nsw_blob.extend(raw)
    n_posts = gs[nonstop]
    totals = np.add.reduceat(counts_s, bnd[:-1])[nonstop]
    key_table["nsw_lemmas"] = _shrunk_keys(svlist[heads[nonstop]])
    key_table["nsw_post_start"] = _cumsum0(n_posts)[:-1]
    key_table["nsw_n_post"] = n_posts.astype(np.int64)
    key_table["nsw_pay_start"] = _cumsum0(totals)[:-1]
    key_table["nsw_total"] = totals.astype(np.int64)

    # ---- files: same layout/manifest as write_segment_store, no fsync ----
    import io
    (path / "postings.bin").write_bytes(bytes(blob))
    (path / "nsw.bin").write_bytes(bytes(nsw_blob))
    keys_buf = io.BytesIO()
    _savez_deterministic(keys_buf, key_table)
    keys_bytes = keys_buf.getvalue()
    (path / "keys.npz").write_bytes(keys_bytes)
    manifest = {
        "format_version": FORMAT_VERSION,
        "kind": "segment",
        "n_docs": len(docs),
        "doc_ids": [int(d) for d in sorted(doc_ids)],
        "superseded": [],
        "max_distance": D,
        "fl_crc32": int(fl_crc),
        "families": families_meta,
        "nsw": nsw_meta,
        "postings": {"bytes": len(blob), "crc32": zlib.crc32(bytes(blob))},
        "nsw_blob": {"bytes": len(nsw_blob),
                     "crc32": zlib.crc32(bytes(nsw_blob))},
        "keys_file": {"bytes": len(keys_bytes),
                      "crc32": zlib.crc32(keys_bytes)},
    }
    with open(path / "manifest.json", "w") as f:
        json.dump(manifest, f)


# ---------------------------------------------------------------------------
# merge-side spill access: raw key tables + packed columns (no per-key
# laziness — the merge reads contiguous multi-key ranges)
# ---------------------------------------------------------------------------


class _SpillReader:
    """Verified low-level view of one spill store: manifest, CRC-checked
    mmap'd blobs, and the raw key-extent tables."""

    def __init__(self, path: Path, expect_fl_crc: int):
        self.path = path
        m = _load_manifest(path / "manifest.json", expect_kind="segment")
        if m["fl_crc32"] != expect_fl_crc:
            raise StoreError(
                f"{path}: spill keyed under FL signature {m['fl_crc32']}, "
                f"merge expects {expect_fl_crc}"
            )
        self.manifest = m
        self.blob = _open_blob(path / "postings.bin", m["postings"],
                               use_mmap=True, verify=True)
        self.nsw_blob = _open_blob(path / "nsw.bin", m["nsw_blob"],
                                   use_mmap=True, verify=True)
        keys_bytes = (path / "keys.npz").read_bytes()
        if len(keys_bytes) != m["keys_file"]["bytes"] or \
                zlib.crc32(keys_bytes) != m["keys_file"]["crc32"]:
            raise StoreError(f"corrupt key table in {path}")
        import io
        try:
            with np.load(io.BytesIO(keys_bytes)) as kt:
                self.table = {name: kt[name] for name in kt.files}
        except Exception as e:
            raise StoreError(f"corrupt key table in {path}: {e}") from e
        self.doc_ids = [int(d) for d in m["doc_ids"]]
        self.n_docs = int(m["n_docs"])

    def family(self, fname: str):
        fm = self.manifest["families"][fname]
        return (
            self.table[f"{fname}_keys"],
            self.table[f"{fname}_start"].astype(np.int64),
            self.table[f"{fname}_rows"].astype(np.int64),
            fm["codes"],
            fm["offsets"],
        )

    def nsw(self):
        nm = self.manifest["nsw"]
        return (
            self.table["nsw_lemmas"],
            self.table["nsw_post_start"].astype(np.int64),
            self.table["nsw_n_post"].astype(np.int64),
            self.table["nsw_pay_start"].astype(np.int64),
            self.table["nsw_total"].astype(np.int64),
            nm["codes"],
            nm["offsets"],
        )


def _decode_col_range(blob, code: int, offset: int, start: int, n: int) -> np.ndarray:
    dt = _PACK_DTYPES[code]
    try:
        raw = np.frombuffer(
            blob, dtype=dt, count=n, offset=offset + start * np.dtype(dt).itemsize
        )
    except ValueError as e:
        raise StoreError(f"truncated spill column: {e}") from e
    return _unzigzag(raw.astype(np.int64))


def _decode_family_range(
    blob, codes, offsets, start: int, n: int, width: int,
    rel_boundaries: np.ndarray,
) -> list[np.ndarray]:
    """Decode rows ``[start, start+n)`` of a family — a MULTI-key contiguous
    range (``rel_boundaries`` are the range-relative key starts, first is 0).
    Column 0's delta chain resets to an absolute value at each boundary
    (§12.1), so the cumulative sum is re-based per key segment."""
    cols: list[np.ndarray] = []
    for c in range(width):
        v = _decode_col_range(blob, codes[c], offsets[c], start, n)
        if c == 0 and n:
            cs = np.cumsum(v)
            seg_lens = np.diff(np.append(rel_boundaries, n))
            adjust = cs[rel_boundaries] - v[rel_boundaries]
            v = cs - np.repeat(adjust, seg_lens)
        cols.append(v)
    return cols


# ---------------------------------------------------------------------------
# §12.1 re-encode spools: bounded temp-file columns -> narrowed final blobs
# ---------------------------------------------------------------------------


class _ColumnSpool:
    """One output column spooled to disk as uint32 zigzag values; narrowed
    to the final §12.1 pack dtype in a streaming pass once its global max
    is known.  This is what keeps merge memory bounded by the batch size
    instead of the family size."""

    def __init__(self, path: Path):
        self.path = path
        self._f = open(path, "wb")
        self.max = 0
        self.n = 0

    def append(self, values: np.ndarray) -> None:
        z = _zigzag(values.astype(np.int64))
        if len(z):
            m = int(z.max())
            if m > _PACK_MAX[-1]:
                raise StoreError(f"packed value {m} exceeds uint32 range")
            self.max = max(self.max, m)
            self.n += len(z)
            self._f.write(z.astype(np.uint32).tobytes())

    def code(self) -> int:
        for code, top in enumerate(_PACK_MAX):
            if self.max <= top:
                return code
        raise StoreError("unreachable: max checked at append")

    def spool_into(self, out, crc: int, chunk_rows: int = 1 << 20) -> tuple[int, int]:
        """Stream-narrow into the final blob file; returns (bytes, crc)."""
        self._f.close()
        dt = _PACK_DTYPES[self.code()]
        written = 0
        with open(self.path, "rb") as f:
            while True:
                buf = f.read(4 * chunk_rows)
                if not buf:
                    break
                vals = np.frombuffer(buf, dtype=np.uint32).astype(dt)
                raw = vals.tobytes()
                out.write(raw)
                crc = zlib.crc32(raw, crc)
                written += len(raw)
        os.unlink(self.path)
        return written, crc


def _sort_perm(rank: np.ndarray, cols: Sequence[np.ndarray]) -> np.ndarray:
    """Stable permutation sorting rows by ``(rank, cols[0], ..., cols[-1])``
    — the ``merge_posting_arrays`` order with the batch-key rank major.

    Fast path packs all sort keys into ONE int64 word (rank in the high
    bits, columns below) and argsorts once; a single 300k-row argsort is
    ~6x cheaper than the equivalent multi-pass ``np.lexsort``.  Falls back
    to ``np.lexsort`` whenever the packed width would overflow 63 bits or
    a column is negative (packing would break the order)."""
    n = len(rank)
    if n == 0:
        return np.empty(0, dtype=np.intp)
    keys = [rank, *cols]
    spans = []
    bits = 0
    for k in keys:
        lo, hi = int(k.min()), int(k.max())
        spans.append(lo)
        bits += max((hi - lo).bit_length(), 1)
    if bits <= 63:
        packed = (keys[0] - np.int64(spans[0])).astype(np.int64)
        for k, lo in zip(keys[1:], spans[1:]):
            s = k - np.int64(lo)
            packed = (packed << np.int64(max(int(s.max()).bit_length(), 1))) | s
        return np.argsort(packed, kind="stable")
    return np.lexsort(tuple(reversed(list(cols))) + (rank,))


def _cumsum0(a: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a) + 1, dtype=np.int64)
    np.cumsum(a, out=out[1:])
    return out


def _ragged_take(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    total = int(counts.sum())
    return (
        np.repeat(starts, counts)
        + np.arange(total, dtype=np.int64)
        - np.repeat(_cumsum0(counts)[:-1], counts)
    )


def _merge_spills(
    readers: Sequence[_SpillReader],
    fl: FLList,
    max_distance: int,
    out_dir: Path,
    merge_batch_rows: int,
) -> None:
    """Stream every §3 family from the spills into one §12.2 segment store
    at ``out_dir`` — identical bytes to ``write_segment_store`` over the
    union index (see module docstring for the merge invariants)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp_dir = out_dir / "_merge_tmp"
    tmp_dir.mkdir(exist_ok=True)

    stop_flag_cache: dict[str, bool] = {}

    def _is_stop(lemma: str) -> bool:
        hit = stop_flag_cache.get(lemma)
        if hit is None:
            hit = stop_flag_cache[lemma] = bool(fl.is_stop(lemma))
        return hit

    families_meta: dict[str, dict] = {}
    key_table: dict[str, np.ndarray] = {}
    nsw_spools = [
        _ColumnSpool(tmp_dir / f"nsw_col{c}.u32") for c in range(3)
    ]
    nsw_lemmas: list[str] = []
    nsw_n_post: list[np.ndarray] = []
    nsw_totals: list[np.ndarray] = []

    postings_path = out_dir / "postings.bin"
    blob_pos = 0
    blob_crc = 0
    out = open(postings_path, "wb")
    try:
        for fname in _FAMILIES:
            width = POSTING_WIDTH[fname]
            per_spill = [r.family(fname) for r in readers]
            key_arrays = [p[0] for p in per_spill if len(p[0])]
            union = (
                np.unique(np.concatenate(key_arrays))
                if key_arrays else np.empty(0, dtype=str)
            )
            pos_in_union = [
                np.searchsorted(union, p[0]) if len(p[0])
                else np.empty(0, dtype=np.int64)
                for p in per_spill
            ]
            totals = np.zeros(len(union), dtype=np.int64)
            for s, p in enumerate(per_spill):
                if len(p[0]):
                    np.add.at(totals, pos_in_union[s], p[2])

            spools = [
                _ColumnSpool(tmp_dir / f"{fname}_col{c}.u32")
                for c in range(width)
            ]
            is_ord = fname == "ordinary"
            nsw_tables = [r.nsw() for r in readers] if is_ord else None

            # row-budgeted key batches: each spill contributes ONE
            # contiguous decoded slice per batch
            cum = _cumsum0(totals)
            lo = 0
            while lo < len(union):
                hi = int(np.searchsorted(cum, cum[lo] + merge_batch_rows,
                                         side="left"))
                hi = min(max(hi, lo + 1), len(union))
                n_keys = hi - lo

                part_cols: list[list[np.ndarray]] = [[] for _ in range(width)]
                rank_parts: list[np.ndarray] = []
                counts_parts: list[np.ndarray] = []
                pstart_parts: list[np.ndarray] = []
                stop_parts: list[np.ndarray] = []
                dist_parts: list[np.ndarray] = []
                pay_base = 0
                for s, (keys_s, starts_s, rows_s, codes, offsets) in enumerate(per_spill):
                    pu = pos_in_union[s]
                    j0 = int(np.searchsorted(pu, lo, side="left"))
                    j1 = int(np.searchsorted(pu, hi, side="left"))
                    if j0 == j1:
                        continue
                    row0 = int(starts_s[j0])
                    nrows = int(starts_s[j1 - 1] + rows_s[j1 - 1] - row0)
                    rel_bnd = starts_s[j0:j1] - row0
                    cols = _decode_family_range(
                        readers[s].blob, codes, offsets, row0, nrows, width,
                        rel_bnd,
                    )
                    for c in range(width):
                        part_cols[c].append(cols[c])
                    rank_parts.append(
                        np.repeat(pu[j0:j1] - lo, rows_s[j0:j1])
                    )
                    if is_ord:
                        # per-row NSW count + payload-start vectors for this
                        # slice: spill NSW lemmas are the non-stop subset of
                        # its ordinary keys, scattered to their row ranges
                        (nl, nps, nnp, nys, ntot, ncodes, noffs) = nsw_tables[s]
                        counts_vec = np.zeros(nrows, dtype=np.int64)
                        pstart_vec = np.zeros(nrows, dtype=np.int64)
                        k0 = int(np.searchsorted(nl, keys_s[j0]))
                        k1 = int(np.searchsorted(nl, keys_s[j1 - 1], side="right"))
                        if k0 < k1:
                            post0 = int(nps[k0])
                            n_counts = int(nnp[k0:k1].sum())
                            counts_flat = _decode_col_range(
                                readers[s].nsw_blob, ncodes[0], noffs[0],
                                post0, n_counts,
                            )
                            pay0 = int(nys[k0])
                            n_pay = int(ntot[k0:k1].sum())
                            stop_flat = _decode_col_range(
                                readers[s].nsw_blob, ncodes[1], noffs[1],
                                pay0, n_pay,
                            )
                            dist_flat = _decode_col_range(
                                readers[s].nsw_blob, ncodes[2], noffs[2],
                                pay0, n_pay,
                            )
                            # destination rows of each NSW lemma inside the
                            # decoded ordinary slice
                            kpos = np.searchsorted(keys_s[j0:j1], nl[k0:k1])
                            dest = _ragged_take(
                                rel_bnd[kpos], nnp[k0:k1]
                            )
                            counts_vec[dest] = counts_flat
                            pstart_vec[dest] = (
                                _cumsum0(counts_flat)[:-1] + pay_base
                            )
                            stop_parts.append(stop_flat)
                            dist_parts.append(dist_flat)
                            pay_base += n_pay
                        counts_parts.append(counts_vec)
                        pstart_parts.append(pstart_vec)

                cat = [np.concatenate(part_cols[c]) for c in range(width)]
                rank = np.concatenate(rank_parts)
                # reference per-key merge order: stable §4 row columns over
                # parts concatenated in chunk (= doc) order; for ordinary the
                # NSW payload rides the same permutation
                perm = _sort_perm(rank, cat)
                rank_m = rank[perm]
                key_start_rows = np.concatenate(
                    ([0], np.flatnonzero(rank_m[1:] != rank_m[:-1]) + 1)
                )
                if len(key_start_rows) != n_keys:
                    raise StoreError(
                        f"merge dropped keys in {fname}: "
                        f"{len(key_start_rows)} groups for {n_keys} keys"
                    )
                for c in range(width):
                    col = cat[c][perm]
                    if c == 0:
                        dv = np.diff(col, prepend=np.int64(0))
                        dv[key_start_rows] = col[key_start_rows]
                        spools[c].append(dv)
                    else:
                        spools[c].append(col)

                if is_ord:
                    counts_m = np.concatenate(counts_parts)[perm]
                    pstart_m = np.concatenate(pstart_parts)[perm]
                    stop_cat = (
                        np.concatenate(stop_parts) if stop_parts
                        else np.empty(0, dtype=np.int64)
                    )
                    dist_cat = (
                        np.concatenate(dist_parts) if dist_parts
                        else np.empty(0, dtype=np.int64)
                    )
                    gather = _ragged_take(pstart_m, counts_m)
                    names = union[lo:hi].tolist()
                    nonstop = np.asarray(
                        [not _is_stop(nm) for nm in names], dtype=bool
                    )
                    row_mask = np.repeat(
                        nonstop,
                        np.diff(np.append(key_start_rows, len(rank_m))),
                    )
                    nsw_spools[0].append(counts_m[row_mask])
                    nsw_spools[1].append(stop_cat[gather])
                    nsw_spools[2].append(dist_cat[gather])
                    per_key_rows = np.diff(
                        np.append(key_start_rows, len(rank_m))
                    )
                    per_key_pay = np.add.reduceat(
                        counts_m, key_start_rows
                    ) if len(rank_m) else np.zeros(0, dtype=np.int64)
                    nsw_lemmas.extend(
                        nm for nm, ns in zip(names, nonstop) if ns
                    )
                    nsw_n_post.append(per_key_rows[nonstop])
                    nsw_totals.append(per_key_pay[nonstop])
                lo = hi

            # narrow this family's spools into the final blob
            codes_out, offsets_out, sizes_out = [], [], []
            n_rows_total = int(totals.sum())
            for sp in spools:
                codes_out.append(sp.code())
                offsets_out.append(blob_pos)
                written, blob_crc = sp.spool_into(out, blob_crc)
                sizes_out.append(written)
                blob_pos += written
            families_meta[fname] = {
                "n_rows": n_rows_total,
                "codes": codes_out,
                "offsets": offsets_out,
                "sizes": sizes_out,
            }
            key_table[f"{fname}_keys"] = union.astype(str)
            key_table[f"{fname}_start"] = _cumsum0(totals)[:-1]
            key_table[f"{fname}_rows"] = totals
        out.flush()
        os.fsync(out.fileno())
    finally:
        out.close()

    nsw_path = out_dir / "nsw.bin"
    nsw_meta = {"codes": [], "offsets": [], "sizes": [],
                "n_counts": nsw_spools[0].n, "n_payload": nsw_spools[1].n}
    nsw_pos = 0
    nsw_crc = 0
    with open(nsw_path, "wb") as nout:
        for sp in nsw_spools:
            nsw_meta["codes"].append(sp.code())
            nsw_meta["offsets"].append(nsw_pos)
            written, nsw_crc = sp.spool_into(nout, nsw_crc)
            nsw_meta["sizes"].append(written)
            nsw_pos += written
        nout.flush()
        os.fsync(nout.fileno())

    n_post_all = (
        np.concatenate(nsw_n_post) if nsw_n_post else np.zeros(0, np.int64)
    )
    totals_all = (
        np.concatenate(nsw_totals) if nsw_totals else np.zeros(0, np.int64)
    )
    key_table["nsw_lemmas"] = np.asarray(nsw_lemmas, dtype=str)
    key_table["nsw_post_start"] = _cumsum0(n_post_all)[:-1]
    key_table["nsw_n_post"] = n_post_all
    key_table["nsw_pay_start"] = _cumsum0(totals_all)[:-1]
    key_table["nsw_total"] = totals_all

    import io
    keys_buf = io.BytesIO()
    _savez_deterministic(keys_buf, key_table)
    keys_bytes = keys_buf.getvalue()
    _write_durable(out_dir / "keys.npz", keys_bytes)

    all_doc_ids = sorted(d for r in readers for d in r.doc_ids)
    manifest = {
        "format_version": FORMAT_VERSION,
        "kind": "segment",
        "n_docs": sum(r.n_docs for r in readers),
        "doc_ids": [int(d) for d in all_doc_ids],
        "superseded": [],
        "max_distance": int(max_distance),
        "fl_crc32": int(fl_signature(fl)),
        "families": families_meta,
        "nsw": nsw_meta,
        "postings": {"bytes": blob_pos, "crc32": blob_crc},
        "nsw_blob": {"bytes": nsw_pos, "crc32": nsw_crc},
        "keys_file": {"bytes": len(keys_bytes), "crc32": zlib.crc32(keys_bytes)},
    }
    fsync_json(out_dir / "manifest.json", manifest)
    shutil.rmtree(tmp_dir)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def _run_pool(workers: int, fn: Callable, tasks: list, inline: bool) -> None:
    """Run phase tasks inline or over a spawn pool.  Inline is forced when
    a fault injector is attached (schedules are counted in-process) — the
    outputs are identical either way (§17.4).  Spawn, not fork: the caller
    usually holds a CUDA context and threads (``launch/serve.py``), and
    forking a multithreaded parent can deadlock the child or hand it a
    context it must not use; workers only need the numpy spill path, and
    the interpreter start amortizes over chunk batches."""
    if inline or workers <= 1 or len(tasks) <= 1:
        for t in tasks:
            fn(t)
        return
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(processes=min(workers, len(tasks))) as pool:
        # any worker exception propagates and aborts the run (fail clean)
        pool.map(fn, tasks, chunksize=1)


def bulk_build(
    texts: Sequence[str] | None = None,
    *,
    out_dir: str | Path,
    sw_count: int,
    fu_count: int,
    max_distance: int = 5,
    build_pair: bool = True,
    build_degenerate: bool = True,
    documents: Sequence[Document] | None = None,
    doc_ids: Sequence[int] | None = None,
    fl: FLList | None = None,
    docs_per_spill: int = 64,
    workers: int = 1,
    merge_batch_rows: int = DEFAULT_MERGE_BATCH_ROWS,
    resume: bool = False,
    keep_spills: bool = False,
    injector=None,
    keep: int = 2,
) -> BulkBuildStats:
    """SPIMI bulk build (DESIGN.md §17): lemmatize + spill + merge
    ``texts`` (or pre-lemmatized ``documents``) into an atomically
    published ``snap_<N>`` under ``out_dir`` — every §3 family, built
    out-of-core (see module docstring for phases and contracts).

    ``resume=True`` revalidates an interrupted run's chunks and spills by
    CRC and redoes only the invalid ones; the finished snapshot is
    byte-identical to an uninterrupted run.  ``fl`` pins an external
    FL-list (shard-global builds); otherwise the FL reduces from the chunk
    frequency counters.  ``keep_spills`` leaves the spill directory in
    place (for inspection)."""
    t_start = time.perf_counter()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    run_dir = out_dir / _RUN_DIR

    if documents is not None:
        if texts is not None:
            raise ValueError("pass texts or documents, not both")
        docs_all = list(documents)
        ids = [int(d.doc_id) for d in docs_all]
        corpus_crc = _corpus_crc(ids, [d.text for d in docs_all])
    else:
        if texts is None:
            raise ValueError("pass texts or documents")
        ids = (
            [int(i) for i in doc_ids] if doc_ids is not None
            else list(range(len(texts)))
        )
        if len(ids) != len(texts):
            raise ValueError("doc_ids and texts length mismatch")
        docs_all = None
        corpus_crc = _corpus_crc(ids, texts)

    n_docs = len(ids)
    dps = max(1, int(docs_per_spill))
    n_chunks = (n_docs + dps - 1) // dps
    chunk_bounds = [
        (c * dps, min((c + 1) * dps, n_docs)) for c in range(n_chunks)
    ]
    run_meta = {
        "format_version": FORMAT_VERSION,
        "kind": "ingest_run",
        "sw_count": int(sw_count),
        "fu_count": int(fu_count),
        "max_distance": int(max_distance),
        "build_pair": bool(build_pair),
        "build_degenerate": bool(build_degenerate),
        "docs_per_spill": dps,
        "n_docs": n_docs,
        "corpus_crc32": corpus_crc,
        "chunks": chunk_bounds,
        "pinned_fl": fl is not None,
    }

    if run_dir.exists():
        existing = None
        try:
            with open(run_dir / _RUN_META) as f:
                existing = json.load(f)
        except (OSError, json.JSONDecodeError):
            existing = None
        compatible = existing is not None and all(
            existing.get(k) == run_meta[k]
            for k in run_meta
            if k != "chunks"
        ) and [tuple(b) for b in existing.get("chunks", [])] == chunk_bounds
        if not (resume and compatible):
            # a fresh build (or an incompatible leftover) starts clean —
            # partial runs are only ever continued under resume=True
            shutil.rmtree(run_dir)
    run_dir.mkdir(exist_ok=True)
    if not (run_dir / _RUN_META).exists():
        fsync_json(run_dir / _RUN_META, run_meta)

    inline = injector is not None

    # ---- phase L: lemmatize + persist chunks ----------------------------
    t0 = time.perf_counter()
    chunk_metas: list[dict | None] = [
        _chunk_meta(_chunk_dir(run_dir, c)) for c in range(n_chunks)
    ]
    chunks_reused = sum(m is not None for m in chunk_metas)
    todo_l = []
    for c, meta in enumerate(chunk_metas):
        if meta is not None:
            continue
        lo, hi = chunk_bounds[c]
        if docs_all is not None:
            if injector is not None:
                injector.fire("ingest.lemmatize", shard=c,
                              path=_chunk_dir(run_dir, c))
            _write_chunk(_chunk_dir(run_dir, c), docs_all[lo:hi])
        else:
            todo_l.append((str(run_dir), c,
                           list(zip(ids[lo:hi], texts[lo:hi]))))
    if todo_l:
        if inline:
            # fire each chunk's injection point right before its work, so a
            # crash at chunk c leaves chunks < c durable (resume picks them up)
            for task in todo_l:
                injector.fire("ingest.lemmatize", shard=task[1],
                              path=_chunk_dir(run_dir, task[1]))
                _lemmatize_chunk(task)
        else:
            _run_pool(workers, _lemmatize_chunk, todo_l, inline)
    for c in range(n_chunks):
        if chunk_metas[c] is None:
            chunk_metas[c] = _chunk_meta(_chunk_dir(run_dir, c))
            if chunk_metas[c] is None:
                raise StoreError(f"chunk {c} failed to persist")
    t_lem = time.perf_counter() - t0

    # ---- FL reduce ------------------------------------------------------
    if fl is None:
        freq: Counter = Counter()
        for meta in chunk_metas:
            freq.update(meta["freq"])
        fl = FLList.from_frequencies(freq, sw_count, fu_count)
    fl_crc = fl_signature(fl)

    # ---- phase S: spill segments ----------------------------------------
    t0 = time.perf_counter()

    def _spill_valid(c: int) -> bool:
        try:
            _SpillReader(_chunk_dir(run_dir, c) / _SPILL, fl_crc)
            return True
        except StoreError:
            return False

    spill_ok = [_spill_valid(c) for c in range(n_chunks)]
    spills_reused = sum(spill_ok)
    todo_s = [
        (str(run_dir), c, fl, max_distance, build_pair, build_degenerate,
         fl_crc)
        for c, ok in enumerate(spill_ok)
        if not ok
    ]
    if todo_s:
        if inline or workers <= 1 or len(todo_s) <= 1:
            for task in todo_s:
                c = task[1]
                if injector is not None:
                    injector.fire("ingest.spill", shard=c,
                                  path=_chunk_dir(run_dir, c))
                # prelemmatized single-process path: spill straight from
                # the in-memory docs (the chunk file carries the same
                # values — just written from them, or CRC-validated under
                # the run's pinned corpus_crc)
                chunk_docs = None
                if docs_all is not None:
                    lo, hi = chunk_bounds[c]
                    chunk_docs = docs_all[lo:hi]
                _spill_chunk(task, docs=chunk_docs)
        else:
            _run_pool(workers, _spill_chunk, todo_s, inline)
    t_spill = time.perf_counter() - t0

    # ---- merge + snapshot publish ---------------------------------------
    t0 = time.perf_counter()
    readers = []
    for c in range(n_chunks):
        cdir = _chunk_dir(run_dir, c)
        if injector is not None:
            # bitflip events physically corrupt THIS chunk's spill before
            # the CRC-verified open below — real §12.2 rejection under test
            injector.fire("ingest.merge", shard=c, path=cdir)
        readers.append(_SpillReader(cdir / _SPILL, fl_crc))

    latest = latest_snapshot(out_dir)
    snap_n = 0 if latest is None else latest + 1
    tmp = out_dir / f"{SNAPSHOT_PREFIX}_{snap_n}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    _merge_spills(readers, fl, max_distance, tmp / "seg_000",
                  merge_batch_rows)

    with open(tmp / "documents.jsonl", "wb") as f:
        for c in range(n_chunks):
            f.write((_chunk_dir(run_dir, c) / _DOCS).read_bytes())
        f.flush()
        os.fsync(f.fileno())

    manifest = {
        "format_version": FORMAT_VERSION,
        "kind": "snapshot",
        "sw_count": int(fl.sw_count),
        "fu_count": int(fl.fu_count),
        "max_distance": int(max_distance),
        "build_pair": bool(build_pair),
        "build_degenerate": bool(build_degenerate),
        "fl": {
            "lemmas": fl.lemmas,
            "frequency": fl.frequency,
            "sw_count": fl.sw_count,
            "fu_count": fl.fu_count,
        },
        "fl_crc32": fl_crc,
        "tombstones": [],
        "generation": 1,
        "mutations": 1,
        "epoch": 0,
        "next_id": (max(ids) + 1) if ids else 0,
        "segments": ["seg_000"],
        "n_documents": n_docs,
        "n_buffered": 0,
    }
    fsync_json(tmp / "manifest.json", manifest)
    final = out_dir / f"{SNAPSHOT_PREFIX}_{snap_n}"
    replace_dir(tmp, final)
    retain_latest(out_dir, SNAPSHOT_PREFIX, keep)
    t_merge = time.perf_counter() - t0

    spill_bytes = sum(
        p.stat().st_size
        for c in range(n_chunks)
        for p in (_chunk_dir(run_dir, c) / _SPILL).rglob("*")
        if p.is_file()
    )
    if not keep_spills:
        shutil.rmtree(run_dir)

    total = time.perf_counter() - t_start
    return BulkBuildStats(
        snapshot_path=str(final),
        n_docs=n_docs,
        n_chunks=n_chunks,
        workers=workers,
        docs_per_spill=dps,
        chunks_reused=chunks_reused,
        spills_reused=spills_reused,
        lemmatize_s=t_lem,
        spill_s=t_spill,
        merge_s=t_merge,
        total_s=total,
        docs_per_sec=(n_docs / total) if total > 0 else 0.0,
        spill_bytes=spill_bytes,
        timings={
            "lemmatize_s": t_lem,
            "spill_s": t_spill,
            "merge_s": t_merge,
            "total_s": total,
        },
    )
