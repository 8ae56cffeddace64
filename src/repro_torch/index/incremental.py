"""Incremental segment-based index construction with update/delete semantics.

The companion construction paper (Veretennikov, "An efficient algorithm for
three-component key index construction", arXiv 2006.07954) builds the §3
indexes from sorted sub-index runs that are merged; this module is that
architecture made *maintainable*: a production index that stays fresh under
document churn (arXiv 2009.03679's serving requirement) without whole-corpus
rebuilds.

Design
------

* **Segments** — documents are ingested in batches; ``commit()`` freezes the
  batch into an immutable sorted segment (a complete §3 ``IndexSet`` over the
  batch: ordinary + NSW + pair/triple/degenerate postings).  Per-document row
  generation is shared with ``build_indexes`` (``builder._RowAccumulator``),
  so a segment's per-document content is byte-identical to a from-scratch
  rebuild's.

* **Tombstones** — ``delete_document`` marks a doc id dead; queries filter
  tombstoned rows at segment-union time, so deletion is O(1) and visible
  immediately.  ``compact()`` physically drops dead rows.

* **Query-time union** — ``IncrementalIndexer.index`` is a
  :class:`SegmentedIndexSet`, an ``IndexSet`` whose posting dicts are lazy
  *merging* mappings: the first lookup of a key runs a vectorized k-way merge
  (concat + ``np.lexsort`` over the §4 lexicographic row order, honoring the
  NSW ragged offsets) of the per-segment arrays minus dead docs, and caches
  the result.  Every engine (scalar SE2.4, vectorized, fused, Pallas-kernel)
  serves over the view transparently and returns byte-identical fragments to
  a from-scratch rebuild of the surviving documents.

* **FL drift** — the FL-list is recomputed from surviving-document
  frequencies at each ``commit(refresh_fl=True)`` generation.  Row
  generation for a document depends ONLY on (a) the relative FL order and
  types of the document's own lemmas (``core.keys.lemma_order_signature``)
  and (b) absolute FL-numbers of stop lemmas, which reach posting storage
  only through NSW stop-lemma ids.  So on drift we re-key ONLY the affected
  postings: documents whose signature changed are superseded in place and
  re-indexed into the new generation's segment; every other document's
  postings are kept verbatim with a vectorized NSW stop-id remap.  This is
  exact — ``to_index_set()`` equals ``build_indexes`` over the survivors —
  and is the contract the differential test harness pins.

* **Compaction** — ``compact(memory_budget_bytes)`` greedily groups adjacent
  segments so each rewritten segment stays under the budget (the merge
  working set), materializes the group's union with dead rows dropped, and
  clears the now-physically-deleted tombstones.
"""

from __future__ import annotations

import time
from collections import Counter
from collections.abc import Mapping
from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence

import numpy as np

from ..core.keys import lemma_order_signature
from ..core.lemma import FLList, Lemmatizer
from .builder import IndexSet, NSWRecords, POSTING_WIDTH, build_segment
from .corpus import Document, DocumentStore

__all__ = [
    "IncrementalIndexer",
    "Segment",
    "SegmentedIndexSet",
    "as_index_set",
    "generation_token",
    "index_sets_equal",
    "merge_posting_arrays",
]

_WIDTH = POSTING_WIDTH

# ---------------------------------------------------------------------------
# vectorized k-way merge primitives
# ---------------------------------------------------------------------------


def _drop_dead_mask(doc_col: np.ndarray, dead: np.ndarray) -> np.ndarray:
    """Boolean keep-mask for rows whose doc id is NOT in sorted ``dead``."""
    if not len(dead) or not len(doc_col):
        return np.ones(len(doc_col), dtype=bool)
    i = np.searchsorted(dead, doc_col)
    i = np.minimum(i, len(dead) - 1)
    return dead[i] != doc_col


def merge_posting_arrays(arrays: Sequence[np.ndarray], width: int) -> np.ndarray:
    """K-way merge of sorted posting arrays into one §4-ordered array.

    Segments hold disjoint doc sets, so the merged lexicographic order is a
    permutation of the concatenation — one ``np.lexsort`` over all columns
    (last column least significant) reproduces a from-scratch sort exactly.
    """
    arrays = [a for a in arrays if len(a)]
    if not arrays:
        return np.empty((0, width), dtype=np.int32)
    if len(arrays) == 1:
        return arrays[0]
    merged = np.concatenate(arrays)
    order = np.lexsort(tuple(merged[:, c] for c in range(width - 1, -1, -1)))
    return merged[order]


def _merge_ordinary_nsw(
    parts: Sequence[tuple[np.ndarray, NSWRecords | None]],
) -> tuple[np.ndarray, NSWRecords | None]:
    """Merge per-segment (ordinary rows, parallel NSW) for one lemma.

    NSW offsets are ragged and parallel to the (doc, pos)-sorted ordinary
    array, so the merge permutation computed over the posting rows is applied
    to the per-posting *slice lengths*, and the payload is gathered with a
    repeat/arange ragged gather — no Python loop over postings.
    """
    parts = [(rows, rec) for rows, rec in parts if len(rows)]
    if not parts:
        return np.empty((0, 2), dtype=np.int32), None
    rows_list = [rows for rows, _ in parts]
    have_nsw = any(rec is not None for _, rec in parts)
    if len(rows_list) == 1:
        return parts[0]

    all_rows = np.concatenate(rows_list)
    order = np.lexsort((all_rows[:, 1], all_rows[:, 0]))
    merged_rows = all_rows[order]
    if not have_nsw:
        return merged_rows, None

    counts_list, starts_list, payload_sl, payload_d = [], [], [], []
    base = 0
    for rows, rec in parts:
        if not len(rows):
            continue
        assert rec is not None, "NSW present in some segments but not others"
        counts_list.append(np.diff(rec.offsets))
        starts_list.append(rec.offsets[:-1] + base)
        payload_sl.append(rec.stop_lemma)
        payload_d.append(rec.distance)
        base += len(rec.stop_lemma)
    counts = np.concatenate(counts_list)[order]
    starts = np.concatenate(starts_list)[order]
    sl = np.concatenate(payload_sl) if payload_sl else np.empty(0, np.int32)
    dist = np.concatenate(payload_d) if payload_d else np.empty(0, np.int32)

    offsets = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    total = int(offsets[-1])
    # ragged gather: element j of posting i reads payload[starts[i] + j]
    idx = (
        np.repeat(starts, counts)
        + np.arange(total, dtype=np.int64)
        - np.repeat(offsets[:-1], counts)
    )
    rec = NSWRecords(
        offsets=offsets,
        stop_lemma=sl[idx].astype(np.int32, copy=False),
        distance=dist[idx].astype(np.int32, copy=False),
    )
    return merged_rows, rec


def _filter_ordinary_nsw(
    rows: np.ndarray, rec: NSWRecords | None, dead: np.ndarray
) -> tuple[np.ndarray, NSWRecords | None]:
    """Drop tombstoned postings (and their ragged NSW slices) for one lemma."""
    if not len(dead) or not len(rows):
        return rows, rec
    keep = _drop_dead_mask(rows[:, 0], dead)
    if keep.all():
        return rows, rec
    rows = rows[keep]
    if rec is None:
        return rows, None
    counts = np.diff(rec.offsets)[keep]
    starts = rec.offsets[:-1][keep]
    offsets = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    total = int(offsets[-1])
    idx = (
        np.repeat(starts, counts)
        + np.arange(total, dtype=np.int64)
        - np.repeat(offsets[:-1], counts)
    )
    return rows, NSWRecords(
        offsets=offsets,
        stop_lemma=rec.stop_lemma[idx],
        distance=rec.distance[idx],
    )


# ---------------------------------------------------------------------------
# lazy merging mapping views
# ---------------------------------------------------------------------------


class _MergedPostings(Mapping):
    """Lazy union of one posting dict (pair/triple/...) across segments.

    A key's merged array is computed on first access (tombstone filter +
    k-way merge) and cached for the lifetime of the view; the indexer drops
    the whole view on any mutation, which drops every cache with it.
    """

    def __init__(self, contribs: list[tuple[IndexSet, np.ndarray]], fname: str):
        self._contribs = contribs
        self._field = fname
        self._width = _WIDTH[fname]
        self._cache: dict = {}
        self._keys: set | None = None

    def _key_union(self) -> set:
        if self._keys is None:
            keys: set = set()
            for idx, _ in self._contribs:
                keys.update(getattr(idx, self._field).keys())
            self._keys = keys
        return self._keys

    def __getitem__(self, key):
        try:
            return self._cache[key]
        except KeyError:
            pass
        parts = []
        present = False
        for idx, dead in self._contribs:
            a = getattr(idx, self._field).get(key)
            if a is None:
                continue
            present = True
            if len(dead) and len(a):
                a = a[_drop_dead_mask(a[:, 0], dead)]
            parts.append(a)
        if not present:
            raise KeyError(key)
        merged = merge_posting_arrays(parts, self._width)
        self._cache[key] = merged
        return merged

    def __iter__(self):
        return iter(self._key_union())

    def __len__(self):
        return len(self._key_union())

    def __contains__(self, key):
        return key in self._key_union()


class _MergedOrdinary(Mapping):
    """Ordinary-index view; stays offset-aligned with the NSW view by
    sharing one per-lemma merge (see ``SegmentedIndexSet._merged_lemma``)."""

    def __init__(self, view: "SegmentedIndexSet"):
        self._view = view

    def __getitem__(self, lemma):
        rows, _ = self._view._merged_lemma(lemma)
        return rows

    def __iter__(self):
        return iter(self._view._ordinary_keys())

    def __len__(self):
        return len(self._view._ordinary_keys())

    def __contains__(self, lemma):
        return lemma in self._view._ordinary_keys()


class _MergedNSW(Mapping):
    def __init__(self, view: "SegmentedIndexSet"):
        self._view = view

    def _keys(self) -> set:
        return {
            l
            for l in self._view._ordinary_keys()
            if self._view._merged_lemma(l)[1] is not None
        }

    def __getitem__(self, lemma):
        rec = self._view._merged_lemma(lemma)[1]
        if rec is None:
            raise KeyError(lemma)
        return rec

    def __iter__(self):
        return iter(self._keys())

    def __len__(self):
        return len(self._keys())

    def __contains__(self, lemma):
        return self._view._merged_lemma(lemma)[1] is not None if lemma in self._view._ordinary_keys() else False


class SegmentedIndexSet(IndexSet):
    """Query-time union of immutable segments minus tombstoned documents
    (DESIGN.md §10.1; posting merges preserve the §4 row order exactly).

    Duck-compatible with (and a subclass of) :class:`IndexSet`: the posting
    dict fields hold lazy merging mappings, ``key_postings`` and every engine
    work unchanged.  ``to_index_set()`` materializes the union into a plain
    ``IndexSet`` — byte-identical to ``build_indexes`` over the surviving
    documents (the differential harness pins this).
    """

    def __init__(
        self,
        fl: FLList,
        max_distance: int,
        contribs: list[tuple[IndexSet, np.ndarray]],
        n_docs: int,
    ):
        self._contribs = contribs
        self._lemma_cache: dict[str, tuple[np.ndarray, NSWRecords | None]] = {}
        self._ordinary_key_union: set | None = None
        IndexSet.__init__(
            self,
            fl=fl,
            max_distance=max_distance,
            ordinary=_MergedOrdinary(self),
            nsw=_MergedNSW(self),
            pair=_MergedPostings(contribs, "pair"),
            triple=_MergedPostings(contribs, "triple"),
            stop_single=_MergedPostings(contribs, "stop_single"),
            stop_pair=_MergedPostings(contribs, "stop_pair"),
            n_docs=n_docs,
        )

    # -- per-lemma ordinary + NSW (one shared merge keeps them aligned) -----

    def _ordinary_keys(self) -> set:
        if self._ordinary_key_union is None:
            keys: set = set()
            for idx, _ in self._contribs:
                keys.update(idx.ordinary.keys())
            self._ordinary_key_union = keys
        return self._ordinary_key_union

    def _merged_lemma(self, lemma: str) -> tuple[np.ndarray, NSWRecords | None]:
        try:
            return self._lemma_cache[lemma]
        except KeyError:
            pass
        if lemma not in self._ordinary_keys():
            raise KeyError(lemma)
        parts: list[tuple[np.ndarray, NSWRecords | None]] = []
        for idx, dead in self._contribs:
            rows = idx.ordinary.get(lemma)
            if rows is None:
                continue
            rows, rec = _filter_ordinary_nsw(rows, idx.nsw.get(lemma), dead)
            parts.append((rows, rec))
        out = _merge_ordinary_nsw(parts)
        self._lemma_cache[lemma] = out
        return out

    # -- materialization ----------------------------------------------------

    def to_index_set(self) -> IndexSet:
        """Force every merge; drop keys whose postings are fully tombstoned
        (a rebuild would not have them)."""
        ordinary: dict[str, np.ndarray] = {}
        nsw: dict[str, NSWRecords] = {}
        for lemma in sorted(self._ordinary_keys()):
            rows, rec = self._merged_lemma(lemma)
            if not len(rows):
                continue
            ordinary[lemma] = rows
            if rec is not None:
                nsw[lemma] = rec

        def materialize(mapping: Mapping) -> dict:
            out = {}
            for key in mapping:
                arr = mapping[key]
                if len(arr):
                    out[key] = arr
            return out

        return IndexSet(
            fl=self.fl,
            max_distance=self.max_distance,
            ordinary=ordinary,
            nsw=nsw,
            pair=materialize(self.pair),
            triple=materialize(self.triple),
            stop_single=materialize(self.stop_single),
            stop_pair=materialize(self.stop_pair),
            n_docs=self.n_docs,
        )


# ---------------------------------------------------------------------------
# the incremental indexer
# ---------------------------------------------------------------------------


@dataclass
class Segment:
    """One immutable sorted generation unit: a complete §3 ``IndexSet`` over
    one ingest batch (DESIGN.md §10.1).

    ``superseded`` lists docs re-keyed into a LATER segment after FL drift —
    they are filtered from this segment exactly like tombstones, but stay
    live in the index through their re-keyed copies.
    """

    index: IndexSet
    doc_ids: frozenset[int]
    superseded: set[int] = field(default_factory=set)

    def live_bytes(self) -> int:
        return self.index.size_bytes()["total"]


class IncrementalIndexer:
    """Segment-based incremental builder of the §3 multi-component indexes.

    Typical loop::

        ix = IncrementalIndexer(sw_count=80, fu_count=250, max_distance=5)
        ix.add_documents(["some text", ...])      # buffered
        ix.commit()                               # -> new immutable segment
        engine = SearchEngine(ix)                 # serves the live union view
        ix.delete_document(3)                     # tombstone, visible now
        ix.add_documents([...]); ix.commit()      # FL drift handled exactly
        ix.compact(memory_budget_bytes=64 << 20)  # physical merge + GC

    ``commit(refresh_fl=False)`` pins the current FL-list (the low-latency
    serving mode: no drift scan, exact w.r.t. a rebuild that passes the same
    ``fl``); the default recomputes the FL-list from surviving frequencies
    and re-keys drifted documents, staying exact w.r.t. a plain
    ``build_indexes`` rebuild.
    """

    def __init__(
        self,
        sw_count: int,
        fu_count: int,
        max_distance: int = 5,
        lemmatizer: Lemmatizer | None = None,
        build_pair: bool = True,
        build_degenerate: bool = True,
        use_fast_builder: bool = True,
    ):
        self.sw_count = sw_count
        self.fu_count = fu_count
        self.max_distance = max_distance
        self.lemmatizer = lemmatizer or Lemmatizer()
        self.build_pair = build_pair
        self.build_degenerate = build_degenerate
        # commit() routes segment construction through the vectorized
        # builder (§17.1) by default; the scalar build_segment stays the
        # oracle the property/differential suites compare against
        self.use_fast_builder = use_fast_builder
        self.fl: FLList | None = None
        self.segments: list[Segment] = []
        self.tombstones: set[int] = set()
        self.documents: dict[int, Document] = {}  # committed survivors
        self.generation = 0
        self._buffer: dict[int, Document] = {}
        self._freq: Counter = Counter()
        # per-doc unique lemma sets, cached at ingest (docs are immutable):
        # the drift scan tests set intersections instead of re-walking
        # lemma_streams, keeping commit cost off the token count
        self._doc_lemmas: dict[int, frozenset[str]] = {}
        self._next_id = 0
        self._view: SegmentedIndexSet | None = None
        # monotone mutation counter: bumped whenever the QUERY-VISIBLE state
        # changes (commit, committed delete, compact) — the cache-invalidation
        # token the serving frontend keys its LRU caches by (DESIGN.md §11)
        self._mutations = 0
        # restore epoch (DESIGN.md §12.5): 0 for a freshly built indexer,
        # bumped past the snapshot's stored epoch on every restore so tokens
        # from different boots of the same snapshot lineage never collide
        self._restore_epoch = 0
        # mutation listeners (DESIGN.md §13.2): called after every token
        # bump, so generation-keyed device caches (the posting arena) can
        # evict stale buffers eagerly instead of waiting for LRU pressure
        self._listeners: list = []
        # write-ahead log (DESIGN.md §18): when attached via enable_wal /
        # restore, every mutating op appends a durable record BEFORE the
        # in-memory state changes; None = §12 snapshot-only durability
        self.wal = None
        # stats of the last §18.2 replay this indexer was restored through
        self.last_wal_replay: dict = {"records": 0, "seconds": 0.0}

    def subscribe(self, callback):
        """Register ``callback(indexer)`` to run after every query-visible
        mutation (commit, committed delete, compact) — i.e. after every
        ``generation_token`` bump.  The serving-side consumer is
        ``PostingArena.attach`` (DESIGN.md §13.2), which evicts
        device-resident posting buffers keyed by tokens this indexer no
        longer serves.  Returns an unsubscribe callable (idempotent) —
        short-lived consumers over a long-lived indexer must call it (see
        ``PostingArena.detach``) or their closures outlive them.  Listeners
        are droppable accelerator state, so they are intentionally NOT part
        of snapshots (a restored indexer starts with none)."""
        self._listeners.append(callback)

        def unsubscribe() -> None:
            try:
                self._listeners.remove(callback)
            except ValueError:
                pass

        return unsubscribe

    def _notify(self) -> None:
        for cb in list(self._listeners):
            cb(self)

    @property
    def generation_token(self):
        """Token identifying the current query-visible index state — an int
        (the monotone mutation counter) for a freshly built indexer, or an
        ``(epoch, mutations)`` tuple after a snapshot restore (DESIGN.md
        §12.5).

        Bumps on every ``commit``, committed ``delete_document`` and
        ``compact`` — any event that can change the fragment set an engine
        serving this indexer would return.  Frontend caches (§11 of
        DESIGN.md) key entries by this token, so a generation bump
        invalidates them without any explicit flush; buffered (uncommitted)
        adds do not bump it because they are not query-visible yet.

        Across restarts (§12.5): ``restore`` resumes the stored mutation
        counter under a fresh epoch claimed from the snapshot lineage's
        persisted ``restore_epoch`` counter — strictly greater than the
        stored epoch AND any epoch an earlier boot of the same lineage
        claimed.  Equal tokens therefore still imply equal index states
        (even across sibling boots of one snapshot), and a state the
        *previous* process reached after the snapshot point can never share
        a token with a state this process reaches — pre-restart cached
        results are correctly invalidated, post-restart caches warm
        normally.
        """
        if self._restore_epoch:
            return (self._restore_epoch, self._mutations)
        return self._mutations

    # -- durability (DESIGN.md §12/§18; implementation in index/store.py
    # and index/wal.py) ----------------------------------------------------

    def enable_wal(self, lineage_dir, injector=None, shard=None):
        """Attach a §18 write-ahead log at ``<lineage_dir>/wal`` — the same
        lineage directory ``snapshot``/``restore`` use, so checkpoints,
        retention and replay share one root.  From this point every
        ``add``/``delete``/``commit``/``compact`` appends a durable record
        before mutating, and ``restore`` of this lineage replays the tail
        (the post-snapshot state is exact, not just the snapshot).
        ``injector``/``shard`` feed the §14 ``wal.*`` fault points.
        Returns the attached :class:`~repro_torch.index.wal.WriteAheadLog`."""
        from .wal import WriteAheadLog

        self.wal = WriteAheadLog(
            Path(lineage_dir) / "wal", injector=injector, shard=shard
        )
        return self.wal

    def snapshot(self, directory, keep: int = 2):
        """Freeze this indexer into ``<directory>/snap_<N>`` — the durable
        §12.2 on-disk form: delta+bitpacked segment stores, pre-lemmatized
        documents, tombstones, FL state and the §12.5 generation token.
        Atomic (tmp -> fsync -> rename) with ``keep``-newest retention;
        returns the published snapshot path.

        With a §18 WAL attached, the snapshot is also a WAL checkpoint:
        a ``checkpoint`` record anchors it in the log *before* it
        publishes (a crash in between leaves a dangling anchor that
        replays as a no-op), the active segment is sealed, and replayed
        prefixes beyond the retention window are truncated."""
        from .store import latest_snapshot, save_snapshot

        if self.wal is not None:
            prev = latest_snapshot(Path(directory))
            upcoming = 0 if prev is None else prev + 1
            self.wal.checkpoint(upcoming, self._mutations)
        path = save_snapshot(self, directory, keep=keep)
        if self.wal is not None:
            self.wal.prune(keep=keep)
        return path

    @classmethod
    def restore(
        cls,
        directory,
        snapshot_id: int | None = None,
        use_mmap: bool = True,
        verify: bool = True,
        lemmatizer: Lemmatizer | None = None,
        injector=None,
        replay_wal: bool = True,
    ) -> "IncrementalIndexer":
        """Warm-start an indexer from a §12.2 snapshot: segments serve
        lazily from ``mmap`` pages and nothing is re-lemmatized.  When the
        lineage has a §18 WAL (``<directory>/wal``), the tail logged after
        the restored snapshot's checkpoint is replayed on top, so the
        restored index is exact (``index_sets_equal``) vs the uncrashed
        live indexer *including post-snapshot commits* — the §18.2
        zero-data-loss contract; without a WAL it is exact vs the
        snapshotted view (the §12 contract), as before.  Raises
        ``StoreError`` on corruption.  ``injector`` is the §14
        fault-injection hook passed through to ``load_snapshot`` and the
        re-attached WAL (the chaos harness corrupts snapshot and WAL bytes
        for real there); ``replay_wal=False`` restores the bare snapshot.
        Replay stats land in ``last_wal_replay`` (record count, seconds)."""
        from .store import latest_snapshot, load_snapshot

        directory = Path(directory)
        ix = load_snapshot(
            directory,
            snapshot_id=snapshot_id,
            use_mmap=use_mmap,
            verify=verify,
            lemmatizer=lemmatizer,
            injector=injector,
        )
        wal_dir = directory / "wal"
        if wal_dir.exists():
            from .wal import WriteAheadLog
            from .wal import replay as wal_replay

            ix.wal = WriteAheadLog(wal_dir, injector=injector)
            if replay_wal:
                sid = (
                    snapshot_id
                    if snapshot_id is not None
                    else latest_snapshot(directory)
                )
                tail = ix.wal.tail_after_snapshot(sid)
                t0 = time.perf_counter()
                applied = wal_replay(ix, tail)
                ix.last_wal_replay = {
                    "records": applied,
                    "seconds": time.perf_counter() - t0,
                }
        return ix

    @classmethod
    def bulk_build(
        cls,
        texts: Sequence[str] | None = None,
        *,
        out_dir,
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
        resume: bool = False,
        keep_spills: bool = False,
        injector=None,
        lemmatizer: Lemmatizer | None = None,
        wal: bool = False,
    ) -> tuple["IncrementalIndexer", "object"]:
        """External-memory cold build (§17): SPIMI spill/merge straight to a
        published §12.2 snapshot, then warm-start an indexer from it.  The
        result is byte-identical to ``snapshot()`` after a one-commit build of
        the same corpus (the §17.4 determinism contract), but an order of
        magnitude faster because postings never round-trip through Python
        dicts.  Returns ``(indexer, BulkBuildStats)``.

        With ``wal=True`` the returned indexer gets a §18 write-ahead log
        attached under ``out_dir/wal`` anchored by a typed ``bulk_build``
        checkpoint record for the published snapshot, so incremental
        mutations after the cold build are crash-recoverable with zero
        committed-write loss (§18.2)."""
        from .ingest import bulk_build as _bulk_build

        stats = _bulk_build(
            texts,
            out_dir=out_dir,
            sw_count=sw_count,
            fu_count=fu_count,
            max_distance=max_distance,
            build_pair=build_pair,
            build_degenerate=build_degenerate,
            documents=documents,
            doc_ids=doc_ids,
            fl=fl,
            docs_per_spill=docs_per_spill,
            workers=workers,
            resume=resume,
            keep_spills=keep_spills,
            injector=injector,
        )
        ix = cls.restore(out_dir, lemmatizer=lemmatizer)
        if wal and ix.wal is None:
            from .store import latest_snapshot

            log = ix.enable_wal(out_dir, injector=injector)
            log.checkpoint(
                latest_snapshot(Path(out_dir)), ix._mutations, rtype="bulk_build"
            )
        return ix, stats

    # -- ingest / delete ----------------------------------------------------

    def add_documents(
        self,
        texts: Sequence[str],
        doc_ids: Sequence[int] | None = None,
    ) -> list[int]:
        """Buffer documents for the next ``commit``; returns their doc ids.

        ``doc_ids`` lets a router (e.g. the sharded service) assign globally
        unique ids; they must be fresh — tombstoned ids are never reused.
        """
        if doc_ids is not None and len(doc_ids) != len(texts):
            raise ValueError("doc_ids must parallel texts")
        base = self._next_id
        docs = [
            Document(
                doc_id=base + i if doc_ids is None else int(doc_ids[i]),
                text=text,
                lemma_stream=self.lemmatizer.lemmatize_text(text),
            )
            for i, text in enumerate(texts)
        ]
        return self.add_prelemmatized(docs)

    def add_prelemmatized(self, documents: Sequence[Document]) -> list[int]:
        """Ingest documents that already carry a ``lemma_stream`` (e.g. from
        a ``DocumentStore``) without re-lemmatizing; doc ids are taken from
        the documents and must be fresh.  The batch is validated up front
        and (with a §18 WAL attached) logged as ONE durable ``add`` record
        carrying the pre-lemmatized payloads BEFORE any buffer mutates —
        a batch either appends entirely or raises without side effects."""
        docs = list(documents)
        seen: set[int] = set()
        for doc in docs:
            if (
                doc.doc_id in self.documents
                or doc.doc_id in self._buffer
                or doc.doc_id in self.tombstones
                or doc.doc_id in seen
            ):
                raise ValueError(f"doc id {doc.doc_id} already used")
            seen.add(doc.doc_id)
        if self.wal is not None and docs:
            from .wal import docs_to_payload

            self.wal.append("add", {"docs": docs_to_payload(docs)})
        for doc in docs:
            self._ingest(doc)
        return [doc.doc_id for doc in docs]

    def _ingest(self, doc: Document) -> None:
        doc_id = doc.doc_id
        if (
            doc_id in self.documents
            or doc_id in self._buffer
            or doc_id in self.tombstones
        ):
            raise ValueError(f"doc id {doc_id} already used")
        self._next_id = max(self._next_id, doc_id + 1)
        self._buffer[doc_id] = doc
        self._freq.update(l for lemmas in doc.lemma_stream for l in lemmas)
        self._doc_lemmas[doc_id] = frozenset(
            l for lemmas in doc.lemma_stream for l in lemmas
        )

    def delete_document(self, doc_id: int) -> None:
        """Tombstone a committed doc (effective immediately at query time) or
        drop it from the ingest buffer.  Raises ``KeyError`` if unknown.
        With a §18 WAL attached the delete is durably logged before it
        applies (unknown ids raise without logging)."""
        if doc_id not in self._buffer and doc_id not in self.documents:
            raise KeyError(doc_id)
        if self.wal is not None:
            self.wal.append("delete", {"doc_id": int(doc_id)})
        if doc_id in self._buffer:
            doc = self._buffer.pop(doc_id)
        elif doc_id in self.documents:
            doc = self.documents.pop(doc_id)
            self.tombstones.add(doc_id)
            self._view = None  # tombstone filter must take effect
            self._mutations += 1  # query-visible: invalidate frontend caches
            self._notify()
        else:
            raise KeyError(doc_id)
        self._doc_lemmas.pop(doc_id, None)
        self._freq.subtract(l for lemmas in doc.lemma_stream for l in lemmas)

    def surviving_frequencies(self) -> dict[str, int]:
        """Lemma frequencies over committed survivors + the ingest buffer —
        exactly ``DocumentStore.lemma_frequencies()`` of a rebuild corpus."""
        return {l: n for l, n in self._freq.items() if n > 0}

    # -- generations --------------------------------------------------------

    def commit(self, refresh_fl: bool = True, fl: FLList | None = None) -> dict:
        """Freeze the ingest buffer into a new immutable segment.

        With ``refresh_fl`` (or an explicit ``fl`` from a corpus-level
        reduce), the FL-list moves to the new generation and drifted
        documents are re-keyed (see module docstring).  Returns a generation
        report: ``{"new_docs", "rekeyed_docs", "drifted_lemmas", "segments"}``.

        With a §18 WAL attached, the commit's *resolved* FL (explicit,
        refreshed from surviving frequencies, or kept) is computed first
        and durably logged before any state mutates — so replaying the
        record on another process reproduces this commit exactly, even
        when the FL came from a corpus-level reduce this shard could not
        recompute alone (§18.2).
        """
        if self.wal is not None:
            from .wal import fl_to_payload

            if fl is not None:
                resolved = fl
            elif refresh_fl or self.fl is None:
                resolved = FLList.from_frequencies(
                    self.surviving_frequencies(),
                    sw_count=self.sw_count,
                    fu_count=self.fu_count,
                )
            else:
                resolved = self.fl
            self.wal.append("commit", {"fl": fl_to_payload(resolved)})
            fl = resolved
        new_docs = list(self._buffer.values())
        self._buffer = {}
        if fl is not None:
            new_fl = fl
        elif refresh_fl or self.fl is None:
            new_fl = FLList.from_frequencies(
                self.surviving_frequencies(),
                sw_count=self.sw_count,
                fu_count=self.fu_count,
            )
        else:
            new_fl = self.fl

        rekeyed: list[Document] = []
        n_drifted = 0
        if self.fl is not None and new_fl is not self.fl:
            rekeyed, n_drifted = self._rekey_drifted(self.fl, new_fl)
        self.fl = new_fl

        batch = rekeyed + new_docs
        if batch:
            if self.use_fast_builder:
                from .fastbuild import build_segment_fast as _builder
            else:
                _builder = build_segment
            seg_index = _builder(
                batch,
                new_fl,
                max_distance=self.max_distance,
                build_pair=self.build_pair,
                build_degenerate=self.build_degenerate,
            )
            self.segments.append(
                Segment(index=seg_index, doc_ids=frozenset(d.doc_id for d in batch))
            )
        for doc in new_docs:
            self.documents[doc.doc_id] = doc
        self.generation += 1
        self._view = None
        self._mutations += 1
        self._notify()
        return {
            "new_docs": len(new_docs),
            "rekeyed_docs": len(rekeyed),
            "drifted_lemmas": n_drifted,
            "segments": len(self.segments),
        }

    def _rekey_drifted(
        self, old_fl: FLList, new_fl: FLList
    ) -> tuple[list[Document], int]:
        """FL-drift handling: supersede-and-reindex ONLY affected documents.

        A document is affected iff its ``lemma_order_signature`` changed —
        the exact invariance condition of per-document row generation.  For
        every kept document, stored postings remain valid except the NSW
        stop-lemma ids (absolute FL-numbers), which are remapped in bulk.
        """
        changed: set[str] = set()
        for l in set(old_fl.fl_number) | set(new_fl.fl_number):
            if l not in old_fl.fl_number or l not in new_fl.fl_number:
                # absent lemmas share one sentinel FL-number: always drifted
                changed.add(l)
            elif old_fl.fl_number[l] != new_fl.fl_number[l] or old_fl.lemma_type(
                l
            ) != new_fl.lemma_type(l):
                changed.add(l)
        if not changed:
            return [], 0

        rekeyed: list[Document] = []
        for seg in self.segments:
            live = seg.doc_ids - self.tombstones - seg.superseded
            for doc_id in live:
                doc = self.documents[doc_id]
                lemmas = self._doc_lemmas[doc_id]
                if not (lemmas & changed):
                    continue
                # the signature IS the invariance condition: it orders
                # sentinel-tied (FL-unknown) lemmas deterministically by
                # string and carries each lemma's type, so comparing it
                # re-keys exactly the docs whose rows could differ — a
                # lemma merely ENTERING the FL list (e.g. under a pinned
                # shard-global FL) does not re-key docs whose relative
                # order and types are unchanged
                if lemma_order_signature(lemmas, old_fl) != lemma_order_signature(
                    lemmas, new_fl
                ):
                    seg.superseded.add(doc_id)
                    rekeyed.append(doc)

        # bulk NSW remap for kept docs: old stop FL-number -> new FL-number.
        # Stop lemmas that left the stop class only occur in superseded or
        # dead docs (a type change flips the signature), so -1 never serves.
        remap = np.full(max(old_fl.sw_count, 1), -1, dtype=np.int32)
        remap_needed = False
        for l, old_n in old_fl.fl_number.items():
            if old_n >= old_fl.sw_count:
                continue
            new_n = new_fl.fl_number.get(l)
            if new_n is not None and new_n < new_fl.sw_count:
                remap[old_n] = new_n
                if new_n != old_n:
                    remap_needed = True
        if remap_needed:
            for seg in self.segments:
                for lemma, rec in list(seg.index.nsw.items()):
                    if len(rec.stop_lemma):
                        # replace, don't mutate: materialized to_index_set()
                        # snapshots may share the NSWRecords object (single-
                        # contributor merges return originals) and must stay
                        # consistent with their pinned FL generation
                        seg.index.nsw[lemma] = NSWRecords(
                            offsets=rec.offsets,
                            stop_lemma=remap[rec.stop_lemma],
                            distance=rec.distance,
                        )
        return rekeyed, len(changed)

    # -- compaction ---------------------------------------------------------

    def compact(self, memory_budget_bytes: int | None = None) -> dict:
        """Rewrite segments: k-way merge adjacent segments into as few as the
        ``memory_budget_bytes`` working-set bound allows, physically dropping
        tombstoned and superseded rows; clears the collected tombstones.
        With a §18 WAL attached the compaction (a deterministic function
        of the budget and current state) is durably logged before it runs.
        """
        if not self.segments:
            return {"segments": 0, "collected": 0}
        if self.wal is not None:
            self.wal.append("compact", {"memory_budget_bytes": memory_budget_bytes})
        groups: list[list[Segment]] = []
        cur: list[Segment] = []
        cur_bytes = 0
        for seg in self.segments:
            nbytes = seg.live_bytes()
            if cur and memory_budget_bytes and cur_bytes + nbytes > memory_budget_bytes:
                groups.append(cur)
                cur, cur_bytes = [], 0
            cur.append(seg)
            cur_bytes += nbytes
        groups.append(cur)

        new_segments: list[Segment] = []
        collected = 0
        for group in groups:
            dead_ids = set()
            for seg in group:
                dead_ids |= (seg.doc_ids & self.tombstones) | seg.superseded
            if len(group) == 1 and not dead_ids:
                new_segments.append(group[0])
                continue
            contribs = [
                (seg.index, self._dead_array(seg)) for seg in group
            ]
            # liveness is per segment: a doc superseded in one segment may be
            # live through its re-keyed copy in another segment of the group
            live_ids = frozenset().union(
                *(
                    seg.doc_ids - seg.superseded - self.tombstones
                    for seg in group
                )
            )
            view = SegmentedIndexSet(
                fl=self.fl
                or FLList.from_frequencies(
                    {}, sw_count=self.sw_count, fu_count=self.fu_count
                ),
                max_distance=self.max_distance,
                contribs=contribs,
                n_docs=len(live_ids),
            )
            merged = view.to_index_set()
            new_segments.append(Segment(index=merged, doc_ids=live_ids))
            # a tombstone is collectable only once its LIVE (non-superseded)
            # copy is physically gone — superseded copies in other groups are
            # filtered by their segment's superseded set, not the tombstone
            dropped_tombstones = set()
            for seg in group:
                dropped_tombstones |= (seg.doc_ids & self.tombstones) - seg.superseded
            self.tombstones -= dropped_tombstones
            collected += len(dropped_tombstones)
        self.segments = new_segments
        self._view = None
        self._mutations += 1
        self._notify()
        return {"segments": len(self.segments), "collected": collected}

    # -- the live view ------------------------------------------------------

    def _dead_array(self, seg: Segment) -> np.ndarray:
        dead = (seg.doc_ids & self.tombstones) | seg.superseded
        return np.asarray(sorted(dead), dtype=np.int64)

    @property
    def index(self) -> SegmentedIndexSet:
        """The live multi-segment ``IndexSet`` view (cached per mutation)."""
        if self._view is None:
            fl = self.fl or FLList.from_frequencies(
                {}, sw_count=self.sw_count, fu_count=self.fu_count
            )
            contribs = [(seg.index, self._dead_array(seg)) for seg in self.segments]
            self._view = SegmentedIndexSet(
                fl=fl,
                max_distance=self.max_distance,
                contribs=contribs,
                n_docs=len(self.documents),
            )
        return self._view

    def surviving_store(self) -> DocumentStore:
        """The rebuild corpus: committed survivors in doc-id order."""
        return DocumentStore.from_documents(
            (self.documents[i] for i in sorted(self.documents)),
            lemmatizer=self.lemmatizer,
        )

    def rebuild_index_set(self) -> IndexSet:
        """From-scratch ``build_indexes`` over the survivors — the oracle the
        differential harness compares ``index.to_index_set()`` against."""
        from .builder import build_indexes

        return build_indexes(
            self.surviving_store(),
            sw_count=self.sw_count,
            fu_count=self.fu_count,
            max_distance=self.max_distance,
            build_pair=self.build_pair,
            build_degenerate=self.build_degenerate,
        )


def as_index_set(obj) -> IndexSet:
    """Engines accept either a plain §3 ``IndexSet`` or an
    ``IncrementalIndexer`` (resolved to its live DESIGN.md §10 view per
    call, so commits/deletes are picked up)."""
    if isinstance(obj, IncrementalIndexer):
        return obj.index
    return obj


def generation_token(obj) -> object:
    """The cache-invalidation token for any index source (DESIGN.md §11).

    * ``IncrementalIndexer`` (or anything exposing ``generation_token``,
      e.g. ``ShardedSearchService``) — its monotone mutation token;
    * plain ``IndexSet`` — the constant 0 (immutable snapshot, caches never
      go stale).

    Frontend LRU caches key every entry by this token: a bump makes all old
    entries unreachable (natural invalidation, eventual LRU eviction).
    """
    tok = getattr(obj, "generation_token", None)
    if tok is None:
        return 0
    return tok


# ---------------------------------------------------------------------------
# structural equality (the differential harness' pin)
# ---------------------------------------------------------------------------


def _nsw_equal(a: NSWRecords, b: NSWRecords) -> bool:
    return (
        np.array_equal(a.offsets, b.offsets)
        and np.array_equal(a.stop_lemma, b.stop_lemma)
        and np.array_equal(a.distance, b.distance)
    )


def index_sets_equal(a: IndexSet, b: IndexSet) -> tuple[bool, str]:
    """Byte-level structural equality of two §3 index sets — the
    incremental == rebuild pin of DESIGN.md §10.3.

    Returns ``(equal, reason)`` — the reason names the first divergence so a
    failing differential test points straight at the broken layer.
    """
    if a.max_distance != b.max_distance:
        return False, f"max_distance {a.max_distance} != {b.max_distance}"
    if a.n_docs != b.n_docs:
        return False, f"n_docs {a.n_docs} != {b.n_docs}"
    if a.fl.lemmas != b.fl.lemmas:
        return False, "fl.lemmas order differs"
    if a.fl.frequency != b.fl.frequency:
        return False, "fl.frequency differs"
    if (a.fl.sw_count, a.fl.fu_count) != (b.fl.sw_count, b.fl.fu_count):
        return False, "fl sw/fu counts differ"
    for fname in ("ordinary", "pair", "triple", "stop_single", "stop_pair"):
        da, db = getattr(a, fname), getattr(b, fname)
        ka, kb = set(da.keys()), set(db.keys())
        if ka != kb:
            return False, f"{fname} key sets differ (e.g. {sorted(ka ^ kb)[:3]})"
        for key in ka:
            if not np.array_equal(da[key], db[key]):
                return False, f"{fname}[{key!r}] rows differ"
    ka, kb = set(a.nsw.keys()), set(b.nsw.keys())
    if ka != kb:
        return False, f"nsw key sets differ (e.g. {sorted(ka ^ kb)[:3]})"
    for key in ka:
        if not _nsw_equal(a.nsw[key], b.nsw[key]):
            return False, f"nsw[{key!r}] differs"
    return True, "equal"
