"""Index builder (paper §3): ordinary index with NSW records, two-component
(w,v) indexes and three-component (f,s,t) indexes, all as sorted numpy arrays.

Posting layouts (int32, lexicographically sorted rows — the §4 order):

  ordinary:          (doc, pos)
  (w,v)    arity 2:  (doc, pos_w, d_v)               |d| <= MaxDistance
  (f,s,t)  arity 3:  (doc, pos_f, d1_s, d2_t)        |d1|,|d2| <= MaxDistance

Three-component keys are built for stop-lemma triples with FL(f)<=FL(s)<=FL(t)
(paper: "only when f, s, and t are all stop lemmas and only for f <= s <= t").
When s == t the (d1, d2) pair enumerates *unordered distinct* occurrence pairs
with d1 < d2 (exactly the paper's (be, who, who) example records).

NSW (near-stop-word) records attach, to every ordinary posting of a
frequently-used/ordinary lemma, the stop lemmas within MaxDistance — stored as
a ragged (offsets, lemma_id, distance) triple.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

from ..core.lemma import FLList, LemmaType
from .corpus import DocumentStore

__all__ = ["IndexSet", "build_indexes", "build_segment", "NSWRecords", "POSTING_WIDTH"]

_POSTING_BYTES = {1: 8, 2: 12, 3: 16}  # int32 record sizes per key arity

# §4 row widths (int32 columns) per posting family — the ONE table the
# incremental merge layer and the on-disk store both key their layouts by
POSTING_WIDTH = {
    "ordinary": 2,
    "stop_single": 2,
    "pair": 3,
    "stop_pair": 3,
    "triple": 4,
}


@dataclass
class NSWRecords:
    """Ragged §3 near-stop-word records parallel to an ordinary posting
    array: per posting, the stop lemmas within MaxDistance and their signed
    distances (stop lemma ids are absolute FL-numbers — the one place they
    reach storage, see DESIGN.md §10.2)."""

    offsets: np.ndarray  # (n_postings + 1,) int64
    stop_lemma: np.ndarray  # (total,) int32 FL-numbers
    distance: np.ndarray  # (total,) int32


@dataclass
class IndexSet:
    """Everything §3 defines, over one document shard."""

    fl: FLList
    max_distance: int
    # ordinary inverted index: lemma -> (n,2) [doc, pos]
    ordinary: dict[str, np.ndarray]
    # NSW records parallel to `ordinary` for FU/ordinary lemmas
    nsw: dict[str, NSWRecords]
    # multi-component indexes keyed by canonical lemma tuples
    pair: dict[tuple[str, str], np.ndarray]
    triple: dict[tuple[str, str, str], np.ndarray]
    # degenerate stop-lemma keys for 1/2-lemma subqueries (paper §14 allows
    # "any multi-component indexes and one-component indexes")
    stop_single: dict[tuple[str], np.ndarray] = field(default_factory=dict)
    stop_pair: dict[tuple[str, str], np.ndarray] = field(default_factory=dict)
    n_docs: int = 0

    def key_postings(self, key: tuple[str, ...]) -> np.ndarray:
        """Postings for a canonical key of any arity (empty if absent)."""
        if len(key) == 3:
            return self.triple.get(key, _EMPTY3)
        if len(key) == 2:
            arr = self.stop_pair.get(key)
            if arr is None:
                arr = self.pair.get(key, _EMPTY2)
            return arr
        return self.stop_single.get(key, _EMPTY1)

    def size_bytes(self) -> dict[str, int]:
        ordinary = sum(a.nbytes for a in self.ordinary.values())
        nsw = sum(r.stop_lemma.nbytes + r.distance.nbytes + r.offsets.nbytes for r in self.nsw.values())
        pair = sum(a.nbytes for a in self.pair.values())
        triple = sum(a.nbytes for a in self.triple.values())
        extra = sum(a.nbytes for a in self.stop_single.values()) + sum(
            a.nbytes for a in self.stop_pair.values()
        )
        return {
            "ordinary": ordinary,
            "nsw": nsw,
            "pair": pair,
            "triple": triple,
            "stop_degenerate": extra,
            "total": ordinary + nsw + pair + triple + extra,
        }


_EMPTY1 = np.empty((0, 2), dtype=np.int32)
_EMPTY2 = np.empty((0, 3), dtype=np.int32)
_EMPTY3 = np.empty((0, 4), dtype=np.int32)


def _sorted_rows(rows: list[tuple[int, ...]], width: int) -> np.ndarray:
    if not rows:
        return np.empty((0, width), dtype=np.int32)
    arr = np.asarray(rows, dtype=np.int32)
    order = np.lexsort(tuple(arr[:, c] for c in range(arr.shape[1] - 1, -1, -1)))
    return arr[order]


class _RowAccumulator:
    """Per-document §3 row generation.

    The unit of construction is ONE document: ``add_document`` appends every
    row the document contributes to every index, and ``finalize`` sorts/packs
    the accumulated rows into an immutable :class:`IndexSet`.  Whole-corpus
    builds (``build_indexes``) and incremental segment builds
    (``build_segment``, used by ``index/incremental.py``) share this code, so
    a segment over a document batch is byte-identical to the corresponding
    slice of a full rebuild.
    """

    def __init__(
        self,
        fl: FLList,
        max_distance: int,
        build_pair: bool = True,
        build_degenerate: bool = True,
        triple_key_filter: set[tuple[str, str, str]] | None = None,
    ):
        self.fl = fl
        self.max_distance = max_distance
        self.build_pair = build_pair
        self.build_degenerate = build_degenerate
        self.triple_key_filter = triple_key_filter
        self.ordinary_rows: dict[str, list[tuple[int, int]]] = {}
        self.pair_rows: dict[tuple[str, str], list[tuple[int, int, int]]] = {}
        self.triple_rows: dict[tuple[str, str, str], list[tuple[int, int, int, int]]] = {}
        self.single_rows: dict[tuple[str], list[tuple[int, int]]] = {}
        self.spair_rows: dict[tuple[str, str], list[tuple[int, int, int]]] = {}
        self.nsw_raw: dict[str, list[list[tuple[int, int]]]] = {}

    def add_document(self, doc) -> None:
        fl = self.fl
        D = self.max_distance
        build_pair = self.build_pair
        build_degenerate = self.build_degenerate
        triple_key_filter = self.triple_key_filter
        ordinary_rows = self.ordinary_rows
        pair_rows = self.pair_rows
        triple_rows = self.triple_rows
        single_rows = self.single_rows
        spair_rows = self.spair_rows
        nsw_raw = self.nsw_raw
        # occurrence list: (pos, lemma) for every lemma of every position
        occ: list[tuple[int, str]] = []
        for pos, lemmas in enumerate(doc.lemma_stream):
            for l in lemmas:
                occ.append((pos, l))
        n = len(occ)
        types = [fl.lemma_type(l) for _, l in occ]
        numbers = [fl.number(l) for _, l in occ]

        # ---- ordinary index + NSW ---------------------------------------
        for (pos, l), t in zip(occ, types):
            ordinary_rows.setdefault(l, []).append((doc.doc_id, pos))
            if t != LemmaType.STOP:
                near: list[tuple[int, int]] = []
                for (p2, l2), t2 in zip(occ, types):
                    if t2 == LemmaType.STOP and abs(p2 - pos) <= D:
                        near.append((fl.number(l2), p2 - pos))
                nsw_raw.setdefault(l, []).append(near)
            elif build_degenerate:
                single_rows.setdefault((l,), []).append((doc.doc_id, pos))

        # ---- windowed co-occurrence scan ---------------------------------
        # occ is sorted by position (multi-lemma entries share a position).
        for i in range(n):
            pi, li = occ[i]
            ti, ni = types[i], numbers[i]
            # neighbours within +-D of occurrence i (excluding i itself)
            lo = i
            while lo > 0 and occ[lo - 1][0] >= pi - D:
                lo -= 1
            hi = i
            while hi + 1 < n and occ[hi + 1][0] <= pi + D:
                hi += 1
            neigh = [j for j in range(lo, hi + 1) if j != i]

            # (w,v) index: w frequently used, v FU-or-ordinary;
            # if both FU then only w < v.
            if build_pair and ti == LemmaType.FREQUENTLY_USED:
                for j in neigh:
                    pj, lj = occ[j]
                    tj, nj = types[j], numbers[j]
                    if tj == LemmaType.STOP:
                        continue
                    if tj == LemmaType.FREQUENTLY_USED and not (ni < nj):
                        continue
                    pair_rows.setdefault((li, lj), []).append((doc.doc_id, pi, pj - pi))

            if ti != LemmaType.STOP:
                continue

            # stop-lemma neighbours only, for (f,s,t) and (f,s) keys
            sneigh = [j for j in neigh if types[j] == LemmaType.STOP]

            if build_degenerate:
                for j in sneigh:
                    pj, lj, nj = occ[j][0], occ[j][1], numbers[j]
                    if ni < nj or (ni == nj and pi < pj):
                        spair_rows.setdefault((li, lj), []).append((doc.doc_id, pi, pj - pi))

            # center occurrence i is an occurrence of f; every pair (j,k)
            # of stop neighbours with FL(f) <= FL(s) <= FL(t) yields a record.
            m = len(sneigh)
            for a in range(m):
                j = sneigh[a]
                pj, lj, nj = occ[j][0], occ[j][1], numbers[j]
                if nj < ni:
                    continue  # f must be the most frequent of the triple
                for b in range(m):
                    if b == a:
                        continue
                    k = sneigh[b]
                    pk, lk, nk = occ[k][0], occ[k][1], numbers[k]
                    if nk < ni:
                        continue
                    # canonical order inside (s, t)
                    if nj > nk:
                        continue  # handled when (a, b) swapped
                    if nj == nk:
                        # same lemma rank: unordered distinct pair, d1 < d2
                        if not (pj < pk or (pj == pk and b < a)):
                            continue
                    key = (li, lj, lk)
                    if triple_key_filter is not None and key not in triple_key_filter:
                        continue
                    triple_rows.setdefault(key, []).append(
                        (doc.doc_id, pi, pj - pi, pk - pi)
                    )

    def finalize(self, n_docs: int) -> IndexSet:
        ordinary = {l: _sorted_rows(r, 2) for l, r in self.ordinary_rows.items()}

        # pack NSW records aligned with the *sorted* ordinary posting order
        nsw: dict[str, NSWRecords] = {}
        for l, per_posting in self.nsw_raw.items():
            rows = self.ordinary_rows[l]
            order = np.lexsort(
                (np.asarray([p for _, p in rows]), np.asarray([d for d, _ in rows]))
            )
            offsets = [0]
            stop_l: list[int] = []
            dist: list[int] = []
            for idx in order:
                for sl, dd in per_posting[idx]:
                    stop_l.append(sl)
                    dist.append(dd)
                offsets.append(len(stop_l))
            nsw[l] = NSWRecords(
                offsets=np.asarray(offsets, dtype=np.int64),
                stop_lemma=np.asarray(stop_l, dtype=np.int32),
                distance=np.asarray(dist, dtype=np.int32),
            )

        return IndexSet(
            fl=self.fl,
            max_distance=self.max_distance,
            ordinary=ordinary,
            nsw=nsw,
            pair={k: _sorted_rows(r, 3) for k, r in self.pair_rows.items()},
            triple={k: _sorted_rows(r, 4) for k, r in self.triple_rows.items()},
            stop_single={k: _sorted_rows(r, 2) for k, r in self.single_rows.items()},
            stop_pair={k: _sorted_rows(r, 3) for k, r in self.spair_rows.items()},
            n_docs=n_docs,
        )


def build_indexes(
    store: DocumentStore,
    sw_count: int,
    fu_count: int,
    max_distance: int = 5,
    build_pair: bool = True,
    build_degenerate: bool = True,
    triple_key_filter: set[tuple[str, str, str]] | None = None,
    fl: FLList | None = None,
) -> IndexSet:
    """Build every §3 index over ``store``.

    ``triple_key_filter`` restricts the (f,s,t) build to a key subset —
    used by large-corpus benchmarks to bound build time exactly like an
    on-demand index materialization would.  ``fl`` overrides the FL-list
    (document shards must share the corpus-global lemma typing — in
    production the FL-list is a corpus-level reduce broadcast to builders).
    """
    if fl is None:
        freq = store.lemma_frequencies()
        fl = FLList.from_frequencies(freq, sw_count=sw_count, fu_count=fu_count)
    return build_segment(
        store.documents,
        fl,
        max_distance=max_distance,
        build_pair=build_pair,
        build_degenerate=build_degenerate,
        triple_key_filter=triple_key_filter,
    )


def build_segment(
    documents: Sequence,
    fl: FLList,
    max_distance: int = 5,
    build_pair: bool = True,
    build_degenerate: bool = True,
    triple_key_filter: set[tuple[str, str, str]] | None = None,
) -> IndexSet:
    """Build one immutable sorted segment over a document batch.

    This is the incremental-construction unit (``index/incremental.py``): a
    segment is a complete §3 ``IndexSet`` over its batch, and because row
    generation is per-document, a segment's per-document content is
    byte-identical to a whole-corpus rebuild's — k-way segment merges can
    therefore reproduce a from-scratch build exactly.
    """
    acc = _RowAccumulator(
        fl,
        max_distance,
        build_pair=build_pair,
        build_degenerate=build_degenerate,
        triple_key_filter=triple_key_filter,
    )
    for doc in documents:
        acc.add_document(doc)
    return acc.finalize(n_docs=len(documents))
