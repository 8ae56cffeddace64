"""Baseline search algorithms (paper §4, experiments SE1 and SE2.1–SE2.3).

All of these are prior work the paper compares against; the paper's own
contribution (SE2.4, the Combiner) lives in ``combiner.py``.  Every algorithm
returns ``(results, stats)`` where ``stats`` carries the §11 metrics.

* ``se1_ordinary``       — DAAT merge over the plain inverted index (Idx1).
* ``se21_main_cell``     — Main-Cell [17]: the main lemma is the first
  component of every key; all iterators are aligned on (ID, P).
* ``se22_intermediate``  — Intermediate-Lists [14]: simple key cover, per-doc
  intermediate per-lemma streams, then merged.
* ``se23_optimized``     — Optimized-Intermediate-Lists [15]: §6 key
  selection, but still materializes intermediate streams.
"""

from __future__ import annotations

import heapq
import time
from typing import Mapping, Sequence

import numpy as np

from ..index.builder import IndexSet
from .keys import SelectedKey, Subquery, select_keys
from .lemma import FLList
from .oracle import sweep_events
from .postings import KeyIterator, QueryStats, SearchResult

__all__ = [
    "se1_ordinary",
    "se21_main_cell",
    "se22_intermediate",
    "se23_optimized",
    "simple_key_cover",
    "main_cell_keys",
]


# ---------------------------------------------------------------------------
# SE1 — ordinary inverted index
# ---------------------------------------------------------------------------


def se1_ordinary(
    subquery: Subquery, index: IndexSet
) -> tuple[list[SearchResult], QueryStats]:
    """Full posting-list DAAT merge (the paper's 193-million-postings case).

    The ordinary index must be read in full for every query lemma — this is
    precisely the cost the multi-component indexes exist to avoid.
    """
    stats = QueryStats()
    t0 = time.perf_counter()
    mult = subquery.multiplicity()
    lists: dict[str, np.ndarray] = {}
    for lemma in mult:
        rows = index.ordinary.get(lemma)
        if rows is None or not len(rows):
            stats.elapsed_sec = time.perf_counter() - t0
            return [], stats  # some lemma never occurs -> no results
        lists[lemma] = rows
        stats.postings_read += len(rows)
        stats.bytes_read += rows.nbytes

    # document-level intersection
    doc_sets = [np.unique(rows[:, 0]) for rows in lists.values()]
    docs = doc_sets[0]
    for ds in doc_sets[1:]:
        docs = np.intersect1d(docs, ds, assume_unique=True)

    results: list[SearchResult] = []
    max_span = 2 * index.max_distance
    for doc in docs.tolist():
        # heap-merge the per-lemma position streams within the document
        streams = []
        for lemma, rows in lists.items():
            lo = np.searchsorted(rows[:, 0], doc, side="left")
            hi = np.searchsorted(rows[:, 0], doc, side="right")
            streams.append([(int(p), lemma) for p in rows[lo:hi, 1]])
        merged: list[tuple[int, str]] = []
        heap = [(s[0], i, 0) for i, s in enumerate(streams) if s]
        heapq.heapify(heap)
        while heap:
            head, si, ei = heapq.heappop(heap)
            stats.heap_ops += 1
            merged.append(head)
            if ei + 1 < len(streams[si]):
                heapq.heappush(heap, (streams[si][ei + 1], si, ei + 1))
        # dedup (multi-lemma positions can repeat)
        merged = sorted(set(merged))
        results.extend(sweep_events(doc, merged, mult, max_span=max_span))
    stats.results = len(results)
    stats.elapsed_sec = time.perf_counter() - t0
    return results, stats


# ---------------------------------------------------------------------------
# key covers used by the baselines
# ---------------------------------------------------------------------------


def simple_key_cover(subquery: Subquery, fl: FLList) -> list[SelectedKey]:
    """SE2.2's unoptimized cover [14]: FL-sorted unique lemmas chunked into
    consecutive triples; a short final chunk is padded by reusing earlier
    lemmas *unstarred* (they produce redundant stream records — the
    inefficiency §6 was designed to remove)."""
    uniq = sorted(subquery.unique_lemmas(), key=fl.number)
    if not uniq:
        return []
    arity = min(3, max(1, len(subquery)))
    keys: list[SelectedKey] = []
    for i in range(0, len(uniq), arity):
        chunk = uniq[i : i + arity]
        j = 0
        while len(chunk) < arity and len(uniq) > len(chunk):
            if uniq[j] not in chunk:
                chunk.append(uniq[j])
            j += 1
        if len(chunk) < arity:  # subquery has < arity unique lemmas
            chunk = chunk + [chunk[-1]] * (arity - len(chunk))
        chunk = sorted(chunk, key=fl.number)
        keys.append(SelectedKey(tuple(chunk), tuple([False] * len(chunk))))
    return keys


def main_cell_keys(subquery: Subquery, fl: FLList) -> list[SelectedKey]:
    """SE2.1's cover [17]: main lemma duplicated as first component."""
    uniq = sorted(subquery.unique_lemmas(), key=fl.number)
    if not uniq:
        return []
    main, rest = uniq[0], uniq[1:]
    if not rest:
        return [SelectedKey((main, main, main), (False, True, True))]
    keys: list[SelectedKey] = []
    for i in range(0, len(rest), 2):
        pair = rest[i : i + 2]
        if len(pair) == 1:
            # pad with a *different* query lemma (starred: it is present at
            # any full result anyway, but must not emit duplicate events)
            pool = [l for l in uniq if l != pair[0] and l != main]
            pad = max(pool, key=fl.number) if pool else main
            comps = [main, pair[0], pad]
            stars = [False, False, True]
            order = sorted(range(3), key=lambda k: (fl.number(comps[k]), stars[k]))
            keys.append(
                SelectedKey(
                    tuple(comps[k] for k in order),
                    tuple(stars[k] for k in order),
                )
            )
            continue
        comps = sorted([main] + pair, key=fl.number)
        keys.append(SelectedKey(tuple(comps), (False, False, False)))
    return keys


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def _open_iterators(
    keys: Sequence[SelectedKey], index: IndexSet, stats: QueryStats
) -> list[KeyIterator]:
    return [KeyIterator(k, index.key_postings(k.components), stats) for k in keys]


def _align_docs(iters: list[KeyIterator], stats: QueryStats) -> int | None:
    """Step 1: advance the min-doc iterator until all agree; None if done."""
    while True:
        if any(it.exhausted for it in iters):
            return None
        docs = [it.doc for it in iters]
        stats.heap_ops += 1
        lo, hi = min(docs), max(docs)
        if lo == hi:
            return lo
        for it in iters:
            if it.doc == lo:
                it.skip_to_doc(hi)
                break


def _doc_events(
    it: KeyIterator, doc: int, stats: QueryStats, honor_stars: bool
) -> list[tuple[int, str]]:
    """Read every record of ``it`` for ``doc``; emit (pos, lemma) events."""
    events: list[tuple[int, str]] = []
    while not it.exhausted and it.doc == doc:
        events.extend(it.events(honor_stars=honor_stars))
        it.next()
    stats.intermediate_records += len(events)
    return events


# ---------------------------------------------------------------------------
# SE2.2 / SE2.3 — intermediate-lists family
# ---------------------------------------------------------------------------


def _intermediate_lists_search(
    subquery: Subquery,
    keys: list[SelectedKey],
    index: IndexSet,
    honor_stars: bool,
) -> tuple[list[SearchResult], QueryStats]:
    stats = QueryStats()
    t0 = time.perf_counter()
    mult = subquery.multiplicity()
    max_span = 2 * index.max_distance
    results: list[SearchResult] = []
    iters = _open_iterators(keys, index, stats)
    while True:
        doc = _align_docs(iters, stats)
        if doc is None:
            break
        # materialize the intermediate per-lemma streams, then merge
        events: set[tuple[int, str]] = set()
        for it in iters:
            events.update(_doc_events(it, doc, stats, honor_stars))
        results.extend(sweep_events(doc, sorted(events), mult, max_span=max_span))
    stats.results = len(results)
    stats.elapsed_sec = time.perf_counter() - t0
    return results, stats


def se22_intermediate(
    subquery: Subquery, index: IndexSet
) -> tuple[list[SearchResult], QueryStats]:
    keys = simple_key_cover(subquery, index.fl)
    return _intermediate_lists_search(subquery, keys, index, honor_stars=True)


def se23_optimized(
    subquery: Subquery, index: IndexSet
) -> tuple[list[SearchResult], QueryStats]:
    """§6 key selection, but: (a) intermediate streams are materialized, and
    (b) ``*``-marked components still emit stream records — the duplicate
    work the Combiner's §10.4 star-skip removes (§12's 10.1 s vs 1.7 s)."""
    keys = select_keys(subquery, index.fl)
    return _intermediate_lists_search(subquery, keys, index, honor_stars=False)


# ---------------------------------------------------------------------------
# SE2.1 — Main-Cell
# ---------------------------------------------------------------------------


def se21_main_cell(
    subquery: Subquery, index: IndexSet
) -> tuple[list[SearchResult], QueryStats]:
    """Align every iterator on the same (ID, P) of the main lemma [17].

    The oldest algorithm treats the query as a *set* of lemmas (duplicate
    query lemmas are not multiplicity-counted — §14 names duplicate handling
    as a limitation the Combiner removes)."""
    stats = QueryStats()
    t0 = time.perf_counter()
    keys = main_cell_keys(subquery, index.fl)
    mult = {l: 1 for l in subquery.unique_lemmas()}
    max_span = 2 * index.max_distance
    iters = _open_iterators(keys, index, stats)
    results: list[SearchResult] = []
    seen: set[SearchResult] = set()
    while True:
        if any(it.exhausted for it in iters):
            break
        cells = [(it.doc, it.pos) for it in iters]
        stats.heap_ops += 1
        lo, hi = min(cells), max(cells)
        if lo != hi:
            for it in iters:
                if (it.doc, it.pos) == lo:
                    it.next()
                    break
            continue
        # aligned: consume the whole (ID, P) group in every iterator
        doc, pos = lo
        events: set[tuple[int, str]] = set()
        for it in iters:
            while not it.exhausted and it.doc == doc and it.pos == pos:
                events.update(it.events(honor_stars=False))
                it.next()
        for r in sweep_events(doc, sorted(events), mult, max_span=max_span):
            if r not in seen:
                seen.add(r)
                results.append(r)
    stats.results = len(results)
    stats.elapsed_sec = time.perf_counter() - t0
    return sorted(results), stats
