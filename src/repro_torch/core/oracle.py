"""Result-semantics oracle.

The shared semantics of SE2.2 / SE2.3 / SE2.4 (and the vectorized / Pallas
engines) decomposes into two layers:

1. an *event stream* per document — the deduplicated ``(pos, lemma)``
   occurrences derivable from the selected keys' postings (honouring §6
   ``*`` marks);

2. a *minimal-covering-window sweep* over that stream — the Lemma-table
   process of §10.1–10.2: walk events in position order, keep capped
   per-lemma counts, and each time every subquery lemma is covered with
   multiplicity, shrink from the left while the front event is over-counted
   and emit the fragment ``(front.pos, event.pos)``.

Results are reported with the proximity filter ``span <= 2 * MaxDistance``
(fragments wider than the Step-2 window can never be *guaranteed* found by
the multi-key algorithms; see DESIGN.md §7).
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Mapping, Sequence

import numpy as np

from .keys import SelectedKey, Subquery
from .postings import SearchResult

__all__ = ["key_events", "sweep_events", "oracle_search", "ordinary_events"]


def key_events(
    keys: Sequence[SelectedKey],
    postings: Mapping[SelectedKey, np.ndarray],
    honor_stars: bool = True,
) -> dict[int, list[tuple[int, str]]]:
    """Deduplicated per-document event streams from key postings."""
    per_doc: dict[int, set[tuple[int, str]]] = {}
    for key in keys:
        rows = postings[key]
        comps, stars = key.components, key.starred
        for row in np.asarray(rows):
            doc, p = int(row[0]), int(row[1])
            bucket = per_doc.setdefault(doc, set())
            if not (honor_stars and stars[0]):
                bucket.add((p, comps[0]))
            for slot in range(1, len(comps)):
                if not (honor_stars and stars[slot]):
                    bucket.add((p + int(row[1 + slot]), comps[slot]))
    return {doc: sorted(evts) for doc, evts in per_doc.items()}


def ordinary_events(
    lemmas: Iterable[str],
    ordinary: Mapping[str, np.ndarray],
) -> dict[int, list[tuple[int, str]]]:
    """Event streams straight from the ordinary index (SE1 semantics)."""
    per_doc: dict[int, set[tuple[int, str]]] = {}
    for lemma in set(lemmas):
        rows = ordinary.get(lemma)
        if rows is None:
            continue
        for row in rows:
            per_doc.setdefault(int(row[0]), set()).add((int(row[1]), lemma))
    return {doc: sorted(evts) for doc, evts in per_doc.items()}


def sweep_events(
    doc_id: int,
    events: Sequence[tuple[int, str]],
    multiplicity: Mapping[str, int],
    max_span: int | None = None,
) -> list[SearchResult]:
    """§10.1–10.2 Lemma-table sweep over one document's event stream.

    Positions are processed atomically (a text position is one word; when a
    multi-lemma word contributes several events at the same position, the
    completion check runs once after all of them) — this is also the
    vectorized engines' semantics.
    """
    needed_total = sum(multiplicity.values())
    counts: dict[str, int] = {l: 0 for l in multiplicity}
    covered = 0
    window: deque[tuple[int, str]] = deque()
    out: list[SearchResult] = []
    i, n = 0, len(events)
    while i < n:
        pos = events[i][0]
        while i < n and events[i][0] == pos:  # all events at this position
            lem = events[i][1]
            i += 1
            if lem not in counts:
                continue
            if counts[lem] < multiplicity[lem]:
                covered += 1
            counts[lem] += 1
            window.append((pos, lem))
        if covered != needed_total:
            continue
        # shrink from the left while the front is over-counted
        while window:
            fpos, flem = window[0]
            if counts[flem] > multiplicity[flem]:
                counts[flem] -= 1
                window.popleft()
            else:
                break
        start = window[0][0]
        if max_span is None or pos - start <= max_span:
            out.append(SearchResult(doc_id=doc_id, start=start, end=pos))
    return out


def oracle_search(
    subquery: Subquery,
    keys: Sequence[SelectedKey],
    postings: Mapping[SelectedKey, np.ndarray],
    max_distance: int,
) -> list[SearchResult]:
    """Reference result set for the multi-key algorithms."""
    mult = subquery.multiplicity()
    results: list[SearchResult] = []
    for doc, events in sorted(key_events(keys, postings).items()):
        results.extend(sweep_events(doc, events, mult, max_span=2 * max_distance))
    return results
