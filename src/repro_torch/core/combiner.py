"""The Combiner algorithm — SE2.4, the paper's contribution (§5–§10, §13).

A Document-At-A-Time three-level merge over multi-component key posting
lists that produces minimal result fragments **without materializing
intermediate per-lemma posting lists**:

Step 1 (§8)  — document alignment: advance the min-doc iterator until every
               iterator sits on the same document.
Step 2 (§9)  — position alignment inside the document: advance the
               min-position iterator until ``maxP - minP < 2*MaxDistance``.
Step 3 (§10) — the Position table: three cyclic buffers of ``WindowSize``
               entries, each with a 64-bit occupancy ``Mask``.  ``Set(P,Lem)``
               writes the entry at relative position ``P - Start``; Bit Scan
               Forward over the first buffer's mask yields the sorted
               ``Source`` queue for free; the Lemma table (capped per-lemma
               counts, §10.1–10.2) turns the event stream into minimal
               fragments via the ``Processed`` queue; the buffer switch
               (§10.5) rotates buffers cyclically and advances ``Start``.

Fidelity notes (see DESIGN.md §7):
* the paper's trace (§13) shows ``Set`` is also called for ``Key[0]`` at
  ``Value.P`` (§10.4 lists only Key[1]/Key[2]); we follow the trace;
* §10.5's Processed-queue cleaning must mirror the Lemma-table bookkeeping
  of the §10.2 shrink loop (decrement counts), otherwise stale counts
  produce fragments that do not actually contain every lemma — we decrement;
* one entry per text position, but the entry holds the position's *lemma
  set*, not a single lemma: a §2 multi-lemma word ("are" -> are, be) can
  satisfy two subquery lemmas at one position, and the verbatim
  ``Set``-overwrites reading silently drops one of them (missing e.g. the
  minimal fragment of [to be who you are] whose "be" is supplied by the
  word "are").  Duplicate ``Set`` calls for the SAME (position, lemma) still
  overwrite, and the §10.1 completion check runs once per position (all of
  the position's events enter the Lemma table first) — exactly the oracle's
  atomic-position sweep, so SE2.4 stays fragment-identical to
  ``core/oracle.py`` and every device engine.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Sequence

from ..index.builder import IndexSet
from .keys import SelectedKey, Subquery, select_keys
from .postings import KeyIterator, QueryStats, SearchResult

__all__ = ["se24_combiner", "PositionTable", "LemmaTable", "CombinerState"]


# ---------------------------------------------------------------------------
# Lemma table (§10.1, §10.6 local renumbering)
# ---------------------------------------------------------------------------


class LemmaTable:
    """Capped per-lemma occurrence counts over the current fragment."""

    __slots__ = ("max_per", "count_per", "total_max", "total_count")

    def __init__(self, subquery: Subquery):
        mult = subquery.multiplicity()
        self.max_per = mult  # Entry.Max
        self.count_per = {l: 0 for l in mult}  # Entry.Count
        self.total_max = len(subquery)  # Lemma.Max
        self.total_count = 0  # Lemma.Count

    def add(self, lemma: str) -> None:
        if self.count_per[lemma] < self.max_per[lemma]:
            self.total_count += 1
        self.count_per[lemma] += 1

    def remove(self, lemma: str) -> None:
        if self.count_per[lemma] <= self.max_per[lemma]:
            self.total_count -= 1
        self.count_per[lemma] -= 1

    @property
    def complete(self) -> bool:
        return self.total_count == self.total_max

    def overcounted(self, lemma: str) -> bool:
        return self.count_per[lemma] > self.max_per[lemma]

    def reset(self) -> None:
        for l in self.count_per:
            self.count_per[l] = 0
        self.total_count = 0


# ---------------------------------------------------------------------------
# Position table (§10.3) — three cyclic buffers with 64-bit masks
# ---------------------------------------------------------------------------


@dataclass
class _Entry:
    # one entry per text position; ``lems`` is the position's lemma set
    # (multi-lemma words can satisfy several subquery lemmas at one position
    # — see the module fidelity notes)
    lems: list[str] = field(default_factory=list)
    p: int = -1


class PositionTable:
    """Three ``WindowSize``-entry buffers; each has a 64-bit ``Mask``.

    ``MaxDistance * 2 <= WindowSize <= 64`` (§10.3).  Masks are Python ints
    used as 64-bit registers; Bit Scan Forward is ``(m & -m).bit_length()-1``.
    """

    def __init__(self, window_size: int, max_distance: int):
        if not (2 * max_distance <= window_size <= 64):
            raise ValueError("need MaxDistance*2 <= WindowSize <= 64")
        self.W = window_size
        self.D = max_distance
        self.flush_border = int(window_size * 1.5)  # WindowFlushBorder (§10.3)
        self.start = 0
        self.order = [0, 1, 2]  # order[0] is "the first buffer"
        self.entries = [[_Entry() for _ in range(window_size)] for _ in range(3)]
        self.mask = [0, 0, 0]

    # -- §10.3 -------------------------------------------------------------
    def shift(self, new_start: int) -> None:
        """Monotone re-anchor; only legal when all buffers are drained."""
        assert new_start >= self.start, "Start never moves backwards (§10.4)"
        assert not any(self.mask), "shift with pending entries would drop them"
        self.start = new_start

    def set(self, p: int, lem: str) -> None:
        r = p - self.start
        if r < 0:
            return  # event behind the frontier (already flushed region)
        buf = r // self.W
        assert buf < 3, "event beyond the third buffer violates §10.4"
        rel = r % self.W
        phys = self.order[buf]
        e = self.entries[phys][rel]
        if e.p != p:  # entry reused from an older window: start fresh
            e.p = p
            e.lems = [lem]
        elif lem not in e.lems:  # same (p, lem) overwrites; new lemma joins
            e.lems.append(lem)
        self.mask[phys] |= 1 << rel

    def flush_first(self) -> list[tuple[int, str]]:
        """Bit-Scan-Forward the first buffer's mask into the Source queue
        (one event per (position, lemma); a multi-lemma position emits its
        lemmas in sorted order, matching the oracle's event stream)."""
        phys = self.order[0]
        m = self.mask[phys]
        out: list[tuple[int, str]] = []
        while m:
            lsb = m & -m
            rel = lsb.bit_length() - 1
            e = self.entries[phys][rel]
            for lem in sorted(e.lems):
                out.append((e.p, lem))
            m ^= lsb
        self.mask[phys] = 0
        return out  # sorted by construction

    def switch(self) -> None:
        """§10.5 cyclic renumbering; Start advances one window."""
        self.order = self.order[1:] + self.order[:1]
        self.start += self.W

    @property
    def empty(self) -> bool:
        return not any(self.mask)


# ---------------------------------------------------------------------------
# Per-document combiner state
# ---------------------------------------------------------------------------


class CombinerState:
    """Source/Processed queues + Lemma table + Position table for one doc."""

    def __init__(self, subquery: Subquery, window_size: int, max_distance: int):
        self.table = LemmaTable(subquery)
        self.ptable = PositionTable(window_size, max_distance)
        self.processed: deque[tuple[int, str]] = deque()
        self.results: list[SearchResult] = []

    def shift(self, new_start: int) -> None:
        # a far-forward shift expires stale Processed entries (same
        # bookkeeping as the §10.5 cleaning)
        self._clean_processed(new_start)
        self.ptable.shift(new_start)

    def set(self, p: int, lem: str) -> None:
        self.ptable.set(p, lem)

    def process_source(self, doc_id: int) -> None:
        """§10.1 main loop: Source -> Processed + Lemma table + results.

        Positions are processed atomically: every event of a multi-lemma
        position enters the Lemma table before the §10.2 completion check,
        exactly like the oracle sweep — per-event checks would emit an extra
        stale-start fragment when the position's first lemma already
        completes the cover."""
        src = self.ptable.flush_first()
        i, n = 0, len(src)
        while i < n:
            p = src[i][0]
            while i < n and src[i][0] == p:  # all events at this position
                _, lem = src[i]
                i += 1
                self.processed.append((p, lem))
                self.table.add(lem)
            # §10.2 check
            if not self.table.complete:
                continue
            while self.processed:
                fp, fl = self.processed[0]
                if self.table.overcounted(fl):
                    self.table.remove(fl)
                    self.processed.popleft()
                else:
                    break
            start = self.processed[0][0]
            self.results.append(SearchResult(doc_id=doc_id, start=start, end=p))

    def switch(self) -> None:
        """§10.5: clean Processed, rotate buffers, advance Start."""
        self._clean_border()
        self.ptable.switch()

    def _clean_border(self) -> None:
        # remove entries with (Start + WindowSize - Entry.P) > MaxDistance*2
        limit = self.ptable.start + self.ptable.W - 2 * self.ptable.D
        while self.processed and self.processed[0][0] < limit:
            _, lem = self.processed.popleft()
            self.table.remove(lem)

    def _clean_processed(self, new_start: int) -> None:
        limit = new_start - 2 * self.ptable.D
        while self.processed and self.processed[0][0] < limit:
            _, lem = self.processed.popleft()
            self.table.remove(lem)

    @property
    def drained(self) -> bool:
        return self.ptable.empty


# ---------------------------------------------------------------------------
# SE2.4 top level
# ---------------------------------------------------------------------------


def _align_docs(iters: list[KeyIterator], stats: QueryStats) -> int | None:
    """Step 1 (§8)."""
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


def _step3(
    doc: int,
    iters: list[KeyIterator],
    state: CombinerState,
    max_span: int,
) -> None:
    """§10.4: rounds of read -> flush -> process -> switch until drained."""
    live = [it for it in iters if not it.exhausted and it.doc == doc]
    if not live:
        return
    p_min = min(it.pos for it in live)
    state.shift(max(state.ptable.start, p_min - min(p_min, state.ptable.D)))
    while True:
        read_any = False
        border = state.ptable.start + state.ptable.flush_border
        for it in iters:
            while not it.exhausted and it.doc == doc and it.pos < border:
                for p, lem in it.events():  # honours * marks (§10.4)
                    state.set(p, lem)
                it.next()
                read_any = True
        state.process_source(doc)
        state.switch()
        if not read_any and state.drained:
            return


def se24_combiner(
    subquery: Subquery,
    index: IndexSet,
    window_size: int = 64,
    keys: Sequence[SelectedKey] | None = None,
) -> tuple[list[SearchResult], QueryStats]:
    """The paper's new algorithm.  ``window_size=64`` per §13's advice."""
    stats = QueryStats()
    t0 = time.perf_counter()
    D = index.max_distance
    window_size = min(64, max(window_size, 2 * D))
    key_list = list(keys) if keys is not None else select_keys(subquery, index.fl)
    iters = [KeyIterator(k, index.key_postings(k.components), stats) for k in key_list]
    max_span = 2 * D
    results: list[SearchResult] = []

    while True:
        doc = _align_docs(iters, stats)  # Step 1
        if doc is None:
            break
        state = CombinerState(subquery, window_size, D)
        # Step 2 (§9)
        while True:
            in_doc = [it for it in iters if not it.exhausted and it.doc == doc]
            if len(in_doc) < len(iters):
                break  # Step 2 exit 1 -> Step 1
            ps = [it.pos for it in in_doc]
            stats.heap_ops += 1
            delta = max(ps) - min(ps)
            if delta < 2 * D:
                _step3(doc, iters, state, max_span)  # Step 3, then back here
                continue
            # advance the min-position iterator
            for it in in_doc:
                if it.pos == min(ps):
                    it.next()
                    break
        # drain anything Step 3 buffered but had not flushed yet
        while not state.drained:
            state.process_source(doc)
            state.switch()
        results.extend(r for r in state.results if r.span <= max_span)

    stats.results = len(results)
    stats.elapsed_sec = time.perf_counter() - t0
    return results, stats
