"""Fused, batched, query-at-a-time serving pipeline (DESIGN.md §9) on torch.

The serving unit is a *query batch*.  Every (query, subquery, shard) work
item becomes one fixed-shape **segment** of compact event triples
``(doc_slot, pos, lemma)``.  Candidate (segment, doc) pairs share one global
row axis R, packed densely, and one device program runs, for all segments
of all queries at once:

    per-event rank cover  ->  §14 scoring  ->  per-query top-k
    ->  fragment dedup and §15.1 result assembly

The cover is the *event-centric* form of the rank identity: a fragment
ending at event position ``e`` starts at ``min over lemmas l of p_l(e)``,
the position of the ``mult[l]``-th latest occurrence of ``l`` at or before
``e``, gathered from per-(row, lemma) occurrence-position tables.  With
``use_kernel=True`` the cover instead scatters occupancy on the device and
runs the dense CUDA cover kernel (``kernels/proximity.py``), gathering back
to event granularity; both give identical fragments.

The batch reads out as one fixed-shape device-to-host copy of the §15.1
result buffer (``readout="host"`` keeps the host dedup as the differential
reference).  Shape budgets are powers of two, as in the reference, so plans
of similar batches have equal shapes.

Candidate selection for multi-key subqueries runs the Combiner's Step-1
document alignment as a pre-filter over sorted doc-id lists; lists of at
least ``INTERSECT_DEVICE_THRESHOLD`` docs go through the CUDA block
intersection kernel (``kernels/intersect.py``), one segmented launch per
round of the batch's folds.

Every entry point takes ``device`` and runs there: ``"cuda"`` unless the
caller asks for ``"cpu"``, where each kernel wrapper takes its plain
version.  ``serve_query_batch`` routes each work item over the
device-resident posting arena (``search/arena.py``) when its keys are
resident, and through the host pack otherwise.  This module ports
``src/repro/search/fused.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..core.keys import SelectedKey, Subquery, select_keys
from ..core.postings import QueryStats, SearchResult
from ..index.builder import POSTING_WIDTH, IndexSet
from ..kernels.intersect import PAD, block_offsets, intersect_sorted_segments, pack_segments
from ..kernels.proximity import COMPUTE_DTYPES, proximity_window

__all__ = [
    "SegmentEvents",
    "QueryBatchPlan",
    "FusedBatchResult",
    "PendingBatch",
    "bucket_pow2",
    "extract_segment_events",
    "intersect_candidates",
    "intersect_candidates_many",
    "intersect_inputs",
    "plan_query_batch",
    "fused_serve_batch",
    "run_query_batch",
    "scatter_occupancy",
    "serve_query_batch",
    "dispatch_count",
    "reset_dispatch_count",
    "collect_phases",
    "compile_count",
]

# Default list size above which the Step-1 pre-filter pays for a device
# round-trip; below it the same block intersection runs as host searchsorted.
INTERSECT_DEVICE_THRESHOLD = 4096

_DISPATCHES = 0


def dispatch_count() -> int:
    """Device programs issued by this module since the last reset: one per
    fused batch plus one per Step-1 fold round that has device work.  A
    round is step r of every item's intersection fold in the batch
    (``intersect_candidates_many``), so a batch whose items each take at
    most one device step per round counts one per round, not one per pair
    (the reference counts one per pair); a single item counts one per
    device step, as the reference does."""
    return _DISPATCHES


def reset_dispatch_count() -> None:
    """Zero the dispatch counter (see ``dispatch_count``)."""
    global _DISPATCHES
    _DISPATCHES = 0


# When a sink dict is installed, the serving paths attribute wall time to
# the six phases of a batch, appended per batch in µs (DESIGN.md §15.3):
# plan_us, pack_us, h2d_us (enqueue of the input copies), dispatch_us
# (enqueue of the device program), compute_us (a device barrier, only taken
# when a sink is installed) and readout_us (the device-to-host copy + split).
_PHASE_SINK: dict | None = None


def collect_phases(sink: dict | None) -> dict | None:
    """Install (or clear, with ``None``) the phase-breakdown sink.  Returns
    the previous sink."""
    global _PHASE_SINK
    prev, _PHASE_SINK = _PHASE_SINK, sink
    return prev


def _phase(sink: dict | None, name: str, t0: float) -> float:
    now = time.perf_counter()
    if sink is not None:
        sink.setdefault(name, []).append((now - t0) * 1e6)
    return now


def compile_count() -> None:
    """Compiled-program count of the serving entry points.  PyTorch keeps
    no per-shape program cache, so there is none to count: ``None``, as the
    reference returns where its jax exposes no cache."""
    return None


def bucket_pow2(n: int, lo: int = 1) -> int:
    """Smallest power of two >= max(n, lo) — the shape budget of
    DESIGN.md §9.2."""
    n = max(n, lo)
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# compact event transport (host side)
# ---------------------------------------------------------------------------


@dataclass
class SegmentEvents:
    """Compact event transport for one (subquery, shard) work item — the
    §10.4 ``Set`` calls batched into triples (DESIGN.md §9.1).

    Events are deduplicated and sorted by (doc, pos, lemma).  ``rank`` is the
    event's occurrence index within its (doc, lemma) group; ``primary``
    marks the first event at each (doc, pos) so positionwise quantities are
    not double-counted for multi-lemma positions.
    """

    doc_ids: np.ndarray  # [Bd] sorted unique candidate doc ids
    slot: np.ndarray  # [E] int32 index into doc_ids
    pos: np.ndarray  # [E] int32 document position
    lem: np.ndarray  # [E] int32 local lemma id
    rank: np.ndarray  # [E] int32 occurrence index within (doc, lemma)
    primary: np.ndarray  # [E] bool first event of its (doc, pos)
    mult: np.ndarray  # [L] int32 required multiplicity per local lemma
    lemmas: list[str]  # local lemma id -> lemma


def intersect_inputs(
    a: np.ndarray, b: np.ndarray, block_a: int = 128, block_b: int = 256
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """The block intersection's inputs for sorted-unique ``a`` and ``b``:
    both padded with ``PAD`` to a power of two, the tile offsets, and the
    number of tiles per block that covers every block's match span."""
    na = bucket_pow2(len(a), block_a)
    nb = bucket_pow2(len(b), block_b)
    a_p = np.full((na,), PAD, np.int32)
    a_p[: len(a)] = a
    b_p = np.full((nb,), PAD, np.int32)
    b_p[: len(b)] = b
    offsets = block_offsets(a_p, b_p, block_a, block_b)
    # size the chunk sweep from data statistics: matches of a real a-block
    # end before searchsorted(b, block_last, right)
    n_blocks = na // block_a
    last_idx = np.minimum(np.arange(1, n_blocks + 1) * block_a - 1, len(a) - 1)
    ends = np.searchsorted(b_p[: len(b)], a_p[last_idx], side="right")
    span = np.maximum(ends - offsets, 1)
    n_chunks = bucket_pow2(int(np.ceil(span.max() / block_b)))
    return a_p, b_p, offsets, n_chunks


# the port's own stream for the Step-1 rounds: a round's readout waits for
# its own copies and launch, not for a fused batch queued on the current
# stream.  Nothing of a round crosses streams: its inputs are made on this
# stream and its outputs land in host memory.
_INTERSECT_STREAMS: dict[int, torch.cuda.Stream] = {}


def _intersect_stream(device: torch.device) -> torch.cuda.Stream:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    stream = _INTERSECT_STREAMS.get(idx)
    if stream is None:
        stream = _INTERSECT_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return stream


def _device_intersect_round(
    pairs: Sequence[tuple[np.ndarray, np.ndarray]],
    device: str | torch.device,
    block_a: int = 128,
    block_b: int = 256,
) -> list[np.ndarray]:
    """Membership masks of sorted-unique ``a`` in sorted-unique ``b`` for
    every ``(a, b)`` pair of one fold round, through ONE launch of the
    segmented block-intersection kernel (host-computed tile offsets, each
    pair with its own ``n_chunks``).  On a card the pairs go over in one
    pinned buffer with one asynchronous copy, and the masks come back with
    one readout into pinned memory."""
    global _DISPATCHES
    segments = [intersect_inputs(a, b, block_a, block_b) for a, b in pairs]
    device = torch.device(device)
    if device.type == "cuda":
        with torch.cuda.device(device), torch.cuda.stream(_intersect_stream(device)):
            staged, pack = pack_segments(segments, block_a, block_b, pinned=True)
            hit = intersect_sorted_segments(staged.to(device, non_blocking=True), pack)
            host = torch.empty(hit.shape, dtype=hit.dtype, pin_memory=True)
            host.copy_(hit, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        done.synchronize()
    else:
        staged, pack = pack_segments(segments, block_a, block_b)
        host = intersect_sorted_segments(staged, pack)
    _DISPATCHES += 1
    return [m[: len(a)] > 0 for m, (a, _) in zip(pack.split(host.numpy()), pairs)]


def intersect_candidates_many(
    doc_lists_per_item: Sequence[Sequence[np.ndarray]],
    device_threshold: int = INTERSECT_DEVICE_THRESHOLD,
    device: str | torch.device = "cuda",
) -> list[np.ndarray]:
    """:func:`intersect_candidates` of every item, the folds run side by
    side in rounds.

    Each item's fold is unchanged: its lists shortest first, step r
    intersects the running result with list r + 1, an empty result ends
    it, and a step with ``min(len(acc), len(other)) >= device_threshold``
    runs the block intersection on ``device`` (host ``searchsorted``
    otherwise).  Steps of different items are independent, so round r takes
    step r of every live item, and all of a round's device steps are one
    launch (one dispatch).
    """
    folds = [sorted((np.asarray(d) for d in lists), key=len) for lists in doc_lists_per_item]
    accs = [fold[0] for fold in folds]
    for r in range(1, max((len(fold) for fold in folds), default=0)):
        on_device = []
        for i, fold in enumerate(folds):
            if r >= len(fold) or not len(accs[i]):
                continue
            acc, other = accs[i], fold[r]
            if min(len(acc), len(other)) >= device_threshold:
                on_device.append(i)
            else:
                j = np.minimum(np.searchsorted(other, acc), len(other) - 1)
                accs[i] = acc[other[j] == acc]
        if on_device:
            hits = _device_intersect_round([(accs[i], folds[i][r]) for i in on_device], device)
            for i, hit in zip(on_device, hits):
                accs[i] = accs[i][hit]
    return accs


def intersect_candidates(
    doc_lists: Sequence[np.ndarray],
    device_threshold: int = INTERSECT_DEVICE_THRESHOLD,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Sorted-unique doc-list intersection across a subquery's keys — the
    Combiner's §10.1 Step-1 document alignment, run once as a batch
    pre-filter (DESIGN.md §9.1).

    Lists at or above ``device_threshold`` go through the block intersection
    on ``device``, one launch per step; smaller ones use the identical host
    form (searchsorted) where a device round-trip would not pay off.
    """
    return intersect_candidates_many([doc_lists], device_threshold, device)[0]


@dataclass
class _KeyEvents:
    """One work item up to Step 1: each key's sorted unique doc ids and the
    item's raw (doc, pos, lemma) event columns."""

    key_docs: list[np.ndarray]
    doc: np.ndarray
    pos: np.ndarray
    lem: np.ndarray
    doc_len: int
    lemmas: list[str]
    mult: np.ndarray


def _key_events(
    subquery: Subquery,
    index: IndexSet,
    keys: Sequence[SelectedKey] | None,
    doc_len: int,
    stats: QueryStats | None,
) -> _KeyEvents | None:
    """The half of ``extract_segment_events`` before Step 1: key postings ->
    event columns.  ``None`` (counted in ``empty_subqueries``) when the item
    has no key events."""
    if index.n_docs == 0:
        if stats is not None:
            stats.empty_subqueries += 1
        return None
    keys = list(keys) if keys is not None else select_keys(subquery, index.fl)
    lemmas = subquery.unique_lemmas()
    lid = {l: i for i, l in enumerate(lemmas)}
    mult_map = subquery.multiplicity()
    mult = np.array([mult_map[l] for l in lemmas], dtype=np.int32)

    # vectorized event extraction: one (doc, pos, lemma) column set per
    # unstarred key slot — no per-posting Python work
    ev_doc, ev_pos, ev_lem = [], [], []
    key_docs: list[np.ndarray] = []
    for key in keys:
        rows = np.asarray(index.key_postings(key.components))
        if stats is not None:
            stats.postings_read += len(rows)
            stats.bytes_read += rows.nbytes
        key_docs.append(
            np.unique(rows[:, 0]) if len(rows) else np.empty((0,), np.int32)
        )
        if not len(rows):
            continue
        comps, stars = key.components, key.starred
        for slot in range(len(comps)):
            if stars[slot]:
                continue
            pos = rows[:, 1] if slot == 0 else rows[:, 1] + rows[:, 1 + slot]
            ev_doc.append(rows[:, 0])
            ev_pos.append(pos)
            ev_lem.append(np.full(len(rows), lid[comps[slot]], np.int32))

    if not ev_doc:
        if stats is not None:
            stats.empty_subqueries += 1
        return None
    doc_a = np.concatenate(ev_doc)
    pos_a = np.concatenate(ev_pos)
    lem_a = np.concatenate(ev_lem)
    ok = pos_a >= 0
    doc_a, pos_a, lem_a = doc_a[ok], pos_a[ok], lem_a[ok]
    if len(pos_a):
        # the position modulus must cover every real position: documents
        # longer than the caller's doc_len hint must not lose fragments
        doc_len = max(doc_len, int(pos_a.max()) + 1)
    return _KeyEvents(key_docs, doc_a, pos_a, lem_a, doc_len, lemmas, mult)


def extract_segment_events(
    subquery: Subquery,
    index: IndexSet,
    keys: Sequence[SelectedKey] | None = None,
    doc_len: int = 512,
    stats: QueryStats | None = None,
    intersect_device_threshold: int = INTERSECT_DEVICE_THRESHOLD,
    device: str | torch.device = "cuda",
) -> SegmentEvents | None:
    """Key postings -> compact (doc_slot, pos, lemma) event triples — the
    §10.4 ``Set`` calls batched, plus the §10.1/§10.3 pre-filters
    (DESIGN.md §9.1).

    Returns ``None`` for an empty subquery (no key events, or the Step-1
    candidate intersection is empty) so callers short-circuit instead of
    dispatching an all-padding batch; the skip is counted in
    ``QueryStats.empty_subqueries``.
    """
    ke = _key_events(subquery, index, keys, doc_len, stats)
    if ke is None:
        return None
    cand = None
    if len(ke.key_docs) >= 2:
        cand = intersect_candidates(
            ke.key_docs, device_threshold=intersect_device_threshold, device=device
        )
    return _segment_events(ke, cand, stats)


def _segment_events(
    ke: _KeyEvents, cand: np.ndarray | None, stats: QueryStats | None
) -> SegmentEvents | None:
    """The half of ``extract_segment_events`` after Step 1: the candidate
    filter (``cand``, the item's Step-1 intersection, ``None`` for a
    single-key item), event dedup, the counting gate and ranks."""
    doc_a, pos_a, lem_a = ke.doc, ke.pos, ke.lem
    doc_len, lemmas, mult = ke.doc_len, ke.lemmas, ke.mult
    # Step-1 pre-filter: a fragment needs every key iterator on the document
    if cand is not None:
        if len(cand) and len(doc_a):
            i = np.minimum(np.searchsorted(cand, doc_a), len(cand) - 1)
            keep = cand[i] == doc_a
            doc_a, pos_a, lem_a = doc_a[keep], pos_a[keep], lem_a[keep]
        else:
            doc_a = doc_a[:0]

    if not len(doc_a):
        if stats is not None:
            stats.empty_subqueries += 1
        return None

    # dedup events (occupancy semantics: one event per (doc, pos, lemma))
    # and run Step 2's counting gate batched: a candidate doc whose distinct
    # positions of some lemma fall short of its multiplicity can never emit
    # a fragment — drop its rows before the device budget.
    n_lem = len(lemmas)
    comp = (doc_a.astype(np.int64) * doc_len + pos_a) * n_lem + lem_a
    comp = np.unique(comp)  # sorted by (doc, pos, lemma)
    lem_a = (comp % n_lem).astype(np.int32)
    pos_a = ((comp // n_lem) % doc_len).astype(np.int32)
    doc_a = (comp // (n_lem * doc_len)).astype(np.int32)
    docs, slot = np.unique(doc_a, return_inverse=True)
    counts = np.bincount(
        slot * n_lem + lem_a, minlength=len(docs) * n_lem
    ).reshape(len(docs), n_lem)
    ok_doc = (counts >= mult[None, :]).all(axis=1)
    if not ok_doc.all():
        keep = ok_doc[slot]
        doc_a, pos_a, lem_a = doc_a[keep], pos_a[keep], lem_a[keep]
        if not len(doc_a):
            if stats is not None:
                stats.empty_subqueries += 1
            return None
        docs, slot = np.unique(doc_a, return_inverse=True)

    # occurrence rank within (doc, lemma) + primary flag per (doc, pos)
    order = np.lexsort((pos_a, lem_a, slot))
    grp = slot[order].astype(np.int64) * n_lem + lem_a[order]
    new_grp = np.r_[True, grp[1:] != grp[:-1]]
    grp_start = np.maximum.accumulate(
        np.where(new_grp, np.arange(len(order)), 0)
    )
    rank = np.empty(len(order), np.int32)
    rank[order] = (np.arange(len(order)) - grp_start).astype(np.int32)
    pos_key = slot.astype(np.int64) * doc_len + pos_a
    primary = np.r_[True, pos_key[1:] != pos_key[:-1]]

    return SegmentEvents(
        doc_ids=docs.astype(np.int32),
        slot=slot.astype(np.int32),
        pos=pos_a.astype(np.int32),
        lem=lem_a.astype(np.int32),
        rank=rank,
        primary=primary,
        mult=mult,
        lemmas=lemmas,
    )


# ---------------------------------------------------------------------------
# query-batch plan (bucketed, padded, fixed-shape)
# ---------------------------------------------------------------------------


@dataclass
class QueryBatchPlan:
    """Fixed-shape host arrays for one fused device program (DESIGN.md §9.2
    bucketed budgets; the §10.4 events of every work item, packed).

    Every (segment, candidate-doc) pair of every query occupies one row of
    a single global row axis ``R``.  ``postab`` is the per-(row, lemma)
    occurrence-position table the event-centric cover gathers from (pad =
    ``doc_len``, greater than every real position).  Padding rows have
    ``row_doc = -1`` / ``row_query = -1`` / ``mult = 0`` and emit nothing.
    """

    events: np.ndarray  # [E, 3] int32 (row, pos, lemma), pad = -1
    primary: np.ndarray  # [E] int8 first-event-of-(row, pos) flag
    postab: np.ndarray  # [R, L, K] int32 k-th occurrence position, pad = doc_len
    row_doc: np.ndarray  # [R] int32 global doc id per row, pad = -1
    row_query: np.ndarray  # [R] int32 query index per row, pad = -1
    mult: np.ndarray  # [R, L] int32 (0 = unused lemma slot)
    n_queries: int  # live queries (<= query_budget)
    query_budget: int  # bucket_pow2(n_queries)
    doc_len: int  # bucketed window budget


def plan_query_batch(
    work: Sequence[Sequence[tuple]],
    doc_len: int = 512,
    stats: QueryStats | Sequence[QueryStats] | None = None,
    intersect_device_threshold: int = INTERSECT_DEVICE_THRESHOLD,
    device: str | torch.device = "cuda",
) -> QueryBatchPlan | None:
    """Pack a query batch into one device program's inputs.

    ``work[qi]`` lists query ``qi``'s ``(subquery, index-shard)`` items; an
    item may carry a third element, the §6 keys to use (``(subquery, index,
    keys)``), as the query planner passes them.  ``stats`` is one
    accumulator for the batch or one per query.  ``device`` runs the Step-1
    intersections of long lists.  Returns ``None`` when every item is empty
    (nothing to dispatch).
    """
    def stat_for(qi: int) -> QueryStats | None:
        if stats is None or isinstance(stats, QueryStats):
            return stats
        return stats[qi]

    sink = _PHASE_SINK
    t0 = time.perf_counter()
    # extract_segment_events item by item, with every item's Step-1 fold
    # run side by side: one launch per round of the batch, not per pair
    items_ke: list[tuple[int, _KeyEvents]] = []
    for qi, items in enumerate(work):
        for item in items:
            keys = item[2] if len(item) > 2 else None
            ke = _key_events(item[0], item[1], keys, doc_len, stat_for(qi))
            if ke is not None:
                items_ke.append((qi, ke))
    multi = [ke.key_docs for _, ke in items_ke if len(ke.key_docs) >= 2]
    cands = iter(intersect_candidates_many(multi, intersect_device_threshold, device))
    segs: list[tuple[int, SegmentEvents]] = []
    for qi, ke in items_ke:
        cand = next(cands) if len(ke.key_docs) >= 2 else None
        se = _segment_events(ke, cand, stat_for(qi))
        if se is not None:
            segs.append((qi, se))
    t0 = _phase(sink, "plan_us", t0)
    if not segs:
        return None

    n_rows = sum(len(se.doc_ids) for _, se in segs)
    n_events = sum(len(se.slot) for _, se in segs)
    r_budget = bucket_pow2(n_rows, lo=8)
    e_budget = bucket_pow2(n_events, lo=64)
    l_budget = bucket_pow2(max(len(se.lemmas) for _, se in segs), lo=2)
    k_budget = bucket_pow2(max(int(se.rank.max()) for _, se in segs) + 1, lo=4)
    # position budget: bucketed from the last real event, not clamped to the
    # caller's doc_len hint — long documents keep their fragments
    max_pos = max(int(se.pos.max()) for _, se in segs)
    n_budget = bucket_pow2(max_pos + 1, lo=64)

    events = np.full((e_budget, 3), -1, np.int32)
    primary = np.zeros((e_budget,), np.int8)
    postab = np.full((r_budget, l_budget, k_budget), n_budget, np.int32)
    row_doc = np.full((r_budget,), -1, np.int32)
    row_query = np.full((r_budget,), -1, np.int32)
    mult = np.zeros((r_budget, l_budget), np.int32)
    row = ev = 0
    for qi, se in segs:
        nd, ne = len(se.doc_ids), len(se.slot)
        events[ev : ev + ne, 0] = se.slot + row
        events[ev : ev + ne, 1] = se.pos
        events[ev : ev + ne, 2] = se.lem
        primary[ev : ev + ne] = se.primary
        postab[se.slot + row, se.lem, se.rank] = se.pos
        row_doc[row : row + nd] = se.doc_ids
        row_query[row : row + nd] = qi
        mult[row : row + nd, : len(se.mult)] = se.mult
        row += nd
        ev += ne
    _phase(sink, "pack_us", t0)
    return QueryBatchPlan(
        events=events,
        primary=primary,
        postab=postab,
        row_doc=row_doc,
        row_query=row_query,
        mult=mult,
        n_queries=len(work),
        query_budget=bucket_pow2(len(work)),
        doc_len=n_budget,
    )


# ---------------------------------------------------------------------------
# the fused device program
# ---------------------------------------------------------------------------

_I32_SENTINEL = int(np.iinfo(np.int32).max)


def _assemble_fragments(
    q: torch.Tensor,  # [E] int32 query index per event
    d: torch.Tensor,  # [E] int32 doc id per event
    s: torch.Tensor,  # [E] int32 fragment start per event
    e: torch.Tensor,  # [E] int32 fragment end per event
    valid: torch.Tensor,  # [E] bool emitting primary events
    query_budget: int,
) -> torch.Tensor:
    """Device-side fragment dedup + result assembly (DESIGN.md §15.1).

    Sorts the per-event fragment keys ``(q, d, s, e)`` lexicographically
    (invalid events carry the int32 sentinel in every column and sort last),
    drops adjacent duplicates, and compacts the survivors to the head of a
    dense ``[E + Q, 4]`` int32 result buffer, in ascending ``(q, doc,
    start, end)`` order.  The trailing ``Q`` rows carry the per-query
    unique-fragment counts in column 0, so the readout is ONE fixed-shape
    copy.
    """
    cap = q.shape[0]
    keys = [torch.where(valid, col, _I32_SENTINEL) for col in (q, d, s, e)]
    # torch has no multi-key sort: stable sorts from the least significant
    # key to the most give the lexicographic order
    order = torch.arange(cap, device=q.device)
    for col in reversed(keys):
        order = order[torch.sort(col[order], stable=True).indices]
    qs, ds, ss, es = (col[order] for col in keys)

    def prev(col: torch.Tensor) -> torch.Tensor:
        return torch.cat([col.new_full((1,), -1), col[:-1]])

    fin = qs < _I32_SENTINEL
    dup = (qs == prev(qs)) & (ds == prev(ds)) & (ss == prev(ss)) & (es == prev(es))
    uniq = fin & ~dup
    # compaction scatter: unique survivors go to their prefix-sum slot,
    # everything else to one extra dump row cut off afterwards (a boolean
    # mask would force a device sync)
    dump = cap + query_budget
    dest = torch.where(uniq, torch.cumsum(uniq.to(torch.int64), 0) - 1, dump)
    buf = torch.full((dump + 1, 4), -1, dtype=torch.int32, device=q.device)
    buf.index_put_((dest,), torch.stack([qs, ds, ss, es], dim=1))
    buf = buf[:dump]
    counts = torch.zeros(query_budget, dtype=torch.int32, device=q.device)
    counts.index_add_(0, qs.clamp(0, query_budget - 1), uniq.to(torch.int32))
    buf[cap:, 0] = counts
    return buf


def _event_fields(
    events: torch.Tensor, r: int, l: int, n: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(row clamped to [0, R) as int64, pos, lem, ok)`` of the event
    triples; ``ok`` marks events inside the ``[R, L, N]`` budget."""
    row, pos, lem = events[:, 0], events[:, 1], events[:, 2]
    ok = (row >= 0) & (row < r) & (pos >= 0) & (pos < n) & (lem >= 0) & (lem < l)
    return row.clamp(0, r - 1).to(torch.int64), pos, lem, ok


def scatter_occupancy(
    events: torch.Tensor, r: int, l: int, n: int, compute_dtype: str
) -> torch.Tensor:
    """The dense ``[R, L, N]`` 0/1 occupancy of the valid events, in the
    compute dtype — the cover kernel's input on the ``use_kernel`` path."""
    row_s, pos, lem, ok = _event_fields(events, r, l, n)
    cdt = COMPUTE_DTYPES[compute_dtype]
    flat = (row_s * l + lem.clamp(min=0)) * n + pos.clamp(min=0)
    # set, not max-scatter: invalid events go to a dump cell past the end,
    # so no 0 can overwrite a 1
    flat = torch.where(ok, flat, r * l * n)
    occ = torch.zeros(r * l * n + 1, dtype=cdt, device=events.device)
    occ.index_put_((flat,), torch.ones((), dtype=cdt, device=events.device))
    return occ[: r * l * n].reshape(r, l, n)


def _gather_last(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tab[..., idx[...]]`` along the last axis (``take_along_axis``)."""
    return torch.gather(tab, -1, idx.to(torch.int64)[..., None])[..., 0]


def fused_serve_batch(
    events: torch.Tensor,  # [E, 3] int32 (row, pos, lemma), pad = -1
    primary: torch.Tensor,  # [E] int8 first-event-of-(row, pos) flag
    postab: torch.Tensor,  # [R, L, K] int32 occurrence positions, pad = window_len
    row_doc: torch.Tensor,  # [R] int32 global doc id per row, pad = -1
    row_query: torch.Tensor,  # [R] int32 query index per row, pad = -1
    mult: torch.Tensor,  # [R, L] int32
    *,
    max_distance: int,
    query_budget: int,
    window_len: int,
    top_k: int = 16,
    compute_dtype: str = "uint8",  # §Perf-3: dense-path occupancy fits u8
    use_kernel: bool = False,
) -> dict[str, torch.Tensor]:
    """One device program for a whole query batch, on the inputs' device.

    stage 1  per-event rank cover: for every event, gather the mult-th
             latest occurrence position of every lemma from ``postab`` —
             fragment start = min over active lemmas, emit iff the span
             fits ``2 * max_distance`` (O(events), no dense occupancy);
             with ``use_kernel=True``: scatter occupancy [R, L, N] on the
             device instead and run the cover kernel, then gather emit and
             start back to event granularity;
    stage 2  §14 relevance per row (scatter-add of per-event contributions);
    stage 3  per-query top-k over row scores (ties to the lower row, as
             ``jax.lax.top_k`` breaks them);
    stage 4  §15.1 fragment dedup and result assembly (``res``).

    Scores are float32 sums whose order differs from the reference's, so
    they agree within rounding, not bit for bit.
    """
    r, l, k = postab.shape
    n = window_len
    q = query_budget
    window = 2 * max_distance + 1
    dev = events.device

    row_s, pos, _, ok = _event_fields(events, r, l, n)

    if use_kernel:
        # ---- dense path: on-device scatter + cover kernel -----------------
        occ = scatter_occupancy(events, r, l, n, compute_dtype)
        emit_rn, start_rn = proximity_window(occ, mult, max_distance, compute_dtype=compute_dtype)
        pos_s = pos.clamp(0, n - 1).to(torch.int64)
        emit = ok & emit_rn[row_s, pos_s]
        start = start_rn[row_s, pos_s]
    else:
        # ---- event-centric rank cover -------------------------------------
        tab = postab[row_s]  # [E, L, K]
        mrow = mult[row_s]  # [E, L]
        active = mrow > 0
        pos_c = pos[:, None]
        # C_l(pos): occurrences of lemma l at/before this event's position.
        # postab rows are position-sorted, so this is a log2(K)-step binary
        # search per (event, lemma) instead of a K-wide compare-reduce.
        cnt = torch.zeros(tab.shape[:2], dtype=torch.int32, device=dev)  # [E, L]
        step = k
        while step > 1:
            step //= 2
            probe = _gather_last(tab, (cnt + step - 1).clamp(max=k - 1))
            cnt = torch.where(probe <= pos_c, cnt + step, cnt)
        # strides sum to k-1, so a full prefix undercounts by one: final probe
        probe = _gather_last(tab, cnt.clamp(max=k - 1))
        cnt = cnt + (probe <= pos_c).to(torch.int32)
        have = cnt >= mrow
        p_sel = _gather_last(tab, (cnt - mrow).clamp(0, k - 1))
        p_sel = torch.where(active & have, p_sel, n)  # inactive -> +inf for min
        start = p_sel.min(dim=-1).values  # [E] largest covering q
        covered = (have | ~active).all(dim=-1) & active.any(dim=-1)
        emit = ok & covered & (start < n) & (pos - start < window)
        start = torch.where(emit, start, pos)

    # ---- §14 relevance per row (primary events only: one per position) ----
    frag = emit & (primary > 0)
    span = (pos - start).to(torch.float32)
    contrib = torch.where(frag & ok, 1.0 / (span + 1.0) ** 2, 0.0)
    scores = torch.zeros(r, dtype=torch.float32, device=dev).index_add_(0, row_s, contrib)
    scores = torch.where(row_doc >= 0, scores, -torch.inf)

    # ---- per-query top-k ---------------------------------------------------
    qids = torch.arange(q, device=dev, dtype=row_query.dtype)[:, None]
    scores_q = torch.where(row_query[None, :] == qids, scores[None, :], -torch.inf)
    kk = min(top_k, r)
    # a stable descending sort keeps equal scores in row order, the tie
    # order of jax.lax.top_k (torch.topk does not promise one)
    idx = torch.sort(scores_q, dim=1, descending=True, stable=True).indices[:, :kk]
    top_scores = torch.gather(scores_q, 1, idx)
    top_docs = torch.where(torch.isfinite(top_scores), row_doc[idx], -1)

    frag_per_row = torch.zeros(r, dtype=torch.int32, device=dev).index_add_(
        0, row_s, frag.to(torch.int32)
    )
    n_fragments = torch.zeros(q, dtype=torch.int32, device=dev).index_add_(
        0,
        row_query.clamp(0, q - 1).to(torch.int64),
        torch.where(row_query >= 0, frag_per_row, 0),
    )

    # ---- §15.1 device-side result assembly --------------------------------
    ev_q = row_query[row_s]
    ev_d = row_doc[row_s]
    frag_valid = frag & (ev_q >= 0) & (ev_d >= 0)
    res = _assemble_fragments(ev_q, ev_d, start, pos, frag_valid, q)

    return {
        "emit": emit,
        "start": start,
        "res": res,
        "top_docs": top_docs,
        "top_scores": top_scores,
        "n_fragments": n_fragments,
    }


# ---------------------------------------------------------------------------
# execution + vectorized readout
# ---------------------------------------------------------------------------


class FusedBatchResult:
    """Per-query exact fragment sets plus the device's row-level ranking
    (DESIGN.md §9.3: the fragment readout is the exact §10.2 result; the
    device top-k is row-level).

    The device readout (§15.1) carries fragments as the compact
    ``frag_rows``/``frag_offsets`` pair — ``per_query`` materializes
    ``SearchResult`` objects lazily on first access.  The host readout and
    the empty/merge paths construct eagerly with ``per_query=...``.
    """

    __slots__ = (
        "top_docs",
        "top_scores",
        "n_fragments",
        "frag_rows",
        "frag_offsets",
        "_per_query",
    )

    def __init__(
        self,
        *,
        top_docs: np.ndarray,  # [Q, K] int32 (-1 pad)
        top_scores: np.ndarray,  # [Q, K] float32
        n_fragments: np.ndarray,  # [Q] pre-dedup emit counts
        per_query: list[list[SearchResult]] | None = None,
        frag_rows: np.ndarray | None = None,  # [F, 3] int32 (doc, start, end)
        frag_offsets: np.ndarray | None = None,  # [Q + 1] int64 cumulative
    ):
        if per_query is None and frag_offsets is None:
            raise ValueError("need per_query or frag_rows/frag_offsets")
        self.top_docs = top_docs
        self.top_scores = top_scores
        self.n_fragments = n_fragments
        self.frag_rows = frag_rows
        self.frag_offsets = frag_offsets
        self._per_query = per_query

    @property
    def n_queries(self) -> int:
        if self._per_query is not None:
            return len(self._per_query)
        return len(self.frag_offsets) - 1

    def n_results(self, qi: int) -> int:
        """Deduped fragment count for query ``qi`` without materializing
        ``SearchResult`` objects."""
        if self._per_query is not None:
            return len(self._per_query[qi])
        return int(self.frag_offsets[qi + 1] - self.frag_offsets[qi])

    @property
    def per_query(self) -> list[list[SearchResult]]:
        """Deduped fragment union per query, sorted by (doc, start, end);
        materialized from ``frag_rows`` on first access and cached."""
        if self._per_query is None:
            rows = self.frag_rows.tolist()
            offs = self.frag_offsets.tolist()
            make = SearchResult._make
            self._per_query = [
                [make(r) for r in rows[offs[qi] : offs[qi + 1]]]
                for qi in range(len(offs) - 1)
            ]
        return self._per_query


class PendingBatch:
    """Handle for an in-flight query batch (DESIGN.md §15.2).

    ``run_query_batch``/``serve_query_batch`` with ``defer=True`` return
    one of these right after enqueueing the device program: CUDA runs it
    asynchronously while the caller plans the next batch.  ``result()``
    performs the blocking readout (idempotent; the result is cached).
    """

    __slots__ = ("_thunk", "_result")

    def __init__(self, thunk):
        self._thunk = thunk
        self._result = None

    def result(self) -> FusedBatchResult:
        if self._thunk is not None:
            self._result = self._thunk()
            self._thunk = None
        return self._result


def empty_batch_result(n_queries: int, top_k: int) -> FusedBatchResult:
    return FusedBatchResult(
        per_query=[[] for _ in range(n_queries)],
        top_docs=np.full((n_queries, top_k), -1, np.int32),
        top_scores=np.full((n_queries, top_k), -np.inf, np.float32),
        n_fragments=np.zeros((n_queries,), np.int64),
    )


def _dedup_fragments(
    q_of: np.ndarray, docs: np.ndarray, starts: np.ndarray, ends: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-side fragment dedup: sorted unique ``(q, doc, start, end)``
    columns, in the same ascending order the §15.1 device assembly emits.

    Two tiers: when the packed key fits int64 the dedup is one ``np.unique``
    over ``((q * D + doc) * N + start) * N + end``; otherwise — wide doc-id
    spaces or very long documents, where packing would alias distinct
    fragments — ``np.lexsort`` + adjacent-diff, which has no width budget.
    """
    if q_of.size == 0:
        z = np.zeros((0,), np.int64)
        return z, z, z, z
    doc_mod = int(docs.max(initial=0)) + 1
    n_mod = int(max(starts.max(initial=0), ends.max(initial=0))) + 1
    q_mod = int(q_of.max(initial=0)) + 1
    if (q_mod * doc_mod * n_mod * n_mod - 1).bit_length() <= 63:
        frag_key = ((q_of * doc_mod + docs) * n_mod + starts) * n_mod + ends
        uniq = np.unique(frag_key)
        u_end = uniq % n_mod
        u_start = (uniq // n_mod) % n_mod
        u_doc = (uniq // (n_mod * n_mod)) % doc_mod
        u_q = uniq // (n_mod * n_mod * doc_mod)
        return u_q, u_doc, u_start, u_end
    order = np.lexsort((ends, starts, docs, q_of))
    q_s, d_s, s_s, e_s = q_of[order], docs[order], starts[order], ends[order]
    keep = np.ones(q_s.shape, bool)
    keep[1:] = (
        (q_s[1:] != q_s[:-1])
        | (d_s[1:] != d_s[:-1])
        | (s_s[1:] != s_s[:-1])
        | (e_s[1:] != e_s[:-1])
    )
    return q_s[keep], d_s[keep], s_s[keep], e_s[keep]


def _split_result_buffer(
    buf: np.ndarray, n_queries: int, query_budget: int
) -> tuple[np.ndarray, np.ndarray]:
    """Split the fetched §15.1 result buffer into ``(frag_rows,
    frag_offsets)``: the trailing ``query_budget`` rows carry per-query
    counts in column 0; the head rows are the compacted unique fragments,
    already grouped by query in ascending key order."""
    cap = buf.shape[0] - query_budget
    counts = buf[cap : cap + n_queries, 0].astype(np.int64)
    offsets = np.zeros((n_queries + 1,), np.int64)
    np.cumsum(counts, out=offsets[1:])
    frag_rows = buf[: int(offsets[-1]), 1:4]
    return frag_rows, offsets


def run_query_batch(
    plan: QueryBatchPlan,
    *,
    max_distance: int,
    top_k: int = 16,
    use_kernel: bool = False,
    compute_dtype: str = "uint8",
    stats: QueryStats | None = None,
    readout: str = "device",
    defer: bool = False,
    device: str | torch.device = "cuda",
) -> FusedBatchResult | PendingBatch:
    """Run ONE device program for the plan on ``device`` and read results
    out of the §15.1 dense buffer — one fixed-shape copy
    (``readout="device"``).  ``readout="host"`` instead fetches the
    per-event emit/start arrays and dedups on the host — the differential
    reference.  ``defer=True`` returns a :class:`PendingBatch` right after
    the program is enqueued (§15.2)."""
    if readout not in ("device", "host"):
        raise ValueError(f"unknown readout mode: {readout!r}")
    global _DISPATCHES
    sink = _PHASE_SINK
    t0 = time.perf_counter()
    arrays = (plan.events, plan.primary, plan.postab, plan.row_doc, plan.row_query, plan.mult)
    if torch.device(device).type == "cuda":
        # pinned staging makes the copies asynchronous: a pageable copy
        # would first wait for the work already queued on the stream
        inputs = [torch.from_numpy(a).pin_memory().to(device, non_blocking=True) for a in arrays]
    else:
        inputs = [torch.from_numpy(a) for a in arrays]
    if stats is not None:
        stats.h2d_bytes += sum(a.nbytes for a in arrays)
    t0 = _phase(sink, "h2d_us", t0)
    out = fused_serve_batch(
        *inputs,
        max_distance=max_distance,
        query_budget=plan.query_budget,
        window_len=plan.doc_len,
        top_k=top_k,
        compute_dtype=compute_dtype,
        use_kernel=use_kernel,
    )
    _DISPATCHES += 1
    if stats is not None:
        stats.device_dispatches += 1
    _phase(sink, "dispatch_us", t0)

    nq = plan.n_queries

    def finalize() -> FusedBatchResult:
        t1 = time.perf_counter()
        if sink is not None:
            # bench-only barrier: bills device time to compute_us
            if out["res"].is_cuda:
                torch.cuda.synchronize(out["res"].device)
            t1 = _phase(sink, "compute_us", t1)
        top = dict(
            top_docs=out["top_docs"].cpu().numpy()[:nq],
            top_scores=out["top_scores"].cpu().numpy()[:nq],
            n_fragments=out["n_fragments"].cpu().numpy()[:nq],
        )
        if readout == "device":
            frag_rows, frag_offsets = _split_result_buffer(
                out["res"].cpu().numpy(), nq, plan.query_budget
            )
            result = FusedBatchResult(frag_rows=frag_rows, frag_offsets=frag_offsets, **top)
        else:
            # host readout: one nonzero over the event batch (primary events
            # carry one fragment per emitting position), then the two-tier
            # host dedup — differential reference for §15.1
            emit = out["emit"].cpu().numpy() & (plan.primary > 0)
            (hits,) = np.nonzero(emit)
            starts = out["start"].cpu().numpy()[hits].astype(np.int64)
            ends = plan.events[hits, 1].astype(np.int64)
            rows = plan.events[hits, 0]
            docs = plan.row_doc[rows].astype(np.int64)
            q_of = plan.row_query[rows].astype(np.int64)
            live = (q_of >= 0) & (q_of < nq)
            u_q, u_doc, u_start, u_end = _dedup_fragments(
                q_of[live], docs[live], starts[live], ends[live]
            )
            per_query: list[list[SearchResult]] = [[] for _ in range(nq)]
            for qi, d, st, en in zip(
                u_q.tolist(), u_doc.tolist(), u_start.tolist(), u_end.tolist()
            ):
                per_query[qi].append(SearchResult(doc_id=d, start=st, end=en))
            result = FusedBatchResult(per_query=per_query, **top)
        _phase(sink, "readout_us", t1)
        return result

    if defer:
        return PendingBatch(finalize)
    return finalize()


def _merge_results(
    results: Sequence[FusedBatchResult], n_queries: int, top_k: int
) -> FusedBatchResult:
    """Union per-query fragment sets and re-merge the row-level top-k lists
    of several results.  Device-readout results merge at the array level —
    concatenate fragment columns, re-dedup with the two-tier host dedup;
    results that already carry ``per_query`` lists union as sets."""
    if len(results) == 1:
        return results[0]
    scores = np.concatenate([r.top_scores for r in results], axis=1)
    docs = np.concatenate([r.top_docs for r in results], axis=1)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :top_k]
    top_docs = np.take_along_axis(docs, order, axis=1)
    top_scores = np.take_along_axis(scores, order, axis=1)
    n_fragments = sum(r.n_fragments for r in results)
    if all(r.frag_offsets is not None and r._per_query is None for r in results):
        q_col = np.concatenate(
            [
                np.repeat(
                    np.arange(n_queries, dtype=np.int64),
                    np.diff(r.frag_offsets),
                )
                for r in results
            ]
        )
        rows = np.concatenate(
            [r.frag_rows for r in results], dtype=np.int64, casting="unsafe"
        ).reshape(-1, 3)
        u_q, u_d, u_s, u_e = _dedup_fragments(
            q_col, rows[:, 0], rows[:, 1], rows[:, 2]
        )
        counts = np.bincount(u_q, minlength=n_queries)
        offsets = np.zeros((n_queries + 1,), np.int64)
        np.cumsum(counts, out=offsets[1:])
        return FusedBatchResult(
            frag_rows=np.stack([u_d, u_s, u_e], axis=1).astype(np.int32),
            frag_offsets=offsets,
            top_docs=top_docs,
            top_scores=top_scores,
            n_fragments=n_fragments,
        )
    per_query: list[list[SearchResult]] = []
    for qi in range(n_queries):
        union: set[SearchResult] = set()
        for r in results:
            union.update(r.per_query[qi])
        per_query.append(sorted(union))
    return FusedBatchResult(
        per_query=per_query,
        top_docs=top_docs,
        top_scores=top_scores,
        n_fragments=n_fragments,
    )


def serve_query_batch(
    work: Sequence[Sequence[tuple]],
    *,
    max_distance: int,
    top_k: int = 16,
    doc_len: int = 512,
    use_kernel: bool = False,
    compute_dtype: str = "uint8",
    stats: QueryStats | Sequence[QueryStats] | None = None,
    batch_stats: QueryStats | None = None,
    residencies: dict | None = None,
    intersect_device_threshold: int = INTERSECT_DEVICE_THRESHOLD,
    readout: str = "device",
    defer: bool = False,
    device: str | torch.device = "cuda",
) -> FusedBatchResult | PendingBatch:
    """Serve one query batch, routing each (subquery, view) work item over
    the device-resident posting arena when its keys are resident and through
    the host-pack path on ``device`` otherwise (DESIGN.md §13).

    ``work`` is the ``plan_query_batch`` cross product (items are
    ``(subquery, index[, keys])``); ``residencies`` maps ``id(view)`` to the
    :class:`~repro_torch.search.arena.ArenaResidency` acquired for that view
    (no entry = host path for that view's items; the arena program runs on
    the arena's device).  A fully resident batch is ONE arena dispatch; a
    fully host batch is ONE host dispatch (plus one per Step-1 fold round
    with long-list intersects); a mixed batch runs both and merges.

    Exactness contract: the per-query fragment sets are identical for every
    routing (arena, host, or mixed), equal to the §10 oracle and to the
    reference package's fragments for the same work.  ``readout``/``defer``
    forward to ``run_query_batch`` / ``run_arena_batch``.
    """
    from .arena import ArenaOverflow, plan_arena_batch, run_arena_batch

    global _DISPATCHES

    def stat_for(qi: int) -> QueryStats | None:
        if stats is None or isinstance(stats, QueryStats):
            return stats
        return stats[qi]

    sink = _PHASE_SINK
    host_work: list[list[tuple]] = [[] for _ in work]
    arena_items: list[tuple] = []
    arena_fallback: list[tuple[int, tuple, object]] = []
    t0 = time.perf_counter()
    for qi, items in enumerate(work):
        for item in items:
            sub, view = item[0], item[1]
            res = residencies.get(id(view)) if residencies else None
            if res is None:
                host_work[qi].append(item)
                continue
            keys = (
                list(item[2])
                if len(item) > 2 and item[2] is not None
                else select_keys(sub, view.fl)
            )
            st = stat_for(qi)
            extents = []
            for key in keys:
                ext = res.lookup(key.components)
                if ext is None:
                    break
                extents.append(ext)
            if len(extents) < len(keys):
                if st is not None:
                    # per-key units, like arena_hits: every key of the item
                    # is served by the host pack
                    st.arena_misses += len(keys)
                # carry the selected keys: the host pack accepts 3-tuples
                host_work[qi].append((sub, view, keys))
                continue

            def account(hit=True, st=st, keys=keys, extents=extents):
                # §11 accounting parity with the host pack: the arena path
                # reads the same rows, on the device.  ``hit=False`` records
                # an overflow fallback — the host pack does its own counting
                if st is None:
                    return
                if not hit:
                    st.arena_misses += len(keys)
                    return
                st.arena_hits += len(keys)
                for ext in extents:
                    st.postings_read += ext.n_rows
                    st.bytes_read += ext.n_rows * 4 * POSTING_WIDTH.get(ext.family, 2)

            # provably-empty short-circuits, mirroring the host pack
            # (extract_segment_events returning None)
            if (
                not keys
                or all(e.n_rows == 0 for e in extents)
                or (len(keys) >= 2 and any(e.n_rows == 0 for e in extents))
            ):
                account()
                if st is not None:
                    st.empty_subqueries += 1
                continue
            arena_items.append((qi, sub, keys, extents, res))
            # the accounting thunk applies ONLY if the arena plan succeeds:
            # on ArenaOverflow the host pack does its own counting (no
            # double charge, no phantom arena_hits)
            arena_fallback.append((qi, (sub, view, keys), account))

    results: list[FusedBatchResult | PendingBatch] = []
    if arena_items:
        try:
            aplan = plan_arena_batch(arena_items, n_queries=len(work))
        except ArenaOverflow:
            aplan = None
            for qi, item3, account in arena_fallback:
                account(hit=False)
                host_work[qi].append(item3)
        if aplan is not None:
            for _qi, _item3, account in arena_fallback:
                account()
        # the arena's whole host side — routing + descriptor planning — is
        # the pack phase (there is no plan phase: no posting is read)
        t0 = _phase(sink, "pack_us", t0)
        if aplan is not None:
            results.append(
                run_arena_batch(
                    aplan,
                    max_distance=max_distance,
                    top_k=top_k,
                    use_kernel=use_kernel,
                    stats=batch_stats,
                    phases=sink,
                    readout=readout,
                    defer=defer,
                )
            )
            _DISPATCHES += 1
    if any(host_work):
        hplan = plan_query_batch(
            host_work,
            doc_len=doc_len,
            stats=stats,
            intersect_device_threshold=intersect_device_threshold,
            device=device,
        )
        if hplan is not None:
            results.append(
                run_query_batch(
                    hplan,
                    max_distance=max_distance,
                    top_k=top_k,
                    use_kernel=use_kernel,
                    compute_dtype=compute_dtype,
                    stats=batch_stats,
                    readout=readout,
                    defer=defer,
                    device=device,
                )
            )
    n_queries = len(work)
    if not results:
        empty = empty_batch_result(n_queries, top_k)
        return PendingBatch(lambda: empty) if defer else empty
    if defer:
        pending = list(results)
        return PendingBatch(
            lambda: _merge_results([p.result() for p in pending], n_queries, top_k)
        )
    return _merge_results(results, n_queries, top_k)
