"""Vectorized §3 row generation (DESIGN.md §17.1): ``build_segment_fast``.

``builder._RowAccumulator`` walks every occurrence with Python loops — per
occurrence it re-scans a ±MaxDistance window for pairs, stop pairs and
triples, and per non-stop occurrence it collects near-stop-word neighbours.
That per-token interpretation cost is what caps full builds at double-digit
docs/s.  This module generates the SAME rows as flat numpy batches:

* all documents of a batch are flattened into one occurrence table
  ``(doc, pos, gpos, lemma_id)`` where ``gpos`` is a *global* position with a
  ``MaxDistance + 1`` gap between documents — a single sorted axis on which
  every ±D window is two ``np.searchsorted`` calls and windows can never
  cross a document boundary;
* window memberships become ``repeat``/``arange`` ragged gathers, the §3
  pair/stop-pair/triple acceptance rules become boolean masks over those
  gathers (triples enumerate each window's unordered occurrence pairs once
  and orient them by the §3 rank/position rules, blocked to bound the
  working set);
* each family is finalized with ONE ``np.lexsort`` over (packed key, row
  columns) and split at key boundaries — per key this is exactly
  ``builder._sorted_rows``'s order, and NSW payloads are gathered under the
  same (stable) permutation the scalar ``finalize`` applies.

Exactness is the whole point: ``build_segment_fast(...)`` is
``index_sets_equal``-identical (rows, NSW offsets and payload order
included) to ``builder.build_segment(...)`` for every input — the §17
property suite and the CI differential gate pin this, which is what lets
the SPIMI bulk-ingest pipeline (``index/ingest.py``) and the incremental
committer use the fast path while ``build_segment`` stays the scalar
oracle.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.lemma import FLList, LemmaType
from .builder import IndexSet, NSWRecords

__all__ = ["build_segment_fast"]

_STOP = int(LemmaType.STOP)
_FU = int(LemmaType.FREQUENTLY_USED)

# per-center window-pair candidates processed per block: bounds the peak
# working set of the triple cross product without changing any output
_TRIPLE_BLOCK = 1 << 21


def _cumsum0(a: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a) + 1, dtype=np.int64)
    np.cumsum(a, out=out[1:])
    return out


def _ragged_take(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Flat gather indices for ragged slices: element j of slice i is
    ``starts[i] + j`` — the repeat/arange pattern shared with the
    incremental NSW merge."""
    total = int(counts.sum())
    return (
        np.repeat(starts, counts)
        + np.arange(total, dtype=np.int64)
        - np.repeat(_cumsum0(counts)[:-1], counts)
    )


def _pack_keys(keycols: Sequence[np.ndarray], n_vocab: int) -> np.ndarray:
    """Mixed-radix pack of per-row key-id tuples into one int64 column —
    packed order == lexicographic id-tuple order, so one sort key replaces
    ``arity`` of them."""
    assert n_vocab ** len(keycols) < 2**63, "vocabulary too large to pack keys"
    packed = keycols[0].astype(np.int64, copy=True)
    for k in keycols[1:]:
        packed *= n_vocab
        packed += k
    return packed


def _family_dict(
    keycols: Sequence[np.ndarray],
    rowcols: Sequence[np.ndarray],
    vlist: list[str],
) -> dict:
    """Sort rows (packed key major, row columns minor — per key exactly
    ``_sorted_rows``'s lexicographic order), split at key boundaries, and
    assemble the key -> rows dict without per-row Python work."""
    n = len(rowcols[0])
    if n == 0:
        return {}
    packed = _pack_keys(keycols, len(vlist))
    order = np.lexsort(tuple(reversed(rowcols)) + (packed,))
    packed = packed[order]
    rows = np.stack([r[order] for r in rowcols], axis=1).astype(np.int32)
    starts = np.concatenate(
        ([0], np.flatnonzero(packed[1:] != packed[:-1]) + 1, [n])
    )
    arity = len(keycols)
    head = packed[starts[:-1]]
    cols: list[list[str]] = []
    for _ in range(arity):
        cols.append([vlist[i] for i in (head % len(vlist)).tolist()])
        head = head // len(vlist)
    keys = list(zip(*reversed(cols)))  # zip builds the key tuples in C
    return {
        k: rows[s:e]
        for k, s, e in zip(keys, starts[:-1].tolist(), starts[1:].tolist())
    }


def _candidates(
    documents: Sequence,
    fl: FLList,
    D: int,
    build_pair: bool,
    build_degenerate: bool,
    triple_key_filter: set[tuple[str, str, str]] | None,
) -> dict | None:
    """Shared §3 candidate generation: the occurrence table, the NSW flats
    and every family's pre-sort (key-id columns, row columns) arrays.
    ``build_segment_fast`` assembles these into an in-RAM ``IndexSet``;
    the spill writer (``ingest._write_spill_fast``) sorts the same arrays
    by lexicographic key rank and encodes them straight to disk.  Returns
    ``None`` when the batch has no occurrences."""

    # ---- flatten the batch into one occurrence table ---------------------
    # One pass over the whole batch instead of ~10 small numpy calls per
    # document: token counts and per-token lemma counts are gathered once,
    # and positions / doc ids / gap-shifted global positions are derived
    # with batch-wide repeat/cumsum arithmetic (identical values to the
    # per-doc construction — pinned by the builder differential suite).
    streams = [doc.lemma_stream for doc in documents]
    n_tok = np.fromiter(
        (len(s) for s in streams), dtype=np.int64, count=len(streams)
    )
    total_tok = int(n_tok.sum())
    flat = [l for s in streams for t in s for l in t]
    n = len(flat)
    if n == 0:
        return None
    lens = np.fromiter(
        (len(t) for s in streams for t in s), dtype=np.int64, count=total_tok
    )
    tok_start = _cumsum0(n_tok)  # doc boundaries on the token axis
    # token position within its document
    tok_pos = np.arange(total_tok, dtype=np.int64) - np.repeat(
        tok_start[:-1], n_tok
    )
    occ_start = _cumsum0(lens)  # doc boundaries on the occurrence axis
    occ_per_doc = occ_start[tok_start[1:]] - occ_start[tok_start[:-1]]
    pos = np.repeat(tok_pos, lens)
    doc = np.repeat(
        np.fromiter((d.doc_id for d in documents), dtype=np.int64,
                    count=len(documents)),
        occ_per_doc,
    )
    # windows can never cross documents: shift each doc by a D+1 gap
    gpos = pos + np.repeat(_cumsum0(n_tok + D + 1)[:-1], occ_per_doc)

    # one C-level unique pass interns the vocabulary: ids ARE lexicographic
    # ranks (ascending lemma order), which the spill writer relies on
    vlist_arr, lid = np.unique(np.asarray(flat), return_inverse=True)
    lid = lid.astype(np.int64)
    vlist = vlist_arr.tolist()
    vtyp = np.asarray([int(fl.lemma_type(l)) for l in vlist], dtype=np.int8)
    vnum = np.asarray([fl.number(l) for l in vlist], dtype=np.int64)
    typ = vtyp[lid]
    num = vnum[lid]

    # ±D window of every occurrence over the one sorted global-position axis
    lo = np.searchsorted(gpos, gpos - D, side="left")
    hi = np.searchsorted(gpos, gpos + D + 1, side="left")  # exclusive

    sidx = np.flatnonzero(typ == _STOP)  # stop occurrences, in batch order
    sg = gpos[sidx]
    slo = np.searchsorted(sg, gpos - D, side="left")
    shi = np.searchsorted(sg, gpos + D + 1, side="left")

    # ---- NSW payload flats (pre-sort, per occurrence) --------------------
    nsw_counts = np.where(typ != _STOP, shi - slo, 0)
    pay_idx = _ragged_take(slo, nsw_counts)  # indices into sidx
    rep_occ = np.repeat(np.arange(n, dtype=np.int64), nsw_counts)
    nsw_stop_flat = vnum[lid[sidx[pay_idx]]]
    nsw_dist_flat = pos[sidx[pay_idx]] - pos[rep_occ]
    pay_starts = _cumsum0(nsw_counts)[:-1]  # per-occurrence payload start

    # ---- (w,v) pair candidates ------------------------------------------
    pair_cand = None
    if build_pair:
        c = np.flatnonzero(typ == _FU)
        cnt = hi[c] - lo[c]
        j = _ragged_take(lo[c], cnt)  # neighbour occ index (incl. self)
        ci = np.repeat(c, cnt)
        keep = (
            (j != ci)
            & (typ[j] != _STOP)
            & ~((typ[j] == _FU) & (num[ci] >= num[j]))
        )
        ci, j = ci[keep], j[keep]
        pair_cand = (
            (lid[ci], lid[j]),
            (doc[ci], pos[ci], pos[j] - pos[ci]),
        )

    # ---- degenerate stop pair candidates ---------------------------------
    # per-stop-occurrence views: one gather each, then every candidate
    # lookup below indexes these directly instead of through sidx twice
    stop_pair_cand = None
    ns = len(sidx)
    sclo = slo[sidx]  # stop-window bounds per stop occurrence
    schi = shi[sidx]
    snum = num[sidx]
    sgpos = gpos[sidx]
    slid = lid[sidx]
    sdoc = doc[sidx]
    spos = pos[sidx]
    if build_degenerate and ns:
        cnt = schi - sclo
        js = _ragged_take(sclo, cnt)  # neighbour index into sidx
        ai = np.repeat(np.arange(ns, dtype=np.int64), cnt)  # center's sidx pos
        keep = (js != ai) & (
            (snum[ai] < snum[js])
            | ((snum[ai] == snum[js]) & (sgpos[ai] < sgpos[js]))
        )
        ai, js = ai[keep], js[keep]
        stop_pair_cand = (
            (slid[ai], slid[js]),
            (sdoc[ai], spos[ai], spos[js] - spos[ai]),
        )

    # ---- (f,s,t) triple candidates --------------------------------------
    triple_cand = None
    if ns:
        allowed = None
        V = len(vlist)
        if triple_key_filter is not None:
            vocab = {l: i for i, l in enumerate(vlist)}
            packed = [
                (vocab[a] * V + vocab[b]) * V + vocab[c]
                for a, b, c in triple_key_filter
                if a in vocab and b in vocab and c in vocab
            ]
            allowed = np.asarray(sorted(packed), dtype=np.int64)
        m = schi - sclo
        msq = m * m
        key_parts: list[np.ndarray] = []
        row_parts: list[tuple[np.ndarray, ...]] = []
        blocks = _cumsum0(msq)
        start = 0
        while start < ns:
            # grow the center block until its window cross-product count
            # hits the cap
            end = int(
                np.searchsorted(blocks, blocks[start] + _TRIPLE_BLOCK, side="left")
            )
            end = min(max(end, start + 1), ns)
            A = np.arange(start, end, dtype=np.int64)
            msq_a = msq[A]
            total = int(msq_a.sum())
            start = end
            if total == 0:
                continue
            t = (
                np.arange(total, dtype=np.int64)
                - np.repeat(_cumsum0(msq_a)[:-1], msq_a)
            )
            mrep = np.repeat(m[A], msq_a)
            base = np.repeat(sclo[A], msq_a)
            ai = np.repeat(A, msq_a)  # center's index into sidx
            # enumerate each unordered window pair {u < v} once (strict
            # upper triangle), excluding the center itself
            us = base + t // mrep
            vs = base + t % mrep
            tri = (us < vs) & (us != ai) & (vs != ai)
            us, vs, ai = us[tri], vs[tri], ai[tri]
            ni = snum[ai]
            nu = snum[us]
            nv = snum[vs]
            keep = (nu >= ni) & (nv >= ni)  # f most frequent of the triple
            us, vs, ai = us[keep], vs[keep], ai[keep]
            nu, nv = nu[keep], nv[keep]
            # orient the pair into canonical (s, t): ascending rank; equal
            # ranks order by position, exact position ties by the scalar's
            # window-order rule (`b < a`), which for u < v emits (v, u)
            gu = sgpos[us]
            gv = sgpos[vs]
            swap = (nv < nu) | ((nu == nv) & (gu >= gv))
            js = np.where(swap, vs, us)
            ks = np.where(swap, us, vs)
            pk = (slid[ai] * V + slid[js]) * V + slid[ks]
            if allowed is not None:
                inset = np.isin(pk, allowed)
                ai, js, ks, pk = ai[inset], js[inset], ks[inset], pk[inset]
            key_parts.append(pk)
            row_parts.append(
                (sdoc[ai], spos[ai], spos[js] - spos[ai], spos[ks] - spos[ai])
            )
        if key_parts:
            packed_all = np.concatenate(key_parts)
            k1 = packed_all // (V * V)
            rem = packed_all % (V * V)
            rowcols = tuple(
                np.concatenate([p[i] for p in row_parts]) for i in range(4)
            )
            triple_cand = ((k1, rem // V, rem % V), rowcols)

    return {
        "n": n,
        "vlist": vlist,
        "vtyp": vtyp,
        "vnum": vnum,
        "lid": lid,
        "doc": doc,
        "pos": pos,
        "nsw_counts": nsw_counts,
        "pay_starts": pay_starts,
        "nsw_stop_flat": nsw_stop_flat,
        "nsw_dist_flat": nsw_dist_flat,
        "pair": pair_cand,
        "stop_pair": stop_pair_cand,
        "triple": triple_cand,
    }


def build_segment_fast(
    documents: Sequence,
    fl: FLList,
    max_distance: int = 5,
    build_pair: bool = True,
    build_degenerate: bool = True,
    triple_key_filter: set[tuple[str, str, str]] | None = None,
) -> IndexSet:
    """Drop-in vectorized replacement for ``builder.build_segment`` (the
    §3 index families; DESIGN.md §17.1) — byte-identical output (see
    module docstring), same signature."""
    D = int(max_distance)
    n_docs = len(documents)
    cand = _candidates(
        documents, fl, D, build_pair, build_degenerate, triple_key_filter
    )
    if cand is None:
        return IndexSet(
            fl=fl, max_distance=D, ordinary={}, nsw={}, pair={}, triple={},
            stop_single={}, stop_pair={}, n_docs=n_docs,
        )
    n = cand["n"]
    vlist = cand["vlist"]
    vtyp = cand["vtyp"]
    lid, doc, pos = cand["lid"], cand["doc"], cand["pos"]

    # ---- ordinary index + NSW -------------------------------------------
    # One stable lexsort (pos, doc, lemma) gives every lemma's rows in
    # exactly _sorted_rows order AND — because ties keep insertion order —
    # the same per-lemma permutation finalize() applies to NSW slices.
    order = np.lexsort((pos, doc, lid))
    lid_s = lid[order]
    ord_rows = np.stack((doc[order], pos[order]), axis=1).astype(np.int32)
    counts_s = cand["nsw_counts"][order]
    src = _ragged_take(cand["pay_starts"][order], counts_s)
    stop_s = cand["nsw_stop_flat"][src].astype(np.int32)
    dist_s = cand["nsw_dist_flat"][src].astype(np.int32)
    pcs = _cumsum0(counts_s)

    bnd = np.concatenate(
        ([0], np.flatnonzero(lid_s[1:] != lid_s[:-1]) + 1, [n])
    )
    group_ids = lid_s[bnd[:-1]].tolist()
    group_stop = (vtyp[lid_s[bnd[:-1]]] == _STOP).tolist()
    ordinary: dict[str, np.ndarray] = {}
    nsw: dict[str, NSWRecords] = {}
    stop_single: dict[tuple[str], np.ndarray] = {}
    for v, is_stop, s, e in zip(
        group_ids, group_stop, bnd[:-1].tolist(), bnd[1:].tolist()
    ):
        lemma = vlist[v]
        rows = ord_rows[s:e]
        ordinary[lemma] = rows
        if not is_stop:
            nsw[lemma] = NSWRecords(
                offsets=pcs[s : e + 1] - pcs[s],
                stop_lemma=stop_s[pcs[s] : pcs[e]],
                distance=dist_s[pcs[s] : pcs[e]],
            )
        elif build_degenerate:
            # a stop lemma's degenerate single-key rows ARE its ordinary
            # rows (same (doc,pos) content, same order) — share the slice
            stop_single[(lemma,)] = rows

    pair = (
        _family_dict(*cand["pair"], vlist) if cand["pair"] is not None else {}
    )
    stop_pair = (
        _family_dict(*cand["stop_pair"], vlist)
        if cand["stop_pair"] is not None else {}
    )
    triple = (
        _family_dict(*cand["triple"], vlist)
        if cand["triple"] is not None else {}
    )

    return IndexSet(
        fl=fl,
        max_distance=D,
        ordinary=ordinary,
        nsw=nsw,
        pair=pair,
        triple=triple,
        stop_single=stop_single,
        stop_pair=stop_pair,
        n_docs=n_docs,
    )
