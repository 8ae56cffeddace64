"""Device-resident posting arena: on-device gather/pack for the fused
pipeline (DESIGN.md §13), on torch.

The host-pack path (``search/fused.py``) gathers posting slices, builds
occurrence tables and packs padded event arrays on the host for every
batch.  This module moves the hot posting columns onto the device **once
per index generation** and does the gather/pack there:

* :class:`PostingArena` — a byte-budgeted LRU of device-resident posting
  families.  Per ``(view, generation token, shard)``, each §3 family's keys
  are transformed into **per-slot event streams**: for every key and
  component slot, the sorted-unique ``(doc, pos)`` pairs the slot
  contributes (the query-independent half of the host pack, hoisted to
  upload time).  Streams are concatenated (``index.builder.family_rows``
  key order, every extent aligned to ``ARENA_BLOCK`` rows) into ONE int32
  tensor per family on the arena's ``device``.

* :func:`plan_arena_batch` — per batch, the host ships only
  **descriptors**: per work item, per selected key, the slot extents plus
  (segment id, lemma id, Step-1/emit flags, key index).  No posting row is
  touched on the host.

* :func:`arena_serve_batch` — ONE device program per batch: stage 0 slices
  the arena (the CUDA block-gather kernel ``kernels/gather.py`` with
  ``use_kernel=True``, an indexed gather otherwise), then on-device sorts
  rebuild the host pack's event pipeline — Step-1 document alignment,
  cross-key event dedup, the Step-2 multiplicity gate, the event-centric
  rank cover — and the same §14 scoring, per-query top-k and §15.1 result
  assembly as ``fused_serve_batch``.

Exactness contract: arena-path fragment sets are identical to the host-pack
path, to the reference package's arena program and to its scalar Combiner
(``tests/test_torch_arena.py``).  Keys that are not resident fall back to
the host-pack path, as do batches whose packed int32 composites would
overflow (:class:`ArenaOverflow`).  This module ports
``src/repro/search/arena.py`` for plain and incremental sources, with the
indexer's mutation hooks (``attach``), without the HLO lowering
(``lower_arena_batch``) or fault injection.
"""

from __future__ import annotations

import itertools
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core.postings import QueryStats, SearchResult
from ..index.builder import POSTING_WIDTH, IndexSet, family_rows
from ..index.incremental import IncrementalIndexer
from ..kernels.gather import ARENA_BLOCK, gather_blocks
from ..launch.cost_analysis import ProgramCost, count_cost
from .fused import _assemble_fragments, bucket_pow2 as _bucket

__all__ = [
    "ARENA_BLOCK",
    "ArenaOverflow",
    "ArenaResidency",
    "KeyExtent",
    "PostingArena",
    "plan_arena_batch",
    "arena_serve_batch",
    "lower_arena_batch",
    "run_arena_batch",
]

# §3 families `IndexSet.key_postings` serves (ordinary/NSW never reach it)
_ARENA_FAMILIES = ("stop_single", "stop_pair", "pair", "triple")

_I32_MAX = int(np.iinfo(np.int32).max)

# view identities for arena entry keys, unique across every arena of the
# process: a view stamped by one arena keeps its stamp, so a per-arena
# counter could hand a second view the same number in another arena
_SOURCE_IDS = itertools.count(1)

class ArenaOverflow(RuntimeError):
    """A batch's packed composites would not fit the int32 bit budgets of
    the §13.4 device program (DESIGN.md §13.3).  Callers fall back to the
    host-pack path — exactness is never at stake, only the gather
    locality."""


class SlotExtent(NamedTuple):
    """One (key, slot) event stream's slice of its §3 family buffer
    (DESIGN.md §13.1)."""

    block_start: int  # first arena block of the extent
    n_events: int  # sorted-unique (doc, pos) pairs in the stream
    max_pos: int


class KeyExtent(NamedTuple):
    """One §6 key's arena residency (DESIGN.md §13.1): per-slot stream
    extents plus the upload-time statistics the planner needs to size
    budgets — and keep the §11 postings-read accounting exact — without
    reading a single row."""

    family: str
    n_rows: int  # raw §4 rows (the §11 postings-read accounting unit)
    n_docs: int  # distinct doc ids (slot-0 stream — every row contributes)
    max_doc: int
    slots: tuple  # SlotExtent per component slot


_ZERO_EXTENT = KeyExtent("", 0, 0, 0, ())


@dataclass
class _FamilyBuffer:
    """One resident (view, token, shard, family) upload."""

    buf: torch.Tensor  # [n_blocks_pow2 * BLOCK, 2] int32 (doc, pos) streams
    extents: dict  # canonical key -> KeyExtent
    nbytes: int


@dataclass
class ArenaResidency:
    """The resident §3 families of one (generation token, shard) — the
    handle work items carry into ``serve_query_batch`` (DESIGN.md §13.2)."""

    token: object
    shard: int
    families: dict = field(default_factory=dict)  # fname -> _FamilyBuffer

    def lookup(self, components: tuple) -> KeyExtent | None:
        """Arena extent for a canonical key, mirroring
        ``IndexSet.key_postings`` dispatch exactly; ``None`` = the serving
        family is not resident (host fallback), a zero-row extent = the key
        is resident-but-absent (provably empty, no fallback needed)."""
        arity = len(components)
        if arity == 3:
            fams = ("triple",)
        elif arity == 2:
            # stop_pair precedes pair in key_postings; the two key spaces
            # are disjoint (stop/stop vs FU-anchored), so a hit in either is
            # authoritative, but proving ABSENCE needs both resident.
            fams = ("stop_pair", "pair")
        else:
            fams = ("stop_single",)
        for fname in fams:
            fb = self.families.get(fname)
            if fb is not None:
                ext = fb.extents.get(components)
                if ext is not None:
                    return ext
        if all(f in self.families for f in fams):
            return _ZERO_EXTENT
        return None

    def buffer(self, fname: str) -> torch.Tensor:
        return self.families[fname].buf


def _family_streams(arrays: list[np.ndarray], width: int, block: int):
    """Every key's per-slot sorted-unique (doc, pos) event streams of one
    family's §4 rows — the query-independent half of
    ``extract_segment_events`` hoisted to upload time; slot ``s``'s position
    is the anchor position plus the slot's signed distance (DESIGN.md
    §13.1) — laid out as the arena buffer holds them: key by key, slot by
    slot, each stream padded to whole blocks.  One sort a slot over the
    whole family, where the reference takes ``np.unique`` key by key (the
    same streams: a cold acquire of the launcher's 4 shards spent most of
    its time in that loop).

    Returns ``(rows, events, first_block, n_events, max_pos, n_docs,
    max_doc, n_blocks)``: each event's buffer row and (doc, pos) pair, and
    per (key, slot) its first block, event count and largest position, per
    key its distinct documents and last document, and the blocks in all."""
    n_keys, n_slots = len(arrays), width - 1
    lens = np.fromiter((len(a) for a in arrays), np.int64, n_keys)
    rows = np.concatenate(arrays) if n_keys else np.empty((0, width), np.int32)
    key = np.repeat(np.arange(n_keys), lens)
    doc = rows[:, 0].astype(np.int64)
    uniq = []
    n_events = np.zeros((n_keys, n_slots), np.int64)
    for s in range(n_slots):
        pos = rows[:, 1].astype(np.int64)
        if s > 0:
            pos = pos + rows[:, 1 + s]
        comp = (doc << 32) | pos
        order = np.lexsort((comp, key))
        k, c = key[order], comp[order]
        keep = np.ones(len(c), bool)
        keep[1:] = (k[1:] != k[:-1]) | (c[1:] != c[:-1])
        uniq.append((k[keep], c[keep]))
        n_events[:, s] = np.bincount(k[keep], minlength=n_keys)
    n_blocks = -(-n_events // block)
    first_block = np.zeros(n_keys * n_slots, np.int64)
    np.cumsum(n_blocks.ravel()[:-1], out=first_block[1:])
    first_block = first_block.reshape(n_keys, n_slots) if n_keys else first_block.reshape(0, n_slots)
    max_pos = np.zeros((n_keys, n_slots), np.int64)
    dest, events = [], []
    for s, (k, c) in enumerate(uniq):
        start = np.zeros(n_keys, np.int64)
        np.cumsum(n_events[:-1, s], out=start[1:])
        dest.append(first_block[k, s] * block + np.arange(len(k)) - start[k])
        pair = np.stack(((c >> 32).astype(np.int32), (c & 0xFFFFFFFF).astype(np.int32)), axis=1)
        events.append(pair)
        live = n_events[:, s] > 0
        if live.any():
            max_pos[live, s] = np.maximum.reduceat(pair[:, 1], start[live])
    # distinct documents a key (its rows are in §4 order: doc sorted) and
    # its last document
    change = (rows[1:, 0] != rows[:-1, 0]) & (key[1:] == key[:-1])
    n_docs = 1 + np.bincount(key[1:][change], minlength=n_keys)
    ends = np.cumsum(lens) - 1
    max_doc = np.where(lens > 0, rows[np.maximum(ends, 0), 0] if len(rows) else 0, 0)
    return (np.concatenate(dest) if dest else np.empty(0, np.int64),
            np.concatenate(events) if events else np.empty((0, 2), np.int32),
            first_block, n_events, max_pos, n_docs, max_doc, int(n_blocks.sum()))


class PostingArena:
    """Byte-budgeted LRU of device-resident posting families (DESIGN.md
    §13.1), on ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``).

    ``acquire`` is the only serving-path entry: it returns (uploading on
    first touch) the :class:`ArenaResidency` for an index view under its
    generation token.  Warm acquires are dictionary hits.  Families that do
    not fit the budget are left non-resident — ``serve_query_batch`` routes
    their work items through the host pack, so residency is a locality
    optimization, never a correctness surface.
    """

    def __init__(
        self,
        budget_bytes: int = 256 << 20,
        block: int = ARENA_BLOCK,
        device="cuda",
    ):
        self.budget_bytes = int(budget_bytes)
        self.block = int(block)
        self.device = torch.device(device)
        self._entries: OrderedDict[tuple, _FamilyBuffer] = OrderedDict()
        self._bytes = 0
        # entry keys refused under the CURRENT budget, with the bytes each
        # upload would have taken: not re-attempted (re-building the
        # host-side concat per batch would reintroduce the per-batch
        # O(postings) host work the arena exists to remove).  A bounded
        # FIFO shared across callers
        self.refused: OrderedDict[tuple, int] = OrderedDict()
        self._refused_cap = 512
        self._unsubscribers: list = []
        self.hits = 0  # warm family acquires
        self.misses = 0  # family uploads + budget refusals
        self.uploads = 0
        self.upload_bytes = 0  # H2D bytes spent on arena uploads
        self.evictions = 0
        # §14 fault injection (``search/resilience.py``): an injected
        # ``arena.acquire`` overflow refuses the round — its keys take the
        # host pack (fragments identical), counted in ``pressure_events``
        self.injector = None
        self.pressure_events = 0

    # ---- residency --------------------------------------------------------

    def acquire(self, view: IndexSet, token: object, shard: int = 0) -> ArenaResidency:
        """Resident families of ``view`` under ``token`` — uploads what is
        missing (and fits), touches what is warm."""
        return self.acquire_many([(view, token, shard)])[0]

    def acquire_many(self, specs: Sequence[tuple]) -> list[ArenaResidency]:
        """Residencies for a whole serving round — ``specs`` lists
        ``(view, token, shard)`` per live shard.  All of the round's entries
        are PINNED against each other's admissions: a budget smaller than
        the round's working set yields stable partial residency instead of
        views evicting one another's buffers every batch."""
        if self.injector is not None:
            from .resilience import InjectedFault

            try:
                self.injector.fire("arena.acquire")
            except InjectedFault:
                # injected device-memory pressure (§14): refuse the round —
                # empty residencies route every key through the host pack,
                # so fragments are identical, only locality degrades
                self.pressure_events += 1
                return [
                    ArenaResidency(token=token, shard=shard)
                    for _view, token, shard in specs
                ]

        # entry keys carry a per-VIEW identity stamped on first acquire:
        # generation tokens alone are not unique (every plain IndexSet has
        # token 0), so a shared arena must never let one source's buffers
        # answer for another's.  The stamp is a process-wide counter (never
        # reused, unlike id()) and travels with the view object
        def source_id(view) -> int:
            sid = getattr(view, "_arena_source_id", None)
            if sid is None:
                sid = next(_SOURCE_IDS)
                try:
                    view._arena_source_id = sid
                except AttributeError:  # __slots__ view: fall back to id()
                    sid = id(view)
            return sid

        sids = [source_id(view) for view, _token, _shard in specs]
        pinned = {
            (sid, token, shard, fname)
            for sid, (_view, token, shard) in zip(sids, specs)
            for fname in _ARENA_FAMILIES
        }
        out = []
        for sid, (view, token, shard) in zip(sids, specs):
            res = ArenaResidency(token=token, shard=shard)
            for fname in _ARENA_FAMILIES:
                key = (sid, token, shard, fname)
                fb = self._entries.get(key)
                if fb is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    res.families[fname] = fb
                    continue
                self.misses += 1
                if key in self.refused:
                    continue
                fb = self._upload_family(view, fname)
                if not self._admit(key, fb, pinned):
                    self.refused[key] = fb.nbytes
                    while len(self.refused) > self._refused_cap:
                        self.refused.popitem(last=False)
                    continue
                res.families[fname] = fb
            out.append(res)
        return out

    def _admit(self, key: tuple, fb: _FamilyBuffer, pinned=frozenset()) -> bool:
        """Insert under the byte budget, evicting LRU entries (never the
        current round's ``pinned`` ones); refuse (and drop) an upload that
        cannot fit even after evicting everything evictable."""
        if fb.nbytes > self.budget_bytes:
            return False
        while self._bytes + fb.nbytes > self.budget_bytes:
            victim = next((k for k in self._entries if k not in pinned), None)
            if victim is None:
                return False
            old = self._entries.pop(victim)
            self._bytes -= old.nbytes
            self.evictions += 1
        self._entries[key] = fb
        self._bytes += fb.nbytes
        return True

    def _upload_family(self, view: IndexSet, fname: str) -> _FamilyBuffer:
        width = POSTING_WIDTH[fname]
        keys, arrays, rows, _starts = family_rows(getattr(view, fname), width)
        block = self.block
        dest, events, first, n_ev, max_pos, n_docs, max_doc, blk = _family_streams(arrays, width, block)
        extents: dict = {}
        for k, n, fb, ne, mp, nd, md in zip(keys, rows.tolist(), first.tolist(), n_ev.tolist(), max_pos.tolist(),
                                            n_docs.tolist(), max_doc.tolist()):
            if n == 0:
                extents[k] = KeyExtent(fname, 0, 0, 0, ())
                continue
            extents[k] = KeyExtent(family=fname, n_rows=n, n_docs=nd, max_doc=md,
                                   slots=tuple(SlotExtent(*x) for x in zip(fb, ne, mp)))
        # pow2 total blocks: buffer shapes bucket across generations (§9.2)
        total_blocks = 1 << max(0, (max(blk, 1) - 1).bit_length())
        concat = np.full((total_blocks * block, 2), -1, np.int32)
        concat[dest] = events
        buf = torch.from_numpy(concat).to(self.device)
        self.uploads += 1
        self.upload_bytes += concat.nbytes
        return _FamilyBuffer(buf=buf, extents=extents, nbytes=concat.nbytes)

    # ---- invalidation (generation hooks, DESIGN.md §13.2) ------------------

    def attach(self, source) -> None:
        """Subscribe eager eviction to an index source's mutation hook: on
        every commit/committed-delete/compact, entries whose token is no
        longer live for the source are dropped at once instead of aging out
        by LRU, and with them the arena's last reference to their device
        buffers.  Token-keyed residency is already correct without this
        (stale tokens are unreachable); attaching just returns the bytes
        sooner.  A plain ``IndexSet`` never mutates, so attaching one is a
        no-op.  ``detach()`` removes the subscriptions (an arena that
        outlives its usefulness must detach, or the indexer's listener list
        keeps it alive)."""
        indexers = getattr(source, "indexers", None)
        if indexers is None and isinstance(source, IncrementalIndexer):
            indexers = [source]
        if not indexers:
            return

        # evict ONLY tokens this source previously served (tracked across
        # mutations), never unrelated sources' entries that happen to carry
        # a colliding token value — entry keys are (sid, token, shard,
        # family) and a shared arena may hold other sources' buffers
        prev_tokens = {ix.generation_token for ix in indexers}

        def _on_mutation(_ix) -> None:
            nonlocal prev_tokens
            live = {ix.generation_token for ix in indexers}
            stale = prev_tokens - live
            for key in [k for k in self._entries if k[1] in stale]:
                fb = self._entries.pop(key)
                self._bytes -= fb.nbytes
                self.evictions += 1
            prev_tokens = live

        for ix in indexers:
            self._unsubscribers.append(ix.subscribe(_on_mutation))

    def detach(self) -> None:
        """Remove every mutation subscription made by ``attach`` (DESIGN.md
        §13.2) — idempotent; the arena keeps working, invalidation reverts
        to token-keyed LRU aging."""
        for unsub in self._unsubscribers:
            unsub()
        self._unsubscribers = []

    def release(self) -> None:
        """Drop every resident buffer and refusal record (DESIGN.md §13.2)
        — the normal eviction path, so counters stay consistent.  The arena
        remains usable and re-uploads on the next acquire."""
        self.evictions += len(self._entries)
        self._entries.clear()
        self._bytes = 0
        self.refused.clear()

    # ---- introspection ----------------------------------------------------

    @property
    def size_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def metrics(self) -> dict:
        lookups = self.hits + self.misses
        return {
            "arena_bytes": self._bytes,
            "arena_entries": len(self._entries),
            "arena_hit_rate": self.hits / lookups if lookups else 0.0,
            "arena_hits": self.hits,
            "arena_misses": self.misses,
            "arena_uploads": self.uploads,
            "arena_upload_bytes": self.upload_bytes,
            "arena_evictions": self.evictions,
            "arena_pressure_events": self.pressure_events,
        }


# ---------------------------------------------------------------------------
# §13.3 descriptor planning (host side: O(keys), zero posting reads)
# ---------------------------------------------------------------------------


@dataclass
class ArenaBatchPlan:
    """Fixed-shape descriptor arrays for one arena device program — the
    §13.3 descriptor ABI.  Everything here is O(work items + arena blocks);
    no posting row is ever materialized on the host.

    Every key contributes its slot-0 stream as the Step-1 membership witness
    (``kd=1``); streams of unstarred slots additionally emit events
    (``emit=1``).  Two ABI forms ride in one plan: the block-aligned form
    steers the gather kernel, the dense form packs extents back to back for
    the indexed gather so the event budget tracks real rows.
    """

    # one gather GROUP per (residency, family) pair
    families: tuple  # group labels (fname per group)
    buffers: list  # per group: device buffer (resident, NOT per-batch H2D)
    # block-aligned form, consumed by the gather kernel (use_kernel=True):
    src: list  # per group: [Gg] int32 arena block index per output block
    nv: list  # per group: [Gg] int32 live rows per output block
    blk_meta: list  # per group: [Gg, 5] int32 (seg, lem, kd, emit, key)
    # dense form, consumed by the indexed gather (no block padding):
    d_src: list  # per group: [Dg] int32 first arena ROW of each descriptor
    d_n: list  # per group: [Dg] int32 events per descriptor
    d_dest: list  # per group: [Dg] int32 dense output offset (cumsum of d_n)
    d_meta: list  # per group: [Dg, 5] int32 (seg, lem, kd, emit, key)
    e_budget: list  # per group: pow2 dense event budget
    n_keys: np.ndarray  # [S] int32
    mult: np.ndarray  # [S, L] int32
    seg_query: np.ndarray  # [S] int32
    n_queries: int
    query_budget: int
    n_budget: int  # position budget (pow2)
    row_budget: int  # candidate-row budget (pow2)
    lemma_budget: int  # pow2
    key_budget: int  # keys-per-work-item budget (pow2)
    doc_bits: int  # bit width of the largest doc id in the batch
    tier: str  # "pack32" (one fused sort) or "argsort" (wide doc ids)
    block: int
    n_events: int  # gathered stream events (pre-padding), for accounting


def plan_arena_batch(
    items: Sequence[tuple],
    *,
    n_queries: int,
    block: int = ARENA_BLOCK,
) -> ArenaBatchPlan | None:
    """Pack arena-resident work items into one device program's descriptors
    (the host-side half of the §10.4 event pipeline, reduced to extent
    arithmetic).

    ``items`` are ``(query_index, subquery, keys, extents, residency)``
    tuples whose keys ALL resolved to arena extents (``serve_query_batch``
    does the split and the empty-work short-circuits).  Returns ``None``
    when nothing would be gathered; raises :class:`ArenaOverflow` when the
    packed int32 composites cannot hold this batch.
    """
    if not items:
        return None
    # gather groups keyed by (residency identity, family): items from
    # different shards never share a group even for the same family name
    fam_desc: dict[tuple, list] = {}
    group_buf: dict[tuple, object] = {}
    n_keys = np.zeros(len(items), np.int32)
    seg_query = np.full(len(items), -1, np.int32)
    max_l = 1
    max_pos = 0
    max_doc = 0
    row_bound = 0
    n_events = 0
    mult_rows: list[np.ndarray] = []
    for seg, (qi, sub, keys, extents, res) in enumerate(items):
        lemmas = sub.unique_lemmas()
        lid = {l: i for i, l in enumerate(lemmas)}
        mult_map = sub.multiplicity()
        mult_rows.append(np.array([mult_map[l] for l in lemmas], np.int32))
        max_l = max(max_l, len(lemmas))
        seg_query[seg] = qi
        n_keys[seg] = len(keys)
        for key_local, (key, ext) in enumerate(zip(keys, extents)):
            # deterministic group order: by (shard, family); id() only
            # breaks the tie of two residencies claiming one shard
            gkey = (res.shard, ext.family, id(res))
            group_buf.setdefault(gkey, res.buffer(ext.family))
            max_doc = max(max_doc, ext.max_doc)
            row_bound += ext.n_docs
            unstarred = {s for s, _ in key.active_components()}
            for slot, se in enumerate(ext.slots):
                kd = 1 if slot == 0 else 0
                emit = 1 if slot in unstarred else 0
                if not (kd or emit) or se.n_events == 0:
                    continue
                if emit:
                    max_pos = max(max_pos, se.max_pos)
                n_events += se.n_events
                fam_desc.setdefault(gkey, []).append(
                    (
                        se.block_start,
                        se.n_events,
                        seg,
                        lid[key.components[slot]] if emit else 0,
                        kd,
                        emit,
                        key_local,
                    )
                )
    if not fam_desc:
        return None

    # ---- int32 composite bit budgets ---------------------------------------
    n_budget = _bucket(max_pos + 1, lo=64)
    lemma_budget = _bucket(max_l, lo=2)
    s_budget = _bucket(len(items))
    key_budget = _bucket(int(n_keys.max()))
    row_budget = _bucket(min(max(row_bound, 1), max(n_events, 1)), lo=8)
    rb = max((row_budget - 1).bit_length(), 1)
    nb = (n_budget - 1).bit_length()
    lb = max((lemma_budget - 1).bit_length(), 1)
    sb = max((s_budget - 1).bit_length(), 1)
    kb = max((key_budget - 1).bit_length(), 1)
    db = max(int(max_doc).bit_length(), 1)
    if rb + nb + lb > 30:
        raise ArenaOverflow(
            f"dedup composite bits {rb}+{nb}+{lb} > 30 (rows={row_budget}, "
            f"positions={n_budget}, lemmas={lemma_budget})"
        )
    # one fused (seg, doc, key, kd, emit, pos, lemma) sort when everything
    # fits int32; wide doc-id spaces drop pos/lemma from the sort key and
    # pay payload gathers instead; wider still -> host-pack fallback
    if sb + db + kb + 2 + nb + lb <= 30:
        tier = "pack32"
    elif sb + db + kb + 2 <= 30:
        tier = "argsort"
    else:
        raise ArenaOverflow(
            f"row-group bits {sb}+{db}+{kb}+2 > 30 (doc ids up to {max_doc}; "
            f"wider per-shard doc spaces take the host path)"
        )

    group_keys = sorted(fam_desc, key=lambda gk: gk[:2])
    families = tuple(gk[1] for gk in group_keys)
    buffers = [group_buf[gk] for gk in group_keys]
    src: list = []
    nv: list = []
    blk_meta: list = []
    d_src: list = []
    d_n_d: list = []
    d_dest: list = []
    d_meta_d: list = []
    e_budget: list = []
    for gk in group_keys:
        descs = fam_desc[gk]
        d_bstart = np.asarray([d[0] for d in descs], np.int64)
        d_n = np.asarray([d[1] for d in descs], np.int64)
        d_meta = np.asarray([d[2:] for d in descs], np.int32)  # [D, 5]
        nblk = np.maximum(1, -(-d_n // block))
        g = _bucket(int(nblk.sum()))
        total = int(nblk.sum())
        # block j of descriptor d reads arena block bstart[d] + j and holds
        # min(block, n[d] - j*block) live rows
        desc_of = np.repeat(np.arange(len(descs)), nblk)
        starts = np.zeros(len(descs), np.int64)
        np.cumsum(nblk[:-1], out=starts[1:])
        within = np.arange(total, dtype=np.int64) - np.repeat(starts, nblk)
        pad = g - total
        src.append(np.concatenate(
            [(d_bstart[desc_of] + within).astype(np.int32), np.zeros(pad, np.int32)]
        ))
        nv.append(np.concatenate(
            [
                np.minimum(block, d_n[desc_of] - within * block).astype(np.int32),
                np.zeros(pad, np.int32),
            ]
        ))
        blk_meta.append(np.concatenate(
            [d_meta[desc_of], np.tile(np.array([[-1, 0, 0, 0, 0]], np.int32), (pad, 1))]
        ))
        # dense form: extents back to back, descriptor table pow2-padded
        # (zero-row pads), event budget = bucket(real rows)
        d = _bucket(len(descs))
        dest = np.zeros(len(descs), np.int64)
        np.cumsum(d_n[:-1], out=dest[1:])
        e_budget.append(_bucket(int(d_n.sum()), lo=block))
        d_src.append(np.concatenate(
            [(d_bstart * block).astype(np.int32), np.zeros(d - len(descs), np.int32)]
        ))
        d_n_d.append(np.concatenate(
            [d_n.astype(np.int32), np.zeros(d - len(descs), np.int32)]
        ))
        d_dest.append(np.concatenate(
            [dest.astype(np.int32), np.full(d - len(descs), int(d_n.sum()), np.int32)]
        ))
        d_meta_d.append(np.concatenate(
            [d_meta, np.tile(np.array([[-1, 0, 0, 0, 0]], np.int32), (d - len(descs), 1))]
        ))

    mult = np.zeros((s_budget, lemma_budget), np.int32)
    for seg, row in enumerate(mult_rows):
        mult[seg, : len(row)] = row
    n_keys_p = np.zeros(s_budget, np.int32)
    n_keys_p[: len(items)] = n_keys
    seg_query_p = np.full(s_budget, -1, np.int32)
    seg_query_p[: len(items)] = seg_query

    return ArenaBatchPlan(
        families=families,
        buffers=buffers,
        src=src,
        nv=nv,
        blk_meta=blk_meta,
        d_src=d_src,
        d_n=d_n_d,
        d_dest=d_dest,
        d_meta=d_meta_d,
        e_budget=e_budget,
        n_keys=n_keys_p,
        mult=mult,
        seg_query=seg_query_p,
        n_queries=n_queries,
        query_budget=_bucket(n_queries),
        n_budget=n_budget,
        row_budget=row_budget,
        lemma_budget=lemma_budget,
        key_budget=key_budget,
        doc_bits=db,
        tier=tier,
        block=block,
        n_events=n_events,
    )


# ---------------------------------------------------------------------------
# §13.4 the arena device program (gather -> pack -> cover -> score -> top-k)
# ---------------------------------------------------------------------------


def _binary_search(a: torch.Tensor, v: torch.Tensor, right: bool) -> torch.Tensor:
    """``searchsorted`` of ``v`` (any shape) in sorted int32 ``a``: the
    count of elements ``< v`` (``<= v`` when ``right``), as int32 — the
    reference's §9.3 binary search, as one device search."""
    return torch.searchsorted(a, v.contiguous(), right=right, out_int32=True)


def _prev(col: torch.Tensor) -> torch.Tensor:
    """``col`` shifted one place later, with -1 in front."""
    return torch.cat([col.new_full((1,), -1), col[:-1]])


def _cumsum_i32(flags: torch.Tensor) -> torch.Tensor:
    """Exclusive-then-inclusive prefix count ``[0, c_0, c_0 + c_1, ...]``
    as int32 (``torch.cumsum`` of a bool would give int64)."""
    return torch.cat([flags.new_zeros(1, dtype=torch.int32), torch.cumsum(flags, 0, dtype=torch.int32)])


# The reference takes its float32 score prefix sums with ``jnp.cumsum``,
# which XLA on the CPU computes as a chunked scan: sequential sums within
# chunks of 16, the chunk totals scanned the same way, recursively.
# Repeating that order makes the scores bitwise equal to the reference's,
# ties included, on the CPU and on the card alike.
_SCAN_CHUNK = 16


def _cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sums of ``x`` in the reference's summation
    order (see ``_SCAN_CHUNK``)."""
    n = x.shape[0]
    m = -(-n // _SCAN_CHUNK)
    r = torch.nn.functional.pad(x, (0, m * _SCAN_CHUNK - n)).reshape(m, _SCAN_CHUNK)
    cols = [r[:, 0]]
    for k in range(1, _SCAN_CHUNK):  # explicit order: no library scan
        cols.append(cols[-1] + r[:, k])
    inner = torch.stack(cols, dim=1)
    if m > 1:
        carry = _cumsum_f32(inner[:, -1])
        inner = torch.cat([inner[:1], inner[1:] + carry[:-1, None]])
    return inner.reshape(-1)[:n]


def arena_serve_batch(
    buffers: tuple,  # per-group arena buffer, order = `families`
    gather_args: tuple,  # per-group descriptor tensors (form picked by
    #   use_kernel: block-aligned (src, nv, meta[G,5]) for the gather
    #   kernel; dense (src_row, n, dest, meta[D,5]) for the indexed form)
    n_keys: torch.Tensor,  # [S] int32
    mult: torch.Tensor,  # [S, L] int32
    seg_query: torch.Tensor,  # [S] int32
    *,
    families: tuple,
    e_budgets: tuple,  # per-group dense event budgets (indexed form)
    block: int,
    max_distance: int,
    query_budget: int,
    n_budget: int,
    row_budget: int,
    lemma_budget: int,
    s_budget: int,
    key_budget: int,
    doc_bits: int,
    tier: str,
    top_k: int = 16,
    use_kernel: bool = False,
) -> dict[str, torch.Tensor]:
    """One device program for an arena-resident query batch (DESIGN.md
    §13.4), on the inputs' device:

    stage 0  gather: every descriptor's arena extent into one (doc, pos)
             event workspace (the CUDA block-gather kernel with
             ``use_kernel=True``, its dense indexed form otherwise —
             identical fragments either way);
    stage 1  one packed sort groups events by (segment, doc): dense
             candidate-row ids + Step-1 document alignment;
    stage 2  cross-key event dedup to one (doc, pos, lemma) + the Step-2
             multiplicity gate;
    stage 3  event-centric rank cover: binary search over the (row, lemma,
             pos)-sorted stream;
    stage 4  §14 scoring + per-query top-k, as ``fused_serve_batch``.

    Every composite stays int32, as in the reference; integer outputs equal
    the reference's, and float32 scores agree within rounding.
    """
    i32 = torch.int32
    dev = n_keys.device
    nb = (n_budget - 1).bit_length()
    lb = max((lemma_budget - 1).bit_length(), 1)
    kb = max((key_budget - 1).bit_length(), 1)
    db = doc_bits
    window = 2 * max_distance + 1

    # ---- stage 0: gather the (doc, pos) event streams ---------------------
    rows_l, meta_l = [], []
    for fi in range(len(families)):
        if use_kernel:
            f_src, f_nv, meta_b = gather_args[fi]
            rows = gather_blocks(buffers[fi], f_src, f_nv, block=block)
            meta = meta_b.repeat_interleave(block, dim=0)  # [G*B, 5]
        else:
            # dense indexed gather: descriptor extents pack back to back, so
            # the event budget tracks REAL rows (no per-extent block padding)
            d_srcrow, d_n, d_dest, d_meta = gather_args[fi]
            iota = torch.arange(e_budgets[fi], dtype=i32, device=dev)
            desc = _binary_search(d_dest, iota, right=True) - 1
            desc = desc.clamp(0, d_dest.shape[0] - 1)
            within = iota - d_dest[desc]
            alive = within < d_n[desc]
            srcrow = (d_srcrow[desc] + within).clamp(0, buffers[fi].shape[0] - 1)
            rows = torch.where(alive[:, None], buffers[fi][srcrow], -1)
            meta = d_meta[desc]  # [E, 5]
        rows_l.append(rows)
        meta_l.append(meta)
    rows = torch.cat(rows_l)
    meta = torch.cat(meta_l)
    doc, pos = rows[:, 0], rows[:, 1]
    seg, lem, kd, emit_f, key = (meta[:, c] for c in range(5))
    e = doc.shape[0]
    valid0 = (doc >= 0) & (seg >= 0)

    # ---- stage 1: one packed sort -> (seg, doc) rows + Step-1 gate --------
    # Composite layout (high -> low): seg | doc | key | kd-inverted | emit
    # | pos | lemma.  kd streams (slot 0) sort to the head of each
    # (seg, doc, key) group, so group-first & kd counts every key exactly
    # once per candidate doc.  Invalid elements carry the int32 sentinel
    # and sort last.  ``tier`` picks one fused sort or a stable argsort +
    # payload gathers (wide per-shard doc-id spaces).
    pos_c = torch.where(emit_f > 0, pos, 0)
    head = ((((seg << db) | doc) << kb) | key) << 1 | (1 - kd)
    if tier == "pack32":
        pack = ((((head << 1) | emit_f) << nb) | pos_c) << lb | lem
        pack = torch.sort(torch.where(valid0, pack, _I32_MAX)).values
        fin1 = pack < _I32_MAX
        lem_s = pack & (lemma_budget - 1)
        pos_s = (pack >> lb) & (n_budget - 1)
        em_s = ((pack >> (lb + nb)) & 1) > 0
        head_s = pack >> (lb + nb + 1)
    else:  # "argsort": jnp.argsort is stable, so this sort must be too
        head_s, perm = torch.sort(torch.where(valid0, head, _I32_MAX), stable=True)
        fin1 = head_s < _I32_MAX
        pos_s = pos_c[perm]
        em_s = emit_f[perm] > 0
        lem_s = lem[perm]
    kd_s = (head_s & 1) == 0  # kd-inverted bit
    sd = head_s >> (kb + 1)  # (seg, doc) group id
    grp_key = head_s >> 1  # (seg, doc, key) group id
    new_row = fin1 & (sd != _prev(sd))
    row_id = torch.where(fin1, torch.cumsum(new_row, 0, dtype=i32) - 1, row_budget)
    row_idc = row_id.clamp(0, row_budget - 1)
    # row boundaries: row_id is sorted, so per-row ranges come from binary
    # search instead of scatters
    r_iota = torch.arange(row_budget, dtype=i32, device=dev)
    row_lo = _binary_search(row_id, r_iota, right=False)
    row_hi = _binary_search(row_id, r_iota, right=True)
    row_used = row_lo < row_hi
    sd_lo = sd[row_lo.clamp(max=e - 1)]
    row_seg = torch.where(row_used, sd_lo >> db, 0)
    row_doc = torch.where(row_used, sd_lo & ((1 << db) - 1), -1)
    row_seg_c = row_seg.clamp(0, s_budget - 1)
    # Step-1: distinct keys present per (seg, doc) == the work item's key
    # count (single-key items skip the gate, as the host pack does)
    kd_first = fin1 & kd_s & (grp_key != _prev(grp_key))
    cum_kd = _cumsum_i32(kd_first)
    key_count = cum_kd[row_hi] - cum_kd[row_lo]
    need = n_keys[row_seg_c]
    row_pass = row_used & ((need < 2) | (key_count >= need))

    # ---- stage 2: dedup to one (doc, pos, lemma) + Step-2 gate ------------
    keep = fin1 & em_s & (pos_s < n_budget) & row_pass[row_idc]
    comp = (((row_idc << nb) | pos_s) << lb) | lem_s
    comp = torch.sort(torch.where(keep, comp, _I32_MAX)).values
    fin = comp < _I32_MAX
    uniq = fin & (comp != _prev(comp))
    lem2 = comp & (lemma_budget - 1)
    pos2 = (comp >> lb) & (n_budget - 1)
    row2 = (comp >> (lb + nb)).clamp(0, row_budget - 1)

    # ---- stage 3: the (row, lemma, pos)-sorted stream IS the §9.1 postab --
    cov = (((row2 << lb) | lem2) << nb) | pos2
    cov = torch.sort(torch.where(uniq, cov, _I32_MAX)).values
    # per-(row, lemma) group bounds once; `cov` holds deduped events only,
    # so range sizes are exactly the distinct-position counts
    l_iota = torch.arange(lemma_budget, dtype=i32, device=dev)
    grp_rl = ((r_iota[:, None] << lb) | l_iota[None, :]) << nb  # [R, L]
    lo_rl = _binary_search(cov, grp_rl, right=False)
    cnt_rl = _binary_search(cov, grp_rl | (n_budget - 1), right=True) - lo_rl
    mult_rows = mult[row_seg_c]  # [R, L] (0 = unused slot, trivially passes)
    ok_row = row_used & (cnt_rl >= mult_rows).all(dim=1)
    live = uniq & ok_row[row2]

    # event-centric rank cover (§9.3 identity): for event (row, pos) and
    # lemma l, cnt = occurrences of l at or before pos; the fragment start
    # is the mult-th latest, gathered straight from the sorted stream
    grp_e = ((row2[:, None] << lb) | l_iota[None, :]) << nb  # [E, L]
    hi_e = _binary_search(cov, grp_e | pos2[:, None], right=True)
    lo_e = lo_rl[row2]  # [E, L]
    cnt = hi_e - lo_e
    mult_e = mult_rows[row2]  # [E, L]
    active = mult_e > 0
    have = cnt >= mult_e
    sel = (lo_e + cnt - mult_e).clamp(0, e - 1)
    p_sel = torch.where(active & have, cov[sel] & (n_budget - 1), n_budget)
    start = p_sel.min(dim=-1).values
    covered = (have | ~active).all(dim=-1) & active.any(dim=-1)
    emit = live & covered & (start < n_budget) & (pos2 - start < window)
    start = torch.where(emit, start, pos2)

    # ---- stage 4: §14 scoring + per-query top-k (as fused_serve_batch) ----
    pp = comp >> lb
    primary = fin & (pp != _prev(pp))
    emit_primary = emit & primary
    span = (pos2 - start).to(torch.float32)
    contrib = torch.where(emit_primary, 1.0 / (span + 1.0) ** 2, 0.0)
    # per-row reductions via prefix sums over the row-sorted stream (`comp`
    # groups rows contiguously) — no [E]->[R] scatters on the hot path
    crow = torch.where(fin, comp >> (lb + nb), row_budget)
    c_lo = _binary_search(crow, r_iota, right=False)
    c_hi = _binary_search(crow, r_iota, right=True)
    cum_scores = torch.cat([contrib.new_zeros(1), _cumsum_f32(contrib)])
    scores = cum_scores[c_hi] - cum_scores[c_lo]
    scores = torch.where(ok_row & (row_doc >= 0), scores, -torch.inf)
    row_query = torch.where(row_used, seg_query[row_seg_c], -1)
    qids = torch.arange(query_budget, dtype=i32, device=dev)[:, None]
    scores_q = torch.where(row_query[None, :] == qids, scores[None, :], -torch.inf)
    kk = min(top_k, row_budget)
    # a stable descending sort keeps equal scores in row order, the tie
    # order of jax.lax.top_k
    idx = torch.sort(scores_q, dim=1, descending=True, stable=True).indices[:, :kk]
    top_scores = torch.gather(scores_q, 1, idx)
    top_docs = torch.where(torch.isfinite(top_scores), row_doc[idx], -1)

    cum_frag = _cumsum_i32(emit_primary)
    frag_per_row = cum_frag[c_hi] - cum_frag[c_lo]
    n_fragments = torch.zeros(query_budget, dtype=i32, device=dev).index_add_(
        0,
        row_query.clamp(0, query_budget - 1),
        torch.where(row_query >= 0, frag_per_row, 0),
    )

    # §15.1 device-side result assembly over the deduped event stream
    ev_q = row_query[row2]
    ev_d = row_doc[row2]
    frag_valid = emit_primary & (ev_q >= 0) & (ev_d >= 0)
    res = _assemble_fragments(ev_q, ev_d, start, pos2, frag_valid, query_budget)

    return {
        "emit": emit_primary,
        "start": start,
        "comp": comp,
        "row_doc": row_doc,
        "row_query": row_query,
        "res": res,
        "top_docs": top_docs,
        "top_scores": top_scores,
        "n_fragments": n_fragments,
    }


def _device_args(plan: ArenaBatchPlan, use_kernel: bool, device: torch.device):
    """Assemble ONE arena program's device arguments from a plan.

    Returns ``(args, h2d_bytes)`` where ``args`` matches the positional
    signature of :func:`arena_serve_batch` and ``h2d_bytes`` counts the
    descriptor bytes enqueued host-to-device (the resident posting buffers
    never move — that is the point of the arena, §13.1).  On a CUDA device
    the descriptors are staged in pinned memory and copied asynchronously.
    """
    if device.type == "cuda":
        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).pin_memory().to(device, non_blocking=True)
    else:
        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(device)

    groups = range(len(plan.families))
    if use_kernel:
        host = [(plan.src[g], plan.nv[g], plan.blk_meta[g]) for g in groups]
    else:
        host = [(plan.d_src[g], plan.d_n[g], plan.d_dest[g], plan.d_meta[g]) for g in groups]
    gather_args = tuple(tuple(put(a) for a in arrays) for arrays in host)
    small = (plan.n_keys, plan.mult, plan.seg_query)
    args = (
        tuple(plan.buffers[g] for g in groups),
        gather_args,
        *(put(a) for a in small),
    )
    h2d = sum(a.nbytes for arrays in host for a in arrays) + sum(a.nbytes for a in small)
    return args, h2d


def _static_kwargs(plan: ArenaBatchPlan, *, max_distance: int, top_k: int, use_kernel: bool) -> dict:
    """The shape/config keyword arguments of :func:`arena_serve_batch` for
    a plan."""
    return dict(
        families=plan.families,
        e_budgets=tuple(plan.e_budget),
        block=plan.block,
        max_distance=max_distance,
        query_budget=plan.query_budget,
        n_budget=plan.n_budget,
        row_budget=plan.row_budget,
        lemma_budget=plan.lemma_budget,
        s_budget=len(plan.n_keys),
        key_budget=plan.key_budget,
        doc_bits=plan.doc_bits,
        tier=plan.tier,
        top_k=top_k,
        use_kernel=use_kernel,
    )


def lower_arena_batch(
    plan: ArenaBatchPlan,
    *,
    max_distance: int,
    top_k: int = 16,
    use_kernel: bool = False,
) -> ProgramCost:
    """The cost (``launch.cost_analysis.ProgramCost``: flops, HBM bytes) of
    the exact arena program :func:`run_arena_batch` would run for the plan,
    on the device of its resident buffers.  The reference lowers the
    program without running it; the port cannot, so it runs it once under
    ``count_cost`` (the descriptors' copies and the readout are not
    counted)."""
    args, _ = _device_args(plan, use_kernel, plan.buffers[0].device)
    _, cost = count_cost(
        arena_serve_batch, *args,
        **_static_kwargs(plan, max_distance=max_distance, top_k=top_k, use_kernel=use_kernel),
    )
    return cost


def run_arena_batch(
    plan: ArenaBatchPlan,
    *,
    max_distance: int,
    top_k: int = 16,
    use_kernel: bool = False,
    stats: QueryStats | None = None,
    phases: dict | None = None,
    readout: str = "device",
    defer: bool = False,
):
    """Dispatch ONE arena device program, on the device of the plan's
    resident buffers, and read results out (DESIGN.md §13.4).  The readout
    mirrors ``run_query_batch``: ``readout="device"`` splits the §15.1
    device-assembled result buffer (one fixed-shape copy); ``readout="host"``
    keeps the ``np.nonzero`` + two-tier dedup over the event stream as the
    differential reference.  ``defer=True`` returns a
    :class:`~repro_torch.search.fused.PendingBatch` right after the program
    is enqueued (§15.2)."""
    from .fused import (
        FusedBatchResult,
        PendingBatch,
        _dedup_fragments,
        _split_result_buffer,
    )

    if readout not in ("device", "host"):
        raise ValueError(f"unknown readout mode: {readout!r}")
    device = plan.buffers[0].device
    t0 = time.perf_counter()
    args, h2d = _device_args(plan, use_kernel, device)
    if stats is not None:
        stats.h2d_bytes += h2d
    if phases is not None:
        phases.setdefault("h2d_us", []).append((time.perf_counter() - t0) * 1e6)
        t0 = time.perf_counter()
    out = arena_serve_batch(
        *args, **_static_kwargs(plan, max_distance=max_distance, top_k=top_k, use_kernel=use_kernel)
    )
    if stats is not None:
        stats.device_dispatches += 1
    if phases is not None:
        phases.setdefault("dispatch_us", []).append((time.perf_counter() - t0) * 1e6)

    nq = plan.n_queries

    def finalize():
        t1 = time.perf_counter()
        if phases is not None:
            # bench-only barrier: device time goes to compute_us, not to
            # whichever phase bracket encloses the first fetch
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            phases.setdefault("compute_us", []).append((now - t1) * 1e6)
            t1 = now
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
            nb = (plan.n_budget - 1).bit_length()
            lb = max((plan.lemma_budget - 1).bit_length(), 1)
            (hits,) = np.nonzero(out["emit"].cpu().numpy())
            comp = out["comp"].cpu().numpy()[hits].astype(np.int64)
            starts = out["start"].cpu().numpy()[hits].astype(np.int64)
            ends = (comp >> lb) & (plan.n_budget - 1)
            rows = comp >> (lb + nb)
            docs = out["row_doc"].cpu().numpy().astype(np.int64)[rows]
            q_of = out["row_query"].cpu().numpy().astype(np.int64)[rows]
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
        if phases is not None:
            phases.setdefault("readout_us", []).append((time.perf_counter() - t1) * 1e6)
        return result

    if defer:
        return PendingBatch(finalize, torch.cuda.current_stream(device) if device.type == "cuda" else None)
    return finalize()
