#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its seconds:

1. the device: name, count, and ``nvidia-smi``'s name and power limit;
2. the kernel build: every ``src/repro_torch/kernels/csrc/*.cu``, one
   ``nvcc`` per source, all started together, with each ``ptxas`` report;
3. the index: a synthetic Zipf corpus of 8,192 documents x 250 positions,
   indexed by the port (the host-side build is what bounds the corpus size);
4. the host route: a slate of queries served twice through
   ``ServingFrontend(device="cuda", use_kernel=True)``.  The proximity and
   intersect launch counters are set to 0 just before the first round and
   read just after it; the run fails unless both rose, and unless the
   intersect launches equal the rounds of the slate's Step-1 folds (derived
   here from the key lists, independently of the port).  The second round
   must be all cache hits.  The fused batch's readout phase is then timed
   with and without the slate's device intersects, in turns;
4b. the arena route: one ``PostingArena`` with the reference launcher's
   default budget (64 MiB) on the card — its cold acquire's seconds, bytes,
   and resident and refused families — then the same slate through
   ``ServingFrontend(arena=..., use_kernel=True)``.  The gather launch
   counter is set to 0 just before and read just after; the run fails unless
   it rose, the slate hit the arena and no upload happened during the
   slates;
5. the kernels against their plain PyTorch versions on the card, at the
   shapes of the main paths' own inputs, with kernel, plain-version, bound
   and library-call times.  The cover kernel: the main path's occupancy
   (required to be 0/1, so the time is its bit path's), arbitrary values
   that wrap in the compute dtype at the same shape (its general path, timed
   on its own line), one launch whose rows alternate between the two, and a
   sweep of ragged N, windows 1 to 63, 1 to 8 lemmas and awkward
   multiplicities — emit and start equal everywhere.  The gather: every
   ``n_valid`` kind and out-of-range sources.  The intersect: one pair at
   the planner's, full and partial ``n_chunks``; one segmented launch per
   fold round of the slate (6 and 3 pairs); a segment list with mixed
   ``n_chunks``, a single-tile ``b``, windows clamped at the last tile and
   a window above the kernel's shared-memory budget; unsorted windows
   (which a search alone would get wrong); duplicates and PAD runs — with
   single-pair, segmented, launch-floor, plain and ``torch.isin`` times,
   and the slate's Step-1 host wall one launch per pair against one per
   round;
6. the slate again through fresh frontends — the event-rank cover and the
   arena route with and without the gather kernel on the card, and the host
   route and the arena route on the CPU — which must all agree with the CPU
   host route: equal fragments and documents, scores within rtol 1e-5;
7. the reference launcher's default deployment: the first 4,096 documents
   of phase 3's store under a 4-shard ``ShardedSearchService`` (one
   corpus-global FL-list, every key built), its build seconds, each shard's
   size and longest Step-1 lists, and one index over the same documents
   served by the host route on the CPU.
   The slate through ``ServingFrontend(svc, use_kernel=True)`` (host route)
   and over a 64 MiB arena — and, where that budget refuses the slate's
   triples, over the smallest power-of-two budget that keeps them — each
   with its launch counters set to 0 before and read after, 5 fresh-frontend
   latencies and a profile; then ``svc.search_batch`` with ``fused`` and
   with ``se2.4``, the host Combiner over the same shards.  Every route must
   equal ``se2.4`` over the shards and the single-index CPU route.
   The baselines SE1 and SE2.1-SE2.3 are timed on "to be or not to be" and
   each held to its own oracle, and ``device_topk_merge`` runs on the card
   over per-shard top-10 lists with a forced tie, against a stable host sort.

It exits non-zero on the first failure (no phase catches its own), and when
no CUDA device is present.  The line before the last is a JSON object with
one entry per kernel; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SLATE = [
    # the launcher's default queries
    "who are you who",
    "to be or not to be",
    "what do you do all day",
    # multi-word stop-word queries
    "who is who in the world of war",
    "time and time again",
    "one at a time",
    "the who are an english rock band",
    "i need you",
]
N_DOCS, DOC_LEN, VOCAB, SEED = 8192, 250, 5000, 0
SW_COUNT, FU_COUNT, MAX_DISTANCE = 80, 250, 5
TOP_K = 10
ARENA_BUDGET = 64 << 20  # the reference launcher's default --arena-budget-mb
N_SHARDS = 4  # the reference launcher's default --n-shards
# phase 7's corpus: every shard builds every key, so 8,192 documents would
# take the run past its time budget (526 s of command time on an H100)
SHARDED_DOCS = 4096
SCORE_RTOL = 1e-5  # float32 scores summed in another order on each path

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the float32 rate outside
# the tensor cores (an FMA counted as two operations).  The data sheet lists
# no rate for 32-bit integer compares and adds, which run slower than this,
# so timing them at this rate keeps the bound a lower bound.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def phase(name: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"[phase] {name}: {now - t0:.3f} s", flush=True)
    return now


# a spin of ~0.1 s at the H100's SM clock (about 2 GHz): long enough for the
# host to enqueue every timed call behind it
SPIN_CYCLES = 200_000_000


def cuda_ms(torch, fn, iters: int) -> tuple[float, float, bool]:
    """Mean device time of ``fn`` per call over ``iters`` calls after one
    warm-up, from CUDA events.  A spin kernel holds the stream first, so the
    host enqueues the calls before the first one runs and the events time
    them back to back; without it a call whose host side is slower than its
    kernel would be timed at the host's pace.  Returns ``(ms, host us per
    call, back to back)``; the last is False when the calls outlasted the
    spin (or synchronized), and the time then includes host gaps."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t_host = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t_host) * 1e6 / iters
    back_to_back = not start.query()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_us, back_to_back


def timing(label: str, t: tuple[float, float, bool]) -> str:
    ms, host_us, b2b = t
    return f"{label} {ms:.4f} ms ({'back to back' if b2b else 'host-paced'}; host {host_us:.1f} us/call)"


def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))

    from repro_torch.core.keys import expand_subqueries, select_keys
    from repro_torch.core.lemma import FLList
    from repro_torch.index import DocumentStore, build_indexes, synthesize_corpus
    from repro_torch.kernels import _build
    from repro_torch.kernels.gather import ARENA_BLOCK, gather_blocks, gather_blocks_plain
    from repro_torch.kernels.intersect import (
        PAD,
        block_offsets,
        intersect_sorted,
        intersect_sorted_plain,
        intersect_sorted_segments,
        pack_segments,
    )
    from repro_torch.kernels.proximity import proximity_window, proximity_window_plain
    from repro_torch.core.baselines import simple_key_cover
    from repro_torch.core.oracle import key_events, ordinary_events, sweep_events
    from repro_torch.search import (
        SearchRequest,
        ServingFrontend,
        ShardedSearchService,
        device_topk_merge,
        fused,
        rank_documents,
    )
    from repro_torch.search.arena import PostingArena, plan_arena_batch
    from repro_torch.search.planner import generation_token

    dev = torch.device("cuda", 0)
    counted = {"proximity_window": proximity_window, "intersect_sorted": intersect_sorted,
               "gather_blocks": gather_blocks}
    path_launches: dict[str, dict[str, int]] = {}  # path -> kernel -> launches

    def zero_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts(path):
        path_launches[path] = {kname: fn.launches for kname, fn in counted.items()}
        return path_launches[path]

    def slate_profile(make_fe, label, first_ms, cached_ms):
        """Slate latency of 5 fresh frontends (cold result cache) on a warm
        device, the six phases of one, and one profiled slate's wall, device
        busy share and top device operations."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        slate_ms, phases = [], {}
        for rep in range(5):
            fe = make_fe()
            prev = fused.collect_phases(phases if rep == 4 else None)
            t_serve = time.perf_counter()
            fe.search_many(requests)
            torch.cuda.synchronize()
            slate_ms.append((time.perf_counter() - t_serve) * 1e3)
            fused.collect_phases(prev)
        print(f"{label} slate latency on {name}: first {first_ms:.1f} ms, cached {cached_ms:.3f} ms, "
              f"fresh frontend {[round(x, 1) for x in slate_ms]} ms (median {sorted(slate_ms)[2]:.1f})")
        print(f"{label} phases of one instrumented slate (us): "
              + json.dumps({k: [round(x, 1) for x in v] for k, v in phases.items()}))
        # device busy share of one fresh slate, from the profiler's kernel
        # and copy events (one stream: they do not overlap)
        fe = make_fe()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_serve = time.perf_counter()
            fe.search_many(requests)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t_serve) * 1e3
        dev_events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
        print(f"{label} profiled slate: wall {wall_ms:.1f} ms, device busy {busy_ms:.3f} ms "
              f"({100 * busy_ms / wall_ms:.2f}%), idle {100 - 100 * busy_ms / wall_ms:.2f}%")
        for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} {e.key[:90]}")

    t0 = time.perf_counter()

    # ---- 1. device ---------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} x{torch.cuda.device_count()}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    t0 = phase("device", t0)

    # ---- 2. kernel build ---------------------------------------------------
    reports = _build.build_all()
    for src_name, out in reports.items():
        ptxas = [ln for ln in out.splitlines() if "registers" in ln or "spill" in ln]
        print(f"built {src_name}.cu: " + " | ".join(ln.strip() for ln in ptxas))
    t0 = phase("kernel build (nvcc, parallel)", t0)

    # ---- 3. index ------------------------------------------------------------
    store = synthesize_corpus(n_docs=N_DOCS, doc_len=DOC_LEN, vocab_size=VOCAB, seed=SEED)
    fl = FLList.from_frequencies(store.lemma_frequencies(), sw_count=SW_COUNT, fu_count=FU_COUNT)
    lem = store.lemmatizer
    subs = {q: expand_subqueries(q, lem) for q in SLATE}
    # only the slate's (f,s,t) keys are built: every family the slate reads
    # is complete, and the build stays inside the run's time limit
    triples = {
        k.components for q in SLATE for sub in subs[q] for k in select_keys(sub, fl) if k.arity == 3
    }
    index = build_indexes(
        store, SW_COUNT, FU_COUNT, max_distance=MAX_DISTANCE, triple_key_filter=triples, fl=fl
    )
    print(f"index: {len(store)} docs, {store.total_positions()} positions, "
          f"{index.size_bytes()['total'] / 2**20:.1f} MiB of postings, {len(triples)} triple keys")
    t0 = phase("corpus + index build (host)", t0)

    # ---- 4. main path, host route ------------------------------------------
    def step1_folds(views):
        """The slate's Step-1 folds as the planner forms them over ``views``
        (each multi-key (subquery, view) item's key doc lists, shortest
        first; step r on the card when both sides hold at least the
        threshold's docs): the items' lists and the device pairs by round."""
        items = []
        for q in SLATE:
            for view in views:
                for sub in subs[q]:
                    keys = select_keys(sub, view.fl)
                    if len(keys) >= 2:
                        items.append([np.unique(view.key_postings(key.components)[:, 0]) for key in keys])
        by_round: dict[int, list] = {}
        for lists in items:
            lists = sorted(lists, key=len)
            acc = lists[0]
            for r, other in enumerate(lists[1:]):
                if not len(acc):
                    break
                if min(len(acc), len(other)) >= fused.INTERSECT_DEVICE_THRESHOLD:
                    by_round.setdefault(r, []).append((acc, other))
                acc = np.intersect1d(acc, other)
        return items, [by_round[r] for r in sorted(by_round)]

    fold_items, rounds = step1_folds([index])
    n_pairs = sum(len(pairs) for pairs in rounds)
    print(f"slate Step-1 folds: {len(fold_items)} multi-key subqueries, {n_pairs} device pairs in "
          f"{len(rounds)} rounds {[len(pairs) for pairs in rounds]}")

    requests = [SearchRequest(q, top_k=TOP_K) for q in SLATE]
    frontend = ServingFrontend(index, lemmatizer=lem, device="cuda", use_kernel=True, max_batch=16)
    zero_counts()
    fused.reset_dispatch_count()
    t_serve = time.perf_counter()
    main_resps = frontend.search_many(requests)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t_serve) * 1e3
    launches = dict(read_counts("host route"))
    del launches["gather_blocks"]
    dispatches = fused.dispatch_count()
    print(f"host route: {len(SLATE)} queries, {dispatches} device programs, kernel launches {launches} "
          f"(intersect: one per fold round, {len(rounds)} expected; one per pair would be {n_pairs})")
    for kname, count in launches.items():
        require(count > 0, f"{kname} was not launched on the host route")
    require(launches["intersect_sorted"] == len(rounds),
            f"the host route made {launches['intersect_sorted']} intersect launches for {len(rounds)} fold rounds")
    t_serve = time.perf_counter()
    cached = frontend.search_many(requests)
    cached_ms = (time.perf_counter() - t_serve) * 1e3
    require(all(r.stats.cache_hits == 1 for r in cached), "second round not all cache hits")
    for r in main_resps:
        require(all(np.isfinite(d.score) and d.score > 0 for d in r.docs), f"bad scores for {r.query!r}")
        print(f"  {r.query!r}: {r.stats.results} fragments, top doc "
              f"{r.docs[0].doc_id if r.docs else None}, {r.n_subqueries} subqueries")
    slate_profile(lambda: ServingFrontend(index, lemmatizer=lem, device="cuda", use_kernel=True,
                                          max_batch=16), "host route", first_ms, cached_ms)
    # the fused batch's readout phase with the slate's Step-1 rounds on the
    # card and with a threshold no list reaches (no device intersect), in
    # turns: the rounds run on a stream of their own and must not slow it
    work = [[(sub, index) for sub in subs[q]] for q in SLATE]
    readout_us: dict[int, list] = {}
    for rep in range(8):
        threshold = (fused.INTERSECT_DEVICE_THRESHOLD, 1 << 30)[rep % 2]
        sink = {}
        prev = fused.collect_phases(sink)
        fused.serve_query_batch(work, max_distance=MAX_DISTANCE, top_k=TOP_K, use_kernel=True,
                                intersect_device_threshold=threshold, device="cuda")
        fused.collect_phases(prev)
        readout_us.setdefault(threshold, []).append(round(sink["readout_us"][0], 1))
    print(f"host route readout_us, 4 batches each in turns: device intersects "
          f"{readout_us[fused.INTERSECT_DEVICE_THRESHOLD]}, none {readout_us[1 << 30]}")
    t0 = phase("serving (host route)", t0)

    # ---- 4b. main path, arena route ------------------------------------------
    arena = PostingArena(budget_bytes=ARENA_BUDGET, device="cuda")
    t_acq = time.perf_counter()
    residency = arena.acquire(index, 0)
    torch.cuda.synchronize()
    acquire_s = time.perf_counter() - t_acq
    m = arena.metrics()
    resident = {f: fb.nbytes for f, fb in residency.families.items()}
    refused = {key[3]: nbytes for key, nbytes in arena.refused.items()}
    print(f"cold acquire (budget {ARENA_BUDGET >> 20} MiB): {acquire_s:.3f} s, "
          f"{m['arena_uploads']} uploads, {m['arena_upload_bytes'] / 2**20:.1f} MiB copied to the card")
    print(f"  resident: {json.dumps({f: f'{b / 2**20:.1f} MiB' for f, b in resident.items()})}")
    print(f"  refused (larger than the budget): {json.dumps({f: f'{b / 2**20:.1f} MiB' for f, b in refused.items()})}")
    print(f"  arena metrics: {json.dumps(m)}")
    require(resident, "no family is resident under the budget")

    def arena_frontend(**kw):
        return ServingFrontend(index, lemmatizer=lem, arena=arena, device="cuda", max_batch=16,
                               **{"use_kernel": True, **kw})

    frontend = arena_frontend()
    uploads = arena.metrics()["arena_uploads"]
    zero_counts()
    fused.reset_dispatch_count()
    t_serve = time.perf_counter()
    arena_resps = frontend.search_many(requests)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t_serve) * 1e3
    launches["gather_blocks"] = read_counts("arena route")["gather_blocks"]
    dispatches = fused.dispatch_count()
    hits = sum(r.stats.arena_hits for r in arena_resps)
    misses = sum(r.stats.arena_misses for r in arena_resps)
    print(f"arena route: {len(SLATE)} queries, {dispatches} device programs, gather launches "
          f"{launches['gather_blocks']}, arena hits {hits} keys, misses {misses} keys")
    require(launches["gather_blocks"] > 0, "gather_blocks was not launched on the arena route")
    require(hits > 0, "the slate did not hit the arena")
    require(dispatches > 0, "the arena route issued no device program")
    t_serve = time.perf_counter()
    cached = frontend.search_many(requests)
    cached_ms = (time.perf_counter() - t_serve) * 1e3
    require(all(r.stats.cache_hits == 1 for r in cached), "second arena round not all cache hits")
    for r, h in zip(arena_resps, main_resps):
        require([d.doc_id for d in r.docs] == [d.doc_id for d in h.docs],
                f"arena route top {TOP_K} differs from the host route for {r.query!r}")
    slate_profile(arena_frontend, "arena route", first_ms, cached_ms)
    require(arena.metrics()["arena_uploads"] == uploads, "a slate uploaded to the arena: the cold entries were missed")
    print(f"  arena metrics after the slates: {json.dumps(arena.metrics())}")
    t0 = phase("serving (arena route)", t0)

    # ---- 5. kernels against their plain versions, main-path shapes -----------
    plan = fused.plan_query_batch(work, device="cpu")
    r, l, k = plan.postab.shape
    n = plan.doc_len
    print(f"main-path plan: E={plan.events.shape[0]} (live {int((plan.events[:, 0] >= 0).sum())}) "
          f"R={r} (live {int((plan.row_doc >= 0).sum())}) L={l} K={k} N={n} Q={plan.query_budget}")
    # the host's share after the readout: materializing and ranking every
    # fragment of the slate (what execute_plans does per response)
    res = fused.serve_query_batch(work, max_distance=MAX_DISTANCE, top_k=TOP_K,
                                  use_kernel=True, device="cuda")
    t_rank = time.perf_counter()
    for frs in res.per_query:
        rank_documents(frs, top_k=TOP_K)
    rank_ms = (time.perf_counter() - t_rank) * 1e3
    print(f"host response ranking of the slate: {rank_ms:.1f} ms over "
          f"{sum(len(frs) for frs in res.per_query)} fragments")
    t_plan = time.perf_counter()
    for q in SLATE:
        frontend.planner.plan(q)
    print(f"host query planning of the slate (QueryPlanner.plan): "
          f"{(time.perf_counter() - t_plan) * 1e3:.1f} ms")
    events = torch.from_numpy(plan.events).to(dev)
    mult = torch.from_numpy(plan.mult).to(dev)
    kernels = []

    def cover_check(occ, mult_, dtype, label, max_distance=MAX_DISTANCE, quiet=False):
        """The cover kernel against its plain version: emit and start must
        be equal bit for bit at every position; returns the largest absolute
        difference of either."""
        ek, sk = proximity_window(occ, mult_, max_distance, compute_dtype=dtype)
        ep, sp = proximity_window_plain(occ, mult_, max_distance, compute_dtype=dtype)
        torch.cuda.synchronize()
        differ = (ek != ep) | (sk != sp)
        err = int((sk - sp).abs().max()) if sk.numel() else 0
        err = max(err, int(differ.any()))
        if not quiet:
            print(f"proximity {label} {dtype} {tuple(occ.shape)}: {int(ep.sum())} emits, "
                  f"{int(differ.sum())} positions differ, max_abs_err {err}")
        require(err == 0, f"proximity kernel != plain ({label}, {dtype}, max_distance {max_distance})")
        return err

    def cover_inputs(b, l_, n_, window, dtype, wild_rows):
        """0/1 rows (sparse, dense, events only at e < window) and, on
        ``wild_rows``, arbitrary values that wrap in the compute type;
        multiplicities with 0, negative values, values above the window and
        256."""
        occ_np = (rng.random((b, l_, n_)) < np.array([0.1, 0.5, 0.3])[np.arange(b) % 3, None, None])
        occ_np = occ_np.astype(np.int64)
        occ_np[2::3, :, window:] = 0
        if dtype == "uint8":
            wild = rng.integers(0, 256, (b, l_, n_))
        else:
            wild = rng.choice([-(2**31), -3, -1, 0, 1, 2, 3, 2**31 - 1], (b, l_, n_))
        occ_np[wild_rows] = wild[wild_rows]
        mult_np = rng.choice([0, 1, 1, 1, 2, 2, 3, -1, -5, window, window + 1, 64, 65, 255, 256], (b, l_))
        return (torch.from_numpy(occ_np.astype(np.int32)).to(dev),
                torch.from_numpy(mult_np.astype(np.int32)).to(dev))

    rng = np.random.default_rng(SEED)
    n_active = int((plan.mult > 0).sum())
    print(f"cover: {n_active} active (row, lemma) pairs of {r * l}")
    # the earlier form of the kernel (one thread per position summing its
    # window) on an H100 80GB HBM3 at 700 W, for comparison
    cover_err, earlier_ms = 0, {"uint8": 1.5996, "int32": 1.5949}
    for dtype in ("uint8", "int32"):
        occ = fused.scatter_occupancy(events, r, l, n, dtype)
        # the main path's occupancy is 0/1: every tile takes the bit path
        require(int(occ.max()) <= 1, "the main path's occupancy is not 0/1")
        cover_err = max(cover_err, cover_check(occ, mult, dtype, "main-path"))
        # arbitrary occupancy values at the main path's shape: every tile
        # takes the general path, and both sides wrap in the compute dtype
        gen = torch.Generator(device=dev).manual_seed(SEED)
        if dtype == "uint8":
            occ_w = torch.randint(0, 256, (r, l, n), generator=gen, device=dev, dtype=torch.uint8)
        else:
            occ_w = torch.randint(-(2**31), 2**31 - 1, (r, l, n), generator=gen, device=dev,
                                  dtype=torch.int32)
        mult_w = torch.randint(0, 4, (r, l), generator=gen, device=dev, dtype=torch.int32)
        cover_err = max(cover_err, cover_check(occ_w, mult_w, dtype, "wraparound"))
        # one launch whose rows alternate between 0/1 and wrapping values
        occ_m, mult_m = cover_inputs(512, l, n, 2 * MAX_DISTANCE + 1, dtype, slice(1, None, 2))
        cover_err = max(cover_err, cover_check(occ_m, mult_m, dtype, "mixed rows"))
        # the sweep: ragged N, windows 1 to 63, 1 to 8 lemmas, awkward mult
        t_sweep, n_sweep = time.perf_counter(), 0
        for n_ in (128, 200, 520, 4096):
            for md in (0, 1, 5, 31):
                for l_ in (1, 3, 8):
                    occ_s, mult_s = cover_inputs(48, l_, n_, 2 * md + 1, dtype, slice(3, None, 4))
                    cover_err = max(cover_err, cover_check(occ_s, mult_s, dtype, "sweep", md, quiet=True))
                    n_sweep += 1
        print(f"proximity sweep {dtype}: {n_sweep} launches (N 128/200/520/4096, max_distance "
              f"0/1/5/31, L 1/3/8), emit and start equal everywhere, "
              f"{time.perf_counter() - t_sweep:.2f} s")
        t_k = cuda_ms(torch, lambda: proximity_window(occ, mult, MAX_DISTANCE, compute_dtype=dtype), 50)
        t_g = cuda_ms(torch, lambda: proximity_window(occ_w, mult_w, MAX_DISTANCE, compute_dtype=dtype), 20)
        t_p = cuda_ms(torch, lambda: proximity_window_plain(occ, mult, MAX_DISTANCE, compute_dtype=dtype), 2)
        ms, plain_ms = t_k[0], t_p[0]
        item = occ.element_size()
        # the active occupancy rows read once (an inactive row never changes
        # the output), mult read, emit and start written
        n_bytes = n_active * n * item + r * l * item + r * n * (1 + 4)
        whole_ms = (r * l * n * item + r * l * item + r * n * (1 + 4)) / HBM_BYTES_PER_S * 1e3
        # one test per active (row, lemma) and position
        n_ops = n_active * n
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        print(f"proximity {dtype}: {timing('kernel (bit path)', t_k)} [earlier per-position form: {earlier_ms[dtype]} ms], "
              f"{timing('plain', t_p)}, bound {b_ms:.4f} ms ({b_by}; whole-input bytes {whole_ms:.4f} ms)")
        print(f"proximity {dtype} general path: {timing('kernel on the wraparound input', t_g)}")
        if dtype == "uint8":  # the frontend's compute dtype: the main path's entry
            cover_entry = {
                "name": "proximity_window", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/proximity.cu",
                "replaces": "src/repro/kernels/proximity.py:105",
                "launches": launches["proximity_window"],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,
            }
        del occ, occ_w
    kernels.append({**cover_entry, "max_abs_err": cover_err})

    # the two longest doc lists of one multi-key subquery of the slate
    pairs = []
    for lists in fold_items:
        docs = sorted(lists, key=len)
        pairs.append((min(len(docs[-1]), len(docs[-2])), docs[-2], docs[-1]))
    _, a_docs, b_docs = max(pairs, key=lambda t: t[0])
    a_np, b_np, off_np, n_chunks = fused.intersect_inputs(a_docs, b_docs)
    a, b, off = (torch.from_numpy(x).to(dev) for x in (a_np, b_np, off_np))
    print(f"intersect inputs: |a|={len(a_docs)} |b|={len(b_docs)} NA={len(a_np)} NB={len(b_np)} n_chunks={n_chunks}")
    full_chunks = len(b_np) // 256
    member = torch.isin(a, b) & (a != int(PAD))
    intersect_err = 0
    for chunks, label in ((n_chunks, "main-path"), (full_chunks, "full"), (1, "partial")):
        got = intersect_sorted(a, b, off, n_chunks=chunks)
        want = intersect_sorted_plain(a, b, off, n_chunks=chunks)
        err = int((got - want).abs().max())
        print(f"intersect {label} n_chunks={chunks}: {int(got.sum())} hits, "
              f"{int(member.sum())} members, {int((got != want).sum())} elements differ")
        require(err == 0, f"intersect kernel != plain ({label})")
        intersect_err = max(intersect_err, err)
        require(bool((got <= member.int()).all()), f"intersect false positive ({label})")
        if chunks >= n_chunks:
            require(torch.equal(got.bool(), member), f"intersect under-reports ({label})")

    def segments_check(segments, label):
        """One segmented launch against the plain version of each segment
        alone, every element; returns the packed buffer on the card, its
        layout and the per-segment masks."""
        nonlocal intersect_err
        buf, pack = pack_segments(segments)
        buf = buf.to(dev)
        masks = pack.split(intersect_sorted_segments(buf, pack))
        differ = hits = 0
        for s_, mask in enumerate(masks):
            a_s, b_s, off_s = pack.segment(buf, s_)
            want = intersect_sorted_plain(a_s, b_s, off_s, n_chunks=pack.n_chunks[s_])
            differ += int((mask != want).sum())
            hits += int(want.sum())
            intersect_err = max(intersect_err, int((mask - want).abs().max()))
        print(f"intersect segmented {label}: {len(masks)} segments in one launch, n_chunks "
              f"{list(pack.n_chunks)}, NB {list(pack.nb)}, {hits} hits, {differ} elements differ")
        require(differ == 0, f"segmented intersect kernel != plain ({label})")
        return buf, pack, masks

    def search_only(a_s, b_s, off_s, chunks):
        """What a kernel that only binary-searched would report: a
        lower bound over each block's window, sorted or not."""
        last, out = len(b_s) // 256 - 1, np.zeros(len(a_s), bool)
        for blk, o in enumerate(off_s.tolist()):
            lo, hi = (min(max(t, 0), last) for t in (o // 256, o // 256 + chunks - 1))
            w, v = b_s[lo * 256:(hi + 1) * 256], a_s[blk * 128:(blk + 1) * 128]
            out[blk * 128:(blk + 1) * 128] = (w[np.minimum(np.searchsorted(w, v), len(w) - 1)] == v) & (v != PAD)
        return out

    # one launch per fold round of the slate, as the planner forms them; the
    # planner sizes n_chunks to cover every span, so the masks are exact
    round_packs = []
    for r, round_pairs in enumerate(rounds):
        buf, pack, masks = segments_check([fused.intersect_inputs(x, y) for x, y in round_pairs],
                                          f"round {r + 1}")
        for s_, mask in enumerate(masks):
            a_s, b_s, _ = pack.segment(buf, s_)
            require(torch.equal(mask.bool(), torch.isin(a_s, b_s) & (a_s != int(PAD))),
                    f"round {r + 1} segment {s_}: not the exact membership")
        round_packs.append((buf, pack))
    base = [fused.intersect_inputs(x, y) for x, y in rounds[0]]
    irng = np.random.default_rng(SEED + 1)
    big_b = np.sort(irng.choice(20000, 16000, replace=False)).astype(np.int32)
    big_a = np.sort(irng.choice(20000, 5000, replace=False)).astype(np.int32)
    a_g, b_g, off_g, _ = fused.intersect_inputs(big_a, big_b)
    # mixed n_chunks (the planner's, 1, 3, the whole list); every window
    # clamped at the last tile; a single-tile b; a 16,384-element window
    # above the kernel's shared-memory budget, searched in place
    mixed = [(x, y, o, (c, 1, 3, len(y) // 256)[k]) for k, (x, y, o, c) in enumerate(base[:4])]
    x, y, o, _ = base[4 % len(base)]
    mixed.append((x, y, np.full_like(o, len(y) - 256), 4))
    a_small, b_small = base[0][0][:256].copy(), np.full(256, PAD, np.int32)
    b_small[:200] = base[0][1][:200]
    mixed.append((a_small, b_small, block_offsets(a_small, b_small, 128, 256), 2))
    mixed.append((a_g, b_g, off_g, len(b_g) // 256))
    segments_check(mixed, "mixed")
    # unsorted windows (a reversed span, a shuffled b, and the in-place
    # window reversed): equal to the plain version only through the scan
    unsorted = []
    for k, (x, y, o, c) in enumerate(base[:2]):
        y = y.copy()
        y[:3000] = y[:3000][::-1] if k == 0 else irng.permutation(y[:3000])
        unsorted.append((x, y, o, c))
    y = b_g.copy()
    y[100:12000] = y[100:12000][::-1]
    unsorted.append((a_g, y, off_g, len(y) // 256))
    _, _, masks = segments_check(unsorted, "unsorted")
    wrong = [int((search_only(*seg) != m.cpu().numpy().astype(bool)).sum()) for seg, m in zip(unsorted, masks)]
    print(f"intersect unsorted: a search alone would get {wrong} elements wrong per segment")
    require(all(w_ > 0 for w_ in wrong), "an unsorted window a search gets right: the scan branch is not shown")
    # duplicates and PAD runs in b (non-decreasing: the search stays exact)
    dups = []
    for k, (x, y, _, _) in enumerate(base[:2]):
        y = np.sort(np.repeat(y[: len(y) // 4], 4))
        y[len(y) // 2: len(y) // 2 + 700] = PAD
        y = np.sort(y)
        dups.append((x, y, block_offsets(x, y, 128, 256), (2, len(y) // 256)[k]))
    _, _, masks = segments_check(dups, "duplicates and PAD runs")
    a_s, b_s = (torch.from_numpy(t_).to(dev) for t_ in dups[1][:2])
    require(torch.equal(masks[1].bool(), torch.isin(a_s, b_s) & (a_s != int(PAD))),
            "duplicates and PAD runs: the whole-list window is not the exact membership")

    def any_offsets(na_, nb_, chunks):
        """The CPU tests' arbitrary-offset pairs (same seeds): offsets below
        0 (-1 and -257 first: floor and truncating division differ there,
        and a negative first tile wraps to the end), past the end,
        unaligned."""
        g = np.random.default_rng(na_ + nb_ + chunks)
        a_o = np.sort(g.integers(0, 3 * nb_, na_)).astype(np.int32)
        a_o[-g.integers(1, 40):] = PAD
        b_o = np.sort(g.integers(0, 3 * nb_, nb_)).astype(np.int32)
        b_o[-g.integers(1, 64):] = PAD
        off_o = g.integers(-3 * 256, nb_ + 3 * 256, na_ // 128).astype(np.int32)
        off_o[:2] = -1, -257
        return a_o, b_o, off_o, chunks

    anyoff = [any_offsets(*shape) for shape in
              ((512, 1024, 1), (1024, 2048, 2), (256, 2048, 3), (384, 256, 2), (1024, 4096, 16))]
    print(f"intersect any offsets: {sum(int((o < 0).sum()) for _, _, o, _ in anyoff)} blocks below 0, "
          f"{sum(int((o >= len(b_o)).sum()) for _, b_o, o, _ in anyoff)} past the end")
    segments_check(anyoff, "any offsets")

    t_k = cuda_ms(torch, lambda: intersect_sorted(a, b, off, n_chunks=n_chunks), 200)
    t_p = cuda_ms(torch, lambda: intersect_sorted_plain(a, b, off, n_chunks=n_chunks), 20)
    t_l = cuda_ms(torch, lambda: torch.isin(a, b), 200)
    buf1, pack1 = round_packs[0]
    t_seg = [cuda_ms(torch, lambda: intersect_sorted_segments(buf_, pack_), 200) for buf_, pack_ in round_packs]
    a_f, b_f, off_f = a[:128], b[:256], torch.zeros(1, dtype=torch.int32, device=dev)
    t_f = cuda_ms(torch, lambda: intersect_sorted(a_f, b_f, off_f, n_chunks=1), 200)
    ms, plain_ms, lib_ms = t_k[0], t_p[0], t_l[0]
    na_, nb_ = len(a_np), len(b_np)
    # both lists are sorted: a binary search of each a element over its
    # block's n_chunks * 256 b elements is what the function needs
    n_ops = na_ * math.ceil(math.log2(n_chunks * 256))
    b_ms, b_by = bound_ms(4 * (na_ + nb_ + len(off_np) + na_), n_ops)
    # a round: the packed buffer read once, the masks written once, one
    # search per a element over its segment's window
    seg_ops = sum(na_s * math.ceil(math.log2(min(c, nb_s // 256) * 256))
                  for na_s, nb_s, c in zip(pack1.na, pack1.nb, pack1.n_chunks))
    seg_b_ms, seg_b_by = bound_ms(4 * (pack1.size + sum(pack1.na)), seg_ops)
    print(f"intersect: {timing('kernel', t_k)}, {timing('plain', t_p)}, {timing('torch.isin', t_l)}, "
          f"bound {b_ms:.6f} ms ({b_by})")
    for r, (t_r, (_, pack_)) in enumerate(zip(t_seg, round_packs)):
        print(f"intersect round {r + 1}, {len(pack_.na)} segments in one launch: "
              f"{timing('kernel', t_r)} [{len(pack_.na)} single-pair launches: {len(pack_.na) * ms:.4f} ms]")
    print(f"intersect round 1 bound {seg_b_ms:.6f} ms ({seg_b_by}); "
          f"{timing('launch floor (one 128-element block, one 256-element tile)', t_f)}")

    # the slate's Step-1 host wall: one launch and one readout per pair
    # (intersect_candidates per item) against one per round
    def step1(batched):
        launched = intersect_sorted.launches
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        if batched:
            out = fused.intersect_candidates_many(fold_items, device="cuda")
        else:
            out = [fused.intersect_candidates(lists, device="cuda") for lists in fold_items]
        torch.cuda.synchronize()
        return (time.perf_counter() - t_s) * 1e3, intersect_sorted.launches - launched, out

    walls, step1_launches = {False: [], True: []}, {}
    want = [functools.reduce(np.intersect1d, lists) for lists in fold_items]
    for rep in range(6):
        for batched in ((False, True) if rep % 2 == 0 else (True, False)):
            wall, step1_launches[batched], out = step1(batched)
            walls[batched].append(wall)
            require(all(np.array_equal(g, w_) for g, w_ in zip(out, want)),
                    f"Step-1 candidates differ ({'per round' if batched else 'per pair'})")
    print(f"slate Step-1 host wall (ms, 6 runs each, alternating): one launch per pair "
          f"{[round(w_, 3) for w_ in walls[False]]} (median {sorted(walls[False])[3]:.3f}, "
          f"{step1_launches[False]} launches); one per round {[round(w_, 3) for w_ in walls[True]]} "
          f"(median {sorted(walls[True])[3]:.3f}, {step1_launches[True]} launches)")
    require(step1_launches[True] == len(rounds) and step1_launches[False] == n_pairs,
            f"Step-1 launches {step1_launches}, expected {len(rounds)} per round and {n_pairs} per pair")
    kernels.append({
        "name": "intersect_sorted", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/intersect.cu",
        "replaces": "src/repro/kernels/intersect.py:82",
        "launches": launches["intersect_sorted"], "max_abs_err": intersect_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
        "segmented_ms": t_seg[0][0], "segments": len(pack1.na),
        "segmented_bound_ms": seg_b_ms, "launch_floor_ms": t_f[0],
    })
    del a, b, off, events, mult, round_packs, buf1

    # the arena route's gather descriptors, as serve_query_batch plans them
    items = []
    for qi, q in enumerate(SLATE):
        for sub in subs[q]:
            keys = select_keys(sub, index.fl)
            exts = [residency.lookup(key.components) for key in keys]
            if keys and all(e is not None and e.n_rows for e in exts):
                items.append((qi, sub, keys, exts, residency))
    aplan = plan_arena_batch(items, n_queries=len(SLATE))
    print(f"arena plan: {len(items)} work items, tier {aplan.tier}, {aplan.n_events} live events, "
          f"groups {list(aplan.families)} with G={[len(x) for x in aplan.src]} output blocks, "
          f"row_budget {aplan.row_budget}, n_budget {aplan.n_budget}, "
          f"lemma_budget {aplan.lemma_budget}, doc_bits {aplan.doc_bits}")

    def gather_check(buf, src_t, nv_t, label):
        got = gather_blocks(buf, src_t, nv_t)
        want = gather_blocks_plain(buf, src_t, nv_t)
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        print(f"gather {label} G={src_t.shape[0]} over {buf.shape[0] // ARENA_BLOCK} arena blocks: "
              f"{int((got[:, 0] >= 0).sum())} live rows, max_abs_err {err}")
        require(err == 0 and got.shape == want.shape, f"gather kernel != plain ({label})")
        return err

    gather_err, groups = 0, []
    for g, fname in enumerate(aplan.families):
        src_t, nv_t = (torch.from_numpy(x[g]).to(dev) for x in (aplan.src, aplan.nv))
        gather_err = max(gather_err, gather_check(aplan.buffers[g], src_t, nv_t, f"main-path {fname}"))
        groups.append((len(aplan.src[g]), aplan.buffers[g], src_t, nv_t, aplan.nv[g]))
    # random descriptors over the largest resident buffer: repeated sources,
    # padded blocks (src 0, n_valid 0), sources past either end, every
    # n_valid kind
    big = max((fb.buf for fb in residency.families.values()), key=lambda t: t.shape[0])
    nb_big = big.shape[0] // ARENA_BLOCK
    src_r = rng.integers(0, nb_big, 8192).astype(np.int32)
    src_r[::7] = src_r[0]
    src_r[1], src_r[2], src_r[-64:] = -5, nb_big + 5, 0
    nv_r = rng.choice([0, 1, 63, 64, 127, ARENA_BLOCK, ARENA_BLOCK + 3, -1], 8192).astype(np.int32)
    nv_r[-64:] = 0
    gather_err = max(gather_err, gather_check(
        big, torch.from_numpy(src_r).to(dev), torch.from_numpy(nv_r).to(dev), "random"))
    # times at the main path's largest group
    g_blocks, buf, src_t, nv_t, nv_np = max(groups, key=lambda t: t[0])
    t_k = cuda_ms(torch, lambda: gather_blocks(buf, src_t, nv_t), 200)
    t_p = cuda_ms(torch, lambda: gather_blocks_plain(buf, src_t, nv_t), 20)
    blocks3 = buf.view(-1, ARENA_BLOCK, 2)
    t_l = cuda_ms(torch, lambda: torch.index_select(blocks3, 0, src_t), 200)
    ms, plain_ms, lib_ms = t_k[0], t_p[0], t_l[0]
    live_rows = int(np.clip(nv_np, 0, ARENA_BLOCK).sum())
    # 8 B per output row written, per live row read, per block of indirection
    b_ms, b_by = bound_ms(8 * (g_blocks * ARENA_BLOCK + live_rows + g_blocks), 0)
    print(f"gather G={g_blocks} ({live_rows} live rows): {timing('kernel', t_k)}, {timing('plain', t_p)}, "
          f"{timing('torch.index_select (the gather without the mask)', t_l)}, bound {b_ms:.6f} ms ({b_by})")
    kernels.append({
        "name": "gather_blocks", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gather.cu",
        "replaces": "src/repro/kernels/gather.py:64",
        "launches": launches["gather_blocks"], "max_abs_err": gather_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
    })
    del groups, buf, src_t, nv_t, blocks3
    t0 = phase("kernels vs plain versions", t0)

    # ---- 6. the slate against the event-rank cover, the arena and the CPU -----
    full = [SearchRequest(q, top_k=len(store)) for q in SLATE]
    cpu_arena = PostingArena(budget_bytes=ARENA_BUDGET, device="cpu")
    t_acq = time.perf_counter()
    cpu_arena.acquire(index, 0)
    print(f"cpu arena cold acquire: {time.perf_counter() - t_acq:.3f} s")
    runs = {}
    for label, kwargs in (
        ("cuda kernel", dict(device="cuda", use_kernel=True)),
        ("cuda rank", dict(device="cuda", use_kernel=False)),
        ("cuda arena kernel", dict(device="cuda", use_kernel=True, arena=arena)),
        ("cuda arena dense", dict(device="cuda", use_kernel=False, arena=arena)),
        ("cpu arena", dict(device="cpu", arena=cpu_arena)),
        ("cpu", dict(device="cpu")),
    ):
        t_run = time.perf_counter()
        runs[label] = ServingFrontend(index, lemmatizer=lem, max_batch=16, **kwargs).search_many(full)
        print(f"{label}: {(time.perf_counter() - t_run) * 1e3:.1f} ms for the slate, all documents ranked")
        if "arena" in label:
            require(sum(r.stats.arena_hits for r in runs[label]) > 0, f"{label} did not hit the arena")
    for qi, q in enumerate(SLATE):
        ref = runs["cpu"][qi]
        ref_frags = {(d.doc_id, f.start, f.end) for d in ref.docs for f in d.fragments}
        for label in runs.keys() - {"cpu"}:
            got = runs[label][qi]
            require({(d.doc_id, f.start, f.end) for d in got.docs for f in d.fragments} == ref_frags,
                    f"{label} fragments differ from the cpu run for {q!r}")
            require([d.doc_id for d in got.docs] == [d.doc_id for d in ref.docs],
                    f"{label} documents differ from the cpu run for {q!r}")
            require(np.allclose([d.score for d in got.docs], [d.score for d in ref.docs], rtol=SCORE_RTOL),
                    f"{label} scores differ from the cpu run for {q!r}")
        for resps, route in ((main_resps, "host"), (arena_resps, "arena")):
            require([d.doc_id for d in resps[qi].docs] == [d.doc_id for d in ref.docs[:TOP_K]],
                    f"{route} route top {TOP_K} differs from the cpu ranking for {q!r}")
        print(f"  {q!r}: {len(ref_frags)} fragments in {len(ref.docs)} docs agree on all {len(runs)} runs")
    t0 = phase("agreement: every card and cpu run == the cpu host route", t0)

    # ---- 7. the launcher's default deployment: 4 shards, se2.4 ---------------
    # the first SHARDED_DOCS documents of phase 3's store: every key of every
    # shard is built, and two cold acquires build and copy every family
    shard_store = DocumentStore(documents=store.documents[:SHARDED_DOCS], lemmatizer=lem)
    t_build = time.perf_counter()
    svc = ShardedSearchService(shard_store, n_shards=N_SHARDS, sw_count=SW_COUNT, fu_count=FU_COUNT,
                               max_distance=MAX_DISTANCE, device="cuda")
    print(f"sharded service: {len(shard_store)} docs of phase 3's store in {N_SHARDS} shards under one "
          f"FL-list, built in {time.perf_counter() - t_build:.1f} s")
    for i, shard in enumerate(svc.shards):
        sizes = shard.size_bytes()
        longest = max((len(sorted(lists, key=len)[0]) for lists in step1_folds([shard])[0]), default=0)
        print(f"  shard {i}: {shard.n_docs} docs, {sizes['total'] / 2**20:.1f} MiB of postings "
              f"({sizes['triple'] / 2**20:.1f} MiB triple); the longest shortest Step-1 list of a "
              f"multi-key item: {longest} docs (device threshold {fused.INTERSECT_DEVICE_THRESHOLD})")
    _, shard_rounds = step1_folds(svc.shards)
    print(f"sharded slate Step-1 folds: {sum(len(pairs) for pairs in shard_rounds)} device pairs in "
          f"{len(shard_rounds)} rounds")
    # one index over the same documents (the slate's (f,s,t) keys, as in
    # phase 3), served by the host route on the CPU
    fl_one = FLList.from_frequencies(shard_store.lemma_frequencies(), sw_count=SW_COUNT, fu_count=FU_COUNT)
    one = build_indexes(shard_store, SW_COUNT, FU_COUNT, max_distance=MAX_DISTANCE, fl=fl_one,
                        triple_key_filter={k.components for q in SLATE for sub in subs[q]
                                           for k in select_keys(sub, fl_one) if k.arity == 3})
    single_cpu = ServingFrontend(one, lemmatizer=lem, max_batch=16, device="cpu").search_many(full)
    t0 = phase("sharded service and single-index build (host), single-index cpu host route", t0)

    def sharded_route(path, make_fe, expect):
        """The slate once through a fresh frontend with the launch counters
        at 0 before and read after, its cached repeat, the profile of 5
        fresh frontends, and every document ranked through one more."""
        fe = make_fe()
        zero_counts()
        fused.reset_dispatch_count()
        t_serve = time.perf_counter()
        resps = fe.search_many(requests)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t_serve) * 1e3
        counts, dispatches = read_counts(path), fused.dispatch_count()
        hits = sum(r.stats.arena_hits for r in resps)
        print(f"{path}: {dispatches} device programs, kernel launches {counts}, arena hits {hits} keys, "
              f"misses {sum(r.stats.arena_misses for r in resps)} keys")
        for kname in ("proximity_window", "gather_blocks"):
            if expect[kname]:
                require(counts[kname] > 0, f"{kname} was not launched on the {path}")
        require(counts["intersect_sorted"] == expect["intersect_sorted"],
                f"the {path} made {counts['intersect_sorted']} intersect launches, "
                f"{expect['intersect_sorted']} expected")
        require(hits > 0 or not expect["gather_blocks"], f"the {path} did not hit the arena")
        t_serve = time.perf_counter()
        cached = fe.search_many(requests)
        cached_ms = (time.perf_counter() - t_serve) * 1e3
        require(all(r.stats.cache_hits == 1 for r in cached), f"second {path} round not all cache hits")
        slate_profile(make_fe, path, first_ms, cached_ms)
        return make_fe().search_many(full)

    sharded = {"sharded host route": sharded_route(
        "sharded host route",
        lambda: ServingFrontend(svc, device="cuda", use_kernel=True, max_batch=16),
        {"proximity_window": True, "gather_blocks": False, "intersect_sorted": len(shard_rounds)})}

    def cold_arena(budget_bytes):
        """An arena on the card with the frontend's own tokens, acquired
        cold for every shard: its seconds and each shard's resident and
        refused families."""
        fe = ServingFrontend(svc, arena_budget_mb=budget_bytes / 2**20, device="cuda", use_kernel=True,
                             max_batch=16)
        token = generation_token(svc)
        t_acq = time.perf_counter()
        res = fe.arena.acquire_many([(shard, token, i) for i, shard in enumerate(svc.shards)])
        torch.cuda.synchronize()
        m = fe.arena.metrics()
        print(f"sharded cold acquire (budget {budget_bytes >> 20} MiB): {time.perf_counter() - t_acq:.3f} s, "
              f"{m['arena_uploads']} uploads, {m['arena_upload_bytes'] / 2**20:.1f} MiB copied to the card, "
              f"{m['arena_bytes'] / 2**20:.1f} MiB kept")
        fam_bytes = []
        for i, r in enumerate(res):
            refused_i = {key[3]: nb for key, nb in fe.arena.refused.items() if key[2] == i}
            print(f"  shard {i}: resident {json.dumps({f: f'{fb.nbytes / 2**20:.1f} MiB' for f, fb in r.families.items()})}, "
                  f"refused {json.dumps({f: f'{nb / 2**20:.1f} MiB' for f, nb in refused_i.items()})}")
            fam_bytes.append({**{f: fb.nbytes for f, fb in r.families.items()}, **refused_i})
        return fe.arena, res, fam_bytes

    def arena_route(budget_bytes, arena_, res):
        uploads = arena_.metrics()["arena_uploads"]
        triples = all("triple" in r.families for r in res)
        path = f"sharded arena route ({budget_bytes >> 20} MiB)"
        sharded[path] = sharded_route(
            path, lambda: ServingFrontend(svc, arena=arena_, device="cuda", use_kernel=True, max_batch=16),
            {"proximity_window": not triples, "gather_blocks": triples,
             "intersect_sorted": 0 if triples else len(shard_rounds)})
        require(arena_.metrics()["arena_uploads"] == uploads, f"the {path} uploaded: the cold entries were missed")
        return triples

    arena64, res64, fam_bytes = cold_arena(ARENA_BUDGET)
    triples_resident = arena_route(ARENA_BUDGET, arena64, res64)
    arena64.release()
    if not triples_resident:
        # the smallest power-of-two budget at which the acquire's admission
        # (every shard's families in order, none evictable) keeps every
        # shard's triples, from the sizes the cold acquire recorded
        def admits(budget):
            used, kept = 0, 0
            for sizes in fam_bytes:
                for fname in ("stop_single", "stop_pair", "pair", "triple"):
                    if used + sizes[fname] <= budget:
                        used += sizes[fname]
                        kept += fname == "triple"
            return kept == N_SHARDS

        budget = ARENA_BUDGET
        while not admits(budget):
            budget *= 2
        print(f"the slate's triples are refused at {ARENA_BUDGET >> 20} MiB; the smallest power-of-two "
              f"budget that admits every shard's triple family: {budget >> 20} MiB")
        arena_big, res_big, _ = cold_arena(budget)
        require(arena_route(budget, arena_big, res_big), f"the triples are not resident at {budget >> 20} MiB")
        arena_big.release()
    t0 = phase("serving (sharded host and arena routes)", t0)

    svc.algorithm, svc.use_kernel = "fused", True
    zero_counts()
    t_serve = time.perf_counter()
    sharded["svc.search_batch fused"] = svc.search_batch(SLATE, top_k=len(store))
    torch.cuda.synchronize()
    counts = read_counts("sharded svc.search_batch fused")
    print(f"svc.search_batch (fused, use_kernel): {(time.perf_counter() - t_serve) * 1e3:.1f} ms for the slate, "
          f"all documents ranked, kernel launches {counts}")
    require(counts["proximity_window"] > 0, "proximity_window was not launched by svc.search_batch")
    svc.algorithm = "se2.4"
    t_serve = time.perf_counter()
    combiner = svc.search_batch(SLATE, top_k=len(store))
    print(f"svc.search_batch (se2.4, the host Combiner over the same shards): "
          f"{time.perf_counter() - t_serve:.2f} s for the slate")
    for qi, q in enumerate(SLATE):
        ref = combiner[qi]
        ref_frags = {(d.doc_id, f.start, f.end) for d in ref.docs for f in d.fragments}
        for label, resps in (*sharded.items(), ("single-index cpu host route", single_cpu)):
            got = resps[qi]
            require({(d.doc_id, f.start, f.end) for d in got.docs for f in d.fragments} == ref_frags,
                    f"{label} fragments differ from se2.4 over the shards for {q!r}")
            require([d.doc_id for d in got.docs] == [d.doc_id for d in ref.docs],
                    f"{label} documents differ from se2.4 over the shards for {q!r}")
            require(np.allclose([d.score for d in got.docs], [d.score for d in ref.docs], rtol=SCORE_RTOL),
                    f"{label} scores differ from se2.4 over the shards for {q!r}")
        print(f"  {q!r}: {len(ref_frags)} fragments in {len(ref.docs)} docs; se2.4 == "
              f"{len(sharded) + 1} routes")
    t0 = phase("agreement: sharded routes == se2.4 over the shards == the single index", t0)

    # the baselines on one query, each held to the contract the reference's
    # own tests hold it to (tests/test_combiner.py): se2.2 and se2.3 equal
    # the §10 sweep over their own keys' events in the documents every key
    # reaches, as se2.4 does over its keys, and SE1 the sweep over the
    # ordinary index; SE2.1 treats the query as a lemma set, and every
    # fragment it reports is checked against the document's own lemmas.
    # Their fragment sets differ from se2.4's by design (other events, other
    # keys, set semantics): the overlap is printed
    q = "to be or not to be"
    qsubs = expand_subqueries(q, lem)
    docs_by_id = {d.doc_id: d for d in store.documents}
    want = {"se1": set(), "se2.2": set(), "se2.3": set(), "se2.4": set()}
    for shard in svc.shards:
        for sub in qsubs:
            mult, span = sub.multiplicity(), 2 * MAX_DISTANCE
            for alg, keys, honor in (("se2.2", simple_key_cover(sub, shard.fl), True),
                                     ("se2.3", select_keys(sub, shard.fl), False),
                                     ("se2.4", select_keys(sub, shard.fl), True)):
                post = {k: shard.key_postings(k.components) for k in keys}
                # the documents every key's iterator reaches (Step 1)
                aligned = functools.reduce(np.intersect1d, [np.unique(a[:, 0]) for a in post.values()])
                for doc, events in key_events(keys, post, honor_stars=honor).items():
                    if doc in aligned:
                        want[alg] |= {tuple(r) for r in sweep_events(doc, events, mult, span)}
            for doc, events in ordinary_events(sub.lemmas, shard.ordinary).items():
                want["se1"] |= {tuple(r) for r in sweep_events(doc, events, mult, span)}
    got = {}
    for alg in ("se2.4", "se1", "se2.1", "se2.2", "se2.3"):
        svc.algorithm = alg
        t_q = time.perf_counter()
        r = svc.search(q, top_k=len(store))
        secs = time.perf_counter() - t_q
        got[alg] = {(d.doc_id, f.start, f.end) for d in r.docs for f in d.fragments}
        print(f"{alg} over the 4 shards, {q!r}: {secs:.3f} s, {len(got[alg])} fragments, "
              f"{len(got[alg] & got['se2.4'])} shared with se2.4, "
              f"postings read {r.stats.postings_read}")
    for alg, frags in want.items():
        require(got[alg] == frags, f"{alg} != the sweep over its own events for {q!r}")
    for doc, start, end in got["se2.1"]:
        words = {lm for pos in docs_by_id[doc].lemma_stream[start:end + 1] for lm in pos}
        require(end - start <= 2 * MAX_DISTANCE and any(set(sub.lemmas) <= words for sub in qsubs),
                f"se2.1 fragment {(doc, start, end)} does not hold the query's lemmas")
    print("baselines against se2.4: " + ", ".join(
        f"{alg} {'==' if got[alg] == got['se2.4'] else '!='} se2.4" for alg in ("se1", "se2.1", "se2.2", "se2.3")))
    svc.algorithm = "se2.4"

    # device_topk_merge on the card: each shard's top 10 of a response
    # (from se2.4 over the shards), a tie forced across shards at the top
    ref = max(combiner, key=lambda r: len(r.docs))
    per_shard = [[(d.score, d.doc_id) for d in ref.docs if d.doc_id % N_SHARDS == s_][:TOP_K]
                 for s_ in range(N_SHARDS)]
    sc = np.full((N_SHARDS, TOP_K), -np.inf, np.float32)
    dc = np.full((N_SHARDS, TOP_K), -1, np.int32)
    for s_, lst in enumerate(per_shard):
        sc[s_, :len(lst)] = [x for x, _ in lst]
        dc[s_, :len(lst)] = [y for _, y in lst]
    sc[1, 0] = sc[3, 0] = sc[0, 0]
    top_s, top_d = device_topk_merge(torch.from_numpy(sc).to(dev), torch.from_numpy(dc).to(dev), TOP_K)
    order = np.argsort(-sc.reshape(-1), kind="stable")[:TOP_K]
    print(f"device_topk_merge on {top_s.device}: {ref.query!r}, {N_SHARDS} x {TOP_K} per-shard lists, "
          f"merged top docs {top_d.tolist()}")
    require(top_d.device.type == "cuda" and np.array_equal(top_d.cpu().numpy(), dc.reshape(-1)[order])
            and np.array_equal(top_s.cpu().numpy(), sc.reshape(-1)[order]),
            "device_topk_merge != a stable host sort")
    phase("baselines and device_topk_merge", t0)

    for entry in kernels:
        by_path = {path: counts[entry["name"]] for path, counts in path_launches.items()}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
