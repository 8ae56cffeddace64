#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its seconds:

1. the device: name, count, and ``nvidia-smi``'s name and power limit;
2. the kernel build: every ``src/repro_torch/kernels/csrc/*.cu``, one
   ``nvcc`` per source, all started together;
3. the index: a synthetic Zipf corpus of 8,192 documents x 250 positions,
   indexed by the port (the host-side build is what bounds the corpus size);
4. the main path: a slate of queries served twice through
   ``ServingFrontend(device="cuda", use_kernel=True)``.  Both kernels' launch
   counters are set to 0 just before the first round and read just after it;
   the run fails unless both rose.  The second round must be all cache hits;
5. the kernels against their plain PyTorch versions on the card, at the
   shapes of the main path's own inputs (plus random inputs that exercise
   the compute dtype's wraparound), with kernel, plain-version, bound and
   library-call times;
6. the slate again through fresh frontends — the event-rank cover on the
   card and the whole port on the CPU — which must agree with the main
   path: equal fragments and documents, scores within rtol 1e-5.

It exits non-zero on the first failure (no phase catches its own), and when
no CUDA device is present.  The line before the last is a JSON object with
one entry per kernel; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

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


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
    from repro_torch.index import build_indexes, synthesize_corpus
    from repro_torch.kernels import _build
    from repro_torch.kernels.intersect import (
        intersect_sorted,
        intersect_sorted_plain,
    )
    from repro_torch.kernels.proximity import proximity_window, proximity_window_plain
    from repro_torch.search import SearchRequest, ServingFrontend, fused, rank_documents

    dev = torch.device("cuda", 0)
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

    # ---- 4. main path --------------------------------------------------------
    requests = [SearchRequest(q, top_k=TOP_K) for q in SLATE]
    frontend = ServingFrontend(index, lemmatizer=lem, device="cuda", use_kernel=True, max_batch=16)
    proximity_window.launches = 0
    intersect_sorted.launches = 0
    fused.reset_dispatch_count()
    t_serve = time.perf_counter()
    main_resps = frontend.search_many(requests)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t_serve) * 1e3
    launches = {
        "proximity_window": proximity_window.launches,
        "intersect_sorted": intersect_sorted.launches,
    }
    dispatches = fused.dispatch_count()
    print(f"main path: {len(SLATE)} queries, {dispatches} device programs, kernel launches {launches}")
    for kname, count in launches.items():
        require(count > 0, f"{kname} was not launched on the main path")
    t_serve = time.perf_counter()
    cached = frontend.search_many(requests)
    cached_ms = (time.perf_counter() - t_serve) * 1e3
    require(all(r.stats.cache_hits == 1 for r in cached), "second round not all cache hits")
    for r in main_resps:
        require(all(np.isfinite(d.score) and d.score > 0 for d in r.docs), f"bad scores for {r.query!r}")
        print(f"  {r.query!r}: {r.stats.results} fragments, top doc "
              f"{r.docs[0].doc_id if r.docs else None}, {r.n_subqueries} subqueries")
    # steady state: fresh frontends (cold result cache) on a warm device
    slate_ms, phases = [], {}
    for rep in range(5):
        fe = ServingFrontend(index, lemmatizer=lem, device="cuda", use_kernel=True, max_batch=16)
        prev = fused.collect_phases(phases if rep == 4 else None)
        t_serve = time.perf_counter()
        fe.search_many(requests)
        torch.cuda.synchronize()
        slate_ms.append((time.perf_counter() - t_serve) * 1e3)
        fused.collect_phases(prev)
    print(f"slate latency on {name}: first {first_ms:.1f} ms, cached {cached_ms:.3f} ms, "
          f"fresh frontend {[round(x, 1) for x in slate_ms]} ms (median {sorted(slate_ms)[2]:.1f})")
    print("phases of one instrumented slate (us): "
          + json.dumps({k: [round(x, 1) for x in v] for k, v in phases.items()}))
    # device busy share of one fresh slate, from the profiler's kernel and
    # copy events (one stream: they do not overlap)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fe = ServingFrontend(index, lemmatizer=lem, device="cuda", use_kernel=True, max_batch=16)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_serve = time.perf_counter()
        fe.search_many(requests)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_serve) * 1e3
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    print(f"profiled slate: wall {wall_ms:.1f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.2f}%), idle {100 - 100 * busy_ms / wall_ms:.2f}%")
    for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} {e.key[:90]}")
    t0 = phase("serving (main path)", t0)

    # ---- 5. kernels against their plain versions, main-path shapes -----------
    work = [[(sub, index) for sub in subs[q]] for q in SLATE]
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

    def cover_check(occ, mult_, dtype, label):
        ek, sk = proximity_window(occ, mult_, MAX_DISTANCE, compute_dtype=dtype)
        ep, sp = proximity_window_plain(occ, mult_, MAX_DISTANCE, compute_dtype=dtype)
        torch.cuda.synchronize()
        err = max(
            int((ek != ep).sum()),
            int(torch.where(ep, (sk - sp).abs(), 0).max()),
        )
        print(f"proximity {label} {dtype} {tuple(occ.shape)}: {int(ep.sum())} emits, max_abs_err {err}")
        require(err == 0, f"proximity kernel != plain ({label}, {dtype})")
        return err

    rng = np.random.default_rng(SEED)
    for dtype in ("uint8", "int32"):
        occ = fused.scatter_occupancy(events, r, l, n, dtype)
        err = cover_check(occ, mult, dtype, "main-path")
        # arbitrary occupancy values: both sides wrap in the compute dtype
        if dtype == "uint8":
            occ_w = rng.integers(0, 256, (256, l, n), dtype=np.uint8)
        else:
            occ_w = rng.integers(-(2**31), 2**31, (256, l, n), dtype=np.int64).astype(np.int32)
        mult_w = rng.integers(0, 4, (256, l)).astype(np.int32)
        cover_check(torch.from_numpy(occ_w).to(dev), torch.from_numpy(mult_w).to(dev), dtype, "wraparound")
        ms = cuda_ms(torch, lambda: proximity_window(occ, mult, MAX_DISTANCE, compute_dtype=dtype), 50)
        plain_ms = cuda_ms(torch, lambda: proximity_window_plain(occ, mult, MAX_DISTANCE, compute_dtype=dtype), 2)
        item = occ.element_size()
        n_bytes = r * l * n * item + r * l * item + r * n * (1 + 4)
        # an add and a compare per active (row, lemma), position and offset
        n_ops = 2 * int((plan.mult > 0).sum()) * n * (2 * MAX_DISTANCE + 1)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        print(f"proximity {dtype}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        if dtype == "uint8":  # the frontend's compute dtype: the main path's entry
            kernels.append({
                "name": "proximity_window", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/proximity.cu",
                "replaces": "src/repro/kernels/proximity.py:105",
                "launches": launches["proximity_window"], "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,
            })
        del occ

    # the two longest doc lists of one multi-key subquery of the slate
    pairs = []
    for q in SLATE:
        for sub in subs[q]:
            keys = select_keys(sub, index.fl)
            docs = sorted(
                (np.unique(index.key_postings(key.components)[:, 0]) for key in keys), key=len
            )
            if len(docs) >= 2:
                pairs.append((min(len(docs[-1]), len(docs[-2])), docs[-2], docs[-1]))
    _, a_docs, b_docs = max(pairs, key=lambda t: t[0])
    a_np, b_np, off_np, n_chunks = fused.intersect_inputs(a_docs, b_docs)
    a, b, off = (torch.from_numpy(x).to(dev) for x in (a_np, b_np, off_np))
    print(f"intersect inputs: |a|={len(a_docs)} |b|={len(b_docs)} NA={len(a_np)} NB={len(b_np)} n_chunks={n_chunks}")
    full_chunks = len(b_np) // 256
    member = torch.isin(a, b) & (a != int(fused.PAD))
    intersect_err = 0
    for chunks, label in ((n_chunks, "main-path"), (full_chunks, "full"), (1, "partial")):
        got = intersect_sorted(a, b, off, n_chunks=chunks)
        want = intersect_sorted_plain(a, b, off, n_chunks=chunks)
        err = int((got != want).sum())
        print(f"intersect {label} n_chunks={chunks}: {int(got.sum())} hits, "
              f"{int(member.sum())} members, max_abs_err {err}")
        require(err == 0, f"intersect kernel != plain ({label})")
        intersect_err = max(intersect_err, err)
        require(bool((got <= member.int()).all()), f"intersect false positive ({label})")
        if chunks >= n_chunks:
            require(torch.equal(got.bool(), member), f"intersect under-reports ({label})")
    ms = cuda_ms(torch, lambda: intersect_sorted(a, b, off, n_chunks=n_chunks), 200)
    plain_ms = cuda_ms(torch, lambda: intersect_sorted_plain(a, b, off, n_chunks=n_chunks), 20)
    lib_ms = cuda_ms(torch, lambda: torch.isin(a, b), 200)
    na_, nb_ = len(a_np), len(b_np)
    # both lists are sorted: a binary search of each a element over its
    # block's n_chunks * 256 b elements is what the function needs
    n_ops = na_ * math.ceil(math.log2(n_chunks * 256))
    b_ms, b_by = bound_ms(4 * (na_ + nb_ + len(off_np) + na_), n_ops)
    print(f"intersect: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.isin {lib_ms:.4f} ms, "
          f"bound {b_ms:.6f} ms ({b_by})")
    kernels.append({
        "name": "intersect_sorted", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/intersect.cu",
        "replaces": "src/repro/kernels/intersect.py:82",
        "launches": launches["intersect_sorted"], "max_abs_err": intersect_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
    })
    del a, b, off, events, mult
    t0 = phase("kernels vs plain versions", t0)

    # ---- 6. the slate against the event-rank cover and the CPU ---------------
    full = [SearchRequest(q, top_k=len(store)) for q in SLATE]
    runs = {}
    for label, kwargs in (
        ("cuda kernel", dict(device="cuda", use_kernel=True)),
        ("cuda rank", dict(device="cuda", use_kernel=False)),
        ("cpu", dict(device="cpu")),
    ):
        t_run = time.perf_counter()
        runs[label] = ServingFrontend(index, lemmatizer=lem, max_batch=16, **kwargs).search_many(full)
        print(f"{label}: {(time.perf_counter() - t_run) * 1e3:.1f} ms for the slate, all documents ranked")
    for qi, q in enumerate(SLATE):
        ref = runs["cpu"][qi]
        ref_frags = {(d.doc_id, f.start, f.end) for d in ref.docs for f in d.fragments}
        for label in ("cuda kernel", "cuda rank"):
            got = runs[label][qi]
            require({(d.doc_id, f.start, f.end) for d in got.docs for f in d.fragments} == ref_frags,
                    f"{label} fragments differ from the cpu run for {q!r}")
            require([d.doc_id for d in got.docs] == [d.doc_id for d in ref.docs],
                    f"{label} documents differ from the cpu run for {q!r}")
            require(np.allclose([d.score for d in got.docs], [d.score for d in ref.docs], rtol=SCORE_RTOL),
                    f"{label} scores differ from the cpu run for {q!r}")
        require([d.doc_id for d in main_resps[qi].docs] == [d.doc_id for d in ref.docs[:TOP_K]],
                f"main-path top {TOP_K} differs from the cpu ranking for {q!r}")
        print(f"  {q!r}: {len(ref_frags)} fragments in {len(ref.docs)} docs agree on all three runs")
    phase("agreement: cuda kernel == cuda rank == cpu", t0)

    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
