#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases 12,13  # phases 1, 2, 12 and 13 only
    python3 chip_smoke.py --phases 14     # phases 1, 2 and 14 only
    python3 chip_smoke.py --phases 15     # phases 1, 2 and 15 (worlds of ranks) only
    python3 chip_smoke.py --phases 16     # phases 1, 2 and 16: needs four cards

Phases, each printed with its seconds (``--phases`` selects some of them:
phases 1 and 2 always run, and phases 3-10 run together or not at all; the
default is phases 1-15, on one card; phase 16 runs only when selected, and
the run then exits non-zero, naming the count, where fewer than four cards
are visible; the last line is the same either way):

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
   and over an arena at the smallest power-of-two budget that keeps every
   shard's triples (2,048 MiB, checked; the launcher's 64 MiB keeps none,
   and phase 8 drives its host-pack fallback) — each with its launch
   counters set to 0 before and read after, 5 fresh-frontend latencies and
   a profile; then ``svc.search_batch`` with ``fused`` and
   with ``se2.4``, the host Combiner over the same shards.  Every route must
   equal ``se2.4`` over the shards and the single-index CPU route.
   The baselines SE1 and SE2.1-SE2.3 are timed on "to be or not to be" and
   each held to its own oracle, and ``device_topk_merge`` runs on the card
   over per-shard top-10 lists with a forced tie, against a stable host sort.

8. the reference launcher's durable deployment (``--snapshot-dir``) on the
   same 4,096 documents: ``ShardedSearchService(incremental=True)``, each
   shard's view required equal to phase 7's static shard; a WAL-less
   snapshot of it for phase 9a; ``enable_wal`` and ``snapshot`` into a
   temporary directory (seconds, MiB on disk); the slate
   through the host route and through a 64 MiB arena attached to the source,
   before and after a mutation (512 documents added, 64 of the slate's
   documents deleted, one ``commit``) — each with launch counters, 5
   fresh-frontend latencies and a profile, the arena's cold acquire timed,
   every route equal to ``se2.4`` over the live shards and to
   ``svc.search_batch`` with ``fused``; the arena's evictions required to
   lower ``torch.cuda.memory_allocated()`` by the bytes it evicted; shard 0
   held to a scalar rebuild of its survivors; ``compact`` and the host route
   again; then one more snapshot, acknowledged post-snapshot work (128
   added, 16 deleted, a commit), and ``ServingFrontend.from_snapshot`` in a
   fresh process (torch and the port only), which must replay WAL records
   and serve the live service's fragments exactly.

9. the reference launcher's other deployments, on the same 4,096 documents:
   (a) ``ShardedSearchService.bulk_ingest`` with 4 spawn workers (seconds,
   KiB spilled, docs/s), its tree required equal, file by file (sha256), to
   a WAL-less snapshot phase 8 takes of its freshly built service, the
   ``restore_epoch.*`` claims aside; the slate through the bulk-ingested
   service's host route (cover launches counted) equal to phase 7's
   ``se2.4``; (b) the WAL and a seeded fault schedule (``CHAOS_SEED``) on
   it, the slate through a 64 MiB arena frontend for ``CHAOS_ROUNDS``
   rounds — every response exact or flagged ``DEGRADED`` and exact over its
   live shards, faults fired and a snapshot recovery required — then
   ``search_batch(dead_shards=[1])`` fused with the cover kernel, flagged
   and exact over shards 0, 2 and 3; (c) ``python -m
   repro_torch.launch.serve`` in fresh processes (torch and the port only):
   a warm start from the bulk tree (its cached second round and its top 10
   equal to the live service's), the same under the fault schedule, a
   2-replica daemon on TCP with a client that kills the primary (every
   wire response equal to the warm start's, a failover reported, a clean
   exit on ``SIGINT``; the client's wall split into its imports, the kill,
   the first query, which waits for the successor replica's first batch and
   its cold 64 MiB arena acquire, the other queries and the metrics; the
   kill runs after run 4 has ended and while the card child waits at its
   next phase line, ``QuietGate``) and the CLI's own bulk-ingested cold
   start and warm start over a corpus of ``CLI_DOCS`` documents.  The launcher processes
   run alongside the in-process phases 9a and 9b (their work is host-bound
   and disjoint: the bulk tree is only read once 9b has armed its WAL).

10. the ``paper_search`` device steps: every cell of the reference's
   dry-run (``serve_online``, ``serve_bulk``, ``score_1m``, ``build_chunk``)
   at its single-pod layout (256 cluster shards folded into one program)
   through ``repro_torch.launch.dryrun.run_cell`` on seeded inputs (3-5
   active lemmas a query, bursts narrower than the window, a tenth of the
   clusters padded, a few postings out of range), each with its launch
   counters set to 0 before and read after (one cover launch a serve call);
   each serve cell's kernel path against its plain path on the card
   (``n_fragments`` and ``top_docs`` identical, scores within rtol 1e-5,
   fragments found), ``serve_online`` also against the CPU, and the cover
   kernel against its plain version at N = 128 with the three stages' times,
   the cover's byte bound and the cell's peak memory; ``build_step`` over
   ``synthesize_corpus(n_docs=4096, doc_len=1024)``'s FL-numbers, bit-equal
   on the card, on the CPU and in a numpy count; the slate's subqueries over
   phase 3's index in one ``serve_step`` (clusters == documents), equal to
   ``se2.4`` and ``rank_documents``; and ``python -m
   repro_torch.launch.dryrun --arch paper_search --all`` in a fresh process
   (jax and the reference package blocked), which must exit 0 with four
   ``ok`` records under ``artifacts/``.  The CLI and the build corpus's
   host-side construction start when phase 9 ends, beside the card child.

11. the dense LM training path (``tinyllama-1.1b`` at its full width): (a)
   ``repro_torch.launch.dryrun.run_cell`` on the four runnable cells at one
   data rank's share of the global batch (train_4k 16 x 4,096 in 2
   microbatches and prefill_32k 2 x 32,768 at 4 of the 22 layers,
   decode_32k 8 sequences on a 32,768-token cache and long_500k[swa] 1 x
   524,288 with a 4,096 window at all 22; long_500k stays skipped), each
   with its wall ms, peak MiB and the model TFLOP/s of the share, and a
   ``torch.profiler`` breakdown of one train_4k step; the launch counters are set to 0 before and read after (this path
   runs none of the three kernels); (b) ``flash_attention`` against
   ``attention_plain`` at one layer's shapes (16 x 4,096, 32 heads, kv 4) in
   bfloat16, within 2e-2 relative; (c) a prefill of 1,024 tokens and one
   ``decode_step`` against a prefill of 1,025, all 22 layers, in float32
   within 1e-4 relative and in bfloat16 within 5e-2; (d) one float32 train
   step at full width with depth cut to 2 layers (seq 256, batch 2) on the
   card against the port on this machine's CPU (metrics within rtol 1e-4,
   params within atol 1e-5); (e) ``python -m repro_torch.launch.train
   --arch tinyllama-1.1b --full-scale --steps 6`` in a fresh process, every
   loss and grad norm finite, run beside phase 3's host-side index build
   (the card otherwise idle); (f) beside phase 7's host-side builds,
   checkpoint resume at full width with depth cut to 2 layers, under
   ``torch.use_deterministic_algorithms(True)``: 4 steps straight against 2
   steps, ``CheckpointManager.save_async`` and, in a fresh process,
   ``restore_checkpoint`` and 2 more steps on the restored pipeline state —
   params equal bit for bit; the checkpoint files are deleted after.

12. the MoE LM family, in one child process (torch and the port only) with
   phases 13-15, run beside phases 7, 8 and 9 (host-bound; phase 15 first,
   so that 12's largest cell meets phase 9): (a) ``run_cell`` on
   ``olmoe-1b-7b`` at full width and one data rank's share (prefill_32k at
   8 of 16 layers, train_4k at 4 in 4 microbatches, decode_32k and
   long_500k[swa] at 6) and on ``llama4-maverick-400b-a17b`` at full width
   cut to one (dense, MoE) block (prefill_32k, decode_32k), each with its
   wall ms, peak MiB, model TFLOP/s of the share and its launch counters set
   to 0 before and read after (this path runs none of the three kernels);
   (b) one MoE layer at olmoe's widths (256 tokens): the einsum and sort
   dispatches equal on the card at a capacity factor that drops nothing, in
   float32 and bfloat16, and at the config's capacity factor, which drops,
   each equal to itself on this machine's CPU, dropped pairs included; (c)
   a prefill of 1,024 tokens and one ``decode_step`` against a prefill of
   1,025, all 16 layers at a capacity factor that drops nothing, in float32
   (within 1e-4 relative, no route flipped) and bfloat16 (within 5e-2 when
   no route flipped), the decoded token's routing flips counted; (d) one
   float32 train step at full width, depth 1 (seq 256, batch 2, the
   config's capacity: its dropped pairs counted), card against CPU.

13. the recsys models (``fm``, ``autoint``, ``dcn-v2``, ``mind``) at full
   scale through all four of their cells, each on its whole global batch
   (train_batch 65,536, serve_p99 512, serve_bulk 262,144, retrieval_cand 1
   x 1,000,000 candidates): wall ms, peak MiB, model TFLOP/s, launch
   counters; and one float32 train step of each at its reduced config,
   card against CPU.

14. the GNN family and the cost counters, in the child process of phases
   12, 13 and 15, after them: (a) ``run_cell`` on all four ``gat-cora`` cells at
   full shape, each graph whole (``full_graph_sm`` Cora's 2,708 nodes;
   ``minibatch_lg`` the 169,984-node sampled budget at 602 features;
   ``ogb_products`` 2,449,029 nodes, 61,859,140 edges, 100 features, 47
   classes; ``molecule`` 128 graphs of 30 nodes), each with its wall ms,
   first-call seconds (the call the cost counter runs), peak MiB, model
   TFLOP/s, the layer-2 aggregate's edge chunks, the record's
   ``flops_per_device``, ``hbm_bytes_per_device`` and collective fields,
   and its launch counters set to 0 before and read after (this path runs
   none of the three kernels), and a ``torch.profiler`` breakdown of one
   ``ogb_products`` step; (b) one float32 train step of each reduced
   cell, card against CPU; (c) the chunked aggregate against the unchunked
   form at ogbn-products' node count and widths on ``AGG_EDGES`` edges,
   values and both gradients, with each form's time and peak memory; (d)
   ``python -m repro_torch.launch.train --arch gat-cora --steps 2`` in a
   fresh process; (e) for a reduced cell of each family (``paper_search``
   ``serve_online`` through the cover kernel, tinyllama's ``train_4k``,
   ``fm``'s ``train_batch``, ``gat-cora``'s ``molecule``), the cost counted
   on the card equal to the cost counted on the CPU, flops and bytes, op
   by op where they differ.

15. the multi-device half, in the child process of phases 12-14, before
   them (beside phases 7 and 8): a world of one rank over NCCL (``make_device_mesh`` over a
   one-rank process group) runs ``serve_online`` and tinyllama's cut
   train_4k and prefill_32k bit for bit as the port without a mesh; then
   ``python -m torch.distributed.run --nproc-per-node 2 chip_smoke.py
   --world-worker`` starts a world of two over gloo on the card (NCCL
   refuses two ranks of one communicator on one device), each rank
   running (a) ``run_cell`` on ``serve_online`` and ``serve_bulk`` at NS
   256 under ``--mesh 1x2`` — 128 shards a rank, one cover launch a rank a
   call, the lists all-gathered; ``top_docs`` and ``n_fragments`` equal
   the one-program fold's, ``top_scores`` within rtol 1e-5 — with its wall
   ms, all-gather bytes and peak MiB; (b) tinyllama at full width, 2
   layers, train_4k (4 rows; bfloat16 and float32) and prefill_32k (2 rows)
   under 1x2 (tensor parallelism) and 2x1 with FSDP, against the unsharded run
   on the same inputs (bfloat16 within 2e-2 relative, float32 metrics
   within 1e-4 and params within 1e-5 relative), with wall ms, peak MiB
   and the counted collectives; (c) one olmoe MoE layer at full width (64
   experts, top 8, 4,096 tokens), ``local`` over model = 2 against
   ``_moe_sort`` with no drops (float32 within 1e-5, bfloat16 2e-2), and
   at the config's capacity its dropped pairs equal to the same world's on
   the CPU; (d) ``compressed_grad_allreduce`` over ``pod`` = 2 on
   tinyllama's 2-layer gradient tree, card equal to the CPU; (e) tinyllama
   at full width and all 22 layers, decode_32k (4 rows on 32,768) and
   long_500k[swa] (1 row on 524,288, window 4,096) context-parallel: each
   rank holds half of every layer's cache; at cache_len 0, mid-slice, the
   last row of rank 0's slice, the first of rank 1's, windows across the
   262,144 boundary and S - 1, each rank's logits, the written row (from
   the rank that holds it) and the rest of its slice (bit for bit) against
   the unsharded ``decode_step`` on the same rank, bfloat16 within 2e-2,
   with wall ms, peak MiB and collective bytes a rank; and the trainer's
   and the dry-run's own command lines under ``--mesh 1x2`` (the dry-run's
   on ``serve_online`` and on decode_32k at full size); (f) beside those
   command lines, a world of three (1x3) in which nothing of tinyllama
   splits over ``model`` (32 heads, 2,048 ``wq`` columns, 32,000 entries
   and 32,768 positions do not divide 3): decode_32k at all 22 layers, as
   (e), and one train_4k step at 2 layers, 4 rows, against the unsharded
   run on each rank; beside them the trainer's command line under ``--mesh
   1x2`` for ``fm`` (its table row-sharded) and ``gat-cora`` (its edges
   split), reduced, every loss finite.  Then (g) and (h): each cell of
   FAMILY_RECSYS and FAMILY_GNN unsharded on the card first, its new params
   and metrics (or scores) kept on the host, then ``chip_smoke.py
   --family-worker`` in a second world of two: (g) fm and autoint
   train_batch and retrieval_cand under 1x2 (row-sharded tables), dcn-v2
   train_batch under 1x2 (column-split MLP, the table whole) and mind
   train_batch under 2x1 (the global batch's negatives; 3/4 of its batch,
   FAMILY_CUTS), at full width and vocabulary; (h) ``gat-cora``'s full_graph_sm, minibatch_lg and
   molecule under 1x2 and 2x1 and ogb_products under 1x2 (edges split),
   cut to 3/4 of its nodes and edges (FAMILY_CUTS); each rank's loss and accuracy within rtol 1e-4 / atol 1e-5 of
   the unsharded step's, its slice of the new params within rtol 1e-3 /
   atol 1e-6, or its scores within rtol 1e-4 / atol 1e-5, with wall ms,
   peak MiB and collective bytes a rank and the unsharded ms.  Every rank's
   kernel launches go into the kernels line by path (none on the recsys
   and GNN paths).

16. the multi-device half over NCCL, one rank on each of four cards (ranks
   that share a card run gloo, as in phase 15; here none does): each card's
   ``nvidia-smi`` name and power limit, ``nvidia-smi topo -m`` and NCCL's
   version; every cell's unsharded step first, on card 0, its outputs kept
   on the host; then ``python -m torch.distributed.run --nproc-per-node 4
   chip_smoke.py --quad-worker`` starts a world of four over NCCL (each
   rank names its ``torch.cuda.current_device()``: four distinct cards
   required), running (a) ``serve_online`` and ``serve_bulk`` under 1x4
   and 2x2 (64 shards and one cover launch a rank a call, the lists
   all-gathered) with every integer equal to the one-program fold, and
   ``device_topk_merge`` over the four ranks equal to one card's merge;
   (b) tinyllama's train_4k and prefill_32k at 4 of 22 layers under 4x1,
   4x1 with FSDP, 2x2 and 1x4, each rank at one production data rank's
   share (16 x 4,096 and 2 x 32,768: ``world_lm_spec`` with the global
   batch scaled by the world's data size), held to the unsharded step on
   the world's batch within 2e-2; (c) decode_32k and long_500k[swa]
   context-parallel over 1x4 at all 22 layers, as 15e at QUAD_DECODE's
   cache lengths (the four slices' boundaries), the float32 holds and
   witness at 22 layers for both; (d) one olmoe MoE layer's ``local``
   dispatch over model = 4 (16 of 64 experts a rank) against ``_moe_sort``,
   its drops equal to one card's sort dispatch, and
   ``compressed_grad_allreduce`` over pod = 4 against the plain sum of
   every rank's int8 values and scales; (e) fm and autoint (1x4, their
   998,960-row tables a quarter a rank), dcn-v2 (1x4) and mind (4x1, its
   whole 65,536-row batch) and (f) ``gat-cora``'s four cells under 1x4 and
   2x2, ogb_products whole, each held as 15g-h hold theirs.  Per rank: wall
   ms, peak MiB, the counted collective bytes, and the largest collective's
   time and bus bandwidth in the call and replayed alone, against NVLink's
   450 GB/s, beside phase 15's gloo figure for the cell.  Then the
   trainer's command line in a world of four (``--mesh 2x2``, its default
   backend, a checkpoint at its last step), resumed in a world of one over
   NCCL: the next step's loss equal to an unsharded run's within 2e-2.

It exits non-zero on the first failure (no phase catches its own), and when
no CUDA device is present.  The line before the last is a JSON object with
one entry per kernel; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import gc
import hashlib
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
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
# the smallest power-of-two arena budget that keeps every shard's triples at
# that size (phase 7 checks it is the smallest)
SHARDED_ARENA_BUDGET = 2048 << 20
SCORE_RTOL = 1e-5  # float32 scores summed in another order on each path

# phase 8's warm start, run in a fresh process as the launcher's next boot
# would: torch and the port only (jax and the reference package blocked)
WARM_START = """
import hashlib, json, sys, time
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.kernels.proximity import proximity_window
from repro_torch.search import SearchRequest, ServingFrontend
t0 = time.perf_counter()
fe = ServingFrontend.from_snapshot(sys.argv[2], use_kernel=True, device="cuda", max_batch=16)
restore_s = time.perf_counter() - t0
requests = [SearchRequest(q, top_k=int(sys.argv[4])) for q in json.loads(sys.argv[3])]
proximity_window.launches = 0
t0 = time.perf_counter()
resps = fe.search_many(requests)
torch.cuda.synchronize()
slate_ms = (time.perf_counter() - t0) * 1e3
digests = [hashlib.sha256(json.dumps(sorted((d.doc_id, f.start, f.end) for d in r.docs
                                            for f in d.fragments)).encode()).hexdigest()[:16]
           for r in resps]
print(json.dumps({"restore_s": restore_s, "slate_ms": slate_ms, "digests": digests,
                  "replayed": sum(ix.last_wal_replay["records"] for ix in fe._source.indexers),
                  "cover_launches": proximity_window.launches}))
"""

# phase 9: the fault schedule's seed (the reference chaos harness's first;
# at 4 shards its kill of shard 0 comes at the 9th probe and it corrupts no
# snapshot, so recovery finds an intact one), the rounds served under it,
# and the corpus of the launcher's own bulk-ingested cold start: at 4,096
# documents its cold and warm starts outlast the rest of phase 9 (162 s of
# phase 9 on an H100 80GB HBM3 at 700 W), so they ran at half that; since
# phase 11 joined the run (893.5 s of command time on the same card), at a
# quarter
CHAOS_SEED = 101
CHAOS_ROUNDS = 10
CLI_DOCS = 1024

# phases 9c and 10: ``python -m <module> <args>`` in a fresh process, with
# jax and the reference package blocked as in WARM_START
RUN_MODULE = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
runpy.run_module(sys.argv.pop(1), run_name="__main__", alter_sys=True)
"""
# 9c's client, as RUN_MODULE, with the seconds of its imports and of each
# request it sends (``request_over_tcp``) on its standard error: the split
# of its wall
RUN_CLIENT_TIMED = """
import runpy, sys, time
t0 = time.perf_counter()
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.search import service
print(f"[client] import {time.perf_counter() - t0:.3f}", file=sys.stderr, flush=True)
send = service.request_over_tcp
def timed(address, payload, *args, **kwargs):
    t = time.perf_counter()
    try:
        return send(address, payload, *args, **kwargs)
    finally:
        print(f"[client] {payload.get('op', 'query')} {time.perf_counter() - t:.3f}", file=sys.stderr, flush=True)
service.request_over_tcp = timed
runpy.run_module(sys.argv.pop(1), run_name="__main__", alter_sys=True)
"""

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the float32 rate outside
# the tensor cores (an FMA counted as two operations).  The data sheet lists
# no rate for 32-bit integer compares and adds, which run slower than this,
# so timing them at this rate keeps the bound a lower bound.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


class QuietGate:
    """Keeps phase 9c's kill-and-failover step and the card child's work
    apart.  The main process ``hold``s the gate around the step (a file
    under ``root``); the child, at each of its phase lines, waits while the
    gate is held (``checkpoint``), and says it waits (a second file)."""

    def __init__(self, root: Path):
        self.held, self.paused = Path(root) / "gate_held", Path(root) / "gate_paused"

    def hold(self, child, timeout: float) -> tuple[str, float]:
        """Hold the gate; wait until the child waits at it or has ended (at
        most ``timeout`` s): what it does then, and the seconds waited."""
        t = time.perf_counter()
        self.held.touch()
        while not self.paused.exists() and child.poll() is None and time.perf_counter() - t < timeout:
            time.sleep(0.2)
        state = "waiting" if self.paused.exists() else "ended" if child.poll() is not None else "running"
        return state, time.perf_counter() - t

    def release(self) -> None:
        self.held.unlink(missing_ok=True)

    def checkpoint(self, timeout: float = 600) -> float:
        """In the child: wait while the gate is held; the seconds waited."""
        if not self.held.exists():
            return 0.0
        t = time.perf_counter()
        self.paused.touch()
        try:
            while self.held.exists() and time.perf_counter() - t < timeout:
                time.sleep(0.2)
        finally:
            self.paused.unlink(missing_ok=True)
        return time.perf_counter() - t


# the card child's gate (set in that process only: ``CARD_CHILD``)
CHILD_GATE: QuietGate | None = None


def phase(name: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"[phase] {name}: {now - t0:.3f} s", flush=True)
    if CHILD_GATE is not None:
        waited = CHILD_GATE.checkpoint()
        if waited:
            print(f"[gate] the card child waited {waited:.1f} s for phase 9c's kill-and-failover step", flush=True)
            now = time.perf_counter()
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


# phase 10: the paper_search dry-run cells (``repro_torch.launch.dryrun``)
# at the reference's single-pod layout (256 cluster shards folded into one
# program), the build step over a corpus of the build_chunk cell's shape,
# and one check on real postings (the slate's subqueries over phase 3's
# index, clusters == documents).  The real-data window is the packer's
# 256-position hint, raised to a multiple of 128 that holds every position
# (phase 3's documents run past 256 positions).
BUILD_DOCS, BUILD_DOC_LEN = 4096, 1024
REAL_DATA_WINDOW = 256
REAL_DATA_TOP_K = 16
DRYRUN_OUT = ROOT / "artifacts" / "chip_smoke_dryrun"

# phase 11: the dense LM path at tinyllama-1.1b's full width; the cells at
# one data rank's share (256 / 16 sequences for train_4k), train and prefill
# timed once after their first call.  Since phases 12 and 13 joined the run,
# train_4k (and its profiled step) and prefill_32k run at 4 of the 22 layers:
# at full depth they took 3 x 12.0 s and 2 x 16.2 s of the run (NVIDIA H100
# 80GB HBM3, 700 W); the trainer CLI (e) still trains all 22 layers, and (c)
# still decodes through all of them
LM_ARCH = "tinyllama-1.1b"
LM_CELLS = ("train_4k", "prefill_32k", "decode_32k", "long_500k[swa]", "long_500k")
LM_CELL_LAYERS = {"train_4k": 4, "prefill_32k": 4}
LM_BF16_REL = 2e-2  # bfloat16 products rounded before the float32 softmax
# (c) over all 22 layers: float32 (TF32 off) is the exact check; in bfloat16
# the two paths round each layer's products apart (a decode's one-row
# matmuls against the prefill's rows), and the residual stream carries the
# difference through 22 layers: 1.70e-2 and 1.75e-2 in two runs (NVIDIA H100
# 80GB HBM3), where the 2-layer CPU tests hold 2e-2
LM_F32_REL = 1e-4
LM_DECODE_BF16_REL = 5e-2
LM_PREFILL = 1024  # (c): prefill S tokens, decode one, against a prefill of S + 1
LM_CLI_STEPS = 6
# (d) and (f): depth cut to 2 layers; (d) at seq 256, batch 2 (the CPU runs
# it too), (f) on train_4k's sequence at batch 2 in 2 microbatches
LM_CUT_LAYERS = 2
LM_CKPT_BATCH = 2

# (f): one trainer process: ``first`` runs 2 steps, saves them with
# CheckpointManager.save_async and runs 2 more; ``resume`` restores the
# step-2 checkpoint and its pipeline state and runs 2 steps.  Each prints
# the sha256 of its final params and optimizer state, leaf by leaf in tree
# order.  Deterministic algorithms in both.
LM_RESUME = """
import dataclasses, hashlib, os, sys, time
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, sys.argv[1])
import torch
torch.use_deterministic_algorithms(True)
from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
from repro_torch.configs import get_spec
from repro_torch.tree import tree_leaves
from repro_torch.data.pipeline import LMTokenPipeline, PipelineState
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.models import transformer
from repro_torch.optim import adamw_init
mode, arch, n_layers, batch, ckpt = sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5]), sys.argv[6]
spec = get_spec(arch)
spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(spec.model_cfg, n_layers=n_layers))
cell = build_cell(spec, "train_4k", make_production_mesh())
cfg = spec.model_cfg
params = transformer.init_params(0, cfg, device="cuda")
opt = adamw_init(params)
pipe = LMTokenPipeline(cfg.vocab, spec.shapes["train_4k"].kwargs["seq_len"], batch, seed=0)
if mode == "resume":
    t = time.perf_counter()
    state, step = restore_checkpoint(ckpt, {"params": params, "opt": opt, "pipe": pipe.state.as_tree()}, device="cuda")
    torch.cuda.synchronize()
    print(f"restore_checkpoint {time.perf_counter() - t:.2f} s", flush=True)
    assert step == 2, step
    params, opt = state["params"], state["opt"]
    pipe.state = PipelineState.from_tree(state["pipe"])
mgr = CheckpointManager(ckpt)
for i in range(2 if mode == "resume" else 4):
    batch_t = {k: torch.from_numpy(v).cuda() for k, v in pipe.next_batch().items()}
    params, opt, m = cell.fn(params, opt, batch_t)
    print(mode, "step", int(opt["step"]), {k: float(v) for k, v in m.items()}, flush=True)
    if mode == "first" and i == 1:
        t = time.perf_counter()
        mgr.save_async(2, {"params": params, "opt": opt, "pipe": pipe.state.as_tree()})
        print(f"save_async returned in {time.perf_counter() - t:.2f} s (the host copy)", flush=True)
t = time.perf_counter()
mgr.wait()
if mode == "first":
    print(f"wait for the write {time.perf_counter() - t:.2f} s after the last step", flush=True)
digest = hashlib.sha256()
for leaf in tree_leaves({"params": params, "opt": opt}):
    digest.update(leaf.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
print("digest", int(opt["step"]), len(tree_leaves({"params": params, "opt": opt})), digest.hexdigest())
"""


# phase 12: the MoE LM family.  olmoe-1b-7b at full width (6.92e9 params,
# 13.8 GB in bfloat16; 16 layers of 64 experts, top 8) at one data rank's
# share of each cell, cut in depth: prefill_32k at 8 of 16 layers (at all 16
# it took 23 s of the card child's run, first call and one timed, on an
# NVIDIA H100 80GB HBM3 at 700 W, when phase 15's worlds grew); the others to
# fit one card:
#  - train_4k: params, the float32 master, m and v, the gradient accumulator
#    and the update's new state come to about 37.6 B a parameter when the
#    update runs: 4 layers (1.88e9 params) about 71 GB, 5 about 87 GB;
#  - decode_32k (8 x 32,768) and long_500k[swa] (1 x 524,288): the cache is
#    4.3 GB a layer, and the step returns a new one beside it: 6 layers.
# llama4-maverick-400b-a17b at full width, cut to one (dense, MoE) block: 2
# of its 48 layers, 128 experts of top 1, 1.84e10 params, 36.9 GB in
# bfloat16; prefill_32k and decode_32k.
MOE_ARCH = "olmoe-1b-7b"
MOE_CELL_LAYERS = {"train_4k": 4, "prefill_32k": 8, "decode_32k": 6, "long_500k[swa]": 6, "long_500k": 16}
MAVERICK_ARCH = "llama4-maverick-400b-a17b"
MAVERICK_CELL_LAYERS = {"prefill_32k": 2, "decode_32k": 2}
MOE_NO_DROP = 8.0  # (b) and (c): a capacity factor at which no expert overflows
MOE_CHECK_TOKENS = 256  # (b): einsum's [T, E, C] tensors at olmoe's widths, float32
MOE_PREFILL = 1024  # (c): prefill S tokens, decode one, against a prefill of S + 1
# phase 13: the four recsys models at full scale, each cell on its whole
# global batch (MIND's loss takes its negatives from the whole batch)
RECSYS_ARCHS = ("fm", "autoint", "dcn-v2", "mind")
# phase 14: the GNN family (gat-cora) at full shape, every cell whole on one
# card: ogb_products is 2,449,029 nodes and 61,859,140 edges, where the
# reference shards the nodes over its mesh
GNN_ARCH = "gat-cora"
# (c): the chunked aggregate against the unchunked form at ogbn-products'
# node count, heads and classes, on as many edges as the unchunked form's
# [E, 8, 47] float32 tensors leave room for (6.0 GB each)
AGG_EDGES = 4_000_000
# (e): a reduced cell of each family, its cost counted on the card and on
# this machine's CPU
COST_CELLS = (("paper_search", "serve_online"), ("tinyllama-1.1b", "train_4k"), ("fm", "train_batch"),
              ("gat-cora", "molecule"))
# phases 15, 12, 13 and 14 run in one child process (torch and the port
# only); beside phases 7, 8 and 9 its CPU work (the CPU halves of 12d, 13,
# 14b and 14e, the gloo worlds of 15) keeps to a few threads at a lower CPU
# priority (CHILD_NICE), and it waits at its next phase line while phase 9c
# kills the daemon's primary: the launcher client waits for the successor's
# first answer (its cold arena acquire, host-bound) within the launcher's
# 60 s socket timeout, and the child's load had pushed that answer past it
# (52-68 s of client wall where it passed; NVIDIA H100 80GB HBM3 machine, 8
# host cores)
CARD_CHILD = """
import json, os, sys
os.nice(int(sys.argv[4]))
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.CHILD_GATE = chip_smoke.QuietGate(sys.argv[5])
out = chip_smoke.new_families([int(p) for p in sys.argv[2].split(",")], int(sys.argv[3]))
print("card child: " + json.dumps(out), flush=True)
"""
CHILD_THREADS = 4
CHILD_NICE = 10
SEARCH_PHASES = set(range(3, 11))
CHILD_PHASES = (12, 13, 14, 15)
ALL_PHASES = set(range(1, 16))  # the default run: one card
KNOWN_PHASES = ALL_PHASES | {16}  # 16 only when asked for: four cards
# phase 15: the multi-device half in worlds of ranks on the one card.  NCCL
# refuses two ranks of one communicator on one device ("Duplicate GPU
# detected"), so worlds of two and three run gloo on the card's tensors; a
# world of one runs NCCL.  tinyllama at full width, depth cut to 2 layers and each
# cell's world batch to WORLD_LM_ROWS rows (train_4k at 4,096 tokens,
# prefill_32k at 32,768), so that two ranks and the unsharded run fit the card
# together; prefill_32k at 2 rows since phase 15 grew (at 4 its six runs took
# 32 s of the card child's run; NVIDIA H100 80GB HBM3, 700 W)
WORLD_BACKEND = "gloo"
WORLD_SERVE = ("serve_online", "serve_bulk")
WORLD_LM_CELLS = ("train_4k", "prefill_32k")
WORLD_LM_LAYERS = 2
WORLD_LM_ROWS = {"train_4k": 4, "prefill_32k": 2}
WORLD_MOE_TOKENS = 4096  # (c): one olmoe MoE layer's tokens
WORLD_COMPRESS_LAYERS = 2  # (d): tinyllama's gradient tree at this depth
# (e): tinyllama's decode cells at full width and depth (22 layers) in the
# world of two, context-parallel (each rank holds half of every layer's
# cache: 1.47 GB of decode_32k's 2.95, 5.9 of long_500k[swa]'s 11.8), held
# at these cache_len values: 0, mid-slice, the last row of rank 0's slice,
# the first of rank 1's, windows across the 262,144 boundary, and S - 1
WORLD_DECODE = {"decode_32k": (4, (0, 8192, 16383, 16384, 32767)),
                "long_500k[swa]": (1, (0, 262143, 262144, 264191, 524287))}
# the holds of (e), each (dtype, layers, bound on the relative error): float32
# (TF32 off) is the exact check, at all 22 layers for decode_32k and at 4
# for long_500k[swa] (its float32 cache is 23.6 GB at 22, and the unsharded
# step on each rank needs it twice); bfloat16 within the usual 2e-2 at 2
# layers, and at all 22 within phase 11c's bound for two bfloat16 paths
# through 22 layers (LM_DECODE_BF16_REL): the sharded step rounds its
# row-split sums and its merged attention per rank, and 22 bfloat16 layers
# carry those roundings apart as they carry 11c's decode from its prefill.
# Where the float32 step fits beside it (WORLD_DECODE_EXACT), the witness
# for that cause: both bfloat16 steps against the float32 step on the same
# (bfloat16) weights and cache, the sharded one no farther from it than the
# unsharded one plus LM_BF16_REL
WORLD_DECODE_HOLDS = {"decode_32k": (("float32", 22, 1e-4), ("bfloat16", 2, 2e-2), ("bfloat16", 22, 5e-2)),
                      "long_500k[swa]": (("float32", 4, 1e-4), ("bfloat16", 2, 2e-2), ("bfloat16", 22, 5e-2))}
WORLD_DECODE_EXACT = {("decode_32k", "bfloat16", 22)}
# (f): a world of three (1x3): nothing of tinyllama divides 3 (32 heads,
# 2,048 wq columns, a 5,632-wide FFN, 32,000 entries, 32,768 positions), so
# every rank runs the whole model: decode_32k at full depth and a train_4k
# step at WORLD_LM_LAYERS layers, WORLD_LM_ROWS["train_4k"] rows
WORLD3_DECODE = ("decode_32k", 4, (0, 16384, 32767))


# (g) and (h): the recsys and GNN cells at full width and size in a world of
# two (gloo on the card), each against the unsharded step on the same
# inputs: that step runs first, in the card child, and keeps its outputs on
# the host (mind's train_batch alone peaks at 55.3 GB, so it cannot sit
# beside two ranks); then ``--family-worker``'s world.  fm and autoint
# row-shard their tables over model (1x2); dcn-v2's 33,762,577 rows and
# mind's 3,706,119 divide no model axis, so their tables stay whole: dcn-v2
# splits its MLP columns (1x2), mind splits its batch and gathers its
# negatives (2x1).  The GNN cells split their edges over both meshes;
# ogb_products (2,449,029 nodes: odd, so its nodes stay whole) runs under
# 1x2 only, its one call a rank the counted first call (about 9 GB of gloo
# traffic a rank: msg [N, 8, 47] alone is 3.68 GB).  Two cuts of scale
# (FAMILY_CUTS) let the pair sit beside phases 7 and 8 and their launcher
# processes: ogb_products at 3/4 of its nodes and edges (at full shape
# each rank peaked at 35.0 GB alone, leaving under 9 GB of the card's 79.2
# for everything else), and mind at 3/4 of its batch (at 65,536 rows a
# rank's [32,768, 65,536] logits and their gradient took it past 37 GB,
# and the pair ran out of the card beside phases 7 and 8; NVIDIA H100 80GB
# HBM3, 700 W)
FAMILY_RECSYS = (("fm", "train_batch", (1, 2)), ("fm", "retrieval_cand", (1, 2)),
                 ("autoint", "train_batch", (1, 2)), ("autoint", "retrieval_cand", (1, 2)),
                 ("dcn-v2", "train_batch", (1, 2)), ("mind", "train_batch", (2, 1)))
FAMILY_GNN = tuple(("gat-cora", shape, mesh) for shape in ("full_graph_sm", "minibatch_lg", "molecule")
                   for mesh in ((1, 2), (2, 1))) + (("gat-cora", "ogb_products", (1, 2)),)
FAMILY_ONE_CALL = {("gat-cora", "ogb_products")}
FAMILY_CUTS = {("gat-cora", "ogb_products"): {"n_nodes": 1_836_772, "n_edges": 46_394_356},  # the edges even
               ("mind", "train_batch"): {"batch": 49_152}}
# the float32 holds: forward (loss, accuracy, scores), and the params after
# one AdamW step, each |got - want| <= atol + rtol |want|
FAMILY_FWD = {"rtol": 1e-4, "atol": 1e-5}
FAMILY_STEP = {"rtol": 1e-3, "atol": 1e-6}

# phase 16 (``--phases 16`` only: it needs four cards): the multi-device half
# over NCCL in a world of four ranks, one on each card, each card's own
# memory, so nothing is cut to let two ranks share one card.  The LM cells
# run one production data rank's share a rank (train_4k 16 x 4,096,
# prefill_32k 2 x 32,768: the world's batch is the share times the world's
# data size) at phase 11's 4 of 22 layers, the unsharded step on the world's
# batch in microbatches of the ranks' size (8 rows); decode at all 22 layers
# with the float32 holds and witness at 22 for both cells (a rank's
# long_500k[swa] float32 step, its whole cache and the unsharded step's copy
# of it take about 63 GB of the card); the recsys and GNN cells at full size
# (mind's 65,536 rows, ogb_products whole).
QUAD = 4
QUAD_BACKEND = "nccl"
QUAD_DEVICE = "cuda"
QUAD_TIMEOUT_S = 300  # the world's process group: how long a rank waits for a peer that failed
QUAD_SERVE_MESHES = ((1, 4), (2, 2))
QUAD_MERGE = (16, TOP_K)  # device_topk_merge: 16 per-shard top-10 lists, 4 a rank
QUAD_LM_MESHES = (((4, 1), False), ((4, 1), True), ((2, 2), False), ((1, 4), False))
QUAD_LM_SHARE = {"train_4k": 16, "prefill_32k": 2}  # global_batch / 16 data ranks: 256 / 16, 32 / 16
# (16c) the four slices of 1x4: 0, mid-slice, the last row of rank 0's slice,
# the first of ranks 1, 2 and 3, a window across the first boundary, S - 1
QUAD_DECODE = {"decode_32k": (4, (0, 4096, 8191, 8192, 16384, 24576, 32767)),
               "long_500k[swa]": (1, (0, 131071, 131072, 133119, 262144, 393216, 524287))}
QUAD_DECODE_HOLDS = {shape: (("float32", 22, 1e-4), ("bfloat16", 2, 2e-2), ("bfloat16", 22, 5e-2))
                     for shape in QUAD_DECODE}
QUAD_DECODE_EXACT = {(shape, "bfloat16", 22) for shape in QUAD_DECODE}
QUAD_RECSYS = (("fm", "train_batch", (1, 4)), ("fm", "retrieval_cand", (1, 4)),
               ("autoint", "train_batch", (1, 4)), ("autoint", "retrieval_cand", (1, 4)),
               ("dcn-v2", "train_batch", (1, 4)), ("mind", "train_batch", (4, 1)))
QUAD_GNN = tuple(("gat-cora", shape, mesh) for shape in ("full_graph_sm", "minibatch_lg", "molecule", "ogb_products")
                 for mesh in ((1, 4), (2, 2)))
QUAD_CLI_MESH, QUAD_CLI_STEPS = "2x2", 2  # 16b: the trainer's command line, checkpointing its last step
NVLINK_GB_S = 450.0  # an H100 SXM's NVLink, each way
# phase 15's figures for the same cells (gloo, two ranks on one card; PERF.md
# §5, on an NVIDIA H100 80GB HBM3 at 700 W), printed beside phase 16's
PHASE15_GLOO = {
    "serve_online": "1x2: 3.8-13.4 ms a rank", "serve_bulk": "1x2: 15.4-25.7 ms a rank",
    "train_4k": "1x2, 2 layers, 4 rows: 1,111.9-1,254.6 ms; 2x1 FSDP 2,299.2-2,780.0 ms",
    "prefill_32k": "1x2, 2 layers: 5,772.9-6,978.7 ms; 2x1 FSDP 3,649.7-3,739.5 ms",
    "decode_32k": "1x2, 22 layers, 4 rows: 277.5-411.6 ms", "long_500k[swa]": "1x2, 22 layers: 285.3-509.6 ms",
    "compress": "pod = 2: 782.2-1,141.0 ms",
    "fm train_batch": "1x2: 479.8-532.2 ms", "fm retrieval_cand": "1x2: 1,938.9-2,586.9 ms",
    "autoint train_batch": "1x2: 411.6-535.8 ms", "autoint retrieval_cand": "1x2: 4,050.6-5,867.4 ms",
    "dcn-v2 train_batch": "1x2: 1,689.5-2,331.6 ms", "mind train_batch": "2x1: 2,040.0-2,040.1 ms (65,536 rows)",
    "gat-cora full_graph_sm": "1x2: 38.9-60.0 ms", "gat-cora minibatch_lg": "1x2: 659.4-837.9 ms; 2x1 607.1-942.7 ms",
    "gat-cora molecule": "2x1: 28.0-38.0 ms", "gat-cora ogb_products": "1x2: 15,011-15,097 ms (whole)"}


def topk_agree(label: str, docs, scores, want_docs, want_scores) -> None:
    """A top-k list against a longer reference ranking: scores within rtol
    of the reference's first k; documents equal, as sets inside runs of
    scores equal within that tolerance (sums taken in another order may swap
    them), and a run cut by k drawn from the reference's whole run."""
    import numpy as np

    docs, scores = [int(x) for x in docs], np.asarray(scores, np.float64)
    want_docs, want_scores = [int(x) for x in want_docs], np.asarray(want_scores, np.float64)
    k = len(docs)
    require(len(want_docs) >= k and np.allclose(scores, want_scores[:k], rtol=SCORE_RTOL, atol=0),
            f"{label}: scores {scores.tolist()} != {want_scores[:k].tolist()}")
    i = 0
    while i < k:
        j = i + 1
        while j < len(want_scores) and np.isclose(want_scores[j], want_scores[i], rtol=SCORE_RTOL, atol=0):
            j += 1
        got, want = set(docs[i:min(j, k)]), set(want_docs[i:j])
        require(got == want if j <= k else got <= want, f"{label}: documents {docs} != {want_docs[:k]}")
        i = j


def numpy_build_count(toks, stop, d: int, n_buckets: int):
    """The build step's histogram and total in numpy's own uint32
    arithmetic: an independent count of every (f,s,t) triple posting."""
    import numpy as np

    b, n = toks.shape
    t = np.zeros((b, n + 2 * d), np.uint32)
    s = np.zeros((b, n + 2 * d), bool)
    t[:, d:d + n], s[:, d:d + n] = toks.astype(np.uint32), stop
    hist, total = np.zeros(n_buckets, np.int64), 0
    for d1 in range(-d, d + 1):
        for d2 in range(d1 + 1, d + 1):
            if d1 == 0 or d2 == 0:
                continue
            valid = stop & s[:, d + d1:d + d1 + n] & s[:, d + d2:d + d2 + n]
            h = (t[:, d:d + n] * np.uint32(2654435761) ^ t[:, d + d1:d + d1 + n] * np.uint32(40503)
                 ^ t[:, d + d2:d + d2 + n]) % np.uint32(n_buckets)
            hist += np.bincount(h[valid], minlength=n_buckets)
            total += int(valid.sum())
    return hist, total


def build_corpus_tokens():
    """Phase 10b's build corpus on the host: each position's most frequent
    lemma's FL-number over ``synthesize_corpus(n_docs=BUILD_DOCS,
    doc_len=BUILD_DOC_LEN)``, stop lemmas at the smoke's sw_count; (tokens,
    stop mask, seconds)."""
    import numpy as np

    from repro_torch.core.lemma import FLList
    from repro_torch.index import synthesize_corpus

    t_c = time.perf_counter()
    bstore = synthesize_corpus(n_docs=BUILD_DOCS, doc_len=BUILD_DOC_LEN, seed=SEED)
    bfl = FLList.from_frequencies(bstore.lemma_frequencies(), sw_count=SW_COUNT, fu_count=FU_COUNT)
    docs = bstore.documents[-BUILD_DOCS:]
    require(min(len(x) for x in docs) >= BUILD_DOC_LEN, "a build document is shorter than the cell")
    toks = np.array([[min(bfl.fl_number[x] for x in lemmas) for lemmas in doc.lemma_stream[:BUILD_DOC_LEN]]
                     for doc in docs], np.int32)
    return toks, toks < SW_COUNT, time.perf_counter() - t_c


def paper_search_early(procs: list):
    """Phase 10b's host-bound parts, started while the card child finishes
    phases 12-15: the dry-run CLI over the four cells in a fresh process
    (jax and the reference package blocked) and the build corpus on a
    thread."""
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    cli = subprocess.Popen(
        [sys.executable, "-c", RUN_MODULE, "repro_torch.launch.dryrun", "--arch", "paper_search", "--all", "--out", str(DRYRUN_OUT)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    procs.append(cli)
    return cli, Background(build_corpus_tokens)


def paper_search_phase(torch, dev, index, subqueries, kernels, zero_counts, read_counts, early) -> None:
    """Phase 10 (see the module docstring); ``early`` is what
    ``paper_search_early`` started."""
    import numpy as np

    from repro_torch.configs import get_spec
    from repro_torch.core.combiner import se24_combiner
    from repro_torch.kernels.proximity import proximity_window
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.search import pack_subquery_events, rank_documents
    from repro_torch.search import serving_step as ss

    t10 = time.perf_counter()
    spec = get_spec("paper_search")
    cfg = spec.model_cfg
    layout = make_production_mesh()
    d, n, l = cfg.max_distance, cfg.window_len, cfg.n_lemmas
    cells, serve_online = {}, None
    for shape in spec.shapes:
        cell = build_cell(spec, shape, layout)
        zero_counts()
        rec = dryrun.run_cell("paper_search", shape, False, device=dev)
        counts = read_counts(f"dry-run {shape}")
        require(rec["status"] == "ok", f"dry-run {shape}: {rec.get('error')}\n{rec.get('traceback')}")
        # one cover launch per serve call (a run's first call and its timed repeats)
        want = {"proximity_window": rec["calls"] if cell.step == "serve" else 0,
                "intersect_sorted": 0, "gather_blocks": 0}
        require(counts == want, f"dry-run {shape} launched {counts}, not {want}")
        print(f"dry-run {shape} ({rec['mesh']}, NS {rec['n_devices']}, {rec['device_name']}): inputs "
              f"{rec['input_shapes']}, wall {[round(x, 4) for x in rec['wall_ms']]} ms, peak "
              f"{rec['peak_bytes'] / 2**20:.1f} MiB, first call {rec['first_call_s']:.3f} s, {rec['result']}, "
              f"launches {counts}")
        if cell.step != "serve":
            cells[shape] = {"wall_ms": rec["wall_ms"], "peak_mib": rec["peak_bytes"] / 2**20}
            continue
        post, cd, mult = dryrun.cell_inputs(cell, cfg, device=dev)  # run_cell's inputs
        ns, b, p_loc, _ = post.shape
        c_loc = cd.shape[2]
        kw = dict(max_distance=d, n_clusters=c_loc, window_len=n, top_k=cfg.top_k)
        before = proximity_window.launches
        got = ss.serve_step_sharded(post, cd, mult, **kw)
        torch.cuda.synchronize()
        require(proximity_window.launches == before + 1, f"{shape}: not one cover launch per call")
        plain = ss.serve_step_sharded_plain(post, cd, mult, **kw)
        torch.cuda.synchronize()
        require(proximity_window.launches == before + 1, f"{shape}: the plain path launched the kernel")
        n_frag = int(got["n_fragments"].sum())
        require(torch.equal(got["n_fragments"], plain["n_fragments"]) and n_frag > 0,
                f"{shape}: n_fragments of the kernel path != the plain path's (or 0)")
        require(torch.equal(got["top_docs"], plain["top_docs"]), f"{shape}: top_docs != the plain path's")
        require(torch.allclose(got["top_scores"], plain["top_scores"], rtol=SCORE_RTOL, atol=0),
                f"{shape}: top_scores != the plain path's")
        if shape == "serve_online":  # held to the CPU below, beside the dry-run process
            serve_online = ((post, cd, mult), kw, {k: v.cpu() for k, v in got.items()})
        # the three stages on the folded batch, each timed alone
        rows = ns * b * c_loc
        post2, cd2 = post.reshape(ns * b, p_loc, 3), cd.reshape(ns * b, c_loc)
        t_s1 = cuda_ms(torch, lambda: ss._stage_scatter(post2, l, c_loc, n, torch.uint8), 5)
        occ = ss._stage_scatter(post2, l, c_loc, n, torch.uint8).view(rows, l, n)
        m2 = mult.repeat(ns, 1).repeat_interleave(c_loc, dim=0).to(torch.uint8)
        t_s2 = cuda_ms(torch, lambda: proximity_window(occ, m2, d, compute_dtype="uint8"), 20)
        emit, start = proximity_window(occ, m2, d, compute_dtype="uint8")
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        p_emit, p_start = ss._cover_plain(occ, m2, d, "uint8")
        ev1.record()
        ev1.synchronize()
        plain_ms = ev0.elapsed_time(ev1)
        require(torch.equal(emit, p_emit) and torch.equal(start, p_start),
                f"{shape}: the cover kernel != its plain version at N = {n}")
        t_s3 = cuda_ms(torch, lambda: ss._stage_score(emit, start, cd2, min(cfg.top_k, c_loc)), 5)
        # the active occupancy rows read once, mult read, emit and start written
        n_active = int((m2 > 0).sum())
        b_ms, b_by = bound_ms(n_active * n + rows * l + rows * n * 5, n_active * n)
        empty_rows = int((occ.amax(dim=(1, 2)) == 0).sum())
        padded = int((cd2 < 0).sum()) * 1.0 / cd2.numel()
        stages = [t_s1[0], t_s2[0], t_s3[0]]
        print(f"  {shape}: R = {rows} rows x {l} x {n}, {n_active} active (row, lemma) pairs, {empty_rows} rows "
              f"all zero, {100 * padded:.1f}% clusters padded, {n_frag} fragments; kernel == plain path and "
              f"cover == plain bit for bit")
        print(f"  {shape} stages: {timing('scatter', t_s1)}, {timing('cover kernel', t_s2)}, "
              f"{timing('score + top-k', t_s3)}; sum {sum(stages):.4f} ms of wall {min(rec['wall_ms']):.4f} ms; "
              f"cover bound {b_ms:.4f} ms ({b_by}), kernel/bound {t_s2[0] / b_ms:.2f}x, plain cover "
              f"{plain_ms:.2f} ms (one call)")
        cells[shape] = {"rows": rows, "ms": t_s2[0], "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "launches": counts["proximity_window"], "stages_ms": stages,
                        "wall_ms": rec["wall_ms"], "peak_mib": rec["peak_bytes"] / 2**20}
        del post, cd, mult, got, plain, occ, m2, emit, start, p_emit, p_start
    t10 = phase("paper_search dry-run cells on the card (10a)", t10)

    # the same four cells through the CLI, started beside the card child
    cli, corpus = early
    try:
        (post, cd, mult), kw, got = serve_online
        # the CPU's whole ranking (its first top_k are its top-k list)
        cpu = ss.serve_step_sharded(post.cpu(), cd.cpu(), mult.cpu(),
                                    **{**kw, "top_k": post.shape[0] * cd.shape[2]})
        require(torch.equal(got["n_fragments"], cpu["n_fragments"]), "serve_online: n_fragments card != cpu")
        require(got["top_docs"].shape[1] == min(kw["top_k"], cpu["top_docs"].shape[1]), "serve_online: top-k width")
        for q in range(got["top_docs"].shape[0]):
            topk_agree(f"serve_online query {q} card vs cpu", got["top_docs"][q], got["top_scores"][q],
                       cpu["top_docs"][q], cpu["top_scores"][q])
        print(f"serve_online on the card == the port's CPU run ({got['top_docs'].shape[0]} queries)")

        # build_chunk's shape over a corpus
        toks, stop, t_c = corpus.result()
        print(f"build corpus: {toks.shape}, {100 * stop.mean():.1f}% stop positions, {t_c:.1f} s (built beside "
              "the card child)")
        tok_d, stop_d = torch.from_numpy(toks).to(dev), torch.from_numpy(stop).to(dev)
        bkw = dict(max_distance=d, n_buckets=cfg.build_buckets)
        card = ss.build_step(tok_d, stop_d, **bkw)
        host = ss.build_step(torch.from_numpy(toks), torch.from_numpy(stop), **bkw)
        ref_hist, ref_total = numpy_build_count(toks, stop, d, cfg.build_buckets)
        require(torch.equal(card["bucket_histogram"].cpu(), host["bucket_histogram"])
                and int(card["n_postings"]) == int(host["n_postings"]), "build_step card != cpu")
        require(np.array_equal(host["bucket_histogram"].numpy(), ref_hist) and int(host["n_postings"]) == ref_total,
                "build_step != the numpy count")
        t_b = cuda_ms(torch, lambda: ss.build_step(tok_d, stop_d, **bkw), 5)
        print(f"build_step over the corpus: {ref_total} triple postings in {int((ref_hist > 0).sum())} buckets; "
              f"card == cpu == numpy bit for bit; {timing('card', t_b)}")
        cells["build_chunk"]["corpus_ms"] = t_b[0]

        # real postings: the slate's subqueries over phase 3's index
        packs = []
        for q in SLATE:
            for sub in subqueries[q]:
                pk = pack_subquery_events(sub, index, doc_len=REAL_DATA_WINDOW, device="cpu")
                if pk is not None:
                    packs.append((q, sub, pk))
        s_n = len(packs)
        p_max = max(len(pk.events) for _, _, pk in packs)
        c_max = max(len(pk.doc_ids) for _, _, pk in packs)
        l_max = max(len(pk.mult) for _, _, pk in packs)
        window = max(REAL_DATA_WINDOW, -(-(int(max(pk.events[:, 1].max() for _, _, pk in packs)) + 1) // 128) * 128)
        post_np = np.full((s_n, p_max, 3), -1, np.int32)
        cd_np = np.full((s_n, c_max), -1, np.int32)
        mult_np = np.zeros((s_n, l_max), np.int32)
        for i, (_, _, pk) in enumerate(packs):
            post_np[i, :len(pk.events)] = pk.events
            cd_np[i, :len(pk.doc_ids)] = pk.doc_ids
            mult_np[i, :len(pk.mult)] = pk.mult
        before = proximity_window.launches
        out = ss.serve_step(*(torch.from_numpy(x).to(dev) for x in (post_np, cd_np, mult_np)),
                            max_distance=index.max_distance, n_clusters=c_max, window_len=window,
                            top_k=REAL_DATA_TOP_K)
        out = {k: v.cpu() for k, v in out.items()}
        require(proximity_window.launches == before + 1, "real data: not one cover launch")
        n_total = 0
        for i, (q, sub, _) in enumerate(packs):
            results, _ = se24_combiner(sub, index)
            require(int(out["n_fragments"][i]) == len(results),
                    f"real data {q!r}: n_fragments {int(out['n_fragments'][i])} != se2.4's {len(results)}")
            ranked = rank_documents(results, top_k=len(results))  # every document with a fragment
            k = min(REAL_DATA_TOP_K, len(ranked))
            topk_agree(f"real data {q!r}", out["top_docs"][i][:k], out["top_scores"][i][:k],
                       [x for x, _, _ in ranked], [s for _, s, _ in ranked])
            require(bool((out["top_scores"][i][k:] <= 0).all()), f"real data {q!r}: a document past se2.4's")
            n_total += len(results)
        print(f"real data: {s_n} subqueries of the slate over phase 3's index in one serve_step "
              f"({s_n} x {c_max} clusters x {l_max} x {window}, {p_max} postings): n_fragments == se2.4 "
              f"({n_total} fragments) and the top {REAL_DATA_TOP_K} == rank_documents")

        out_s, err_s = cli.communicate(timeout=600)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    print("  " + "\n  ".join(ln for ln in out_s.splitlines() if ln.strip()))
    require(cli.returncode == 0, f"the dry-run CLI exited {cli.returncode}: {err_s[-3000:]}")
    records = [json.loads(p.read_text()) for p in sorted(DRYRUN_OUT.glob("paper_search__*__singlepod.json"))]
    require(sorted(r["shape"] for r in records) == sorted(spec.shapes) and all(r["status"] == "ok" for r in records),
            f"the dry-run CLI wrote {[(r['shape'], r['status']) for r in records]}")
    print(f"python -m repro_torch.launch.dryrun --arch paper_search --all: exit 0, {len(records)} ok records "
          f"in {DRYRUN_OUT.relative_to(ROOT)}")
    for entry in kernels:
        if entry["name"] == "proximity_window":
            entry["dryrun_cells_n128"] = {k: v for k, v in cells.items() if "ms" in v}
    phase("paper_search build corpus, card == cpu, real data, dry-run CLI (10b)", t10)


def lm_phase(torch, dev, zero_counts, read_counts, cli: dict, ckpt: dict) -> dict:
    """Phase 11 (see the module docstring) with the results of (e) and (f),
    which ran beside phases 3 and 7; returns its summary."""
    import dataclasses
    import gc

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_spec
    from repro_torch.configs.common import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import layers, transformer
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.tree import tree_leaves, tree_map

    def rel(got, want) -> float:
        return float((got.float() - want.float()).norm() / want.float().norm())

    t11 = time.perf_counter()
    spec = get_spec(LM_ARCH)
    cfg = spec.model_cfg
    layout = make_production_mesh()
    summary: dict = {"arch": LM_ARCH, "params": cfg.param_count(), "cells": {}}
    print(f"{LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads (kv {cfg.n_kv_heads}), "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.param_count():,} params, {cfg.dtype}")
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on: the float32 checks need them off")

    def cut(shape):
        n = LM_CELL_LAYERS.get(shape, cfg.n_layers)
        return n, dataclasses.replace(spec, model_cfg=dataclasses.replace(cfg, n_layers=n))

    # ---- (a) the cells at one data rank's share ----
    zero_counts()
    for shape in LM_CELLS:
        repeats = 1 if shape in ("train_4k", "prefill_32k") else dryrun.REPEATS
        n_layers, cut_spec = cut(shape)
        rec = dryrun.run_cell(LM_ARCH, shape, False, verbose=False, device=dev, repeats=repeats, spec=cut_spec)
        if spec.shapes[shape].skip_reason is not None:
            require(rec["status"] == "skipped", f"{shape}: {rec['status']}, not skipped as in the reference")
            print(f"cell {shape}: skipped ({rec['skip_reason'][:60]}...)")
            summary["cells"][shape] = {"status": "skipped"}
            continue
        require(rec["status"] == "ok", f"{shape}: {rec.get('error')}\n{rec.get('traceback')}")
        wall = min(rec["wall_ms"])
        tflops = rec["model_flops_share"] / wall / 1e9
        peak = rec["peak_bytes"] / 2**20
        inputs = rec["input_shapes"][2] if shape == "train_4k" else rec["input_shapes"][1:]
        print(f"cell {shape}: {n_layers} of {cfg.n_layers} layers; {rec['notes']}; inputs {json.dumps(inputs)}; "
              f"wall {[round(x, 3) for x in rec['wall_ms']]} ms (first call {rec['first_call_s']:.2f} s), "
              f"peak {peak:.1f} MiB, {tflops:.2f} model TFLOP/s of the share, {rec['result']}")
        summary["cells"][shape] = {"layers": n_layers, "wall_ms": rec["wall_ms"], "first_call_s": rec["first_call_s"],
                                   "peak_mib": peak, "model_tflops": tflops, "result": rec["result"]}
        torch.cuda.empty_cache()
    counts = read_counts("LM cells (phase 11a)")
    require(all(v == 0 for v in counts.values()), f"the LM path launched a search kernel: {counts}")
    t11 = phase("LM dry-run cells at the data-rank share (11a)", t11)

    # one train_4k step under the profiler (at the cell's depth): device busy
    # share, top kernels
    train_layers, train_spec = cut("train_4k")
    cell = build_cell(train_spec, "train_4k", layout)
    share, _ = dryrun.data_share(spec.shapes["train_4k"].kwargs["global_batch"], layout)
    args = dryrun.cell_inputs(cell, train_spec.model_cfg, device=dev, batch=share)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_step = time.perf_counter()
        out = cell.fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_step) * 1e3
    del out
    # the optimizer alone at the same shapes (the params stand in for the
    # gradients: the update's work does not depend on their values)
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    adamw_update(args[0], args[1], AdamWConfig())
    ev0.record()
    adamw_update(args[0], args[1], AdamWConfig())
    ev1.record()
    ev1.synchronize()
    adamw_ms = ev0.elapsed_time(ev1)
    del args
    dev_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    gemm_ms = sum(e.self_device_time_total for e in dev_events
                  if any(w in e.key.lower() for w in ("gemm", "cutlass", "nvjet", "xmma", "sm90"))) / 1e3
    print(f"profiled train_4k step, {train_layers} layers: wall {wall_ms:.1f} ms (profiler on), device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), of which matmul kernels {gemm_ms:.1f} ms "
          f"({100 * gemm_ms / busy_ms:.1f}%), {sum(e.count for e in dev_events)} kernel launches; "
          f"adamw_update alone {adamw_ms:.1f} ms")
    for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.1f} ms x{e.count:<6d} {e.key[:100]}")
    summary["train_4k_profile"] = {"wall_ms": wall_ms, "busy_ms": busy_ms, "matmul_ms": gemm_ms,
                                   "adamw_ms": adamw_ms}
    del prof, dev_events
    gc.collect()
    torch.cuda.empty_cache()
    t11 = phase("train_4k step under torch.profiler", t11)

    # ---- (b) flash_attention against one masked softmax, one layer ----
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, s, dh = share, spec.shapes["train_4k"].kwargs["seq_len"], cfg.d_head
    q = torch.randn((b, s, cfg.n_heads, dh), generator=gen, device=dev, dtype=torch.bfloat16)
    k = torch.randn((b, s, cfg.n_kv_heads, dh), generator=gen, device=dev, dtype=torch.bfloat16)
    v = torch.randn((b, s, cfg.n_kv_heads, dh), generator=gen, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        flash = layers.flash_attention(q, k, v, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        t_flash = cuda_ms(torch, lambda: layers.flash_attention(q, k, v, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk), 3)
        # the plain softmax materializes [rows, heads, S, S] in float32: two rows at a time
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        plain = torch.cat([layers.attention_plain(q[i:i + 2], k[i:i + 2], v[i:i + 2]) for i in range(0, b, 2)])
        ev1.record()
        ev1.synchronize()
    err_b = rel(flash, plain)
    max_b = float((flash.float() - plain.float()).abs().max())
    require(flash.dtype == torch.bfloat16 and err_b < LM_BF16_REL,
            f"flash_attention vs attention_plain: relative error {err_b:.3e} (limit {LM_BF16_REL})")
    print(f"flash_attention vs attention_plain at {tuple(q.shape)} q, {tuple(k.shape)} kv, bf16: relative error "
          f"{err_b:.3e} (limit {LM_BF16_REL}), max abs {max_b:.3e}; {timing('flash', t_flash)}, plain "
          f"{ev0.elapsed_time(ev1):.1f} ms (one call)")
    summary["flash_vs_plain"] = {"rel_err": err_b, "max_abs": max_b, "flash_ms": t_flash[0],
                                 "plain_ms": ev0.elapsed_time(ev1)}
    del q, k, v, flash, plain
    torch.cuda.empty_cache()
    t11 = phase("flash_attention vs plain softmax, one layer (11b)", t11)

    # ---- (c) prefill S then decode one token vs prefill of S + 1 ----
    tokens = torch.randint(0, cfg.vocab, (2, LM_PREFILL + 1), generator=gen, device=dev)
    summary["decode_vs_prefill"] = {}
    for dtype, limit in (("float32", LM_F32_REL), ("bfloat16", LM_DECODE_BF16_REL)):
        dcfg = dataclasses.replace(cfg, dtype=dtype)
        params = transformer.init_params(SEED, dcfg, device=dev)
        # both prefills as one attention tile (S = 1,024 is the config's
        # chunk; S + 1 = 1,025 gets a chunk of its own, where the gcd fallback
        # of 1,024 would be 1)
        cfg_long = dataclasses.replace(dcfg, q_chunk=LM_PREFILL + 1, kv_chunk=LM_PREFILL + 1)
        with torch.no_grad():
            _, cache = transformer.prefill_step(params, tokens[:, :LM_PREFILL], dcfg)
            cache = {n: torch.cat([c, torch.zeros_like(c[:, :, :1])], dim=2) for n, c in cache.items()}
            logits, new_cache = transformer.decode_step(params, cache, tokens[:, LM_PREFILL:], LM_PREFILL, dcfg)
            want, want_cache = transformer.prefill_step(params, tokens, cfg_long)
        err_c = rel(logits, want)
        err_kv = max(rel(new_cache[n][:, :, LM_PREFILL], want_cache[n][:, :, LM_PREFILL]) for n in ("k", "v"))
        require(err_c < limit and err_kv < limit,
                f"decode vs prefill, {dtype}: logits relative error {err_c:.3e}, written cache row {err_kv:.3e}")
        print(f"prefill {LM_PREFILL} + decode_step vs prefill {LM_PREFILL + 1}, {cfg.n_layers} layers, {dtype}: "
              f"logits relative error {err_c:.3e}, written cache row {err_kv:.3e} (limit {limit}); top-1 tokens "
              f"{logits.argmax(-1).tolist()} vs {want.argmax(-1).tolist()}")
        summary["decode_vs_prefill"][dtype] = {"logits_rel_err": err_c, "cache_rel_err": err_kv}
        del params, cache, new_cache, want_cache, logits, want
        torch.cuda.empty_cache()
    t11 = phase("prefill + decode vs prefill, all layers (11c)", t11)

    # ---- (d) a float32 train step, depth cut, card vs this machine's CPU ----
    cut = dataclasses.replace(cfg, n_layers=LM_CUT_LAYERS, dtype="float32")
    short = ShapeCell(name="train_4k", step="train", kind="training", kwargs={"seq_len": 256, "global_batch": 2})
    cut_spec = dataclasses.replace(spec, model_cfg=cut, shapes={"train_4k": short})
    cell = build_cell(cut_spec, "train_4k", layout)
    cpu_args = dryrun.cell_inputs(cell, cut, device="cpu", batch=2)
    card_args = tree_map(lambda t: t.to(dev), cpu_args)
    t_cpu = time.perf_counter()
    cpu_p, cpu_o, cpu_m = cell.fn(*cpu_args)
    t_cpu = time.perf_counter() - t_cpu
    card_p, card_o, card_m = cell.fn(*card_args)
    torch.cuda.synchronize()
    m_err = {k: abs(float(card_m[k]) - float(cpu_m[k])) / max(abs(float(cpu_m[k])), 1e-30) for k in cpu_m}
    p_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p)))
    o_err = max(float((a.cpu().float() - b.float()).abs().max())
                for a, b in zip(tree_leaves(card_o["master"]), tree_leaves(cpu_o["master"])))
    require(all(e < 1e-4 for e in m_err.values()) and p_err < 1e-5 and o_err < 1e-5,
            f"float32 train step card vs cpu: metrics {m_err}, params max abs {p_err:.3e}, master {o_err:.3e}")
    print(f"float32 train step, {LM_CUT_LAYERS} layers at full width, 2 x 256 tokens: card == cpu (metrics "
          f"relative {max(m_err.values()):.2e} < 1e-4, params max abs {p_err:.2e} and master {o_err:.2e} < 1e-5; "
          f"loss {float(card_m['loss']):.6f}); cpu step {t_cpu:.1f} s")
    summary["float32_step_card_vs_cpu"] = {"metrics_rel": max(m_err.values()), "params_abs": p_err}
    del cpu_args, card_args, cpu_p, cpu_o, card_p, card_o
    gc.collect()
    torch.cuda.empty_cache()
    t11 = phase("float32 train step card vs cpu, 2 layers (11d)", t11)

    # ---- (e) and (f), run beside phases 3 and 7: their results ----
    for line in cli["lines"]:
        print(f"  {line}")
    print(f"python -m repro_torch.launch.train --full-scale --steps {LM_CLI_STEPS} (beside phase 3's host-side "
          f"index build): exit 0, every loss and grad norm finite; process {cli['process_s']:.1f} s")
    summary["cli"] = {k: cli[k] for k in ("steps", "done", "process_s")}
    for line in ckpt["lines"]:
        print(f"  {line}")
    print(f"checkpoint resume, {LM_CUT_LAYERS} layers at full width, {LM_CKPT_BATCH} x 4,096 tokens, "
          f"deterministic (beside phase 7's host-side builds): 4 steps straight == 2 steps + save_async "
          f"({ckpt['ckpt_mib']:.0f} MiB on disk) + fresh-process restore + 2 steps, all {ckpt['leaves']} leaves "
          f"(params, m, v, master, step) bit for bit (sha256 {ckpt['sha256'][:16]}); processes "
          f"{ckpt['process_s'][0]:.1f} s and {ckpt['process_s'][1]:.1f} s")
    summary["checkpoint_resume"] = {k: ckpt[k] for k in ("ckpt_mib", "leaves", "sha256", "process_s")}
    return summary


def lm_cli_start(procs: list):
    """Phase 11e: ``python -m repro_torch.launch.train --full-scale`` in a
    fresh process (jax and the reference package blocked), started beside
    phase 3's host-side index build, when the card is otherwise idle."""
    argv = ["--arch", LM_ARCH, "--full-scale", "--steps", str(LM_CLI_STEPS), "--device", "cuda"]
    proc = subprocess.Popen([sys.executable, "-c", RUN_MODULE, "repro_torch.launch.train", *argv],
                            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs.append(proc)
    return proc, time.perf_counter()


def lm_cli_finish(proc, t_start: float) -> dict:
    """Wait for the trainer of ``lm_cli_start`` and check what it printed:
    steps 0 and 5 and the ``done:`` line, every loss and grad norm finite."""
    out, err = proc.communicate(timeout=600)
    lines = [ln for ln in out.splitlines() if ln.strip()]
    require(proc.returncode == 0, f"the trainer exited {proc.returncode}: {err[-3000:]}\n{out[-2000:]}")
    steps = [dict(kv.split("=") for kv in ln.split()[2:]) for ln in lines if ln.startswith("step ")]
    require([int(ln.split()[1]) for ln in lines if ln.startswith("step ")] == [0, 5] and lines[-1].startswith(
        f"done: {LM_CLI_STEPS} steps"), f"the trainer printed {lines}")
    require(all(math.isfinite(float(st[k])) for st in steps for k in ("loss", "grad_norm")),
            f"a loss or grad norm is not finite: {steps}")
    return {"lines": lines, "steps": steps, "done": lines[-1], "process_s": time.perf_counter() - t_start}


def lm_resume_check(procs: list) -> dict:
    """Phase 11f: the checkpoint-resume check of ``LM_RESUME`` in two fresh
    processes, one after the other (on a thread beside phase 7's host-side
    builds); the checkpoint files are deleted after."""
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_ckpt_"))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    lines, seconds, digests = [], [], {}
    try:
        for mode in ("first", "resume"):
            t_run = time.perf_counter()
            proc = subprocess.Popen([sys.executable, "-c", LM_RESUME, str(ROOT / "src"), mode, LM_ARCH,
                                     str(LM_CUT_LAYERS), str(LM_CKPT_BATCH), str(work)],
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            procs.append(proc)
            out, err = proc.communicate(timeout=600)
            require(proc.returncode == 0, f"checkpoint {mode} run exited {proc.returncode}: {err[-3000:]}")
            lines += [ln for ln in out.splitlines() if ln.strip()]
            seconds.append(time.perf_counter() - t_run)
            digests[mode] = [ln.split()[1:] for ln in out.splitlines() if ln.startswith("digest ")]
            if mode == "first":
                ckpt_mib = sum(p.stat().st_size for p in work.rglob("*") if p.is_file()) / 2**20
        require(digests["first"] == digests["resume"] and len(digests["first"]) == 1
                and digests["first"][0][0] == "4",
                f"resumed params and state != straight ones: {digests}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    require(not work.exists(), f"{work} was not deleted")
    return {"lines": lines, "ckpt_mib": ckpt_mib, "leaves": int(digests["first"][0][1]),
            "sha256": digests["first"][0][2], "process_s": seconds}


class MoESpy:
    """Within the ``with``: every ``moe_ffn`` call of the port's
    transformer, recorded as (its input, its router) on the way."""

    def __init__(self, transformer):
        self._tf = transformer
        self.calls: list = []

    def __enter__(self):
        self._orig = self._tf.moe_ffn

        def spy(x, params, cfg):
            self.calls.append((x.detach(), params["router"].detach()))
            return self._orig(x, params, cfg)

        self._tf.moe_ffn = spy
        return self

    def __exit__(self, *exc):
        self._tf.moe_ffn = self._orig


def lm_cells(torch, dev, arch: str, layers: dict, read_counts, zero_counts, label: str) -> dict:
    """``dryrun.run_cell`` on each cell of ``layers`` at that depth (the
    config's full width, one data rank's share): wall ms, peak MiB, model
    TFLOP/s; each cell's launch counters set to 0 before and read after."""
    import dataclasses

    from repro_torch.configs import get_spec
    from repro_torch.launch import dryrun

    spec = get_spec(arch)
    cfg = spec.model_cfg
    print(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads (kv {cfg.n_kv_heads}), "
          f"{cfg.moe.n_experts} experts of d_ff {cfg.moe.d_ff}, top {cfg.moe.top_k}, dispatch {cfg.moe.dispatch!r} "
          f"(on one card the reference's single-device sort), interleave {cfg.moe_interleave}, vocab {cfg.vocab}, "
          f"{cfg.param_count():,} params ({cfg.active_param_count():,} active), {cfg.dtype}")
    out = {}
    for shape, n_layers in layers.items():
        cut = dataclasses.replace(spec, model_cfg=dataclasses.replace(cfg, n_layers=n_layers))
        repeats = 1 if shape in ("train_4k", "prefill_32k") else dryrun.REPEATS
        zero_counts()
        rec = dryrun.run_cell(arch, shape, False, verbose=False, device=dev, repeats=repeats, spec=cut)
        counts = read_counts(f"{label} {arch} {shape}")
        require(all(v == 0 for v in counts.values()), f"the {arch} {shape} cell launched a search kernel: {counts}")
        if spec.shapes[shape].skip_reason is not None:
            require(rec["status"] == "skipped", f"{arch} {shape}: {rec['status']}, not skipped as in the reference")
            print(f"cell {arch} {shape}: skipped ({rec['skip_reason'][:60]}...)")
            out[shape] = {"status": "skipped"}
            continue
        require(rec["status"] == "ok", f"{arch} {shape}: {rec.get('error')}\n{rec.get('traceback')}")
        wall = min(rec["wall_ms"])
        tflops = rec["model_flops_share"] / wall / 1e9
        peak = rec["peak_bytes"] / 2**20
        print(f"cell {arch} {shape}: {n_layers} of {cfg.n_layers} layers, "
              f"{cut.model_cfg.param_count():,} params; {rec['notes']}; wall "
              f"{[round(x, 3) for x in rec['wall_ms']]} ms (first call {rec['first_call_s']:.2f} s), peak "
              f"{peak:.1f} MiB, {tflops:.2f} model TFLOP/s of the share, {rec['result']}")
        out[shape] = {"layers": n_layers, "wall_ms": rec["wall_ms"], "first_call_s": rec["first_call_s"],
                      "peak_mib": peak, "model_tflops": tflops, "result": rec["result"]}
        gc.collect()
        torch.cuda.empty_cache()
    return out


def moe_phase(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 12 (see the module docstring); returns its summary."""
    import dataclasses

    from repro_torch.configs import get_spec
    from repro_torch.configs.common import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import moe, transformer
    from repro_torch.tree import tree_leaves, tree_map

    def rel(got, want) -> float:
        return float((got.float() - want.float()).norm() / want.float().norm())

    def routes(x, router, k):
        gates, _ = moe._router(x.reshape(-1, x.shape[-1]).float(), {"router": router})
        return moe._top_k(gates, k)[1].sort(dim=-1).values

    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on: the float32 checks need them off")
    t12 = time.perf_counter()
    summary: dict = {"cells": {}}

    # ---- (a) the cells ----
    summary["cells"][MOE_ARCH] = lm_cells(torch, dev, MOE_ARCH, MOE_CELL_LAYERS, read_counts, zero_counts,
                                          "MoE cells (phase 12a)")
    summary["cells"][MAVERICK_ARCH] = lm_cells(torch, dev, MAVERICK_ARCH, MAVERICK_CELL_LAYERS, read_counts,
                                               zero_counts, "MoE cells (phase 12a)")
    t12 = phase("MoE dry-run cells at the data-rank share (12a)", t12)

    spec = get_spec(MOE_ARCH)
    cfg = spec.model_cfg
    k = cfg.moe.top_k

    # ---- (b) one MoE layer at olmoe's widths: einsum == sort with no drops,
    # and with drops each dispatch on the card == on this machine's CPU ----
    gen = torch.Generator().manual_seed(SEED)
    params_cpu = moe.init_moe_params(gen, cfg.d_model, cfg.moe, torch.float32)
    x_cpu = torch.randn((1, MOE_CHECK_TOKENS, cfg.d_model), generator=gen)
    params_card, x_card = tree_map(lambda t: t.to(dev), params_cpu), x_cpu.to(dev)
    summary["dispatch"] = {}
    for dtype, tol in (("float32", None), ("bfloat16", LM_BF16_REL)):
        dt = getattr(torch, dtype)
        p = {n: (t if n == "router" else t.to(dt)) for n, t in params_card.items()}
        out = {}
        for dispatch in ("einsum", "sort"):
            mcfg = dataclasses.replace(cfg.moe, capacity_factor=MOE_NO_DROP, dispatch=dispatch)
            require(not moe.dropped_slots(x_card.to(dt), p, mcfg).any(), f"{dispatch} dropped at cf {MOE_NO_DROP}")
            out[dispatch] = moe.moe_ffn(x_card.to(dt), p, mcfg)
        err = rel(out["einsum"][0], out["sort"][0])
        aux_err = abs(float(out["einsum"][1]) - float(out["sort"][1])) / abs(float(out["sort"][1]))
        if tol is None:
            ok = torch.allclose(out["einsum"][0], out["sort"][0], rtol=1e-4, atol=1e-5) and aux_err < 1e-4
        else:
            ok = err < tol and aux_err < tol
        require(ok, f"einsum vs sort on the card, {dtype}: y relative error {err:.3e}, aux {aux_err:.3e}")
        print(f"one MoE layer at olmoe's widths, {MOE_CHECK_TOKENS} tokens, capacity factor {MOE_NO_DROP} (no drops), "
              f"{dtype}: einsum == sort on the card (y relative error {err:.3e}, aux {aux_err:.3e})")
        summary["dispatch"][f"einsum_vs_sort_{dtype}"] = {"y_rel_err": err, "aux_rel_err": aux_err}
    for dispatch in ("einsum", "sort"):
        mcfg = dataclasses.replace(cfg.moe, dispatch=dispatch)
        card_y, card_aux = moe.moe_ffn(x_card, params_card, mcfg)
        cpu_y, cpu_aux = moe.moe_ffn(x_cpu, params_cpu, mcfg)
        card_drop = moe.dropped_slots(x_card, params_card, mcfg).cpu()
        cpu_drop = moe.dropped_slots(x_cpu, params_cpu, mcfg)
        max_abs = float((card_y.cpu() - cpu_y).abs().max())
        require(torch.equal(card_drop, cpu_drop) and int(cpu_drop.sum()) > 0,
                f"{dispatch} at cf {cfg.moe.capacity_factor}: card drops {int(card_drop.sum())}, cpu {int(cpu_drop.sum())}")
        require(torch.allclose(card_y.cpu(), cpu_y, rtol=1e-4, atol=1e-5)
                and abs(float(card_aux) - float(cpu_aux)) <= 1e-4 * abs(float(cpu_aux)),
                f"{dispatch} with drops: card vs cpu max abs {max_abs:.3e}")
        print(f"  {dispatch} at the config's capacity factor {cfg.moe.capacity_factor} (C = "
              f"{moe._capacity(MOE_CHECK_TOKENS, mcfg)}): {int(cpu_drop.sum())} of {cpu_drop.numel()} (token, slot) "
              f"pairs dropped, the same on the card and the CPU; card == cpu (max abs {max_abs:.3e})")
        summary["dispatch"][f"{dispatch}_drops"] = {"dropped": int(cpu_drop.sum()), "max_abs": max_abs}
    drops = {d: moe.dropped_slots(x_cpu, params_cpu, dataclasses.replace(cfg.moe, dispatch=d)) for d in ("einsum", "sort")}
    print(f"  einsum and sort drop {'different' if not torch.equal(drops['einsum'], drops['sort']) else 'the same'} "
          f"(token, slot) pairs: {int((drops['einsum'] != drops['sort']).sum())} differ")
    del params_card, x_card, out
    gc.collect()
    torch.cuda.empty_cache()
    t12 = phase("einsum vs sort on the card, each dispatch card vs cpu with drops (12b)", t12)

    # ---- (c) prefill S then decode one token vs prefill of S + 1, all layers,
    # at a capacity factor that drops nothing (the sort dispatch would drop
    # the prefill's latest tokens first, and a decode of one token never) ----
    tokens = torch.randint(0, cfg.vocab, (2, MOE_PREFILL + 1), generator=torch.Generator(device=dev).manual_seed(SEED),
                           device=dev)
    summary["decode_vs_prefill"] = {}
    for dtype, limit in (("float32", LM_F32_REL), ("bfloat16", LM_DECODE_BF16_REL)):
        dcfg = dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(cfg.moe, capacity_factor=MOE_NO_DROP))
        params = transformer.init_params(SEED, dcfg, device=dev)
        cfg_long = dataclasses.replace(dcfg, q_chunk=MOE_PREFILL + 1, kv_chunk=MOE_PREFILL + 1)
        with torch.no_grad(), MoESpy(transformer) as spy:
            _, cache = transformer.prefill_step(params, tokens[:, :MOE_PREFILL], dcfg)
            cache = {n: torch.cat([c, torch.zeros_like(c[:, :, :1])], dim=2) for n, c in cache.items()}
            spy.calls.clear()
            logits, new_cache = transformer.decode_step(params, cache, tokens[:, MOE_PREFILL:], MOE_PREFILL, dcfg)
            decoded = list(spy.calls)
            spy.calls.clear()
            want, want_cache = transformer.prefill_step(params, tokens, cfg_long)
            prefilled = list(spy.calls)
        require(len(decoded) == len(prefilled) == cfg.n_layers, f"{len(decoded)}, {len(prefilled)} MoE calls")
        flips = [int((routes(xd, r, k) != routes(xp[:, -1:], r, k)).any(-1).sum())
                 for (xd, r), (xp, _) in zip(decoded, prefilled)]
        err_c = rel(logits, want)
        err_kv = max(rel(new_cache[n][:, :, MOE_PREFILL], want_cache[n][:, :, MOE_PREFILL]) for n in ("k", "v"))
        held = dtype == "float32" or not any(flips)
        require(not held or (err_c < limit and err_kv < limit),
                f"decode vs prefill, {dtype}: logits relative error {err_c:.3e}, written cache row {err_kv:.3e}, "
                f"routing flips per layer {flips}")
        require(dtype != "float32" or not any(flips), f"float32 decode and prefill routed apart: {flips}")
        print(f"prefill {MOE_PREFILL} + decode_step vs prefill {MOE_PREFILL + 1}, {cfg.n_layers} layers, "
              f"capacity factor {MOE_NO_DROP}, {dtype}: logits relative error {err_c:.3e}, written cache row "
              f"{err_kv:.3e} ({'limit ' + str(limit) if held else 'not held: a route flipped'}); routing flips "
              f"(token, layer) of the decoded token: {sum(flips)} of {2 * cfg.n_layers}; top-1 tokens "
              f"{logits.argmax(-1).tolist()} vs {want.argmax(-1).tolist()}")
        summary["decode_vs_prefill"][dtype] = {"logits_rel_err": err_c, "cache_rel_err": err_kv,
                                               "routing_flips": sum(flips)}
        del params, cache, new_cache, want_cache, logits, want, decoded, prefilled
        gc.collect()
        torch.cuda.empty_cache()
    t12 = phase("prefill + decode vs prefill, all 16 layers (12c)", t12)

    # ---- (d) a float32 train step at full width, depth 1, card vs CPU ----
    cut = dataclasses.replace(cfg, n_layers=1, dtype="float32", microbatches=1)
    short = ShapeCell(name="train_4k", step="train", kind="training", kwargs={"seq_len": 256, "global_batch": 2})
    cut_spec = dataclasses.replace(spec, model_cfg=cut, shapes={"train_4k": short})
    cell = build_cell(cut_spec, "train_4k", make_production_mesh())
    cpu_args = dryrun.cell_inputs(cell, cut, device="cpu", batch=2)
    card_args = tree_map(lambda t: t.to(dev), cpu_args)
    with MoESpy(transformer) as spy:
        card_p, card_o, card_m = cell.fn(*card_args)
    layer = tree_map(lambda t: t[0], card_args[0]["layers"]["moe"])
    dropped = int(moe.dropped_slots(spy.calls[0][0], layer, cut.moe).sum())
    t_cpu = time.perf_counter()
    cpu_p, cpu_o, cpu_m = cell.fn(*cpu_args)
    t_cpu = time.perf_counter() - t_cpu
    torch.cuda.synchronize()
    m_err = {n: abs(float(card_m[n]) - float(cpu_m[n])) / max(abs(float(cpu_m[n])), 1e-30) for n in cpu_m}
    p_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p)))
    o_err = max(float((a.cpu() - b).abs().max())
                for a, b in zip(tree_leaves(card_o["master"]), tree_leaves(cpu_o["master"])))
    require(dropped > 0, "the float32 step dropped no token: no drop was exercised")
    require(all(e < 1e-4 for e in m_err.values()) and p_err < 1e-5 and o_err < 1e-5,
            f"float32 MoE train step card vs cpu: metrics {m_err}, params max abs {p_err:.3e}, master {o_err:.3e}")
    print(f"float32 train step, 1 layer at full width, 2 x 256 tokens, capacity factor {cut.moe.capacity_factor}: "
          f"{dropped} of {2 * 256 * k} (token, slot) pairs dropped; card == cpu (metrics relative "
          f"{max(m_err.values()):.2e} < 1e-4, params max abs {p_err:.2e} and master {o_err:.2e} < 1e-5; loss "
          f"{float(card_m['loss']):.6f}, aux {float(card_m['aux']):.6f}); cpu step {t_cpu:.1f} s")
    summary["float32_step_card_vs_cpu"] = {"metrics_rel": max(m_err.values()), "params_abs": p_err,
                                           "dropped": dropped}
    del cpu_args, card_args, cpu_p, cpu_o, card_p, card_o, spy
    gc.collect()
    torch.cuda.empty_cache()
    phase("float32 MoE train step card vs cpu, 1 layer (12d)", t12)
    return summary


def recsys_phase(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 13 (see the module docstring); returns its summary."""
    from repro_torch.configs import get_reduced_spec, get_spec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.tree import tree_leaves, tree_map

    t13 = time.perf_counter()
    summary: dict = {}
    for arch in RECSYS_ARCHS:
        spec = get_spec(arch)
        cfg = spec.model_cfg
        print(f"{arch}: model {cfg.model!r}, {cfg.n_sparse} sparse fields ({cfg.total_vocab:,} rows of "
              f"{cfg.embed_dim}), {cfg.n_dense} dense, {cfg.param_count():,} params, {cfg.dtype}")
        summary[arch] = {}
        for shape in spec.shapes:
            zero_counts()
            rec = dryrun.run_cell(arch, shape, False, verbose=False, device=dev)
            counts = read_counts(f"recsys cells (phase 13a) {arch} {shape}")
            require(all(v == 0 for v in counts.values()), f"the {arch} {shape} cell launched a search kernel: {counts}")
            require(rec["status"] == "ok", f"{arch} {shape}: {rec.get('error')}\n{rec.get('traceback')}")
            wall = min(rec["wall_ms"])
            tflops = rec["model_flops_global"] / wall / 1e9
            peak = rec["peak_bytes"] / 2**20
            print(f"cell {arch} {shape}: whole batch {json.dumps(rec['input_shapes'][-1])}; wall "
                  f"{[round(x, 3) for x in rec['wall_ms']]} ms (first call {rec['first_call_s']:.2f} s), peak "
                  f"{peak:.1f} MiB, {tflops:.3f} model TFLOP/s, {rec['result']}")
            summary[arch][shape] = {"wall_ms": rec["wall_ms"], "first_call_s": rec["first_call_s"],
                                    "peak_mib": peak, "model_tflops": tflops, "result": rec["result"]}
            gc.collect()
            torch.cuda.empty_cache()
        # a float32 train step at the reduced config, card vs this machine's CPU
        rspec = get_reduced_spec(arch)
        cell = build_cell(rspec, "train_batch", make_production_mesh())
        cpu_args = dryrun.cell_inputs(cell, rspec.model_cfg, device="cpu")
        card_args = tree_map(lambda t: t.to(dev), cpu_args)
        card_p, _, card_m = cell.fn(*card_args)
        cpu_p, _, cpu_m = cell.fn(*cpu_args)
        m_err = abs(float(card_m["loss"]) - float(cpu_m["loss"])) / abs(float(cpu_m["loss"]))
        p_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p)))
        require(m_err < 1e-4 and p_err < 1e-5, f"{arch} float32 train step card vs cpu: loss {m_err:.3e}, "
                                               f"params max abs {p_err:.3e}")
        print(f"  {arch} float32 train step at the reduced config ({rspec.shapes['train_batch'].kwargs['batch']} "
              f"rows): card == cpu (loss relative {m_err:.2e} < 1e-4, params max abs {p_err:.2e} < 1e-5)")
        summary[arch]["float32_step_card_vs_cpu"] = {"loss_rel": m_err, "params_abs": p_err}
    phase("recsys dry-run cells at full scale, float32 steps card vs cpu (13)", t13)
    return summary


def gnn_phase(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 14a-d (see the module docstring); returns its summary."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_reduced_spec, get_spec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import gnn
    from repro_torch.tree import tree_leaves, tree_map

    t14 = time.perf_counter()
    spec = get_spec(GNN_ARCH)
    summary: dict = {}
    # ---- (a) every cell at full shape, whole
    for shape, meta in spec.shapes.items():
        cfg, kw = spec.cfg_for(shape), meta.kwargs
        zero_counts()
        rec = dryrun.run_cell(GNN_ARCH, shape, False, verbose=False, device=dev)
        counts = read_counts(f"gnn cells (phase 14a) {GNN_ARCH} {shape}")
        require(all(v == 0 for v in counts.values()), f"the {shape} cell launched a search kernel: {counts}")
        require(rec["status"] == "ok", f"{GNN_ARCH} {shape}: {rec.get('error')}\n{rec.get('traceback')}")
        wall = min(rec["wall_ms"])
        tflops = rec["model_flops_global"] / wall / 1e9
        peak = rec["peak_bytes"] / 2**20
        chunk = gnn.edge_chunk(kw["n_edges"], cfg.n_heads, cfg.n_classes, dev)
        print(f"cell {GNN_ARCH} {shape}: whole graph, {kw['n_nodes']:,} nodes, {kw['n_edges']:,} edges, "
              f"{cfg.d_feat} features, {cfg.n_classes} classes, task {cfg.task}, {cfg.param_count():,} params; "
              f"layer-2 aggregate in {-(-kw['n_edges'] // chunk)} chunk(s) of {chunk:,} edges; wall "
              f"{[round(x, 3) for x in rec['wall_ms']]} ms (first call, counted, {rec['first_call_s']:.2f} s; "
              f"inputs {rec['inputs_s']:.2f} s), peak {peak:.1f} MiB, {tflops:.4f} model TFLOP/s; "
              f"flops/dev {rec['flops_per_device']:.4e}, hbm/dev {rec['hbm_bytes_per_device']:.4e} B, "
              f"coll/dev {rec['collective_total_per_device']:.4e} B {rec['collective_bytes_per_device']}; "
              f"{rec['result']}")
        summary[shape] = {"wall_ms": rec["wall_ms"], "first_call_s": rec["first_call_s"], "inputs_s": rec["inputs_s"],
                          "peak_mib": peak, "model_tflops": tflops, "chunk": chunk,
                          "flops_per_device": rec["flops_per_device"],
                          "hbm_bytes_per_device": rec["hbm_bytes_per_device"],
                          "collective_total_per_device": rec["collective_total_per_device"],
                          "result": rec["result"]}
        gc.collect()
        torch.cuda.empty_cache()
    # one ogb_products step under the profiler: device busy share, top kernels
    cell = build_cell(spec, "ogb_products", make_production_mesh())
    args = dryrun.cell_inputs(cell, spec.cfg_for("ogb_products"), device=dev)
    cell.fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_step = time.perf_counter()
        out = cell.fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_step) * 1e3
    del out, args
    dev_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    print(f"profiled ogb_products step: wall {wall_ms:.1f} ms (profiler on), device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in dev_events)} kernel launches")
    for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.1f} ms x{e.count:<6d} {e.key[:100]}")
    summary["ogb_products_profile"] = {"wall_ms": wall_ms, "busy_ms": busy_ms, "top": [
        (e.key[:100], e.self_device_time_total / 1e3, e.count)
        for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:12]]}
    del prof, dev_events
    gc.collect()
    torch.cuda.empty_cache()
    t14 = phase("gnn dry-run cells at full shape, a profiled ogb_products step (14a)", t14)

    # ---- (b) a float32 train step of each reduced cell, card vs this CPU
    rspec = get_reduced_spec(GNN_ARCH)
    for shape in rspec.shapes:
        cell = build_cell(rspec, shape, make_smoke_mesh())
        cpu_args = dryrun.cell_inputs(cell, rspec.cfg_for(shape), device="cpu")
        card_args = tree_map(lambda t: t.to(dev), cpu_args)
        card_p, _, card_m = cell.fn(*card_args)
        cpu_p, _, cpu_m = cell.fn(*cpu_args)
        m_err = abs(float(card_m["loss"]) - float(cpu_m["loss"])) / abs(float(cpu_m["loss"]))
        p_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p)))
        require(m_err < 1e-4 and p_err < 1e-5 and float(card_m["acc"]) == float(cpu_m["acc"]),
                f"gat-cora {shape} float32 train step card vs cpu: loss {m_err:.3e}, params max abs {p_err:.3e}, "
                f"acc {float(card_m['acc'])} vs {float(cpu_m['acc'])}")
        print(f"  {GNN_ARCH} {shape} float32 train step at the reduced config: card == cpu (loss relative "
              f"{m_err:.2e} < 1e-4, acc equal, params max abs {p_err:.2e} < 1e-5)")
        summary[f"{shape}_float32_step_card_vs_cpu"] = {"loss_rel": m_err, "params_abs": p_err}
    t14 = phase("float32 gnn train steps card vs cpu (14b)", t14)

    # ---- (c) the chunked aggregate against the unchunked form
    big = spec.shapes["ogb_products"].kwargs
    cfg = spec.cfg_for("ogb_products")
    n, e, nh, d = big["n_nodes"], AGG_EDGES, cfg.n_heads, cfg.n_classes
    gen = torch.Generator(device=dev).manual_seed(14)
    src = torch.randint(0, n, (e,), generator=gen, device=dev)
    dst = torch.randint(0, n, (e,), generator=gen, device=dev)
    ex = torch.rand((e, nh), generator=gen, device=dev).requires_grad_(True)
    h = torch.randn((n, nh, d), generator=gen, device=dev).requires_grad_(True)
    g_out = torch.randn((n, nh, d), generator=gen, device=dev)
    chunk = gnn.edge_chunk(e, nh, d, dev)
    runs = {}
    for label, fn in (("chunked", lambda: gnn.aggregate(ex, h, src, dst)),
                      ("unchunked", lambda: gnn.aggregate_plain(ex, h, src, dst))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        out = fn()
        ev[1].record()
        grads = torch.autograd.grad(out, (ex, h), g_out)
        ev[2].record()
        ev[2].synchronize()
        runs[label] = (out.detach(), grads, ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                       (torch.cuda.max_memory_allocated() - base) / 2**20)
        del out, grads
    (got, g_got, *t_c), (want, g_want, *t_u) = runs["chunked"], runs["unchunked"]
    errs = [float((a - b).abs().max()) for a, b in ((got, want), *zip(g_got, g_want))]
    ok = torch.allclose(got, want, rtol=1e-5, atol=1e-5) and all(
        torch.allclose(a, b, rtol=1e-5, atol=1e-5) for a, b in zip(g_got, g_want))
    require(ok, f"the chunked aggregate != the unchunked form: max abs (msg, d ex, d h) {errs}")
    print(f"aggregate at ogbn-products' nodes and widths ({n:,} nodes, {e:,} edges, {nh} heads x {d}): chunked "
          f"({-(-e // chunk)} chunks of {chunk:,} edges) == unchunked within rtol 1e-5 / atol 1e-5 (max abs msg, "
          f"d ex, d h: {[f'{x:.2e}' for x in errs]}); forward + backward ms, peak MiB: chunked {t_c[0]:.3f} + "
          f"{t_c[1]:.3f}, {t_c[2]:.1f}; unchunked {t_u[0]:.3f} + {t_u[1]:.3f}, {t_u[2]:.1f}")
    summary["aggregate_check"] = {"edges": e, "chunk": chunk, "max_abs": errs, "chunked_ms": t_c[:2],
                                  "chunked_peak_mib": t_c[2], "unchunked_ms": t_u[:2], "unchunked_peak_mib": t_u[2]}
    del runs, got, want, g_got, g_want, ex, h, g_out, src, dst
    gc.collect()
    torch.cuda.empty_cache()
    t14 = phase("chunked aggregate vs the unchunked form (14c)", t14)

    # ---- (d) the trainer CLI in a fresh process
    t_cli = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", RUN_MODULE, "repro_torch.launch.train", "--arch", GNN_ARCH,
                           "--steps", "2", "--device", "cuda"],
                          cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    require(proc.returncode == 0, f"the gat-cora trainer exited {proc.returncode}: {proc.stderr[-3000:]}")
    steps = [dict(kv.split("=") for kv in ln.split()[2:]) for ln in lines if ln.startswith("step ")]
    require([int(ln.split()[1]) for ln in lines if ln.startswith("step ")] == [0, 1]
            and lines[-1].startswith("done: 2 steps")
            and all(math.isfinite(float(st[k])) for st in steps for k in ("loss", "acc")),
            f"the gat-cora trainer printed {lines}")
    print(f"python -m repro_torch.launch.train --arch {GNN_ARCH} --steps 2 (fresh process, "
          f"{time.perf_counter() - t_cli:.1f} s): " + " | ".join(lines))
    summary["cli"] = lines
    phase("the gat-cora trainer CLI (14d)", t14)
    return summary


def cost_phase(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 14e (see the module docstring); returns its summary."""
    from repro_torch.configs import get_reduced_spec
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost_analysis import CostCounter
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.tree import tree_map

    t14 = time.perf_counter()
    summary: dict = {}
    for arch, shape in COST_CELLS:
        spec = get_reduced_spec(arch)
        cell = build_cell(spec, shape, make_smoke_mesh())
        cpu_args = dryrun.cell_inputs(cell, spec.cfg_for(shape), device="cpu")
        card_args = tree_map(lambda t: t.to(dev), cpu_args)
        on_cpu, on_card = CostCounter(), CostCounter()
        with on_cpu:
            cell.fn(*cpu_args)
        zero_counts()
        with on_card:
            cell.fn(*card_args)
        torch.cuda.synchronize()
        counts = read_counts(f"cost counter card vs cpu (phase 14e) {arch} {shape}")
        a, b = on_card.cost, on_cpu.cost
        if (a.flops, a.hbm_bytes) != (b.flops, b.hbm_bytes):
            diff = {op: (on_card.by_op.get(op), on_cpu.by_op.get(op))
                    for op in sorted(set(on_card.by_op) | set(on_cpu.by_op))
                    if on_card.by_op.get(op) != on_cpu.by_op.get(op)}
            require(False, f"{arch} {shape}: the card counts flops {a.flops:.6e}, bytes {a.hbm_bytes:.6e}; the cpu "
                           f"{b.flops:.6e}, {b.hbm_bytes:.6e}; ops apart (card, cpu): {json.dumps(diff)[:3000]}")
        print(f"cost of the reduced {arch} {shape} cell: card == cpu, flops {a.flops:.6e}, bytes "
              f"{a.hbm_bytes:.6e}, collectives {a.collectives} ({len(on_card.by_op)} op kinds; kernel launches "
              f"{counts})")
        summary[f"{arch} {shape}"] = {"flops": a.flops, "hbm_bytes": a.hbm_bytes, "ops": len(on_card.by_op)}
    phase("cost counted on the card == on the cpu, one reduced cell a family (14e)", t14)
    return summary


def world_lm_spec(shape: str, *, dtype: str | None = None, fsdp: bool = False, layers: int = WORLD_LM_LAYERS,
                  rows: int | None = None, spec=None):
    """tinyllama's spec (or ``spec``) cut for phases 15 and 16: ``layers``
    layers, and the cell's global batch set so that one production data
    rank's share (the batch a world runs) is ``rows`` rows (default
    ``WORLD_LM_ROWS``')."""
    import dataclasses

    from repro_torch.configs import get_spec
    from repro_torch.launch.dryrun import data_share
    from repro_torch.launch.mesh import make_production_mesh

    spec = spec or get_spec(LM_ARCH)
    cfg = dataclasses.replace(spec.model_cfg, n_layers=layers, fsdp=fsdp, dtype=dtype or spec.model_cfg.dtype)
    cell = spec.shapes[shape]
    _, n_data = data_share(1, make_production_mesh())
    kwargs = {**cell.kwargs, "global_batch": (rows or WORLD_LM_ROWS[shape]) * n_data}
    shapes = {**spec.shapes, shape: dataclasses.replace(cell, kwargs=kwargs)}
    return dataclasses.replace(spec, model_cfg=cfg, shapes=shapes)


def decode_record(torch, dev, mesh, shape: str, rows: int) -> dict:
    """One rank of a world: ``run_cell`` on tinyllama's ``shape`` (bfloat16)
    at full width and depth and ``rows`` rows under ``mesh``: wall ms, peak
    MiB, collective bytes and this rank's slice of the cache."""
    from repro_torch.launch import dryrun

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    spec = world_lm_spec(shape, layers=get_lm_layers(), rows=rows)
    rec = dryrun.run_cell(LM_ARCH, shape, verbose=False, dmesh=mesh, spec=spec)
    require(rec["status"] == "ok", f"rank {mesh.rank} {shape} {mesh}: {rec.get('error')}\n{rec.get('traceback')}")
    return {"wall_ms": rec["wall_ms"], "peak_mib": torch.cuda.max_memory_allocated(dev) / 2**20,
            "collectives": rec["collective_bytes_per_device"], "first_call_s": rec["first_call_s"],
            "cache_local": rec["input_shapes"][1]["k"]}


def decode_holds(torch, dev, mesh, shape: str, rows: int, lens, rel, *, dtype: str, layers: int,
                 exact: bool = False) -> list:
    """One rank of a world: tinyllama's ``shape`` cell in ``dtype`` at
    ``layers`` layers under ``mesh``, at each ``cache_len`` of ``lens`` on
    this rank's slices of one seeded input, held against the unsharded
    ``decode_step`` on the whole input on this rank: the logits, the
    written row of the new cache (from the rank whose slice holds it), and
    every other row of the rank's slice equal to the input's, bit for bit
    (the unsharded step leaves those rows as they were too), so the ranks'
    slices together hold the whole gathered cache to the unsharded one.
    With ``exact``, both steps' logits also against the unsharded step in
    float32 on the same weights and cache."""
    import dataclasses

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer
    from repro_torch.parallel.sharding import sanitize_specs, shard_tree
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    spec = world_lm_spec(shape, dtype=dtype, layers=layers, rows=rows)
    cell = build_cell(spec, shape, make_production_mesh(), mesh)
    # the cell's config: long_500k[swa]'s window is the cell's
    cfg = dataclasses.replace(spec.cfg_for(shape), sliding_window=spec.shapes[shape].kwargs.get("sliding_window"))
    params, cache, tokens, _ = dryrun.cell_inputs(cell, cfg, device=dev, batch=rows)
    my_params = shard_tree(params, cell.in_specs[0], mesh)
    my_tokens = shard_tree(tokens, sanitize_specs(cell.in_specs[2], tokens, mesh), mesh)
    s_all = cache["k"].shape[2]
    split = tuple(cell.in_specs[1]["k"])[2] == "model"
    s_loc = s_all // mesh.axis_size("model") if split else s_all
    off = mesh.coord("model") * s_loc if split else 0
    holds = []
    to32 = (lambda t: tree_map(lambda a: a.float() if a.is_floating_point() else a, t)) if exact else None
    for n in lens:
        local = shard_tree(cache, cell.in_specs[1], mesh)
        logits, new = cell.fn(my_params, local, my_tokens, torch.tensor(n, dtype=torch.int32, device=dev))
        row = min(n, s_all - 1) - off
        owns = 0 <= row < s_loc
        rest = all(torch.equal(new[k][:, :, :row], local[k][:, :, :row]) and
                   torch.equal(new[k][:, :, row + 1:], local[k][:, :, row + 1:]) if owns else
                   torch.equal(new[k], local[k]) for k in "kv")
        got_row = {k: new[k][:, :, row].clone() for k in "kv"} if owns else None
        del new, local
        with torch.no_grad():
            want_logits, want = transformer.decode_step(params, cache, tokens, n, cfg)
        holds.append({"cache_len": n, "owns_row": owns, "rest_equal": rest, "logits_rel": rel(logits, want_logits),
                      "row_rel": max(rel(got_row[k], want[k][:, :, row + off]) for k in "kv") if owns else None})
        del want
        if exact:
            with torch.no_grad():  # the float32 step's new cache (23.6 GB for long_500k[swa]) not kept
                logits32 = transformer.decode_step(to32(params), to32(cache), tokens, n, cfg)[0]
            holds[-1].update(exact_rel=rel(logits, logits32), exact_want_rel=rel(want_logits, logits32))
            del logits32
            gc.collect()
            torch.cuda.empty_cache()
    del params, cache, my_params
    gc.collect()
    torch.cuda.empty_cache()
    return holds




def get_lm_layers() -> int:
    """tinyllama's full depth (22 layers)."""
    from repro_torch.configs import get_spec

    return get_spec(LM_ARCH).model_cfg.n_layers


def world3_worker(out_dir: str) -> int:
    """One rank of phase 15's world of three (15f, ``--world3-worker
    DIR``): under 1x3 nothing of tinyllama splits over ``model``, so each
    rank runs the whole model; decode_32k at full depth (``decode_holds``)
    and a train_4k step at WORLD_LM_LAYERS layers, each against the
    unsharded run on the same rank.  Writes ``DIR/world3_rank<r>.json``."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.gather import gather_blocks
    from repro_torch.kernels.intersect import intersect_sorted
    from repro_torch.kernels.proximity import proximity_window
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.tree import tree_leaves

    m13 = make_device_mesh((1, 3), ("data", "model"), backend=WORLD_BACKEND, device="cuda")
    rank, dev = m13.rank, m13.device
    counted = {"proximity_window": proximity_window, "intersect_sorted": intersect_sorted,
               "gather_blocks": gather_blocks}
    for fn in counted.values():
        fn.launches = 0

    def rel(got, want) -> float:
        return float((got.float() - want.float()).norm() / max(float(want.float().norm()), 1e-30))

    t = time.perf_counter()
    shape, rows, lens = WORLD3_DECODE
    res: dict = {"rank": rank, "decode": {shape: {
        **decode_record(torch, dev, m13, shape, rows),
        "holds": decode_holds(torch, dev, m13, shape, rows, lens, rel, dtype="bfloat16", layers=get_lm_layers())}}}
    spec = world_lm_spec("train_4k")
    want = dryrun.run_cell(LM_ARCH, "train_4k", verbose=False, device=dev, repeats=1, spec=spec, keep_outputs=True)
    require(want["status"] == "ok", f"rank {rank} train_4k no mesh: {want.get('error')}")
    want_out = want.pop("outputs")
    torch.cuda.reset_peak_memory_stats(dev)
    rec = dryrun.run_cell(LM_ARCH, "train_4k", verbose=False, dmesh=m13, repeats=1, spec=spec, keep_outputs=True)
    require(rec["status"] == "ok", f"rank {rank} train_4k 1x3: {rec.get('error')}\n{rec.get('traceback')}")
    got = rec.pop("outputs")  # every leaf replicated: this rank's params are the whole tree
    res["train"] = {"wall_ms": rec["wall_ms"], "wall_ms_unsharded": want["wall_ms"],
                    "peak_mib": torch.cuda.max_memory_allocated(dev) / 2**20,
                    "collectives": rec["collective_bytes_per_device"],
                    "params_rel": max(rel(a, b) for a, b in zip(tree_leaves(got[0]), tree_leaves(want_out[0]))),
                    "metrics_rel": max(abs(float(got[2][k]) - float(want_out[2][k])) / max(abs(float(want_out[2][k])),
                                                                                          1e-30) for k in got[2])}
    del got, want_out
    res["launches"] = {f"world 1x3 LM decode and train (phase 15f), rank {rank}":
                       {kname: fn.launches for kname, fn in counted.items()}}
    res["s"] = time.perf_counter() - t
    (Path(out_dir) / f"world3_rank{rank}.json").write_text(json.dumps(res))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


def world_worker(out_dir: str) -> int:
    """One rank of phase 15's world of two (``python -m
    torch.distributed.run --nproc-per-node 2 chip_smoke.py --world-worker
    DIR``): (a) the paper_search serve cells under ``--mesh 1x2``, (b) the
    LM cells under 1x2 and 2x1 with FSDP against the unsharded run, (c) one
    olmoe MoE layer's ``local`` dispatch over model = 2, (d) the int8
    gradient all-reduce, card against the same world's CPU tensors, (e)
    tinyllama's decode cells context-parallel at full depth
    (``decode_holds``).  Writes
    its summary to ``DIR/rank<r>.json`` and rank 0's serve outputs to
    ``DIR/serve_<shape>.pt``."""
    import dataclasses

    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_spec
    from repro_torch.kernels.proximity import proximity_window
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_device_mesh, make_production_mesh, use_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import moe, transformer
    from repro_torch.kernels.gather import gather_blocks
    from repro_torch.kernels.intersect import intersect_sorted
    from repro_torch.optim import compressed_grad_allreduce
    from repro_torch.parallel.sharding import P, gather_tree, shard_tree
    from repro_torch.tree import tree_leaves, tree_map

    out = Path(out_dir)
    m12 = make_device_mesh((1, 2), ("data", "model"), backend=WORLD_BACKEND, device="cuda")
    m21 = make_device_mesh((2, 1), ("data", "model"), backend=WORLD_BACKEND, device="cuda")
    rank, dev = m12.rank, m12.device
    res: dict = {"rank": rank, "backend": WORLD_BACKEND, "device": str(dev), "serve": {}, "lm": {}, "launches": {}}
    counted = {"proximity_window": proximity_window, "intersect_sorted": intersect_sorted,
               "gather_blocks": gather_blocks}

    def zero_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts(path):
        res["launches"][path] = {kname: fn.launches for kname, fn in counted.items()}
        return res["launches"][path]

    def rel(got, want) -> float:
        return float((got.float() - want.float()).norm() / max(float(want.float().norm()), 1e-30))

    # ---- (a) the document-sharded serve cells ----
    t = time.perf_counter()
    for shape in WORLD_SERVE:
        zero_counts()
        rec = dryrun.run_cell("paper_search", shape, verbose=False, dmesh=m12, keep_outputs=True)
        launches = read_counts(f"world 1x2 paper_search {shape} (phase 15a), rank {rank}")["proximity_window"]
        require(rec["status"] == "ok", f"rank {rank} {shape}: {rec.get('error')}\n{rec.get('traceback')}")
        outs = {k: v.cpu() for k, v in rec.pop("outputs").items()}
        if rank == 0:
            torch.save(outs, out / f"serve_{shape}.pt")
        res["serve"][shape] = {"wall_ms": rec["wall_ms"], "calls": rec["calls"], "cover_launches": launches,
                               "collectives": rec["collective_bytes_per_device"], "peak_mib": rec["peak_bytes"] / 2**20,
                               "input_shapes": rec["input_shapes"],
                               "digest": hashlib.sha256(b"".join(outs[k].numpy().tobytes() for k in sorted(outs)))
                               .hexdigest()}
    res["serve_s"] = time.perf_counter() - t

    # ---- (b) the LM cells: 1x2 (TP) and 2x1 with FSDP against no mesh ----
    t = time.perf_counter()
    layout = make_production_mesh()
    zero_counts()
    for shape in WORLD_LM_CELLS:
        for dtype in ((None, "float32") if shape == "train_4k" else (None,)):
            base = world_lm_spec(shape, dtype=dtype)
            want = dryrun.run_cell(LM_ARCH, shape, verbose=False, device=dev, repeats=1, spec=base,
                                   keep_outputs=True)
            require(want["status"] == "ok", f"rank {rank} {shape} no mesh: {want.get('error')}")
            want_out = want.pop("outputs")
            for mesh, fsdp in ((m12, False), (m21, True)):
                spec = world_lm_spec(shape, dtype=dtype, fsdp=fsdp)
                torch.cuda.reset_peak_memory_stats(dev)
                rec = dryrun.run_cell(LM_ARCH, shape, verbose=False, dmesh=mesh, repeats=1, spec=spec,
                                      keep_outputs=True)
                require(rec["status"] == "ok", f"rank {rank} {shape} {mesh}: {rec.get('error')}\n{rec.get('traceback')}")
                got = rec.pop("outputs")
                cell = build_cell(spec, shape, layout, mesh)
                key = f"{shape} {dtype or 'bfloat16'} {mesh}{' fsdp' if fsdp else ''}"
                entry = {"wall_ms": rec["wall_ms"], "wall_ms_unsharded": want["wall_ms"],
                         "peak_mib": torch.cuda.max_memory_allocated(dev) / 2**20,
                         "collectives": rec["collective_bytes_per_device"], "batch": rec["input_shapes"][-1]}
                if shape == "train_4k":
                    params = gather_tree(got[0], cell.in_specs[0], mesh)
                    entry["params_rel"] = max(rel(a, b) for a, b in zip(tree_leaves(params), tree_leaves(want_out[0])))
                    entry["metrics"] = {k: float(v) for k, v in got[2].items()}
                    entry["metrics_want"] = {k: float(v) for k, v in want_out[2].items()}
                    entry["metrics_rel"] = max(abs(entry["metrics"][k] - entry["metrics_want"][k])
                                               / max(abs(entry["metrics_want"][k]), 1e-30) for k in entry["metrics"])
                else:
                    logits, cache = got
                    b0 = mesh.coord("data") * logits.shape[0]
                    entry["logits_rel"] = rel(logits, want_out[0][b0:b0 + logits.shape[0]])
                    entry["cache_rel"] = max(rel(cache[k], want_out[1][k][:, b0:b0 + logits.shape[0]]) for k in "kv")
                res["lm"][key] = entry
                del got
            del want_out
            torch.cuda.empty_cache()
    res["lm_s"] = time.perf_counter() - t
    read_counts(f"world 1x2 and 2x1 LM cells (phase 15b), rank {rank}")

    # ---- (c) one olmoe MoE layer, `local` over model = 2 ----
    t = time.perf_counter()
    mspec = get_spec(MOE_ARCH)
    mcfg = mspec.model_cfg.moe
    gen = torch.Generator(device="cpu").manual_seed(7)
    res["moe"] = {}
    zero_counts()
    for dtype in (torch.float32, torch.bfloat16):
        full = tree_map(lambda a: a.to(dev), moe.init_moe_params(gen.manual_seed(7), mspec.model_cfg.d_model, mcfg,
                                                                 dtype))
        # a direction every token shares skews the routing, so the config's
        # capacity drops pairs
        x = torch.randn((1, WORLD_MOE_TOKENS, mspec.model_cfg.d_model), generator=gen.manual_seed(8))
        x = (x + 2.0 * torch.randn((mspec.model_cfg.d_model,), generator=gen)).to(dev, dtype)
        specs = {"router": P(), "w_gate": P("model"), "w_up": P("model"), "w_down": P("model")}
        local = shard_tree(full, specs, m12)
        nodrop = dataclasses.replace(mcfg, capacity_factor=MOE_NO_DROP, dispatch="local")
        want_y, want_aux = moe._moe_sort(x.reshape(-1, x.shape[-1]), full, nodrop)
        with use_mesh(m12):
            y, aux = moe.moe_ffn(x, local, nodrop)
            dropped = moe.dropped_slots(x, local, dataclasses.replace(mcfg, dispatch="local"))
            dropped_cpu = moe.dropped_slots(x.cpu(), {"router": local["router"].cpu()},
                                            dataclasses.replace(mcfg, dispatch="local"))
            y_cap, _ = moe.moe_ffn(x, local, dataclasses.replace(mcfg, dispatch="local"))
        name = str(dtype).replace("torch.", "")
        res["moe"][name] = {"y_rel": rel(y.reshape(want_y.shape), want_y), "aux": float(aux), "aux_want": float(want_aux),
                            "dropped": int(dropped.sum()), "dropped_equal_cpu": bool(torch.equal(dropped.cpu(), dropped_cpu)),
                            "y_cap_finite": bool(torch.isfinite(y_cap).all())}
        del full, local
    res["moe_s"] = time.perf_counter() - t
    read_counts(f"world 1x2 olmoe MoE layer (phase 15c), rank {rank}")

    # ---- (d) the int8 gradient all-reduce over `pod` ----
    t = time.perf_counter()
    mpod = make_device_mesh((2, 1, 1), ("pod", "data", "model"), backend=WORLD_BACKEND, device="cuda")
    cspec = get_spec(LM_ARCH)
    shapes = transformer.param_shapes(dataclasses.replace(cspec.model_cfg, n_layers=WORLD_COMPRESS_LAYERS))
    gen = torch.Generator(device="cpu").manual_seed(1000 + rank)
    grads_cpu = tree_map(lambda m: torch.randn(m.shape, generator=gen) * 1e-3, shapes)
    err_cpu = tree_map(lambda g: torch.randn(g.shape, generator=gen) * 1e-5, grads_cpu)
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    g_dev, e_dev = tree_map(lambda a: a.to(dev), grads_cpu), tree_map(lambda a: a.to(dev), err_cpu)
    torch.cuda.synchronize(dev)
    ev0.record()
    out_dev, err_dev = compressed_grad_allreduce(g_dev, e_dev, mpod, "pod")
    ev1.record()
    ev1.synchronize()
    out_cpu, err_new_cpu = compressed_grad_allreduce(grads_cpu, err_cpu, mpod, "pod")
    res["compress"] = {
        "leaves": len(tree_leaves(grads_cpu)), "elements": sum(g.numel() for g in tree_leaves(grads_cpu)),
        "ms": ev0.elapsed_time(ev1),
        "out_equal": all(torch.equal(a.cpu(), b) for a, b in zip(tree_leaves(out_dev), tree_leaves(out_cpu))),
        "err_equal": all(torch.equal(a.cpu(), b) for a, b in zip(tree_leaves(err_dev), tree_leaves(err_new_cpu))),
        "s": time.perf_counter() - t}

    # ---- (e) context-parallel decode at full width and depth ----
    t = time.perf_counter()
    zero_counts()
    res["decode"] = {}
    for shape, (rows, lens) in WORLD_DECODE.items():
        res["decode"][shape] = decode_record(torch, dev, m12, shape, rows)
        res["decode"][shape]["holds"] = {
            f"{dtype} {layers}": decode_holds(torch, dev, m12, shape, rows, lens, rel, dtype=dtype, layers=layers,
                                              exact=(shape, dtype, layers) in WORLD_DECODE_EXACT)
            for dtype, layers, _ in WORLD_DECODE_HOLDS[shape]}
    read_counts(f"world 1x2 context-parallel decode (phase 15e), rank {rank}")
    res["decode_s"] = time.perf_counter() - t
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the dry-run's command line on the context-parallel decode_32k at
    # full size, in this world (a process group it finds up is the one its
    # --mesh runs on; it tears the group down when it is done) ----
    try:
        dryrun.main(["--arch", LM_ARCH, "--shape", "decode_32k", "--mesh", "1x2", "--backend", WORLD_BACKEND,
                     "--out", str(out / "dryrun_decode")])
    except SystemExit as e:
        require(e.code == 0, f"rank {rank}: the dry-run CLI exited {e.code}")
    return 0


def decode_holds_check(label: str, per_rank: list, owners: int, bound: float) -> None:
    """Print and require ``decode_holds``' results of every rank: the logits
    and the written row within ``bound`` relative, the rest of each slice
    equal to the input's, and the written row held by ``owners`` ranks (the
    one whose slice holds it, or every rank where the cache is whole)."""
    for i, n in enumerate(h["cache_len"] for h in per_rank[0]):
        holds = [e[i] for e in per_rank]
        rows = [h["row_rel"] for h in holds if h["owns_row"]]
        logits = ", ".join(f"{h['logits_rel']:.2e}" for h in holds)
        written = ", ".join(f"{x:.2e}" for x in rows)
        print(f"{label} cache_len {n}: logits rel {logits} (a rank each), written row rel {written} ({len(rows)} "
              f"rank(s) hold it), the rest of every slice equal to the input: {all(h['rest_equal'] for h in holds)}")
        require(len(rows) == owners and all(x <= bound for x in rows), f"{label} cache_len {n}: written row")
        require(all(h["rest_equal"] and h["logits_rel"] <= bound for h in holds), f"{label} cache_len {n}")
        if "exact_rel" in holds[0]:
            print(f"{label} cache_len {n}: logits rel to the float32 step on the same weights and cache: sharded "
                  + ", ".join(f"{h['exact_rel']:.2e}" for h in holds) + ", unsharded "
                  + ", ".join(f"{h['exact_want_rel']:.2e}" for h in holds) + " (a rank each)")
            require(all(h["exact_rel"] <= h["exact_want_rel"] + LM_BF16_REL for h in holds),
                    f"{label} cache_len {n}: the sharded step farther from float32 than the unsharded one + 2e-2")


def world_start(procs: list, argv: list[str], env: dict | None = None):
    """``python -m torch.distributed.run --standalone --nproc-per-node N
    <argv>`` (the world's processes import torch and the port only), with
    ``env`` added to the environment."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "4", **(env or {})}
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", *argv], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs.append(proc)
    return proc, time.perf_counter()


def world_finish(started, label: str, timeout: float = 600) -> str:
    proc, t_start = started
    out, err = proc.communicate(timeout=timeout)
    # a failed rank's own traceback comes before the launcher's report of it
    first = err.find("Traceback (most recent call last)")
    require(proc.returncode == 0, f"{label} exited {proc.returncode}: {out[-3000:]}\n"
                                  f"{err[first:first + 6000] if first >= 0 else ''}\n...\n{err[-1500:]}")
    print(f"{label}: {time.perf_counter() - t_start:.1f} s (process wall)")
    return out


def world_phase(torch, dev, path_launches: dict) -> dict:
    """Phase 15 (see the module docstring), its worlds' launch counts added
    to ``path_launches``; returns its summary."""
    import torch.distributed as dist

    from repro_torch.kernels.proximity import proximity_window
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.tree import tree_leaves

    t15 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    summary: dict = {"backend_world2": WORLD_BACKEND, "backend_world1": "nccl"}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_world_"))
    procs: list = []
    try:
        # ---- a world of one over NCCL: bit for bit the port without a mesh ----
        dist.init_process_group("nccl", init_method=f"file://{work / 'nccl1'}", rank=0, world_size=1)
        m1 = make_device_mesh((1, 1), ("data", "model"), backend="nccl", device="cuda")
        same = {}
        for arch, shape, spec in [("paper_search", "serve_online", None)] + [
                (LM_ARCH, s, world_lm_spec(s)) for s in WORLD_LM_CELLS]:
            a = dryrun.run_cell(arch, shape, verbose=False, device=dev, repeats=0, spec=spec, keep_outputs=True)
            b = dryrun.run_cell(arch, shape, verbose=False, dmesh=m1, repeats=0, spec=spec, keep_outputs=True)
            require(a["status"] == "ok" and b["status"] == "ok", f"{shape}: {a.get('error')} {b.get('error')}")
            la, lb = tree_leaves(a["outputs"]), tree_leaves(b["outputs"])
            same[shape] = len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))
            require(same[shape], f"world of one (nccl) {shape} != no mesh")
            require(b["collective_total_per_device"] == 0, f"world of one counted collectives {b['collective_bytes_per_device']}")
        dist.destroy_process_group()
        print(f"world of one over nccl == no mesh, bit for bit: {same}")
        summary["world1_equal"] = same
        # the one-program fold of the serve cells, for the world of two
        fold = {}
        for shape in WORLD_SERVE:
            rec = dryrun.run_cell("paper_search", shape, verbose=False, device=dev, keep_outputs=True)
            require(rec["status"] == "ok", f"{shape}: {rec.get('error')}")
            fold[shape] = {k: v.cpu() for k, v in rec.pop("outputs").items()}
            print(f"15a {shape}, the one-program fold of 256 shards (no mesh): wall "
                  f"{[round(x, 3) for x in rec['wall_ms']]} ms, peak {rec['peak_bytes'] / 2**20:.1f} MiB")
        gc.collect()
        torch.cuda.empty_cache()
        t15 = phase("world of one over nccl, the one-program fold (15)", t15)

        world = world_start(procs, ["--nproc-per-node", "2", str(ROOT / "chip_smoke.py"), "--world-worker", str(work)])
        world_out = world_finish(world, "world of two (gloo on the card, chip_smoke.py --world-worker)")
        ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
        # the dry-run CLI's main on decode_32k, the world's last act
        rec = json.loads(next((work / "dryrun_decode").glob("*.json")).read_text())
        require(rec["status"] == "ok" and rec["device_mesh"] == "1x2" and rec["backend"] == WORLD_BACKEND,
                f"the decode dry-run CLI's record: {rec.get('status')} {rec.get('device_mesh')}")
        print("  " + " | ".join(ln for ln in world_out.splitlines() if ln.startswith("[dryrun]")))
        # ---- (a) serving ----
        for shape in WORLD_SERVE:
            got = torch.load(work / f"serve_{shape}.pt")
            want = fold[shape]
            require(torch.equal(got["top_docs"], want["top_docs"]), f"{shape}: world top_docs != the fold's")
            require(torch.equal(got["n_fragments"], want["n_fragments"]), f"{shape}: world n_fragments != the fold's")
            require(torch.allclose(got["top_scores"], want["top_scores"], rtol=1e-5, atol=0),
                    f"{shape}: world top_scores != the fold's")
            require(ranks[0]["serve"][shape]["digest"] == ranks[1]["serve"][shape]["digest"],
                    f"{shape}: the ranks returned different results")
            for r in ranks:
                e = r["serve"][shape]
                require(e["cover_launches"] == e["calls"], f"rank {r['rank']} {shape}: {e['cover_launches']} cover "
                                                           f"launches in {e['calls']} calls")
                print(f"15a {shape} rank {r['rank']} ({WORLD_BACKEND}, mesh 1x2): wall {[round(x, 3) for x in e['wall_ms']]}"
                      f" ms, cover launches {e['cover_launches']} in {e['calls']} calls, all-gather "
                      f"{json.dumps(e['collectives'])} B, peak {e['peak_mib']:.1f} MiB, inputs {e['input_shapes'][:2]}")
            print(f"15a {shape}: top_docs and n_fragments == the one-program fold, top_scores within rtol 1e-5")
        summary["serve"] = {shape: [r["serve"][shape] for r in ranks] for shape in WORLD_SERVE}
        for r in ranks:
            path_launches.update(r["launches"])
            for path, counts in r["launches"].items():
                if "15a" not in path:
                    require(all(v == 0 for v in counts.values()), f"{path} launched a search kernel: {counts}")
        # ---- (b) the LM cells ----
        for key, e in ranks[0]["lm"].items():
            f32 = "float32" in key
            for r in ranks:
                ee = r["lm"][key]
                print(f"15b {key} rank {r['rank']} ({WORLD_BACKEND}): batch {json.dumps(ee['batch'])}, wall "
                      f"{[round(x, 1) for x in ee['wall_ms']]} ms (unsharded on this rank "
                      f"{[round(x, 1) for x in ee['wall_ms_unsharded']]} ms), peak {ee['peak_mib']:.1f} MiB, "
                      f"collectives {json.dumps(ee['collectives'])} B")
            if "train_4k" in key:
                tol_p = 1e-5 if f32 else LM_BF16_REL
                tol_m = 1e-4 if f32 else LM_BF16_REL
                print(f"15b {key}: metrics {e['metrics']} vs no mesh {e['metrics_want']} (rel {e['metrics_rel']:.2e}), "
                      f"params rel {e['params_rel']:.2e}")
                require(e["metrics_rel"] <= tol_m and e["params_rel"] <= tol_p, f"15b {key}: beyond tolerance")
            else:
                for r in ranks:
                    ee = r["lm"][key]
                    print(f"15b {key} rank {r['rank']}: logits rel {ee['logits_rel']:.2e}, cache rel {ee['cache_rel']:.2e}")
                    require(ee["logits_rel"] <= LM_BF16_REL and ee["cache_rel"] <= LM_BF16_REL, f"15b {key}: beyond 2e-2")
        summary["lm"] = {key: [r["lm"][key] for r in ranks] for key in ranks[0]["lm"]}
        # ---- (c) MoE and (d) compression ----
        for r in ranks:
            for name, e in r["moe"].items():
                tol = 1e-5 if name == "float32" else LM_BF16_REL
                print(f"15c olmoe layer {name} rank {r['rank']}: local (1x2) vs sort, no drops: y rel {e['y_rel']:.2e}, "
                      f"aux {e['aux']:.6f} vs {e['aux_want']:.6f}; at the config's capacity {e['dropped']} pairs dropped, "
                      f"== the same world on the CPU: {e['dropped_equal_cpu']}")
                require(e["y_rel"] <= tol and e["dropped_equal_cpu"] and e["y_cap_finite"], f"15c {name} rank {r['rank']}")
                require(abs(e["aux"] - e["aux_want"]) <= 1e-4 * abs(e["aux_want"]), f"15c {name}: aux")
            c = r["compress"]
            print(f"15d compressed_grad_allreduce rank {r['rank']}: {c['leaves']} leaves, {c['elements']:,} elements, "
                  f"{c['ms']:.1f} ms on the card; output == cpu {c['out_equal']}, residual == cpu {c['err_equal']}")
            require(c["out_equal"] and c["err_equal"], f"15d rank {r['rank']}: card != cpu")
        summary["moe"] = [r["moe"] for r in ranks]
        summary["compress"] = [r["compress"] for r in ranks]
        # ---- (e) context-parallel decode ----
        for shape in WORLD_DECODE:
            for r in ranks:
                e = r["decode"][shape]
                print(f"15e {shape} rank {r['rank']} ({WORLD_BACKEND}, mesh 1x2, all layers): cache slice "
                      f"{e['cache_local']}, wall {[round(x, 3) for x in e['wall_ms']]} ms, first call "
                      f"{e['first_call_s']} s, peak {e['peak_mib']:.1f} MiB, collectives {json.dumps(e['collectives'])} B")
            for dtype, layers, bound in WORLD_DECODE_HOLDS[shape]:
                decode_holds_check(f"15e {shape} {dtype} at {layers} layers (bound {bound:g})",
                                   [r["decode"][shape]["holds"][f"{dtype} {layers}"] for r in ranks], 1, bound)
        summary["decode"] = {shape: [r["decode"][shape] for r in ranks] for shape in WORLD_DECODE}
        summary["worker_s"] = {k: [r[k] for r in ranks] for k in ("serve_s", "lm_s", "moe_s", "decode_s")}
        t15 = phase("world of two: serving, LM, MoE, compression, decode (15a-e)", t15)

        # ---- the entry points' own command lines in worlds of two, beside
        # (f) the world of three ----
        dry = world_start(procs, ["--nproc-per-node", "2", "-m", "repro_torch.launch.dryrun", "--arch", "paper_search",
                                  "--shape", "serve_online", "--mesh", "1x2", "--backend", WORLD_BACKEND,
                                  "--out", str(work / "dryrun")])
        train = world_start(procs, ["--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--arch", LM_ARCH,
                                    "--steps", "2", "--mesh", "1x2", "--backend", WORLD_BACKEND])
        # the trainer's command line on a recsys and the GNN model (reduced
        # configs): fm's table row-sharded, gat-cora's edges split
        family_cli = {arch: world_start(procs, ["--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--arch",
                                                arch, "--steps", "2", "--mesh", "1x2", "--backend", WORLD_BACKEND])
                      for arch in ("fm", "gat-cora")}
        world3 = world_start(procs, ["--nproc-per-node", "3", str(ROOT / "chip_smoke.py"), "--world3-worker",
                                     str(work)])
        dry_out = world_finish(dry, "python -m torch.distributed.run -m repro_torch.launch.dryrun --mesh 1x2")
        rec = json.loads(next((work / "dryrun").glob("*.json")).read_text())
        require(rec["status"] == "ok" and rec["device_mesh"] == "1x2" and rec["backend"] == WORLD_BACKEND,
                f"the dry-run CLI's record: {rec.get('status')} {rec.get('device_mesh')}")
        print("  " + " | ".join(ln for ln in dry_out.splitlines() if ln.startswith("[dryrun]")))
        train_out = world_finish(train, "python -m torch.distributed.run -m repro_torch.launch.train --mesh 1x2")
        steps = [ln for ln in train_out.splitlines() if ln.startswith(("step", "done"))]
        print("  " + " | ".join(steps))
        require(len(steps) == 3, f"the trainer printed {steps}")
        for arch, started in family_cli.items():
            cli_out = world_finish(started, f"python -m torch.distributed.run -m repro_torch.launch.train --arch {arch} "
                                            "--mesh 1x2")
            steps = [ln for ln in cli_out.splitlines() if ln.startswith(("step", "done"))]
            print("  " + " | ".join(steps))
            require([ln.split()[:2] for ln in steps] == [["step", "0"], ["step", "1"], ["done:", "2"]]
                    and all(math.isfinite(float(kv.split("=")[1])) for ln in steps[:2] for kv in ln.split()[2:]),
                    f"the {arch} trainer printed {steps}")
        world_finish(world3, "world of three (gloo on the card, chip_smoke.py --world3-worker)")
        # ---- (f) the world of three ----
        ranks3 = [json.loads((work / f"world3_rank{r}.json").read_text()) for r in range(3)]
        shape = WORLD3_DECODE[0]
        for r in ranks3:
            e, tr = r["decode"][shape], r["train"]
            print(f"15f {shape} rank {r['rank']} ({WORLD_BACKEND}, mesh 1x3, all layers, the cache whole): wall "
                  f"{[round(x, 3) for x in e['wall_ms']]} ms, first call {e['first_call_s']} s, peak "
                  f"{e['peak_mib']:.1f} MiB, collectives {json.dumps(e['collectives'])} B")
            print(f"15f train_4k rank {r['rank']} (mesh 1x3, {WORLD_LM_LAYERS} layers, {WORLD_LM_ROWS['train_4k']} rows): wall "
                  f"{[round(x, 1) for x in tr['wall_ms']]} ms (unsharded on this rank "
                  f"{[round(x, 1) for x in tr['wall_ms_unsharded']]} ms), peak {tr['peak_mib']:.1f} MiB, collectives "
                  f"{json.dumps(tr['collectives'])} B; metrics rel {tr['metrics_rel']:.2e}, params rel "
                  f"{tr['params_rel']:.2e}")
            require(tr["metrics_rel"] <= LM_BF16_REL and tr["params_rel"] <= LM_BF16_REL, "15f train_4k: beyond 2e-2")
            path_launches.update(r["launches"])
            for path, counts in r["launches"].items():
                require(all(v == 0 for v in counts.values()), f"{path} launched a search kernel: {counts}")
        decode_holds_check(f"15f {shape} bfloat16 at all layers", [r["decode"][shape]["holds"] for r in ranks3], 3,
                           LM_BF16_REL)
        summary["world3"] = ranks3
        phase("the dry-run and trainer command lines in worlds of two, the world of three (15f)", t15)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return summary


def family_file(work: Path, arch: str, shape: str) -> Path:
    return work / f"unsharded_{arch}_{shape}.pt"


def family_spec(arch: str, cuts: dict | None = None):
    """The full spec of ``arch``, its cells cut as ``cuts`` (default
    FAMILY_CUTS) says."""
    import dataclasses

    from repro_torch.configs import get_spec

    spec = get_spec(arch)
    shapes = dict(spec.shapes)
    for (a, shape), kwargs in (FAMILY_CUTS if cuts is None else cuts).items():
        if a == arch:
            shapes[shape] = dataclasses.replace(shapes[shape], kwargs={**shapes[shape].kwargs, **kwargs})
    return dataclasses.replace(spec, shapes=shapes)


def family_within(got, want, tol: dict) -> dict:
    """How far ``got`` lies from ``want`` (tensors, or trees of them):
    the largest absolute error and the elements beyond ``tol``'s atol +
    rtol |want|."""
    from repro_torch.tree import tree_leaves

    worst, beyond = 0.0, 0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.float(), b.to(a.device).float()
        err = (a - b).abs()
        if err.numel():
            worst = max(worst, float(err.max()))
            beyond += int((err > tol["atol"] + tol["rtol"] * b.abs()).sum())
    return {"max_abs": worst, "beyond": beyond}


def family_cells(torch, dev, work: Path, cells, meshes: dict, cuts: dict | None = None, spy: bool = False) -> dict:
    """One rank of a world: each (arch, shape, mesh) of ``cells`` at full
    width under ``meshes[mesh]``, against the unsharded step's outputs that
    ``family_unsharded`` saved in ``work`` (this rank's slices of them):
    loss (and accuracy), the new params or the scores, with wall ms, peak
    MiB and the counted collectives a rank; with ``spy``, also the largest
    collective's time and bus bandwidth (``CollectiveSpy``)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.parallel.sharding import P, shard_tree

    res = {}
    for arch, shape, mesh_shape in cells:
        mesh = meshes[mesh_shape]
        spec = family_spec(arch, cuts)
        cell = build_cell(spec, shape, make_production_mesh(), mesh)
        want = torch.load(family_file(work, arch, shape), mmap=True, weights_only=False)
        torch.cuda.synchronize(dev)
        with CollectiveSpy(torch, dev) if spy else contextlib.nullcontext() as seen:
            rec = dryrun.run_cell(arch, shape, verbose=False, dmesh=mesh, keep_outputs=True, spec=spec,
                                  repeats=0 if (arch, shape) in FAMILY_ONE_CALL else 1)
        require(rec["status"] == "ok", f"rank {mesh.rank} {arch} {shape} {mesh}: {rec.get('error')}\n"
                                       f"{rec.get('traceback')}")
        out = rec.pop("outputs")
        e = {"mesh": str(mesh), "wall_ms": rec["wall_ms"] or [rec["first_call_s"] * 1e3],
             "counted_call_only": not rec["wall_ms"], "first_call_s": rec["first_call_s"],
             "peak_mib": rec["peak_bytes"] / 2**20, "collectives": rec["collective_bytes_per_device"],
             "inputs": rec["input_shapes"][-1]}
        if spy:
            e["peak_mib_rank"] = torch.cuda.max_memory_allocated(dev) / 2**20
            e["largest"] = seen.largest()
        if cell.step == "train":
            new, _, metrics = out
            e["metrics"] = {k: float(v) for k, v in metrics.items()}
            e["metrics_want"] = want["metrics"]
            e["metrics_fwd"] = {k: abs(e["metrics"][k] - w) <= FAMILY_FWD["atol"] + FAMILY_FWD["rtol"] * abs(w)
                                for k, w in want["metrics"].items()}
            e["params"] = family_within(new, shard_tree(want["params"], cell.in_specs[0], mesh), FAMILY_STEP)
        else:
            cand = cell.in_specs[1]["cand_ids"]
            e["scores"] = family_within(out, shard_tree({"s": want["scores"]}, {"s": P(*cand)}, mesh)["s"],
                                        FAMILY_FWD)
        res[f"{arch} {shape} {mesh}"] = e
        del out, want, rec
        gc.collect()
        torch.cuda.empty_cache()
    return res


def family_worker(out_dir: str) -> int:
    """One rank of phase 15's second world of two (``--family-worker DIR``):
    (g) the recsys cells of FAMILY_RECSYS and (h) the GNN cells of
    FAMILY_GNN at full size under their meshes (``family_cells``).  Writes
    ``DIR/family_rank<r>.json``."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.gather import gather_blocks
    from repro_torch.kernels.intersect import intersect_sorted
    from repro_torch.kernels.proximity import proximity_window
    from repro_torch.launch.mesh import make_device_mesh

    work = Path(out_dir)
    meshes = {(1, 2): make_device_mesh((1, 2), ("data", "model"), backend=WORLD_BACKEND, device="cuda"),
              (2, 1): make_device_mesh((2, 1), ("data", "model"), backend=WORLD_BACKEND, device="cuda")}
    rank, dev = meshes[(1, 2)].rank, meshes[(1, 2)].device
    counted = {"proximity_window": proximity_window, "intersect_sorted": intersect_sorted,
               "gather_blocks": gather_blocks}
    res: dict = {"rank": rank, "cells": {}, "launches": {}, "s": {}}
    for label, cells in (("15g", FAMILY_RECSYS), ("15h", FAMILY_GNN)):
        t = time.perf_counter()
        for fn in counted.values():
            fn.launches = 0
        res["cells"].update(family_cells(torch, dev, work, cells, meshes))
        res["launches"][f"world of two, {label} {'recsys' if label == '15g' else 'GNN'} cells, rank {rank}"] = {
            kname: fn.launches for kname, fn in counted.items()}
        res["s"][label] = time.perf_counter() - t
    (work / f"family_rank{rank}.json").write_text(json.dumps(res))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


def family_unsharded(torch, dev, work: Path, cells, cuts: dict | None = None) -> dict:
    """The unsharded step of each (arch, shape) of ``cells`` on ``dev``
    (cut as ``family_spec(arch, cuts)``), its new params and metrics (or its
    scores) saved to ``work`` on the host; their wall ms and peak MiB."""
    from repro_torch.launch import dryrun
    from repro_torch.tree import tree_map

    summary = {}
    for arch, shape in dict.fromkeys((a, s) for a, s, _ in cells):
        gc.collect()
        torch.cuda.empty_cache()
        one = (arch, shape) in FAMILY_ONE_CALL
        rec = dryrun.run_cell(arch, shape, verbose=False, device=dev, repeats=0 if one else 1, keep_outputs=True,
                              spec=family_spec(arch, cuts))
        require(rec["status"] == "ok", f"{arch} {shape} unsharded: {rec.get('error')}\n{rec.get('traceback')}")
        out = rec.pop("outputs")
        if isinstance(out, tuple):  # a train step: (params, optimizer state, metrics)
            out = {"params": tree_map(lambda x: x.cpu(), out[0]), "metrics": {k: float(v) for k, v in out[2].items()}}
        else:
            out = {"scores": out.cpu()}
        torch.save(out, family_file(work, arch, shape))
        summary[f"{arch} {shape}"] = {
            "wall_ms": rec["wall_ms"] or [rec["first_call_s"] * 1e3], "peak_mib": rec["peak_bytes"] / 2**20}
        del out, rec
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def family_world_phase(torch, dev, path_launches: dict) -> dict:
    """Phase 15g and 15h (see the module docstring): the unsharded steps on
    the card, their outputs to the host, then the world of two; returns
    the summary, its worlds' launch counts added to ``path_launches``."""
    t = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_family_"))
    procs: list = []
    summary: dict = {"unsharded": {}}
    try:
        summary["unsharded"] = family_unsharded(torch, dev, work, FAMILY_RECSYS + FAMILY_GNN)
        t = phase("recsys and GNN unsharded steps at full size, their outputs to the host (15g, 15h)", t)
        world = world_start(procs, ["--nproc-per-node", "2", str(ROOT / "chip_smoke.py"), "--family-worker",
                                    str(work)])
        world_finish(world, "world of two (gloo on the card, chip_smoke.py --family-worker)")
        ranks = [json.loads((work / f"family_rank{r}.json").read_text()) for r in range(2)]
        for r in ranks:
            path_launches.update(r["launches"])
            for path, counts in r["launches"].items():
                require(all(v == 0 for v in counts.values()), f"{path} launched a search kernel: {counts}")
        for arch, shape, mesh in FAMILY_RECSYS + FAMILY_GNN:
            key = f"{arch} {shape} {mesh[0]}x{mesh[1]}"
            label = "15g" if (arch, shape, mesh) in FAMILY_RECSYS else "15h"
            want = summary["unsharded"][f"{arch} {shape}"]
            for r in ranks:
                e = r["cells"][key]
                held = e["metrics_fwd"] if "metrics_fwd" in e else {}
                close = e.get("params", e.get("scores"))
                print(f"{label} {key} rank {r['rank']} ({WORLD_BACKEND}): wall {[round(x, 3) for x in e['wall_ms']]} ms"
                      f"{' (the counted call)' if e['counted_call_only'] else ''} (unsharded "
                      f"{[round(x, 3) for x in want['wall_ms']]} ms, {want['peak_mib']:.1f} MiB), peak "
                      f"{e['peak_mib']:.1f} MiB, collectives {json.dumps(e['collectives'])} B; "
                      + (f"metrics {e['metrics']} vs {e['metrics_want']}; " if held else "")
                      + f"{'params after the step' if 'params' in e else 'scores'}: max abs {close['max_abs']:.3e}, "
                        f"{close['beyond']} beyond tolerance")
                require(all(held.values()) and close["beyond"] == 0,
                        f"{label} {key} rank {r['rank']}: beyond the float32 tolerances")
        summary["cells"] = {k: [r["cells"][k] for r in ranks] for k in ranks[0]["cells"]}
        summary["worker_s"] = [r["s"] for r in ranks]
        phase("world of two: recsys (15g) and GNN (15h) cells at full size == unsharded", t)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return summary


class CollectiveSpy:
    """Within the ``with``: every all-reduce, all-gather and reduce-scatter
    that ``torch.distributed`` runs (the port's collectives call them through
    the module), each with its bytes (the whole tensor: an all-gather's
    output, a reduce-scatter's input), group and CUDA events around it.
    ``largest()`` (every rank of the world calls it) times the largest of
    them in the calls, and again alone after a barrier, as bus bandwidth."""

    NAMES = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter"}

    def __init__(self, torch, dev):
        self.torch, self.dev, self.calls, self._orig = torch, dev, [], {}

    def __enter__(self):
        import torch.distributed as dist

        for name in self.NAMES:
            self._orig[name] = getattr(dist, name)
            setattr(dist, name, self._wrap(name, self._orig[name]))
        return self

    def __exit__(self, *exc) -> None:
        import torch.distributed as dist

        for name, fn in self._orig.items():
            setattr(dist, name, fn)

    def _timed(self, fn):
        torch = self.torch
        if self.dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn()
            ev[1].record()
            return ev
        t = time.perf_counter()
        fn()
        return (t, time.perf_counter())

    @staticmethod
    def _elapsed(ev) -> float:
        if isinstance(ev[0], float):
            return (ev[1] - ev[0]) * 1e3
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1])

    def _wrap(self, name, fn):
        import torch.distributed as dist

        def call(*args, **kwargs):
            whole = args[1] if name == "reduce_scatter_tensor" else args[0]
            out = []
            ev = self._timed(lambda: out.append(fn(*args, **kwargs)))
            self.calls.append({"name": name, "shape": tuple(whole.shape), "dtype": whole.dtype,
                               "bytes": whole.numel() * whole.element_size(), "group": kwargs.get("group"),
                               "ranks": dist.get_world_size(kwargs.get("group")), "op": kwargs.get("op"),
                               "events": ev})
            return out[0]

        return call

    def largest(self, replays: int = 3) -> dict | None:
        """The largest collective (the first of the largest): its kind, ranks,
        bytes, least time in the calls, and that time replayed alone
        (``replays`` times after a warm-up and a barrier), each as bus
        bandwidth (nccl-tests' ``busbw``: bytes / time times 2(n-1)/n for an
        all-reduce, (n-1)/n for a gather or scatter)."""
        import torch.distributed as dist

        torch = self.torch
        if not self.calls:
            return None
        big = max(self.calls, key=lambda c: c["bytes"])
        same = [c for c in self.calls if (c["name"], c["shape"], c["dtype"], c["ranks"]) ==
                (big["name"], big["shape"], big["dtype"], big["ranks"])]
        in_call = min(self._elapsed(c["events"]) for c in same)
        n, fn = big["ranks"], self._orig[big["name"]]
        whole = torch.zeros(big["shape"], dtype=big["dtype"], device=self.dev)
        part = torch.zeros((big["shape"][0] // n, *big["shape"][1:]), dtype=big["dtype"], device=self.dev)
        kw = {"group": big["group"]} | ({"op": big["op"]} if big["op"] is not None else {})
        args = {"all_reduce": (whole,), "all_gather_into_tensor": (whole, part),
                "reduce_scatter_tensor": (part, whole)}[big["name"]]
        dist.barrier()
        fn(*args, **kw)
        alone = min(self._elapsed(self._timed(lambda: fn(*args, **kw))) for _ in range(replays))
        del whole, part
        factor = (2 if big["name"] == "all_reduce" else 1) * (n - 1) / n

        def busbw(ms: float) -> float:
            return big["bytes"] / (ms * 1e-3) * factor / 1e9 if ms > 0 else float("inf")

        return {"kind": self.NAMES[big["name"]], "ranks": n, "bytes": big["bytes"], "dtype": str(big["dtype"]),
                "calls": len(same), "in_call_ms": in_call, "in_call_busbw_gb_s": busbw(in_call),
                "alone_ms": alone, "alone_busbw_gb_s": busbw(alone)}


def largest_line(e: dict | None) -> str:
    """``CollectiveSpy.largest()``'s entry as one line, against NVLink."""
    if not e:
        return "no collective"
    return (f"largest collective {e['kind']} of {e['bytes']:,} B over {e['ranks']} ranks ({e['calls']} in the calls): "
            f"{e['in_call_ms']:.3f} ms in the call = {e['in_call_busbw_gb_s']:.1f} GB/s bus, alone "
            f"{e['alone_ms']:.3f} ms = {e['alone_busbw_gb_s']:.1f} GB/s bus "
            f"({e['alone_busbw_gb_s'] / NVLINK_GB_S:.1%} of NVLink's {NVLINK_GB_S:.0f} GB/s each way)")


def quad_lm_spec(shape: str, rows: int, *, fsdp: bool = False, unsharded: bool = False):
    """tinyllama's spec for 16b: phase 11's layers (LM_CELL_LAYERS) and a
    world batch of ``rows`` rows (``world_lm_spec``).  ``unsharded``: the
    train cell in microbatches of a rank's size (one data rank's share in
    the config's microbatches), so the step on the world's whole batch fits
    one card as a rank's share does."""
    import dataclasses

    spec = world_lm_spec(shape, fsdp=fsdp, layers=LM_CELL_LAYERS[shape], rows=rows)
    if unsharded and spec.shapes[shape].step == "train":
        micro = max(1, spec.model_cfg.microbatches)
        spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(
            spec.model_cfg, microbatches=micro * rows // QUAD_LM_SHARE[shape]))
    return spec


def quad_lm_rows() -> dict:
    """16b's world batches: each cell's rows for each data size of
    QUAD_LM_MESHES (one production data rank's share a data rank)."""
    return {shape: sorted({share * m[0] for m, _ in QUAD_LM_MESHES}) for shape, share in QUAD_LM_SHARE.items()}


def quad_lm_file(work: Path, shape: str, rows: int) -> Path:
    return work / f"lm_{shape}_{rows}.pt"


def quad_worker(out_dir: str) -> int:
    """One rank of phase 16's world of four (``python -m
    torch.distributed.run --nproc-per-node 4 chip_smoke.py --quad-worker
    DIR``), one rank a card over NCCL: (16a) the serve cells under 1x4 and
    2x2 and ``device_topk_merge``, (16b) tinyllama's train_4k and
    prefill_32k under QUAD_LM_MESHES, (16c) decode context-parallel over
    1x4 at 22 layers, (16d) one olmoe MoE layer over model = 4 and the int8
    gradient all-reduce over pod = 4, (16e) the recsys and (16f) the GNN
    cells at full size; each against the unsharded outputs phase 16 saved
    in DIR on one card (or, in 16c and 16d, this rank's own unsharded run).
    Writes ``DIR/quad_rank<r>.json``."""
    import dataclasses
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_spec
    from repro_torch.kernels.gather import gather_blocks
    from repro_torch.kernels.intersect import intersect_sorted
    from repro_torch.kernels.proximity import proximity_window
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_device_mesh, make_production_mesh, use_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import moe, transformer
    from repro_torch.optim import compressed_grad_allreduce
    from repro_torch.parallel.sharding import P, gather_tree, shard_tree
    from repro_torch.search import device_topk_merge
    from repro_torch.tree import tree_leaves, tree_map

    work = Path(out_dir)
    if QUAD_DEVICE == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(QUAD_BACKEND, timeout=datetime.timedelta(seconds=QUAD_TIMEOUT_S))
    meshes = {shape: make_device_mesh(shape, ("data", "model"), backend=QUAD_BACKEND, device=QUAD_DEVICE)
              for shape in ((1, 4), (2, 2), (4, 1))}
    rank, dev = dist.get_rank(), meshes[(1, 4)].device
    res: dict = {"rank": rank, "backend": dist.get_backend(), "device": str(dev),
                 "current_device": torch.cuda.current_device(), "launches": {}, "s": {}, "memory": {}}

    def note(label: str) -> None:
        """This rank's card memory at ``label``: free and total (as
        ``cudaMemGetInfo`` reports them), PyTorch's reserved bytes, and what
        neither holds (the CUDA context, NCCL's communicators and buffers)."""
        free, total = torch.cuda.mem_get_info(dev)
        reserved = torch.cuda.memory_reserved(dev)
        res["memory"][label] = {"free": free, "total": total, "reserved": reserved,
                                "other": total - free - reserved}
        print(f"rank {rank} {label}: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free, PyTorch reserves "
              f"{reserved / 2**30:.2f}, other {(total - free - reserved) / 2**30:.2f}", flush=True)

    # what one communicator costs the card: the default group's (all four
    # ranks) and a pair's, each at its first collective
    note("16 start")
    dist.barrier()
    note("16 after the world's communicator")
    one = torch.ones(1, device=dev)
    dist.all_reduce(one, group=meshes[(2, 2)].group("model"))
    note("16 after a pair's communicator")
    counted = {"proximity_window": proximity_window, "intersect_sorted": intersect_sorted,
               "gather_blocks": gather_blocks}

    def zero_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts(path):
        res["launches"][path] = {kname: fn.launches for kname, fn in counted.items()}
        return res["launches"][path]

    def rel(got, want) -> float:
        return float((got.float() - want.float()).norm() / max(float(want.float().norm()), 1e-30))

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    def run(arch, shape, mesh, **kwargs):
        """``run_cell`` under ``mesh`` with the collective spy: the record,
        the first call's outputs, and the entry phase 16 prints."""
        fresh()
        with CollectiveSpy(torch, dev) as spy:
            rec = dryrun.run_cell(arch, shape, verbose=False, dmesh=mesh, keep_outputs=True, **kwargs)
        require(rec["status"] == "ok", f"rank {rank} {arch} {shape} {mesh}: {rec.get('error')}\n{rec.get('traceback')}")
        out = rec.pop("outputs")
        return rec, out, {"mesh": str(mesh), "wall_ms": rec["wall_ms"], "first_call_s": rec["first_call_s"],
                          "peak_mib": torch.cuda.max_memory_allocated(dev) / 2**20,
                          "collectives": rec["collective_bytes_per_device"], "largest": spy.largest(),
                          "inputs": rec["input_shapes"]}

    # ---- (16a) the document-sharded serve cells and the top-k merge ----
    t = time.perf_counter()
    note("16a")
    res["serve"] = {}
    for mshape in QUAD_SERVE_MESHES:
        mesh = meshes[mshape]
        for shape in WORLD_SERVE:
            zero_counts()
            rec, out, e = run("paper_search", shape, mesh)
            launches = read_counts(f"world {mesh} paper_search {shape} (phase 16a), rank {rank}")["proximity_window"]
            out = {k: v.cpu() for k, v in out.items()}
            want = torch.load(work / f"fold_{shape}.pt")
            e.update(calls=rec["calls"], cover_launches=launches,
                     ints_equal=all(torch.equal(out[k], want[k]) for k in ("top_docs", "n_fragments")),
                     scores_equal=torch.equal(out["top_scores"], want["top_scores"]),
                     scores_close=torch.allclose(out["top_scores"], want["top_scores"], rtol=SCORE_RTOL, atol=0))
            res["serve"][f"{shape} {mesh}"] = e
    n_lists, k = QUAD_MERGE
    gen = torch.Generator().manual_seed(16)
    # a few score values, so equal scores meet across ranks; ids all distinct
    scores = (torch.randint(0, 6, (n_lists, k), generator=gen).float() / 4).sort(dim=1, descending=True).values
    docs = torch.randperm(n_lists * k, generator=gen).reshape(n_lists, k)
    want_s, want_d = device_topk_merge(scores.to(dev), docs.to(dev), k)
    res["merge"] = {}
    for mshape in QUAD_SERVE_MESHES:
        mesh, per = meshes[mshape], n_lists // QUAD
        mine = slice(mesh.rank * per, (mesh.rank + 1) * per)
        got_s, got_d = device_topk_merge(scores[mine].to(dev), docs[mine].to(dev), k, mesh=mesh)
        res["merge"][str(mesh)] = {"equal": torch.equal(got_s, want_s) and torch.equal(got_d, want_d),
                                   "top": got_s.tolist(), "ties": int((want_s[1:] == want_s[:-1]).sum())}
    res["s"]["16a"] = time.perf_counter() - t

    # ---- (16b) the LM cells at one data rank's share a rank ----
    t = time.perf_counter()
    note("16b")
    layout = make_production_mesh()
    res["lm"] = {}
    zero_counts()
    for mshape, fsdp in QUAD_LM_MESHES:
        mesh = meshes[mshape]
        for shape in QUAD_LM_SHARE:
            rows = QUAD_LM_SHARE[shape] * mesh.axis_size("data")
            spec = quad_lm_spec(shape, rows, fsdp=fsdp)
            note(f"16b {shape} {mesh}{' fsdp' if fsdp else ''}")
            rec, got, e = run(LM_ARCH, shape, mesh, repeats=1, spec=spec)
            want = torch.load(quad_lm_file(work, shape, rows), mmap=True, weights_only=False)
            e.update(world_rows=rows, rows_a_rank=rec["input_shapes"][-1]["tokens"][0])
            if shape == "train_4k":
                cell = build_cell(spec, shape, layout, mesh)
                params = gather_tree(got[0], cell.in_specs[0], mesh)
                e["params_rel"] = max(rel(a, b.to(dev)) for a, b in zip(tree_leaves(params), tree_leaves(want["params"])))
                e["metrics"] = {k: float(v) for k, v in got[2].items()}
                e["metrics_want"] = want["metrics"]
                e["metrics_rel"] = max(abs(e["metrics"][k] - w) / max(abs(w), 1e-30) for k, w in want["metrics"].items())
                del params
            else:
                logits, cache = got
                b0 = mesh.coord("data") * logits.shape[0]
                e["logits_rel"] = rel(logits, want["logits"][b0:b0 + logits.shape[0]].to(dev))
                e["cache_rel"] = max(rel(cache[c], want["cache"][c][:, b0:b0 + logits.shape[0]].to(dev)) for c in "kv")
            res["lm"][f"{shape} {mesh}{' fsdp' if fsdp else ''}"] = e
            del got, want
    read_counts(f"world of four LM cells (phase 16b), rank {rank}")
    res["s"]["16b"] = time.perf_counter() - t

    # ---- (16c) context-parallel decode over 1x4 at all 22 layers ----
    t = time.perf_counter()
    zero_counts()
    res["decode"] = {}
    mesh = meshes[(1, 4)]
    for shape, (rows, lens) in QUAD_DECODE.items():
        fresh()
        note(f"16c {shape}")
        with CollectiveSpy(torch, dev) as spy:
            e = decode_record(torch, dev, mesh, shape, rows)
        e["largest"] = spy.largest()
        e["holds"] = {}
        for dtype, layers, _ in QUAD_DECODE_HOLDS[shape]:
            note(f"16c {shape} {dtype} {layers}")
            torch.cuda.reset_peak_memory_stats(dev)
            e["holds"][f"{dtype} {layers}"] = decode_holds(torch, dev, mesh, shape, rows, lens, rel, dtype=dtype,
                                                           layers=layers,
                                                           exact=(shape, dtype, layers) in QUAD_DECODE_EXACT)
            e.setdefault("peak_mib_holds", {})[f"{dtype} {layers}"] = torch.cuda.max_memory_allocated(dev) / 2**20
        res["decode"][shape] = e
    read_counts(f"world of four context-parallel decode (phase 16c), rank {rank}")
    res["s"]["16c"] = time.perf_counter() - t

    # ---- (16d) one olmoe MoE layer over model = 4, the int8 all-reduce ----
    t = time.perf_counter()
    note("16d")
    zero_counts()
    mesh = meshes[(1, 4)]
    mspec = get_spec(MOE_ARCH)
    mcfg, d_model = mspec.model_cfg.moe, mspec.model_cfg.d_model
    res["moe"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cpu").manual_seed(7)
        full = tree_map(lambda a: a.to(dev), moe.init_moe_params(gen, d_model, mcfg, dtype))
        # a direction every token shares skews the routing, so the config's
        # capacity drops pairs
        x = torch.randn((1, WORLD_MOE_TOKENS, d_model), generator=gen.manual_seed(8))
        x = (x + 2.0 * torch.randn((d_model,), generator=gen)).to(dev, dtype)
        local = shard_tree(full, {"router": P(), "w_gate": P("model"), "w_up": P("model"), "w_down": P("model")},
                           mesh)
        nodrop = dataclasses.replace(mcfg, capacity_factor=MOE_NO_DROP, dispatch="local")
        want_y, want_aux = moe._moe_sort(x.reshape(-1, d_model), full, nodrop)
        # the pairs one card's sort dispatch drops: each expert's queue, in
        # token order, is the same whichever rank holds the expert
        want_drop = moe.dropped_slots(x, full, dataclasses.replace(mcfg, dispatch="sort"))
        fresh()
        with use_mesh(mesh), CollectiveSpy(torch, dev) as spy:
            y, aux = moe.moe_ffn(x, local, nodrop)
            dropped = moe.dropped_slots(x, local, dataclasses.replace(mcfg, dispatch="local"))
            y_cap, _ = moe.moe_ffn(x, local, dataclasses.replace(mcfg, dispatch="local"))
        res["moe"][str(dtype).replace("torch.", "")] = {
            "y_rel": rel(y.reshape(want_y.shape), want_y), "aux": float(aux), "aux_want": float(want_aux),
            "dropped": int(dropped.sum()), "dropped_equal_sort": bool(torch.equal(dropped, want_drop)),
            "y_cap_finite": bool(torch.isfinite(y_cap).all()), "experts_a_rank": local["w_gate"].shape[0],
            "peak_mib": torch.cuda.max_memory_allocated(dev) / 2**20, "largest": spy.largest()}
        del full, local, x, y, y_cap, want_y
    read_counts(f"world of four olmoe MoE layer (phase 16d), rank {rank}")
    # the int8 all-reduce over pod = 4, on tinyllama's 2-layer gradient
    # tree: every rank draws every rank's gradients and residuals (a seed a
    # (rank, leaf)) and sums their int8 values and scales itself
    mpod = make_device_mesh((QUAD, 1, 1), ("pod", "data", "model"), backend=QUAD_BACKEND, device=QUAD_DEVICE)
    shapes = tree_leaves(transformer.param_shapes(dataclasses.replace(get_spec(LM_ARCH).model_cfg,
                                                                      n_layers=WORLD_COMPRESS_LAYERS)))

    def draw(r: int, i: int):
        g = torch.Generator(device=dev).manual_seed(100_000 * r + i)
        shape = tuple(shapes[i].shape)
        return (torch.randn(shape, generator=g, device=dev) * 1e-3, torch.randn(shape, generator=g, device=dev) * 1e-5)

    mine = [draw(rank, i) for i in range(len(shapes))]
    fresh()
    with CollectiveSpy(torch, dev) as spy:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out, err = compressed_grad_allreduce([g for g, _ in mine], [e for _, e in mine], mpod, "pod")
        end.record()
        end.synchronize()
    ms = start.elapsed_time(end)
    worst, bits, err_equal = 0.0, 0, True
    for i, (o, e_new) in enumerate(zip(out, err)):
        qs, scales = [], []
        for r in range(QUAD):
            g, e_old = mine[i] if r == rank else draw(r, i)
            xr = g.float() + e_old
            s = torch.clamp(xr.abs().max(), min=1e-12) / 127.0
            q = torch.clamp(torch.round(xr / s), -127, 127)
            qs.append(q.to(torch.int32))
            scales.append(s)
            if r == rank:
                err_equal &= torch.equal(e_new, xr - q * s)
        total = sum(scales[1:], scales[0])
        want = (sum(qs[1:], qs[0]).float() * (total / QUAD) / QUAD).to(o.dtype)
        worst = max(worst, float(((o - want).abs() / want.abs().clamp_min(1e-30)).max()))
        bits += int((o != want).sum())
    res["compress"] = {"leaves": len(shapes), "elements": sum(s.numel() for s in shapes), "ms": ms,
                       "out_rel_max": worst, "out_bits_differ": bits, "err_equal": bool(err_equal),
                       "largest": spy.largest()}
    del mine, out, err
    res["s"]["16d"] = time.perf_counter() - t

    # ---- (16e) recsys and (16f) GNN cells at full size ----
    for label, cells in (("16e", QUAD_RECSYS), ("16f", QUAD_GNN)):
        t = time.perf_counter()
        note(label)
        zero_counts()
        res[label] = family_cells(torch, dev, work, cells, meshes, cuts={}, spy=True)
        read_counts(f"world of four {'recsys' if label == '16e' else 'GNN'} cells (phase {label}), rank {rank}")
        res["s"][label] = time.perf_counter() - t
    (work / f"quad_rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


# (16b): the trainer's checkpoint from its world of four, resumed in a world
# of one rank over NCCL for one more step, against the same step of an
# unsharded run from the seed (the reduced config, as the trainer runs it
# without --full-scale): each prints its loss
QUAD_RESUME = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import get_reduced_spec
from repro_torch.data.pipeline import LMTokenPipeline, PipelineState
from repro_torch.launch.mesh import make_device_mesh, make_smoke_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.models import transformer
from repro_torch.optim import adamw_init
from repro_torch.parallel.sharding import P
from repro_torch.tree import tree_map
ckpt, steps, rendezvous, backend, device = sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6]
spec = get_reduced_spec("tinyllama-1.1b")
cfg, kw = spec.model_cfg, spec.shapes["train_4k"].kwargs
def fresh():
    params = transformer.init_params(0, cfg, device=device)
    return params, adamw_init(params), LMTokenPipeline(cfg.vocab, kw["seq_len"], kw["global_batch"], seed=0)
def step(cell, params, opt, pipe):
    return cell.fn(params, opt, {k: torch.from_numpy(v).to(device) for k, v in pipe.next_batch().items()})
params, opt, pipe = fresh()
cell = build_cell(spec, "train_4k", make_smoke_mesh())
for _ in range(steps + 1):
    params, opt, m = step(cell, params, opt, pipe)
print("unsharded step", int(opt["step"]), "loss", float(m["loss"]), flush=True)
dist.init_process_group(backend, init_method=f"file://{rendezvous}", rank=0, world_size=1)
mesh = make_device_mesh((1, 1), ("data", "model"), backend=backend, device=device)
cell = build_cell(spec, "train_4k", make_smoke_mesh(), mesh)
params, opt, pipe = fresh()
template = {"params": params, "opt": opt, "pipe": pipe.state.as_tree()}
specs = {"params": cell.in_specs[0], "opt": cell.in_specs[1], "pipe": tree_map(lambda _: P(), template["pipe"])}
state, at = restore_checkpoint(ckpt, template, device=device, mesh=mesh, specs=specs)
pipe.state = PipelineState.from_tree(state["pipe"])
params, opt, m = step(cell, state["params"], state["opt"], pipe)
print("resumed from step", at, "step", int(opt["step"]), "loss", float(m["loss"]), "backend", dist.get_backend(),
      flush=True)
dist.destroy_process_group()
"""


def quad_phase(torch, dev, path_launches: dict) -> dict:
    """Phase 16 (see the module docstring): the cards, their links and NCCL;
    the unsharded steps on one card, their outputs to the host; the world of
    four; the trainer's command line in a world of four and its checkpoint
    resumed in a world of one.  Returns the summary, the world's launch
    counts added to ``path_launches``."""
    from repro_torch.launch import dryrun
    from repro_torch.tree import tree_map

    t = time.perf_counter()
    cards = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True)
    topo = topo.stdout if topo.returncode == 0 else f"(exit {topo.returncode}) {topo.stdout}{topo.stderr}"
    nccl = torch.cuda.nccl.version() if QUAD_DEVICE == "cuda" else "not used"
    nccl = ".".join(map(str, nccl)) if isinstance(nccl, tuple) else str(nccl)
    for line in cards:
        print(f"16 card {line}")
    print("16 nvidia-smi topo -m:\n" + topo.rstrip())
    print(f"16 NCCL {nccl}; torch {torch.__version__}, {torch.cuda.device_count()} cards visible")
    summary: dict = {"cards": cards, "nccl": nccl, "unsharded": {}}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_quad_"))
    procs: list = []
    try:
        # ---- the unsharded steps, on this card, their outputs to the host ----
        for shape in WORLD_SERVE:
            rec = dryrun.run_cell("paper_search", shape, verbose=False, device=dev, keep_outputs=True)
            require(rec["status"] == "ok", f"{shape}: {rec.get('error')}")
            torch.save({k: v.cpu() for k, v in rec.pop("outputs").items()}, work / f"fold_{shape}.pt")
            summary["unsharded"][shape] = {"wall_ms": rec["wall_ms"], "peak_mib": rec["peak_bytes"] / 2**20}
        for shape, all_rows in quad_lm_rows().items():
            for rows in all_rows:
                gc.collect()
                torch.cuda.empty_cache()
                rec = dryrun.run_cell(LM_ARCH, shape, verbose=False, device=dev, repeats=0, keep_outputs=True,
                                      spec=quad_lm_spec(shape, rows, unsharded=True))
                require(rec["status"] == "ok", f"{shape} {rows} rows unsharded: {rec.get('error')}\n"
                                               f"{rec.get('traceback')}")
                out = rec.pop("outputs")
                if shape == "train_4k":
                    out = {"params": tree_map(lambda x: x.cpu(), out[0]),
                           "metrics": {k: float(v) for k, v in out[2].items()}}
                else:
                    out = {"logits": out[0].cpu(), "cache": {k: v.cpu() for k, v in out[1].items()}}
                torch.save(out, quad_lm_file(work, shape, rows))
                summary["unsharded"][f"{shape} {rows} rows"] = {"wall_ms": [rec["first_call_s"] * 1e3],
                                                                "peak_mib": rec["peak_bytes"] / 2**20}
                del out, rec
        summary["unsharded"].update(family_unsharded(torch, dev, work, QUAD_RECSYS + QUAD_GNN, cuts={}))
        for key, e in summary["unsharded"].items():
            print(f"16 unsharded {key} on one card: wall {[round(x, 3) for x in e['wall_ms']]} ms, peak "
                  f"{e['peak_mib']:.1f} MiB")
        gc.collect()
        torch.cuda.empty_cache()
        t = phase("the unsharded steps on one card, their outputs to the host (16)", t)

        # ---- the world of four ----
        world = world_start(procs, ["--nproc-per-node", str(QUAD), str(ROOT / "chip_smoke.py"), "--quad-worker",
                                    str(work)], env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
        world_finish(world, f"world of four ({QUAD_BACKEND}, one rank a card, chip_smoke.py --quad-worker)",
                     timeout=900)
        ranks = [json.loads((work / f"quad_rank{r}.json").read_text()) for r in range(QUAD)]
        for r in ranks:
            mem = r["memory"]
            world_comm = mem["16 after the world's communicator"]["other"] - mem["16 start"]["other"]
            pair_comm = mem["16 after a pair's communicator"]["other"] - mem["16 after the world's communicator"]["other"]
            print(f"16 rank {r['rank']}: card memory outside PyTorch's pool (GiB) at each step "
                  + json.dumps({k: round(v["other"] / 2**30, 2) for k, v in mem.items()})
                  + f"; a communicator of four ranks {world_comm / 2**20:.0f} MiB, of two {pair_comm / 2**20:.0f} MiB")
        summary["memory"] = [r["memory"] for r in ranks]
        for r in ranks:
            print(f"16 rank {r['rank']}: backend {r['backend']}, device {r['device']}, "
                  f"torch.cuda.current_device() {r['current_device']}, seconds {json.dumps(r['s'])}")
        require(all(r["backend"] == QUAD_BACKEND for r in ranks), "a rank of the world of four ran no NCCL")
        require(sorted(r["current_device"] for r in ranks) == list(range(QUAD)),
                f"the world of four's ranks are not on four cards: {[r['current_device'] for r in ranks]}")
        summary["ranks"] = [{k: r[k] for k in ("rank", "backend", "device", "current_device", "s")} for r in ranks]
        for r in ranks:
            path_launches.update(r["launches"])
            for path, counts in r["launches"].items():
                if "16a" not in path:
                    require(all(v == 0 for v in counts.values()), f"{path} launched a search kernel: {counts}")

        def line(label, r, e, gloo_key):
            wall = [round(x, 3) for x in e["wall_ms"]] if e.get("wall_ms") else "none timed"
            print(f"{label} rank {r['rank']} (card {r['current_device']}): wall {wall} ms, first call "
                  f"{e.get('first_call_s')} s, peak {e['peak_mib']:.1f} MiB, collectives "
                  f"{json.dumps(e['collectives'])} B; {largest_line(e.get('largest'))}; phase 15 (gloo): "
                  f"{PHASE15_GLOO.get(gloo_key, 'none')}")

        # ---- (16a) ----
        for key in ranks[0]["serve"]:
            shape = key.split()[0]
            for r in ranks:
                e = r["serve"][key]
                line(f"16a {key}", r, e, shape)
                require(e["cover_launches"] == e["calls"], f"16a {key} rank {r['rank']}: {e['cover_launches']} cover "
                                                           f"launches in {e['calls']} calls")
                require(e["ints_equal"] and e["scores_close"], f"16a {key} rank {r['rank']}: != the one-program fold")
            print(f"16a {key}: {ranks[0]['serve'][key]['inputs'][0][0]} shards a rank; top_docs and n_fragments == "
                  f"the one-program fold on every rank, top_scores bit-equal: "
                  f"{[r['serve'][key]['scores_equal'] for r in ranks]}")
        for mesh in ranks[0]["merge"]:
            print(f"16a device_topk_merge over {mesh} ({QUAD_MERGE[0]} lists of {QUAD_MERGE[1]}, "
                  f"{ranks[0]['merge'][mesh]['ties']} ties in the top): == one card's merge on every rank: "
                  f"{[r['merge'][mesh]['equal'] for r in ranks]}")
            require(all(r["merge"][mesh]["equal"] for r in ranks), f"16a device_topk_merge over {mesh}")
        # ---- (16b) ----
        for key in ranks[0]["lm"]:
            shape = key.split()[0]
            for r in ranks:
                e = r["lm"][key]
                line(f"16b {key} ({e['rows_a_rank']} of {e['world_rows']} rows a rank)", r, e, shape)
                require(e["rows_a_rank"] == QUAD_LM_SHARE[shape], f"16b {key}: {e['rows_a_rank']} rows a rank")
                if shape == "train_4k":
                    print(f"16b {key} rank {r['rank']}: metrics {e['metrics']} vs unsharded {e['metrics_want']} (rel "
                          f"{e['metrics_rel']:.2e}), params rel {e['params_rel']:.2e}")
                    require(e["metrics_rel"] <= LM_BF16_REL and e["params_rel"] <= LM_BF16_REL,
                            f"16b {key}: beyond 2e-2")
                else:
                    print(f"16b {key} rank {r['rank']}: logits rel {e['logits_rel']:.2e}, cache rel {e['cache_rel']:.2e}")
                    require(e["logits_rel"] <= LM_BF16_REL and e["cache_rel"] <= LM_BF16_REL, f"16b {key}: beyond 2e-2")
        # ---- (16c) ----
        for shape in QUAD_DECODE:
            for r in ranks:
                e = r["decode"][shape]
                line(f"16c {shape} (1x4, all layers, cache slice {e['cache_local']})", r, e, shape)
                print(f"16c {shape} rank {r['rank']}: peak MiB of each hold's steps "
                      + json.dumps({k: round(v, 1) for k, v in e["peak_mib_holds"].items()}))
            for dtype, layers, bound in QUAD_DECODE_HOLDS[shape]:
                decode_holds_check(f"16c {shape} {dtype} at {layers} layers (bound {bound:g})",
                                   [r["decode"][shape]["holds"][f"{dtype} {layers}"] for r in ranks], 1, bound)
        # ---- (16d) ----
        for r in ranks:
            for name, e in r["moe"].items():
                tol = 1e-5 if name == "float32" else LM_BF16_REL
                print(f"16d olmoe layer {name} rank {r['rank']}: local (1x4, {e['experts_a_rank']} experts a rank) vs "
                      f"sort, no drops: y rel {e['y_rel']:.2e}, aux {e['aux']:.6f} vs {e['aux_want']:.6f}; at the "
                      f"config's capacity {e['dropped']} pairs dropped, == one card's sort dispatch: "
                      f"{e['dropped_equal_sort']}; peak {e['peak_mib']:.1f} MiB; {largest_line(e['largest'])}")
                require(e["y_rel"] <= tol and e["dropped_equal_sort"] and e["y_cap_finite"], f"16d {name} rank {r['rank']}")
                require(abs(e["aux"] - e["aux_want"]) <= 1e-4 * abs(e["aux_want"]), f"16d {name}: aux")
            c = r["compress"]
            print(f"16d compressed_grad_allreduce rank {r['rank']} (pod = {QUAD}): {c['leaves']} leaves, "
                  f"{c['elements']:,} elements, {c['ms']:.1f} ms; output vs the plain sum of every rank's int8 "
                  f"values and scales: max rel {c['out_rel_max']:.2e} ({c['out_bits_differ']} elements differ in "
                  f"bits), residual equal {c['err_equal']}; {largest_line(c['largest'])}; phase 15 (gloo): "
                  f"{PHASE15_GLOO['compress']}")
            require(c["err_equal"] and c["out_rel_max"] <= 1e-6, f"16d rank {r['rank']}: compressed all-reduce")
        # ---- (16e), (16f) ----
        for label, cells in (("16e", QUAD_RECSYS), ("16f", QUAD_GNN)):
            for arch, shape, mesh in cells:
                key = f"{arch} {shape} {mesh[0]}x{mesh[1]}"
                want = summary["unsharded"][f"{arch} {shape}"]
                for r in ranks:
                    e = r[label][key]
                    held = e.get("metrics_fwd", {})
                    close = e.get("params", e.get("scores"))
                    line(f"{label} {key}{' (the counted call)' if e['counted_call_only'] else ''}", r,
                         {**e, "peak_mib": e["peak_mib_rank"]}, f"{arch} {shape}")
                    print(f"{label} {key} rank {r['rank']}: unsharded {[round(x, 3) for x in want['wall_ms']]} ms, "
                          f"{want['peak_mib']:.1f} MiB; " + (f"metrics {e['metrics']} vs {e['metrics_want']}; "
                                                              if held else "")
                          + f"{'params after the step' if 'params' in e else 'scores'}: max abs "
                            f"{close['max_abs']:.3e}, {close['beyond']} beyond tolerance")
                    require(all(held.values()) and close["beyond"] == 0,
                            f"{label} {key} rank {r['rank']}: beyond the float32 tolerances")
        summary["world"] = {k: [r[k] for r in ranks] for k in ("serve", "merge", "lm", "decode", "moe", "compress",
                                                                 "16e", "16f")}
        t = phase("world of four over NCCL: serving, LM, decode, MoE, compression, recsys, GNN (16a-f)", t)

        # ---- (16b) the trainer's command line in a world of four, resumed ----
        ckpt = work / "ckpt"
        cli = world_start(procs, ["--nproc-per-node", str(QUAD), "-m", "repro_torch.launch.train", "--arch", LM_ARCH,
                                  "--mesh", QUAD_CLI_MESH, "--steps", str(QUAD_CLI_STEPS), "--ckpt-every",
                                  str(QUAD_CLI_STEPS), "--ckpt-dir", str(ckpt)])
        cli_out = world_finish(cli, f"python -m torch.distributed.run --nproc-per-node {QUAD} -m "
                                    f"repro_torch.launch.train --mesh {QUAD_CLI_MESH} (its default backend)")
        steps = [ln for ln in cli_out.splitlines() if ln.startswith(("step", "done"))]
        print("  " + " | ".join(steps))
        require([ln.split()[:2] for ln in steps] == [["step", "0"], ["step", "1"], ["done:", str(QUAD_CLI_STEPS)]],
                f"the trainer printed {steps}")
        t_run = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-c", QUAD_RESUME, str(ROOT / "src"), str(ckpt), str(QUAD_CLI_STEPS),
                                 str(work / "rendezvous"), QUAD_BACKEND, QUAD_DEVICE], cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(proc)
        out, err = proc.communicate(timeout=300)
        require(proc.returncode == 0, f"the resume check exited {proc.returncode}: {err[-3000:]}")
        lines = [ln for ln in out.splitlines() if ln.strip()]
        print("  " + " | ".join(lines) + f" ({time.perf_counter() - t_run:.1f} s)")
        want_loss = float(next(ln for ln in lines if ln.startswith("unsharded")).split()[-1])
        got = next(ln for ln in lines if ln.startswith("resumed")).split()
        got_loss = float(got[got.index("loss") + 1])
        require(got[3] == str(QUAD_CLI_STEPS) and got[got.index("backend") + 1] == QUAD_BACKEND, f"resumed {got}")
        require(abs(got_loss - want_loss) <= LM_BF16_REL * max(1.0, abs(want_loss)),
                f"16b the resumed step's loss {got_loss} != the unsharded run's {want_loss}")
        summary["cli"] = {"lines": steps, "resume": lines}
        phase("the trainer's command line in a world of four, its checkpoint resumed in a world of one (16b)", t)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return summary


def new_families(phases: list[int], threads: int) -> dict:
    """Phases 15, 12, 13 and 14, as selected and in that order, in this
    process (the card child of a whole run): their summaries and their
    launch counts by path."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.gather import gather_blocks
    from repro_torch.kernels.intersect import intersect_sorted
    from repro_torch.kernels.proximity import proximity_window

    if threads:
        torch.set_num_threads(threads)
    counted = {"proximity_window": proximity_window, "intersect_sorted": intersect_sorted,
               "gather_blocks": gather_blocks}
    path_launches: dict[str, dict[str, int]] = {}

    def zero_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts(path):
        path_launches[path] = {kname: fn.launches for kname, fn in counted.items()}
        return path_launches[path]

    dev = torch.device("cuda", 0)
    out: dict = {}
    # phase 15 first, 15g and 15h after 15f: they run beside phases 7 and 8,
    # whose card memory is small; 12a's olmoe train_4k (70 GB) then lands
    # beside phase 9
    if 15 in phases:
        out["world"] = world_phase(torch, dev, path_launches)
        out["family_world"] = family_world_phase(torch, dev, path_launches)
    if 12 in phases:
        out["moe"] = moe_phase(torch, dev, zero_counts, read_counts)
    if 13 in phases:
        out["recsys"] = recsys_phase(torch, dev, zero_counts, read_counts)
    if 14 in phases:
        out["gnn"] = gnn_phase(torch, dev, zero_counts, read_counts)
        out["cost"] = cost_phase(torch, dev, zero_counts, read_counts)
    out["launches_by_path"] = path_launches
    return out


def card_child_start(procs: list, phases: list[int], threads: int):
    """Phases 12-15 in a fresh process (jax and the reference package
    blocked), its output to files (a pipe would stall it once full), and
    the ``QuietGate`` it checks at each phase line."""
    # expandable segments: the train_4k cell's state is about 71 GB
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    nice = CHILD_NICE if threads else 0  # alone (threads 0) it has the machine to itself
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_child_"))
    with open(work / "out.log", "w") as out, open(work / "err.log", "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", CARD_CHILD, str(ROOT), ",".join(map(str, phases)),
                                 str(threads), str(nice), str(work)],
                                cwd=ROOT, env=env, stdout=out, stderr=err, text=True)
    procs.append(proc)
    return proc, time.perf_counter(), phases, work, QuietGate(work)


def card_child_finish(child) -> dict:
    """Wait for the child of ``card_child_start``, print its lines and
    return what it reported."""
    proc, t_start, phases, work, _ = child
    try:
        proc.wait(timeout=1000)
        lines = (work / "out.log").read_text().splitlines()
        err = (work / "err.log").read_text()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ok = proc.returncode == 0 and lines and lines[-1].startswith("card child: ")
    for line in lines[:-1] if ok else lines:
        print(line)
    require(ok, f"phases {phases} exited {proc.returncode}: {err[-4000:]}")
    print(f"phases {phases} process: {time.perf_counter() - t_start:.1f} s")
    return json.loads(lines[-1][len("card child: "):])


class Background:
    """``fn()`` on a thread; ``result()`` joins it and re-raises its error."""

    def __init__(self, fn):
        self._out: dict = {}

        def run():
            try:
                self._out["value"] = fn()
            except BaseException as e:  # re-raised by result()
                self._out["error"] = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def result(self, timeout: float = 900):
        self._thread.join(timeout)
        require(not self._thread.is_alive(), "a background check did not finish")
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]



def parse_phases(text: str) -> set[int]:
    """``--phases``: phase numbers and ranges (``3-10,12``).  Phases 1 and 2
    (the device, the kernel build) always run; phases 3-10 share the index
    and the services, so selecting any of them runs all of them."""
    phases: set[int] = set()
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        phases.update(range(int(lo), int(hi or lo) + 1))
    if not phases <= KNOWN_PHASES:
        raise argparse.ArgumentTypeError(f"phases are 1-16, not {sorted(phases - KNOWN_PHASES)}")
    return phases | (SEARCH_PHASES if phases & SEARCH_PHASES else set())


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", type=parse_phases, default=ALL_PHASES,
                    help="the phases to run, e.g. 12,13 or 3-10 (default: all; see the module docstring)")
    ap.add_argument("--world-worker", default=None, help=argparse.SUPPRESS)  # one rank of phase 15's world
    ap.add_argument("--world3-worker", default=None, help=argparse.SUPPRESS)  # one rank of 15f's world of three
    ap.add_argument("--family-worker", default=None, help=argparse.SUPPRESS)  # one rank of 15g-h's world of two
    ap.add_argument("--quad-worker", default=None, help=argparse.SUPPRESS)  # one rank of phase 16's world of four
    parsed = ap.parse_args(argv)
    if parsed.world_worker is not None:
        return world_worker(parsed.world_worker)
    if parsed.family_worker is not None:
        return family_worker(parsed.family_worker)
    if parsed.world3_worker is not None:
        return world3_worker(parsed.world3_worker)
    if parsed.quad_worker is not None:
        return quad_worker(parsed.quad_worker)
    phases = parsed.phases
    procs: list = []  # every process the run starts beside its phases
    try:
        return _main(procs, phases)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _main(procs: list, phases: set[int]) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if 16 in phases and torch.cuda.device_count() < QUAD:
        print(f"chip_smoke: phase 16 needs {QUAD} cards, one rank on each; this machine shows "
              f"{torch.cuda.device_count()}; nothing was run", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))

    from repro_torch.core.keys import expand_subqueries, select_keys
    from repro_torch.core.lemma import FLList
    from repro_torch.index import DocumentStore, build_indexes, index_sets_equal, synthesize_corpus
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

    def search_phases():
        """Phases 3-10 (see the module docstring); phases 11e and 11f run
        beside phases 3 and 7, and 15 and 12-14 beside phases 7, 8 and 9,
        when selected."""
        nonlocal t0

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
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


        # phase 11e beside phase 3: the trainer at full scale while the host
        # builds the index and the card is otherwise idle
        lm_cli = lm_cli_start(procs) if 11 in phases else None

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
        if lm_cli is not None:
            lm_cli = lm_cli_finish(*lm_cli)
            t0 = phase("the rest of the trainer CLI (11e) after phase 3", t0)

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
        # phase 11f beside the host-side builds below
        lm_ckpt = Background(lambda: lm_resume_check(procs)) if 11 in phases else None
        # phases 15, 12, 13 and 14 in a child process beside phases 7, 8 and
        # 9, which are host-bound (their slates' times and profiles share the
        # card with it; none is held to a bound)
        gc.collect()
        torch.cuda.empty_cache()
        child = card_child_start(procs, new, threads=CHILD_THREADS) if new else None
        print(f"card memory held here: {torch.cuda.memory_reserved() / 2**20:.1f} MiB reserved; phases "
              f"{new} {'started beside phases 7, 8 and 9' if new else 'not selected'}")
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
        if lm_ckpt is not None:
            lm_ckpt = lm_ckpt.result()
            t0 = phase("the rest of the checkpoint resume check (11f) after the builds", t0)

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

        # the arena at the smallest power-of-two budget at which the acquire's
        # admission (every shard's families in order, none evictable) keeps
        # every shard's triples.  The launcher's 64 MiB keeps none of them, and
        # phase 8 drives that budget's host-pack fallback over these documents
        arena_big, res_big, fam_bytes = cold_arena(SHARDED_ARENA_BUDGET)

        def triples_kept(budget):
            used, kept = 0, 0
            for sizes in fam_bytes:
                for fname in ("stop_single", "stop_pair", "pair", "triple"):
                    if used + sizes[fname] <= budget:
                        used += sizes[fname]
                        kept += fname == "triple"
            return kept

        require(triples_kept(SHARDED_ARENA_BUDGET) == N_SHARDS
                and triples_kept(SHARDED_ARENA_BUDGET // 2) < N_SHARDS and triples_kept(ARENA_BUDGET) == 0,
                f"{SHARDED_ARENA_BUDGET >> 20} MiB is not the smallest power-of-two budget that keeps "
                f"every shard's triples")
        print(f"the smallest power-of-two budget that admits every shard's triple family: "
              f"{SHARDED_ARENA_BUDGET >> 20} MiB (none at {ARENA_BUDGET >> 20} MiB)")
        require(arena_route(SHARDED_ARENA_BUDGET, arena_big, res_big),
                f"the triples are not resident at {SHARDED_ARENA_BUDGET >> 20} MiB")
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
        t0 = phase("baselines and device_topk_merge", t0)

        def agree(label, resps, ref_resps):
            """Fragments, documents and (rtol) scores of every query equal."""
            for q, got, ref in zip(SLATE, resps, ref_resps):
                require({(d.doc_id, f.start, f.end) for d in got.docs for f in d.fragments}
                        == {(d.doc_id, f.start, f.end) for d in ref.docs for f in d.fragments},
                        f"{label} fragments differ for {q!r}")
                require([d.doc_id for d in got.docs] == [d.doc_id for d in ref.docs],
                        f"{label} documents differ for {q!r}")
                require(np.allclose([d.score for d in got.docs], [d.score for d in ref.docs], rtol=SCORE_RTOL),
                        f"{label} scores differ for {q!r}")

        def digests(resps):
            return [hashlib.sha256(json.dumps(sorted((d.doc_id, f.start, f.end) for d in r.docs
                                                     for f in d.fragments)).encode()).hexdigest()[:16]
                    for r in resps]

        def durable_phase(snap_dir: Path, ref_dir: Path) -> None:
            t8 = time.perf_counter()
            t_build = time.perf_counter()
            isvc = ShardedSearchService(shard_store, n_shards=N_SHARDS, sw_count=SW_COUNT, fu_count=FU_COUNT,
                                        max_distance=MAX_DISTANCE, incremental=True, device="cuda")
            print(f"incremental service: {len(shard_store)} docs in {N_SHARDS} shards, built in "
                  f"{time.perf_counter() - t_build:.1f} s")
            for i, (ix, static) in enumerate(zip(isvc.indexers, svc.shards)):
                eq, why = index_sets_equal(ix.index.to_index_set(), static)
                require(eq, f"incremental shard {i} != phase 7's static shard: {why}")
                print(f"  shard {i}: {len(ix.segments)} segment(s), "
                      f"{sum(seg.live_bytes() for seg in ix.segments) / 2**20:.1f} MiB, == phase 7's shard")
            t_ref = time.perf_counter()
            isvc.snapshot(ref_dir)  # WAL-less: phase 9a's bulk tree must equal it file for file
            print(f"WAL-less snapshot for phase 9a: {time.perf_counter() - t_ref:.2f} s")
            t_dur = time.perf_counter()
            isvc.enable_wal(snap_dir)
            isvc.snapshot(snap_dir)
            on_disk = sum(f.stat().st_size for f in snap_dir.rglob("*") if f.is_file())
            print(f"enable_wal + snapshot: {time.perf_counter() - t_dur:.2f} s, {on_disk / 2**20:.1f} MiB on disk")
            t8 = phase("durable service: incremental build, WAL and snapshot", t8)

            host_fe = ServingFrontend(isvc, use_kernel=True, device="cuda", max_batch=16)
            arena_fe = ServingFrontend(isvc, arena_budget_mb=ARENA_BUDGET >> 20, use_kernel=True,
                                       device="cuda", max_batch=16)
            arena8 = arena_fe.arena

            def acquire(tag):
                """The attached arena's cold acquire under the live tokens."""
                tok = generation_token(isvc)
                t_acq = time.perf_counter()
                res = arena8.acquire_many([(v, tok[i], i) for i, v in enumerate(isvc.shards)])
                torch.cuda.synchronize()
                triples = all("triple" in r.families for r in res)
                print(f"durable arena cold acquire ({tag}, {ARENA_BUDGET >> 20} MiB): "
                      f"{time.perf_counter() - t_acq:.3f} s, {json.dumps(arena8.metrics())}; every shard's "
                      f"triples resident: {triples}" + ("" if triples else
                                                         " (the slate falls back to the host pack)"))
                return triples

            def routes(tag):
                """The host route and the attached arena's route, each through
                fresh frontends (launch counters at 0 before, read after)."""
                _, rounds8 = step1_folds(isvc.shards)
                n_rounds = len(rounds8)
                out = {f"durable host route, {tag}": sharded_route(
                    f"durable host route, {tag}",
                    lambda: ServingFrontend(isvc, use_kernel=True, device="cuda", max_batch=16),
                    {"proximity_window": True, "gather_blocks": False, "intersect_sorted": n_rounds})}
                triples = acquire(tag)
                uploads = arena8.uploads
                path = f"durable arena route ({ARENA_BUDGET >> 20} MiB), {tag}"
                out[path] = sharded_route(
                    path, lambda: ServingFrontend(isvc, arena=arena8, use_kernel=True, device="cuda", max_batch=16),
                    {"proximity_window": not triples, "gather_blocks": triples,
                     "intersect_sorted": 0 if triples else n_rounds})
                require(arena8.uploads == uploads, f"the {path} uploaded: the cold entries were missed")
                return out

            before = routes("before mutation")
            for label, resps in before.items():
                agree(f"{label} vs phase 7's se2.4", resps, combiner)
            for fe in (host_fe, arena_fe):
                require(all(r.stats.cache_hits == 0 for r in fe.search_many(requests)), "a cold slate hit the cache")
                require(all(r.stats.cache_hits == 1 for r in fe.search_many(requests)), "a repeat missed the cache")
            t8 = phase("durable service: slate before mutation (host and 64 MiB arena routes)", t8)

            # mutate: 512 new documents, 64 of the slate's documents deleted
            added = synthesize_corpus(n_docs=512, doc_len=DOC_LEN, vocab_size=VOCAB, seed=1)
            seen, victims = set(), []
            for r in before[f"durable host route, before mutation"]:
                for d in r.docs[:16]:
                    if d.doc_id not in seen and len(victims) < 64:
                        seen.add(d.doc_id)
                        victims.append(d.doc_id)
            require(len(victims) == 64, "the slate holds fewer than 64 documents")
            evictions, resident = arena8.evictions, arena8.size_bytes
            torch.cuda.synchronize()
            mem_before = torch.cuda.memory_allocated()
            t_mut = time.perf_counter()
            isvc.add_documents([d.text for d in added.documents])
            for doc_id in victims:
                isvc.delete_document(doc_id)
            add_del_s = time.perf_counter() - t_mut
            t_commit = time.perf_counter()
            report = isvc.commit()
            commit_s = time.perf_counter() - t_commit
            torch.cuda.synchronize()
            freed = mem_before - torch.cuda.memory_allocated()
            evicted = resident - arena8.size_bytes
            print(f"mutation: {len(added)} added and {len(victims)} deleted in {add_del_s:.2f} s; "
                  f"commit {commit_s:.2f} s, "
                  f"report {json.dumps(report)}")
            print(f"attached arena: evictions {evictions} -> {arena8.evictions}, {evicted / 2**20:.3f} MiB "
                  f"evicted, torch.cuda.memory_allocated fell by {freed / 2**20:.3f} MiB")
            require(arena8.evictions > evictions and evicted > 0, "the attached arena evicted nothing")
            require(freed >= evicted, "the evicted buffers were not freed on the card")
            require(all(r.stats.cache_hits == 0 for r in host_fe.search_many(requests)),
                    "a host-route slate hit the result cache after the token moved")
            t8 = phase("durable service: add, delete, commit, eviction", t8)

            after = routes("after mutation")  # the arena's re-acquire is cold here
            require(all(r.stats.cache_hits == 0 for r in arena_fe.search_many(requests)),
                    "an arena-route slate hit the result cache after the token moved")
            isvc.algorithm = "se2.4"
            t_q = time.perf_counter()
            live_se24 = isvc.search_batch(SLATE, top_k=len(store))
            print(f"svc.search_batch (se2.4) over the live shards: {time.perf_counter() - t_q:.2f} s")
            isvc.algorithm, isvc.use_kernel = "fused", True
            zero_counts()
            live_fused = isvc.search_batch(SLATE, top_k=len(store))
            torch.cuda.synchronize()
            require(read_counts("durable svc.search_batch fused")["proximity_window"] > 0,
                    "proximity_window was not launched by the durable svc.search_batch")
            isvc.algorithm = "se2.4"
            for label, resps in (*after.items(), ("durable svc.search_batch fused", live_fused)):
                agree(f"{label} vs se2.4 over the live shards", resps, live_se24)
            # the scalar rebuild of shard 0's survivors, under the service's
            # corpus-global FL-list (the shard's own rebuild_index_set would
            # rank its lemmas by the shard's frequencies alone)
            ix0 = isvc.indexers[0]
            t_rb = time.perf_counter()
            rebuilt = build_indexes(ix0.surviving_store(), SW_COUNT, FU_COUNT, max_distance=MAX_DISTANCE,
                                    fl=isvc.fl)
            eq, why = index_sets_equal(isvc.shards[0].to_index_set(), rebuilt)
            require(eq, f"shard 0's live view != its rebuild: {why}")
            print(f"shard 0: live view == the scalar rebuild of its {len(ix0.documents)} survivors "
                  f"({time.perf_counter() - t_rb:.1f} s)")
            t8 = phase("durable service: slate after mutation, se2.4, fused, shard 0 rebuild", t8)

            t_c = time.perf_counter()
            creport = isvc.compact(memory_budget_bytes=64 << 20)
            print(f"compact (64 MiB budget): {time.perf_counter() - t_c:.2f} s, report {json.dumps(creport)}")
            compacted = ServingFrontend(isvc, use_kernel=True, device="cuda", max_batch=16).search_many(full)
            compact_se24 = isvc.search_batch(SLATE, top_k=len(store))
            agree("compacted host route vs se2.4", compacted, compact_se24)
            agree("se2.4 after compact vs before", compact_se24, live_se24)
            t8 = phase("durable service: compact and serve", t8)

            # acknowledged post-snapshot work, then a warm start in a fresh process
            isvc.snapshot(snap_dir)
            more = synthesize_corpus(n_docs=128, doc_len=DOC_LEN, vocab_size=VOCAB, seed=2)
            isvc.add_documents([d.text for d in more.documents])
            for doc_id in sorted(isvc.indexers[0].documents)[:16]:
                isvc.delete_document(doc_id)
            isvc.commit()
            live = ServingFrontend(isvc, use_kernel=True, device="cuda", max_batch=16).search_many(full)
            agree("live host route vs se2.4", live, isvc.search_batch(SLATE, top_k=len(store)))
            child = subprocess.run(
                [sys.executable, "-c", WARM_START, str(src), str(snap_dir), json.dumps(SLATE), str(len(store))],
                capture_output=True, text=True, timeout=600,
            )
            require(child.returncode == 0, f"the warm-start process failed: {child.stderr[-3000:]}")
            warm = json.loads(child.stdout.strip().splitlines()[-1])
            print(f"fresh-process from_snapshot: restore {warm['restore_s']:.2f} s, {warm['replayed']} WAL records "
                  f"replayed, slate {warm['slate_ms']:.1f} ms, cover launches {warm['cover_launches']}")
            print(f"  digests live {digests(live)}")
            print(f"  digests warm {warm['digests']}")
            require(warm["replayed"] > 0, "the warm start replayed no WAL record")
            require(warm["cover_launches"] > 0, "the warm-started host route launched no cover kernel")
            require(warm["digests"] == digests(live), "the warm-started service serves other fragments")
            phase("durable service: snapshot, acknowledged work, fresh-process warm start", t8)

        def printed(stdout: str) -> list[tuple[str, list[str], str]]:
            """The launcher's (or its client's) printed responses: per response,
            its ``query:`` line, its document lines without the score (document
            and first four fragments) and its flags."""
            out = []
            for line in stdout.splitlines():
                if line.startswith("query: "):
                    flags = line.rsplit("[", 1)[1].rstrip("]") if line.endswith("]") else ""
                    out.append((line.split("'")[1], [], flags))
                elif line.startswith("  doc ") and out:
                    doc, _, frags = line.partition(" fragments: ")
                    out[-1][1].append(f"{doc.split(' score=')[0]} fragments: {frags}")
            return out

        def doc_lines(resps):
            """The launcher's document lines for in-process responses."""
            return [f"  doc {d.doc_id:5d} fragments: "
                    + ", ".join(f"[{f.start},{f.end}]" for f in d.fragments[:4]) for d in resps.docs]

        def launcher_phase(work: Path) -> None:
            t9 = time.perf_counter()
            bulk_dir, cli_dir = work / "bulk", work / "cli"
            env = {**os.environ, "PYTHONPATH": str(src)}
            procs: list[subprocess.Popen] = []
            stopping = threading.Event()
            procs_lock = threading.Lock()  # no launch slips past the cleanup below

            def launch(*args, script: str = RUN_MODULE) -> subprocess.Popen:
                with procs_lock:
                    require(not stopping.is_set(), "phase 9 is stopping: no more launcher processes")
                    proc = subprocess.Popen([sys.executable, "-u", "-c", script, "repro_torch.launch.serve", *map(str, args)], env=env,
                                            cwd=work, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                    procs.append(proc)
                return proc

            def finish(proc, label, timeout=600, errors: list | None = None) -> str:
                out, err = proc.communicate(timeout=timeout)
                if errors is not None:
                    errors.append(err)
                require(proc.returncode == 0, f"launcher {label} exited {proc.returncode}: {err[-3000:]}")
                return out

            slate_args = ["--queries", *SLATE, "--top-k", TOP_K]
            try:
                # 9c run 4 first, in the background: the CLI's own corpus and tree
                cli_runs: dict[str, object] = {}

                def cli_chain():
                    try:
                        t_c = time.perf_counter()
                        cli_runs["cold"] = finish(launch("--bulk-ingest", "--snapshot-dir", cli_dir,
                                                         "--n-docs", CLI_DOCS, "--n-shards", N_SHARDS,
                                                         "--sw-count", SW_COUNT, "--fu-count", FU_COUNT,
                                                         *slate_args), "run 4 (bulk-ingest cold start)")
                        cli_runs["cold_s"] = time.perf_counter() - t_c
                        t_c = time.perf_counter()
                        cli_runs["warm"] = finish(launch("--snapshot-dir", cli_dir, *slate_args),
                                                  "run 4 (warm start)")
                        cli_runs["warm_s"] = time.perf_counter() - t_c
                    except BaseException as e:  # re-raised in the main thread
                        cli_runs["error"] = e

                cli_thread = threading.Thread(target=cli_chain, daemon=True)
                cli_thread.start()

                # ---- 9a. bulk ingest on the card's host, byte for byte ----------
                t_b = time.perf_counter()
                bsvc, bstats = ShardedSearchService.bulk_ingest(
                    shard_store, bulk_dir, n_shards=N_SHARDS, sw_count=SW_COUNT, fu_count=FU_COUNT,
                    max_distance=MAX_DISTANCE, workers=4, device="cuda")
                bulk_s = time.perf_counter() - t_b
                spill = sum(st.spill_bytes for st in bstats)
                print(f"bulk ingest: {len(shard_store)} docs into {N_SHARDS} shards, 4 spawn workers, "
                      f"{bulk_s:.2f} s, {spill / 1024:.0f} KiB spilled, {len(shard_store) / bulk_s:.0f} docs/s; "
                      f"per shard (lemmatize, spill, merge s): "
                      + json.dumps([[round(st.lemmatize_s, 2), round(st.spill_s, 2), round(st.merge_s, 2)]
                                    for st in bstats]))

                def tree(root):
                    return {str(f.relative_to(root)): hashlib.sha256(f.read_bytes()).hexdigest()
                            for f in sorted(root.rglob("*"))
                            if f.is_file() and not f.name.startswith("restore_epoch")}

                bulk_tree, ref_tree = tree(bulk_dir), tree(work / "reference")
                require(set(bulk_tree) == set(ref_tree),
                        f"bulk tree files != the snapshot's: {sorted(set(bulk_tree) ^ set(ref_tree))[:8]}")
                differ = sorted(k for k in bulk_tree if bulk_tree[k] != ref_tree[k])
                require(not differ, f"bulk tree differs from the snapshot in {differ[:8]}")
                print(f"bulk tree == phase 8's WAL-less snapshot: {len(bulk_tree)} files, sha256 of each "
                      f"equal ({sum(f.stat().st_size for f in bulk_dir.rglob('*') if f.is_file()) / 2**20:.1f} MiB)")
                zero_counts()
                t_serve = time.perf_counter()
                bulk_resps = ServingFrontend(bsvc, use_kernel=True, device="cuda", max_batch=16).search_many(full)
                torch.cuda.synchronize()
                counts = read_counts("bulk-ingested host route")
                print(f"bulk-ingested service, host route: {(time.perf_counter() - t_serve) * 1e3:.1f} ms for the "
                      f"slate, all documents ranked, kernel launches {counts}")
                require(counts["proximity_window"] > 0, "proximity_window was not launched on the bulk-ingested service")
                agree("bulk-ingested host route vs phase 7's se2.4", bulk_resps, combiner)
                t9 = phase("launcher deployments: bulk ingest, tree and slate (9a)", t9)

                # ---- 9b. resilience on the card ----------------------------------
                from repro_torch.search.resilience import FaultInjector, ResiliencePolicy

                bsvc.enable_wal(bulk_dir)
                injector = FaultInjector.from_seed(CHAOS_SEED, n_shards=N_SHARDS)
                bsvc.enable_resilience(policy=ResiliencePolicy(snapshot_dir=bulk_dir), injector=injector)
                print(f"fault schedule, seed {CHAOS_SEED}: " + json.dumps(
                    [[e.point, e.kind, e.shard, e.at_call, e.count] for e in injector.schedule]))
                # the bulk tree now only gets read: start 9c's runs 1-3 alongside
                runs = {"warm": launch("--snapshot-dir", bulk_dir, *slate_args, "--repeat", 2),
                        "chaos": launch("--snapshot-dir", bulk_dir, *slate_args, "--repeat", 3,
                                        "--chaos-seed", CHAOS_SEED),
                        "daemon": launch("--daemon", "--port", 0, "--replicas", 2, "--snapshot-dir", bulk_dir)}
                t_runs = time.perf_counter()
                daemon_out: list[str] = []
                listening = threading.Event()

                def drain_daemon():
                    for line in runs["daemon"].stdout:
                        daemon_out.append(line)
                        if "listening on" in line:
                            listening.set()

                daemon_err: list[str] = []
                drains = [threading.Thread(target=drain_daemon, daemon=True),
                          threading.Thread(target=lambda: daemon_err.extend(runs["daemon"].stderr), daemon=True)]
                for th in drains:
                    th.start()

                fe9 = ServingFrontend(bsvc, arena_budget_mb=ARENA_BUDGET >> 20, use_kernel=True, device="cuda",
                                      max_batch=16)
                by_query = dict(zip(SLATE, combiner))
                zero_counts()
                flagged = 0
                for rnd in range(CHAOS_ROUNDS):
                    t_r = time.perf_counter()
                    resps = fe9.search_many(full)
                    torch.cuda.synchronize()
                    for q, r in zip(SLATE, resps):
                        ref = by_query[q]
                        if r.stats.shards_degraded:
                            # se2.4 over the live shards: the shards hold disjoint
                            # documents, and a document's score is its own
                            dead = bsvc.supervisor.last_excluded
                            require(r.stats.partial, f"round {rnd}: a degraded response is not flagged partial")
                            ref = copy.copy(ref)
                            ref.docs = [d for d in ref.docs if d.doc_id % N_SHARDS not in dead]
                            flagged += 1
                        else:
                            require(not r.stats.partial, f"round {rnd}: an exact response is flagged partial")
                        agree(f"chaos round {rnd} {q!r}", [r], [ref])
                    st = resps[0].stats
                    print(f"  chaos round {rnd}: {(time.perf_counter() - t_r) * 1e3:.1f} ms, cache hits "
                          f"{sum(r.stats.cache_hits for r in resps)}, degraded {st.shards_degraded}, retries "
                          f"{st.retries}, recoveries {st.recoveries}, arena hits {sum(r.stats.arena_hits for r in resps)}")
                counts = read_counts("chaos frontend (64 MiB arena)")
                rm = bsvc.resilience_metrics()
                am = fe9.metrics()
                print(f"chaos frontend: {CHAOS_ROUNDS} rounds, {flagged} flagged responses, kernel launches {counts}; "
                      f"resilience {json.dumps(rm)}; arena pressure events {am['arena_pressure_events']}, "
                      f"uploads {am['arena_uploads']}")
                print("  fired: " + json.dumps(injector.log, default=str))
                require(counts["proximity_window"] > 0, "proximity_window was not launched under the fault schedule")
                require(rm["fired"] >= 2 and rm["recoveries"] >= 1,
                        f"the schedule fired {rm['fired']} faults and {rm['recoveries']} recoveries")
                bsvc.algorithm, bsvc.use_kernel = "fused", True
                zero_counts()
                dead_resps = bsvc.search_batch(SLATE, top_k=len(store), dead_shards=[1])
                torch.cuda.synchronize()
                counts = read_counts("dead_shards=[1] fused")
                bsvc.algorithm = "se2.4"
                require(counts["proximity_window"] > 0, "proximity_window was not launched with a dead shard")
                for q, r in zip(SLATE, dead_resps):
                    require(r.stats.shards_degraded == 1 and r.stats.partial, f"dead-shard response {q!r} not flagged")
                    ref = copy.copy(by_query[q])
                    ref.docs = [d for d in ref.docs if d.doc_id % N_SHARDS != 1]
                    agree(f"dead_shards=[1] {q!r}", [r], [ref])
                print(f"search_batch(dead_shards=[1]) fused: every response flagged and == se2.4 over shards 0, 2, 3; "
                      f"kernel launches {counts}")
                t9 = phase("launcher deployments: fault schedule and dead shards (9b)", t9)

                # ---- 9c. the launcher in fresh processes ---------------------------
                live10 = ServingFrontend(bsvc, use_kernel=True, device="cuda", max_batch=16).search_many(requests)
                warm_out = finish(runs["warm"], "run 1 (warm start)")
                warm_printed = printed(warm_out)
                print("  " + "\n  ".join(ln for ln in warm_out.splitlines() if not ln.startswith(("  doc", "query"))
                                           and ln.strip()))
                require(any(ln.startswith(f"warm start: restored {N_SHARDS} shards") for ln in warm_out.splitlines()),
                        "run 1 printed no warm start")
                require(len(warm_printed) == 2 * len(SLATE), f"run 1 printed {len(warm_printed)} responses")
                require(all("CACHED" in flags for _, _, flags in warm_printed[len(SLATE):]),
                        "run 1's second round is not all [CACHED]")
                for (q, lines, _), r in zip(warm_printed, live10):
                    require(lines == doc_lines(r), f"run 1's top {TOP_K} for {q!r} != the live service's")
                chaos_out = finish(runs["chaos"], "run 2 (fault schedule)")
                res_line = [ln for ln in chaos_out.splitlines() if ln.startswith("resilience:")]
                print(f"  run 2: {[ln for ln in chaos_out.splitlines() if ln.startswith('chaos:')]} {res_line}")
                require(len(res_line) == 1 and not res_line[0].startswith("resilience: 0 fault"),
                        "run 2 reported no fault fired")
                require(listening.wait(timeout=600), f"the daemon never listened: {''.join(daemon_err)[-3000:]}")
                line = next(ln for ln in daemon_out if "listening on" in ln)
                address = line.split(" on ", 1)[1].split()[0]
                print(f"  daemon ({time.perf_counter() - t_runs:.1f} s after start): {line.strip()}")
                # the kill and the successor's first answer (its replica's cold
                # 64 MiB arena acquire, host-bound) with no other launcher run
                # and the card child waiting at its next phase line
                cli_thread.join(timeout=900)
                gate = child[4] if child is not None else None
                held = gate.hold(child[0], timeout=120) if gate is not None else ("not started", 0.0)
                client_err: list = []
                try:
                    t_cl = time.perf_counter()
                    client_out = finish(launch("--connect", address, "--kill-primary", *slate_args,
                                               script=RUN_CLIENT_TIMED), "client", errors=client_err)
                    client_s = time.perf_counter() - t_cl
                finally:
                    if gate is not None:
                        gate.release()
                split = [ln.split()[1:] for ln in client_err[0].splitlines() if ln.startswith("[client] ")]
                queries = [float(x) for op, x in split if op == "query"]
                print(f"  client ({client_s:.1f} s; the card child {held[0]} after {held[1]:.1f} s): " + " | ".join(
                    ln for ln in client_out.splitlines() if ln.startswith(("kill_primary", "daemon"))))
                print(f"  client split (s): imports {dict(split)['import']}, kill_primary {dict(split)['kill_primary']}, "
                      f"first query (failover and the successor's first batch) {queries[0]:.3f}, the other "
                      f"{len(queries) - 1} queries {sum(queries[1:]):.3f}, metrics {dict(split)['metrics']}, the rest "
                      f"{client_s - sum(float(x) for _, x in split):.3f}")
                client_printed = printed(client_out)
                require(len(client_printed) == len(SLATE), f"the client printed {len(client_printed)} responses")
                for (q, lines, _), (wq, wlines, _) in zip(client_printed, warm_printed):
                    require(q == wq and lines == wlines, f"the daemon's wire response for {q!r} != run 1's")
                require(any("1 failover(s)" in ln for ln in client_out.splitlines() if ln.startswith("daemon:")),
                        "the client's metrics report no failover")
                runs["daemon"].send_signal(signal.SIGINT)
                rc = runs["daemon"].wait(timeout=60)
                for th in drains:
                    th.join(timeout=10)
                require(rc == 0, f"the daemon exited {rc} on SIGINT: {''.join(daemon_err)[-3000:]}")
                summary = [ln.strip() for ln in daemon_out if ln.startswith("daemon: primary=")]
                print(f"  daemon after SIGINT: exit {rc}, {summary}")
                require(len(summary) == 1, "the daemon printed no summary on SIGINT")
                require("error" not in cli_runs and "warm" in cli_runs, f"run 4 failed: {cli_runs.get('error')}")
                cold_p, warm_p = printed(cli_runs["cold"]), printed(cli_runs["warm"])
                print(f"  run 4: cold start {cli_runs['cold_s']:.1f} s, warm start {cli_runs['warm_s']:.1f} s (process "
                      f"wall); " + " | ".join(ln for ln in (cli_runs["cold"] + cli_runs["warm"]).splitlines()
                                            if ln.startswith(("bulk ingest:", "warm start:"))))
                require(len(cold_p) == len(SLATE) and [x[:2] for x in cold_p] == [x[:2] for x in warm_p],
                        "run 4's cold and warm starts printed other documents")
                phase("launcher deployments: four launcher runs (9c)", t9)
            finally:
                with procs_lock:
                    stopping.set()
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()

        # ---- 8. the durable deployment under mutation ----------------------------
        # the launcher's --snapshot-dir deployment (incremental shards, the
        # write-ahead log, snapshots, a 64 MiB arena attached to the source) over
        # the same documents, mutated while it serves, then warm-started in a
        # fresh process from what it wrote
        work = Path(tempfile.mkdtemp(prefix="chip_smoke_durable_"))
        try:
            durable_phase(work / "snapshot", work / "reference")
            t0 = time.perf_counter()
            launcher_phase(work)
            t0 = phase("the launcher's deployments (phase 9, whole)", t0)
            early = paper_search_early(procs)
            card = card_child_finish(child) if child else None
            t0 = phase(f"the rest of phases {new} after phase 9", t0)
        finally:
            shutil.rmtree(work, ignore_errors=True)

        # ---- 10. the paper_search device steps ------------------------------------
        paper_search_phase(torch, dev, index, subs, kernels, zero_counts, read_counts, early)
        return lm_cli, lm_ckpt, card


    kernels: list = []
    new = [p for p in CHILD_PHASES if p in phases]
    if SEARCH_PHASES & phases:
        lm_cli, lm_ckpt, card = search_phases()
    else:
        t0 = time.perf_counter()
        card = card_child_finish(card_child_start(procs, new, threads=0)) if new else None
        t0 = phase(f"phases {new} alone", t0)
        if 11 in phases:
            lm_cli = lm_cli_finish(*lm_cli_start(procs))
            lm_ckpt = lm_resume_check(procs)
            t0 = phase("the trainer CLI (11e) and the checkpoint resume check (11f) alone", t0)

    # ---- 11. the dense LM training path -----------------------------------------
    if 11 in phases:
        lm = lm_phase(torch, dev, zero_counts, read_counts, lm_cli, lm_ckpt)
        print("lm phase: " + json.dumps(lm))

    # ---- 12, 13 and 14: what their child process reported ------------------------
    if card is not None:
        path_launches.update(card.pop("launches_by_path"))
        print("moe, recsys and gnn phases: " + json.dumps(card))

    # ---- 16. the multi-device half over NCCL on four cards --------------------------
    if 16 in phases:
        t0 = time.perf_counter()
        quad = quad_phase(torch, dev, path_launches)
        print("phase 16: " + json.dumps(quad))
        t0 = phase("phase 16, whole", t0)

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
