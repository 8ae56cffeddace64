"""Dry-run on one card: run every (architecture x input shape) cell at its
full shape, and record its time and peak device memory.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch paper_search --shape serve_online
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch paper_search --all \\
      [--multi-pod] [--both-meshes] [--out artifacts/dryrun] [--device cuda]

The reference lowers and compiles each cell for a 256- or 512-chip TPU mesh
and records XLA's memory and cost analyses.  The port has no compiler to
ask, so ``run_cell`` allocates seeded inputs at the cell's shapes on the
device (an explicit ``torch.Generator``), runs the cell's function, checks
the outputs' shapes, and records the card's own numbers: wall ms of a few
runs by CUDA events (host clock on the CPU), the peak bytes allocated above
what the device held before the cell, and the device's name.  The mesh's
shard count (NS) shapes the serve cells as in the reference; their shards
are folded into one program.  An LM cell runs one data rank's share of its
global batch (``global_batch // data``, ``data`` 16 on one pod and 32 on
two, at least 1) at the cell's full sequence length and the config's full
width and depth; its record keeps the global batch's ``model_flops_global``
and adds the share's.  A recsys cell runs its whole global batch (MIND's
loss takes its negatives from the whole batch, so a share would change it),
on the trainer's batches (``recsys_batch``).  A GNN cell runs its whole
graph on the trainer's batch (``gnn_batch``): ogbn-products' 2.45M nodes
and 61.9M edges on one card, where the reference shards the nodes.

Each record also carries the reference's per-device cost fields
(``flops_per_device``, ``hbm_bytes_per_device``,
``collective_bytes_per_device``, ``collective_total_per_device``), counted
by ``launch/cost_analysis.count_cost`` on the cell's first, untimed call,
so the timed calls run without the counter.  They are the cost of the work
the cell runs on this rank (an LM cell's data-rank share), beside
``model_flops_share``; with no world, nothing is collective.  The reference's
``xla_cost_flops_raw``, ``lower_s``, ``compile_s`` and XLA memory fields
have no counterpart here and are not written.  Records of cells that ran
are cached in ``--out`` and skipped on the next run; the exit code is 1
when any cell failed.

Started by ``python -m torch.distributed.run --nproc-per-node N`` (or with
``--mesh``), the run is one world of ranks on a ``DeviceMesh`` of
``--mesh DATAxMODEL`` (default: the whole world on ``data``) over
``--backend`` (default ``nccl`` on the card, ``gloo`` on the CPU): every
rank draws the same inputs from the seed and keeps its slice of each under
the cell's ``in_specs`` (``parallel.sharding.shard_tree``); an LM cell's
data-rank share is split again over the world's data axes (a decode
cell's cache also over ``model``, by position, where the axis divides
them), and a serve cell's NS shards over all of its ranks.  The record
adds ``device_mesh``, ``backend`` and the collectives the first call ran,
counted per rank; only rank 0 prints and writes it.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed

from ..configs import ARCH_IDS, ArchSpec, get_spec
from ..data.pipeline import LMTokenPipeline, RecsysBatchPipeline
from ..data.sampler import random_graph
from ..models import gnn, recsys, transformer
from ..optim import adamw_init
from ..parallel.sharding import sanitize_specs, shard_tree
from ..tree import tree_leaves
from .cost_analysis import count_cost
from .mesh import DeviceMesh, MeshLayout, make_device_mesh, make_production_mesh, parse_mesh, world_from_env
from .steps import Cell, build_cell

__all__ = ["cell_inputs", "gnn_batch", "recsys_batch", "run_cell", "main"]

# build cells: FL-numbers over a vocabulary of this many lemmas, the most
# frequent STOP_LEMMAS of them stop lemmas (the serving smoke's sw_count)
VOCAB = 5000
STOP_LEMMAS = 80
# serve cells: shares of padded clusters and of out-of-range postings
PAD_CLUSTER_SHARE = 0.1
WILD_POSTING_SHARE = 1 / 512
# timed calls a cell, after one untimed call
REPEATS = 3


def data_share(global_batch: int, mesh: MeshLayout) -> tuple[int, int]:
    """(one data rank's share of ``global_batch``, the number of data
    ranks): the product of the layout's ``pod`` and ``data`` axes."""
    data = math.prod(n for n, a in zip(mesh.shape, mesh.axis_names) if a in ("pod", "data"))
    return max(1, global_batch // data), data


def _lm_inputs(cell: Cell, cfg, batch: int, seed: int, dev: torch.device) -> tuple:
    """Params from the seed, and the step's other inputs at ``batch`` rows:
    Zipf tokens from ``LMTokenPipeline`` (train and prefill), or a cache of
    N(0, 1) values filled to its last row with one new token (decode)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = transformer.init_params(gen, cfg, device=dev)
    if cell.step == "decode":
        _, _, seq, hkv, dh = cell.abstract_args[1]["k"].shape
        shape = (cfg.n_layers, batch, seq, hkv, dh)
        cache = {k: torch.randn(shape, generator=gen, dtype=cfg.torch_dtype, device=dev) for k in ("k", "v")}
        tokens = torch.randint(0, cfg.vocab, (batch, 1), generator=gen, device=dev, dtype=torch.int32)
        return params, cache, tokens, torch.tensor(seq - 1, dtype=torch.int32, device=dev)
    seq = cell.abstract_args[-1]["tokens"].shape[1]
    host = LMTokenPipeline(cfg.vocab, seq, batch, seed=seed).next_batch()
    bat = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    if cell.step == "prefill":
        return params, {"tokens": bat["tokens"]}
    return params, adamw_init(params), bat


def recsys_batch(cfg: recsys.RecsysConfig, rows: int, seed: int = 0) -> tuple[dict, RecsysBatchPipeline]:
    """The reference trainer's first recsys batch (``_concrete_batch``),
    with its numpy draws: the pipeline's batch of ``rows`` rows, MIND's ids
    clipped into the item vocabulary, or a CTR model's sparse ids drawn
    uniformly per field; and the pipeline, for the batches after it."""
    rng = np.random.default_rng(seed)
    pipe = RecsysBatchPipeline(cfg.field_vocab, rows, n_dense=cfg.n_dense,
                               hist_len=cfg.hist_len if cfg.model == "mind" else 0, seed=seed)
    b = pipe.next_batch()
    if cfg.model == "mind":
        b["hist_ids"] = np.clip(b["hist_ids"], -1, cfg.field_vocab[0] - 1)
        b["target_id"] = np.clip(b["target_id"], 0, cfg.field_vocab[0] - 1)
    else:
        b["sparse_ids"] = np.stack([rng.integers(0, v, rows) for v in cfg.field_vocab], axis=1).astype(np.int32)
    return b, pipe


def _recsys_inputs(cell: Cell, cfg: recsys.RecsysConfig, seed: int, dev: torch.device) -> tuple:
    """Params from the seed; the batch of ``recsys_batch`` with the cell's
    keys, at the cell's rows; for retrieval, candidate items drawn uniformly
    from the item vocabulary (field 0)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = recsys.init_recsys_params(gen, cfg, device=dev)
    shapes = cell.abstract_args[-1]
    rows = next(t.shape[0] for k, t in shapes.items() if k != "cand_ids")
    host, _ = recsys_batch(cfg, rows, seed)
    if "cand_ids" in shapes:
        rng = np.random.default_rng((seed, 1))
        host["cand_ids"] = rng.integers(0, cfg.field_vocab[0], shapes["cand_ids"].shape[0]).astype(np.int32)
    bat = {k: torch.from_numpy(host[k]).to(dev) for k in shapes}
    if cell.step == "train":
        return params, adamw_init(params), bat
    return params, bat


def gnn_batch(cfg: gnn.GATConfig, n_nodes: int, n_edges: int, n_graphs: int = 1,
              seed: int = 0) -> dict[str, np.ndarray]:
    """The reference trainer's gnn batch (``_concrete_batch``), with its
    numpy draws: features of ``random_graph(max(n, 8), 4, ...)``'s first
    ``n`` nodes, uniform random ``src`` and ``dst``, all-ones edge and label
    masks, uniform labels (one a node, or one a graph for the graph task)
    and, for the graph task, ``n // n_graphs`` consecutive nodes a graph."""
    rng = np.random.default_rng(seed)
    n, e = n_nodes, n_edges
    g = random_graph(max(n, 8), avg_degree=4, d_feat=cfg.d_feat, n_classes=cfg.n_classes, seed=seed)
    batch = {
        "x": g.features[:n],
        "src": rng.integers(0, n, e).astype(np.int32),
        "dst": rng.integers(0, n, e).astype(np.int32),
        "edge_mask": np.ones(e, np.int32),
    }
    task_graph = cfg.task == "graph"
    nl = n_graphs if task_graph else n
    batch["labels"] = rng.integers(0, cfg.n_classes, nl).astype(np.int32)
    batch["label_mask"] = np.ones(nl, np.int32)
    if task_graph:
        batch["graph_ids"] = np.repeat(np.arange(n_graphs), n // n_graphs).astype(np.int32)
    return batch


def _gnn_inputs(cell: Cell, cfg: gnn.GATConfig, seed: int, dev: torch.device) -> tuple:
    """Params from the seed, their AdamW state, and ``gnn_batch`` at the
    cell's node, edge and graph counts."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = gnn.init_gat_params(gen, cfg, device=dev)
    shapes = cell.abstract_args[-1]
    n_graphs = shapes["labels"].shape[0] if cfg.task == "graph" else 1
    host = gnn_batch(cfg, shapes["x"].shape[0], shapes["src"].shape[0], n_graphs, seed)
    return params, adamw_init(params), {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def cell_inputs(cell: Cell, cfg, *, seed: int = 0, device="cuda", batch: int | None = None) -> tuple:
    """Seeded inputs at the cell's shapes on ``device``, dense enough that
    covers fire.

    Serve cells: each query has 3-5 active lemmas of multiplicity 1-2; its
    postings come in bursts, one posting per lemma occurrence, narrower than
    the cover's window and placed in a random cluster of the shard; about a
    tenth of the clusters are padded (-1) and a few postings lie out of
    range.  Build cells: log-uniform FL-numbers (frequent lemmas dominate, as
    in text), the smallest ``STOP_LEMMAS`` of them stop lemmas.  LM cells:
    see ``_lm_inputs``, at ``batch`` rows (default the cell's global batch).
    Recsys cells: see ``_recsys_inputs``; GNN cells: ``_gnn_inputs``.  The
    same seed on the same device gives the same inputs.
    """
    dev = torch.device(device)
    if isinstance(cfg, recsys.RecsysConfig):
        return _recsys_inputs(cell, cfg, seed, dev)
    if isinstance(cfg, gnn.GATConfig):
        return _gnn_inputs(cell, cfg, seed, dev)
    if cell.step in ("train", "prefill", "decode"):
        if batch is None:  # the global batch: the tokens' leading extent
            tokens = cell.abstract_args[2] if cell.step == "decode" else cell.abstract_args[-1]["tokens"]
            batch = tokens.shape[0]
        return _lm_inputs(cell, cfg, batch, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randint(lo: int, hi: int, shape) -> torch.Tensor:
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    def rand(shape) -> torch.Tensor:
        return torch.rand(shape, generator=gen, device=dev)

    if cell.step == "build":
        docs, doc_len = cell.abstract_args[0].shape
        tokens = (torch.exp(rand((docs, doc_len)) * math.log(VOCAB)) - 1).to(torch.int32)
        return tokens.clamp_(0, VOCAB - 1), tokens < STOP_LEMMAS

    ns, b, p_loc, _ = cell.abstract_args[0].shape
    c_loc = cell.abstract_args[1].shape[2]
    l = cell.abstract_args[2].shape[1]
    n, d = cfg.window_len, cfg.max_distance
    width = min(2 * d, n)  # a burst's positions: narrower than the window 2D+1
    n_active = randint(3, 6, (b, 1))
    mult = torch.where(torch.arange(l, device=dev) < n_active, randint(1, 3, (b, l)), 0)
    # the k-th posting of a burst carries the k-th lemma of the query's
    # multiset (lemma l repeated mult[l] times); past its end, padding
    burst = max(1, 2 * d)
    k = torch.arange(burst, device=dev).expand(b, burst).contiguous()
    lemma_of = torch.searchsorted(mult.cumsum(dim=1), k, right=True)
    lemma_of = torch.where(lemma_of < l, lemma_of, -1)
    n_bursts = -(-p_loc // burst)
    cl = randint(0, c_loc, (ns, b, n_bursts)).repeat_interleave(burst, dim=2)[..., :p_loc]
    centre = randint(0, n - width + 1, (ns, b, n_bursts)).repeat_interleave(burst, dim=2)[..., :p_loc]
    pos = centre + randint(0, width, (ns, b, p_loc))
    lem = lemma_of[:, torch.arange(p_loc, device=dev) % burst].expand(ns, b, p_loc)
    postings = torch.where((lem >= 0)[..., None], torch.stack([cl, pos, lem], dim=-1), -1)
    wild = torch.stack([randint(-1, c_loc + 2, (ns, b, p_loc)), randint(-2, n + 3, (ns, b, p_loc)),
                        randint(-1, l + 2, (ns, b, p_loc))], dim=-1)
    postings = torch.where((rand((ns, b, p_loc)) < WILD_POSTING_SHARE)[..., None], wild, postings)
    cluster_doc = (torch.arange(ns, device=dev)[:, None, None] * c_loc
                   + torch.arange(c_loc, device=dev)).expand(ns, b, c_loc)
    cluster_doc = torch.where(rand((ns, b, c_loc)) < PAD_CLUSTER_SHARE, -1, cluster_doc)
    return postings.to(torch.int32), cluster_doc.to(torch.int32), mult.to(torch.int32)


def _check_lm_outputs(cell: Cell, cfg, args: tuple, out) -> dict:
    if cell.step == "train":
        return _check_train_outputs(args, out)
    logits, cache = out
    b = args[1]["tokens"].shape[0] if cell.step == "prefill" else args[2].shape[0]
    if logits.shape != (b, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cell.step} outputs: logits {tuple(logits.shape)} (want ({b}, {cfg.vocab})), finite")
    want = args[1]["k"].shape if cell.step == "decode" else (
        cfg.n_layers, b, args[1]["tokens"].shape[1], cfg.n_kv_heads, cfg.d_head)
    if cache["k"].shape != want or cache["v"].shape != want:
        raise AssertionError(f"{cell.step} outputs: cache {tuple(cache['k'].shape)}, want {tuple(want)}")
    return {"logits_absmax": float(logits.abs().max())}


def _check_train_outputs(args: tuple, out) -> dict:
    new_params, new_state, metrics = out
    bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v))]
    if bad or int(new_state["step"]) != int(args[1]["step"]) + 1:
        raise AssertionError(f"train outputs: metrics {bad} not finite, or step {int(new_state['step'])}")
    for old, new in zip(tree_leaves(args[0]), tree_leaves(new_params)):
        if new.shape != old.shape or new.dtype != old.dtype:
            raise AssertionError(f"train outputs: a param {tuple(old.shape)} {old.dtype} became "
                                 f"{tuple(new.shape)} {new.dtype}")
    return {k: float(v) for k, v in metrics.items()}


def _check_recsys_outputs(cell: Cell, args: tuple, out) -> dict:
    if cell.step == "train":
        return _check_train_outputs(args, out)
    bat = args[1]
    n = bat["cand_ids"].shape[0] if cell.step == "retrieval" else next(iter(bat.values())).shape[0]
    if out.shape != (n,) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{cell.step} outputs: scores {tuple(out.shape)} (want ({n},)), finite")
    return {"scores_absmax": float(out.abs().max())}


def _check_outputs(cell: Cell, cfg, out, args: tuple) -> dict:
    """The outputs' shapes and invariants; a summary for the record."""
    if isinstance(cfg, recsys.RecsysConfig):
        return _check_recsys_outputs(cell, args, out)
    if isinstance(cfg, gnn.GATConfig):
        return _check_train_outputs(args, out)
    if cell.step in ("train", "prefill", "decode"):
        return _check_lm_outputs(cell, cfg, args, out)
    if cell.step == "build":
        hist, total = out["bucket_histogram"], out["n_postings"]
        if hist.shape != (cfg.build_buckets,) or int(hist.sum()) != int(total):
            raise AssertionError(f"build outputs: histogram {tuple(hist.shape)} summing to "
                                 f"{int(hist.sum())}, n_postings {int(total)}")
        return {"n_postings": int(total)}
    ns, b = cell.abstract_args[0].shape[:2]  # every shard, whatever the world
    c_loc = cell.abstract_args[1].shape[2]
    k = min(cfg.top_k, ns * min(cfg.top_k, c_loc))
    docs, scores, nfrag = out["top_docs"], out["top_scores"], out["n_fragments"]
    if docs.shape != (b, k) or scores.shape != (b, k) or nfrag.shape != (b,):
        raise AssertionError(f"serve outputs: top_docs {tuple(docs.shape)}, top_scores "
                             f"{tuple(scores.shape)}, n_fragments {tuple(nfrag.shape)}; want ({b}, {k})")
    if not bool(torch.isfinite(scores).all()) or bool((scores[:, 1:] > scores[:, :-1]).any()):
        raise AssertionError("serve outputs: top_scores not finite and descending")
    return {"n_fragments": int(nfrag.sum()), "queries_with_fragments": int((nfrag > 0).sum())}


def _shapes(x):
    if isinstance(x, dict):
        return {k: _shapes(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_shapes(v) for v in x]
    return list(x.shape)


def run_cell(arch: str, shape: str, multi_pod: bool = False, verbose: bool = True, *, device="cuda",
             repeats: int = REPEATS, spec: ArchSpec | None = None, dmesh: DeviceMesh | None = None,
             keep_outputs: bool = False) -> dict:
    """Run one cell on ``device`` at the layout's shard count: one call,
    counted (``cost_analysis.count_cost``), then ``repeats`` timed calls on
    inputs from seed 0.  ``spec`` replaces the registry's (a config cut to
    fit one card).  ``dmesh`` runs it in a world of ranks, each on its
    slices of the inputs (every rank calls it).  ``keep_outputs`` keeps
    the first call's outputs under ``"outputs"`` (not JSON)."""
    spec = spec or get_spec(arch)
    cell_meta = spec.shapes[shape]
    mesh = make_production_mesh(multi_pod=multi_pod)
    dev = torch.device(device) if dmesh is None else dmesh.device
    on_card = dev.type == "cuda"
    verbose = verbose and (dmesh is None or dmesh.rank == 0)
    rec: dict = {
        "arch": arch, "shape": shape, "step": cell_meta.step,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "n_devices": mesh.size,
        "kind": cell_meta.kind,
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if on_card else "cpu",
    }
    if dmesh is not None:
        rec.update(device_mesh=str(dmesh), backend=dmesh.backend, world=dmesh.size, rank=dmesh.rank)
    if cell_meta.skip_reason is not None:
        rec["status"] = "skipped"
        rec["skip_reason"] = cell_meta.skip_reason
        return rec
    t0 = time.perf_counter()
    try:
        cell = build_cell(spec, shape, mesh, dmesh)
        cfg = spec.cfg_for(shape)
        lm = spec.family == "lm"
        share = None
        if lm:
            global_batch = cell_meta.kwargs["global_batch"]
            share, data = data_share(global_batch, mesh)
        base_bytes = 0
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base_bytes = torch.cuda.memory_allocated(dev)
        args = cell_inputs(cell, cfg, device=dev, batch=share)
        if dmesh is not None:
            # every rank drew the same inputs: keep this rank's slices
            args = tuple(shard_tree(a, sanitize_specs(s, a, dmesh), dmesh) for a, s in zip(args, cell.in_specs))
        if on_card:
            torch.cuda.synchronize(dev)
        t_inputs = time.perf_counter() - t0
        t_first = time.perf_counter()
        out, cost = count_cost(cell.fn, *args)
        summary = _check_outputs(cell, cfg, out, args)
        if keep_outputs:
            rec["outputs"] = out
        del out
        if on_card:
            torch.cuda.synchronize(dev)
        t_first = time.perf_counter() - t_first
        wall_ms = []
        for _ in range(repeats):
            if on_card:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                cell.fn(*args)
                end.record()
                end.synchronize()
                wall_ms.append(start.elapsed_time(end))
            else:
                t = time.perf_counter()
                cell.fn(*args)
                wall_ms.append((time.perf_counter() - t) * 1e3)
        rec.update(
            status="ok",
            inputs_s=round(t_inputs, 3),
            first_call_s=round(t_first, 3),
            wall_ms=wall_ms,
            # the cell's own: above what the device held before its inputs
            peak_bytes=int(torch.cuda.max_memory_allocated(dev)) - base_bytes if on_card else None,
            calls=1 + repeats,
            input_shapes=[_shapes(a) for a in args],
            # per card: the work this run does (an LM cell's data-rank share)
            flops_per_device=cost.flops,
            hbm_bytes_per_device=cost.hbm_bytes,
            collective_bytes_per_device=dict(cost.collectives),
            collective_total_per_device=cost.collective_bytes,
            model_flops_global=float(cell.model_flops_fn()),
            result=summary,
            notes=cell.notes,
        )
        if lm:
            # every LM useful-work model is linear in the batch
            rec["model_flops_share"] = rec["model_flops_global"] * share / global_batch
            rec["notes"] = "; ".join(x for x in (
                f"data-rank share: batch {share} of global batch {global_batch} ({data} data ranks)",
                cell.notes) if x)
        del args
        if verbose:
            peak = f"{rec['peak_bytes'] / 2**20:.1f} MiB" if on_card else "not measured"
            rate = (f" share {rec['model_flops_share'] / min(wall_ms) / 1e9:.1f} model TFLOP/s"
                    if lm and on_card else "")
            world = f", world {dmesh} {dmesh.backend}" if dmesh is not None else ""
            print(f"[dryrun] {arch} x {shape} ({rec['mesh']}{world}, {rec['device_name']}): OK "
                  f"wall={min(wall_ms):.3f} ms (of {repeats}) peak={peak}{rate} "
                  f"flops/dev={cost.flops:.3e} hbm/dev={cost.hbm_bytes:.3e} "
                  f"coll/dev={cost.collective_bytes:.3e}B first={t_first:.2f}s {summary}")
    except Exception as e:  # a dry-run failure is a bug in the system
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch} x {shape}: FAIL {rec['error'][:200]}")
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every shape of --arch, or of every architecture")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL (or PODxDATAxMODEL) of the world's ranks; default: the whole world on data")
    ap.add_argument("--backend", default=None, help="the world's process group: nccl (default on cuda) or gloo")
    args = ap.parse_args(argv)

    dmesh = None
    world = world_from_env()
    if world > 1 or args.mesh is not None:
        shape, names = parse_mesh(args.mesh, world)
        backend = args.backend or ("nccl" if torch.device(args.device).type == "cuda" else "gloo")
        dmesh = make_device_mesh(shape, names, backend=backend, device=args.device)
    lead = dmesh is None or dmesh.rank == 0

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    targets: list[tuple[str, str]] = []
    if args.all:
        for arch in (args.arch,) if args.arch else ARCH_IDS:
            targets.extend((arch, name) for name in get_spec(arch).shapes)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        targets.append((args.arch, args.shape))

    n_fail = 0
    for multi_pod in meshes:
        for arch, shape in targets:
            tag = "multipod" if multi_pod else "singlepod"
            if dmesh is not None:
                tag += f"__world{dmesh}"
            safe_shape = shape.replace("[", "_").replace("]", "")
            path = outdir / f"{arch}__{safe_shape}__{tag}.json"
            if dmesh is None and path.exists():
                prev = json.loads(path.read_text())
                if prev.get("status") in ("ok", "skipped"):
                    print(f"[dryrun] {arch} x {shape} ({tag}): cached")
                    continue
            rec = run_cell(arch, shape, multi_pod, device=args.device, dmesh=dmesh)
            if lead:
                path.write_text(json.dumps(rec, indent=2))
            if rec["status"] == "error":
                n_fail += 1
                if not lead:  # rank 0 prints only its own
                    print(f"[dryrun] rank {dmesh.rank}: {arch} x {shape}: FAIL {rec['error'][:200]}")
    if lead:
        print(f"[dryrun] done; {n_fail} failures")
    if dmesh is not None:
        torch.distributed.destroy_process_group()
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
