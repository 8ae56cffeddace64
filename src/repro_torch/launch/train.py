"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [options]``.

The reference's ``repro/launch/train.py`` on one device: the same flags,
defaults and printed lines, plus ``--device`` (default ``cuda``).  It runs
real steps of the cell the dry-run runs (``launch/steps.build_cell``: one
code path), on deterministic pipeline batches, with asynchronous checkpoints
every ``--ckpt-every`` steps.  Without ``--full-scale`` it trains the
reduced config (CPU-sized) on the cell's batch; with it, the full config.
An LM (dense or MoE) trains on one data rank's share of the cell's global
batch (``global_batch // data``, ``data`` 16 on the single-pod layout), at
the full sequence length; a recsys model on the whole batch, whose first
batch is drawn as the reference draws it (``dryrun.recsys_batch``); the GNN
on the cell's whole graph, drawn as the reference draws it
(``dryrun.gnn_batch``), the same batch every step.

Started by ``python -m torch.distributed.run --nproc-per-node N`` (or with
``--mesh``), an LM trains in a world of ranks on a ``DeviceMesh`` of
``--mesh DATAxMODEL`` (default: the whole world on ``data``) over
``--backend`` (default ``nccl`` on the card, ``gloo`` on the CPU): every
rank initialises the same params and draws the same batches, and keeps its
slices of them under the cell's ``in_specs`` (``shard_tree``); the batch
is split over the world's data axes.  Only rank 0 prints, and a checkpoint
is gathered to rank 0 and written by it, as a one-rank run writes it.

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.train \
        --arch tinyllama-1.1b --steps 6 --device cpu --mesh 1x2

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 6 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b --steps 6 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch dcn-v2 --steps 6 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gat-cora --steps 6 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b --full-scale --steps 6
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed

from ..checkpoint import CheckpointManager
from ..configs import get_reduced_spec, get_spec
from ..data.pipeline import LMTokenPipeline
from ..models import gnn, recsys, transformer
from ..optim import adamw_init
from ..parallel.sharding import P, sanitize_specs, shard_tree
from ..tree import tree_map
from .dryrun import data_share, gnn_batch, recsys_batch
from .mesh import make_device_mesh, make_production_mesh, make_smoke_mesh, parse_mesh, world_from_env
from .steps import build_cell


def _to_device(batch: dict, device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None, help="defaults to the train cell")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--full-scale", action="store_true",
                    help="use the full config, on one data rank's share of the global batch")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL (or PODxDATAxMODEL) of the world's ranks; default: the whole world on data")
    ap.add_argument("--backend", default=None, help="the world's process group: nccl (default on cuda) or gloo")
    args = ap.parse_args(argv)
    dmesh = None
    world = world_from_env()
    if world > 1 or args.mesh is not None:
        shape_, names = parse_mesh(args.mesh, world)
        backend = args.backend or ("nccl" if torch.device(args.device).type == "cuda" else "gloo")
        dmesh = make_device_mesh(shape_, names, backend=backend, device=args.device)
    lead = dmesh is None or dmesh.rank == 0

    spec = get_spec(args.arch) if args.full_scale else get_reduced_spec(args.arch)
    shape = args.shape
    if shape is None:
        shape = next(n for n, c in spec.shapes.items() if c.step == "train")
    mesh = make_production_mesh() if args.full_scale else make_smoke_mesh()
    cell = build_cell(spec, shape, mesh, dmesh)
    kw = spec.shapes[shape].kwargs
    device = torch.device(args.device) if dmesh is None else dmesh.device

    cfg = spec.cfg_for(shape)
    if spec.family == "lm":
        params = transformer.init_params(0, cfg, device=device)
        pipe = LMTokenPipeline(cfg.vocab, kw["seq_len"], data_share(kw["global_batch"], mesh)[0], seed=0)
        batch = pipe.next_batch()
    elif spec.family == "gnn":
        params = gnn.init_gat_params(0, cfg, device=device)
        n_graphs = kw.get("batch_graphs", 1)
        batch, pipe = gnn_batch(cfg, kw["n_nodes"], kw["n_edges"], n_graphs), None
    else:
        params = recsys.init_recsys_params(0, cfg, device=device)
        batch, pipe = recsys_batch(cfg, kw["batch"])
    batch = _to_device(batch, device)
    p_specs, _, b_specs = cell.in_specs
    if dmesh is not None:
        params = shard_tree(params, p_specs, dmesh)

    def local(b: dict) -> dict:
        return b if dmesh is None else shard_tree(b, sanitize_specs(b_specs, b, dmesh), dmesh)

    opt_state = adamw_init(params)
    batch = local(batch)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    t0 = time.time()
    for step in range(args.steps):
        if pipe is not None and step > 0:
            nb = pipe.next_batch()
            # a pipeline batch with the first batch's keys replaces it
            batch = local(_to_device(nb, device)) if set(nb) == set(batch) else batch
        params, opt_state, metrics = cell.fn(params, opt_state, batch)
        if lead and (step % 5 == 0 or step == args.steps - 1):
            # in sorted key order, as the reference's jitted step returns them
            m = {k: float(metrics[k]) for k in sorted(metrics)}
            print(f"step {step:4d} " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
        if mgr and (step + 1) % args.ckpt_every == 0:
            payload = {"params": params, "opt": opt_state, "pipe": pipe.state.as_tree() if pipe else {}}
            if dmesh is not None:
                specs = {"params": p_specs, "opt": cell.in_specs[1], "pipe": tree_map(lambda _: P(), payload["pipe"])}
                mgr.save_async(step + 1, payload, mesh=dmesh, specs=specs)
            else:
                mgr.save_async(step + 1, payload)
    if mgr:
        mgr.wait()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    if lead:
        print(f"done: {args.steps} steps in {dt:.1f}s ({dt/args.steps*1000:.0f} ms/step)")
    if dmesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
