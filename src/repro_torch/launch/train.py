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

from ..checkpoint import CheckpointManager
from ..configs import get_reduced_spec, get_spec
from ..data.pipeline import LMTokenPipeline
from ..models import gnn, recsys, transformer
from ..optim import adamw_init
from .dryrun import data_share, gnn_batch, recsys_batch
from .mesh import make_production_mesh, make_smoke_mesh
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
    args = ap.parse_args(argv)

    spec = get_spec(args.arch) if args.full_scale else get_reduced_spec(args.arch)
    shape = args.shape
    if shape is None:
        shape = next(n for n, c in spec.shapes.items() if c.step == "train")
    mesh = make_production_mesh() if args.full_scale else make_smoke_mesh()
    cell = build_cell(spec, shape, mesh)
    kw = spec.shapes[shape].kwargs
    device = torch.device(args.device)

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
    opt_state = adamw_init(params)
    batch = _to_device(batch, device)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    t0 = time.time()
    for step in range(args.steps):
        if pipe is not None and step > 0:
            nb = pipe.next_batch()
            # a pipeline batch with the first batch's keys replaces it
            batch = _to_device(nb, device) if set(nb) == set(batch) else batch
        params, opt_state, metrics = cell.fn(params, opt_state, batch)
        if step % 5 == 0 or step == args.steps - 1:
            # in sorted key order, as the reference's jitted step returns them
            m = {k: float(metrics[k]) for k in sorted(metrics)}
            print(f"step {step:4d} " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save_async(step + 1, {"params": params, "opt": opt_state,
                                      "pipe": pipe.state.as_tree() if pipe else {}})
    if mgr:
        mgr.wait()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s ({dt/args.steps*1000:.0f} ms/step)")


if __name__ == "__main__":
    main()
