"""The port's side of the multi-rank LM tests, run in each rank of a gloo
world (``_torch_worlds.run_world``); this module imports neither jax nor
the reference, so a rank starts with torch and the port alone."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_reduced_spec
from repro_torch.launch.mesh import make_device_mesh, make_smoke_mesh, use_mesh
from repro_torch.launch.steps import _value_and_grad, build_cell, sync_grads
from repro_torch.models import moe, transformer
from repro_torch.models.convert import from_reference
from repro_torch.optim import adamw_init, global_norm
from repro_torch.parallel.collectives import all_reduce
from repro_torch.parallel.sharding import P, gather_tree, sanitize_specs, shard_tree
from repro_torch.tree import tree_map


def _np(tree):
    return tree_map(lambda t: t.detach().float().numpy() if isinstance(t, torch.Tensor) else t, tree)


def lm_case(payload):
    """For each case ``(arch, mesh shape, fsdp, cfg changes)``: the loss,
    metrics and gathered gradients of one step on the payload's first
    batch, and the gathered params and metrics of three train steps (one a
    batch), under a mesh of the world; numpy trees."""
    out = {}
    for key, (arch, shape, fsdp, changes) in payload["cases"].items():
        mesh = make_device_mesh(shape, ("data", "model"), backend="gloo", device="cpu")
        spec = get_reduced_spec(arch)
        changes = dict(changes)
        if "moe" in changes:
            changes["moe"] = moe.MoEConfig(**changes["moe"])
        cfg = dataclasses.replace(spec.model_cfg, dtype="float32", fsdp=fsdp, **changes)
        spec = dataclasses.replace(spec, model_cfg=cfg)
        cell = build_cell(spec, "train_4k", make_smoke_mesh(), mesh)
        p_specs, _, b_specs = cell.in_specs
        full = from_reference(payload["params"][payload["params_of"][key]], device="cpu")
        params = shard_tree(full, p_specs, mesh)
        batches = [shard_tree({k: torch.from_numpy(v) for k, v in b.items()},
                              sanitize_specs(b_specs, {k: torch.from_numpy(v) for k, v in b.items()}, mesh), mesh)
                   for b in payload["batches"]]
        with use_mesh(mesh):
            loss, metrics, grads = _value_and_grad(transformer.loss_fn, params, batches[0], cfg)
            grads = sync_grads(grads, p_specs, mesh)
        res = {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
               "grads": _np(gather_tree(grads, p_specs, mesh)), "steps": []}
        opt = adamw_init(params)
        for b in batches:
            params, opt, m = cell.fn(params, opt, b)
            res["steps"].append({k: float(v) for k, v in m.items()})
        res["params"] = _np(gather_tree(params, p_specs, mesh))
        res["opt_step"] = int(opt["step"])
        res["in_specs"] = _flat_specs(cell.in_specs)
        out[key] = res
    return out


def _flat_specs(in_specs) -> list:
    """A cell's ``in_specs``: per argument, a dict of path -> spec tuple."""
    from repro_torch.parallel.sharding import map_with_path

    specs = []
    for tree in in_specs:
        flat = {}
        map_with_path(lambda path, s: flat.__setitem__(path, tuple(s)), tree)
        specs.append(flat)
    return specs


def share_case(payload):
    """The reduced tinyllama's train_4k cell through ``run_cell`` under each
    mesh of the payload, with the smoke's scaled-share spec (``chip_smoke.
    world_lm_spec``: ``payload["rows"]`` rows a data rank, the cell's global
    batch scaled by the mesh's data size), and without a mesh on the same
    spec: the whole batch ``run_cell`` drew, this rank's rows of it, and the
    metrics of both steps."""
    import chip_smoke
    from repro_torch.launch import dryrun

    out = {}
    for shape in payload["meshes"]:
        mesh = make_device_mesh(shape, ("data", "model"), backend="gloo", device="cpu")
        base = get_reduced_spec("tinyllama-1.1b")
        base = dataclasses.replace(base, model_cfg=dataclasses.replace(base.model_cfg, dtype="float32"))
        spec = chip_smoke.world_lm_spec("train_4k", rows=payload["rows"] * mesh.axis_size("data"),
                                        layers=base.model_cfg.n_layers, spec=base)
        drawn, cut = [], []
        cell_inputs, shard = dryrun.cell_inputs, dryrun.shard_tree
        dryrun.cell_inputs = lambda *a, **k: drawn.append(cell_inputs(*a, **k)) or drawn[-1]
        dryrun.shard_tree = lambda *a, **k: cut.append(shard(*a, **k)) or cut[-1]
        try:
            got = dryrun.run_cell("tinyllama-1.1b", "train_4k", verbose=False, device="cpu", dmesh=mesh, repeats=0,
                                  spec=spec, keep_outputs=True)
        finally:
            dryrun.cell_inputs, dryrun.shard_tree = cell_inputs, shard
        want = dryrun.run_cell("tinyllama-1.1b", "train_4k", verbose=False, device="cpu", repeats=0, spec=spec,
                               keep_outputs=True)
        assert got["status"] == "ok" and want["status"] == "ok", (got.get("traceback"), want.get("traceback"))
        out[shape] = {"global_tokens": drawn[0][2]["tokens"].numpy(), "tokens": cut[-1]["tokens"].numpy(),
                      "metrics": {k: float(v) for k, v in got["outputs"][2].items()},
                      "metrics_unsharded": {k: float(v) for k, v in want["outputs"][2].items()},
                      "in_specs": _flat_specs(build_cell(spec, "train_4k", dryrun.make_production_mesh(),
                                                         mesh).in_specs)}
    return out


def global_norm_case(payload):
    """``global_norm`` of a tree's shards under every mesh of the payload,
    against the norm of the whole tree; each leaf's spec shards it over
    some axes and replicates it over the others."""
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(8,)).astype(np.float32)),
            "c": torch.from_numpy(rng.normal(size=(2, 4, 2)).astype(np.float32)),
            "d": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32))}
    specs = {"a": P("data", "model"), "b": P("model"), "c": P(None, "data"), "d": P()}
    out = {"whole": float(global_norm(tree))}
    for shape in payload["meshes"]:
        mesh = make_device_mesh(shape, ("data", "model"), backend="gloo", device="cpu")
        local = shard_tree(tree, specs, mesh)
        # what summing every rank's squares would give: replicated copies
        # counted once for each rank that holds one
        squares = sum((x.float() ** 2).sum() for x in local.values())
        out[shape] = {"sharded": float(global_norm(local, specs=specs, mesh=mesh)),
                      "naive": float(torch.sqrt(all_reduce(squares, mesh, mesh.axis_names)))}
    return out


def moe_local_case(payload):
    """``moe_ffn`` with the ``local`` dispatch under the payload's mesh, for
    each capacity factor: the whole output (gathered over the data axes),
    the aux loss, and the dropped pairs (gathered)."""
    from repro_torch.parallel.collectives import all_gather

    mesh = make_device_mesh(payload["mesh"], ("data", "model"), backend="gloo", device="cpu")
    full = from_reference(payload["params"], device="cpu")
    local = shard_tree(full, {"router": P(), "w_gate": P("model"), "w_up": P("model"), "w_down": P("model")}, mesh)
    x = torch.from_numpy(payload["x"])
    rows = x.shape[0] // mesh.axis_size("data")
    x_loc = x[mesh.coord("data") * rows:(mesh.coord("data") + 1) * rows]
    out = {}
    for cf in payload["capacity_factors"]:
        cfg = moe.MoEConfig(**{**payload["cfg"], "capacity_factor": cf})
        with use_mesh(mesh):
            y, aux = moe.moe_ffn(x_loc, local, cfg)
            dropped = moe.dropped_slots(x_loc, local, cfg)
        out[cf] = {"y": all_gather(y, mesh, "data", 0).numpy(), "aux": float(aux),
                   "dropped": all_gather(dropped.view(x_loc.shape[0], x_loc.shape[1], -1), mesh, "data", 0).numpy()}
    return out


def collectives_case(payload):
    """The collective bytes the cost counter charges one rank for the
    reduced cells' first call under the payload's mesh (a decode cell's
    batch holds the cache's ``k`` and ``v``, ``tokens`` and ``cache_len``)."""
    from repro_torch.launch.cost_analysis import count_cost

    mesh = make_device_mesh(payload["mesh"], ("data", "model"), backend="gloo", device="cpu")
    out = {}
    for arch, shape in payload["cells"]:
        spec = get_reduced_spec(arch)
        if spec.model_cfg is not None:  # gat-cora's config follows its cell
            spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(spec.model_cfg, dtype="float32"))
        cell = build_cell(spec, shape, make_smoke_mesh(), mesh)
        full = from_reference(payload["params"][arch], device="cpu")
        args = [full]
        bat = {k: torch.from_numpy(np.asarray(v)) for k, v in payload["batch"][shape].items()}
        if cell.step == "train":
            args.append(adamw_init(full))
        if cell.step == "decode":
            args += [{k: bat[k] for k in ("k", "v")}, bat["tokens"], bat["cache_len"]]
        else:
            args.append({k: bat[k] for k in cell.abstract_args[-1]})
        local = [shard_tree(a, sanitize_specs(s, a, mesh), mesh) for a, s in zip(args, cell.in_specs)]
        _, cost = count_cost(cell.fn, *local)
        out[(arch, shape)] = dict(cost.collectives)
    return out


def checkpoint_case(payload):
    """Save this world's shards of a train state (params and AdamW state
    of the reduced tinyllama under FSDP, after one step) to
    ``payload["save"]``, and restore ``payload["restore"]`` (written by
    another world) into this mesh's slices: whether they equal the slices
    of the whole state."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint

    mesh = make_device_mesh(payload["mesh"], ("data", "model"), backend="gloo", device="cpu")
    spec = get_reduced_spec("tinyllama-1.1b")
    spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(spec.model_cfg, fsdp=True))
    cell = build_cell(spec, "train_4k", make_smoke_mesh(), mesh)
    specs = {"params": cell.in_specs[0], "opt": cell.in_specs[1]}
    whole = {"params": from_reference(payload["params"], device="cpu"),
             "opt": from_reference(payload["opt"], device="cpu")}
    mine = shard_tree(whole, specs, mesh)
    out = {}
    if payload.get("save"):
        out["saved"] = str(save_checkpoint(payload["save"], 1, mine, mesh=mesh, specs=specs))
    if payload.get("restore"):
        got, step = restore_checkpoint(payload["restore"], whole, device="cpu", mesh=mesh, specs=specs)
        from repro_torch.tree import tree_leaves

        out["restored_step"] = step
        out["restored_equal"] = all(a.dtype == b.dtype and torch.equal(a, b)
                                    for a, b in zip(tree_leaves(got), tree_leaves(mine)))
    return out


def train_cli_case(payload):
    """``python -m repro_torch.launch.train --mesh ...`` in this rank (the
    world's process group is up, over the backend the flags name): what it
    printed, and the checkpoint directory it wrote."""
    import contextlib
    import io

    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(payload["argv"])
    return {"stdout": buf.getvalue()}


def _cut_spec(arch: str, dtype: str, changes: dict):
    """The reduced spec of ``arch`` in ``dtype`` with the config ``changes``
    (a ``moe`` entry is a dict of ``MoEConfig`` fields, merged into the
    config's)."""
    spec = get_reduced_spec(arch)
    changes = dict(changes)
    if "moe" in changes:
        changes["moe"] = dataclasses.replace(spec.model_cfg.moe, **changes["moe"])
    return dataclasses.replace(spec, model_cfg=dataclasses.replace(spec.model_cfg, dtype=dtype, **changes))


def serve_case(payload):
    """For each case ``{arch, changes, dtype, mesh, shape, inputs}``: the
    prefill or decode cell of the reduced spec under a mesh of the world,
    run on the named inputs (numpy, float32 values of the config's dtype)
    cut by the cell's ``in_specs``; the logits and the new cache, gathered
    (``gather_tree``), the ``in_specs`` as tuples, and the collective bytes
    the cost counter charged this rank; numpy trees."""
    from repro_torch.launch.cost_analysis import count_cost
    from repro_torch.parallel.sharding import map_with_path

    meshes = {}
    out = {}
    for key, case in payload["cases"].items():
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_device_mesh(shape, ("data", "model"), backend="gloo", device="cpu")
        mesh = meshes[shape]
        spec = _cut_spec(case["arch"], case["dtype"], case.get("changes", {}))
        if "seq_len" in case:  # a cache of another length than the cell's
            c = spec.shapes[case["shape"]]
            c = dataclasses.replace(c, kwargs={**c.kwargs, "seq_len": case["seq_len"]})
            spec = dataclasses.replace(spec, shapes={**spec.shapes, case["shape"]: c})
        cfg = spec.model_cfg
        cell = build_cell(spec, case["shape"], make_smoke_mesh(), mesh)
        inputs = payload["inputs"][case["inputs"]]
        params = tree_map(lambda t: t.to(cfg.torch_dtype), from_reference(payload["params"][case["params"]],
                                                                          device="cpu"))
        if cell.step == "decode":
            cache = {k: torch.from_numpy(inputs[k]).to(cfg.torch_dtype) for k in ("k", "v")}
            args = (params, cache, torch.from_numpy(inputs["tokens"]), torch.tensor(int(inputs["cache_len"])))
        else:
            args = (params, {"tokens": torch.from_numpy(inputs["tokens"])})
        local = [shard_tree(a, sanitize_specs(s, a, mesh), mesh) for a, s in zip(args, cell.in_specs)]
        (logits, cache), cost = count_cost(cell.fn, *local)
        # the batch rows over the data axes where they divide; a prefill's
        # cache comes back whole over `model`, a decode's as its in_specs
        rows = cell.in_specs[2][0] if cell.step == "decode" else cell.in_specs[1]["tokens"][0]
        cache_specs = cell.in_specs[1] if cell.step == "decode" else {k: P(None, rows) for k in ("k", "v")}
        whole = gather_tree({"logits": logits, "cache": cache}, {"logits": P(rows), "cache": cache_specs}, mesh)
        specs = []
        for tree in cell.in_specs:
            flat = {}
            map_with_path(lambda path, s: flat.__setitem__(path, tuple(s)), tree)
            specs.append(flat)
        out[key] = {"logits": _np(whole["logits"]), "cache": _np(whole["cache"]), "in_specs": specs,
                    "local_cache_rows": int(cache["k"].shape[2]), "collectives": dict(cost.collectives)}
    return out


def train_and_serve_case(payload):
    """``lm_case`` of ``payload["train"]`` and ``serve_case`` of
    ``payload["serve"]`` in one world."""
    return {"train": lm_case(payload["train"]), "serve": serve_case(payload["serve"])}


def _cell_spec(arch: str, shape: str, cut: dict | None):
    """The reduced spec of ``arch``; ``cut``: the kwargs of a cell named
    ``shape`` added to it (a train cell, as a GNN cut of a full cell)."""
    from repro_torch.configs.common import ShapeCell

    spec = get_reduced_spec(arch)
    if cut:
        spec = dataclasses.replace(spec, shapes={**spec.shapes, shape: ShapeCell(name=shape, step="train",
                                                                                  kind="cut", kwargs=cut)})
    return spec


def family_case(payload):
    """For each case ``{arch, shape, mesh, params, inputs, (cut)}``: the
    recsys or GNN cell under a mesh of the world, on the named inputs
    (numpy) cut by its ``in_specs``.  A train cell: the loss, the metrics
    and the gathered gradients of ``value_and_grad`` on this rank's share
    (summed over the data axes as the cell sums them), then one step of the
    cell (its metrics and the gathered params); a score or retrieval cell:
    its outputs gathered over the axes its rows split over.  With each, the
    ``in_specs`` as tuples and the collective bytes the cost counter
    charged this rank for the cell's call.  ``payload["save"]``: a
    directory each world saves ``payload["state"]`` into, sharded under the
    case ``payload["save_case"]``'s train specs."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch.cost_analysis import count_cost
    from repro_torch.models import gnn, recsys
    from repro_torch.parallel.collectives import all_gather
    from repro_torch.parallel.sharding import map_with_path

    meshes: dict = {}
    out = {}
    for key, case in payload["cases"].items():
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_device_mesh(shape, ("data", "model"), backend="gloo", device="cpu")
        mesh = meshes[shape]
        spec = _cell_spec(case["arch"], case["shape"], case.get("cut"))
        cfg = spec.cfg_for(case["shape"])
        cell = build_cell(spec, case["shape"], make_smoke_mesh(), mesh)
        p_specs, b_specs = cell.in_specs[0], cell.in_specs[-1]
        params = shard_tree(from_reference(payload["params"][case["params"]], device="cpu"), p_specs, mesh)
        bat = shard_tree({k: torch.from_numpy(np.asarray(v)) for k, v in payload["inputs"][case["inputs"]].items()},
                         b_specs, mesh)
        specs = []
        for tree in cell.in_specs:
            flat = {}
            map_with_path(lambda path, s: flat.__setitem__(path, tuple(s)), tree)
            specs.append(flat)
        res = {"in_specs": specs}
        if cell.step == "train":
            if spec.family == "gnn":
                n_graphs = spec.shapes[case["shape"]].kwargs.get("batch_graphs", 1)
                shards = gnn.GATShards(mesh, b_specs["src"][0], b_specs["x"][0] == "data")
                loss, metrics, grads = _value_and_grad(gnn.gat_loss, params, bat, cfg, n_graphs=n_graphs,
                                                       shards=shards)
            else:
                with use_mesh(mesh):
                    loss, metrics, grads = _value_and_grad(recsys.recsys_loss, params, bat, cfg,
                                                           rows=b_specs[sorted(b_specs)[0]][0])
                    grads = sync_grads(grads, p_specs, mesh)
            res.update(loss=float(loss), metrics={k: float(v) for k, v in metrics.items()},
                       grads=_np(gather_tree(grads, p_specs, mesh)))
            (new, _, m), cost = count_cost(cell.fn, params, adamw_init(params), bat)
            res.update(step={k: float(v) for k, v in m.items()}, params=_np(gather_tree(new, p_specs, mesh)))
        else:
            scores, cost = count_cost(cell.fn, params, bat)
            axes = (b_specs["cand_ids"] if "cand_ids" in b_specs else b_specs[sorted(b_specs)[0]])[0]
            res["scores"] = (all_gather(scores, mesh, axes, 0) if axes else scores).numpy()
        res["collectives"] = dict(cost.collectives)
        out[key] = res
        if key == payload.get("save_case"):
            state = {"params": from_reference(payload["state"]["params"], device="cpu"),
                     "opt": from_reference(payload["state"]["opt"], device="cpu")}
            sp = {"params": p_specs, "opt": cell.in_specs[1]}
            save_checkpoint(payload["save"], 1, shard_tree(state, sp, mesh), mesh=mesh, specs=sp)
    return out
