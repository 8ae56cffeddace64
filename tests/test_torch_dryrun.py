"""The port's dry-run (``repro_torch.configs``, ``launch/{mesh,steps,dryrun}``)
against the reference's, on the CPU: the same cells, shapes, dtypes, shard
counts and useful-work models for ``paper_search`` and the dense LMs (whose
cells run one data rank's share); ``run_cell`` and ``main`` on the reduced
spec; every architecture id resolves, and the MoE, recsys and GNN
families build and run.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import ASSIGNED_ARCH_IDS as REF_ASSIGNED_ARCH_IDS
from repro.configs import get_reduced_spec as ref_get_reduced_spec
from repro.configs import get_spec as ref_get_spec
from repro.launch.mesh import make_smoke_mesh as ref_make_smoke_mesh
from repro.launch.steps import build_cell as ref_build_cell
from repro_torch.configs import (
    ARCH_IDS,
    ASSIGNED_ARCH_IDS,
    PORTED_ARCH_IDS,
    get_reduced_spec,
    get_spec,
)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.launch.steps import build_cell, input_specs

SHAPES = ["serve_online", "serve_bulk", "score_1m", "build_chunk"]
_DTYPES = {jnp.int32: torch.int32, jnp.bool_: torch.bool}


def _ref_layout(shape, axis_names):
    """A stand-in for a reference mesh of ``shape`` devices: what
    ``launch/steps._search_cell`` reads of a mesh (its size, axis names and
    device shape), without 256 devices."""
    return types.SimpleNamespace(devices=np.empty(shape, dtype=object), axis_names=axis_names)


def _assert_same_args(port_args, ref_args):
    assert len(port_args) == len(ref_args)
    for got, want in zip(port_args, ref_args):
        assert got.device.type == "meta"
        assert tuple(got.shape) == tuple(want.shape)
        assert got.dtype == _DTYPES[want.dtype.type]


def test_configs_are_the_reference_configs():
    assert ARCH_IDS == REF_ARCH_IDS and ASSIGNED_ARCH_IDS == REF_ASSIGNED_ARCH_IDS
    assert PORTED_ARCH_IDS == REF_ARCH_IDS
    for arch in PORTED_ARCH_IDS:
        for get, ref_get in ((get_spec, ref_get_spec), (get_reduced_spec, ref_get_reduced_spec)):
            spec, ref = get(arch), ref_get(arch)
            assert (spec.arch_id, spec.family, spec.source) == (ref.arch_id, ref.family, ref.source)
            # a GNN config varies by cell (each cell is another graph)
            for name in ref.shapes:
                assert dataclasses.asdict(spec.cfg_for(name)) == dataclasses.asdict(ref.cfg_for(name))
            assert {k: dataclasses.asdict(v) for k, v in spec.shapes.items()} == {
                k: dataclasses.asdict(v) for k, v in ref.shapes.items()}


@pytest.mark.parametrize("shape", SHAPES)
def test_input_specs_equal_the_reference_abstract_args(shape):
    ref = ref_build_cell(ref_get_spec("paper_search"), shape, ref_make_smoke_mesh())
    _assert_same_args(input_specs("paper_search", shape, make_smoke_mesh()), ref.abstract_args)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_production_layouts_follow_the_reference(shape, multi_pod):
    """NS 256 single-pod and 512 multi-pod: the same C_loc, P_loc, shapes
    and useful-work model as the reference's ``_search_cell``."""
    layout = make_production_mesh(multi_pod=multi_pod)
    assert layout.size == (512 if multi_pod else 256)
    spec = get_spec("paper_search")
    cell = build_cell(spec, shape, layout)
    ref = ref_build_cell(ref_get_spec("paper_search"), shape,
                         _ref_layout(layout.shape, layout.axis_names))
    _assert_same_args(cell.abstract_args, ref.abstract_args)
    assert cell.model_flops_fn() == ref.model_flops_fn()
    assert (cell.step, cell.shape_name, cell.arch_id) == (ref.step, ref.shape_name, ref.arch_id)
    if cell.step == "serve":
        kw = spec.shapes[shape].kwargs
        ns = layout.size
        assert cell.abstract_args[0].shape == (ns, kw["batch"], max(1, -(-kw["postings"] // ns)), 3)
        assert cell.abstract_args[1].shape[2] == max(1, -(-max(kw["clusters"], ns) // ns))


def test_input_specs_default_to_the_single_pod_layout():
    assert input_specs("paper_search", "score_1m")[0].shape == (256, 8, 1024, 3)
    assert input_specs("paper_search", "score_1m")[1].shape == (256, 8, 512)


@pytest.mark.parametrize("shape", ["serve_online", "build_chunk"])
def test_run_cell_on_the_cpu_reduced_spec(shape, monkeypatch):
    monkeypatch.setattr(dryrun, "get_spec", get_reduced_spec)
    rec = dryrun.run_cell("paper_search", shape, False, verbose=False, device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert rec["device"] == "cpu" and rec["device_name"] == "cpu" and rec["peak_bytes"] is None
    assert len(rec["wall_ms"]) == dryrun.REPEATS == rec["calls"] - 1 and rec["model_flops_global"] > 0
    json.dumps(rec)


def test_cell_inputs_are_seeded_and_dense_enough_to_cover():
    spec = get_reduced_spec("paper_search")
    cell = build_cell(spec, "serve_online", make_smoke_mesh())
    a = dryrun.cell_inputs(cell, spec.model_cfg, seed=3, device="cpu")
    b = dryrun.cell_inputs(cell, spec.model_cfg, seed=3, device="cpu")
    for x, y, meta in zip(a, b, cell.abstract_args):
        assert torch.equal(x, y) and x.shape == meta.shape and x.dtype == meta.dtype
    active = (a[2] > 0).sum(dim=1)
    assert ((active >= 3) & (active <= 5)).all() and a[2].max() <= 2
    out = cell.fn(*a)
    assert int(out["n_fragments"].sum()) > 0
    # at serve_online's single-pod shapes (inputs only): about a tenth of
    # the clusters padded, a few postings out of range
    full = get_spec("paper_search")
    cell = build_cell(full, "serve_online", make_production_mesh())
    post, cluster_doc, mult = dryrun.cell_inputs(cell, full.model_cfg, seed=0, device="cpu")
    assert 0.08 < float((cluster_doc == -1).float().mean()) < 0.12
    cl, pos, lem = post.unbind(-1)
    wild = (cl < -1) | (cl >= cluster_doc.shape[2]) | (pos >= full.model_cfg.window_len) | (lem >= mult.shape[1])
    assert 0 < int(wild.sum()) < post.shape[:3].numel() // 256


def test_main_runs_caches_and_exits_zero(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "get_spec", get_reduced_spec)
    argv = ["--arch", "paper_search", "--all", "--device", "cpu", "--out", str(tmp_path)]
    with pytest.raises(SystemExit) as exc:
        dryrun.main(argv)
    assert exc.value.code == 0
    records = sorted(tmp_path.glob("*.json"))
    assert [p.name for p in records] == ["paper_search__build_chunk__singlepod.json",
                                         "paper_search__serve_online__singlepod.json"]
    assert all(json.loads(p.read_text())["status"] == "ok" for p in records)
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        dryrun.main(argv)
    assert exc.value.code == 0
    assert capsys.readouterr().out.count(": cached") == 2


def test_main_exits_one_when_a_cell_fails(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("broken step")

    monkeypatch.setattr(dryrun, "get_spec", get_reduced_spec)
    monkeypatch.setattr(dryrun, "build_cell", broken)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "paper_search", "--shape", "build_chunk", "--device", "cpu",
                     "--out", str(tmp_path)])
    assert exc.value.code == 1
    rec = json.loads((tmp_path / "paper_search__build_chunk__singlepod.json").read_text())
    assert rec["status"] == "error" and "broken step" in rec["error"]


_FAMILIES = {"stablelm-3b": "lm", "mistral-large-123b": "lm", "tinyllama-1.1b": "lm",
             "llama4-maverick-400b-a17b": "lm", "olmoe-1b-7b": "lm", "gat-cora": "gnn", "autoint": "recsys",
             "mind": "recsys", "dcn-v2": "recsys", "fm": "recsys"}


@pytest.mark.parametrize("arch_id", REF_ASSIGNED_ARCH_IDS)
def test_scaffolding_architectures_refuse(arch_id):
    """No architecture refuses any more: every id resolves to its family,
    full and reduced."""
    for get in (get_spec, get_reduced_spec):
        assert get(arch_id).family == _FAMILIES[arch_id] == ref_get_spec(arch_id).family


@pytest.mark.parametrize("family", ["lm", "gnn", "recsys"])
def test_scaffolding_families_refuse_to_build_cells(family):
    """No family refuses any more: an lm cell of a config with MoE layers, a
    reduced gnn cell and a recsys cell build and run."""
    arch, shape = {"lm": ("olmoe-1b-7b", "prefill_32k"), "gnn": ("gat-cora", "molecule"),
                   "recsys": ("fm", "serve_p99")}[family]
    spec = get_reduced_spec(arch)
    cell = build_cell(spec, shape, make_smoke_mesh())
    args = dryrun.cell_inputs(cell, spec.cfg_for(shape), device="cpu")
    out = cell.fn(*args)
    if family == "lm":
        assert spec.model_cfg.moe is not None and out[0].shape == (2, spec.model_cfg.vocab)
    elif family == "gnn":
        new_params, new_state, metrics = out
        assert sorted(metrics) == ["acc", "loss"] and bool(torch.isfinite(metrics["loss"]))
        assert int(new_state["step"]) == 1 and len(new_params) == spec.cfg_for(shape).n_layers
    else:
        assert out.shape == (spec.shapes[shape].kwargs["batch"],) and bool(torch.isfinite(out).all())


def test_unknown_architecture_is_a_key_error():
    for get in (get_spec, get_reduced_spec):
        with pytest.raises(KeyError):
            get("no-such-arch")
    with pytest.raises(KeyError):
        ref_get_spec("no-such-arch")


# ---------------------------------------------------------------------------
# dense LM cells
# ---------------------------------------------------------------------------

LM_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k[swa]"]


def _lm_args_equal(port, ref):
    """Trees of meta tensors against ShapeDtypeStructs: the same structure
    (the reference's sorted leaf order), shapes and dtypes."""
    import jax

    from repro_torch.tree import tree_leaves

    got, want = tree_leaves(port), jax.tree.leaves(ref)
    assert len(got) == len(want)
    dtypes = {**_DTYPES, jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for g, w in zip(got, want):
        assert g.device.type == "meta" and tuple(g.shape) == tuple(w.shape) and g.dtype == dtypes[w.dtype.type]


@pytest.mark.parametrize("shape", LM_SHAPES)
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "stablelm-3b", "mistral-large-123b"])
def test_lm_cells_equal_the_reference_cells(arch, shape):
    """Full-scale abstract args (params, AdamW state, batch, cache) and
    useful-work models against the reference's ``_lm_cell``."""
    ref = ref_build_cell(ref_get_spec(arch), shape, ref_make_smoke_mesh())
    cell = build_cell(get_spec(arch), shape, make_smoke_mesh())
    assert (cell.step, cell.shape_name, cell.arch_id, cell.notes) == (ref.step, ref.shape_name, ref.arch_id,
                                                                      ref.notes)
    _lm_args_equal(cell.abstract_args, ref.abstract_args)
    assert cell.model_flops_fn() == ref.model_flops_fn()


@pytest.mark.parametrize("multi_pod,shares", [(False, (16, 2, 8, 1)), (True, (8, 1, 4, 1))])
def test_lm_data_rank_shares(multi_pod, shares):
    spec = get_spec("tinyllama-1.1b")
    layout = make_production_mesh(multi_pod=multi_pod)
    got = tuple(dryrun.data_share(spec.shapes[s].kwargs["global_batch"], layout)[0] for s in LM_SHAPES)
    assert got == shares
    assert dryrun.data_share(256, layout)[1] == (32 if multi_pod else 16)
    assert dryrun.data_share(4, make_smoke_mesh()) == (4, 1)


@pytest.mark.parametrize("shape", LM_SHAPES)
def test_run_cell_lm_on_the_cpu_reduced_spec(shape, monkeypatch):
    monkeypatch.setattr(dryrun, "get_spec", get_reduced_spec)
    rec = dryrun.run_cell("tinyllama-1.1b", shape, False, verbose=False, device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    kw = get_reduced_spec("tinyllama-1.1b").shapes[shape].kwargs
    share = max(1, kw["global_batch"] // 16)
    assert rec["model_flops_share"] == rec["model_flops_global"] * share / kw["global_batch"]
    assert rec["notes"].startswith(f"data-rank share: batch {share} of global batch {kw['global_batch']}")
    if shape == "train_4k":
        assert set(rec["result"]) == {"loss", "nll", "aux", "grad_norm"} and rec["input_shapes"][2]["tokens"] == [
            share, kw["seq_len"]]
    else:
        assert np.isfinite(rec["result"]["logits_absmax"])
    json.dumps(rec)


def test_lm_cell_inputs_are_seeded():
    spec = get_reduced_spec("stablelm-3b")
    cell = build_cell(spec, "decode_32k", make_smoke_mesh())
    a = dryrun.cell_inputs(cell, spec.model_cfg, seed=2, device="cpu", batch=3)
    b = dryrun.cell_inputs(cell, spec.model_cfg, seed=2, device="cpu", batch=3)
    from repro_torch.tree import tree_leaves

    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    params, cache, tokens, cache_len = a
    assert cache["k"].shape == (2, 3, 256, 4, 16) and tokens.shape == (3, 1) and int(cache_len) == 255
    train = dryrun.cell_inputs(build_cell(spec, "train_4k", make_smoke_mesh()), spec.model_cfg, device="cpu")
    assert train[2]["tokens"].shape == (4, 128) and int(train[1]["step"]) == 0
