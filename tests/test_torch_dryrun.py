"""The port's dry-run (``repro_torch.configs``, ``launch/{mesh,steps,dryrun}``)
against the reference's, on the CPU: the same cells, shapes, dtypes, shard
counts and useful-work models; ``run_cell`` and ``main`` on the reduced
spec; the families off the search path refuse.
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
    assert PORTED_ARCH_IDS == ("paper_search",)
    for get, ref_get in ((get_spec, ref_get_spec), (get_reduced_spec, ref_get_reduced_spec)):
        spec, ref = get("paper_search"), ref_get("paper_search")
        assert (spec.arch_id, spec.family, spec.source) == (ref.arch_id, ref.family, ref.source)
        assert dataclasses.asdict(spec.model_cfg) == dataclasses.asdict(ref.model_cfg)
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


@pytest.mark.parametrize("arch_id", REF_ASSIGNED_ARCH_IDS)
def test_scaffolding_architectures_refuse(arch_id):
    for get in (get_spec, get_reduced_spec):
        with pytest.raises(NotImplementedError, match="seed scaffolding off the search path"):
            get(arch_id)


@pytest.mark.parametrize("family", ["lm", "gnn", "recsys"])
def test_scaffolding_families_refuse_to_build_cells(family):
    spec = dataclasses.replace(get_spec("paper_search"), family=family)
    with pytest.raises(NotImplementedError, match="seed scaffolding off the search path"):
        build_cell(spec, "serve_online", make_smoke_mesh())


def test_unknown_architecture_is_a_key_error():
    for get in (get_spec, get_reduced_spec):
        with pytest.raises(KeyError):
            get("no-such-arch")
    with pytest.raises(KeyError):
        ref_get_spec("no-such-arch")
