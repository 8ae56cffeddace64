"""The port's cost counter (``repro_torch.launch.cost_analysis``) against the
reference's ``launch/hlo_analysis.analyze_hlo``, on the CPU.

A pure ``[M, K] x [K, N]`` product: flops and bytes equal the reference's
count of its compiled ``jnp.dot``.  The reduced tinyllama train cell, a
reduced recsys cell (dcn-v2) and the reduced GNN cell: the port's flops
within ``FLOPS_TOL`` (25%) of the reference's.  They are not equal: XLA
counts the fused program after its rewrites, the port each eager op as it
runs (it also skips attention tiles masked for every query); bytes differ
far more, since a fusion keeps its intermediates out of HBM and an eager op
writes them.  The rules op by op; the three kernel wrappers charging their
bound's figures on the CPU with their plain versions' ops uncounted; the
search lowerings; the dry-run records' cost fields for a reduced cell of
each family.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced_spec as ref_get_reduced_spec
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import make_smoke_mesh as ref_make_smoke_mesh
from repro.launch.steps import build_cell as ref_build_cell
from repro.search import distributed as ref_distributed
from repro_torch.configs import get_reduced_spec
from repro_torch.core.keys import expand_subqueries, select_keys
from repro_torch.index import build_indexes, synthesize_corpus
from repro_torch.kernels import gather as gather_mod
from repro_torch.kernels import intersect as intersect_mod
from repro_torch.kernels import proximity as proximity_mod
from repro_torch.launch import dryrun
from repro_torch.launch.cost_analysis import ProgramCost, count_cost, kernel_cost, op_cost
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.search import arena, distributed, fused

# these tests run in parallel workers beside timing-sensitive ones
torch.set_num_threads(2)

FLOPS_TOL = 0.25


@pytest.mark.parametrize("m,k,n", [(64, 96, 48), (1, 300, 7), (256, 128, 512), (33, 17, 65)])
def test_pure_product_equals_analyze_hlo(m, k, n):
    """float32 (the CPU's XLA widens a bfloat16 product to float32 with
    converts around the dot: no longer a pure product)."""
    jdt, tdt = jnp.float32, torch.float32
    a, b = jnp.ones((m, k), jdt), jnp.ones((k, n), jdt)
    want = analyze_hlo(jax.jit(jnp.dot).lower(a, b).compile().as_text())
    assert want.flops == 2.0 * m * k * n
    out, got = count_cost(torch.mm, torch.ones(m, k, dtype=tdt), torch.ones(k, n, dtype=tdt))
    assert out.shape == (m, n)
    assert (got.flops, got.hbm_bytes, got.collectives) == (want.flops, want.hbm_bytes, want.collectives)
    _, via_matmul = count_cost(lambda x, y: x @ y, torch.ones(m, k, dtype=tdt), torch.ones(k, n, dtype=tdt))
    assert via_matmul == got


def _ref_flops(arch: str, shape: str) -> float:
    cell = ref_build_cell(ref_get_reduced_spec(arch), shape, ref_make_smoke_mesh())
    return analyze_hlo(jax.jit(cell.fn).lower(*cell.abstract_args).compile().as_text()).flops


@pytest.mark.parametrize("arch,shape", [("tinyllama-1.1b", "train_4k"), ("dcn-v2", "train_batch"),
                                        ("gat-cora", "full_graph_sm")])
def test_cell_flops_within_tolerance_of_the_reference(arch, shape):
    spec = get_reduced_spec(arch)
    cell = build_cell(spec, shape, make_smoke_mesh())
    args = dryrun.cell_inputs(cell, spec.cfg_for(shape), device="cpu")
    _, cost = count_cost(cell.fn, *args)
    ratio = cost.flops / _ref_flops(arch, shape)
    assert abs(ratio - 1) < FLOPS_TOL, ratio
    assert cost.hbm_bytes > 0 and cost.collectives == {}


def _one(func, *args, **kwargs):
    """The (flops, bytes) the counter charges for one call."""
    _, cost = count_cost(func, *args, **kwargs)
    return cost.flops, cost.hbm_bytes


def test_op_rules():
    x = torch.ones(6, 10)
    # elementwise: numel; result + operands
    assert _one(torch.add, x, x) == (60, 3 * 240)
    assert _one(lambda t: t.mul_(2.0), x.clone()) == (60, 2 * 240)
    # views and allocations are free
    assert _one(lambda t: t.view(60).t().unsqueeze(0).expand(3, 60).transpose(0, 1), torch.ones(6, 10)) == (0, 0)
    assert _one(torch.empty, 4, 4) == (0, 0)
    # fills write their result
    assert _one(torch.zeros, 5, 3) == (0, 60)
    # reductions: max(in, out) elements; result + operands
    assert _one(lambda t: t.sum(dim=1), x) == (60, 240 + 24)
    # gathers and slices read what they write
    idx = torch.tensor([0, 5, 5])
    assert _one(torch.index_select, x, 0, idx) == (60, 2 * 3 * 10 * 4)
    # an in-place update is charged twice the update, its work the update's
    src = torch.ones(3, 10)
    assert _one(lambda t: t.index_add_(0, idx, src), x.clone()) == (30, 2 * 120)
    assert _one(lambda t: t[1:4].copy_(src), x.clone()) == (0, 2 * 120)
    # a copy to another dtype is a conversion
    assert _one(lambda t: t.to(torch.int32), x) == (60, 240 + 240)
    assert _one(torch.clone, x) == (0, 2 * 240)
    # sorts: n ceil(log2 n)
    v = torch.arange(1000.0).flip(0)
    flops, nbytes = _one(torch.sort, v)
    assert flops == 1000 * math.ceil(math.log2(1000)) and nbytes == 4000 + 4000 + 8000
    # products: 2 x numel(out) x K; a bias enters the bytes
    bias, w = torch.ones(7), torch.ones(10, 7)
    assert _one(torch.nn.functional.linear, x, w.t(), bias) == (2 * 6 * 7 * 10, 4 * (42 + 7 + 60 + 70))
    assert _one(torch.bmm, torch.ones(2, 3, 4), torch.ones(2, 4, 5)) == (2 * 30 * 4, 4 * (30 + 24 + 40))


def test_a_loop_counts_its_trips_and_backward_is_counted():
    w = torch.ones(8, 8, requires_grad=True)

    def f(trips):
        y = torch.ones(4, 8)
        for _ in range(trips):
            y = y @ w
        return y

    one, three = count_cost(f, 1)[1], count_cost(f, 3)[1]
    assert three.flops == 3 * one.flops == 3 * 2 * 4 * 8 * 8
    _, fwd_bwd = count_cost(lambda: torch.autograd.grad(f(1).sum(), w))
    assert fwd_bwd.flops > 2 * one.flops  # the backward's product counted


def test_program_cost_add():
    c = ProgramCost(1.0, 2.0, {"all-reduce": 3.0})
    c.add(ProgramCost(10.0, 20.0, {"all-reduce": 1.0, "all-gather": 2.0}), mult=2.0)
    assert (c.flops, c.hbm_bytes, c.collectives, c.collective_bytes) == (
        21.0, 42.0, {"all-reduce": 5.0, "all-gather": 4.0}, 9.0)


def test_kernel_cost_charges_once_and_suspends_the_mode():
    def wrapper(x):
        with kernel_cost(lambda: (7.0, 11.0)):
            return (x * 2).sum()

    assert _one(wrapper, torch.ones(100)) == (7.0, 11.0)
    assert wrapper(torch.ones(3)) == 6.0  # no counter: a no-op


def test_kernel_wrappers_charge_their_bound_figures_on_the_cpu():
    """Each wrapper's CPU path (its plain version) is charged the figures
    the kernel's roofline bound counts, and none of the plain version's
    ops."""
    gen = torch.Generator().manual_seed(0)
    b, l, n, d = 5, 4, 64, 3
    occ = torch.randint(0, 2, (b, l, n), generator=gen, dtype=torch.uint8)
    mult = torch.tensor([[1, 0, 2, 0]] * b, dtype=torch.int32)
    n_active = int((mult > 0).sum())
    got = _one(proximity_mod.proximity_window, occ, mult, d, compute_dtype="uint8")
    assert got == (n_active * n, n_active * n + b * l + b * n * 5)

    a = torch.arange(0, 512, 2, dtype=torch.int32)
    bb = torch.arange(0, 1024, 1, dtype=torch.int32)
    off = torch.from_numpy(intersect_mod.block_offsets(a.numpy(), bb.numpy(), 128, 256))
    got = _one(intersect_mod.intersect_sorted, a, bb, off, n_chunks=2)
    assert got == (256 * math.ceil(math.log2(512)), 4 * (256 + 1024 + 2 + 256))
    buf, pack = intersect_mod.pack_segments([(a.numpy(), bb.numpy(), off.numpy(), 2),
                                             (a.numpy()[:128], bb.numpy()[:256], off.numpy()[:1], 4)])
    got = _one(intersect_mod.intersect_sorted_segments, buf, pack)
    assert got == (256 * 9 + 128 * 8, 4 * (pack.size + 384))

    arena_rows = torch.arange(4 * 128 * 2, dtype=torch.int32).reshape(-1, 2)
    src_block = torch.tensor([3, 0, 9], dtype=torch.int32)
    n_valid = torch.tensor([128, 5, -2], dtype=torch.int32)
    got = _one(gather_mod.gather_blocks, arena_rows, src_block, n_valid)
    assert got == (0, 8 * (3 * 128 + 133 + 3))


@pytest.fixture(scope="module")
def index():
    store = synthesize_corpus(n_docs=60, doc_len=120, vocab_size=500, seed=7)
    idx = build_indexes(store, sw_count=60, fu_count=120, max_distance=5)
    work = [[(s, idx) for s in expand_subqueries(q, store.lemmatizer)]
            for q in ("who are you who", "to be or not to be", "time and time again")]
    return idx, work


@pytest.mark.parametrize("use_kernel", [False, True])
def test_lower_query_batch_counts_the_program_run_query_batch_runs(index, use_kernel):
    _, work = index
    plan = fused.plan_query_batch(work, device="cpu")
    cost = fused.lower_query_batch(plan, max_distance=5, use_kernel=use_kernel, device="cpu")
    inputs = [torch.from_numpy(a) for a in (plan.events, plan.primary, plan.postab, plan.row_doc,
                                            plan.row_query, plan.mult)]
    _, want = count_cost(fused.fused_serve_batch, *inputs, max_distance=5, query_budget=plan.query_budget,
                         window_len=plan.doc_len, top_k=16, compute_dtype="uint8", use_kernel=use_kernel)
    assert isinstance(cost, ProgramCost) and cost == want and cost.flops > 0 and cost.collectives == {}
    # the host readout does no device work
    _, run = count_cost(fused.run_query_batch, plan, max_distance=5, use_kernel=use_kernel, device="cpu")
    assert run == cost


def test_lower_arena_batch_counts_the_arena_program(index):
    idx, work = index
    res = arena.PostingArena(device="cpu").acquire(idx, 0)
    items = []
    for qi, its in enumerate(work):
        for sub, view in its:
            keys = select_keys(sub, view.fl)
            exts = [res.lookup(k.components) for k in keys]
            if keys and all(e is not None and e.n_rows > 0 for e in exts):
                items.append((qi, sub, keys, exts, res))
    plan = arena.plan_arena_batch(items, n_queries=len(work))
    for use_kernel in (False, True):
        cost = arena.lower_arena_batch(plan, max_distance=5, use_kernel=use_kernel)
        _, run = count_cost(arena.run_arena_batch, plan, max_distance=5, use_kernel=use_kernel)
        assert cost == run and cost.flops > 0 and cost.hbm_bytes > 0


def test_shard_stats_is_the_references():
    assert [(f.name, f.type) for f in dataclasses.fields(distributed.ShardStats)] == [
        (f.name, f.type) for f in dataclasses.fields(ref_distributed.ShardStats)]
    assert distributed.ShardStats(3, 1, 0.5) == distributed.ShardStats(postings_read=3, results=1, elapsed_sec=0.5)


@pytest.mark.parametrize("arch,shape", [("paper_search", "serve_online"), ("tinyllama-1.1b", "decode_32k"),
                                        ("fm", "train_batch"), ("gat-cora", "molecule")])
def test_run_cell_records_the_cost_fields(arch, shape, monkeypatch):
    """Every family's record carries the reference's per-device cost
    fields, counted on the first call alone, and equal from run to run."""
    monkeypatch.setattr(dryrun, "get_spec", get_reduced_spec)
    recs = [dryrun.run_cell(arch, shape, False, verbose=False, device="cpu", repeats=1) for _ in range(2)]
    for rec in recs:
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
        assert rec["collective_bytes_per_device"] == {} and rec["collective_total_per_device"] == 0.0
        assert not {"xla_cost_flops_raw", "lower_s", "compile_s"} & set(rec)
    assert recs[0]["flops_per_device"] == recs[1]["flops_per_device"]
    assert recs[0]["hbm_bytes_per_device"] == recs[1]["hbm_bytes_per_device"]
    spec, mesh = get_reduced_spec(arch), make_production_mesh()
    cell = build_cell(spec, shape, mesh)
    kw = spec.shapes[shape].kwargs
    share = dryrun.data_share(kw["global_batch"], mesh)[0] if spec.family == "lm" else None
    _, cost = count_cost(cell.fn, *dryrun.cell_inputs(cell, spec.cfg_for(shape), device="cpu", batch=share))
    assert cost.flops == recs[0]["flops_per_device"]


def test_op_cost_of_a_host_to_host_copy_is_free_only_across_devices():
    """``_to_copy`` of the same dtype: a copy on one device, free across
    devices (a meta tensor stands in for another device here)."""
    x = torch.ones(4)
    assert op_cost(torch.ops.aten._to_copy.default, (x,), {}, torch.empty(4, device="meta")) == (0.0, 0.0)
    assert op_cost(torch.ops.aten._to_copy.default, (x,), {}, x.clone()) == (0.0, 32.0)
