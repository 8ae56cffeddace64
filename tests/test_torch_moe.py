"""The port's MoE FFN (``repro_torch.models.moe``) and the MoE half of its
transformer against the reference's, on the CPU.

``moe_ffn``: each dispatch (``einsum``, ``sort``, and ``local``, which on one
device is the reference's own fallback to ``sort``) at a capacity factor
that drops (0.25) and one that does not (8.0), in float32 (rtol 1e-4, atol
1e-5) and bfloat16 (2e-2 relative), one call at a time with the same input
in both packages; the dropped (token, slot) pairs, read from the
reference's output; gradients to x, the router and the experts (rtol 1e-3,
atol 1e-6); the zero-router tie; ``_pack_local`` summed over 1, 2 and 4
columns against ``_moe_sort``.

The two MoE configs (``olmoe-1b-7b``, ``llama4-maverick-400b-a17b``) at
their reduced sizes: the init tree, forward, loss and gradients, prefill and
decode with the interleaved cache, three AdamW steps, their dry-run cells,
the trainer CLI and a checkpoint round trip across the two packages, with
the tolerances of ``tests/_lm_compare.py``.  A bfloat16 model routes a few
tokens to other experts in the two packages (a flip is a discrete
difference, not rounding): whole-model bfloat16 comparisons run at a
capacity factor that drops nothing, count the flipped (token, layer)
routes, and hold each sequence's tokens before its first flipped token
(causal attention: nothing a flip changes reaches them).
"""

import dataclasses
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import restore_checkpoint as ref_restore_checkpoint
from repro.checkpoint import save_checkpoint as ref_save_checkpoint
from repro.configs import get_reduced_spec as ref_get_reduced_spec
from repro.configs import get_spec as ref_get_spec
from repro.data.pipeline import LMTokenPipeline
from repro.launch import train as ref_train
from repro.launch.mesh import make_smoke_mesh as ref_make_smoke_mesh
from repro.launch.steps import build_cell as ref_build_cell
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_reduced_spec, get_spec
from repro_torch.launch import dryrun
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.models import moe as port_moe
from repro_torch.models import transformer as port_tf
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.tree import tree_leaves
from tests._lm_compare import (
    BF16_REL,
    DTYPES,
    FWD,
    GRAD,
    MOE_ARCHS,
    assert_close,
    lm_batch,
    np32,
    port_cfg,
    port_moe_cfg,
    ref_cfg,
    ref_params,
    rel_err,
    to_port,
    torch_batch,
)

DISPATCHES = ["einsum", "sort", "local"]
DROPPING, NO_DROP = 0.25, 8.0
D_MODEL = 16


def _moe_cfgs(dispatch, cf, **changes):
    rcfg = ref_moe.MoEConfig(n_experts=8, top_k=2, d_ff=32, capacity_factor=cf, dispatch=dispatch, **changes)
    return rcfg, port_moe_cfg(rcfg)


def _moe_setup(dispatch, cf, dtype="float32", seed=0, **changes):
    rcfg, pcfg = _moe_cfgs(dispatch, cf, **changes)
    rp = ref_moe.init_moe_params(jax.random.key(seed), D_MODEL, rcfg, jnp.dtype(dtype))
    x = np.random.default_rng(seed).normal(size=(2, 24, D_MODEL)).astype(np.float32)
    return rcfg, pcfg, rp, to_port(rp), x


def _port_x(x, dtype):
    return torch.from_numpy(x).to(port_tf._DTYPES[dtype])


def _ref_ffn(rcfg):
    return jax.jit(lambda x, p: ref_moe.moe_ffn(x, p, rcfg))


def _ref_dropped(x, y, rp, rcfg) -> np.ndarray:
    """The (token, slot) pairs the reference's ``moe_ffn`` dropped, read
    from its float32 output ``y`` on ``x``: each token's output is a sum
    over its k slots of 0 or 1 times the slot's weighted expert output, so a
    least-squares fit of the k coefficients recovers which slots it kept."""
    x2d = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    y = np.asarray(y, np.float64).reshape(x2d.shape)
    gates, _ = ref_moe._router(jnp.asarray(x2d, jnp.float32), rp, rcfg)
    w, e = (np.asarray(a) for a in jax.lax.top_k(gates, rcfg.top_k))
    w = w / np.maximum(w.sum(-1, keepdims=True), 1e-9)
    wg, wu, wd = (np.asarray(rp[k], np.float64) for k in ("w_gate", "w_up", "w_down"))
    g, u = np.einsum("td,edf->etf", x2d, wg), np.einsum("td,edf->etf", x2d, wu)
    ffn = np.einsum("etf,efd->etd", g / (1 + np.exp(-g)) * u, wd)  # every expert on every token
    t = np.arange(x2d.shape[0])
    contrib = w[..., None] * ffn[e, t[:, None]]  # [T, k, D]
    coef = np.stack([np.linalg.lstsq(contrib[i].T, y[i], rcond=None)[0] for i in t])
    assert np.allclose(coef, np.round(coef), atol=1e-3), coef
    return np.round(coef) == 0


@pytest.mark.parametrize("n", [1, 7, 48, 65_536])
def test_capacity_equals_the_reference(n):
    for dispatch in DISPATCHES:
        for cf in (DROPPING, 1.25, NO_DROP):
            rcfg, pcfg = _moe_cfgs(dispatch, cf)
            assert port_moe._capacity(n, pcfg) == ref_moe._capacity(n, rcfg)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cf", [DROPPING, NO_DROP])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_ffn_equals_the_reference(dispatch, cf, dtype):
    rcfg, pcfg, rp, pp, x = _moe_setup(dispatch, cf, dtype)
    want_y, want_aux = _ref_ffn(rcfg)(jnp.asarray(x, jnp.dtype(dtype)), rp)
    y, aux = port_moe.moe_ffn(_port_x(x, dtype), pp, pcfg)
    assert y.dtype == port_tf._DTYPES[dtype] and y.shape == x.shape
    assert_close(y, want_y, dtype, what="y")
    assert_close(aux, want_aux, dtype, what="aux")
    if dtype == "float32":
        dropped = port_moe.dropped_slots(_port_x(x, dtype), pp, pcfg).numpy()
        assert (dropped == _ref_dropped(x, want_y, rp, rcfg)).all()
        assert dropped.any() == (cf == DROPPING)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_shared_experts_equal_the_reference(dispatch):
    rcfg, pcfg, rp, pp, x = _moe_setup(dispatch, 1.25, seed=3, n_shared_experts=2)
    assert sorted(pp["shared"]) == ["w_down", "w_gate", "w_up"] and pp["shared"]["w_gate"].shape == (D_MODEL, 64)
    want_y, want_aux = _ref_ffn(rcfg)(jnp.asarray(x), rp)
    y, aux = port_moe.moe_ffn(torch.from_numpy(x), pp, pcfg)
    np.testing.assert_allclose(np32(y), np32(want_y), **FWD)
    np.testing.assert_allclose(float(aux), float(want_aux), **FWD)


def test_dispatches_drop_different_pairs_under_overflow():
    """Einsum fills each expert slot-major, sort token-major: under
    overflow they drop different (token, slot) pairs, the same number."""
    _, _, rp, pp, x = _moe_setup("einsum", DROPPING)
    drops = {d: port_moe.dropped_slots(torch.from_numpy(x), pp, _moe_cfgs(d, DROPPING)[1]) for d in DISPATCHES}
    assert not torch.equal(drops["einsum"], drops["sort"]) and torch.equal(drops["sort"], drops["local"])
    assert int(drops["einsum"].sum()) == int(drops["sort"].sum()) > 0


@pytest.mark.parametrize("cf", [DROPPING, NO_DROP])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_gradients_equal_the_reference(dispatch, cf):
    rcfg, pcfg, rp, pp, x = _moe_setup(dispatch, cf, seed=1)
    r = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)

    def ref_obj(xx, p):
        y, aux = ref_moe.moe_ffn(xx, p, rcfg)
        return jnp.sum(y * r) + aux

    want_x, want_p = jax.jit(jax.grad(ref_obj, argnums=(0, 1)))(jnp.asarray(x), rp)
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = [t.requires_grad_(True) for t in tree_leaves(pp)]
    y, aux = port_moe.moe_ffn(xt, pp, pcfg)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    np.testing.assert_allclose(np32(xt.grad), np32(want_x), **GRAD)
    for name, got, want in zip(sorted(pp), leaves, jax.tree.leaves(want_p)):
        np.testing.assert_allclose(np32(got.grad), np32(want), err_msg=name, **GRAD)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_zero_router_selects_the_first_experts(dispatch):
    """Every gate 1/E: ``lax.top_k`` keeps the lower index on ties, so both
    packages route every token to experts 0..k-1."""
    rcfg, pcfg, rp, pp, x = _moe_setup(dispatch, NO_DROP, seed=2)
    rp = {**rp, "router": jnp.zeros_like(rp["router"])}
    pp = {**pp, "router": torch.zeros_like(pp["router"])}
    gates, _ = port_moe._router(torch.from_numpy(x).reshape(-1, D_MODEL), pp)
    w, e = port_moe._top_k(gates, pcfg.top_k)
    assert (e == torch.arange(pcfg.top_k)).all() and torch.allclose(w, torch.full_like(w, 0.5))
    _, ref_e = jax.lax.top_k(ref_moe._router(jnp.asarray(x).reshape(-1, D_MODEL), rp, rcfg)[0], rcfg.top_k)
    assert (np.asarray(ref_e) == np.arange(rcfg.top_k)).all()
    want_y, want_aux = _ref_ffn(rcfg)(jnp.asarray(x), rp)
    y, aux = port_moe.moe_ffn(torch.from_numpy(x), pp, pcfg)
    np.testing.assert_allclose(np32(y), np32(want_y), **FWD)
    np.testing.assert_allclose(float(aux), float(want_aux), **FWD)


@pytest.mark.parametrize("cf", [DROPPING, NO_DROP])
@pytest.mark.parametrize("n_cols", [1, 2, 4])
def test_pack_local_summed_over_columns_equals_sort(n_cols, cf):
    rcfg, pcfg, rp, pp, x = _moe_setup("local", cf, seed=4)
    x2d = torch.from_numpy(x).reshape(-1, D_MODEL)
    gates, _ = port_moe._router(x2d, pp)
    e_loc = pcfg.n_experts // n_cols
    parts = [port_moe._pack_local(x2d, *(pp[k][col * e_loc:(col + 1) * e_loc] for k in ("w_gate", "w_up", "w_down")),
                                  gates, pcfg, col, n_cols) for col in range(n_cols)]
    assert all(p.dtype == torch.float32 for p in parts)
    want, _ = port_moe._moe_sort(x2d, pp, pcfg)
    np.testing.assert_allclose(np32(sum(parts)), np32(want), **FWD)
    ref_y, _ = jax.jit(lambda a, p: ref_moe._moe_sort(a, p, rcfg))(jnp.asarray(x).reshape(-1, D_MODEL), rp)
    np.testing.assert_allclose(np32(sum(parts)), np32(ref_y), **FWD)


# ---------------------------------------------------------------------------
# the MoE transformers at their reduced sizes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_init_has_the_reference_tree(arch):
    rcfg = ref_cfg(arch, "bfloat16")
    cfg = port_cfg(rcfg)
    rp = ref_params(rcfg)
    pp = port_tf.init_params(0, cfg, device="cpu")
    assert jax.tree.structure(rp) == jax.tree.structure(to_reference(pp))
    for got, want in zip(tree_leaves(pp), jax.tree.leaves(rp)):
        assert tuple(got.shape) == want.shape
        assert got.dtype == (torch.float32 if want.dtype == jnp.float32 else torch.bfloat16)
    routers = [t for t in tree_leaves(pp) if t.dtype == torch.float32]
    assert len(routers) == 1 and routers[0].shape[-1] == cfg.moe.n_experts
    assert ("dense_sub" in pp["layers"]) == (cfg.moe_interleave > 1)
    shapes = port_tf.param_shapes(cfg)
    assert [(t.shape, t.dtype) for t in tree_leaves(shapes)] == [(t.shape, t.dtype) for t in tree_leaves(pp)]
    assert sum(t.numel() for t in tree_leaves(pp)) == cfg.param_count() == rcfg.param_count()
    full, ref_full = get_spec(arch).model_cfg, ref_get_spec(arch).model_cfg
    assert dataclasses.asdict(full) == dataclasses.asdict(ref_full)
    assert sum(t.numel() for t in tree_leaves(port_tf.param_shapes(full))) == full.param_count() == ref_full.param_count()
    assert full.active_param_count() == ref_full.active_param_count()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_gradients_equal_the_reference(arch):
    rcfg = ref_cfg(arch, "float32")
    cfg = port_cfg(rcfg)
    rp = ref_params(rcfg, seed=1)
    batch = lm_batch(rcfg.vocab, 2, 64, seed=1)
    (want_loss, want_m), want_g = jax.jit(jax.value_and_grad(lambda p: ref_tf.loss_fn(p, batch, rcfg),
                                                             has_aux=True))(rp)
    pp = to_port(rp)
    leaves = [t.requires_grad_(True) for t in tree_leaves(pp)]
    loss, m = port_tf.loss_fn(pp, torch_batch(batch), cfg)
    loss.backward()
    assert float(m["aux"].detach()) > 0
    for k in ("nll", "aux"):
        np.testing.assert_allclose(float(m[k].detach()), float(want_m[k]), err_msg=k, **FWD)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **FWD)
    for got, g in zip(leaves, jax.tree.leaves(want_g)):
        np.testing.assert_allclose(np32(got.grad), np32(g), **GRAD)


def _bf16_no_drop(arch):
    r0 = ref_cfg(arch, "bfloat16")
    return dataclasses.replace(r0, moe=dataclasses.replace(r0.moe, capacity_factor=NO_DROP))


def _flipped_tokens(rcfg, cfg, rp, pp, tokens, monkeypatch):
    """[B, S] True where a token's top-k experts differ between the two
    packages in any MoE layer, each package routing its own MoE inputs
    (recorded on the way: the reference's through an ordered callback);
    and each package's final hidden states."""
    rec_ref, rec_port = [], []
    ref_ffn, port_ffn = ref_tf.moe_ffn, port_tf.moe_ffn

    def ref_spy(x, p, c):
        jax.debug.callback(lambda a, r: rec_ref.append((np.array(a), np.array(r))), x.astype(jnp.float32),
                           p["router"], ordered=True)
        return ref_ffn(x, p, c)

    def port_spy(x, p, c):
        rec_port.append((x.detach().float().numpy(), p["router"].detach().numpy()))
        return port_ffn(x, p, c)

    monkeypatch.setattr(ref_tf, "moe_ffn", ref_spy)
    monkeypatch.setattr(port_tf, "moe_ffn", port_spy)
    want_h = jax.jit(lambda p, t: ref_tf.forward(p, t, rcfg)[0])(rp, tokens).block_until_ready()
    jax.effects_barrier()
    with torch.no_grad():
        h = port_tf.forward(pp, torch.from_numpy(tokens), cfg)[0]
    assert len(rec_ref) == len(rec_port) == cfg.n_moe_layers
    flipped = np.zeros(tokens.size, bool)
    for (xr, rr), (xp, rpp) in zip(rec_ref, rec_port):
        routes = [np.sort(port_moe._top_k(port_moe._router(torch.from_numpy(a).reshape(-1, a.shape[-1]),
                                                           {"router": torch.from_numpy(r)})[0], rcfg.moe.top_k)[1]
                          .numpy(), axis=-1) for a, r in ((xr, rr), (xp, rpp))]
        flipped |= (routes[0] != routes[1]).any(-1)
    return flipped.reshape(tokens.shape), h, want_h


def _before_first_flip(flipped: np.ndarray) -> np.ndarray:
    s = flipped.shape[1]
    first = np.where(flipped.any(1), flipped.argmax(1), s)
    return np.arange(s)[None, :] < first[:, None]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_bfloat16_forward_holds_the_tokens_no_flip_reaches(arch, monkeypatch):
    rcfg = _bf16_no_drop(arch)
    cfg = port_cfg(rcfg)
    rp = ref_params(rcfg)
    pp = to_port(rp)
    batch = lm_batch(rcfg.vocab, 2, 96)
    flipped, h, want_h = _flipped_tokens(rcfg, cfg, rp, pp, batch["tokens"], monkeypatch)
    keep = _before_first_flip(flipped)
    print(f"{arch}: {int(flipped.sum())} of {flipped.size} tokens routed apart in some layer; "
          f"{int(keep.sum())} held")
    assert flipped.mean() < 0.1 and keep.sum() >= flipped.size // 4
    monkeypatch.undo()
    want_loss, _ = jax.jit(lambda p, b: ref_tf.loss_fn(p, b, rcfg))(rp, batch)
    loss, _ = port_tf.loss_fn(pp, torch_batch(batch), cfg)
    assert_close(loss, want_loss, "bfloat16", what="loss")
    assert rel_err(np32(h)[keep], np32(want_h)[keep]) < BF16_REL


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_equal_the_reference(arch):
    """Prefill logits and the [L, B, S, Hkv, Dh] cache (the interleaved
    config's layer 2i is block i's dense sublayer, 2i + 1 its MoE one); a
    decode step past the end of the cache, and one in a sliding window; all
    in float32."""
    rcfg = ref_cfg(arch, "float32")
    cfg = port_cfg(rcfg)
    rp = ref_params(rcfg, seed=2)
    pp = to_port(rp)
    tokens = lm_batch(rcfg.vocab, 2, 80, seed=2)["tokens"]
    want_logits, want_cache = jax.jit(lambda p, t: ref_tf.prefill_step(p, t, rcfg))(rp, tokens)
    with torch.no_grad():
        logits, cache = port_tf.prefill_step(pp, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(np32(logits), np32(want_logits), **FWD)
    for k in ("k", "v"):
        assert cache[k].shape == (cfg.n_layers, 2, 80, cfg.n_kv_heads, cfg.d_head)
        np.testing.assert_allclose(np32(cache[k]), np32(want_cache[k]), **FWD)
    for s, cache_len, window in ((24, 30, None), (48, 27, 16)):
        dcfg_r = dataclasses.replace(rcfg, sliding_window=window)
        rng = np.random.default_rng(s + cache_len)
        shape = (rcfg.n_layers, 2, s, rcfg.n_kv_heads, rcfg.d_head)
        c = {k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")}
        tok = rng.integers(0, rcfg.vocab, (2, 1)).astype(np.int32)
        want_l, want_c = jax.jit(lambda p, c, t, n: ref_tf.decode_step(p, c, t, n, dcfg_r))(
            rp, c, tok, jnp.asarray(cache_len, jnp.int32))
        with torch.no_grad():
            got_l, got_c = port_tf.decode_step(pp, to_port(c), torch.from_numpy(tok), cache_len,
                                               port_cfg(dcfg_r))
        np.testing.assert_allclose(np32(got_l), np32(want_l), **FWD)
        for k in ("k", "v"):
            np.testing.assert_allclose(np32(got_c[k]), np32(want_c[k]), **FWD)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_three_train_steps_equal_the_reference(arch):
    """Three float32 steps of the train cell at the reduced config (its
    drops included) from the reference's weights."""
    dtype = "float32"
    ref_spec = ref_get_reduced_spec(arch)
    rcfg = ref_cfg(arch, dtype)
    ref_spec = dataclasses.replace(ref_spec, model_cfg=rcfg)
    spec = dataclasses.replace(get_reduced_spec(arch), model_cfg=port_cfg(rcfg))
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with mesh:
        ref_step = jax.jit(ref_build_cell(ref_spec, "train_4k", mesh).fn)
    cell = build_cell(spec, "train_4k", make_smoke_mesh())
    rparams = ref_params(rcfg, seed=5)
    ropt = ref_adamw_init(rparams)
    params, opt = from_reference(rparams, device="cpu"), from_reference(ropt, device="cpu")
    pipe = LMTokenPipeline(rcfg.vocab, 64, 4, seed=5)
    for step in range(3):
        batch = pipe.next_batch()
        with mesh:
            rparams, ropt, rm = ref_step(rparams, ropt, batch)
        params, opt, m = cell.fn(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert sorted(m) == sorted(rm) == ["aux", "grad_norm", "loss", "nll"] and float(m["aux"]) > 0
        for k in ("loss", "nll", "aux"):
            assert_close(m[k], rm[k], dtype, what=f"step {step} {k}")
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), **GRAD)
    for got, want in zip(tree_leaves(params), jax.tree.leaves(rparams)):
        np.testing.assert_allclose(np32(got), np32(want), rtol=0, atol=1e-5)


LM_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k[swa]"]


@pytest.mark.parametrize("shape", LM_SHAPES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_cells_equal_the_reference_cells_and_run_reduced(arch, shape, monkeypatch):
    """Full-scale abstract args and useful-work models (MoE: active
    parameters) against the reference's ``_lm_cell``; the reduced cell
    through ``run_cell`` on the CPU."""
    ref = ref_build_cell(ref_get_spec(arch), shape, ref_make_smoke_mesh())
    cell = build_cell(get_spec(arch), shape, make_smoke_mesh())
    assert (cell.step, cell.notes) == (ref.step, ref.notes)
    got, want = tree_leaves(cell.abstract_args), jax.tree.leaves(ref.abstract_args)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert [str(g.dtype).split(".")[1] for g in got] == [str(w.dtype) for w in want]
    assert cell.model_flops_fn() == ref.model_flops_fn()
    monkeypatch.setattr(dryrun, "get_spec", get_reduced_spec)
    rec = dryrun.run_cell(arch, shape, False, verbose=False, device="cpu", repeats=1)
    assert rec["status"] == "ok", rec.get("traceback")
    if shape == "train_4k":
        assert rec["result"]["aux"] > 0 and np.isfinite(rec["result"]["loss"])


_STEP_LINE = re.compile(r"^step +(\d+) aux=(\S+) grad_norm=(\S+) loss=(\S+) nll=(\S+)$")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_cli_prints_the_reference_lines(arch, monkeypatch, capsys):
    """``--arch <moe> --steps 6`` at the reduced config (bfloat16, the
    reference's capacity): the reference's lines; aux, loss and nll within
    2e-2 of the reference's, from the reference's initial weights."""
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--steps", "6"])
    ref_train.main()
    want = capsys.readouterr().out.splitlines()
    rcfg = ref_get_reduced_spec(arch).model_cfg
    init = to_port(ref_params(rcfg, seed=0))
    monkeypatch.setattr(port_tf, "init_params", lambda key, cfg, device: init)
    port_train.main(["--arch", arch, "--steps", "6", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 3 and got[-1].startswith("done: 6 steps")
    for g, w in zip(got[:-1], want[:-1]):
        gm, wm = _STEP_LINE.match(g), _STEP_LINE.match(w)
        assert gm and wm and gm.group(1) == wm.group(1), (g, w)
        for i in (2, 4, 5):  # aux, loss, nll
            assert abs(float(gm.group(i)) / float(wm.group(i)) - 1) < BF16_REL, (g, w)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_checkpoint_round_trip_across_packages(arch, tmp_path):
    """``models/convert.py`` carries MoE trees as they are; each package
    restores the other's checkpoint of params and AdamW state bit for bit."""
    rcfg = ref_cfg(arch, "bfloat16")
    rp = ref_params(rcfg, seed=6)
    tree = {"params": rp, "opt": ref_adamw_init(rp)}
    port_tree = from_reference(jax.tree.map(np.asarray, tree), device="cpu")
    assert jax.tree.structure(tree) == jax.tree.structure(to_reference(port_tree))
    ref_save_checkpoint(tmp_path / "ref", 3, tree)
    got, step = restore_checkpoint(tmp_path / "ref", port_tree, device="cpu")
    assert step == 3
    for a, b in zip(tree_leaves(got), tree_leaves(port_tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    save_checkpoint(tmp_path / "port", 4, port_tree)
    back, step = ref_restore_checkpoint(tmp_path / "port", tree)
    assert step == 4
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
