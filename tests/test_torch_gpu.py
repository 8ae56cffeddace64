"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the serving path's shapes, and the port's serving path on the card (the
host route and the posting arena, over a static index and over a mutated
incremental service) against the host route on the CPU; the dense LM path
(attention, prefill and decode, a float32 train step), the MoE FFN, the
MoE, recsys and GNN train steps on the card at reduced sizes, the GNN's
chunked aggregate against its unchunked form, the cost counter's count
on the card against the CPU's, and worlds of ranks on the card: a world of
one over NCCL against no mesh, bit for bit, a world of two on one card
(gloo: NCCL refuses two ranks of one communicator on one card) against one
rank, its context-parallel decode (half the cache's positions a rank)
included, and, where two cards are present, a world of two over NCCL with
a rank on each.

Every test here needs a CUDA device: each is marked ``gpu`` and skips (in a
fixture, at run time) where there is none.  This file imports neither jax
nor the reference package, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.index import build_indexes, synthesize_corpus
from repro_torch.kernels import (
    ARENA_BLOCK,
    PAD,
    gather_blocks,
    gather_blocks_plain,
    intersect_sorted,
    intersect_sorted_plain,
    intersect_sorted_segments,
    pack_segments,
    proximity_window,
    proximity_window_plain,
)
from repro_torch.search import SearchRequest, ServingFrontend, ShardedSearchService
from repro_torch.search.arena import PostingArena
from repro_torch.search import fused
from repro_torch.search.fused import intersect_inputs

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["uint8", "int32"])
def test_proximity_kernel_equals_plain_at_serving_shape(cuda, dtype):
    rng = np.random.default_rng(0)
    occ = torch.from_numpy((rng.random((32768, 8, 512)) < 0.1).astype(np.uint8)).to(cuda)
    mult = torch.from_numpy(rng.integers(0, 3, (32768, 8)).astype(np.int32)).to(cuda)
    launches = proximity_window.launches
    emit, start = proximity_window(occ, mult, 5, compute_dtype=dtype)
    assert proximity_window.launches == launches + 1
    p_emit, p_start = proximity_window_plain(occ, mult, 5, compute_dtype=dtype)
    assert torch.equal(emit, p_emit)
    assert torch.equal(torch.where(p_emit, start, 0), torch.where(p_emit, p_start, 0))


def _mixed_cover_inputs(rng, b, l, n, window, dtype):
    """Rows cycling through sparse 0/1, dense 0/1, 0/1 with events only at
    e < window, and arbitrary values that wrap in the compute type; awkward
    multiplicities (0, negative, above the window, 256)."""
    occ = (rng.random((b, l, n)) < np.array([0.1, 0.5, 0.3, 0.0])[np.arange(b) % 4, None, None])
    occ = occ.astype(np.int64)
    occ[2::4, :, window:] = 0
    if dtype == "uint8":
        wild = rng.integers(0, 256, (b, l, n))
    else:
        wild = rng.choice([-(2**31), -3, -1, 0, 1, 2, 3, 2**31 - 1], (b, l, n))
    occ[3::4] = wild[3::4]
    mult = rng.choice([0, 1, 1, 1, 2, 2, 3, -1, -5, window, window + 1, 64, 65, 255, 256],
                      (b, l))
    return occ.astype(np.int32), mult.astype(np.int32)


@pytest.mark.parametrize("dtype", ["uint8", "int32"])
@pytest.mark.parametrize("n", [1, 7, 128, 200, 513, 520, 1030, 4096])
def test_proximity_kernel_equals_plain_on_any_input(cuda, dtype, n):
    """Both branches of the kernel in one launch (0/1 rows take the bit
    path, rows with other values the general path), ragged N, windows 1 to
    63: emit and start equal everywhere."""
    rng = np.random.default_rng(n)
    for max_distance in (0, 1, 2, 5, 15, 31):
        for l in (1, 3, 8):
            occ_np, mult_np = _mixed_cover_inputs(rng, 8, l, n, 2 * max_distance + 1, dtype)
            occ, mult = torch.from_numpy(occ_np).to(cuda), torch.from_numpy(mult_np).to(cuda)
            emit, start = proximity_window(occ, mult, max_distance, compute_dtype=dtype)
            p_emit, p_start = proximity_window_plain(occ, mult, max_distance, compute_dtype=dtype)
            assert torch.equal(emit, p_emit), (max_distance, l)
            assert torch.equal(start, p_start), (max_distance, l)


@pytest.mark.parametrize("n_chunks", [1, 2, 32])
def test_intersect_kernel_equals_plain_at_serving_shape(cuda, n_chunks):
    rng = np.random.default_rng(1)
    a_docs = np.sort(rng.choice(8192, 5500, replace=False)).astype(np.int32)
    b_docs = np.sort(rng.choice(8192, 5600, replace=False)).astype(np.int32)
    a_p, b_p, off_p, _ = intersect_inputs(a_docs, b_docs)
    a, b, off = (torch.from_numpy(x).to(cuda) for x in (a_p, b_p, off_p))
    launches = intersect_sorted.launches
    got = intersect_sorted(a, b, off, n_chunks=n_chunks)
    assert intersect_sorted.launches == launches + 1
    assert torch.equal(got, intersect_sorted_plain(a, b, off, n_chunks=n_chunks))


def _any_offsets(na, nb, n_chunks):
    """``tests/test_torch_kernels.py``'s ``_model_inputs("any-offsets", ...)``
    (same seed): sorted a and b padded with PAD, block offsets anywhere —
    -1 and -257 first (floor and truncating division differ there, and a
    negative first tile wraps to the end), below 0, past the end,
    unaligned."""
    rng = np.random.default_rng(na + nb + n_chunks)
    a = np.sort(rng.integers(0, 3 * nb, na)).astype(np.int32)
    a[-rng.integers(1, 40):] = PAD
    b = np.sort(rng.integers(0, 3 * nb, nb)).astype(np.int32)
    b[-rng.integers(1, 64):] = PAD
    off = rng.integers(-3 * 256, nb + 3 * 256, na // 128).astype(np.int32)
    off[:2] = -1, -257
    return a, b, off, n_chunks


def _serving_segments(rng, kind):
    """Pairs of 4,100-6,000 docs out of 8,192, padded as the planner pads
    them, with mixed n_chunks: the planner's own, 1 (partial), twice it and
    the whole list.  "unsorted" reverses a span of one b; "global" adds a
    16,384-element b searched whole, a window above the kernel's
    shared-memory budget, sorted and unsorted.  "any-offsets" is the CPU
    tests' arbitrary-offset pairs instead."""
    if kind == "any-offsets":
        return [_any_offsets(*shape) for shape in
                ((512, 1024, 1), (1024, 2048, 2), (256, 2048, 3), (384, 256, 2), (1024, 4096, 16))]
    n = {"round1": 6, "round2": 3, "unsorted": 4, "global": 2}[kind]
    segments = []
    for k in range(n):
        a_docs, b_docs = (np.sort(rng.choice(8192, rng.integers(4100, 6000), replace=False))
                          .astype(np.int32) for _ in range(2))
        a_p, b_p, off_p, n_chunks = intersect_inputs(a_docs, b_docs)
        n_chunks = (n_chunks, 1, 2 * n_chunks, len(b_p) // 256)[k % 4]
        segments.append((a_p, b_p, off_p, n_chunks))
    if kind == "unsorted":
        b_p = segments[1][1].copy()
        b_p[:1500] = b_p[:1500][::-1]
        segments[1] = (segments[1][0], b_p, segments[1][2], segments[1][3])
    if kind == "global":
        for reverse in (False, True):
            b_docs = np.sort(rng.choice(20000, 16000, replace=False)).astype(np.int32)
            a_docs = np.sort(rng.choice(20000, 5000, replace=False)).astype(np.int32)
            a_p, b_p, off_p, _ = intersect_inputs(a_docs, b_docs)
            if reverse:
                b_p[100:9000] = b_p[100:9000][::-1]
            segments.append((a_p, b_p, off_p, len(b_p) // 256))
    return segments


@pytest.mark.parametrize("kind", ["round1", "round2", "unsorted", "global", "any-offsets"])
def test_intersect_segments_kernel_equals_plain(cuda, kind):
    """One launch over every segment, each equal to the plain version of
    that segment alone with its own n_chunks."""
    segments = _serving_segments(np.random.default_rng(len(kind)), kind)
    buf, pack = pack_segments(segments)
    buf = buf.to(cuda)
    launches = intersect_sorted.launches
    got = intersect_sorted_segments(buf, pack)
    assert intersect_sorted.launches == launches + 1
    for s, mask in enumerate(pack.split(got)):
        a, b, off = pack.segment(buf, s)
        assert torch.equal(mask, intersect_sorted_plain(a, b, off, n_chunks=pack.n_chunks[s])), s


def test_intersect_candidates_many_on_card_equals_cpu(cuda):
    """The batch's folds in rounds on the card: the CPU's candidates, one
    launch per round."""
    rng = np.random.default_rng(5)
    core = rng.choice(8192, 64, replace=False)
    items = [
        [np.unique(np.concatenate([core, rng.choice(8192, rng.integers(4100, 6000), replace=False)]))
         .astype(np.int32) for _ in range(n)]
        for n in (2, 3, 2, 4, 3, 2)
    ]
    want = fused.intersect_candidates_many(items, device_threshold=1, device="cpu")
    launches = intersect_sorted.launches
    fused.reset_dispatch_count()
    got = fused.intersect_candidates_many(items, device_threshold=1, device=cuda)
    assert fused.dispatch_count() == intersect_sorted.launches - launches == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_gather_kernel_equals_plain_at_serving_shape(cuda):
    """8,192 output blocks over a 16,384-block arena: repeated sources,
    padded blocks, sources past either end, every n_valid kind."""
    rng = np.random.default_rng(2)
    g, nb = 8192, 16384
    arena = torch.from_numpy(rng.integers(-1, 1 << 20, (nb * ARENA_BLOCK, 2)).astype(np.int32)).to(cuda)
    src = rng.integers(0, nb, g).astype(np.int32)
    src[::7] = src[0]
    src[-64:] = 0
    src[1], src[2] = -5, nb + 5
    nv = rng.choice([0, 1, 63, 64, 127, ARENA_BLOCK, ARENA_BLOCK + 3], g).astype(np.int32)
    nv[-64:] = 0
    src_t, nv_t = torch.from_numpy(src).to(cuda), torch.from_numpy(nv).to(cuda)
    launches = gather_blocks.launches
    got = gather_blocks(arena, src_t, nv_t)
    assert gather_blocks.launches == launches + 1
    assert torch.equal(got, gather_blocks_plain(arena, src_t, nv_t))


def test_frontend_on_card_equals_cpu(cuda):
    store = synthesize_corpus(n_docs=120, doc_len=150, vocab_size=600, seed=3)
    index = build_indexes(store, sw_count=60, fu_count=150, max_distance=5)
    requests = [SearchRequest(q, top_k=1000) for q in
                ("who are you who", "to be or not to be", "time and time again")]

    def run(**kw):
        resps = ServingFrontend(index, lemmatizer=store.lemmatizer, **kw).search_many(requests)
        return [[(d.doc_id, d.score, [(f.start, f.end) for f in d.fragments]) for d in r.docs]
                for r in resps]

    want = run(device="cpu")
    for use_kernel, with_arena in ((False, False), (True, False), (False, True), (True, True)):
        kw = {"arena": PostingArena(device="cuda")} if with_arena else {}
        launches = gather_blocks.launches
        got = run(device="cuda", use_kernel=use_kernel, **kw)
        if with_arena and use_kernel:
            assert gather_blocks.launches > launches
        assert [[(d, f) for d, _, f in r] for r in got] == [[(d, f) for d, _, f in r] for r in want]
        for g, w in zip(got, want):
            # float32 row sums never reach the ranking: rank_documents sums
            # the same fragments in the same order on both devices
            assert [s for _, s, _ in g] == [s for _, s, _ in w]


def _incremental_service(device):
    store = synthesize_corpus(n_docs=120, doc_len=150, vocab_size=600, seed=3)
    svc = ShardedSearchService(store, n_shards=2, sw_count=60, fu_count=150,
                               incremental=True, device=device)
    extra = synthesize_corpus(n_docs=24, doc_len=150, vocab_size=600, seed=4)
    svc.add_documents([d.text for d in extra.documents])
    for doc_id in (1, 2, 7):
        svc.delete_document(doc_id)
    svc.commit()
    return svc


def test_incremental_service_on_card_equals_cpu(cuda):
    requests = [SearchRequest(q, top_k=1000) for q in
                ("who are you who", "to be or not to be", "time and time again")]

    def run(svc, **kw):
        resps = ServingFrontend(svc, **kw).search_many(requests)
        return [[(d.doc_id, d.score, [(f.start, f.end) for f in d.fragments]) for d in r.docs]
                for r in resps]

    want = run(_incremental_service("cpu"), device="cpu")
    svc = _incremental_service("cuda")
    for use_kernel, budget in ((False, 0), (True, 0), (True, 64)):
        launches = proximity_window.launches
        got = run(svc, device="cuda", use_kernel=use_kernel, arena_budget_mb=budget)
        if use_kernel and not budget:
            assert proximity_window.launches > launches
        assert got == want


def test_attached_arena_eviction_frees_card_memory(cuda):
    svc = _incremental_service("cuda")
    fe = ServingFrontend(svc, arena_budget_mb=2048, device="cuda")
    fe.search_many(["who are you who", "to be or not to be"])
    torch.cuda.synchronize()
    resident = fe.arena.size_bytes
    assert resident > 0
    before = torch.cuda.memory_allocated()
    svc.add_documents(["who are you who"])
    svc.commit()
    torch.cuda.synchronize()
    # eviction compares token values across shards, as the reference's
    # does: a shard whose stale token equals another shard's live one keeps
    # its buffers until LRU, so not every entry need go
    evicted = resident - fe.arena.size_bytes
    assert fe.arena.evictions > 0 and evicted > 0
    assert before - torch.cuda.memory_allocated() >= evicted
    fe.close()


def _wire(resp):
    return [(d.doc_id, d.score, [(f.start, f.end) for f in d.fragments]) for d in resp.docs]


def test_two_replica_daemon_on_card_equals_serial_card_frontend(cuda):
    """Two card frontends with slates in flight together (one arena both
    share), read out on a daemon thread: every response equals a serial
    card frontend's, batch for batch."""
    from repro_torch.search.service import ServiceDaemon

    svc = ShardedSearchService(synthesize_corpus(n_docs=120, doc_len=150, vocab_size=600, seed=3),
                               n_shards=4, sw_count=60, fu_count=150, device="cuda")
    arena = PostingArena(budget_bytes=256 << 20, device="cuda")
    queries = ["who are you who", "to be or not to be", "time and time again", "one at a time",
               "what do you do all day", "i need you", "the who are an english rock band"]

    def frontend():
        return ServingFrontend(svc, arena=arena, use_kernel=True, max_batch=3, device="cuda")

    daemon = ServiceDaemon([frontend(), frontend()], max_queue=64)
    tickets = [daemon.submit(SearchRequest(q, top_k=10)) for q in queries * 3]
    assert daemon._launch_ready() and len(daemon._inflight) == 2
    daemon.start()  # the rest is launched and read out on the daemon's thread
    results = [t.result(timeout=300) for t in tickets]
    daemon.stop()
    serial = [frontend(), frontend()]
    batches: dict[int, list] = {}
    for t in tickets:
        batches.setdefault(t.seq // 3, []).append(t)
    for _, batch in sorted(batches.items()):
        want = serial[batch[0].replica].search_many([t.request for t in batch])
        for t, w in zip(batch, want):
            assert _wire(results[t.seq]) == _wire(w), t.seq


def test_chaos_through_a_card_frontend_is_exact_or_flagged(cuda, tmp_path):
    """A seeded fault schedule through a card frontend with a 64 MiB arena:
    every response is the CPU service's over every shard or, flagged
    degraded, over the shards the barrier kept."""
    from repro_torch.search.resilience import FaultInjector, ResiliencePolicy

    store = synthesize_corpus(n_docs=120, doc_len=150, vocab_size=600, seed=3)
    kw = dict(n_shards=3, sw_count=60, fu_count=150, incremental=True)
    svc = ShardedSearchService(store, **kw, device="cuda")
    svc.snapshot(tmp_path)
    svc.enable_resilience(policy=ResiliencePolicy(snapshot_dir=tmp_path, breaker_cooldown_s=0.0),
                          injector=FaultInjector.from_seed(101, n_shards=3))
    cpu = ShardedSearchService(store, **kw, device="cpu")
    queries = ["who are you who", "to be or not to be", "time and time again"]
    full = {q: _wire(r) for q, r in zip(queries, cpu.search_batch(queries, top_k=1000))}
    fe = ServingFrontend(svc, arena_budget_mb=64, use_kernel=True, device="cuda")
    for _ in range(10):
        for q, resp in zip(queries, fe.search_many([SearchRequest(q, top_k=1000) for q in queries])):
            if not resp.stats.shards_degraded:
                assert _wire(resp) == full[q] and not resp.stats.partial
            else:
                live = set(range(3)) - set(svc.supervisor.last_excluded)
                degraded = cpu.search_batch([q], top_k=1000, dead_shards=sorted(set(range(3)) - live))
                assert resp.stats.partial and _wire(resp) == _wire(degraded[0])
    m = svc.resilience_metrics()
    assert m["fired"] >= 2 and m["recoveries"] >= 1


def _serve_cell(shape, device, seed=1):
    from repro_torch.configs import get_spec
    from repro_torch.launch.dryrun import cell_inputs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell

    spec = get_spec("paper_search")
    cfg = spec.model_cfg
    cell = build_cell(spec, shape, make_production_mesh())
    args = cell_inputs(cell, cfg, seed=seed, device=device)
    kw = dict(max_distance=cfg.max_distance, n_clusters=args[1].shape[2], window_len=cfg.window_len,
              top_k=cfg.top_k)
    return args, kw


@pytest.mark.parametrize("dtype", ["uint8", "int32"])
def test_serve_step_kernel_path_equals_plain_at_n128(cuda, dtype):
    """serve_online at the single-pod layout (256 shards folded: 65,536 rows
    of 8 x 128, some all zero, a tenth of the clusters padded, postings out
    of range): one cover launch a call, every output equal to the plain
    path's."""
    from repro_torch.search.serving_step import serve_step_sharded, serve_step_sharded_plain

    args, kw = _serve_cell("serve_online", cuda)
    launches = proximity_window.launches
    got = serve_step_sharded(*args, **kw, compute_dtype=dtype)
    assert proximity_window.launches == launches + 1
    plain = serve_step_sharded_plain(*args, **kw, compute_dtype=dtype)
    assert proximity_window.launches == launches + 1
    assert torch.equal(got["n_fragments"], plain["n_fragments"]) and int(got["n_fragments"].sum()) > 0
    assert torch.equal(got["top_docs"], plain["top_docs"])
    assert torch.allclose(got["top_scores"], plain["top_scores"], rtol=1e-5, atol=0)


def test_serve_step_tie_order_on_card(cuda):
    """All-padded queries (-1.0) and queries without postings (0.0): the
    lower cluster first on the card, as on the CPU."""
    from repro_torch.search.serving_step import serve_step

    rng = np.random.default_rng(2)
    b, c, l, n = 6, 64, 8, 128
    post = np.full((b, 32, 3), -1, np.int32)
    post[3:, :, 0] = rng.integers(0, c, (3, 32))
    post[3:, :, 1] = rng.integers(0, n, (3, 32))
    post[3:, :, 2] = rng.integers(0, 2, (3, 32))
    cd = rng.integers(0, 1000, (b, c)).astype(np.int32)
    cd[0] = -1
    cd[2, ::3] = -1
    mult = np.zeros((b, l), np.int32)
    mult[:, :2] = 1
    kw = dict(max_distance=5, n_clusters=c, window_len=n, top_k=16)
    card = serve_step(*(torch.from_numpy(x).to(cuda) for x in (post, cd, mult)), **kw)
    cpu = serve_step(*(torch.from_numpy(x) for x in (post, cd, mult)), **kw)
    assert torch.equal(card["top_docs"].cpu(), cpu["top_docs"])
    assert torch.equal(card["n_fragments"].cpu(), cpu["n_fragments"])
    assert torch.allclose(card["top_scores"].cpu(), cpu["top_scores"], rtol=1e-5, atol=0)
    assert (card["top_scores"][0] == -1.0).all() and (card["top_scores"][1] == 0.0).all()


@pytest.mark.parametrize("n_buckets", [65536, 1000])
def test_build_step_on_card_equals_cpu(cuda, n_buckets):
    """The uint32 hash and the int32 histogram bit for bit, negative tokens
    included."""
    from repro_torch.search.serving_step import build_step

    rng = np.random.default_rng(n_buckets)
    toks = rng.integers(0, 200, (256, 1024)).astype(np.int32)
    toks[::7] = rng.integers(-(2**31), 2**31 - 1, (len(toks[::7]), 1024))
    stop = toks < 80
    card = build_step(torch.from_numpy(toks).to(cuda), torch.from_numpy(stop).to(cuda),
                      max_distance=5, n_buckets=n_buckets)
    cpu = build_step(torch.from_numpy(toks), torch.from_numpy(stop), max_distance=5, n_buckets=n_buckets)
    assert torch.equal(card["bucket_histogram"].cpu(), cpu["bucket_histogram"])
    assert int(card["n_postings"]) == int(cpu["n_postings"]) == int(cpu["bucket_histogram"].sum()) > 0


# ---------------------------------------------------------------------------
# the dense LM path on the card (reduced sizes; chip_smoke.py phase 11 runs
# the same checks at full width)
# ---------------------------------------------------------------------------


def _rel(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("window", [None, 100])
def test_flash_attention_on_card_equals_plain_softmax(cuda, window):
    """bf16 within 2e-2 relative (bf16 products rounded before the float32
    softmax); float32 (TF32 off, PyTorch's default) within rtol 1e-4."""
    from repro_torch.models.layers import attention_plain, flash_attention

    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda) for shape in
               ((2, 512, 8, 64), (2, 512, 2, 64), (2, 512, 2, 64)))
    for dtype, check in ((torch.bfloat16, lambda a, b: _rel(a, b) < 2e-2),
                         (torch.float32, lambda a, b: torch.allclose(a, b, rtol=1e-4, atol=1e-5))):
        args = [x.to(dtype) for x in (q, k, v)]
        got = flash_attention(*args, q_chunk=128, kv_chunk=128, sliding_window=window)
        want = attention_plain(*args, sliding_window=window)
        assert got.dtype == dtype and check(got.float(), want.float())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prefill_then_decode_on_card_equals_prefill_of_one_more_token(cuda, dtype):
    import dataclasses

    from repro_torch.configs import get_reduced_spec
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_reduced_spec("tinyllama-1.1b").model_cfg, dtype=dtype)
    params = transformer.init_params(0, cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 97), generator=gen, device=cuda)
    with torch.no_grad():
        _, cache = transformer.prefill_step(params, tokens[:, :96], cfg)
        padded = {n: torch.cat([c, torch.zeros_like(c[:, :, :4])], dim=2) for n, c in cache.items()}
        logits, _ = transformer.decode_step(params, padded, tokens[:, 96:], 96, cfg)
        want, _ = transformer.prefill_step(params, tokens, cfg)
    if dtype == "float32":
        assert torch.allclose(logits, want, rtol=1e-4, atol=1e-4)
    else:
        assert _rel(logits, want) < 2e-2


def test_float32_train_step_on_card_equals_cpu(cuda):
    """Three float32 steps of the reduced tinyllama train cell (2
    microbatches) on the card and on the CPU: metrics within rtol 1e-4,
    params within atol 1e-5."""
    import dataclasses

    from repro_torch.configs import get_reduced_spec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.tree import tree_leaves, tree_map

    spec = get_reduced_spec("tinyllama-1.1b")
    spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(spec.model_cfg, dtype="float32", microbatches=2))
    cell = build_cell(spec, "train_4k", make_smoke_mesh())
    cpu_args = dryrun.cell_inputs(cell, spec.model_cfg, device="cpu")
    card_args = tree_map(lambda t: t.to(cuda), cpu_args)
    for _ in range(3):
        cpu_p, cpu_o, cpu_m = cell.fn(*cpu_args)
        card_p, card_o, card_m = cell.fn(*card_args)
        assert card_p["embed"].is_cuda
        for k in cpu_m:
            assert torch.allclose(card_m[k].cpu(), cpu_m[k], rtol=1e-4, atol=1e-6), k
        cpu_args = (cpu_p, cpu_o, cpu_args[2])
        card_args = (card_p, card_o, card_args[2])
    for a, b in zip(tree_leaves(card_args[:2]), tree_leaves(cpu_args[:2])):
        assert torch.allclose(a.cpu().float(), b.float(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("capacity_factor", [0.25, 8.0])
def test_moe_ffn_on_card_equals_cpu(cuda, dispatch, capacity_factor):
    """One MoE layer of 16 experts, top 4, float32: the same output, aux and
    dropped (token, slot) pairs on the card and the CPU, with drops (0.25)
    and without (8.0)."""
    from repro_torch.models import moe
    from repro_torch.tree import tree_map

    cfg = moe.MoEConfig(n_experts=16, top_k=4, d_ff=64, capacity_factor=capacity_factor, dispatch=dispatch)
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe_params(gen, 32, cfg, torch.float32)
    x = torch.randn((2, 40, 32), generator=gen)
    card = moe.moe_ffn(x.to(cuda), tree_map(lambda t: t.to(cuda), params), cfg)
    cpu = moe.moe_ffn(x, params, cfg)
    assert torch.allclose(card[0].cpu(), cpu[0], rtol=1e-4, atol=1e-5)
    assert torch.allclose(card[1].cpu(), cpu[1], rtol=1e-4)
    dropped = moe.dropped_slots(x.to(cuda), tree_map(lambda t: t.to(cuda), params), cfg).cpu()
    assert torch.equal(dropped, moe.dropped_slots(x, params, cfg)) and bool(dropped.any()) == (capacity_factor < 1)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-maverick-400b-a17b", "fm", "autoint", "dcn-v2", "mind"])
def test_moe_and_recsys_float32_train_step_on_card_equals_cpu(cuda, arch):
    """One float32 step of each reduced MoE and recsys train cell on the
    card and on the CPU: metrics within rtol 1e-4, params within atol 1e-5."""
    import dataclasses

    from repro_torch.configs import get_reduced_spec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.tree import tree_leaves, tree_map

    spec = get_reduced_spec(arch)
    if spec.family == "lm":
        spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(spec.model_cfg, dtype="float32"))
    shape = next(n for n, c in spec.shapes.items() if c.step == "train")
    cell = build_cell(spec, shape, make_smoke_mesh())
    cpu_args = dryrun.cell_inputs(cell, spec.model_cfg, device="cpu")
    card_args = tree_map(lambda t: t.to(cuda), cpu_args)
    cpu_p, _, cpu_m = cell.fn(*cpu_args)
    card_p, _, card_m = cell.fn(*card_args)
    for k in cpu_m:
        assert torch.allclose(card_m[k].cpu(), cpu_m[k], rtol=1e-4, atol=1e-6), k
    for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p)):
        assert a.is_cuda and torch.allclose(a.cpu(), b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("chunk", [None, 65_536])
def test_gnn_chunked_aggregate_on_card_equals_unchunked(cuda, chunk):
    """The GAT aggregate in edge chunks (from the card's memory, or forced)
    against the unchunked form on the card, at ogbn-products' heads and
    classes on a cut graph: values and both gradients."""
    from repro_torch.models import gnn

    gen = torch.Generator(device=cuda).manual_seed(0)
    n, e, nh, d = 200_000, 1_000_000, 8, 47
    src = torch.randint(0, n, (e,), generator=gen, device=cuda)
    dst = torch.randint(0, n, (e,), generator=gen, device=cuda)
    ex = torch.rand((e, nh), generator=gen, device=cuda).requires_grad_(True)
    h = torch.randn((n, nh, d), generator=gen, device=cuda).requires_grad_(True)
    g_out = torch.randn((n, nh, d), generator=gen, device=cuda)
    got = gnn.aggregate(ex, h, src, dst, chunk)
    want = gnn.aggregate_plain(ex, h, src, dst)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip(torch.autograd.grad(got, (ex, h), g_out), torch.autograd.grad(want, (ex, h), g_out)):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
def test_gnn_float32_train_step_on_card_equals_cpu(cuda, shape):
    """One step of each reduced gat-cora train cell on the card and on the
    CPU: loss within rtol 1e-4, accuracy equal, params within atol 1e-5."""
    from repro_torch.configs import get_reduced_spec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.tree import tree_leaves, tree_map

    spec = get_reduced_spec("gat-cora")
    cell = build_cell(spec, shape, make_smoke_mesh())
    cpu_args = dryrun.cell_inputs(cell, spec.cfg_for(shape), device="cpu")
    cpu_p, _, cpu_m = cell.fn(*cpu_args)
    card_p, _, card_m = cell.fn(*tree_map(lambda t: t.to(cuda), cpu_args))
    assert torch.allclose(card_m["loss"].cpu(), cpu_m["loss"], rtol=1e-4) and float(card_m["acc"]) == float(cpu_m["acc"])
    for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p)):
        assert a.is_cuda and torch.allclose(a.cpu(), b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch,shape", [("paper_search", "serve_online"), ("tinyllama-1.1b", "train_4k"),
                                        ("fm", "train_batch"), ("gat-cora", "molecule")])
def test_cost_counted_on_card_equals_cpu(cuda, arch, shape):
    """A reduced cell of each family counts the same flops and bytes on the
    card (the cover kernel's wrapper charging its figures) as on the CPU
    (its plain version charging the same)."""
    from repro_torch.configs import get_reduced_spec
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost_analysis import count_cost
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.tree import tree_map

    spec = get_reduced_spec(arch)
    cell = build_cell(spec, shape, make_smoke_mesh())
    cpu_args = dryrun.cell_inputs(cell, spec.cfg_for(shape), device="cpu")
    _, on_cpu = count_cost(cell.fn, *cpu_args)
    _, on_card = count_cost(cell.fn, *tree_map(lambda t: t.to(cuda), cpu_args))
    assert on_card == on_cpu and on_cpu.flops > 0


def _world_case(payload):
    """One rank of a world on the card: a reduced tinyllama float32 train
    step and a reduced paper_search serve step under each mesh of
    ``payload["meshes"]``, against the same rank without a mesh."""
    import dataclasses

    from repro_torch.configs import get_reduced_spec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.parallel.sharding import gather_tree
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = get_reduced_spec("tinyllama-1.1b")
    spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(spec.model_cfg, dtype="float32"))
    serve = get_reduced_spec("paper_search")
    out = {}
    for shape, fsdp in payload["meshes"]:
        mesh = make_device_mesh(shape, ("data", "model"), backend=payload["backend"], device="cuda")
        lm = dataclasses.replace(spec, model_cfg=dataclasses.replace(spec.model_cfg, fsdp=fsdp))
        row = {}
        for arch, cell_name, sp in (("tinyllama-1.1b", "train_4k", lm), ("paper_search", "serve_online", serve)):
            want = dryrun.run_cell(arch, cell_name, verbose=False, device=mesh.device, repeats=0, spec=sp,
                                   keep_outputs=True)
            got = dryrun.run_cell(arch, cell_name, verbose=False, dmesh=mesh, repeats=0, spec=sp, keep_outputs=True)
            assert want["status"] == "ok" and got["status"] == "ok", (want.get("traceback"), got.get("traceback"))
            g, w = got["outputs"], want["outputs"]
            if cell_name == "train_4k":
                cell = build_cell(sp, cell_name, dryrun.make_production_mesh(), mesh)
                g = (gather_tree(g[0], cell.in_specs[0], mesh), g[2])
                w = (w[0], w[2])
            pairs = list(zip(tree_leaves(g), tree_leaves(w)))
            row[cell_name] = {"equal": all(torch.equal(a, b) for a, b in pairs),
                              "rel": max(float((a.double() - b.double()).norm() / max(float(b.double().norm()), 1e-30))
                                         for a, b in pairs)}
        out[f"{shape}{' fsdp' if fsdp else ''}"] = row
    return out


def test_world_of_one_over_nccl_equals_no_mesh(cuda, tmp_path):
    from _torch_worlds import run_world

    (res,) = run_world(1, "test_torch_gpu:_world_case", {"backend": "nccl", "meshes": [((1, 1), False)]},
                       tmp_path, backend="nccl")
    assert res["(1, 1)"]["train_4k"]["equal"] and res["(1, 1)"]["serve_online"]["equal"], res


def _family_world_case(payload):
    """The reduced fm and gat-cora train steps on the card under a mesh of
    this world, and without one on the same card: whether the new params,
    AdamW state and metrics are equal, bit for bit (with deterministic
    algorithms: the GNN's ``index_add`` sums in another order each run
    otherwise)."""
    import os

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    from repro_torch.configs import get_reduced_spec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.tree import tree_leaves

    mesh = make_device_mesh(payload["mesh"], ("data", "model"), backend=payload["backend"], device="cuda")
    out = {}
    for arch, cell_name in (("fm", "train_batch"), ("gat-cora", "full_graph_sm")):
        sp = get_reduced_spec(arch)
        want = dryrun.run_cell(arch, cell_name, verbose=False, device=mesh.device, repeats=0, spec=sp,
                               keep_outputs=True)
        got = dryrun.run_cell(arch, cell_name, verbose=False, dmesh=mesh, repeats=0, spec=sp, keep_outputs=True)
        assert want["status"] == "ok" and got["status"] == "ok", (want.get("traceback"), got.get("traceback"))
        pairs = list(zip(tree_leaves(got["outputs"]), tree_leaves(want["outputs"])))
        out[arch] = bool(pairs) and all(torch.equal(a, b) for a, b in pairs)
    return out


def test_world_of_one_over_nccl_runs_fm_and_gat_cora_as_no_mesh(cuda, tmp_path):
    from _torch_worlds import run_world

    (res,) = run_world(1, "test_torch_gpu:_family_world_case", {"backend": "nccl", "mesh": (1, 1)}, tmp_path,
                       backend="nccl")
    assert res == {"fm": True, "gat-cora": True}, res


def test_world_of_two_on_card_equals_one_rank(cuda, tmp_path):
    from _torch_worlds import run_world

    meshes = [((1, 2), False), ((2, 1), True)]
    for res in run_world(2, "test_torch_gpu:_world_case", {"backend": "gloo", "meshes": meshes}, tmp_path):
        for key, row in res.items():
            assert row["serve_online"]["equal"], (key, row)
            assert row["train_4k"]["rel"] <= 1e-5, (key, row)


def _nccl_world_case(payload):
    """``_world_case`` in a rank of a world over NCCL, with the card the
    rank runs on."""
    meshes = _world_case(payload)  # the mesh sets the rank's card
    return {"card": torch.cuda.current_device(), "meshes": meshes}


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL runs one rank a card")
    return cuda


def test_world_of_two_over_nccl_on_two_cards_equals_no_mesh(two_cards, tmp_path):
    """A world of two ranks over NCCL, one on each of two cards: the reduced
    serve_online bit for bit the one-program fold, and a float32 train_4k
    step of the reduced (2-layer) tinyllama within 1e-5 of no mesh, under
    1x2 and 2x1 with FSDP."""
    from _torch_worlds import run_world

    meshes = [((1, 2), False), ((2, 1), True)]
    ranks = run_world(2, "test_torch_gpu:_nccl_world_case", {"backend": "nccl", "meshes": meshes}, tmp_path,
                      timeout=300, backend="nccl")
    assert sorted(res["card"] for res in ranks) == [0, 1]
    for res in ranks:
        for key, row in res["meshes"].items():
            assert row["serve_online"]["equal"], (key, row)
            assert row["train_4k"]["rel"] <= 1e-5, (key, row)


def _decode_world_case(payload):
    """One rank of a world of two on the card: the reduced tinyllama's
    decode cells in float32 under 1x2 (each rank holding half the cache's
    positions), against the same rank's unsharded run: the relative error
    of the logits and of the gathered new cache."""
    import dataclasses

    from repro_torch.configs import get_reduced_spec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.parallel.sharding import gather_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = get_reduced_spec("tinyllama-1.1b")
    spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(spec.model_cfg, dtype="float32"))
    mesh = make_device_mesh((1, 2), ("data", "model"), backend="gloo", device="cuda")
    out = {}
    for shape in payload["shapes"]:
        want = dryrun.run_cell("tinyllama-1.1b", shape, verbose=False, device=mesh.device, repeats=0, spec=spec,
                               keep_outputs=True)
        got = dryrun.run_cell("tinyllama-1.1b", shape, verbose=False, dmesh=mesh, repeats=0, spec=spec,
                              keep_outputs=True)
        assert want["status"] == "ok" and got["status"] == "ok", (want.get("traceback"), got.get("traceback"))
        cell = build_cell(spec, shape, dryrun.make_production_mesh(), mesh)
        logits, cache = got["outputs"]
        whole = gather_tree(cache, cell.in_specs[1], mesh)
        out[shape] = {"rows": cache["k"].shape[2], "logits": _rel(logits, want["outputs"][0]),
                      "cache": max(_rel(whole[k], want["outputs"][1][k]) for k in ("k", "v"))}
    return out


def test_context_parallel_decode_on_card_equals_one_rank(cuda, tmp_path):
    from _torch_worlds import run_world

    for res in run_world(2, "test_torch_gpu:_decode_world_case", {"shapes": ["decode_32k", "long_500k[swa]"]},
                         tmp_path, timeout=300):
        for shape, row in res.items():
            assert row["rows"] == {"decode_32k": 128, "long_500k[swa]": 256}[shape], (shape, row)
            assert row["logits"] <= 1e-5 and row["cache"] <= 1e-5, (shape, row)
