"""The port's sharded service (``search/distributed.py``), the frontend and
planner over it, and ``device_topk_merge``, against the reference's on the
same stores.

Fragment sets must be identical — across algorithms, routes (host pack,
posting arena, both readouts) and packages — and scores agree within the
tolerance each test states (float sums over the same fragments: 1e-9 where
both rank the same fragments in the same order).  There are no dead shards:
the resilience layer is not ported yet.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.index import DocumentStore as RefDocumentStore
from repro.index import synthesize_corpus as ref_synthesize_corpus
from repro.search.distributed import ShardedSearchService as RefShardedSearchService
from repro.search.distributed import device_topk_merge as ref_device_topk_merge
from repro.search.distributed import shard_documents as ref_shard_documents
from repro.search.frontend import SearchRequest as RefRequest
from repro.search.frontend import ServingFrontend as RefFrontend
from repro_torch.core.combiner import se24_combiner
from repro_torch.core.keys import expand_subqueries, select_keys
from repro_torch.core.oracle import oracle_search
from repro_torch.index import DocumentStore, build_indexes, synthesize_corpus
from repro_torch.search import (
    ALGORITHMS,
    SearchEngine,
    SearchRequest,
    ServingFrontend,
    ShardedSearchService,
    device_topk_merge,
    fused,
    shard_documents,
)
from repro_torch.search import distributed as dist_mod
from repro_torch.search.arena import PostingArena
from tests.strategies import make_corpus, make_queries

QUERIES = [
    "who are you who",
    "to be or not to be",
    "what do you do all day",
    "the time of war",
    "to be who you are",
]
SERVICE = dict(n_shards=4, sw_count=60, fu_count=150)


def _frags(resp):
    return {(d.doc_id, f.start, f.end) for d in resp.docs for f in d.fragments}


def _docs(resp):
    return [(d.doc_id, sorted((f.start, f.end) for f in d.fragments)) for d in resp.docs]


@pytest.fixture(scope="module")
def stores():
    kw = dict(n_docs=50, doc_len=100, vocab_size=600, seed=11)
    return ref_synthesize_corpus(**kw), synthesize_corpus(**kw)


@pytest.fixture(scope="module")
def services(stores):
    ref_store, store = stores
    return (RefShardedSearchService(ref_store, **SERVICE),
            ShardedSearchService(store, **SERVICE, device="cpu"))


def test_shard_documents_partition_equals_reference(stores):
    ref_store, store = stores
    shards = shard_documents(store, 4)
    assert sum(len(s) for s in shards) == len(store)
    for i, (s, r) in enumerate(zip(shards, ref_shard_documents(ref_store, 4))):
        assert all(d.doc_id % 4 == i for d in s.documents)
        assert [d.doc_id for d in s.documents] == [d.doc_id for d in r.documents]
        assert [d.lemma_stream for d in s.documents] == [d.lemma_stream for d in r.documents]


def test_shards_equal_reference_shards(services):
    """One corpus-global FL-list; every shard's families, array for array."""
    ref_svc, svc = services
    assert svc.fl.lemmas == ref_svc.fl.lemmas and svc.generation_token == ref_svc.generation_token
    for shard, ref_shard in zip(svc.shards, ref_svc.shards):
        assert shard.fl is svc.fl and shard.n_docs == ref_shard.n_docs
        for name in ("ordinary", "pair", "triple", "stop_single", "stop_pair"):
            fam, ref_fam = getattr(shard, name), getattr(ref_shard, name)
            assert set(fam) == set(ref_fam), name
            for key in fam:
                np.testing.assert_array_equal(fam[key], ref_fam[key], err_msg=f"{name}[{key}]")


@pytest.mark.parametrize("algorithm", [*ALGORITHMS, "fused"])
def test_sharded_service_equals_reference_service(services, algorithm):
    """Every algorithm over the same shards: the reference service's
    documents and fragments, scores within rtol 1e-9."""
    ref_svc, svc = services
    ref_svc.algorithm = svc.algorithm = algorithm
    try:
        got = svc.search_batch(QUERIES, top_k=1000)
        want = ref_svc.search_batch(QUERIES, top_k=1000)
    finally:
        ref_svc.algorithm = svc.algorithm = "se2.4"
    for g, w in zip(got, want):
        assert _docs(g) == _docs(w), (algorithm, g.query)
        np.testing.assert_allclose([d.score for d in g.docs], [d.score for d in w.docs], rtol=1e-9)
        assert g.n_subqueries == w.n_subqueries


def test_fused_sharded_service_is_one_dispatch_and_equals_the_combiner(stores):
    """4 shards (``tests/test_fused.py``'s sharded case without dead
    shards): the whole batch is one device program, and it serves the
    documents and scores of the host Combiner over the same shards."""
    _, store = stores
    svc_f = ShardedSearchService(store, **SERVICE, algorithm="fused", device="cpu")
    svc_h = ShardedSearchService(store, **SERVICE, algorithm="se2.4", device="cpu")
    fused.reset_dispatch_count()
    resps_f = svc_f.search_batch(QUERIES[:4], top_k=20)
    assert fused.dispatch_count() == 1
    assert all(r.stats.device_dispatches == 1 for r in resps_f)
    for q, rf in zip(QUERIES[:4], resps_f):
        rh = svc_h.search(q, top_k=20)
        assert {d.doc_id for d in rf.docs} == {d.doc_id for d in rh.docs}
        np.testing.assert_allclose(sorted(d.score for d in rf.docs), sorted(d.score for d in rh.docs),
                                   rtol=1e-6)


def test_sharded_service_equals_single_index(stores):
    """``tests/test_system.py``: 4 shards under one FL-list == one index."""
    _, store = stores
    svc = ShardedSearchService(store, **SERVICE, device="cpu")
    single = SearchEngine(build_indexes(store, sw_count=60, fu_count=150, max_distance=5),
                          lemmatizer=store.lemmatizer, device="cpu")
    for q in QUERIES:
        a, b = svc.search(q, top_k=8), single.search(q, top_k=8)
        assert {d.doc_id for d in a.docs} == {d.doc_id for d in b.docs}
        np.testing.assert_allclose(sorted(d.score for d in a.docs), sorted(d.score for d in b.docs),
                                   rtol=1e-9)
        assert _frags(svc.search(q, top_k=1000)) == _frags(single.search(q, top_k=1000))


@pytest.mark.parametrize("seed", [7, 101, 4242])
def test_frontend_over_sharded_service_matches_unplanned_and_reference(seed):
    """``tests/test_planner.py``'s frontend over a 2-shard fused service:
    planned == unplanned, == the reference's frontend over the reference's
    service, with and without a 64 MiB arena."""
    spec = make_corpus(seed, max_docs=8)
    kw = dict(n_shards=2, sw_count=spec.sw_count, fu_count=spec.fu_count,
              max_distance=spec.max_distance, algorithm="fused")
    svc = ShardedSearchService(DocumentStore.from_texts(spec.texts), **kw, device="cpu")
    ref_svc = RefShardedSearchService(RefDocumentStore.from_texts(spec.texts), **kw)
    queries = make_queries(seed, spec, n_queries=2) + ["to be who you are"]
    unplanned = svc.search_batch(queries, top_k=64)
    for arena_mb in (0, 64):
        fe = ServingFrontend(svc, arena_budget_mb=arena_mb, device="cpu")
        served = fe.search_many([SearchRequest(q, top_k=64) for q in queries])
        ref_fe = RefFrontend(ref_svc, arena_budget_mb=arena_mb)
        want = ref_fe.search_many([RefRequest(q, top_k=64) for q in queries])
        for a, b, w in zip(unplanned, served, want):
            assert _docs(a) == _docs(b) == _docs(w), (a.query, arena_mb)
            for field in ("postings_read", "bytes_read", "arena_hits", "arena_misses"):
                assert getattr(b.stats, field) == getattr(w.stats, field), (a.query, field)
        if arena_mb:
            assert fe.metrics()["arena_uploads"] == ref_fe.metrics()["arena_uploads"] > 0
        cached = fe.search_many([SearchRequest(q, top_k=64) for q in queries])
        assert all(r.stats.cache_hits == 1 for r in cached)
        fe.close()


def test_frontend_keys_shard_views_by_shard(services):
    """Posting-cache keys carry the shard id; each shard's arena residency
    is acquired under its own (token, shard)."""
    _, svc = services
    fe = ServingFrontend(svc, arena_budget_mb=64, device="cpu")
    token, views, shard_ids, cached, _ = fe._live_views()
    assert shard_ids == [0, 1, 2, 3] and [c._key_prefix for c in cached] == [(token, s) for s in shard_ids]
    res = fe._acquire_residencies(views, cached, token, shard_ids)
    assert [res[id(c)].shard for c in cached] == shard_ids
    assert {res[id(c)].token for c in cached} == {token}
    fe.close()


def test_sharded_service_arena_equals_host_pack(stores):
    """``tests/test_arena.py``'s sharded arena case without dead shards: one
    dispatch, the host pack's fragments, the arena hit."""
    _, store = stores
    svc_a = ShardedSearchService(store, **SERVICE, algorithm="fused",
                                 arena=PostingArena(device="cpu"), device="cpu")
    svc_h = ShardedSearchService(store, **SERVICE, algorithm="fused", device="cpu")
    fused.reset_dispatch_count()
    ra = svc_a.search_batch(QUERIES[:3], top_k=32)
    assert fused.dispatch_count() == 1
    assert sum(r.stats.arena_hits for r in ra) > 0
    for a, h in zip(ra, svc_h.search_batch(QUERIES[:3], top_k=32)):
        assert _frags(a) == _frags(h)


@pytest.mark.parametrize("seed", [5, 77])
def test_sharded_device_readout_equals_host_readout_and_oracle(seed, monkeypatch):
    """``tests/test_differential.py``'s sharded case without dead shards:
    the device readout == the host readout == the §10 oracle over every
    shard."""
    spec = make_corpus(seed, max_docs=8)
    store = DocumentStore.from_texts(spec.texts)
    svc = ShardedSearchService(store, n_shards=2, sw_count=spec.sw_count, fu_count=spec.fu_count,
                               max_distance=spec.max_distance, algorithm="fused", device="cpu")
    for q in make_queries(seed, spec, n_queries=3):
        ra = svc.search(q, top_k=32)
        with monkeypatch.context() as m:
            m.setattr(dist_mod, "serve_query_batch",
                      partial(dist_mod.serve_query_batch, readout="host"))
            rb = svc.search(q, top_k=32)
        assert _docs(ra) == _docs(rb), q
        oracle = set()
        for shard in svc.shards:
            for sub in expand_subqueries(q, store.lemmatizer):
                keys = select_keys(sub, shard.fl)
                post = {k: shard.key_postings(k.components) for k in keys}
                oracle |= {tuple(r) for r in oracle_search(sub, keys, post, shard.max_distance)}
                assert set(se24_combiner(sub, shard)[0]) <= oracle
        assert _frags(svc.search(q, top_k=10_000)) == oracle, q


@pytest.mark.parametrize("k", [1, 5, 12, 40])
@pytest.mark.parametrize("seed", [0, 1])
def test_device_topk_merge_equals_reference_with_ties(seed, k):
    """The reference's ``jax.lax.top_k`` keeps the lower flat index first
    among equal scores; so does the port's stable sort."""
    rng = np.random.default_rng(seed)
    scores = rng.choice([0.5, 1.0, 2.0, 3.0], (4, 8)).astype(np.float32)  # many ties
    scores[1, 3] = scores[2, 0] = scores[3, 7] = 9.0  # a tie across shards at the top
    doc_ids = rng.permutation(32).reshape(4, 8).astype(np.int32)
    top, docs = device_topk_merge(torch.from_numpy(scores), torch.from_numpy(doc_ids), k)
    ref_top, ref_docs = ref_device_topk_merge(jnp.asarray(scores), jnp.asarray(doc_ids), k)
    np.testing.assert_array_equal(top.numpy(), np.asarray(ref_top))
    np.testing.assert_array_equal(docs.numpy(), np.asarray(ref_docs))
    assert docs[:3].tolist() == [doc_ids[1, 3], doc_ids[2, 0], doc_ids[3, 7]][: min(k, 3)]


def test_unported_options_raise_naming_their_item(stores, tmp_path):
    """Bulk ingest and the resilience layer are ported: ``resilience=`` and
    ``injector=`` switch the probe barrier on at construction, as the
    reference's do, and ``dead_shards`` degrades a batch exactly as the
    reference's.  A static service's durability endpoints still need
    ``incremental=True``, as the reference's do."""
    from repro.search.resilience import FaultInjector as RefInjector
    from repro.search.resilience import ResiliencePolicy as RefPolicy
    from repro_torch.search.resilience import FaultInjector, ResiliencePolicy

    ref_store, store = stores
    small = dict(n_shards=2, sw_count=10, fu_count=10)
    for kw, ref_kw in (({"resilience": ResiliencePolicy()}, {"resilience": RefPolicy()}),
                       ({"injector": FaultInjector()}, {"injector": RefInjector()})):
        svc = ShardedSearchService(store, **small, **kw, device="cpu")
        ref = RefShardedSearchService(ref_store, **small, **ref_kw)
        assert svc.supervisor is not None and svc.injector is not None
        assert svc.resilience_metrics() == ref.resilience_metrics()
    svc = ShardedSearchService(store, **small, device="cpu")
    ref = RefShardedSearchService(ref_store, **small)
    assert svc.resilience_metrics() == {} and svc.supervisor is None
    got = svc.search_batch(QUERIES, top_k=1000, dead_shards=[0])
    want = ref.search_batch(QUERIES, top_k=1000, dead_shards=[0])
    for g, w in zip(got, want):
        assert _docs(g) == _docs(w) and g.stats.shards_degraded == w.stats.shards_degraded == 1
        assert g.stats.partial and all(d.doc_id % 2 == 1 for d in g.docs)
    assert svc.enable_resilience() is svc.supervisor
    bulk, stats = ShardedSearchService.bulk_ingest(store, tmp_path / "bulk", 2, 10, 10, device="cpu")
    assert bulk.device == "cpu" and sum(st.n_docs for st in stats) == len(store)
    for call in (lambda: svc.enable_wal(tmp_path), lambda: svc.snapshot(tmp_path),
                 lambda: svc.commit(), lambda: svc.delete_document(0)):
        with pytest.raises(RuntimeError, match="incremental=True"):
            call()
    incremental = ShardedSearchService(store, **small, incremental=True)
    assert incremental.generation_token == (1, 1)
    with pytest.raises(ValueError, match="mesh"):
        device_topk_merge(torch.zeros(2, 2), torch.zeros(2, 2), 2, mesh=object())
