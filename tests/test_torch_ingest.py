"""The port's external-memory bulk ingest (``index/ingest.py``,
``IncrementalIndexer.bulk_build``, ``ShardedSearchService.bulk_ingest``)
against the reference's.

Bulk trees are compared as bytes: every file under a tree, and the set of
files, must be identical across packages and to the port's own one-commit
``snapshot()`` of the same corpus — the ``restore_epoch.*`` claim files
aside, which a restore writes.  Crashes at the three ``ingest.*`` fault
points and corrupted spills must resume to the uncrashed tree or fail
cleanly, and each package restores the other's bulk tree.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import pytest

from repro.index import DocumentStore as RefDocumentStore
from repro.index import IncrementalIndexer as RefIncrementalIndexer
from repro.index.ingest import _write_spill_fast as ref_write_spill_fast
from repro.index.ingest import bulk_build as ref_bulk_build
from repro.search.distributed import ShardedSearchService as RefService
from repro_torch.core.lemma import FLList
from repro_torch.index import (
    DocumentStore,
    IncrementalIndexer,
    build_indexes,
    index_sets_equal,
    synthesize_corpus,
)
from repro_torch.index.fastbuild import build_segment_fast
from repro_torch.index.ingest import BulkBuildStats, _write_spill_fast, bulk_build
from repro_torch.index.store import (
    StoreError,
    fl_signature,
    load_snapshot,
    open_segment_store,
    write_segment_store,
)
from repro_torch.search import ServingFrontend, ShardedSearchService
from repro_torch.search.resilience import FaultEvent, FaultInjector, ShardCrash
from tests._hypothesis_compat import given, settings
from tests.strategies import make_corpus, seeds

SW, FU = 8, 16
TEXTS = [
    f"doc {i} the who are you who walk to be or not to be w{i % 7:03d}"
    for i in range(12)
]
DPS = 4  # -> 3 chunks
QUERIES = ["who are you who", "to be or not to be", "to be who you are"]


def _tree(root: Path) -> dict[str, bytes]:
    """Every file under ``root`` but the restore-epoch claims, as bytes."""
    return {
        str(p.relative_to(root)): p.read_bytes()
        for p in sorted(Path(root).rglob("*"))
        if p.is_file() and not p.name.startswith("restore_epoch")
    }


def _assert_trees_identical(a: Path, b: Path, ctx: str) -> None:
    ta, tb = _tree(a), _tree(b)
    assert set(ta) == set(tb), (
        f"{ctx}: file sets differ: only-a={sorted(set(ta) - set(tb))} "
        f"only-b={sorted(set(tb) - set(ta))}"
    )
    diff = [k for k in sorted(ta) if ta[k] != tb[k]]
    assert not diff, f"{ctx}: files differ byte-wise: {diff}"


def _build(out, injector=None, resume=False, **kw):
    return bulk_build(
        TEXTS, out_dir=out, sw_count=SW, fu_count=FU,
        docs_per_spill=DPS, injector=injector, resume=resume, **kw,
    )


def _assert_equals_uncrashed(out, tmp_path):
    """The resumed tree == an uncrashed port run's == the reference's."""
    ref = tmp_path / "uncrashed_ref"
    _build(ref)
    _assert_trees_identical(Path(out) / "snap_0", ref / "snap_0", "resumed vs uncrashed")
    ref_pkg = tmp_path / "reference_package"
    ref_bulk_build(TEXTS, out_dir=ref_pkg, sw_count=SW, fu_count=FU, docs_per_spill=DPS)
    _assert_trees_identical(Path(out) / "snap_0", ref_pkg / "snap_0", "port vs reference")


# ---------------------------------------------------------------------------
# crashes and corruption (the reference's tests/test_ingest_faults.py)
# ---------------------------------------------------------------------------


def test_crash_mid_spill_then_resume_is_byte_identical(tmp_path):
    out = tmp_path / "out"
    inj = FaultInjector([FaultEvent("ingest.spill", "crash", shard=1)])
    with pytest.raises(ShardCrash):
        _build(out, injector=inj)
    assert not list(out.glob("snap_*"))
    assert (out / "ingest_run" / "chunk_0000" / "chunk.json").exists()
    stats = _build(out, resume=True)
    assert stats.chunks_reused == 3 and stats.spills_reused == 1
    _assert_equals_uncrashed(out, tmp_path)


def test_crash_mid_lemmatize_then_resume_is_byte_identical(tmp_path):
    out = tmp_path / "out"
    inj = FaultInjector([FaultEvent("ingest.lemmatize", "crash", shard=2)])
    with pytest.raises(ShardCrash):
        _build(out, injector=inj)
    stats = _build(out, resume=True)
    assert stats.chunks_reused == 2
    _assert_equals_uncrashed(out, tmp_path)


def test_fresh_run_ignores_crashed_leftovers(tmp_path):
    out = tmp_path / "out"
    inj = FaultInjector([FaultEvent("ingest.spill", "crash", shard=0)])
    with pytest.raises(ShardCrash):
        _build(out, injector=inj)
    stats = _build(out)
    assert stats.chunks_reused == 0 and stats.spills_reused == 0
    _assert_equals_uncrashed(out, tmp_path)


def test_bitflip_spill_is_rejected_and_nothing_published(tmp_path):
    out = tmp_path / "out"
    inj = FaultInjector([FaultEvent("ingest.merge", "bitflip", shard=1)])
    with pytest.raises(StoreError):
        _build(out, injector=inj)
    assert inj.log and inj.log[0]["kind"] == "bitflip"
    assert not list(out.glob("snap_*"))
    stats = _build(out, resume=True)
    assert stats.spills_reused == 2
    _assert_equals_uncrashed(out, tmp_path)


def test_truncated_spill_is_rebuilt_on_resume(tmp_path):
    out = tmp_path / "out"
    inj = FaultInjector([FaultEvent("ingest.merge", "crash", shard=0)])
    with pytest.raises(ShardCrash):
        _build(out, injector=inj)
    victim = out / "ingest_run" / "chunk_0001" / "seg_000" / "postings.bin"
    blob = victim.read_bytes()
    victim.write_bytes(blob[: len(blob) // 2])
    stats = _build(out, resume=True)
    assert stats.chunks_reused == 3 and stats.spills_reused == 2
    _assert_equals_uncrashed(out, tmp_path)


def test_crashed_resumed_with_spawn_workers_equals_uncrashed(tmp_path):
    """Resume composes with spawn-pool spilling: workers never change the
    bytes (§17.4)."""
    out = tmp_path / "out"
    inj = FaultInjector([FaultEvent("ingest.spill", "crash", shard=2)])
    with pytest.raises(ShardCrash):
        _build(out, injector=inj)
    _build(out, resume=True, workers=2)
    _assert_equals_uncrashed(out, tmp_path)


def test_kill_at_an_ingest_point_marks_the_chunk_down(tmp_path):
    """A ``kill`` at ``ingest.lemmatize`` aborts like a crash and puts the
    chunk id in the injector's down-set, as the reference's does."""
    import repro.search.resilience as ref_res
    import repro_torch.search.resilience as port_res

    out = []
    for res, build in ((port_res, bulk_build), (ref_res, ref_bulk_build)):
        inj = res.FaultInjector([res.FaultEvent("ingest.lemmatize", "kill", shard=1)])
        with pytest.raises(res.ShardCrash):
            build(TEXTS, out_dir=tmp_path / res.__name__, sw_count=SW, fu_count=FU,
                  docs_per_spill=DPS, injector=inj)
        out.append(([{k: v for k, v in e.items() if k != "path"} for e in inj.log], inj.metrics()))
    assert out[0] == out[1]
    assert out[0][1]["down"] == [1]


# ---------------------------------------------------------------------------
# the raw spill writer and the bulk build (tests/test_ingest_properties.py)
# ---------------------------------------------------------------------------


def _spec_store(spec):
    store = DocumentStore.from_texts(spec.texts)
    fl = FLList.from_frequencies(
        store.lemma_frequencies(), sw_count=spec.sw_count, fu_count=spec.fu_count
    )
    return store, fl


@settings(max_examples=6, deadline=None, derandomize=True)
@given(seeds)
def test_raw_spill_writer_byte_identical(seed):
    """``_write_spill_fast`` == the generic store writer, byte for byte, and
    == the reference's spill writer on the same chunk."""
    spec = make_corpus(seed, max_docs=8)
    store, fl = _spec_store(spec)
    ref_store = RefDocumentStore.from_texts(spec.texts)
    from repro.core.lemma import FLList as RefFLList

    ref_fl = RefFLList.from_frequencies(
        ref_store.lemma_frequencies(), sw_count=spec.sw_count, fu_count=spec.fu_count
    )
    docs = store.documents
    ids = [d.doc_id for d in docs]
    crc = fl_signature(fl)
    with tempfile.TemporaryDirectory() as td:
        ref_dir, fast_dir, pkg_dir = Path(td) / "ref", Path(td) / "fast", Path(td) / "pkg"
        write_segment_store(
            build_segment_fast(docs, fl, max_distance=spec.max_distance),
            ref_dir, fl_crc=crc, doc_ids=ids,
        )
        _write_spill_fast(docs, fl, fast_dir, fl_crc=crc, doc_ids=ids,
                          max_distance=spec.max_distance, build_pair=True,
                          build_degenerate=True)
        ref_write_spill_fast(ref_store.documents, ref_fl, pkg_dir, fl_crc=crc, doc_ids=ids,
                             max_distance=spec.max_distance, build_pair=True,
                             build_degenerate=True)
        _assert_trees_identical(ref_dir, fast_dir, f"seed {seed}")
        _assert_trees_identical(pkg_dir, fast_dir, f"seed {seed} vs the reference")
        open_segment_store(fast_dir, fl, expect_fl_crc=crc)


def test_raw_spill_writer_empty_and_degenerate(tmp_path):
    fl = FLList.from_frequencies({"the": 9, "who": 5, "walk": 2}, sw_count=1, fu_count=1)
    crc = fl_signature(fl)
    cases = {"empty": [], "single": ["walk"], "dup": ["walk walking walked walk walks"]}
    for name, texts in cases.items():
        docs = DocumentStore.from_texts(texts).documents
        ids = [d.doc_id for d in docs]
        ref_dir, fast_dir = tmp_path / f"{name}_ref", tmp_path / f"{name}_fast"
        write_segment_store(build_segment_fast(docs, fl), ref_dir, fl_crc=crc, doc_ids=ids)
        _write_spill_fast(docs, fl, fast_dir, fl_crc=crc, doc_ids=ids, max_distance=5,
                          build_pair=True, build_degenerate=True)
        _assert_trees_identical(ref_dir, fast_dir, name)


@settings(max_examples=4, deadline=None, derandomize=True)
@given(seeds)
def test_bulk_build_equals_in_ram_build_and_reference(seed):
    spec = make_corpus(seed, max_docs=10)
    rng = np.random.default_rng(seed ^ 0x5B1711)
    docs_per_spill = int(rng.integers(1, len(spec.texts) + 2))
    kw = dict(sw_count=spec.sw_count, fu_count=spec.fu_count,
              max_distance=spec.max_distance, docs_per_spill=docs_per_spill)
    with tempfile.TemporaryDirectory() as td:
        stats = bulk_build(spec.texts, out_dir=Path(td) / "port", **kw)
        assert isinstance(stats, BulkBuildStats) and stats.n_docs == len(spec.texts)
        ref_bulk_build(spec.texts, out_dir=Path(td) / "ref", **kw)
        _assert_trees_identical(Path(td) / "port", Path(td) / "ref", f"seed {seed}")
        got = load_snapshot(Path(td) / "port").index.to_index_set()
        want = build_indexes(DocumentStore.from_texts(spec.texts), sw_count=spec.sw_count,
                             fu_count=spec.fu_count, max_distance=spec.max_distance)
        equal, why = index_sets_equal(got, want)
        assert equal, f"seed {seed} dps={docs_per_spill}: {why}"
        assert set(got.nsw) == set(want.nsw)


def test_bulk_build_single_doc_and_duplicate_lemma_corpus(tmp_path):
    for name, texts in {"single": ["to be or not to be"],
                        "dup": ["walk walking walked", "walks walk the walk"]}.items():
        bulk_build(texts, out_dir=tmp_path / name, sw_count=2, fu_count=2, docs_per_spill=1)
        ref_bulk_build(texts, out_dir=tmp_path / f"{name}_ref", sw_count=2, fu_count=2,
                       docs_per_spill=1)
        _assert_trees_identical(tmp_path / name, tmp_path / f"{name}_ref", name)
        restored = load_snapshot(tmp_path / name)
        ref = build_indexes(DocumentStore.from_texts(texts), sw_count=2, fu_count=2)
        equal, why = index_sets_equal(restored.index.to_index_set(), ref)
        assert equal, f"{name}: {why}"


def test_bulk_build_worker_count_invariant(tmp_path):
    """1-worker and 3-worker (spawn) builds publish byte-identical trees."""
    store = DocumentStore.from_texts(make_corpus(1234, max_docs=12).texts)
    texts = [d.text for d in store.documents]
    out1, out3 = tmp_path / "w1", tmp_path / "w3"
    bulk_build(texts, out_dir=out1, sw_count=10, fu_count=20, docs_per_spill=3, workers=1)
    stats = bulk_build(texts, out_dir=out3, sw_count=10, fu_count=20, docs_per_spill=3,
                       workers=3)
    assert stats.workers == 3 and stats.n_chunks == len(texts) // 3
    _assert_trees_identical(out1 / "snap_0", out3 / "snap_0", "workers 1 vs 3")


# ---------------------------------------------------------------------------
# IncrementalIndexer.bulk_build and the sharded bulk ingest
# ---------------------------------------------------------------------------


def test_bulk_build_anchors_wal_for_post_build_replay(tmp_path):
    store = synthesize_corpus(n_docs=10, doc_len=50, vocab_size=250, seed=11)
    live, stats = IncrementalIndexer.bulk_build(
        documents=list(store.documents), out_dir=tmp_path, sw_count=SW, fu_count=FU,
        max_distance=5, lemmatizer=store.lemmatizer, wal=True,
    )
    assert stats.n_docs == len(store)
    assert live.wal is not None
    assert live.wal.records()[0].rtype == "bulk_build"
    live.add_documents(["post build doc alpha beta"])
    live.commit()
    recovered = IncrementalIndexer.restore(tmp_path, lemmatizer=store.lemmatizer)
    assert recovered.last_wal_replay["records"] == 2
    eq, why = index_sets_equal(recovered.index.to_index_set(), live.index.to_index_set())
    assert eq, why
    assert recovered.documents.keys() == live.documents.keys()
    # the reference replays the port's log the same way
    ref = RefIncrementalIndexer.restore(tmp_path, lemmatizer=store.lemmatizer)
    assert ref.last_wal_replay["records"] == 2
    assert sorted(ref.documents) == sorted(live.documents)


def test_incremental_bulk_build_equals_one_commit_snapshot(tmp_path):
    """The §17.4 contract at the indexer: a bulk build's tree is the
    one-commit ``snapshot()`` tree of the same documents, in both packages."""
    store = synthesize_corpus(n_docs=30, doc_len=60, vocab_size=400, seed=4)
    ix = IncrementalIndexer(sw_count=SW, fu_count=FU, max_distance=5, lemmatizer=store.lemmatizer)
    ix.add_prelemmatized(store.documents)
    ix.commit()
    ix.snapshot(tmp_path / "snap")
    bulk, _ = IncrementalIndexer.bulk_build(
        documents=list(store.documents), out_dir=tmp_path / "bulk", sw_count=SW, fu_count=FU,
        max_distance=5, lemmatizer=store.lemmatizer, docs_per_spill=7,
    )
    from repro.index import synthesize_corpus as ref_synthesize_corpus

    ref_docs = ref_synthesize_corpus(n_docs=30, doc_len=60, vocab_size=400, seed=4).documents
    ref, _ = RefIncrementalIndexer.bulk_build(
        documents=list(ref_docs),
        out_dir=tmp_path / "ref", sw_count=SW, fu_count=FU, max_distance=5, docs_per_spill=7,
    )
    _assert_trees_identical(tmp_path / "bulk", tmp_path / "snap", "bulk vs snapshot")
    _assert_trees_identical(tmp_path / "bulk", tmp_path / "ref", "port vs reference")
    assert index_sets_equal(bulk.index.to_index_set(), ix.index.to_index_set())[0]


@pytest.fixture(scope="module")
def sharded_trees(tmp_path_factory):
    """One corpus bulk-ingested into 3 shards by each package, and the
    port's one-commit incremental service snapshotted (no WAL)."""
    root = tmp_path_factory.mktemp("bulk")
    kw = dict(n_docs=60, doc_len=80, vocab_size=500, seed=9)
    from repro.index import synthesize_corpus as ref_synthesize_corpus

    store, ref_store = synthesize_corpus(**kw), ref_synthesize_corpus(**kw)
    svc_kw = dict(n_shards=3, sw_count=20, fu_count=50, max_distance=5)
    port_svc, port_stats = ShardedSearchService.bulk_ingest(
        store, root / "port", **svc_kw, docs_per_spill=8, device="cpu")
    ref_svc, ref_stats = RefService.bulk_ingest(ref_store, root / "ref", **svc_kw,
                                                docs_per_spill=8)
    inc = ShardedSearchService(store, **svc_kw, incremental=True, device="cpu")
    inc.snapshot(root / "snap")
    return root, store, port_svc, port_stats, ref_svc, inc


def test_sharded_bulk_tree_byte_identical_to_reference_and_snapshot(sharded_trees):
    root, store, port_svc, stats, _, _ = sharded_trees
    assert len(stats) == 3 and sum(s.n_docs for s in stats) == len(store)
    assert all(s.spill_bytes > 0 and s.docs_per_sec > 0 for s in stats)
    _assert_trees_identical(root / "port", root / "ref", "port vs reference bulk tree")
    _assert_trees_identical(root / "port", root / "snap", "bulk tree vs one-commit snapshot")
    # the bulk ingest's own restore claimed an epoch in every shard
    assert len(list((root / "port").glob("shard_*/restore_epoch.*"))) == 3
    assert port_svc.device == "cpu" and port_svc.n_shards == 3


def test_sharded_bulk_ingest_serves_like_the_incremental_service(sharded_trees):
    _, _, port_svc, _, ref_svc, inc = sharded_trees
    for alg in ("se2.4", "fused"):
        port_svc.algorithm = ref_svc.algorithm = inc.algorithm = alg
        got = port_svc.search_batch(QUERIES, top_k=1000)
        for want in (inc.search_batch(QUERIES, top_k=1000),
                     ref_svc.search_batch(QUERIES, top_k=1000)):
            for g, w in zip(got, want):
                assert [(d.doc_id, sorted((f.start, f.end) for f in d.fragments)) for d in g.docs] == \
                    [(d.doc_id, sorted((f.start, f.end) for f in d.fragments)) for d in w.docs]
                np.testing.assert_allclose([d.score for d in g.docs], [d.score for d in w.docs],
                                           rtol=1e-5)
    port_svc.algorithm = ref_svc.algorithm = inc.algorithm = "se2.4"
    fe = ServingFrontend(port_svc, arena_budget_mb=64, device="cpu")
    assert [len(r.docs) for r in fe.search_many(QUERIES)] == \
        [len(r.docs) for r in inc.search_batch(QUERIES)]


def test_each_package_restores_the_others_bulk_tree(sharded_trees, tmp_path):
    import shutil

    root, store, port_svc, _, ref_svc, _ = sharded_trees
    shutil.copytree(root / "ref", tmp_path / "ref")
    shutil.copytree(root / "port", tmp_path / "port")
    from_ref = ShardedSearchService.restore(tmp_path / "ref", device="cpu")
    from_port = RefService.restore(tmp_path / "port")
    for a, b in ((from_ref, ref_svc), (from_port, port_svc)):
        for x, y in zip(a.indexers, b.indexers):
            eq, why = index_sets_equal(x.index.to_index_set(), y.index.to_index_set())
            assert eq, why
    got = from_ref.search_batch(QUERIES, top_k=1000)
    want = from_port.search_batch(QUERIES, top_k=1000)
    for g, w in zip(got, want):
        assert {(d.doc_id, f.start, f.end) for d in g.docs for f in d.fragments} == \
            {(d.doc_id, f.start, f.end) for d in w.docs for f in d.fragments}


def test_sharded_bulk_ingest_resumes_after_a_crash(tmp_path):
    """A crash at one shard's spill: ``resume=True`` finishes the tree,
    byte-identical to an uncrashed ingest."""
    store = synthesize_corpus(n_docs=24, doc_len=50, vocab_size=300, seed=3)
    kw = dict(n_shards=2, sw_count=10, fu_count=30, docs_per_spill=4, device="cpu")
    inj = FaultInjector([FaultEvent("ingest.spill", "crash", shard=1)])
    with pytest.raises(ShardCrash):
        ShardedSearchService.bulk_ingest(store, tmp_path / "a", injector=inj, **kw)
    assert not (tmp_path / "a" / "service.json").exists()
    ShardedSearchService.bulk_ingest(store, tmp_path / "a", resume=True, **kw)
    ShardedSearchService.bulk_ingest(store, tmp_path / "b", **kw)
    _assert_trees_identical(tmp_path / "a", tmp_path / "b", "resumed vs uncrashed")
