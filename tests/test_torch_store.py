"""The port's durable index store (``index/store.py``, ``checkpoint/``)
against the reference's: the same history snapshots to byte-identical files
in both packages, each package restores the other's snapshots, and the
port's store rejects corruption, retains, resumes tokens under a new
restore epoch and warm-starts sharded services and frontends as the
reference's does.

Comparisons are exact: whole files byte for byte (the ``restore_epoch.*``
claim files aside, which a restore writes), restored views family by
family, and served fragment sets.
"""

import json
import shutil

import numpy as np
import pytest

from repro.index import DocumentStore as RefDocumentStore
from repro.index import IncrementalIndexer as RefIncrementalIndexer
from repro.index import index_sets_equal as ref_index_sets_equal
from repro.search.distributed import ShardedSearchService as RefService
from repro.search.frontend import ServingFrontend as RefFrontend
from repro_torch.checkpoint import fsync_json, latest_numbered, replace_dir, retain_latest
from repro_torch.index import (
    DocumentStore,
    IncrementalIndexer,
    PAPER_EXAMPLE_DOCS,
    StoreError,
    StoredIndexSet,
    index_sets_equal,
    latest_snapshot,
    synthesize_corpus,
)
from repro_torch.index.store import FAMILY_WIDTH
from repro_torch.search import SearchEngine, ServingFrontend, ShardedSearchService

QUERIES = ["who are you who", "to be or not to be", "to be who you are"]


def _texts(n_docs=24, seed=11):
    store = synthesize_corpus(n_docs=n_docs, doc_len=60, vocab_size=500, seed=seed)
    return [d.text for d in store.documents]


def _history(cls, name, texts):
    """One named history, driven identically on either package."""
    ix = cls(sw_count=30, fu_count=60, max_distance=5)
    if name == "empty":
        return ix
    step = len(texts) if name == "single" else max(1, len(texts) // 3)
    for i in range(0, len(texts), step):
        ix.add_documents(texts[i : i + step])
        ix.commit()
    if name == "tombstones-compact":
        for victim in sorted(ix.documents)[::4]:
            ix.delete_document(victim)
        ix.compact(memory_budget_bytes=40_000)
        ix.delete_document(sorted(ix.documents)[1])
    elif name == "fl-drift":
        ix.add_documents(["zeta " * 40, "who are you who"])
        assert ix.commit()["rekeyed_docs"] > 0
    elif name == "buffered":
        ix.add_documents(["a buffered document to be or not"])
    return ix


HISTORIES = ["empty", "single", "multi-segment", "tombstones-compact", "fl-drift", "buffered"]


def _tree(root):
    """Every file under ``root`` but the restore-epoch claims, as bytes."""
    return {
        str(p.relative_to(root)): p.read_bytes()
        for p in sorted(root.rglob("*"))
        if p.is_file() and not p.name.startswith("restore_epoch")
    }


def _assert_same_files(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for name in ta:
        assert ta[name] == tb[name], name


def _frags(resp):
    return sorted((d.doc_id, f.start, f.end) for d in resp.docs for f in d.fragments)


@pytest.mark.parametrize("name", HISTORIES)
def test_snapshot_files_are_byte_identical_and_restore_across_packages(tmp_path, name):
    texts = _texts()
    ix, ref = _history(IncrementalIndexer, name, texts), _history(RefIncrementalIndexer, name, texts)
    ix.snapshot(tmp_path / "port")
    ref.snapshot(tmp_path / "ref")
    _assert_same_files(tmp_path / "port", tmp_path / "ref")
    # each package restores the other's snapshot to the live view
    from_ref = IncrementalIndexer.restore(tmp_path / "ref")
    from_port = RefIncrementalIndexer.restore(tmp_path / "port")
    eq, why = index_sets_equal(from_ref.index.to_index_set(), ix.index.to_index_set())
    assert eq, why
    eq, why = ref_index_sets_equal(from_port.index.to_index_set(), ref.index.to_index_set())
    assert eq, why
    assert from_ref.generation_token == from_port.generation_token == (1, ix.generation_token)
    assert sorted(from_ref._buffer) == sorted(ix._buffer)
    # and serves it: the port over the reference's files, and the reverse
    for q in QUERIES:
        got = SearchEngine(from_ref, device="cpu").search(q, top_k=32)
        live = SearchEngine(ix, device="cpu").search(q, top_k=32)
        assert _frags(got) == _frags(live) == _frags(RefFrontend(from_port).search(q, top_k=32)), q


@pytest.mark.filterwarnings("error::UserWarning")
def test_lazy_decodes_are_byte_identical(tmp_path):
    ix = _history(IncrementalIndexer, "multi-segment", _texts())
    ix.snapshot(tmp_path)
    rx = IncrementalIndexer.restore(tmp_path)
    for seg_mem, seg_disk in zip(ix.segments, rx.segments):
        assert isinstance(seg_disk.index, StoredIndexSet)
        for fname in FAMILY_WIDTH:
            mem, disk = getattr(seg_mem.index, fname), getattr(seg_disk.index, fname)
            assert set(mem) == set(disk), fname
            for key in mem:
                assert mem[key].dtype == disk[key].dtype and mem[key].shape == disk[key].shape
                np.testing.assert_array_equal(mem[key], disk[key])
        assert set(seg_mem.index.nsw) == set(seg_disk.index.nsw)
        for lemma, rec in seg_mem.index.nsw.items():
            for f in ("offsets", "stop_lemma", "distance"):
                a, b = getattr(rec, f), getattr(seg_disk.index.nsw[lemma], f)
                assert a.dtype == b.dtype and np.array_equal(a, b), (lemma, f)
        assert seg_disk.index.size_bytes() == seg_mem.index.size_bytes()
    # restored (read-only mmap) postings serve through the fused program and
    # the arena without touching torch's non-writable-array path
    for kw in ({}, {"arena_budget_mb": 64}):
        fe = ServingFrontend(rx, use_kernel=True, device="cpu", **kw)
        live = ServingFrontend(ix, use_kernel=True, device="cpu", **kw)
        for g, w in zip(fe.search_many(QUERIES), live.search_many(QUERIES)):
            assert _frags(g) == _frags(w)


# ---------------------------------------------------------------------------
# corruption rejection
# ---------------------------------------------------------------------------


def _truncate(path):
    path.write_bytes(path.read_bytes()[:-8])


def _flip(path):
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))


def _set_version(snap):
    m = json.loads((snap / "manifest.json").read_text())
    m["format_version"] = 999
    (snap / "manifest.json").write_text(json.dumps(m))


CORRUPTIONS = {
    "truncated": (lambda snap: _truncate(next(snap.glob("seg_*/postings.bin"))), "truncated"),
    "bitflip": (lambda snap: _flip(next(snap.glob("seg_*/postings.bin"))), "CRC"),
    "manifest": (lambda snap: (snap / "manifest.json").write_text("{not json"), "corrupt manifest"),
    "version": (_set_version, "format version"),
}


@pytest.mark.parametrize("kind", list(CORRUPTIONS))
def test_corruption_is_rejected(tmp_path, kind):
    ix = _history(IncrementalIndexer, "single", _texts(n_docs=10))
    snap = ix.snapshot(tmp_path)
    corrupt, match = CORRUPTIONS[kind]
    corrupt(snap)
    with pytest.raises(StoreError, match=match):
        IncrementalIndexer.restore(tmp_path)
    if kind == "bitflip":
        IncrementalIndexer.restore(tmp_path, verify=False)  # the CRC scan is skipped


def test_missing_snapshot_rejected(tmp_path):
    with pytest.raises(StoreError):
        IncrementalIndexer.restore(tmp_path)


def test_fl_signature_mismatch_rejected(tmp_path):
    """A segment keyed under another FL generation (spliced in from another
    snapshot) is refused: row generation is FL-relative."""
    ix = _history(IncrementalIndexer, "single", _texts(n_docs=12, seed=1))
    other = _history(IncrementalIndexer, "single", _texts(n_docs=12, seed=2))
    snap, other_snap = ix.snapshot(tmp_path / "a"), other.snapshot(tmp_path / "b")
    seg, other_seg = next(snap.glob("seg_*")), next(other_snap.glob("seg_*"))
    shutil.rmtree(seg)
    shutil.copytree(other_seg, seg)
    with pytest.raises(StoreError, match="FL signature"):
        IncrementalIndexer.restore(tmp_path / "a")


# ---------------------------------------------------------------------------
# retention and generation tokens across restarts (§12.5)
# ---------------------------------------------------------------------------


def test_snapshot_retention_keeps_newest(tmp_path):
    ix = _history(IncrementalIndexer, "single", _texts(n_docs=8))
    for _ in range(3):
        ix.snapshot(tmp_path, keep=2)
    assert sorted(p.name for p in tmp_path.glob("snap_*")) == ["snap_1", "snap_2"]
    assert latest_snapshot(tmp_path) == 2
    rx = IncrementalIndexer.restore(tmp_path, snapshot_id=1)
    eq, why = index_sets_equal(rx.index.to_index_set(), ix.index.to_index_set())
    assert eq, why


def test_checkpoint_helpers_publish_and_retain(tmp_path):
    for n in range(3):
        tmp = tmp_path / f"item_{n}.tmp"
        tmp.mkdir()
        fsync_json(tmp / "manifest.json", {"n": n})
        replace_dir(tmp, tmp_path / f"item_{n}")
    (tmp_path / "item_9").mkdir()  # no manifest: not complete, never counted
    assert latest_numbered(tmp_path, "item") == 2
    retain_latest(tmp_path, "item", 1)
    assert sorted(p.name for p in tmp_path.glob("item_*")) == ["item_2", "item_9"]
    assert (tmp_path / "item_2" / "manifest.json").read_text() == '{"n": 2}'


def test_generation_token_resumes_under_new_epoch(tmp_path):
    ix = _history(IncrementalIndexer, "multi-segment", _texts(n_docs=8))
    token_live = ix.generation_token
    ix.snapshot(tmp_path)
    rx = IncrementalIndexer.restore(tmp_path)
    assert rx.generation_token == (1, token_live) != token_live
    rx.add_documents(["one more doc"])
    rx.commit()
    assert rx.generation_token == (1, token_live + 1)
    rx.snapshot(tmp_path)
    assert IncrementalIndexer.restore(tmp_path).generation_token == (2, token_live + 1)
    # sibling restores of one snapshot claim distinct epochs, in either package
    boot_a = IncrementalIndexer.restore(tmp_path)
    boot_b = RefIncrementalIndexer.restore(tmp_path)
    assert boot_a.generation_token == (3, token_live + 1)
    assert boot_b.generation_token == (4, token_live + 1)


# ---------------------------------------------------------------------------
# warm-started serving layers
# ---------------------------------------------------------------------------


def _service_texts():
    return list(PAPER_EXAMPLE_DOCS) + ["to be or not to be", "i need you now"]


def test_sharded_service_snapshot_is_byte_identical_and_restores_across_packages(tmp_path):
    kw = dict(n_shards=2, sw_count=20, fu_count=10, incremental=True)
    svc = ShardedSearchService(DocumentStore.from_texts(_service_texts()), **kw, device="cpu")
    ref = RefService(RefDocumentStore.from_texts(_service_texts()), **kw)
    for s, d in ((svc, tmp_path / "port"), (ref, tmp_path / "ref")):
        s.enable_wal(d)
        s.snapshot(d)
        s.add_documents(["who are you now", "to be a rock"])
        s.delete_document(1)
        s.commit()
    _assert_same_files(tmp_path / "port", tmp_path / "ref")
    restored = ShardedSearchService.restore(tmp_path / "ref", device="cpu")
    ref_restored = RefService.restore(tmp_path / "port")
    assert restored.device == "cpu" and restored.n_shards == svc.n_shards
    assert restored.generation_token == ref_restored.generation_token != svc.generation_token
    for a, b in zip(restored.shards, svc.shards):
        eq, why = index_sets_equal(a.to_index_set(), b.to_index_set())
        assert eq, why
    for q in QUERIES:
        want = _frags(svc.search(q, top_k=16))
        assert _frags(restored.search(q, top_k=16)) == want == _frags(ref_restored.search(q, top_k=16))
    restored.add_documents(["a brand new document"])
    restored.commit()
    assert "device" not in json.loads((tmp_path / "ref" / "service.json").read_text())


def test_service_manifest_pins_survive_torn_snapshot(tmp_path):
    """Shard snapshots written by a run that crashed before publishing
    ``service.json`` leave the previous set restorable; retention runs only
    after the manifest publish."""
    svc = ShardedSearchService(DocumentStore.from_texts(list(PAPER_EXAMPLE_DOCS)), n_shards=2,
                               sw_count=10, fu_count=5, incremental=True, device="cpu")
    svc.snapshot(tmp_path, keep=1)
    want = _frags(svc.search("who are you", top_k=16))
    svc.add_documents(["new doc one"])
    svc.commit()
    for _ in range(2):
        for i, ix in enumerate(svc.indexers):
            ix.snapshot(tmp_path / f"shard_{i:02d}", keep=0)
    restored = ShardedSearchService.restore(tmp_path, device="cpu")
    assert _frags(restored.search("who are you", top_k=16)) == want
    svc.snapshot(tmp_path, keep=1)
    assert all(len(list((tmp_path / f"shard_{i:02d}").glob("snap_*"))) == 1 for i in range(2))
    restored = ShardedSearchService.restore(tmp_path, device="cpu")
    assert _frags(restored.search("who are you", top_k=16)) == _frags(svc.search("who are you", top_k=16))


@pytest.mark.filterwarnings("error::UserWarning")
@pytest.mark.parametrize("arena", [False, True], ids=["host", "arena"])
def test_frontend_warm_start_from_snapshot(tmp_path, arena):
    kw = {"arena_budget_mb": 64} if arena else {}
    ix = _history(IncrementalIndexer, "multi-segment", _texts(n_docs=12))
    before = ServingFrontend(ix, use_kernel=True, device="cpu", **kw).search_many(QUERIES)
    ix.snapshot(tmp_path / "ix")
    warm = ServingFrontend.from_snapshot(tmp_path / "ix", use_kernel=True, device="cpu",
                                         warmup_shapes=[(64, 16, 4, 8, 1, 64)], **kw)
    assert isinstance(warm._source, IncrementalIndexer)
    for b, a in zip(before, warm.search_many(QUERIES)):
        assert _frags(b) == _frags(a)
    # a sharded snapshot is found by its service.json, with its WAL tail
    svc = ShardedSearchService(DocumentStore.from_texts(list(PAPER_EXAMPLE_DOCS)), n_shards=2,
                               sw_count=10, fu_count=5, incremental=True, device="cpu")
    svc.enable_wal(tmp_path / "svc")
    svc.snapshot(tmp_path / "svc")
    svc.add_documents(["who are you who again"])
    svc.commit()
    warm_svc = ServingFrontend.from_snapshot(tmp_path / "svc", use_kernel=True, device="cpu", **kw)
    assert warm_svc._source.device == "cpu"
    assert sum(ix.last_wal_replay["records"] for ix in warm_svc._source.indexers) > 0
    live = ServingFrontend(svc, use_kernel=True, device="cpu", **kw)
    for a, b in zip(warm_svc.search_many(QUERIES), live.search_many(QUERIES)):
        assert _frags(a) == _frags(b)
