"""The port's write-ahead log (``index/wal.py``) against the reference's.

Frames are the reference's bytes exactly; a log written by either package
replays in the other to an ``index_sets_equal`` view; torn and flipped tails
truncate to the acknowledged prefix (every byte boundary of a small log is
swept); replay neither re-logs nor counts anchors; and the ``wal.append`` /
``wal.torn_tail`` fault points behave as the reference calls them, driven
here by a stub injector.
"""

import bisect
import json

import pytest

from repro.index import IncrementalIndexer as RefIncrementalIndexer
from repro.index import WriteAheadLog as RefWriteAheadLog
from repro.index import index_sets_equal as ref_index_sets_equal
from repro.index.wal import encode_frame as ref_encode_frame
from repro.index.wal import docs_to_payload as ref_docs_to_payload
from repro.index.wal import fl_to_payload as ref_fl_to_payload
from repro_torch.index import (
    DocumentStore,
    IncrementalIndexer,
    WriteAheadLog,
    index_sets_equal,
    read_frames,
    synthesize_corpus,
)
from repro_torch.index.wal import (
    docs_to_payload,
    encode_frame,
    fl_from_payload,
    fl_to_payload,
    replay,
)

SW, FU, D = 40, 80, 5

PAYLOADS = [
    ("add", {"docs": [{"doc_id": 0, "text": "a b", "lemmas": [["a", 0]]}]}),
    ("delete", {"doc_id": 3}),
    ("commit", {"fl": None}),
    ("compact", {"memory_budget_bytes": None}),
    ("checkpoint", {"snapshot_id": 0, "mutations": 4}),
    ("bulk_build", {"snapshot_id": 2, "mutations": 9}),
]


def _texts(n=18, seed=11):
    store = synthesize_corpus(n_docs=n, doc_len=50, vocab_size=250, seed=seed)
    return [d.text for d in store.documents], store.lemmatizer


def _fresh(lem=None, cls=IncrementalIndexer):
    return cls(sw_count=SW, fu_count=FU, max_distance=D, lemmatizer=lem)


def _assert_same_index(a, b, ctx=""):
    eq, why = index_sets_equal(a.index.to_index_set(), b.index.to_index_set())
    assert eq, f"{ctx}: {why}"


class _Crash(RuntimeError):
    pass


class _StubInjector:
    """Raises at the ``at_call``-th firing of ``point``; records every call
    (point, keyword arguments) as the log makes it."""

    def __init__(self, point, at_call):
        self.point, self.at_call, self.n = point, at_call, 0
        self.calls = []

    def fire(self, point, **kw):
        self.calls.append((point, kw))
        if point == self.point:
            self.n += 1
            if self.n - 1 == self.at_call:
                raise _Crash(point)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rtype,payload", PAYLOADS, ids=[p[0] for p in PAYLOADS])
def test_encode_frame_bytes_equal_reference(rtype, payload):
    for seq in (0, 7, 2**40):
        assert encode_frame(seq, rtype, payload) == ref_encode_frame(seq, rtype, payload)


def test_frame_round_trip_byte_exact(tmp_path):
    path = tmp_path / "records.bin"
    path.write_bytes(b"".join(encode_frame(i, t, p) for i, (t, p) in enumerate(PAYLOADS)))
    assert [(r.seq, r.rtype, r.payload) for r in read_frames(path)] == [
        (i, t, p) for i, (t, p) in enumerate(PAYLOADS)
    ]


@pytest.mark.parametrize(
    "mutate,survivors",
    [
        (lambda data: data[:-1], 3),  # torn tail: short payload
        (lambda data: data[: len(data) // 2], 2),  # torn mid-frame
        (lambda data: data[:-3] + bytes([data[-3] ^ 0x40]) + data[-2:], 3),  # bitflip
    ],
    ids=["short-payload", "mid-frame", "bitflip"],
)
def test_torn_or_flipped_tail_truncates_to_acknowledged_prefix(tmp_path, mutate, survivors):
    path = tmp_path / "records.bin"
    frames = [encode_frame(i, "delete", {"doc_id": i}) for i in range(4)]
    path.write_bytes(mutate(b"".join(frames)))
    assert [r.seq for r in read_frames(path)] == list(range(survivors))
    assert path.read_bytes() == b"".join(frames[:survivors])
    with open(path, "ab") as f:
        f.write(encode_frame(survivors, "delete", {"doc_id": 99}))
    assert [r.payload["doc_id"] for r in read_frames(path)] == list(range(survivors)) + [99]


def test_mid_file_corruption_stops_scan_never_resyncs(tmp_path):
    path = tmp_path / "records.bin"
    frames = [encode_frame(i, "delete", {"doc_id": i}) for i in range(3)]
    bad = bytearray(b"".join(frames))
    bad[len(frames[0]) + 8] ^= 0x01  # inside frame 1
    path.write_bytes(bytes(bad))
    assert [r.seq for r in read_frames(path)] == [0]
    assert path.read_bytes() == frames[0]


def test_non_monotonic_sequence_rejected(tmp_path):
    path = tmp_path / "records.bin"
    path.write_bytes(encode_frame(5, "delete", {"doc_id": 0}) + encode_frame(5, "delete", {"doc_id": 1}))
    assert [r.seq for r in read_frames(path)] == [5]


def test_records_truncated_at_every_boundary_are_the_acked_prefix(tmp_path):
    payloads = [("add", {"docs": [{"doc_id": i, "text": f"t{i}", "lemmas": []}]}) for i in range(3)]
    payloads += [("commit", {"fl": None}), ("delete", {"doc_id": 1})]
    frames = [encode_frame(i, t, p) for i, (t, p) in enumerate(payloads)]
    blob = b"".join(frames)
    ends, off = [], 0
    for f in frames:
        off += len(f)
        ends.append(off)
    path = tmp_path / "records.bin"
    for cut in range(len(blob) + 1):
        path.write_bytes(blob[:cut])
        want = bisect.bisect_right(ends, cut)
        assert [r.seq for r in read_frames(path)] == list(range(want)), cut
        assert path.read_bytes() == blob[: ends[want - 1] if want else 0]


def test_payload_codecs_equal_reference_and_round_trip():
    texts, lem = _texts()
    ix, ref = _fresh(lem), _fresh(None, RefIncrementalIndexer)
    for x in (ix, ref):
        x.add_documents(texts)
        x.commit()
    assert fl_to_payload(ix.fl) == ref_fl_to_payload(ref.fl)
    back = fl_from_payload(json.loads(json.dumps(fl_to_payload(ix.fl))))
    assert back.lemmas == ix.fl.lemmas and back.fl_number == ix.fl.fl_number
    assert back.frequency == ix.fl.frequency
    assert (back.sw_count, back.fu_count) == (ix.fl.sw_count, ix.fl.fu_count)
    assert fl_from_payload(None) is None and fl_to_payload(None) is None
    docs = [ix.documents[i] for i in sorted(ix.documents)]
    ref_docs = [ref.documents[i] for i in sorted(ref.documents)]
    assert docs_to_payload(docs) == ref_docs_to_payload(ref_docs)


# ---------------------------------------------------------------------------
# segments: checkpoint / seal / prune
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls", [WriteAheadLog, RefWriteAheadLog], ids=["port", "ref"])
def test_checkpoint_seals_segment_and_prune_keeps_tail(tmp_path, cls):
    """The port's log, and a reference log reopened by the port."""
    wal = cls(tmp_path / "wal")
    wal.append("delete", {"doc_id": 0})
    wal.checkpoint(0, mutations=1)
    wal.append("delete", {"doc_id": 1})
    wal.checkpoint(1, mutations=2)
    wal.append("delete", {"doc_id": 2})
    assert sorted(p.name for p in (tmp_path / "wal").glob("wal_*")) == ["wal_0", "wal_1", "wal_2"]
    assert not (tmp_path / "wal" / "wal_2" / "manifest.json").exists()
    wal.prune(keep=1)
    assert sorted(p.name for p in (tmp_path / "wal").glob("wal_*")) == ["wal_1", "wal_2"]
    reopened = WriteAheadLog(tmp_path / "wal")
    assert reopened.append("delete", {"doc_id": 3}) == 5
    assert [r.seq for r in reopened.records()] == [2, 3, 4, 5]


def test_tail_after_snapshot_anchors_and_unanchored_is_empty(tmp_path):
    wal = WriteAheadLog(tmp_path / "wal")
    wal.append("delete", {"doc_id": 0})
    wal.checkpoint(0, mutations=1)
    wal.append("delete", {"doc_id": 1})
    wal.append("delete", {"doc_id": 2})
    assert [r.payload["doc_id"] for r in wal.tail_after_snapshot(0)] == [1, 2]
    assert wal.tail_after_snapshot(7) == []


# ---------------------------------------------------------------------------
# replay: restore + tail == the uncrashed live indexer
# ---------------------------------------------------------------------------


def _live_lineage(cls, root, texts, lem=None):
    live = _fresh(lem, cls)
    live.enable_wal(root)
    ids = live.add_documents(texts[:12])
    live.commit()
    live.snapshot(root)
    live.add_documents(texts[12:])
    live.commit()
    live.delete_document(ids[2])
    live.commit(refresh_fl=True)
    live.compact(memory_budget_bytes=None)
    return live, ids


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_log_written_by_either_package_replays_in_the_other(tmp_path, writer):
    texts, _ = _texts()
    port_live, ids = _live_lineage(IncrementalIndexer, tmp_path / "port", texts)
    ref_live, _ = _live_lineage(RefIncrementalIndexer, tmp_path / "ref", texts)
    for name in ("wal_0", "wal_1"):
        for f in sorted((tmp_path / "port" / "wal" / name).iterdir()):
            assert f.read_bytes() == (tmp_path / "ref" / "wal" / name / f.name).read_bytes(), f
    if writer == "port":
        recovered = RefIncrementalIndexer.restore(tmp_path / "port")
        eq, why = ref_index_sets_equal(recovered.index.to_index_set(), ref_live.index.to_index_set())
    else:
        recovered = IncrementalIndexer.restore(tmp_path / "ref")
        eq, why = index_sets_equal(recovered.index.to_index_set(), port_live.index.to_index_set())
    assert eq, why
    assert recovered.last_wal_replay["records"] == 5
    assert recovered.tombstones == port_live.tombstones
    assert recovered.documents.keys() == port_live.documents.keys()
    # the recovered indexer keeps logging into the same log
    recovered.delete_document(ids[5])
    assert recovered.wal.records()[-1].payload == {"doc_id": ids[5]}


def test_restore_without_replay_is_snapshot_only(tmp_path):
    texts, lem = _texts()
    live = _fresh(lem)
    live.enable_wal(tmp_path)
    live.add_documents(texts[:12])
    live.commit()
    live.snapshot(tmp_path)
    live.add_documents(texts[12:])
    live.commit()
    snap_only = IncrementalIndexer.restore(tmp_path, lemmatizer=lem, replay_wal=False)
    assert snap_only.last_wal_replay["records"] == 0 and len(snap_only.documents) == 12
    replayed = IncrementalIndexer.restore(tmp_path, lemmatizer=lem)
    assert len(replayed.documents) == len(texts)
    eq, why = index_sets_equal(replayed.index.to_index_set(), replayed.rebuild_index_set())
    assert eq, f"replayed state vs full rebuild: {why}"


def test_torn_wal_tail_recovers_acknowledged_prefix(tmp_path):
    texts, lem = _texts()
    live = _fresh(lem)
    wal = live.enable_wal(tmp_path)
    live.add_documents(texts[:12])
    live.commit()
    live.snapshot(tmp_path)
    ids = live.add_documents(texts[12:15])
    live.commit()
    tail_file = wal._segment / "records.bin"
    good = tail_file.read_bytes()
    tail_file.write_bytes(good + encode_frame(999, "delete", {"doc_id": 1})[:9])
    recovered = IncrementalIndexer.restore(tmp_path, lemmatizer=lem)
    _assert_same_index(recovered, live, "torn tail")
    assert tail_file.read_bytes() == good and set(ids) <= recovered.documents.keys()


@pytest.mark.parametrize("fraction", [0.0, 0.13, 0.5, 0.77, 1.0])
def test_tail_cut_anywhere_restores_the_acked_prefix_end_to_end(tmp_path, fraction):
    store = synthesize_corpus(n_docs=4, doc_len=12, vocab_size=40, seed=3)
    docs = list(store.documents)
    ix = IncrementalIndexer(sw_count=10, fu_count=20, max_distance=D, lemmatizer=store.lemmatizer)
    ix.enable_wal(tmp_path)
    ix.add_prelemmatized(docs[:3])
    ix.commit()
    ix.snapshot(tmp_path)
    ix.add_prelemmatized(docs[3:])
    ix.commit()
    ix.delete_document(docs[0].doc_id)
    ix.commit()
    tail = sorted(tmp_path.glob("wal/wal_*"))[-1] / "records.bin"
    original = tail.read_bytes()
    full = read_frames(tail, truncate=False)
    tail.write_bytes(original[: int(len(original) * fraction)])
    got = IncrementalIndexer.restore(tmp_path, lemmatizer=store.lemmatizer)
    surviving = read_frames(tail, truncate=False)
    assert [r.seq for r in surviving] == [r.seq for r in full[: len(surviving)]]
    expect = IncrementalIndexer.restore(tmp_path, lemmatizer=store.lemmatizer, replay_wal=False)
    assert replay(expect, surviving) == got.last_wal_replay["records"] == len(surviving)
    assert sorted(got.documents) == sorted(expect.documents)
    assert sorted(got.tombstones) == sorted(expect.tombstones)
    _assert_same_index(got, expect, f"cut at {fraction}")


def test_replay_is_suppressed_from_relogging(tmp_path):
    texts, lem = _texts(n=8)
    live = _fresh(lem)
    wal = live.enable_wal(tmp_path)
    live.add_documents(texts)
    live.commit()
    live.snapshot(tmp_path)
    live.add_documents(["extra doc one two"])
    live.commit()
    n_records = len(wal.records())
    recovered = IncrementalIndexer.restore(tmp_path, lemmatizer=lem)
    assert recovered.last_wal_replay["records"] == 2
    assert len(recovered.wal.records()) == n_records


def test_replay_helper_counts_only_mutations(tmp_path):
    texts, lem = _texts(n=8)
    live = _fresh(lem)
    wal = live.enable_wal(tmp_path)
    live.add_documents(texts)
    live.commit()
    fresh = _fresh(lem)
    assert replay(fresh, wal.records()) == 2  # add + commit; no anchors here
    _assert_same_index(fresh, live, "replay onto empty")


# ---------------------------------------------------------------------------
# fault points, driven by a stub injector
# ---------------------------------------------------------------------------


def test_wal_append_fault_loses_op_without_acknowledging(tmp_path):
    texts, lem = _texts(n=8)
    live = _fresh(lem)
    inj = _StubInjector("wal.append", at_call=2)
    live.enable_wal(tmp_path, injector=inj, shard=0)
    live.add_documents(texts)
    live.commit()
    victim = min(live.documents)
    with pytest.raises(_Crash):
        live.delete_document(victim)
    assert [r.rtype for r in live.wal.records()] == ["add", "commit"]
    assert victim in live.documents
    assert inj.calls[0] == ("wal.append", {"shard": 0})


def test_wal_torn_tail_fault_leaves_truncatable_partial_frame(tmp_path):
    texts, lem = _texts(n=8)
    live = _fresh(lem)
    inj = _StubInjector("wal.torn_tail", at_call=2)
    wal = live.enable_wal(tmp_path, injector=inj, shard=0)
    live.add_documents(texts)
    live.commit()
    tail_file = wal._segment / "records.bin"
    clean = tail_file.read_bytes()
    with pytest.raises(_Crash):
        live.delete_document(min(live.documents))
    assert len(tail_file.read_bytes()) > len(clean)  # real partial bytes
    assert [r.rtype for r in read_frames(tail_file)] == ["add", "commit"]
    assert tail_file.read_bytes() == clean
    assert ("wal.torn_tail", {"shard": 0, "path": tail_file}) in inj.calls


def test_service_wal_tags_shards_and_bulk_paths_name_bulk_ingest(tmp_path):
    from repro_torch.search import ShardedSearchService

    store = DocumentStore.from_texts(["who are you who", "to be or not to be", "what do you do"])
    svc = ShardedSearchService(store, n_shards=2, sw_count=5, fu_count=5, incremental=True,
                               device="cpu")
    inj = _StubInjector("never", at_call=0)
    logs = svc.enable_wal(tmp_path, injector=inj)
    assert [w.shard for w in logs] == [0, 1] and all(w.injector is inj for w in logs)
    svc.add_documents(["one more"])
    assert ("wal.append", {"shard": 1}) in inj.calls  # doc 3 routes to shard 1
    # the bulk paths build now: a bulk-built indexer's log is anchored by a
    # ``bulk_build`` record and armed with the injector it was given, and a
    # bulk-ingested service's logs tag their shards like a live one's
    ix, _ = IncrementalIndexer.bulk_build(["x y z", "who are you"], out_dir=tmp_path / "b",
                                          sw_count=5, fu_count=5, wal=True, injector=inj)
    assert [r.rtype for r in ix.wal.records()] == ["bulk_build"] and ix.wal.injector is inj
    bulk, _ = ShardedSearchService.bulk_ingest(store, tmp_path / "c", 2, 5, 5, device="cpu")
    logs = bulk.enable_wal(tmp_path / "c", injector=inj)
    assert [w.shard for w in logs] == [0, 1] and all(w.injector is inj for w in logs)
