"""The port's launcher (``python -m repro_torch.launch.serve``) against the
reference's (``python -m repro.launch.serve``) on the same flags.

Both run in this process with stdout captured: the reference's ``main``
with ``sys.argv`` set, the port's ``main(argv)`` with ``--device cpu``
added.  Standard output must be equal line for line once these are masked:
every millisecond figure and the docs/s rate (wall-clock timings); the
``warmup:`` line's program count (a jit compile count in the reference, a
count of programs run in the port); the straggler list of the
``resilience:`` line (the MAD rule over real probe latencies); and the
snapshot directory, which differs between the two runs.
"""

from __future__ import annotations

import contextlib
import io
import re
import sys
import threading

import pytest

from repro.launch import serve as ref_serve
from repro_torch.launch import serve as port_serve

_MASKS = (
    (re.compile(r"-?\d+(\.\d+)? ms\b"), "<ms> ms"),
    (re.compile(r"\d+ docs/s"), "<rate> docs/s"),
    (re.compile(r"precompiled \d+ device program"), "precompiled <n> device program"),
    (re.compile(r"stragglers=\[[\d, ]*\]"), "stragglers=<list>"),
)


def _mask(text: str, directory=None) -> list[str]:
    if directory is not None:
        text = text.replace(str(directory), "<dir>")
    for pattern, repl in _MASKS:
        text = pattern.sub(repl, text)
    return text.splitlines()


def _run_ref(argv, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", ["serve.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref_serve.main()
    return out.getvalue()


def _run_port(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_serve.main([*argv, "--device", "cpu"])
    return out.getvalue()


def _same_output(argv_ref, argv_port, monkeypatch, dir_ref=None, dir_port=None):
    want = _mask(_run_ref(argv_ref, monkeypatch), dir_ref)
    got = _mask(_run_port(argv_port), dir_port)
    assert got == want
    return got


def test_default(monkeypatch):
    lines = _same_output([], [], monkeypatch)
    assert any(ln.startswith("frontend: served 3 requests") for ln in lines)
    assert any(ln.startswith("arena: ") for ln in lines)


def test_explain_repeat(monkeypatch):
    argv = ["--explain", "--repeat", "2"]
    lines = _same_output(argv, argv, monkeypatch)
    assert sum("[CACHED]" in ln for ln in lines) == 3
    assert any("result-cache hit rate 0.50" in ln for ln in lines)


def test_snapshot_dir_cold_then_warm(monkeypatch, tmp_path):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    for phase in ("cold start", "warm start"):
        lines = _same_output(["--snapshot-dir", str(ref_dir)], ["--snapshot-dir", str(port_dir)],
                             monkeypatch, ref_dir, port_dir)
        assert any(ln.startswith(phase) for ln in lines), phase
    # a warm start with a conflicting build flag says it ignores it
    lines = _same_output(["--snapshot-dir", str(ref_dir), "--n-shards", "2"],
                         ["--snapshot-dir", str(port_dir), "--n-shards", "2"],
                         monkeypatch, ref_dir, port_dir)
    assert any(ln.startswith("note: warm start ignores build flags: --n-shards=2") for ln in lines)


def test_bulk_ingest(monkeypatch, tmp_path):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    lines = _same_output(["--bulk-ingest", "--snapshot-dir", str(ref_dir)],
                         ["--bulk-ingest", "--snapshot-dir", str(port_dir)],
                         monkeypatch, ref_dir, port_dir)
    assert lines[0].startswith("bulk ingest: corpus (150 docs) -> 4 shard stores")
    assert lines[1].startswith("bulk ingest: 152 docs / 4 shards")
    # the port warm-starts from the tree it published
    warm = _mask(_run_port(["--snapshot-dir", str(port_dir)]), port_dir)
    assert warm[0].startswith("warm start: restored 4 shards / 152 docs")
    assert [ln for ln in warm if ln.startswith("  doc")] == [ln for ln in lines if ln.startswith("  doc")]


def test_chaos_seed_with_snapshot_dir(monkeypatch, tmp_path):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    argv = ["--chaos-seed", "101", "--repeat", "3"]
    lines = _same_output([*argv, "--snapshot-dir", str(ref_dir)],
                         [*argv, "--snapshot-dir", str(port_dir)],
                         monkeypatch, ref_dir, port_dir)
    assert any(ln.startswith("chaos: seed 101 armed") for ln in lines)
    (res,) = [ln for ln in lines if ln.startswith("resilience:")]
    assert not res.startswith("resilience: 0 fault")


def test_kill_shard(monkeypatch):
    argv = ["--kill-shard", "1"]
    lines = _same_output(argv, argv, monkeypatch)
    assert lines[1].startswith("note: --kill-shard/--algorithm select the raw engine path")
    assert sum("DEGRADED (1 shard(s) down)" in ln for ln in lines) == 3


def test_connect_to_a_port_daemon():
    """Client mode against a port daemon started in this process: the wire
    responses print the daemon's documents, and ``--kill-primary`` fails the
    replicated daemon over."""
    from repro_torch.index import synthesize_corpus
    from repro_torch.search import ServingFrontend, ShardedSearchService
    from repro_torch.search.service import ReplicatedServiceDaemon, ServiceDaemon, serve_tcp

    store = synthesize_corpus(n_docs=150, seed=7)
    svc = ShardedSearchService(store, n_shards=4, sw_count=60, fu_count=150, device="cpu")
    fronts = [ServingFrontend(svc, device="cpu") for _ in range(2)]
    daemon = ReplicatedServiceDaemon([ServiceDaemon([f]) for f in fronts])
    server = serve_tcp(daemon)
    host, port = server.address
    try:
        queries = ["who are you who", "to be or not to be"]
        out = _run_port(["--connect", f"{host}:{port}", "--kill-primary", "--top-k", "5",
                         "--queries", *queries])
    finally:
        server.shutdown()
        server.server_close()
        daemon.stop()
    lines = out.splitlines()
    assert lines[0] == "kill_primary: replica 0 killed; successor takes over after the lease expires"
    want = ServingFrontend(svc, device="cpu").search_many(queries)
    got_docs = [int(ln.split()[1]) for ln in lines if ln.startswith("  doc")]
    assert got_docs == [d.doc_id for r in want for d in r.docs[:5]]
    assert lines[-1].startswith("daemon: primary=1 alive=[False, True], 2/2 completed, 1 failover(s)")


def test_main_parses_argv_and_defaults_to_cuda():
    """``--device`` defaults to ``cuda``; every other flag and default is
    the reference launcher's."""
    import argparse

    seen = {}

    def capture(self, args=None, namespace=None):
        seen[self.prog] = {a.dest: a.default for a in self._actions if a.dest != "help"}
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        for main, prog in ((ref_serve.main, "ref"), (lambda: port_serve.main([]), "port")):
            mp.setattr(sys, "argv", [prog])
            with pytest.raises(SystemExit):
                main()
    port_flags = dict(seen["port"])
    assert port_flags.pop("device") == "cuda"
    assert port_flags == seen["ref"]


def test_daemon_mode_starts_serves_and_stops(monkeypatch):
    """``--daemon --replicas 2``: the launcher prints its listening address,
    serves a client, and on an interrupt prints the daemon summary."""
    import time

    lines = []
    real_sleep = time.sleep

    class _Capture(io.StringIO):
        def write(self, s):
            lines.extend(ln for ln in s.splitlines() if ln)
            return super().write(s)

    def sleep(seconds):
        if seconds >= 3600:  # the launcher's idle loop: serve one client, then interrupt
            listening = next(ln for ln in lines if "listening on" in ln)
            host, port = listening.rsplit(" on ", 1)[1].split()[0].rsplit(":", 1)
            from repro_torch.search.service import request_over_tcp

            request_over_tcp((host, int(port)), {"op": "kill_primary"})
            reply = request_over_tcp((host, int(port)), {"query": "who are you who", "top_k": 5})
            assert reply["docs"] and reply["readmissions"] == 0
            raise KeyboardInterrupt
        real_sleep(seconds)

    monkeypatch.setattr(time, "sleep", sleep)
    out = _Capture()
    with contextlib.redirect_stdout(out):
        port_serve.main(["--daemon", "--port", "0", "--replicas", "2", "--device", "cpu"])
    assert any("2 replica(s) listening on 127.0.0.1:" in ln for ln in lines)
    assert any("python -m repro_torch.launch.serve --connect" in ln for ln in lines)
    assert lines[-1].startswith("daemon: primary=1 alive=[False, True], 1/1 completed, 1 failover(s)")
    assert threading.active_count() < 20
