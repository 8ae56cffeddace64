"""Serving launcher for the paper's search system (§5 end to end), on torch.

``python -m repro_torch.launch.serve --queries "who are you who" "to be or not to be"``

The reference package's launcher with the same flags, defaults and printed
lines, over the PyTorch/CUDA port, plus ``--device`` (``cuda`` unless the
caller asks for ``cpu``), which every service, restore, bulk ingest and
frontend it builds is given.  ``main(argv)`` parses ``argv`` (the process's
arguments when ``None``).

Builds a synthetic corpus, shards it, and serves queries — by default
through the deadline-aware :class:`~repro_torch.search.frontend.ServingFrontend`
(query planner + micro-batched fused dispatch + generation-keyed caches),
or through the raw per-algorithm engines with ``--no-frontend``.

Useful flags:

* ``--explain``       print each query's plan (lemma classes, §3 index-family
                      bindings, live posting-cost estimates) before serving;
* ``--deadline-ms``   per-request response-time budget (arXiv 2009.03679);
                      partial responses are flagged in the output;
* ``--repeat N``      serve the query list N times to show cache hit rates;
* ``--algorithm``     SE1/SE2.1–SE2.4 host loops or the fused device batch
                      (``--no-frontend`` path only);
* ``--kill-shard``    degraded fan-out demo (``--no-frontend`` path only);
* ``--snapshot-dir``  durable-index warm start (DESIGN.md §12 + §18): if the
                      directory holds a service snapshot, restore it, replay
                      each shard's write-ahead-log tail (post-snapshot ops
                      come back too — §18.2 zero data loss) and serve
                      straight from mmap'd disk pages — no corpus build, no
                      re-lemmatization; otherwise build the corpus once, arm
                      the §18 WAL and snapshot into the directory so the
                      NEXT run warm-starts (the crash-recovery loop);
* ``--daemon``        serve over the network (DESIGN.md §16): start the
                      continuous-batching :class:`ServiceDaemon` behind the
                      JSON-lines TCP transport and run until Ctrl-C;
                      ``--port`` picks the listen port (0 = ephemeral,
                      printed on startup); with ``--replicas N`` (N > 1) the
                      replicas run behind the §18.3 lease-based
                      :class:`ReplicatedServiceDaemon` — kill the primary
                      from a client (``--kill-primary``) and the successor
                      re-admits its in-flight requests exactly once;
* ``--connect``       be the client instead: send ``--queries`` to a
                      running ``--daemon`` at HOST:PORT and print the wire
                      responses (no corpus build on this side);
* ``--chaos-seed``    serve under a seeded fault schedule (DESIGN.md §14):
                      shard crashes/kills, straggler delays, snapshot
                      bit-flips fire deterministically at the §14 injection
                      points while the resilience layer detects, retries
                      and recovers.  Responses stay exact or flagged
                      DEGRADED; pair with ``--snapshot-dir`` so killed
                      shards can recover from durable snapshots, and with
                      ``--repeat`` to watch recovery happen mid-run.
"""

from __future__ import annotations

import argparse


def _print_response(resp, show_partial: bool = True) -> None:
    flags = []
    if resp.stats.cache_hits:
        flags.append("CACHED")
    if resp.stats.shards_degraded:
        flags.append(f"DEGRADED ({resp.stats.shards_degraded} shard(s) down)")
    if resp.stats.shed:
        flags.append("SHED")
    if show_partial and resp.stats.partial and not resp.stats.shards_degraded:
        flags.append(
            f"PARTIAL (skipped {resp.stats.skipped_subqueries} subqueries)"
        )
    # §14 failure-path counters (batch-level): only shown when non-zero, so
    # fault-free serving output is unchanged
    for name in ("retries", "hedges", "recoveries"):
        n = getattr(resp.stats, name)
        if n:
            flags.append(f"{name}={n}")
    tag = f"  [{', '.join(flags)}]" if flags else ""
    print(
        f"\nquery: {resp.query!r}  ({resp.n_subqueries} subqueries, "
        f"{resp.stats.postings_read} postings, "
        f"{resp.stats.elapsed_sec * 1000:.1f} ms){tag}"
    )
    for d in resp.docs:
        frags = ", ".join(f"[{f.start},{f.end}]" for f in d.fragments[:4])
        print(f"  doc {d.doc_id:5d} score={d.score:.4f} fragments: {frags}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", nargs="+", default=[
        "who are you who", "to be or not to be", "what do you do all day",
    ])
    ap.add_argument("--algorithm", default="se2.4",
                    choices=["se1", "se2.1", "se2.2", "se2.3", "se2.4", "fused"],
                    help="engine for the raw-engine path; passing a non-default "
                         "value implies --no-frontend (the frontend always "
                         "plans into the fused pipeline)")
    ap.add_argument("--n-docs", type=int, default=150)
    ap.add_argument("--n-shards", type=int, default=4)
    ap.add_argument("--sw-count", type=int, default=60)
    ap.add_argument("--fu-count", type=int, default=150)
    ap.add_argument("--max-distance", type=int, default=5)
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--kill-shard", type=int, action="append", default=[],
                    help="simulate dead shards; implies --no-frontend (the "
                         "frontend serves every live shard)")
    ap.add_argument("--no-frontend", action="store_true",
                    help="serve through the raw engines instead of the "
                         "planner + frontend layer")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request response-time budget (frontend mode)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="serve the query list this many times (shows the "
                         "result-cache hit rate in frontend mode)")
    ap.add_argument("--explain", action="store_true",
                    help="print each query's plan before serving")
    ap.add_argument("--snapshot-dir", default=None,
                    help="warm start from (or bootstrap) a durable index "
                         "snapshot directory (DESIGN.md §12)")
    ap.add_argument("--bulk-ingest", action="store_true",
                    help="cold-start through the §17 external-memory SPIMI "
                         "pipeline: shards spill+merge straight to disk "
                         "under --snapshot-dir (required) instead of "
                         "building in RAM, then serve from the published "
                         "snapshot — byte-identical to the in-RAM build")
    ap.add_argument("--bulk-workers", type=int, default=1,
                    help="spill worker processes for --bulk-ingest")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="serve under the §14 seeded fault schedule: "
                         "deterministic shard crashes/kills, stragglers and "
                         "snapshot bit-flips, detected and recovered by the "
                         "resilience layer (recovery needs --snapshot-dir)")
    ap.add_argument("--daemon", action="store_true",
                    help="serve over TCP through the §16 continuous-batching "
                         "daemon until interrupted (frontend mode only)")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP listen port for --daemon (0 = ephemeral, "
                         "printed on startup)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="daemon replicas behind --daemon (one shared "
                         "snapshot+WAL lineage).  With N > 1 the replicas "
                         "run behind the §18.3 primary lease: kill the "
                         "primary (--connect ... --kill-primary) and the "
                         "successor re-admits its in-flight requests "
                         "exactly once with byte-identical responses")
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="client mode: send --queries to a running --daemon "
                         "and print the wire responses")
    ap.add_argument("--kill-primary", action="store_true",
                    help="client mode: kill the serving daemon's primary "
                         "replica (§18.3 failover walkthrough) before "
                         "sending --queries")
    ap.add_argument("--arena-budget-mb", type=float, default=64.0,
                    help="device-resident posting arena byte budget "
                         "(DESIGN.md §13; 0 disables — frontend mode only): "
                         "hot posting columns upload once per index "
                         "generation and serving batches gather/pack on "
                         "device instead of in host numpy")
    ap.add_argument("--device", default="cuda",
                    help="torch device every service, restore, bulk ingest "
                         "and frontend serves on (cuda unless cpu is asked for)")
    args = ap.parse_args(argv)

    import time
    from pathlib import Path

    if args.connect:
        from ..search.service import request_over_tcp

        host, _, port = args.connect.rpartition(":")
        address = (host or "127.0.0.1", int(port))
        if args.kill_primary:
            out = request_over_tcp(address, {"op": "kill_primary"})
            if "error" in out:
                print(f"kill_primary: {out['error']}")
            else:
                print(f"kill_primary: replica {out['killed']} killed; "
                      f"successor takes over after the lease expires")
        for q in args.queries * args.repeat:
            payload = {"query": q, "top_k": args.top_k}
            if args.deadline_ms is not None:
                payload["deadline_ms"] = args.deadline_ms
            out = request_over_tcp(address, payload)
            flags = [f for f in ("partial", "shed") if out.get(f)]
            tag = f"  [{', '.join(f.upper() for f in flags)}]" if flags else ""
            print(f"\nquery: {out['query']!r}  "
                  f"(batch_size={out.get('batch_size')}, "
                  f"replica={out.get('replica')}, "
                  f"wait={1e3 * (out.get('queue_wait_sec') or 0):.1f} ms){tag}")
            for d in out["docs"]:
                frags = ", ".join(f"[{s},{e}]" for _, s, e in d["fragments"][:4])
                print(f"  doc {d['doc_id']:5d} score={d['score']:.4f} "
                      f"fragments: {frags}")
        m = request_over_tcp(address, {"op": "metrics"})["metrics"]
        if "failovers" in m:  # §18.3 replicated daemon
            print(f"\ndaemon: primary={m['primary']} alive={m['alive']}, "
                  f"{m['completed']}/{m['requests']} completed, "
                  f"{m['failovers']} failover(s), "
                  f"{m['readmitted']} re-admitted exactly-once")
        else:
            print(f"\ndaemon: {m['completed']} completed, {m['shed_queue']} shed, "
                  f"{m['batches']} batches, "
                  f"mean occupancy {m['mean_batch_occupancy']:.2f}")
        return

    from ..index.corpus import synthesize_corpus
    from ..search.distributed import ShardedSearchService

    svc = None
    if args.snapshot_dir and (Path(args.snapshot_dir) / "service.json").exists():
        t0 = time.perf_counter()
        svc = ShardedSearchService.restore(args.snapshot_dir, device=args.device)
        if args.algorithm != ap.get_default("algorithm"):
            svc.algorithm = args.algorithm  # explicit CLI choice wins
        else:
            args.algorithm = svc.algorithm  # else keep the stored engine
        n_docs = sum(len(ix.documents) for ix in svc.indexers)
        print(f"warm start: restored {svc.n_shards} shards / {n_docs} docs "
              f"from {args.snapshot_dir} in "
              f"{(time.perf_counter() - t0) * 1000:.0f} ms (no rebuild)")
        replayed = sum(ix.last_wal_replay["records"] for ix in svc.indexers)
        if any(ix.wal is None for ix in svc.indexers):
            # pre-§18 snapshot tree (no wal/ dirs): start logging now so the
            # NEXT crash is covered by the zero-data-loss contract
            svc.enable_wal(args.snapshot_dir)
        if replayed:
            replay_ms = 1e3 * sum(
                ix.last_wal_replay["seconds"] for ix in svc.indexers)
            print(f"wal: replayed {replayed} post-snapshot record(s) in "
                  f"{replay_ms:.0f} ms (§18.2 zero-data-loss)")
        # build flags describe a NEW corpus; a warm start serves the stored
        # one — surface any conflicting explicit flags instead of silently
        # dropping them (delete the snapshot dir to rebuild)
        ignored = [
            f"--{name.replace('_', '-')}={getattr(args, name)} "
            f"(snapshot has {stored})"
            for name, stored in (
                ("n_shards", svc.n_shards),
                ("sw_count", svc.sw_count),
                ("fu_count", svc.fu_count),
                ("max_distance", svc.max_distance),
                ("n_docs", n_docs),
            )
            # flag non-default (user typed it) AND disagreeing with the store
            if getattr(args, name) != ap.get_default(name)
            and getattr(args, name) != stored
        ]
        if ignored:
            print("note: warm start ignores build flags: " + ", ".join(ignored))
    if svc is None and args.bulk_ingest:
        if not args.snapshot_dir:
            ap.error("--bulk-ingest needs --snapshot-dir (the spill/merge "
                     "pipeline publishes a §12.2 snapshot tree)")
        print(f"bulk ingest: corpus ({args.n_docs} docs) -> "
              f"{args.n_shards} shard stores under {args.snapshot_dir}...")
        t0 = time.perf_counter()
        store = synthesize_corpus(n_docs=args.n_docs, seed=7)
        svc, stats = ShardedSearchService.bulk_ingest(
            store, args.snapshot_dir, n_shards=args.n_shards,
            sw_count=args.sw_count, fu_count=args.fu_count,
            max_distance=args.max_distance, algorithm=args.algorithm,
            workers=args.bulk_workers, device=args.device,
        )
        n_docs = sum(s.n_docs for s in stats)
        total_s = time.perf_counter() - t0
        print(f"bulk ingest: {n_docs} docs / {len(stats)} shards in "
              f"{total_s * 1000:.0f} ms "
              f"({sum(s.spill_bytes for s in stats) / 1024:.0f} KB spilled, "
              f"{n_docs / total_s:.0f} docs/s incl. corpus synthesis); "
              f"rerun to warm-start")
    if svc is None:
        print(f"building corpus ({args.n_docs} docs) and {args.n_shards} index shards...")
        t0 = time.perf_counter()
        store = synthesize_corpus(n_docs=args.n_docs, seed=7)
        svc = ShardedSearchService(
            store, n_shards=args.n_shards, sw_count=args.sw_count,
            fu_count=args.fu_count, max_distance=args.max_distance,
            algorithm=args.algorithm,
            # chaos mode wants incremental shards too: snapshot recovery
            # (the §14 failure path) only exists for IncrementalIndexer
            incremental=bool(args.snapshot_dir) or args.chaos_seed is not None,
            device=args.device,
        )
        build_ms = (time.perf_counter() - t0) * 1000
        if args.snapshot_dir:
            # arm the §18 WAL before the first snapshot so snap_0 carries a
            # checkpoint anchor and every later op is durably logged
            svc.enable_wal(args.snapshot_dir)
            svc.snapshot(args.snapshot_dir)
            print(f"cold start: built in {build_ms:.0f} ms, snapshotted to "
                  f"{args.snapshot_dir} (rerun to warm-start; §18 WAL armed)")

    if args.chaos_seed is not None:
        from ..search.resilience import FaultInjector, ResiliencePolicy

        injector = FaultInjector.from_seed(args.chaos_seed, n_shards=svc.n_shards)
        svc.enable_resilience(
            policy=ResiliencePolicy(snapshot_dir=args.snapshot_dir),
            injector=injector,
        )
        print(f"chaos: seed {args.chaos_seed} armed "
              f"{len(injector.schedule)} fault event(s) at the §14 "
              f"injection points"
              + ("" if args.snapshot_dir else
                 " (no --snapshot-dir: killed shards stay degraded)"))

    # --kill-shard / a non-default --algorithm only make sense on the raw
    # engine path: honor them there instead of silently ignoring them
    if args.kill_shard or args.algorithm != "se2.4":
        if not args.no_frontend:
            print("note: --kill-shard/--algorithm select the raw engine path "
                  "(frontend disabled for this run)")
        args.no_frontend = True

    if args.no_frontend:
        for q in args.queries * args.repeat:
            resp = svc.search(q, top_k=args.top_k, dead_shards=args.kill_shard)
            _print_response(resp, show_partial=False)
        _print_resilience(svc.resilience_metrics())
        return

    from ..search.frontend import SearchRequest, ServingFrontend

    deadline = args.deadline_ms / 1000.0 if args.deadline_ms is not None else None
    frontend = ServingFrontend(
        svc,
        default_deadline_sec=deadline,
        arena_budget_mb=args.arena_budget_mb,
        device=args.device,
    )
    # warm through the REAL serving path with the actual query slate and
    # top_k: shape budgets and top_k are static device-program arguments,
    # so this compiles exactly the programs the first served round reuses
    warm = frontend.warmup(queries=args.queries, top_k=args.top_k)
    print(f"warmup: precompiled {warm['programs']} device program(s) in "
          f"{warm['seconds'] * 1000:.0f} ms (cold p99 excludes jit compile)")

    if args.daemon:
        from ..search.service import (
            ReplicatedServiceDaemon,
            ServiceDaemon,
            serve_tcp,
        )

        fronts = [frontend] + [
            ServingFrontend(
                svc,
                default_deadline_sec=deadline,
                arena_budget_mb=args.arena_budget_mb,
                device=args.device,
            )
            for _ in range(max(1, args.replicas) - 1)
        ]
        if args.replicas > 1:
            # §18.3: N independent daemon replicas behind a lease-based
            # primary.  --kill-primary (client mode) crashes the primary;
            # the successor re-admits its in-flight tickets exactly once
            # under the original request ids.
            daemon = ReplicatedServiceDaemon([ServiceDaemon([f]) for f in fronts])
        else:
            daemon = ServiceDaemon(fronts)
        server = serve_tcp(daemon, port=args.port)
        host, port = server.address
        print(f"daemon: {len(fronts)} replica(s) listening on {host}:{port}"
              + (" (§18.3 lease-based failover armed)"
                 if args.replicas > 1 else ""))
        print(f"  try:  python -m repro_torch.launch.serve --connect {host}:{port} "
              f"--queries 'who are you who'"
              + (" --kill-primary" if args.replicas > 1 else ""))
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
            server.server_close()
            daemon.stop()
            m = daemon.metrics()
            if "failovers" in m:  # §18.3 replicated daemon
                print(f"\ndaemon: primary={m['primary']} alive={m['alive']}, "
                      f"{m['completed']}/{m['requests']} completed, "
                      f"{m['failovers']} failover(s), "
                      f"{m['readmitted']} re-admitted exactly-once")
            else:
                print(f"\ndaemon: {m['completed']} completed, "
                      f"{m['shed_queue']} shed, {m['batches']} batches, "
                      f"mean occupancy {m['mean_batch_occupancy']:.2f}")
        return
    if args.explain:
        for q in args.queries:
            print(frontend.planner.plan(q).explain())
    for _round in range(args.repeat):
        requests = [SearchRequest(q, top_k=args.top_k) for q in args.queries]
        for resp in frontend.search_many(requests):
            _print_response(resp)
    m = frontend.metrics()
    print(
        f"\nfrontend: served {m['served']} requests, "
        f"result-cache hit rate {m['result_cache_hit_rate']:.2f}, "
        f"posting-cache hit rate {m['posting_cache_hit_rate']:.2f} "
        f"({m['posting_cache_entries']} slices, "
        f"{m['posting_cache_bytes'] / 1024:.0f} KB), "
        f"{m['partial_responses']} partial responses"
    )
    if "arena_bytes" in m:
        print(
            f"arena: {m['arena_entries']} resident families, "
            f"{m['arena_bytes'] / (1 << 20):.1f} MB, "
            f"hit rate {m['arena_hit_rate']:.2f} "
            f"({m['arena_uploads']} uploads, "
            f"{m['arena_upload_bytes'] / (1 << 20):.1f} MB shipped once per "
            f"generation)"
        )
    _print_resilience(m.get("resilience", {}), sheds=m.get("sheds", 0))


def _print_resilience(rm: dict, sheds: int = 0) -> None:
    """Post-run §14 report: fired faults, breaker states, recoveries.
    Silent when the resilience layer is off (no --chaos-seed, no
    --kill-shard), so fault-free output is unchanged."""
    if not rm:
        return
    print(
        f"resilience: {rm['fired']} fault(s) fired, "
        f"{rm['recoveries']} snapshot recoveries, "
        f"{rm['errors']} probe errors, "
        f"breakers {rm['breaker_states']}, "
        f"down={rm['down']} stragglers={rm['stragglers']} sheds={sheds}"
    )


if __name__ == "__main__":
    main()
