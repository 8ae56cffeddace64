"""Fault-injected resilient serving (DESIGN.md §14; §5 serving under failure).

Host code only, a copy of the reference's module over the port's indexes:
the fault schedule ``FaultInjector.from_seed`` draws is the reference's
event for event, and the probe barrier decides which shards serve before
the surviving shards pack into the device program.

The paper keeps worst-case proximity queries answerable under pressure and
arXiv 2009.03679 extends that to response-time guarantees; this module
extends both to *failure* pressure.  It supplies the three pieces the
sharded serving stack (``search/distributed.py``) needs to survive real
operation instead of being *told* which shards are dead:

* :class:`FaultInjector` — a deterministic, seeded fault schedule fired at
  named injection points threaded through the service, frontend, arena and
  snapshot store (the §14 injection-point ABI): shard crashes/kills,
  straggler delays, physical snapshot bit-flips, device-arena pressure.
* :class:`HealthMonitor` — per-shard consecutive-error circuit breakers
  (CLOSED -> OPEN -> cooldown -> HALF_OPEN probe) plus MAD-based straggler
  detection (ported from ``runtime/fault_tolerance.StragglerMonitor``; the
  MAD rule now lives here as :func:`mad_stragglers`).
* :class:`ShardSupervisor` — the per-batch probe barrier: guarded shard
  touches with hedged retries and ``RestartPolicy`` backoff for transient
  failures, and automatic recovery of crashed shards by re-restoring the
  newest restorable §12.2 snapshot.  A recovered shard claims a fresh
  §12.5 restore epoch, so every generation-keyed cache (result, posting,
  arena) self-invalidates — no explicit flush.

Exactness contract (the §14 headline invariant, pinned by the
chaos differentials in ``tests/test_torch_resilience.py``): under ANY seeded
fault schedule every served response is either exact — fragment-identical
to the SE2.4 oracle over the full corpus — or explicitly flagged partial
(``QueryStats.shards_degraded`` / ``partial``) with exact ranking over the
shards it did cover; never silently wrong.  A crashed shard's recovery
restores index state that is ``index_sets_equal`` to an uncrashed replica
of the snapshotted state.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Sequence

import numpy as np

from ..core.postings import QueryStats
from ..runtime.clock import SystemClock
from ..runtime.fault_tolerance import RestartPolicy

__all__ = [
    "InjectedFault",
    "ShardCrash",
    "FaultEvent",
    "FaultInjector",
    "HealthMonitor",
    "ResiliencePolicy",
    "ShardSupervisor",
    "mad_stragglers",
]


class InjectedFault(RuntimeError):
    """Base class for every fault the §14 harness raises at an injection
    point — catching it is how a layer opts into graceful degradation
    (e.g. the arena treats it as device-memory pressure and refuses the
    round; fragments stay exact via the host fallback)."""


class ShardCrash(InjectedFault):
    """A shard failed a probe (§14 failure model).

    ``transient=True`` models a blip worth retrying under the
    ``RestartPolicy`` backoff; ``transient=False`` models a dead process —
    the supervisor goes straight to snapshot recovery.
    """

    def __init__(self, shard: int, transient: bool = False, point: str = "shard.search"):
        super().__init__(f"injected {'transient ' if transient else ''}crash: "
                         f"shard {shard} at {point}")
        self.shard = shard
        self.transient = transient
        self.point = point


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault (§14 injection-point ABI).

    Fires when the ``at_call``-th .. ``at_call + count - 1``-th arrival
    reaches ``point`` for ``shard`` (``None`` matches any arrival at the
    point).  ``kind`` is one of ``crash`` (transient :class:`ShardCrash`),
    ``kill`` (the shard stays down until recovered), ``delay`` (sleep
    ``delay_s`` — a straggler), ``bitflip`` (XOR one byte of a snapshot
    blob on disk so the §12.2 CRC machinery rejects it), ``overflow``
    (device-arena pressure).  ``param`` positions the bit-flip
    (offset fraction of the target blob).
    """

    point: str
    kind: str
    shard: int | None = None
    at_call: int = 0
    count: int = 1
    delay_s: float = 0.0
    param: float = 0.0


class FaultInjector:
    """Deterministic seeded fault scheduler (§14).

    One injector instance is threaded through every resilient layer; each
    layer calls :meth:`fire` at its named injection point and the injector
    consults the schedule by per-(point, shard) arrival count — no clocks,
    no randomness at fire time, so a given seed replays the identical fault
    sequence on every run (the property the chaos-differential harness and
    the CI gate depend on; its responses must stay exact-or-flagged).

    Injection points (the §14 ABI — see DESIGN.md for the full table):

    ====================  =======================  =========================
    point                 fired by                 kinds honored
    ====================  =======================  =========================
    ``shard.search``      supervisor shard probe   ``crash``, ``kill``
    ``shard.straggler``   supervisor shard probe   ``delay`` (attempt 0 only)
    ``shard.commit``      service ``commit`` loop  ``crash``, ``kill``
    ``store.load_snapshot``  ``store.load_snapshot``  ``bitflip``
    ``arena.acquire``     ``PostingArena``         ``overflow``
    ``ingest.lemmatize``  bulk ingest, per chunk   ``crash``, ``kill``
    ``ingest.spill``      bulk ingest, per chunk   ``crash``, ``kill``
    ``ingest.merge``      bulk ingest merge open   ``bitflip`` (on the
                                                   chunk's spill store)
    ``wal.append``        WAL frame append (§18)   ``crash``, ``kill``
    ``wal.torn_tail``     WAL frame append (§18)   ``crash``, ``kill``
    ``daemon.crash``      replicated daemon pump   ``kill``
    ====================  =======================  =========================

    The ``wal.*`` points (§18.1) fire with ``shard=`` the WAL's shard id:
    at ``wal.append`` the fault aborts BEFORE any byte is written (the
    operation is lost but was never acknowledged — no durability hole);
    at ``wal.torn_tail`` the log flushes a *partial* frame first, so the
    reader's truncate-at-last-valid-frame path is exercised against a
    real torn tail.  A ``kill`` at either point also marks the shard down
    (the process died mid-write), handing the shard to §14 recovery —
    which now replays the WAL tail.  ``daemon.crash`` (§18.3) fires with
    ``shard=`` the daemon replica id; ``kill`` raises without touching
    the shard down-set (replica liveness is the replicated daemon's own
    state, keyed separately from index shards).

    The ``ingest.*`` points (§17) fire with ``shard=`` set to the CHUNK id
    and, for ``ingest.merge``, ``path=`` to the chunk directory so a
    ``bitflip`` physically corrupts that spill's ``seg_*/postings.bin`` —
    the merge's CRC verification and the resume re-spill are exercised
    against real corruption, not mocks (``tests/test_torch_ingest.py``).

    The legacy ``dead_shards=`` simulation argument routes through
    :meth:`hold_down` — held shards fail their probes exactly like killed
    ones, so there is ONE failure path, not two.
    """

    def __init__(self, schedule: Sequence[FaultEvent] = (), seed: int = 0,
                 clock=None):
        self.seed = seed
        self.schedule = tuple(schedule)
        # §16.4: straggler delays sleep on THIS clock — under a virtual
        # clock an injected delay advances shared virtual time instantly,
        # so hedge/deadline tests see the exact scheduled latency without
        # a real sleep.
        self.clock = clock or SystemClock()
        self._arrivals: dict[tuple, int] = {}
        self.down: set[int] = set()  # killed shards (until revive())
        self._held: set[int] = set()  # legacy dead_shards= routing (scoped)
        self.log: list[dict] = []  # fired events, for reports and tests

    @classmethod
    def from_seed(cls, seed: int, n_shards: int, wal: bool = False) -> "FaultInjector":
        """Expand ``seed`` into a deterministic fault schedule (§14): one
        or two transient crashes, one permanent kill (exercises snapshot
        recovery), a straggler delay, and — seed-dependently — a snapshot
        bit-flip on the first recovery restore and a round of arena
        pressure.  With ``wal=True`` the schedule additionally draws §18
        durability faults — crashes mid-WAL-append, a torn-tail kill
        mid-commit, and a primary daemon kill — appended AFTER the base
        draws, so base schedules are identical with or without the flag.
        Equal seeds produce equal schedules, so CI replays are exact."""
        rng = np.random.default_rng(seed)
        events: list[FaultEvent] = []
        for _ in range(int(rng.integers(1, 3))):
            events.append(FaultEvent(
                "shard.search", "crash", shard=int(rng.integers(n_shards)),
                at_call=int(rng.integers(0, 8)), count=int(rng.integers(1, 3)),
            ))
        events.append(FaultEvent(
            "shard.search", "kill", shard=int(rng.integers(n_shards)),
            at_call=int(rng.integers(2, 10)),
        ))
        events.append(FaultEvent(
            "shard.straggler", "delay", shard=int(rng.integers(n_shards)),
            at_call=int(rng.integers(0, 6)), count=int(rng.integers(1, 3)),
            delay_s=float(rng.uniform(0.001, 0.005)),
        ))
        if rng.random() < 0.5:
            events.append(FaultEvent(
                "store.load_snapshot", "bitflip",
                at_call=0, param=float(rng.random()),
            ))
        if rng.random() < 0.5:
            events.append(FaultEvent(
                "arena.acquire", "overflow",
                at_call=int(rng.integers(0, 4)), count=int(rng.integers(1, 3)),
            ))
        if wal:
            events.append(FaultEvent(
                "wal.append", "crash", shard=int(rng.integers(n_shards)),
                at_call=int(rng.integers(0, 4)),
            ))
            if rng.random() < 0.7:
                events.append(FaultEvent(
                    "wal.torn_tail", "kill", shard=int(rng.integers(n_shards)),
                    at_call=int(rng.integers(0, 4)),
                ))
            events.append(FaultEvent(
                "daemon.crash", "kill", shard=0,
                at_call=int(rng.integers(1, 5)),
            ))
        return cls(schedule=events, seed=seed)

    # ---- legacy dead_shards routing ---------------------------------------

    def hold_down(self, shards) -> None:
        """Hold shards down for the current call scope — the single failure
        path the legacy ``dead_shards=`` argument routes through (§14);
        pair with :meth:`release`."""
        self._held.update(int(s) for s in shards)

    def release(self, shards) -> None:
        """Release shards held by :meth:`hold_down` (§14).  Killed shards
        (``kill`` events) are NOT released — only :meth:`revive` after a
        successful snapshot recovery does that."""
        self._held.difference_update(int(s) for s in shards)

    def revive(self, shard: int) -> None:
        """Mark a killed shard alive again — called by the supervisor after
        a successful §12.2 snapshot recovery, never spontaneously (§14)."""
        self.down.discard(int(shard))

    def is_down(self, shard: int) -> bool:
        """True while ``shard`` is killed or held down (§14 single failure
        path — exact degraded responses exclude exactly these shards)."""
        return shard in self.down or shard in self._held

    def is_held(self, shard: int) -> bool:
        """True while ``shard`` is held by the legacy ``dead_shards=``
        routing (§14): told-dead shards are excluded without health churn
        or recovery — the caller asked for the degraded fan-out."""
        return shard in self._held

    # ---- firing -----------------------------------------------------------

    def fire(self, point: str, shard: int | None = None, path=None,
             attempt: int = 0) -> None:
        """Arrive at injection point ``point`` (§14 ABI): consult the
        schedule by arrival count and perform whatever fault is due —
        raise :class:`ShardCrash` / :class:`InjectedFault`, sleep a
        straggler delay, or physically flip a snapshot byte under
        ``path``.  ``attempt`` > 0 marks a retry/hedge arrival: straggler
        delays fire only on the primary attempt (the retry models going to
        a replica).  No-op (beyond counting) when nothing is scheduled."""
        key = (point, shard)
        n = self._arrivals.get(key, 0)
        self._arrivals[key] = n + 1
        if point in ("shard.search", "shard.commit") and shard is not None \
                and self.is_down(shard):
            raise ShardCrash(shard, transient=False, point=point)
        for ev in self.schedule:
            if ev.point != point:
                continue
            if ev.shard is not None and ev.shard != shard:
                continue
            if not (ev.at_call <= n < ev.at_call + ev.count):
                continue
            if ev.kind == "crash":
                self._log(ev, shard=shard, arrival=n)
                raise ShardCrash(shard if shard is not None else -1,
                                 transient=True, point=point)
            if ev.kind == "kill":
                if point != "daemon.crash":
                    # daemon replicas are not index shards: their liveness
                    # lives in the replicated daemon, not the down-set
                    self.down.add(int(shard))
                self._log(ev, shard=shard, arrival=n)
                raise ShardCrash(shard, transient=False, point=point)
            if ev.kind == "delay" and attempt == 0:
                self._log(ev, shard=shard, arrival=n)
                self.clock.sleep(ev.delay_s)
            elif ev.kind == "bitflip" and path is not None:
                if self._bitflip(path, ev, n):
                    self._log(ev, shard=shard, arrival=n, path=str(path))
            elif ev.kind == "overflow":
                self._log(ev, shard=shard, arrival=n)
                raise InjectedFault(f"injected arena pressure at {point}")

    def _log(self, ev: FaultEvent, **info) -> None:
        self.log.append({"point": ev.point, "kind": ev.kind, **info})

    def _bitflip(self, path, ev: FaultEvent, arrival: int = 0) -> bool:
        """XOR one byte of a CRC-protected snapshot blob under ``path`` —
        a *physical* corruption, so detection exercises the real §12.2
        verify machinery (``open_segment_store`` CRC checks), not a mock.
        The byte offset advances with the arrival count: a repeated event
        (``count > 1``) corrupts a FRESH byte each time instead of XORing
        the same one back to its original value, so a snapshot hit twice
        stays corrupt (the unrecoverable-shard scenario)."""
        root = Path(path)
        targets = sorted(root.glob("seg_*/postings.bin"))
        targets = [t for t in targets if t.stat().st_size > 0]
        if not targets:
            return False
        target = targets[0]
        data = bytearray(target.read_bytes())
        off = (int(ev.param * len(data)) + arrival) % len(data)
        data[off] ^= 0xFF
        target.write_bytes(bytes(data))
        return True

    def metrics(self) -> dict:
        """Injector accounting for reports and the bench harness (§14):
        fired-event log length, killed/held shard sets — the ground truth
        the chaos harness compares degraded responses against (exactness
        of the degraded fan-out)."""
        return {
            "fired": len(self.log),
            "down": sorted(self.down),
            "held": sorted(self._held),
        }


def mad_stragglers(times: Sequence[Sequence[float]], mad_threshold: float = 5.0) -> list[int]:
    """MAD straggler rule (§14; ported from ``runtime/fault_tolerance``):
    a worker whose median duration sits ``mad_threshold`` MADs above the
    fleet median (floored at 5% of the fleet median so tiny absolute
    spreads don't flag everything) is a straggler.  Pure function of the
    duration windows — identical inputs give identical verdicts, which is
    what lets the runtime's training monitor and the serving
    :class:`HealthMonitor` share one implementation."""
    med_per = [float(np.median(t)) if len(t) else 0.0 for t in times]
    fleet = float(np.median([m for m in med_per if m > 0] or [0.0]))
    if fleet == 0:
        return []
    mad = float(np.median([abs(m - fleet) for m in med_per if m > 0] or [0.0]))
    thr = fleet + mad_threshold * max(mad, 0.05 * fleet)
    return [i for i, m in enumerate(med_per) if m > thr]


class HealthMonitor:
    """Per-shard health: error counters, latency windows, circuit breakers
    (§14 circuit-breaker thresholds; detection replaces the caller-supplied
    ``dead_shards`` list).

    Breaker lifecycle: CLOSED while probes succeed; ``breaker_errors``
    *consecutive* failures OPEN it (the shard is excluded without further
    probing — exact degraded responses, no error amplification); after
    ``cooldown_s`` the breaker is HALF_OPEN and exactly the next probe is
    allowed through — success closes it, failure re-opens the cooldown.
    Latency windows feed :func:`mad_stragglers`.
    """

    def __init__(
        self,
        n_shards: int,
        breaker_errors: int = 2,
        cooldown_s: float = 0.05,
        window: int = 20,
        mad_threshold: float = 5.0,
        clock=time.monotonic,
    ):
        self.n_shards = n_shards
        self.breaker_errors = max(1, int(breaker_errors))
        self.cooldown_s = float(cooldown_s)
        self.window = int(window)
        self.mad_threshold = float(mad_threshold)
        self._clock = clock
        self._consec = [0] * n_shards
        self._open_since: list[float | None] = [None] * n_shards
        self._times: list[list[float]] = [[] for _ in range(n_shards)]
        self.errors = [0] * n_shards
        self.probes = 0

    def record_success(self, shard: int, latency_s: float) -> None:
        """A probe of ``shard`` succeeded in ``latency_s`` — closes the
        breaker (a HALF_OPEN success), zeroes the consecutive-error count
        and feeds the straggler latency window (§14)."""
        self.probes += 1
        self._consec[shard] = 0
        self._open_since[shard] = None
        t = self._times[shard]
        t.append(float(latency_s))
        if len(t) > self.window:
            t.pop(0)

    def record_error(self, shard: int) -> bool:
        """A probe of ``shard`` failed; returns True when this failure
        trips the breaker OPEN (``breaker_errors`` consecutive failures —
        the §14 threshold).  A HALF_OPEN failure restarts the cooldown."""
        self.probes += 1
        self.errors[shard] += 1
        self._consec[shard] += 1
        if self._consec[shard] >= self.breaker_errors:
            was_closed = self._open_since[shard] is None
            self._open_since[shard] = self._clock()
            return was_closed
        return False

    def allows(self, shard: int) -> bool:
        """False while the breaker is OPEN and cooling down; True when
        CLOSED or HALF_OPEN (cooldown elapsed: one probe may pass — §14
        lifecycle)."""
        opened = self._open_since[shard]
        if opened is None:
            return True
        return (self._clock() - opened) >= self.cooldown_s

    def state(self, shard: int) -> str:
        """Breaker state name for dashboards: ``closed`` / ``open`` /
        ``half_open`` (§14 lifecycle)."""
        opened = self._open_since[shard]
        if opened is None:
            return "closed"
        return "half_open" if (self._clock() - opened) >= self.cooldown_s else "open"

    def note_recovered(self, shard: int) -> None:
        """Reset ``shard`` after a successful snapshot recovery — breaker
        CLOSED, consecutive errors zeroed (§14; cumulative ``errors`` stay,
        they are history not state)."""
        self._consec[shard] = 0
        self._open_since[shard] = None

    def stragglers(self) -> list[int]:
        """Shards whose probe latency violates the §14 MAD rule (see
        :func:`mad_stragglers` for the exact, deterministic criterion)."""
        return mad_stragglers(self._times, self.mad_threshold)

    def metrics(self) -> dict:
        """Health accounting for reports (§14): probe/error totals and the
        exact breaker state per shard."""
        return {
            "probes": self.probes,
            "errors": list(self.errors),
            "breaker_states": [self.state(i) for i in range(self.n_shards)],
        }


@dataclasses.dataclass
class ResiliencePolicy:
    """Knobs for the §14 failure path: retry backoff (the previously
    unwired ``runtime/fault_tolerance.RestartPolicy``), circuit-breaker
    thresholds, straggler hedging, and snapshot recovery.  Defaults are
    test-fast (zero backoff, 50 ms cooldown); production raises them.  The
    policy never affects *what* a response contains — only which shards
    serve it — so responses stay exact-or-flagged under any setting."""

    restart: RestartPolicy = dataclasses.field(
        default_factory=lambda: RestartPolicy(max_restarts=2, min_backoff_s=0.0)
    )
    breaker_errors: int = 2
    breaker_cooldown_s: float = 0.05
    hedge_after_s: float | None = None
    recover: bool = True
    snapshot_dir: str | Path | None = None


class ShardSupervisor:
    """The per-batch probe barrier of the resilient fan-out (§14).

    ``probe_live_shards`` touches every shard through its injection points
    before the batch packs into the single fused dispatch: held-down
    (legacy ``dead_shards=``) and breaker-OPEN shards are excluded up
    front; every other shard gets a guarded probe with ``RestartPolicy``
    backoff retries for transient crashes, optional hedging for
    stragglers, and — when a probe ultimately fails — automatic recovery
    by re-restoring the newest restorable §12.2 snapshot.  Exactness: the
    surviving shards still pack into ONE fused device dispatch, and a
    recovered shard claims a fresh §12.5 epoch so every generation-keyed
    cache self-invalidates (responses are exact over covered shards).
    """

    def __init__(
        self,
        service,
        policy: ResiliencePolicy | None = None,
        injector: FaultInjector | None = None,
        health: HealthMonitor | None = None,
        clock=None,
    ):
        self.service = service
        self.policy = policy or ResiliencePolicy()
        self.injector = injector or FaultInjector()
        # §16.4: one timeline for the whole barrier — probe latency
        # brackets, backoff sleeps, breaker cooldowns and injected
        # straggler delays all read/advance the same clock, so a virtual
        # clock makes the hedge decision an exact-tick comparison.
        self.clock = clock or SystemClock()
        if clock is not None:
            self.injector.clock = self.clock
        self.health = health or HealthMonitor(
            service.n_shards,
            breaker_errors=self.policy.breaker_errors,
            cooldown_s=self.policy.breaker_cooldown_s,
            clock=self.clock,
        )
        self.recoveries = 0
        # §18.2 accounting: total WAL records replayed across recoveries
        self.wal_records_replayed = 0
        self.last_excluded: frozenset[int] = frozenset()
        self._pool = None

    # ---- the probe barrier -------------------------------------------------

    def probe_live_shards(self, stats: QueryStats | None = None) -> list[int]:
        """Return the shard ids that will serve the next batch (§14).

        Recovery happens INSIDE the barrier, so by the time the caller
        resolves its live views the recovered indexer (fresh §12.5 epoch)
        is already in place — callers must resolve views and generation
        tokens AFTER this returns.  ``stats`` (batch-level) accumulates
        ``retries`` / ``hedges`` / ``recoveries`` and gets
        ``shards_degraded`` set to the exact excluded-shard count.
        """
        if stats is None:
            stats = QueryStats()
        live: list[int] = []
        excluded: list[int] = []
        for shard in range(self.service.n_shards):
            if self.injector.is_held(shard):
                # told-dead (legacy dead_shards=): excluded by request —
                # no health churn, no recovery, exact degraded fan-out
                excluded.append(shard)
                continue
            if not self.health.allows(shard):
                excluded.append(shard)  # breaker OPEN, still cooling down
                continue
            if self._probe(shard, stats):
                live.append(shard)
            else:
                excluded.append(shard)
        self.last_excluded = frozenset(excluded)
        stats.shards_degraded = len(excluded)
        return live

    def _probe(self, shard: int, stats: QueryStats) -> bool:
        attempt = 0
        while True:
            try:
                t0 = self.clock.now()
                self._touch(shard, attempt, stats)
                self.health.record_success(shard, self.clock.now() - t0)
                return True
            except ShardCrash as e:
                self.health.record_error(shard)
                if e.transient and attempt < self.policy.restart.max_restarts:
                    stats.retries += 1
                    self.clock.sleep(self.policy.restart.backoff(attempt))
                    attempt += 1
                    continue
                return self.recover_shard(shard, stats)

    def _touch(self, shard: int, attempt: int, stats: QueryStats) -> None:
        hedge = self.policy.hedge_after_s
        if hedge is None:
            self._touch_once(shard, attempt)
            return
        if getattr(self.clock, "virtual", False):
            # deterministic hedge path (§16.4): under a virtual clock the
            # primary probe runs to completion synchronously — an injected
            # straggler delay advances virtual time instead of sleeping —
            # and the hedge fires iff the primary's virtual elapsed exceeds
            # the threshold, exactly as the threaded race would decide it
            # (attempt+1 skips the injected delay, modelling the replica).
            # No threads, so the tick accounting is exact and replayable.
            t0 = self.clock.now()
            self._touch_once(shard, attempt)
            if self.clock.now() - t0 > hedge:
                stats.hedges += 1
                self._touch_once(shard, attempt + 1)
            return
        import concurrent.futures as cf

        pool = self._executor()
        first = pool.submit(self._touch_once, shard, attempt)
        try:
            first.result(timeout=hedge)
            return
        except cf.TimeoutError:
            pass
        except ShardCrash:
            raise
        # the primary probe is straggling: race a hedge (attempt+1 skips
        # the injected straggler delay — the model for "ask a replica");
        # first success wins, the loser finishes in the pool harmlessly
        stats.hedges += 1
        second = pool.submit(self._touch_once, shard, attempt + 1)
        futs = {first, second}
        err: BaseException | None = None
        while futs:
            done, futs = cf.wait(futs, return_when=cf.FIRST_COMPLETED)
            for f in done:
                try:
                    f.result()
                    return
                except BaseException as e:
                    err = e
        raise err

    def _touch_once(self, shard: int, attempt: int) -> None:
        self.injector.fire("shard.straggler", shard=shard, attempt=attempt)
        self.injector.fire("shard.search", shard=shard, attempt=attempt)
        # the real touch: resolving the live view walks the shard's segment
        # list — the in-process analogue of the per-shard health RPC
        _ = self.service.shards[shard].n_docs

    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=2)
        return self._pool

    # ---- commit guard ------------------------------------------------------

    def guard_commit(self, shard: int) -> None:
        """Injection point for a crash mid-``commit`` (§14): the service
        calls this before each shard's commit; an injected crash records
        the error (so the next batch's barrier attempts recovery) and
        propagates — leaving some shards committed and this one not, which
        is exactly the torn state the §12.5 epoch claim makes safe."""
        try:
            self.injector.fire("shard.commit", shard=shard)
        except ShardCrash:
            self.health.record_error(shard)
            raise

    # ---- recovery ----------------------------------------------------------

    def recover_shard(self, shard: int, stats: QueryStats | None = None) -> bool:
        """Re-restore ``shard`` from the newest restorable §12.2 snapshot,
        then replay its §18 WAL tail (post-snapshot commits included).

        Walks snapshot ids downward past corrupt candidates (a bit-flipped
        blob fails the store's CRC verify and raises ``StoreError`` — the
        harness corrupts disk bytes for real).  On success the shard's
        indexer is REPLACED: the restored one claims a fresh §12.5 epoch,
        so the service token changes and result/posting/arena caches keyed
        by pre-crash tokens can never serve again (exactness across the
        crash).  When the shard lineage has a write-ahead log, ``restore``
        replays every operation durably logged after the chosen snapshot
        (§18.2), so the recovered shard is ``index_sets_equal`` to an
        uncrashed replica — zero committed-write loss, and the recovered
        FL already agrees with the service's live FL-list.  The pre-§18
        lost-commit guard survives only as a WAL-less fallback: if the
        restored FL state still disagrees with the live FL (no WAL, or a
        truncated tail), the shard re-keys under the live FL so
        cross-shard lemma typing stays agreed — the §3 invariant sharded
        exactness depends on (approximate recovery: flagged, never
        silently wrong).  Returns False (shard stays degraded, responses
        stay flagged) when recovery is disabled, no snapshot root is
        known, or every candidate is corrupt."""
        pol = self.policy
        svc = self.service
        if not pol.recover or getattr(svc, "indexers", None) is None:
            return False
        root = pol.snapshot_dir or getattr(svc, "last_snapshot_dir", None)
        if root is None:
            return False
        from ..index.incremental import IncrementalIndexer
        from ..index.store import StoreError, fl_signature, latest_snapshot

        sdir = Path(root) / f"shard_{shard:02d}"
        sid = latest_snapshot(sdir)
        if sid is None:
            return False
        while sid >= 0:
            try:
                ix = IncrementalIndexer.restore(
                    sdir,
                    snapshot_id=sid,
                    lemmatizer=svc.lemmatizer,
                    injector=self.injector,
                )
            except StoreError:
                sid -= 1  # corrupt / missing candidate: walk to an older one
                continue
            if ix.wal is not None:
                ix.wal.shard = shard  # re-key the §14 wal.* arrival counters
            self.wal_records_replayed += ix.last_wal_replay["records"]
            # WAL-less fallback (pre-§18 mechanism): with a replayed tail
            # the FL signatures already agree and this is a no-op
            if svc.fl is not None and fl_signature(ix.fl) != fl_signature(svc.fl):
                ix.commit(fl=svc.fl)
            svc.indexers[shard] = ix
            self.injector.revive(shard)
            self.health.note_recovered(shard)
            self.recoveries += 1
            if stats is not None:
                stats.recoveries += 1
            return True
        return False

    def metrics(self) -> dict:
        """Supervisor accounting (§14): recoveries, last excluded set, and
        the health monitor's exact breaker states — surfaced by the
        service, the frontend ``metrics()`` and ``launch/serve.py``."""
        return {
            "recoveries": self.recoveries,
            "wal_records_replayed": self.wal_records_replayed,
            "last_excluded": sorted(self.last_excluded),
            "stragglers": self.health.stragglers(),
            **self.health.metrics(),
            **self.injector.metrics(),
        }
