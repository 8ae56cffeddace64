"""Continuous-batching serving daemon (DESIGN.md §16; §5 serving at scale).

Host code only (threads, sockets, the frontend's ``submit_many`` hook), a
copy of the reference's module over the port's ``ServingFrontend``: batches
are launched and read out on the thread that pumps the daemon, each readout
on the CUDA stream its program was queued on.

The service boundary between "a servable frontend" and "a served system":
:class:`ServiceDaemon` owns a FIFO request queue and N
:class:`~repro_torch.search.frontend.ServingFrontend` replicas over ONE index
source / snapshot lineage, and schedules **continuous micro-batches** —
a batch is formed from everything queued the instant a replica goes idle,
and new requests are admitted into the queue *while* batches are in
flight on the device (riding ``submit_many``'s deferred finalize, the
§15.2 pipeline hook), not in lockstep rounds.  Per-request deadlines
shrink by the observed queue wait before dispatch and map onto the
frontend's §5 partial-result machinery; queue overflow load-sheds at
admission (an immediate, explicitly flagged empty partial — never an
error, never cached).

Exactness contract (DESIGN.md §16.2, pinned by
``tests/test_torch_service.py``): for any
arrival schedule, the multiset of responses the daemon returns is
**byte-identical** to a serial ``ServingFrontend.search_many`` run over
the same requests with the same effective deadlines — batching, queueing
and replica routing change *when* work runs, never what a response
contains — and every response that is not complete is flagged
(``QueryStats.partial`` / ``shed`` / ``shards_degraded``).  All queue
timing reads an injectable clock (§16.4): under a virtual clock the whole
daemon — admission, deadline shrinking, retirement — replays a given
schedule deterministically with no real sleeps or sockets
(:meth:`ServiceDaemon.replay`), which is what lets tier-1 tests assert
exact tick boundaries.  A thin JSON-lines TCP transport
(:func:`serve_tcp`) exposes the same daemon over real sockets for
``launch/serve.py --daemon``.

Replicated failover (DESIGN.md §18.3): :class:`ReplicatedServiceDaemon`
runs N such daemons over one snapshot+WAL lineage behind a deterministic,
injectable-clock primary lease.  Requests carry client-visible idempotent
ids; when the primary is killed mid-flight, the successor re-admits its
unanswered tickets exactly once each, and — because replicas serve one
lineage deterministically — the re-admitted responses are byte-identical
to what the dead primary would have returned (pinned by
``tests/test_torch_service.py``): every acknowledged write/read is answered
exactly once, exact or flagged, never silently lost.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from collections import deque
from typing import Sequence

from ..core.postings import QueryStats
from ..runtime.clock import SystemClock
from .engine import QueryResponse
from .frontend import SearchRequest, ServingFrontend

__all__ = [
    "Ticket",
    "ServiceDaemon",
    "RequestHandle",
    "ReplicatedServiceDaemon",
    "response_to_wire",
    "serve_tcp",
    "TcpDaemonServer",
    "request_over_tcp",
]


class Ticket:
    """A queued request's handle (DESIGN.md §16.1).

    ``submit`` returns one immediately; :meth:`result` blocks until the
    daemon completes it (already-set for queue-shed tickets).  Carries the
    per-request accounting the load harness and the queue property tests
    assert on — ``queue_wait_sec`` / ``latency_sec`` read the daemon's
    injected clock (§16.4), so under a virtual clock they are exact tick
    differences, and ``effective_deadline_sec`` records the
    post-queue-wait budget actually handed to the frontend (the value a
    serial reference run must use to reproduce this response
    byte-identically).
    """

    __slots__ = (
        "request",
        "seq",
        "enqueued_at",
        "shed_at_queue",
        "effective_deadline_sec",
        "replica",
        "batch_size",
        "queue_wait_sec",
        "latency_sec",
        "_event",
        "_response",
    )

    def __init__(self, request: SearchRequest, seq: int, enqueued_at: float):
        self.request = request
        self.seq = seq
        self.enqueued_at = enqueued_at
        self.shed_at_queue = False
        self.effective_deadline_sec: float | None = request.deadline_sec
        self.replica: int | None = None
        self.batch_size = 0
        self.queue_wait_sec = 0.0
        self.latency_sec = 0.0
        self._event = threading.Event()
        self._response: QueryResponse | None = None

    def done(self) -> bool:
        """True once the response is set (§16.1) — never un-sets."""
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> QueryResponse:
        """Block until the daemon completes this ticket and return the
        response (§16.1).  Idempotent; raises ``TimeoutError`` only when a
        real ``timeout`` expires (virtual-clock runs complete tickets
        synchronously inside ``pump``/``replay``, so tests never wait)."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"ticket {self.seq} not completed in {timeout}s")
        return self._response

    def _complete(self, response: QueryResponse) -> None:
        self._response = response
        self._event.set()


class _Inflight:
    """One launched batch: the replica it occupies, its tickets in
    admission order, and the deferred finalize from ``submit_many``."""

    __slots__ = ("replica", "tickets", "finalize", "launched_at")

    def __init__(self, replica: int, tickets: list[Ticket], finalize, launched_at: float):
        self.replica = replica
        self.tickets = tickets
        self.finalize = finalize
        self.launched_at = launched_at


class ServiceDaemon:
    """Continuous-batching request scheduler over frontend replicas
    (DESIGN.md §16; the tentpole of the serving-at-scale layer).

    Scheduling loop (:meth:`pump`): (1) *launch* — while the queue is
    non-empty and a replica is idle, pop up to ``batch_limit`` tickets
    (FIFO: admission order is batch order), shrink each deadline by its
    queue wait, and ``submit_many`` the slate — the device program is
    enqueued and the replica marked busy, but nothing blocks; (2)
    *retire* — pop the OLDEST in-flight batch and call its finalize
    (the blocking device readout) **outside the daemon lock**, so new
    requests are admitted into the queue during the device wait.  That
    overlap is the continuous-batching invariant the occupancy metric
    pins: at saturation the mean batch occupancy exceeds 1 because
    arrivals during batch N's flight form batch N+1.

    Invariants (§16.2, property-tested): batches retire FIFO, tickets
    within a batch keep admission order, at most ONE batch is in flight
    per replica (``submit_many`` is not re-entrant per frontend), every
    queued ticket is eventually completed (no starvation — FIFO pop,
    no re-ordering), and responses are byte-identical to a serial
    ``search_many`` run with the same effective deadlines.  Queue
    overflow (``max_queue``) sheds at admission: an immediate empty
    response flagged ``stats.shed`` / ``stats.partial`` that never
    reaches a frontend and is never cached.

    Deterministic mode (§16.4): give every replica AND the daemon one
    shared virtual clock and drive the scheduler with :meth:`pump` /
    :meth:`drain` / :meth:`replay` — no threads, no sleeps, exact tick
    accounting.  Real mode: :meth:`start` runs the same ``pump`` loop on
    a daemon thread with condition-variable wakeups.
    """

    def __init__(
        self,
        replicas: ServingFrontend | Sequence[ServingFrontend],
        *,
        clock=None,
        max_queue: int = 256,
        batch_limit: int | None = None,
        poll_interval_s: float = 0.005,
    ):
        if isinstance(replicas, ServingFrontend):
            replicas = [replicas]
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("ServiceDaemon needs at least one frontend replica")
        self.clock = clock or SystemClock()
        self.max_queue = max(1, int(max_queue))
        # one slate == one frontend chunk == ONE fused dispatch: the cap
        # never exceeds any replica's max_batch (enforced again per launch)
        self.batch_limit = (
            min(r.max_batch for r in self.replicas)
            if batch_limit is None
            else max(1, int(batch_limit))
        )
        self.poll_interval_s = float(poll_interval_s)

        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._queue: deque[Ticket] = deque()
        self._inflight: deque[_Inflight] = deque()
        self._busy = [False] * len(self.replicas)
        self._rr = 0  # round-robin replica cursor
        self._thread: threading.Thread | None = None
        self._stopping = False

        self._seq = 0
        self._submitted = 0
        self._completed = 0
        self._shed_queue = 0
        self._batches = 0
        self._batched = 0
        self._queue_peak = 0
        self._occupancy: dict[int, int] = {}
        self._per_replica_batches = [0] * len(self.replicas)

    # ---- admission ---------------------------------------------------------

    def submit(
        self,
        request: SearchRequest | str,
        *,
        top_k: int = 10,
        deadline_sec: float | None = None,
    ) -> Ticket:
        """Admit one request (§16.1) and return its :class:`Ticket`.

        Admission control is exact and deterministic: if the queue holds
        ``max_queue`` tickets (or the daemon is stopping), the request is
        load-shed HERE — the ticket completes immediately with an empty
        response flagged ``stats.shed=1`` / ``stats.partial=True`` that
        never reaches a frontend and can never be cached.  Otherwise the
        ticket joins the FIFO queue stamped with the injected clock's now
        (§16.4) — its deadline budget starts aging from this instant.
        """
        req = (
            request
            if isinstance(request, SearchRequest)
            else SearchRequest(query=str(request), top_k=top_k, deadline_sec=deadline_sec)
        )
        with self._work:
            ticket = Ticket(req, self._seq, self.clock.now())
            self._seq += 1
            self._submitted += 1
            if self._stopping or len(self._queue) >= self.max_queue:
                self._shed_queue += 1
                ticket.shed_at_queue = True
                ticket._complete(self._shed_response(req))
                return ticket
            self._queue.append(ticket)
            self._queue_peak = max(self._queue_peak, len(self._queue))
            self._work.notify_all()
        return ticket

    def _shed_response(self, req: SearchRequest) -> QueryResponse:
        stats = QueryStats()
        stats.shed = 1
        stats.partial = True  # empty-by-admission: flagged, never cached
        stats.deadline_sec = 0.0 if req.deadline_sec is None else float(req.deadline_sec)
        return QueryResponse(query=req.query, docs=[], stats=stats)

    # ---- the scheduler -----------------------------------------------------

    def _next_idle(self) -> int | None:
        n = len(self.replicas)
        for k in range(n):
            i = (self._rr + k) % n
            if not self._busy[i]:
                self._rr = (i + 1) % n
                return i
        return None

    def _launch_ready(self) -> bool:
        launched = False
        while True:
            with self._lock:
                if not self._queue:
                    return launched
                idx = self._next_idle()
                if idx is None:
                    return launched
                replica = self.replicas[idx]
                cap = max(1, min(self.batch_limit, replica.max_batch))
                take = min(cap, len(self._queue))
                tickets = [self._queue.popleft() for _ in range(take)]
                self._busy[idx] = True
            # deadline shrinking + submit happen OUTSIDE the lock: planning
            # and the device enqueue must not block concurrent admission
            now = self.clock.now()
            slate: list[SearchRequest] = []
            for t in tickets:
                wait = max(0.0, now - t.enqueued_at)
                t.queue_wait_sec = wait
                d = t.request.deadline_sec
                eff = None if d is None else max(0.0, float(d) - wait)
                t.effective_deadline_sec = eff
                t.replica = idx
                t.batch_size = len(tickets)
                slate.append(
                    SearchRequest(
                        query=t.request.query,
                        top_k=t.request.top_k,
                        deadline_sec=eff,
                    )
                )
            finalize = replica.submit_many(slate)
            with self._lock:
                self._inflight.append(_Inflight(idx, tickets, finalize, now))
                self._batches += 1
                self._batched += len(tickets)
                self._per_replica_batches[idx] += 1
                self._occupancy[len(tickets)] = self._occupancy.get(len(tickets), 0) + 1
            launched = True

    def _retire_oldest(self) -> bool:
        with self._lock:
            if not self._inflight:
                return False
            inf = self._inflight.popleft()
        # the blocking device readout runs OUTSIDE the lock: this is the
        # window in which submit() keeps admitting — continuous batching
        responses = inf.finalize()
        now = self.clock.now()
        with self._work:
            for ticket, resp in zip(inf.tickets, responses):
                ticket.latency_sec = max(0.0, now - ticket.enqueued_at)
                ticket._complete(resp)
            self._busy[inf.replica] = False
            self._completed += len(inf.tickets)
            self._work.notify_all()
        return True

    def pump(self) -> bool:
        """One deterministic scheduler step (§16.2): launch batches onto
        every idle replica, then retire the oldest in-flight batch
        (blocking readout).  Returns True when any work was done.  This is
        the ONLY scheduling logic — the daemon thread, :meth:`drain` and
        :meth:`replay` all run exactly this step, so threaded and
        virtual-clock runs make identical batching decisions for identical
        queue states."""
        launched = self._launch_ready()
        retired = self._retire_oldest()
        return launched or retired

    def drain(self) -> None:
        """Run :meth:`pump` until the queue and every in-flight batch are
        empty (§16.2) — the in-process deterministic transport: submit
        tickets, ``drain()``, read exact results from the tickets.  No
        threads or sleeps involved."""
        while True:
            with self._lock:
                if not self._queue and not self._inflight:
                    return
            self.pump()

    def replay(self, schedule, *, service_time_sec: float = 0.0) -> list[Ticket]:
        """Deterministically replay an open-loop arrival ``schedule`` on
        the virtual clock (§16.4) and return the tickets in arrival order.

        ``schedule`` is an iterable of ``(arrival_time_sec, request)``
        pairs (request: ``str`` or :class:`SearchRequest`); the clock is
        advanced to each event in time order.  ``service_time_sec`` models
        how long a launched batch occupies its replica in *virtual* time:
        arrivals that land before a batch's virtual completion queue up
        behind it and form the next batch — exactly the
        admission-during-flight behavior the real daemon shows under load,
        but with no threads, so a given (schedule, service time) pair
        yields an identical batch sequence, identical effective deadlines
        and identical responses on every run.  Requires a virtual clock.
        """
        if not getattr(self.clock, "virtual", False):
            raise ValueError("replay() requires a virtual clock (ManualClock)")
        events = sorted(
            ((float(t), k, req) for k, (t, req) in enumerate(schedule)),
            key=lambda e: (e[0], e[1]),
        )
        svc = max(0.0, float(service_time_sec))
        tickets: list[Ticket] = []
        i = 0
        while True:
            with self._lock:
                oldest = self._inflight[0].launched_at if self._inflight else None
                queued = bool(self._queue)
            if i >= len(events) and oldest is None and not queued:
                return tickets
            completion = None if oldest is None else oldest + svc
            arrival = events[i][0] if i < len(events) else None
            if arrival is not None and (completion is None or arrival <= completion):
                self.clock.advance(max(0.0, arrival - self.clock.peek()))
                tickets.append(self.submit(events[i][2]))
                i += 1
                self._launch_ready()
            elif completion is not None:
                self.clock.advance(max(0.0, completion - self.clock.peek()))
                self._retire_oldest()
                self._launch_ready()
            else:  # queued work, nothing in flight, no arrivals left
                self._launch_ready()

    # ---- threaded (real-time) mode ----------------------------------------

    def start(self) -> "ServiceDaemon":
        """Start the daemon thread (§16.3): the same :meth:`pump` loop,
        woken by condition variable on submit and batch retirement, so
        real-socket serving batches identically to the deterministic
        runs.  Idempotent; returns self."""
        with self._work:
            if self._thread is not None:
                return self
            self._stopping = False
            self._thread = threading.Thread(
                target=self._run, name="service-daemon", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            with self._work:
                while not self._stopping and not self._queue and not self._inflight:
                    self._work.wait(timeout=self.poll_interval_s)
                if self._stopping and not self._queue and not self._inflight:
                    return
            self.pump()

    def stop(self, drain: bool = True) -> None:
        """Stop serving (§16.3).  New submits shed immediately from this
        point.  ``drain=True`` completes everything already queued or in
        flight first (every admitted ticket still gets its exact
        response); ``drain=False`` sheds the queue (flagged, like any
        admission shed) and only retires batches already on the device.
        Joins the daemon thread if one is running; also usable in
        deterministic mode (no thread), where it drains inline."""
        with self._work:
            self._stopping = True
            if not drain:
                while self._queue:
                    t = self._queue.popleft()
                    self._shed_queue += 1
                    t.shed_at_queue = True
                    t._complete(self._shed_response(t.request))
            self._work.notify_all()
            thread = self._thread
            self._thread = None
        if thread is not None:
            thread.join(timeout=60.0)
        else:
            self.drain()

    # ---- accounting --------------------------------------------------------

    def metrics(self) -> dict:
        """Daemon counters for the load harness and CI gates (§16.5):
        admission totals, queue-shed count, queue depth peak, batch count
        and the exact batch-occupancy histogram — ``mean_batch_occupancy``
        > 1 is the pinned evidence that batches formed from arrivals
        admitted while earlier batches were in flight (continuous
        batching), and ``submitted == completed + shed_queue + queued +
        inflight`` is the no-lost-ticket conservation the property tests
        assert."""
        with self._lock:
            inflight_reqs = sum(len(b.tickets) for b in self._inflight)
            batches = self._batches
            return {
                "replicas": len(self.replicas),
                "batch_limit": self.batch_limit,
                "max_queue": self.max_queue,
                "submitted": self._submitted,
                "completed": self._completed,
                "shed_queue": self._shed_queue,
                "queued": len(self._queue),
                "inflight_requests": inflight_reqs,
                "queue_peak": self._queue_peak,
                "batches": batches,
                "batched_requests": self._batched,
                "mean_batch_occupancy": (self._batched / batches) if batches else 0.0,
                "batch_occupancy_hist": {
                    str(k): v for k, v in sorted(self._occupancy.items())
                },
                "per_replica_batches": list(self._per_replica_batches),
            }


# ---- replicated daemon failover (DESIGN.md §18.3) --------------------------


class RequestHandle:
    """A client's durable handle on one idempotent request (§18.3).

    Keyed by a client-visible ``request_id``: re-submitting the same id —
    whether a client retry or the successor re-admitting a killed
    primary's in-flight work — always resolves to this ONE handle, and
    :meth:`result` always returns the ONE recorded response (byte-identical
    on every read; the §18.3 exactly-once contract).  ``ticket`` tracks
    the currently-assigned underlying :class:`Ticket` (it changes exactly
    once per failover re-admission); completions from a superseded ticket
    of a dead primary are accepted only while it is still current, so a
    request is never answered twice.
    """

    __slots__ = ("request_id", "request", "ticket", "readmissions", "_event", "_response")

    def __init__(self, request_id: str, request: SearchRequest):
        self.request_id = request_id
        self.request = request
        self.ticket: Ticket | None = None
        self.readmissions = 0
        self._event = threading.Event()
        self._response: QueryResponse | None = None

    def done(self) -> bool:
        """True once the one-and-only response is recorded (§18.3)."""
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> QueryResponse:
        """Block until the response is recorded and return it — the same
        object on every call, across client retries and primary failovers
        (§18.3 idempotency).  Raises ``TimeoutError`` on a real expiry."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.request_id!r} not completed in {timeout}s")
        return self._response

    def _record(self, response: QueryResponse) -> None:
        self._response = response
        self._event.set()


class ReplicatedServiceDaemon:
    """N daemon replicas over ONE snapshot+WAL lineage with deterministic
    primary failover (DESIGN.md §18.3).

    One member of ``daemons`` is the **primary** — the only replica that
    admits and schedules work.  Liveness is lease-based and entirely
    injectable-clock driven (no real sleeps): a killed primary's lease
    expires ``lease_sec`` after its recorded death on the shared clock,
    at which point the next live replica takes over and **re-admits** the
    dead primary's unanswered requests exactly once each, under their
    original client-visible request ids.  Because every replica serves
    the same index lineage and the frontends are deterministic, a
    re-admitted request's response is byte-identical to what the dead
    primary would have returned — pinned by the §18.3 chaos tests — so
    clients cannot observe which replica answered; duplicates (client
    retries of an id) resolve to the already-recorded response without
    recomputation.  Exactness: every response is the exact
    single-frontend response or explicitly flagged (shed), never silently
    wrong, and every acknowledged (admitted) request gets exactly one
    response.

    The §14 ``daemon.crash`` fault point fires once per :meth:`pump` with
    ``shard=`` the primary's index; a scheduled ``kill`` crashes the
    primary mid-flight.  Deterministic mode: deterministic underlying
    daemons + a shared virtual clock, driven by :meth:`pump` /
    :meth:`drain` (drain expires the lease by advancing the virtual
    clock when work is stranded on a dead primary).  Threaded mode:
    :meth:`start` runs the live daemons' threads plus a failover monitor.
    """

    def __init__(
        self,
        daemons: Sequence[ServiceDaemon],
        *,
        clock=None,
        lease_sec: float = 0.05,
        injector=None,
        poll_interval_s: float = 0.005,
    ):
        self.daemons = list(daemons)
        if not self.daemons:
            raise ValueError("ReplicatedServiceDaemon needs at least one daemon")
        self.clock = clock or self.daemons[0].clock
        self.lease_sec = float(lease_sec)
        self.injector = injector
        self.poll_interval_s = float(poll_interval_s)
        self._lock = threading.RLock()
        self.alive = [True] * len(self.daemons)
        self._primary = 0
        self._death_at: float | None = None
        self._registry: dict[str, RequestHandle] = {}
        self._auto = 0
        self._failovers = 0
        self._readmitted = 0
        self._dedup_hits = 0
        self._monitor: threading.Thread | None = None
        self._stopping = False

    # -- clock/lease ---------------------------------------------------------

    def _now(self) -> float:
        # reading the lease must not advance a virtual clock (peek vs now)
        if getattr(self.clock, "virtual", False):
            return self.clock.peek()
        return self.clock.now()

    @property
    def primary(self) -> int | None:
        """Index of the current primary, or None when every replica is
        dead (§18.3; reads do not advance the lease clock)."""
        with self._lock:
            return self._primary if self.alive[self._primary] else None

    # -- admission (idempotent request ids) ----------------------------------

    def submit(
        self,
        request: SearchRequest | str,
        *,
        top_k: int = 10,
        deadline_sec: float | None = None,
        request_id: str | None = None,
    ) -> RequestHandle:
        """Admit one idempotent request (§18.3) and return its
        :class:`RequestHandle`.  A known ``request_id`` returns the
        existing handle — the recorded response is served as-is
        (byte-identical, no recomputation); a fresh id is assigned to the
        current primary.  With every replica dead the request completes
        immediately as an explicitly flagged shed (never an error, never
        silently dropped)."""
        req = (
            request
            if isinstance(request, SearchRequest)
            else SearchRequest(query=str(request), top_k=top_k, deadline_sec=deadline_sec)
        )
        with self._lock:
            if request_id is None:
                request_id = f"auto-{self._auto}"
                self._auto += 1
            handle = self._registry.get(request_id)
            if handle is not None:
                self._dedup_hits += 1
                return handle
            self._maybe_failover()
            handle = RequestHandle(request_id, req)
            self._registry[request_id] = handle
            self._assign(handle)
        return handle

    def _assign(self, handle: RequestHandle) -> None:
        if self.alive[self._primary]:
            handle.ticket = self.daemons[self._primary].submit(handle.request)
            return
        if any(self.alive):
            # arrived inside the dead primary's lease window: park it —
            # failover admits it to the successor (never shed while a
            # live replica remains)
            return
        handle._record(self._shed_response(handle.request))

    def _shed_response(self, req: SearchRequest) -> QueryResponse:
        stats = QueryStats()
        stats.shed = 1
        stats.partial = True  # no live primary: flagged, never silently lost
        stats.deadline_sec = 0.0 if req.deadline_sec is None else float(req.deadline_sec)
        return QueryResponse(query=req.query, docs=[], stats=stats)

    # -- failure / failover --------------------------------------------------

    def crash_primary(self) -> int | None:
        """Kill the current primary (§18.3): fault-point targets and the
        ``kill_primary`` wire op land here.  Its queued and in-flight
        requests stay unanswered until the lease expires and the successor
        re-admits them (exactly once each).  Returns the killed index, or
        None if everything is already dead."""
        with self._lock:
            if not self.alive[self._primary]:
                return None
            killed = self._primary
            self.alive[killed] = False
            self._death_at = self._now()
            return killed

    def _maybe_fire_crash(self) -> None:
        if self.injector is None:
            return
        from .resilience import ShardCrash

        try:
            self.injector.fire("daemon.crash", shard=self._primary)
        except ShardCrash:
            self.crash_primary()

    def _maybe_failover(self) -> None:
        if self.alive[self._primary] or self._death_at is None:
            return
        if self._now() < self._death_at + self.lease_sec:
            return  # the dead primary's lease has not expired yet
        n = len(self.daemons)
        successor = None
        for k in range(1, n + 1):
            i = (self._primary + k) % n
            if self.alive[i]:
                successor = i
                break
        if successor is None:
            # nobody left: answer stranded requests as flagged sheds
            for handle in self._registry.values():
                if not handle.done():
                    handle._record(self._shed_response(handle.request))
            self._death_at = None
            return
        self._primary = successor
        self._death_at = None
        self._failovers += 1
        if self._monitor is not None:
            self.daemons[successor].start()
        # exactly-once re-admission: every unanswered request of the dead
        # primary re-enters the successor's queue under its ORIGINAL id;
        # the superseded ticket is dropped, so even if the dead process
        # somehow finished it, only one response is ever recorded
        for handle in self._registry.values():
            if handle.done():
                continue
            old_ticket = handle.ticket
            if old_ticket is not None and old_ticket.done():
                # completed before the crash reached it: accept the exact
                # response instead of recomputing
                self._record(handle, old_ticket)
                continue
            if old_ticket is None:
                # parked during the lease window: this is its FIRST
                # admission, not a re-admission
                handle.ticket = self.daemons[successor].submit(handle.request)
                continue
            handle.readmissions += 1
            self._readmitted += 1
            handle.ticket = self.daemons[successor].submit(handle.request)

    def _record(self, handle: RequestHandle, ticket: Ticket) -> None:
        if handle.ticket is ticket and not handle.done():
            handle._record(ticket._response)

    def _propagate(self) -> None:
        for handle in self._registry.values():
            t = handle.ticket
            if t is not None and t.done() and not handle.done():
                self._record(handle, t)

    # -- deterministic runs -------------------------------------------------

    def pump(self) -> bool:
        """One deterministic replicated-scheduler step (§18.3): fire the
        ``daemon.crash`` fault point, run lease-based failover if due,
        pump the live primary, and record completed responses.  Returns
        True when any underlying work was done."""
        with self._lock:
            self._maybe_fire_crash()
            self._maybe_failover()
            p = self._primary if self.alive[self._primary] else None
        worked = self.daemons[p].pump() if p is not None else False
        with self._lock:
            self._propagate()
        return worked

    def drain(self) -> None:
        """Run :meth:`pump` until every registered request has its one
        response (§18.3).  When work is stranded on a dead primary whose
        lease has not expired, a virtual clock is advanced by
        ``lease_sec`` (the deterministic analogue of waiting the lease
        out); real clocks just keep polling."""
        import time as _time

        while True:
            with self._lock:
                pending = [h for h in self._registry.values() if not h.done()]
            if not pending:
                return
            worked = self.pump()
            if worked:
                continue
            with self._lock:
                stranded = (not self.alive[self._primary]) and self._death_at is not None
            if stranded and getattr(self.clock, "virtual", False):
                self.clock.advance(self.lease_sec)
            elif not getattr(self.clock, "virtual", False):
                _time.sleep(self.poll_interval_s)

    # -- threaded (real-time) mode -------------------------------------------

    def start(self) -> "ReplicatedServiceDaemon":
        """Threaded mode (§18.3): start the primary's daemon thread plus a
        failover monitor that watches the lease and re-admits after a
        kill; successors start on takeover.  Idempotent; returns self."""
        with self._lock:
            if self._monitor is not None:
                return self
            self._stopping = False
            self.daemons[self._primary].start()
            self._monitor = threading.Thread(
                target=self._run_monitor, name="daemon-failover-monitor", daemon=True
            )
            self._monitor.start()
        return self

    def _run_monitor(self) -> None:
        import time as _time

        while not self._stopping:
            with self._lock:
                self._maybe_failover()
                self._propagate()
            _time.sleep(self.poll_interval_s)

    def stop(self, drain: bool = True) -> None:
        """Stop the monitor and every live daemon (§18.3); dead replicas
        are left alone (their queues were re-admitted at failover)."""
        with self._lock:
            self._stopping = True
            monitor = self._monitor
            self._monitor = None
        if monitor is not None:
            monitor.join(timeout=10.0)
        for i, daemon in enumerate(self.daemons):
            if self.alive[i]:
                daemon.stop(drain=drain)
        with self._lock:
            self._propagate()

    # -- accounting ----------------------------------------------------------

    def metrics(self) -> dict:
        """Replication counters for the chaos harness and wire clients
        (§18.3): primary index, per-replica liveness, failover count,
        exactly-once re-admissions, idempotent dedup hits, and the live
        primary's scheduler metrics."""
        with self._lock:
            p = self._primary if self.alive[self._primary] else None
            return {
                "replicas": len(self.daemons),
                "primary": p,
                "alive": list(self.alive),
                "failovers": self._failovers,
                "readmitted": self._readmitted,
                "dedup_hits": self._dedup_hits,
                "requests": len(self._registry),
                "completed": sum(1 for h in self._registry.values() if h.done()),
                "primary_metrics": None if p is None else self.daemons[p].metrics(),
            }


# ---- wire format (JSON lines over TCP) ------------------------------------


def response_to_wire(resp: QueryResponse, ticket: Ticket | None = None) -> dict:
    """Encode one response for the JSON-lines transport (§16.3).

    Lossless for everything the exactness harness compares: every ranked
    doc with its exact score and its exact ``(doc_id, start, end)``
    fragments, plus the flags (``partial`` / ``shed`` /
    ``shards_degraded``) that mark a response as not-complete.  With a
    ``ticket``, the daemon-side accounting (queue wait, batch size,
    latency) rides along so the load generator needs no second channel.
    """
    out = {
        "query": resp.query,
        "docs": [
            {
                "doc_id": int(d.doc_id),
                "score": float(d.score),
                "fragments": [[int(f.doc_id), int(f.start), int(f.end)] for f in d.fragments],
            }
            for d in resp.docs
        ],
        "n_subqueries": int(resp.n_subqueries),
        "partial": bool(resp.stats.partial),
        "shed": int(resp.stats.shed),
        "shards_degraded": int(resp.stats.shards_degraded),
        "cache_hit": bool(resp.stats.cache_hits),
        "deadline_sec": float(resp.stats.deadline_sec),
    }
    if ticket is not None:
        out["seq"] = ticket.seq
        out["queue_wait_sec"] = float(ticket.queue_wait_sec)
        out["latency_sec"] = float(ticket.latency_sec)
        out["batch_size"] = int(ticket.batch_size)
        out["replica"] = ticket.replica
        out["shed_at_queue"] = bool(ticket.shed_at_queue)
    return out


class _JsonLineHandler(socketserver.StreamRequestHandler):
    """One connection: newline-delimited JSON requests, one JSON reply per
    line, in request order per connection (concurrency = connections)."""

    def handle(self) -> None:  # pragma: no cover - exercised via round-trip test
        daemon: ServiceDaemon = self.server.search_daemon  # type: ignore[attr-defined]
        for raw in self.rfile:
            line = raw.strip()
            if not line:
                continue
            try:
                msg = json.loads(line.decode("utf-8"))
            except (ValueError, UnicodeDecodeError) as e:
                reply = {"error": f"bad request: {e}"}
            else:
                reply = self._dispatch(daemon, msg)
            self.wfile.write((json.dumps(reply) + "\n").encode("utf-8"))
            self.wfile.flush()

    @staticmethod
    def _dispatch(daemon: "ServiceDaemon | ReplicatedServiceDaemon", msg: dict) -> dict:
        op = msg.get("op", "search")
        if op == "metrics":
            return {"metrics": daemon.metrics()}
        if op == "ping":
            return {"pong": True}
        if op == "kill_primary":
            # §18.3 failover walkthrough: only a replicated daemon has a
            # primary to kill
            if not isinstance(daemon, ReplicatedServiceDaemon):
                return {"error": "kill_primary requires --replicas > 1"}
            killed = daemon.crash_primary()
            return {"killed": killed, "metrics": daemon.metrics()}
        if op != "search" or "query" not in msg:
            return {"error": f"unknown op {op!r}"}
        deadline_ms = msg.get("deadline_ms")
        req = SearchRequest(
            query=str(msg["query"]),
            top_k=int(msg.get("top_k", 10)),
            deadline_sec=None if deadline_ms is None else float(deadline_ms) / 1e3,
        )
        timeout_s = float(msg.get("timeout_s", 60.0))
        if isinstance(daemon, ReplicatedServiceDaemon):
            # idempotent §18.3 path: a repeated request_id returns the
            # recorded response byte-identically, across failovers
            handle = daemon.submit(req, request_id=msg.get("request_id"))
            resp = handle.result(timeout=timeout_s)
            out = response_to_wire(resp, handle.ticket)
            out["request_id"] = handle.request_id
            out["readmissions"] = handle.readmissions
            return out
        ticket = daemon.submit(req)
        resp = ticket.result(timeout=timeout_s)
        return response_to_wire(resp, ticket)


class TcpDaemonServer(socketserver.ThreadingTCPServer):
    """JSON-lines TCP front of a :class:`ServiceDaemon` (§16.3).

    One thread per connection; every connection's requests go through the
    SAME daemon queue, so concurrent clients batch together and receive
    exactly the responses the in-process transport would return (the wire
    encoding is lossless for docs/scores/fragments/flags — pinned by the
    round-trip test in ``tests/test_torch_service.py``).  Bind port 0 for an
    ephemeral test port; ``address`` reports the bound (host, port).
    """

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, daemon: ServiceDaemon, host: str = "127.0.0.1", port: int = 0):
        super().__init__((host, port), _JsonLineHandler)
        self.search_daemon = daemon

    @property
    def address(self) -> tuple[str, int]:
        """The bound ``(host, port)`` — port is the ephemeral assignment
        when constructed with port 0 (§16.3)."""
        host, port = self.server_address[:2]
        return (host, port)


def serve_tcp(
    daemon: ServiceDaemon, host: str = "127.0.0.1", port: int = 0
) -> TcpDaemonServer:
    """Start the daemon (threaded mode) and a JSON-lines TCP server over
    it on a background thread (§16.3); returns the server (use
    ``server.address`` for the bound port, ``server.shutdown()`` +
    ``daemon.stop()`` to tear down).  Responses over the wire are exactly
    the in-process responses, encoded by :func:`response_to_wire`."""
    daemon.start()
    server = TcpDaemonServer(daemon, host=host, port=port)
    thread = threading.Thread(
        target=server.serve_forever, name="service-tcp", daemon=True
    )
    thread.start()
    return server


def request_over_tcp(
    address: tuple[str, int], payload: dict, timeout_s: float = 60.0
) -> dict:
    """One JSON-lines round trip against :func:`serve_tcp` (§16.3): send
    ``payload`` on a fresh connection, return the decoded reply — the
    exact wire image of the daemon's response.  The client half of the
    load generator and the transport round-trip test."""
    with socket.create_connection(address, timeout=timeout_s) as sock:
        sock.sendall((json.dumps(payload) + "\n").encode("utf-8"))
        with sock.makefile("rb") as f:
            line = f.readline()
    if not line:
        raise ConnectionError("server closed the connection without a reply")
    return json.loads(line.decode("utf-8"))
