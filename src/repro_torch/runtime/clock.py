"""Injectable clocks for every time-dependent serving layer (DESIGN.md §16.4).

All serving-side timing — deadline budgets and EWMA throughput calibration
in ``search/frontend.py``, circuit-breaker cooldowns and straggler hedging
in ``search/resilience.py``, queue wait and latency accounting in
``search/service.py`` — reads time through one of these clock objects
instead of calling ``time`` directly.  Production uses :class:`SystemClock`
(identical behavior to the previous direct ``time.perf_counter`` /
``time.sleep`` calls); tests inject :class:`ManualClock`, whose time only
moves when the test (or an injected fault's virtual ``sleep``) advances it,
so deadline/shed/straggler tests assert **exact tick boundaries** — no real
sleeps, no wall-clock flakiness, and a given schedule of advances replays
identically on every run.

Both clocks are *callable* (returning "now") so they can be passed anywhere
a bare ``clock()`` callable is expected (e.g. the ``HealthMonitor`` breaker
cooldown in ``search/resilience.py``).
"""

from __future__ import annotations

import time

__all__ = ["SystemClock", "ManualClock"]


class SystemClock:
    """The real wall clock (DESIGN.md §16.4): ``now()`` is
    ``time.perf_counter`` and ``sleep`` is ``time.sleep`` — byte-for-byte
    the timing behavior the serving layers had before clock injection, so
    production timing is identical with or without an explicit clock."""

    #: virtual clocks advance only when told to; schedulers use this flag
    #: to pick deterministic (thread-free) code paths.
    virtual = False

    def now(self) -> float:
        """Monotonic seconds (``time.perf_counter``)."""
        return time.perf_counter()

    __call__ = now

    @staticmethod
    def sleep(seconds: float) -> None:
        """Real ``time.sleep`` (§16.4); no-op for non-positive durations."""
        if seconds > 0:
            time.sleep(seconds)


class ManualClock:
    """A deterministic fake clock (DESIGN.md §16.4).

    Time starts at ``start`` and moves ONLY via :meth:`advance` /
    :meth:`sleep` (an injected straggler delay "sleeps" by advancing
    virtual time instantly) or the optional ``tick`` auto-advance: with
    ``tick > 0`` every ``now()`` reading advances time by exactly one tick
    first, so code that brackets work with two readings observes an elapsed
    time of exactly ``tick`` — the exactness hook the EWMA-calibration and
    queue-timer tests assert against (identical advance schedules produce
    identical timestamps on every run).
    """

    virtual = True

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        self._now = float(start)
        self.tick = float(tick)

    def now(self) -> float:
        """Current virtual time; auto-advances by ``tick`` per reading."""
        if self.tick:
            self._now += self.tick
        return self._now

    __call__ = now

    def peek(self) -> float:
        """Read the virtual time WITHOUT consuming an auto-advance tick
        (test assertions use this so observing time never moves it —
        §16.4 exact-tick contract)."""
        return self._now

    def sleep(self, seconds: float) -> None:
        """Advance virtual time by ``seconds`` instantly — the injected
        form of ``time.sleep`` (§16.4): a scheduled straggler delay is
        observable as an exact timestamp difference, but costs no real
        time."""
        self.advance(seconds)

    def advance(self, seconds: float) -> float:
        """Move the clock forward ``seconds`` (negative is clamped to 0 —
        virtual time is monotonic like ``time.perf_counter``); returns the
        new virtual now."""
        self._now += max(0.0, float(seconds))
        return self._now
