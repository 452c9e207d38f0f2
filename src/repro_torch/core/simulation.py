"""Deterministic discrete-event simulation substrate.

The paper's daemons are wall-clock driven (1-min polls, 2-min timeouts,
10-s guest probes). To make the reliability experiments reproducible on a
CPU container, every core component takes time from a :class:`SimClock`
and periodic actions are scheduled on an :class:`EventLoop` (a priority
queue of timestamped callbacks). The very same components run against a
real clock in deployment — the clock is the only seam.

Copied from ``repro/core/simulation.py`` (plain Python), so that
the port imports nothing of the JAX package; only the
cross-references name the port's modules.
"""

from __future__ import annotations

import heapq
import itertools
import time as _time
from dataclasses import dataclass, field
from typing import Callable


class Clock:
    """Abstract time source."""

    def now(self) -> float:  # pragma: no cover - interface
        raise NotImplementedError


class SimClock(Clock):
    """Simulated clock; time advances only when told to."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        assert dt >= 0, dt
        self._t += dt
        return self._t

    def set(self, t: float) -> None:
        assert t >= self._t, (t, self._t)
        self._t = t


class WallClock(Clock):
    """Real time (deployment)."""

    def now(self) -> float:
        return _time.monotonic()


@dataclass(order=True)
class _Event:
    t: float
    seq: int
    fn: Callable[[], None] = field(compare=False)
    period: float = field(compare=False, default=0.0)
    cancelled: bool = field(compare=False, default=False)


class EventLoop:
    """Priority-queue event loop over a :class:`SimClock`.

    ``schedule(dt, fn)`` runs ``fn`` once at ``now+dt``; ``every(period, fn)``
    re-arms automatically (the paper's poll/probe daemons). ``run_until(t)``
    advances the clock through all due events in deterministic order
    (time, insertion order).
    """

    def __init__(self, clock: SimClock | None = None):
        self.clock = clock or SimClock()
        self._q: list[_Event] = []
        self._counter = itertools.count()

    def schedule(self, dt: float, fn: Callable[[], None]) -> _Event:
        ev = _Event(self.clock.now() + dt, next(self._counter), fn)
        heapq.heappush(self._q, ev)
        return ev

    def every(self, period: float, fn: Callable[[], None],
              first_in: float | None = None) -> _Event:
        assert period > 0
        ev = _Event(
            self.clock.now() + (period if first_in is None else first_in),
            next(self._counter), fn, period=period,
        )
        heapq.heappush(self._q, ev)
        return ev

    def cancel(self, ev: _Event) -> None:
        ev.cancelled = True

    def run_until(self, t: float) -> None:
        while self._q and self._q[0].t <= t:
            ev = heapq.heappop(self._q)
            if ev.cancelled:
                continue
            self.clock.set(max(ev.t, self.clock.now()))
            ev.fn()
            if ev.period > 0 and not ev.cancelled:
                ev.t += ev.period
                ev.seq = next(self._counter)
                heapq.heappush(self._q, ev)
        self.clock.set(max(t, self.clock.now()))

    def run_for(self, dt: float) -> None:
        self.run_until(self.clock.now() + dt)
