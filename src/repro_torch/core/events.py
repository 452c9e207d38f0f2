"""Failure traces (paper §IV): Nagios-style host up/down events + replay.

The paper's reliability experiment parsed 36 months of Nagios monitoring
data from 650 School of Informatics hosts, computed hourly host activity,
and replayed the most active hour on a 30-node cluster. We reproduce the
*shape* of that data: per-host alternating UP/DOWN renewal processes with
host-specific MTBF/MTTR drawn from a heavy-tailed mix (a few chronically
flaky machines, many mostly-up ones), which is what Nagios availability
data looks like. Traces are seeded and serializable so experiments are
reproducible; ``replay`` drives any callback (the simulation harness) with
the ordered events.

Copied from ``repro/core/events.py`` (plain Python), so that
the port imports nothing of the JAX package; only the
cross-references name the port's modules.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

UP, DOWN = "up", "down"


@dataclass(frozen=True)
class HostEvent:
    t: float
    host_id: str
    kind: str  # "up" | "down"


@dataclass
class FailureTrace:
    """An ordered list of host up/down transitions over [0, duration)."""

    duration: float
    host_ids: list[str]
    events: list[HostEvent]
    seed: int | None = None

    def for_host(self, host_id: str) -> list[HostEvent]:
        return [e for e in self.events if e.host_id == host_id]

    def downtime_fraction(self, host_id: str) -> float:
        """Fraction of the trace window the host spends DOWN."""
        t, state, down = 0.0, UP, 0.0
        for e in self.for_host(host_id):
            if e.kind == DOWN and state == UP:
                t, state = e.t, DOWN
            elif e.kind == UP and state == DOWN:
                down += e.t - t
                state = UP
        if state == DOWN:
            down += self.duration - t
        return down / self.duration

    def n_failures(self, host_id: str) -> int:
        return sum(1 for e in self.for_host(host_id) if e.kind == DOWN)

    def to_json(self) -> str:
        return json.dumps(
            {
                "duration": self.duration,
                "host_ids": self.host_ids,
                "seed": self.seed,
                "events": [[e.t, e.host_id, e.kind] for e in self.events],
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "FailureTrace":
        d = json.loads(s)
        return cls(
            duration=d["duration"],
            host_ids=d["host_ids"],
            seed=d.get("seed"),
            events=[HostEvent(t, h, k) for t, h, k in d["events"]],
        )


def nagios_like_trace(
    n_hosts: int,
    duration: float,
    seed: int = 0,
    *,
    mean_uptime: float = 1800.0,
    mean_downtime: float = 120.0,
    flaky_fraction: float = 0.2,
    flaky_uptime_scale: float = 0.25,
    host_prefix: str = "host",
) -> FailureTrace:
    """Generate a per-host alternating renewal trace.

    Each host draws exponential UP periods (mean ``mean_uptime``; flaky
    hosts get ``flaky_uptime_scale`` of that) and exponential DOWN periods
    (mean ``mean_downtime``). All hosts start UP. This mirrors the hourly
    activity replay of §IV: over a ~1-hour window with these defaults a
    30-host fleet sees a handful of failures concentrated on flaky hosts.
    """
    rng = np.random.default_rng(np.random.SeedSequence([seed, n_hosts]))
    host_ids = [f"{host_prefix}{i:03d}" for i in range(n_hosts)]
    flaky = rng.random(n_hosts) < flaky_fraction
    events: list[HostEvent] = []
    for i, h in enumerate(host_ids):
        up_mean = mean_uptime * (flaky_uptime_scale if flaky[i] else 1.0)
        t = float(rng.exponential(up_mean))
        state = DOWN
        while t < duration:
            events.append(HostEvent(t, h, state))
            dur = rng.exponential(
                mean_downtime if state == DOWN else up_mean
            )
            t += float(dur)
            state = UP if state == DOWN else DOWN
    events.sort(key=lambda e: (e.t, e.host_id))
    return FailureTrace(duration, host_ids, events, seed)


def constant_failure_trace(
    host_ids: list[str],
    fail_times: dict[str, list[float]],
    duration: float,
    recovery: float = 120.0,
) -> FailureTrace:
    """Hand-authored trace: each listed failure is DOWN at t, UP at
    t+recovery (for targeted tests/benchmarks)."""
    events = []
    for h, times in fail_times.items():
        for t in times:
            events.append(HostEvent(t, h, DOWN))
            if t + recovery < duration:
                events.append(HostEvent(t + recovery, h, UP))
    events.sort(key=lambda e: (e.t, e.host_id))
    return FailureTrace(duration, list(host_ids), events, None)


def replay(
    trace: FailureTrace,
    on_event: Callable[[HostEvent], None],
    *,
    until: float | None = None,
) -> Iterator[HostEvent]:
    """Feed events through ``on_event`` in order; yields each event after
    delivery (callers interleave their own per-interval work)."""
    horizon = trace.duration if until is None else until
    for e in trace.events:
        if e.t >= horizon:
            break
        on_event(e)
        yield e
