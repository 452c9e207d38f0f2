"""Seeded fault injection on the :class:`~repro_torch.core.simulation.SimClock`.

One fault-injection layer shared by the batch tier
(:mod:`repro_torch.serving.batch`), the elastic serving cell (the JAX
package's ``serving/cell.py``, not ported yet), their benches, and the
tests — instead of
each growing a private copy. A :class:`FaultPlan` is a deterministic,
seeded trace of :class:`FaultEvent` s consumed in timeline order:

- ``crash``   — the host falls silent (its client stops polling and its
  worker stops advancing); the availability checker's 2-minute rule —
  or, in the cell, the per-step collective deadline — detects it,
  exactly as in §III-A.
- ``slow``    — the host's per-token decode time is multiplied, driving
  it past workunit deadlines (batch) or the collective step deadline
  (cell straggler eviction).
- ``corrupt`` — the host flips a token in its next ``count`` reported
  results, so its digest loses the hash-quorum vote (batch tier only).
- ``rejoin``  — a previously crashed/slow host comes back clean and
  polls again (:meth:`~repro_torch.core.server.AdHocServer.host_returned`);
  elastic consumers may grow their mesh back onto it.

Copied from ``repro/core/faults.py`` (plain Python), so that
the port imports nothing of the JAX package; only the
cross-references name the port's modules.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["FaultEvent", "FaultPlan"]


@dataclass
class FaultEvent:
    """One scheduled fault on the :class:`SimClock` timeline."""

    at: float
    kind: str            # "crash" | "slow" | "corrupt" | "rejoin"
    host: str
    factor: float = 4.0  # slow: decode-time multiplier
    count: int = 1       # corrupt: number of results to corrupt


class FaultPlan:
    """A deterministic, seeded trace of injected faults."""

    def __init__(self, events: list[FaultEvent]):
        self.events = sorted(events, key=lambda e: (e.at, e.host, e.kind))
        self._i = 0

    def due(self, now: float) -> list[FaultEvent]:
        """Events whose time has come (consumed; call with advancing now)."""
        out = []
        while self._i < len(self.events) and self.events[self._i].at <= now:
            out.append(self.events[self._i])
            self._i += 1
        return out

    @classmethod
    def seeded(
        cls,
        hosts: list[str],
        seed: int,
        *,
        kill_fraction: float = 0.25,
        crash_window: tuple[float, float] = (10.0, 30.0),
        n_slow: int = 1,
        slow_factor: float = 8.0,
        n_corrupt: int = 1,
        corrupt_results: int = 1,
        n_rejoin: int = 0,
        rejoin_delay: tuple[float, float] = (10.0, 20.0),
    ) -> "FaultPlan":
        """A churn trace over ``hosts``: ``ceil(kill_fraction * len)``
        crashes inside ``crash_window``, plus ``n_slow`` slow hosts and
        ``n_corrupt`` corrupters active from t=0, plus ``n_rejoin`` of
        the crashed hosts returning ``rejoin_delay`` seconds after their
        crash. Targets are disjoint (rejoins excepted — they revive a
        crashed host) and chosen by the seed, so the trace is
        reproducible byte-for-byte; with ``n_rejoin=0`` the rng draw
        sequence — and hence the trace — is identical to what pre-rejoin
        callers got for the same seed.
        """
        import numpy as np

        rng = np.random.default_rng(seed)
        order = [hosts[i] for i in rng.permutation(len(hosts))]
        n_kill = max(1, int(np.ceil(len(hosts) * kill_fraction)))
        events: list[FaultEvent] = []
        it = iter(order)
        lo, hi = crash_window
        crashed: list[FaultEvent] = []
        for _ in range(min(n_kill, len(order))):
            ev = FaultEvent(
                at=float(rng.uniform(lo, hi)), kind="crash", host=next(it))
            events.append(ev)
            crashed.append(ev)
        for _ in range(n_slow):
            events.append(FaultEvent(
                at=0.0, kind="slow", host=next(it), factor=slow_factor))
        for _ in range(n_corrupt):
            events.append(FaultEvent(
                at=0.0, kind="corrupt", host=next(it),
                count=corrupt_results))
        # rejoin draws come last so seeded traces without them are
        # bit-identical to the pre-rejoin generator for the same seed
        d_lo, d_hi = rejoin_delay
        for ev in sorted(crashed, key=lambda e: e.at)[:n_rejoin]:
            events.append(FaultEvent(
                at=ev.at + float(rng.uniform(d_lo, d_hi)), kind="rejoin",
                host=ev.host))
        return cls(events)
