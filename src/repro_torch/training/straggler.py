"""Straggler detection & mitigation (the paper's low-interference rule,
TPU-adapted).

On a non-exclusive host the paper suspends the VM while the host user
needs the machine. Under synchronous SPMD training a *slow* host stalls
every all-reduce, so suspension alone would stall the fleet. The
TPU-native actions (DESIGN.md §3) are:

- **rebalance** — with gradient accumulation, shift microbatches away from
  loaded hosts: the step time is ``max_h(micro_h × t_h)``, so matching
  ``micro_h ∝ 1/t_h`` minimizes the barrier wait;
- **evict** — when a host is persistently over the interference limit,
  treat it like the paper's suspend: drop it from the mesh (the elastic
  restore path brings it back later).

Detection mirrors the Resource Monitor: per-host step durations over a
sliding window, flagged when exceeding ``factor ×`` the fleet median.

Copied from ``repro/training/straggler.py`` (numpy only), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np


@dataclass
class StragglerDetector:
    factor: float = 1.5
    window: int = 8
    min_samples: int = 3
    _hist: dict[str, deque] = field(default_factory=dict)

    def record(self, host_id: str, duration: float) -> None:
        self._hist.setdefault(host_id, deque(maxlen=self.window)).append(duration)

    def host_time(self, host_id: str) -> float | None:
        h = self._hist.get(host_id)
        if not h or len(h) < self.min_samples:
            return None
        return float(np.mean(h))

    def detect(self) -> set[str]:
        times = {
            h: t for h in self._hist if (t := self.host_time(h)) is not None
        }
        if len(times) < 2:
            return set()
        med = float(np.median(list(times.values())))
        return {h for h, t in times.items() if t > self.factor * med}


def rebalance_microbatches(
    host_times: dict[str, float], total_micro: int
) -> dict[str, int]:
    """Allocate ``total_micro`` microbatches ∝ host speed (1/time).

    Every host keeps ≥1 microbatch (it still holds a data shard); the
    remainder goes to the fastest hosts. Exact: Σ allocations == total.
    """
    hosts = sorted(host_times)
    n = len(hosts)
    assert total_micro >= n, (total_micro, n)
    speed = np.array([1.0 / max(host_times[h], 1e-9) for h in hosts])
    share = speed / speed.sum() * total_micro
    alloc = np.maximum(1, np.floor(share).astype(int))
    # fix rounding drift, preferring fastest hosts for +1, slowest for -1
    while alloc.sum() < total_micro:
        alloc[int(np.argmax(share - alloc))] += 1
    while alloc.sum() > total_micro:
        candidates = np.where(alloc > 1)[0]
        j = candidates[int(np.argmin((share - alloc)[candidates]))]
        alloc[j] -= 1
    return {h: int(a) for h, a in zip(hosts, alloc)}


def step_time_sync(host_times: dict[str, float],
                   alloc: dict[str, int]) -> float:
    """Wall time of one synchronous step = the slowest host's share."""
    return max(host_times[h] * alloc[h] for h in alloc)


@dataclass
class InterferenceController:
    """Chooses the mitigation per detection sweep.

    ``evict_after`` consecutive flags → evict (paper-suspend analogue);
    otherwise rebalance.
    """

    detector: StragglerDetector = field(default_factory=StragglerDetector)
    evict_after: int = 3
    _flagged: dict[str, int] = field(default_factory=dict)

    def update(self, durations: dict[str, float]) -> dict:
        for h, d in durations.items():
            self.detector.record(h, d)
        stragglers = self.detector.detect()
        for h in list(self._flagged):
            if h not in stragglers:
                self._flagged.pop(h)
        evict = set()
        for h in stragglers:
            self._flagged[h] = self._flagged.get(h, 0) + 1
            if self._flagged[h] >= self.evict_after:
                evict.add(h)
        return {"stragglers": stragglers, "evict": evict}
