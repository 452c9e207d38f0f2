"""Availability checking (paper §III-A/B): polls and the 2-minute rule.

Each ad hoc client polls the server every ``poll_interval`` (60 s). The
``availability_checker`` daemon declares a host terminated/failed after
``failure_timeout`` (120 s) of silence. Guests are probed locally by their
client every ``guest_probe_interval`` (10 s); a probe failure is reported
to the server on the next poll (or immediately in-process here).

Copied from ``repro/core/availability.py`` (plain Python), so that
the port imports nothing of the JAX package; only the
cross-references name the port's modules.
"""

from __future__ import annotations

from dataclasses import dataclass

POLL_INTERVAL_S = 60.0
FAILURE_TIMEOUT_S = 120.0
GUEST_PROBE_INTERVAL_S = 10.0


@dataclass
class HostPresence:
    host_id: str
    last_poll: float
    available: bool = True


class AvailabilityChecker:
    """Server-side availability_checker daemon state."""

    def __init__(self, failure_timeout: float = FAILURE_TIMEOUT_S):
        self.failure_timeout = failure_timeout
        self._presence: dict[str, HostPresence] = {}

    def register(self, host_id: str, now: float) -> None:
        self._presence[host_id] = HostPresence(host_id, now, True)

    def deregister(self, host_id: str) -> None:
        self._presence.pop(host_id, None)

    def record_poll(self, host_id: str, now: float) -> None:
        p = self._presence.get(host_id)
        if p is None:
            self.register(host_id, now)
        else:
            p.last_poll = now
            p.available = True

    def check(self, now: float) -> list[str]:
        """Run the availability sweep: returns hosts *newly* deemed failed
        (silent for longer than the timeout)."""
        newly_failed = []
        for p in self._presence.values():
            if p.available and now - p.last_poll > self.failure_timeout:
                p.available = False
                newly_failed.append(p.host_id)
        return newly_failed

    def mark_failed(self, host_id: str) -> None:
        """Explicitly flag a host DOWN (a reported leave/failure): the
        next :meth:`check` sweep won't re-report it as newly failed."""
        p = self._presence.get(host_id)
        if p is not None:
            p.available = False

    def is_available(self, host_id: str) -> bool:
        p = self._presence.get(host_id)
        return bool(p and p.available)

    def available_hosts(self) -> list[str]:
        return [h for h, p in self._presence.items() if p.available]

    def to_state(self) -> dict:
        return {
            h: (p.last_poll, p.available) for h, p in self._presence.items()
        }

    @classmethod
    def from_state(cls, state: dict, failure_timeout: float = FAILURE_TIMEOUT_S
                   ) -> "AvailabilityChecker":
        ac = cls(failure_timeout)
        for h, (t, a) in state.items():
            ac._presence[h] = HostPresence(h, t, a)
        return ac
