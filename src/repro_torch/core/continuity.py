"""Guest lifecycle ↔ workload binding (the "ad hoc guest").

The paper's guest is a VirtualBox VM executing a BOINC task. Here a guest
is any object implementing :class:`GuestRuntime` — the contract the ad hoc
client needs to control it (start/stop), probe it (the 10-second
VBoxManage-style liveness check), snapshot/restore it, and account its
progress. The port carries one implementation:

- :class:`SimulatedGuest` — abstract work units advanced by simulated
  time; used by the reliability/performance benchmarks (paper §IV replays
  failure traces against these).

A guest bound to a real training task (``TrainingGuest``, whose snapshot
is a serialized train state) comes with the port's trainer, which is not
ported yet (ROADMAP Queue 1).

Copied from ``repro/core/continuity.py`` (plain Python), so that
the port imports nothing of the JAX package; only the
cross-references name the port's modules.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Protocol


class GuestRuntime(Protocol):
    """What the ad hoc client can do with its guest VM."""

    guest_id: str
    job_id: str

    def start(self, payload: Any, now: float) -> None: ...

    def healthy(self) -> bool: ...

    def progress(self) -> float: ...

    def snapshot(self) -> bytes: ...

    def restore(self, blob: bytes) -> None: ...

    def stop(self) -> None: ...


@dataclass
class SimulatedGuest:
    """A guest whose job is ``work_units`` of abstract compute.

    ``advance(dt)`` performs ``dt * speed`` units of work (zero while
    suspended). ``snapshot()`` captures the progress counter — restoring a
    snapshot resumes from the captured progress, exactly the semantics a
    VM snapshot gives a BOINC task mid-computation.
    """

    guest_id: str
    job_id: str
    work_units: float = 0.0
    speed: float = 1.0
    done: float = 0.0
    running: bool = False
    suspended: bool = False
    failed: bool = False
    snapshot_overhead_s: float = 0.0   # pause while the snapshot is taken
    _pause_until: float = field(default=0.0, repr=False)

    def start(self, payload: Any, now: float) -> None:
        if isinstance(payload, dict) and "work_units" in payload:
            self.work_units = float(payload["work_units"])
        self.running = True
        self.failed = False

    def healthy(self) -> bool:
        return self.running and not self.failed

    def progress(self) -> float:
        return self.done

    def complete(self) -> bool:
        return self.done >= self.work_units

    def advance(self, dt: float, now: float) -> None:
        if not self.running or self.suspended or self.failed:
            return
        effective = dt
        if now < self._pause_until:
            effective = max(0.0, dt - (self._pause_until - now))
        self.done = min(self.work_units, self.done + effective * self.speed)

    def snapshot(self) -> bytes:
        import struct

        return struct.pack("<dd", self.done, self.work_units)

    def note_snapshot_pause(self, now: float) -> None:
        self._pause_until = now + self.snapshot_overhead_s

    def restore(self, blob: bytes) -> None:
        import struct

        self.done, self.work_units = struct.unpack("<dd", blob)
        self.running = True
        self.failed = False

    def stop(self) -> None:
        self.running = False

    def crash(self) -> None:
        self.failed = True
