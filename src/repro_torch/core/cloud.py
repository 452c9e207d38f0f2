"""The assembled ad hoc cloud: server + clients + guests on a simulated LAN.

This is the harness the paper-§IV experiments run on: register N hosts,
apply a failure trace (Nagios replay), submit cloud jobs, and measure
completion. All periodic daemons run at the paper's constants:

- client → server poll        every 60 s   (staggered per host)
- availability sweep          every 10 s   (server-side daemon cadence)
- guest liveness probe        every 10 s
- resource monitor            every 10 s
- P2P snapshot                every ``snapshot_interval_s`` (default 120 s)
- guest work advance          every ``tick_s`` of simulated compute

Setting ``continuity=False`` turns off snapshot/restore — the plain-BOINC
baseline the paper compares against (failed tasks restart from scratch).

Copied from ``repro/core/cloud.py`` (plain Python), so that
the port imports nothing of the JAX package; only the
cross-references name the port's modules.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.checkpoint.store import SnapshotStore
from repro_torch.core.availability import GUEST_PROBE_INTERVAL_S, POLL_INTERVAL_S
from repro_torch.core.client import AdHocClient, ResourceMonitor
from repro_torch.core.continuity import SimulatedGuest
from repro_torch.core.events import DOWN, UP, FailureTrace
from repro_torch.core.server import AdHocServer, JobState
from repro_torch.core.simulation import EventLoop, SimClock


@dataclass
class SimParams:
    n_hosts: int = 30
    cloudlet: str = "cloudlet-0"
    service: str = "generic"
    seed: int = 0
    continuity: bool = True
    snapshot_interval_s: float = 120.0
    snapshot_overhead_s: float = 2.0      # guest pause while snapshotting
    tick_s: float = 5.0
    guest_fail_per_hour: float = 0.0      # VM-level failure injection
    work_speed: float = 1.0
    storage_cap_bytes: int = 1 << 62
    snapshot_target_failure: float = 0.05
    max_snapshot_receivers: int = 8
    load_limit: float = 0.75
    max_job_attempts: int = 50


class AdHocCloudSim:
    def __init__(self, params: SimParams,
                 host_load_fns: dict[str, callable] | None = None):
        self.p = params
        self.loop = EventLoop(SimClock())
        self.clock = self.loop.clock
        self.rng = np.random.default_rng(
            np.random.SeedSequence([params.seed, 0xC10D])
        )
        self.server = AdHocServer(
            snapshot_target_failure=params.snapshot_target_failure,
            max_snapshot_receivers=params.max_snapshot_receivers,
            max_job_attempts=params.max_job_attempts,
            continuity_enabled=params.continuity,
        )
        self.server.create_cloudlet(params.cloudlet, params.service)
        self.host_ids = [f"host{i:03d}" for i in range(params.n_hosts)]
        self.stores = {
            h: SnapshotStore(params.storage_cap_bytes) for h in self.host_ids
        }
        self.guests: dict[str, SimulatedGuest] = {}     # guest_id -> guest
        load_fns = host_load_fns or {}
        self.clients: dict[str, AdHocClient] = {}
        for h in self.host_ids:
            self.clients[h] = AdHocClient(
                h,
                self.server,
                guest_factory=self._make_guest,
                peer_stores=self.stores,
                local_store=self.stores[h],
                load_fn=load_fns.get(h, lambda now: 0.0),
                monitor=ResourceMonitor(load_limit=params.load_limit),
                snapshot_target_failure=params.snapshot_target_failure,
                max_snapshot_receivers=params.max_snapshot_receivers,
            )
            self.server.register_host(
                h, 0.0, cloudlets=[params.cloudlet],
                storage_limit=params.storage_cap_bytes,
            )
        self._schedule_daemons()

    # ----------------------------------------------------------------- wiring
    def _make_guest(self, guest_id: str, job_id: str) -> SimulatedGuest:
        g = SimulatedGuest(
            guest_id=guest_id,
            job_id=job_id,
            speed=self.p.work_speed,
            snapshot_overhead_s=self.p.snapshot_overhead_s,
        )
        self.guests[guest_id] = g
        return g

    def _schedule_daemons(self) -> None:
        n = max(1, len(self.host_ids))
        for i, h in enumerate(self.host_ids):
            client = self.clients[h]
            self.loop.every(
                POLL_INTERVAL_S,
                (lambda c: lambda: c.poll(self.clock.now()))(client),
                first_in=POLL_INTERVAL_S * (i + 1) / n,
            )
            self.loop.every(
                GUEST_PROBE_INTERVAL_S,
                (lambda c: lambda: c.probe_guest(self.clock.now()))(client),
                first_in=GUEST_PROBE_INTERVAL_S * (i + 1) / n,
            )
            self.loop.every(
                GUEST_PROBE_INTERVAL_S,
                (lambda c: lambda: c.monitor_resources(self.clock.now()))(client),
                first_in=GUEST_PROBE_INTERVAL_S * (i + 0.5) / n,
            )
            if self.p.continuity:
                self.loop.every(
                    self.p.snapshot_interval_s,
                    (lambda c: lambda: c.snapshot_guest(self.clock.now()))(client),
                    first_in=self.p.snapshot_interval_s * (i + 1) / n,
                )
        self.loop.every(10.0, lambda: self.server.tick(self.clock.now()))
        self.loop.every(self.p.tick_s, self._advance_guests)

    def _advance_guests(self) -> None:
        now = self.clock.now()
        dt = self.p.tick_s
        fail_p = self.p.guest_fail_per_hour * dt / 3600.0
        for h, client in self.clients.items():
            g = client.guest
            if g is None or not client.up:
                continue
            if fail_p > 0 and g.healthy() and self.rng.random() < fail_p:
                g.crash()      # detected by the next 10 s probe
                continue
            g.advance(dt, now)
            client.maybe_report_completion(now)

    # ------------------------------------------------------------------ trace
    def apply_trace(self, trace: FailureTrace) -> None:
        for e in trace.events:
            client = self.clients.get(e.host_id)
            if client is None:
                continue
            if e.kind == DOWN:
                self.loop.schedule(
                    e.t - self.clock.now(),
                    (lambda c: lambda: c.go_down(self.clock.now()))(client),
                )
            elif e.kind == UP:
                self.loop.schedule(
                    e.t - self.clock.now(),
                    (lambda c: lambda: c.come_up(self.clock.now()))(client),
                )

    # ------------------------------------------------------------------- jobs
    def submit(self, work_units: float, n_jobs: int = 1) -> list[str]:
        now = self.clock.now()
        return [
            self.server.submit_job(
                self.p.cloudlet, work_units, now,
                payload={"work_units": work_units},
            )
            for _ in range(n_jobs)
        ]

    # -------------------------------------------------------------------- run
    def run(self, duration: float) -> dict:
        self.loop.run_until(self.clock.now() + duration)
        return self.stats()

    def run_until_settled(self, max_duration: float, check_every: float = 60.0
                          ) -> dict:
        """Run until all jobs reach a terminal state (or the horizon)."""
        end = self.clock.now() + max_duration
        while self.clock.now() < end:
            self.loop.run_until(min(end, self.clock.now() + check_every))
            states = {j.state for j in self.server.jobs.values()}
            if states <= {JobState.COMPLETED, JobState.FAILED}:
                break
        return self.stats()

    def stats(self) -> dict:
        s = self.server.completion_stats()
        s["now"] = self.clock.now()
        jobs = self.server.jobs.values()
        makespans = [
            j.completed_at - j.submitted_at
            for j in jobs
            if j.completed_at is not None
        ]
        s["mean_makespan"] = float(np.mean(makespans)) if makespans else None
        s["max_makespan"] = float(np.max(makespans)) if makespans else None
        snap_meta = self.server.snapshots.latest
        s["live_snapshots"] = len(snap_meta)
        return s
