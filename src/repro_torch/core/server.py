"""The ad hoc server (paper §II-A, §III): Job Service + VM Service.

Mirrors the paper's BOINC-project pair:

- **Job Service** (``work_creator`` daemon): accepts cloud-user jobs
  submitted on-the-fly and turns them into workunits (:meth:`submit_job`).
- **VM Service** (``vm_controller`` daemon): instantiates guests on hosts,
  schedules jobs to the most reliable ready host (§III-B), and issues
  commands to clients — the *server-controlled* inversion of BOINC
  (§III-C). Commands are returned from :meth:`poll` (the BOINC XML
  message) and delivered by the transport (in-process here).
- **availability_checker** daemon: the 2-minute rule (§III-A), run by
  :meth:`tick`; failures trigger the §III-D restore protocol.

The server's own state (reliability registry, job table, snapshot
locations, cloudlets) is a plain serializable dict (:meth:`to_state`) so
the server can be "replicated and load balanced in the same way regular
BOINC servers currently are" — a standby replays the state and takes over.

Copied from ``repro/core/server.py`` (plain Python), so that
the port imports nothing of the JAX package; only the
cross-references name the port's modules.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Any

from repro_torch.core.availability import (
    FAILURE_TIMEOUT_S,
    AvailabilityChecker,
)
from repro_torch.core.cloudlet import CloudletRegistry
from repro_torch.core.reliability import ReliabilityRegistry
from repro_torch.core.snapshot import SnapshotScheduler


class JobState(str, Enum):
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"          # terminal: retries exhausted


@dataclass
class CloudJob:
    """A cloud-user job: application (+ optional data) = work_units of
    compute in a given cloudlet environment."""

    job_id: str
    cloudlet: str
    work_units: float
    submitted_at: float
    # SLO routing (mirrors the serving scheduler's request fields): higher
    # priority is placed first; a deadline (absolute sim-time by which the
    # job must have *started*) breaks ties within a priority tier
    priority: int = 0
    deadline_s: float | None = None
    state: JobState = JobState.QUEUED
    assigned_host: str | None = None
    guest_id: str | None = None
    attempts: int = 0
    restarts_from_zero: int = 0
    restores: int = 0
    completed_at: float | None = None
    payload: Any = None       # opaque job description (e.g. RunConfig)


@dataclass
class Command:
    """A server→client instruction (paper §III-C 'Transferring Control')."""

    kind: str                  # start_guest | snapshot | restore | delete_snapshot | suspend | resume | stop_guest
    args: dict = field(default_factory=dict)


@dataclass
class PollResponse:
    """The BOINC XML message returned to a polling client: the list of all
    other available hosts with reliabilities (used by the P2P snapshot
    component), plus any pending commands for this host."""

    peers: list[tuple[str, float, float]]   # (host_id, reliability, fail_prob)
    commands: list[Command]


@dataclass
class HostInfo:
    host_id: str
    cloudlets: list[str]
    vm_ready: bool = False      # VM image delivered + configured (V-BOINC 1-4)
    guest_id: str | None = None  # running guest, if any
    suspended: bool = False


class AdHocServer:
    """Central coordination: schedling, availability, continuity."""

    def __init__(
        self,
        *,
        failure_timeout: float = FAILURE_TIMEOUT_S,
        snapshot_target_failure: float = 0.05,
        max_snapshot_receivers: int = 16,
        max_job_attempts: int = 25,
        continuity_enabled: bool = True,
        job_preempt_margin: int | None = None,
    ):
        self.reliability = ReliabilityRegistry()
        self.availability = AvailabilityChecker(failure_timeout)
        self.cloudlets = CloudletRegistry()
        self.snapshots = SnapshotScheduler(
            target_joint_failure=snapshot_target_failure,
            max_receivers=max_snapshot_receivers,
        )
        self.hosts: dict[str, HostInfo] = {}
        self.jobs: dict[str, CloudJob] = {}
        # hosts currently considered down: makes _on_host_failure
        # idempotent when the same failure is reported twice (e.g. an
        # explicit report racing the availability sweep) — double
        # revocation would double-count the failure and re-queue twice
        self._down: set[str] = set()
        # batch-inference masters (repro_torch.serving.batch) notified on host
        # failure so lost workunit replicas are re-issued
        self._batch_masters: list[Any] = []
        self._outbox: dict[str, list[Command]] = {}
        self._job_counter = itertools.count()
        self._guest_counter = itertools.count()
        self.max_job_attempts = max_job_attempts
        # job-granularity preemption (the serving scheduler's
        # preempt_margin at cloud-job scale): a queued job outranking the
        # lowest-priority running job by >= margin may evict it when no
        # ready host exists. None (default) disables it.
        self.job_preempt_margin = job_preempt_margin
        # continuity_enabled=False degrades to the BOINC baseline the paper
        # compares against: failures restart the job from scratch.
        self.continuity_enabled = continuity_enabled
        self.log: list[tuple[float, str, dict]] = []

    # ------------------------------------------------------------------ util
    def _emit(self, now: float, event: str, **kv) -> None:
        self.log.append((now, event, kv))

    def _push_cmd(self, host_id: str, cmd: Command) -> None:
        self._outbox.setdefault(host_id, []).append(cmd)

    # ------------------------------------------------------- host membership
    def register_host(
        self,
        host_id: str,
        now: float,
        *,
        cloudlets: list[str] | None = None,
        storage_limit: int | None = None,
    ) -> HostInfo:
        """A host donates itself (paper: connects, receives a VM image)."""
        self.reliability.add_host(host_id, storage_limit=storage_limit)
        self.availability.record_poll(host_id, now)
        info = self.hosts.get(host_id)
        if info is None:
            info = HostInfo(host_id, [])
            self.hosts[host_id] = info
        for cl in cloudlets or []:
            assert cl in self.cloudlets, f"unknown cloudlet {cl!r}"
            self.cloudlets.join(cl, host_id)
            if cl not in info.cloudlets:
                info.cloudlets.append(cl)
        info.vm_ready = True  # V-BOINC steps (1)-(4) complete
        self._down.discard(host_id)
        self._emit(now, "host_registered", host=host_id)
        return info

    def create_cloudlet(self, name: str, service: str):
        return self.cloudlets.create(name, service)

    def register_failure_listener(self, listener: Any) -> None:
        """Wire a scheduler into the server's failure fan-out: its
        ``on_host_failure(host_id, now)`` runs on every detected host
        failure/leave, and — if it defines one — its ``job_status``
        answers through :meth:`job_status`. Used by the batch tier
        (:class:`repro_torch.serving.batch.BatchMaster`, lost replicas
        re-issue) and the elastic cell
        (:class:`repro_torch.serving.cell.ElasticServeCell`, re-shard)."""
        if listener not in self._batch_masters:
            self._batch_masters.append(listener)

    # historical name, from when batch masters were the only listeners
    register_batch_master = register_failure_listener

    # -------------------------------------------------- job service (work_creator)
    def submit_job(
        self, cloudlet: str, work_units: float, now: float, payload: Any = None,
        *, priority: int = 0, deadline_s: float | None = None,
    ) -> str:
        """On-the-fly job submission (the work_creator daemon's product)."""
        assert cloudlet in self.cloudlets, f"unknown cloudlet {cloudlet!r}"
        job_id = f"job{next(self._job_counter):04d}"
        self.jobs[job_id] = CloudJob(
            job_id=job_id, cloudlet=cloudlet, work_units=work_units,
            submitted_at=now, payload=payload,
            priority=priority, deadline_s=deadline_s,
        )
        self._emit(now, "job_submitted", job=job_id, cloudlet=cloudlet)
        # Job Service notifies VM Service that a cloud job exists (§III-A)
        self.schedule(now)
        return job_id

    # -------------------------------------------- vm service (vm_controller)
    def _ready_hosts(self, cloudlet: str) -> list[str]:
        members = self.cloudlets.get(cloudlet).members
        return [
            h
            for h in members
            if self.availability.is_available(h)
            and self.hosts[h].vm_ready
            and self.hosts[h].guest_id is None
            and not self.hosts[h].suspended
        ]

    def schedule(self, now: float) -> list[tuple[str, str]]:
        """Assign queued jobs to the most reliable ready hosts (§III-B).

        Queued jobs are considered in SLO order — priority descending,
        earliest deadline, then submission order — the job-granularity
        analogue of the serving scheduler's admission order
        (:mod:`repro_torch.serving.scheduler`), so a scarce ready host goes to
        the most urgent job, not the oldest dict entry.

        Returns [(job_id, host_id)] assignments made this pass.
        """
        out = []
        queued = sorted(
            (j for j in self.jobs.values() if j.state == JobState.QUEUED),
            key=lambda j: (
                -j.priority,
                j.deadline_s if j.deadline_s is not None else float("inf"),
                j.submitted_at, j.job_id,
            ),
        )
        for job in queued:
            ready = self._ready_hosts(job.cloudlet)
            if not ready and self.job_preempt_margin is not None:
                victim = self._pick_job_victim(job)
                if victim is not None:
                    self._preempt_job(victim, now)
                    ready = self._ready_hosts(job.cloudlet)
            if not ready:
                continue
            best = self.reliability.ranked(ready)[0]
            self._assign(job, best, now)
            out.append((job.job_id, best))
        return out

    def _pick_job_victim(self, candidate: CloudJob) -> CloudJob | None:
        """Spill-cost-aware victim selection, mirroring the serving
        scheduler's :meth:`~repro_torch.serving.scheduler.Scheduler.pick_victim`:
        base priorities gate the preemption, and within the losing tier
        a job whose snapshot is already placed on peers (§III-D — the
        job-level analogue of write-behind staged pages) is evicted
        first, because its resume is a restore rather than a restart."""
        running = [
            j for j in self.jobs.values()
            if j.state == JobState.RUNNING
            and j.cloudlet == candidate.cloudlet
            and j.assigned_host is not None
            and self.availability.is_available(j.assigned_host)
        ]
        if not running:
            return None
        staged = (lambda j: 0 if (self.continuity_enabled
                                  and self.snapshots.locations(j.job_id))
                  else 1)
        running.sort(key=lambda j: (j.priority, staged(j), j.job_id))
        v = running[0]
        assert self.job_preempt_margin is not None
        if candidate.priority >= v.priority + self.job_preempt_margin:
            return v
        return None

    def _preempt_job(self, victim: CloudJob, now: float) -> None:
        """Vacate the victim's host and requeue it; the next assignment
        restores from its placed snapshot if one survives (the preempt →
        spill → recall path at job granularity)."""
        host = victim.assigned_host
        info = self.hosts.get(host) if host is not None else None
        if info is not None and info.guest_id == victim.guest_id:
            self._push_cmd(host, Command(
                "stop_guest",
                dict(job_id=victim.job_id, guest_id=victim.guest_id)))
            info.guest_id = None
        victim.state = JobState.QUEUED
        victim.assigned_host = None
        victim.guest_id = None
        self._emit(now, "job_preempted", job=victim.job_id, host=host,
                   snapshot_staged=bool(
                       self.snapshots.locations(victim.job_id)))

    def _assign(self, job: CloudJob, host_id: str, now: float) -> None:
        guest_id = f"guest{next(self._guest_counter):04d}"
        job.state = JobState.RUNNING
        job.assigned_host = host_id
        job.guest_id = guest_id
        job.attempts += 1
        self.hosts[host_id].guest_id = guest_id
        self.reliability.record_assignment(host_id)
        restore_from = None
        if self.continuity_enabled and self.snapshots.locations(job.job_id):
            restore_from = self.snapshots.restore_source(
                job.job_id,
                available=set(self.availability.available_hosts()),
                reliability_rank=self.reliability.ranked(),
            )
        if restore_from is not None:
            job.restores += 1
            self._push_cmd(host_id, Command(
                "restore",
                dict(job_id=job.job_id, guest_id=guest_id,
                     source=restore_from),
            ))
            # paper: after restore, the other replicas are deleted
            for h in self.snapshots.forget(job.job_id):
                if h != restore_from:
                    self._push_cmd(h, Command(
                        "delete_snapshot", dict(job_id=job.job_id)))
        else:
            if job.attempts > 1:
                job.restarts_from_zero += 1
            self._push_cmd(host_id, Command(
                "start_guest",
                dict(job_id=job.job_id, guest_id=guest_id,
                     payload=job.payload),
            ))
        self._emit(now, "job_assigned", job=job.job_id, host=host_id,
                   restored=restore_from is not None)

    # ----------------------------------------------------------- client API
    def poll(
        self,
        host_id: str,
        now: float,
        *,
        load: float = 0.0,
        guest_ok: bool = True,
        storage_used: int = 0,
    ) -> PollResponse:
        """Handle a periodic client poll (§III-C).

        Returns the peer list (for P2P snapshot placement) and pending
        commands. ``guest_ok=False`` reports a guest failure detected by
        the client's 10-second probe.
        """
        self.availability.record_poll(host_id, now)
        self.reliability.record_load(host_id, load)
        self.reliability.record_storage(host_id, storage_used)
        if not guest_ok and self.hosts[host_id].guest_id is not None:
            self._on_guest_failure(host_id, now)
        # advertise available peers that still have storage headroom
        peers = [
            (h, self.reliability.reliability(h),
             self.reliability.failure_probability(h))
            for h in self.availability.available_hosts()
            if h != host_id and not self.reliability.get(h).storage_full()
        ]
        cmds = self._outbox.pop(host_id, [])
        self.schedule(now)
        return PollResponse(peers=peers, commands=cmds)

    def snapshot_policy(self, host_id: str) -> tuple[list[str], set[str], set[str], set[str]]:
        """Inputs the client's P2P snapshot component needs for placement:
        (cloudlet peers, in_use, available, storage_full)."""
        info = self.hosts[host_id]
        peers: list[str] = []
        for cl in info.cloudlets:
            peers.extend(self.cloudlets.peers(cl, host_id))
        peers = sorted(set(peers))
        in_use = {h for h, i in self.hosts.items() if i.guest_id is not None}
        available = set(self.availability.available_hosts())
        storage_full = {
            h for h in self.hosts if self.reliability.get(h).storage_full()
        }
        return peers, in_use, available, storage_full

    def report_snapshot(
        self,
        host_id: str,
        job_id: str,
        receivers: list[str],
        joint_failure: float,
        size_bytes: int,
        now: float,
    ) -> None:
        """Client informs the server of receiving hosts (§III-D)."""
        self.snapshots.record_placement(
            job_id, receivers, joint_failure, size_bytes=size_bytes, now=now
        )
        for r in receivers:
            rec = self.reliability.get(r)
            rec.storage_used += size_bytes
        self._emit(now, "snapshot_placed", job=job_id, host=host_id,
                   receivers=receivers, joint=joint_failure)

    def report_completion(self, host_id: str, job_id: str, now: float) -> None:
        job = self.jobs[job_id]
        job.state = JobState.COMPLETED
        job.completed_at = now
        self.reliability.record_completion(host_id)
        info = self.hosts[host_id]
        if info.guest_id == job.guest_id:
            info.guest_id = None
        self.forget_snapshots(job_id)
        self._emit(now, "job_completed", job=job_id, host=host_id)
        self.schedule(now)

    def report_suspend(self, host_id: str, now: float, suspended: bool) -> None:
        """Client suspended/resumed its guest due to host-user interference
        (§III-C Resource Monitor)."""
        self.hosts[host_id].suspended = suspended
        self._emit(now, "guest_suspended" if suspended else "guest_resumed",
                   host=host_id)

    # ------------------------------------------------------ failure handling
    def tick(self, now: float) -> list[str]:
        """Run the availability_checker sweep; handle newly failed hosts."""
        failed = self.availability.check(now)
        for h in failed:
            self._on_host_failure(h, now)
        if failed:
            self.schedule(now)
        return failed

    def host_returned(self, host_id: str, now: float) -> None:
        """A previously failed host polls again (comes back UP).

        Covers the fast-reboot case too: if the host went down and came
        back *within* the 2-minute window, the availability checker never
        fired, but the guest died with the host — the returning client's
        state (no VM running) reveals it, and the job is rescheduled as a
        guest failure.
        """
        info = self.hosts.get(host_id)
        if info is not None and info.guest_id is not None:
            # guest lost in the outage but failure not yet detected
            self.reliability.record_guest_failure(host_id)
            self._emit(now, "guest_lost_on_reboot", host=host_id)
            self._reschedule_job_of(host_id, now)
        self.availability.record_poll(host_id, now)
        self._down.discard(host_id)     # a fresh DOWN episode may begin
        if info is not None:
            info.guest_id = None       # its guest died with the failure
            info.suspended = False
            info.vm_ready = True
        self.schedule(now)

    def report_host_failure(self, host_id: str, now: float) -> None:
        """Explicit failure/leave report (e.g. a host-user reclaims their
        machine). Safe to race the availability sweep: the handler is
        idempotent per DOWN episode."""
        self.availability.mark_failed(host_id)
        self._on_host_failure(host_id, now)
        self.schedule(now)

    def _on_host_failure(self, host_id: str, now: float) -> None:
        if host_id in self._down:
            # already handled this DOWN episode: a second report (explicit
            # report + sweep, or duplicated sweep) must not double-count
            # the failure, re-revoke leases, or re-queue the job again
            return
        self._down.add(host_id)
        self.reliability.record_host_failure(host_id)
        self.snapshots.drop_host(host_id)
        # the failed host took any KV pages it was holding for neighbors
        # with it: revoke its leases so lenders recall-miss and recompute
        # instead of waiting on a dead peer (churn-safe spill, §III-B)
        revoked = self.cloudlets.leases.invalidate_holder(host_id)
        if revoked:
            self._emit(now, "page_leases_revoked", host=host_id,
                       leases=len(revoked))
        info = self.hosts.get(host_id)
        self._emit(now, "host_failed", host=host_id)
        if info and info.guest_id is not None:
            self._reschedule_job_of(host_id, now)
            info.guest_id = None
        for master in self._batch_masters:
            master.on_host_failure(host_id, now)

    def _on_guest_failure(self, host_id: str, now: float) -> None:
        self.reliability.record_guest_failure(host_id)
        self._emit(now, "guest_failed", host=host_id)
        self._reschedule_job_of(host_id, now)
        self.hosts[host_id].guest_id = None

    def _reschedule_job_of(self, host_id: str, now: float) -> None:
        job = next(
            (
                j for j in self.jobs.values()
                if j.assigned_host == host_id and j.state == JobState.RUNNING
            ),
            None,
        )
        if job is None:
            return
        if job.attempts >= self.max_job_attempts:
            job.state = JobState.FAILED
            self._emit(now, "job_failed_permanently", job=job.job_id)
            return
        job.state = JobState.QUEUED
        job.assigned_host = None
        job.guest_id = None
        self.schedule(now)

    # ------------------------------------------------------------ status API
    def job_status(self, job_id: str) -> dict | None:
        """Uniform job-status lookup: cloud jobs (:class:`CloudJob`) and
        batch-inference jobs answer through the same API."""
        job = self.jobs.get(job_id)
        if job is not None:
            return {
                "job_id": job.job_id, "kind": "cloud",
                "state": job.state.value, "cloudlet": job.cloudlet,
                "assigned_host": job.assigned_host,
                "attempts": job.attempts, "restores": job.restores,
                "restarts_from_zero": job.restarts_from_zero,
            }
        for master in self._batch_masters:
            status = getattr(master, "job_status", lambda _jid: None)(job_id)
            if status is not None:
                return status
        return None

    def forget_snapshots(self, guest_id: str, *, keep: str | None = None
                         ) -> None:
        """Drop every stored replica of ``guest_id``'s snapshot and tell
        the holders to delete their copy (§III-D cleanup, shared by job
        completion and workunit validation)."""
        for h in self.snapshots.forget(guest_id):
            if h != keep:
                self._push_cmd(h, Command(
                    "delete_snapshot", dict(job_id=guest_id)))

    # ----------------------------------------------------- state replication
    def to_state(self) -> dict:
        """Serializable server state (for replication / failover)."""
        return {
            "reliability": self.reliability.to_state(),
            "availability": self.availability.to_state(),
            "cloudlets": self.cloudlets.to_state(),
            "snapshots": self.snapshots.to_state(),
            "jobs": {
                j.job_id: dict(
                    cloudlet=j.cloudlet, work_units=j.work_units,
                    submitted_at=j.submitted_at, state=j.state.value,
                    assigned_host=j.assigned_host, guest_id=j.guest_id,
                    attempts=j.attempts,
                    restarts_from_zero=j.restarts_from_zero,
                    restores=j.restores, completed_at=j.completed_at,
                )
                for j in self.jobs.values()
            },
            "hosts": {
                h: dict(cloudlets=i.cloudlets, vm_ready=i.vm_ready,
                        guest_id=i.guest_id, suspended=i.suspended)
                for h, i in self.hosts.items()
            },
        }

    @classmethod
    def from_state(cls, state: dict, **kw) -> "AdHocServer":
        srv = cls(**kw)
        srv.reliability = ReliabilityRegistry.from_state(state["reliability"])
        srv.availability = AvailabilityChecker.from_state(state["availability"])
        srv.cloudlets = CloudletRegistry.from_state(state["cloudlets"])
        srv.snapshots = SnapshotScheduler.from_state(state["snapshots"])
        for job_id, kv in state["jobs"].items():
            srv.jobs[job_id] = CloudJob(
                job_id=job_id, cloudlet=kv["cloudlet"],
                work_units=kv["work_units"], submitted_at=kv["submitted_at"],
                state=JobState(kv["state"]), assigned_host=kv["assigned_host"],
                guest_id=kv["guest_id"], attempts=kv["attempts"],
                restarts_from_zero=kv["restarts_from_zero"],
                restores=kv["restores"], completed_at=kv["completed_at"],
            )
        srv._job_counter = itertools.count(len(srv.jobs))
        for h, kv in state["hosts"].items():
            srv.hosts[h] = HostInfo(h, **kv)
        # hosts already down in the replicated availability state have had
        # their failure handled by the primary: don't re-handle on takeover
        srv._down = {
            h for h in srv.hosts if not srv.availability.is_available(h)
        }
        return srv

    # ---------------------------------------------------------------- stats
    def completion_stats(self) -> dict:
        jobs = list(self.jobs.values())
        done = [j for j in jobs if j.state == JobState.COMPLETED]
        return {
            "submitted": len(jobs),
            "completed": len(done),
            "completion_rate": (len(done) / len(jobs)) if jobs else 1.0,
            "restores": sum(j.restores for j in jobs),
            "restarts_from_zero": sum(j.restarts_from_zero for j in jobs),
            "attempts": sum(j.attempts for j in jobs),
        }
