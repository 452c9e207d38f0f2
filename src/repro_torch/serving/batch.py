"""Verified batch-inference tier: BOINC-style workunits over the cloudlet.

The interactive :class:`~repro_torch.serving.engine.ServeEngine` assumes its
host survives the request. The source paper's premise is the opposite —
harvest *sporadically available, unreliable* hosts — and BOINC's answer
is **redundant workunits + quorum validation + transitioner re-issue**
(Anderson, *BOINC: A Platform for Volunteer Computing*). This module
applies that answer to batch inference:

- :class:`BatchMaster` accepts jobs of N prompts and shards them into
  **page-aligned workunits**: prompts are packed greedily until the
  pages a workunit's prompts reserve (prompt + ``max_new_tokens``,
  rounded up to whole KV pages) reach ``wu_pages``, so every workunit
  fits a worker engine's page pool by construction.
- Each workunit is **replicated** onto ``replication`` distinct cloudlet
  hosts — ranked by the §III-B reliability table, never two replicas of
  the same workunit on one host — and executed through a fresh
  :class:`~repro_torch.serving.engine.ServeEngine` with greedy exact decode.
- Results validate by **bitwise hash quorum**: a replica's result is the
  digest of its token ids; ``min_quorum`` matching digests make the
  result canonical. Exact greedy decode is what makes bitwise agreement
  attainable — replicas of the same workunit produce identical tokens
  on any host, so a single flipped token is outvoted, not averaged.
- A **transitioner** pass (:meth:`BatchMaster.tick`) re-issues workunits
  on host failure/leave (the server's §III-A availability sweep calls
  :meth:`on_host_failure`), on deadline timeout, and on quorum mismatch
  — with per-workunit exponential backoff. Hosts that repeatedly return
  non-canonical digests are penalized through
  :meth:`~repro_torch.core.reliability.ReliabilityRegistry.record_corrupt_result`
  (reliability drops + error quarantine), so placement routes away from
  them.
- Workunits **migrate instead of restarting**: active replicas
  periodically snapshot their engine and place the blob by the paper's
  §III-D receiver-selection rule (via the server's
  :class:`~repro_torch.core.snapshot.SnapshotScheduler`); a re-issue whose
  snapshot still has a live holder restores it and continues decoding
  mid-stream — greedy decode makes the continuation bitwise identical,
  so migrated replicas still reach quorum.
- The master **degrades gracefully**: a workunit that exhausts
  ``max_wu_attempts`` is marked failed and the job completes *partial*,
  surfacing per-workunit status (:meth:`job_status`) and per-prompt
  results with ``None`` holes (:meth:`results`) instead of failing the
  whole job.

Fault injection is first-class: a :class:`FaultPlan` is a seeded trace of
host-crash / slow-host / corrupt-result events over the
:class:`~repro_torch.core.simulation.SimClock` timeline, applied by
:meth:`BatchMaster.run` — crashes silence a host's polls (the 2-minute
rule detects it), slowness stretches its decode until deadlines fire,
corruption flips a token in its reported result so quorum outvotes it.
Robustness is therefore *tested deterministically* (see
``benchmarks/batch_bench.py --batch-churn`` and ``tests/test_batch.py``),
not asserted.

Ported from ``repro/serving/batch.py``: everything but
:func:`make_engine_factory` is the reference's code, with its
cross-references naming the port's modules. Its replicas are the
port's paged engines; bitwise quorum holds on the card because a
lane's bits do not depend on its neighbours in the batch (the paged
decode kernel's fixed key segments, ``gemm_rows``' row-invariant
products, and a prefill per slot).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import zlib
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable

from repro_torch import resolve_device
from repro_torch.core.backoff import JitteredBackoff
from repro_torch.core.faults import FaultEvent, FaultPlan  # noqa: F401  (re-export:
# FaultPlan grew up here before moving to core.faults; importers keep working)
from repro_torch.core.server import AdHocServer
from repro_torch.core.simulation import SimClock
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.kvcache import pages_needed
from repro_torch.serving.scheduler import SchedulerConfig

EngineFactory = Callable[[str], ServeEngine]


def make_engine_factory(model, params, **engine_kwargs) -> EngineFactory:
    """Factory of identical per-replica engines over one set of weights.

    Every replica runs in a fresh :class:`ServeEngine` (isolated cache,
    deterministic request ids 0..k-1 so a restored snapshot maps back to
    its workunit's prompts), built with the same ``engine_kwargs``: the
    same ``n_slots``, ``page_size`` and ``n_pages``, so a snapshot of one
    replica restores into another. The engines share the one ``params``
    module and the one ``model`` (:class:`ModelFns`): the weights sit on
    the device once, not once per replica (``ServeEngine`` checks their
    device and copies nothing). The JAX package's factory
    (``repro/serving/batch.py:78-108``) shares its engines' jitted
    functions instead; the port has nothing to compile.

    Like every entry point of the port, the engines run on ``cuda``
    unless ``device="cpu"`` is passed; asked for ``cuda`` without a card,
    the factory raises here, and so would each engine.

    Batch replicas default to the *synchronous* scheduler: a workunit is
    decoded for throughput and validated by hash quorum — whole-prompt
    admission maximizes tokens per step and keeps the step-count timeout
    accounting stable. The interactive tiers (engine default, cell) own
    continuous batching; pass ``scheduler=`` to override.
    """
    engine_kwargs.setdefault("scheduler",
                             SchedulerConfig(token_budget=None))
    engine_kwargs["device"] = resolve_device(
        engine_kwargs.get("device", "cuda"))

    def factory(host_id: str) -> ServeEngine:
        del host_id  # identical engines; the id is placement metadata
        return ServeEngine(model, params, **engine_kwargs)

    return factory


def result_digest(outputs: list[list[int]]) -> str:
    """Bitwise token-id digest of one replica's workunit result."""
    blob = json.dumps([[int(t) for t in toks] for toks in outputs])
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


# --------------------------------------------------------------------------
# workunits
# --------------------------------------------------------------------------

class WuState(str, Enum):
    PENDING = "pending"        # waiting for (re)placement
    ACTIVE = "active"          # at least one replica running
    VALIDATED = "validated"    # canonical result reached quorum
    FAILED = "failed"          # attempts exhausted; job degrades

_TERMINAL = (WuState.VALIDATED, WuState.FAILED)


@dataclass
class Assignment:
    """One replica of a workunit running on one host."""

    host: str
    engine: ServeEngine
    reqs: list[Request]
    issued_at: float
    deadline: float
    base_tokens: int = 0       # tokens already in the restored snapshot
    credit: float = 0.0        # fractional decode steps carried over
    last_snapshot: float = 0.0
    resumed: bool = False

    def tokens_done(self) -> int:
        return sum(len(r.generated) for r in self.reqs)

    def new_tokens(self) -> int:
        """Tokens this replica decoded itself (excludes snapshot carry)."""
        return self.tokens_done() - self.base_tokens

    def done(self) -> bool:
        return all(r.done for r in self.reqs)


@dataclass
class Workunit:
    wu_id: str
    job_id: str
    prompt_ids: list[int]           # indices into the job's prompt list
    prompts: list[list[int]]
    max_new_tokens: int
    replication: int
    min_quorum: int
    state: WuState = WuState.PENDING
    active: list[Assignment] = field(default_factory=list)
    # digest -> hosts that reported it / the tokens behind it
    results: dict[str, list[str]] = field(default_factory=dict)
    result_tokens: dict[str, list[list[int]]] = field(default_factory=dict)
    hosts_done: set[str] = field(default_factory=set)
    hosts_rejected: set[str] = field(default_factory=set)  # outvoted digests
    canonical: str | None = None
    attempts: int = 0               # replicas ever issued
    backoff: JitteredBackoff | None = None
    next_issue_at: float = 0.0
    reissue_cause: str | None = None   # crash | timeout | quorum
    completed_at: float | None = None

    def best_count(self) -> int:
        return max((len(h) for h in self.results.values()), default=0)

    def pages(self, page_size: int) -> int:
        return sum(
            pages_needed(len(p) + self.max_new_tokens, page_size)
            for p in self.prompts
        )


@dataclass
class BatchJob:
    job_id: str
    prompts: list[list[int]]
    max_new_tokens: int
    wu_ids: list[str]
    submitted_at: float
    state: str = "running"          # running | completed | partial
    completed_at: float | None = None


# --------------------------------------------------------------------------
# the master
# --------------------------------------------------------------------------

class BatchMaster:
    """Master side of the batch tier: shard, place, validate, re-issue.

    Composes the ad hoc server's primitives — cloudlet membership for the
    placement scope, the reliability registry for ranking and quarantine,
    the availability checker for failure detection, and the snapshot
    scheduler for workunit migration. Registering the master
    (:meth:`AdHocServer.register_batch_master`) wires the server's
    ``_on_host_failure`` into workunit re-issue and its ``job_status``
    API into batch jobs.
    """

    def __init__(
        self,
        server: AdHocServer,
        cloudlet: str,
        engine_factory: EngineFactory,
        *,
        replication: int = 2,
        min_quorum: int = 2,
        wu_pages: int = 8,
        page_size: int = 64,
        deadline_s: float = 60.0,
        backoff_base_s: float = 2.0,
        backoff_max_s: float = 60.0,
        snapshot_every_s: float = 10.0,
        decode_step_s: float = 1.0,
        max_wu_attempts: int = 12,
    ):
        assert min_quorum >= 1 and replication >= min_quorum, (
            replication, min_quorum)
        self.server = server
        self.cloudlet = cloudlet
        self.engine_factory = engine_factory
        self.replication = replication
        self.min_quorum = min_quorum
        self.wu_pages = wu_pages
        self.page_size = page_size
        self.deadline_s = deadline_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.snapshot_every_s = snapshot_every_s
        self.decode_step_s = decode_step_s
        self.max_wu_attempts = max_wu_attempts

        self.jobs: dict[str, BatchJob] = {}
        self.wus: dict[str, Workunit] = {}
        self._job_counter = itertools.count()
        self._host_busy: dict[str, str] = {}       # host -> wu_id
        self._wu_blobs: dict[str, tuple[bytes, int]] = {}  # wu -> (blob, toks)
        # fault-injection state (driven by a FaultPlan through run())
        self._crashed: set[str] = set()
        self._slow: dict[str, float] = {}
        self._corrupt_budget: dict[str, int] = {}
        self.stats = {
            "workunits": 0,
            "validated": 0,
            "failed_workunits": 0,
            "results_received": 0,
            "reissued": 0,              # total replicas beyond the initial
            "reissued_crash": 0,
            "reissued_timeout": 0,
            "reissued_quorum": 0,
            "quorum_rejections": 0,     # results outvoted by the quorum
            "timeouts": 0,              # replicas cancelled past deadline
            "crash_cancellations": 0,   # replicas lost to host failure
            "resumed_from_snapshot": 0,
            "snapshots_placed": 0,
            "useful_tokens": 0,         # decoded by canonical-digest replicas
            "wasted_tokens": 0,         # decoded by everything else
        }
        server.register_batch_master(self)

    # ------------------------------------------------------------ submission
    def submit(
        self,
        prompts: list[list[int]],
        *,
        max_new_tokens: int,
        now: float,
        replication: int | None = None,
        min_quorum: int | None = None,
    ) -> str:
        """Shard a job of prompts into page-aligned workunits and queue
        them for placement (the next :meth:`tick` places replicas)."""
        assert prompts, "empty job"
        repl = self.replication if replication is None else replication
        quorum = self.min_quorum if min_quorum is None else min_quorum
        assert quorum >= 1 and repl >= quorum, (repl, quorum)
        job_id = f"batch{next(self._job_counter):04d}"
        wu_ids: list[str] = []
        shard_ids: list[int] = []
        pages = 0
        for i, p in enumerate(prompts):
            need = pages_needed(len(p) + max_new_tokens, self.page_size)
            if shard_ids and pages + need > self.wu_pages:
                wu_ids.append(self._make_wu(
                    job_id, len(wu_ids), shard_ids, prompts,
                    max_new_tokens, repl, quorum))
                shard_ids, pages = [], 0
            shard_ids.append(i)
            pages += need
        wu_ids.append(self._make_wu(job_id, len(wu_ids), shard_ids, prompts,
                                    max_new_tokens, repl, quorum))
        self.jobs[job_id] = BatchJob(
            job_id=job_id, prompts=[list(p) for p in prompts],
            max_new_tokens=max_new_tokens, wu_ids=wu_ids, submitted_at=now,
        )
        self.server._emit(now, "batch_job_submitted", job=job_id,
                          workunits=len(wu_ids))
        return job_id

    def _make_wu(self, job_id, idx, shard_ids, prompts, max_new, repl,
                 quorum) -> str:
        wu_id = f"{job_id}/wu{idx:03d}"
        self.wus[wu_id] = Workunit(
            wu_id=wu_id, job_id=job_id, prompt_ids=list(shard_ids),
            prompts=[list(prompts[i]) for i in shard_ids],
            max_new_tokens=max_new, replication=repl, min_quorum=quorum,
        )
        self.stats["workunits"] += 1
        return wu_id

    # ------------------------------------------------------------ status API
    def job_status(self, job_id: str) -> dict | None:
        """Per-workunit status of a batch job (None if unknown — the
        server's :meth:`~AdHocServer.job_status` falls through)."""
        job = self.jobs.get(job_id)
        if job is None:
            return None
        wus = {}
        for wid in job.wu_ids:
            wu = self.wus[wid]
            wus[wid] = {
                "state": wu.state.value,
                "prompts": len(wu.prompts),
                "attempts": wu.attempts,
                "active_hosts": sorted(a.host for a in wu.active),
                "results": {d: sorted(h) for d, h in wu.results.items()},
                "canonical": wu.canonical,
            }
        done = sum(self.wus[w].state == WuState.VALIDATED for w in job.wu_ids)
        return {
            "job_id": job_id, "kind": "batch", "state": job.state,
            "validated": done,
            "failed": sum(self.wus[w].state == WuState.FAILED
                          for w in job.wu_ids),
            "total": len(job.wu_ids),
            "workunits": wus,
        }

    def results(self, job_id: str) -> list[list[int] | None]:
        """Per-prompt canonical outputs; ``None`` where the workunit
        failed (graceful degradation: partial results, never an
        all-or-nothing job failure)."""
        job = self.jobs[job_id]
        out: list[list[int] | None] = [None] * len(job.prompts)
        for wid in job.wu_ids:
            wu = self.wus[wid]
            if wu.canonical is None:
                continue
            toks = wu.result_tokens[wu.canonical]
            for pid, t in zip(wu.prompt_ids, toks):
                out[pid] = list(t)
        return out

    def unfinished(self) -> int:
        return sum(j.state == "running" for j in self.jobs.values())

    # ----------------------------------------------------- failure handling
    def on_host_failure(self, host_id: str, now: float) -> None:
        """Server-detected host failure/leave: the replica it was running
        is lost; schedule a re-issue (the server already penalized the
        host's reliability and dropped its snapshot replicas)."""
        self._host_busy.pop(host_id, None)
        for wu in self.wus.values():
            lost = [a for a in wu.active if a.host == host_id]
            for a in lost:
                self._cancel(wu, a, now, cause="crash")
                self.stats["crash_cancellations"] += 1
            if lost and wu.state not in _TERMINAL:
                self._schedule_reissue(wu, now, cause="crash")

    def _cancel(self, wu: Workunit, a: Assignment, now: float, *,
                cause: str) -> None:
        wu.active.remove(a)
        if self._host_busy.get(a.host) == wu.wu_id:
            del self._host_busy[a.host]
        info = self.server.hosts.get(a.host)
        if info is not None and info.guest_id == f"wu:{wu.wu_id}":
            info.guest_id = None
        self.stats["wasted_tokens"] += a.new_tokens()
        self.server._emit(now, "workunit_replica_cancelled", wu=wu.wu_id,
                          host=a.host, cause=cause)

    def _schedule_reissue(self, wu: Workunit, now: float, *,
                          cause: str) -> None:
        """Exponential backoff before the transitioner may place fresh
        replicas of this workunit."""
        if wu.backoff is None:
            wu.backoff = JitteredBackoff(self.backoff_base_s,
                                         self.backoff_max_s)
        wu.next_issue_at = max(wu.next_issue_at, now + wu.backoff.next_delay())
        wu.reissue_cause = cause
        if wu.state == WuState.ACTIVE and not wu.active:
            wu.state = WuState.PENDING

    # ------------------------------------------------------- the transitioner
    def tick(self, now: float, dt: float = 0.0) -> None:
        """One transitioner pass: advance replicas by ``dt`` of simulated
        time, collect finished results into the quorum, cancel replicas
        past their deadline, (re)place replicas, finalize jobs."""
        if dt:
            self._advance(now, dt)
        self._check_deadlines(now)
        self._place(now)
        self._finalize_jobs(now)

    def _advance(self, now: float, dt: float) -> None:
        for wu in list(self.wus.values()):
            for a in list(wu.active):
                if a not in wu.active:
                    # cancelled mid-pass: a sibling replica just completed
                    # the quorum and superseded this one
                    continue
                if a.host in self._crashed:
                    continue  # dead host: no progress until detected
                slow = self._slow.get(a.host, 1.0)
                a.credit += dt / (self.decode_step_s * slow)
                steps = int(a.credit)
                a.credit -= steps
                for _ in range(steps):
                    if not a.engine.pending():
                        break
                    a.engine.step()
                if a.done():
                    self._collect(wu, a, now)
                elif (now - a.last_snapshot >= self.snapshot_every_s
                        and a.new_tokens() > 0):
                    self._snapshot_replica(wu, a, now)

    def _collect(self, wu: Workunit, a: Assignment, now: float) -> None:
        """A replica finished: fold its digest into the quorum."""
        wu.active.remove(a)
        if self._host_busy.get(a.host) == wu.wu_id:
            del self._host_busy[a.host]
        info = self.server.hosts.get(a.host)
        if info is not None and info.guest_id == f"wu:{wu.wu_id}":
            info.guest_id = None
        outputs = [list(r.generated) for r in a.reqs]
        budget = self._corrupt_budget.get(a.host, 0)
        if budget > 0:
            # fault injection: the host computed correctly but reports a
            # flipped token — exactly what hash quorum must catch. The
            # flip is host-unique so two injected corrupters never agree
            # by construction (colluding identical corruption is the known
            # BOINC redundancy limit, not what this models).
            self._corrupt_budget[a.host] = budget - 1
            flip = 1 + zlib.crc32(a.host.encode()) % 1024
            outputs[0] = [outputs[0][0] ^ flip] + outputs[0][1:]
        digest = result_digest(outputs)
        wu.hosts_done.add(a.host)
        votes = wu.results.setdefault(digest, [])
        if a.host not in votes:
            # a quorum needs *independent* confirmations: one host never
            # votes twice, however many replicas of the wu it ended up with
            votes.append(a.host)
        wu.result_tokens.setdefault(digest, outputs)
        self.stats["results_received"] += 1
        self.server._emit(now, "workunit_result", wu=wu.wu_id, host=a.host,
                          digest=digest)
        if wu.canonical is None:
            if len(wu.results[digest]) >= wu.min_quorum:
                self._validate(wu, digest, now, last_tokens=a.new_tokens())
            else:
                if len(wu.results) > 1:
                    # digests disagree and no side has quorum yet: the
                    # transitioner must issue extra replicas (quorum path)
                    self._schedule_reissue(wu, now, cause="quorum")
                self.stats["useful_tokens"] += a.new_tokens()
        elif digest == wu.canonical:
            self.stats["useful_tokens"] += a.new_tokens()
            self.server.reliability.record_completion(a.host)
        else:
            self._reject(wu, digest, now)

    def _validate(self, wu: Workunit, digest: str, now: float, *,
                  last_tokens: int) -> None:
        wu.canonical = digest
        wu.state = WuState.VALIDATED
        wu.completed_at = now
        self.stats["validated"] += 1
        self.stats["useful_tokens"] += last_tokens
        for h in wu.results[digest]:
            self.server.reliability.record_completion(h)
        for d in list(wu.results):
            if d != digest:
                self._reject(wu, d, now)
        # replicas still running are redundant now: their work is wasted
        for a in list(wu.active):
            self._cancel(wu, a, now, cause="superseded")
        self.server.forget_snapshots(f"wu:{wu.wu_id}")
        self._wu_blobs.pop(wu.wu_id, None)
        self.server._emit(now, "workunit_validated", wu=wu.wu_id,
                          digest=digest, votes=len(wu.results[digest]))

    def _reject(self, wu: Workunit, digest: str, now: float) -> None:
        """A digest lost the quorum vote: quarantine feedback for every
        host that reported it, and its decoded tokens count as waste."""
        for h in wu.results[digest]:
            if h in wu.hosts_rejected:
                continue
            wu.hosts_rejected.add(h)
            self.server.reliability.record_corrupt_result(h, now)
            self.stats["quorum_rejections"] += 1
            self.server._emit(now, "workunit_result_rejected", wu=wu.wu_id,
                              host=h, digest=digest)
        toks = wu.result_tokens.get(digest)
        if toks is not None:
            self.stats["wasted_tokens"] += sum(len(t) for t in toks)

    def _check_deadlines(self, now: float) -> None:
        for wu in self.wus.values():
            if wu.state in _TERMINAL:
                continue
            overdue = [a for a in wu.active if now > a.deadline]
            for a in overdue:
                self._cancel(wu, a, now, cause="timeout")
                self.stats["timeouts"] += 1
                # a no-reply is a guest failure in the reliability table —
                # slow hosts drift down the placement ranking
                self.server.reliability.record_guest_failure(a.host)
            if overdue:
                self._schedule_reissue(wu, now, cause="timeout")

    # --------------------------------------------------------------- placing
    def _candidates(self, wu: Workunit, now: float) -> list[str]:
        """Placement pool for one more replica of ``wu``: available,
        unquarantined cloudlet members with no guest, excluding hosts
        already running a replica of this workunit and hosts whose digest
        was rejected; hosts that already reported stay last-resort (a
        quorum needs *independent* confirmations)."""
        members = self.server.cloudlets.members(self.cloudlet)
        rel = self.server.reliability
        running = {a.host for a in wu.active}
        pool = [
            h for h in members
            if self.server.availability.is_available(h)
            and not rel.is_quarantined(h, now)
            and h not in self._host_busy
            and self.server.hosts.get(h) is not None
            and self.server.hosts[h].guest_id is None
            and not self.server.hosts[h].suspended
            and h not in running
            and h not in wu.hosts_rejected
        ]
        fresh = [h for h in pool if h not in wu.hosts_done]
        return rel.ranked(fresh if fresh else pool)

    def _needed(self, wu: Workunit) -> int:
        if wu.state in _TERMINAL:
            return 0
        if not wu.attempts:
            return wu.replication
        return max(0, wu.min_quorum - wu.best_count() - len(wu.active))

    def _place(self, now: float) -> None:
        for wu in sorted(self.wus.values(), key=lambda w: w.wu_id):
            need = self._needed(wu)
            if not need or now < wu.next_issue_at:
                continue
            for _ in range(need):
                if wu.attempts >= self.max_wu_attempts:
                    # graceful degradation: give up on this workunit, the
                    # job completes *partial* with per-wu status instead
                    # of burning the cloudlet forever
                    self._fail_wu(wu, now)
                    break
                cands = self._candidates(wu, now)
                if not cands:
                    break  # retry next tick; churn may free hosts
                self._issue(wu, cands[0], now)

    def _fail_wu(self, wu: Workunit, now: float) -> None:
        wu.state = WuState.FAILED
        wu.completed_at = now
        self.stats["failed_workunits"] += 1
        for a in list(wu.active):
            self._cancel(wu, a, now, cause="failed")
        self.server.forget_snapshots(f"wu:{wu.wu_id}")
        self._wu_blobs.pop(wu.wu_id, None)
        self.server._emit(now, "workunit_failed", wu=wu.wu_id,
                          attempts=wu.attempts)

    def _issue(self, wu: Workunit, host: str, now: float) -> None:
        engine = self.engine_factory(host)
        resumed = False
        stored = self._wu_blobs.get(wu.wu_id)
        if stored is not None:
            # migrate instead of restarting: restore the most advanced
            # snapshot if any §III-D receiver of it is still alive
            source = self.server.snapshots.restore_source(
                f"wu:{wu.wu_id}",
                available=set(self.server.availability.available_hosts()),
                reliability_rank=self.server.reliability.ranked(),
            )
            if source is not None:
                engine.restore(stored[0])
                resumed = True
        if resumed:
            reqs = [engine.requests[i] for i in range(len(wu.prompts))]
            self.stats["resumed_from_snapshot"] += 1
        else:
            reqs = [engine.submit(p, max_new_tokens=wu.max_new_tokens)
                    for p in wu.prompts]
        a = Assignment(
            host=host, engine=engine, reqs=reqs, issued_at=now,
            deadline=now + self.deadline_s,
            base_tokens=sum(len(r.generated) for r in reqs),
            last_snapshot=now, resumed=resumed,
        )
        wu.active.append(a)
        wu.attempts += 1
        if wu.state == WuState.PENDING:
            wu.state = WuState.ACTIVE
        self._host_busy[host] = wu.wu_id
        self.server.hosts[host].guest_id = f"wu:{wu.wu_id}"
        self.server.reliability.record_assignment(host)
        if wu.attempts > wu.replication:
            self.stats["reissued"] += 1
            cause = wu.reissue_cause or "quorum"
            self.stats[f"reissued_{cause}"] += 1
        self.server._emit(now, "workunit_issued", wu=wu.wu_id, host=host,
                          attempt=wu.attempts, resumed=resumed)

    # ------------------------------------------------------------- snapshots
    def _snapshot_replica(self, wu: Workunit, a: Assignment,
                          now: float) -> None:
        """Periodic engine snapshot, placed by the paper's §III-D rule so
        a re-issued replica can continue mid-stream."""
        a.last_snapshot = now
        stored = self._wu_blobs.get(wu.wu_id)
        if stored is not None and a.tokens_done() <= stored[1]:
            return  # a more advanced snapshot already exists
        peers, in_use, available, storage_full = \
            self.server.snapshot_policy(a.host)
        receivers, joint = self.server.snapshots.place(
            a.host, peers,
            {h: self.server.reliability.failure_probability(h)
             for h in peers},
            in_use=in_use, available=available, storage_full=storage_full,
        )
        if not receivers:
            return  # every peer busy/full: keep decoding, try next period
        blob = a.engine.snapshot()
        self.server.report_snapshot(
            a.host, f"wu:{wu.wu_id}", receivers, joint, len(blob), now)
        self._wu_blobs[wu.wu_id] = (blob, a.tokens_done())
        self.stats["snapshots_placed"] += 1

    # ------------------------------------------------------------ job finish
    def _finalize_jobs(self, now: float) -> None:
        for job in self.jobs.values():
            if job.state != "running":
                continue
            states = [self.wus[w].state for w in job.wu_ids]
            if all(s in _TERMINAL for s in states):
                job.state = ("completed"
                             if all(s == WuState.VALIDATED for s in states)
                             else "partial")
                job.completed_at = now
                self.server._emit(now, "batch_job_done", job=job.job_id,
                                  state=job.state)

    # ------------------------------------------------------------ simulation
    def run(
        self,
        clock: SimClock,
        *,
        fault_plan: FaultPlan | None = None,
        tick_s: float = 1.0,
        max_ticks: int = 100_000,
    ) -> dict:
        """Drive the whole tier on a :class:`SimClock` until every job is
        terminal: apply due fault events, poll for live hosts (crashed
        ones fall silent so the 2-minute rule catches them), sweep
        availability, run one transitioner pass per tick. Returns a
        summary dict (stats + final job states)."""
        started = clock.now()
        for _ in range(max_ticks):
            if not self.unfinished():
                break
            now = clock.now()
            for ev in fault_plan.due(now) if fault_plan else []:
                if ev.kind == "crash":
                    self._crashed.add(ev.host)
                elif ev.kind == "slow":
                    self._slow[ev.host] = ev.factor
                elif ev.kind == "corrupt":
                    self._corrupt_budget[ev.host] = (
                        self._corrupt_budget.get(ev.host, 0) + ev.count)
                elif ev.kind == "rejoin":
                    self._crashed.discard(ev.host)
                    self._slow.pop(ev.host, None)
                    if ev.host in self.server.hosts:
                        self.server.host_returned(ev.host, now)
                self.server._emit(now, "fault_injected", kind=ev.kind,
                                  host=ev.host)
            for h in self.server.cloudlets.members(self.cloudlet):
                if h not in self._crashed and h in self.server.hosts:
                    self.server.poll(h, now)
            self.server.tick(now)
            self.tick(now, tick_s)
            clock.advance(tick_s)
        useful = self.stats["useful_tokens"]
        wasted = self.stats["wasted_tokens"]
        elapsed = clock.now() - started
        return {
            "elapsed_s": elapsed,
            "goodput_tok_s": (useful / elapsed) if elapsed else 0.0,
            "wasted_work_fraction": (
                wasted / (useful + wasted) if useful + wasted else 0.0),
            "jobs": {j.job_id: j.state for j in self.jobs.values()},
            **self.stats,
        }
