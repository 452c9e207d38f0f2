"""Elastic tensor-parallel serving cell: one logical engine, many
unreliable hosts.

The paper's thesis applied to inference: an ad hoc cloudlet serves a
model bigger than any one member by running a single logical
:class:`~repro_torch.serving.engine.ServeEngine` **tensor-parallel**
across N reliability-ranked hosts — params and the paged KV pool laid out
by the partition rule engine (:mod:`repro_torch.parallel.partition`; KV
shards over ``kv_heads`` when divisible, else over the ``pages`` fallback
dim) on the ``(data, model)`` grid that :func:`plan_elastic_mesh` picks
for the surviving device count. Losing a host mid-decode degrades the
grid instead of killing the stream.

Failure detection has two sources with different deadlines:

- the **per-step collective deadline** (``step_deadline_s``): a decode
  step is an all-reduce over every member, so a silent host stalls the
  collective within one step — the cell reports the failure to the
  server (:meth:`~repro_torch.core.server.AdHocServer.report_host_failure`)
  long before the §III-A 2-minute availability rule would fire. A host
  whose injected slowdown stretches the step past the same deadline is
  a **straggler**: evicted from the cell, penalized in the reliability
  registry, and excluded from re-placement.
- the **server failure fan-out** (the availability sweep, explicit
  leave reports, lease revocation): the cell registers as a failure
  listener, so any detection path marks it dirty.

On churn the cell runs the **re-shard protocol**: rank the surviving
candidates by reliability, re-plan the grid, re-lay-out params from the
elastic checkpoint (a host-resident full copy, :func:`gather_state`),
restore in-flight slots from the last §III-D snapshot if a receiver
survives (else restart the streams), shed the lowest-priority slots when
the survivor grid can't hold the full batch (reported ``shed``, never
silently dropped), and **replay** each stream up to its committed
frontier by teacher-forcing the committed tokens through real decode
steps (:meth:`ServeEngine.step` ``force_tokens``, keyed by engine
``req_id`` so replay is *slot-stable*: a scheduler that preempts may
reassign slots mid-replay without detaching a stream from its committed
history). Replay makes mid-stream resume exact *by construction*: a token
the client has seen is never re-sampled, so a host loss can reorder the
arithmetic underneath the stream without ever rewriting it. Re-shard
attempts back off exponentially (:class:`JitteredBackoff`) while the
cloudlet is below ``min_hosts``, and a ``rejoin`` fault/return grows the
grid back gracefully (snapshot-first, zero replay).

Ported from ``repro/serving/cell.py`` in its default, **layout-only**
mode: the logical engine computes on one device while placement, layout
(real :class:`~repro_torch.parallel.partition.PartitionSpec` trees on a
:class:`~repro_torch.parallel.partition.LayoutGrid`, also the source of
the ``reshard_bytes_moved`` accounting), detection, snapshots, shed and
replay are all real. The bytes are the port's own leaves' (bf16 where it
stores a weight in bf16), counted by the reference's rule. Placing params
and the pool on a grid of real devices (``materialize=True``) is ROADMAP
Queue 1, item 16; asked for, the cell raises.

The engines come from :func:`make_engine_factory` (or the caller's
``factory``): they run on ``cuda`` unless ``engine_kwargs`` passes
``device="cpu"``, and with the factory's scheduler, the synchronous one
unless ``engine_kwargs`` names another (the reference's docstring says
"the full continuous-batching scheduler", but its code takes the
factory's default as this one does; ROADMAP Queue 3, R7). Each re-shard
drops the old engine before the factory builds the next, so one pool is
on the device at a time. Replay holds on the card because a lane's
arithmetic does not depend on its batch (``gemm_rows`` and the per-lane
attention kernels).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

from repro_torch.checkpoint.elastic import gather_state, plan_elastic_mesh
from repro_torch.core.backoff import JitteredBackoff
from repro_torch.core.faults import FaultEvent, FaultPlan
from repro_torch.core.server import AdHocServer
from repro_torch.core.simulation import SimClock
from repro_torch.models.model_api import tree_leaves
from repro_torch.parallel.partition import (
    layout_grid,
    tree_map2,
    tree_partition_specs,
)
from repro_torch.serving.batch import EngineFactory, make_engine_factory
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.kvcache import paged_cache_partition_specs

Tree = Any

__all__ = ["CellRequest", "ElasticServeCell"]


@dataclass
class CellRequest:
    """One streaming request owned by the cell (not by any engine
    incarnation). ``committed`` is the authoritative token stream — what
    the client has received; engines come and go underneath it."""

    req_id: int
    prompt: list[int]
    max_new_tokens: int
    eos_id: int | None = None
    priority: int = 0                   # higher = shed later
    committed: list[int] = field(default_factory=list)
    engine_id: int | None = None        # id inside the current engine
    state: str = "pending"              # pending | done | shed


class ElasticServeCell:
    """A tensor-parallel serving cell over one cloudlet that survives
    host churn mid-decode. See the module docstring for the protocol."""

    def __init__(
        self,
        server: AdHocServer,
        cloudlet: str,
        model,
        params,
        *,
        engine_kwargs: dict | None = None,
        factory: EngineFactory | None = None,
        name: str = "cell0",
        model_parallel: int = 2,
        devices_per_host: int = 1,
        target_hosts: int = 4,
        min_hosts: int = 1,
        slots_per_host: int = 2,
        decode_step_s: float = 1.0,
        collective_s: float = 0.1,
        step_deadline_s: float = 4.0,
        snapshot_every_s: float = 5.0,
        reshard_fixed_s: float = 2.0,
        reshard_bw_bytes_s: float = 64e6,
        backoff_base_s: float = 1.0,
        backoff_cap_s: float = 30.0,
        backoff_jitter: float = 0.25,
        backoff_seed: int = 0,
        materialize: bool = False,
        max_replay_steps: int = 100_000,
        snapshot_fail_floor: float = 0.2,
    ):
        if model_parallel < 1 or devices_per_host < 1:
            raise ValueError((model_parallel, devices_per_host))
        if min_hosts < 1 or target_hosts < min_hosts:
            raise ValueError((min_hosts, target_hosts))
        if materialize:
            raise ValueError(
                "materialize=True (params and the paged pool placed on a "
                "grid of real devices) is not ported: the cell runs "
                "layout-only; ROADMAP Queue 1, item 16")
        self.server = server
        self.cloudlet = cloudlet
        self.model = model
        self.name = name
        self._guest = f"cell:{name}"
        self.model_parallel = model_parallel
        self.devices_per_host = devices_per_host
        self.target_hosts = target_hosts
        self.min_hosts = min_hosts
        self.slots_per_host = slots_per_host
        self.decode_step_s = decode_step_s
        self.collective_s = collective_s
        self.step_deadline_s = step_deadline_s
        self.snapshot_every_s = snapshot_every_s
        self.reshard_fixed_s = reshard_fixed_s
        self.reshard_bw_bytes_s = reshard_bw_bytes_s
        self.max_replay_steps = max_replay_steps
        self.snapshot_fail_floor = snapshot_fail_floor

        # the elastic checkpoint: a host-resident full copy of the params
        # every re-shard re-lays-out from (the cell's equivalent of the
        # paper's replicated VM image), as a tree of the specs' structure
        self.params_host = gather_state(model.param_tree(params))
        self.param_axes = model.param_axes()
        # a caller-supplied factory lets many cells (or a cell and its
        # parity reference) share one set of weights
        self._engine_kwargs = dict(engine_kwargs or {})
        # replay binds by req_id (slot-stable), so engine-level
        # preemption may reshuffle slots mid-replay without detaching a
        # stream from its committed frontier; the engines take the
        # factory's scheduler (synchronous unless engine_kwargs names one)
        self.factory: EngineFactory = factory or make_engine_factory(
            model, params, **self._engine_kwargs)
        self.engine: ServeEngine | None = None

        self.requests: dict[int, CellRequest] = {}
        self._counter = 0
        self.cell_hosts: list[str] = []
        self.grid: tuple[int, int] | None = None
        self._layout = None              # (param_specs, cache_specs)
        self._dirty = False              # membership changed: must re-shard
        self._grow = False               # a host rejoined: may grow back
        self.backoff = JitteredBackoff(backoff_base_s, backoff_cap_s,
                                       jitter=backoff_jitter,
                                       seed=backoff_seed)
        self._next_reshard_at = 0.0
        self._blob: bytes | None = None  # last placed snapshot
        self._last_snap_at = 0.0
        self._losses_accounted = 0

        # fault-injection state (driven by a FaultPlan through run())
        self.crashed: set[str] = set()
        self.slow: dict[str, float] = {}
        self.demoted: set[str] = set()   # evicted stragglers

        self.stats = {
            "resharded": 0,             # re-shards after a loss (shrink)
            "reshard_grow": 0,          # graceful grow-back re-shards
            "reshard_stalls": 0,        # below min_hosts: backed off
            "reshard_bytes_moved": 0,   # layout-diff + lost-shard bytes
            "restarts": 0,              # re-shards with no live snapshot
            "resumed_from_snapshot": 0,
            "downtime_steps": 0,        # aborted + re-shard + replay steps
            "tokens_replayed": 0,       # committed tokens teacher-forced
            "slots_shed": 0,
            "collective_timeouts": 0,
            "stragglers_evicted": 0,
            "hosts_lost": 0,
            "committed_tokens": 0,
            "snapshots_placed": 0,
        }
        server.register_failure_listener(self)

    # ------------------------------------------------------------- requests
    def submit(self, prompt: list[int], *, max_new_tokens: int = 16,
               eos_id: int | None = None, priority: int = 0) -> CellRequest:
        cr = CellRequest(self._counter, list(prompt), max_new_tokens,
                         eos_id, priority)
        self._counter += 1
        self.requests[cr.req_id] = cr
        if self.engine is not None:
            cr.engine_id = self.engine.submit(
                cr.prompt, max_new_tokens=max_new_tokens,
                eos_id=eos_id, priority=priority).req_id
        return cr

    def unfinished(self) -> int:
        return sum(r.state == "pending" for r in self.requests.values())

    def results(self) -> dict[int, dict]:
        """Final per-request report: state (``done`` / ``shed`` /
        ``pending``) and the committed stream — shed slots surface their
        partial stream, they are never silently dropped."""
        return {
            r.req_id: {"state": r.state, "priority": r.priority,
                       "tokens": list(r.committed)}
            for r in self.requests.values()
        }

    # ------------------------------------------------------------ status API
    def job_status(self, job_id: str) -> dict | None:
        if job_id != self.name:
            return None
        return {
            "job_id": self.name, "kind": "cell",
            "hosts": list(self.cell_hosts), "grid": self.grid,
            "requests": {
                str(r.req_id): {"state": r.state,
                                "committed": len(r.committed)}
                for r in self.requests.values()
            },
        }

    # ----------------------------------------------------- failure handling
    def on_host_failure(self, host_id: str, now: float) -> None:
        """Server failure fan-out (availability sweep, explicit report,
        or our own collective-deadline report): losing a member makes
        the mesh dirty; :meth:`step` runs the re-shard protocol."""
        if host_id in self.cell_hosts:
            self.cell_hosts.remove(host_id)
            self._dirty = True
            self.stats["hosts_lost"] += 1
            self.server._emit(now, "cell_host_lost", cell=self.name,
                              host=host_id)

    def apply_fault(self, ev: FaultEvent, now: float) -> None:
        if ev.kind == "crash":
            self.crashed.add(ev.host)
        elif ev.kind == "slow":
            self.slow[ev.host] = ev.factor
        elif ev.kind == "rejoin":
            self.crashed.discard(ev.host)
            self.slow.pop(ev.host, None)
            self.demoted.discard(ev.host)
            if ev.host in self.server.hosts:
                self.server.host_returned(ev.host, now)
            self._grow = True
        # "corrupt" has no cell semantics (no quorum vote to lose)
        self.server._emit(now, "fault_injected", kind=ev.kind, host=ev.host)

    # -------------------------------------------------------------- timing
    def step_time(self, slow_factor: float = 1.0) -> float:
        """One decode step: compute at the slowest member's pace plus a
        collective term that grows with the ring size."""
        n_dev = max(1, len(self.cell_hosts)) * self.devices_per_host
        return (self.decode_step_s * slow_factor
                + self.collective_s * math.log2(max(2, n_dev)))

    # ------------------------------------------------------------ lifecycle
    def step(self, clock: SimClock) -> int:
        """One cell step: re-shard if dirty (or grow if a host
        returned), else detect failures at the collective, else decode
        one token per active slot. Returns newly committed tokens."""
        now = clock.now()
        if self.engine is None or self._dirty:
            self._reshard(clock, cause="form" if self.engine is None
                          else "churn")
            return 0
        if self._grow:
            cands = self._candidates(now)
            if (len(self.cell_hosts) < self.target_hosts
                    and len(cands) > len(self.cell_hosts)):
                if self._reshard(clock, cause="grow"):
                    return 0
            else:
                self._grow = False      # nothing to grow onto

        # --- failure detection, source 1: the per-step collective deadline
        dead = [h for h in self.cell_hosts if h in self.crashed]
        if dead:
            clock.advance(self.step_deadline_s)   # the step that timed out
            self.stats["collective_timeouts"] += 1
            self.stats["downtime_steps"] += 1
            for h in dead:
                self.server._emit(now, "cell_collective_timeout",
                                  cell=self.name, host=h)
                self.server.report_host_failure(h, clock.now())
                if h in self.cell_hosts:    # report raced an earlier DOWN
                    self.on_host_failure(h, clock.now())
            return 0
        worst = max((self.slow.get(h, 1.0) for h in self.cell_hosts),
                    default=1.0)
        if self.step_time(worst) > self.step_deadline_s:
            stragglers = [h for h in self.cell_hosts
                          if self.step_time(self.slow.get(h, 1.0))
                          > self.step_deadline_s]
            clock.advance(self.step_deadline_s)
            self.stats["downtime_steps"] += 1
            for h in stragglers:
                self.demoted.add(h)
                self.stats["stragglers_evicted"] += 1
                self.server.reliability.record_guest_failure(h)
                self.cell_hosts.remove(h)
                info = self.server.hosts.get(h)
                if info is not None and info.guest_id == self._guest:
                    info.guest_id = None
                self.server._emit(now, "cell_straggler_evicted",
                                  cell=self.name, host=h,
                                  factor=self.slow.get(h, 1.0))
            self._dirty = True
            return 0

        # --- normal decode step
        if not self.engine.pending():
            return 0
        new = self._engine_step(clock)
        if (clock.now() - self._last_snap_at >= self.snapshot_every_s
                and new):
            self._place_snapshot(clock.now())
        return new

    def run(self, clock: SimClock, *, fault_plan: FaultPlan | None = None,
            max_ticks: int = 100_000) -> dict:
        """Drive the cell until every request is terminal: apply due
        faults, poll for live hosts (crashed ones fall silent), sweep
        availability, run one cell step."""
        started = clock.now()
        for _ in range(max_ticks):
            if not self.unfinished():
                break
            now = clock.now()
            for ev in (fault_plan.due(now) if fault_plan else []):
                self.apply_fault(ev, now)
            for h in self.server.cloudlets.members(self.cloudlet):
                if h not in self.crashed and h in self.server.hosts:
                    self.server.poll(h, now)
            self.server.tick(now)
            self.step(clock)
            if clock.now() <= now:      # stalled (e.g. below min_hosts)
                clock.advance(self.decode_step_s)
        elapsed = clock.now() - started
        done = sum(r.state == "done" for r in self.requests.values())
        shed = sum(r.state == "shed" for r in self.requests.values())
        eng_stats = self.engine.stats if self.engine is not None else {}
        return {
            "elapsed_s": elapsed,
            "hosts": list(self.cell_hosts),
            "grid": self.grid,
            "requests_done": done,
            "requests_shed": shed,
            "requests_pending": self.unfinished(),
            "goodput_tok_s": (self.stats["committed_tokens"] / elapsed
                              if elapsed else 0.0),
            "forced_tokens": int(eng_stats.get("forced_tokens", 0)),
            "forced_mismatches": int(eng_stats.get("forced_mismatches", 0)),
            **self.stats,
        }

    # ------------------------------------------------------------ placement
    def _candidates(self, now: float) -> list[str]:
        """Reliability-ranked placement pool: available, unquarantined,
        VM-ready cloudlet members that are free — or already ours."""
        rel = self.server.reliability
        mine = set(self.cell_hosts)
        pool = []
        for h in self.server.cloudlets.members(self.cloudlet):
            info = self.server.hosts.get(h)
            if info is None or info.suspended or not info.vm_ready:
                continue
            if not self.server.availability.is_available(h):
                continue
            if rel.is_quarantined(h, now) or h in self.demoted:
                continue
            if info.guest_id is not None and h not in mine:
                continue
            pool.append(h)
        return rel.ranked(pool)

    # -------------------------------------------------------------- re-shard
    def _reshard(self, clock: SimClock, *, cause: str) -> bool:
        """The re-shard protocol: pick survivors, re-plan the grid,
        re-lay-out params, restore + shed + replay. Returns False (and
        backs off) when the cloudlet can't host the cell right now."""
        now = clock.now()
        if now < self._next_reshard_at:
            return False
        cands = self._candidates(now)
        n = min(self.target_hosts, len(cands))
        if n < self.min_hosts:
            delay = self.backoff.next_delay()
            self._next_reshard_at = now + delay
            self.stats["reshard_stalls"] += 1
            self.server._emit(now, "cell_reshard_stalled", cell=self.name,
                              candidates=len(cands), retry_in=delay)
            return False
        hosts = cands[:n]
        grid = plan_elastic_mesh(n * self.devices_per_host,
                                 model_parallel=self.model_parallel)

        # snapshot-first on graceful re-shards (formation, grow-back):
        # the old engine is intact, so the new one resumes with zero
        # replay; on churn we fall back to the last placed snapshot
        blob = None
        if self.engine is not None and not self._dirty:
            blob = self.engine.snapshot()
        elif self.engine is not None:
            blob = self._restorable_blob()

        for h in self.cell_hosts:       # release the old membership
            info = self.server.hosts.get(h)
            if info is not None and info.guest_id == self._guest:
                info.guest_id = None
        self.cell_hosts = list(hosts)
        for h in hosts:
            self.server.hosts[h].guest_id = self._guest
            self.server.reliability.record_assignment(h)

        # the old engine's pool goes before the new one is allocated: its
        # state lives on in ``blob``
        self.engine = None
        engine = self.factory(hosts[0])
        if not engine.paged:
            raise ValueError("the elastic cell needs the paged engine "
                             "(page-granular KV layout); use paged=True")
        restored = False
        if blob is not None:
            engine.restore(blob)
            restored = True
        moved = self._relayout(grid, engine)
        self.engine = engine
        self._sync_requests(restored)
        shed = self._apply_capacity(now)

        reshard_s = self.reshard_fixed_s + moved / self.reshard_bw_bytes_s
        clock.advance(reshard_s)
        if cause != "form":
            self.stats["downtime_steps"] += int(
                math.ceil(reshard_s / self.step_time()))
            if cause == "grow":
                self.stats["reshard_grow"] += 1
            else:
                self.stats["resharded"] += 1
            if restored:
                self.stats["resumed_from_snapshot"] += 1
            else:
                self.stats["restarts"] += 1
        replayed = self._replay(clock)
        self._dirty = False
        self._grow = False
        self.backoff.reset()
        self._next_reshard_at = clock.now()
        self._place_snapshot(clock.now())
        self.server._emit(now, "cell_resharded", cell=self.name, cause=cause,
                          hosts=list(hosts), grid=list(grid),
                          bytes_moved=moved, restored=restored,
                          replayed=replayed, shed=shed)
        return True

    def _restorable_blob(self) -> bytes | None:
        """The last placed snapshot, if any §III-D receiver of it is
        still alive (the server dropped dead holders' replicas)."""
        if self._blob is None:
            return None
        source = self.server.snapshots.restore_source(
            self._guest,
            available=set(self.server.availability.available_hosts()),
            reliability_rank=self.server.reliability.ranked(),
        )
        return self._blob if source is not None else None

    def _relayout(self, grid: tuple[int, int], engine: ServeEngine) -> int:
        """Re-derive the params + paged-KV layout for ``grid`` through
        the partition rule engine and return the bytes the re-shard
        moves: every leaf whose PartitionSpec changed, plus the lost
        fraction of the leaves whose spec survived (their shards on the
        dead hosts re-materialize from the elastic checkpoint)."""
        mesh = layout_grid(*grid)
        p_specs = tree_partition_specs(self.param_axes, self.params_host,
                                       mesh)
        c_specs = paged_cache_partition_specs(
            self.model, engine.n_slots, engine.n_pages, engine.page_size,
            mesh)

        def nbytes(tree):
            return sum(x.numel() * x.element_size() for x in tree_leaves(tree))

        total = nbytes(self.params_host) + nbytes(engine.cache)
        if self._layout is None:
            moved = total                # initial scatter onto the cell
        else:
            old_p, old_c = self._layout

            def changed(old_specs, new_specs, tree):
                # the spec trees mirror the value tree's structure
                moved_specs = tree_map2(lambda o, s: o != s, old_specs,
                                        new_specs)
                return sum(tree_leaves(tree_map2(
                    lambda x, m: x.numel() * x.element_size() if m else 0,
                    tree, moved_specs)))
            delta = (changed(old_p, p_specs, self.params_host)
                     + changed(old_c, c_specs, engine.cache))
            lost = self.stats["hosts_lost"] - self._losses_accounted
            frac = min(1.0, lost / max(1, len(self.cell_hosts) + lost))
            moved = delta + int(frac * (total - delta))
        self._losses_accounted = self.stats["hosts_lost"]
        self._layout = (p_specs, c_specs)
        self.grid = grid
        self.stats["reshard_bytes_moved"] += moved
        return moved

    def _sync_requests(self, restored: bool) -> None:
        """Reconcile cell requests with the new engine incarnation:
        cancel stale snapshot entries for terminal requests, resubmit
        pending requests the snapshot predates (or all of them on a
        restart)."""
        del restored
        eng = self.engine
        for cr in sorted(self.requests.values(), key=lambda c: c.req_id):
            er = (eng.requests.get(cr.engine_id)
                  if cr.engine_id is not None else None)
            if cr.state in ("shed", "done"):
                if er is not None and not er.done:
                    eng.cancel(er.req_id)   # older snapshot still ran it
                continue
            if er is None:
                cr.engine_id = eng.submit(
                    cr.prompt, max_new_tokens=cr.max_new_tokens,
                    eos_id=cr.eos_id, priority=cr.priority).req_id

    def _apply_capacity(self, now: float) -> int:
        """Graceful degradation: cap concurrent lanes at what the
        survivor mesh can hold and shed the lowest-priority active
        slots above it (their partial streams stay reported)."""
        eng = self.engine
        cap = max(1, min(eng.n_slots,
                         self.slots_per_host * len(self.cell_hosts)))
        eng.active_cap = cap
        active = []
        for cr in self.requests.values():
            if cr.state != "pending" or cr.engine_id is None:
                continue
            er = eng.requests.get(cr.engine_id)
            if er is not None and er.slot is not None:
                active.append(cr)
        excess = len(active) - cap
        if excess <= 0:
            return 0
        victims = sorted(active, key=lambda c: (c.priority, -c.req_id))
        for v in victims[:excess]:
            eng.cancel(v.engine_id)
            v.engine_id = None
            v.state = "shed"
            self.stats["slots_shed"] += 1
            self.server._emit(now, "cell_slot_shed", cell=self.name,
                              req=v.req_id, priority=v.priority,
                              committed=len(v.committed))
        return excess

    # ---------------------------------------------------------------- replay
    def _gap(self) -> int:
        eng = self.engine
        gap = 0
        for cr in self.requests.values():
            if cr.state != "pending" or cr.engine_id is None:
                continue
            er = eng.requests.get(cr.engine_id)
            if er is not None:
                gap += max(0, len(cr.committed) - len(er.generated))
        return gap

    def _replay(self, clock: SimClock) -> int:
        """Teacher-force every resumed stream back to its committed
        frontier: real decode steps whose sampled tokens are overridden
        by the committed history, so the rebuilt KV matches what the
        client saw — token-for-token, whatever the new mesh computes."""
        replayed = self._gap()
        if not replayed:
            return 0
        self.stats["tokens_replayed"] += replayed
        guard = 0
        while self._gap() > 0:
            self._engine_step(clock)
            self.stats["downtime_steps"] += 1
            guard += 1
            if guard > self.max_replay_steps:
                raise RuntimeError(
                    f"replay did not converge after {guard} steps "
                    f"(gap={self._gap()})")
        return replayed

    def _force_map(self) -> dict[int, int] | None:
        """Engine req_id -> committed token for every lane behind its
        frontier. Keyed by request, not slot, so a preemption that
        reshuffles slot assignment mid-replay cannot detach a stream
        from its committed history (slot-stable replay)."""
        eng = self.engine
        force: dict[int, int] = {}
        for cr in self.requests.values():
            if cr.state != "pending" or cr.engine_id is None:
                continue
            er = eng.requests.get(cr.engine_id)
            if er is None or er.slot is None:
                continue
            k = len(er.generated)
            if k < len(cr.committed):
                force[er.req_id] = cr.committed[k]
        return force or None

    def _fixup_first_tokens(self) -> None:
        """Admission computes a slot's first token inside prefill, where
        it can't be teacher-forced. If a replayed request's recomputed
        first token diverges from the committed one (never on one card,
        whose lanes compute alike in any batch; possible under sharded
        arithmetic), pin it back."""
        eng = self.engine
        for cr in self.requests.values():
            if cr.state != "pending" or cr.engine_id is None:
                continue
            er = eng.requests.get(cr.engine_id)
            if (er is None or not cr.committed or len(er.generated) != 1
                    or er.generated[0] == cr.committed[0]):
                continue
            er.generated[0] = cr.committed[0]
            eng.stats["forced_mismatches"] += 1
            if er.slot is not None:
                eng.last_token[er.slot] = cr.committed[0]

    def _engine_step(self, clock: SimClock) -> int:
        eng = self.engine
        # admit before building the force map: a lane admitted this very
        # step must decode teacher-forced too, and its prefill-recomputed
        # first token must be pinned back to the committed one *before* it
        # feeds the next decode input
        eng._admit()
        self._fixup_first_tokens()
        eng.step(self._force_map())
        self._fixup_first_tokens()
        worst = max((self.slow.get(h, 1.0) for h in self.cell_hosts),
                    default=1.0)
        clock.advance(self.step_time(worst))
        return self._commit()

    def _commit(self) -> int:
        """Extend every committed stream with freshly decoded tokens.
        The invariant the whole protocol exists for: a committed token
        is never rewritten — replay must reproduce the prefix exactly."""
        eng = self.engine
        new = 0
        for cr in self.requests.values():
            if cr.state != "pending" or cr.engine_id is None:
                continue
            er = eng.requests.get(cr.engine_id)
            if er is None:
                continue
            k = min(len(er.generated), len(cr.committed))
            if er.generated[:k] != cr.committed[:k]:
                raise RuntimeError(
                    f"committed token rewritten for request {cr.req_id}: "
                    f"{cr.committed[:k]} -> {er.generated[:k]}")
            if len(er.generated) > len(cr.committed):
                fresh = er.generated[len(cr.committed):]
                cr.committed.extend(int(t) for t in fresh)
                new += len(fresh)
            if er.done and len(cr.committed) == len(er.generated):
                cr.state = "done"
        self.stats["committed_tokens"] += new
        return new

    # ------------------------------------------------------------- snapshots
    def _place_snapshot(self, now: float) -> None:
        """Periodic engine snapshot placed by the §III-D rule so the
        next re-shard resumes mid-stream instead of restarting."""
        if self.engine is None or not self.cell_hosts:
            return
        head = self.cell_hosts[0]
        peers, in_use, available, storage_full = \
            self.server.snapshot_policy(head)
        # fellow members may hold each other's replicas: "in use" means
        # busy with someone *else's* guest, not cooperating in this cell
        # (a cell spanning its whole cloudlet has no idle peers at all)
        in_use = in_use - set(self.cell_hosts)
        # floor the per-host failure probability: a member's loss is
        # exactly the event the snapshot insures against, yet a fresh
        # host reports ~0 — without the floor the first-n rule stops at
        # a single replica that dies with the very host we lose
        fp = {h: max(self.server.reliability.failure_probability(h),
                     self.snapshot_fail_floor)
              for h in peers}
        receivers, joint = self.server.snapshots.place(
            head, peers, fp,
            in_use=in_use, available=available, storage_full=storage_full,
        )
        if not receivers:
            return      # every peer busy/full: keep the previous snapshot
        blob = self.engine.snapshot()
        self.server.report_snapshot(head, self._guest, receivers, joint,
                                    len(blob), now)
        self._blob = blob
        self._last_snap_at = now
        self.stats["snapshots_placed"] += 1
