"""SLO-aware scheduling policy for iteration-level continuous batching.

A copy of ``repro/serving/scheduler.py``: pure Python, kept apart so the
port imports nothing of the JAX package.

The :class:`~repro_torch.serving.engine.ServeEngine` owns the *mechanics* of
serving (pages, prefill chunks, the batched decode kernel); this module
owns the *policy*: which waiting request is admitted next, whether a
prefill chunk may run this step, when an active slot is preempted back
to the queue, and when load is shed instead of queued unboundedly.

It is the scheduling analogue of BOINC's deadline-driven work dispatch
(Anderson, *BOINC: A Platform for Volunteer Computing*) applied at
**token granularity** rather than workunit granularity: on an ad hoc
cloud the hosts behind a serving cell come and go (Kirby et al.), so the
batch composition must be re-decided every iteration, not every request.

Policy summary
--------------

**Effective priority with aging.** Every request carries a base
``priority`` (higher = more important). While it waits, its *effective*
priority rises by one per ``aging_steps`` engine steps, so a starved
request eventually outranks fresher work of nominally higher priority.
Admission considers waiting requests in effective-priority order
(deadline-urgent first within a tier).

**Deadline-ordered admission.** ``deadline_ms`` is a TTFT budget in
simulated milliseconds from submission. Among requests of equal
effective priority the earliest absolute deadline is admitted first; a
request whose deadline expires before it ever reaches a slot is **shed**
(dropped with its ``shed`` flag set) rather than left to rot in the
queue.

**Bounded head bypass.** Under page pressure a later request whose
cached prefix shrinks its private-page need may be admitted past a
blocked higher-ranked request — but only while the blocked request's
effective-priority lead is strictly below ``bypass_margin``. Because the
blocked head *ages* while bypass candidates arrive fresh, its lead grows
past the margin after at most ``~bypass_margin * aging_steps`` steps, at
which point bypass shuts off and freed pages accumulate for the head:
the old queue-scan rule could starve an oversized head indefinitely
under a steady stream of prefix hits, the aged rule cannot.

**Priority preemption.** When a waiting request's *base* priority
exceeds an active slot's base priority by ``preempt_margin`` and no free
slot (or page headroom) can take it, the lowest-priority active decode
slot is preempted back to the waiting queue. Preemption is deliberately
keyed on base priorities, not aged ones: aging exists to order peers
fairly, and letting it trigger preemption would make any uniform
backlog thrash. A preempted slot's pages are registered in the prefix
trie before release, so they stay resident (refcounted or free-but-
cached) until re-admission revives them or pool pressure evicts them —
and with a remote pool attached the engine additionally *spills* the
victim's whole chain to neighbor hosts, so resume is a page recall
rather than a re-prefill. Among equal-priority victims the engine's
``spill_cost`` hook prefers the one whose pages are already
write-behind staged (cheapest eviction).

**Queue bounds with class quotas.** With ``max_queue`` set, admission
sheds the lowest-ranked waiting requests once the queue exceeds the
bound — degrade, don't queue unboundedly. ``class_shares`` reserves a
fraction of the bound per base-priority class so a burst of one class
cannot monopolize the queue and shed every other class.

**Token budget.** ``token_budget`` caps the tokens processed per engine
step: each active decode lane reserves one, and only the remainder may
be spent on prefill chunks. Long prompts therefore prefill across
several steps while decode lanes keep emitting every step — inter-token
latency stays flat through prompt bursts. ``prefill_cost_ratio``
deflates the prefill allowance when a prefill token is measured to cost
more step time than a decode token, keeping the budget an honest proxy
for wall-clock. ``token_budget=None`` selects the legacy synchronous
mode (whole prompt prefilled at admission), kept as the non-continuous
reference for parity benchmarks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterable

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, typing only
    from repro_torch.serving.engine import Request


@dataclass
class SchedulerConfig:
    """Knobs for the serving scheduler (see module docstring)."""

    # tokens (decode lanes + prefill chunk tokens) per engine step;
    # None = legacy synchronous admission (the non-continuous reference)
    token_budget: int | None = 256
    # waiting steps per +1 effective priority (0 disables aging)
    aging_steps: int = 32
    # max effective-priority lead a blocked request may have before
    # cached-prefix bypass past it shuts off
    bypass_margin: int = 2
    # base-priority gap required to preempt an active slot; None disables
    preempt_margin: int | None = 2
    # failed-candidate trie lookups per admission scan (bypass window)
    scan_limit: int = 16
    # waiting-queue bound; lowest-ranked requests beyond it are shed
    max_queue: int | None = None
    # admission-control quotas: base-priority class -> fraction of
    # max_queue reserved for that class, so a flood of low-priority
    # arrivals cannot shed higher classes out of a bounded queue.
    # Unreserved capacity stays first-come in ranked order.
    class_shares: dict[int, float] | None = None
    # simulated cost of one prefill token relative to one decode token;
    # the per-step token_budget is decode-denominated, so a ratio > 1
    # shrinks the prefill allowance (chunked prefill arithmetic is
    # batched and cheaper per token than it is under this ratio only
    # when measured so — benches pass their measured value)
    prefill_cost_ratio: float = 1.0

    @property
    def synchronous(self) -> bool:
        return self.token_budget is None


class Scheduler:
    """Pure policy over the engine's waiting queue and active slots.

    Holds no request state of its own — requests carry their
    ``priority`` / ``deadline_ms`` / ``arrival_step``, so engine
    snapshot/restore round-trips the whole scheduling picture for free.
    """

    def __init__(self, cfg: SchedulerConfig | None = None,
                 *, decode_step_s: float = 5e-3):
        self.cfg = cfg or SchedulerConfig()
        self.decode_step_s = decode_step_s

    # ------------------------------------------------------------ priorities
    def effective_priority(self, req: "Request", step: int) -> int:
        """Base priority plus the aging credit earned while waiting."""
        if self.cfg.aging_steps <= 0:
            return req.priority
        waited = max(0, step - req.arrival_step)
        return req.priority + waited // self.cfg.aging_steps

    def deadline_step(self, req: "Request") -> float:
        """Absolute engine step by which the request must have started."""
        if req.deadline_ms is None:
            return float("inf")
        return req.arrival_step + req.deadline_ms / (self.decode_step_s * 1e3)

    def expired(self, req: "Request", step: int) -> bool:
        """A still-waiting request whose TTFT deadline already passed."""
        return step > self.deadline_step(req)

    # ------------------------------------------------------------- admission
    def order(self, queue: Iterable["Request"], step: int,
              ) -> list["Request"]:
        """Admission order: effective priority desc, then earliest
        deadline, then arrival (FIFO among true peers)."""
        return sorted(
            queue,
            key=lambda r: (-self.effective_priority(r, step),
                           self.deadline_step(r), r.arrival_step, r.req_id),
        )

    def may_bypass(self, blocked: "Request", candidate: "Request",
                   step: int) -> bool:
        """May ``candidate`` be admitted past page-blocked ``blocked``?
        Only while the blocked request's aged lead is strictly below the
        margin — the engine additionally requires the candidate to hold a
        resident cached prefix (it must *shrink* the page need, not just
        fit). Strict: a preemption victim re-queued ``preempt_margin``
        priorities under its preemptor must not bypass straight back past
        it, so ``bypass_margin`` defaults to ``preempt_margin`` and the
        boundary case blocks."""
        lead = (self.effective_priority(blocked, step)
                - self.effective_priority(candidate, step))
        return lead < self.cfg.bypass_margin

    # ------------------------------------------------------------ preemption
    def pick_victim(self, candidate: "Request",
                    active: Iterable["Request"],
                    *, spill_cost=None) -> "Request | None":
        """Lowest-base-priority active request the candidate may preempt,
        or None. Base priorities only — see the module docstring.

        ``spill_cost`` (optional callable ``Request -> int``) breaks ties
        *within* a priority tier by how much work evicting the victim
        still costs — the engine passes the number of chain pages not yet
        write-behind staged on a neighbor, so preemption prefers victims
        whose pages already left the building. Priority stays the primary
        key: a cheap spill never justifies evicting higher-priority work.
        """
        if self.cfg.preempt_margin is None:
            return None
        cost = spill_cost if spill_cost is not None else (lambda r: 0)
        victims = sorted(active,
                         key=lambda r: (r.priority, cost(r), -r.req_id))
        if not victims:
            return None
        v = victims[0]
        if candidate.priority >= v.priority + self.cfg.preempt_margin:
            return v
        return None

    # -------------------------------------------------------------- shedding
    def overflow(self, queue: list["Request"], step: int) -> list["Request"]:
        """Waiting requests to shed because the queue exceeds its bound:
        the lowest-ranked tail, never the head.

        With ``class_shares`` set, each base-priority class keeps its
        reserved share of ``max_queue`` before the remainder is filled in
        ranked order — a flood of aged low-priority arrivals can no
        longer shed a trickle of higher-priority work out of a bounded
        queue (admission control, not just ordering)."""
        if self.cfg.max_queue is None or len(queue) <= self.cfg.max_queue:
            return []
        ranked = self.order(queue, step)
        cap = self.cfg.max_queue
        if not self.cfg.class_shares:
            return ranked[cap:]
        reserved = {c: int(share * cap)
                    for c, share in self.cfg.class_shares.items()}
        free = cap - sum(reserved.values())
        assert free >= 0, "class_shares reserve more than max_queue"
        kept: list["Request"] = []
        shed: list["Request"] = []
        for r in ranked:
            if reserved.get(r.priority, 0) > 0:
                reserved[r.priority] -= 1
                kept.append(r)
            elif free > 0:
                free -= 1
                kept.append(r)
            else:
                shed.append(r)
        return shed

    # ---------------------------------------------------------------- budget
    def prefill_budget(self, n_decode_lanes: int, prefilling: bool,
                       tokens_per_lane: int = 1) -> int:
        """Prefill tokens allowed this step after decode lanes reserve
        theirs — one token each for plain decode, a whole draft+verify
        window (``tokens_per_lane``) each when the engine speculates this
        step. Guarantees minimal progress (one chunk's worth is granted
        by the engine when a prefill is mid-flight and the budget is
        exhausted) via the ``prefilling`` flag at the call site.

        The budget is denominated in decode tokens; the leftover is
        deflated by ``prefill_cost_ratio`` so a prefill token that costs
        (say) 1.5 decode tokens of step time spends 1.5 budget units."""
        assert self.cfg.token_budget is not None
        del prefilling
        left = max(0, self.cfg.token_budget
                   - n_decode_lanes * tokens_per_lane)
        if self.cfg.prefill_cost_ratio != 1.0:
            assert self.cfg.prefill_cost_ratio > 0
            left = int(left / self.cfg.prefill_cost_ratio)
        return left
