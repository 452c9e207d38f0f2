"""Batched serving engine: continuous batching over a paged KV cache.

Ported from ``repro/serving/engine.py``, paged engine only. The engine owns
``n_slots`` decode lanes over a shared pool of fixed-size pages with
per-slot page tables (:mod:`repro_torch.serving.kvcache`). Admission runs
chunked prefill at true prompt length, writing each chunk's K/V straight
into the slot's pages; decode advances every active slot through one
batched ``decode_paged`` step through the paged flash-decode kernel.

What carries over from the reference, with the same semantics and the same
``stats`` counters:

- iteration-level continuous batching under the scheduler's per-step token
  budget (``_admission_scan``, ``_pump_prefill``/``_advance_prefill``/
  ``_finish_prefill``), and the synchronous mode ``token_budget=None``,
  which drains each prefill inside its admission and is the oracle for
  continuous batching;
- copy-on-write prefix sharing through the prefix trie, with the COW copy
  of a partially used shared page on a whole-prompt hit (``_copy_pages``);
- deferral of a request whose prefix an in-flight prefill is about to
  register (``_await_inflight_prefix``);
- token-exact preemption with re-prefill resume, shedding of expired and
  overflowing requests, ``cancel`` and teacher forcing (``step(
  force_tokens=...)``);
- host-side sampling from numpy Gumbel noise keyed by (seed, position)
  (``_choose``), so sampled streams match the reference's exactly.

Not in this slice (each raises ``NotImplementedError`` naming its ROADMAP
item where the constructor takes it): speculative decoding and ``fork``,
the spill tier (``remote_pool``, ``write_behind``), snapshot/restore,
multimodal and cross-attention families, and the dense ``paged=False``
path.

The model's entry points update the page pools in place; the JAX engine
donates its cache to the jitted step for the same reason
(``engine.py:612-613``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models.model_api import ModelFns
from repro_torch.serving.kvcache import (
    PagePool,
    PrefixIndex,
    init_paged_cache,
    pages_needed,
)
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig


@dataclass
class Request:
    req_id: int
    prompt: list[int]
    max_new_tokens: int
    eos_id: int | None = None
    # SLO scheduling (see repro_torch.serving.scheduler): higher priority
    # wins; deadline_ms is a TTFT budget in simulated milliseconds
    priority: int = 0
    deadline_ms: float | None = None
    arrival_step: int = 0
    # preemption: committed tokens (all but the last) re-prefilled after the
    # prompt on re-admission, so a preempted stream resumes token-exactly
    resume: list[int] = field(default_factory=list)
    shed: bool = False     # dropped by the scheduler, not completed
    # sampling: temperature 0 is greedy; > 0 draws per-position Gumbel
    # noise from ``seed`` (a sampled stream is a function of prompt + seed)
    temperature: float = 0.0
    seed: int = 0
    generated: list[int] = field(default_factory=list)
    slot: int | None = None
    done: bool = False
    # memo for derived trie keys (pure functions of the immutable prompt)
    key_cache: dict = field(default_factory=dict, repr=False)


def _copy_pages(cache: dict, src: int, dst: int) -> None:
    """COW: duplicate physical page ``src`` into ``dst`` in every paged leaf
    (``*_pages``, laid out ``(layers, n_pages, page, ...)``), in place. Rows
    of ``dst`` past the copied prefix are dead — overwritten by the suffix
    prefill/decode before being read, or masked causally."""
    for k, v in cache.items():
        if k.endswith("_pages"):
            v[:, dst].copy_(v[:, src])


class SlotLifecycle:
    """The slot-binding state machine shared by the admission flavors
    (fresh prefill and resume re-prefill): the page-table row mirrors the
    chain, ``lengths`` counts cache-resident positions, ``last_token`` is
    the last committed token."""

    def __init__(self, engine: "ServeEngine"):
        self.eng = engine

    def bind(self, slot: int, req: Request, chain: list[int]) -> None:
        """Install ``chain`` as the slot's page-table row and bind the
        request to the lane."""
        eng = self.eng
        eng.slot_pages[slot] = list(chain)
        eng.page_table[slot, :] = 0
        eng.page_table[slot, : len(chain)] = chain
        eng.slot_req[slot] = req.req_id
        req.slot = slot

    def activate(self, slot: int, req: Request, first: int,
                 length: int) -> None:
        """Prefill finished at ``length`` positions producing logits whose
        argmax is ``first``: commit the first token — or, for a request
        resuming from a preemption, verify that the recomputed token
        re-derives the already-committed one."""
        eng = self.eng
        resumed = bool(req.generated)
        if resumed:
            committed = req.generated[len(req.resume)]
            if first != committed:
                eng.stats["resume_mismatches"] += 1
            first = committed
            req.resume = []
            req.key_cache.pop("admit_keys", None)
        else:
            req.generated.append(first)
        req.slot = slot
        eng.slot_req[slot] = req.req_id
        eng.lengths[slot] = length
        eng.last_token[slot] = first
        if not resumed and req.eos_id is not None and first == req.eos_id:
            req.done = True
            req.slot = None
            eng._release_slot(slot)


@dataclass
class _PrefillTask:
    """One admission's chunked prefill, in flight across engine steps. The
    slot's pages are allocated and its request bound when the task is
    created; the slot's page-table row stays on the scratch page until the
    last chunk lands, so the batched decode's inert write for this lane
    never touches real (possibly shared) pages."""

    req: Request
    tlen: int                    # prompt + resume positions
    ptoks: list[int]             # prompt + resume
    offset: int                  # next position to compute
    key_tokens: list[int]        # trie keys registered at completion
    logits: torch.Tensor | None = None  # last chunk's logits


class ServeEngine:
    def __init__(
        self,
        model: ModelFns,
        params: nn.Module,
        *,
        n_slots: int = 8,
        max_seq: int = 1024,
        paged: bool | None = None,
        page_size: int = 64,
        n_pages: int | None = None,
        prefill_chunk: int = 256,
        prefix_share: bool | None = None,
        remote_pool=None,
        write_behind: bool = False,
        scheduler: SchedulerConfig | None = None,
        draft: ModelFns | None = None,
        device: str | torch.device = "cuda",
    ):
        if paged is False:
            raise NotImplementedError(
                "paged=False (the dense cache and decode_attention) is not "
                "ported yet: ROADMAP Queue 1, item 5 follow-on")
        if draft is not None:
            raise NotImplementedError(
                "speculative decoding is not ported yet: ROADMAP Queue 1, "
                "item 6")
        if remote_pool is not None or write_behind:
            raise NotImplementedError(
                "the spill tier (remote_pool, write_behind) is not ported "
                "yet: ROADMAP Queue 1, item 7")
        self.device = resolve_device(device)
        if any(p.device != self.device for p in params.parameters()):
            raise ValueError(f"params are not all on {self.device}")
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.sched = Scheduler(scheduler)
        # slot -> in-flight chunked prefill (continuous batching only; the
        # synchronous mode drains each task within its admission call)
        self.prefilling: dict[int, _PrefillTask] = {}
        self.last_step_tokens = 0
        self._step_prefill_tokens = 0
        self._has_deadlines = False
        self.max_seq = max_seq
        self.lengths = np.zeros((n_slots,), np.int32)
        self.last_token = np.zeros((n_slots,), np.int32)
        self.slot_req: list[int | None] = [None] * n_slots
        self.lifecycle = SlotLifecycle(self)
        self.queue: list[Request] = []
        self.requests: dict[int, Request] = {}
        self._req_counter = 0
        self.steps = 0
        # every key of the reference engine (engine.py:444-489); the spill,
        # cross, speculative and fork counters stay 0 in this slice
        self.stats = {k: 0 for k in (
            "prefill_tokens", "prefill_tokens_shared", "prefix_hit_tokens",
            "prefix_hits", "cow_copies", "peak_pages",
            "pages_spilled", "pages_recalled", "recall_misses",
            "prefix_evictions", "recall_hold_steps", "peak_resident_pages",
            "cross_regions_computed", "cross_regions_shared",
            "cross_pages_shared",
            "forced_tokens", "forced_mismatches",
            "preemptions", "shed_expired", "shed_overflow",
            "resume_mismatches",
            "preempt_spills", "recall_resumes", "resume_fallbacks",
            "recall_resume_prefill_tokens", "pages_staged",
            "spec_rounds", "spec_proposed", "spec_accepted",
            "forks", "fork_shared_pages",
        )}

        self.page_size = page_size
        self.max_pages = -(-max_seq // page_size)
        # default pool: full capacity (one spare page for scratch)
        self.n_pages = (n_pages if n_pages is not None
                        else n_slots * self.max_pages + 1)
        self.pool = PagePool(self.n_pages)
        self.page_table = np.zeros((n_slots, self.max_pages), np.int32)
        self.slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
        self.prefill_chunk = min(prefill_chunk, self.max_pages * page_size)
        # copy-on-write prefix sharing through the trie (on by default)
        self.prefix_share = True if prefix_share is None else prefix_share
        self.prefix_index = PrefixIndex(page_size)
        self.cache = init_paged_cache(model, n_slots, self.n_pages,
                                      page_size, device=self.device)
        self._admit_ready = True  # new submits / freed pages to try

    # ------------------------------------------------------------- helpers
    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr)).to(self.device)

    def _admit_keys(self, req: Request) -> list[int]:
        """Trie key sequence for admission: the prompt plus one key per
        ``resume`` token. Memoized until the resume suffix changes."""
        if "admit_keys" not in req.key_cache:
            req.key_cache["admit_keys"] = list(req.prompt) + list(req.resume)
        return req.key_cache["admit_keys"]

    # ------------------------------------------------------------- interface
    def submit(self, prompt: list[int], *, max_new_tokens: int = 16,
               eos_id: int | None = None, priority: int = 0,
               deadline_ms: float | None = None,
               temperature: float = 0.0, seed: int = 0) -> Request:
        if not 1 <= len(prompt) < self.max_seq:
            raise ValueError(
                f"prompt length {len(prompt)} outside [1, {self.max_seq})")
        need = pages_needed(min(len(prompt) + max_new_tokens, self.max_seq),
                            self.page_size)
        if need > self.n_pages - 1:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.n_pages - 1} allocatable pages")
        req = Request(self._req_counter, list(prompt), max_new_tokens, eos_id,
                      priority=priority, deadline_ms=deadline_ms,
                      arrival_step=self.steps,
                      temperature=temperature, seed=seed)
        if deadline_ms is not None:
            self._has_deadlines = True
        self._req_counter += 1
        self.requests[req.req_id] = req
        self.queue.append(req)
        self._admit_ready = True
        return req

    def pending(self) -> int:
        return len(self.queue) + sum(s is not None for s in self.slot_req)

    def cancel(self, req_id: int) -> Request:
        """Withdraw a request: dequeue it if waiting, release its slot
        (private pages freed, shared pages drop one ref) if active. Its
        ``generated`` tokens so far stay on the returned request."""
        req = self.requests.pop(req_id)
        if req in self.queue:
            self.queue.remove(req)
        if req.slot is not None:
            self._release_slot(req.slot)
            req.slot = None
        return req

    def reset_stats(self) -> None:
        """Zero the counters (e.g. between a warmup and a measured pass)."""
        for k in self.stats:
            self.stats[k] = 0

    def step(self, force_tokens: dict[int, int] | None = None) -> int:
        """Admit waiting requests, then advance every active slot by one
        token. Returns the number of active slots that generated.

        ``force_tokens`` maps req_id -> token id to teacher-force this
        step: the slot's K/V is still written from its real last token and
        the model's choice is still computed (a difference counts as a
        ``forced_mismatch``), but the committed token is the forced one."""
        if not self.sched.cfg.synchronous:
            self._shed_pass()
            self._admission_scan()
            lanes = [i for i, r in enumerate(self.slot_req)
                     if r is not None and i not in self.prefilling]
            prefill_used = self._pump_prefill(
                self.sched.prefill_budget(len(lanes), bool(self.prefilling)))
            self._preempt_pass()
        else:
            prefill_used = self._admit()
        active = [i for i, r in enumerate(self.slot_req)
                  if r is not None and i not in self.prefilling]
        if not active:
            if self.prefilling:   # chunks ran: time passes
                self.steps += 1
            self.last_step_tokens = prefill_used
            return 0
        batch = {
            "tokens": self._tensor(self.last_token[:, None]),
            "positions": self._tensor(self.lengths),
            "page_table": self._tensor(self.page_table),
        }
        logits = self.model.decode_paged(self.params, self.cache, batch)
        next_tokens = logits.argmax(dim=-1).cpu().numpy()
        rows = (logits.float().cpu().numpy()
                if self._any_sampled(active) else None)
        for i in active:
            req = self.requests[self.slot_req[i]]
            if rows is not None and req.temperature > 0:
                tok = self._choose(rows[i], req, int(self.lengths[i]))
            else:
                tok = int(next_tokens[i])
            if force_tokens is not None and req.req_id in force_tokens:
                forced = int(force_tokens[req.req_id])
                self.stats["forced_tokens"] += 1
                if forced != tok:
                    self.stats["forced_mismatches"] += 1
                tok = forced
            self._commit_token(i, req, tok)
        self.steps += 1
        self.last_step_tokens = prefill_used + len(active)
        return len(active)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        while self.pending() and max_steps > 0:
            self.step()
            max_steps -= 1
        return [r for r in self.requests.values() if r.done]

    # -------------------------------------------------------------- sampling
    def _any_sampled(self, lanes: list[int]) -> bool:
        return any(self.requests[self.slot_req[i]].temperature > 0
                   for i in lanes)

    @staticmethod
    def _choose(row: np.ndarray, req: Request, pos: int) -> int:
        """The committed token for logits ``row`` computed at cache position
        ``pos``: greedy argmax at temperature 0, else argmax of ``row/T``
        plus Gumbel noise drawn from ``(seed, pos)`` on the host with numpy
        — the same noise as the reference's (``engine.py:965-978``)."""
        if req.temperature <= 0:
            return int(np.argmax(row))
        rng = np.random.default_rng([int(req.seed) & 0xFFFFFFFF, int(pos)])
        u = rng.random(row.shape[-1])
        g = -np.log(-np.log(u + 1e-20) + 1e-20)
        return int(np.argmax(row.astype(np.float64) / req.temperature + g))

    def _commit_token(self, i: int, req: Request, tok: int) -> bool:
        """Append one committed token to lane ``i``; True when the request
        completed (slot released)."""
        req.generated.append(tok)
        self.lengths[i] += 1
        self.last_token[i] = tok
        if ((req.eos_id is not None and tok == req.eos_id)
                or len(req.generated) >= req.max_new_tokens
                or self.lengths[i] >= self.max_seq - 1):
            self._finish_request(i, req)
            return True
        return False

    def _finish_request(self, i: int, req: Request) -> None:
        """Completion: register the slot's fully committed pages — prompt
        and generated — in the prefix trie before release, so a later
        prompt extending this transcript shares them."""
        if self.prefix_share:
            covered = int(self.lengths[i])
            gen = req.generated[: covered - len(req.prompt)]
            self._register_prefix(req.prompt + list(gen),
                                  self.slot_pages[i])
        req.done = True
        req.slot = None
        self._release_slot(i)

    # ----------------------------------------------------------------- admit
    def _admit(self) -> int:
        """Synchronous admission: one shed + admission pass, then drain any
        in-flight prefills to completion. Returns the prefill tokens
        computed."""
        self._step_prefill_tokens = 0
        self._shed_pass()
        self._admission_scan()
        if self.prefilling:
            self._pump_prefill(None)
        return self._step_prefill_tokens

    def _admission_scan(self) -> None:
        """Admit waiting requests into free slots in the scheduler's order.
        Under page pressure a lower-ranked request whose cached prefix
        shrinks its private-page need may be admitted past a blocked
        higher-ranked one, only while the blocked request's aged lead stays
        below ``bypass_margin``."""
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        while free and self.queue:
            if not self._admit_ready:
                return  # nothing changed since the last failed scan
            ranked = self.sched.order(self.queue, self.steps)
            admitted = False
            deferred = False
            blocked: Request | None = None
            attempts = 0
            for req in ranked:
                if attempts >= self.sched.cfg.scan_limit:
                    break
                if blocked is not None and not self.sched.may_bypass(
                        blocked, req, self.steps):
                    break  # ranked order: later candidates' leads only grow
                attempts += 1
                if self._await_inflight_prefix(req):
                    deferred = True
                    continue
                if self._try_admit(free[0], req,
                                   require_shared=blocked is not None):
                    self.queue.remove(req)
                    free.pop(0)
                    admitted = True
                    break
                if blocked is None:
                    blocked = req
            if not admitted:
                if not deferred:
                    self._admit_ready = False
                return

    def _await_inflight_prefix(self, req: Request) -> bool:
        """True when a still-prefilling slot will register a longer usable
        prefix for this request than the trie holds now: admitting it now
        would prefill the duplicate prefix from scratch."""
        if not self.prefix_share or not self.prefilling:
            return False
        keys = self._admit_keys(req)
        best = 0
        for task in self.prefilling.values():
            m = 0
            for a, b in zip(keys, task.key_tokens):
                if a != b:
                    break
                m += 1
            best = max(best, m // self.page_size)
        if not best:
            return False
        return best > len(self.prefix_index.lookup(keys))

    # ------------------------------------------------------- shed / preempt
    def _shed_pass(self) -> None:
        """Drop waiting requests whose TTFT deadline passed, then the
        lowest-ranked tail beyond ``max_queue``."""
        if not self.queue:
            return
        if self._has_deadlines:
            for req in list(self.queue):
                if (req.deadline_ms is not None
                        and self.sched.expired(req, self.steps)):
                    self._shed(req, "shed_expired")
        if self.sched.cfg.max_queue is not None:
            for req in self.sched.overflow(self.queue, self.steps):
                self._shed(req, "shed_overflow")

    def _shed(self, req: Request, counter: str) -> None:
        req.shed = True
        self.cancel(req.req_id)
        self.stats[counter] += 1

    def preempt(self, req_id: int) -> Request:
        """Preempt an active decode slot back to the waiting queue,
        token-exactly: its pages are registered in the prefix trie under
        prompt + generated keys (the free list keeps their content until
        reallocation), ``generated[:-1]`` becomes the ``resume`` suffix
        re-prefilled on re-admission, and the final committed token is
        re-derived and verified then."""
        req = self.requests[req_id]
        slot = req.slot
        if slot is None or slot in self.prefilling:
            raise ValueError("only active decode slots can be preempted")
        if self.prefix_share:
            covered = int(self.lengths[slot])
            gen = req.generated[: covered - len(req.prompt)]
            self._register_prefix(req.prompt + list(gen),
                                  self.slot_pages[slot])
        req.resume = list(req.generated[:-1])
        req.key_cache.pop("admit_keys", None)
        # aging restarts from the preemption, or the victim would bypass
        # straight back past the request that preempted it
        req.arrival_step = self.steps
        self._release_slot(slot)
        req.slot = None
        self.queue.append(req)
        self.stats["preemptions"] += 1
        return req

    def _preempt_pass(self) -> None:
        """If the best waiting request outranks the weakest active decode
        slot by ``preempt_margin`` (base priorities), preempt that slot;
        one victim per step."""
        if self.sched.cfg.preempt_margin is None or not self.queue:
            return
        cand = min(self.queue,
                   key=lambda r: (-r.priority, r.arrival_step, r.req_id))
        active = [self.requests[r] for i, r in enumerate(self.slot_req)
                  if r is not None and i not in self.prefilling]
        victim = self.sched.pick_victim(cand, active)
        if victim is not None:
            self.preempt(victim.req_id)

    def _try_admit(self, slot: int, req: Request, *,
                   require_shared: bool = False) -> bool:
        """Plan + execute one paged admission: trie lookup, refcount bumps
        on the shared pages, private allocation for the rest. Returns False
        with no side effects if the pool cannot satisfy it, or if
        ``require_shared`` and no resident cached page shrinks the
        request."""
        tlen = len(req.prompt) + len(req.resume)
        P = self.page_size
        need = pages_needed(
            min(len(req.prompt) + req.max_new_tokens, self.max_seq), P)
        key_tokens = self._admit_keys(req)
        matched, shared = 0, []
        if self.prefix_share:
            chain = self.prefix_index.lookup(key_tokens)
            # cap at tlen-1: at least one suffix token must run through the
            # model to produce the first-token logits
            matched = min(len(chain) * P, tlen - 1)
            shared = chain[: pages_needed(matched, P)] if matched else []
        if require_shared and not shared:
            return False
        revive = sum(1 for p in shared if self.pool.refcount(p) == 0)
        if (need - matched // P) + revive > self.pool.available:
            return False
        # ---- execute: guaranteed to succeed from here ----
        self.pool.share(shared)       # revive cached pages before alloc
        private = self.pool.alloc(need - matched // P)
        assert private is not None  # guaranteed by the pre-check
        self._retire_cached(private)
        self._prefill_paged(slot, req, shared, private, matched, key_tokens)
        return True

    def _retire_cached(self, pages: list[int]) -> None:
        """Freshly reallocated pages lose their cached contents: evict them
        (and their subtrees) from the prefix trie."""
        if not self.prefix_share:
            return
        for p in pages:
            if p in self.prefix_index._nodes:
                dropped = self.prefix_index.evict_pages([p])
                self.stats["prefix_evictions"] += len(dropped)

    def _release_slot(self, slot: int) -> None:
        self.slot_req[slot] = None
        self.lengths[slot] = 0
        self.pool.free(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.page_table[slot, :] = 0  # scratch page: inert lane writes
        self.prefilling.pop(slot, None)
        self._admit_ready = True      # freed capacity: rescan the queue

    def _prefill_paged(self, slot: int, req: Request, shared: list[int],
                       private: list[int], matched: int,
                       key_tokens: list[int]) -> None:
        """Begin the chunked prefill of the uncached suffix: the slot's
        chain is the shared prefix pages plus its private pages. On a
        whole-prompt hit (``matched`` not page-aligned) the final, partly
        used shared page is copied on write into ``private[0]`` and only
        the last prompt token is recomputed, by one synthetic decode step.

        Under a continuous scheduler this only binds the slot and queues a
        ``_PrefillTask`` that ``step()`` pumps under the token budget; the
        synchronous mode drains it here."""
        ptoks = req.prompt + req.resume
        tlen = len(ptoks)
        P = self.page_size
        full = matched // P
        cow = bool(matched % P)
        if cow:
            src, dst = shared[full], private[0]
            _copy_pages(self.cache, src, dst)
            self.pool.free([src])  # drop this slot's read ref on the original
            self.stats["cow_copies"] += 1
        chain = shared[:full] + private
        self.slot_pages[slot] = chain
        # the page-table row stays on the scratch page until the last chunk
        # lands; the COW path installs it below, finishing in this call
        self.page_table[slot, :] = 0
        self.slot_req[slot] = req.req_id
        req.slot = slot
        self.stats["prefill_tokens"] += tlen - matched
        self.stats["prefill_tokens_shared"] += matched
        if matched:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += matched
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       self.pool.outstanding)
        if cow:
            # one synthetic decode step writes the final token's K/V into
            # the COW'd page and returns its logits; other lanes re-write
            # the K/V their next real step writes anyway (idempotent), and
            # unbound lanes scatter into the scratch page
            self.page_table[slot, : len(chain)] = chain
            toks = self.last_token.copy()
            toks[slot] = ptoks[-1]
            pos = self.lengths.copy()
            pos[slot] = tlen - 1
            batch = {
                "tokens": self._tensor(toks[:, None]),
                "positions": self._tensor(pos),
                "page_table": self._tensor(self.page_table),
            }
            logits = self.model.decode_paged(self.params, self.cache, batch)
            first = int(logits[slot].argmax())
            self._finish_prefill(slot, req, key_tokens, chain, first, tlen)
            return
        self.prefilling[slot] = _PrefillTask(
            req=req, tlen=tlen, ptoks=ptoks, offset=matched,
            key_tokens=key_tokens)
        if self.sched.cfg.synchronous:
            self._advance_prefill(slot, None)

    def _advance_prefill(self, slot: int, budget: int | None,
                         force: bool = False) -> int:
        """Run prefill chunks for one in-flight task. ``budget`` bounds the
        tokens computed (None = drain); ``force`` grants the first chunk
        even over budget, so a saturated step still makes progress.
        Returns the prefill tokens computed."""
        task = self.prefilling[slot]
        C = self.prefill_chunk
        chain = self.slot_pages[slot]
        row = np.zeros((self.max_pages,), np.int32)
        row[: len(chain)] = chain
        table_row = self._tensor(row)
        used = 0
        while task.offset < task.tlen:
            n = min(C, task.tlen - task.offset)
            if (budget is not None and n > budget - used
                    and not (force and used == 0)):
                break
            off = task.offset
            toks = np.zeros((1, C), np.int32)
            toks[0, :n] = task.ptoks[off:off + n]
            batch = {"tokens": self._tensor(toks), "valid": n,
                     "page_table": table_row}
            task.logits = self.model.prefill_chunk(self.params, self.cache,
                                                   batch, offset=off)
            task.offset += n
            used += n
        if task.offset >= task.tlen:
            first = int(task.logits[0].argmax())
            del self.prefilling[slot]
            self._finish_prefill(slot, task.req, task.key_tokens, chain,
                                 first, task.tlen)
        self._step_prefill_tokens += used
        return used

    def _pump_prefill(self, budget: int | None) -> int:
        """Advance every in-flight prefill under the step's remaining token
        budget (slot order; only the first slot may overshoot by one chunk
        — the progress guarantee). Returns tokens computed."""
        used = 0
        for slot in sorted(self.prefilling):
            rem = None if budget is None else budget - used
            if rem is not None and rem <= 0 and used > 0:
                break
            used += self._advance_prefill(slot, rem, force=(used == 0))
        return used

    def _finish_prefill(self, slot: int, req: Request, key_tokens: list[int],
                        chain: list[int], first: int, tlen: int) -> None:
        """The last chunk landed: install the real page-table row, register
        the prompt pages in the trie (only now — their content exists), and
        commit the first token."""
        self.lifecycle.bind(slot, req, chain)
        if self.prefix_share:
            self._register_prefix(key_tokens, chain)
        retained = sum(
            1 for p in self.prefix_index._nodes
            if p < self.n_pages and self.pool.refcount(p) == 0
        )
        self.stats["peak_resident_pages"] = max(
            self.stats["peak_resident_pages"],
            self.pool.outstanding + retained,
        )
        self.lifecycle.activate(slot, req, first, tlen)

    def _register_prefix(self, tokens: list[int], chain: list[int]) -> None:
        """Index the full pages of ``tokens`` (the trie key sequence, one
        key per cache position) so later prompts can share them."""
        n = len(tokens) // self.page_size
        if n:
            self.prefix_index.insert(tokens, chain[:n])
