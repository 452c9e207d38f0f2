"""Batched serving engine: continuous batching over a paged KV cache, and
the legacy dense cache that is its oracle.

Ported from ``repro/serving/engine.py``. The engine owns ``n_slots`` decode
lanes. It serves every family of the port: dense, MoE, SSM (falcon-mamba-7b),
hybrid (zamba2-1.2b) and the multimodal VLM (llava-next-mistral-7b) and
enc-dec (whisper-medium), in one of two modes:

- paged (the default): a shared pool of fixed-size pages with per-slot
  page tables (:mod:`repro_torch.serving.kvcache`). Admission runs chunked
  prefill at true prompt length, writing each chunk's K/V straight into
  the slot's pages and its recurrent state into the slot's rows; decode
  advances every active slot through one batched ``decode_paged`` step;
- dense (``paged=False``): one ``(n_slots, max_seq)`` cache. Admission is
  synchronous: the prompt is right-aligned in a power-of-two bucket of at
  least 32, left-padded with token 0 (the pads are attended), prefilled in
  one ``prefill`` call, and the zero-padded result is written over the
  whole slot row; the first token comes from the last position and the
  admitted length is the bucket. Decode runs ``decode_step`` over every
  slot (``decode_attention`` on the dense cache).

What carries over from the reference, with the same semantics and the same
``stats`` counters:

- iteration-level continuous batching under the scheduler's per-step token
  budget (``_admission_scan``, ``_pump_prefill``/``_advance_prefill``/
  ``_finish_prefill``), and the synchronous mode ``token_budget=None``,
  which drains each prefill inside its admission and is the oracle for
  continuous batching;
- copy-on-write prefix sharing through the prefix trie, with the COW copy
  of a partially used shared page on a whole-prompt hit (``_copy_pages``);
  for families with per-slot recurrent state (``model.paged_state``: the
  SSM and hybrid families) the trie is bookkeeping only, as in the
  reference (``engine.py:521-527,1869-1873,2015-2031``): it counts would-be
  hits through phantom page ids registered at admission, and prefill is
  never skipped (a preempted request re-prefills from offset 0);
- deferral of a request whose prefix an in-flight prefill is about to
  register (``_await_inflight_prefix``);
- token-exact preemption with re-prefill resume, shedding of expired and
  overflowing requests, ``cancel`` and teacher forcing (``step(
  force_tokens=...)``), and ``active_cap``, the lanes an elastic cell
  (:mod:`repro_torch.serving.cell`) lets admission fill;
- host-side sampling from numpy Gumbel noise keyed by (seed, position)
  (``_choose``), so sampled streams match the reference's exactly;
- the spill tier (``remote_pool``, a
  :class:`~repro_torch.serving.kvcache.RemotePagePool`): cached prefix
  pages that reallocation would destroy are lent to peer hosts and leave
  trie stubs (``_retire_cached``); a prefix hit recalls them within
  ``recall_budget`` pages, re-planning after a miss (``_try_admit_paged``);
  a preemption lends the slot's whole chain and re-admission recalls it
  with no token recomputed (``_try_admit_recall``); ``write_behind``
  stages each decode page on a peer as it fills. A recalled lane sits out ``slot_hold`` decode steps,
  the simulated transfer time at ``decode_step_s`` per step. Pages move
  through the batched ``extract_page_payloads``/``install_page_payloads``,
  in the reference's payload bytes. Families with per-slot recurrent state
  accept a pool and never spill, as in the reference;
- ``snapshot``/``restore`` in both modes, in the reference's blob format
  and meta fields (paper §III-D continuity): a snapshot of either package
  restores in the other, spilled trie stubs and slot-spill groups
  included. A restore revalidates each lease against the cloudlet's live
  membership; without a remote pool, spilled stubs are evicted (their
  prefixes are recomputed) and spilled slot chains fall back to
  re-prefill;
- speculative decoding (``draft``, ``draft_params``, ``spec_k``): a draft
  model proposes ``spec_k`` tokens a lane by as many paged decode steps,
  and the target verifies the window ``[last, d1..dk]`` in one
  ``verify_paged`` pass, which folds the window into its decode step, so
  the committed tokens are plain decode's (``_spec_step``). The draft's
  page pools ride in ``self.cache`` under ``draft_``, addressed by the
  target's page tables, so COW, prefix sharing, spill, preemption and
  snapshots carry them with no bookkeeping of their own. The draft rides
  every prefill chunk and every decode step that does not speculate;
- ``fork``: sampling children split off a live slot, sharing its full
  committed pages copy-on-write;
- the multimodal families (``engine.py:396-760, 1490-1860``): a request
  carries ``extra={"embeds": ...}`` (VLM) or ``extra={"frames": ...}``
  (enc-dec). VLM image rows take ordinary cache positions ahead of the
  text, chunked inline, keyed in the trie by a CRC of each row's bytes, so
  a shared image and text prefix shares pages like text. An enc-dec
  request also holds a cross-attention region, a page chain of its own
  (``cross_table``, ``cross_len``) filled once by the family's
  ``prefill_cross``: requests with the same frames share one region
  (a full-chain trie hit on the frames' content keys skips the encoder),
  a released region stays cached for the next, and cold region pages
  spill and recall through the remote pool like prefix pages, each page's
  payload carrying its own region's leaves only. Decoder prompt keys are
  salted with the frames' digest: the same text under other frames never
  shares. A preempted enc-dec slot re-prefills (no chain spill, no
  write-behind), and a multimodal target takes no draft, as in the
  reference.

One deliberate difference: a lane whose chunked prefill is still in flight
keeps its recurrent state through the batched decode steps that run
meanwhile, bit for bit (``_decode_step``). The reference's decode advances
the conv/SSM state of every lane, that one included (ROADMAP Queue 3, R3).

The model's entry points update the page pools in place; the JAX engine
donates its cache to the jitted step for the same reason
(``engine.py:612-613``).

On a mesh (the materialized elastic cell, ``serving/cell.py``) the paged
engine's weights and pool are DTensors: :meth:`ServeEngine.lay_out` places
the pool by ``paged_cache_shardings`` and lifts the paged entry points onto
the mesh (``parallel.partition.on_mesh``); they write K/V into the local
blocks in place, and logits come back whole.
A snapshot serializes whole tensors, so its bytes do not depend on the
layout; a restore into a laid-out engine lays the pool out again.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import weakref
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.checkpoint.elastic import place
from repro_torch.checkpoint.serializer import deserialize_tree, serialize_tree
from repro_torch.models.model_api import ModelFns
from repro_torch.parallel.partition import on_mesh
from repro_torch.serving.kvcache import (
    PagePool,
    PrefixIndex,
    RemotePagePool,
    SpilledPage,
    expand_prefill_cache,
    extract_page_payloads,
    init_cache,
    init_paged_cache,
    install_page_payloads,
    pages_needed,
    paged_cache_shardings,
    scatter_slot,
)
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

# Trie key namespaces of multimodal content (``engine.py:143-160``): text
# ids are < 2^32 and salted keys < 2^70, so keys made from modality bytes
# never collide with a text prompt's, nor the three kinds with each other.
_MM_NS = 1 << 70                    # VLM image-embedding rows
_CROSS_NS = 2 << 70                 # enc-dec encoder-frame rows
_CROSS_PAD = 1 << 33                # cross-key pad sentinel (crc32 < 2^32)
_SALT_SHIFT = 34                    # frames-digest salt of enc-dec keys


def _content_keys(arr) -> list[int]:
    """One key per modality row (image patch, audio frame): a CRC of its
    raw bytes, stable across processes and packages, so a restored
    engine's trie keys keep matching."""
    a = np.ascontiguousarray(np.asarray(arr))
    return [zlib.crc32(r.tobytes()) for r in a.reshape(-1, a.shape[-1])]


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
    # spill-backed preemption: cache positions held by the slot-spill group
    # lease-tracked under this request's id in the RemotePagePool (0 = no
    # spilled chain; ``resume`` stays set as the recall-miss fallback)
    spill_len: int = 0
    shed: bool = False     # dropped by the scheduler, not completed
    # sampling: temperature 0 is greedy; > 0 draws per-position Gumbel
    # noise from ``seed`` (a sampled stream is a function of prompt + seed)
    temperature: float = 0.0
    seed: int = 0
    # modality inputs: ``embeds`` (VLM) or ``frames`` (enc-dec), numpy
    extra: dict = field(default_factory=dict)
    generated: list[int] = field(default_factory=list)
    slot: int | None = None
    done: bool = False
    # memo for derived trie keys and modality lengths (pure functions of the
    # immutable prompt and extra): not snapshotted, recomputed after restore
    key_cache: dict = field(default_factory=dict, repr=False)


def _bucket(n: int, minimum: int = 32) -> int:
    """The dense prefill's length: the least power-of-two multiple of
    ``minimum`` that holds ``n``."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _encode_extra(extra: dict) -> dict:
    """JSON-encode modality arrays for the snapshot meta."""
    out = {}
    for k, v in extra.items():
        a = np.asarray(v)
        out[k] = {
            "dtype": str(a.dtype),
            "shape": list(a.shape),
            "data": base64.b64encode(np.ascontiguousarray(a).tobytes()).decode(),
        }
    return out


def _decode_extra(enc: dict) -> dict:
    out = {}
    for k, ent in enc.items():
        dt = np.dtype(ent["dtype"])
        out[k] = np.frombuffer(
            base64.b64decode(ent["data"]), dt).reshape(ent["shape"])
    return out


def _draft_view(cache: dict) -> dict:
    """The draft model's leaves of an engine cache, under their own names
    (the same tensors: the draft's entry points update them in place)."""
    return {k[6:]: v for k, v in cache.items() if k.startswith("draft_")}


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
    (fresh prefill, resume re-prefill and recall resume): the page-table
    row mirrors the chain, ``lengths`` counts cache-resident positions,
    ``last_token`` is the last committed token. It holds its engine
    through a weak proxy: a strong reference back would make a cycle, and a
    dropped engine's device pool would then wait for the cyclic collector
    (the batch tier drops an engine per finished or cancelled replica)."""

    def __init__(self, engine: "ServeEngine"):
        self.eng = weakref.proxy(engine)

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

    def resume_recalled(self, slot: int, req: Request, length: int) -> None:
        """Recall hit: the slot's cache already holds every committed
        position (installed verbatim from the spilled chain), so the stream
        picks up at its last committed token, with nothing recomputed."""
        eng = self.eng
        req.resume = []
        req.key_cache.pop("admit_keys", None)
        eng.lengths[slot] = length
        eng.last_token[slot] = req.generated[-1]


@dataclass
class _PrefillTask:
    """One admission's chunked prefill, in flight across engine steps. The
    slot's pages are allocated and its request bound when the task is
    created; the slot's page-table row stays on the scratch page until the
    last chunk lands, so the batched decode's inert write for this lane
    never touches real (possibly shared) pages."""

    req: Request
    tlen: int                    # image rows + prompt + resume positions
    mm: int                      # inline image positions (VLM)
    ptoks: list[int]             # prompt + resume (text positions)
    offset: int                  # next position to compute
    key_tokens: list[int]        # trie keys registered at completion
    embeds: np.ndarray | None = None    # (mm, VISION_D) image rows, VLM
    logits: torch.Tensor | None = None  # last chunk's logits


class ServeEngine:
    def __init__(
        self,
        model: ModelFns,
        params: nn.Module,
        *,
        n_slots: int = 8,
        max_seq: int = 1024,
        max_cross_seq: int | None = None,
        paged: bool | None = None,
        page_size: int = 64,
        n_pages: int | None = None,
        prefill_chunk: int = 256,
        prefix_share: bool | None = None,
        remote_pool: RemotePagePool | None = None,
        recall_budget: int = 8,
        write_behind: bool = False,
        decode_step_s: float = 5e-3,
        active_cap: int | None = None,
        scheduler: SchedulerConfig | None = None,
        draft: ModelFns | None = None,
        draft_params: nn.Module | None = None,
        spec_k: int = 4,
        device: str | torch.device = "cuda",
    ):
        if paged is None:
            paged = model.supports_paged
        elif paged and not model.supports_paged:
            raise ValueError(
                f"{model.cfg.arch_id}: family has no paged serving path; "
                "use paged=False")
        if remote_pool is not None and not paged:
            raise ValueError(
                "the spill tier needs the paged cache; use paged=True")
        # multimodal capabilities (orthogonal to paged): inline image rows
        # in the prompt (VLM), a paged cross-attention region (enc-dec)
        self._mm = getattr(model, "paged_mm_inline", False)
        self.cross = paged and model.supports_paged_cross
        if draft is not None:
            # the reference's checks and messages (engine.py:411-433)
            if not paged:
                raise ValueError("speculative decoding needs the paged cache")
            if self._mm or model.supports_paged_cross:
                raise ValueError(
                    "speculative decoding covers text-only paged families")
            if not model.supports_spec_decode:
                raise ValueError(
                    f"{model.cfg.arch_id}: family has no paged verify path")
            if not draft.supports_spec_decode:
                raise ValueError(
                    f"{draft.cfg.arch_id}: draft family cannot share paged "
                    "decode state")
            if draft.cfg.vocab_size != model.cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft.cfg.vocab_size} != target vocab "
                    f"{model.cfg.vocab_size}: accepted draft tokens must be "
                    "target tokens")
            if spec_k < 1:
                raise ValueError("spec_k must be >= 1")
        self.device = resolve_device(device)
        for what, ps in (("params", params), ("draft_params", draft_params)):
            if ps is not None and any(p.device != self.device
                                      for p in ps.parameters()):
                raise ValueError(f"{what} are not all on {self.device}")
        self.model = model
        self.params = params
        self.mesh = None  # the mesh the pool is laid out on (lay_out)
        self._draft = draft
        self.draft_params = draft_params
        self.spec_k = spec_k
        self.paged = paged
        self.n_slots = n_slots
        # elastic serving: a cell may cap concurrent decode lanes below
        # n_slots when its survivor grid shrinks (slots stay allocated so
        # snapshots keep their shape; admission just stops above the cap)
        self.active_cap = active_cap
        self.sched = Scheduler(scheduler, decode_step_s=decode_step_s)
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
        # every key of the reference engine (engine.py:444-489)
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
        self._admit_ready = True  # new submits / freed pages to try
        self.remote_pool = remote_pool
        if not paged:
            # the trie, the page pool and the spill tier belong to the
            # paged cache
            self.prefix_cache = self.prefix_share = False
            self.spill = self.write_behind = False
            self.cache = init_cache(model, n_slots, max_seq,
                                    device=self.device)
            return

        self.page_size = page_size
        self.max_pages = -(-max_seq // page_size)
        # the cross region's capacity (enc-dec): pages a slot holds for the
        # encoder output, beside its decoder pages
        self.max_cross_seq = ((max_cross_seq if max_cross_seq is not None
                               else max_seq) if self.cross else 0)
        self.max_cross_pages = -(-self.max_cross_seq // page_size)
        # default pool: full capacity (one spare page for scratch)
        self.n_pages = (n_pages if n_pages is not None
                        else n_slots * (self.max_pages + self.max_cross_pages)
                        + 1)
        self.pool = PagePool(self.n_pages)
        self.page_table = np.zeros((n_slots, self.max_pages), np.int32)
        self.slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
        if self.cross:
            self.cross_table = np.zeros((n_slots, self.max_cross_pages),
                                        np.int32)
            self.cross_len = np.zeros((n_slots,), np.int32)
            self.slot_cross_pages: list[list[int]] = [
                [] for _ in range(n_slots)]
        self.prefill_chunk = min(prefill_chunk, self.max_pages * page_size)
        # prefix sharing through the trie: on by default; families with
        # recurrent state (not page-addressable) keep trie bookkeeping only
        enabled = True if prefix_share is None else prefix_share
        self.prefix_cache = enabled
        self.prefix_share = enabled and model.supports_prefix_sharing
        self.prefix_index = PrefixIndex(page_size)
        self._phantom_next = self.n_pages  # bookkeeping-only node ids
        # spill tier: lend cold cached pages to peer hosts instead of
        # evicting them (only with page-addressable prefix sharing:
        # recurrent state cannot be lent page-wise)
        self.recall_budget = recall_budget
        self.decode_step_s = decode_step_s
        self.spill = remote_pool is not None and self.prefix_share
        # write-behind: stage each decode page on a peer as it fills, so a
        # later preemption ships only the unstaged remainder (an enc-dec
        # slot's chain does not spill: cross regions have their own path)
        self.write_behind = bool(write_behind) and self.spill \
            and not self.cross
        self.spilled: dict[int, SpilledPage] = {}
        self._spill_next = self.n_pages  # stub ids, never page-table ids
        # decode steps a slot sits out after a recall (the simulated
        # transfer time)
        self.slot_hold = np.zeros((n_slots,), np.int32)
        self.cache = init_paged_cache(model, n_slots, self.n_pages,
                                      page_size, device=self.device)
        if draft is not None:
            # the same n_slots / n_pages / page_size: the target's page
            # tables address the draft's pools too (engine.py:545-598)
            for k, v in init_paged_cache(draft, n_slots, self.n_pages,
                                         page_size,
                                         device=self.device).items():
                self.cache["draft_" + k] = v

            def draft_decode(dparams, cache, batch) -> torch.Tensor:
                return draft.decode_paged(dparams, _draft_view(cache), batch)

            def draft_prefill(dparams, cache, batch, *, offset) -> None:
                draft.prefill_chunk(dparams, _draft_view(cache), batch,
                                    offset=offset)

            # one attribute each, as the reference's jitted hooks: a test
            # may wrap ``_draft_decode``
            self._draft_decode = draft_decode
            self._draft_prefill = draft_prefill

    # ------------------------------------------------------------- helpers
    def _tensor(self, arr) -> torch.Tensor:
        a = np.asarray(arr)
        if not a.flags.writeable:   # a restored request's extra
            a = a.copy()
        return torch.as_tensor(a).to(self.device)

    def _target(self) -> dict:
        """The target model's leaves of the cache (the draft's ride under
        ``draft_``)."""
        if self._draft is None:
            return self.cache
        return {k: v for k, v in self.cache.items()
                if not k.startswith("draft_")}

    # --------------------------------------------------------- multimodal
    def _mm_len(self, req: Request) -> int:
        """Cache positions a VLM request's image rows take ahead of its
        text; 0 for every other family."""
        if self._mm and "embeds" in req.extra:
            if "mm_len" not in req.key_cache:
                req.key_cache["mm_len"] = int(
                    np.asarray(req.extra["embeds"]).shape[-2])
            return req.key_cache["mm_len"]
        return 0

    def _total_len(self, req: Request) -> int:
        return self._mm_len(req) + len(req.prompt)

    def _frames_salt(self, req: Request) -> int:
        """CRC of the request's whole frames: mixed into every enc-dec trie
        key, so regions and prompts share only on an exact match of the
        whole input."""
        if "salt" not in req.key_cache:
            req.key_cache["salt"] = zlib.crc32(np.ascontiguousarray(
                np.asarray(req.extra["frames"])).tobytes())
        return req.key_cache["salt"]

    def _key_tokens(self, req: Request) -> list[int]:
        """Trie key sequence of the prompt pages (``engine.py:651-671``): a
        VLM's image rows lead as content keys; an enc-dec prompt's text is
        salted with the frames' digest (its K/V depends on the encoder
        input through cross attention)."""
        if "key_tokens" not in req.key_cache:
            if self._mm and "embeds" in req.extra:
                ks = [_MM_NS | c for c in _content_keys(req.extra["embeds"])
                      ] + list(req.prompt)
            else:
                ks = self._gen_keys(req, req.prompt)
            req.key_cache["key_tokens"] = ks
        return req.key_cache["key_tokens"]

    def _gen_keys(self, req: Request, toks: list[int]) -> list[int]:
        """Trie keys of text tokens past the image rows: the ids, salted
        with the frames' digest for enc-dec as the prompt's are."""
        if self.cross and "frames" in req.extra:
            salt = (self._frames_salt(req) + 1) << _SALT_SHIFT
            return [t + salt for t in toks]
        return list(toks)

    def _admit_keys(self, req: Request) -> list[int]:
        """Trie key sequence for admission: the prompt's keys plus one key
        per ``resume`` token. Memoized until the resume suffix changes."""
        if "admit_keys" not in req.key_cache:
            req.key_cache["admit_keys"] = (self._key_tokens(req)
                                           + self._gen_keys(req, req.resume))
        return req.key_cache["admit_keys"]

    def _cross_keys(self, req: Request) -> list[int]:
        """Trie key sequence of the encoder region: a content key per frame,
        padded to whole pages with a sentinel, every key mixing in the
        whole frames' digest (``engine.py:694-707``): the encoder is
        non-causal, so frames that are a page-aligned prefix of a longer
        cached input must not hit its region."""
        if "cross_keys" not in req.key_cache:
            ns = _CROSS_NS | (self._frames_salt(req) << _SALT_SHIFT)
            ks = [ns | c for c in _content_keys(req.extra["frames"])]
            pad = -len(ks) % self.page_size
            req.key_cache["cross_keys"] = ks + [ns | _CROSS_PAD] * pad
        return req.key_cache["cross_keys"]

    def _n_frames(self, req: Request) -> int:
        if "n_frames" not in req.key_cache:
            req.key_cache["n_frames"] = int(
                np.asarray(req.extra["frames"]).shape[-2])
        return req.key_cache["n_frames"]

    def _cross_batch(self, batch: dict, slot: int | None = None) -> dict:
        """``batch`` with the cross tables an enc-dec entry point reads:
        every slot's, or one slot's row (a prefill chunk)."""
        if self.cross:
            if slot is None:
                batch["cross_page_table"] = self._tensor(self.cross_table)
                batch["cross_len"] = self._tensor(self.cross_len)
            else:
                batch["cross_page_table"] = self._tensor(
                    self.cross_table[slot])
                batch["cross_len"] = self._tensor(self.cross_len[slot])
        return batch

    # ------------------------------------------------------------- interface
    def submit(self, prompt: list[int], *, max_new_tokens: int = 16,
               eos_id: int | None = None, extra: dict | None = None,
               priority: int = 0, deadline_ms: float | None = None,
               temperature: float = 0.0, seed: int = 0) -> Request:
        """Queue a request. A VLM request carries ``extra={"embeds": (1,
        n_image_tokens, VISION_D)}``, an enc-dec one ``extra={"frames": (1,
        S_enc, d_model)}`` (numpy); the checks and messages are the
        reference's (``engine.py:715-760``)."""
        extra = dict(extra or {})
        probe = Request(-1, list(prompt), max_new_tokens, eos_id, extra=extra)
        allowed = ({"embeds"} if self._mm else set()) | (
            {"frames"} if self.cross else set())
        if self.paged and set(extra) - allowed:
            raise ValueError(
                f"unsupported modality extras {sorted(set(extra) - allowed)} "
                "for this family's paged path; construct the engine with "
                "paged=False")
        if self._mm and "embeds" not in extra:
            raise ValueError("vlm requests need extra={'embeds': ...}")
        if self.cross and "frames" not in extra:
            raise ValueError("enc-dec requests need extra={'frames': ...}")
        tlen = self._total_len(probe)
        if not 1 <= len(prompt) or not tlen < self.max_seq:
            raise ValueError(
                f"prompt length {len(prompt)} (+{tlen - len(prompt)} "
                f"modality positions) outside [1, {self.max_seq})")
        if self.paged:
            need = pages_needed(min(tlen + max_new_tokens, self.max_seq),
                                self.page_size)
            if self.cross:
                n_cp = pages_needed(self._n_frames(probe), self.page_size)
                if (n_cp > self.max_cross_pages
                        or self._n_frames(probe) > self.max_cross_seq):
                    raise ValueError(
                        f"{self._n_frames(probe)} frames exceed "
                        f"max_cross_seq={self.max_cross_seq}")
                need += n_cp
            if need > self.n_pages - 1:
                raise ValueError(
                    f"request needs {need} pages but the pool only has "
                    f"{self.n_pages - 1} allocatable pages")
        req = Request(self._req_counter, list(prompt), max_new_tokens, eos_id,
                      priority=priority, deadline_ms=deadline_ms,
                      arrival_step=self.steps,
                      temperature=temperature, seed=seed, extra=extra)
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
        if self.paged and self.remote_pool is not None:
            # drop the slot-spill group (a preempted chain or write-behind
            # staged pages): nobody will recall it
            self.remote_pool.release_slot(req_id)
            req.spill_len = 0
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
        if self.paged and not self.sched.cfg.synchronous:
            self._shed_pass()
            self._admission_scan()
            lanes = [i for i, r in enumerate(self.slot_req)
                     if r is not None and i not in self.prefilling
                     and not self.slot_hold[i]]
            # a speculating lane takes its whole draft + verify window of
            # the step's token budget; prefill gets what is left
            per_lane = (self._spec_tokens_per_lane()
                        if force_tokens is None
                        and self._spec_feasible(lanes) else 1)
            prefill_used = self._pump_prefill(
                self.sched.prefill_budget(len(lanes), bool(self.prefilling),
                                          tokens_per_lane=per_lane))
            self._preempt_pass()
        else:
            prefill_used = self._admit()
        if self.paged:
            held = self.slot_hold > 0
            active = [i for i, r in enumerate(self.slot_req)
                      if r is not None and not held[i]
                      and i not in self.prefilling]
            self.slot_hold[held] -= 1
            if not active:
                if held.any() or self.prefilling:   # time passes
                    self.steps += 1
                self.last_step_tokens = prefill_used
                return 0
        else:
            active = [i for i, r in enumerate(self.slot_req) if r is not None]
            if not active:
                self.last_step_tokens = prefill_used
                return 0
        if force_tokens is None and self._spec_feasible(active):
            # a speculative round completes within the step: no half-verified
            # window is left for snapshot, preemption or cancel to see
            self._spec_step(active)
            self.steps += 1
            self.last_step_tokens = (
                prefill_used + len(active) * self._spec_tokens_per_lane())
            return len(active)
        batch = {
            "tokens": self._tensor(self.last_token[:, None]),
            "positions": self._tensor(self.lengths),
        }
        if self.paged:
            batch["page_table"] = self._tensor(self.page_table)
            logits = self._decode_step(self._cross_batch(batch))
            if self._draft is not None:
                # keep the draft's cache complete at every position through
                # the steps that do not speculate (forcing, budget fallback)
                self._draft_decode(self.draft_params, self.cache, batch)
        else:
            logits = self.model.decode_step(self.params, self.cache, batch)
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

    def _decode_step(self, batch: dict) -> torch.Tensor:
        """One batched ``decode_paged`` step. It runs every lane; a lane
        whose chunked prefill is in flight gets its recurrent state rows
        (every non-page leaf, ``(layers, n_slots, ...)``) back afterwards,
        bit for bit, so its next chunk continues from the state its last
        chunk left (R3). Its attention K/V write already goes to the
        scratch page through its page-table row."""
        hold = sorted(self.prefilling) if self.model.paged_state else []
        saved = {}
        if hold:
            idx = torch.tensor(hold, device=self.device)
            saved = {k: v[:, idx] for k, v in self.cache.items()
                     if not k.endswith("_pages")}
        logits = self.model.decode_paged(self.params, self._target(), batch)
        for k, rows in saved.items():
            self.cache[k][:, idx] = rows
        return logits

    # ------------------------------------------------- speculation / fork
    def _spec_tokens_per_lane(self) -> int:
        """Step-budget cost of one speculating lane: k draft proposals, one
        draft cache-fill step (position n+k) and a k+1-token verify."""
        return 2 * self.spec_k + 2

    def _spec_feasible(self, lanes: list[int]) -> bool:
        """Speculate this step? It needs a draft, every lane at least
        ``spec_k + 1`` positions from the sequence cap (the window never
        writes past ``max_seq``), and under a continuous scheduler a token
        budget that covers every lane's window (else plain decode); the
        synchronous mode always speculates."""
        if self._draft is None or not lanes:
            return False
        k = self.spec_k
        if any(self.lengths[i] + k + 1 >= self.max_seq for i in lanes):
            return False
        if self.sched.cfg.synchronous:
            return True
        return (len(lanes) * self._spec_tokens_per_lane()
                <= self.sched.cfg.token_budget)

    def _spec_step(self, active: list[int]) -> None:
        """One speculative round for every active lane, batched
        (``engine.py:1009-1105``).

        With ``lengths[i] = n``: the draft proposes ``d1..dk`` by k paged
        decode steps fed ``[last, d1..d_{k-1}]`` at positions ``n..n+k-1``
        (and one more for ``d_k`` at ``n+k``, so that a fully accepted
        window leaves no hole in the draft's cache); a sampled lane's guess
        takes its own ``(seed, position)`` noise. The target verifies
        ``[last, d1..dk]`` in one ``verify_paged`` pass, whose logits
        ``L_0..L_k`` are k+1 plain decode steps' (``g_{j+1}`` chosen from
        ``L_j``). The longest prefix with ``d_j == g_j`` is accepted and
        ``g_1..g_{a+1}`` commit through ``_commit_token``. A rejection rolls
        back by page offset alone: ``lengths`` stops at ``n+a+1``, and K/V
        written past it sits beyond every length mask until it is written
        again in order. Every speculative write lands at or beyond
        ``lengths``, so write-behind's full pages stay immutable.

        Lanes that do not speculate (idle, prefilling, recall-held) ride
        through the batched calls as inert lanes: position 0 on the
        scratch page. The reference rides a held lane at its own
        positions, where JAX drops a write past the page table; here a
        window past the table would index beyond it. Nothing is lost: a
        held lane's first real step writes its K/V at ``lengths``."""
        k = self.spec_k
        inert = np.ones((self.n_slots,), bool)
        inert[active] = False
        n0 = np.where(inert, 0, self.lengths).astype(np.int32)
        rows = self.page_table.copy()
        rows[inert] = 0
        table = self._tensor(rows)
        sampled = self._any_sampled(active)
        toks = self.last_token.copy()
        pos = n0.copy()
        draft_toks = np.zeros((self.n_slots, k), np.int32)
        for j in range(k + 1):
            batch = {"tokens": self._tensor(toks[:, None]),
                     "positions": self._tensor(pos), "page_table": table}
            dlogits = self._draft_decode(self.draft_params, self.cache, batch)
            if j < k:
                nxt = dlogits.argmax(dim=-1).cpu().numpy().astype(np.int32)
                if sampled:
                    drows = dlogits.float().cpu().numpy()
                    for i in active:
                        req = self.requests[self.slot_req[i]]
                        if req.temperature > 0:
                            nxt[i] = self._choose(drows[i], req, int(pos[i]))
                draft_toks[:, j] = nxt
                toks = nxt
            pos = pos + 1
        window = np.concatenate([self.last_token[:, None], draft_toks], axis=1)
        vbatch = {"tokens": self._tensor(window),
                  "positions": self._tensor(n0), "page_table": table}
        vlogits = self.model.verify_paged(self.params, self._target(), vbatch)
        greedy = vlogits.argmax(dim=-1).cpu().numpy()
        vrows = vlogits.float().cpu().numpy() if sampled else None
        for i in active:
            req = self.requests[self.slot_req[i]]
            base = int(n0[i])
            if vrows is not None and req.temperature > 0:
                target = [self._choose(vrows[i, j], req, base + j)
                          for j in range(k + 1)]
            else:
                target = [int(greedy[i, j]) for j in range(k + 1)]
            a = 0
            while a < k and int(draft_toks[i, a]) == target[a]:
                a += 1
            self.stats["spec_rounds"] += 1
            self.stats["spec_proposed"] += k
            self.stats["spec_accepted"] += a
            for tok in target[: a + 1]:
                if self._commit_token(i, req, tok):
                    break

    def fork(self, req_id: int, n: int, *, temperature: float = 1.0,
             seeds: list[int] | None = None) -> list[Request]:
        """Fork ``n`` sampling children off a live decode slot
        (``engine.py:1107-1193``). Each child continues the parent's stream
        from its current position: every full committed page is shared
        copy-on-write (a refcount, no copy), the partly filled last page is
        copied into the child's first private page, and the rest of its
        capacity is allocated privately. Children diverge through their own
        ``(temperature, seed)``; the shared pages stay read-only, since
        every lane writes only past its fork length. The parent's
        write-behind staging carries over to each child for the shared
        pages. An enc-dec child shares its parent's encoder region. Needs
        ``n`` free slots and the pages; raises ``ValueError`` before any
        side effect otherwise."""
        assert self.paged, "fork needs the paged cache"
        req = self.requests[req_id]
        slot = req.slot
        if slot is None or slot in self.prefilling:
            raise ValueError("fork needs an active decode slot")
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        if len(free) < n:
            raise ValueError(f"fork of {n} needs {n} free slots, "
                             f"have {len(free)}")
        P = self.page_size
        chain = self.slot_pages[slot]
        length = int(self.lengths[slot])
        full = length // P
        partial = length % P != 0
        need = pages_needed(
            min(self._total_len(req) + req.max_new_tokens, self.max_seq), P)
        priv_n = need - full
        if n * priv_n > self.pool.available:
            raise ValueError(f"fork of {n} needs {n * priv_n} pages, "
                             f"have {self.pool.available}")
        seeds = list(seeds) if seeds is not None else list(range(n))
        if len(seeds) != n:
            raise ValueError(f"need {n} seeds, got {len(seeds)}")
        children: list[Request] = []
        for c, seed in zip(free[:n], seeds):
            child = Request(self._req_counter, list(req.prompt),
                            req.max_new_tokens, req.eos_id,
                            priority=req.priority, arrival_step=self.steps,
                            temperature=temperature, seed=seed,
                            extra=dict(req.extra))
            self._req_counter += 1
            child.generated = list(req.generated)
            self.requests[child.req_id] = child
            self.pool.share(chain[:full])
            priv = self.pool.alloc(priv_n)
            assert priv is not None  # guaranteed by the pre-check
            self._retire_cached(priv)
            if partial:
                _copy_pages(self.cache, chain[full], priv[0])
                self.stats["cow_copies"] += 1
            cchain = chain[:full] + priv
            self.slot_pages[c] = cchain
            self.page_table[c, :] = 0
            self.page_table[c, : len(cchain)] = cchain
            self.lengths[c] = length
            self.last_token[c] = self.last_token[slot]
            self.slot_req[c] = child.req_id
            child.slot = c
            if self.cross:
                # the child reads the parent's encoder region (one more
                # reference); the reference engine leaves the child's
                # cross table empty (ROADMAP Queue 3, R6)
                region = self.slot_cross_pages[slot]
                self.pool.share(region)
                self.slot_cross_pages[c] = list(region)
                self.cross_table[c] = self.cross_table[slot]
                self.cross_len[c] = self.cross_len[slot]
            # the parent's staged pages are immutable and now shared: the
            # child's spill group stages them too (a lease has one
            # borrower), so its preemption ships only pages past the fork
            if self.write_behind:
                for idx in self.remote_pool.staged_pages(req.req_id):
                    if idx < full and self.remote_pool.stage_page(
                            child.req_id, idx,
                            extract_page_payloads(self.cache,
                                                  [cchain[idx]])[0]):
                        self.stats["pages_staged"] += 1
            self.stats["forks"] += 1
            self.stats["fork_shared_pages"] += full
            children.append(child)
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       self.pool.outstanding)
        return children

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
        if self.write_behind and self.lengths[i] % self.page_size == 0:
            # a chain page just filled; a full page is immutable (every
            # position below ``lengths`` is committed), so its bytes can be
            # staged on a peer now, and a later preemption ships only the
            # unstaged remainder. Fail-soft when no peer has room.
            idx = int(self.lengths[i]) // self.page_size - 1
            page = self.slot_pages[i][idx]
            blob = extract_page_payloads(self.cache, [page])[0]
            if self.remote_pool.stage_page(req.req_id, idx, blob):
                self.stats["pages_staged"] += 1
        return False

    def _finish_request(self, i: int, req: Request) -> None:
        """Completion: register the slot's fully committed pages — prompt
        and generated — in the prefix trie before release, so a later
        prompt extending this transcript shares them."""
        if self.paged and self.prefix_share:
            covered = int(self.lengths[i])
            gen = req.generated[: covered - self._total_len(req)]
            self._register_prefix(
                self._key_tokens(req) + self._gen_keys(req, gen),
                self.slot_pages[i])
        if self.paged and self.remote_pool is not None:
            # write-behind staged pages die with the request
            self.remote_pool.release_slot(req.req_id)
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
        if self.paged and self.prefilling:
            self._pump_prefill(None)
        return self._step_prefill_tokens

    def _admission_scan(self) -> None:
        """Admit waiting requests into free slots in the scheduler's order.
        Under page pressure a lower-ranked request whose cached prefix
        shrinks its private-page need may be admitted past a blocked
        higher-ranked one, only while the blocked request's aged lead stays
        below ``bypass_margin``."""
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        if self.active_cap is not None:
            headroom = self.active_cap - sum(
                r is not None for r in self.slot_req)
            free = free[:max(0, headroom)]
        if not self.paged:
            while free and self.queue:
                req = self.sched.order(self.queue, self.steps)[0]
                self.queue.remove(req)
                self._prefill_into(free.pop(0), req)
            return
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
        re-derived and verified then.

        With the spill tier the slot's used chain (prompt and generated
        positions, the partly filled last page included) is also lent as a
        slot-spill group keyed by the request id, skipping pages already
        staged by write-behind; re-admission recalls it whole and resumes
        with no token recomputed. The ``resume`` fallback stays armed for a
        lost or over-budget chain."""
        req = self.requests[req_id]
        slot = req.slot
        assert self.paged, "preemption needs the paged cache"
        if slot is None or slot in self.prefilling:
            raise ValueError("only active decode slots can be preempted")
        if self.prefix_cache:
            covered = int(self.lengths[slot])
            gen = req.generated[: covered - self._total_len(req)]
            self._register_prefix(
                self._key_tokens(req) + self._gen_keys(req, gen),
                self.slot_pages[slot])
        if self.spill and not self.cross:
            # only the pages holding real positions travel; staged indices
            # are already on a peer
            length = int(self.lengths[slot])
            chain = self.slot_pages[slot]
            staged = self.remote_pool.staged_pages(req.req_id)
            idxs = [i for i in range(pages_needed(length, self.page_size))
                    if i not in staged]
            blobs = extract_page_payloads(self.cache, [chain[i] for i in idxs])
            if self.remote_pool.spill_slot(req.req_id, dict(zip(idxs, blobs))):
                req.spill_len = length
                self.stats["preempt_spills"] += 1
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
        one victim per step. Among equal-priority victims the one whose
        chain is cheapest to move (most pages already staged) goes
        first."""
        if self.sched.cfg.preempt_margin is None or not self.queue:
            return
        cand = min(self.queue,
                   key=lambda r: (-r.priority, r.arrival_step, r.req_id))
        active = [self.requests[r] for i, r in enumerate(self.slot_req)
                  if r is not None and i not in self.prefilling
                  and not self.slot_hold[i]]
        victim = self.sched.pick_victim(cand, active,
                                        spill_cost=self._spill_cost)
        if victim is not None:
            self.preempt(victim.req_id)

    def _spill_cost(self, req: Request) -> int:
        """Pages a preemption of ``req`` would still have to move: its used
        chain less the pages already staged. Zero without the spill
        tier (and for an enc-dec slot, whose chain does not spill)."""
        if not self.spill or self.cross or req.slot is None:
            return 0
        n_chain = pages_needed(int(self.lengths[req.slot]), self.page_size)
        staged = sum(1 for idx in self.remote_pool.staged_pages(req.req_id)
                     if idx < n_chain)
        return n_chain - staged

    def _try_admit(self, slot: int, req: Request, *,
                   require_shared: bool = False) -> bool:
        """One admission attempt, recall-first: a request whose preempted
        chain is spilled tries to recall it whole; everything else, and
        every fallback, goes through the prefix-aware plan. Under bypass
        (``require_shared``) a spilled candidate waits: its recall restores
        its full page need, so it cannot shrink past a blocked head."""
        if req.spill_len and not require_shared:
            got = self._try_admit_recall(slot, req)
            if got is not None:
                return got
            # chain lost (holder churn or over budget): re-prefill below
        elif req.spill_len:
            return False
        return self._try_admit_paged(slot, req,
                                     require_shared=require_shared)

    def _try_admit_recall(self, slot: int, req: Request) -> bool | None:
        """Admit a preempted request by recalling its spilled chain. True
        when the slot resumed from the recalled pages; False (no side
        effects) when the pool cannot hold the chain yet, the group kept;
        None when the chain is lost (a recall miss, or a chain longer than
        ``recall_budget``): the group is dropped, ``resume_fallbacks``
        counts it and the caller re-prefills."""
        P = self.page_size
        if pages_needed(req.spill_len, P) > self.recall_budget:
            self.remote_pool.release_slot(req.req_id)
            req.spill_len = 0
            self.stats["resume_fallbacks"] += 1
            return None
        need = pages_needed(
            min(self._total_len(req) + req.max_new_tokens, self.max_seq), P)
        if need > self.pool.available:
            return False
        payloads, wait_s = self.remote_pool.recall_slot(req.req_id)
        length, req.spill_len = req.spill_len, 0
        if payloads is None:
            self.stats["recall_misses"] += 1
            self.stats["resume_fallbacks"] += 1
            return None
        chain = self.pool.alloc(need)
        assert chain is not None  # guaranteed by the pre-check
        self._retire_cached(chain)
        self._install([chain[i] for i in payloads], list(payloads.values()))
        self.stats["pages_recalled"] += len(payloads)
        self.lifecycle.bind(slot, req, chain)
        self.lifecycle.resume_recalled(slot, req, length)
        self.stats["recall_resumes"] += 1
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       self.pool.outstanding)
        self._hold(slot, wait_s)
        return True

    def _hold(self, slot: int, wait_s: float) -> None:
        """Recall in flight: the lane sits out the decode steps the
        simulated transfer takes (see ``step``)."""
        hold = int(np.ceil(wait_s / self.decode_step_s)) if wait_s > 0 else 0
        if hold:
            self.slot_hold[slot] = hold
            self.stats["recall_hold_steps"] += hold

    def _try_admit_paged(self, slot: int, req: Request, *,
                         require_shared: bool = False) -> bool:
        """Plan + execute one paged admission: trie lookup, batched recall
        of spilled prefix (and encoder-region) pages, refcount bumps on the
        shared pages, private allocation for the rest. Returns False with
        no local side effects if the pool cannot satisfy it, or if
        ``require_shared`` and no resident cached page shrinks the request.

        The usable prefix is the resident pages plus spilled stubs within
        the per-request ``recall_budget``. An enc-dec request also plans
        its encoder region (``engine.py:1490-1680``): a full-chain trie hit
        on the frames' keys shares the cached region (the encoder is
        skipped), else fresh pages are allocated and ``prefill_cross``
        fills them; region stubs recall through the same budget. The plan
        re-plans after a recall miss (the stub's subtree dropped, those
        tokens or that region recomputed), and retries with resident pages
        only when the recalls will not fit; payloads recalled by an attempt
        that then fails are lent again (or evicted), so no cached page is
        lost silently."""
        tlen = self._total_len(req) + len(req.resume)
        P = self.page_size
        need = pages_needed(
            min(self._total_len(req) + req.max_new_tokens, self.max_seq), P)
        key_tokens = self._admit_keys(req)
        cross_keys = self._cross_keys(req) if self.cross else []
        n_cp = len(cross_keys) // P
        payloads: dict[int, bytes] = {}   # stub id -> recalled page bytes
        wait_s = 0.0
        allow_spill = self.spill
        while True:
            matched, shared, recalls, would_be = 0, [], [], 0
            cross_shared: list[int] = []
            cross_recalls: list[int] = []
            budget = self.recall_budget - len(payloads)
            if self.prefix_cache:
                chain = self.prefix_index.lookup(key_tokens)
                # truncated at the first stub the budget (or a disabled
                # spill tier) cannot cover
                usable: list[int] = []
                for sid in chain:
                    if sid < self.n_pages:
                        usable.append(sid)
                    elif (allow_spill and sid in self.spilled
                          and (sid in payloads or budget > 0)):
                        usable.append(sid)
                        if sid not in payloads:
                            budget -= 1
                    else:
                        break
                # cap at tlen-1: at least one suffix token must run through
                # the model to produce the first-token logits
                matched = min(len(usable) * P, tlen - 1)
                if not self.prefix_share:
                    # recurrent state is not page-addressable: the trie
                    # tracks would-be hits only, prefill is never skipped
                    would_be = min(len(chain) * P, tlen - 1)
                    matched = 0
                elif matched:
                    shared = usable[: pages_needed(matched, P)]
                    recalls = [s for s in shared if s >= self.n_pages]
                # the encoder region: reusable only on a full-chain hit (a
                # prefix of a non-causal encoder's output is not a function
                # of a prefix of its input)
                if self.prefix_share and n_cp:
                    cross_shared = self._plan_cross(
                        cross_keys, n_cp, payloads, budget, allow_spill)
                    cross_recalls = [s for s in cross_shared
                                     if s >= self.n_pages]
            resident = [s for s in shared if s < self.n_pages]
            cross_resident = [s for s in cross_shared if s < self.n_pages]
            if require_shared and not (resident or cross_resident):
                self._abort_recalls(payloads)
                return False
            # feasibility pre-check, so that failure has no local side
            # effects: revived pages leave the free list, and every recall
            # needs a fresh local page on top of the private ones (and of a
            # freshly computed region's)
            revive = sum(1 for p in resident + cross_resident
                         if self.pool.refcount(p) == 0)
            cross_new = n_cp if (self.cross and not cross_shared) else 0
            if ((need - matched // P) + len(recalls) + revive + cross_new
                    + len(cross_recalls) > self.pool.available):
                if recalls or cross_recalls:
                    # the recalls will not fit: retry with resident pages
                    # only (the stubs stay spilled for a later hit)
                    allow_spill = False
                    continue
                self._abort_recalls(payloads)
                return False
            missing = [s for s in recalls + cross_recalls
                       if s not in payloads]
            if missing:
                got, w = self.remote_pool.recall(
                    [self.spilled[s].lease_id for s in missing])
                wait_s += w
                missed = False
                for s in missing:
                    if s not in self.spilled:
                        continue  # dropped with a missed ancestor's subtree
                    blob = got.get(self.spilled[s].lease_id)
                    if blob is None:
                        # the holder left: drop the stub's subtree and
                        # recompute those tokens (or that region)
                        self._evict_node(s)
                        self.stats["recall_misses"] += 1
                        missed = True
                    else:
                        payloads[s] = blob
                if missed:
                    continue  # re-plan against the pruned trie
            break
        # payloads the final plan cannot use: lend them again
        unused = {s: payloads.pop(s) for s in list(payloads)
                  if s not in recalls and s not in cross_recalls}
        if unused:
            self._abort_recalls(unused)
        # ---- execute: guaranteed to succeed from here ----
        self.pool.share(resident)       # revive cached pages before alloc
        self.pool.share(cross_resident)
        all_recalls = recalls + cross_recalls
        if all_recalls:
            local = self.pool.alloc(len(all_recalls))
            assert local is not None  # guaranteed by the pre-check
            self._retire_cached(local)
            for region, sids in ((False, recalls), (True, cross_recalls)):
                pages = local[:len(sids)]
                local = local[len(sids):]
                self._install(pages, [payloads.pop(s) for s in sids],
                              cross=region)
                tgt = cross_shared if region else shared
                for sid, page in zip(sids, pages):
                    self.prefix_index.remap(sid, page)
                    del self.spilled[sid]
                    tgt[tgt.index(sid)] = page
            self.stats["pages_recalled"] += len(all_recalls)
        private = self.pool.alloc(need - matched // P)
        assert private is not None  # guaranteed by the pre-check
        self._retire_cached(private)
        cross_chain: list[int] | None = None
        cross_computed = False
        if self.cross:
            if cross_shared:
                cross_chain = cross_shared
                self.stats["cross_regions_shared"] += 1
                self.stats["cross_pages_shared"] += len(cross_shared)
            else:
                cross_chain = self.pool.alloc(n_cp)
                assert cross_chain is not None  # covered by the pre-check
                self._retire_cached(cross_chain)
                cross_computed = True
        if would_be:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += would_be
        self._prefill_paged(slot, req, shared, private, matched, key_tokens,
                            cross_keys, cross_chain, cross_computed)
        if self.slot_req[slot] == req.req_id:
            self._hold(slot, wait_s)
        return True

    def _plan_cross(self, cross_keys: list[int], n_cp: int,
                    payloads: dict[int, bytes], budget: int,
                    allow_spill: bool) -> list[int]:
        """The cached encoder region of ``cross_keys``: its whole chain of
        ``n_cp`` pages and stubs (the stubs recalled already or within
        ``budget`` recalls), else ``[]``."""
        cchain = self.prefix_index.lookup(cross_keys)
        if len(cchain) != n_cp:
            return []
        used = 0
        for sid in cchain:
            if sid < self.n_pages:
                continue
            if not (allow_spill and sid in self.spilled
                    and (sid in payloads or budget - used > 0)):
                return []
            if sid not in payloads:
                used += 1
        return list(cchain)

    def _install(self, pages: list[int], blobs: list[bytes], *,
                 cross: bool = False) -> None:
        """Recalled payloads of one region into ``pages``, batched (a family
        without a cross region: every paged leaf)."""
        if not pages:
            return
        keys = self._region_keys(cross=cross)
        if keys is None:
            install_page_payloads(self.cache, pages, blobs)
        else:
            install_page_payloads(self.cache, pages, blobs, keys)

    def _region_keys(self, *, cross: bool) -> frozenset[str] | None:
        """The cache leaves one region's page payload carries: a cross page
        only the ``cross_*`` pools, a prompt page the rest; None (every
        ``*_pages`` leaf) for a family without a cross region
        (``engine.py:1681-1689``)."""
        if not self.cross:
            return None
        names = {k for k in self.cache if k.endswith("_pages")}
        cross_names = {k for k in names if k.startswith("cross_")}
        return frozenset(cross_names if cross else names - cross_names)

    def _node_is_cross(self, page: int) -> bool:
        """A trie node belongs to the cross region iff its block's keys
        carry the cross namespace (``engine.py:1691-1695``)."""
        ent = self.prefix_index._nodes.get(page)
        return bool(ent and ent[1] and ent[1][0] >= _CROSS_NS)

    def _retire_cached(self, pages: list[int]) -> None:
        """Freshly reallocated pages lose their cached contents: lend the
        still-cached ones to a peer (the pool's LRU order makes them the
        coldest retained prefixes), leaving a trie stub, or evict them (and
        their subtrees) when no peer takes them. The payloads are read in
        one batched copy a region before any of these pages is written."""
        if not self.prefix_cache:
            return
        cached = [p for p in pages if p in self.prefix_index._nodes]
        blobs = {}
        if self.spill:
            for region in ((False, True) if self.cross else (False,)):
                some = [p for p in cached if self._node_is_cross(p) == region]
                blobs.update(zip(some, extract_page_payloads(
                    self.cache, some, self._region_keys(cross=region))))
        for p in cached:
            if p not in self.prefix_index._nodes:
                continue  # dropped with an evicted ancestor's subtree
            if self.spill:
                lease = self.remote_pool.lend(blobs[p])
                if lease is not None:
                    sid = self._spill_next
                    self._spill_next += 1
                    self.prefix_index.remap(p, sid)
                    self.spilled[sid] = SpilledPage(lease.lease_id,
                                                    lease.holder)
                    self.stats["pages_spilled"] += 1
                    continue
            self._evict_node(p)

    def _evict_node(self, node: int) -> None:
        """Drop a trie node (content lost) and its subtree, releasing the
        leases of spilled descendants: their pages are unreachable."""
        dropped = self.prefix_index.evict_pages([node])
        for d in dropped:
            sp = self.spilled.pop(d, None)
            if sp is not None and self.remote_pool is not None:
                self.remote_pool.release(sp.lease_id)
        self.stats["prefix_evictions"] += len(dropped)

    def _abort_recalls(self, payloads: dict[int, bytes]) -> None:
        """An admission attempt recalled payloads it cannot use: lend them
        again so the cached pages stay recallable (the recall released
        their leases), and evict the ones no peer takes."""
        for sid, blob in list(payloads.items()):
            if sid not in self.prefix_index._nodes:
                continue  # stub already evicted (a missed ancestor)
            lease = self.remote_pool.lend(blob) if self.remote_pool else None
            if lease is None:
                self._evict_node(sid)
            else:
                self.spilled[sid] = SpilledPage(lease.lease_id, lease.holder)
        payloads.clear()

    def _release_slot(self, slot: int) -> None:
        self.slot_req[slot] = None
        self.lengths[slot] = 0
        if self.paged:
            self.pool.free(self.slot_pages[slot])
            self.slot_pages[slot] = []
            self.page_table[slot, :] = 0  # scratch page: inert lane writes
            if self.cross:
                # drop this slot's reference on its encoder region; the
                # pages keep their content in the free list, so a later
                # request with the same frames revives them from the trie
                self.pool.free(self.slot_cross_pages[slot])
                self.slot_cross_pages[slot] = []
                self.cross_table[slot, :] = 0
                self.cross_len[slot] = 0
            self.slot_hold[slot] = 0
            self.prefilling.pop(slot, None)
            self._admit_ready = True      # freed capacity: rescan the queue

    def _prefill_paged(self, slot: int, req: Request, shared: list[int],
                       private: list[int], matched: int,
                       key_tokens: list[int],
                       cross_keys: list[int] | None = None,
                       cross_chain: list[int] | None = None,
                       cross_computed: bool = False) -> None:
        """Begin the chunked prefill of the uncached suffix: the slot's
        chain is the shared prefix pages plus its private pages. On a
        whole-prompt hit (``matched`` not page-aligned) the final, partly
        used shared page is copied on write into ``private[0]`` and only
        the last prompt token is recomputed, by one synthetic decode step.

        A VLM prompt spans its image rows, then its text: each chunk reads
        its share of the rows (``embeds`` and ``mm_len``). An enc-dec
        request first installs its encoder region (``cross_chain``),
        running ``prefill_cross`` only when the region was not served from
        the cache (``engine.py:1776-1860``).

        Under a continuous scheduler this only binds the slot and queues a
        ``_PrefillTask`` that ``step()`` pumps under the token budget; the
        synchronous mode drains it here."""
        ptoks = req.prompt + req.resume
        mm = self._mm_len(req)
        tlen = mm + len(ptoks)
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
        if self.cross:
            # the encoder region goes in before any decoder compute (the
            # chunks and the COW recompute both read it)
            self.slot_cross_pages[slot] = list(cross_chain)
            self.cross_table[slot, :] = 0
            self.cross_table[slot, : len(cross_chain)] = cross_chain
            self.cross_len[slot] = self._n_frames(req)
            if cross_computed:
                frames = np.asarray(req.extra["frames"])
                if frames.ndim == 2:
                    frames = frames[None]
                self.model.prefill_cross(self.params, self.cache, {
                    "frames": self._tensor(frames),
                    "cross_page_table": self._tensor(self.cross_table[slot]),
                })
                self.stats["cross_regions_computed"] += 1
                if self.prefix_share:
                    self.prefix_index.insert(cross_keys, cross_chain)
        self.slot_req[slot] = req.req_id
        req.slot = slot
        self.stats["prefill_tokens"] += tlen - matched
        self.stats["prefill_tokens_shared"] += matched
        if matched:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += matched
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       self.pool.outstanding)
        if self.prefix_cache and not self.prefix_share:
            # bookkeeping-only trie: phantom ids carry no page content, so
            # they register at begin (sharing families wait for the content,
            # _finish_prefill)
            self._register_prefix(key_tokens, chain)
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
            logits = self._decode_step(self._cross_batch(batch))
            if self._draft is not None:
                # the recomputed last prompt token needs its draft K/V too
                self._draft_decode(self.draft_params, self.cache, batch)
            first = int(logits[slot].argmax())
            self._finish_prefill(slot, req, key_tokens, chain, first, tlen)
            return
        self.prefilling[slot] = _PrefillTask(
            req=req, tlen=tlen, mm=mm, ptoks=ptoks, offset=matched,
            key_tokens=key_tokens,
            embeds=(np.asarray(req.extra["embeds"]).reshape(mm, -1)
                    if mm else None))
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
            mm = task.mm
            si = min(max(mm - off, 0), n)  # image rows in this chunk
            toks = np.zeros((1, C), np.int32)
            toks[0, si:n] = task.ptoks[off + si - mm:off + n - mm]
            batch = {"tokens": self._tensor(toks), "valid": n, "slot": slot,
                     "page_table": table_row}
            kw = {"offset": off}
            if self._mm:
                emb = np.zeros((1, C, task.embeds.shape[1]),
                               task.embeds.dtype)
                emb[0, :si] = task.embeds[off:off + si]
                batch["embeds"] = self._tensor(emb)
                kw["mm_len"] = mm
            task.logits = self.model.prefill_chunk(
                self.params, self._target(), self._cross_batch(batch, slot),
                **kw)
            if self._draft is not None:
                # the draft rides every chunk: its prompt K/V lands in the
                # same pages, so shared and COW'd prefixes are complete
                self._draft_prefill(self.draft_params, self.cache, batch,
                                    offset=off)
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
        key per cache position) so later prompts can share them — or, for
        recurrent-state families, so the trie counts would-be hits through
        phantom ids (``>= n_pages``)."""
        n = len(tokens) // self.page_size
        if n == 0:
            return
        if self.prefix_share:
            self.prefix_index.insert(tokens, chain[:n])
            return
        # bookkeeping-only trie: bound its growth, it holds no pages
        if len(self.prefix_index) > 8 * self.n_pages:
            return
        phantoms = list(range(self._phantom_next, self._phantom_next + n))
        self._phantom_next += n
        self.prefix_index.insert(tokens, phantoms)

    # ----------------------------------------------------------- dense admit
    def _prefill_into(self, slot: int, req: Request) -> None:
        """Dense admission (``engine.py:2033-2062``): the prompt,
        right-aligned in its bucket and left-padded with token 0, runs
        through one ``prefill`` with the request's modality inputs (a VLM's
        image rows ahead of the bucket, an enc-dec's frames); the
        zero-padded batch-1 cache is written over the whole slot row. The
        pad rows are attended (bucketed serving; exact comparisons use
        prompts of bucket length). The first token is the argmax of the
        last position, and the admitted length is the image rows plus the
        bucket."""
        plen = len(req.prompt)
        mm = self._mm_len(req)
        assert plen >= 1 and mm + plen < self.max_seq, (plen, mm)
        bucket = min(_bucket(plen), self.max_seq - mm)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, bucket - plen:] = req.prompt
        batch = {"tokens": self._tensor(toks)}
        for k, v in req.extra.items():
            batch[k] = self._tensor(v)
        logits, pcache = self.model.prefill(self.params, batch)
        pcache = expand_prefill_cache(
            pcache, {k: v[:, :1] for k, v in self.cache.items()})
        scatter_slot(self.cache, pcache, slot)
        # (B, V) logits, or (B, S, V) where a family returns every position
        row = logits[0, -1] if logits.ndim == 3 else logits[0]
        self.lifecycle.activate(slot, req, int(row.argmax()), mm + bucket)

    # ---------------------------------------------------------------- mesh
    def lay_out(self, mesh) -> None:
        """Run on ``mesh`` (``cell.py:470-476``): the paged pool placed by
        ``paged_cache_shardings``, each leaf a DTensor whose local block
        this rank cuts from the whole pool it holds (``place``), and the
        paged entry points lifted onto the mesh (``on_mesh``). The weights
        are the caller's to lay out."""
        if not self.paged or self._draft is not None:
            raise ValueError("only the paged engine without a draft lays "
                             "its pool out on a mesh")
        if self.mesh is not None:
            raise ValueError("the pool is laid out already")
        self.mesh = mesh
        self._place_pool()
        self.model = dataclasses.replace(
            self.model,
            prefill_chunk=on_mesh(self.model.prefill_chunk, mesh),
            decode_paged=on_mesh(self.model.decode_paged, mesh))

    def _place_pool(self) -> None:
        shardings = paged_cache_shardings(self.model, self.n_slots,
                                          self.n_pages, self.page_size,
                                          self.mesh)
        self.cache = {k: place(v, self.mesh, shardings[k].placements)
                      for k, v in self.cache.items()}

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> bytes:
        """The engine's whole state as one blob, in the reference's format
        (``engine.py:2064-2149``): a ``<u4`` meta length, the meta JSON
        (requests, queue, slots, the pool and the prefix trie, stats), then
        the serialized tensors (cache, lengths, last tokens, steps, page
        table). In-flight chunked prefills are drained first: the blob
        cannot carry their device-side logits, and the tokens do not
        change."""
        if self.paged and self.prefilling:
            self._pump_prefill(None)
        state = {
            # a laid-out pool whole: the bytes do not depend on the layout
            "cache": {k: v.full_tensor() if isinstance(v, DTensor) else v
                      for k, v in self.cache.items()},
            "lengths": self.lengths,
            "last_token": self.last_token,
            "steps": np.asarray(self.steps, np.int64),
        }
        if self.paged:
            state["page_table"] = self.page_table
            if self.cross:
                state["cross_table"] = self.cross_table
                state["cross_len"] = self.cross_len
        blob = serialize_tree(state)
        meta = {
            "paged": self.paged,
            "slot_req": self.slot_req,
            "queue": [r.req_id for r in self.queue],
            "requests": {
                str(r.req_id): {
                    "prompt": r.prompt,
                    "max_new_tokens": r.max_new_tokens,
                    "eos_id": r.eos_id,
                    "generated": r.generated,
                    "slot": r.slot,
                    "done": r.done,
                    "extra": _encode_extra(r.extra),
                    "priority": r.priority,
                    "deadline_ms": r.deadline_ms,
                    "arrival_step": r.arrival_step,
                    "resume": r.resume,
                    "spill_len": r.spill_len,
                    "temperature": r.temperature,
                    "seed": r.seed,
                }
                for r in self.requests.values()
            },
        }
        if self.paged:
            pool_free, pool_ref, pool_touch = self.pool.serialize()
            meta["page_size"] = self.page_size
            meta["n_pages"] = self.n_pages
            meta["free_pages"] = pool_free
            meta["slot_pages"] = [[int(p) for p in ps]
                                  for ps in self.slot_pages]
            if self.cross:
                meta["slot_cross_pages"] = [[int(p) for p in ps]
                                            for ps in self.slot_cross_pages]
            # refcounts and the trie must survive a restore on a substitute
            # host, or shared pages would double-free
            meta["page_ref"] = {str(p): r for p, r in pool_ref.items()}
            meta["page_touch"] = {str(p): g for p, g in pool_touch.items()}
            meta["prefix_trie"] = (self.prefix_index.serialize()
                                   if self.prefix_cache else [])
            # spill tier: only the stubs and lease ids travel, never the
            # lent payloads; a restore revalidates each lease
            meta["spilled"] = {str(sid): [sp.lease_id, sp.peer]
                               for sid, sp in self.spilled.items()}
            if self.remote_pool is not None:
                meta["slot_spills"] = {}
                for r in self.requests.values():
                    leases = self.remote_pool.slot_leases(r.req_id)
                    if leases:
                        meta["slot_spills"][str(r.req_id)] = {
                            str(i): [lid, peer]
                            for i, (lid, peer) in leases.items()}
            meta["slot_hold"] = [int(h) for h in self.slot_hold]
        meta["stats"] = {k: int(v) for k, v in self.stats.items()}
        mb = json.dumps(meta).encode()
        return len(mb).to_bytes(4, "little") + mb + blob

    def restore(self, blob: bytes) -> None:
        """Resume from a :meth:`snapshot` blob of either package
        (``engine.py:2151-2287``). The engine must be built as the
        snapshotted one was (mode, slots, ``max_seq``, page size and pool
        size). Spilled trie stubs are revalidated against the remote pool's
        live cloudlet membership: a stub whose lease is gone (or any stub,
        on an engine without a remote pool) is evicted with its subtree, so
        its prefix is recomputed, never served stale. Slot-spill groups are
        re-adopted whole (``adopt_slot``); a group that cannot be falls back
        to re-prefill (``resume_fallbacks``)."""
        mlen = int.from_bytes(blob[:4], "little")
        meta = json.loads(blob[4:4 + mlen].decode())
        assert meta.get("paged", False) == self.paged, (
            "snapshot/engine paged-mode mismatch")
        like = {
            # a laid-out pool comes back whole on the host, then lay_out
            # places it again
            "cache": ({k: torch.empty((), dtype=v.dtype).expand(v.shape)
                       for k, v in self.cache.items()}
                      if self.mesh is not None else self.cache),
            "lengths": self.lengths,
            "last_token": self.last_token,
            "steps": np.asarray(self.steps, np.int64),
        }
        if self.paged:
            assert meta["page_size"] == self.page_size
            assert meta["n_pages"] == self.n_pages
            like["page_table"] = self.page_table
            if self.cross:
                like["cross_table"] = self.cross_table
                like["cross_len"] = self.cross_len
        state = deserialize_tree(blob[4 + mlen:], like)
        self.cache = state["cache"]
        if self.mesh is not None:
            self._place_pool()
        self.lengths = state["lengths"].copy()
        self.last_token = state["last_token"].copy()
        self.steps = int(state["steps"])
        if self.paged:
            self.page_table = state["page_table"].copy()
            if self.cross:
                self.cross_table = state["cross_table"].copy()
                self.cross_len = state["cross_len"].copy()
                self.slot_cross_pages = [
                    [int(p) for p in ps]
                    for ps in meta.get("slot_cross_pages",
                                       [[] for _ in range(self.n_slots)])]
            self.pool.restore(meta["free_pages"], meta.get("page_ref"),
                              meta.get("page_touch"))
            self.slot_pages = [[int(p) for p in ps]
                               for ps in meta["slot_pages"]]
            snap_spilled = {
                int(sid): SpilledPage(int(ent[0]), ent[1])
                for sid, ent in meta.get("spilled", {}).items()}
            self.slot_hold = np.asarray(
                meta.get("slot_hold", [0] * self.n_slots), np.int32).copy()
            if self.prefix_cache:
                self.prefix_index = PrefixIndex.load(
                    self.page_size, meta.get("prefix_trie", []),
                    # sharing engines install trie ids into page tables, so
                    # they must be pool pages or known spill stubs;
                    # bookkeeping-only engines hold phantom ids >= n_pages
                    max_page=self.n_pages if self.prefix_share else None,
                    extra_ids=set(snap_spilled))
                phantoms = [p for p in self.prefix_index._nodes
                            if p >= self.n_pages]
                self._phantom_next = max(phantoms,
                                         default=self.n_pages - 1) + 1
                self._spill_next = max(max(snap_spilled, default=0) + 1,
                                       self.n_pages)
                # revalidate leases. Every stub is loaded before any
                # eviction, so that dropping an invalid ancestor releases
                # the still-valid leases of its spilled descendants
                # (_evict_node) instead of leaking them
                self.spilled = {sid: sp for sid, sp in snap_spilled.items()
                                if sid in self.prefix_index._nodes}
                if self.remote_pool is not None:
                    for sid, sp in snap_spilled.items():
                        if sid not in self.spilled:  # orphaned stub entry
                            self.remote_pool.release(sp.lease_id)
                for sid in list(self.spilled):
                    sp = self.spilled.get(sid)
                    if sp is None:
                        continue  # dropped with an evicted ancestor
                    if (self.remote_pool is None
                            or not self.remote_pool.lease_valid(sp.lease_id)):
                        if self.remote_pool is not None:
                            self.remote_pool.release(sp.lease_id)
                        self._evict_node(sid)
            self.prefilling = {}      # snapshots drain in-flight prefills
            self._admit_ready = True  # restored queue must be rescanned
        self.stats = {**self.stats,
                      **{k: int(v) for k, v in meta.get("stats", {}).items()}}
        self.requests = {}
        for rid, kv in meta["requests"].items():
            req = Request(int(rid), kv["prompt"], kv["max_new_tokens"],
                          kv["eos_id"],
                          extra=_decode_extra(kv.get("extra", {})))
            req.generated = kv["generated"]
            req.slot = kv["slot"]
            req.done = kv["done"]
            req.priority = int(kv.get("priority", 0))
            req.deadline_ms = kv.get("deadline_ms")
            req.arrival_step = int(kv.get("arrival_step", 0))
            req.resume = list(kv.get("resume", []))
            req.spill_len = int(kv.get("spill_len", 0))
            req.temperature = float(kv.get("temperature", 0.0))
            req.seed = int(kv.get("seed", 0))
            if req.deadline_ms is not None:
                self._has_deadlines = True
            self.requests[req.req_id] = req
        self.slot_req = meta["slot_req"]
        self.queue = [self.requests[rid] for rid in meta["queue"]]
        self._req_counter = max(self.requests) + 1 if self.requests else 0
        if self.paged:
            # re-adopt slot-spill groups: every lease must still be valid
            # or the whole chain falls back to re-prefill, never to a
            # partial recall
            for rid_s, leases in meta.get("slot_spills", {}).items():
                rid = int(rid_s)
                mapping = {int(i): int(ent[0]) for i, ent in leases.items()}
                req = self.requests.get(rid)
                ok = (self.remote_pool is not None
                      and self.remote_pool.adopt_slot(rid, mapping))
                if req is None:
                    if ok:  # finished or cancelled while the snapshot sat
                        self.remote_pool.release_slot(rid)
                    continue
                if not ok and req.spill_len:
                    req.spill_len = 0
                    self.stats["resume_fallbacks"] += 1
            if self.remote_pool is None:
                for req in self.requests.values():
                    req.spill_len = 0
