"""Serving caches: the dense per-slot cache and its slot scatter, the
host-side state of the paged KV cache — the page allocator and the prefix
trie — the pool allocation, and the multi-host spill tier.

Ported from ``repro/serving/kvcache.py`` (``init_cache``, ``scatter_slot``,
``expand_prefill_cache``: lines 87-134; ``pages_needed``, ``PagePool``,
``PrefixIndex``: lines 137-487; the spill tier: lines 490-808;
``init_paged_cache``: line 809; ``cache_shardings`` and
``paged_cache_shardings``: lines 92-96 and 814-819). The allocator, the trie and the
remote pool are plain Python, copied as they are; the caches themselves
are torch tensors made by the model's ``init_cache`` and
``init_paged_cache``.

**Multi-host page spill** (:class:`RemotePagePool`): when reallocation
would destroy retained prefix-cache pages, the engine serializes them and
*lends* them to a peer host of its cloudlet (most reliable first) instead
of evicting them; a :class:`SpilledPage` stub keeps their place in the
trie, and a later prefix hit *recalls* them. A preempted slot's whole
chain can travel as one group (``spill_slot``/``recall_slot``), and full
decode pages can be staged ahead (``stage_page``, write-behind). A recall
returns the exact lent bytes or misses (the holder left the cloudlet), and
a miss is recomputed: borrowed memory can delay tokens, never change them.

A page's payload is :func:`extract_page_payload`'s blob, in the
serializer's format: the page's slice ``(layers, page_size, K, dh)`` of
every ``*_pages`` leaf, bf16 as ``"bfloat16"`` with its raw bits — byte
for byte the reference's blob for the same page contents, so lent pages
and snapshot stubs cross packages. On the card a page never leaves the
cache's device except as those bytes: :func:`extract_page_payloads` reads
many pages with one ``index_select`` per leaf and one device-to-host copy,
and :func:`install_page_payloads` writes them back with one host-to-device
copy and one ``index_copy_`` per leaf. Both copies are synchronous, so a
payload is complete before it is lent, and a page's bytes are read before
the caller's next write to it is queued.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.checkpoint.serializer import read_leaves, serialize_tree
from repro_torch.core.cloudlet import CloudletRegistry, PageLease
from repro_torch.core.reliability import ReliabilityRegistry
from repro_torch.models.model_api import ModelFns, Tree
from repro_torch.parallel.partition import (
    tree_partition_specs,
    tree_shardings,
)


def init_cache(model: ModelFns, n_slots: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda") -> Tree:
    """The model's zeroed dense cache: every leaf ``(layers, n_slots,
    ...)``, attention K/V ``max_seq`` long."""
    return model.init_cache(n_slots, max_seq, dtype, device)


def scatter_slot(cache: Tree, slot_cache: Tree, slot: int) -> None:
    """Write a batch-1 ``slot_cache`` into slot ``slot`` of ``cache``, in
    place. Leaves are ``(layers, batch, ...)``; a ``slot_cache`` leaf may be
    shorter along trailing dims (prompt-length K/V against ``max_seq``) and
    lands at offset 0 of each, as in the reference."""
    for name, c in cache.items():
        s = slot_cache[name]
        if c.ndim != s.ndim:
            raise ValueError(f"{name}: {tuple(c.shape)} vs {tuple(s.shape)}")
        c[(slice(None), slot) + tuple(slice(0, n) for n in s.shape[2:])] = \
            s[:, 0].to(c.dtype)


def expand_prefill_cache(prefill_cache: Tree, like: Tree) -> Tree:
    """Zero-pad a prefill cache's trailing dims up to the ``like`` leaves'
    shapes (batch dim already equal), so that scattering it rewrites the
    whole slot row: positions past the prompt's bucket become zeros, not
    what the slot held before. An enc-dec prefill's cross K/V pads to
    ``ENC_SEQ`` this way, and its int32 ``enc_len`` keeps its dtype."""
    out = {}
    for name, p in prefill_cache.items():
        want = like[name].shape
        if p.ndim != len(want) or any(a > b for a, b in zip(p.shape, want)):
            raise ValueError(f"{name}: {tuple(p.shape)} does not fit "
                             f"{tuple(want)}")
        pad = [x for a, b in zip(reversed(p.shape), reversed(want))
               for x in (0, b - a)]
        out[name] = torch.nn.functional.pad(p, pad).to(like[name].dtype)
    return out


SCRATCH_PAGE = 0  # physical page 0 is never allocated


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages required to hold ``n_tokens`` cache entries."""
    return max(1, -(-n_tokens // page_size))


class PagePool:
    """Host-side refcounting free-list allocator over ``n_pages`` pages.

    Page 0 (:data:`SCRATCH_PAGE`) is reserved: cleared page-table rows
    point at it so inactive decode lanes scatter into a sacrificial page
    instead of a page another request now owns.

    **Prefix sharing** extends the original exclusive-ownership allocator
    with per-page refcounts: :meth:`share` bumps the count of pages that a
    second slot installs into its page table (shared pages are read-only —
    a slot that must write into one copies it first, see the engine's COW
    path). :meth:`free` decrements and only returns a page to the free
    list when its count reaches zero, so a page is never recycled while
    any slot still reads it. A freed page keeps its contents: the prefix
    index may still map a token prefix to it, and :meth:`share` *revives*
    such a cached page straight out of the free list. Reallocation
    (:meth:`alloc`) is what finally invalidates cached contents — the
    caller must evict those pages from its prefix index.

    **LRU generations** (the spill tier's eviction order): every page
    carries a *last-touch generation*, bumped whenever the page is
    allocated, shared/revived, freed, or explicitly :meth:`touch`-ed on a
    prefix-cache read. :meth:`alloc` hands out the *coldest* free pages
    first (never-touched, then oldest generation), so the pages a
    reallocation retires — the candidates the engine spills to a neighbor
    host — are exactly the least-recently-used cached prefixes.

    Invariants (tested): live allocations are disjoint,
    ``available + outstanding == n_pages - 1``, refcounts are positive for
    exactly the outstanding pages, and a page is never handed out twice
    without dropping to refcount zero in between.
    """

    def __init__(self, n_pages: int):
        assert n_pages >= 2, "need at least one allocatable page + scratch"
        self.n_pages = n_pages
        self._free = list(range(1, n_pages))
        self._ref: dict[int, int] = {}
        # last-touch generation per page (absent = never touched = coldest)
        self._gen = 0
        self._touch: dict[int, int] = {}

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def outstanding(self) -> int:
        return len(self._ref)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def last_touch(self, page: int) -> int:
        return self._touch.get(page, 0)

    def touch(self, pages: list[int]) -> None:
        """Mark ``pages`` as just-used (a prefix-cache read of retained
        pages): they move to the warm end of the eviction order."""
        for p in pages:
            self._gen += 1
            self._touch[p] = self._gen

    def _evict_order(self) -> list[int]:
        """Free pages, coldest first (LRU by last-touch generation)."""
        return sorted(self._free, key=lambda p: (self._touch.get(p, 0), p))

    def alloc(self, n: int) -> list[int] | None:
        """Pop the ``n`` coldest free pages, or None (and no side effects)
        if exhausted.

        Handed-out pages lose any cached contents: callers holding a
        prefix index must evict (or spill) the returned ids.
        """
        if n > len(self._free):
            return None
        pages = self._evict_order()[:n]
        taken = set(pages)
        self._free = [p for p in self._free if p not in taken]
        for p in pages:
            self._ref[p] = 1
        self.touch(pages)
        return pages

    def share(self, pages: list[int]) -> None:
        """Bump the refcount of ``pages`` (install into another slot).

        Pages at refcount zero are *revived*: pulled back out of the free
        list with their contents intact (a prefix-cache hit on a page
        whose last owner already completed).
        """
        revive = set()
        for p in pages:
            assert 0 < p < self.n_pages, f"share of invalid page {p}"
            r = self._ref.get(p, 0)
            if r == 0:
                revive.add(p)
            self._ref[p] = r + 1
        if revive:
            assert revive <= set(self._free), "revive of a live page"
            self._free = [p for p in self._free if p not in revive]
        self.touch(pages)

    def free(self, pages: list[int]) -> None:
        """Drop one reference per page; recycle at refcount zero."""
        for p in pages:
            r = self._ref.get(p, 0)
            assert r > 0, f"double free of page {p}"
            if r == 1:
                del self._ref[p]
                self._free.append(p)
            else:
                self._ref[p] = r - 1
        self.touch(pages)

    def serialize(self) -> tuple[list[int], dict[int, int], dict[int, int]]:
        """Snapshot counterpart of :meth:`restore`: the free list (in
        eviction order), the live refcounts, and the last-touch
        generations."""
        return self._evict_order(), dict(self._ref), dict(self._touch)

    def restore(self, free: list[int],
                ref: dict[int, int] | None = None,
                touch: dict[int, int] | None = None) -> None:
        """Reset the allocator from a snapshot's free list (+ refcounts).

        The incoming lists are validated rather than trusted: a corrupt
        snapshot (duplicate or out-of-range page ids, the scratch page in
        the free list, refcounted pages overlapping the free list, or
        pages missing from both) raises ``ValueError`` instead of
        silently seeding an allocator that would later double-hand-out
        pages.
        """
        free = [int(p) for p in free]
        if len(set(free)) != len(free):
            raise ValueError("corrupt snapshot: duplicate free page ids")
        bad = [p for p in free if not 0 < p < self.n_pages]
        if bad or SCRATCH_PAGE in free:
            raise ValueError(
                f"corrupt snapshot: free page ids out of range {bad or [0]}"
            )
        if ref is None:
            # legacy snapshot: every non-free page is exclusively owned
            ref = {p: 1 for p in range(1, self.n_pages) if p not in set(free)}
        else:
            ref = {int(p): int(r) for p, r in ref.items()}
            if any(r < 1 for r in ref.values()):
                raise ValueError("corrupt snapshot: non-positive refcount")
            bad = [p for p in ref if not 0 < p < self.n_pages]
            if bad:
                raise ValueError(
                    f"corrupt snapshot: refcounted page ids out of range {bad}"
                )
        if set(free) & set(ref):
            raise ValueError(
                "corrupt snapshot: pages both free and refcounted"
            )
        if set(free) | set(ref) != set(range(1, self.n_pages)):
            raise ValueError(
                "corrupt snapshot: pages missing from free list + refcounts"
            )
        self._free = free
        self._ref = ref
        # generations are an eviction-order hint: filter rather than
        # reject, and re-seed from the free-list order when absent so a
        # legacy snapshot keeps its (approximate) LRU order
        if touch is None:
            self._touch = {p: i + 1 for i, p in enumerate(free)}
        else:
            self._touch = {
                int(p): int(g) for p, g in touch.items()
                if 0 < int(p) < self.n_pages
            }
        self._gen = max(self._touch.values(), default=0)


class PrefixIndex:
    """Trie over page-sized token blocks → resident page ids.

    One node per *full* page of prompt tokens: the node for block ``i`` of
    a prompt exists iff tokens ``[i*P, (i+1)*P)`` of some admitted request
    have been prefilled into a page that is still resident (refcounted by
    a slot, or sitting content-intact in the pool's free list). Nodes are
    keyed by ``(parent node, block tokens)``, so lookups walk the trie at
    page granularity and return the longest chain of reusable pages.

    Families whose per-token cache is not page-addressable (SSM/hybrid
    recurrent state) insert *phantom* ids (``>= n_pages``, handed out by
    the engine) — the trie then only tracks would-be hits for stats; no
    pages are installed and prefill is not skipped.

    "Tokens" are trie keys, not necessarily vocabulary ids: the engine
    keys vlm image rows and enc-dec encoder frames by content-derived
    pseudo-tokens (and salts enc-dec prompt tokens with the frames
    digest), so multimodal pages share through the same trie walk.

    The index holds **no pool references**: a cached page whose owners all
    completed lives in the free list until reallocation, at which point
    the engine calls :meth:`evict_pages` and the node (plus its now
    unreachable subtree) is dropped.
    """

    ROOT = None

    def __init__(self, page_size: int):
        self.page_size = page_size
        # parent node id (None = root) -> {block token tuple: child id}
        self._children: dict[int | None, dict[tuple[int, ...], int]] = {}
        # node id -> (parent node id, block token tuple)
        self._nodes: dict[int, tuple[int | None, tuple[int, ...]]] = {}

    def __len__(self) -> int:
        return len(self._nodes)

    def lookup(self, tokens: list[int]) -> list[int]:
        """Longest cached page-aligned prefix of ``tokens``: the matched
        page-id chain, outermost page first."""
        P = self.page_size
        chain: list[int] = []
        parent: int | None = self.ROOT
        for i in range(len(tokens) // P):
            page = self._children.get(parent, {}).get(
                tuple(tokens[i * P:(i + 1) * P])
            )
            if page is None:
                break
            chain.append(page)
            parent = page
        return chain

    def insert(self, tokens: list[int], chain: list[int]) -> None:
        """Register the full prompt pages of an admitted request.

        ``chain[i]`` is the page holding block ``i``. Existing entries
        win — the first page prefilled for a block stays the canonical
        copy, so COW duplicates never displace the shared original.
        """
        P = self.page_size
        parent: int | None = self.ROOT
        for i in range(min(len(tokens) // P, len(chain))):
            block = tuple(tokens[i * P:(i + 1) * P])
            kids = self._children.setdefault(parent, {})
            page = kids.get(block)
            if page is None:
                page = chain[i]
                kids[block] = page
                self._nodes[page] = (parent, block)
            parent = page

    def remap(self, old: int, new: int) -> None:
        """Rename node ``old`` to ``new``, keeping its place in the trie
        (parent edge and entire subtree intact).

        This is how a page **spills** without losing its cached prefix:
        the physical page id is swapped for a spill-stub id (and swapped
        back on recall), while descendants — resident or spilled — stay
        reachable through it.
        """
        assert new not in self._nodes, (old, new)
        parent, block = self._nodes.pop(old)
        self._nodes[new] = (parent, block)
        self._children[parent][block] = new
        kids = self._children.pop(old, None)
        if kids is not None:
            self._children[new] = kids
            for blk, child in kids.items():
                self._nodes[child] = (new, blk)

    def evict_pages(self, pages: list[int]) -> list[int]:
        """Drop nodes whose pages were reallocated (plus their subtrees —
        children are unreachable once the parent's content is gone).
        Returns every node id actually dropped, so the caller can release
        spill leases belonging to dropped descendants."""
        dropped: list[int] = []
        for p in pages:
            self._drop(p, dropped)
        return dropped

    def _drop(self, page: int, dropped: list[int] | None = None) -> None:
        ent = self._nodes.pop(page, None)
        if ent is None:
            return
        if dropped is not None:
            dropped.append(page)
        parent, block = ent
        kids = self._children.get(parent)
        if kids is not None and kids.get(block) == page:
            del kids[block]
            if not kids:
                self._children.pop(parent, None)
        for child in list(self._children.get(page, {}).values()):
            self._drop(child, dropped)
        self._children.pop(page, None)

    # ------------------------------------------------------------ snapshot
    def serialize(self) -> list[list]:
        """JSON-friendly edge list, parents before children."""
        out: list[list] = []
        stack: list[int | None] = [self.ROOT]
        while stack:
            parent = stack.pop()
            for block, page in self._children.get(parent, {}).items():
                out.append([page, -2 if parent is self.ROOT else parent,
                            list(block)])
                stack.append(page)
        return out

    @classmethod
    def load(cls, page_size: int, entries: list[list], *,
             max_page: int | None = None,
             extra_ids: frozenset[int] | set[int] = frozenset(),
             ) -> "PrefixIndex":
        """Rebuild from :meth:`serialize` output, validating it: node ids
        must be positive (never the scratch page) and — when ``max_page``
        is given (sharing engines, where ids are installed into page
        tables) — below the pool size or in ``extra_ids`` (spill stubs,
        which are resolved to real pages by recall before any page-table
        install); blocks must span exactly one page. A corrupt snapshot
        raises ``ValueError`` instead of poisoning the pool on the next
        prefix hit."""
        idx = cls(page_size)
        for page, parent, block in entries:
            parent = cls.ROOT if parent == -2 else int(parent)
            page = int(page)
            if page < 1 or (max_page is not None and page >= max_page
                            and page not in extra_ids):
                raise ValueError(
                    f"corrupt snapshot: prefix-trie page id {page} out of "
                    f"range"
                )
            if page in idx._nodes:
                # a duplicate would leave a dangling edge after eviction,
                # able to serve another request's live page as "cached"
                raise ValueError(
                    f"corrupt snapshot: prefix-trie page id {page} appears "
                    f"twice"
                )
            if len(block) != page_size:
                raise ValueError(
                    f"corrupt snapshot: prefix-trie block of {len(block)} "
                    f"tokens (page size {page_size})"
                )
            block = tuple(int(t) for t in block)
            idx._children.setdefault(parent, {})[block] = page
            idx._nodes[page] = (parent, block)
        return idx


# ---------------------------------------------------------------------------
# Multi-host page spill (the ad hoc cloud's memory-harvesting tier)
# ---------------------------------------------------------------------------

# simulated transfer costs (seconds). Lending is off the critical path
# (write-behind); recall is paid before the suffix prefill of a request
# that hits a spilled prefix, batched as one round trip per peer.
LEND_PAGE_S = 2e-4
RECALL_RTT_S = 1e-3
RECALL_PAGE_S = 5e-4


@dataclass
class SpilledPage:
    """Trie stub standing in for a page lent to a neighbor host.

    The stub's node id (>= ``n_pages``, never installable in a page
    table) stays in the :class:`PrefixIndex` where the physical page used
    to be; ``lease_id`` names the loan in the cloudlet's
    :class:`~repro_torch.core.cloudlet.LeaseTable` and ``peer`` the host
    physically holding the serialized page.
    """

    lease_id: int
    peer: str


def _paged_leaves(cache: Tree, keys) -> dict[str, torch.Tensor]:
    """The ``*_pages`` leaves, sorted by name (the blob's leaf order),
    restricted to ``keys`` where given."""
    return {k: cache[k] for k in sorted(cache)
            if k.endswith("_pages") and (keys is None or k in keys)}


def extract_page_payload(cache: Tree, page: int,
                         keys: frozenset[str] | set[str] | None = None,
                         ) -> bytes:
    """Serialize physical page ``page``'s slice of the paged cache leaves
    (``*_pages``, laid out ``(layers, n_pages, page_size, ...)``) into a
    self-describing blob — the unit a host lends to a peer.

    ``keys`` restricts the payload to one region's leaves: an enc-dec page
    serves either the decoder's self pools or the cross (encoder-output)
    pools, never both, so it ships that region's leaves only
    (``repro/serving/kvcache.py:508-523``)."""
    return serialize_tree({k: v[:, page]
                           for k, v in _paged_leaves(cache, keys).items()})


def _page_views(leaves: dict[str, torch.Tensor], buf: torch.Tensor
                ) -> dict[str, torch.Tensor]:
    """``buf``'s rows (one page each, the leaves' bytes back to back) as
    per-leaf tensors ``(n, layers, page_size, ...)``."""
    out, off = {}, 0
    for k, v in leaves.items():
        size = v[:, 0].numel() * v.element_size()
        out[k] = buf[:, off:off + size].view(v.dtype).view(
            (buf.shape[0], v.shape[0]) + tuple(v.shape[2:]))
        off += size
    return out


def _gather_pages(leaves: dict[str, torch.Tensor], pages: list[int]
                  ) -> torch.Tensor:
    """Pages ``pages`` of ``leaves``, page-major, in one buffer on the
    leaves' device: per leaf one ``index_select`` along the page dim."""
    some = next(iter(leaves.values()))
    idx = torch.tensor(pages, dtype=torch.long, device=some.device)
    row = sum(v[:, 0].numel() * v.element_size() for v in leaves.values())
    staging = torch.empty((len(pages), row), dtype=torch.uint8,
                          device=some.device)
    for k, dst in _page_views(leaves, staging).items():
        dst.copy_(leaves[k].index_select(1, idx).transpose(0, 1))
    return staging


def _copy_to_host(staging: torch.Tensor) -> torch.Tensor:
    """A device buffer copied synchronously into page-locked host memory
    (PyTorch's host allocator keeps the block for the next call, where a
    fresh pageable buffer would be faulted in page by page); a host
    buffer as it is."""
    if not staging.is_cuda:
        return staging
    host = torch.empty(staging.shape, dtype=torch.uint8, pin_memory=True)
    return host.copy_(staging)


def extract_page_payloads(cache: Tree, pages: list[int],
                          keys: frozenset[str] | set[str] | None = None,
                          ) -> list[bytes]:
    """:func:`extract_page_payload` of each page of ``pages`` (all of one
    region, ``keys``), byte for byte, in one pass: the pages gathered
    page-major on the cache's device, one device-to-host copy, then each
    page's blob serialized from host views that are already contiguous."""
    if not pages:
        return []
    leaves = _paged_leaves(cache, keys)
    host = _page_views(leaves, _copy_to_host(_gather_pages(leaves, pages)))
    return [serialize_tree({k: t[j] for k, t in host.items()})
            for j in range(len(pages))]


def page_payload_like(cache: Tree,
                      keys: frozenset[str] | set[str] | None = None,
                      ) -> dict[str, torch.Tensor]:
    """Zero templates matching :func:`extract_page_payload` output (host
    tensors of each leaf's page shape and dtype) — the ``like`` tree a
    recall deserializes against."""
    return {k: torch.zeros((), dtype=v.dtype).expand(
                (v.shape[0],) + tuple(v.shape[2:]))
            for k, v in _paged_leaves(cache, keys).items()}


def _stack_payloads(leaves: dict[str, torch.Tensor], blobs: list[bytes],
                    pin: bool) -> dict[str, torch.Tensor]:
    """Per leaf, every payload's slice stacked into one host tensor
    ``(n, layers, page_size, ...)`` (page-locked if ``pin``). A payload
    must carry every leaf, in the cache's dtype and page shape."""
    parsed = [read_leaves(b) for b in blobs]
    out = {}
    for k, v in leaves.items():
        shape = (v.shape[0],) + tuple(v.shape[2:])
        bf16 = v.dtype == torch.bfloat16
        name = "bfloat16" if bf16 else \
            str(torch.empty(0, dtype=v.dtype).numpy().dtype)
        src = torch.empty((len(blobs),) + shape, dtype=v.dtype,
                          pin_memory=pin)
        buf = (src.view(torch.int16) if bf16 else src).numpy()
        for j, leaves_j in enumerate(parsed):
            got, arr = leaves_j[k]
            if got != name or arr.shape != shape:
                raise ValueError(f"{k}: payload {got} {arr.shape}, cache "
                                 f"{name} {shape}")
            buf[j] = arr.view(buf.dtype)
        out[k] = src
    return out


def _scatter_pages(leaves: dict[str, torch.Tensor], pages: list[int],
                   srcs: dict[str, torch.Tensor]) -> None:
    """Per leaf one synchronous host-to-device copy of its stacked pages
    and one ``index_copy_`` of them into pages ``pages``."""
    some = next(iter(leaves.values()))
    idx = torch.tensor(pages, dtype=torch.long, device=some.device)
    for k, v in leaves.items():
        v.index_copy_(1, idx, srcs[k].to(v.device).transpose(0, 1))


def install_page_payloads(cache: Tree, pages: list[int],
                          blobs: list[bytes],
                          keys: frozenset[str] | set[str] | None = None,
                          ) -> None:
    """Recall: write each payload of ``blobs`` into physical page
    ``pages[j]`` of the paged leaves (of one region, ``keys``), in place —
    the inverse of :func:`extract_page_payloads`. Per leaf the payloads
    are gathered into one host buffer (page-locked for a CUDA cache),
    copied to the device once, synchronously, and scattered with one
    ``index_copy_`` along the page dim. A payload must carry every leaf of
    the region, in the cache's dtype and page shape."""
    if len(pages) != len(blobs):
        raise ValueError(f"{len(pages)} pages for {len(blobs)} payloads")
    if not pages:
        return
    leaves = _paged_leaves(cache, keys)
    some = next(iter(leaves.values()))
    _scatter_pages(leaves, pages, _stack_payloads(leaves, blobs, some.is_cuda))


class RemotePagePool:
    """Spill tier: lend cold KV pages to neighbor cloudlet hosts.

    The paper's core move is harvesting *sporadically available,
    non-exclusive* neighbor resources; this class applies it to serving
    memory. When local page pressure would destroy retained prefix-cache
    pages, the engine serializes them and **lends** them to a peer chosen
    from ``registry.peers(cloudlet, host_id)`` — most reliable first, per
    the §III-B reliability table — leaving a :class:`SpilledPage` stub in
    the prefix trie. A later prompt that hits the spilled prefix
    **recalls** the pages (batched, one simulated round trip per peer)
    before chunked prefill of the suffix.

    Borrowed memory is revocable: a peer's ``leave()`` invalidates every
    lease it held (see :class:`~repro_torch.core.cloudlet.LeaseTable`), so a
    recall *misses* — the engine drops the stub's subtree and recomputes.
    The churn-safety invariant: a recall either returns the exact bytes
    that were lent, or nothing; stale data is unrepresentable because
    lease validity is checked against live cloudlet membership at recall
    time.

    Simulated latency is accounted against §III-B reliability: expected
    transfer time is scaled by ``1 / (1 - failure_probability(peer))`` —
    the geometric-retry expectation over the peer's availability trace —
    so flaky peers cost more wall-clock even when they eventually answer.
    The engine converts the returned wait into recall-in-flight decode
    steps (the scheduler keeps the slot admitted but holds its decode).
    """

    def __init__(
        self,
        registry: CloudletRegistry,
        cloudlet: str,
        host_id: str,
        *,
        reliability: ReliabilityRegistry | None = None,
        peer_capacity_pages: int = 64,
        lend_page_s: float = LEND_PAGE_S,
        recall_rtt_s: float = RECALL_RTT_S,
        recall_page_s: float = RECALL_PAGE_S,
    ):
        self.registry = registry
        self.cloudlet = cloudlet
        self.host_id = host_id
        self.reliability = reliability
        self.peer_capacity_pages = peer_capacity_pages
        self.lend_page_s = lend_page_s
        self.recall_rtt_s = recall_rtt_s
        self.recall_page_s = recall_page_s
        self._store: dict[int, bytes] = {}  # lease id -> lent payload
        # slot spill groups: group key -> {chain index: lease id}. One
        # group holds a preempted slot's whole page chain; staged pages
        # (write-behind) join the group before the preemption happens.
        self._slots: dict[int, dict[int, int]] = {}
        self.stats = {
            "pages_lent": 0,
            "pages_recalled": 0,
            "recall_misses": 0,
            "lend_rejects": 0,
            "pages_staged": 0,
            "slots_spilled": 0,
            "slots_recalled": 0,
            "slot_recall_misses": 0,
            "sim_lend_s": 0.0,
            "sim_recall_s": 0.0,
        }

    # ------------------------------------------------------------- placement
    def peers(self) -> list[str]:
        """Lending candidates: cloudlet co-members, most reliable first
        (unrecorded hosts last, alphabetical — deterministic)."""
        cands = self.registry.peers(self.cloudlet, self.host_id)
        if self.reliability is None:
            return sorted(cands)
        known = [h for h in cands if h in self.reliability]
        unknown = sorted(h for h in cands if h not in self.reliability)
        return self.reliability.ranked(known) + unknown

    def held_pages(self, peer: str) -> int:
        """Pages ``peer`` currently stores for this cloudlet (its lending
        budget is shared across all lenders)."""
        return sum(
            1 for m in self.registry.leases.held_by(peer)
            if m.cloudlet == self.cloudlet
        )

    def _retry_factor(self, peer: str) -> float:
        if self.reliability is None or peer not in self.reliability:
            return 1.0
        p = min(self.reliability.failure_probability(peer), 0.95)
        return 1.0 / (1.0 - p)

    # ------------------------------------------------------------ lend/recall
    def lend(self, payload: bytes) -> PageLease | None:
        """Lend one serialized page to the most reliable peer with spare
        capacity; returns the lease, or None (caller must evict) when no
        peer can take it."""
        for peer in self.peers():
            if self.held_pages(peer) >= self.peer_capacity_pages:
                continue
            lease = self.registry.leases.grant(
                self.cloudlet, self.host_id, peer, len(payload)
            )
            self._store[lease.lease_id] = payload
            self.stats["pages_lent"] += 1
            self.stats["sim_lend_s"] += (
                self.lend_page_s * self._retry_factor(peer)
            )
            return lease
        self.stats["lend_rejects"] += 1
        return None

    def lease_valid(self, lease_id: int) -> bool:
        """A lease is recallable iff the table still has it, its holder is
        still a cloudlet member, and the payload is still stored."""
        lease = self.registry.leases.get(lease_id)
        return (
            lease is not None
            and lease.holder in self.registry.get(self.cloudlet).members
            and lease_id in self._store
        )

    def recall(self, lease_ids: list[int]
               ) -> tuple[dict[int, bytes | None], float]:
        """Batched recall of lent pages. Returns ``(payloads, wait_s)``:
        per-lease payload bytes (None = miss, the holder churned away) and
        the simulated wall-clock wait — one RTT per distinct peer plus a
        reliability-scaled per-page transfer cost."""
        out: dict[int, bytes | None] = {}
        wait = 0.0
        peers_hit: set[str] = set()
        for lid in lease_ids:
            if not self.lease_valid(lid):
                # churned holder (or revoked lease): drop any orphaned
                # payload; the caller falls back to recompute
                self._store.pop(lid, None)
                self.registry.leases.release(lid)
                out[lid] = None
                self.stats["recall_misses"] += 1
                continue
            lease = self.registry.leases.release(lid)
            out[lid] = self._store.pop(lid)
            peers_hit.add(lease.holder)
            wait += self.recall_page_s * self._retry_factor(lease.holder)
            self.stats["pages_recalled"] += 1
        wait += self.recall_rtt_s * len(peers_hit)
        self.stats["sim_recall_s"] += wait
        return out, wait

    def release(self, lease_id: int) -> None:
        """Drop a lease whose page will never be recalled (its trie stub
        was evicted): frees the peer's capacity immediately."""
        self._store.pop(lease_id, None)
        self.registry.leases.release(lease_id)

    # --------------------------------------------------- slot spill groups
    def stage_page(self, key: int, idx: int, payload: bytes) -> bool:
        """Write-behind: pre-stage one page of slot group ``key`` (chain
        index ``idx``) on a peer while the slot is still decoding. Only
        *full* pages may be staged — their contents are immutable, so the
        staged bytes stay exact. Fail-soft: returns False (page simply
        not staged) when no peer has capacity; a later :meth:`spill_slot`
        ships it with the unstaged remainder."""
        group = self._slots.setdefault(key, {})
        if idx in group:
            return True
        lease = self.lend(payload)
        if lease is None:
            return False
        group[idx] = lease.lease_id
        self.stats["pages_staged"] += 1
        return True

    def staged_pages(self, key: int) -> frozenset[int]:
        """Chain indices of group ``key`` already on a peer — what a
        spill-cost-aware victim choice counts as pre-paid."""
        return frozenset(self._slots.get(key, ()))

    def spill_slot(self, key: int, payloads: dict[int, bytes]) -> bool:
        """Lend a preempted slot's remaining (unstaged) chain pages as
        group ``key``, all-or-nothing: on success every index in
        ``payloads`` plus previously staged ones is lease-tracked for
        :meth:`recall_slot`; on failure (a page found no peer) the whole
        group — fresh leases *and* staged ones — is released and False
        returned, so the caller falls back to re-prefill with no leaked
        peer capacity."""
        group = self._slots.setdefault(key, {})
        fresh: list[int] = []
        for idx, payload in payloads.items():
            if idx in group:
                continue  # already write-behind staged
            lease = self.lend(payload)
            if lease is None:
                for lid in fresh:
                    self.release(lid)
                for lid in group.values():
                    self.release(lid)
                del self._slots[key]
                return False
            group[idx] = lease.lease_id
            fresh.append(lease.lease_id)
        self.stats["slots_spilled"] += 1
        return True

    def recall_slot(self, key: int) -> tuple[dict[int, bytes] | None, float]:
        """All-or-nothing recall of slot group ``key``. Returns
        ``(payloads, wait_s)`` mapping chain index -> exact lent bytes on
        a full hit; ``(None, wait_s)`` when any page's holder churned
        away (the partial remainder is useless — a chain with a hole
        cannot seed a decode cache), with every surviving lease released.
        Either way the group is gone afterwards."""
        group = self._slots.pop(key, None)
        if group is None:
            return None, 0.0
        got, wait = self.recall(list(group.values()))
        out = {idx: got[lid] for idx, lid in group.items()}
        if any(b is None for b in out.values()):
            self.stats["slot_recall_misses"] += 1
            return None, wait
        self.stats["slots_recalled"] += 1
        return out, wait

    def release_slot(self, key: int) -> None:
        """Drop slot group ``key`` without recalling it (the request was
        shed/cancelled, or fell back to re-prefill): frees the peers'
        capacity immediately. Safe on an unknown key."""
        group = self._slots.pop(key, None)
        for lid in (group or {}).values():
            self.release(lid)

    def slot_leases(self, key: int) -> dict[int, tuple[int, str]]:
        """Snapshot view of group ``key``: chain index -> (lease id,
        holder peer). Empty for an unknown key."""
        out: dict[int, tuple[int, str]] = {}
        for idx, lid in self._slots.get(key, {}).items():
            lease = self.registry.leases.get(lid)
            out[idx] = (lid, lease.holder if lease else "")
        return out

    def adopt_slot(self, key: int, leases: dict[int, int]) -> bool:
        """Re-adopt a restored snapshot's slot group: every lease must
        still be valid (holder in the cloudlet, payload stored) or the
        whole group is released and False returned — a restore can only
        trust a chain it can recall completely. Leases the live pool
        tracks under ``key`` but the snapshot does not (staged after the
        snapshot was cut) are released rather than leaked."""
        existing = self._slots.pop(key, None) or {}
        for lid in set(existing.values()) - set(leases.values()):
            self.release(lid)
        if any(not self.lease_valid(lid) for lid in leases.values()):
            for lid in leases.values():
                self.release(lid)
            return False
        self._slots[key] = dict(leases)
        return True

    @property
    def lent(self) -> int:
        return len(self._store)


def init_paged_cache(model: ModelFns, n_slots: int, n_pages: int,
                     page_size: int, dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device = "cuda") -> Tree:
    """The model's zeroed paged cache on ``device``: layer-stacked page
    pools ``*_pages`` ``(L, n_pages, page_size, K, dh)`` in ``dtype``, and,
    for the SSM and hybrid families, dense per-slot state leaves — ``conv``
    ``(L, n_slots, W-1, C)`` in ``dtype`` and ``ssm`` ``(L, n_slots, ...)``
    in f32 (the reference's rule, ``model_api._cache_dtype``). The
    engine's page operations (``_copy_pages``) touch only ``*_pages``."""
    return model.init_paged_cache(n_slots, n_pages, page_size, dtype, device)


def paged_cache_partition_specs(model: ModelFns, n_slots: int, n_pages: int,
                                page_size: int, grid) -> Tree:
    """The paged cache's :class:`~repro_torch.parallel.partition.
    PartitionSpec` per leaf on ``grid``, from its logical axes and abstract
    shapes: a pool shards over ``kv_heads`` where the count divides the
    model axis, else over ``pages``. The layout half of
    :func:`paged_cache_shardings`."""
    axes = model.paged_cache_axes(n_slots, n_pages, page_size)
    abstract = model.abstract_paged_cache(n_slots, n_pages, page_size)
    return tree_partition_specs(axes, abstract, grid)


def paged_cache_shardings(model: ModelFns, n_slots: int, n_pages: int,
                          page_size: int, mesh) -> Tree:
    """The paged cache's :class:`~repro_torch.parallel.partition.Sharding`
    per leaf on ``mesh`` (``kvcache.py:814-819``): the placements of
    :func:`paged_cache_partition_specs`."""
    axes = model.paged_cache_axes(n_slots, n_pages, page_size)
    abstract = model.abstract_paged_cache(n_slots, n_pages, page_size)
    return tree_shardings(axes, abstract, mesh)


def cache_shardings(model: ModelFns, n_slots: int, max_seq: int,
                    mesh) -> Tree:
    """The dense cache's :class:`~repro_torch.parallel.partition.Sharding`
    per leaf on ``mesh`` (``kvcache.py:92-96``)."""
    return tree_shardings(model.cache_axes(n_slots, max_seq),
                          model.abstract_cache(n_slots, max_seq), mesh)
