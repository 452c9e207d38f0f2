"""Host-side state of the paged KV cache: the page allocator and the
prefix trie, plus the pool allocation.

Ported from ``repro/serving/kvcache.py`` (``pages_needed``, ``PagePool``,
``PrefixIndex``: lines 137-487; ``init_paged_cache``: line 809). The
allocator and the trie are plain Python, copied as they are; the pools
themselves are torch tensors made by the model's ``init_paged_cache``.

The multi-host spill tier (``RemotePagePool``, ``SpilledPage``, the page
payload helpers) and the copies of ``core/cloudlet.py`` and
``core/reliability.py`` it needs come with the spill slice (ROADMAP).
"""

from __future__ import annotations

import torch

from repro_torch.models.model_api import ModelFns, Tree

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


def init_paged_cache(model: ModelFns, n_slots: int, n_pages: int,
                     page_size: int, dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device = "cuda") -> Tree:
    """The model's zeroed paged cache: layer-stacked page pools
    ``(L, n_pages, page_size, K, dh)`` on ``device``."""
    return model.init_paged_cache(n_slots, n_pages, page_size, dtype, device)
