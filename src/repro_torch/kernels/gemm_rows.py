"""Row-invariant matrix product: a CUDA C++ kernel for Hopper, its plan, its
plain version, its launch count, and the shapes of a decode step's products.

The kernel (``csrc/gemm_rows.cu``, which carries the design note) has no
TPU counterpart: the JAX package leaves these products to XLA. It exists to
keep the reference's guarantee that greedy speculative decoding equals plain
decoding. The verify folds its ``B·W`` window lanes into the paged decode
step (``models/transformer.py``), so a lane's arithmetic must not change
with the number of rows in the call; cuBLAS, which picks its kernel from
the row count, breaks that on the H100 (the first 8 rows of a 40-row 4096 x
1024 product differ from an 8-row product). Here a row's bits depend only on
that row and the weights: ``plan`` fixes the tiles, the k step and the K
segments from (K, N, the layout of w, the SM count), never from the row
count, and the segments' f32 partials are added in segment order.

It is chosen by entry point, never by row count: ``decode_paged_fn`` (and
so the verify) passes it down as ``mm``; prefill, the dense engine and the
SSM families keep ``torch.matmul``.

``gemm_rows_grouped`` is the same kernel over all E experts of an MoE
layer at once (``buf (E, C, K) @ w (E, K, N)``, one launch): its plan
(``plan_grouped``) is fixed by (E, K, N, the SM count), never by the
capacity C or the routing, and with the routing's ``counts`` it skips the
64-row passes no token reached, so an expert no lane chose costs no weight
read. The MoE paged decode step takes it for the routed experts.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import _build
from repro_torch.kernels._flash_decode import counters
from repro_torch.kernels.ref import gemm_rows as plain  # noqa: F401  (beside the kernel)
from repro_torch.kernels.ref import gemm_rows_grouped as plain_grouped  # noqa: F401

SUB_N = 64                # columns of a consumer warpgroup: SUB_N
ROWS = 64                 # rows of a pass: XROWS
RING_BYTES = 192 * 1024   # the ring's w and x tiles, a block: RING_BYTES
X_STAGE = ROWS * 128      # an x tile: 64 rows of 64 k (128 bytes)
MAX_SEG_128 = 5           # the most segments a 128-column tile is cut in


class Plan(NamedTuple):
    """How the kernel cuts one product, for a given SM count: ``n_tiles``
    tiles of ``bn`` columns (``bn / 64`` consumer warpgroups), ``bk`` k per
    step (a ring stage), each tile's ``kt`` steps cut into K segments:
    ``s_base`` of them, one more for the first ``extra`` tiles. Segment
    ``s`` of ``S`` is steps ``s kt / S`` to ``(s + 1) kt / S`` (rounded
    down); the work items are (tile, segment), tile by tile, and block
    ``b`` of ``grid`` takes items ``b``, ``b + grid``, ...; ``n_seg`` is
    the most segments a tile has, ``stages`` the ring's depth;
    ``evict_first`` marks w's loads evict-first in L2."""

    K: int
    N: int
    bn: int
    bk: int
    n_tiles: int
    s_base: int
    extra: int
    grid: int
    stages: int
    evict_first: bool

    @property
    def kt(self) -> int:
        return -(-self.K // self.bk)

    @property
    def n_seg(self) -> int:
        return self.s_base + (self.extra > 0)

    @property
    def items(self) -> int:
        """Work items of one 64-row pass."""
        return self.n_tiles * self.s_base + self.extra

    def work(self) -> list[tuple[int, int, int, int]]:
        """Every item of a pass as (tile, segment, k0, k1), k in steps, in
        item order (the kernel's ``item_at``)."""
        out = []
        for t in range(self.n_tiles):
            S = self.s_base + (t < self.extra)
            out += [(t, s, s * self.kt // S, (s + 1) * self.kt // S)
                    for s in range(S)]
        return out

    def segments(self, t: int) -> list[tuple[int, int]]:
        """The K range ``[k0, k1)`` of each segment of tile ``t``, in merge
        order."""
        return [(k0 * self.bk, min(self.K, k1 * self.bk))
                for tt, _, k0, k1 in self.work() if tt == t]

    def scratch_floats(self, M: int) -> int:
        """f32 partials of an ``M``-row launch: ``n_seg * N`` a row when a
        tile is split, none when none is."""
        return M * self.N * self.n_seg if self.n_seg > 1 else 0


@functools.cache
def plan(K: int, N: int, nk: bool, n_sm: int) -> Plan:
    """The kernel's cut of a (K, N) product on a card of ``n_sm`` SMs; ``nk``
    where w is stored (N, K). A pure function of these four: the row count
    is no argument, so a row's order over K is the same at every M.

    Every SM gets an item, in one wave, where the product has enough k
    steps: tiles are cut into the fewest segments that make at least
    ``n_sm`` items (``n_sm // n_tiles`` each, one more for the first
    ``n_sm % n_tiles``), so the items are ``n_sm`` exactly. All tiles cut K
    at nearly the same steps, so the blocks read the same rows of w at
    once, as DRAM pages prefer. Tiles are 128 columns (x read once for
    twice the columns, 256-byte runs of each row of w) unless that cuts
    them in more than ``MAX_SEG_128`` segments, else 64: each segment
    costs a partial and a share of the merge, and at 40 rows the merge of
    16 segments cost more than 64-column tiles do. ``bk`` is 64, or 32
    where 64 leaves fewer steps than SMs. The loads of w are marked
    evict-first in L2 (w is read once a step) where the items fit one
    wave; where they take many (the unembedding) that measured slower on
    the H100 (``PERF.md``)."""
    bn = 2 * SUB_N if MAX_SEG_128 * -(-N // (2 * SUB_N)) >= n_sm else SUB_N
    return _cut(K, N, n_sm, bn)


def _cut(K: int, N: int, n_sm: int, bn: int) -> Plan:
    """``plan``'s cut at tile width ``bn``."""
    n_tiles = -(-N // bn)
    bk = 64 if n_tiles * -(-K // 64) >= n_sm else 32
    kt = -(-K // bk)
    if n_tiles >= n_sm:
        s_base, extra = 1, 0
    elif n_tiles * kt <= n_sm:
        s_base, extra = kt, 0
    else:
        s_base, extra = divmod(n_sm, n_tiles)
    items = n_tiles * s_base + extra
    return Plan(K, N, bn, bk, n_tiles, s_base, extra, min(n_sm, items),
                RING_BYTES // (bk * bn * 2 + X_STAGE), items <= n_sm)


@functools.cache
def plan_grouped(E: int, K: int, N: int, n_sm: int) -> Plan:
    """The kernel's cut of a grouped ``(E, K, N)`` product on a card of
    ``n_sm`` SMs: tiles of 128 columns, or 64 where 128 would give fewer
    items than SMs (granite-moe's 32 experts at N 512), k steps of 64,
    every tile whole (E tiles already give the SMs items: no K split, no
    partials), the items (expert, tile) expert by expert. A pure function
    of these four: no capacity, no routing."""
    bn = 2 * SUB_N if E * -(-N // (2 * SUB_N)) >= n_sm else SUB_N
    n_tiles = -(-N // bn)
    items = E * n_tiles
    return Plan(K, N, bn, 64, n_tiles, 1, 0, min(n_sm, items),
                RING_BYTES // (64 * bn * 2 + X_STAGE), items <= n_sm)


@functools.cache
def _lib():
    lib = _build.load("gemm_rows")
    lib.gemm_rows_record.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 10 + [
        ctypes.POINTER(ctypes.c_void_p)]
    lib.gemm_rows_record.restype = ctypes.c_int
    lib.gemm_rows_free_record.argtypes = [ctypes.c_void_p]
    lib.gemm_rows_free_record.restype = None
    lib.gemm_rows_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gemm_rows_smem.restype = ctypes.c_int
    fn = lib.gemm_rows_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    grouped = lib.gemm_rows_grouped_bf16
    grouped.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    grouped.restype = ctypes.c_int
    return lib


@functools.cache
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# per weight (pointer, shape, strides, dtype, device): its launch record
# (w's tensor map and plan, encoded once: a weight keeps its address for
# the life of a serve) and the plan's numbers a launch passes
_launches: dict[tuple, tuple] = {}
MAX_RECORDS = 4096


def _record(w: torch.Tensor, K: int, N: int, ld: int, nk: int, p: Plan,
            n_exp: int) -> int:
    """Encode w's tensor map and ``p`` into a launch record."""
    lib = _lib()
    if len(_launches) >= MAX_RECORDS:
        forget()
    rec = ctypes.c_void_p()
    err = lib.gemm_rows_record(w.data_ptr(), K, N, ld, nk, p.bk,
                               p.bn // SUB_N, p.s_base, p.extra,
                               int(p.evict_first), n_exp, ctypes.byref(rec))
    _build.check(err, "gemm_rows (tensor map)")
    return rec.value


def _check_device(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"gemm_rows kernel needs CUDA tensors on one "
                         f"device, got {x.device} and {w.device}")
    if w.dtype != torch.bfloat16:
        raise TypeError(f"gemm_rows kernel: w must be bf16, got {w.dtype}")


def _prepare(x: torch.Tensor, w: torch.Tensor, key: tuple) -> tuple:
    """Check a weight (and that ``x`` can meet it), plan its product and
    encode its tensor map; cached under ``key``. The record holds no
    reference to w (the cache must not keep a dropped model's weights
    alive): a weight keeps its address for the life of a serve. A (K, N)
    weight whose N is no multiple of 8 is copied once into rows of ``ld``
    (N rounded up to 8) columns, zero past N, which the record keeps with
    a weak reference to w: the map's row pitch must be a multiple of 16
    bytes. The copy is taken when the record is made, as the tensor map is:
    a weight keeps its values for the life of a serve, and another tensor
    at w's address is copied anew."""
    _check_device(x, w)
    if w.ndim != 2:
        raise TypeError(f"gemm_rows kernel: w must be a matrix, got "
                        f"{tuple(w.shape)}")
    K, N = w.shape
    if w.is_contiguous():
        nk = 0
    elif w.t().is_contiguous():
        nk = 1
    else:
        raise ValueError("gemm_rows kernel: w must be contiguous or the "
                         "transpose of a contiguous tensor")
    if K % 8 or w.data_ptr() % 16:
        raise ValueError(f"gemm_rows kernel: K {K} must be a multiple of 8 "
                         f"and w 16-byte aligned")
    src, ld, pad = w, N, None
    if not nk and N % 8:
        ld = -(-N // 8) * 8
        src = torch.zeros(K, ld, dtype=w.dtype, device=w.device)
        src[:, :N] = w
        pad = (src, weakref.ref(w))
    p = plan(K, N, nk, _n_sm(x.device.index))
    launch = _launches[key] = (K, N, _record(src, K, N, ld, nk, p, 0),
                               p.grid, p.scratch_floats(1), p.n_tiles, pad)
    return launch


def forget() -> None:
    """Free every launch record, grouped ones too (the next call of a
    weight encodes its tensor map again)."""
    for launch in _launches.values():
        _lib().gemm_rows_free_record(launch[2])
    _launches.clear()


def gemm_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``x (..., K) @ w (K, N)`` in bf16 with f32 sums.
    ``w`` is contiguous, or the transpose of a contiguous ``(N, K)`` tensor
    (a tied embedding's ``embedding.t()``). The checks of ``w`` run once
    per weight, with its plan and tensor map; a call checks ``x``."""
    dev = x.device
    key = (w.data_ptr(), w.shape, w.stride(), w.dtype, dev)
    launch = _launches.get(key)
    if launch is not None and launch[6] is not None \
            and launch[6][1]() is not w:   # a padded copy of another w
        _lib().gemm_rows_free_record(launch[2])
        launch = None
    launch = launch or _prepare(x, w, key)
    K, N, rec, grid, scratch_a_row, n_tiles, _ = launch
    if x.dtype != torch.bfloat16 or x.shape[-1] != K:
        raise ValueError(f"gemm_rows kernel: x {x.dtype} "
                         f"{tuple(x.shape)} @ w {tuple(w.shape)} (bf16)")
    flat = x.ndim == 2 and x.is_contiguous()
    x2 = x if flat else x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:
        raise ValueError("gemm_rows kernel: x is not 16-byte aligned")
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    if M:
        part = cnt = None
        if scratch_a_row:  # the plan splits K
            # the f32 partials of split products
            part = _build.scratch("gemm_rows", max(M * scratch_a_row, 1 << 20),
                                  torch.float32, dev).data_ptr()
            cnt = counters(-(-M // ROWS) * n_tiles, dev).data_ptr()
        err = _lib().gemm_rows_bf16(x2.data_ptr(), rec, out.data_ptr(), part,
                                    cnt, M, grid, _build.stream(dev))
        _build.check(err, "gemm_rows")
        gemm_rows.launches += 1
    return out if flat else out.reshape(*x.shape[:-1], N)


gemm_rows.launches = 0


def _prepare_grouped(buf: torch.Tensor, w: torch.Tensor, key: tuple) -> tuple:
    """``_prepare`` for a grouped product: w (E, K, N) contiguous bf16."""
    _check_device(buf, w)
    if w.ndim != 3 or not w.is_contiguous():
        raise ValueError(f"gemm_rows_grouped kernel: w must be a contiguous "
                         f"(E, K, N) tensor, got {tuple(w.shape)}")
    E, K, N = w.shape
    if K % 8 or N % 8 or w.data_ptr() % 16:
        raise ValueError(f"gemm_rows_grouped kernel: K {K} and N {N} must "
                         f"be multiples of 8 and w 16-byte aligned")
    p = plan_grouped(E, K, N, _n_sm(buf.device.index))
    launch = _launches[key] = (K, N, _record(w, K, N, N, 0, p, E), p.grid,
                               0, p.n_tiles, None)
    return launch


def gemm_rows_grouped(buf: torch.Tensor, w: torch.Tensor,
                      counts: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel: ``buf (E, C, K) @ w (E, K, N)`` in bf16 with f32
    sums, one launch for all experts. With ``counts`` (E,) int64 on the
    card (the routing's per-expert counts), expert e's rows at or past
    ``counts[e]`` are neither read nor written: the result holds whatever
    its memory held there."""
    dev = buf.device
    key = (w.data_ptr(), w.shape, w.stride(), w.dtype, dev)
    launch = _launches.get(key) or _prepare_grouped(buf, w, key)
    K, N, rec, grid = launch[:4]
    E = w.shape[0]
    if buf.dtype != torch.bfloat16 or buf.ndim != 3 \
            or buf.shape[0] != E or buf.shape[2] != K:
        raise ValueError(f"gemm_rows_grouped kernel: buf {buf.dtype} "
                         f"{tuple(buf.shape)} @ w {tuple(w.shape)} (bf16)")
    if counts is not None and (counts.dtype != torch.int64
                               or counts.shape != (E,)
                               or counts.device != dev):
        raise ValueError(f"gemm_rows_grouped kernel: counts must be ({E},) "
                         f"int64 on {dev}")
    buf = buf.contiguous()
    if buf.data_ptr() % 16:
        raise ValueError("gemm_rows_grouped kernel: buf is not 16-byte "
                         "aligned")
    C = buf.shape[1]
    out = torch.empty((E, C, N), dtype=torch.bfloat16, device=dev)
    if C:
        err = _lib().gemm_rows_grouped_bf16(
            buf.data_ptr(), rec, out.data_ptr(),
            None if counts is None else counts.data_ptr(), C, grid,
            _build.stream(dev))
        _build.check(err, "gemm_rows_grouped")
        gemm_rows_grouped.launches += 1
    return out


gemm_rows_grouped.launches = 0


def decode_products(cfg: ModelConfig) -> list[tuple[str, int, int, bool]]:
    """``(name, K, N, nk)`` of each matrix product that one decode step of
    a dense config runs per layer (q, k, v, o, the MLP's three) and once
    (the unembedding; ``nk`` where it is the tied embedding's transpose)."""
    d, dh = cfg.d_model, cfg.d_head
    return [("q", d, cfg.n_heads * dh, False),
            ("k", d, cfg.n_kv_heads * dh, False),
            ("v", d, cfg.n_kv_heads * dh, False),
            ("o", cfg.n_heads * dh, d, False),
            ("gate", d, cfg.d_ff, False), ("up", d, cfg.d_ff, False),
            ("down", cfg.d_ff, d, False),
            ("unembed", d, cfg.vocab_size, cfg.tie_embeddings)]


def step_products(cfg: ModelConfig) -> list[tuple[str, int, int, bool, int]]:
    """``(name, K, N, nk, times)``: each row-invariant product of one paged
    decode step of a config and how many times a step runs it. A dense or
    VLM config's layers run ``decode_products``. An enc-dec config's
    decoder layers run q, k, v and o of the self attention, q and o of the
    cross attention and the GELU MLP's two. An MoE config's layers run q,
    k, v and o, its MoE layers the shared experts' three (its routed
    experts go through ``gemm_rows_grouped``), its leading dense layers
    their MLP's three."""
    L = cfg.n_layers
    if cfg.family in ("dense", "vlm"):
        return [(name, K, N, nk, 1 if name == "unembed" else L)
                for name, K, N, nk in decode_products(cfg)]
    if cfg.family == "encdec":
        d, hd = cfg.d_model, cfg.n_heads * cfg.d_head
        out = [(name, K, N, nk, L)
               for name, K, N, nk in decode_products(cfg)[:4]]
        return out + [("cross q", d, hd, False, L),
                      ("cross o", hd, d, False, L),
                      ("wi", d, cfg.d_ff, False, L),
                      ("wd", cfg.d_ff, d, False, L),
                      ("unembed", d, cfg.vocab_size, cfg.tie_embeddings, 1)]
    d, nd = cfg.d_model, cfg.first_k_dense
    out = [(name, K, N, nk, cfg.n_layers)
           for name, K, N, nk in decode_products(cfg)[:4]]
    shared = cfg.n_shared_experts * cfg.d_expert
    for tag, width, times in (("shared", shared, cfg.n_layers - nd),
                              ("dense", cfg.d_ff_dense or cfg.d_ff, nd)):
        if width and times:
            out += [(f"{tag} gate", d, width, False, times),
                    (f"{tag} up", d, width, False, times),
                    (f"{tag} down", width, d, False, times)]
    return out + [("unembed", d, cfg.vocab_size, cfg.tie_embeddings, 1)]


def grouped_products(cfg: ModelConfig) -> list[tuple[str, int, int, int]]:
    """``(name, E, K, N)`` of each grouped product of an MoE layer's routed
    experts on the paged decode step (gate, up, down)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_expert
    return [("gate", E, d, f), ("up", E, d, f), ("down", E, f, d)]
