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
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import _build
from repro_torch.kernels._flash_decode import counters
from repro_torch.kernels.ref import gemm_rows as plain  # noqa: F401  (beside the kernel)

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
def _lib():
    lib = _build.load("gemm_rows")
    lib.gemm_rows_record.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 8 + [
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
    return lib


@functools.cache
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# per weight (pointer, shape, strides, dtype, device): its launch record
# (w's tensor map and plan, encoded once: a weight keeps its address for
# the life of a serve) and the plan's numbers a launch passes
_launches: dict[tuple, tuple] = {}
MAX_RECORDS = 4096
# per device, the f32 partials of split products, grown on demand
_partials: dict[torch.device, torch.Tensor] = {}


def _prepare(x: torch.Tensor, w: torch.Tensor, key: tuple) -> tuple:
    """Check a weight (and that ``x`` can meet it), plan its product and
    encode its tensor map; cached under ``key``."""
    dev = x.device
    if dev.type != "cuda" or w.device != dev:
        raise ValueError(f"gemm_rows kernel needs CUDA tensors on one "
                         f"device, got {x.device} and {w.device}")
    if w.dtype != torch.bfloat16 or w.ndim != 2:
        raise TypeError(f"gemm_rows kernel: w must be a bf16 matrix, got "
                        f"{w.dtype} {tuple(w.shape)}")
    K, N = w.shape
    if w.is_contiguous():
        nk = 0
    elif w.t().is_contiguous():
        nk = 1
    else:
        raise ValueError("gemm_rows kernel: w must be contiguous or the "
                         "transpose of a contiguous tensor")
    if K % 8 or N % 8 or w.data_ptr() % 16:
        raise ValueError(f"gemm_rows kernel: K {K} and N {N} must be "
                         f"multiples of 8 and w 16-byte aligned")
    p = plan(K, N, nk, _n_sm(dev.index))
    lib = _lib()
    if len(_launches) >= MAX_RECORDS:
        forget()
    rec = ctypes.c_void_p()
    err = lib.gemm_rows_record(w.data_ptr(), K, N, nk, p.bk, p.bn // SUB_N,
                               p.s_base, p.extra, int(p.evict_first),
                               ctypes.byref(rec))
    _build.check(err, "gemm_rows (tensor map)")
    launch = _launches[key] = (K, N, rec.value, p.grid, p.scratch_floats(1),
                               p.n_tiles)
    return launch


def forget() -> None:
    """Free every launch record (the next call of a weight encodes its
    tensor map again)."""
    for launch in _launches.values():
        _lib().gemm_rows_free_record(launch[2])
    _launches.clear()


def _scratch(n: int, device: torch.device) -> torch.Tensor:
    buf = _partials.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 1 << 20), dtype=torch.float32, device=device)
        _partials[device] = buf
    return buf


def gemm_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``x (..., K) @ w (K, N)`` in bf16 with f32 sums.
    ``w`` is contiguous, or the transpose of a contiguous ``(N, K)`` tensor
    (a tied embedding's ``embedding.t()``). The checks of ``w`` run once
    per weight, with its plan and tensor map; a call checks ``x``."""
    dev = x.device
    key = (w.data_ptr(), w.shape, w.stride(), w.dtype, dev)
    launch = _launches.get(key) or _prepare(x, w, key)
    K, N, rec, grid, scratch_a_row, n_tiles = launch
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
            part = _scratch(M * scratch_a_row, dev).data_ptr()
            cnt = counters(-(-M // ROWS) * n_tiles, dev).data_ptr()
        err = _lib().gemm_rows_bf16(x2.data_ptr(), rec, out.data_ptr(), part,
                                    cnt, M, grid, _build.stream(dev))
        _build.check(err, "gemm_rows")
        gemm_rows.launches += 1
    return out if flat else out.reshape(*x.shape[:-1], N)


gemm_rows.launches = 0


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
