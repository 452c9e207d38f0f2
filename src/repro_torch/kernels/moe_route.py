"""Token-choice top-k routing: a CUDA C++ kernel for Hopper, its plain
version, its launch count.

The kernel (``csrc/moe_route.cu``, which carries the design note) has no
TPU counterpart: the JAX package routes in XLA (``repro/models/moe.py:
209-213``). It exists for the same reason as ``gemm_rows``: on the card a
token's routing must not depend on how many tokens share the call, or a
near tie between experts flips between an 8-lane decode step and a 40-lane
verify and greedy speculation stops equalling plain decode. A token tile is
split over ``d`` across the blocks of a thread block cluster, one launch a
call; :func:`plan` fixes the cluster, the slices and the runs, and so every
summation order, from ``(d, E)`` alone. It runs on every path on the card:
prefill, the dense engine, the paged decode step and the verify folded into
it.

Training differentiates it through :class:`MoeRoute`, whose backward is
``csrc/moe_route_bwd.cu`` (its own design note): two launches, d_logits a
warp a token (written as bf16 hi, mid and lo parts), then ``dx`` and
``d_router`` on the tensor cores (``mma.sync`` on those parts and R's hi
and lo, three products each: the f32 contract), each slice of ``d`` taken
by 8 blocks (its ranks), rank ``r`` every eighth token tile from ``r``;
:func:`grads_plan` fixes that cut, and so every summation order, from
``(d, E)`` alone. Its plain version,
``ref.moe_route_grads``, sums ``d_router`` in the kernel's order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, _flash_decode
from repro_torch.kernels._cost import Cost, record
from repro_torch.kernels.ref import moe_route as plain  # noqa: F401  (beside the kernel)
from repro_torch.kernels.ref import moe_route_bwd as plain_bwd  # noqa: F401
from repro_torch.kernels.ref import moe_route_grads as plain_grads  # noqa: F401

MAX_E, MAX_K, MAX_D = 256, 16, 8192   # csrc MAX_E, MAX_K, MAX_D
THREADS = 512      # csrc THREADS: a block
MAX_C = 8          # csrc MAX_C: blocks of a cluster (portable)
MIN_SLICE = 64     # the fewest router rows a block of a cluster owns
# the backward's second launch (csrc/moe_route_bwd.cu): THREADS, TILE_FLOATS,
# RANKS
GRADS_THREADS, TILE_FLOATS, RANKS = 256, 4096, 8
SMS = 132          # the H100's SMs: one wave of the backward's blocks, two
BLOCKS_PER_SM = 2  # an SM (csrc __launch_bounds__)


class Plan(NamedTuple):
    """How the kernel cuts ``x @ router`` for ``(d, E)``: a cluster of
    ``C`` blocks, block ``r`` owning router rows ``[r S, r S + S)`` (the last
    slice may be shorter); thread ``j E + e`` of a block folds expert ``e``
    over run ``j`` of its slice, rows ``[j L, j L + L)`` of it (the last
    runs may be shorter or empty), in row order. A logit is the ``J`` runs'
    partials added in run order, then the ``C`` blocks' in rank order."""

    d: int
    E: int
    C: int
    S: int
    J: int
    L: int

    def slices(self) -> list[tuple[int, int]]:
        """Each block's router rows ``(start, stop)``, in rank order."""
        return [(r * self.S, min((r + 1) * self.S, self.d))
                for r in range(self.C)]

    def runs(self, r: int) -> list[tuple[int, int]]:
        """Block ``r``'s runs as router rows ``(start, stop)``, in run
        order; an empty run has ``start >= stop``."""
        lo, hi = self.slices()[r]
        return [(lo + min(j * self.L, hi - lo), lo + min((j + 1) * self.L,
                                                         hi - lo))
                for j in range(self.J)]

    def smem_bytes(self, tile: int) -> int:
        """Dynamic shared memory of a block for a tile of ``tile`` tokens:
        x's tile, the runs' partials, the cluster's partials of the tokens
        the block ranks (f32)."""
        tpb = -(-tile // self.C)
        return 4 * (tile * (self.S + self.J * self.E) + self.C * tpb * self.E)


@functools.cache
def plan(d: int, E: int) -> Plan:
    """The cut for ``(d, E)``; no token count enters it. ``C`` is the
    largest power of two up to 8 whose slices hold at least ``MIN_SLICE``
    rows (1 below that), ``J = THREADS // E`` runs a slice."""
    if not (1 <= E <= MAX_E and 1 <= d <= MAX_D):
        raise ValueError(f"moe_route plan: d {d}, E {E}")
    C = MAX_C
    while C > 1 and -(-d // C) < MIN_SLICE:
        C //= 2
    S = -(-d // C)
    J = THREADS // E
    return Plan(d, E, C, S, J, -(-S // J))


def tile(T: int) -> int:
    """Tokens a cluster takes (csrc: 8 up to 64 tokens, else 16). It
    changes which tokens share a block, never a token's arithmetic."""
    return 8 if T <= 64 else 16


@functools.cache
def _lib():
    lib = _build.load("moe_route")
    fn = lib.moe_route_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib_bwd():
    lib = _build.load("moe_route_bwd")
    fn = lib.moe_route_bwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def moe_route(x: torch.Tensor, router: torch.Tensor, k: int, *,
              with_probs: bool = False):
    """Launch the kernel: ``x (T, d)`` bf16, ``router (d, E)`` f32; returns
    ``weights (T, k)`` f32 and ``ids (T, k)`` int32, best first, and with
    ``with_probs`` the softmax ``probs (T, E)`` f32 too (the same launch;
    weights and ids the same bits either way)."""
    if x.device.type not in _build.DEVICES or router.device != x.device:
        raise ValueError(f"moe_route kernel needs CUDA tensors on one "
                         f"device, got {x.device} and {router.device}")
    if x.dtype != torch.bfloat16 or router.dtype != torch.float32:
        raise TypeError(f"moe_route kernel: x bf16 and router f32, got "
                        f"{x.dtype} and {router.dtype}")
    T, d = x.shape
    E = router.shape[1]
    if router.shape != (d, E) or not (1 <= k <= min(E, MAX_K)) \
            or E > MAX_E or d > MAX_D:
        raise ValueError(f"moe_route kernel: x {tuple(x.shape)}, router "
                         f"{tuple(router.shape)}, k {k}")
    x = x.contiguous()
    router = router.contiguous()
    weights = torch.empty(T, k, dtype=torch.float32, device=x.device)
    ids = torch.empty(T, k, dtype=torch.int32, device=x.device)
    probs = torch.empty(T, E, dtype=torch.float32, device=x.device) \
        if with_probs else None
    if T and x.is_meta:
        record("moe_route", cost(T, d, E, k, with_probs=with_probs))
    elif T:
        p = plan(d, E)
        err = _lib()(x.data_ptr(), router.data_ptr(), weights.data_ptr(),
                     ids.data_ptr(), probs.data_ptr() if with_probs else None,
                     T, d, E, k, p.C, p.S, p.J, p.L, _build.stream(x.device))
        _build.check(err, "moe_route")
        moe_route.launches += 1
    return (weights, ids, probs) if with_probs else (weights, ids)


moe_route.launches = 0


def cost(T: int, d: int, E: int, k: int, *,
         with_probs: bool = False) -> Cost:
    """One call: x (bf16) and the router (f32) read, weights and ids (T, k)
    written, with ``with_probs`` the softmax (T, E) f32 too; the f32
    product's 2 T d E FLOP and an exponential a logit."""
    nbytes = T * d * 2 + d * E * 4 + T * k * 8 + (T * E * 4 if with_probs
                                                    else 0)
    return Cost(2 * T * d * E, nbytes, exps=T * E, unit="f32")


def bwd_cost(T: int, d: int, E: int, k: int, *,
             basis: str = "bf16") -> Cost:
    """One backward call (two launches): x read and dx written (bf16),
    probs, dprobs (T, E), ids, weights, dw (T, k), the router read and
    d_router written (f32). The two products' 4 T d E operations run three
    times over on the tensor cores (bf16 splits under the f32 contract);
    ``basis`` "f32" counts them once on the f32 units, with d_logits' few
    a token."""
    nbytes = 4 * T * d + 8 * T * E + 12 * T * k + 8 * d * E
    if basis == "f32":
        return Cost(4 * T * d * E + 4 * T * E + 4 * T * k, nbytes,
                    unit="f32", launches=2)
    return Cost(3 * 4 * T * d * E, nbytes, unit="bf16", launches=2)


class GradsPlan(NamedTuple):
    """How the backward's second launch cuts ``(d, E)``: ``E`` rounded up
    to ``EP`` (32, 64, 128 or 256; the first launch writes d_logits' bf16
    parts in rows of ``EP + 8``); tiles of ``TT`` tokens; ``C`` blocks (its
    ranks) a slice of ``S = 8 CG`` columns of ``d`` (the last may be
    shorter), ``slices`` of them, ``blocks`` in all; rank ``r`` takes the
    tiles ``r, r + C, ...``. d_router's order: in a block, ``G`` token
    groups, group ``g`` the 16-token steps ``g, g + G, ...`` of each of its
    tiles in ascending order, one tensor-core product a step; the groups'
    partials added in group order, then the ranks' in rank order. No token
    count enters it."""

    d: int
    E: int
    EP: int
    TT: int
    CG: int
    S: int
    C: int
    slices: int
    blocks: int
    G: int

    def order(self) -> dict:
        """The keywords of ``ref.moe_route_grads`` that sum d_router in
        this plan's order."""
        return {"tile": self.TT, "ranks": self.C, "groups": self.G}


@functools.cache
def grads_plan(d: int, E: int) -> GradsPlan:
    """The cut for ``(d, E)``: the fewest column groups a block (``CG``, a
    power of two, at most 8 and ``1024 / EP``) that leave one wave of
    blocks, two an SM."""
    if not (1 <= E <= MAX_E and 8 <= d <= MAX_D and d % 8 == 0):
        raise ValueError(f"moe_route_bwd plan: d {d}, E {E}")
    EP = next(p for p in (32, 64, 128, 256) if E <= p)
    CG = 1
    while CG < min(8, 1024 // EP) and \
            -(-d // (8 * CG)) * RANKS > BLOCKS_PER_SM * SMS:
        CG *= 2
    slices = -(-d // (8 * CG))
    return GradsPlan(d, E, EP, TILE_FLOATS // EP, CG, 8 * CG, RANKS, slices,
                     slices * RANKS, max(1, 128 // EP))


def moe_route_bwd(x: torch.Tensor, router: torch.Tensor, probs: torch.Tensor,
                  ids: torch.Tensor, weights: torch.Tensor, dw: torch.Tensor,
                  dprobs: torch.Tensor | None = None, *, need_dx: bool = True,
                  need_drouter: bool = True, with_d_logits: bool = False):
    """Launch the backward kernels: from the forward's ``x (T, d)`` bf16,
    ``router (d, E)`` f32, ``probs (T, E)`` f32, ``ids (T, k)`` int32 and
    ``weights (T, k)`` f32, the weights' gradient ``dw (T, k)`` and,
    optionally, the probabilities' own ``dprobs (T, E)`` (f32); returns
    ``(dx, d_router)``: ``dx (T, d)`` bf16 unless not ``need_dx``,
    ``d_router (d, E)`` f32 unless not ``need_drouter`` (None each when not
    wanted), and with ``with_d_logits`` also the first launch's ``d_logits
    (T, E)`` f32. Two launches; one alone when neither gradient is
    wanted."""
    dev = probs.device
    if dev.type not in _build.DEVICES or any(
            t is not None and t.device != dev
            for t in (x, router, ids, weights, dw, dprobs)):
        raise ValueError("moe_route_bwd kernel needs CUDA tensors on one "
                         "device")
    T, E = probs.shape
    d = x.shape[-1]
    k = ids.shape[-1]
    if (x.dtype != torch.bfloat16 or router.dtype != torch.float32
            or probs.dtype != torch.float32 or ids.dtype != torch.int32
            or any(t.dtype != torch.float32 for t in (weights, dw))
            or (dprobs is not None and dprobs.dtype != torch.float32)):
        raise TypeError("moe_route_bwd kernel: x bf16, router, probs, "
                        "weights, dw, dprobs f32 and ids int32")
    if (x.shape != (T, d) or router.shape != (d, E) or ids.shape != (T, k)
            or weights.shape != (T, k) or dw.shape != (T, k)
            or (dprobs is not None and dprobs.shape != (T, E))
            or not (1 <= k <= min(E, MAX_K)) or E > MAX_E):
        raise ValueError(f"moe_route_bwd kernel: x {tuple(x.shape)}, router "
                         f"{tuple(router.shape)}, probs "
                         f"{tuple(probs.shape)}, ids {tuple(ids.shape)}, "
                         f"weights {tuple(weights.shape)}, dw "
                         f"{tuple(dw.shape)}")
    p = grads_plan(d, E)
    x, router, probs, ids, weights, dw = (
        t.contiguous() for t in (x, router, probs, ids, weights, dw))
    if x.data_ptr() % 16:
        x = x.clone()
    if router.data_ptr() % 16:
        router = router.clone()
    if dprobs is not None:
        dprobs = dprobs.contiguous()
    d_logits = torch.empty(T, E, dtype=torch.float32, device=dev) \
        if with_d_logits else None
    # d_logits' bf16 parts (hi, mid, lo) for the second launch, and the
    # blocks' partials of d_router: scratch the device keeps
    parts = _build.scratch("route_parts", 3 * T * (p.EP + 8), torch.bfloat16,
                           dev)
    dx = torch.empty(T, d, dtype=torch.bfloat16, device=dev) \
        if need_dx else None
    # every element written by the kernel; none at all without tokens
    d_router = (torch.empty if T else torch.zeros)(
        d, E, dtype=torch.float32, device=dev) if need_drouter else None
    part = _build.scratch("route_partials", p.blocks * p.S * E,
                          torch.float32, dev) if need_drouter else None
    if T and dev.type == "meta":
        record("moe_route_bwd", bwd_cost(T, d, E, k))
    elif T:
        err = _lib_bwd()(
            x.data_ptr(), router.data_ptr(), probs.data_ptr(), ids.data_ptr(),
            weights.data_ptr(), dw.data_ptr(),
            None if dprobs is None else dprobs.data_ptr(),
            None if d_logits is None else d_logits.data_ptr(),
            parts.data_ptr(), None if dx is None else dx.data_ptr(),
            None if d_router is None else d_router.data_ptr(),
            None if part is None else part.data_ptr(),
            _flash_decode.counters(p.slices, dev).data_ptr(),
            T, d, E, k, p.CG, _build.stream(dev))
        _build.check(err, "moe_route_bwd")
        moe_route_bwd.launches += 1
    out = (dx, d_router)
    return (*out, d_logits) if with_d_logits else out


moe_route_bwd.launches = 0


class MoeRoute(torch.autograd.Function):
    """Routing with its gradient: the forward kernel with ``probs`` out;
    the backward kernels (:func:`moe_route_bwd`) for ``dx`` (x's type) and
    ``d_router`` (f32), the einsum's products on the tensor cores under
    the f32 contract (bf16 hi, mid and lo splits), in a fixed order. Returns ``(weights, ids, probs)``; ``ids`` carries no gradient
    and ``k`` is not differentiable."""

    @staticmethod
    def forward(ctx, x, router, k: int):
        weights, ids, probs = moe_route(x, router, k, with_probs=True)
        ctx.save_for_backward(x, router, probs, ids, weights)
        ctx.mark_non_differentiable(ids)
        ctx.set_materialize_grads(False)
        return weights, ids, probs

    @staticmethod
    def backward(ctx, dw, _dids, dprobs):
        x, router, probs, ids, weights = ctx.saved_tensors
        if dw is None:
            dw = torch.zeros_like(weights)
        dx, d_router = moe_route_bwd(
            x, router, probs, ids, weights, dw.float(),
            None if dprobs is None else dprobs.float(),
            need_dx=ctx.needs_input_grad[0],
            need_drouter=ctx.needs_input_grad[1])
        return dx, d_router, None
