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
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import moe_route as plain  # noqa: F401  (beside the kernel)
from repro_torch.kernels.ref import moe_route_bwd as plain_bwd  # noqa: F401

MAX_E, MAX_K, MAX_D = 256, 16, 8192   # csrc MAX_E, MAX_K, MAX_D
THREADS = 512      # csrc THREADS: a block
MAX_C = 8          # csrc MAX_C: blocks of a cluster (portable)
MIN_SLICE = 64     # the fewest router rows a block of a cluster owns


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
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def moe_route(x: torch.Tensor, router: torch.Tensor, k: int, *,
              with_probs: bool = False):
    """Launch the kernel: ``x (T, d)`` bf16, ``router (d, E)`` f32; returns
    ``weights (T, k)`` f32 and ``ids (T, k)`` int32, best first, and with
    ``with_probs`` the softmax ``probs (T, E)`` f32 too (the same launch;
    weights and ids the same bits either way)."""
    if x.device.type != "cuda" or router.device != x.device:
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
    if T:
        p = plan(d, E)
        err = _lib()(x.data_ptr(), router.data_ptr(), weights.data_ptr(),
                     ids.data_ptr(), probs.data_ptr() if with_probs else None,
                     T, d, E, k, p.C, p.S, p.J, p.L, _build.stream(x.device))
        _build.check(err, "moe_route")
        moe_route.launches += 1
    return (weights, ids, probs) if with_probs else (weights, ids)


moe_route.launches = 0


def moe_route_bwd(probs: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor, dw: torch.Tensor,
                  dprobs: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the backward kernel: from the forward's ``probs (T, E)`` f32,
    ``ids (T, k)`` int32 and ``weights (T, k)`` f32, the weights' gradient
    ``dw (T, k)`` and, optionally, the probabilities' own ``dprobs (T, E)``
    (f32); returns ``d_logits (T, E)`` f32."""
    dev = probs.device
    if dev.type != "cuda" or any(t is not None and t.device != dev
                                 for t in (ids, weights, dw, dprobs)):
        raise ValueError("moe_route_bwd kernel needs CUDA tensors on one "
                         "device")
    T, E = probs.shape
    k = ids.shape[-1]
    if (probs.dtype != torch.float32 or ids.dtype != torch.int32
            or any(t.dtype != torch.float32 for t in (weights, dw))
            or (dprobs is not None and dprobs.dtype != torch.float32)):
        raise TypeError("moe_route_bwd kernel: probs, weights, dw, dprobs "
                        "f32 and ids int32")
    if (ids.shape != (T, k) or weights.shape != (T, k) or dw.shape != (T, k)
            or (dprobs is not None and dprobs.shape != (T, E))
            or not (1 <= k <= min(E, MAX_K)) or E > MAX_E):
        raise ValueError(f"moe_route_bwd kernel: probs {tuple(probs.shape)}, "
                         f"ids {tuple(ids.shape)}, weights "
                         f"{tuple(weights.shape)}, dw {tuple(dw.shape)}")
    probs, ids, weights, dw = (t.contiguous()
                               for t in (probs, ids, weights, dw))
    if dprobs is not None:
        dprobs = dprobs.contiguous()
    d_logits = torch.empty(T, E, dtype=torch.float32, device=dev)
    if T:
        err = _lib_bwd()(probs.data_ptr(), ids.data_ptr(), weights.data_ptr(),
                         dw.data_ptr(),
                         None if dprobs is None else dprobs.data_ptr(),
                         d_logits.data_ptr(), T, E, k, _build.stream(dev))
        _build.check(err, "moe_route_bwd")
        moe_route_bwd.launches += 1
    return d_logits


moe_route_bwd.launches = 0


def _f32_products() -> None:
    """The router's gradient products are f32 (XLA's einsum): refuse TF32."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("MoeRoute backward: TF32 matmuls are on; the "
                           "router's products must run in full f32")


class MoeRoute(torch.autograd.Function):
    """Routing with its gradient: the forward kernel with ``probs`` out, the
    backward kernel for ``d_logits``, then ``dx = d_logits @ router.T`` cast
    to x's type and ``d_router = x.float().T @ d_logits``, f32 products
    (``torch.matmul``; the step's deterministic mode fixes cuBLAS's).
    Returns ``(weights, ids, probs)``; ``ids`` carries no gradient and ``k``
    is not differentiable."""

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
        d_logits = moe_route_bwd(probs, ids, weights, dw.float(),
                                 None if dprobs is None else dprobs.float())
        _f32_products()
        dx = (d_logits @ router.float().t()).to(x.dtype) \
            if ctx.needs_input_grad[0] else None
        d_router = (x.float().t() @ d_logits).to(router.dtype) \
            if ctx.needs_input_grad[1] else None
        return dx, d_router, None
