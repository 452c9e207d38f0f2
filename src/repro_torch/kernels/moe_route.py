"""Token-choice top-k routing: a CUDA C++ kernel for Hopper, its plain
version, its launch count.

The kernel (``csrc/moe_route.cu``, which carries the design note) has no
TPU counterpart: the JAX package routes in XLA (``repro/models/moe.py:
209-213``). It exists for the same reason as ``gemm_rows``: on the card a
token's routing must not depend on how many tokens share the call, or a
near tie between experts flips between an 8-lane decode step and a 40-lane
verify and greedy speculation stops equalling plain decode. One block routes
one token, with every summation order fixed by ``(d, E)``. It runs on every
path on the card: prefill, the dense engine, the paged decode step and the
verify folded into it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import moe_route as plain  # noqa: F401  (beside the kernel)

MAX_E, MAX_K, MAX_D = 256, 16, 8192   # csrc MAX_E, MAX_K, MAX_D


@functools.cache
def _lib():
    lib = _build.load("moe_route")
    fn = lib.moe_route_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def moe_route(x: torch.Tensor, router: torch.Tensor,
              k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: ``x (T, d)`` bf16, ``router (d, E)`` f32; returns
    ``weights (T, k)`` f32 and ``ids (T, k)`` int32, best first."""
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
    if T:
        err = _lib()(x.data_ptr(), router.data_ptr(), weights.data_ptr(),
                     ids.data_ptr(), T, d, E, k, _build.stream(x.device))
        _build.check(err, "moe_route")
        moe_route.launches += 1
    return weights, ids


moe_route.launches = 0
