"""Mamba1 selective scan: a CUDA C++ kernel for Hopper, its plain version,
its launch count.

The kernel (``csrc/selective_scan.cu``, which carries the design note)
replaces ``repro/kernels/selective_scan.py::selective_scan``: the
recurrence ``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t``,
``y_t = h_t C_t + D x_t`` over ``(B, S, Di)`` inputs with ``(Di, N)``
state per batch row, from ``h0``; returns ``(y, hT)``. It scans each
256-step tile in parallel over a half-warp's lanes, one channel a
half-warp (16 steps a lane, each lane's decay product ``P`` formed as exp2
of its dt sum, a 4-round shuffle scan across the lanes), and carries the
state from tile to tile, so one
call equals chained calls cut at multiples of 256, bit for bit; the
reference's ``chunk`` blocking has no counterpart here. The plain version
(``ref.selective_scan``) walks the steps in order.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import selective_scan as plain  # noqa: F401  (beside the kernel)

STATES = (4, 8, 16, 32, 64)   # the state sizes the kernel is built for
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _lib():
    lib = _build.load("selective_scan")
    fn = lib.selective_scan_bf16
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype,
           dev) -> torch.Tensor:
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
        raise ValueError(f"selective_scan kernel: {name} must be {dtype} "
                         f"{shape} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.contiguous()


def selective_scan(
    x: torch.Tensor,    # (B, S, Di) bf16
    dt: torch.Tensor,   # (B, S, Di) bf16
    A: torch.Tensor,    # (Di, N) f32
    Bm: torch.Tensor,   # (B, S, N) bf16
    C: torch.Tensor,    # (B, S, N) bf16
    D: torch.Tensor,    # (Di,) f32
    h0: torch.Tensor | None = None,  # (B, Di, N) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors; returns ``y`` (B, S, Di) bf16 and
    ``hT`` (B, Di, N) f32."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"selective_scan kernel needs CUDA, got {dev}")
    B, S, Di = x.shape
    N = A.shape[-1]
    if N not in STATES:
        raise ValueError(f"selective_scan kernel: state size {N} not in "
                         f"{STATES}")
    bf, f32 = torch.bfloat16, torch.float32
    x = _check(x, "x", (B, S, Di), bf, dev)
    dt = _check(dt, "dt", (B, S, Di), bf, dev)
    A = _check(A, "A", (Di, N), f32, dev)
    Bm = _check(Bm, "Bm", (B, S, N), bf, dev)
    C = _check(C, "C", (B, S, N), bf, dev)
    D = _check(D, "D", (Di,), f32, dev)
    # B and C are read as bf16 pairs: 4-byte aligned
    Bm, C = (t if t.data_ptr() % 4 == 0 else t.clone() for t in (Bm, C))
    if h0 is None:
        h0 = torch.zeros(B, Di, N, dtype=f32, device=dev)
    h0 = _check(h0, "h0", (B, Di, N), f32, dev)
    y = torch.empty_like(x)
    hT = torch.empty_like(h0)
    if B and Di:
        # 16-byte staging of x and dt and 16-byte stores of y, else scalar
        vec = Di % 8 == 0 and not any(t.data_ptr() % 16 for t in (x, dt, y))
        err = _lib()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                     C.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
                     hT.data_ptr(), B, S, Di, N, int(vec),
                     _build.stream(dev))
        _build.check(err, "selective_scan")
        selective_scan.launches += 1
    return y, hT


selective_scan.launches = 0
