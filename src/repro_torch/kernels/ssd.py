"""Mamba2 SSD (chunked state-space duality): a CUDA C++ kernel for Hopper,
its plain version, its launch count.

The kernel (``csrc/ssd.cu``, which carries the design note) replaces
``repro/kernels/ssd.py::ssd``: per batch row and head, chunk by chunk, the
masked ``c x c`` product ``(C B^T * exp(l_i - l_j)) dt x`` plus the carried
``(P, N)`` state's contribution, then the state's update; ``B`` and ``C``
are shared by all heads (one group). Returns ``(y, hT)``. The plain version
(``ref.ssd``) follows the same chunking.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd as plain  # noqa: F401  (beside the kernel)

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _lib():
    lib = _build.load("ssd")
    fn = lib.ssd_bf16
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype,
           dev) -> torch.Tensor:
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
        raise ValueError(f"ssd kernel: {name} must be {dtype} {shape} on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.contiguous()


def ssd(
    x: torch.Tensor,    # (B, S, Hs, P) bf16
    dt: torch.Tensor,   # (B, S, Hs) bf16
    A: torch.Tensor,    # (Hs,) f32
    Bm: torch.Tensor,   # (B, S, N) bf16
    C: torch.Tensor,    # (B, S, N) bf16
    D: torch.Tensor,    # (Hs,) f32
    h0: torch.Tensor | None = None,  # (B, Hs, P, N) f32
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors; returns ``y`` (B, S, Hs, P) bf16
    and ``hT`` (B, Hs, P, N) f32."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd kernel needs CUDA, got {dev}")
    B, S, Hs, P = x.shape
    N = Bm.shape[-1]
    bf, f32 = torch.bfloat16, torch.float32
    x = _check(x, "x", (B, S, Hs, P), bf, dev)
    dt = _check(dt, "dt", (B, S, Hs), bf, dev)
    A = _check(A, "A", (Hs,), f32, dev)
    Bm = _check(Bm, "Bm", (B, S, N), bf, dev)
    C = _check(C, "C", (B, S, N), bf, dev)
    D = _check(D, "D", (Hs,), f32, dev)
    if h0 is None:
        h0 = torch.zeros(B, Hs, P, N, dtype=f32, device=dev)
    h0 = _check(h0, "h0", (B, Hs, P, N), f32, dev)
    c = max(1, min(chunk, S))
    y = torch.empty_like(x)
    hT = torch.empty_like(h0)
    if B and Hs and P:
        # a chunk whose tiles do not fit in shared memory (c = 256 takes up
        # to N = 86) is refused by the launch, and raises here
        err = _lib()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 C.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
                 hT.data_ptr(), B, S, Hs, P, N, c,
                 torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "ssd")
        ssd.launches += 1
    return y, hT


ssd.launches = 0
