"""RMSNorm: a CUDA C++ kernel for Hopper, its plain version, its launch
count.

The kernel (``csrc/rmsnorm.cu``, which carries the design note) replaces
``repro/kernels/rmsnorm.py::rmsnorm`` (``_rmsnorm_kernel``, the TPU kernel
that normalizes ``(256, d)`` row tiles held in VMEM): the mean of squares in
f32, ``rsqrt(mean + eps)``, the scale by ``w`` in f32, the cast back to
``x.dtype``, over any leading shape. A warp per row up to ``d = 256`` (the
qk-norm rows), a block per row above, chosen by ``d`` alone so that a row's
bits never depend on how many rows share the call. It is launched through
``ctypes`` like the other kernels: the serving path is host-bound, and this
kernel runs 145 times per qwen3-8b decode step.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm as plain  # noqa: F401  (beside the kernel)

_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the widest row: 1024 threads, 2 runs of 16 bytes each (csrc MAX_RUNS)
MAX_BYTES = 1024 * 2 * 16


@functools.cache
def _lib():
    lib = _build.load("rmsnorm")
    fn = lib.rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    empty = lib.empty_launch
    empty.argtypes = [ctypes.c_void_p]
    empty.restype = ctypes.c_int
    return fn, empty


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor: RMS-normalize the trailing dim of
    ``x`` (any leading shape) and scale by ``w``."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm kernel needs CUDA tensors on one device, "
                         f"got {x.device} and {w.device}")
    xtype, wtype = _TYPES.get(x.dtype), _TYPES.get(w.dtype)
    if xtype is None or wtype is None:
        raise TypeError(f"rmsnorm kernel: unsupported dtypes {x.dtype}, "
                        f"{w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm kernel: w {tuple(w.shape)} for d={d}")
    if d * x.element_size() > MAX_BYTES:
        raise ValueError(f"rmsnorm kernel: d={d} over {MAX_BYTES} bytes a row")
    x2 = x.reshape(-1, d).contiguous()
    out = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows and d:
        fn, _ = _lib()
        err = fn(x2.data_ptr(), w.contiguous().data_ptr(), out.data_ptr(),
                 rows, d, xtype, wtype, eps,
                 _build.stream(x.device))
        _build.check(err, "rmsnorm")
        rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0


def empty_launch(device: torch.device) -> None:
    """Launch an empty kernel (``csrc/rmsnorm.cu``) on the current stream:
    the floor under any launch, for timing. Not counted."""
    _, empty = _lib()
    _build.check(empty(_build.stream(device)),
                 "empty kernel")
