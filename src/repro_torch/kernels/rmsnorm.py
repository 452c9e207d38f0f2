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

Training needs the gradient: :class:`RMSNorm` is the
``torch.autograd.Function`` whose forward is this kernel and whose backward
is the hand-written backward of ``csrc/rmsnorm.cu`` (:func:`rmsnorm_bwd`):
per row in f32, ``r = rsqrt(mean(x²) + eps)``, ``x̂ = x·r``, ``dx = r·(g·w −
x̂·mean(g·w·x̂))`` cast to x's type; ``dw`` as f32 partial rows, one a block
over its fixed run of rows (:func:`chunk_rows`), then a second launch that
sums them in a fixed order: no atomics, the same bits every run, and no
fill of ``dw`` (the second launch writes every column). A backward call
(two launches) counts one in ``rmsnorm_bwd.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._cost import Cost, record
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
    bwd = lib.rmsnorm_bwd
    bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return fn, empty, bwd


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor: RMS-normalize the trailing dim of
    ``x`` (any leading shape) and scale by ``w``."""
    if x.device.type not in _build.DEVICES or w.device != x.device:
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
    if rows and d and x.is_meta:
        record("rmsnorm", cost(rows, d, x.element_size(), w.element_size()))
    elif rows and d:
        fn, _, _ = _lib()
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
    _, empty, _ = _lib()
    _build.check(empty(_build.stream(device)),
                 "empty kernel")


def cost(rows: int, d: int, x_bytes: int = 2, w_bytes: int = 4) -> Cost:
    """One call over ``rows`` rows of ``d``: x read and the output written
    (``x_bytes`` each), w read; its few operations a row count for
    nothing."""
    return Cost(0, 2 * rows * d * x_bytes + d * w_bytes, unit="f32")


MIN_CHUNK, MAX_RUNS_BWD = 32, 256


def chunk_rows(rows: int) -> int:
    """Rows of one block's run (one dw partial row): at least
    ``MIN_CHUNK``, and at most ``MAX_RUNS_BWD`` runs a call, so that the
    partial rows stay a small share of the bytes and one wave fills the
    card."""
    return max(MIN_CHUNK, -(-rows // MAX_RUNS_BWD))


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel on CUDA tensors: ``(dx, dw)`` of
    ``rmsnorm(x, w, eps)`` for the output's gradient ``g`` (x's shape and
    type): dx of x's shape and type, dw f32 of w's shape."""
    if x.device.type not in _build.DEVICES or w.device != x.device \
            or g.device != x.device:
        raise ValueError(f"rmsnorm_bwd kernel needs CUDA tensors on one "
                         f"device, got {x.device}, {w.device}, {g.device}")
    xtype, wtype = _TYPES.get(x.dtype), _TYPES.get(w.dtype)
    if xtype is None or wtype is None or g.dtype != x.dtype:
        raise TypeError(f"rmsnorm_bwd kernel: unsupported dtypes {x.dtype}, "
                        f"{w.dtype}, g {g.dtype}")
    d = x.shape[-1]
    if w.shape != (d,) or g.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd kernel: w {tuple(w.shape)}, g "
                         f"{tuple(g.shape)} for x {tuple(x.shape)}")
    if d * 4 > MAX_BYTES:
        raise ValueError(f"rmsnorm_bwd kernel: d={d} over {MAX_BYTES // 4}")
    x2 = x.reshape(-1, d).contiguous()
    g2 = g.reshape(-1, d).contiguous()
    rows = x2.shape[0]
    dx = torch.empty_like(x2)
    if not (rows and d):   # no rows: a zero gradient, no launch
        return dx.reshape(x.shape), torch.zeros(d, dtype=torch.float32,
                                                device=x.device)
    dw = torch.empty(d, dtype=torch.float32, device=x.device)  # all written
    chunk = chunk_rows(rows)
    part = torch.empty((-(-rows // chunk), d), dtype=torch.float32,
                       device=x.device)
    if x.is_meta:
        record("rmsnorm_bwd", bwd_cost(rows, d, x.element_size(),
                                       w.element_size()))
        return dx.reshape(x.shape), dw
    _, _, bwd = _lib()
    err = bwd(x2.data_ptr(), w.contiguous().data_ptr(), g2.data_ptr(),
              dx.data_ptr(), part.data_ptr(), dw.data_ptr(), rows, d,
              xtype, wtype, eps, chunk, _build.stream(x.device))
    _build.check(err, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    return dx.reshape(x.shape), dw


rmsnorm_bwd.launches = 0


def bwd_cost(rows: int, d: int, x_bytes: int = 2, w_bytes: int = 4) -> Cost:
    """One backward call (two launches): x and g read and dx written
    (``x_bytes`` each), w read and dw written (``w_bytes`` each); the
    partial rows stay in L2 and count nothing."""
    return Cost(0, 3 * rows * d * x_bytes + 2 * d * w_bytes, unit="f32",
                launches=2)


class RMSNorm(torch.autograd.Function):
    """RMSNorm with its gradient: the forward kernel, the backward kernel.
    Non-differentiable ``eps``."""

    @staticmethod
    def forward(ctx, x, w, eps: float):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, g.to(x.dtype), ctx.eps)
        return dx, (dw.to(w.dtype) if ctx.needs_input_grad[1] else None), None
