"""RMSNorm: a Triton kernel for Hopper, its plain version, its launch count.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm`` (``_rmsnorm_kernel``, the TPU
kernel that normalizes ``(256, d)`` row tiles held in VMEM).

What bounds it on this card: bytes. The work is one read and one write of
``x`` with a per-row f32 reduction, a few FLOP per byte: the bound is
``2 * rows * d * itemsize`` bytes over 3.35 TB/s.

Design: one program per row, ``BLOCK_D = next_power_of_2(d)`` (4096 for the
block norms, 128 for qk-norm), a masked block load, f32 ``tl.sum`` and
``tl.rsqrt``, the scale by ``w`` in f32 and a cast back to ``x.dtype`` on the
store — the reference's arithmetic in one pass over the row. No tensor cores
and no shared-memory layout to control, which is why this kernel is Triton.
``triton`` is imported when the kernel is first launched, never at import.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.ref import rmsnorm as plain  # noqa: F401  (beside the kernel)


@functools.cache
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, w_ptr, o_ptr, d, eps, BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < d
        x = tl.load(x_ptr + row * d + cols, mask=mask, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / d
        y = x * tl.rsqrt(var + eps)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        tl.store(o_ptr + row * d + cols, (y * w).to(o_ptr.dtype.element_ty),
                 mask=mask)

    return triton, rmsnorm_kernel


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor: RMS-normalize the trailing dim of
    ``x`` (any leading shape) and scale by ``w``."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm kernel needs CUDA tensors on one device, "
                         f"got {x.device} and {w.device}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"rmsnorm kernel: unsupported dtype {x.dtype}")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm kernel: w {tuple(w.shape)} for d={d}")
    triton, kernel = _kernel()
    x2 = x.reshape(-1, d).contiguous()
    out = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows:
        block = triton.next_power_of_2(d)
        kernel[(rows,)](x2, w.contiguous(), out, d, eps, BLOCK_D=block,
                        num_warps=max(1, min(8, block // 256)))
        rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0
