"""Causal GQA flash attention: a CUDA C++ kernel for Hopper, its plain
version, its launch count.

The kernel (``csrc/flash_attention.cu``, which carries the design note)
replaces ``repro/kernels/flash_attention.py::flash_attention``: causal or
non-causal GQA attention of ``(B, Sq, H, D)`` queries over ``(B, Sk, K, D)``
keys with ``q_offset``, kv head ``h // (H/K)``, tiles above the diagonal
skipped and keys past ``Sk`` masked.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention as plain  # noqa: F401  (beside the kernel)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                          ctypes.c_void_p]


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_bf16
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D) bf16
    k: torch.Tensor,  # (B, Sk, K, D) bf16
    v: torch.Tensor,  # (B, Sk, K, D) bf16
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns ``(B, Sq, H, D)`` bf16."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA, got {dev}")
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    if (k.shape[0] != B or k.shape[3] != D or v.shape != k.shape or H % K
            or D not in (64, 128)):
        raise ValueError(
            f"flash_attention kernel: q {tuple(q.shape)}, k {tuple(k.shape)},"
            f" v {tuple(v.shape)} (need H % K == 0 and D in (64, 128))")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != dev or t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention kernel: {name} must be bf16 on "
                             f"{dev}, got {t.dtype} on {t.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel: inputs are not 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if B and Sq:
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B, Sq, Sk, H, K, D, int(causal), int(q_offset),
                     D ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "flash_attention")
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
