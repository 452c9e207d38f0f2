"""Causal GQA flash attention: a CUDA C++ kernel for Hopper, its plain
version, its launch count.

The kernel (``csrc/flash_attention.cu``, which carries the design note)
replaces ``repro/kernels/flash_attention.py::flash_attention``: causal or
non-causal GQA attention of ``(B, Sq, H, D)`` queries over ``(B, Sk, K, D)``
keys with ``q_offset``, kv head ``h // (H/K)``, tiles above the diagonal
skipped and keys past ``Sk`` masked. The kernel is built for head widths 64
and 128; narrower heads (the REDUCED configs' 16, 24 and 32) are zero-padded
to 64 by ``_pad.run_padded`` and run at the true width's scale.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _pad
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
    """Launch the kernel on CUDA tensors; returns ``(B, Sq, H, D)`` bf16.
    D 64 and 128 run as they are; a narrower D runs zero-padded to 64."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA, got {dev}")
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    if (k.shape[0] != B or k.shape[3] != D or v.shape != k.shape or H % K
            or D > _pad.WIDTHS[-1]):
        raise ValueError(
            f"flash_attention kernel: q {tuple(q.shape)}, k {tuple(k.shape)},"
            f" v {tuple(v.shape)} (need H % K == 0 and D <= "
            f"{_pad.WIDTHS[-1]})")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != dev or t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention kernel: {name} must be bf16 on "
                             f"{dev}, got {t.dtype} on {t.device}")
    return _pad.run_padded(_launch, q, k, v, causal=causal, q_offset=q_offset)


def _launch(q, k, v, *, scale: float, causal: bool, q_offset: int):
    """The launch at a built width (64 or 128), softmax scale given."""
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel: inputs are not 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if B and Sq:
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B, Sq, Sk, H, K, D, int(causal), int(q_offset),
                     scale, _build.stream(q.device))
        _build.check(err, "flash_attention")
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
