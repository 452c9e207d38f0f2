"""Flash-decode attention over a dense cache: a CUDA C++ kernel for Hopper,
its plain version, its launch count.

The kernel (``csrc/decode_attention.cu`` over ``csrc/flash_decode.cuh``,
which carries the design note) replaces ``repro/kernels/decode_attention.py
::decode_attention``: one query token per lane against that lane's
``(S, K, D)`` cache, keys masked at ``lengths[b]``, f32 online softmax, GQA
as ``(K, G)`` groups, and zeros for a lane of length 0. The kernel is built
for head widths 64 and 128; at a narrower width (the REDUCED configs' 16, 24
and 32) ``_pad.run_padded`` zero-pads q and a copy of the cache to 64 for the
call and runs at the true width's scale.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _flash_decode, _pad
from repro_torch.kernels.ref import decode_attention as plain  # noqa: F401  (beside the kernel)

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                          ctypes.c_void_p]


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_bf16
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, dev) -> None:
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"decode_attention kernel: {name} must be a "
                         f"contiguous {dtype} tensor on {dev}, got "
                         f"{t.dtype} on {t.device}")
    if t.data_ptr() % (16 if dtype == torch.bfloat16 else 4):
        raise ValueError(f"decode_attention kernel: {name} is not aligned "
                         f"for its loads")


def decode_attention(
    q: torch.Tensor,        # (B, H, D) bf16
    k: torch.Tensor,        # (B, S, K, D) bf16
    v: torch.Tensor,        # (B, S, K, D) bf16
    lengths: torch.Tensor,  # (B,) int32
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns ``(B, H, D)`` bf16.
    D 64 and 128 run on the tensors as they are; a narrower D on padded
    copies of q, k and v (one per call)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention kernel needs CUDA, got {dev}")
    B, H, D = q.shape
    Bk, S, K, Dk = k.shape
    if (Bk != B or Dk != D or v.shape != k.shape or H % K or H // K > 8
            or D > _pad.WIDTHS[-1]):
        raise ValueError(
            f"decode_attention kernel: q {tuple(q.shape)}, k/v "
            f"{tuple(k.shape)}/{tuple(v.shape)} (need H % K == 0, "
            f"H/K <= 8 and D <= {_pad.WIDTHS[-1]})")
    if lengths.shape != (B,):
        raise ValueError("decode_attention kernel: lengths do not match the "
                         "batch")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, name, torch.bfloat16, dev)
    _check(lengths, "lengths", torch.int32, dev)
    return _pad.run_padded(_launch, q, k, v, lengths)


def _launch(q, k, v, lengths, *, scale: float):
    """The launch at a built width (64 or 128), softmax scale given."""
    B, H, D = q.shape
    _, S, K, _ = k.shape
    out = torch.empty_like(q)
    if B:
        part, cnt = _flash_decode.scratch(B, K, H // K, D, S, q.device)
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
                     cnt.data_ptr(), B, S, H, K, D,
                     scale, _build.stream(q.device))
        _build.check(err, "decode_attention")
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
