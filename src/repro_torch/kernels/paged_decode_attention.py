"""Paged flash-decode attention: a CUDA C++ kernel for Hopper, its plain
version, its launch count.

The kernel (``csrc/paged_decode_attention.cu``, which carries the design
note) replaces ``repro/kernels/paged_decode_attention.py::
paged_decode_attention``: one query token per lane against that lane's
pages of the shared pool, reached through ``page_table[b, :]``, keys masked
at ``lengths[b]``, f32 online softmax, GQA as ``(K, G)`` groups, and zeros
for a lane of length 0.

The kernel is built for head widths 64 and 128, and at those widths the
wrapper hands it the page pool as it is: no copy, no extra launch. At a
narrower width (the REDUCED configs' 16, 24 and 32) ``_pad.run_padded``
zero-pads q and a copy of the whole pool to 64 for each call and runs at the
true width's scale. That copy is acceptable only because such pools are
small; the pool's own layout (which snapshots carry across packages) never
changes.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _flash_decode, _pad
from repro_torch.kernels.ref import paged_decode_attention as plain  # noqa: F401

# the most query heads a kv head's block takes (the rows of its mma tile
# that csrc/flash_decode.cuh fills)
MAX_GROUP = 8

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                          ctypes.c_void_p]


def _lib():
    lib = _build.load("paged_decode_attention")
    fn = lib.paged_decode_attention_bf16
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, dev) -> None:
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"paged_decode_attention kernel: {name} must be a "
                         f"contiguous {dtype} tensor on {dev}, got "
                         f"{t.dtype} on {t.device}")
    if t.data_ptr() % (16 if dtype == torch.bfloat16 else 4):
        raise ValueError(f"paged_decode_attention kernel: {name} is not "
                         f"aligned for its loads")


def paged_decode_attention(
    q: torch.Tensor,           # (B, H, D) bf16
    k_pages: torch.Tensor,     # (n_pages, P, K, D) bf16
    v_pages: torch.Tensor,     # (n_pages, P, K, D) bf16
    page_table: torch.Tensor,  # (B, max_pages) int32
    lengths: torch.Tensor,     # (B,) int32
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns ``(B, H, D)`` bf16."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attention kernel needs CUDA, got {dev}")
    B, H, D = q.shape
    n_pages, P, K, Dk = k_pages.shape
    if (Dk != D or v_pages.shape != k_pages.shape or H % K
            or H // K > MAX_GROUP or D > _pad.WIDTHS[-1]):
        raise ValueError(
            f"paged_decode_attention kernel: q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} (need H % K == 0, "
            f"H/K <= {MAX_GROUP} and D <= {_pad.WIDTHS[-1]})")
    if page_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError("paged_decode_attention kernel: page_table/lengths "
                         "do not match the batch")
    for t, name in ((q, "q"), (k_pages, "k_pages"), (v_pages, "v_pages")):
        _check(t, name, torch.bfloat16, dev)
    for t, name in ((page_table, "page_table"), (lengths, "lengths")):
        _check(t, name, torch.int32, dev)
    return _pad.run_padded(_launch, q, k_pages, v_pages, page_table, lengths)


def _launch(q, k_pages, v_pages, page_table, lengths, *, scale: float):
    """The launch at a built width (64 or 128), softmax scale given."""
    B, H, D = q.shape
    _, P, K, _ = k_pages.shape
    out = torch.empty_like(q)
    if B:
        part, cnt = _flash_decode.scratch(B, K, H // K, D,
                                          page_table.shape[1] * P, q.device)
        err = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                     part.data_ptr(), cnt.data_ptr(),
                     B, H, K, D, P, page_table.shape[1], scale,
                     _build.stream(q.device))
        _build.check(err, "paged_decode_attention")
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
