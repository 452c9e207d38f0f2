"""Row-invariant matrix product: a CUDA C++ kernel for Hopper, its plain
version, its launch count, and the shapes of a decode step's products.

The kernel (``csrc/gemm_rows.cu``, which carries the design note) has no
TPU counterpart: the JAX package leaves these products to XLA. It exists to
keep the reference's guarantee that greedy speculative decoding equals plain
decoding. The verify folds its ``B·W`` window lanes into the paged decode
step (``models/transformer.py``), so a lane's arithmetic must not change
with the number of rows in the call; cuBLAS, which picks its kernel from
the row count, breaks that on the H100 (the first 8 rows of a 40-row 4096 x
1024 product differ from an 8-row product). Here a row's bits depend only on
that row and the weights: no split-K, one fixed order over K.

It is chosen by entry point, never by row count: ``decode_paged_fn`` (and
so the verify) passes it down as ``mm``; prefill, the dense engine and the
SSM families keep ``torch.matmul``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import _build
from repro_torch.kernels.ref import gemm_rows as plain  # noqa: F401  (beside the kernel)


@functools.cache
def _lib():
    fn = _build.load("gemm_rows").gemm_rows_bf16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gemm_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``x (..., K) @ w (K, N)`` in bf16 with f32 sums.
    ``w`` is contiguous, or the transpose of a contiguous ``(N, K)`` tensor
    (a tied embedding's ``embedding.t()``)."""
    dev = x.device
    if dev.type != "cuda" or w.device != dev:
        raise ValueError(f"gemm_rows kernel needs CUDA tensors on one "
                         f"device, got {x.device} and {w.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"gemm_rows kernel: bf16 operands, got {x.dtype}, "
                        f"{w.dtype}")
    if w.ndim != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"gemm_rows kernel: x {tuple(x.shape)} @ w "
                         f"{tuple(w.shape)}")
    K, N = w.shape
    if w.is_contiguous():
        nk = 0
    elif w.t().is_contiguous():
        nk = 1
    else:
        raise ValueError("gemm_rows kernel: w must be contiguous or the "
                         "transpose of a contiguous tensor")
    if K % 8 or N % 8:
        raise ValueError(f"gemm_rows kernel: K {K} and N {N} must be "
                         f"multiples of 8 (16-byte rows)")
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    for t, name in ((x2, "x"), (w, "w"), (out, "out")):
        if t.data_ptr() % 16:
            raise ValueError(f"gemm_rows kernel: {name} is not 16-byte "
                             f"aligned")
    if M:
        err = _lib()(x2.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
                     nk, _build.stream(dev))
        _build.check(err, "gemm_rows")
        gemm_rows.launches += 1
    return out.reshape(*x.shape[:-1], N)


gemm_rows.launches = 0


def decode_products(cfg: ModelConfig) -> list[tuple[str, int, int, bool]]:
    """``(name, K, N, nk)`` of each matrix product that one decode step of
    a dense config runs per layer (q, k, v, o, the MLP's three) and once
    (the unembedding; ``nk`` where it is the tied embedding's transpose)."""
    d, dh = cfg.d_model, cfg.d_head
    return [("q", d, cfg.n_heads * dh, False),
            ("k", d, cfg.n_kv_heads * dh, False),
            ("v", d, cfg.n_kv_heads * dh, False),
            ("o", cfg.n_heads * dh, d, False),
            ("gate", d, cfg.d_ff, False), ("up", d, cfg.d_ff, False),
            ("down", cfg.d_ff, d, False),
            ("unembed", d, cfg.vocab_size, cfg.tie_embeddings)]
