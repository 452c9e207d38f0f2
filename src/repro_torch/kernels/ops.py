"""Kernel dispatch for the serving path.

A tensor on the CPU goes to the plain PyTorch version (``ref.py``). A CUDA
tensor launches the hand-written kernel, and a kernel that refuses its input
raises: nothing falls back. ``use_backend("plain")`` is an explicit, scoped
override that sends CUDA tensors to the plain versions too, mirroring the JAX
package's ``use_backend`` (``repro/kernels/ops.py:53-61``); only tests and
the comparison phase of ``chip_smoke.py`` enter it, never the engine or the
CLI.

Each kernel wrapper counts its own launches (``<wrapper>.launches``); this
module counts the calls that went to a plain version, so a run can show
which path it took.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm

_BACKENDS = ("kernel", "plain")
_BACKEND: contextvars.ContextVar[str] = contextvars.ContextVar(
    "repro_torch_kernel_backend", default="kernel"
)

KERNELS = {
    "rmsnorm": _rmsnorm.rmsnorm,
    "paged_decode_attention": _paged.paged_decode_attention,
    "flash_attention": _flash.flash_attention,
}
plain_calls = {name: 0 for name in KERNELS}


@contextlib.contextmanager
def use_backend(name: str):
    """Scoped backend choice: "kernel" (the default) or "plain"."""
    if name not in _BACKENDS:
        raise ValueError(f"backend {name!r}: expected one of {_BACKENDS}")
    tok = _BACKEND.set(name)
    try:
        yield
    finally:
        _BACKEND.reset(tok)


def counts() -> dict[str, dict[str, int]]:
    """Kernel launches and plain-version calls so far, per kernel."""
    return {name: {"launches": fn.launches, "plain": plain_calls[name]}
            for name, fn in KERNELS.items()}


def reset_counts() -> None:
    for name, fn in KERNELS.items():
        fn.launches = 0
        plain_calls[name] = 0


def _plain(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu" or _BACKEND.get() == "plain":
        plain_calls[name] += 1
        return True
    return False


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    if _plain(x, "rmsnorm"):
        return ref.rmsnorm(x, w, eps)
    return _rmsnorm.rmsnorm(x, w, eps)


def attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, K, D)
    v: torch.Tensor,  # (B, Sk, K, D)
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    if _plain(q, "flash_attention"):
        return ref.attention(q, k, v, causal=causal, q_offset=q_offset)
    return _flash.flash_attention(q, k, v, causal=causal, q_offset=q_offset)


def paged_decode_attention(
    q: torch.Tensor,           # (B, H, D)
    k_pages: torch.Tensor,     # (n_pages, P, K, D)
    v_pages: torch.Tensor,     # (n_pages, P, K, D)
    page_table: torch.Tensor,  # (B, max_pages) int32
    lengths: torch.Tensor,     # (B,) int32
) -> torch.Tensor:
    if _plain(q, "paged_decode_attention"):
        return ref.paged_decode_attention(q, k_pages, v_pages, page_table,
                                          lengths)
    return _paged.paged_decode_attention(q, k_pages, v_pages, page_table,
                                         lengths)
