"""Head widths the attention kernels are not built for, by zero padding.

The flash, dense-decode and paged-decode kernels are instantiated for head
widths 64 and 128 only (``csrc/flash_attention.cu``, ``csrc/flash_decode.cuh``).
The REDUCED configs use narrower heads (qwen3-8b 24, smollm-360m and
zamba2-1.2b 16). :func:`run_padded` zero-pads q, k and v along the head
dimension up to the nearest built width and slices the output back:

- the padded products of q and k are exact zeros, so every score keeps its
  bits;
- the padded columns of v give padded output columns, which are dropped;
- the softmax scale is the true width's ``D ** -0.5``, passed explicitly,
  never the padded tensor's.

At a built width the tensors go through untouched: no copy, no extra launch.
The helper is plain PyTorch around any attention function that takes
``scale=``, so the CPU tests run it around the plain versions.
"""

from __future__ import annotations

import torch

WIDTHS = (64, 128)  # the head widths the CUDA kernels are built for


def width(d: int) -> int:
    """The built width a head of ``d`` runs at: the smallest of
    :data:`WIDTHS` not below it."""
    for w in WIDTHS:
        if d <= w:
            return w
    raise ValueError(f"head width {d}: the attention kernels take at most "
                     f"{WIDTHS[-1]}")


def pad(t: torch.Tensor, w: int) -> torch.Tensor:
    """``t`` zero-padded along its last dim to ``w`` (``t`` itself at
    ``w``)."""
    d = t.shape[-1]
    return t if d == w else torch.nn.functional.pad(t, (0, w - d))


def run_padded(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               *args, **kw) -> torch.Tensor:
    """``fn(q, k, v, *args, scale=D ** -0.5, **kw)`` with q, k and v padded
    along their last dim to the built width of ``D = q.shape[-1]``, and the
    result sliced back to ``D``."""
    d = q.shape[-1]
    w = width(d)
    out = fn(pad(q, w), pad(k, w), pad(v, w), *args, scale=d ** -0.5, **kw)
    return out if w == d else out[..., :d].contiguous()
