"""Distributed-optimization helpers: gradient compression.

Ported from ``repro/parallel/collectives.py``. ``compress_grads`` models
stochastic-rounding int8 quantization of gradients (per-tensor absmax
scale) as quantize→dequantize around the gradient reduction, so the
numerics of the compressed collective show in training quality.

The reference draws its rounding noise inside ``_quantize_int8`` from a
``jax.random`` key. Here the two halves are apart: :func:`int8_noise` draws
``uniform[0, 1) - 0.5`` of a leaf's shape from a ``torch.Generator``, and
:func:`quantize_int8` rounds ``g`` given that noise, so a test can feed
the reference's own noise and compare exactly. The port's generator does
not give ``jax.random``'s bits.
"""

from __future__ import annotations

import torch

from repro_torch.models.model_api import Tree, tree_leaves, tree_map


def int8_noise(shape, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """Stochastic-rounding noise of ``shape``: uniform in [-0.5, 0.5), f32."""
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32) - 0.5


def quantize_int8(g: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``g`` quantized to int8 with stochastic rounding by ``noise`` and
    dequantized (``repro/parallel/collectives.py:19-26``), f32."""
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale + noise), -127, 127).to(torch.int8)
    return q.float() * scale


def compress_grads(grads: Tree, generator: torch.Generator | None,
                   mode: str) -> Tree:
    """Apply gradient compression. mode: "none" | "int8" (noise for each
    leaf drawn from ``generator`` in tree order)."""
    if mode == "none":
        return grads
    if mode != "int8":
        raise ValueError(f"unknown compression mode {mode!r}")
    noise = {id(g): int8_noise(g.shape, generator, g.device)
             for g in tree_leaves(grads)}
    return tree_map(lambda g: quantize_int8(g, noise[id(g)]), grads)
