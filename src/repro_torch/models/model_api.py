"""Model protocol and the parameter-spec system of the port.

As in the JAX package (``repro/models/model_api.py``), every family builds a
nested dict of :class:`PSpec` (shape, logical axes, initializer), and
initialization is derived from that one structure, with the same fan-in rule
(``model_api.py:43-57``): ``normal(0, 1/sqrt(fan_in))`` with fan-in over
every axis but the last, excluding a leading ``layers`` axis.

Storage: a matrix (two or more axes besides ``layers``) is stored in bf16,
because the reference keeps f32 masters but casts every matrix to bf16
before use (``repro/models/layers.py:21-25``), so the arithmetic is the
same. Vectors (norm weights) stay f32, as the reference's RMSNorm reads its
weight in f32 (``repro/kernels/ref.py:31``).

A family's ``build`` turns the nested tree (layer-stacked leaves
``(L, ...)``, the reference's layout) into its ``nn.Module``, holding one
module per layer; initialization and the weight bridge both go through it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.config import ModelConfig

Tree = dict[str, Any]


@dataclass(frozen=True)
class PSpec:
    """Declarative parameter spec."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "fan_in"  # fan_in | zeros | ones | normal

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    @property
    def stacked(self) -> bool:
        return bool(self.axes) and self.axes[0] == "layers"

    @property
    def is_matrix(self) -> bool:
        return len(self.shape) - int(self.stacked) >= 2

    def fan_in(self) -> int:
        """The reference's fan-in: all axes but the last, without a leading
        ``layers`` axis."""
        if len(self.shape) == 1:
            return max(1, self.shape[0])
        if self.stacked and len(self.shape) > 2:
            return max(1, math.prod(self.shape[1:-1]))
        return max(1, math.prod(self.shape[:-1]))


def storage_dtype(spec: PSpec) -> torch.dtype:
    return torch.bfloat16 if spec.is_matrix else torch.float32


def _materialize(spec: PSpec, gen: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    dtype = storage_dtype(spec)
    if spec.init in ("zeros", "ones"):
        fill = 0.0 if spec.init == "zeros" else 1.0
        return torch.full(spec.shape, fill, dtype=dtype, device=device)
    scale = 0.02 if spec.init == "normal" else spec.fan_in() ** -0.5
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    # one layer at a time: the f32 draw of a whole stacked leaf would need
    # twice the memory of the bf16 weights it becomes
    for dst in (out if spec.stacked else [out]):
        dst.copy_(torch.randn(dst.shape, generator=gen, device=device,
                              dtype=torch.float32) * scale)
    return out


def _is_leaf(x) -> bool:
    return isinstance(x, PSpec)


def tree_map(fn, tree):
    if _is_leaf(tree) or not isinstance(tree, dict):
        return fn(tree)
    return {k: tree_map(fn, v) for k, v in tree.items()}


class Params(nn.Module):
    """A flat group of named weights (one attention block, one MLP, ...)."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))


@dataclass
class ModelFns:
    """One architecture: its specs and its serving entry points.

    The paged entry points update the page pools of ``cache`` in place and
    return only the logits:

    - ``paged_cache_specs(n_slots, n_pages, page_size)`` -> dict of PSpec;
    - ``prefill_chunk(params, cache, batch, *, offset)`` — one prompt chunk
      at absolute position ``offset``; batch carries ``tokens (1, C)``,
      ``valid`` (int) and ``page_table (max_pages,)``; returns the logits
      of the last valid token ``(1, V)``;
    - ``decode_paged(params, cache, batch)`` — one batched token step;
      batch carries ``tokens (B, 1)``, ``positions (B,)`` and
      ``page_table (B, max_pages)``; returns ``(B, V)`` logits.
    """

    cfg: ModelConfig
    param_specs: Tree
    build: Callable[[Tree], nn.Module]
    paged_cache_specs: Callable[..., Tree]
    prefill_chunk: Callable[..., torch.Tensor]
    decode_paged: Callable[..., torch.Tensor]

    def init(self, generator: torch.Generator | int = 0,
             device: str | torch.device = "cuda") -> nn.Module:
        """Seeded weights drawn on ``device`` with the reference's fan-in
        rule (the draws themselves differ from ``jax.random``'s)."""
        dev = resolve_device(device)
        gen = generator
        if isinstance(generator, int):
            gen = torch.Generator(device=dev).manual_seed(generator)
        tree = tree_map(lambda s: _materialize(s, gen, dev), self.param_specs)
        return self.build(tree)

    def init_paged_cache(self, n_slots: int, n_pages: int, page_size: int,
                         dtype: torch.dtype = torch.bfloat16,
                         device: str | torch.device = "cuda") -> Tree:
        dev = resolve_device(device)
        specs = self.paged_cache_specs(n_slots, n_pages, page_size)
        return {k: torch.zeros(s.shape, dtype=_cache_dtype(s, dtype),
                               device=dev) for k, s in specs.items()}


def _cache_dtype(spec: PSpec, dtype: torch.dtype) -> torch.dtype:
    """The reference's cache-dtype rule (``model_api.py:261-268``): int32
    bookkeeping leaves, f32 recurrent state, else ``dtype``."""
    if spec.axes and spec.axes[-1] == "null_i32":
        return torch.int32
    if "state" in (spec.axes or ()):
        return torch.float32
    return dtype
