"""Model protocol and the parameter-spec system of the port.

As in the JAX package (``repro/models/model_api.py``), every family builds a
nested dict of :class:`PSpec` (shape, logical axes, initializer), and
initialization is derived from that one structure, with the same fan-in rule
(``model_api.py:43-57``): ``normal(0, 1/sqrt(fan_in))`` with fan-in over
every axis but the last, excluding a leading ``layers`` axis.

Storage: a leaf is stored in bf16 exactly where the reference casts it to
bf16 before every use (``ll.cast``, ``repro/models/layers.py:21-25``) —
the spec says so with ``cast=True`` — so the arithmetic is the same.
Every other leaf stays f32, as the reference reads it from its f32 master:
norm weights (``repro/kernels/ref.py:31``), the SSM families' ``A_log``
(``repro/models/mamba.py:76``, ``hybrid.py:97``), ``conv_w``
(``repro/kernels/ops.py:395-402``) and their vectors.

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
    init: str = "fan_in"  # fan_in | zeros | ones | normal | small
    cast: bool = False    # the reference casts it to bf16 before every use

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    @property
    def stacked(self) -> bool:
        return bool(self.axes) and self.axes[0] == "layers"

    def fan_in(self) -> int:
        """The reference's fan-in: all axes but the last, without a leading
        ``layers`` axis."""
        if len(self.shape) == 1:
            return max(1, self.shape[0])
        if self.stacked and len(self.shape) > 2:
            return max(1, math.prod(self.shape[1:-1]))
        return max(1, math.prod(self.shape[:-1]))


def storage_dtype(spec: PSpec) -> torch.dtype:
    return torch.bfloat16 if spec.cast else torch.float32


def _init_scale(spec: PSpec) -> float:
    """The reference's draw scale per init rule (``model_api.py:43-57``)."""
    if spec.init == "normal":
        return 0.02
    if spec.init == "small":
        return 1e-4
    if spec.init == "fan_in":
        return spec.fan_in() ** -0.5
    raise ValueError(f"unknown init {spec.init!r} for spec {spec.shape}")


def _materialize(spec: PSpec, gen: torch.Generator,
                 device: torch.device,
                 dtype: torch.dtype | None = None) -> torch.Tensor:
    dtype = dtype or storage_dtype(spec)
    if spec.init in ("zeros", "ones"):
        fill = 0.0 if spec.init == "zeros" else 1.0
        return torch.full(spec.shape, fill, dtype=dtype, device=device)
    scale = _init_scale(spec)
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


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in ``jax.tree``'s order for dicts:
    sorted keys, depth first."""
    if _is_leaf(tree) or not isinstance(tree, dict):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]


class Params(nn.Module):
    """A flat group of named weights (one attention block, one MLP, ...)."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))


@dataclass
class ModelFns:
    """One architecture: its specs and its serving entry points.

    The dense entry points (the engine's ``paged=False`` path,
    ``repro/models/model_api.py:97-110``):

    - ``cache_specs(batch, max_seq)`` -> dict of PSpec, every leaf laid
      out ``(layers, batch, ...)``: attention K/V ``(L, B, max_seq, K,
      dh)``, recurrent state ``(L, B, ...)``;
    - ``prefill(params, batch)`` — the whole prompt ``tokens (1, S)`` from
      position 0; returns ``(logits of the last position (1, V), a batch-1
      cache)`` whose sequence leaves are S long;
    - ``decode_step(params, cache, batch)`` — one batched token step over
      every lane; batch carries ``tokens (B, 1)`` and ``positions (B,)``;
      updates ``cache`` in place and returns ``(B, V)`` logits.

    The paged entry points update ``cache`` in place and return only the
    logits:

    - ``paged_cache_specs(n_slots, n_pages, page_size)`` -> dict of PSpec:
      sequence-indexed leaves are shared page pools named ``*_pages``
      ``(layers, n_pages, page_size, ...)``; per-slot recurrent state
      (SSM ``conv``/``ssm``) keeps a dense ``(layers, n_slots, ...)``
      layout;
    - ``prefill_chunk(params, cache, batch, *, offset)`` — one prompt chunk
      at absolute position ``offset``; batch carries ``tokens (1, C)``,
      ``valid`` (int), ``slot`` (int) and ``page_table (max_pages,)``;
      returns the logits of the last valid token ``(1, V)``;
    - ``decode_paged(params, cache, batch)`` — one batched token step over
      every slot; batch carries ``tokens (B, 1)``, ``positions (B,)`` and
      ``page_table (B, max_pages)``; returns ``(B, V)`` logits;
    - ``verify_paged(params, cache, batch)`` (optional, speculative
      decoding, ``repro/models/model_api.py:133-139``) — one pass over a
      W-token draft window; batch carries ``tokens (B, W)``, ``positions
      (B,)`` (the cache position of ``tokens[:, 0]``) and ``page_table (B,
      max_pages)``; writes the window's K/V as W sequential
      ``decode_paged`` steps would and returns ``(B, W, V)`` logits.

    The multimodal families add (``repro/models/model_api.py:147-159``):

    - ``paged_cross_specs(n_pages, page_size)`` and ``prefill_cross(params,
      cache, batch)`` (enc-dec): the cross-attention K/V, made once a
      request from the encoder output, lives in its own ``cross_*_pages``
      pools beside the self pools, addressed by the engine's per-slot cross
      page table; ``prefill_cross`` runs the encoder over ``frames (1,
      S_enc, d)`` and writes each decoder layer's cross K/V into the pages
      of ``cross_page_table (max_cross_pages,)``. With both set, the
      chunks and the decode step also take ``cross_page_table`` and
      ``cross_len`` in their batch;
    - ``paged_mm_inline`` (VLM): ``prefill_chunk`` also takes ``embeds (1,
      C, VISION_D)`` and the keyword ``mm_len``: positions below ``mm_len``
      read projected image rows, the rest token embeddings.

    Training (every family, ``repro/models/model_api.py:99-100``):
    ``loss(tree, batch)`` -> ``(loss, aux)`` over the layer-stacked f32
    master tree (:meth:`init_master`), not the serving module.

    ``paged_state`` is True when the cache carries per-slot recurrent state
    (``repro/models/model_api.py:121-130``): that state is not
    page-addressable, so the engine's prefix sharing falls back to trie
    bookkeeping only, and a decode step advances the state of every lane
    it runs.
    """

    cfg: ModelConfig
    param_specs: Tree
    build: Callable[[Tree], nn.Module]
    cache_specs: Callable[..., Tree]
    prefill: Callable[..., tuple[torch.Tensor, Tree]]
    decode_step: Callable[..., torch.Tensor]
    loss: Callable[..., tuple[torch.Tensor, dict]]
    paged_cache_specs: Callable[..., Tree] | None = None
    prefill_chunk: Callable[..., torch.Tensor] | None = None
    decode_paged: Callable[..., torch.Tensor] | None = None
    paged_state: bool = False
    verify_paged: Callable[..., torch.Tensor] | None = None
    paged_cross_specs: Callable[..., Tree] | None = None
    prefill_cross: Callable[..., None] | None = None
    paged_mm_inline: bool = False

    @property
    def supports_paged(self) -> bool:
        """True when the family has the paged entry points
        (``repro/models/model_api.py:191-197``)."""
        return (self.paged_cache_specs is not None
                and self.prefill_chunk is not None
                and self.decode_paged is not None)

    @property
    def supports_prefix_sharing(self) -> bool:
        """True when the whole per-token cache lives in shared page pools,
        so a cached prompt prefix can be installed into another slot with
        zero recompute (``repro/models/model_api.py:200-207``)."""
        return self.supports_paged and not self.paged_state

    @property
    def supports_spec_decode(self) -> bool:
        """True when the family can be a speculative-decoding target or
        draft (``repro/models/model_api.py:209-216``): it has
        ``verify_paged`` and its whole cache lives in pages, so a rejected
        window rolls back by resetting a length. ``paged_state`` families
        are excluded: their recurrent state cannot be rewound."""
        return self.verify_paged is not None and self.supports_prefix_sharing

    @property
    def supports_paged_cross(self) -> bool:
        """True when the family pages its cross-attention region (enc-dec):
        the engine then allocates a cross page chain a request at admission
        and runs :attr:`prefill_cross` to fill it
        (``repro/models/model_api.py:219-226``)."""
        return (self.supports_paged and self.paged_cross_specs is not None
                and self.prefill_cross is not None)

    def init(self, generator: torch.Generator | int = 0,
             device: str | torch.device = "cuda") -> nn.Module:
        """Seeded weights drawn on ``device`` with the reference's fan-in
        rule (the draws themselves differ from ``jax.random``'s)."""
        return self.assemble(self._draw(generator, device))

    def init_master(self, generator: torch.Generator | int = 0,
                    device: str | torch.device = "cuda") -> Tree:
        """The f32 master tree that training steps (``param_specs``'
        structure, stacked leaves ``(L, ...)``): the draws of :meth:`init`
        for the same generator, kept in f32 where :meth:`init` rounds a
        ``cast`` leaf to bf16."""
        return self._draw(generator, device, torch.float32)

    def _draw(self, generator, device, dtype: torch.dtype | None = None
              ) -> Tree:
        dev = resolve_device(device)
        gen = generator
        if isinstance(generator, int):
            gen = torch.Generator(device=dev).manual_seed(generator)
        return tree_map(lambda s: _materialize(s, gen, dev, dtype),
                        self.param_specs)

    def assemble(self, tree: Tree) -> nn.Module:
        """The family's module over ``tree`` (``build``). Its per-layer
        weights are views of the tree's layer-stacked leaves, and the module
        keeps the tree, so :meth:`param_tree` hands the leaves back without
        a copy."""
        module = self.build(tree)
        module._param_tree = tree
        return module

    def param_tree(self, params: nn.Module) -> Tree:
        """The weights of ``params`` as a tree of ``param_specs``'
        structure (stacked leaves ``(L, ...)``, the reference's layout),
        sharing their storage: what the partition rules pair with
        :meth:`param_axes`."""
        tree = getattr(params, "_param_tree", None)
        if tree is None:
            raise ValueError("params were not made by ModelFns.init, "
                             "ModelFns.assemble or the bridge")
        return tree

    def param_axes(self) -> Tree:
        """Each weight's logical axes (``repro/models/model_api.py:164-
        165``)."""
        return tree_map(lambda s: s.axes, self.param_specs)

    def abstract_params(self) -> Tree:
        """Each weight's shape and storage type as a meta tensor:
        allocates nothing."""
        return tree_map(lambda s: torch.empty(s.shape, dtype=storage_dtype(s),
                                              device="meta"),
                        self.param_specs)

    def init_cache(self, n_slots: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device = "cuda") -> Tree:
        """The zeroed dense cache of ``n_slots`` lanes of ``max_seq``
        positions, with the reference's cache-dtype rule."""
        return zeros_from_specs(self.cache_specs(n_slots, max_seq), dtype,
                                resolve_device(device))

    def init_paged_cache(self, n_slots: int, n_pages: int, page_size: int,
                         dtype: torch.dtype = torch.bfloat16,
                         device: str | torch.device = "cuda") -> Tree:
        """The zeroed paged cache, the cross-attention pools (enc-dec)
        allocated beside the self pools."""
        return zeros_from_specs(
            self._full_paged_specs(n_slots, n_pages, page_size), dtype,
            resolve_device(device))

    def _full_paged_specs(self, n_slots: int, n_pages: int,
                          page_size: int) -> dict:
        """The paged cache's specs, the cross-attention pools (enc-dec)
        merged in."""
        specs = dict(self.paged_cache_specs(n_slots, n_pages, page_size))
        if self.paged_cross_specs is not None:
            specs.update(self.paged_cross_specs(n_pages, page_size))
        return specs

    def paged_cache_axes(self, n_slots: int, n_pages: int,
                         page_size: int) -> Tree:
        """Each paged cache leaf's logical axes
        (``repro/models/model_api.py:246-249``)."""
        return {k: s.axes for k, s in
                self._full_paged_specs(n_slots, n_pages, page_size).items()}

    def abstract_paged_cache(self, n_slots: int, n_pages: int,
                             page_size: int,
                             dtype: torch.dtype = torch.bfloat16) -> Tree:
        """Each paged cache leaf's shape and cache dtype as a meta tensor
        (``repro/models/model_api.py:251-257``): allocates nothing."""
        return {k: torch.empty(s.shape, dtype=_cache_dtype(s, dtype),
                               device="meta")
                for k, s in self._full_paged_specs(n_slots, n_pages,
                                                   page_size).items()}


def zeros_from_specs(specs: dict, dtype: torch.dtype = torch.bfloat16,
                     device: torch.device | None = None) -> Tree:
    """Zeroed tensors for a flat dict of cache specs, in the reference's
    cache dtypes (:func:`_cache_dtype`)."""
    return {k: torch.zeros(s.shape, dtype=_cache_dtype(s, dtype),
                           device=device) for k, s in specs.items()}


def _cache_dtype(spec: PSpec, dtype: torch.dtype) -> torch.dtype:
    """The reference's cache-dtype rule (``model_api.py:261-268``): int32
    bookkeeping leaves, f32 recurrent state, else ``dtype``."""
    if spec.axes and spec.axes[-1] == "null_i32":
        return torch.int32
    if "state" in (spec.axes or ()):
        return torch.float32
    return dtype
