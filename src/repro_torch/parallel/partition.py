"""Logical-axis → grid-axis partition rule engine, layout only.

Ported from ``repro/parallel/partition.py:36-124``. Every parameter and
cache tensor carries a tuple of *logical axis names* (the specs of
``repro_torch.models.model_api``); this module maps them onto a
``(pod, data, model)`` grid with the reference's **divisibility-checked
fallbacks**:

- primary tensor-parallel dims (``heads, kv_heads, mlp, experts, vocab,
  inner, ssm_heads, embed_model``) take ``model`` when the dim size divides
  the axis;
- if no primary dim could take ``model``, a *fallback* dim
  (``embed_in → embed_out → seq_fallback → pages``) takes it instead
  (row-parallel weights, sequence- or page-sharded caches);
- ``batch`` takes the combined data axes ``(pod, data)`` when divisible,
  then ``(data,)``, else stays replicated.

The grid is a :class:`LayoutGrid` (axis names and sizes, no devices) and a
spec a :class:`PartitionSpec` (one entry per dim: an axis name, a tuple of
names, or None), a tuple that compares as ``jax.sharding.PartitionSpec``
compares. Placing tensors on a grid of real devices
(``tree_shardings``, ``activation_sharding``, ``shard``) belongs to the
materialized elastic cell, ROADMAP Queue 1, item 16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

Tree = Any

# Dims that take the "model" axis directly.
MODEL_PRIMARY = {
    "heads",
    "kv_heads",
    "mlp",
    "expert_mlp",
    "experts",
    "vocab",
    "inner",
    "ssm_heads",
    "embed_model",
    "seq_model",   # sequence parallelism: residual-stream seq dim
}

# Ordered fallback receivers of "model" when no primary dim sharded.
# "pages" lets a paged KV pool shard over physical pages when the kv-head
# count doesn't divide the model axis (pages are independent, page ids are
# global).
MODEL_FALLBACK = ("embed_in", "embed_out", "seq_fallback", "pages")

# Dims that never shard.
NEVER = {
    "layers", "embed", "head_dim", "state", "conv", "dt_rank", "q_per_kv",
    "null", "null_i32", "seq", "page", None,
}

DATA_AXES_PREFERENCE = (("pod", "data"), ("data",))


class PartitionSpec(tuple):
    """One tensor's layout: an entry per dim, a grid axis name, a tuple of
    names (the dim spans their product) or None (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class LayoutGrid:
    """A named device grid without devices: what the partition rules
    read of a mesh (``axis_names`` and ``shape``)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} vs sizes {self.sizes}")
        if any(s < 1 for s in self.sizes):
            raise ValueError(f"grid axes must be >= 1, got {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def layout_grid(data: int, model: int) -> LayoutGrid:
    """The elastic cell's ``(data, model)`` grid."""
    return LayoutGrid(("data", "model"), (data, model))


def _mesh_axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return math.prod(mesh.shape[n] for n in name)
    return mesh.shape[name]


def spec_for_axes(axes: tuple, shape: tuple[int, ...], mesh) -> PartitionSpec:
    """Resolve one tensor's logical axes to a :class:`PartitionSpec` on
    ``mesh`` (anything with ``axis_names`` and a ``shape`` mapping)."""
    assert len(axes) == len(shape), (axes, shape)
    entries: list = [None] * len(axes)
    model_size = mesh.shape.get("model", 1) if "model" in mesh.axis_names else 1
    model_taken = False

    # pass 1: batch + primary model dims
    for i, (name, dim) in enumerate(zip(axes, shape)):
        if name == "batch":
            for cand in DATA_AXES_PREFERENCE:
                if all(a in mesh.axis_names for a in cand) and dim % _mesh_axis_size(
                    mesh, cand
                ) == 0 and dim > 0:
                    entries[i] = cand if len(cand) > 1 else cand[0]
                    break
        elif name in MODEL_PRIMARY and not model_taken:
            if "model" in mesh.axis_names and dim % model_size == 0 and dim > 0:
                entries[i] = "model"
                model_taken = True

    # pass 2: model fallback
    if not model_taken and "model" in mesh.axis_names:
        for fb in MODEL_FALLBACK:
            for i, (name, dim) in enumerate(zip(axes, shape)):
                if name == fb and dim % model_size == 0 and dim > 0:
                    entries[i] = "model"
                    model_taken = True
                    break
            if model_taken:
                break

    return PartitionSpec(*entries)


def tree_map2(fn: Callable, a: Tree, b: Tree) -> Tree:
    """``fn`` over the paired leaves of two trees of nested dicts of one
    structure."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            raise ValueError(f"tree keys differ: {sorted(a)} vs "
                             f"{sorted(b) if isinstance(b, dict) else b!r}")
        return {k: tree_map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def tree_partition_specs(axes_tree: Tree, value_tree: Tree, mesh) -> Tree:
    """Map a tree of logical-axis tuples and a tree of shaped values
    (tensors, meta tensors) of the same structure to PartitionSpecs."""
    return tree_map2(
        lambda axes, val: spec_for_axes(tuple(axes), tuple(val.shape), mesh),
        axes_tree, value_tree)
