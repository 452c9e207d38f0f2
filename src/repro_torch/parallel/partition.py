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
compares.

Placement on a grid of real devices (``repro/parallel/partition.py:125-163``)
goes through ``torch.distributed.tensor``: a ``DeviceMesh`` named like the
grid's axes stands for the ``Mesh``, and :func:`to_placements` turns a spec
into one placement per mesh dim, ``Shard(i)`` where entry ``i`` names that
mesh dim (or holds it in a tuple), else ``Replicate()``. A
:class:`Sharding` (mesh and placements) stands for ``NamedSharding``
(:func:`tree_shardings`). Activations take the same rules through
:func:`shard`, a ``redistribute`` that is a no-op unless a mesh was
installed with :func:`activation_sharding`, so the model code is the same
on one device and on a grid. The rules shard only divisible dims, so no
shard is uneven and nothing is padded.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

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


# ---------------------------------------------------------------------------
# Placement on a mesh of real devices
# ---------------------------------------------------------------------------


def _axis_names(mesh) -> tuple[str, ...]:
    """A ``DeviceMesh``'s dim names, or a :class:`LayoutGrid`'s axes."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def grid_of(mesh) -> LayoutGrid:
    """What the rules read of a ``DeviceMesh`` (or a grid): its axis names
    and sizes."""
    if isinstance(mesh, LayoutGrid):
        return mesh
    return LayoutGrid(_axis_names(mesh), tuple(mesh.shape))


def to_placements(spec: PartitionSpec, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(i)`` where entry ``i`` of
    ``spec`` names that dim or holds it in a tuple (``("pod", "data")``
    shards dim ``i`` over both, in mesh order), else ``Replicate()``. A
    mesh dim of size 1 replicates: its one block is the whole dim, and a
    replicated dim is one that views and reshapes may merge."""
    grid = grid_of(mesh)
    out = [Replicate()] * len(grid.axis_names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if grid.shape[axis] > 1:
                out[grid.axis_names.index(axis)] = Shard(i)
    return tuple(out)


class Sharding(NamedTuple):
    """One tensor's place on a mesh: the counterpart of ``NamedSharding``."""

    mesh: Any
    placements: tuple


def tree_shardings(axes_tree: Tree, value_tree: Tree, mesh) -> Tree:
    """The :class:`Sharding` of every leaf (``repro/parallel/partition.py:
    125-131``): the rules' spec on ``mesh``'s grid, as placements."""
    grid = grid_of(mesh)
    return tree_map2(
        lambda axes, val: Sharding(mesh, to_placements(
            spec_for_axes(tuple(axes), tuple(val.shape), grid), mesh)),
        axes_tree, value_tree)


_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_activation_mesh", default=None)


@contextlib.contextmanager
def activation_sharding(mesh):
    """Install ``mesh`` so that :func:`shard` lays activations out on it
    (None uninstalls)."""
    tok = _ACTIVE_MESH.set(mesh)
    try:
        yield
    finally:
        _ACTIVE_MESH.reset(tok)


def current_mesh():
    """The mesh :func:`activation_sharding` installed, or None."""
    return _ACTIVE_MESH.get()


def shard(x: torch.Tensor, *axes) -> torch.Tensor:
    """Lay an activation out by logical axis names: without a mesh, ``x``
    itself; under one, ``x`` redistributed to the rules' placements (a
    plain tensor first becomes a replicated DTensor). A partial sum meets
    its reduction here."""
    mesh = _ACTIVE_MESH.get()
    if mesh is None:
        return x
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    spec = spec_for_axes(tuple(axes), tuple(x.shape), grid_of(mesh))
    return x.redistribute(mesh, to_placements(spec, mesh))


def on_mesh(fn: Callable, mesh) -> Callable:
    """A paged entry point ``fn(params, cache, batch, **kw)`` (the model's
    ``prefill_chunk`` or ``decode_paged``) run on ``mesh`` by a rank of
    it, with the weights and the pool the caller's DTensors: the tensors
    of ``batch`` enter as replicated DTensors, tensors the model makes
    count as replicated (``implicit_replication``), activations follow
    the rules (:func:`activation_sharding`), and the logits leave whole
    (``full_tensor()``), so the caller's sampling and bookkeeping never
    see a DTensor."""
    rep = [Replicate()] * mesh.ndim

    @functools.wraps(fn)
    def run(params, cache, batch, **kw):
        batch = {k: (DTensor.from_local(v, mesh, rep, run_check=False)
                     if isinstance(v, torch.Tensor)
                     and not isinstance(v, DTensor) else v)
                 for k, v in batch.items()}
        with activation_sharding(mesh), implicit_replication():
            logits = fn(params, cache, batch, **kw)
        return (logits.full_tensor() if isinstance(logits, DTensor)
                else logits)

    return run
