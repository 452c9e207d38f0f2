"""Per-cell programs of the dry-run and the roofline (``repro/launch/
cells.py``).

A *cell* is (architecture x input shape). :func:`build_cell` returns the
cell's program, its inputs as meta tensors, and each input leaf's
partition spec on a layout grid:

- ``train_*``   -> the whole train step (loss, gradients, AdamW) over a
  train state (``training/state.py::abstract_train_state``);
- ``prefill_*`` -> the dense prefill (params, batch) -> (logits, cache);
- ``decode_*``  -> one dense ``decode_step`` of a new token against a
  ``seq_len`` cache (``abstract_cache(global_batch, seq_len)``).

The serving cells take the serving module's weights in the types they are
stored in (``ModelFns.abstract_params``: bf16 where the reference casts a
leaf at each use, f32 else), the port's layout of the reference's
``serve_dtype``.

Nothing is allocated: every input is a meta tensor, and :func:`lower_cell`
(the counterpart of the reference's ``jit(...).lower``) runs the program
under :class:`~repro_torch.launch.counter.MetaCounter`. The same program
runs on the card over real tensors (``chip_smoke.py``'s
``phase_roofline``). From the specs come each device's bytes of params,
state and cache on the grid (the reference's per-device memory analysis);
a dim that does not divide the grid axis its spec names is reported in
``indivisible``, what the reference's compile would refuse.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.config import ModelConfig, RunConfig, ShapeConfig
from repro_torch.launch.counter import MetaCounter
from repro_torch.models import get_model
from repro_torch.models.model_api import ModelFns, batch_axes_for
from repro_torch.parallel.partition import tree_map2, tree_partition_specs
from repro_torch.training.state import abstract_train_state, train_state_axes
from repro_torch.training.step import make_train_step


@dataclass
class CellProgram:
    arch_id: str
    shape: ShapeConfig
    fn: Callable                 # positional-arg step function
    abstract_args: tuple         # meta tensors (and host leaves) matching fn
    in_specs: tuple              # partition-spec trees matching abstract_args
    kind: str                    # train | prefill | decode
    model: ModelFns
    per_device_bytes: dict = field(default_factory=dict)
    indivisible: list = field(default_factory=list)


def _layout(name: str, axes: Any, values: Any, mesh) -> tuple[Any, int,
                                                               list]:
    """The specs of ``values`` on ``mesh``, the bytes a device holds of
    them, and the dims that do not divide their grid axes."""
    specs = tree_partition_specs(axes, values, mesh)
    total, bad = 0, []

    def one(spec, val):
        nonlocal total
        shards = 1
        for i, entry in enumerate(spec):
            if entry is None:
                continue
            size = math.prod(mesh.shape[a] for a in
                             (entry if isinstance(entry, tuple) else (entry,)))
            if val.shape[i] % size:
                bad.append(f"{name}: dim {i} ({val.shape[i]}) over "
                           f"{entry} ({size})")
            shards *= size
        total += _nbytes(val) // shards
        return spec

    tree_map2(one, specs, values)
    return specs, total, bad


def _nbytes(val) -> int:
    if isinstance(val, torch.Tensor):
        return val.numel() * val.element_size()
    return int(val.nbytes)       # the state's host leaves (numpy)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               run: RunConfig | None = None) -> CellProgram:
    model = get_model(cfg)
    run = run or RunConfig(arch=cfg.arch_id)
    ispecs = model.input_specs(shape)
    bspec, bbytes, bbad = _layout("batch", batch_axes_for(ispecs), ispecs,
                                  mesh)

    if shape.kind == "train":
        state = abstract_train_state(model)
        sspec, sbytes, sbad = _layout("state", train_state_axes(model),
                                      state, mesh)
        return CellProgram(
            cfg.arch_id, shape, make_train_step(model, run), (state, ispecs),
            (sspec, bspec), "train", model,
            {"state": sbytes, "batch": bbytes}, sbad + bbad)

    tree = model.abstract_params()
    pspec, pbytes, pbad = _layout("params", model.param_axes(), tree, mesh)
    params = model.assemble(tree)

    if shape.kind == "prefill":
        def prefill(params, batch):
            return model.prefill(params, batch)

        return CellProgram(
            cfg.arch_id, shape, prefill, (params, ispecs), (pspec, bspec),
            "prefill", model, {"params": pbytes, "batch": bbytes},
            pbad + bbad)

    cache = model.abstract_cache(shape.global_batch, shape.seq_len)
    cspec, cbytes, cbad = _layout(
        "cache", model.cache_axes(shape.global_batch, shape.seq_len), cache,
        mesh)

    def serve_step(params, cache, batch):
        return model.decode_step(params, cache, batch)

    return CellProgram(
        cfg.arch_id, shape, serve_step, (params, cache, ispecs),
        (pspec, cspec, bspec), "decode", model,
        {"params": pbytes, "cache": cbytes, "batch": bbytes},
        pbad + cbad + bbad)


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a program's inputs: a module's parameters, the
    leaves of nested dicts, lists and tuples."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def lower_cell(prog: CellProgram) -> dict:
    """Run the cell's program once under the counter, over its meta
    inputs: each kernel's wrapper records its cost (under
    ``ops.use_backend("plain")`` the plain versions run op by op instead).
    Returns the counter's summary; ``argument_bytes`` is the inputs'
    global bytes. Eager execution runs every loop in full, so the count is
    trip-exact with nothing unrolled."""
    with MetaCounter() as counter:
        prog.fn(*prog.abstract_args)
    out = counter.summary()
    out["argument_bytes"] = sum(map(_nbytes, _tensors(prog.abstract_args)))
    return out
