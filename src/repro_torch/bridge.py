"""Weight bridge: the JAX package's parameters, as numpy arrays, into the
port's modules.

The two packages cannot draw the same random weights (``jax.random`` and
``torch.Generator`` differ), so tests that hold the port against the
reference hand the reference's parameters across by value. Leaves keep the
reference's nested layout; layer-stacked leaves ``(L, ...)`` are split into
the port's per-layer modules by the family's ``build``.

A bf16 leaf crosses bit for bit: its raw bytes are reinterpreted
(``view(np.int16)`` then ``view(torch.bfloat16)``), so no numpy bfloat16
type (``ml_dtypes``) is needed on either side. An f32 leaf crosses as is
and is then stored as the port stores it (``model_api.storage_dtype``): a
leaf the reference casts before every use is rounded to bf16 (round to
nearest even, the same cast), every other leaf — norm weights, the SSM
families' ``A_log`` and ``conv_w`` — stays f32 as the reference reads it.
Nested groups (the hybrid family's ``shared.attn``/``shared.mlp``) and
unstacked leaves (its ``app_proj``) follow the same rule.

A train state crosses as a whole (:func:`train_state_from_reference`,
:func:`train_state_to_reference`): ``params``, ``mu`` and ``nu`` as f32
tensors of the reference's stacked layout, ``step``, ``rng`` and
``data_step`` as the numpy scalars and words the port's state holds
(``training/state.py``), so that the two packages step the same state.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models.model_api import ModelFns, storage_dtype


def tensor_from_numpy(arr: np.ndarray,
                      device: str | torch.device = "cpu") -> torch.Tensor:
    """One leaf, bitwise: f32 as f32, bfloat16 (any numpy bfloat16 type) as
    ``torch.bfloat16`` via its raw bytes."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`tensor_from_numpy`. A bf16 tensor comes back
    as its raw bits (``np.uint16``); ``.view(<numpy bfloat16 type>)`` gives
    the values where such a type is installed."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_from_reference(tree: dict, model: ModelFns, *,
                          device: str | torch.device = "cuda") -> nn.Module:
    """The reference's parameter tree (numpy leaves, same nesting as
    ``ModelFns.init`` of the JAX package) as the port's module for
    ``model``, on ``device``."""
    dev = resolve_device(device)

    def leaf(spec, arr):
        t = tensor_from_numpy(arr, dev)
        if tuple(t.shape) != spec.shape:
            raise ValueError(f"leaf of shape {tuple(t.shape)} for spec "
                             f"{spec.shape}")
        return t.to(storage_dtype(spec))

    def walk(specs, sub):
        if isinstance(specs, dict):
            if set(specs) != set(sub):
                raise ValueError(f"keys {sorted(sub)} for specs {sorted(specs)}")
            return {k: walk(specs[k], sub[k]) for k in specs}
        return leaf(specs, sub)

    return model.assemble(walk(model.param_specs, tree))




def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def train_state_from_reference(state: dict, *,
                               device: str | torch.device = "cuda") -> dict:
    """The reference's train state (numpy leaves, ``jax.tree.map(np.asarray,
    state)``) as the port's: ``params``/``mu``/``nu`` f32 tensors on
    ``device``, ``step``/``data_step`` 0-d int32 and ``rng`` (2,) uint32
    numpy arrays."""
    dev = resolve_device(device)

    def f32(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            raise ValueError(f"a {a.dtype} leaf where f32 was expected")
        return tensor_from_numpy(a, dev)

    opt = state["opt"]
    return {
        "params": _map(f32, state["params"]),
        "opt": {"mu": _map(f32, opt["mu"]), "nu": _map(f32, opt["nu"]),
                "step": np.asarray(opt["step"], np.int32)},
        "rng": np.asarray(state["rng"], np.uint32),
        "data_step": np.asarray(state["data_step"], np.int32),
    }


def train_state_to_reference(state: dict) -> dict:
    """The port's train state as numpy leaves of the reference's tree and
    dtypes (``jax.tree.map(jnp.asarray, ...)`` makes it the reference's)."""
    opt = state["opt"]
    return {
        "params": _map(numpy_from_tensor, state["params"]),
        "opt": {"mu": _map(numpy_from_tensor, opt["mu"]),
                "nu": _map(numpy_from_tensor, opt["nu"]),
                "step": np.asarray(opt["step"], np.int32)},
        "rng": np.asarray(state["rng"], np.uint32),
        "data_step": np.asarray(state["data_step"], np.int32),
    }
