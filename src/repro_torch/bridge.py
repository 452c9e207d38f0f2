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
and is then stored as the port stores it: matrices are rounded to bf16
(round to nearest even, the same cast the reference applies before every
use), norm weights stay f32.
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

    return model.build(walk(model.param_specs, tree))


