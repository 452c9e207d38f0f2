"""TrainState: the checkpointable unit of the ad hoc cloud's "VM snapshot".

Ported from ``repro/training/state.py``: a plain dict, so serialization and
the partition rules go through generic tree walks, with the reference's
keys and dtypes:

- ``params`` f32 master weights (bf16 compute casts happen in the loss),
  layer-stacked as the reference lays them out, on the run's device;
- ``opt``    AdamW moments ``mu``/``nu`` (f32, beside their parameters) and
  ``step`` (0-d int32);
- ``rng``    (2,) uint32 words;
- ``data_step`` 0-d int32 cursor of the deterministic data stream.

The scalars and ``rng`` are numpy arrays held on the host: the step reads
them there, and the serializer writes them as they are.

``rng`` has the reference's shape and type, so a state's blob crosses
packages with the same tree and dtypes, but the port cannot reproduce
``jax.random``'s threefry draws: its words seed the port's own generators
(``training/step.py``). A state restored across packages therefore
continues with the port's own noise (int8 compression) and its own next
words; with compression off, no step reads them.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.model_api import ModelFns, tree_map
from repro_torch.optim import adamw_init

TrainState = dict  # alias: states are plain dicts


def _rng_words(seed: int) -> np.ndarray:
    """The initial ``rng`` words of a run seeded with ``seed``."""
    return np.random.SeedSequence([seed, 1]).generate_state(2, np.uint32)


def init_train_state(model: ModelFns, seed: int = 0,
                     device: str | torch.device = "cuda") -> TrainState:
    params = model.init_master(seed, device)
    return {
        "params": params,
        "opt": adamw_init(params),
        "rng": _rng_words(seed),
        "data_step": np.zeros((), np.int32),
    }


def abstract_train_state(model: ModelFns) -> TrainState:
    """Meta-tensor stand-ins of every leaf's shape and dtype: allocates
    nothing."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    params = tree_map(lambda s: meta(s.shape, torch.float32),
                      model.param_specs)

    def zeros_like(t):
        return tree_map(lambda x: meta(x.shape, x.dtype), t)

    return {
        "params": params,
        "opt": {"mu": zeros_like(params), "nu": zeros_like(params),
                "step": meta((), torch.int32)},
        "rng": meta((2,), torch.uint32),
        "data_step": meta((), torch.int32),
    }


def train_state_axes(model: ModelFns) -> Any:
    """Logical-axis tree matching the TrainState structure."""
    paxes = model.param_axes()
    scalar = ()
    return {
        "params": paxes,
        "opt": {"mu": paxes, "nu": paxes, "step": scalar},
        "rng": ("null",),
        "data_step": scalar,
    }
