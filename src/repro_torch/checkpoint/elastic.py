"""Elastic restore: the grid a surviving cell re-forms on, and the host
copy it re-lays-out from.

Ported from ``repro/checkpoint/elastic.py``. The paper restores a VM
snapshot on a substitute host; the generalization here is that after
losing hosts the survivors form a smaller ``(data, model)`` grid and the
checkpointed state is re-laid-out onto it.

- :func:`plan_elastic_mesh` (``elastic.py:28-56``) picks the largest
  usable grid for the surviving device count, keeping the model axis
  intact where it can (a model group is the unit of host loss);
- :func:`gather_state` (``elastic.py:81-85``) copies every tensor of a
  state to host memory: the elastic checkpoint.

``make_elastic_mesh`` and ``reshard_state`` place state on a grid of real
devices; they belong to the materialized cell (ROADMAP Queue 1, item 16).
"""

from __future__ import annotations

from typing import Any

Tree = Any


def plan_elastic_mesh(
    n_devices: int, *, model_parallel: int, prefer_pow2: bool = True
) -> tuple[int, int]:
    """Largest (data, model) grid with model axis kept at ``model_parallel``.

    Loses at most ``model_parallel-1`` devices' capacity (partial model
    groups can't host a replica). If fewer than one model group survives,
    model parallelism degrades to the largest power-of-two that fits.
    """
    if n_devices < 1:
        raise ValueError(
            f"plan_elastic_mesh needs at least one surviving device, got "
            f"n_devices={n_devices}")
    if model_parallel < 1:
        raise ValueError(
            f"model_parallel must be >= 1, got {model_parallel} (a model "
            "axis of zero or negative width has no layout)")
    mp = model_parallel
    while mp > n_devices:
        mp //= 2
    mp = max(1, mp)
    data = n_devices // mp
    if prefer_pow2 and data > 1:
        p = 1
        while p * 2 <= data:
            p *= 2
        data = p
    return data, mp


def gather_state(state: Tree) -> Tree:
    """A host copy of every tensor of ``state`` (nested dicts of tensors),
    bit for bit: the serialization side of an elastic checkpoint."""
    if isinstance(state, dict):
        return {k: gather_state(v) for k, v in state.items()}
    return state.detach().to("cpu", copy=True)
