"""Elastic restore: the grid a surviving cell re-forms on, and the host
copy it re-lays-out from.

Ported from ``repro/checkpoint/elastic.py``. The paper restores a VM
snapshot on a substitute host; the generalization here is that after
losing hosts the survivors form a smaller ``(data, model)`` grid and the
checkpointed state is re-laid-out onto it.

- :func:`plan_elastic_mesh` (``elastic.py:28-56``) picks the largest
  usable grid for the surviving device count, keeping the model axis
  intact where it can (a model group is the unit of host loss);
- :func:`make_elastic_mesh` (``elastic.py:58-68``) builds the grid of
  real devices: a ``DeviceMesh`` over the first ``data * model`` ranks
  of the process group, one per grid and kept, because building one is
  collective over the whole group;
- :func:`reshard_state` (``elastic.py:71-78``) lays a host copy out on
  such a mesh, each leaf by the partition rules (:func:`place`);
- :func:`gather_state` (``elastic.py:81-85``) copies every tensor of a
  state to host memory, a sharded one whole: the elastic checkpoint.

Expert parallelism and sharded training on these meshes are ROADMAP item
16b.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from repro_torch.parallel.partition import tree_map2, tree_shardings

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


# one mesh per (ranks, grid, device type): building a mesh is collective
# over the whole process group, and a gloo group costs sockets
_MESHES: dict[tuple, DeviceMesh] = {}


def make_elastic_mesh(ranks, data: int, model: int) -> DeviceMesh:
    """A ``DeviceMesh`` named ``("data", "model")`` over the first ``data *
    model`` of ``ranks`` (ranks of the default process group), on the
    group's device type: ``cuda`` under NCCL, ``cpu`` under gloo. Every
    rank of the group must call it, members or not; a grid built before
    is handed back."""
    ranks = [int(r) for r in ranks]
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({data}, {model})")
    if len(ranks) < data * model:
        raise ValueError(
            f"cannot build a ({data}, {model}) mesh from {len(ranks)} "
            f"device(s): need {data * model}. Re-plan the grid for the "
            "surviving devices with plan_elastic_mesh() first.")
    # the first DTensor call imports torch._dynamo, and that import leaves
    # a reference cycle (a frame of torch.fx.wrap) that keeps every frame
    # below it alive, locals and all, until the cyclic collector runs:
    # imported here, before anything is placed, it holds no weights
    import torch._dynamo  # noqa: F401

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    key = (tuple(ranks[: data * model]), data, model, device_type)
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = DeviceMesh(device_type,
                          torch.tensor(key[0]).reshape(data, model),
                          mesh_dim_names=("data", "model"))
        _MESHES[key] = mesh
    return mesh


def clear_meshes() -> None:
    """Forget the kept meshes (before the process group is destroyed)."""
    _MESHES.clear()


def local_chunk(x: torch.Tensor, mesh: DeviceMesh, placements) -> torch.Tensor:
    """This rank's block of ``x`` under ``placements``: ``torch.chunk`` of
    each sharded dim at the rank's coordinate, in mesh order (the rules
    shard only divisible dims, so every block is whole). Empty on a rank
    outside the mesh, as DTensor keeps it."""
    coord = mesh.get_coordinate()
    if coord is None:
        return x.new_empty((0,))
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            x = x.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return x


def place(x: torch.Tensor, mesh: DeviceMesh, placements) -> DTensor:
    """``distribute_tensor(x, mesh, placements, src_data_rank=None)`` of a
    tensor every rank holds whole, with the block cut before it goes to
    the mesh's device: a rank copies only its own block there."""
    local = local_chunk(x.detach(), mesh, placements)
    local = local.to(mesh.device_type).contiguous()
    stride, n = [], 1
    for size in reversed(x.shape):
        stride.insert(0, n)
        n *= size
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=tuple(stride))


def reshard_state(state: Tree, axes_tree: Tree, mesh: DeviceMesh) -> Tree:
    """Lay ``state`` (nested dicts of tensors, the same host copy on every
    rank) out on ``mesh`` by the partition rules: no broadcast, since
    every rank holds the whole copy."""
    shardings = tree_shardings(axes_tree, state, mesh)
    return tree_map2(lambda x, s: place(x, s.mesh, s.placements),
                     state, shardings)


def gather_state(state: Tree) -> Tree:
    """A host copy of every tensor of ``state`` (nested dicts of tensors),
    bit for bit, a DTensor whole (``full_tensor``, collective over its
    mesh): the serialization side of an elastic checkpoint."""
    if isinstance(state, dict):
        return {k: gather_state(v) for k, v in state.items()}
    if isinstance(state, DTensor):
        return state.full_tensor().detach().to("cpu", copy=True)
    return state.detach().to("cpu", copy=True)
