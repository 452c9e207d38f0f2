"""Checkpointing of the port: the ad hoc cloud's "VM snapshot".

- :mod:`~repro_torch.checkpoint.serializer` — tree <-> bytes in the JAX
  package's data-only blob format (+ shard splitting).
- :mod:`~repro_torch.checkpoint.store` — per-host snapshot stores
  (memory/disk).
- :mod:`~repro_torch.checkpoint.replicated` — P2P replicated checkpoint
  manager (placement per the paper's ≤5%-joint-failure rule).
- :mod:`~repro_torch.checkpoint.elastic` — the grid a surviving elastic
  cell re-forms on (``plan_elastic_mesh``) and the host copy it
  re-lays-out from (``gather_state``).
"""

from repro_torch.checkpoint.serializer import (
    deserialize_tree,
    serialize_tree,
    split_into_shards,
    join_shards,
)
from repro_torch.checkpoint.elastic import gather_state, plan_elastic_mesh
from repro_torch.checkpoint.store import DiskStore, SnapshotStore

__all__ = [
    "serialize_tree",
    "deserialize_tree",
    "split_into_shards",
    "join_shards",
    "SnapshotStore",
    "DiskStore",
    "gather_state",
    "plan_elastic_mesh",
]
