"""P2P replicated checkpoint manager: the paper's snapshot protocol applied
to sharded training state.

At scale, each *owner* host serializes one byte-balanced shard of the
state (``split_into_shards``) and pushes it to receiver peers chosen by
the paper's ≤5%-joint-failure placement (§III-D). A restore succeeds if,
for every shard, at least one holder (owner or receiver) survives — the
per-shard survival probability is exactly the paper's per-snapshot bound,
so an n-shard checkpoint survives with probability ≥ (1-target)^n; callers
tighten ``target_joint_failure`` as the fleet grows (0.05/n keeps the
whole-checkpoint bound at 95%).

Only the latest version is kept (owner pushes overwrite), matching the
paper's keep-only-latest rule.

Copied from ``repro/checkpoint/replicated.py`` (plain Python), so that
the port imports nothing of the JAX package; only the
cross-references name the port's modules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.checkpoint.serializer import join_shards, split_into_shards
from repro_torch.checkpoint.store import SnapshotStore
from repro_torch.core.snapshot import SnapshotScheduler

Pytree = Any


@dataclass
class ShardPlacement:
    shard_idx: int
    owner: str
    receivers: list[str]
    joint_failure: float
    size_bytes: int


@dataclass
class CheckpointRecord:
    step: int
    placements: list[ShardPlacement]
    complete: bool


class ReplicatedCheckpointManager:
    """Drives shard placement + restore over per-host stores."""

    def __init__(
        self,
        job_id: str,
        owners: list[str],
        stores: dict[str, SnapshotStore],
        *,
        target_joint_failure: float = 0.05,
        max_receivers: int = 8,
        scale_target_by_shards: bool = True,
    ):
        self.job_id = job_id
        self.owners = list(owners)
        self.stores = stores
        n = max(1, len(owners))
        target = (
            target_joint_failure / n if scale_target_by_shards
            else target_joint_failure
        )
        self.placer = SnapshotScheduler(
            target_joint_failure=target, max_receivers=max_receivers
        )
        self.latest: CheckpointRecord | None = None

    def _key(self, shard_idx: int) -> str:
        return f"{self.job_id}/shard{shard_idx}"

    # ------------------------------------------------------------------ save
    def save(
        self,
        state: Pytree,
        step: int,
        *,
        fail_prob: dict[str, float],
        available: set[str],
        in_use: set[str] = frozenset(),
        storage_full: set[str] = frozenset(),
    ) -> CheckpointRecord:
        """Serialize → shard → place → push. Each owner keeps its own shard
        locally *and* replicates it to its receivers."""
        blobs = split_into_shards(state, len(self.owners))
        placements = []
        complete = True
        for i, (owner, blob) in enumerate(zip(self.owners, blobs)):
            peers = [h for h in self.stores if h != owner]
            receivers, joint = self.placer.place(
                owner, peers, {**{h: 1.0 for h in peers}, **fail_prob},
                in_use=set(in_use) - {owner},
                available=available,
                storage_full=storage_full,
            )
            delivered = []
            if owner in self.stores and self.stores[owner].put(
                self._key(i), blob
            ):
                delivered.append(owner)
            for r in receivers:
                if self.stores[r].put(self._key(i), blob):
                    delivered.append(r)
            if len(delivered) <= (1 if owner in delivered else 0):
                complete = False  # no off-host replica landed
            placements.append(
                ShardPlacement(i, owner, delivered, joint, len(blob))
            )
        rec = CheckpointRecord(step, placements, complete)
        self.latest = rec
        return rec

    # --------------------------------------------------------------- restore
    def restore(
        self, like: Pytree, *, surviving: set[str]
    ) -> tuple[Pytree, int] | None:
        """Collect one live copy of every shard; None if any shard lost."""
        if self.latest is None:
            return None
        blobs = []
        for pl in self.latest.placements:
            blob = None
            for h in pl.receivers:
                if h in surviving and h in self.stores:
                    blob = self.stores[h].get(self._key(pl.shard_idx))
                    if blob is not None:
                        break
            if blob is None:
                return None
            blobs.append(blob)
        return join_shards(blobs, like), self.latest.step

    def survival_ok(self, surviving: set[str]) -> bool:
        """Would a restore succeed with this surviving set?"""
        if self.latest is None:
            return False
        return all(
            any(h in surviving for h in pl.receivers)
            for pl in self.latest.placements
        )

    def drop_host(self, host_id: str) -> None:
        if self.latest is None:
            return
        for pl in self.latest.placements:
            if host_id in pl.receivers:
                pl.receivers.remove(host_id)

    def forget(self) -> None:
        """Delete every replica (job finished / superseded restore).

        Sweeps all stores, not just recorded receivers — a host that
        failed and returned may still hold a stale replica file.
        """
        if self.latest is None:
            return
        for pl in self.latest.placements:
            key = self._key(pl.shard_idx)
            for store in self.stores.values():
                store.delete(key)
        self.latest = None
