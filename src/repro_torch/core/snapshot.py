"""P2P snapshot placement (paper §III-D): making the unreliable reliable.

The P2P Snapshot component periodically captures guest snapshots and pushes
them to peers. Receivers are chosen by the paper's algorithm:

1. filter candidates — exclude the sender, hosts currently *in use*
   (running a guest), hosts outside the sender's cloudlet, unavailable
   hosts, and hosts whose ad-hoc storage cap is reached (the server stops
   advertising those);
2. sort the remainder by **descending reliability**;
3. select the **first n** hosts such that the joint probability of all n
   failing is ≤ the target (5%) — i.e. ∏ p_fail(h_i) ≤ 0.05, giving the
   95% continuity goal.

Bookkeeping follows the paper: only the most recent snapshot per guest is
stored (receivers drop the previous version), and after a restore all
remaining replicas of the restored snapshot are deleted.

Copied from ``repro/core/snapshot.py`` (plain Python), so that
the port imports nothing of the JAX package; only the
cross-references name the port's modules.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

DEFAULT_TARGET_JOINT_FAILURE = 0.05


def joint_failure_probability(fail_probs: list[float]) -> float:
    """P(all receivers fail) = ∏ p_i (independent failures, as in §III-D)."""
    out = 1.0
    for p in fail_probs:
        assert -1e-9 <= p <= 1 + 1e-9, p
        out *= min(1.0, max(0.0, p))
    return out


def select_receivers(
    ranked_candidates: list[str],
    fail_prob: dict[str, float],
    *,
    target: float = DEFAULT_TARGET_JOINT_FAILURE,
    max_receivers: int = 16,
) -> tuple[list[str], float]:
    """The paper's "first n hosts with < target chance of all failing".

    ``ranked_candidates`` must already be sorted by descending reliability.
    Returns ``(receivers, achieved_joint_failure)``. If even
    ``max_receivers`` can't reach the target (all peers flaky), returns the
    best-effort prefix — the achieved probability tells the caller how far
    off the 95% goal the placement is.
    """
    receivers: list[str] = []
    joint = 1.0
    for h in ranked_candidates:
        if len(receivers) >= max_receivers:
            break
        receivers.append(h)
        joint *= min(1.0, max(0.0, fail_prob[h]))
        if joint <= target:
            break
    return receivers, joint


@dataclass
class SnapshotMeta:
    """Server-side record of one stored snapshot version.

    ``lease_ids`` lists the page leases (see
    :class:`repro_torch.core.cloudlet.LeaseTable`) the guest's serving cache
    depended on when the snapshot was taken — pages spilled to neighbor
    hosts. A restore on a substitute host revalidates those leases: ones
    revoked by churn while the snapshot sat idle are recomputed, the rest
    are recalled as usual, so the snapshot blob itself never has to embed
    remote page payloads.
    """

    guest_id: str
    version: int                  # monotonically increasing per guest
    size_bytes: int
    locations: list[str]          # receiver host ids currently holding it
    joint_failure: float          # ∏ p_fail at placement time
    created_at: float
    lease_ids: list[int] = field(default_factory=list)


@dataclass
class SnapshotScheduler:
    """Placement policy + location bookkeeping (the paper's P2P Snapshot
    component's server-visible half)."""

    target_joint_failure: float = DEFAULT_TARGET_JOINT_FAILURE
    max_receivers: int = 16
    # guest_id -> most recent SnapshotMeta (keep-only-latest, §III-D)
    latest: dict[str, SnapshotMeta] = field(default_factory=dict)

    def filter_candidates(
        self,
        sender: str,
        peers: list[str],
        *,
        in_use: set[str],
        available: set[str],
        storage_full: set[str],
    ) -> list[str]:
        """Paper filter: availability, in-use, cloudlet (callers pass the
        sender's cloudlet peers), storage headroom."""
        return [
            h
            for h in peers
            if h != sender
            and h in available
            and h not in in_use
            and h not in storage_full
        ]

    def place(
        self,
        sender: str,
        peers: list[str],
        fail_prob: dict[str, float],
        *,
        in_use: set[str],
        available: set[str],
        storage_full: set[str],
    ) -> tuple[list[str], float]:
        """Choose receivers for a snapshot taken on ``sender``.

        ``peers`` = sender's cloudlet co-members; ``fail_prob`` from the
        reliability registry. Candidates are sorted by ascending failure
        probability (= descending reliability) before the first-n rule.
        """
        cands = self.filter_candidates(
            sender, peers, in_use=in_use, available=available,
            storage_full=storage_full,
        )
        cands.sort(key=lambda h: (fail_prob[h], h))
        return select_receivers(
            cands, fail_prob,
            target=self.target_joint_failure,
            max_receivers=self.max_receivers,
        )

    # -- bookkeeping -----------------------------------------------------------
    def record_placement(
        self,
        guest_id: str,
        receivers: list[str],
        joint: float,
        *,
        size_bytes: int,
        now: float,
        lease_ids: list[int] | None = None,
    ) -> SnapshotMeta:
        """Register a new snapshot version; returns its metadata.

        Only the most recent snapshot is kept (the previous version's
        replicas are superseded — receivers overwrite on push).
        ``lease_ids`` records the page leases the guest's cache depends on
        at capture time (spilled KV pages on neighbor hosts).
        """
        prev = self.latest.get(guest_id)
        version = (prev.version + 1) if prev else 1
        meta = SnapshotMeta(
            guest_id=guest_id,
            version=version,
            size_bytes=size_bytes,
            locations=list(receivers),
            joint_failure=joint,
            created_at=now,
            lease_ids=list(lease_ids or []),
        )
        self.latest[guest_id] = meta
        return meta

    def locations(self, guest_id: str) -> list[str]:
        meta = self.latest.get(guest_id)
        return list(meta.locations) if meta else []

    def leases_of(self, guest_id: str) -> list[int]:
        """Page leases the guest's latest snapshot depends on — the set a
        restorer must revalidate before trusting spilled-page stubs."""
        meta = self.latest.get(guest_id)
        return list(meta.lease_ids) if meta else []

    def drop_host(self, host_id: str) -> None:
        """A host left/failed: its stored replicas are gone."""
        for meta in self.latest.values():
            if host_id in meta.locations:
                meta.locations.remove(host_id)

    def restore_source(self, guest_id: str, *, available: set[str],
                       reliability_rank: list[str]) -> str | None:
        """Pick the most reliable available holder of the latest snapshot."""
        locs = [h for h in self.locations(guest_id) if h in available]
        if not locs:
            return None
        order = {h: i for i, h in enumerate(reliability_rank)}
        locs.sort(key=lambda h: order.get(h, math.inf))
        return locs[0]

    def forget(self, guest_id: str) -> list[str]:
        """After a restore (or job completion) delete remaining replicas;
        returns the hosts that must discard their copy (paper: 'all hosts
        that store the restored snapshot are instructed to delete it')."""
        meta = self.latest.pop(guest_id, None)
        return list(meta.locations) if meta else []

    def to_state(self) -> dict:
        return {
            g: dict(
                version=m.version, size_bytes=m.size_bytes,
                locations=list(m.locations), joint_failure=m.joint_failure,
                created_at=m.created_at, lease_ids=list(m.lease_ids),
            )
            for g, m in self.latest.items()
        }

    @classmethod
    def from_state(cls, state: dict, **kw) -> "SnapshotScheduler":
        s = cls(**kw)
        for g, m in state.items():
            s.latest[g] = SnapshotMeta(guest_id=g, **m)
        return s
