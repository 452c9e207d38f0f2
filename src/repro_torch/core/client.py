"""The ad hoc client (paper §III-C, Figure 4).

Host-side middleware around the guest VM:

- **Command Listener** — executes server commands delivered in poll
  responses (start/restore/delete/suspend — the server-controlled
  inversion of BOINC).
- **Resource Monitor** — watches host-user load; suspends the guest when
  the host user needs the machine and resumes when load drops (the
  low-interference property).
- **Failure Detection** — probes the guest every 10 s (VBoxManage
  analogue); failures are reported on the next poll.
- **P2P Snapshot** — periodically snapshots the guest and pushes it to the
  most reliable peers (placement per §III-D), then informs the server of
  the receiving hosts.

The client is transport-agnostic: it talks to the server through direct
method calls here (LAN deployment would swap in RPC) and pushes snapshot
bytes into peer :class:`~repro_torch.checkpoint.store.SnapshotStore` objects
(the ``pssh`` parallel-push analogue).

Copied from ``repro/core/client.py`` (plain Python), so that
the port imports nothing of the JAX package; only the
cross-references name the port's modules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.core.continuity import GuestRuntime
from repro_torch.core.server import AdHocServer, Command
from repro_torch.core.snapshot import SnapshotScheduler


@dataclass
class ResourceMonitor:
    """Suspend the guest while host-user load exceeds the limit for a
    sustained period; resume when it drops (paper §III-C)."""

    load_limit: float = 0.75
    sustain_s: float = 30.0
    _over_since: float | None = None

    def update(self, load: float, now: float, suspended: bool) -> str | None:
        """Returns "suspend" / "resume" / None."""
        if load > self.load_limit:
            if self._over_since is None:
                self._over_since = now
            if not suspended and now - self._over_since >= self.sustain_s:
                return "suspend"
        else:
            self._over_since = None
            if suspended:
                return "resume"
        return None


class AdHocClient:
    """One per host. Drives its guest under server control."""

    def __init__(
        self,
        host_id: str,
        server: AdHocServer,
        *,
        guest_factory: Callable[[str, str], GuestRuntime],
        peer_stores: dict[str, Any],      # host_id -> SnapshotStore
        local_store: Any,
        load_fn: Callable[[float], float] = lambda now: 0.0,
        monitor: ResourceMonitor | None = None,
        snapshot_target_failure: float = 0.05,
        max_snapshot_receivers: int = 16,
    ):
        self.host_id = host_id
        self.server = server
        self.guest_factory = guest_factory
        self.peer_stores = peer_stores
        self.local_store = local_store
        self.load_fn = load_fn
        self.monitor = monitor or ResourceMonitor()
        self.placer = SnapshotScheduler(
            target_joint_failure=snapshot_target_failure,
            max_receivers=max_snapshot_receivers,
        )
        self.guest: GuestRuntime | None = None
        self.suspended = False
        self.up = True                    # host power state (trace-driven)
        self._guest_failed_pending = False
        self._peer_fail_prob: dict[str, float] = {}

    # ----------------------------------------------------------------- poll
    def poll(self, now: float) -> list[Command]:
        """Periodic 60-second poll: report state, receive peers + commands."""
        if not self.up:
            return []
        guest_ok = not self._guest_failed_pending
        resp = self.server.poll(
            self.host_id,
            now,
            load=self.load_fn(now),
            guest_ok=guest_ok,
            storage_used=getattr(self.local_store, "used_bytes", 0),
        )
        if not guest_ok:
            self._guest_failed_pending = False
            self.guest = None
        self._peer_fail_prob = {h: p for h, _, p in resp.peers}
        for cmd in resp.commands:
            self.execute(cmd, now)
        return resp.commands

    # ------------------------------------------------------- command listener
    def execute(self, cmd: Command, now: float) -> None:
        if not self.up:
            return
        if cmd.kind == "start_guest":
            self.guest = self.guest_factory(cmd.args["guest_id"],
                                            cmd.args["job_id"])
            self.guest.start(cmd.args.get("payload"), now)
        elif cmd.kind == "restore":
            job_id = cmd.args["job_id"]
            source = cmd.args["source"]
            blob = self._fetch_snapshot(source, job_id)
            self.guest = self.guest_factory(cmd.args["guest_id"], job_id)
            self.guest.start(None, now)
            if blob is not None:
                self.guest.restore(blob)
            # the restoring host also deletes its (now superseded) copy
            self.local_store.delete(job_id)
        elif cmd.kind == "delete_snapshot":
            self.local_store.delete(cmd.args["job_id"])
        elif cmd.kind == "suspend":
            self._set_suspended(True, now)
        elif cmd.kind == "resume":
            self._set_suspended(False, now)
        elif cmd.kind == "stop_guest":
            if self.guest is not None:
                self.guest.stop()
                self.guest = None
        else:  # pragma: no cover - defensive
            raise ValueError(f"unknown command {cmd.kind!r}")

    def _fetch_snapshot(self, source: str, job_id: str) -> bytes | None:
        if source == self.host_id:
            return self.local_store.get(job_id)
        store = self.peer_stores.get(source)
        return store.get(job_id) if store is not None else None

    # ------------------------------------------------------ resource monitor
    def monitor_resources(self, now: float) -> None:
        if not self.up or self.guest is None:
            return
        action = self.monitor.update(self.load_fn(now), now, self.suspended)
        if action == "suspend":
            self._set_suspended(True, now)
            self.server.report_suspend(self.host_id, now, True)
        elif action == "resume":
            self._set_suspended(False, now)
            self.server.report_suspend(self.host_id, now, False)

    def _set_suspended(self, flag: bool, now: float) -> None:
        self.suspended = flag
        if self.guest is not None and hasattr(self.guest, "suspended"):
            self.guest.suspended = flag

    # ------------------------------------------------------ failure detection
    def probe_guest(self, now: float) -> bool:
        """10-second guest liveness probe. Returns guest health."""
        if not self.up or self.guest is None:
            return True
        if not self.guest.healthy():
            self._guest_failed_pending = True
            return False
        return True

    # --------------------------------------------------------- p2p snapshot
    def snapshot_guest(self, now: float) -> list[str] | None:
        """Capture + place a snapshot of the running guest (§III-D).

        Returns receiver host ids, or None if no guest / placement failed.
        """
        if not self.up or self.guest is None or self.suspended:
            return None
        if not self.guest.healthy():
            return None
        blob = self.guest.snapshot()
        if hasattr(self.guest, "note_snapshot_pause"):
            self.guest.note_snapshot_pause(now)
        peers, in_use, available, storage_full = self.server.snapshot_policy(
            self.host_id
        )
        fail_prob = dict(self._peer_fail_prob)
        for h in peers:
            fail_prob.setdefault(h, 1.0)   # unknown peers treated as unreliable
        receivers, joint = self.placer.place(
            self.host_id, peers, fail_prob,
            in_use=in_use, available=available, storage_full=storage_full,
        )
        if not receivers:
            return None
        # pssh-style parallel push: write into each receiver's store
        # (keep-only-latest: put() overwrites the previous version).
        delivered = []
        for r in receivers:
            store = self.peer_stores.get(r)
            if store is None:
                continue
            if store.put(self.guest.job_id, blob):
                delivered.append(r)
        if not delivered:
            return None
        self.server.report_snapshot(
            self.host_id, self.guest.job_id, delivered, joint,
            len(blob), now,
        )
        return delivered

    # --------------------------------------------------------------- running
    def maybe_report_completion(self, now: float) -> bool:
        g = self.guest
        if g is None or not self.up:
            return False
        if getattr(g, "complete", lambda: False)():
            self.server.report_completion(self.host_id, g.job_id, now)
            self.guest = None
            return True
        return False

    # ------------------------------------------------------------- power
    def go_down(self, now: float) -> None:
        """Host failure (trace event): everything on it dies silently."""
        self.up = False
        if self.guest is not None:
            self.guest.stop()
            self.guest = None
        self.local_store.clear()
        self.suspended = False

    def come_up(self, now: float) -> None:
        self.up = True
        self.server.host_returned(self.host_id, now)
