"""Cloudlets (paper §II-A): named guest groups offering one service.

A cloudlet is the scheduling and snapshot-placement scope: "only hosts
within a specific cloudlet need to be taken into account when scheduling a
job destined for that cloudlet", and snapshot receivers are filtered by
"the sender's cloudlet membership" (§III-D). A guest may belong to several
cloudlets when jobs needing different environments share it.

Here a cloudlet's *service* is an architecture id (e.g. a ``qwen3-8b``
serving cloudlet) or a training job family; its members are host ids.

**Page leases** extend the cloudlet into a memory-harvesting scope: a
member host may *lend* spare memory (cold KV-cache pages, see
:class:`repro_torch.serving.kvcache.RemotePagePool`) to a neighbor. The
:class:`LeaseTable` is the cloudlet-scoped bookkeeping of those loans —
who lent what to whom — and is what makes borrowed memory *revocable*:
when a holder leaves a cloudlet (churn), every lease it holds in that
scope is invalidated, so lenders discover the loss at recall time and
fall back to recomputing, never to reading a vanished page.

Copied from ``repro/core/cloudlet.py`` (plain Python), so that the port
imports nothing of the JAX package; only the cross-references name the
port's modules.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Cloudlet:
    name: str
    service: str                       # e.g. arch id / environment label
    members: set[str] = field(default_factory=set)

    def join(self, host_id: str) -> None:
        self.members.add(host_id)

    def leave(self, host_id: str) -> None:
        self.members.discard(host_id)

    def __contains__(self, host_id: str) -> bool:
        return host_id in self.members


@dataclass
class PageLease:
    """One page-sized loan of a lender's data held by a peer host."""

    lease_id: int
    cloudlet: str                      # scope the loan was granted in
    lender: str                        # host whose data is lent out
    holder: str                        # peer physically storing the page
    n_bytes: int


class LeaseTable:
    """Cloudlet-scoped bookkeeping of pages lent to peer hosts.

    The table records *who holds what for whom*; the lent payloads
    themselves travel through
    :class:`repro_torch.serving.kvcache.RemotePagePool`.
    Invariant: a lease is valid exactly while its holder remains a member
    of the cloudlet it was granted in — :meth:`invalidate_holder` (called
    by the registry on ``leave``/``leave_all``) revokes everything a
    departing host held, so a recall of a revoked lease misses instead of
    returning stale or vanished data.
    """

    def __init__(self):
        self._leases: dict[int, PageLease] = {}
        self._next = 1

    def __len__(self) -> int:
        return len(self._leases)

    def grant(self, cloudlet: str, lender: str, holder: str,
              n_bytes: int) -> PageLease:
        lease = PageLease(self._next, cloudlet, lender, holder, int(n_bytes))
        self._leases[lease.lease_id] = lease
        self._next += 1
        return lease

    def valid(self, lease_id: int) -> bool:
        return lease_id in self._leases

    def get(self, lease_id: int) -> PageLease | None:
        return self._leases.get(lease_id)

    def release(self, lease_id: int) -> PageLease | None:
        """Drop a lease (page recalled home, or its stub evicted)."""
        return self._leases.pop(lease_id, None)

    def held_by(self, host_id: str) -> list[PageLease]:
        return [m for m in self._leases.values() if m.holder == host_id]

    def of_lender(self, host_id: str) -> list[PageLease]:
        return [m for m in self._leases.values() if m.lender == host_id]

    def invalidate_holder(self, host_id: str,
                          cloudlet: str | None = None) -> list[int]:
        """Revoke every lease ``host_id`` holds (churn); returns the
        revoked lease ids so callers can count the lost pages."""
        gone = [
            i for i, m in self._leases.items()
            if m.holder == host_id
            and (cloudlet is None or m.cloudlet == cloudlet)
        ]
        for i in gone:
            del self._leases[i]
        return gone

    def to_state(self) -> dict:
        return {
            "next": self._next,
            "leases": [
                [m.lease_id, m.cloudlet, m.lender, m.holder, m.n_bytes]
                for m in self._leases.values()
            ],
        }

    @classmethod
    def from_state(cls, state: dict) -> "LeaseTable":
        t = cls()
        t._next = int(state.get("next", 1))
        for lease_id, cloudlet, lender, holder, n_bytes in state.get(
                "leases", []):
            t._leases[int(lease_id)] = PageLease(
                int(lease_id), cloudlet, lender, holder, int(n_bytes)
            )
        return t


class CloudletRegistry:
    def __init__(self):
        self._cloudlets: dict[str, Cloudlet] = {}
        self.leases = LeaseTable()

    def create(self, name: str, service: str) -> Cloudlet:
        if name.startswith("__"):
            # "__leases__" (and any future "__*" key) is reserved for
            # registry state serialization — a cloudlet named that would
            # silently vanish on a to_state/from_state round-trip
            raise ValueError(f"reserved cloudlet name {name!r}")
        if name in self._cloudlets:
            cl = self._cloudlets[name]
            assert cl.service == service, (name, cl.service, service)
            return cl
        cl = Cloudlet(name, service)
        self._cloudlets[name] = cl
        return cl

    def get(self, name: str) -> Cloudlet:
        return self._cloudlets[name]

    def __contains__(self, name: str) -> bool:
        return name in self._cloudlets

    def names(self) -> list[str]:
        return list(self._cloudlets)

    def join(self, name: str, host_id: str) -> None:
        self._cloudlets[name].join(host_id)

    def leave(self, name: str, host_id: str) -> list[int]:
        """A host leaves one cloudlet: its membership is dropped and every
        page lease it held in that scope is revoked (the pages left with
        it). Returns the revoked lease ids."""
        self._cloudlets[name].leave(host_id)
        return self.leases.invalidate_holder(host_id, cloudlet=name)

    def leave_all(self, host_id: str) -> list[int]:
        """Host churn/failure: leaves every cloudlet, revoking all leases
        the host held. Returns the revoked lease ids."""
        for cl in self._cloudlets.values():
            cl.leave(host_id)
        return self.leases.invalidate_holder(host_id)

    def of_host(self, host_id: str) -> list[str]:
        return [n for n, cl in self._cloudlets.items() if host_id in cl]

    def for_service(self, service: str) -> list[Cloudlet]:
        return [cl for cl in self._cloudlets.values() if cl.service == service]

    def members(self, name: str) -> list[str]:
        """Members of cloudlet ``name``, sorted for deterministic
        iteration (the batch tier's placement scope)."""
        return sorted(self._cloudlets[name].members)

    def peers(self, name: str, host_id: str) -> list[str]:
        """Other members of ``host_id``'s cloudlet ``name``."""
        return [h for h in self._cloudlets[name].members if h != host_id]

    def to_state(self) -> dict:
        state = {
            n: {"service": cl.service, "members": sorted(cl.members)}
            for n, cl in self._cloudlets.items()
        }
        if len(self.leases):
            # reserved key ("__" is not a valid cloudlet name); omitted
            # when empty so pre-lease snapshots round-trip byte-identically
            state["__leases__"] = self.leases.to_state()
        return state

    @classmethod
    def from_state(cls, state: dict) -> "CloudletRegistry":
        reg = cls()
        leases = state.get("__leases__")
        if leases is not None:
            reg.leases = LeaseTable.from_state(leases)
        for n, kv in state.items():
            if n == "__leases__":
                continue
            cl = reg.create(n, kv["service"])
            cl.members = set(kv["members"])
        return reg
