"""Host reliability (paper §III-B) — the formula, verbatim.

::

    host_reliability = 0               if NF == CA
                     = 100             if NF == 0
                     = (CC / CA) * 100 otherwise

where NF = total host + guest failures, CA = cloud jobs assigned,
CC = cloud jobs completed. Reliability is (re)calculated when a job
completes, when a guest becomes non-operational, or when the host misses
its 2-minute poll window — :class:`ReliabilityRegistry` is the Job/VM
Service database table that stores it alongside each candidate host.

Copied unchanged from ``repro/core/reliability.py`` (plain Python), so that
the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass


def host_reliability(ca: int, cc: int, nf: int) -> float:
    """The paper's formula. Returns a percentage clamped to [0, 100].

    Inputs are counters and must be non-negative; negatives raise
    ``ValueError`` (an ``assert`` would vanish under ``python -O`` and a
    corrupted counter would silently produce a nonsense score). The
    zero-denominator cases the formula leaves open are pinned down
    explicitly: a fresh host (CA == NF == 0) is fully reliable, a host
    with failures but no assignments (CA == 0, NF > 0 — died while idle)
    is fully unreliable, and CC > CA (double-reported completions) caps
    at 100 rather than overflowing.
    """
    if ca < 0 or cc < 0 or nf < 0:
        raise ValueError(f"negative reliability counters: {(ca, cc, nf)}")
    if nf == ca:
        # includes the CA == 0, NF == 0 fresh-host case only when NF==CA==0
        # is caught by the NF == 0 branch below per the paper's ordering.
        if nf == 0:
            return 100.0
        return 0.0
    if nf == 0:
        return 100.0
    if ca == 0:
        # failures recorded before any assignment (host died while idle);
        # not covered by the paper's formula — treat like the NF==CA case.
        return 0.0
    return min(100.0, max(0.0, (cc / ca) * 100.0))


@dataclass
class HostRecord:
    """Per-host reliability factors (paper §III-B items 1-4)."""

    host_id: str
    jobs_assigned: int = 0      # (1) CA
    jobs_completed: int = 0     # (2) CC
    host_failures: int = 0      # (3) termination / hardware / OS failures
    guest_failures: int = 0     # (4) VM config/instantiation/exec/shutdown
    resource_load: float = 0.0  # (5) current load, reported by the client
    storage_used: int = 0       # bytes of ad hoc data (snapshots, client)
    storage_limit: int = 1 << 62  # host-user-set cap (regular BOINC pref)
    corrupt_results: int = 0    # quorum-rejected results (batch tier)
    quarantined_until: float = 0.0  # no placements before this sim time

    @property
    def nf(self) -> int:
        return self.host_failures + self.guest_failures

    def reliability(self) -> float:
        return host_reliability(self.jobs_assigned, self.jobs_completed, self.nf)

    def failure_probability(self) -> float:
        """P(this host fails a job) = 1 - reliability, clamped to [0, 1]."""
        return min(1.0, max(0.0, 1.0 - self.reliability() / 100.0))

    def storage_full(self) -> bool:
        return self.storage_used >= self.storage_limit


class ReliabilityRegistry:
    """The server-side table of host reliability records.

    Beyond the paper's §III-B factors it tracks *error quarantine* for
    the verified batch tier: a host whose results keep losing the hash
    quorum vote is suspended from placement for exponentially growing
    windows (``quarantine_base_s * 2^excess``), on top of the reliability
    drop each corrupt result already causes.
    """

    def __init__(self, *, quarantine_after: int = 3,
                 quarantine_base_s: float = 300.0):
        self._records: dict[str, HostRecord] = {}
        self.quarantine_after = quarantine_after
        self.quarantine_base_s = quarantine_base_s

    # -- membership ----------------------------------------------------------
    def add_host(self, host_id: str, *, storage_limit: int | None = None
                 ) -> HostRecord:
        rec = self._records.get(host_id)
        if rec is None:
            rec = HostRecord(host_id)
            if storage_limit is not None:
                rec.storage_limit = storage_limit
            self._records[host_id] = rec
        return rec

    def __contains__(self, host_id: str) -> bool:
        return host_id in self._records

    def get(self, host_id: str) -> HostRecord:
        return self._records[host_id]

    def hosts(self) -> list[str]:
        return list(self._records)

    # -- factor updates (paper: recalculated on completion/failure/timeout) --
    def record_assignment(self, host_id: str) -> None:
        self.add_host(host_id).jobs_assigned += 1

    def record_completion(self, host_id: str) -> None:
        self.add_host(host_id).jobs_completed += 1

    def record_host_failure(self, host_id: str) -> None:
        self.add_host(host_id).host_failures += 1

    def record_guest_failure(self, host_id: str) -> None:
        self.add_host(host_id).guest_failures += 1

    def record_load(self, host_id: str, load: float) -> None:
        self.add_host(host_id).resource_load = load

    def record_storage(self, host_id: str, used: int) -> None:
        self.add_host(host_id).storage_used = used

    def record_corrupt_result(self, host_id: str, now: float = 0.0) -> None:
        """Quorum rejected this host's result (batch tier feedback).

        Counts as a guest failure — the §III-B score drops, routing
        placement away — and past ``quarantine_after`` rejections the
        host is quarantined for exponentially growing windows.
        """
        rec = self.add_host(host_id)
        rec.corrupt_results += 1
        rec.guest_failures += 1
        excess = rec.corrupt_results - self.quarantine_after
        if excess >= 0:
            window = self.quarantine_base_s * (2 ** min(excess, 6))
            rec.quarantined_until = max(rec.quarantined_until, now + window)

    def is_quarantined(self, host_id: str, now: float) -> bool:
        rec = self._records.get(host_id)
        return bool(rec and now < rec.quarantined_until)

    # -- queries --------------------------------------------------------------
    def reliability(self, host_id: str) -> float:
        return self._records[host_id].reliability()

    def failure_probability(self, host_id: str) -> float:
        return self._records[host_id].failure_probability()

    def ranked(self, candidates: list[str] | None = None) -> list[str]:
        """Host ids by descending reliability (ties: stable by id)."""
        ids = self.hosts() if candidates is None else list(candidates)
        return sorted(
            ids, key=lambda h: (-self._records[h].reliability(), h)
        )

    # -- snapshot/restore of the registry itself (server replication) --------
    def to_state(self) -> dict:
        return {
            h: dict(
                jobs_assigned=r.jobs_assigned,
                jobs_completed=r.jobs_completed,
                host_failures=r.host_failures,
                guest_failures=r.guest_failures,
                resource_load=r.resource_load,
                storage_used=r.storage_used,
                storage_limit=r.storage_limit,
                corrupt_results=r.corrupt_results,
                quarantined_until=r.quarantined_until,
            )
            for h, r in self._records.items()
        }

    @classmethod
    def from_state(cls, state: dict) -> "ReliabilityRegistry":
        reg = cls()
        for h, kv in state.items():
            reg._records[h] = HostRecord(h, **kv)
        return reg
