"""The paper's ad hoc cloud runtime, copied from ``repro/core/`` (plain
Python), so that the port imports nothing of the JAX package. Components
map 1:1 onto the paper's architecture:

- :mod:`repro_torch.core.reliability` — the ``host_reliability`` formula (§III-B).
- :mod:`repro_torch.core.availability` — heartbeat/availability checking (§III-A/C).
- :mod:`repro_torch.core.snapshot` — P2P snapshot placement (§III-D).
- :mod:`repro_torch.core.cloudlet` — cloudlets and their page leases (§II-A),
  which the serving engine's spill tier lends cold KV pages through.
- :mod:`repro_torch.core.server` — the ad hoc server (job service + VM service).
- :mod:`repro_torch.core.client` — the ad hoc client (monitor, probe, snapshot agent).
- :mod:`repro_torch.core.continuity` — the guest lifecycle contract.
- :mod:`repro_torch.core.events` — failure traces and replay (paper §IV).
- :mod:`repro_torch.core.faults` — seeded fault injection.
- :mod:`repro_torch.core.backoff` — jittered exponential backoff.
- :mod:`repro_torch.core.simulation` — deterministic discrete-event clock/loop.
- :mod:`repro_torch.core.cloud` — server, clients and guests on a simulated LAN.
"""

from repro_torch.core.reliability import (
    HostRecord,
    ReliabilityRegistry,
    host_reliability,
)
from repro_torch.core.snapshot import SnapshotScheduler, joint_failure_probability
from repro_torch.core.availability import AvailabilityChecker
from repro_torch.core.cloudlet import (
    Cloudlet,
    CloudletRegistry,
    LeaseTable,
    PageLease,
)
from repro_torch.core.server import AdHocServer, CloudJob, Command, JobState
from repro_torch.core.client import AdHocClient, ResourceMonitor
from repro_torch.core.cloud import AdHocCloudSim, SimParams
from repro_torch.core.simulation import EventLoop, SimClock

__all__ = [
    "AdHocServer",
    "CloudJob",
    "Command",
    "JobState",
    "AdHocClient",
    "ResourceMonitor",
    "AdHocCloudSim",
    "SimParams",
    "EventLoop",
    "SimClock",
    "HostRecord",
    "ReliabilityRegistry",
    "host_reliability",
    "SnapshotScheduler",
    "joint_failure_probability",
    "AvailabilityChecker",
    "Cloudlet",
    "CloudletRegistry",
    "LeaseTable",
    "PageLease",
]
