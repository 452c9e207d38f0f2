"""The paper's ad hoc cloud runtime, as far as the port needs it so far:
host reliability (§III-B, :mod:`~repro_torch.core.reliability`) and
cloudlets with their page leases (§II-A, :mod:`~repro_torch.core.cloudlet`),
which the serving engine's spill tier lends cold KV pages through. The rest
of ``repro/core/`` is ROADMAP Queue 1, item 8."""

from repro_torch.core.cloudlet import (
    Cloudlet,
    CloudletRegistry,
    LeaseTable,
    PageLease,
)
from repro_torch.core.reliability import (
    HostRecord,
    ReliabilityRegistry,
    host_reliability,
)

__all__ = [
    "Cloudlet",
    "CloudletRegistry",
    "HostRecord",
    "LeaseTable",
    "PageLease",
    "ReliabilityRegistry",
    "host_reliability",
]
