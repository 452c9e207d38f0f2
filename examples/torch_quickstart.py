"""Quickstart on the PyTorch port: stand up an ad hoc cloud from simulated
volunteer hosts, submit jobs, watch reliability scheduling + P2P snapshots
do their thing (``examples/quickstart.py``, through ``repro_torch``).

The runtime is host code: a simulated fleet and clock, with no device
work, so the example takes no arguments.

    PYTHONPATH=src python examples/torch_quickstart.py
"""

from repro_torch.core import AdHocCloudSim, SimParams
from repro_torch.core.events import nagios_like_trace

# 1) an ad hoc cloud of 12 sporadically-available hosts (one cloudlet)
params = SimParams(
    n_hosts=12,
    seed=0,
    continuity=True,            # the paper's snapshot/restore protocol
    snapshot_interval_s=120.0,  # periodic P2P snapshots
    guest_fail_per_hour=0.5,    # VMs also crash on their own sometimes
)
cloud = AdHocCloudSim(params)

# 2) hosts are unreliable: replay a synthetic Nagios-style failure trace
trace = nagios_like_trace(12, duration=3600.0, seed=7, mean_uptime=1800.0)
cloud.apply_trace(trace)
print(f"fleet: {len(cloud.host_ids)} hosts, "
      f"{sum(trace.n_failures(h) for h in trace.host_ids)} failures "
      f"in the next simulated hour")

# 3) a cloud user submits jobs on the fly (work_creator daemon)
cloud.submit(work_units=900.0, n_jobs=6)   # six 15-minute jobs

# 4) run the hour; the server schedules to the most reliable hosts,
#    clients snapshot P2P, failures trigger restores on other hosts
stats = cloud.run_until_settled(max_duration=2 * 3600.0)

print(f"\ncompleted {stats['completed']}/{stats['submitted']} jobs "
      f"({stats['completion_rate']:.0%})")
print(f"snapshot restores: {stats['restores']}   "
      f"restarts from zero: {stats['restarts_from_zero']}")
print(f"mean makespan: {stats['mean_makespan']:.0f}s "
      f"(pure work: 900s)")

# 5) inspect the reliability table the scheduler used (paper §III-B)
print("\nhost reliabilities after the hour:")
for h in cloud.server.reliability.ranked()[:5]:
    rec = cloud.server.reliability.get(h)
    print(f"  {h}: {rec.reliability():5.1f}%  "
          f"(assigned {rec.jobs_assigned}, completed {rec.jobs_completed}, "
          f"failures {rec.nf})")
