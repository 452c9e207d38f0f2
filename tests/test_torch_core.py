"""The port's ad hoc cloud runtime (``repro_torch/core/``) against the JAX
package's.

- every case of ``tests/test_server.py``, ``test_reliability.py``,
  ``test_snapshot.py``, ``test_availability.py``, ``test_faults.py``,
  ``test_backoff.py``, ``test_simulation.py`` and ``test_cloud_sim.py``,
  run once on each package: on the port, the test file's own source with
  every ``repro.`` import retargeted to ``repro_torch.`` (:func:`ported`),
  inline imports included;
- the same inputs give the same outputs in both packages: seeded failure
  traces, fault plans and backoff draws; an :class:`AdHocCloudSim` over
  the same ``SimParams`` and trace gives the same event log and metrics;
- an :class:`AdHocServer`'s ``to_state`` loads across packages both ways,
  and the loaded server keeps scheduling as the original does.

:func:`ported`, :func:`cases` and :func:`run_case` serve
``tests/test_torch_checkpoint.py`` and ``tests/test_torch_batch.py`` too.
"""

import ast
import enum
import importlib
import inspect
import json
import re
import sys
import types
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro.core.backoff as ref_backoff  # noqa: E402
import repro.core.cloud as ref_cloud  # noqa: E402
import repro.core.events as ref_events  # noqa: E402
import repro.core.faults as ref_faults  # noqa: E402
import repro.core.server as ref_server  # noqa: E402
import repro_torch.core.backoff as port_backoff  # noqa: E402
import repro_torch.core.cloud as port_cloud  # noqa: E402
import repro_torch.core.events as port_events  # noqa: E402
import repro_torch.core.faults as port_faults  # noqa: E402
import repro_torch.core.server as port_server  # noqa: E402

TESTS = Path(__file__).resolve().parent
CORE_TESTS = ("test_server", "test_reliability", "test_snapshot",
              "test_availability", "test_faults", "test_backoff",
              "test_simulation", "test_cloud_sim")
PACKAGES = ("repro", "repro_torch")


def ported(name: str) -> types.ModuleType:
    """``tests/<name>.py`` with every ``repro.`` retargeted to
    ``repro_torch.``: the reference's cases, on the port's modules."""
    key = f"{name}__on_repro_torch"
    if key not in sys.modules:
        path = TESTS / f"{name}.py"
        mod = types.ModuleType(key)
        mod.__file__ = str(path)
        code = re.sub(r"\brepro\.", "repro_torch.", path.read_text())
        sys.modules[key] = mod
        exec(compile(code, str(path), "exec"), mod.__dict__)
    return sys.modules[key]


def module_of(name: str, package: str) -> types.ModuleType:
    """The test module ``name`` as written (``repro``) or retargeted to
    the port (``repro_torch``)."""
    return importlib.import_module(name) if package == "repro" else ported(name)


def cases(name: str) -> list[str]:
    """Every test of ``tests/<name>.py``: ``func`` or ``Class::method``."""
    out = []
    for node in ast.parse((TESTS / f"{name}.py").read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith("test"):
            out.append(node.name)
        elif isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            out += [f"{node.name}::{m.name}" for m in node.body
                    if isinstance(m, ast.FunctionDef)
                    and m.name.startswith("test")]
    return out


def run_case(mod: types.ModuleType, case: str, **fixtures):
    """Call one case of ``mod``, handing it the fixtures it names."""
    if "::" in case:
        cls, meth = case.split("::")
        fn = getattr(getattr(mod, cls)(), meth)
    else:
        fn = getattr(mod, case)
    return fn(**{p: fixtures[p] for p in inspect.signature(fn).parameters})


CORE_CASES = [(n, c) for n in CORE_TESTS for c in cases(n)]


def test_every_reference_case_is_collected():
    assert len(CORE_CASES) >= 70
    assert {n for n, _ in CORE_CASES} == set(CORE_TESTS)
    # the retargeted modules hold the port's classes
    assert ported("test_server").AdHocServer is port_server.AdHocServer
    assert ported("test_cloud_sim").AdHocCloudSim is port_cloud.AdHocCloudSim


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("name,case", CORE_CASES,
                         ids=[f"{n}::{c}" for n, c in CORE_CASES])
def test_reference_case(name, case, package, tmp_path):
    run_case(module_of(name, package), case, tmp_path=tmp_path)


# ---------------------------------------------------------------------------
# same inputs, same outputs, across packages
# ---------------------------------------------------------------------------


def _plain(obj):
    """A JSON-able view of log entries and stats (enums by value)."""
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        seq = sorted(obj) if isinstance(obj, (set, frozenset)) else obj
        return [_plain(v) for v in seq]
    return obj


def test_seeded_traces_and_plans_equal_the_reference():
    a = ref_events.nagios_like_trace(9, 7200.0, seed=11, mean_uptime=900.0)
    b = port_events.nagios_like_trace(9, 7200.0, seed=11, mean_uptime=900.0)
    assert a.to_json() == b.to_json()
    assert port_events.FailureTrace.from_json(a.to_json()).to_json() == \
        a.to_json()
    hosts = [f"h{i}" for i in range(9)]
    for kw in (dict(seed=4, crash_window=(6.0, 14.0)),
               dict(seed=7, crash_window=(1.0, 30.0))):
        a = ref_faults.FaultPlan.seeded(hosts, **kw)
        b = port_faults.FaultPlan.seeded(hosts, **kw)
        assert [vars(e) for e in a.events] == [vars(e) for e in b.events]
    a = ref_backoff.JitteredBackoff(2.0, 60.0, jitter=0.3, seed=3)
    b = port_backoff.JitteredBackoff(2.0, 60.0, jitter=0.3, seed=3)
    assert [a.next_delay() for _ in range(12)] == \
        [b.next_delay() for _ in range(12)]


@pytest.mark.parametrize("continuity", [True, False])
def test_cloud_sim_log_and_metrics_equal_the_reference(continuity):
    """The paper-§IV harness: 12 hosts under a seeded Nagios-like trace,
    guest failures and snapshots, 8 jobs — the same event log, event for
    event, and the same metrics in both packages."""
    out = []
    for cloud, events in ((ref_cloud, ref_events), (port_cloud, port_events)):
        sim = cloud.AdHocCloudSim(cloud.SimParams(
            n_hosts=12, seed=3, continuity=continuity,
            snapshot_interval_s=120.0, guest_fail_per_hour=1.0))
        sim.apply_trace(events.nagios_like_trace(
            12, 2 * 3600.0, seed=11, mean_uptime=1200.0))
        sim.submit(work_units=1500.0, n_jobs=8)
        stats = sim.run_until_settled(6 * 3600.0)
        out.append((_plain(stats), _plain(sim.server.log),
                    _plain(sim.server.to_state())))
    assert out[0][0] == out[1][0]
    assert len(out[0][1]) > 100
    assert out[0][1] == out[1][1]
    assert out[0][2] == out[1][2]


def _busy_server(mod):
    """A server mid-run: 4 hosts, two jobs running (one with a placed
    snapshot), and host ``d`` silent past the 2-minute rule."""
    srv = mod.AdHocServer(failure_timeout=120.0)
    srv.create_cloudlet("cl", "svc")
    for h in ("a", "b", "c", "d"):
        srv.register_host(h, 0.0, cloudlets=["cl"])
    j0 = srv.submit_job("cl", 50.0, now=0.0)
    j1 = srv.submit_job("cl", 80.0, now=1.0)
    runner = srv.jobs[j0].assigned_host
    srv.report_snapshot(runner, j0, [h for h in "abcd" if h != runner],
                        0.02, 128, now=10.0)
    for h in ("a", "b", "c"):
        srv.poll(h, 100.0)
    srv.tick(200.0)
    return srv, j0, j1


@pytest.mark.parametrize("src,dst", [("repro", "repro_torch"),
                                     ("repro_torch", "repro")])
def test_server_state_loads_across_packages(src, dst):
    mods = {"repro": ref_server, "repro_torch": port_server}
    srv, j0, j1 = _busy_server(mods[src])
    state = json.loads(json.dumps(srv.to_state()))
    clone = mods[dst].AdHocServer.from_state(state)
    assert _plain(clone.to_state()) == _plain(srv.to_state())
    # both keep operating alike: the same polls, sweep and completions
    for s in (srv, clone):
        for h in ("a", "b", "c", "d"):
            s.poll(h, 300.0)
        s.tick(300.0)
        for jid in (j0, j1):
            job = s.jobs[jid]
            if job.assigned_host is not None:
                s.report_completion(job.assigned_host, jid, now=310.0)
    assert _plain(clone.to_state()) == _plain(srv.to_state())
    assert clone.completion_stats() == srv.completion_stats()
