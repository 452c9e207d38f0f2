"""The port's verified batch tier (``repro_torch/serving/batch.py``)
against the JAX package's.

- every case of ``tests/test_batch.py`` runs twice on REDUCED ``qwen3-8b``
  with the same weights (the reference's ``init(jax.random.key(0))``,
  handed across by the bridge): as written, on the reference's
  ``BatchMaster`` and engines, and retargeted to the port
  (``test_torch_core.ported``) on the port's, on the CPU. Each case keeps
  its own assertions (job states, re-issue causes, quorum, results equal
  to a trusted engine's from the same factory); beside them, every
  summary ``BatchMaster.run`` returns, every master's counters, workunit
  states and votes and its server's event log equal the jitted
  reference's, and the port's trusted engine gives the tokens of the
  reference run op by op (ROADMAP Queue 3, P1);
- the teardown the batch tier relies on: a dropped ``ServeEngine`` is
  freed by reference counting alone (no cycle through its slot
  lifecycle), so a replica's page pool goes when its workunit is
  collected, cancelled or superseded, with the cyclic collector off.
"""

import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import repro.serving.batch as ref_batch  # noqa: E402
import repro_torch.serving.batch as port_batch  # noqa: E402
import test_batch as ref_tests  # noqa: E402
from repro.configs import REDUCED  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core.server import AdHocServer  # noqa: E402
from repro_torch.core.simulation import SimClock  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from test_torch_core import cases, module_of, run_case  # noqa: E402

torch.set_num_threads(1)
BATCH_CASES = cases("test_batch")
PACKAGES = {"repro": ref_batch, "repro_torch": port_batch}


@pytest.fixture(scope="module")
def both():
    """Each package's ``qwen`` and ``factory`` fixtures of
    ``tests/test_batch.py``, on the same weights."""
    cfg = REDUCED["qwen3-8b"]
    jm = ref_get_model(cfg)
    jp = jm.init(jax.random.key(0))
    tcfg = get("qwen3-8b", reduced=True)
    tm = get_model(tcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tm,
                               device="cpu")
    return {
        "repro": dict(qwen=(cfg, jm, jp), factory=ref_batch.make_engine_factory(
            jm, jp, **ref_tests.ENGINE_KW)),
        "repro_torch": dict(
            qwen=(tcfg, tm, tp), factory=port_batch.make_engine_factory(
                tm, tp, device="cpu", **ref_tests.ENGINE_KW)),
    }


def _record(mod, batch_mod, monkeypatch) -> dict:
    """Record every master a case builds, every summary its ``run``
    returns and every trusted engine's prompts and tokens
    (``test_batch.reference``)."""
    rec: dict = {"masters": [], "summaries": [], "trusted": []}
    init, run = batch_mod.BatchMaster.__init__, batch_mod.BatchMaster.run
    trusted = mod.reference

    def init_(self, *args, **kw):
        init(self, *args, **kw)
        rec["masters"].append(self)

    def run_(self, *args, **kw):
        out = run(self, *args, **kw)
        rec["summaries"].append(out)
        return out

    def trusted_(factory, ps, *args):
        out = trusted(factory, ps, *args)
        rec["trusted"].append(((ps, *args), out))
        return out

    monkeypatch.setattr(batch_mod.BatchMaster, "__init__", init_)
    monkeypatch.setattr(batch_mod.BatchMaster, "run", run_)
    monkeypatch.setattr(mod, "reference", trusted_)
    return rec


def _counters(rec: dict) -> dict:
    """What a case's masters did, tokens aside: run summaries, counters,
    job and workunit states, attempts, votes per result, and the server's
    event log with each digest masked."""
    def masked(log):
        return [(t, ev, {k: ("<digest>" if k == "digest" else v)
                         for k, v in kv.items()}) for t, ev, kv in log]

    return {
        "summaries": rec["summaries"],
        "stats": [m.stats for m in rec["masters"]],
        "jobs": [{j: b.state for j, b in m.jobs.items()}
                 for m in rec["masters"]],
        "wus": [{w: (u.state.value, u.attempts,
                     sorted(sorted(h) for h in u.results.values()))
                 for w, u in m.wus.items()} for m in rec["masters"]],
        "log": [masked(m.server.log) for m in rec["masters"]],
    }


def _digests(rec: dict) -> list:
    return [{w: (u.canonical, u.results) for w, u in m.wus.items()}
            for m in rec["masters"]] + [m.server.log for m in rec["masters"]]


def test_every_reference_case_is_collected():
    assert len(BATCH_CASES) >= 12


@pytest.mark.parametrize("case", BATCH_CASES)
def test_reference_case_on_both_packages(case, both, monkeypatch):
    """The case's own assertions in both packages; its counters equal the
    jitted reference's; the port's trusted engine's tokens equal the
    reference's run op by op (``jax.disable_jit``; ROADMAP Queue 3, P1:
    jitted, the reference breaks three exact ties of these scenarios the
    other way), and where the jitted reference gives the same tokens,
    every digest and vote equals its own too."""
    got = {}
    for package, batch_mod in PACKAGES.items():
        mod = module_of("test_batch", package)
        rec = _record(mod, batch_mod, monkeypatch)
        run_case(mod, case, **both[package])
        got[package] = rec
    ref, port = got["repro"], got["repro_torch"]
    want, have = _counters(ref), _counters(port)
    for key in want:
        assert have[key] == want[key], key
    assert [a for a, _ in port["trusted"]] == [a for a, _ in ref["trusted"]]
    monkeypatch.undo()
    with jax.disable_jit():
        op_by_op = [ref_tests.reference(both["repro"]["factory"], *args)
                    for args, _ in ref["trusted"]]
    assert [t for _, t in port["trusted"]] == op_by_op
    if [t for _, t in port["trusted"]] == [t for _, t in ref["trusted"]]:
        assert _digests(port) == _digests(ref)


# ---------------------------------------------------------------------------
# teardown: engines are freed by reference counting
# ---------------------------------------------------------------------------


@pytest.fixture
def no_gc():
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


@pytest.mark.parametrize("variant", ["plain", "restored", "draft"])
def test_dropped_engine_is_freed_without_the_collector(variant, both, no_gc):
    _, tm, tp = both["repro_torch"]["qwen"]
    kw = dict(ref_tests.ENGINE_KW, device="cpu")
    if variant == "draft":
        kw.update(draft=tm, draft_params=tp)
    eng = ServeEngine(tm, tp, **kw)
    eng.submit(list(range(1, 20)), max_new_tokens=4)
    eng.step()
    if variant == "restored":
        blob = eng.snapshot()
        eng = ServeEngine(tm, tp, **kw)
        eng.restore(blob)
    eng.run()
    ref = weakref.ref(eng)
    pool = weakref.ref(eng.cache["k_pages"])
    del eng
    assert ref() is None
    assert pool() is None


def test_batch_replicas_are_freed_as_they_retire(both, no_gc):
    """A churned job (a crash resumed from a snapshot, a slow host timed
    out, a corrupter outvoted): after every transitioner pass the live
    engines are exactly the active replicas', and none outlives the job."""
    cfg, _, _ = both["repro_torch"]["qwen"]
    factory = both["repro_torch"]["factory"]
    refs: list = []

    def tracked(host_id):
        eng = factory(host_id)
        refs.append(weakref.ref(eng))
        return eng

    srv = AdHocServer(failure_timeout=4.0)
    srv.create_cloudlet("batch", "qwen3-8b")
    for h in (f"h{i}" for i in range(6)):
        srv.register_host(h, 0.0, cloudlets=["batch"])
    master = port_batch.BatchMaster(
        srv, "batch", tracked, replication=2, min_quorum=2, wu_pages=4,
        page_size=ref_tests.PAGE_SIZE, deadline_s=24.0, backoff_base_s=1.0,
        snapshot_every_s=3.0, decode_step_s=1.0)
    live_vs_active = []
    tick = master.tick

    def counted_tick(now, dt=0.0):
        tick(now, dt)
        live_vs_active.append((sum(r() is not None for r in refs),
                               sum(len(w.active) for w in master.wus.values())))

    master.tick = counted_tick
    ps = ref_tests.prompts(cfg, 4, seed=11)
    job = master.submit(ps, max_new_tokens=16, now=0.0)
    plan = port_batch.FaultPlan([
        port_batch.FaultEvent(at=0.0, kind="slow", host="h2", factor=10.0),
        port_batch.FaultEvent(at=0.0, kind="corrupt", host="h1"),
        port_batch.FaultEvent(at=7.0, kind="crash", host="h0")])
    summary = master.run(SimClock(), fault_plan=plan, max_ticks=300)
    assert summary["jobs"][job] == "completed"
    assert summary["reissued_crash"] >= 1
    assert summary["resumed_from_snapshot"] >= 1
    assert summary["quorum_rejections"] >= 1
    assert summary["timeouts"] >= 1
    assert len(refs) > 4
    assert all(live == active for live, active in live_vs_active)
    assert all(r() is None for r in refs)
