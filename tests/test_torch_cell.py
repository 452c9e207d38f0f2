"""The port's elastic serving cell (``repro_torch/serving/cell.py``)
against the JAX package's.

Every in-process case of ``tests/test_cell.py`` (its 9; the tenth, the
materialized cell on 8 forced host devices, runs a subprocess: its port,
on 8 gloo ranks, is ``tests/test_torch_materialize.py``) runs twice on REDUCED ``qwen3-8b`` with the same weights (the
reference's ``init(jax.random.key(0))``, handed across by the bridge):
as written, on the reference's cell and engines, and retargeted to the
port (``test_torch_core.ported``) on the port's, on the CPU. Each case
keeps its own assertions (streams equal a trusted engine's of the same
factory, the invariant raises). Beside them:

- every summary ``run()`` returns equals the reference's, counter for
  counter, but ``reshard_bytes_moved``, ``elapsed_s`` and
  ``goodput_tok_s``: the port stores the weights the reference casts
  before every use in bf16 where the reference's test holds f32, so the
  bytes differ, and with them the simulated seconds a re-shard takes.
  ``reshard_bytes_moved`` is held to the reference's rule
  (``repro/serving/cell.py:520-572``), computed here from the reference's
  ``spec_for_axes`` over each package's own leaves, re-shard by re-shard;
  the reference's own number obeys it too;
- the server's ``cell_*`` events come in the same kinds and order with the
  same fields (the bytes aside);
- the port's trusted engine (``test_cell.reference``) gives the tokens of
  the reference's run op by op (``jax.disable_jit``); jitted, the
  reference breaks five near ties of these scenarios the other way
  (ROADMAP Queue 3, P1: two in the clean serve, one in the stall, two in
  the shed's trusted run). Where it breaks none, the cells' committed streams are equal
  token for token; where it does, the port's engine teacher-forced on the
  jitted reference's tokens (as ``test_torch_engine._force_from``) agrees
  with each of them but at the recorded flips.

The reference cell calls ``AbstractMesh`` in the pair form
(``repro/serving/cell.py:536-537``) that jax 0.9.0 rejects (ROADMAP Queue
3, R1); here it runs under a shim that takes the pair form, set for each
test alone. Nothing of ``src/repro`` changes.
"""

import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.sharding  # noqa: E402

import repro.serving.batch as ref_batch  # noqa: E402
import repro.serving.cell as ref_cell  # noqa: E402
import repro_torch.serving.batch as port_batch  # noqa: E402
import repro_torch.serving.cell as port_cell  # noqa: E402
import test_cell as ref_tests  # noqa: E402
from repro.configs import REDUCED  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.parallel.partition import spec_for_axes as ref_spec  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core.server import AdHocServer  # noqa: E402
from repro_torch.core.simulation import SimClock  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from test_partition import FakeMesh  # noqa: E402
from test_torch_core import cases, module_of, run_case  # noqa: E402

torch.set_num_threads(1)
# the materialized case runs in a subprocess on 8 forced host devices; the
# port's runs on 8 gloo ranks in tests/test_torch_materialize.py
CELL_CASES = [c for c in cases("test_cell")
              if c != "test_materialized_cell_survives_churn_on_a_real_mesh"]
PACKAGES = {"repro": ref_cell, "repro_torch": port_cell}
# near ties the jitted reference breaks the other way (ROADMAP Queue 3,
# P1): streams of the case's trusted engine that differ from the port's
P1_FLIPS = {
    "TestCleanServe::test_matches_reference_with_no_faults": 2,
    "TestCrashResume::test_stall_below_min_hosts_then_rejoin_completes": 1,
    "TestShed::test_sheds_lowest_priority_and_reports_partial": 2,
}


@pytest.fixture(scope="module")
def both():
    """Each package's ``qwen`` and ``factory`` fixtures of
    ``tests/test_cell.py``, on the same weights."""
    cfg = REDUCED["qwen3-8b"]
    jm = ref_get_model(cfg)
    jp = jm.init(jax.random.key(0))
    tm = get_model(get("qwen3-8b", reduced=True))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tm,
                               device="cpu")
    return {
        "repro": dict(qwen=(cfg, jm, jp), factory=ref_batch.make_engine_factory(
            jm, jp, **ref_tests.ENGINE_KW)),
        "repro_torch": dict(
            qwen=(tm.cfg, tm, tp), factory=port_batch.make_engine_factory(
                tm, tp, device="cpu", **ref_tests.ENGINE_KW)),
    }


@pytest.fixture
def pair_form_mesh(monkeypatch):
    """``jax.sharding.AbstractMesh`` taking the pair form the reference
    cell passes (R1), for one test."""
    real = jax.sharding.AbstractMesh

    def shim(shape_tuple, *args, **kw):
        try:
            return real(shape_tuple, *args, **kw)
        except TypeError:       # jax 0.9.0: (axis_sizes, axis_names)
            return real(tuple(s for _, s in shape_tuple),
                        tuple(n for n, _ in shape_tuple))

    monkeypatch.setattr(jax.sharding, "AbstractMesh", shim)


def _record(mod, cell_mod, monkeypatch) -> dict:
    """Record every cell a case builds, every summary its ``run`` returns,
    each re-shard's layout inputs (the grid, the hosts lost since the last
    one, the members left, the leaves laid out and the bytes the cell says
    it moved), and every trusted engine's prompts and tokens
    (``test_cell.reference``)."""
    rec: dict = {"cells": [], "summaries": [], "relayouts": [],
                 "trusted": []}
    trusted = mod.reference

    def trusted_(factory, ps, *args):
        out = trusted(factory, ps, *args)
        rec["trusted"].append(((ps, *args), out))
        return out

    monkeypatch.setattr(mod, "reference", trusted_)
    cls = cell_mod.ElasticServeCell
    init, run, relayout = cls.__init__, cls.run, cls._relayout

    def init_(self, *args, **kw):
        init(self, *args, **kw)
        rec["cells"].append(self)

    def run_(self, *args, **kw):
        out = run(self, *args, **kw)
        rec["summaries"].append(out)
        return out

    def relayout_(self, grid, engine):
        entry = {"cell": len(rec["cells"]) - 1, "grid": tuple(grid),
                 "lost": self.stats["hosts_lost"] - self._losses_accounted,
                 "members": len(self.cell_hosts),
                 "params": _leaves(self.params_host),
                 "cache": _leaves(engine.cache),
                 "cache_shape": (engine.n_slots, engine.n_pages,
                                 engine.page_size)}
        entry["moved"] = relayout(self, grid, engine)
        rec["relayouts"].append(entry)
        return entry["moved"]

    monkeypatch.setattr(cls, "__init__", init_)
    monkeypatch.setattr(cls, "run", run_)
    monkeypatch.setattr(cls, "_relayout", relayout_)
    return rec


def _leaves(tree, prefix=()) -> dict:
    """path -> (shape, bytes per element) of a tree of nested dicts of
    numpy, jax or torch arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    size = (tree.element_size() if isinstance(tree, torch.Tensor)
            else np.dtype(tree.dtype).itemsize)
    return {prefix: (tuple(tree.shape), size)}


def _axes(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_axes(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree)}


def _rule_bytes(relayouts: list, model) -> list[int]:
    """The reference's byte rule (``repro/serving/cell.py:545-572``) over
    the recorded leaves, with the reference's partition rules and logical
    axes: a cell's first layout moves every byte; a later one every leaf
    whose spec changed, plus the lost hosts' share of the rest."""
    p_axes = _axes(model.param_axes())
    out, last = [], {}
    for r in relayouts:
        mesh = FakeMesh(data=r["grid"][0], model=r["grid"][1])
        c_axes = {(k,): tuple(v) for k, v in
                  model.paged_cache_axes(*r["cache_shape"]).items()}
        leaves = {("p",) + k: v for k, v in r["params"].items()}
        leaves.update({("c",) + k: v for k, v in r["cache"].items()})
        axes = {("p",) + k: v for k, v in p_axes.items()}
        axes.update({("c",) + k: v for k, v in c_axes.items()})
        assert set(axes) == set(leaves)
        specs = {k: tuple(ref_spec(axes[k], shape, mesh))
                 for k, (shape, _) in leaves.items()}
        nbytes = {k: int(np.prod(shape)) * size
                  for k, (shape, size) in leaves.items()}
        total = sum(nbytes.values())
        old = last.get(r["cell"])
        if old is None:
            moved = total
        else:
            delta = sum(n for k, n in nbytes.items() if specs[k] != old[k])
            frac = min(1.0, r["lost"] / max(1, r["members"] + r["lost"]))
            moved = delta + int(frac * (total - delta))
        last[r["cell"]] = specs
        out.append(moved)
    return out


UNCOMPARED = ("reshard_bytes_moved", "elapsed_s", "goodput_tok_s")


def _events(cell) -> list:
    """The server's ``cell_*`` events of ``cell``: kind and fields, the
    bytes moved aside."""
    return [(ev, {k: v for k, v in kv.items() if k != "bytes_moved"})
            for _, ev, kv in cell.server.log if ev.startswith("cell_")]


def test_every_in_process_case_is_collected():
    assert len(CELL_CASES) == 9
    assert {c.split("::")[0] for c in CELL_CASES} == {
        "TestCleanServe", "TestCrashResume", "TestStraggler", "TestShed",
        "TestGrow", "TestInvariant"}


@pytest.mark.parametrize("case", CELL_CASES)
def test_reference_case_on_both_packages(case, both, monkeypatch,
                                         pair_form_mesh):
    """The case's own assertions in both packages; then every summary
    counter, every ``cell_*`` event and every committed stream equal the
    reference's, and each package's bytes follow the reference's rule
    over its own leaves."""
    got = {}
    for package, cell_mod in PACKAGES.items():
        mod = module_of("test_cell", package)
        rec = _record(mod, cell_mod, monkeypatch)
        run_case(mod, case, **both[package])
        got[package] = rec
    ref, port = got["repro"], got["repro_torch"]
    assert len(port["cells"]) == len(ref["cells"]) >= 1
    assert len(port["summaries"]) == len(ref["summaries"])
    for want, have in zip(ref["summaries"], port["summaries"]):
        assert {k: v for k, v in have.items() if k not in UNCOMPARED} == \
            {k: v for k, v in want.items() if k not in UNCOMPARED}
    for want, have in zip(ref["cells"], port["cells"]):
        assert _events(have) == _events(want)
        assert {k: v for k, v in have.stats.items()
                if k != "reshard_bytes_moved"} == \
            {k: v for k, v in want.stats.items()
             if k != "reshard_bytes_moved"}
        assert {r.req_id: (r.state, len(r.committed))
                for r in have.requests.values()} == \
            {r.req_id: (r.state, len(r.committed))
             for r in want.requests.values()}
    jm = both["repro"]["qwen"][1]
    assert len(port["relayouts"]) == len(ref["relayouts"]) >= 1
    for rec in (ref, port):
        moved = [r["moved"] for r in rec["relayouts"]]
        assert moved == _rule_bytes(rec["relayouts"], jm)
        for i, cell in enumerate(rec["cells"]):
            assert cell.stats["reshard_bytes_moved"] == sum(
                r["moved"] for r in rec["relayouts"] if r["cell"] == i)
    # the port's bf16 weights move fewer bytes than the reference's f32
    assert sum(r["moved"] for r in port["relayouts"]) < \
        sum(r["moved"] for r in ref["relayouts"])

    # streams: the port's trusted engine against the reference run op by
    # op; against the jitted reference, equal but at the recorded flips
    assert [a for a, _ in port["trusted"]] == [a for a, _ in ref["trusted"]]
    monkeypatch.undo()
    with jax.disable_jit():
        op_by_op = [ref_tests.reference(both["repro"]["factory"], *args)
                    for args, _ in ref["trusted"]]
    assert [t for _, t in port["trusted"]] == op_by_op
    flips = sum(a != b for (_, want), (_, have) in zip(ref["trusted"],
                                                        port["trusted"])
                for a, b in zip(want, have))
    assert flips == P1_FLIPS.get(case, 0)
    if not flips:
        for want, have in zip(ref["cells"], port["cells"]):
            assert [r.committed for r in have.requests.values()] == \
                [r.committed for r in want.requests.values()]
    for args, want in ref["trusted"]:
        mismatches = _forced(both["repro_torch"]["factory"], *args,
                             tokens=want)
        assert mismatches == sum(
            a != b for a, b in zip(want, ref_tests.reference(
                both["repro_torch"]["factory"], *args)))


def _forced(factory, ps, max_new=ref_tests.MAX_NEW, *, tokens) -> int:
    """Serve ``ps`` on a fresh engine of ``factory`` teacher-forced on
    ``tokens`` (every decoded token; a prefill's first token cannot be
    forced): the tokens must come out, and the forced mismatches (the
    model's own choice differing) are returned."""
    eng = factory("__forced__")
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in ps]
    for _ in range(5000):
        if not eng.pending():
            break
        eng._admit()         # a lane admitted this step decodes forced too
        eng.step({r.req_id: tokens[i][len(r.generated)]
                  for i, r in enumerate(reqs)
                  if r.slot is not None and len(r.generated) < max_new})
    assert [list(r.generated) for r in reqs] == tokens
    return eng.stats["forced_mismatches"]


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------


def _cell(both, **kw):
    _, tm, tp = both["repro_torch"]["qwen"]
    srv = AdHocServer(failure_timeout=6.0)
    srv.create_cloudlet("cell", "qwen3-8b")
    for h in ("h0", "h1", "h2", "h3"):
        srv.register_host(h, 0.0, cloudlets=["cell"])
    return srv, port_cell.ElasticServeCell(srv, "cell", tm, tp, **kw)


def test_materialize_is_refused(both, tmp_path):
    """``materialize=True`` on a grid larger than the devices there are
    raises the reference's too-few-devices ``ValueError`` at formation: a
    (2, 2) grid over the reference's one CPU device, and over a process
    group of one rank on the port. The materialized cell itself runs in
    ``tests/test_torch_materialize.py``."""
    import torch.distributed as dist

    n = len(jax.devices())
    want = f"materialize=True needs 4 devices, have {n} "
    _, jm, jp = both["repro"]["qwen"]
    ref_srv = ref_tests.AdHocServer(failure_timeout=6.0)
    ref_srv.create_cloudlet("cell", "qwen3-8b")
    for h in ("h0", "h1", "h2", "h3"):
        ref_srv.register_host(h, 0.0, cloudlets=["cell"])
    ref = ref_cell.ElasticServeCell(ref_srv, "cell", jm, jp,
                                    factory=both["repro"]["factory"],
                                    materialize=True)
    with pytest.raises(ValueError, match=want):
        ref.step(ref_tests.SimClock())       # formation
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            rank=0, world_size=n)
    try:
        _, cell = _cell(both, factory=both["repro_torch"]["factory"],
                        materialize=True)
        with pytest.raises(ValueError, match=want):
            cell.step(SimClock())            # formation
    finally:
        dist.destroy_process_group()


def test_cell_engines_run_on_cuda_unless_asked_for_the_cpu(both):
    """With no factory the cell builds its engines through
    ``make_engine_factory``: on ``cuda`` unless ``engine_kwargs`` says
    ``device="cpu"``; the synchronous scheduler unless it names one (the
    reference's code, R7)."""
    kw = dict(ref_tests.ENGINE_KW)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _cell(both, engine_kwargs=kw)
    _, cell = _cell(both, engine_kwargs=dict(kw, device="cpu"))
    eng = cell.factory("h0")
    assert eng.cache["k_pages"].device.type == "cpu"
    assert eng.sched.cfg.synchronous
    _, jm, jp = both["repro"]["qwen"]
    assert ref_batch.make_engine_factory(jm, jp, **kw)("h0").sched.cfg \
        .synchronous


def test_elastic_checkpoint_is_a_host_copy_of_the_weights(both):
    _, tm, tp = both["repro_torch"]["qwen"]
    _, cell = _cell(both, factory=both["repro_torch"]["factory"])
    tree = tm.param_tree(tp)
    assert _leaves(cell.params_host) == _leaves(tree)
    assert _axes(cell.param_axes) == _axes(
        both["repro"]["qwen"][1].param_axes())
    emb = cell.params_host["embedding"]
    assert torch.equal(emb, tree["embedding"])
    assert emb.untyped_storage().data_ptr() != \
        tree["embedding"].untyped_storage().data_ptr()


@pytest.fixture
def no_gc():
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def test_one_engine_at_a_time_through_churn(both, no_gc):
    """Crash, re-shard, rejoin, grow back: when the factory builds an
    engine, every earlier one is already freed (its pool with it), by
    reference counting alone. The last goes with the cell, which the
    server holds as a failure listener while the cell holds the server:
    that cycle is the collector's."""
    factory = both["repro_torch"]["factory"]
    refs: list = []
    alive_at_build: list[int] = []

    def tracked(host_id):
        alive_at_build.append(sum(r() is not None for r in refs))
        eng = factory(host_id)
        refs.append(weakref.ref(eng))
        return eng

    srv, cell = _cell(both, factory=tracked, model_parallel=2,
                      target_hosts=4, slots_per_host=1, decode_step_s=1.0,
                      step_deadline_s=4.0, snapshot_every_s=3.0)
    from repro_torch.core.faults import FaultEvent, FaultPlan

    cfg = both["repro_torch"]["qwen"][0]
    for p in ref_tests.prompts(cfg, 2, seed=8):
        cell.submit(p, max_new_tokens=24)
    plan = FaultPlan([FaultEvent(at=6.0, kind="crash", host="h1"),
                      FaultEvent(at=16.0, kind="rejoin", host="h1")])
    summary = cell.run(SimClock(), fault_plan=plan, max_ticks=500)
    assert summary["resharded"] == 1 and summary["reshard_grow"] == 1
    assert alive_at_build == [0, 0, 0]
    assert sum(r() is not None for r in refs) == 1
    del cell, srv
    gc.collect()
    assert all(r() is None for r in refs)


def test_active_cap_admits_as_the_reference(both):
    """``active_cap`` stops admission at the cap, as the reference's
    engine does: the same slots fill step by step, and the cap can be
    raised mid-run."""
    _, jm, jp = both["repro"]["qwen"]
    _, tm, tp = both["repro_torch"]["qwen"]
    kw = dict(ref_tests.ENGINE_KW)
    engines = (RefEngine(jm, jp, active_cap=2, **kw),
               ServeEngine(tm, tp, active_cap=2, device="cpu", **kw))
    cfg = both["repro_torch"]["qwen"][0]
    ps = ref_tests.prompts(cfg, 5, seed=11)
    trace = []
    for eng in engines:
        for p in ps:
            eng.submit(p, max_new_tokens=4)
        seen = []
        for i in range(30):
            if i == 6:
                eng.active_cap = 3
            eng.step()
            seen.append([r for r in eng.slot_req])
        trace.append(seen)
        assert max(sum(r is not None for r in s) for s in seen[:6]) == 2
        assert not eng.pending()
    assert trace[0] == trace[1]
