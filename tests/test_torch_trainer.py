"""The port's fault-tolerant trainer against the JAX package's, on the CPU.

- The four scenarios of ``tests/test_continuity.py`` (uninterrupted, one
  failure, two failures, a failure before the first snapshot) run on both
  packages with REDUCED smollm-360m: ``completed``, ``effective``,
  ``executed``, ``recomputed``, ``restores``, ``restarts`` and the host of
  every executed step equal the reference's (the protocol is the same
  code), and, the port's guests started from the reference's initial
  state (bridged), every loss within 2e-3 of the reference's at its step
  (the numerics of ``tests/test_torch_train.py``); the port's final state
  after one and after two failures is bitwise its uninterrupted run's:
  params, moments, step, rng words and data cursor.
- Every case of ``tests/test_continuity.py`` runs on the port too, the
  file's source retargeted to ``repro_torch`` (``test_torch_core.ported``)
  with its trainer built on the CPU: the scenarios and the straggler units.
- A TrainState blob written by either package deserializes in the other,
  leaf for leaf, and a port guest restored from a reference guest's
  snapshot resumes at its cursor.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.checkpoint import serializer as ref_ser  # noqa: E402
from repro.config import RunConfig as RefRun  # noqa: E402
from repro.configs import REDUCED  # noqa: E402
from repro.training.trainer import AdHocTrainer as RefTrainer  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    train_state_from_reference,
    train_state_to_reference,
)
from repro_torch.checkpoint import serializer  # noqa: E402
from repro_torch.config import RunConfig  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models.model_api import tree_leaves  # noqa: E402
from repro_torch.training.trainer import AdHocTrainer  # noqa: E402
from test_torch_core import cases, ported, run_case  # noqa: E402

torch.set_num_threads(1)
ARCH = "smollm-360m"
LOSS_ATOL = 2e-3
# (snapshot every, hosts, steps, failures): tests/test_continuity.py's
SCENARIOS = {
    "uninterrupted": (4, 4, 12, {}),
    "one_failure": (4, 4, 12, {6: "host000"}),
    "two_failures": (4, 4, 12, {3: "host000", 9: "host001"}),
    "before_first_snapshot": (100, 3, 8, {5: "host000"}),
}
COUNTERS = ("completed", "effective_steps", "executed_steps",
            "recomputed_steps", "restores", "restarts_from_zero",
            "host_of_step")


def _ref_report(name):
    every, hosts, steps, fail = SCENARIOS[name]
    t = RefTrainer(REDUCED[ARCH], RefRun(arch=ARCH,
                                         snapshot_interval_steps=every),
                   n_hosts=hosts, total_steps=steps, seq_len=32,
                   global_batch=4, fail_at_steps=dict(fail))
    return t.run_to_completion()


def _port_report(name):
    every, hosts, steps, fail = SCENARIOS[name]
    t = AdHocTrainer(get(ARCH, reduced=True),
                     RunConfig(arch=ARCH, snapshot_interval_steps=every),
                     n_hosts=hosts, total_steps=steps, seq_len=32,
                     global_batch=4, fail_at_steps=dict(fail), device="cpu")
    return t.run_to_completion()


@pytest.fixture(scope="module")
def reports():
    """Each scenario on both packages, the port's guests starting from the
    reference's initial state."""
    from repro.models import get_model as ref_get_model
    from repro.training.state import init_train_state as ref_init

    import repro_torch.training.trainer as trainer_mod

    ref0 = jax.tree.map(np.asarray, ref_init(ref_get_model(REDUCED[ARCH]),
                                             0))

    def start(model, seed, device):
        return train_state_from_reference(ref0, device=device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_mod, "init_train_state", start)
        return {name: (_ref_report(name), _port_report(name))
                for name in SCENARIOS}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_counters_and_losses_equal_the_reference(reports, name):
    ref, port = reports[name]
    for c in COUNTERS:
        assert getattr(port, c) == getattr(ref, c), (name, c)
    assert [s for s, _ in port.losses] == [s for s, _ in ref.losses]
    for (_, a), (_, b) in zip(ref.losses, port.losses):
        assert b == pytest.approx(a, abs=LOSS_ATOL)


def _bits(state) -> list[bytes]:
    host = train_state_to_reference(state)
    return [np.asarray(x).tobytes() for x in jax.tree.leaves(host)]


@pytest.mark.parametrize("name", ["one_failure", "two_failures"])
def test_restored_run_is_bitwise_the_uninterrupted_run(reports, name):
    _, base = reports["uninterrupted"]
    _, port = reports[name]
    assert port.restores >= 1 and port.recomputed_steps > 0
    assert _bits(port.final_state) == _bits(base.final_state)


CONTINUITY_CASES = cases("test_continuity")


@pytest.fixture(scope="module")
def continuity_on_the_port():
    mod = ported("test_continuity")
    mod.AdHocTrainer = functools.partial(AdHocTrainer, device="cpu")
    return mod


@pytest.fixture(scope="module")
def port_baseline():
    """The uninterrupted run from the port's own initial state, as the
    retargeted cases build theirs."""
    return _port_report("uninterrupted")


@pytest.mark.parametrize("case", CONTINUITY_CASES)
def test_continuity_case_on_the_port(continuity_on_the_port, port_baseline,
                                     case):
    assert len(CONTINUITY_CASES) == 9
    run_case(continuity_on_the_port, case, baseline_report=port_baseline)


@pytest.fixture(scope="module")
def states(reports):
    ref, port = reports["one_failure"]
    return (jax.tree.map(np.asarray, ref.final_state), port.final_state)


def test_blobs_cross_packages_both_ways(states):
    ref_state, port_state = states
    # the port's blob in the reference
    blob = serializer.serialize_tree(port_state)
    got = ref_ser.deserialize_tree(blob, ref_state)
    want = train_state_to_reference(port_state)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # the reference's blob in the port
    blob = ref_ser.serialize_tree(ref_state)
    got = serializer.deserialize_tree(blob, port_state)
    want = train_state_from_reference(ref_state, device="cpu")
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        if isinstance(a, torch.Tensor):
            assert b.dtype == a.dtype and torch.equal(a, b)
        else:
            assert np.asarray(b).dtype == np.asarray(a).dtype
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_a_port_guest_resumes_from_a_reference_snapshot():
    """A reference guest's snapshot restores on a port guest, which then
    steps on from the reference's cursor (with the port's own rng words,
    ``training/state.py``) to the end of the job."""
    ref_t = RefTrainer(REDUCED[ARCH], RefRun(arch=ARCH), n_hosts=2,
                       total_steps=3, seq_len=32, global_batch=4)
    ref_g = ref_t._make_guest("g-ref", "job")
    ref_g.start(None, 0.0)
    for _ in range(2):
        ref_g.run_step()
    port_t = AdHocTrainer(get(ARCH, reduced=True), RunConfig(arch=ARCH),
                          n_hosts=2, total_steps=3, seq_len=32,
                          global_batch=4, device="cpu")
    g = port_t._make_guest("g-port", "job")
    g.start(None, 0.0)
    g.restore(ref_g.snapshot())
    assert g.progress() == 2.0 and not g.complete()
    assert _bits(g.state) == [
        np.asarray(x).tobytes()
        for x in jax.tree.leaves(jax.tree.map(np.asarray, ref_g.state))]
    ref_loss = ref_g.run_step()
    assert g.run_step() == pytest.approx(ref_loss, abs=LOSS_ATOL)
    assert g.complete() and g.run_step() is None
