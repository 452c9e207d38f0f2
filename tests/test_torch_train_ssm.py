"""The port's training path for the recurrent families against the JAX
package's, on the CPU.

- ``ref.selective_scan_bwd`` and ``ref.ssd_bwd``, the plain versions of the
  two backward kernels (closed form: the scan's adjoint walked back tile by
  tile, the SSD's transposed chunked products), against ``jax.vjp`` of the
  reference's ``ops.selective_scan`` / ``ops.ssd`` on the XLA backend and
  against autograd through the port's plain forwards: f32 inputs, every
  gradient (``h0``'s too) within ``PLAIN_REL`` of its largest magnitude
  (measured: the scan ≤ 5.5e-7, the SSD ≤ 1.7e-5 against jax and ≤ 1.5e-6
  against autograd; f32 sums in other orders). Nonzero and zero
  ``h0``, a gradient for ``hT`` and none, ragged tails, two or more chunks
  (tiles), every state size of the scan's backward kernel (4, 8, 16).
- ``loss_fn``: the loss and every gradient leaf of REDUCED falcon-mamba-7b
  and zamba2-1.2b against ``jax.value_and_grad(model.loss)``, the reference
  run op by op (``jax.disable_jit``, ROADMAP Queue 3, P1), with
  ``tests/test_torch_train.py``'s tolerances (the loss within 2e-3, each
  leaf within 2 % of its largest magnitude; measured ≤ 1.6 %); which plain
  routes the loss takes (each layer forward and recomputed).
- ``make_train_step``: three zamba2 steps, each from the reference's own
  state at that step (bridged), against the reference's step run op by op:
  the loss (2e-3), the grad norm (2 %), ``lr``, ``tokens``, each leaf's
  update within 15 % of the reference's in the Frobenius norm (Adam's steps
  move an element by about lr whatever its gradient, so a near-zero
  gradient whose sign bf16 rounding flips moves it the other way; measured
  7.1–12.6 %), ``mu`` within 3 % and ``nu`` (the squared gradient: twice
  the relative error) within 6 % of each leaf's largest magnitude
  (measured ≤ 2.1 % and ≤ 3.7 %). Chained, the steps drift apart as the
  reference's jitted and op-by-op runs drift from each other (grad norm
  7.6 % apart by step 3 at REDUCED zamba2), so each step starts from the
  reference's state.
- the train state of both families crossing the bridge both ways;
- ``launch/train.py --arch zamba2-1.2b --device cpu`` with a failure: the
  restored run's final state bitwise the uninterrupted run's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import RunConfig as RefRun  # noqa: E402
from repro.configs import REDUCED  # noqa: E402
from repro.data.synthetic import SyntheticDataset as RefData  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.training.state import init_train_state as ref_init_state  # noqa: E402
from repro.training.step import make_train_step as ref_make_step  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    numpy_from_tensor,
    tensor_from_numpy,
    train_state_from_reference,
    train_state_to_reference,
)
from repro_torch.config import RunConfig  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.model_api import tree_leaves, tree_map  # noqa: E402
from repro_torch.training.state import init_train_state  # noqa: E402
from repro_torch.training.step import make_train_step  # noqa: E402

torch.set_num_threads(1)
PLAIN_REL = 1e-4
LOSS_ATOL = 2e-3
GRAD_SHARE = 0.02      # of each leaf's largest reference magnitude
MOMENT_SHARE = 0.03    # mu, against the reference's step from one state
NU_SHARE = 0.06        # nu: the squared gradient
PARAM_CHANGE_SHARE = 0.15
SEQ, BATCH = 32, 4
ARCHS = ("falcon-mamba-7b", "zamba2-1.2b")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaf_close(got, want, share: float, what: str) -> None:
    err = _rel(got, want)
    assert err <= share, f"{what}: {err:.3g} of the largest value, over {share}"


def _port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _ref_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# the plain backwards
# ---------------------------------------------------------------------------


def _scan_inputs(rng, B, S, Di, N, h0_scale):
    f = np.float32
    return [0.5 * rng.standard_normal((B, S, Di)).astype(f),
            0.1 * np.abs(rng.standard_normal((B, S, Di))).astype(f),
            -(np.abs(rng.standard_normal((Di, N))) + 0.1).astype(f),
            0.5 * rng.standard_normal((B, S, N)).astype(f),
            0.5 * rng.standard_normal((B, S, N)).astype(f),
            rng.standard_normal(Di).astype(f),
            h0_scale * rng.standard_normal((B, Di, N)).astype(f)]


def _ssd_inputs(rng, B, S, Hs, P, N, h0_scale):
    f = np.float32
    return [0.5 * rng.standard_normal((B, S, Hs, P)).astype(f),
            0.1 * np.abs(rng.standard_normal((B, S, Hs))).astype(f),
            -(np.abs(rng.standard_normal(Hs)) + 0.1).astype(f),
            0.5 * rng.standard_normal((B, S, N)).astype(f),
            0.5 * rng.standard_normal((B, S, N)).astype(f),
            rng.standard_normal(Hs).astype(f),
            h0_scale * rng.standard_normal((B, Hs, P, N)).astype(f)]


def _hold(got, ref_fwd, port_fwd, ins, dy, dhT) -> None:
    """``got`` (a plain backward's seven gradients) against ``jax.vjp`` of
    ``ref_fwd`` and torch autograd through ``port_fwd``, on ``ins``."""
    _, vjp = jax.vjp(ref_fwd, *map(jnp.asarray, ins))
    want_ref = vjp((jnp.asarray(dy), jnp.asarray(
        dhT if dhT is not None else np.zeros_like(ins[6]))))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, hT = port_fwd(*leaves)
    want_port = torch.autograd.grad(
        (y, hT), leaves, (torch.from_numpy(dy), torch.from_numpy(
            dhT if dhT is not None else np.zeros_like(ins[6]))))
    names = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
    for name, g, wr, wp in zip(names, got, want_ref, want_port):
        assert g.dtype == torch.float32, name
        _leaf_close(g.numpy(), np.asarray(wr), PLAIN_REL, f"{name} vs jax")
        _leaf_close(g.numpy(), wp.numpy(), PLAIN_REL, f"{name} vs autograd")


@pytest.mark.parametrize("B,S,Di,N,h0_scale,with_dhT", [
    (2, 37, 12, 4, 0.5, True), (1, 300, 8, 8, 0.0, False),
    (2, 520, 6, 16, 0.5, True), (1, 256, 5, 16, 0.5, False)])
def test_scan_bwd_equals_the_reference_vjp(B, S, Di, N, h0_scale, with_dhT):
    rng = np.random.default_rng(S + N)
    ins = _scan_inputs(rng, B, S, Di, N, h0_scale)
    dy = rng.standard_normal((B, S, Di)).astype(np.float32)
    dhT = (0.3 * rng.standard_normal((B, Di, N)).astype(np.float32)
           if with_dhT else None)
    got = ref.selective_scan_bwd(*map(torch.from_numpy, ins),
                                 torch.from_numpy(dy),
                                 None if dhT is None else torch.from_numpy(dhT))
    with ref_ops.use_backend("xla"):
        _hold(got, lambda *a: ref_ops.selective_scan(*a, chunk=64),
              ref.selective_scan, ins, dy, dhT)


@pytest.mark.parametrize("B,S,Hs,P,N,chunk,h0_scale,with_dhT", [
    (2, 37, 3, 4, 5, 16, 0.5, True), (1, 64, 2, 8, 4, 16, 0.0, False),
    (2, 300, 2, 8, 8, 256, 0.5, True), (1, 50, 2, 3, 4, 64, 0.5, False),
    (1, 33, 2, 4, 4, 8, 0.5, True)])
def test_ssd_bwd_equals_the_reference_vjp(B, S, Hs, P, N, chunk, h0_scale,
                                          with_dhT):
    rng = np.random.default_rng(S + P + chunk)
    ins = _ssd_inputs(rng, B, S, Hs, P, N, h0_scale)
    dy = rng.standard_normal((B, S, Hs, P)).astype(np.float32)
    dhT = (0.3 * rng.standard_normal((B, Hs, P, N)).astype(np.float32)
           if with_dhT else None)
    got = ref.ssd_bwd(*map(torch.from_numpy, ins), torch.from_numpy(dy),
                      None if dhT is None else torch.from_numpy(dhT),
                      chunk=chunk)
    with ref_ops.use_backend("xla"):
        _hold(got, lambda *a: ref_ops.ssd(*a, chunk=chunk),
              lambda *a: ref.ssd(*a, chunk=chunk), ins, dy, dhT)


def test_plain_ssd_gradient_is_finite_at_a_long_decaying_chunk():
    """At a 256-step chunk whose decay reaches exp(-180) (dt 0.7, A -1, as
    zamba2's initial weights give), exp(l_i - l_j) above the diagonal
    would overflow: the plain SSD masks the exponent first, so autograd
    through it stays finite and equals ``ref.ssd_bwd``. (The reference's
    XLA form takes ``exp`` before its mask and gives NaN for dt and A
    here: ROADMAP Queue 3, R8.)"""
    rng = np.random.default_rng(7)
    ins = _ssd_inputs(rng, 1, 300, 2, 4, 4, 0.5)
    ins[1] = np.full_like(ins[1], 0.7)
    ins[2] = -np.ones_like(ins[2])
    dy = rng.standard_normal((1, 300, 2, 4)).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, _ = ref.ssd(*leaves, chunk=256)
    want = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    got = ref.ssd_bwd(*map(torch.from_numpy, ins), torch.from_numpy(dy),
                      chunk=256)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD", "dh0"), got,
                          want):
        assert bool(torch.isfinite(w).all()), name
        _leaf_close(g.numpy(), w.numpy(), PLAIN_REL, name)


def test_plain_backwards_keep_the_input_types():
    """bf16 inputs give bf16 dx, ddt, dB, dC (autograd through the plain
    forward's casts gives the same types), f32 dA, dD, dh0."""
    rng = np.random.default_rng(0)
    for bwd, ins, kw in (
            (ref.selective_scan_bwd, _scan_inputs(rng, 1, 20, 4, 4, 0.5), {}),
            (ref.ssd_bwd, _ssd_inputs(rng, 1, 20, 2, 4, 4, 0.5),
             {"chunk": 8})):
        ts = [torch.from_numpy(a) for a in ins]
        for i in (0, 1, 3, 4):
            ts[i] = ts[i].bfloat16()
        dy = torch.ones_like(ts[0])
        out = bwd(*ts, dy, None, **kw)
        assert [t.dtype for t in out] == [torch.bfloat16] * 2 + [
            torch.float32] + [torch.bfloat16] * 2 + [torch.float32] * 2
        assert [t.shape for t in out] == [t.shape for t in ts]


# ---------------------------------------------------------------------------
# the losses and their gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def loss_pair(request):
    arch = request.param
    cfg = REDUCED[arch]
    ref_model = ref_get_model(cfg)
    ref_params = ref_model.init(jax.random.key(0))
    batch = RefData(cfg, SEQ, BATCH, seed=0).batch(0)
    with jax.disable_jit():
        (loss, aux), grads = jax.value_and_grad(ref_model.loss, has_aux=True)(
            ref_params, _ref_batch(batch))
    port = get_model(get(arch, reduced=True))
    tree = tree_map(lambda a: tensor_from_numpy(np.asarray(a))
                    .requires_grad_(), ref_params)
    ploss, paux = port.loss(tree, _port_batch(batch))
    pgrads = torch.autograd.grad(ploss, tree_leaves(tree))
    paux = {k: v.detach() for k, v in paux.items()}
    return arch, (loss, aux, grads), (ploss.detach(), paux, pgrads)


def test_loss_equals_the_reference(loss_pair):
    arch, (loss, aux, _), (ploss, paux, _) = loss_pair
    assert float(ploss) == pytest.approx(float(loss), abs=LOSS_ATOL), arch
    assert float(paux["ce"]) == pytest.approx(float(aux["ce"]),
                                              abs=LOSS_ATOL)
    assert float(paux["z_loss"]) == pytest.approx(float(aux["z_loss"]),
                                                  rel=1e-4)
    assert float(paux["tokens"]) == float(aux["tokens"])


def test_every_gradient_leaf_equals_the_reference(loss_pair):
    arch, (_, _, grads), (_, _, pgrads) = loss_pair
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert len(flat) == len(pgrads)
    for (path, want), got in zip(flat, pgrads):
        assert got.dtype == torch.float32
        _leaf_close(got.numpy(), want, GRAD_SHARE,
                    f"{arch} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("arch", ARCHS)
def test_the_loss_takes_the_plain_routes_on_the_cpu(arch):
    """On the CPU every op is the plain version, the backward too: each
    Mamba layer's scan (or SSD) and norms run twice (the forward, and its
    recompute under ``remat_policy`` full), the shared block's attention
    and norms twice per application, the final norm once."""
    model = get_model(get(arch, reduced=True))
    cfg = model.cfg
    tree = tree_map(lambda t: t.requires_grad_(),
                    model.init_master(0, device="cpu"))
    batch = _port_batch(RefData(REDUCED[arch], 16, 2).batch(0))
    ops.reset_counts()
    loss, _ = model.loss(tree, batch)
    loss.backward()
    c = ops.counts()
    L = cfg.n_layers
    if arch == "falcon-mamba-7b":
        assert c["selective_scan_bwd"]["plain"] == 2 * L
        assert c["rmsnorm_bwd"]["plain"] == 2 * L + 1
        assert c["ssd_bwd"]["plain"] == c["flash_attention_bwd"]["plain"] == 0
    else:
        apps = len(cfg.hybrid_attention_layers())
        assert c["ssd_bwd"]["plain"] == 2 * L
        assert c["flash_attention_bwd"]["plain"] == 2 * apps
        # block and gate norms a layer, two norms an application
        assert c["rmsnorm_bwd"]["plain"] == 2 * (2 * L + 2 * apps) + 1
        assert c["selective_scan_bwd"]["plain"] == 0
    assert all(v["launches"] == 0 for v in c.values())
    assert all(t.grad is not None and t.grad.dtype == torch.float32
               for t in tree_leaves(tree))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zamba_steps():
    """Three reference steps of REDUCED zamba2, run op by op, from seed 0:
    the state before each step and after the last, and each step's
    metrics."""
    arch = "zamba2-1.2b"
    cfg = REDUCED[arch]
    ref_model = ref_get_model(cfg)
    ref_step = ref_make_step(ref_model, RefRun(arch=arch))
    ds = RefData(cfg, SEQ, BATCH, seed=0)
    state = ref_init_state(ref_model, seed=0)
    states, metrics = [jax.tree.map(np.asarray, state)], []
    for i in range(3):
        with jax.disable_jit():
            state, m = ref_step(state, _ref_batch(ds.batch(i)))
        states.append(jax.tree.map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
    return ds, states, metrics


@pytest.mark.parametrize("i", [0, 1, 2])
def test_zamba2_train_step_equals_the_reference(zamba_steps, i):
    ds, states, metrics = zamba_steps
    port = get_model(get("zamba2-1.2b", reduced=True))
    step = make_train_step(port, RunConfig(arch="zamba2-1.2b"))
    ps, pm = step(train_state_from_reference(states[i], device="cpu"),
                  _port_batch(ds.batch(i)))
    rm = metrics[i]
    assert float(pm["loss"]) == pytest.approx(rm["loss"], abs=LOSS_ATOL)
    assert float(pm["ce"]) == pytest.approx(rm["ce"], abs=LOSS_ATOL)
    assert float(pm["grad_norm"]) == pytest.approx(rm["grad_norm"],
                                                   rel=GRAD_SHARE)
    assert float(pm["lr"]) == pytest.approx(rm["lr"], rel=1e-6)
    assert float(pm["tokens"]) == rm["tokens"]
    mine, theirs, before = train_state_to_reference(ps), states[i + 1], \
        states[i]
    for p0, a, b in zip(jax.tree.leaves(before["params"]),
                        jax.tree.leaves(theirs["params"]),
                        jax.tree.leaves(mine["params"])):
        p0 = np.asarray(p0, np.float64)
        want = np.asarray(a, np.float64) - p0
        got = np.asarray(b, np.float64) - p0
        share = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert share <= PARAM_CHANGE_SHARE, (p0.shape, share)
    for key, share in (("mu", MOMENT_SHARE), ("nu", NU_SHARE)):
        for a, b in zip(jax.tree.leaves(theirs["opt"][key]),
                        jax.tree.leaves(mine["opt"][key])):
            _leaf_close(b, a, share, key)
    assert int(mine["opt"]["step"]) == int(theirs["opt"]["step"]) == i + 1
    assert int(mine["data_step"]) == int(theirs["data_step"]) == i + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_crosses_the_bridge_both_ways(arch):
    host = jax.tree.map(np.asarray,
                        ref_init_state(ref_get_model(REDUCED[arch]), seed=0))
    state = train_state_from_reference(host, device="cpu")
    back = train_state_to_reference(state)
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(back)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    mine = init_train_state(get_model(get(arch, reduced=True)), seed=0,
                            device="cpu")
    assert [np.asarray(x).dtype for x in jax.tree.leaves(host)] == \
        [numpy_from_tensor(x).dtype if isinstance(x, torch.Tensor)
         else np.asarray(x).dtype for x in tree_leaves(mine)]
    assert [np.asarray(x).shape for x in jax.tree.leaves(host)] == \
        [tuple(x.shape) for x in tree_leaves(mine)]


def test_train_cli_restores_zamba2_bitwise():
    """``launch/train.py --arch zamba2-1.2b --device cpu`` with a failure
    at step 5 (snapshots every 2) ends in the uninterrupted run's state,
    bit for bit, with one restore and a recomputed step."""
    from repro_torch.launch import train as train_cli

    argv = ["--arch", "zamba2-1.2b", "--device", "cpu", "--steps", "6",
            "--hosts", "2", "--snapshot-every", "2", "--seq-len", "32",
            "--batch", "2"]
    failed = train_cli.main(argv + ["--fail-at", "5"])
    clean = train_cli.main(argv)
    assert failed.completed and clean.completed
    assert failed.restores == 1 and failed.recomputed_steps == 1
    assert clean.restores == 0
    assert all(np.isfinite(loss) for _, loss in failed.losses)
    for a, b in zip(tree_leaves(failed.final_state),
                    tree_leaves(clean.final_state)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
