"""The port's training path for the encoder-decoder (whisper-medium)
against the JAX package's, on the CPU.

- the plain attention's backward, non-causal and with more or fewer keys
  than queries (the encoder's and the cross attention's form), against
  ``jax.vjp`` of the reference's ``ops.attention`` on the XLA backend: f32
  inputs, every gradient within ``PLAIN_REL`` of its largest magnitude
  (measured ≤ 3.3e-7); MHA and GQA, an edge of a single key;
- ``loss_fn``: the loss and every gradient leaf of REDUCED whisper-medium
  against ``jax.value_and_grad(model.loss)``, the reference run op by op
  (``jax.disable_jit``, ROADMAP Queue 3, P1), with
  ``tests/test_torch_train.py``'s tolerances (the loss within 2e-3, each
  leaf within 2 % of its largest magnitude; measured ≤ 1.6 %), at a
  decoder longer than the encoder and at one shorter; which plain routes
  the loss takes;
- ``make_train_step``: two steps, each from the reference's own state
  (bridged), against the reference's step run op by op, with
  ``tests/test_torch_train_ssm.py``'s limits or the reference's own jitted
  step's reading, whichever is larger;
- the train state crossing the bridge both ways;
- ``launch/train.py --arch whisper-medium --device cpu`` with a failure:
  the restored run's final state bitwise the uninterrupted run's.
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
ARCH = "whisper-medium"
PLAIN_REL = 1e-4
LOSS_ATOL = 2e-3
GRAD_SHARE = 0.02      # of each leaf's largest reference magnitude
MOMENT_SHARE = 0.03    # mu, against the reference's step from one state
NU_SHARE = 0.06        # nu: the squared gradient
PARAM_CHANGE_SHARE = 0.15
BATCH = 4


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


def _frames_cut(batch: dict, n: int) -> dict:
    """The batch with its frames cut to the first ``n`` (an encoder
    shorter than the decoder: the data gives ``min(S, 1500)``)."""
    return {**batch, "frames": batch["frames"][:, :n]}


# ---------------------------------------------------------------------------
# the plain attention's backward, non-causal, Sq != Sk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,Sq,Sk,H,K,D", [
    (2, 24, 15, 4, 4, 16), (1, 7, 33, 4, 2, 16), (2, 40, 40, 2, 2, 8),
    (1, 9, 1, 4, 4, 16)])
def test_non_causal_attention_backward_equals_the_reference_vjp(B, Sq, Sk,
                                                                 H, K, D):
    rng = np.random.default_rng(Sq * Sk + H)
    f = np.float32
    ins = [rng.standard_normal((B, Sq, H, D)).astype(f),
           rng.standard_normal((B, Sk, K, D)).astype(f),
           rng.standard_normal((B, Sk, K, D)).astype(f)]
    dout = rng.standard_normal((B, Sq, H, D)).astype(f)
    with ref_ops.use_backend("xla"):
        _, vjp = jax.vjp(lambda q, k, v: ref_ops.attention(
            q, k, v, causal=False), *map(jnp.asarray, ins))
        want = vjp(jnp.asarray(dout))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    got = torch.autograd.grad(ref.attention(*leaves, causal=False), leaves,
                              torch.from_numpy(dout))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _leaf_close(g.numpy(), np.asarray(w), PLAIN_REL, name)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


CASES = {"dec32-enc32": (32, None), "dec16-enc12": (16, 12)}


@pytest.fixture(scope="module", params=sorted(CASES))
def loss_pair(request):
    seq, n_frames = CASES[request.param]
    cfg = REDUCED[ARCH]
    ref_model = ref_get_model(cfg)
    ref_params = ref_model.init(jax.random.key(0))
    batch = RefData(cfg, seq, BATCH, seed=0).batch(0)
    if n_frames is not None:
        batch = _frames_cut(batch, n_frames)
    with jax.disable_jit():
        (loss, aux), grads = jax.value_and_grad(ref_model.loss, has_aux=True)(
            ref_params, _ref_batch(batch))
    port = get_model(get(ARCH, reduced=True))
    tree = tree_map(lambda a: tensor_from_numpy(np.asarray(a))
                    .requires_grad_(), ref_params)
    ploss, paux = port.loss(tree, _port_batch(batch))
    pgrads = torch.autograd.grad(ploss, tree_leaves(tree))
    paux = {k: v.detach() for k, v in paux.items()}
    return request.param, (loss, aux, grads), (
        ploss.detach(), paux, pgrads)


def test_loss_equals_the_reference(loss_pair):
    case, (loss, aux, _), (ploss, paux, _) = loss_pair
    assert float(ploss) == pytest.approx(float(loss), abs=LOSS_ATOL), case
    assert float(paux["ce"]) == pytest.approx(float(aux["ce"]),
                                              abs=LOSS_ATOL)
    assert float(paux["z_loss"]) == pytest.approx(float(aux["z_loss"]),
                                                  rel=1e-4)
    assert float(paux["tokens"]) == float(aux["tokens"])


def test_every_gradient_leaf_equals_the_reference(loss_pair):
    case, (_, _, grads), (_, _, pgrads) = loss_pair
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert len(flat) == len(pgrads)
    for (path, want), got in zip(flat, pgrads):
        assert got.dtype == torch.float32
        _leaf_close(got.numpy(), want, GRAD_SHARE,
                    f"{case} {jax.tree_util.keystr(path)}")


def test_the_loss_takes_the_plain_routes_on_the_cpu():
    """On the CPU every op is the plain version, the backward too: each
    encoder layer's attention and two norms, each decoder layer's two
    attentions and three norms run twice (the forward, and the recompute
    under ``remat_policy`` full), the two final norms once."""
    model = get_model(get(ARCH, reduced=True))
    cfg = model.cfg
    tree = tree_map(lambda t: t.requires_grad_(),
                    model.init_master(0, device="cpu"))
    batch = _port_batch(RefData(REDUCED[ARCH], 16, 2).batch(0))
    ops.reset_counts()
    loss, _ = model.loss(tree, batch)
    loss.backward()
    c = ops.counts()
    Le, Ld = cfg.n_encoder_layers, cfg.n_layers
    assert c["flash_attention_bwd"]["plain"] == 2 * (Le + 2 * Ld)
    assert c["rmsnorm_bwd"]["plain"] == 2 * (2 * Le + 3 * Ld) + 2
    assert c["moe_route_bwd"]["plain"] == 0
    assert all(v["launches"] == 0 for v in c.values())
    assert all(t.grad is not None and t.grad.dtype == torch.float32
               for t in tree_leaves(tree))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def whisper_steps():
    """Two reference steps of REDUCED whisper-medium, run op by op, from
    seed 0: the state before each step and after the last, each step's
    metrics, and the jitted step's state from each state (the control)."""
    cfg = REDUCED[ARCH]
    ref_model = ref_get_model(cfg)
    ref_step = ref_make_step(ref_model, RefRun(arch=ARCH))
    ds = RefData(cfg, 32, BATCH, seed=0)
    state = ref_init_state(ref_model, seed=0)
    states, metrics, jitted = [jax.tree.map(np.asarray, state)], [], []
    jit_step = jax.jit(ref_step)
    for i in range(2):
        jitted.append(jax.tree.map(np.asarray, jit_step(
            state, _ref_batch(ds.batch(i)))[0]))
        with jax.disable_jit():
            state, m = ref_step(state, _ref_batch(ds.batch(i)))
        states.append(jax.tree.map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
    return ds, states, metrics, jitted


def _change_share(p0, after, got) -> float:
    p0 = np.asarray(p0, np.float64)
    want = np.asarray(after, np.float64) - p0
    got = np.asarray(got, np.float64) - p0
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("i", [0, 1])
def test_whisper_train_step_equals_the_reference(whisper_steps, i):
    """Step ``i`` from the reference's own state (bridged) against its step
    run op by op: the metrics, and each leaf's change, ``mu`` and ``nu``
    within the base limits or within the reference's own jitted step's
    reading of that leaf, whichever is larger (at step 0 Adam moves every
    element by about lr whatever its gradient, so a near-zero gradient
    whose sign rounding flips moves the other way: the encoder's MLP norms
    read 0.248 for the port and for the jitted reference alike; measured
    elsewhere ≤ 0.111 at step 0, ≤ 0.014 at step 1)."""
    ds, states, metrics, jitted = whisper_steps
    port = get_model(get(ARCH, reduced=True))
    ps, pm = make_train_step(port, RunConfig(arch=ARCH))(
        train_state_from_reference(states[i], device="cpu"),
        _port_batch(ds.batch(i)))
    rm = metrics[i]
    assert float(pm["loss"]) == pytest.approx(rm["loss"], abs=LOSS_ATOL)
    assert float(pm["grad_norm"]) == pytest.approx(rm["grad_norm"],
                                                   rel=GRAD_SHARE)
    assert float(pm["lr"]) == pytest.approx(rm["lr"], rel=1e-6)
    mine, theirs, before, ctl = train_state_to_reference(ps), \
        states[i + 1], states[i], jitted[i]
    for (path, p0), a, b, c in zip(
            jax.tree_util.tree_flatten_with_path(before["params"])[0],
            jax.tree.leaves(theirs["params"]),
            jax.tree.leaves(mine["params"]),
            jax.tree.leaves(ctl["params"])):
        limit = max(PARAM_CHANGE_SHARE, _change_share(p0, a, c))
        share = _change_share(p0, a, b)
        assert share <= limit, (jax.tree_util.keystr(path), share, limit)
    for key, base in (("mu", MOMENT_SHARE), ("nu", NU_SHARE)):
        for (path, a), b, c in zip(
                jax.tree_util.tree_flatten_with_path(theirs["opt"][key])[0],
                jax.tree.leaves(mine["opt"][key]),
                jax.tree.leaves(ctl["opt"][key])):
            _leaf_close(b, a, max(base, _rel(c, a)),
                        f"{key} {jax.tree_util.keystr(path)}")
    assert int(mine["opt"]["step"]) == int(theirs["opt"]["step"]) == i + 1


def test_train_state_crosses_the_bridge_both_ways():
    host = jax.tree.map(np.asarray,
                        ref_init_state(ref_get_model(REDUCED[ARCH]), seed=0))
    state = train_state_from_reference(host, device="cpu")
    back = train_state_to_reference(state)
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(back)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    mine = init_train_state(get_model(get(ARCH, reduced=True)), seed=0,
                            device="cpu")
    assert [np.asarray(x).dtype for x in jax.tree.leaves(host)] == \
        [numpy_from_tensor(x).dtype if isinstance(x, torch.Tensor)
         else np.asarray(x).dtype for x in tree_leaves(mine)]
    assert [np.asarray(x).shape for x in jax.tree.leaves(host)] == \
        [tuple(x.shape) for x in tree_leaves(mine)]


def test_train_cli_restores_whisper_bitwise():
    """``launch/train.py --arch whisper-medium --device cpu`` with a
    failure at step 5 (snapshots every 2) ends in the uninterrupted run's
    state, bit for bit, with one restore and a recomputed step."""
    from repro_torch.launch import train as train_cli

    argv = ["--arch", ARCH, "--device", "cpu", "--steps", "6", "--hosts",
            "2", "--snapshot-every", "2", "--seq-len", "32", "--batch", "2"]
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
