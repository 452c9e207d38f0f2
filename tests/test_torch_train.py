"""The port's training path against the JAX package's, on the CPU.

- ``data/synthetic.py``: batches byte-equal to ``repro.data.synthetic``'s
  for several seeds and steps, the VLM's ``embeds`` and the enc-dec's
  ``frames`` included;
- ``optim/adamw.py``: ``lr_schedule`` (both schedules), ``global_norm``
  and the clip against the reference, within 1e-6 relative (f32 both
  sides); ``adamw_update`` on the same params, grads and moments within
  1e-6, three steps in a row;
- ``parallel/collectives.py``: ``quantize_int8`` fed the reference's own
  noise (``jax.random.uniform(key, shape) - 0.5``) is bitwise the
  reference's ``_quantize_int8``;
- ``loss_fn``: the loss and every gradient leaf for REDUCED smollm-360m
  (tied), qwen3-8b (qk-norm, untied) and llava-next-mistral-7b (the VLM
  branch) against ``jax.value_and_grad(model.loss)``, the reference run op
  by op (``jax.disable_jit``, ROADMAP Queue 3, P1), weights handed across
  by the bridge. Tolerances: the loss and ``ce`` within 2e-3 (measured
  6e-5–5.4e-4), and each gradient leaf's largest difference within 2 % of
  that leaf's largest magnitude (measured 0.2–1.1 %): both sides round
  every product to bf16, in other orders and places;
- ``make_train_step``: 3 steps with 1 and with 2 microbatches from one
  bridged state against the reference's jitted step: each ``params``
  leaf's change over the 3 steps within 15 % of the reference's change in
  the Frobenius norm (measured 1.1–7.1 %: Adam's first steps move each
  parameter by about ±lr whatever its gradient's size, so where bf16
  rounding flips a near-zero gradient's sign, 0.2–2 % of a leaf's
  elements, that element moves the other way; an update not written,
  written with the wrong sign or with another step's lr lands at 30 % or
  more), ``mu`` and ``nu`` within 3 % of each
  leaf's largest magnitude (measured up to 2.0 %: jitted, XLA keeps f32
  where a bf16 product feeds an f32 consumer, P1, so the reference's
  gradients move further from the port's than op by op), the metrics
  (``loss`` 2e-3, ``grad_norm`` 2 % relative, ``lr`` 1e-6 relative,
  ``tokens`` exactly);
- every case of ``tests/test_step.py`` on the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import OptimConfig as RefOptim  # noqa: E402
from repro.config import RunConfig as RefRun  # noqa: E402
from repro.configs import REDUCED  # noqa: E402
from repro.data.synthetic import SyntheticDataset as RefData  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.parallel import collectives as ref_coll  # noqa: E402
from repro.training.state import init_train_state as ref_init_state  # noqa: E402
from repro.training.step import make_train_step as ref_make_step  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    numpy_from_tensor,
    tensor_from_numpy,
    train_state_from_reference,
    train_state_to_reference,
)
from repro_torch.config import OptimConfig, RunConfig  # noqa: E402
from repro_torch.configs import ARCHS as PORT_ARCHS, get  # noqa: E402
from repro_torch.data.synthetic import SyntheticDataset  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.model_api import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.training.state import init_train_state  # noqa: E402
from repro_torch.training.step import make_train_step  # noqa: E402

torch.set_num_threads(1)
LOSS_ATOL = 2e-3
GRAD_SHARE = 0.02      # of each leaf's largest reference magnitude
MOMENT_SHARE = 0.03    # the same, against the jitted reference's step
PARAM_CHANGE_SHARE = 0.15  # ||port's change - reference's|| / ||reference's||
SEQ, BATCH = 32, 4


def _leaf_close(got, want, share: float, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    lim = share * max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= lim, f"{what}: max abs err {err:.3g} over {lim:.3g}"


def _ref_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _clone(state):
    """A deep copy of a port state (its step updates leaves in place)."""
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else np.array(x), state)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-360m", "llava-next-mistral-7b",
                                  "whisper-medium"])
def test_batches_are_the_reference_bytes(arch):
    cfg_ref, cfg = REDUCED[arch], get(arch, reduced=True)
    for seed in (0, 3):
        ref = RefData(cfg_ref, 48, 3, seed=seed)
        port = SyntheticDataset(cfg, 48, 3, seed=seed)
        for step in (0, 1, 17):
            a, b = ref.batch(step), port.batch(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes(), (arch, seed, step, k)


# ---------------------------------------------------------------------------
# optimizer and compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_schedule_equals_the_reference(schedule):
    kw = dict(learning_rate=1e-3, warmup_steps=10, total_steps=100,
              schedule=schedule)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 250):
        want = float(ref_adamw.lr_schedule(RefOptim(**kw), jnp.asarray(step)))
        got = float(adamw.lr_schedule(OptimConfig(**kw), step))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def _random_tree(rng):
    return {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((3,)).astype(np.float32),
                  "d": 0.01 * rng.standard_normal((4, 2, 3)).astype(
                      np.float32)}}


def _torch_tree(tree):
    return tree_map(lambda a: tensor_from_numpy(np.asarray(a)), tree)


def test_global_norm_and_clip_equal_the_reference():
    rng = np.random.default_rng(0)
    tree = _random_tree(rng)
    want = float(ref_adamw.global_norm(tree))
    got = adamw.global_norm(_torch_tree(tree))
    assert float(got) == pytest.approx(want, rel=1e-6)
    for max_norm in (0.5, 1e3):
        ref = ref_adamw.clip_by_global_norm(tree, max_norm,
                                            jnp.asarray(want))
        port = adamw.clip_by_global_norm(_torch_tree(tree), max_norm, got)
        for a, b in zip(jax.tree.leaves(ref), tree_leaves(port)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)


def test_adamw_update_equals_the_reference():
    rng = np.random.default_rng(1)
    cfg_kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=20)
    params = _random_tree(rng)
    ref_p, ref_o = params, ref_adamw.adamw_init(params)
    port_p = _torch_tree(params)
    port_o = adamw.adamw_init(port_p)
    for _ in range(3):
        grads = _random_tree(rng)
        ref_p, ref_o, ref_i = ref_adamw.adamw_update(ref_p, grads, ref_o,
                                                     RefOptim(**cfg_kw))
        port_p, port_o, port_i = adamw.adamw_update(
            port_p, _torch_tree(grads), port_o, OptimConfig(**cfg_kw))
        for tree_r, tree_p in ((ref_p, port_p), (ref_o["mu"], port_o["mu"]),
                               (ref_o["nu"], port_o["nu"])):
            for a, b in zip(jax.tree.leaves(tree_r), tree_leaves(tree_p)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           atol=1e-6, rtol=0)
        assert int(port_o["step"]) == int(ref_o["step"])
        assert float(port_i["lr"]) == pytest.approx(float(ref_i["lr"]),
                                                    rel=1e-6)
        assert float(port_i["grad_norm"]) == pytest.approx(
            float(ref_i["grad_norm"]), rel=1e-6)


def test_int8_compression_is_exact_with_the_reference_noise():
    rng = np.random.default_rng(2)
    tree = _random_tree(rng)
    tree["b"]["d"][0, 0, 0] = 0.0
    key = jax.random.key(7)
    leaves = jax.tree.leaves(tree)
    keys = jax.random.split(key, len(leaves))
    for g, k in zip(leaves, keys):
        want = np.asarray(ref_coll._quantize_int8(jnp.asarray(g), k))
        noise = np.asarray(jax.random.uniform(k, g.shape, jnp.float32) - 0.5)
        got = collectives.quantize_int8(torch.from_numpy(g),
                                        torch.from_numpy(noise.copy()))
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes()
    # the tree form draws each leaf's noise in tree order from the generator
    port = _torch_tree(tree)
    gen = torch.Generator().manual_seed(3)
    out = collectives.compress_grads(port, gen, "int8")
    gen = torch.Generator().manual_seed(3)
    for g, o in zip(tree_leaves(port), tree_leaves(out)):
        noise = collectives.int8_noise(g.shape, gen, g.device)
        assert torch.equal(o, collectives.quantize_int8(g, noise))
    assert collectives.compress_grads(port, None, "none") is port
    with pytest.raises(ValueError, match="unknown compression"):
        collectives.compress_grads(port, gen, "fp4")


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["smollm-360m", "qwen3-8b",
                                        "llava-next-mistral-7b"])
def loss_pair(request):
    arch = request.param
    cfg = REDUCED[arch]
    ref = ref_get_model(cfg)
    ref_params = ref.init(jax.random.key(0))
    batch = RefData(cfg, SEQ, BATCH, seed=0).batch(0)
    with jax.disable_jit():
        (loss, aux), grads = jax.value_and_grad(ref.loss, has_aux=True)(
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


def test_the_loss_runs_kernel_routes_only_where_asked():
    """On the CPU every op is the plain version, the backward too: each
    layer's attention and block norms run twice (the forward, and its
    recompute under ``remat_policy`` full), the final norm once."""
    from repro_torch.kernels import ops

    model = get_model(get("smollm-360m", reduced=True))
    tree = tree_map(lambda t: t.requires_grad_(),
                    model.init_master(0, device="cpu"))
    batch = _port_batch(RefData(REDUCED["smollm-360m"], 16, 2).batch(0))
    ops.reset_counts()
    loss, _ = model.loss(tree, batch)
    loss.backward()
    c = ops.counts()
    cfg = model.cfg
    assert c["flash_attention_bwd"]["plain"] == 2 * cfg.n_layers
    assert c["rmsnorm_bwd"]["plain"] == 2 * 2 * cfg.n_layers + 1
    assert all(v["launches"] == 0 for v in c.values())
    assert all(t.grad is not None and t.grad.dtype == torch.float32
               for t in tree_leaves(tree))


def test_master_init_rounds_to_the_serving_weights():
    """``init_master`` draws what ``init`` draws for one seed, kept f32."""
    model = get_model(get("qwen3-8b", reduced=True))
    tree = model.init_master(4, device="cpu")
    params = model.init(4, device="cpu")
    served = model.param_tree(params)
    for a, b, spec in zip(tree_leaves(tree), tree_leaves(served),
                          tree_leaves(model.param_specs)):
        assert a.dtype == torch.float32
        assert torch.equal(a.to(b.dtype), b)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_setup():
    cfg = REDUCED["smollm-360m"]
    ref_model = ref_get_model(cfg)
    ref_state = ref_init_state(ref_model, seed=0)
    ds = RefData(cfg, SEQ, BATCH, seed=0)
    port = get_model(get("smollm-360m", reduced=True))
    host = jax.tree.map(np.asarray, ref_state)
    return cfg, ref_model, ref_state, ds, port, host


@pytest.mark.parametrize("micro", [1, 2])
def test_three_train_steps_equal_the_reference(step_setup, micro):
    cfg, ref_model, ref_state, ds, port, host = step_setup
    ref_step = jax.jit(ref_make_step(ref_model, RefRun(
        arch=cfg.arch_id, microbatches=micro)))
    step = make_train_step(port, RunConfig(arch=cfg.arch_id,
                                           microbatches=micro))
    rs = ref_state
    ps = train_state_from_reference(host, device="cpu")
    for i in range(3):
        b = ds.batch(i)
        rs, rm = ref_step(rs, _ref_batch(b))
        ps, pm = step(ps, _port_batch(b))
        assert float(pm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  abs=LOSS_ATOL)
        assert float(pm["ce"]) == pytest.approx(float(rm["ce"]),
                                                abs=LOSS_ATOL)
        assert float(pm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=GRAD_SHARE)
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        assert float(pm["tokens"]) == float(rm["tokens"])
    mine = train_state_to_reference(ps)
    theirs = jax.tree.map(np.asarray, rs)
    for p0, a, b in zip(jax.tree.leaves(host["params"]),
                        jax.tree.leaves(theirs["params"]),
                        jax.tree.leaves(mine["params"])):
        p0 = np.asarray(p0, np.float64)
        want = np.asarray(a, np.float64) - p0
        got = np.asarray(b, np.float64) - p0
        share = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert share <= PARAM_CHANGE_SHARE, (p0.shape, share)
    for key in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(theirs["opt"][key]),
                        jax.tree.leaves(mine["opt"][key])):
            _leaf_close(b, a, MOMENT_SHARE, key)
    assert int(mine["opt"]["step"]) == int(theirs["opt"]["step"]) == 3
    assert int(mine["data_step"]) == int(theirs["data_step"]) == 3
    assert mine["rng"].dtype == theirs["rng"].dtype == np.uint32


def test_train_state_crosses_the_bridge_both_ways(step_setup):
    *_, port, host = step_setup
    state = train_state_from_reference(host, device="cpu")
    back = train_state_to_reference(state)
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(back)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    mine = init_train_state(port, seed=0, device="cpu")
    assert [np.asarray(x).dtype for x in jax.tree.leaves(host)] == \
        [numpy_from_tensor(x).dtype if isinstance(x, torch.Tensor)
         else np.asarray(x).dtype for x in tree_leaves(mine)]


# ---------------------------------------------------------------------------
# tests/test_step.py on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    cfg = get("smollm-360m", reduced=True)
    model = get_model(cfg)
    state = init_train_state(model, seed=0, device="cpu")
    ds = SyntheticDataset(cfg, 32, 4, seed=0)
    batch = _port_batch(ds.batch(0))
    return cfg, model, state, batch


def test_microbatching_matches_single_batch(setup):
    cfg, model, state, batch = setup
    s1 = make_train_step(model, RunConfig(arch=cfg.arch_id, microbatches=1))
    s2 = make_train_step(model, RunConfig(arch=cfg.arch_id, microbatches=2))
    out1, m1 = s1(_clone(state), batch)
    out2, m2 = s2(_clone(state), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), abs=2e-3)
    for a, b in zip(tree_leaves(out1["params"]), tree_leaves(out2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4,
                                   rtol=5e-4)


def test_int8_compression_close_but_not_identical(setup):
    cfg, model, state, batch = setup
    plain = make_train_step(model, RunConfig(arch=cfg.arch_id))
    comp = make_train_step(model, RunConfig(arch=cfg.arch_id,
                                            grad_compression="int8"))
    o1, m1 = plain(_clone(state), batch)
    o2, m2 = comp(_clone(state), batch)
    assert np.isfinite(float(m2["loss"]))
    diffs = [float((a - b).abs().max()) for a, b in
             zip(tree_leaves(o1["params"]), tree_leaves(o2["params"]))]
    assert 0 < max(diffs) < 1e-2


def test_grad_clipping_bounds_update(setup):
    cfg, model, state, batch = setup
    step = make_train_step(model, RunConfig(
        arch=cfg.arch_id,
        optim=OptimConfig(grad_clip_norm=1e-6, learning_rate=1.0)))
    before = _clone(state)
    out, m = step(_clone(state), batch)
    delta = max(float((a - b).abs().max()) for a, b in
                zip(tree_leaves(before["params"]),
                    tree_leaves(out["params"])))
    assert delta < 0.2   # weight decay term only


class TestOptimizer:
    def test_schedule_warmup_and_decay(self):
        cfg = OptimConfig(learning_rate=1e-3, warmup_steps=10,
                          total_steps=100)
        lrs = [float(adamw.lr_schedule(cfg, s)) for s in (0, 5, 10, 50, 100)]
        assert lrs[0] == 0.0
        assert lrs[1] == pytest.approx(5e-4)
        assert lrs[2] == pytest.approx(1e-3)
        assert lrs[3] < lrs[2]
        assert lrs[4] == pytest.approx(1e-4, rel=0.01)  # 0.1 floor

    def test_adamw_moves_toward_gradient(self):
        params = {"w": torch.ones(4)}
        opt = adamw.adamw_init(params)
        grads = {"w": torch.tensor([1.0, -1.0, 2.0, 0.0])}
        cfg = OptimConfig(learning_rate=0.1, warmup_steps=0,
                          weight_decay=0.0, schedule="constant")
        new, opt, info = adamw.adamw_update(params, grads, opt, cfg)
        w = new["w"].numpy()
        assert w[0] < 1.0 and w[1] > 1.0 and w[2] < 1.0
        assert w[3] == pytest.approx(1.0)
        assert int(opt["step"]) == 1
        assert float(info["grad_norm"]) == pytest.approx(np.sqrt(6), rel=1e-5)

    def test_global_norm(self):
        t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
        assert float(adamw.global_norm(t)) == pytest.approx(5.0)


@pytest.mark.parametrize("arch", sorted(PORT_ARCHS))
def test_every_family_trains_one_reduced_step(arch):
    """Every arch of the port has a loss: one REDUCED step on the CPU gives
    a finite loss and moves the params."""
    model = get_model(get(arch, reduced=True))
    assert model.loss is not None
    state = init_train_state(model, seed=0, device="cpu")
    before = [t.clone() for t in tree_leaves(state["params"])]
    batch = _port_batch(SyntheticDataset(model.cfg, 16, 2).batch(0))
    state, m = make_train_step(model, RunConfig(arch=arch))(state, batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(state["params"])))


def _policy_run(policy: str):
    """REDUCED qwen3-8b's loss under ``use_backend("plain")`` with
    ``remat_policy`` ``policy``, its gradients taken on another thread:
    (loss, grads, the backend each kernel call saw, forward calls)."""
    import threading
    from dataclasses import replace

    from repro_torch.kernels import ops

    cfg = replace(get("qwen3-8b", reduced=True), remat_policy=policy)
    model = get_model(cfg)
    tree = tree_map(lambda t: t.requires_grad_(),
                    model.init_master(0, device="cpu"))
    batch = _port_batch(SyntheticDataset(cfg, 16, 2).batch(0))
    seen = []
    real = ops._plain

    def spy(x, name):
        seen.append(ops.current_backend())
        return real(x, name)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_plain", spy)
        with ops.use_backend("plain"):
            loss, _ = model.loss(tree, batch)
        n_forward = len(seen)
        out = []
        worker = threading.Thread(target=lambda: out.append(
            torch.autograd.grad(loss, tree_leaves(tree))))
        worker.start()
        worker.join()
    return float(loss), out[0], seen, n_forward


@pytest.mark.parametrize("policy", ["full", "dots", "none"])
def test_remat_policies_give_one_gradient_under_the_forwards_backend(policy):
    """Every ``remat_policy`` gives the same loss and gradients bit for bit
    (``full`` and ``dots`` recompute, ``none`` keeps everything), and a
    recompute run from another thread — where autograd runs a CUDA
    backward — sees the backend the forward ran under."""
    loss, grads, seen, n_forward = _policy_run(policy)
    assert set(seen) == {"plain"}
    # every layer's kernel calls again, the final norm not
    assert len(seen) - n_forward == (0 if policy == "none"
                                     else n_forward - 1)
    if policy != "full":
        full_loss, full_grads, _, _ = _policy_run("full")
        assert loss == full_loss
        assert all(torch.equal(a, b) for a, b in zip(grads, full_grads))
