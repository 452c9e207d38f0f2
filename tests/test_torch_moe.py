"""The port's MoE family against the JAX package's, REDUCED
``granite-moe-1b-a400m`` (4 experts, top-2, tied embeddings) and
``deepseek-moe-16b`` (8 experts, top-2, a shared expert, a leading dense
layer), with the reference's weights from ``ModelFns.init(jax.random.key(
0))`` handed across by the bridge.

- the bridge carries ``dense_layers`` and ``moe_layers`` into the port's
  layers, the f32 router bit for bit;
- routing: ids exactly and weights to 1e-6 against ``repro/models/moe.py``'s
  routing lines (``moe.py:209-213``), each token's result independent of
  the others;
- capacity: the kept (token, choice) pairs, their ranks and the per-expert
  counts exactly the reference's (``moe.py:216-236``), on a chunk of 32
  tokens over 4 experts where pairs are dropped;
- combine: XLA's scatter-add of bf16 contributions rounds to bf16 after
  each add, in update order, both jitted and op by op (measured here);
  ``moe.combine`` equals it bit for bit;
- ``moe_mlp_forward`` against the reference's, and prefill-chunk, paged
  decode, dense prefill and dense decode logits at every step;
- the paged and the dense engine token for token with equal ``stats``
  against the reference run op by op (``jax.disable_jit``; ROADMAP Queue 3,
  P1), and a paged snapshot restored across packages both ways.

Tolerances: logits and MLP outputs atol = 5e-2, rtol = 2e-2, as
``tests/test_torch_model.py`` (XLA keeps excess precision where a bf16
product feeds an f32 consumer, and sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REDUCED  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import get_model, moe  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=5e-2, rtol=2e-2)
ARCHS = ["granite-moe-1b-a400m", "deepseek-moe-16b"]


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    arch = request.param
    cfg = REDUCED[arch]
    jm = ref_get_model(cfg)
    jp = jm.init(jax.random.key(0))
    tm = get_model(get(arch, reduced=True))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return cfg, jm, jp, tm, tp


def _bf16(a: np.ndarray):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
        torch.bfloat16)


def _layer(jp, group: str, i: int):
    return jax.tree.map(lambda v: v[i], jp[group])


def _ref_route(xf, router, cfg):
    """``repro/models/moe.py:209-213``."""
    logits = jnp.einsum("td,de->te", xf.astype(jnp.float32),
                        router.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    weights, sel = jax.lax.top_k(probs, cfg.moe_top_k)
    weights = weights / jnp.maximum(weights.sum(-1, keepdims=True), 1e-9)
    return np.asarray(weights), np.asarray(sel)


def _ref_dispatch(sel, cfg, S):
    """``repro/models/moe.py:216-236``, token-major: each pair's rank and
    whether it is kept, the counts and the capacity."""
    T, k = sel.shape
    E = cfg.n_experts
    counts = jnp.bincount(sel.reshape(-1), length=E)
    cap = int(np.ceil(T * k * cfg.capacity_factor / E))
    cap = max(8, min(cap, T))
    if S == 1:
        cap = max(cap, T)
    e_flat = jnp.asarray(sel.reshape(-1))
    order = jnp.argsort(e_flat, stable=True)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(T * k) - starts[e_flat[order]]
    by_pair = np.empty(T * k, np.int64)
    by_pair[np.asarray(order)] = np.asarray(rank)
    return by_pair, by_pair < cap, np.asarray(counts), cap


def test_bridge_carries_both_layer_groups_and_the_f32_router(fam):
    cfg, _, jp, _, tp = fam
    nd = cfg.first_k_dense
    assert len(tp.layers) == cfg.n_layers
    for i in range(cfg.n_layers - nd):
        mlp = tp.layers[nd + i].mlp
        ref = _layer(jp, "moe_layers", i)["mlp"]
        assert mlp.router.dtype == torch.float32
        assert np.array_equal(mlp.router.numpy(), np.asarray(ref["router"]))
        for name in ("wg", "wu", "wd"):
            want = np.asarray(jnp.asarray(ref[name], jnp.bfloat16))
            assert np.array_equal(
                getattr(mlp, name).view(torch.int16).numpy(),
                want.view(np.int16)), name
        assert (mlp.shared is None) == (not cfg.n_shared_experts)
        if mlp.shared is not None:
            want = np.asarray(jnp.asarray(ref["shared"]["wd"], jnp.bfloat16))
            assert np.array_equal(mlp.shared.wd.view(torch.int16).numpy(),
                                  want.view(np.int16))
    for i in range(nd):
        ref = _layer(jp, "dense_layers", i)
        want = np.asarray(jnp.asarray(ref["mlp"]["wg"], jnp.bfloat16))
        assert tp.layers[i].mlp.wg.shape == (cfg.d_model, cfg.d_ff_dense)
        assert np.array_equal(tp.layers[i].mlp.wg.view(torch.int16).numpy(),
                              want.view(np.int16))


def test_routing_ids_and_weights_equal_the_references(fam):
    cfg, _, jp, _, tp = fam
    rng = np.random.default_rng(3)
    jx, tx = _bf16(rng.standard_normal((40, cfg.d_model)))
    nd = cfg.first_k_dense
    router = tp.layers[nd].mlp.router
    want_w, want_ids = _ref_route(jx, _layer(jp, "moe_layers", 0)[
        "mlp"]["router"], cfg)
    w, ids = ops.moe_route(tx, router, cfg.moe_top_k)
    assert ids.dtype == torch.int32 and w.dtype == torch.float32
    assert np.array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(w.numpy(), want_w, atol=1e-6, rtol=1e-6)
    # a token's routing does not depend on the other tokens of the call
    for lo, hi in ((0, 1), (7, 15), (39, 40)):
        wi, ii = ops.moe_route(tx[lo:hi], router, cfg.moe_top_k)
        assert torch.equal(ii, ids[lo:hi]) and torch.equal(wi, w[lo:hi])


def test_ties_go_to_the_lower_expert():
    """Equal probabilities rank by expert id, as ``lax.top_k`` ranks them."""
    x = torch.ones(2, 4, dtype=torch.bfloat16)
    router = torch.zeros(4, 6)
    router[:, 4] = 1.0             # expert 4 first, then 0..3, 5 all tied
    w, ids = ops.moe_route(x, router, 3)
    assert ids.tolist() == [[4, 0, 1], [4, 0, 1]]
    _, jids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(
        (x.float() @ router).numpy()), axis=-1), 3)
    assert ids.tolist() == np.asarray(jids).tolist()


def test_capacity_drops_equal_the_references():
    """REDUCED granite, one 32-token chunk over 4 experts (top-2, capacity
    20): the kept pairs, their ranks and the counts are the reference's,
    and pairs are dropped; the chunk's MoE output matches the reference's,
    which it would not if a different pair were dropped."""
    cfg = REDUCED["granite-moe-1b-a400m"]
    jm = ref_get_model(cfg)
    jp = jm.init(jax.random.key(0))
    tm = get_model(get(cfg.arch_id, reduced=True))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tm, device="cpu")
    rng = np.random.default_rng(5)
    jx, tx = _bf16(rng.standard_normal((1, 32, cfg.d_model)))
    jlayer = _layer(jp, "moe_layers", 0)["mlp"]
    _, sel = _ref_route(jx.reshape(32, -1), jlayer["router"], cfg)
    want_rank, want_keep, want_counts, want_cap = _ref_dispatch(sel, cfg, 32)
    e, _, rank, keep, counts, cap = moe.route(tp.layers[0].mlp,
                                              tx.reshape(32, -1), cfg, 32)
    assert cap == want_cap == 20
    assert np.array_equal(e.numpy(), sel.reshape(-1))
    assert np.array_equal(counts.numpy(), want_counts)
    assert np.array_equal(rank.numpy(), want_rank)
    assert np.array_equal(keep.numpy(), want_keep)
    assert (~want_keep).sum() > 0          # pairs are dropped here
    with jax.disable_jit():
        want, _ = jmoe.moe_mlp_forward(jlayer, jx, cfg)
    got = moe.moe_mlp_forward(tp.layers[0].mlp, tx, cfg)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("jit", [False, True])
def test_combine_rounds_after_each_add_like_the_reference(jit):
    """The reference's combine, ``zeros(bf16).at[tok].add(contrib)``
    (``moe.py:250``), applies a token's contributions in update order and
    rounds to bf16 after each add, jitted and op by op alike: it equals
    ``moe.combine`` bit for bit, and differs from an f32 sum rounded
    once."""
    rng = np.random.default_rng(9)
    T, k, d = 24, 6, 64
    jc, tc = _bf16(rng.standard_normal((T * k, d)) * 3)
    tok = jnp.repeat(jnp.arange(T), k)

    def scatter(c):
        return jnp.zeros((T, d), jnp.bfloat16).at[tok].add(c)

    if jit:
        want = jax.jit(scatter)(jc)
    else:
        with jax.disable_jit():
            want = scatter(jc)
    want = np.asarray(want).view(np.int16)
    got = moe.combine(tc.view(T, k, d))
    assert np.array_equal(got.view(torch.int16).numpy(), want)
    once = tc.view(T, k, d).float().sum(1).bfloat16()
    assert not np.array_equal(once.view(torch.int16).numpy(), want)


@pytest.mark.parametrize("shape", [(2, 24), (5, 1), (40, 1)])
def test_moe_mlp_forward_matches_the_reference(fam, shape):
    """A layer's routed and shared experts, a prefill-like (S 24) and a
    decode-like (S 1, no drop) call, against the reference op by op."""
    cfg, _, jp, _, tp = fam
    rng = np.random.default_rng(sum(shape))
    jx, tx = _bf16(rng.standard_normal((*shape, cfg.d_model)))
    jlayer = _layer(jp, "moe_layers", 0)["mlp"]
    with jax.disable_jit():
        want, _ = jmoe.moe_mlp_forward(jlayer, jx, cfg)
    got = moe.moe_mlp_forward(tp.layers[cfg.first_k_dense].mlp, tx, cfg)
    assert got.shape == (*shape, cfg.d_model) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def test_only_the_paged_decode_takes_the_row_invariant_products(fam):
    """The products are chosen by entry point: a paged decode step (and so
    the verify folded into it) takes ``ops.gemm_rows_grouped`` for the
    routed experts (3 a MoE layer) and ``ops.gemm_rows`` for every other
    product (q, k, v, o a layer, the shared experts' and the dense layers'
    three, the unembedding); a prefill chunk and the dense engine's calls
    take neither. Every call routes through ``ops.moe_route``."""
    cfg, _, _, tm, tp = fam
    nd, n_moe = cfg.first_k_dense, cfg.n_layers - cfg.first_k_dense
    rows = 4 * cfg.n_layers + 3 * nd + 3 * n_moe * bool(
        cfg.n_shared_experts) + 1
    cache = tm.init_paged_cache(2, 9, 16, device="cpu")
    table = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    toks = torch.randint(1, 512, (2, 3), dtype=torch.int32)
    pos = torch.tensor([20, 5], dtype=torch.int32)
    calls = {
        "prefill_chunk": lambda: tm.prefill_chunk(tp, cache, {
            "tokens": torch.zeros(1, 32, dtype=torch.int32), "valid": 20,
            "slot": 0, "page_table": table[0]}, offset=0),
        "decode_paged": lambda: tm.decode_paged(tp, cache, {
            "tokens": toks[:, :1], "positions": pos, "page_table": table}),
        "verify_paged": lambda: tm.verify_paged(tp, cache, {
            "tokens": toks, "positions": pos, "page_table": table}),
        "decode_step": lambda: tm.decode_step(
            tp, tm.init_cache(2, 32, device="cpu"),
            {"tokens": toks[:, :1], "positions": pos}),
        "prefill": lambda: tm.prefill(tp, {"tokens": toks}),
    }
    for name, call in calls.items():
        ops.reset_counts()
        call()
        paged = name in ("decode_paged", "verify_paged")
        plain = {n: c["plain"] for n, c in ops.counts().items()}
        assert plain["gemm_rows"] == (rows if paged else 0), name
        assert plain["gemm_rows_grouped"] == (3 * n_moe if paged else 0)
        assert plain["moe_route"] == n_moe, name


# ---------------------------------------------------------------------------
# Logits at every step: paged chunks and decode, dense prefill and decode
# ---------------------------------------------------------------------------

PAGE, CHUNK, MAX_PAGES, N_PAGES = 16, 64, 10, 24
LENS, STEPS = (100, 40), 5


@pytest.fixture(scope="module")
def paged_run(fam):
    cfg, jm, jp, tm, tp = fam
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in LENS]
    forced = rng.integers(1, cfg.vocab_size, (len(LENS), STEPS))
    ids = rng.permutation(np.arange(1, N_PAGES))[: len(LENS) * MAX_PAGES]
    table = ids.reshape(len(LENS), MAX_PAGES).astype(np.int32)
    jcache = jm.init_paged_cache(len(LENS), N_PAGES, PAGE)
    tcache = tm.init_paged_cache(len(LENS), N_PAGES, PAGE, device="cpu")
    steps = []
    with jax.disable_jit():
        for b, p in enumerate(prompts):
            for off in range(0, len(p), CHUNK):
                n = min(CHUNK, len(p) - off)
                toks = np.zeros((1, CHUNK), np.int32)
                toks[0, :n] = p[off:off + n]
                jl, jcache = jm.prefill_chunk(jp, jcache, {
                    "tokens": jnp.asarray(toks), "valid": jnp.asarray(n),
                    "slot": jnp.asarray(b),
                    "page_table": jnp.asarray(table[b])}, offset=off)
                tl = tm.prefill_chunk(tp, tcache, {
                    "tokens": torch.from_numpy(toks), "valid": n,
                    "page_table": torch.from_numpy(table[b])}, offset=off)
                steps.append((f"lane {b} chunk @{off}", np.asarray(jl),
                              tl.numpy()))
        pos = np.array(LENS, np.int32)
        for s in range(STEPS):
            toks = forced[:, s:s + 1].astype(np.int32)
            jl, jcache = jm.decode_paged(jp, jcache, {
                "tokens": jnp.asarray(toks), "positions": jnp.asarray(pos),
                "page_table": jnp.asarray(table)})
            tl = tm.decode_paged(tp, tcache, {
                "tokens": torch.from_numpy(toks),
                "positions": torch.from_numpy(pos),
                "page_table": torch.from_numpy(table)})
            steps.append((f"decode {s}", np.asarray(jl), tl.numpy()))
            pos = pos + 1
    return steps, jcache, tcache, table, pos


def test_paged_logits_match_at_every_step(paged_run):
    steps = paged_run[0]
    assert len(steps) == 2 + 1 + STEPS
    for what, want, got in steps:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
        assert (got.argmax(-1) == want.argmax(-1)).all(), what


def test_paged_pools_match_at_written_positions(paged_run):
    _, jcache, tcache, table, end = paged_run
    for name in ("k_pages", "v_pages"):
        ref_pool = np.asarray(jcache[name], np.float32)
        pool = tcache[name].float().numpy()
        for b, n in enumerate(end):
            pos = np.arange(n)
            pid, off = table[b][pos // PAGE], pos % PAGE
            np.testing.assert_allclose(pool[:, pid, off],
                                       ref_pool[:, pid, off],
                                       err_msg=f"{name} lane {b}", **TOL)


def test_dense_logits_and_cache_match(fam):
    """Two prompts left-padded into buckets of 32 and 64, prefilled whole
    and scattered into a dense cache, then 4 teacher-forced decode steps."""
    cfg, jm, jp, tm, tp = fam
    rng = np.random.default_rng(21)
    forced = rng.integers(1, cfg.vocab_size, (2, 4)).astype(np.int32)
    jcache = jm.init_cache(2, 80)
    tcache = tm.init_cache(2, 80, device="cpu")
    with jax.disable_jit():
        for slot, (n, bucket) in enumerate(((20, 32), (64, 64))):
            toks = np.zeros((1, bucket), np.int32)
            toks[0, bucket - n:] = rng.integers(1, cfg.vocab_size, n)
            jl, jpc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
            jcache = jkv.scatter_slot(jcache, jkv.expand_prefill_cache(
                jpc, jax.tree.map(lambda c: c[:, :1], jcache)),
                jnp.asarray(slot))
            tl, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
            kvcache.scatter_slot(tcache, kvcache.expand_prefill_cache(
                tpc, {k: v[:, :1] for k, v in tcache.items()}), slot)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       err_msg=f"prefill {slot}", **TOL)
        pos = np.array([32, 64], np.int32)
        for s in range(4):
            toks = forced[:, s:s + 1]
            jl, jcache = jm.decode_step(jp, jcache, {
                "tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)})
            tl = tm.decode_step(tp, tcache, {
                "tokens": torch.from_numpy(toks),
                "positions": torch.from_numpy(pos)})
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       err_msg=f"decode {s}", **TOL)
            pos = pos + 1
    for name, t in tcache.items():
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(jcache[name], np.float32),
                                   err_msg=name, **TOL)


# ---------------------------------------------------------------------------
# Engines, token for token, and snapshots across packages
# ---------------------------------------------------------------------------


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, cfg.vocab_size, 24).tolist()
    return [(prefix if i % 2 else []) + rng.integers(
        1, cfg.vocab_size, n).tolist() for i, n in enumerate(lens)]


def _tokens(eng) -> list:
    return [r.generated for r in sorted(eng.requests.values(),
                                        key=lambda r: r.req_id)]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_engine_tokens_and_stats_equal_the_references(fam, paged):
    """5 requests on 3 slots (every other one behind a shared 24-token
    prefix): the same tokens, the same ``stats`` counters, the same slot
    bookkeeping as the reference run op by op."""
    cfg, jm, jp, tm, tp = fam
    kw = dict(n_slots=3, max_seq=96, paged=paged)
    if paged:
        kw.update(page_size=16, prefill_chunk=32)
    ref = RefEngine(jm, jp, **kw)
    port = ServeEngine(tm, tp, device="cpu", **kw)
    prompts = _prompts(cfg, [12, 20, 9, 30, 6], seed=4)
    for eng in (ref, port):
        for p in prompts:
            eng.submit(p, max_new_tokens=5)
    with jax.disable_jit():
        ref.run(400)
    port.run(400)
    assert all(r.done for r in port.requests.values())
    assert _tokens(port) == _tokens(ref)
    assert port.stats == ref.stats
    if paged:
        assert port.stats["prefix_hits"] > 0


@pytest.fixture(scope="module")
def crossing():
    """REDUCED deepseek-moe-16b, paged: each package's uninterrupted run,
    and each package's blob after 3 steps (the reference op by op)."""
    cfg = REDUCED["deepseek-moe-16b"]
    jm = ref_get_model(cfg)
    jp = jm.init(jax.random.key(0))
    tm = get_model(get(cfg.arch_id, reduced=True))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tm, device="cpu")
    prompts = _prompts(cfg, [8, 24, 40, 12], seed=7)
    makers = {"ref": lambda: RefEngine(jm, jp, n_slots=2, max_seq=96),
              "port": lambda: ServeEngine(tm, tp, n_slots=2, max_seq=96,
                                          device="cpu")}
    out = {"makers": makers}
    with jax.disable_jit():
        for side, make in makers.items():
            whole = make()
            for p in prompts:
                whole.submit(p, max_new_tokens=6)
            whole.run(400)
            out[side + "_tokens"] = _tokens(whole)
            cut = make()
            for p in prompts:
                cut.submit(p, max_new_tokens=6)
            for _ in range(3):
                cut.step()
            out[side + "_blob"] = cut.snapshot()
    assert out["ref_tokens"] == out["port_tokens"]
    return out


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_snapshot_restores_across_packages(crossing, direction):
    src, dst = direction.split("_to_")
    eng = crossing["makers"][dst]()
    eng.restore(crossing[src + "_blob"])
    with jax.disable_jit():
        eng.run(400)
    assert all(r.done for r in eng.requests.values())
    assert _tokens(eng) == crossing[src + "_tokens"]
