"""The port's enc-dec family against the JAX package's, REDUCED
``whisper-medium`` (2 encoder and 2 decoder layers, d 64, 4 heads of 16,
GELU MLP, learned positions, tied unembedding), with the reference's
weights from ``ModelFns.init(jax.random.key(0))`` handed across by the
bridge, the reference run op by op (``jax.disable_jit``; ROADMAP Queue 3,
P1).

- the bridge carries ``enc_layers`` and ``dec_layers`` (``self_attn``,
  ``cross_attn``, ``mlp``) and the positions into the port's modules;
- the GELU MLP is ``jax.nn.gelu``'s tanh approximation in f32, not the
  exact erf GELU;
- ``ref.paged_cross_attention`` and ``ops.paged_cross_attention`` against
  ``repro.kernels.ref.paged_cross_attention`` at the shapes of
  ``tests/test_paged_multimodal.py:109-111``, 2e-2 in bf16 and 2e-5 in f32;
- ``encode``, the dense prefill and decode steps, ``prefill_cross``, the
  prefill chunks and ``decode_paged``: logits at every step, the caches
  and pools at every written position;
- only the paged decode step takes the row-invariant products.

Tolerances: logits atol = 5e-2, rtol = 2e-2, as
``tests/test_torch_model.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REDUCED  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.models import layers as jll  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import encdec, get_model  # noqa: E402
from repro_torch.models import layers as ll  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=5e-2, rtol=2e-2)
ARCH = "whisper-medium"


@pytest.fixture(scope="module")
def fam():
    cfg = REDUCED[ARCH]
    jm = ref_get_model(cfg)
    jp = jm.init(jax.random.key(0))
    tm = get_model(get(ARCH, reduced=True))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return cfg, jm, jp, tm, tp


def _bf16(a: np.ndarray):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
        torch.bfloat16)


def _frames(cfg, n, seed):
    return np.random.default_rng(seed).standard_normal(
        (1, n, cfg.d_model)).astype(np.float32)


def test_bridge_carries_both_stacks_and_the_positions(fam):
    cfg, _, jp, _, tp = fam
    assert len(tp.enc_layers) == cfg.n_encoder_layers
    assert len(tp.dec_layers) == cfg.n_layers
    assert tp.dec_pos.shape == (cfg.max_position, cfg.d_model)
    assert tp.enc_pos.shape == (encdec.ENC_SEQ, cfg.d_model)
    assert tp.enc_pos.dtype == torch.bfloat16
    assert tp.enc_final_ln.dtype == torch.float32
    for part in ("self_attn", "cross_attn"):
        want = np.asarray(jnp.asarray(jp["dec_layers"][part]["wq"][1],
                                      jnp.bfloat16))
        got = getattr(tp.dec_layers[1][part], "wq")
        assert np.array_equal(got.view(torch.int16).numpy(),
                              want.view(np.int16))
    want = np.asarray(jnp.asarray(jp["enc_layers"]["mlp"]["wi"][0],
                                  jnp.bfloat16))
    assert np.array_equal(tp.enc_layers[0]["mlp"].wi.view(torch.int16)
                          .numpy(), want.view(np.int16))
    assert not hasattr(tp.enc_layers[0]["mlp"], "wg")


def test_gelu_mlp_is_the_tanh_approximation(fam):
    cfg, _, jp, _, tp = fam
    rng = np.random.default_rng(2)
    jx, tx = _bf16(rng.standard_normal((3, 7, cfg.d_model)))
    jlayer = jax.tree.map(lambda v: v[0], jp["dec_layers"]["mlp"])
    with jax.disable_jit():
        want = np.asarray(jll.mlp_forward(jlayer, jx, cfg), np.float32)
    got = ll.mlp_forward(tp.dec_layers[0]["mlp"], tx, cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **TOL)
    # the exact (erf) GELU is another function: inputs of the hidden
    # layer's size separate the two
    h = torch.linspace(-4, 4, 1001)
    tanh = torch.nn.functional.gelu(h, approximate="tanh")
    assert (tanh - torch.nn.functional.gelu(h)).abs().max() > 1e-4
    np.testing.assert_allclose(tanh.numpy(),
                               np.asarray(jax.nn.gelu(h.numpy())),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,c,h,k,d,page,max_pages,n_pages",
                         [(2, 3, 4, 2, 16, 8, 2, 8),
                          (1, 16, 8, 8, 32, 16, 3, 8)])
def test_paged_cross_attention_matches_the_reference(b, c, h, k, d, page,
                                                     max_pages, n_pages,
                                                     dtype):
    rng = np.random.default_rng(b * 100 + c)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q = jnp.asarray(rng.standard_normal((b, c, h, d)), jdt)
    kp = jnp.asarray(rng.standard_normal((n_pages, page, k, d)), jdt)
    vp = jnp.asarray(rng.standard_normal((n_pages, page, k, d)), jdt)
    ids = rng.permutation(np.arange(1, n_pages))[: b * max_pages]
    table = ids.reshape(b, max_pages).astype(np.int32)
    lens = rng.integers(1, max_pages * page + 1, b).astype(np.int32)
    want = np.asarray(jref.paged_cross_attention(
        q, kp, vp, jnp.asarray(table), jnp.asarray(lens)), np.float32)

    def tt(a):
        a = np.asarray(a)
        if dtype == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())

    args = (tt(q), tt(kp), tt(vp), torch.from_numpy(table),
            torch.from_numpy(lens))
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)
    for fn in (ref.paged_cross_attention, ops.paged_cross_attention):
        got = fn(*args)
        assert got.shape == (b, c, h, d)
        np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,c,h,k,d,page,max_pages,n_pages",
                         [(2, 1, 16, 16, 64, 64, 3, 8),
                          (2, 17, 16, 16, 64, 64, 3, 8),
                          (1, 64, 16, 16, 16, 8, 4, 8),
                          (2, 5, 8, 2, 32, 16, 3, 8)])
def test_cross_fold_stacks_rows_into_the_kernels_groups(b, c, h, k, d, page,
                                                        max_pages, n_pages,
                                                        dtype):
    """The card's route of ``ops.paged_cross_attention`` with the paged
    decode kernel's plain twin in its place: ``cross_rows`` rows of a lane
    share a folded lane as the rows of each kv head's group (8 at whisper's
    MHA, C padded with zero rows to a multiple), against the reference's
    oracle, and every query equal to a one-lane decode at its length."""
    rng = np.random.default_rng(b * 1000 + c * 10 + h)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q = jnp.asarray(rng.standard_normal((b, c, h, d)), jdt)
    kp = jnp.asarray(rng.standard_normal((n_pages, page, k, d)), jdt)
    vp = jnp.asarray(rng.standard_normal((n_pages, page, k, d)), jdt)
    table = rng.permutation(np.arange(1, n_pages))[: b * max_pages] \
        .reshape(b, max_pages).astype(np.int32)
    lens = rng.integers(1, max_pages * page + 1, b).astype(np.int32)
    want = np.asarray(jref.paged_cross_attention(
        q, kp, vp, jnp.asarray(table), jnp.asarray(lens)), np.float32)

    def tt(a):
        a = np.asarray(a)
        if dtype == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())

    tq, tk, tv = tt(q), tt(kp), tt(vp)
    ttab, tlen = torch.from_numpy(table), torch.from_numpy(lens)
    rows = ops.cross_rows(c, h, k)
    assert rows == min(8 // (h // k), c)
    got = ops._cross_fold(tq, tk, tv, ttab, tlen,
                          run=ref.paged_decode_attention)
    assert got.shape == (b, c, h, d) and got.dtype == tq.dtype
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    for i in range(b):
        for j in range(c):
            one = ref.paged_decode_attention(tq[i, j][None], tk, tv,
                                             ttab[i:i + 1], tlen[i:i + 1])
            np.testing.assert_allclose(got[i, j].float().numpy(),
                                       one[0].float().numpy(), **tol)


def test_encode_matches_the_reference(fam):
    cfg, _, jp, _, tp = fam
    f = _frames(cfg, 13, seed=3)
    with jax.disable_jit():
        want = np.asarray(jencdec.encode(jp, jnp.asarray(f), cfg), np.float32)
    got = encdec.encode(tp, torch.from_numpy(f), cfg)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 13, cfg.d_model)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL)


def test_only_the_paged_decode_takes_the_row_invariant_products(fam):
    """The paged decode step takes ``ops.gemm_rows`` for q, k, v, o of the
    self attention, q and o of the cross attention, the MLP's two and the
    unembedding (8 a layer and 1); its cross read goes through
    ``ops.paged_cross_attention`` (the paged decode dispatch). Prefill,
    ``prefill_cross`` and the dense path take none."""
    cfg, _, _, tm, tp = fam
    cache = tm.init_paged_cache(2, 9, 8, device="cpu")
    table = torch.arange(1, 7, dtype=torch.int32).reshape(2, 3)
    ctable = torch.tensor([[7, 8], [7, 8]], dtype=torch.int32)
    clen = torch.tensor([12, 9], dtype=torch.int32)
    frames = torch.from_numpy(_frames(cfg, 12, seed=1))
    calls = {
        "prefill_cross": lambda: tm.prefill_cross(tp, cache, {
            "frames": frames, "cross_page_table": ctable[0]}),
        "prefill_chunk": lambda: tm.prefill_chunk(tp, cache, {
            "tokens": torch.ones(1, 8, dtype=torch.int32), "valid": 5,
            "page_table": table[0], "cross_page_table": ctable[0],
            "cross_len": clen[0]}, offset=0),
        "decode_paged": lambda: tm.decode_paged(tp, cache, {
            "tokens": torch.ones(2, 1, dtype=torch.int32),
            "positions": torch.tensor([5, 3], dtype=torch.int32),
            "page_table": table, "cross_page_table": ctable,
            "cross_len": clen}),
        "prefill": lambda: tm.prefill(tp, {
            "tokens": torch.ones(1, 8, dtype=torch.int32),
            "frames": frames}),
    }
    for name, call in calls.items():
        ops.reset_counts()
        call()
        plain = {n: c["plain"] for n, c in ops.counts().items()}
        assert plain["gemm_rows"] == (8 * cfg.n_layers + 1
                                      if name == "decode_paged" else 0), name
        assert plain["paged_decode_attention"] == (
            2 * cfg.n_layers if name == "decode_paged" else
            cfg.n_layers if name == "prefill_chunk" else 0), name


# ---------------------------------------------------------------------------
# Logits at every step: dense, and paged (cross region, chunks, decode)
# ---------------------------------------------------------------------------

PAGE, CHUNK, MAX_PAGES, MAX_CP, N_PAGES = 8, 16, 6, 3, 32
LENS, N_FRAMES, STEPS = (21, 9), (20, 11), 4


def test_dense_logits_and_cache_match(fam):
    """Two prompts with their frames prefilled whole into buckets and
    scattered into a dense cache (the cross K/V zero-padded to ``ENC_SEQ``,
    ``enc_len`` carried), then teacher-forced decode steps."""
    cfg, jm, jp, tm, tp = fam
    rng = np.random.default_rng(21)
    forced = rng.integers(1, cfg.vocab_size, (2, STEPS)).astype(np.int32)
    jcache = jm.init_cache(2, 48)
    tcache = tm.init_cache(2, 48, device="cpu")
    assert tcache["enc_len"].dtype == torch.int32
    assert tcache["cross_k"].shape[2] == encdec.ENC_SEQ
    pos = []
    with jax.disable_jit():
        for slot, (n, nf) in enumerate(zip(LENS, N_FRAMES)):
            bucket = 32
            toks = np.zeros((1, bucket), np.int32)
            toks[0, bucket - n:] = rng.integers(1, cfg.vocab_size, n)
            f = _frames(cfg, nf, seed=slot)
            jl, jpc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                      "frames": jnp.asarray(f)})
            jcache = jkv.scatter_slot(jcache, jkv.expand_prefill_cache(
                jpc, jax.tree.map(lambda c: c[:, :1], jcache)),
                jnp.asarray(slot))
            tl, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                      "frames": torch.from_numpy(f)})
            kvcache.scatter_slot(tcache, kvcache.expand_prefill_cache(
                tpc, {k: v[:, :1] for k, v in tcache.items()}), slot)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       err_msg=f"prefill {slot}", **TOL)
            pos.append(bucket)
        assert tcache["enc_len"][0, :, 0].tolist() == list(N_FRAMES)
        pos = np.array(pos, np.int32)
        for s in range(STEPS):
            toks = forced[:, s:s + 1]
            jl, jcache = jm.decode_step(jp, jcache, {
                "tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)})
            tl = tm.decode_step(tp, tcache, {
                "tokens": torch.from_numpy(toks),
                "positions": torch.from_numpy(pos)})
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       err_msg=f"decode {s}", **TOL)
            assert (tl.numpy().argmax(-1) == np.asarray(jl).argmax(-1)).all()
            pos = pos + 1
    for name, t in tcache.items():
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(jcache[name], np.float32),
                                   err_msg=name, **TOL)


@pytest.fixture(scope="module")
def paged_run(fam):
    cfg, jm, jp, tm, tp = fam
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in LENS]
    forced = rng.integers(1, cfg.vocab_size, (len(LENS), STEPS))
    ids = rng.permutation(np.arange(1, N_PAGES))
    table = ids[: len(LENS) * MAX_PAGES].reshape(len(LENS), MAX_PAGES)
    ctable = ids[len(LENS) * MAX_PAGES:][: len(LENS) * MAX_CP].reshape(
        len(LENS), MAX_CP)
    table, ctable = table.astype(np.int32), ctable.astype(np.int32)
    clen = np.array(N_FRAMES, np.int32)
    jcache = jm.init_paged_cache(len(LENS), N_PAGES, PAGE)
    tcache = tm.init_paged_cache(len(LENS), N_PAGES, PAGE, device="cpu")
    assert set(tcache) == set(jcache)
    steps = []
    with jax.disable_jit():
        for b, p in enumerate(prompts):
            f = _frames(cfg, N_FRAMES[b], seed=40 + b)
            jcache = jm.prefill_cross(jp, jcache, {
                "frames": jnp.asarray(f),
                "cross_page_table": jnp.asarray(ctable[b])})
            tm.prefill_cross(tp, tcache, {
                "frames": torch.from_numpy(f),
                "cross_page_table": torch.from_numpy(ctable[b])})
            for off in range(0, len(p), CHUNK):
                n = min(CHUNK, len(p) - off)
                toks = np.zeros((1, CHUNK), np.int32)
                toks[0, :n] = p[off:off + n]
                jl, jcache = jm.prefill_chunk(jp, jcache, {
                    "tokens": jnp.asarray(toks), "valid": jnp.asarray(n),
                    "slot": jnp.asarray(b),
                    "page_table": jnp.asarray(table[b]),
                    "cross_page_table": jnp.asarray(ctable[b]),
                    "cross_len": jnp.asarray(clen[b])}, offset=off)
                tl = tm.prefill_chunk(tp, tcache, {
                    "tokens": torch.from_numpy(toks), "valid": n,
                    "page_table": torch.from_numpy(table[b]),
                    "cross_page_table": torch.from_numpy(ctable[b]),
                    "cross_len": torch.tensor(clen[b])}, offset=off)
                steps.append((f"lane {b} chunk @{off}", np.asarray(jl),
                              tl.numpy()))
        pos = np.array(LENS, np.int32)
        for s in range(STEPS):
            toks = forced[:, s:s + 1].astype(np.int32)
            jl, jcache = jm.decode_paged(jp, jcache, {
                "tokens": jnp.asarray(toks), "positions": jnp.asarray(pos),
                "page_table": jnp.asarray(table),
                "cross_page_table": jnp.asarray(ctable),
                "cross_len": jnp.asarray(clen)})
            tl = tm.decode_paged(tp, tcache, {
                "tokens": torch.from_numpy(toks),
                "positions": torch.from_numpy(pos),
                "page_table": torch.from_numpy(table),
                "cross_page_table": torch.from_numpy(ctable),
                "cross_len": torch.from_numpy(clen)})
            steps.append((f"decode {s}", np.asarray(jl), tl.numpy()))
            pos = pos + 1
    return steps, jcache, tcache, table, ctable, pos


def test_paged_logits_match_at_every_step(paged_run):
    steps = paged_run[0]
    assert len(steps) == 2 + 1 + STEPS
    for what, want, got in steps:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
        assert (got.argmax(-1) == want.argmax(-1)).all(), what


def test_paged_pools_match_at_written_positions(paged_run):
    """The self pools at every prompt and decode position, the cross pools
    at every frame of each lane's region."""
    _, jcache, tcache, table, ctable, end = paged_run
    for prefix, tbl, ns in (("self", table, end), ("cross", ctable, N_FRAMES)):
        for kv in ("k", "v"):
            name = f"{prefix}_{kv}_pages"
            ref_pool = np.asarray(jcache[name], np.float32)
            pool = tcache[name].float().numpy()
            for b, n in enumerate(ns):
                pos = np.arange(n)
                pid, off = tbl[b][pos // PAGE], pos % PAGE
                np.testing.assert_allclose(pool[:, pid, off],
                                           ref_pool[:, pid, off],
                                           err_msg=f"{name} lane {b}", **TOL)
