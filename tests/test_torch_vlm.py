"""The port's VLM family against the JAX package's, REDUCED
``llava-next-mistral-7b`` (2 layers, d 96, 4 / 2 heads of 24, 8 image
rows of the stub vision width 1024), with the reference's weights handed
across by the bridge, the reference run op by op (``jax.disable_jit``;
ROADMAP Queue 3, P1).

- the bridge carries ``mm_proj``, stored bf16 as the reference casts it;
- the dense prefill puts the projected image rows ahead of the text, and
  its logits and cache match, then the decode steps';
- the paged prefill chunks read the image rows inline below ``mm_len``:
  with chunks of 6 over 8 image rows, chunk 0 is all image, chunk 1
  straddles ``mm_len`` (2 image rows, 4 text), the rest are text; the
  logits at every chunk and decode step, and the pools at every written
  position, match.

Tolerances: logits atol = 5e-2, rtol = 2e-2, as
``tests/test_torch_model.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REDUCED  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import get_model, transformer  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=5e-2, rtol=2e-2)
ARCH = "llava-next-mistral-7b"


@pytest.fixture(scope="module")
def fam():
    cfg = REDUCED[ARCH]
    jm = ref_get_model(cfg)
    jp = jm.init(jax.random.key(0))
    tm = get_model(get(ARCH, reduced=True))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return cfg, jm, jp, tm, tp


def _embeds(cfg, seed):
    return np.random.default_rng(seed).standard_normal(
        (1, cfg.n_image_tokens, transformer.VISION_D)).astype(np.float32)


def test_bridge_carries_mm_proj(fam):
    cfg, jm, jp, tm, tp = fam
    assert tm.paged_mm_inline and jm.paged_mm_inline
    assert tp.mm_proj.shape == (transformer.VISION_D, cfg.d_model)
    assert tp.mm_proj.dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(jp["mm_proj"], jnp.bfloat16))
    assert np.array_equal(tp.mm_proj.view(torch.int16).numpy(),
                          want.view(np.int16))
    assert get(ARCH, reduced=True).param_count() == sum(
        p.numel() for p in tp.parameters())


def test_dense_logits_and_cache_match(fam):
    """Two requests, image rows ahead of a left-padded bucket of 32,
    scattered into a dense cache, then teacher-forced decode steps at
    positions past the image rows."""
    cfg, jm, jp, tm, tp = fam
    rng = np.random.default_rng(21)
    mm = cfg.n_image_tokens
    forced = rng.integers(1, cfg.vocab_size, (2, 4)).astype(np.int32)
    jcache = jm.init_cache(2, 64)
    tcache = tm.init_cache(2, 64, device="cpu")
    with jax.disable_jit():
        for slot, n in enumerate((20, 32)):
            toks = np.zeros((1, 32), np.int32)
            toks[0, 32 - n:] = rng.integers(1, cfg.vocab_size, n)
            e = _embeds(cfg, seed=slot)
            jl, jpc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                      "embeds": jnp.asarray(e)})
            jcache = jkv.scatter_slot(jcache, jkv.expand_prefill_cache(
                jpc, jax.tree.map(lambda c: c[:, :1], jcache)),
                jnp.asarray(slot))
            tl, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                      "embeds": torch.from_numpy(e)})
            assert tpc["k"].shape[2] == mm + 32
            kvcache.scatter_slot(tcache, kvcache.expand_prefill_cache(
                tpc, {k: v[:, :1] for k, v in tcache.items()}), slot)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       err_msg=f"prefill {slot}", **TOL)
        pos = np.full(2, mm + 32, np.int32)
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


PAGE, CHUNK, MAX_PAGES, N_PAGES = 8, 6, 6, 16
TEXT, STEPS = (13, 4), 4


@pytest.fixture(scope="module")
def paged_run(fam):
    cfg, jm, jp, tm, tp = fam
    rng = np.random.default_rng(11)
    mm = cfg.n_image_tokens
    texts = [rng.integers(1, cfg.vocab_size, n) for n in TEXT]
    embeds = [_embeds(cfg, seed=30 + b) for b in range(len(TEXT))]
    forced = rng.integers(1, cfg.vocab_size, (len(TEXT), STEPS))
    ids = rng.permutation(np.arange(1, N_PAGES))[: len(TEXT) * MAX_PAGES]
    table = ids.reshape(len(TEXT), MAX_PAGES).astype(np.int32)
    jcache = jm.init_paged_cache(len(TEXT), N_PAGES, PAGE)
    tcache = tm.init_paged_cache(len(TEXT), N_PAGES, PAGE, device="cpu")
    steps, splits = [], []
    with jax.disable_jit():
        for b, text in enumerate(texts):
            tlen = mm + len(text)
            for off in range(0, tlen, CHUNK):
                n = min(CHUNK, tlen - off)
                si = min(max(mm - off, 0), n)     # image rows in the chunk
                splits.append((b, off, si, n - si))
                toks = np.zeros((1, CHUNK), np.int32)
                toks[0, si:n] = text[off + si - mm:off + n - mm]
                emb = np.zeros((1, CHUNK, transformer.VISION_D), np.float32)
                emb[0, :si] = embeds[b][0, off:off + si]
                jl, jcache = jm.prefill_chunk(jp, jcache, {
                    "tokens": jnp.asarray(toks), "valid": jnp.asarray(n),
                    "slot": jnp.asarray(b),
                    "page_table": jnp.asarray(table[b]),
                    "embeds": jnp.asarray(emb)}, offset=off, mm_len=mm)
                tl = tm.prefill_chunk(tp, tcache, {
                    "tokens": torch.from_numpy(toks), "valid": n,
                    "page_table": torch.from_numpy(table[b]),
                    "embeds": torch.from_numpy(emb)}, offset=off, mm_len=mm)
                steps.append((f"lane {b} chunk @{off} ({si} image rows)",
                              np.asarray(jl), tl.numpy()))
        pos = np.array([mm + n for n in TEXT], np.int32)
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
    return steps, splits, jcache, tcache, table, pos


def test_a_chunk_straddles_mm_len(paged_run):
    splits = paged_run[1]
    assert (0, 0, 6, 0) in splits          # all image rows
    assert (0, 6, 2, 4) in splits          # image rows, then text
    assert any(si == 0 and off > 0 for _, off, si, _ in splits)


def test_paged_logits_match_at_every_step(paged_run):
    steps = paged_run[0]
    for what, want, got in steps:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
        assert (got.argmax(-1) == want.argmax(-1)).all(), what


def test_paged_pools_match_at_written_positions(paged_run):
    _, _, jcache, tcache, table, end = paged_run
    for name in ("k_pages", "v_pages"):
        ref_pool = np.asarray(jcache[name], np.float32)
        pool = tcache[name].float().numpy()
        for b, n in enumerate(end):
            pos = np.arange(n)
            pid, off = table[b][pos // PAGE], pos % PAGE
            np.testing.assert_allclose(pool[:, pid, off],
                                       ref_pool[:, pid, off],
                                       err_msg=f"{name} lane {b}", **TOL)


def test_image_rows_take_no_row_invariant_product(fam):
    """``mm_proj`` is a prefill product (``torch.matmul``): a chunk holding
    image rows calls no ``gemm_rows``; the paged decode step calls it for
    q, k, v, o, the MLP's three a layer and the unembedding."""
    cfg, _, _, tm, tp = fam
    cache = tm.init_paged_cache(1, 4, 8, device="cpu")
    table = torch.tensor([1, 2, 3], dtype=torch.int32)
    ops.reset_counts()
    tm.prefill_chunk(tp, cache, {
        "tokens": torch.ones(1, 8, dtype=torch.int32), "valid": 8,
        "page_table": table,
        "embeds": torch.ones(1, 8, transformer.VISION_D)},
        offset=0, mm_len=cfg.n_image_tokens)
    assert ops.counts()["gemm_rows"]["plain"] == 0
    tm.decode_paged(tp, cache, {
        "tokens": torch.ones(1, 1, dtype=torch.int32),
        "positions": torch.tensor([8], dtype=torch.int32),
        "page_table": table[None]})
    assert ops.counts()["gemm_rows"]["plain"] == 7 * cfg.n_layers + 1
