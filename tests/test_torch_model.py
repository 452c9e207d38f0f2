"""The port's dense decoder against the JAX package's, step by step.

Reduced ``qwen3-8b`` (qk-norm, untied) and ``smollm-360m`` (tied
embeddings, no qk-norm), with the reference's weights from
``ModelFns.init(jax.random.key(0))`` handed across by the bridge. Two
prompts, one longer than two prefill chunks (chunks at offsets 0, 256 and
512), are prefilled into shuffled pages, then both lanes take 8
teacher-forced batched decode steps. At every step the logits agree, the
greedy token is the same (or the two candidates are tied within the logit
tolerance), and at the end the page pools agree at every written position.

Both sides run on the CPU: the port through its plain kernels, the
reference through its default ``xla`` backend.

Tolerance: atol = 5e-2, rtol = 2e-2, looser in atol than the kernels' bf16
bound (``tests/test_kernels.py:28-30``). The port rounds to bf16 where the
reference's code does (every einsum output, the logits before their f32
cast), but XLA compiles the reference with excess precision allowed: where
a bf16 product feeds an f32 consumer (the logits' cast, qk-norm's and the
block norms' f32 reads) it keeps the f32 value and skips the rounding. The
two sides thus differ by a few bf16 ulps of the activations (measured:
logits up to 0.042, K/V pages up to 0.047 where RoPE cancels two values of
magnitude ~4, reduced qwen3-8b), which also flips a greedy token where the
reference's top two logits are closer than that (ROADMAP Queue 3, P1).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REDUCED  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=5e-2, rtol=2e-2)
PAGE, CHUNK, MAX_PAGES, N_PAGES = 64, 256, 10, 24
LENS = (600, 300)
STEPS = 8


@pytest.fixture(scope="module", params=["qwen3-8b", "smollm-360m"])
def pair(request):
    arch = request.param
    cfg = REDUCED[arch]
    ref = ref_get_model(cfg)
    ref_params = ref.init(jax.random.key(0))
    port = get_model(get(arch, reduced=True))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), port,
                                   device="cpu")
    return cfg, ref, ref_params, port, params


def _run(pair):
    cfg, ref, ref_params, port, params = pair
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in LENS]
    forced = rng.integers(1, cfg.vocab_size, (len(LENS), STEPS))
    ids = rng.permutation(np.arange(1, N_PAGES))[: len(LENS) * MAX_PAGES]
    table = ids.reshape(len(LENS), MAX_PAGES).astype(np.int32)
    jcache = ref.init_paged_cache(len(LENS), N_PAGES, PAGE)
    tcache = port.init_paged_cache(len(LENS), N_PAGES, PAGE, device="cpu")
    jprefill = jax.jit(ref.prefill_chunk, static_argnames=("offset",))
    jdecode = jax.jit(ref.decode_paged)
    steps = []   # (what, ref logits, port logits)
    for b, p in enumerate(prompts):
        for off in range(0, len(p), CHUNK):
            n = min(CHUNK, len(p) - off)
            toks = np.zeros((1, CHUNK), np.int32)
            toks[0, :n] = p[off:off + n]
            jl, jcache = jprefill(ref_params, jcache, {
                "tokens": jnp.asarray(toks), "valid": jnp.asarray(n),
                "slot": jnp.asarray(b), "page_table": jnp.asarray(table[b])},
                offset=off)
            tl = port.prefill_chunk(params, tcache, {
                "tokens": torch.from_numpy(toks), "valid": n,
                "page_table": torch.from_numpy(table[b])}, offset=off)
            steps.append((f"lane {b} chunk @{off}", np.asarray(jl),
                          tl.numpy()))
    pos = np.array(LENS, np.int32)
    for s in range(STEPS):
        toks = forced[:, s:s + 1].astype(np.int32)
        jl, jcache = jdecode(ref_params, jcache, {
            "tokens": jnp.asarray(toks), "positions": jnp.asarray(pos),
            "page_table": jnp.asarray(table)})
        tl = port.decode_paged(params, tcache, {
            "tokens": torch.from_numpy(toks),
            "positions": torch.from_numpy(pos),
            "page_table": torch.from_numpy(table)})
        steps.append((f"decode {s}", np.asarray(jl), tl.numpy()))
        pos = pos + 1
    return steps, jcache, tcache, table, pos


@pytest.fixture(scope="module")
def run(pair):
    return _run(pair)


def test_logits_match_at_every_step(run):
    steps = run[0]
    assert len(steps) == 3 + 2 + STEPS
    for what, want, got in steps:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)


def test_greedy_tokens_match_at_every_step(run):
    """Equal greedy tokens, except at a near tie: there the port's choice
    must score within the logit tolerance of the reference's best."""
    flips = []
    for what, want, got in run[0]:
        for lane, (w, g) in enumerate(zip(want.argmax(-1), got.argmax(-1))):
            if w != g:
                assert want[lane, g] >= want[lane, w] - TOL["atol"], what
                flips.append((what, lane))
    # measured: two near ties in reduced qwen3-8b (decode 6 lane 0, gap
    # 0.0033; decode 7 lane 1, gap 0.0146), none in smollm-360m
    assert len(flips) <= 2, flips


def test_page_pools_match_at_written_positions(run):
    _, jcache, tcache, table, end = run
    for name in ("k_pages", "v_pages"):
        ref_pool = np.asarray(jcache[name], np.float32)
        pool = tcache[name].float().numpy()
        for b, n in enumerate(end):
            pos = np.arange(n)
            pid, off = table[b][pos // PAGE], pos % PAGE
            np.testing.assert_allclose(pool[:, pid, off], ref_pool[:, pid, off],
                                       err_msg=f"{name} lane {b}", **TOL)
        # nothing was written outside the two lanes' pages and scratch page 0
        untouched = sorted(set(range(1, N_PAGES)) - set(table.ravel()))
        assert not pool[:, untouched].any()
