"""The port's SSM and hybrid families against the JAX package's, step by step.

Reduced ``falcon-mamba-7b`` (Mamba1) and ``zamba2-1.2b`` (Mamba2 with the
weight-shared attention block), with the reference's weights from
``ModelFns.init(jax.random.key(0))`` handed across by the bridge. Two
prompts of 40 and 23 tokens are prefilled in chunks of 16 (=
``ssm_chunk``), so both end mid-chunk (``valid`` 8 and 7 of 16, the
pad-tail rule: pads get ``dt = 0`` and the conv state is cut at
``valid``); then both lanes take 6 teacher-forced batched decode steps.
At every step the logits agree, the greedy token is the same (or tied
within the tolerance), and at the end the conv and SSM states of both
slots agree.

Both sides run on the CPU: the port through its plain versions, the
reference through its default ``xla`` backend (the chunked scan and SSD),
op by op (``jax.disable_jit``). Jitted, XLA keeps excess precision where a
bf16 product feeds an f32 consumer and skips the rounding the code asks
for; in zamba2 that moves the reference's own logits and SSM states
further from its op-by-op run than the port's are. A single Mamba2 block
of the port equals the reference's op-by-op block bit for bit in its
output.

Tolerance: atol = 5e-2, rtol = 2e-2 on logits and states, as in
``tests/test_torch_model.py``: the attention's f32 softmax is summed in
another order (the reference's blocked online softmax against the port's
plain one), which flips bf16 roundings of its output; measured here:
logits up to 0.016 (falcon-mamba) and 0.025 (zamba2), SSM states up to
0.055 on magnitudes up to 16.
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
PAGE, CHUNK, MAX_PAGES, N_PAGES = 16, 16, 5, 14
LENS = (40, 23)
STEPS = 6


@pytest.fixture(scope="module", params=["falcon-mamba-7b", "zamba2-1.2b"])
def pair(request):
    arch = request.param
    cfg = REDUCED[arch]
    ref = ref_get_model(cfg)
    ref_params = ref.init(jax.random.key(0))
    port = get_model(get(arch, reduced=True))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), port,
                                   device="cpu")
    return cfg, ref, ref_params, port, params


@pytest.fixture(scope="module")
def run(pair):
    cfg, ref, ref_params, port, params = pair
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in LENS]
    forced = rng.integers(1, cfg.vocab_size, (len(LENS), STEPS))
    ids = rng.permutation(np.arange(1, N_PAGES))[: len(LENS) * MAX_PAGES]
    table = ids.reshape(len(LENS), MAX_PAGES).astype(np.int32)
    jcache = ref.init_paged_cache(len(LENS), N_PAGES, PAGE)
    tcache = port.init_paged_cache(len(LENS), N_PAGES, PAGE, device="cpu")
    with jax.disable_jit():
        return _run(ref, ref_params, port, params, prompts, forced, table,
                    jcache, tcache)


def _run(ref, ref_params, port, params, prompts, forced, table, jcache,
         tcache):
    jprefill, jdecode = ref.prefill_chunk, ref.decode_paged
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
                "tokens": torch.from_numpy(toks), "valid": n, "slot": b,
                "page_table": torch.from_numpy(table[b])}, offset=off)
            steps.append((f"lane {b} chunk @{off} valid {n}", np.asarray(jl),
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
    return steps, jcache, tcache


def test_logits_match_at_every_step(run):
    steps = run[0]
    assert len(steps) == 3 + 2 + STEPS
    for what, want, got in steps:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)


def test_greedy_tokens_match_at_every_step(run):
    """Equal greedy tokens, except at a near tie: there the port's choice
    must score within the logit tolerance of the reference's best."""
    for what, want, got in run[0]:
        for lane, (w, g) in enumerate(zip(want.argmax(-1), got.argmax(-1))):
            if w != g:
                assert want[lane, g] >= want[lane, w] - TOL["atol"], what


def test_recurrent_state_matches(run):
    _, jcache, tcache = run
    for name in ("conv", "ssm"):
        assert tcache[name].dtype == (torch.float32 if name == "ssm"
                                      else torch.bfloat16)
        np.testing.assert_allclose(tcache[name].float().numpy(),
                                   np.asarray(jcache[name], np.float32),
                                   err_msg=name, **TOL)
