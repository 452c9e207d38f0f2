"""The port's dense-cache path (``paged=False``) against the JAX package's.

Three layers, each on the same inputs on both sides (numpy inputs, and the
reference's weights from ``ModelFns.init(jax.random.key(0))`` handed
across by the bridge):

- the plain ``decode_attention`` against the reference's dispatch under
  its ``xla`` backend and the TPU kernel run by the interpreter
  (``pallas_interpret``), at the shapes of ``tests/test_kernels.py``, f32
  and bf16; a lane of length 0 gives zeros, as the TPU kernel does (the
  XLA path averages the masked values there: ROADMAP Queue 3, P2);
- the dense ``prefill`` and ``decode_step`` of REDUCED qwen3-8b,
  smollm-360m, falcon-mamba-7b and zamba2-1.2b: logits at every step and
  the whole cache at the end, after the reference's own slot scatter;
- the dense engine, token for token with equal ``stats``, on the
  scenarios of ``tests/test_serving.py``; and the port's paged engine
  against its own dense engine (``tests/test_paged.py:148-160``).

The reference runs op by op (``jax.disable_jit``): jitted, XLA keeps excess
precision where a bf16 product feeds an f32 consumer, which flips a near
tie in REDUCED qwen3-8b's first dense prefill here (ROADMAP Queue 3, P1).
Op by op, the port's dense prefill logits equal the reference's exactly.
Tolerances: kernels as ``tests/test_kernels.py`` (bf16 atol = rtol =
2e-2, f32 2e-5); logits and caches atol = 5e-2, rtol = 2e-2, as
``tests/test_torch_model.py`` (the attention's f32 softmax is summed in
another order than the reference's, which can flip a bf16 rounding).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REDUCED  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

torch.set_num_threads(1)
RNG = np.random.default_rng(13)
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TOL = dict(atol=5e-2, rtol=2e-2)
ARCHS = ["qwen3-8b", "smollm-360m", "falcon-mamba-7b", "zamba2-1.2b"]


def ktol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bf16" else \
        dict(atol=2e-5, rtol=2e-5)


def pair(a: np.ndarray, name: str):
    """The same values as a JAX array and a torch tensor (bf16 rounds once,
    in JAX, and crosses bit for bit)."""
    j = jnp.asarray(a, DTYPES[name])
    if name == "bf16":
        return j, torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
            torch.bfloat16)
    return j, torch.from_numpy(np.asarray(j).copy())


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------


def _decode_case(b, s, h, k, d, dtype, lens):
    jq, tq = pair(RNG.standard_normal((b, h, d)), dtype)
    jk, tk = pair(RNG.standard_normal((b, s, k, d)), dtype)
    jv, tv = pair(RNG.standard_normal((b, s, k, d)), dtype)
    lens = np.asarray(lens, np.int32)
    return (jq, jk, jv, jnp.asarray(lens)), (tq, tk, tv, torch.from_numpy(lens))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize(
    "b,s,h,k,d",
    [(2, 64, 4, 2, 16), (3, 100, 8, 8, 32), (1, 48, 16, 2, 128)],
)
def test_decode_attention_matches_reference(b, s, h, k, d, backend, dtype):
    jargs, targs = _decode_case(b, s, h, k, d, dtype,
                                RNG.integers(1, s + 1, b))
    got = f32(ref.decode_attention(*targs))
    with jops.use_backend(backend):
        want = f32(jops.decode_attention(*jargs))
    np.testing.assert_allclose(got, want, **ktol(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_zero_length_lane_gives_zeros(dtype):
    """Lane 0 is empty, lane 2 full: the plain version gives zeros at
    length 0, never NaN, as the TPU kernel (interpreted, ``block_k`` 16 so
    that blocks past a length are skipped) does."""
    jargs, targs = _decode_case(3, 64, 4, 2, 16, dtype, [0, 37, 64])
    got = f32(ref.decode_attention(*targs))
    want = f32(pallas_decode(*jargs, block_k=16, interpret=True))
    assert np.all(got[0] == 0.0) and not np.isnan(got).any()
    np.testing.assert_allclose(got, want, **ktol(dtype))


# ---------------------------------------------------------------------------
# Dense prefill and decode_step
# ---------------------------------------------------------------------------

PLENS, BUCKETS, MAX_SEQ, STEPS = (20, 64), (32, 64), 80, 6


@pytest.fixture(scope="module", params=ARCHS)
def pair_model(request):
    arch = request.param
    cfg = REDUCED[arch]
    jm = ref_get_model(cfg)
    jp = jm.init(jax.random.key(0))
    tm = get_model(get(arch, reduced=True))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return cfg, jm, jp, tm, tp


@pytest.fixture(scope="module")
def dense_run(pair_model):
    """Two prompts (20 tokens left-padded into a bucket of 32, and 64)
    prefilled and scattered into slots 0 and 1 of a dense cache, then 6
    teacher-forced decode steps of both lanes."""
    cfg, jm, jp, tm, tp = pair_model
    rng = np.random.default_rng(21)
    forced = rng.integers(1, cfg.vocab_size, (2, STEPS)).astype(np.int32)
    jcache = jm.init_cache(2, MAX_SEQ)
    tcache = tm.init_cache(2, MAX_SEQ, device="cpu")
    steps = []   # (what, ref logits, port logits)
    with jax.disable_jit():
        for slot, (n, bucket) in enumerate(zip(PLENS, BUCKETS)):
            toks = np.zeros((1, bucket), np.int32)
            toks[0, bucket - n:] = rng.integers(1, cfg.vocab_size, n)
            jl, jpc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
            jpc = jkv.expand_prefill_cache(
                jpc, jax.tree.map(lambda c: c[:, :1], jcache))
            jcache = jkv.scatter_slot(jcache, jpc, jnp.asarray(slot))
            tl, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
            tpc = kvcache.expand_prefill_cache(
                tpc, {k: v[:, :1] for k, v in tcache.items()})
            kvcache.scatter_slot(tcache, tpc, slot)
            steps.append((f"prefill {slot}", np.asarray(jl), tl.numpy()))
        pos = np.array(BUCKETS, np.int32)
        for s in range(STEPS):
            toks = forced[:, s:s + 1]
            jl, jcache = jm.decode_step(jp, jcache, {
                "tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)})
            tl = tm.decode_step(tp, tcache, {
                "tokens": torch.from_numpy(toks),
                "positions": torch.from_numpy(pos)})
            steps.append((f"decode {s}", np.asarray(jl), tl.numpy()))
            pos = pos + 1
    return steps, jcache, tcache


def test_dense_logits_match_at_every_step(dense_run):
    steps = dense_run[0]
    assert len(steps) == 2 + STEPS
    for what, want, got in steps:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
        assert (got.argmax(-1) == want.argmax(-1)).all(), what


def test_dense_cache_matches(dense_run):
    """Every leaf of the dense cache — K/V rows, pads and zero tails
    included, or the recurrent states — after prefill, scatter and
    decode."""
    _, jcache, tcache = dense_run
    assert sorted(tcache) == sorted(jcache)
    for name, t in tcache.items():
        want = np.asarray(jcache[name], np.float32)
        assert tuple(t.shape) == want.shape, name
        np.testing.assert_allclose(t.float().numpy(), want, err_msg=name,
                                   **TOL)


# ---------------------------------------------------------------------------
# The dense engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen():
    cfg = REDUCED["qwen3-8b"]
    jm = ref_get_model(cfg)
    jp = jm.init(jax.random.key(0))
    tm = get_model(get("qwen3-8b", reduced=True))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return cfg, jm, jp, tm, tp


def _engines(fam, **kw):
    """A reference and a port dense engine with the same settings; the
    reference's model runs op by op (P1)."""
    _, jm, jp, tm, tp = fam
    r = RefEngine(jm, jp, paged=False, **kw)
    r._prefill, r._decode = jm.prefill, jm.decode_step
    return r, ServeEngine(tm, tp, paged=False, device="cpu", **kw)


def _prompts(cfg, n, length=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, length).tolist() for _ in range(n)]


def _run_both(ref, port, steps: int) -> None:
    with jax.disable_jit():
        ref.run(steps)
    port.run(steps)


def _same(ref: RefEngine, port: ServeEngine) -> None:
    assert sorted(ref.requests) == sorted(port.requests)
    for rid, r in ref.requests.items():
        p = port.requests[rid]
        assert p.generated == r.generated, rid
        assert (p.done, p.slot) == (r.done, r.slot)
    assert port.stats == ref.stats
    assert port.slot_req == ref.slot_req
    assert np.array_equal(port.lengths, ref.lengths)


def test_more_requests_than_slots_all_complete(qwen):
    """``tests/test_serving.py:24``: 8 requests on 3 slots."""
    cfg = qwen[0]
    ref, port = _engines(qwen, n_slots=3, max_seq=96)
    for eng in (ref, port):
        for p in _prompts(cfg, 8):
            eng.submit(p, max_new_tokens=6)
    _run_both(ref, port, 500)
    assert all(len(r.generated) == 6 for r in port.requests.values())
    _same(ref, port)


def test_eos_terminates_early(qwen):
    """``tests/test_serving.py:74``: a request stops at its ``eos_id``, the
    second token a probe run generated."""
    cfg = qwen[0]
    p = _prompts(cfg, 1, seed=9)[0]
    probe = ServeEngine(qwen[3], qwen[4], n_slots=1, max_seq=96,
                        paged=False, device="cpu")
    r0 = probe.submit(p, max_new_tokens=3)
    probe.run(50)
    eos = r0.generated[1]
    ref, port = _engines(qwen, n_slots=2, max_seq=96)
    for eng in (ref, port):
        eng.submit(p, max_new_tokens=10, eos_id=eos)
        eng.submit(_prompts(cfg, 1, seed=4)[0], max_new_tokens=4)
    _run_both(ref, port, 100)
    req = port.requests[0]
    assert req.done and req.generated[-1] == eos and len(req.generated) == 2
    _same(ref, port)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_stateful_families_serve(arch):
    """``tests/test_serving.py:138``: the recurrent-state families through
    the dense engine, against the reference's."""
    cfg = REDUCED[arch]
    jm = ref_get_model(cfg)
    jp = jm.init(jax.random.key(0))
    tm = get_model(get(arch, reduced=True))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tm, device="cpu")
    ref, port = _engines((cfg, jm, jp, tm, tp), n_slots=2, max_seq=64)
    for eng in (ref, port):
        for p in _prompts(cfg, 3, 6):
            eng.submit(p, max_new_tokens=4)
    _run_both(ref, port, 200)
    assert all(r.done for r in port.requests.values())
    _same(ref, port)


def test_bucketed_prefill_samples_last_position():
    """``tests/test_serving.py:109``: when prefill returns every position's
    logits (B, S, V), the first token comes from the LAST position — under
    right-aligned bucketing position 0 is a pad row. The prompt lands
    right-aligned, and the admitted length is the bucket."""
    S, V = 32, 7
    seen = {}

    class StubFns:
        def init_cache(self, n_slots, max_seq, dtype, device):
            return {"k": torch.zeros((1, n_slots, max_seq, 1, 1), dtype=dtype,
                                     device=device)}

        def prefill(self, params, batch):
            seen["tokens"] = batch["tokens"].clone()
            s = batch["tokens"].shape[1]
            logits = torch.zeros((1, s, V))
            logits[0, 0, 5] = 1.0    # pad-row argmax: 5
            logits[0, -1, 3] = 1.0   # last-position argmax: 3
            return logits, {"k": torch.zeros((1, 1, s, 1, 1),
                                             dtype=torch.bfloat16)}

        decode_step = staticmethod(lambda *a: None)

    eng = ServeEngine(StubFns(), torch.nn.Module(), n_slots=1, max_seq=S,
                      paged=False, device="cpu")
    req = eng.submit(list(range(1, 9)), max_new_tokens=2)
    eng._admit()
    assert req.generated[0] == 3
    assert seen["tokens"].tolist() == [[0] * 24 + list(range(1, 9))]
    assert eng.lengths[0] == 32


def test_prefill_rewrites_the_whole_slot_row(qwen):
    """A reused slot's rows past the new bucket become zeros, not the K/V
    the slot held before (the reference pads the prefill cache to
    ``max_seq`` before it scatters)."""
    cfg, _, _, tm, tp = qwen
    eng = ServeEngine(tm, tp, n_slots=1, max_seq=96, paged=False,
                      device="cpu")
    eng.submit(_prompts(cfg, 1, length=60)[0], max_new_tokens=3)
    eng.run(20)
    assert eng.cache["k"][:, 0, 40:66].abs().sum() > 0   # bucket 64 + decode
    eng.submit(_prompts(cfg, 1, length=8, seed=1)[0], max_new_tokens=1)
    eng._admit()
    assert eng.cache["k"][:, 0, :32].abs().sum() > 0
    assert not eng.cache["k"][:, 0, 32:].any()
    assert not eng.cache["v"][:, 0, 32:].any()


def test_paged_matches_dense_token_for_token(qwen):
    """``tests/test_paged.py:148-160``: power-of-two prompts make the dense
    bucketing exact, so the port's paged engine and its dense engine agree
    on every generated token."""
    cfg, _, _, tm, tp = qwen
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (32, 64, 32, 64)]
    dense = ServeEngine(tm, tp, n_slots=2, max_seq=96, paged=False,
                        device="cpu")
    paged = ServeEngine(tm, tp, n_slots=2, max_seq=96, paged=True,
                        page_size=16, prefill_chunk=32, device="cpu")
    for p in prompts:
        dense.submit(p, max_new_tokens=5)
        paged.submit(p, max_new_tokens=5)
    dd = sorted(dense.run(300), key=lambda r: r.req_id)
    pd = sorted(paged.run(300), key=lambda r: r.req_id)
    assert len(dd) == 4
    assert [r.generated for r in pd] == [r.generated for r in dd]


def test_dense_engine_refuses_what_needs_pages(qwen):
    """The reference's messages (``engine.py:411,616-619``): speculative
    decoding and the spill tier need the paged cache; preemption too."""
    _, _, _, tm, tp = qwen
    kw = dict(n_slots=2, max_seq=64, paged=False, device="cpu")
    with pytest.raises(ValueError, match="needs the paged cache"):
        ServeEngine(tm, tp, draft=tm, **kw)
    with pytest.raises(ValueError, match="needs the paged cache"):
        ServeEngine(tm, tp, remote_pool=object(), **kw)
    eng = ServeEngine(tm, tp, **kw)
    req = eng.submit([1, 2, 3], max_new_tokens=4)
    eng.step()
    with pytest.raises(AssertionError, match="paged"):
        eng.preempt(req.req_id)


def test_bucket_at_max_seq_stops_after_one_decode(qwen):
    """A 40-token prompt's bucket (64) fills ``max_seq``: its lane decodes
    once at position 64, whose K/V write falls past the cache and is
    dropped (as JAX's scatter drops it), and the request ends with two
    tokens, as in the reference; the other lane is unaffected."""
    cfg = qwen[0]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (40, 20)]
    ref, port = _engines(qwen, n_slots=2, max_seq=64)
    for eng in (ref, port):
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
    _run_both(ref, port, 100)
    assert [len(r.generated) for r in port.requests.values()] == [2, 8]
    _same(ref, port)
