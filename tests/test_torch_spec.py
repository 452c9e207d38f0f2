"""Speculative decoding and ``fork`` on the port, against the JAX package.

- every case of ``tests/test_spec_decode.py``, its MoE parity case
  (REDUCED deepseek-moe-16b drafted by granite-moe-1b-a400m) included, run
  on the port's engine on the CPU with the reference's own assertion:
  greedy and sampled
  speculation give plain decode's tokens, a self-draft accepts everything,
  a rejection at every window offset rolls back with exact counters,
  preemption, snapshot and budget fallback keep the tokens, the
  constructor's refusals, fork's sharing and refusals, and decode pages in
  the prefix trie;
- the port against the reference on the same weights (the reference's
  ``init`` handed across by the bridge), the reference run op by op
  (``jax.disable_jit``; ROADMAP Queue 3, P1): tokens and the five
  ``spec_*``/``fork*`` counters of the same scenarios; a lent page of a
  speculating engine byte for byte, ``draft_`` leaves included; a
  speculating engine's snapshot restored across packages both ways;
- ``ops.paged_verify_attention`` against ``repro.kernels.ref``'s oracle at
  the cases of ``tests/test_kernels.py:176-198``, and
  ``layers.attn_verify_paged`` against the reference's layer.

Everything runs at REDUCED size (vocab 512, K at most 256), where the CPU
product gives a row the same bits whatever the row count. On the card that
needs the row-invariant product of ``kernels/gemm_rows.py``;
``tests/test_torch_gpu.py`` and ``chip_smoke.py``'s ``phase_spec`` hold it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving.kvcache as ref_kv  # noqa: E402
import repro_torch.serving.kvcache as port_kv  # noqa: E402
from repro.configs import REDUCED  # noqa: E402
from repro.configs import draft_for as ref_draft_for  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as RefSched  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import DRAFT_PAIRS, draft_for, get  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as ll  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

torch.set_num_threads(1)
SPEC_K = 3
COUNTERS = ("spec_rounds", "spec_proposed", "spec_accepted", "forks",
            "fork_shared_pages")


@pytest.fixture(scope="module")
def pair():
    """REDUCED qwen3-8b and its REDUCED smollm-360m draft, weights as
    ``tests/test_spec_decode.py::_pair`` draws them, in both packages."""
    cfg = REDUCED["qwen3-8b"]
    jm = ref_get_model(cfg)
    jp = jm.init(jax.random.key(0))
    jd = ref_get_model(ref_draft_for("qwen3-8b", reduced=True))
    jdp = jd.init(jax.random.key(1))
    tm = get_model(get("qwen3-8b", reduced=True))
    td = get_model(draft_for("qwen3-8b", reduced=True))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tm,
                               device="cpu")
    tdp = params_from_reference(jax.tree.map(np.asarray, jdp), td,
                                device="cpu")
    return cfg, jm, jp, jd, jdp, tm, tp, td, tdp


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]


def _kw(sync: bool, n_slots: int, kw: dict) -> dict:
    kw.setdefault("max_seq", 96)
    kw.setdefault("page_size", 16)
    kw.setdefault("prefill_chunk", 32)
    kw["n_slots"] = n_slots
    return kw


def _engine(model, params, *, sync=False, n_slots=2, **kw):
    """``tests/test_spec_decode.py::_engine`` on the port."""
    kw = _kw(sync, n_slots, kw)
    if sync:
        kw.setdefault("scheduler", SchedulerConfig(token_budget=None))
    return ServeEngine(model, params, paged=True, device="cpu", **kw)


def _ref_engine(model, params, *, sync=False, n_slots=2, **kw):
    kw = _kw(sync, n_slots, kw)
    if sync:
        kw.setdefault("scheduler", RefSched(token_budget=None))
    return RefEngine(model, params, paged=True, **kw)


def _drain(engine, prompts, *, max_new=8, temps=None, seeds=None):
    for j, p in enumerate(prompts):
        engine.submit(p, max_new_tokens=max_new,
                      temperature=temps[j] if temps else 0.0,
                      seed=seeds[j] if seeds else 0)
    done = sorted(engine.run(800), key=lambda r: r.req_id)
    return [r.generated for r in done]


def test_draft_pairs_are_the_references():
    from repro.configs import DRAFT_PAIRS as REF_PAIRS

    assert DRAFT_PAIRS == REF_PAIRS
    assert draft_for("qwen3-8b", reduced=True) == get("smollm-360m",
                                                      reduced=True)
    assert draft_for("smollm-360m") is None
    # the MoE pair resolves, at published widths too (where its vocabs
    # differ, ROADMAP Queue 3, R4)
    for reduced in (False, True):
        assert draft_for("deepseek-moe-16b", reduced=reduced) == get(
            "granite-moe-1b-a400m", reduced=reduced)


def test_only_paged_attention_families_speculate():
    assert get_model(get("qwen3-8b", reduced=True)).supports_spec_decode
    for arch in ("falcon-mamba-7b", "zamba2-1.2b"):
        model = get_model(get(arch, reduced=True))
        assert not model.supports_spec_decode
        assert model.supports_spec_decode == ref_get_model(
            REDUCED[arch]).supports_spec_decode


def test_only_the_paged_decode_takes_the_row_invariant_product(pair):
    """The product is chosen by entry point, never by row count: every
    product of a paged decode step (7 a layer and the unembedding), and so
    of the verify folded into it, goes through ``ops.gemm_rows``; a prefill
    chunk and the dense decode keep ``torch.matmul``."""
    tm, tp = pair[5], pair[6]
    per_step = 7 * tm.cfg.n_layers + 1
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
    }
    for name, call in calls.items():
        ops.reset_counts()
        call()
        want = per_step if name in ("decode_paged", "verify_paged") else 0
        assert ops.counts()["gemm_rows"]["plain"] == want, name


# ---------------------------------------------------------------------------
# The cases of tests/test_spec_decode.py on the port
# ---------------------------------------------------------------------------


def test_spec_matches_plain_greedy(pair):
    cfg, *_, tm, tp, td, tdp = pair
    prompts = _prompts(cfg, [32, 17, 40, 5], seed=3)
    base = _drain(_engine(tm, tp), prompts)
    spec_eng = _engine(tm, tp, draft=td, draft_params=tdp, spec_k=SPEC_K)
    got = _drain(spec_eng, prompts)
    assert got == base
    assert spec_eng.stats["spec_rounds"] > 0


@pytest.fixture(scope="module")
def moe_pair():
    """``tests/test_spec_decode.py::_pair("deepseek-moe-16b")``: REDUCED
    deepseek-moe-16b and its REDUCED granite-moe-1b-a400m draft, in both
    packages."""
    arch = "deepseek-moe-16b"
    jm = ref_get_model(REDUCED[arch])
    jp = jm.init(jax.random.key(0))
    jd = ref_get_model(ref_draft_for(arch, reduced=True))
    jdp = jd.init(jax.random.key(1))
    tm = get_model(get(arch, reduced=True))
    td = get_model(draft_for(arch, reduced=True))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tm,
                               device="cpu")
    tdp = params_from_reference(jax.tree.map(np.asarray, jdp), td,
                                device="cpu")
    return REDUCED[arch], jm, jp, jd, jdp, tm, tp, td, tdp


def test_spec_matches_plain_greedy_moe(moe_pair):
    """``tests/test_spec_decode.py:82``'s MoE case on the port: greedy
    speculation gives plain decode's tokens; and both equal the reference's
    engines' run op by op (P1), with equal ``spec_*`` counters."""
    cfg, *_, tm, tp, td, tdp = moe_pair
    prompts = _prompts(cfg, [32, 17, 40, 5], seed=3)
    base = _drain(_engine(tm, tp), prompts)
    spec_eng = _engine(tm, tp, draft=td, draft_params=tdp, spec_k=SPEC_K)
    got = _drain(spec_eng, prompts)
    assert got == base
    assert spec_eng.stats["spec_rounds"] > 0
    jeng, _ = _both(moe_pair, draft="pair")
    with jax.disable_jit():
        assert _drain(jeng, prompts) == got
    assert _counters(spec_eng) == _counters(jeng)


def test_spec_matches_plain_greedy_synchronous(pair):
    cfg, *_, tm, tp, td, tdp = pair
    prompts = _prompts(cfg, [32, 17], seed=5)
    base = _drain(_engine(tm, tp, sync=True), prompts)
    spec_eng = _engine(tm, tp, sync=True, draft=td, draft_params=tdp,
                       spec_k=SPEC_K)
    assert _drain(spec_eng, prompts) == base
    assert spec_eng.stats["spec_rounds"] > 0


def test_spec_sampled_stream_is_reproduced(pair):
    cfg, *_, tm, tp, td, tdp = pair
    prompts = _prompts(cfg, [32, 17, 23], seed=7)
    temps, seeds = [0.8, 0.0, 1.3], [11, 0, 42]
    base = _drain(_engine(tm, tp, n_slots=3), prompts, temps=temps,
                  seeds=seeds)
    got = _drain(_engine(tm, tp, n_slots=3, draft=td, draft_params=tdp,
                         spec_k=SPEC_K),
                 prompts, temps=temps, seeds=seeds)
    assert got == base


def test_self_draft_accepts_everything(pair):
    cfg, *_, tm, tp, _, _ = pair
    prompts = _prompts(cfg, [32, 17], seed=3)
    base = _drain(_engine(tm, tp), prompts)
    eng = _engine(tm, tp, draft=tm, draft_params=tp, spec_k=SPEC_K)
    assert _drain(eng, prompts) == base
    assert eng.stats["spec_proposed"] > 0
    assert eng.stats["spec_accepted"] == eng.stats["spec_proposed"]


@pytest.mark.parametrize("reject_at", list(range(SPEC_K + 1)))
def test_spec_rollback_at_every_offset(pair, reject_at):
    """Self-draft with the proposal at offset ``reject_at`` flipped to a
    wrong token, through the same ``_draft_decode`` wrapper as the
    reference's test: exactly ``reject_at`` tokens accepted a round, and
    plain decode's stream."""
    cfg, *_, tm, tp, _, _ = pair
    prompts = _prompts(cfg, [17], seed=9)
    base = _drain(_engine(tm, tp, sync=True), prompts)
    eng = _engine(tm, tp, sync=True, draft=tm, draft_params=tp,
                  spec_k=SPEC_K)
    orig = eng._draft_decode
    calls = {"n": 0}

    def adversarial(dp, cache, batch):
        logits = orig(dp, cache, batch)
        j = calls["n"] % (SPEC_K + 1)
        calls["n"] += 1
        if j == reject_at:
            wrong = (logits.argmax(dim=-1) + 1) % logits.shape[-1]
            logits = torch.nn.functional.one_hot(
                wrong, logits.shape[-1]).float()
        return logits

    eng._draft_decode = adversarial
    assert _drain(eng, prompts) == base
    rounds = eng.stats["spec_rounds"]
    assert rounds == -(-7 // (reject_at + 1))  # 7 decode tokens after prefill
    assert eng.stats["spec_accepted"] == reject_at * rounds
    assert eng.stats["spec_proposed"] == SPEC_K * rounds


def test_spec_preemption_roundtrip(pair):
    cfg, *_, tm, tp, td, tdp = pair
    prompts = _prompts(cfg, [32, 17], seed=13)
    base = _drain(_engine(tm, tp), prompts, max_new=10)
    eng = _engine(tm, tp, draft=td, draft_params=tdp, spec_k=SPEC_K)
    reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
    for _ in range(4):
        eng.step()
    victim = next(r for r in reqs
                  if r.slot is not None and r.slot not in eng.prefilling)
    eng.preempt(victim.req_id)
    done = sorted(eng.run(800), key=lambda r: r.req_id)
    assert [r.generated for r in done] == base
    assert eng.stats["preemptions"] == 1
    assert eng.stats["resume_mismatches"] == 0


def test_spec_snapshot_restore_mid_generation(pair):
    cfg, *_, tm, tp, td, tdp = pair
    prompts = _prompts(cfg, [32, 17], seed=15)

    def build():
        return _engine(tm, tp, sync=True, draft=td, draft_params=tdp,
                       spec_k=SPEC_K)

    eng = build()
    for p in prompts:
        eng.submit(p, max_new_tokens=10)
    for _ in range(2):
        eng.step()
    blob = eng.snapshot()
    ref_done = sorted(eng.run(800), key=lambda r: r.req_id)
    other = build()
    other.restore(blob)
    got_done = sorted(other.run(800), key=lambda r: r.req_id)
    assert ([r.generated for r in got_done]
            == [r.generated for r in ref_done])
    assert other.stats["spec_rounds"] >= eng.stats["spec_rounds"] > 0


def test_spec_budget_fallback_is_plain_decode(pair):
    cfg, *_, tm, tp, td, tdp = pair
    prompts = _prompts(cfg, [32, 17], seed=17)
    base = _drain(_engine(tm, tp), prompts)
    tight = SchedulerConfig(token_budget=2 * SPEC_K + 1)  # window is 2k+2
    eng = _engine(tm, tp, draft=td, draft_params=tdp, spec_k=SPEC_K,
                  scheduler=tight)
    assert _drain(eng, prompts) == base
    assert eng.stats["spec_rounds"] == 0


def test_spec_engine_validation(pair):
    cfg, *_, tm, tp, td, tdp = pair
    with pytest.raises(ValueError, match="paged cache"):
        ServeEngine(tm, tp, paged=False, draft=td, draft_params=tdp,
                    device="cpu")
    ssm = get_model(get("falcon-mamba-7b", reduced=True))
    sp = ssm.init(2, device="cpu")
    with pytest.raises(ValueError, match="verify|decode state"):
        _engine(ssm, sp, draft=td, draft_params=tdp)
    small_vocab = dataclasses.replace(get("smollm-360m", reduced=True),
                                      vocab_size=128)
    dv = get_model(small_vocab)
    dvp = dv.init(3, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        _engine(tm, tp, draft=dv, draft_params=dvp)
    with pytest.raises(ValueError, match="spec_k"):
        _engine(tm, tp, draft=td, draft_params=tdp, spec_k=0)
    # the reference's messages, word for word
    jdv = ref_get_model(dataclasses.replace(REDUCED["smollm-360m"],
                                            vocab_size=128))
    jssm = ref_get_model(REDUCED["falcon-mamba-7b"])
    cases = [((tm, tp, dict(draft=dv, draft_params=dvp)),
              (pair[1], pair[2], dict(draft=jdv))),
             ((tm, tp, dict(draft=td, draft_params=tdp, spec_k=0)),
              (pair[1], pair[2], dict(draft=pair[3], spec_k=0))),
             ((ssm, sp, dict(draft=td, draft_params=tdp)),
              (jssm, None, dict(draft=pair[3]))),
             ((tm, tp, dict(draft=ssm, draft_params=sp)),
              (pair[1], pair[2], dict(draft=jssm)))]
    for (m, p, kw), (jm, jp, jkw) in cases:
        with pytest.raises(ValueError) as port_err:
            _engine(m, p, **kw)
        with pytest.raises(ValueError) as ref_err:
            _ref_engine(jm, jp, **jkw)
        assert str(port_err.value) == str(ref_err.value)


def test_fork_shares_committed_pages_and_diverges(pair):
    cfg, *_, tm, tp, _, _ = pair
    prompts = _prompts(cfg, [32], seed=3)
    eng = _engine(tm, tp, sync=True, n_slots=6)
    parent = eng.submit(prompts[0], max_new_tokens=12)
    for _ in range(4):
        eng.step()
    n_before = len(parent.generated)
    kids = eng.fork(parent.req_id, 3, temperature=1.0, seeds=[1, 2, 3])
    lanes = [parent] + kids
    logical = sum(len(eng.slot_pages[r.slot]) for r in lanes)
    physical = len({p for r in lanes for p in eng.slot_pages[r.slot]})
    assert logical / physical > 1  # full committed pages shared n-ways
    assert eng.stats["forks"] == 3
    assert eng.stats["fork_shared_pages"] > 0
    eng.run(800)
    assert all(k.done for k in kids)
    # children share the parent's committed prefix, then diverge by seed
    assert len({tuple(k.generated) for k in kids}) > 1
    for k in kids:
        assert k.generated[:n_before] == parent.generated[:n_before]
    # every shared page's refcount drained back out
    assert eng.pool.outstanding == 0
    assert eng.pool.available == eng.n_pages - 1


def test_fork_rejects_impossible_requests(pair):
    cfg, *_, tm, tp, _, _ = pair
    eng = _engine(tm, tp, sync=True, n_slots=2)
    parent = eng.submit(_prompts(cfg, [32], seed=3)[0], max_new_tokens=8)
    eng.step()
    with pytest.raises(ValueError, match="free slots"):
        eng.fork(parent.req_id, 5)
    queued = _engine(tm, tp, sync=True, n_slots=2)
    waiting = queued.submit(_prompts(cfg, [32], seed=4)[0], max_new_tokens=8)
    with pytest.raises(ValueError, match="active decode slot"):
        queued.fork(waiting.req_id, 1)
    # pages short: refused before any side effect
    tight = _engine(tm, tp, sync=True, n_slots=4, n_pages=9)
    p = tight.submit(_prompts(cfg, [32], seed=5)[0], max_new_tokens=40)
    tight.step()
    before = (tight.pool.available, list(tight.slot_req), dict(tight.stats))
    with pytest.raises(ValueError, match="pages"):
        tight.fork(p.req_id, 3)
    assert before == (tight.pool.available, list(tight.slot_req),
                      dict(tight.stats))


def test_decode_pages_enter_prefix_trie_at_completion(pair):
    cfg, *_, tm, tp, _, _ = pair
    eng = _engine(tm, tp)
    p0 = _prompts(cfg, [24], seed=3)[0]
    r1 = eng.submit(p0, max_new_tokens=16)
    eng.run(800)
    assert r1.done
    ext = list(p0) + list(r1.generated) + [5, 6, 7]
    hits0 = eng.stats["prefix_hit_tokens"]
    eng.submit(ext, max_new_tokens=4)
    eng.run(800)
    gained = eng.stats["prefix_hit_tokens"] - hits0
    prompt_only_cap = (len(p0) // eng.page_size) * eng.page_size
    assert gained > prompt_only_cap  # shared into the generated region


def test_held_lane_near_the_table_end_rides_a_spec_round(pair):
    """A recall-held lane whose window would pass the end of its page
    table (length 94 of 96, k = 3) rides the other lane's speculative
    rounds as an inert lane, and both streams are plain decode's under the
    same hold."""
    cfg, *_, tm, tp, _, _ = pair
    prompts = _prompts(cfg, [93, 17], seed=19)

    def run(**kw):
        eng = _engine(tm, tp, sync=True, **kw)
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.step()
        assert int(eng.lengths[reqs[0].slot]) == 94
        eng.slot_hold[reqs[0].slot] = 3
        eng.run(800)
        return eng, [r.generated for r in reqs]

    _, want = run()
    spec, got = run(draft=tm, draft_params=tp, spec_k=SPEC_K)
    assert got == want
    assert spec.stats["spec_rounds"] > 0


# ---------------------------------------------------------------------------
# The port against the reference: tokens, counters, payloads, snapshots
# ---------------------------------------------------------------------------


def _both(pair, *, draft: str | None, sync=False, n_slots=2, **kw):
    """A reference engine and a port engine with the same settings and
    draft (``"pair"``: smollm-360m, ``"self"``: the target itself)."""
    _, jm, jp, jd, jdp, tm, tp, td, tdp = pair
    jkw, tkw = dict(kw), dict(kw)
    if draft is not None:
        jkw.update(draft=jd if draft == "pair" else jm,
                   draft_params=jdp if draft == "pair" else jp,
                   spec_k=SPEC_K)
        tkw.update(draft=td if draft == "pair" else tm,
                   draft_params=tdp if draft == "pair" else tp,
                   spec_k=SPEC_K)
    return (_ref_engine(jm, jp, sync=sync, n_slots=n_slots, **jkw),
            _engine(tm, tp, sync=sync, n_slots=n_slots, **tkw))


def _counters(eng) -> dict:
    return {k: eng.stats[k] for k in COUNTERS}


SCENARIOS = {
    # (draft, engine settings, prompt lengths, prompt seed, temperatures)
    "greedy": ("pair", {}, [32, 17, 40, 5], 3, None),
    "greedy_sync": ("pair", {"sync": True}, [32, 17], 5, None),
    "sampled": ("pair", {"n_slots": 3}, [32, 17, 23], 7, [0.8, 0.0, 1.3]),
    "self_draft": ("self", {}, [32, 17], 3, None),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_spec_tokens_and_counters_equal_the_reference(pair, name):
    """The same prompts, seeds and weights through both packages' engines;
    the reference op by op (P1). Tokens and the five counters equal."""
    draft, kw, lens, seed, temps = SCENARIOS[name]
    seeds = [11, 0, 42][:len(lens)] if temps else None
    prompts = _prompts(pair[0], lens, seed=seed)
    jeng, teng = _both(pair, draft=draft, **kw)
    with jax.disable_jit():
        want = _drain(jeng, prompts, temps=temps, seeds=seeds)
    got = _drain(teng, prompts, temps=temps, seeds=seeds)
    assert got == want
    assert _counters(teng) == _counters(jeng)
    assert teng.stats["spec_rounds"] > 0


def test_fork_tokens_and_counters_equal_the_reference(pair):
    cfg = pair[0]
    prompt = _prompts(cfg, [32], seed=3)[0]
    jeng, teng = _both(pair, draft=None, sync=True, n_slots=6)
    out = {}
    for side, eng in (("ref", jeng), ("port", teng)):
        with jax.disable_jit():
            parent = eng.submit(prompt, max_new_tokens=12)
            for _ in range(4):
                eng.step()
            eng.fork(parent.req_id, 3, temperature=1.0, seeds=[1, 2, 3])
            eng.run(800)
        out[side] = [r.generated for r in sorted(eng.requests.values(),
                                                 key=lambda r: r.req_id)]
    assert out["port"] == out["ref"]
    assert _counters(teng) == _counters(jeng)
    assert teng.stats["cow_copies"] == jeng.stats["cow_copies"]
    assert teng.pool.outstanding == jeng.pool.outstanding == 0


def test_spec_engine_page_payload_is_the_references(pair):
    """A speculating engine's cache carries the draft's pools under
    ``draft_``, in the reference's leaf order: the same bits in both
    packages' caches give byte-equal lent pages."""
    jeng, teng = _both(pair, draft="pair")
    assert sorted(teng.cache) == sorted(jeng.cache) == [
        "draft_k_pages", "draft_v_pages", "k_pages", "v_pages"]
    rng = np.random.default_rng(23)
    for k, v in jeng.cache.items():
        vals = jnp.asarray(rng.standard_normal(v.shape), v.dtype)
        jeng.cache[k] = vals
        bits = np.asarray(vals).view(np.int16).copy()
        teng.cache[k].copy_(torch.from_numpy(bits).view(torch.bfloat16))
    for page in (1, 5, teng.n_pages - 1):
        want = ref_kv.extract_page_payload(jeng.cache, page)
        assert port_kv.extract_page_payload(teng.cache, page) == want
    pages = [3, 1, 4]
    assert port_kv.extract_page_payloads(teng.cache, pages) == [
        ref_kv.extract_page_payload(jeng.cache, p) for p in pages]


@pytest.fixture(scope="module")
def spec_crossing(pair):
    """Each package's uninterrupted speculating run, and each package's
    blob after 2 steps of the same workload (the reference op by op)."""
    prompts = _prompts(pair[0], [32, 17], seed=15)
    out = {}
    with jax.disable_jit():
        for side in ("ref", "port"):
            for cut in (False, True):
                eng = _both(pair, draft="pair", sync=True)[side == "port"]
                for p in prompts:
                    eng.submit(p, max_new_tokens=10)
                if cut:
                    for _ in range(2):
                        eng.step()
                    out[side + "_blob"] = eng.snapshot()
                else:
                    eng.run(800)
                    out[side + "_tokens"] = _tokens(eng)
    assert out["ref_tokens"] == out["port_tokens"]
    return out


def _tokens(eng) -> list:
    return [r.generated for r in sorted(eng.requests.values(),
                                        key=lambda r: r.req_id)]


def test_reference_spec_blob_restores_into_the_port(pair, spec_crossing):
    teng = _both(pair, draft="pair", sync=True)[1]
    teng.restore(spec_crossing["ref_blob"])
    teng.run(800)
    assert all(r.done for r in teng.requests.values())
    assert _tokens(teng) == spec_crossing["ref_tokens"]
    assert teng.stats["spec_rounds"] > 0


def test_port_spec_blob_restores_into_the_reference(pair, spec_crossing):
    jeng = _both(pair, draft="pair", sync=True)[0]
    jeng.restore(spec_crossing["port_blob"])
    with jax.disable_jit():
        jeng.run(800)
    assert all(r.done for r in jeng.requests.values())
    assert _tokens(jeng) == spec_crossing["port_tokens"]
    assert jeng.pool.outstanding == 0


# ---------------------------------------------------------------------------
# The verify attention and layer against the reference
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(42)


def _paged_case(dtype, b=3, w=4, h=4, k=2, d=16, p=8, max_pages=4,
                n_pages=16):
    """``tests/test_kernels.py::_paged_case``, as numpy arrays."""
    q = RNG.standard_normal((b, w, h, d))
    kp = RNG.standard_normal((n_pages, p, k, d))
    vp = RNG.standard_normal((n_pages, p, k, d))
    table = np.stack([RNG.choice(np.arange(1, n_pages), max_pages,
                                 replace=False)
                      for _ in range(b)]).astype(np.int32)
    positions = RNG.integers(0, p * max_pages - w + 1, b).astype(np.int32)
    jx = [jnp.asarray(a, dtype) for a in (q, kp, vp)]
    tx = [_torch_of(a) for a in jx]
    return (jx + [jnp.asarray(table), jnp.asarray(positions)],
            tx + [torch.from_numpy(table), torch.from_numpy(positions)])


def _torch_of(a) -> torch.Tensor:
    """A JAX array's exact values as a torch tensor of the same dtype."""
    if a.dtype == jnp.bfloat16:
        bits = np.asarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a).copy())


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == jnp.bfloat16 else \
        dict(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_paged_verify_matches_reference(dtype):
    jx, tx = _paged_case(dtype)
    got = ops.paged_verify_attention(*tx)
    want = jref.paged_verify_attention(*jx)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))
    assert got.dtype == tx[0].dtype


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_verify_fold_matches_reference(dtype):
    """The card's route of ``ops.paged_verify_attention`` (``ops._fold``,
    one window row a folded lane at its own length) with the paged decode
    kernel's plain twin in its place, against the reference's oracle."""
    jx, (q, kp, vp, table, positions) = _paged_case(dtype)
    lengths = positions[:, None] + torch.arange(q.shape[1]) + 1
    got = ops._fold(q, kp, vp, table, lengths,
                    run=ops.ref.paged_decode_attention)
    assert got.shape == q.shape and got.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jref.paged_verify_attention(*jx),
                                          np.float32), **_tol(dtype))


def test_paged_verify_equals_sequential_decode():
    """Query j of the window equals a single-token paged decode at length
    ``positions + j + 1`` (``tests/test_kernels.py:187-198``)."""
    _, (q, kp, vp, table, positions) = _paged_case(jnp.float32)
    window = ops.paged_verify_attention(q, kp, vp, table, positions)
    for j in range(q.shape[1]):
        step = ops.paged_decode_attention(q[:, j], kp, vp, table,
                                          positions + j + 1)
        np.testing.assert_allclose(window[:, j].numpy(), step.numpy(),
                                   atol=2e-6, rtol=2e-6)


def test_paged_verify_counts_as_a_plain_paged_decode():
    _, tx = _paged_case(jnp.float32)
    ops.reset_counts()
    ops.paged_verify_attention(*tx)
    assert ops.counts()["paged_decode_attention"] == {"launches": 0,
                                                      "plain": 1}


def test_attn_verify_paged_matches_reference(pair):
    """One attention layer of REDUCED qwen3-8b over a verify window: the
    output and both pools after the window's K/V scatter, a position past
    the table's capacity landing on the scratch page."""
    cfg, jm, jp, *_, tm, tp, _, _ = pair
    B, W, P, n_pages, max_pages = 3, 4, 8, 12, 3
    rng = np.random.default_rng(31)
    x = jnp.asarray(rng.standard_normal((B, W, cfg.d_model)), jnp.bfloat16)
    kp = jnp.asarray(rng.standard_normal(
        (n_pages, P, cfg.n_kv_heads, cfg.d_head)), jnp.bfloat16)
    vp = jnp.asarray(rng.standard_normal(kp.shape), jnp.bfloat16)
    table = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32)
    positions = np.array([0, 9, P * max_pages - 2], np.int32)  # last spills
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    with jax.disable_jit():
        jout, jk, jv = jlayers.attn_verify_paged(
            jattn, x, cfg, jnp.asarray(positions), kp, vp,
            jnp.asarray(table))
    tk, tv = _torch_of(kp), _torch_of(vp)
    tout = ll.attn_verify_paged(tp.layers[0].attn, _torch_of(x), tm.cfg,
                                torch.from_numpy(positions), tk, tv,
                                torch.from_numpy(table))
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout, np.float32), atol=2e-2,
                               rtol=2e-2)
    for got, want in ((tk, jk), (tv, jv)):
        # pages the window wrote, and every other page untouched
        np.testing.assert_allclose(got[1:].float().numpy(),
                                   np.asarray(want, np.float32)[1:],
                                   atol=2e-2, rtol=2e-2)


def test_paged_kv_append_multi_matches_reference():
    rng = np.random.default_rng(5)
    pages = jnp.asarray(rng.standard_normal((10, 4, 2, 8)), jnp.float32)
    new = jnp.asarray(rng.standard_normal((2, 3, 2, 8)), jnp.float32)
    table = jnp.asarray([[1, 2, 3], [4, 5, 6]], jnp.int32)
    positions = jnp.asarray([2, 10], jnp.int32)   # lane 1 spills at 12
    want = jlayers.paged_kv_append_multi(pages, new, table, positions)
    got = _torch_of(pages)
    ll.paged_kv_append_multi(got, _torch_of(new), _torch_of(table),
                             _torch_of(positions))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
