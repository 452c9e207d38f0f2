"""The port's engine on the SSM and hybrid families, against the JAX
package's, token for token.

Each scenario runs on the same REDUCED ``falcon-mamba-7b`` or
``zamba2-1.2b`` weights (the reference's ``ModelFns.init(jax.random.key(0))``,
handed across by the bridge) through ``repro.serving.engine.ServeEngine``
and ``repro_torch.serving.engine.ServeEngine`` on the CPU, in continuous
and in synchronous mode. Every request's tokens and every ``stats``
counter must be equal. The scenarios are the reference's own for these
families: paged serving of three prompts (``tests/test_paged.py:263-281``),
failed admissions that must not inflate the would-be-hit counters
(``tests/test_prefix_share.py:290``) and the bookkeeping-only trie
(``tests/test_prefix_share.py:374``); then preemption, which re-prefills
from offset 0, and the serve CLI.

Last, R3 (ROADMAP Queue 3): a lane whose chunked prefill overlaps batched
decode steps of another lane ends its prefill with exactly the conv and
SSM state a solo prefill of the same prompt gives, bit for bit. The
reference's decode advances that lane's state too; with these weights
(``A_log`` drawn at scale 1e-4, so A is about -1 and the state forgets
within a chunk) its greedy tokens are unaffected, which is why the
token-for-token scenarios hold in continuous mode as well.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import REDUCED  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as RefSched  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

torch.set_num_threads(1)
PAGE = 16
MODES = {"continuous": None, "synchronous": {"token_budget": None}}


@pytest.fixture(scope="module", params=["falcon-mamba-7b", "zamba2-1.2b"])
def fam(request):
    cfg = REDUCED[request.param]
    ref = ref_get_model(cfg)
    ref_params = ref.init(jax.random.key(0))
    port = get_model(get(request.param, reduced=True))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), port,
                                   device="cpu")
    return cfg, ref, ref_params, port, params


def _engines(fam, mode: str, **kw):
    """A reference engine and a port engine with the same settings."""
    _, ref, ref_params, port, params = fam
    sched = MODES[mode]
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("prefill_chunk", 16)
    r = RefEngine(ref, ref_params, paged=True,
                  scheduler=RefSched(**sched) if sched is not None else None,
                  **kw)
    # the reference's model op by op, without XLA's excess precision
    # (tests/test_torch_ssm_model.py): jitted, it moves zamba2's prefill
    # logits enough to flip a first token, which teacher forcing cannot
    # hold
    r._prefill_chunk, r._decode_paged = ref.prefill_chunk, ref.decode_paged
    p = ServeEngine(port, params, device="cpu",
                    scheduler=SchedulerConfig(**sched)
                    if sched is not None else None, **kw)
    return r, p


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]


def _shared_prompts(cfg, prefix_len, suffix_lens, seed):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, cfg.vocab_size, prefix_len).tolist()
    return [prefix + rng.integers(1, cfg.vocab_size, n).tolist()
            for n in suffix_lens]


def _same(ref: RefEngine, port: ServeEngine) -> None:
    rr = {r.req_id: r for r in ref.requests.values()}
    pr = {r.req_id: r for r in port.requests.values()}
    assert sorted(rr) == sorted(pr)
    for rid in rr:
        assert pr[rid].generated == rr[rid].generated, rid
        assert (pr[rid].done, pr[rid].shed) == (rr[rid].done, rr[rid].shed)
    assert port.stats == ref.stats
    assert port.pool.outstanding == ref.pool.outstanding
    assert port.pool.available == ref.pool.available
    assert np.array_equal(port.page_table, ref.page_table)
    assert len(port.prefix_index) == len(ref.prefix_index)


@pytest.mark.parametrize("mode", MODES)
def test_paged_serve_matches_reference(fam, mode):
    """``tests/test_paged.py:263-281``: chunked prefill writes recurrent
    state in place (dt = 0 pad identity); three requests on two slots."""
    cfg = fam[0]
    prompts = _prompts(cfg, [6, 18, 9], seed=8)
    ref, port = _engines(fam, mode)
    for eng in (ref, port):
        for p in prompts:
            eng.submit(p, max_new_tokens=4)
        eng.run(300)
    assert all(r.done for r in port.requests.values())
    _same(ref, port)


@pytest.mark.parametrize("mode", MODES)
def test_failed_admission_retries_do_not_inflate_stats(fam, mode):
    """``tests/test_prefix_share.py:290``: a queued request retried every
    step while the pool is full bumps the would-be-hit counters once."""
    cfg = fam[0]
    rng = np.random.default_rng(9)
    prefix = rng.integers(1, cfg.vocab_size, 32).tolist()
    p1 = prefix + rng.integers(1, cfg.vocab_size, 4).tolist()
    p2 = prefix + rng.integers(1, cfg.vocab_size, 6).tolist()
    ref, port = _engines(fam, mode, n_pages=4)
    for eng in (ref, port):
        eng.submit(p1, max_new_tokens=8)     # 3 pages: fills the pool
        eng.submit(p2, max_new_tokens=8)     # a would-be hit, but must wait
        for _ in range(4):                   # several failed retries
            eng.step()
        assert eng.stats["prefix_hits"] <= 1
        eng.run(300)
    assert port.stats["prefix_hits"] == 1
    assert port.stats["prefix_hit_tokens"] == 32
    assert port.pool.outstanding == 0
    _same(ref, port)


@pytest.mark.parametrize("mode", MODES)
def test_stateful_family_falls_back_to_bookkeeping(fam, mode):
    """``tests/test_prefix_share.py:374``: the trie counts would-be hits
    through phantom ids, but prefill is never skipped."""
    cfg, _, _, port_model, _ = fam
    assert not port_model.supports_prefix_sharing
    prompts = _shared_prompts(cfg, 32, [4, 6], seed=7)
    ref, port = _engines(fam, mode)
    assert port.prefix_cache and not port.prefix_share
    for eng in (ref, port):
        for p in prompts:
            eng.submit(p, max_new_tokens=4)
        eng.run(300)
    assert port.stats["prefill_tokens_shared"] == 0
    assert port.stats["prefix_hit_tokens"] >= 32
    assert port.stats["prefill_tokens"] == sum(len(p) for p in prompts)
    assert min(port.prefix_index._nodes) >= port.n_pages   # phantom ids
    assert port.pool.outstanding == 0
    _same(ref, port)


def test_preemption_re_prefills_from_offset_zero(fam):
    """A preempted stream resumes token-exactly: its prompt and committed
    tokens are prefilled again from offset 0 (nothing of a recurrent
    state can be shared), and the last committed token is re-derived."""
    cfg = fam[0]
    pv, ph = _prompts(cfg, [20, 9], seed=13)
    ref, port = _engines(fam, "continuous", n_slots=1)
    resumed = []
    for eng in (ref, port):
        victim = eng.submit(pv, max_new_tokens=8)
        for _ in range(4):
            eng.step()
        eng.submit(ph, max_new_tokens=3, priority=2)
        eng.step()
        assert eng.stats["preemptions"] == 1 and victim.resume
        resumed.append(len(victim.resume))
        eng.run(300)
    assert port.stats["resume_mismatches"] == 0
    assert port.stats["prefill_tokens_shared"] == 0
    assert port.stats["prefill_tokens"] == 2 * len(pv) + len(ph) + resumed[1]
    _same(ref, port)


def _slot_state(cache, slot: int) -> dict:
    return {k: v[:, slot].clone() for k, v in cache.items()
            if not k.endswith("_pages")}


def _overlapped_prefill_state(fam, long_: list[int], short: list[int], *,
                              guard: bool) -> dict:
    """The conv and SSM rows of the slot that prefills ``long_`` in chunks
    of 16 under a token budget of 4 (one chunk per step) while ``short``
    decodes, taken when its last chunk lands. ``guard=False`` runs the
    batched decode bare, as the reference does."""
    _, _, _, model, params = fam
    eng = ServeEngine(model, params, n_slots=2, max_seq=96, page_size=PAGE,
                      prefill_chunk=16, device="cpu",
                      scheduler=SchedulerConfig(token_budget=4))
    if not guard:
        eng._decode_step = lambda batch: model.decode_paged(params, eng.cache,
                                                            batch)
    decoder = eng.submit(short, max_new_tokens=20)
    eng.step()
    eng.step()
    assert decoder.generated and decoder.slot is not None
    target = eng.submit(long_, max_new_tokens=2)
    finished, decoded_meanwhile = {}, 0
    finish = eng._finish_prefill

    def spy(slot, req, *args):
        if req is target:
            finished.update(_slot_state(eng.cache, slot))
        finish(slot, req, *args)

    eng._finish_prefill = spy
    while not finished:
        before = len(decoder.generated)
        eng.step()
        if eng.prefilling:
            decoded_meanwhile += len(decoder.generated) - before
    assert decoded_meanwhile >= 3     # decode steps overlapped the prefill
    return finished


def test_r3_prefilling_lane_keeps_its_state(fam):
    """A 60-token prompt prefilled in chunks of 16 while another lane
    decodes ends with the conv and SSM rows of a solo prefill, bit for
    bit; without the guard (the reference's behavior) they differ."""
    cfg, _, _, model, params = fam
    short, long_ = _prompts(cfg, [8, 60], seed=21)
    solo = model.init_paged_cache(1, 5, PAGE, device="cpu")
    table = torch.tensor([1, 2, 3, 4, 0, 0], dtype=torch.int32)
    for off in range(0, len(long_), 16):
        n = min(16, len(long_) - off)
        toks = torch.zeros(1, 16, dtype=torch.int32)
        toks[0, :n] = torch.tensor(long_[off:off + n])
        model.prefill_chunk(params, solo, {"tokens": toks, "valid": n,
                                           "slot": 0, "page_table": table},
                            offset=off)
    want = _slot_state(solo, 0)
    got = _overlapped_prefill_state(fam, long_, short, guard=True)
    assert set(got) == set(want) == {"conv", "ssm"}
    for k in want:
        assert torch.equal(got[k], want[k]), k
    bare = _overlapped_prefill_state(fam, long_, short, guard=False)
    assert not torch.equal(bare["ssm"], want["ssm"])


def test_serve_cli_on_cpu(fam, capsys):
    from repro_torch.launch import serve

    done = serve.main(["--arch", fam[0].arch_id, "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new", "3",
                       "--prompt-len", "20"])
    assert len(done) == 3 and all(len(r.generated) == 3 for r in done)
    assert "3/3 requests completed" in capsys.readouterr().out
