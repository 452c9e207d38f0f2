"""The port's serving engine against the JAX package's, token for token.

Each scenario runs twice on the same REDUCED ``qwen3-8b`` weights (the
reference's ``ModelFns.init(jax.random.key(0))``, handed across by the
bridge): once through ``repro.serving.engine.ServeEngine`` and once through
``repro_torch.serving.engine.ServeEngine`` on the CPU. Every request's
tokens and every ``stats`` counter must be equal. Scenarios follow the
reference's own tests: more requests than slots, continuous batching
against the synchronous oracle (``tests/test_scheduler.py:215``), shared
prefixes with copy-on-write (``tests/test_prefix_share.py:176,217``),
preemption and shedding (``tests/test_scheduler.py:313,344``), ``cancel``,
a sampled request, and the serve CLI.

Where a greedy step sits on a near tie that the two packages' bf16
roundings break differently (``tests/test_torch_model.py``; ROADMAP Queue
3, P1), the scenario is held by teacher forcing: the port commits the
reference's token through ``step(force_tokens=...)`` and the number of
steps whose own choice differed (``forced_mismatches``) is bounded.
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


@pytest.fixture(scope="module")
def qwen():
    cfg = REDUCED["qwen3-8b"]
    ref = ref_get_model(cfg)
    ref_params = ref.init(jax.random.key(0))
    port = get_model(get("qwen3-8b", reduced=True))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), port,
                                   device="cpu")
    return cfg, ref, ref_params, port, params


def _engines(qwen, sched: dict | None = None, **kw):
    """A reference engine and a port engine with the same settings."""
    _, ref, ref_params, port, params = qwen
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 96)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("prefill_chunk", 32)
    r = RefEngine(ref, ref_params, paged=True,
                  scheduler=RefSched(**sched) if sched is not None else None,
                  **kw)
    p = ServeEngine(port, params, device="cpu",
                    scheduler=SchedulerConfig(**sched)
                    if sched is not None else None, **kw)
    return r, p


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]


class _Oracle:
    """``force_tokens`` for the port: the reference's next committed token
    of each request, looked up when the step commits it (so a request
    admitted and decoded within one step is forced too)."""

    def __init__(self, port: ServeEngine, ref: RefEngine):
        self.port, self.ref = port, ref

    def __contains__(self, rid) -> bool:
        gen = self.ref.requests.get(rid)
        return gen is not None and \
            len(self.port.requests[rid].generated) < len(gen.generated)

    def __getitem__(self, rid) -> int:
        return self.ref.requests[rid].generated[
            len(self.port.requests[rid].generated)]


def _force_from(port: ServeEngine, ref: RefEngine) -> None:
    """Teacher-force the port's engine with the reference's tokens."""
    step = port.step
    port.step = lambda force_tokens=None: step(force_tokens=_Oracle(port, ref))


def _same(ref: RefEngine, port: ServeEngine, *, forced_ok: int = 0) -> None:
    rr = {r.req_id: r for r in ref.requests.values()}
    pr = {r.req_id: r for r in port.requests.values()}
    assert sorted(rr) == sorted(pr)
    for rid in rr:
        assert pr[rid].generated == rr[rid].generated, rid
        assert (pr[rid].done, pr[rid].shed) == (rr[rid].done, rr[rid].shed)
    stats = dict(port.stats)
    assert stats.pop("forced_mismatches") <= forced_ok
    stats.pop("forced_tokens")   # counts the oracle's forcing, not a result
    ref_stats = {k: v for k, v in ref.stats.items()
                 if k not in ("forced_mismatches", "forced_tokens")}
    assert stats == ref_stats
    assert port.pool.outstanding == ref.pool.outstanding
    assert port.pool.available == ref.pool.available
    assert np.array_equal(port.page_table, ref.page_table)


def test_more_requests_than_slots(qwen):
    cfg = qwen[0]
    prompts = _prompts(cfg, [24, 40, 8, 70, 16, 33], seed=20)
    ref, port = _engines(qwen)
    for eng in (ref, port):
        for i, p in enumerate(prompts):
            eng.submit(p, max_new_tokens=4 + i)
    ref.run(400)
    port.run(400)
    assert all(r.done for r in port.requests.values())
    _same(ref, port)


def test_continuous_matches_synchronous_and_reference(qwen):
    """Slots join and leave mid-decode in the port exactly as in the
    reference, and the port's continuous run equals its own synchronous
    oracle token for token."""
    cfg = qwen[0]
    prompts = _prompts(cfg, [24, 40, 8, 32, 16], seed=10)
    news = [6, 3, 9, 4, 7]
    ref, cont = _engines(qwen)
    _, sync = _engines(qwen, sched={"token_budget": None})
    for eng in (ref, cont, sync):
        for p, n in zip(prompts, news):
            eng.submit(p, max_new_tokens=n)
    joined_mid_stream = False
    for _ in range(300):
        mid = any(0 < len(r.generated) < r.max_new_tokens
                  for r in cont.requests.values() if r.slot is not None)
        before = {i for i, r in enumerate(cont.slot_req) if r is not None}
        ref.step()
        cont.step()
        assert cont.last_step_tokens == ref.last_step_tokens
        after = {i for i, r in enumerate(cont.slot_req) if r is not None}
        joined_mid_stream |= mid and bool(after - before)
        if not cont.pending():
            break
    assert joined_mid_stream
    assert not ref.pending()
    _same(ref, cont)
    sync.run(300)
    assert [r.generated for r in sync.requests.values()] == \
        [r.generated for r in cont.requests.values()]


def test_shared_prefix_and_cow(qwen):
    """Requests sharing a 32-token prefix share its pages; an identical
    page-aligned prompt is a whole-prompt hit that copies the last shared
    page on write."""
    cfg = qwen[0]
    rng = np.random.default_rng(1)
    prefix = rng.integers(1, cfg.vocab_size, 2 * PAGE).tolist()
    prompts = [prefix + rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (8, 8, 5)] + [prefix, prefix]
    ref, port = _engines(qwen)
    for eng in (ref, port):
        for p in prompts:
            eng.submit(p, max_new_tokens=5)
    ref.run(300)
    port.run(300)
    assert port.stats["cow_copies"] >= 1
    assert port.stats["prefill_tokens_shared"] > 0
    _same(ref, port)
    assert port.pool.available == port.n_pages - 1


def test_prefix_survives_completion_and_pressure(qwen):
    """A completed request's prefix is revived from the free list, and
    under page pressure a cached-prefix request is admitted past an
    oversized head (``tests/test_prefix_share.py``)."""
    cfg = qwen[0]
    rng = np.random.default_rng(4)
    prefix = rng.integers(1, cfg.vocab_size, 2 * PAGE).tolist()
    a = prefix + rng.integers(1, cfg.vocab_size, 4).tolist()
    big = rng.integers(1, cfg.vocab_size, 64).tolist()
    c = prefix + rng.integers(1, cfg.vocab_size, 8).tolist()
    ref, port = _engines(qwen, n_pages=8)
    for eng in (ref, port):
        eng.submit(a, max_new_tokens=8)
        eng.step()
        eng.submit(big, max_new_tokens=16)
        rc = eng.submit(c, max_new_tokens=8)
        eng.step()
        assert rc.slot is not None
        eng.run(500)
    _same(ref, port)
    assert port.stats["prefix_evictions"] > 0


def test_preemption_round_trip(qwen):
    """The victim resumes token-exactly after re-prefill; the preempting
    request meets a near tie at position 16 (ROADMAP Queue 3, P1), held by
    teacher forcing."""
    cfg = qwen[0]
    pv, ph = _prompts(cfg, [32, 16], seed=13)
    ref, port = _engines(qwen, n_slots=1)
    _force_from(port, ref)
    for eng in (ref, port):
        victim = eng.submit(pv, max_new_tokens=10)
        for _ in range(5):
            eng.step()
        eng.submit(ph, max_new_tokens=4, priority=2)
        eng.step()
        assert eng.stats["preemptions"] == 1 and victim.resume
        eng.run(400)
    assert port.stats["resume_mismatches"] == 0
    _same(ref, port, forced_ok=1)


def test_shedding(qwen):
    """Overflow sheds the lowest-ranked tail, expiry drops a hopeless TTFT
    deadline; one near tie at position 21 (ROADMAP Queue 3, P1) is held by
    teacher forcing."""
    cfg = qwen[0]
    ps = _prompts(cfg, [16] * 7, seed=14)
    ref, port = _engines(qwen, n_slots=1, sched={"max_queue": 2})
    _force_from(port, ref)
    for eng in (ref, port):
        eng.submit(ps[0], max_new_tokens=8)
        eng.step()
        for p in ps[1:5]:
            eng.submit(p, max_new_tokens=2)
        eng.step()
        eng.run(300)
        eng.submit(ps[5], max_new_tokens=8)
        eng.step()
        eng.submit(ps[6], max_new_tokens=2, deadline_ms=5)
        for _ in range(4):
            eng.step()
        eng.run(300)
    assert port.stats["shed_overflow"] == 2
    assert port.stats["shed_expired"] == 1
    _same(ref, port, forced_ok=1)


def test_cancel(qwen):
    cfg = qwen[0]
    ps = _prompts(cfg, [20, 40, 12], seed=15)
    ref, port = _engines(qwen)
    out = []
    for eng in (ref, port):
        reqs = [eng.submit(p, max_new_tokens=8) for p in ps]
        for _ in range(4):
            eng.step()
        active = eng.cancel(reqs[0].req_id)      # mid-decode
        queued = eng.cancel(reqs[2].req_id)      # still waiting
        out.append((list(active.generated), list(queued.generated)))
        eng.run(300)
    assert out[0] == out[1]
    assert out[1][0] and not out[1][1]
    assert port.requests.keys() == ref.requests.keys()
    _same(ref, port)


def test_sampled_request_matches(qwen):
    """A temperature > 0 request draws its Gumbel noise on the host from
    (seed, position), so its stream equals the reference's."""
    cfg = qwen[0]
    ps = _prompts(cfg, [20, 9], seed=16)
    ref, port = _engines(qwen)
    for eng in (ref, port):
        eng.submit(ps[0], max_new_tokens=10, temperature=0.8, seed=7)
        eng.submit(ps[1], max_new_tokens=6)
        eng.run(300)
    greedy_like = _engines(qwen)[1]
    g = greedy_like.submit(ps[0], max_new_tokens=10)
    greedy_like.run(300)
    assert port.requests[0].generated != g.generated   # it did sample
    _same(ref, port)


def test_force_tokens_counts_mismatches(qwen):
    cfg = qwen[0]
    (p,) = _prompts(cfg, [12], seed=17)
    free, forced = _engines(qwen)[1], _engines(qwen)[1]
    own = free.submit(p, max_new_tokens=4)
    free.run(10)
    req = forced.submit(p, max_new_tokens=4)
    other = (own.generated[2] + 1) % cfg.vocab_size
    forced.step(force_tokens={req.req_id: own.generated[1]})  # agrees
    forced.step(force_tokens={req.req_id: other})             # overrides
    assert req.generated == own.generated[:2] + [other]
    assert forced.stats["forced_tokens"] == 2
    assert forced.stats["forced_mismatches"] == 1


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve

    done = serve.main(["--arch", "qwen3-8b", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new", "4"])
    assert len(done) == 3 and all(len(r.generated) == 4 for r in done)
    assert "3/3 requests completed" in capsys.readouterr().out
