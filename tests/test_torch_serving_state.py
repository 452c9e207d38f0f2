"""The port's host-side serving state against the JAX package's.

``PagePool``, ``PrefixIndex``, ``pages_needed`` and the scheduler policy
are plain Python that the port copies; these tests drive the reference's
classes and the port's with the same scripts and require the same
results, so the copies cannot drift.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serving import kvcache as ref_kv  # noqa: E402
from repro.serving import scheduler as ref_sched  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro_torch.serving import kvcache as port_kv  # noqa: E402
from repro_torch.serving import scheduler as port_sched  # noqa: E402
from repro_torch.serving.engine import Request as PortRequest  # noqa: E402


@pytest.mark.parametrize("seed", range(4))
def test_page_pool_scripts_agree(seed):
    """A random script of alloc / share / free / touch / serialize leaves
    both pools in the same state after every operation."""
    rng = np.random.default_rng(seed)
    pools = [ref_kv.PagePool(24), port_kv.PagePool(24)]
    held: list[list[int]] = []
    for _ in range(200):
        op = rng.integers(4)
        if op == 0:
            n = int(rng.integers(1, 6))
            got = [p.alloc(n) for p in pools]
            assert got[0] == got[1]
            if got[0] is not None:
                held.append(got[0])
        elif op == 1 and held:
            chain = held[int(rng.integers(len(held)))]
            for p in pools:
                p.share(chain[:2])
            held.append(chain[:2])
        elif op == 2 and held:
            chain = held.pop(int(rng.integers(len(held))))
            for p in pools:
                p.free(chain)
        elif op == 3 and held:
            for p in pools:
                p.touch(held[-1][:1])
        assert pools[0].serialize() == pools[1].serialize()
        assert (pools[0].available, pools[0].outstanding) == \
            (pools[1].available, pools[1].outstanding)
    other = port_kv.PagePool(24)
    other.restore(*pools[0].serialize())
    assert other.serialize() == pools[0].serialize()


def test_page_pool_rejects_bad_use():
    pool = port_kv.PagePool(4)
    pages = pool.alloc(2)
    pool.free(pages)
    with pytest.raises(AssertionError):
        pool.free(pages)
    with pytest.raises(ValueError, match="corrupt"):
        port_kv.PagePool(4).restore([1, 1, 2])
    assert [port_kv.pages_needed(n, 16) for n in (0, 1, 16, 17)] == \
        [ref_kv.pages_needed(n, 16) for n in (0, 1, 16, 17)] == [1, 1, 1, 2]


@pytest.mark.parametrize("seed", range(3))
def test_prefix_index_scripts_agree(seed):
    """Insert / lookup / remap / evict on both tries; same chains, same
    dropped subtrees, same serialized form."""
    rng = np.random.default_rng(seed)
    P = 4
    tries = [ref_kv.PrefixIndex(P), port_kv.PrefixIndex(P)]
    prefixes = [rng.integers(0, 5, 3 * P).tolist() for _ in range(3)]
    next_id = 1
    for _ in range(60):
        toks = prefixes[int(rng.integers(3))][: P * int(rng.integers(1, 4))]
        toks = toks + rng.integers(0, 3, int(rng.integers(0, 2 * P))).tolist()
        op = rng.integers(3)
        if op == 0:
            chain = list(range(next_id, next_id + len(toks) // P))
            next_id += len(chain)
            for t in tries:
                t.insert(toks, chain)
        elif op == 1:
            found = [t.lookup(toks) for t in tries]
            assert found[0] == found[1]
            if found[0]:
                drop = found[0][int(rng.integers(len(found[0])))]
                assert tries[0].evict_pages([drop]) == \
                    tries[1].evict_pages([drop])
        else:
            found = tries[0].lookup(toks)
            if found:
                for t in tries:
                    t.remap(found[-1], next_id)
                next_id += 1
        assert tries[0].serialize() == tries[1].serialize()
        assert len(tries[0]) == len(tries[1])
    loaded = port_kv.PrefixIndex.load(P, tries[0].serialize())
    assert loaded.serialize() == tries[0].serialize()


def test_scheduler_policy_agrees():
    """Admission order, aging, deadlines, bypass, victims, overflow and the
    token budget: the port's copy decides as the reference does."""
    rng = np.random.default_rng(7)
    specs = [dict(priority=int(rng.integers(3)),
                  deadline_ms=None if rng.random() < 0.5
                  else float(rng.integers(10, 200)),
                  arrival_step=int(rng.integers(20)))
             for _ in range(12)]
    cfg = dict(aging_steps=4, bypass_margin=2, preempt_margin=2, max_queue=5,
               class_shares={2: 0.4})
    pair = []
    for sched, req in ((ref_sched, RefRequest), (port_sched, PortRequest)):
        s = sched.Scheduler(sched.SchedulerConfig(**cfg))
        reqs = [req(i, [1, 2, 3], 4, None, **kw) if sched is port_sched
                else req(i, [1, 2, 3], 4, None, {}, **kw)
                for i, kw in enumerate(specs)]
        pair.append((s, reqs))
    for step in (0, 7, 30):
        ids = [[r.req_id for r in s.order(reqs, step)] for s, reqs in pair]
        assert ids[0] == ids[1]
        over = [[r.req_id for r in s.overflow(reqs, step)] for s, reqs in pair]
        assert over[0] == over[1]
        for i in range(len(specs)):
            a = [s.expired(reqs[i], step) for s, reqs in pair]
            b = [s.may_bypass(reqs[i], reqs[-1 - i], step)
                 for s, reqs in pair]
            assert a[0] == a[1] and b[0] == b[1]
    victims = [s.pick_victim(reqs[0], reqs[1:]) for s, reqs in pair]
    assert (victims[0] and victims[0].req_id) == (victims[1] and
                                                 victims[1].req_id)
    for lanes in (0, 3, 300):
        assert pair[0][0].prefill_budget(lanes, False) == \
            pair[1][0].prefill_budget(lanes, False)
