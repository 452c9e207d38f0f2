"""The port's spill tier against the JAX package's.

- the plain-Python copies (``core/cloudlet.py``, ``core/reliability.py``,
  kvcache's ``PagePool``, ``PrefixIndex`` and ``RemotePagePool``): the cases
  of ``tests/test_spill.py`` run against both packages, one script of
  operations gives equal ``to_state()`` dicts and pool ``stats`` in both,
  and the hypothesis slot-spill lifecycle of ``tests/test_property.py``
  runs against the port's classes;
- page payloads: a port cache and a reference cache holding the same bits
  give byte-equal blobs, each package's blob deserializes in the other to
  the same bits, and the batched extraction equals the per-page one;
- the engine scenarios of ``tests/test_spill.py`` on REDUCED ``qwen3-8b``
  (the reference's weights, handed across by the bridge): the port's spill
  engine gives the no-spill engine's tokens, and, teacher-forced on the
  reference's tokens (``tests/test_torch_engine.py``'s helper, for the near
  ties of ROADMAP Queue 3, P1), every ``stats`` counter of the reference
  engine, the remote pool's counters and the same leases;
- snapshots carrying spilled stubs and slot-spill groups cross packages
  both ways against one shared remote pool, and the pages recalled are the
  bytes the other package lent;
- the SSM and hybrid families accept a remote pool and never spill.
"""

import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.checkpoint.serializer as ref_serializer  # noqa: E402
import repro.core.cloudlet as ref_cloudlet  # noqa: E402
import repro.core.reliability as ref_reliability  # noqa: E402
import repro.serving.kvcache as ref_kv  # noqa: E402
import repro_torch.core.cloudlet as port_cloudlet  # noqa: E402
import repro_torch.core.reliability as port_reliability  # noqa: E402
import repro_torch.serving.engine as port_engine  # noqa: E402
import repro_torch.serving.kvcache as port_kv  # noqa: E402
from repro.configs import REDUCED  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as RefSched  # noqa: E402
from repro_torch.bridge import params_from_reference, tensor_from_numpy  # noqa: E402
from repro_torch.checkpoint.serializer import deserialize_tree  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402
from test_torch_engine import _force_from  # noqa: E402

torch.set_num_threads(1)
PAGE = 16

PKGS = {
    "repro": types.SimpleNamespace(cloudlet=ref_cloudlet,
                                   reliability=ref_reliability, kv=ref_kv),
    "repro_torch": types.SimpleNamespace(cloudlet=port_cloudlet,
                                         reliability=port_reliability,
                                         kv=port_kv),
}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


# ---------------------------------------------------------------------------
# LeaseTable + registry churn (tests/test_spill.py:37-103), both packages
# ---------------------------------------------------------------------------


def test_lease_table_grant_release_invalidate(pkg):
    t = pkg.cloudlet.LeaseTable()
    a = t.grant("serve", "h0", "h1", 100)
    b = t.grant("serve", "h0", "h2", 200)
    c = t.grant("train", "h3", "h1", 300)
    assert len(t) == 3 and t.valid(a.lease_id)
    assert {m.lease_id for m in t.held_by("h1")} == {a.lease_id, c.lease_id}
    assert {m.lease_id for m in t.of_lender("h0")} == {a.lease_id, b.lease_id}
    gone = t.invalidate_holder("h1", cloudlet="serve")
    assert gone == [a.lease_id]
    assert t.valid(c.lease_id) and not t.valid(a.lease_id)
    assert t.release(b.lease_id).holder == "h2"
    assert t.release(b.lease_id) is None
    assert len(t) == 1


def test_lease_table_state_round_trip(pkg):
    t = pkg.cloudlet.LeaseTable()
    t.grant("serve", "h0", "h1", 64)
    t.grant("serve", "h0", "h2", 128)
    clone = pkg.cloudlet.LeaseTable.from_state(t.to_state())
    assert len(clone) == 2
    assert clone.grant("serve", "h0", "h1", 1).lease_id == 3


def test_registry_leave_revokes_held_leases(pkg):
    reg = pkg.cloudlet.CloudletRegistry()
    reg.create("serve", "arch")
    for h in ("h0", "h1", "h2"):
        reg.join("serve", h)
    a = reg.leases.grant("serve", "h0", "h1", 10)
    b = reg.leases.grant("serve", "h0", "h2", 10)
    assert reg.leave("serve", "h1") == [a.lease_id]
    assert "h1" not in reg.get("serve")
    assert reg.leases.valid(b.lease_id)
    assert reg.leave_all("h2") == [b.lease_id]
    assert len(reg.leases) == 0


def test_registry_rejects_reserved_cloudlet_names(pkg):
    reg = pkg.cloudlet.CloudletRegistry()
    with pytest.raises(ValueError):
        reg.create("__leases__", "arch")


def test_registry_state_round_trips_leases(pkg):
    reg = pkg.cloudlet.CloudletRegistry()
    reg.create("serve", "arch")
    reg.join("serve", "h0")
    reg.join("serve", "h1")
    reg.leases.grant("serve", "h0", "h1", 42)
    clone = pkg.cloudlet.CloudletRegistry.from_state(reg.to_state())
    assert clone.names() == ["serve"]
    assert len(clone.leases) == 1
    assert clone.leases.get(1).holder == "h1"
    assert clone.leave_all("h1") == [1]


# ---------------------------------------------------------------------------
# PagePool LRU + PrefixIndex remap (tests/test_spill.py:106-145)
# ---------------------------------------------------------------------------


def test_pool_alloc_retires_coldest_pages_first(pkg):
    pool = pkg.kv.PagePool(8)
    a = pool.alloc(7)
    pool.free(a)
    pool.touch([a[0]])
    assert pool.alloc(2) == [a[1], a[2]]
    fresh = pkg.kv.PagePool(8)
    b = fresh.alloc(2)
    fresh.free(b)
    assert fresh.alloc(2) == [3, 4]


def test_pool_touch_survives_snapshot(pkg):
    pool = pkg.kv.PagePool(8)
    a = pool.alloc(3)
    pool.free(a)
    pool.touch([a[0]])
    free, ref, touch = pool.serialize()
    clone = pkg.kv.PagePool(8)
    clone.restore(free, ref, touch)
    assert clone.alloc(2) == pool.alloc(2)


def test_prefix_index_remap_preserves_subtree(pkg):
    idx = pkg.kv.PrefixIndex(4)
    toks = [1] * 4 + [2] * 4 + [3] * 4
    idx.insert(toks, [10, 11, 12])
    idx.remap(11, 99)
    assert idx.lookup(toks) == [10, 99, 12]
    idx.remap(99, 5)
    assert idx.lookup(toks) == [10, 5, 12]
    assert set(idx.evict_pages([5])) == {5, 12}
    assert idx.lookup(toks) == [10]


# ---------------------------------------------------------------------------
# RemotePagePool (tests/test_spill.py:148-197)
# ---------------------------------------------------------------------------


def _cloudlet(pkg, peers=("h1", "h2"), fail=()):
    reg = pkg.cloudlet.CloudletRegistry()
    reg.create("serve", "arch")
    reg.join("serve", "h0")
    rel = pkg.reliability.ReliabilityRegistry()
    for h in peers:
        reg.join("serve", h)
        rel.add_host(h)
        if h in fail:
            rel.record_assignment(h)
            rel.record_host_failure(h)
    return reg, rel


def test_remote_pool_lend_recall_byte_exact(pkg):
    reg, rel = _cloudlet(pkg)
    pool = pkg.kv.RemotePagePool(reg, "serve", "h0", reliability=rel)
    blobs = [bytes([i]) * 37 for i in range(4)]
    leases = [pool.lend(b) for b in blobs]
    assert pool.lent == 4 and len(reg.leases) == 4
    got, wait = pool.recall([m.lease_id for m in leases])
    assert [got[m.lease_id] for m in leases] == blobs
    assert wait > 0
    assert pool.lent == 0 and len(reg.leases) == 0


def test_remote_pool_prefers_reliable_peers_and_respects_capacity(pkg):
    reg, rel = _cloudlet(pkg, fail=("h1",))
    pool = pkg.kv.RemotePagePool(reg, "serve", "h0", reliability=rel,
                                 peer_capacity_pages=2)
    holders = [pool.lend(b"x").holder for _ in range(4)]
    assert holders == ["h2", "h2", "h1", "h1"]
    assert pool.lend(b"x") is None
    assert pool.stats["lend_rejects"] == 1


def test_remote_pool_churned_holder_recall_misses(pkg):
    reg, rel = _cloudlet(pkg)
    pool = pkg.kv.RemotePagePool(reg, "serve", "h0", reliability=rel,
                                 peer_capacity_pages=1)
    a = pool.lend(b"a")
    b = pool.lend(b"b")
    reg.leave("serve", a.holder)
    got, _ = pool.recall([a.lease_id, b.lease_id])
    assert got[a.lease_id] is None
    assert got[b.lease_id] == b"b"
    assert pool.stats["recall_misses"] == 1
    assert pool.lent == 0


def _script(pkg) -> tuple:
    """One sequence of every pool operation: lend, stage, spill and recall
    slot groups, adopt, churn, release. Returns what a caller can see."""
    reg, rel = _cloudlet(pkg, peers=("h1", "h2", "h3"), fail=("h3",))
    rel.record_assignment("h1")
    rel.record_completion("h1")
    pool = pkg.kv.RemotePagePool(reg, "serve", "h0", reliability=rel,
                                 peer_capacity_pages=3)
    seen = [pool.peers()]
    leases = [pool.lend(bytes([i]) * (i + 3)) for i in range(4)]
    seen.append([(m.lease_id, m.holder) for m in leases])
    seen.append([pool.stage_page(7, i, b"s%d" % i) for i in range(3)])
    seen.append(pool.spill_slot(7, {i: b"p%d" % i for i in range(5)}))
    seen.append(pool.spill_slot(8, {0: b"q0"}))
    seen.append(pool.slot_leases(8))
    reg.leave("serve", "h2")
    seen.append(pool.recall([m.lease_id for m in leases]))
    seen.append(pool.adopt_slot(8, {i: lid for i, (lid, _)
                                    in pool.slot_leases(8).items()}))
    seen.append(pool.recall_slot(8))
    seen.append([pool.lend(b"z") is not None for _ in range(6)])
    pool.release_slot(7)
    return reg.to_state(), pool.stats, pool.lent, seen


def test_one_script_gives_equal_state_in_both_packages():
    ref, port = _script(PKGS["repro"]), _script(PKGS["repro_torch"])
    assert port == ref
    assert ref[1]["recall_misses"] and ref[1]["lend_rejects"]


def test_slot_spill_lifecycle_against_the_port_classes(monkeypatch):
    """``tests/test_property.py``'s hypothesis slot-spill lifecycle, run on
    the port's ``CloudletRegistry``, ``RemotePagePool`` and ``PagePool``
    (the test names them through ``repro``'s modules, which are patched
    here for its run)."""
    import test_property

    made = []

    class Remote(port_kv.RemotePagePool):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(ref_cloudlet, "CloudletRegistry",
                        port_cloudlet.CloudletRegistry)
    monkeypatch.setattr(ref_kv, "RemotePagePool", Remote)
    monkeypatch.setattr(test_property, "PagePool", port_kv.PagePool)
    test_property.test_slot_spill_lifecycle_conserves_pages_and_leases()
    assert made and all(isinstance(r.registry, port_cloudlet.CloudletRegistry)
                        for r in made)


# ---------------------------------------------------------------------------
# Page payloads
# ---------------------------------------------------------------------------


def _caches(seed=0, L=3, n_pages=9, K=2, dh=8):
    """A reference cache and a port cache holding the same bf16 bits, with
    a non-paged leaf beside the pools."""
    rng = np.random.default_rng(seed)
    arrs = {k: np.asarray(rng.standard_normal((L, n_pages, PAGE, K, dh)),
                          dtype=jnp.bfloat16) for k in ("k_pages", "v_pages")}
    arrs["conv"] = rng.standard_normal((L, 2, 5)).astype(np.float32)
    ref = {k: jnp.asarray(a) for k, a in arrs.items()}
    port = {k: tensor_from_numpy(a) for k, a in arrs.items()}
    return arrs, ref, port


def test_payload_blobs_are_byte_equal_to_the_reference():
    arrs, ref, port = _caches()
    for page in (1, 4, 8):
        want = ref_kv.extract_page_payload(ref, page)
        assert port_kv.extract_page_payload(port, page) == want
        only = port_kv.extract_page_payload(port, page, keys={"v_pages"})
        assert only == ref_kv.extract_page_payload(ref, page,
                                                   keys={"v_pages"})


def test_payloads_deserialize_across_packages_to_the_same_bits():
    arrs, ref, port = _caches(seed=1)
    ref_like = ref_kv.page_payload_like(ref)
    port_like = port_kv.page_payload_like(port)
    assert {k: tuple(v.shape) for k, v in port_like.items()} == \
        {k: v.shape for k, v in ref_like.items()}
    for page in (2, 7):
        # the port's blob in the reference
        got = ref_serializer.deserialize_tree(
            port_kv.extract_page_payload(port, page), ref_like)
        for k in ("k_pages", "v_pages"):
            assert np.array_equal(got[k].view(np.uint16),
                                  arrs[k][:, page].view(np.uint16))
        # the reference's blob in the port, single and batched
        blob = ref_kv.extract_page_payload(ref, page)
        got = deserialize_tree(blob, port_like)
        for k in ("k_pages", "v_pages"):
            assert torch.equal(got[k], port[k][:, page])
    blank = {k: torch.zeros_like(v) for k, v in port.items()}
    blobs = [ref_kv.extract_page_payload(ref, p) for p in (2, 7, 3)]
    port_kv.install_page_payloads(blank, [5, 1, 8], blobs)
    for k in ("k_pages", "v_pages"):
        assert torch.equal(blank[k][:, [5, 1, 8]], port[k][:, [2, 7, 3]])
        assert not blank[k][:, [0, 2, 3, 4, 6, 7]].any()
    assert not blank["conv"].any()


def test_batched_extraction_equals_per_page_extraction():
    _, _, port = _caches(seed=2)
    pages = [6, 1, 1, 8, 3]
    blobs = port_kv.extract_page_payloads(port, pages)
    assert blobs == [port_kv.extract_page_payload(port, p) for p in pages]
    assert port_kv.extract_page_payloads(port, []) == []
    with pytest.raises(ValueError, match="payloads"):
        port_kv.install_page_payloads(port, [1, 2], blobs[:1])
    wrong = port_kv.extract_page_payload(
        {k: v[:, :, :8] for k, v in port.items()}, 1)
    with pytest.raises(ValueError, match="k_pages"):
        port_kv.install_page_payloads(port, [1], [wrong])


# ---------------------------------------------------------------------------
# Engine scenarios (tests/test_spill.py:200-519), port against reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    cfg = REDUCED["qwen3-8b"]
    ref = ref_get_model(cfg)
    ref_params = ref.init(jax.random.key(0))
    port = get_model(get("qwen3-8b", reduced=True))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), port,
                                   device="cpu")
    return cfg, ref, ref_params, port, params


def _spill_setup(name: str, n_peers: int = 2):
    """A cloudlet of ``h0`` and ``n_peers`` peers, and ``h0``'s remote
    pool, from package ``name``."""
    pkg = PKGS[name]
    reg = pkg.cloudlet.CloudletRegistry()
    reg.create("serve", "qwen3-8b")
    reg.join("serve", "h0")
    rel = pkg.reliability.ReliabilityRegistry()
    for i in range(1, n_peers + 1):
        reg.join("serve", f"h{i}")
        rel.add_host(f"h{i}")
    return reg, pkg.kv.RemotePagePool(reg, "serve", "h0", reliability=rel)


class Side:
    """Engines of one package, on its own cloudlet. A port side may be
    teacher-forced on the tokens of a finished reference engine."""

    def __init__(self, qwen, name: str, force: RefEngine | None = None):
        self.qwen, self.name, self.force = qwen, name, force
        self.reg, self.remote = _spill_setup(name)

    def engine(self, spill: bool = True, sched: dict | None = None, **kw):
        _, ref, ref_params, port, params = self.qwen
        kw.setdefault("n_slots", 1)
        kw.setdefault("max_seq", 96)
        kw.setdefault("page_size", PAGE)
        kw.setdefault("prefill_chunk", 32)
        kw.setdefault("n_pages", 6)  # 5 usable: two 2-page prefixes can't both stay
        remote = self.remote if spill else None
        if self.name == "repro":
            return RefEngine(ref, ref_params, paged=True, remote_pool=remote,
                             scheduler=RefSched(**sched) if sched else None,
                             **kw)
        eng = ServeEngine(port, params, device="cpu", remote_pool=remote,
                          scheduler=SchedulerConfig(**sched) if sched
                          else None, **kw)
        if self.force is not None:
            _force_from(eng, self.force)
        return eng


def _prefixes(cfg, n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, 2 * PAGE).tolist()
            for _ in range(n)]


def _reqs(cfg, prefix, n, seed):
    rng = np.random.default_rng(seed)
    return [prefix + rng.integers(1, cfg.vocab_size, 6).tolist()
            for _ in range(n)]


def _run_phases(cfg, eng, prefixes, *, rounds=2, seed0=100):
    """Alternate prefixes across rounds (two requests each, 4 new tokens);
    returns the tokens in submission order."""
    out = []
    seed = seed0
    for _ in range(rounds):
        for pref in prefixes:
            seed += 1
            reqs = [eng.submit(p, max_new_tokens=4)
                    for p in _reqs(cfg, pref, 2, seed)]
            eng.run(400)
            out.extend(tuple(r.generated) for r in reqs)
    return out


def _held(ref: RefEngine, port: ServeEngine, ref_side: Side, port_side: Side,
          *, forced_ok: int) -> None:
    """The teacher-forced port engine against the reference: the same
    tokens, every counter equal, the same pools, stubs and leases."""
    assert {r: q.generated for r, q in port.requests.items()} == \
        {r: q.generated for r, q in ref.requests.items()}
    stats = dict(port.stats)
    assert stats.pop("forced_mismatches") <= forced_ok
    stats.pop("forced_tokens")
    want = {k: v for k, v in ref.stats.items()
            if k not in ("forced_mismatches", "forced_tokens")}
    assert stats == want
    assert port.pool.serialize() == ref.pool.serialize()
    assert port.spilled == {s: port_kv.SpilledPage(p.lease_id, p.peer)
                            for s, p in ref.spilled.items()}
    assert port_side.remote.stats == ref_side.remote.stats
    assert port_side.reg.to_state() == ref_side.reg.to_state()


def _scenario(qwen, play, *, forced_ok: int):
    """``play(side)`` on the reference, on the port teacher-forced by the
    reference's final engine, and on the port unforced. Returns the three
    results and the sides."""
    ref_side = Side(qwen, "repro")
    ref = play(ref_side)
    port_side = Side(qwen, "repro_torch", force=ref[0])
    port = play(port_side)
    _held(ref[0], port[0], ref_side, port_side, forced_ok=forced_ok)
    free_side = Side(qwen, "repro_torch")
    return ref, port, play(free_side), free_side


def _no_spill_tokens(qwen, prefixes, **kw) -> list:
    eng = Side(qwen, "repro_torch").engine(spill=False, **kw)
    return _run_phases(qwen[0], eng, prefixes)


def test_spill_recall_round_trip_parity(qwen):
    """Under page pressure cold prefix pages are lent, not evicted; a later
    hit recalls them: the no-spill engine's tokens, fewer prompt tokens
    recomputed. Against the reference, two greedy steps sit on near ties
    that the packages' bf16 roundings break differently (P1), held by
    teacher forcing."""
    cfg = qwen[0]
    prefixes = _prefixes(cfg, 2)

    def play(side):
        eng = side.engine()
        return eng, _run_phases(cfg, eng, prefixes)

    ref, port, (eng, out), side = _scenario(qwen, play, forced_ok=2)
    base = Side(qwen, "repro_torch").engine(spill=False)
    assert out == _run_phases(cfg, base, prefixes)
    assert eng.stats["pages_spilled"] > 0
    assert eng.stats["pages_recalled"] > 0
    assert eng.stats["recall_misses"] == 0
    assert eng.stats["prefix_evictions"] < base.stats["prefix_evictions"]
    assert eng.stats["prefill_tokens"] < base.stats["prefill_tokens"]
    assert eng.stats["recall_hold_steps"] > 0
    assert eng.pool.outstanding == 0
    assert side.remote.lent == len(eng.spilled)


def test_peer_leave_mid_recall_falls_back_to_recompute(qwen):
    """Every peer leaves while pages are lent out: the next hit misses,
    drops the stubs and recomputes, with the no-spill tokens."""
    cfg = qwen[0]
    prefixes = _prefixes(cfg, 2, seed=2)

    def play(side):
        eng = side.engine()
        out = _run_phases(cfg, eng, prefixes, rounds=1)
        assert eng.stats["pages_spilled"] > 0 and side.remote.lent > 0
        for h in ("h1", "h2"):
            side.reg.leave_all(h)
        assert len(side.reg.leases) == 0
        return eng, out + _run_phases(cfg, eng, prefixes, rounds=1,
                                      seed0=999)

    ref, port, (eng, out), side = _scenario(qwen, play, forced_ok=0)
    base = Side(qwen, "repro_torch").engine(spill=False)
    want = _run_phases(cfg, base, prefixes, rounds=1)
    assert out == want + _run_phases(cfg, base, prefixes, rounds=1,
                                     seed0=999)
    assert eng.stats["recall_misses"] > 0
    assert eng.stats["pages_recalled"] == 0
    assert len(eng.spilled) == 0
    assert eng.pool.outstanding == 0


def test_recall_budget_bounds_recalls_per_admission(qwen):
    cfg = qwen[0]
    prefixes = _prefixes(cfg, 2, seed=3)

    def play(side):
        eng = side.engine(recall_budget=1)
        return eng, _run_phases(cfg, eng, prefixes)

    ref, port, (eng, out), _ = _scenario(qwen, play, forced_ok=0)
    assert out == _no_spill_tokens(qwen, prefixes)
    assert 0 < eng.stats["pages_recalled"] <= eng.stats["prefix_hits"]


def test_spill_snapshot_restore_round_trips_leases(qwen):
    """Snapshot with pages lent out, restored on a fresh engine wired to
    the same cloudlet: the stubs revalidate, recalls work, the tokens are
    the no-spill engine's, and every page is freed exactly once."""
    cfg = qwen[0]
    prefixes = _prefixes(cfg, 2, seed=4)

    def play(side):
        eng = side.engine()
        out = _run_phases(cfg, eng, prefixes, rounds=1)
        assert eng.stats["pages_spilled"] > 0 and side.remote.lent > 0
        eng2 = side.engine()
        eng2.restore(eng.snapshot())
        assert eng2.spilled == eng.spilled
        return eng2, out + _run_phases(cfg, eng2, prefixes, rounds=1,
                                       seed0=100 + len(prefixes))

    ref, port, (eng, out), side = _scenario(qwen, play, forced_ok=0)
    assert out == _no_spill_tokens(qwen, prefixes)
    assert eng.stats["pages_recalled"] > 0
    assert eng.pool.outstanding == 0
    assert eng.pool.available == eng.n_pages - 1
    assert side.remote.lent == len(eng.spilled)


def test_restore_releases_descendant_leases_of_churned_ancestor(qwen):
    """A snapshot whose spilled chain spans two peers, restored after the
    ancestor's holder left: evicting the ancestor stub releases the
    descendant's still-valid lease too."""
    cfg = qwen[0]
    prefixes = _prefixes(cfg, 2, seed=6)

    def play(side):
        eng = side.engine(recall_budget=8)
        _run_phases(cfg, eng, prefixes, rounds=1)
        pairs = [(sid, eng.prefix_index._nodes[sid][0]) for sid in eng.spilled
                 if eng.prefix_index._nodes[sid][0] in eng.spilled]
        assert pairs, "the workload spills a parent and its child"
        child, parent = pairs[0]
        blob = eng.snapshot()
        side.reg.leave_all(eng.spilled[parent].peer)
        eng2 = side.engine()
        eng2.restore(blob)
        assert parent not in eng2.spilled and child not in eng2.spilled
        for sid in (parent, child):
            assert not side.reg.leases.valid(eng.spilled[sid].lease_id)
        assert side.remote.lent == len(eng2.spilled)
        return eng2, None

    _scenario(qwen, play, forced_ok=0)


def test_restore_without_remote_pool_drops_stubs_safely(qwen):
    """A snapshot holding spill stubs, restored on an engine with no spill
    tier, recomputes those prefixes: the no-spill tokens, nothing
    recalled. One near tie against the reference (P1), held by teacher
    forcing."""
    cfg = qwen[0]
    prefixes = _prefixes(cfg, 2, seed=5)

    def play(side):
        eng = side.engine()
        out = _run_phases(cfg, eng, prefixes, rounds=1)
        assert eng.stats["pages_spilled"] > 0
        eng2 = side.engine(spill=False)
        eng2.restore(eng.snapshot())
        assert len(eng2.spilled) == 0
        return eng2, out + _run_phases(cfg, eng2, prefixes, rounds=1,
                                       seed0=100 + len(prefixes))

    ref, port, (eng, out), _ = _scenario(qwen, play, forced_ok=1)
    assert out == _no_spill_tokens(qwen, prefixes)
    assert eng.stats["pages_recalled"] == 0
    assert eng.pool.outstanding == 0


def test_spill_tier_is_paged_only(qwen):
    _, remote = _spill_setup("repro_torch")
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(qwen[3], qwen[4], n_slots=2, max_seq=96, paged=False,
                    remote_pool=remote, device="cpu")
    eng = ServeEngine(qwen[3], qwen[4], n_slots=2, max_seq=96, page_size=16,
                      remote_pool=remote, write_behind=True, device="cpu")
    assert eng.spill and eng.write_behind


# ---------------------------------------------------------------------------
# Spill-backed preemption: recall resume, recall-miss fallback
# ---------------------------------------------------------------------------


TAIL = [5, 6, 7]
# 11 tokens: the victim's decode fills its third page before the preemption
LONG_TAIL = list(range(5, 16))


def _preempt(side, cfg, write_behind=False, tail=TAIL):
    """One slot, a low-priority victim mid-decode, a high-priority
    preemptor: the engine, victim and preemptor right after the preemption
    spilled the victim's chain."""
    eng = side.engine(n_slots=1, n_pages=12, write_behind=write_behind,
                      sched={"token_budget": 64, "preempt_margin": 2})
    prefix = _prefixes(cfg, 1, seed=9)[0]
    low = eng.submit(list(prefix) + tail, max_new_tokens=8, priority=0)
    for _ in range(6):
        eng.step()
    assert low.slot is not None and len(low.generated) >= 2
    high = eng.submit(list(prefix) + [9, 9], max_new_tokens=4, priority=3)
    for _ in range(2):
        eng.step()
    assert low.slot is None, "victim was not preempted"
    return eng, low, high


def _unharassed(qwen, tail=TAIL) -> tuple[list, list]:
    """The two streams served side by side by the port with no pool."""
    cfg = qwen[0]
    ref = Side(qwen, "repro_torch").engine(spill=False, n_slots=2,
                                           n_pages=12)
    prefix = _prefixes(cfg, 1, seed=9)[0]
    a = ref.submit(list(prefix) + tail, max_new_tokens=8)
    b = ref.submit(list(prefix) + [9, 9], max_new_tokens=4)
    ref.run(400)
    return a.generated, b.generated


@pytest.mark.parametrize("write_behind", [False, True])
def test_preemption_spills_and_resumes_via_recall(qwen, write_behind):
    """A preemption moves the victim's whole chain to peers; re-admission
    recalls it and resumes with no token re-prefilled, and the streams equal
    the unharassed two-slot run's. With write-behind on, the page the
    victim's decode filled was staged before the preemption and is not
    lent again."""
    cfg = qwen[0]
    tail = LONG_TAIL if write_behind else TAIL

    def play(side):
        eng, low, high = _preempt(side, cfg, write_behind, tail)
        assert eng.stats["preempt_spills"] == 1
        assert low.spill_len > 0 and low.resume
        assert side.remote.staged_pages(low.req_id)
        eng.run(400)
        assert low.done and high.done
        return eng, (low.generated, high.generated)

    ref, port, (eng, out), side = _scenario(qwen, play, forced_ok=0)
    assert out == _unharassed(qwen, tail)
    assert eng.stats["recall_resumes"] == 1
    assert eng.stats["resume_fallbacks"] == 0
    assert eng.stats["recall_resume_prefill_tokens"] == 0
    assert (eng.stats["pages_staged"] > 0) == write_behind
    assert eng.pool.outstanding == 0
    assert side.remote.lent == 0


def test_recall_miss_falls_back_to_reprefill_with_parity(qwen):
    cfg = qwen[0]

    def play(side):
        eng, low, high = _preempt(side, cfg)
        assert low.spill_len > 0
        for h in ("h1", "h2"):
            side.reg.leave_all(h)
        eng.run(400)
        assert low.done and high.done and low.spill_len == 0
        return eng, (low.generated, high.generated)

    ref, port, (eng, out), side = _scenario(qwen, play, forced_ok=0)
    assert out == _unharassed(qwen)
    assert eng.stats["recall_resumes"] == 0
    assert eng.stats["resume_fallbacks"] >= 1
    assert eng.pool.outstanding == 0
    assert side.remote.lent == 0


def test_preempt_spill_survives_snapshot_restore(qwen):
    cfg = qwen[0]

    def play(side):
        eng, low, high = _preempt(side, cfg)
        blob = eng.snapshot()
        eng2 = side.engine(n_slots=1, n_pages=12)
        eng2.restore(blob)
        low2, high2 = eng2.requests[low.req_id], eng2.requests[high.req_id]
        assert low2.spill_len == low.spill_len > 0
        assert side.remote.staged_pages(low.req_id)
        eng2.run(400)
        assert low2.done and high2.done
        return eng2, (low2.generated, high2.generated)

    ref, port, (eng, out), side = _scenario(qwen, play, forced_ok=0)
    assert out == _unharassed(qwen)
    assert eng.stats["recall_resumes"] >= 1
    assert eng.pool.outstanding == 0
    assert side.remote.lent == 0


# ---------------------------------------------------------------------------
# Snapshots with spilled state across packages, against one remote pool
# ---------------------------------------------------------------------------


def _record_lends(remote) -> dict:
    """Every payload ``remote`` is handed, by lease id."""
    lent: dict[int, bytes] = {}
    lend = remote.lend

    def spy(payload):
        lease = lend(payload)
        if lease is not None:
            lent[lease.lease_id] = payload
        return lease

    remote.lend = spy
    return lent


def _record_port_installs(monkeypatch, eng) -> list:
    """Each batch the port engine installs, checked right after the install
    against the cache: the pages hold the payloads' bytes."""
    seen = []
    install = port_kv.install_page_payloads

    def spy(cache, pages, blobs):
        install(cache, pages, blobs)
        assert port_kv.extract_page_payloads(cache, pages) == list(blobs)
        seen.extend(blobs)

    monkeypatch.setattr(port_engine, "install_page_payloads", spy)
    return seen


def _record_ref_installs(eng) -> list:
    """The same for the reference engine's per-page install."""
    seen = []
    install = eng._install_page

    def spy(cache, dst, vals):
        cache = install(cache, dst, vals)
        blob = ref_kv.extract_page_payload(cache, int(dst))
        assert all(np.array_equal(np.asarray(cache[k][:, int(dst)]),
                                  np.asarray(v)) for k, v in vals.items())
        seen.append(blob)
        return cache

    eng._install_page = spy
    return seen


@pytest.mark.parametrize("scenario", ["prefix", "preempt"])
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_spilled_snapshot_crosses_packages(qwen, monkeypatch, writer,
                                           scenario):
    """One package spills into a remote pool (prefix stubs, or a preempted
    slot's chain) and snapshots; the other package's engine restores the
    blob against the same pool object, recalls and finishes. Every page it
    installs holds bytes the writer lent, and the tokens are the
    reference's uninterrupted run's (the port, on either end, teacher-forced
    on them, P1)."""
    cfg = qwen[0]
    reader = "repro_torch" if writer == "repro" else "repro"
    prefixes = _prefixes(cfg, 2, seed=4)
    pool_kw = {} if scenario == "prefix" else {"n_slots": 1, "n_pages": 12}

    def force(name):
        return whole if name == "repro_torch" else None

    if scenario == "prefix":
        whole = Side(qwen, "repro").engine()
        _run_phases(cfg, whole, prefixes)
    else:
        whole = _preempt(Side(qwen, "repro"), cfg)[0]
        whole.run(400)
    side = Side(qwen, writer, force=force(writer))
    lent = _record_lends(side.remote)
    if scenario == "prefix":
        eng = side.engine()
        _run_phases(cfg, eng, prefixes, rounds=1)
        assert eng.stats["pages_spilled"] > 0
    else:
        eng, low, _ = _preempt(side, cfg)
        assert low.spill_len > 0
    blob = eng.snapshot()
    meta = json.loads(blob[4:4 + int.from_bytes(blob[:4], "little")])
    assert meta["spilled"] if scenario == "prefix" else meta["slot_spills"]
    read_side = Side(qwen, reader, force=force(reader))
    read_side.reg, read_side.remote = side.reg, side.remote
    eng2 = read_side.engine(**pool_kw)
    installed = (_record_port_installs(monkeypatch, eng2)
                 if reader == "repro_torch" else _record_ref_installs(eng2))
    eng2.restore(blob)
    if scenario == "prefix":
        _run_phases(cfg, eng2, prefixes, rounds=1, seed0=100 + len(prefixes))
        assert eng2.stats["pages_recalled"] > 0
    else:
        eng2.run(400)
        assert eng2.stats["recall_resumes"] == 1
    assert installed and all(b in lent.values() for b in installed)
    assert {r: q.generated for r, q in eng2.requests.items()} == \
        {r: q.generated for r, q in whole.requests.items()}
    for e in (eng, eng2):
        assert e.stats["forced_mismatches"] == 0
    assert eng2.pool.outstanding == 0
    assert side.remote.lent == len(eng2.spilled)


# ---------------------------------------------------------------------------
# Families with recurrent state accept a pool and never spill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_recurrent_families_accept_a_pool_and_never_spill(arch):
    model = get_model(get(arch, reduced=True))
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, model.cfg.vocab_size, 2 * PAGE).tolist()
    prompts = [prefix + rng.integers(1, model.cfg.vocab_size, 6).tolist()
               for _ in range(4)]
    outs = []
    for remote in (_spill_setup("repro_torch")[1], None):
        eng = ServeEngine(model, params, n_slots=1, max_seq=96, page_size=PAGE,
                          prefill_chunk=32, n_pages=6, remote_pool=remote,
                          write_behind=remote is not None, device="cpu")
        for p in prompts:
            eng.submit(p, max_new_tokens=4)
        eng.run(400)
        outs.append([r.generated for r in eng.requests.values()])
        assert not eng.spill and not eng.write_behind
        assert eng.stats["pages_spilled"] == eng.stats["pages_staged"] == 0
        assert eng.stats["prefix_hits"] > 0   # would-be hits, bookkeeping
    assert outs[0] == outs[1]
