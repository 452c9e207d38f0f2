"""Engine snapshots of the port: the blob format, restores across packages,
and the serve CLI's ``--fail-after`` continuity path (paper §III-D).

The serializer writes the JAX package's format (``repro/checkpoint/
serializer.py``) byte for byte. A snapshot crosses packages both ways, in
both modes: a blob written by the reference's engine, restored into the
port's, finishes as the reference finishes; a blob written by the port,
restored into the reference's, is accepted and finishes as the port does.
Both engines run REDUCED qwen3-8b on the same weights (the reference's
``ModelFns.init(jax.random.key(0))``, through the bridge), the reference op
by op (``jax.disable_jit``; jitted, XLA's excess precision flips a near tie
of this model's first dense prefill: ROADMAP Queue 3, P1). Then the port's
own restore: token for token in both modes, with the prefix trie and
shared refcounts surviving (``tests/test_paged.py:227-252``,
``tests/test_prefix_share.py:328``), and a paged/dense mismatch refused.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import serializer as jser  # noqa: E402
from repro.configs import REDUCED  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.checkpoint.serializer import (  # noqa: E402
    deserialize_tree,
    serialize_tree,
)
from repro_torch.configs import get  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

torch.set_num_threads(1)
MODES = {"paged": dict(paged=True, page_size=16, prefill_chunk=32),
         "dense": dict(paged=False)}


# ---------------------------------------------------------------------------
# The blob format
# ---------------------------------------------------------------------------


def _tree(rng):
    bf = rng.standard_normal((3, 4, 5)).astype(np.float32)
    return {
        "cache": {"v_pages": bf, "k": rng.standard_normal((2, 7)).astype(
            np.float32), "conv": bf[0]},
        "lengths": rng.integers(0, 99, 6).astype(np.int32),
        "steps": np.asarray(41, np.int64),
    }


def test_serializer_round_trip_is_bitwise_and_matches_the_reference():
    """f32, bf16 and int leaves, a 0-d leaf and nested dicts round-trip
    bit for bit; the port's blob is byte for byte the reference's for the
    same values, and each package reads the other's."""
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    port = {"cache": {"v_pages": torch.from_numpy(tree["cache"]["v_pages"]
                                                  ).bfloat16(),
                      "k": torch.from_numpy(tree["cache"]["k"]),
                      "conv": torch.from_numpy(tree["cache"]["conv"]
                                               ).bfloat16()},
            "lengths": tree["lengths"], "steps": tree["steps"]}
    blob = serialize_tree(port)
    back = deserialize_tree(blob, port)
    for name in ("v_pages", "k", "conv"):
        got, want = back["cache"][name], port["cache"][name]
        assert got.dtype == want.dtype
        assert torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16
                           else got, want.view(torch.int16)
                           if want.dtype == torch.bfloat16 else want)
    assert np.array_equal(back["lengths"], tree["lengths"])
    assert back["lengths"].dtype == np.int32
    assert back["steps"].shape == () and int(back["steps"]) == 41

    jtree = {"cache": {"v_pages": jnp.asarray(tree["cache"]["v_pages"],
                                              jnp.bfloat16),
                       "k": jnp.asarray(tree["cache"]["k"]),
                       "conv": jnp.asarray(tree["cache"]["conv"],
                                           jnp.bfloat16)},
             "lengths": tree["lengths"], "steps": tree["steps"]}
    assert jser.serialize_tree(jtree) == blob
    from_ref = jser.deserialize_tree(blob, jtree)
    assert np.array_equal(np.asarray(from_ref["cache"]["v_pages"]).view(
        np.int16), port["cache"]["v_pages"].view(torch.int16).numpy())
    assert deserialize_tree(jser.serialize_tree(jtree), port)[
        "cache"]["k"].equal(port["cache"]["k"])


def test_deserialize_rejects_a_shape_mismatch():
    t = {"a": torch.zeros(2, 3)}
    with pytest.raises(ValueError, match="shape"):
        deserialize_tree(serialize_tree(t), {"a": torch.zeros(3, 2)})


# ---------------------------------------------------------------------------
# Restores across packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen():
    cfg = REDUCED["qwen3-8b"]
    jm = ref_get_model(cfg)
    jp = jm.init(jax.random.key(0))
    tm = get_model(get("qwen3-8b", reduced=True))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return cfg, jm, jp, tm, tp


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]


def _ref_engine(qwen, mode):
    _, jm, jp, _, _ = qwen
    eng = RefEngine(jm, jp, n_slots=2, max_seq=96, **MODES[mode])
    # op by op (P1)
    eng._prefill, eng._decode = jm.prefill, jm.decode_step
    eng._prefill_chunk, eng._decode_paged = jm.prefill_chunk, jm.decode_paged
    return eng


def _port_engine(qwen, mode, **kw):
    return ServeEngine(qwen[3], qwen[4], n_slots=2, max_seq=96,
                       device="cpu", **MODES[mode], **kw)


def _submit(eng, prompts, n=8):
    for p in prompts:
        eng.submit(p, max_new_tokens=n)


def _tokens(eng) -> list:
    return [r.generated for r in sorted(eng.requests.values(),
                                        key=lambda r: r.req_id)]


@pytest.fixture(scope="module", params=list(MODES))
def crossing(request, qwen):
    """Per mode: each package's uninterrupted run, and each package's blob
    after 3 steps of the same workload."""
    mode = request.param
    prompts = _prompts(qwen[0], [8, 24, 40, 12], seed=7)
    out = {"mode": mode}
    with jax.disable_jit():
        for side, make in (("ref", _ref_engine), ("port", _port_engine)):
            whole = make(qwen, mode)
            _submit(whole, prompts)
            whole.run(400)
            out[side + "_tokens"] = _tokens(whole)
            cut = make(qwen, mode)
            _submit(cut, prompts)
            for _ in range(3):
                cut.step()
            out[side + "_blob"] = cut.snapshot()
    assert out["ref_tokens"] == out["port_tokens"]
    return out


def test_reference_blob_restores_into_the_port(crossing, qwen):
    port = _port_engine(qwen, crossing["mode"])
    port.restore(crossing["ref_blob"])
    port.run(400)
    assert all(r.done for r in port.requests.values())
    assert _tokens(port) == crossing["ref_tokens"]


def test_port_blob_restores_into_the_reference(crossing, qwen):
    ref = _ref_engine(qwen, crossing["mode"])
    ref.restore(crossing["port_blob"])
    with jax.disable_jit():
        ref.run(400)
    assert all(r.done for r in ref.requests.values())
    assert _tokens(ref) == crossing["port_tokens"]
    if crossing["mode"] == "paged":
        assert ref.pool.outstanding == 0
        assert np.all(ref.page_table == 0)


def test_reference_blob_with_spilled_state_falls_back(crossing, qwen):
    """An engine without a remote pool. Paged: a reference blob's spilled
    trie stub is evicted with its subtree (its prefix is recomputed), and a
    request whose chain was spilled falls back to re-prefill, as the
    reference's restore does without a remote pool
    (``engine.py:2219-2227,2272-2287``) — the same trie and the same
    ``stats`` as the reference's own restore of the blob (whose stats merge
    overwrites the eviction count). Dense: neither engine reads spill
    state."""
    import json

    mode = crossing["mode"]
    blob = crossing["ref_blob"]
    mlen = int.from_bytes(blob[:4], "little")
    meta = json.loads(blob[4:4 + mlen])
    stub = 10_000
    if mode == "paged":
        trie = meta["prefix_trie"]
        assert trie, "the workload registers prompt pages"
        trie.append([stub, trie[0][0], [7] * 16])   # a spilled child page
    meta["spilled"] = {str(stub): [5, "peer-a"]}
    meta["slot_spills"] = {"3": {"0": [6, "peer-a"]}}
    meta["requests"]["3"]["spill_len"] = 16
    mb = json.dumps(meta).encode()
    blob = len(mb).to_bytes(4, "little") + mb + blob[4 + mlen:]
    port = _port_engine(qwen, mode)
    port.restore(blob)
    ref = _ref_engine(qwen, mode)
    ref.restore(blob)
    assert port.stats == ref.stats
    if mode == "paged":
        assert stub not in port.prefix_index._nodes
        assert port.prefix_index.serialize() == ref.prefix_index.serialize()
        assert port.stats["resume_fallbacks"] == \
            meta["stats"]["resume_fallbacks"] + 1
    else:
        assert port.stats == meta["stats"]
    port.run(400)
    assert _tokens(port) == crossing["ref_tokens"]


# ---------------------------------------------------------------------------
# The port's own restore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_snapshot_restore_resumes_identically(qwen, mode):
    """``tests/test_serving.py:44`` and ``tests/test_paged.py:227``: a
    snapshot after 3 steps, restored on a fresh engine, gives the
    uninterrupted run's tokens; the restored pool drains fully."""
    prompts = _prompts(qwen[0], [8, 24, 40, 12], seed=7)
    whole = _port_engine(qwen, mode)
    _submit(whole, prompts)
    whole.run(400)
    eng = _port_engine(qwen, mode)
    _submit(eng, prompts)
    for _ in range(3):
        eng.step()
    eng2 = _port_engine(qwen, mode)
    eng2.restore(eng.snapshot())
    assert eng2.stats == eng.stats and eng2.steps == eng.steps
    eng2.run(400)
    assert _tokens(eng2) == _tokens(whole)
    if mode == "paged":
        assert eng2.pool.outstanding == 0
        assert np.all(eng2.page_table == 0)


def test_snapshot_restores_shared_refcounts_and_trie(qwen):
    """``tests/test_prefix_share.py:328``: a snapshot with shared pages in
    flight keeps their refcounts and the trie, replays identically, and
    releasing everything returns every page exactly once."""
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, qwen[0].vocab_size, 32).tolist()
    prompts = [prefix + rng.integers(1, qwen[0].vocab_size, n).tolist()
               for n in (4, 6, 9, 5)]
    whole = _port_engine(qwen, "paged")
    _submit(whole, prompts)
    whole.run(400)
    eng = _port_engine(qwen, "paged")
    _submit(eng, prompts)
    for _ in range(3):
        eng.step()
    assert any(r > 1 for r in eng.pool._ref.values())   # sharing in flight
    ref_before = dict(eng.pool._ref)
    eng2 = _port_engine(qwen, "paged")
    eng2.restore(eng.snapshot())
    assert eng2.pool._ref == ref_before
    assert len(eng2.prefix_index) == len(eng.prefix_index)
    eng2.run(400)
    assert _tokens(eng2) == _tokens(whole)
    assert eng2.pool.outstanding == 0
    assert eng2.pool.available == eng2.n_pages - 1


def test_snapshot_drains_inflight_prefills(qwen):
    """Under continuous batching a snapshot taken while a chunked prefill
    is in flight drains it first; the restored engine still finishes with
    the uninterrupted tokens."""
    prompts = _prompts(qwen[0], [70, 12], seed=8)
    sched = SchedulerConfig(token_budget=40)   # one chunk of 32 per step
    whole = _port_engine(qwen, "paged", scheduler=sched)
    _submit(whole, prompts, n=5)
    whole.run(400)
    eng = _port_engine(qwen, "paged", scheduler=sched)
    _submit(eng, prompts, n=5)
    eng.step()
    assert eng.prefilling
    blob = eng.snapshot()
    assert not eng.prefilling
    eng2 = _port_engine(qwen, "paged", scheduler=sched)
    eng2.restore(blob)
    eng2.run(400)
    assert _tokens(eng2) == _tokens(whole)


def test_paged_dense_snapshot_mode_mismatch_rejected(qwen):
    """``tests/test_paged.py:254-262``, both ways round."""
    for src, dst in (("paged", "dense"), ("dense", "paged")):
        blob = _port_engine(qwen, src).snapshot()
        with pytest.raises(AssertionError, match="mode mismatch"):
            _port_engine(qwen, dst).restore(blob)


def test_cli_fail_after_resumes_identically():
    """``python -m repro_torch.launch.serve --fail-after 3`` completes every
    request with the uninterrupted run's output."""
    args = ["--arch", "qwen3-8b", "--device", "cpu", "--requests", "6"]
    whole = serve.main(args)
    failed = serve.main(args + ["--fail-after", "3"])
    assert len(failed) == len(whole) == 6
    assert [r.generated for r in sorted(failed, key=lambda r: r.req_id)] == \
        [r.generated for r in sorted(whole, key=lambda r: r.req_id)]
