"""The port's multimodal serving against the JAX package's: every engine
scenario of ``tests/test_paged_multimodal.py`` on REDUCED
``whisper-medium`` (enc-dec) and ``llava-next-mistral-7b`` (VLM), with the
reference's weights handed across by the bridge.

Each scenario runs on both packages' engines with the same requests and
the same configuration; the reference runs op by op (``jax.disable_jit``;
ROADMAP Queue 3, P1). Held:

- the tokens equal the reference's, and where the reference test holds
  them against an exact unpadded prefill plus decode, the port's equal the
  port's own exact run too;
- every ``stats`` counter equals the reference's (the cross-region
  counters among them), and every page is back (``pool.outstanding``);
- a spill lends the reference's pages under its lease ids, each payload
  one region's leaves, in the reference's bytes for its content, its
  values the reference's within the logits' tolerance (the encoder's f32
  reductions sum in XLA's order there);
- a snapshot after two steps restores across the packages both ways, for
  both families, and finishes with the uninterrupted tokens;
- ``submit`` refuses what the reference refuses, with its messages, and
  the CLI refuses the multimodal archs before building an engine.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REDUCED  # noqa: E402
from repro.core.cloudlet import CloudletRegistry as RefRegistry  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402
from repro.serving import kvcache as ref_kv  # noqa: E402
from repro.serving.kvcache import RemotePagePool as RefRemote  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.checkpoint.serializer import read_leaves  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core.cloudlet import CloudletRegistry  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.kvcache import (  # noqa: E402
    RemotePagePool,
    expand_prefill_cache,
    scatter_slot,
)

torch.set_num_threads(1)
VISION_D = 1024
MAX_SEQ = 96


def _family(arch):
    cfg = REDUCED[arch]
    jm = ref_get_model(cfg)
    jp = jm.init(jax.random.key(0))
    tm = get_model(get(arch, reduced=True))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return cfg, jm, jp, tm, tp


@pytest.fixture(scope="module")
def whisper():
    return _family("whisper-medium")


@pytest.fixture(scope="module")
def llava():
    return _family("llava-next-mistral-7b")


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, n).tolist()


def _frames(cfg, n, seed):
    return np.random.default_rng(seed).standard_normal(
        (1, n, cfg.d_model)).astype(np.float32)


def _embeds(cfg, seed):
    return np.random.default_rng(seed).standard_normal(
        (1, cfg.n_image_tokens, VISION_D)).astype(np.float32)


def _kw(fam: str, **kw) -> dict:
    """The reference test's engines: 2 slots, pages of 8, chunks of 16 (an
    enc-dec one with a 32-frame cross region)."""
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_chunk", 16)
    if fam == "encdec":
        kw.setdefault("max_cross_seq", 32)
    kw.setdefault("n_slots", 2)
    return dict(paged=True, **kw)


def _both(fam, rounds, *, steps=400, **kw):
    """``rounds`` (each a list of (prompt, max_new, extra), submitted and
    then run) on the reference engine, op by op, and on the port's, built
    with the same keywords (``remote`` builds each side's own remote pool).
    Returns both engines and their requests in submission order."""
    _, jm, jp, tm, tp = fam
    make_remote = kw.pop("remote", None)
    ref = RefEngine(jm, jp, **kw,
                    **({"remote_pool": make_remote(True)} if make_remote
                       else {}))
    port = ServeEngine(tm, tp, device="cpu", **kw,
                       **({"remote_pool": make_remote(False)} if make_remote
                          else {}))
    out = {}
    for name, eng in (("ref", ref), ("port", port)):
        reqs = []
        for subs in rounds:
            reqs += [eng.submit(p, max_new_tokens=n, extra=e)
                     for p, n, e in subs]
            if name == "ref":
                with jax.disable_jit():
                    eng.run(steps)
            else:
                eng.run(steps)
        out[name] = reqs
    return ref, port, out["ref"], out["port"]


def _check(ref, port, rreqs, preqs):
    assert all(r.done for r in preqs)
    assert [r.generated for r in preqs] == [r.generated for r in rreqs]
    assert port.stats == ref.stats
    if port.paged:
        assert port.pool.outstanding == 0 == ref.pool.outstanding


def _exact(fam, prompt, extra, n_new):
    """The port's greedy continuation from an exact (unpadded) prefill
    and dense decode, as ``tests/test_paged_multimodal.py:_exact``."""
    _, _, _, tm, tp = fam
    batch = {"tokens": torch.tensor([prompt], dtype=torch.int32)}
    mm = 0
    for k, v in extra.items():
        batch[k] = torch.from_numpy(np.asarray(v))
        if k == "embeds":
            mm = int(np.asarray(v).shape[-2])
    logits, pc = tm.prefill(tp, batch)
    out = [int(logits[0].argmax())]
    cache = tm.init_cache(1, MAX_SEQ, device="cpu")
    scatter_slot(cache, expand_prefill_cache(pc, cache), 0)
    pos = mm + len(prompt)
    for _ in range(n_new - 1):
        lg = tm.decode_step(tp, cache, {
            "tokens": torch.tensor([[out[-1]]], dtype=torch.int32),
            "positions": torch.tensor([pos], dtype=torch.int32)})
        out.append(int(lg[0].argmax()))
        pos += 1
    return out


# ---------------------------------------------------------------------------
# Enc-dec
# ---------------------------------------------------------------------------


def test_encdec_paged_matches_exact(whisper):
    """Prompt lengths across page and chunk boundaries, frame counts with a
    partial last cross page; all four submitted at once on two slots."""
    cfg = whisper[0]
    cases = [(8, 12), (16, 8), (5, 11), (21, 16)]
    subs = [(_tokens(cfg, plen, seed=i), 4,
             {"frames": _frames(cfg, nf, seed=100 + i)})
            for i, (plen, nf) in enumerate(cases)]
    ref, port, rr, pr = _both(whisper, [subs], **_kw("encdec"))
    _check(ref, port, rr, pr)
    for r in pr:
        assert r.generated == _exact(whisper, r.prompt, r.extra, 4)
    assert port.stats["cross_regions_computed"] == 4


def test_encdec_paged_matches_dense_where_bucketing_exact(whisper):
    """Prompts of the dense bucket's length: the port's paged and dense
    engines agree token for token, and each equals the reference's engine
    of its mode."""
    cfg = whisper[0]
    f = _frames(cfg, 12, seed=5)
    subs = [(_tokens(cfg, 32, seed=s), 5, {"frames": f}) for s in (20, 21)]
    dense = _both(whisper, [subs], n_slots=2, max_seq=MAX_SEQ, paged=False)
    paged = _both(whisper, [subs], **_kw("encdec"))
    _check(*dense)
    _check(*paged)
    assert [r.generated for r in paged[3]] == [r.generated for r in dense[3]]
    # the dense cache keeps each slot's true encoder length
    assert dense[1].cache["enc_len"].dtype == torch.int32


def test_encdec_cross_region_shared(whisper):
    """Three requests with the same frames, one after another: the encoder
    runs once and the region is shared twice."""
    cfg = whisper[0]
    f = _frames(cfg, 16, seed=6)
    rounds = [[(_tokens(cfg, 9, seed=s), 3, {"frames": f})]
              for s in (30, 31, 32)]
    ref, port, rr, pr = _both(whisper, rounds, steps=200, **_kw("encdec"))
    _check(ref, port, rr, pr)
    assert port.stats["cross_regions_computed"] == 1
    assert port.stats["cross_regions_shared"] == 2
    assert port.stats["cross_pages_shared"] == 4
    for r in pr:
        assert r.generated == _exact(whisper, r.prompt, r.extra, 3)


def test_encdec_no_false_share_across_frames(whisper):
    """The same decoder prompt under other frames shares neither its
    pages (salted keys) nor the other input's region."""
    cfg = whisper[0]
    p = _tokens(cfg, 16, seed=40)
    rounds = [[(p, 3, {"frames": _frames(cfg, 12, seed=s)})]
              for s in (41, 42)]
    ref, port, rr, pr = _both(whisper, rounds, steps=100, **_kw("encdec"))
    _check(ref, port, rr, pr)
    assert port.stats["prefill_tokens_shared"] == 0
    assert port.stats["cross_regions_shared"] == 0
    assert port.stats["cross_regions_computed"] == 2


def test_encdec_no_share_on_prefix_frames(whisper):
    """Frames that are exactly the first page of a longer cached input do
    not hit its region (every cross key carries the whole frames'
    digest)."""
    cfg = whisper[0]
    p = _tokens(cfg, 9, seed=45)
    fa = _frames(cfg, 16, seed=46)
    rounds = [[(p, 3, {"frames": fa})], [(p, 3, {"frames": fa[:, :8]})]]
    ref, port, rr, pr = _both(whisper, rounds, steps=100, **_kw("encdec"))
    _check(ref, port, rr, pr)
    assert port.stats["cross_regions_shared"] == 0
    assert port.stats["cross_regions_computed"] == 2
    assert port.stats["prefill_tokens_shared"] == 0


def _remote(ref: bool):
    registry = (RefRegistry if ref else CloudletRegistry)()
    registry.create("serve", "whisper-medium")
    for h in ("h0", "h1"):
        registry.join("serve", h)
    pool = (RefRemote if ref else RemotePagePool)
    return pool(registry, "serve", "h0", peer_capacity_pages=32)


def _payload_keys(blob: bytes) -> set:
    hlen = int(np.frombuffer(blob[:4], "<u4")[0])
    return {e["key"] for e in json.loads(blob[4:4 + hlen].decode())}


def test_encoder_page_spill_recall_roundtrip(whisper):
    """A 10-page pool cannot keep five regions: cold pages are lent to a
    peer, each payload one region's leaves, under the reference's lease
    ids, the encoder pages byte for byte the reference's; the first frames
    again recall their region, with the first run's tokens."""
    cfg = whisper[0]
    p = _tokens(cfg, 8, seed=50)
    frames = [_frames(cfg, 16, seed=60 + i) for i in range(5)]
    rounds = [[(p, 4, {"frames": f})] for f in frames]
    kw = _kw("encdec", n_pages=11, remote=_remote)
    ref, port, rr, pr = _both(whisper, rounds, steps=200, **kw)
    _check(ref, port, rr, pr)
    lent, want = port.remote_pool._store, ref.remote_pool._store
    assert lent.keys() == want.keys()
    cross = {"cross_k_pages", "cross_v_pages"}
    n_cross = 0
    for lid, blob in lent.items():
        keys = _payload_keys(blob)
        assert keys == _payload_keys(want[lid])
        assert keys in (cross, {"self_k_pages", "self_v_pages"})
        n_cross += keys == cross
        # the reference's payload of the port's page, byte for byte; its
        # values the reference's own page's within the logits' tolerance
        # (XLA sums the encoder's f32 reductions in another order)
        got = {k: arr for k, (_, arr) in read_leaves(blob).items()}
        page = {k: jnp.asarray(a.view(jnp.bfloat16)[:, None])
                for k, a in got.items()}
        assert ref_kv.extract_page_payload(page, 0) == blob
        for k, (_, arr) in read_leaves(want[lid]).items():
            np.testing.assert_allclose(
                got[k].view(jnp.bfloat16).astype(np.float32),
                arr.view(jnp.bfloat16).astype(np.float32),
                atol=5e-2, rtol=2e-2, err_msg=f"lease {lid} {k}")
    assert n_cross >= 4
    # the same frames again: the region recalled, the first run's tokens
    r = port.submit(p, max_new_tokens=4, extra={"frames": frames[0]})
    want_r = ref.submit(p, max_new_tokens=4, extra={"frames": frames[0]})
    port.run(200)
    with jax.disable_jit():
        ref.run(200)
    assert port.stats["pages_recalled"] > 0
    assert port.stats == ref.stats
    assert r.generated == want_r.generated == pr[0].generated
    assert port.pool.outstanding == 0


# ---------------------------------------------------------------------------
# VLM
# ---------------------------------------------------------------------------


def test_vlm_paged_matches_exact(llava):
    cfg = llava[0]
    subs = [(_tokens(cfg, plen, seed=i), 4,
             {"embeds": _embeds(cfg, seed=200 + i)})
            for i, plen in enumerate((8, 24, 5))]
    ref, port, rr, pr = _both(llava, [subs], **_kw("vlm"))
    _check(ref, port, rr, pr)
    for r in pr:
        assert r.generated == _exact(llava, r.prompt, r.extra, 4)


def test_vlm_prefix_share_hit_on_shared_image_and_text(llava):
    """The same image and a shared 16-token text prefix: the second
    admission shares the image rows and the page-aligned text."""
    cfg = llava[0]
    img = _embeds(cfg, seed=70)
    prefix = _tokens(cfg, 16, seed=71)
    rounds = [[(prefix + _tokens(cfg, 8, seed=s), 3, {"embeds": img})]
              for s in (72, 73)]
    ref, port, rr, pr = _both(llava, rounds, steps=100, **_kw("vlm"))
    _check(ref, port, rr, pr)
    assert port.stats["prefill_tokens_shared"] >= cfg.n_image_tokens + 16
    assert port.stats["prefix_hits"] >= 1


def test_vlm_no_share_across_different_images(llava):
    cfg = llava[0]
    p = _tokens(cfg, 24, seed=80)
    rounds = [[(p, 2, {"embeds": _embeds(cfg, seed=s)})] for s in (81, 82)]
    ref, port, rr, pr = _both(llava, rounds, steps=100, **_kw("vlm"))
    _check(ref, port, rr, pr)
    assert port.stats["prefill_tokens_shared"] == 0


def test_vlm_dense_engine_matches_the_reference(llava):
    """The dense engine admits the image rows ahead of the text bucket."""
    cfg = llava[0]
    subs = [(_tokens(cfg, n, seed=n), 4, {"embeds": _embeds(cfg, seed=n)})
            for n in (32, 20)]
    _check(*_both(llava, [subs], n_slots=2, max_seq=MAX_SEQ, paged=False))


# ---------------------------------------------------------------------------
# Snapshots across packages, submit's validation
# ---------------------------------------------------------------------------


def _extra(fam_name, cfg, i):
    if fam_name == "encdec":
        return {"frames": _frames(cfg, 12, seed=90 + i)}
    return {"embeds": _embeds(cfg, seed=90 + i)}


@pytest.fixture(scope="module", params=["encdec", "vlm"])
def crossing(request, whisper, llava):
    """Each package's uninterrupted run of three requests, and each
    package's snapshot after two steps (the reference op by op)."""
    name = request.param
    fam = whisper if name == "encdec" else llava
    cfg, jm, jp, tm, tp = fam
    subs = [(_tokens(cfg, n, seed=i), 6, _extra(name, cfg, i))
            for i, n in enumerate((8, 20, 6))]
    makers = {"ref": lambda: RefEngine(jm, jp, **_kw(name)),
              "port": lambda: ServeEngine(tm, tp, device="cpu",
                                          **_kw(name))}
    out = {"makers": makers}
    with jax.disable_jit():
        for side, make in makers.items():
            whole = make()
            for p, n, e in subs:
                whole.submit(p, max_new_tokens=n, extra=e)
            whole.run(400)
            out[side + "_tokens"] = [r.generated for r in sorted(
                whole.requests.values(), key=lambda r: r.req_id)]
            cut = make()
            for p, n, e in subs:
                cut.submit(p, max_new_tokens=n, extra=e)
            for _ in range(2):
                cut.step()
            out[side + "_blob"] = cut.snapshot()
    assert out["ref_tokens"] == out["port_tokens"]
    return out


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref",
                                       "port_to_port"])
def test_multimodal_snapshot_restores_across_packages(crossing, direction):
    src, dst = direction.split("_to_")
    eng = crossing["makers"][dst]()
    eng.restore(crossing[src + "_blob"])
    with jax.disable_jit():
        eng.run(400)
    assert all(r.done for r in eng.requests.values())
    assert eng.pool.outstanding == 0
    assert [r.generated for r in sorted(eng.requests.values(),
                                        key=lambda r: r.req_id)] == \
        crossing[src + "_tokens"]


def test_submit_validation(whisper, llava):
    wcfg, _, _, wm, wp = whisper
    vcfg, _, _, vm, vp = llava
    enc = ServeEngine(wm, wp, device="cpu", **_kw("encdec"))
    with pytest.raises(ValueError, match="frames"):
        enc.submit(_tokens(wcfg, 4, seed=1), max_new_tokens=2)
    with pytest.raises(ValueError, match="max_cross_seq"):
        enc.submit(_tokens(wcfg, 4, seed=1), max_new_tokens=2,
                   extra={"frames": _frames(wcfg, 40, seed=1)})
    with pytest.raises(ValueError, match="unsupported modality"):
        enc.submit(_tokens(wcfg, 4, seed=1), max_new_tokens=2,
                   extra={"frames": _frames(wcfg, 8, seed=1), "embeds": 1})
    vlm = ServeEngine(vm, vp, device="cpu", **_kw("vlm"))
    with pytest.raises(ValueError, match="embeds"):
        vlm.submit(_tokens(vcfg, 4, seed=1), max_new_tokens=2)
    with pytest.raises(ValueError, match="modality positions"):
        vlm.submit(_tokens(vcfg, MAX_SEQ - 4, seed=1), max_new_tokens=2,
                   extra={"embeds": _embeds(vcfg, seed=1)})
    # text-only paged families still refuse modality extras outright
    qm = get_model(get("qwen3-8b", reduced=True))
    qeng = ServeEngine(qm, qm.init(0, device="cpu"), n_slots=1, max_seq=32,
                       paged=True, page_size=8, device="cpu")
    with pytest.raises(ValueError, match="unsupported modality"):
        qeng.submit([1, 2, 3], max_new_tokens=2, extra={"embeds": np.ones(3)})


@pytest.mark.parametrize("arch,key", [("whisper-medium", "frames"),
                                      ("llava-next-mistral-7b", "embeds")])
def test_cli_refuses_multimodal_archs(arch, key, monkeypatch):
    """``repro_torch.launch.serve`` refuses a multimodal arch before it
    builds a model or an engine, naming the ``extra`` that serves it."""
    from repro_torch.launch import serve
    from repro_torch.serving import engine

    def boom(*a, **k):
        raise AssertionError("an engine was built")

    monkeypatch.setattr(engine, "ServeEngine", boom)
    with pytest.raises(SystemExit, match=f"extra=.*'{key}'"):
        serve.main(["--arch", arch, "--device", "cpu"])


def test_forked_encdec_children_read_the_parents_region(whisper):
    """A greedy child forked off a live enc-dec slot shares its parent's
    encoder region (one more reference), so it continues with the
    parent's tokens; every page comes back. The reference engine leaves a
    child's cross table empty (ROADMAP Queue 3, R6), so this holds the
    port alone."""
    cfg, _, _, tm, tp = whisper
    eng = ServeEngine(tm, tp, device="cpu", **_kw("encdec", n_slots=3))
    parent = eng.submit(_tokens(cfg, 12, seed=7), max_new_tokens=8,
                        extra={"frames": _frames(cfg, 20, seed=8)})
    while len(parent.generated) < 3:
        eng.step()
    region = list(eng.slot_cross_pages[parent.slot])
    kids = eng.fork(parent.req_id, 2, temperature=0.0)
    assert all(eng.pool.refcount(p) == 3 for p in region)
    assert all(eng.slot_cross_pages[k.slot] == region for k in kids)
    eng.run(200)
    assert [k.generated for k in kids] == [parent.generated] * 2
    assert eng.pool.outstanding == 0
