"""Serving on the ad hoc cloud with the PyTorch port: batched inference
guests survive a host failure mid-generation and resume on a substitute
host with identical outputs (greedy decoding + snapshot continuity);
``examples/adhoc_serving.py`` through ``repro_torch``.

Two guests run the same failure drill, at their REDUCED widths:

- a text LLM (qwen3, paged KV cache + chunked prefill), and
- a VLM (llava) with a mixed image+text request set: a shared image and a
  shared system prompt are COW-shared across requests, and the whole
  engine state (page pool, tables, prefix trie) travels in one snapshot
  blob.

Runs on ``cuda`` (the hand-written kernels) unless ``--device cpu`` is
given (their plain versions).

    PYTHONPATH=src python examples/torch_adhoc_serving.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.configs import REDUCED
from repro_torch.models import get_model
from repro_torch.models.transformer import VISION_D
from repro_torch.serving.engine import ServeEngine

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda",
                help="cuda (default; raises without a card) or cpu")
DEVICE = ap.parse_args().device


def failure_drill(name, model, params, submits, **engine_kw):
    """Run reference vs interrupted-and-restored engines; assert parity."""
    engine_kw.setdefault("n_slots", 3)
    engine_kw.setdefault("max_seq", 128)
    engine_kw["device"] = DEVICE
    ref = ServeEngine(model, params, **engine_kw)
    for args, kw in submits:
        ref.submit(*args, **kw)
    ref_done = sorted(ref.run(), key=lambda r: r.req_id)
    print(f"[{name}] reference host served {len(ref_done)} requests")

    engine = ServeEngine(model, params, **engine_kw)
    for args, kw in submits:
        engine.submit(*args, **kw)
    for _ in range(4):
        engine.step()
    print(f"[{name}] host failure! latest P2P snapshot restored on a peer "
          "(paper §III-D)...")
    snapshot = engine.snapshot()      # this is what peers already hold

    substitute = ServeEngine(model, params, **engine_kw)
    substitute.restore(snapshot)
    done = sorted(substitute.run(), key=lambda r: r.req_id)

    match = len(done) == len(ref_done) and all(
        a.generated == b.generated for a, b in zip(ref_done, done))
    for r in done[:3]:
        print(f"  req {r.req_id}: {r.prompt[:3]}... -> {r.generated}")
    print(f"[{name}] all {len(done)} continuations identical to the "
          f"failure-free host: {match}\n")
    assert match
    return substitute


# --- text guest: qwen3 through the paged engine ---------------------------
cfg = REDUCED["qwen3-8b"]
model = get_model(cfg)
params = model.init(0, device=DEVICE)
rng = np.random.default_rng(0)
text_submits = [
    ((rng.integers(1, cfg.vocab_size, 8).tolist(),),
     dict(max_new_tokens=10))
    for _ in range(6)
]
failure_drill("text", model, params, text_submits)

# --- vlm guest: llava with a mixed image+text request set ------------------
vcfg = REDUCED["llava-next-mistral-7b"]
vmodel = get_model(vcfg)
vparams = vmodel.init(1, device=DEVICE)
images = [
    rng.standard_normal((1, vcfg.n_image_tokens, VISION_D)).astype(np.float32)
    for _ in range(2)
]
system_prompt = rng.integers(1, vcfg.vocab_size, 24).tolist()
vlm_submits = []
for i in range(6):
    img = images[i % 2]               # two distinct images across the mix
    prompt = system_prompt + rng.integers(1, vcfg.vocab_size, 6).tolist()
    vlm_submits.append(((prompt,),
                        dict(max_new_tokens=8, extra={"embeds": img})))
# page_size 16: the shared image (8 rows) + system prompt spans full
# pages, so the COW prefix sharing is visible in the stats below
substitute = failure_drill("vlm", vmodel, vparams, vlm_submits,
                           page_size=16)
s = substitute.stats
print(f"[vlm] prefix sharing across the mix: "
      f"{s['prefill_tokens_shared']} prompt tokens served from shared "
      f"pages ({s['prefix_hits']} hits, {s['cow_copies']} COW copies)")
