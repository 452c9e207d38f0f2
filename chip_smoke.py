"""Smoke run of the PyTorch port on one NVIDIA H100.

Usage (from the root of a checkout, on a machine with the card):

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. device: prints the card's name and power limit (``nvidia-smi``);
2. build: compiles every kernel of the serving path from ``src/repro_torch``
   (one ``nvcc`` per CUDA source, all started together, plus the Triton
   kernel's first compile) and prints the seconds;
3. kernels: holds each hand-written kernel against its plain PyTorch
   version at the main path's shapes (bf16, atol = rtol = 2e-2) and times
   kernel, plain version and, where one PyTorch call computes the same
   function, that call (``library_ms``, a yardstick only);
4. serve: full-width, full-depth ``qwen3-8b`` with seeded random weights
   serves 16 requests (4 share a 512-token prefix) through
   ``repro_torch.serving.engine.ServeEngine``; every kernel must have been
   launched and no plain version called;
5. logits: two requests, prefill plus 8 teacher-forced decode steps, once
   through the kernels and once under ``ops.use_backend("plain")``; the
   logits must agree.

The line before the last is the kernels summary as JSON; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of ``repro``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_TC_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
TOL = dict(atol=2e-2, rtol=2e-2)  # bf16, as tests/test_kernels.py:28-30
L2_BYTES = 50 * 2 ** 20

# serving configuration of the smoke run
N_SLOTS, MAX_SEQ, PAGE, CHUNK = 8, 2048, 64, 256


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def _close(got, want, what: str) -> float:
    import torch

    err = (got.float() - want.float()).abs()
    lim = TOL["atol"] + TOL["rtol"] * want.float().abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    if bool((err > lim).any()):
        raise AssertionError(f"{what}: max abs err {err.max().item():.4g} "
                             f"over atol=rtol=2e-2")
    return float(err.max())


def _time_ms(fn, *, iters: int = 20, flush: bool = False) -> float:
    """Median device time of one call, by CUDA events around each call.
    With ``flush`` a 128 MB write first evicts the L2 cache (the serving path
    finds its KV pages cold). Then a sleep kernel of about half a
    millisecond keeps the stream busy while the host queues the first event,
    the call and the second event, so the host's launch cost is not timed."""
    import torch

    scrub = torch.empty(4 * L2_BYTES // 4, dtype=torch.float32, device="cuda") \
        if flush else None
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        if scrub is not None:
            scrub.zero_()
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# 1-2. device and build
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "smi": smi}


def phase_build() -> None:
    import torch

    from repro_torch.kernels import _build, ops

    t0 = time.perf_counter()
    logs = _build.build_all()
    t_nvcc = time.perf_counter() - t0
    for name, text in logs.items():
        usage = [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln]
        log({"build": name, "ptxas": usage})
    x = torch.ones(2, 128, dtype=torch.bfloat16, device="cuda")
    ops.rmsnorm(x, torch.ones(128, device="cuda"))  # Triton's first compile
    torch.cuda.synchronize()
    log({"phase": "build", "nvcc_s": round(t_nvcc, 3),
         "total_s": round(time.perf_counter() - t0, 3)})


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------


def check_rmsnorm(gen) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref, rmsnorm as rk

    rows = []
    for shape in [(N_SLOTS, 4096), (CHUNK, 4096), (CHUNK * 32, 128),
                  (CHUNK * 8, 128)]:
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        w = 1 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
        got = rk.rmsnorm(x, w, 1e-6)
        with ops.use_backend("plain"):
            want = ops.rmsnorm(x, w, 1e-6)
        err = _close(got, want, f"rmsnorm {shape}")
        nbytes = 2 * x.numel() * x.element_size() + w.numel() * 4
        wl = w.to(x.dtype)
        rows.append({
            "shape": list(shape), "max_abs_err": err,
            "ms": _time_ms(lambda: rk.rmsnorm(x, w, 1e-6)),
            "plain_ms": _time_ms(lambda: ref.rmsnorm(x, w, 1e-6)),
            "library_ms": _time_ms(
                lambda: F.rms_norm(x, (shape[-1],), wl, 1e-6)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        })
    return rows


def _paged_case(gen, lengths, *, n_heads=32, n_kv=8, d=128):
    import torch

    B = len(lengths)
    max_pages = MAX_SEQ // PAGE
    n_pages = B * max_pages + 1
    q = torch.randn(B, n_heads, d, generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn(n_pages, PAGE, n_kv, d, generator=gen,
                     device="cuda").to(torch.bfloat16)
    vp = torch.randn(n_pages, PAGE, n_kv, d, generator=gen,
                     device="cuda").to(torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(
        B), device="cpu")
    table = (perm[: B * max_pages] + 1).reshape(B, max_pages).to(torch.int32)
    table[3, :4] = table[2, :4]          # lanes 2 and 3 share a prefix
    lens = torch.tensor(lengths, dtype=torch.int32)
    return q, kp, vp, table.cuda(), lens.cuda()


def check_paged_decode(gen) -> dict:
    import torch

    from repro_torch.kernels import ops, paged_decode_attention as pk

    lengths = [0, 1, 63, 64, 65, 2047, 700, 1300]
    q, kp, vp, table, lens = _paged_case(gen, lengths)
    got = pk.paged_decode_attention(q, kp, vp, table, lens)
    with ops.use_backend("plain"):
        want = ops.paged_decode_attention(q, kp, vp, table, lens)
    err = _close(got, want, "paged_decode_attention")
    if bool(got[0].float().abs().max() != 0):
        raise AssertionError("paged decode: zero-length lane is not zeros")
    again = pk.paged_decode_attention(q, kp, vp, table, lens)
    if not torch.equal(got, again):
        raise AssertionError("paged decode: two runs differ bitwise")
    # lane 5 must not see the other lanes: change them all, and the batch size
    q2, table2, lens2 = q.clone(), table.clone(), lens.clone()
    others = [i for i in range(len(lengths)) if i != 5]
    q2[others] = torch.randn_like(q2[others], dtype=torch.float32).to(q.dtype)
    table2[others] = table2[others].flip(1)
    lens2[others] = torch.tensor([5, 9, 100, 2000, 17, 33, 64],
                                 dtype=torch.int32, device="cuda")
    other = pk.paged_decode_attention(q2, kp, vp, table2, lens2)
    alone = pk.paged_decode_attention(q[5:6], kp, vp, table[5:6], lens[5:6])
    if not (torch.equal(other[5], got[5]) and torch.equal(alone[0], got[5])):
        raise AssertionError("paged decode: lane 5 changed with its batch")
    K, D = kp.shape[2], kp.shape[3]
    n_keys = int(lens.sum())
    nbytes = (n_keys * K * D * 2 * 2 + 2 * q.numel() * 2
              + table.numel() * 4 + lens.numel() * 4)
    flops = 4 * n_keys * q.shape[1] * D
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    return {
        "shape": {"B": len(lengths), "H": q.shape[1], "K": K, "D": D,
                  "P": PAGE, "lengths": lengths},
        "max_abs_err": err,
        "ms": _time_ms(lambda: pk.paged_decode_attention(q, kp, vp, table,
                                                         lens), flush=True),
        "plain_ms": _time_ms(lambda: pk.plain(q, kp, vp, table, lens),
                             flush=True),
        "library_ms": None, "bound_ms": bound,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
        else "operations",
    }


def check_flash(gen) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fk, ops

    H, K, D = 32, 8, 128
    rows = []
    cases = [(CHUNK, off, -(-(off + CHUNK) // PAGE) * PAGE)
             for off in (0, 256, 1280)] + [(200, 777, 977)]
    for sq, off, sk in cases:
        q = torch.randn(1, sq, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn(1, sk, K, D, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(1, sk, K, D, generator=gen, device="cuda").to(torch.bfloat16)
        got = fk.flash_attention(q, k, v, causal=True, q_offset=off)
        with ops.use_backend("plain"):
            want = ops.attention(q, k, v, causal=True, q_offset=off)
        err = _close(got, want, f"flash_attention sq={sq} off={off} sk={sk}")
        qpos = torch.arange(sq, device="cuda")[:, None] + off
        mask = torch.arange(sk, device="cuda")[None, :] <= qpos
        keys = int(mask.sum())
        flops = 4 * D * H * keys
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rows.append({
            "shape": {"Sq": sq, "Sk": sk, "q_offset": off, "H": H, "K": K,
                      "D": D},
            "max_abs_err": err,
            "ms": _time_ms(lambda: fk.flash_attention(q, k, v, causal=True,
                                                      q_offset=off),
                           flush=True),
            "plain_ms": _time_ms(lambda: fk.plain(q, k, v, causal=True,
                                                  q_offset=off), flush=True),
            "library_ms": _time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True),
                flush=True),
            "bound_ms": max(flops / BF16_TC_FLOPS,
                            nbytes / HBM_BYTES_PER_S) * 1e3,
            "bound_by": "operations" if flops / BF16_TC_FLOPS
            >= nbytes / HBM_BYTES_PER_S else "bytes",
        })
    return rows


def phase_kernels(seed: int = 0) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {"rmsnorm": check_rmsnorm(gen),
           "paged_decode_attention": [check_paged_decode(gen)],
           "flash_attention": check_flash(gen)}
    for name, rows in out.items():
        for r in rows:
            log({"kernel_check": name, **r})
    return out


# ---------------------------------------------------------------------------
# 4. serve: the port's main path at full width
# ---------------------------------------------------------------------------


def _traffic(seed: int, vocab: int) -> list[list[int]]:
    """16 prompts of 96-1536 tokens; 4 of them share a 512-token prefix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(96, 1537, 16)
    prefix = rng.integers(1, vocab, 512).tolist()
    prompts = []
    for i, n in enumerate(lens):
        if i % 4 == 1:  # requests 1, 5, 9, 13
            tail = rng.integers(1, vocab, max(int(n) - 512, 32)).tolist()
            prompts.append(prefix + tail)
        else:
            prompts.append(rng.integers(1, vocab, int(n)).tolist())
    return prompts


def phase_serve(model, params, seed: int = 0) -> dict:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServeEngine

    cfg = model.cfg
    engine = ServeEngine(model, params, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                         page_size=PAGE, prefill_chunk=CHUNK, device="cuda")
    # warm-up request (cuBLAS handles, allocator), then a clean slate
    engine.submit(list(range(1, 300)), max_new_tokens=2)
    engine.run()
    engine.reset_stats()
    prompts = _traffic(seed, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=32) for p in prompts]
    ttft: dict[int, float] = {}
    decode_ms, prefill_s, prefill_tok = [], 0.0, 0
    while engine.pending():
        s0 = time.perf_counter()
        n_active = engine.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - s0
        used = engine.last_step_tokens - n_active
        if used:
            prefill_s += dt
            prefill_tok += used
        elif n_active:
            decode_ms.append(dt * 1e3)
        for r in reqs:
            if r.generated and r.req_id not in ttft:
                ttft[r.req_id] = time.perf_counter() - t0
    wall = time.perf_counter() - t0
    counts = ops.counts()
    done = [r for r in reqs if r.done]
    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)}/{len(reqs)} requests completed")
    for name, c in counts.items():
        if c["launches"] <= 0:
            raise AssertionError(f"kernel {name} was never launched: {c}")
        if c["plain"]:
            raise AssertionError(f"plain {name} ran on the main path: {c}")
    if engine.stats["prefix_hits"] <= 0:
        raise AssertionError("the shared 512-token prefix was never hit")
    n_gen = sum(len(r.generated) for r in reqs)
    out = {
        "phase": "serve", "arch": cfg.arch_id, "layers": cfg.n_layers,
        "params_b": round(cfg.param_count() / 1e9, 3),
        "requests": len(reqs), "generated_tokens": n_gen, "wall_s": wall,
        "tokens_per_s": n_gen / wall,
        "decode_step_ms_median": statistics.median(decode_ms),
        "decode_steps": len(decode_ms),
        "ttft_s_median": statistics.median(ttft.values()),
        "prefill_tokens_per_s": prefill_tok / prefill_s,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "prefix_hits": engine.stats["prefix_hits"],
        "prefill_tokens_shared": engine.stats["prefill_tokens_shared"],
        "launches": {n: c["launches"] for n, c in counts.items()},
    }
    log(out)
    return out


def phase_profile(model, params, seed: int = 2) -> dict:
    """Where the time goes: ``torch.profiler`` over a short serve (8
    requests of 512 prompt tokens, 8 new tokens each) on a warm engine —
    the device's busy share of the wall time and the kernels that fill it."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import ServeEngine

    rng = np.random.default_rng(seed)
    engine = ServeEngine(model, params, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                         page_size=PAGE, prefill_chunk=CHUNK, device="cuda")
    engine.submit(list(range(1, 300)), max_new_tokens=2)
    engine.run()
    for _ in range(N_SLOTS):
        engine.submit(rng.integers(1, model.cfg.vocab_size, 512).tolist(),
                      max_new_tokens=8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    top_host = sorted(host, key=lambda e: -e.self_cpu_time_total)[:12]
    out = {"phase": "profile", "wall_s": wall, "device_busy_s": busy,
           "device_busy_share": busy / wall,
           "host_self_s": sum(e.self_cpu_time_total for e in host) / 1e6,
           "top_kernels": [{"name": e.key[:70], "calls": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top],
           "top_host_ops": [{"name": e.key[:70], "calls": e.count,
                             "ms": e.self_cpu_time_total / 1e3}
                            for e in top_host]}
    log(out)
    return out


# ---------------------------------------------------------------------------
# 5. logits: kernel path against the plain path, teacher-forced
# ---------------------------------------------------------------------------

# Max |logit difference| allowed between the kernel path and the plain path
# over the 18 teacher-forced logit rows (2 prefills + 2 x 8 decode steps).
# Both paths share every matrix product; they differ in the attention and
# norm kernels' f32 summation order and in the flash kernel's bf16
# probabilities. Each such difference is a bf16 rounding of an activation,
# and with random weights the roundings compound through 36 layers: the
# first measured runs (H100 80GB HBM3, 700 W) gave 0.22 at most, mean 0.032,
# on logits of magnitude up to 4.8, already on the first (prefill) row. The
# bound is about twice that. A row's greedy token may differ only at a near
# tie: the plain path must score the kernel path's choice within the same
# bound of its own best.
LOGIT_ATOL = 0.5


def _teacher_forced(model, params, prompts, forced, n_steps: int):
    """Prefill each prompt (one slot each), then ``n_steps`` batched decode
    steps feeding ``forced`` tokens; returns the logits of every step
    (prefill's first-token logits first) and the launches per call."""
    import torch

    from repro_torch.kernels import ops

    B = len(prompts)
    max_pages = MAX_SEQ // PAGE
    cache = model.init_paged_cache(B, B * max_pages + 1, PAGE, device="cuda")
    table = torch.zeros(B, max_pages, dtype=torch.int32, device="cuda")
    for b in range(B):
        table[b] = torch.arange(1 + b * max_pages, 1 + (b + 1) * max_pages)
    rows, per_call = [], {}
    first = []
    for b, p in enumerate(prompts):
        for off in range(0, len(p), CHUNK):
            n = min(CHUNK, len(p) - off)
            toks = torch.zeros(1, CHUNK, dtype=torch.int32, device="cuda")
            toks[0, :n] = torch.tensor(p[off:off + n])
            before = ops.counts()
            lg = model.prefill_chunk(params, cache, {
                "tokens": toks, "valid": n, "page_table": table[b]},
                offset=off)
            per_call.setdefault("prefill_chunk", {
                k: ops.counts()[k]["launches"] - v["launches"]
                for k, v in before.items()})
        first.append(lg[0])
    rows.append(torch.stack(first))
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device="cuda")
    for s in range(n_steps):
        toks = torch.tensor([[forced[b][s]] for b in range(B)],
                            dtype=torch.int32, device="cuda")
        before = ops.counts()
        lg = model.decode_paged(params, cache, {
            "tokens": toks, "positions": pos, "page_table": table})
        per_call.setdefault("decode_step", {
            k: ops.counts()[k]["launches"] - v["launches"]
            for k, v in before.items()})
        rows.append(lg)
        pos = pos + 1
    return torch.stack(rows).float(), per_call


def phase_logits(model, params, seed: int = 1) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    vocab = model.cfg.vocab_size
    prompts = [rng.integers(1, vocab, n).tolist() for n in (700, 300)]
    forced = rng.integers(1, vocab, (2, 8)).tolist()
    got, per_call = _teacher_forced(model, params, prompts, forced, 8)
    with ops.use_backend("plain"):
        want, _ = _teacher_forced(model, params, prompts, forced, 8)
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits on the kernel path")
    diff = (got - want).abs()
    pick = got.argmax(-1, keepdim=True)
    top1 = (pick == want.argmax(-1, keepdim=True)).float().mean().item()
    # how far below its own best the plain path scores the kernel's choice
    tie_gap = (want.amax(-1, keepdim=True) - want.gather(-1, pick)).max()
    out = {"phase": "logits", "max_abs_diff": diff.max().item(),
           "max_abs_diff_per_step": diff.amax(dim=(1, 2)).tolist(),
           "mean_abs_diff": diff.mean().item(),
           "max_abs_logit": want.abs().max().item(),
           "top1_agreement": top1, "max_tie_gap": tie_gap.item(),
           "atol": LOGIT_ATOL,
           "launches_per_call": per_call}
    log(out)
    if diff.max().item() > LOGIT_ATOL or tie_gap.item() > LOGIT_ATOL:
        raise AssertionError(f"kernel and plain logits differ by "
                             f"{diff.max().item():.4g}, greedy choices by "
                             f"{tie_gap.item():.4g} (bound {LOGIT_ATOL})")
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

ROUTES = {
    "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                "src/repro/kernels/rmsnorm.py:48"),
    "paged_decode_attention": (
        "cuda", "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/paged_decode_attention.py:129"),
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:139"),
}
# the check row that stands for each kernel in the summary line: the
# decode step's block norm, the paged decode case, the longest prefill
# chunk (q_offset 1280)
SUMMARY_ROW = {"rmsnorm": 0, "paged_decode_attention": 0,
               "flash_attention": 2}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here, before any output,
    # when the script stands without the rest of the repo)

    device = phase_device()
    phase_build()
    checks = phase_kernels()

    from repro_torch.configs import get
    from repro_torch.models import get_model

    model = get_model(get("qwen3-8b"))
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    log({"phase": "init", "seconds": time.perf_counter() - t0,
         "weights_gb": sum(p.numel() * p.element_size()
                           for p in params.parameters()) / 1e9})
    serve = phase_serve(model, params)
    phase_profile(model, params)
    per_call = phase_logits(model, params)["launches_per_call"]

    kernels = []
    for name, (route, source, replaces) in ROUTES.items():
        row = checks[name][SUMMARY_ROW[name]]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": serve["launches"][name],
            "launches_per_decode_step": per_call["decode_step"][name],
            "launches_per_prefill_chunk": per_call["prefill_chunk"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"],
        })
    log({"kernels": kernels})
    log(device["smi"])
    log({"ok": True, "device": {"platform": device["platform"],
                                "kind": device["kind"],
                                "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
