"""Smoke run of the PyTorch port on one NVIDIA H100.

Usage (from the root of a checkout, on a machine with the card):

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. device: prints the card's name and power limit (``nvidia-smi``);
2. build: compiles every kernel of the serving path from ``src/repro_torch``
   (one ``nvcc`` per CUDA source, all started together, plus the Triton
   kernel's first compile) and prints the seconds;
3. kernels: holds each hand-written kernel against its plain PyTorch
   version at the main paths' shapes (bf16 outputs atol = rtol = 2e-2, f32
   SSM states 5e-3, as ``tests/test_kernels.py:28-30,106,128``) and times
   kernel, plain version and, where one PyTorch call computes the same
   function, that call (``library_ms``, a yardstick only), with the
   factors ``x_library`` (ms / library_ms) and ``x_bound`` (ms /
   bound_ms); the attention kernels also at zamba2's shapes (D = 64,
   H = K = 32), the SSM kernels also at a ragged length and from a nonzero
   state; the dense decode at a 2048-position cache with lengths 0
   (zeros), 1 and 2048; both decode kernels bitwise: two runs equal, and a
   lane equal alone, in a batch of other lanes, among lanes all longer
   than it, and over a cache of another capacity (S, or the page table's
   width); flash attention, the scan and the SSD also over a whole
   2048-token dense prefill;
4. per model — full-width, full-depth ``qwen3-8b``, then ``falcon-mamba-7b``
   (Mamba1), then ``zamba2-1.2b`` (Mamba2 + shared attention), each with
   seeded random weights, freed before the next:
   a. serve: 16 requests (4 share a 512-token prefix) through
      ``repro_torch.serving.engine.ServeEngine``; every kernel of the
      model's path must have been launched and no plain version called;
      for the SSM and hybrid models the prefix trie is bookkeeping only
      (would-be hits counted, no prefill shared), and the longest prompt's
      state when its prefill ends, with decode steps of other lanes run
      meanwhile, must equal a solo prefill's (the R3 guard);
   b. profile: where a short serve's device and host time go;
   c. logits: two requests, prefill plus 8 teacher-forced decode steps,
      once through the kernels and once under ``ops.use_backend("plain")``;
      the logits must agree within the model's bound where the model is
      not chaotic (qwen3-8b), beside a control (the plain path with one
      bf16 ulp added to one embedding value); and every kernel call of the
      plain path is also run through the kernel on the same activations
      and must agree within the kernel's tolerance (kernel-forced);
   d. dense: the same 16 requests through ``ServeEngine(paged=False)``
      (every kernel of the dense path launched, ``decode_attention`` for
      qwen3-8b and zamba2, no plain version called), the share of greedy
      tokens equal to the paged serve's (a number, not a gate: the dense
      engine attends its bucket's left pads, and the rounding differs),
      and a teacher-forced dense run whose every kernel call is held
      against the plain version on the same activations (kernel-forced);
   e. continuity, paged and dense: 8 requests served, snapshotted after 6
      steps, restored into a fresh engine and finished; every request's
      tokens must equal an uninterrupted run's exactly (same card,
      greedy); the blob's bytes and the snapshot and restore seconds are
      printed.

The line two before the last is the kernels summary as JSON (one row per
kernel and model whose path runs it), the line before the last the card's
name and power limit, the last ``{"ok": true, "device": {...}}``. Imports
nothing of JAX or of ``repro``.
"""

from __future__ import annotations

import gc
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
# exponentials per second of the special-function units: 16 per SM per
# clock (4 per SM sub-partition, Hopper white paper), 132 SMs, 1.98 GHz
SFU_EXP_PER_S = 16 * 132 * 1.98e9
TOL = dict(atol=2e-2, rtol=2e-2)  # bf16, as tests/test_kernels.py:28-30
STATE_TOL = dict(atol=5e-3, rtol=5e-3)  # f32 SSM state, test_kernels.py:106
L2_BYTES = 50 * 2 ** 20

# serving configuration of the smoke run
N_SLOTS, MAX_SEQ, PAGE, CHUNK = 8, 2048, 64, 256


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def _close(got, want, what: str, tol: dict = TOL) -> float:
    import torch

    err = (got.float() - want.float()).abs()
    lim = tol["atol"] + tol["rtol"] * want.float().abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    if bool((err > lim).any()):
        raise AssertionError(f"{what}: max abs err {err.max().item():.4g} "
                             f"over atol=rtol={tol['atol']}")
    return float(err.max())


def _bound(nbytes: float, flops: float, flop_rate: float,
           exps: float = 0.0) -> dict:
    """The least time of one call: bytes over HBM's rate against
    operations over their units' peak (FLOPs, and exponentials on the
    special-function units where the kernel is made of them)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / flop_rate, exps / SFU_EXP_PER_S)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
        saved = _build.BUILD / f"{name}.log"
        if not text and saved.exists():  # built earlier in this checkout
            text = saved.read_text()
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
    # the block norms of qwen3-8b / falcon-mamba (d 4096) and of zamba2
    # (d 2048; its gate norm is d_inner 4096), qwen3's qk-norm rows
    for shape in [(N_SLOTS, 4096), (CHUNK, 4096), (CHUNK * 32, 128),
                  (CHUNK * 8, 128), (N_SLOTS, 2048), (CHUNK, 2048)]:
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
            **_bound(nbytes, 0, F32_FLOPS),
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


def check_paged_decode(gen, *, n_heads=32, n_kv=8, d=128) -> dict:
    import torch

    from repro_torch.kernels import ops, paged_decode_attention as pk

    lengths = [0, 1, 63, 64, 65, 2047, 700, 1300]
    q, kp, vp, table, lens = _paged_case(gen, lengths, n_heads=n_heads,
                                         n_kv=n_kv, d=d)
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
    # lane 6 (700 keys, three segments) among lanes all longer than it, and
    # alone over a wider page table (another capacity, so another grid)
    lens3 = torch.full_like(lens, MAX_SEQ)
    lens3[6] = lens[6]
    longer = pk.paged_decode_attention(q, kp, vp, table, lens3)
    wide = torch.cat([table[6:7], table[7:8, :8]], dim=1)
    wider = pk.paged_decode_attention(q[6:7], kp, vp, wide, lens[6:7])
    if not (torch.equal(longer[6], got[6]) and torch.equal(wider[0], got[6])):
        raise AssertionError("paged decode: lane 6 changed among longer "
                             "lanes or with the table's width")
    K, D = kp.shape[2], kp.shape[3]
    n_keys = int(lens.sum())
    nbytes = (n_keys * K * D * 2 * 2 + 2 * q.numel() * 2
              + table.numel() * 4 + lens.numel() * 4)
    flops = 4 * n_keys * q.shape[1] * D
    return {
        "shape": {"B": len(lengths), "H": q.shape[1], "K": K, "D": D,
                  "P": PAGE, "lengths": lengths},
        "max_abs_err": err,
        "ms": _time_ms(lambda: pk.paged_decode_attention(q, kp, vp, table,
                                                         lens), flush=True),
        "plain_ms": _time_ms(lambda: pk.plain(q, kp, vp, table, lens),
                             flush=True),
        "library_ms": None, **_bound(nbytes, flops, F32_FLOPS),
    }


def check_decode(gen, *, n_heads=32, n_kv=8, d=128) -> dict:
    """The dense-cache decode at the dense engine's shape: 8 lanes over a
    ``MAX_SEQ`` cache, lengths from 0 (zeros) to the whole cache."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dk, ops

    lengths = [0, 1, 63, MAX_SEQ, 700, 1300, MAX_SEQ - 1, 64]
    B, S = len(lengths), MAX_SEQ
    q = torch.randn(B, n_heads, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, S, n_kv, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, S, n_kv, d, generator=gen, device="cuda").bfloat16()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = dk.decode_attention(q, k, v, lens)
    with ops.use_backend("plain"):
        want = ops.decode_attention(q, k, v, lens)
    err = _close(got, want, "decode_attention")
    if bool(got[0].float().abs().max() != 0):
        raise AssertionError("decode: zero-length lane is not zeros")
    if not torch.equal(got, dk.decode_attention(q, k, v, lens)):
        raise AssertionError("decode: two runs differ bitwise")
    alone = dk.decode_attention(q[5:6], k[5:6], v[5:6], lens[5:6])
    if not torch.equal(alone[0], got[5]):
        raise AssertionError("decode: lane 5 changed with its batch")
    # lane 5 (1300 keys, six segments) among lanes all longer than it, and
    # alone in a cache of another S (more segments, so another grid)
    lens3 = torch.full_like(lens, S)
    lens3[5] = lens[5]
    longer = dk.decode_attention(q, k, v, lens3)
    k2 = torch.zeros(1, S + 1024, n_kv, d, device="cuda", dtype=k.dtype)
    v2 = torch.zeros_like(k2)
    k2[0, :S], v2[0, :S] = k[5], v[5]
    other_s = dk.decode_attention(q[5:6], k2, v2, lens[5:6])
    if not (torch.equal(longer[5], got[5]) and torch.equal(other_s[0], got[5])):
        raise AssertionError("decode: lane 5 changed among longer lanes or "
                             "with the cache's S")
    n_keys = int(lens.sum())
    nbytes = (n_keys * n_kv * d * 2 * 2 + 2 * q.numel() * 2
              + lens.numel() * 4)
    flops = 4 * n_keys * n_heads * d
    # the yardstick: SDPA over the same cache, a boolean key mask and GQA
    # (NaN on the empty lane; only its time is used)
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None]
            )[:, None, None, :]
    return {
        "shape": {"B": B, "H": n_heads, "K": n_kv, "D": d, "S": S,
                  "lengths": lengths},
        "max_abs_err": err,
        "ms": _time_ms(lambda: dk.decode_attention(q, k, v, lens),
                       flush=True),
        "plain_ms": _time_ms(lambda: dk.plain(q, k, v, lens), flush=True),
        "library_ms": _time_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), flush=True),
        **_bound(nbytes, flops, F32_FLOPS),
    }


def check_flash(gen, *, H=32, K=8, D=128) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fk, ops

    rows = []
    # paged prefill chunks, a ragged one, and a whole dense prefill
    cases = [(CHUNK, off, -(-(off + CHUNK) // PAGE) * PAGE)
             for off in (0, 256, 1280)] + [(200, 777, 977),
                                            (MAX_SEQ, 0, MAX_SEQ)]
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
            **_bound(nbytes, flops, BF16_TC_FLOPS),
        })
    return rows


def check_selective_scan(gen) -> list[dict]:
    """falcon-mamba's prefill chunk (S = 256, Di = 8192, N = 16) from a zero
    and from a nonzero state, a ragged S = 200, and a whole dense prefill
    (S = 2048 from a zero state); y (bf16) and hT (f32)."""
    import torch

    from repro_torch.kernels import ops, selective_scan as sk

    rows = []
    for S, h0_scale in ((CHUNK, 0.0), (CHUNK, 0.1), (200, 0.1),
                        (MAX_SEQ, 0.0)):
        B, Di, N = 1, 8192, 16
        x = (0.5 * torch.randn(B, S, Di, generator=gen, device="cuda")).bfloat16()
        dt = (0.1 * torch.randn(B, S, Di, generator=gen, device="cuda").abs()
              ).bfloat16()
        A = -(torch.randn(Di, N, generator=gen, device="cuda").abs() + 0.1)
        Bm = (0.5 * torch.randn(B, S, N, generator=gen, device="cuda")).bfloat16()
        C = (0.5 * torch.randn(B, S, N, generator=gen, device="cuda")).bfloat16()
        D = torch.randn(Di, generator=gen, device="cuda")
        h0 = h0_scale * torch.randn(B, Di, N, generator=gen, device="cuda")
        y, hT = sk.selective_scan(x, dt, A, Bm, C, D, h0)
        with ops.use_backend("plain"):
            yw, hw = ops.selective_scan(x, dt, A, Bm, C, D, h0)
        what = f"selective_scan S={S} h0*{h0_scale}"
        err = max(_close(y, yw, what), _close(hT, hw, what + " hT", STATE_TOL))
        nbytes = (3 * B * S * Di * 2 + 2 * B * S * N * 2 + Di * N * 4 + Di * 4
                  + 2 * B * Di * N * 4)
        # per (t, d, n): dt*A, exp, two products and an add for h, an FMA
        # into y; per (t, d): dt*x and D*x + y
        n_sn = B * S * Di * N
        rows.append({
            "shape": {"B": B, "S": S, "Di": Di, "N": N, "h0": h0_scale},
            "max_abs_err": err,
            "ms": _time_ms(lambda: sk.selective_scan(x, dt, A, Bm, C, D, h0),
                           flush=True),
            "plain_ms": _time_ms(lambda: sk.plain(x, dt, A, Bm, C, D, h0),
                                 iters=3, flush=True),
            "library_ms": None,
            **_bound(nbytes, 6 * n_sn + 3 * B * S * Di, F32_FLOPS, exps=n_sn),
        })
    return rows


def check_ssd(gen) -> list[dict]:
    """zamba2's prefill chunk (S = c = 256, Hs = 64, P = 64, N = 64) from a
    zero and from a nonzero state, a ragged S = 200, S = 600 over three
    chunks, and a whole dense prefill (S = 2048, eight chunks, from a zero
    state); y (bf16) and hT (f32)."""
    import torch

    from repro_torch.kernels import ops, ssd as dk

    rows = []
    for S, h0_scale in ((CHUNK, 0.0), (CHUNK, 0.1), (200, 0.1), (600, 0.1),
                        (MAX_SEQ, 0.0)):
        B, Hs, P, N = 1, 64, 64, 64
        x = (0.5 * torch.randn(B, S, Hs, P, generator=gen, device="cuda")
             ).bfloat16()
        dt = (0.1 * torch.randn(B, S, Hs, generator=gen, device="cuda").abs()
              ).bfloat16()
        A = -(torch.randn(Hs, generator=gen, device="cuda").abs() + 0.1)
        Bm = (0.5 * torch.randn(B, S, N, generator=gen, device="cuda")).bfloat16()
        C = (0.5 * torch.randn(B, S, N, generator=gen, device="cuda")).bfloat16()
        D = torch.randn(Hs, generator=gen, device="cuda")
        h0 = h0_scale * torch.randn(B, Hs, P, N, generator=gen, device="cuda")
        y, hT = dk.ssd(x, dt, A, Bm, C, D, h0, chunk=CHUNK)
        with ops.use_backend("plain"):
            yw, hw = ops.ssd(x, dt, A, Bm, C, D, h0, chunk=CHUNK)
        what = f"ssd S={S} h0*{h0_scale}"
        err = max(_close(y, yw, what), _close(hT, hw, what + " hT", STATE_TOL))
        nbytes = (2 * B * S * Hs * P * 2 + B * S * Hs * 2 + 2 * B * S * N * 2
                  + 2 * Hs * 4 + 2 * B * Hs * P * N * 4)
        # per chunk of n steps: C B^T once for all heads (n(n+1)/2 pairs x
        # N FMAs); per head the masked product with x (pairs x P), the
        # carried state's read and update (2 n P N), the decay mask
        chunks = [min(CHUNK, S - c0) for c0 in range(0, S, CHUNK)]
        pairs = sum(n * (n + 1) // 2 for n in chunks)
        flops = B * (2 * pairs * N + Hs * (2 * pairs * P + 3 * pairs
                                           + 4 * S * P * N))
        rows.append({
            "shape": {"B": B, "S": S, "Hs": Hs, "P": P, "N": N,
                      "chunk": CHUNK, "h0": h0_scale},
            "max_abs_err": err,
            "ms": _time_ms(lambda: dk.ssd(x, dt, A, Bm, C, D, h0, chunk=CHUNK),
                           flush=True),
            "plain_ms": _time_ms(lambda: dk.plain(x, dt, A, Bm, C, D, h0,
                                                  chunk=CHUNK), flush=True),
            "library_ms": None,
            **_bound(nbytes, flops, F32_FLOPS, exps=B * Hs * (pairs + 2 * S)),
        })
    return rows


def phase_kernels(seed: int = 0) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {"rmsnorm": check_rmsnorm(gen),
           "paged_decode_attention": [check_paged_decode(gen)],
           "decode_attention": [check_decode(gen)],
           "flash_attention": check_flash(gen),
           "selective_scan": check_selective_scan(gen),
           "ssd": check_ssd(gen),
           # zamba2's shared attention block: D = 64, H = K = 32 (G = 1)
           "paged_decode_attention@zamba2": [
               check_paged_decode(gen, n_heads=32, n_kv=32, d=64)],
           "decode_attention@zamba2": [
               check_decode(gen, n_heads=32, n_kv=32, d=64)],
           "flash_attention@zamba2": check_flash(gen, H=32, K=32, D=64)}
    for name, rows in out.items():
        for r in rows:
            r.update(_factors(r))
            log({"kernel_check": name, **r})
    return out


def _factors(row: dict) -> dict:
    """The kernel's time over its library call's and over its bound."""
    lib = row["library_ms"]
    return {"x_library": row["ms"] / lib if lib else None,
            "x_bound": row["ms"] / row["bound_ms"]}


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


# kernels each model's path launches (every one of them must run in its
# serve phase; no plain version may)
PATH_KERNELS = {
    "qwen3-8b": ("rmsnorm", "paged_decode_attention", "flash_attention"),
    "falcon-mamba-7b": ("rmsnorm", "selective_scan"),
    "zamba2-1.2b": ("rmsnorm", "paged_decode_attention", "flash_attention",
                    "ssd"),
}
# the same for the dense engine (``paged=False``)
DENSE_PATH_KERNELS = {
    "qwen3-8b": ("rmsnorm", "decode_attention", "flash_attention"),
    "falcon-mamba-7b": ("rmsnorm", "selective_scan"),
    "zamba2-1.2b": ("rmsnorm", "decode_attention", "flash_attention", "ssd"),
}


def _check_counts(counts: dict, path: tuple, what: str) -> None:
    """Every kernel of ``path`` launched, no plain version called."""
    for name, c in counts.items():
        if name in path and c["launches"] <= 0:
            raise AssertionError(f"{what}: kernel {name} was never "
                                 f"launched: {c}")
        if c["plain"]:
            raise AssertionError(f"{what}: plain {name} ran: {c}")


def _slot_state(cache, slot: int) -> dict:
    return {k: v[:, slot].clone() for k, v in cache.items()
            if not k.endswith("_pages")}


def _solo_state(model, params, prompt: list[int]) -> dict:
    """The recurrent state a prefill of ``prompt`` alone leaves in a fresh
    one-slot cache."""
    import torch

    max_pages = MAX_SEQ // PAGE
    cache = model.init_paged_cache(1, max_pages + 1, PAGE, device="cuda")
    table = torch.arange(1, max_pages + 1, dtype=torch.int32, device="cuda")
    for off in range(0, len(prompt), CHUNK):
        n = min(CHUNK, len(prompt) - off)
        toks = torch.zeros(1, CHUNK, dtype=torch.int32, device="cuda")
        toks[0, :n] = torch.tensor(prompt[off:off + n])
        model.prefill_chunk(params, cache, {"tokens": toks, "valid": n,
                                            "slot": 0, "page_table": table},
                            offset=off)
    return _slot_state(cache, 0)


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
    # R3: the longest prompt's state when its last chunk lands
    longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    at_finish: dict = {}
    finish = engine._finish_prefill

    def spy(slot, req, *args):
        if model.paged_state and req.req_id == reqs[longest].req_id:
            at_finish.update(_slot_state(engine.cache, slot))
        finish(slot, req, *args)

    engine._finish_prefill = spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=32) for p in prompts]
    ttft: dict[int, float] = {}
    decode_ms, prefill_s, prefill_tok = [], 0.0, 0
    overlapped = 0   # decode steps run while the longest prompt prefilled
    while engine.pending():
        s0 = time.perf_counter()
        n_active = engine.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - s0
        used = engine.last_step_tokens - n_active
        slot = reqs[longest].slot
        overlapped += bool(n_active and slot in engine.prefilling)
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
    _check_counts(counts, PATH_KERNELS[cfg.arch_id], "paged serve")
    stats = engine.stats
    r3 = None
    if model.paged_state:
        # the trie is bookkeeping only: would-be hits, nothing shared
        if stats["prefix_hit_tokens"] <= 0 or stats["prefill_tokens_shared"]:
            raise AssertionError(f"bookkeeping-only trie: {stats}")
        if not overlapped or not at_finish:
            raise AssertionError("no decode step overlapped a prefill")
        solo = _solo_state(model, params, prompts[longest])
        r3 = {k: (at_finish[k].float() - solo[k].float()).abs().max().item()
              for k in solo}
        for k in solo:
            _close(at_finish[k], solo[k], f"R3 {k} state",
                   STATE_TOL if k == "ssm" else TOL)
    elif stats["prefix_hits"] <= 0:
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
        "prefix_hits": stats["prefix_hits"],
        "prefix_hit_tokens": stats["prefix_hit_tokens"],
        "prefill_tokens_shared": stats["prefill_tokens_shared"],
        "decode_steps_overlapping_prefill": overlapped,
        "r3_max_abs_diff": r3,
        "launches": {n: c["launches"] for n, c in counts.items()},
    }
    log(out)
    out["tokens"] = [r.generated for r in reqs]
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
# over the 18 teacher-forced logit rows (2 prefills + 2 x 8 decode steps),
# free-running through the whole depth. Both paths share every matrix
# product; they differ in the kernels' f32 summation order (and the flash
# kernel's bf16 probabilities). Each such difference is a bf16 rounding of
# an activation, and with random weights the roundings compound through the
# layers. qwen3-8b: the first measured runs (H100 80GB HBM3, 700 W) gave
# 0.22 at most, mean 0.032, on logits of magnitude up to 4.8, already on the
# first (prefill) row; the bound is about twice that.
# falcon-mamba-7b and zamba2-1.2b: no bound. falcon-mamba's first run gave
# 3.7 on logits up to 4.75 (top-1 agreement 1 in 18), zamba2's 0.85 on
# logits up to 4.5: with random weights these stacks are chaotic. The phase
# measures two controls on the plain path, one bf16 ulp added to one
# embedding value and to every embedding value (each up or down at
# random). At full width (H100 80GB HBM3, 700 W) they moved the logits by
# 0.148 and 7.19 (falcon-mamba), 0.63 and 1.43 (zamba2), 0.23 and 0.58
# (qwen3-8b): rounding-sized differences alone move the two SSM stacks as
# far as the kernel path does. What holds the kernels to account there is
# the kernel-forced check (``_kernel_forced``): every kernel call of the
# path run both ways on the model's own activations, within the kernels'
# own tolerances.
LOGIT_ATOL = {"qwen3-8b": 0.5, "falcon-mamba-7b": None, "zamba2-1.2b": None}


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
                "tokens": toks, "valid": n, "slot": b,
                "page_table": table[b]}, offset=off)
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


def _kernel_forced(run) -> dict:
    """The plain path of ``run()`` (a teacher-forced pass), in which every
    call of a kernel's dispatch also runs the kernel on the same input —
    the model's real activations at the path's shapes — and holds it to
    the kernel's tolerance (bf16 outputs 2e-2, f32 states 5e-3). The plain
    result carries on, so no difference compounds. Returns the largest
    difference per kernel."""
    import torch

    from repro_torch.kernels import ops

    dispatch = {"rmsnorm": "rmsnorm", "attention": "flash_attention",
                "paged_decode_attention": "paged_decode_attention",
                "decode_attention": "decode_attention",
                "selective_scan": "selective_scan", "ssd": "ssd"}
    saved = {n: getattr(ops, n) for n in dispatch}
    worst: dict[str, float] = {}

    def both(name, plain, kernel):
        def run(*args, **kw):
            want = plain(*args, **kw)
            got = kernel(*args, **kw)
            pairs = zip(got, want) if isinstance(want, tuple) \
                else [(got, want)]
            for g, w in pairs:
                tol = STATE_TOL if w.dtype == torch.float32 else TOL
                err = _close(g, w, f"kernel-forced {name}", tol)
                worst[name] = max(worst.get(name, 0.0), err)
            return want
        return run

    for n, k in dispatch.items():
        setattr(ops, n, both(k, saved[n], ops.KERNELS[k]))
    try:
        with ops.use_backend("plain"):
            run()
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)
    return worst


def phase_logits(model, params, seed: int = 1) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    atol = LOGIT_ATOL[model.cfg.arch_id]
    rng = np.random.default_rng(seed)
    vocab = model.cfg.vocab_size
    prompts = [rng.integers(1, vocab, n).tolist() for n in (700, 300)]
    forced = rng.integers(1, vocab, (2, 8)).tolist()
    got, per_call = _teacher_forced(model, params, prompts, forced, 8)
    with ops.use_backend("plain"):
        want, _ = _teacher_forced(model, params, prompts, forced, 8)
        # controls: the plain path with one bf16 ulp added to one embedding
        # value (the first prompt token's first), and to every embedding
        # value, each up or down at random — how far rounding-sized
        # differences alone move the logits
        emb = params.embedding.data
        t0 = prompts[0][0]
        keep = emb.clone()
        try:
            emb[t0, 0] = (keep[t0, 0].float() * (1 + 2 ** -7)).to(emb.dtype)
            nudged, _ = _teacher_forced(model, params, prompts, forced, 8)
            gen = torch.Generator(device="cuda").manual_seed(seed)
            sign = torch.randint(0, 2, keep.shape, generator=gen,
                                 device="cuda", dtype=torch.int8) * 2 - 1
            emb.copy_((keep.float() * (1 + sign * 2.0 ** -7)).to(emb.dtype))
            nudged_all, _ = _teacher_forced(model, params, prompts, forced, 8)
        finally:
            emb.copy_(keep)
        del keep
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits on the kernel path")
    diff = (got - want).abs()
    pick = got.argmax(-1, keepdim=True)
    top1 = (pick == want.argmax(-1, keepdim=True)).float().mean().item()
    # how far below its own best the plain path scores the kernel's choice
    tie_gap = (want.amax(-1, keepdim=True) - want.gather(-1, pick)).max()
    out = {"phase": "logits", "arch": model.cfg.arch_id,
           "max_abs_diff": diff.max().item(),
           "max_abs_diff_per_step": diff.amax(dim=(1, 2)).tolist(),
           "mean_abs_diff": diff.mean().item(),
           "max_abs_logit": want.abs().max().item(),
           "top1_agreement": top1, "max_tie_gap": tie_gap.item(),
           "one_ulp_control_max_abs_diff": (nudged - want).abs().max().item(),
           "every_value_ulp_control_max_abs_diff":
               (nudged_all - want).abs().max().item(),
           "atol": atol, "launches_per_call": per_call}
    out["kernel_forced_max_abs_err"] = _kernel_forced(
        lambda: _teacher_forced(model, params, prompts, forced, 8))
    log(out)
    if atol is not None and (diff.max().item() > atol
                             or tie_gap.item() > atol):
        raise AssertionError(f"kernel and plain logits differ by "
                             f"{diff.max().item():.4g}, greedy choices by "
                             f"{tie_gap.item():.4g} (bound {atol})")
    return out


# ---------------------------------------------------------------------------
# 6. dense: the engine's paged=False path
# ---------------------------------------------------------------------------


def _teacher_forced_dense(model, params, prompts, forced, n_steps: int):
    """The dense path's counterpart of :func:`_teacher_forced`: each prompt
    right-aligned in its bucket, prefilled whole and scattered into its
    slot of a dense cache, then ``n_steps`` batched ``decode_step`` calls
    feeding ``forced`` tokens; returns the launches per call."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.engine import _bucket
    from repro_torch.serving.kvcache import expand_prefill_cache, scatter_slot

    B = len(prompts)
    cache = model.init_cache(B, MAX_SEQ, device="cuda")
    per_call = {}

    def launches(before):
        return {k: ops.counts()[k]["launches"] - v["launches"]
                for k, v in before.items()}

    pos = []
    for b, p in enumerate(prompts):
        n = _bucket(len(p))
        toks = torch.zeros(1, n, dtype=torch.int32, device="cuda")
        toks[0, n - len(p):] = torch.tensor(p)
        before = ops.counts()
        _, pcache = model.prefill(params, {"tokens": toks})
        per_call.setdefault("prefill", launches(before))
        scatter_slot(cache, expand_prefill_cache(
            pcache, {k: v[:, :1] for k, v in cache.items()}), b)
        pos.append(n)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    for s in range(n_steps):
        toks = torch.tensor([[forced[b][s]] for b in range(B)],
                            dtype=torch.int32, device="cuda")
        before = ops.counts()
        model.decode_step(params, cache, {"tokens": toks, "positions": pos})
        per_call.setdefault("decode_step", launches(before))
        pos = pos + 1
    return per_call


def phase_dense(model, params, paged_tokens: list, seed: int = 0) -> dict:
    """The smoke traffic through ``ServeEngine(paged=False)``, then the
    kernel-forced check of a teacher-forced dense run."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServeEngine

    cfg = model.cfg
    engine = ServeEngine(model, params, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                         paged=False, device="cuda")
    engine.submit(list(range(1, 300)), max_new_tokens=2)   # warm-up
    engine.run()
    engine.reset_stats()
    prompts = _traffic(seed, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=32) for p in prompts]
    ttft: dict[int, float] = {}
    decode_ms = []
    while engine.pending():
        s0 = time.perf_counter()
        queued = len(engine.queue)
        n_active = engine.step()
        torch.cuda.synchronize()
        if n_active and len(engine.queue) == queued:   # no admission ran
            decode_ms.append((time.perf_counter() - s0) * 1e3)
        for r in reqs:
            if r.generated and r.req_id not in ttft:
                ttft[r.req_id] = time.perf_counter() - t0
    wall = time.perf_counter() - t0
    counts = ops.counts()
    if not all(r.done for r in reqs):
        raise AssertionError("dense serve: not every request completed")
    _check_counts(counts, DENSE_PATH_KERNELS[cfg.arch_id], "dense serve")
    tokens = [r.generated for r in reqs]
    n_gen = sum(map(len, tokens))
    same = sum(a == b for t, u in zip(tokens, paged_tokens)
               for a, b in zip(t, u))
    rng = np.random.default_rng(seed + 1)
    tf_prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                  for n in (700, 300)]
    forced = rng.integers(1, cfg.vocab_size, (2, 8)).tolist()
    per_call = _teacher_forced_dense(model, params, tf_prompts, forced, 8)
    out = {
        "phase": "dense", "arch": cfg.arch_id, "requests": len(reqs),
        "generated_tokens": n_gen, "wall_s": wall,
        "tokens_per_s": n_gen / wall,
        "decode_step_ms_median": statistics.median(decode_ms),
        "decode_steps": len(decode_ms),
        "ttft_s_median": statistics.median(ttft.values()),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        # bucketed admission: a prompt whose bucket fills max_seq ends after
        # one decode step, as in the reference
        "requests_ended_at_max_seq": sum(
            len(t) < 32 for t in tokens),
        "greedy_agreement_with_paged": same / max(1, sum(
            min(len(t), len(u)) for t, u in zip(tokens, paged_tokens))),
        "launches": {n: c["launches"] for n, c in counts.items()},
        "launches_per_call": per_call,
        "kernel_forced_max_abs_err": _kernel_forced(
            lambda: _teacher_forced_dense(model, params, tf_prompts, forced,
                                          8)),
    }
    log(out)
    return out


# ---------------------------------------------------------------------------
# 7. continuity: snapshot, restore on a fresh engine, finish
# ---------------------------------------------------------------------------

FAIL_AFTER = 6


def phase_continuity(model, params, *, paged: bool, seed: int = 3) -> dict:
    """8 requests (prompts of 100-600 tokens, 16 new tokens each) served
    without a failure, and again with the host failing after
    ``FAIL_AFTER`` steps: snapshot, a fresh engine restores the blob and
    finishes. Every request's tokens must be equal, bit for bit the same
    greedy stream."""
    import numpy as np
    import torch

    from repro_torch.serving.engine import ServeEngine

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, model.cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(100, 601, 8)]

    def engine():
        return ServeEngine(model, params, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                           page_size=PAGE, prefill_chunk=CHUNK, paged=paged,
                           device="cuda")

    def submit(eng):
        return [eng.submit(p, max_new_tokens=16) for p in prompts]

    whole = engine()
    want = [r.generated for r in submit(whole)]
    whole.run()
    del whole
    cut = engine()
    submit(cut)
    for _ in range(FAIL_AFTER):
        cut.step()
    torch.cuda.synchronize()
    # what snapshot() does first, timed apart: finish in-flight prefills
    t0 = time.perf_counter()
    draining = len(cut.prefilling)
    if draining:
        cut._pump_prefill(None)
    torch.cuda.synchronize()
    t_drain = time.perf_counter() - t0
    t0 = time.perf_counter()
    blob = cut.snapshot()
    t_snap = time.perf_counter() - t0
    in_flight = sum(r is not None for r in cut.slot_req)
    del cut
    gc.collect()
    resumed = engine()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed.restore(blob)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    resumed.run()
    got = [resumed.requests[i].generated for i in range(len(prompts))]
    out = {"phase": "continuity", "arch": model.cfg.arch_id,
           "mode": "paged" if paged else "dense",
           "fail_after_steps": FAIL_AFTER, "slots_in_flight": in_flight,
           "prefills_drained": draining, "drain_s": t_drain,
           "blob_bytes": len(blob), "snapshot_s": t_snap,
           "restore_s": t_restore,
           "generated_tokens": sum(map(len, got)),
           "identical": got == want}
    log(out)
    if got != want:
        raise AssertionError(f"continuity ({out['mode']}): the restored "
                             f"engine's tokens differ from the "
                             f"uninterrupted run's")
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
    "decode_attention": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:113"),
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:139"),
    "selective_scan": ("cuda", "src/repro_torch/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:111"),
    "ssd": ("cuda", "src/repro_torch/csrc/ssd.cu",
            "src/repro/kernels/ssd.py:112"),
}
# the check row that stands for each (kernel, model) in the summary line:
# the decode step's block norm (d 4096, or zamba2's d 2048), the paged and
# the dense decode cases, the longest prefill chunk (q_offset 1280), the SSM
# kernels' prefill chunk from a nonzero state
SUMMARY_ROW = {
    "qwen3-8b": {"rmsnorm": ("rmsnorm", 0),
                 "paged_decode_attention": ("paged_decode_attention", 0),
                 "decode_attention": ("decode_attention", 0),
                 "flash_attention": ("flash_attention", 2)},
    "falcon-mamba-7b": {"rmsnorm": ("rmsnorm", 0),
                        "selective_scan": ("selective_scan", 1)},
    "zamba2-1.2b": {"rmsnorm": ("rmsnorm", 4),
                    "paged_decode_attention": (
                        "paged_decode_attention@zamba2", 0),
                    "decode_attention": ("decode_attention@zamba2", 0),
                    "flash_attention": ("flash_attention@zamba2", 2),
                    "ssd": ("ssd", 1)},
}


def run_model(arch: str) -> dict:
    """Serve, profile, logits, dense and continuity phases of one model at
    full width; its weights and caches are freed before returning."""
    import torch

    from repro_torch.configs import get
    from repro_torch.models import get_model

    model = get_model(get(arch))
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    log({"phase": "init", "arch": arch, "seconds": time.perf_counter() - t0,
         "weights_gb": sum(p.numel() * p.element_size()
                           for p in params.parameters()) / 1e9})
    serve = phase_serve(model, params)
    phase_profile(model, params)
    per_call = phase_logits(model, params)["launches_per_call"]
    dense = phase_dense(model, params, serve["tokens"])
    for paged in (True, False):
        phase_continuity(model, params, paged=paged)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    # each kernel's counts come from the path that runs it: the dense
    # decode from the dense serve, every other kernel from the paged one
    return {"paged": (serve["launches"], per_call["decode_step"],
                      per_call["prefill_chunk"]),
            "dense": (dense["launches"],
                      dense["launches_per_call"]["decode_step"],
                      dense["launches_per_call"]["prefill"])}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here, before any output,
    # when the script stands without the rest of the repo)

    # f32 products and convolutions in full f32 (the plain versions' SSM
    # einsums are f32): both defaults stated, not left to the install
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = phase_device()
    phase_build()
    checks = phase_kernels()

    kernels = []
    for arch, rows in SUMMARY_ROW.items():
        ran = run_model(arch)
        for name, (check, i) in rows.items():
            route, source, replaces = ROUTES[name]
            row = checks[check][i]
            path = "dense" if name == "decode_attention" else "paged"
            serve, per_step, per_prefill = ran[path]
            kernels.append({
                "name": name, "route": route, "source": source,
                "replaces": replaces, "model": arch, "path": path,
                "launches": serve[name],
                "launches_per_decode_step": per_step[name],
                "launches_per_prefill": per_prefill[name],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "x_library": row["x_library"], "x_bound": row["x_bound"],
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
