"""Smoke run of the PyTorch port on one NVIDIA H100.

Usage (from the root of a checkout, on a machine with the card):

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. device: prints the card's name and power limit (``nvidia-smi``);
2. build: compiles every kernel of the serving path from ``src/repro_torch``
   (one ``nvcc`` per CUDA source, all started together) and prints the
   seconds;
3. kernels: prints the launch floor (an empty kernel timed as every kernel
   is, and its host cost) and the host microseconds per launch of the
   ``rmsnorm`` and ``ssd`` wrappers; holds each hand-written kernel against its plain PyTorch
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
   2048-token dense prefill; the SSD's and the scan's whole calls bitwise
   equal to chained 256-step calls carrying the state, and their final
   states within 1e-4 of the plain f32 state's largest value; the scan also
   at N = 4 (falcon-mamba's REDUCED state size); RMSNorm also at the
   decode step's qk-norm shapes, each row bitwise the same alone as in its
   batch; the speculative verify (8 lanes, a window of 5, folded into the
   paged decode kernel), each query bitwise a single-token decode at its
   length; the paged decode step's row-invariant product (``gemm_rows``,
   no TPU counterpart) at each product of qwen3-8b's decode step, 8 and 40
   rows, beside cuBLAS and with the kernel's plan for it, and one step's
   products in all; at the batch tier's shapes (4 slots, 24-page pools,
   page tables of 16) RMSNorm, the paged decode (each lane bitwise the
   same alone) and ``gemm_rows`` at 4 rows;
3b. cli: ``repro_torch.launch.serve.main`` at its defaults (REDUCED
   configs, whose heads of 16 and 24 the attention wrappers pad to 64) for
   ``qwen3-8b``, ``zamba2-1.2b`` and ``falcon-mamba-7b``, without and with
   ``--fail-after 4``: every request completes, every kernel of the path
   is launched, the restored run gives the same tokens; qwen3-8b's card
   tokens are held against the CPU plain path teacher-forced on them
   (each within 0.05 of the CPU's top logit);
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
      printed;
   f. spill (qwen3-8b only, ``phase_spill``): the spill tier — cold prefix
      pages lent to two peers and recalled bit for bit, the spill engine's
      tokens equal to an engine's that retires nothing; both peers leave
      and the next round misses and recomputes; a lane preempted mid-decode
      with write-behind on resumes through the recall of its chain with
      the un-preempted tokens; every kernel of the paged path launched and
      no plain version called; ms per spilled and recalled page, per chain
      (whole and by part, on the engine's own path) and per decode step
      with write-behind on and off (median, and the window's time over its
      steps, off/on/on/off in turns) printed beside the card's name and
      power limit;
   g. spec (qwen3-8b only, ``phase_spec``): speculative decoding and
      ``fork`` — a, each decode product's rows bitwise the same at 1, 8,
      40, 64 and 80 rows through ``gemm_rows``, its counters left at zero
      (cuBLAS's verdicts printed); b, a
      self-draft engine (``spec_k`` 4) gives plain decode's tokens with
      every proposal accepted, every kernel of the path launched and no
      plain version, with the medians of a decode step, a draft step and a
      verify; c, the REDUCED pair (smollm-360m drafting) greedy and
      sampled, tokens equal plain's; d, a live slot forked into 3 sampled
      children; e, a speculating engine's snapshot restored with the
      uninterrupted tokens;
   h. batch (qwen3-8b only, ``phase_batch``): the verified batch tier
      (``repro_torch.serving.batch``) over the paged engine, the
      batch-churn scenario of ``benchmarks/batch_bench.py`` at full width:
      16 prompts of 64-448 tokens, 24 new tokens each, sharded into
      workunits replicated on 2 of 7 hosts and validated by bitwise hash
      quorum, each replica a fresh engine of ``make_engine_factory``
      (4 slots, 24-page pools). a, a clean job: completed with nothing
      re-issued, rejected or wasted; b, the same prompts under the seeded
      fault plan (crashes, a host slowed 8x, a corrupter): completed, a
      re-issue of every cause the plan produces, the corrupter outvoted
      once, a replica resumed from another replica's snapshot. Both jobs'
      results equal a trusted engine's of the same factory token for
      token, every kernel of the paged path launched and no plain version,
      and with the cyclic collector off the device memory after each job
      is back within one replica pool (0.25 GB) of before; wall seconds
      beside simulated ones, replica steps, tokens per wall second,
      snapshots, blob bytes, snapshot and restore seconds and peak memory
      printed beside the card's name and power limit.

The line two before the last is the kernels summary as JSON (one row per
kernel and model whose path runs it, and rows with ``"path": "spec"`` for
the speculative path and ``"path": "batch"`` for the batch tier), the line
before the last the card's
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
# the SSD's f32 contract (every f32 operand of a bf16 product split into
# hi + lo, ~16 bits kept): its final state within this share of the plain
# f32 state's largest value; operands left in plain bf16 miss it
SSD_STATE_REL = 1e-4
# the selective scan's final state: within this share of the plain f32
# state's largest value (the exponentials' ~2 ulp and the f32 sums' order)
SCAN_STATE_REL = 1e-4
L2_BYTES = 50 * 2 ** 20

# serving configuration of the smoke run
N_SLOTS, MAX_SEQ, PAGE, CHUNK = 8, 2048, 64, 256
# the batch tier's replica engines (``phase_batch``): 4 slots over a 24-page
# pool, a workunit's pages and the scratch page
BATCH_ENGINE = dict(n_slots=4, max_seq=1024, page_size=PAGE, n_pages=24)


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


def _rel_err(got, want) -> float:
    """Largest difference over the largest magnitude of ``want``."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def _kernels_us(fn, n: int = 20) -> dict:
    """Per kernel that ``fn`` launches: device microseconds per launch and
    launches per call (``torch.profiler`` over ``n`` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0]: {"us": e.self_device_time_total / e.count,
                                  "per_call": e.count / n}
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


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
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    t_nvcc = time.perf_counter() - t0
    for name, text in logs.items():
        saved = _build.BUILD / f"{name}.log"
        if not text and saved.exists():  # built earlier in this checkout
            text = saved.read_text()
        usage = [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
        log({"build": name, "ptxas": usage})
    # gemm_rows' ring is dynamic shared memory, which ptxas does not see
    from repro_torch.kernels import gemm_rows as gk
    log({"build": "gemm_rows", "dynamic_smem_bytes": {
        f"bk {bk}, tile {64 * wg}": gk._lib().gemm_rows_smem(bk, wg)
        for bk in (32, 64) for wg in (1, 2)}})
    log({"phase": "build", "nvcc_s": round(t_nvcc, 3)})


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------


def _host_us(fn, n: int = 1000) -> dict:
    """Host cost of one launch through ``fn``: a host clock over ``n``
    enqueues (after a warm-up), then one synchronise. ``host_us`` is the
    clock before the synchronise over ``n``; ``wall_us`` includes it (equal
    when the device kept up with the host)."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"host_us": (t1 - t0) / n * 1e6, "wall_us": (t2 - t0) / n * 1e6,
            "n": n}


def phase_floor(gen) -> dict:
    """The launch floor of ``_time_ms`` (an empty kernel timed the same
    way, and its host cost through ``ctypes``), and the host cost per launch
    of the ``rmsnorm`` wrapper (the decode step's (8, 4096) block norm) and
    of the ``ssd`` wrapper (zamba2's prefill chunk), and of the
    ``gemm_rows`` wrapper beside ``torch.matmul`` (a decode product)."""
    import torch

    from repro_torch.kernels import gemm_rows as gk, rmsnorm as rk

    dev = torch.device("cuda")
    x, w = _rmsnorm_case(gen, (N_SLOTS, 4096))
    args = _ssd_case(gen, CHUNK, 0.1)
    # the decode step's k product (8 rows, 4096 -> 1024): the row-invariant
    # product's wrapper against cuBLAS's torch.matmul, host side
    xk = torch.randn(N_SLOTS, 4096, generator=gen, device="cuda").bfloat16()
    wk = torch.randn(4096, 1024, generator=gen, device="cuda").bfloat16()
    out = {"phase": "floor",
           "empty_kernel_ms": _time_ms(lambda: rk.empty_launch(dev)),
           "host_per_launch": {
               "empty_kernel": _host_us(lambda: rk.empty_launch(dev)),
               **_wrapper_host_us(x, w, args),
               "gemm_rows": _host_us(lambda: gk.gemm_rows(xk, wk)),
               "torch.matmul": _host_us(lambda: torch.matmul(xk, wk))}}
    host = out["host_per_launch"]
    out["gemm_rows_host_le_matmul"] = \
        host["gemm_rows"]["host_us"] <= host["torch.matmul"]["host_us"]
    log(out)
    return out


def _wrapper_host_us(x, w, ssd_args) -> dict:
    """Host cost per call of the ``rmsnorm`` and ``ssd`` wrappers (300 SSD
    calls: two launches each stay within the device's launch queue)."""
    from repro_torch.kernels import rmsnorm as rk, ssd as dk

    return {"rmsnorm": _host_us(lambda: rk.rmsnorm(x, w, 1e-6)),
            "ssd": _host_us(lambda: dk.ssd(*ssd_args, chunk=CHUNK), n=300)}


def _rmsnorm_case(gen, shape):
    import torch

    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
    return x, w


# RMSNorm's check shapes: the block norms of qwen3-8b / falcon-mamba (d 4096)
# and of zamba2 (d 2048; its gate norm is d_inner 4096) at the decode step
# (8 rows) and a prefill chunk (256); qwen3's qk-norm rows (q: 32 heads,
# k: 8 kv heads of 128) over a chunk, then at the decode step
RMSNORM_SHAPES = [(N_SLOTS, 4096), (CHUNK, 4096), (CHUNK * 32, 128),
                  (CHUNK * 8, 128), (N_SLOTS, 2048), (CHUNK, 2048),
                  (N_SLOTS * 32, 128), (N_SLOTS * 8, 128)]
# the batch tier's decode step (4 slots): block norm, q and k norms
BATCH_RMSNORM_SHAPES = [(4, 4096), (4 * 32, 128), (4 * 8, 128)]


def check_rmsnorm(gen, shapes=RMSNORM_SHAPES) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref, rmsnorm as rk

    rows = []
    for shape in shapes:
        x, w = _rmsnorm_case(gen, shape)
        got = rk.rmsnorm(x, w, 1e-6)
        with ops.use_backend("plain"):
            want = ops.rmsnorm(x, w, 1e-6)
        err = _close(got, want, f"rmsnorm {shape}")
        # a row's bits do not depend on the rows beside it: the first row
        # alone, the first 8 alone, the last row alone
        for sl in (slice(0, 1), slice(0, 8), slice(shape[0] - 1, None)):
            if not torch.equal(rk.rmsnorm(x[sl].clone(), w, 1e-6), got[sl]):
                raise AssertionError(f"rmsnorm {shape}: rows {sl} differ "
                                     f"from the same rows in the batch")
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


def check_paged_decode_batch(gen) -> dict:
    """The paged decode at the batch tier's shape (``phase_batch``): 4
    lanes of a workunit (prompt plus generated positions up to 472) in a
    24-page pool, page tables of 16 (``max_seq`` 1024): against the plain
    version, two runs bitwise equal, and each lane bitwise the same alone
    as in its batch — what bitwise hash quorum across replicas rests on."""
    import torch

    from repro_torch.kernels import ops, paged_decode_attention as pk

    lengths = [88, 300, 472, 150]
    B, H, K, D = len(lengths), 32, 8, 128
    n_pages, width = BATCH_ENGINE["n_pages"], BATCH_ENGINE["max_seq"] // PAGE
    q = torch.randn(B, H, D, generator=gen, device="cuda").bfloat16()
    kp = torch.randn(n_pages, PAGE, K, D, generator=gen,
                     device="cuda").bfloat16()
    vp = torch.randn(n_pages, PAGE, K, D, generator=gen,
                     device="cuda").bfloat16()
    pages = (torch.randperm(n_pages - 1, generator=torch.Generator()
                            .manual_seed(B)) + 1).tolist()
    table = torch.zeros(B, width, dtype=torch.int32)
    for i, n in enumerate(lengths):
        need = -(-n // PAGE)
        table[i, :need] = torch.tensor(pages[:need])
        pages = pages[need:]
    table = table.cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = pk.paged_decode_attention(q, kp, vp, table, lens)
    with ops.use_backend("plain"):
        want = ops.paged_decode_attention(q, kp, vp, table, lens)
    err = _close(got, want, "paged_decode_attention (batch)")
    if not torch.equal(got, pk.paged_decode_attention(q, kp, vp, table,
                                                      lens)):
        raise AssertionError("paged decode (batch): two runs differ")
    for i in range(B):
        alone = pk.paged_decode_attention(q[i:i + 1], kp, vp, table[i:i + 1],
                                          lens[i:i + 1])
        if not torch.equal(alone[0], got[i]):
            raise AssertionError(f"paged decode (batch): lane {i} changed "
                                 f"with its batch")
    n_keys = int(lens.sum())
    nbytes = (n_keys * K * D * 2 * 2 + 2 * q.numel() * 2
              + table.numel() * 4 + lens.numel() * 4)
    return {
        "shape": {"B": B, "H": H, "K": K, "D": D, "P": PAGE,
                  "pages": n_pages, "table": width, "lengths": lengths},
        "max_abs_err": err,
        "ms": _time_ms(lambda: pk.paged_decode_attention(q, kp, vp, table,
                                                         lens), flush=True),
        "plain_ms": _time_ms(lambda: pk.plain(q, kp, vp, table, lens),
                             flush=True),
        "library_ms": None, **_bound(nbytes, 4 * n_keys * H * D, F32_FLOPS),
    }


def check_paged_verify(gen, k: int = 4) -> dict:
    """The speculative verify at qwen3-8b's shape: 8 lanes, a window of
    k + 1, folded into the paged decode kernel (``ops.paged_verify_attention``
    on the card): against the plain version, and each window query bitwise
    equal to a single-token paged decode at its own length."""
    import torch

    from repro_torch.kernels import ops, ref

    W = k + 1
    lengths = [1, 63, 64, 65, 2047 - W, 700, 1300, 0]
    _, kp, vp, table, lens = _paged_case(gen, lengths)
    B, H, D, K = len(lengths), 32, kp.shape[3], kp.shape[2]
    q = torch.randn(B, W, H, D, generator=gen, device="cuda").bfloat16()
    got = ops.paged_verify_attention(q, kp, vp, table, lens)
    want = ref.paged_verify_attention(q, kp, vp, table, lens)
    err = _close(got, want, "paged verify")
    for j in range(W):
        step = ops.paged_decode_attention(q[:, j].contiguous(), kp, vp,
                                          table, lens + j + 1)
        if not torch.equal(step, got[:, j]):
            raise AssertionError(f"paged verify: query {j} differs from a "
                                 f"decode at its length")
    # each lane's pages once (its window reads the same keys), q and out
    n_keys = int(lens.sum()) + B * W
    nbytes = (n_keys * K * D * 2 * 2 + 2 * q.numel() * 2
              + table.numel() * 4 + B * 4)
    flops = 4 * H * D * sum(int(n) * W + W * (W + 1) // 2 for n in lengths)
    return {
        "shape": {"B": B, "W": W, "H": H, "K": K, "D": D, "P": PAGE,
                  "positions": lengths},
        "max_abs_err": err,
        "ms": _time_ms(lambda: ops.paged_verify_attention(
            q, kp, vp, table, lens), flush=True),
        "plain_ms": _time_ms(lambda: ref.paged_verify_attention(
            q, kp, vp, table, lens), flush=True),
        "library_ms": None, **_bound(nbytes, flops, F32_FLOPS),
    }


def check_gemm_rows(gen, arch: str = "qwen3-8b") -> list[dict]:
    """The paged decode step's row-invariant product at each of its shapes
    (full-width ``arch``), at the decode step's 8 rows and a k = 4 verify's
    40: against the plain version (``x @ w``), each timed with L2 flushed
    (a step finds its weights cold) beside cuBLAS's ``torch.matmul``, and
    at the batch tier's 4 rows (``phase_batch``), with
    the kernel's plan for it (tile width, k step, work items, K segments,
    ring depth); then one decode step's and one verify's products in all
    (36 layers of seven and the unembedding), with their bounds."""
    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import gemm_rows as gk, ops

    cfg = get(arch)
    rows, steps = [], {}
    for M in (BATCH_ENGINE["n_slots"], N_SLOTS, N_SLOTS * 5):
        step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
                "flops": 0, "max_abs_err": 0.0}
        for name, K, N, nk in gk.decode_products(cfg):
            w = (torch.randn(N, K, generator=gen, device="cuda")
                 * K ** -0.5).bfloat16()
            w = w.t() if nk else w.reshape(K, N)
            x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
            got = gk.gemm_rows(x, w)
            with ops.use_backend("plain"):
                want = ops.gemm_rows(x, w)
            err = _close(got, want, f"gemm_rows {name} M={M}")
            nbytes = 2 * (K * N + M * K + M * N)
            p = gk.plan(K, N, nk, gk._n_sm(torch.cuda.current_device()))
            row = {"shape": {"M": M, "K": K, "N": N, "product": name},
                   "plan": {"tile_n": p.bn, "bk": p.bk, "items": p.items,
                            "grid": p.grid, "segments": p.s_base,
                            "tiles_with_one_more": p.extra,
                            "stages": p.stages},
                   "max_abs_err": err,
                   "ms": _time_ms(lambda: gk.gemm_rows(x, w), flush=True),
                   "plain_ms": _time_ms(lambda: gk.plain(x, w), flush=True),
                   "library_ms": _time_ms(lambda: torch.matmul(x, w),
                                          flush=True),
                   **_bound(nbytes, 2 * M * K * N, BF16_TC_FLOPS)}
            rows.append(row)
            times = 1 if name == "unembed" else cfg.n_layers
            for key in ("ms", "plain_ms", "library_ms"):
                step[key] += times * row[key]
            step["bytes"] += times * nbytes
            step["flops"] += times * 2 * M * K * N
            step["max_abs_err"] = max(step["max_abs_err"], err)
            del w, x
        steps[M] = step
    for M, step in steps.items():
        rows.append({"shape": {"M": M, "products": "one step", "arch": arch,
                               "layers": cfg.n_layers},
                     "max_abs_err": step["max_abs_err"], "ms": step["ms"],
                     "plain_ms": step["plain_ms"],
                     "library_ms": step["library_ms"],
                     **_bound(step["bytes"], step["flops"], BF16_TC_FLOPS)})
    return rows


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


def _scan_case(gen, S: int, h0_scale: float, *, B=1, Di=8192, N=16):
    """falcon-mamba's scan inputs over S steps: x, dt, A, Bm, C, D, h0."""
    import torch

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    return ((rnd(B, S, Di, scale=0.5)).bfloat16(),
            (0.1 * rnd(B, S, Di).abs()).bfloat16(),
            -(rnd(Di, N).abs() + 0.1),
            rnd(B, S, N, scale=0.5).bfloat16(),
            rnd(B, S, N, scale=0.5).bfloat16(),
            rnd(Di), rnd(B, Di, N, scale=h0_scale))


def check_selective_scan(gen) -> list[dict]:
    """falcon-mamba's prefill chunk (S = 256, Di = 8192, N = 16) from a zero
    and from a nonzero state, a ragged S = 200, a whole dense prefill
    (S = 2048 from a zero state), S = 600 over three tiles, and the chunk
    at N = 4 (the REDUCED config's state size); y (bf16) and hT (f32), hT
    also within 1e-4 of the plain f32 state's largest value. S = 600 and
    2048 are also run as chained 256-step calls, which must give the same
    bits."""
    import torch

    from repro_torch.kernels import ops, selective_scan as sk

    rows = []
    for S, h0_scale, N in ((CHUNK, 0.0, 16), (CHUNK, 0.1, 16), (200, 0.1, 16),
                           (MAX_SEQ, 0.0, 16), (600, 0.1, 16),
                           (CHUNK, 0.1, 4)):
        args = _scan_case(gen, S, h0_scale, N=N)
        x, dt, A, Bm, C, D, h0 = args
        B, _, Di = x.shape
        y, hT = sk.selective_scan(*args)
        with ops.use_backend("plain"):
            yw, hw = ops.selective_scan(*args)
        what = f"selective_scan S={S} N={N} h0*{h0_scale}"
        err = max(_close(y, yw, what), _close(hT, hw, what + " hT", STATE_TOL))
        rel = _rel_err(hT, hw)
        if not rel <= SCAN_STATE_REL:
            raise AssertionError(f"{what}: hT off the f32 plain state by "
                                 f"{rel:.3g} of its largest value, over "
                                 f"{SCAN_STATE_REL}")
        chained = None
        if S > CHUNK:
            yc, hc = _chained(sk.selective_scan, args)
            chained = torch.equal(yc, y) and torch.equal(hc, hT)
            if not chained:
                raise AssertionError(f"{what}: one call and chained "
                                     f"{CHUNK}-step calls differ bitwise")
        nbytes = (3 * B * S * Di * 2 + 2 * B * S * N * 2 + Di * N * 4 + Di * 4
                  + 2 * B * Di * N * 4)
        # per (t, d, n): dt*A, exp, two products and an add for h, an FMA
        # into y; per (t, d): dt*x and D*x + y
        n_sn = B * S * Di * N
        rows.append({
            "shape": {"B": B, "S": S, "Di": Di, "N": N, "h0": h0_scale},
            "max_abs_err": err, "hT_rel_err": rel, "chained_equal": chained,
            "ms": _time_ms(lambda: sk.selective_scan(*args), flush=True),
            "plain_ms": _time_ms(lambda: sk.plain(*args), iters=3,
                                 flush=True),
            "library_ms": None,
            **_bound(nbytes, 6 * n_sn + 3 * B * S * Di, F32_FLOPS, exps=n_sn),
        })
    return rows


def _ssd_case(gen, S: int, h0_scale: float, *, B=1, Hs=64, P=64, N=64):
    """zamba2's SSD inputs over S steps: x, dt, A, Bm, C, D, h0."""
    import torch

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    return ((rnd(B, S, Hs, P, scale=0.5)).bfloat16(),
            (0.1 * rnd(B, S, Hs).abs()).bfloat16(),
            -(rnd(Hs).abs() + 0.1),
            rnd(B, S, N, scale=0.5).bfloat16(),
            rnd(B, S, N, scale=0.5).bfloat16(),
            rnd(Hs), rnd(B, Hs, P, N, scale=h0_scale))


def _chained(fn, args, chunk: int = CHUNK):
    """An SSM kernel ``fn`` (``x, dt, A, Bm, C, D, h0 -> y, hT``) over
    ``chunk``-step calls, each carrying hT into the next h0, as the paged
    engine's chunked prefill runs it."""
    import torch

    x, dt, A, Bm, C, D, h = args
    ys = []
    for t0 in range(0, x.shape[1], chunk):
        t1 = t0 + chunk
        y, h = fn(x[:, t0:t1], dt[:, t0:t1], A, Bm[:, t0:t1], C[:, t0:t1], D,
                  h)
        ys.append(y)
    return torch.cat(ys, 1), h


def check_ssd(gen) -> list[dict]:
    """zamba2's prefill chunk (S = c = 256, Hs = 64, P = 64, N = 64) from a
    zero and from a nonzero state, a ragged S = 200, S = 600 over three
    chunks, and a whole dense prefill (S = 2048, eight chunks, from a zero
    state); y (bf16) and hT (f32). S = 600 and 2048 are also run as chained
    256-step calls, which must give the same bits."""
    import torch

    from repro_torch.kernels import ops, ssd as dk

    rows = []
    for S, h0_scale in ((CHUNK, 0.0), (CHUNK, 0.1), (200, 0.1), (600, 0.1),
                        (MAX_SEQ, 0.0)):
        args = _ssd_case(gen, S, h0_scale)
        B, _, Hs, P = args[0].shape
        N = args[3].shape[-1]
        y, hT = dk.ssd(*args, chunk=CHUNK)
        with ops.use_backend("plain"):
            yw, hw = ops.ssd(*args, chunk=CHUNK)
        what = f"ssd S={S} h0*{h0_scale}"
        err = max(_close(y, yw, what), _close(hT, hw, what + " hT", STATE_TOL))
        rel = _rel_err(hT, hw)
        if not rel <= SSD_STATE_REL:
            raise AssertionError(f"{what}: hT off the f32 plain state by "
                                 f"{rel:.3g} of its largest value, over "
                                 f"{SSD_STATE_REL}")
        chained = None
        if S > CHUNK:
            yc, hc = _chained(lambda *a: dk.ssd(*a, chunk=CHUNK), args)
            chained = torch.equal(yc, y) and torch.equal(hc, hT)
            if not chained:
                raise AssertionError(f"{what}: one call and chained "
                                     f"{CHUNK}-step calls differ bitwise")
        nbytes = (2 * B * S * Hs * P * 2 + B * S * Hs * 2 + 2 * B * S * N * 2
                  + 2 * Hs * 4 + 2 * B * Hs * P * N * 4)
        # per chunk of n steps: C B^T once for all heads (n(n+1)/2 pairs x
        # N FMAs); per head the masked product with x (pairs x P), the
        # carried state's read and update (2 n P N), the decay mask
        chunks = [min(CHUNK, S - c0) for c0 in range(0, S, CHUNK)]
        pairs = sum(n * (n + 1) // 2 for n in chunks)
        flops = B * (2 * pairs * N + Hs * (2 * pairs * P + 3 * pairs
                                           + 4 * S * P * N))
        exps = B * Hs * (pairs + 2 * S)
        # the least time on the tensor cores (bf16 peak), and the same work
        # on the f32 units outside them (``bound_f32_ms``)
        f32 = _bound(nbytes, flops, F32_FLOPS, exps=exps)
        rows.append({
            "shape": {"B": B, "S": S, "Hs": Hs, "P": P, "N": N,
                      "chunk": CHUNK, "h0": h0_scale},
            "max_abs_err": err, "hT_rel_err": rel, "chained_equal": chained,
            "ms": _time_ms(lambda: dk.ssd(*args, chunk=CHUNK), flush=True),
            "kernels_us": _kernels_us(lambda: dk.ssd(*args, chunk=CHUNK)),
            "plain_ms": _time_ms(lambda: dk.plain(*args, chunk=CHUNK),
                                 flush=True),
            "library_ms": None,
            **_bound(nbytes, flops, BF16_TC_FLOPS, exps=exps),
            "bound_f32_ms": f32["bound_ms"], "bound_f32_by": f32["bound_by"],
        })
    return rows


def phase_kernels(seed: int = 0) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    phase_floor(gen)
    out = {"rmsnorm": check_rmsnorm(gen),
           "paged_decode_attention": [check_paged_decode(gen)],
           "decode_attention": [check_decode(gen)],
           "flash_attention": check_flash(gen),
           "paged_verify": [check_paged_verify(gen)],
           "gemm_rows": check_gemm_rows(gen),
           "selective_scan": check_selective_scan(gen),
           "ssd": check_ssd(gen),
           # zamba2's shared attention block: D = 64, H = K = 32 (G = 1)
           "paged_decode_attention@zamba2": [
               check_paged_decode(gen, n_heads=32, n_kv=32, d=64)],
           "decode_attention@zamba2": [
               check_decode(gen, n_heads=32, n_kv=32, d=64)],
           "flash_attention@zamba2": check_flash(gen, H=32, K=32, D=64),
           # the batch tier's decode step: 4 slots, 24-page pools
           "rmsnorm@batch": check_rmsnorm(gen, BATCH_RMSNORM_SHAPES),
           "paged_decode_attention@batch": [check_paged_decode_batch(gen)]}
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
    "qwen3-8b": ("rmsnorm", "paged_decode_attention", "flash_attention",
                 "gemm_rows"),
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


def _teacher_forced(model, params, prompts, forced, n_steps: int, *,
                    device: str = "cuda"):
    """Prefill each prompt (one slot each), then ``n_steps`` batched decode
    steps feeding ``forced`` tokens; returns the logits of every step
    (prefill's first-token logits first) and the launches per call."""
    import torch

    from repro_torch.kernels import ops

    B = len(prompts)
    max_pages = MAX_SEQ // PAGE
    cache = model.init_paged_cache(B, B * max_pages + 1, PAGE, device=device)
    table = torch.zeros(B, max_pages, dtype=torch.int32, device=device)
    for b in range(B):
        table[b] = torch.arange(1 + b * max_pages, 1 + (b + 1) * max_pages)
    rows, per_call = [], {}
    first = []
    for b, p in enumerate(prompts):
        for off in range(0, len(p), CHUNK):
            n = min(CHUNK, len(p) - off)
            toks = torch.zeros(1, CHUNK, dtype=torch.int32, device=device)
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
                       device=device)
    for s in range(n_steps):
        toks = torch.tensor([[forced[b][s]] for b in range(B)],
                            dtype=torch.int32, device=device)
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
                "selective_scan": "selective_scan", "ssd": "ssd",
                "gemm_rows": "gemm_rows"}
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
# 8. the CLI at its defaults: REDUCED configs on the card
# ---------------------------------------------------------------------------

CLI_ARCHS = ("qwen3-8b", "zamba2-1.2b", "falcon-mamba-7b")
# qwen3-8b's card tokens against the CPU plain path's logits at the same
# positions: each within this of the CPU's top logit (a bf16 near-tie)
CLI_TIE_GAP = 0.05


def phase_cli(arch: str) -> dict:
    """``python -m repro_torch.launch.serve --arch ARCH`` at its defaults
    (REDUCED config, cuda, 8 requests of 8 tokens, 12 new tokens each),
    then again with ``--fail-after 4``. Every request must complete, every
    kernel of the path must be launched in each run (counted from 0 just
    before it) and no plain version called, and the restored run's tokens
    must equal the uninterrupted run's. For qwen3-8b the port's plain path
    on the CPU, with the same weights, is teacher-forced on the card's
    tokens: each card token within ``CLI_TIE_GAP`` of the CPU's top logit
    at its position; the exact argmax matches are counted."""
    import contextlib
    import io

    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import get_model

    runs, out = {}, {"phase": "cli", "arch": arch}
    for name, extra in (("whole", []), ("fail_after_4", ["--fail-after", "4"])):
        ops.reset_counts()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            done = serve.main(["--arch", arch, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.counts()
        if len(done) != 8 or not all(r.done for r in done):
            raise AssertionError(f"cli {arch} {name}: {len(done)}/8 requests "
                                 f"completed")
        _check_counts(counts, PATH_KERNELS[arch], f"cli {arch} {name}")
        runs[name] = sorted(done, key=lambda r: r.req_id)
        out[name] = {"wall_s": wall, "last_line": printed.getvalue(
            ).strip().splitlines()[-1],
            "launches": {n: c["launches"] for n, c in counts.items()}}
    whole = [r.generated for r in runs["whole"]]
    out["restored_equal"] = whole == [r.generated for r in runs["fail_after_4"]]
    if not out["restored_equal"]:
        raise AssertionError(f"cli {arch}: --fail-after 4 changed the tokens")
    if arch == "qwen3-8b":
        model = get_model(get(arch, reduced=True))
        params = model.init(0, device="cuda").to("cpu")   # the CLI's weights
        prompts = [r.prompt for r in runs["whole"]]
        n_new = {len(g) for g in whole}
        if len(n_new) != 1:
            raise AssertionError(f"cli {arch}: ragged generations {n_new}")
        n = n_new.pop()
        logits, _ = _teacher_forced(model, params, prompts,
                                    [g[:-1] for g in whole], n - 1,
                                    device="cpu")       # (n, 8, vocab)
        card = torch.tensor(whole).T                    # (n, 8)
        picked = logits.gather(-1, card[..., None])[..., 0]
        gap = logits.amax(-1) - picked
        out.update({"cpu_tokens": int(card.numel()),
                    "argmax_matches": int((logits.argmax(-1) == card).sum()),
                    "max_tie_gap": float(gap.max()), "bound": CLI_TIE_GAP})
        if not float(gap.max()) <= CLI_TIE_GAP:
            raise AssertionError(f"cli {arch}: a card token sits "
                                 f"{float(gap.max()):.4g} below the CPU's top "
                                 f"logit (bound {CLI_TIE_GAP})")
    log(out)
    return out


# ---------------------------------------------------------------------------
# 9. spill: lend cold pages to peers, recall them, resume a preempted slot
# ---------------------------------------------------------------------------

# scenario A: 4 prefixes of 512 tokens (8 pages), each followed by 2
# requests with a random 64-token suffix and 16 new tokens, over 2 rounds
SPILL_PREFIXES, SPILL_PREFIX, SPILL_SUFFIX, SPILL_NEW = 4, 512, 64, 16
# a request holds ceil((512 + 64 + 16) / 64) = 10 pages; two of one prefix
# at once hold 8 shared + 2 + 2 = 12, and a finished prefix leaves 10 pages
# in the trie (its 8 pages and each request's full suffix page): a pool of
# 12 + 10 usable pages keeps at most two prefixes resident
SPILL_POOL = 1 + 12 + 10
# scenario C: 4 requests of 300-700 prompt tokens, 200 new tokens each, one
# lane preempted after 100 decode steps
RESUME_LENS, RESUME_NEW, RESUME_AFTER = (300, 701), 200, 100


def _cloudlet_pool():
    """``h0``'s remote pool over peers ``h1`` and ``h2`` of one cloudlet,
    ranked by a reliability registry."""
    from repro_torch.core import CloudletRegistry, ReliabilityRegistry
    from repro_torch.serving.kvcache import RemotePagePool

    reg = CloudletRegistry()
    reg.create("serve", "qwen3-8b")
    reg.join("serve", "h0")
    rel = ReliabilityRegistry()
    for h in ("h1", "h2"):
        reg.join("serve", h)
        rel.add_host(h)
    return reg, RemotePagePool(reg, "serve", "h0", reliability=rel)


def _spill_round(engines: dict, prompts: list) -> dict:
    """Serve ``prompts`` (pairs sharing a prefix, pair by pair) on every
    engine; returns each engine's tokens."""
    out = {}
    for name, eng in engines.items():
        toks = []
        for i in range(0, len(prompts), 2):
            reqs = [eng.submit(p, max_new_tokens=SPILL_NEW)
                    for p in prompts[i:i + 2]]
            eng.run()
            toks += [r.generated for r in reqs]
        out[name] = toks
    return out


def _tie_check(model, params, prompts, a: list, b: list) -> int:
    """Where two engines' greedy streams differ, each stream is
    teacher-forced through the model and each of its tokens must lie within
    ``CLI_TIE_GAP`` of the top logit at its position (``phase_cli``'s
    rule). Returns the number of requests that differ."""
    import torch

    differ = 0
    for p, x, y in zip(prompts, a, b):
        if x == y:
            continue
        differ += 1
        for toks in (x, y):
            logits, _ = _teacher_forced(model, params, [p], [toks[:-1]],
                                        len(toks) - 1)
            picked = logits[:, 0].gather(-1, torch.tensor(
                toks, device=logits.device)[:, None])[:, 0]
            gap = float((logits[:, 0].amax(-1) - picked).max())
            if not gap <= CLI_TIE_GAP:
                raise AssertionError(f"spill: a token sits {gap:.4g} below "
                                     f"the top logit (bound {CLI_TIE_GAP})")
    return differ


def _watch_spilled_pages(engine) -> dict:
    """Follow the pages the engine lends: a device copy of a page's bits
    when its trie node becomes a stub, and, when the stub is recalled,
    whether the page it lands in holds the same bits (counted)."""
    import torch

    idx = engine.prefix_index
    seen = {"stubs": {}, "recalled": 0, "equal": 0}
    remap = idx.remap

    def spy(old: int, new: int) -> None:
        if old < engine.n_pages <= new:            # lent
            seen["stubs"][new] = {k: v[:, old].clone()
                                  for k, v in engine.cache.items()
                                  if k.endswith("_pages")}
        elif new < engine.n_pages <= old:          # recalled, installed
            bits = seen["stubs"].pop(old)
            seen["recalled"] += 1
            seen["equal"] += all(
                torch.equal(engine.cache[k][:, new].view(torch.int16),
                            b.view(torch.int16)) for k, b in bits.items())
        remap(old, new)

    idx.remap = spy
    return seen


def _page_costs(engine, pages: list[int]) -> dict:
    """Milliseconds per page to spill (extract + lend) and to recall
    (recall + deserialize + install) the chain ``pages`` of ``engine``'s
    cache, one page per call and all pages in one call, against a remote
    pool of its own; the lent payloads are held until the chain is
    recalled, as a preempted chain's are. Each page's own payload is
    written back, so the cache is unchanged. Medians of 5 passes, the two
    ways in turns."""
    import torch

    from repro_torch.serving.kvcache import (
        extract_page_payload,
        extract_page_payloads,
        install_page_payloads,
    )

    _, remote = _cloudlet_pool()
    cache, n = engine.cache, len(pages)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n, out

    def spill(batched: bool) -> list[int]:
        blobs = (extract_page_payloads(cache, pages) if batched
                 else [extract_page_payload(cache, p) for p in pages])
        return [remote.lend(b).lease_id for b in blobs]

    def recall(lids: list[int], batched: bool) -> None:
        if batched:
            got, _ = remote.recall(lids)
            install_page_payloads(cache, pages, [got[i] for i in lids])
            return
        for p, lid in zip(pages, lids):
            got, _ = remote.recall([lid])
            install_page_payloads(cache, [p], [got[lid]])

    ms = {(w, b): [] for w in ("spill", "recall") for b in (False, True)}
    for _ in range(5):
        for batched in (False, True):
            t, lids = timed(lambda: spill(batched))
            ms["spill", batched].append(t)
            t, _ = timed(lambda: recall(lids, batched))
            ms["recall", batched].append(t)
    assert remote.lent == 0
    return {"pages": n} | {
        f"{w}_ms_per_page_{'batched' if b else 'single'}":
            statistics.median(v) for (w, b), v in ms.items()}


class _SpillParts:
    """Host ms of the spill path's parts, timed on the engine's own path:
    the device gather of the pages (``gather``), their copy into
    page-locked host memory (``to_host``), each blob's serialization
    (``serialize``) and the lend (``lend``); on a recall the pool's recall
    (``recall``), stacking the payloads in page-locked memory (``stack``)
    and the host-to-device copy with its ``index_copy_`` (``scatter``).
    Each wrapped call runs between two device syncs and adds its time and
    its page count to the part under the current window (:meth:`window`);
    outside a window a call is not timed. :meth:`close` unwraps."""

    def __init__(self, remote) -> None:
        from repro_torch.serving import kvcache

        self.label = None
        self.ms: dict = {}
        self.pages: dict = {}
        # part: (owner, attribute, pages handled by one call)
        targets = {"gather": (kvcache, "_gather_pages", lambda a: len(a[1])),
                   "to_host": (kvcache, "_copy_to_host",
                               lambda a: a[0].shape[0]),
                   "serialize": (kvcache, "serialize_tree", lambda a: 1),
                   "lend": (remote, "lend", lambda a: 1),
                   "recall": (remote, "recall", lambda a: len(a[0])),
                   "stack": (kvcache, "_stack_payloads", lambda a: len(a[1])),
                   "scatter": (kvcache, "_scatter_pages",
                               lambda a: len(a[1]))}
        self._undo = []
        for part, (owner, name, count) in targets.items():
            fn = getattr(owner, name)
            self._undo.append((owner, name, fn))
            setattr(owner, name, self._timed(part, fn, count))

    def _timed(self, part: str, fn, count):
        import torch

        def timed(*args, **kw):
            if self.label is None:
                return fn(*args, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            key = (self.label, part)
            self.ms[key] = self.ms.get(key, 0.0) + (
                time.perf_counter() - t0) * 1e3
            self.pages[key] = self.pages.get(key, 0) + count(args)
            return out
        return timed

    def window(self, label: str):
        """A context in which the parts' times add up under ``label``."""
        import contextlib

        @contextlib.contextmanager
        def ctx():
            prev, self.label = self.label, label
            try:
                yield
            finally:
                self.label = prev
        return ctx()

    def close(self) -> None:
        for owner, name, fn in self._undo:
            setattr(owner, name, fn)

    def report(self) -> dict:
        """Per window: each part's total ms and the pages it handled."""
        out: dict = {}
        for (label, part), ms in self.ms.items():
            out.setdefault(label, {})[part] = {
                "ms": ms, "pages": self.pages[label, part]}
        return out


def _resume_run(model, params, prompts, *, write_behind: bool,
                preempt: bool) -> dict:
    """Scenario C's serve: decode-step times (median, and the decode
    steps' whole time over their count), tokens and counters; with
    ``preempt`` one lane is preempted after ``RESUME_AFTER`` decode steps,
    and the times of that preemption and of its recall are taken, whole
    and by part (:class:`_SpillParts`)."""
    import torch

    from repro_torch.serving.engine import ServeEngine

    reg, remote = _cloudlet_pool()
    engine = ServeEngine(model, params, n_slots=4, max_seq=MAX_SEQ,
                         page_size=PAGE, prefill_chunk=CHUNK,
                         remote_pool=remote, recall_budget=16,
                         write_behind=write_behind, device="cuda")
    reqs = [engine.submit(p, max_new_tokens=RESUME_NEW) for p in prompts]
    timing: dict = {}
    admit = engine._try_admit_recall
    parts = _SpillParts(remote) if preempt else None
    if parts is not None:
        # outside the chain's spill and recall: write-behind staging and
        # lends of retired prefix pages, inside decode steps
        parts.label = "in_steps"

    def timed_recall(slot, req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with parts.window("chain_recall"):
            got = admit(slot, req)
        torch.cuda.synchronize()
        timing["chain_recall_ms"] = (time.perf_counter() - t0) * 1e3
        timing["chain_recall_pages"] = engine.stats["pages_recalled"]
        return got

    if preempt:
        engine._try_admit_recall = timed_recall
    steps, staged_ms, plain_ms = 0, [], []
    while engine.pending():
        staged = engine.stats["pages_staged"]
        s0 = time.perf_counter()
        n_active = engine.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - s0) * 1e3
        if n_active and engine.last_step_tokens == n_active:  # decode only
            steps += 1
            (staged_ms if engine.stats["pages_staged"] > staged
             else plain_ms).append(dt)
        if preempt and steps == RESUME_AFTER and "victim" not in timing:
            victim = max((r for r in reqs if r.slot is not None
                          and r.slot not in engine.prefilling),
                         key=lambda r: len(r.prompt))
            timing["victim"] = victim.req_id
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with parts.window("chain_spill"):
                engine.preempt(victim.req_id)
            torch.cuda.synchronize()
            timing["chain_spill_ms"] = (time.perf_counter() - t0) * 1e3
            timing["chain_spill_len"] = victim.spill_len
    if parts is not None:
        parts.close()
        timing["parts"] = parts.report()
    if not all(r.done for r in reqs):
        raise AssertionError("spill C: a request did not complete")
    out = {"tokens": [r.generated for r in reqs], "stats": engine.stats,
           "decode_step_ms_median": statistics.median(staged_ms + plain_ms),
           "decode_step_ms_mean": (sum(staged_ms) + sum(plain_ms))
                                  / (len(staged_ms) + len(plain_ms)),
           "decode_steps": len(staged_ms) + len(plain_ms),
           "staging_steps": len(staged_ms),
           "staging_step_ms_median": (statistics.median(staged_ms)
                                      if staged_ms else None),
           "other_step_ms_median": statistics.median(plain_ms),
           "lent_after": remote.lent, **timing}
    del engine
    return out


def phase_spill(model, params, card: str, seed: int = 4) -> dict:
    """The spill tier at full width (qwen3-8b): scenario A, prefix spill
    (``benchmarks/serving_bench.py``'s spill scenario) on three engines of
    2 slots: ``evict`` (a pool of ``SPILL_POOL`` pages), ``spill`` (the
    same pool and a remote pool) and ``retain`` (a pool that retires
    nothing); B, churn (both peers leave, the next round misses and
    recomputes); C, preemption through recall with write-behind (4 slots,
    ``recall_budget`` 16). Held: A spills, recalls and never misses, a
    recalled page holds the bits it was lent with, and ``spill``'s tokens
    equal ``retain``'s; B misses, recalls nothing and keeps no stub; C
    spills the preempted chain, stages pages, resumes through recall with
    no prompt token recomputed, and its tokens equal an un-preempted run
    with write-behind off; ``evict``'s tokens where they differ from
    ``spill``'s are near ties (``_tie_check``). Every kernel of the paged
    path is launched (counted from 0 at the phase's start) and no plain
    version runs. The spill and recall costs are also broken down by part
    on the engine's own path (:class:`_SpillParts`): A's lends and recalls,
    and C's chain spill, chain recall and staging."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.kvcache import extract_page_payload

    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, vocab, SPILL_PREFIX).tolist()
                for _ in range(SPILL_PREFIXES)]

    def round_prompts():
        return [pre + rng.integers(1, vocab, SPILL_SUFFIX).tolist()
                for pre in prefixes for _ in range(2)]

    ops.reset_counts()
    reg, remote = _cloudlet_pool()
    kw = dict(n_slots=2, max_seq=MAX_SEQ, page_size=PAGE,
              prefill_chunk=CHUNK, device="cuda")
    engines = {"evict": ServeEngine(model, params, n_pages=SPILL_POOL, **kw),
               "spill": ServeEngine(model, params, n_pages=SPILL_POOL,
                                    remote_pool=remote, **kw),
               "retain": ServeEngine(model, params,
                                     n_pages=4 * MAX_SEQ // PAGE + 1, **kw)}
    spill = engines["spill"]
    watched = _watch_spilled_pages(spill)
    prompts, tokens = [], {k: [] for k in engines}
    a_parts = _SpillParts(remote)
    with a_parts.window("A"):       # lends on retire, recalls on admission
        for _ in range(2):
            ps = round_prompts()
            prompts += ps
            for k, v in _spill_round(engines, ps).items():
                tokens[k] += v
    a_parts.close()
    a = {k: {c: e.stats[c] for c in ("pages_spilled", "pages_recalled",
                                     "recall_misses", "prefix_evictions",
                                     "prefill_tokens", "recall_hold_steps")}
         for k, e in engines.items()}
    if not (a["spill"]["pages_spilled"] > 0 and a["spill"]["pages_recalled"]
            > 0 and a["spill"]["recall_misses"] == 0):
        raise AssertionError(f"spill A: {a['spill']}")
    if a["retain"]["prefix_evictions"] or a["retain"]["pages_spilled"]:
        raise AssertionError(f"spill A: the retain engine retired pages: "
                             f"{a['retain']}")
    watched.pop("stubs")
    if not 0 < watched["recalled"] == watched["equal"]:
        raise AssertionError(f"spill A: recalled pages not bit for bit the "
                             f"lent ones: {watched}")
    if tokens["spill"] != tokens["retain"]:
        raise AssertionError("spill A: spill tokens differ from retain's")
    a_differ = _tie_check(model, params, prompts, tokens["evict"],
                          tokens["spill"])
    payload_bytes = len(extract_page_payload(spill.cache, 1))
    costs = _page_costs(spill, list(range(1, min(17, SPILL_POOL))))
    del engines["retain"]
    # B: both peers churn away with the pages they hold
    for h in ("h1", "h2"):
        reg.leave_all(h)
    recalled = spill.stats["pages_recalled"]
    ps = round_prompts()
    b_tokens = _spill_round(engines, ps)
    b = {c: spill.stats[c] for c in ("recall_misses", "pages_recalled",
                                     "pages_spilled", "prefix_evictions")}
    if not (b["recall_misses"] > 0 and b["pages_recalled"] == recalled
            and not spill.spilled):
        raise AssertionError(f"spill B: {b}, {len(spill.spilled)} stubs")
    b_differ = _tie_check(model, params, ps, b_tokens["evict"],
                          b_tokens["spill"])
    del engines, spill
    gc.collect()
    torch.cuda.empty_cache()
    # C: preemption through recall, with write-behind
    c_prompts = [rng.integers(1, vocab, int(n)).tolist()
                 for n in rng.integers(*RESUME_LENS, 4)]
    # the preempted run, then un-preempted runs in turns: off, on, on, off
    c_on = _resume_run(model, params, c_prompts, write_behind=True,
                       preempt=True)
    turns = [_resume_run(model, params, c_prompts, write_behind=wb,
                         preempt=False) for wb in (False, True, True, False)]
    runs = [c_on] + turns
    c_off = turns[0]
    # write-behind's cost: the decode steps' whole time over their count,
    # on against off; unresolved where the two off runs differ by more
    means = [r["decode_step_ms_mean"] for r in turns]
    wb_ms = (means[1] + means[2] - means[0] - means[3]) / 2
    off_spread = abs(means[0] - means[3])
    st = c_on["stats"]
    c = {k: st[k] for k in ("preemptions", "preempt_spills", "pages_staged",
                            "recall_resumes", "resume_fallbacks",
                            "recall_resume_prefill_tokens", "pages_recalled",
                            "recall_hold_steps")}
    if not (c["preempt_spills"] >= 1 and c["pages_staged"] >= 1
            and c["recall_resumes"] >= 1
            and c["recall_resume_prefill_tokens"] == 0):
        raise AssertionError(f"spill C: {c}")
    if any(r["tokens"] != c_off["tokens"] for r in runs):
        raise AssertionError("spill C: a run's tokens differ from the "
                             "un-preempted run's with write-behind off")
    if any(r["lent_after"] for r in runs):
        raise AssertionError("spill C: leases outlived their requests")
    counts = ops.counts()
    _check_counts(counts, PATH_KERNELS["qwen3-8b"], "spill")
    out = {"phase": "spill", "arch": model.cfg.arch_id, "card": card,
           "payload_bytes": payload_bytes, **costs,
           "chain_spill_ms": c_on["chain_spill_ms"],
           "chain_spill_positions": c_on["chain_spill_len"],
           "chain_recall_ms": c_on["chain_recall_ms"],
           "chain_recall_pages": c_on["chain_recall_pages"],
           "chain_parts": c_on["parts"],
           "A_parts": a_parts.report(),
           # un-preempted runs in turns: off, on, on, off
           "decode_step_ms_median_in_turns": [
               r["decode_step_ms_median"] for r in turns],
           "decode_step_ms_mean_in_turns": means,
           "decode_steps_in_turns": [r["decode_steps"] for r in turns],
           "write_behind_ms_per_step": wb_ms,
           "off_runs_spread_ms": off_spread,
           "write_behind_verdict": ("unresolved" if off_spread >= abs(wb_ms)
                                    else "resolved"),
           # write-behind runs in turns: steps that staged a page against
           # the rest
           "staging_steps": [r["staging_steps"] for r in turns[1:3]],
           "staging_step_ms_median": [r["staging_step_ms_median"]
                                      for r in turns[1:3]],
           "other_step_ms_median": [r["other_step_ms_median"]
                                    for r in turns[1:3]],
           "preempted_run_decode_step_ms_median":
               c_on["decode_step_ms_median"],
           "A": a, "A_recalled_pages_bits_equal": watched,
           "A_evict_requests_differing": a_differ,
           "B": b, "B_evict_requests_differing": b_differ, "C": c,
           "launches": {n: v["launches"] for n, v in counts.items()}}
    log(out)
    return out


# ---------------------------------------------------------------------------
# 10. spec: speculative decoding and fork on the paged engine
# ---------------------------------------------------------------------------

SPEC_K, SPEC_NEW = 4, 32
# the spec path's kernels: the draft's and the target's decode, the verify
# fold, the prefill chunks, and the row-invariant product of every decode
SPEC_PATH_KERNELS = PATH_KERNELS["qwen3-8b"]


def _product_verdicts(cfg) -> dict:
    """Phase a: at each product of ``cfg``'s decode step, whether a row's
    bits are the same at 8 rows (the decode step) as at 40 (a k = 4
    verify), at 64, at 80 (a 16-slot verify: two 64-row passes) and alone,
    and for row 37 of 40 alone: for cuBLAS (``torch.matmul``) and for
    ``ops.gemm_rows``, which must hold at every shape and leave the shared
    counters at zero."""
    import torch

    from repro_torch.kernels import _flash_decode, gemm_rows as gk

    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for name, K, N, nk in gk.decode_products(cfg):
        w = (torch.randn(N, K, generator=gen, device="cuda")
             * K ** -0.5).bfloat16()
        w = w.t() if nk else w.reshape(K, N)
        x = torch.randn(80, K, generator=gen, device="cuda").bfloat16()
        verdict = {}
        for lib, mm in (("cublas", torch.matmul), ("gemm_rows", gk.gemm_rows)):
            y = {M: mm(x[:M], w) for M in (1, 8, 40, 64, 80)}
            verdict[lib] = {
                "M40": torch.equal(y[40][:8], y[8]),
                "M64": torch.equal(y[64][:8], y[8]),
                "M80": torch.equal(y[80][:64], y[64]),
                "M1": torch.equal(y[1], y[8][:1]),
                "row37": torch.equal(mm(x[37:38], w), y[40][37:38]),
                "max_abs_diff_40_8": float(
                    (y[40][:8].float() - y[8].float()).abs().max())}
        verdict["gemm_rows"]["counters_zero"] = bool(
            (_flash_decode.counters(1, w.device) == 0).all())
        out[f"{name} {K}x{N}"] = verdict
        if not all(v for k, v in verdict["gemm_rows"].items()
                   if k != "max_abs_diff_40_8"):
            raise AssertionError(f"spec a: gemm_rows rows change with the "
                                 f"row count at {name}: {verdict}")
        del w, x
    return out


def _timed(fn, times: list):
    """``fn`` with each call's wall time between two device syncs appended
    to ``times`` (ms)."""
    import torch

    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    return run


def _spec_engine(model, params, **kw):
    import dataclasses

    from repro_torch.serving.engine import ServeEngine

    eng = ServeEngine(model, params, **kw)
    # time the model calls: the target's decode step and its verify
    eng.decode_ms, eng.verify_ms, eng.draft_ms = [], [], []
    eng.model = dataclasses.replace(
        model, decode_paged=_timed(model.decode_paged, eng.decode_ms),
        verify_paged=_timed(model.verify_paged, eng.verify_ms))
    if kw.get("draft") is not None:
        eng._draft_decode = _timed(eng._draft_decode, eng.draft_ms)
    return eng


def _drain_tokens(eng, prompts, *, max_new, temps=None, seeds=None) -> dict:
    import torch

    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=max_new,
                       temperature=temps[j] if temps else 0.0,
                       seed=seeds[j] if seeds else 0)
            for j, p in enumerate(prompts)]
    eng.run(100_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(r.done for r in reqs):
        raise AssertionError("spec: a request did not complete")
    n_gen = sum(len(r.generated) for r in reqs)
    return {"tokens": [r.generated for r in reqs], "wall_s": wall,
            "generated_tokens": n_gen, "tokens_per_s": n_gen / wall}


def phase_spec(model, params, card: str, seed: int = 5) -> dict:
    """Speculative decoding and ``fork`` on full-width qwen3-8b (the smoke
    settings: ``N_SLOTS`` slots, pages of ``PAGE``, chunks of ``CHUNK``):
    a, each decode product's rows bitwise the same at 1, 8, 40, 64 and 80
    rows for ``ops.gemm_rows`` (cuBLAS's verdicts printed beside); b, 8 requests of
    96-1024 tokens, ``SPEC_NEW`` new each, through a plain engine and a
    self-draft engine (``spec_k`` 4): equal tokens and every proposal
    accepted (the 8-row draft decode and the 40-row verify give the same
    argmax), every kernel of the path launched, no plain version; the
    medians of a plain decode step, a draft step and a verify pass; c, the
    REDUCED pair (qwen3-8b drafted by smollm-360m, heads of 24 and 16
    padded to 64), k = 3, greedy and sampled, spec tokens equal plain's;
    d, a live self-draft slot forked into 3 sampled children; e, a
    speculating engine (4 slots, ``max_seq`` 1024, both caches in its
    blob) snapshotted after 2 steps and restored into a fresh one, with the
    uninterrupted run's tokens."""
    import gc as _gc

    import numpy as np
    import torch

    from repro_torch.configs import draft_for, get
    from repro_torch.kernels import ops
    from repro_torch.models import get_model

    out = {"phase": "spec", "arch": model.cfg.arch_id, "card": card,
           "spec_k": SPEC_K}
    out["products"] = _product_verdicts(model.cfg)
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, vocab, int(n)).tolist()
               for n in rng.integers(96, 1025, 8)]
    kw = dict(n_slots=N_SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
              prefill_chunk=CHUNK, device="cuda")
    # b. self-draft against plain decode
    plain = _spec_engine(model, params, **kw)
    base = _drain_tokens(plain, prompts, max_new=SPEC_NEW)
    plain_ms = list(plain.decode_ms)
    del plain
    _gc.collect()
    torch.cuda.empty_cache()
    spec = _spec_engine(model, params, draft=model, draft_params=params,
                        spec_k=SPEC_K, **kw)
    per_round: dict = {}
    per_verify: dict = {}
    step, verify = spec._spec_step, spec.model.verify_paged

    def counted(fn, into):
        def run(*args, **kwargs):
            before = ops.counts()
            got = fn(*args, **kwargs)
            if not into:
                into.update({k: ops.counts()[k]["launches"] - v["launches"]
                             for k, v in before.items()})
            return got
        return run

    spec._spec_step = counted(step, per_round)
    spec.model.verify_paged = counted(verify, per_verify)
    ops.reset_counts()
    got = _drain_tokens(spec, prompts, max_new=SPEC_NEW)
    counts = ops.counts()
    st = spec.stats
    if got["tokens"] != base["tokens"]:
        raise AssertionError("spec b: self-draft tokens differ from plain "
                             "decode's")
    if not 0 < st["spec_accepted"] == st["spec_proposed"]:
        raise AssertionError(f"spec b: accepted {st['spec_accepted']} of "
                             f"{st['spec_proposed']} self-draft proposals")
    _check_counts(counts, SPEC_PATH_KERNELS, "spec self-draft")
    decode_med = statistics.median(plain_ms)
    verify_med = statistics.median(spec.verify_ms)
    out["self_draft"] = {
        "requests": len(prompts), "new_tokens": SPEC_NEW,
        "spec_rounds": st["spec_rounds"],
        "spec_proposed": st["spec_proposed"],
        "spec_accepted": st["spec_accepted"],
        "decode_step_ms_median": decode_med,
        "draft_step_ms_median": statistics.median(spec.draft_ms),
        "verify_ms_median": verify_med,
        "verify_over_decode_step": verify_med / decode_med,
        "decode_steps": len(plain_ms), "draft_steps": len(spec.draft_ms),
        "verifies": len(spec.verify_ms),
        "plain_tokens_per_s": base["tokens_per_s"],
        "spec_tokens_per_s": got["tokens_per_s"],
        "plain_wall_s": base["wall_s"], "spec_wall_s": got["wall_s"],
        "launches": {n: c["launches"] for n, c in counts.items()},
        "launches_per_spec_round": per_round,
        "launches_per_verify": per_verify}
    del spec
    _gc.collect()
    torch.cuda.empty_cache()
    # d. fork: a live self-draft slot into 3 sampled children
    fork = _spec_engine(model, params, draft=model, draft_params=params,
                        spec_k=SPEC_K, **kw)
    parents = [fork.submit(p, max_new_tokens=SPEC_NEW) for p in prompts[:2]]
    while not (parents[0].generated and parents[0].slot is not None
               and parents[0].slot not in fork.prefilling
               and len(parents[0].generated) > SPEC_K):
        fork.step()
    n_before = len(parents[0].generated)
    kids = fork.fork(parents[0].req_id, 3, temperature=1.0, seeds=[1, 2, 3])
    fork.run(100_000)
    fst = fork.stats
    if not (fst["fork_shared_pages"] > 0 and fst["forks"] == 3
            and all(k.done for k in kids)):
        raise AssertionError(f"spec d: {fst}")
    if any(k.generated[:n_before] != parents[0].generated[:n_before]
           for k in kids):
        raise AssertionError("spec d: a child differs from its parent "
                             "before the fork")
    if len({tuple(k.generated) for k in kids}) < 2:
        raise AssertionError("spec d: the children did not diverge")
    if fork.pool.outstanding:
        raise AssertionError(f"spec d: {fork.pool.outstanding} pages "
                             f"outstanding after the run")
    if fst["spec_accepted"] != fst["spec_proposed"]:
        raise AssertionError("spec d: a sampled self-draft proposal was "
                             "rejected")
    out["fork"] = {"tokens_before_fork": n_before,
                   "forks": fst["forks"],
                   "fork_shared_pages": fst["fork_shared_pages"],
                   "cow_copies": fst["cow_copies"],
                   "children_distinct": len({tuple(k.generated)
                                             for k in kids}),
                   "spec_rounds": fst["spec_rounds"],
                   "spec_accepted": fst["spec_accepted"]}
    del fork
    _gc.collect()
    torch.cuda.empty_cache()
    # e. continuity of a speculating engine: both caches in the blob
    ckw = dict(kw, n_slots=4, max_seq=1024)
    c_prompts = [rng.integers(1, vocab, int(n)).tolist()
                 for n in rng.integers(100, 601, 6)]

    def cont_engine():
        return _spec_engine(model, params, draft=model, draft_params=params,
                            spec_k=SPEC_K, **ckw)

    whole = cont_engine()
    want = _drain_tokens(whole, c_prompts, max_new=16)["tokens"]
    del whole
    cut = cont_engine()
    reqs = [cut.submit(p, max_new_tokens=16) for p in c_prompts]
    for _ in range(2):
        cut.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = cut.snapshot()
    snap_s = time.perf_counter() - t0
    del cut, reqs
    _gc.collect()
    torch.cuda.empty_cache()
    fresh = cont_engine()
    t0 = time.perf_counter()
    fresh.restore(blob)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    fresh.run(100_000)
    tokens = [r.generated for r in sorted(fresh.requests.values(),
                                          key=lambda r: r.req_id)]
    if tokens != want:
        raise AssertionError("spec e: the restored speculating engine's "
                             "tokens differ from the uninterrupted run's")
    out["continuity"] = {"blob_bytes": len(blob), "snapshot_s": snap_s,
                         "restore_s": restore_s,
                         "spec_rounds": fresh.stats["spec_rounds"]}
    del fresh, blob
    _gc.collect()
    torch.cuda.empty_cache()
    # c. the REDUCED pair on the card, greedy and sampled
    tm = get_model(get("qwen3-8b", reduced=True))
    tp = tm.init(0, device="cuda")
    dm = get_model(draft_for("qwen3-8b", reduced=True))
    dp = dm.init(1, device="cuda")
    rkw = dict(max_seq=96, page_size=16, prefill_chunk=32, device="cuda")
    rvocab = tm.cfg.vocab_size
    pair = {}
    for name, lens, temps, seeds, slots in (
            ("greedy", [32, 17, 40, 5], None, None, 2),
            ("sampled", [32, 17, 23, 40], [0.8, 0.0, 1.3, 0.8],
             [11, 0, 42, 7], 3)):
        prng = np.random.default_rng(3)
        ps = [prng.integers(1, rvocab, n).tolist() for n in lens]
        base_r = _drain_tokens(_spec_engine(tm, tp, n_slots=slots, **rkw),
                               ps, max_new=8, temps=temps, seeds=seeds)
        ops.reset_counts()
        eng = _spec_engine(tm, tp, n_slots=slots, draft=dm, draft_params=dp,
                           spec_k=3, **rkw)
        got_r = _drain_tokens(eng, ps, max_new=8, temps=temps, seeds=seeds)
        _check_counts(ops.counts(), SPEC_PATH_KERNELS, f"spec c {name}")
        if got_r["tokens"] != base_r["tokens"]:
            raise AssertionError(f"spec c: {name} REDUCED pair tokens differ "
                                 f"from plain decode's")
        if not eng.stats["spec_rounds"]:
            raise AssertionError(f"spec c: {name} never speculated")
        pair[name] = {k: eng.stats[k] for k in ("spec_rounds",
                                                "spec_proposed",
                                                "spec_accepted")}
    out["reduced_pair"] = pair
    log(out)
    return out


# ---------------------------------------------------------------------------
# 11. batch: the verified batch tier over the paged engine
# ---------------------------------------------------------------------------

# ``benchmarks/batch_bench.py``'s batch-churn scenario (7 hosts, replication
# 2 / quorum 2, a 45 s deadline, snapshots every 5 s, the 6 s failure
# timeout, the fault plan of seed 4 over its crash window) widened to the
# full model: prompts of 64-448 tokens, 24 new tokens each, pages of 64,
# workunits of up to 16 pages, and the replica engines of ``BATCH_ENGINE``
# (a snapshot carries the whole pool, so its blob grows with the pool, not
# with the pages in use)
BATCH_HOSTS, BATCH_PROMPTS, BATCH_NEW = 7, 16, 24
BATCH_PROMPT_LENS = (64, 448)
BATCH_MASTER = dict(replication=2, min_quorum=2, wu_pages=16, page_size=PAGE,
                    deadline_s=45.0, backoff_base_s=2.0, snapshot_every_s=5.0,
                    decode_step_s=1.0)
BATCH_FAILURE_TIMEOUT_S = 6.0
BATCH_FAULT_SEED, BATCH_CRASH_WINDOW = 4, (6.0, 14.0)
# device memory after a job against before it: within one replica's pool
# (qwen3-8b: 24 pages of 36 x 2 x 8 x 128 x 64 x 2 B = 9,437,184 B)
BATCH_MEM_SLACK_BYTES = 0.25e9
# the plan's fault kinds and the re-issue cause each must show
BATCH_CAUSES = {"crash": "reissued_crash", "slow": "reissued_timeout",
                "corrupt": "reissued_quorum"}


def _batch_prompts(vocab: int, seed: int) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi = BATCH_PROMPT_LENS
    return [rng.integers(1, vocab, int(n)).tolist()
            for n in rng.integers(lo, hi + 1, BATCH_PROMPTS)]


def _batch_cluster(factory, service: str):
    """The scenario's cloudlet ``batch``: its hosts, the ad hoc server and
    the batch master over ``factory``."""
    from repro_torch.core.server import AdHocServer
    from repro_torch.serving.batch import BatchMaster

    hosts = [f"h{i}" for i in range(BATCH_HOSTS)]
    srv = AdHocServer(failure_timeout=BATCH_FAILURE_TIMEOUT_S)
    srv.create_cloudlet("batch", service)
    for h in hosts:
        srv.register_host(h, 0.0, cloudlets=["batch"])
    return hosts, srv, BatchMaster(srv, "batch", factory, **BATCH_MASTER)


class _EngineMeter:
    """Hooks on ``ServeEngine.step``, ``snapshot`` and ``restore`` while a
    batch job runs: replica steps and the tokens they generate, each
    snapshot's and restore's seconds (between device syncs) and each blob's
    bytes. The hooks sit on the class, never on an engine, so they keep no
    dropped replica alive."""

    def __init__(self):
        from repro_torch.serving.engine import ServeEngine

        self.cls = ServeEngine
        self.orig = {n: getattr(ServeEngine, n)
                     for n in ("step", "snapshot", "restore")}
        self.steps = self.tokens = 0
        self.snapshot_s, self.restore_s, self.blob_bytes = [], [], []

    def __enter__(self):
        import torch

        step, snapshot, restore = (self.orig[n] for n in
                                   ("step", "snapshot", "restore"))
        meter = self

        def made(eng) -> int:
            return sum(len(r.generated) for r in eng.requests.values())

        def step_(eng, *args, **kw):
            before = made(eng)
            n = step(eng, *args, **kw)
            meter.steps += 1
            meter.tokens += made(eng) - before
            return n

        def snapshot_(eng):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blob = snapshot(eng)
            meter.snapshot_s.append(time.perf_counter() - t0)
            meter.blob_bytes.append(len(blob))
            return blob

        def restore_(eng, blob):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restore(eng, blob)
            torch.cuda.synchronize()
            meter.restore_s.append(time.perf_counter() - t0)

        self.cls.step, self.cls.snapshot, self.cls.restore = (
            step_, snapshot_, restore_)
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.cls, n, fn)


def _batch_job(master, prompts, plan) -> dict:
    """One job through ``master`` on a fresh simulated clock, with the
    launch counts zeroed just before and read just after, and the cyclic
    garbage collector off: a replica's engine (and its device pool) must go
    by reference counting alone when its workunit retires it."""
    import torch

    from repro_torch.core.simulation import SimClock
    from repro_torch.kernels import ops

    clock = SimClock()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    meter = _EngineMeter()
    gc.disable()
    try:
        ops.reset_counts()
        with meter:
            t0 = time.perf_counter()
            job = master.submit(prompts, max_new_tokens=BATCH_NEW,
                                now=clock.now())
            summary = master.run(clock, fault_plan=plan, tick_s=1.0,
                                 max_ticks=2000)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = ops.counts()
        mem1 = torch.cuda.memory_allocated()
    finally:
        gc.enable()
    med = (lambda xs: statistics.median(xs) if xs else None)
    return {
        "job": job, "summary": summary, "results": master.results(job),
        "counts": counts,
        "numbers": {
            "wall_s": wall, "sim_s": summary["elapsed_s"],
            "replica_steps": meter.steps,
            "generated_tokens": meter.tokens,
            "tokens_per_wall_s": meter.tokens / wall,
            "snapshots_placed": summary["snapshots_placed"],
            "snapshots_taken": len(meter.snapshot_s),
            "blob_bytes": max(meter.blob_bytes, default=None),
            "snapshot_s_median": med(meter.snapshot_s),
            "restores": len(meter.restore_s),
            "restore_s_median": med(meter.restore_s),
            "memory_before_gb": mem0 / 1e9, "memory_after_gb": mem1 / 1e9,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        },
    }


def phase_batch(model, params, card: str, seed: int = 6) -> dict:
    """The verified batch tier (``repro_torch.serving.batch``) driving the
    paged engine at full width: a trusted engine of the factory serves the
    16 prompts in one queue; then a, a clean job (completed, nothing
    re-issued, rejected or wasted) and b, the same prompts under the seeded
    fault plan (crashes, a host slowed 8x, a corrupter: completed, re-issues
    of every cause the plan produces, the corrupter outvoted once, at least
    one replica resumed from another's snapshot). Both jobs' results must
    equal the trusted engine's token for token, every kernel of the paged
    path must run and no plain version, and the device memory after each
    job must be back within one replica pool of before. Wall seconds beside
    simulated ones, replica steps, tokens per wall second, snapshots and
    restores, printed beside ``card``."""
    import torch

    from repro_torch.serving.batch import FaultPlan, make_engine_factory

    cfg = model.cfg
    factory = make_engine_factory(model, params, device="cuda", **BATCH_ENGINE)
    prompts = _batch_prompts(cfg.vocab_size, seed)
    t0 = time.perf_counter()
    trusted = factory("__trusted__")
    reqs = [trusted.submit(p, max_new_tokens=BATCH_NEW) for p in prompts]
    trusted.run(100_000)
    torch.cuda.synchronize()
    want = [list(r.generated) for r in reqs]
    out = {"phase": "batch", "arch": cfg.arch_id, "layers": cfg.n_layers,
           "params_b": round(cfg.param_count() / 1e9, 3), "card": card,
           "prompts": len(prompts),
           "prompt_tokens": sum(map(len, prompts)), "new_tokens": BATCH_NEW,
           "hosts": BATCH_HOSTS, "engine": BATCH_ENGINE,
           "master": BATCH_MASTER,
           "trusted": {"wall_s": time.perf_counter() - t0,
                       "steps": trusted.steps}}
    del trusted, reqs
    gc.collect()
    torch.cuda.empty_cache()
    launches = {}
    for name in ("clean", "churn"):
        hosts, srv, master = _batch_cluster(factory, cfg.arch_id)
        plan = (FaultPlan.seeded(hosts, seed=BATCH_FAULT_SEED,
                                 crash_window=BATCH_CRASH_WINDOW)
                if name == "churn" else None)
        got = _batch_job(master, prompts, plan)
        s = got["summary"]
        _check_counts(got["counts"], PATH_KERNELS["qwen3-8b"],
                      f"batch {name}")
        job_out = {
            **got["numbers"], "state": s["jobs"][got["job"]],
            **{k: s[k] for k in (
                "workunits", "validated", "results_received", "reissued",
                "reissued_crash", "reissued_timeout", "reissued_quorum",
                "quorum_rejections", "timeouts", "crash_cancellations",
                "resumed_from_snapshot", "useful_tokens", "wasted_tokens")},
            "results_equal_trusted": got["results"] == want,
            "launches": {n: c["launches"] for n, c in got["counts"].items()}}
        if plan is not None:
            job_out["faults"] = [f"{e.kind}@{e.at:g}s {e.host}"
                                 for e in plan.events]
            corrupters = [e.host for e in plan.events if e.kind == "corrupt"]
            job_out["corrupt_results"] = {
                h: srv.reliability.get(h).corrupt_results for h in corrupters}
        out[name] = job_out
        for n, c in got["counts"].items():
            launches[n] = launches.get(n, 0) + c["launches"]
        grew = (job_out["memory_after_gb"] - job_out["memory_before_gb"]) * 1e9
        problems = []
        if job_out["state"] != "completed":
            problems.append(f"job {job_out['state']}")
        if not job_out["results_equal_trusted"]:
            problems.append("results differ from the trusted engine's")
        if grew > BATCH_MEM_SLACK_BYTES:
            problems.append(f"device memory grew by {grew:.4g} B")
        if name == "clean" and (s["reissued"] or s["quorum_rejections"]
                                or s["wasted_tokens"]):
            problems.append("re-issue, rejection or waste in a clean job")
        if name == "churn":
            kinds = {e.kind for e in plan.events}
            problems += [f"no {cause} for the plan's {kind}"
                         for kind, cause in BATCH_CAUSES.items()
                         if kind in kinds and not s[cause]]
            if not (s["reissued"] and s["quorum_rejections"] >= 1
                    and s["resumed_from_snapshot"] >= 1):
                problems.append("no re-issue, rejection or resume")
            if list(job_out["corrupt_results"].values()) != [1]:
                problems.append(f"corrupter: {job_out['corrupt_results']}")
        if problems:
            log(out)
            raise AssertionError(f"batch {name}: " + "; ".join(problems))
    out["launches"] = launches
    log(out)
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

ROUTES = {
    "rmsnorm": ("cuda", "src/repro_torch/csrc/rmsnorm.cu",
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
    # no TPU kernel: the paged decode step's products, row-invariant so that
    # the speculative verify equals plain decode
    "gemm_rows": ("cuda", "src/repro_torch/csrc/gemm_rows.cu",
                  "torch.matmul (cuBLAS)"),
}
# the check row that stands for each (kernel, model) in the summary line:
# the decode step's block norm (d 4096, or zamba2's d 2048), the paged and
# the dense decode cases, the longest prefill chunk (q_offset 1280), the SSM
# kernels' prefill chunk from a nonzero state
SUMMARY_ROW = {
    "qwen3-8b": {"rmsnorm": ("rmsnorm", 0),
                 "paged_decode_attention": ("paged_decode_attention", 0),
                 "decode_attention": ("decode_attention", 0),
                 "flash_attention": ("flash_attention", 2),
                 "gemm_rows": ("gemm_rows", -2)},
    "falcon-mamba-7b": {"rmsnorm": ("rmsnorm", 0),
                        "selective_scan": ("selective_scan", 1)},
    "zamba2-1.2b": {"rmsnorm": ("rmsnorm", 4),
                    "paged_decode_attention": (
                        "paged_decode_attention@zamba2", 0),
                    "decode_attention": ("decode_attention@zamba2", 0),
                    "flash_attention": ("flash_attention@zamba2", 2),
                    "ssd": ("ssd", 1)},
}
# the spec path's rows (qwen3-8b): the block norm, the verify fold, the
# longest prefill chunk, and one verify's products (M = 40)
SPEC_SUMMARY_ROW = {"rmsnorm": ("rmsnorm", 0),
                    "paged_decode_attention": ("paged_verify", 0),
                    "flash_attention": ("flash_attention", 2),
                    "gemm_rows": ("gemm_rows", -1)}
# the batch path's rows (qwen3-8b): its decode step's block norm and paged
# decode (4 slots), a second prefill chunk (256 queries over 512 keys, the
# longest its prompts need), one decode step's products at 4 rows
BATCH_SUMMARY_ROW = {"rmsnorm": ("rmsnorm@batch", 0),
                     "paged_decode_attention": (
                         "paged_decode_attention@batch", 0),
                     "flash_attention": ("flash_attention", 1),
                     "gemm_rows": ("gemm_rows", -3)}


def run_model(arch: str, card: str) -> dict:
    """Serve, profile, logits, dense and continuity phases of one model at
    full width, and for qwen3-8b the spill, spec and batch phases (their
    numbers printed beside ``card``, the card's name and power limit); its
    weights and caches are freed before returning."""
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
    spec = batch = None
    if arch == "qwen3-8b":
        phase_spill(model, params, card)
        spec = phase_spec(model, params, card)["self_draft"]
        batch = phase_batch(model, params, card)["launches"]
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    # each kernel's counts come from the path that runs it: the dense
    # decode from the dense serve, every other kernel from the paged one
    return {"paged": (serve["launches"], per_call["decode_step"],
                      per_call["prefill_chunk"]),
            "dense": (dense["launches"],
                      dense["launches_per_call"]["decode_step"],
                      dense["launches_per_call"]["prefill"]),
            "spec": spec, "batch": batch}


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
    for arch in CLI_ARCHS:
        phase_cli(arch)

    kernels = []

    def row_of(name, check, i, arch, path, launches, **extra):
        route, source, replaces = ROUTES[name]
        row = checks[check][i]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "model": arch, "path": path,
            "launches": launches, **extra,
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "x_library", "x_bound", "shape")},
            **({"bound_f32_ms": row["bound_f32_ms"]}
               if "bound_f32_ms" in row else {})})

    for arch, rows in SUMMARY_ROW.items():
        ran = run_model(arch, device["smi"])
        for name, (check, i) in rows.items():
            path = "dense" if name == "decode_attention" else "paged"
            serve, per_step, per_prefill = ran[path]
            row_of(name, check, i, arch, path, serve[name],
                   launches_per_decode_step=per_step[name],
                   launches_per_prefill=per_prefill[name])
        spec = ran["spec"]
        for name, (check, i) in (SPEC_SUMMARY_ROW.items() if spec else ()):
            row_of(name, check, i, arch, "spec", spec["launches"][name],
                   launches_per_spec_round=spec["launches_per_spec_round"][
                       name],
                   launches_per_verify=spec["launches_per_verify"][name])
        for name, (check, i) in (BATCH_SUMMARY_ROW.items()
                                 if ran["batch"] else ()):
            row_of(name, check, i, arch, "batch", ran["batch"][name])
    log({"kernels": kernels})
    log(device["smi"])
    log({"ok": True, "device": {"platform": device["platform"],
                                "kind": device["kind"],
                                "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
