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
   same alone) and ``gemm_rows`` at 4 rows; the MoE family's kernels (no
   TPU counterpart): the router (``moe_route``) at deepseek-moe-16b's d
   2048, E 64, k 6 over 8, 40 and 256 tokens and granite-moe-1b-a400m's
   over 8 (ids equal to the plain version's but at near ties, counted;
   each token's bits the same at 1, 8, 40 and 64 tokens), the routed
   experts' grouped product (``gemm_rows_grouped``) at both configs'
   gate, up and down over random routings of 8 and 40 lanes (empty
   experts skipped), beside ``torch.bmm``, and bitwise per (expert, row)
   at capacity 8, 40 and 64, at another rank, with the other experts empty
   or full; every other decode product of deepseek-moe-16b,
   granite-moe-1b-a400m (its tied 49,155-column unembedding, row-invariant
   at 1-80 rows in both layouts), phi4-mini-3.8b and minitron-4b through
   ``gemm_rows``; the attention kernels at deepseek-moe's (16 / 16 of 128)
   and granite-moe's (16 / 8 of 64) heads; the multimodal families:
   whisper-medium's encoder attention through the flash kernel's
   non-causal branch at (1, 1500, 16, 64) and (1, 750, 16, 64) beside SDPA,
   its cross read folded into the paged decode kernel (8 lanes at C = 1,
   and a 256-row chunk, 8 rows a folded lane in the kv heads' groups,
   lengths 1500 and 750; every folded query bitwise a one-lane decode;
   beside the fold of one row a lane), the dense cross read over the 1500-padded cache, its
   decoder's attention (16 / 16 of 64) and block norms (d 1024, and the
   encoder's 1500 rows), and every decode product of whisper-medium and
   llava-next-mistral-7b through ``gemm_rows`` at 8 and 40 rows, each
   row-invariant at 1-80 rows (whisper's tied 51,865-column unembedding in
   both layouts);
3b. cli: ``repro_torch.launch.serve.main`` at its defaults (REDUCED
   configs, whose heads of 16 and 24 the attention wrappers pad to 64) for
   ``qwen3-8b``, ``zamba2-1.2b``, ``falcon-mamba-7b`` and
   ``granite-moe-1b-a400m``, without and with
   ``--fail-after 4``: every request completes, every kernel of the path
   is launched, the restored run gives the same tokens; qwen3-8b's card
   tokens are held against the CPU plain path teacher-forced on them
   (each within 0.05 of the CPU's top logit);
4. per model — full-width, full-depth ``qwen3-8b``, then ``falcon-mamba-7b``
   (Mamba1; its depth cut to 16 of 64 layers), then ``zamba2-1.2b`` (Mamba2
   + shared attention), then ``deepseek-moe-16b`` (MoE: a dense layer, then
   MoE layers of 64 routed experts, top-6, and 2 shared; its depth cut to 8
   of 28 layers), each with seeded random weights, freed
   before the next, through phases a-e (and f-h and k for qwen3-8b, i
   for deepseek-moe-16b); then ``granite-moe-1b-a400m`` (a short serve: 8
   requests of 16 new tokens on 4 slots, and phase c), ``phi4-mini-3.8b``
   and ``minitron-4b`` (a short serve each); then the multimodal families,
   ``whisper-medium`` (enc-dec: 24 encoder and 24 decoder layers, d 1024,
   16 heads of 64, GELU MLP, tied 51,865 vocab) and
   ``llava-next-mistral-7b`` (VLM: 576 image rows of the stub vision width
   1024 through ``mm_proj``, then a 32-layer Mistral backbone) through
   phases a-e with modality inputs (whisper also j):
   a. serve: 16 requests (4 share a 512-token prefix) through
      ``repro_torch.serving.engine.ServeEngine``; every kernel of the
      model's path must have been launched and no plain version called;
      whisper's requests carry frames (8 share one 1500-row input, 4
      distinct 1500-row and 4 distinct 750-row inputs, one prompt's text
      under other frames): exactly 9 encoder regions computed, 7 shared,
      168 pages shared, the cross fold and the encoder's flash launched;
      llava's carry 576 image rows each (4 share an image and a 256-token
      text prefix: 3 x 832 prefill positions shared, one prompt's text
      under another image);
      for the SSM and hybrid models the prefix trie is bookkeeping only
      (would-be hits counted, no prefill shared), and the longest prompt's
      state when its prefill ends, with decode steps of other lanes run
      meanwhile, must equal a solo prefill's (the R3 guard);
   b. profile: where a short serve's device and host time go;
   c. logits: two requests, prefill plus 8 teacher-forced decode steps,
      once through the kernels and once under ``ops.use_backend("plain")``;
      the logits must agree within the model's bound where the model is
      not chaotic (qwen3-8b, whisper-medium, llava-next-mistral-7b),
      beside controls (the plain path with one bf16 ulp added to one
      embedding value, and to every one; for llava the image/text split
      one row early, which must move the logits past the bound); and
      every kernel call of the
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
      printed beside the card's name and power limit;
   i. spec (deepseek-moe-16b, ``phase_spec_moe``): greedy self-draft
      speculation (``spec_k`` 4) gives plain decode's tokens with every
      proposal accepted: the 8-lane decode step and the 40-lane verify
      route and multiply every lane alike (its granite-moe draft differs
      in vocab at published widths, R4);
   j. cross spill (whisper-medium, ``phase_cross_spill``): a second
      request's admission reallocates cached pages of the first, which are
      lent to a peer (decoder and encoder-region pages, each payload its
      region's leaves); the first request's frames and prompt again share
      its region through their recall, every recalled page bitwise the
      lent one, the tokens unchanged;
   k. cell (qwen3-8b only, ``phase_cell``): the elastic serving cell
      (``repro_torch.serving.cell``, layout-only) over the paged engine at
      full width: 8 prompts of 96-384 tokens, 32 new tokens each, on 4
      hosts of 2 lanes on a (2, 2) grid (engines of
      ``make_engine_factory``: 8 slots, 64-page pools), four fresh cells
      one after another, faults timed from the end of formation: a, clean
      (nothing re-sharded, replayed or shed); b, a crash, then the host
      rejoins (collective timeout, re-shard onto 3 hosts resumed from a
      snapshot with a replay, 2 lanes shed, grow back to 4); c, two
      crashes with ``min_hosts`` 2 and priorities 0,0,1,1,2,2,3,3 (4
      lanes: the four lowest shed); d, a host slowed 8x, evicted and
      never placed on again. Every finished stream equals a trusted
      engine's, every shed one is a prefix of it, no forced mismatch in b
      and d, hosts lost equal the crashes, every kernel of the paged path
      launched and no plain version, each engine built only once every
      earlier one is freed, the device memory back within less than one
      pool after each run; wall seconds by part (engine build, restore,
      relayout, replay, snapshot placement, ``gather_state``'s host copy)
      beside simulated ones, printed beside the card's name and power
      limit (``tools/cell_rehearsal.py`` predicts every counter on the
      CPU);
   l. materialized (qwen3-8b only, ``phase_materialized``): the cell with
      ``materialize=True`` on a one-rank NCCL group (``tcp://127.0.0.1``,
      a free port) and a (1, 1) ``DeviceMesh``: params and the pool are
      DTensors, every engine step runs under the mesh. One host of one
      card serves phase_cell's 8 prompts (a second host, suspended, only
      holds snapshots); the host crashes, the cell stalls below
      ``min_hosts``, the host rejoins and the cell re-forms on it:
      ``reshard_state`` copies the whole host checkpoint onto the card
      again and the pool comes back from the snapshot, the streams replay.
      Every stream equals phase_cell's trusted engine's, no forced
      mismatch (a (1, 1) mesh replicates every leaf, so the arithmetic is
      one device's), every kernel of the paged path launched and no plain
      version, the device memory back within less than one pool; wall
      seconds by part (``reshard_state``, pool placement, restore,
      replay, ...) beside the same scenario's layout-only cell's, with the
      bytes each moved. Then each of the path's kernels at the rank-local
      shapes a (2, 2) grid gives one rank (16 of 32 query heads, 4 of 8 kv
      heads, ``gemm_rows`` on N/2 column and K/2 row shards, the norms'
      rows on a data shard of 4 lanes) against its plain version, and
      against the matching slice of the full-shape call (bitwise or
      not, printed; a row shard's two halves summed within tolerance). The
      process group is destroyed before the next phase.

5. train (``phase_train``): a, training's kernels at its shapes against
   autograd through the plain versions: the flash forward (with ``lse``)
   and the hand-written backward (``csrc/flash_attention_bwd.cu``) at
   smollm-360m's B 8, S 2048, 15 / 5 heads of 64 and qwen3-8b's B 2, S
   2048, 32 / 8 heads of 128, the RMSNorm forward and backward at
   smollm's (16,384, 960) rows and qwen3's (131,072, 128) qk and (4,096,
   4,096) block rows (dq, dk, dv within 2 % of each gradient's largest
   magnitude, dx at 2e-2, dw within 1e-3 of its largest value; two
   backward runs bitwise equal; the forward's bits the same with ``lse``
   as without, at a training and at a serving chunk's shape), beside the
   backward of SDPA (``enable_gqa``) and of ``F.rms_norm``; b, smollm-360m
   at full width and depth through ``repro_torch.launch.train.main``
   (seq 2048, batch 8, 10 steps, 2 hosts, snapshots every 5, a failure
   at step 7), then the same run without the failure: the counters equal
   a REDUCED CPU rehearsal of the schedule, the final states bitwise
   equal, every loss finite, the run's first loss the same step's run
   alone, which is within 2e-2 (loss) and 5 % (grad norm) of that step
   under the plain versions; the flash and RMSNorm kernels launched
   forward and backward and no plain version; step ms, tokens/s, peak
   device memory, host memory, blob bytes, snapshot and restore seconds;
   c, qwen3-8b at published widths with its depth cut to 8 of 36 layers:
   3 steps at B 2, S 2048, twice from seed 0: finite losses, the two runs
   bitwise equal (losses, grad norms, an exact digest of every leaf); step
   ms and peak memory; d, the recurrent families: the scan's forward
   (saving its tiles' states: y and hT the same bits) and backward
   (``csrc/selective_scan_bwd.cu``) at falcon-mamba-7b's B 2, S 2048, Di
   8192, N 16, the SSD's (keeping its scratch) and backward
   (``csrc/ssd_bwd.cu``) at zamba2-1.2b's B 2, S 2048, 64 heads of 64, N
   64, chunk 256, against autograd through the plain versions (each bf16
   gradient within 1 % in every 64-step tile, each f32 one within 1e-3 of
   its largest value, two runs bitwise equal, a planted fault caught); then
   falcon-mamba-7b at published widths, 8 of 64 layers, and zamba2-1.2b at
   published widths and full depth: each first step within c's loss and
   grad-norm limits of the plain step, and its leaves held: falcon-mamba
   at 2 layers (the plain scan's loop stays in seconds) within b's leaf
   limit; zamba2 at full depth for seeds 0 and 1, each leaf within its
   share under a control of rounding (the plain step with every embedding
   value one bf16 ulp up or down); the backward kernels of the first
   seed's kernel step run again on the same inputs against plain versions
   (forced: every SSD, scan, flash and RMSNorm backward call, per tile);
   then 3 steps at B 2, S 2048 twice from seed 0, as c. The scan and SSD
   backward checks also run at the decay the models start from (dt about
   0.8, A about -1). e, the MoE and enc-dec families: the router with its
   softmax out (weights and ids the same bits as without) and its backward
   (``csrc/moe_route_bwd.cu``: d_logits, then dx and d_router, two
   launches) at granite-moe-1b-a400m's and deepseek-moe-16b's 4096 tokens
   a layer (d_logits against the plain closed form, dx and d_router
   against the plain version summed in the kernel's order and the route's
   against plain autograd; its device time and launches beside the
   parent's design rebuilt on the same inputs), the
   flash backward's non-causal branch at whisper-medium's encoder (B 2,
   1500 frames, 16 heads of 64) and cross attention (2048 queries over
   1500 keys); then granite-moe-1b-a400m and whisper-medium at published
   widths and full depth: each first step at 2 layers within c's limits of
   the plain step, each leaf within b's, every backward kernel call rerun
   against plain versions (forced), then 3 steps at B 2, S 2048 twice from
   seed 0, as c. Sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (unless set)
   before CUDA starts, for the whole run.
6. examples (``phase_examples``): ``examples/torch_adhoc_serving.py`` on
   the card in a fresh process (its failure drills assert identical
   continuations);
7. roofline (``phase_roofline``): six cells of ``launch/cells.py`` at
   published widths and depth (qwen3-8b decode, B 8 over a 2048-position
   cache, and prefill, B 2 x 2048; falcon-mamba-7b's and zamba2-1.2b's
   prefill, B 1 x 2048; smollm-360m's train step, B 8 x 2048, and
   granite-moe-1b-a400m's, B 2 x 2048), each first through the meta pass
   (product FLOPs, each kernel's ``cost``, bytes, peak live bytes), then on
   the card with seeded weights: the median of 5 calls after 3 to warm
   (CUDA events), ``t_compute_ms``, ``t_memory_ms`` and the bound on the
   H100's peaks (``launch/roofline.py``), ``x_roofline`` (measured over
   the larger term; under 0.95 fails: the count would overstate the work),
   ``mfu`` (model FLOPs over measured time over the bf16 peak; train and
   prefill), the temp bytes predicted and measured (``max_memory_allocated``
   over what was allocated before one warm call; more than 25 % apart
   fails), and each kernel's wrapper calls from the meta pass and from
   ``ops.counts()`` (any difference fails), with the device launches a
   call makes.

Every bound (``bound_ms``) is ``launch/roofline.py::bound`` of the
kernel's ``cost`` (``kernels/*.py``) at the check's shape: the card's peaks
and each kernel's work are kept in one place each.

The MoE models' logits have no bound (random-weight routing is chaotic):
the kernel-forced check holds the router there (ids equal but at a near
tie) and the grouped product (rows below each expert's count).

The line two before the last is the kernels summary as JSON (one row per
kernel and model whose path runs it, and rows with ``"path": "spec"`` for
the speculative path, ``"path": "batch"`` for the batch tier,
``"path": "cell"`` for the elastic cell, ``"path": "materialized"`` for
the materialized cell, ``"path": "train"`` for
training (the backward kernels among them), and
whisper's routes: the cross fold, the encoder's flash and the dense cross
read, each with the launches counted around that route's calls), the line
before the last the card's
name and power limit, the last ``{"ok": true, "device": {...}}``. Imports
nothing of JAX or of ``repro``.
"""

from __future__ import annotations

import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# the train step runs in torch's deterministic mode, whose cuBLAS needs
# this before CUDA starts (src/repro_torch/training/step.py)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's peaks and a call's least time: one source for every bound of
# this script (launch/roofline.py); each kernel's work is its module's cost
from repro_torch.launch.roofline import bound  # noqa: E402

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
        wl = w.to(x.dtype)
        rows.append({
            "shape": list(shape), "max_abs_err": err,
            "ms": _time_ms(lambda: rk.rmsnorm(x, w, 1e-6)),
            "plain_ms": _time_ms(lambda: ref.rmsnorm(x, w, 1e-6)),
            "library_ms": _time_ms(
                lambda: F.rms_norm(x, (shape[-1],), wl, 1e-6)),
            **bound(rk.cost(x.numel() // shape[-1], shape[-1],
                            x.element_size(), w.element_size())),
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
    return {
        "shape": {"B": len(lengths), "H": q.shape[1], "K": K, "D": D,
                  "P": PAGE, "lengths": lengths},
        "max_abs_err": err,
        "ms": _time_ms(lambda: pk.paged_decode_attention(q, kp, vp, table,
                                                         lens), flush=True),
        "plain_ms": _time_ms(lambda: pk.plain(q, kp, vp, table, lens),
                             flush=True),
        "library_ms": None, **bound(pk.cost(len(lengths), q.shape[1], K, D,
                                            table.numel(), n_keys)),
    }


def _pool_case(gen, lengths, engine: dict, H: int = 32, K: int = 8,
               D: int = 128):
    """q (B, H, D) and an engine's pools (``n_pages``, pages of ``PAGE``, K
    kv heads) with each lane's pages drawn from a shuffled pool: q, k
    pages, v pages, page tables, lengths."""
    import torch

    B = len(lengths)
    n_pages, width = engine["n_pages"], engine["max_seq"] // PAGE
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
    return (q, kp, vp, table.cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def check_paged_decode_pool(gen, lengths, engine: dict, what: str,
                            heads: tuple[int, int] = (32, 8)) -> dict:
    """The paged decode at an engine's pool and table shape: the batch
    tier's (``phase_batch``: 4 lanes of a workunit, prompt plus generated
    positions up to 472, in a 24-page pool, page tables of 16) or the
    elastic cell's (``phase_cell``: 8 lanes up to 416 positions in a
    64-page pool, tables of 8; with ``heads`` a (2, 2) grid's rank-local
    16 of 32 query and 4 of 8 kv heads): against the plain version, two
    runs bitwise equal, and each lane bitwise the same alone as in its
    batch — what bitwise hash quorum across replicas and the cell's exact
    replay rest on."""
    import torch

    from repro_torch.kernels import ops, paged_decode_attention as pk

    (H, K), D, B = heads, 128, len(lengths)
    n_pages, width = engine["n_pages"], engine["max_seq"] // PAGE
    q, kp, vp, table, lens = _pool_case(gen, lengths, engine, H, K, D)
    got = pk.paged_decode_attention(q, kp, vp, table, lens)
    with ops.use_backend("plain"):
        want = ops.paged_decode_attention(q, kp, vp, table, lens)
    err = _close(got, want, f"paged_decode_attention ({what})")
    if not torch.equal(got, pk.paged_decode_attention(q, kp, vp, table,
                                                      lens)):
        raise AssertionError(f"paged decode ({what}): two runs differ")
    for i in range(B):
        alone = pk.paged_decode_attention(q[i:i + 1], kp, vp, table[i:i + 1],
                                          lens[i:i + 1])
        if not torch.equal(alone[0], got[i]):
            raise AssertionError(f"paged decode ({what}): lane {i} changed "
                                 f"with its batch")
    n_keys = int(lens.sum())
    return {
        "shape": {"B": B, "H": H, "K": K, "D": D, "P": PAGE,
                  "pages": n_pages, "table": width, "lengths": lengths},
        "max_abs_err": err,
        "ms": _time_ms(lambda: pk.paged_decode_attention(q, kp, vp, table,
                                                         lens), flush=True),
        "plain_ms": _time_ms(lambda: pk.plain(q, kp, vp, table, lens),
                             flush=True),
        "library_ms": None,
        **bound(pk.cost(B, H, K, D, table.numel(), n_keys)),
    }


def check_paged_verify(gen, k: int = 4) -> dict:
    """The speculative verify at qwen3-8b's shape: 8 lanes, a window of
    k + 1, folded into the paged decode kernel (``ops.paged_verify_attention``
    on the card): against the plain version, and each window query bitwise
    equal to a single-token paged decode at its own length."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_decode_attention as pk

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
    return {
        "shape": {"B": B, "W": W, "H": H, "K": K, "D": D, "P": PAGE,
                  "positions": lengths},
        "max_abs_err": err,
        "ms": _time_ms(lambda: ops.paged_verify_attention(
            q, kp, vp, table, lens), flush=True),
        "plain_ms": _time_ms(lambda: ref.paged_verify_attention(
            q, kp, vp, table, lens), flush=True),
        "library_ms": None,
        **bound(pk.verify_cost(B, W, H, K, D, table.numel(), lengths)),
    }


def check_gemm_rows(gen, arch: str = "qwen3-8b",
                    Ms=(BATCH_ENGINE["n_slots"], N_SLOTS, N_SLOTS * 5)
                    ) -> list[dict]:
    """The paged decode step's row-invariant product at each of its shapes
    (full-width ``arch``), at the decode step's 8 rows and a k = 4 verify's
    40: against the plain version (``x @ w``), each timed with L2 flushed
    (a step finds its weights cold) beside cuBLAS's ``torch.matmul``, and
    (by default) at the batch tier's 4 rows (``phase_batch``), with
    the kernel's plan for it (tile width, k step, work items, K segments,
    ring depth); then one decode step's and one verify's products in all
    (qwen3-8b: 36 layers of seven and the unembedding), with their bounds
    (``gemm_rows.step_products``)."""
    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import gemm_rows as gk, ops

    cfg = get(arch)
    rows, steps = [], {}
    for M in Ms:
        step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "cost": None, "max_abs_err": 0.0}
        for name, K, N, nk, times in gk.step_products(cfg):
            w = (torch.randn(N, K, generator=gen, device="cuda")
                 * K ** -0.5).bfloat16()
            w = w.t() if nk else w.reshape(K, N)
            x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
            got = gk.gemm_rows(x, w)
            with ops.use_backend("plain"):
                want = ops.gemm_rows(x, w)
            err = _close(got, want, f"gemm_rows {name} M={M}")
            cost = gk.cost(M, K, N)
            p = gk.plan(K, N, nk, gk._n_sm(torch.cuda.current_device()))
            row = {"shape": {"M": M, "K": K, "N": N, "product": name,
                             "arch": arch},
                   "plan": {"tile_n": p.bn, "bk": p.bk, "items": p.items,
                            "grid": p.grid, "segments": p.s_base,
                            "tiles_with_one_more": p.extra,
                            "stages": p.stages},
                   "max_abs_err": err,
                   "ms": _time_ms(lambda: gk.gemm_rows(x, w), flush=True),
                   "plain_ms": _time_ms(lambda: gk.plain(x, w), flush=True),
                   "library_ms": _time_ms(lambda: torch.matmul(x, w),
                                          flush=True),
                   **bound(cost)}
            rows.append(row)
            for key in ("ms", "plain_ms", "library_ms"):
                step[key] += times * row[key]
            step["cost"] = times * cost if step["cost"] is None \
                else step["cost"] + times * cost
            step["max_abs_err"] = max(step["max_abs_err"], err)
            del w, x
        steps[M] = step
    for M, step in steps.items():
        rows.append({"shape": {"M": M, "products": "one step", "arch": arch,
                               "layers": cfg.n_layers},
                     "max_abs_err": step["max_abs_err"], "ms": step["ms"],
                     "plain_ms": step["plain_ms"],
                     "library_ms": step["library_ms"],
                     **bound(step["cost"])})
    return rows


def check_decode(gen, *, n_heads=32, n_kv=8, d=128, S=MAX_SEQ,
                 lengths=(0, 1, 63, MAX_SEQ, 700, 1300, MAX_SEQ - 1, 64)
                 ) -> dict:
    """The dense-cache decode at the dense engine's shape: 8 lanes over a
    ``MAX_SEQ`` cache, lengths from 0 (zeros) to the whole cache (or
    ``S`` and ``lengths`` given: whisper's cross read over its
    ``ENC_SEQ``-padded encoder cache at each lane's ``enc_len``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dk, ops

    lengths = list(lengths)
    B = len(lengths)
    q = torch.randn(B, n_heads, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, S, n_kv, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, S, n_kv, d, generator=gen, device="cuda").bfloat16()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = dk.decode_attention(q, k, v, lens)
    with ops.use_backend("plain"):
        want = ops.decode_attention(q, k, v, lens)
    err = _close(got, want, "decode_attention")
    if lengths[0] == 0 and bool(got[0].float().abs().max() != 0):
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
        **bound(dk.cost(B, n_heads, n_kv, d, S, lengths)),
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
            **bound(fk.cost(1, sq, sk, H, K, D, causal=True, q_offset=off)),
        })
    return rows


def _init_decay(gen, dt_shape, a_shape):
    """dt and A as the recurrent families' initial weights draw them: dt
    the softplus of a unit normal (about 0.8 on average; the projections
    into it are fan-in scaled and ``dt_bias`` is zero), A = -exp(A_log)
    with A_log at the ``small`` scale (1e-4), so about -1. The decay's
    exponent falls by about 200 over 256 steps."""
    import torch
    import torch.nn.functional as F

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    return (F.softplus(rnd(*dt_shape)).bfloat16(),
            -torch.exp(1e-4 * rnd(*a_shape)))


def _scan_case(gen, S: int, h0_scale: float, *, B=1, Di=8192, N=16,
               init_decay: bool = False):
    """falcon-mamba's scan inputs over S steps: x, dt, A, Bm, C, D, h0;
    dt and A mild (dt about 0.08), or with ``init_decay`` as the model's
    initial weights draw them (``_init_decay``)."""
    import torch

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    x = rnd(B, S, Di, scale=0.5).bfloat16()
    dt, A = (_init_decay(gen, (B, S, Di), (Di, N)) if init_decay else
             ((0.1 * rnd(B, S, Di).abs()).bfloat16(),
              -(rnd(Di, N).abs() + 0.1)))
    return (x, dt, A,
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
        rows.append({
            "shape": {"B": B, "S": S, "Di": Di, "N": N, "h0": h0_scale},
            "max_abs_err": err, "hT_rel_err": rel, "chained_equal": chained,
            "ms": _time_ms(lambda: sk.selective_scan(*args), flush=True),
            "plain_ms": _time_ms(lambda: sk.plain(*args), iters=3,
                                 flush=True),
            "library_ms": None,
            **bound(sk.cost(B, S, Di, N)),
        })
    return rows


def _ssd_case(gen, S: int, h0_scale: float, *, B=1, Hs=64, P=64, N=64,
              init_decay: bool = False):
    """zamba2's SSD inputs over S steps: x, dt, A, Bm, C, D, h0; dt and A
    mild, or with ``init_decay`` as the model's initial weights draw them
    (``_init_decay``)."""
    import torch

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    x = rnd(B, S, Hs, P, scale=0.5).bfloat16()
    dt, A = (_init_decay(gen, (B, S, Hs), (Hs,)) if init_decay else
             ((0.1 * rnd(B, S, Hs).abs()).bfloat16(), -(rnd(Hs).abs() + 0.1)))
    return (x, dt, A,
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
        # the least time on the tensor cores (bf16 peak), and the same work
        # on the f32 units outside them (``bound_f32_ms``)
        f32 = bound(dk.cost(B, S, Hs, P, N, chunk=CHUNK, unit="f32"))
        rows.append({
            "shape": {"B": B, "S": S, "Hs": Hs, "P": P, "N": N,
                      "chunk": CHUNK, "h0": h0_scale},
            "max_abs_err": err, "hT_rel_err": rel, "chained_equal": chained,
            "ms": _time_ms(lambda: dk.ssd(*args, chunk=CHUNK), flush=True),
            "kernels_us": _kernels_us(lambda: dk.ssd(*args, chunk=CHUNK)),
            "plain_ms": _time_ms(lambda: dk.plain(*args, chunk=CHUNK),
                                 flush=True),
            "library_ms": None,
            **bound(dk.cost(B, S, Hs, P, N, chunk=CHUNK)),
            "bound_f32_ms": f32["bound_ms"], "bound_f32_by": f32["bound_by"],
        })
    return rows



# ---------------------------------------------------------------------------
# 3c. the MoE family's kernels: routing and the grouped expert products
# ---------------------------------------------------------------------------

# two of the plain version's first k + 1 probabilities (sorted) closer than
# this are a near tie, which the kernel may rank either way: the two compute
# a probability near 1/64 to ~2e-9 (f32 sums over d in another order, the
# exponential's ulp)
ROUTE_TIE = 1e-7
ROUTE_TOL = dict(atol=1e-5, rtol=1e-5)   # the renormalised f32 weights
MOE_ARCHS = ("deepseek-moe-16b", "granite-moe-1b-a400m")


def _route_near_ties(x, router, k):
    """Per token: two of its first k + 1 plain probabilities near-tied."""
    import torch

    probs = torch.softmax(x.float() @ router.float(), -1).sort(
        -1, descending=True)[0][:, :k + 1]
    return ((probs[:, :-1] - probs[:, 1:]) < ROUTE_TIE).any(-1)


def _route_agrees(got, want, x, router, k, tally: dict) -> float:
    """The router kernel's (weights, ids) against the plain version's: ids
    equal for every token but a near tie (counted into ``tally``), weights
    within ``ROUTE_TOL`` where the ids are equal; returns the largest weight
    difference."""
    (w, ids), (pw, pids) = got, want
    same = (ids == pids).all(-1)
    ties = _route_near_ties(x, router, k)
    tally["moe_route_near_ties"] = tally.get("moe_route_near_ties", 0) + int(
        ties.sum())
    tally["moe_route_ids_differ"] = tally.get("moe_route_ids_differ", 0) + \
        int((~same).sum())
    if not bool((same | ties).all()):
        raise AssertionError("moe_route: ids differ from the plain version's "
                             "away from a near tie")
    return _close(w[same], pw[same], "moe_route weights", ROUTE_TOL) \
        if bool(same.any()) else 0.0


def _router(gen, cfg, T: int):
    """Rows like the normalized bf16 h and an f32 router at the init's
    scale (``small``, 1e-4: probabilities near 1/E)."""
    import torch

    x = torch.randn(T, cfg.d_model, generator=gen, device="cuda").bfloat16()
    router = torch.randn(cfg.d_model, cfg.n_experts, generator=gen,
                         device="cuda") * 1e-4
    return x, router


def check_moe_route(gen, empty_ms: float, arch: str = "deepseek-moe-16b",
                    Ts=(8, 40, 256)) -> list[dict]:
    """The router kernel at ``arch``'s (d, E, k): a decode step's 8 tokens,
    a k = 4 verify's 40 and a prefill chunk's 256, against its plain
    version (``_route_agrees``), timed beside the plain composite (an f32
    product, a softmax, a sort; no single PyTorch call computes the
    function, so ``library_ms`` is none) and, as ``x_empty``, over the same
    run's empty kernel (``empty_ms``, ``phase_floor``); then each token's
    ids and weights bitwise the same at 1, 8, 37, 40, 64 and 256 tokens."""
    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import moe_route as rk, ref

    cfg = get(arch)
    d, E, k = cfg.d_model, cfg.n_experts, cfg.moe_top_k
    x, router = _router(gen, cfg, 256)
    rows = []
    for T in Ts:
        xt = x[:T]
        tally: dict = {}
        err = _route_agrees(rk.moe_route(xt, router, k),
                            ref.moe_route(xt, router, k), xt, router, k,
                            tally)
        plain_ms = _time_ms(lambda: ref.moe_route(xt, router, k))
        rows.append({"shape": {"T": T, "d": d, "E": E, "k": k, "arch": arch},
                     "max_abs_err": err,
                     "near_ties": tally["moe_route_near_ties"],
                     "ids_differ": tally["moe_route_ids_differ"],
                     "ms": _time_ms(lambda: rk.moe_route(xt, router, k)),
                     "plain_ms": plain_ms, "library_ms": None,
                     "library": "none", "composite_ms": plain_ms,
                     **bound(rk.cost(T, d, E, k))})
        rows[-1]["empty_kernel_ms"] = empty_ms
        rows[-1]["x_empty"] = rows[-1]["ms"] / empty_ms
    whole = rk.moe_route(x, router, k)
    invariant = [1, 8, 37, 40, 64, 256]
    for T in invariant:
        part = rk.moe_route(x[:T], router, k)
        if not (torch.equal(part[0], whole[0][:T])
                and torch.equal(part[1], whole[1][:T])):
            raise AssertionError(f"moe_route: tokens' results change at "
                                 f"T = {T}")
    rows[0]["row_invariant_T"] = invariant
    return rows


def _routing_counts(gen, T: int, E: int, k: int):
    """A routing of ``T`` lanes, each to ``k`` distinct random experts:
    the per-expert counts (E,) int64."""
    import torch

    picks = torch.rand(T, E, generator=gen, device="cuda").argsort(-1)[:, :k]
    return torch.bincount(picks.reshape(-1), minlength=E)


def check_gemm_rows_grouped(gen, arch: str = "deepseek-moe-16b",
                            Cs=(N_SLOTS, N_SLOTS * 5)) -> list[dict]:
    """The routed experts' grouped product at each of ``arch``'s decode
    products (gate, up, down) at the decode step's capacity (8 lanes) and a
    k = 4 verify's (40), over a random routing of that many lanes (experts
    no lane chose are empty): the rows below each expert's count against
    the plain version, timed with L2 flushed beside the plain version and
    ``torch.bmm`` on the same buffer (the library call), the bound counting
    only the experts this routing reads; then the MoE layers' products of
    one step in all."""
    from repro_torch.configs import get
    from repro_torch.kernels import gemm_rows as gk, ops

    import torch

    cfg = get(arch)
    E, k = cfg.n_experts, cfg.moe_top_k
    n_moe = cfg.n_layers - cfg.first_k_dense
    rows = []
    for C in Cs:
        counts = _routing_counts(gen, C, E, k)
        active = int((counts > 0).sum())
        n_rows = int(counts.sum())
        keep = torch.arange(C, device="cuda")[None] < counts[:, None]
        step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "cost": None, "max_abs_err": 0.0}
        for name, _, K, N in gk.grouped_products(cfg):
            w = (torch.randn(E, K, N, generator=gen, device="cuda")
                 * K ** -0.5).bfloat16()
            buf = torch.randn(E, C, K, generator=gen, device="cuda").bfloat16()
            buf[~keep] = 0   # dispatch leaves unfilled slots zero
            got = gk.gemm_rows_grouped(buf, w, counts)
            with ops.use_backend("plain"):
                want = ops.gemm_rows_grouped(buf, w, counts)
            err = _close(got[keep], want[keep],
                         f"gemm_rows_grouped {arch} {name} C={C}")
            cost = gk.grouped_cost(E, C, K, N, counts.tolist())
            p = gk.plan_grouped(E, K, N, gk._n_sm(torch.cuda.current_device()))
            row = {"shape": {"E": E, "C": C, "K": K, "N": N, "product": name,
                             "arch": arch, "experts_active": active,
                             "rows": n_rows},
                   "plan": {"tile_n": p.bn, "items": E * p.n_tiles,
                            "grid": p.grid, "stages": p.stages},
                   "max_abs_err": err,
                   "ms": _time_ms(lambda: gk.gemm_rows_grouped(buf, w, counts),
                                  flush=True),
                   "plain_ms": _time_ms(lambda: gk.plain_grouped(buf, w),
                                        flush=True),
                   "library_ms": _time_ms(lambda: torch.bmm(buf, w),
                                          flush=True),
                   **bound(cost)}
            rows.append(row)
            for key in ("ms", "plain_ms", "library_ms"):
                step[key] += n_moe * row[key]
            step["cost"] = n_moe * cost if step["cost"] is None \
                else step["cost"] + n_moe * cost
            step["max_abs_err"] = max(step["max_abs_err"], err)
            del w, buf
        rows.append({"shape": {"C": C, "products": "one step", "arch": arch,
                               "moe_layers": n_moe, "experts_active": active},
                     "max_abs_err": step["max_abs_err"], "ms": step["ms"],
                     "plain_ms": step["plain_ms"],
                     "library_ms": step["library_ms"],
                     **bound(step["cost"])})
    return rows


def check_grouped_invariance(gen, arch: str) -> dict:
    """Bitwise: an (expert, row) result of the grouped product is the same
    at capacity 8, 40 and 64, at another rank (its expert's rows moved down
    by 3), and with the other experts empty (counts 0) or full, at each of
    ``arch``'s products; the rows past an expert's count are not read."""
    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import gemm_rows as gk

    cfg = get(arch)
    E = cfg.n_experts
    out = {}
    for name, _, K, N in gk.grouped_products(cfg):
        w = (torch.randn(E, K, N, generator=gen, device="cuda")
             * K ** -0.5).bfloat16()
        src = torch.randn(E, 64, K, generator=gen, device="cuda").bfloat16()
        full = gk.gemm_rows_grouped(src, w)
        checks = 0
        for C in (8, 40, 64):
            sub = src[:, :C].contiguous()
            for mode in ("random", "others_empty", "others_full"):
                counts = torch.randint(1, C + 1, (E,), generator=gen,
                                       device="cuda")
                if mode != "random":
                    counts[:] = 0 if mode == "others_empty" else C
                    counts[E // 2] = C // 2
                # poison the rows past each count: the kernel must not read
                # them
                poisoned = sub.clone()
                poisoned[torch.arange(C, device="cuda")[None]
                         >= counts[:, None]] = float("nan")
                got = gk.gemm_rows_grouped(poisoned, w, counts)
                keep = torch.arange(C, device="cuda")[None] < counts[:, None]
                if not torch.equal(got[keep], full[:, :C][keep]):
                    raise AssertionError(f"gemm_rows_grouped {arch} {name}: "
                                         f"rows change at C={C} ({mode})")
                checks += 1
            moved = torch.zeros_like(sub)
            moved[:, 3:] = sub[:, :C - 3]
            if not torch.equal(gk.gemm_rows_grouped(moved, w)[:, 3:],
                               full[:, :C - 3]):
                raise AssertionError(f"gemm_rows_grouped {arch} {name}: "
                                     f"rows change with their rank at C={C}")
            checks += 1
        out[f"{name} {E}x{K}x{N}"] = {"bitwise_checks": checks}
        del w, src, full
    return out


def check_unaligned_gemm_rows(gen) -> dict:
    """granite-moe's tied unembedding through ``gemm_rows``: N = 49,155 (no
    multiple of 8), K 1024, w as the (N, K) embedding's transpose and as a
    (K, N) matrix; each row's bits the same at every row count 1-80."""
    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import gemm_rows as gk

    cfg = get("granite-moe-1b-a400m")
    K, N = cfg.d_model, cfg.vocab_size
    out = {}
    for nk in (True, False):
        w = (torch.randn(N, K, generator=gen, device="cuda")
             * K ** -0.5).bfloat16()
        w = w.t() if nk else w.t().contiguous()
        x = torch.randn(80, K, generator=gen, device="cuda").bfloat16()
        y80 = gk.gemm_rows(x, w)
        bad = [M for M in range(1, 81)
               if not torch.equal(gk.gemm_rows(x[:M], w), y80[:M])]
        if bad:
            raise AssertionError(f"gemm_rows N={N} nk={nk}: rows change at "
                                 f"M in {bad[:5]}")
        out["nk" if nk else "kn"] = {"row_counts_1_80_bitwise": True,
                                     "max_abs_err": _close(
                                         y80, x @ w, f"gemm_rows N={N}")}
        del w
    return out


# ---------------------------------------------------------------------------
# 3b. the multimodal families' routes: the encoder's non-causal flash, the
# cross fold, the dense cross read, their decode products
# ---------------------------------------------------------------------------

# whisper-medium's encoder sequence and attention heads (16 of 64, MHA);
# the cross region's pages
from repro_torch.models.encdec import ENC_SEQ  # noqa: E402

W_HEADS, W_D = 16, 64
CROSS_PAGES = -(-ENC_SEQ // PAGE)
MM_ARCHS = ("whisper-medium", "llava-next-mistral-7b")


def check_flash_encoder(gen) -> list[dict]:
    """whisper-medium's encoder attention, the flash kernel's non-causal
    branch (Sq = Sk = 1500 and 750: key tails of 28 and 92 at the 64- and
    128-key tiles, the query tail zero-filled by TMA): against the plain
    version, beside SDPA (no mask) and the bound; each query row alone
    gives its row of the whole call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fk, ops

    rows = []
    for S in (ENC_SEQ, ENC_SEQ // 2):
        q, k, v = (torch.randn(1, S, W_HEADS, W_D, generator=gen,
                               device="cuda").bfloat16() for _ in range(3))
        got = fk.flash_attention(q, k, v, causal=False)
        with ops.use_backend("plain"):
            want = ops.attention(q, k, v, causal=False)
        err = _close(got, want, f"flash_attention non-causal S={S}")
        for r in (0, S // 2, S - 1):
            one = fk.flash_attention(q[:, r:r + 1].contiguous(), k, v,
                                     causal=False)
            _close(one, got[:, r:r + 1], f"flash non-causal S={S} row {r}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rows.append({
            "shape": {"Sq": S, "Sk": S, "causal": False, "H": W_HEADS,
                      "K": W_HEADS, "D": W_D},
            "max_abs_err": err,
            "ms": _time_ms(lambda: fk.flash_attention(q, k, v, causal=False),
                           flush=True),
            "plain_ms": _time_ms(lambda: fk.plain(q, k, v, causal=False),
                                 flush=True),
            "library_ms": _time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt),
                flush=True),
            **bound(fk.cost(1, S, S, W_HEADS, W_HEADS, W_D, causal=False))})
    return rows


def _cross_case(gen, lengths, C):
    """q (B, C, 16, 64) and a pool of whisper's cross pages: each lane's
    24-page region of its own."""
    import torch

    B = len(lengths)
    n_pages = B * CROSS_PAGES + 1
    kp = torch.randn(n_pages, PAGE, W_HEADS, W_D, generator=gen,
                     device="cuda").bfloat16()
    vp = torch.randn(kp.shape, generator=gen, device="cuda").bfloat16()
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(B * 1000 + C)) + 1
    table = perm.reshape(B, CROSS_PAGES).to(torch.int32).cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn(B, C, W_HEADS, W_D, generator=gen,
                    device="cuda").bfloat16()
    return q, kp, vp, table, lens


def check_cross_fold(gen) -> list[dict]:
    """whisper-medium's cross read, folded into the paged decode kernel
    (``ops.paged_cross_attention``): a decode step's 8 lanes (C = 1) at
    lengths 1500 and 750 (the last page partial), and a 256-row prefill
    chunk (C = 256: 32 folded lanes of 8 rows in each of the 16 kv heads'
    groups over a 24-page table) at 1500 and at 750: against the plain
    version, and each folded query (all of C = 1; rows 0-8, 127 and 255 of
    a chunk, every place in a group) bitwise a one-lane decode at its
    length. ``one_row_ms`` times the fold of one row a lane (the TPU path's,
    this route before PR 22's review) on the same inputs."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_decode_attention as pk

    rows = []
    for lengths, C in (([ENC_SEQ, ENC_SEQ // 2] * 4, 1), ([ENC_SEQ], CHUNK),
                       ([ENC_SEQ // 2], CHUNK)):
        q, kp, vp, table, lens = _cross_case(gen, lengths, C)
        got = ops.paged_cross_attention(q, kp, vp, table, lens)
        want = ref.paged_cross_attention(q, kp, vp, table, lens)
        err = _close(got, want, f"paged cross fold C={C} {lengths[:2]}")
        for b in range(len(lengths)):
            for c in sorted({*range(9), C // 2 - 1, C - 1} & set(range(C))):
                one = ops.paged_decode_attention(
                    q[b, c][None].contiguous(), kp, vp, table[b:b + 1],
                    lens[b:b + 1])
                if not torch.equal(one[0], got[b, c]):
                    raise AssertionError(f"cross fold C={C}: query ({b}, "
                                         f"{c}) differs from a one-lane "
                                         f"decode at its length")
        n_keys = int(lens.sum())
        # Q K^T and P V on bf16 operands: the tensor cores' rate; the same
        # work on the f32 units outside them (``bound_f32_ms``)
        cross = functools.partial(pk.cross_cost, len(lengths), C, W_HEADS,
                                  W_HEADS, W_D, table.numel(), n_keys)
        f32 = bound(cross(unit="f32"))
        one_row = (q, kp, vp, table, lens[:, None].expand(len(lengths), C))
        rows.append({
            "shape": {"B": len(lengths), "C": C, "H": W_HEADS, "K": W_HEADS,
                      "D": W_D, "P": PAGE, "table": CROSS_PAGES,
                      "lengths": lengths, "folded_lanes": len(lengths) * C},
            "max_abs_err": err,
            "ms": _time_ms(lambda: ops.paged_cross_attention(
                q, kp, vp, table, lens), flush=True),
            "one_row_ms": _time_ms(lambda: ops._fold(*one_row), flush=True),
            "plain_ms": _time_ms(lambda: ref.paged_cross_attention(
                q, kp, vp, table, lens), flush=True),
            "library_ms": None,
            **bound(cross()),
            "bound_f32_ms": f32["bound_ms"], "bound_f32_by": f32["bound_by"]})
    return rows


def check_rows_invariant(gen, arch: str) -> dict:
    """Each decode product of ``arch`` (``gemm_rows.step_products``)
    through ``gemm_rows``: a row's bits the same at every row count 1-80,
    w as a (K, N) matrix; the unembedding also as the transpose of the
    (N, K) embedding where it is tied (whisper-medium's 51,865 columns)."""
    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import gemm_rows as gk

    out = {}
    for name, K, N, nk, _ in gk.step_products(get(arch)):
        for layout in ((True, False) if nk else (False,)):
            w = (torch.randn(N, K, generator=gen, device="cuda")
                 * K ** -0.5).bfloat16()
            w = w.t() if layout else w.t().contiguous()
            x = torch.randn(80, K, generator=gen, device="cuda").bfloat16()
            y80 = gk.gemm_rows(x, w)
            bad = [M for M in range(1, 81)
                   if not torch.equal(gk.gemm_rows(x[:M], w), y80[:M])]
            if bad:
                raise AssertionError(f"gemm_rows {arch} {name} (K {K}, N "
                                     f"{N}, nk {layout}): rows change at M "
                                     f"in {bad[:5]}")
            out[f"{name} {'nk' if layout else 'kn'}"] = {
                "K": K, "N": N, "row_counts_1_80_bitwise": True,
                "max_abs_err": _close(y80, x @ w, f"gemm_rows {name}")}
            del w
    return out


def phase_kernels(seed: int = 0) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    empty_ms = phase_floor(gen)["empty_kernel_ms"]
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
           "paged_decode_attention@batch": [check_paged_decode_pool(
               gen, [88, 300, 472, 150], BATCH_ENGINE, "batch")],
           # the elastic cell's decode step: 8 slots, a 64-page pool
           "paged_decode_attention@cell": [check_paged_decode_pool(
               gen, CELL_LENGTHS, CELL_ENGINE,
               "cell")],
           # the MoE family: the router and the routed experts' products,
           # deepseek-moe's attention (MHA 16 of 128), every other decode
           # product of each new config (granite-moe's with its tied
           # 49,155-column unembedding)
           "moe_route": check_moe_route(gen, empty_ms),
           "moe_route@granite": check_moe_route(gen, empty_ms,
                                                "granite-moe-1b-a400m"),
           "gemm_rows_grouped": check_gemm_rows_grouped(gen),
           "gemm_rows_grouped@granite": check_gemm_rows_grouped(
               gen, "granite-moe-1b-a400m"),
           "rmsnorm@granite": check_rmsnorm(gen, [(N_SLOTS, 1024)]),
           "paged_decode_attention@deepseek": [
               check_paged_decode(gen, n_heads=16, n_kv=16, d=128)],
           "paged_decode_attention@granite": [
               check_paged_decode(gen, n_heads=16, n_kv=8, d=64)],
           "decode_attention@deepseek": [
               check_decode(gen, n_heads=16, n_kv=16, d=128)],
           "flash_attention@deepseek": check_flash(gen, H=16, K=16, D=128),
           "flash_attention@granite": check_flash(gen, H=16, K=8, D=64),
           **{f"gemm_rows@{arch}": check_gemm_rows(gen, arch, (N_SLOTS,
                                                               N_SLOTS * 5))
              for arch in ("deepseek-moe-16b", "granite-moe-1b-a400m",
                           "phi4-mini-3.8b", "minitron-4b", *MM_ARCHS)},
           # the multimodal families: whisper-medium's block norms (d 1024:
           # a decode step, a chunk, the encoder's 1500 rows), its decoder's
           # attention (16 / 16 of 64), the encoder's non-causal flash, the
           # cross fold and the dense cross read over the ENC_SEQ-padded
           # cache; llava-next-mistral-7b's heads are qwen3-8b's (32 / 8 of
           # 128, d 4096)
           "rmsnorm@whisper": check_rmsnorm(
               gen, [(N_SLOTS, 1024), (CHUNK, 1024), (ENC_SEQ, 1024)]),
           "paged_decode_attention@whisper": [
               check_paged_decode(gen, n_heads=W_HEADS, n_kv=W_HEADS,
                                  d=W_D)],
           "decode_attention@whisper": [
               check_decode(gen, n_heads=W_HEADS, n_kv=W_HEADS, d=W_D)],
           "flash_attention@whisper": check_flash(gen, H=W_HEADS, K=W_HEADS,
                                                  D=W_D),
           "flash_attention@encoder": check_flash_encoder(gen),
           "paged_cross": check_cross_fold(gen),
           "decode_attention@cross": [
               check_decode(gen, n_heads=W_HEADS, n_kv=W_HEADS, d=W_D,
                            S=ENC_SEQ,
                            lengths=(ENC_SEQ, 750, ENC_SEQ, 1, 750, 1300,
                                     ENC_SEQ - 1, 64))]}
    for name, rows in out.items():
        for r in rows:
            r.update(_factors(r))
            log({"kernel_check": name, **r})
    invariance = {arch: check_grouped_invariance(gen, arch)
                  for arch in MOE_ARCHS}
    log({"kernel_check": "gemm_rows_grouped bitwise", **invariance})
    log({"kernel_check": "gemm_rows N 49155 bitwise",
         **check_unaligned_gemm_rows(gen)})
    for arch in MM_ARCHS:
        log({"kernel_check": f"gemm_rows@{arch} bitwise at 1-80 rows",
             **check_rows_invariant(gen, arch)})
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


def _mm_input(cfg, rng, rows: int | None = None):
    """One request's modality input for a multimodal ``cfg``: whisper's
    frames ``(1, rows or ENC_SEQ, d_model)`` or llava's image rows ``(1,
    n_image_tokens, VISION_D)``, f32 from ``rng``; None for a text-only
    config."""
    import numpy as np

    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (1, rows or ENC_SEQ, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        from repro_torch.models.transformer import VISION_D

        return {"embeds": rng.standard_normal(
            (1, cfg.n_image_tokens, VISION_D)).astype(np.float32)}
    return None


def _mm_traffic(cfg, seed: int):
    """The multimodal serve traffic (16 requests): prompts, each request's
    ``extra`` and the counters the engine must show.

    whisper-medium: decoder prompts of 32-448 tokens; requests 0, 2, .., 14
    share one 1500-row frames input (the shared region), 1, 5, 9, 13 have
    distinct 1500-row inputs, 3, 7, 11, 15 distinct 750-row inputs (a
    partial last cross page); request 5 has request 0's text under other
    frames, so its prompt shares nothing. Expected: 9 regions computed, 7
    shared, 7 x 24 pages shared.

    llava-next-mistral-7b: 576 image rows each, then 96-1024 text tokens;
    requests 1, 5, 9, 13 share one image and a 256-token text prefix (the
    later three share its whole pages: 13 of them, 3 x 832 positions),
    request 2 has request 0's text under another image (nothing
    shared)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    if cfg.family == "encdec":
        lens = rng.integers(32, 449, 16)
        prompts = [rng.integers(1, V, int(n)).tolist() for n in lens]
        prompts[5] = list(prompts[0])
        shared = _mm_input(cfg, rng)
        extras = [shared if i % 2 == 0 else
                  _mm_input(cfg, rng, ENC_SEQ if i % 4 == 1 else ENC_SEQ // 2)
                  for i in range(16)]
        expect = {"cross_regions_computed": 9, "cross_regions_shared": 7,
                  "cross_pages_shared": 7 * CROSS_PAGES}
        return prompts, extras, expect
    lens = rng.integers(96, 1025, 16)
    prefix = rng.integers(1, V, 256).tolist()
    image = _mm_input(cfg, rng)
    prompts, extras = [], []
    for i, n in enumerate(lens):
        if i % 4 == 1:
            prompts.append(prefix + rng.integers(
                1, V, max(int(n) - 256, 32)).tolist())
            extras.append(image)
        else:
            prompts.append(rng.integers(1, V, int(n)).tolist())
            extras.append(_mm_input(cfg, rng))
    prompts[2] = list(prompts[0])
    shared = (cfg.n_image_tokens + 256) // PAGE * PAGE
    expect = {"prefill_tokens_shared": 3 * shared}
    return prompts, extras, expect


def _engine_kw(cfg) -> dict:
    """The smoke engines' cross region: whisper's 1500 frames (24 pages) a
    slot, not ``max_seq``'s 32."""
    return {"max_cross_seq": ENC_SEQ} if cfg.family == "encdec" else {}


def _warm(engine, cfg) -> None:
    """A warm-up request (cuBLAS handles, the allocator), a multimodal one
    with an input of its own, then a clean slate."""
    import numpy as np

    engine.submit(list(range(1, 300)), max_new_tokens=2,
                  extra=_mm_input(cfg, np.random.default_rng(99)))
    engine.run()
    engine.reset_stats()


def _route_launches(module, attr: str, kernel, into: dict, key: str,
                    when=lambda *a, **k: True):
    """Patch ``module.attr`` so that the launches of ``kernel`` made inside
    its calls (those ``when`` accepts) are added to ``into[key]``: the
    launches of one route of a kernel (the cross fold, the encoder's
    flash, the dense cross read). Returns the undo."""
    orig = getattr(module, attr)

    def run(*args, **kw):
        if not when(*args, **kw):
            return orig(*args, **kw)
        before = kernel.launches
        out = orig(*args, **kw)
        into[key] = into.get(key, 0) + kernel.launches - before
        return out

    setattr(module, attr, run)
    return lambda: setattr(module, attr, orig)


# kernels each model's path launches (every one of them must run in its
# serve phase; no plain version may)
_DENSE_PAGED = ("rmsnorm", "paged_decode_attention", "flash_attention",
                "gemm_rows")
_MOE_PAGED = _DENSE_PAGED + ("moe_route", "gemm_rows_grouped")
PATH_KERNELS = {
    "qwen3-8b": _DENSE_PAGED,
    "falcon-mamba-7b": ("rmsnorm", "selective_scan"),
    "zamba2-1.2b": ("rmsnorm", "paged_decode_attention", "flash_attention",
                    "ssd"),
    "deepseek-moe-16b": _MOE_PAGED,
    "granite-moe-1b-a400m": _MOE_PAGED,
    "phi4-mini-3.8b": _DENSE_PAGED,
    "minitron-4b": _DENSE_PAGED,
    "whisper-medium": _DENSE_PAGED,
    "llava-next-mistral-7b": _DENSE_PAGED,
}
# the same for the dense engine (``paged=False``)
DENSE_PATH_KERNELS = {
    "qwen3-8b": ("rmsnorm", "decode_attention", "flash_attention"),
    "falcon-mamba-7b": ("rmsnorm", "selective_scan"),
    "zamba2-1.2b": ("rmsnorm", "decode_attention", "flash_attention", "ssd"),
    "deepseek-moe-16b": ("rmsnorm", "decode_attention", "flash_attention",
                         "moe_route"),
    "whisper-medium": ("rmsnorm", "decode_attention", "flash_attention"),
    "llava-next-mistral-7b": ("rmsnorm", "decode_attention",
                              "flash_attention"),
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


def _per_call(fn, into: dict):
    """``fn`` with the kernel launches of its first call recorded in
    ``into``."""
    from repro_torch.kernels import ops

    def run(*args, **kw):
        before = ops.counts()
        out = fn(*args, **kw)
        if not into:
            into.update({k: ops.counts()[k]["launches"] - v["launches"]
                         for k, v in before.items()})
        return out
    return run


def phase_serve(model, params, seed: int = 0, *, short: bool = False) -> dict:
    """The smoke traffic (16 requests, 32 new tokens each, on ``N_SLOTS``
    slots; ``short``: its first 8, 16 new tokens each, on half the slots,
    so that request 5 is admitted after request 1's prefix is cached)
    through the paged engine."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServeEngine

    cfg = model.cfg
    slots = N_SLOTS // 2 if short else N_SLOTS
    engine = ServeEngine(model, params, n_slots=slots, max_seq=MAX_SEQ,
                         page_size=PAGE, prefill_chunk=CHUNK, device="cuda",
                         **_engine_kw(cfg))
    _warm(engine, cfg)
    per_step: dict = {}
    per_chunk: dict = {}
    engine.model = dataclasses.replace(
        model, decode_paged=_per_call(model.decode_paged, per_step),
        prefill_chunk=_per_call(model.prefill_chunk, per_chunk))
    expect = None
    if cfg.family in ("encdec", "vlm"):
        prompts, extras, expect = _mm_traffic(cfg, seed)
    else:
        prompts = _traffic(seed, cfg.vocab_size)
        extras = [None] * len(prompts)
    n_new = 32
    if short:
        prompts, n_new = prompts[:8], 16
    # the launches of the paged decode kernel's cross route and of the
    # encoder's flash (whisper)
    routes: dict = {}
    undo = []
    if cfg.family == "encdec":
        from repro_torch.kernels import flash_attention as fk
        from repro_torch.kernels import ops as ops_mod
        from repro_torch.kernels import paged_decode_attention as pk
        from repro_torch.models import encdec

        # the decode step's cross read (C = 1) and a chunk's (C > 1) apart
        undo = [_route_launches(ops_mod, "paged_cross_attention",
                                pk.paged_decode_attention, routes, "cross",
                                when=lambda q, *a: q.shape[1] == 1),
                _route_launches(ops_mod, "paged_cross_attention",
                                pk.paged_decode_attention, routes,
                                "cross chunk",
                                when=lambda q, *a: q.shape[1] > 1),
                _route_launches(encdec, "encode", fk.flash_attention, routes,
                                "encoder")]
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
    reqs = [engine.submit(p, max_new_tokens=n_new, extra=e)
            for p, e in zip(prompts, extras)]
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
    for fn in reversed(undo):  # the last patch of an attribute first
        fn()
    done = [r for r in reqs if r.done]
    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)}/{len(reqs)} requests completed")
    _check_counts(counts, PATH_KERNELS[cfg.arch_id], "paged serve")
    stats = engine.stats
    got = {k: stats[k] for k in expect} if expect else None
    if expect and got != expect:
        raise AssertionError(f"multimodal counters {got}, expected {expect}")
    if cfg.family == "encdec" and not (routes.get("cross")
                                       and routes.get("cross chunk")
                                       and routes.get("encoder")):
        raise AssertionError(f"enc-dec routes not launched: {routes}")
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
    elif stats["prefix_hits"] <= 0 and cfg.family != "encdec":
        raise AssertionError("the shared prefix was never hit")
    n_gen = sum(len(r.generated) for r in reqs)
    out = {
        "phase": "serve", "arch": cfg.arch_id, "layers": cfg.n_layers,
        "params_b": round(cfg.param_count() / 1e9, 3), "slots": slots,
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
        "multimodal_counters": got, "multimodal_expected": expect,
        "cross_cache_stats": ({k: stats[k] for k in (
            "cross_regions_computed", "cross_regions_shared",
            "cross_pages_shared")} if cfg.family == "encdec" else None),
        "launches": {n: c["launches"] for n, c in counts.items()},
        "route_launches": routes,
        "launches_per_call": {"decode_step": per_step,
                              "prefill_chunk": per_chunk},
    }
    log(out)
    out["tokens"] = [r.generated for r in reqs]
    return out


# the profiled serve: short, since the profiler's own trace processing
# grows with the launches it records (8 requests of 512 tokens and 8 new
# cost 240 s in the four profiles of qwen3-8b, falcon-mamba, zamba2 and
# deepseek-moe on an H100 80GB HBM3 at 700 W, falcon-mamba's 99.7 s for a
# 4.7 s serve)
PROFILE_REQUESTS, PROFILE_PROMPT, PROFILE_NEW = 4, 256, 4


def phase_profile(model, params, seed: int = 2) -> dict:
    """Where the time goes: ``torch.profiler`` over a short serve
    (``PROFILE_REQUESTS`` requests of ``PROFILE_PROMPT`` prompt tokens,
    ``PROFILE_NEW`` new tokens each, a multimodal one with its inputs) on a
    warm engine — the device's busy share of the wall time and the kernels
    that fill it."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import ServeEngine

    rng = np.random.default_rng(seed)
    cfg = model.cfg
    engine = ServeEngine(model, params, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                         page_size=PAGE, prefill_chunk=CHUNK, device="cuda",
                         **_engine_kw(cfg))
    _warm(engine, cfg)
    for _ in range(PROFILE_REQUESTS):
        engine.submit(rng.integers(1, cfg.vocab_size,
                                   PROFILE_PROMPT).tolist(),
                      max_new_tokens=PROFILE_NEW, extra=_mm_input(cfg, rng))
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
    out = {"phase": "profile", "arch": cfg.arch_id,
           "requests": PROFILE_REQUESTS, "prompt_tokens": PROFILE_PROMPT,
           "new_tokens": PROFILE_NEW, "wall_s": wall, "device_busy_s": busy,
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
# deepseek-moe-16b and granite-moe-1b-a400m: no bound either. The router's
# init is ``small`` (1e-4), so every expert's probability sits near 1/E and
# a rounding-sized difference in h reorders experts: random-weight routing
# is chaotic. The kernel-forced check holds the router (ids equal but at a
# near tie, counted) and the grouped product there.
# whisper-medium: the first measured run (H100 80GB HBM3, 700 W) gave 0.047
# at most, mean 0.0079, on logits up to 2.98 (the one-ulp control 0.041);
# the bound is about twice that. llava-next-mistral-7b: qwen3-8b's 0.5.
# Five readings (H100 80GB HBM3, 700 W; ``tools/logit_spread.py`` at seeds
# 1-4 and this phase) gave 0.176-0.211 on logits up to 5.4; the fault
# control, the image/text split one row early, moved the logits by
# 0.766-0.891, and the phase fails if it ever moves them by less than the
# bound: the bound must catch a broken split.
LOGIT_ATOL = {"qwen3-8b": 0.5, "falcon-mamba-7b": None, "zamba2-1.2b": None,
              "deepseek-moe-16b": None, "granite-moe-1b-a400m": None,
              "whisper-medium": 0.1, "llava-next-mistral-7b": 0.5}


def _teacher_forced(model, params, prompts, forced, n_steps: int, *,
                    device: str = "cuda", extras=None, mm_shift: int = 0):
    """Prefill each prompt (one slot each), then ``n_steps`` batched decode
    steps feeding ``forced`` tokens; returns the logits of every step
    (prefill's first-token logits first) and the launches per call. A
    multimodal prompt takes its ``extras[b]``: a VLM's image rows chunked
    inline ahead of the text (``embeds``, ``mm_len``), an enc-dec's frames
    through ``prefill_cross`` into a region of the lane's own that every
    chunk and decode step reads (``cross_page_table``, ``cross_len``).
    ``mm_shift`` tells the model an ``mm_len`` that many rows short: a
    broken image/text split, its last image rows read as text (token 0)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    B = len(prompts)
    extras = extras or [None] * B
    cross = model.supports_paged_cross
    mm = [int(np.asarray(e["embeds"]).shape[-2])
          if e and "embeds" in e else 0 for e in extras]
    max_pages = MAX_SEQ // PAGE
    n_cp = CROSS_PAGES if cross else 0
    cache = model.init_paged_cache(B, B * (max_pages + n_cp) + 1, PAGE,
                                   device=device)
    table = torch.zeros(B, max_pages, dtype=torch.int32, device=device)
    for b in range(B):
        table[b] = torch.arange(1 + b * max_pages, 1 + (b + 1) * max_pages)
    ctx: dict = {}
    if cross:
        base = 1 + B * max_pages
        ctable = torch.arange(base, base + B * n_cp, dtype=torch.int32,
                              device=device).reshape(B, n_cp)
        clen = torch.tensor([e["frames"].shape[-2] for e in extras],
                            dtype=torch.int32, device=device)
        for b, e in enumerate(extras):
            model.prefill_cross(params, cache, {
                "frames": torch.from_numpy(e["frames"]).to(device),
                "cross_page_table": ctable[b]})
        ctx = {"cross_page_table": ctable, "cross_len": clen}
    rows, per_call = [], {}
    first = []
    for b, p in enumerate(prompts):
        tlen = mm[b] + len(p)
        for off in range(0, tlen, CHUNK):
            n = min(CHUNK, tlen - off)
            si = min(max(mm[b] - off, 0), n)      # image rows in the chunk
            toks = torch.zeros(1, CHUNK, dtype=torch.int32, device=device)
            toks[0, si:n] = torch.tensor(p[off + si - mm[b]:off + n - mm[b]])
            batch = {"tokens": toks, "valid": n, "slot": b,
                     "page_table": table[b]}
            kw = {}
            if model.paged_mm_inline:
                emb = np.zeros((1, CHUNK, extras[b]["embeds"].shape[-1]),
                               np.float32)
                emb[0, :si] = extras[b]["embeds"][0, off:off + si]
                batch["embeds"] = torch.from_numpy(emb).to(device)
                kw["mm_len"] = mm[b] - mm_shift
            if cross:
                batch.update(cross_page_table=ctable[b], cross_len=clen[b])
            before = ops.counts()
            lg = model.prefill_chunk(params, cache, batch, offset=off, **kw)
            per_call.setdefault("prefill_chunk", {
                k: ops.counts()[k]["launches"] - v["launches"]
                for k, v in before.items()})
        first.append(lg[0])
    rows.append(torch.stack(first))
    pos = torch.tensor([m + len(p) for m, p in zip(mm, prompts)],
                       dtype=torch.int32, device=device)
    for s in range(n_steps):
        toks = torch.tensor([[forced[b][s]] for b in range(B)],
                            dtype=torch.int32, device=device)
        before = ops.counts()
        lg = model.decode_paged(params, cache, {
            "tokens": toks, "positions": pos, "page_table": table, **ctx})
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
                "gemm_rows": "gemm_rows", "moe_route": "moe_route",
                "gemm_rows_grouped": "gemm_rows_grouped"}
    saved = {n: getattr(ops, n) for n in dispatch}
    worst: dict[str, float] = {}
    # the cross route (enc-dec): the paged decode kernel over the folded
    # query rows, i.e. the dispatch itself under the kernel backend
    cross = ops.paged_cross_attention

    def fold(*args):
        with ops.use_backend("kernel"):
            return cross(*args)

    def both(name, plain, kernel):
        def run(*args, **kw):
            want = plain(*args, **kw)
            got = kernel(*args, **kw)
            if name == "moe_route":   # ids: equal but at a near tie
                worst[name] = max(worst.get(name, 0.0),
                                  _route_agrees(got, want, args[0], args[1],
                                                args[2], worst))
                return want
            if name == "gemm_rows_grouped" and len(args) > 2:
                # the kernel leaves rows past each expert's count unwritten
                keep = torch.arange(want.shape[1], device=want.device)[
                    None] < args[2][:, None]
                got, want_cmp = got[keep], want[keep]
                err = _close(got, want_cmp, f"kernel-forced {name}")
                worst[name] = max(worst.get(name, 0.0), err)
                return want
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
    ops.paged_cross_attention = both("paged_cross_attention", cross, fold)
    try:
        with ops.use_backend("plain"):
            run()
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)
        ops.paged_cross_attention = cross
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
    # whisper: a full and a half encoder input; llava: an image each
    extras = [_mm_input(model.cfg, rng, rows) for rows in (ENC_SEQ, 750)]
    tf = functools.partial(_teacher_forced, extras=extras)
    got, per_call = tf(model, params, prompts, forced, 8)
    with ops.use_backend("plain"):
        want, _ = tf(model, params, prompts, forced, 8)
        # controls: the plain path with one bf16 ulp added to one embedding
        # value (the first prompt token's first), and to every embedding
        # value, each up or down at random — how far rounding-sized
        # differences alone move the logits
        emb = params.embedding.data
        t0 = prompts[0][0]
        keep = emb.clone()
        try:
            emb[t0, 0] = (keep[t0, 0].float() * (1 + 2 ** -7)).to(emb.dtype)
            nudged, _ = tf(model, params, prompts, forced, 8)
            gen = torch.Generator(device="cuda").manual_seed(seed)
            sign = torch.randint(0, 2, keep.shape, generator=gen,
                                 device="cuda", dtype=torch.int8) * 2 - 1
            emb.copy_((keep.float() * (1 + sign * 2.0 ** -7)).to(emb.dtype))
            nudged_all, _ = tf(model, params, prompts, forced, 8)
        finally:
            emb.copy_(keep)
        del keep
        # a VLM's fault control: the image/text split one row early (the
        # last image row read as a text token), the size of fault the
        # bound must catch
        split = tf(model, params, prompts, forced, 8,
                   mm_shift=1)[0] if model.paged_mm_inline else None
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
           "split_control_max_abs_diff":
               None if split is None else (split - want).abs().max().item(),
           "atol": atol, "launches_per_call": per_call}
    out["kernel_forced_max_abs_err"] = _kernel_forced(
        lambda: tf(model, params, prompts, forced, 8))
    log(out)
    if atol is not None and (diff.max().item() > atol
                             or tie_gap.item() > atol):
        raise AssertionError(f"kernel and plain logits differ by "
                             f"{diff.max().item():.4g}, greedy choices by "
                             f"{tie_gap.item():.4g} (bound {atol})")
    split_diff = out["split_control_max_abs_diff"]
    if atol is not None and split_diff is not None and split_diff <= atol:
        raise AssertionError(f"a broken image/text split moves the logits "
                             f"by {split_diff:.4g}, within the bound {atol}")
    return out


# ---------------------------------------------------------------------------
# 6. dense: the engine's paged=False path
# ---------------------------------------------------------------------------


def _teacher_forced_dense(model, params, prompts, forced, n_steps: int,
                          extras=None):
    """The dense path's counterpart of :func:`_teacher_forced`: each prompt
    right-aligned in its bucket (after a VLM's image rows; with an
    enc-dec's frames), prefilled whole and scattered into its slot of a
    dense cache, then ``n_steps`` batched ``decode_step`` calls feeding
    ``forced`` tokens; returns the launches per call."""
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
        batch = {"tokens": toks}
        for k, v in ((extras or [None] * B)[b] or {}).items():
            batch[k] = torch.from_numpy(v).cuda()
        before = ops.counts()
        _, pcache = model.prefill(params, batch)
        per_call.setdefault("prefill", launches(before))
        scatter_slot(cache, expand_prefill_cache(
            pcache, {k: v[:, :1] for k, v in cache.items()}), b)
        pos.append(n + (batch["embeds"].shape[1] if "embeds" in batch
                        else 0))
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
    _warm(engine, cfg)
    if cfg.family in ("encdec", "vlm"):
        prompts, extras, _ = _mm_traffic(cfg, seed)
    else:
        prompts, extras = _traffic(seed, cfg.vocab_size), [None] * 16
    # the dense cross read's and the encoder's launches (whisper)
    routes: dict = {}
    undo = []
    if cfg.family == "encdec":
        from repro_torch.kernels import decode_attention as dk
        from repro_torch.kernels import flash_attention as fk
        from repro_torch.models import encdec, layers

        undo = [_route_launches(layers, "attn_decode", dk.decode_attention,
                                routes, "dense cross",
                                lambda *a, **k: k.get("update_cache") is
                                False),
                _route_launches(encdec, "encode", fk.flash_attention, routes,
                                "encoder")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=32, extra=e)
            for p, e in zip(prompts, extras)]
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
    for fn in reversed(undo):  # the last patch of an attribute first
        fn()
    if not all(r.done for r in reqs):
        raise AssertionError("dense serve: not every request completed")
    _check_counts(counts, DENSE_PATH_KERNELS[cfg.arch_id], "dense serve")
    if cfg.family == "encdec" and not (routes.get("dense cross")
                                       and routes.get("encoder")):
        raise AssertionError(f"dense enc-dec routes not launched: {routes}")
    tokens = [r.generated for r in reqs]
    n_gen = sum(map(len, tokens))
    same = sum(a == b for t, u in zip(tokens, paged_tokens)
               for a, b in zip(t, u))
    rng = np.random.default_rng(seed + 1)
    tf_prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                  for n in (700, 300)]
    forced = rng.integers(1, cfg.vocab_size, (2, 8)).tolist()
    tf_extras = [_mm_input(cfg, rng, rows) for rows in (ENC_SEQ, 750)]
    per_call = _teacher_forced_dense(model, params, tf_prompts, forced, 8,
                                     tf_extras)
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
        "route_launches": routes,
        "launches_per_call": per_call,
        "kernel_forced_max_abs_err": _kernel_forced(
            lambda: _teacher_forced_dense(model, params, tf_prompts, forced,
                                          8, tf_extras)),
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
    cfg = model.cfg
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(100, 601, 8)]
    extras = [_mm_input(cfg, rng) for _ in prompts]

    def engine():
        return ServeEngine(model, params, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                           page_size=PAGE, prefill_chunk=CHUNK, paged=paged,
                           device="cuda", **(_engine_kw(cfg) if paged else {}))

    def submit(eng):
        return [eng.submit(p, max_new_tokens=16, extra=e)
                for p, e in zip(prompts, extras)]

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

CLI_ARCHS = ("qwen3-8b", "zamba2-1.2b", "falcon-mamba-7b",
             "granite-moe-1b-a400m")
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
    (of its region's leaves: an enc-dec cross page's ``cross_*`` pools, any
    other page the rest) when its trie node becomes a stub, and, when the
    stub is recalled, whether the page it lands in holds the same bits
    (counted; ``cross`` counts the cross pages recalled)."""
    import torch

    idx = engine.prefix_index
    seen = {"stubs": {}, "recalled": 0, "equal": 0, "cross": 0}
    remap = idx.remap

    def spy(old: int, new: int) -> None:
        if old < engine.n_pages <= new:            # lent
            keys = engine._region_keys(cross=engine._node_is_cross(old))
            seen["stubs"][new] = {k: v[:, old].clone()
                                  for k, v in engine.cache.items()
                                  if k.endswith("_pages")
                                  and (keys is None or k in keys)}
        elif new < engine.n_pages <= old:          # recalled, installed
            bits = seen["stubs"].pop(old)
            seen["recalled"] += 1
            seen["cross"] += any(k.startswith("cross_") for k in bits)
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
# whisper's cross-region spill: one request holds ceil((200 + 16) / 64) = 4
# decoder pages and a 24-page region; a pool of 28 + 20 usable pages keeps
# one request's pages and 20 more, so the second request reallocates 8 of
# the first's cached pages (its 4 decoder pages and 4 region pages, the
# coldest) and they are lent; the budget covers a whole region's recalls
CROSS_SPILL_PROMPT, CROSS_SPILL_NEW = 200, 16
CROSS_SPILL_POOL = 1 + 4 + CROSS_PAGES + 20


def phase_cross_spill(model, params, card: str, seed: int = 7) -> dict:
    """The spill tier's cross branch at full width (whisper-medium): A
    (frames F0) is served, B (other frames, another prompt) reallocates
    some of A's cached pages, which are lent to a peer (decoder pages and
    encoder-region pages, each payload one region's leaves); A's prompt
    and frames again share the cached region through the recall of its
    lent pages (the encoder not run), every recalled page bitwise the lent
    one, and the tokens equal A's first ones. Every kernel of the paged
    path launched, no plain version."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServeEngine

    cfg = model.cfg
    rng = np.random.default_rng(seed)
    _, remote = _cloudlet_pool()
    engine = ServeEngine(model, params, n_slots=1, max_seq=MAX_SEQ,
                         page_size=PAGE, prefill_chunk=CHUNK,
                         n_pages=CROSS_SPILL_POOL, remote_pool=remote,
                         recall_budget=64, device="cuda", **_engine_kw(cfg))
    seen = _watch_spilled_pages(engine)
    a_prompt, b_prompt = (rng.integers(1, cfg.vocab_size,
                                       CROSS_SPILL_PROMPT).tolist()
                          for _ in range(2))
    a_in, b_in = _mm_input(cfg, rng), _mm_input(cfg, rng)
    ops.reset_counts()
    out_tokens, seconds = [], []
    for prompt, extra in ((a_prompt, a_in), (b_prompt, b_in),
                          (a_prompt, a_in)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        req = engine.submit(prompt, max_new_tokens=CROSS_SPILL_NEW,
                            extra=extra)
        engine.run()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        out_tokens.append(req.generated)
    counts = ops.counts()
    _check_counts(counts, PATH_KERNELS[cfg.arch_id], "cross spill")
    st = engine.stats
    out = {"phase": "cross_spill", "arch": cfg.arch_id, "card": card,
           "pool_pages": CROSS_SPILL_POOL, "region_pages": CROSS_PAGES,
           **{k: st[k] for k in (
               "pages_spilled", "pages_recalled", "recall_misses",
               "cross_regions_computed", "cross_regions_shared",
               "cross_pages_shared", "prefill_tokens_shared")},
           "recalled_pages": seen["recalled"],
           "recalled_cross_pages": seen["cross"],
           "recalled_pages_bitwise_equal": seen["equal"],
           "tokens_equal": out_tokens[2] == out_tokens[0],
           "request_seconds": seconds,
           "pool_outstanding": engine.pool.outstanding,
           "launches": {n: c["launches"] for n, c in counts.items()}}
    log(out)
    problems = []
    if not (st["pages_spilled"] and st["pages_recalled"]
            and seen["cross"]):
        problems.append("no cross page spilled and recalled")
    if seen["equal"] != seen["recalled"]:
        problems.append("a recalled page differs from the lent one")
    if (st["cross_regions_computed"], st["cross_regions_shared"]) != (2, 1):
        problems.append("the repeat did not share A's region")
    if out_tokens[2] != out_tokens[0]:
        problems.append("the recalled region changed the tokens")
    if engine.pool.outstanding:
        problems.append("pages left outstanding")
    if problems:
        raise AssertionError("cross spill: " + "; ".join(problems))
    return out


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


def _self_draft(model, params, prompts, kw, path: tuple) -> dict:
    """The same prompts through a plain engine and a self-draft engine
    (``spec_k`` ``SPEC_K``): equal tokens, every proposal accepted, every
    kernel of ``path`` launched and no plain version; the medians of a
    plain decode step, a draft step and a verify pass, and the launches of
    a spec round and of a verify."""
    import gc as _gc

    import torch

    from repro_torch.kernels import ops

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
    spec._spec_step = _per_call(spec._spec_step, per_round)
    spec.model.verify_paged = _per_call(spec.model.verify_paged, per_verify)
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
    _check_counts(counts, path, "spec self-draft")
    decode_med = statistics.median(plain_ms)
    verify_med = statistics.median(spec.verify_ms)
    out = {
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
    return out


def phase_spec_moe(model, params, card: str, seed: int = 5) -> dict:
    """Greedy self-draft speculation on full-width deepseek-moe-16b (its
    granite-moe draft differs in vocab at published widths, R4): 8 requests
    of 96-1024 tokens, ``SPEC_NEW`` new each, through a plain and a
    self-draft engine (``_self_draft``): plain decode's tokens with every
    proposal accepted, which needs the 8-lane decode step and the 40-lane
    verify to route and multiply every lane alike."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, model.cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(96, 1025, 8)]
    kw = dict(n_slots=N_SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
              prefill_chunk=CHUNK, device="cuda")
    out = {"phase": "spec", "arch": model.cfg.arch_id, "card": card,
           "spec_k": SPEC_K,
           "self_draft": _self_draft(model, params, prompts, kw,
                                     PATH_KERNELS[model.cfg.arch_id])}
    log(out)
    return out


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
    out["self_draft"] = _self_draft(model, params, prompts, kw,
                                    SPEC_PATH_KERNELS)
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
# 4k. the elastic serving cell
# ---------------------------------------------------------------------------

# The cell's engines (``phase_cell``): 8 slots over a 64-page pool of 64
# (36 layers x 2 x 8 kv heads x 128 x 2 B x 64 = 9,437,184 B a page), so
# a snapshot carries ~0.6 GB
CELL_ENGINE = dict(n_slots=8, max_seq=512, page_size=PAGE, n_pages=64)
# the cell's decode step's lane lengths in the kernel checks
CELL_LENGTHS = [130, 250, 416, 96, 300, 180, 384, 222]
# 4 hosts of 2 lanes on a model axis of 2: the (2, 2) grid; the simulated
# clock as tests/test_cell.py sets it, but a re-shard's bytes move at
# 12.5 GB/s (a 100 Gb/s link): full-width formation "moves" ~17 GB, 3.4
# simulated s, below the 6 s failure timeout (at the reference's default
# 64 MB/s it would take 267 s)
CELL_HOSTS = 4
CELL = dict(model_parallel=2, target_hosts=CELL_HOSTS, min_hosts=1,
            slots_per_host=2, decode_step_s=1.0, collective_s=0.1,
            step_deadline_s=4.0, snapshot_every_s=6.0, reshard_fixed_s=2.0,
            reshard_bw_bytes_s=12.5e9)
CELL_FAILURE_TIMEOUT_S = 6.0
CELL_PROMPTS, CELL_PROMPT_LENS, CELL_NEW = 8, (96, 384), 32
CELL_PRIORITIES = (0, 0, 1, 1, 2, 2, 3, 3)
# each scenario: settings over CELL, priorities or None, and its faults as
# (simulated seconds after formation ends, kind, host, slow factor)
# (a crash lands one step after the snapshot of the sixth step, so the
# re-shard resumes from it and replays a token a lane)
CELL_SCENARIOS = {
    "clean": ({}, None, []),
    "crash_rejoin": ({}, None, [(6.5, "crash", "h1", None),
                                (17.0, "rejoin", "h1", None)]),
    "shed": ({"min_hosts": 2}, CELL_PRIORITIES,
             [(6.5, "crash", "h2", None), (6.5, "crash", "h3", None)]),
    "straggler": ({}, None, [(7.0, "slow", "h0", 8.0)]),
}
# device memory after a run (the cell and its server dropped) against
# before it: within less than one pool (0.604 GB)
CELL_MEM_SLACK_BYTES = 0.25e9


def _cell_prompts(vocab: int, seed: int) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi = CELL_PROMPT_LENS
    return [rng.integers(1, vocab, int(n)).tolist()
            for n in rng.integers(lo, hi + 1, CELL_PROMPTS)]


def _cell_formed(model, params, factory, name: str, prompts):
    """One scenario's cloudlet, server and cell over ``factory``, its
    requests submitted and the cell formed (one tick of ``run``); the
    fault plan timed from the end of formation. Returns (server, cell,
    requests, clock, plan)."""
    from repro_torch.core.faults import FaultEvent, FaultPlan
    from repro_torch.core.server import AdHocServer
    from repro_torch.core.simulation import SimClock
    from repro_torch.serving.cell import ElasticServeCell

    settings, prios, faults = CELL_SCENARIOS[name]
    srv = AdHocServer(failure_timeout=CELL_FAILURE_TIMEOUT_S)
    srv.create_cloudlet("cell", model.cfg.arch_id)
    for i in range(CELL_HOSTS):
        srv.register_host(f"h{i}", 0.0, cloudlets=["cell"])
    cell = ElasticServeCell(srv, "cell", model, params, factory=factory,
                            **{**CELL, **settings})
    reqs = [cell.submit(p, max_new_tokens=CELL_NEW,
                        priority=prios[i] if prios else 0)
            for i, p in enumerate(prompts)]
    clock = SimClock()
    cell.run(clock, max_ticks=1)
    formed = [kv for _, ev, kv in srv.log if ev == "cell_resharded"]
    if [kv["cause"] for kv in formed] != ["form"] or cell.grid != (2, 2):
        raise AssertionError(f"cell {name}: formation {formed}, "
                             f"grid {cell.grid}")
    t0 = clock.now()
    plan = FaultPlan([FaultEvent(at=t0 + dt, kind=kind, host=host,
                                 **({"factor": f} if f else {}))
                      for dt, kind, host, f in faults])
    return srv, cell, reqs, clock, plan


def _cell_checks(name: str, s: dict, cell, reqs, want) -> list[str]:
    """What tests/test_cell.py asserts for the scenario, at full width:
    every stream done equals the trusted engine's, every shed one is an
    exact prefix of it, nothing pending, no host lost but to a crash."""
    faults = CELL_SCENARIOS[name][2]
    crashes = sum(kind == "crash" for _, kind, _, _ in faults)
    problems = []
    for r in reqs:
        if r.state == "done" and r.committed != want[r.req_id]:
            problems.append(f"request {r.req_id}: stream differs")
        if r.state == "shed" and r.committed != \
                want[r.req_id][:len(r.committed)]:
            problems.append(f"request {r.req_id}: shed stream not a prefix")
    if s["requests_pending"] or s["requests_done"] + s["requests_shed"] \
            != len(reqs):
        problems.append("requests left pending")
    if s["hosts_lost"] != crashes:
        problems.append(f"{s['hosts_lost']} hosts lost, {crashes} crashed")
    if name == "clean":
        if (s["grid"] != (2, 2) or s["resharded"] or s["tokens_replayed"]
                or s["slots_shed"] or s["requests_done"] != len(reqs)):
            problems.append("a clean run re-sharded, replayed or shed")
    elif name == "crash_rejoin":
        if not (s["collective_timeouts"] >= 1 and s["resharded"] >= 1
                and s["resumed_from_snapshot"] >= 1
                and s["tokens_replayed"] >= 1 and s["reshard_grow"] >= 1
                and len(s["hosts"]) == CELL_HOSTS and "h1" in s["hosts"]):
            problems.append("no crash re-shard, resume, replay or grow-back")
    elif name == "shed":
        prios = CELL_SCENARIOS[name][1]
        shed = sorted(r.req_id for r in reqs if r.state == "shed")
        lowest = sorted(sorted(range(len(reqs)), key=lambda i: prios[i])[:4])
        if s["slots_shed"] != 4 or shed != lowest or s["grid"] != (1, 2):
            problems.append(f"shed {shed}, not the four lowest priorities "
                            f"{lowest} on a (1, 2) grid")
    elif name == "straggler":
        if not (s["stragglers_evicted"] == 1 and "h0" in cell.demoted
                and "h0" not in s["hosts"] and s["tokens_replayed"] >= 1):
            problems.append("the slow host was not evicted, or no replay")
    if name in ("crash_rejoin", "straggler") and s["forced_mismatches"]:
        problems.append(f"{s['forced_mismatches']} forced mismatches")
    return problems


class _CellParts:
    """Hooks on the cell's re-shard parts while a scenario runs: each
    engine build (the factory call), relayout, replay, snapshot placement,
    the elastic checkpoint's host copy (``gather_state``) and, on a
    materialized cell, its copy onto the mesh (``reshard_state``) and the
    pool's placement (``ServeEngine.lay_out``), in seconds
    between device syncs (a restore's are :class:`_EngineMeter`'s). The
    hooks sit on the class and the module, never on a cell, so they keep
    no dropped cell alive."""

    PARTS = ("engine_build", "relayout", "replay", "snapshot_placement",
             "gather_state", "reshard_state", "pool_placement")

    def __init__(self):
        import repro_torch.serving.cell as cell_mod

        self.mod, self.cls = cell_mod, cell_mod.ElasticServeCell
        self.seconds = {p: [] for p in self.PARTS}

    def _timed(self, part: str, fn):
        import torch

        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.seconds[part].append(time.perf_counter() - t0)
            return out
        return run

    def __enter__(self):
        eng = self.mod.ServeEngine
        self.orig = [(self.mod, n, getattr(self.mod, n))
                     for n in ("gather_state", "reshard_state")] + [
            (self.cls, n, getattr(self.cls, n))
            for n in ("_relayout", "_replay", "_place_snapshot")] + [
            (eng, "lay_out", eng.lay_out)]
        for obj, attr, fn in self.orig:
            part = {"_relayout": "relayout", "_replay": "replay",
                    "_place_snapshot": "snapshot_placement",
                    "lay_out": "pool_placement"}.get(attr, attr)
            setattr(obj, attr, self._timed(part, fn))
        return self

    def factory(self, factory):
        return self._timed("engine_build", factory)

    def __exit__(self, *exc):
        for obj, attr, fn in self.orig:
            setattr(obj, attr, fn)

    def report(self, restore_s: list[float]) -> dict:
        return {p: {"n": len(v), "s": sum(v), "max_s": max(v, default=0.0)}
                for p, v in {**self.seconds, "restore": restore_s}.items()}


def _cell_run(model, params, factory, name: str, prompts, want) -> dict:
    """One scenario on a fresh cell: formed, then run under its fault plan
    with the launch counts zeroed just before and read just after and the
    cyclic collector off, each engine built only once every earlier one is
    freed; then the cell and its server dropped (they hold each other:
    the collector's cycle) and the device memory read again."""
    import weakref

    import torch

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    built: list = []
    alive_at_build: list[int] = []

    def tracked(host_id):
        alive_at_build.append(sum(r() is not None for r in built))
        eng = factory(host_id)
        built.append(weakref.ref(eng))
        return eng

    gc.disable()
    try:
        with _CellParts() as parts, _EngineMeter() as meter:
            ops.reset_counts()
            t0 = time.perf_counter()
            srv, cell, reqs, clock, plan = _cell_formed(
                model, params, parts.factory(tracked), name, prompts)
            formed_s = time.perf_counter() - t0
            summary = cell.run(clock, fault_plan=plan, max_ticks=2000)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.counts()
        events = [(round(t, 3), ev, {k: v for k, v in kv.items()
                                     if k not in ("cell",)})
                  for t, ev, kv in srv.log
                  if ev.startswith("cell_") or ev == "fault_injected"]
        problems = _cell_checks(name, summary, cell, reqs, want)
        peak = torch.cuda.max_memory_allocated()
        del cell, srv, reqs
    finally:
        gc.enable()
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    if any(alive_at_build):
        problems.append(f"engines alive at each build: {alive_at_build}")
    if mem1 - mem0 > CELL_MEM_SLACK_BYTES:
        problems.append(f"device memory grew by {mem1 - mem0} B")
    _check_counts(counts, PATH_KERNELS["qwen3-8b"], f"cell {name}")
    return {
        "summary": summary, "events": events, "problems": problems,
        "counts": counts,
        "numbers": {
            "wall_s": wall, "formation_wall_s": formed_s,
            "sim_s": clock.now(), "engine_steps": meter.steps,
            "generated_tokens": meter.tokens,
            "snapshots_taken": len(meter.snapshot_s),
            "snapshot_s": sum(meter.snapshot_s),
            "blob_bytes": max(meter.blob_bytes, default=None),
            "parts": parts.report(meter.restore_s),
            "engines_built": len(built),
            "memory_before_gb": mem0 / 1e9, "memory_after_gb": mem1 / 1e9,
            "max_memory_allocated_gb": peak / 1e9},
    }


def phase_cell(model, params, card: str, seed: int = 8) -> dict:
    """The elastic serving cell (``repro_torch.serving.cell``) driving the
    paged engine at full width through host churn: a trusted engine of the
    factory serves the 8 prompts in one queue; then four fresh cells of 4
    hosts on a (2, 2) grid, one after another: a, clean (nothing
    re-sharded, replayed or shed); b, a crash, then the host rejoins
    (collective timeout, re-shard onto 3 hosts resumed from a snapshot and
    replayed, 2 lanes shed, grow back to 4); c, two crashes at once with
    ``min_hosts`` 2 and priorities 0,0,1,1,2,2,3,3 (capacity 4 lanes: the
    four lowest priorities shed with exact prefixes); d, a host slowed 8x,
    evicted and never placed on again. Every stream done equals the trusted
    engine's token for token, every shed one is a prefix of it, replay
    recomputes the committed tokens exactly (no forced mismatch in b and
    d), every kernel of the paged path runs and no plain version, and the
    device memory after each run is back within less than one pool. Wall
    seconds by part (engine build, restore, relayout, replay, snapshot
    placement, ``gather_state``'s host copy) beside simulated ones, printed
    beside ``card``."""
    import torch

    from repro_torch.serving.batch import make_engine_factory

    cfg = model.cfg
    factory = make_engine_factory(model, params, device="cuda", **CELL_ENGINE)
    prompts = _cell_prompts(cfg.vocab_size, seed)
    t0 = time.perf_counter()
    trusted = factory("__trusted__")
    reqs = [trusted.submit(p, max_new_tokens=CELL_NEW) for p in prompts]
    trusted.run(100_000)
    torch.cuda.synchronize()
    want = [list(r.generated) for r in reqs]
    out = {"phase": "cell", "arch": cfg.arch_id, "layers": cfg.n_layers,
           "params_b": round(cfg.param_count() / 1e9, 3), "card": card,
           "prompts": len(prompts), "prompt_tokens": sum(map(len, prompts)),
           "new_tokens": CELL_NEW, "hosts": CELL_HOSTS,
           "engine": CELL_ENGINE, "cell": CELL,
           "failure_timeout_s": CELL_FAILURE_TIMEOUT_S,
           "trusted": {"wall_s": time.perf_counter() - t0,
                       "steps": trusted.steps}}
    del trusted, reqs
    gc.collect()
    launches = {}
    for name in CELL_SCENARIOS:
        got = _cell_run(model, params, factory, name, prompts, want)
        s = got["summary"]
        out[name] = {**got["numbers"], **s, "events": got["events"],
                     "launches": {n: c["launches"]
                                  for n, c in got["counts"].items()}}
        for n, c in got["counts"].items():
            launches[n] = launches.get(n, 0) + c["launches"]
        if got["problems"]:
            log(out)
            raise AssertionError(f"cell {name}: " + "; ".join(
                got["problems"]))
    out["launches"] = launches
    log(out)
    # the trusted tokens for the materialized cell (phase_materialized)
    out["want"] = want
    return out


# ---------------------------------------------------------------------------
# 4l. the materialized cell: a (1, 1) DeviceMesh of one NCCL rank
# ---------------------------------------------------------------------------

# phase_cell's engines, clock and prompts on one host of one card: a model
# axis of 1, all 8 lanes on the host. A second member of the cloudlet,
# suspended (never a candidate), holds the snapshots. A step takes 1.1
# simulated s here, so the sixth step places a snapshot and the crash lands
# one step after it; with no candidate left the cell stalls below
# min_hosts, backing off without jitter, and re-forms when the host
# rejoins, from the snapshot, replaying a token a lane.
MAT_HOSTS = ("h0", "h1")
MAT_CELL = dict(CELL, model_parallel=1, devices_per_host=1, target_hosts=1,
                min_hosts=1, slots_per_host=CELL_ENGINE["n_slots"],
                backoff_jitter=0.0)
MAT_FAULTS = [(7.5, "crash", "h0"), (18.0, "rejoin", "h0")]
# the rank-local shapes a (2, 2) grid gives rank (0, 0) of qwen3-8b's paged
# path: lanes 0-3 of 8 (its data shard), query heads 0-15 of 32 and kv
# heads 0-3 of 8 (its model shard); gemm_rows on N / 2 where the rules
# shard a product's output (column-parallel) and on K / 2 where they shard
# its input (row-parallel: o and down, whose halves' bf16 partials are
# summed by the all-reduce)
SHARD_LANES = 4
SHARD_ROW_PARALLEL = ("o", "down")


def _mat_formed(model, params, factory, prompts, *, materialize: bool):
    """The materialized scenario's server and cell, requests submitted and
    the cell formed (one tick of ``run``); the fault plan timed from the
    end of formation. Returns (server, cell, requests, clock, plan)."""
    from repro_torch.core.faults import FaultEvent, FaultPlan
    from repro_torch.core.server import AdHocServer
    from repro_torch.core.simulation import SimClock
    from repro_torch.serving.cell import ElasticServeCell

    srv = AdHocServer(failure_timeout=CELL_FAILURE_TIMEOUT_S)
    srv.create_cloudlet("cell", model.cfg.arch_id)
    for h in MAT_HOSTS:
        srv.register_host(h, 0.0, cloudlets=["cell"])
    srv.report_suspend(MAT_HOSTS[1], 0.0, True)
    cell = ElasticServeCell(srv, "cell", model, params, factory=factory,
                            materialize=materialize, **MAT_CELL)
    reqs = [cell.submit(p, max_new_tokens=CELL_NEW) for p in prompts]
    clock = SimClock()
    cell.run(clock, max_ticks=1)
    if cell.grid != (1, 1) or cell.cell_hosts != [MAT_HOSTS[0]]:
        raise AssertionError(f"materialized cell formed on {cell.cell_hosts}"
                             f", grid {cell.grid}")
    t0 = clock.now()
    plan = FaultPlan([FaultEvent(at=t0 + dt, kind=kind, host=host)
                      for dt, kind, host in MAT_FAULTS])
    return srv, cell, reqs, clock, plan


def _mat_checks(s: dict, reqs, want) -> list[str]:
    """Every stream done and equal to the trusted engine's; the crash timed
    out a collective, the cell stalled, re-formed on the rejoined host
    from the snapshot and replayed; no forced mismatch."""
    problems = [f"request {r.req_id}: stream differs" for r in reqs
                if r.committed != want[r.req_id]]
    if s["requests_done"] != len(reqs) or s["requests_pending"]:
        problems.append("requests left undone")
    if not (s["collective_timeouts"] >= 1 and s["reshard_stalls"] >= 1
            and s["resharded"] == 1 and s["resumed_from_snapshot"] == 1
            and s["tokens_replayed"] >= 1 and s["grid"] == (1, 1)
            and s["hosts"] == [MAT_HOSTS[0]]):
        problems.append("no timeout, stall, re-shard from the snapshot or "
                        "replay")
    if s["forced_mismatches"]:
        problems.append(f"{s['forced_mismatches']} forced mismatches")
    return problems


def _mat_run(model, params, factory, prompts, want, *,
             materialize: bool) -> dict:
    """The scenario on a fresh cell, counted and metered as ``_cell_run``
    counts a phase_cell scenario; with ``materialize`` also each
    ``reshard_state`` and pool placement (``ServeEngine.lay_out``) and
    what the engine held on the mesh. Its peak device memory is held to
    two pools and, on the mesh, one copy of the weights above what was
    held before."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels import ops
    from repro_torch.models.model_api import tree_leaves

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gc.disable()
    try:
        with _CellParts() as parts, _EngineMeter() as meter:
            ops.reset_counts()
            t0 = time.perf_counter()
            srv, cell, reqs, clock, plan = _mat_formed(
                model, params, parts.factory(factory), prompts,
                materialize=materialize)
            formed_s = time.perf_counter() - t0
            summary = cell.run(clock, fault_plan=plan, max_ticks=2000)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.counts()
        problems = _mat_checks(summary, reqs, want)
        eng = cell.engine
        held = {"params_dtensor": all(isinstance(p, DTensor)
                                      for p in eng.params.parameters()),
                "pool_placements": {k: [repr(p) for p in v.placements]
                                    for k, v in eng.cache.items()
                                    if isinstance(v, DTensor)},
                "mesh": (None if cell.mesh is None else
                         [list(cell.mesh.mesh_dim_names),
                          list(cell.mesh.shape),
                          cell.mesh.device_type])}
        if materialize and not (held["params_dtensor"]
                                and len(held["pool_placements"])
                                == len(eng.cache)):
            problems.append(f"the engine held no DTensors: {held}")
        param_bytes = sum(x.numel() * x.element_size()
                          for x in tree_leaves(cell.params_host))
        pool_bytes = sum(v.numel() * v.element_size()
                         for v in eng.cache.values())
        events = [(round(t, 3), ev, {k: v for k, v in kv.items()
                                     if k not in ("cell",)})
                  for t, ev, kv in srv.log
                  if ev.startswith("cell_") or ev == "fault_injected"]
        peak = torch.cuda.max_memory_allocated()
        del cell, srv, reqs, eng
    finally:
        gc.enable()
    # above what the phase held before, with the collector off: the two
    # pools a re-form holds at once (the one it restores and the one it
    # replaces) and, on a mesh, one copy of the weights (the engine's
    # shards, re-laid-out from the host copy): a dropped engine's weights
    # kept alive past its re-form would go over
    peak_limit = (2 * pool_bytes + (param_bytes if materialize else 0)
                  + CELL_MEM_SLACK_BYTES)
    if peak - mem0 > peak_limit:
        problems.append(f"peak {peak - mem0} B above the memory before, "
                        f"limit {peak_limit} B")
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    if mem1 - mem0 > CELL_MEM_SLACK_BYTES:
        problems.append(f"device memory grew by {mem1 - mem0} B")
    what = "materialized" if materialize else "layout-only"
    _check_counts(counts, PATH_KERNELS["qwen3-8b"], f"cell {what}")
    report = parts.report(meter.restore_s)
    return {"summary": summary, "problems": problems, "counts": counts,
            "numbers": {
                "wall_s": wall, "formation_wall_s": formed_s,
                "sim_s": clock.now(), "engine_steps": meter.steps,
                "generated_tokens": meter.tokens,
                "snapshots_taken": len(meter.snapshot_s),
                "snapshot_s": sum(meter.snapshot_s),
                "blob_bytes": max(meter.blob_bytes, default=None),
                "parts": report, **held, "events": events,
                # what the re-shards copied: the whole host checkpoint onto
                # the card at each reshard_state, each restored pool from
                # the host
                "reshard_state_bytes": report["reshard_state"]["n"]
                * param_bytes,
                "restored_pool_bytes": report["restore"]["n"] * pool_bytes,
                "memory_before_gb": mem0 / 1e9,
                "memory_after_gb": mem1 / 1e9,
                "max_memory_allocated_gb": peak / 1e9,
                "peak_limit_gb": (mem0 + peak_limit) / 1e9}}


def check_shard_shapes(gen) -> dict:
    """Each kernel of qwen3-8b's paged path at the rank-local shapes of a
    (2, 2) grid (``SHARD_LANES``, half the heads, ``gemm_rows`` on its N or
    K half): against the matching slice of the same inputs' full-shape
    call at the kernel's tolerance, with whether that slice is bitwise the
    same (a row-parallel product's two halves, each a kernel call, summed
    in bf16 as the all-reduce sums them). Then the kernel checks at those
    shapes hold each against its plain version and print their rows (ms,
    plain_ms, library_ms, bound); ``gemm_rows``' rows, which no check
    makes at these shapes, are made here."""
    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import flash_attention as fk, gemm_rows as gk
    from repro_torch.kernels import ops, paged_decode_attention as pk
    from repro_torch.kernels import rmsnorm as rk

    cfg = get("qwen3-8b")
    H, K, D, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    h, k, b = H // 2, K // 2, SHARD_LANES
    slices, out = {}, {}

    def held(name, got, full_slice):
        slices[name] = {
            "bitwise_full_slice": bool(torch.equal(got, full_slice)),
            "max_abs_full_slice": _close(got, full_slice,
                                         f"{name} at a (2, 2) shard")}

    # RMSNorm: the block norm's rows, the q and k norms' rows of lanes 0-3
    for what, shape, cut in (("block", (N_SLOTS, d), (slice(0, b),)),
                             ("q_norm", (N_SLOTS, H, D),
                              (slice(0, b), slice(0, h))),
                             ("k_norm", (N_SLOTS, K, D),
                              (slice(0, b), slice(0, k)))):
        x, w = _rmsnorm_case(gen, shape)
        full = rk.rmsnorm(x.reshape(-1, shape[-1]), w, 1e-6).view(shape)
        xs = x[cut].contiguous().reshape(-1, shape[-1])
        held(f"rmsnorm {what}", rk.rmsnorm(xs, w, 1e-6),
             full[cut].reshape(-1, shape[-1]))
    # the paged decode over the cell's pool: lanes 0-3, heads 0-15 of
    # their kv heads 0-3
    q, kp, vp, table, lens = _pool_case(gen, CELL_LENGTHS, CELL_ENGINE)
    full = pk.paged_decode_attention(q, kp, vp, table, lens)
    qs = q[:b, :h].contiguous()
    ks, vs = kp[:, :, :k].contiguous(), vp[:, :, :k].contiguous()
    held("paged_decode_attention",
         pk.paged_decode_attention(qs, ks, vs, table[:b], lens[:b]),
         full[:b, :h])
    # flash: a second prefill chunk (256 queries over 512 keys)
    q = torch.randn(1, CHUNK, H, D, generator=gen, device="cuda").bfloat16()
    kk = torch.randn(1, 2 * CHUNK, K, D, generator=gen,
                     device="cuda").bfloat16()
    vv = torch.randn(1, 2 * CHUNK, K, D, generator=gen,
                     device="cuda").bfloat16()
    full = fk.flash_attention(q, kk, vv, causal=True, q_offset=CHUNK)
    qs = q[:, :, :h].contiguous()
    ks, vs = kk[:, :, :k].contiguous(), vv[:, :, :k].contiguous()
    held("flash_attention",
         fk.flash_attention(qs, ks, vs, causal=True, q_offset=CHUNK),
         full[:, :, :h])
    # gemm_rows: every decode product on its half
    rows, step = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                      "cost": None, "max_abs_err": 0.0}
    for name, Kd, N, _, times in gk.step_products(cfg):
        w = (torch.randn(Kd, N, generator=gen, device="cuda")
             * Kd ** -0.5).bfloat16()
        x = torch.randn(N_SLOTS, Kd, generator=gen, device="cuda").bfloat16()
        full = gk.gemm_rows(x, w)
        if name in SHARD_ROW_PARALLEL:
            xs, ws = x[:b, :Kd // 2].contiguous(), w[:Kd // 2].contiguous()
            rest = gk.gemm_rows(x[:b, Kd // 2:].contiguous(),
                                w[Kd // 2:].contiguous())
            got = gk.gemm_rows(xs, ws)
            held(f"gemm_rows {name} K/2, halves summed", got + rest,
                 full[:b])
            shard = "row"
        else:
            xs, ws = x[:b].contiguous(), w[:, :N // 2].contiguous()
            got = gk.gemm_rows(xs, ws)
            held(f"gemm_rows {name} N/2", got, full[:b, :N // 2])
            shard = "column"
        with ops.use_backend("plain"):
            err = _close(got, ops.gemm_rows(xs, ws),
                         f"gemm_rows {name} at a (2, 2) shard")
        cost = gk.cost(b, *ws.shape)
        row = {"shape": {"M": b, "K": ws.shape[0], "N": ws.shape[1],
                         "product": name, "shard": shard, "arch": cfg.arch_id},
               "max_abs_err": err,
               "ms": _time_ms(lambda: gk.gemm_rows(xs, ws), flush=True),
               "plain_ms": _time_ms(lambda: gk.plain(xs, ws), flush=True),
               "library_ms": _time_ms(lambda: torch.matmul(xs, ws),
                                      flush=True),
               **bound(cost)}
        rows.append(row)
        for key in ("ms", "plain_ms", "library_ms"):
            step[key] += times * row[key]
        step["cost"] = (times * cost if step["cost"] is None
                        else step["cost"] + times * cost)
        step["max_abs_err"] = max(step["max_abs_err"], row["max_abs_err"])
        del w, x, xs, ws, full, got
    rows.append({"shape": {"M": b, "products": "one step", "arch": cfg.arch_id,
                           "layers": cfg.n_layers, "shards": "(2, 2)"},
                 "max_abs_err": step["max_abs_err"], "ms": step["ms"],
                 "plain_ms": step["plain_ms"],
                 "library_ms": step["library_ms"], **bound(step["cost"])})
    out["rmsnorm@shard"] = check_rmsnorm(gen, [(b, d), (b * h, D),
                                               (b * k, D)])
    out["paged_decode_attention@shard"] = [check_paged_decode_pool(
        gen, CELL_LENGTHS[:b], CELL_ENGINE, "shard", heads=(h, k))]
    out["flash_attention@shard"] = check_flash(gen, H=h, K=k, D=D)
    out["gemm_rows@shard"] = rows
    for name, checks in out.items():
        for r in checks:
            r.update(_factors(r))
            log({"kernel_check": name, **r})
    log({"kernel_check": "(2, 2) shards against the full-shape call",
         **slices})
    return out


def phase_materialized(model, params, card: str, want: list,
                       seed: int = 8) -> dict:
    """The materialized elastic cell on the card (``MAT_CELL``): a one-rank
    NCCL group and a (1, 1) mesh, the scenario run materialized and then
    layout-only on fresh cells, each stream held to phase_cell's trusted
    engine's (``want``, from the same prompts), the re-shard's parts timed
    beside each other; then the (2, 2) grid's rank-local shapes
    (:func:`check_shard_shapes`). The group is destroyed before it
    returns, and its meshes forgotten."""
    import socket

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.elastic import clear_meshes
    from repro_torch.serving.batch import make_engine_factory

    prompts = _cell_prompts(model.cfg.vocab_size, seed)
    factory = make_engine_factory(model, params, device="cuda", **CELL_ENGINE)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    out = {"phase": "materialized", "arch": model.cfg.arch_id, "card": card,
           "layers": model.cfg.n_layers, "process_group": {
               "backend": dist.get_backend(), "world": dist.get_world_size(),
               "init_s": time.perf_counter() - t0},
           "prompts": len(prompts), "new_tokens": CELL_NEW,
           "engine": CELL_ENGINE, "cell": MAT_CELL, "faults": MAT_FAULTS}
    runs = {}
    try:
        for materialize in (True, False):
            name = "materialized" if materialize else "layout_only"
            runs[name] = _mat_run(model, params, factory, prompts, want,
                                  materialize=materialize)
            out[name] = {**runs[name]["numbers"], **runs[name]["summary"],
                         "launches": {n: c["launches"] for n, c in
                                      runs[name]["counts"].items()}}
    finally:
        clear_meshes()
        dist.destroy_process_group()
    if dist.is_initialized():
        raise AssertionError("the process group outlived the phase")
    problems = [f"{name}: {p}" for name, r in runs.items()
                for p in r["problems"]]
    if problems:
        log(out)
        raise AssertionError("materialized cell: " + "; ".join(problems))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    checks = check_shard_shapes(gen)
    log(out)
    return {"launches": {n: c["launches"] for n, c in
                         runs["materialized"]["counts"].items()},
            "checks": checks}


# ---------------------------------------------------------------------------
# 5. training (the dense family): the backward kernels, the trainer
# ---------------------------------------------------------------------------

# the training shapes: smollm-360m at B 8, S 2048 (15 / 5 heads of 64, rows
# of 960), qwen3-8b at B 2, S 2048 (32 / 8 heads of 128, qk rows of 128,
# block rows of 4096)
TRAIN = dict(B=8, S=2048)
QWEN_TRAIN = dict(B=2, S=2048, layers=8, steps=3)
# the flash backward against plain autograd: for each (batch, 64-row tile
# of the sequence, head), the gradient's difference over the reference's in
# the Frobenius norm, the largest over the tiles within this (bf16 outputs,
# P and dS rounded to bf16 for their products). Each tile is measured
# against its own size: under causal attention dq, dk and dv fall about as
# 1/sqrt(position), so a share of the whole gradient's largest value would
# let the last tiles be wrong. Planted faults (the last key tile's dv
# zeroed, the last query tile's dq 10 % too large) must land above it.
# Read on the H100 (tools/train_limits.py): 0.0034-0.0042 at both training
# shapes and the gpu tests' six; the planted faults 1.0 and 0.100.
GRAD_TILE_SHARE = 1e-2
# dw (f32 sums over 16,384-131,072 rows, in another order than autograd's):
# its largest difference within this share of its largest magnitude
DW_REL = 1e-3
# the trainer's first step under the kernels against the same step under
# the plain versions: the loss (absolute), the grad norm (relative), and
# every gradient leaf, layer by layer (the Frobenius norm of the difference
# over the plain step's; read from AdamW's first moment, which after one
# step is (1 - b1) times the clipped gradient). Read on the H100
# (tools/train_limits.py): loss 3.6e-4, grad norm 4.9e-5, leaves 0.013 (the
# final norm) to 0.057 (a layer's MLP norm). A
# planted fault (one layer's attention-norm gradient 20 % too large) must
# land above the leaves' limit.
FIRST_STEP_LOSS_ATOL = 2e-2
FIRST_STEP_NORM_REL = 5e-2
FIRST_STEP_LEAF_SHARE = 0.1
TRAIN_RUN = dict(steps=10, hosts=2, snapshot_every=5, fail_at=7)


def _tile_share(got, want, tile: int = 64) -> float:
    """The largest, over (batch, ``tile`` rows of dim 1, head) tiles of
    (B, S, H, D) gradients, of ||got - want|| / ||want|| (Frobenius, f32).
    NaN where a tile of ``want`` is all zero or ``got`` is not finite."""
    import torch.nn.functional as F

    B, S, H, D = want.shape

    def sums(t):
        t = F.pad(t, (0, 0, 0, 0, 0, -S % tile))
        return t.square().reshape(B, -1, tile, H, D).sum((2, 4))

    want = want.float()
    return float((sums(got.float() - want) / sums(want)).max().sqrt())


def _planted(got, want, tile: int = 64) -> dict:
    """The tile share of two faults planted in the kernel's gradients:
    the last key tile's dv zeroed, the last query tile's dq scaled by
    1.1."""
    dq, _, dv = (t.clone() for t in got)
    last = (dv.shape[1] - 1) // tile * tile
    dv[:, last:] = 0
    dq[:, last:] *= 1.1
    return {"dv_last_tile_zeroed": _tile_share(dv, want[2], tile),
            "dq_last_tile_x1.1": _tile_share(dq, want[0], tile)}


def _grad_ms(out, ins, dout) -> float:
    import torch

    return _time_ms(lambda: torch.autograd.grad(out, ins, dout,
                                                retain_graph=True),
                    flush=True)


# the flash backward's training shapes: (B, S, H, K, D), causal
FLASH_BWD_SHAPES = {"smollm-360m": (TRAIN["B"], TRAIN["S"], 15, 5, 64),
                    "qwen3-8b": (QWEN_TRAIN["B"], QWEN_TRAIN["S"], 32, 8,
                                 128)}
# the flash backward's launches by kernel name (csrc/flash_attention_bwd.cu):
# dQ (which also writes the row sums of dO * O), then dK/dV
FLASH_BWD_PARTS = {"flash_bwd_dq_kernel": "dq",
                   "flash_bwd_dkdv_kernel": "dkdv"}


def _parts_ms(fn, parts: dict) -> dict:
    """The device time of each launch of one warm call of ``fn``, by the
    kernel names of ``parts`` (name -> part), from one ``torch.profiler``
    trace of that call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {part: 0.0 for part in parts.values()}
    for e in prof.key_averages():
        for name, part in parts.items():
            if name in e.key:
                out[part] += e.self_device_time_total / 1e3
    return out


def _print_flash_bwd_parts() -> int:
    """``chip_smoke.py --flash-bwd-parts``: the flash backward's
    ``parts_ms`` at both training shapes, on inputs drawn as
    ``check_flash_bwd`` draws them, and the device operations one call of
    the RMSNorm backward makes at each of its training shapes
    (``_kernels_us``: per operation, its microseconds and launches a call),
    printed as one JSON line; so too the device operations of one call of
    each SSM backward at its training shape, and of the router's whole
    backward (``MoeRoute``'s, through autograd) and of its parent's design
    (``_route_bwd_parent``) at both MoE configs' (``route_bwd_ops``)."""
    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import flash_attention as fk, rmsnorm as rk
    from repro_torch.kernels import moe_route as mk
    from repro_torch.kernels import selective_scan as sk, ssd as dk

    gen = torch.Generator(device="cuda").manual_seed(24)
    res = {"rmsnorm_bwd_ops": {}}
    args = _scan_case(gen, SCAN_TRAIN["S"], 0.1, B=SCAN_TRAIN["B"],
                      Di=SCAN_TRAIN["Di"], N=SCAN_TRAIN["N"])
    dy = torch.randn_like(args[0], dtype=torch.float32).bfloat16()
    states = sk.selective_scan(*args, save_states=True)[2]
    res["scan_bwd_ops"] = _kernels_us(
        lambda: sk.selective_scan_bwd(*args[:6], states, dy), n=5)
    args = _ssd_case(gen, SSD_TRAIN["S"], 0.1, B=SSD_TRAIN["B"],
                     Hs=SSD_TRAIN["Hs"], P=SSD_TRAIN["P"], N=SSD_TRAIN["N"])
    dy = torch.randn_like(args[0], dtype=torch.float32).bfloat16()
    scratch = dk._forward(*args, CHUNK)[2]
    res["ssd_bwd_ops"] = _kernels_us(
        lambda: dk.ssd_bwd(*args[:6], scratch, dy, chunk=CHUNK), n=5)
    del args, dy, states, scratch
    for what, shape in RMSNORM_BWD_SHAPES.items():
        x, w = _rmsnorm_case(gen, shape)
        g = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        res["rmsnorm_bwd_ops"][what] = _kernels_us(
            lambda: rk.rmsnorm_bwd(x, w, g, 1e-5))
        del x, w, g
    for what, (B, S, H, K, D) in FLASH_BWD_SHAPES.items():
        q, k, v, dout = (
            torch.randn(*shape, generator=gen, device="cuda").to(
                torch.bfloat16)
            for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D),
                          (B, S, H, D)))
        out, lse = fk.flash_attention(q, k, v, causal=True, with_lse=True)
        res[what] = _parts_ms(
            lambda: fk.flash_attention_bwd(q, k, v, out, dout, lse),
            FLASH_BWD_PARTS)
        del q, k, v, dout, out, lse
    res["route_bwd_ops"] = {}
    for arch in MOE_ARCHS_TRAIN:
        cfg = get(arch)
        T, E, k = MOE_TRAIN_T, cfg.n_experts, cfg.moe_top_k
        x, router = _router(gen, cfg, T)
        weights, ids, probs = mk.moe_route(x, router, k, with_probs=True)
        args = (x, router, probs, ids, weights,
                torch.randn(T, k, generator=gen, device="cuda"),
                torch.randn(T, E, generator=gen, device="cuda"))
        # the whole backward as training runs it: MoeRoute's, by autograd
        xk, rk_ = x.clone().requires_grad_(), router.clone().requires_grad_()
        kw, _, kp = mk.MoeRoute.apply(xk, rk_, k)
        res["route_bwd_ops"][arch] = {
            "ops": _kernels_us(lambda: torch.autograd.grad(
                (kw, kp), (xk, rk_), args[5:], retain_graph=True)),
            "parent_ops": _kernels_us(lambda: _route_bwd_parent(args))}
    log(res)
    return 0


# the RMSNorm backward's training shapes: smollm-360m's block norm, qwen3-8b's
# qk-norm rows (32 heads of 128) and its block norm
RMSNORM_BWD_SHAPES = {
    "smollm-360m block": (TRAIN["B"] * TRAIN["S"], 960),
    "qwen3-8b qk": (QWEN_TRAIN["B"] * QWEN_TRAIN["S"] * 32, 128),
    "qwen3-8b block": (QWEN_TRAIN["B"] * QWEN_TRAIN["S"], 4096)}
# the kernels one call of the RMSNorm backward launches: the rows, then the
# sum of the partial rows; nothing else (no fill of dw)
RMSNORM_BWD_OPS = ("rmsnorm_bwd_kernel", "rmsnorm_dw_kernel")


def _flash_bwd_parts() -> dict:
    """``_print_flash_bwd_parts`` in a fresh process. (In this process,
    after the serve phases' traces, a trace of one backward call held no
    kernels on the H100, with CUDA activity alone or with the CPU's; the
    first trace of a process holds them.)"""
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--flash-bwd-parts"], capture_output=True,
                         text=True, timeout=600, check=True)
    return json.loads(run.stdout.strip().splitlines()[-1])


def _sdpa(ins, causal: bool, gqa: bool, backend: str = "FLASH_ATTENTION"):
    """SDPA over ``ins`` (B, H, S, D) under the one backend ``backend`` (a
    name of ``SDPBackend``): PyTorch's own choice is cuDNN at the training
    shapes, whose backward's time moves between calls in one process
    (PERF.md section 6, PR 29). Deterministic algorithms must be off (they
    reroute a backend's backward)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError("SDPA timed under deterministic algorithms")
    with sdpa_kernel(getattr(SDPBackend, backend)):
        return F.scaled_dot_product_attention(*ins, is_causal=causal,
                                              enable_gqa=gqa)


def check_flash_bwd(gen, *, B, S, H, K, D, what: str,
                    parts_ms: dict | None, Sk: int | None = None,
                    causal: bool = True) -> list[dict]:
    """The flash forward (with ``lse``) and backward kernels at a training
    shape (S queries over ``Sk`` keys, S where None; causal or not)
    against plain autograd; the forward's bits the same with ``lse`` as
    without; two backward runs bitwise equal. Rows: forward, backward."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fk, ref

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    Sk = Sk or S
    q, k, v, dout = rnd(B, S, H, D), rnd(B, Sk, K, D), rnd(B, Sk, K, D), \
        rnd(B, S, H, D)
    out, lse = fk.flash_attention(q, k, v, causal=causal, with_lse=True)
    if not torch.equal(out, fk.flash_attention(q, k, v, causal=causal)):
        raise AssertionError(f"flash {what}: the output with lse differs "
                             f"from the output without")
    got = fk.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
    again = fk.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash backward {what}: two runs differ")
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    plain_out = ref.attention(*ins, causal=causal)
    want = torch.autograd.grad(plain_out, ins, dout, retain_graph=True)
    fwd_err = _close(out, plain_out.detach(), f"flash forward {what}")
    shares = {n: _tile_share(a, w) for n, a, w in zip(("dq", "dk", "dv"),
                                                      got, want)}
    if not all(x <= GRAD_TILE_SHARE for x in shares.values()):
        raise AssertionError(f"flash backward {what}: tile shares {shares} "
                             f"over {GRAD_TILE_SHARE}")
    planted = _planted(got, want)
    if not all(x > GRAD_TILE_SHARE for x in planted.values()):
        raise AssertionError(f"flash backward {what}: a planted fault "
                             f"passes the check: {planted}")
    bwd_err = max(float((a.float() - w.float()).abs().max())
                  for a, w in zip(got, want))
    shape = {"B": B, "S": S, "H": H, "K": K, "D": D, "causal": causal}
    if Sk != S:
        shape["Sk"] = Sk
    lib_ins = [t.detach().transpose(1, 2).clone().requires_grad_()
               for t in (q, k, v)]
    lib_out = _sdpa(lib_ins, causal, gqa=H != K)
    lib_dout = dout.transpose(1, 2)
    fwd = {"shape": shape, "max_abs_err": fwd_err,
           "ms": _time_ms(lambda: fk.flash_attention(
               q, k, v, causal=causal, with_lse=True), flush=True),
           "plain_ms": _time_ms(lambda: ref.attention(q, k, v,
                                                      causal=causal),
                                flush=True),
           "library_ms": _time_ms(lambda: _sdpa(
               [t.detach() for t in lib_ins], causal, gqa=H != K),
               flush=True),
           "library_backend": "FLASH_ATTENTION",
           **bound(fk.cost(B, S, Sk, H, K, D, causal=causal,
                           with_lse=True))}

    # the backward's work: five products of D-deep dots a pair (S, dP, dV,
    # dK, dQ); q, k, v, o, dO and lse read once, dq, dk, dv written once
    bwd = {"shape": shape, "max_abs_err": bwd_err,
           "grad_tile_share": shares, "planted_tile_share": planted,
           "bitwise_repeat": True,
           "ms": _time_ms(lambda: fk.flash_attention_bwd(
               q, k, v, out, dout, lse, causal=causal), flush=True),
           # the kernels execute 14 D FLOP a pair (S and dP twice: in dK/dV
           # and in dQ) against the bound's 10 D
           "executed_flop_per_pair": 14 * D,
           "plain_ms": _grad_ms(plain_out, ins, dout),
           "library_ms": _grad_ms(lib_out, lib_ins, lib_dout),
           "library_backend": "FLASH_ATTENTION",
           **bound(fk.bwd_cost(B, S, Sk, H, K, D, causal=causal))}
    if parts_ms is not None:
        # each launch of one call (``_flash_bwd_parts``)
        bwd["parts_ms"] = parts_ms
    for row in (fwd, bwd):
        row["x_library"] = row["ms"] / row["library_ms"]
        row["x_bound"] = row["ms"] / row["bound_ms"]
    log({"check": f"flash_attention_bwd@{what}", "forward": fwd,
         "backward": bwd})
    return [fwd, bwd]


def check_rmsnorm_bwd(gen, shape, what: str, ops: dict) -> list[dict]:
    """The RMSNorm forward and backward kernels at a training shape against
    plain autograd; two backward runs bitwise equal; ``ops``, the device
    operations of one backward call (``_flash_bwd_parts``), are the two
    kernels once each. Rows: forward, backward."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref, rmsnorm as rk

    eps = 1e-5
    x, w = _rmsnorm_case(gen, shape)
    g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    dx, dw = rk.rmsnorm_bwd(x, w, g, eps)
    dx2, dw2 = rk.rmsnorm_bwd(x, w, g, eps)
    if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
        raise AssertionError(f"rmsnorm backward {what}: two runs differ")
    found = sorted(n for n in RMSNORM_BWD_OPS for op in ops if n in op)
    if found != sorted(RMSNORM_BWD_OPS) or len(ops) != 2 or any(
            v["per_call"] != 1 for v in ops.values()):
        raise AssertionError(f"rmsnorm backward {what}: device operations "
                             f"{ops}, not {RMSNORM_BWD_OPS} once each")
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = ref.rmsnorm(xp, wp, eps)
    want = torch.autograd.grad(y, (xp, wp), g, retain_graph=True)
    err = _close(dx, want[0], f"rmsnorm backward dx {what}")
    dw_rel = _rel_err(dw, want[1])
    if dw_rel > DW_REL:
        raise AssertionError(f"rmsnorm backward dw {what}: {dw_rel:.3g} of "
                             f"its largest value, over {DW_REL}")
    fwd_err = _close(rk.rmsnorm(x, w, eps), y.detach(),
                     f"rmsnorm forward {what}")
    xl, wl = x.clone().requires_grad_(), w.to(x.dtype).requires_grad_()
    yl = F.rms_norm(xl, (shape[-1],), wl, eps)
    rows, d = x.numel() // shape[-1], shape[-1]
    fwd = {"shape": list(shape), "max_abs_err": fwd_err,
           "ms": _time_ms(lambda: rk.rmsnorm(x, w, eps)),
           "plain_ms": _time_ms(lambda: ref.rmsnorm(x, w, eps)),
           "library_ms": _time_ms(lambda: F.rms_norm(
               x, (shape[-1],), wl.detach(), eps)),
           **bound(rk.cost(rows, d, x.element_size(), w.element_size()))}
    bwd = {"shape": list(shape), "max_abs_err": err, "dw_rel": dw_rel,
           "bitwise_repeat": True, "device_ops": ops,
           "ms": _time_ms(lambda: rk.rmsnorm_bwd(x, w, g, eps)),
           "plain_ms": _time_ms(lambda: torch.autograd.grad(
               y, (xp, wp), g, retain_graph=True)),
           "library_ms": _time_ms(lambda: torch.autograd.grad(
               yl, (xl, wl), g, retain_graph=True)),
           **bound(rk.bwd_cost(rows, d, x.element_size(), w.element_size()))}
    for row in (fwd, bwd):
        row["x_library"] = row["ms"] / row["library_ms"]
        row["x_bound"] = row["ms"] / row["bound_ms"]
    log({"check": f"rmsnorm_bwd@{what}", "forward": fwd, "backward": bwd})
    return [fwd, bwd]


# the router's backward at the MoE configs' training shapes: T = B 2 x S
# 2048 tokens a layer. d_logits (the first launch's scratch) against
# ref.moe_route_bwd on the same inputs (both f32, sums over k and E in other
# orders: within ROUTE_BWD_REL of the largest magnitude); the kernels' dx
# (bf16) and d_router (f32) against ref.moe_route_grads on the same inputs
# (d_router summed in the kernel's order), and the whole route's dx and
# d_router (``MoeRoute``) against autograd through the plain router on the
# tokens whose picks agree (a near tie may rank either way: those tokens'
# gradients are zeroed on both sides), dx within ROUTE_DX_REL (bf16
# rounding), d_router within ROUTE_DROUTER_REL (f32 sums over 4096 tokens
# in another order) of their largest magnitudes
MOE_TRAIN_T = 4096
ROUTE_BWD_REL = 1e-5
ROUTE_DX_REL = 1e-2
ROUTE_DROUTER_REL = 1e-4
# the router backward's launches by kernel name (csrc/moe_route_bwd.cu):
# d_logits, then dx and d_router
ROUTE_BWD_PARTS = {"moe_route_bwd_kernel": "d_logits",
                   "moe_route_grads_kernel": "products"}


MOE_ARCHS_TRAIN = ("granite-moe-1b-a400m", "deepseek-moe-16b")


def _ops_total(ops: dict) -> dict:
    """A call's device time (ms) and launches from ``_kernels_us``'s
    operations, with the operations themselves."""
    return {"device_ms": sum(o["us"] * o["per_call"] for o in ops.values())
            / 1e3,
            "launches_per_call": sum(o["per_call"] for o in ops.values()),
            "ops": ops}


def _route_bwd_parent(args):
    """The parent's design of the router's backward on ``args`` (x, router,
    probs, ids, weights, dw, dprobs): d_logits (this design's first
    launch), then x in f32, the two f32 products (cuBLAS), dx cast to
    bf16."""
    from repro_torch.kernels import moe_route as rk

    x, router = args[:2]
    dl = rk.moe_route_bwd(*args, need_dx=False, need_drouter=False,
                          with_d_logits=True)[2]
    return ((dl @ router.t()).to(x.dtype), x.float().t() @ dl)


def check_moe_route_bwd(gen, arch: str, device_ops: dict) -> list[dict]:
    """The router kernel with ``probs`` out and its backward kernels
    (``csrc/moe_route_bwd.cu``) at ``arch``'s (d, E, k) over MOE_TRAIN_T
    tokens: the forward's weights and ids bitwise the same as without
    ``probs``; d_logits against the plain closed form, dx and d_router
    against ``ref.moe_route_grads`` and the whole route's gradients
    (``MoeRoute``) against plain autograd (the limits above); two backward
    runs bitwise equal. The backward's row: its ms by CUDA events; from
    ``device_ops`` (``_print_flash_bwd_parts``'s ``route_bwd_ops``, traced
    in a fresh process), each launch's device ms (``parts_ms``), the device
    ms and launches of the whole route backward, and those of the parent's
    design rebuilt on inputs of the same shapes (``_route_bwd_parent``),
    which must hold the two launches of ROUTE_BWD_PARTS and nothing else
    (and the parent's some); dx element by element within one bf16
    rounding of the f32 product (``ref.moe_route_dx_excess`` at most 1,
    a product of bf16-rounded operands over 1); the bound where its
    products run, on the tensor cores (``bound_ms``: three bf16 products
    each), and on the f32 units (``bound_f32_ms``). Rows: forward with
    ``probs``, backward; no single PyTorch call computes either
    (``library_ms`` none)."""
    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import moe_route as rk, ref

    cfg = get(arch)
    d, E, k, T = cfg.d_model, cfg.n_experts, cfg.moe_top_k, MOE_TRAIN_T
    x, router = _router(gen, cfg, T)
    w0, ids0 = rk.moe_route(x, router, k)
    weights, ids, probs = rk.moe_route(x, router, k, with_probs=True)
    if not (torch.equal(w0, weights) and torch.equal(ids0, ids)):
        raise AssertionError(f"moe_route {arch}: probs changed the weights' "
                             f"or the ids' bits")
    pw, pids, pprobs = ref.moe_route(x, router, k, with_probs=True)
    same = (ids == pids).all(-1)
    dw = torch.randn(T, k, generator=gen, device="cuda") * same[:, None]
    dprobs = torch.randn(T, E, generator=gen, device="cuda") * same[:, None]
    args = (x, router, probs, ids, weights, dw, dprobs)
    got = rk.moe_route_bwd(*args, with_d_logits=True)
    again = rk.moe_route_bwd(*args, with_d_logits=True)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"moe_route_bwd {arch}: two runs differ")
    kdx, kdr, kdl = got
    want_dl = ref.moe_route_bwd(probs, ids, weights, dw, dprobs)
    plan = rk.grads_plan(d, E)
    pdx_same, pdr_same = ref.moe_route_grads(*args, **plan.order())
    xk, rk_ = x.clone().requires_grad_(), router.clone().requires_grad_()
    kw, _, kp = rk.MoeRoute.apply(xk, rk_, k)
    xp, rp = x.clone().requires_grad_(), router.clone().requires_grad_()
    pw2, _, pp2 = ref.moe_route(xp, rp, k, with_probs=True)
    dx, dr = torch.autograd.grad((kw, kp), (xk, rk_), (dw, dprobs),
                                 retain_graph=True)
    pdx, pdr = torch.autograd.grad((pw2, pp2), (xp, rp), (dw, dprobs),
                                   retain_graph=True)
    if not (torch.equal(dx, kdx) and torch.equal(dr, kdr)):
        raise AssertionError(f"moe_route_bwd {arch}: MoeRoute's gradients "
                             f"are not the kernels'")
    readings = {"d_logits_rel": _rel_err(kdl, want_dl),
                "kernel_dx_rel": _rel_err(kdx, pdx_same),
                "kernel_d_router_rel": _rel_err(kdr, pdr_same),
                "dx_rel": _rel_err(dx, pdx), "d_router_rel": _rel_err(dr, pdr)}
    limits = {"d_logits_rel": ROUTE_BWD_REL, "kernel_dx_rel": ROUTE_DX_REL,
              "kernel_d_router_rel": ROUTE_DROUTER_REL,
              "dx_rel": ROUTE_DX_REL, "d_router_rel": ROUTE_DROUTER_REL}
    # dx element by element (one rounding of an f32-accurate product), and
    # a control that keeps less (bf16 operands) and must fail it
    readings["dx_excess"] = ref.moe_route_dx_excess(kdx, kdl, router)
    limits["dx_excess"] = 1.0
    control = ref.moe_route_dx_excess(
        (kdl.bfloat16().float() @ router.bfloat16().float().t()).bfloat16(),
        kdl, router)
    if not all(readings[n] <= limits[n] for n in limits) or control <= 1:
        raise AssertionError(f"moe_route_bwd {arch}: {readings} over "
                             f"{limits}, or the control {control} within")
    shape = {"T": T, "d": d, "E": E, "k": k, "arch": arch}
    fwd = {"shape": shape, "max_abs_err": _close(weights[same], pw[same],
                                                 "moe_route weights",
                                                 ROUTE_TOL),
           "probs_max_abs_err": float((probs - pprobs).abs().max()),
           "ids_differ": int((~same).sum()), "bitwise_without_probs": True,
           "ms": _time_ms(lambda: rk.moe_route(x, router, k,
                                               with_probs=True)),
           "plain_ms": _time_ms(lambda: ref.moe_route(x, router, k,
                                                      with_probs=True)),
           "library_ms": None, "library": "none",
           **bound(rk.cost(T, d, E, k, with_probs=True))}

    # x read and dx written (bf16), probs, dprobs (T, E), ids, weights, dw
    # (T, k), the router read and d_router written (f32); the two products'
    # 4 T d E operations, three times over on the tensor cores (bf16 splits
    # under the f32 contract), once on the f32 units (and d_logits' few a
    # token)
    # the whole backward (MoeRoute's, through autograd): its device time
    # and launches, each kernel of ROUTE_BWD_PARTS' time a call; it must
    # hold those two launches, once a call, and nothing else
    whole = _ops_total(device_ops["ops"])
    old = _ops_total(device_ops["parent_ops"])
    found = {part for key in whole["ops"]
             for name, part in ROUTE_BWD_PARTS.items() if name in key}
    if (len(whole["ops"]) != 2 or found != set(ROUTE_BWD_PARTS.values())
            or any(o["per_call"] != 1 or o["us"] <= 0
                   for o in whole["ops"].values())
            or old["launches_per_call"] <= 0 or old["device_ms"] <= 0):
        raise AssertionError(f"moe_route_bwd {arch}: the traces hold "
                             f"{whole['ops']} and the parent's "
                             f"{old['ops']}, not ROUTE_BWD_PARTS' two "
                             f"launches a call")
    bwd = {"shape": shape, "plan": plan._asdict(),
           "max_abs_err": max(float((kdx.float() - pdx_same.float()).abs()
                                    .max()),
                              float((kdr - pdr_same).abs().max())),
           "d_logits_max_abs_err": float((kdl - want_dl).abs().max()),
           **readings, "dx_excess_control": control, "bitwise_repeat": True,
           "ms": _time_ms(lambda: rk.moe_route_bwd(*args)),
           "parts_ms": {part: sum(o["us"] * o["per_call"]
                                  for key, o in whole["ops"].items()
                                  if name in key) / 1e3
                        for name, part in ROUTE_BWD_PARTS.items()},
           "device_ms": whole["device_ms"],
           "launches_per_call": whole["launches_per_call"],
           "device_ops": whole["ops"],
           "parent_ms": _time_ms(lambda: _route_bwd_parent(args)),
           "parent_device_ms": old["device_ms"],
           "parent_launches_per_call": old["launches_per_call"],
           "parent_device_ops": old["ops"],
           "plain_ms": _time_ms(lambda: ref.moe_route_grads(
               *args, **plan.order())),
           # the whole route's backward through autograd, against autograd
           # through the plain router
           "route_grad_ms": _grad_ms((kw, kp), (xk, rk_), (dw, dprobs)),
           "plain_route_grad_ms": _grad_ms((pw2, pp2), (xp, rp),
                                           (dw, dprobs)),
           "library_ms": None, "library": "none",
           "bound_f32_ms": bound(rk.bwd_cost(T, d, E, k,
                                             basis="f32"))["bound_ms"],
           **bound(rk.bwd_cost(T, d, E, k))}
    bwd["device_x_bound"] = bwd["device_ms"] / bwd["bound_ms"]
    bwd["device_x_bound_f32"] = bwd["device_ms"] / bwd["bound_f32_ms"]
    for row in (fwd, bwd):
        row.update(_factors(row))
    log({"check": f"moe_route_bwd@{arch}", "forward": fwd, "backward": bwd})
    return [fwd, bwd]


# the SSM backward kernels' training shapes: falcon-mamba-7b's scan and
# zamba2-1.2b's SSD (chunk 256), B 2, S 2048
SCAN_TRAIN = dict(B=2, S=2048, Di=8192, N=16)
SSD_TRAIN = dict(B=2, S=2048, Hs=64, P=64, N=64)
# the SSM backward kernels against plain autograd: each bf16 gradient (dx,
# ddt, dB, dC) per (batch, 64-step tile) within GRAD_TILE_SHARE of the tile's
# own size in the Frobenius norm (both sides round to bf16 at the end), each
# f32 one (dA, dD, dh0) within SSM_F32_GRAD_REL of its largest magnitude; a
# planted fault (a bf16 gradient's last tile 10 % too large) must land above
# the tile limit
SSM_F32_GRAD_REL = 1e-3
SSM_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


def _seq_share(got, want, tile: int = 64) -> float:
    """The largest, over (batch, ``tile`` steps of dim 1) tiles of a
    (B, S, ...) gradient, of ||got - want|| / ||want|| (Frobenius, f32)."""
    import torch.nn.functional as F

    B, S = want.shape[:2]

    def sums(t):
        t = F.pad(t.float().reshape(B, S, -1), (0, 0, 0, -S % tile))
        return t.square().reshape(B, -1, tile * t.shape[-1]).sum(-1)

    return float((sums(got.float() - want.float()) / sums(want)).max().sqrt())


def _ssm_grads_held(what: str, got, again, want) -> dict:
    """A backward kernel's seven gradients (``SSM_GRADS``) against plain
    autograd's: two runs bitwise equal, the bf16 ones tile by tile, the f32
    ones whole, a fault planted in each bf16 one's last tile caught (the
    least of those readings returned)."""
    import torch

    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: two runs differ")
    if not all(bool(torch.isfinite(g.float()).all()) for g in got):
        raise AssertionError(f"{what}: a gradient is not finite")
    tiles = {n: _seq_share(g, w) for n, g, w in zip(SSM_GRADS, got, want)
             if g.dtype == torch.bfloat16}
    whole = {n: _rel_err(g, w) for n, g, w in zip(SSM_GRADS, got, want)
             if g.dtype == torch.float32}
    if not (all(x <= GRAD_TILE_SHARE for x in tiles.values())
            and all(x <= SSM_F32_GRAD_REL for x in whole.values())):
        raise AssertionError(f"{what}: tile shares {tiles} (limit "
                             f"{GRAD_TILE_SHARE}), f32 {whole} (limit "
                             f"{SSM_F32_GRAD_REL})")
    planted = {}
    for n, g, w in zip(SSM_GRADS, got, want):
        if g.dtype == torch.bfloat16:
            bad = g.clone()
            bad[:, (bad.shape[1] - 1) // 64 * 64:] *= 1.1
            planted[n] = _seq_share(bad, w)
    planted = min(planted.values())
    if not planted > GRAD_TILE_SHARE:
        raise AssertionError(f"{what}: a planted fault passes: {planted}")
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want) if g.dtype == torch.bfloat16)
    return {"max_abs_err": err, "grad_tile_share": tiles,
            "f32_grad_rel": whole, "planted_tile_share": planted,
            "bitwise_repeat": True}


def _once_ms(fn) -> float:
    """The device time of one warm call of ``fn``, by CUDA events (for the
    plain versions' backward, too slow to repeat twenty times)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def _plain_scan_grads(args, dy):
    """Autograd through the plain scan, one 256-step tile at a time (the
    whole sequence's graph takes a full-size gradient of its (B, S, Di, N)
    decays at each of its 2048 steps): each tile from the plain state
    entering it, the tiles in reverse, hT's gradient carried back. The
    chain rule makes it the whole sequence's autograd."""
    import torch

    from repro_torch.kernels import ref

    x, dt, A, Bm, C, D, h0 = args
    S = x.shape[1]
    starts = [h0]
    with torch.no_grad():
        for t0 in range(0, S - CHUNK, CHUNK):
            sl = slice(t0, t0 + CHUNK)
            starts.append(ref.selective_scan(x[:, sl], dt[:, sl], A, Bm[:, sl],
                                             C[:, sl], D, starts[-1])[1])
    out = [[] for _ in range(4)]      # dx, ddt, dB, dC, tiles in reverse
    dA, dD, u = 0, 0, torch.zeros_like(h0)
    for k in reversed(range(len(starts))):
        sl = slice(k * CHUNK, (k + 1) * CHUNK)
        ins = [t.detach().requires_grad_() for t in (
            x[:, sl], dt[:, sl], A, Bm[:, sl], C[:, sl], D, starts[k])]
        y, hT = ref.selective_scan(*ins)
        g = torch.autograd.grad((y, hT), ins, (dy[:, sl], u))
        for i, j in enumerate((0, 1, 3, 4)):
            out[i].append(g[j])
        dA, dD, u = dA + g[2], dD + g[5], g[6]
    dx, ddt, dB, dC = (torch.cat(t[::-1], 1) for t in out)
    return dx, ddt, dA, dB, dC, dD, u


def check_scan_bwd(gen, device_ops: dict) -> list[dict]:
    """falcon-mamba-7b's scan at its training shape (``SCAN_TRAIN``) from a
    nonzero state: the forward saving its tiles' states (y and hT the same
    bits as without), the backward kernel against autograd through the
    plain scan (``_plain_scan_grads``), twice bitwise. ``device_ops``: the
    kernels one backward call launches (``_flash_bwd_parts``). Rows:
    forward, backward."""
    import torch

    from repro_torch.kernels import ref, selective_scan as sk

    B, S, Di, N = (SCAN_TRAIN[k] for k in ("B", "S", "Di", "N"))

    def held_at(init_decay: bool):
        what = "selective_scan" + (" init decay" if init_decay else "")
        args = _scan_case(gen, S, 0.1, B=B, Di=Di, N=N, init_decay=init_decay)
        dy = torch.randn(B, S, Di, generator=gen, device="cuda").bfloat16()
        y, hT = sk.selective_scan(*args)
        ys, hs, states = sk.selective_scan(*args, save_states=True)
        if not (torch.equal(y, ys) and torch.equal(hT, hs)):
            raise AssertionError(f"{what}: saving the tiles' states changed "
                                 f"y or hT")
        with torch.no_grad():
            yw, hw = ref.selective_scan(*args)
        fwd_err = max(_close(y, yw, what + " train"),
                      _close(hT, hw, what + " train hT", STATE_TOL))
        del yw, hw
        got = sk.selective_scan_bwd(*args[:6], states, dy)
        again = sk.selective_scan_bwd(*args[:6], states, dy)
        want = _plain_scan_grads(args, dy)
        return (args, dy, states, fwd_err,
                _ssm_grads_held(what + "_bwd", got, again, want))

    args, dy, states, fwd_err, held = held_at(False)
    # the decay the models start from (dt about 0.8, A about -1): held, not
    # timed
    init = held_at(True)[-2:]
    plain_bwd_ms = _once_ms(lambda: _plain_scan_grads(args, dy))
    torch.cuda.empty_cache()
    shape = {"B": B, "S": S, "Di": Di, "N": N, "h0": 0.1}
    fwd = {"shape": shape, "max_abs_err": fwd_err, "library_ms": None,
           "ms": _time_ms(lambda: sk.selective_scan(*args, save_states=True),
                          flush=True),
           "plain_ms": _time_ms(lambda: ref.selective_scan(*args), iters=3,
                                flush=True),
           # x, dt, B, C, A, D and h0 read; y, hT and the states written
           **bound(sk.cost(B, S, Di, N, save_states=True))}
    # read: x, dt, dy, B, C, A, D and the states; written: dx, ddt, dB, dC,
    # dA, dD, dh0. Per (t, d, n) the replay's exponential and ~12 f32
    # operations (the replay's two, the adjoint's and the five sums')
    bwd = {"shape": shape, **held, "device_ops": device_ops,
           "init_decay": {"forward_max_abs_err": init[0], **init[1]},
           "library_ms": None,
           "ms": _time_ms(lambda: sk.selective_scan_bwd(*args[:6], states,
                                                        dy), flush=True),
           "plain_ms": plain_bwd_ms,
           **bound(sk.bwd_cost(B, S, Di, N))}
    for row in (fwd, bwd):
        row.update(_factors(row))
    log({"check": "selective_scan_bwd@falcon-mamba-7b", "forward": fwd,
         "backward": bwd})
    return [fwd, bwd]


def check_ssd_bwd(gen, device_ops: dict) -> list[dict]:
    """zamba2-1.2b's SSD at its training shape (``SSD_TRAIN``, chunk 256)
    from a nonzero state: the forward that keeps its scratch (y and hT the
    same bits as the serving call's), the backward kernel against autograd
    through the plain SSD over the whole sequence, twice bitwise.
    ``device_ops``: the kernels one backward call launches. Rows: forward,
    backward."""
    import torch

    from repro_torch.kernels import ref, ssd as dk

    B, S, Hs, P, N = (SSD_TRAIN[k] for k in ("B", "S", "Hs", "P", "N"))

    def held_at(init_decay: bool):
        what = "ssd" + (" init decay" if init_decay else "")
        args = _ssd_case(gen, S, 0.1, B=B, Hs=Hs, P=P, N=N,
                         init_decay=init_decay)
        dy = torch.randn(B, S, Hs, P, generator=gen,
                         device="cuda").bfloat16()
        y, hT = dk.ssd(*args, chunk=CHUNK)
        yk, hk, scratch = dk._forward(*args, CHUNK)
        if not (torch.equal(y, yk) and torch.equal(hT, hk)):
            raise AssertionError(f"{what}: the training forward's y or hT "
                                 f"differ from serving's")
        got = dk.ssd_bwd(*args[:6], scratch, dy, chunk=CHUNK)
        again = dk.ssd_bwd(*args[:6], scratch, dy, chunk=CHUNK)
        ins = [t.clone().requires_grad_() for t in args]
        yw, _ = ref.ssd(*ins, chunk=CHUNK)
        fwd_err = _close(y, yw.detach(), what + " train")

        def plain_grad():
            return torch.autograd.grad(yw, ins, dy, retain_graph=True)

        held = _ssm_grads_held(what + "_bwd", got, again, plain_grad())
        return args, dy, scratch, fwd_err, held, plain_grad

    args, dy, scratch, fwd_err, held, plain_grad = held_at(False)
    plain_bwd_ms = _once_ms(plain_grad)
    del plain_grad
    # the decay the models start from (dt about 0.8, A about -1): held, not
    # timed
    init = held_at(True)[3:5]
    torch.cuda.empty_cache()
    shape = {"B": B, "S": S, "Hs": Hs, "P": P, "N": N, "chunk": CHUNK,
             "h0": 0.1}
    fwd = {"shape": shape, "max_abs_err": fwd_err, "library_ms": None,
           "ms": _time_ms(lambda: dk._forward(*args, CHUNK), flush=True),
           "plain_ms": _time_ms(lambda: ref.ssd(*args, chunk=CHUNK),
                                flush=True),
           # x, dt, B, C, A, D, h0 read; y, hT and the kept scratch written
           **bound(dk.cost(B, S, Hs, P, N, chunk=CHUNK, keep_scratch=True))}
    bwd = {"shape": shape, **held, "device_ops": device_ops,
           "init_decay": {"forward_max_abs_err": init[0], **init[1]},
           "library_ms": None,
           "ms": _time_ms(lambda: dk.ssd_bwd(*args[:6], scratch, dy,
                                             chunk=CHUNK), flush=True),
           "plain_ms": plain_bwd_ms,
           # the least time on the tensor cores (bf16 peak), where its
           # products run
           **bound(dk.bwd_cost(B, S, Hs, P, N, chunk=CHUNK))}
    for row in (fwd, bwd):
        row.update(_factors(row))
    log({"check": "ssd_bwd@zamba2-1.2b", "forward": fwd, "backward": bwd})
    return [fwd, bwd]


def _rss_gb() -> dict:
    """The process's resident host memory (``/proc``) and its peak so far
    (``getrusage``), GB."""
    import resource

    out = {"peak": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
           * 1024 / 1e9}
    for line in Path("/proc/self/status").read_text().splitlines():
        key, _, val = line.partition(":")
        if key == "VmRSS":
            out["now"] = int(val.split()[0]) * 1024 / 1e9
    return out


def _state_bits(state) -> list:
    """Every leaf of a train state, tensors as they are, numpy as bytes."""
    import numpy as np
    import torch

    from repro_torch.models.model_api import tree_leaves

    return [t if isinstance(t, torch.Tensor) else np.asarray(t).tobytes()
            for t in tree_leaves(state)]


def _states_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(_state_bits(a), _state_bits(b)))


def _train_argv(fail: bool) -> list[str]:
    r = TRAIN_RUN
    argv = ["--arch", "smollm-360m", "--full", "--steps", str(r["steps"]),
            "--hosts", str(r["hosts"]), "--snapshot-every",
            str(r["snapshot_every"]), "--seq-len", str(TRAIN["S"]),
            "--batch", str(TRAIN["B"])]
    return argv + (["--fail-at", str(r["fail_at"])] if fail else [])


def _rehearsed_counters() -> dict:
    """The trainer's counters for the smoke's schedule, from the same
    trainer at REDUCED width on the CPU (the protocol does not depend on
    the model)."""
    from repro_torch.config import RunConfig
    from repro_torch.configs import get
    from repro_torch.training.trainer import AdHocTrainer

    r = TRAIN_RUN
    t = AdHocTrainer(get("smollm-360m", reduced=True),
                     RunConfig(arch="smollm-360m",
                               snapshot_interval_steps=r["snapshot_every"]),
                     n_hosts=r["hosts"], total_steps=r["steps"], seq_len=16,
                     global_batch=2, fail_at_steps={r["fail_at"]: "host000"},
                     device="cpu")
    rep = t.run_to_completion()
    return {k: getattr(rep, k) for k in (
        "completed", "effective_steps", "executed_steps", "recomputed_steps",
        "restores", "restarts_from_zero", "host_of_step")}


def _timed_guest(timing: dict):
    """Wrap ``TrainingGuest``'s step, snapshot and restore with device-
    synchronised host clocks into ``timing``; returns the undo."""
    import torch

    from repro_torch.training import trainer as tr

    orig = {n: getattr(tr.TrainingGuest, n)
            for n in ("run_step", "snapshot", "restore")}

    def wrap(name):
        def run(self, *args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig[name](self, *args)
            torch.cuda.synchronize()
            timing[name].append(time.perf_counter() - t)
            if name == "snapshot":
                timing["blob_bytes"] = len(out)
            return out
        return run

    for n in orig:
        setattr(tr.TrainingGuest, n, wrap(n))
    return lambda: [setattr(tr.TrainingGuest, n, f) for n, f in orig.items()]


def _node_ops(prof, node: str, busy_ms: float) -> dict:
    """The kernels that the autograd nodes named ``node`` (a Function's
    backward, as ``MoeRouteBackward``) launched in a profile, with those of
    the operations they called: the calls, their device ms, its share of
    ``busy_ms``, and their launches."""
    def kernels(e) -> int:
        return len(e.kernels) + sum(kernels(c) for c in e.cpu_children)

    calls = [e for e in prof.events() if e.name == node]
    ms = sum(e.device_time_total for e in calls) / 1e3
    return {"calls": len(calls), "device_ms": ms, "share": ms / busy_ms,
            "launches": sum(kernels(e) for e in calls)}


def _profile_step(step, state, batch, nodes=()) -> dict:
    """One warm train step under ``torch.profiler``: the device's busy
    share of the step's wall time, the kernels by device time, the host's
    own time, and for each autograd node named in ``nodes`` its share
    (``_node_ops``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3),
            "host_self_ms": sum(e.self_cpu_time_total for e in host) / 1e3,
            "top_kernels": [{"name": e.key[:70], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3,
                             "share": e.self_device_time_total / 1e3 / busy}
                            for e in top],
            "nodes": {n: _node_ops(prof, n, busy) for n in nodes}}


def _leaf_shares(got, want, prefix: str = "") -> dict:
    """For each leaf of two trees of one structure, ||got - want|| /
    ||want|| (Frobenius, f32), as a list: a layer-stacked leaf (under
    ``layers``, ``moe_layers``, ``enc_layers``...) layer by layer, any
    other whole."""
    out = {}
    for k, w in want.items():
        name = f"{prefix}/{k}"
        if isinstance(w, dict):
            out.update(_leaf_shares(got[k], w, name))
            continue
        d, w = got[k].float() - w.float(), w.float()
        dims = tuple(range("layers/" in name, w.dim()))
        out[name] = (d.square().sum(dims) / w.square().sum(dims)).sqrt() \
            .reshape(-1).tolist()
    return out


class _KeptBackward:
    """While entered, keeps every call of the backward kernels that the
    autograd Functions make (``ssd_bwd``, ``selective_scan_bwd``,
    ``flash_attention_bwd``, ``rmsnorm_bwd``, ``moe_route_bwd``): clones of
    the tensor arguments, and the keywords."""

    def __init__(self):
        from repro_torch.kernels import flash_attention as fk
        from repro_torch.kernels import moe_route as mk
        from repro_torch.kernels import rmsnorm as rk
        from repro_torch.kernels import selective_scan as sk
        from repro_torch.kernels import ssd as dk

        self.mods = {"ssd": (dk, "ssd_bwd"),
                     "selective_scan": (sk, "selective_scan_bwd"),
                     "flash_attention": (fk, "flash_attention_bwd"),
                     "rmsnorm": (rk, "rmsnorm_bwd"),
                     "moe_route": (mk, "moe_route_bwd")}
        self.calls = {name: [] for name in self.mods}
        self.orig = {name: getattr(mod, attr)
                     for name, (mod, attr) in self.mods.items()}

    def __enter__(self):
        import torch

        for name, (mod, attr) in self.mods.items():
            f = self.orig[name]

            def kept(*args, _name=name, _f=f, **kw):
                self.calls[_name].append((
                    [a.detach().clone() if isinstance(a, torch.Tensor) else a
                     for a in args], kw))
                return _f(*args, **kw)

            kept.launches = f.launches
            setattr(mod, attr, kept)
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self.mods.items():
            self.orig[name].launches = getattr(mod, attr).launches
            setattr(mod, attr, self.orig[name])


def _flash_bwd_rounded(q, k, v, o, dout, lse, *, causal, q_offset):
    """The flash backward's arithmetic as ``csrc/flash_attention_bwd.cu``
    states it, in plain torch: delta from the bf16 output, P and dS rounded
    to bf16 before the products that take them, f32 sums (a kv head's
    gradients summed over its query heads). Returns (dq, dk, dv) bf16."""
    import torch

    scale = q.shape[-1] ** -0.5
    G = q.shape[2] // k.shape[2]
    qf, of, df = (t.float() for t in (q, o, dout))
    kf, vf = (t.float().repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        keep = (torch.arange(k.shape[1], device=q.device)[None, :]
                <= torch.arange(q.shape[1], device=q.device)[:, None]
                + q_offset)
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - lse[..., None])
    del s
    delta = (df * of).sum(-1).transpose(1, 2)
    ds = torch.einsum("bqhd,bkhd->bhqk", df, vf).sub_(delta[..., None])
    ds = ds.mul_(p).bfloat16().float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    del ds
    dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), df)
    B, Sk, K, D = k.shape
    dk, dv = (t.reshape(B, Sk, K, G, D).sum(3) for t in (dk, dv))
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _forced_backward(kept: _KeptBackward) -> dict:
    """Each backward kernel call kept from a train step (``_KeptBackward``)
    run again, twice, against a plain version on the same inputs: the SSD
    and the scan against autograd through their plain versions
    (``_ssm_grads_held``: bf16 gradients per 64-step tile within
    GRAD_TILE_SHARE, f32 within SSM_F32_GRAD_REL); RMSNorm's dx per 64-row
    tile within GRAD_TILE_SHARE, dw within DW_REL of its largest value,
    against autograd through the plain RMSNorm; flash attention's dq, dk,
    dv per (64-row tile, head) within GRAD_TILE_SHARE of
    ``_flash_bwd_rounded``, the kernel's own rounding points in plain
    torch; the router's d_logits within ROUTE_BWD_REL of its largest value
    against ``ref.moe_route_bwd`` (a planted fault: the last token's row
    1.1 times), its dx within ROUTE_DX_REL and d_router within
    ROUTE_DROUTER_REL of ``ref.moe_route_grads`` on the same inputs.
    (Against autograd through the plain f32 attention, the bf16 dS
    alone moves dq's tiles by up to 1.4 % at zamba2's activations:
    ``_flash_bwd_rounded`` differs from it by as much as the kernel does.)
    Two runs must give the same bits, every gradient must be finite, and a
    fault planted in the last tile (x 1.1) must read above the tile limit.
    Returns, per kernel, the worst reading of each gradient over the calls
    and the least planted reading."""
    import torch

    from repro_torch.kernels import moe_route as mk, ref

    calls, orig = kept.calls, kept.orig
    out = {kind: {"calls": len(c)} for kind, c in calls.items() if c}

    def note(kind, readings: dict, planted: float):
        r = out[kind]
        for n, v in readings.items():
            r[n] = max(r.get(n, 0.0), v)
        r["planted_min"] = min(r.get("planted_min", float("inf")), planted)

    def held(kind, names, got, again, want, share):
        """bf16 gradients of a kernel other than the SSMs', by ``share``;
        the fault planted in the first one's last tile."""
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"forced {kind}: two runs differ")
        if not all(bool(torch.isfinite(g.float()).all()) for g in got):
            raise AssertionError(f"forced {kind}: a gradient is not finite")
        bad = got[0].clone()
        bad[:, (bad.shape[1] - 1) // 64 * 64:] *= 1.1
        note(kind, {n: share(g, w) for n, g, w in zip(names, got, want)},
             share(bad, want[0]))

    for kind in ("ssd", "selective_scan"):
        for a, kw in calls[kind]:
            x, dt, A, Bm, C, D, saved, dy = a[:8]
            got, again = orig[kind](*a, **kw), orig[kind](*a, **kw)
            if kind == "ssd":
                h0 = torch.zeros(x.shape[0], *x.shape[2:], Bm.shape[-1],
                                 device=x.device)
                ins = [t.clone().requires_grad_()
                       for t in (x, dt, A, Bm, C, D, h0)]
                want = torch.autograd.grad(
                    ref.ssd(*ins, chunk=kw["chunk"])[0], ins, dy)
            else:
                want = _plain_scan_grads((x, dt, A, Bm, C, D, saved[:, 0]),
                                         dy)
            r = _ssm_grads_held(f"forced {kind}_bwd", got, again, want)
            note(kind, {**r["grad_tile_share"], **r["f32_grad_rel"]},
                 r["planted_tile_share"])
            del got, again, want
    for a, kw in calls["flash_attention"]:
        fn = orig["flash_attention"]
        held("flash_attention", ("dq", "dk", "dv"), fn(*a, **kw),
             fn(*a, **kw), _flash_bwd_rounded(*a, **kw), _tile_share)
    for a, kw in calls["rmsnorm"]:
        x, w, g = a[:3]
        got, again = orig["rmsnorm"](*a, **kw), orig["rmsnorm"](*a, **kw)
        ins = [x.clone().requires_grad_(), w.clone().requires_grad_()]
        want = torch.autograd.grad(ref.rmsnorm(*ins, *a[3:], **kw), ins, g)
        rows = (1, -1, x.shape[-1])
        held("rmsnorm", ("dx",), [got[0].reshape(rows)],
             [again[0].reshape(rows)], [want[0].reshape(rows)], _seq_share)
        if not torch.equal(got[1], again[1]):
            raise AssertionError("forced rmsnorm: two runs' dw differ")
        note("rmsnorm", {"dw": _rel_err(got[1], want[1])}, float("inf"))
    for a, kw in calls["moe_route"]:
        fn = orig["moe_route"]
        got = fn(*a, **kw, with_d_logits=True)
        again = fn(*a, **kw, with_d_logits=True)
        if not all(g is None and h is None or torch.equal(g, h)
                   for g, h in zip(got, again)):
            raise AssertionError("forced moe_route: two runs differ")
        want = ref.moe_route_bwd(*a[2:])
        dx, dr, dl = got
        pdx, pdr = ref.moe_route_grads(
            *a, **mk.grads_plan(a[0].shape[1], a[1].shape[1]).order())
        bad = dl.clone()
        bad[-1] *= 1.1
        note("moe_route", {"d_logits": _rel_err(dl, want),
                           **({} if dx is None else
                              {"route_dx": _rel_err(dx, pdx)}),
                           **({} if dr is None else
                              {"d_router": _rel_err(dr, pdr)})},
             _rel_err(bad, want))
    limit = {"dw": DW_REL, "dA": SSM_F32_GRAD_REL, "dD": SSM_F32_GRAD_REL,
             "dh0": SSM_F32_GRAD_REL, "d_logits": ROUTE_BWD_REL,
             "route_dx": ROUTE_DX_REL, "d_router": ROUTE_DROUTER_REL}
    for kind, r in out.items():
        over = {n: v for n, v in r.items() if n not in ("calls", "planted_min")
                and not v <= limit.get(n, GRAD_TILE_SHARE)}
        floor = ROUTE_BWD_REL if kind == "moe_route" else GRAD_TILE_SHARE
        if over or not r["planted_min"] > floor:
            raise AssertionError(f"forced {kind}: {r}")
    return out


def _first_step(cfg, B: int, S: int, plant: tuple[str, ...] | None,
                profile: bool = False, seed: int = 0,
                forced: bool = False) -> dict:
    """The first step of a training run of ``cfg`` (init seed ``seed``,
    batch ``seed`` of B rows of S tokens from data seed ``seed``) under the
    kernels and under the plain versions, from one initial state: the loss
    and the grad norm within FIRST_STEP_LOSS_ATOL and FIRST_STEP_NORM_REL,
    and every gradient leaf, layer by layer, held. With ``plant`` (a
    leaf's path) each leaf within FIRST_STEP_LEAF_SHARE, and a planted
    fault (the last layer's slice of that leaf 20 % too large) must read
    above it. Without, each leaf within its share under a control of
    rounding: the plain step with every embedding value one bf16 ulp up or
    down at random, a rounding at every input value, as the kernels round
    differently at every activation. With ``forced``, every backward
    kernel call of the kernel step is also run again against a plain
    version on the same inputs (``_forced_backward``). With ``profile``, a
    second kernel step is profiled."""
    import torch

    from repro_torch.config import RunConfig
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.models.model_api import tree_map
    from repro_torch.training.state import init_train_state
    from repro_torch.training.step import make_train_step

    model = get_model(cfg)
    step = make_train_step(model, RunConfig(arch=cfg.arch_id))
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticDataset(
        cfg, S, B, seed).batch(seed).items()}
    out, mu = {"seed": seed}, {}
    kept = _KeptBackward()
    for name in ("kernel", "plain") + (() if plant else ("control",)):
        state = init_train_state(model, seed, "cuda")
        if name == "control":
            emb = state["params"]["embedding"]
            gen = torch.Generator(device="cuda").manual_seed(seed)
            sign = torch.randint(0, 2, emb.shape, generator=gen,
                                 device="cuda") * 2 - 1
            emb.mul_(1 + sign * 2.0 ** -7)
            del sign
        with ops.use_backend("kernel" if name == "kernel" else "plain"):
            if name == "kernel" and forced:
                with kept:
                    state, m = step(state, batch)
            else:
                state, m = step(state, batch)
        out[name] = {k: float(m[k]) for k in ("loss", "grad_norm", "ce")}
        mu[name] = tree_map(torch.clone, state["opt"]["mu"])
        if name == "kernel" and profile:
            out["profile"] = _profile_step(step, state, batch)
        del state, m
        gc.collect()
        torch.cuda.empty_cache()
    d_loss = abs(out["kernel"]["loss"] - out["plain"]["loss"])
    d_norm = abs(out["kernel"]["grad_norm"] / out["plain"]["grad_norm"] - 1)
    by_layer = _leaf_shares(mu["kernel"], mu["plain"])
    # NaN (a leaf not finite, or all zero in the plain step) reads as inf
    leaves = {n: max(float("inf") if x != x else x for x in v)
              for n, v in by_layer.items()}
    worst = max(leaves, key=leaves.get)
    if plant:
        limits = dict.fromkeys(leaves, FIRST_STEP_LEAF_SHARE)
        leaf = mu["kernel"]
        for k in plant:
            leaf = leaf[k]
        leaf[-1] *= 1.2
        planted = _leaf_shares(mu["kernel"], mu["plain"])[
            "/" + "/".join(plant)][-1]
    else:
        limits = {n: max(v) for n, v in _leaf_shares(
            mu["control"], mu["plain"]).items()}
        planted = None
    del mu
    gc.collect()
    torch.cuda.empty_cache()
    ratio = {n: leaves[n] / limits[n] for n in leaves}
    out.update(loss_diff=d_loss, grad_norm_rel=d_norm,
               loss_atol=FIRST_STEP_LOSS_ATOL,
               grad_norm_rel_tol=FIRST_STEP_NORM_REL,
               leaf_shares=leaves, worst_leaf=worst,
               worst_leaf_by_layer=by_layer[worst],
               leaf_share_limit=(FIRST_STEP_LEAF_SHARE if plant else
                                 "the control's share of the same leaf"),
               worst_share_over_limit=max(ratio.values()),
               worst_leaf_over_limit=max(ratio, key=ratio.get))
    if plant:
        out["planted_leaf_share"] = planted
    else:
        out["control_leaf_shares"] = limits
    if forced:
        out["forced_backward"] = _forced_backward(kept)
        del kept
        gc.collect()
        torch.cuda.empty_cache()
    if (d_loss > FIRST_STEP_LOSS_ATOL or d_norm > FIRST_STEP_NORM_REL
            or not out["worst_share_over_limit"] <= 1):
        raise AssertionError(f"train {cfg.arch_id}: the first step's kernel "
                             f"and plain runs disagree: {out}")
    if plant and not planted > FIRST_STEP_LEAF_SHARE:
        raise AssertionError(f"train {cfg.arch_id}: a planted gradient fault "
                             f"passes the leaf check: {planted}")
    return out


def phase_train_run(card: str) -> dict:
    """b. smollm-360m at full width and depth through ``launch/train.py``'s
    ``main``: with a failure, then without; the restored run's final state
    bitwise the uninterrupted run's."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli

    from repro_torch.configs import get

    want = _rehearsed_counters()
    first = _first_step(get("smollm-360m"), TRAIN["B"], TRAIN["S"],
                        ("layers", "attn", "ln"), profile=True)
    out = {"phase": "train", "arch": "smollm-360m", "card": card,
           "seq": TRAIN["S"], "batch": TRAIN["B"], **TRAIN_RUN,
           "first_step": first, "rehearsed": want}
    reports = {}
    for fail in (True, False):
        timing = {"run_step": [], "snapshot": [], "restore": []}
        undo = _timed_guest(timing)
        torch.cuda.reset_peak_memory_stats()
        rss0 = _rss_gb()
        ops.reset_counts()
        t0 = time.perf_counter()
        try:
            rep = train_cli.main(_train_argv(fail))
        finally:
            undo()
        wall = time.perf_counter() - t0
        gc.collect()
        counts = ops.counts()
        key = "failure" if fail else "clean"
        steps = timing["run_step"]
        med = statistics.median(steps)
        out[key] = {
            "wall_s": wall,
            "counters": {k: getattr(rep, k) for k in want},
            "losses": rep.losses,
            "step_ms_median": med * 1e3, "step_ms_min": min(steps) * 1e3,
            "step_ms_first": steps[0] * 1e3,
            "tokens_per_s": TRAIN["B"] * TRAIN["S"] / med,
            "snapshot_s": timing["snapshot"], "restore_s": timing["restore"],
            "blob_bytes": timing.get("blob_bytes"),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "host_gb_before": rss0, "host_gb_after": _rss_gb(),
            "launches": {k: v["launches"] for k, v in counts.items()},
        }
        _check_counts(counts, ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                               "flash_attention_bwd"), f"train {key}")
        if not all(np.isfinite(l) for _, l in rep.losses):
            raise AssertionError(f"train {key}: a loss is not finite")
        reports[key] = rep
        if fail:
            got = out[key]["counters"]
            if got != want:
                raise AssertionError(f"train: counters {got}, the rehearsal "
                                     f"predicts {want}")
            if rep.losses[0][1] != first["kernel"]["loss"]:
                raise AssertionError("train: the run's first loss differs "
                                     "from the same step run alone")
    if not reports["clean"].completed or reports["clean"].restores:
        raise AssertionError("train: the clean run did not complete alone")
    if not _states_equal(reports["failure"].final_state,
                         reports["clean"].final_state):
        raise AssertionError("train: the restored run's final state differs "
                             "from the uninterrupted run's")
    out["final_states_bitwise_equal"] = True
    out["launches"] = out["failure"]["launches"]
    del reports
    gc.collect()
    torch.cuda.empty_cache()
    log(out)
    return out


def _digest(state) -> list:
    """An exact digest of every tensor leaf (its int32 words summed, and
    weighted by position, in int64 on the device) and the numpy leaves'
    bytes."""
    import numpy as np
    import torch

    from repro_torch.models.model_api import tree_leaves

    out = []
    for t in tree_leaves(state):
        if isinstance(t, torch.Tensor):
            w = t.reshape(-1).view(torch.int32).to(torch.int64)
            pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
            out.append((int(w.sum()), int((w * pos).sum())))
        else:
            out.append(np.asarray(t).tobytes())
    return out


# the kernels each training path launches (forward and backward)
TRAIN_PATH = {
    "qwen3-8b": ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                 "flash_attention_bwd"),
    "falcon-mamba-7b": ("rmsnorm", "rmsnorm_bwd", "selective_scan",
                        "selective_scan_bwd"),
    "zamba2-1.2b": ("rmsnorm", "rmsnorm_bwd", "ssd", "ssd_bwd",
                    "flash_attention", "flash_attention_bwd"),
    "granite-moe-1b-a400m": ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                             "flash_attention_bwd", "moe_route",
                             "moe_route_bwd"),
    "whisper-medium": ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                       "flash_attention_bwd"),
}
# the training runs of the recurrent, MoE and enc-dec families: published
# widths, B 2, S 2048 (whisper's encoder over min(S, 1500) = 1500 frames),
# 3 steps twice (``layers``: None is full depth); falcon-mamba-7b at 8 of
# 64 layers (its full depth's f32
# state, ~7.2 B parameters x 16 bytes, does not fit one card), zamba2-1.2b
# at full depth. The first-step gates against the plain step
# (``_first_step``) run at ``gate_layers`` (None: full depth) for each of
# ``gate_seeds``, the backward kernels of the first seed's kernel step also
# run again against plain versions (``_forced_backward``). falcon-mamba:
# 2 layers, where the plain scan's per-step Python loop stays in seconds,
# each leaf within FIRST_STEP_LEAF_SHARE (``plant``: the planted fault's
# leaf). zamba2: full depth, where rounding alone moves its leaves far
# (random weights, gradient norm 78-344): each leaf within its share under
# the every-value control. Swapping one kernel at a time into the plain
# step (tools/train_gate_swap.py; PERF.md section 6) puts all of the
# kernel step's difference on the flash forward's bf16 probabilities;
# at seeds 0, 1, 2 the kernel step's leaves read 0.57, 0.63 and 0.67 of
# the control's at most.
# granite-moe-1b-a400m and whisper-medium: full depth, each gate at 2
# layers (whisper: 2 encoder and 2 decoder layers), each leaf within
# FIRST_STEP_LEAF_SHARE. deepseek-moe-16b does not train on the card: its
# f32 state (~16.4 B parameters x 16 bytes) does not fit; its code is
# granite's, its router's backward is checked at its shape
# (``check_moe_route_bwd``) and its leading dense layer and shared experts
# on the CPU (tests/test_torch_train_moe.py).
TRAIN_RUNS = {
    "falcon-mamba-7b": dict(B=2, S=2048, layers=8, steps=3, gate_layers=2,
                            gate_seeds=(0,), plant=("layers", "ln")),
    "zamba2-1.2b": dict(B=2, S=2048, layers=None, steps=3, gate_layers=None,
                        gate_seeds=(0, 1), plant=None),
    "granite-moe-1b-a400m": dict(B=2, S=2048, layers=None, steps=3,
                                 gate_layers=2, gate_seeds=(0,),
                                 plant=("moe_layers", "attn", "ln")),
    "whisper-medium": dict(B=2, S=2048, layers=None, steps=3, gate_layers=2,
                           gate_seeds=(0,),
                           plant=("dec_layers", "self_attn", "ln")),
}


def train_cfg(arch: str, n: int | None):
    """``arch``'s published config with its depth cut to ``n`` layers
    (None: full depth); an encoder's depth is cut with it."""
    from dataclasses import replace

    from repro_torch.configs import get

    full = get(arch)
    if n is None:
        return full
    if full.n_encoder_layers:
        return replace(full, n_layers=n, n_encoder_layers=n)
    return replace(full, n_layers=n)


def _train_twice(cfg, q: dict, what: str) -> dict:
    """``cfg`` trained ``q["steps"]`` steps at B ``q["B"]``, S ``q["S"]``,
    twice from seed 0: finite losses, the two runs bitwise equal (losses,
    grad norms, every leaf's digest), every kernel of its path
    (``TRAIN_PATH``) launched and no plain version."""
    import numpy as np
    import torch

    from repro_torch.config import RunConfig
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.training.state import init_train_state
    from repro_torch.training.step import make_train_step

    model = get_model(cfg)
    step = make_train_step(model, RunConfig(arch=cfg.arch_id))
    data = SyntheticDataset(cfg, q["S"], q["B"], 0)
    runs = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        state = init_train_state(model, 0, "cuda")
        metrics, times = [], []
        for i in range(q["steps"]):
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in data.batch(i).items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
            times.append(time.perf_counter() - t)
        runs.append({"metrics": metrics, "step_ms": [t * 1e3 for t in times],
                     "digest": _digest(state),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "launches": {k: v["launches"]
                                  for k, v in ops.counts().items()}})
        _check_counts(ops.counts(), TRAIN_PATH[cfg.arch_id], f"train {what}")
        del state, m
        gc.collect()
        torch.cuda.empty_cache()
    a, b = runs
    if not all(np.isfinite(m["loss"]) for m in a["metrics"]):
        raise AssertionError(f"train {what}: a loss is not finite: "
                             f"{a['metrics']}")
    if a["metrics"] != b["metrics"] or a["digest"] != b["digest"]:
        raise AssertionError(f"train {what}: two runs from one state differ")
    out = {"arch": cfg.arch_id, "params": cfg.param_count(), "B": q["B"],
           "S": q["S"], "metrics": a["metrics"], "step_ms": a["step_ms"],
           "step_ms_second_run": b["step_ms"],
           "tokens_per_s": q["B"] * q["S"] / (statistics.median(
               a["step_ms"][1:]) / 1e3),
           "peak_gb": a["peak_gb"], "runs_bitwise_equal": True,
           "launches": a["launches"],
           "launches_per_step": {k: v / q["steps"]
                                 for k, v in a["launches"].items()}}
    del model, runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_qwen(card: str) -> dict:
    """c. qwen3-8b at published widths, its depth cut to 8 of 36 layers:
    3 steps at B 2, S 2048, twice from one seed (``_train_twice``)."""
    from dataclasses import replace

    from repro_torch.configs import get

    q = QWEN_TRAIN
    cfg = replace(get("qwen3-8b"), n_layers=q["layers"])
    out = {"phase": "train_qwen3", "card": card,
           "reduced": {"n_layers": f"{q['layers']} of 36"},
           **_train_twice(cfg, q, "qwen3-8b")}
    log(out)
    return out


def phase_train_family(card: str, arch: str) -> dict:
    """d, e. One of ``TRAIN_RUNS`` at published widths: the first step
    against the plain step (``_first_step``'s limits) at the gate's depth
    and seeds, the first seed's backward kernel calls run again against
    plain versions, then 3 steps at B 2, S 2048, twice from one seed
    (``_train_twice``)."""
    from repro_torch.configs import get

    q = TRAIN_RUNS[arch]
    full = get(arch)
    gate = train_cfg(arch, q["gate_layers"])
    first = [_first_step(gate, q["B"], q["S"], q["plant"], seed=seed,
                         forced=seed == q["gate_seeds"][0])
             for seed in q["gate_seeds"]]
    cfg = train_cfg(arch, q["layers"])
    out = {"phase": f"train_{arch}", "card": card,
           "reduced": ({} if q["layers"] is None else
                       {"n_layers": f"{q['layers']} of {full.n_layers}"}),
           "first_step": {"n_layers": f"{gate.n_layers} of {full.n_layers}",
                          "seeds": first},
           **_train_twice(cfg, q, arch)}
    log(out)
    return out


def phase_train(card: str) -> dict:
    """5. Training: a, the backward kernels (and the forwards they pair
    with) at the training shapes against plain autograd; b, smollm-360m
    trained through ``launch/train.py`` with a failure and without; c,
    qwen3-8b at published widths, 8 of 36 layers; d, falcon-mamba-7b (8 of
    64 layers) and zamba2-1.2b (full depth) at published widths; e,
    granite-moe-1b-a400m and whisper-medium at published widths and full
    depth."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(24)
    t0 = time.perf_counter()
    parts = _flash_bwd_parts()
    checks = {
        "flash@smollm": check_flash_bwd(gen, **TRAIN, H=15, K=5, D=64,
                                        what="smollm-360m",
                                        parts_ms=parts["smollm-360m"]),
        "flash@qwen3": check_flash_bwd(gen, B=QWEN_TRAIN["B"],
                                       S=QWEN_TRAIN["S"], H=32, K=8, D=128,
                                       what="qwen3-8b",
                                       parts_ms=parts["qwen3-8b"]),
        **{key: check_rmsnorm_bwd(gen, RMSNORM_BWD_SHAPES[what], what,
                                  parts["rmsnorm_bwd_ops"][what])
           for key, what in (("rmsnorm@smollm", "smollm-360m block"),
                             ("rmsnorm@qwen3-qk", "qwen3-8b qk"),
                             ("rmsnorm@qwen3", "qwen3-8b block"))},
        "scan@falcon": check_scan_bwd(gen, parts["scan_bwd_ops"]),
        "ssd@zamba2": check_ssd_bwd(gen, parts["ssd_bwd_ops"]),
        "route@granite": check_moe_route_bwd(
            gen, "granite-moe-1b-a400m",
            parts["route_bwd_ops"]["granite-moe-1b-a400m"]),
        "route@deepseek": check_moe_route_bwd(
            gen, "deepseek-moe-16b",
            parts["route_bwd_ops"]["deepseek-moe-16b"]),
        # whisper-medium's encoder (1500 frames) and cross attention (2048
        # queries over 1500 keys): the non-causal branch, Sq != Sk
        "flash@whisper-enc": check_flash_bwd(
            gen, B=2, S=1500, H=16, K=16, D=64, what="whisper-medium "
            "encoder", parts_ms=None, causal=False),
        "flash@whisper-cross": check_flash_bwd(
            gen, B=2, S=2048, Sk=1500, H=16, K=16, D=64,
            what="whisper-medium cross", parts_ms=None, causal=False),
    }
    # K-a at a serving shape: lse on leaves the output's bits
    from repro_torch.kernels import flash_attention as fk

    qs = torch.randn(1, CHUNK, 32, 128, generator=gen,
                     device="cuda").bfloat16()
    ks = torch.randn(1, 1536, 8, 128, generator=gen, device="cuda").bfloat16()
    vs = torch.randn(1, 1536, 8, 128, generator=gen, device="cuda").bfloat16()
    if not torch.equal(fk.flash_attention(qs, ks, vs, q_offset=1280),
                       fk.flash_attention(qs, ks, vs, q_offset=1280,
                                          with_lse=True)[0]):
        raise AssertionError("flash: lse changed a serving chunk's bits")
    del qs, ks, vs
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    run = phase_train_run(card)
    t2 = time.perf_counter()
    qwen = phase_train_qwen(card)
    seconds = {"train_kernels": round(t1 - t0, 3),
               "train_smollm": round(t2 - t1, 3),
               "train_qwen3": round(time.perf_counter() - t2, 3)}
    runs = {}
    for arch in TRAIN_RUNS:
        t = time.perf_counter()
        runs[arch] = phase_train_family(card, arch)
        seconds[f"train_{arch}"] = round(time.perf_counter() - t, 3)
    log({"phase_seconds": seconds, "arch": "train"})
    return {"checks": checks, "run": run, "qwen": qwen, **runs}


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
    # no TPU kernel either (the JAX package routes and runs its experts in
    # XLA, repro/models/moe.py:81-87, 209-213): row-invariant too
    "moe_route": ("cuda", "src/repro_torch/csrc/moe_route.cu",
                  "src/repro/models/moe.py:209 (no TPU kernel: XLA's f32 "
                  "einsum, softmax, top_k)"),
    "gemm_rows_grouped": ("cuda", "src/repro_torch/csrc/gemm_rows.cu",
                          "src/repro/models/moe.py:83 (no TPU kernel: XLA's "
                          "expert einsums; torch.bmm on the card)"),
    # training's backward kernels: the TPU kernels have none (the JAX
    # package differentiates the ops' XLA form, repro/kernels/ops.py:35,
    # 100-118); each is the backward of the port of the kernel named
    "flash_attention_bwd": (
        "cuda", "src/repro_torch/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:139 (its backward: XLA's "
        "autodiff of repro/kernels/ops.py:100-118)"),
    "rmsnorm_bwd": ("cuda", "src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:48 (its backward: XLA's "
                    "autodiff of repro/kernels/ops.py:35)"),
    "selective_scan_bwd": (
        "cuda", "src/repro_torch/csrc/selective_scan_bwd.cu",
        "src/repro/kernels/selective_scan.py:111 (its backward: XLA's "
        "autodiff of repro/kernels/ops.py:434-485)"),
    "ssd_bwd": ("cuda", "src/repro_torch/csrc/ssd_bwd.cu",
                "src/repro/kernels/ssd.py:112 (its backward: XLA's autodiff "
                "of repro/kernels/ops.py:534-585)"),
    # the router's backward, d_logits and the einsum's two products (dx,
    # d_router): no TPU kernel (XLA's autodiff of the routing,
    # repro/models/moe.py:209-218)
    "moe_route_bwd": ("cuda", "src/repro_torch/csrc/moe_route_bwd.cu",
                      "src/repro/models/moe.py:209 (no TPU kernel: XLA's "
                      "autodiff of the f32 einsum, softmax, top_k and aux "
                      "loss, repro/models/moe.py:209-218; two launches, "
                      "moe_route_bwd_kernel and moe_route_grads_kernel)"),
}
# the training path's rows: (kernel, check, row, model, whose launches)
TRAIN_ROWS = [
    ("flash_attention", "flash@smollm", 0, "smollm-360m", "run"),
    ("flash_attention_bwd", "flash@smollm", 1, "smollm-360m", "run"),
    ("rmsnorm", "rmsnorm@smollm", 0, "smollm-360m", "run"),
    ("rmsnorm_bwd", "rmsnorm@smollm", 1, "smollm-360m", "run"),
    ("flash_attention", "flash@qwen3", 0, "qwen3-8b", "qwen"),
    ("flash_attention_bwd", "flash@qwen3", 1, "qwen3-8b", "qwen"),
    ("rmsnorm", "rmsnorm@qwen3", 0, "qwen3-8b", "qwen"),
    ("rmsnorm_bwd", "rmsnorm@qwen3", 1, "qwen3-8b", "qwen"),
    ("rmsnorm_bwd", "rmsnorm@qwen3-qk", 1, "qwen3-8b", "qwen"),
    ("selective_scan", "scan@falcon", 0, "falcon-mamba-7b",
     "falcon-mamba-7b"),
    ("selective_scan_bwd", "scan@falcon", 1, "falcon-mamba-7b",
     "falcon-mamba-7b"),
    ("ssd", "ssd@zamba2", 0, "zamba2-1.2b", "zamba2-1.2b"),
    ("ssd_bwd", "ssd@zamba2", 1, "zamba2-1.2b", "zamba2-1.2b"),
    ("moe_route", "route@granite", 0, "granite-moe-1b-a400m",
     "granite-moe-1b-a400m"),
    ("moe_route_bwd", "route@granite", 1, "granite-moe-1b-a400m",
     "granite-moe-1b-a400m"),
    ("flash_attention", "flash@whisper-enc", 0, "whisper-medium",
     "whisper-medium"),
    ("flash_attention_bwd", "flash@whisper-enc", 1, "whisper-medium",
     "whisper-medium"),
    ("flash_attention_bwd", "flash@whisper-cross", 1, "whisper-medium",
     "whisper-medium"),
]
# each training row's path: the model and the depth it trains at
TRAIN_PATH_NAME = {"smollm-360m": "train", "qwen3-8b": "train (8 of 36 layers)",
                   "falcon-mamba-7b": "train (8 of 64 layers)",
                   "zamba2-1.2b": "train", "granite-moe-1b-a400m": "train",
                   "whisper-medium": "train"}
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
    # the MoE family: the decode step's router (8 tokens) and one step's
    # grouped and other row-invariant products (8 rows)
    "deepseek-moe-16b": {
        "rmsnorm": ("rmsnorm", 4),
        "paged_decode_attention": ("paged_decode_attention@deepseek", 0),
        "decode_attention": ("decode_attention@deepseek", 0),
        "flash_attention": ("flash_attention@deepseek", 2),
        "gemm_rows": ("gemm_rows@deepseek-moe-16b", -2),
        "moe_route": ("moe_route", 0),
        "gemm_rows_grouped": ("gemm_rows_grouped", 3)},
    "granite-moe-1b-a400m": {
        "rmsnorm": ("rmsnorm@granite", 0),
        "paged_decode_attention": ("paged_decode_attention@granite", 0),
        "flash_attention": ("flash_attention@granite", 2),
        "gemm_rows": ("gemm_rows@granite-moe-1b-a400m", -2),
        "moe_route": ("moe_route@granite", 0),
        "gemm_rows_grouped": ("gemm_rows_grouped@granite", 3)},
    "phi4-mini-3.8b": {"gemm_rows": ("gemm_rows@phi4-mini-3.8b", -2)},
    "minitron-4b": {"gemm_rows": ("gemm_rows@minitron-4b", -2)},
    # the multimodal families: whisper's block norm (d 1024), its decoder's
    # attention (16 / 16 of 64) and longest chunk; llava's are qwen3-8b's
    # shapes (d 4096, 32 / 8 of 128); one decode step's products each
    "whisper-medium": {
        "rmsnorm": ("rmsnorm@whisper", 0),
        "paged_decode_attention": ("paged_decode_attention@whisper", 0),
        "decode_attention": ("decode_attention@whisper", 0),
        "flash_attention": ("flash_attention@whisper", 2),
        "gemm_rows": ("gemm_rows@whisper-medium", -2)},
    "llava-next-mistral-7b": {
        "rmsnorm": ("rmsnorm", 0),
        "paged_decode_attention": ("paged_decode_attention", 0),
        "decode_attention": ("decode_attention", 0),
        "flash_attention": ("flash_attention", 2),
        "gemm_rows": ("gemm_rows@llava-next-mistral-7b", -2)},
}
# rows of a kernel's other routes, with the route's own launches (counted
# around the route's calls in the serve phases): the cross fold of the
# paged decode kernel (the decode step's 8 lanes, C = 1; a chunk's rows,
# C > 1, counted apart),
# the encoder's non-causal flash (1500 frames), the dense cross read over
# the ENC_SEQ-padded cache: (kernel, check row, path, route key)
ROUTE_ROWS = {"whisper-medium": [
    ("paged_decode_attention", ("paged_cross", 0), "paged cross", "cross"),
    ("paged_decode_attention", ("paged_cross", 1), "paged cross chunk",
     "cross chunk"),
    ("flash_attention", ("flash_attention@encoder", 0), "paged encoder",
     "encoder"),
    ("flash_attention", ("flash_attention@encoder", 0), "dense encoder",
     "encoder"),
    ("decode_attention", ("decode_attention@cross", 0), "dense cross",
     "dense cross")]}
# the models whose every phase runs (serve, profile, logits, dense,
# continuity both ways); the others run a short paged serve, and granite-moe
# its logits too
FULL_RUN = ("qwen3-8b", "falcon-mamba-7b", "zamba2-1.2b", "deepseek-moe-16b",
            "whisper-medium", "llava-next-mistral-7b")
# deepseek-moe's spec path: its block norm, decode attention and longest
# prefill chunk, the verify's router (40 tokens) and one verify's grouped and
# other products (40 rows)
MOE_SPEC_SUMMARY_ROW = {
    "rmsnorm": ("rmsnorm", 4),
    "paged_decode_attention": ("paged_decode_attention@deepseek", 0),
    "flash_attention": ("flash_attention@deepseek", 2),
    "moe_route": ("moe_route", 1),
    "gemm_rows_grouped": ("gemm_rows_grouped", 7),
    "gemm_rows": ("gemm_rows@deepseek-moe-16b", -1)}
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
# the cell path's rows (qwen3-8b): its decode step's block norm (8 lanes),
# the paged decode over its 64-page pool, a second prefill chunk (256
# queries over 512 keys, the longest its prompts need), one decode step's
# products at 8 rows
CELL_SUMMARY_ROW = {"rmsnorm": ("rmsnorm", 0),
                    "paged_decode_attention": ("paged_decode_attention@cell",
                                               0),
                    "flash_attention": ("flash_attention", 1),
                    "gemm_rows": ("gemm_rows", -2)}


# the serving paths whose depth is cut, so that the smoke with its training
# runs stays within its time limit (widths are never cut): falcon-mamba-7b's
# phases took 156 s at 64 layers (its logits phase's plain scan 59 s),
# deepseek-moe-16b's 95 s at 28 (PERF.md section 4)
# ---------------------------------------------------------------------------
# whole steps against the H100 roofline (launch/roofline.py)
# ---------------------------------------------------------------------------

# the cells: (arch, seq_len, global batch, kind), at full width and depth
ROOFLINE_CELLS = (("qwen3-8b", 2048, 8, "decode"),
                  ("qwen3-8b", 2048, 2, "prefill"),
                  ("falcon-mamba-7b", 2048, 1, "prefill"),
                  ("zamba2-1.2b", 2048, 1, "prefill"),
                  ("smollm-360m", 2048, 8, "train"),
                  ("granite-moe-1b-a400m", 2048, 2, "train"))
# a measured step under this share of its roofline bound means the meta
# pass counts work the card did not do
ROOFLINE_X_MIN = 0.95
# the meta pass's peak of live bytes against the card's, relative
TEMP_REL = 0.25


def _cell_args(prog, seed: int) -> tuple:
    """The cell's inputs on the card: seeded weights (a train state for a
    train cell), random tokens, and for decode a zeroed cache of seq_len
    positions with every lane at its last one (the meta pass counts every
    position of the cache)."""
    import torch

    from repro_torch.training.state import init_train_state

    model, shape = prog.model, prog.shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B, S, V = shape.global_batch, shape.seq_len, model.cfg.vocab_size

    def tokens(*size):
        return torch.randint(0, V, size, generator=gen, device="cuda",
                             dtype=torch.int32)

    if shape.kind == "train":
        return (init_train_state(model, seed, "cuda"),
                {"tokens": tokens(B, S), "labels": tokens(B, S)})
    params = model.init(seed, "cuda")
    if shape.kind == "prefill":
        return params, {"tokens": tokens(B, S)}
    cache = model.init_cache(B, S, device="cuda")
    return params, cache, {
        "tokens": tokens(B, 1),
        "positions": torch.full((B,), S - 1, dtype=torch.int32,
                                device="cuda")}


def roofline_cell(arch: str, S: int, B: int, kind: str, card: str) -> dict:
    """One cell: the meta pass (``launch/cells.py``), then the same
    program on the card, 3 calls to warm and the median of 5 by CUDA
    events (``_time_ms``); the first call's kernel calls against the meta
    pass's, the peak of bytes allocated above the inputs during one warm
    call against the meta pass's peak of live bytes."""
    import torch

    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.launch.cells import build_cell, lower_cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.roofline import (PEAK_FLOPS_BF16, RooflineTerms,
                                             model_flops_for)

    cfg = get(arch)
    shape = ShapeConfig(f"card_{kind}", S, B, kind)
    t0 = time.perf_counter()
    prog = build_cell(cfg, shape, make_host_mesh(1, 1))
    meta = lower_cell(prog)
    meta_s = time.perf_counter() - t0
    args = _cell_args(prog, seed=0)
    torch.cuda.synchronize()
    ops.reset_counts()
    prog.fn(*args)
    torch.cuda.synchronize()
    counts = ops.counts()
    calls = {name: {"meta": meta["kernels"].get(name, {}).get("calls", 0),
                    "card": c["launches"],
                    "device_launches_a_call":
                        meta["kernels"][name]["launches"]
                        // meta["kernels"][name]["calls"]
                        if name in meta["kernels"] else 0}
             for name, c in counts.items()
             if c["launches"] or name in meta["kernels"]}
    plain = {name: c["plain"] for name, c in counts.items() if c["plain"]}
    for _ in range(2):
        prog.fn(*args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = prog.fn(*args)
    torch.cuda.synchronize()
    temp = torch.cuda.max_memory_allocated() - base
    del out
    ms = _time_ms(lambda: prog.fn(*args), iters=5)
    terms = RooflineTerms(arch, shape.name, "one card", 1, meta["flops"],
                          meta["bytes"], 0.0, {}, model_flops_for(cfg, shape),
                          meta["compute_s"])
    row = {"cell": f"{arch} {kind}", "S": S, "B": B, "card": card,
           "ms": ms,
           "t_compute_ms": terms.t_compute * 1e3,
           "t_memory_ms": terms.t_memory * 1e3,
           "bound": terms.bound,
           "x_roofline": ms / 1e3 / terms.t_bound,
           "mfu": (terms.model_flops / (ms / 1e3) / PEAK_FLOPS_BF16
                   if kind != "decode" else None),
           "model_flops": terms.model_flops, "flops": meta["flops"],
           "bytes": meta["bytes"],
           "temp_bytes_predicted": meta["peak_bytes"],
           "temp_bytes_measured": temp,
           "temp_rel": (meta["peak_bytes"] - temp) / temp,
           "argument_bytes": meta["argument_bytes"],
           "kernel_calls": calls, "plain_calls": plain,
           "meta_pass_s": meta_s}
    log({"roofline": row})
    bad = {n: c for n, c in calls.items() if c["meta"] != c["card"]}
    if bad or plain:
        raise AssertionError(f"roofline {arch} {kind}: kernel calls differ "
                             f"between the meta pass and the card {bad}, "
                             f"or plain versions ran {plain}")
    if not row["x_roofline"] >= ROOFLINE_X_MIN:
        raise AssertionError(f"roofline {arch} {kind}: {ms:.3f} ms is "
                             f"{row['x_roofline']:.3f} of the bound, under "
                             f"{ROOFLINE_X_MIN}: the count overstates")
    if not abs(row["temp_rel"]) <= TEMP_REL:
        raise AssertionError(f"roofline {arch} {kind}: temp bytes predicted "
                             f"{meta['peak_bytes']}, measured {temp}")
    del args, prog
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_roofline(card: str) -> list[dict]:
    """Each of ``ROOFLINE_CELLS`` through ``roofline_cell``; any failure
    fails the run."""
    t0 = time.perf_counter()
    rows = [roofline_cell(*cell, card) for cell in ROOFLINE_CELLS]
    log({"phase_seconds": {"roofline": round(time.perf_counter() - t0, 3)}})
    return rows


def phase_examples() -> dict:
    """``examples/torch_adhoc_serving.py`` on the card (its failure drills
    assert identical continuations); a fresh process."""
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    done = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_adhoc_serving.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    lines = done.stdout.strip().splitlines()
    ok = done.returncode == 0 and sum(
        "failure-free host: True" in ln for ln in lines) == 2
    log({"example": "torch_adhoc_serving.py", "rc": done.returncode,
         "seconds": round(time.perf_counter() - t0, 3), "tail": lines[-3:],
         "stderr": done.stderr.strip().splitlines()[-3:]})
    if not ok:
        raise AssertionError("examples/torch_adhoc_serving.py failed on the "
                             "card")
    return {"rc": done.returncode}


SERVE_LAYERS = {"falcon-mamba-7b": 16, "deepseek-moe-16b": 8}


def run_model(arch: str, card: str) -> dict:
    """Serve, profile, logits, dense and continuity phases of one model of
    ``FULL_RUN`` at full width (``SERVE_LAYERS`` cuts the depth of two of
    them), for qwen3-8b the spill, spec and batch
    phases, for deepseek-moe-16b the self-draft spec phase, for
    whisper-medium the cross spill (their numbers printed beside ``card``,
    the card's name and power limit); a short paged serve of any other
    model, and granite-moe's logits. Its weights and caches are freed
    before returning."""
    from dataclasses import replace

    import torch

    from repro_torch.configs import get
    from repro_torch.models import get_model

    cfg = get(arch)
    depth = cfg.n_layers
    if arch in SERVE_LAYERS:
        cfg = replace(cfg, n_layers=SERVE_LAYERS[arch])
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    log({"phase": "init", "arch": arch, "seconds": time.perf_counter() - t0,
         "n_layers": f"{cfg.n_layers} of {depth}",
         "weights_gb": sum(p.numel() * p.element_size()
                           for p in params.parameters()) / 1e9})
    full = arch in FULL_RUN
    seconds: dict[str, float] = {}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = round(time.perf_counter() - t, 3)
        return out

    serve = timed("serve", phase_serve, model, params, short=not full)
    per_call = serve["launches_per_call"]
    dense = spec = batch = cell = mat = None
    if full:
        timed("profile", phase_profile, model, params)
    if full or arch == "granite-moe-1b-a400m":
        per_call = timed("logits", phase_logits, model,
                         params)["launches_per_call"]
    if full:
        dense = timed("dense", phase_dense, model, params, serve["tokens"])
        for paged in (True, False):
            timed(f"continuity_{'paged' if paged else 'dense'}",
                  phase_continuity, model, params, paged=paged)
    if arch == "qwen3-8b":
        timed("spill", phase_spill, model, params, card)
        spec = timed("spec", phase_spec, model, params, card)["self_draft"]
        batch = timed("batch", phase_batch, model, params,
                      card)["launches"]
        cell = timed("cell", phase_cell, model, params, card)
        mat = timed("materialized", phase_materialized, model, params, card,
                    cell["want"])
        cell = cell["launches"]
    elif arch == "deepseek-moe-16b":
        spec = timed("spec", phase_spec_moe, model, params,
                     card)["self_draft"]
    elif arch == "whisper-medium":
        timed("cross_spill", phase_cross_spill, model, params, card)
    log({"phase_seconds": seconds, "arch": arch})
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    # each kernel's counts come from the path that runs it: the dense
    # decode from the dense serve, every other kernel from the paged one
    return {"paged": (serve["launches"], per_call["decode_step"],
                      per_call["prefill_chunk"]),
            "dense": dense and (dense["launches"],
                                dense["launches_per_call"]["decode_step"],
                                dense["launches_per_call"]["prefill"]),
            "spec": spec, "batch": batch, "cell": cell, "materialized": mat,
            "routes": {"paged": serve["route_launches"],
                       "dense": dense and dense["route_launches"]}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here, before any output,
    # when the script stands without the rest of the repo)
    if sys.argv[1:] == ["--flash-bwd-parts"]:
        return _print_flash_bwd_parts()

    # f32 products and convolutions in full f32 (the plain versions' SSM
    # einsums are f32): both defaults stated, not left to the install
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = phase_device()
    phase_build()
    t0 = time.perf_counter()
    checks = phase_kernels()
    t1 = time.perf_counter()
    for arch in CLI_ARCHS:
        phase_cli(arch)
    log({"phase_seconds": {"kernels": round(t1 - t0, 3),
                           "cli": round(time.perf_counter() - t1, 3)}})

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
            **{k: row[k] for k in ("bound_f32_ms", "one_row_ms",
                                   "grad_tile_share", "dw_rel", "parts_ms",
                                   "executed_flop_per_pair", "f32_grad_rel",
                                   "device_ops", "d_logits_rel", "dx_rel",
                                   "d_router_rel", "route_grad_ms",
                                   "plain_route_grad_ms", "kernel_dx_rel",
                                   "kernel_d_router_rel", "device_ms",
                                   "launches_per_call", "dx_excess",
                                   "parent_device_ms",
                                   "parent_launches_per_call")
               if k in row}})

    for arch, rows in SUMMARY_ROW.items():
        ran = run_model(arch, device["smi"])
        for name, (check, i) in rows.items():
            path = "dense" if name == "decode_attention" else "paged"
            serve, per_step, per_prefill = ran[path]
            row_of(name, check, i, arch, path, serve[name],
                   launches_per_decode_step=per_step[name],
                   launches_per_prefill=per_prefill[name])
        spec = ran["spec"]
        spec_rows = SPEC_SUMMARY_ROW if arch == "qwen3-8b" \
            else MOE_SPEC_SUMMARY_ROW
        for name, (check, i) in (spec_rows.items() if spec else ()):
            row_of(name, check, i, arch, "spec", spec["launches"][name],
                   launches_per_spec_round=spec["launches_per_spec_round"][
                       name],
                   launches_per_verify=spec["launches_per_verify"][name])
        for name, (check, i) in (BATCH_SUMMARY_ROW.items()
                                 if ran["batch"] else ()):
            row_of(name, check, i, arch, "batch", ran["batch"][name])
        for name, (check, i) in (CELL_SUMMARY_ROW.items()
                                 if ran["cell"] else ()):
            row_of(name, check, i, arch, "cell", ran["cell"][name])
        if ran["materialized"]:
            # the (1, 1) mesh runs the cell's shapes; the (2, 2) grid's
            # rank-local ones are printed by their own kernel_check lines
            checks.update(ran["materialized"]["checks"])
            for name, (check, i) in CELL_SUMMARY_ROW.items():
                row_of(name, check, i, arch, "materialized",
                       ran["materialized"]["launches"][name])
        for name, (check, i), path, key in ROUTE_ROWS.get(arch, ()):
            routes = ran["routes"]["dense" if path.startswith("dense")
                                   else "paged"]
            row_of(name, check, i, arch, path, routes[key])
    t2 = time.perf_counter()
    train = phase_train(device["smi"])
    checks.update(train["checks"])
    for name, check, i, arch, whose in TRAIN_ROWS:
        per_step = train[whose].get("launches_per_step", {}).get(name)
        row_of(name, check, i, arch, TRAIN_PATH_NAME[arch],
               train[whose]["launches"][name],
               **({} if per_step is None else
                  {"launches_per_step": per_step}))
    log({"phase_seconds": {"train": round(time.perf_counter() - t2, 3)}})
    phase_examples()
    phase_roofline(device["smi"])
    log({"kernels": kernels})
    log(device["smi"])
    log({"ok": True, "device": {"platform": device["platform"],
                                "kind": device["kind"],
                                "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
