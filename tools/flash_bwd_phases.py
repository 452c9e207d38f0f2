"""Where a consumer warpgroup of the flash backward spends its cycles, on
one H100.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/flash_bwd_phases.py [CU]

``CU`` is ``src/repro_torch/csrc/flash_attention_bwd.cu`` unless given
(e.g. an edited copy under ``build/``). The tool copies it under
``build/flash_bwd_phases/``, inserts probes at fixed points of the dK/dV
and dQ kernels' step (after the stage's wait; after S and dP are done;
after P and dS are formed; after the products are done; the comment
above ``KV_POINTS`` says where each kernel differs) where every consumer
thread adds the ``clock64()`` cycles since its last
probe to the phase that ends there, builds the copy with ``nvcc`` (``csrc/`` on the
include path) and runs it once at ``chip_smoke.py``'s two training shapes
on random inputs. Thread 0 of each warpgroup writes its sums, its step count
and ``%globaltimer`` at its start and end. It prints the card's name and
power limit, then one JSON line per shape: for each kernel the mean cycles
a step in each phase (over every warpgroup that has rows), the mean
warpgroup's span, the kernel's span and the mean number of warpgroups
running on an SM; and the instrumented call's time beside the plain one.
It refuses a source in which a probe point is missing. The probes cost a
clock read and an add at each point.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

MAX_WG = 2 * 8192  # warpgroups recorded a kernel
PHASES = ["wait_stage", "s_dp", "p_ds", "products"]
SLOTS = len(PHASES) + 3  # the phases, steps, start ns, end ns

PRELUDE = r"""
#define PH_MAX_WG %d
#define PH_SLOTS %d
__device__ long long ph_out[2][PH_MAX_WG * PH_SLOTS];
#define PH(i) { const long long _t = clock64(); ph[i] += _t - ph_t; ph_t = _t; }
__device__ __forceinline__ unsigned long long ph_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    return t;
}
__device__ __forceinline__ void ph_write(int kernel, int wg, const long long* ph,
                                         int steps, unsigned long long t0) {
    if (threadIdx.x %% 128) return;
    const int i = (blockIdx.y * gridDim.x + blockIdx.x) * 2 + wg;
    if (i >= PH_MAX_WG) return;
    long long* o = ph_out[kernel] + (size_t)i * PH_SLOTS;
    for (int p = 0; p < %d; ++p) o[p] = ph[p];
    o[%d] = steps;
    o[%d] = (long long)t0;
    o[%d] = (long long)ph_ns();
}
extern "C" int ph_read(void* out) {
    cudaMemcpyFromSymbol(out, ph_out, sizeof(ph_out));
    return (int)cudaGetLastError();
}
extern "C" int ph_clear() {
    static long long z[2 * PH_MAX_WG * PH_SLOTS];
    cudaMemcpyToSymbol(ph_out, z, sizeof(z));
    return (int)cudaGetLastError();
}
""" % (MAX_WG, SLOTS, len(PHASES), len(PHASES), len(PHASES) + 1,
       len(PHASES) + 2)

START = ("    setmaxnreg_inc<CONSUMER_REGS>();\n",
         "    setmaxnreg_inc<CONSUMER_REGS>();\n"
         "    long long ph[4] = {0, 0, 0, 0};\n"
         "    long long ph_t = clock64();\n"
         "    const unsigned long long ph_t0 = ph_ns();\n")
# (anchor, text after it), each anchor once in its kernel's part: the
# phases end after the stage's wait; after S and dP are done (dK/dV: S^T
# and dP^T; dQ: S alone, dP still running); after P and dS are formed (dQ:
# waiting for dP on the way); after the products are done (dQ: the last
# step's, which ran under this step's S, P and dS)
KV_POINTS = [
    ("        mbar_wait(&full[s], (it / STAGES) & 1);\n", "PH(0)\n"),
    ("        wgmma_wait<0>();\n        fence_regs<STEP / 2>(st);\n"
     "        fence_regs<STEP / 2>(dpt);\n", "PH(1)\n"),
    ("            put_a(sa, j, 1, d[2], d[3]);\n        }\n", "PH(2)\n"),
    ("        wgmma_commit();\n        wgmma_wait<0>();\n", "PH(3)\n"),
    ("    const size_t kv_row = (size_t)K * D;\n",
     "    ph_write(0, wg, ph, n_iter, ph_t0);\n"),
]
Q_POINTS = [
    ("        mbar_wait(&full[s], (it / STAGES) & 1);\n", "PH(0)\n"),
    ("            wgmma_wait<1>();\n        }\n        fence_regs<STEP / 2>(pr);\n",
     "PH(1)\n"),
    ("                  pr[4 * j + 3] * (dp[4 * j + 3] - del[1]));\n        }\n",
     "PH(2)\n"),
    ("            retire(sp, (it - 1) % STAGES);\n        }\n", "PH(3)\n"),
    ("    const size_t q_row = (size_t)H * D;\n",
     "    ph_write(1, wg, ph, n_iter, ph_t0);\n"),
]


# the comments that open the two kernels
KV_MARK = "// dK, dV (the second launch): a block per"
Q_MARK = "// dQ and delta (the first launch): a block per"


def instrument(text: str) -> str:
    head, rest = text.split(KV_MARK, 1)
    kv, q = rest.split(Q_MARK, 1)

    def put(part, points):
        for anchor, add in [START] + points:
            if part.count(anchor) != 1:
                raise SystemExit(f"probe point missing or repeated: "
                                 f"{anchor.strip()[:60]!r}")
            part = part.replace(anchor, anchor + add)
        return part

    return (head + PRELUDE + KV_MARK + put(kv, KV_POINTS) + Q_MARK
            + put(q, Q_POINTS))


def summary(raw, n_wg: int) -> dict:
    import numpy as np

    rows = raw[:n_wg]
    rows = rows[rows[:, len(PHASES)] > 0]  # warpgroups that ran steps
    steps = rows[:, len(PHASES)].sum()
    t0, t1 = rows[:, -2], rows[:, -1]
    span = float(t1.max() - t0.min())
    return {"warpgroups": int(len(rows)), "steps": int(steps),
            "cycles_a_step": {p: round(float(rows[:, i].sum() / steps), 1)
                              for i, p in enumerate(PHASES)},
            "mean_wg_us": round(float((t1 - t0).mean()) / 1e3, 3),
            "span_us": round(span / 1e3, 3),
            "wgs_per_sm": round(float((t1 - t0).sum()) / span / 132, 3)}


SHAPES = {"smollm-360m": (8, 2048, 15, 5, 64),  # B, S, H, K, D; causal
          "qwen3-8b": (2, 2048, 32, 8, 128)}


def build_lib(text: str, name: str) -> ctypes.CDLL:
    """``text`` (a version of ``flash_attention_bwd.cu``) built with the
    port's nvcc flags under ``build/<name>/``, loaded, its entry typed."""
    from repro_torch.kernels import _build, flash_attention as fk

    out_dir = ROOT / "build" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "flash_attention_bwd.cu"
    src.write_text(text)
    lib_path = out_dir / "libflash_bwd.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.flash_attention_bwd_bf16.argtypes = fk._BWD_ARGTYPES
    lib.flash_attention_bwd_bf16.restype = ctypes.c_int
    return lib


def case(gen, B, S, H, K, D):
    """Random inputs at a causal training shape, the forward's output and
    lse, and ``run(lib)`` that calls a built library's entry on them into
    fresh gradients (returned) -- as the wrapper would."""
    import torch

    from repro_torch.kernels import _build, flash_attention as fk

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = rnd(B, S, H, D), rnd(B, S, K, D), rnd(B, S, K, D), \
        rnd(B, S, H, D)
    o, lse = fk.flash_attention(q, k, v, causal=True, with_lse=True)
    delta = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
    grads = [torch.empty_like(t) for t in (q, k, v)]

    def run(lib):
        err = lib.flash_attention_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(g.data_ptr() for g in grads), B, S, S, H, K, D, 1, 0,
            D ** -0.5, _build.stream(q.device))
        _build.check(err, "flash_attention_bwd")
        return grads

    def kernel():
        return fk.flash_attention_bwd(q, k, v, o, do, lse)

    return run, kernel


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build

    cu = Path(sys.argv[1]) if len(sys.argv) > 1 else \
        _build.CSRC / "flash_attention_bwd.cu"
    lib = build_lib(instrument(cu.read_text()), "flash_bwd_phases")
    cs.phase_device()
    gen = torch.Generator(device="cuda").manual_seed(24)
    for name, (B, S, H, K, D) in SHAPES.items():
        run, kernel = case(gen, B, S, H, K, D)
        run(lib)
        torch.cuda.synchronize()
        lib.ph_clear()
        got = run(lib)
        torch.cuda.synchronize()
        raw = np.zeros((2, MAX_WG, SLOTS), dtype=np.int64)
        lib.ph_read(raw.ctypes.data_as(ctypes.c_void_p))
        same = all(torch.equal(a, b) for a, b in zip(got, kernel()))
        n_kv = B * K * ((S + 127) // 128) * 2
        n_q = B * H * ((S + 127) // 128) * 2
        cs.log({"shape": name, "bits_as_the_kernel": same,
                "dkdv": summary(raw[0], n_kv), "dq": summary(raw[1], n_q),
                "ms_probed": cs._time_ms(lambda: run(lib), flush=True),
                "ms_plain": cs._time_ms(kernel, flush=True)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
