"""A %globaltimer timeline of the selective-scan kernel on one H100.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/scan_timeline.py [CU] [--S 256]

``CU`` is ``src/repro_torch/csrc/selective_scan.cu`` unless given (e.g. an
edited copy of it under ``build/``). The tool inserts probes at fixed
points of a copy of the kernel (its entry; after its prologue; per 256-step
tile after staging, after the scan and after y is stored; its end) where
thread 0 of each block records ``%globaltimer``, ``clock64()`` and its SM,
builds the copy and the source as it is (``tools/cu_variant.py``) and runs
them once at falcon-mamba-7b's prefill chunk (B 1, Di 8192, N 16, S 256
from a nonzero state; ``--S`` for another length) on the inputs
``chip_smoke.py`` draws (``_scan_case``). It prints the card's name and
power limit, then one JSON line: the kernel's span, each phase's mean per
block in ns and SM cycles, blocks per SM and how many ran at once, and the
instrumented and plain kernel's times by CUDA events. It refuses a source
in which a probe point is missing. The probes cost one thread's few
instructions at each point.
"""

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

import cu_variant

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

MAX_BLOCKS = 4096
MAX_TILES = 40
SLOTS = 3 + 3 * MAX_TILES  # entry, start, 3 per tile, end

PROBES = r"""
#define TL_BLOCKS %d
#define TL_SLOTS %d
__device__ unsigned long long tl_ns[TL_BLOCKS * TL_SLOTS];
__device__ long long tl_clk[TL_BLOCKS * TL_SLOTS];
__device__ unsigned tl_sm[TL_BLOCKS];
__device__ __forceinline__ void tl_probe(int slot) {
    if (threadIdx.x != 0) return;
    const unsigned bid = blockIdx.y * gridDim.x + blockIdx.x;
    if (bid >= TL_BLOCKS || slot >= TL_SLOTS) return;
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    tl_ns[bid * TL_SLOTS + slot] = t;
    tl_clk[bid * TL_SLOTS + slot] = clock64();
    if (slot == 0) {
        unsigned sm;
        asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(sm));
        tl_sm[bid] = sm;
    }
}
extern "C" int tl_read(void* ns, void* clk, void* sm) {
    cudaMemcpyFromSymbol(ns, tl_ns, sizeof(tl_ns));
    cudaMemcpyFromSymbol(clk, tl_clk, sizeof(tl_clk));
    cudaMemcpyFromSymbol(sm, tl_sm, sizeof(tl_sm));
    return (int)cudaGetLastError();
}
extern "C" int tl_clear() {
    static unsigned long long z[TL_BLOCKS * TL_SLOTS];
    static unsigned zs[TL_BLOCKS];
    cudaMemcpyToSymbol(tl_ns, z, sizeof(z));
    cudaMemcpyToSymbol(tl_clk, z, sizeof(z));
    cudaMemcpyToSymbol(tl_sm, zs, sizeof(zs));
    return (int)cudaGetLastError();
}
""" % (MAX_BLOCKS, SLOTS)

# Each anchor occurs once in the kernel; it is replaced by the same text
# with thread 0's probe at its slot: 0 entry, 1 after the prologue, per
# tile k 2 + 3k staged, 3 + 3k scanned, 4 + 3k y stored; the last slot at
# the end.
PROBE_POINTS = [
    ("    int S, int Di) {\n", "    int S, int Di) {\n    tl_probe(0);\n"),
    ("Ds[c] = c0 + c < Di ? D[c0 + c] : 0.f;\n",
     "Ds[c] = c0 + c < Di ? D[c0 + c] : 0.f;\n    tl_probe(1);\n"),
    ("        __syncthreads();\n        if (VEC && k + 1 < ntiles)\n",
     "        __syncthreads();\n        tl_probe(2 + 3 * k);\n"
     "        if (VEC && k + 1 < ntiles)\n"),
    ("        __syncthreads();\n\n        // ---- y out",
     "        __syncthreads();\n        tl_probe(3 + 3 * k);\n\n"
     "        // ---- y out"),
    ("    }\n    __syncthreads();\n    for (int i = tid; i < CT * N;",
     "        tl_probe(4 + 3 * k);\n    }\n    __syncthreads();\n"
     "    for (int i = tid; i < CT * N;"),
    ("        if (c0 + i / N < Di) hT[((size_t)b * Di + c0) * N + i] = "
     "hs[i];\n",
     "        if (c0 + i / N < Di) hT[((size_t)b * Di + c0) * N + i] = "
     "hs[i];\n    tl_probe(TL_SLOTS - 1);\n"),
]


def instrument(src: str) -> str:
    """The probed copy of ``src``; raises if a probe point is not found
    exactly once (the kernel changed under the tool)."""
    src = cu_variant.edited(src, PROBE_POINTS)
    head = src.index("#include <stdint.h>\n") + len("#include <stdint.h>\n")
    return src[:head] + PROBES + src[head:]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("cu", nargs="?",
                    default=str(ROOT / "src/repro_torch/csrc/selective_scan.cu"))
    ap.add_argument("--S", type=int, default=256)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build

    cs.phase_device()
    src = Path(args.cu).read_text()
    lib = cu_variant.variant("scan_timeline probed", instrument(src))
    plain_lib = cu_variant.variant("scan_timeline plain", src)
    lib.tl_read.argtypes = [ctypes.c_void_p] * 3
    lib.tl_read.restype = lib.tl_clear.restype = ctypes.c_int
    lib.tl_clear.argtypes = []
    for fn in (lib.selective_scan_bf16, plain_lib.selective_scan_bf16):
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

    gen = torch.Generator(device="cuda").manual_seed(0)
    x, dt, A, Bm, C, D, h0 = cs._scan_case(gen, args.S, 0.1)
    (B, S, Di), N = x.shape, A.shape[1]
    y = torch.empty_like(x)
    hT = torch.empty_like(h0)
    dev = torch.device("cuda")

    def call(fn):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 C.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
                 hT.data_ptr(), None, B, S, Di, N, 1, _build.stream(dev))
        _build.check(err, "selective_scan")

    t_probed = cs._time_ms(lambda: call(lib.selective_scan_bf16), flush=True)
    t_plain = cs._time_ms(lambda: call(plain_lib.selective_scan_bf16),
                          flush=True)
    _build.check(lib.tl_clear(), "tl_clear")
    torch.cuda.synchronize()
    scrub = torch.empty(4 * cs.L2_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    scrub.zero_()
    torch.cuda._sleep(1_000_000)
    call(lib.selective_scan_bf16)
    torch.cuda.synchronize()
    ns = np.zeros(MAX_BLOCKS * SLOTS, np.uint64)
    clk = np.zeros(MAX_BLOCKS * SLOTS, np.int64)
    sm = np.zeros(MAX_BLOCKS, np.uint32)
    _build.check(lib.tl_read(ns.ctypes.data, clk.ctypes.data, sm.ctypes.data),
                 "tl_read")
    tiles = -(-S // 256)
    n_blocks = -(-Di // 32) * B
    ns = ns.reshape(MAX_BLOCKS, SLOTS)[:n_blocks].astype(np.int64)
    clk = clk.reshape(MAX_BLOCKS, SLOTS)[:n_blocks]
    sm = sm[:n_blocks]
    t0 = int(ns[:, 0].min())
    end = ns[:, SLOTS - 1]

    def phase(a, b):
        """Mean over blocks of slot b - slot a, ns and cycles."""
        return {"ns": float((ns[:, b] - ns[:, a]).mean()),
                "cycles": float((clk[:, b] - clk[:, a]).mean())}

    out = {"source": args.cu,
           "shape": {"B": B, "S": S, "Di": Di, "N": N, "h0": 0.1},
           "blocks": n_blocks, "tiles": tiles,
           "ms_probed": t_probed, "ms": t_plain,
           "span_ns": int(end.max() - t0),
           "block_ns_mean": float((end - ns[:, 0]).mean()),
           "entry_ns": {"first": 0, "median": float(np.median(ns[:, 0] - t0)),
                        "last": int(ns[:, 0].max() - t0)},
           "end_ns": {"first": int(end.min() - t0),
                      "median": float(np.median(end - t0)),
                      "last": int(end.max() - t0)},
           "prologue": phase(0, 1), "tiles_detail": []}
    prev = 1
    sums = {"stage": 0.0, "scan": 0.0, "store": 0.0}
    for k in range(tiles):
        s, c, w = 2 + 3 * k, 3 + 3 * k, 4 + 3 * k
        row = {"stage": phase(prev, s), "scan": phase(s, c),
               "store": phase(c, w)}
        for key in sums:
            sums[key] += row[key]["ns"]
        out["tiles_detail"].append(row)
        prev = w
    out["epilogue"] = phase(prev, SLOTS - 1)
    out["phase_ns_sum"] = sums
    per_sm: dict[int, list] = {}
    for i in range(n_blocks):
        per_sm.setdefault(int(sm[i]), []).append((int(ns[i, 0]), int(end[i])))
    conc = []
    for iv in per_sm.values():
        pts = sorted([(a, 1) for a, _ in iv] + [(b, -1) for _, b in iv],
                     key=lambda p: (p[0], p[1]))
        cur = best = 0
        for _, d in pts:
            cur += d
            best = max(best, cur)
        conc.append(best)
    out["sms_used"] = len(per_sm)
    out["blocks_per_sm"] = {"max": max(map(len, per_sm.values())),
                            "median": statistics.median(
                                map(len, per_sm.values()))}
    out["resident_blocks_per_sm_max"] = {"max": max(conc),
                                         "median": statistics.median(conc)}
    if len(out["tiles_detail"]) > 8:
        out["tiles_detail"] = out["tiles_detail"][:2] + out["tiles_detail"][-1:]
    cs.log(json.loads(json.dumps(out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
