"""A %globaltimer timeline of the MoE router's backward on one H100.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/route_bwd_timeline.py [CU]

``CU`` is ``src/repro_torch/csrc/moe_route_bwd.cu`` unless given (e.g. an
edited copy under ``build/``). The tool inserts probes at fixed points of a
copy of the source, where thread 0 of each block records ``%globaltimer``
and its SM: in the first launch (d_logits) its entry and end; in the
second its entry, after its prologue (R's parts in shared memory), after
its wait for the first launch, per tile after its copies landed, after it
issued the next tile's, after dx and after d_router, before its partial
of d_router is written,
when it has counted its arrival, and (the slice's last block) after the
sum over the ranks.
It builds the copy (``tools/cu_variant.py``), runs it once at
granite-moe-1b-a400m's and deepseek-moe-16b's training shapes on
``tools/route_bwd_variants.py``'s inputs, and prints the card's name and
power limit, then one JSON line a shape: the spans of both launches from
the first launch's first entry, each phase's mean per block in ns, and
how many blocks shared an SM. It refuses a source in which a probe point
is missing. The probes cost one thread's few instructions at each point.
"""

import ctypes
import json
import sys
from pathlib import Path

import cu_variant

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

MAX_A, MAX_B, TILES = 8192, 1024, 16
PER = 4                     # a tile: landed, issued, dx, end
SLOTS = 3 + PER * TILES + 3  # entry, prologue, wait; the tiles; the sums

PROBES = r"""
#define TL_A %d
#define TL_B %d
#define TL_SLOTS %d
#define PER %d
__device__ unsigned long long tl_a[TL_A * 2];
__device__ unsigned long long tl_b[TL_B * TL_SLOTS];
__device__ unsigned tl_sm[TL_B];
__device__ __forceinline__ unsigned long long tl_now() {
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    return t;
}
__device__ __forceinline__ void tl_probe_a(int slot) {
    if (threadIdx.x == 0 && blockIdx.x < TL_A)
        tl_a[blockIdx.x * 2 + slot] = tl_now();
}
__device__ __forceinline__ void tl_probe(int slot) {
    const unsigned bid = blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x != 0 || bid >= TL_B || slot >= TL_SLOTS) return;
    tl_b[bid * TL_SLOTS + slot] = tl_now();
    if (slot == 0) {
        unsigned sm;
        asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(sm));
        tl_sm[bid] = sm;
    }
}
extern "C" int tl_read(void* a, void* b, void* sm) {
    cudaMemcpyFromSymbol(a, tl_a, sizeof(tl_a));
    cudaMemcpyFromSymbol(b, tl_b, sizeof(tl_b));
    cudaMemcpyFromSymbol(sm, tl_sm, sizeof(tl_sm));
    return (int)cudaGetLastError();
}
extern "C" int tl_clear() {
    static unsigned long long za[TL_A * 2], zb[TL_B * TL_SLOTS];
    static unsigned zs[TL_B];
    cudaMemcpyToSymbol(tl_a, za, sizeof(za));
    cudaMemcpyToSymbol(tl_b, zb, sizeof(zb));
    cudaMemcpyToSymbol(tl_sm, zs, sizeof(zs));
    return (int)cudaGetLastError();
}
""" % (MAX_A, MAX_B, SLOTS, PER)

PROBE_POINTS = [
    ('    asm volatile("griddepcontrol.launch_dependents;");\n',
     '    asm volatile("griddepcontrol.launch_dependents;");\n'
     '    tl_probe_a(0);\n'),
    ("        out[2 * plane] = z;\n    }\n}\n",
     "        out[2 * plane] = z;\n    }\n    tl_probe_a(1);\n}\n"),
    ("    const int g = lane >> 2, t4 = lane & 3;\n",
     "    const int g = lane >> 2, t4 = lane & 3;\n    tl_probe(0);\n"),
    ("    __syncthreads();   // the barriers are initialised\n",
     "    __syncthreads();   // the barriers are initialised\n"
     "    tl_probe(1);\n"),
    ('    asm volatile("griddepcontrol.wait;" ::: "memory");\n',
     '    asm volatile("griddepcontrol.wait;" ::: "memory");\n'
     '    tl_probe(2);\n'),
    ("        mbar_wait(&full[st], (it >> 1) & 1);\n        __syncthreads();\n",
     "        mbar_wait(&full[st], (it >> 1) & 1);\n        __syncthreads();\n"
     "        tl_probe(3 + PER * it);\n"),
    ("            load_parts(tile + RANKS, st ^ 1);\n        }\n",
     "            load_parts(tile + RANKS, st ^ 1);\n        }\n"
     "        tl_probe(4 + PER * it);\n"),
    ("        // d_router^T += dl^T x:",
     "        tl_probe(5 + PER * it);\n        // d_router^T += dl^T x:"),
    ("        __syncthreads();   // the stage is free for the tile after next\n",
     "        __syncthreads();   // the stage is free for the tile after next\n"
     "        tl_probe(6 + PER * it);\n"),
    ("    __threadfence();\n    __syncthreads();\n    if (tid == 0)\n"
     "        last = atomicAdd",
     "    tl_probe(TL_SLOTS - 3);\n"
     "    __threadfence();\n    __syncthreads();\n    if (tid == 0)\n"
     "        last = atomicAdd"),
    ("    if (!last) return;\n",
     "    tl_probe(TL_SLOTS - 2);\n    if (!last) return;\n"),
    ("    if (tid == 0) counters[blockIdx.y] = 0u;\n}\n",
     "    if (tid == 0) counters[blockIdx.y] = 0u;\n"
     "    tl_probe(TL_SLOTS - 1);\n}\n"),
]


def instrument(src: str) -> str:
    """The probed copy of ``src``; raises if a probe point is not found
    exactly once (the kernel changed under the tool)."""
    src = cu_variant.edited(src, PROBE_POINTS)
    head = src.index("#include <stdint.h>\n") + len("#include <stdint.h>\n")
    return src[:head] + PROBES + src[head:]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.kernels import _build, _flash_decode, moe_route as rk

    cs.phase_device()
    path = Path(sys.argv[1]) if len(sys.argv) > 1 else \
        _build.CSRC / "moe_route_bwd.cu"
    lib = cu_variant.variant("route_bwd_timeline probed",
                             instrument(path.read_text()))
    fn = lib.moe_route_bwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = lib.tl_read.restype = lib.tl_clear.restype = ctypes.c_int
    lib.tl_read.argtypes = [ctypes.c_void_p] * 3
    lib.tl_clear.argtypes = []
    stream = _build.stream(torch.device("cuda"))
    for arch in ("granite-moe-1b-a400m", "deepseek-moe-16b"):
        cfg = get(arch)
        T, d, E, k = cs.MOE_TRAIN_T, cfg.d_model, cfg.n_experts, cfg.moe_top_k
        gen = torch.Generator(device="cuda").manual_seed(30)
        x, router = cs._router(gen, cfg, T)
        weights, ids, probs = rk.moe_route(x, router, k, with_probs=True)
        dw = torch.randn(T, k, generator=gen, device="cuda")
        dprobs = torch.randn(T, E, generator=gen, device="cuda")
        p = rk.grads_plan(d, E)
        parts = torch.empty(3, T, p.EP + 8, dtype=torch.bfloat16,
                            device="cuda")
        dx = torch.empty(T, d, dtype=torch.bfloat16, device="cuda")
        dr = torch.empty(d, E, device="cuda")
        part = torch.empty(p.blocks * p.S * E, device="cuda")
        cnt = _flash_decode.counters(p.slices, torch.device("cuda"))

        def call():
            _build.check(fn(x.data_ptr(), router.data_ptr(), probs.data_ptr(),
                            ids.data_ptr(), weights.data_ptr(), dw.data_ptr(),
                            dprobs.data_ptr(), None, parts.data_ptr(),
                            dx.data_ptr(), dr.data_ptr(), part.data_ptr(),
                            cnt.data_ptr(), T, d, E, k, p.CG, stream),
                         "moe_route_bwd probed")

        ms = cs._time_ms(call)
        _build.check(lib.tl_clear(), "tl_clear")
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        call()
        torch.cuda.synchronize()
        a = np.zeros(MAX_A * 2, np.uint64)
        b = np.zeros(MAX_B * SLOTS, np.uint64)
        sm = np.zeros(MAX_B, np.uint32)
        _build.check(lib.tl_read(a.ctypes.data, b.ctypes.data,
                                 sm.ctypes.data), "tl_read")
        na, nb = -(-T // 8), p.blocks
        a = a.reshape(MAX_A, 2)[:na].astype(np.int64)
        b = b.reshape(MAX_B, SLOTS)[:nb].astype(np.int64)
        t0 = int(a[:, 0].min())
        tiles = -(-T // p.TT)
        per_rank = -(-tiles // p.C)

        def mean(i, j):
            ok = (b[:, i] > 0) & (b[:, j] > 0)
            return float((b[ok, j] - b[ok, i]).mean()) if ok.any() else None

        end = np.where(b[:, SLOTS - 1] > 0, b[:, SLOTS - 1], b[:, SLOTS - 2])
        out = {"arch": arch, "plan": p._asdict(), "ms": ms,
               "a_ns": {"first_entry": 0, "last_entry": int(a[:, 0].max() - t0),
                        "last_end": int(a[:, 1].max() - t0)},
               "b_ns": {"first_entry": int(b[:, 0].min() - t0),
                        "last_entry": int(b[:, 0].max() - t0),
                        "last_wait": int(b[:, 2].max() - t0),
                        "first_end": int(end.min() - t0),
                        "last_end": int(end.max() - t0)},
               "blocks_a_sm": int(np.bincount(sm[:nb]).max()),
               "prologue": mean(0, 1), "wait": mean(1, 2),
               "tiles": [{"landed": mean(2 + PER * i, 3 + PER * i),
                          "issue": mean(3 + PER * i, 4 + PER * i),
                          "dx": mean(4 + PER * i, 5 + PER * i),
                          "d_router": mean(5 + PER * i, 6 + PER * i)}
                         for i in range(min(per_rank, TILES))],
               "to_partial": mean(2 + PER * min(per_rank, TILES), SLOTS - 3),
               "partial_written": mean(SLOTS - 3, SLOTS - 2),
               "rank_sums": mean(SLOTS - 2, SLOTS - 1)}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
