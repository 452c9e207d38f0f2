"""Time the flash backward against variants of its own design on one H100.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/flash_bwd_variants.py

Each variant is a text edit of this checkout's ``flash_attention_bwd.cu``,
built beside it under ``build/flash_bwd_variants/<name>/`` with the same
flags (``tools/flash_bwd_phases.py``'s ``build_lib``) and called through its
C entry on ``chip_smoke.py``'s two training shapes. The variants:

- ``exp2f``: the exponentials through ``exp2f`` (its subnormal path) in
  place of ``ex2.approx.ftz``;
- ``dq_undeferred``: the dQ kernel's step waits for its own dQ product
  before the next step, as the dK/dV kernel's does, in place of running
  it under the next step's S, dP and exponentials;
- ``dkdv_fixed_operands``: dV's and dK's products read their A operand
  from shared memory (the warpgroup's own K and V tiles) in place of P^T
  and dS^T from registers. Its gradients are wrong: it times the step
  without the products' dependence on the step's exponentials.

Prints the card's name and power limit, then one JSON line a shape: each
version's median time (L2 flushed, ``chip_smoke._time_ms``), each launch's
time (``chip_smoke._parts_ms``), the largest per-tile share of each
gradient against the checkout's kernel, and whether the bits are the
kernel's; the checkout's own version is timed first and last. The edits fit
the current kernel only; the tool refuses a source where one is missing.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

DQ_DEFERRED = (
    "    // dS in bf16, the A operand of dQ's product: two sets, a step's and",
    "    const size_t q_row = (size_t)H * D;\n")
DQ_UNDEFERRED = r'''    mbar_wait(own_full, 0);
    for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        const int kt0 = it * STEP;
        const bf16* kt = ks + s * T;
        const bool edge = kt0 + STEP > Sk || qw0 + OWN > Sq
                          || (causal && kt0 + STEP - 1 > q_offset + qw0);
        mbar_wait(&full[s], (it / STAGES) & 1);
        float sc[STEP / 2], dp[STEP / 2];
        product_ss<D>(sc, qt, kt);
        product_ss<D>(dp, dot, vs + s * T);
        wgmma_wait<0>();
        fence_regs<STEP / 2>(sc);
        fence_regs<STEP / 2>(dp);
        uint32_t sa[STEP / 16][4];
#pragma unroll
        for (int j = 0; j < STEP / 8; ++j) {
            float d[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int hlf = e >> 1;
                float x = ex2(sc[4 * j + e] * scale_log2 - lse2[hlf]);
                if (edge) {
                    const int query = row0 + hlf * 8;
                    const int key = kt0 + 8 * j + cq + (e & 1);
                    if (key >= Sk || query >= Sq
                        || (causal && key > q_offset + query))
                        x = 0.f;
                }
                d[e] = x * (dp[4 * j + e] - del[hlf]);
            }
            put_a(sa, j, 0, d[0], d[1]);
            put_a(sa, j, 1, d[2], d[3]);
        }
        fence_regs<D / 2>(dqa);
        fence_regs<STEP / 4>(&sa[0][0]);
        wgmma_fence();
        product_rs<D>(dqa, sa, kt);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<D / 2>(dqa);
        fence_regs<STEP / 4>(&sa[0][0]);
        mbar_arrive(&empty[s]);
    }

'''
SS_T = r'''
// D(64 x N) += A(64 x 16, shared, K-major) * B(16 x N, shared, MN-major)
template <int D>
__device__ __forceinline__ void product_fixed(float* d, const bf16* a,
                                              const bf16* b) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = kmajor(a, kk), db = mnmajor(b, kk);
        if constexpr (D == 128)
            asm volatile(
                "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
                "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
                : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
                : "l"(da), "l"(db), "r"(1));
        else
            asm volatile(
                "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
                : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
                : "l"(da), "l"(db), "r"(1));
    }
}

'''


def variants(src: str) -> dict:
    """The checkout's source and each variant's text."""
    def edit(text, old, new):
        if text.count(old) < 1:
            raise SystemExit(f"variant edit does not fit: {old[:60]!r}")
        return text.replace(old, new)

    a = src.index(DQ_DEFERRED[0])
    b = src.index(DQ_DEFERRED[1])
    kv_mark = "// dK, dV (the second launch): a block per"
    fixed = edit(src, kv_mark, SS_T + kv_mark)
    fixed = edit(fixed, "        product_rs<D>(dva, pa, dot);\n"
                 "        product_rs<D>(dka, sa, qt);\n",
                 "        product_fixed<D>(dva, kt, dot);\n"
                 "        product_fixed<D>(dka, vt, qt);\n")
    return {"this": src,
            "exp2f": edit(edit(src, "ex2(st[", "exp2f(st["),
                          "ex2(pr[", "exp2f(pr["),
            "dq_undeferred": src[:a] + DQ_UNDEFERRED + src[b:],
            "dkdv_fixed_operands": fixed}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from flash_bwd_phases import SHAPES, build_lib, case
    from repro_torch.kernels import _build

    texts = variants((_build.CSRC / "flash_attention_bwd.cu").read_text())
    libs = {n: build_lib(t, f"flash_bwd_variants/{n}")
            for n, t in texts.items()}
    cs.phase_device()
    gen = torch.Generator(device="cuda").manual_seed(24)
    for shape, (B, S, H, K, D) in SHAPES.items():
        run, kernel = case(gen, B, S, H, K, D)
        want = [t.clone() for t in kernel()]
        out = {"shape": shape}
        for name in [*libs, "this"]:
            got = run(libs[name])
            row = {"ms": cs._time_ms(lambda: run(libs[name]), flush=True),
                   "parts_ms": cs._parts_ms(lambda: run(libs[name]),
                                            cs.FLASH_BWD_PARTS),
                   "bits_as_the_kernel": all(
                       torch.equal(a, w) for a, w in zip(got, want)),
                   "tile_share": {g: cs._tile_share(a, w) for g, a, w in
                                  zip(("dq", "dk", "dv"), got, want)}}
            out[name if name not in out else name + "_again"] = row
        cs.log(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
