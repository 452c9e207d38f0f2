"""Time edited copies of the MoE router and the RMSNorm backward on one H100.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/route_norm_variants.py

Each variant is this checkout's ``csrc/moe_route.cu`` or ``csrc/rmsnorm.cu``
with a few lines replaced (``ROUTE`` and ``NORM`` below name them; a
variant whose lines are missing is refused), built by
``tools/cu_variant.py`` and called through its C
entry at ``chip_smoke.py``'s shapes: the router at deepseek-moe-16b's and
granite-moe-1b-a400m's (d, E, k) and 8, 40 and 256 tokens, the backward at
the three training shapes. Prints the card's name and power limit, the
empty kernel's time, then one JSON line a variant: the median ms of a call
(``chip_smoke._time_ms``). Some variants compute wrong results on purpose
(they leave a phase out to show what it costs); none is checked. The
router's variants say where its time goes; the backward's, what its design
choices bought.
"""

import ctypes
import sys
from pathlib import Path

import cu_variant

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

ROUTERS = {"deepseek-moe-16b": (2048, 64, 6),
           "granite-moe-1b-a400m": (1024, 32, 8)}
NORM_SHAPES = {"smollm-360m block": (16384, 960),
               "qwen3-8b qk": (131072, 128),
               "qwen3-8b block": (4096, 4096)}
RANKING = "    const int lane = tid & 31, w = tid >> 5;"
SMEM = ("        ((size_t)S * TT + (size_t)J * TT * E + (size_t)C * tpb * E)\n"
        "        * sizeof(float);")
HALF = ("launch_rows<T, VEC, NR, 3, 2, 16>(x, w, wtype, g, dx, part,\n"
        "                                                rows, d, eps, chunk, "
        "16, vec,")
STAGING = """    float r[U];
    if (worker) load_rows(r, rows, i_lo, i_hi, E);

    // x's tile, columns of the slice, transposed: xs[i][t] (thread q takes
    // t = q % TT, i = q / TT: its store is word q of the tile)
    for (int q = tid; q < TT * S; q += THREADS) {
        const int t = q % TT, i = q / TT;
        float v = 0.f;
        if (t0 + t < T && i < sl)
            v = __bfloat162float(x[(size_t)(t0 + t) * d + s0 + i]);
        xs[q] = v;
    }
"""
X_FIRST = """    auto x_at = [&](int q) {
        const int t = q % TT, i = q / TT;
        return q < TT * S && t0 + t < T && i < sl
                   ? __bfloat162float(x[(size_t)(t0 + t) * d + s0 + i])
                   : 0.f;
    };
    constexpr int XR = TT / 2;
    float xv[XR];
#pragma unroll
    for (int u = 0; u < XR; ++u) xv[u] = x_at(tid + u * THREADS);
    float r[U];
    if (worker) load_rows(r, rows, i_lo, i_hi, E);
#pragma unroll
    for (int u = 0; u < XR; ++u)
        if (tid + u * THREADS < TT * S) xs[tid + u * THREADS] = xv[u];
    for (int q = tid + XR * THREADS; q < TT * S; q += THREADS) xs[q] = x_at(q);
"""
ROUTE = {
    "as built": [],
    # every block leaves after the cluster barrier: no softmax, no top-k
    "no ranking": [(RANKING, "    return;\n" + RANKING)],
    # no router row is loaded or multiplied: the partials are zeros
    "no router product": [
        ("    if (worker) load_rows(r, rows, i_lo, i_hi, E);\n", "\n"),
        ("    if (worker) {\n        for (int i0",
         "    if (false) {\n        for (int i0")],
    # a thread's first TT / 2 values of x's tile loaded into registers
    # before its router rows, stored after them
    "x's values before the router rows": [(STAGING, X_FIRST)],
    # 8 tokens a cluster at every T (twice the clusters at 256 tokens)
    "tile 8 at any T": [("if (T <= 64)", "if (T <= 1 << 30)")],
    # 120 KB of shared memory a block: one block an SM
    "one block an SM": [(SMEM, "        120 * 1024;")],
}
NORM = {
    "as built": [],
    # 2 or 6 rows ahead at d <= 256, not 3
    "2 rows ahead at d <= 256": [(HALF, HALF.replace(", 3, 2, 16>",
                                                     ", 2, 2, 16>"))],
    "6 rows ahead at d <= 256": [(HALF, HALF.replace(", 3, 2, 16>",
                                                     ", 6, 2, 16>"))],
    # two rows ahead above d 256, not one
    "2 rows ahead above 256": [("launch_rows<T, VEC, 4, 1, 2, 32>",
                                "launch_rows<T, VEC, 4, 2, 2, 32>")],
    # the sum of the partial rows launched as an ordinary kernel
    "no programmatic launch": [
        ('    asm volatile("griddepcontrol.wait;" ::: "memory");', ""),
        ("attr[0].val.programmaticStreamSerializationAllowed = 1;",
         "attr[0].val.programmaticStreamSerializationAllowed = 0;")],
    # 512 runs a call, not 256 (the wrapper's rule doubled)
    "512 runs": [],
}


def build(name: str, subs) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    src = (_build.CSRC / f"{name}.cu").read_text()
    return cu_variant.variant(name, cu_variant.edited(src, subs))


def route_row(cs, lib, gen) -> dict:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_route import plan

    fn = lib.moe_route_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    dev = torch.device("cuda")
    row = {}
    for arch, (d, E, k) in ROUTERS.items():
        x = torch.randn(256, d, generator=gen, device="cuda").bfloat16()
        router = torch.randn(d, E, generator=gen, device="cuda") * 1e-4
        p = plan(d, E)
        for T in (8, 40, 256):
            w = torch.empty(T, k, device="cuda")
            ids = torch.empty(T, k, dtype=torch.int32, device="cuda")

            def call():
                err = fn(x.data_ptr(), router.data_ptr(), w.data_ptr(),
                         ids.data_ptr(), None, T, d, E, k, p.C, p.S, p.J,
                         p.L, _build.stream(dev))
                if err:
                    raise RuntimeError(f"moe_route variant: error {err}")

            row[f"{arch} T {T}"] = cs._time_ms(call, iters=50)
    return row


def norm_row(cs, lib, gen, runs: int) -> dict:
    import torch

    from repro_torch.kernels import _build

    fn = lib.rmsnorm_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    dev = torch.device("cuda")
    row = {}
    for what, (rows, d) in NORM_SHAPES.items():
        x, w = cs._rmsnorm_case(gen, (rows, d))
        g = cs._rmsnorm_case(gen, (rows, d))[0]
        dx = torch.empty_like(x)
        dw = torch.empty(d, device="cuda")
        chunk = max(32, -(-rows // runs))
        part = torch.empty(-(-rows // chunk), d, device="cuda")

        def call():
            err = fn(x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(),
                     part.data_ptr(), dw.data_ptr(), rows, d, 1, 0, 1e-5,
                     chunk, _build.stream(dev))
            if err:
                raise RuntimeError(f"rmsnorm_bwd variant: error {err}")

        row[what] = cs._time_ms(call, iters=50)
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import rmsnorm as nk

    cs.phase_device()
    dev = torch.device("cuda")
    cs.log({"empty_kernel_ms": cs._time_ms(lambda: nk.empty_launch(dev))})
    gen = torch.Generator(device="cuda").manual_seed(26)
    for name, subs in ROUTE.items():
        cs.log({"moe_route": name,
                "ms": route_row(cs, build("moe_route", subs), gen)})
    for name, subs in NORM.items():
        runs = 512 if name == "512 runs" else 256
        cs.log({"rmsnorm_bwd": name,
                "ms": norm_row(cs, build("rmsnorm", subs), gen, runs)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
