"""Time edited copies of the two SSM backward kernels on one H100.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/ssm_bwd_variants.py

Each variant is this checkout's ``csrc/selective_scan_bwd.cu`` or
``csrc/ssd_bwd.cu`` with a few lines replaced (``SCAN`` and ``SSD`` below
name them; a variant whose lines are missing is refused), built by
``tools/cu_variant.py`` and called
through the wrapper (its C entry swapped for the variant's) at
``chip_smoke.py``'s training shapes: the scan at falcon-mamba-7b's (B 2, S
2048, Di 8192, N 16), the SSD at zamba2-1.2b's (B 2, S 2048, 64 heads of
64, N 64, chunk 256). Prints the card's name and power limit, each
variant's ptxas registers and spills, then one JSON line a variant: the
median ms of a call (``chip_smoke._time_ms``, L2 flushed) in two rounds,
and the device microseconds of each launch (``chip_smoke._kernels_us``).
The variants leave a part out to show what it costs; they compute wrong
results on purpose and none is checked.
"""

import ctypes
import json
import sys
from pathlib import Path

import cu_variant

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# the state loop's two barriers of the scan backward
ROWS_WRITTEN = "                __syncthreads();  // every channel's rows are written\n"
ROWS_READ = "                __syncthreads();  // the rows are read\n"
SUM_PASS = ROWS_WRITTEN + "                {\n"
TERM_STORES = (
    "                        *reinterpret_cast<float4*>(rb + lo(q)) = "
    "make_float4(tb[0], tb[1], tb[2], tb[3]);\n"
    "                        *reinterpret_cast<float4*>(rc + lo(q)) = "
    "make_float4(tc[0], tc[1], tc[2], tc[3]);\n")
SCAN = {
    "as built": [],
    # the channel sums of dB and dC left out (their rows still stored)
    "no channel sums": [(SUM_PASS, ROWS_WRITTEN + "                if (false) {\n")],
    # no barrier in the state loop (the sums race)
    "no state-loop barriers": [(ROWS_WRITTEN, ""), (ROWS_READ, "")],
    # no dB, dC terms stored, no sums, no barriers: the recurrences alone
    "recurrences only": [
        (SUM_PASS, "                if (false) {\n"), (ROWS_READ, ""),
        (TERM_STORES,
         "                        dAl[s] += tb[0] + tb[1] + tb[2] + tb[3]"
         " + tc[0] + tc[1] + tc[2] + tc[3];\n")],
    # B and C not read in the state loop (a register in their place): what
    # their four shared-memory reads a step and state cost
    "no B, C reads": [(f"const float4 {v} = *reinterpret_cast<const float4*>("
                       f"{t} + {n} * NS + 64 * q + 4 * g);",
                       f"const float4 {v} = make_float4(ar[s], ar[s], "
                       f"ar[s], ar[s]);")
                      for v, t, n in (("v", "BT", "n"), ("v", "CTs", "(n0 + s)"),
                                      ("bv4", "BT", "(n0 + s)"),
                                      ("cv4", "CTs", "(n0 + s)"))],
}
DC_PHASE = ("                if (32 * hf < N) {\n"
            "                    float* pc = pC")
XB = ("                        for (int dp = 0; dp < MAXW / 16; ++dp) {\n"
      "                            uint32_t f[4];\n"
      "                            if (16 * dp < P) {\n"
      "                                ldsm_x4_trans(f, ys + ro + 16 * dp);")
STATE = ("            // D dy, and x_j . v), half 1 s = x_j dHn (dB += w s)\n"
         "            {\n")
GM = ("                    for (int kk = 0; kk < MAXW / 16; ++kk) {\n"
      "#pragma unroll\n"
      "                        for (int nb = 0; nb < 4; ++nb) {\n"
      "                            const int o = (ic + 8 * nb + g)")
SSD = {
    "as built": [],
    # no dC_I += dG B_J, no carried state's read, no dC partial
    "no dC phase": [(DC_PHASE, DC_PHASE.replace("32 * hf < N", "false"))],
    # no dx_J += M^T dy_I, dB_J += dG^T C_I in a pair
    "no dx, dB products": [(XB, XB.replace("dp < MAXW / 16", "dp < 0"))],
    # no exiting state's terms at a key tile's start
    "no exiting-state terms": [(STATE, STATE.replace("{", "if (false) {"))],
    # no G^T, dM^T products (their accumulators left zero)
    "no G, dM products": [(GM, GM.replace("kk < MAXW / 16", "kk < 0"))],
    # all four left out: staging, the elementwise work, the sums
    "no products": [
        (DC_PHASE, DC_PHASE.replace("32 * hf < N", "false")),
        (XB, XB.replace("dp < MAXW / 16", "dp < 0")),
        (STATE, STATE.replace("{", "if (false) {")),
        (GM, GM.replace("kk < MAXW / 16", "kk < 0"))],
}


def main() -> int:
    import chip_smoke as cs
    import torch

    from repro_torch.kernels import _build, selective_scan as sk, ssd as dk

    jobs = {}
    for table, file, entry in ((SCAN, "selective_scan_bwd.cu",
                                "selective_scan_bwd_bf16"),
                               (SSD, "ssd_bwd.cu", "ssd_bwd_bf16")):
        src = (_build.CSRC / file).read_text()
        for name, edits in table.items():
            key = ("scan " if table is SCAN else "ssd ") + name
            jobs[key] = (entry, cu_variant.Build(
                key, cu_variant.edited(src, edits)))
    fns = {}
    for key, (entry, job) in jobs.items():
        lib, usage = job.wait()
        print(key, "|", " | ".join(usage[-4:]), flush=True)
        fn = getattr(lib, entry)
        mod = sk if key.startswith("scan") else dk
        fn.argtypes = mod._BWD_ARGTYPES
        fn.restype = ctypes.c_int
        fns[key] = (mod, fn)

    cs.phase_device()
    gen = torch.Generator(device="cuda").manual_seed(27)
    sargs = cs._scan_case(gen, 2048, 0.1, B=2, Di=8192, N=16)
    sdy = torch.randn(2, 2048, 8192, generator=gen, device="cuda").bfloat16()
    states = sk.selective_scan(*sargs, save_states=True)[2]
    dargs = cs._ssd_case(gen, 2048, 0.1, B=2, Hs=64, P=64, N=64)
    ddy = torch.randn(2, 2048, 64, 64, generator=gen,
                      device="cuda").bfloat16()
    scratch = dk._forward(*dargs, 256)[2]
    calls = {sk: lambda: sk.selective_scan_bwd(*sargs[:6], states, sdy),
             dk: lambda: dk.ssd_bwd(*dargs[:6], scratch, ddy, chunk=256)}
    res = {}
    for rnd in range(2):
        for key, (mod, fn) in fns.items():
            orig = mod._bwd_lib
            mod._bwd_lib = lambda fn=fn: fn
            try:
                ms = cs._time_ms(calls[mod], flush=True)
                if rnd == 0:
                    res[key] = {"ms": [ms],
                                "launches_us": cs._kernels_us(calls[mod], n=5)}
                else:
                    res[key]["ms"].append(ms)
            finally:
                mod._bwd_lib = orig
    for key, row in res.items():
        print(json.dumps({key: row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
