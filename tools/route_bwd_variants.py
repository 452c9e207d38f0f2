"""Time edited copies of the MoE router's backward on one H100.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/route_bwd_variants.py [NAME ...]

Each variant (or each one named) is this checkout's
``csrc/moe_route_bwd.cu`` with a few lines replaced (``VARIANTS`` below
names them; a variant whose lines are missing is refused), built by ``tools/cu_variant.py`` and called through its C
entry at granite-moe-1b-a400m's and deepseek-moe-16b's training shapes
(4096 tokens; ``chip_smoke._router``'s inputs, the forward kernel's
probabilities and picks), in four modes: both gradients, dx alone,
d_router alone, d_logits alone (null pointers for the gradients not
wanted). Prints the card's name and power limit, then one JSON line a
variant: per shape and mode the median ms of a call (``chip_smoke.
_time_ms``) and the device microseconds of each launch (``chip_smoke.
_kernels_us``), and ptxas's registers and spills. A variant may also set
the column groups a block (the C entry's ``CG``) in place of the plan's.
Some variants compute wrong results on purpose (they leave a phase out to
show what it costs); none is checked.
"""

import json
import sys
from pathlib import Path

import cu_variant

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

ARCHS = ("granite-moe-1b-a400m", "deepseek-moe-16b")
DX = "        if (dx != nullptr) {\n            for (int item = warp;"
DROUTER = "        if (drouter != nullptr) {\n            for (int ks = gw;"
NO_MMA = """#define mma16816(d, a0, a1, a2, a3, b0, b1) \\
    ((d)[0] += __uint_as_float((a0) ^ (a1) ^ (a2) ^ (a3) ^ (b0) ^ (b1)))
#define RANKS 8"""
# name: (edits, column groups a block by arch, or None for the plan's)
VARIANTS = {
    "as is": ([], None),
    # the products left out: the copies, the waits, the barriers, the sums
    # and the writes
    "loads only": ([(DX, DX.replace("dx != nullptr", "false")),
                    (DROUTER, DROUTER.replace("drouter != nullptr",
                                              "false"))], None),
    # no tile at all: the launch, the prologue (R's parts), the sums
    "no tiles": ([("tile < ntiles; tile += RANKS", "tile < 0; tile += RANKS")],
                 None),
    # the products replaced by an operation that only consumes their
    # fragments
    "no mma": ([("#define RANKS 8", NO_MMA)], None),
    "tiles of 8192 floats": ([("#define TILE_FLOATS 4096",
                               "#define TILE_FLOATS 8192")], None),
    # half the blocks, one an SM (registers not capped)
    "4 ranks, 1 block an SM": (
        [("#define RANKS 8", "#define RANKS 4"),
         ("__launch_bounds__(THREADS, 2) moe_route_grads_kernel",
          "__launch_bounds__(THREADS) moe_route_grads_kernel")], None),
}
MODES = ("both", "dx", "d_router", "d_logits")


def main() -> int:
    import ctypes

    import chip_smoke as cs
    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import _build, _flash_decode, moe_route as rk

    cs.phase_device()
    src = (_build.CSRC / "moe_route_bwd.cu").read_text()
    names = sys.argv[1:] or list(VARIANTS)
    builds = {name: cu_variant.Build(f"moe_route_bwd {name}",
                                     cu_variant.edited(src, VARIANTS[name][0]))
              for name in names}
    cases = {}
    for arch in ARCHS:
        cfg = get(arch)
        T, d, E, k = cs.MOE_TRAIN_T, cfg.d_model, cfg.n_experts, cfg.moe_top_k
        gen = torch.Generator(device="cuda").manual_seed(30)
        x, router = cs._router(gen, cfg, T)
        weights, ids, probs = rk.moe_route(x, router, k, with_probs=True)
        dw = torch.randn(T, k, generator=gen, device="cuda")
        dprobs = torch.randn(T, E, generator=gen, device="cuda")
        p = rk.grads_plan(d, E)
        cases[arch] = (
            x, router, probs, ids, weights, dw, dprobs, None,
            torch.empty(3, T, p.EP + 8, dtype=torch.bfloat16, device="cuda"),
            torch.empty(T, d, dtype=torch.bfloat16, device="cuda"),
            torch.empty(d, E, device="cuda"),
            # the partials of up to 8 ranks of blocks as small as 8
            # columns, for any CG
            torch.empty(8 * d * E, device="cuda"),
            _flash_decode.counters(d // 8, torch.device("cuda")),
            (T, d, E, k, p.CG))
    stream = _build.stream(torch.device("cuda"))
    for name, b in builds.items():
        lib, usage = b.wait()
        fn = lib.moe_route_bwd
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = {"variant": name, "ptxas": usage}
        cgs = VARIANTS[name][1]
        for arch, c in cases.items():
            ptrs = [None if t is None else t.data_ptr() for t in c[:13]]
            sizes = c[13] if cgs is None else (*c[13][:4], cgs[arch])
            for mode in MODES:
                args = list(ptrs)
                if mode in ("d_router", "d_logits"):
                    args[9] = None
                if mode in ("dx", "d_logits"):
                    args[10] = None

                def call():
                    err = fn(*args, *sizes, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                out[f"{arch} {mode}"] = {"ms": cs._time_ms(call),
                                         "device_us": cs._kernels_us(call)}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
