"""Time one checkout's MoE router and RMSNorm backward on one H100.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/compare_route_norm_bwd.py SRC

``SRC`` is a ``src`` directory whose ``repro_torch`` is imported: this
checkout's ``src``, or another commit's unpacked under ``build/``
(``git archive <commit> src | tar -x -C build/parent``). Prints the card's
name and power limit, then one JSON line: the seconds to build the two
sources, the empty kernel's time (the floor under any launch, timed the
same way), and on ``chip_smoke.py``'s inputs

- ``moe_route`` at deepseek-moe-16b's (2048, 64, 6) and
  granite-moe-1b-a400m's (1024, 32, 8) and 8, 40 and 256 tokens;
- ``rmsnorm_bwd`` at the three training shapes: smollm-360m's block norm
  (16,384, 960), qwen3-8b's qk-norm rows (131,072, 128) and its block norm
  (4,096, 4,096), bf16 with an f32 w;

each call's median device time (``chip_smoke._time_ms``, L2 warm), its
bound, its ratio to the empty kernel, and the device operations one call
makes with each one's microseconds (one profiler trace of 20 calls). Run in
turns in one call (other, this, this, other), it compares two versions of
the kernels on one card.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ROUTERS = {"deepseek-moe-16b": (2048, 64, 6),
           "granite-moe-1b-a400m": (1024, 32, 8)}
NORM_SHAPES = {"smollm-360m block": (16384, 960),
               "qwen3-8b qk": (131072, 128),
               "qwen3-8b block": (4096, 4096)}


def route_rows(cs, gen, empty_ms: float, cost) -> dict:
    import torch

    from repro_torch.kernels import moe_route as rk

    out = {}
    for arch, (d, E, k) in ROUTERS.items():
        x = torch.randn(256, d, generator=gen, device="cuda").bfloat16()
        router = torch.randn(d, E, generator=gen, device="cuda") * 1e-4
        for T in (8, 40, 256):
            xt = x[:T]
            ms = cs._time_ms(lambda: rk.moe_route(xt, router, k))
            out[f"{arch} T {T}"] = {
                "ms": ms, "x_empty": ms / empty_ms,
                "device_ops": cs._kernels_us(
                    lambda: rk.moe_route(xt, router, k)),
                **cs.bound(cost(T, d, E, k))}
    return out


def norm_rows(cs, gen, cost) -> dict:
    from repro_torch.kernels import rmsnorm as rk

    out = {}
    for what, shape in NORM_SHAPES.items():
        x, w = cs._rmsnorm_case(gen, shape)
        g = cs._rmsnorm_case(gen, shape)[0]
        out[what] = {"ms": cs._time_ms(lambda: rk.rmsnorm_bwd(x, w, g)),
                     "device_ops": cs._kernels_us(
                         lambda: rk.rmsnorm_bwd(x, w, g)),
                     **cs.bound(cost(x.numel() // shape[-1], shape[-1],
                                     x.element_size(), w.element_size()))}
        out[what]["x_bound"] = out[what]["ms"] / out[what]["bound_ms"]
    return out


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__ if len(sys.argv) != 2 else "no CUDA device",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    # the bounds: this checkout's costs, whatever SRC holds
    from repro_torch.kernels.moe_route import cost as route_cost
    from repro_torch.kernels.rmsnorm import bwd_cost as norm_cost

    # chip_smoke put this checkout's src first and imported from it: drop
    # what it imported, so that the package under SRC is the one timed
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, sys.argv[1])
    import repro_torch
    from repro_torch.kernels import _build, rmsnorm as nk

    cs.phase_device()
    t0 = time.perf_counter()
    _build.build_all(("rmsnorm", "moe_route"))
    out = {"package": repro_torch.__file__,
           "build_s": time.perf_counter() - t0}
    dev = torch.device("cuda")
    out["empty_kernel_ms"] = cs._time_ms(lambda: nk.empty_launch(dev))
    gen = torch.Generator(device="cuda").manual_seed(26)
    out["moe_route"] = route_rows(cs, gen, out["empty_kernel_ms"],
                                  route_cost)
    out["rmsnorm_bwd"] = norm_rows(cs, gen, norm_cost)
    cs.log(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
