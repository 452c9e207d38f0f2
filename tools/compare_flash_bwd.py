"""Time one checkout's flash attention backward on one H100.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/compare_flash_bwd.py SRC

``SRC`` is a ``src`` directory whose ``repro_torch`` is imported: this
checkout's ``src``, or another commit's unpacked under ``build/``
(``git archive <commit> src | tar -x -C build/parent``). Prints the card's
name and power limit, then one JSON line: the seconds to build the
package's flash kernels and, at ``chip_smoke.py``'s two training shapes
(smollm-360m: B 8, S 2048, H 15 / K 5, D 64; qwen3-8b: B 2, S 2048, H 32 /
K 8, D 128; causal), the backward's median device time with a cold L2
(``chip_smoke._time_ms``), each launch's device time from one profiler
trace (``parts_ms``), SDPA's backward on the same inputs, the bound, and
each gradient's largest per-tile share against plain autograd. Run in turns
in one call (other, this, this, other), it compares two versions of the
kernel on one card. The gates are ``chip_smoke.py``'s.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def case(cs, gen, cost, *, B, S, H, K, D) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fk, ref

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v, dout = rnd(B, S, H, D), rnd(B, S, K, D), rnd(B, S, K, D), \
        rnd(B, S, H, D)
    out, lse = fk.flash_attention(q, k, v, causal=True, with_lse=True)

    def bwd_call():
        return fk.flash_attention_bwd(q, k, v, out, dout, lse)

    got = bwd_call()
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention(*ins, causal=True), ins, dout)
    shares = {n: cs._tile_share(a, w)
              for n, a, w in zip(("dq", "dk", "dv"), got, want)}
    del ins, want
    lib_ins = [t.detach().transpose(1, 2).clone().requires_grad_()
               for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_ins, is_causal=True,
                                             enable_gqa=True)
    row = {"shape": {"B": B, "S": S, "H": H, "K": K, "D": D},
           "grad_tile_share": shares,
           "ms": cs._time_ms(bwd_call, flush=True),
           "parts_ms": cs._parts_ms(bwd_call, cs.FLASH_BWD_PARTS),
           "library_ms": cs._grad_ms(lib_out, lib_ins, dout.transpose(1, 2)),
           **cs.bound(cost(B, S, S, H, K, D))}
    row["x_library"] = row["ms"] / row["library_ms"]
    row["x_bound"] = row["ms"] / row["bound_ms"]
    return row


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__ if len(sys.argv) != 2 else "no CUDA device",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    # the bound: this checkout's cost of the backward, whatever SRC holds
    from repro_torch.kernels.flash_attention import bwd_cost

    # chip_smoke put this checkout's src first and imported from it: drop
    # what it imported, so that the package under SRC is the one timed
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, sys.argv[1])
    import repro_torch
    from repro_torch.kernels import _build

    cs.phase_device()
    t0 = time.perf_counter()
    _build.build_all(("flash_attention", "flash_attention_bwd"))
    out = {"package": repro_torch.__file__,
           "build_s": time.perf_counter() - t0}
    gen = torch.Generator(device="cuda").manual_seed(24)
    out["smollm-360m"] = case(cs, gen, bwd_cost, **cs.TRAIN, H=15, K=5,
                              D=64)
    out["qwen3-8b"] = case(cs, gen, bwd_cost, B=cs.QWEN_TRAIN["B"],
                           S=cs.QWEN_TRAIN["S"], H=32, K=8, D=128)
    cs.log(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
