"""Time one checkout's ``rmsnorm``, ``ssd`` and ``selective_scan`` wrappers on
one H100.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/compare_rmsnorm_ssd.py SRC

``SRC`` is a ``src`` directory whose ``repro_torch`` is imported: this
checkout's ``src``, or another commit's unpacked under ``build/``
(``git archive <commit> src | tar -x -C build/parent``). Prints the card's
name and power limit, then one JSON line: the seconds to build the
package's kernels, the host microseconds per call of the two wrappers (a
host clock over many enqueues, then one synchronise), and the device time
of each at ``chip_smoke.py``'s RMSNorm shapes, at zamba2-1.2b's SSD chunk
and 2048-step prefill, and at falcon-mamba-7b's scan chunk (from a nonzero
state) and 2048-step prefill, on the inputs ``chip_smoke.py`` draws from the
same seed and with its timing method. Run in turns in one call (other,
this, this, other), it compares two versions of the kernels on one card.
Times only: the checks are ``chip_smoke.py``'s.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__ if len(sys.argv) != 2 else "no CUDA device",
              file=sys.stderr)
        return 1
    import chip_smoke as cs

    sys.path.insert(0, sys.argv[1])  # ahead of this checkout's src
    import repro_torch
    from repro_torch.kernels import _build, rmsnorm as rk, ssd as dk
    from repro_torch.kernels import selective_scan as sk

    cs.phase_device()
    t0 = time.perf_counter()
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, w = cs._rmsnorm_case(gen, (cs.N_SLOTS, 4096))
    rk.rmsnorm(x, w, 1e-6)  # the first call compiles what is compiled late
    torch.cuda.synchronize()
    out = {"package": repro_torch.__file__,
           "build_s": time.perf_counter() - t0,
           "host_per_launch": cs._wrapper_host_us(
               x, w, cs._ssd_case(gen, cs.CHUNK, 0.1)),
           "rmsnorm": [], "ssd": [], "selective_scan": []}
    for shape in cs.RMSNORM_SHAPES:
        x, w = cs._rmsnorm_case(gen, shape)
        out["rmsnorm"].append({"shape": list(shape), "ms": cs._time_ms(
            lambda: rk.rmsnorm(x, w, 1e-6))})
    for S, h0_scale in ((cs.CHUNK, 0.1), (cs.MAX_SEQ, 0.0)):
        args = cs._ssd_case(gen, S, h0_scale)
        out["ssd"].append({"S": S, "h0": h0_scale, "ms": cs._time_ms(
            lambda: dk.ssd(*args, chunk=cs.CHUNK), flush=True)})
    for S, h0_scale in ((cs.CHUNK, 0.1), (cs.MAX_SEQ, 0.0)):
        args = cs._scan_case(gen, S, h0_scale)
        out["selective_scan"].append({"S": S, "h0": h0_scale, "ms": cs._time_ms(
            lambda: sk.selective_scan(*args), flush=True)})
    cs.log(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
