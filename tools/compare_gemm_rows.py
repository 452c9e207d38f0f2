"""Time one checkout's ``gemm_rows`` wrapper on one H100, product by product.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/compare_gemm_rows.py SRC

``SRC`` is a ``src`` directory whose ``repro_torch`` is imported: this
checkout's ``src``, or another commit's unpacked under ``build/``
(``git archive <commit> src | tar -x -C build/parent``). Prints the card's
name and power limit, then one JSON line: the seconds to build the
package's kernels, the host microseconds per call of the wrapper beside
``torch.matmul``'s (a host clock over many enqueues, then one synchronise),
and the device time of each product of full-width qwen3-8b's decode step at
8 rows (a decode step) and 40 (a k = 4 verify), beside cuBLAS's, on the
inputs ``chip_smoke.py`` draws from the same seed and with its timing
method (L2 flushed); then one step's products in all (36 layers of seven
and the unembedding). Run in turns in one call (other, this, this, other),
it compares two versions of the kernel on one card. Times only: the checks
are ``chip_smoke.py``'s.
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
    from repro_torch.configs import get
    from repro_torch.kernels import _build, gemm_rows as gk

    cs.phase_device()
    t0 = time.perf_counter()
    _build.build_all(("gemm_rows",))
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    xk = torch.randn(cs.N_SLOTS, 4096, generator=gen, device="cuda").bfloat16()
    wk = torch.randn(4096, 1024, generator=gen, device="cuda").bfloat16()
    out = {"package": repro_torch.__file__, "build_s": build_s,
           "host_per_launch": {
               "gemm_rows": cs._host_us(lambda: gk.gemm_rows(xk, wk)),
               "torch.matmul": cs._host_us(lambda: torch.matmul(xk, wk))},
           "products": [], "steps": {}}
    cfg = get("qwen3-8b")
    for M in (cs.N_SLOTS, cs.N_SLOTS * 5):
        step = {"ms": 0.0, "library_ms": 0.0}
        for name, K, N, nk in gk.decode_products(cfg):
            w = (torch.randn(K, N, generator=gen, device="cuda")
                 * K ** -0.5).bfloat16()
            x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
            row = {"M": M, "product": name, "K": K, "N": N,
                   "ms": cs._time_ms(lambda: gk.gemm_rows(x, w), flush=True),
                   "library_ms": cs._time_ms(lambda: torch.matmul(x, w),
                                             flush=True)}
            out["products"].append(row)
            times = 1 if name == "unembed" else cfg.n_layers
            for key in step:
                step[key] += times * row[key]
            del w, x
        out["steps"][M] = step
    cs.log(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
