"""Time ``gemm_rows`` against variants of its own design on one H100.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/gemm_rows_variants.py

Prints the card's name and power limit, then one JSON line a product of
full-width qwen3-8b's decode step at 8 and 40 rows: cuBLAS's time, the
kernel's under its plan, and its time under each variant, on the inputs and
with the timing method of ``chip_smoke.py`` (L2 flushed). The variants:

- ``no_evict_first``: the plan with w's loads not marked evict-first;
- ``tile_64`` / ``tile_128``: the plan's cut at 64- or 128-column tiles
  (the same rule for the segments: at least one item an SM);
- ``one_item_a_tile``: no split of K (fewer items than SMs where the tiles
  are fewer).

Each variant is checked against the plain product (bf16 atol = rtol =
2e-2) and for row invariance (8 rows against 40) before it is timed; a
variant that fails is reported, not timed. Times only a variant's plan,
never its source: the kernel is the checkout's.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.kernels import _build, gemm_rows as gk

    cs.phase_device()
    _build.build_all(("gemm_rows",))
    n_sm = gk._n_sm(torch.cuda.current_device())
    real = gk.plan
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, K, N, nk in gk.decode_products(get("qwen3-8b")):
        if name in ("v", "o", "up"):  # the same shapes as k, q and gate
            continue
        p = real(K, N, nk, n_sm)
        variants = {
            "plan": p,
            "no_evict_first": p._replace(evict_first=False),
            "tile_64": gk._cut(K, N, n_sm, 64),
            "tile_128": gk._cut(K, N, n_sm, 128),
            "one_item_a_tile": p._replace(
                s_base=1, extra=0, grid=min(n_sm, p.n_tiles),
                evict_first=p.n_tiles <= n_sm),
        }
        w = (torch.randn(K, N, generator=gen, device="cuda")
             * K ** -0.5).bfloat16()
        for M in (cs.N_SLOTS, cs.N_SLOTS * 5):
            x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
            row = {"product": name, "K": K, "N": N, "M": M,
                   "cublas_ms": cs._time_ms(lambda: torch.matmul(x, w),
                                            flush=True)}
            want = x.float() @ w.float()
            for label, vp in variants.items():
                gk.plan = lambda *a, vp=vp: vp
                gk.forget()
                try:
                    got = gk.gemm_rows(x, w)
                    ok = bool(((got.float() - want).abs()
                               <= 2e-2 + 2e-2 * want.abs()).all())
                    ok = ok and torch.equal(gk.gemm_rows(x[:8], w), got[:8])
                    row[label] = (cs._time_ms(lambda: gk.gemm_rows(x, w),
                                              flush=True) if ok else "wrong")
                except RuntimeError as e:
                    row[label] = f"refused: {e}"
                row[label + "_cut"] = [vp.bn, vp.s_base, vp.extra, vp.items]
            gk.plan = real
            gk.forget()
            print(json.dumps(row), flush=True)
        del w
    return 0


if __name__ == "__main__":
    sys.exit(main())
