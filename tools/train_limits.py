"""Readings for the limits of ``chip_smoke.py``'s training checks, on one
H100.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/train_limits.py

Prints, one ``READ`` line each:

- the flash backward's per-tile shares (``chip_smoke._tile_share``) and
  its planted faults at the smoke's two training shapes (smollm-360m B 8,
  S 2048, 15 / 5 heads of 64; qwen3-8b B 2, S 2048, 32 / 8 of 128), with
  the limit raised so that the readings print whatever they are;
- the same planted faults under the former check (each gradient's largest
  difference over its largest magnitude, 1 at least), and the gradients'
  largest and median magnitudes;
- the tile shares at ``tests/test_torch_gpu.py``'s ``FLASH_BWD_CASES``;
- the first train step of smollm-360m at full width under the kernels
  against the same step under the plain versions: loss, grad norm, and
  every gradient leaf's share, layer by layer (``chip_smoke._first_step``).

Readings only: the limits are ``chip_smoke.py``'s ``GRAD_TILE_SHARE`` and
``FIRST_STEP_LEAF_SHARE`` and the gpu tests' ``FLASH_BWD_TILE_SHARE``.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT)]

import chip_smoke as c  # noqa: E402  (sets CUBLAS_WORKSPACE_CONFIG first)
import torch  # noqa: E402


def _former_share(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()
                 / max(1.0, float(want.abs().max())))


def main() -> int:
    from repro_torch.kernels import flash_attention as fk, ops, ref
    from test_torch_gpu import FLASH_BWD_CASES

    c.phase_device()  # the card's name and power limit
    # limits above every reading so far and below the planted faults'
    # (0.100 and 0.200), so the checks' own controls still hold
    c.GRAD_TILE_SHARE = 0.05
    c.FIRST_STEP_LEAF_SHARE = 0.15
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(24)
    for kw, what in ((dict(**c.TRAIN, H=15, K=5, D=64), "smollm"),
                     (dict(B=2, S=2048, H=32, K=8, D=128), "qwen3")):
        rows = c.check_flash_bwd(gen, **kw, what=what)
        print("READ", what, json.dumps({k: rows[1][k] for k in (
            "grad_tile_share", "planted_tile_share", "max_abs_err")}),
            flush=True)

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda").bfloat16()

    B, S, H, K, D = 8, 2048, 15, 5, 64
    q, k, v, do = rnd(B, S, H, D), rnd(B, S, K, D), rnd(B, S, K, D), \
        rnd(B, S, H, D)
    o, lse = fk.flash_attention(q, k, v, causal=True, with_lse=True)
    got = fk.flash_attention_bwd(q, k, v, o, do, lse)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention(*ins, causal=True), ins, do)
    dv = got[2].clone()
    dv[:, 1984:] = 0
    dq = got[0].clone()
    dq[:, 1984:] *= 1.1
    print("READ old-metric", json.dumps({
        "dv_zeroed": _former_share(dv, want[2]),
        "dq_x1.1": _former_share(dq, want[0]),
        "max_abs": [float(w.float().abs().max()) for w in want],
        "median_abs": [float(w.float().abs().median()) for w in want]}),
        flush=True)
    del q, k, v, do, o, lse, got, ins, want, dv, dq
    for D, H, K, S, causal in FLASH_BWD_CASES:
        g = torch.Generator(device="cuda").manual_seed(D + S)

        def r(*s):
            return torch.randn(*s, generator=g, device="cuda").to(
                torch.bfloat16)

        q, k, v = r(2, S, H, D), r(2, S, K, D), r(2, S, K, D)
        do = r(2, S, H, D)

        def grads(plain: bool):
            ins = [t.clone().requires_grad_() for t in (q, k, v)]
            if plain:
                with ops.use_backend("plain"):
                    out = ops.attention(*ins, causal=causal)
            else:
                out = ops.attention(*ins, causal=causal)
            return torch.autograd.grad(out, ins, do)

        w, a = grads(True), grads(False)
        print("READ case", (D, H, K, S, causal),
              [c._tile_share(x, y) for x, y in zip(a, w)], flush=True)
    torch.cuda.empty_cache()
    from repro_torch.configs import get

    first = c._first_step(get("smollm-360m"), c.TRAIN["B"], c.TRAIN["S"],
                          ("layers", "attn", "ln"))
    print("READ first", json.dumps({k: first[k] for k in (
        "loss_diff", "grad_norm_rel", "leaf_shares", "worst_leaf",
        "worst_leaf_by_layer", "planted_leaf_share")}), flush=True)
    print("READ seconds", time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
