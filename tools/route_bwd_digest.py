"""The MoE router's whole backward of one checkout, on one H100: digests of
its outputs and its device time.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/route_bwd_digest.py SRC

``SRC`` is a ``src`` directory whose ``repro_torch`` is imported: this
checkout's ``src``, or another commit's unpacked under ``build/``
(``git archive <commit> src | tar -x -C build/parent``). On
``chip_smoke.check_moe_route_bwd``'s inputs at granite-moe-1b-a400m's and
deepseek-moe-16b's training shapes (4096 tokens; ``chip_smoke._router``,
seed 30, no near tie zeroed), runs the route's backward as training does,
``torch.autograd.grad`` through ``MoeRoute`` with the weights' and the
probabilities' gradients, and prints the card's name and power limit, then
one JSON line an arch: a SHA-256 of d_logits (the first kernel's output;
two checkouts whose kernels compute the same bits print the same one), of
dx and of d_router; the device operations of one call (``chip_smoke.
_kernels_us``, a profile of 20 calls: each one's microseconds and launches
a call), their sum and their count; and the call's median time by CUDA
events with L2 flushed (``chip_smoke._grad_ms``, which includes autograd's
host time). Run in turns in one call (other, this, this, other), it
compares two designs of the backward on one card.
"""

import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("granite-moe-1b-a400m", "deepseek-moe-16b")


def _digest(t) -> str:
    import torch

    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    # chip_smoke put this checkout's src first and imported from it: drop
    # what it imported, so that the package under SRC is the one run
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    src = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(src))
    import repro_torch
    from repro_torch.configs import get
    from repro_torch.kernels import moe_route as rk

    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise SystemExit(f"repro_torch imported from {repro_torch.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_device()
    print("package", repro_torch.__file__, flush=True)
    for arch in ARCHS:
        cfg = get(arch)
        T, E, k = cs.MOE_TRAIN_T, cfg.n_experts, cfg.moe_top_k
        gen = torch.Generator(device="cuda").manual_seed(30)
        x, router = cs._router(gen, cfg, T)
        dw = torch.randn(T, k, generator=gen, device="cuda")
        dprobs = torch.randn(T, E, generator=gen, device="cuda")
        xk, rk_ = x.clone().requires_grad_(), router.clone().requires_grad_()
        weights, ids, probs = rk.MoeRoute.apply(xk, rk_, k)
        if hasattr(rk, "grads_plan"):     # two launches, d_logits kept
            dl = rk.moe_route_bwd(x, router, probs, ids, weights, dw,
                                  dprobs, need_dx=False, need_drouter=False,
                                  with_d_logits=True)[2]
        else:                             # the first design's wrapper
            dl = rk.moe_route_bwd(probs, ids, weights, dw, dprobs)

        def grad():
            return torch.autograd.grad((weights, probs), (xk, rk_),
                                       (dw, dprobs), retain_graph=True)

        dx, dr = grad()
        ops = cs._kernels_us(grad)
        print(json.dumps({
            "arch": arch, "src": str(src), "T": T, "d": cfg.d_model, "E": E,
            "k": k, "d_logits_sha256": _digest(dl), "dx_sha256": _digest(dx),
            "d_router_sha256": _digest(dr),
            "device_ms": sum(o["us"] * o["per_call"] for o in ops.values())
            / 1e3,
            "launches_per_call": sum(o["per_call"] for o in ops.values()),
            "device_ops": ops,
            "grad_ms": cs._grad_ms((weights, probs), (xk, rk_),
                                   (dw, dprobs))}), flush=True)
        del x, router, xk, rk_, weights, ids, probs, dl, dx, dr
    return 0


if __name__ == "__main__":
    sys.exit(main())
