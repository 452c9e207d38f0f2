"""Time SDPA's backward under each of its backends beside the port's flash
backward, at ``chip_smoke.py``'s training shapes, on one H100.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/sdpa_backends.py [--rounds R]

The shapes are ``check_flash_bwd``'s: smollm-360m (B 8, S 2048, H 15 / K
5, D 64) and qwen3-8b (B 2, S 2048, H 32 / K 8, D 128), causal; whisper-
medium's encoder (B 2, 1500 x 1500, H = K = 16, D 64) and cross attention
(2048 queries over 1500 keys), not causal. In each of ``R`` rounds
(default 3), for each shape: the port's backward, then SDPA's forward and
backward under flash, memory-efficient and cuDNN attention
(``torch.nn.attention.sdpa_kernel``; null where the backend refuses the
inputs) and under PyTorch's own choice, each the median of 20 calls with a
cold L2 (``chip_smoke._time_ms``, ``_grad_ms``). Deterministic algorithms
are off. For PyTorch's own choice, the device kernels of one backward
call, from one profiler trace, say which backend it took. Prints the
card's name and power limit, then one JSON line a round.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SHAPES = {
    "smollm-360m": dict(B=8, S=2048, Sk=2048, H=15, K=5, D=64, causal=True),
    "qwen3-8b": dict(B=2, S=2048, Sk=2048, H=32, K=8, D=128, causal=True),
    "whisper-medium encoder": dict(B=2, S=1500, Sk=1500, H=16, K=16, D=64,
                                   causal=False),
    "whisper-medium cross": dict(B=2, S=2048, Sk=1500, H=16, K=16, D=64,
                                 causal=False),
}


def _kernels(fn) -> list[str]:
    """The device kernels of one call of ``fn``, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type.name == "CUDA"})


def case(cs, gen, *, B, S, Sk, H, K, D, causal) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fk

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v, dout = rnd(B, S, H, D), rnd(B, Sk, K, D), rnd(B, Sk, K, D), \
        rnd(B, S, H, D)
    out, lse = fk.flash_attention(q, k, v, causal=causal, with_lse=True)
    row = {"port_bwd_ms": cs._time_ms(lambda: fk.flash_attention_bwd(
        q, k, v, out, dout, lse, causal=causal), flush=True)}
    ins = [t.detach().transpose(1, 2).clone().requires_grad_()
           for t in (q, k, v)]
    ldout = dout.transpose(1, 2)
    for b in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
        try:
            lout = cs._sdpa(ins, causal, gqa=H != K, backend=b)
        except RuntimeError:
            row[b] = None
            continue
        row[b] = {"fwd_ms": cs._time_ms(lambda: cs._sdpa(
                      [t.detach() for t in ins], causal, gqa=H != K,
                      backend=b), flush=True),
                  "bwd_ms": cs._grad_ms(lout, ins, ldout)}
        del lout
    lout = F.scaled_dot_product_attention(*ins, is_causal=causal,
                                          enable_gqa=H != K)
    row["default"] = {
        "fwd_ms": cs._time_ms(lambda: F.scaled_dot_product_attention(
            *(t.detach() for t in ins), is_causal=causal, enable_gqa=H != K),
            flush=True),
        "bwd_ms": cs._grad_ms(lout, ins, ldout),
        "bwd_kernels": _kernels(lambda: torch.autograd.grad(
            lout, ins, ldout, retain_graph=True))}
    return row


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    cs.phase_device()
    for r in range(args.rounds):
        gen = torch.Generator(device="cuda").manual_seed(24)
        cs.log({"round": r, "torch": torch.__version__,
                **{what: case(cs, gen, **shape)
                   for what, shape in SHAPES.items()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
