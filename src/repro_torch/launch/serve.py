"""End-to-end serving entry point of the port (CLI).

A :class:`~repro_torch.serving.engine.ServeEngine` serves a batch of random
prompts with continuous batching, from weights drawn from ``--seed``, and
prints each request's greedy continuation. With ``--fail-after N`` the
serving host fails after N engine steps: the engine is snapshotted, a
fresh engine with the same weights restores the blob (the substitute host,
paper §III-D), and generation resumes deterministically. Runs on ``cuda``
unless ``--device cpu`` is given.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        [--full] [--device cpu] [--requests 8 --max-new 12] [--fail-after 5]

``--arch`` takes every text-only arch the port carries: ``qwen3-8b``,
``smollm-360m``, ``phi4-mini-3.8b``, ``minitron-4b`` (dense),
``granite-moe-1b-a400m``, ``deepseek-moe-16b`` (MoE), ``falcon-mamba-7b``
(SSM) and ``zamba2-1.2b`` (hybrid). The multimodal archs
(``llava-next-mistral-7b``, ``whisper-medium``) need a modality input with
every request, which this CLI does not make: it refuses them before
building anything, and they serve through the Python API,
``ServeEngine.submit(prompt, extra={"embeds": ...})`` or ``extra={"frames":
...}``.
"""

from __future__ import annotations

import argparse

# the modality input each multimodal family's requests carry
MODALITY = {"encdec": "frames", "vlm": "embeds"}


def main(argv: list[str] | None = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--fail-after", type=int, default=None,
                    help="kill the serving host after N engine steps")
    ap.add_argument("--full", action="store_true",
                    help="published widths and depth (else the reduced twin)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.configs import get
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServeEngine

    cfg = get(args.arch, reduced=not args.full)
    if cfg.family in MODALITY:
        raise SystemExit(
            f"{args.arch}: the {cfg.family} family needs "
            f"extra={{{MODALITY[cfg.family]!r}: ...}} with every request, "
            "which this CLI does not supply; serve it through "
            "ServeEngine.submit(prompt, extra={'frames'|'embeds': ...})")
    model = get_model(cfg)
    params = model.init(args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    engine = ServeEngine(model, params, n_slots=args.slots,
                         max_seq=args.max_seq, device=args.device)
    for _ in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size, args.prompt_len).tolist()
        engine.submit(prompt, max_new_tokens=args.max_new)
    print(f"serving {args.requests} requests on {args.arch} "
          f"({args.slots} slots, {engine.device})")
    if args.fail_after is None:
        done = engine.run()
    else:
        for _ in range(args.fail_after):
            engine.step()
        print(f"-- host failure after {args.fail_after} steps: snapshotting, "
              f"restoring on substitute host --")
        blob = engine.snapshot()          # P2P replica (paper §III-D)
        engine2 = ServeEngine(model, params, n_slots=args.slots,
                              max_seq=args.max_seq, device=args.device)
        engine2.restore(blob)             # restore on the receiver
        done = engine2.run()
    for r in sorted(done, key=lambda r: r.req_id)[:6]:
        print(f"  req {r.req_id}: prompt {r.prompt[:4]}... -> {r.generated}")
    print(f"{len(done)}/{args.requests} requests completed")
    return done


if __name__ == "__main__":
    main()
