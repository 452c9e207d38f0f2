"""End-to-end serving entry point of the port (CLI).

A :class:`~repro_torch.serving.engine.ServeEngine` serves a batch of random
prompts with continuous batching, from weights drawn from ``--seed``, and
prints each request's greedy continuation. Runs on ``cuda`` unless
``--device cpu`` is given.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        [--full] [--device cpu] [--requests 8 --max-new 12]
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=8)
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
    done = engine.run()
    for r in sorted(done, key=lambda r: r.req_id)[:6]:
        print(f"  req {r.req_id}: prompt {r.prompt[:4]}... -> {r.generated}")
    print(f"{len(done)}/{args.requests} requests completed")
    return done


if __name__ == "__main__":
    main()
