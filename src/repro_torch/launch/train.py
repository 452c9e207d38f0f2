"""End-to-end training entry point of the port (CLI).

Runs a real training job on the ad hoc cloud runtime: a simulated host
fleet executes the train step, periodic P2P snapshots protect it, and
injected failures exercise the §III-D restore path. The reference's flags
(``repro/launch/train.py``), plus ``--device`` (``cuda`` unless ``cpu`` is
given). REDUCED configs run the whole loop on the CPU; ``--full`` (the
published widths and depth) is for the card. Every family trains: the
dense decoders (``qwen3-8b``, ``smollm-360m``, ``phi4-mini-3.8b``,
``minitron-4b``), ``llava-next-mistral-7b``, the SSM family
(``falcon-mamba-7b``), the hybrid (``zamba2-1.2b``), the MoE family
(``granite-moe-1b-a400m``, ``deepseek-moe-16b``) and the encoder-decoder
(``whisper-medium``, on the synthetic data's frames).

Sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (unless set) before CUDA starts:
the step runs in torch's deterministic mode, which needs it for cuBLAS
(``training/step.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 30 --hosts 4 --fail-at 10 --fail-at 20 [--full] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--snapshot-every", type=int, default=5)
    ap.add_argument("--fail-at", type=int, action="append", default=[],
                    help="inject a host failure when the job reaches this step")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--full", action="store_true",
                    help="use the full published config (for the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.config import RunConfig
    from repro_torch.configs import get
    from repro_torch.training.trainer import AdHocTrainer

    cfg = get(args.arch, reduced=not args.full)
    run = RunConfig(
        arch=args.arch,
        shape=args.shape,
        seed=args.seed,
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        snapshot_interval_steps=args.snapshot_every,
    )
    fail_at = {s: "host000" for s in args.fail_at}
    trainer = AdHocTrainer(
        cfg,
        run,
        n_hosts=args.hosts,
        total_steps=args.steps,
        seq_len=args.seq_len,
        global_batch=args.batch,
        fail_at_steps=fail_at,
        device=args.device,
    )
    print(f"training {args.arch} ({'full' if args.full else 'reduced'}) "
          f"for {args.steps} steps on {args.hosts} ad hoc hosts "
          f"(snapshot every {args.snapshot_every}, failures at "
          f"{sorted(fail_at) or 'none'}) on {trainer.device}")
    report = trainer.run_to_completion()
    print(f"completed={report.completed} effective={report.effective_steps} "
          f"executed={report.executed_steps} "
          f"recomputed={report.recomputed_steps} restores={report.restores} "
          f"restarts={report.restarts_from_zero}")
    for i, (step, loss) in enumerate(report.losses):
        if i % max(1, len(report.losses) // 10) == 0 or i == len(report.losses) - 1:
            print(f"  step {step:4d}  loss {loss:.4f}  "
                  f"host {report.host_of_step[i]}")
    return report


if __name__ == "__main__":
    main()
