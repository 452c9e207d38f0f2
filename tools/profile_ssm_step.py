"""Warm training steps of the families ``chip_smoke`` trains, timed and
profiled on one H100.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/profile_ssm_step.py [--src SRC] [--steps K]
        [--nodes NODE ...] [ARCH ...]

``ARCH`` is an arch of ``chip_smoke.TRAIN_RUNS``, its depth cut as that
table cuts it: ``zamba2-1.2b`` (the default; full depth),
``falcon-mamba-7b`` (8 of 64 layers), ``granite-moe-1b-a400m`` (full
depth), ``deepseek-moe-16b`` or ``whisper-medium``. ``--nodes`` names
autograd nodes (``MoeRouteBackward``: the router's backward) whose calls
in the profiled step are reported with the device ms and launches of the
kernels they made and their share of the busy time
(``chip_smoke._node_ops``). Each
is built at published widths from seed 0 and trained at ``chip_smoke``'s
training shape (B 2, S 2048) through ``make_train_step``: two steps to
warm, ``K`` (default 5) timed, then one under ``torch.profiler``
(``chip_smoke._profile_step``: the device's busy time over the profiled
step's own wall, the host's own time, the kernels by device time). ``SRC``
is a ``src`` directory whose ``repro_torch`` is run: this checkout's (the
default), or another commit's unpacked under ``build/`` (``git archive
<commit> src | tar -x -C build/parent``); run two packages in turns (A, B,
B, A) to compare their steps on one card. Prints the card's name and
power limit, then one JSON line an arch: the warm-up and timed steps'
milliseconds, their median, and the profile.
"""

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the step's deterministic mode needs this before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def profile_steps(archs, src: str, steps: int, nodes=()) -> None:
    """Each arch of ``chip_smoke.TRAIN_RUNS`` in turn, under the package at
    ``src``: two warm steps, ``steps`` timed, one profiled
    (``chip_smoke._profile_step`` with ``nodes``), one JSON line each."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    # chip_smoke put this checkout's src first and imported from it: drop
    # what it imported, so that the package under src is the one run
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    src = Path(src).resolve()
    sys.path.insert(0, str(src))
    import repro_torch
    from repro_torch.config import RunConfig
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.models import get_model
    from repro_torch.training.state import init_train_state
    from repro_torch.training.step import make_train_step

    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise SystemExit(f"repro_torch imported from {repro_torch.__file__}")
    cs.phase_device()
    for arch in archs:
        q = cs.TRAIN_RUNS[arch]
        cfg = cs.train_cfg(arch, q["layers"])
        model = get_model(cfg)
        step = make_train_step(model, RunConfig(arch=cfg.arch_id))
        data = SyntheticDataset(cfg, q["S"], q["B"], 0)
        state = init_train_state(model, 0, "cuda")
        times = []
        for i in range(2 + steps):
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in data.batch(i).items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in data.batch(2 + steps).items()}
        prof = cs._profile_step(step, state, batch, nodes)
        print(json.dumps({"arch": arch, "src": str(src),
                          "n_layers": cfg.n_layers, "B": q["B"], "S": q["S"],
                          "warm_step_ms": times[:2],
                          "step_ms": times[2:],
                          "median_step_ms": statistics.median(times[2:]),
                          "profile": prof}), flush=True)
        del model, step, state, batch
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("archs", nargs="*", default=["zamba2-1.2b"])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--nodes", nargs="*", default=[])
    args = ap.parse_args(argv)
    profile_steps(args.archs, args.src, args.steps, tuple(args.nodes))
    return 0


if __name__ == "__main__":
    sys.exit(main())
