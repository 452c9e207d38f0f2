"""The spread of one model's kernel-path logits over seeds, on one H100.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/logit_spread.py ARCH SEED [SEED ...]

For each seed, builds ``ARCH`` at full width with random weights drawn from
that seed and runs ``chip_smoke.py``'s ``phase_logits`` on inputs drawn
from it too, with no bound applied: two prompts teacher-forced through the
kernel path and the plain path, and the phase's controls (one bf16 ulp on
one embedding value and on every one; for a VLM the image/text split one
row early). Prints the card's name and power limit, one JSON line per seed
(the phase's own line, then ``{"seed": ..., ...}`` with the numbers that
choose a bound), and last the largest of each over the seeds. Readings
only: the bound is ``chip_smoke.py``'s ``LOGIT_ATOL``.
"""

import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

KEYS = ("max_abs_diff", "mean_abs_diff", "max_abs_logit", "max_tie_gap",
        "one_ulp_control_max_abs_diff",
        "every_value_ulp_control_max_abs_diff", "split_control_max_abs_diff")


def main() -> int:
    import torch

    if len(sys.argv) < 3 or not torch.cuda.is_available():
        print(__doc__ if len(sys.argv) < 3 else "no CUDA device",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.models import get_model

    arch, seeds = sys.argv[1], [int(a) for a in sys.argv[2:]]
    device = cs.phase_device()
    cs.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.LOGIT_ATOL[arch] = None
    model = get_model(get(arch))
    readings = []
    for seed in seeds:
        params = model.init(seed, device="cuda")
        out = cs.phase_logits(model, params, seed=seed)
        readings.append({"seed": seed, **{k: out[k] for k in KEYS}})
        print(json.dumps(readings[-1]), flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({
        "arch": arch, "seeds": seeds, "card": device["smi"],
        "max": {k: max((r[k] for r in readings if r[k] is not None),
                       default=None) for k in KEYS}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
