"""End-to-end training on the ad hoc cloud with the PyTorch port: the
executing host is killed mid-run, training resumes from a P2P snapshot on
another host and ends bit-identical to a failure-free run
(``examples/fault_tolerant_training.py`` through ``repro_torch``).

REDUCED smollm-360m, on ``cuda`` (the hand-written kernels and their
backwards) unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_fault_tolerant_training.py [--device cpu]
"""

import argparse
import os

# the step runs in torch's deterministic mode, whose cuBLAS needs this
# before CUDA starts (src/repro_torch/training/step.py)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

from repro_torch.config import RunConfig  # noqa: E402
from repro_torch.configs import REDUCED  # noqa: E402
from repro_torch.models.model_api import tree_leaves  # noqa: E402
from repro_torch.training.trainer import AdHocTrainer  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda",
                help="cuda (default; raises without a card) or cpu")
DEVICE = ap.parse_args().device

ARCH = "smollm-360m"
STEPS = 24

cfg = REDUCED[ARCH]  # reduced same-family config: seconds a run
run = RunConfig(arch=ARCH, snapshot_interval_steps=5)

print(f"=== reference run: {STEPS} steps, no failures ===")
ref = AdHocTrainer(cfg, run, n_hosts=4, total_steps=STEPS, seq_len=64,
                   global_batch=8, device=DEVICE).run_to_completion()
print(f"completed={ref.completed} loss {ref.losses[0][1]:.3f} -> "
      f"{ref.losses[-1][1]:.3f}")

print("\n=== faulty run: host dies at step 8, another at step 17 ===")
faulty = AdHocTrainer(
    cfg, run, n_hosts=4, total_steps=STEPS, seq_len=64, global_batch=8,
    fail_at_steps={8: "host000", 17: "host001"}, device=DEVICE,
).run_to_completion()
print(f"completed={faulty.completed}")
print(f"executed {faulty.executed_steps} steps for "
      f"{faulty.effective_steps} effective "
      f"({faulty.recomputed_steps} recomputed after failures)")
print(f"snapshot restores: {faulty.restores}, "
      f"restarts from zero: {faulty.restarts_from_zero}")
print(f"hosts used: {sorted(set(faulty.host_of_step))}")

same = all(torch.equal(a, b) for a, b in zip(
    tree_leaves(ref.final_state["params"]),
    tree_leaves(faulty.final_state["params"])))
print(f"\nfinal parameters bit-identical to failure-free run: {same}")
assert same, "continuity broken!"
print("the ad hoc cloud made an unreliable fleet train exactly like a "
      "reliable one.")
