"""One cell's meta pass, in full (``repro/launch/exact_compile.py``'s
command line).

The reference compiles the unrolled program of one hillclimb cell and
reads its per-device FLOPs, bytes and collective bytes. The port runs
eagerly, so every loop of the program (layers, loss chunks, scans) runs
in full on the meta device and the count is already trip-exact: this runs
the dry-run's pass (``launch/dryrun.py``) on the one-pod grid and writes
its record, with no card.

    PYTHONPATH=src python -m repro_torch.launch.exact_compile ARCH SHAPE [VARIANT]

The record lands in ``artifacts/torch_exact/<arch>__<shape>__exact.json``
and is printed.
"""

from __future__ import annotations

import json
import os
import sys
import time


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    arch, shape_name = argv[0], argv[1]
    variant = argv[2] if len(argv) > 2 and argv[2] != "-" else None

    from repro_torch.launch.dryrun import NO_COLLECTIVES, measure

    t0 = time.time()
    m = measure(arch, shape_name, "single", variant)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "single",
        "variant": variant or "baseline",
        "chips": 256,
        "measurement": "meta pass (eager: every loop in full; per device "
                       "= global / devices)",
        "count_s": round(time.time() - t0, 1),
        "flops_per_device": m["flops_per_device"],
        "bytes_per_device": m["bytes_per_device"],
        "compute_s_per_device": m["compute_s_per_device"],
        "temp_per_device": m["memory"]["temp_per_device"],
        "kernels": m["kernels"],
        "collectives": None,
        "collectives_reason": NO_COLLECTIVES,
    }
    tag = f"{arch}__{shape_name}__exact"
    if variant:
        tag += "__" + variant.replace("=", "-").replace(",", "+")
    out = os.path.join("artifacts", "torch_exact", tag + ".json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
