"""Digests of one checkout's SSM backward kernels' outputs on one H100.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/ssm_bwd_digest.py SRC

``SRC`` is a ``src`` directory whose ``repro_torch`` is imported: this
checkout's ``src``, or another commit's unpacked under ``build/``
(``git archive <commit> src | tar -x -C build/parent``). On
``chip_smoke.py``'s inputs at the training shapes (``_scan_case`` at
falcon-mamba-7b's, ``_ssd_case`` at zamba2-1.2b's, B 2, S 2048, each with
the mild decay and the decay the models start from), runs
``selective_scan_bwd`` and ``ssd_bwd`` and prints the card's name and
power limit, then two JSON lines: a SHA-256 of each call's seven
gradients' bytes (two checkouts whose kernels compute the same bits print
the same line), and the device microseconds of each launch of a call
(``chip_smoke._kernels_us``, a profile of 20 calls).
"""

import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


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
    from repro_torch.kernels import selective_scan as sk
    from repro_torch.kernels import ssd as dk

    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise SystemExit(f"repro_torch imported from {repro_torch.__file__}")
    cs.phase_device()
    print("package", repro_torch.__file__, flush=True)
    out, us = {}, {}
    for init in (False, True):
        gen = torch.Generator(device="cuda").manual_seed(27)
        args = cs._scan_case(gen, 2048, 0.1, B=2, Di=8192, N=16,
                             init_decay=init)
        dy = torch.randn(2, 2048, 8192, generator=gen,
                         device="cuda").bfloat16()
        _, _, hs = sk.selective_scan(*args, save_states=True)
        grads = sk.selective_scan_bwd(*args[:6], hs, dy)
        out[f"selective_scan_bwd init_decay={init}"] = _digest(grads)
        us[f"selective_scan_bwd init_decay={init}"] = cs._kernels_us(
            lambda: sk.selective_scan_bwd(*args[:6], hs, dy))
        del args, dy, hs, grads
        args = cs._ssd_case(gen, 2048, 0.1, B=2, Hs=64, P=64, N=64,
                            init_decay=init)
        dy = torch.randn(2, 2048, 64, 64, generator=gen,
                         device="cuda").bfloat16()
        _, _, scratch = dk._forward(*args, 256)
        grads = dk.ssd_bwd(*args[:6], scratch, dy, chunk=256)
        out[f"ssd_bwd init_decay={init}"] = _digest(grads)
        us[f"ssd_bwd init_decay={init}"] = cs._kernels_us(
            lambda: dk.ssd_bwd(*args[:6], scratch, dy, chunk=256))
        del args, dy, scratch, grads
    print(json.dumps(out), flush=True)
    print(json.dumps(us), flush=True)
    return 0


def _digest(tensors) -> str:
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


if __name__ == "__main__":
    sys.exit(main())
