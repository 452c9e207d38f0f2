"""Edited copies of the package's CUDA sources, built for the tools that
time or probe variants of a kernel on the card (``tools/ssm_bwd_variants.py``,
``tools/route_norm_variants.py``, ``tools/scan_timeline.py``).

``edited(source, edits)`` replaces each ``(old, new)`` pair of ``edits``,
each ``old`` found in the source exactly once (else the kernel changed
under the tool, and the variant is refused). ``Build(name, source)``
starts ``nvcc`` on a source with the package's own flags and headers
(``csrc/*.cuh``) under ``build/variants/<name>-<hash>``, the hash being the
source's, so an unchanged source is built once; ``Build.wait()`` returns
its library and ptxas's lines on registers and spills. ``variant(name,
source)`` does both.
"""

import ctypes
import hashlib
import os
import re
import subprocess
from pathlib import Path

OUT = Path(__file__).resolve().parents[1] / "build" / "variants"


def edited(source: str, edits) -> str:
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"variant refused: {old[:60]!r} is not in the "
                             f"source once")
        source = source.replace(old, new)
    return source


class Build:
    def __init__(self, name: str, source: str):
        from repro_torch.kernels import _build

        OUT.mkdir(parents=True, exist_ok=True)
        tag = hashlib.sha1(source.encode()).hexdigest()[:12]
        stem = OUT / f"{re.sub(r'[^A-Za-z0-9_.-]+', '_', name)}-{tag}"
        self.so, self.log = stem.with_suffix(".so"), stem.with_suffix(".log")
        self.tmp = stem.with_suffix(".tmp.so")
        self.proc = None
        if not self.so.exists():
            cu = stem.with_suffix(".cu")
            cu.write_text(source)
            self.proc = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                 "-o", str(self.tmp), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait(self) -> tuple[ctypes.CDLL, list[str]]:
        if self.proc is not None:
            log, _ = self.proc.communicate()
            if self.proc.returncode:
                raise RuntimeError(f"nvcc failed for {self.so.name}:\n{log}")
            self.log.write_text(log)
            os.replace(self.tmp, self.so)
            self.proc = None
        usage = [ln.strip() for ln in self.log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        return ctypes.CDLL(str(self.so)), usage


def variant(name: str, source: str) -> ctypes.CDLL:
    return Build(name, source).wait()[0]
