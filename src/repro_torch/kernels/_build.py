"""Build the CUDA C++ kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (pointers and the stream as
``void*``, sizes as ``int``; every entry returns ``cudaGetLastError()``).
It compiles on first use, for ``sm_90a`` only, into
``build/repro_torch/lib<name>-<hash>.so`` at the root of the checkout; the
hash is the source's and its headers' (``csrc/*.cuh``), so an edited source
or header rebuilds and a stale library is never loaded. Nothing here runs
at import time: the CPU tests import every module of the port on a machine
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("rmsnorm", "paged_decode_attention", "decode_attention",
           "flash_attention", "flash_attention_bwd", "selective_scan",
           "selective_scan_bwd", "ssd", "ssd_bwd", "gemm_rows", "moe_route",
           "moe_route_bwd")

_libs: dict[str, ctypes.CDLL] = {}
_scratches: dict[tuple, torch.Tensor] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the hash covers the source, every
    shared header of ``csrc/`` and the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def _start(name: str) -> subprocess.Popen | None:
    """Start nvcc for one source unless its library is already built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen | None) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    out = lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    (BUILD / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source in parallel (one nvcc each, all started
    together); returns each compiler log (``-Xptxas -v`` register and
    shared-memory use), empty for a library that was already built."""
    procs = {n: _start(n) for n in names}
    return {n: _finish(n, p) for n, p in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    if name not in _libs:
        build_all((name,))
        _libs[name] = ctypes.CDLL(str(lib_path(name)))
    return _libs[name]


def stream(device) -> int:
    """The handle of ``device``'s current CUDA stream, as the C entries
    take it (PyTorch's raw query: the cheapest on the host)."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def scratch(name: str, n: int, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """The device's scratch ``name``: at least ``n`` elements, uninitialised,
    grown on demand and kept between calls, so that no call allocates it
    anew (under deterministic mode a new tensor is filled first). A kernel
    writes what it reads of it, and launches run in stream order."""
    key = (name, device)
    buf = _scratches.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=dtype, device=device)
        _scratches[key] = buf
    return buf


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
