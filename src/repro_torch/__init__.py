"""PyTorch / CUDA port of the JAX package ``repro``, for one NVIDIA H100.

Module names follow ``repro`` so that each module's counterpart is easy to
find; the code inside is PyTorch. The port imports neither ``jax`` nor
anything of ``repro``: it keeps its own copies of what it needs. Its entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; asked for
``cuda`` without a card, they raise.

The first slice serves dense decoders (``qwen3-8b``, ``smollm-360m``)
through the paged, continuously batched engine, with hand-written Hopper
kernels for RMSNorm (Triton), paged decode attention and flash attention
(CUDA C++). ``ROADMAP.md`` lists what comes next.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` must have a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
