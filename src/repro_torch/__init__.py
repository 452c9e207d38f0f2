"""PyTorch / CUDA port of the JAX package ``repro``, for one NVIDIA H100.

Module names follow ``repro`` so that each module's counterpart is easy to
find; the code inside is PyTorch. The port imports neither ``jax`` nor
anything of ``repro``: it keeps its own copies of what it needs. Its entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; asked for
``cuda`` without a card, they raise.

The continuously batched engine serves the dense decoders (``qwen3-8b``,
``smollm-360m``, ``phi4-mini-3.8b``, ``minitron-4b``), the MoE family
(``granite-moe-1b-a400m``, ``deepseek-moe-16b``), the SSM family
(``falcon-mamba-7b``, Mamba1), the hybrid family (``zamba2-1.2b``,
Mamba2 with a shared attention block) and the multimodal families
(``whisper-medium``, enc-dec with a paged cross-attention region;
``llava-next-mistral-7b``, VLM with image rows inline),
over a paged KV cache (the default) or a dense one (``paged=False``), with
snapshot/restore in the JAX package's blob format. The paged engine's
spill tier lends cold KV pages to peer hosts of a cloudlet and recalls
them (``serving.kvcache.RemotePagePool``, over ``core.cloudlet`` and
``core.reliability``). Every kernel is hand-written CUDA C++ for Hopper:
RMSNorm, flash attention, paged and dense decode attention, the Mamba1
selective scan and the Mamba2 SSD, and the row-invariant products
(``gemm_rows``, grouped over experts too) and MoE router of the paged
decode step. ``ROADMAP.md`` lists what comes next.
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
