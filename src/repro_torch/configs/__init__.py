"""Architecture registry of the port: ``--arch <id>`` resolves here.

Each module defines ``CONFIG`` (the published figures) and ``reduced()``
(a tiny same-family twin for CPU tests), exactly as the JAX package's
``repro/configs``: every arch of the JAX package, all six families
(dense, MoE, SSM, hybrid, and the multimodal enc-dec and VLM).
``DRAFT_PAIRS`` and ``draft_for`` are copies of the reference's
speculative-decoding pairings.
"""

from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.configs import (
    deepseek_moe_16b,
    falcon_mamba_7b,
    granite_moe_1b_a400m,
    llava_next_mistral_7b,
    minitron_4b,
    phi4_mini_3_8b,
    qwen3_8b,
    smollm_360m,
    whisper_medium,
    zamba2_1_2b,
)

_MODULES = [qwen3_8b, smollm_360m, phi4_mini_3_8b, minitron_4b,
            granite_moe_1b_a400m, deepseek_moe_16b, falcon_mamba_7b,
            zamba2_1_2b, llava_next_mistral_7b, whisper_medium]

ARCHS: dict[str, ModelConfig] = {m.CONFIG.arch_id: m.CONFIG for m in _MODULES}
REDUCED: dict[str, ModelConfig] = {m.CONFIG.arch_id: m.reduced() for m in _MODULES}

# Natural draft/target pairings for speculative decoding: a small same-vocab
# family member drafts for the big target. Keyed by target arch id. At
# published widths every pair differs in vocab, so an engine refuses it
# there (ROADMAP Queue 3, R4); they run at REDUCED sizes, where every
# vocab is 512.
DRAFT_PAIRS: dict[str, str] = {
    "qwen3-8b": "smollm-360m",
    "phi4-mini-3.8b": "smollm-360m",
    "minitron-4b": "smollm-360m",
    "deepseek-moe-16b": "granite-moe-1b-a400m",
}


def get(arch_id: str, reduced: bool = False) -> ModelConfig:
    table = REDUCED if reduced else ARCHS
    if arch_id not in table:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(table)}")
    return table[arch_id]


def draft_for(arch_id: str, reduced: bool = False) -> ModelConfig | None:
    """The paired draft config for a target arch (None when unpaired)."""
    pair = DRAFT_PAIRS.get(arch_id)
    return get(pair, reduced=reduced) if pair else None
