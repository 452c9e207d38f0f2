"""Architecture registry of the port: ``--arch <id>`` resolves here.

Each module defines ``CONFIG`` (the published figures) and ``reduced()``
(a tiny same-family twin for CPU tests), exactly as the JAX package's
``repro/configs``. Only the dense family is ported so far; the other
archs of the JAX package raise ``KeyError`` naming the ROADMAP item that
ports their family.
"""

from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.configs import qwen3_8b, smollm_360m

_MODULES = [qwen3_8b, smollm_360m]

ARCHS: dict[str, ModelConfig] = {m.CONFIG.arch_id: m.CONFIG for m in _MODULES}
REDUCED: dict[str, ModelConfig] = {m.CONFIG.arch_id: m.reduced() for m in _MODULES}

# archs of the JAX package whose family the port does not carry yet
_NOT_PORTED: dict[str, str] = {
    "phi4-mini-3.8b": "dense configs beyond the first slice (ROADMAP Queue 1)",
    "minitron-4b": "dense configs beyond the first slice (ROADMAP Queue 1)",
    "granite-moe-1b-a400m": "MoE family (ROADMAP Queue 1, item 11)",
    "deepseek-moe-16b": "MoE family (ROADMAP Queue 1, item 11)",
    "falcon-mamba-7b": "SSM family (ROADMAP Queue 1, item 12)",
    "zamba2-1.2b": "hybrid family (ROADMAP Queue 1, item 12)",
    "llava-next-mistral-7b": "multimodal families (ROADMAP Queue 1, item 13)",
    "whisper-medium": "multimodal families (ROADMAP Queue 1, item 13)",
}


def get(arch_id: str, reduced: bool = False) -> ModelConfig:
    table = REDUCED if reduced else ARCHS
    if arch_id in _NOT_PORTED:
        raise KeyError(
            f"arch {arch_id!r} is not ported yet: {_NOT_PORTED[arch_id]}"
        )
    if arch_id not in table:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(table)}")
    return table[arch_id]
