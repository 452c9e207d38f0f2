"""Model zoo of the port: ``get_model(cfg)`` returns a
:class:`repro_torch.models.model_api.ModelFns`.

Only the dense family (``transformer``) is ported; the others raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models.model_api import ModelFns

_LATER = {
    "moe": "ROADMAP Queue 1, item 11 (MoE family)",
    "ssm": "ROADMAP Queue 1, item 12 (SSM and hybrid families)",
    "hybrid": "ROADMAP Queue 1, item 12 (SSM and hybrid families)",
    "encdec": "ROADMAP Queue 1, item 13 (multimodal families)",
    "vlm": "ROADMAP Queue 1, item 13 (multimodal families)",
}


def get_model(cfg: ModelConfig) -> ModelFns:
    if cfg.family == "dense":
        from repro_torch.models import transformer

        return transformer.make_model(cfg)
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family} family is not ported yet "
            f"({_LATER[cfg.family]})"
        )
    raise ValueError(f"unknown family {cfg.family!r}")
