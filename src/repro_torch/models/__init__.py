"""Model zoo of the port: ``get_model(cfg)`` returns a
:class:`repro_torch.models.model_api.ModelFns`.

The dense (``transformer``), MoE (``moe``), SSM (``mamba``) and hybrid
(``hybrid``) families are ported; the multimodal ones raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models.model_api import ModelFns

_LATER = {
    "encdec": "ROADMAP Queue 1, item 13 (multimodal families)",
    "vlm": "ROADMAP Queue 1, item 13 (multimodal families)",
}


def get_model(cfg: ModelConfig) -> ModelFns:
    if cfg.family == "dense":
        from repro_torch.models import transformer as family
    elif cfg.family == "moe":
        from repro_torch.models import moe as family
    elif cfg.family == "ssm":
        from repro_torch.models import mamba as family
    elif cfg.family == "hybrid":
        from repro_torch.models import hybrid as family
    elif cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family} family is not ported yet "
            f"({_LATER[cfg.family]})"
        )
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return family.make_model(cfg)
