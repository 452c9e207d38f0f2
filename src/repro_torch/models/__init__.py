"""Model zoo of the port: ``get_model(cfg)`` returns a
:class:`repro_torch.models.model_api.ModelFns`.

Every family of the JAX package is ported: dense and VLM
(``transformer``), MoE (``moe``), SSM (``mamba``), hybrid (``hybrid``) and
enc-dec (``encdec``).
"""

from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models.model_api import ModelFns


def get_model(cfg: ModelConfig) -> ModelFns:
    if cfg.family in ("dense", "vlm"):
        from repro_torch.models import transformer as family
    elif cfg.family == "moe":
        from repro_torch.models import moe as family
    elif cfg.family == "ssm":
        from repro_torch.models import mamba as family
    elif cfg.family == "hybrid":
        from repro_torch.models import hybrid as family
    elif cfg.family == "encdec":
        from repro_torch.models import encdec as family
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return family.make_model(cfg)
