"""falcon-mamba-7b — attention-free Mamba1 LM. [arXiv:2410.05355; unverified]

64L d_model=4096 (attn-free) vocab=65024, ssm_state=16 — mamba1 arch.
"""

from dataclasses import replace

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65_024,
    ssm_state=16,
    d_conv=4,
    expand=2,
    mamba_version=1,
    ssm_chunk=256,
    source="arXiv:2410.05355; unverified",
    notes="mamba1 arch, attention-free",
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        vocab_size=512,
        ssm_state=4,
        ssm_chunk=16,
    )
