"""zamba2-1.2b — hybrid: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64 — Mamba2 +
shared attn blocks (one weight-shared attention+MLP block applied periodically).
"""

from dataclasses import replace

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_000,
    ssm_state=64,
    d_conv=4,
    expand=2,
    mamba_version=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    attn_every=6,
    source="arXiv:2411.15242; hf",
    notes="Mamba2 + shared attn blocks (applied every 6 layers)",
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        ssm_state=8,
        ssm_head_dim=16,
        ssm_chunk=16,
        attn_every=2,
    )
