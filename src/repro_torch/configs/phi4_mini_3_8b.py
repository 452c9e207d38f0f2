"""phi4-mini-3.8b — dense decoder LM. [arXiv:2412.08905; hf]

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 — RoPE SwiGLU GQA.
"""

from dataclasses import replace

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200_064,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2412.08905; hf",
    notes="RoPE SwiGLU GQA",
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_head=16,
        d_ff=256,
        vocab_size=512,
    )
