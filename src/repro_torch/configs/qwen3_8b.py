"""qwen3-8b — dense decoder LM with qk-norm. [hf:Qwen/Qwen3-8B; hf]

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936 — qk_norm, GQA.
"""

from dataclasses import replace

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12_288,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B; hf",
    notes="qk_norm, GQA",
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2,
        d_model=96,
        n_heads=4,
        n_kv_heads=2,
        d_head=24,
        d_ff=256,
        vocab_size=512,
    )
