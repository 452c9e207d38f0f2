"""granite-moe-1b-a400m — fine-grained MoE.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32 experts top-8.
"""

from dataclasses import replace

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49_155,
    n_experts=32,
    moe_top_k=8,
    d_expert=512,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    notes="32 experts top-8",
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=96,
        d_expert=96,
        vocab_size=512,
        n_experts=4,
        moe_top_k=2,
    )
