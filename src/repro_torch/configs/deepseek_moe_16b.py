"""deepseek-moe-16b — fine-grained MoE with shared experts. [arXiv:2401.06066; hf]

28L d_model=2048 16H (MHA kv=16) d_ff=1408 vocab=102400, 64 routed top-6 +
2 shared experts; first layer dense (d_ff=10944) as in the release.
"""

from dataclasses import replace

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    d_expert=1408,
    first_k_dense=1,
    d_ff_dense=10_944,
    source="arXiv:2401.06066; hf",
    notes="2 shared + 64 routed top-6, fine-grained",
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=96,
        d_expert=96,
        d_ff_dense=128,
        first_k_dense=1,
        vocab_size=512,
        n_experts=8,
        n_shared_experts=1,
        moe_top_k=2,
    )
