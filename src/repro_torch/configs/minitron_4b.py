"""minitron-4b — pruned nemotron dense LM. [arXiv:2407.14679; hf]

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""

from dataclasses import replace

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab_size=256_000,
    source="arXiv:2407.14679; hf",
    notes="pruned nemotron",
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
