"""smollm-360m — small llama-architecture LM. [hf:HuggingFaceTB/SmolLM; hf]

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
"""

from dataclasses import replace

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49_152,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
    notes="llama-arch small",
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
