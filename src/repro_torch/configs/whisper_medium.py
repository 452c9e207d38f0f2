"""whisper-medium — encoder-decoder audio backbone. [arXiv:2212.04356; unverified]

24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865 — enc-dec, conv frontend
STUB per the assignment (``input_specs()`` supplies precomputed frame
embeddings). GELU MLP, learned positions, MHA.
"""

from dataclasses import replace

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-medium",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51_865,
    gated_mlp=False,
    learned_positions=True,
    tie_embeddings=True,
    max_position=32_768,
    source="arXiv:2212.04356; unverified",
    notes="enc-dec, conv frontend (stub)",
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2,
        n_encoder_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab_size=512,
    )
