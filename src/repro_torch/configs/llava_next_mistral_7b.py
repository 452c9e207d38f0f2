"""llava-next-mistral-7b — VLM: anyres vision stub + Mistral backbone.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000 — anyres tiling.
The vision tower is a STUB per the assignment: ``input_specs()`` supplies
precomputed patch embeddings (n_image_tokens positions).
"""

from dataclasses import replace

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    n_image_tokens=576,
    rope_theta=1_000_000.0,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
    notes="anyres tiling (stub frontend); Mistral-7B backbone",
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
        n_image_tokens=8,
    )
