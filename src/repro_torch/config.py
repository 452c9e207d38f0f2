"""Model and input-shape configuration.

A copy of the JAX package's ``ModelConfig`` and ``ShapeConfig``
(``repro/config.py``): the port imports nothing of that package, so the
field set and defaults are repeated here verbatim (the two packages'
configs compare equal field by field); of the derived quantities only what
the port uses is kept.
"""

from __future__ import annotations

from dataclasses import dataclass

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (one instance per arch)."""

    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # Attention details
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    causal: bool = True

    # MLP
    gated_mlp: bool = True  # SwiGLU if True, GELU MLP if False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    first_k_dense: int = 0
    d_ff_dense: int = 0
    router_aux_coef: float = 0.01

    # SSM (Mamba)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    mamba_version: int = 1
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # Hybrid (zamba2-style)
    attn_every: int = 0

    # Encoder-decoder (whisper-style)
    n_encoder_layers: int = 0
    learned_positions: bool = False
    max_position: int = 0

    # VLM (llava-style)
    n_image_tokens: int = 0

    # Common
    norm_eps: float = 1e-5
    notes: str = ""
    source: str = ""

    # Performance knobs of the reference (kept so configs compare equal)
    remat_policy: str = "full"
    seq_parallel: bool = False
    moe_impl: str = "dense"
    ssm_dtype: str = "f32"

    def __post_init__(self):
        if self.d_head == 0 and self.n_heads > 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.n_heads and self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(
                f"{self.arch_id}: n_heads={self.n_heads} not a multiple of "
                f"n_kv_heads={self.n_kv_heads}"
            )

    def param_count(self) -> int:
        """Parameters of a dense decoder (embedding, blocks, unembedding)."""
        d, L = self.d_model, self.n_layers
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head \
            + self.n_heads * self.d_head * d
        mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + L * (attn + mlp)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
