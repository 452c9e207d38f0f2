"""Model, input-shape and run configuration.

A copy of the JAX package's ``ModelConfig``, ``ShapeConfig``, ``SHAPES``,
``OptimConfig`` and ``RunConfig`` (``repro/config.py``): the port imports
nothing of that package, so the field sets and defaults are repeated here
verbatim (the two packages' configs compare equal field by field); of the
derived quantities only what the port uses is kept.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

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

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        """Mamba1 delta-projection rank."""
        return max(1, math.ceil(self.d_model / 16))

    @property
    def n_ssm_heads(self) -> int:
        """Mamba2 head count."""
        return self.d_inner // self.ssm_head_dim

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    def hybrid_attention_layers(self) -> list[int]:
        """Layer indices at which the shared attention block is applied."""
        if self.family != "hybrid" or self.attn_every <= 0:
            return []
        return [i for i in range(self.n_layers) if i % self.attn_every == 0]

    def param_count(self) -> int:
        """Parameters of the serving families the port carries, leaf for
        leaf as their specs declare them (norm weights included)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2) + d  # + final norm
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head \
            + self.n_heads * self.d_head * d + d
        if self.qk_norm:
            attn += 2 * self.d_head
        mlp = (3 if self.gated_mlp else 2) * d * self.d_ff + d
        di, N, W = self.d_inner, self.ssm_state, self.d_conv
        if self.family == "dense":
            return emb + L * (attn + mlp)
        if self.family == "vlm":      # + mm_proj (repro/models/transformer.py)
            from repro_torch.models.transformer import VISION_D
            return emb + L * (attn + mlp) + VISION_D * d
        if self.family == "encdec":   # repro/models/encdec.py build_specs
            from repro_torch.models.encdec import ENC_SEQ
            pos = (ENC_SEQ + (self.max_position or 32_768)) * d + d
            return (emb + pos + self.n_encoder_layers * (attn + mlp)
                    + L * (2 * attn + mlp))
        if self.family == "ssm":      # Mamba1 block (repro/models/mamba.py)
            R = self.dt_rank
            block = (d + 2 * d * di + W * di + di + di * R + 2 * di * N
                     + R * di + di + di * N + di + di * d)
            return emb + L * block
        if self.family == "hybrid":   # Mamba2 blocks + one shared block
            nh, xbc = self.n_ssm_heads, di + 2 * N
            block = (d + d * di + d * xbc + W * xbc + xbc + d * nh + 3 * nh
                     + di + di * d)
            apps = len(self.hybrid_attention_layers())
            return emb + L * block + attn + mlp + apps * 2 * d * d
        if self.family == "moe":      # repro/models/moe.py build_specs
            nd, f = self.first_k_dense, self.d_expert
            dense = (3 if self.gated_mlp else 2) * d * (
                self.d_ff_dense or self.d_ff) + d
            moe = (d * self.n_experts + 3 * self.n_experts * d * f + d
                   + 3 * d * self.n_shared_experts * f)
            return emb + nd * (attn + dense) + (L - nd) * (attn + moe)
        raise ValueError(f"param_count: unknown family {self.family!r}")


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Run configuration (training/serving hyper-parameters)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip_norm: float = 1.0
    z_loss_coef: float = 1e-4
    schedule: str = "cosine"  # cosine | constant


@dataclass(frozen=True)
class RunConfig:
    """Everything the launcher needs for one job."""

    arch: str
    shape: str = "train_4k"
    optim: OptimConfig = field(default_factory=OptimConfig)
    seed: int = 0

    # distribution
    multi_pod: bool = False
    remat: bool = True
    grad_compression: str = "none"  # none | int8
    microbatches: int = 1           # gradient accumulation steps

    # ad hoc cloud runtime (paper constants, §III)
    host_poll_interval_s: float = 60.0       # client polls server every 1 min
    host_failure_timeout_s: float = 120.0    # failed after 2 min of silence
    guest_probe_interval_s: float = 10.0     # VBoxManage-style guest probe
    snapshot_interval_steps: int = 50        # periodic snapshot cadence
    snapshot_target_failure: float = 0.05    # joint failure bound (≤5%)
    max_snapshot_receivers: int = 8

    def shape_config(self) -> ShapeConfig:
        return SHAPES[self.shape]
