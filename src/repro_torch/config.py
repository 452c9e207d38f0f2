"""Model, input-shape and run configuration.

A copy of the JAX package's ``ModelConfig``, ``ShapeConfig``, ``SHAPES``,
``OptimConfig`` and ``RunConfig`` (``repro/config.py``): the port imports
nothing of that package, so the field sets and defaults are repeated here
verbatim (the two packages' configs compare equal field by field), with the
derived quantities and the cell enumeration the port uses (``iter_cells``
with the reference's skip rule: ``long_500k`` only for the sub-quadratic
families).

Two parameter counts: ``param_counts`` is the reference's analytic count
(``repro/config.py:128-195``, verbatim), total and active a token, which
``launch/roofline.py::model_flops_for`` reads; ``param_count`` counts the
serving families' leaves as their specs declare them, norm weights
included, which the analytic count leaves out.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Any, Iterator

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

    @property
    def uses_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can run the 500k-token decode shape."""
        return self.family in ("ssm", "hybrid")

    def param_counts(self) -> dict[str, float]:
        """The reference's analytic parameter counts, total and active a
        token (``repro/config.py:128-195``): the projections, experts and
        embeddings, without norm weights or biases (``param_count`` counts
        every leaf)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d
        unemb = 0 if self.tie_embeddings else self.vocab_size * d
        per_layer_attn = 0.0
        if self.uses_attention:
            qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
            out = self.n_heads * self.d_head * d
            per_layer_attn = qkv + out

        def mlp_params(width: int) -> float:
            return (3 if self.gated_mlp else 2) * d * width

        total = emb + unemb
        active = emb + unemb
        if self.family == "ssm" or self.family == "hybrid":
            di = self.d_inner
            # Mamba block params (in_proj (x,z), conv, ssm params, out_proj)
            if self.mamba_version == 1:
                ssm = (
                    d * 2 * di
                    + di * self.d_conv
                    + di * (self.dt_rank + 2 * self.ssm_state)
                    + self.dt_rank * di
                    + di * self.ssm_state  # A
                    + di  # D
                    + di * d
                )
            else:
                nh = self.n_ssm_heads
                ssm = (
                    d * (2 * di + 2 * self.ssm_state * nh // max(nh, 1) * nh + nh)
                    + di * self.d_conv
                    + di * d
                )
            if self.family == "ssm":
                total += L * ssm
                active += L * ssm
            else:
                # hybrid: mamba blocks every layer + one SHARED attention+MLP
                # block applied every `attn_every` layers (zamba2: weights shared)
                shared = per_layer_attn + mlp_params(self.d_ff)
                total += L * ssm + shared
                n_apps = len(self.hybrid_attention_layers())
                active += L * ssm + n_apps * shared
        elif self.uses_moe:
            dense_layers = self.first_k_dense
            moe_layers = L - dense_layers
            router = self.n_experts * d
            experts_total = self.n_experts * mlp_params(self.d_expert)
            experts_active = self.moe_top_k * mlp_params(self.d_expert)
            shared = self.n_shared_experts * mlp_params(self.d_expert)
            dense_ff = mlp_params(self.d_ff_dense or self.d_ff)
            total += moe_layers * (per_layer_attn + router + experts_total + shared)
            total += dense_layers * (per_layer_attn + dense_ff)
            active += moe_layers * (per_layer_attn + router + experts_active + shared)
            active += dense_layers * (per_layer_attn + dense_ff)
        elif self.family == "encdec":
            enc = self.n_encoder_layers * (per_layer_attn + mlp_params(self.d_ff))
            dec = L * (2 * per_layer_attn + mlp_params(self.d_ff))  # self+cross attn
            total += enc + dec
            active += enc + dec
        else:  # dense, vlm
            per_layer = per_layer_attn + mlp_params(self.d_ff)
            total += L * per_layer
            active += L * per_layer
        return {"total": float(total), "active": float(active)}

    def hybrid_attention_layers(self) -> list[int]:
        """Layer indices at which the shared attention block is applied."""
        if self.family != "hybrid" or self.attn_every <= 0:
            return []
        return [i for i in range(self.n_layers) if i % self.attn_every == 0]

    def param_count(self) -> int:
        """Parameters of the serving families the port carries, leaf for
        leaf as their specs declare them (norm weights included; the
        analytic :meth:`param_counts` leaves them out)."""
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


def cell_is_valid(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """The reference's skip rule (``repro/config.py:225-229``). Returns
    (valid, reason_if_skipped)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention (skip per assignment)"
    return True, ""


def iter_cells(arch_ids: list[str] | None = None) -> Iterator[tuple[str, str]]:
    """Yield every valid (arch_id, shape_name) cell."""
    from repro_torch.configs import ARCHS

    for arch_id in arch_ids or list(ARCHS):
        cfg = ARCHS[arch_id]
        for shape in SHAPES.values():
            ok, _ = cell_is_valid(cfg, shape)
            if ok:
                yield arch_id, shape.name


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


def asdict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def with_overrides(cfg, **kw):
    return replace(cfg, **kw)
