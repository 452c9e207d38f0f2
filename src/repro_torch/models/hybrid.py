"""Zamba2-style hybrid (zamba2-1.2b): the dense and the paged serving paths.

Ported from ``repro/models/hybrid.py``: a Mamba2 (SSD) backbone, and one
weight-SHARED attention + MLP block applied before every ``attn_every``-th
layer, each application with its own input projection over
``[hidden ‖ original embedding]`` (``app_proj``, the Zamba wiring).

The caches: the shared block's K/V like any attention cache, one per
application — dense ``att_k``/``att_v`` (n_apps, n_slots, max_seq, K, dh),
or page pools ``att_k_pages``/``att_v_pages`` (n_apps, n_pages, P, K, dh);
the Mamba2 ``conv`` (L, n_slots, W-1, Di+2N) bf16 and ``ssm`` (L, n_slots,
Hs, P, N) f32 states stay dense per slot in both and are updated in place.

Training: :func:`loss_fn` follows the reference's segments
(``repro/models/hybrid.py:205-225``): the shared block before each
segment, recomputed in the backward (the reference's ``jax.checkpoint``),
then the segment's Mamba2 layers (:func:`_mix`, the body :func:`_block`
serves with, from zero states), each rematerialized per ``remat_policy``;
the SSD's gradient is the backward kernel on the card (``ops.ssd``).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as ll
from repro_torch.models.mamba import new_conv_state, silu, slot_state
from repro_torch.models.model_api import (ModelFns, Params, PSpec, Tree,
                                          standard_input_specs,
                                          zeros_from_specs)
from repro_torch.models.transformer import _cast, _remat
from repro_torch.parallel.partition import shard


def mamba2_block_specs(cfg: ModelConfig, layers: int) -> dict:
    d, di, N, W = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.d_conv
    nh = cfg.n_ssm_heads
    lead, lx = (layers,), ("layers",)
    return {
        "ln": PSpec(lead + (d,), lx + ("embed",), init="ones"),
        "wz": PSpec(lead + (d, di), lx + ("embed_in", "inner"), cast=True),
        "w_xbc": PSpec(lead + (d, di + 2 * N), lx + ("embed_in", "inner"),
                       cast=True),
        "conv_w": PSpec(lead + (W, di + 2 * N), lx + ("conv", "inner")),
        "conv_b": PSpec(lead + (di + 2 * N,), lx + ("inner",), init="zeros"),
        "wdt": PSpec(lead + (d, nh), lx + ("embed_in", "ssm_heads"), cast=True),
        "dt_bias": PSpec(lead + (nh,), lx + ("ssm_heads",), init="zeros"),
        "A_log": PSpec(lead + (nh,), lx + ("ssm_heads",), init="small"),
        "D": PSpec(lead + (nh,), lx + ("ssm_heads",), init="ones"),
        "gate_ln": PSpec(lead + (di,), lx + ("inner",), init="ones"),
        "out_proj": PSpec(lead + (di, d), lx + ("inner", "embed_out"),
                          cast=True),
    }


def build_specs(cfg: ModelConfig) -> dict:
    n_apps = len(cfg.hybrid_attention_layers())
    d = cfg.d_model
    return {
        **ll.embed_specs(cfg),
        "layers": mamba2_block_specs(cfg, cfg.n_layers),
        "shared": {
            "attn": ll.attn_specs(cfg),
            "mlp": ll.mlp_specs(cfg, cfg.d_ff),
        },
        # per-application adapter over [hidden ‖ embedding0] (Zamba wiring)
        "app_proj": PSpec((n_apps, 2 * d, d), ("layers", "embed_in", "embed"),
                          cast=True),
    }


class Shared(nn.Module):
    def __init__(self, attn: dict, mlp: dict):
        super().__init__()
        self.attn = Params(**attn)
        self.mlp = Params(**mlp)


class HybridLM(nn.Module):
    """Weights of the hybrid: embedding, one :class:`Params` per Mamba2
    layer, the shared block, the per-application ``app_proj``, final norm
    and (untied) unembedding."""

    def __init__(self, cfg: ModelConfig, tree: Tree):
        super().__init__()
        self.cfg = cfg
        for name, t in tree.items():
            if name not in ("layers", "shared"):
                self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        stacked = tree["layers"]
        self.layers = nn.ModuleList(
            Params(**{k: v[i] for k, v in stacked.items()})
            for i in range(cfg.n_layers))
        self.shared = Shared(tree["shared"]["attn"], tree["shared"]["mlp"])


def segments(cfg: ModelConfig) -> list[tuple[int, int, int]]:
    """``(application index, first layer, end layer)``: the shared block
    runs before the Mamba2 layers ``[first, end)`` of its segment."""
    apps = cfg.hybrid_attention_layers()
    bounds = apps + [cfg.n_layers]
    return [(i, bounds[i], bounds[i + 1]) for i in range(len(apps))]


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def _split_xbc(xbc: torch.Tensor, cfg: ModelConfig):
    di, N = cfg.d_inner, cfg.ssm_state
    return xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]


def _dt(lp: nn.Module, h: torch.Tensor) -> torch.Tensor:
    return F.softplus((h @ lp.wdt).float() + lp.dt_bias.float())


def _gate_out(lp: nn.Module, x: torch.Tensor, y: torch.Tensor,
              z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    y = ops.rmsnorm(y * silu(z), lp.gate_ln, cfg.norm_eps)
    return x + shard(y @ lp.out_proj, "batch", None, None)


def _mix(lp, x: torch.Tensor, cfg: ModelConfig,
         conv_state: torch.Tensor | None = None,
         ssm_state: torch.Tensor | None = None, valid: int | None = None):
    """The Mamba2 block over a sequence (``hybrid.py:68-118``): ``x`` plus
    its mixing, from ``conv_state`` and ``ssm_state`` (zeros when None, as
    the training loss runs it). With ``valid``, pads past the ``valid``
    leading tokens get ``dt = 0``, an identity step of the SSD recurrence.
    Returns ``(out, the conv's input, new ssm state (B, Hs, P, N))``."""
    B, S, _ = x.shape
    h = ops.rmsnorm(x, lp.ln, cfg.norm_eps)
    z = h @ lp.wz
    xbc = shard(h @ lp.w_xbc, "batch", None, "inner")
    pre_conv = xbc
    xbc = silu(ops.causal_conv1d(xbc, lp.conv_w, lp.conv_b, state=conv_state))
    xin, Bm, C = _split_xbc(xbc, cfg)
    dt = _dt(lp, h)
    if valid is not None:
        real = torch.arange(S, device=x.device)[None, :, None] < valid
        dt = torch.where(real, dt, torch.zeros((), device=x.device))
    A = -torch.exp(lp.A_log.float())
    xh = xin.reshape(B, S, cfg.n_ssm_heads, cfg.ssm_head_dim)
    y, hT = ops.ssd(xh, dt.to(xh.dtype), A, Bm, C, lp.D.float(),
                    h0=ssm_state, chunk=cfg.ssm_chunk)
    out = _gate_out(lp, x, y.reshape(B, S, cfg.d_inner), z, cfg)
    return out, pre_conv, hT


def _block(lp: nn.Module, x: torch.Tensor, cfg: ModelConfig,
           conv_state: torch.Tensor, ssm_state: torch.Tensor, valid: int):
    """A prompt chunk through one Mamba2 block; pads past ``valid`` get
    ``dt = 0``, an identity step of the SSD recurrence. Returns ``(out, new
    conv state, new ssm state (B, Hs, P, N))``."""
    out, pre_conv, hT = _mix(lp, x, cfg, conv_state, ssm_state, valid)
    return out, new_conv_state(conv_state, pre_conv, valid), hT


def _block_decode(lp: nn.Module, x: torch.Tensor, cfg: ModelConfig,
                  conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """One token per lane through one Mamba2 block; x (B, 1, d)."""
    B = x.shape[0]
    h = ops.rmsnorm(x, lp.ln, cfg.norm_eps)
    z = h @ lp.wz
    xbc = h @ lp.w_xbc
    new_conv = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)[:, 1:]
    xbc = silu(ops.causal_conv1d(xbc, lp.conv_w, lp.conv_b, state=conv_state))
    xin, Bm, C = _split_xbc(xbc, cfg)
    dt = _dt(lp, h)
    A = -torch.exp(lp.A_log.float())
    y, h_new = ops.ssd_step(
        xin[:, 0].reshape(B, cfg.n_ssm_heads, cfg.ssm_head_dim),
        dt[:, 0].to(xin.dtype), A, Bm[:, 0], C[:, 0], lp.D.float(), ssm_state)
    out = _gate_out(lp, x, y.reshape(B, 1, cfg.d_inner), z, cfg)
    return out, new_conv.to(torch.bfloat16), h_new


def _decode_layers(params: HybridLM, cache: Tree, x: torch.Tensor, a: int,
                   b: int, cfg: ModelConfig) -> torch.Tensor:
    """One token per lane through the Mamba2 layers ``[a, b)``, their
    ``conv``/``ssm`` state rows of every lane updated in place."""
    for i in range(a, b):
        x, cs, ss = _block_decode(params.layers[i], x, cfg, cache["conv"][i],
                                  cache["ssm"][i])
        cache["conv"][i] = cs
        cache["ssm"][i] = ss
    return x


# ---------------------------------------------------------------------------
# Shared attention block
# ---------------------------------------------------------------------------


def _shared_block(sp, proj: torch.Tensor, x: torch.Tensor,
                  x0: torch.Tensor, cfg: ModelConfig, attend) -> torch.Tensor:
    """An application of the weight-shared attention + MLP block ``sp``
    (``hybrid.py:158-196``) through its input projection ``proj`` (its
    ``app_proj`` row): ``attend(p, h)`` is the attention of this call (a
    whole-prompt prefill, a prefill chunk or a decode step) on the
    application's cache."""
    inp = torch.cat([x, x0], dim=-1) @ proj
    h = ops.rmsnorm(inp, sp.attn.ln, cfg.norm_eps)
    inp = inp + attend(sp.attn, h)
    h = ops.rmsnorm(inp, sp.mlp.ln, cfg.norm_eps)
    inp = inp + ll.mlp_forward(sp.mlp, h, cfg)
    return x + inp


# ---------------------------------------------------------------------------
# Dense serving entry points
# ---------------------------------------------------------------------------


def _state_specs(cfg: ModelConfig, batch: int) -> dict:
    """The Mamba2 states of ``batch`` slots, alike in both caches."""
    L, N, W, di = cfg.n_layers, cfg.ssm_state, cfg.d_conv, cfg.d_inner
    nh, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    return {
        "conv": PSpec((L, batch, W - 1, di + 2 * N),
                      ("layers", "batch", "conv", "inner"), init="zeros"),
        "ssm": PSpec((L, batch, nh, P, N),
                     ("layers", "batch", "ssm_heads", None, "state"),
                     init="zeros"),
    }


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    n_apps = len(cfg.hybrid_attention_layers())
    K, dh = cfg.n_kv_heads, cfg.d_head
    seq_axes = ("layers", "batch", "seq_fallback", "kv_heads", "head_dim")
    return {
        **_state_specs(cfg, batch),
        "att_k": PSpec((n_apps, batch, max_seq, K, dh), seq_axes,
                       init="zeros"),
        "att_v": PSpec((n_apps, batch, max_seq, K, dh), seq_axes,
                       init="zeros"),
    }


def prefill_fn(params: HybridLM, batch: dict, cfg: ModelConfig):
    """The whole prompt from a zero state (``hybrid.py:257-280``): each
    application of the shared block attends causally over every position,
    each Mamba2 layer runs one SSD over them. Returns the logits of the
    last position (B, V) f32 and the batch-B cache (the engine's prompts
    are one lane, a cell's ``B``)."""
    x = ll.embed_lookup(params, batch["tokens"])          # (B, S, d)
    x0 = x
    S = x.shape[1]
    rows = ll.dense_rows(cfg, torch.arange(S, device=x.device))
    state = zeros_from_specs(_state_specs(cfg, x.shape[0]), device=x.device)
    att_k, att_v = [], []

    def attend(p, h):
        out, k, v = ll.attn_forward(p, h, cfg, rows)
        att_k.append(k)
        att_v.append(v)
        return out

    for app, a, b in segments(cfg):
        x = _shared_block(params.shared, params.app_proj[app], x, x0, cfg,
                          attend)
        for i in range(a, b):
            x, cs, ss = _block(params.layers[i], x, cfg, state["conv"][i],
                               state["ssm"][i], S)
            state["conv"][i] = cs
            state["ssm"][i] = ss
    x = ops.rmsnorm(x, params.final_ln, cfg.norm_eps)
    cache = {**state, "att_k": torch.stack(att_k),
             "att_v": torch.stack(att_v)}
    return ll.logits_last(params, x[:, -1], cfg), cache


def decode_fn(params: HybridLM, cache: Tree, batch: dict,
              cfg: ModelConfig) -> torch.Tensor:
    """One batched token step over every lane of the dense cache
    (``hybrid.py:283-315``). Returns (B, V) f32."""
    positions = batch["positions"]
    rows = ll.dense_decode_rows(cfg, positions, cache["att_k"].shape[2])
    lengths = (positions + 1).to(torch.int32)
    x = ll.embed_lookup(params, batch["tokens"])          # (B, 1, d)
    x0 = x
    for app, a, b in segments(cfg):
        x = _shared_block(
            params.shared, params.app_proj[app], x, x0, cfg,
            lambda p, h: ll.attn_decode(p, h, cfg, rows, lengths,
                                        cache["att_k"][app],
                                        cache["att_v"][app]))
        x = _decode_layers(params, cache, x, a, b, cfg)
    x = ops.rmsnorm(x, params.final_ln, cfg.norm_eps)
    return ll.logits_last(params, x[:, 0], cfg)


# ---------------------------------------------------------------------------
# Paged serving entry points
# ---------------------------------------------------------------------------


def paged_cache_specs(cfg: ModelConfig, n_slots: int, n_pages: int,
                      page_size: int) -> dict:
    n_apps = len(cfg.hybrid_attention_layers())
    K, dh = cfg.n_kv_heads, cfg.d_head
    page_axes = ("layers", "pages", "page", "kv_heads", "head_dim")
    return {
        **_state_specs(cfg, n_slots),
        "att_k_pages": PSpec((n_apps, n_pages, page_size, K, dh), page_axes,
                             init="zeros"),
        "att_v_pages": PSpec((n_apps, n_pages, page_size, K, dh), page_axes,
                             init="zeros"),
    }


def prefill_chunk_fn(params: HybridLM, cache: Tree, batch: dict,
                     cfg: ModelConfig, *, offset: int) -> torch.Tensor:
    """One prompt chunk into slot ``batch["slot"]`` (``hybrid.py:330-386``):
    the shared block's K/V go into the slot's pages of each application's
    pool, the Mamba2 states into the slot's rows. Returns the logits of the
    last valid token, (1, V) f32."""
    slot, valid = int(batch["slot"]), int(batch["valid"])
    table = batch["page_table"]
    x = ll.embed_lookup(params, batch["tokens"])          # (1, C, d)
    x0 = x
    kp, vp = cache["att_k_pages"], cache["att_v_pages"]
    P = kp.shape[2]
    rows = ll.chunk_rows(cfg, offset, x.shape[1], table, P)
    n_ctx = min((offset + x.shape[1] + P - 1) // P, table.shape[0])
    ctx = table[:n_ctx].long()
    for app, a, b in segments(cfg):
        x = _shared_block(
            params.shared, params.app_proj[app], x, x0, cfg,
            lambda p, h: ll.attn_prefill_chunk(p, h, cfg, offset, rows, ctx,
                                               kp[app], vp[app]))
        for i in range(a, b):
            cs = slot_state(cache, "conv", i, slot, offset)
            ss = slot_state(cache, "ssm", i, slot, offset)
            x, cs, ss = _block(params.layers[i], x, cfg, cs, ss, valid)
            cache["conv"][i, slot:slot + 1] = cs
            cache["ssm"][i, slot:slot + 1] = ss
    x = ops.rmsnorm(x, params.final_ln, cfg.norm_eps)
    return ll.logits_last(params, x[:, valid - 1], cfg)


def decode_paged_fn(params: HybridLM, cache: Tree, batch: dict,
                    cfg: ModelConfig) -> torch.Tensor:
    """One batched token step over every slot (``hybrid.py:389-423``).
    Returns (B, V) f32."""
    positions = batch["positions"]
    table = batch["page_table"]
    x = ll.embed_lookup(params, batch["tokens"])          # (B, 1, d)
    x0 = x
    kp, vp = cache["att_k_pages"], cache["att_v_pages"]
    rows = ll.decode_rows(cfg, positions, table, kp.shape[2])
    lengths = (positions + 1).to(torch.int32)
    for app, a, b in segments(cfg):
        x = _shared_block(
            params.shared, params.app_proj[app], x, x0, cfg,
            lambda p, h: ll.attn_decode_paged(p, h, cfg, rows, lengths,
                                              kp[app], vp[app], table))
        x = _decode_layers(params, cache, x, a, b, cfg)
    x = ops.rmsnorm(x, params.final_ln, cfg.norm_eps)
    return ll.logits_last(params, x[:, 0], cfg)


# ---------------------------------------------------------------------------
# Training: the loss over a layer-stacked f32 tree
# ---------------------------------------------------------------------------


def loss_fn(tree: Tree, batch: dict, cfg: ModelConfig):
    """The language-model loss of ``batch`` (``tokens``, ``labels`` (B, S)
    int) under the layer-stacked f32 tree ``tree`` (``hybrid.py:205-225``):
    before each segment the shared block, its weights and ``app_proj`` row
    cast as the reference's ``ll.cast`` casts them, recomputed whole in the
    backward; then the segment's Mamba2 layers (:func:`_mix` from zero
    states) over views of their slices of the stacked leaves, each
    rematerialized per ``cfg.remat_policy``. Returns (loss, {"ce",
    "z_loss", "tokens"})."""
    specs = build_specs(cfg)
    top = SimpleNamespace(**{k: _cast(v, specs[k]) for k, v in tree.items()
                             if k not in ("layers", "shared", "app_proj")})
    x = ll.embed_lookup(top, batch["tokens"])
    x0 = x
    rows = ll.dense_rows(cfg, torch.arange(x.shape[1], device=x.device))
    shared_names = [(g, k) for g in ("attn", "mlp")
                    for k in sorted(tree["shared"][g])]
    names = sorted(tree["layers"])
    per_layer = list(zip(*(torch.unbind(tree["layers"][k]) for k in names)))
    projs = torch.unbind(tree["app_proj"])

    def shared(x, x0, proj, *leaves):
        groups = {"attn": {}, "mlp": {}}
        for (g, k), t in zip(shared_names, leaves):
            groups[g][k] = _cast(t, specs["shared"][g][k])
        sp = SimpleNamespace(attn=SimpleNamespace(**groups["attn"]),
                             mlp=SimpleNamespace(**groups["mlp"]))
        return _shared_block(sp, _cast(proj, specs["app_proj"]), x, x0, cfg,
                             lambda p, h: ll.attn_forward(p, h, cfg, rows)[0])

    def layer(x, *leaves):
        lp = SimpleNamespace(**{k: _cast(t, specs["layers"][k])
                                for k, t in zip(names, leaves)})
        return _mix(lp, x, cfg)[0]

    shared_body = _remat(shared, cfg, "full")
    body = _remat(layer, cfg)
    shared_leaves = [tree["shared"][g][k] for g, k in shared_names]
    for app, a, b in segments(cfg):
        x = shared_body(x, x0, projs[app], *shared_leaves)
        for leaves in per_layer[a:b]:
            x = body(x, *leaves)
    x = ops.rmsnorm(x, tree["final_ln"], cfg.norm_eps)
    return ll.lm_loss(top, x, batch["labels"], cfg)


def make_model(cfg: ModelConfig) -> ModelFns:
    return ModelFns(
        cfg=cfg,
        param_specs=build_specs(cfg),
        build=functools.partial(HybridLM, cfg),
        cache_specs=functools.partial(cache_specs, cfg),
        prefill=functools.partial(prefill_fn, cfg=cfg),
        decode_step=functools.partial(decode_fn, cfg=cfg),
        paged_cache_specs=functools.partial(paged_cache_specs, cfg),
        prefill_chunk=functools.partial(prefill_chunk_fn, cfg=cfg),
        decode_paged=functools.partial(decode_paged_fn, cfg=cfg),
        # attention K/V pages could be shared, but the Mamba2 recurrent
        # state cannot be skipped: prefix sharing is bookkeeping only
        paged_state=True,
        loss=functools.partial(loss_fn, cfg=cfg),
        input_specs=functools.partial(standard_input_specs, cfg),
    )
