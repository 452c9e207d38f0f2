"""Mamba1 selective-SSM LM (falcon-mamba-7b): the dense and the paged
serving paths.

Ported from ``repro/models/mamba.py``: Mamba1 blocks with falcon-mamba's
parameter-free RMS normalization of the SSM inputs (dt, B, C). The state of
a slot is O(1) in sequence length, so both caches are the same: ``conv``
(L, n_slots, W-1, Di) bf16 and ``ssm`` (L, n_slots, Di, N) f32, dense per
slot, and no page pool at all. The dense prefill runs the whole prompt
through one scan per layer from a zero state; chunked prefill writes the
slot's rows in place; decode is the ordinary batched step over every slot,
for both engines (``mamba.py:257,261``). Layer ``l`` updates
``cache[...][l]`` in place, as the dense family updates its page pools.

Training: :func:`loss_fn` runs the blocks' mixing (:func:`_mix`, the body
:func:`_block` serves with) from zero states over views of the
layer-stacked f32 tree, each layer rematerialized per ``remat_policy``
(``repro/models/mamba.py:149-160``); the scan's gradient is the backward
kernel on the card (``ops.selective_scan``).
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
from repro_torch.models.model_api import (ModelFns, Params, PSpec, Tree,
                                          zeros_from_specs)
from repro_torch.models.transformer import _cast, _remat


def mamba_block_specs(cfg: ModelConfig, layers: int) -> dict:
    d, di, N, R, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                      cfg.d_conv)
    lead, lx = (layers,), ("layers",)
    return {
        "ln": PSpec(lead + (d,), lx + ("embed",), init="ones"),
        "wx": PSpec(lead + (d, di), lx + ("embed_in", "inner"), cast=True),
        "wz": PSpec(lead + (d, di), lx + ("embed_in", "inner"), cast=True),
        "conv_w": PSpec(lead + (W, di), lx + ("conv", "inner")),
        "conv_b": PSpec(lead + (di,), lx + ("inner",), init="zeros"),
        "wdt": PSpec(lead + (di, R), lx + ("inner", "dt_rank"), cast=True),
        "wB": PSpec(lead + (di, N), lx + ("inner", "state"), cast=True),
        "wC": PSpec(lead + (di, N), lx + ("inner", "state"), cast=True),
        "dt_proj": PSpec(lead + (R, di), lx + ("dt_rank", "inner"), cast=True),
        "dt_bias": PSpec(lead + (di,), lx + ("inner",), init="zeros"),
        "A_log": PSpec(lead + (di, N), lx + ("inner", "state"), init="small"),
        "D": PSpec(lead + (di,), lx + ("inner",), init="ones"),
        "out_proj": PSpec(lead + (di, d), lx + ("inner", "embed_out"),
                          cast=True),
    }


def build_specs(cfg: ModelConfig) -> dict:
    return {**ll.embed_specs(cfg),
            "layers": mamba_block_specs(cfg, cfg.n_layers)}


class MambaLM(nn.Module):
    """Weights of a Mamba1 LM: embedding, one :class:`Params` per layer,
    final norm and (untied) unembedding."""

    def __init__(self, cfg: ModelConfig, tree: Tree):
        super().__init__()
        self.cfg = cfg
        for name, t in tree.items():
            if name != "layers":
                self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        stacked = tree["layers"]
        self.layers = nn.ModuleList(
            Params(**{k: v[i] for k, v in stacked.items()})
            for i in range(cfg.n_layers))


# ---------------------------------------------------------------------------
# Mamba1 block
# ---------------------------------------------------------------------------


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU in f32, cast back (the reference's ``jax.nn.silu`` of an f32
    copy)."""
    return F.silu(x.float()).to(x.dtype)


def _rms(x: torch.Tensor) -> torch.Tensor:
    """Parameter-free RMS normalization (falcon-mamba's dt/B/C norm)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6)).to(x.dtype)


def _ssm_inputs(lp: nn.Module, xin: torch.Tensor):
    """xin (B, S, Di) -> (dt f32, Bm, C, A f32, D f32)."""
    dt_low = _rms(xin @ lp.wdt)
    dt = F.softplus((dt_low @ lp.dt_proj).float() + lp.dt_bias.float())
    Bm = _rms(xin @ lp.wB)
    C = _rms(xin @ lp.wC)
    A = -torch.exp(lp.A_log.float())
    return dt, Bm, C, A, lp.D.float()


def new_conv_state(conv_state: torch.Tensor, pre_conv: torch.Tensor,
                   valid: int) -> torch.Tensor:
    """The last ``W-1`` real rows of ``conv_state ‖ pre_conv[:, :valid]``
    (``repro/models/mamba.py:114-123``): rows ``[valid, valid+W-1)`` of the
    concatenation, so pad rows past ``valid`` never enter the state."""
    W1 = conv_state.shape[1]
    ext = torch.cat([conv_state.to(pre_conv.dtype), pre_conv], dim=1)
    return ext[:, valid:valid + W1].to(torch.bfloat16)


def _mix(lp, x: torch.Tensor, cfg: ModelConfig,
         conv_state: torch.Tensor | None = None,
         ssm_state: torch.Tensor | None = None, valid: int | None = None):
    """The Mamba1 block over a sequence (``mamba.py:82-113``): ``x`` plus
    its mixing, from ``conv_state`` and ``ssm_state`` (zeros when None, as
    the training loss runs it). With ``valid``, pads past the ``valid``
    leading tokens get ``dt = 0``, an identity step of the recurrence.
    Returns ``(out, the conv's input (B, S, Di), new ssm state)``."""
    S = x.shape[1]
    h = ops.rmsnorm(x, lp.ln, cfg.norm_eps)
    xin = h @ lp.wx
    z = h @ lp.wz
    pre_conv = xin
    xin = silu(ops.causal_conv1d(xin, lp.conv_w, lp.conv_b, state=conv_state))
    dt, Bm, C, A, D = _ssm_inputs(lp, xin)
    if valid is not None:
        real = torch.arange(S, device=x.device)[None, :, None] < valid
        dt = torch.where(real, dt, torch.zeros((), device=x.device))
    y, hT = ops.selective_scan(xin, dt.to(xin.dtype), A, Bm, C, D,
                               h0=ssm_state)
    y = y * silu(z)
    return x + y @ lp.out_proj, pre_conv, hT


def _block(lp: nn.Module, x: torch.Tensor, cfg: ModelConfig,
           conv_state: torch.Tensor, ssm_state: torch.Tensor, valid: int):
    """A prompt chunk through one Mamba1 block. ``valid`` leading tokens
    are real: pads get ``dt = 0``, an identity step of the recurrence, so
    the carried state is exactly the state after ``valid`` tokens. Returns
    ``(out, new conv state (B, W-1, Di) bf16, new ssm state (B, Di, N))``."""
    out, pre_conv, hT = _mix(lp, x, cfg, conv_state, ssm_state, valid)
    return out, new_conv_state(conv_state, pre_conv, valid), hT


def _block_decode(lp: nn.Module, x: torch.Tensor, cfg: ModelConfig,
                  conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """One token per lane through one Mamba1 block; x (B, 1, d)."""
    h = ops.rmsnorm(x, lp.ln, cfg.norm_eps)
    xin = h @ lp.wx
    z = h @ lp.wz
    new_conv = torch.cat([conv_state.to(xin.dtype), xin], dim=1)[:, 1:]
    xin = silu(ops.causal_conv1d(xin, lp.conv_w, lp.conv_b, state=conv_state))
    dt, Bm, C, A, D = _ssm_inputs(lp, xin)
    y, h_new = ops.selective_scan_step(xin[:, 0], dt[:, 0].to(xin.dtype), A,
                                       Bm[:, 0], C[:, 0], D, ssm_state)
    y = y[:, None] * silu(z)
    return x + y @ lp.out_proj, new_conv.to(torch.bfloat16), h_new


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    L, di, N, W = cfg.n_layers, cfg.d_inner, cfg.ssm_state, cfg.d_conv
    return {
        "conv": PSpec((L, batch, W - 1, di),
                      ("layers", "batch", "conv", "inner"), init="zeros"),
        "ssm": PSpec((L, batch, di, N),
                     ("layers", "batch", "inner", "state"), init="zeros"),
    }


def paged_cache_specs(cfg: ModelConfig, n_slots: int, n_pages: int,
                      page_size: int) -> dict:
    return cache_specs(cfg, n_slots, 0)


def prefill_fn(params: MambaLM, batch: dict, cfg: ModelConfig):
    """The whole prompt from a zero state (``mamba.py:163-174``): one
    selective scan per layer over every position. Returns the logits of the
    last position (1, V) f32 and the batch-1 cache ``conv``/``ssm``."""
    x = ll.embed_lookup(params, batch["tokens"])          # (1, S, d)
    S = x.shape[1]
    state = zeros_from_specs(cache_specs(cfg, 1, 0), device=x.device)
    for i, lp in enumerate(params.layers):
        x, cs, ss = _block(lp, x, cfg, state["conv"][i], state["ssm"][i], S)
        state["conv"][i] = cs
        state["ssm"][i] = ss
    x = ops.rmsnorm(x, params.final_ln, cfg.norm_eps)
    return ll.logits_last(params, x[:, -1], cfg), state


def slot_state(cache: Tree, name: str, layer: int, slot: int,
               offset: int) -> torch.Tensor:
    """Layer ``layer``'s state of one slot as a (1, ...) batch: zeros at a
    fresh admission (``offset == 0``), whatever the slot last held."""
    row = cache[name][layer, slot:slot + 1]
    return torch.zeros_like(row) if offset == 0 else row


def prefill_chunk_fn(params: MambaLM, cache: Tree, batch: dict,
                     cfg: ModelConfig, *, offset: int) -> torch.Tensor:
    """One prompt chunk into slot ``batch["slot"]`` (``mamba.py:212-249``);
    returns the logits of the last valid token, (1, V) f32."""
    slot, valid = int(batch["slot"]), int(batch["valid"])
    x = ll.embed_lookup(params, batch["tokens"])          # (1, C, d)
    for i, lp in enumerate(params.layers):
        cs = slot_state(cache, "conv", i, slot, offset)
        ss = slot_state(cache, "ssm", i, slot, offset)
        x, cs, ss = _block(lp, x, cfg, cs, ss, valid)
        cache["conv"][i, slot:slot + 1] = cs
        cache["ssm"][i, slot:slot + 1] = ss
    x = ops.rmsnorm(x, params.final_ln, cfg.norm_eps)
    return ll.logits_last(params, x[:, valid - 1], cfg)


def decode_fn(params: MambaLM, cache: Tree, batch: dict,
              cfg: ModelConfig) -> torch.Tensor:
    """One batched token step over every slot (``mamba.py:177-191``), the
    dense and the paged engine's alike. Returns (B, V) f32."""
    x = ll.embed_lookup(params, batch["tokens"])          # (B, 1, d)
    for i, lp in enumerate(params.layers):
        x, cs, ss = _block_decode(lp, x, cfg, cache["conv"][i],
                                  cache["ssm"][i])
        cache["conv"][i] = cs
        cache["ssm"][i] = ss
    x = ops.rmsnorm(x, params.final_ln, cfg.norm_eps)
    return ll.logits_last(params, x[:, 0], cfg)


# ---------------------------------------------------------------------------
# Training: the loss over a layer-stacked f32 tree
# ---------------------------------------------------------------------------


def loss_fn(tree: Tree, batch: dict, cfg: ModelConfig):
    """The language-model loss of ``batch`` (``tokens``, ``labels`` (B, S)
    int) under the layer-stacked f32 tree ``tree`` (``mamba.py:149-160``):
    each layer runs :func:`_mix` from zero states over views of its slice
    of the stacked leaves, the ``cast`` ones in bf16 (the reference's
    ``ll.cast`` at each use), rematerialized per ``cfg.remat_policy`` as the
    dense family's layers are. Returns (loss, {"ce", "z_loss",
    "tokens"})."""
    specs = build_specs(cfg)
    top = SimpleNamespace(**{k: _cast(v, specs[k]) for k, v in tree.items()
                             if k != "layers"})
    x = ll.embed_lookup(top, batch["tokens"])
    names = sorted(tree["layers"])
    # one unbind a leaf: its backward stacks the layers' gradients at once
    per_layer = list(zip(*(torch.unbind(tree["layers"][k]) for k in names)))

    def layer(x, *leaves):
        lp = SimpleNamespace(**{k: _cast(t, specs["layers"][k])
                                for k, t in zip(names, leaves)})
        return _mix(lp, x, cfg)[0]

    body = _remat(layer, cfg)
    for leaves in per_layer:
        x = body(x, *leaves)
    x = ops.rmsnorm(x, tree["final_ln"], cfg.norm_eps)
    return ll.lm_loss(top, x, batch["labels"], cfg)


def make_model(cfg: ModelConfig) -> ModelFns:
    return ModelFns(
        cfg=cfg,
        param_specs=build_specs(cfg),
        build=functools.partial(MambaLM, cfg),
        cache_specs=functools.partial(cache_specs, cfg),
        prefill=functools.partial(prefill_fn, cfg=cfg),
        decode_step=functools.partial(decode_fn, cfg=cfg),
        paged_cache_specs=functools.partial(paged_cache_specs, cfg),
        prefill_chunk=functools.partial(prefill_chunk_fn, cfg=cfg),
        decode_paged=functools.partial(decode_fn, cfg=cfg),
        # recurrent state is not page-addressable: prefix sharing falls
        # back to trie bookkeeping only
        paged_state=True,
        loss=functools.partial(loss_fn, cfg=cfg),
    )
