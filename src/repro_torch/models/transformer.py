"""Dense decoder-only transformer (qwen3, smollm): the paged serving path.

Ported from ``repro/models/transformer.py``. The reference's ``lax.scan``
over layer-stacked parameters becomes a loop over per-layer modules; the
page pools stay layer-stacked ``(L, n_pages, P, K, dh)`` tensors, and layer
``l`` updates its slice ``pools[l]`` in place.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as ll
from repro_torch.models.model_api import ModelFns, Params, PSpec, Tree


def build_specs(cfg: ModelConfig) -> dict:
    L = cfg.n_layers
    return {
        **ll.embed_specs(cfg),
        "layers": {
            "attn": ll.attn_specs(cfg, layers=L),
            "mlp": ll.mlp_specs(cfg, cfg.d_ff, layers=L),
        },
    }


class Block(nn.Module):
    def __init__(self, attn: dict, mlp: dict):
        super().__init__()
        self.attn = Params(**attn)
        self.mlp = Params(**mlp)


class DenseLM(nn.Module):
    """Weights of a dense decoder: embedding, one :class:`Block` per layer,
    final norm and (untied) unembedding."""

    def __init__(self, cfg: ModelConfig, tree: Tree):
        super().__init__()
        self.cfg = cfg
        top = {k: v for k, v in tree.items() if k != "layers"}
        for name, t in top.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        stacked = tree["layers"]
        self.layers = nn.ModuleList(
            Block({k: v[i] for k, v in stacked["attn"].items()},
                  {k: v[i] for k, v in stacked["mlp"].items()})
            for i in range(cfg.n_layers)
        )


def paged_cache_specs(cfg: ModelConfig, n_slots: int, n_pages: int,
                      page_size: int) -> dict:
    L, K, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    axes = ("layers", "pages", "page", "kv_heads", "head_dim")
    return {
        "k_pages": PSpec((L, n_pages, page_size, K, dh), axes, init="zeros"),
        "v_pages": PSpec((L, n_pages, page_size, K, dh), axes, init="zeros"),
    }


def prefill_chunk_fn(params: DenseLM, cache: Tree, batch: dict,
                     cfg: ModelConfig, *, offset: int) -> torch.Tensor:
    """One prompt chunk at absolute position ``offset`` (``transformer.py:
    186-223``): K/V written into the slot's pages, logits taken at the true
    final token (``valid - 1`` within the chunk). Returns (1, V) f32."""
    table = batch["page_table"]
    x = ll.embed_lookup(params, batch["tokens"])          # (1, C, d)
    P = cache["k_pages"].shape[2]
    rows = ll.chunk_rows(cfg, offset, x.shape[1], table, P)
    n_ctx = min((offset + x.shape[1] + P - 1) // P, table.shape[0])
    ctx = table[:n_ctx].long()
    for lp, kp, vp in zip(params.layers, cache["k_pages"], cache["v_pages"]):
        h = ops.rmsnorm(x, lp.attn.ln, cfg.norm_eps)
        y = x + ll.attn_prefill_chunk(lp.attn, h, cfg, offset, rows, ctx,
                                      kp, vp)
        h = ops.rmsnorm(y, lp.mlp.ln, cfg.norm_eps)
        x = y + ll.mlp_forward(lp.mlp, h, cfg)
    x = ops.rmsnorm(x, params.final_ln, cfg.norm_eps)
    valid = int(batch["valid"])
    return ll.logits_last(params, x[:, valid - 1], cfg)


def decode_paged_fn(params: DenseLM, cache: Tree, batch: dict,
                    cfg: ModelConfig) -> torch.Tensor:
    """One batched token step (``transformer.py:226-246``). Returns (B, V)."""
    positions = batch["positions"]
    table = batch["page_table"]
    x = ll.embed_lookup(params, batch["tokens"])          # (B, 1, d)
    rows = ll.decode_rows(cfg, positions, table, cache["k_pages"].shape[2])
    lengths = (positions + 1).to(torch.int32)
    for lp, kp, vp in zip(params.layers, cache["k_pages"], cache["v_pages"]):
        h = ops.rmsnorm(x, lp.attn.ln, cfg.norm_eps)
        y = x + ll.attn_decode_paged(lp.attn, h, cfg, rows, lengths, kp, vp,
                                     table)
        h = ops.rmsnorm(y, lp.mlp.ln, cfg.norm_eps)
        x = y + ll.mlp_forward(lp.mlp, h, cfg)
    x = ops.rmsnorm(x, params.final_ln, cfg.norm_eps)
    return ll.logits_last(params, x[:, 0], cfg)


def make_model(cfg: ModelConfig) -> ModelFns:
    return ModelFns(
        cfg=cfg,
        param_specs=build_specs(cfg),
        build=functools.partial(DenseLM, cfg),
        paged_cache_specs=functools.partial(paged_cache_specs, cfg),
        prefill_chunk=functools.partial(prefill_chunk_fn, cfg=cfg),
        decode_paged=functools.partial(decode_paged_fn, cfg=cfg),
    )
