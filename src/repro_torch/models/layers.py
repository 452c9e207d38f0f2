"""Layer primitives of the dense decoder: RoPE, GQA projections, paged
attention, the MLP, embeddings and logits.

Ported from ``repro/models/layers.py``. Results are rounded to bf16 at
exactly the reference's points, so the two packages compute the same
numbers up to summation order: every matrix product takes bf16 operands and
gives a bf16 result, RoPE and the SiLU run in f32 and
cast back, and the logits are a bf16 product cast to f32
(``layers.py:379``). Weights arrive already in bf16 (see ``model_api``).

Page pools are updated in place (``index_put_``): the JAX engine donates
its cache to the jitted step for the same reason (``engine.py:612-613``),
so that a step rewrites the few rows it touches instead of materializing a
second copy of every pool.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.model_api import PSpec

def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., a) @ w (a, ...)``: the einsums of the reference with the
    contracted axis first in ``w`` and the rest of ``w`` kept."""
    out = x @ w.reshape(w.shape[0], -1)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


# ---------------------------------------------------------------------------
# What every layer of one model call shares
# ---------------------------------------------------------------------------


@dataclass
class Rows:
    """Computed once per model call and read by every layer: the RoPE
    tables of the positions being written (``cos``/``sin``, each half
    repeated, broadcast over heads) and where those positions' K/V rows
    land in the page pools (``pid``, ``off``). The reference recomputes
    these in each layer; the values are the same."""

    cos: torch.Tensor | None
    sin: torch.Tensor | None
    pid: torch.Tensor   # page of each written position
    off: torch.Tensor   # row of that position within its page


def rope_tables(positions: torch.Tensor, d: int, theta: float):
    """cos/sin of rotate-half RoPE for ``positions`` (...,), shaped
    (..., 1, d) to broadcast over the heads of (..., H, d)."""
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions[..., None].float() * freqs     # (..., half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return (torch.cat([cos, cos], dim=-1)[..., None, :],
            torch.cat([sin, sin], dim=-1)[..., None, :])


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE in f32, cast back: ``[x1 cos - x2 sin,
    x2 cos + x1 sin]`` (``layers.py:33-45``), as one product with the
    rotated halves ``[-x2, x1]`` — the same f32 operations in the same
    order."""
    half = x.shape[-1] // 2
    xf = x.float()
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def decode_rows(cfg: ModelConfig, positions: torch.Tensor,
                page_table: torch.Tensor, page_size: int) -> Rows:
    """One token per lane at ``positions`` (B,), through the lanes' tables
    (B, max_pages). Inactive lanes point at the scratch page 0."""
    pos = positions.long()
    pid = page_table.long().gather(1, (pos // page_size)[:, None])[:, 0]
    cos = sin = None
    if cfg.rope_theta > 0 and not cfg.learned_positions:
        cos, sin = rope_tables(pos[:, None], cfg.d_head, cfg.rope_theta)
    return Rows(cos, sin, pid, pos % page_size)


def chunk_rows(cfg: ModelConfig, offset: int, n: int,
               page_table: torch.Tensor, page_size: int) -> Rows:
    """Chunk positions ``offset .. offset + n - 1`` through one slot's table
    row (max_pages,). Pad-tail positions past the table's capacity land on
    the scratch page (id 0) instead of clobbering a clamped-index real page
    (``layers.py:271-277``)."""
    max_pages = page_table.shape[0]
    pos = offset + torch.arange(n, device=page_table.device)
    logical = pos // page_size
    pid = torch.where(logical < max_pages,
                      page_table.long()[logical.clamp(max=max_pages - 1)],
                      torch.zeros_like(logical))
    cos = sin = None
    if cfg.rope_theta > 0 and not cfg.learned_positions:
        cos, sin = rope_tables(pos, cfg.d_head, cfg.rope_theta)
    return Rows(cos, sin, pid, pos % page_size)


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig, layers: int) -> dict:
    """Parameter specs for ``layers`` stacked attention blocks."""
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    lead, lax_ = (layers,), ("layers",)
    specs = {
        "wq": PSpec(lead + (d, H, dh), lax_ + ("embed_in", "heads", "head_dim")),
        "wk": PSpec(lead + (d, K, dh), lax_ + ("embed_in", "kv_heads", "head_dim")),
        "wv": PSpec(lead + (d, K, dh), lax_ + ("embed_in", "kv_heads", "head_dim")),
        "wo": PSpec(lead + (H, dh, d), lax_ + ("heads", "head_dim", "embed_out")),
        "ln": PSpec(lead + (d,), lax_ + ("embed",), init="ones"),
    }
    if cfg.qk_norm:
        specs["q_norm"] = PSpec(lead + (dh,), lax_ + ("head_dim",), init="ones")
        specs["k_norm"] = PSpec(lead + (dh,), lax_ + ("head_dim",), init="ones")
    return specs


def _project_qkv(p: nn.Module, x: torch.Tensor, cfg: ModelConfig, rows: Rows):
    """x (B,S,d) -> q (B,S,H,dh), k/v (B,S,K,dh), with qk-norm + RoPE."""
    q = _mm(x, p.wq)
    k = _mm(x, p.wk)
    v = _mm(x, p.wv)
    if cfg.qk_norm:
        q = ops.rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = ops.rmsnorm(k, p.k_norm, cfg.norm_eps)
    if rows.cos is not None:
        q = apply_rope(q, rows.cos, rows.sin)
        k = apply_rope(k, rows.cos, rows.sin)
    return q, k, v


def paged_kv_append(pages: torch.Tensor, new: torch.Tensor,
                    rows: Rows) -> None:
    """Scatter K or V rows ``new`` (N, K, dh) into the shared pool
    (n_pages, P, K, dh) in place, at ``rows.pid``/``rows.off``.

    Write targets are owned by one sequence each (the engine maps written
    positions to private pages); inactive lanes and pad-tail positions
    point at the scratch page 0 and collide harmlessly there."""
    pages.index_put_((rows.pid, rows.off), new.to(pages.dtype))


def attn_decode_paged(
    p: nn.Module,
    x: torch.Tensor,            # (B, 1, d)
    cfg: ModelConfig,
    rows: Rows,                 # decode_rows() of this step
    lengths: torch.Tensor,      # (B,) int32 — positions + 1
    k_pages: torch.Tensor,      # (n_pages, P, K, dh) — updated in place
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # (B, max_pages) int32
) -> torch.Tensor:
    """Single-token attention against a paged cache (``layers.py:170-187``);
    returns (B, 1, d)."""
    q, k, v = _project_qkv(p, x, cfg, rows)
    paged_kv_append(k_pages, k[:, 0], rows)
    paged_kv_append(v_pages, v[:, 0], rows)
    out = ops.paged_decode_attention(q[:, 0], k_pages, v_pages, page_table,
                                     lengths)
    return _mm(out.flatten(1), p.wo.flatten(0, 1))[:, None]


def attn_prefill_chunk(
    p: nn.Module,
    x: torch.Tensor,            # (1, C, d) — one prompt chunk, normalized
    cfg: ModelConfig,
    offset: int,                # absolute position of x[:, 0]
    rows: Rows,                 # chunk_rows() of this chunk
    ctx: torch.Tensor,          # (n_ctx,) the slot's first context pages
    k_pages: torch.Tensor,      # (n_pages, P, K, dh) — updated in place
    v_pages: torch.Tensor,
) -> torch.Tensor:
    """Chunked-prefill attention (``layers.py:245-287``): write the chunk's
    K/V straight into the slot's pages, then attend causally over the
    gathered context pages ``ctx`` — ``[0, offset + C)`` rounded up to whole
    pages. Pages below ``offset`` may be shared prefix pages: they are only
    read here. Returns (1, C, d)."""
    q, k, v = _project_qkv(p, x, cfg, rows)
    paged_kv_append(k_pages, k[0], rows)
    paged_kv_append(v_pages, v[0], rows)
    n_ctx = ctx.shape[0] * k_pages.shape[1]
    k_ctx = k_pages[ctx].reshape(1, n_ctx, *k.shape[2:])
    v_ctx = v_pages[ctx].reshape(1, n_ctx, *v.shape[2:])
    # keys past offset+C sit above the causal diagonal for every real query
    out = ops.attention(q, k_ctx, v_ctx, causal=True, q_offset=offset)
    return _mm(out.flatten(2), p.wo.flatten(0, 1))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, width: int, layers: int) -> dict:
    d = cfg.d_model
    lead, lax_ = (layers,), ("layers",)
    if not cfg.gated_mlp:
        raise NotImplementedError("the port's dense family is gated (SwiGLU)")
    return {
        "wg": PSpec(lead + (d, width), lax_ + ("embed_in", "mlp")),
        "wu": PSpec(lead + (d, width), lax_ + ("embed_in", "mlp")),
        "wd": PSpec(lead + (width, d), lax_ + ("mlp", "embed_out")),
        "ln": PSpec(lead + (d,), lax_ + ("embed",), init="ones"),
    }


def mlp_forward(p: nn.Module, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU; x (..., d) already normalized."""
    g = x @ p.wg
    u = x @ p.wu
    h = F.silu(g.float()).to(g.dtype) * u
    return h @ p.wd


# ---------------------------------------------------------------------------
# Embeddings + logits
# ---------------------------------------------------------------------------


def embed_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    specs = {
        "embedding": PSpec((v, d), ("vocab_gather", "embed_model"), init="normal"),
        "final_ln": PSpec((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = PSpec((d, v), ("embed_in", "vocab"))
    return specs


def embed_lookup(p: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    return p.embedding[tokens.long()]


def logits_last(p: nn.Module, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """h (B, d) -> logits (B, V) in f32, from a bf16 product."""
    if cfg.tie_embeddings:
        return (h @ p.embedding.t()).float()
    return (h @ p.unembed).float()
