"""Layer primitives shared by the families: RoPE, GQA projections,
attention over a dense or a paged cache, the MLP, embeddings and logits.

Ported from ``repro/models/layers.py``. Results are rounded to bf16 at
exactly the reference's points, so the two packages compute the same
numbers up to summation order: every matrix product takes bf16 operands and
gives a bf16 result, RoPE, the SiLU and the GELU run in f32
and cast back, and the logits are a bf16 product cast to f32
(``layers.py:379``). Weights arrive already in bf16 (see ``model_api``).

Page pools and dense caches are updated in place (``index_put_``): the JAX
engine donates its cache to the jitted step for the same reason
(``engine.py:612-613``), so that a step rewrites the few rows it touches
instead of materializing a second copy of every pool.

The functions that a paged decode step runs take the step's matrix product
as ``mm`` (``x (..., a)``, ``w (a, n)`` -> ``(..., n)``): ``torch.matmul``
by default, and ``ops.gemm_rows`` on the paged decode entry point, whose
rows do not depend on how many rows share the call (see
``models/transformer.py``).

Activations are laid out by logical axes through
:func:`~repro_torch.parallel.partition.shard` at the reference's points
(``layers.py:82-84, 110, 348, 370, 383``): a no-op without a mesh, a
``redistribute`` under one, where the weights are DTensors and every
product and kernel takes its shards (``kernels/ops.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.model_api import PSpec
from repro_torch.parallel.partition import shard

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _mm(x: torch.Tensor, w: torch.Tensor,
        mm: Matmul = torch.matmul) -> torch.Tensor:
    """``x (..., a) @ w (a, ...)``: the einsums of the reference with the
    contracted axis first in ``w`` and the rest of ``w`` kept. A DTensor
    ``w`` sharded on its first kept axis stays sharded through both
    reshapes (the rules never shard ``head_dim``)."""
    out = mm(x, w.reshape(w.shape[0], -1))
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def _put(cache: torch.Tensor, idx: tuple, new: torch.Tensor) -> None:
    """``cache[idx] = new`` in place, the leading ``len(idx)`` dims indexed
    by tensors of one shape. A DTensor cache (a pool laid out on a mesh)
    takes the write block by block, as ``index_put_`` has no sharding
    rule on every torch: ``new`` is laid out as the cache's kept dims are,
    whole where the cache shards an indexed dim, and there a rank keeps
    only the rows whose index falls in its block (the rules' ``pages``
    fallback)."""
    new = new.to(cache.dtype)
    if not isinstance(cache, DTensor):
        cache.index_put_(idx, new)
        return
    mesh, coord = cache.device_mesh, cache.device_mesh.get_coordinate()
    n, lead = len(idx), idx[0].ndim
    want, lo, block = [], 0, cache.shape[0]
    for i, p in enumerate(cache.placements):
        if isinstance(p, Shard) and p.dim >= n:
            want.append(Shard(p.dim - n + lead))
            continue
        want.append(Replicate())
        if isinstance(p, Shard):
            if p.dim != 0:
                raise ValueError(f"a cache sharded on indexed dim {p.dim}")
            block //= mesh.size(i)
            lo += coord[i] * block
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    new = new.redistribute(mesh, want).to_local()
    idx = [j.full_tensor() if isinstance(j, DTensor) else j for j in idx]
    if block != cache.shape[0]:
        keep = (idx[0] >= lo) & (idx[0] < lo + block)
        idx = [idx[0][keep] - lo] + [j[keep] for j in idx[1:]]
        new = new[keep]
    cache.to_local().index_put_(tuple(idx), new)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host-made input whole as a plain tensor (under a mesh it enters
    replicated): the page arithmetic of a call runs on plain tensors, as
    not every torch has a sharding rule for each of its operations."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``. A DTensor table is read block by block: an index
    the whole of every rank (replicated) picks rows of the local block,
    which keeps the table's placements on its other dims; a table sharded
    on its first dim is gathered whole first."""
    if not isinstance(table, DTensor):
        return table[idx]
    mesh = table.device_mesh
    place = [Replicate() if isinstance(p, Shard) and p.dim == 0 else p
             for p in table.placements]
    if any(isinstance(p, Shard) and p.dim == 0 for p in table.placements):
        table = table.redistribute(mesh, place)
    if isinstance(idx, DTensor):
        idx = idx.full_tensor()
    out = table.to_local()[idx]
    shift = idx.ndim - 1
    return DTensor.from_local(
        out, mesh, [Shard(p.dim + shift) if isinstance(p, Shard) else p
                    for p in place], run_check=False)


# ---------------------------------------------------------------------------
# What every layer of one model call shares
# ---------------------------------------------------------------------------


@dataclass
class Rows:
    """Computed once per model call and read by every layer: the RoPE
    tables of the positions being written (``cos``/``sin``, each half
    repeated, broadcast over heads) and where those positions' K/V rows
    land: ``(pid, off)`` is (page, row within the page) in a page pool, or
    (lane, position) in a dense cache. The reference recomputes these in
    each layer; the values are the same."""

    cos: torch.Tensor | None
    sin: torch.Tensor | None
    pid: torch.Tensor | None = None  # page (paged) or lane (dense)
    off: torch.Tensor | None = None  # row in the page, or position
    # dense decode only: (B, 1, 1), True where the position falls past the
    # cache and the write is dropped; None when no lane's does
    drop: torch.Tensor | None = None


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


def dense_rows(cfg: ModelConfig, positions: torch.Tensor) -> Rows:
    """The RoPE tables of a whole-sequence prefill's ``positions`` (S,);
    its K/V come back from the call instead of landing in a cache."""
    cos = sin = None
    if cfg.rope_theta > 0 and not cfg.learned_positions:
        cos, sin = rope_tables(positions, cfg.d_head, cfg.rope_theta)
    return Rows(cos, sin)


def dense_decode_rows(cfg: ModelConfig, positions: torch.Tensor,
                      max_seq: int) -> Rows:
    """One token per lane at ``positions`` (B,) of a dense ``max_seq``
    cache. A position at or past ``max_seq`` — a lane admitted at a bucket
    of ``max_seq`` decodes once past its cache before the engine retires
    it — has its write dropped, as JAX's scatter drops an out-of-bounds
    update. Whether any lane's is, is read on the host once per step,
    before the step queues any kernel, so the read waits for nothing. Meta
    positions (a dry-run's, which has no values) drop none: a cell's lanes
    decode inside their cache."""
    pos = positions.long()
    drop = pos >= max_seq
    cos = sin = None
    if cfg.rope_theta > 0 and not cfg.learned_positions:
        cos, sin = rope_tables(pos[:, None], cfg.d_head, cfg.rope_theta)
    dropped = pos.device.type != "meta" and bool(drop.any())
    return Rows(cos, sin, torch.arange(pos.shape[0], device=pos.device),
                pos.clamp(max=max_seq - 1),
                drop[:, None, None] if dropped else None)


def decode_rows(cfg: ModelConfig, positions: torch.Tensor,
                page_table: torch.Tensor, page_size: int) -> Rows:
    """One token per lane at ``positions`` (B,), through the lanes' tables
    (B, max_pages). Inactive lanes point at the scratch page 0."""
    pos, page_table = _host(positions).long(), _host(page_table)
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
    page_table = _host(page_table)
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


def attn_specs(cfg: ModelConfig, layers: int | None = None) -> dict:
    """Parameter specs for one (``layers=None``, the hybrid family's shared
    block) or ``layers`` stacked attention blocks."""
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    lead = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)
    specs = {
        "wq": PSpec(lead + (d, H, dh), lax_ + ("embed_in", "heads", "head_dim"),
                    cast=True),
        "wk": PSpec(lead + (d, K, dh), lax_ + ("embed_in", "kv_heads", "head_dim"),
                    cast=True),
        "wv": PSpec(lead + (d, K, dh), lax_ + ("embed_in", "kv_heads", "head_dim"),
                    cast=True),
        "wo": PSpec(lead + (H, dh, d), lax_ + ("heads", "head_dim", "embed_out"),
                    cast=True),
        "ln": PSpec(lead + (d,), lax_ + ("embed",), init="ones"),
    }
    if cfg.qk_norm:
        specs["q_norm"] = PSpec(lead + (dh,), lax_ + ("head_dim",), init="ones")
        specs["k_norm"] = PSpec(lead + (dh,), lax_ + ("head_dim",), init="ones")
    return specs


def _project_qkv(p: nn.Module, x: torch.Tensor, cfg: ModelConfig, rows: Rows,
                 mm: Matmul = torch.matmul):
    """x (B,S,d) -> q (B,S,H,dh), k/v (B,S,K,dh), with qk-norm + RoPE."""
    q = _mm(x, p.wq, mm)
    k = _mm(x, p.wk, mm)
    v = _mm(x, p.wv, mm)
    if cfg.qk_norm:
        q = ops.rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = ops.rmsnorm(k, p.k_norm, cfg.norm_eps)
    if rows.cos is not None:
        q = apply_rope(q, rows.cos, rows.sin)
        k = apply_rope(k, rows.cos, rows.sin)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)
    return q, k, v


def _project_q(p: nn.Module, x: torch.Tensor, cfg: ModelConfig, rows: Rows,
               mm: Matmul = torch.matmul) -> torch.Tensor:
    """The query alone (cross attention, whose K/V come from the encoder):
    x (B,S,d) -> q (B,S,H,dh), with qk-norm and RoPE where the config has
    them."""
    q = _mm(x, p.wq, mm)
    if cfg.qk_norm:
        q = ops.rmsnorm(q, p.q_norm, cfg.norm_eps)
    if rows.cos is not None:
        q = apply_rope(q, rows.cos, rows.sin)
    return q


def attn_forward(p: nn.Module, x: torch.Tensor, cfg: ModelConfig,
                 rows: Rows, *, causal: bool = True,
                 kv: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Full-sequence attention (prefill, ``layers.py:88-110``); x (B, S, d)
    already normalized, ``rows = dense_rows(arange(S))``. With ``kv`` (the
    cross attention's encoder K/V) only q is projected. Returns (out (B, S,
    d), k, v (B, S, K, dh))."""
    if kv is None:
        q, k, v = _project_qkv(p, x, cfg, rows)
    else:
        q, (k, v) = _project_q(p, x, cfg, rows), kv
    out = ops.attention(q, k, v, causal=causal)
    out = _mm(out.flatten(2), p.wo.flatten(0, 1))
    return shard(out, "batch", None, None), k, v


def kv_append(cache: torch.Tensor, new: torch.Tensor, rows: Rows) -> None:
    """Scatter one token per lane into the layer's dense cache (B, S, K,
    dh) in place, at ``rows``' (lane, position) (``layers.py:133-140``);
    new (B, K, dh). A dropped lane's row keeps what it held."""
    new = new.to(cache.dtype)
    if rows.drop is not None:
        new = torch.where(rows.drop, cache[rows.pid, rows.off], new)
    cache.index_put_((rows.pid, rows.off), new)


def attn_decode(
    p: nn.Module,
    x: torch.Tensor,            # (B, 1, d)
    cfg: ModelConfig,
    rows: Rows,                 # dense_decode_rows() of this step
    lengths: torch.Tensor,      # (B,) int32 — positions + 1
    cache_k: torch.Tensor,      # (B, S, K, dh) — updated in place
    cache_v: torch.Tensor,
    *,
    update_cache: bool = True,
) -> torch.Tensor:
    """Single-token attention against a dense cache (``layers.py:113-130``):
    the token's K/V land at its position, then it attends over ``lengths``
    keys. With ``update_cache=False`` (the enc-dec cross read, over the
    encoder's cache at ``enc_len``) nothing is written and only q is
    projected. Returns (B, 1, d)."""
    if update_cache:
        q, k, v = _project_qkv(p, x, cfg, rows)
        kv_append(cache_k, k[:, 0], rows)
        kv_append(cache_v, v[:, 0], rows)
    else:
        q = _project_q(p, x, cfg, rows)
    out = ops.decode_attention(q[:, 0], cache_k, cache_v, lengths)
    return _mm(out.flatten(1), p.wo.flatten(0, 1))[:, None]


def paged_kv_append(pages: torch.Tensor, new: torch.Tensor,
                    rows: Rows) -> None:
    """Scatter K or V rows ``new`` (N, K, dh) into the shared pool
    (n_pages, P, K, dh) in place, at ``rows.pid``/``rows.off``.

    Write targets are owned by one sequence each (the engine maps written
    positions to private pages); inactive lanes and pad-tail positions
    point at the scratch page 0 and collide harmlessly there."""
    _put(pages, (rows.pid, rows.off), new)


def attn_decode_paged(
    p: nn.Module,
    x: torch.Tensor,            # (B, 1, d)
    cfg: ModelConfig,
    rows: Rows,                 # decode_rows() of this step
    lengths: torch.Tensor,      # (B,) int32 — positions + 1
    k_pages: torch.Tensor,      # (n_pages, P, K, dh) — updated in place
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # (B, max_pages) int32
    mm: Matmul = torch.matmul,
) -> torch.Tensor:
    """Single-token attention against a paged cache (``layers.py:170-187``);
    returns (B, 1, d)."""
    q, k, v = _project_qkv(p, x, cfg, rows, mm)
    paged_kv_append(k_pages, k[:, 0], rows)
    paged_kv_append(v_pages, v[:, 0], rows)
    out = ops.paged_decode_attention(q[:, 0], k_pages, v_pages, page_table,
                                     lengths)
    return _mm(out.flatten(1), p.wo.flatten(0, 1), mm)[:, None]


def paged_kv_append_multi(
    pages: torch.Tensor,        # (n_pages, P, K, dh) — updated in place
    new: torch.Tensor,          # (B, W, K, dh)
    page_table: torch.Tensor,   # (B, max_pages) int32
    positions: torch.Tensor,    # (B,) — position of new[:, 0]
) -> None:
    """Scatter a W-token window per sequence into its pages
    (``layers.py:189-214``), the multi-token sibling of
    :func:`paged_kv_append`. Window positions past the table's capacity
    land on the scratch page 0 instead of a clamped-index real page."""
    P = pages.shape[1]
    max_pages = page_table.shape[1]
    W = new.shape[1]
    pos = positions.long()[:, None] + torch.arange(W, device=pages.device)
    logical = pos // P
    pid = torch.where(
        logical < max_pages,
        page_table.long().gather(1, logical.clamp(max=max_pages - 1)),
        torch.zeros_like(logical))
    pages.index_put_((pid, pos % P), new.to(pages.dtype))


def attn_verify_paged(
    p: nn.Module,
    x: torch.Tensor,            # (B, W, d) — the verify window, normalized
    cfg: ModelConfig,
    positions: torch.Tensor,    # (B,) — cache position of x[:, 0]
    k_pages: torch.Tensor,      # (n_pages, P, K, dh) — updated in place
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # (B, max_pages) int32
) -> torch.Tensor:
    """Multi-query attention of a verify window against a paged cache
    (``layers.py:217-242``): the window's K/V is scattered first, then query
    ``j`` attends causally up to its own position. The engine does not call
    it: its verify folds the window into the decode path
    (``transformer.verify_paged_fn``). Returns (B, W, d)."""
    W = x.shape[1]
    pos = positions.long()[:, None] + torch.arange(W, device=x.device)
    cos = sin = None
    if cfg.rope_theta > 0 and not cfg.learned_positions:
        cos, sin = rope_tables(pos, cfg.d_head, cfg.rope_theta)
    q, k, v = _project_qkv(p, x, cfg, Rows(cos, sin))
    paged_kv_append_multi(k_pages, k, page_table, positions)
    paged_kv_append_multi(v_pages, v, page_table, positions)
    out = ops.paged_verify_attention(q, k_pages, v_pages, page_table,
                                     positions)
    return _mm(out.flatten(2), p.wo.flatten(0, 1))


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
    k_ctx = _take(k_pages, ctx).reshape(1, n_ctx, *k.shape[2:])
    v_ctx = _take(v_pages, ctx).reshape(1, n_ctx, *v.shape[2:])
    # keys past offset+C sit above the causal diagonal for every real query
    out = ops.attention(q, k_ctx, v_ctx, causal=True, q_offset=offset)
    return _mm(out.flatten(2), p.wo.flatten(0, 1))


def attn_cross_paged(
    p: nn.Module,
    x: torch.Tensor,            # (B, C, d) — decoder rows, normalized
    cfg: ModelConfig,
    k_pages: torch.Tensor,      # (n_pages, P, K, dh) — the encoder region
    v_pages: torch.Tensor,
    cross_table: torch.Tensor,  # (B, max_cross_pages) int32
    cross_len: torch.Tensor,    # (B,) int32 — valid encoder positions
    mm: Matmul = torch.matmul,
) -> torch.Tensor:
    """Cross attention of decoder rows against the paged encoder region
    (``layers.py:290-318``). Read-only: ``prefill_cross`` wrote the region
    once at admission, so shared regions stay intact. No RoPE on either
    side: the encoder keys are unrotated. Returns (B, C, d)."""
    q = _project_q(p, x, cfg, Rows(None, None), mm)
    out = ops.paged_cross_attention(q, k_pages, v_pages, cross_table,
                                    cross_len)
    return _mm(out.flatten(2), p.wo.flatten(0, 1), mm)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, width: int, layers: int | None = None) -> dict:
    d = cfg.d_model
    lead = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)
    wd = PSpec(lead + (width, d), lax_ + ("mlp", "embed_out"), cast=True)
    ln = PSpec(lead + (d,), lax_ + ("embed",), init="ones")
    if not cfg.gated_mlp:
        return {"wi": PSpec(lead + (d, width), lax_ + ("embed_in", "mlp"),
                            cast=True), "wd": wd, "ln": ln}
    return {
        "wg": PSpec(lead + (d, width), lax_ + ("embed_in", "mlp"), cast=True),
        "wu": PSpec(lead + (d, width), lax_ + ("embed_in", "mlp"), cast=True),
        "wd": wd, "ln": ln,
    }


def mlp_forward(p: nn.Module, x: torch.Tensor, cfg: ModelConfig,
                mm: Matmul = torch.matmul) -> torch.Tensor:
    """SwiGLU, or the GELU MLP where ``cfg.gated_mlp`` is off; x (..., d)
    already normalized. The GELU is ``jax.nn.gelu``'s default, the tanh
    approximation, in f32 and cast back (``layers.py:341-343``)."""
    if not cfg.gated_mlp:
        h = mm(x, p.wi)
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    else:
        g = mm(x, p.wg)
        u = mm(x, p.wu)
        h = F.silu(g.float()).to(g.dtype) * u
    h = shard(h, "batch", None, "mlp") if h.ndim == 3 else h
    return mm(h, p.wd)


# ---------------------------------------------------------------------------
# Embeddings + logits
# ---------------------------------------------------------------------------


def embed_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    specs = {
        "embedding": PSpec((v, d), ("vocab_gather", "embed_model"),
                           init="normal", cast=True),
        "final_ln": PSpec((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = PSpec((d, v), ("embed_in", "vocab"), cast=True)
    return specs


def embed_lookup(p: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    x = _take(p.embedding, tokens.long())
    return shard(x, "batch", None, None) if x.ndim == 3 else x


def logits_last(p: nn.Module, h: torch.Tensor, cfg: ModelConfig,
                mm: Matmul = torch.matmul) -> torch.Tensor:
    """h (B, d) -> logits (B, V) in f32, from a bf16 product."""
    if cfg.tie_embeddings:
        return mm(h, p.embedding.t()).float()
    return mm(h, p.unembed).float()


def _chunk_loss(hc: torch.Tensor, lc: torch.Tensor, w: torch.Tensor,
                tied: bool):
    """One chunk of :func:`lm_loss`: the sums of its masked nll and
    squared log-normalizer, and its count of labels."""
    logits = (hc @ (w.t() if tied else w)).float()          # (B, c, V) f32
    logits = shard(logits, "batch", None, "vocab")
    lse = torch.logsumexp(logits, dim=-1)                   # (B, c)
    mask = lc >= 0
    lbl = torch.where(mask, lc, torch.zeros_like(lc)).long()
    gold = logits.gather(-1, lbl[..., None])[..., 0]
    nll = torch.where(mask, lse - gold, torch.zeros_like(lse))
    z = torch.where(mask, torch.square(lse), torch.zeros_like(lse))
    return nll.sum(), z.sum(), mask.sum(dtype=torch.int32)


def lm_loss(p, hidden: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
            *, chunk: int = 512, z_loss_coef: float = 1e-4):
    """Chunked cross entropy with z-loss (``layers.py:387-428``): the
    logits of ``chunk`` tokens at a time, a bf16 product cast to f32 as
    :func:`logits_last` computes them; labels of -1 are masked out.
    ``hidden`` (B, S, d) bf16, final norm applied; ``labels`` (B, S) int.
    Each chunk runs under ``torch.utils.checkpoint``, so that its (B, c, V)
    logits are recomputed in the backward rather than kept: the (B, S, V)
    tensor never exists, as under the reference's scan. Returns (loss,
    {"ce", "z_loss", "tokens"})."""
    from torch.utils.checkpoint import checkpoint

    b, s, d = hidden.shape
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    w = p.embedding if cfg.tie_embeddings else p.unembed
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    zt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for i in range(0, s + pad, c):
        nll, z, n = checkpoint(_chunk_loss, hidden[:, i:i + c],
                               labels[:, i:i + c], w, cfg.tie_embeddings,
                               use_reentrant=False)
        tot, zt, cnt = tot + nll, zt + z, cnt + n
    denom = torch.clamp(cnt, min=1).float()
    ce = tot / denom
    z = zt / denom
    loss = ce + z_loss_coef * z
    return loss, {"ce": ce, "z_loss": z, "tokens": denom}
