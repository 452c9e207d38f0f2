"""Plain PyTorch versions of the kernels on the serving path.

Ported from the JAX package's oracles (``repro/kernels/ref.py:26-131``) and
held to the same conventions: attention tensors are ``(batch, seq, heads,
head_dim)``, GQA repeats each kv head ``H/K`` times on the query side, and
softmax statistics are f32 whatever the input type. These run wherever a
tensor lies on the CPU, and on the card they are what each hand-written
kernel is compared with.

One deliberate difference from ``repro.kernels.ref``: a paged-decode lane of
length 0 gives zeros, which is the kernels' contract (the TPU kernel's and
the port's; ``tests/test_paged.py:114-120``), where the JAX oracle averages
the masked values.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large-but-finite; avoids NaN from (-inf) - (-inf)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS-normalize the trailing dim of ``x`` in f32 and scale by ``w``."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, K, D) -> (B, S, H, D) by repeating each kv head H/K times."""
    rep = n_heads // k.shape[2]
    return k if rep == 1 else k.repeat_interleave(rep, dim=2)


def attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, K, D)
    v: torch.Tensor,  # (B, Sk, K, D)
    *,
    causal: bool = True,
    q_offset: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Multi-head (GQA) attention; ``q_offset`` is the absolute position of
    ``q[:, 0]`` relative to ``k[:, 0]``."""
    _, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(~(kpos <= qpos), NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,        # (B, H, D) — one new token per sequence
    k: torch.Tensor,        # (B, S, K, D) — cache (garbage past length)
    v: torch.Tensor,        # (B, S, K, D)
    lengths: torch.Tensor,  # (B,) int — valid cache positions per sequence
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Masked attention of one token over a dense cache; a lane of length
    0 gives zeros."""
    _, h, d = q.shape
    s = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    logits = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * scale
    mask = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    logits = logits.masked_fill(~mask[:, None, :], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, v.float())
    out = out.masked_fill((lengths == 0)[:, None, None], 0.0)
    return out.to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,           # (B, H, D)
    k_pages: torch.Tensor,     # (n_pages, P, K, D) — shared page pool
    v_pages: torch.Tensor,     # (n_pages, P, K, D)
    page_table: torch.Tensor,  # (B, max_pages) int — physical page ids
    lengths: torch.Tensor,     # (B,) int — valid tokens per sequence
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Gather each sequence's pages through its table into a dense cache,
    then run :func:`decode_attention`; entries past ``lengths[b]`` are
    masked."""
    b, _, d = q.shape
    kh = k_pages.shape[2]
    idx = page_table.long()
    k = k_pages[idx].reshape(b, -1, kh, d)
    v = v_pages[idx].reshape(b, -1, kh, d)
    return decode_attention(q, k, v, lengths, scale=scale)
