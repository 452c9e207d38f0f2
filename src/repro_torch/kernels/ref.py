"""Plain PyTorch versions of the kernels on the serving path.

Ported from the JAX package's oracles (``repro/kernels/ref.py:26-131,
207-298``) and its XLA paths (``repro/kernels/ops.py:381-605``), held to
the same conventions: attention tensors are ``(batch, seq, heads,
head_dim)``, GQA repeats each kv head ``H/K`` times on the query side, and
softmax statistics and SSM states are f32 whatever the input type. These
run wherever a tensor lies on the CPU, and on the card they are what each
hand-written kernel is compared with.

The SSM functions: ``selective_scan`` is the sequential oracle
(``ref.py:211-255``), the order the CUDA kernel walks too; ``ssd`` is the
chunked form of the reference's XLA path (``ops.py:519-576``: masked
``c x c`` products within a chunk, a carried ``(P, N)`` state across
chunks), the blocking the CUDA kernel follows. ``causal_conv1d``,
``selective_scan_step`` and ``ssd_step`` have no TPU kernel: they are plain
code on every device (``ops.py:381-405,457-477,579-605``). ``gemm_rows``,
``gemm_rows_grouped`` and ``moe_route`` have no TPU kernel either: the
reference leaves them to XLA; the port's kernels for them exist for row
invariance (``kernels/gemm_rows.py``, ``kernels/moe_route.py``).

One deliberate difference from ``repro.kernels.ref``: a decode lane of
length 0, dense or paged, gives zeros, which is the kernels' contract (the
TPU kernels' ``acc / max(l, 1e-30)`` and the port's;
``tests/test_paged.py:114-120``), where the JAX oracle and the XLA path
(``repro/kernels/ops.py:205-219``) average the masked values (ROADMAP
Queue 3, P2).
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


def paged_verify_attention(
    q: torch.Tensor,           # (B, W, H, D) — a window of W queries a lane
    k_pages: torch.Tensor,     # (n_pages, P, K, D) — shared page pool
    v_pages: torch.Tensor,     # (n_pages, P, K, D)
    page_table: torch.Tensor,  # (B, max_pages) int — physical page ids
    positions: torch.Tensor,   # (B,) int — cache position of query 0
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal multi-query paged decode (``repro/kernels/ref.py:139-169``):
    query ``j`` of lane ``b`` attends over the first ``positions[b] + j +
    1`` cache entries, its own K/V included."""
    b, w, h, d = q.shape
    kh = k_pages.shape[2]
    idx = page_table.long()
    k = _expand_kv(k_pages[idx].reshape(b, -1, kh, d), h)
    v = _expand_kv(v_pages[idx].reshape(b, -1, kh, d), h)
    s = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    kpos = torch.arange(s, device=q.device)[None, None, :]
    qend = (positions.long()[:, None, None]
            + torch.arange(w, device=q.device)[None, :, None] + 1)
    mask = kpos < qend                                        # (B, W, S)
    logits = logits.masked_fill(~mask[:, None], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def paged_cross_attention(
    q: torch.Tensor,           # (B, C, H, D) — C query rows a lane
    k_pages: torch.Tensor,     # (n_pages, P, K, D) — the encoder region pool
    v_pages: torch.Tensor,     # (n_pages, P, K, D)
    page_table: torch.Tensor,  # (B, max_pages) int — physical page ids
    lengths: torch.Tensor,     # (B,) int — valid encoder positions a lane
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Non-causal attention of C query rows a lane over its paged cross
    (encoder-output) region, keys masked at ``lengths[b]``
    (``repro/kernels/ref.py:177-200``): the enc-dec decode step (C = 1)
    and a prefill chunk (C = chunk)."""
    b, c, h, d = q.shape
    kh = k_pages.shape[2]
    idx = page_table.long()
    k = _expand_kv(k_pages[idx].reshape(b, -1, kh, d), h)
    v = _expand_kv(v_pages[idx].reshape(b, -1, kh, d), h)
    s = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Row-invariant matrix product (no TPU kernel: it keeps the verify fold's
# lanes equal to plain decode's on the card, see kernels/gemm_rows.py)
# ---------------------------------------------------------------------------


def gemm_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` with bf16 operands, f32 sums and a bf16
    result: the plain product the paged decode step took before it had a
    kernel of its own."""
    return x @ w


def gemm_rows_grouped(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``buf (E, C, K) @ w (E, K, N)`` with bf16 operands, f32 sums and a
    bf16 result: the reference's expert products (``einsum("ecd,edf->ecf")``,
    ``repro/models/moe.py:81-87``)."""
    return torch.bmm(buf, w)


# ---------------------------------------------------------------------------
# MoE routing (no TPU kernel: the reference routes in XLA,
# ``repro/models/moe.py:209-213``)
# ---------------------------------------------------------------------------


def moe_route(x: torch.Tensor, router: torch.Tensor, k: int, *,
              with_probs: bool = False):
    """Token-choice top-k routing: f32 logits ``x.float() @ router``, a
    softmax, the ``k`` most probable experts (a tie goes to the lower id, as
    ``lax.top_k`` breaks it), their probabilities renormalised by
    ``max(sum, 1e-9)``. ``x (T, d)``, ``router (d, E)``; returns ``weights
    (T, k)`` f32 and ``ids (T, k)`` int32, best first, and with
    ``with_probs`` the softmax ``probs (T, E)`` f32 (the aux loss's).
    Differentiable by autograd: the oracle of ``moe_route_bwd``."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    # a stable descending sort keeps equal probabilities in id order
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :k], ids[:, :k]
    weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    ids = ids.to(torch.int32)
    return (weights, ids, probs) if with_probs else (weights, ids)


def moe_route_bwd(probs: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor, dw: torch.Tensor,
                  dprobs: torch.Tensor | None = None) -> torch.Tensor:
    """The gradient of :func:`moe_route`'s logits in closed form, from its
    ``probs (T, E)``, ``ids (T, k)`` and ``weights (T, k)``, the weights'
    gradient ``dw (T, k)`` and, optionally, the probabilities' own ``dprobs
    (T, E)``: the renormalisation's backward through ``max(s, 1e-9)`` (``s``
    the picks' sum), the picks' gradients scattered into their experts'
    columns (a token's ids are distinct: a scatter, no adds), the softmax's
    backward ``p * (dp - sum p dp)``. Returns ``d_logits (T, E)`` f32, the
    backward kernel's first launch; the products to ``x`` and the router
    follow in :func:`moe_route_grads`."""
    probs = probs.float()
    ids = ids.long()
    s = probs.gather(1, ids).sum(-1, keepdim=True)
    c = (dw.float() * weights.float()).sum(-1, keepdim=True)
    ds = (dw.float() - torch.where(s > 1e-9, c, torch.zeros_like(c))) \
        / s.clamp(min=1e-9)
    dp = torch.zeros_like(probs).scatter(1, ids, ds)
    if dprobs is not None:
        dp = dp + dprobs.float()
    return probs * (dp - (probs * dp).sum(-1, keepdim=True))


def moe_route_grads(x: torch.Tensor, router: torch.Tensor,
                    probs: torch.Tensor, ids: torch.Tensor,
                    weights: torch.Tensor, dw: torch.Tensor,
                    dprobs: torch.Tensor | None = None, *, tile: int = 16,
                    ranks: int = 1,
                    groups: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of :func:`moe_route`'s inputs from the same arguments
    as :func:`moe_route_bwd` and the forward's ``x (T, d)`` and ``router
    (d, E)``: ``dx = d_logits @ router.T`` in f32, cast to x's type, and
    ``d_router = x.float().T @ d_logits`` (f32) summed over the tokens in
    the backward kernel's order: in steps of 16 tokens (one product a step),
    tiles of ``tile`` tokens dealt to ``ranks`` in turn, each rank's steps
    dealt to ``groups`` in turn; a group adds its steps in ascending order,
    a rank its groups' sums in group order, and the ranks' sums are added in
    rank order (``tile``, ``ranks`` and ``groups`` are ``TT``, ``C`` and
    ``G`` of ``kernels/moe_route.py::grads_plan(d, E)``; the defaults add
    the steps in order)."""
    dl = moe_route_bwd(probs, ids, weights, dw, dprobs)
    dx = (dl @ router.float().t()).to(x.dtype)
    (T, d), E = x.shape, dl.shape[1]
    span = tile * ranks
    pad = -T % span
    # (rounds, ranks, steps a group, groups, 16, width)
    shape = (-1, ranks, tile // 16 // groups, groups, 16)
    xs = torch.nn.functional.pad(x.float(), (0, 0, 0, pad)).reshape(
        *shape, d)
    ds = torch.nn.functional.pad(dl, (0, 0, 0, pad)).reshape(*shape, E)
    part = torch.zeros(ranks, groups, d, E, dtype=torch.float32,
                       device=x.device)
    for n in range(xs.shape[0]):
        for i in range(xs.shape[2]):
            part += xs[n, :, i].transpose(-1, -2) @ ds[n, :, i]
    d_router = torch.zeros(d, E, dtype=torch.float32, device=x.device)
    for r in range(ranks):
        rank = torch.zeros(d, E, dtype=torch.float32, device=x.device)
        for g in range(groups):
            rank += part[r, g]
        d_router += rank
    return dx, d_router


# dx under the f32 contract, element by element: an f32-accurate product
# rounded once to bf16 lies within DX_ROUNDING of its value plus DX_SPLIT of
# the magnitudes it sums (the kernel's three split products drop terms of
# at most 3 2^-16 of each product's size; its f32 sums add less)
DX_ROUNDING = 2.0 ** -8
DX_SPLIT = 2.0 ** -13


def moe_route_dx_excess(dx: torch.Tensor, d_logits: torch.Tensor,
                        router: torch.Tensor) -> float:
    """The largest ratio, over the elements of ``dx (T, d)``, of its
    distance from ``d_logits @ router.T`` (in f64) to what one rounding of
    an f32-accurate product allows there: ``DX_ROUNDING |want| + DX_SPLIT
    (|d_logits| @ |router|.T)``. At most 1 when dx keeps the f32 contract;
    a product of bf16-rounded operands reads ~10-40."""
    dl, r = d_logits.double(), router.double()
    want = dl @ r.t()
    allow = DX_ROUNDING * want.abs() + DX_SPLIT * (dl.abs() @ r.abs().t())
    err = (dx.double() - want).abs()
    ratio = torch.where(allow > 0, err / allow.clamp(min=1e-300),
                        torch.where(err > 0, torch.inf, 0.0))
    return float(ratio.max()) if ratio.numel() else 0.0


# ---------------------------------------------------------------------------
# Mamba: causal depthwise conv, selective scan (Mamba1), SSD (Mamba2)
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor | None = None,
                  state: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv along seq in f32, cast back: x (B, S, C), w
    (W, C); ``state`` (B, W-1, C) supplies the left context. Written as W
    shifted products (no cuDNN: its f32 convolutions run in TF32)."""
    S = x.shape[1]
    W = w.shape[0]
    if state is None:
        xp = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    xp = xp.float()
    wf = w.float()
    out = xp[:, 0:S] * wf[0]
    for k in range(1, W):
        out = out + xp[:, k:k + S] * wf[k]
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def selective_scan(
    x: torch.Tensor,    # (B, S, Di)  post-conv activations
    dt: torch.Tensor,   # (B, S, Di)  post-softplus step sizes
    A: torch.Tensor,    # (Di, N)     negative state matrix
    Bm: torch.Tensor,   # (B, S, N)
    C: torch.Tensor,    # (B, S, N)
    D: torch.Tensor,    # (Di,)
    h0: torch.Tensor | None = None,  # (B, Di, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential Mamba1 scan in f32: ``h_t = exp(dt_t A) h_{t-1} +
    (dt_t x_t) B_t``, ``y_t = h_t C_t + D x_t``. Returns ``(y, h_final)``
    with y in ``x.dtype`` and h_final f32 (B, Di, N)."""
    b, s, di = x.shape
    n = A.shape[1]
    xf, dtf = x.float(), dt.float()
    Cf = C.float()
    h = (torch.zeros(b, di, n, dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    dA = torch.exp(dtf[..., None] * A.float()[None, None])     # (B,S,Di,N)
    dBx = (dtf * xf)[..., None] * Bm.float()[:, :, None, :]    # (B,S,Di,N)
    ys = []
    for t in range(s):
        h = dA[:, t] * h + dBx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = (torch.stack(ys, dim=1) if ys else xf.new_zeros(b, 0, di))
    y = y + D.float()[None, None] * xf
    return y.to(x.dtype), h


SCAN_TILE = 256  # the steps of one tile of the scan's kernels


def selective_scan_bwd(x, dt, A, Bm, C, D, h0, dy, dhT=None):
    """The gradients of :func:`selective_scan` for ``dy`` (y's gradient)
    and ``dhT`` (hT's, or None), in closed form: the adjoint of the state,
    ``g_t = dy_t C_t + exp(dt_{t+1} A) g_{t+1}``, walked back from ``dhT``
    tile by tile (``SCAN_TILE`` steps), each tile's states replayed from the
    state entering it, as the backward kernel does. Returns ``(dx, ddt, dA,
    dB, dC, dD, dh0)`` in the types of ``x, dt, A, Bm, C, D`` and f32."""
    b, s, di = x.shape
    n = A.shape[1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf, dyf = Bm.float(), C.float(), dy.float()
    h = (torch.zeros(b, di, n, dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())

    def step(t, h):
        return (torch.exp(dtf[:, t, :, None] * Af) * h
                + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :])

    starts = []   # the state entering each tile
    for t0 in range(0, s, SCAN_TILE):
        starts.append(h)
        for t in range(t0, min(t0 + SCAN_TILE, s)):
            h = step(t, h)
    # u: the adjoint reaching the state entering the step after t
    u = torch.zeros_like(h) if dhT is None else dhT.float()
    dx, ddt = torch.zeros_like(xf), torch.zeros_like(dtf)
    dB, dC = torch.zeros_like(Bf), torch.zeros_like(Cf)
    dA = torch.zeros_like(Af)
    for k in reversed(range(len(starts))):
        t0 = k * SCAN_TILE
        hs = [starts[k]]
        for t in range(t0, min(t0 + SCAN_TILE, s)):
            hs.append(step(t, hs[-1]))
        for t in reversed(range(t0, min(t0 + SCAN_TILE, s))):
            a = torch.exp(dtf[:, t, :, None] * Af)
            g = dyf[:, t, :, None] * Cf[:, t, None, :] + u
            dC[:, t] = torch.einsum("bd,bdn->bn", dyf[:, t], hs[t - t0 + 1])
            dB[:, t] = torch.einsum("bdn,bd->bn", g, dtf[:, t] * xf[:, t])
            s1 = torch.einsum("bdn,bn->bd", g, Bf[:, t])
            w = g * a * hs[t - t0]
            dA += (w * dtf[:, t, :, None]).sum(0)
            dx[:, t] = dtf[:, t] * s1
            ddt[:, t] = xf[:, t] * s1 + (w * Af).sum(-1)
            u = a * g
    dx = dx + D.float() * dyf
    dD = (dyf * xf).sum((0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(Bm.dtype), dC.to(C.dtype), dD.to(D.dtype), u)


def selective_scan_step(x, dt, A, Bm, C, D, h):
    """One decode step of the Mamba1 recurrence: x, dt (B, Di), Bm, C
    (B, N), h (B, Di, N) f32 -> (y (B, Di) in ``x.dtype``, new h)."""
    xf, dtf = x.float(), dt.float()
    dA = torch.exp(dtf[..., None] * A.float()[None])
    dBx = (dtf * xf)[..., None] * Bm.float()[:, None, :]
    h_new = dA * h + dBx
    y = torch.einsum("bdn,bn->bd", h_new, C.float())
    y = y + D.float()[None] * xf
    return y.to(x.dtype), h_new


def _causal_decay(l: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
    """``exp(l_i - l_j)`` for ``j <= i``, zero above the diagonal: the
    exponent is masked to ``-inf`` before ``exp`` (as the kernel forms only
    ``j <= i``), so a long chunk's ``exp(l_i - l_j)``, ``i < j``, never
    overflows to ``inf``, whose product with the mask's zero gradient
    would be NaN under autograd. l (B, c, Hs) -> (B, i, j, Hs)."""
    ldiff = l[:, :, None, :] - l[:, None, :, :]
    return torch.exp(ldiff.masked_fill(~causal[None, :, :, None],
                                       float("-inf")))


def ssd(
    x: torch.Tensor,    # (B, S, Hs, P)
    dt: torch.Tensor,   # (B, S, Hs)  post-softplus
    A: torch.Tensor,    # (Hs,)       negative scalar per head
    Bm: torch.Tensor,   # (B, S, N)   shared across heads
    C: torch.Tensor,    # (B, S, N)
    D: torch.Tensor,    # (Hs,)
    h0: torch.Tensor | None = None,  # (B, Hs, P, N)
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked Mamba2 SSD in f32 (``ops.py:519-576``). Within a chunk of
    ``c`` steps, with ``l`` the inclusive cumsum of ``dt A``:
    ``y_i = sum_{j<=i} exp(l_i - l_j) (C_i . B_j) dt_j x_j
    + exp(l_i) C_i h + D x_i``; across chunks the ``(P, N)`` state carries
    as ``h' = exp(l_last) h + sum_j exp(l_last - l_j) dt_j x_j B_j``.
    A ragged tail is padded with zeros (dt = 0: identity steps)."""
    b, s, hs, p = x.shape
    n = Bm.shape[-1]
    c = max(1, min(chunk, s))
    pad = (-s) % c
    F = torch.nn.functional
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = F.pad(dt.float(), (0, 0, 0, pad))
    Bf = F.pad(Bm.float(), (0, 0, 0, pad))
    Cf = F.pad(C.float(), (0, 0, 0, pad))
    h = (torch.zeros(b, hs, p, n, dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    Af = A.float()
    causal = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, s + pad, c):
        xc, dtc = xf[:, c0:c0 + c], dtf[:, c0:c0 + c]
        Bc, Cc = Bf[:, c0:c0 + c], Cf[:, c0:c0 + c]
        l = torch.cumsum(dtc * Af[None, None], dim=1)         # (B,c,Hs)
        g = torch.einsum("bin,bjn->bij", Cc, Bc)               # (B,c,c)
        decay = _causal_decay(l, causal)                       # (B,i,j,Hs)
        m = g[..., None] * decay * dtc[:, None]                # (B,i,j,Hs)
        y_intra = torch.einsum("bijh,bjhp->bihp", m, xc)
        y_inter = torch.einsum("bin,bhpn,bih->bihp", Cc, h, torch.exp(l))
        rev = torch.exp(l[:, -1:, :] - l)                      # (B,c,Hs)
        s_chunk = torch.einsum("bjh,bjn,bjhp->bhpn", rev * dtc, Bc, xc)
        h = torch.exp(l[:, -1])[:, :, None, None] * h + s_chunk
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :s]
    y = y + D.float()[None, None, :, None] * xf[:, :s]
    return y.to(x.dtype), h


def ssd_bwd(x, dt, A, Bm, C, D, h0, dy, dhT=None, *, chunk: int = 256):
    """The gradients of :func:`ssd` for ``dy`` and ``dhT`` (or None), as
    the transposes of its chunked form, the chunks in reverse order: the
    state's gradient ``dH_c = exp(L_c) dH_{c+1} + sum_i exp(l_i) dy_i^T
    C_i`` (L_c the chunk's last ``l``), and per chunk and head the
    products' transposes (``dx`` from ``M^T dy`` and the exiting state's
    gradient, ``dM = dy x^T`` on the causal triangle giving ``dG`` and so
    ``dB``, ``dC``), ``d(dt)`` through the weights and through ``l``'s
    reverse cumsum, ``dA`` and ``dD``. Returns ``(dx, ddt, dA, dB, dC, dD,
    dh0)`` in the types of ``x, dt, A, Bm, C, D`` and f32."""
    b, s, hs, p = x.shape
    n = Bm.shape[-1]
    c = max(1, min(chunk, s))
    pad = (-s) % c
    F = torch.nn.functional
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dyf = F.pad(dy.float(), (0, 0, 0, 0, 0, pad))
    dtf = F.pad(dt.float(), (0, 0, 0, pad))
    Bf = F.pad(Bm.float(), (0, 0, 0, pad))
    Cf = F.pad(C.float(), (0, 0, 0, pad))
    Af = A.float()
    h = (torch.zeros(b, hs, p, n, dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    causal = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    ls, states = [], []   # each chunk's l and entering state
    for c0 in range(0, s + pad, c):
        dtc, Bc, xc = dtf[:, c0:c0 + c], Bf[:, c0:c0 + c], xf[:, c0:c0 + c]
        l = torch.cumsum(dtc * Af[None, None], dim=1)
        ls.append(l)
        states.append(h)
        rev = torch.exp(l[:, -1:, :] - l)
        h = (torch.exp(l[:, -1])[:, :, None, None] * h
             + torch.einsum("bjh,bjn,bjhp->bhpn", rev * dtc, Bc, xc))
    dH = torch.zeros_like(h) if dhT is None else dhT.float()
    dx, ddt = torch.zeros_like(xf), torch.zeros_like(dtf)
    dB, dC = torch.zeros_like(Bf), torch.zeros_like(Cf)
    dA = torch.zeros_like(Af)
    for k in reversed(range(len(ls))):
        c0 = k * c
        sl = slice(c0, c0 + c)
        xc, dyc, dtc = xf[:, sl], dyf[:, sl], dtf[:, sl]
        Bc, Cc, l, H = Bf[:, sl], Cf[:, sl], ls[k], states[k]
        L = l[:, -1]                                            # (B,Hs)
        g = torch.einsum("bin,bjn->bij", Cc, Bc)
        E = _causal_decay(l, causal)                            # (B,i,j,Hs)
        dM = torch.einsum("bihp,bjhp->bijh", dyc, xc)
        M = g[..., None] * E * dtc[:, None]
        dG = dM * E * dtc[:, None]
        R = dM * M
        # the masked product y_i += sum_j M_ij x_j
        dxc = torch.einsum("bijh,bihp->bjhp", M, dyc)
        dCc = torch.einsum("bijh,bjn->bin", dG, Bc)
        dBc = torch.einsum("bijh,bin->bjn", dG, Cc)
        ddtc = torch.einsum("bijh,bij,bijh->bjh", dM, g, E)
        dl = R.sum(2) - R.sum(1)
        # the carried state's read y_i += exp(l_i) C_i H^T
        eL = torch.exp(l)
        q = torch.einsum("bihp,bhpn,bih->bihn", dyc, H, eL)
        dCc = dCc + q.sum(2)
        dl = dl + torch.einsum("bihn,bin->bih", q, Cc)
        dH_in = torch.einsum("bihp,bin,bih->bhpn", dyc, Cc, eL)
        # the state's update H' = exp(L) H + sum_j w_j x_j B_j^T
        decay = torch.exp(L[:, None] - l)
        w = decay * dtc
        v = torch.einsum("bhpn,bjn->bjhp", dH, Bc)
        dxc = dxc + w[..., None] * v
        dw = (xc * v).sum(-1)
        dBc = dBc + torch.einsum("bjh,bhpn,bjhp->bjn", w, dH, xc)
        ddtc = ddtc + dw * decay
        dl = dl - dw * w
        dl[:, -1] += (dw * w).sum(1) + torch.exp(L) * (dH * H).sum((-1, -2))
        dH = dH_in + torch.exp(L)[:, :, None, None] * dH
        # l = cumsum(dt A): its gradient summed from each step to the end
        rc = torch.flip(torch.cumsum(torch.flip(dl, (1,)), 1), (1,))
        ddt[:, sl] = ddtc + rc * Af
        dA += (rc * dtc).sum((0, 1))
        dx[:, sl], dB[:, sl], dC[:, sl] = dxc, dBc, dCc
    xs = xf[:, :s]
    dx = dx[:, :s] + D.float()[None, None, :, None] * dyf[:, :s]
    dD = (dyf[:, :s] * xs).sum((0, 1, 3))
    return (dx.to(x.dtype), ddt[:, :s].to(dt.dtype), dA.to(A.dtype),
            dB[:, :s].to(Bm.dtype), dC[:, :s].to(C.dtype), dD.to(D.dtype),
            dH)


def ssd_step(x, dt, A, Bm, C, D, h):
    """One decode step of the Mamba2 recurrence: x (B, Hs, P), dt (B, Hs),
    Bm, C (B, N), h (B, Hs, P, N) f32 -> (y (B, Hs, P) in ``x.dtype``,
    new h)."""
    xf, dtf = x.float(), dt.float()
    da = torch.exp(dtf * A.float()[None])                      # (B,Hs)
    dbx = torch.einsum("bh,bhp,bn->bhpn", dtf, xf, Bm.float())
    h_new = da[..., None, None] * h + dbx
    y = torch.einsum("bhpn,bn->bhp", h_new, C.float())
    y = y + D.float()[None, :, None] * xf
    return y.to(x.dtype), h_new
