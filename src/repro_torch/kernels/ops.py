"""Kernel dispatch for the serving path.

A tensor on the CPU goes to the plain PyTorch version (``ref.py``). A CUDA
tensor launches the hand-written kernel, and a kernel that refuses its input
raises: nothing falls back. ``use_backend("plain")`` is an explicit, scoped
override that sends CUDA tensors to the plain versions too, mirroring the JAX
package's ``use_backend`` (``repro/kernels/ops.py:53-61``); only tests and
the comparison phase of ``chip_smoke.py`` enter it, never the engine or the
CLI.

Each kernel wrapper counts its own launches (``<wrapper>.launches``); this
module counts the calls that went to a plain version, so a run can show
which path it took. ``paged_verify_attention`` and ``paged_cross_attention``
are no kernels of their own: on the card each folds its query rows into the
paged decode kernel (``_fold``), the verify window into its batch as the TPU
path does (``repro/kernels/ops.py:285-301``), a cross read's rows eight to a
lane into its GQA groups, and counts there. ``gemm_rows`` has
no TPU kernel: it is the paged decode step's row-invariant product
(``kernels/gemm_rows.py``); nor have ``gemm_rows_grouped``, its form over
all experts of an MoE layer, and ``moe_route``, the MoE router
(``kernels/moe_route.py``). ``causal_conv1d``, ``selective_scan_step`` and
``ssd_step`` have no TPU kernel (the JAX package runs them through XLA on
every backend): they are plain code on every device, and not counted.

Training differentiates ``attention``, ``rmsnorm``, ``selective_scan``,
``ssd`` and ``moe_route``. When an input needs a gradient, a CUDA tensor
goes through the ``torch.autograd.Function`` of the kernel
(``flash_attention.FlashAttention``, ``rmsnorm.RMSNorm``,
``selective_scan.SelectiveScan``, ``ssd.SSD``, ``moe_route.MoeRoute``),
whose backward is a hand-written kernel too (``flash_attention_bwd``,
``rmsnorm_bwd``, ``selective_scan_bwd``, ``ssd_bwd``, ``moe_route_bwd``,
counted in ``counts()``); a CPU tensor, or any under
``use_backend("plain")``, goes to the plain version and autograd
differentiates that: the oracle of the backward kernels. Such a call counts
a plain call of the backward too. A call that needs no gradient (serving)
takes the path it always took.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gemm_rows as _gemm
from repro_torch.kernels import moe_route as _route
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import selective_scan as _scan
from repro_torch.kernels import ssd as _ssd

_BACKENDS = ("kernel", "plain")
_BACKEND: contextvars.ContextVar[str] = contextvars.ContextVar(
    "repro_torch_kernel_backend", default="kernel"
)

KERNELS = {
    "rmsnorm": _rmsnorm.rmsnorm,
    "paged_decode_attention": _paged.paged_decode_attention,
    "decode_attention": _decode.decode_attention,
    "flash_attention": _flash.flash_attention,
    "selective_scan": _scan.selective_scan,
    "ssd": _ssd.ssd,
    "gemm_rows": _gemm.gemm_rows,
    "moe_route": _route.moe_route,
    "gemm_rows_grouped": _gemm.gemm_rows_grouped,
    "flash_attention_bwd": _flash.flash_attention_bwd,
    "rmsnorm_bwd": _rmsnorm.rmsnorm_bwd,
    "selective_scan_bwd": _scan.selective_scan_bwd,
    "ssd_bwd": _ssd.ssd_bwd,
    "moe_route_bwd": _route.moe_route_bwd,
}
plain_calls = {name: 0 for name in KERNELS}


def current_backend() -> str:
    """The backend of the current scope ("kernel" or "plain")."""
    return _BACKEND.get()


@contextlib.contextmanager
def use_backend(name: str):
    """Scoped backend choice: "kernel" (the default) or "plain"."""
    if name not in _BACKENDS:
        raise ValueError(f"backend {name!r}: expected one of {_BACKENDS}")
    tok = _BACKEND.set(name)
    try:
        yield
    finally:
        _BACKEND.reset(tok)


def counts() -> dict[str, dict[str, int]]:
    """Kernel launches and plain-version calls so far, per kernel."""
    return {name: {"launches": fn.launches, "plain": plain_calls[name]}
            for name, fn in KERNELS.items()}


def reset_counts() -> None:
    for name, fn in KERNELS.items():
        fn.launches = 0
        plain_calls[name] = 0


def _plain(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu" or _BACKEND.get() == "plain":
        plain_calls[name] += 1
        return True
    return False


def _needs_grad(*ts: torch.Tensor | None) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    grad = _needs_grad(x, w)
    if _plain(x, "rmsnorm"):
        if grad:
            plain_calls["rmsnorm_bwd"] += 1
        return ref.rmsnorm(x, w, eps)
    if grad:
        return _rmsnorm.RMSNorm.apply(x, w, eps)
    return _rmsnorm.rmsnorm(x, w, eps)


def attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, K, D)
    v: torch.Tensor,  # (B, Sk, K, D)
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    grad = _needs_grad(q, k, v)
    if _plain(q, "flash_attention"):
        if grad:
            plain_calls["flash_attention_bwd"] += 1
        return ref.attention(q, k, v, causal=causal, q_offset=q_offset)
    if grad:
        return _flash.FlashAttention.apply(q, k, v, causal, q_offset)
    return _flash.flash_attention(q, k, v, causal=causal, q_offset=q_offset)


def decode_attention(
    q: torch.Tensor,        # (B, H, D)
    k: torch.Tensor,        # (B, S, K, D)
    v: torch.Tensor,        # (B, S, K, D)
    lengths: torch.Tensor,  # (B,) int32
) -> torch.Tensor:
    """One token per lane over a dense cache; zeros for a lane of length 0,
    as the TPU kernel gives (``ref.decode_attention``)."""
    if _plain(q, "decode_attention"):
        return ref.decode_attention(q, k, v, lengths)
    return _decode.decode_attention(q, k, v, lengths)


def paged_decode_attention(
    q: torch.Tensor,           # (B, H, D)
    k_pages: torch.Tensor,     # (n_pages, P, K, D)
    v_pages: torch.Tensor,     # (n_pages, P, K, D)
    page_table: torch.Tensor,  # (B, max_pages) int32
    lengths: torch.Tensor,     # (B,) int32
) -> torch.Tensor:
    if _plain(q, "paged_decode_attention"):
        return ref.paged_decode_attention(q, k_pages, v_pages, page_table,
                                          lengths)
    return _paged.paged_decode_attention(q, k_pages, v_pages, page_table,
                                         lengths)


def _fold(q, k_pages, v_pages, page_table, lengths, *, rows: int = 1,
          run=None) -> torch.Tensor:
    """``q (B, W, H, D)`` through the paged decode kernel (or ``run``, a
    function of its arguments) as ``B * W / rows`` folded lanes: each
    ``rows`` consecutive query rows of a lane, which share a length, stack
    into the GQA group of every kv head (``rows * H / K`` query heads a
    block, at most ``_paged.MAX_GROUP``), and each folded lane takes its
    lane's table row. ``lengths (B, W / rows)`` per folded lane; ``W`` a
    multiple of ``rows``. A row's arithmetic is the same wherever it sits in
    the group, so each is bitwise a one-lane decode at its length."""
    B, W, H, D = q.shape
    K = k_pages.shape[2]
    n = W // rows
    qf = (q.reshape(B, n, rows, K, H // K, D).transpose(2, 3)
          .reshape(B * n, K * rows * (H // K), D))
    table = page_table if n == 1 else page_table.repeat_interleave(n, dim=0)
    out = (run or _paged.paged_decode_attention)(
        qf.contiguous(), k_pages, v_pages, table.contiguous(),
        lengths.reshape(-1).to(torch.int32).contiguous())
    return (out.reshape(B, n, K, rows, H // K, D).transpose(2, 3)
            .reshape(B, W, H, D))


def paged_verify_attention(
    q: torch.Tensor,           # (B, W, H, D) — a window of W queries a lane
    k_pages: torch.Tensor,     # (n_pages, P, K, D)
    v_pages: torch.Tensor,     # (n_pages, P, K, D)
    page_table: torch.Tensor,  # (B, max_pages) int32
    positions: torch.Tensor,   # (B,) int32 — cache position of query 0
) -> torch.Tensor:
    """Causal multi-query paged decode for speculative verification: query
    ``j`` of lane ``b`` attends over ``positions[b] + j + 1`` entries. On the
    card the window folds into the batch of the paged decode kernel, lengths
    ``positions[:, None] + arange(W) + 1`` and the table repeated W times
    (``repro/kernels/ops.py:285-301``)."""
    if _plain(q, "paged_decode_attention"):
        return ref.paged_verify_attention(q, k_pages, v_pages, page_table,
                                          positions)
    W = q.shape[1]
    return _fold(q, k_pages, v_pages, page_table,
                 positions[:, None] + torch.arange(W, device=q.device) + 1)


def cross_rows(C: int, H: int, K: int) -> int:
    """Query rows of a cross read that share one folded lane: as many as
    fill the kernel's group (whisper's MHA: 8), never more than C."""
    return max(1, min(_paged.MAX_GROUP // (H // K), C))


def _cross_fold(q, k_pages, v_pages, page_table, lengths,
                run=None) -> torch.Tensor:
    """The card's route of :func:`paged_cross_attention`: every row of a
    lane has the lane's length, so ``cross_rows`` of them share a folded
    lane (C padded with zero rows to a multiple). ``run`` stands in for the
    kernel (a test's plain twin on the CPU)."""
    B, C, H, _ = q.shape
    rows = cross_rows(C, H, k_pages.shape[2])
    pad = -C % rows
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    out = _fold(q, k_pages, v_pages, page_table,
                lengths[:, None].expand(B, (C + pad) // rows), rows=rows,
                run=run)
    return out[:, :C] if pad else out


def paged_cross_attention(
    q: torch.Tensor,           # (B, C, H, D) — C query rows a lane
    k_pages: torch.Tensor,     # (n_pages, P, K, D) — the encoder region pool
    v_pages: torch.Tensor,     # (n_pages, P, K, D)
    page_table: torch.Tensor,  # (B, max_cross_pages) int32
    lengths: torch.Tensor,     # (B,) int32 — valid encoder positions
) -> torch.Tensor:
    """Non-causal attention of a query block over a paged cross-attention
    (encoder-output) region, keys masked at ``lengths``. On the card the C
    query rows fold into the paged decode kernel (``_cross_fold``), and
    count there: ``cross_rows`` rows a folded lane as the rows of its kv
    heads' groups, so each region segment is read once for that many rows
    rather than once a row, as the TPU path's one row a lane does
    (``repro/kernels/ops.py:323-349``). At C = 1 the lanes go as they
    are."""
    if _plain(q, "paged_decode_attention"):
        return ref.paged_cross_attention(q, k_pages, v_pages, page_table,
                                         lengths)
    return _cross_fold(q, k_pages, v_pages, page_table, lengths)


def gemm_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)``, bf16 with f32 sums, each row's bits
    independent of the other rows of the call (the paged decode step's
    product)."""
    if _plain(x, "gemm_rows"):
        return ref.gemm_rows(x, w)
    return _gemm.gemm_rows(x, w)


def gemm_rows_grouped(buf: torch.Tensor, w: torch.Tensor,
                      counts: torch.Tensor | None = None) -> torch.Tensor:
    """``buf (E, C, K) @ w (E, K, N)``, bf16 with f32 sums, each (expert,
    row)'s bits independent of C, of its rank and of the other experts (the
    MoE paged decode step's routed experts). On the card, rows of expert e
    at or past ``counts[e]`` are left unwritten; the plain version computes
    every row."""
    if _plain(buf, "gemm_rows_grouped"):
        return ref.gemm_rows_grouped(buf, w)
    return _gemm.gemm_rows_grouped(buf, w, counts)


def moe_route(x: torch.Tensor, router: torch.Tensor, k: int, *,
              with_probs: bool = False):
    """``x (T, d)`` bf16 through the f32 ``router (d, E)``: ``weights (T,
    k)`` f32 and ``ids (T, k)`` int32 of each token's top-k experts, a
    token's result independent of the others; with ``with_probs`` also the
    softmax ``probs (T, E)`` f32 (training's aux loss)."""
    grad = _needs_grad(x, router)
    if _plain(x, "moe_route"):
        if grad:
            plain_calls["moe_route_bwd"] += 1
        return ref.moe_route(x, router, k, with_probs=with_probs)
    if grad:
        weights, ids, probs = _route.MoeRoute.apply(x, router, k)
        return (weights, ids, probs) if with_probs else (weights, ids)
    return _route.moe_route(x, router, k, with_probs=with_probs)


def selective_scan(
    x: torch.Tensor,    # (B, S, Di)
    dt: torch.Tensor,   # (B, S, Di)
    A: torch.Tensor,    # (Di, N) f32
    Bm: torch.Tensor,   # (B, S, N)
    C: torch.Tensor,    # (B, S, N)
    D: torch.Tensor,    # (Di,) f32
    h0: torch.Tensor | None = None,  # (B, Di, N) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba1 scan, f32 inside whatever the model's ``ssm_dtype`` (the TPU
    kernel ignores it too, ``repro/kernels/ops.py:423-429``)."""
    grad = _needs_grad(x, dt, A, Bm, C, D, h0)
    if _plain(x, "selective_scan"):
        if grad:
            plain_calls["selective_scan_bwd"] += 1
        return ref.selective_scan(x, dt, A, Bm, C, D, h0)
    if grad:
        return _scan.SelectiveScan.apply(x, dt, A, Bm, C, D, h0)
    return _scan.selective_scan(x, dt, A, Bm, C, D, h0)


def ssd(
    x: torch.Tensor,    # (B, S, Hs, P)
    dt: torch.Tensor,   # (B, S, Hs)
    A: torch.Tensor,    # (Hs,) f32
    Bm: torch.Tensor,   # (B, S, N)
    C: torch.Tensor,    # (B, S, N)
    D: torch.Tensor,    # (Hs,) f32
    h0: torch.Tensor | None = None,  # (B, Hs, P, N) f32
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    grad = _needs_grad(x, dt, A, Bm, C, D, h0)
    if _plain(x, "ssd"):
        if grad:
            plain_calls["ssd_bwd"] += 1
        return ref.ssd(x, dt, A, Bm, C, D, h0, chunk=chunk)
    if grad:
        return _ssd.SSD.apply(x, dt, A, Bm, C, D, h0, chunk)
    return _ssd.ssd(x, dt, A, Bm, C, D, h0, chunk=chunk)


# no TPU kernel behind these: plain code on every device
causal_conv1d = ref.causal_conv1d
selective_scan_step = ref.selective_scan_step
ssd_step = ref.ssd_step
