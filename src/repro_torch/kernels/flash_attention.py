"""Causal GQA flash attention: a CUDA C++ kernel for Hopper, its plain
version, its launch count.

The kernel (``csrc/flash_attention.cu``, which carries the design note)
replaces ``repro/kernels/flash_attention.py::flash_attention``: causal or
non-causal GQA attention of ``(B, Sq, H, D)`` queries over ``(B, Sk, K, D)``
keys with ``q_offset``, kv head ``h // (H/K)``, tiles above the diagonal
skipped and keys past ``Sk`` masked. The kernel is built for head widths 64
and 128; narrower heads (the REDUCED configs' 16, 24 and 32) are zero-padded
to 64 by ``_pad.run_padded`` and run at the true width's scale.

Training (the loss's attention) needs a gradient: :class:`FlashAttention`
is the ``torch.autograd.Function`` whose forward is this kernel, asked also
for each query row's log-sum-exp of the scaled scores (``lse``, f32 ``(B,
H, Sq)``), and whose backward is the hand-written backward kernel
(``csrc/flash_attention_bwd.cu``, which carries its design note):
:func:`flash_attention_bwd` gives dq, dk and dv from q, k, v, the output,
its gradient and ``lse``, with no floating-point atomics, so the same bits
every run. Both wrappers count their calls (``launches``; a backward call
is two launches: dQ, which also forms the row sums of dO∘O, then dK/dV).
Without ``lse`` the forward's outputs are the serving path's bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _pad
from repro_torch.kernels._cost import Cost, record
from repro_torch.kernels.ref import attention as plain  # noqa: F401  (beside the kernel)

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                          ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p]


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_bf16
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib_bwd():
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_bf16
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, what: str) -> None:
    dev = q.device
    if dev.type not in _build.DEVICES:
        raise ValueError(f"{what} kernel needs CUDA, got {dev}")
    B, Sq, H, D = q.shape
    if (k.shape[0] != B or k.shape[3] != D or v.shape != k.shape
            or H % k.shape[2] or D > _pad.WIDTHS[-1]):
        raise ValueError(
            f"{what} kernel: q {tuple(q.shape)}, k {tuple(k.shape)},"
            f" v {tuple(v.shape)} (need H % K == 0 and D <= "
            f"{_pad.WIDTHS[-1]})")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != dev or t.dtype != torch.bfloat16:
            raise ValueError(f"{what} kernel: {name} must be bf16 on "
                             f"{dev}, got {t.dtype} on {t.device}")


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D) bf16
    k: torch.Tensor,  # (B, Sk, K, D) bf16
    v: torch.Tensor,  # (B, Sk, K, D) bf16
    *,
    causal: bool = True,
    q_offset: int = 0,
    with_lse: bool = False,
):
    """Launch the kernel on CUDA tensors; returns ``(B, Sq, H, D)`` bf16,
    and with ``with_lse`` also ``lse (B, H, Sq)`` f32. D 64 and 128 run as
    they are; a narrower D runs zero-padded to 64."""
    _check(q, k, v, "flash_attention")
    if not with_lse:
        return _pad.run_padded(_launch, q, k, v, causal=causal,
                               q_offset=q_offset)
    d = q.shape[-1]
    w = _pad.width(d)
    out, lse = _launch(_pad.pad(q, w), _pad.pad(k, w), _pad.pad(v, w),
                       scale=d ** -0.5, causal=causal, q_offset=q_offset,
                       with_lse=True)
    return (out if w == d else out[..., :d].contiguous()), lse


def _aligned(*ts) -> None:
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash attention kernels: inputs are not 16-byte "
                         "aligned")


def _launch(q, k, v, *, scale: float, causal: bool, q_offset: int,
            with_lse: bool = False):
    """The launch at a built width (64 or 128), softmax scale given."""
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _aligned(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if B and Sq and q.is_meta:
        record("flash_attention", cost(B, Sq, Sk, H, K, D, causal=causal,
                                       q_offset=q_offset, with_lse=with_lse))
    elif B and Sq:
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr() if with_lse else None,
                     B, Sq, Sk, H, K, D, int(causal), int(q_offset),
                     scale, _build.stream(q.device))
        _build.check(err, "flash_attention")
        flash_attention.launches += 1
    return (out, lse) if with_lse else out


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        q_offset: int = 0):
    """The backward kernel on CUDA tensors: ``(dq, dk, dv)`` bf16 of q's,
    k's and v's shapes, from the forward's inputs, its output ``out``, the
    output's gradient ``dout`` (both (B, Sq, H, D)) and its ``lse`` (B, H,
    Sq) f32. A narrower D than 64 runs zero-padded at the true width's
    scale, the gradients sliced back."""
    _check(q, k, v, "flash_attention_bwd")
    for t, name in ((out, "out"), (dout, "dout")):
        if (t.shape != q.shape or t.device != q.device
                or t.dtype != torch.bfloat16):
            raise ValueError(f"flash_attention_bwd kernel: {name} "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"want q's {tuple(q.shape)} bf16 on {q.device}")
    B, Sq, H, d = q.shape
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd kernel: lse {tuple(lse.shape)}"
                         f" {lse.dtype}, want ({B}, {H}, {Sq}) f32")
    w = _pad.width(d)
    pq, pk, pv, po, pdo = (_pad.pad(t, w).contiguous()
                           for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    _aligned(pq, pk, pv, po, pdo)
    dq, dk, dv = (torch.empty_like(t) for t in (pq, pk, pv))
    Sk, K = k.shape[1], k.shape[2]
    if B and Sq and Sk:
        delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        if q.is_meta:
            record("flash_attention_bwd", bwd_cost(
                B, Sq, Sk, H, K, d, causal=causal, q_offset=q_offset))
        else:
            err = _lib_bwd()(pq.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                             po.data_ptr(), pdo.data_ptr(), lse.data_ptr(),
                             delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                             dv.data_ptr(), B, Sq, Sk, H, K, w, int(causal),
                             int(q_offset), d ** -0.5,
                             _build.stream(q.device))
            _build.check(err, "flash_attention_bwd")
            flash_attention_bwd.launches += 1
    else:  # nothing attended: every gradient is zero
        for t in (dq, dk, dv):
            t.zero_()
    if w != d:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


flash_attention_bwd.launches = 0


def pairs(B: int, Sq: int, Sk: int, H: int, *, causal: bool = True,
          q_offset: int = 0) -> int:
    """(query, key) pairs the kernel scores: every pair without a mask,
    else query row i's first ``min(Sk, i + q_offset + 1)`` keys (the tiles
    above the diagonal are skipped), over B and the H query heads."""
    if not causal:
        return B * H * Sq * Sk
    a = q_offset + 1                        # the first row's keys
    n1 = min(max(Sk - a + 1, 0), Sq)        # rows short of Sk keys
    return B * H * (n1 * a + n1 * (n1 - 1) // 2 + (Sq - n1) * Sk)


def cost(B: int, Sq: int, Sk: int, H: int, K: int, D: int, *,
         causal: bool = True, q_offset: int = 0,
         with_lse: bool = False) -> Cost:
    """One forward call: Q K^T and P V, 4 D FLOP a scored pair on the
    tensor cores; q, k, v read and the output written (bf16), ``lse``
    (f32) written when asked. A head narrower than 64 counts at its padded
    width, as the card runs it (``_pad``)."""
    w = _pad.width(D)
    n = pairs(B, Sq, Sk, H, causal=causal, q_offset=q_offset)
    q = B * Sq * H * w
    kv = B * Sk * K * w
    nbytes = (2 * q + 2 * kv) * 2 + (B * H * Sq * 4 if with_lse else 0)
    return Cost(4 * w * n, nbytes, unit="bf16")


def bwd_cost(B: int, Sq: int, Sk: int, H: int, K: int, D: int, *,
             causal: bool = True, q_offset: int = 0) -> Cost:
    """One backward call (two launches): five products of D-deep dots a
    pair (S, dP, dV, dK, dQ), 10 D FLOP (the kernels execute 14 D, S and dP
    twice); q, k, v, o, dO and lse read once, dq, dk, dv written once."""
    w = _pad.width(D)
    n = pairs(B, Sq, Sk, H, causal=causal, q_offset=q_offset)
    q = B * Sq * H * w
    io = (q + 2 * B * Sk * K * w) * 2
    return Cost(10 * w * n, 2 * io + 2 * q * 2 + B * H * Sq * 4,
                unit="bf16", launches=2)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward kernel (asked for
    ``lse`` too), the backward kernel. Non-differentiable ``causal`` and
    ``q_offset``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int):
        out, lse = flash_attention(q, k, v, causal=causal,
                                   q_offset=q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=ctx.causal,
                                         q_offset=ctx.q_offset)
        return dq, dk, dv, None, None
