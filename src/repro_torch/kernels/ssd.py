"""Mamba2 SSD (chunked state-space duality): a CUDA C++ kernel for Hopper,
its plain version, its launch count.

The kernel (``csrc/ssd.cu``, which carries the design note) replaces
``repro/kernels/ssd.py::ssd``: per batch row and head, chunk by chunk, the
masked ``c x c`` product ``(C B^T * exp(l_i - l_j)) dt x`` plus the carried
``(P, N)`` state's contribution, then the state's update; ``B`` and ``C``
are shared by all heads (one group). Returns ``(y, hT)``. The plain version
(``ref.ssd``) follows the same chunking.

One call is two launches: the chunks' local states in parallel, with the
state passed in chunk order by the last block of each head, then y for
every (query tile, chunk, head) from the state entering its chunk. The
wrapper allocates the scratch between them (l, the per-chunk states and
decays) as one f32 buffer per call; the per-head arrival counters are the
device's shared zeroed buffer (``_flash_decode.counters``), which the
kernel leaves at zero.

Training needs the gradient: :class:`SSD` is the
``torch.autograd.Function`` whose forward is this kernel, keeping its
scratch buffer (each chunk's ``l``, entering state and decay: what the
backward reads, so nothing is recomputed, and serving's bits are those of
the same launches), and whose backward is the hand-written kernel of
``csrc/ssd_bwd.cu`` (:func:`ssd_bwd`, three launches: the chunks' local
parts of the state's gradient on the tensor cores, passed over the chunks
in reverse by each head's last block; the transposed products per (chunk,
group of ``HEADS_BWD`` heads) on the tensor cores, dB and dC summed over
the group's heads; the sums over head groups, chunks and batch rows in one
fixed order). Its plain version is ``ref.ssd_bwd``. A backward call counts
one in ``ssd_bwd.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _flash_decode
from repro_torch.kernels._cost import Cost, record
from repro_torch.kernels.ref import ssd as plain  # noqa: F401  (beside the kernel)

MAX_P = 64      # P: a multiple of 8 up to 64
MAX_N = 64      # N: a multiple of 8 up to 64
MAX_CHUNK = 256
HEADS_BWD = 4   # heads of a backward products block (csrc HG)

_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 24 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p]


@functools.cache
def _lib():
    fn = _build.load("ssd").ssd_bf16
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_lib():
    fn = _build.load("ssd_bwd").ssd_bwd_bf16
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype,
           dev) -> torch.Tensor:
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
        raise ValueError(f"ssd kernel: {name} must be {dtype} {shape} on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.contiguous()


def scratch_sizes(B: int, S: int, Hs: int, P: int, N: int,
                  c: int) -> tuple[int, int, int]:
    """Floats of the scratch regions: l (B, Hs, chunks * c), the states
    (B, Hs, chunks, P, N) and the decays (B, Hs, chunks); the first rounded
    up to 4 floats so that the states start 16-byte aligned."""
    chunks = -(-S // c)
    n_l = B * Hs * chunks * c
    return -(-n_l // 4) * 4, B * Hs * chunks * P * N, B * Hs * chunks


def ssd(
    x: torch.Tensor,    # (B, S, Hs, P) bf16
    dt: torch.Tensor,   # (B, S, Hs) bf16
    A: torch.Tensor,    # (Hs,) f32
    Bm: torch.Tensor,   # (B, S, N) bf16
    C: torch.Tensor,    # (B, S, N) bf16
    D: torch.Tensor,    # (Hs,) f32
    h0: torch.Tensor | None = None,  # (B, Hs, P, N) f32
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors; returns ``y`` (B, S, Hs, P) bf16
    and ``hT`` (B, Hs, P, N) f32."""
    return _forward(x, dt, A, Bm, C, D, h0, chunk)[:2]


def _forward(x, dt, A, Bm, C, D, h0, chunk, keep_scratch: bool = False):
    """:func:`ssd`'s launches: ``(y, hT, scratch)``, the scratch the f32
    buffer of l, the entering states and the decays (None without a step
    or a launch); ``keep_scratch`` where a backward will read it (its
    bytes count in the call's cost)."""
    dev = x.device
    if dev.type not in _build.DEVICES:
        raise ValueError(f"ssd kernel needs CUDA, got {dev}")
    B, S, Hs, P = x.shape
    N = Bm.shape[-1]
    if P % 8 or P > MAX_P or N % 8 or N > MAX_N:
        raise ValueError(f"ssd kernel: P = {P} and N = {N} must be multiples "
                         f"of 8 up to {MAX_P} and {MAX_N}")
    c = max(1, min(chunk, S))
    if c > MAX_CHUNK:
        raise ValueError(f"ssd kernel: chunk {c} over {MAX_CHUNK}")
    bf, f32 = torch.bfloat16, torch.float32
    x = _check(x, "x", (B, S, Hs, P), bf, dev)
    dt = _check(dt, "dt", (B, S, Hs), bf, dev)
    A = _check(A, "A", (Hs,), f32, dev)
    Bm = _check(Bm, "Bm", (B, S, N), bf, dev)
    C = _check(C, "C", (B, S, N), bf, dev)
    D = _check(D, "D", (Hs,), f32, dev)
    if h0 is None:
        h0 = torch.zeros(B, Hs, P, N, dtype=f32, device=dev)
    h0 = _check(h0, "h0", (B, Hs, P, N), f32, dev)
    y = torch.empty_like(x)
    if not S:  # no step: the state passes through
        return y, h0.clone(), None
    hT = torch.empty_like(h0)
    buf = None
    if B and Hs:
        n_l, n_s, n_d = scratch_sizes(B, S, Hs, P, N, c)
        buf = torch.empty(n_l + n_s + n_d, dtype=f32, device=dev)
        if dev.type == "meta":
            record("ssd", cost(B, S, Hs, P, N, chunk=chunk,
                               keep_scratch=keep_scratch))
        else:
            base = buf.data_ptr()
            err = _lib()(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                         Bm.data_ptr(), C.data_ptr(), D.data_ptr(),
                         h0.data_ptr(), y.data_ptr(), hT.data_ptr(), base,
                         base + 4 * n_l, base + 4 * (n_l + n_s),
                         _flash_decode.counters(B * Hs, dev).data_ptr(),
                         B, S, Hs, P, N, c, _build.stream(dev))
            _build.check(err, "ssd")
            ssd.launches += 1
    return y, hT, buf


ssd.launches = 0


def ssd_bwd(x, dt, A, Bm, C, D, scratch, dy, dhT=None, *, chunk: int = 256):
    """The backward kernel on CUDA tensors: the gradients of :func:`ssd`
    for ``dy`` (y's gradient, bf16) and ``dhT`` (hT's, f32, or None), from
    the forward's inputs and ``scratch``, the buffer its launches filled
    (:func:`_forward`). Returns ``(dx, ddt, dA, dB, dC, dD, dh0)``: bf16,
    bf16, f32, bf16, bf16, f32, f32."""
    dev = x.device
    if dev.type not in _build.DEVICES:
        raise ValueError(f"ssd_bwd kernel needs CUDA, got {dev}")
    B, S, Hs, P = x.shape
    N = Bm.shape[-1]
    c = max(1, min(chunk, S))
    bf, f32 = torch.bfloat16, torch.float32
    x = _check(x, "x", (B, S, Hs, P), bf, dev)
    dt = _check(dt, "dt", (B, S, Hs), bf, dev)
    A = _check(A, "A", (Hs,), f32, dev)
    Bm = _check(Bm, "Bm", (B, S, N), bf, dev)
    C = _check(C, "C", (B, S, N), bf, dev)
    D = _check(D, "D", (Hs,), f32, dev)
    dy = _check(dy, "dy", (B, S, Hs, P), bf, dev)
    if dhT is not None:
        dhT = _check(dhT, "dhT", (B, Hs, P, N), f32, dev)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    dB, dC = torch.empty_like(Bm), torch.empty_like(C)
    dh0 = torch.empty(B, Hs, P, N, dtype=f32, device=dev)
    if scratch is None:   # no step or no head: zeros, dh0 = dhT
        for t in (dx, ddt, dA, dD, dB, dC):
            t.zero_()
        dh0.copy_(dhT if dhT is not None else torch.zeros_like(dh0))
        return dx, ddt, dA, dB, dC, dD, dh0
    n_l, n_s, n_d = scratch_sizes(B, S, Hs, P, N, c)
    if scratch.dtype != f32 or scratch.numel() != n_l + n_s + n_d:
        raise ValueError("ssd_bwd kernel: scratch is not this call's")
    chunks = -(-S // c)
    groups = -(-Hs // HEADS_BWD)
    dHn = torch.empty(B, Hs, chunks, P, N, dtype=f32, device=dev)
    pBC = torch.empty(2, B, groups, S, N, dtype=f32, device=dev)
    pAD = torch.empty(2, B, Hs, chunks, dtype=f32, device=dev)
    if dev.type == "meta":
        record("ssd_bwd", bwd_cost(B, S, Hs, P, N, chunk=chunk))
        return dx, ddt, dA, dB, dC, dD, dh0
    base = scratch.data_ptr()
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    err = _bwd_lib()(*map(ptr, (x, dt, A, Bm, C, D, dy, dhT)), base,
                     base + 4 * n_l, base + 4 * (n_l + n_s),
                     *map(ptr, (dHn, dx, ddt, dA, dB, dC, dD, dh0, pBC[0],
                                pBC[1], pAD[0], pAD[1],
                                _flash_decode.counters(B * Hs, dev))),
                     B, S, Hs, P, N, c, _build.stream(dev))
    _build.check(err, "ssd_bwd")
    ssd_bwd.launches += 1
    return dx, ddt, dA, dB, dC, dD, dh0


ssd_bwd.launches = 0


def _pairs(S: int, chunk: int) -> int:
    """The causal (i, j) pairs of every chunk: n(n+1)/2 for a chunk of n
    steps."""
    c = max(1, min(chunk, S))
    chunks = [min(c, S - c0) for c0 in range(0, S, c)]
    return sum(n * (n + 1) // 2 for n in chunks)


def cost(B: int, S: int, Hs: int, P: int, N: int, *, chunk: int = 256,
         keep_scratch: bool = False, unit: str = "bf16") -> Cost:
    """One forward call (two launches). Per chunk of n steps: C B^T once
    for all heads (n(n+1)/2 pairs x N FMAs); per head the masked product
    with x (pairs x P), the carried state's read and update (2 n P N), the
    decay mask; an exponential a pair and two a step. x, dt, B, C, A, D
    and h0 read, y and hT written, and with ``keep_scratch`` (training's
    forward) the scratch its backward reads. The products run on bf16
    operands, so the tensor cores' rate (``unit`` "f32": the same work on
    the units outside them)."""
    pairs = _pairs(S, chunk)
    flops = B * (2 * pairs * N + Hs * (2 * pairs * P + 3 * pairs
                                       + 4 * S * P * N))
    nbytes = (2 * B * S * Hs * P * 2 + B * S * Hs * 2 + 2 * B * S * N * 2
              + 2 * Hs * 4 + 2 * B * Hs * P * N * 4)
    if keep_scratch:
        nbytes += 4 * sum(scratch_sizes(B, S, Hs, P, N,
                                        max(1, min(chunk, S))))
    return Cost(flops, nbytes, exps=B * Hs * (pairs + 2 * S), unit=unit,
                launches=2)


def bwd_cost(B: int, S: int, Hs: int, P: int, N: int, *,
             chunk: int = 256) -> Cost:
    """One backward call (three launches). Per (b, chunk): C B^T on the
    causal triangle; per head dy x^T, M^T dy (P deep), dG^T C, dG B (N
    deep) on the triangle, and four (c, P, N) products with the states (the
    local dH, dHn B, dHn^T x, dy H). Read: x, dy, dt, B, C, A, D and the
    scratch; written: dx, ddt, dB, dC, dA, dD, dh0."""
    pairs = _pairs(S, chunk)
    sx, sn = B * S * Hs * P * 2, B * S * N * 2
    state = B * Hs * P * N * 4
    scratch = 4 * sum(scratch_sizes(B, S, Hs, P, N, max(1, min(chunk, S))))
    flops = B * (2 * pairs * N + Hs * (4 * pairs * P + 4 * pairs * N
                                       + 8 * S * P * N))
    nbytes = (3 * sx + 2 * B * S * Hs * 2 + 4 * sn + 4 * Hs * 4 + state
              + scratch)
    return Cost(flops, nbytes, exps=B * Hs * (2 * pairs + 2 * S),
                unit="bf16", launches=3)


class SSD(torch.autograd.Function):
    """The SSD with its gradient: the forward kernel keeping its scratch,
    the backward kernel. ``h0`` may be None (zeros); ``chunk`` is not
    differentiable."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, C, D, h0, chunk: int):
        y, hT, buf = _forward(x, dt, A, Bm, C, D, h0, chunk,
                              keep_scratch=True)
        ctx.save_for_backward(x, dt, A, Bm, C, D, buf)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, A, Bm, C, D, buf = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype)
        grads = ssd_bwd(x, dt, A, Bm, C, D, buf, dy, dhT, chunk=ctx.chunk)
        return (*(g.to(t.dtype) if need else None for g, t, need in zip(
            grads, (x, dt, A, Bm, C, D, grads[6]), ctx.needs_input_grad)),
            None)
