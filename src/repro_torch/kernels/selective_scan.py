"""Mamba1 selective scan: a CUDA C++ kernel for Hopper, its plain version,
its launch count.

The kernel (``csrc/selective_scan.cu``, which carries the design note)
replaces ``repro/kernels/selective_scan.py::selective_scan``: the
recurrence ``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t``,
``y_t = h_t C_t + D x_t`` over ``(B, S, Di)`` inputs with ``(Di, N)``
state per batch row, from ``h0``; returns ``(y, hT)``. It scans each
256-step tile in parallel over a half-warp's lanes, one channel a
half-warp (16 steps a lane, each lane's decay product ``P`` formed as exp2
of its dt sum, a 4-round shuffle scan across the lanes), and carries the
state from tile to tile, so one
call equals chained calls cut at multiples of 256, bit for bit; the
reference's ``chunk`` blocking has no counterpart here. The plain version
(``ref.selective_scan``) walks the steps in order.

Training needs the gradient: :class:`SelectiveScan` is the
``torch.autograd.Function`` whose forward is this kernel, saving the f32
state entering each 256-step tile (``save_states``; serving's ``y`` and
``hT`` keep their bits), and whose backward is the hand-written kernel of
``csrc/selective_scan_bwd.cu`` (:func:`selective_scan_bwd`): each tile
replayed from its saved state with the forward's own operations, the
state's adjoint scanned back over the tile (64 channels a block in four
passes of 16, two states a lane at a time), dB and dC summed over a
block's channels in channel order into one f32 partial a block, then the
blocks' partials (dB, dC) and the batch rows (dA, dD) added in one fixed
order by a second launch. Its plain version is ``ref.selective_scan_bwd``.
A backward call (two launches) counts one in
``selective_scan_bwd.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._cost import Cost, record
from repro_torch.kernels.ref import selective_scan as plain  # noqa: F401  (beside the kernel)

STATES = (4, 8, 16, 32, 64)   # the state sizes the kernel is built for
BWD_STATES = (4, 8, 16)       # and its backward
TILE = 256                    # steps of a tile (csrc TT)
CHANNELS_BWD = 64             # channels of a backward block (csrc CT)
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]


@functools.cache
def _lib():
    fn = _build.load("selective_scan").selective_scan_bf16
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_lib():
    fn = _build.load("selective_scan_bwd").selective_scan_bwd_bf16
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype,
           dev) -> torch.Tensor:
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
        raise ValueError(f"selective_scan kernel: {name} must be {dtype} "
                         f"{shape} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.contiguous()


def selective_scan(
    x: torch.Tensor,    # (B, S, Di) bf16
    dt: torch.Tensor,   # (B, S, Di) bf16
    A: torch.Tensor,    # (Di, N) f32
    Bm: torch.Tensor,   # (B, S, N) bf16
    C: torch.Tensor,    # (B, S, N) bf16
    D: torch.Tensor,    # (Di,) f32
    h0: torch.Tensor | None = None,  # (B, Di, N) f32
    *,
    save_states: bool = False,
):
    """Launch the kernel on CUDA tensors; returns ``y`` (B, S, Di) bf16 and
    ``hT`` (B, Di, N) f32, and with ``save_states`` also the f32 state
    entering each tile, (B, ceil(S / 256), Di, N), tile 0's being h0."""
    dev = x.device
    if dev.type not in _build.DEVICES:
        raise ValueError(f"selective_scan kernel needs CUDA, got {dev}")
    B, S, Di = x.shape
    N = A.shape[-1]
    if N not in STATES:
        raise ValueError(f"selective_scan kernel: state size {N} not in "
                         f"{STATES}")
    bf, f32 = torch.bfloat16, torch.float32
    x = _check(x, "x", (B, S, Di), bf, dev)
    dt = _check(dt, "dt", (B, S, Di), bf, dev)
    A = _check(A, "A", (Di, N), f32, dev)
    Bm = _check(Bm, "Bm", (B, S, N), bf, dev)
    C = _check(C, "C", (B, S, N), bf, dev)
    D = _check(D, "D", (Di,), f32, dev)
    # B and C are read as bf16 pairs: 4-byte aligned
    Bm, C = (t if t.data_ptr() % 4 == 0 else t.clone() for t in (Bm, C))
    if h0 is None:
        h0 = torch.zeros(B, Di, N, dtype=f32, device=dev)
    h0 = _check(h0, "h0", (B, Di, N), f32, dev)
    y = torch.empty_like(x)
    hT = torch.empty_like(h0)
    hs = (torch.empty(B, -(-S // TILE), Di, N, dtype=f32, device=dev)
          if save_states else None)
    if B and Di and dev.type == "meta":
        record("selective_scan", cost(B, S, Di, N, save_states=save_states))
    elif B and Di:
        # 16-byte staging of x and dt and 16-byte stores of y, else scalar
        vec = Di % 8 == 0 and not any(t.data_ptr() % 16 for t in (x, dt, y))
        err = _lib()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                     C.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
                     hT.data_ptr(), hs.data_ptr() if save_states else None,
                     B, S, Di, N, int(vec), _build.stream(dev))
        _build.check(err, "selective_scan")
        selective_scan.launches += 1
    return (y, hT, hs) if save_states else (y, hT)


selective_scan.launches = 0


def selective_scan_bwd(x, dt, A, Bm, C, D, hs, dy, dhT=None):
    """The backward kernel on CUDA tensors: the gradients of
    :func:`selective_scan` for ``dy`` (y's gradient, bf16) and ``dhT``
    (hT's, f32, or None), from the forward's inputs and ``hs``, its saved
    states. Returns ``(dx, ddt, dA, dB, dC, dD, dh0)``: bf16, bf16, f32,
    bf16, bf16, f32, f32."""
    dev = x.device
    if dev.type not in _build.DEVICES:
        raise ValueError(f"selective_scan_bwd kernel needs CUDA, got {dev}")
    B, S, Di = x.shape
    N = A.shape[-1]
    if N not in BWD_STATES:
        raise ValueError(f"selective_scan_bwd kernel: state size {N} not in "
                         f"{BWD_STATES}")
    bf, f32 = torch.bfloat16, torch.float32
    x = _check(x, "x", (B, S, Di), bf, dev)
    dt = _check(dt, "dt", (B, S, Di), bf, dev)
    A = _check(A, "A", (Di, N), f32, dev)
    Bm = _check(Bm, "Bm", (B, S, N), bf, dev)
    C = _check(C, "C", (B, S, N), bf, dev)
    D = _check(D, "D", (Di,), f32, dev)
    hs = _check(hs, "hs", (B, -(-S // TILE), Di, N), f32, dev)
    dy = _check(dy, "dy", (B, S, Di), bf, dev)
    if dhT is not None:
        dhT = _check(dhT, "dhT", (B, Di, N), f32, dev)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    dB, dC = torch.empty_like(Bm), torch.empty_like(C)
    dh0 = torch.empty(B, Di, N, dtype=f32, device=dev)
    if not (B and S and Di):   # nothing to walk: zeros, dh0 = dhT
        for t in (dx, ddt, dA, dD, dB, dC):
            t.zero_()
        dh0.copy_(dhT if dhT is not None else torch.zeros_like(dh0))
        return dx, ddt, dA, dB, dC, dD, dh0
    blocks = -(-Di // CHANNELS_BWD)
    pB = torch.empty(2, blocks, B, S, N, dtype=f32, device=dev)
    pA = torch.empty(B, Di, N, dtype=f32, device=dev)
    pD = torch.empty(B, Di, dtype=f32, device=dev)
    if dev.type == "meta":
        record("selective_scan_bwd", bwd_cost(B, S, Di, N))
        return dx, ddt, dA, dB, dC, dD, dh0
    # B and C are read as bf16 pairs: 4-byte aligned
    Bm, C = (t if t.data_ptr() % 4 == 0 else t.clone() for t in (Bm, C))
    # 16-byte staging of x, dt, dy and 16-byte stores of dx, ddt, else scalar
    vec = Di % 8 == 0 and not any(t.data_ptr() % 16
                                  for t in (x, dt, dy, dx, ddt))
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    err = _bwd_lib()(*map(ptr, (x, dt, A, Bm, C, D, hs, dy, dhT, dx, ddt, dA,
                                dB, dC, dD, dh0, pB[0], pB[1], pA, pD)),
                     B, S, Di, N, int(vec), _build.stream(dev))
    _build.check(err, "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC, dD, dh0


selective_scan_bwd.launches = 0


def _io(B: int, S: int, Di: int, N: int) -> int:
    """x and dt read (bf16), B and C read (bf16), A and D read (f32)."""
    return 2 * B * S * Di * 2 + 2 * B * S * N * 2 + Di * N * 4 + Di * 4


def cost(B: int, S: int, Di: int, N: int, *,
         save_states: bool = False) -> Cost:
    """One forward call: per (t, d, n) dt*A, its exponential, two products
    and an add for h, an FMA into y; per (t, d) dt*x and D*x + y, on the
    f32 units. The inputs and h0 read, y and hT written, with
    ``save_states`` also each tile's entering state."""
    n_sn = B * S * Di * N
    tiles = -(-S // TILE) if save_states else 0
    return Cost(6 * n_sn + 3 * B * S * Di,
                _io(B, S, Di, N) + B * S * Di * 2
                + (2 + tiles) * B * Di * N * 4, exps=n_sn, unit="f32")


def bwd_cost(B: int, S: int, Di: int, N: int) -> Cost:
    """One backward call (two launches): read x, dt, dy, B, C, A, D and the
    tiles' states; written dx, ddt, dB, dC, dA, dD, dh0. Per (t, d, n) the
    replay's exponential and ~12 f32 operations (the replay's two, the
    adjoint's and the five sums')."""
    n_sn = B * S * Di * N
    tiles = -(-S // TILE)
    return Cost(12 * n_sn,
                _io(B, S, Di, N) + 3 * B * S * Di * 2 + 2 * B * S * N * 2
                + Di * N * 4 + Di * 4 + (tiles + 1) * B * Di * N * 4,
                exps=n_sn, unit="f32", launches=2)


class SelectiveScan(torch.autograd.Function):
    """The scan with its gradient: the forward kernel saving its tiles'
    entering states, the backward kernel. ``h0`` may be None (zeros)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, C, D, h0):
        y, hT, hs = selective_scan(x, dt, A, Bm, C, D, h0, save_states=True)
        ctx.save_for_backward(x, dt, A, Bm, C, D, hs)
        ctx.set_materialize_grads(False)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, A, Bm, C, D, hs = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype)
        grads = selective_scan_bwd(x, dt, A, Bm, C, D, hs, dy, dhT)
        return tuple(g.to(t.dtype) if need else None for g, t, need in zip(
            grads, (x, dt, A, Bm, C, D, hs), ctx.needs_input_grad))
