"""The arithmetic order of the time-parallel selective-scan kernel, on the CPU.

The CUDA scan (``csrc/selective_scan.cu``) cuts the steps into tiles of 256
at fixed offsets from the call's start. In a tile, lane g of a half-warp
(one channel) owns steps 16g .. 16g+15; per state it folds its 16 steps'
``(a, b) = (exp(dt A), dt x B)`` in order into one map ``h -> P h + Q``
(``P = exp(A * the lane's dt sum)``), composes the 16 lanes' maps with a
4-round Kogge-Stone shuffle scan, applies the composite of lanes 0..g-1 to
the state carried into the tile, replays its 16 steps and sums ``h C`` over
the states in order. Lane 15's last state is carried into the next tile. A
CUDA kernel cannot run here, so this file holds a plain-torch mirror of
that order (``torch.exp`` in place of the kernel's ``ex2.approx``, which
cannot be mirrored) and shows:

- one call over S steps equals chained calls cut at multiples of 256, bit
  for bit in y and the final state, at S 600 and 2048 and at a channel count
  that is not a multiple of the kernel's 32-channel block;
- a batch row gives the same bits alone and in a batch of 3;
- the mirror matches the JAX package's oracle (``repro.kernels.ref.
  selective_scan``) and its TPU kernel in interpret mode at
  ``tests/test_kernels.py``'s tolerances (bf16 y 2e-2, f32 state 5e-3), and
  the port's plain version, at small shapes including N 4;
- the mirror's constants are the CUDA source's.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.selective_scan import selective_scan as pallas_scan  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

torch.set_num_threads(1)
TILE, LANES, STEPS = 256, 16, 16  # steps of a tile, lanes, steps of a lane
STATE_TOL = dict(atol=5e-3, rtol=5e-3)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"


def _shift(t: torch.Tensor, o: int, fill: float) -> torch.Tensor:
    """Along the lane dim (1): lane L gets lane L - o's value, the first o
    lanes ``fill`` (``__shfl_up_sync`` with the lanes below o masked)."""
    head = torch.full_like(t[:, :o], fill)
    return torch.cat([head, t[:, :-o]], dim=1)


def scan_split(x, dt, A, Bm, C, D, h0=None):
    """The kernel's order of operations, f32; returns (y in x's dtype, hT)."""
    b, s, di = x.shape
    n = A.shape[1]
    F = torch.nn.functional
    h = (torch.zeros(b, di, n) if h0 is None else h0.float()).clone()
    Af = A.float()
    ys = []
    for t0 in range(0, s, TILE):
        nt = min(TILE, s - t0)

        def tile(t):  # this tile's rows, zero-padded to 256 steps
            return F.pad(t[:, t0:t0 + nt].float(), (0, 0, 0, TILE - nt))

        xt, dtt, Bt, Ct = tile(x), tile(dt), tile(Bm), tile(C)
        dx = dtt * xt                                          # (B,T,Di)
        a = torch.exp(dtt[..., None] * Af)                     # (B,T,Di,N)
        bb = dx[..., None] * Bt[:, :, None, :]
        a = a.reshape(b, LANES, STEPS, di, n)
        bb = bb.reshape(b, LANES, STEPS, di, n)
        # each lane's steps folded in order: h -> P h + Q, P from the
        # lane's dt sum (taken in step order)
        dl = dtt.reshape(b, LANES, STEPS, di)
        sdt = dl[:, :, 0]
        for j in range(1, STEPS):
            sdt = sdt + dl[:, :, j]
        P = torch.exp(sdt[..., None] * Af)
        Q = bb[:, :, 0]
        for j in range(1, STEPS):
            Q = a[:, :, j] * Q + bb[:, :, j]
        # inclusive Kogge-Stone over the lanes: right (own) after left
        for o in (1, 2, 4, 8):
            Pp, Qp = _shift(P, o, 1.0), _shift(Q, o, 0.0)
            on = (torch.arange(LANES) >= o).view(1, LANES, 1, 1)
            Q = torch.where(on, P * Qp + Q, Q)
            P = torch.where(on, P * Pp, P)
        # the state entering each lane: lanes 0..L-1 applied to the carry
        hin = torch.cat([h[:, None], (P * h[:, None] + Q)[:, :-1]], dim=1)
        yacc = torch.zeros(b, LANES, STEPS, di)
        hh = hin
        Cl = Ct.reshape(b, LANES, STEPS, n)
        for j in range(STEPS):
            hh = a[:, :, j] * hh + bb[:, :, j]
            for k in range(n):   # the states in order
                yacc[:, :, j] = yacc[:, :, j] + hh[..., k] * Cl[:, :, j, None, k]
        h = hh[:, -1]
        y = yacc.reshape(b, TILE, di)[:, :nt] + D.float() * xt[:, :nt]
        ys.append(y)
    y = torch.cat(ys, 1) if ys else torch.zeros(b, 0, di)
    return y.to(x.dtype), h


def _inputs(rng, b, s, di, n, h0_scale=0.1):
    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)

    def f32(a):
        return torch.from_numpy(a.astype(np.float32))

    return (bf(rng.standard_normal((b, s, di)) * 0.5),
            bf(np.abs(rng.standard_normal((b, s, di))) * 0.1),
            f32(-np.abs(rng.standard_normal((di, n))) - 0.1),
            bf(rng.standard_normal((b, s, n)) * 0.5),
            bf(rng.standard_normal((b, s, n)) * 0.5),
            f32(rng.standard_normal(di)),
            f32(rng.standard_normal((b, di, n)) * h0_scale))


def _f32(a) -> np.ndarray:
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.fixture(scope="module")
def long_cases():
    """S 600 and 2048 at Di 37 (a ragged 32-channel block), N 16."""
    rng = np.random.default_rng(7)
    out = {}
    for s in (600, 2048):
        ins = _inputs(rng, 1, s, 37, 16)
        out[s] = (ins, scan_split(*ins))
    return out


@pytest.mark.parametrize("cuts", ["every_tile", "one_cut"])
@pytest.mark.parametrize("s", [600, 2048])
def test_one_call_equals_chained_tile_calls_bitwise(long_cases, s, cuts):
    ins, (y, hT) = long_cases[s]
    x, dt, A, Bm, C, D, h = ins
    edges = (list(range(0, s, TILE)) if cuts == "every_tile" else [0, 512])
    edges.append(s)
    parts = []
    for t0, t1 in zip(edges[:-1], edges[1:]):
        yc, h = scan_split(x[:, t0:t1], dt[:, t0:t1], A, Bm[:, t0:t1],
                           C[:, t0:t1], D, h)
        parts.append(yc)
    assert torch.equal(torch.cat(parts, 1), y)
    assert torch.equal(h, hT)


def test_a_row_gives_the_same_bits_alone_and_in_a_batch():
    rng = np.random.default_rng(3)
    ins = _inputs(rng, 3, 300, 40, 8)
    y, hT = scan_split(*ins)
    x, dt, A, Bm, C, D, h0 = ins
    for r in range(3):
        one = slice(r, r + 1)
        y1, h1 = scan_split(x[one], dt[one], A, Bm[one], C[one], D, h0[one])
        assert torch.equal(y1, y[one]) and torch.equal(h1, hT[one])


def test_identity_steps_keep_the_state_bitwise():
    """Steps with dt = 0 (the model's padding of a short chunk) leave the
    state as it was: a call whose last 100 steps have dt = 0 ends in the
    state of the call without them."""
    rng = np.random.default_rng(5)
    x, dt, A, Bm, C, D, h0 = _inputs(rng, 1, 300, 16, 4)
    dt = dt.clone()
    dt[:, 200:] = 0
    _, hT = scan_split(x, dt, A, Bm, C, D, h0)
    _, h200 = scan_split(x[:, :200], dt[:, :200], A, Bm[:, :200], C[:, :200],
                         D, h0)
    assert torch.equal(hT, h200)


@pytest.mark.parametrize("b,s,di,n", [(2, 40, 24, 8), (1, 16, 128, 16),
                                      (2, 7, 8, 4), (1, 300, 40, 4)])
def test_mirror_matches_the_oracle_and_the_tpu_kernel(b, s, di, n):
    rng = np.random.default_rng(b * 1000 + s + di + n)
    ins = _inputs(rng, b, s, di, n)
    y, hT = scan_split(*ins)
    j = [jnp.asarray(_f32(t)) for t in ins]
    for k in (0, 1, 3, 4):   # x, dt, Bm, C in bf16, as the kernel takes them
        j[k] = j[k].astype(jnp.bfloat16)
    yo, ho = jref.selective_scan(*j)
    yp, hp = pallas_scan(*j, chunk=16, block_channels=8, interpret=True)
    yw, hw = ref.selective_scan(*ins)
    for want_y, want_h in ((yo, ho), (yp, hp), (yw, hw)):
        np.testing.assert_allclose(_f32(y), _f32(want_y), **BF16_TOL)
        np.testing.assert_allclose(_f32(hT), _f32(want_h), **STATE_TOL)


def test_constants_are_the_cuda_sources():
    src = (CSRC / "selective_scan.cu").read_text()
    flat = re.sub(r"\s+", "", src)   # layout-free: whitespace edits pass

    def define(name):
        return int(re.search(rf"#define\s+{name}\s+(\d+)", src).group(1))

    assert define("TT") == TILE == LANES * STEPS
    assert define("CT") == 32   # so Di 37 leaves a ragged channel block
    assert "for(into=1;o<16;o<<=1)" in flat          # 4 rounds
    assert "for(intj=1;j<16;++j)Q=fmaf" in flat      # 16-step fold
    assert "constintg=lane&15;" in flat              # 16 lanes
