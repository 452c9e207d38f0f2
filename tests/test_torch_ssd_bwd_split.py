"""The arithmetic of the tensor-core SSD backward kernel, on the CPU.

The CUDA backward (``csrc/ssd_bwd.cu``) runs in three launches: (a) each
chunk's local part of the state's gradient, ``sum_i (exp(l_i) dy_i)^T C_i``,
in parallel, then the gradient passed over the chunks in reverse by each
head's last block; (b) per (chunk, group of 4 heads) one walk of the causal
triangle by 64-step key tile J, query tiles I >= J inside: ``G^T = B_J
C_I^T`` and ``dM^T = x_J dy_I^T`` formed once per tile pair, then ``dx_J +=
M^T dy_I``, ``dB_J += dG^T C_I`` and ``dC_I += dG B_J``, the exiting
state's terms at the start of each key tile, the carried state's read at
the diagonal; dB and dC added over the group's heads in head order into one
partial per group; (c) the groups' partials, and dA, dD over batch rows and
chunks, added in one fixed order. Its products run on bf16 tensor cores
under the forward's f32 contract: G and dM have two bf16 operands; every f32
operand is split into a bf16 part and the bf16 rounding of the rest (M, dG,
exp(l) dy, H, dHn). Warp w owns key rows 16 (w % 4) .. and the column half
w / 4, so dx and dB are two halves' partials added in half order, and the
row and column sums of dl and ddt are kept per half.

A CUDA kernel cannot run here, so this file holds a plain-torch mirror of
that arithmetic (the phases, the splits, the tiles and halves, the sums'
orders; ``torch.exp`` for the kernel's exponentials) and holds it:

- against ``jax.vjp`` of the JAX package's oracle (``repro.kernels.ref.
  ssd``) and against the port's plain backward (``ref.ssd_bwd``), every
  gradient within ``SPLIT_REL`` of its largest magnitude: hi + lo keeps
  about 16 bits of each f32 operand (relative error ~2^-17 a product), and
  the f32 sums run in other orders over up to a chunk of terms; measured
  at most 6.7e-6 here, so 1e-4 leaves a margin and still catches the lo
  halves dropped (2.0e-3 at the least);
- at REDUCED-like sizes with ragged last chunks, one to three chunks,
  chunk 16, 64 and 256, ragged head groups (3 and 5 heads), P and N below
  16, nonzero h0 and a gradient for hT or none;
- dB and dC added per head group in head order, then over groups, equal the
  per-head sums within f32 rounding (measured 3.2e-8, held at 1e-6);
  dropping the lo halves moves the gradients by more than ten times
  ``SPLIT_REL``;
- the mirror's constants are the CUDA source's and the wrapper's.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

torch.set_num_threads(1)
TT = 64            # steps of a tile (csrc TT)
HG = 4             # heads of a products block (csrc HG)
SPLIT_REL = 1e-4   # of each gradient's largest magnitude
CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


def split(a: torch.Tensor, lo: bool = True) -> tuple[torch.Tensor, ...]:
    """An f32 tensor as its bf16 rounding and the bf16 rounding of the
    rest, both as f32 values (the rest zero without ``lo``)."""
    hi = a.to(torch.bfloat16).float()
    rest = (a - hi).to(torch.bfloat16).float()
    return hi, rest if lo else torch.zeros_like(rest)


def prod(a: torch.Tensor, b: torch.Tensor, lo: bool) -> torch.Tensor:
    """``a @ b`` with ``a`` f32 split into hi + lo, ``b`` bf16 values: the
    two tensor-core products, added hi first."""
    hi, rest = split(a, lo)
    return hi @ b + rest @ b


def ssd_bwd_split(x, dt, A, Bm, C, D, h0, dy, dhT=None, *, chunk=256,
                  heads=HG, lo=True):
    """The kernel's arithmetic in plain torch, f32 out. x, dt, Bm, C, dy
    hold bf16 values; A, D, h0, dhT f32. ``heads``: heads of a group."""
    b_, s, hs, p = x.shape
    n = Bm.shape[-1]
    c = max(1, min(chunk, s))
    spans = [(t0, min(s, t0 + c)) for t0 in range(0, s, c)]
    f = (lambda t: t.float())
    x, dt, Bm, C, dy = map(f, (x, dt, Bm, C, dy))
    A, D = A.float(), D.float()
    h = torch.zeros(b_, hs, p, n) if h0 is None else h0.float()

    # the forward's scratch: l, the entering states, the decays
    ls, Ls, Hs_in = [], [], []
    for t0, t1 in spans:
        l = torch.cumsum(dt[:, t0:t1] * A, dim=1)              # (b, j, h)
        L = l[:, -1]
        w = torch.exp(L[:, None] - l) * dt[:, t0:t1]
        xw = split(x[:, t0:t1] * w[..., None])
        local = sum(torch.einsum("bjhp,bjn->bhpn", part, Bm[:, t0:t1])
                    for part in xw)
        ls.append(l)
        Ls.append(L)
        Hs_in.append(h)
        h = torch.exp(L)[:, :, None, None] * h + local

    # (a) the chunks' local parts, then the gradient passed in reverse
    dHn = [None] * len(spans)
    cur = torch.zeros(b_, hs, p, n) if dhT is None else dhT.float()
    locals_ = []
    for (t0, t1), l in zip(spans, ls):
        ey = torch.exp(l)[..., None] * dy[:, t0:t1]            # (b, i, h, p)
        hi, rest = split(ey, lo)
        locals_.append(torch.einsum("bihp,bin->bhpn", hi, C[:, t0:t1])
                       + torch.einsum("bihp,bin->bhpn", rest, C[:, t0:t1]))
    for k in reversed(range(len(spans))):
        dHn[k] = cur
        cur = torch.exp(Ls[k])[:, :, None, None] * cur + locals_[k]
    dh0 = cur

    # (b) per chunk, head group and head: the walk by key tile
    groups = -(-hs // heads)
    dx = torch.zeros(b_, s, hs, p)
    ddt = torch.zeros(b_, s, hs)
    pB = torch.zeros(b_, groups, s, n)
    pC = torch.zeros(b_, groups, s, n)
    pA = torch.zeros(b_, hs, len(spans))
    pD = torch.zeros(b_, hs, len(spans))
    for k, (t0, t1) in enumerate(spans):
        nt = t1 - t0
        nq = -(-nt // TT)
        ct = nq * TT

        def rows(t, width):  # the chunk's rows, padded to whole tiles
            out = torch.zeros(b_, ct, width)
            out[:, :nt] = t
            return out

        Bc, Cc = rows(Bm[:, t0:t1], n), rows(C[:, t0:t1], n)
        for hh in range(hs):
            grp = hh // heads
            xc, yc = rows(x[:, t0:t1, hh], p), rows(dy[:, t0:t1, hh], p)
            l = torch.zeros(b_, ct)
            l[:, :nt] = ls[k][:, :, hh]
            dtc = torch.zeros(b_, ct)
            dtc[:, :nt] = dt[:, t0:t1, hh]
            L = Ls[k][:, hh]
            H, dH = Hs_in[k][:, hh], dHn[k][:, hh]               # (b, p, n)
            valid = torch.arange(ct) < nt
            rowR = torch.zeros(b_, ct)
            colR = torch.zeros(2, b_, ct)
            colD = torch.zeros(2, b_, ct)
            qd = torch.zeros(2, b_, ct)
            wdw = torch.zeros(b_, ct)
            ddS = torch.zeros(b_, ct)
            for J in range(nq):
                jsl = slice(J * TT, (J + 1) * TT)
                lj, dj = l[:, jsl], dtc[:, jsl]
                dec = torch.where(valid[jsl], torch.exp(L[:, None] - lj), 0.)
                w = dec * dj
                # the exiting state's terms: half 0 v = B_j dHn^T, half 1
                # s = x_j dHn
                v = prod(dH, Bc[:, jsl].transpose(1, 2), lo)
                v = v.transpose(1, 2)                           # (b, j, p)
                dxh = [w[..., None] * v + D[hh] * yc[:, jsl],
                       torch.zeros(b_, TT, p)]
                dw = (xc[:, jsl] * v).sum(-1)
                wdw[:, jsl] = torch.where(valid[jsl], dw * w, 0.)
                ddS[:, jsl] = torch.where(valid[jsl], dw * dec, 0.)
                sterm = prod(dH.transpose(1, 2), xc[:, jsl].transpose(1, 2),
                             lo).transpose(1, 2)                # (b, j, n)
                dbh = [torch.zeros(b_, TT, n), w[..., None] * sterm]
                for I in range(J, nq):
                    isl = slice(I * TT, (I + 1) * TT)
                    li = l[:, isl]
                    # G^T and dM^T once: rows j, columns i
                    Gt = Bc[:, jsl] @ Cc[:, isl].transpose(1, 2)
                    dMt = xc[:, jsl] @ yc[:, isl].transpose(1, 2)
                    ii = torch.arange(I * TT, (I + 1) * TT)
                    jj = torch.arange(J * TT, (J + 1) * TT)
                    ok = (ii[None, :] >= jj[:, None]) & (ii[None, :] < nt)
                    E = torch.where(ok, torch.exp(
                        (li[:, None, :] - lj[:, :, None]).masked_fill(
                            ~ok, 0.)), 0.)
                    Mt = Gt * E * dj[..., None]
                    dGt = dMt * E * dj[..., None]
                    R = dMt * Mt
                    rowR[:, isl] += R.sum(1)
                    dGt_hi, dGt_lo = split(dGt, lo)
                    for half in range(2):
                        hsl = slice(32 * half, 32 * half + 32)
                        colR[half][:, jsl] += R[:, :, hsl].sum(-1)
                        colD[half][:, jsl] += (dMt * Gt * E)[:, :, hsl].sum(-1)
                        dxh[half] = dxh[half] + prod(
                            Mt[:, :, hsl], yc[:, isl][:, hsl], lo)
                        dbh[half] = dbh[half] + prod(
                            dGt[:, :, hsl], Cc[:, isl][:, hsl], lo)
                    # rows i: dC += dG B_J, at the diagonal + q
                    dc = (dGt_hi.transpose(1, 2) @ Bc[:, jsl]
                          + dGt_lo.transpose(1, 2) @ Bc[:, jsl])
                    if I == J:
                        q = torch.exp(li)[..., None] * prod(
                            H.transpose(1, 2), yc[:, isl].transpose(1, 2),
                            lo).transpose(1, 2)                 # (b, i, n)
                        dc = dc + q
                        for half in range(2):
                            nsl = slice(32 * half, 32 * half + 32)
                            qd[half][:, isl] = (Cc[:, isl][..., nsl]
                                                * q[..., nsl]).sum(-1)
                    pC[:, grp, t0 + I * TT:t0 + min(nt, (I + 1) * TT)] += \
                        dc[:, :min(nt, (I + 1) * TT) - I * TT]
                m = min(nt, (J + 1) * TT) - J * TT
                dx[:, t0 + J * TT:t0 + J * TT + m, hh] = (dxh[0] + dxh[1])[:, :m]
                pB[:, grp, t0 + J * TT:t0 + J * TT + m] += \
                    (dbh[0] + dbh[1])[:, :m]
            # per row: dl and ddt's parts in a fixed order; l's reverse
            # cumsum; dA and dD of the chunk
            dl = rowR - colR[0] - colR[1] + qd[0] + qd[1] - wdw
            dd = colD[0] + colD[1] + ddS
            dl[:, nt - 1] += torch.exp(L) * (dH * H).sum((-1, -2)) + wdw.sum(1)
            rc = torch.flip(torch.cumsum(torch.flip(dl, (1,)), 1), (1,))
            ddt[:, t0:t1, hh] = (A[hh] * rc + dd)[:, :nt]
            pA[:, hh, k] = (rc * dtc).sum(1)
            pD[:, hh, k] = (yc * xc).sum((1, 2))
    # (c) the groups' partials in group order; dA, dD over batch rows, then
    # chunks
    dB = sum(pB[:, g_] for g_ in range(groups))
    dC = sum(pC[:, g_] for g_ in range(groups))
    dA = pA.sum(0).sum(-1)
    dD = pD.sum(0).sum(-1)
    return dx, ddt, dA, dB, dC, dD, dh0


def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (the kernel's input type), as f32."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _inputs(rng, B, S, Hs, P, N, h0_scale):
    """x, dt, B, C holding bf16 values and f32 A, D, h0 (numpy f32)."""
    f = np.float32
    return [_bf16(0.5 * rng.standard_normal((B, S, Hs, P))),
            _bf16(0.1 * np.abs(rng.standard_normal((B, S, Hs)))),
            -(np.abs(rng.standard_normal(Hs)) + 0.1).astype(f),
            _bf16(0.5 * rng.standard_normal((B, S, N))),
            _bf16(0.5 * rng.standard_normal((B, S, N))),
            rng.standard_normal(Hs).astype(f),
            (h0_scale * rng.standard_normal((B, Hs, P, N))).astype(f)]


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


CASES = [  # B, S, Hs, P, N, chunk, h0_scale, with_dhT
    (2, 37, 3, 16, 8, 256, 0.5, True),     # one ragged chunk, 3 heads
    (1, 300, 5, 8, 16, 256, 0.5, False),   # a ragged second chunk, 5 heads
    (2, 100, 2, 16, 16, 16, 0.0, True),    # chunk 16 (REDUCED), ragged
    (1, 200, 4, 8, 8, 64, 0.5, True),      # chunk 64: four chunks, one group
]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"B{c[0]}-S{c[1]}-Hs{c[2]}-P{c[3]}-N{c[4]}-c{c[5]}"
                     for c in CASES])
def case(request):
    B, S, Hs, P, N, chunk, h0_scale, with_dhT = request.param
    rng = np.random.default_rng(S + 7 * Hs + P + chunk)
    ins = _inputs(rng, B, S, Hs, P, N, h0_scale)
    dy = _bf16(rng.standard_normal((B, S, Hs, P)))
    dhT = ((0.3 * rng.standard_normal((B, Hs, P, N))).astype(np.float32)
           if with_dhT else None)
    t = [torch.from_numpy(a.copy()) for a in ins]
    tdy = torch.from_numpy(dy.copy())
    tdhT = None if dhT is None else torch.from_numpy(dhT)
    got = ssd_bwd_split(*t, tdy, tdhT, chunk=chunk)
    return dict(ins=ins, dy=dy, dhT=dhT, t=t, tdy=tdy, tdhT=tdhT,
                chunk=chunk, got=got)


def test_split_bwd_matches_the_oracles_vjp(case):
    """Every gradient against ``jax.vjp`` of ``repro.kernels.ref.ssd``, the
    sequential oracle (the chunking is the mirror's alone)."""
    ins, dy, dhT = case["ins"], case["dy"], case["dhT"]
    _, vjp = jax.vjp(jref.ssd, *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(
        dhT if dhT is not None else np.zeros_like(ins[6]))))
    for name, g, w in zip(GRADS, case["got"], want):
        err = _rel(g.numpy(), np.asarray(w))
        assert err <= SPLIT_REL, f"{name}: {err:.3g} over {SPLIT_REL}"


def test_split_bwd_matches_the_ports_plain_backward(case):
    """Every gradient against ``ref.ssd_bwd`` on the same f32 values."""
    want = ref.ssd_bwd(*case["t"], case["tdy"], case["tdhT"],
                       chunk=case["chunk"])
    for name, g, w in zip(GRADS, case["got"], want):
        err = _rel(g.numpy(), w.numpy())
        assert err <= SPLIT_REL, f"{name}: {err:.3g} over {SPLIT_REL}"


def test_head_groups_and_lo_halves(case):
    """dB and dC summed per group of 4 heads in head order, then over the
    groups, equal per-head partials summed over heads (one head a group)
    within f32 rounding; without the lo halves the gradients move by far
    more than ``SPLIT_REL``."""
    per_head = ssd_bwd_split(*case["t"], case["tdy"], case["tdhT"],
                             chunk=case["chunk"], heads=1)
    for i in (3, 4):   # dB, dC
        assert _rel(case["got"][i].numpy(), per_head[i].numpy()) <= 1e-6
    no_lo = ssd_bwd_split(*case["t"], case["tdy"], case["tdhT"],
                          chunk=case["chunk"], lo=False)
    worst = max(_rel(a.numpy(), b.numpy())
                for a, b in zip(no_lo, case["got"]))
    assert worst > 10 * SPLIT_REL


def test_constants_are_the_kernels():
    """The mirror's tile, head group and limits are ``csrc/ssd_bwd.cu``'s,
    and the wrapper's group size is the same."""
    from repro_torch.kernels import ssd as dk

    src = (CSRC / "ssd_bwd.cu").read_text()
    defs = dict(re.findall(r"^#define (\w+) (\d+)", src, re.M))
    assert int(defs["TT"]) == TT and int(defs["HG"]) == HG == dk.HEADS_BWD
    assert int(defs["MAXW"]) == dk.MAX_P == dk.MAX_N
    assert int(defs["MAXC"]) == dk.MAX_CHUNK
