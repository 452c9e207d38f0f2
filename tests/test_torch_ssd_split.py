"""The arithmetic of the tensor-core SSD kernel, on the CPU.

The CUDA SSD (``csrc/ssd.cu``) runs the chunked SSD in three phases: each
chunk's local state ``S_c = sum_j w_j x_j (x) B_j`` (``w_j = exp(L - l_j)
dt_j``) in parallel, the state passed in chunk order (``H_{c+1} = exp(L_c)
H_c + S_c``), and y from the state entering each chunk. Its products run on
bf16 tensor cores under an f32 contract: every f32 operand of a product
with a bf16 one is split into a bf16 part and the bf16 rounding of the rest
(the weights M in ``M x``, the state H in ``C H^T``, ``w x`` in
``(w x)^T B``). A CUDA kernel cannot run here, so this file holds a
plain-torch mirror of that arithmetic (phases and splits written out,
nothing of the kernel's tiling) against the JAX package's oracle
(``repro.kernels.ref.ssd``) and its TPU kernel in interpret mode, at the
shapes of ``tests/test_torch_ssm_kernels.py::test_ssd_matches_reference``
plus a three-chunk ragged case: y in bf16 at atol = rtol = 2e-2
(``tests/test_kernels.py:28-30``), the f32 state at 5e-3
(``tests/test_kernels.py:106``). Before the bf16 cast, the mirror's y is
also held to the port's f32 plain version at 1e-4: hi + lo keeps about 16
bits of each f32 operand (relative error ~2^-17 a product), summed over up
to a chunk of terms. One call over several chunks equals chained one-chunk
calls carrying the state, bit for bit; a chunk whose log-decay reaches
-512 stays finite.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd import ssd as pallas_ssd  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

torch.set_num_threads(1)
STATE_TOL = dict(atol=5e-3, rtol=5e-3)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An f32 tensor as its bf16 rounding and the bf16 rounding of the
    rest, both as f32 values."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def ssd_split(x, dt, A, Bm, C, D, h0=None, *, chunk=256, f32_y=False):
    """The kernel's arithmetic in plain torch. x, Bm, C hold bf16 values
    (exact in the products); returns y in bf16 (f32 with ``f32_y``) and the
    final f32 state."""
    b, s, hs, p = x.shape
    n = Bm.shape[-1]
    c = max(1, min(chunk, s))
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, Bm, C))
    Af = A.float()
    h = (torch.zeros(b, hs, p, n) if h0 is None else h0.float())
    spans = [(t0, min(s, t0 + c)) for t0 in range(0, s, c)]

    def rows(t, t0, t1):
        return t[:, t0:t1].contiguous()

    # (a) each chunk alone: l, its total decay L, its local state
    ls, Ls, local = [], [], []
    for t0, t1 in spans:
        xc, dtc, Bc = rows(xf, t0, t1), rows(dtf, t0, t1), rows(Bf, t0, t1)
        l = torch.cumsum(dtc * Af, dim=1)                          # (b,j,h)
        L = l[:, -1]                                               # (b,h)
        w = torch.exp(L[:, None] - l) * dtc
        hi, lo = split(xc * w[..., None])                          # w x
        local.append(torch.einsum("bjhp,bjn->bhpn", hi, Bc)
                     + torch.einsum("bjhp,bjn->bhpn", lo, Bc))
        ls.append(l)
        Ls.append(L)
    # (b) the state passed in chunk order
    entering = []
    for L, sc in zip(Ls, local):
        entering.append(h)
        h = torch.exp(L)[:, :, None, None] * h + sc
    # (c) y of each chunk from the state entering it
    ys = []
    for (t0, t1), l, H in zip(spans, ls, entering):
        xc, dtc = rows(xf, t0, t1), rows(dtf, t0, t1)
        Bc, Cc = rows(Bf, t0, t1), rows(Cf, t0, t1)
        nt = t1 - t0
        causal = torch.ones(nt, nt, dtype=torch.bool).tril()
        hh, hl = split(H)
        inter = (torch.einsum("bin,bhpn->bihp", Cc, hh)
                 + torch.einsum("bin,bhpn->bihp", Cc, hl))
        y = torch.exp(l)[..., None] * inter
        g = torch.einsum("bin,bjn->bij", Cc, Bc)                   # (b,i,j)
        ldiff = (l[:, :, None] - l[:, None]).masked_fill(
            ~causal[None, :, :, None], -float("inf"))              # (b,i,j,h)
        m = g[..., None] * torch.exp(ldiff) * dtc[:, None]
        mh, ml = split(m)
        y = y + torch.einsum("bijh,bjhp->bihp", mh, xc) \
            + torch.einsum("bijh,bjhp->bihp", ml, xc)
        ys.append(y + D.float()[None, None, :, None] * xc)
    y = torch.cat(ys, dim=1)
    return (y if f32_y else y.to(x.dtype)), h


def _inputs(rng, b, s, hs, p, n, dt_scale=0.1):
    """bf16 x, dt, B, C and f32 A, D, h0 — as JAX arrays and as torch
    tensors with the same bits."""
    def bf(a):
        j = jnp.asarray(a, jnp.bfloat16)
        return j, torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
            torch.bfloat16)

    def f32(a):
        j = jnp.asarray(a, jnp.float32)
        return j, torch.from_numpy(np.asarray(j).copy())

    return [bf(rng.standard_normal((b, s, hs, p)) * 0.5),
            bf(np.abs(rng.standard_normal((b, s, hs))) * dt_scale),
            f32(-np.abs(rng.standard_normal((hs,))) - 0.1),
            bf(rng.standard_normal((b, s, n)) * 0.5),
            bf(rng.standard_normal((b, s, n)) * 0.5),
            f32(rng.standard_normal((hs,))),
            f32(rng.standard_normal((b, hs, p, n)) * 0.1)]


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize(
    "b,s,hs,p,n,chunk",
    [(2, 48, 3, 16, 8, 16), (1, 16, 8, 64, 16, 8), (2, 5, 2, 8, 4, 16),
     (1, 70, 2, 16, 8, 16), (2, 600, 2, 16, 8, 256)],
)
def test_split_ssd_matches_the_oracle_and_the_tpu_kernel(b, s, hs, p, n,
                                                         chunk):
    """The last case runs three chunks of 256, the third ragged (88)."""
    ins = _inputs(np.random.default_rng(s * p + n), b, s, hs, p, n)
    j, t = [a for a, _ in ins], [a for _, a in ins]
    y, hT = ssd_split(*t, chunk=chunk)
    assert y.dtype == torch.bfloat16 and hT.dtype == torch.float32
    wants = [jref.ssd(*j), pallas_ssd(*j, chunk=chunk, interpret=True)]
    for yw, hw in wants:
        np.testing.assert_allclose(f32(y), f32(yw), **BF16_TOL)
        np.testing.assert_allclose(f32(hT), f32(hw), **STATE_TOL)
    # before the cast: the port's f32 plain version on the same values
    y32, h32 = ssd_split(*t, chunk=chunk, f32_y=True)
    yp, hp = ref.ssd(*[a.float() for a in t], chunk=chunk)
    torch.testing.assert_close(y32, yp, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h32, hp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("s,chunk", [(600, 256), (2048, 256), (70, 16)])
def test_one_call_equals_chained_chunk_calls_bitwise(s, chunk):
    """One call over s steps, and calls of ``chunk`` steps each carrying
    hT into the next h0, give the same y and hT bit for bit: a chunk's
    work depends only on its own steps and the state entering it."""
    ins = _inputs(np.random.default_rng(s), 1, s, 2, 16, 16)
    x, dt, A, Bm, C, D, h = [a for _, a in ins]
    y, hT = ssd_split(x, dt, A, Bm, C, D, h, chunk=chunk)
    parts = []
    for t0 in range(0, s, chunk):
        t1 = t0 + chunk
        yc, h = ssd_split(x[:, t0:t1], dt[:, t0:t1], A, Bm[:, t0:t1],
                          C[:, t0:t1], D, h, chunk=chunk)
        parts.append(yc)
    assert torch.equal(torch.cat(parts, 1), y)
    assert torch.equal(h, hT)


def test_split_ssd_long_chunk_does_not_overflow():
    """Decay from the difference l_i - l_j, never exp(l_i) * exp(-l_j): a
    chunk whose cumulative log-decay reaches -512 stays finite and agrees
    with the oracle."""
    ins = _inputs(np.random.default_rng(7), 1, 64, 2, 8, 16)
    j, t = [a for a, _ in ins], [a for _, a in ins]
    t[1] = torch.full_like(t[1], 8.0)                 # dt: l reaches -512
    t[2] = torch.full_like(t[2], -1.0)
    j[1] = jnp.asarray(t[1].float().numpy(), jnp.bfloat16)
    j[2] = jnp.asarray(t[2].numpy())
    y, hT = ssd_split(*t, chunk=64)
    assert torch.isfinite(y.float()).all() and torch.isfinite(hT).all()
    yw, hw = jref.ssd(*j)
    np.testing.assert_allclose(f32(y), f32(yw), **BF16_TOL)
    np.testing.assert_allclose(f32(hT), f32(hw), **STATE_TOL)


def test_scratch_layout_and_limits_are_the_kernels():
    """The wrapper's scratch regions (l, states, decays) leave the states
    16-byte aligned (the state pass reads them as float4), and its limits
    are ``csrc/ssd.cu``'s."""
    import re
    from pathlib import Path

    from repro_torch.kernels import ssd as dk

    for B, S, Hs, P, N, c in [(1, 256, 64, 64, 64, 256), (2, 600, 5, 48, 64, 256),
                              (1, 37, 3, 8, 16, 37), (3, 5, 1, 8, 16, 5)]:
        n_l, n_s, n_d = dk.scratch_sizes(B, S, Hs, P, N, c)
        chunks = -(-S // c)
        assert n_l % 4 == 0 and n_l >= B * Hs * chunks * c
        assert n_s == B * Hs * chunks * P * N and n_d == B * Hs * chunks
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "ssd.cu").read_text()
    defs = dict(re.findall(r"^#define (\w+) (\d+)", src, re.M))
    assert int(defs["MAXW"]) == dk.MAX_P == dk.MAX_N
    assert int(defs["MAXC"]) == dk.MAX_CHUNK
