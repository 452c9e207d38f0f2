"""The arithmetic order of the RMSNorm backward kernel, on the CPU.

The CUDA backward (``rmsnorm_bwd`` in ``csrc/rmsnorm.cu``) gives each row
``tpr`` threads, fixed by ``d`` and the type: up to ``d`` 256 half a warp
whose lanes own two runs of 16 bytes (four at f32); above, ``W`` warps
whose threads own 4 (or 8) runs of 16 bytes. Thread ``lt`` owns runs ``lt, lt + tpr, ...``; it
sums its squares and its ``g w x`` in run and element order with ``fmaf``,
a row's lanes in a warp add theirs by a butterfly, a row's warps add
theirs in warp order. A block of 256 threads walks a run of ``chunk_rows(rows)`` rows, its
``256 / tpr`` row groups taking rows ``grp, grp + G, ...``; each thread
keeps its columns' ``dw`` in f32 over its rows (``fmaf(g, xh, acc)`` in row
order), the groups' sums are added in group order into the run's partial
row, and a second launch sums the partial rows: thread ``(c, y)`` runs
``y, y + 32, ...`` in order, then the 32 sums in ``y`` order. A CUDA kernel
cannot run here, so this file holds a plain-torch mirror of that order
(each ``fmaf`` through f64, ``torch.rsqrt`` for ``rsqrtf``) and shows:

- the mirror's dx and dw match ``jax.grad`` of the JAX package's
  ``repro.kernels.ref.rmsnorm`` and plain autograd through the port's
  ``ref.rmsnorm`` at small shapes (bf16 dx within 2e-2; f32 dw within 1e-4
  of its largest magnitude), on both paths and a width that loads element
  by element;
- a row's dx bits do not depend on how many rows share the call;
- the wrapper's run rule covers every row once, each run's row groups
  cover it once, at the three training shapes and more;
- the mirror's constants are the CUDA source's.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref, rmsnorm as rk  # noqa: E402

torch.set_num_threads(1)
BWD_THREADS, WARP_D = 256, 256     # csrc BWD_THREADS, WARP_D
EPS = 1e-5
CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
# the three training shapes: smollm-360m's block norm, qwen3-8b's qk-norm
# rows and its block norm; then more rows than one run, and a ragged last run
TRAIN_SHAPES = [(16384, 960), (131072, 128), (4096, 4096)]


def layout(d, itemsize=2):
    """``(VEC, RUNS, tpr)`` for a row of ``d`` (csrc ``launch_bwd``)."""
    vec = 16 // itemsize
    if d <= WARP_D:   # half a warp a row
        return vec, WARP_D // (16 * vec), 16
    runs = -(-d // vec)
    w4 = -(-runs // 128)
    if w4 <= BWD_THREADS // 32:
        return vec, 4, 32 * w4
    return vec, 8, 32 * -(-runs // 256)


def _fma(a, b, c):
    """f32 ``fmaf`` through f64: the product is exact there."""
    return (a.double() * b.double() + c.double()).float()


def _thread_cols(d, itemsize=2):
    """cols[lt, s]: the s-th column thread lt sums, in its order; -1 past
    the row's end or past its runs."""
    vec, runs, tpr = layout(d, itemsize)
    lt = torch.arange(tpr)[:, None, None]
    u = torch.arange(runs)[None, :, None]
    k = torch.arange(vec)[None, None, :]
    c = (lt + u * tpr) * vec + k
    return torch.where(c < d, c, -1).reshape(tpr, runs * vec), tpr


def _row_sum(v, cols, tpr):
    """The kernel's sum of ``v (R, tpr)``, each thread's own sum: a
    butterfly over the row's lanes in each warp (16 or 32), then the warps
    in order."""
    width = min(tpr, 32)
    lanes = torch.arange(width)
    w = v.reshape(v.shape[0], tpr // width, width)
    o = width // 2
    while o:
        w = w + w[..., lanes ^ o]
        o //= 2
    out = w[:, 0, 0]
    for j in range(1, tpr // width):
        out = out + w[:, j, 0]
    return out


def row_stats(x, g, wf, d, itemsize=2):
    """Per row: ``ss`` and ``dot`` in the kernel's order."""
    cols, tpr = _thread_cols(d, itemsize)
    live = cols >= 0
    c = cols.clamp(min=0)
    xs = torch.where(live, x[:, c], 0.0)            # (R, tpr, n)
    gw = torch.where(live, g[:, c] * wf[c], 0.0)
    ss = torch.zeros(x.shape[0], tpr)
    dot = torch.zeros(x.shape[0], tpr)
    for s in range(cols.shape[1]):
        ss = _fma(xs[..., s], xs[..., s], ss)
        dot = _fma(gw[..., s], xs[..., s], dot)
    return _row_sum(ss, cols, tpr), _row_sum(dot, cols, tpr)


def bwd_split(x, w, g, eps=EPS):
    """The kernel's ``(dx, dw)``: dx in x's type, dw f32."""
    rows, d = x.shape
    xf, gf, wf = x.float(), g.float(), w.float()
    ss, dot = row_stats(xf, gf, wf, d, x.element_size())
    r = torch.rsqrt(ss / d + eps)[:, None]
    m = dot[:, None] * r / d
    xh = xf * r
    dx = (r * (gf * wf - xh * m)).to(x.dtype)
    # dw: each block's run, its groups' rows in order, groups in order
    _, _, tpr = layout(d, x.element_size())
    G = BWD_THREADS // tpr
    chunk = rk.chunk_rows(rows)
    nb = -(-rows // chunk)
    steps = -(-chunk // G)
    pad = nb * steps * G
    gp = torch.zeros(pad, d)
    hp = torch.zeros(pad, d)
    for b in range(nb):   # block b's rows, laid out (step, group)
        lo, hi = b * chunk, min((b + 1) * chunk, rows)
        gp[b * steps * G:b * steps * G + hi - lo] = gf[lo:hi]
        hp[b * steps * G:b * steps * G + hi - lo] = xh[lo:hi]
    gp = gp.reshape(nb, steps, G, d)
    hp = hp.reshape(nb, steps, G, d)
    acc = torch.zeros(nb, G, d)
    for s in range(steps):
        acc = _fma(gp[:, s], hp[:, s], acc)
    part = acc[:, 0]
    for j in range(1, G):
        part = part + acc[:, j]
    ys = []
    for y in range(32):   # the second launch
        v = torch.zeros(d)
        for j in range(y, nb, 32):
            v = v + part[j]
        ys.append(v)
    dw = torch.zeros(d)
    for v in ys:
        dw = dw + v
    return dx, dw


def _case(seed, rows, d, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32))
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(d).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32))
    return x.to(dtype), w, g.to(dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("rows,d", [(37, 96), (300, 128), (70, 960),
                                    (40, 4096), (5, 33), (9, 300)])
def test_mirror_matches_jax_grad_and_plain_autograd(rows, d):
    x, w, g = _case(rows * 7 + d, rows, d)
    dx, dw = bwd_split(x, w, g)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jg = jnp.asarray(g.float().numpy()).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm(a, b, EPS), jx,
                     jnp.asarray(w.numpy()))
    jdx, jdw = vjp(jg)
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    pdx, pdw = torch.autograd.grad(ref.rmsnorm(xp, wp, EPS), (xp, wp), g)
    for want_dx, want_dw in ((np.asarray(jdx.astype(jnp.float32)),
                              np.asarray(jdw)),
                             (pdx.float().numpy(), pdw.numpy())):
        np.testing.assert_allclose(dx.float().numpy(), want_dx, atol=2e-2,
                                   rtol=2e-2)
        assert _rel(dw.numpy(), want_dw) <= 1e-4


def test_a_rows_dx_bits_do_not_depend_on_the_row_count():
    x, w, g = _case(3, 200, 960)
    dx, _ = bwd_split(x, w, g)
    for lo, n in ((0, 1), (7, 33), (100, 100)):
        part, _ = bwd_split(x[lo:lo + n], w, g[lo:lo + n])
        assert torch.equal(part, dx[lo:lo + n])


def test_two_calls_give_the_same_bits():
    x, w, g = _case(4, 1000, 128)
    a, b = bwd_split(x, w, g), bwd_split(x, w, g)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("rows,d", TRAIN_SHAPES + [(20000, 960),
                                                   (1000, 4096), (37, 96)])
def test_the_run_rule_covers_every_row_once(rows, d):
    chunk = rk.chunk_rows(rows)
    nb = -(-rows // chunk)
    assert nb <= rk.MAX_RUNS_BWD and chunk >= rk.MIN_CHUNK
    _, _, tpr = layout(d)
    G = BWD_THREADS // tpr
    seen = np.zeros(rows, np.int64)
    for b in range(nb):
        lo, hi = b * chunk, min((b + 1) * chunk, rows)
        assert hi > lo
        for grp in range(G):
            seen[lo + grp:hi:G] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("d", [33, 96, 128, 256, 257, 960, 1024, 2048,
                               4096, 8192])
def test_threads_a_row_cover_it_once(d):
    cols, tpr = _thread_cols(d)
    got = sorted(c for c in cols.flatten().tolist() if c >= 0)
    assert got == list(range(d)) and (tpr == 16 or tpr % 32 == 0)
    assert tpr <= BWD_THREADS and BWD_THREADS // tpr >= 1
    if d == 128:               # half a warp a row: shuffles only
        assert tpr == 16
    if d == 960:               # a warp a row: shuffles only
        assert tpr == 32
    if d == 4096:              # a fixed small group of warps
        assert tpr == 128


def test_constants_are_the_cuda_sources():
    src = (CSRC / "rmsnorm.cu").read_text()
    flat = re.sub(r"\s+", "", src)   # layout-free: whitespace edits pass

    def define(name):
        return int(re.search(rf"#define\s+{name}\s+(\d+)", src).group(1))

    assert define("BWD_THREADS") == BWD_THREADS
    assert define("WARP_D") == WARP_D
    assert "constexprintNR=WARP_D/(16*VEC);" in flat      # half a warp
    assert "launch_rows<T,VEC,NR,3,2,16>" in flat and "chunk,16,vec," in flat
    assert "launch_rows<T,VEC,4,1,2,32>" in flat
    assert "launch_rows<T,VEC,8,1,1,32>" in flat
    assert "for(into=LANES>>1;o;o>>=1)" in flat
    # a half warp's shuffles name only its lanes: the other half's group may
    # have one row fewer in a ragged run, and leave the loop first
    assert "LANES==32?0xffffffffu:0xffffu<<(threadIdx.x&16);" in flat
    assert "constintw4=(runs+127)/128;" in flat
    assert "constintw8=(runs+255)/256;" in flat
    assert "ss=fmaf(xv,xv,ss);" in flat
    assert "dot=fmaf(to_f(gr.v[k])*wv[k],xv,dot);" in flat
    assert "acc[u][k]=fmaf(gv,xh,acc[u][k]);" in flat
    assert "for(intj=1;j<W;++j){a=red[par][grp*W+j];ss+=a.x;dot+=a.y;}" in flat
    assert "for(intj=1;j<G;++j)v+=sums[j*d+c];" in flat
    assert "for(intj=threadIdx.y;j<runs;j+=32)v+=part[(size_t)j*d+c];" in flat
    assert "for(intj=0;j<32;++j)t+=s[j][threadIdx.x];" in flat
