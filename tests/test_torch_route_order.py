"""The arithmetic order of the MoE router kernel, on the CPU.

The CUDA router (``csrc/moe_route.cu``) cuts ``x @ router`` over ``d``
across the blocks of a thread block cluster, as ``kernels/moe_route.py::
plan(d, E)`` says: block ``r`` owns a slice of the router's rows, thread
``j E + e`` folds expert ``e`` over run ``j`` of the slice in row order
with ``fmaf``, a block adds its runs' partials in run order, and the
token's ranking warp adds the blocks' partials in rank order; then a
softmax (max and sum by 32-lane butterflies) and the top-k, a tie to the
lower id, renormalised by ``max(sum, 1e-9)`` summed in pick order. Tokens
go through in tiles of 8 or 16 (``tile(T)``), zero-padded. A CUDA kernel
cannot run here, so this file holds a plain-torch mirror of that order
(each ``fmaf`` through f64, ``torch.exp`` for ``expf``) and shows:

- the mirror routes as the JAX package does (``repro/models/moe.py:
  208-212``, run as ``tests/test_torch_moe.py::_ref_route`` runs it) and as
  the port's plain version: ids equal except at a near tie (two of the
  first k + 1 probabilities within ``ROUTE_TIE``), weights within 1e-5, at
  both MoE configs' full ``(d, E, k)`` and at their REDUCED widths;
- a token's bits are the same alone and inside T = 8, 37, 40 and 256;
- ``plan`` reads no token count, covers ``d`` exactly once, and fits a
  block's shared memory and a portable cluster;
- the mirror's constants and orders are the CUDA source's.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels import moe_route as rk, ref  # noqa: E402

torch.set_num_threads(1)
ROUTE_TIE = 1e-7      # as tests/test_torch_gpu.py: a near tie
WEIGHT_TOL = dict(atol=1e-5, rtol=1e-5)
SMEM_BYTES = 232_448  # a block's shared memory on the H100 (227 KB)
CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
ARCHS = ["deepseek-moe-16b", "granite-moe-1b-a400m"]


def _fma(a, b, c):
    """f32 ``fmaf`` through f64: the product is exact there."""
    return (a.double() * b.double() + c.double()).float()


def logits_split(x, router, p):
    """The kernel's f32 logits of one tile ``x (TT, d)``: every run of every
    block folds its rows in order (all runs in lockstep), the runs' partials
    are added in run order, the blocks' in rank order."""
    TT = x.shape[0]
    runs = [p.runs(r) for r in range(p.C)]
    # rows[r, j, u]: the u-th row of run j of block r, or -1 past its end
    rows = torch.full((p.C, p.J, p.L), -1, dtype=torch.long)
    for r in range(p.C):
        for j, (lo, hi) in enumerate(runs[r]):
            if hi > lo:
                rows[r, j, :hi - lo] = torch.arange(lo, hi)
    acc = torch.zeros(p.C, p.J, TT, p.E)
    for u in range(p.L):
        idx = rows[:, :, u]
        live = (idx >= 0)[..., None, None]
        i = idx.clamp(min=0)
        xs = x[:, i].permute(1, 2, 0)[..., None]            # (C, J, TT, 1)
        rs = router[i][:, :, None, :]                       # (C, J, 1, E)
        acc = torch.where(live, _fma(xs, rs, acc), acc)
    blk = acc[:, 0]
    for j in range(1, p.J):
        blk = blk + acc[:, j]
    out = blk[0]
    for r in range(1, p.C):
        out = out + blk[r]
    return out


def _butterfly(v):
    """A 32-lane xor butterfly over the last dim (lanes), each step adding
    lane l's and lane l ^ o's values."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v


def rank(logits, k):
    """The ranking warp: softmax (max and sum by butterfly, lane l holding
    experts l, l + 32, ... and summing them in that order), the top-k (a
    tie to the lower id) and the renormalisation in pick order."""
    T, E = logits.shape
    per = -(-E // 32)
    lanes = torch.full((T, per * 32), float("-inf"))
    lanes[:, :E] = logits
    lanes = lanes.reshape(T, per, 32)
    m = lanes.max(-1).values.max(-1).values[:, None, None]
    p = torch.where(torch.isinf(lanes), torch.zeros(()),
                    torch.exp(lanes - m))
    s = p[:, 0]
    for q in range(1, per):
        s = s + p[:, q]
    s = _butterfly(s)[:, :1, None]
    probs = (p / s).reshape(T, per * 32)[:, :E]
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :k], ids[:, :k]
    total = torch.zeros(T)
    for r in range(k):
        total = total + weights[:, r]
    return weights / total.clamp(min=1e-9)[:, None], ids.to(torch.int32)


def route_split(x, router, k):
    """The kernel's routing of ``x (T, d)`` bf16 with ``router (d, E)``
    f32, tile by tile as the launch cuts the tokens."""
    T, d = x.shape
    p = rk.plan(d, router.shape[1])
    TT = rk.tile(T)
    xf, rf = x.float(), router.float()
    outs = []
    for t0 in range(0, T, TT):
        tile = torch.zeros(TT, d)
        n = min(TT, T - t0)
        tile[:n] = xf[t0:t0 + n]
        outs.append(logits_split(tile, rf, p)[:n])
    w, ids = rank(torch.cat(outs), k)
    return w, ids


def _ref_route(xf, router, k):
    """``repro/models/moe.py:208-212``."""
    logits = jnp.einsum("td,de->te", xf.astype(jnp.float32),
                        router.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    weights, sel = jax.lax.top_k(probs, k)
    weights = weights / jnp.maximum(weights.sum(-1, keepdims=True), 1e-9)
    return np.asarray(weights), np.asarray(sel), np.asarray(probs)


def _case(seed, T, d, E, scale):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((T, d), dtype=np.float32)
                         ).bfloat16()
    router = torch.from_numpy(
        (rng.standard_normal((d, E)) * scale).astype(np.float32))
    return x, router


def _near_ties(probs, k):
    top = -np.sort(-probs, axis=-1)[:, :k + 1]
    return ((top[:, :-1] - top[:, 1:]) < ROUTE_TIE).any(-1)


def _widths(arch, reduced):
    cfg = get(arch, reduced=reduced)
    return cfg.d_model, cfg.n_experts, cfg.moe_top_k


@pytest.mark.parametrize("scale", [1e-4, 3e-2])
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_mirror_routes_as_the_reference_and_the_plain_version(arch, reduced,
                                                              scale):
    d, E, k = _widths(arch, reduced)
    x, router = _case(d + E, 40, d, E, scale)
    w, ids = route_split(x, router, k)
    jw, jids, jprobs = _ref_route(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(router.numpy()), k)
    pw, pids = ref.moe_route(x, router, k)
    ties = _near_ties(jprobs, k)
    for want_w, want_ids in ((jw, jids), (pw.numpy(), pids.numpy())):
        same = (ids.numpy() == want_ids).all(-1)
        assert (same | ties).all(), np.flatnonzero(~(same | ties))
        np.testing.assert_allclose(w.numpy()[same], want_w[same],
                                   **WEIGHT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_tokens_bits_are_the_same_at_any_token_count(arch):
    d, E, k = _widths(arch, False)
    x, router = _case(7, 256, d, E, 1e-4)
    whole = route_split(x, router, k)
    for lo, T in ((0, 1), (0, 8), (3, 37), (5, 40), (0, 256)):
        part = route_split(x[lo:lo + T], router, k)
        assert torch.equal(part[0], whole[0][lo:lo + T]), T
        assert torch.equal(part[1], whole[1][lo:lo + T]), T


PLAN_CASES = [(2048, 64), (1024, 32), (64, 8), (64, 4), (8192, 256),
              (4096, 128), (500, 7), (513, 3), (100, 256), (1, 1), (33, 5)]


@pytest.mark.parametrize("d,E", PLAN_CASES)
def test_plan_covers_d_once_and_fits_the_card(d, E):
    p = rk.plan(d, E)
    assert list(inspect.signature(rk.plan).parameters) == ["d", "E"]
    covered = [i for r in range(p.C) for lo, hi in p.runs(r)
               for i in range(lo, hi)]
    assert covered == list(range(d))                 # once, in row order
    assert [s for s in p.slices() if s[1] <= s[0]] == []
    assert 1 <= p.C <= rk.MAX_C == 8                  # a portable cluster
    assert p.J * E <= rk.THREADS and p.S <= rk.MAX_D // rk.MAX_C
    assert max(p.smem_bytes(rk.tile(T)) for T in (1, 256)) <= SMEM_BYTES
    assert p.C == 1 or -(-d // p.C) >= rk.MIN_SLICE


def test_full_configs_split_over_a_cluster_of_eight():
    for arch in ARCHS:
        d, E, _ = _widths(arch, False)
        p = rk.plan(d, E)
        assert p.C == 8 and p.S * p.C == d
        # two blocks an SM
        assert 2 * (p.smem_bytes(16) + 1024) <= 233_472


def test_tiles_do_not_reach_into_the_plan():
    assert {rk.tile(T) for T in (1, 8, 40, 64)} == {8}
    assert {rk.tile(T) for T in (65, 256, 2048)} == {16}


def test_constants_are_the_cuda_sources():
    src = (CSRC / "moe_route.cu").read_text()
    flat = re.sub(r"\s+", "", src)   # layout-free: whitespace edits pass

    def define(name):
        return int(re.search(rf"#define\s+{name}\s+(\d+)", src).group(1))

    assert define("THREADS") == rk.THREADS
    assert define("MAX_E") == rk.MAX_E and define("MAX_K") == rk.MAX_K
    assert define("MAX_D") == rk.MAX_D and define("MAX_C") == rk.MAX_C
    assert "if(T<=64)returnlaunch_nq<8>" in flat       # tile(T)
    assert "returnlaunch_nq<16>" in flat
    assert "constintj=tid/E,e=tid-j*E;" in flat         # thread j E + e
    assert "constinti_lo=j*L,i_hi=min(i_lo+L,sl);" in flat  # run j
    assert "acc[4*q]=fmaf(a.x,r[u],acc[4*q]);" in flat  # rows in order
    assert "for(intjj=1;jj<J;++jj)v+=part" in flat       # run order
    assert "floatl=pr[0];" in flat                       # rank order
    assert "for(intrr=1;rr<MAX_C;++rr)if(rr<C)l+=pr[rr];" in flat
    assert "for(into=16;o;o>>=1)s+=__shfl_xor_sync" in flat
    assert "sum+=v;" in flat and "fmaxf(sum,1e-9f)" in flat  # pick order
    # a round's pick: the largest probability, then the lowest id
    assert "__reduce_min_sync(0xffffffffu,key==top?id:0xffffffffu)" in flat
