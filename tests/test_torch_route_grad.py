"""The MoE router's whole backward, dx and d_router, on the CPU.

On the card, ``MoeRoute``'s backward is two hand-written launches
(``csrc/moe_route_bwd.cu``): d_logits a warp a token, written as bf16
parts, then the einsum's two products on the tensor cores, each block a
slice of ``d``, a slice's 8 blocks (its ranks) dealt the token tiles in
turn, ``d_router`` summed in a fixed order that ``kernels/moe_route.py::
grads_plan(d, E)`` sets (16-token steps, dealt to ``G`` token groups in a
block; the groups' partials added in group order, then the ranks' in rank
order). A CUDA kernel cannot run here, so this file holds its plain
version, ``ref.moe_route_grads``, which sums in that order, and shows:

- ``(dx, d_router)`` equal ``jax.vjp`` of the reference's routing from
  ``x`` and the router on (``repro/models/moe.py:209-218``: the f32
  einsum, softmax, top-k, renormalisation and the Switch-style aux loss,
  run eagerly as ``tests/test_torch_train_moe.py`` runs it) at the REDUCED
  widths of granite-moe-1b-a400m and deepseek-moe-16b, from seeded numpy
  inputs: ``dx`` (bf16 in both) within ``DX_REL`` of its largest magnitude
  (one bf16 rounding of f32 values summed in other orders; measured <=
  5.9e-4), ``d_router`` within ``DROUTER_REL`` (f32 sums in other orders;
  measured <= 5.4e-7);
- the same against autograd through the plain forward ``ref.moe_route``;
- ``d_router`` in the kernel's order against ``x.float().T @ d_logits``
  within ``ORDER_REL`` (1e-5) relative, at REDUCED and at both MoE
  configs' full (d, E) over their 4096 training tokens (measured <=
  7.9e-7);
- ``ref.moe_route_dx_excess``, the card's element-by-element check of dx
  (one bf16 rounding of an f32-accurate product), passes the plain dx and
  the card's three split products and fails each product left out;
- the mirror's order is the one the plan describes, step by step;
- ``grads_plan`` reads no token count, covers ``d`` once, fits a block's
  shared memory and its registers' column groups, fills one wave of the
  H100 at the training widths, and its constants are the CUDA source's;
- the wrapper refuses CPU tensors (no fallback), and ``ops.moe_route``
  on the CPU differentiates the plain version.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels import moe_route as rk, ops, ref  # noqa: E402

torch.set_num_threads(1)
DX_REL = 1e-2
DROUTER_REL = 1e-5
ORDER_REL = 1e-5
SMEM_BYTES = 232_448  # a block's shared memory on the H100 (227 KB)
CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
ARCHS = ["granite-moe-1b-a400m", "deepseek-moe-16b"]


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 and back to f32 (both packages' x)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _ref_route(xf, router, k: int):
    """The reference's routing from its bf16 ``xf`` and router on
    (``repro/models/moe.py:209-218``): the renormalised top-k weights and
    the aux loss."""
    T, E = xf.shape[0], router.shape[1]
    logits = jnp.einsum("td,de->te", xf.astype(jnp.float32),
                        router.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    weights, sel = jax.lax.top_k(probs, k)
    weights = weights / jnp.maximum(weights.sum(-1, keepdims=True), 1e-9)
    counts = jnp.bincount(sel.reshape(-1), length=E)
    frac = counts.astype(jnp.float32) / (T * k)
    return weights, E * jnp.sum(probs.mean(0) * frac)


def _case(arch: str, T: int, seed: int):
    """Seeded numpy inputs at ``arch``'s REDUCED (d, E, k): bf16-exact rows
    like the normalized h, an f32 router at a scale that spreads the
    probabilities, the weights' gradient."""
    cfg = get(arch, reduced=True)
    d, E, k = cfg.d_model, cfg.n_experts, cfg.moe_top_k
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((T, d)).astype(np.float32))
    router = (rng.standard_normal((d, E)) * 0.2).astype(np.float32)
    dw = rng.standard_normal((T, k)).astype(np.float32)
    return x, router, dw, k


def _port_grads(x, router, dw, k, daux, order):
    """The port's plain forward, then ``ref.moe_route_grads`` from its
    outputs; the aux loss's gradient reaches the probabilities as ``daux E
    frac_e / T``."""
    T, E = x.shape[0], router.shape[1]
    xt = torch.from_numpy(x).bfloat16()
    rt = torch.from_numpy(router)
    weights, ids, probs = ref.moe_route(xt, rt, k, with_probs=True)
    counts = torch.zeros(E).scatter_add_(0, ids.reshape(-1).long(),
                                         torch.ones(T * k))
    dprobs = None if daux is None else (
        daux * E * counts / (T * k) / T).expand(T, E)
    return ref.moe_route_grads(xt, rt, probs, ids, weights,
                               torch.from_numpy(dw), dprobs, **order)


@pytest.mark.parametrize("daux", [0.7, 0.0, None])
@pytest.mark.parametrize("T", [37, 300])
@pytest.mark.parametrize("arch", ARCHS)
def test_plain_grads_equal_the_reference_vjp(arch, T, daux):
    """``ref.moe_route_grads`` in the kernel's order against ``jax.vjp`` of
    the reference's routing with respect to ``x`` (bf16) and the router."""
    x, router, dw, k = _case(arch, T, T + len(arch))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b: _ref_route(a, b, k), xj,
                     jnp.asarray(router))
    want_dx, want_dr = vjp((jnp.asarray(dw), jnp.float32(daux or 0.0)))
    assert want_dx.dtype == jnp.bfloat16
    d, E = router.shape
    dx, dr = _port_grads(x, router, dw, k, daux, rk.grads_plan(d, E).order())
    assert dx.dtype == torch.bfloat16 and dx.shape == (T, d)
    assert dr.dtype == torch.float32 and dr.shape == (d, E)
    assert _rel(dx.float().numpy(), np.asarray(want_dx, np.float32)) <= DX_REL
    assert _rel(dr.numpy(), np.asarray(want_dr)) <= DROUTER_REL


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_grads_equal_autograd_through_the_plain_forward(arch):
    """The same against ``torch.autograd`` through ``ref.moe_route`` (the
    oracle the card's checks also use)."""
    x, router, dw, k = _case(arch, 300, 5)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    rt = torch.from_numpy(router).requires_grad_()
    weights, ids, probs = ref.moe_route(xt, rt, k, with_probs=True)
    dprobs = torch.from_numpy(np.random.default_rng(6).standard_normal(
        probs.shape).astype(np.float32))
    want_dx, want_dr = torch.autograd.grad(
        (weights, probs), (xt, rt), (torch.from_numpy(dw), dprobs))
    d, E = router.shape
    dx, dr = ref.moe_route_grads(xt.detach(), rt.detach(), probs.detach(),
                                 ids, weights.detach(), torch.from_numpy(dw),
                                 dprobs, **rk.grads_plan(d, E).order())
    assert _rel(dx.float().numpy(), want_dx.float().numpy()) <= DX_REL
    assert _rel(dr.numpy(), want_dr.numpy()) <= DROUTER_REL


@pytest.mark.parametrize("T,d,E,k", [
    (300, 64, 4, 2), (300, 64, 8, 2), (37, 64, 6, 2), (4096, 1024, 32, 8),
    (4096, 2048, 64, 6), (1000, 64, 256, 16)])
def test_d_router_in_the_kernels_order_equals_the_product(T, d, E, k):
    """``d_router`` summed in the kernel's order (``grads_plan(d, E)``)
    within ORDER_REL of ``x.float().T @ d_logits``; dx exactly the f32
    product cast to bf16."""
    g = torch.Generator().manual_seed(T + d + E)
    x = torch.randn(T, d, generator=g).bfloat16()
    router = torch.randn(d, E, generator=g) * 0.05
    weights, ids, probs = ref.moe_route(x, router, k, with_probs=True)
    dw = torch.randn(T, k, generator=g)
    dprobs = torch.randn(T, E, generator=g)
    dx, dr = ref.moe_route_grads(x, router, probs, ids, weights, dw, dprobs,
                                 **rk.grads_plan(d, E).order())
    dl = ref.moe_route_bwd(probs, ids, weights, dw, dprobs)
    assert _rel(dr.numpy(), (x.float().t() @ dl).numpy()) <= ORDER_REL
    assert torch.equal(dx, (dl @ router.t()).bfloat16())


def _split_dx(dl: torch.Tensor, router: torch.Tensor, drop: str | None):
    """dx as the card forms it (``csrc/moe_route_bwd.cu``): d_logits' bf16
    parts hi and mid, R's bf16 hi and lo, the products hi hi, hi lo and mid
    hi summed in f32 and rounded once to bf16; ``drop`` leaves out
    ``"hi_lo"`` or ``"mid_hi"``, and ``"bf16"`` keeps hi hi alone (the
    product of bf16-rounded operands)."""
    hi = dl.bfloat16().float()
    mid = (dl - hi).bfloat16().float()
    rhi = router.bfloat16().float()
    rlo = (router - rhi).bfloat16().float()
    terms = {"hi_hi": hi @ rhi.t(), "hi_lo": hi @ rlo.t(),
             "mid_hi": mid @ rhi.t()}
    if drop == "bf16":
        return terms["hi_hi"].bfloat16()
    return sum(v for n, v in terms.items() if n != drop).bfloat16()


@pytest.mark.parametrize("drop", [None, "hi_lo", "mid_hi", "bf16"])
@pytest.mark.parametrize("T,d,E,k", [
    (300, 64, 4, 2), (37, 64, 6, 2), (300, 1024, 32, 8), (300, 2048, 64, 6),
    (37, 512, 256, 16)])
def test_dx_check_reads_the_f32_contract(T, d, E, k, drop):
    """``ref.moe_route_dx_excess`` (the card's element-by-element check of
    dx) is at most 1 for the plain dx and for the card's three split
    products, and over 1 when one product is left out or the operands are
    rounded to bf16 first: the check sees each product. Measured: the
    contract <= 0.96, a dropped product >= 8.3."""
    g = torch.Generator().manual_seed(T + d + E)
    x = torch.randn(T, d, generator=g).bfloat16()
    router = torch.randn(d, E, generator=g) * 0.05
    weights, ids, probs = ref.moe_route(x, router, k, with_probs=True)
    dl = ref.moe_route_bwd(probs, ids, weights, torch.randn(T, k, generator=g),
                           torch.randn(T, E, generator=g))
    dx = _split_dx(dl, router, drop)
    if drop is None:
        assert ref.moe_route_dx_excess(dx, dl, router) <= 1.0
        assert ref.moe_route_dx_excess((dl @ router.t()).bfloat16(), dl,
                                       router) <= 1.0
    else:
        assert ref.moe_route_dx_excess(dx, dl, router) > 1.0


@pytest.mark.parametrize("tile,ranks,groups", [
    (16, 1, 1), (64, 1, 2), (256, 4, 4), (128, 4, 2), (32, 3, 2)])
def test_the_mirrors_order_is_the_plans(tile, ranks, groups):
    """Step by step: 16-token products, tiles of ``tile`` dealt to
    ``ranks`` in turn, a rank's steps dealt to ``groups`` in turn, each
    group's steps added in ascending order, then the groups in order, then
    the ranks (rows past T zero: they add nothing)."""
    g = torch.Generator().manual_seed(tile + ranks + groups)
    T, d, E, k = 301, 16, 4, 2
    x = torch.randn(T, d, generator=g).bfloat16()
    router = torch.randn(d, E, generator=g)
    weights, ids, probs = ref.moe_route(x, router, k, with_probs=True)
    dw = torch.randn(T, k, generator=g)
    dl = ref.moe_route_bwd(probs, ids, weights, dw)
    part = torch.zeros(ranks, groups, d, E)
    for t0 in range(0, T, 16):
        tile_i, step = t0 // tile, t0 % tile // 16
        xb = torch.zeros(16, d)
        db = torch.zeros(16, E)
        xb[:min(16, T - t0)] = x[t0:t0 + 16].float()
        db[:min(16, T - t0)] = dl[t0:t0 + 16]
        part[tile_i % ranks, step % groups] += xb.t() @ db
    want = torch.zeros(d, E)
    for r in range(ranks):
        rank = torch.zeros(d, E)
        for q in range(groups):
            rank += part[r, q]
        want += rank
    _, dr = ref.moe_route_grads(x, router, probs, ids, weights, dw,
                                tile=tile, ranks=ranks, groups=groups)
    assert torch.equal(dr, want)


WIDTHS = [(d, E) for d in (8, 64, 1000, 1024, 2048, 2056, 4096, 8192)
          for E in (1, 4, 6, 8, 32, 64, 100, 256)]


@pytest.mark.parametrize("d,E", WIDTHS)
def test_grads_plan_covers_d_once_and_fits_a_block(d, E):
    """Every column of ``d`` in exactly one slice; ``CG`` a power of two
    within the kernel's register arrays (8 column groups, 4 at EP 256) and
    ``CG EP <= 1024``; whole token groups of 16-token steps a tile; the
    block's shared memory (two stages of d_logits' three bf16 parts and of
    x, R's two parts, the warps' staging rows of dx) within the H100's 227
    KB, and the final sums within the stages."""
    p = rk.grads_plan(d, E)
    cols = torch.zeros(d, dtype=torch.long)
    for b in range(p.slices):
        cols[b * p.S:min((b + 1) * p.S, d)] += 1
    assert bool((cols == 1).all()) and (p.slices - 1) * p.S < d
    assert p.S == 8 * p.CG and p.CG & (p.CG - 1) == 0
    assert p.CG <= (4 if p.EP == 256 else 8) and p.CG * p.EP <= 1024
    assert p.EP >= E and p.EP in (32, 64, 128, 256)
    assert p.TT * p.EP == rk.TILE_FLOATS and p.TT // 16 % p.G == 0
    assert p.C == rk.RANKS and p.blocks == p.slices * p.C
    assert p.G == max(1, 128 // p.EP)
    xs = 2 * p.TT * p.S * 2          # x's stages, as the TMA writes them
    ring = 2 * 3 * p.TT * (p.EP + 8) * 2
    stage = rk.GRADS_THREADS // 32 * 16 * 72 * 2   # the warps' rows of dx
    smem = 1024 + xs + ring + 2 * p.S * (p.EP + 8) * 2 + stage
    assert smem <= SMEM_BYTES
    assert p.G * p.S * p.EP * 4 <= xs + ring
    # a stage of x starts on its swizzle's span (16 CG bytes by 8 rows)
    assert p.TT * p.S * 2 % (128 * p.CG if p.CG > 1 else 16) == 0
    assert p.TT <= 256 and p.S <= 256    # a TMA box's sides


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_plan_fills_one_wave_at_the_training_widths(arch):
    """At the MoE configs' (d, E): 256 blocks, two on each of 128 of the
    H100's 132 SMs, one wave, 8 a slice; granite 32 columns a block,
    deepseek 64."""
    cfg = get(arch)
    p = rk.grads_plan(cfg.d_model, cfg.n_experts)
    assert p.blocks == 256 and p.C == 8
    assert p.blocks <= rk.BLOCKS_PER_SM * rk.SMS
    assert p.S == {"granite-moe-1b-a400m": 32, "deepseek-moe-16b": 64}[arch]


def test_grads_plan_refuses_what_the_kernel_does_not_take():
    """``d`` a multiple of 8 up to MAX_D, ``E`` up to MAX_E; no token count
    among the parameters."""
    for d, E in ((12, 4), (4, 4), (rk.MAX_D + 8, 4), (64, 0),
                 (64, rk.MAX_E + 1)):
        with pytest.raises(ValueError):
            rk.grads_plan(d, E)
    assert list(rk.GradsPlan._fields[:2]) == ["d", "E"]
    assert not any("T" == f for f in rk.GradsPlan._fields)


def test_the_plans_constants_are_the_cuda_sources():
    """The wrapper's constants and the plan's rules, read from
    ``csrc/moe_route_bwd.cu``."""
    src = (CSRC / "moe_route_bwd.cu").read_text()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))

    assert define("THREADS") == rk.GRADS_THREADS
    assert define("TILE_FLOATS") == rk.TILE_FLOATS
    assert define("RANKS") == rk.RANKS
    assert re.search(r"__launch_bounds__\(THREADS, (\d+)\) moe_route_grads_kernel",
                     src).group(1) == str(rk.BLOCKS_PER_SM)
    assert define("MAX_E") == rk.MAX_E and define("MAX_K") == rk.MAX_K
    assert "CG * EP > 1024" in src and "d % 8 != 0" in src
    assert "CG > 8 || (CG & (CG - 1)) != 0" in src
    assert "MAXCG = EP == 256 ? 4 : 8" in src
    assert "return E <= 32 ? 32 : E <= 64 ? 64 : E <= 128 ? 128 : 256;" in src
    # the order of d_router's sums: tiles dealt to ranks, steps to groups,
    # groups then ranks in order
    assert "for (int tile = rank; tile < ntiles; tile += RANKS, ++it)" in src
    assert "for (int ks = gw; ks < MT; ks += GW)" in src
    assert "for (int q = 1; q < GW; ++q) v += red[" in src
    assert "for (int q = 1; q < RANKS; ++q) sum += v[q][u];" in src


def test_the_wrapper_refuses_cpu_tensors():
    """On CPU tensors the kernels' wrapper raises: the CPU runs the plain
    version only through ``ops``."""
    x = torch.zeros(4, 64).bfloat16()
    router = torch.zeros(64, 4)
    weights, ids, probs = ref.moe_route(x, router, 2, with_probs=True)
    with pytest.raises(ValueError):
        rk.moe_route_bwd(x, router, probs, ids, weights, torch.zeros(4, 2))


def test_ops_differentiates_the_plain_version_on_the_cpu():
    """``ops.moe_route`` with a gradient on CPU tensors counts a plain call
    of the backward and gives ``ref.moe_route_grads``' gradients."""
    x, router, dw, k = _case("granite-moe-1b-a400m", 40, 9)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    rt = torch.from_numpy(router).requires_grad_()
    before = ops.plain_calls["moe_route_bwd"]
    weights, ids, probs = ops.moe_route(xt, rt, k, with_probs=True)
    assert ops.plain_calls["moe_route_bwd"] == before + 1
    dprobs = torch.full(probs.shape, 0.1)
    dx, dr = torch.autograd.grad((weights, probs), (xt, rt),
                                 (torch.from_numpy(dw), dprobs))
    d, E = router.shape
    pdx, pdr = ref.moe_route_grads(xt.detach(), rt.detach(), probs.detach(),
                                   ids, weights.detach(),
                                   torch.from_numpy(dw), dprobs,
                                   **rk.grads_plan(d, E).order())
    assert _rel(dx.float().numpy(), pdx.float().numpy()) <= DX_REL
    assert _rel(dr.numpy(), pdr.numpy()) <= DROUTER_REL
