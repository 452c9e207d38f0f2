"""The plan of the row-invariant product, on the CPU.

``csrc/gemm_rows.cu`` cuts a product into work items (n tile, K segment)
walked by a persistent grid, and adds the segments' f32 partials in segment
order. A row's bits may depend only on that row and w, so every choice of
the cut is made by ``kernels/gemm_rows.py::plan`` from (K, N, the layout of
w, the SM count), never from the row count. The kernel cannot run here;
these tests hold the plan itself at every decode product of full-width and
REDUCED qwen3-8b, smollm-360m, phi4-mini-3.8b and minitron-4b
(``gemm_rows.decode_products``), in both layouts of w, and the constants
that the wrapper and the source share; and the grouped product's plan at
the MoE configs' expert products, and the shapes of an MoE decode step's
other products (granite-moe's tied 49,155-column unembedding among them).
"""

import inspect
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels import gemm_rows as gk  # noqa: E402

N_SM = 132  # the H100 SXM's SMs
SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
          / "gemm_rows.cu")
ARCHS = ("qwen3-8b", "smollm-360m", "phi4-mini-3.8b", "minitron-4b")
MOE_ARCHS = ("granite-moe-1b-a400m", "deepseek-moe-16b")


def _cases(widths):
    return [pytest.param(K, N, nk, reduced,
                         id=f"{arch}-{'reduced' if reduced else 'full'}-"
                            f"{name}-{'nk' if nk else 'kn'}")
            for arch in ARCHS for reduced in widths
            for name, K, N, _ in gk.decode_products(get(arch, reduced=reduced))
            for nk in (False, True)]


ALL = _cases((False, True))
FULL = _cases((False,))


@pytest.mark.parametrize("K,N,nk,reduced", ALL)
def test_segments_cover_k_once_in_order_on_the_k_step(K, N, nk, reduced):
    """Every tile's segments cover [0, K) once, in order, cut on the k
    step; the items are each tile's segments in order, tile by tile."""
    p = gk.plan(K, N, nk, N_SM)
    assert p.bk in (32, 64) and p.bn in (64, 128)
    assert p.n_tiles == -(-N // p.bn)
    for t in range(p.n_tiles):
        segs = p.segments(t)
        assert len(segs) == p.s_base + (t < p.extra) <= p.n_seg <= p.kt
        assert segs[0][0] == 0 and segs[-1][1] == K
        for (_, a1), (b0, _) in zip(segs, segs[1:]):
            assert a1 == b0  # contiguous, in merge order, no overlap
        for k0, k1 in segs:
            assert k0 < k1 and k0 % p.bk == 0
            assert k1 == K or k1 % p.bk == 0
    work = p.work()
    assert len(work) == p.items
    assert [w[:2] for w in work] == sorted(w[:2] for w in work)
    assert p.grid == min(N_SM, p.items)


def test_plan_takes_no_row_count():
    """The plan's parameters are (K, N, nk, n_sm): no row count, so the
    tile width, the k step and the segments are the same at every M."""
    assert list(inspect.signature(gk.plan).parameters) == ["K", "N", "nk",
                                                           "n_sm"]
    assert "M" not in gk.Plan._fields
    assert "M" not in inspect.signature(gk.Plan.work).parameters


@pytest.mark.parametrize("K,N,nk,reduced", FULL)
def test_full_width_products_give_every_sm_an_item(K, N, nk, reduced):
    p = gk.plan(K, N, nk, N_SM)
    assert p.items >= N_SM, p


@pytest.mark.parametrize("K,N,nk,reduced", ALL)
def test_scratch_per_row_is_independent_of_the_row_count(K, N, nk, reduced):
    p = gk.plan(K, N, nk, N_SM)
    per_row = {gk.plan(K, N, nk, N_SM).scratch_floats(M) / M
               for M in (*range(1, 65), 80, 128)}
    assert per_row == {p.n_seg * N if p.n_seg > 1 else 0}


@pytest.mark.parametrize("n_sm", [1, 78, 114, 132])
def test_plan_is_a_pure_function_of_its_arguments(n_sm):
    """Called again (and with the cache cleared) the plan is the same;
    every product's ring fits the block's shared memory."""
    shapes = {(K, N, nk) for arch in ARCHS for reduced in (False, True)
              for _, K, N, nk in gk.decode_products(get(arch, reduced=reduced))}
    first = {s: gk.plan(*s, n_sm) for s in shapes}
    gk.plan.cache_clear()
    for s, p in first.items():
        again = gk.plan(*s, n_sm)
        assert again == p
        stage = p.bk * p.bn * 2 + gk.X_STAGE
        assert p.stages * stage <= gk.RING_BYTES
        assert p.stages >= 8


def test_constants_mirror_the_source():
    """The wrapper's tile, pass and ring sizes are the kernel's, and so is
    its numbering of the items (``Plan.work`` mirrors ``item_at``)."""
    text = SOURCE.read_text()

    def define(name):
        return re.search(rf"#define {name} (.+?)\s", text + "\n").group(1)

    assert int(define("SUB_N")) == gk.SUB_N
    assert int(define("XROWS")) == gk.ROWS
    assert eval(re.search(r"#define RING_BYTES \((.+?)\)", text).group(1)) \
        == gk.RING_BYTES
    assert "X_STAGE (XROWS * 128)" in text and gk.X_STAGE == gk.ROWS * 128
    for line in ("const int wide = extra * (s_base + 1);",
                 "it.k0 = it.s * KT / it.n_seg;",
                 "it.k1 = (it.s + 1) * KT / it.n_seg;",
                 "const int per_pass = n_tiles * s_base + extra;"):
        assert line in text


def _moe_products(cfg):
    """(K, N, nk) of an MoE decode step's row-invariant products: q, k, v,
    o, the shared experts', the dense layers' and the unembedding."""
    d, dh = cfg.d_model, cfg.d_head
    out = [(d, cfg.n_heads * dh, False), (d, cfg.n_kv_heads * dh, False),
           (cfg.n_heads * dh, d, False),
           (d, cfg.vocab_size, cfg.tie_embeddings)]
    for width in (cfg.n_shared_experts * cfg.d_expert,
                  (cfg.d_ff_dense or cfg.d_ff) if cfg.first_k_dense else 0):
        if width:
            out += [(d, width, False), (width, d, False)]
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_moe_step_products_plan_to_whole_k(arch, reduced):
    """Every other product of an MoE decode step plans as a dense one does:
    segments cover K once on the k step, with an N no multiple of 8 (the
    tied 49,155-column unembedding) cut into tiles like any other."""
    for K, N, nk in _moe_products(get(arch, reduced=reduced)):
        p = gk.plan(K, N, nk, N_SM)
        assert p.n_tiles == -(-N // p.bn)
        for t in range(p.n_tiles):
            segs = p.segments(t)
            assert segs[0][0] == 0 and segs[-1][1] == K
        assert p.items >= N_SM or reduced


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_grouped_plan_takes_no_capacity_and_splits_nothing(arch, reduced):
    """The grouped plan of each routed-expert product: a function of (E,
    K, N, n_sm) alone, every tile whole (one segment, no partials), tiles
    that cover N, a ring that fits; at full width at least one item an
    SM."""
    assert list(inspect.signature(gk.plan_grouped).parameters) == [
        "E", "K", "N", "n_sm"]
    cfg = get(arch, reduced=reduced)
    for name, E, K, N in gk.grouped_products(cfg):
        p = gk.plan_grouped(E, K, N, N_SM)
        assert (p.s_base, p.extra, p.n_seg, p.bk) == (1, 0, 1, 64)
        assert p.scratch_floats(40) == 0
        assert p.n_tiles * p.bn >= N > (p.n_tiles - 1) * p.bn
        assert p.grid == min(N_SM, E * p.n_tiles)
        assert p.stages * (p.bk * p.bn * 2 + gk.X_STAGE) <= gk.RING_BYTES
        assert p.work() == [(t, 0, 0, p.kt) for t in range(p.n_tiles)]
        if not reduced:
            assert E * p.n_tiles >= N_SM, (name, p)
        gk.plan_grouped.cache_clear()
        assert gk.plan_grouped(E, K, N, N_SM) == p


def test_grouped_products_are_the_experts():
    cfg = get("deepseek-moe-16b")
    assert gk.grouped_products(cfg) == [("gate", 64, 2048, 1408),
                                        ("up", 64, 2048, 1408),
                                        ("down", 64, 1408, 2048)]


MM_ARCHS = ("whisper-medium", "llava-next-mistral-7b")


@pytest.mark.parametrize("arch", MM_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_multimodal_step_products_plan_to_whole_k(arch, reduced):
    """Every product of a multimodal decode step (``step_products``:
    whisper-medium's self and cross attention, GELU MLP and tied
    51,865-column unembedding; llava's as a dense config's) plans in both
    layouts of w as a dense one does: segments cover K once in order on
    the k step, tiles cover N, and at full width every SM gets an item."""
    cfg = get(arch, reduced=reduced)
    products = gk.step_products(cfg)
    names = [p[0] for p in products]
    if cfg.family == "encdec":
        assert names == ["q", "k", "v", "o", "cross q", "cross o", "wi",
                         "wd", "unembed"]
        assert products[-1][1:] == (cfg.d_model, cfg.vocab_size, True, 1)
    else:
        assert names == [p[0] for p in gk.decode_products(cfg)]
    for _, K, N, _, times in products:
        assert times in (1, cfg.n_layers)
        for nk in (False, True):
            p = gk.plan(K, N, nk, N_SM)
            assert p.n_tiles == -(-N // p.bn)
            for t in range(p.n_tiles):
                segs = p.segments(t)
                assert segs[0][0] == 0 and segs[-1][1] == K
                for (_, a1), (b0, _) in zip(segs, segs[1:]):
                    assert a1 == b0
                assert all(k0 % p.bk == 0 for k0, _ in segs)
            assert p.items >= N_SM or reduced, (K, N, nk, p)
