"""The attention wrappers' head padding (``repro_torch.kernels._pad``) on the
CPU.

The flash, dense-decode and paged-decode kernels are built for head widths
64 and 128; the REDUCED configs' heads are 16 (smollm-360m, zamba2-1.2b) and
24 (qwen3-8b) wide. The wrappers zero-pad q, k and v to the built width and
pass the true width's softmax scale. Here the same helper runs around the
plain versions: padded, scaled by the true width and sliced back, every
output must equal the unpadded plain attention bit for bit (the padded
products are exact zeros), at the REDUCED head counts, with a lane of
length 0 (zeros, ROADMAP Queue 3, P2). At a built width the helper must hand
the tensors through untouched. The kernels themselves are held on the card
(``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _pad, ref  # noqa: E402

# (H, K) of the REDUCED configs: qwen3-8b, smollm-360m, zamba2-1.2b
HEADS = [(4, 2), (6, 2), (4, 4)]


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(torch.bfloat16)


@pytest.fixture(scope="module")
def cases():
    """Inputs per (D, H, K): q, k, v for a prefill chunk, and a paged pool
    with its table and lengths (0, 1, ragged, full)."""
    rng = np.random.default_rng(0)
    out = {}
    for D in (16, 24, 32):
        for H, K in HEADS:
            P, max_pages, B = 16, 4, 4
            pool = 1 + B * max_pages
            table = torch.from_numpy(
                1 + rng.permutation(B * max_pages).reshape(B, max_pages)
            ).to(torch.int32)
            out[D, H, K] = dict(
                q=_bf16(rng, 2, 37, H, D), k=_bf16(rng, 2, 60, K, D),
                v=_bf16(rng, 2, 60, K, D), qd=_bf16(rng, B, H, D),
                kp=_bf16(rng, pool, P, K, D), vp=_bf16(rng, pool, P, K, D),
                table=table,
                lens=torch.tensor([0, 1, 37, P * max_pages], dtype=torch.int32))
    return out


@pytest.mark.parametrize("H,K", HEADS)
@pytest.mark.parametrize("D", [16, 24, 32])
@pytest.mark.parametrize("kind", ["causal", "offset", "full", "dense", "paged"])
def test_padded_plain_attention_equals_unpadded_bitwise(cases, kind, D, H, K):
    c = cases[D, H, K]
    if kind in ("causal", "offset", "full"):
        kw = {"causal": kind != "full", "q_offset": 23 if kind == "offset" else 0}
        args = (c["q"], c["k"], c["v"])
        fn = ref.attention
    elif kind == "dense":
        kw = {}
        B, S = c["qd"].shape[0], c["kp"].shape[1] * c["table"].shape[1]
        kd = c["kp"][c["table"].long()].reshape(B, S, K, D)
        vd = c["vp"][c["table"].long()].reshape(B, S, K, D)
        args = (c["qd"], kd, vd, c["lens"])
        fn = ref.decode_attention
    else:
        kw = {}
        args = (c["qd"], c["kp"], c["vp"], c["table"], c["lens"])
        fn = ref.paged_decode_attention
    want = fn(*args, **kw)
    got = _pad.run_padded(fn, *args, **kw)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want)
    if kind in ("dense", "paged"):
        assert not got[0].any()   # the lane of length 0


def test_padding_uses_the_true_width_scale(cases):
    """The padded tensors' own width would give another scale, and other
    bits: the helper must not take it from them."""
    c = cases[24, 4, 2]
    want = ref.attention(c["q"], c["k"], c["v"])
    p = [_pad.pad(t, 64) for t in (c["q"], c["k"], c["v"])]
    wrong = ref.attention(*p)[..., :24]
    assert not torch.equal(wrong, want)
    assert torch.equal(_pad.run_padded(ref.attention, c["q"], c["k"], c["v"]),
                       want)


@pytest.mark.parametrize("D,W", [(1, 64), (16, 64), (24, 64), (32, 64),
                                 (64, 64), (65, 128), (96, 128), (128, 128)])
def test_width_is_the_nearest_built_width(D, W):
    assert _pad.width(D) == W


def test_width_over_the_widest_kernel_raises():
    with pytest.raises(ValueError, match="at most 128"):
        _pad.width(129)


@pytest.mark.parametrize("D", [64, 128])
def test_built_widths_pass_the_tensors_through_untouched(D):
    """At 64 and 128 the kernel gets the caller's tensors (no copy of a
    page pool), the scale D ** -0.5, and its output as it is."""
    q, k, v = (torch.zeros(2, 3, D) for _ in range(3))
    extra = torch.zeros(2, dtype=torch.int32)
    seen = {}
    out = torch.zeros(2, 3, D)

    def fn(*args, scale):
        seen["args"], seen["scale"] = args, scale
        return out

    assert _pad.run_padded(fn, q, k, v, extra) is out
    assert all(a is b for a, b in zip(seen["args"], (q, k, v, extra)))
    assert seen["scale"] == D ** -0.5
