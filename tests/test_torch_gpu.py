"""The port's Hopper kernels on the card, against their plain versions.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
test). On the H100: ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_gpu.py``. This file imports only torch and the port, so it
runs where JAX is not installed. ``chip_smoke.py`` covers the main path's
full shapes; these are small shapes, bf16, atol = rtol = 2e-2.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card():
    """On the H100: each kernel against its plain version, bf16, at small
    shapes (``chip_smoke.py`` covers the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    x = rnd(37, 4096)
    w = torch.ones(4096, device=dev)
    with ops.use_backend("plain"):
        want = ops.rmsnorm(x, w)
    torch.testing.assert_close(ops.rmsnorm(x, w).float(), want.float(),
                               atol=2e-2, rtol=2e-2)
    q, k, v = rnd(1, 100, 8, 128), rnd(1, 300, 2, 128), rnd(1, 300, 2, 128)
    with ops.use_backend("plain"):
        want = ops.attention(q, k, v, q_offset=200)
    torch.testing.assert_close(ops.attention(q, k, v, q_offset=200).float(),
                               want.float(), atol=2e-2, rtol=2e-2)
    pages = rnd(9, 64, 2, 128)
    table = torch.arange(1, 9, device=dev, dtype=torch.int32).reshape(2, 4)
    lens = torch.tensor([0, 200], device=dev, dtype=torch.int32)
    qd = rnd(2, 8, 128)
    with ops.use_backend("plain"):
        want = ops.paged_decode_attention(qd, pages, pages, table, lens)
    got = ops.paged_decode_attention(qd, pages, pages, table, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("S,h0_scale", [(37, 0.0), (200, 0.1), (300, 0.1)])
def test_ssm_kernels_match_plain_versions_on_the_card(S, h0_scale):
    """On the H100: the selective scan and the SSD against their plain
    versions, ragged lengths (SSD over one and over two chunks of 256) and
    nonzero initial states; y in bf16 at atol = rtol = 2e-2, the f32 final
    state at 5e-3 (``tests/test_kernels.py:106,128``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(S)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=dev)

    B, Di, N = 2, 200, 16
    ins = [rnd(B, S, Di, scale=0.5).bfloat16(),
           (rnd(B, S, Di).abs() * 0.1).bfloat16(),
           -(rnd(Di, N).abs() + 0.1),
           rnd(B, S, N, scale=0.5).bfloat16(), rnd(B, S, N, scale=0.5).bfloat16(),
           rnd(Di), rnd(B, Di, N, scale=h0_scale)]
    with ops.use_backend("plain"):
        yw, hw = ops.selective_scan(*ins)
    y, hT = ops.selective_scan(*ins)
    torch.testing.assert_close(y.float(), yw.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(hT, hw, atol=5e-3, rtol=5e-3)

    B, Hs, P, N = 2, 3, 48, 64
    ins = [rnd(B, S, Hs, P, scale=0.5).bfloat16(),
           (rnd(B, S, Hs).abs() * 0.1).bfloat16(),
           -(rnd(Hs).abs() + 0.1),
           rnd(B, S, N, scale=0.5).bfloat16(), rnd(B, S, N, scale=0.5).bfloat16(),
           rnd(Hs), rnd(B, Hs, P, N, scale=h0_scale)]
    with ops.use_backend("plain"):
        yw, hw = ops.ssd(*ins, chunk=256)
    y, hT = ops.ssd(*ins, chunk=256)
    torch.testing.assert_close(y.float(), yw.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(hT, hw, atol=5e-3, rtol=5e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("H,K,D", [(8, 2, 128), (32, 32, 64), (16, 2, 64)])
def test_decode_attention_matches_plain_version_on_the_card(H, K, D):
    """On the H100: the dense-cache decode kernel against its plain
    version, bf16 at atol = rtol = 2e-2, lengths 0 (zeros), 1, ragged and
    S; a lane's result does not change with its batch, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(H + D)
    B, S = 5, 300

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    q, k, v = rnd(B, H, D), rnd(B, S, K, D), rnd(B, S, K, D)
    lens = torch.tensor([0, 1, 77, S, 256], device=dev, dtype=torch.int32)
    with ops.use_backend("plain"):
        want = ops.decode_attention(q, k, v, lens)
    got = ops.decode_attention(q, k, v, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert not got[0].any()
    alone = ops.decode_attention(q[2:3], k[2:3], v[2:3], lens[2:3])
    assert torch.equal(alone[0], got[2])


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset", [0, 211])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_matches_plain_version_on_the_card(D, G, q_offset,
                                                           causal):
    """On the H100: the warpgroup flash kernel against its plain version,
    bf16 at atol = rtol = 2e-2; B 2, Sq 100 (not a multiple of the 64-row
    query tile), Sk 333 (not a multiple of the 64-key tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(D + G + q_offset)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    K = 2
    q, k, v = rnd(2, 100, K * G, D), rnd(2, 333, K, D), rnd(2, 333, K, D)
    with ops.use_backend("plain"):
        want = ops.attention(q, k, v, causal=causal, q_offset=q_offset)
    got = ops.attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("H,K,D", [(8, 2, 128), (32, 32, 64), (16, 2, 64)])
def test_split_decode_matches_plain_version_on_the_card(H, K, D, layout):
    """On the H100: both decode kernels (one template, 256-key segments
    merged by the last block to finish) against their plain versions at
    lengths 0, 1, SEG - 1, SEG, SEG + 1, cap - 1 and cap (cap = 640 keys:
    a dense S, or 10 pages of 64), bf16 at atol = rtol = 2e-2; and a lane's
    bits do not move alone, among lanes all longer than it, or over a
    cache of another capacity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels._flash_decode import SEG

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(H + D)
    P, max_pages = 64, 10
    cap = P * max_pages
    lengths = [0, 1, SEG - 1, SEG, SEG + 1, cap - 1, cap]
    B = len(lengths)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    q = rnd(B, H, D)
    lens = torch.tensor(lengths, device=dev, dtype=torch.int32)
    if layout == "dense":
        k, v = rnd(B, cap, K, D), rnd(B, cap, K, D)

        def run(qq, ll, lanes=slice(None), extra=0):
            kk, vv = k[lanes], v[lanes]
            if extra:
                pad = torch.zeros(kk.shape[0], extra, K, D, device=dev,
                                  dtype=kk.dtype)
                kk, vv = torch.cat([kk, pad], 1), torch.cat([vv, pad], 1)
            return ops.decode_attention(qq, kk.contiguous(), vv.contiguous(),
                                        ll)
    else:
        pages = rnd(B * max_pages + 1, P, K, D)
        vpages = rnd(B * max_pages + 1, P, K, D)
        table = (torch.randperm(B * max_pages, device=dev) + 1).to(
            torch.int32).reshape(B, max_pages)

        def run(qq, ll, lanes=slice(None), extra=0):
            t = table[lanes]
            if extra:
                t = torch.cat([t, t[:, :extra // P]], 1)
            return ops.paged_decode_attention(qq, pages, vpages,
                                              t.contiguous(), ll)

    got = run(q, lens)
    with ops.use_backend("plain"):
        want = run(q, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert not got[0].any()
    assert torch.equal(run(q, lens), got)
    for lane in (2, 4, 5):  # SEG - 1, SEG + 1, cap - 1
        one = slice(lane, lane + 1)
        longer = torch.full_like(lens, cap)
        longer[lane] = lens[lane]
        assert torch.equal(run(q[one], lens[one], one)[0], got[lane])
        assert torch.equal(run(q, longer)[lane], got[lane])
        assert torch.equal(run(q[one], lens[one], one, extra=3 * P)[0],
                           got[lane])
