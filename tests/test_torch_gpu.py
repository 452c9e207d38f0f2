"""The port's Hopper kernels on the card, against their plain versions.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
test). On the H100: ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_gpu.py``. This file imports only torch and the port (and,
on the card, ``chip_smoke.py``, which imports nothing else), so it runs
where JAX is not installed. ``chip_smoke.py`` covers the main path's
full shapes; these are small shapes, bf16, atol = rtol = 2e-2.
"""

import os

import pytest

# the train step runs in torch's deterministic mode, whose cuBLAS needs this
# before CUDA starts (repro_torch/training/step.py)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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


def _ssd_inputs(g, B, S, Hs, P, N, h0_scale):
    dev = "cuda"

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=dev)

    return [rnd(B, S, Hs, P, scale=0.5).bfloat16(),
            (rnd(B, S, Hs).abs() * 0.1).bfloat16(),
            -(rnd(Hs).abs() + 0.1),
            rnd(B, S, N, scale=0.5).bfloat16(),
            rnd(B, S, N, scale=0.5).bfloat16(),
            rnd(Hs), rnd(B, Hs, P, N, scale=h0_scale)]


# the SSD's f32 contract: its final state within this share of the plain
# f32 state's largest value (``chip_smoke.py``'s ``SSD_STATE_REL``)
SSD_STATE_REL = 1e-4


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("h0_scale", [0.0, 0.1])
@pytest.mark.parametrize("S", [37, 256, 300, 600])
@pytest.mark.parametrize("P,N", [(48, 64), (64, 64), (16, 8)])
def test_ssd_matches_plain_version_on_the_card(P, N, S, h0_scale):
    """On the H100: the tensor-core SSD (chunk-local states in parallel, the
    state passed in chunk order, y per query tile) against its plain
    version at P 48 and 64 with N 64 (zamba2-1.2b's widths) and P 16 with
    N 8 (its REDUCED config's), chunk 256, ragged S over one to three
    chunks, from a zero and a nonzero state; y in bf16 at atol = rtol =
    2e-2, the f32 final state at 5e-3 (``tests/test_kernels.py:106,128``)
    and within 1e-4 of the plain state's largest value (the f32
    contract)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(P + N + S)
    ins = _ssd_inputs(g, 2, S, 5, P, N, h0_scale)
    with ops.use_backend("plain"):
        yw, hw = ops.ssd(*ins, chunk=256)
    y, hT = ops.ssd(*ins, chunk=256)
    torch.testing.assert_close(y.float(), yw.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(hT, hw, atol=5e-3, rtol=5e-3)
    assert _rel_err(hT, hw) <= SSD_STATE_REL


@pytest.mark.gpu
def test_ssd_state_limit_rejects_plain_bf16_operands(tmp_path, monkeypatch):
    """On the H100: the 1e-4 limit on the SSD's final state tells the f32
    contract from plain bf16. The same source, built from a copy of
    ``csrc/`` whose hi + lo split keeps the hi half only (every f32 operand
    rounded to bf16, ~2^-9 a product), misses the limit on inputs where the
    kernel meets it. Prints both readings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import shutil

    from repro_torch.kernels import _build, ssd as dk

    g = torch.Generator(device="cuda").manual_seed(0)
    ins = _ssd_inputs(g, 1, 600, 8, 64, 64, 0.1)
    with ops.use_backend("plain"):
        _, hw = ops.ssd(*ins, chunk=256)
    split = _rel_err(dk.ssd(*ins, chunk=256)[1], hw)
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    mma = csrc / "mma.cuh"
    text = mma.read_text()
    lo = "lo = pack_bf16(__floats2bfloat162_rn(a - f.x, b - f.y));"
    assert text.count(lo) == 1
    mma.write_text(text.replace(lo, "lo = 0u;"))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    dk._lib.cache_clear()
    try:
        hi_only = _rel_err(dk.ssd(*ins, chunk=256)[1], hw)
    finally:
        dk._lib.cache_clear()
    print(f"ssd hT relative error: hi + lo {split:.4g}, hi only {hi_only:.4g}")
    assert split <= SSD_STATE_REL < hi_only


@pytest.mark.gpu
@pytest.mark.parametrize("S", [600, 2048])
def test_ssd_whole_call_equals_chained_chunk_calls_on_the_card(S):
    """On the H100: one SSD call over S steps and successive calls of 256
    steps, each carrying hT into the next h0 (the paged engine's chunked
    prefill), give the same y and hT bit for bit (the dense engine is the
    paged one's oracle)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ssd as dk

    g = torch.Generator(device="cuda").manual_seed(S)
    x, dt, A, Bm, C, D, h0 = _ssd_inputs(g, 1, S, 8, 64, 64, 0.1)
    y, hT = dk.ssd(x, dt, A, Bm, C, D, h0, chunk=256)
    h, parts = h0, []
    for t0 in range(0, S, 256):
        t1 = min(S, t0 + 256)
        yc, h = dk.ssd(x[:, t0:t1], dt[:, t0:t1], A, Bm[:, t0:t1],
                       C[:, t0:t1], D, h, chunk=256)
        parts.append(yc)
    assert torch.equal(torch.cat(parts, 1), y)
    assert torch.equal(h, hT)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("d", [33, 64, 128, 960, 2048, 4096, 8192])
def test_rmsnorm_matches_plain_version_on_the_card(d, dtype):
    """On the H100: the CUDA RMSNorm against its plain version at atol =
    rtol = 2e-2, on the warp path (d <= 256) and the block path, with
    d not a multiple of the vector width (33, and 960's runs at f32), and
    w in f32 and in x's type; and a row's bits do not depend on how many
    rows share the call (8 or 8,192)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import rmsnorm as rk

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(d)
    x = torch.randn(8192, d, generator=g, device="cuda").to(dt)
    w = 1 + 0.1 * torch.randn(d, generator=g, device="cuda")
    for wt in (w, w.to(dt)):
        with ops.use_backend("plain"):
            want = ops.rmsnorm(x, wt, 1e-6)
        got = ops.rmsnorm(x, wt, 1e-6)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    few = rk.rmsnorm(x[:8].clone(), w, 1e-6)
    many = rk.rmsnorm(x, w, 1e-6)
    assert torch.equal(few, many[:8])
    odd = rk.rmsnorm(x[1:4], w, 1e-6)  # rows off the 16-byte alignment
    assert torch.equal(odd, many[1:4])


# the scan's final state: within this share of the plain f32 state's
# largest value (``chip_smoke.py``'s ``SCAN_STATE_REL``)
SCAN_STATE_REL = 1e-4


def _scan_inputs(g, B, S, Di, N, h0_scale):
    dev = "cuda"

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=dev)

    return [rnd(B, S, Di, scale=0.5).bfloat16(),
            (rnd(B, S, Di).abs() * 0.1).bfloat16(),
            -(rnd(Di, N).abs() + 0.1),
            rnd(B, S, N, scale=0.5).bfloat16(),
            rnd(B, S, N, scale=0.5).bfloat16(),
            rnd(Di), rnd(B, Di, N, scale=h0_scale)]


@pytest.mark.gpu
@pytest.mark.parametrize("S", [37, 300, 600])
@pytest.mark.parametrize("Di", [200, 37])
@pytest.mark.parametrize("N", [4, 16, 64])
def test_selective_scan_matches_plain_version_on_the_card(N, Di, S):
    """On the H100: the time-parallel scan against its plain version at N
    4 (falcon-mamba-7b's REDUCED config), 16 (its published one) and 64,
    Di 200 (a ragged 32-channel block, 16-byte staging) and 37 (the scalar
    path), ragged S over one to three 256-step tiles, from a nonzero state;
    y in bf16 at atol = rtol = 2e-2, the f32 state at 5e-3
    (``tests/test_kernels.py:106``) and within 1e-4 of the plain state's
    largest value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(N + Di + S)
    ins = _scan_inputs(g, 2, S, Di, N, 0.1)
    with ops.use_backend("plain"):
        yw, hw = ops.selective_scan(*ins)
    y, hT = ops.selective_scan(*ins)
    torch.testing.assert_close(y.float(), yw.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(hT, hw, atol=5e-3, rtol=5e-3)
    assert _rel_err(hT, hw) <= SCAN_STATE_REL


@pytest.mark.gpu
@pytest.mark.parametrize("S", [600, 2048])
def test_selective_scan_whole_call_equals_chained_tile_calls_on_the_card(S):
    """On the H100: one scan call over S steps and successive calls cut at
    multiples of 256 (every 256, and once at 512), each carrying hT into the
    next h0, give the same y and hT bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import selective_scan as sk

    g = torch.Generator(device="cuda").manual_seed(S)
    x, dt, A, Bm, C, D, h0 = _scan_inputs(g, 1, S, 8192, 16, 0.1)
    y, hT = sk.selective_scan(x, dt, A, Bm, C, D, h0)
    for edges in (list(range(0, S, 256)) + [S], [0, 512, S]):
        h, parts = h0, []
        for t0, t1 in zip(edges[:-1], edges[1:]):
            yc, h = sk.selective_scan(x[:, t0:t1], dt[:, t0:t1], A,
                                      Bm[:, t0:t1], C[:, t0:t1], D, h)
            parts.append(yc)
        assert torch.equal(torch.cat(parts, 1), y)
        assert torch.equal(h, hT)


@pytest.mark.gpu
def test_selective_scan_rows_and_identity_steps_on_the_card():
    """On the H100: each batch row of the scan gives the same bits alone
    as in a batch of 3; and steps with dt = 0 (how the model pads a short
    chunk) leave the state bitwise as it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import selective_scan as sk

    g = torch.Generator(device="cuda").manual_seed(3)
    ins = _scan_inputs(g, 3, 300, 256, 16, 0.1)
    y, hT = sk.selective_scan(*ins)
    x, dt, A, Bm, C, D, h0 = ins
    for r in range(3):
        one = slice(r, r + 1)
        y1, h1 = sk.selective_scan(x[one], dt[one], A, Bm[one], C[one], D,
                                   h0[one])
        assert torch.equal(y1, y[one]) and torch.equal(h1, hT[one])
    dt = dt.clone()
    dt[:, 200:] = 0
    _, h_pad = sk.selective_scan(x, dt, A, Bm, C, D, h0)
    _, h200 = sk.selective_scan(x[:, :200], dt[:, :200], A, Bm[:, :200],
                                C[:, :200], D, h0)
    assert torch.equal(h_pad, h200)


# (H, K, D) of the REDUCED configs: qwen3-8b, smollm-360m, zamba2-1.2b; and
# D 32 at qwen3-8b's head counts
REDUCED_HEADS = [(4, 2, 24), (6, 2, 16), (4, 4, 16), (4, 2, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("H,K,D", REDUCED_HEADS)
def test_attention_kernels_take_reduced_head_widths_on_the_card(H, K, D):
    """On the H100: flash (causal at two offsets, and full), the dense
    decode and the paged decode at the REDUCED configs' head widths, which
    the wrappers zero-pad to 64 and run at the true width's scale, against
    their plain versions at atol = rtol = 2e-2, with a lane of length 0
    (zeros, ROADMAP Queue 3, P2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(H * 100 + D)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    q, k, v = rnd(2, 50, H, D), rnd(2, 150, K, D), rnd(2, 150, K, D)
    for causal, off in ((True, 0), (True, 100), (False, 0)):
        with ops.use_backend("plain"):
            want = ops.attention(q, k, v, causal=causal, q_offset=off)
        got = ops.attention(q, k, v, causal=causal, q_offset=off)
        assert got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    P, max_pages, B = 16, 16, 4
    lens = torch.tensor([0, 1, 100, P * max_pages], device=dev,
                        dtype=torch.int32)
    qd = rnd(B, H, D)
    kp, vp = rnd(B * max_pages + 1, P, K, D), rnd(B * max_pages + 1, P, K, D)
    table = (torch.randperm(B * max_pages, device=dev) + 1).to(
        torch.int32).reshape(B, max_pages)
    kd = kp[table.long()].reshape(B, P * max_pages, K, D)
    vd = vp[table.long()].reshape(B, P * max_pages, K, D)
    for name, args in (("paged", (qd, kp, vp, table, lens)),
                       ("dense", (qd, kd, vd, lens))):
        fn = ops.paged_decode_attention if name == "paged" \
            else ops.decode_attention
        with ops.use_backend("plain"):
            want = fn(*args)
        got = fn(*args)
        assert got.shape == (B, H, D)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        assert not got[0].any()


@pytest.mark.gpu
def test_page_payloads_round_trip_bit_for_bit_on_the_card():
    """On the H100, at qwen3-8b's full-width page (36 layers, 64 positions,
    8 kv heads of 128, bf16): the batched extraction gives each page's
    single-page blob byte for byte, and the batched install writes those
    bits into other pages of a blank cache, touching nothing else."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.serving.kvcache import (
        extract_page_payload,
        extract_page_payloads,
        install_page_payloads,
    )

    g = torch.Generator(device="cuda").manual_seed(7)
    shape = (36, 12, 64, 8, 128)
    cache = {k: torch.randn(*shape, generator=g, device="cuda").to(
        torch.bfloat16) for k in ("k_pages", "v_pages")}
    pages, dst = [3, 7, 1, 10], [5, 2, 11, 8]
    blobs = extract_page_payloads(cache, pages)
    assert blobs == [extract_page_payload(cache, p) for p in pages]
    blank = {k: torch.zeros_like(v) for k, v in cache.items()}
    install_page_payloads(blank, dst, blobs)
    for k, v in cache.items():
        assert torch.equal(blank[k][:, dst].view(torch.int16),
                           v[:, pages].view(torch.int16))
        rest = [p for p in range(shape[1]) if p not in dst]
        assert not blank[k][:, rest].any()
    assert extract_page_payloads(blank, dst) == blobs


@pytest.mark.gpu
def test_spill_engine_gives_the_retain_engines_tokens_on_the_card():
    """On the H100, REDUCED qwen3-8b (heads padded to 64): under page
    pressure the spill engine lends cold prefix pages and recalls them, and
    its greedy tokens equal those of an engine whose pool retires nothing
    (``tests/test_spill.py``'s round trip)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.core import CloudletRegistry, ReliabilityRegistry
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.kvcache import RemotePagePool

    model = get_model(get("qwen3-8b", reduced=True))
    params = model.init(0, device="cuda")
    reg = CloudletRegistry()
    reg.create("serve", "qwen3-8b")
    rel = ReliabilityRegistry()
    for h in ("h0", "h1", "h2"):
        reg.join("serve", h)
        rel.add_host(h)
    remote = RemotePagePool(reg, "serve", "h0", reliability=rel)
    kw = dict(n_slots=1, max_seq=96, page_size=16, prefill_chunk=32,
              device="cuda")
    spill = ServeEngine(model, params, n_pages=6, remote_pool=remote, **kw)
    retain = ServeEngine(model, params, n_pages=64, **kw)
    rng = np.random.default_rng(1)
    vocab = model.cfg.vocab_size
    prefixes = [rng.integers(1, vocab, 32).tolist() for _ in range(2)]
    outs = {id(spill): [], id(retain): []}
    for r in range(2):
        for i, pre in enumerate(prefixes):
            tails = np.random.default_rng(100 * r + i).integers(1, vocab,
                                                                (2, 6))
            for eng in (spill, retain):
                reqs = [eng.submit(pre + t.tolist(), max_new_tokens=4)
                        for t in tails]
                eng.run(400)
                outs[id(eng)] += [r_.generated for r_ in reqs]
    assert spill.stats["pages_spilled"] > 0
    assert spill.stats["pages_recalled"] > 0
    assert retain.stats["prefix_evictions"] == 0
    assert outs[id(spill)] == outs[id(retain)]


ROW_COUNTS = (*range(1, 65), 80, 128)


def _rows_invariant(mm, w, x) -> dict:
    """Bitwise verdicts of ``mm`` at every row count of ``ROW_COUNTS`` (``x``
    has 128 rows): each M-row product's rows against the same rows of the
    128-row one (so the first 8 against the 8-row decode step's, row for
    row), row 37 alone against its place in the 40-row product, and two
    launches in a row on one stream."""
    out = {M: mm(x[:M], w) for M in ROW_COUNTS}
    return {"rows": all(torch.equal(out[M], out[128][:M]) for M in out),
            "M40": torch.equal(out[40][:8], out[8]),
            "row37": torch.equal(mm(x[37:38], w), out[40][37:38]),
            "again": torch.equal(mm(x[:40], w), out[40])}


def _weight(g, K, N, nk):
    """A (K, N) weight, or the transpose of a contiguous (N, K) one."""
    w = (torch.randn(N, K, generator=g, device="cuda") * K ** -0.5).bfloat16()
    return w.t() if nk else w.reshape(K, N)


@pytest.mark.gpu
def test_decode_products_are_row_invariant_on_the_card():
    """On the H100, at each product of full-width qwen3-8b's and
    smollm-360m's decode step, with w in both layouts ((K, N), and the
    transpose of an (N, K) tensor, as smollm-360m's tied unembedding): the
    product the paged decode step takes (``ops.gemm_rows``) gives a row the
    same bits at every row count from 1 to 64, at 80 and at 128 (the
    16-slot k = 4 verify, and two 64-row passes), wherever the row sits,
    and in two launches in a row, so the 40-row verify of a k = 4 window
    equals the 8-row decode step; it leaves the shared counters at zero.
    cuBLAS's verdicts are printed beside it (``-s``): it picks its kernel
    from the row count, and differs at 4096 -> 1024."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get
    from repro_torch.kernels import _flash_decode
    from repro_torch.kernels.gemm_rows import decode_products

    g = torch.Generator(device="cuda").manual_seed(3)
    for arch in ("qwen3-8b", "smollm-360m"):
        for name, K, N, tied in decode_products(get(arch)):
            for nk in (False, True):
                w = _weight(g, K, N, nk)
                x = torch.randn(128, K, generator=g, device="cuda").bfloat16()
                ours = _rows_invariant(ops.gemm_rows, w, x)
                cnt = _flash_decode.counters(1, w.device)
                ours["counters_zero"] = bool((cnt == 0).all())
                print(arch, name, K, N, "nk" if nk else "kn", "gemm_rows",
                      ours, "cuBLAS" if nk == tied else "",
                      _rows_invariant(torch.matmul, w, x) if nk == tied
                      else "")
                assert all(ours.values()), (arch, name, nk, ours)
                del w


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-8b", "smollm-360m"])
def test_gemm_rows_matches_plain_version_on_the_card(arch):
    """On the H100: the row-invariant product against its plain version
    (``x @ w``, cuBLAS) at each decode product of the full-width config,
    8 and 40 rows, bf16 atol = rtol = 2e-2, with w in both layouts
    (smollm-360m's unembedding is its tied embedding's transpose, w as
    (N, K)). And at the REDUCED widths (K 96: three 32-wide k steps;
    ``test_gemm_rows_every_kernel_instance_on_the_card`` takes a K that is
    no multiple of the step)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get
    from repro_torch.kernels.gemm_rows import decode_products

    g = torch.Generator(device="cuda").manual_seed(4)
    for reduced in (False, True):
        for name, K, N, _ in decode_products(get(arch, reduced=reduced)):
            for nk in (False, True):
                w = _weight(g, K, N, nk)
                for M in (8, 40):
                    x = torch.randn(M, K, generator=g,
                                    device="cuda").bfloat16()
                    with ops.use_backend("plain"):
                        want = ops.gemm_rows(x, w)
                    got = ops.gemm_rows(x, w)
                    assert got.shape == (M, N) and got.dtype == torch.bfloat16
                    torch.testing.assert_close(
                        got.float(), want.float(), atol=2e-2, rtol=2e-2,
                        msg=f"{arch} {name} {M} nk={nk}")
                assert all(_rows_invariant(ops.gemm_rows, w, torch.randn(
                    128, K, generator=g, device="cuda").bfloat16()).values())
                del w


@pytest.mark.gpu
@pytest.mark.parametrize("bk,bn", [(32, 64), (32, 128), (64, 64), (64, 128)])
def test_gemm_rows_every_kernel_instance_on_the_card(bk, bn, monkeypatch):
    """On the H100: each instance of the kernel (k step 32 or 64, one or
    two consumer warpgroups, w as (K, N) and as the transpose of (N, K)),
    forced through a plan of its own at shapes where no decode product
    reaches it, against its plain version (bf16 atol = rtol = 2e-2), with
    split and unsplit tiles, its rows bitwise the same at every row count
    and its counters left at zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import _flash_decode, gemm_rows as gk

    g = torch.Generator(device="cuda").manual_seed(5)
    for K, N, s_base, extra in ((960, 2560, 3, 7), (200, 384, 1, 0),
                                (1024, 512, 4, 1)):
        kt = -(-K // bk)
        n_tiles = -(-N // bn)
        items = n_tiles * s_base + extra
        p = gk.Plan(K, N, bn, bk, n_tiles, s_base, extra, min(132, items),
                    gk.RING_BYTES // (bk * bn * 2 + gk.X_STAGE),
                    items <= 132)
        assert s_base + (extra > 0) <= kt
        monkeypatch.setattr(gk, "plan", lambda *a, p=p: p)
        gk.forget()
        for nk in (False, True):
            w = _weight(g, K, N, nk)
            x = torch.randn(128, K, generator=g, device="cuda").bfloat16()
            torch.testing.assert_close(
                gk.gemm_rows(x, w).float(), (x.float() @ w.float()),
                atol=2e-2, rtol=2e-2, msg=f"{K} {N} {bk} {bn} nk={nk}")
            assert all(_rows_invariant(gk.gemm_rows, w, x).values())
            assert bool((_flash_decode.counters(1, w.device) == 0).all())
    gk.forget()


@pytest.mark.gpu
def test_verify_fold_equals_sequential_paged_decodes_on_the_card():
    """On the H100, at qwen3-8b's shape (8 lanes, a k = 4 window of 5, 32
    heads over 8 of 128, pages of 64): the verify window folded into the
    paged decode kernel equals 5 sequential single-token paged decodes
    bit for bit (the kernel-level face of greedy spec == plain decode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(5)
    B, W, H, K, D, P, max_pages = 8, 5, 32, 8, 128, 64, 32
    kp = torch.randn(B * max_pages + 1, P, K, D, generator=g,
                     device="cuda").bfloat16()
    vp = torch.randn(kp.shape, generator=g, device="cuda").bfloat16()
    table = (torch.randperm(B * max_pages, generator=g, device="cuda")
             + 1).to(torch.int32).reshape(B, max_pages)
    positions = torch.tensor([0, 1, 63, 64, 255, 256, 1000, 2042],
                             device="cuda", dtype=torch.int32)
    q = torch.randn(B, W, H, D, generator=g, device="cuda").bfloat16()
    window = ops.paged_verify_attention(q, kp, vp, table, positions)
    for j in range(W):
        step = ops.paged_decode_attention(q[:, j].contiguous(), kp, vp, table,
                                          positions + j + 1)
        assert torch.equal(window[:, j], step), j
    with ops.use_backend("plain"):
        want = ops.paged_verify_attention(q, kp, vp, table, positions)
    torch.testing.assert_close(window.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
def test_verify_paged_equals_decode_steps_on_the_card():
    """On the H100, REDUCED qwen3-8b (heads padded to 64): the model's
    ``verify_paged`` over a window of 4 gives the logits and the pages of 4
    sequential ``decode_paged`` steps, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get
    from repro_torch.models import get_model

    model = get_model(get("qwen3-8b", reduced=True))
    params = model.init(0, device="cuda")
    B, W, P = 3, 4, 16
    table = torch.arange(1, 1 + B * 6, device="cuda",
                         dtype=torch.int32).reshape(B, 6)
    g = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(1, 512, (B, 40), generator=g, device="cuda",
                         dtype=torch.int32)
    cache = model.init_paged_cache(B, 1 + B * 6, P, device="cuda")
    for t in range(30):
        model.decode_paged(params, cache, {
            "tokens": toks[:, t:t + 1], "page_table": table,
            "positions": torch.full((B,), t, device="cuda",
                                    dtype=torch.int32)})
    seq_cache = {k: v.clone() for k, v in cache.items()}
    pos = torch.full((B,), 30, device="cuda", dtype=torch.int32)
    steps = torch.stack([model.decode_paged(params, seq_cache, {
        "tokens": toks[:, 30 + j:31 + j], "positions": pos + j,
        "page_table": table}) for j in range(W)], 1)
    got = model.verify_paged(params, cache, {
        "tokens": toks[:, 30:30 + W], "positions": pos, "page_table": table})
    assert torch.equal(got, steps)
    for k in cache:
        assert torch.equal(cache[k].view(torch.int16),
                           seq_cache[k].view(torch.int16)), k


# ---------------------------------------------------------------------------
# The MoE family's kernels: routing and the grouped expert products
# ---------------------------------------------------------------------------

# (d, E, k) of the routers: deepseek-moe-16b, granite-moe-1b-a400m, and
# their REDUCED twins
ROUTERS = [(2048, 64, 6), (1024, 32, 8), (64, 8, 2), (64, 4, 2)]
# a near tie: where two of the plain version's first k + 1 probabilities
# (sorted) differ by less than this, the kernel may rank them either way;
# the two compute a probability near 1/64 to ~2e-9 (f32 sums over d in
# another order, the exponential's ulp)
ROUTE_TIE = 1e-7


def _router_case(g, T, d, E):
    """Normalized-looking bf16 rows and an f32 router at the init's scale
    (``small``, 1e-4), so the experts' probabilities sit near 1/E."""
    x = torch.randn(T, d, generator=g, device="cuda").bfloat16()
    router = torch.randn(d, E, generator=g, device="cuda") * 1e-4
    return x, router


def _route_ties(x, router, k) -> torch.Tensor:
    """Per token, whether two of its first k + 1 probabilities (plain
    version, sorted) are a near tie."""
    probs = torch.softmax(x.float() @ router, -1).sort(-1, descending=True)[0]
    top = probs[:, :k + 1]
    return ((top[:, :-1] - top[:, 1:]) < ROUTE_TIE).any(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("d,E,k", ROUTERS)
def test_moe_route_matches_plain_version_on_the_card(d, E, k):
    """On the H100: the router kernel against its plain version at 8, 40
    and 256 tokens: ids equal except at a near tie (printed), weights
    within 1e-5; and each token's ids and weights bitwise the same at 1, 8,
    37, 40, 64 and 256 tokens (37 is no multiple of the kernel's token
    tile, 256 takes the larger tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(E)
    x, router = _router_case(g, 256, d, E)
    for T in (8, 40, 256):
        w, ids = ops.moe_route(x[:T], router, k)
        with ops.use_backend("plain"):
            pw, pids = ops.moe_route(x[:T], router, k)
        same = (ids == pids).all(-1)
        ties = _route_ties(x[:T], router, k)
        print(d, E, k, T, "near ties", int(ties.sum()),
              "rows differing", int((~same).sum()))
        assert bool((same | ties).all())
        torch.testing.assert_close(w[same], pw[same], atol=1e-5, rtol=1e-5)
    whole = ops.moe_route(x, router, k)
    for T in (1, 8, 37, 40, 64, 256):
        part = ops.moe_route(x[:T], router, k)
        assert torch.equal(part[0], whole[0][:T])
        assert torch.equal(part[1], whole[1][:T])


def _routing(g, E, C, n_empty):
    """Per-expert row counts (E,) int64 for a buffer of C rows an expert:
    ``n_empty`` experts get none, one gets all C, the rest 1..C."""
    counts = torch.randint(1, C + 1, (E,), generator=g, device="cuda")
    perm = torch.randperm(E, generator=g, device="cuda")
    counts[perm[:n_empty]] = 0
    counts[perm[n_empty]] = C
    return counts


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "granite-moe-1b-a400m"])
@pytest.mark.parametrize("reduced", [False, True])
def test_gemm_rows_grouped_matches_plain_version_on_the_card(arch, reduced):
    """On the H100, each routed-expert product of the config (gate, up,
    down) at the decode step's and a k = 4 verify's capacity (8 and 40),
    with routings that leave experts empty: every row below its expert's
    count within bf16 atol = rtol = 2e-2 of the plain version; without
    counts, every row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get
    from repro_torch.kernels.gemm_rows import grouped_products

    g = torch.Generator(device="cuda").manual_seed(7)
    for name, E, K, N in grouped_products(get(arch, reduced=reduced)):
        w = (torch.randn(E, K, N, generator=g, device="cuda")
             * K ** -0.5).bfloat16()
        for C in (8, 40):
            buf = torch.randn(E, C, K, generator=g, device="cuda").bfloat16()
            counts = _routing(g, E, C, E // 3)
            with ops.use_backend("plain"):
                want = ops.gemm_rows_grouped(buf, w, counts)
            got = ops.gemm_rows_grouped(buf, w, counts)
            rows = torch.arange(C, device="cuda")[None, :] < counts[:, None]
            torch.testing.assert_close(got[rows].float(), want[rows].float(),
                                       atol=2e-2, rtol=2e-2,
                                       msg=f"{arch} {name} C={C}")
            torch.testing.assert_close(
                ops.gemm_rows_grouped(buf, w).float(), want.float(),
                atol=2e-2, rtol=2e-2)
        del w


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "granite-moe-1b-a400m"])
def test_gemm_rows_grouped_rows_are_invariant_on_the_card(arch):
    """On the H100: an (expert, row) result of the grouped product has the
    same bits at capacity 8, 40 and 64, at any rank within its expert (the
    rows of expert e shifted down by 3), with the other experts empty or
    full, and without counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get
    from repro_torch.kernels.gemm_rows import grouped_products

    g = torch.Generator(device="cuda").manual_seed(8)
    for name, E, K, N in grouped_products(get(arch)):
        w = (torch.randn(E, K, N, generator=g, device="cuda")
             * K ** -0.5).bfloat16()
        src = torch.randn(E, 64, K, generator=g, device="cuda").bfloat16()
        full = ops.gemm_rows_grouped(src, w)
        for C in (8, 40, 64):
            for n_empty in (0, E // 2, E - 1):
                counts = _routing(g, E, C, n_empty)
                got = ops.gemm_rows_grouped(src[:, :C].contiguous(), w,
                                            counts)
                rows = torch.arange(C, device="cuda")[None] < counts[:, None]
                assert torch.equal(got[rows], full[:, :C][rows]), \
                    (name, C, n_empty)
            # rank: expert rows moved down by 3 in a fresh buffer
            moved = torch.zeros(E, C, K, device="cuda",
                                dtype=torch.bfloat16)
            moved[:, 3:] = src[:, :C - 3]
            got = ops.gemm_rows_grouped(moved, w)
            assert torch.equal(got[:, 3:], full[:, :C - 3]), (name, C)
        del w


@pytest.mark.gpu
def test_gemm_rows_takes_an_unaligned_n_on_the_card():
    """On the H100: granite-moe's tied unembedding, N = 49,155 (no multiple
    of 8), K 1024, w as the transpose of the (N, K) embedding and as a (K,
    N) matrix: within bf16 atol = rtol = 2e-2 of the plain version, and
    each row's bits the same at every row count 1-80 (and 128)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(9)
    K, N = 1024, 49_155
    for nk in (True, False):
        w = _weight(g, K, N, nk)
        x = torch.randn(128, K, generator=g, device="cuda").bfloat16()
        for M in (8, 40):
            with ops.use_backend("plain"):
                want = ops.gemm_rows(x[:M], w)
            got = ops.gemm_rows(x[:M], w)
            assert got.shape == (M, N)
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                       rtol=2e-2, msg=f"nk={nk} M={M}")
        assert all(_rows_invariant(ops.gemm_rows, w, x).values()), nk
        del w


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "granite-moe-1b-a400m"])
def test_moe_decode_lane_is_batch_invariant_on_the_card(arch):
    """On the H100, REDUCED ``arch`` at its full REDUCED depth: a lane's
    paged decode logits alone, in a batch of 8 and in the 40-lane verify
    fold of a k = 4 window are bitwise equal; the router and the grouped
    product were launched, no plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get
    from repro_torch.models import get_model

    model = get_model(get(arch, reduced=True))
    params = model.init(0, device="cuda")
    B, W, P, pages = 8, 5, 16, 6
    table = torch.arange(1, 1 + B * pages, device="cuda",
                         dtype=torch.int32).reshape(B, pages)
    g = torch.Generator(device="cuda").manual_seed(10)
    toks = torch.randint(1, 512, (B, 40), generator=g, device="cuda",
                         dtype=torch.int32)
    cache = model.init_paged_cache(B, 1 + B * pages, P, device="cuda")
    for t in range(30):
        model.decode_paged(params, cache, {
            "tokens": toks[:, t:t + 1], "page_table": table,
            "positions": torch.full((B,), t, device="cuda",
                                    dtype=torch.int32)})
    pos = torch.full((B,), 30, device="cuda", dtype=torch.int32)

    def fresh():
        return {k: v.clone() for k, v in cache.items()}

    ops.reset_counts()
    alone = model.decode_paged(params, fresh(), {
        "tokens": toks[:1, 30:31], "positions": pos[:1],
        "page_table": table[:1]})[0]
    batch = model.decode_paged(params, fresh(), {
        "tokens": toks[:, 30:31], "positions": pos, "page_table": table})[0]
    fold = model.verify_paged(params, fresh(), {
        "tokens": toks[:, 30:30 + W], "positions": pos,
        "page_table": table})[0, 0]
    assert torch.equal(alone, batch) and torch.equal(alone, fold)
    counts = ops.counts()
    for name in ("moe_route", "gemm_rows_grouped", "gemm_rows"):
        assert counts[name]["launches"] > 0 and not counts[name]["plain"]


# ---------------------------------------------------------------------------
# The multimodal families: the encoder's non-causal flash, the cross fold
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1500, 750, 37])
def test_flash_non_causal_at_the_encoder_shapes_on_the_card(S):
    """On the H100, whisper-medium's encoder attention: Sq = Sk = S, 16
    heads of 64 (G 1), non-causal, against the plain version at atol = rtol
    = 2e-2; 1500 leaves key tails of 28 (64-key tiles) and 92 (128)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(S)
    q, k, v = (torch.randn(1, S, 16, 64, generator=g, device="cuda")
               .bfloat16() for _ in range(3))
    with ops.use_backend("plain"):
        want = ops.attention(q, k, v, causal=False)
    got = ops.attention(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    # each query row alone gives its row of the whole call
    one = ops.attention(q[:, S // 2:S // 2 + 1].contiguous(), k, v,
                        causal=False)
    torch.testing.assert_close(one.float(), got[:, S // 2:S // 2 + 1].float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 17, 256])
def test_cross_fold_is_single_lane_decodes_on_the_card(C):
    """On the H100, whisper-medium's cross read (16 heads of 64 over 16 kv
    heads, pages of 64, a 24-page region): C query rows a lane folded into
    the paged decode kernel, 8 rows a folded lane in the kv heads' groups
    (C padded to a multiple); every folded query, at every place in a
    group, bitwise a one-lane decode at its lane's length (1500 or 750, the
    last page partial), and the fold within 2e-2 of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(C)
    B, H, D, P, width = 2, 16, 64, 64, 24
    kp = torch.randn(B * width + 1, P, H, D, generator=g,
                     device="cuda").bfloat16()
    vp = torch.randn(kp.shape, generator=g, device="cuda").bfloat16()
    table = (torch.randperm(B * width, generator=g, device="cuda")
             + 1).to(torch.int32).reshape(B, width)
    lens = torch.tensor([1500, 750], device="cuda", dtype=torch.int32)
    q = torch.randn(B, C, H, D, generator=g, device="cuda").bfloat16()
    got = ops.paged_cross_attention(q, kp, vp, table, lens)
    for b in range(B):
        for c in sorted({*range(min(C, 9)), C // 2, C - 1}):
            one = ops.paged_decode_attention(
                q[b, c][None].contiguous(), kp, vp, table[b:b + 1],
                lens[b:b + 1])
            assert torch.equal(one[0], got[b, c]), (b, c)
    with ops.use_backend("plain"):
        want = ops.paged_cross_attention(q, kp, vp, table, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_reduced_multimodal_serving_on_the_card(arch, paged):
    """On the H100, REDUCED whisper-medium (enc-dec) and
    llava-next-mistral-7b (VLM), heads padded to 64: four requests (two
    sharing the modality input) complete through every kernel of the path,
    no plain version; the paged enc-dec engine computes two encoder
    regions and shares one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServeEngine

    cfg = get(arch, reduced=True)
    model = get_model(cfg)
    params = model.init(0, device="cuda")
    rng = np.random.default_rng(3)
    key = "frames" if cfg.family == "encdec" else "embeds"
    shape = ((1, 40, cfg.d_model) if key == "frames"
             else (1, cfg.n_image_tokens, 1024))
    inputs = [rng.standard_normal(shape).astype(np.float32)
              for _ in range(3)]
    kw = dict(n_slots=2, max_seq=128, device="cuda", paged=paged)
    if paged:
        kw.update(page_size=16, prefill_chunk=32)
    eng = ServeEngine(model, params, **kw)
    ops.reset_counts()
    reqs = [eng.submit(rng.integers(1, cfg.vocab_size, n).tolist(),
                       max_new_tokens=6, extra={key: inputs[min(i, 2)]})
            for i, n in enumerate((32, 20, 45, 32))]
    eng.run(500)
    assert all(r.done and len(r.generated) == 6 for r in reqs)
    counts = ops.counts()
    path = ["rmsnorm", "flash_attention"] + (
        ["paged_decode_attention", "gemm_rows"] if paged
        else ["decode_attention"])
    for name in path:
        assert counts[name]["launches"] > 0, name
    assert not any(c["plain"] for c in counts.values()), counts
    if paged and key == "frames":
        assert eng.stats["cross_regions_computed"] == 3
        assert eng.stats["cross_regions_shared"] == 1
        assert eng.pool.outstanding == 0


@pytest.mark.gpu
def test_elastic_cell_crash_and_rejoin_on_the_card():
    """On the H100, REDUCED qwen3-8b (heads padded to 64) through the
    port's elastic cell with ``tests/test_cell.py``'s engines and settings:
    a host crashes mid-stream and rejoins. The collective deadline finds
    it, the cell re-shards onto 3 hosts, resumes from a snapshot and
    replays to the committed frontier, then grows back to 4; the streams
    equal a trusted engine's, and replay recomputes every committed token
    (no forced mismatch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.core.faults import FaultEvent, FaultPlan
    from repro_torch.core.server import AdHocServer
    from repro_torch.core.simulation import SimClock
    from repro_torch.models import get_model
    from repro_torch.serving.batch import make_engine_factory
    from repro_torch.serving.cell import ElasticServeCell

    model = get_model(get("qwen3-8b", reduced=True))
    params = model.init(0, device="cuda")
    factory = make_engine_factory(model, params, device="cuda", n_slots=6,
                                  max_seq=96, page_size=8, n_pages=80)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, model.cfg.vocab_size, 8).tolist()
               for _ in range(2)]
    trusted = factory("__trusted__")
    want = [trusted.submit(p, max_new_tokens=24) for p in prompts]
    trusted.run(5000)
    srv = AdHocServer(failure_timeout=6.0)
    srv.create_cloudlet("cell", "qwen3-8b")
    for i in range(4):
        srv.register_host(f"h{i}", 0.0, cloudlets=["cell"])
    cell = ElasticServeCell(srv, "cell", model, params, factory=factory,
                            model_parallel=2, target_hosts=4, min_hosts=1,
                            slots_per_host=1, decode_step_s=1.0,
                            step_deadline_s=4.0, snapshot_every_s=3.0)
    reqs = [cell.submit(p, max_new_tokens=24) for p in prompts]
    plan = FaultPlan([FaultEvent(at=6.0, kind="crash", host="h1"),
                      FaultEvent(at=16.0, kind="rejoin", host="h1")])
    ops.reset_counts()
    s = cell.run(SimClock(), fault_plan=plan, max_ticks=500)
    counts = ops.counts()
    assert s["requests_done"] == 2 and s["hosts_lost"] == 1
    assert s["resharded"] >= 1 and s["resumed_from_snapshot"] >= 1
    assert s["tokens_replayed"] >= 1 and s["reshard_grow"] >= 1
    assert s["forced_tokens"] >= 1 and s["forced_mismatches"] == 0
    assert len(s["hosts"]) == 4 and "h1" in s["hosts"]
    assert [r.committed for r in reqs] == [r.generated for r in want]
    for name in ("rmsnorm", "paged_decode_attention", "flash_attention",
                 "gemm_rows"):
        assert counts[name]["launches"] > 0 and not counts[name]["plain"]


# the flash backward's limit: per (batch, 64-row tile, head), the
# gradient's difference over plain autograd's in the Frobenius norm (read
# on the H100 at these cases: 0.0033-0.0042)
FLASH_BWD_TILE_SHARE = 1e-2


def _tile_share(got, want, tile: int = 64) -> float:
    """The largest, over (batch, ``tile`` rows of dim 1, head) tiles of
    (B, S, H, D) gradients, of ||got - want|| / ||want|| (Frobenius, f32):
    each tile against its own size, since causal gradients fall with the
    position. NaN where a tile of ``want`` is all zero."""
    import torch.nn.functional as F

    B, S, H, D = want.shape

    def sums(t):
        t = F.pad(t, (0, 0, 0, 0, 0, -S % tile))
        return t.square().reshape(B, -1, tile, H, D).sum((2, 4))

    want = want.float()
    return float((sums(got.float() - want) / sums(want)).max().sqrt())


# (D, H, K, Sq, Sk, q_offset, causal, B): widths 16 (padded to 64), 64 and
# 128, GQA 3:1 and 4:1, lengths off the 64-row steps and the 128-row blocks
# (127, 129, 191), the non-causal branch, Sq != Sk with a q_offset (causal
# and not), and the training shapes' full 2048 rows at B 1
FLASH_BWD_CASES = [(16, 6, 2, 100, 100, 0, True, 2),
                   (64, 15, 5, 200, 200, 0, True, 2),
                   (128, 32, 8, 130, 130, 0, True, 2),
                   (64, 12, 3, 64, 64, 0, True, 2),
                   (128, 8, 2, 257, 257, 0, False, 2),
                   (64, 4, 1, 33, 33, 0, True, 2),
                   (128, 8, 2, 100, 300, 200, True, 2),
                   (64, 6, 2, 64, 257, 0, False, 2),
                   (64, 6, 3, 127, 127, 0, True, 2),
                   (128, 4, 1, 129, 129, 0, True, 2),
                   (64, 15, 5, 191, 191, 0, True, 2),
                   (64, 15, 5, 2048, 2048, 0, True, 1),
                   (128, 32, 8, 2048, 2048, 0, True, 1),
                   # whisper-medium's non-causal shapes (H = K = 16, D 64):
                   # the encoder at 1500 and 750 frames, the cross
                   # attention's 2048 queries over 1500 keys
                   (64, 16, 16, 1500, 1500, 0, False, 1),
                   (64, 16, 16, 750, 750, 0, False, 2),
                   (64, 16, 16, 2048, 1500, 0, False, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("D,H,K,Sq,Sk,q_offset,causal,B", FLASH_BWD_CASES)
def test_flash_backward_matches_plain_autograd_on_the_card(
        D, H, K, Sq, Sk, q_offset, causal, B):
    """On the H100: the flash backward kernel's dq, dk and dv against
    autograd through the plain attention, bf16, each 64-row tile within
    ``FLASH_BWD_TILE_SHARE`` of its own size (a fault planted in the last,
    ragged tile lands above it); two backward runs bitwise equal; the
    forward's output bits the same with ``lse`` as without."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import flash_attention as fk

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(D + Sk + q_offset)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, K, D), rnd(B, Sk, K, D)
    dout = rnd(B, Sq, H, D)

    def grads(plain: bool):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        if plain:
            with ops.use_backend("plain"):
                out = ops.attention(*ins, causal=causal, q_offset=q_offset)
        else:
            out = ops.attention(*ins, causal=causal, q_offset=q_offset)
        return out.detach(), torch.autograd.grad(out, ins, dout)

    want_out, want = grads(True)
    before = fk.flash_attention_bwd.launches
    out1, got1 = grads(False)
    out2, got2 = grads(False)
    torch.cuda.synchronize()
    assert fk.flash_attention_bwd.launches == before + 2
    assert torch.equal(out1, fk.flash_attention(q, k, v, causal=causal,
                                                q_offset=q_offset))
    torch.testing.assert_close(out1.float(), want_out.float(), atol=2e-2,
                               rtol=2e-2)
    for a, b, w, name in zip(got1, got2, want, "qkv"):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        assert torch.equal(a, b), f"d{name} differs between two runs"
        share = _tile_share(a, w)
        assert share <= FLASH_BWD_TILE_SHARE, (name, share)
        bad = a.clone()
        bad[:, (a.shape[1] - 1) // 64 * 64:] *= 1.1
        assert _tile_share(bad, w) > FLASH_BWD_TILE_SHARE, name


@pytest.mark.gpu
def test_flash_backward_over_a_single_key_on_the_card():
    """On the H100: non-causal attention of 37 queries over one key (the
    edge of the key tiles: 63 of 64 rows masked). Every probability is 1,
    so dq and dk are zero (the kernel's within 1e-3: its delta and dP are
    f32 sums of the same products in other orders) and dv is the sum of
    dO over the queries, held per tile as the other cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v, dout = rnd(2, 37, 16, 64), rnd(2, 1, 16, 64), \
        rnd(2, 1, 16, 64), rnd(2, 37, 16, 64)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    dq, dk, dv = torch.autograd.grad(ops.attention(*ins, causal=False), ins,
                                     dout)
    again = torch.autograd.grad(ops.attention(*ins, causal=False), ins, dout)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
    assert float(dq.float().abs().max()) <= 1e-3
    assert float(dk.float().abs().max()) <= 1e-3
    want = dout.float().sum(1, keepdim=True)
    assert _tile_share(dv, want) <= FLASH_BWD_TILE_SHARE


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d", [(37, 96), (1000, 128), (300, 960),
                                    (64, 4096), (5, 33), (20000, 960),
                                    (1000, 4096)])
def test_rmsnorm_backward_matches_plain_autograd_on_the_card(rows, d):
    """On the H100: the RMSNorm backward kernel's dx (bf16, 2e-2) and dw
    (f32, within 1e-4 of its largest magnitude) against autograd through
    the plain version; two runs bitwise equal. (20,000, 960) has more rows
    than one run of the wrapper's rule; (1,000, 4,096) a last run of 8
    rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(rows + d)
    x = torch.randn(rows, d, generator=g, device=dev).to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    gy = torch.randn(rows, d, generator=g, device=dev).to(torch.bfloat16)

    def grads(plain: bool):
        xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
        if plain:
            with ops.use_backend("plain"):
                y = ops.rmsnorm(xi, wi, 1e-6)
        else:
            y = ops.rmsnorm(xi, wi, 1e-6)
        return torch.autograd.grad(y, (xi, wi), gy)

    want = grads(True)
    a, b = grads(False), grads(False)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].dtype == torch.bfloat16 and a[1].dtype == torch.float32
    torch.testing.assert_close(a[0].float(), want[0].float(), atol=2e-2,
                               rtol=2e-2)
    assert _rel(a[1], want[1]) <= 1e-4


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.gpu
def test_reduced_trainer_restores_bitwise_on_the_card():
    """On the H100: REDUCED smollm-360m trained by ``AdHocTrainer`` with a
    failure at step 5 (snapshots every 3) ends in the uninterrupted run's
    state bit for bit; the flash and RMSNorm kernels ran forward and
    backward, no plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from repro_torch.config import RunConfig
    from repro_torch.configs import get
    from repro_torch.models.model_api import tree_leaves
    from repro_torch.training.trainer import AdHocTrainer

    def run(fail):
        t = AdHocTrainer(get("smollm-360m", reduced=True),
                         RunConfig(arch="smollm-360m",
                                   snapshot_interval_steps=3),
                         n_hosts=2, total_steps=8, seq_len=64,
                         global_batch=4, fail_at_steps=fail)
        return t.run_to_completion()

    ops.reset_counts()
    failed = run({5: "host000"})
    counts = ops.counts()
    clean = run({})
    assert failed.completed and clean.completed
    assert failed.restores == 1 and failed.recomputed_steps == 2
    assert all(np.isfinite(l) for _, l in failed.losses + clean.losses)
    for name in ("flash_attention", "flash_attention_bwd", "rmsnorm",
                 "rmsnorm_bwd"):
        assert counts[name]["launches"] > 0 and counts[name]["plain"] == 0
    for a, b in zip(tree_leaves(failed.final_state),
                    tree_leaves(clean.final_state)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.gpu
def test_train_step_under_the_plain_backend_on_the_card():
    """On the H100: a REDUCED qwen3-8b train step under
    ``use_backend("plain")`` launches no kernel, its layers' recompute
    included (autograd runs it on a thread of its own), and lands within
    2e-2 of the kernel step's loss from the same state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.config import RunConfig
    from repro_torch.configs import get
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.models import get_model
    from repro_torch.training.state import init_train_state
    from repro_torch.training.step import make_train_step

    cfg = get("qwen3-8b", reduced=True)
    model = get_model(cfg)
    step = make_train_step(model, RunConfig(arch=cfg.arch_id))
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             SyntheticDataset(cfg, 128, 4).batch(0).items()}
    losses = {}
    for name in ("plain", "kernel"):
        ops.reset_counts()
        with ops.use_backend(name):
            _, m = step(init_train_state(model, 0), batch)
        losses[name] = float(m["loss"])
        counts = ops.counts()
        if name == "plain":
            assert all(c["launches"] == 0 for c in counts.values())
            assert counts["flash_attention_bwd"]["plain"] > 0
        else:
            assert all(c["plain"] == 0 for c in counts.values())
            assert counts["rmsnorm_bwd"]["launches"] > 0
    assert abs(losses["plain"] - losses["kernel"]) <= 2e-2


def _smoke():
    """``chip_smoke.py`` (at the repo's root), whose metrics these tests
    share: imported only on the card."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def _ssm_grads(fn, ins, douts, plain: bool):
    """``fn(*ins)``'s outputs and the gradients of every input for
    ``douts``, through the kernels or under the plain backend."""
    leaves = [t.clone().requires_grad_() for t in ins]
    with ops.use_backend("plain" if plain else "kernel"):
        out = fn(*leaves)
    return [o.detach() for o in out], torch.autograd.grad(out, leaves, douts)


def _check_ssm_grads(what, got, again, want) -> None:
    """The seven gradients (x, dt, A, B, C, D, h0) each of its input's
    type and shape, held by ``chip_smoke._ssm_grads_held``: two runs
    bitwise equal, each bf16 gradient per (batch, 64-step tile) within
    ``GRAD_TILE_SHARE`` (1 %) of the tile's own size in the Frobenius norm
    (both sides round to bf16 at the end: ~0.3 %), each f32 one within
    ``SSM_F32_GRAD_REL`` (1e-3) of its largest magnitude, a fault planted
    in each bf16 one's last tile caught."""
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == w.dtype and a.shape == w.shape, i
    _smoke()._ssm_grads_held(what, got, again, want)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Di,N,h0_scale,init_decay", [
    (2, 37, 200, 16, 0.1, False), (2, 300, 96, 8, 0.0, False),
    (2, 520, 64, 4, 0.1, False), (1, 256, 37, 16, 0.1, False),
    (1, 2048, 512, 16, 0.1, False), (2, 2048, 256, 16, 0.1, True),
    (2, 300, 96, 4, 0.0, True), (1, 700, 72, 8, 0.1, True),
    (2, 130, 24, 4, 0.1, False), (1, 513, 8200, 16, 0.1, False)])
def test_scan_backward_matches_plain_autograd_on_the_card(B, S, Di, N,
                                                         h0_scale,
                                                         init_decay):
    """On the H100: the selective-scan backward kernel's gradients of
    every input (x, dt, B, C bf16; A, D, h0 f32) for y's and hT's
    gradients against autograd through the plain scan, per 64-step tile;
    two runs bitwise equal; the forward's y and hT the same bits with its
    tiles' entering states saved, tile 0's being h0. Lengths
    below 256, off 256 and 2048; channels off the 64-channel block and off
    its 16-channel pass (37, 200, 72, 24, 8200: a last block of 8), N 4, 8
    and 16; dt and A mild (dt about 0.08) or, with ``init_decay``, as the
    models' initial weights draw them (dt about 0.8, A about -1:
    ``chip_smoke._init_decay``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import selective_scan as sk

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(S + Di + N)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=dev)

    x = rnd(B, S, Di, scale=0.5).bfloat16()
    dt, A = (_smoke()._init_decay(g, (B, S, Di), (Di, N)) if init_decay else
             ((rnd(B, S, Di).abs() * 0.1).bfloat16(),
              -(rnd(Di, N).abs() + 0.1)))
    ins = [x, dt, A,
           rnd(B, S, N, scale=0.5).bfloat16(), rnd(B, S, N, scale=0.5).bfloat16(),
           rnd(Di), rnd(B, Di, N, scale=h0_scale)]
    douts = (rnd(B, S, Di).bfloat16(), rnd(B, Di, N, scale=0.1))
    y, hT = sk.selective_scan(*ins)
    ys, hs, states = sk.selective_scan(*ins, save_states=True)
    assert torch.equal(y, ys) and torch.equal(hT, hs)
    assert torch.equal(states[:, 0], ins[6])
    _, want = _ssm_grads(ops.selective_scan, ins, douts, True)
    before = sk.selective_scan_bwd.launches
    out, got = _ssm_grads(ops.selective_scan, ins, douts, False)
    _, again = _ssm_grads(ops.selective_scan, ins, douts, False)
    torch.cuda.synchronize()
    assert sk.selective_scan_bwd.launches == before + 2
    assert torch.equal(out[0], y) and torch.equal(out[1], hT)
    _check_ssm_grads("selective_scan_bwd", got, again, want)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hs,P,N,chunk,h0_scale,init_decay", [
    (2, 37, 4, 16, 8, 256, 0.1, False), (2, 300, 4, 48, 64, 256, 0.1, False),
    (2, 100, 3, 16, 16, 16, 0.0, False), (2, 200, 2, 64, 32, 64, 0.1, False),
    (1, 257, 2, 8, 8, 128, 0.1, False), (1, 2048, 8, 64, 64, 256, 0.1, False),
    (2, 2048, 8, 64, 64, 256, 0.1, True), (2, 100, 3, 16, 16, 16, 0.0, True),
    (1, 300, 4, 48, 64, 256, 0.1, True), (1, 300, 5, 32, 16, 64, 0.1, False),
    (2, 150, 6, 24, 40, 128, 0.1, True), (2, 50, 7, 8, 8, 64, 0.0, False),
    (1, 90, 9, 40, 24, 32, 0.1, False)])
def test_ssd_backward_matches_plain_autograd_on_the_card(B, S, Hs, P, N,
                                                        chunk, h0_scale,
                                                        init_decay):
    """On the H100: the SSD backward kernel's gradients of every input
    against autograd through the plain (chunked) SSD, per 64-step tile;
    two runs bitwise equal; the forward's y and hT the same bits when its
    scratch is kept. Ragged tails, one to eight chunks, chunk 16 (REDUCED
    configs), 32, 64, 128 and 256, S below one chunk, several (P, N) down
    to 8 (P 24 and 40, N 24 and 40: off the 16-wide product steps), head
    counts off the backward's 4-head group (3, 5, 6, 7, 9); dt and A mild
    or, with ``init_decay``, as the models' initial weights draw them (the
    decay's exponent falls by about 200 over a 256-step chunk)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ssd as dk

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(S + P + N + chunk)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=dev)

    x = rnd(B, S, Hs, P, scale=0.5).bfloat16()
    dt, A = (_smoke()._init_decay(g, (B, S, Hs), (Hs,)) if init_decay else
             ((rnd(B, S, Hs).abs() * 0.1).bfloat16(), -(rnd(Hs).abs() + 0.1)))
    ins = [x, dt, A,
           rnd(B, S, N, scale=0.5).bfloat16(), rnd(B, S, N, scale=0.5).bfloat16(),
           rnd(Hs), rnd(B, Hs, P, N, scale=h0_scale)]
    douts = (rnd(B, S, Hs, P).bfloat16(), rnd(B, Hs, P, N, scale=0.1))

    def fn(*a):
        return ops.ssd(*a, chunk=chunk)

    y, hT = dk.ssd(*ins, chunk=chunk)
    _, want = _ssm_grads(fn, ins, douts, True)
    before = dk.ssd_bwd.launches
    out, got = _ssm_grads(fn, ins, douts, False)
    _, again = _ssm_grads(fn, ins, douts, False)
    torch.cuda.synchronize()
    assert dk.ssd_bwd.launches == before + 2
    assert torch.equal(out[0], y) and torch.equal(out[1], hT)
    _check_ssm_grads("ssd_bwd", got, again, want)


SSM_TRAIN_KERNELS = {
    "falcon-mamba-7b": ("rmsnorm", "rmsnorm_bwd", "selective_scan",
                        "selective_scan_bwd"),
    "zamba2-1.2b": ("rmsnorm", "rmsnorm_bwd", "ssd", "ssd_bwd",
                    "flash_attention", "flash_attention_bwd"),
}


def _reduced_step_against_plain(arch: str, kernels: tuple) -> None:
    """A REDUCED train step of ``arch`` launches every kernel of
    ``kernels``, forward and backward, and no plain version; its loss is
    within 2e-2 of the same step under the plain backend, and its gradient
    norm within 5 %; a second step from the same state gives the same
    bits."""
    from repro_torch.config import RunConfig
    from repro_torch.configs import get
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.models import get_model
    from repro_torch.models.model_api import tree_leaves
    from repro_torch.training.state import init_train_state
    from repro_torch.training.step import make_train_step

    cfg = get(arch, reduced=True)
    model = get_model(cfg)
    step = make_train_step(model, RunConfig(arch=cfg.arch_id))
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             SyntheticDataset(cfg, 300, 2).batch(0).items()}
    metrics, states = {}, {}
    for name in ("plain", "kernel", "again"):
        ops.reset_counts()
        with ops.use_backend("plain" if name == "plain" else "kernel"):
            states[name], m = step(init_train_state(model, 0), batch)
        metrics[name] = {k: float(m[k]) for k in ("loss", "grad_norm")}
        counts = ops.counts()
        if name == "plain":
            assert all(c["launches"] == 0 for c in counts.values())
        else:
            assert all(c["plain"] == 0 for c in counts.values()), counts
            for k in kernels:
                assert counts[k]["launches"] > 0, k
    assert abs(metrics["plain"]["loss"] - metrics["kernel"]["loss"]) <= 2e-2
    assert abs(metrics["kernel"]["grad_norm"]
               / metrics["plain"]["grad_norm"] - 1) <= 5e-2
    assert metrics["kernel"] == metrics["again"]
    for a, b in zip(tree_leaves(states["kernel"]),
                    tree_leaves(states["again"])):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(SSM_TRAIN_KERNELS))
def test_reduced_ssm_losses_on_the_card(arch):
    """On the H100: a REDUCED falcon-mamba-7b / zamba2-1.2b train step
    against the plain step (``_reduced_step_against_plain``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _reduced_step_against_plain(arch, SSM_TRAIN_KERNELS[arch])


# ---------------------------------------------------------------------------
# the MoE and enc-dec training paths: the router's backward, the flash
# backward at whisper's non-causal shapes, REDUCED train steps
# ---------------------------------------------------------------------------

# d_logits of the router's backward kernel against its plain version on the
# same inputs: both f32, sums over k and E in other orders (largest
# difference within this share of the largest magnitude)
ROUTE_BWD_REL = 1e-5
MOE_ENCDEC_TRAIN_KERNELS = {
    "granite-moe-1b-a400m": ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                             "flash_attention_bwd", "moe_route",
                             "moe_route_bwd"),
    "deepseek-moe-16b": ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                         "flash_attention_bwd", "moe_route",
                         "moe_route_bwd"),
    "whisper-medium": ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                       "flash_attention_bwd"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("T,d,E,k", [
    (1, 1024, 32, 8), (8, 1024, 32, 1), (4096, 1024, 32, 8),
    (4096, 2048, 64, 6), (37, 512, 64, 16), (8, 256, 256, 16),
    (300, 64, 4, 2), (37, 64, 4, 1), (1, 2048, 64, 6), (37, 2048, 64, 6),
    (300, 1024, 32, 8), (1000, 2048, 64, 6), (4096, 64, 256, 16),
    (300, 1024, 256, 16), (4096, 1024, 4, 1), (37, 64, 6, 2),
    (37, 2056, 64, 6), (129, 8192, 32, 8), (129, 8192, 256, 16)])
def test_moe_route_bwd_matches_plain_version_on_the_card(T, d, E, k):
    """On the H100: the router's backward kernels (d_logits, then dx and
    d_router) on the forward kernel's own probabilities, picks and weights,
    with and without the probabilities' gradient: d_logits against
    ``ref.moe_route_bwd`` within ``ROUTE_BWD_REL``; dx (bf16) within 1e-2
    and d_router within ``ROUTE_BWD_REL`` of ``ref.moe_route_grads`` (summed
    in the kernel's order) and of ``x.float().T @ d_logits``; dx element by
    element within one bf16 rounding of the f32 product
    (``ref.moe_route_dx_excess`` at most 1), where a product of
    bf16-rounded operands reads over 1; two runs
    bitwise equal; ``MoeRoute``'s dx and d_router the kernels', also when
    only one of x and the router needs a gradient. T 1 to 4096 (37, 300 and
    1000 off the kernel's token tile), k 1 to MAX_K, E 4 to MAX_E (6: rows
    padded to 4), d 64 to 8192 (2056: a block's slice past d)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import moe_route as rk
    from repro_torch.kernels import ref

    def rel(got, want):
        scale = float(want.float().abs().max())
        return float((got.float() - want.float()).abs().max()) / (scale or 1.0)

    g = torch.Generator(device="cuda").manual_seed(T + E + k)
    x, router = _router_case(g, T, d, E)
    router = router * 100   # probabilities well apart from 1/E
    weights, ids, probs = rk.moe_route(x, router, k, with_probs=True)
    dw = torch.randn(T, k, generator=g, device="cuda")
    dprobs = torch.randn(T, E, generator=g, device="cuda")
    order = rk.grads_plan(d, E).order()
    for dp in (dprobs, None):
        args = (x, router, probs, ids, weights, dw, dp)
        got = rk.moe_route_bwd(*args, with_d_logits=True)
        again = rk.moe_route_bwd(*args, with_d_logits=True)
        want = ref.moe_route_bwd(probs, ids, weights, dw, dp)
        pdx, pdr = ref.moe_route_grads(*args, **order)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        dx, dr, dl = got
        assert dx.dtype == torch.bfloat16 and dx.shape == (T, d)
        assert dr.dtype == torch.float32 and dr.shape == (d, E)
        # at k 1 without dprobs every weight is 1 and d_logits is zero
        errs = {"d_logits": rel(dl, want), "dx": rel(dx, pdx),
                "d_router": rel(dr, pdr),
                "d_router_matmul": rel(dr, x.float().t() @ want)}
        print(T, d, E, k, dp is not None, errs)
        assert errs["d_logits"] <= ROUTE_BWD_REL, errs
        assert errs["dx"] <= 1e-2, errs
        assert errs["d_router"] <= ROUTE_BWD_REL, errs
        assert errs["d_router_matmul"] <= ROUTE_BWD_REL, errs
        # dx element by element: one bf16 rounding of an f32-accurate
        # product; the control (bf16 operands) fails the same check
        assert ref.moe_route_dx_excess(dx, dl, router) <= 1.0
        if dp is not None:
            control = (dl.bfloat16().float()
                       @ router.bfloat16().float().t()).bfloat16()
            assert ref.moe_route_dx_excess(control, dl, router) > 1.0
    xl, rl = x.clone().requires_grad_(), router.clone().requires_grad_()
    w2, ids2, p2 = rk.MoeRoute.apply(xl, rl, k)
    assert torch.equal(w2, weights) and torch.equal(ids2, ids)
    dx, dr = torch.autograd.grad((w2, p2), (xl, rl), (dw, dprobs))
    kdx, kdr = rk.moe_route_bwd(x, router, probs, ids, weights, dw, dprobs)
    assert torch.equal(dx, kdx) and torch.equal(dr, kdr)
    dl = ref.moe_route_bwd(probs, ids, weights, dw, dprobs)
    assert _rel(dx.float(), (dl @ router.t()).bfloat16().float()) <= 1e-2
    assert _rel(dr, x.float().t() @ dl) <= ROUTE_BWD_REL
    # one input wanting a gradient: the other product is not formed
    for which in (0, 1):
        ins = [x.clone(), router.clone()]
        ins[which].requires_grad_()
        w3, _, p3 = rk.MoeRoute.apply(*ins, k)
        (one,) = torch.autograd.grad((w3, p3), (ins[which],), (dw, dprobs))
        assert torch.equal(one, (kdx, kdr)[which])


@pytest.mark.gpu
@pytest.mark.parametrize("d,E,k", ROUTERS)
def test_moe_route_probs_leave_weights_and_ids_bitwise_on_the_card(d, E, k):
    """On the H100: the router kernel with ``probs`` out gives the same
    weights and ids bits as without, at 1, 8, 37 and 4096 tokens; its
    probabilities within 1e-6 of the plain softmax's (the kernel's logits
    are f32 sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import moe_route as rk

    g = torch.Generator(device="cuda").manual_seed(d + E)
    x, router = _router_case(g, 4096, d, E)
    for T in (1, 8, 37, 4096):
        w, ids = rk.moe_route(x[:T], router, k)
        w2, ids2, probs = rk.moe_route(x[:T], router, k, with_probs=True)
        assert torch.equal(w, w2) and torch.equal(ids, ids2), T
        want = torch.softmax(x[:T].float() @ router, -1)
        assert float((probs - want).abs().max()) <= 1e-6, T


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(MOE_ENCDEC_TRAIN_KERNELS))
def test_reduced_moe_and_encdec_losses_on_the_card(arch):
    """On the H100: a REDUCED granite-moe / deepseek-moe / whisper-medium
    train step against the plain step (``_reduced_step_against_plain``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _reduced_step_against_plain(arch, MOE_ENCDEC_TRAIN_KERNELS[arch])
