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
