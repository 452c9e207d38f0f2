"""The port's kernels: plain versions against the JAX package, dispatch.

The plain PyTorch versions (``repro_torch.kernels.ref``) are held against
the JAX oracles (``repro.kernels.ref``) and against the JAX dispatch
(``repro.kernels.ops``) under both its CPU backends — ``xla`` and
``pallas_interpret``, the TPU kernel run by the interpreter — on the same
numpy inputs, at the shape grids of ``tests/test_kernels.py`` and
``tests/test_paged.py``. Tolerances are those of ``tests/test_kernels.py``:
bf16 atol = rtol = 2e-2, f32 2e-5.

The hand-written Hopper kernels run only on the card: their tests are in
``tests/test_torch_gpu.py``, marked ``gpu``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(1)
RNG = np.random.default_rng(42)
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bf16" else \
        dict(atol=2e-5, rtol=2e-5)


def pair(a: np.ndarray, name: str):
    """The same values as a JAX array and a torch tensor of one dtype (bf16
    rounds once, in JAX, and crosses bit for bit)."""
    j = jnp.asarray(a, DTYPES[name])
    if name == "bf16":
        bits = np.asarray(j).view(np.int16).copy()
        return j, torch.from_numpy(bits).view(torch.bfloat16)
    return j, torch.from_numpy(np.asarray(j).copy())


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "shape", [(2, 16, 33), (1, 7, 64), (3, 5, 960), (2, 1, 128)]
)
def test_rmsnorm_matches_reference(shape, dtype):
    jx, tx = pair(RNG.standard_normal(shape), dtype)
    jw, tw = pair(RNG.standard_normal(shape[-1:]), "f32")
    got = f32(ref.rmsnorm(tx, tw, 1e-5))
    np.testing.assert_allclose(got, f32(jref.rmsnorm(jx, jw, 1e-5)),
                               **tol(dtype))
    for backend in ("xla", "pallas_interpret"):
        with jops.use_backend(backend):
            want = f32(jops.rmsnorm(jx, jw, 1e-5))
        np.testing.assert_allclose(got, want, **tol(dtype))


# ---------------------------------------------------------------------------
# Flash attention (prefill)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "b,sq,sk,h,k,d,causal,q_off",
    [
        (2, 32, 32, 4, 2, 16, True, 0),     # GQA causal square
        (1, 17, 63, 5, 1, 8, True, 46),     # ragged + offset (suffix decode)
        (2, 8, 40, 8, 8, 32, False, 0),     # MHA non-causal cross-attn
        (1, 64, 64, 2, 2, 128, True, 0),    # full head_dim tile
        (1, 32, 96, 4, 2, 24, True, 64),    # chunked prefill at an offset
    ],
)
def test_attention_matches_reference(b, sq, sk, h, k, d, causal, q_off, dtype):
    jq, tq = pair(RNG.standard_normal((b, sq, h, d)), dtype)
    jk, tk = pair(RNG.standard_normal((b, sk, k, d)), dtype)
    jv, tv = pair(RNG.standard_normal((b, sk, k, d)), dtype)
    got = f32(ref.attention(tq, tk, tv, causal=causal, q_offset=q_off))
    want = f32(jref.attention(jq, jk, jv, causal=causal, q_offset=q_off))
    np.testing.assert_allclose(got, want, **tol(dtype))
    for backend in ("xla", "pallas_interpret"):
        with jops.use_backend(backend):
            want = f32(jops.attention(jq, jk, jv, causal=causal,
                                      q_offset=q_off, block_q=16, block_k=16))
        np.testing.assert_allclose(got, want, **tol(dtype))


# ---------------------------------------------------------------------------
# Paged decode attention
# ---------------------------------------------------------------------------


def _paged_case(b, h, k, d, page, max_pages, n_pages, dtype):
    jq, tq = pair(RNG.standard_normal((b, h, d)), dtype)
    jkp, tkp = pair(RNG.standard_normal((n_pages, page, k, d)), dtype)
    jvp, tvp = pair(RNG.standard_normal((n_pages, page, k, d)), dtype)
    ids = RNG.permutation(np.arange(1, n_pages))[: b * max_pages]
    table = ids.reshape(b, max_pages).astype(np.int32)
    lens = RNG.integers(1, max_pages * page + 1, b).astype(np.int32)
    return (jq, jkp, jvp, jnp.asarray(table), jnp.asarray(lens)), \
        (tq, tkp, tvp, torch.from_numpy(table), torch.from_numpy(lens))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize(
    "b,h,k,d,page,max_pages,n_pages",
    [(2, 4, 2, 16, 8, 4, 12), (3, 8, 8, 32, 16, 3, 16),
     (1, 16, 2, 64, 8, 5, 8)],
)
def test_paged_decode_matches_reference(b, h, k, d, page, max_pages, n_pages,
                                        backend, dtype):
    jargs, targs = _paged_case(b, h, k, d, page, max_pages, n_pages, dtype)
    got = f32(ref.paged_decode_attention(*targs))
    np.testing.assert_allclose(got, f32(jref.paged_decode_attention(*jargs)),
                               **tol(dtype))
    with jops.use_backend(backend):
        want = f32(jops.paged_decode_attention(*jargs))
    np.testing.assert_allclose(got, want, **tol(dtype))


def test_paged_decode_zero_length_lane_gives_zeros():
    """The kernels' contract for an empty lane is zeros, never NaN — held
    against the TPU kernel run by the interpreter (``repro.kernels.ref``
    averages the masked values there instead)."""
    jargs, targs = _paged_case(2, 4, 2, 16, 8, 4, 12, "f32")
    jl = jargs[4].at[0].set(0)
    tl = targs[4].clone()
    tl[0] = 0
    got = f32(ref.paged_decode_attention(*targs[:4], tl))
    with jops.use_backend("pallas_interpret"):
        want = f32(jops.paged_decode_attention(*jargs[:4], jl))
    assert np.all(got[0] == 0.0) and not np.isnan(got).any()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def test_cpu_tensors_dispatch_to_the_plain_versions():
    ops.reset_counts()
    x = torch.randn(3, 16)
    torch.testing.assert_close(ops.rmsnorm(x, torch.ones(16)),
                               ref.rmsnorm(x, torch.ones(16)))
    q = torch.randn(1, 8, 4, 16)
    kv = torch.randn(1, 8, 2, 16)
    torch.testing.assert_close(ops.attention(q, kv, kv, q_offset=0),
                               ref.attention(q, kv, kv))
    pages = torch.randn(5, 4, 2, 16)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lens = torch.tensor([3, 8], dtype=torch.int32)
    ops.paged_decode_attention(q[:, :2, :, :].reshape(2, 4, 16), pages, pages,
                               table, lens)
    cache = pages[:2]
    torch.testing.assert_close(
        ops.decode_attention(q[0, :2], cache, cache, lens),
        ref.decode_attention(q[0, :2], cache, cache, lens))
    # the verify window counts where the card folds it: the paged decode
    ops.paged_verify_attention(torch.randn(2, 3, 4, 16), pages, pages,
                               table, lens - 3)
    w = torch.randn(16, 8).bfloat16()
    torch.testing.assert_close(ops.gemm_rows(x.bfloat16(), w),
                               x.bfloat16() @ w)
    buf = torch.randn(4, 3, 16).bfloat16()
    wg = torch.randn(4, 16, 8).bfloat16()
    torch.testing.assert_close(ops.gemm_rows_grouped(buf, wg),
                               torch.bmm(buf, wg))
    router = torch.randn(16, 4)
    torch.testing.assert_close(ops.moe_route(x.bfloat16(), router, 2),
                               ref.moe_route(x.bfloat16(), router, 2))
    counts = ops.counts()
    assert {n: c["plain"] for n, c in counts.items()} == {
        "rmsnorm": 1, "flash_attention": 1, "paged_decode_attention": 2,
        "decode_attention": 1, "selective_scan": 0, "ssd": 0,
        "gemm_rows": 1, "moe_route": 1, "gemm_rows_grouped": 1,
        # no input needs a gradient: no backward is set up
        "flash_attention_bwd": 0, "rmsnorm_bwd": 0,
        "selective_scan_bwd": 0, "ssd_bwd": 0, "moe_route_bwd": 0}
    assert all(c["launches"] == 0 for c in counts.values())
    ops.reset_counts()
    assert all(c == {"launches": 0, "plain": 0} for c in ops.counts().values())


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel on a CUDA tensor or raises: it never
    computes on the CPU itself (that is the dispatch's plain route)."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import gemm_rows as gk
    from repro_torch.kernels import moe_route as mk
    from repro_torch.kernels import paged_decode_attention as pk
    from repro_torch.kernels import rmsnorm as rk

    x = torch.randn(2, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        rk.rmsnorm(x, torch.ones(16))
    with pytest.raises(ValueError):
        mk.moe_route(x, torch.randn(16, 4), 2)
    with pytest.raises(ValueError):
        gk.gemm_rows_grouped(x[None], torch.randn(1, 16, 8).bfloat16())
    q = torch.randn(1, 8, 4, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fk.flash_attention(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError):
        pk.paged_decode_attention(q[0], q, q, torch.zeros(1, 1, dtype=torch.int32),
                                  torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        dk.decode_attention(q[0], q, q, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        with ops.use_backend("pallas"):
            pass
