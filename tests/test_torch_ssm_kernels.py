"""The port's SSM kernels' plain versions against the JAX package.

The plain PyTorch ``selective_scan`` and ``ssd`` (``repro_torch.kernels.
ref``) are held against the JAX oracles (``repro.kernels.ref``), the TPU
kernels run by the interpreter (``repro.kernels.selective_scan.
selective_scan`` and ``repro.kernels.ssd.ssd`` with ``interpret=True``)
and the JAX dispatch's XLA paths, on the same numpy inputs, at the shape
grids of ``tests/test_kernels.py:86-128`` plus a longer one that carries
the state across several chunks. ``causal_conv1d``, ``selective_scan_step``
and ``ssd_step``, plain code on every device, are held against
``repro.kernels.ops``. The dispatch in ``repro_torch.kernels.ops`` sends a
CPU tensor to the plain version and counts it.

Tolerances are those of ``tests/test_kernels.py:28-30,106,128``: outputs
in bf16 atol = rtol = 2e-2, in f32 2e-5; the f32 final state 5e-3.

The CUDA kernels run only on the card: ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.selective_scan import selective_scan as pallas_scan  # noqa: E402
from repro.kernels.ssd import ssd as pallas_ssd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(1)
RNG = np.random.default_rng(43)
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}
STATE_TOL = dict(atol=5e-3, rtol=5e-3)


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


def _scan_inputs(b, s, di, n, dtype):
    return [
        pair(RNG.standard_normal((b, s, di)) * 0.5, dtype),              # x
        pair(np.abs(RNG.standard_normal((b, s, di))) * 0.1, dtype),      # dt
        pair(-np.abs(RNG.standard_normal((di, n))) - 0.1, "f32"),        # A
        pair(RNG.standard_normal((b, s, n)) * 0.5, dtype),               # B
        pair(RNG.standard_normal((b, s, n)) * 0.5, dtype),               # C
        pair(RNG.standard_normal((di,)), "f32"),                         # D
        pair(RNG.standard_normal((b, di, n)) * 0.1, "f32"),              # h0
    ]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "b,s,di,n,chunk,bc",
    [(2, 40, 24, 8, 16, 16), (1, 16, 128, 16, 8, 64), (2, 7, 8, 4, 16, 8),
     (1, 70, 32, 16, 16, 32)],
)
def test_selective_scan_matches_reference(b, s, di, n, chunk, bc, dtype):
    ins = _scan_inputs(b, s, di, n, dtype)
    j, t = [a for a, _ in ins], [a for _, a in ins]
    y, hT = ref.selective_scan(*t)
    assert y.dtype == t[0].dtype and hT.dtype == torch.float32
    wants = [jref.selective_scan(*j),
             pallas_scan(*j, chunk=chunk, block_channels=bc, interpret=True),
             jops._selective_scan_xla(*j, chunk=chunk)]
    for yw, hw in wants:
        np.testing.assert_allclose(f32(y), f32(yw), **tol(dtype))
        np.testing.assert_allclose(f32(hT), f32(hw), **STATE_TOL)


def _ssd_inputs(b, s, hs, p, n, dtype):
    return [
        pair(RNG.standard_normal((b, s, hs, p)) * 0.5, dtype),           # x
        pair(np.abs(RNG.standard_normal((b, s, hs))) * 0.1, dtype),      # dt
        pair(-np.abs(RNG.standard_normal((hs,))) - 0.1, "f32"),          # A
        pair(RNG.standard_normal((b, s, n)) * 0.5, dtype),               # B
        pair(RNG.standard_normal((b, s, n)) * 0.5, dtype),               # C
        pair(RNG.standard_normal((hs,)), "f32"),                         # D
        pair(RNG.standard_normal((b, hs, p, n)) * 0.1, "f32"),           # h0
    ]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "b,s,hs,p,n,chunk",
    [(2, 48, 3, 16, 8, 16), (1, 16, 8, 64, 16, 8), (2, 5, 2, 8, 4, 16),
     (1, 70, 2, 16, 8, 16)],
)
def test_ssd_matches_reference(b, s, hs, p, n, chunk, dtype):
    ins = _ssd_inputs(b, s, hs, p, n, dtype)
    j, t = [a for a, _ in ins], [a for _, a in ins]
    y, hT = ref.ssd(*t, chunk=chunk)
    assert y.dtype == t[0].dtype and hT.dtype == torch.float32
    wants = [jref.ssd(*j), pallas_ssd(*j, chunk=chunk, interpret=True),
             jops._ssd_xla(*j, chunk=chunk)]
    for yw, hw in wants:
        np.testing.assert_allclose(f32(y), f32(yw), **tol(dtype))
        np.testing.assert_allclose(f32(hT), f32(hw), **STATE_TOL)


def test_ssd_long_chunk_does_not_overflow():
    """Decay from the difference l_i - l_j, never exp(l_i) * exp(-l_j): a
    chunk whose cumulative log-decay reaches -400 stays finite."""
    ins = _ssd_inputs(1, 64, 2, 8, 4, "f32")
    t = [a for _, a in ins]
    t[1] = torch.full_like(t[1], 8.0)                 # dt: l reaches -512
    t[2] = torch.full_like(t[2], -1.0)
    y, hT = ref.ssd(*t, chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(hT).all()
    yw, hw = jref.ssd(*[a for a, _ in ins[:1]], jnp.asarray(t[1].numpy()),
                      jnp.asarray(t[2].numpy()), *[a for a, _ in ins[3:]])
    np.testing.assert_allclose(f32(y), f32(yw), **tol("f32"))
    np.testing.assert_allclose(f32(hT), f32(hw), **STATE_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(dtype, with_state):
    jx, tx = pair(RNG.standard_normal((2, 9, 12)), dtype)
    jw, tw = pair(RNG.standard_normal((4, 12)), "f32")
    jb, tb = pair(RNG.standard_normal((12,)), "f32")
    js, ts = pair(RNG.standard_normal((2, 3, 12)), "bf16")
    state = (js, ts) if with_state else (None, None)
    got = ref.causal_conv1d(tx, tw, tb, state=state[1])
    want = jops.causal_conv1d(jx, jw, jb, state=state[0])
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_selective_scan_step_matches_reference(dtype):
    b, di, n = 3, 16, 4
    x, dt = pair(RNG.standard_normal((b, di)), dtype), \
        pair(np.abs(RNG.standard_normal((b, di))) * 0.1, dtype)
    A = pair(-np.abs(RNG.standard_normal((di, n))) - 0.1, "f32")
    Bm, C = pair(RNG.standard_normal((b, n)), dtype), \
        pair(RNG.standard_normal((b, n)), dtype)
    D = pair(RNG.standard_normal((di,)), "f32")
    h = pair(RNG.standard_normal((b, di, n)), "f32")
    ins = [x, dt, A, Bm, C, D, h]
    y, hn = ref.selective_scan_step(*[t for _, t in ins])
    yw, hw = jops.selective_scan_step(*[j for j, _ in ins])
    np.testing.assert_allclose(f32(y), f32(yw), **tol(dtype))
    np.testing.assert_allclose(f32(hn), f32(hw), **tol("f32"))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_step_matches_reference(dtype):
    b, hs, p, n = 3, 4, 8, 6
    ins = [pair(RNG.standard_normal((b, hs, p)), dtype),
           pair(np.abs(RNG.standard_normal((b, hs))) * 0.1, dtype),
           pair(-np.abs(RNG.standard_normal((hs,))) - 0.1, "f32"),
           pair(RNG.standard_normal((b, n)), dtype),
           pair(RNG.standard_normal((b, n)), dtype),
           pair(RNG.standard_normal((hs,)), "f32"),
           pair(RNG.standard_normal((b, hs, p, n)), "f32")]
    y, hn = ref.ssd_step(*[t for _, t in ins])
    yw, hw = jops.ssd_step(*[j for j, _ in ins])
    np.testing.assert_allclose(f32(y), f32(yw), **tol(dtype))
    np.testing.assert_allclose(f32(hn), f32(hw), **tol("f32"))


def test_dispatch_sends_cpu_tensors_to_the_plain_versions():
    ops.reset_counts()
    t = [a for _, a in _scan_inputs(1, 5, 8, 4, "bf16")]
    y, hT = ops.selective_scan(*t)
    want = ref.selective_scan(*t)
    assert torch.equal(y, want[0]) and torch.equal(hT, want[1])
    t = [a for _, a in _ssd_inputs(1, 5, 2, 8, 4, "bf16")]
    y, hT = ops.ssd(*t, chunk=4)
    want = ref.ssd(*t, chunk=4)
    assert torch.equal(y, want[0]) and torch.equal(hT, want[1])
    c = ops.counts()
    assert c["selective_scan"] == {"launches": 0, "plain": 1}
    assert c["ssd"] == {"launches": 0, "plain": 1}


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import selective_scan as sk
    from repro_torch.kernels import ssd as dk

    t = [a for _, a in _scan_inputs(1, 5, 8, 4, "bf16")]
    with pytest.raises(ValueError, match="CUDA"):
        sk.selective_scan(*t)
    t = [a for _, a in _ssd_inputs(1, 5, 2, 8, 4, "bf16")]
    with pytest.raises(ValueError, match="CUDA"):
        dk.ssd(*t)
    assert sk.selective_scan.launches == 0 and dk.ssd.launches == 0
