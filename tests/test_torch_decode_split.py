"""The split-and-merge arithmetic of the decode kernels, on the CPU.

Both decode kernels (``csrc/flash_decode.cuh``) cut each lane's keys into
fixed segments of ``SEG`` keys, compute an f32 partial ``(m, l, acc)`` per
segment, and merge the partials in segment order in one online pass. A
CUDA kernel cannot run here, so this file holds a plain-torch mirror of
that arithmetic (segments and merge written out, nothing of the kernel's
tiling) against the JAX package's oracle, ``repro.kernels.ref
.decode_attention``, in f32 at atol = rtol = 2e-5 (``tests/test_kernels.py``),
at lengths around the segment boundary and at the whole cache; a lane of
length 0 against the port's plain version, which gives zeros as the kernels
do (the JAX oracle averages there: ROADMAP Queue 3, P2). It also holds the
wrapper's helper for the segment count and the scratch shape.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _flash_decode, ref  # noqa: E402

SEG = _flash_decode.SEG
NEG_INF = -1e30
HEADER = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
          / "flash_decode.cuh")


def split_decode(q, k, v, lengths):
    """The kernels' arithmetic in plain torch, f32: per lane and kv head,
    one partial (m, l, acc) per segment of SEG keys, then one online merge
    in segment order; zeros for a lane of length 0."""
    B, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = D ** -0.5
    out = torch.zeros(B, H, D)
    for b in range(B):
        n = int(min(max(int(lengths[b]), 0), k.shape[1]))
        for kh in range(K):
            qg = q[b, kh * G:(kh + 1) * G].float()           # (G, D)
            parts = []
            for s0 in range(0, n, SEG):
                kk = k[b, s0:min(s0 + SEG, n), kh].float()   # (n_s, D)
                vv = v[b, s0:min(s0 + SEG, n), kh].float()
                s = (qg @ kk.T) * scale                      # (G, n_s)
                m = s.max(dim=1).values
                p = torch.exp(s - m[:, None])
                parts.append((m, p.sum(dim=1), p @ vv))
            if not parts:
                continue
            mx = torch.full((G,), NEG_INF)
            lt = torch.zeros(G)
            acc = torch.zeros(G, D)
            for m, l, a in parts:                            # segment order
                mn = torch.maximum(mx, m)
                co, cn = torch.exp(mx - mn), torch.exp(m - mn)
                lt = lt * co + l * cn
                acc = acc * co[:, None] + a * cn[:, None]
                mx = mn
            out[b, kh * G:(kh + 1) * G] = acc / lt.clamp_min(1e-30)[:, None]
    return out


def _case(rng, lengths, S, H=8, K=2, D=32):
    B = len(lengths)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("H,K,D", [(8, 2, 32), (4, 4, 16), (16, 2, 64)])
def test_split_merge_matches_the_oracle(H, K, D):
    """Lengths 1, SEG - 1, SEG, SEG + 1 and the whole cache S (three
    segments, the last one partial)."""
    S = 2 * SEG + 77
    rng = np.random.default_rng(H * D)
    q, k, v, lens = _case(rng, [1, SEG - 1, SEG, SEG + 1, S], S, H, K, D)
    got = split_decode(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    want = np.asarray(jref.decode_attention(*(jnp.asarray(a) for a in
                                              (q, k, v, lens))))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_split_merge_zero_length_lane_gives_zeros():
    S = SEG + 5
    rng = np.random.default_rng(0)
    q, k, v, lens = _case(rng, [0, S, 3], S)
    args = [torch.from_numpy(a) for a in (q, k, v, lens)]
    got = split_decode(*args)
    assert not got[0].any()
    torch.testing.assert_close(got, ref.decode_attention(*args), atol=2e-5,
                               rtol=2e-5)


def test_split_merge_is_independent_of_the_batch_and_of_s():
    """A lane's segments follow only its own length: alone, among longer
    lanes, or in a cache of another S, its result is the same bits."""
    S = 3 * SEG
    rng = np.random.default_rng(1)
    q, k, v, _ = _case(rng, [0, 0, 0], S)
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    lane = 1
    got = split_decode(q, k, v, torch.tensor([SEG + 9, 2 * SEG + 3, S]))
    alone = split_decode(q[lane:lane + 1], k[lane:lane + 1], v[lane:lane + 1],
                         torch.tensor([2 * SEG + 3]))
    longer = split_decode(q, k, v, torch.tensor([S, 2 * SEG + 3, S]))
    wide = torch.cat([k[lane:lane + 1], torch.ones(1, SEG, *k.shape[2:])], 1)
    other_s = split_decode(q[lane:lane + 1], wide,
                           torch.cat([v[lane:lane + 1], wide[:, S:]], 1),
                           torch.tensor([2 * SEG + 3]))
    for other in (alone[0], longer[lane], other_s[0]):
        assert torch.equal(other, got[lane])


def test_segment_count_and_scratch_shape():
    assert [_flash_decode.n_segments(c) for c in (0, 1, SEG - 1, SEG,
                                                   SEG + 1, 2048)] == \
        [0, 1, 1, 1, 2, -(-2048 // SEG)]
    # a record of G * D + 16 floats: acc (G, D), m at G * D, l at G * D + 8,
    # 16-byte aligned for every G * D the kernels take (D 64 or 128)
    assert _flash_decode.partial_shape(8, 8, 4, 128, 2048) == \
        (8, 8, -(-2048 // SEG), 4 * 128 + 16)
    for G in range(1, 9):
        for D in (64, 128):
            assert (G * D + 16) * 4 % 16 == 0


def test_segment_size_is_the_kernels():
    """The wrapper sizes its scratch with the header's SEG."""
    m = re.search(r"^#define SEG (\d+)", HEADER.read_text(), re.M)
    assert m and int(m.group(1)) == SEG and SEG % 64 == 0


def test_scratch_counters_are_zero_and_grow():
    dev = torch.device("cpu")
    _flash_decode._counters.pop(dev, None)
    part, cnt = _flash_decode.scratch(2, 8, 4, 64, 600, dev)
    assert part.shape == (2, 8, 3, 4 * 64 + 16) and part.dtype == torch.float32
    assert cnt.numel() >= 16 and not cnt.any()
    _, again = _flash_decode.scratch(2, 8, 4, 64, 600, dev)
    assert again.data_ptr() == cnt.data_ptr()   # one buffer per device
    _, grown = _flash_decode.scratch(64, 8, 1, 64, 600, dev)
    assert grown.numel() >= 512 and not grown.any()
    _flash_decode._counters.pop(dev, None)
