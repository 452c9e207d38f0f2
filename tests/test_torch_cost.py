"""Each kernel's cost and the meta pass that records it.

- the kernels' ``cost`` functions reproduce the bounds ``chip_smoke.py``
  printed on the card (PERF.md §6), to the printed digits, at their
  shapes, through ``launch/roofline.py::bound``;
- a meta tensor takes the card's path and makes no launch: every kernel
  of ``ops`` (and each autograd Function's backward) gives outputs of the
  plain version's shapes and types on the meta device and records one
  call, its cost and its launches, at the wrapper's launch; the verify and
  cross folds record their own cost; under ``use_backend("plain")`` a meta
  tensor goes through the plain version;
- the counter's peak of live bytes is exact on a hand-made sequence of
  allocations and views;
- with the default backend, the meta pass's calls per kernel equal the
  plain calls ``ops.counts()`` records when the same REDUCED cells (every
  family, train, prefill and decode at B 2, S 128) run on the CPU with
  real tensors. The plain bookkeeping counts a backward at each forward
  call that needs one (``ops.plain_calls``), so the backwards are held
  against the meta pass's tally of such forwards (``grad_calls``); the
  meta pass counts a backward where autograd runs it, as the card does.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.configs import REDUCED  # noqa: E402
from repro_torch.kernels import _cost  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import gemm_rows as gk  # noqa: E402
from repro_torch.kernels import moe_route as rk  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_decode_attention as pk  # noqa: E402
from repro_torch.kernels import rmsnorm as nk  # noqa: E402
from repro_torch.kernels import selective_scan as sk  # noqa: E402
from repro_torch.kernels import ssd as dk2  # noqa: E402
from repro_torch.launch.cells import build_cell, lower_cell  # noqa: E402
from repro_torch.launch.counter import MetaCounter  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.roofline import bound  # noqa: E402
from repro_torch.training.state import init_train_state  # noqa: E402

torch.set_num_threads(1)

QWEN_LENS = (0, 1, 63, 2048, 700, 1300, 2047, 64)      # check_decode
PAGED_LENS = (0, 1, 63, 64, 65, 2047, 700, 1300)       # check_paged_decode
TRAIN_T = 2 * 2048                                     # B 2 x S 2048

# (what, cost, the bound PERF.md prints in ms): the card's rows
BOUNDS = [
    ("rmsnorm (8, 4096)", nk.cost(8, 4096), "0.000044"),
    ("rmsnorm zamba2 (8, 2048)", nk.cost(8, 2048), "0.000022"),
    ("rmsnorm smollm train (16384, 960)", nk.cost(16384, 960), "0.018782"),
    ("rmsnorm qwen3 block train", nk.cost(4096, 4096), "0.020037"),
    ("rmsnorm qwen3 qk train", nk.cost(131072, 128), "0.020033"),
    ("rmsnorm_bwd smollm", nk.bwd_cost(16384, 960), "0.028173"),
    ("rmsnorm_bwd qwen3 qk", nk.bwd_cost(131072, 128), "0.030049"),
    ("rmsnorm_bwd qwen3 block", nk.bwd_cost(4096, 4096), "0.030059"),
    ("decode_attention qwen3", dk.cost(8, 32, 8, 128, 2048, QWEN_LENS),
     "0.007648"),
    ("decode_attention zamba2", dk.cost(8, 32, 32, 64, 2048, QWEN_LENS),
     "0.015237"),
    ("paged decode qwen3", pk.cost(8, 32, 8, 128, 8 * 32, sum(PAGED_LENS)),
     "0.005224"),
    ("paged decode zamba2", pk.cost(8, 32, 32, 64, 8 * 32, sum(PAGED_LENS)),
     "0.010388"),
    ("paged verify qwen3 8 x 5", pk.verify_cost(
        8, 5, 32, 8, 128, 8 * 32, (1, 63, 64, 65, 2042, 700, 1300, 0)),
     "0.005423"),
    ("cross fold C 1", pk.cross_cost(8, 1, 16, 16, 64, 8 * 24,
                                     4 * (1500 + 750)), "0.011014"),
    ("cross fold C 256 at 1500", pk.cross_cost(1, 256, 16, 16, 64, 24, 1500),
     "0.002147"),
    ("cross fold C 256 at 750", pk.cross_cost(1, 256, 16, 16, 64, 24, 750),
     "0.001230"),
    ("cross fold C 256 at 1500, f32", pk.cross_cost(
        1, 256, 16, 16, 64, 24, 1500, unit="f32"), "0.023476"),
    ("flash chunk", fk.cost(1, 256, 1536, 32, 8, 128, q_offset=1280),
     "0.005973"),
    ("flash dense prefill", fk.cost(1, 2048, 2048, 32, 8, 128), "0.034759"),
    ("flash encoder 1500", fk.cost(1, 1500, 1500, 16, 16, 64, causal=False),
     "0.009319"),
    ("flash train smollm", fk.cost(8, 2048, 2048, 15, 5, 64, with_lse=True),
     "0.065173"),
    ("flash train qwen3", fk.cost(2, 2048, 2048, 32, 8, 128, with_lse=True),
     "0.069518"),
    ("flash train whisper cross", fk.cost(
        2, 2048, 1500, 16, 16, 64, causal=False, with_lse=True), "0.025446"),
    ("flash_bwd smollm", fk.bwd_cost(8, 2048, 2048, 15, 5, 64), "0.162932"),
    ("flash_bwd qwen3", fk.bwd_cost(2, 2048, 2048, 32, 8, 128), "0.173794"),
    ("flash_bwd whisper encoder", fk.bwd_cost(2, 1500, 1500, 16, 16, 64,
                                              causal=False), "0.046593"),
    ("selective_scan (1, 256, 8192)", sk.cost(1, 256, 8192, 16), "0.008024"),
    ("selective_scan S 2048", sk.cost(1, 2048, 8192, 16), "0.064192"),
    ("selective_scan N 4", sk.cost(1, 256, 8192, 4), "0.003884"),
    ("selective_scan train", sk.cost(2, 2048, 8192, 16, save_states=True),
     "0.128384"),
    ("selective_scan_bwd train", sk.bwd_cost(2, 2048, 8192, 16), "0.128384"),
    ("ssd (1, 256, 64, 64)", dk2.cost(1, 256, 64, 64, 64), "0.001908"),
    ("ssd S 2048", dk2.cost(1, 2048, 64, 64, 64), "0.010877"),
    ("ssd f32 basis", dk2.cost(1, 256, 64, 64, 64, unit="f32"), "0.008186"),
    ("ssd train", dk2.cost(2, 2048, 64, 64, 64, keep_scratch=True),
     "0.027077"),
    ("ssd_bwd train", dk2.bwd_cost(2, 2048, 64, 64, 64), "0.036936"),
    ("moe_route deepseek T 8", rk.cost(8, 2048, 64, 6), "0.000166"),
    ("moe_route deepseek T 256", rk.cost(256, 2048, 64, 6), "0.001002"),
    ("moe_route granite T 40", rk.cost(40, 1024, 32, 8), "0.000064"),
    ("moe_route probs granite", rk.cost(TRAIN_T, 1024, 32, 8,
                                        with_probs=True), "0.004006"),
    ("moe_route probs deepseek", rk.cost(TRAIN_T, 2048, 64, 6,
                                         with_probs=True), "0.016026"),
    ("moe_route_bwd granite", rk.bwd_cost(TRAIN_T, 1024, 32, 8), "0.005517"),
    ("moe_route_bwd deepseek", rk.bwd_cost(TRAIN_T, 2048, 64, 6),
     "0.011043"),
    ("moe_route_bwd granite f32", rk.bwd_cost(TRAIN_T, 1024, 32, 8,
                                              basis="f32"), "0.008023"),
    ("moe_route_bwd deepseek f32", rk.bwd_cost(TRAIN_T, 2048, 64, 6,
                                               basis="f32"), "0.032069"),
]


@pytest.mark.parametrize("what,cost,printed", BOUNDS,
                         ids=[b[0] for b in BOUNDS])
def test_cost_reproduces_the_printed_bound(what, cost, printed):
    decimals = len(printed.split(".")[1])
    assert f"{bound(cost)['bound_ms']:.{decimals}f}" == printed


def test_a_decode_step_of_gemm_rows_adds_to_its_printed_bound():
    """qwen3-8b's decode step (36 layers of seven products and the
    unembedding) at 8, 40 and 4 rows: PERF.md's 4.532 / 4.587 / 4.525."""
    from repro_torch.configs import get

    cfg = get("qwen3-8b")
    got = []
    for M in (8, 40, 4):
        step = None
        for _, K, N, _, times in gk.step_products(cfg):
            c = times * gk.cost(M, K, N)
            step = c if step is None else step + c
        got.append(f"{bound(step)['bound_ms']:.3f}")
    assert got == ["4.532", "4.587", "4.525"]


def test_costs_count_launches_and_the_data_they_depend_on():
    assert [c.launches for c in (
        nk.cost(8, 64), nk.bwd_cost(8, 64), fk.cost(1, 8, 8, 4, 4, 64),
        fk.bwd_cost(1, 8, 8, 4, 4, 64), sk.cost(1, 8, 64, 16),
        sk.bwd_cost(1, 8, 64, 16), dk2.cost(1, 8, 4, 16, 16),
        dk2.bwd_cost(1, 8, 4, 16, 16), rk.cost(4, 64, 8, 2),
        rk.bwd_cost(4, 64, 8, 2), gk.cost(4, 64, 64))] == \
        [1, 2, 1, 2, 1, 2, 2, 3, 1, 2, 1]
    # the routing's rows, or (a meta pass) the whole capacity
    full = gk.grouped_cost(4, 8, 64, 32)
    routed = gk.grouped_cost(4, 8, 64, 32, counts=[3, 0, 8, 1])
    assert full.flops == 2 * 32 * 64 * 32
    assert routed.flops == 2 * 12 * 64 * 32
    assert routed.bytes == 2 * (3 * 64 * 32 + 12 * (64 + 32))
    # the causal pairs, by rows: a chunk at an offset against the mask
    for Sq, Sk, off in ((256, 1536, 1280), (200, 977, 777), (7, 7, 0),
                        (5, 3, 0), (4, 20, 30)):
        mask = torch.arange(Sk)[None, :] <= torch.arange(Sq)[:, None] + off
        assert fk.pairs(1, Sq, Sk, 1, q_offset=off) == int(mask.sum())
    # narrow heads count at their padded width
    assert fk.cost(1, 4, 4, 2, 2, 16).flops == fk.cost(1, 4, 4, 2, 2, 64).flops
    with pytest.raises(ValueError):
        nk.cost(1, 1) + fk.cost(1, 1, 1, 1, 1, 64)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _cpu(t, gen):
    if t.dtype in (torch.int32, torch.int64):
        return torch.zeros(t.shape, dtype=t.dtype)
    return torch.randn(t.shape, generator=gen).to(t.dtype)


def _calls():
    """(every meta call recorded, a recorder) for ``_cost.recording``."""
    got = []
    return got, lambda name, cost: got.append((name, cost))


OPS = {
    "rmsnorm": (lambda: (_meta(3, 5, 64), _meta(64, dtype=torch.float32)),
                lambda x, w: ops.rmsnorm(x, w)),
    "flash_attention": (lambda: (_meta(2, 9, 4, 16), _meta(2, 9, 2, 16),
                                 _meta(2, 9, 2, 16)),
                        lambda q, k, v: ops.attention(q, k, v)),
    "decode_attention": (lambda: (_meta(2, 4, 16), _meta(2, 24, 2, 16),
                                  _meta(2, 24, 2, 16),
                                  _meta(2, dtype=torch.int32)),
                         ops.decode_attention),
    "paged_decode_attention": (
        lambda: (_meta(2, 4, 16), _meta(5, 8, 2, 16), _meta(5, 8, 2, 16),
                 _meta(2, 3, dtype=torch.int32), _meta(2, dtype=torch.int32)),
        ops.paged_decode_attention),
    "gemm_rows": (lambda: (_meta(3, 64), _meta(64, 32)), ops.gemm_rows),
    "gemm_rows_grouped": (lambda: (_meta(4, 8, 64), _meta(4, 64, 32)),
                          ops.gemm_rows_grouped),
    "moe_route": (lambda: (_meta(6, 64), _meta(64, 8, dtype=torch.float32)),
                  lambda x, r: ops.moe_route(x, r, 2, with_probs=True)),
    "selective_scan": (
        lambda: (_meta(1, 12, 32), _meta(1, 12, 32),
                 _meta(32, 4, dtype=torch.float32), _meta(1, 12, 4),
                 _meta(1, 12, 4), _meta(32, dtype=torch.float32)),
        ops.selective_scan),
    "ssd": (lambda: (_meta(1, 12, 2, 8), _meta(1, 12, 2),
                     _meta(2, dtype=torch.float32), _meta(1, 12, 8),
                     _meta(1, 12, 8), _meta(2, dtype=torch.float32)),
            lambda *a: ops.ssd(*a, chunk=8)),
}
BACKWARD = {"rmsnorm": "rmsnorm_bwd", "flash_attention": "flash_attention_bwd",
            "moe_route": "moe_route_bwd", "selective_scan": "selective_scan_bwd",
            "ssd": "ssd_bwd"}


@pytest.mark.parametrize("name", sorted(OPS))
def test_meta_branch_gives_the_plain_shapes_and_records_one_call(name):
    make, run = OPS[name]
    args = make()
    gen = torch.Generator().manual_seed(0)
    want = run(*[_cpu(a, gen) for a in args])
    got, sink = _calls()
    before = {n: c["launches"] for n, c in ops.counts().items()}
    with _cost.recording(sink):
        out = run(*args)
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(want, tuple) else (want,)
    assert [(o.shape, o.dtype, o.device.type) for o in outs] == \
        [(w.shape, w.dtype, "meta") for w in wants]
    assert [n for n, _ in got] == [name]
    assert got[0][1].launches >= 1 and got[0][1].bytes > 0
    assert {n: c["launches"] for n, c in ops.counts().items()} == before
    # the plain backend sends a meta tensor through the plain version
    got.clear()
    with _cost.recording(sink), ops.use_backend("plain"):
        plain = run(*args)
    assert not got
    plain = plain if isinstance(plain, tuple) else (plain,)
    assert [(o.shape, o.dtype) for o in plain] == \
        [(w.shape, w.dtype) for w in wants]


@pytest.mark.parametrize("name", sorted(BACKWARD))
def test_meta_backward_records_its_kernel_with_input_shaped_grads(name):
    make, run = OPS[name]
    args = [a.requires_grad_() if a.is_floating_point() else a
            for a in make()]
    got, sink = _calls()
    noted = []
    with _cost.recording(sink, noted.append):
        out = run(*args)
        outs = out if isinstance(out, tuple) else (out,)
        loss = sum(o.float().sum() for o in outs if o.is_floating_point())
        grads = torch.autograd.grad(loss, [a for a in args
                                           if a.requires_grad])
    assert [n for n, _ in got] == [name, BACKWARD[name]]
    assert noted == [BACKWARD[name]]
    assert [(g.shape, g.dtype) for g in grads] == \
        [(a.shape, a.dtype) for a in args if a.requires_grad]


def test_meta_folds_record_their_own_cost():
    """The verify and cross folds run the paged decode kernel over folded
    lanes; on meta tensors it records the fold's cost (each lane's table
    read once, a cross read's products on the tensor cores) over every
    position of the tables, the window at the table's end."""
    B, W, C, H, K, D, P, pages = 2, 3, 5, 4, 2, 16, 8, 3
    kp = _meta(7, P, K, D)
    table, lens = _meta(B, pages, dtype=torch.int32), \
        _meta(B, dtype=torch.int32)
    got, sink = _calls()
    with _cost.recording(sink):
        v = ops.paged_verify_attention(_meta(B, W, H, D), kp, kp, table, lens)
        c = ops.paged_cross_attention(_meta(B, C, H, D), kp, kp, table, lens)
    cap = pages * P
    assert (v.shape, c.shape) == ((B, W, H, D), (B, C, H, D))
    assert got == [
        ("paged_decode_attention",
         pk.verify_cost(B, W, H, K, D, B * pages, [cap - W] * B)),
        ("paged_decode_attention",
         pk.cross_cost(B, C, H, K, D, B * pages, B * cap))]
    assert got[1][1].unit == "bf16"


def test_peak_bytes_are_exact_on_allocations_and_views():
    with MetaCounter() as c:
        a = torch.empty(1000, dtype=torch.float32, device="meta")   # 4000
        v = a.view(10, 100)                      # a view: no new bytes
        b = a + 1                                # 8000 live
        del a                                    # v keeps a's storage
        c2 = v.t().contiguous()                  # 12000 live: the peak
        del v, b                                 # 4000 live
        d = torch.empty(500, dtype=torch.bfloat16, device="meta")  # 5000
        del c2, d
    assert c.peak_bytes == 12000
    assert c.live == 0
    # an argument written in place is not the pass's
    x = torch.empty(100, device="meta")
    with MetaCounter() as c:
        x.add_(1)
        y = x[:10] * 2
    assert c.peak_bytes == 40 and c.bytes == 400 + 400 + 40 + 40
    del y


# one REDUCED config of each family
FAMILY_ARCHS = ("qwen3-8b", "granite-moe-1b-a400m", "falcon-mamba-7b",
                "zamba2-1.2b", "whisper-medium", "llava-next-mistral-7b")


def _real_args(prog, gen):
    """The cell's inputs as CPU tensors: seeded weights, random tokens, a
    zeroed cache with every lane at a position inside it."""
    model, shape = prog.model, prog.shape

    def fill(t):
        if t.dtype in (torch.int32, torch.int64):
            hi = model.cfg.vocab_size if t.ndim == 2 else shape.seq_len
            return torch.randint(0, hi, t.shape, generator=gen,
                                 dtype=t.dtype)
        return torch.randn(t.shape, generator=gen).to(t.dtype)

    batch = {k: fill(v) for k, v in prog.abstract_args[-1].items()}
    if shape.kind == "train":
        return init_train_state(prog.model, 0, "cpu"), batch
    params = model.init(0, "cpu")
    if shape.kind == "prefill":
        return params, batch
    return params, model.init_cache(shape.global_batch, shape.seq_len,
                                    device="cpu"), batch


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_meta_pass_calls_equal_the_cpu_runs_plain_calls(arch, kind):
    prog = build_cell(REDUCED[arch], ShapeConfig("t", 128, 2, kind),
                      make_host_mesh(1, 1), run=RunConfig(arch=arch))
    meta = lower_cell(prog)
    args = _real_args(prog, torch.Generator().manual_seed(1))
    ops.reset_counts()
    prog.fn(*args)
    plain = {n: c["plain"] for n, c in ops.counts().items() if c["plain"]}
    assert not any(c["launches"] for c in ops.counts().values())
    forward = {n: k["calls"] for n, k in meta["kernels"].items()
               if not n.endswith("_bwd")}
    assert forward == {n: c for n, c in plain.items()
                       if not n.endswith("_bwd")}
    assert meta["grad_calls"] == {n: c for n, c in plain.items()
                                  if n.endswith("_bwd")}
    # autograd runs each backward once a layer: the recomputed forward
    # (remat) needs no backward of its own
    backward = {n: k["calls"] for n, k in meta["kernels"].items()
                if n.endswith("_bwd")}
    assert set(backward) == set(meta["grad_calls"])
    assert all(0 < backward[n] <= meta["grad_calls"][n] for n in backward)
    assert (kind == "train") == bool(backward)
