"""Kernel dispatch for the serving path.

A tensor on the CPU goes to the plain PyTorch version (``ref.py``). A CUDA
tensor launches the hand-written kernel, and a kernel that refuses its input
raises: nothing falls back. ``use_backend("plain")`` is an explicit, scoped
override that sends CUDA tensors to the plain versions too, mirroring the JAX
package's ``use_backend`` (``repro/kernels/ops.py:53-61``); only tests and
the comparison phase of ``chip_smoke.py`` enter it, never the engine or the
CLI.

Each kernel wrapper counts its own launches (``<wrapper>.launches``); this
module counts the calls that went to a plain version, so a run can show
which path it took. ``paged_verify_attention`` and ``paged_cross_attention``
are no kernels of their own: on the card each folds its query rows into the
paged decode kernel (``_fold``), the verify window into its batch as the TPU
path does (``repro/kernels/ops.py:285-301``), a cross read's rows eight to a
lane into its GQA groups, and counts there. ``gemm_rows`` has
no TPU kernel: it is the paged decode step's row-invariant product
(``kernels/gemm_rows.py``); nor have ``gemm_rows_grouped``, its form over
all experts of an MoE layer, and ``moe_route``, the MoE router
(``kernels/moe_route.py``). ``causal_conv1d``, ``selective_scan_step`` and
``ssd_step`` have no TPU kernel (the JAX package runs them through XLA on
every backend): they are plain code on every device, and not counted.

Training differentiates ``attention``, ``rmsnorm``, ``selective_scan``,
``ssd`` and ``moe_route``. When an input needs a gradient, a CUDA tensor
goes through the ``torch.autograd.Function`` of the kernel
(``flash_attention.FlashAttention``, ``rmsnorm.RMSNorm``,
``selective_scan.SelectiveScan``, ``ssd.SSD``, ``moe_route.MoeRoute``),
whose backward is a hand-written kernel too (``flash_attention_bwd``,
``rmsnorm_bwd``, ``selective_scan_bwd``, ``ssd_bwd``, ``moe_route_bwd``,
counted in ``counts()``); a CPU tensor, or any under
``use_backend("plain")``, goes to the plain version and autograd
differentiates that: the oracle of the backward kernels. Such a call counts
a plain call of the backward too. A call that needs no gradient (serving)
takes the path it always took.

A meta tensor (the dry-run's pass, ``launch/counter.py``) takes the
card's path under the kernel backend, autograd Functions included: each
wrapper checks it and allocates as on the card, and at its launch records
the call's cost (``kernels/_cost.py``) in place of the launch, with no
``ctypes`` call and no launch counted. Under ``use_backend("plain")`` it
goes to the plain version like a CPU tensor.

A DTensor (a tensor laid out on a ``DeviceMesh`` by the partition rules,
``parallel/partition.py``) reaches ``rmsnorm``, ``attention``,
``paged_decode_attention`` and ``gemm_rows``: each takes it through a
``local_map`` whose placements keep every shard whole for the function,
and calls itself on the local blocks, so that each block takes the path
its device takes (the kernel on ``cuda``, the plain version on ``cpu`` or
under ``use_backend("plain")``) and counts there. Heads shard with the kv
heads: rank ``r`` of a model axis of size ``m`` holds query heads ``[r H /
m, (r + 1) H / m)`` and kv heads ``[r K / m, (r + 1) K / m)``, so its GQA
groups are whole. A row-parallel ``gemm_rows`` (``w`` sharded on K) gives a
partial sum, reduced where ``shard()`` or the next operation asks; a row's
bits then depend on the reduction's order, so the row invariance of one
device is not claimed across a model axis. Every other entry refuses a
DTensor: its sharded form is ROADMAP item 16b.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import _cost
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gemm_rows as _gemm
from repro_torch.kernels import moe_route as _route
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import selective_scan as _scan
from repro_torch.kernels import ssd as _ssd

_BACKENDS = ("kernel", "plain")
_BACKEND: contextvars.ContextVar[str] = contextvars.ContextVar(
    "repro_torch_kernel_backend", default="kernel"
)

KERNELS = {
    "rmsnorm": _rmsnorm.rmsnorm,
    "paged_decode_attention": _paged.paged_decode_attention,
    "decode_attention": _decode.decode_attention,
    "flash_attention": _flash.flash_attention,
    "selective_scan": _scan.selective_scan,
    "ssd": _ssd.ssd,
    "gemm_rows": _gemm.gemm_rows,
    "moe_route": _route.moe_route,
    "gemm_rows_grouped": _gemm.gemm_rows_grouped,
    "flash_attention_bwd": _flash.flash_attention_bwd,
    "rmsnorm_bwd": _rmsnorm.rmsnorm_bwd,
    "selective_scan_bwd": _scan.selective_scan_bwd,
    "ssd_bwd": _ssd.ssd_bwd,
    "moe_route_bwd": _route.moe_route_bwd,
}
plain_calls = {name: 0 for name in KERNELS}


def current_backend() -> str:
    """The backend of the current scope ("kernel" or "plain")."""
    return _BACKEND.get()


@contextlib.contextmanager
def use_backend(name: str):
    """Scoped backend choice: "kernel" (the default) or "plain"."""
    if name not in _BACKENDS:
        raise ValueError(f"backend {name!r}: expected one of {_BACKENDS}")
    tok = _BACKEND.set(name)
    try:
        yield
    finally:
        _BACKEND.reset(tok)


def counts() -> dict[str, dict[str, int]]:
    """Kernel launches and plain-version calls so far, per kernel."""
    return {name: {"launches": fn.launches, "plain": plain_calls[name]}
            for name, fn in KERNELS.items()}


def reset_counts() -> None:
    for name, fn in KERNELS.items():
        fn.launches = 0
        plain_calls[name] = 0


def _plain(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu" or _BACKEND.get() == "plain":
        plain_calls[name] += 1
        return True
    return False


def _dtensor(*ts) -> bool:
    return any(isinstance(t, DTensor) for t in ts)


def _refuse_dtensor(name: str, *ts) -> None:
    """An entry with no sharded form yet takes no DTensor: it raises
    rather than gather the shards behind the caller's back."""
    if _dtensor(*ts):
        raise NotImplementedError(
            f"ops.{name} takes no DTensor: its sharded form (the SSM, "
            "hybrid, MoE, enc-dec and speculative paths on a mesh) is "
            "ROADMAP item 16b")


def _lift(*ts) -> tuple:
    """The mesh of the DTensors among ``ts``, then every one of ``ts`` as
    a DTensor of it (a plain tensor replicated)."""
    mesh = next(t for t in ts if isinstance(t, DTensor)).device_mesh
    rep = [Replicate()] * mesh.ndim
    return (mesh, *(t if isinstance(t, DTensor) else
                    DTensor.from_local(t, mesh, rep, run_check=False)
                    for t in ts))


def _whole(t: DTensor, *dims: int) -> list:
    """``t``'s placements with ``dims`` whole: a shard of one of them, or a
    partial sum, becomes ``Replicate()``."""
    keep = {d % t.ndim for d in dims}
    return [p if isinstance(p, Shard) and p.dim not in keep else Replicate()
            for p in t.placements]


def _note_grad(x: torch.Tensor, name: str) -> None:
    """A kernel call that needs a gradient: on meta tensors, its backward
    ``name`` noted for the meta pass (the tally ``plain_calls`` keeps for
    a plain call)."""
    if x.is_meta:
        _cost.note_grad(name)


def _needs_grad(*ts: torch.Tensor | None) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    if _dtensor(x, w):
        # rows shard as they are; the normalized dim is whole, w replicated
        mesh, x, w = _lift(x, w)
        px = _whole(x, -1)
        return local_map(rmsnorm, out_placements=px,
                         in_placements=(px, [Replicate()] * mesh.ndim, None),
                         device_mesh=mesh, redistribute_inputs=True)(x, w, eps)
    grad = _needs_grad(x, w)
    if _plain(x, "rmsnorm"):
        if grad:
            plain_calls["rmsnorm_bwd"] += 1
        return ref.rmsnorm(x, w, eps)
    if grad:
        _note_grad(x, "rmsnorm_bwd")
        return _rmsnorm.RMSNorm.apply(x, w, eps)
    return _rmsnorm.rmsnorm(x, w, eps)


def attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, K, D)
    v: torch.Tensor,  # (B, Sk, K, D)
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    if _dtensor(q, k, v):
        return _attention_shards(q, k, v, causal, q_offset)
    grad = _needs_grad(q, k, v)
    if _plain(q, "flash_attention"):
        if grad:
            plain_calls["flash_attention_bwd"] += 1
        return ref.attention(q, k, v, causal=causal, q_offset=q_offset)
    if grad:
        _note_grad(q, "flash_attention_bwd")
        return _flash.FlashAttention.apply(q, k, v, causal, q_offset)
    return _flash.flash_attention(q, k, v, causal=causal, q_offset=q_offset)


def _heads_and_batch(q: DTensor, kv: DTensor, hq: int, hk: int,
                     bq: int | None, bk: int | None) -> tuple[list, list]:
    """Placements that keep each GQA group whole: on a mesh dim where the
    kv operand shards its heads (dim ``hk``), the queries shard theirs
    (``hq``) alike; on a dim where the queries shard their batch (``bq``),
    the kv operand shards its own (``bk``), or stays whole where it has
    none (a page pool); every other dim is replicated."""
    pq, pk = [], []
    for a, b in zip(q.placements, kv.placements):
        if isinstance(b, Shard) and b.dim == hk:
            pq.append(Shard(hq))
            pk.append(Shard(hk))
        elif bq is not None and isinstance(a, Shard) and a.dim == bq:
            pq.append(Shard(bq))
            pk.append(Shard(bk) if bk is not None else Replicate())
        else:
            pq.append(Replicate())
            pk.append(Replicate())
    return pq, pk


def _attention_shards(q, k, v, causal: bool, q_offset: int) -> DTensor:
    """``attention`` on DTensors: heads sharded as k's kv heads are, the
    batch as q's is; each rank runs its block."""
    mesh, q, k, v = _lift(q, k, v)
    pq, pk = _heads_and_batch(q, k, 2, 2, 0, 0)

    def run(q, k, v):
        return attention(q, k, v, causal=causal, q_offset=q_offset)

    return local_map(run, out_placements=pq, in_placements=(pq, pk, pk),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def decode_attention(
    q: torch.Tensor,        # (B, H, D)
    k: torch.Tensor,        # (B, S, K, D)
    v: torch.Tensor,        # (B, S, K, D)
    lengths: torch.Tensor,  # (B,) int32
) -> torch.Tensor:
    """One token per lane over a dense cache; zeros for a lane of length 0,
    as the TPU kernel gives (``ref.decode_attention``)."""
    _refuse_dtensor("decode_attention", q, k, v, lengths)
    if _plain(q, "decode_attention"):
        return ref.decode_attention(q, k, v, lengths)
    return _decode.decode_attention(q, k, v, lengths)


def paged_decode_attention(
    q: torch.Tensor,           # (B, H, D)
    k_pages: torch.Tensor,     # (n_pages, P, K, D)
    v_pages: torch.Tensor,     # (n_pages, P, K, D)
    page_table: torch.Tensor,  # (B, max_pages) int32
    lengths: torch.Tensor,     # (B,) int32
) -> torch.Tensor:
    if _dtensor(q, k_pages, v_pages, page_table, lengths):
        return _paged_decode_shards(q, k_pages, v_pages, page_table, lengths)
    if _plain(q, "paged_decode_attention"):
        return ref.paged_decode_attention(q, k_pages, v_pages, page_table,
                                          lengths)
    return _paged.paged_decode_attention(q, k_pages, v_pages, page_table,
                                         lengths)


def _paged_decode_shards(q, k_pages, v_pages, page_table,
                         lengths) -> DTensor:
    """``paged_decode_attention`` on DTensors. A pool sharded on its kv
    heads gives each rank the query heads of its groups; a pool sharded on
    ``pages`` (the rules' fallback where the kv heads do not divide the
    model axis) is gathered whole first, since the kernel reads any page
    of a lane's table, and the queries are then whole on that dim too.
    Lanes shard as the queries' batch does, their table rows and lengths
    with them."""
    mesh, q, k_pages, v_pages, page_table, lengths = _lift(
        q, k_pages, v_pages, page_table, lengths)
    pq, pk = _heads_and_batch(q, k_pages, 1, 2, 0, None)
    lanes = [Shard(0) if p == Shard(0) else Replicate() for p in pq]
    return local_map(paged_decode_attention, out_placements=pq,
                     in_placements=(pq, pk, pk, lanes, lanes),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k_pages, v_pages, page_table, lengths)


def _fold(q, k_pages, v_pages, page_table, lengths, *, rows: int = 1,
          run=None, meta_cost=None) -> torch.Tensor:
    """``q (B, W, H, D)`` through the paged decode kernel (or ``run``, a
    function of its arguments) as ``B * W / rows`` folded lanes: each
    ``rows`` consecutive query rows of a lane, which share a length, stack
    into the GQA group of every kv head (``rows * H / K`` query heads a
    block, at most ``_paged.MAX_GROUP``), and each folded lane takes its
    lane's table row. ``lengths (B, W / rows)`` per folded lane; ``W`` a
    multiple of ``rows``. A row's arithmetic is the same wherever it sits in
    the group, so each is bitwise a one-lane decode at its length. On meta
    tensors the kernel records ``meta_cost``, the fold's own."""
    B, W, H, D = q.shape
    K = k_pages.shape[2]
    n = W // rows
    qf = (q.reshape(B, n, rows, K, H // K, D).transpose(2, 3)
          .reshape(B * n, K * rows * (H // K), D))
    table = page_table if n == 1 else page_table.repeat_interleave(n, dim=0)
    args = (qf.contiguous(), k_pages, v_pages, table.contiguous(),
            lengths.reshape(-1).to(torch.int32).contiguous())
    out = run(*args) if run else _paged.paged_decode_attention(
        *args, meta_cost=meta_cost)
    return (out.reshape(B, n, K, rows, H // K, D).transpose(2, 3)
            .reshape(B, W, H, D))


def paged_verify_attention(
    q: torch.Tensor,           # (B, W, H, D) — a window of W queries a lane
    k_pages: torch.Tensor,     # (n_pages, P, K, D)
    v_pages: torch.Tensor,     # (n_pages, P, K, D)
    page_table: torch.Tensor,  # (B, max_pages) int32
    positions: torch.Tensor,   # (B,) int32 — cache position of query 0
) -> torch.Tensor:
    """Causal multi-query paged decode for speculative verification: query
    ``j`` of lane ``b`` attends over ``positions[b] + j + 1`` entries. On the
    card the window folds into the batch of the paged decode kernel, lengths
    ``positions[:, None] + arange(W) + 1`` and the table repeated W times
    (``repro/kernels/ops.py:285-301``)."""
    _refuse_dtensor("paged_verify_attention", q, k_pages, v_pages,
                    page_table, positions)
    if _plain(q, "paged_decode_attention"):
        return ref.paged_verify_attention(q, k_pages, v_pages, page_table,
                                          positions)
    B, W, H, D = q.shape
    meta_cost = None
    if q.is_meta:   # no positions to read: each window at its table's end
        cap = page_table.shape[1] * k_pages.shape[1]
        meta_cost = _paged.verify_cost(B, W, H, k_pages.shape[2], D,
                                       page_table.numel(),
                                       [max(cap - W, 0)] * B)
    return _fold(q, k_pages, v_pages, page_table,
                 positions[:, None] + torch.arange(W, device=q.device) + 1,
                 meta_cost=meta_cost)


def cross_rows(C: int, H: int, K: int) -> int:
    """Query rows of a cross read that share one folded lane: as many as
    fill the kernel's group (whisper's MHA: 8), never more than C."""
    return max(1, min(_paged.MAX_GROUP // (H // K), C))


def _cross_fold(q, k_pages, v_pages, page_table, lengths,
                run=None) -> torch.Tensor:
    """The card's route of :func:`paged_cross_attention`: every row of a
    lane has the lane's length, so ``cross_rows`` of them share a folded
    lane (C padded with zero rows to a multiple). ``run`` stands in for the
    kernel (a test's plain twin on the CPU). On meta tensors, which have
    no lengths, the kernel records ``cross_cost`` over every position of
    the tables."""
    B, C, H, D = q.shape
    K = k_pages.shape[2]
    meta_cost = _paged.cross_cost(
        B, C, H, K, D, page_table.numel(),
        B * page_table.shape[1] * k_pages.shape[1]) if q.is_meta else None
    rows = cross_rows(C, H, K)
    pad = -C % rows
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    out = _fold(q, k_pages, v_pages, page_table,
                lengths[:, None].expand(B, (C + pad) // rows), rows=rows,
                run=run, meta_cost=meta_cost)
    return out[:, :C] if pad else out


def paged_cross_attention(
    q: torch.Tensor,           # (B, C, H, D) — C query rows a lane
    k_pages: torch.Tensor,     # (n_pages, P, K, D) — the encoder region pool
    v_pages: torch.Tensor,     # (n_pages, P, K, D)
    page_table: torch.Tensor,  # (B, max_cross_pages) int32
    lengths: torch.Tensor,     # (B,) int32 — valid encoder positions
) -> torch.Tensor:
    """Non-causal attention of a query block over a paged cross-attention
    (encoder-output) region, keys masked at ``lengths``. On the card the C
    query rows fold into the paged decode kernel (``_cross_fold``), and
    count there: ``cross_rows`` rows a folded lane as the rows of its kv
    heads' groups, so each region segment is read once for that many rows
    rather than once a row, as the TPU path's one row a lane does
    (``repro/kernels/ops.py:323-349``). At C = 1 the lanes go as they
    are."""
    _refuse_dtensor("paged_cross_attention", q, k_pages, v_pages,
                    page_table, lengths)
    if _plain(q, "paged_decode_attention"):
        return ref.paged_cross_attention(q, k_pages, v_pages, page_table,
                                         lengths)
    return _cross_fold(q, k_pages, v_pages, page_table, lengths)


def gemm_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)``, bf16 with f32 sums, each row's bits
    independent of the other rows of the call (the paged decode step's
    product). On DTensors (:func:`_gemm_rows_shards`) a ``w`` sharded on N
    gives an output sharded on its last dim, one sharded on K a partial
    sum."""
    if _dtensor(x, w):
        return _gemm_rows_shards(x, w)
    if _plain(x, "gemm_rows"):
        return ref.gemm_rows(x, w)
    return _gemm.gemm_rows(x, w)


def _gemm_rows_shards(x, w) -> DTensor:
    """``gemm_rows`` on DTensors, per mesh dim: column-parallel where ``w``
    shards N (``x`` whole on K, the output ``Shard(-1)``), row-parallel
    where it shards K (``x`` sharded on K, the output ``Partial()``), and
    where ``w`` is replicated the rows of ``x`` shard as they are."""
    mesh, x, w = _lift(x, w)
    last = x.ndim - 1
    px, pw, po = [], [], []
    for a, b in zip(_whole(x, -1), w.placements):
        if isinstance(b, Shard) and b.dim == 1:
            px.append(Replicate())
            pw.append(b)
            po.append(Shard(last))
        elif isinstance(b, Shard):
            px.append(Shard(last))
            pw.append(b)
            po.append(Partial())
        else:
            px.append(a)
            pw.append(Replicate())
            po.append(a)
    return local_map(gemm_rows, out_placements=po, in_placements=(px, pw),
                     device_mesh=mesh, redistribute_inputs=True)(x, w)


def gemm_rows_grouped(buf: torch.Tensor, w: torch.Tensor,
                      counts: torch.Tensor | None = None) -> torch.Tensor:
    """``buf (E, C, K) @ w (E, K, N)``, bf16 with f32 sums, each (expert,
    row)'s bits independent of C, of its rank and of the other experts (the
    MoE paged decode step's routed experts). On the card, rows of expert e
    at or past ``counts[e]`` are left unwritten; the plain version computes
    every row."""
    _refuse_dtensor("gemm_rows_grouped", buf, w, counts)
    if _plain(buf, "gemm_rows_grouped"):
        return ref.gemm_rows_grouped(buf, w)
    return _gemm.gemm_rows_grouped(buf, w, counts)


def moe_route(x: torch.Tensor, router: torch.Tensor, k: int, *,
              with_probs: bool = False):
    """``x (T, d)`` bf16 through the f32 ``router (d, E)``: ``weights (T,
    k)`` f32 and ``ids (T, k)`` int32 of each token's top-k experts, a
    token's result independent of the others; with ``with_probs`` also the
    softmax ``probs (T, E)`` f32 (training's aux loss)."""
    _refuse_dtensor("moe_route", x, router)
    grad = _needs_grad(x, router)
    if _plain(x, "moe_route"):
        if grad:
            plain_calls["moe_route_bwd"] += 1
        return ref.moe_route(x, router, k, with_probs=with_probs)
    if grad:
        _note_grad(x, "moe_route_bwd")
        weights, ids, probs = _route.MoeRoute.apply(x, router, k)
        return (weights, ids, probs) if with_probs else (weights, ids)
    return _route.moe_route(x, router, k, with_probs=with_probs)


def selective_scan(
    x: torch.Tensor,    # (B, S, Di)
    dt: torch.Tensor,   # (B, S, Di)
    A: torch.Tensor,    # (Di, N) f32
    Bm: torch.Tensor,   # (B, S, N)
    C: torch.Tensor,    # (B, S, N)
    D: torch.Tensor,    # (Di,) f32
    h0: torch.Tensor | None = None,  # (B, Di, N) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba1 scan, f32 inside whatever the model's ``ssm_dtype`` (the TPU
    kernel ignores it too, ``repro/kernels/ops.py:423-429``)."""
    _refuse_dtensor("selective_scan", x, dt, A, Bm, C, D, h0)
    grad = _needs_grad(x, dt, A, Bm, C, D, h0)
    if _plain(x, "selective_scan"):
        if grad:
            plain_calls["selective_scan_bwd"] += 1
        return ref.selective_scan(x, dt, A, Bm, C, D, h0)
    if grad:
        _note_grad(x, "selective_scan_bwd")
        return _scan.SelectiveScan.apply(x, dt, A, Bm, C, D, h0)
    return _scan.selective_scan(x, dt, A, Bm, C, D, h0)


def ssd(
    x: torch.Tensor,    # (B, S, Hs, P)
    dt: torch.Tensor,   # (B, S, Hs)
    A: torch.Tensor,    # (Hs,) f32
    Bm: torch.Tensor,   # (B, S, N)
    C: torch.Tensor,    # (B, S, N)
    D: torch.Tensor,    # (Hs,) f32
    h0: torch.Tensor | None = None,  # (B, Hs, P, N) f32
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    _refuse_dtensor("ssd", x, dt, A, Bm, C, D, h0)
    grad = _needs_grad(x, dt, A, Bm, C, D, h0)
    if _plain(x, "ssd"):
        if grad:
            plain_calls["ssd_bwd"] += 1
        return ref.ssd(x, dt, A, Bm, C, D, h0, chunk=chunk)
    if grad:
        _note_grad(x, "ssd_bwd")
        return _ssd.SSD.apply(x, dt, A, Bm, C, D, h0, chunk)
    return _ssd.ssd(x, dt, A, Bm, C, D, h0, chunk=chunk)


# no TPU kernel behind these: plain code on every device
causal_conv1d = ref.causal_conv1d
selective_scan_step = ref.selective_scan_step
ssd_step = ref.ssd_step
