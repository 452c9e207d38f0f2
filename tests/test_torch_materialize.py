"""The port's materialized elastic cell: params and the paged pool laid out
as DTensors on a real ``(data, model)`` ``DeviceMesh``, decode running the
port's kernels (here their plain versions: every rank is a CPU process) on
each rank's shards, against the JAX package on the same grids. Every case
runs on the reference's weights (REDUCED qwen3-8b's
``init(jax.random.key(0))``, handed across by the bridge).

- the placements (``to_placements``, ``tree_shardings``,
  ``paged_cache_shardings``, ``cache_shardings``) of every leaf of every
  REDUCED family's params and caches on the (4, 2), (2, 2), (1, 2),
  (2, 1) and (2, 2, 2) grids are the rules' specs (``spec_for_axes``),
  dim for dim; pure Python, no processes;
- on 8 gloo ranks: REDUCED qwen3-8b's params resharded onto (4, 2),
  gathered back bit for bit, then onto the (2, 2) that
  ``plan_elastic_mesh(4, model_parallel=2)`` picks, bit for bit again, each
  rank holding exactly its block; ``make_elastic_mesh`` raises the
  reference's two errors with its messages;
- one prefill chunk a lane and 4 teacher-forced paged decode steps, the
  same tokens, tables and positions through the port on 4 gloo ranks and
  through the reference's jitted ``prefill_chunk`` / ``decode_paged`` on 4
  forced host devices (a subprocess run beside the ranks), each unsharded,
  on (2, 2) and on (1, 4), where the 2 kv heads do not divide the model
  axis (the pool shards its pages and the k and v products their rows,
  the rules' fallbacks). Unsharded, the port's logits are within
  ``tests/test_torch_model.py``'s tolerance (atol 5e-2, rtol 2e-2) of the
  reference's. Sharded, neither side is bitwise its own single device: a
  row-parallel product rounds each rank's partial sum to bf16 before the
  reduction adds them, which GSPMD does as the port does. The reference's
  own departure (``d_ref``, its sharded logits against its unsharded ones;
  measured 0.042 on (2, 2) and 0.090 on (1, 4)) is the sharding's share,
  so on each grid the port's logits are held to the reference's at that
  tolerance with ``d_ref`` added to its atol, and the port's own
  departure to ``d_ref`` plus two bf16 ulps of the largest logit (the
  port rounds its logits to bf16 in both runs, the reference keeps f32;
  measured 0.051 and 0.086); on (2, 2) the port stays within that
  tolerance of its own unsharded run too. On (1, 4) the page-sharded pool
  gives the bits of the same mesh's run with the pool whole. Every kernel
  entry of the path ran through its DTensor branch; every other entry
  refuses a DTensor;
- on 8 gloo ranks, ``tests/test_cell.py``'s materialized scenario
  (``MATERIALIZE_SCRIPT``: 4 hosts of 2 devices, (4, 2), host h1 crashes,
  (2, 2)) on the port: 2 requests done, grid [2, 2], lens [8, 8], and
  ``resharded``, ``tokens_replayed`` and ``forced_tokens`` equal to the
  reference's own materialized run (a subprocess on 8 forced host
  devices); every rank's committed streams are rank 0's, and equal both
  the port's layout-only cell's and the reference's materialized ones;
  each engine a re-shard dropped holds neither weights nor pool, though
  the test keeps it;
- a snapshot of an engine laid out on (2, 2) has the bytes of the
  unsharded engine's for the same state, and a blob restores into either
  layout with its bytes unchanged, both then finishing their streams.

Each multi-process group runs in one subprocess that spawns its ranks
(``file://`` rendezvous under ``tmp_path``, no fixed port), joins them
under its own deadline, reads every rank's exit code and prints one JSON
line: a gloo collective that fails can abort every rank instead of
raising. The reference's weights and the decode inputs reach the ranks
as ``.npz`` files.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_cell  # noqa: E402
from repro_torch.checkpoint.elastic import make_elastic_mesh  # noqa: E402
from repro_torch.configs import REDUCED  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.model_api import tree_leaves  # noqa: E402
from repro_torch.parallel.partition import (  # noqa: E402
    LayoutGrid,
    spec_for_axes,
    to_placements,
    tree_partition_specs,
    tree_shardings,
)
from repro_torch.serving.kvcache import (  # noqa: E402
    cache_shardings,
    paged_cache_shardings,
)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TOL = dict(atol=5e-2, rtol=2e-2)          # tests/test_torch_model.py's
GRIDS = {"4x2": (("data", "model"), (4, 2)),
         "2x2": (("data", "model"), (2, 2)),
         "1x2": (("data", "model"), (1, 2)),
         "2x1": (("data", "model"), (2, 1)),
         "2x2x2": (("pod", "data", "model"), (2, 2, 2))}
CELL_ENGINE = dict(n_slots=2, max_seq=64, page_size=8, n_pages=48)
# (c): two lanes, a prompt of 12 tokens each in pages 1-4 and 5-8, then
# 4 teacher-forced decode steps
DECODE = dict(n_pages=16, page_size=8, prompt=12, steps=4)
# a rank group's deadline, below pytest-timeout's 300 s
GROUP_TIMEOUT_S = 150

# One rank group: ``python ranks.py GROUP WORLD RDV OUT`` spawns WORLD
# ranks of a gloo group, each running GROUP's cases in order and writing
# its JSON to OUT; the parent prints every rank's result and exit code.
RANKS = r'''
import json, os, sys, time, traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = float(os.environ["GROUP_TIMEOUT_S"])
CELL_ENGINE = json.loads(os.environ["CELL_ENGINE"])


def bits(t):
    return t.detach().contiguous().view(torch.uint8)


def qwen():
    """REDUCED qwen3-8b on the reference's weights (``REF_WEIGHTS``, one
    leaf a key of its nested names joined by "/")."""
    from repro_torch.bridge import params_from_reference
    from repro_torch.configs import REDUCED
    from repro_torch.models import get_model
    model = get_model(REDUCED["qwen3-8b"])
    leaves, tree = np.load(os.environ["REF_WEIGHTS"]), {}
    for key in leaves.files:
        *path, name = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = leaves[key]
    return model, params_from_reference(tree, model, device="cpu")


def case_reshard(rank, world):
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.elastic import (
        gather_state, local_chunk, make_elastic_mesh, plan_elastic_mesh,
        reshard_state)
    from repro_torch.models.model_api import tree_leaves
    from repro_torch.parallel.partition import tree_map2, tree_shardings

    model, params = qwen()
    axes = model.param_axes()
    first = gather_state(model.param_tree(params))
    host, out = first, []
    for grid in [(4, 2), plan_elastic_mesh(4, model_parallel=2)]:
        mesh = make_elastic_mesh(range(world), *grid)
        state = reshard_state(host, axes, mesh)
        sh = tree_shardings(axes, host, mesh)
        member = mesh.get_coordinate() is not None
        blocks = tree_leaves(tree_map2(
            lambda d, pair: (isinstance(d, DTensor)
                             and tuple(d.placements) == pair[1].placements
                             and torch.equal(bits(d.to_local()), bits(
                                 local_chunk(pair[0], mesh,
                                             pair[1].placements)))),
            state, tree_map2(lambda h, s: (h, s), host, sh)))
        rec = {"grid": list(grid), "member": member,
               "blocks_ok": all(blocks),
               "sharded_leaves": sum(any(p.is_shard() for p in s.placements)
                                     for s in tree_leaves(sh))}
        if member:
            back = gather_state(state)
            rec["bitwise"] = all(tree_leaves(tree_map2(
                lambda a, b: torch.equal(bits(a), bits(b)), back, first)))
            host = back
        out.append(rec)
    return {"reshard": out}


def case_decode(rank, world):
    """``DECODE_INPUTS`` through the port: unsharded, on (2, 2), and on
    (1, 4), where the 2 kv heads do not divide the model axis and the pool
    shards its pages (the rules' fallback)."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.checkpoint.elastic import (
        gather_state, make_elastic_mesh, place, reshard_state)
    from repro_torch.kernels import ops
    from repro_torch.parallel.partition import on_mesh
    from repro_torch.serving.kvcache import paged_cache_shardings

    model, params = qwen()
    io = np.load(os.environ["DECODE_INPUTS"])
    prompts, forced, table = (torch.from_numpy(io[k])
                              for k in ("prompts", "forced", "table"))
    n_slots = len(prompts)
    n_pages, P = int(io["n_pages"]), int(io["page_size"])
    host = gather_state(model.param_tree(params))

    def run(ps, mesh, whole_pool=False):
        prefill, decode = model.prefill_chunk, model.decode_paged
        cache = model.init_paged_cache(n_slots, n_pages, P, device="cpu")
        if mesh is not None:
            sh = paged_cache_shardings(model, n_slots, n_pages, P, mesh)
            cache = {k: place(v, mesh, [Replicate()] * mesh.ndim
                              if whole_pool else sh[k].placements)
                     for k, v in cache.items()}
            prefill, decode = on_mesh(prefill, mesh), on_mesh(decode, mesh)
        logits = [prefill(ps, cache, {
            "tokens": prompts[slot:slot + 1], "valid": prompts.shape[1],
            "slot": slot, "page_table": table[slot]}, offset=0)[0]
            for slot in range(n_slots)]
        for s in range(forced.shape[1]):
            logits.extend(decode(ps, cache, {
                "tokens": forced[:, s:s + 1].contiguous(),
                "positions": torch.full((n_slots,), prompts.shape[1] + s,
                                        dtype=torch.int32),
                "page_table": table}))
        pool = cache["k_pages"]
        return [lg.float().tolist() for lg in logits], (
            [repr(p) for p in pool.placements]
            if isinstance(pool, DTensor) else None)

    out = {"plain": run(params, None)[0] if rank == 0 else None}
    for grid in [(2, 2), (1, 4)]:
        mesh = make_elastic_mesh(range(world), *grid)
        sharded = model.assemble(reshard_state(host, model.param_axes(),
                                               mesh))
        ops.reset_counts()
        got, pool_placements = run(sharded, mesh)
        out["%dx%d" % grid] = {
            "logits": got if rank == 0 else None,
            "pool_placements": pool_placements,
            "counts": {k: v for k, v in ops.counts().items() if v["plain"]},
            "params_dtensor": all(isinstance(p, DTensor)
                                  for p in sharded.parameters())}
    # the pages fallback against the same mesh with the pool whole: the
    # same arithmetic, so the same bits
    whole, _ = run(sharded, mesh, whole_pool=True)
    out["1x4"]["bitwise_whole_pool"] = whole == out["1x4"]["logits"] \
        if rank == 0 else None
    return out


def case_snapshot(rank, world):
    """Snapshot bytes across layouts: A unsharded, B and D laid out on (2,
    2), C unsharded."""
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.elastic import (
        gather_state, make_elastic_mesh, reshard_state)
    from repro_torch.parallel.partition import activation_sharding
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.kvcache import paged_cache_shardings

    model, params = qwen()
    mesh = make_elastic_mesh(range(world), 2, 2)
    kw = dict(CELL_ENGINE, device="cpu")
    host = gather_state(model.param_tree(params))

    def laid_out():
        eng = ServeEngine(model, params, **kw)
        eng.params = model.assemble(reshard_state(host, model.param_axes(),
                                                  mesh))
        eng.lay_out(mesh)
        return eng

    rng = np.random.default_rng(3)
    a = ServeEngine(model, params, **kw)
    for _ in range(2):
        a.submit(rng.integers(1, model.cfg.vocab_size, 11).tolist(),
                 max_new_tokens=8)
    for _ in range(3):
        a.step()
    blob_a = a.snapshot()
    b = laid_out()
    b.restore(blob_a)
    sh = paged_cache_shardings(model, b.n_slots, b.n_pages, b.page_size,
                               mesh)
    placed = all(isinstance(v, DTensor)
                 and tuple(v.placements) == sh[k].placements
                 for k, v in b.cache.items())
    same_a = b.snapshot() == blob_a
    with activation_sharding(mesh):
        for _ in range(2):
            b.step()
        blob_b = b.snapshot()
    c = ServeEngine(model, params, **kw)
    c.restore(blob_b)
    d = laid_out()
    d.restore(blob_b)
    same_c, same_d = c.snapshot() == blob_b, d.snapshot() == blob_b
    c.run(100)
    with activation_sharding(mesh):
        d.run(100)
    return {"placed": placed, "a_into_2x2": same_a, "b_into_plain": same_c,
            "b_into_2x2": same_d,
            "done": [all(r.done for r in e.requests.values()) for e in (c, d)],
            "tokens": [[r.generated for r in e.requests.values()]
                       for e in (c, d)]}


def case_cell(rank, world):
    """tests/test_cell.py's MATERIALIZE_SCRIPT on the port."""
    from repro_torch.core.faults import FaultEvent, FaultPlan
    from repro_torch.core.server import AdHocServer
    from repro_torch.core.simulation import SimClock
    from repro_torch.serving.batch import make_engine_factory
    from repro_torch.serving.cell import ElasticServeCell

    model, params = qwen()
    cfg = model.cfg
    srv = AdHocServer(failure_timeout=6.0)
    srv.create_cloudlet("cell", cfg.arch_id)
    for h in [f"h{i}" for i in range(4)]:
        srv.register_host(h, 0.0, cloudlets=["cell"])
    # the cell's own factory, each engine it builds kept here: a dropped
    # engine must hold neither weights nor pool, whatever keeps it
    factory = make_engine_factory(model, params, **CELL_ENGINE, device="cpu")
    built = []

    def keeping(host):
        built.append(factory(host))
        return built[-1]

    cell = ElasticServeCell(
        srv, "cell", model, params, factory=keeping,
        model_parallel=2, devices_per_host=2, target_hosts=4, min_hosts=1,
        slots_per_host=1, decode_step_s=1.0, step_deadline_s=4.0,
        snapshot_every_s=3.0, materialize=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, 8).tolist() for _ in range(2)]
    reqs = [cell.submit(p, max_new_tokens=8) for p in prompts]
    plan = FaultPlan([FaultEvent(at=6.0, kind="crash", host="h1")])
    s = cell.run(SimClock(), fault_plan=plan, max_ticks=500)
    grids = [kv["grid"] for _, ev, kv in srv.log if ev == "cell_resharded"]
    return {"done": s["requests_done"], "grid": list(s["grid"]),
            "grids": grids, "resharded": s["resharded"],
            "replayed": s["tokens_replayed"], "forced": s["forced_tokens"],
            "mismatches": s["forced_mismatches"],
            "lens": [len(r.committed) for r in reqs],
            "streams": [r.committed for r in reqs], "prompts": prompts,
            "member": cell.mesh.get_coordinate() is not None,
            "dropped_engines_hold": [e.params is not None
                                     or e.cache is not None
                                     for e in built if e is not cell.engine]}


GROUPS = {"four": (case_decode, case_snapshot),
          "eight": (case_reshard, case_cell)}


def rank_main(group, rank, world, rdv, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)
    res = {}
    try:
        for case in GROUPS[group]:
            res[case.__name__] = case(rank, world)
    except Exception:
        res["error"] = traceback.format_exc()
    with open(os.path.join(out, f"{rank}.json"), "w") as f:
        json.dump(res, f)
    if "error" not in res:
        dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    group, world, rdv, out = sys.argv[1], int(sys.argv[2]), *sys.argv[3:5]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(group, r, world, rdv, out))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    ranks = []
    for r in range(world):
        path = os.path.join(out, f"{r}.json")
        ranks.append(json.load(open(path)) if os.path.exists(path) else None)
    print(json.dumps({"exitcodes": [p.exitcode for p in procs],
                      "ranks": ranks}))
'''


def _group(tmp_path_factory, group: str, world: int,
           shared: dict) -> list[dict]:
    """Run one rank group; every rank's result, each having exited 0."""
    tmp = tmp_path_factory.mktemp(f"ranks_{group}")
    script = tmp / "ranks.py"
    script.write_text(RANKS)
    out = tmp / "out"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=SRC,
               GROUP_TIMEOUT_S=str(GROUP_TIMEOUT_S),
               CELL_ENGINE=json.dumps(CELL_ENGINE), OMP_NUM_THREADS="1",
               **shared)
    proc = subprocess.run(
        [sys.executable, str(script), group, str(world), str(tmp / "rdv"),
         str(out)], capture_output=True, text=True, env=env,
        timeout=GROUP_TIMEOUT_S + 60)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    errors = [r.get("error") for r in rec["ranks"] if r and "error" in r]
    assert rec["exitcodes"] == [0] * world and not errors, (
        rec["exitcodes"], errors[:1], proc.stderr[-3000:])
    return rec["ranks"]


def _leaves(tree: dict, prefix: str = "") -> dict:
    """A nested tree's numpy leaves by their names joined with "/"."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def shared(tmp_path_factory) -> dict:
    """The files every rank reads: the reference's weights (REDUCED
    qwen3-8b's ``init(jax.random.key(0))``) and (c)'s inputs, tokens drawn
    from a seed."""
    jax = pytest.importorskip("jax")
    from repro.configs import REDUCED as REF_REDUCED
    from repro.models import get_model as ref_get_model

    tmp = tmp_path_factory.mktemp("shared")
    ref = ref_get_model(REF_REDUCED["qwen3-8b"])
    np.savez(tmp / "weights.npz", **_leaves(ref.init(jax.random.key(0))))
    rng = np.random.default_rng(5)
    V, n = REDUCED["qwen3-8b"].vocab_size, 2
    table = np.zeros((n, 8), np.int32)
    table[:, :4] = np.arange(1, 9).reshape(n, 4)
    np.savez(tmp / "inputs.npz", table=table,
             prompts=rng.integers(1, V, (n, DECODE["prompt"]), np.int32),
             forced=rng.integers(1, V, (n, DECODE["steps"]), np.int32),
             n_pages=DECODE["n_pages"], page_size=DECODE["page_size"])
    return {"REF_WEIGHTS": str(tmp / "weights.npz"),
            "DECODE_INPUTS": str(tmp / "inputs.npz")}


def _ref_params(model, shared: dict):
    """The reference's weights as the port's module for ``model``."""
    from repro_torch.bridge import params_from_reference

    leaves, tree = np.load(shared["REF_WEIGHTS"]), {}
    for key in leaves.files:
        *path, name = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = leaves[key]
    return params_from_reference(tree, model, device="cpu")


# The reference's side of (c): ``python -c REFERENCE_DECODE INPUTS OUT`` on
# 4 forced host devices writes the logits of each run to OUT
REFERENCE_DECODE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
import jax.numpy as jnp

from repro.checkpoint.elastic import make_elastic_mesh, reshard_state
from repro.configs import REDUCED
from repro.models import get_model
from repro.parallel.partition import activation_sharding
from repro.serving.kvcache import paged_cache_shardings

io = np.load(sys.argv[1])
prompts, forced, table = io["prompts"], io["forced"], io["table"]
n_slots, n_pages, P = len(prompts), int(io["n_pages"]), int(io["page_size"])
model = get_model(REDUCED["qwen3-8b"])
params = model.init(jax.random.key(0))


def run(mesh):
    # as the reference's cell does at each re-shard: a traced step keeps
    # the sharding constraints of the mesh it was traced under
    jax.clear_caches()
    ps, cache = params, model.init_paged_cache(n_slots, n_pages, P)
    if mesh is not None:
        ps = reshard_state(jax.tree.map(np.asarray, params),
                           model.param_axes(), mesh)
        cache = jax.device_put(cache, paged_cache_shardings(
            model, n_slots, n_pages, P, mesh))
    logits = []
    with activation_sharding(mesh):
        prefill = jax.jit(model.prefill_chunk, static_argnames=("offset",))
        decode = jax.jit(model.decode_paged)
        for slot in range(n_slots):
            lg, cache = prefill(ps, cache, {
                "tokens": jnp.asarray(prompts[slot:slot + 1]),
                "valid": jnp.asarray(prompts.shape[1]),
                "slot": jnp.asarray(slot),
                "page_table": jnp.asarray(table[slot])}, offset=0)
            logits.append(np.asarray(lg, np.float32)[0])
        for s in range(forced.shape[1]):
            lg, cache = decode(ps, cache, {
                "tokens": jnp.asarray(forced[:, s:s + 1]),
                "positions": jnp.full((n_slots,), prompts.shape[1] + s,
                                      jnp.int32),
                "page_table": jnp.asarray(table)})
            logits.extend(np.asarray(lg, np.float32))
    return np.stack(logits)


np.savez(sys.argv[2], plain=run(None), **{
    "%dx%d" % g: run(make_elastic_mesh(jax.devices(), *g))
    for g in [(2, 2), (1, 4)]})
'''


@pytest.fixture(scope="module")
def four(tmp_path_factory, shared):
    """The 4-rank group's results, and the reference's logits of (c) from
    its subprocess, run beside the group."""
    out = tmp_path_factory.mktemp("reference_decode") / "logits.npz"
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_DECODE, shared["DECODE_INPUTS"],
         str(out)], env=dict(os.environ, PYTHONPATH=SRC),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = _group(tmp_path_factory, "four", 4, shared)
        _, err = ref.communicate(timeout=GROUP_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    return ranks, dict(np.load(out))


@pytest.fixture(scope="module")
def eight(tmp_path_factory, shared):
    """The 8-rank group's results, and the JAX package's materialized cell
    on 8 forced host devices (the script of tests/test_cell.py, run as that
    file runs it, then its committed streams printed), run beside the
    group: its counters, and its streams under ``"streams"``."""
    ref = subprocess.Popen(
        [sys.executable, "-c", test_cell.MATERIALIZE_SCRIPT
         + "print(json.dumps([r.committed for r in reqs]))\n"],
        env=dict(os.environ, PYTHONPATH=SRC), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = _group(tmp_path_factory, "eight", 8, shared)
        out, err = ref.communicate(timeout=GROUP_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    counters, streams = out.strip().splitlines()[-2:]
    return ranks, {**json.loads(counters), "streams": json.loads(streams)}


# ---------------------------------------------------------------------------
# (a) placements against the rules, no processes
# ---------------------------------------------------------------------------


def _inverse(placements, names, ndim) -> tuple:
    """The spec a placement tuple stands for: each dim's mesh axes, in
    mesh order (a tuple where more than one)."""
    entries = []
    for i in range(ndim):
        on = tuple(n for n, p in zip(names, placements)
                   if p.is_shard() and p.dim == i)
        entries.append(None if not on else on[0] if len(on) == 1 else on)
    return tuple(entries)


def _without_unit_axes(spec, shape: dict) -> tuple:
    """``spec`` with the axes of size 1 dropped: a shard over one device
    is the whole dim, which ``to_placements`` replicates."""
    entries = []
    for e in spec:
        on = tuple(a for a in (e if isinstance(e, tuple) else (e,))
                   if a is not None and shape[a] > 1)
        entries.append(None if not on else on[0] if len(on) == 1 else on)
    return tuple(entries)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch", sorted(REDUCED))
def test_placements_are_the_rules_specs(arch, grid):
    names, sizes = GRIDS[grid]
    mesh = LayoutGrid(names, sizes)
    model = get_model(REDUCED[arch])
    trees = [(model.param_axes(), model.abstract_params())]
    if model.supports_paged:
        trees.append((model.paged_cache_axes(2, 9, 8),
                      model.abstract_paged_cache(2, 9, 8)))
    n = 0
    for axes, vals in trees:
        specs = tree_partition_specs(axes, vals, mesh)
        shardings = tree_shardings(axes, vals, mesh)
        for spec, s, v, ax in zip(tree_leaves(specs), tree_leaves(shardings),
                                  tree_leaves(vals), tree_leaves(axes)):
            assert spec == spec_for_axes(ax, tuple(v.shape), mesh)
            assert s.mesh is mesh
            assert s.placements == to_placements(spec, mesh)
            assert len(s.placements) == len(names)
            assert _inverse(s.placements, names, v.ndim) == \
                _without_unit_axes(spec, mesh.shape)
            for p in s.placements:
                if p.is_shard():
                    size = v.shape[p.dim]
                    on = [sz for nm, sz, q in zip(names, sizes, s.placements)
                          if q == p]
                    assert size % int(np.prod(on)) == 0
            n += 1
    if model.supports_paged:
        sh = paged_cache_shardings(model, 2, 9, 8, mesh)
        assert all(sh[k].placements == to_placements(spec, mesh)
                   for k, spec in tree_partition_specs(
                       model.paged_cache_axes(2, 9, 8),
                       model.abstract_paged_cache(2, 9, 8), mesh).items())
    sh = cache_shardings(model, 4, 16, mesh)
    assert all(sh[k].placements == to_placements(spec, mesh)
               for k, spec in tree_partition_specs(
                   model.cache_axes(4, 16), model.abstract_cache(4, 16),
                   mesh).items())
    assert n > 0


def test_pod_axes_shard_one_dim_in_mesh_order():
    names = ("pod", "data", "model")
    mesh = LayoutGrid(names, (2, 2, 2))
    got = to_placements(spec_for_axes(("batch", "heads"), (8, 4), mesh),
                        mesh)
    assert [repr(p) for p in got] == ["Shard(dim=0)", "Shard(dim=0)",
                                      "Shard(dim=1)"]


def test_make_elastic_mesh_raises_the_references_errors():
    jax = pytest.importorskip("jax")
    import repro.checkpoint.elastic as ref

    devs = jax.devices()
    for grid in [(0, 2), (len(devs) + 1, 2)]:
        with pytest.raises(ValueError) as want:
            ref.make_elastic_mesh(devs, *grid)
        with pytest.raises(ValueError) as got:
            make_elastic_mesh(range(len(devs)), *grid)
        assert str(got.value) == str(want.value)


def test_other_kernel_entries_refuse_dtensors():
    """Outside the sharded slice, a DTensor raises one error naming the
    next one (no silent gather), before any process group is asked for."""
    from torch.distributed.tensor import DTensor

    class Fake(DTensor):      # an instance check is all the entries make
        def __new__(cls):
            return torch.Tensor._make_subclass(cls, torch.zeros(1))

    d = Fake()
    z = torch.zeros(1)
    for name, call in {
            "decode_attention": lambda: ops.decode_attention(d, z, z, z),
            "paged_verify_attention": lambda: ops.paged_verify_attention(
                d, z, z, z, z),
            "paged_cross_attention": lambda: ops.paged_cross_attention(
                d, z, z, z, z),
            "selective_scan": lambda: ops.selective_scan(d, z, z, z, z, z),
            "ssd": lambda: ops.ssd(d, z, z, z, z, z),
            "moe_route": lambda: ops.moe_route(d, z, 2),
            "gemm_rows_grouped": lambda: ops.gemm_rows_grouped(d, z)}.items():
        with pytest.raises(NotImplementedError, match="item 16b") as err:
            call()
        assert name in str(err.value)


# ---------------------------------------------------------------------------
# (b) reshard and gather across (4, 2) -> (2, 2), 8 ranks
# ---------------------------------------------------------------------------


def test_reshard_gather_is_bitwise_across_grids(eight):
    for rank, res in enumerate(eight[0]):
        steps = res["case_reshard"]["reshard"]
        assert [s["grid"] for s in steps] == [[4, 2], [2, 2]]
        for s in steps:
            assert s["blocks_ok"], (rank, s)
            assert s["sharded_leaves"] > 0
            assert s["member"] == (rank < s["grid"][0] * s["grid"][1])
            if s["member"]:
                assert s["bitwise"], (rank, s)


# ---------------------------------------------------------------------------
# (c) prefill and decode against the reference's, unsharded and on (2, 2)
#     and (1, 4), 4 ranks beside 4 forced host devices
# ---------------------------------------------------------------------------


# the pool (L, pages, P, K, dh) on (2, 2): its kv heads over "model",
# replicated over "data"; on (1, 4) the 2 kv heads do not divide the model
# axis, and its pages take it
POOL_PLACEMENTS = {"2x2": ["Replicate()", "Shard(dim=3)"],
                   "1x4": ["Replicate()", "Shard(dim=1)"]}
N_LOGITS = 2 + 2 * DECODE["steps"]     # a chunk a lane, then 2 a step


def test_unsharded_decode_matches_the_references(four):
    ranks, ref = four
    got = np.asarray(ranks[0]["case_decode"]["plain"])
    assert got.shape == ref["plain"].shape == (N_LOGITS, 512)
    np.testing.assert_allclose(got, ref["plain"], **TOL)


@pytest.mark.parametrize("grid", list(POOL_PLACEMENTS))
def test_sharded_decode_logits_within_bf16_tolerance(four, grid):
    """The port's logits on ``grid`` against the reference's on the same
    grid, at the one-device tolerance with the reference's own departure
    from its one device (``d_ref``) added to its atol; the port's own
    departure within ``d_ref`` and two bf16 ulps of the largest logit;
    on (2, 2) also within the one-device tolerance of its own unsharded
    run."""
    ranks, ref = four
    dec = ranks[0]["case_decode"]
    plain, got = np.asarray(dec["plain"]), np.asarray(dec[grid]["logits"])
    assert got.shape == ref[grid].shape == (N_LOGITS, 512)
    d_ref = float(np.abs(ref[grid] - ref["plain"]).max())
    d_port = float(np.abs(got - plain).max())
    ulp = 2.0 ** (np.floor(np.log2(np.abs(plain).max())) - 7)
    print(grid, "largest departure from one device: port", d_port,
          "reference", d_ref, "; port against reference",
          float(np.abs(got - ref[grid]).max()))
    np.testing.assert_allclose(got, ref[grid], atol=TOL["atol"] + d_ref,
                               rtol=TOL["rtol"])
    assert d_port <= d_ref + 2 * ulp, (d_port, d_ref, ulp)
    if grid == "2x2":
        # two-way partials: within the one-device tolerance of the port's
        # own unsharded run as well
        np.testing.assert_allclose(got, plain, **TOL)
    else:
        assert dec[grid]["bitwise_whole_pool"]
    for rank, r in enumerate(ranks):
        dec = r["case_decode"][grid]
        assert dec["params_dtensor"]
        assert dec["pool_placements"] == POOL_PLACEMENTS[grid]
        # each rank ran every kernel of the path on its shards: RMSNorm 9
        # a call, flash 2 a chunk, the paged decode 2 a step, gemm_rows 7 a
        # layer and the unembedding a step
        assert dec["counts"] == {
            "rmsnorm": {"launches": 0, "plain": 6 * 9},
            "flash_attention": {"launches": 0, "plain": 2 * 2},
            "paged_decode_attention": {"launches": 0, "plain": 4 * 2},
            "gemm_rows": {"launches": 0, "plain": 4 * 15}}, rank


# ---------------------------------------------------------------------------
# (d) the reference's materialized scenario on the port, 8 ranks
# ---------------------------------------------------------------------------


def _layout_only(prompts, shared) -> list[list[int]]:
    """The same scenario on the port's layout-only cell, in-process."""
    from repro_torch.core.faults import FaultEvent, FaultPlan
    from repro_torch.core.server import AdHocServer
    from repro_torch.core.simulation import SimClock
    from repro_torch.serving.cell import ElasticServeCell

    model = get_model(REDUCED["qwen3-8b"])
    params = _ref_params(model, shared)
    srv = AdHocServer(failure_timeout=6.0)
    srv.create_cloudlet("cell", "qwen3-8b")
    for i in range(4):
        srv.register_host(f"h{i}", 0.0, cloudlets=["cell"])
    cell = ElasticServeCell(
        srv, "cell", model, params,
        engine_kwargs=dict(CELL_ENGINE, device="cpu"), model_parallel=2,
        devices_per_host=2, target_hosts=4, min_hosts=1, slots_per_host=1,
        decode_step_s=1.0, step_deadline_s=4.0, snapshot_every_s=3.0)
    reqs = [cell.submit(p, max_new_tokens=8) for p in prompts]
    cell.run(SimClock(), fault_plan=FaultPlan(
        [FaultEvent(at=6.0, kind="crash", host="h1")]), max_ticks=500)
    return [r.committed for r in reqs]


def test_materialized_cell_matches_the_references(eight, shared):
    ranks, ref = eight
    runs = [r["case_cell"] for r in ranks]
    got = runs[0]
    assert got["done"] == 2
    assert got["grid"] == [2, 2]
    assert got["grids"] == [[4, 2], [2, 2]]      # formed, then shrunk
    assert got["resharded"] >= 1
    assert got["replayed"] >= 1
    assert got["forced"] >= 1
    assert got["lens"] == [8, 8]
    for key in ("done", "grid", "resharded", "replayed", "forced", "lens"):
        assert got[key] == ref[key], key
    # the engines the re-shards dropped let go of their weights and pools
    assert got["dropped_engines_hold"] and not any(
        got["dropped_engines_hold"])
    # ranks 4-7 were left out of the shrunk mesh and still commit rank 0's
    # streams
    assert [r["member"] for r in runs] == [True] * 4 + [False] * 4
    for r in runs[1:]:
        assert {k: v for k, v in r.items() if k != "member"} == \
            {k: v for k, v in got.items() if k != "member"}
    print("forced mismatches: port", got["mismatches"], "reference",
          ref["mismatches"])
    assert got["streams"] == _layout_only(got["prompts"], shared)
    assert got["streams"] == ref["streams"]


# ---------------------------------------------------------------------------
# (e) snapshot bytes across layouts, 4 ranks
# ---------------------------------------------------------------------------


def test_snapshot_bytes_do_not_depend_on_the_layout(four):
    ranks, _ = four
    for rank, r in enumerate(ranks):
        s = r["case_snapshot"]
        assert s["placed"], rank
        assert s["a_into_2x2"] and s["b_into_plain"] and s["b_into_2x2"], s
        assert s["done"] == [True, True], s
    # every rank restored the same blob and decoded rank 0's logits
    assert len({json.dumps(r["case_snapshot"]["tokens"])
                for r in ranks}) == 1
