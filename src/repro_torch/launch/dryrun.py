"""Dry-run of every (arch x shape x mesh) cell: the meta pass and the H100
roofline, with no card and nothing allocated.

The counterpart of ``repro/launch/dryrun.py``, whose 512 placeholder CPU
devices stand in for two pods and whose ``lower().compile()`` proves the
sharding. Here every cell's program (``launch/cells.py``) runs once on
meta tensors under the counter (``launch/counter.py``): product FLOPs and
each kernel's cost (``kernels/*.py::cost``), HBM bytes, the peak of live
bytes above the arguments (the reference's ``temp_size``) and each
kernel's calls and launches. The grid's partition rules give each
device's bytes of params, state and cache, and report a dim that does not
divide its axis. Per-device figures follow the reference's
ideal-partition convention (global / devices), and the terms are the
H100's (``launch/roofline.py``): a prediction from the meta pass and the
datasheet's peaks, not a measurement. ``collectives`` is null: the meta
pass counts no collectives yet (ROADMAP item 16b; the materialized cell's
sharded serving issues them through DTensor). It runs on the CPU and
needs no card.

Records land in ``artifacts/torch_dryrun/<arch>__<shape>__<mesh>.json``
(the reference's stay in ``artifacts/dryrun/``). The sweep is resumable:
a cell with a record is skipped unless ``--force``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both] [--force] [--out DIR]
        [--variant k=v,...]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time
import traceback

NO_COLLECTIVES = "no collective count until item 16b"


def parse_variant(spec: str | None) -> dict:
    """--variant "seq_parallel=true,remat_policy=dots" -> field dict."""
    if not spec:
        return {}
    out = {}
    for kv in spec.split(","):
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


RUN_FIELDS = {"grad_compression", "microbatches"}


def configs(arch_id: str, variant: str | None):
    """The cell's ``ModelConfig`` and ``RunConfig`` under ``variant``."""
    import dataclasses

    from repro_torch.config import RunConfig
    from repro_torch.configs import get

    fields = parse_variant(variant)
    cfg = dataclasses.replace(
        get(arch_id),
        **{k: v for k, v in fields.items() if k not in RUN_FIELDS})
    run = RunConfig(arch=arch_id,
                    **{k: v for k, v in fields.items() if k in RUN_FIELDS})
    return cfg, run


@functools.lru_cache(maxsize=4)
def _count(arch_id: str, shape_name: str, variant: str | None) -> tuple:
    """The meta pass of one cell (the same on every grid): its summary and
    seconds."""
    from repro_torch.config import SHAPES
    from repro_torch.launch.cells import build_cell, lower_cell
    from repro_torch.launch.mesh import make_host_mesh

    cfg, run = configs(arch_id, variant)
    t0 = time.time()
    prog = build_cell(cfg, SHAPES[shape_name], make_host_mesh(1, 1), run=run)
    out = lower_cell(prog)
    return prog.kind, out, time.time() - t0


def measure(arch_id: str, shape_name: str, mesh_kind: str,
            variant: str | None = None) -> dict:
    """The record's figures of a valid cell."""
    from repro_torch.config import SHAPES
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import devices, make_production_mesh
    from repro_torch.launch.roofline import model_flops_for, \
        terms_from_artifact

    cfg, run = configs(arch_id, variant)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    chips = devices(mesh)
    t0 = time.time()
    prog = build_cell(cfg, shape, mesh, run=run)
    layout_s = time.time() - t0
    kind, c, count_s = _count(arch_id, shape_name, variant)
    rec = {
        "kind": kind,
        "count_s": round(count_s, 3),
        "layout_s": round(layout_s, 3),
        "memory": {
            "argument_size": c["argument_bytes"],
            "temp_size": c["peak_bytes"],
            "temp_per_device": c["peak_bytes"] // chips,
            "per_device": prog.per_device_bytes,
        },
        "cost_global": {
            "flops": float(c["flops"]),
            "bytes_accessed": float(c["bytes"]),
            "transcendentals": float(sum(k["exps"]
                                         for k in c["kernels"].values())),
            "product_flops": c["product_flops"],
            "kernel_flops": c["kernel_flops"],
            "compute_s": c["compute_s"],
        },
        "kernels": c["kernels"],
        "indivisible": prog.indivisible,
        "collectives": None,
        "collectives_reason": NO_COLLECTIVES,
        "flops_global": float(c["flops"]),
        "bytes_global": float(c["bytes"]),
        "flops_per_device": float(c["flops"]) / chips,
        "bytes_per_device": float(c["bytes"]) / chips,
        "compute_s_per_device": c["compute_s"] / chips,
        "model_flops": model_flops_for(cfg, shape),
    }
    rec["roofline"] = terms_from_artifact(
        {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
         "chips": chips, **rec}, cfg, shape).to_dict()
    return rec


def run_cell(arch_id: str, shape_name: str, mesh_kind: str, out_dir: str,
             force: bool = False, variant: str | None = None) -> dict:
    from repro_torch.config import SHAPES, cell_is_valid
    from repro_torch.configs import ARCHS

    tag = f"{arch_id}__{shape_name}__{mesh_kind}"
    if variant:
        tag += "__" + variant.replace("=", "-").replace(",", "+")
    path = os.path.join(out_dir, tag.replace("/", "_") + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    cfg, _ = configs(arch_id, variant)
    ok, why = cell_is_valid(cfg, SHAPES[shape_name])
    rec: dict = {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": mesh_kind,
        "variant": variant or "baseline",
        "chips": 512 if mesh_kind == "multi" else 256,
    }
    if not ok:
        rec.update(status="skipped", reason=why)
    else:
        try:
            rec.update(status="ok", **measure(arch_id, shape_name, mesh_kind,
                                              variant))
            if rec["indivisible"]:
                rec.update(status="error",
                           error="indivisible: " + "; ".join(
                               rec["indivisible"][:4]))
        except Exception as e:
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       trace=traceback.format_exc()[-4000:])
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="artifacts/torch_dryrun")
    ap.add_argument("--variant", default=None,
                    help="comma-separated ModelConfig/RunConfig overrides, "
                         "e.g. remat_policy=dots")
    args = ap.parse_args(argv)

    from repro_torch.config import SHAPES
    from repro_torch.configs import ARCHS

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    results = []
    t_all = time.time()
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                t0 = time.time()
                rec = run_cell(arch, shape, mesh, args.out, args.force,
                               variant=args.variant)
                dt = time.time() - t0
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f"flops/dev={rec['flops_per_device']:.3e} "
                             f"bytes/dev={rec['bytes_per_device']:.3e} "
                             f"bound={r['bound']} count={rec['count_s']}s")
                elif status == "error":
                    extra = rec.get("error", "")[:120]
                elif status == "skipped":
                    extra = rec.get("reason", "")
                print(f"[{dt:7.1f}s] {arch:24s} {shape:12s} {mesh:6s} "
                      f"{status:8s} {extra}", flush=True)
                results.append(rec)

    n_ok = sum(r.get("status") == "ok" for r in results)
    n_skip = sum(r.get("status") == "skipped" for r in results)
    n_err = sum(r.get("status") == "error" for r in results)
    print(f"\nDRY-RUN SUMMARY: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"of {len(results)} cells in {time.time() - t_all:.1f} s")
    if n_err:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
