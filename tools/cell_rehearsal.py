"""CPU rehearsal of ``chip_smoke.py``'s ``phase_cell`` and
``phase_materialized``: predicts every counter of the four elastic-cell
scenarios and of the materialized cell's before the card runs them.

Usage, from the root of a checkout (no card needed; ~10 s):

    PYTHONPATH=src python tools/cell_rehearsal.py

The scenarios are ``chip_smoke.py``'s own (``CELL``, ``CELL_ENGINE``,
``CELL_SCENARIOS``, the prompts of ``_cell_prompts``, the formation and
fault plan of ``_cell_formed`` and the checks of ``_cell_checks``), served
by REDUCED ``qwen3-8b`` on the CPU. A re-shard's bytes, and so the
simulated seconds it takes, are reckoned from full-width ``qwen3-8b``'s
abstract weights and pool (meta tensors, nothing allocated): the cell's
relayout is handed those trees in place of the REDUCED ones, so its clock,
and every counter that follows the clock, is the full-width run's. The
tokens are REDUCED's. The materialized scenario (``MAT_CELL``,
``MAT_FAULTS``, ``_mat_formed``, ``_mat_checks``) runs on a one-rank gloo
group and a (1, 1) mesh where the card uses NCCL, then layout-only. Prints
one JSON line a scenario and the full-width byte counts.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.checkpoint.elastic import clear_meshes  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.model_api import tree_leaves  # noqa: E402
from repro_torch.serving.batch import make_engine_factory  # noqa: E402
from repro_torch.serving.cell import ElasticServeCell  # noqa: E402


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def main() -> int:
    torch.set_num_threads(4)
    full = get_model(get("qwen3-8b"))
    eng = smoke.CELL_ENGINE
    full_params = full.abstract_params()
    full_cache = full.abstract_paged_cache(eng["n_slots"], eng["n_pages"],
                                           eng["page_size"])
    print(json.dumps({"full_width_bytes": {
        "params": _nbytes(full_params), "pool": _nbytes(full_cache),
        "page": _nbytes(full_cache) // eng["n_pages"]}}))

    relayout = ElasticServeCell._relayout

    def full_width(self, grid, engine):
        proxy = SimpleNamespace(n_slots=engine.n_slots,
                                n_pages=engine.n_pages,
                                page_size=engine.page_size, cache=full_cache)
        saved = self.params_host, self.param_axes, self.model
        self.params_host, self.param_axes, self.model = (
            full_params, full.param_axes(), full)
        try:
            return relayout(self, grid, proxy)
        finally:
            self.params_host, self.param_axes, self.model = saved

    ElasticServeCell._relayout = full_width
    model = get_model(get("qwen3-8b", reduced=True))
    params = model.init(0, device="cpu")
    factory = make_engine_factory(model, params, device="cpu", **eng)
    prompts = smoke._cell_prompts(model.cfg.vocab_size, 8)
    trusted = factory("__trusted__")
    reqs = [trusted.submit(p, max_new_tokens=smoke.CELL_NEW)
            for p in prompts]
    trusted.run(100_000)
    want = [list(r.generated) for r in reqs]
    ok = True
    for name in smoke.CELL_SCENARIOS:
        srv, cell, creqs, clock, plan = smoke._cell_formed(
            model, params, factory, name, prompts)
        formed_at = clock.now()
        summary = cell.run(clock, fault_plan=plan, max_ticks=2000)
        problems = smoke._cell_checks(name, summary, cell, creqs, want)
        ok &= not problems
        resharded = [(round(t, 4), kv["cause"], kv["grid"],
                      kv["bytes_moved"], kv["replayed"], kv["shed"])
                     for t, ev, kv in srv.log if ev == "cell_resharded"]
        print(json.dumps({
            "scenario": name, "formation_ends_s": formed_at,
            "faults": [(e.at, e.kind, e.host) for e in plan.events],
            **{k: v for k, v in summary.items() if k != "goodput_tok_s"},
            "sim_s": clock.now(), "reshards": resharded,
            "states": [r.state for r in creqs],
            "committed": [len(r.committed) for r in creqs],
            "problems": problems}))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1)
        try:
            for materialize in (True, False):
                srv, cell, creqs, clock, plan = smoke._mat_formed(
                    model, params, factory, prompts, materialize=materialize)
                summary = cell.run(clock, fault_plan=plan, max_ticks=2000)
                problems = smoke._mat_checks(summary, creqs, want)
                ok &= not problems
                print(json.dumps({
                    "scenario": "materialized" if materialize
                    else "materialized, layout-only",
                    **{k: v for k, v in summary.items()
                       if k != "goodput_tok_s"},
                    "sim_s": clock.now(),
                    "reshards": [(round(t, 4), kv["cause"], kv["grid"],
                                  kv["restored"], kv["replayed"])
                                 for t, ev, kv in srv.log
                                 if ev == "cell_resharded"],
                    "problems": problems}))
        finally:
            clear_meshes()
            dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
