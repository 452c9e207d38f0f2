"""The launch layer of the port against the reference's
(``repro/launch``, ``repro/config.py``, ``repro/models/model_api.py``).

- ``param_counts``, ``cell_is_valid``, ``iter_cells``, every family's
  ``input_specs`` (keys, shapes, dtypes), ``batch_axes_for``,
  ``abstract_cache`` and ``cache_axes``, and ``model_flops_for`` equal the
  reference's for every arch and every valid shape of ``SHAPES``, full and
  REDUCED;
- ``RooflineTerms`` picks its bound and gives its ratios as
  ``tests/test_roofline.py::TestTerms`` holds the reference's, with the
  H100's constants;
- under ``use_backend("plain")`` the meta pass's product FLOPs equal the
  reference's jaxpr's within 1 %, for REDUCED dense, MoE, SSM, hybrid,
  enc-dec and VLM configs as train, prefill and decode cells at B 2, S 128.
  The reference's count is 2 M N K a ``dot_general`` that contracts, times
  its scans' lengths, from ``jax.make_jaxpr`` of ``build_cell(...).fn``
  under ``exact_flops_mode`` on ``make_host_mesh(1, 1)``, dead code
  dropped as XLA drops it. ``dot_general``s with nothing to contract are
  left out: they are broadcast products, which torch runs as ``mul`` (the
  SSD step's ``einsum("bh,bhp,bn->bhpn")``). A train cell adds to the
  reference's count the port's one known extra: each loss chunk's logits
  product is recomputed in the backward (``layers.lm_loss`` runs each
  chunk under ``torch.utils.checkpoint``; the reference's unrolled scan
  keeps the logits), 2 B S d V. The plain attention forms the full S x S
  scores, as the reference's XLA flash does at S 128 (one 128-key block),
  so these counts hold plain mode; the kernels' costs (which skip masked
  tiles) are held by ``tests/test_torch_cost.py``;
- the dry-run's ``run_cell`` records a full-width cell and skips an
  invalid one; ``exact_compile`` writes its record;
- each port example with device work finishes with ``--device cpu``, and
  the quickstart's printed summary equals the reference example's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.config import SHAPES as RSHAPES  # noqa: E402
from repro.config import ShapeConfig as RShape  # noqa: E402
from repro.config import cell_is_valid as r_cell_is_valid  # noqa: E402
from repro.config import iter_cells as r_iter_cells  # noqa: E402
from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.configs import REDUCED as RREDUCED  # noqa: E402
from repro.launch import roofline as rroof  # noqa: E402
from repro.models import get_model as r_get_model  # noqa: E402
from repro.models.model_api import batch_axes_for as r_batch_axes  # noqa: E402

from repro_torch.config import SHAPES, RunConfig, ShapeConfig  # noqa: E402
from repro_torch.config import asdict, cell_is_valid, iter_cells  # noqa: E402
from repro_torch.config import with_overrides  # noqa: E402
from repro_torch.configs import ARCHS, REDUCED  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.cells import build_cell, lower_cell  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.model_api import batch_axes_for  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TABLES = {"full": (ARCHS, RARCHS), "reduced": (REDUCED, RREDUCED)}


def _specs(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


@pytest.mark.parametrize("table", sorted(TABLES))
def test_config_helpers_equal_the_reference(table):
    port, ref = TABLES[table]
    assert sorted(port) == sorted(ref)      # registered in another order
    for arch in port:
        assert port[arch].param_counts() == ref[arch].param_counts()
        assert port[arch].uses_moe == ref[arch].uses_moe
        assert port[arch].sub_quadratic == ref[arch].sub_quadratic
        for name in SHAPES:
            assert cell_is_valid(port[arch], SHAPES[name]) == \
                r_cell_is_valid(ref[arch], RSHAPES[name])
            assert roofline.model_flops_for(port[arch], SHAPES[name]) == \
                rroof.model_flops_for(ref[arch], RSHAPES[name])
    assert sorted(iter_cells()) == sorted(r_iter_cells())
    assert len(list(iter_cells())) == len(list(r_iter_cells())) == 32
    assert list(iter_cells(["zamba2-1.2b"])) == \
        list(r_iter_cells(["zamba2-1.2b"]))
    cfg = with_overrides(port["qwen3-8b"], remat_policy="dots")
    assert cfg.remat_policy == "dots" and asdict(cfg)["arch_id"] == "qwen3-8b"


@pytest.mark.parametrize("table", sorted(TABLES))
def test_inputs_and_caches_equal_the_reference(table):
    port, ref = TABLES[table]
    for arch in port:
        pm, rm = get_model(port[arch]), r_get_model(ref[arch])
        for name, shape in SHAPES.items():
            if not cell_is_valid(port[arch], shape)[0]:
                continue
            pi, ri = pm.input_specs(shape), rm.input_specs(RSHAPES[name])
            assert {v.device.type for v in pi.values()} == {"meta"}
            assert _specs(pi) == _specs(ri), (arch, name)
            assert batch_axes_for(pi) == r_batch_axes(ri)
            if shape.kind != "decode":
                continue
            B, S = shape.global_batch, shape.seq_len
            assert _specs(pm.abstract_cache(B, S)) == \
                _specs(rm.abstract_cache(B, S)), (arch, name)
            assert pm.cache_axes(B, S) == {
                k: tuple(v) for k, v in rm.cache_axes(B, S).items()}


class TestTerms:
    def make(self, flops=1e15, byts=1e12, coll=1e10, compute_s=None):
        if compute_s is None:   # every FLOP on the bf16 tensor cores
            compute_s = flops / roofline.PEAK_FLOPS_BF16
        return roofline.RooflineTerms(
            arch="a", shape="s", mesh="single", chips=256,
            flops_per_chip=flops, bytes_per_chip=byts,
            collective_bytes_per_chip=coll, collective_breakdown={},
            model_flops=flops * 256 * 0.5, compute_s_per_chip=compute_s)

    def test_bound_selection(self):
        assert self.make(flops=1e15, byts=1e9, coll=1e6).bound == "compute"
        assert self.make(flops=1e12, byts=1e13, coll=1e6).bound == "memory"
        assert self.make(flops=1e12, byts=1e9, coll=1e13).bound == \
            "collective"
        # the H100's peaks: 989 TFLOP/s bf16, 3.35 TB/s
        assert (roofline.PEAK_FLOPS_BF16, roofline.HBM_BW) == \
            (989e12, 3.35e12)
        t = self.make(flops=989e12, byts=3.35e12, coll=0)
        assert t.t_compute == pytest.approx(1.0)
        assert t.t_memory == pytest.approx(1.0)
        # the compute term is the meta pass's (f32 work, exponentials)
        t = self.make(compute_s=2.0)
        assert t.t_compute == 2.0 and t.bound == "compute"

    def test_ratios(self):
        t = self.make()
        assert t.useful_flops_ratio == pytest.approx(0.5)
        assert 0 < t.roofline_fraction <= 1.0
        d = t.to_dict()
        assert d["bound"] == t.bound
        assert d["t_compute_s"] == t.t_compute

    def test_bound_of_a_cost(self):
        from repro_torch.kernels._cost import Cost

        assert roofline.bound(Cost(989e9, 1, unit="bf16")) == \
            {"bound_ms": pytest.approx(1.0), "bound_by": "operations"}
        assert roofline.bound(Cost(0, 3.35e9)) == \
            {"bound_ms": pytest.approx(1.0), "bound_by": "bytes"}
        exps = 16 * 132 * 1.98e9 * 1e-3
        assert roofline.bound(Cost(1, 1, exps=exps))["bound_ms"] == \
            pytest.approx(1.0)


def test_meshes_have_the_reference_shapes():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.axis_names, one.sizes) == (("data", "model"), (16, 16))
    assert (two.axis_names, two.sizes) == (("pod", "data", "model"),
                                           (2, 16, 16))
    assert make_host_mesh(2, 4).shape == {"data": 2, "model": 4}


# --- plain-mode product FLOPs against the reference's jaxpr ---------------

FAMILY_ARCHS = {"dense": "qwen3-8b", "moe": "granite-moe-1b-a400m",
                "ssm": "falcon-mamba-7b", "hybrid": "zamba2-1.2b",
                "encdec": "whisper-medium", "vlm": "llava-next-mistral-7b"}
B, S = 2, 128


def _dot_flops(eqn) -> int:
    import numpy as np

    (lc, _), _ = eqn.params["dimension_numbers"]
    if not lc:         # a broadcast product: nothing contracted
        return 0
    a = eqn.invars[0].aval.shape
    out = eqn.outvars[0].aval.shape
    return 2 * int(np.prod(out)) * int(np.prod([a[i] for i in lc]))


def _jaxpr_flops(jaxpr, mult: int = 1) -> int:
    from jax.extend import core

    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            total += mult * _dot_flops(eqn)
        assert eqn.primitive.name != "while", "a rolled loop"
        m = mult * (eqn.params["length"] if eqn.primitive.name == "scan"
                    else 1)
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (tuple, list)) else [p]):
                if isinstance(sub, core.ClosedJaxpr):
                    total += _jaxpr_flops(sub.jaxpr, m)
                elif isinstance(sub, core.Jaxpr):
                    total += _jaxpr_flops(sub, m)
    return total


def _reference_flops(arch: str, kind: str) -> int:
    from jax._src.interpreters import partial_eval as pe

    from repro.launch.cells import build_cell as r_build_cell
    from repro.launch.mesh import make_host_mesh as r_host_mesh
    from repro.parallel import tracing
    from repro.parallel.partition import activation_sharding

    mesh = r_host_mesh(1, 1)
    prog = r_build_cell(RREDUCED[arch], RShape("t", S, B, kind), mesh)
    with activation_sharding(mesh), tracing.exact_flops_mode(True):
        jx = jax.make_jaxpr(prog.fn)(*prog.abstract_args)
    live, _ = pe.dce_jaxpr(jx.jaxpr, [True] * len(jx.jaxpr.outvars))
    return _jaxpr_flops(live)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_plain_products_equal_the_reference_jaxpr(family, kind):
    arch = FAMILY_ARCHS[family]
    cfg = REDUCED[arch]
    want = _reference_flops(arch, kind)
    if kind == "train":       # the loss chunks' recomputed logits products
        s_text = S - (cfg.n_image_tokens if cfg.family == "vlm" else 0)
        want += 2 * B * s_text * cfg.d_model * cfg.vocab_size
    prog = build_cell(cfg, ShapeConfig("t", S, B, kind),
                      make_host_mesh(1, 1), run=RunConfig(arch=arch))
    with ops.use_backend("plain"):
        got = lower_cell(prog)
    assert got["kernels"] == {}
    products = sum(got["product_flops"].values())
    assert products == pytest.approx(want, rel=0.01), (products, want)


def test_kernel_pass_counts_kernel_costs_instead_of_plain_products():
    """The default backend: no plain attention products; each kernel's
    FLOPs come from its cost (the causal flash skips the masked tiles)."""
    cfg = REDUCED["qwen3-8b"]
    prog = build_cell(cfg, ShapeConfig("t", S, B, "prefill"),
                      make_host_mesh(1, 1))
    with ops.use_backend("plain"):
        plain = lower_cell(prog)
    kern = lower_cell(prog)
    assert kern["product_flops"]["f32"] == 0 < plain["product_flops"]["f32"]
    assert kern["kernels"]["flash_attention"]["calls"] == cfg.n_layers
    assert kern["flops"] == sum(kern["product_flops"].values()) + \
        kern["kernel_flops"]
    assert 0 < kern["peak_bytes"] and 0 < kern["bytes"]


# --- the dry-run and exact_compile ----------------------------------------


def test_dryrun_records_a_cell(tmp_path):
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("zamba2-1.2b", "train_4k", "single", str(tmp_path))
    assert rec["status"] == "ok" and rec["kind"] == "train"
    assert rec["chips"] == 256
    assert rec["collectives"] is None
    assert rec["collectives_reason"] == dryrun.NO_COLLECTIVES
    assert rec["flops_per_device"] == rec["flops_global"] / 256
    assert rec["memory"]["temp_size"] > 0
    assert rec["memory"]["per_device"]["state"] > 0
    assert rec["kernels"]["ssd"]["calls"] == rec["kernels"]["ssd_bwd"][
        "calls"] * 2
    assert rec["roofline"]["bound"] in ("compute", "memory")
    assert rec["indivisible"] == []
    on_disk = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert on_disk["flops_global"] == rec["flops_global"]
    # an invalid cell is skipped, as the reference's
    rec = dryrun.run_cell("qwen3-8b", "long_500k", "multi", str(tmp_path))
    assert rec["status"] == "skipped" and rec["chips"] == 512
    assert dryrun.parse_variant("remat_policy=dots,microbatches=2,x=1.5") \
        == {"remat_policy": "dots", "microbatches": 2, "x": 1.5}


def test_exact_compile_writes_its_record(tmp_path, monkeypatch):
    from repro_torch.launch import exact_compile

    monkeypatch.chdir(tmp_path)
    rec = exact_compile.main(["smollm-360m", "decode_32k"])
    path = tmp_path / "artifacts" / "torch_exact" / \
        "smollm-360m__decode_32k__exact.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    assert rec["flops_per_device"] > 0 and rec["collectives"] is None
    assert rec["kernels"]["decode_attention"]["calls"] == \
        ARCHS["smollm-360m"].n_layers


# --- the examples ---------------------------------------------------------


def _run(script: str, *args: str) -> str:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    done = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args], capture_output=True, text=True,
                          timeout=600, env=env, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-2000:]
    return done.stdout


def test_quickstart_prints_the_reference_summary():
    assert _run("torch_quickstart.py") == _run("quickstart.py")


@pytest.mark.parametrize("script", ["torch_adhoc_serving.py",
                                    "torch_fault_tolerant_training.py"])
def test_port_examples_finish_on_the_cpu(script):
    out = _run(script, "--device", "cpu")
    assert "True" in out and "False" not in out
