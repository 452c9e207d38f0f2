"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU.

- importing every ``repro_torch`` module leaves ``jax`` out of
  ``sys.modules`` (in a fresh interpreter);
- an AST scan of ``src/repro_torch`` and ``chip_smoke.py`` finds no import
  of ``jax`` or of ``repro``;
- without a card, every entry point asked for ``cuda`` raises instead of
  running on the CPU;
- the port's configs equal the JAX package's, every arch of it, the
  multimodal ones included, and ``get_model`` builds every family;
- initialization follows the reference's rules (fan-in, ``normal``,
  ``small``; an unknown rule raises), and ``param_count`` counts every
  family's leaves.
"""

import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.model_api import PSpec, _cache_dtype  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules() -> list[str]:
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PORT)], "repro_torch.")
    ]


def test_every_module_imports_without_jax():
    mods = _modules()
    assert {"repro_torch.serving.engine", "repro_torch.models.mamba",
            "repro_torch.models.hybrid", "repro_torch.kernels.selective_scan",
            "repro_torch.kernels.ssd", "repro_torch.configs.falcon_mamba_7b",
            "repro_torch.configs.zamba2_1_2b",
            "repro_torch.kernels.decode_attention",
            "repro_torch.checkpoint.serializer", "repro_torch.core",
            "repro_torch.core.cloudlet",
            "repro_torch.core.reliability",
            "repro_torch.core.simulation", "repro_torch.core.events",
            "repro_torch.core.backoff", "repro_torch.core.faults",
            "repro_torch.core.availability", "repro_torch.core.snapshot",
            "repro_torch.core.server", "repro_torch.core.continuity",
            "repro_torch.core.client", "repro_torch.core.cloud",
            "repro_torch.checkpoint.store",
            "repro_torch.checkpoint.replicated",
            "repro_torch.serving.batch", "repro_torch.models.encdec",
            "repro_torch.configs.whisper_medium",
            "repro_torch.configs.llava_next_mistral_7b",
            "repro_torch.parallel", "repro_torch.parallel.partition",
            "repro_torch.checkpoint.elastic",
            "repro_torch.serving.cell", "repro_torch.data.synthetic",
            "repro_torch.optim.adamw", "repro_torch.parallel.collectives",
            "repro_torch.training.state", "repro_torch.training.step",
            "repro_torch.training.straggler",
            "repro_torch.training.trainer",
            "repro_torch.launch.train"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'repro' or k.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_no_source_imports_jax_or_the_reference_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, name)


def test_no_source_imports_triton():
    """Every kernel is CUDA C++ built by ``kernels/_build.py``: no module of
    the port, nor ``chip_smoke.py``, imports ``triton``."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] != "triton", (f, name)
    from repro_torch.kernels import _build

    assert set(_build.SOURCES) == {p.stem for p in (PORT / "csrc").glob("*.cu")}


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = get_model(get("qwen3-8b", reduced=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_paged_cache(2, 9, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(2, 16)
    params = model.init(0, device="cpu")
    from repro_torch.serving.engine import ServeEngine

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params, n_slots=2, max_seq=64, page_size=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params, n_slots=2, max_seq=64, paged=False)
    from repro_torch.bridge import params_from_reference

    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_reference({}, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device("cuda")
    from repro_torch.config import RunConfig
    from repro_torch.training.state import init_train_state
    from repro_torch.training.trainer import AdHocTrainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdHocTrainer(model.cfg, RunConfig(arch="qwen3-8b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_master(0)
    from repro_torch.serving.batch import make_engine_factory

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine_factory(model, params, n_slots=2, max_seq=64,
                            page_size=16)("h0")
    factory = make_engine_factory(model, params, n_slots=2, max_seq=64,
                                  page_size=16, device="cpu")
    assert factory("h0").cache["k_pages"].device.type == "cpu"
    from repro_torch.core.server import AdHocServer
    from repro_torch.serving.cell import ElasticServeCell

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticServeCell(AdHocServer(), "cell", model, params,
                         engine_kwargs=dict(n_slots=2, max_seq=64,
                                            page_size=16))
    eng = ServeEngine(model, params, n_slots=2, max_seq=64, page_size=16,
                      device="cpu")
    assert eng.cache["k_pages"].device.type == "cpu"


def test_engine_rejects_what_the_slice_leaves_out():
    """Speculative decoding is ported: a draft builds its pools beside the
    target's. The engine refuses a draft for a multimodal (VLM) or cross
    (enc-dec) target, and for a recurrent-state one, as the reference
    refuses them (``repro/serving/engine.py:413-416``); ``get_model``
    builds both multimodal families, the enc-dec's cross pools beside its
    self pools."""
    from repro_torch.configs import draft_for
    from repro_torch.serving.engine import ServeEngine

    model = get_model(get("qwen3-8b", reduced=True))
    params = model.init(0, device="cpu")
    kw = dict(n_slots=2, max_seq=64, page_size=16, device="cpu")
    eng = ServeEngine(model, params, **kw, draft=model, draft_params=params)
    assert sorted(eng.cache) == ["draft_k_pages", "draft_v_pages",
                                 "k_pages", "v_pages"]
    assert draft_for("deepseek-moe-16b").arch_id == "granite-moe-1b-a400m"
    for arch in ("llava-next-mistral-7b", "whisper-medium"):
        mm = get_model(get(arch, reduced=True))
        mparams = mm.init(0, device="cpu")
        with pytest.raises(ValueError, match="text-only"):
            ServeEngine(mm, mparams, **kw, draft=model, draft_params=params)
    enc = get_model(get("whisper-medium", reduced=True))
    assert enc.supports_paged_cross and not model.supports_paged_cross
    assert sorted(enc.init_paged_cache(2, 9, 16, device="cpu")) == [
        "cross_k_pages", "cross_v_pages", "self_k_pages", "self_v_pages"]
    ssm = get_model(get("falcon-mamba-7b", reduced=True))
    with pytest.raises(ValueError, match="verify"):
        ServeEngine(ssm, ssm.init(0, device="cpu"), **kw, draft=model,
                    draft_params=params)


@pytest.mark.parametrize("arch", [
    "qwen3-8b", "smollm-360m", "falcon-mamba-7b", "zamba2-1.2b",
    "phi4-mini-3.8b", "minitron-4b", "granite-moe-1b-a400m",
    "deepseek-moe-16b", "llava-next-mistral-7b", "whisper-medium",
])
def test_configs_equal_the_reference(arch):
    from repro.configs import ARCHS
    from repro.configs import get as ref_get

    for reduced in (False, True):
        assert dataclasses.asdict(get(arch, reduced)) == \
            dataclasses.asdict(ref_get(arch, reduced))
    # every arch of the JAX package is here, and its family builds
    from repro_torch.configs import ARCHS as PORT_ARCHS

    assert set(PORT_ARCHS) == set(ARCHS)
    assert get_model(get(arch, reduced=True)).supports_paged


def test_init_follows_the_reference_fan_in_rule():
    """Same fan-in per leaf as ``repro/models/model_api.py:43-57``, bf16
    storage for matrices, f32 for norm weights."""
    from repro.models import get_model as ref_get_model
    from repro.configs import get as ref_get
    import jax

    cfg = get("qwen3-8b", reduced=True)
    model = get_model(cfg)
    ref_specs = ref_get_model(ref_get("qwen3-8b", reduced=True)).param_specs
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    flat = dict(params.named_parameters())
    ref_flat = jax.tree_util.tree_flatten_with_path(
        ref_specs, is_leaf=lambda x: hasattr(x, "fan_axis"))[0]
    n_port = len(jax.tree_util.tree_leaves(
        model.param_specs, is_leaf=lambda x: isinstance(x, PSpec)))
    assert len(ref_flat) == n_port
    for path, spec in ref_flat:
        keys = [p.key for p in path]
        port = model.param_specs
        for k in keys:
            port = port[k]
        assert port.shape == spec.shape and port.init == spec.init
        if spec.init == "fan_in":
            fan = max(1, int(np.prod(spec.shape[1:-1] if spec.axes[0] ==
                                     "layers" and len(spec.shape) > 2
                                     else spec.shape[:-1])))
            assert port.fan_in() == fan
    w = flat["layers.0.attn.wq"]
    assert w.dtype == torch.bfloat16
    fan = cfg.d_model * cfg.n_heads   # all axes but the last (and layers)
    assert abs(w.float().std().item() * fan ** 0.5 - 1) < 0.05
    assert flat["layers.1.mlp.ln"].dtype == torch.float32
    assert flat["embedding"].dtype == torch.bfloat16
    assert abs(flat["embedding"].float().std().item() / 0.02 - 1) < 0.05


def test_cache_dtype_rule():
    assert _cache_dtype(PSpec((2, 3), ("pages", "null_i32")),
                        torch.bfloat16) == torch.int32
    assert _cache_dtype(PSpec((2, 3), ("state", "x")),
                        torch.bfloat16) == torch.float32
    assert _cache_dtype(PSpec((2, 3), ("pages", "head_dim")),
                        torch.bfloat16) == torch.bfloat16



@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_ssm_specs_follow_the_reference(arch):
    """Every leaf's shape, init rule and fan-in equal the reference's
    (``repro/models/model_api.py:43-57``); ``A_log`` draws with the
    ``small`` rule (N(0, 1) * 1e-4) and stays f32, as does ``conv_w``."""
    import jax
    from repro.configs import get as ref_get
    from repro.models import get_model as ref_get_model

    model = get_model(get(arch, reduced=True))
    ref_specs = ref_get_model(ref_get(arch, reduced=True)).param_specs
    ref_flat = jax.tree_util.tree_flatten_with_path(
        ref_specs, is_leaf=lambda x: hasattr(x, "fan_axis"))[0]
    assert len(ref_flat) == len(jax.tree_util.tree_leaves(
        model.param_specs, is_leaf=lambda x: isinstance(x, PSpec)))
    for path, spec in ref_flat:
        port = model.param_specs
        for k in path:
            port = port[k.key]
        assert (port.shape, port.axes, port.init) == \
            (spec.shape, spec.axes, spec.init), path
        if spec.init == "fan_in":
            fan = max(1, int(np.prod(spec.shape[1:-1] if spec.axes[0] ==
                                     "layers" and len(spec.shape) > 2
                                     else spec.shape[:-1])))
            assert port.fan_in() == fan, path
    params = model.init(torch.Generator().manual_seed(5), device="cpu")
    a_log = torch.stack([b.A_log for b in params.layers])
    assert a_log.dtype == torch.float32
    assert abs(a_log.std().item() / 1e-4 - 1) < 0.2
    assert params.layers[0].conv_w.dtype == torch.float32


def test_unknown_init_rule_raises():
    from repro_torch.models.model_api import _materialize

    spec = PSpec((4, 4), ("embed_in", "mlp"), init="xavier")
    with pytest.raises(ValueError, match="unknown init"):
        _materialize(spec, torch.Generator().manual_seed(0),
                     torch.device("cpu"))


@pytest.mark.parametrize("arch,billions", [
    ("qwen3-8b", 8.191), ("smollm-360m", 0.362),
    ("falcon-mamba-7b", 7.273), ("zamba2-1.2b", 1.229),
    ("llava-next-mistral-7b", 7.246), ("whisper-medium", 0.793),
])
def test_param_count_counts_every_leaf(arch, billions):
    """``param_count`` equals the number of values the specs declare, for
    every family the port carries (falcon-mamba-7b 7.273 B, zamba2-1.2b
    1.229 B, llava-next-mistral-7b 7.246 B with ``mm_proj``,
    whisper-medium 0.793 B with its 32,768 learned decoder positions)."""
    cfg = get(arch)
    specs = _spec_leaves(get_model(cfg).param_specs)
    assert cfg.param_count() == sum(int(np.prod(s.shape)) for s in specs)
    assert round(cfg.param_count() / 1e9, 3) == billions


def _spec_leaves(tree) -> list:
    if isinstance(tree, PSpec):
        return [tree]
    return [leaf for v in tree.values() for leaf in _spec_leaves(v)]
