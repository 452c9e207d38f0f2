"""The port's partition rules (``repro_torch/parallel/partition.py``) and
elastic checkpoint helpers (``repro_torch/checkpoint/elastic.py``)
against the JAX package's.

- every layout case of ``tests/test_partition.py`` (its ``FakeMesh``
  grids; the real-mesh cases place tensors on devices, which the port
  leaves to the materialized cell) runs on both packages, the port's copy
  retargeted (``test_torch_core.ported``), so the port's
  ``PartitionSpec`` meets the file's ``jax.sharding.PartitionSpec``
  assertions; and every ``spec_for_axes`` call a case makes gives the
  reference's entries on the port;
- every leaf of every REDUCED config's params and paged cache resolves
  to the reference's spec on the grids (1, 1), (1, 2), (2, 2), (4, 1)
  and (2, 4), from the port's own axes and abstract shapes (which equal
  the reference's), the cache in the reference's dtypes;
- ``plan_elastic_mesh`` equals the reference's for 1-64 devices at model
  axes 1, 2, 4 and 8, raises on the same bad inputs, and passes every
  case of ``tests/test_elastic.py`` that plans a grid (the file's own
  assertions, its ``plan_elastic_mesh`` swapped for the port's);
- ``gather_state`` is a host copy, bit for bit; ``param_tree`` hands back
  the module's own storage in the specs' structure.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import repro.checkpoint.elastic as ref_elastic  # noqa: E402
import test_elastic  # noqa: E402
import test_partition as ref_tests  # noqa: E402
from repro.configs import get as ref_get  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.parallel.partition import spec_for_axes as ref_spec  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.checkpoint.elastic import (  # noqa: E402
    gather_state,
    plan_elastic_mesh,
)
from repro_torch.configs import REDUCED, get  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.model_api import (  # noqa: E402
    PSpec,
    storage_dtype,
    tree_leaves,
)
from repro_torch.parallel.partition import (  # noqa: E402
    LayoutGrid,
    PartitionSpec,
    layout_grid,
    spec_for_axes,
    tree_partition_specs,
)
from repro_torch.serving.kvcache import (  # noqa: E402
    paged_cache_partition_specs,
)
from test_torch_core import cases, module_of, run_case  # noqa: E402

torch.set_num_threads(1)
# the cases that resolve specs on FakeMesh grids (the rest build a real
# jax Mesh and its NamedShardings)
LAYOUT_CASES = [c for c in cases("test_partition")
                if not c.startswith("TestRealMeshIntegration")]
GRIDS = [(1, 1), (1, 2), (2, 2), (4, 1), (2, 4)]
ARCHS = sorted(REDUCED)


def test_every_layout_case_is_collected():
    assert len(LAYOUT_CASES) == 11


@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_reference_case_on_both_packages(case, monkeypatch):
    """The case's own assertions on each package, then each of its calls
    entry for entry on the port."""
    calls = []

    def recorded(axes, shape, mesh):
        calls.append((tuple(axes), tuple(shape), mesh))
        return ref_spec(axes, shape, mesh)

    monkeypatch.setattr(ref_tests, "spec_for_axes", recorded)
    run_case(module_of("test_partition", "repro"), case)
    run_case(module_of("test_partition", "repro_torch"), case)
    assert calls
    for axes, shape, mesh in calls:
        got = spec_for_axes(axes, shape, mesh)
        assert isinstance(got, PartitionSpec)
        assert tuple(got) == tuple(ref_spec(axes, shape, mesh))
        grid = LayoutGrid(tuple(mesh.axis_names),
                          tuple(mesh.shape[a] for a in mesh.axis_names))
        assert tuple(spec_for_axes(axes, shape, grid)) == tuple(got)


def test_partition_spec_compares_as_jax_does():
    P = jax.sharding.PartitionSpec
    assert PartitionSpec("data", None) == P("data", None)
    assert P("data", None) == PartitionSpec("data", None)
    assert PartitionSpec("data", None) != PartitionSpec("data")
    assert (PartitionSpec("model") != PartitionSpec(None)) == \
        (P("model") != P(None))
    assert repr(PartitionSpec(("pod", "data"), None)) == \
        "PartitionSpec(('pod', 'data'), None)"
    assert layout_grid(2, 4).shape == {"data": 2, "model": 4}
    with pytest.raises(ValueError):
        LayoutGrid(("data", "model"), (2, 0))


def _flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _ref_specs(axes: dict, values: dict, grid) -> dict:
    mesh = ref_tests.FakeMesh(data=grid[0], model=grid[1])
    return {k: tuple(ref_spec(tuple(axes[k]), tuple(values[k].shape), mesh))
            for k in axes}


PAGED = dict(n_slots=4, n_pages=17, page_size=8)


@pytest.mark.parametrize("grid", GRIDS, ids=[f"{d}x{m}" for d, m in GRIDS])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_reduced_leaf_takes_the_reference_spec(arch, grid):
    ref_model = ref_get_model(ref_get(arch, reduced=True))
    model = get_model(get(arch, reduced=True))
    # params: the port's axes and abstract shapes are the reference's
    axes, ref_axes = _flat(model.param_axes()), _flat(ref_model.param_axes())
    abstract = _flat(model.abstract_params())
    ref_abstract = _flat(ref_model.abstract_params())
    assert axes == {k: tuple(v) for k, v in ref_axes.items()}
    assert {k: tuple(v.shape) for k, v in abstract.items()} == \
        {k: tuple(v.shape) for k, v in ref_abstract.items()}
    assert all(v.device.type == "meta" for v in abstract.values())
    specs = _flat(tree_partition_specs(model.param_axes(),
                                       model.abstract_params(),
                                       layout_grid(*grid)))
    assert {k: tuple(v) for k, v in specs.items()} == \
        _ref_specs(ref_axes, ref_abstract, grid)
    # the paged cache, the enc-dec cross pools included
    c_axes = model.paged_cache_axes(*PAGED.values())
    ref_c_axes = ref_model.paged_cache_axes(*PAGED.values())
    c_abs = model.abstract_paged_cache(*PAGED.values())
    ref_c_abs = ref_model.abstract_paged_cache(*PAGED.values())
    assert c_axes == {k: tuple(v) for k, v in ref_c_axes.items()}
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in c_abs.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in ref_c_abs.items()}
    c_specs = paged_cache_partition_specs(model, *PAGED.values(),
                                          layout_grid(*grid))
    assert {k: tuple(v) for k, v in c_specs.items()} == \
        _ref_specs(ref_c_axes, ref_c_abs, grid)


def test_plan_elastic_mesh_equals_the_reference():
    for n in range(1, 65):
        for mp in (1, 2, 4, 8):
            for pow2 in (True, False):
                assert plan_elastic_mesh(n, model_parallel=mp,
                                         prefer_pow2=pow2) == \
                    ref_elastic.plan_elastic_mesh(n, model_parallel=mp,
                                                  prefer_pow2=pow2)


# the cases of tests/test_elastic.py that call only plan_elastic_mesh
PLAN_CASES = [c for c in cases("test_elastic")
              if c.startswith("TestPlanElasticMesh::")
              or c.startswith("TestValidation::test_plan_")]


def test_every_plan_case_is_collected():
    assert len(PLAN_CASES) == 7


@pytest.mark.parametrize("case", PLAN_CASES)
def test_elastic_plan_case_on_the_port(case, monkeypatch):
    monkeypatch.setattr(test_elastic, "plan_elastic_mesh", plan_elastic_mesh)
    run_case(test_elastic, case)


@pytest.mark.parametrize("n,mp", [(0, 2), (-3, 1), (4, 0), (4, -2)])
def test_plan_elastic_mesh_refuses_as_the_reference(n, mp):
    with pytest.raises(ValueError) as ref_err:
        ref_elastic.plan_elastic_mesh(n, model_parallel=mp)
    with pytest.raises(ValueError) as err:
        plan_elastic_mesh(n, model_parallel=mp)
    assert str(err.value) == str(ref_err.value)


def test_gather_state_round_trips_bitwise():
    g = torch.Generator().manual_seed(0)
    state = {"w": torch.randn(3, 5, generator=g).bfloat16(),
             "ln": torch.randn(5, generator=g),
             "nested": {"ids": torch.arange(7, dtype=torch.int32),
                        "x": torch.randn(2, 3, generator=g)[:, 1]}}
    host = gather_state(state)
    for a, b in zip(tree_leaves(state), tree_leaves(host)):
        assert b.device.type == "cpu" and b.dtype == a.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
        assert b.untyped_storage().data_ptr() != \
            a.untyped_storage().data_ptr()
    state["w"].zero_()            # a copy, not a view
    assert host["w"].abs().sum() > 0
    back = gather_state(host)
    assert torch.equal(back["nested"]["ids"], host["nested"]["ids"])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_is_the_modules_storage(arch):
    """``param_tree`` has ``param_specs``' structure, each leaf the spec's
    shape in its storage dtype, and every weight of the module lies in one
    of its leaves; through the bridge, its leaves are the reference's
    values as the port stores them."""
    model = get_model(get(arch, reduced=True))
    params = model.init(0, device="cpu")
    tree = _flat(model.param_tree(params))
    specs = _flat(model.param_specs)
    assert set(tree) == set(specs)
    for k, spec in specs.items():
        assert isinstance(spec, PSpec)
        assert tuple(tree[k].shape) == spec.shape
        assert tree[k].dtype == storage_dtype(spec)
    spans = [(t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
             for t in tree.values()]
    for name, p in params.named_parameters():
        assert any(lo <= p.data_ptr() < hi for lo, hi in spans), name
    ref_model = ref_get_model(ref_get(arch, reduced=True))
    ref_params = jax.tree.map(np.asarray, ref_model.init(jax.random.key(1)))
    bridged = params_from_reference(ref_params, model, device="cpu")
    for k, leaf in _flat(model.param_tree(bridged)).items():
        want = _flat(ref_params)[k]
        assert torch.equal(leaf, torch.from_numpy(np.array(want)).to(
            leaf.dtype)), k
    with pytest.raises(ValueError, match="ModelFns.init"):
        model.param_tree(torch.nn.Linear(2, 2))
