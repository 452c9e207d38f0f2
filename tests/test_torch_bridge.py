"""Weight bridge: the JAX package's parameters into the port, by value.

- a leaf round-trips bit for bit, f32 and bf16 alike (special values
  included);
- ``params_from_reference`` maps the reference's layer-stacked tree onto the
  port's per-layer modules: matrices equal the reference's own bf16 cast
  bit for bit, norm weights cross as f32 unchanged;
- a tree that does not match the model's specs is refused.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REDUCED  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    numpy_from_tensor,
    params_from_reference,
    tensor_from_numpy,
)
from repro_torch.configs import get  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

torch.set_num_threads(1)
RNG = np.random.default_rng(5)
SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -3.0e38,
                    1.0, -2.0 ** -133], np.float32)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint16 if a.itemsize == 2
                                        else np.uint32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", [(7,), (3, 5, 4), (2, 1, 9, 2)])
def test_leaf_round_trip_is_bitwise(shape, dtype):
    vals = RNG.standard_normal(shape).astype(np.float32).reshape(-1)
    vals[: min(len(vals), len(SPECIAL))] = SPECIAL[: len(vals)]
    arr = np.asarray(jnp.asarray(vals.reshape(shape), dtype))
    t = tensor_from_numpy(arr)
    assert t.dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                       else torch.float32)
    assert tuple(t.shape) == shape
    back = numpy_from_tensor(t)
    np.testing.assert_array_equal(_bits(back), _bits(arr))
    # the tensor holds the same values as the JAX array
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(arr, np.float32))


@pytest.mark.parametrize("arch", ["qwen3-8b", "smollm-360m"])
def test_params_from_reference_layout(arch):
    cfg = REDUCED[arch]
    ref = ref_get_model(cfg).init(jax.random.key(1))
    tree = jax.tree.map(np.asarray, ref)
    model = get_model(get(arch, reduced=True))
    params = params_from_reference(tree, model, device="cpu")
    assert len(params.layers) == cfg.n_layers
    assert hasattr(params, "unembed") != cfg.tie_embeddings
    for group in ("attn", "mlp"):
        for name, leaf in ref["layers"][group].items():
            stacked = np.asarray(leaf)
            for i, block in enumerate(params.layers):
                got = getattr(getattr(block, group), name)
                if stacked.ndim > 2:     # a matrix: the reference's bf16 cast
                    want = np.asarray(jnp.asarray(stacked[i], jnp.bfloat16))
                    assert got.dtype == torch.bfloat16
                else:                    # a norm weight: f32 as is
                    want = stacked[i]
                    assert got.dtype == torch.float32
                np.testing.assert_array_equal(_bits(numpy_from_tensor(got)),
                                              _bits(want))
    emb = np.asarray(jnp.asarray(ref["embedding"], jnp.bfloat16))
    np.testing.assert_array_equal(_bits(numpy_from_tensor(params.embedding)),
                                  _bits(emb))
    np.testing.assert_array_equal(numpy_from_tensor(params.final_ln),
                                  np.asarray(ref["final_ln"]))


def test_mismatched_tree_is_refused():
    cfg = REDUCED["qwen3-8b"]
    tree = jax.tree.map(np.asarray, ref_get_model(cfg).init(jax.random.key(0)))
    model = get_model(get("qwen3-8b", reduced=True))
    bad = dict(tree)
    bad["embedding"] = bad["embedding"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_reference(bad, model, device="cpu")
    bad = {k: v for k, v in tree.items() if k != "unembed"}
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(bad, model, device="cpu")
