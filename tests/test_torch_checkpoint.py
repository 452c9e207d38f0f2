"""The port's checkpoint subsystem (``repro_torch/checkpoint/``) against
the JAX package's.

- every case of ``tests/test_checkpoint.py`` on both packages (the port's
  run through ``test_torch_core.ported``): stores, the replicated manager,
  the serializer's edge cases;
- the same cases' tree with torch leaves (bf16, f32, int32, a 0-d
  tensor), on the port: saved, restored after owner loss, the leaves back
  on their dtype bit for bit;
- ``split_into_shards`` gives the reference's bytes for the same tree, for
  every shard count, and ``join_shards`` reads the other package's shards,
  both ways.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.checkpoint.serializer as ref_ser  # noqa: E402
import repro_torch.checkpoint.serializer as port_ser  # noqa: E402
from repro_torch.checkpoint import DiskStore, SnapshotStore  # noqa: E402
from repro_torch.checkpoint.replicated import (  # noqa: E402
    ReplicatedCheckpointManager,
)
from test_torch_core import PACKAGES, cases, module_of, run_case  # noqa: E402

CKPT_CASES = cases("test_checkpoint")


def test_every_reference_case_is_collected():
    assert len(CKPT_CASES) >= 12


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CKPT_CASES)
def test_reference_case(case, package, tmp_path):
    run_case(module_of("test_checkpoint", package), case, tmp_path=tmp_path)


def _numpy_tree(seed=0):
    """``test_checkpoint.small_state`` widened by a bf16 leaf (numpy raw
    16-bit patterns, so both packages can hold the same bits)."""
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": rng.standard_normal((8, 8)).astype(np.float32),
            "b": rng.standard_normal((8,)).astype(np.float32),
            "emb_bits": rng.integers(0, 2 ** 16, (16, 4)).astype(np.uint16)
            & np.uint16(0x7F7F),     # finite bf16 patterns
        },
        "opt": {"mu": rng.standard_normal((8, 8)).astype(np.float32),
                "step": np.asarray(7, np.int32)},
        "rng": rng.integers(0, 2 ** 31, size=(2,)).astype(np.uint32),
    }


def _map(tree, leaf):
    return {k: _map(v, leaf) if isinstance(v, dict) else leaf(k, v)
            for k, v in tree.items()}


def _torch_tree(tree):
    """The port's leaves: torch tensors (0-d stays 0-d), the bf16 leaf as
    bf16."""
    def leaf(k, a):
        t = torch.from_numpy(a.copy())
        return t.view(torch.bfloat16) if k == "emb_bits" else t

    return _map(tree, leaf)


def _jax_tree(tree):
    def leaf(k, a):
        x = jnp.asarray(a)
        return x.view(jnp.bfloat16) if k == "emb_bits" else x

    return _map(tree, leaf)


def _bits(tree) -> dict:
    """Every leaf's raw bytes by key (either package's leaves)."""
    out = {}

    def walk(sub, prefix):
        if isinstance(sub, dict):
            for k, v in sub.items():
                walk(v, f"{prefix}{k}/")
            return
        if isinstance(sub, torch.Tensor):
            sub = sub.view(torch.uint16) if sub.dtype == torch.bfloat16 \
                else sub
            arr = sub.numpy()
        else:
            arr = np.asarray(sub)
        out[prefix[:-1]] = (arr.shape, arr.tobytes())

    walk(tree, "")
    return out


@pytest.mark.parametrize("n_shards", [1, 2, 3, 5, 9])
def test_shards_are_the_reference_bytes(n_shards):
    tree = _numpy_tree(1)
    ref = ref_ser.split_into_shards(_jax_tree(tree), n_shards)
    port = port_ser.split_into_shards(_torch_tree(tree), n_shards)
    assert len(port) == n_shards
    assert port == ref
    # numpy leaves (all but the bf16 one) give the same bytes too
    mixed = _numpy_tree(1)
    mixed["params"]["emb_bits"] = _torch_tree(tree)["params"]["emb_bits"]
    assert port_ser.split_into_shards(mixed, n_shards) == ref


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_join_reads_the_other_packages_shards(direction):
    tree = _numpy_tree(2)
    like_port, like_ref = _torch_tree(tree), _jax_tree(tree)
    if direction == "ref_to_port":
        blobs = ref_ser.split_into_shards(like_ref, 3)
        got = port_ser.join_shards(blobs[::-1], like_port)
        assert got["params"]["emb_bits"].dtype == torch.bfloat16
    else:
        blobs = port_ser.split_into_shards(like_port, 3)
        got = ref_ser.join_shards(blobs[::-1], like_ref)
        assert got["params"]["emb_bits"].dtype == jnp.bfloat16
    assert _bits(got) == _bits(like_port)


def test_join_refuses_a_missing_shard():
    tree = _torch_tree(_numpy_tree(3))
    blobs = port_ser.split_into_shards(tree, 3)
    with pytest.raises(KeyError):
        port_ser.join_shards(blobs[:2], tree)


@pytest.mark.parametrize("store", ["memory", "disk"])
def test_replicated_manager_with_torch_leaves(store, tmp_path):
    """The manager over torch leaves: saved by 3 owners, restored after
    owners a and b die, every leaf back bit for bit on its dtype."""
    hosts = ("a", "b", "c", "d", "e")
    stores = {h: (SnapshotStore() if store == "memory"
                  else DiskStore(str(tmp_path / h))) for h in hosts}
    mgr = ReplicatedCheckpointManager("job0", ["a", "b", "c"], stores)
    state = _torch_tree(_numpy_tree(4))
    rec = mgr.save(state, step=21, fail_prob={h: 0.05 for h in hosts},
                   available=set(hosts))
    assert rec.complete and len(rec.placements) == 3
    surviving = {"c", "d", "e"}
    assert mgr.survival_ok(surviving)
    got, step = mgr.restore(state, surviving=surviving)
    assert step == 21
    assert got["params"]["emb_bits"].dtype == torch.bfloat16
    assert got["opt"]["step"].dtype == torch.int32
    assert _bits(got) == _bits(state)
    mgr.forget()
    assert all(s.used_bytes == 0 for s in stores.values())
