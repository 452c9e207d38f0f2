"""Tree <-> bytes serialization with a manifest, in the JAX package's blob
format (``repro/checkpoint/serializer.py:1-75``), so that a snapshot
written by either package restores in the other.

Format: ``[u32 header_len][header JSON][leaf0 raw][leaf1 raw]...``. The
header lists one ``{"key", "dtype", "shape"}`` per leaf, in the order the
raw bytes follow: a nested dict is flattened over its sorted keys, as
``jax.tree_util`` flattens a dict, and a key is the path joined by ``/``
(``cache/k_pages``). Dtypes are numpy names; a bf16 leaf is written as
``"bfloat16"`` with its raw bits (the bridge's 16-bit view), so neither
side needs a numpy bfloat16 type to write it. No pickle anywhere:
snapshots cross trust boundaries in an ad hoc cloud (paper §I), so the
format is data-only by construction.

Leaves are torch tensors (any device) or numpy arrays (0-d included).
Splitting a tree into byte-balanced shards (``split_into_shards``) is not
ported yet (ROADMAP Queue 1, item 8).
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from repro_torch.bridge import numpy_from_tensor

Tree = Any

_HDR = "<u4"


def _flatten(tree: Tree, prefix: str = "") -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _as_numpy(leaf) -> tuple[str, np.ndarray]:
    """(dtype name, array of the leaf's raw bytes)."""
    if isinstance(leaf, torch.Tensor):
        name = "bfloat16" if leaf.dtype == torch.bfloat16 else \
            str(numpy_from_tensor(leaf[:0]).dtype)
        return name, numpy_from_tensor(leaf)
    arr = np.asarray(leaf)
    # a copy only where needed: np.ascontiguousarray would make a 0-d leaf 1-d
    return str(arr.dtype), arr if arr.flags.c_contiguous else arr.copy()


def serialize_tree(tree: Tree) -> bytes:
    """Serialize a (nested dict) tree of arrays to one self-describing
    blob."""
    leaves = [(k, *_as_numpy(a)) for k, a in _flatten(tree)]
    header = [{"key": k, "dtype": dt, "shape": list(a.shape)}
              for k, dt, a in leaves]
    hbytes = json.dumps(header).encode()
    parts = [np.asarray(len(hbytes), _HDR).tobytes(), hbytes]
    parts += [memoryview(a.reshape(-1)).cast("B") for _, _, a in leaves]
    return b"".join(parts)


def _raw_dtype(name: str) -> np.dtype:
    # bf16 is read as its raw 16-bit pattern: no numpy bfloat16 type needed
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def read_leaves(blob: bytes) -> dict[str, tuple[str, np.ndarray]]:
    """The blob's leaves by key: each leaf's dtype name and a read-only
    array over the blob's own bytes (no copy; a bf16 leaf as its raw
    16-bit pattern, ``np.uint16``)."""
    hlen = int(np.frombuffer(blob[:4], _HDR)[0])
    header = json.loads(blob[4:4 + hlen].decode())
    off = 4 + hlen
    arrays: dict[str, tuple[str, np.ndarray]] = {}
    for ent in header:
        dt = _raw_dtype(ent["dtype"])
        n = int(np.prod(ent["shape"], dtype=np.int64))
        arrays[ent["key"]] = (ent["dtype"], np.frombuffer(
            blob, dt, count=n, offset=off).reshape(ent["shape"]))
        off += n * dt.itemsize
    return arrays


def deserialize_tree(blob: bytes, like: Tree) -> Tree:
    """Rebuild a tree with the structure of ``like`` from ``blob``. Each
    leaf comes back as ``like``'s leaf is: a torch tensor of its dtype on
    its device, or a numpy array of its dtype; shapes must agree."""
    arrays = read_leaves(blob)

    def leaf(key: str, want):
        name, arr = arrays[key]
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{key}: shape {arr.shape} in the blob, "
                             f"{tuple(want.shape)} expected")
        if isinstance(want, torch.Tensor):
            t = torch.from_numpy(arr.copy())
            if name == "bfloat16":
                t = t.view(torch.bfloat16)
            return t.to(device=want.device, dtype=want.dtype)
        if name == "bfloat16":
            raise ValueError(f"{key}: a bfloat16 leaf for a numpy {want.dtype}")
        return arr.astype(np.asarray(want).dtype)

    def build(sub, prefix: str):
        if isinstance(sub, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in sub.items()}
        return leaf(prefix[:-1], sub)

    return build(like, "")
