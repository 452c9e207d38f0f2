"""Per-host snapshot stores.

A host's store holds *other* guests' snapshot replicas pushed to it by the
P2P snapshot component. Capacity is the host-user-set maximum ad hoc
storage (regular BOINC preference, paper §III-D): ``put`` refuses when the
blob would exceed the cap, and the server stops advertising full hosts.

Keep-only-latest is a property of the key scheme: snapshots are stored
under their job id, so a newer version overwrites the older one.

Copied from ``repro/checkpoint/store.py`` (plain Python), so that
the port imports nothing of the JAX package; only the
cross-references name the port's modules.
"""

from __future__ import annotations

import os
from typing import Iterator


class SnapshotStore:
    """In-memory store (the default for simulation and tests)."""

    def __init__(self, capacity_bytes: int = 1 << 62):
        self.capacity_bytes = capacity_bytes
        self._blobs: dict[str, bytes] = {}

    @property
    def used_bytes(self) -> int:
        return sum(len(b) for b in self._blobs.values())

    def put(self, key: str, blob: bytes) -> bool:
        projected = self.used_bytes - len(self._blobs.get(key, b"")) + len(blob)
        if projected > self.capacity_bytes:
            return False
        self._blobs[key] = blob
        return True

    def get(self, key: str) -> bytes | None:
        return self._blobs.get(key)

    def delete(self, key: str) -> None:
        self._blobs.pop(key, None)

    def clear(self) -> None:
        self._blobs.clear()

    def keys(self) -> Iterator[str]:
        return iter(list(self._blobs))

    def __contains__(self, key: str) -> bool:
        return key in self._blobs


class DiskStore(SnapshotStore):
    """File-backed store (deployment; one file per key)."""

    def __init__(self, root: str, capacity_bytes: int = 1 << 62):
        super().__init__(capacity_bytes)
        self.root = root
        os.makedirs(root, exist_ok=True)
        from urllib.parse import unquote

        for name in os.listdir(root):
            if name.endswith(".tmp"):
                continue
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                self._blobs[unquote(name)] = f.read()

    def _path(self, key: str) -> str:
        from urllib.parse import quote

        return os.path.join(self.root, quote(key, safe=""))

    def put(self, key: str, blob: bytes) -> bool:
        if not super().put(key, blob):
            return False
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self._path(key))   # atomic swap = keep-only-latest
        return True

    def delete(self, key: str) -> None:
        super().delete(key)
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def clear(self) -> None:
        for k in list(self._blobs):
            self.delete(k)
