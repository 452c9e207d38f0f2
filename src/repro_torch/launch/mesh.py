"""The production and host layout grids (``repro/launch/mesh.py``).

Grids of the partition rules (``parallel/partition.py``), axis names and
sizes without devices: the dry-run (``launch/dryrun.py``) reads the
per-device layout of every leaf from them. The reference's shapes: one
pod (16, 16) over ``("data", "model")``, two pods (2, 16, 16) over
``("pod", "data", "model")``. The reference's TPU constants (peak FLOP/s,
HBM and ICI rates) are not kept: the port's card's are in
``launch/roofline.py``. A grid of real devices is a ``DeviceMesh`` of the
same axis names (``checkpoint.elastic.make_elastic_mesh``, the materialized
elastic cell), which the same rules read (``parallel.partition.grid_of``).
"""

from __future__ import annotations

import math

from repro_torch.parallel.partition import LayoutGrid, layout_grid


def make_production_mesh(*, multi_pod: bool = False) -> LayoutGrid:
    """One pod (16, 16), 256 devices; two pods (2, 16, 16), 512."""
    if multi_pod:
        return LayoutGrid(("pod", "data", "model"), (2, 16, 16))
    return LayoutGrid(("data", "model"), (16, 16))


def make_host_mesh(n_data: int, n_model: int) -> LayoutGrid:
    """A small ``(data, model)`` grid (tests, the elastic cell)."""
    return layout_grid(n_data, n_model)


def devices(mesh: LayoutGrid) -> int:
    return math.prod(mesh.sizes)
