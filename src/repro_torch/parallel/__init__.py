"""Distribution layer of the port: the logical-axis partition rules on a
layout grid (``repro/parallel/partition.py``) and gradient compression
(``collectives``). Placement on real devices waits for the materialized
elastic cell (ROADMAP Queue 1, item 16)."""

from repro_torch.parallel.collectives import compress_grads
from repro_torch.parallel.partition import (
    LayoutGrid,
    PartitionSpec,
    layout_grid,
    spec_for_axes,
    tree_partition_specs,
)

__all__ = [
    "compress_grads",
    "LayoutGrid",
    "PartitionSpec",
    "layout_grid",
    "spec_for_axes",
    "tree_partition_specs",
]
