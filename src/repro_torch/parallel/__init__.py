"""Distribution layer of the port: the logical-axis partition rules on a
layout grid (``repro/parallel/partition.py``). Placement on real devices
waits for the materialized elastic cell (ROADMAP Queue 1, item 16)."""

from repro_torch.parallel.partition import (
    LayoutGrid,
    PartitionSpec,
    layout_grid,
    spec_for_axes,
    tree_partition_specs,
)

__all__ = [
    "LayoutGrid",
    "PartitionSpec",
    "layout_grid",
    "spec_for_axes",
    "tree_partition_specs",
]
