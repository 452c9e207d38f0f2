"""Distribution layer of the port: the logical-axis partition rules on a
layout grid (``repro/parallel/partition.py``) and gradient compression
(``collectives``). Placement on real devices waits for the materialized
elastic cell (ROADMAP Queue 1, item 16).

The reference's ``parallel/tracing.py`` is not ported: its one job is to
unroll ``lax.scan`` while tracing, so that XLA's ``cost_analysis`` counts a
loop body once a trip. The port has no rolled loops: it runs eagerly, and
the dry-run's meta pass (``launch/counter.py``) sees every layer, chunk and
step as it runs, so its counts are trip-exact without a switch."""

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
