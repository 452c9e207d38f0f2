"""Distribution layer of the port: the logical-axis partition rules
(``repro/parallel/partition.py``) on a layout grid and, through
``torch.distributed.tensor``, on a ``DeviceMesh`` of real devices
(``to_placements``, ``tree_shardings``, ``activation_sharding``,
``shard``, ``on_mesh``), and gradient compression (``collectives``). Expert
parallelism and sharded training come with ROADMAP item 16b.

The reference's ``parallel/tracing.py`` is not ported: its one job is to
unroll ``lax.scan`` while tracing, so that XLA's ``cost_analysis`` counts a
loop body once a trip. The port has no rolled loops: it runs eagerly, and
the dry-run's meta pass (``launch/counter.py``) sees every layer, chunk and
step as it runs, so its counts are trip-exact without a switch."""

from repro_torch.parallel.collectives import compress_grads
from repro_torch.parallel.partition import (
    LayoutGrid,
    PartitionSpec,
    Sharding,
    activation_sharding,
    current_mesh,
    grid_of,
    layout_grid,
    on_mesh,
    shard,
    spec_for_axes,
    to_placements,
    tree_partition_specs,
    tree_shardings,
)

__all__ = [
    "compress_grads",
    "LayoutGrid",
    "PartitionSpec",
    "Sharding",
    "activation_sharding",
    "current_mesh",
    "grid_of",
    "layout_grid",
    "on_mesh",
    "shard",
    "spec_for_axes",
    "to_placements",
    "tree_partition_specs",
    "tree_shardings",
]
