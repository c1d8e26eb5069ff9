"""The multi-device layer of the port: the edge-partitioned plan.

The host-side plan of :mod:`dfgnn_tpu.parallel` in numpy (``partition_graph``
with its halo, segment, transpose, balance and reorder flavours).  The
exchanges over ``torch.distributed``, the distributed forward and backward,
and the counterparts of ``make_mesh``, ``shard_dense_batch`` and
``replicate`` are ROADMAP.md queue 1 item 10b.
"""

from dfgnn_tpu_torch.parallel.balance import balance_perm
from dfgnn_tpu_torch.parallel.partition import (
    EdgePartitionedGraph, HaloExchange, SharedSegments, partition_graph,
)
from dfgnn_tpu_torch.parallel.reorder import bfs_reorder, lpa_reorder, reorder_graph

__all__ = ["EdgePartitionedGraph", "HaloExchange", "SharedSegments", "balance_perm",
           "bfs_reorder", "lpa_reorder", "partition_graph", "reorder_graph"]
