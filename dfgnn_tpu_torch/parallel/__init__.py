"""The multi-device layer of the port, over ``torch.distributed``.

One process runs per device (``torchrun``); every function takes its process
group or device mesh explicitly, and a rank holds and returns its own block.

``partition``  the edge-partitioned full graph: the host-side plan
               (``partition_graph`` with its halo, segment, transpose, balance
               and reorder flavours) and ``dist_graph_attention``, its
               exchanges, the shared segments' merge and the fused
               distributed backward
``comm``       the collectives, each with its transpose for autograd
``dist``       meshes and data parallelism over batches of small graphs
``tensor``     head-sharded attention (tensor parallelism)
``multihost``  the process group from torchrun's environment
"""

from dfgnn_tpu_torch.parallel.balance import balance_perm
from dfgnn_tpu_torch.parallel.dist import (
    batch_sharding, make_mesh, replicate, shard_dense_batch,
)
from dfgnn_tpu_torch.parallel.multihost import initialize, process_local_batch
from dfgnn_tpu_torch.parallel.partition import (
    EdgePartitionedGraph, HaloExchange, SharedSegments, dist_graph_attention, gather_nodes,
    partition_graph, shard_nodes,
)
from dfgnn_tpu_torch.parallel.reorder import bfs_reorder, lpa_reorder, reorder_graph
from dfgnn_tpu_torch.parallel.tensor import (
    head_sharded_attention, make_tp_mesh, shard_params_tp,
)

__all__ = ["EdgePartitionedGraph", "HaloExchange", "SharedSegments", "balance_perm",
           "batch_sharding", "bfs_reorder", "dist_graph_attention", "gather_nodes",
           "head_sharded_attention", "initialize", "lpa_reorder", "make_mesh",
           "make_tp_mesh", "partition_graph", "process_local_batch", "reorder_graph",
           "replicate", "shard_dense_batch", "shard_nodes", "shard_params_tp"]
