"""Device meshes and data parallelism over batches of small graphs.

The counterpart of :mod:`dfgnn_tpu.parallel.dist`.  One process runs per
device (``torchrun``), so where JAX places a global array with a sharding,
a rank here holds its own block: :func:`shard_dense_batch` returns this
rank's graphs and :func:`batch_sharding` cuts this rank's rows of a
leading-dim array.  Parameters start equal on every rank (:func:`replicate`)
and ``torch.nn.parallel.DistributedDataParallel`` all-reduces the gradients,
the step GSPMD builds for the JAX package.  One large graph is partitioned
by destination rows instead (:mod:`.partition`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.parallel.comm import broadcast_


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device="cuda") -> DeviceMesh:
    """A 1-D mesh named ``axis`` over the first ``n_devices`` ranks of the
    world (all of them by default).  Every rank makes it; a rank outside it
    gets a mesh whose ``get_coordinate()`` is None."""
    dev = resolve_device(device)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n} outside 1..{world} (the world size)")
    return DeviceMesh(dev.type, torch.arange(n), mesh_dim_names=(axis,))


def mesh_group_rank(mesh: DeviceMesh, axis: Optional[str] = None):
    """``(process group, rank in it)`` of ``mesh``'s dim ``axis`` (its only
    dim when None)."""
    if axis is None or mesh.ndim == 1:
        return mesh.get_group(), mesh.get_local_rank()
    return mesh.get_group(axis), mesh.get_local_rank(axis)


def replicate(tree, mesh: DeviceMesh):
    """Module parameters and buffers, or a tensor, or a list, tuple or dict of
    tensors, overwritten in place by rank 0's of ``mesh`` (a broadcast); returns
    ``tree``."""
    group, _ = mesh_group_rank(mesh)
    if isinstance(tree, torch.nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    elif isinstance(tree, torch.Tensor):
        tensors = [tree]
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    for t in tensors:
        broadcast_(t.data, 0, group)
    return tree


def batch_sharding(mesh: DeviceMesh, axis: str = "data") -> Callable[[torch.Tensor],
                                                                     torch.Tensor]:
    """The cut of this rank's block of a leading-dim (graph or batch) array:
    equal contiguous blocks in rank order, as JAX's ``P(axis)`` sharding
    lays them out."""
    _, r = mesh_group_rank(mesh, axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))

    def cut(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % n:
            raise ValueError(f"leading dim {x.shape[0]} not divisible by {n} ranks")
        per = x.shape[0] // n
        return x[r * per: (r + 1) * per]
    return cut


def shard_dense_batch(batch: DenseBatch, mesh: DeviceMesh, axis: str = "data") -> DenseBatch:
    """This rank's graphs of ``batch``; ``n_graphs`` must divide by the
    mesh size along ``axis``."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if batch.n_graphs % n:
        raise ValueError((batch.n_graphs, n))
    cut = batch_sharding(mesh, axis)
    adj, node_mask = cut(batch.adj), cut(batch.node_mask)
    return DenseBatch(
        adj=adj, node_mask=node_mask,
        val=None if batch.val is None else cut(batch.val),
        n_graphs=batch.n_graphs // n, np_pad=batch.np_pad,
        n_edges=int(torch.count_nonzero(adj)), n_nodes=int(node_mask.sum()),
    )
