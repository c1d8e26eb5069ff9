"""Single entry point dispatching on graph layout.

The counterpart of :mod:`dfgnn_tpu.ops.dispatch`.  Every layout is ported:
:class:`DenseBatch`, :class:`Graph`, :class:`BucketedGraph`,
:class:`BlockedBucketedGraph`, :class:`SampledBlock` and the
edge-partitioned graph; ``method`` names the same implementations as in the
JAX package.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from dfgnn_tpu_torch.data.sampling import SampledBlock, sampled_block_attention
from dfgnn_tpu_torch.formats import BlockedBucketedGraph, BucketedGraph
from dfgnn_tpu_torch.graph import DenseBatch, Graph
from dfgnn_tpu_torch.ops import bucket as _bucket
from dfgnn_tpu_torch.ops import dense_block as _dense
from dfgnn_tpu_torch.ops import flash_mask
from dfgnn_tpu_torch.ops import reference as _ref
from dfgnn_tpu_torch.ops.edge_dropout import seed_from_generator


def graph_attention(
    g,
    q: Optional[torch.Tensor],
    k: Optional[torch.Tensor],
    v: torch.Tensor,
    *,
    score: str = "dot",
    e_row: Optional[torch.Tensor] = None,
    e_col: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    dropout_rate: float = 0.0,
    dropout_generator: Optional[torch.Generator] = None,
    return_weights: bool = False,
    method: str = "auto",
):
    """Fused (or oracle) SDDMM -> edge-softmax -> SpMM attention convolution.

    On a :class:`DenseBatch`, ``flash`` runs the flash kernels, ``dense`` and
    ``reference`` the dense formulation, and ``auto`` the flash kernels where
    they take the shape (:func:`flash_mask.flash_takes`: any head dim and
    any P, on either score, so every shape, as JAX takes Pallas) and the
    dense formulation elsewhere; ``return_weights=True`` always takes the
    dense formulation, the one that materialises weights.
    On a :class:`Graph`, ``auto`` and ``reference`` run the unfused
    segment-op oracle.  On a :class:`BucketedGraph` or
    :class:`BlockedBucketedGraph`, ``auto`` and ``bucket`` run the fused
    bucket path (:mod:`dfgnn_tpu_torch.ops.bucket`).  On a
    :class:`SampledBlock`, ``auto``, ``sampled`` and ``bucket`` run
    :func:`sampled_block_attention`, which has neither dropout nor
    ``return_weights`` (both raise).  On an
    :class:`~dfgnn_tpu_torch.parallel.EdgePartitionedGraph` placed on a mesh
    (``partition_graph(..., mesh=...)``), ``auto`` and ``dist`` run
    :func:`~dfgnn_tpu_torch.parallel.dist_graph_attention` on this rank's
    block of rows (dropout seeded from ``dropout_generator``, which must give
    the same seed on every rank); ``return_weights`` raises.
    The ``DFGNN_TPU_FORCE_METHOD`` environment variable overrides
    ``method="auto"``.
    """
    if method == "auto":
        method = os.environ.get("DFGNN_TPU_FORCE_METHOD", "auto")
    kw = dict(score=score, e_row=e_row, e_col=e_col, negative_slope=negative_slope,
              dropout_rate=dropout_rate, dropout_generator=dropout_generator)
    if isinstance(g, Graph):
        if method in ("auto", "reference"):
            return _ref.graph_attention_reference(g, q, k, v, **kw,
                                                  return_weights=return_weights)
        raise ValueError(f"method {method!r} invalid for Graph")
    if isinstance(g, (BucketedGraph, BlockedBucketedGraph)):
        if method in ("auto", "bucket"):
            return _bucket.bucket_graph_attention(g, q, k, v, **kw,
                                                  return_weights=return_weights)
        raise ValueError(f"method {method!r} invalid for {type(g).__name__}")
    if isinstance(g, SampledBlock):
        if return_weights:
            raise NotImplementedError(
                "return_weights is not available on the sampled-block path")
        if dropout_rate > 0.0:
            raise NotImplementedError(
                "attention dropout is not implemented on the sampled-block "
                "path (never silently ignored)")
        if method in ("auto", "sampled", "bucket"):
            return sampled_block_attention(g, q, k, v, score=score, e_row=e_row, e_col=e_col,
                                           negative_slope=negative_slope)
        raise ValueError(f"method {method!r} invalid for SampledBlock")
    from dfgnn_tpu_torch.parallel.partition import EdgePartitionedGraph, dist_graph_attention

    if isinstance(g, EdgePartitionedGraph):
        if return_weights:
            raise NotImplementedError("return_weights is not available on the distributed path")
        if g.mesh is None:
            raise ValueError("EdgePartitionedGraph needs mesh= set "
                             "(partition_graph(..., mesh=mesh))")
        if method in ("auto", "dist"):
            seed = (seed_from_generator(dropout_generator)
                    if dropout_rate > 0.0 and dropout_generator is not None else None)
            return dist_graph_attention(g, g.mesh, q, k, v, score=score, e_row=e_row,
                                        e_col=e_col, negative_slope=negative_slope,
                                        axis=g.axis, dropout_rate=dropout_rate,
                                        dropout_seed=seed)
        raise ValueError(f"method {method!r} invalid for EdgePartitionedGraph")
    if not isinstance(g, DenseBatch):
        raise TypeError(f"unsupported graph layout {type(g)!r}")
    if method == "auto":
        method = "flash" if flash_mask.flash_takes(score, g.np_pad, v.shape[-1]) else "dense"
    if method == "flash" and not return_weights:
        return flash_mask.flash_graph_attention(g, q, k, v, **kw)
    if method in ("dense", "flash", "reference"):
        return _dense.dense_graph_attention(g, q, k, v, **kw,
                                            return_weights=return_weights)
    raise ValueError(f"method {method!r} invalid for DenseBatch")
