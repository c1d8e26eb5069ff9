"""Single entry point dispatching on graph layout.

The counterpart of :mod:`dfgnn_tpu.ops.dispatch`.  The :class:`DenseBatch`,
:class:`Graph`, :class:`BucketedGraph`, :class:`BlockedBucketedGraph` and
:class:`SampledBlock` layouts are ported; ``method`` names the same
implementations as in the JAX package.
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
    they take the shape (:func:`flash_mask.flash_takes`: any head dim up to
    256 and P up to 2048, on either score) and the dense formulation
    elsewhere; ``return_weights=True``
    always takes the dense formulation, the one that materialises weights.
    On a :class:`Graph`, ``auto`` and ``reference`` run the unfused
    segment-op oracle.  On a :class:`BucketedGraph` or
    :class:`BlockedBucketedGraph`, ``auto`` and ``bucket`` run the fused
    bucket path (:mod:`dfgnn_tpu_torch.ops.bucket`).  On a
    :class:`SampledBlock`, ``auto``, ``sampled`` and ``bucket`` run
    :func:`sampled_block_attention`, which has neither dropout nor
    ``return_weights`` (both raise).
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
    if not isinstance(g, DenseBatch):
        raise NotImplementedError(
            f"graph layout {type(g).__name__} is not ported yet: the edge-partitioned "
            "graph comes with ROADMAP.md queue 1 item 10.")
    if method == "auto":
        method = "flash" if flash_mask.flash_takes(score, g.np_pad, v.shape[-1]) else "dense"
    if method == "flash" and not return_weights:
        return flash_mask.flash_graph_attention(g, q, k, v, **kw)
    if method in ("dense", "flash", "reference"):
        return _dense.dense_graph_attention(g, q, k, v, **kw,
                                            return_weights=return_weights)
    raise ValueError(f"method {method!r} invalid for DenseBatch")
