"""Batched dense masked attention over small graphs, in plain PyTorch.

The counterpart of :mod:`dfgnn_tpu.ops.dense_block`: each graph's SDDMM ->
edge-softmax -> SpMM runs as two batched products with an adjacency mask.
It is the oracle of the flash kernel and the ``method="dense"`` path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.ops.reference import NEG_BIG, attn_dropout


def dense_scores(
    batch: DenseBatch,
    q: Optional[torch.Tensor],
    k: Optional[torch.Tensor],
    *,
    score: str = "dot",
    e_row: Optional[torch.Tensor] = None,
    e_col: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """Masked dense score tensor ``[B, h, P, P]`` (pad entries = -BIG)."""
    if score == "dot":
        s = torch.einsum("brhf,bchf->bhrc", q, k)
    elif score == "add":
        # e_row/e_col: [B, P, h]
        s = e_row.permute(0, 2, 1)[:, :, :, None] + e_col.permute(0, 2, 1)[:, :, None, :]
        s = F.leaky_relu(s, negative_slope)
    else:
        raise ValueError(f"unknown score mode {score!r}")
    if batch.val is not None:
        s = s * batch.val[:, None]
    return torch.where(batch.adj[:, None].bool(), s, NEG_BIG)


def dense_graph_attention(
    batch: DenseBatch,
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
):
    """Masked attention.  ``q, k, v``: ``[B, P, h, f]`` -> ``[B, P, h, f]``;
    rows with no edges produce zeros.

    ``dropout_rate > 0`` drops normalised attention weights with
    :func:`dfgnn_tpu_torch.ops.reference.attn_dropout`, a draw from
    ``dropout_generator`` that matches the JAX package in distribution only.

    ``return_weights=True`` also returns the normalised pre-dropout
    attention weights ``[B, h, P, P]``."""
    s = dense_scores(
        batch, q, k, score=score, e_row=e_row, e_col=e_col,
        negative_slope=negative_slope,
    )
    adj = batch.adj[:, None].bool()
    m = s.amax(dim=-1, keepdim=True)
    ex = torch.where(adj, torch.exp(s - m.clamp_min(NEG_BIG)), 0.0)
    den = ex.sum(dim=-1, keepdim=True)
    w = torch.where(den > 0, ex / torch.where(den > 0, den, 1.0), 0.0)
    w_clean = w
    if dropout_rate > 0.0:
        w = attn_dropout(w, dropout_rate, dropout_generator)
    # JAX promotes a mixed product (fp32 weights of GAT's fp32 scores with a
    # bf16 v) to fp32; torch's einsum refuses mixed operands
    dt = torch.promote_types(w.dtype, v.dtype)
    out = torch.einsum("bhrc,bchf->brhf", w.to(dt), v.to(dt))
    if return_weights:
        return out, w_clean
    return out
