"""Unfused oracle ops: SDDMM, edge-softmax, SpMM via segment reductions.

The counterpart of :mod:`dfgnn_tpu.ops.reference`, the framework's
correctness oracle: plain PyTorch gathers and segment reductions
(``scatter_reduce`` for the row max, ``index_add`` for the sums) over a
:class:`Graph`, differentiable by autograd, on any device.

Conventions (see :mod:`dfgnn_tpu_torch.graph`): scores, softmax and
aggregation are per **row**; ``q`` lives on rows, ``k``/``v`` on cols.
Features are ``[n_nodes, heads, head_dim]``; edge scores ``[e_pad, heads]``.
Segment reductions take one extra segment, ``n_nodes``, that collects the
padded edges and is dropped.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from dfgnn_tpu_torch.graph import Graph

NEG_BIG = -1e30


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather that clips the sentinel pad index (padded lanes are masked
    downstream), as ``jnp.take(mode="clip")``."""
    return x[idx.clamp_max(x.shape[0] - 1)]


def sddmm_dot(g: Graph, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-edge dot scores ``<q[rows_e], k[cols_e]>``, times ``g.val`` when
    present.  Returns ``[e_pad, heads]``."""
    scores = torch.einsum("ehf,ehf->eh", _gather(q, g.rows), _gather(k, g.cols))
    if g.val is not None:
        scores = scores * g.val[:, None]
    return scores


def sddmm_add(g: Graph, e_row: torch.Tensor, e_col: torch.Tensor,
              negative_slope: float = 0.2) -> torch.Tensor:
    """GAT additive scores ``leaky_relu(e_row[rows_e] + e_col[cols_e])`` from
    per-node per-head scalars ``[n, h]``."""
    return F.leaky_relu(_gather(e_row, g.rows) + _gather(e_col, g.cols), negative_slope)


def edge_softmax(g: Graph, scores: torch.Tensor) -> torch.Tensor:
    """Numerically stable softmax over each row's edges; rows without edges
    give 0 (the zero-degree guard of the reference's fused kernels)."""
    n_seg = g.n_nodes + 1
    mask = g.edge_mask[:, None]
    s = torch.where(mask, scores, NEG_BIG)
    idx = g.rows[:, None].expand_as(s)
    # the initial NEG_BIG plays JAX's maximum(segment_max, NEG_BIG)
    row_max = s.new_full((n_seg, s.shape[1]), NEG_BIG).scatter_reduce(
        0, idx, s, reduce="amax", include_self=True)
    ex = torch.where(mask, torch.exp(s - _gather(row_max, g.rows)), 0.0)
    den = ex.new_zeros((n_seg, ex.shape[1])).index_add(0, g.rows, ex)
    den_e = _gather(den, g.rows)
    return torch.where(den_e > 0, ex / torch.where(den_e > 0, den_e, 1.0), 0.0)


def spmm(g: Graph, weights: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Weighted neighbour aggregation ``out[r] = sum_e w_e * v[cols_e]``.
    Returns ``[n_nodes, h, f]``."""
    contrib = weights[:, :, None] * _gather(v, g.cols)
    out = contrib.new_zeros((g.n_nodes + 1, *contrib.shape[1:])).index_add(0, g.rows, contrib)
    return out[: g.n_nodes]


def attn_dropout(w: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Dropout on normalised attention weights with ``1 / (1 - rate)``
    rescaling.  The draw comes from ``generator`` on its own device and
    cannot reproduce JAX's ``jax.random.bernoulli``, so this matches the JAX
    package in distribution only."""
    if generator is None:
        raise ValueError("dropout_rate > 0 requires dropout_generator")
    draw = torch.rand(w.shape, generator=generator, device=generator.device)
    keep = draw.to(w.device) < 1.0 - rate
    return torch.where(keep, w / (1.0 - rate), 0.0)


def graph_attention_reference(
    g: Graph,
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
    """Full unfused SDDMM -> edge-softmax -> SpMM attention convolution.

    ``score='dot'``: GT/AGNN/DotGAT scoring from ``q``/``k``.
    ``score='add'``: GAT scoring from per-node scalars ``e_row``/``e_col``.
    ``return_weights=True`` also returns the weights ``[e_pad, h]`` (after
    dropout, as the JAX package returns them).
    """
    if score == "dot":
        scores = sddmm_dot(g, q, k)
    elif score == "add":
        scores = sddmm_add(g, e_row, e_col, negative_slope)
        if g.val is not None:
            scores = scores * g.val[:, None]
    else:
        raise ValueError(f"unknown score mode {score!r}")
    w = edge_softmax(g, scores)
    if dropout_rate > 0.0:
        w = attn_dropout(w, dropout_rate, dropout_generator)
    out = spmm(g, w, v)
    if return_weights:
        return out, w
    return out
