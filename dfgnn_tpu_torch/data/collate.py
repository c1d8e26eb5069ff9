"""Batched-graph collation and mini-batch iteration.

The counterpart of :mod:`dfgnn_tpu.data.collate`: a batch of graphs
collates into a :class:`DenseBatch` (padded per-graph dense masks) plus flat
feature and label tensors whose node order matches ``b * np_pad + i``.
Collation runs in numpy on the host; each tensor then moves to ``device``
once.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from dfgnn_tpu_torch.data.datasets import BatchedGraphDataset
from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.graph import DenseBatch


def collate_dense(
    ds: BatchedGraphDataset,
    idx,
    np_pad: Optional[int] = None,
    *,
    device="cuda",
):
    """Collate graphs ``idx`` -> (DenseBatch, features, labels, label_mask).

    Features are flat ``[B * np_pad, ...]`` with zero pad rows; node-level
    labels are flat with -1 padding; graph-level labels are ``[B, ...]``.
    All four live on ``device``.
    """
    dev = resolve_device(device)
    graphs = [ds.graphs[i] for i in idx]
    batch = DenseBatch.from_graph_list(
        [(r, c, n) for (r, c, n) in graphs], np_pad=np_pad, device=dev
    )
    B, Pp = batch.n_graphs, batch.np_pad

    f0 = ds.node_features[idx[0]]
    feat_shape = f0.shape[1:] if f0.ndim > 1 else ()
    feats = np.zeros((B * Pp, *feat_shape), dtype=f0.dtype)
    for b, i in enumerate(idx):
        n = graphs[b][2]
        feats[b * Pp : b * Pp + n] = ds.node_features[i]

    if ds.task == "node_classification":
        labels = np.full(B * Pp, -1, dtype=np.int64)
        for b, i in enumerate(idx):
            n = graphs[b][2]
            labels[b * Pp : b * Pp + n] = ds.labels[i]
        label_mask = labels >= 0
    else:
        labels = np.asarray([ds.labels[i] for i in idx])
        label_mask = np.ones(len(idx), bool)
    return (batch, torch.from_numpy(feats).to(dev), torch.from_numpy(labels).to(dev),
            torch.from_numpy(label_mask).to(dev))


def batch_iterator(
    ds: BatchedGraphDataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    np_pad: Optional[int] = None,
    seed: int = 0,
    drop_last: bool = True,
    device="cuda",
) -> Iterator:
    """Batches of ``batch_size`` graphs in order (or shuffled from ``seed``),
    each collated by :func:`collate_dense` onto ``device``."""
    order = np.arange(len(ds))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    stop = len(ds) - (len(ds) % batch_size if drop_last else 0)
    for s in range(0, stop, batch_size):
        idx = order[s : s + batch_size]
        if len(idx) == 0:
            break
        yield collate_dense(ds, idx, np_pad=np_pad, device=device)
