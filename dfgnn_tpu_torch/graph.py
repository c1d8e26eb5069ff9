"""Graph containers of the PyTorch port.

:class:`DenseBatch` is the counterpart of :class:`dfgnn_tpu.graph.DenseBatch`:
a batch of small graphs, each padded to ``np_pad`` nodes, with a dense
adjacency mask per graph.  Graph b's node i is flat node ``b * np_pad + i``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from dfgnn_tpu_torch.device import resolve_device


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class DenseBatch:
    """Batch of small graphs as dense per-graph adjacency masks.

    ``adj`` is stored as uint8 (1 = edge r -> c), the type the attention
    kernel reads, so a batch moved once with :meth:`to` costs no conversion
    per call.
    """

    adj: torch.Tensor        # [B, np_pad, np_pad] uint8; adj[b, r, c] = edge r->c
    node_mask: torch.Tensor  # [B, np_pad] bool
    val: Optional[torch.Tensor] = None  # [B, np_pad, np_pad] fp32 edge values
    n_graphs: int = 0
    np_pad: int = 0
    n_edges: int = 0
    n_nodes: int = 0  # real nodes

    @staticmethod
    def from_graph_list(graphs, np_pad: Optional[int] = None, *,
                        device="cuda") -> "DenseBatch":
        """Collate a list of (rows, cols, n_nodes) tuples in numpy on the
        host, then move the batch to ``device`` in one copy per tensor."""
        dev = resolve_device(device)
        max_n = max(g[2] for g in graphs)
        if np_pad is None:
            np_pad = max(_round_up(max_n, 128), 128)
        if max_n > np_pad:
            raise ValueError(f"a graph has {max_n} nodes, more than np_pad={np_pad}")
        B = len(graphs)
        adj = np.zeros((B, np_pad, np_pad), dtype=np.uint8)
        mask = np.zeros((B, np_pad), dtype=bool)
        for b, (_, _, n) in enumerate(graphs):
            mask[b, :n] = True
        gid = np.concatenate([np.full(len(r), b, dtype=np.int64)
                              for b, (r, _, _) in enumerate(graphs)])
        rows = np.concatenate([np.asarray(r, dtype=np.int64) for r, _, _ in graphs])
        cols = np.concatenate([np.asarray(c, dtype=np.int64) for _, c, _ in graphs])
        adj[gid, rows, cols] = 1
        return DenseBatch(
            adj=torch.from_numpy(adj).to(dev),
            node_mask=torch.from_numpy(mask).to(dev),
            n_graphs=B,
            np_pad=int(np_pad),
            n_edges=int(np.count_nonzero(adj)),
            n_nodes=int(mask.sum()),
        )

    def to(self, device) -> "DenseBatch":
        """The same batch with its tensors on ``device``."""
        return dataclasses.replace(
            self,
            adj=self.adj.to(device),
            node_mask=self.node_mask.to(device),
            val=None if self.val is None else self.val.to(device),
        )

    def replace(self, **changes) -> "DenseBatch":
        return dataclasses.replace(self, **changes)
