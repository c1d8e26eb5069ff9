"""Graph containers of the PyTorch port.

:class:`Graph` is the counterpart of :class:`dfgnn_tpu.graph.Graph`: an
edge list in padded CSR+COO form, the layout of the unfused oracle.  An edge
``e`` connects ``rows[e] -> cols[e]``; edge-softmax normalises over the
edges sharing a row, and aggregation writes to the row node.  Edges are
sorted by row; padded edges carry the sentinel ``rows == cols == n_nodes``.

:class:`DenseBatch` is the counterpart of :class:`dfgnn_tpu.graph.DenseBatch`:
a batch of small graphs, each padded to ``np_pad`` nodes, with a dense
adjacency mask per graph.  Graph b's node i is flat node ``b * np_pad + i``,
so a flat feature tensor lines up with :meth:`DenseBatch.to_graph`'s
block-diagonal :class:`Graph`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from dfgnn_tpu_torch import native
from dfgnn_tpu_torch.device import resolve_device


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def csr_from_coo_plain(rows: np.ndarray, cols: np.ndarray, n: int):
    """The numpy plain version of :func:`native.csr_from_coo`: ``(indptr,
    cols in row order, perm)`` by a stable argsort of the rows."""
    rows, cols = np.asarray(rows, dtype=np.int64), np.asarray(cols, dtype=np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    order = np.argsort(rows, kind="stable")
    return np.cumsum(indptr), cols[order], order


def fill_dense_adj_plain(edge_offsets: np.ndarray, rows: np.ndarray, cols: np.ndarray,
                         P: int) -> np.ndarray:
    """The numpy plain version of :func:`native.fill_dense_adj`."""
    gid = np.repeat(np.arange(len(edge_offsets) - 1), np.diff(edge_offsets))
    adj = np.zeros((len(edge_offsets) - 1, P, P), dtype=np.uint8)
    lo, hi = edge_offsets[0], edge_offsets[-1]
    adj[gid, rows[lo:hi], cols[lo:hi]] = 1
    return adj


@dataclass(frozen=True)
class Graph:
    """A (possibly block-diagonal-batched) graph in padded CSR+COO form.

    Built on the host by :meth:`from_coo`, then moved to a device
    once by :meth:`to`.  ``n_nodes``, ``n_edges`` and ``n_graphs`` are ints.
    """

    indptr: torch.Tensor     # [n_nodes + 1] int64 CSR row pointer (real edges)
    rows: torch.Tensor       # [e_pad] int64, sorted ascending, pad = n_nodes
    cols: torch.Tensor       # [e_pad] int64, pad = n_nodes
    val: Optional[torch.Tensor] = None        # [e_pad] fp32 edge values
    node_mask: Optional[torch.Tensor] = None  # [n_nodes] bool, None = all real
    graph_id: Optional[torch.Tensor] = None   # [n_nodes] int64 batch membership
    n_nodes: int = 0
    n_edges: int = 0  # real edges
    n_graphs: int = 1

    @property
    def e_pad(self) -> int:
        return self.rows.shape[0]

    @property
    def edge_mask(self) -> torch.Tensor:
        """[e_pad] bool: True for real edges."""
        return self.rows < self.n_nodes

    @property
    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    @staticmethod
    def from_coo(rows, cols, n_nodes: int, val=None, *, edge_pad_multiple: int = 128,
                 n_graphs: int = 1, graph_id=None, node_mask=None, sort: bool = True,
                 device="cuda") -> "Graph":
        """Build a padded Graph from COO edge lists on the host, then move it
        to ``device``.  With ``sort`` the edges take a stable sort by row
        (the host library's ``csr_from_coo``), the JAX package's edge order;
        the edge count is padded up to a multiple of ``edge_pad_multiple``."""
        dev = resolve_device(device)
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if rows.shape != cols.shape or rows.ndim != 1:
            raise ValueError("rows and cols must be 1-D of one length")
        n_edges = int(rows.shape[0])
        if val is not None:
            val = np.asarray(val, dtype=np.float32)
        if sort and n_edges > 0:
            indptr, cols, perm = native.csr_from_coo(rows, cols, n_nodes)
            rows = np.repeat(np.arange(n_nodes, dtype=np.int64), np.diff(indptr))
            if val is not None:
                val = val[perm]
        else:
            indptr = np.zeros(n_nodes + 1, dtype=np.int64)
            np.add.at(indptr, rows + 1, 1)
            indptr = np.cumsum(indptr)
        e_pad = max(_round_up(max(n_edges, 1), edge_pad_multiple), edge_pad_multiple)
        rows_p = np.full(e_pad, n_nodes, dtype=np.int64)
        cols_p = np.full(e_pad, n_nodes, dtype=np.int64)
        rows_p[:n_edges] = rows
        cols_p[:n_edges] = cols
        val_p = None
        if val is not None:
            val_p = np.zeros(e_pad, dtype=np.float32)
            val_p[:n_edges] = val
        put = lambda a: None if a is None else torch.from_numpy(np.asarray(a)).to(dev)
        return Graph(
            indptr=put(indptr), rows=put(rows_p), cols=put(cols_p), val=put(val_p),
            node_mask=put(None if node_mask is None else np.asarray(node_mask, dtype=bool)),
            graph_id=put(None if graph_id is None else np.asarray(graph_id, dtype=np.int64)),
            n_nodes=int(n_nodes), n_edges=n_edges, n_graphs=int(n_graphs),
        )

    def to(self, device) -> "Graph":
        """The same graph with its tensors on ``device``."""
        move = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self, indptr=move(self.indptr), rows=move(self.rows), cols=move(self.cols),
            val=move(self.val), node_mask=move(self.node_mask), graph_id=move(self.graph_id))

    def to_csc(self) -> "CSCAux":
        """The column-direction view of the edges, built on the host and put
        on this graph's device: the edges sorted stably by column, with the
        permutation back to CSR edge ids (the reference's CSC + ``val_idx``
        arrays).  Padded entries carry ``n_nodes``; ``edge_perm`` pads with
        ``e_pad - 1``."""
        rows = self.rows[: self.n_edges].cpu().numpy()
        cols = self.cols[: self.n_edges].cpu().numpy()
        order = np.argsort(cols, kind="stable")
        col_ptr = np.zeros(self.n_nodes + 1, dtype=np.int64)
        np.add.at(col_ptr, cols + 1, 1)
        e_pad = self.e_pad
        perm = np.full(e_pad, e_pad - 1, dtype=np.int64)
        perm[: self.n_edges] = order
        rows_csc = np.full(e_pad, self.n_nodes, dtype=np.int64)
        rows_csc[: self.n_edges] = rows[order]
        cols_csc = np.full(e_pad, self.n_nodes, dtype=np.int64)
        cols_csc[: self.n_edges] = cols[order]
        put = lambda a: torch.from_numpy(a).to(self.rows.device)
        return CSCAux(col_ptr=put(np.cumsum(col_ptr)), rows=put(rows_csc), cols=put(cols_csc),
                      edge_perm=put(perm))


@dataclass(frozen=True)
class CSCAux:
    """Column-direction (transposed) view of a Graph's edges."""

    col_ptr: torch.Tensor    # [n_nodes + 1] int64
    rows: torch.Tensor       # [e_pad] int64, source node per CSC-ordered edge
    cols: torch.Tensor       # [e_pad] int64, sorted ascending
    edge_perm: torch.Tensor  # [e_pad] int64, CSC edge -> CSR edge id


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
        """Collate a list of (rows, cols, n_nodes) tuples on the host (the
        adjacency by the host library's ``fill_dense_adj``), then move the
        batch to ``device`` in one copy per tensor."""
        dev = resolve_device(device)
        max_n = max(g[2] for g in graphs)
        if np_pad is None:
            np_pad = max(_round_up(max_n, 128), 128)
        if max_n > np_pad:
            raise ValueError(f"a graph has {max_n} nodes, more than np_pad={np_pad}")
        B = len(graphs)
        mask = np.zeros((B, np_pad), dtype=bool)
        for b, (_, _, n) in enumerate(graphs):
            mask[b, :n] = True
        offs = np.concatenate([[0], np.cumsum([len(r) for r, _, _ in graphs])])
        rows = np.concatenate([np.asarray(r, dtype=np.int64) for r, _, _ in graphs])
        cols = np.concatenate([np.asarray(c, dtype=np.int64) for _, c, _ in graphs])
        adj = native.fill_dense_adj(offs, rows, cols, np_pad)
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

    def to_graph(self) -> Graph:
        """The equivalent flattened block-diagonal :class:`Graph`, on this
        batch's device: graph b's edge r -> c becomes b*P + r -> b*P + c.
        Built in numpy on the host, as the JAX package builds it; edge
        values are not carried, as there."""
        adj = self.adj.cpu().numpy()
        B, P, _ = adj.shape
        b, r, c = np.nonzero(adj)
        return Graph.from_coo(
            b * P + r, b * P + c, n_nodes=B * P, n_graphs=B,
            graph_id=np.repeat(np.arange(B), P),
            node_mask=self.node_mask.cpu().numpy().reshape(-1),
            device=self.adj.device,
        )
