"""Format registry: a Graph converted into the layout a strategy consumes.

A copy of :mod:`dfgnn_tpu.formats`.  The layouts are built on the host in
numpy, as the JAX package builds them, and moved to the graph's device once:

* ``bucketed``   degree-bucketed padded neighbour lists of one full graph
                 (the reference's csr / softmax / tiling strategies): rows of
                 similar degree share a bucket of one width; rows wider than
                 ``split_width`` are laid out as fixed-width segments merged
                 by online softmax; ``with_transpose`` adds the transposed
                 layout the fused custom backward walks.
* ``reference``  the raw :class:`Graph` itself (the unfused oracle).

The containers are frozen dataclasses of tensors with ``.to(device)``, as
:class:`Graph` is.  Index arrays are int64 on the device (their values equal
the JAX package's int32 arrays); the builders fill them in numpy.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dfgnn_tpu_torch.graph import Graph, _round_up


def _move(x, device):
    """A numpy array or tensor as a tensor on ``device``; integer ids become
    int64, the index type of torch's gathers and scatters."""
    if x is None:
        return None
    t = torch.as_tensor(x)
    if not t.is_floating_point() and t.dtype != torch.bool:
        t = t.long()
    return t.to(device)


def _to(obj, device):
    """``obj`` with every array field moved to ``device`` (nested layouts too)."""
    changes = {}
    for f in dataclasses.fields(obj):
        x = getattr(obj, f.name)
        if isinstance(x, tuple):
            changes[f.name] = tuple(b.to(device) for b in x)
        elif dataclasses.is_dataclass(x):
            changes[f.name] = x.to(device)
        elif isinstance(x, (np.ndarray, torch.Tensor)):
            changes[f.name] = _move(x, device)
    return dataclasses.replace(obj, **changes)


@dataclass(frozen=True)
class Bucket:
    """Rows whose degree falls in one bucket, with padded neighbour lists.

    ``row_ids`` is padded with the sentinel ``n_nodes`` (writes land in a
    scratch row that is dropped); ``nbr`` is padded with ``n_nodes`` (gathers
    clip; lanes masked by ``emask``).  ``edge_ids`` (with ``with_edge_ids``)
    holds the CSR edge index per lane, sentinel ``e_pad``, so fused paths can
    scatter per-edge weights back to edge order.
    """

    row_ids: torch.Tensor   # [r_pad] int
    nbr: torch.Tensor       # [r_pad, width] int
    emask: torch.Tensor     # [r_pad, width] bool
    val: Optional[torch.Tensor] = None       # [r_pad, width] fp32
    edge_ids: Optional[torch.Tensor] = None  # [r_pad, width] int
    width: int = 0
    n_rows: int = 0  # real rows
    row_chunk: int = 0

    def to(self, device) -> "Bucket":
        return _to(self, device)


@dataclass(frozen=True)
class SegmentBucket:
    """Fixed-width segments of super-wide rows (degree > ``split_width``).

    A row of degree d occupies ``ceil(d / width)`` consecutive segments.
    Per-segment partial softmax states (m, l, acc) are merged per row with the
    online-softmax combine (the reference tiling kernel's rescale algebra).
    ``seg_id`` maps each segment to its compact wide-row index (sorted; padding
    uses the bin ``n_rows``); ``seg_dst`` / ``wide_rows`` give destination
    node ids per segment / per compact row.
    """

    nbr: torch.Tensor        # [s_pad, width] int (pad: n_cols sentinel)
    emask: torch.Tensor      # [s_pad, width] bool
    seg_id: torch.Tensor     # [s_pad] int, sorted; pad = n_rows
    seg_dst: torch.Tensor    # [s_pad] int destination node id (pad sentinel)
    wide_rows: torch.Tensor  # [n_rows] int destination node per compact row
    val: Optional[torch.Tensor] = None       # [s_pad, width] fp32
    edge_ids: Optional[torch.Tensor] = None  # [s_pad, width] int (see Bucket)
    width: int = 0
    n_rows: int = 0
    n_segments: int = 0  # real
    row_chunk: int = 0

    def to(self, device) -> "SegmentBucket":
        return _to(self, device)


@dataclass(frozen=True)
class BucketedGraph:
    """Degree-bucketed padded-CSR layout of one (full) graph.

    ``transpose`` (rows = sources) enables the fused custom backward;
    ``e_pad > 0`` iff the layout carries edge ids (``return_weights``).
    """

    buckets: Tuple[Bucket, ...]
    n_nodes: int = 0
    n_edges: int = 0
    graph_id: Optional[torch.Tensor] = None
    n_graphs: int = 1
    segments: Optional[SegmentBucket] = None
    transpose: Optional["BucketedGraph"] = None
    e_pad: int = 0

    def to(self, device) -> "BucketedGraph":
        return _to(self, device)

    @property
    def padded_edges(self) -> int:
        tot = sum(b.row_ids.shape[0] * b.width for b in self.buckets)
        if self.segments is not None:
            tot += self.segments.nbr.shape[0] * self.segments.width
        return tot


@dataclass(frozen=True)
class BlockedBucketedGraph:
    """Source-blocked bucketed layout.

    The source nodes are split into blocks of ``block_rows``, and each row's
    edges are grouped by source block, so every gather reads one sub-table of
    ``block_rows`` rows; the per-block partial rows merge exactly through
    their logsumexps (the online-softmax combine across blocks).  Whether
    that pays depends on the card's gather rate against the table's size
    (``_AUTO_BLOCK_ABOVE``).

    ``blocks[b]`` is a :class:`BucketedGraph` over the same row space whose
    ``nbr`` ids are rebased to block-local (sentinel ``block_rows``); rows
    with no edge in a block are absent from its buckets (their lse stays
    -1e30 and their merge weight is 0).
    """

    blocks: Tuple[BucketedGraph, ...]
    block_rows: int = 0
    n_nodes: int = 0
    n_edges: int = 0
    graph_id: Optional[torch.Tensor] = None
    n_graphs: int = 1
    transpose: Optional["BlockedBucketedGraph"] = None
    e_pad: int = 0

    def to(self, device) -> "BlockedBucketedGraph":
        return _to(self, device)

    @property
    def padded_edges(self) -> int:
        return sum(b.padded_edges for b in self.blocks)


# Edge budget per compute chunk (rows-at-once x bucket width), the rows a
# bucket's or segment layout's padding rounds to.
_EDGE_CHUNK = 1 << 15

# Source-block size (rows) and the node count above which build_buckets
# blocks on its own, from the gather probe twin's table sweep
# (scripts/microbench_gather.py, ROADMAP.md queue 1 item 7) on an NVIDIA H100
# 80GB HBM3 at 700 W: torch.index_select of 64 Ki rows took 0.67 to 0.70 ns
# a 512 B row at every table size from 16 MB to 1 GB, and 0.67 ns a 1 KB row
# within the 50 MB L2 against 0.73 to 0.79 ns beyond it.  Blocking pays that
# at most 19% back and costs padded lanes (each block pads every row it
# touches), so auto keeps the flat layout (None).  _SRC_BLOCK_ROWS, 48 MB of
# 1 KB k||v rows inside the L2, is the block chip_smoke.py times against the
# flat layout, and the one auto would take.
_SRC_BLOCK_ROWS = 49152
_AUTO_BLOCK_ABOVE: Optional[int] = None


def _fill_rows(sel, indptr, cols, val, nbr, emask, bval, eid=None, evals=None):
    """Lay the edges of rows ``sel`` out left-aligned in ``nbr`` (and
    ``emask``, ``bval``, ``eid``) row by row: the numpy fill of the JAX
    package's ``bucket_fill``, vectorised over the edges."""
    deg = (indptr[sel + 1] - indptr[sel]).astype(np.int64)
    er = np.repeat(np.arange(sel.size), deg)
    within = np.arange(int(deg.sum())) - np.repeat(np.cumsum(deg) - deg, deg)
    local = np.repeat(indptr[sel], deg) + within
    nbr[er, within] = cols[local]
    emask[er, within] = True
    if bval is not None:
        bval[er, within] = val[local]
    if eid is not None:
        eid[er, within] = local if evals is None else evals[local]


def bucket_rows_numpy(
    indptr: np.ndarray,
    cols: np.ndarray,
    val: Optional[np.ndarray],
    *,
    n_rows_space: int,
    n_cols_space: int,
    min_width: int = 8,
    edge_chunk: int = _EDGE_CHUNK,
    widths: Optional[Sequence[int]] = None,
    row_pad_to: Optional[dict] = None,
    edge_index_map=None,
):
    """Host-side core of :func:`build_buckets` over raw CSR arrays: one
    bucket per width of ``widths`` holding the rows whose degree lies above
    the previous width and at most this one.  ``widths=None`` takes the JAX
    package's doubling ladder: ``min_width``, twice it, and so on up to the
    first width at or above the largest degree.

    ``n_rows_space`` / ``n_cols_space`` are the sentinel pad indices of the
    row-id and neighbour-id spaces.  ``row_pad_to`` (when given) forces
    ``{width: r_pad}``, so that the partitions of one graph come out in the
    same shapes; a width it lacks or maps to 0 gets no bucket.
    ``edge_index_map`` (when given) turns on
    per-lane edge ids: a ``(vals, sentinel)`` pair where lane (i, j) records
    ``vals[local_csr_edge]`` (``vals=None``: CSR edge order) and padded lanes
    carry ``sentinel``.  Returns a list of Buckets holding numpy arrays.
    """
    deg = indptr[1:] - indptr[:-1]
    if widths is None:
        max_deg = int(deg.max()) if deg.size else 0
        widths = [min_width]
        while widths[-1] < max_deg:
            widths.append(2 * widths[-1])
    buckets = []
    lo = 0
    for w in widths:
        sel = np.nonzero((deg > lo) & (deg <= w))[0]
        lo = w
        r = sel.size
        # cap the chunk at the (rounded) real row count: tiny buckets must
        # not round up to a full compute chunk of sentinel rows
        chunk = max(8, min(edge_chunk // w, _round_up(max(r, 1), 8)))
        if row_pad_to is not None:
            r_pad = row_pad_to.get(w, 0)
            if r_pad == 0:
                continue
            assert r <= r_pad, (r, r_pad)
        else:
            if r == 0:
                continue
            r_pad = _round_up(r, chunk)
        row_ids = np.full(r_pad, n_rows_space, dtype=np.int32)
        row_ids[:r] = sel
        nbr = np.full((r_pad, w), n_cols_space, dtype=np.int32)
        emask = np.zeros((r_pad, w), dtype=bool)
        bval = None if val is None else np.zeros((r_pad, w), dtype=np.float32)
        beid = None
        evals = None
        if edge_index_map is not None:
            evals, esent = edge_index_map
            beid = np.full((r_pad, w), esent, dtype=np.int32)
        _fill_rows(sel, indptr, cols, val, nbr, emask, bval, beid, evals)
        buckets.append(Bucket(row_ids=row_ids, nbr=nbr, emask=emask, val=bval,
                              edge_ids=beid, width=int(w), n_rows=int(r),
                              row_chunk=int(chunk)))
    return buckets


def _width_ladder(min_width: int, max_w: int, cap: bool = False,
                  style: str = "x1.5") -> list:
    """Geometric width ladder.  ``style="x1.5"`` (8, 12, 16, 24, 32, ...)
    pads fewer lanes per row than ``style="pow2"`` but has twice the rungs,
    each a separate bucket walk.

    With ``cap=True`` the last rung is trimmed to exactly ``max_w`` so the
    ladder never overshoots it: rows above ``max_w`` go to the segment
    layout, which must never double-cover a row."""
    widths = []
    w = min_width
    while True:
        widths.append(w)
        if w >= max_w:
            break
        if style == "x1.5":
            widths.append(w + w // 2)
            if w + w // 2 >= max_w:
                break
        w *= 2
    if cap:
        widths[-1] = min(widths[-1], max(max_w, min_width))
        if len(widths) >= 2 and widths[-1] <= widths[-2]:
            widths.pop()
    return widths


def segment_rows_numpy(
    indptr: np.ndarray,
    cols: np.ndarray,
    val: Optional[np.ndarray],
    sel: np.ndarray,
    *,
    width: int,
    n_rows_space: int,
    n_cols_space: int,
    edge_chunk: int = _EDGE_CHUNK,
    s_pad_to: Optional[int] = None,
    r_pad_to: Optional[int] = None,
    edge_index_map=None,
) -> Optional[SegmentBucket]:
    """Lay the rows in ``sel`` out as fixed-``width`` edge segments; padded
    segments carry the bin ``r_pad`` (``len(sel)`` by default) and the
    ``n_rows_space`` sentinel.  ``s_pad_to`` / ``r_pad_to`` force the padded
    segment and row counts, so that the partitions of one graph come out in
    the same shapes; padded rows carry the ``n_rows_space`` sentinel."""
    if sel.size == 0 and s_pad_to is None:
        return None
    deg = (indptr[1:] - indptr[:-1])[sel]
    R = int(sel.size)
    R_pad = R if r_pad_to is None else int(r_pad_to)
    nseg = -(-deg // width)
    S = int(nseg.sum())
    chunk = max(8, edge_chunk // width)
    s_pad = _round_up(S, chunk) if s_pad_to is None else int(s_pad_to)
    assert S <= s_pad and R <= R_pad, (S, s_pad, R, R_pad)

    seg_id = np.full(s_pad, R_pad, dtype=np.int32)
    seg_id[:S] = np.repeat(np.arange(R, dtype=np.int32), nseg)
    seg_dst = np.full(s_pad, n_rows_space, dtype=np.int32)
    seg_dst[:S] = np.repeat(sel.astype(np.int32), nseg)

    E_w = int(deg.sum())
    edge_row = np.repeat(np.arange(R), deg)                       # compact row
    within = np.arange(E_w) - np.repeat(np.cumsum(deg) - deg, deg)
    seg_start = np.cumsum(nseg) - nseg
    seg_of_edge = seg_start[edge_row] + within // width
    lane = within % width
    edge_idx = np.repeat(indptr[sel], deg) + within
    nbr = np.full((s_pad, width), n_cols_space, dtype=np.int32)
    emask = np.zeros((s_pad, width), dtype=bool)
    nbr[seg_of_edge, lane] = cols[edge_idx]
    emask[seg_of_edge, lane] = True
    bval = None
    if val is not None:
        bval = np.zeros((s_pad, width), dtype=np.float32)
        bval[seg_of_edge, lane] = val[edge_idx]
    seid = None
    if edge_index_map is not None:
        evals, esent = edge_index_map
        seid = np.full((s_pad, width), esent, dtype=np.int32)
        seid[seg_of_edge, lane] = (
            edge_idx if evals is None else evals[edge_idx]).astype(np.int32)
    wide_rows = np.full(R_pad, n_rows_space, dtype=np.int32)
    wide_rows[:R] = sel
    return SegmentBucket(
        nbr=nbr, emask=emask, seg_id=seg_id, seg_dst=seg_dst,
        wide_rows=wide_rows, val=bval, edge_ids=seid,
        width=int(width), n_rows=R, n_segments=S, row_chunk=int(chunk),
    )


def _bucketize(indptr, cols, val, *, n_rows_space, n_cols_space,
               min_width, edge_chunk, widths, split_width,
               edge_index_map=None, ladder="x1.5"):
    """Shared core: ladder buckets + segment split over raw CSR arrays.

    Explicit ``widths`` compose with ``split_width``: rows wider than the
    split go to segments, and the width list must then cover exactly up to
    ``split_width`` (asserted) so no row is dropped."""
    deg = indptr[1:] - indptr[:-1]
    max_deg = int(deg.max()) if len(deg) else 0
    segments = None
    if split_width is not None and max_deg > split_width:
        sel = np.nonzero(deg > split_width)[0]
        segments = segment_rows_numpy(
            indptr, cols, val, sel,
            width=split_width, n_rows_space=n_rows_space,
            n_cols_space=n_cols_space, edge_chunk=edge_chunk,
            edge_index_map=edge_index_map,
        )
        if widths is None:
            widths = _width_ladder(min_width, split_width, cap=True, style=ladder)
        else:
            assert widths[-1] >= split_width, (
                "explicit widths must cover split_width (rows in "
                f"({widths[-1]}, {split_width}] would be dropped)")
            widths = [w for w in widths if w <= split_width]
            if widths[-1] < split_width:
                widths.append(split_width)
    elif widths is None:
        widths = _width_ladder(min_width, max_deg, style=ladder)
    else:
        assert max_deg <= widths[-1], (
            f"explicit widths top out at {widths[-1]} but max degree is "
            f"{max_deg}; rows would be dropped (set split_width)")
    buckets = bucket_rows_numpy(
        indptr, cols, val,
        n_rows_space=n_rows_space,
        n_cols_space=n_cols_space,
        widths=widths,
        edge_chunk=edge_chunk,
        edge_index_map=edge_index_map,
    )
    return tuple(buckets), segments


def _coo(g: Graph):
    """The graph's real edges on the host: (rows, cols, val or None)."""
    e = g.n_edges
    rows = g.rows[:e].cpu().numpy()
    cols = g.cols[:e].cpu().numpy()
    val = None if g.val is None else g.val[:e].cpu().numpy()
    return rows, cols, val


def _build_blocked(
    g: Graph, block_rows: int, *,
    min_width, edge_chunk, widths, split_width, with_transpose,
    with_edge_ids=False, ladder="x1.5",
) -> "BlockedBucketedGraph":
    n = g.n_nodes
    rows, cols, val = _coo(g)
    nb = -(-n // block_rows)
    blocks = []
    for b in range(nb):
        lo = b * block_rows
        hi = min(lo + block_rows, n)
        m = (cols >= lo) & (cols < hi)
        rb = rows[m]                      # still row-sorted
        cb = (cols[m] - lo).astype(np.int64)
        vb = None if val is None else val[m]
        eim = None
        if with_edge_ids:
            # block-local CSR edge j is original edge orig[j]
            eim = (np.nonzero(m)[0].astype(np.int64), g.e_pad)
        ip = np.zeros(n + 1, np.int64)
        np.add.at(ip, rb + 1, 1)
        ip = np.cumsum(ip)
        bks, segs = _bucketize(
            ip, cb, vb, n_rows_space=n, n_cols_space=block_rows,
            min_width=min_width, edge_chunk=edge_chunk,
            widths=widths, split_width=split_width, edge_index_map=eim,
            ladder=ladder,
        )
        blocks.append(BucketedGraph(buckets=bks, n_nodes=n, n_edges=int(rb.size),
                                    segments=segs))
    transpose = None
    if with_transpose:
        gT = Graph.from_coo(cols, rows, n, val=val, device="cpu")
        transpose = _build_blocked(
            gT, block_rows, min_width=min_width, edge_chunk=edge_chunk,
            widths=widths, split_width=split_width, with_transpose=False,
            ladder=ladder,
        )
    return BlockedBucketedGraph(
        blocks=tuple(blocks), block_rows=int(block_rows),
        n_nodes=n, n_edges=g.n_edges, graph_id=g.graph_id, n_graphs=g.n_graphs,
        transpose=transpose, e_pad=g.e_pad if with_edge_ids else 0,
    )


def build_buckets(
    g: Graph,
    *,
    min_width: int = 16,
    edge_chunk: int = _EDGE_CHUNK,
    widths: Optional[Sequence[int]] = None,
    split_width: Optional[int] = 64,
    with_transpose: bool = False,
    with_edge_ids: bool = False,
    src_block_rows="auto",
    ladder: str = "pow2",
):
    """Split rows into degree buckets (padded neighbour lists) and lay
    super-wide rows (degree > ``split_width``) out as fixed-width edge
    segments merged by online softmax; built on the host, returned on ``g``'s
    device.

    Static widths replace the reference's dynamic-shared-memory sizing
    (``smem_consume``).  ``split_width=None`` disables splitting (super-wide
    buckets then stream through the online-softmax tiled path).
    ``with_transpose=True`` also builds the transposed layout (the
    reference's CSC arrays), so gradients take the fused custom backward.
    ``with_edge_ids=True`` carries CSR edge ids per lane (``return_weights``).

    ``src_block_rows``: ``"auto"`` blocks the sources (a
    :class:`BlockedBucketedGraph`) on graphs above ``_AUTO_BLOCK_ABOVE``
    nodes, never when that is None; ``None`` forces the flat layout and an
    int forces that block size.
    """
    n = g.n_nodes
    if src_block_rows == "auto":
        src_block_rows = (_SRC_BLOCK_ROWS if _AUTO_BLOCK_ABOVE is not None
                          and n > _AUTO_BLOCK_ABOVE else None)
    if src_block_rows:
        return _build_blocked(
            g, int(src_block_rows), min_width=min_width,
            edge_chunk=edge_chunk, widths=widths, split_width=split_width,
            with_transpose=with_transpose, with_edge_ids=with_edge_ids,
            ladder=ladder,
        ).to(g.rows.device)
    return _build_flat(g, min_width=min_width, edge_chunk=edge_chunk, widths=widths,
                       split_width=split_width, with_transpose=with_transpose,
                       with_edge_ids=with_edge_ids, ladder=ladder).to(g.rows.device)


def _build_flat(g: Graph, *, min_width, edge_chunk, widths, split_width, with_transpose,
                with_edge_ids, ladder) -> BucketedGraph:
    n = g.n_nodes
    indptr = g.indptr.cpu().numpy().astype(np.int64)
    rows, cols, val = _coo(g)
    buckets, segments = _bucketize(
        indptr, cols, val, n_rows_space=n, n_cols_space=n,
        min_width=min_width, edge_chunk=edge_chunk,
        widths=widths, split_width=split_width,
        edge_index_map=(None, g.e_pad) if with_edge_ids else None,
        ladder=ladder,
    )
    transpose = None
    if with_transpose:
        gT = Graph.from_coo(cols, rows, n, val=val, device="cpu")
        transpose = _build_flat(
            gT, min_width=min_width, edge_chunk=edge_chunk, widths=None,
            split_width=split_width, with_transpose=False, with_edge_ids=False,
            ladder=ladder,
        )
    return BucketedGraph(
        buckets=tuple(buckets),
        n_nodes=n,
        n_edges=g.n_edges,
        graph_id=g.graph_id,
        n_graphs=g.n_graphs,
        segments=segments,
        transpose=transpose,
        e_pad=g.e_pad if with_edge_ids else 0,
    )


def preprocess(fmt: str, g: Graph, **kw):
    """Convert a Graph to the layout a given strategy consumes (the
    reference's ``load_prepfunc`` names)."""
    if fmt in ("reference", "pyg", "csr", "softmax", "hyper_coo"):
        return g
    if fmt in ("bucketed", "tiling", "csr_gm", "softmax_gm"):
        return build_buckets(g, **kw)
    if fmt in ("two_phase", "softmax_fused"):
        # materialised-score layout: fused paths scatter normalised attention
        # weights back to edge order (the reference's softmax strategy)
        kw.setdefault("with_edge_ids", True)
        return build_buckets(g, **kw)
    if fmt in ("bucketed_train", "hyper_fw_bw"):
        # training layout with the transpose (the reference's preprocess_Hyper_fw_bw)
        return build_buckets(g, with_transpose=True, **kw)
    raise KeyError(f"unknown format {fmt!r}")
