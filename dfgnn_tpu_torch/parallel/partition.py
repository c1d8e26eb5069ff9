"""The edge-partitioned plan of one full graph across several devices.

The counterpart of :mod:`dfgnn_tpu.parallel.partition` up to the point where
a collective is needed.  One large graph's edges are partitioned by
**destination row block**: device ``d`` owns rows ``[d * n_local, (d + 1) *
n_local)``, so edge-softmax stays on the device that owns the row, and only
source-side rows (k, v, or GAT's ``e_col``) travel between devices.

Every device of a step runs the same shapes, so the plan is *harmonised*:
one widths list, the same padded row count per bucket
(``formats.bucket_rows_numpy(row_pad_to=...)``) and, for super-wide rows,
the same padded segment count (``segment_rows_numpy(s_pad_to=...)``).

The plan is built on the host in numpy, as the JAX package builds it, and
kept as CPU tensors with ``.to(device)``.  Its id arrays are int64 (the
index type of torch's gathers); their values equal the JAX package's
int32 arrays.

What runs per shard without a collective is here too: :func:`_local_bg`
(shard ``d``'s layout slice), :func:`_local_drop` (its dropout context) and
the two local halves of the halo exchange, :func:`_halo_send_rows` and
:func:`_halo_source_table`.  The shard index ``d`` is an argument wherever
the JAX package reads ``jax.lax.axis_index``.  The exchanges themselves,
the shared-segment merge across devices and the distributed forward and
backward need ``torch.distributed`` (ROADMAP.md queue 1 item 10b).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.formats import (
    Bucket, BucketedGraph, SegmentBucket, _coo, _to, _width_ladder, bucket_rows_numpy,
    segment_rows_numpy,
)
from dfgnn_tpu_torch.graph import Graph, _round_up
from dfgnn_tpu_torch.ops.bucket import _Drop, _take
from dfgnn_tpu_torch.parallel.balance import balance_perm
from dfgnn_tpu_torch.parallel.reorder import bfs_reorder, lpa_reorder, reorder_graph


@dataclass(frozen=True)
class HaloExchange:
    """Boundary-node exchange plan (its volume is O(halo), not O(n_nodes)).

    Each device d needs, from each peer e, the rows ``need[d][e]`` that d's
    local edges reference; equivalently each device e sends ``send[e][d] =
    need[d][e]`` to d.  ``send_local`` holds those as e-local row indices,
    stacked on a leading device axis and harmonised to one ``max_halo``, so
    the exchange is one all-to-all of static shape.  When a partition carries
    a halo plan, its bucket ``nbr`` ids index the local source table
    ``[x_local ++ recv(n_devices * max_halo) ++ zero row]``.

    ``table_global`` inverts that remap: the global node id of every local
    source-table row, ``[n_devices, table_rows + 1]`` (the last row is the
    appended zero row; padding maps to the ``n_nodes`` sentinel).  Attention
    dropout reads it, since its edge hash keys on global (dst, src) ids.
    """

    send_local: torch.Tensor    # [n_devices (sender), n_devices (receiver), max_halo] int64
    table_global: torch.Tensor  # [n_devices, table_rows + 1] int64
    max_halo: int = 0

    def to(self, device) -> "HaloExchange":
        return _to(self, device)


@dataclass(frozen=True)
class SharedSegments:
    """Globally dealt fixed-width segments of super-wide rows.

    The per-device segment layout pads every device to the largest
    per-device segment count; one super row's segments cannot be split
    across devices there, so one such row bounds every device's pad, and the
    waste grows with the device count.  Here the global segment list is
    split into equal contiguous shares instead (``nbr[d]`` is device d's
    share; the pad is one tail round-up in all).  A segment's destination
    row may live on any device: the per-segment softmax states (m, l, acc)
    are reduced per wide row on each device and merged across devices by
    their logsumexps (the reference tiling kernel's rescale algebra,
    ``fused_gtconv_tiling.cu:72-86``), a collective of item 10b.
    """

    nbr: torch.Tensor        # [n_devices, s_loc, width] global (permuted) ids
    emask: torch.Tensor      # [n_devices, s_loc, width] bool
    seg_id: torch.Tensor     # [n_devices, s_loc] wide-row ordinal j (pad: R)
    wide_rows: torch.Tensor  # [R] global (permuted) row ids
    drop_rows: torch.Tensor  # [R + 1] original ids (+ the n sentinel): dropout rows
    val: Optional[torch.Tensor] = None  # [n_devices, s_loc, width]
    width: int = 0
    n_rows: int = 0       # R
    n_segments: int = 0   # global S

    def to(self, device) -> "SharedSegments":
        return _to(self, device)


@dataclass(frozen=True)
class EdgePartitionedGraph:
    """Per-device bucketed CSR slices, stacked on a leading device axis.

    ``buckets[i]`` arrays have shape ``[n_devices, r_pad_i(, width_i)]``;
    ``row_ids`` are device-local (0..n_local, sentinel n_local); ``nbr`` are
    global node ids (sentinel ``n_nodes``), or local source-table rows when
    the plan carries a :class:`HaloExchange`.  ``segments`` (per-device
    harmonised) or ``shared_segments`` (globally dealt) hold the super-wide
    rows.  ``transpose`` is the source-partitioned layout over the same node
    blocks (the fused distributed backward's CSC direction).  A plan built
    with a node permutation (``balance``, ``reorder``) takes its features
    permuted (``x[node_perm]``) and returns outputs in the original order
    (``out[node_rank]``).
    """

    buckets: Tuple[Bucket, ...]
    n_nodes: int = 0    # global
    n_local: int = 0    # rows per device
    n_devices: int = 0
    n_edges: int = 0
    halo: Optional[HaloExchange] = None
    segments: Optional[SegmentBucket] = None
    shared_segments: Optional[SharedSegments] = None
    transpose: Optional["EdgePartitionedGraph"] = None
    node_perm: Optional[torch.Tensor] = None  # [n] old ids in new order
    node_rank: Optional[torch.Tensor] = None  # [n] rank[old] = new

    def to(self, device) -> "EdgePartitionedGraph":
        return _to(self, device)

    def comm_rows_per_device(self) -> int:
        """Rows each device receives per exchanged operand per layer: the
        exchange-volume model (times the row bytes for bytes a step)."""
        if self.halo is not None:
            return (self.n_devices - 1) * self.halo.max_halo
        return (self.n_devices - 1) * self.n_local

    @property
    def padded_edges(self) -> int:
        tot = sum(math.prod(b.nbr.shape) for b in self.buckets)
        if self.segments is not None:
            tot += math.prod(self.segments.nbr.shape)
        if self.shared_segments is not None:
            tot += math.prod(self.shared_segments.nbr.shape)
        return tot


def _plan_widths(deg: np.ndarray, min_width: int, split_width: int, widths):
    """The (widths, use_segments) bucket plan partition_graph will use,
    shared with the balance pass so both see the same classes."""
    max_deg = int(deg.max()) if deg.size else 0
    use_segments = widths is None and max_deg > split_width
    if widths is None:
        widths = _width_ladder(
            min_width, min(max_deg, split_width) if use_segments else max_deg,
            cap=use_segments,
        )
    return widths, use_segments


def partition_graph(
    g: Graph,
    n_devices: int,
    *,
    min_width: int = 8,
    widths=None,
    halo: bool = False,
    with_transpose: bool = False,
    split_width: int = 256,
    reorder: Optional[str] = None,
    balance: Optional[bool] = None,
) -> EdgePartitionedGraph:
    """Host-side: split rows into ``n_devices`` contiguous blocks and build
    shape-harmonised per-device buckets; returned as CPU tensors.

    ``halo=True`` builds a :class:`HaloExchange` plan: neighbour ids are
    remapped into per-device source tables and only boundary rows are
    exchanged (one all-to-all), so the exchange is O(halo) rows instead of
    the default all-gather's O(n_nodes).  It pays when the partition has
    locality (clustered graphs); on locality-free random graphs the halo
    approaches all of each peer's rows.

    ``reorder="bfs"`` (or ``"lpa"``) applies a locality-aware node
    permutation (:mod:`.reorder`) before the contiguous blocking, so the halo
    stays small on community graphs even when input ids are shuffled.

    ``balance`` (default: on for the all-gather exchange, off when ``halo``
    or ``reorder`` asks for locality) applies a degree-balanced row->device
    permutation (:mod:`.balance`) so the harmonised padded-edge factor does
    not grow with the device count.  It destroys id locality.  An explicit
    ``balance=True`` always applies, after any locality reorder.

    The JAX package's ``mesh`` and ``axis`` have no counterpart here: the
    process group comes with the distributed forward (item 10b).
    """
    return _partition(g, n_devices, min_width=min_width, widths=widths, halo=halo,
                      with_transpose=with_transpose, split_width=split_width,
                      reorder=reorder, balance=balance).to("cpu")


def _partition(g, n_devices, *, min_width, widths, halo, with_transpose, split_width,
               reorder, balance) -> EdgePartitionedGraph:
    """:func:`partition_graph` with numpy arrays in the fields."""
    n = g.n_nodes
    do_balance = ((balance if balance is not None else (reorder is None and not halo))
                  and n_devices > 1 and n > 0)
    if reorder or do_balance:
        r_, c_, val_ = _coo(g)
        perm = np.arange(n, dtype=np.int64)
        if reorder:
            if reorder not in ("bfs", "lpa"):
                raise ValueError(f"unknown reorder {reorder!r}")
            fn = lpa_reorder if reorder == "lpa" else bfs_reorder
            p1 = fn(r_, c_, n)
            r_, c_, _ = reorder_graph(r_, c_, n, p1)
            perm = perm[p1]
        if do_balance:
            deg = np.bincount(r_, minlength=n)
            w_, use_seg = _plan_widths(deg, min_width, split_width, widths)
            p2 = balance_perm(deg, n_devices, w_, split_width, use_seg)
            r_, c_, _ = reorder_graph(r_, c_, n, p2)
            perm = perm[p2]
        rank = np.empty(n, np.int64)
        rank[perm] = np.arange(n)
        g2 = Graph.from_coo(r_, c_, n, val=val_, device="cpu")
        pg = _partition(g2, n_devices, min_width=min_width, widths=widths, halo=halo,
                        with_transpose=with_transpose, split_width=split_width,
                        reorder=None, balance=False)
        if pg.transpose is not None:
            # same node blocks, same permutation: the fused backward's
            # dropout hash maps back to original ids through it too
            pg = dataclasses.replace(pg, transpose=dataclasses.replace(
                pg.transpose, node_perm=perm, node_rank=rank))
        if pg.shared_segments is not None:
            # dropout-hash row ids are original global ids
            ss = pg.shared_segments
            dr = np.concatenate([perm[ss.wide_rows], [n]])
            pg = dataclasses.replace(pg, shared_segments=dataclasses.replace(ss, drop_rows=dr))
        return dataclasses.replace(pg, node_perm=perm, node_rank=rank)

    n_local = _round_up(n, n_devices) // n_devices
    indptr = g.indptr.cpu().numpy().astype(np.int64)
    _, cols, val = _coo(g)

    # widths shared across devices; rows wider than split_width go to the
    # fixed-width segment layout (harmonised below)
    deg = indptr[1:] - indptr[:-1]
    widths, use_segments = _plan_widths(deg, min_width, split_width, widths)

    per_dev = []
    for d in range(n_devices):
        # clamp both ends: with n < n_devices * n_local, whole tail devices
        # can be empty (their blocks start past the last row)
        lo_r, hi_r = min(d * n_local, n), min((d + 1) * n_local, n)
        ip = indptr[lo_r: hi_r + 1] - indptr[lo_r]
        if len(ip) < n_local + 1:  # pad rows with degree 0
            ip = np.concatenate([ip, np.full(n_local + 1 - len(ip), ip[-1])])
        cs = cols[indptr[lo_r]: indptr[hi_r]]
        vs = None if val is None else val[indptr[lo_r]: indptr[hi_r]]
        per_dev.append((ip, cs, vs))

    halo_plan = None
    n_cols_space = n
    if halo and n_devices > 1:
        # One sort over (device, col) pairs builds the whole plan.
        # need[d][e]: global source ids owned by peer e that device d's
        # edges reference; send[e][d] = need[d][e] as e-local indices.
        all_cols = np.concatenate([cs for _, cs, _ in per_dev])
        all_dev = np.repeat(np.arange(n_devices, dtype=np.int64),
                            [cs.size for _, cs, _ in per_dev])
        # unique (d, col) pairs, sorted by (d, col): within one d the halo
        # groups (d, owner e) are contiguous and sorted
        key = all_dev * n + all_cols.astype(np.int64)
        uk, inv = np.unique(key, return_inverse=True)
        inv = inv.reshape(-1)
        d_of = uk // n
        col_of = uk % n
        own_of = col_of // n_local
        is_halo = own_of != d_of
        grp = d_of * n_devices + own_of              # sorted, as uk is
        # rank of each unique pair within its (d, owner) group
        starts = np.searchsorted(grp, np.arange(n_devices * n_devices))
        rank = np.arange(uk.size, dtype=np.int64) - starts[grp]
        counts = np.bincount(grp[is_halo], minlength=n_devices * n_devices)
        mx = int(counts.max()) if counts.size else 0
        H = max(8, _round_up(mx, 8))
        send_local = np.zeros((n_devices, n_devices, H), np.int64)
        # send[e][d][rank] = e-local index of the rank-th needed id
        eh, dh, rh = own_of[is_halo], d_of[is_halo], rank[is_halo]
        send_local[eh, dh, rh] = col_of[is_halo] - eh * n_local
        table_rows = n_local + n_devices * H
        # local-table row of every unique (d, col) pair, and the inverse
        # (global id per table row) for dropout
        table_of = np.where(is_halo, n_local + own_of * H + rank, col_of - d_of * n_local)
        table_global = np.full((n_devices, table_rows + 1), n, np.int64)
        rr = np.arange(n_local, dtype=np.int64)
        owned = rr[None, :] + np.arange(n_devices)[:, None] * n_local
        valid = owned < n
        table_global[:, :n_local][valid] = owned[valid]
        table_global[d_of, table_of] = col_of
        # remap each device's neighbour ids into its local source table
        remapped = table_of[inv]
        off = 0
        for d in range(n_devices):
            ip, cs, vs = per_dev[d]
            per_dev[d] = (ip, remapped[off: off + cs.size], vs)
            off += cs.size
        n_cols_space = table_rows  # sentinel -> the appended zero row (clip)
        halo_plan = HaloExchange(send_local=send_local, table_global=table_global,
                                 max_halo=H)

    # the exact largest row count per width over the devices: the walk
    # re-chunks at run time, so any coarser rounding is padded-edge waste
    row_pad_to = {}
    for w_i, w in enumerate(widths):
        lo = 0 if w_i == 0 else widths[w_i - 1]
        mx = 0
        for ip, _, _ in per_dev:
            dg = ip[1:] - ip[:-1]
            mx = max(mx, int(((dg > lo) & (dg <= w)).sum()))
        if mx:
            row_pad_to[w] = mx

    all_buckets = [
        bucket_rows_numpy(ip, cs, vs, n_rows_space=n_local, n_cols_space=n_cols_space,
                          widths=widths, row_pad_to=row_pad_to)
        for ip, cs, vs in per_dev
    ]
    stacked = []
    for i in range(len(all_buckets[0])):
        per = [bks[i] for bks in all_buckets]
        b0 = per[0]
        stacked.append(Bucket(
            row_ids=np.stack([b.row_ids for b in per]),
            nbr=np.stack([b.nbr for b in per]),
            emask=np.stack([b.emask for b in per]),
            val=None if b0.val is None else np.stack([b.val for b in per]),
            width=b0.width,
            n_rows=max(b.n_rows for b in per),
            row_chunk=b0.row_chunk,
        ))

    segments = None
    shared = None
    if use_segments and not halo and not with_transpose and n_devices > 1:
        # the all-gather exchange: globally dealt shared segments.  The halo
        # plan keeps per-device segments (its remap assumes row-local
        # segments), as does with_transpose (the fused backward walks
        # per-device segments).
        shared = _build_shared_segments(indptr, cols, val, split_width, n, n_devices)
    elif use_segments:
        # harmonise segment and row pads across devices, then stack; the
        # segment count aligns to 64, or to 8 when it is itself tiny
        sels, S_max, R_max = [], 0, 0
        for ip, _, _ in per_dev:
            dg = ip[1:] - ip[:-1]
            sel = np.nonzero(dg > split_width)[0]
            sels.append(sel)
            R_max = max(R_max, sel.size)
            S_max = max(S_max, int((-(-dg[sel] // split_width)).sum()))
        if R_max:
            chunk = 64 if S_max >= 64 else 8
            s_pad = _round_up(max(S_max, 1), chunk)
            per_seg = [
                segment_rows_numpy(ip, cs, vs, sel, width=split_width, n_rows_space=n_local,
                                   n_cols_space=n_cols_space, s_pad_to=s_pad, r_pad_to=R_max)
                for (ip, cs, vs), sel in zip(per_dev, sels)
            ]
            st = lambda name: np.stack([getattr(s, name) for s in per_seg])
            segments = SegmentBucket(
                nbr=st("nbr"), emask=st("emask"), seg_id=st("seg_id"), seg_dst=st("seg_dst"),
                wide_rows=st("wide_rows"),
                val=None if per_seg[0].val is None else st("val"),
                width=split_width, n_rows=R_max,
                n_segments=max(s.n_segments for s in per_seg),
                row_chunk=chunk,
            )

    transpose = None
    if with_transpose:
        rows_, cols_, val_ = _coo(g)
        gT = Graph.from_coo(cols_, rows_, n, val=val_, device="cpu")
        # balance=False is required: the transposed layout must use the
        # same node blocks as the forward partition
        transpose = _partition(gT, n_devices, min_width=min_width, widths=None, halo=halo,
                               with_transpose=False, split_width=split_width, reorder=None,
                               balance=False)
    return EdgePartitionedGraph(
        buckets=tuple(stacked), n_nodes=n, n_local=n_local, n_devices=n_devices,
        n_edges=g.n_edges, halo=halo_plan, segments=segments, shared_segments=shared,
        transpose=transpose,
    )


def _build_shared_segments(indptr, cols, val, split_width, n, n_devices):
    """Host-side: the global segment list of all super-wide rows, split
    into equal contiguous per-device shares (see :class:`SharedSegments`)."""
    deg = indptr[1:] - indptr[:-1]
    sel = np.nonzero(deg > split_width)[0]
    if sel.size == 0:
        return None
    sb = segment_rows_numpy(indptr, cols, val, sel, width=split_width,
                            n_rows_space=n, n_cols_space=n)
    S, R = sb.n_segments, sb.n_rows
    # exact equal shares: padded shares on devices past S are all sentinel
    s_loc = max(1, -(-S // n_devices))
    s_tot = s_loc * n_devices

    def fit(x, fill):
        if x is None:
            return None
        if x.shape[0] >= s_tot:
            x = x[:s_tot]   # rows >= S are sentinel padding
        else:
            pad = np.full((s_tot - x.shape[0],) + x.shape[1:], fill, x.dtype)
            x = np.concatenate([x, pad])
        return x.reshape((n_devices, s_loc) + x.shape[1:])

    wide = sb.wide_rows[:R].astype(np.int64)
    return SharedSegments(
        nbr=fit(sb.nbr, n),
        emask=fit(sb.emask, False),
        seg_id=fit(sb.seg_id, R),
        val=None if sb.val is None else fit(sb.val, 0.0),
        wide_rows=wide,
        # original == permuted here; the balance / reorder wrapper remaps it
        drop_rows=np.concatenate([wide, [n]]),
        width=int(split_width), n_rows=R, n_segments=S,
    )


# ---------------------------------------------------------------------------
# The per-shard half of the distributed forward that needs no collective
# ---------------------------------------------------------------------------

def _pad_nodes(x: Optional[torch.Tensor], n_pad: int) -> Optional[torch.Tensor]:
    """``x`` [n, ...] padded with zero rows to ``n_pad`` rows."""
    if x is None or x.shape[0] == n_pad:
        return x
    return torch.cat([x, x.new_zeros((n_pad - x.shape[0], *x.shape[1:]))])


def _local_bg(pg: EdgePartitionedGraph, d: int, device="cuda") -> BucketedGraph:
    """Shard ``d``'s layout slice as a local :class:`BucketedGraph` on
    ``device`` (the shared segments are not part of it: the cross-device
    merge walks them)."""
    dev = resolve_device(device)
    pick = lambda x: None if x is None else x[d]
    buckets = tuple(dataclasses.replace(b, row_ids=b.row_ids[d], nbr=b.nbr[d],
                                        emask=b.emask[d], val=pick(b.val))
                    for b in pg.buckets)
    sb = pg.segments
    segments = None if sb is None else dataclasses.replace(
        sb, nbr=sb.nbr[d], emask=sb.emask[d], seg_id=sb.seg_id[d], seg_dst=sb.seg_dst[d],
        wide_rows=sb.wide_rows[d], val=pick(sb.val))
    return BucketedGraph(buckets=buckets, n_nodes=pg.n_local, n_edges=pg.n_edges,
                         segments=segments).to(dev)


def _perm_arg(pg: EdgePartitionedGraph) -> Optional[torch.Tensor]:
    """Permuted-global-id -> original-id map ``[n + 1]`` (the last entry is
    the ``n`` sentinel), or None when the plan has no node permutation."""
    if pg.node_perm is None:
        return None
    return torch.cat([pg.node_perm, pg.node_perm.new_full((1,), pg.n_nodes)])


def _local_drop(pg: EdgePartitionedGraph, d: int, seed: int, rate: float,
                device="cuda") -> Optional[_Drop]:
    """Shard ``d``'s dropout context on ``device``: rows rebased to global
    ids by the contiguous row blocking (``row_base = d * n_local``), halo
    table rows mapped back to global ids through ``table_global[d]``, and a
    balance / reorder permutation inverted through :func:`_perm_arg`, so the
    mask is bitwise the single-device layouts' for the same seed and edge
    (see ``ops.bucket._Drop``)."""
    if rate == 0.0:
        return None
    dev = resolve_device(device)
    src_map = None if pg.halo is None else pg.halo.table_global[d].to(dev)
    perm = _perm_arg(pg)
    return _Drop(seed, rate, row_base=d * pg.n_local, src_map=src_map,
                 id_perm=None if perm is None else perm.to(dev))


def _halo_send_rows(pg: EdgePartitionedGraph, d: int, x_l: torch.Tensor) -> torch.Tensor:
    """The rows shard ``d`` sends, ``[n_devices (receiver), max_halo, ...]``:
    the take of its local rows ``x_l`` at ``send_local[d]``, the first half
    of the halo exchange."""
    return _take(x_l, pg.halo.send_local[d].to(x_l.device))


def _halo_source_table(pg: EdgePartitionedGraph, x_l: torch.Tensor,
                       recv: torch.Tensor) -> torch.Tensor:
    """The source table a shard assembles from its local rows ``x_l`` and
    what it received, ``recv`` ``[n_devices (sender), max_halo, ...]``:
    ``[x_l ++ recv ++ zero row]``, the second half of the halo exchange."""
    nd, H = pg.n_devices, pg.halo.max_halo
    zero = x_l.new_zeros((1, *x_l.shape[1:]))
    return torch.cat([x_l, recv.reshape(nd * H, *x_l.shape[1:]), zero])
