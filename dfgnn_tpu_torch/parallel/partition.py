"""The edge-partitioned full graph across several devices.

The counterpart of :mod:`dfgnn_tpu.parallel.partition`.  One large graph's
edges are partitioned by **destination row block**: device ``d`` owns rows
``[d * n_local, (d + 1) * n_local)``, so edge-softmax stays on the device that
owns the row, and only source-side rows (k, v, or GAT's ``e_col``) travel
between devices: an all-gather, or with a halo plan an all-to-all of the
boundary rows.  This is the graph analog of sequence parallelism.

Every device of a step runs the same shapes, so the plan is *harmonised*:
one widths list, the same padded row count per bucket
(``formats.bucket_rows_numpy(row_pad_to=...)``) and, for super-wide rows,
the same padded segment count (``segment_rows_numpy(s_pad_to=...)``).

The plan is built on the host in numpy, as the JAX package builds it, and
kept as CPU tensors; a rank moves only its own slice to its device
(:func:`_shard`, once per plan).  Its id arrays are int64 (the index type of
torch's gathers); their values equal the JAX package's int32 arrays.

:func:`dist_graph_attention` is an SPMD program over ``torch.distributed``,
one process per device: where the JAX function takes and returns global
node-sharded arrays, it takes and returns **this rank's block**, ``[n_local,
h, f]`` rows in plan order, and every rank computes only its own rows.
:func:`shard_nodes` and :func:`gather_nodes` convert from and to the global
order.  Autograd runs through the forward and the collectives of
:mod:`.comm`; a plan built with ``with_transpose=True`` trains through the
fused distributed backward (:class:`_DistFused`) instead.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.formats import (
    Bucket, BucketedGraph, SegmentBucket, _coo, _to, _width_ladder, bucket_rows_numpy,
    segment_rows_numpy,
)
from dfgnn_tpu_torch.graph import Graph, _round_up
from dfgnn_tpu_torch.ops import bucket as _bk
from dfgnn_tpu_torch.ops.bucket import _Drop, _take
from dfgnn_tpu_torch.parallel import comm
from dfgnn_tpu_torch.parallel.balance import balance_perm
from dfgnn_tpu_torch.parallel.dist import mesh_group_rank
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
    ``fused_gtconv_tiling.cu:72-86``) in :func:`_shared_forward`.
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
    (``out[node_rank]``).  ``mesh`` is the 1-D device mesh the plan runs on
    (``partition_graph(..., mesh=...)``), or None for a plan not yet placed.
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
    mesh: Optional[DeviceMesh] = None

    def to(self, device) -> "EdgePartitionedGraph":
        return _to(self, device)

    @property
    def axis(self) -> Optional[str]:
        """The name of the mesh's dim (JAX's ``axis``), None without a mesh."""
        return None if self.mesh is None else self.mesh.mesh_dim_names[0]

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
    mesh: Optional[DeviceMesh] = None,
    axis: str = "data",
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

    ``mesh`` (a :class:`DeviceMesh`; a 2-D one is cut to its dim ``axis``)
    is the mesh :func:`~dfgnn_tpu_torch.ops.graph_attention` runs the plan on;
    the plan stays on the CPU either way.
    """
    if mesh is not None:
        if mesh.ndim > 1:
            mesh = mesh[axis]
        if mesh.mesh_dim_names != (axis,):
            raise ValueError(f"mesh dims {mesh.mesh_dim_names} lack axis {axis!r}")
        if mesh.size() != n_devices:
            raise ValueError(f"mesh of {mesh.size()} ranks for a plan of {n_devices} devices")
    pg = _partition(g, n_devices, min_width=min_width, widths=widths, halo=halo,
                    with_transpose=with_transpose, split_width=split_width,
                    reorder=reorder, balance=balance).to("cpu")
    return pg if mesh is None else dataclasses.replace(pg, mesh=mesh)


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


def _drop_maps(pg: EdgePartitionedGraph, d: int, dev) -> dict:
    """The id maps of shard ``d``'s dropout context on ``dev``."""
    perm = _perm_arg(pg)
    return dict(row_base=d * pg.n_local,
                src_map=None if pg.halo is None else pg.halo.table_global[d].to(dev),
                id_perm=None if perm is None else perm.to(dev))


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
    return _Drop(seed, rate, **_drop_maps(pg, d, resolve_device(device)))


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


# ---------------------------------------------------------------------------
# The distributed forward and backward over torch.distributed
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Shard:
    """One rank's slice of a plan on its device (see :func:`_shard`)."""

    bg: BucketedGraph                  # the rank's buckets and per-device segments
    drop_maps: dict                    # the id maps of its dropout context
    send: Optional[torch.Tensor]       # [n_devices, max_halo] rows it sends (halo plans)
    shared: Optional[tuple]            # its share (seg_id, nbr, emask, val) of the shared segments
    wide_rows: Optional[torch.Tensor]  # [R] the shared segments' rows
    drop_rows: Optional[torch.Tensor]  # [R + 1] their dropout-hash ids

    def drop(self, seed: int, rate: float) -> Optional[_Drop]:
        return None if rate == 0.0 else _Drop(seed, rate, **self.drop_maps)


def _shard(pg: EdgePartitionedGraph, rank: int, device) -> _Shard:
    """Rank ``rank``'s slice of ``pg`` on ``device``: built at its first use
    and kept on the plan object, so a rank moves only its own slice to its
    device, once."""
    memo = pg.__dict__.setdefault("_shards", {})
    key = (rank, str(device))
    if key not in memo:
        dev = torch.device(device)
        ss = pg.shared_segments
        shared = None
        if ss is not None:
            shared = tuple(None if x is None else x[rank].to(dev)
                           for x in (ss.seg_id, ss.nbr, ss.emask, ss.val))
        memo[key] = _Shard(
            bg=_local_bg(pg, rank, dev), drop_maps=_drop_maps(pg, rank, dev),
            send=None if pg.halo is None else pg.halo.send_local[rank].to(dev),
            shared=shared,
            wide_rows=None if ss is None else ss.wide_rows.to(dev),
            drop_rows=None if ss is None else ss.drop_rows.to(dev))
    return memo[key]


def _exchange(pg: EdgePartitionedGraph, sh: _Shard, group):
    """The source-row exchange of one rank, local rows -> source table: the
    halo all-to-all between :func:`_halo_send_rows`' take and
    :func:`_halo_source_table` when the plan has a halo, else the
    all-gather of every rank's rows."""
    if pg.halo is None:
        return lambda x_l: comm.all_gather(x_l, group)
    return lambda x_l: _halo_source_table(pg, x_l, comm.all_to_all(_take(x_l, sh.send), group))


def _source_table(pg, sh, group, b, v, score):
    """The exchanged packed source table (k||v for dot, e_col||v for add)."""
    dot = score == "dot"
    (local,) = _bk._make_tabs(b if dot else None, v, None if dot else b, score, None)
    return (_exchange(pg, sh, group)(local),)


def _forward_local(pg, sh, group, a, b, v, score, slope, drop):
    """This rank's rows: (out [n_local, h, f], lse [n_local, h]) and the
    exchanged source table."""
    dot = score == "dot"
    tabs = _source_table(pg, sh, group, b, v, score)
    res = _bk._forward_tabs(sh.bg, a if dot else None, None if dot else a, tabs, v.dtype,
                            v.shape[2], score, slope, 2048, drop=drop)
    return res, tabs


def _shared_forward(pg, sh, group, rank, a, tabs, f, score, slope, drop, out):
    """This rank's share of the global segment walk and the cross-device
    online-softmax combine; the merged wide rows are written into this rank's
    rows of ``out`` (see :class:`SharedSegments`)."""
    R, L = pg.shared_segments.n_rows, pg.n_local
    h = tabs[0].shape[1]
    idx = sh.wide_rows - rank * L
    valid = (idx >= 0) & (idx < L)
    cidx = idx.clamp(0, L - 1)

    # the wide rows' destination-side operand, replicated: the owner
    # contributes, the sum all-reduce broadcasts; the zero row appended is
    # the padded segments' sentinel
    t = a[cidx]
    t = torch.where(valid.view(R, *(1,) * (t.ndim - 1)), t, torch.zeros_like(t))
    aw = torch.cat([comm.all_reduce_sum(t, group), t.new_zeros((1, *t.shape[1:]))])

    dot = score == "dot"
    seg_id, nbr, emask, val = sh.shared
    chunk = _bk._pick_chunk(nbr.shape[0], nbr.shape[1], _bk._tabs_row_bytes(tabs))
    (sid, *_), (m_s, l_s, acc_s) = _bk._map_chunks(
        lambda args: _bk._segment_partials(args, aw if dot else None, None if dot else aw,
                                           tabs, f, score, slope, drop),
        (seg_id, nbr, emask, val), (R, pg.n_nodes, False, 0.0), chunk)
    bins = R + 1  # the last bin takes the padded segments
    m_loc = torch.full((bins, h), _bk.NEG_BIG, device=m_s.device).scatter_reduce(
        0, sid[:, None].expand(-1, h), m_s, reduce="amax", include_self=True)
    scale = torch.exp(m_s - m_loc[sid])
    l_loc = _bk._segsum(l_s * scale, sid, bins)
    acc_loc = _bk._segsum(acc_s * scale[..., None], sid, bins)
    # the cross-device combine (the reference tiling kernel's rescale algebra,
    # fused_gtconv_tiling.cu:72-86); the shared max is a pure shift, outside
    # autograd
    resc = torch.exp(m_loc - comm.all_reduce_max(m_loc, group))
    l_g = comm.all_reduce_sum(l_loc * resc, group)
    acc_g = comm.all_reduce_sum(acc_loc * resc[..., None], group)
    live = l_g[..., None] > 0
    out_r = torch.where(live, acc_g / torch.where(live, l_g[..., None], 1.0), 0.0)
    tgt = torch.where(valid, idx, L)  # rows of other ranks land in a dropped row
    out = torch.cat([out, out.new_zeros((1, *out.shape[1:]))])
    return out.index_copy(0, tgt, out_r[:R].to(out.dtype))[:L]


class _DistFused(torch.autograd.Function):
    """The distributed forward with the fused distributed backward, on a plan
    built with ``with_transpose=True`` (the multi-device form of
    ``ops.bucket._BucketFused``).  Saves (a, b, v, out, lse) of this rank's
    rows.  The CSR direction (dQ or d e_row) walks this rank's rows with the
    forward's exchange of b||v; the CSC direction (dK or d e_col, and dV)
    walks the transposed layout, the same node blocks partitioned by source,
    with the reverse exchange of the packed a||dO||lse||delta rows.  Both are
    gathers: no reduce-scatter and no atomics.  ``a, b`` are (q, k) for dot
    and (e_row, e_col) for add."""

    @staticmethod
    def forward(ctx, a, b, v, pg, rank, group, meta):
        score, slope, rate, seed = meta
        sh = _shard(pg, rank, v.device)
        (out, lse), _ = _forward_local(pg, sh, group, a, b, v, score, slope,
                                       sh.drop(seed, rate))
        ctx.save_for_backward(a, b, v, out, lse)
        ctx.pg, ctx.rank, ctx.group, ctx.meta = pg, rank, group, meta
        return out

    @staticmethod
    def backward(ctx, do):
        a, b, v, out, lse = ctx.saved_tensors
        pg, rank, group = ctx.pg, ctx.rank, ctx.group
        score, slope, rate, seed = ctx.meta
        dot = score == "dot"
        h, f = v.shape[1], v.shape[2]
        sh, shT = _shard(pg, rank, v.device), _shard(pg.transpose, rank, v.device)
        do = do.float()
        delta = torch.einsum("nhf,nhf->nh", do, out.float())

        tabs = _source_table(pg, sh, group, b, v, score)
        drop = sh.drop(seed, rate)
        (da,) = _bk._walk_backward(
            sh.bg, lambda args: _bk._bwd_csr_chunk(args, a, do, lse, delta, tabs, f, score,
                                                   slope, drop),
            [(h, f)] if dot else [(h,)], _bk._tabs_row_bytes(tabs), v.device)

        # the plan and its transpose share one node permutation, so the
        # dropout hash keys on the same original ids in both directions
        a3 = a if dot else a[..., None]
        local_T = torch.cat([a3.float(), do, torch.stack([lse, delta], dim=-1)], dim=-1)
        tabsT = (_exchange(pg.transpose, shT, group)(local_T),)
        dropT = shT.drop(seed, rate)
        db, dv = _bk._walk_backward(
            shT.bg, lambda args: _bk._bwd_csc_chunk(args, b, v, tabsT, f, score, slope, dropT),
            [(h, f), (h, f)] if dot else [(h,), (h, f)], _bk._tabs_row_bytes(tabsT), v.device)
        return da.to(a.dtype), db.to(b.dtype), dv.to(v.dtype), None, None, None, None


def dist_graph_attention(
    pg: EdgePartitionedGraph,
    mesh: DeviceMesh,
    q: Optional[torch.Tensor],
    k: Optional[torch.Tensor],
    v: torch.Tensor,
    *,
    score: str = "dot",
    e_row: Optional[torch.Tensor] = None,
    e_col: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    axis: str = "data",
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """Fused attention over a row-partitioned graph, one rank's share.

    Every rank of ``mesh``'s dim ``axis`` calls it at once.  ``q, k, v``
    (``[n_local, h, f]``) or ``e_row, e_col`` (``[n_local, h]``) and ``v`` are
    this rank's block of rows in plan order (:func:`shard_nodes`), on its
    device; the result is this rank's rows of the output, ``[n_local, h, f]``
    (:func:`gather_nodes` assembles the graph's).  The source-side operands
    travel by the plan's exchange (all-gather, or the halo all-to-all), each
    rank runs the bucket path's walk over its rows, and the shared segments
    of super-wide rows merge across ranks.  On a plan with a transpose,
    training runs the fused distributed backward (:class:`_DistFused`);
    otherwise autograd runs through the forward and the collectives.

    ``dropout_rate > 0`` drops attention weights as the single-device bucket
    path does for the same ``dropout_seed``, a uint32 given identically on
    every rank (``edge_dropout.seed_from_generator``): the edge hash keys on
    global original (dst, src) ids, rebased per rank and mapped back through
    the halo table and the plan's node permutation, so the mask is bitwise
    the single-device one.
    """
    rate = float(dropout_rate)
    if rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if rate > 0.0 and pg.halo is not None and pg.halo.table_global is None:
        # without the inverse map every lane would hash to one id
        # (correlated whole-row drops): refuse instead
        raise ValueError(
            "dropout on a halo-compressed partition requires the plan's table_global map; "
            "rebuild with partition_graph(...) (HaloExchange.table_global is None)")
    if score not in ("dot", "add"):
        raise ValueError(f"unknown score mode {score!r}")
    group, rank = mesh_group_rank(mesh, axis)
    if dist.get_world_size(group) != pg.n_devices:
        raise ValueError(f"a plan of {pg.n_devices} devices on a group of "
                         f"{dist.get_world_size(group)} ranks")
    a, b = (q, k) if score == "dot" else (e_row, e_col)
    if a.shape[0] != pg.n_local or v.shape[0] != pg.n_local:
        raise ValueError(f"takes this rank's block of {pg.n_local} rows (shard_nodes), "
                         f"got {a.shape[0]} and {v.shape[0]}")
    seed = int(dropout_seed) if rate > 0.0 else 0
    if pg.transpose is not None:
        return _DistFused.apply(a, b, v, pg, rank, group,
                                (score, float(negative_slope), rate, seed))
    sh = _shard(pg, rank, v.device)
    (out, _), tabs = _forward_local(pg, sh, group, a, b, v, score, negative_slope,
                                    sh.drop(seed, rate))
    if pg.shared_segments is not None:
        drop_sh = None if rate == 0.0 else _Drop(
            seed, rate, id_perm=sh.drop_maps["id_perm"], row_map=sh.drop_rows)
        out = _shared_forward(pg, sh, group, rank, a, tabs, v.shape[2], score,
                              negative_slope, drop_sh, out)
    return out


def shard_nodes(pg: EdgePartitionedGraph, x: Optional[torch.Tensor],
                rank: int) -> Optional[torch.Tensor]:
    """Rank ``rank``'s block of a node array ``x`` [n, ...] in the original
    order: permuted into plan order (``x[node_perm]``), padded to ``n_devices
    * n_local`` rows and cut.  Differentiable."""
    if x is None:
        return None
    if pg.node_perm is not None:
        x = x[pg.node_perm.to(x.device)]
    L = pg.n_local
    return _pad_nodes(x, L * pg.n_devices)[rank * L: (rank + 1) * L]


def gather_nodes(pg: EdgePartitionedGraph, out_l: torch.Tensor, mesh: DeviceMesh,
                 axis: Optional[str] = None) -> torch.Tensor:
    """Every rank's block of rows assembled into the graph's ``[n, ...]`` in
    the original order (an all-gather; its backward reduce-scatters)."""
    group, _ = mesh_group_rank(mesh, axis)
    out = comm.all_gather(out_l, group)[: pg.n_nodes]
    return out if pg.node_rank is None else out[pg.node_rank.to(out.device)]
