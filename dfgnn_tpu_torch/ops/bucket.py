"""Fused attention-aggregate over the degree-bucketed padded-CSR format.

The counterpart of :mod:`dfgnn_tpu.ops.bucket`, as torch ops: the JAX
package leaves this path to XLA, and the port leaves it to PyTorch's
operators on the card.  It covers the roles of the reference's ``csr``,
``softmax`` and ``tiling`` CUDA strategies: every row's SDDMM, softmax and
aggregation happen per chunk of rows of one degree bucket, with static
widths per bucket instead of dynamic shared memory.

The hot loop is a random gather of source-side rows (``_take_src``).  On
the card each chunk's gather is materialised in device memory, and each
chunk costs a round of kernel launches, so chunks are sized by
``_GATHER_BUDGET_BYTES`` for few launches at a bounded footprint.  By
default the source-side operands are packed into one gather table (k||v for
dot, e_col||v for add; ``packed=True``), so each edge costs one row gather
instead of one per operand.  Super-wide rows are laid out as fixed-width
segments whose partial (m, l, acc) states merge with the online-softmax
combine (the reference's tiling algebra, ``fused_gtconv_tiling.cu:72-86``);
with ``split_width=None`` the in-chunk tiled scan (``_tiled_chunk``) streams
them instead.  The source-blocked layout runs each block and merges the
blocks' rows exactly through their logsumexps.

Training backward: when the layout carries a transpose
(``build_buckets(with_transpose=True)``), :class:`_BucketFused` mirrors the
reference's fused backward (``fused_gtconv_backward.cu:231-265``): a
CSR-direction pass recomputes the scores from the saved per-row logsumexp
and reduces dQ (or d e_row) per row, and a CSC-direction pass over the
transposed layout reduces dK (or d e_col) and dV per source.  Both are
gather-based row reductions; the O(N h) lse replaces an O(E h) stash, and
dropout is regenerated from its seed.  Without a transpose, with
``gather_dtype`` or with edge values, autograd runs through the forward.

fp32 products need TF32 off (``torch.backends.cuda.matmul.allow_tf32``,
False by default) to meet the reference's rtol 1e-3 bar.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from dfgnn_tpu_torch.formats import BlockedBucketedGraph, Bucket, BucketedGraph, SegmentBucket
from dfgnn_tpu_torch.ops.edge_dropout import keep_scale, seed_from_generator

NEG_BIG = -1e30
_DEAD = 0.5 * NEG_BIG  # rows with lse below this have no edges

# Bytes of one chunk's gathered source tensor.  Each chunk's gather is a
# tensor in device memory and each chunk a round of about 20 kernel launches;
# at 512 MB the reddit stand-in's forward (about 21M padded lanes of 1 KB
# k||v rows at dim 128) walks about 40 chunks, with a peak of a few times the
# budget, a few GB of the H100's 80.  A row never spans a chunk, so the
# budget changes no number.
_GATHER_BUDGET_BYTES = 512 * 2 ** 20


class _Drop(NamedTuple):
    """Dropout context threaded through the fused paths.

    ``col_base`` rebases block-local lane ids to global (source-blocked
    layouts); ``row_base`` rebases device-local row ids to global;
    ``src_map`` (optional [table_rows] int) maps table rows back to global
    node ids; ``id_perm`` (optional [n+1] int) maps permuted node ids back to
    original ids, applied last to both sides.  Together these key the hash on
    the global original (dst, src) node pair in every layout, so the mask
    agrees bitwise across bucket, segment, blocked and transposed walks of
    the same edge.  ``row_map`` (optional), when set, replaces the row-side
    derivation: hash row id = ``row_map[dst]``.  The last four serve the
    edge-partitioned layouts: ``parallel.partition._local_drop`` sets
    ``row_base``, ``src_map`` and ``id_perm``; ``row_map`` serves the shared
    segments' cross-device merge (``parallel.partition._shared_forward``).
    """

    seed: int
    rate: float
    col_base: int = 0
    row_base: int = 0
    src_map: Optional[torch.Tensor] = None
    id_perm: Optional[torch.Tensor] = None
    row_map: Optional[torch.Tensor] = None


def _take(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(x, ids, axis=0, mode="clip")`` for ids >= 0, any shape."""
    flat = ids.reshape(-1).clamp_max(x.shape[0] - 1)
    return x.index_select(0, flat).reshape(*ids.shape, *x.shape[1:])


def _take_rows(x, row_ids):
    return None if x is None else _take(x, row_ids)


def _drop_lane_ids(drop: _Drop, lanes):
    """Global node ids of the lane side [C, W]: the block rebase first, then
    the table map."""
    if drop.src_map is not None:
        return _take(drop.src_map, lanes + drop.col_base)
    return lanes + drop.col_base


def _drop_orig_ids(drop: _Drop, ids):
    """Permuted global ids to original ids (identity without a permutation);
    sentinel ids clip to the map's last entry."""
    return ids if drop.id_perm is None else _take(drop.id_perm, ids)


def _drop_row_ids(drop: _Drop, dst):
    """Original global node ids of the row side."""
    if drop.row_map is not None:
        return _take(drop.row_map, dst)
    return _drop_orig_ids(drop, dst + drop.row_base)


def _keep_scale_chw(drop: _Drop, dst, src, h: int) -> torch.Tensor:
    """Per-(row, head, lane) dropout factor keep/(1-p) [C, h, W]; ``dst`` is
    the per-row id array [C], ``src`` the per-lane ids [C, W]."""
    head = torch.arange(h, device=src.device).view(1, h, 1)
    return keep_scale(drop.seed, _drop_row_ids(drop, dst)[:, None, None],
                      _drop_orig_ids(drop, _drop_lane_ids(drop, src))[:, None, :],
                      head, drop.rate)


def _keep_scale_chw_T(drop: _Drop, src, dst, h: int) -> torch.Tensor:
    """The transposed orientation (rows = sources, lanes = destinations); the
    lane-side rebases apply to the destination ids."""
    head = torch.arange(h, device=dst.device).view(1, h, 1)
    return keep_scale(drop.seed, _drop_orig_ids(drop, _drop_lane_ids(drop, dst))[:, None, :],
                      _drop_row_ids(drop, src)[:, None, None], head, drop.rate)


def _take_src(src, flat, C: int, W: int) -> torch.Tensor:
    """Row gather of one source-side table for a chunk -> [C, W, h, fs] fp32."""
    return _take(src, flat).reshape(C, W, src.shape[1], src.shape[-1]).float()


def _scores_from_k(k_n, q_c, er_c, emask, val, score, negative_slope):
    """Masked scores [C, h, W] from a gathered score-side operand: ``k_n`` is
    [C, W, h, f] for dot or [C, W, h] (e_col) for add."""
    if score == "dot":
        s = torch.einsum("chf,cwhf->chw", q_c.float(), k_n)
    else:
        s = er_c.float()[:, :, None] + k_n.transpose(1, 2).float()
        s = F.leaky_relu(s, negative_slope)
    if val is not None:
        s = s * val[:, None, :]
    return torch.where(emask[:, None, :], s, NEG_BIG)


def _chunk_scores(tabs, q_c, er_c, flat, C, W, emask, val, score, negative_slope):
    """Masked scores [C, h, W] for one chunk from the split score-side table
    (k for dot, e_col for add)."""
    st = tabs[0]
    if score == "dot":
        k_n = _take_src(st, flat, C, W)
    else:
        k_n = _take(st, flat).reshape(C, W, -1)
    return _scores_from_k(k_n, q_c, er_c, emask, val, score, negative_slope)


def _chunk_aggregate(tabs, w, flat, C, W):
    """out [C, h, f] = sum_w w * v_gathered, from the split v table."""
    return torch.einsum("chw,cwhf->chf", w, _take_src(tabs[-1], flat, C, W))


def _packed_gather(tabs, flat, C, W, f, score):
    """One gather of the packed (score-side || v) table -> (k_n, v_n):
    ``k_n`` [C, W, h, f] (dot) or [C, W, h] (add); ``v_n`` [C, W, h, f]."""
    kv = _take_src(tabs[0], flat, C, W)        # [C, W, h, fs + f]
    if score == "dot":
        return kv[..., :f], kv[..., f:]
    return kv[..., 0], kv[..., 1:]


def _pick_chunk(r_pad: int, W: int, row_bytes: int) -> int:
    """Rows per chunk so one chunk's gathered working set (the gathered row
    bytes of all its lanes) meets ``_GATHER_BUDGET_BYTES``."""
    desired = max(8, _GATHER_BUDGET_BYTES // max(W * row_bytes, 1))
    return min(r_pad, desired)


def _tabs_row_bytes(tabs) -> int:
    """Combined gathered bytes per edge across a chunk function's tables."""
    return sum(t[0].numel() * t.element_size() for t in tabs)


def _pad_rows(x, n: int, fill=0):
    """``x`` [r, ...] padded with ``fill`` rows to ``n`` rows (None stays None)."""
    if x is None or x.shape[0] >= n:
        return x
    return torch.cat([x, x.new_full((n - x.shape[0], *x.shape[1:]), fill)])


def _map_chunks(fn, arrays, fills, chunk: int):
    """``fn`` over row chunks of ``arrays`` (each [r, ...] or None), the last
    chunk padded with ``fills``.  Returns the padded arrays and ``fn``'s
    results concatenated over the padded rows."""
    r = arrays[0].shape[0]
    r2 = -(-r // chunk) * chunk
    arrays = tuple(_pad_rows(x, r2, fill) for x, fill in zip(arrays, fills))
    parts = [fn(tuple(None if x is None else x[i: i + chunk] for x in arrays))
             for i in range(0, r2, chunk)]
    return arrays, tuple(torch.cat(p) if len(p) > 1 else p[0] for p in zip(*parts))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _direct_chunk(args, q, e_row, tabs, f, score, negative_slope, drop=None,
                  want_s=False):
    """One row chunk whose width is at most the tile: (out [C, h, f],
    lse [C, h]) and, with ``want_s``, the masked scores."""
    row_ids, nbr, emask, val = args
    C, W = nbr.shape
    h = tabs[0].shape[1]
    flat = nbr.reshape(-1)
    q_c = _take_rows(q, row_ids)
    er_c = _take_rows(e_row, row_ids)
    if len(tabs) == 1:
        k_n, v_n = _packed_gather(tabs, flat, C, W, f, score)
        s = _scores_from_k(k_n, q_c, er_c, emask, val, score, negative_slope)
    else:
        v_n = None
        s = _chunk_scores(tabs, q_c, er_c, flat, C, W, emask, val, score, negative_slope)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_BIG)
    ex = torch.where(emask[:, None, :], torch.exp(s - m), 0.0)
    den = ex.sum(dim=-1, keepdim=True)
    w = torch.where(den > 0, ex / torch.where(den > 0, den, 1.0), 0.0)
    if drop is not None:
        # numerator-only: dropout acts on the normalised weights
        w = w * _keep_scale_chw(drop, row_ids, nbr, h)
    if v_n is not None:
        out = torch.einsum("chw,cwhf->chf", w, v_n)
    else:
        out = _chunk_aggregate(tabs, w, flat, C, W)
    lse = torch.where(den > 0, m + torch.log(torch.where(den > 0, den, 1.0)), NEG_BIG)
    if want_s:
        return out, lse[..., 0], s
    return out, lse[..., 0]


def _tiled_chunk(args, q, e_row, tabs, f, score, negative_slope, tile_width, drop=None):
    """One row chunk of a super-wide bucket: stream neighbour tiles with
    online-softmax rescaling (the reference's tiling algebra)."""
    row_ids, nbr, emask, val = args
    C, W = nbr.shape
    h = tabs[0].shape[1]
    q_c = _take_rows(q, row_ids)
    er_c = _take_rows(e_row, row_ids)
    # carries are fp32 whatever the gather dtype
    m = torch.full((C, h, 1), NEG_BIG, device=nbr.device)
    l = torch.zeros((C, h, 1), device=nbr.device)
    acc = torch.zeros((C, h, f), device=nbr.device)
    for lo in range(0, W, tile_width):
        sl = nbr[:, lo: lo + tile_width]
        msl = emask[:, lo: lo + tile_width]
        vsl = None if val is None else val[:, lo: lo + tile_width]
        flat = sl.reshape(-1)
        if len(tabs) == 1:
            k_n, v_n = _packed_gather(tabs, flat, C, tile_width, f, score)
            s = _scores_from_k(k_n, q_c, er_c, msl, vsl, score, negative_slope)
        else:
            v_n = None
            s = _chunk_scores(tabs, q_c, er_c, flat, C, tile_width, msl, vsl, score,
                              negative_slope)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        scale = torch.exp(m - m_new)
        ex = torch.where(msl[:, None, :], torch.exp(s - m_new), 0.0)
        l = l * scale + ex.sum(dim=-1, keepdim=True)
        exn = ex if drop is None else ex * _keep_scale_chw(drop, row_ids, sl, h)
        if v_n is not None:
            upd = torch.einsum("chw,cwhf->chf", exn, v_n)
        else:
            upd = _chunk_aggregate(tabs, exn, flat, C, tile_width)
        acc = acc * scale + upd
        m = m_new
    out = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), NEG_BIG)
    return out, lse[..., 0]


def _segment_partials(args, q, e_row, tabs, f, score, negative_slope, drop=None,
                      want_s=False):
    """Per-segment partial softmax state (m, l, acc) for one chunk of
    fixed-width segments (one tile of the reference's tiling kernel each)."""
    seg_dst, nbr, emask, val = args
    C, W = nbr.shape
    h = tabs[0].shape[1]
    q_c = _take_rows(q, seg_dst)
    er_c = _take_rows(e_row, seg_dst)
    flat = nbr.reshape(-1)
    if len(tabs) == 1:
        k_n, v_n = _packed_gather(tabs, flat, C, W, f, score)
        s = _scores_from_k(k_n, q_c, er_c, emask, val, score, negative_slope)
    else:
        v_n = None
        s = _chunk_scores(tabs, q_c, er_c, flat, C, W, emask, val, score, negative_slope)
    m = s.amax(dim=-1)                                        # [C, h]
    ex = torch.where(emask[:, None, :], torch.exp(s - m[..., None]), 0.0)
    l = ex.sum(dim=-1)                                        # [C, h]
    exn = ex if drop is None else ex * _keep_scale_chw(drop, seg_dst, nbr, h)
    if v_n is not None:
        acc = torch.einsum("chw,cwhf->chf", exn, v_n)
    else:
        acc = _chunk_aggregate(tabs, exn, flat, C, W)
    if want_s:
        return m, l, acc, s
    return m, l, acc


def _run_bucket(b: Bucket, chunk_fn, row_bytes: int, n_nodes: int):
    """``chunk_fn`` over one bucket's row chunks: (row ids padded to whole
    chunks with the sentinel, results over those rows)."""
    chunk = _pick_chunk(b.nbr.shape[0], b.width, row_bytes)
    (row_ids, *_), res = _map_chunks(chunk_fn, (b.row_ids, b.nbr, b.emask, b.val),
                                     (n_nodes, n_nodes, False, 0.0), chunk)
    return row_ids, res


def _run_segments(sb: SegmentBucket, chunk_fn, row_bytes: int, n_nodes: int):
    """``chunk_fn`` over segment chunks; results per segment [s_pad, ...].
    The last chunk is padded with masked segments, so any chunk size works."""
    s_pad = sb.nbr.shape[0]
    chunk = _pick_chunk(s_pad, sb.width, row_bytes)
    _, res = _map_chunks(chunk_fn, (sb.seg_dst, sb.nbr, sb.emask, sb.val),
                         (n_nodes, n_nodes, False, 0.0), chunk)
    return tuple(r[:s_pad] for r in res)


def _segsum(x, seg_id, bins: int):
    # index_put_ with accumulate sums each bin's rows in a fixed order, where
    # index_add's CUDA atomics sum them in a different order each run
    return x.new_zeros((bins, *x.shape[1:])).index_put_((seg_id,), x, accumulate=True)


def _make_tabs(k, v, e_col, score, gather_dtype, packed=True):
    """Source-side gather tables.

    ``packed=True``: one table whose rows concatenate the score-side operand
    and v (``k||v`` [N, h, 2f] for dot, ``e_col||v`` [N, h, 1+f] for add), so
    each edge costs one row gather.  ``packed=False``: separate ``(st, vt)``
    tables (the ablation baseline)."""
    if score == "dot":
        st = k                       # [N, h, f]
    elif score == "add":
        st = e_col                   # [N, h]
    else:
        raise ValueError(f"unknown score mode {score!r}")
    vt = v
    if gather_dtype is not None:
        st = st.to(gather_dtype)
        vt = vt.to(gather_dtype)
    if packed:
        if score == "add":
            st = st[..., None]       # [N, h, 1]
        return (torch.cat([st, vt.to(st.dtype)], dim=-1),)
    return (st, vt)


def _scatter_edge_vals(acc, eids, r_pad2: int, vals, fill: int):
    """Per-lane values [r_pad2, h, W] into the edge-ordered accumulator
    [e_pad + 1, h] through the layout's edge ids (the reference's
    materialised ``attn_edge`` order)."""
    flat = _pad_rows(eids, r_pad2, fill).reshape(-1)
    return acc.index_copy(0, flat, vals.transpose(1, 2).reshape(-1, vals.shape[1]))


def _forward_tabs(bg, q, e_row, tabs, out_dtype, f, score, negative_slope, tile_width,
                  drop=None, weights_acc=None):
    """Forward over one (possibly source-block-local) set of gather tables;
    returns (out [n, h, f], lse [n, h]) and, with ``weights_acc`` (edge-order
    accumulators (scores [e_pad+1, h], dst [e_pad+1])), the accumulators."""
    h = tabs[0].shape[1]
    row_bytes = _tabs_row_bytes(tabs)
    want_s = weights_acc is not None
    n = bg.n_nodes
    dev = tabs[0].device

    out = torch.zeros((n + 1, h, f), dtype=out_dtype, device=dev)
    lse = torch.full((n + 1, h), NEG_BIG, device=dev)
    for b in bg.buckets:
        W = b.width
        if W <= tile_width:
            fn = lambda a: _direct_chunk(a, q, e_row, tabs, f, score, negative_slope, drop,
                                         want_s)
        else:
            if want_s:
                raise NotImplementedError(
                    "return_weights with tiled super-wide buckets: build the layout "
                    "with split_width (segments) instead")
            tw = tile_width if W % tile_width == 0 else W
            fn = lambda a: _tiled_chunk(a, q, e_row, tabs, f, score, negative_slope, tw,
                                        drop)
        row_ids, res = _run_bucket(b, fn, row_bytes, n)
        out = out.index_copy(0, row_ids, res[0].to(out_dtype))
        lse = lse.index_copy(0, row_ids, res[1])
        if want_s:
            sc, dst = weights_acc
            fill = sc.shape[0] - 1
            sc = _scatter_edge_vals(sc, b.edge_ids, row_ids.shape[0], res[2], fill)
            eids = _pad_rows(b.edge_ids, row_ids.shape[0], fill)
            dst = dst.index_copy(0, eids.reshape(-1),
                                 row_ids[:, None].expand(-1, W).reshape(-1))
            weights_acc = (sc, dst)

    sb = bg.segments
    if sb is not None:
        fn = lambda a: _segment_partials(a, q, e_row, tabs, f, score, negative_slope, drop,
                                         want_s)
        seg_res = _run_segments(sb, fn, row_bytes, n)
        m_s, l_s, acc_s = seg_res[:3]
        if want_s:
            sc, dst = weights_acc
            fill = sc.shape[0] - 1
            sc = _scatter_edge_vals(sc, sb.edge_ids, m_s.shape[0], seg_res[3], fill)
            dst = dst.index_copy(0, sb.edge_ids.reshape(-1),
                                 sb.seg_dst[:, None].expand(-1, sb.width).reshape(-1))
            weights_acc = (sc, dst)
        R = sb.wide_rows.shape[0]
        bins = R + 1  # the last bin absorbs segment padding
        seg_id = sb.seg_id
        m_r = torch.full((bins, h), NEG_BIG, device=dev).scatter_reduce(
            0, seg_id[:, None].expand(-1, h), m_s, reduce="amax", include_self=True)
        scale = torch.exp(m_s - m_r[seg_id])
        l_r = _segsum(l_s * scale, seg_id, bins)
        acc_r = _segsum(acc_s * scale[..., None], seg_id, bins)
        live = l_r[..., None] > 0
        out_r = torch.where(live, acc_r / torch.where(live, l_r[..., None], 1.0), 0.0)
        lse_r = torch.where(l_r > 0, m_r + torch.log(torch.where(l_r > 0, l_r, 1.0)),
                            NEG_BIG)
        out = out.index_copy(0, sb.wide_rows, out_r[:R].to(out_dtype))
        lse = lse.index_copy(0, sb.wide_rows, lse_r[:R])
    if want_s:
        return out[:n], lse[:n], weights_acc
    return out[:n], lse[:n]


# ---------------------------------------------------------------------------
# Source-blocked layout: a forward per block and an exact logsumexp merge
# ---------------------------------------------------------------------------

def _iter_blocks(layout, tabs):
    """(BucketedGraph, block's tables, col_base) per source block, or once
    for a flat layout.  ``col_base`` rebases a block's local neighbour ids to
    global (the layout-invariant dropout hash needs them)."""
    if isinstance(layout, BlockedBucketedGraph):
        B = layout.block_rows
        tabs = tuple(_pad_rows(t, len(layout.blocks) * B) for t in tabs)
        for bi, bg_b in enumerate(layout.blocks):
            yield bg_b, tuple(t[bi * B: (bi + 1) * B] for t in tabs), bi * B
    else:
        yield layout, tabs, 0


def _merge_blocks(outs, lses):
    """Exact cross-block softmax combine from per-block (out, lse)."""
    L = torch.stack(lses)                   # [nb, n, h]
    O = torch.stack(outs)                   # [nb, n, h, f]
    m = L.amax(dim=0).clamp_min(NEG_BIG)
    w = torch.where(L > _DEAD, torch.exp(L - m), 0.0)
    den = w.sum(dim=0)
    out = torch.einsum("bnh,bnhf->nhf", w, O)
    live = den[..., None] > 0
    out = torch.where(live, out / torch.where(live, den[..., None], 1.0), 0.0)
    lse = torch.where(den > 0, m + torch.log(torch.where(den > 0, den, 1.0)), NEG_BIG)
    return out, lse


def _blocked_forward(bbg, q, k, v, score, e_row, e_col, negative_slope, tile_width,
                     gather_dtype, drop=None, weights_acc=None, packed=True):
    tabs = _make_tabs(k, v, e_col, score, gather_dtype, packed)
    outs, lses = [], []
    for bg_b, sub_tabs, col_base in _iter_blocks(bbg, tabs):
        drop_b = None if drop is None else drop._replace(col_base=col_base)
        r = _forward_tabs(bg_b, q, e_row, sub_tabs, torch.float32, v.shape[2], score,
                          negative_slope, tile_width, drop=drop_b, weights_acc=weights_acc)
        if weights_acc is not None:
            o, l, weights_acc = r
        else:
            o, l = r
        outs.append(o)
        lses.append(l)
    out, lse = _merge_blocks(outs, lses)
    if weights_acc is not None:
        return out.to(v.dtype), lse, weights_acc
    return out.to(v.dtype), lse


def _any_forward(bg, q, k, v, score, e_row, e_col, negative_slope, tile_width,
                 gather_dtype, drop=None, weights_acc=None, packed=True):
    if isinstance(bg, BlockedBucketedGraph):
        return _blocked_forward(bg, q, k, v, score, e_row, e_col, negative_slope,
                                tile_width, gather_dtype, drop=drop,
                                weights_acc=weights_acc, packed=packed)
    tabs = _make_tabs(k, v, e_col, score, gather_dtype, packed)
    return _forward_tabs(bg, q, e_row, tabs, v.dtype, v.shape[2], score, negative_slope,
                         tile_width, drop=drop, weights_acc=weights_acc)


# ---------------------------------------------------------------------------
# Custom backward (the reference's design, fused_gtconv_backward.cu:231-265):
# the CSR direction recomputes scores from lse and reduces dQ per row; the
# CSC direction (transposed layout) reduces dK/dV per source.  Both gather.
# ---------------------------------------------------------------------------

def _p_from_scores(s, emask, lse_c):
    """Normalised attention from recomputed scores and the saved logsumexp."""
    live = lse_c > _DEAD
    return torch.where(emask[:, None, :] & live[..., None],
                       torch.exp(s - torch.where(live, lse_c, 0.0)[..., None]), 0.0)


def _bwd_csr_chunk(args, a_row, do, lse, delta, tabs, f, score, negative_slope, drop=None):
    """CSR-direction backward chunk: dQ (dot) or d e_row (add).

    The reference's ``fused_backward_kernel``: recompute the SDDMM, take the
    softmax gradient dS = P * (dP - delta) and reduce it against K per row.
    With dropout the regenerated mask applies to dP (out = (P * M') V, so
    dP = (dO . V^T) * M'; delta = <dO, out> already agrees with the mask).
    A packed layout gathers one k||v row per lane for all three products."""
    row_ids, nbr, emask, val = args
    C, W = nbr.shape
    h = tabs[0].shape[1]
    flat = nbr.reshape(-1)
    do_c = _take_rows(do, row_ids)
    lse_c = _take_rows(lse, row_ids)
    delta_c = _take_rows(delta, row_ids)
    a_c = _take_rows(a_row, row_ids)
    packed = len(tabs) == 1
    if packed:
        k_n, v_n = _packed_gather(tabs, flat, C, W, f, score)
    else:
        k_n = (_take_src(tabs[0], flat, C, W) if score == "dot"
               else _take(tabs[0], flat).reshape(C, W, h))
        v_n = _take_src(tabs[-1], flat, C, W)
    if score == "dot":
        s = torch.einsum("chf,cwhf->chw", a_c.float(), k_n)
        pre = None
    else:
        pre = a_c.float()[:, :, None] + k_n.transpose(1, 2).float()
        s = F.leaky_relu(pre, negative_slope)
    if val is not None:
        s = s * val[:, None, :]
    s = torch.where(emask[:, None, :], s, NEG_BIG)
    p = _p_from_scores(s, emask, lse_c)
    dp = torch.einsum("chf,cwhf->chw", do_c, v_n)
    if drop is not None:
        dp = dp * _keep_scale_chw(drop, row_ids, nbr, h)
    ds = p * (dp - delta_c[..., None])
    if val is not None:
        ds = ds * val[:, None, :]
    if score == "dot":
        return (torch.einsum("chw,cwhf->chf", ds, k_n),)
    dpre = torch.where(pre >= 0, ds, ds * negative_slope)
    return (dpre.sum(dim=2),)              # d e_row [C, h]


def _bwd_csc_chunk(args, b_col, v_full, tabsT, f, score, negative_slope, drop=None):
    """CSC-direction backward chunk over the transposed layout: rows are
    sources j; returns (dK_j, dV_j) for dot or (d e_col_j, dV_j) for add.

    The reference's ``spmm_backward_kernel``, gather-based: the transposed
    buckets replace the CSC and edge-permutation arrays.  Dropout: rows are
    sources and lanes destinations, so the hash orientation swaps; dV uses
    the masked P, dK / d e_col use dS with the mask applied to dP.
    ``tabsT``: destination-side operands, packed (one a||dO||lse||delta row
    per destination) or split ``(a, dO, [lse, delta])``."""
    row_ids, nbr, emask, val = args
    C, W = nbr.shape
    h = tabsT[0].shape[1]
    flat = nbr.reshape(-1)
    fs = f if score == "dot" else 1
    if len(tabsT) == 1:
        g = _take_src(tabsT[0], flat, C, W)              # [C, W, h, fs + f + 2]
        a_n = g[..., :fs]
        do_n = g[..., fs: fs + f]
        lse_n = g[..., fs + f].transpose(1, 2)           # [C, h, W]
        delta_n = g[..., fs + f + 1].transpose(1, 2)
    else:
        aT, doT, ldT = tabsT
        ld = _take(ldT, flat).reshape(C, W, h, 2)
        lse_n = ld[..., 0].transpose(1, 2)
        delta_n = ld[..., 1].transpose(1, 2)
        a_n = (_take_src(aT, flat, C, W) if score == "dot"
               else _take(aT, flat).reshape(C, W, h)[..., None])
        do_n = _take_src(doT, flat, C, W)
    if score == "dot":
        k_j = _take_rows(b_col, row_ids)                 # [C, h, f]
        s = torch.einsum("chf,cwhf->chw", k_j.float(), a_n.float())
        pre = None
    else:
        ec_j = _take_rows(b_col, row_ids)                # [C, h]
        pre = a_n[..., 0].transpose(1, 2).float() + ec_j.float()[:, :, None]
        s = F.leaky_relu(pre, negative_slope)
    if val is not None:
        s = s * val[:, None, :]
    s = torch.where(emask[:, None, :], s, NEG_BIG)
    live = lse_n > _DEAD
    p = torch.where(emask[:, None, :] & live,
                    torch.exp(s - torch.where(live, lse_n, 0.0)), 0.0)
    v_j = _take_rows(v_full, row_ids)                    # [C, h, f]
    dp = torch.einsum("chf,cwhf->chw", v_j.float(), do_n)
    p_num = p
    if drop is not None:
        ks = _keep_scale_chw_T(drop, row_ids, nbr, h)
        dp = dp * ks
        p_num = p * ks
    ds = p * (dp - delta_n)
    if val is not None:
        ds = ds * val[:, None, :]
    dv_j = torch.einsum("chw,cwhf->chf", p_num, do_n)
    if score == "dot":
        return torch.einsum("chw,cwhf->chf", ds, a_n.float()), dv_j
    dpre = torch.where(pre >= 0, ds, ds * negative_slope)
    return dpre.sum(dim=2), dv_j                         # d e_col [C, h]


def _walk_backward(bg, chunk_fn, out_shapes, row_bytes, device):
    """``chunk_fn`` over all buckets and segments of a layout, its per-row
    results written into zero outputs [n_nodes, ...].  Backward quantities
    are plain sums over a row's edges, so segment results combine with a
    segment sum (no online merge)."""
    n = bg.n_nodes
    outs = [torch.zeros((n + 1, *s), device=device) for s in out_shapes]
    for b in bg.buckets:
        row_ids, res = _run_bucket(b, chunk_fn, row_bytes, n)
        outs = [o.index_copy_(0, row_ids, r) for o, r in zip(outs, res)]
    sb = bg.segments
    if sb is not None:
        res = _run_segments(sb, chunk_fn, row_bytes, n)
        R = sb.wide_rows.shape[0]
        outs = [o.index_copy_(0, sb.wide_rows, _segsum(r, sb.seg_id, R + 1)[:R])
                for o, r in zip(outs, res)]
    return [o[:n] for o in outs]


def _layout_has_val(bg) -> bool:
    if isinstance(bg, BlockedBucketedGraph):
        return any(_layout_has_val(b) for b in bg.blocks)
    return any(b.val is not None for b in bg.buckets) or (
        bg.segments is not None and bg.segments.val is not None)


class _BucketFused(torch.autograd.Function):
    """The bucket forward with the fused custom backward: saves (a, b, v,
    out, lse), never an O(E) mask; dropout is regenerated from ``seed``.
    ``a, b`` are (q, k) for dot and (e_row, e_col) for add."""

    @staticmethod
    def forward(ctx, a, b, v, bg, meta, seed):
        score, slope, tile_width, rate, packed = meta
        drop = None if rate == 0.0 else _Drop(seed, rate)
        dot = score == "dot"
        out, lse = _any_forward(bg, a if dot else None, b if dot else None, v, score,
                                None if dot else a, None if dot else b, slope, tile_width,
                                None, drop=drop, packed=packed)
        ctx.save_for_backward(a, b, v, out, lse)
        ctx.bg, ctx.meta, ctx.seed = bg, meta, seed
        return out

    @staticmethod
    def backward(ctx, do):
        a, b, v, out, lse = ctx.saved_tensors
        bg, seed = ctx.bg, ctx.seed
        score, slope, _, rate, packed = ctx.meta
        dot = score == "dot"
        h, f = v.shape[1], v.shape[2]
        do = do.float()
        delta = torch.einsum("nhf,nhf->nh", do, out.float())

        # CSR direction: dQ / d e_row from P recomputed against the saved lse
        tabs = _make_tabs(b if dot else None, v, None if dot else b, score, None,
                          packed=packed)
        csr_bytes = _tabs_row_bytes(tabs)
        da = None
        for bg_b, sub_tabs, col_base in _iter_blocks(bg, tabs):
            drop_b = None if rate == 0.0 else _Drop(seed, rate, col_base=col_base)
            (da_b,) = _walk_backward(
                bg_b, lambda args: _bwd_csr_chunk(args, a, do, lse, delta, sub_tabs, f,
                                                  score, slope, drop_b),
                [(h, f)] if dot else [(h,)], csr_bytes, v.device)
            da = da_b if da is None else da + da_b

        # CSC direction over the transposed layout: dK / d e_col, and dV
        ldT = torch.stack([lse, delta], dim=-1)          # [N, h, 2]
        if packed:
            a3 = a if dot else a[..., None]              # [N, h, fs]
            tabsT = (torch.cat([a3.float(), do, ldT], dim=-1),)
        else:
            tabsT = (a, do, ldT)
        csc_bytes = _tabs_row_bytes(tabsT)
        db = dv = None
        for bgT_b, subT, col_base in _iter_blocks(bg.transpose, tabsT):
            drop_b = None if rate == 0.0 else _Drop(seed, rate, col_base=col_base)
            db_b, dv_b = _walk_backward(
                bgT_b, lambda args: _bwd_csc_chunk(args, b, v, subT, f, score, slope,
                                                   drop_b),
                [(h, f), (h, f)] if dot else [(h,), (h, f)], csc_bytes, v.device)
            db = db_b if db is None else db + db_b
            dv = dv_b if dv is None else dv + dv_b
        return da.to(a.dtype), db.to(b.dtype), dv.to(v.dtype), None, None, None


def bucket_graph_attention(
    bg,
    q: Optional[torch.Tensor],
    k: Optional[torch.Tensor],
    v: torch.Tensor,
    *,
    score: str = "dot",
    e_row: Optional[torch.Tensor] = None,
    e_col: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    tile_width: int = 2048,
    gather_dtype: Optional[torch.dtype] = None,
    dropout_rate: float = 0.0,
    dropout_generator: Optional[torch.Generator] = None,
    return_weights: bool = False,
    packed: bool = True,
):
    """Fused SDDMM -> edge-softmax -> SpMM over all degree buckets.

    ``q, k, v``: ``[n_nodes, h, f]`` (dot) or ``e_row, e_col``: ``[n_nodes,
    h]`` (add).  Returns ``[n_nodes, h, f]`` in v's dtype; rows with no edges
    give zeros.  ``bg`` is a :class:`BucketedGraph` or
    :class:`BlockedBucketedGraph` on the tensors' device.

    When ``bg`` carries a transposed layout, ``gather_dtype`` is None and the
    layout has no edge values, gradients flow through the fused custom
    backward (:class:`_BucketFused`); otherwise autograd runs through the
    forward.

    ``dropout_rate > 0`` drops attention weights with 1/(1-p) rescaling
    through the layout-invariant edge hash of
    :mod:`dfgnn_tpu_torch.ops.edge_dropout`, seeded by one uint32 drawn from
    the CPU ``dropout_generator``; the custom backward regenerates the same
    mask from the seed.

    ``gather_dtype=torch.bfloat16`` halves the bytes of the gathered source
    table; scores and sums stay fp32 (about 1e-2 relative error, outside the
    reference's rtol 1e-3 bar, so it is opt-in).  ``packed=False`` gathers
    one row per operand and edge instead of one packed row (the ablation
    baseline).  ``return_weights=True`` also returns the normalised
    pre-dropout weights ``[e_pad, h]`` in CSR edge order; it needs a layout
    with edge ids (``preprocess("two_phase", g)``).
    """
    if score not in ("dot", "add"):
        raise ValueError(f"unknown score mode {score!r}")
    rate = float(dropout_rate)
    if rate > 0.0 and dropout_generator is None:
        raise ValueError("dropout_rate > 0 requires dropout_generator")
    seed = seed_from_generator(dropout_generator) if rate > 0.0 else 0
    drop = None if rate == 0.0 else _Drop(seed, rate)
    if return_weights:
        # the materialised-score mode (the reference softmax strategy's
        # attn_edge): autograd through the forward
        if bg.e_pad <= 0:
            raise ValueError(
                "return_weights needs an edge-id layout: build with "
                "formats.preprocess('two_phase', g) / build_buckets(with_edge_ids=True)")
        h = v.shape[1]
        sc0 = torch.full((bg.e_pad + 1, h), NEG_BIG, device=v.device)
        dst0 = torch.full((bg.e_pad + 1,), bg.n_nodes, dtype=torch.long, device=v.device)
        out, lse, (sc, dst) = _any_forward(
            bg, q, k, v, score, e_row, e_col, negative_slope, tile_width, gather_dtype,
            drop=drop, weights_acc=(sc0, dst0))
        lse_e = _take(lse, dst[: bg.e_pad])
        sc = sc[: bg.e_pad]
        live = (sc > _DEAD) & (lse_e > _DEAD)
        w = torch.where(live, torch.exp(sc - torch.where(live, lse_e, 0.0)), 0.0)
        return out, w
    # the custom backward treats edge values as constants (the reference's
    # fixed A.val); with val arrays autograd runs through the forward
    if bg.transpose is not None and gather_dtype is None and not _layout_has_val(bg):
        meta = (score, negative_slope, tile_width, rate, packed)
        if score == "dot":
            return _BucketFused.apply(q, k, v, bg, meta, seed)
        return _BucketFused.apply(e_row, e_col, v, bg, meta, seed)
    out, _ = _any_forward(bg, q, k, v, score, e_row, e_col, negative_slope, tile_width,
                          gather_dtype, drop=drop, packed=packed)
    return out
