"""A check of the edge-partitioned plan: every shard's local forward, one
after another in one process, on the source table the plan's exchange would
deliver.  Imports torch and the port only, so the card's tests use it too.

The loop is a test of the plan, not a feature: the distributed forward
(``parallel.dist_graph_attention``) runs each shard in its own process and
moves the rows by collectives.
"""

import torch

from dfgnn_tpu_torch.ops import bucket as bk
from dfgnn_tpu_torch.parallel import partition as pt


def shard_inputs(pg, *xs):
    """Node inputs in the plan's order (``x[node_perm]``), padded to
    ``n_devices * n_local`` rows."""
    n_pad = pg.n_local * pg.n_devices
    perm = None if pg.node_perm is None else pg.node_perm.to(xs[0].device)
    return tuple(None if x is None else pt._pad_nodes(x if perm is None else x[perm], n_pad)
                 for x in xs)


def shard_tables(pg, b, v):
    """Per shard, the (score-side, v) source tables its exchange delivers:
    the whole padded ``b``, ``v`` for the all-gather plan, else
    ``x_d ++ concat_e x_e[send_local[e, d]] ++ 0``."""
    P, L = pg.n_devices, pg.n_local
    if pg.halo is None:
        return [(b, v)] * P
    local = lambda x, d: x[d * L: (d + 1) * L]
    sent = [(pt._halo_send_rows(pg, e, local(b, e)), pt._halo_send_rows(pg, e, local(v, e)))
            for e in range(P)]
    return [tuple(pt._halo_source_table(pg, local(x, d), torch.stack([s[i][d] for s in sent]))
                  for i, x in enumerate((b, v)))
            for d in range(P)]


def shard_forward(pg, d, a_l, tb, tv, f, *, score, negative_slope, seed, rate, device):
    """Shard ``d``'s local forward (out [n_local, h, f]) on its own layout
    slice, dropout context and source tables."""
    bg = pt._local_bg(pg, d, device)
    drop = pt._local_drop(pg, d, seed, rate, device)
    dot = score == "dot"
    tabs = bk._make_tabs(tb if dot else None, tv, None if dot else tb, score, None)
    out, _ = bk._forward_tabs(bg, a_l if dot else None, None if dot else a_l, tabs, tv.dtype, f,
                              score, negative_slope, 2048, drop=drop)
    return out


def shard_loop(pg, q, k, v, *, score="dot", e_row=None, e_col=None, negative_slope=0.2,
               seed=0, rate=0.0):
    """The concatenated shard outputs, cut to ``n`` rows and returned in the
    original node order: equal to the unpartitioned forward."""
    if pg.shared_segments is not None:
        # the loop is one process: the shared segments' cross-device merge
        # runs in dist_graph_attention, over torch.distributed
        raise ValueError("shared segments merge across devices in dist_graph_attention")
    device = v.device
    a, b = (q, k) if score == "dot" else (e_row, e_col)
    a, b, v = shard_inputs(pg, a, b, v)
    L = pg.n_local
    outs = [shard_forward(pg, d, a[d * L: (d + 1) * L], tb, tv, v.shape[2], score=score,
                          negative_slope=negative_slope, seed=seed, rate=rate, device=device)
            for d, (tb, tv) in enumerate(shard_tables(pg, b, v))]
    out = torch.cat(outs)[: pg.n_nodes]
    return out if pg.node_rank is None else out[pg.node_rank.to(device)]
