"""Degree-balanced row->device assignment for edge partitioning.

A copy of :mod:`dfgnn_tpu.parallel.balance`: the same numpy and the same heap
deal, so the permutation is bitwise the JAX package's.

Every device of an SPMD step runs the same shapes, so the plan pads each
device's per-width bucket to the largest row count over the devices
(``partition.py``'s ``row_pad_to``) and, for the segment layout, to the
largest segment count.  Under contiguous blocking of an arbitrary node order
the per-device degree histograms are uneven, so the largest count exceeds
the mean and the padded-edge factor grows with the device count.

This module computes a node permutation that *deals* the rows of each
width class round-robin across the device blocks (heaviest classes first;
segment-layout rows LPT-balanced by their segment count; zero-degree rows
as free filler), making per-class per-device counts equal within 1.  The
largest count then equals the mean and the padded factor stays near the
single-device layout's own padding at any device count.

The permutation destroys id locality: it is the default for the
all-gather exchange (node order does not change its volume) and is off by
default when ``partition_graph(halo=...)`` or ``reorder=...`` asks for a
locality-preserving order.  Host-side numpy, O(E + n log P).
"""

from __future__ import annotations

import heapq

import numpy as np


def balance_perm(
    deg: np.ndarray,
    n_devices: int,
    widths,
    split_width: int,
    use_segments: bool,
) -> np.ndarray:
    """Return ``perm`` (old node ids in new order) such that the
    contiguous ``n_local``-row device blocks of the new order have
    near-equal per-width-class row counts.

    ``deg`` is the per-destination-row degree (CSR row lengths);
    ``widths``/``split_width``/``use_segments`` must match the bucket
    plan ``partition_graph`` will build, so the classes balanced here are
    exactly the classes harmonized there.
    """
    deg = np.asarray(deg, dtype=np.int64)
    n = deg.size
    P = int(n_devices)
    if n == 0 or P <= 1:
        return np.arange(n, dtype=np.int64)
    n_local = -(-n // P)
    # per-device row capacity under contiguous blocking: full blocks, then
    # one short block, then empty tail blocks (mirrors partition_graph's
    # hi_r = min((d+1)*n_local, n))
    cap = np.minimum(n_local, np.maximum(0, n - np.arange(P) * n_local))

    widths = list(widths)
    # class id per row: searchsorted puts deg in (widths[i-1], widths[i]]
    # at i; deg > widths[-1] lands at len(widths) = the segment class
    cls = np.searchsorted(widths, deg)
    assign = np.full(n, -1, np.int32)
    counts = np.zeros(P, np.int64)

    # --- segment-layout rows: LPT on segment count -----------------------
    if use_segments:
        seg_rows = np.nonzero(deg > split_width)[0]
        if seg_rows.size:
            w = -(-deg[seg_rows] // split_width)
            order = np.argsort(-w, kind="stable")
            heap = [(0, d) for d in range(P)]  # (segload, device)
            heapq.heapify(heap)
            for r in seg_rows[order]:
                while True:
                    load, d = heapq.heappop(heap)
                    if counts[d] < cap[d]:
                        break
                assign[r] = d
                counts[d] += 1
                heapq.heappush(heap, (load + int(-(-deg[r] // split_width)), d))

    # --- width classes, heaviest first, round-robin dealing --------------
    start = 0

    def deal(rows: np.ndarray) -> None:
        nonlocal start
        i = 0
        while i < rows.size:
            avail = np.nonzero(counts < cap)[0]
            k = min(avail.size, rows.size - i)
            pick = avail[(start + np.arange(k)) % avail.size]
            assign[rows[i : i + k]] = pick
            counts[pick] += 1  # picks are distinct within a round
            start += k
            i += k

    for c in range(len(widths) - 1, -1, -1):
        deal(np.nonzero((cls == c) & (deg > 0) & (assign < 0))[0])
    # zero-degree rows cost nothing in any bucket — pure filler
    deal(np.nonzero(deg == 0)[0])

    assert (assign >= 0).all() and (counts == cap).all()
    # stable sort by device groups rows into contiguous device blocks in
    # assignment order; block d starts exactly at d*n_local because only
    # trailing devices have cap < n_local
    return np.argsort(assign, kind="stable").astype(np.int64)
