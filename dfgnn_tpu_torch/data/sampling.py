"""Neighbourhood sampling for mini-batch training on large graphs.

The counterpart of :mod:`dfgnn_tpu.data.sampling`: GraphSAGE-style layered
uniform sampling on the host.  A sampled layer is one fixed-width
:class:`~dfgnn_tpu_torch.formats.Bucket` (``[n_seeds, fanout]`` padded
neighbour ids), so the bucket attention path consumes sampled blocks with
no format of its own, and re-sampling never changes a shape.

The draws are the JAX package's, bitwise: its native library's xorshift64
reservoir (``sample_neighbors``), run from the port's own copy of that C++
(:func:`dfgnn_tpu_torch.native.sample_neighbors`), so one seed gives both
packages the same blocks.  :func:`sample_neighbors_plain` is the same
sampler in numpy, the plain version the tests hold the library against.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dfgnn_tpu_torch import native
from dfgnn_tpu_torch.formats import Bucket, BucketedGraph, _fill_rows, _to
from dfgnn_tpu_torch.graph import Graph, _round_up

_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class SampledBlock:
    """One message-passing layer's sampled bipartite block.

    ``bg`` computes ``out[i] = attention over nbr[i]`` for seed i; ``seeds``
    are the ids of the output rows in the table the query side is gathered
    from (sentinel past its end); ``nbr`` indexes the source-side tables.
    The sampler fills both with numpy arrays on the host; :meth:`to` moves
    them to a device as tensors (int64 ids), as ``device_put`` does in the
    JAX package.
    """

    bg: BucketedGraph
    seeds: torch.Tensor      # [s_pad] int64 (sentinel: the query table's length)
    n_seeds: int = 0

    def to(self, device) -> "SampledBlock":
        return _to(self, device)


def _xorshift_states(seed: int, count: int) -> np.ndarray:
    """The first ``count`` states of the C++ sampler's xorshift64 (shifts 13,
    7, 17 from ``seed | 1``), wrapping at 2**64."""
    state = (int(seed) & _MASK64) | 1
    out = [0] * count
    for t in range(count):
        state ^= (state << 13) & _MASK64
        state ^= state >> 7
        state ^= (state << 17) & _MASK64
        out[t] = state
    return np.array(out, dtype=np.uint64)


def sample_neighbors_plain(seeds: np.ndarray, indptr: np.ndarray, cols: np.ndarray,
                           fanout: int, sentinel: int, seed: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy plain version of :func:`native.sample_neighbors`, bitwise:
    per seed, its whole row when the degree is at most ``fanout``, else a
    reservoir sample of ``fanout`` neighbours.  One xorshift stream serves
    every seed of the call, in seed order; row i's draw j (``fanout <= j <
    d``) is ``k = next() % (j + 1)``, and ``k < fanout`` replaces slot k.
    Returns (nbr [n_seeds, fanout] int32 padded with ``sentinel``, mask)."""
    seeds = np.asarray(seeds, dtype=np.int64)
    s = len(seeds)
    nbr = np.full((s, fanout), sentinel, dtype=np.int64)
    mask = np.zeros((s, fanout), dtype=bool)
    deg = indptr[seeds + 1] - indptr[seeds]
    small = np.nonzero(deg <= fanout)[0]
    sub_nbr = np.full((small.size, fanout), sentinel, dtype=np.int64)
    sub_mask = np.zeros((small.size, fanout), dtype=bool)
    _fill_rows(seeds[small], indptr, cols, None, sub_nbr, sub_mask, None)
    nbr[small], mask[small] = sub_nbr, sub_mask

    big = np.nonzero(deg > fanout)[0]
    if big.size:
        start = indptr[seeds[big]]
        nbr[big] = cols[start[:, None] + np.arange(fanout)]
        mask[big] = True
        n_draw = deg[big] - fanout
        row = np.repeat(big, n_draw)
        first = np.repeat(start, n_draw)
        j = fanout + np.arange(int(n_draw.sum())) - np.repeat(np.cumsum(n_draw) - n_draw,
                                                              n_draw)
        k = _xorshift_states(seed, j.size) % (j + 1).astype(np.uint64)
        hit = np.nonzero(k < fanout)[0]
        # the last draw into a slot wins: first occurrence in reverse order
        slot = row[hit] * fanout + k[hit].astype(np.int64)
        _, last = np.unique(slot[::-1], return_index=True)
        win = hit[::-1][last]
        nbr.reshape(-1)[slot[::-1][last]] = cols[first[win] + j[win]]
    return nbr.astype(np.int32), mask


class NeighborSampler:
    """Uniform fixed-fanout sampler over one host-resident CSR graph.  The
    graph's ``indptr`` and ``cols`` are copied to the host once."""

    def __init__(self, g: Graph):
        self.n = g.n_nodes
        self.indptr = g.indptr.cpu().numpy().astype(np.int64)
        self.cols = g.cols[: g.n_edges].cpu().numpy().astype(np.int64)

    def sample_layer(self, seeds: np.ndarray, fanout: int, seed: int, *,
                     seed_pad_multiple: int = 128) -> SampledBlock:
        seeds = np.asarray(seeds, dtype=np.int64)
        s = len(seeds)
        s_pad = max(_round_up(s, seed_pad_multiple), seed_pad_multiple)
        nbr, mask = native.sample_neighbors(seeds, self.indptr, self.cols, fanout, self.n, seed)

        nbr_p = np.full((s_pad, fanout), self.n, dtype=np.int32)
        mask_p = np.zeros((s_pad, fanout), dtype=bool)
        nbr_p[:s] = nbr
        mask_p[:s] = mask
        # local row ids 0..s-1 (the output is seed-indexed)
        row_ids = np.full(s_pad, s_pad, dtype=np.int32)
        row_ids[:s] = np.arange(s, dtype=np.int32)
        seeds_p = np.full(s_pad, self.n, dtype=np.int64)
        seeds_p[:s] = seeds

        bucket = Bucket(row_ids=row_ids, nbr=nbr_p, emask=mask_p, val=None,
                        width=int(fanout), n_rows=int(s),
                        row_chunk=int(max(8, (1 << 15) // fanout)))
        bg = BucketedGraph(buckets=(bucket,), n_nodes=s_pad, n_edges=int(mask.sum()))
        return SampledBlock(bg=bg, seeds=seeds_p, n_seeds=s)

    def sample(self, seeds: np.ndarray, fanouts: Sequence[int], seed: int,
               pad_to: Optional[Sequence[int]] = None) -> List[SampledBlock]:
        """Layered sampling, output layer first (blocks[0] aggregates into the
        seed nodes; blocks[-1] is the input-most layer).  Each deeper layer's
        seed set is the union of the previous layer's seeds and sampled
        neighbours (GraphSAGE frontier expansion); its ids are global.

        ``pad_to`` fixes each layer's padded seed count, so every mini-batch
        has the same shapes (frontiers past the cap are truncated, the usual
        sampling approximation)."""
        blocks = []
        frontier = np.asarray(seeds, dtype=np.int64)
        for li, fanout in enumerate(fanouts):
            pad = None if pad_to is None else int(pad_to[li])
            if pad is not None and len(frontier) > pad:
                frontier = frontier[:pad]
            blk = self.sample_layer(frontier, fanout, seed * 1000003 + li,
                                    seed_pad_multiple=pad if pad is not None else 128)
            blocks.append(blk)
            nbrs = blk.bg.buckets[0].nbr
            real = nbrs[nbrs < self.n]
            frontier = np.unique(np.concatenate([frontier, real.astype(np.int64)]))
        return blocks

    def sample_localized(self, seeds: np.ndarray, fanouts: Sequence[int], seed: int,
                         pad_to: Sequence[int], support_pad: int,
                         ) -> Tuple[List[SampledBlock], np.ndarray]:
        """Layered sampling with block-local indices.

        Block li's ``nbr`` and ``seeds`` index the next deeper block's output
        rows, and the deepest block indexes the returned ``support`` (global
        ids of the input rows, sentinel ``n_nodes``).  So a step's feature
        tensors are all O(batch * prod(fanouts)): gather the input features
        as ``x_full[support]`` and run the blocks in ``reversed`` order.
        Frontier or support overflow past the caps is truncated, and the
        overflowing edges are masked out.  Returns ``(blocks, support)``.
        """
        blocks = self.sample(seeds, fanouts, seed, pad_to=pad_to)
        nbrs = blocks[-1].bg.buckets[0].nbr
        real = nbrs[nbrs < self.n].astype(np.int64)
        lseeds = blocks[-1].seeds
        sup = np.unique(np.concatenate([lseeds[lseeds < self.n], real]))
        sup = sup[:support_pad]
        sup_p = np.full(support_pad, self.n, dtype=np.int64)
        sup_p[: sup.size] = sup
        refs = [(blocks[li + 1].seeds, blocks[li + 1].n_seeds)
                for li in range(len(blocks) - 1)] + [(sup_p, int(sup.size))]
        out = []
        for blk, (ref, ref_real) in zip(blocks, refs):
            b = blk.bg.buckets[0]
            sent = ref.shape[0]
            nbr_loc, found = _localize(b.nbr.ravel(), ref, ref_real, sent)
            emask = b.emask & found.reshape(b.nbr.shape)
            seeds_loc, _ = _localize(blk.seeds, ref, ref_real, sent)
            bucket = dataclasses.replace(b, nbr=nbr_loc.reshape(b.nbr.shape), emask=emask)
            bg = BucketedGraph(buckets=(bucket,), n_nodes=blk.bg.n_nodes,
                               n_edges=int(emask.sum()))
            out.append(SampledBlock(bg=bg, seeds=seeds_loc, n_seeds=blk.n_seeds))
        return out, sup_p


def _localize(ids: np.ndarray, ref: np.ndarray, ref_real: int,
              sentinel: int) -> Tuple[np.ndarray, np.ndarray]:
    """Positions of ``ids`` within ``ref[:ref_real]`` (missing or padded ->
    ``sentinel``).  Returns (local ids int32, found mask)."""
    ids = np.asarray(ids, dtype=np.int64)
    if ref_real == 0:
        return np.full(ids.shape, sentinel, np.int32), np.zeros(ids.shape, bool)
    ref_r = np.asarray(ref[:ref_real], dtype=np.int64)
    order = np.argsort(ref_r, kind="stable")
    sref = ref_r[order]
    pos = np.clip(np.searchsorted(sref, ids), 0, ref_real - 1)
    found = sref[pos] == ids
    loc = np.where(found, order[pos], sentinel)
    return loc.astype(np.int32), found


def sampled_block_attention(block: SampledBlock, q, k, v, *, score: str = "dot",
                            e_row=None, e_col=None, negative_slope: float = 0.2):
    """Fused attention over one sampled block (on the block's device).

    The query side (``q`` or ``e_row``) is gathered at the block's seed rows
    (clipped, as ``jnp.take(mode="clip")``), and the sampled neighbour ids
    gather the source side (``k``, ``v`` or ``e_col``).  Returns ``[s_pad,
    h, f]`` rows aligned with ``block.seeds``; autograd runs through the
    bucket path's forward.
    """
    # imported here: dfgnn_tpu_torch.ops imports this module
    from dfgnn_tpu_torch.ops.bucket import _take, bucket_graph_attention

    take = lambda x: None if x is None else _take(x, block.seeds)
    return bucket_graph_attention(block.bg, take(q), k, v, score=score, e_row=take(e_row),
                                  e_col=e_col, negative_slope=negative_slope)
