#!/usr/bin/env python3
"""Bring-up check of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``dfgnn_tpu_torch/csrc/`` and holds each
against its plain PyTorch version on the card: the flash-attention forward
(kernel #1) and backward (#3) of the dot score (also at the main path's own
inputs, the GT step's ogbg-molhiv batch and the PATTERN serving batch, and
with dropout, at an odd head dim and with empty graphs), the forward (#2) and
backward (#4) of the additive (GAT) score, with and without dropout and with
fp32 scores beside a bf16 v, and the whole-layer kernels of GT (#5) and GAT
(#6, with and without dropout, and against the decomposed path with the
same seed); each is timed beside its bound and beside PyTorch's nearest call
(``scaled_dot_product_attention``, after ``F.linear`` for #5 and #6); #2,
on the body it shares with #1, also at the GAT training shape, on
the ogbg-molhiv batch, on a batch with every fourth graph empty and at
P = 300, each with and without dropout; #4 also at f = 48 and 75, at P =
300, on the ogbg-molhiv batch and with empty graphs, with and without
dropout, its keep mask held bitwise to the hash's; #5 and #6 also at P =
512 (fp32 and bf16), at P = 2048 and f = 256 (bf16), at f = 75, with an odd
din, on the ogbg-molhiv batch and with empty graphs (#6 each with and
without dropout, and its keep mask bitwise); a bf16 GATConv through #6
against its flash route at P = 256 and 512 (the readings behind
``GAT_FUSED_MAX_P``).  Each bound counts the products at the peak of the
units the kernel runs them on (printed beside it: fp32 as 3xTF32 on the
tensor cores).  Then
it drives the slice's paths with random weights from a seed, each with the
six launch counts set to 0 just before it and read just after:
- GTModel serving: the 8-layer, hidden-128, 1-head model over three bs=1024
  PATTERN-like requests through ``method="auto"`` and through
  ``impl="flash_fused"`` (8 launches of #5 a request), logits held against
  ``method="dense"``;
- GTModel training: the twin ``dfgnn_tpu_torch.scripts.train_gtconv`` on
  ogbg-molhiv, bs=1024, two epochs of 8 steps, 8 forward and 8 backward
  launches a step; 3 Adam steps through ``auto`` and through
  ``flash_fused`` (8 + 8 + 8 launches of #5, #1, #3 a step) held against
  ``method="dense"``; ``--checkgrad`` against the segment-op oracle; a train
  step's time and peak memory, and its breakdown by the
  ``profile_train_step`` twin;
- GAT serving: the twin ``dfgnn_tpu_torch.scripts.test_batch_graph`` at the
  reference's setting (PATTERN, bs=1024, dim 128, 1 head, every format
  checked against the oracle), one kernel #2 launch per flash forward;
- GAT training: the twin ``dfgnn_tpu_torch.scripts.train_parity --conv gat``
  (FullGraphNet, hidden 64, 2 layers, 200 Adam steps against the oracle),
  2 + 2 add-kernel launches a step; then a timed Adam step of that model on
  a bs=1024 PATTERN-like batch, with its peak memory;
- GAT serving at the fig-1 setting through ``impl="flash_fused"`` (one #6 a
  forward) and in bf16 through ``GATConv``'s auto route;
- GAT bf16 training: ``run_parity_batched(conv="gat", dtype=bf16)``, 200
  steps with 2 + 2 + 2 launches of #6, #2, #4 a step, and a timed bf16
  ``FullGraphNet(gat)`` Adam step with its peak memory;
- the shmoo twin at dim 256 (bs=256) and bs 1024 and 2048 (dim 128);
- the gather kernels #7 (``gather_rows``) and #8 (``take_rows``) against
  their plain versions, exactly, and timed beside ``torch.index_select``
  (#8 also at a 20,000-row slab, past what a block's shared memory holds),
  with each slab's ``take_plan``;
- full-graph serving: the twin ``dfgnn_tpu_torch.scripts.test_full_graph``
  on the reddit stand-in (14.6M edges) at dim 128 with GT and GAT, the bucket
  path against the oracle on a 4M-edge subsample;
- full-graph training: the twin ``dfgnn_tpu_torch.scripts.train_gatconv``
  (GATNet, arxiv stand-in), the bucket path's custom backward against
  autograd through the oracle at dropout 0 and 0.4, and ``run_parity_full``;
- the gather probe twin ``dfgnn_tpu_torch.scripts.microbench_gather``, the
  path that launches #7 and #8, with its table sweep and its rows of the
  cluster probe (#8's function with the slab in a cluster's shared memory);
- sampled training: the twin ``dfgnn_tpu_torch.scripts.train_sampled`` on
  the arxiv stand-in (dim 64, bs 1024, one epoch, ``--compare-full``), its
  steps/s, host sampling seconds and device ms a step and both runs' peak
  memory; one batch's ``sampled_block_attention`` on both scores against
  the segment-op oracle on the block's live lanes; the sampled step's
  profile (``profile_train_step --model sampled``);
- the utilities and the timing twins: ``profile_region`` around a GT
  serving forward (the trace holds the ``annotate`` range), a checkpoint
  round trip of a TrainState's ``state_dict``s, the batch timing twin
  (PATTERN bs 256, dim 64, 4 layers: #1 and #3, their launches asserted),
  the full-graph timing twin (cora, dim 64, 8 layers) and the GraphWorld
  sweep (dim 64);
- the ablation twin ``dfgnn_tpu_torch.scripts.ablation`` at the JAX
  script's defaults (a PATTERN-like bs=1024 batch at dim 128, 1 head:
  reference, dense, flash through #1, flash_fused through #5; the reddit
  stand-in at quarter scale: the oracle and the five bucket layouts), every
  row held against its oracle, the flash row's #1 and the flash_fused row's
  #5 launches asserted; then one ``utils.Timer`` block around launches of
  #1, against CUDA events;
- the edge-partitioned plan (``parallel.partition_graph``): the
  ``bench_partition_build`` twin's rows on the reddit stand-in at 4 and 8
  devices, with and without the halo plan (build seconds, padded-edge
  factor, ``max_halo``); then three 4-device plans (the balanced all-gather
  plan with its transpose, the halo plan, and the bfs-reordered halo plan
  at dropout 0.1) through every shard's local forward, one shard at a time
  on this card on the source table its exchange would deliver, held
  against the unpartitioned bucket forward, each shard's forward timed;
- the multi-GPU layer (``parallel.dist_graph_attention``): a gloo world of
  four processes sharing this card runs the default plan (shared segments),
  the halo plan, the balanced plan with its transpose (the fused
  distributed backward) and bfs + halo at dropout 0.1, each gathered output
  and gradient held against the unpartitioned bucket path (disputed nodes
  in fp64), each timed on the slowest rank; then the dryrun twin's data-,
  partition- and head-parallel steps against one process (#1 and #3
  launched in the DP and TP steps), and a world of one process over NCCL;
- head dims past 256 and the precision switch (phase 26): GTModel at
  hidden 512 with one head (head dim 512) serving through #1 (8 launches)
  and 3 Adam steps through #1 and #3 (8 + 8 a step), held against
  ``method="dense"``; GAT's fig-1 ``Model`` at hidden 512 through #2, and
  a step through #2 and #4; #1 to #4 at f = 257, 384, 512, 1024 and P =
  26, 128, 300, 2048 (fp32 and bf16, edge values, dropout) against their
  plain versions, and timed at f = 512 beside their bounds and SDPA; #1 to
  #6 at ``precision="default"`` against their TF32-rounded plain versions
  (a TF32 step of each tensor's largest element), timed against
  ``"highest"``, which must equal the call without precision bitwise;
- the whole-layer kernels past head dim 256 (phase 27): #5 and #6 at f =
  257, 384, 512, 1024 and P = 26, 128, 300, 2048 (fp32 at both precisions
  and bf16, #6 with dropout at P = 26 and 300) against their plain
  versions; GTModel at hidden 512 with one head through
  ``impl="flash_fused"``: a request through #5 (8 launches) and 3 Adam
  steps through #5, #1 and #3 (8 + 8 + 8 a step), held against
  ``method="dense"``; GAT's fig-1 ``Model`` at hidden 512 through #6, a
  forward and a step (#6, #2, #4), against dense; the GAT conv in bf16 at
  head dims 128 to 512 through #6 against fp32, timed against its
  flash route, and ``method="auto"`` taking the route ``GAT_FUSED_MAX_F``
  names; #5 and #6 at the wide models' shape and at P = 512 timed beside
  their plain versions, their compositions and bounds;
- graphs past P = 2048 (phase 28), where the stream blocks walk adj in
  windows of 2048 keys (#3's column pass and #4: rows): #1 to #4 at P =
  2049, 2176, 4096 and f = 64, 128, 256, 300 (fp32 and bf16; edge values,
  dropout with #3's and #4's keep masks bitwise, an empty graph and
  ``precision="default"`` at one point each) and at P = 8192, #5 and #6 at
  the same P and f = 64, 128, against their plain versions; #1 to #6 timed
  at 8 x 1 x 4096 x 128 beside their plain versions, bounds and nearest
  PyTorch calls; GTModel (8 layers, hidden 128) serving and taking 3 Adam
  steps and GAT's fig-1 ``Model`` a forward and a step, on a DenseBatch of 8
  graphs of about 3,000 nodes, through ``auto`` (8 #1 a request, 8 + 8 #1,
  #3 a step; GAT #2, #4) and ``flash_fused`` (8 #5, 8 + 8 + 8 #5, #1, #3;
  GAT #6, #2, #4), each against ``method="dense"`` with its time and peak
  memory.
The bucket path is torch ops, so the full-graph, sampled and partitioned
phases launch none of the hand-written kernels, and they assert that.
Prints progress and each phase's wall time, then a ``{"kernels": [...]}`` JSON line (eight records),
and last a ``{"ok": true, ...}`` line.  Exits
non-zero, with no result line, when there is no CUDA device or any check
fails.  Imports no JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

FP32_TOL = dict(rtol=1e-4, atol=1e-5)  # the JAX package's flash-vs-dense bar
# bf16 outputs are O(1) values with 8 significant bits (a step of 2**-8 near
# 1); ordering and ex rounding differences stay well inside 3e-2
BF16_TOL = dict(rtol=0.0, atol=3e-2)
# The backward in fp32: the kernel and cuBLAS sum dp over f and the products
# over P in other orders; each sum of O(10) terms differs by a few fp32 ulps,
# and atol 1e-4 leaves a tenfold margin over that.
BWD_FP32_TOL = dict(rtol=1e-4, atol=1e-4)
# The backward in bf16: ds and p are rounded to bf16 before the products and
# the sums are cast to bf16, so the bar is a bf16 step of the largest
# gradient, 2**-6 of it (set per tensor in bwd_bf16_tol).
BF16_BWD_SCALE = 2.0 ** -6
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)
TRAJECTORY_RTOL = 1e-3  # auto against dense losses over 3 Adam steps
KERNEL_SHAPES = [  # (B, h, P, f, with_val, dtype)
    (1024, 1, 128, 128, False, torch.float32),  # the serving and training paths' shape
    (3, 2, 64, 16, True, torch.float32),
    (2, 4, 512, 32, False, torch.float32),
    (1024, 1, 128, 128, False, torch.bfloat16),
]
BWD_SHAPES = KERNEL_SHAPES + [
    (2, 2, 100, 64, True, torch.float32),  # P not a multiple of the tiles
]
MAIN_SHAPE = (1024, 1, 128, 128)
ADD_SHAPES = [  # (B, h, P, f, with_val, dtype): kernels #2 and #4
    (1024, 1, 128, 128, False, torch.float32),  # the GAT serving path's shape
    (1024, 1, 128, 64, False, torch.float32),   # the GAT training step's shape
    (3, 2, 64, 16, True, torch.float32),
    (2, 4, 512, 32, False, torch.float32),
    (3, 2, 300, 64, True, torch.float32),       # #2's streaming block
    (1024, 1, 128, 128, False, torch.bfloat16),
]
ADD_TRAIN = (1024, 1, 128, 64)  # the GAT training step's shape, timed too
ADD_BWD_SHAPES = ADD_SHAPES + [(2, 2, 100, 64, True, torch.float32)]
LAYER_SHAPES = [  # (B, h, P, din, f, dtype): kernels #5 and #6
    (1024, 1, 128, 128, 128, torch.float32),   # GT and GAT serving at full width
    (1024, 1, 128, 128, 128, torch.bfloat16),
    (1024, 1, 128, 64, 64, torch.bfloat16),    # the bf16 GAT training step's shape
    (3, 2, 64, 48, 16, torch.float32),         # several heads, din != f
    (2, 2, 100, 64, 64, torch.float32),        # P not a multiple of the tiles
]
LAYER_MAIN = (1024, 1, 128, 128, 128)
BF16_REL = 5e-2  # the JAX package's bf16 bar: max |bf16 - fp32| / max |fp32|
PARITY_BF16_GAP = 0.05  # the JAX parity bound's cap
SHMOO_DIMS, SHMOO_BATCHES = (256,), (1024, 2048)
DROP_RATES, DROP_SEED = (0.0, 0.4), 0x5EED
GAT_SERVE_ARGS = ["--dataset", "PATTERN", "--conv", "gat", "--dim", "128", "--heads", "1",
                  "--batch-size", "1024", "--format", "all"]
PARITY_STEPS, PARITY_GAP_BAR = 200, 0.02
GATHER_SHAPES = [  # (table rows, row shape, dtype, rows gathered, chunk, lookahead): #7
    (1 << 18, (128,), torch.float32, 1 << 20, 512, 15),        # the probe's main shape
    (232965, (256,), torch.float32, 1 << 20, 512, 15),         # reddit's packed k||v table
    (1 << 18, (128,), torch.float32, (1 << 20) + 77, 512, 15), # M not a multiple of chunk
    (1 << 18, (128,), torch.bfloat16, 1 << 20, 256, 7),        # a bf16 table
]
TAKE_SLABS, TAKE_MAIN = (512, 1024, 4096, 20000), 4096  # #8's slabs of 128 fp32, 2**20 ids
FULL_SERVE_ARGS = ["--dataset", "reddit", "--dim", "128", "--heads", "1", "--format", "all_fg"]
SAMPLED_BATCH, SAMPLED_DIM = 1024, 64
SAMPLED_ARGS = ["--dataset", "arxiv", "--dim", str(SAMPLED_DIM), "--batch-size",
                str(SAMPLED_BATCH), "--epochs", "1", "--compare-full"]
BATCH_TIMING_ARGS = ["--dataset", "PATTERN", "--batch-size", "256", "--dim", "64",
                     "--n-layers", "4"]
FULL_TIMING_ARGS = ["--dataset", "cora", "--dim", "64", "--n-layers", "8", "--epochs", "5"]
GRAPHWORLD_ARGS = ["--dim", "64"]
FULL_TRAIN_ARGS = ["--dataset", "arxiv", "--dim", "64", "--heads", "4", "--n-layers", "2",
                   "--epochs", "5", "--lr", "1e-2"]
GRAD_SUB_EDGES, GRAD_TOL = 1_000_000, dict(rtol=1e-3, atol=1e-4)
PLAN_DEVICES, SHARD_DEVICES = [4, 8], 4  # the plan-build rows; the shard loops
# The reddit stand-in has rows wider than split_width (256), so its default
# plan deals them as shared segments, whose forward merges across devices
# (dist_graph_attention, phase 25); with the transpose the balanced all-gather
# plan keeps them per device, and each shard's forward stands alone.
SHARD_PLANS = [({"with_transpose": True}, 0.0), ({"halo": True}, 0.0),
               ({"reorder": "bfs", "halo": True}, 0.1)]
# Phase 25: a gloo world of DIST_RANKS processes on this one card, each plan
# (name, partition_graph keywords, dropout rate) through dist_graph_attention;
# the default plan has shared segments, the balanced one its transpose (the
# fused distributed backward).  Each time is the slowest rank's, CUDA events
# over DIST_ITERS runs after DIST_WARMUP.
DIST_RANKS, DIST_WARMUP, DIST_ITERS = 4, 1, 2
DIST_PLANS = [("default", {}, 0.0), ("halo", {"halo": True}, 0.0),
              ("balanced+transpose", {"with_transpose": True}, 0.0),
              ("bfs+halo", {"reorder": "bfs", "halo": True}, 0.1)]
DIST_NCCL_SCALE = 0.25  # the NCCL world of one process: reddit at quarter scale
GAT_HIDDEN, GAT_LAYERS = 64, 2
N_REQUESTS, BATCH, NP_PAD, HIDDEN, LAYERS = 3, 1024, 128, 128, 8
TRAIN_ARGS = ["--dataset", "ogbg-molhiv", "--dim", str(HIDDEN), "--n-layers", str(LAYERS),
              "--heads", "1", "--batch-size", str(BATCH)]
EPOCHS, STEPS_PER_EPOCH, TRAJECTORY_STEPS = 2, 8, 3
# H100 SXM published peaks (NVIDIA data sheet): fp32 on the CUDA cores, HBM3
FP32_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12
BF16_FLOPS = 989e12  # bf16 on the tensor cores, dense
# fp32 products run as 3xTF32 on the tensor cores (#1 to #6): three TF32
# products each, so a third of the 495 TFLOP/s TF32 peak
TF32X3_FLOPS = 495e12 / 3
# Phase 26: #1 to #4 past f = 256 at these head dims and node counts, (B, h)
# small at the large P; the wide GT and GAT models at one head of WIDE_HIDDEN;
# #1 to #4 timed at the table's shape at f = 512
WIDE_F, WIDE_P = (257, 384, 512, 1024), (26, 128, 300, 2048)
WIDE_BH = {26: (8, 2), 128: (4, 2), 300: (2, 2), 2048: (1, 1)}
WIDE_HIDDEN, WIDE_TABLE = 512, (1024, 1, 128, 512)
WIDE_DIN = 72  # phase 27: #5 and #6 on the grid of WIDE_F x WIDE_P take x of this width
WIDE_STREAM = (64, 1, 512, 512)  # phase 27: #5 and #6 timed past P = 128 at head dim 512
# Phase 28: graphs past P = 2048.  #1 to #4 at these node counts ((B, h) per
# P) and head dims, #5 and #6 at the first two head dims (din WIDE_DIN); #1
# to #6 timed at LARGE_TABLE (din = f); the GT and GAT models at HIDDEN on
# a DenseBatch of LARGE_GRAPHS graphs of about LARGE_MEAN nodes
LARGE_P, LARGE_F = (2049, 2176, 4096), (64, 128, 256, 300)
LARGE_BH = {2049: (2, 1), 2176: (2, 1), 4096: (1, 2)}
LARGE_TABLE = (8, 1, 4096, 128)
LARGE_GRAPHS, LARGE_MEAN, LARGE_MAX = 8, 3000, 4096
TF32_STEP = 2.0 ** -10  # a TF32 step (10 mantissa bits) near 1: the "default" bar
# 3xTF32 drops each product's lo x lo term (about 2**-21 of it, where fp32
# rounds a product at 2**-24), so on sums long enough that fp32 itself
# misses BWD_FP32_TOL the kernel's error may exceed the fp32 plain version's:
# up to 1.52x of it over phase 26's grid (the factor set after that reading)
FP32_GRAD_SPREAD = 2.0


def err_and_bad(got, want, tol):
    """(max |got - want|, elements outside atol + rtol*|want| or not finite)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = (err > tol["atol"] + tol["rtol"] * want.abs()) | ~torch.isfinite(got)
    return float(err.max()), int(bad.sum())


def max_err(got, want, tol):
    """Max |got - want|; raises when an element is outside atol + rtol*|want|."""
    err, bad = err_and_bad(got, want, tol)
    if bad:
        raise AssertionError(f"{bad} elements outside {tol}; max err {err}")
    return err


def bwd_bf16_tol(want):
    return dict(rtol=0.0, atol=BF16_BWD_SCALE * float(want.float().abs().max()))


def bound(flops, nbytes, peak=FP32_FLOPS):
    """(bound_ms, bound_by): the larger of the work over ``peak`` (the rate
    of the units the kernel runs its products on: FP32_FLOPS on the CUDA
    cores, TF32X3_FLOPS for fp32 as 3xTF32 on the tensor cores, BF16_FLOPS)
    and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def peak_name(peak):
    return {FP32_FLOPS: "fp32 CUDA cores", TF32X3_FLOPS: "fp32 as 3xTF32 on the tensor cores",
            BF16_FLOPS: "bf16 tensor cores"}[peak] + f" {peak / 1e12:.4g} TFLOP/s"


def add_bytes(B, h, P, f, itemsize):
    """The same for the additive score: the forward reads e_row, e_col, v,
    adj and writes out, lse; the backward reads e_row, e_col, v, out (for
    delta), dO, adj, lse and writes d e_row, d e_col, dv."""
    feat = B * P * h * f * itemsize
    scal = B * P * h * itemsize
    rows = h * B * P * 4
    return 2 * scal + 2 * feat + B * P * P + rows, 4 * scal + 4 * feat + B * P * P + rows


def padded_attention_bound(n_products, adj, h, f, itemsize, backward, flops=FP32_FLOPS):
    """(bound_ms, bound_by, edges) of kernel #1 (``backward`` False: q.k^T
    and ex.v) or #3 (s, dp, dq, dk, dv) on these inputs, counting what they
    need: the products on the edges only; the feature rows that hold an edge
    (q, and for #3 dO and out for delta, of rows with an edge; k, v of keys
    with an edge), adj, and the full outputs (out and lse; dq, dk, dv, with
    lse and delta read).  On padded batches this is the byte count of the
    guide's rule, so no share reads over 100%."""
    B, P, _ = adj.shape
    edges = int(adj.sum())
    rows = int((adj.sum(-1) > 0).sum())
    keys = int((adj.sum(-2) > 0).sum())
    row_b = h * f * itemsize
    if backward:
        nbytes = (3 * rows + 2 * keys) * row_b + B * P * P + 2 * h * B * P * 4 + 3 * B * P * row_b
    else:
        nbytes = (rows + 2 * keys) * row_b + B * P * P + B * P * row_b + h * B * P * 4
    t_ops = n_products * 2 * edges * h * f / flops * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations", edges) if t_ops >= t_bytes else (t_bytes, "bytes", edges)


def attention_bound(n_products, adj, h, f, nbytes, peak):
    """(bound_ms, bound_by, dense_ms) of a kernel doing ``n_products``
    products of 2*f operations per edge and head (#1: q.k^T and p.v; #3: s,
    dp, dq, dk, dv; #2: ex.v; #4: dp and dv) and moving ``nbytes``.  The
    function needs each product only on the edges, so the bound counts adj's
    edges; dense_ms counts every entry of the [P, P] blocks instead."""
    B, P, _ = adj.shape
    bound_ms, bound_by = bound(n_products * 2 * int(adj.sum()) * h * f, nbytes, peak)
    return bound_ms, bound_by, bound(n_products * 2 * B * P * P * h * f, nbytes, peak)[0]


def step_peak_mib(fn):
    """(peak device memory allocated during one call of ``fn`` above what was
    allocated at its start, what was allocated at its start), in MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - start) / 2 ** 20, start / 2 ** 20


def layer_work(score, B, P, din, h, f, edges, itemsize):
    """(flops, bytes) the whole layer must do: its projections over every
    node (3 for #5, 1 and the two score contractions for #6) and its
    attention products over the edges (2 for #5, 1 for #6); each input (x,
    the weights, adj) read once and the output written once."""
    if score == "dot":
        flops = 3 * 2 * B * P * din * h * f + 2 * 2 * edges * h * f
        weights = 3 * (h * din * f * itemsize + h * f * 4)
    else:
        flops = 2 * B * P * din * h * f + 2 * 2 * B * P * h * f + 2 * edges * h * f
        weights = h * din * f * itemsize + 3 * h * f * 4
    return flops, B * P * din * itemsize + weights + B * P * P + B * P * h * f * itemsize


def add_composition(x, w, b, al, ar, adj):
    """#6's nearest PyTorch composition, as a function of no arguments:
    F.linear, the two score contractions, the masked leaky scores as a
    float attn_mask (built inside the call) and
    scaled_dot_product_attention with q = k = 0 of width 8."""
    import torch.nn.functional as F

    from dfgnn_tpu_torch.ops.flash_mask import NEG_BIG

    B, P, din = x.shape
    h, _, f = w.shape
    x2, w_flat = x.reshape(B * P, din), w.permute(0, 2, 1).reshape(h * f, din)
    mask = adj[:, None].bool()
    zq = torch.zeros(B, h, P, 8, device="cuda", dtype=x.dtype)

    def run():
        z = F.linear(x2, w_flat, b.reshape(h * f).to(x.dtype)).reshape(B, P, h, f)
        z = z.transpose(1, 2).float()
        el = torch.einsum("bhpf,hf->bhp", z, al)
        er = torch.einsum("bhpf,hf->bhp", z, ar)
        s = torch.where(mask, F.leaky_relu(el[..., None] + er[..., None, :], 0.2),
                        NEG_BIG).to(x.dtype)
        return F.scaled_dot_product_attention(zq, zq, z.to(x.dtype), attn_mask=s)

    return run


def in_turns(bench, plain_fn, kernel_fn, names=("plain", "kernel")):
    """Times plain, kernel, kernel, plain; returns the two means (ms)."""
    p1 = bench(plain_fn)[1]
    k1 = bench(kernel_fn)[1]
    k2 = bench(kernel_fn)[1]
    p2 = bench(plain_fn)[1]
    a, b = names
    print(f"  times in turns (ms): {a} {p1:.4f}, {b} {k1:.4f}, {b} {k2:.4f}, {a} {p2:.4f}")
    return (k1 + k2) / 2, (p1 + p2) / 2


_PHASE_START = [time.perf_counter()]


def _slowest_ms(fn, group):
    """CUDA-event ms of ``fn`` (DIST_ITERS runs after DIST_WARMUP, after a
    barrier), the slowest rank's."""
    import torch.distributed as dist

    from dfgnn_tpu_torch.parallel import comm

    for _ in range(DIST_WARMUP):
        fn()
    torch.cuda.synchronize()
    dist.barrier(group)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(DIST_ITERS):
        fn()
    end.record()
    end.synchronize()
    ms = torch.tensor([start.elapsed_time(end) / DIST_ITERS], device="cuda")
    return float(comm.all_reduce_max(ms, group)[0])


def _unpartitioned(g, q, k, v, rate, device):
    """The unpartitioned bucket path on the plans' ladder and split (min_width
    8, x1.5, 256) for the loss sum(out ** 2): out, and the gradients of q, k,
    v through its custom backward (held against autograd through the oracle
    in phase 19; autograd through this forward would hold some 20 GB of
    gathered rows, beside four ranks' own)."""
    from dfgnn_tpu_torch import formats
    from dfgnn_tpu_torch.ops import bucket

    bg = formats.build_buckets(g.to(device), min_width=8, split_width=256, ladder="x1.5",
                               with_transpose=True)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = bucket.bucket_graph_attention(
        bg, *xs, dropout_rate=rate, dropout_generator=torch.Generator().manual_seed(DROP_SEED))
    (out ** 2).sum().backward()
    return out.detach(), [x.grad for x in xs]


def _exact_at(g, rows, cols, q, k, v, seed, rate, max_edges=1 << 19):
    """out and dq at the nodes ``rows``, dk and dv at the nodes ``cols``, of
    the loss sum(out ** 2), in fp64 by the segment-op oracle.  The loss is a
    sum over rows, so it runs on the rows these depend on (``rows`` and every
    row with an edge to ``cols``, each with all its edges), ``max_edges``
    edges at a time, summing the gradients; dropout by the edge hash on the
    normalised weights."""
    from dfgnn_tpu_torch.graph import Graph
    from dfgnn_tpu_torch.ops import edge_softmax, sddmm_dot, spmm
    from dfgnn_tpu_torch.ops.edge_dropout import keep_scale

    indptr = g.indptr.numpy()
    er, ec = g.rows[: g.n_edges].numpy(), g.cols[: g.n_edges].numpy()
    need = np.union1d(rows, er[np.isin(ec, cols)])
    group = np.cumsum(indptr[need + 1] - indptr[need]) // max_edges
    xs = [x.double().requires_grad_() for x in (q, k, v)]
    out = torch.zeros_like(xs[2], requires_grad=False)
    grads = [torch.zeros_like(x, requires_grad=False) for x in xs]
    heads = torch.arange(q.shape[1], device=q.device)[None, :]
    for gi in np.unique(group):
        rs = need[group == gi]
        es = np.concatenate([np.arange(indptr[i], indptr[i + 1]) for i in rs])
        sub = Graph.from_coo(er[es], ec[es], g.n_nodes, device=q.device)
        w = edge_softmax(sub, sddmm_dot(sub, xs[0], xs[1]))
        if rate:
            w = w * keep_scale(seed, sub.rows[:, None], sub.cols[:, None], heads, rate).double()
        o = spmm(sub, w, xs[2])
        for acc, d in zip(grads, torch.autograd.grad((o ** 2).sum(), xs)):
            acc += d
        at = torch.from_numpy(rs).to(q.device)
        out[at] = o[at].detach()
        del sub, w, o
    return (out, *grads)


def _outside(got, want, tol):
    """Node ids (dim 0) holding an element of ``got`` outside ``tol`` of ``want``."""
    bad = (got - want).abs() > tol["atol"] + tol["rtol"] * want.abs()
    return bad.reshape(bad.shape[0], -1).any(1).nonzero()[:, 0].cpu().numpy()


def _hold(g, q, k, v, seed, rate, got, grads, want):
    """Rank 0's checks of one plan against :func:`_unpartitioned`'s ``want``,
    the gathered output at FP32_TOL, each gradient at GRAD_TOL.  The nodes
    with elements outside are evaluated in fp64 (:func:`_exact_at`), and
    there the plan must be within the same bar of the exact values, or no
    further from them than the single-device fp32 path is: on rows and
    columns of thousands of edges, in sums that cancel, fp32 summation order
    alone moves a gradient by up to about 2e-3, past GRAD_TOL (PERF.md
    section 6), while a lost or doubled contribution moves it by the size
    of a term."""
    names, tols = ("out", "dq", "dk", "dv"), [FP32_TOL] + [GRAD_TOL] * 3
    gots, wants = [got, *grads], [want[0], *want[1]]
    row = {"checks": {}}
    nodes = {}
    for name, a, b, tol in zip(names, gots, wants, tols):
        err, bad = err_and_bad(a, b, tol)
        row["checks"][name] = dict(err=err, bad=bad, nodes=0, err64=0.0, bad64=0, ref64=0.0)
        if bad:
            nodes[name] = _outside(a, b, tol)
    if nodes:
        rows = np.union1d(nodes.get("out", []), nodes.get("dq", [])).astype(np.int64)
        cols = np.union1d(nodes.get("dk", []), nodes.get("dv", [])).astype(np.int64)
        exact = _exact_at(g, rows, cols, q, k, v, seed, rate)
        for i, (name, a, b, tol) in enumerate(zip(names, gots, wants, tols)):
            if name in nodes:
                at = torch.from_numpy(nodes[name]).to(a.device)
                c = row["checks"][name]
                c["nodes"] = int(at.numel())
                c["err64"], c["bad64"] = err_and_bad(a[at].double(), exact[i][at], tol)
                c["ref64"] = float((b[at].double() - exact[i][at]).abs().max())
    row["ok"] = all(c["bad64"] == 0 or c["err64"] <= c["ref64"]
                    for c in row["checks"].values())
    return row


def _hold_line(row):
    parts = []
    for name, c in row["checks"].items():
        part = f"{name} within {c['err']:.3e} ({c['bad']} outside"
        if c["nodes"]:
            part += (f"; at those {c['nodes']} nodes in fp64 this path is within "
                     f"{c['err64']:.3e} ({c['bad64']} outside), the reference within "
                     f"{c['ref64']:.3e}")
        parts.append(part + ")")
    return (f"against the unpartitioned bucket path (out at {FP32_TOL}, gradients at "
            f"{GRAD_TOL}): " + ", ".join(parts))


def _dist_rank(rank, world_size, device="cuda", scale=1.0):
    """Phase 25 on one rank of the gloo world (every rank on this card): each
    of DIST_PLANS on the reddit stand-in, its gathered output and gradients
    held by rank 0 against the unpartitioned bucket path, and timed; then the
    dryrun twin's three steps.  Returns rank 0's readings.  ``device`` and
    ``scale`` (of the stand-in) let the phase be rehearsed off the card."""
    import torch.distributed as dist

    from dfgnn_tpu_torch.data.datasets import load_full_graph
    from dfgnn_tpu_torch.graph import Graph
    from dfgnn_tpu_torch.ops import bucket, edge_dropout, flash_mask
    from dfgnn_tpu_torch.parallel import (dist_graph_attention, gather_nodes, make_mesh,
                                          partition, partition_graph, shard_nodes)
    from dfgnn_tpu_torch.parallel.dist import mesh_group_rank
    from dfgnn_tpu_torch.scripts import dryrun_multichip

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash_mask.reset_launch_counts()
    ds = load_full_graph("reddit", scale=scale, quiet=True)
    g = Graph.from_coo(ds.rows, ds.cols, ds.n_nodes, device="cpu")
    del ds
    mesh = make_mesh(world_size, device=device)
    group, r = mesh_group_rank(mesh)
    gen = torch.Generator(device=device).manual_seed(25)
    q, k, v = (torch.randn((g.n_nodes, 1, HIDDEN), device=device, generator=gen)
               for _ in range(3))
    want = {}
    if rank == 0:
        want = {rate: _unpartitioned(g, q, k, v, rate, device)
                for rate in sorted({rate for *_, rate in DIST_PLANS})}
    res, pending = {"plans": []}, []
    for name, kw, rate in DIST_PLANS:
        t0 = time.perf_counter()
        pg = partition_graph(g, world_size, mesh=mesh, **kw)
        build_s = time.perf_counter() - t0
        seed = (edge_dropout.seed_from_generator(torch.Generator().manual_seed(DROP_SEED))
                if rate else None)
        xs = [shard_nodes(pg, x, r).detach().requires_grad_() for x in (q, k, v)]
        attend = lambda: dist_graph_attention(pg, mesh, *xs, dropout_rate=rate,
                                              dropout_seed=seed)
        out = attend()
        (out ** 2).sum().backward()
        got = gather_nodes(pg, out.detach(), mesh)
        grads = [gather_nodes(pg, x.grad, mesh) for x in xs]
        row = dict(name=name, kw=kw, rate=rate, build_s=build_s, n_local=pg.n_local,
                   max_halo=None if pg.halo is None else pg.halo.max_halo,
                   shared=pg.shared_segments is not None, transpose=pg.transpose is not None)
        if rank == 0:  # held once every rank is done with the card (_hold)
            pending.append((row, seed, rate, got, grads))
        del out

        def step():
            for x in xs:
                x.grad = None
            (attend() ** 2).sum().backward()
        with torch.no_grad():
            row["fwd_ms"] = _slowest_ms(attend, group)
        row["step_ms"] = _slowest_ms(step, group)
        sh = partition._shard(pg, r, q.device)
        (table,) = bucket._make_tabs(xs[1].detach(), xs[2].detach(), None, "dot", None)
        exchange = partition._exchange(pg, sh, group)
        row["exchange_ms"] = _slowest_ms(lambda: exchange(table), group)
        # an exchange sends each peer this rank's rows (all-gather) or the
        # rows that peer needs (halo): comm_rows_per_device rows in all
        row["sent_mb"] = pg.comm_rows_per_device() * table[0].numel() * 4 / 1e6
        res["plans"].append(row)
        del pg, xs, sh, table, exchange
        if device == "cuda":  # the four ranks share the card's memory
            torch.cuda.empty_cache()
    no_launch = flash_mask.launch_counts()
    if any(no_launch):
        raise AssertionError(f"the partitioned plans launched kernels: {no_launch}")
    res["steps"] = dryrun_multichip.dryrun_multichip(device)
    if rank == 0:
        res["single"] = dryrun_multichip.single_process(world_size, device)
        for row, seed, rate, got, grads in pending:
            row.update(_hold(g, q, k, v, seed, rate, got, grads, want[rate]))
            row["vs_undropped"] = float((got - want[0.0][0]).abs().max())
    return res


def _nccl_world_of_one(smi):
    """A world of this one process over NCCL: the default plan and the
    transposed plan (fused backward) of the quarter-scale reddit stand-in
    through dist_graph_attention, against the unpartitioned bucket path."""
    import datetime

    import torch.distributed as dist

    from dfgnn_tpu_torch.data.datasets import load_full_graph
    from dfgnn_tpu_torch.graph import Graph
    from dfgnn_tpu_torch.parallel import (dist_graph_attention, gather_nodes, make_mesh,
                                          partition_graph, shard_nodes)
    from dfgnn_tpu_torch.parallel.multihost import free_port

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        ds = load_full_graph("reddit", scale=DIST_NCCL_SCALE, quiet=True)
        g = Graph.from_coo(ds.rows, ds.cols, ds.n_nodes, device="cpu")
        mesh = make_mesh(1, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(26)
        q, k, v = (torch.randn((g.n_nodes, 1, HIDDEN), device="cuda", generator=gen)
                   for _ in range(3))
        want = _unpartitioned(g, q, k, v, 0.0, "cuda")
        for kw in ({}, {"with_transpose": True}):
            pg = partition_graph(g, 1, mesh=mesh, **kw)
            ls = [shard_nodes(pg, x, 0).detach().requires_grad_() for x in (q, k, v)]
            out = dist_graph_attention(pg, mesh, *ls)
            (out ** 2).sum().backward()
            row = _hold(g, q, k, v, None, 0.0, gather_nodes(pg, out.detach(), mesh),
                        [gather_nodes(pg, x.grad, mesh) for x in ls], want)
            print(f"NCCL world of 1 ({dist.get_backend()}), reddit stand-in at scale "
                  f"{DIST_NCCL_SCALE} (n={g.n_nodes}, e={g.n_edges}), plan {kw or 'default'}: "
                  f"{_hold_line(row)} ({smi})")
            if not row["ok"]:
                raise AssertionError(f"the NCCL world's plan {kw} disagrees")
    finally:
        dist.destroy_process_group()


def dist_phase(smi):
    """Phase 25, the multi-GPU layer: a gloo world of DIST_RANKS processes
    sharing this card runs each of DIST_PLANS through dist_graph_attention
    and the dryrun twin's three steps (:func:`_dist_rank`); then a world of
    this one process over NCCL (:func:`_nccl_world_of_one`)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from dist_world import start_world

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = start_world(_dist_rank, DIST_RANKS, backend="gloo", timeout=600).results()
    print(f"the gloo world ran in {time.perf_counter() - t0:.2f} s")
    print(f"gloo world of {DIST_RANKS} processes on this one card (backend gloo; CUDA tensors "
          f"straight to gloo), reddit stand-in, GT dot score, dim {HIDDEN}, h=1, fp32; "
          f"times are the slowest rank's, CUDA events, mean of {DIST_ITERS} after "
          f"{DIST_WARMUP} warmup, with {DIST_RANKS} ranks sharing one card ({smi}):")
    for row in res["plans"]:
        print(f"plan {row['name']} {row['kw']} dropout {row['rate']} (shared segments "
              f"{row['shared']}, transpose {row['transpose']}; built in {row['build_s']:.2f} s, "
              f"host; n_local {row['n_local']}, max_halo {row['max_halo']}): {_hold_line(row)}; "
              f"forward {row['fwd_ms']:.4f} ms, forward + backward {row['step_ms']:.4f} ms, "
              f"exchange {row['exchange_ms']:.4f} ms, {row['sent_mb']:.2f} MB sent per rank "
              f"per exchange")
    for row in res["plans"]:
        if not row["ok"]:
            raise AssertionError(f"plan {row['name']} disagrees with the unpartitioned path")
        if row["rate"] and row["vs_undropped"] < 0.1:  # a mask moves outputs by O(1)
            raise AssertionError(f"plan {row['name']}'s outputs do not show its dropout mask")
    steps, single = res["steps"], res["single"]
    launches = steps.pop("launches")
    for key, losses in steps.items():
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"dryrun step {key}: losses {losses}")
        np.testing.assert_allclose(losses, single[key], rtol=1e-4, err_msg=key)
    for key in ("dp", "tp"):
        if min(launches[key]) < 1:
            raise AssertionError(f"dryrun step {key} launched #1, #3 {launches[key]} times")
    print(f"dryrun twin in the same world, losses of 2 steps against one process: "
          + "; ".join(f"{key} {steps[key]} (one process {single[key]})" for key in steps)
          + f"; rank 0's launches of #1, #3: {launches}")
    t0 = time.perf_counter()
    _nccl_world_of_one(smi)
    print(f"the NCCL world of one ran in {time.perf_counter() - t0:.2f} s")


def tf32_tol(want):
    """The bar of a kernel at precision="default" against its TF32-rounded
    plain version: both round the same operands to TF32 and multiply them
    exactly, so they differ by the order of their fp32 sums and by the TF32
    rounding of the intermediates (ex, ds, p * keep) that those sums move
    across a rounding boundary: a TF32 step (2**-10) of each tensor's
    largest element."""
    return dict(rtol=0.0, atol=TF32_STEP * float(want.float().abs().max()))


def hold_fp32_grad(got, want64, want32):
    """An fp32 gradient against its plain version evaluated in fp64: within
    BWD_FP32_TOL, or, where fp32 arithmetic cannot meet that bar on these
    inputs, within FP32_GRAD_SPREAD times the fp32 plain version's largest
    error (at P = 2048 with edge values |dq| reaches 1e2, and the fp32 plain
    version itself lands 3.6e-4 from fp64).  Returns the kernel's and the
    fp32 plain version's largest errors."""
    err = (got.double() - want64).abs()
    plain = float((want32.double() - want64).abs().max())
    bad = (err > BWD_FP32_TOL["atol"] + BWD_FP32_TOL["rtol"] * want64.abs()) | ~torch.isfinite(got)
    if bool(bad.any()) and not float(err.max()) <= FP32_GRAD_SPREAD * plain:
        raise AssertionError(f"{int(bad.sum())} elements outside {BWD_FP32_TOL} of fp64; max err "
                             f"{float(err.max())}, the fp32 plain version's {plain}")
    return float(err.max()), plain


def counts_must_be(what, want):
    """Raises unless kernels #1, #3, #2, #4, #5, #6 were launched ``want``
    times since their counts were last reset."""
    from dfgnn_tpu_torch.ops import flash_mask as fm

    torch.cuda.synchronize()
    if fm.launch_counts() != want:
        raise AssertionError(f"{what} launched #1, #3, #2, #4, #5, #6 {fm.launch_counts()}, "
                             f"expected {want}")


def attention_case(fm, seed, B, h, P, f, dtype, *, with_val, rate, precision=None,
                   empty=False):
    """#1 to #4 on ``attention_inputs`` against their plain versions, each
    backward given the plain forward's out and lse, as its plain version
    is: fp32 forwards at FP32_TOL, the fp32 gradients against the plain
    versions evaluated in fp64 (hold_fp32_grad), bf16 at the bf16 bars; at
    precision="default" every output against the TF32-rounded plain version
    within a TF32 step of its largest element (tf32_tol).  ``empty``
    empties the last graph; rows without an edge must give out = 0.  With
    dropout, #3's and #4's keep masks are held bitwise to the hash's on the
    rows j < f: with dO the one-hot rows, dv[c, j] = round_to<T>(p * keep)[j,
    c], nonzero exactly where the edge is kept.  Returns the printed line."""
    from dfgnn_tpu_torch.data.synthetic import attention_inputs

    q, k, v, adj, val = (torch.from_numpy(a).cuda()
                         for a in attention_inputs(np.random.default_rng(seed), B, h, P, f))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    if empty:
        adj[-1] = 0
    val = val if with_val else None
    rng = np.random.default_rng(seed + 1)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).cuda().to(dtype)
    e_row, e_col = (torch.from_numpy(rng.standard_normal((B, P, h)).astype(np.float32)).cuda()
                    for _ in range(2))
    kw = dict(seed=DROP_SEED, rate=rate, precision=precision)
    fp32, tf32 = dtype == torch.float32, precision == "default"
    tol = tf32_tol if tf32 else (lambda w: FP32_TOL if fp32 else BF16_TOL)
    no_edge = ~adj.bool().any(-1)  # [B, P]
    errs = {}
    d = lambda t: None if t is None else t.double()

    def hold(names, fwd, plain_fwd, bwd, plain_bwd, args):
        """the forward against ``plain_fwd``; the backward, given the plain
        forward's out and lse (its inputs, as the plain backward's), against
        ``plain_bwd`` (+ lse, do, delta); returns the plain forward's"""
        out, lse = fwd(*args, want_lse=True, **kw)
        torch.cuda.synchronize()
        if bool(out[no_edge].any()):
            raise AssertionError(f"P={P} f={f}: a row without an edge is not 0")
        want = plain_fwd(*args, **kw)
        errs[names[0]] = max_err(out, want[0], tol(want[0]))
        errs[names[1]] = max_err(lse, want[1], FP32_TOL)
        del out, lse
        got = bwd(*args, *want, do, **kw)
        torch.cuda.synchronize()
        grads = plain_bwd(*args, want[1], do, fm.bwd_delta(do, want[0]), **kw)
        if fp32 and not tf32:  # against the fp64 evaluation, beside the fp32 one's error
            want64 = plain_bwd(*map(d, args[:3]), args[3], d(args[4]), d(want[1]), d(do),
                               fm.bwd_delta(d(do), d(want[0])), **kw)
            for n, g, w64, w in zip(names[2:], got, want64, grads):
                errs[n], errs[n + " (fp32 plain)"] = hold_fp32_grad(g, w64, w)
        else:
            for n, g, w in zip(names[2:], got, grads):
                errs[n] = max_err(g, w, tf32_tol(w) if tf32 else bwd_bf16_tol(w))
        return want

    out, lse = hold(("out", "lse", "dq", "dk", "dv"), fm.flash_mask_fwd, fm.flash_mask_fwd_plain,
                    fm.flash_mask_bwd, fm.flash_mask_bwd_plain, (q, k, v, adj, val))
    aout, alse = hold(("add out", "add lse", "d e_row", "d e_col", "add dv"), fm.flash_add_fwd,
                      fm.flash_add_fwd_plain, fm.flash_add_bwd, fm.flash_add_bwd_plain,
                      (e_row, e_col, v, adj, val))
    line = (f"  f={f} P={P} B={B} h={h} {dtype} precision={precision} val={with_val} "
            f"rate={rate} empty={empty}: max abs err "
            + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()))
    if rate > 0.0:
        J = min(f, P)
        onehot = torch.eye(P, f, device="cuda").reshape(1, P, 1, f).expand(B, P, h, f)
        onehot = onehot.to(dtype).contiguous()
        keep = fm.dropout_factor(DROP_SEED, rate, B, h, P, adj.device)[:, :, :J] != 0
        mask = (keep & adj[:, None, :J].bool()).permute(0, 3, 1, 2)  # [B, key, h, row j]
        dv1 = fm.flash_mask_bwd(q, k, v, adj, val, out, lse, onehot, **kw)[2]
        dv2 = fm.flash_add_bwd(e_row, e_col, v, adj, val, aout, alse, onehot, **kw)[2]
        for name, dv in (("#3", dv1), ("#4", dv2)):
            if not torch.equal(dv[..., :J] != 0, mask):
                raise AssertionError(f"{name} P={P}: the kept entries differ from the hash's")
        line += f"; #3's and #4's keep masks of rows < {J} bitwise the hash's"
    return line


def time_attention_kernels(smi, shape, seed):
    """#1 to #4 at ``shape`` (B, h, P, f) on ``attention_inputs``, fp32:
    each timed in turns with its plain version, beside its bound and SDPA's
    time.  Returns {name: (ms, plain_ms, bound_ms, bound_by, sdpa_ms)}."""
    import torch.nn.functional as F

    from dfgnn_tpu_torch.data.synthetic import attention_inputs
    from dfgnn_tpu_torch.ops import flash_mask as fm
    from dfgnn_tpu_torch.utils.benchmark import benchmark

    B, h, P, f = shape
    q, k, v, adj, _ = (torch.from_numpy(a).cuda()
                       for a in attention_inputs(np.random.default_rng(seed), B, h, P, f))
    rng = np.random.default_rng(seed + 1)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).cuda()
    e_row, e_col = (torch.from_numpy(rng.standard_normal((B, P, h)).astype(np.float32)).cuda()
                    for _ in range(2))
    out, lse = fm.flash_mask_fwd(q, k, v, adj, want_lse=True)
    aout, alse = fm.flash_add_fwd(e_row, e_col, v, adj, want_lse=True)
    mask = adj[:, None].bool()
    qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=1.0)
    lib_fwd = benchmark(sdpa)[1]
    lib_bwd = benchmark(lambda: torch.autograd.grad(sdpa(), (qg, kg, vg),
                                                    do.transpose(1, 2)))[1] - lib_fwd
    pre = e_row.permute(0, 2, 1)[..., None] + e_col.permute(0, 2, 1)[..., None, :]
    mask_g = torch.where(mask, F.leaky_relu(pre, 0.2), fm.NEG_BIG).requires_grad_(True)
    zq = torch.zeros(B, h, P, 8, device="cuda")
    vg2 = v.transpose(1, 2).detach().requires_grad_(True)
    asdpa = lambda: F.scaled_dot_product_attention(zq, zq, vg2, attn_mask=mask_g)
    alib_fwd = benchmark(asdpa)[1]
    alib_bwd = benchmark(lambda: torch.autograd.grad(asdpa(), (mask_g, vg2),
                                                     do.transpose(1, 2)))[1] - alib_fwd
    cases = [
        ("#1", lambda: fm.flash_mask_fwd_plain(q, k, v, adj),
         lambda: fm.flash_mask_fwd(q, k, v, adj),
         padded_attention_bound(2, adj, h, f, 4, False, TF32X3_FLOPS)[:2], lib_fwd),
        ("#3", lambda: fm.flash_mask_bwd_plain(q, k, v, adj, None, lse, do,
                                               fm.bwd_delta(do, out)),
         lambda: fm.flash_mask_bwd(q, k, v, adj, None, out, lse, do),
         padded_attention_bound(5, adj, h, f, 4, True, TF32X3_FLOPS)[:2], lib_bwd),
        ("#2", lambda: fm.flash_add_fwd_plain(e_row, e_col, v, adj),
         lambda: fm.flash_add_fwd(e_row, e_col, v, adj),
         attention_bound(1, adj, h, f, add_bytes(B, h, P, f, 4)[0], TF32X3_FLOPS)[:2],
         alib_fwd),
        ("#4", lambda: fm.flash_add_bwd_plain(e_row, e_col, v, adj, None, alse, do,
                                              fm.bwd_delta(do, aout)),
         lambda: fm.flash_add_bwd(e_row, e_col, v, adj, None, aout, alse, do),
         attention_bound(2, adj, h, f, add_bytes(B, h, P, f, 4)[1], TF32X3_FLOPS)[:2],
         alib_bwd),
    ]
    times = {}
    for name, plain_fn, kernel_fn, (bound_ms, bound_by), lib_ms in cases:
        ms, plain_ms = in_turns(benchmark, plain_fn, kernel_fn)
        times[name] = (ms, plain_ms, bound_ms, bound_by, lib_ms)
        print(f"  {name} at {shape}, fp32 ({smi}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; peak "
              f"{peak_name(TF32X3_FLOPS)}), SDPA {lib_ms:.4f} ms")
    print("  (SDPA: #1, #3 with the boolean mask, backward timed as (fwd+bwd) - fwd; #2, #4 "
          "with q = k = 0 of width 8 and the masked leaky scores as a float mask, backward to "
          "the mask and v; the backward times include delta = rowsum(dO * out))")
    return times


def wide_models(smi, impl):
    """The wide models of phases 26 and 27 through ``impl``: model_routes at
    hidden WIDE_HIDDEN on a PATTERN-like bs=1024 request, ogbg-molhiv
    bs=1024 and a second PATTERN-like batch for GAT.  Returns the GAT
    model, its batch and its input."""
    from dfgnn_tpu_torch import DenseBatch
    from dfgnn_tpu_torch.data.collate import batch_iterator
    from dfgnn_tpu_torch.data.datasets import load_batched
    from dfgnn_tpu_torch.data.synthetic import pattern_like_batch

    def pattern(seed):
        rng = np.random.default_rng(seed)
        batch = DenseBatch.from_graph_list(
            [(r, c, n) for r, c, n, _ in pattern_like_batch(rng, BATCH)], np_pad=NP_PAD)
        return batch, torch.from_numpy(rng.integers(0, 3, size=(BATCH * NP_PAD,))).cuda()

    ds = load_batched("ogbg-molhiv", n_graphs=BATCH * TRAJECTORY_STEPS, quiet=True)
    train = ("ogbg-molhiv", ds.task, ds.num_classes,
             list(batch_iterator(ds, BATCH, np_pad=NP_PAD)))
    sbatch, sx = pattern(42)
    gat = model_routes(smi, impl, "wide", WIDE_HIDDEN, pattern(40), train, (sbatch, sx))
    return gat, sbatch, sx


def model_routes(smi, impl, what, hidden, serve, train, gat_in):
    """GTModel and GAT's fig-1 Model at ``hidden`` with one head through
    ``impl`` (None: their default auto route, kernels #1 to #4;
    "flash_fused": #5 and #6, with #1 to #4 backward), each against
    method="dense", their launch counts asserted and each route's time and
    peak memory printed beside dense's: GTModel("PATTERN") serving
    ``serve`` (a DenseBatch and its category ids); a GTModel taking 3 Adam
    steps on ``train`` (dataset name, task, classes and batches of (g, x, y,
    mask), one a step); the fig-1 GAT Model on ``gat_in`` (a DenseBatch and
    its category ids), a forward and an Adam step.  ``what`` names the
    models in the printed lines.  Returns the GAT model."""
    from dfgnn_tpu_torch import GTModel
    from dfgnn_tpu_torch.models import Model
    from dfgnn_tpu_torch.ops import flash_mask as fm
    from dfgnn_tpu_torch.train import TrainState, make_loss_fn, train_step
    from dfgnn_tpu_torch.utils.benchmark import benchmark

    L, name = LAYERS, impl or "auto"
    fused = impl == "flash_fused"
    serve_n = (0, 0, 0, 0, L, 0) if fused else (L, 0, 0, 0, 0, 0)
    step = (L, L, 0, 0, L, 0) if fused else (L, L, 0, 0, 0, 0)
    gat_fwd = (0, 0, 0, 0, 0, 1) if fused else (0, 0, 1, 0, 0, 0)
    gat_train = (0, 0, 1, 1, 0, 1) if fused else (0, 0, 1, 1, 0, 0)
    counts = "launches of #1, #3, #2, #4, #5, #6"
    peak = lambda fn: f"{step_peak_mib(fn)[0]:.1f} MiB"

    # the GT model, serving
    batch, x = serve
    gt = GTModel("PATTERN", out_size=2, hidden_size=hidden, num_layers=L, num_heads=1,
                 generator=torch.Generator().manual_seed(40)).eval()
    with torch.inference_mode():
        fm.reset_launch_counts()
        logits = gt(batch, x, impl=impl)
        counts_must_be(f"the {what} GT {name} forward", serve_n)
        if logits.shape != (batch.n_graphs, 2) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{what} GT logits {tuple(logits.shape)}, finite "
                                 f"{bool(torch.isfinite(logits).all())}")
        e = max_err(logits, gt(batch, x, impl="dense"), MODEL_TOL)
        ms, dense_ms = in_turns(benchmark, lambda: gt(batch, x, impl="dense"),
                                lambda: gt(batch, x, impl=impl), names=("dense", name))
        mems = {m: peak(lambda m=m: gt(batch, x, impl=m)) for m in (impl, "dense")}
    print(f"{what} GT serving (GTModel PATTERN, hidden {hidden}, 1 head, {L} layers, "
          f"{batch.n_graphs} graphs at P={batch.np_pad}, {batch.n_edges} edges) through "
          f"{name}: {counts} {serve_n}; vs dense logits max abs err {e:.3e} (tol {MODEL_TOL}); "
          f"forward ({smi}): {name} {ms:.4f} ms, peak {mems[impl]}, dense {dense_ms:.4f} ms, "
          f"peak {mems['dense']}")
    del gt, logits

    # the GT model, training: 3 Adam steps through impl and through dense,
    # the same weights and batches
    dataset, task, classes, batches = train
    per_step = {name: step, "dense": (0,) * 6}
    models = {m: GTModel(dataset, out_size=1 if classes == 1 else classes, hidden_size=hidden,
                         num_layers=L, method=m, generator=torch.Generator().manual_seed(41))
              for m in per_step}
    models["dense"].load_state_dict(models[name].state_dict())
    losses, states = {}, {}
    for m, model in models.items():
        states[m] = (TrainState.create(model, lr=1e-3, step_lr_every=20),
                     make_loss_fn(model, task, classes))
        losses[m] = []
        for b in batches:
            fm.reset_launch_counts()
            losses[m].append(float(train_step(*states[m], *b)[1]))
            counts_must_be(f"a {what} GT {m} step", per_step[m])
    for i, (a, d) in enumerate(zip(losses[name], losses["dense"])):
        if not (math.isfinite(a) and abs(a - d) <= TRAJECTORY_RTOL * abs(d)):
            raise AssertionError(f"{what} GT Adam step {i}: loss {name} {a} vs dense {d}")
    step_ms = {m: benchmark(lambda s=s: train_step(*s, *batches[0]))[1]
               for m, s in states.items()}
    mems = {m: peak(lambda s=s: train_step(*s, *batches[0])) for m, s in states.items()}
    g0 = batches[0][0]
    print(f"{what} GT training (GTModel {dataset}, hidden {hidden}, 1 head, {L} layers, "
          f"{g0.n_graphs} graphs at P={g0.np_pad}): {len(batches)} Adam steps, {counts} {step} a "
          f"step through {name}, none through dense; losses {name} "
          f"{[round(v, 7) for v in losses[name]]}, dense {[round(v, 7) for v in losses['dense']]} "
          f"(rtol {TRAJECTORY_RTOL}); a step ({smi}): {name} {step_ms[name]:.4f} ms, peak "
          f"{mems[name]}, dense {step_ms['dense']:.4f} ms, peak {mems['dense']}")
    del models, states, batches

    # the GAT model: a forward and a step, against dense
    sbatch, sx = gat_in
    mask = sbatch.node_mask.reshape(-1, 1).float()
    gat = Model("PATTERN", "gat", hidden, generator=torch.Generator().manual_seed(42))
    target = torch.from_numpy(np.random.default_rng(42).standard_normal(
        (sbatch.n_graphs * sbatch.np_pad, hidden)).astype(np.float32)).cuda()
    params = list(gat.parameters())

    def gat_loss(i):
        gat.zero_grad()
        loss = (((gat(sbatch, sx, impl=i) - target) ** 2) * mask).mean()
        loss.backward()
        return float(loss.detach()), [p.grad.clone() for p in params]

    with torch.inference_mode():
        fm.reset_launch_counts()
        out = gat(sbatch, sx, impl=impl)
        counts_must_be(f"the {what} GAT {name} forward", gat_fwd)
        e = max_err(out, gat(sbatch, sx, impl="dense"), MODEL_TOL)
        gat_ms, gdense_ms = in_turns(benchmark, lambda: gat(sbatch, sx, impl="dense"),
                                     lambda: gat(sbatch, sx, impl=impl), names=("dense", name))
        mems = {m: peak(lambda m=m: gat(sbatch, sx, impl=m)) for m in (impl, "dense")}
    fm.reset_launch_counts()
    loss_a, grads_a = gat_loss(impl)
    counts_must_be(f"the {what} GAT {name} step", gat_train)
    loss_d, grads_d = gat_loss("dense")
    if not abs(loss_a - loss_d) <= TRAJECTORY_RTOL * abs(loss_d):
        raise AssertionError(f"{what} GAT loss {name} {loss_a} vs dense {loss_d}")
    # the gradients: rtol 1e-3 and atol 1e-4 of each tensor's largest element
    ge = max(max_err(a, d, dict(rtol=1e-3, atol=1e-4 * float(d.abs().max())))
             / float(d.abs().max()) for a, d in zip(grads_a, grads_d))
    step_mems = {i: peak(lambda i=i: gat_loss(i)) for i in (impl, "dense")}
    opt = torch.optim.Adam(params, lr=1e-3)
    fm.reset_launch_counts()
    gat_loss(impl)
    opt.step()
    counts_must_be(f"the {what} GAT {name} Adam step", gat_train)
    print(f"{what} GAT (fig-1 Model PATTERN gat, hidden {hidden}, 1 head, {sbatch.n_graphs} "
          f"graphs at P={sbatch.np_pad}, {sbatch.n_edges} edges) through {name}: a forward "
          f"{counts} {gat_fwd}, vs dense max abs err {e:.3e} (tol {MODEL_TOL}); a step "
          f"{gat_train}: loss {loss_a:.7f}, dense {loss_d:.7f}; gradients within {ge:.2e} of "
          f"their largest element of dense's (bar rtol 1e-3, atol 1e-4 of it); forward ({smi}): "
          f"{name} {gat_ms:.4f} ms, peak {mems[impl]}, dense {gdense_ms:.4f} ms, peak "
          f"{mems['dense']}; forward + backward peak {name} {step_mems[impl]}, dense "
          f"{step_mems['dense']}")
    return gat


def wide_phase(smi):
    """Phase 26: head dims past 256 (#1 to #4) and the precision switch (#1
    to #6).  The wide GT model (GTModel at hidden 512, one head: head dim
    512) serves a PATTERN-like bs=1024 request through #1 and takes 3 Adam
    steps on ogbg-molhiv bs=1024 through #1 and #3, each against
    method="dense"; the fig-1 GAT Model at hidden 512 serves through #2 and
    takes a step through #2 and #4, against dense; #1 to #4 at f = 257, 384,
    512, 1024 and P = 26, 128, 300, 2048 against their plain versions; #1 to
    #4 timed at the table's shape at f = 512 beside their bounds and SDPA;
    #1 to #6 at precision="default" against their TF32-rounded plain
    versions at the table's shape, timed against "highest", and "highest"
    bitwise equal to no precision."""
    from dfgnn_tpu_torch.data.synthetic import attention_inputs
    from dfgnn_tpu_torch.ops import flash_mask as fm
    from dfgnn_tpu_torch.utils.benchmark import benchmark

    # the wide GT and GAT models through their auto route (#1 to #4)
    wide_models(smi, None)

    # #1 to #4 past f = 256 against their plain versions
    n = 0
    for f in WIDE_F:
        for P in WIDE_P:
            for dtype in (torch.float32, torch.bfloat16):
                B, h = WIDE_BH[P]
                print(attention_case(fm, 50 + n, B, h, P, f, dtype, with_val=f in (257, 512),
                                     rate=0.4 if P in (26, 300) else 0.0))
                n += 1
    print(f"#1 to #4 held against their plain versions at {n} points (f in {WIDE_F}, P in "
          f"{WIDE_P}, fp32 and bf16): fp32 forwards {FP32_TOL}; fp32 gradients against the "
          f"plain versions in fp64 at {BWD_FP32_TOL}, or within {FP32_GRAD_SPREAD}x the fp32 "
          f"plain version's error (printed beside); bf16 {BF16_TOL} and a bf16 step of each "
          f"gradient")

    # #1 to #4 at the table's shape at f = 512: times beside bounds and SDPA
    time_attention_kernels(smi, WIDE_TABLE, 60)

    # #1 to #6 at precision="default" against their TF32-rounded plain
    # versions at the table's shape, timed against "highest"; "highest"
    # bitwise equal to the default precision of fp32 inputs
    B, h, P, f = MAIN_SHAPE
    q, k, v, adj, _ = (torch.from_numpy(a).cuda()
                       for a in attention_inputs(np.random.default_rng(62), B, h, P, f))
    rng = np.random.default_rng(63)
    t = lambda *shape, s=1.0: torch.from_numpy((rng.standard_normal(shape) * s)
                                               .astype(np.float32)).cuda()
    do, e_row, e_col = t(B, P, h, f), t(B, P, h), t(B, P, h)
    x, bias = t(B, P, f), [t(h, f, s=0.1) for _ in range(3)]
    ws = [t(h, f, f, s=f ** -0.5) for _ in range(3)]
    lse = {p: fm.flash_mask_fwd(q, k, v, adj, want_lse=True, precision=p)
           for p in fm.PRECISIONS}
    alse = {p: fm.flash_add_fwd(e_row, e_col, v, adj, want_lse=True, precision=p)
            for p in fm.PRECISIONS}
    calls = {  # name: (kernel(precision), plain(precision))
        "#1": (lambda p: fm.flash_mask_fwd(q, k, v, adj, precision=p)[0],
               lambda p: fm.flash_mask_fwd_plain(q, k, v, adj, precision=p)[0]),
        "#3": (lambda p: fm.flash_mask_bwd(q, k, v, adj, None, *lse[p or "highest"], do,
                                           precision=p),
               lambda p: fm.flash_mask_bwd_plain(q, k, v, adj, None, lse[p][1], do,
                                                 fm.bwd_delta(do, lse[p][0]), precision=p)),
        "#2": (lambda p: fm.flash_add_fwd(e_row, e_col, v, adj, precision=p)[0],
               lambda p: fm.flash_add_fwd_plain(e_row, e_col, v, adj, precision=p)[0]),
        "#4": (lambda p: fm.flash_add_bwd(e_row, e_col, v, adj, None, *alse[p or "highest"],
                                          do, precision=p),
               lambda p: fm.flash_add_bwd_plain(e_row, e_col, v, adj, None, alse[p][1], do,
                                                fm.bwd_delta(do, alse[p][0]), precision=p)),
        "#5": (lambda p: fm.flash_layer_dot_fwd(x, ws[0], bias[0], ws[1], bias[1], ws[2],
                                                bias[2], adj, scale=f ** -0.5, precision=p),
               lambda p: fm.flash_layer_dot_fwd_plain(x, ws[0], bias[0], ws[1], bias[1], ws[2],
                                                      bias[2], adj, scale=f ** -0.5,
                                                      precision=p)),
        "#6": (lambda p: fm.flash_layer_add_fwd(x, ws[0], bias[0], bias[1], bias[2], adj,
                                                seed=DROP_SEED, rate=0.4, precision=p),
               lambda p: fm.flash_layer_add_fwd_plain(x, ws[0], bias[0], bias[1], bias[2], adj,
                                                      seed=DROP_SEED, rate=0.4, precision=p)),
    }
    tuple_of = lambda r: r if isinstance(r, tuple) else (r,)
    for name, (kernel_fn, plain_fn) in calls.items():
        got, want = tuple_of(kernel_fn("default")), tuple_of(plain_fn("default"))
        torch.cuda.synchronize()
        errs = [max_err(g, w, tf32_tol(w)) / float(w.abs().max()) for g, w in zip(got, want)]
        if not all(torch.equal(a, b) for a, b in zip(tuple_of(kernel_fn("highest")),
                                                     tuple_of(kernel_fn(None)))):
            raise AssertionError(f"{name}: precision='highest' differs from None on fp32")
        one, three = in_turns(benchmark, lambda: kernel_fn("highest"),
                              lambda: kernel_fn("default"), names=("highest", "default"))
        print(f"  {name} at {MAIN_SHAPE} (din {f}), fp32 ({smi}): 'default' against its "
              f"TF32-rounded plain version within {max(errs):.2e} of the largest element (bar "
              f"a TF32 step, {TF32_STEP:.3g}); 'highest' bitwise no precision; 'default' "
              f"{one:.4f} ms, 'highest' {three:.4f} ms")


def layer_case(fm, seed, B, h, P, f, dtype, precision, rate):
    """#5 and #6 at head dim ``f`` against their plain versions on x [B, P,
    WIDE_DIN] and random weights: fp32 at "highest" within FP32_TOL, at
    "default" within a TF32 step of the largest element of the TF32-rounded
    plain version (tf32_tol), bf16 within BF16_TOL; #6 with dropout at
    ``rate``; every fourth graph empty where B >= 4, and every row without an
    edge exactly 0.  Returns the printed line."""
    from dfgnn_tpu_torch.data.synthetic import attention_inputs

    rng = np.random.default_rng(seed)
    adj = torch.from_numpy(attention_inputs(rng, B, h, P, 8)[3]).cuda()
    if B >= 4:
        adj[::4] = 0
    t = lambda shape, s: torch.from_numpy((rng.standard_normal(shape) * s)
                                          .astype(np.float32)).cuda()
    x = t((B, P, WIDE_DIN), 1.0).to(dtype)
    ws = [t((h, WIDE_DIN, f), WIDE_DIN ** -0.5).to(dtype) for _ in range(3)]
    vecs = [t((h, f), f ** -0.5) for _ in range(3)]
    dot = (x, ws[0], vecs[0], ws[1], vecs[1], ws[2], vecs[2], adj)
    add = (x, ws[0], vecs[0], vecs[1], vecs[2], adj)
    kw5 = dict(scale=f ** -0.5, precision=precision)
    kw6 = dict(slope=0.2, seed=DROP_SEED, rate=rate, precision=precision)
    empty = ~adj.bool().any(-1)
    errs = {}
    for name, kernel, plain in (
            ("#5", lambda: fm.flash_layer_dot_fwd(*dot, **kw5),
             lambda: fm.flash_layer_dot_fwd_plain(*dot, **kw5)),
            ("#6", lambda: fm.flash_layer_add_fwd(*add, **kw6),
             lambda: fm.flash_layer_add_fwd_plain(*add, **kw6))):
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        tol = (BF16_TOL if dtype == torch.bfloat16
               else tf32_tol(want) if precision == "default" else FP32_TOL)
        errs[name] = max_err(got, want, tol)
        if got.shape != (B, P, h, f) or bool(got[empty].any()):
            raise AssertionError(f"{name} f={f} P={P}: shape {tuple(got.shape)}, or a row "
                                 f"without an edge is not 0")
    return (f"  f={f} P={P} B={B} h={h} din={WIDE_DIN} {dtype} precision={precision} #6 "
            f"rate={rate}: max abs err " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()))


def wide_layer_phase(smi):
    """Phase 27: the whole-layer kernels past head dim 256.  #5 and #6 at f
    = 257, 384, 512, 1024 and P = 26, 128, 300, 2048 (fp32 at both
    precisions and bf16) against their plain versions; the wide GT model
    (GTModel at hidden 512, one head) through impl="flash_fused": a
    PATTERN-like bs=1024 request through #5 and 3 Adam steps on
    ogbg-molhiv bs=1024 through #5 forward and #1 + #3 backward, against
    method="dense"; the wide fig-1 GAT Model (hidden 512) through
    flash_fused: a forward through #6 and a step through #6, #2 and #4,
    against dense; the GAT conv in bf16 at head dims 128, 192, 256, 384
    and 512 through #6 against fp32, timed in turns against its flash route
    (the readings behind GAT_FUSED_MAX_F), and method="auto" taking the
    route that bound names; #5 and #6 at the wide models' shape
    (WIDE_TABLE) and past P = 128 (WIDE_STREAM), din WIDE_HIDDEN, held
    against their plain versions at FP32_TOL and timed in turns with them,
    beside their compositions and bounds."""
    from dfgnn_tpu_torch.models import conv as conv_mod, make_conv
    from dfgnn_tpu_torch.ops import flash_mask as fm
    from dfgnn_tpu_torch.utils.benchmark import benchmark

    # #5 and #6 past f = 256 against their plain versions
    n = 0
    for f in WIDE_F:
        for P in WIDE_P:
            for dtype, precision in ((torch.float32, "highest"), (torch.float32, "default"),
                                     (torch.bfloat16, None)):
                print(layer_case(fm, 100 + n, *WIDE_BH[P], P, f, dtype, precision,
                                 0.4 if P in (26, 300) else 0.0))
                n += 1
    print(f"#5 and #6 held against their plain versions at {n} points (f in {WIDE_F}, P in "
          f"{WIDE_P}; fp32 'highest' {FP32_TOL}, fp32 'default' a TF32 step of the largest "
          f"element of the TF32-rounded plain version, bf16 {BF16_TOL})")

    # the wide GT and GAT models through the whole-layer kernels
    gat, sbatch, sx = wide_models(smi, "flash_fused")

    # the GAT conv in bf16 at head dims 128 to 512 (512: the wide model's own
    # conv): #6 against the fp32 conv, and timed in turns against the flash
    # route, the readings behind GAT_FUSED_MAX_F; method="auto" takes the
    # route _auto_bf16_gat names
    with torch.inference_mode():
        h0 = gat.inproj(sx)
    for f in (128, 192, 256, 384, WIDE_HIDDEN):
        conv32 = (gat.conv if f == WIDE_HIDDEN
                  else make_conv("gat", WIDE_HIDDEN, f, 1,
                                 generator=torch.Generator().manual_seed(f)))
        conv16 = make_conv("gat", WIDE_HIDDEN, f, 1, dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(f))
        conv16.load_state_dict(conv32.state_dict())
        route = conv_mod._auto_bf16_gat(sbatch, f)
        with torch.inference_mode():
            fm.reset_launch_counts()
            out16 = conv16(sbatch, h0, impl="flash_fused")
            counts_must_be(f"the bf16 GAT conv at head dim {f} through flash_fused",
                           (0, 0, 0, 0, 0, 1))
            want = conv32(sbatch, h0, impl="flash_fused")
            rel16 = float((out16.float() - want).abs().max() / want.abs().max())
            if out16.dtype != torch.bfloat16 or not rel16 < BF16_REL:
                raise AssertionError(f"bf16 GAT at head dim {f}: {out16.dtype}, max |diff| / "
                                     f"max |fp32| {rel16}")
            fm.reset_launch_counts()
            conv16(sbatch, h0)
            counts_must_be(f"the bf16 GAT conv at head dim {f} through auto ({route})",
                           (0, 0, 0, 0, 0, 1) if route == "flash_fused" else (0, 0, 1, 0, 0, 0))
            fused16_ms, flash16_ms = in_turns(
                benchmark, lambda: conv16(sbatch, h0, impl="flash"),
                lambda: conv16(sbatch, h0, impl="flash_fused"), names=("flash", "#6"))
        print(f"bf16 GAT conv (din {WIDE_HIDDEN}, head dim {f}, bs={BATCH}): #6 vs the fp32 conv "
              f"max |diff| / max |fp32| {rel16:.3e} (bar {BF16_REL}); method='auto' takes "
              f"{route} (GAT_FUSED_MAX_F {conv_mod.GAT_FUSED_MAX_F}); forward ({smi}): #6 "
              f"{fused16_ms:.4f} ms, flash route (F.linear, the score contractions, #2) "
              f"{flash16_ms:.4f} ms (ratio {fused16_ms / flash16_ms:.3f})")
    del gat, sbatch, sx, conv16, conv32, out16, want, h0

    # #5 and #6 at the wide models' shape, and past P = 128 (the stream
    # blocks, whose chunk blocks re-form the scores)
    for shape, seed in ((WIDE_TABLE, 64), (WIDE_STREAM, 65)):
        time_layer_kernels(smi, shape, WIDE_HIDDEN, seed)


def time_layer_kernels(smi, shape, din, seed):
    """#5 and #6 at ``shape`` (B, h, P, f) on x [B, P, din] and random fp32
    weights: held against their plain versions at FP32_TOL, then timed in
    turns with them, beside their compositions and bounds.  Returns {name:
    (ms, plain_ms, bound_ms, bound_by, composition ms)}, #5's composition
    F.linear + SDPA."""
    import torch.nn.functional as F

    from dfgnn_tpu_torch.data.synthetic import attention_inputs
    from dfgnn_tpu_torch.ops import flash_mask as fm
    from dfgnn_tpu_torch.utils.benchmark import benchmark

    B, h, P, f = shape
    rng = np.random.default_rng(seed)
    adj = torch.from_numpy(attention_inputs(rng, B, h, P, 8)[3]).cuda()
    t = lambda shape, s: torch.from_numpy((rng.standard_normal(shape) * s)
                                          .astype(np.float32)).cuda()
    x = t((B, P, din), 1.0)
    ws = [t((h, din, f), din ** -0.5) for _ in range(3)]
    vecs = [t((h, f), f ** -0.5) for _ in range(3)]
    dot = (x, ws[0], vecs[0], ws[1], vecs[1], ws[2], vecs[2], adj)
    add = (x, ws[0], vecs[0], vecs[1], vecs[2], adj)
    x2, mask = x.reshape(B * P, din), adj[:, None].bool()
    w_cat = torch.cat([w.permute(0, 2, 1).reshape(h * f, din) for w in ws])
    b_cat = torch.cat([v.reshape(h * f) for v in vecs])
    heads = lambda a: a.reshape(B, P, h, f)

    def linear_flash():
        q, k, v = F.linear(x2, w_cat, b_cat).split(h * f, dim=1)
        return fm.flash_mask_fwd((heads(q) * f ** -0.5).contiguous(),
                                 heads(k).contiguous(), heads(v).contiguous(), adj)[0]

    def linear_sdpa():
        q, k, v = (heads(a).transpose(1, 2)
                   for a in F.linear(x2, w_cat, b_cat).split(h * f, dim=1))
        return F.scaled_dot_product_attention(q * f ** -0.5, k, v, attn_mask=mask,
                                              scale=1.0)

    edges = int(adj.sum())
    times = {}
    for name, score, kernel_fn, plain_fn, comps in (
            ("#5", "dot", lambda: fm.flash_layer_dot_fwd(*dot, scale=f ** -0.5),
             lambda: fm.flash_layer_dot_fwd_plain(*dot, scale=f ** -0.5),
             (("F.linear + SDPA", linear_sdpa), ("F.linear + #1", linear_flash))),
            ("#6", "add", lambda: fm.flash_layer_add_fwd(*add),
             lambda: fm.flash_layer_add_fwd_plain(*add),
             (("F.linear, contractions, SDPA with a float mask", add_composition(*add)),))):
        got = kernel_fn()
        torch.cuda.synchronize()
        err = max_err(got, plain_fn(), FP32_TOL)
        del got
        ms, plain_ms = in_turns(benchmark, plain_fn, kernel_fn)
        comp_ms = [benchmark(fn)[1] for _, fn in comps]
        comp = ", ".join(f"{c} {t:.4f} ms" for (c, _), t in zip(comps, comp_ms))
        flops, nbytes = layer_work(score, B, P, din, h, f, edges, 4)
        bound_ms, bound_by = bound(flops, nbytes, TF32X3_FLOPS)
        times[name] = (ms, plain_ms, bound_ms, bound_by, comp_ms[0])
        print(f"  {name} at {shape}, din {din}, fp32 ({smi}): against its plain "
              f"version max abs err {err:.2e} (bar {FP32_TOL}); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, {comp}; bound {bound_ms:.4f} ms ({bound_by}; "
              f"{edges} edges, {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; peak "
              f"{peak_name(TF32X3_FLOPS)})")
    return times


def large_graph_phase(smi):
    """Phase 28: graphs past P = 2048, where the stream blocks of #1 to #6
    walk adj in windows of 2048 keys (#3's column pass and #4: rows).  #1 to
    #4 at P = 2049, 2176, 4096 and f = 64, 128, 256, 300 (fp32 and bf16;
    edge values, dropout with the keep masks bitwise, an empty graph and
    precision="default" at one point each) and #1 to #4 at P = 8192 against
    their plain versions; #5 and #6 at the same P and f = 64, 128 (#6 with
    dropout at 2176); #1 to #6 timed at LARGE_TABLE beside their plain
    versions, bounds and nearest PyTorch calls; then GTModel (8 layers,
    hidden 128, one head) serving and taking 3 Adam steps, and the fig-1
    GAT Model a forward and a step, on a DenseBatch of 8 graphs of about
    3,000 nodes (P up to 4096) through auto (#1 to #4) and flash_fused (#5
    and #6), each against method="dense" with its launches asserted.
    Returns the timings: {name: (ms, plain_ms, bound_ms, bound_by,
    library_ms)}."""
    from dfgnn_tpu_torch import DenseBatch
    from dfgnn_tpu_torch.data.synthetic import small_graph_batch
    from dfgnn_tpu_torch.ops import flash_mask as fm

    # #1 to #4 against their plain versions
    n = 0
    for P in LARGE_P:
        B, h = LARGE_BH[P]
        for f in LARGE_F:
            opts = dict(with_val=(P, f) == (2049, 128), empty=(P, f) == (2176, 128),
                        rate=0.4 if (P, f) == (4096, 256) else 0.0)
            for dtype in (torch.float32, torch.bfloat16):
                print(attention_case(fm, 200 + n, B, h, P, f, dtype, **opts))
                n += 1
    print(attention_case(fm, 200 + n, *LARGE_BH[4096], 4096, 128, torch.float32,
                         with_val=False, rate=0.0, precision="default"))
    print(attention_case(fm, 201 + n, 1, 1, 8192, 64, torch.float32, with_val=False, rate=0.0))
    print(f"#1 to #4 held against their plain versions at {n + 2} points (P in {LARGE_P} x f in "
          f"{LARGE_F}, fp32 and bf16; 'default' at P=4096 f=128; P=8192 f=64): fp32 forwards "
          f"{FP32_TOL}; fp32 gradients against the plain versions in fp64 at {BWD_FP32_TOL}, or "
          f"within {FP32_GRAD_SPREAD}x the fp32 plain version's error (printed beside); bf16 "
          f"{BF16_TOL} and a bf16 step of each gradient; 'default' a TF32 step; rows without "
          f"an edge exactly 0")

    # #5 and #6 against their plain versions
    n = 0
    for P in LARGE_P:
        for f in LARGE_F[:2]:
            for dtype in (torch.float32, torch.bfloat16):
                print(layer_case(fm, 300 + n, *LARGE_BH[P], P, f, dtype, None,
                                 0.4 if P == 2176 else 0.0))
                n += 1
    print(f"#5 and #6 held against their plain versions at {n} points (P in {LARGE_P} x f in "
          f"{LARGE_F[:2]}, din {WIDE_DIN}, fp32 {FP32_TOL}, bf16 {BF16_TOL})")

    # #1 to #6 timed at LARGE_TABLE
    times = time_attention_kernels(smi, LARGE_TABLE, 210)
    times.update(time_layer_kernels(smi, LARGE_TABLE, LARGE_TABLE[3], 211))

    # the GT and GAT models on a batch of large graphs, through auto (#1 to
    # #4) and flash_fused (#5, #6), against dense
    rng = np.random.default_rng(220)
    graphs = small_graph_batch(rng, LARGE_GRAPHS, mean_nodes=LARGE_MEAN, deg=8,
                               max_nodes=LARGE_MAX)
    batch = DenseBatch.from_graph_list([(r, c, n) for r, c, n, _ in graphs])
    x = torch.from_numpy(rng.integers(0, 3, size=(batch.n_graphs * batch.np_pad,))).cuda()
    y = torch.from_numpy(rng.integers(0, 2, size=batch.n_graphs)).cuda()
    mask = torch.ones(batch.n_graphs, dtype=torch.bool, device="cuda")
    train = ("PATTERN", "graph_classification", 2, [(batch, x, y, mask)] * TRAJECTORY_STEPS)
    print(f"the large-graph batch: {batch.n_graphs} graphs of {sorted(n for *_, n, _ in graphs)} "
          f"nodes, P={batch.np_pad}, {batch.n_edges} edges")
    for impl in (None, "flash_fused"):
        model_routes(smi, impl, "large-graph", HIDDEN, (batch, x), train, (batch, x))
    return times


def phase_done(name: str) -> None:
    """Prints the wall time since the previous phase ended."""
    now = time.perf_counter()
    print(f"[phase {name}: {now - _PHASE_START[0]:.2f} s wall]", flush=True)
    _PHASE_START[0] = now


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from dfgnn_tpu_torch import DenseBatch, GTModel
    from dfgnn_tpu_torch.models import FullGraphNet, Model, make_conv
    from dfgnn_tpu_torch.data.collate import batch_iterator, collate_dense
    from dfgnn_tpu_torch.data.datasets import load_batched
    from dfgnn_tpu_torch.data.synthetic import attention_inputs, pattern_like_batch
    from dfgnn_tpu_torch.ops import _cuda, flash_mask, gather
    from dfgnn_tpu_torch.parallel import partition, partition_graph
    from dfgnn_tpu_torch.scripts import (ablation, bench_partition_build, microbench_gather,
                                         profile_train_step, shmoo,
                                         test_batch_graph, test_full_graph, test_gt_graphworld,
                                         train_batch_graph_timing, train_full_graph_timing,
                                         train_gatconv, train_gtconv, train_parity,
                                         train_sampled)
    from dfgnn_tpu_torch.data.sampling import NeighborSampler, sampled_block_attention
    from dfgnn_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
    from dfgnn_tpu_torch.utils.profiling import annotate, profile_region
    from dfgnn_tpu_torch.train import TrainState, make_loss_fn, train_step
    from dfgnn_tpu_torch import formats
    from dfgnn_tpu_torch.data.datasets import load_full_graph
    from dfgnn_tpu_torch.graph import Graph
    from dfgnn_tpu_torch.ops import bucket, edge_dropout, reference
    from dfgnn_tpu_torch.train.parity import _noisy_onehot, run_parity_batched, run_parity_full
    from dfgnn_tpu_torch.utils.benchmark import Timer, benchmark

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"nvidia-smi name, power.limit on the next line")
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN: the fp32 reference runs its products in full fp32")

    # 2. build
    t0 = time.perf_counter()
    lib, log = _cuda.build()
    print(f"built {lib.name} with nvcc in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")
    phase_done("1-2 device and build")

    def inputs(seed, B, h, P, f, with_val, dtype):
        q, k, v, adj, val = (torch.from_numpy(a).cuda() for a in
                             attention_inputs(np.random.default_rng(seed), B, h, P, f))
        return q.to(dtype), k.to(dtype), v.to(dtype), adj, val if with_val else None

    def kept(adj, h, rate):
        if rate == 0.0:
            return ""
        B, P, _ = adj.shape
        keep = flash_mask.dropout_factor(DROP_SEED, rate, B, h, P, adj.device) != 0
        frac = float(keep[adj[:, None].bool().expand_as(keep)].float().mean())
        return f"; kept {frac:.4f} of the edges (rate {rate})"

    fwd_rec = {"name": "flash_mask_fwd", "route": "cuda",
               "source": "dfgnn_tpu_torch/csrc/flash_mask_fwd.cu",
               "replaces": "dfgnn_tpu/ops/pallas/flash_mask.py:160"}
    bwd_rec = {"name": "flash_mask_bwd", "route": "cuda",
               "source": "dfgnn_tpu_torch/csrc/flash_mask_bwd.cu",
               "replaces": "dfgnn_tpu/ops/pallas/flash_mask.py:256"}
    layer_rec = {"name": "flash_layer_dot_fwd", "route": "cuda",
                 "source": "dfgnn_tpu_torch/csrc/flash_layer_dot.cu",
                 "replaces": "dfgnn_tpu/ops/pallas/flash_mask.py:508"}
    layer_add_rec = {"name": "flash_layer_add_fwd", "route": "cuda",
                     "source": "dfgnn_tpu_torch/csrc/flash_layer_add.cu",
                     "replaces": "dfgnn_tpu/ops/pallas/flash_mask.py:649"}

    def set_bound(rec, n_products, adj, h, f, nbytes, peak=TF32X3_FLOPS):
        bound_ms, bound_by, dense_ms = attention_bound(n_products, adj, h, f, nbytes, peak)
        rec.update(bound_ms=bound_ms, bound_by=bound_by)
        print(f"  bound on these inputs ({int(adj.sum())} edges of {adj.numel()} block "
              f"entries; peak {peak_name(peak)}, {HBM_BYTES_PER_S:.3g} B/s): {bound_ms:.4f} ms "
              f"({bound_by}); over every entry of the dense [P, P] blocks {dense_ms:.4f} ms")

    def set_dot_bound(rec, adj, h, f, backward):
        """#1 and #3: the bound of padded_attention_bound (rows with an edge)."""
        bound_ms, bound_by, edges = padded_attention_bound(5 if backward else 2, adj, h, f, 4,
                                                           backward, TF32X3_FLOPS)
        rec.update(bound_ms=bound_ms, bound_by=bound_by)
        print(f"  bound on these inputs ({edges} edges; the rows that hold an edge, adj and "
              f"the full outputs; peak {peak_name(TF32X3_FLOPS)}, {HBM_BYTES_PER_S:.3g} B/s): "
              f"{bound_ms:.4f} ms ({bound_by})")

    # 3. kernel #1 against its plain version
    for i, (B, h, P, f, with_val, dtype) in enumerate(KERNEL_SHAPES):
        q, k, v, adj, val = inputs(i, B, h, P, f, with_val, dtype)
        out, lse = flash_mask.flash_mask_fwd(q, k, v, adj, val, want_lse=True)
        torch.cuda.synchronize()
        want_out, want_lse = flash_mask.flash_mask_fwd_plain(q, k, v, adj, val)
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        e_out = max_err(out, want_out, tol)
        e_lse = max_err(lse, want_lse, FP32_TOL)
        print(f"fwd kernel vs plain B={B} h={h} P={P} f={f} val={with_val} {dtype}: "
              f"max abs err out {e_out:.3e} (tol {tol}), lse {e_lse:.3e} (tol {FP32_TOL})")
        if (B, h, P, f) == MAIN_SHAPE:
            ms, plain_ms = in_turns(
                benchmark,
                lambda: flash_mask.flash_mask_fwd_plain(q, k, v, adj),
                lambda: flash_mask.flash_mask_fwd(q, k, v, adj))
            print(f"  {dtype} at the main shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  f"({smi})")
            if dtype == torch.float32:
                mask = adj[:, None].bool()
                qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
                lib_ms = benchmark(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, scale=1.0))[1]
                print(f"  library: scaled_dot_product_attention forward, boolean mask, "
                      f"{lib_ms:.4f} ms")
                set_dot_bound(fwd_rec, adj, h, f, backward=False)
                fwd_rec.update(max_abs_err=e_out, ms=ms, plain_ms=plain_ms, library_ms=lib_ms)

    phase_done("3 kernel #1")

    # 4. kernel #3 against its plain version
    for i, (B, h, P, f, with_val, dtype) in enumerate(BWD_SHAPES):
        q, k, v, adj, val = inputs(10 + i, B, h, P, f, with_val, dtype)
        out, lse = flash_mask.flash_mask_fwd_plain(q, k, v, adj, val)
        do = torch.from_numpy(np.random.default_rng(100 + i).standard_normal(q.shape)
                              .astype(np.float32)).cuda().to(dtype)
        got = flash_mask.flash_mask_bwd(q, k, v, adj, val, out, lse, do)
        torch.cuda.synchronize()
        want = flash_mask.flash_mask_bwd_plain(q, k, v, adj, val, lse, do,
                                               flash_mask.bwd_delta(do, out))
        tols = [BWD_FP32_TOL if dtype == torch.float32 else bwd_bf16_tol(w) for w in want]
        errs = [max_err(g, w, t) for g, w, t in zip(got, want, tols)]
        if (lse == flash_mask.NEG_BIG).sum() == 0:
            raise AssertionError("the inputs have no empty rows")
        print(f"bwd kernel vs plain B={B} h={h} P={P} f={f} val={with_val} {dtype}: max abs err "
              + ", ".join(f"{n} {e:.3e} (max |{n}| {float(w.float().abs().max()):.3g}, atol "
                          f"{t['atol']:.3g})" for n, e, w, t in zip(("dq", "dk", "dv"), errs,
                                                                     want, tols)))
        if (B, h, P, f) == MAIN_SHAPE:
            ms, plain_ms = in_turns(
                benchmark,
                lambda: flash_mask.flash_mask_bwd_plain(q, k, v, adj, val, lse, do,
                                                        flash_mask.bwd_delta(do, out)),
                lambda: flash_mask.flash_mask_bwd(q, k, v, adj, val, out, lse, do))
            print(f"  {dtype} at the main shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  f"({smi}); both include delta = rowsum(dO * out)")
            if dtype == torch.float32:
                mask = adj[:, None].bool()
                qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
                do_h = do.transpose(1, 2)
                sdpa = lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                                              scale=1.0)
                lib_fwd = benchmark(sdpa)[1]
                lib_both = benchmark(lambda: torch.autograd.grad(sdpa(), (qg, kg, vg), do_h))[1]
                lib_ms = lib_both - lib_fwd
                print(f"  library: scaled_dot_product_attention backward, boolean mask, timed "
                      f"as (fwd+bwd) - fwd = {lib_both:.4f} - {lib_fwd:.4f} = {lib_ms:.4f} ms")
                set_dot_bound(bwd_rec, adj, h, f, backward=True)
                bwd_rec.update(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=lib_ms)

    phase_done("4 kernel #3")

    # 4b. kernels #1 and #3 at the main path's own inputs (the adjacency of
    #     the GT step's ogbg-molhiv bs=1024 batch and of the PATTERN bs=1024
    #     serving batch, seeded q, k, v at f=128), then at the table's shape
    #     with dropout 0.4, at an odd head dim (f=75, no 16-byte rows) and on
    #     a batch whose every fourth graph is empty: each held against its
    #     plain version and timed in turns, SDPA beside the main inputs
    molhiv = load_batched("ogbg-molhiv", n_graphs=BATCH, quiet=True)
    molhiv_adj = collate_dense(molhiv, np.arange(BATCH), np_pad=NP_PAD, device="cuda")[0].adj
    pattern_adj = DenseBatch.from_graph_list(
        [(r, c, n) for r, c, n, _ in pattern_like_batch(np.random.default_rng(0), BATCH)],
        np_pad=NP_PAD).adj

    def dot_case(name, adj, f, dtype, rate=0.0, seed=0, time_it=True, sdpa=False):
        B, P, _ = adj.shape
        rng = np.random.default_rng(seed)
        feats = lambda: torch.from_numpy(rng.standard_normal((B, P, 1, f))
                                         .astype(np.float32)).cuda()
        q, k, v, do = feats() * f ** -0.5, feats(), feats(), feats()
        q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
        kw = dict(seed=DROP_SEED, rate=rate)
        out, lse = flash_mask.flash_mask_fwd(q, k, v, adj, want_lse=True, **kw)
        got = flash_mask.flash_mask_bwd(q, k, v, adj, None, out, lse, do, **kw)
        torch.cuda.synchronize()
        want_out, want_lse = flash_mask.flash_mask_fwd_plain(q, k, v, adj, **kw)
        want = flash_mask.flash_mask_bwd_plain(q, k, v, adj, None, lse, do,
                                               flash_mask.bwd_delta(do, out), **kw)
        fp32 = dtype == torch.float32
        e_out = max_err(out, want_out, FP32_TOL if fp32 else BF16_TOL)
        e_lse = max_err(lse, want_lse, FP32_TOL)
        tols = [BWD_FP32_TOL if fp32 else bwd_bf16_tol(w) for w in want]
        errs = [max_err(g, w, t) for g, w, t in zip(got, want, tols)]
        empty = adj.sum(-1) == 0
        if bool(empty.any()) and not (bool((out[empty] == 0).all())
                                      and bool((lse[0][empty] == flash_mask.NEG_BIG).all())
                                      and bool((got[0][empty] == 0).all())):
            raise AssertionError(f"{name}: rows without an edge must give out = 0, "
                                 f"lse = -1e30 and dq = 0")
        line = (f"#1/#3 {name}: B={B} P={P} f={f} {dtype} rate={rate}, {int(adj.sum())} edges, "
                f"{int(empty.sum())} rows without an edge: max abs err out {e_out:.3e}, lse "
                f"{e_lse:.3e}, dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e}")
        if fp32:  # how far the kernel and the fp32 plain version are from exact
            d = lambda t: t.double()
            exact = flash_mask.flash_mask_bwd_plain(
                d(q), d(k), d(v), adj, None, d(lse), d(do),
                flash_mask.bwd_delta(d(do), d(out)), **kw)[0]
            line += (f"; dq against the plain version evaluated in fp64: kernel "
                     f"{float((got[0].double() - exact).abs().max()):.3e}, fp32 plain "
                     f"{float((want[0].double() - exact).abs().max()):.3e}")
            del exact
        print(line + kept(adj, 1, rate))
        if not time_it:
            return
        fwd_ms, fwd_plain = in_turns(
            benchmark, lambda: flash_mask.flash_mask_fwd_plain(q, k, v, adj, **kw),
            lambda: flash_mask.flash_mask_fwd(q, k, v, adj, **kw))
        bwd_ms, bwd_plain = in_turns(
            benchmark, lambda: flash_mask.flash_mask_bwd_plain(
                q, k, v, adj, None, lse, do, flash_mask.bwd_delta(do, out), **kw),
            lambda: flash_mask.flash_mask_bwd(q, k, v, adj, None, out, lse, do, **kw))
        item = 4 if fp32 else 2
        peak = TF32X3_FLOPS if fp32 else BF16_FLOPS
        bf = padded_attention_bound(2, adj, 1, f, item, False, peak)
        bb = padded_attention_bound(5, adj, 1, f, item, True, peak)
        msg = (f"  {name} ({smi}): #1 {fwd_ms:.4f} ms (plain {fwd_plain:.4f}, bound "
               f"{bf[0]:.4f} {bf[1]}), #3 {bwd_ms:.4f} ms (plain {bwd_plain:.4f}, bound "
               f"{bb[0]:.4f} {bb[1]}; both include delta; peak {peak_name(peak)})")
        if sdpa:
            mask = adj[:, None].bool()
            qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
            run = lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=1.0)
            lib_fwd = benchmark(run)[1]
            lib_both = benchmark(lambda: torch.autograd.grad(run(), (qg, kg, vg),
                                                             do.transpose(1, 2)))[1]
            msg += (f"; SDPA forward {lib_fwd:.4f} ms, backward (fwd+bwd - fwd) "
                    f"{lib_both - lib_fwd:.4f} ms")
        print(msg)

    for name, adj in (("ogbg-molhiv bs=1024 (the GT step's batch)", molhiv_adj),
                      ("PATTERN bs=1024 (the serving batch)", pattern_adj)):
        for dtype in (torch.float32, torch.bfloat16):
            dot_case(name, adj, HIDDEN, dtype, seed=3, sdpa=dtype == torch.float32)
    table_adj = inputs(0, *MAIN_SHAPE, False, torch.float32)[3]
    dot_case("table shape, dropout", table_adj, 128, torch.float32, rate=0.4, seed=4)
    dot_case("table shape, dropout", table_adj, 128, torch.bfloat16, rate=0.4, seed=4,
             time_it=False)
    for dtype in (torch.float32, torch.bfloat16):
        dot_case("table shape, odd head dim", table_adj, 75, dtype, seed=5,
                 time_it=dtype == torch.float32)
    holes = table_adj.clone()
    holes[::4] = 0
    dot_case("table shape, every fourth graph empty", holes, 128, torch.float32, seed=6)
    del molhiv, pattern_adj  # molhiv_adj, table_adj and holes serve phase 10 too
    phase_done("4b kernels #1 and #3 at the main path's inputs")

    # 5. serving: GTModel forward over bs=1024 PATTERN-like requests
    model = GTModel("PATTERN", out_size=2, hidden_size=HIDDEN, num_layers=LAYERS, num_heads=1,
                    generator=torch.Generator().manual_seed(0), device="cuda").eval()
    requests = []
    for i in range(N_REQUESTS):
        rng = np.random.default_rng(i)
        graphs = [(r, c, n) for r, c, n, _ in pattern_like_batch(rng, BATCH)]
        batch = DenseBatch.from_graph_list(graphs, np_pad=NP_PAD)
        x = torch.from_numpy(rng.integers(0, 3, size=(BATCH * NP_PAD,))).to("cuda")
        requests.append((batch, x))
    print(f"made {N_REQUESTS} requests of {BATCH} PATTERN-like graphs, "
          f"{[b.n_edges for b, _ in requests]} edges")

    def serve(impl, kernel):
        """Logits of each request through ``impl``; ``LAYERS`` launches of
        kernel ``kernel`` (an index of launch_counts()) a request, none else."""
        out = []
        flash_mask.reset_launch_counts()
        with torch.inference_mode():
            for batch, x in requests:
                before = flash_mask.launch_counts()[kernel]
                out.append(model(batch, x, impl=impl))
                torch.cuda.synchronize()
                if flash_mask.launch_counts()[kernel] - before != LAYERS:
                    raise AssertionError(f"{impl}: {flash_mask.launch_counts()[kernel] - before} "
                                         f"kernel launches in a request, expected {LAYERS}")
        seen = flash_mask.launch_counts()
        want = tuple(N_REQUESTS * LAYERS if i == kernel else 0 for i in range(6))
        if seen != want:
            raise AssertionError(f"{impl} serving launched #1, #3, #2, #4, #5, #6 {seen}, "
                                 f"expected {want}")
        return out

    logits = serve(None, 0)
    print(f"served {N_REQUESTS} requests through method='auto': "
          f"{N_REQUESTS * LAYERS} kernel #1 launches ({LAYERS} per request), none of the others")

    with torch.inference_mode():
        for i, ((batch, x), got) in enumerate(zip(requests, logits)):
            if got.shape != (BATCH, 2):
                raise AssertionError(f"logits shape {tuple(got.shape)}")
            e = max_err(got, model(batch, x, impl="dense"), MODEL_TOL)
            print(f"request {i}: auto vs dense logits max abs err {e:.3e} (tol {MODEL_TOL})")

        # a small input against the CPU model (the plain path) with the same weights
        rng = np.random.default_rng(100)
        small = DenseBatch.from_graph_list(
            [(r, c, n) for r, c, n, _ in pattern_like_batch(rng, 4)], np_pad=NP_PAD,
            device="cpu")
        xs = torch.from_numpy(rng.integers(0, 3, size=(4 * NP_PAD,)))
        cpu_model = GTModel("PATTERN", out_size=2, hidden_size=HIDDEN, num_layers=LAYERS,
                            generator=torch.Generator().manual_seed(1), device="cpu")
        cpu_model.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
        e = max_err(model(small.to("cuda"), xs.to("cuda")).cpu(), cpu_model(small, xs), MODEL_TOL)
        print(f"small batch on the card vs the CPU model: max abs err {e:.3e} (tol {MODEL_TOL})")

        batch, x = requests[0]
        auto_ms, dense_ms = in_turns(
            benchmark,
            lambda: model(batch, x, impl="dense"),
            lambda: model(batch, x), names=("dense", "auto"))
    edges = batch.n_edges * LAYERS
    print(f"GTModel forward per bs={BATCH} request ({smi}): "
          f"auto {auto_ms:.4f} ms ({edges / auto_ms * 1e3:.4e} edges/s), "
          f"dense {dense_ms:.4f} ms ({edges / dense_ms * 1e3:.4e} edges/s); "
          f"edges/s = edges x layers / forward time")
    phase_done("5 GT serving through auto")

    # 5b. GT serving through the whole-layer kernel #5
    fused = serve("flash_fused", 4)
    with torch.inference_mode():
        for i, ((batch, x), got) in enumerate(zip(requests, fused)):
            e = max_err(got, model(batch, x, impl="dense"), MODEL_TOL)
            print(f"request {i}: flash_fused vs dense logits max abs err {e:.3e} (tol {MODEL_TOL})")
        batch, x = requests[0]
        fused_ms, auto_ms = in_turns(
            benchmark,
            lambda: model(batch, x),
            lambda: model(batch, x, impl="flash_fused"), names=("auto", "flash_fused"))
        dense_ms = benchmark(lambda: model(batch, x, impl="dense"))[1]
    print(f"served {N_REQUESTS} requests through impl='flash_fused': {N_REQUESTS * LAYERS} "
          f"kernel #5 launches ({LAYERS} per request), none of the others; GTModel forward per "
          f"bs={BATCH} request ({smi}): flash_fused {fused_ms:.4f} ms "
          f"({edges / fused_ms * 1e3:.4e} edges/s), auto {auto_ms:.4f} ms, dense "
          f"{dense_ms:.4f} ms")
    del model, requests, logits, fused
    phase_done("5b GT serving through flash_fused")

    # 6. training: the trainer twin, ogbg-molhiv, bs=1024, 8 steps an epoch
    flash_mask.reset_launch_counts()
    t0 = time.perf_counter()
    history = train_gtconv.main(TRAIN_ARGS + ["--epochs", str(EPOCHS)])
    torch.cuda.synchronize()
    seen = flash_mask.launch_counts()
    train_fwd, train_bwd = seen[:2]
    if seen[2:] != (0, 0, 0, 0):
        raise AssertionError(f"the GT training twin launched #2, #4, #5 or #6: {seen}")
    steps = history["steps"]
    if len(steps) != EPOCHS * STEPS_PER_EPOCH:
        raise AssertionError(f"{len(steps)} train steps, expected {EPOCHS * STEPS_PER_EPOCH}")
    for n, st in enumerate(steps):
        if (st["fwd_launches"], st["bwd_launches"]) != (LAYERS, LAYERS):
            raise AssertionError(f"step {n}: {st['fwd_launches']} forward and "
                                 f"{st['bwd_launches']} backward launches, expected {LAYERS} each")
        if not math.isfinite(st["loss"]):
            raise AssertionError(f"step {n}: loss {st['loss']}")
    print(f"trained {len(steps)} steps in {time.perf_counter() - t0:.2f} s (host clock, data "
          f"set-up included): {LAYERS} forward + {LAYERS} backward kernel launches every step; "
          f"{train_fwd} forward (training and {EPOCHS} evaluation passes) and {train_bwd} "
          f"backward launches in the run; losses {[round(st['loss'], 5) for st in steps]}")
    fwd_rec["launches"], bwd_rec["launches"] = train_fwd, train_bwd
    phase_done("6 GT training twin")

    # 7. trajectory: 3 Adam steps through the kernels (8 + 8 launches a step),
    #    through the whole-layer kernel (8 #5 + 8 #1 + 8 #3 a step) and through
    #    the dense path (none)
    ds = load_batched("ogbg-molhiv", n_graphs=BATCH * TRAJECTORY_STEPS, quiet=True)
    batches = list(batch_iterator(ds, BATCH, np_pad=NP_PAD))
    per_step = {"auto": (LAYERS, LAYERS, 0, 0, 0, 0), "dense": (0,) * 6,
                "flash_fused": (LAYERS, LAYERS, 0, 0, LAYERS, 0)}
    models = {name: GTModel("ogbg-molhiv", out_size=1, hidden_size=HIDDEN, num_layers=LAYERS,
                            method=name, generator=torch.Generator().manual_seed(2))
              for name in per_step}
    for name in ("dense", "flash_fused"):
        models[name].load_state_dict(models["auto"].state_dict())
    losses = {}
    for name, m in models.items():
        state = TrainState.create(m, lr=1e-3, step_lr_every=20)
        loss_fn = make_loss_fn(m, ds.task, ds.num_classes)
        losses[name] = []
        for b in batches:
            flash_mask.reset_launch_counts()
            losses[name].append(float(train_step(state, loss_fn, *b)[1]))
            if flash_mask.launch_counts() != per_step[name]:
                raise AssertionError(f"{name}: a step launched #1, #3, #2, #4, #5, #6 "
                                     f"{flash_mask.launch_counts()}, expected {per_step[name]}")
    for i, d in enumerate(losses["dense"]):
        for name in ("auto", "flash_fused"):
            a = losses[name][i]
            if not abs(a - d) <= TRAJECTORY_RTOL * abs(d):
                raise AssertionError(f"Adam step {i}: loss {name} {a} vs dense {d}")
        print(f"Adam step {i}: loss auto {losses['auto'][i]:.7f}, flash_fused "
              f"{losses['flash_fused'][i]:.7f}, dense {d:.7f}, rel diff "
              f"{max(abs(losses[n][i] - d) for n in ('auto', 'flash_fused')) / abs(d):.2e} "
              f"(rtol {TRAJECTORY_RTOL}); launches a step: auto {per_step['auto']}, "
              f"flash_fused {per_step['flash_fused']}")
    layer_rec["launches"] = TRAJECTORY_STEPS * LAYERS
    del models
    phase_done("7 GT Adam steps: auto, flash_fused, dense")

    # 8. --checkgrad at full width (exits 1 on a mismatch)
    train_gtconv.main(TRAIN_ARGS + ["--checkgrad"])

    phase_done("8 checkgrad")

    # 9. a train step's time and peak memory: forward, backward, Adam update
    batch, x, y, m = batches[0]
    model = GTModel("ogbg-molhiv", out_size=1, hidden_size=HIDDEN, num_layers=LAYERS,
                    generator=torch.Generator().manual_seed(4))
    state = TrainState.create(model, lr=1e-3, step_lr_every=20)
    loss_fn = make_loss_fn(model, ds.task, ds.num_classes)
    steps = {impl: (lambda impl=impl: train_step(state, lambda *a: loss_fn(*a, impl=impl),
                                                 batch, x, y, m))
             for impl in ("auto", "dense", "flash_fused")}
    step_auto, step_dense = in_turns(benchmark, steps["dense"], steps["auto"],
                                     names=("dense", "auto"))
    step_fused, step_auto2 = in_turns(benchmark, steps["auto"], steps["flash_fused"],
                                      names=("auto", "flash_fused"))
    peaks = {name: step_peak_mib(fn) for name, fn in steps.items()}
    print(f"train step (forward + backward + Adam) per bs={BATCH} ogbg-molhiv batch ({smi}): "
          f"auto {step_auto:.4f} ms, dense {step_dense:.4f} ms (one pair of turns); "
          f"flash_fused {step_fused:.4f} ms, auto {step_auto2:.4f} ms (the next pair); peak "
          f"device memory allocated during one step above what was allocated at its start (the "
          f"model, Adam's moments, the batches and this script's other tensors; "
          f"{peaks['dense'][1]:.1f} MiB at the last step's start): auto "
          f"{peaks['auto'][0]:.1f} MiB, dense {peaks['dense'][0]:.1f} MiB, flash_fused "
          f"{peaks['flash_fused'][0]:.1f} MiB")
    del model, state, steps, batches
    phase_done("9 GT train step time")

    # 9b. where a GT step's device time goes: the profile_train_step twin's
    #     breakdown by kernel group, through auto and through dense
    for impl in ("auto", "dense"):
        profile_train_step.main(["--impl", impl])
    phase_done("9b GT step breakdown")

    # 10. kernels #2 and #4 (the additive score) against their plain versions,
    #     without and with dropout: the kernel and the plain version draw the
    #     same hash mask, so the fp32 bars hold with dropout too
    add_fwd_rec = {"name": "flash_add_fwd", "route": "cuda",
                   "source": "dfgnn_tpu_torch/csrc/flash_add_fwd.cu",
                   "replaces": "dfgnn_tpu/ops/pallas/flash_mask.py:173"}
    add_bwd_rec = {"name": "flash_add_bwd", "route": "cuda",
                   "source": "dfgnn_tpu_torch/csrc/flash_add_bwd.cu",
                   "replaces": "dfgnn_tpu/ops/pallas/flash_mask.py:286"}

    def add_inputs(seed, B, h, P, f, with_val, dtype):
        _, _, v, adj, val = inputs(seed, B, h, P, f, with_val, dtype)
        rng = np.random.default_rng(seed + 500)
        e_row, e_col = (torch.from_numpy(rng.standard_normal((B, P, h)).astype(np.float32))
                        .cuda().to(dtype) for _ in range(2))
        return e_row, e_col, v, adj, val

    def masked_leaky(e_row, e_col, adj):
        """The float attn_mask handed to SDPA, built outside the timed call:
        leaky_relu(e_row + e_col) on the edges, -1e30 elsewhere, [B, h, P, P]."""
        pre = e_row.permute(0, 2, 1)[..., None] + e_col.permute(0, 2, 1)[..., None, :]
        return torch.where(adj[:, None].bool(), F.leaky_relu(pre, 0.2), flash_mask.NEG_BIG)

    sdpa_note = ("q = k = 0 of width 8 and the masked leaky scores as a float attn_mask, built "
                 "outside the timed call; rows without edges average v where the kernel gives 0")
    for i, (B, h, P, f, with_val, dtype) in enumerate(ADD_SHAPES):
        e_row, e_col, v, adj, val = add_inputs(20 + i, B, h, P, f, with_val, dtype)
        for rate in DROP_RATES:
            kw = dict(slope=0.2, seed=DROP_SEED, rate=rate)
            out, lse = flash_mask.flash_add_fwd(e_row, e_col, v, adj, val, want_lse=True, **kw)
            torch.cuda.synchronize()
            want_out, want_lse = flash_mask.flash_add_fwd_plain(e_row, e_col, v, adj, val, **kw)
            tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
            e_out = max_err(out, want_out, tol)
            e_lse = max_err(lse, want_lse, FP32_TOL)
            print(f"add fwd kernel vs plain B={B} h={h} P={P} f={f} val={with_val} {dtype} "
                  f"rate={rate}: max abs err out {e_out:.3e} (tol {tol}), lse {e_lse:.3e}"
                  + kept(adj, h, rate))
            if (B, h, P, f) not in (MAIN_SHAPE, ADD_TRAIN):
                continue
            where = "the main shape" if (B, h, P, f) == MAIN_SHAPE else "the training shape"
            if rate > 0.0:
                drop_ms = benchmark(lambda: flash_mask.flash_add_fwd(e_row, e_col, v, adj, **kw))[1]
                print(f"  {dtype} at {where} with dropout rate {rate}: kernel {drop_ms:.4f} ms")
                continue
            ms, plain_ms = in_turns(
                benchmark,
                lambda: flash_mask.flash_add_fwd_plain(e_row, e_col, v, adj),
                lambda: flash_mask.flash_add_fwd(e_row, e_col, v, adj))
            item, peak = (4, TF32X3_FLOPS) if dtype == torch.float32 else (2, BF16_FLOPS)
            bound_ms, bound_by, _ = attention_bound(1, adj, h, f, add_bytes(B, h, P, f, item)[0],
                                                    peak)
            print(f"  {dtype} at {where}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}; peak {peak_name(peak)}) ({smi})")
            if dtype == torch.float32 and (B, h, P, f) == MAIN_SHAPE:
                mask_f = masked_leaky(e_row, e_col, adj)
                zq = torch.zeros(B, h, P, 8, device="cuda")
                vh = v.transpose(1, 2)
                lib_ms = benchmark(lambda: F.scaled_dot_product_attention(
                    zq, zq, vh, attn_mask=mask_f))[1]
                print(f"  library: scaled_dot_product_attention forward, {sdpa_note}: "
                      f"{lib_ms:.4f} ms")
                set_bound(add_fwd_rec, 1, adj, h, f, add_bytes(B, h, P, f, 4)[0])
                add_fwd_rec.update(max_abs_err=e_out, ms=ms, plain_ms=plain_ms,
                                   library_ms=lib_ms)

    def add_case(name, adj, f, dtype, rate=0.0, seed=0, time_it=True):
        """#2 on one adjacency against its plain version (rows without an
        edge exactly 0 and -1e30), timed in turns; the bound counts the
        feature rows of keys with an edge, as #1's does."""
        B, P, _ = adj.shape
        rng = np.random.default_rng(seed)
        t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
        e_row, e_col, v = t(B, P, 1), t(B, P, 1), t(B, P, 1, f).to(dtype)
        kw = dict(slope=0.2, seed=DROP_SEED, rate=rate)
        out, lse = flash_mask.flash_add_fwd(e_row, e_col, v, adj, want_lse=True, **kw)
        torch.cuda.synchronize()
        want_out, want_lse = flash_mask.flash_add_fwd_plain(e_row, e_col, v, adj, **kw)
        fp32 = dtype == torch.float32
        e_out = max_err(out, want_out, FP32_TOL if fp32 else BF16_TOL)
        e_lse = max_err(lse, want_lse, FP32_TOL)
        empty = adj.sum(-1) == 0
        if not (bool((out[empty] == 0).all())
                and bool((lse[0][empty] == flash_mask.NEG_BIG).all())):
            raise AssertionError(f"#2 {name}: rows without an edge must give out = 0 and "
                                 f"lse = -1e30")
        print(f"#2 {name}: B={B} P={P} f={f} {dtype} rate={rate}, {int(adj.sum())} edges, "
              f"{int(empty.sum())} rows without an edge: max abs err out {e_out:.3e}, lse "
              f"{e_lse:.3e}" + kept(adj, 1, rate))
        if not time_it:
            return
        ms, plain_ms = in_turns(
            benchmark, lambda: flash_mask.flash_add_fwd_plain(e_row, e_col, v, adj, **kw),
            lambda: flash_mask.flash_add_fwd(e_row, e_col, v, adj, **kw))
        item, peak = (4, TF32X3_FLOPS) if fp32 else (2, BF16_FLOPS)
        keys = int((adj.sum(-2) > 0).sum())
        nbytes = keys * f * item + B * P * P + B * P * f * item + 3 * B * P * 4
        bound_ms, bound_by = bound(2 * int(adj.sum()) * f, nbytes, peak)
        print(f"  #2 {name} ({smi}): {ms:.4f} ms (plain {plain_ms:.4f}, bound {bound_ms:.4f} "
              f"{bound_by}; peak {peak_name(peak)})")

    for rate in DROP_RATES:
        for dtype in (torch.float32, torch.bfloat16):
            add_case("ogbg-molhiv bs=1024 (the GT step's batch)", molhiv_adj, HIDDEN, dtype,
                     rate=rate, seed=30)
        add_case("table shape, every fourth graph empty", holes, HIDDEN, torch.float32,
                 rate=rate, seed=31)
        add_case("table adjacency at f=64 (the training shape)", table_adj, 64,
                 torch.bfloat16, rate=rate, seed=32, time_it=rate == 0.0)

    for i, (B, h, P, f, with_val, dtype) in enumerate(ADD_BWD_SHAPES):
        e_row, e_col, v, adj, val = add_inputs(40 + i, B, h, P, f, with_val, dtype)
        do = torch.from_numpy(np.random.default_rng(140 + i).standard_normal(v.shape)
                              .astype(np.float32)).cuda().to(dtype)
        for rate in DROP_RATES:
            kw = dict(slope=0.2, seed=DROP_SEED, rate=rate)
            out, lse = flash_mask.flash_add_fwd_plain(e_row, e_col, v, adj, val, **kw)
            got = flash_mask.flash_add_bwd(e_row, e_col, v, adj, val, out, lse, do, **kw)
            torch.cuda.synchronize()
            want = flash_mask.flash_add_bwd_plain(e_row, e_col, v, adj, val, lse, do,
                                                  flash_mask.bwd_delta(do, out), **kw)
            tols = [BWD_FP32_TOL if dtype == torch.float32 else bwd_bf16_tol(w) for w in want]
            errs = [max_err(g, w, t) for g, w, t in zip(got, want, tols)]
            if (lse == flash_mask.NEG_BIG).sum() == 0:
                raise AssertionError("the inputs have no empty rows")
            print(f"add bwd kernel vs plain B={B} h={h} P={P} f={f} val={with_val} {dtype} "
                  f"rate={rate}: max abs err "
                  + ", ".join(f"{n} {e:.3e} (max |{n}| {float(w.float().abs().max()):.3g}, "
                              f"atol {t['atol']:.3g})" for n, e, w, t in
                              zip(("d e_row", "d e_col", "dv"), errs, want, tols))
                  + kept(adj, h, rate))
            if (B, h, P, f) != MAIN_SHAPE:
                continue
            if rate > 0.0:
                drop_ms = benchmark(lambda: flash_mask.flash_add_bwd(
                    e_row, e_col, v, adj, val, out, lse, do, **kw))[1]
                print(f"  {dtype} with dropout rate {rate}: kernel {drop_ms:.4f} ms")
                continue
            ms, plain_ms = in_turns(
                benchmark,
                lambda: flash_mask.flash_add_bwd_plain(e_row, e_col, v, adj, val, lse, do,
                                                       flash_mask.bwd_delta(do, out)),
                lambda: flash_mask.flash_add_bwd(e_row, e_col, v, adj, val, out, lse, do))
            print(f"  {dtype} at the main shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  f"({smi}); both include delta = rowsum(dO * out)")
            if dtype == torch.float32:
                mask_g = masked_leaky(e_row, e_col, adj).requires_grad_(True)
                zq = torch.zeros(B, h, P, 8, device="cuda")
                vg = v.transpose(1, 2).detach().requires_grad_(True)
                do_h = do.transpose(1, 2)
                sdpa = lambda: F.scaled_dot_product_attention(zq, zq, vg, attn_mask=mask_g)
                lib_fwd = benchmark(sdpa)[1]
                lib_both = benchmark(lambda: torch.autograd.grad(sdpa(), (mask_g, vg), do_h))[1]
                lib_ms = lib_both - lib_fwd
                print(f"  library: scaled_dot_product_attention backward to the float mask and "
                      f"v ({sdpa_note}; the sums of the mask's gradient into d e_row, d e_col "
                      f"are not included), timed as (fwd+bwd) - fwd = {lib_both:.4f} - "
                      f"{lib_fwd:.4f} = {lib_ms:.4f} ms")
                set_bound(add_bwd_rec, 2, adj, h, f, add_bytes(B, h, P, f, 4)[1])
                add_bwd_rec.update(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                                   library_ms=lib_ms)

    # 10 (continued). fp32 scores with a bf16 v, as the bf16 GAT layer hands them
    #    to kernels #2 and #4
    B, h, P, f = 1024, 1, 128, 64
    e_row, e_col, v, adj, _ = add_inputs(60, B, h, P, f, False, torch.float32)
    v = v.bfloat16()
    do = torch.from_numpy(np.random.default_rng(160).standard_normal(v.shape)
                          .astype(np.float32)).cuda().bfloat16()
    for rate in DROP_RATES:
        kw = dict(slope=0.2, seed=DROP_SEED, rate=rate)
        out, lse = flash_mask.flash_add_fwd(e_row, e_col, v, adj, want_lse=True, **kw)
        want_out, want_lse = flash_mask.flash_add_fwd_plain(e_row, e_col, v, adj, **kw)
        e_out, e_lse = max_err(out, want_out, BF16_TOL), max_err(lse, want_lse, FP32_TOL)
        got = flash_mask.flash_add_bwd(e_row, e_col, v, adj, None, want_out, want_lse, do, **kw)
        want = flash_mask.flash_add_bwd_plain(e_row, e_col, v, adj, None, want_lse, do,
                                              flash_mask.bwd_delta(do, want_out), **kw)
        if [t.dtype for t in got] != [torch.float32, torch.float32, torch.bfloat16]:
            raise AssertionError(f"d e_row, d e_col, dv dtypes {[t.dtype for t in got]}")
        errs = [max_err(g, w, bwd_bf16_tol(w)) for g, w in zip(got, want)]
        print(f"add kernels with fp32 e_row, e_col and bf16 v, B={B} h={h} P={P} f={f} "
              f"rate={rate}: max abs err out {e_out:.3e}, lse {e_lse:.3e}, d e_row {errs[0]:.3e}, "
              f"d e_col {errs[1]:.3e}, dv {errs[2]:.3e}")

    def add_bwd_case(name, adj, f, dtype, rate=0.0, seed=0, time_it=False):
        """#4 on one adjacency against its plain version (keys without an
        edge give dv = 0 and d e_col = 0 exactly); with dropout, its keep
        mask against the hash's, bitwise: with dO the one-hot rows j < f,
        dv[c, j] = round_to<T>(p * keep)[j, c], nonzero exactly where the
        edge is kept.  Timed in turns when asked."""
        B, P, _ = adj.shape
        rng = np.random.default_rng(seed)
        t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
        e_row, e_col, v, do = t(B, P, 1), t(B, P, 1), t(B, P, 1, f).to(dtype), t(B, P, 1, f)
        do = do.to(dtype)
        kw = dict(slope=0.2, seed=DROP_SEED, rate=rate)
        out, lse = flash_mask.flash_add_fwd_plain(e_row, e_col, v, adj, **kw)
        got = flash_mask.flash_add_bwd(e_row, e_col, v, adj, None, out, lse, do, **kw)
        torch.cuda.synchronize()
        want = flash_mask.flash_add_bwd_plain(e_row, e_col, v, adj, None, lse, do,
                                              flash_mask.bwd_delta(do, out), **kw)
        fp32 = dtype == torch.float32
        tols = [BWD_FP32_TOL if fp32 else bwd_bf16_tol(w) for w in want]
        errs = [max_err(g, w, tol) for g, w, tol in zip(got, want, tols)]
        keyless = adj.sum(-2) == 0  # [B, P]
        if not (bool((got[1][..., 0][keyless] == 0).all())
                and bool((got[2][keyless] == 0).all())):
            raise AssertionError(f"#4 {name}: keys without an edge must give d e_col = dv = 0")
        line = (f"#4 {name}: B={B} P={P} f={f} {dtype} rate={rate}, {int(adj.sum())} edges, "
                f"{int(keyless.sum())} keys without an edge: max abs err d e_row {errs[0]:.3e}, "
                f"d e_col {errs[1]:.3e}, dv {errs[2]:.3e}" + kept(adj, 1, rate))
        if rate > 0.0:
            J = min(f, P)
            onehot = torch.eye(P, f, device="cuda").reshape(1, P, 1, f).expand(B, P, 1, f)
            dv1 = flash_mask.flash_add_bwd(e_row, e_col, v, adj, None, out, lse,
                                           onehot.to(dtype).contiguous(), **kw)[2]
            keep = flash_mask.dropout_factor(DROP_SEED, rate, B, 1, P, adj.device)[:, 0, :J] != 0
            mask = (keep & adj[:, :J].bool()).transpose(1, 2)  # [B, key, row j]
            if not torch.equal(dv1[:, :, 0, :J] != 0, mask):
                raise AssertionError(f"#4 {name}: the kept entries differ from the hash's")
            line += f"; keep mask of rows < {J} bitwise the hash's"
        print(line)
        if not time_it:
            return
        ms, plain_ms = in_turns(
            benchmark, lambda: flash_mask.flash_add_bwd_plain(e_row, e_col, v, adj, None, lse, do,
                                                              flash_mask.bwd_delta(do, out), **kw),
            lambda: flash_mask.flash_add_bwd(e_row, e_col, v, adj, None, out, lse, do, **kw))
        item, peak = (4, TF32X3_FLOPS) if fp32 else (2, BF16_FLOPS)
        bound_ms, bound_by, _ = attention_bound(2, adj, 1, f, add_bytes(B, 1, P, f, item)[1], peak)
        print(f"  #4 {name} ({smi}): {ms:.4f} ms (plain {plain_ms:.4f}, bound {bound_ms:.4f} "
              f"{bound_by}; peak {peak_name(peak)}; both include delta)")

    p300_adj = inputs(61, 16, 1, 300, 8, False, torch.float32)[3]
    for rate in DROP_RATES:
        for dtype in (torch.float32, torch.bfloat16):
            add_bwd_case("ogbg-molhiv bs=1024 (the GT step's batch)", molhiv_adj, HIDDEN, dtype,
                         rate=rate, seed=33, time_it=rate == 0.0)
        add_bwd_case("table adjacency at f=64 (the GAT training shape)", table_adj, 64,
                     torch.float32, rate=rate, seed=34, time_it=rate == 0.0)
        for f in (48, 75):
            add_bwd_case("table adjacency, off-grid head dim", table_adj, f, torch.float32,
                         rate=rate, seed=35)
        add_bwd_case("table adjacency, off-grid head dim", table_adj, 75, torch.bfloat16,
                     rate=rate, seed=36)
        add_bwd_case("P=300 (three key blocks)", p300_adj, 64, torch.float32, rate=rate, seed=37)
        add_bwd_case("table shape, every fourth graph empty", holes, HIDDEN, torch.float32,
                     rate=rate, seed=38)
    phase_done("10 kernels #2 and #4")

    # 10b. kernels #5 and #6 (the whole layers) against their plain versions;
    #      #6 with dropout also against the decomposed path (the projection,
    #      the score contractions and kernel #2) with the same seed
    def layer_inputs(seed, B, h, P, din, f, dtype):
        rng = np.random.default_rng(seed)
        _, _, _, adj, _ = inputs(seed, B, h, P, 8, False, torch.float32)
        t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
        x = t(rng.standard_normal((B, P, din))).to(dtype)
        ws = [t(rng.standard_normal((h, din, f)) / np.sqrt(din)).to(dtype) for _ in range(3)]
        vecs = [t(rng.standard_normal((h, f)) / np.sqrt(f)) for _ in range(3)]
        return x, ws, vecs, adj

    for i, (B, h, P, din, f, dtype) in enumerate(LAYER_SHAPES):
        x, (wq, wk, wv), (bq, bk, bv), adj = layer_inputs(70 + i, B, h, P, din, f, dtype)
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        dot_args = (x, wq, bq, wk, bk, wv, bv, adj)
        out = flash_mask.flash_layer_dot_fwd(*dot_args, scale=f ** -0.5)
        torch.cuda.synchronize()
        e_dot = max_err(out, flash_mask.flash_layer_dot_fwd_plain(*dot_args, scale=f ** -0.5),
                        tol)
        w, (b, al, ar) = wq, (bq, bk, bv)
        e_add = {}
        for rate in DROP_RATES:
            kw = dict(slope=0.2, seed=DROP_SEED, rate=rate)
            got = flash_mask.flash_layer_add_fwd(x, w, b, al, ar, adj, **kw)
            torch.cuda.synchronize()
            e_add[rate] = max_err(got, flash_mask.flash_layer_add_fwd_plain(x, w, b, al, ar, adj,
                                                                            **kw), tol)
            if rate > 0.0 and dtype == torch.float32:
                z = torch.einsum("bpd,hdf->bphf", x, w) + b
                decomposed, _ = flash_mask.flash_add_fwd((z * al).sum(-1), (z * ar).sum(-1), z,
                                                         adj, **kw)
                e_dec = max_err(got, decomposed, FP32_TOL)
                print(f"  #6 with dropout rate {rate} vs the decomposed path (kernel #2, same "
                      f"seed): max abs err {e_dec:.3e} (tol {FP32_TOL})" + kept(adj, h, rate))
        print(f"layer kernels vs plain B={B} h={h} P={P} din={din} f={f} {dtype}: max abs err "
              f"#5 {e_dot:.3e}, #6 {e_add[0.0]:.3e}, #6 with dropout {e_add[0.4]:.3e} (tol {tol})")
        if (B, h, P, din, f) != LAYER_MAIN:
            continue
        mask = adj[:, None].bool()
        x2 = x.reshape(B * P, din)
        w_cat = torch.cat([t.permute(0, 2, 1).reshape(h * f, din) for t in (wq, wk, wv)])
        b_cat = torch.cat([t.reshape(h * f) for t in (bq, bk, bv)]).to(dtype)
        heads = lambda t: t.reshape(B, P, h, f).transpose(1, 2)

        def sdpa_dot():
            q, k, v = F.linear(x2, w_cat, b_cat).split(h * f, dim=1)
            return F.scaled_dot_product_attention(heads(q) * f ** -0.5, heads(k), heads(v),
                                                  attn_mask=mask, scale=1.0)

        timed = {}
        for name, rec, kernel_fn, plain_fn, lib_fn in (
                ("#5", layer_rec,
                 lambda: flash_mask.flash_layer_dot_fwd(*dot_args, scale=f ** -0.5),
                 lambda: flash_mask.flash_layer_dot_fwd_plain(*dot_args, scale=f ** -0.5),
                 sdpa_dot),
                ("#6", layer_add_rec,
                 lambda: flash_mask.flash_layer_add_fwd(x, w, b, al, ar, adj),
                 lambda: flash_mask.flash_layer_add_fwd_plain(x, w, b, al, ar, adj),
                 add_composition(x, w, b, al, ar, adj))):
            ms, plain_ms = in_turns(benchmark, plain_fn, kernel_fn)
            lib_ms = benchmark(lib_fn)[1]
            timed[name] = ms
            print(f"  {name} {dtype} at the main shape ({smi}): kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library composition {lib_ms:.4f} ms")
            if dtype == torch.float32:
                score = "dot" if name == "#5" else "add"
                # both run their products as 3xTF32 on the tensor cores
                flops, nbytes = layer_work(score, B, P, din, h, f, int(adj.sum()), 4)
                bound_ms, bound_by = bound(flops, nbytes, TF32X3_FLOPS)
                rec.update(bound_ms=bound_ms, bound_by=bound_by, ms=ms, plain_ms=plain_ms,
                           max_abs_err=e_dot if name == "#5" else e_add[0.0], library_ms=lib_ms)
                print(f"  {name} bound on these inputs ({int(adj.sum())} edges; {flops / 1e9:.2f} "
                      f"GFLOP, {nbytes / 1e6:.1f} MB; peak {peak_name(TF32X3_FLOPS)}): "
                      f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        if dtype == torch.float32:
            drop_ms = benchmark(lambda: flash_mask.flash_layer_add_fwd(
                x, w, b, al, ar, adj, slope=0.2, seed=DROP_SEED, rate=0.4))[1]
            print(f"  #6 fp32 with dropout rate 0.4: kernel {drop_ms:.4f} ms (without "
                  f"{timed['#6']:.4f} ms)")
    print("library compositions: #5 = one F.linear over the concatenated [3*h*f, din] "
          "weights, then scaled_dot_product_attention with the boolean mask; #6 = F.linear, "
          "the two score contractions, the masked leaky scores as a float attn_mask (built "
          "inside the timed call) and scaled_dot_product_attention with q = k = 0 of width 8")

    def layer_dot_case(name, adj, din, f, dtype, seed, time_it=False):
        """#5 on one adjacency against its plain version: rows without an
        edge exactly 0; timed in turns beside its bound and the F.linear +
        SDPA composition when asked."""
        B, P, _ = adj.shape
        x, (wq, wk, wv), (bq, bk, bv), _ = layer_inputs(seed, B, 1, P, din, f, dtype)
        args = (x, wq, bq, wk, bk, wv, bv, adj)
        out = flash_mask.flash_layer_dot_fwd(*args, scale=f ** -0.5)
        torch.cuda.synchronize()
        want = flash_mask.flash_layer_dot_fwd_plain(*args, scale=f ** -0.5)
        fp32 = dtype == torch.float32
        err = max_err(out, want, FP32_TOL if fp32 else BF16_TOL)
        empty = adj.sum(-1) == 0
        if out.shape != (B, P, 1, f) or not bool((out[empty] == 0).all()):
            raise AssertionError(f"#5 {name}: shape {tuple(out.shape)}, or a row without an "
                                 f"edge is not 0")
        print(f"#5 {name}: B={B} P={P} din={din} f={f} {dtype}, {int(adj.sum())} edges, "
              f"{int(empty.sum())} rows without an edge: max abs err {err:.3e}")
        if not time_it:
            return
        ms, plain_ms = in_turns(
            benchmark, lambda: flash_mask.flash_layer_dot_fwd_plain(*args, scale=f ** -0.5),
            lambda: flash_mask.flash_layer_dot_fwd(*args, scale=f ** -0.5))
        x2 = x.reshape(B * P, din)
        w_cat = torch.cat([t.permute(0, 2, 1).reshape(f, din) for t in (wq, wk, wv)])
        b_cat = torch.cat([t.reshape(f) for t in (bq, bk, bv)]).to(dtype)
        mask = adj[:, None].bool()

        def composition():
            q, k, v = (t.reshape(B, P, 1, f).transpose(1, 2)
                       for t in F.linear(x2, w_cat, b_cat).split(f, dim=1))
            return F.scaled_dot_product_attention(q * f ** -0.5, k, v, attn_mask=mask, scale=1.0)

        lib_ms = benchmark(composition)[1]
        item, peak = (4, TF32X3_FLOPS) if fp32 else (2, BF16_FLOPS)
        bound_ms, bound_by = bound(*layer_work("dot", B, P, din, 1, f, int(adj.sum()), item),
                                   peak)
        print(f"  #5 {name} ({smi}): {ms:.4f} ms (plain {plain_ms:.4f}, F.linear + SDPA "
              f"{lib_ms:.4f}, bound {bound_ms:.4f} {bound_by}; peak {peak_name(peak)})")

    def layer_add_case(name, adj, din, f, dtype, seed, time_it=False, vs_flash=False):
        """#6 on one adjacency against its plain version, with and without
        dropout: rows without an edge exactly 0.  When asked, timed in turns
        beside its plain version, its bound and the F.linear + SDPA
        composition; ``vs_flash`` also times a bf16 GATConv through
        flash_fused (one #6) and through the flash route (F.linear, the
        score contractions and kernel #2), the readings behind
        GAT_FUSED_MAX_P in models/conv.py."""
        B, P, _ = adj.shape
        x, (w, _, _), (b, al, ar), _ = layer_inputs(seed, B, 1, P, din, f, dtype)
        args = (x, w, b, al, ar, adj)
        fp32 = dtype == torch.float32
        empty = adj.sum(-1) == 0
        errs = {}
        for rate in DROP_RATES:
            kw = dict(slope=0.2, seed=DROP_SEED, rate=rate)
            out = flash_mask.flash_layer_add_fwd(*args, **kw)
            torch.cuda.synchronize()
            want = flash_mask.flash_layer_add_fwd_plain(*args, **kw)
            errs[rate] = max_err(out, want, FP32_TOL if fp32 else BF16_TOL)
            if out.shape != (B, P, 1, f) or not bool((out[empty] == 0).all()):
                raise AssertionError(f"#6 {name} rate {rate}: shape {tuple(out.shape)}, or a "
                                     f"row without an edge is not 0")
        print(f"#6 {name}: B={B} P={P} din={din} f={f} {dtype}, {int(adj.sum())} edges, "
              f"{int(empty.sum())} rows without an edge: max abs err {errs[0.0]:.3e}, with "
              f"dropout {errs[0.4]:.3e}" + kept(adj, 1, 0.4))
        if not time_it:
            return
        ms, plain_ms = in_turns(benchmark, lambda: flash_mask.flash_layer_add_fwd_plain(*args),
                                lambda: flash_mask.flash_layer_add_fwd(*args))
        lib_ms = benchmark(add_composition(*args))[1]
        item, peak = (4, TF32X3_FLOPS) if fp32 else (2, BF16_FLOPS)
        bound_ms, bound_by = bound(*layer_work("add", B, P, din, 1, f, int(adj.sum()), item),
                                   peak)
        print(f"  #6 {name} ({smi}): {ms:.4f} ms (plain {plain_ms:.4f}, F.linear + SDPA "
              f"{lib_ms:.4f}, bound {bound_ms:.4f} {bound_by}; peak {peak_name(peak)})")
        if not vs_flash:
            return
        conv = make_conv("gat", din, f, 1, dtype=dtype,
                         generator=torch.Generator().manual_seed(seed))
        batch = DenseBatch(adj=adj, node_mask=adj.any(-1), n_graphs=B, np_pad=P)
        x2 = x.reshape(B * P, din)
        with torch.inference_mode():
            flash_mask.reset_launch_counts()
            fused = conv(batch, x2, impl="flash_fused")
            torch.cuda.synchronize()
            if flash_mask.launch_counts() != (0, 0, 0, 0, 0, 1):
                raise AssertionError(f"#6 {name}: flash_fused launched "
                                     f"{flash_mask.launch_counts()}, expected one #6")
            rel = float((fused.float() - conv(batch, x2, impl="flash").float()).abs().max()
                        / fused.float().abs().max())
            if not rel < BF16_REL:
                raise AssertionError(f"#6 {name}: flash_fused vs flash {rel}")
            fused_ms, flash_ms = in_turns(benchmark, lambda: conv(batch, x2, impl="flash"),
                                          lambda: conv(batch, x2, impl="flash_fused"),
                                          names=("flash", "flash_fused"))
        print(f"  GAT_FUSED_MAX_P reading: GATConv {dtype} forward at P={P} ({smi}): "
              f"flash_fused {fused_ms:.4f} ms, flash {flash_ms:.4f} ms (flash_fused / flash "
              f"{fused_ms / flash_ms:.3f}; max |diff| / max {rel:.3e})")

    def keep_mask_case(B, P, seed):
        """#6's keep mask bitwise: with x = W = I (din = f = P) and b = 0, z
        is one-hot per node, so out[r, c] = p[r, c] * keep[r, c], nonzero
        exactly where an edge is kept."""
        adj = inputs(seed, B, 1, P, 8, False, torch.float32)[3]
        eye = torch.eye(P, device="cuda")
        x, w = eye.expand(B, P, P).contiguous(), eye[None].contiguous()
        vec = torch.full((1, P), 0.1, device="cuda")
        out = flash_mask.flash_layer_add_fwd(x, w, torch.zeros(1, P, device="cuda"), vec, vec,
                                             adj, seed=DROP_SEED, rate=0.4)
        keep = flash_mask.dropout_factor(DROP_SEED, 0.4, B, 1, P, adj.device)[:, 0] != 0
        if not torch.equal(out[:, :, 0] != 0, keep & adj.bool()):
            raise AssertionError("#6 keep mask differs from the hash's")
        print(f"#6 keep mask B={B} P={P}: equal to the hash's, bitwise" + kept(adj, 1, 0.4))

    p512_adj = inputs(62, 64, 1, 512, 8, False, torch.float32)[3]
    p2048_adj = inputs(63, 3, 1, 2048, 8, False, torch.float32)[3]
    p256_adj = inputs(64, 128, 1, 256, 8, False, torch.float32)[3]
    for dtype in (torch.float32, torch.bfloat16):
        layer_dot_case("ogbg-molhiv bs=1024 (the GT step's batch)", molhiv_adj, HIDDEN, HIDDEN,
                       dtype, 80, time_it=True)
        layer_dot_case("P=512 (the COCO-SP-like size)", p512_adj, HIDDEN, HIDDEN, dtype, 81,
                       time_it=True)
        layer_dot_case("table adjacency, off-grid head dim", table_adj, HIDDEN, 75, dtype, 82)
        layer_add_case("ogbg-molhiv bs=1024 (the GT step's batch)", molhiv_adj, HIDDEN, HIDDEN,
                       dtype, 90, time_it=True)
        layer_add_case("P=512 (the COCO-SP-like size)", p512_adj, HIDDEN, HIDDEN, dtype, 91,
                       time_it=True, vs_flash=dtype == torch.bfloat16)
        layer_add_case("table adjacency, off-grid head dim", table_adj, HIDDEN, 75, dtype, 92)
    layer_dot_case("P=2048 at f=256, three graphs", p2048_adj, HIDDEN, 256, torch.bfloat16, 83)
    layer_dot_case("table shape, every fourth graph empty", holes, HIDDEN, HIDDEN,
                   torch.float32, 84, time_it=True)
    layer_dot_case("P=300, an odd din", p300_adj, 37, 64, torch.float32, 85)
    layer_add_case("P=2048 at f=256, three graphs", p2048_adj, HIDDEN, 256, torch.bfloat16, 93)
    layer_add_case("table shape, every fourth graph empty", holes, HIDDEN, HIDDEN,
                   torch.float32, 94, time_it=True)
    layer_add_case("P=300, an odd din", p300_adj, 37, 75, torch.float32, 95)
    layer_add_case("P=256", p256_adj, HIDDEN, HIDDEN, torch.bfloat16, 96, time_it=True,
                   vs_flash=True)
    keep_mask_case(64, 128, 97)
    del molhiv_adj, table_adj, holes, p300_adj, p512_adj, p2048_adj, p256_adj
    phase_done("10b kernels #5 and #6")

    # 11. GAT serving: the test_batch_graph twin at the reference's fig-1 setting
    flash_mask.reset_launch_counts()
    t0 = time.perf_counter()
    serve = test_batch_graph.main(GAT_SERVE_ARGS)
    torch.cuda.synchronize()
    seen = flash_mask.launch_counts()
    for fmt in ("dense", "flash"):
        if serve[fmt]["ok"] is not True:
            raise AssertionError(f"GAT serving: format {fmt} does not match the oracle")
    if serve["flash"]["launches"] != [0, 0, 1, 0, 0, 0]:
        raise AssertionError(f"GAT serving: launches of #1, #3, #2, #4, #5, #6 in one flash "
                             f"forward {serve['flash']['launches']}, expected [0, 0, 1, 0, 0, 0]")
    if seen[:2] != (0, 0) or seen[3:] != (0, 0, 0):
        raise AssertionError(f"GAT serving launched #1, #3, #4, #5 or #6: {seen}")
    print(f"GAT serving twin ({' '.join(GAT_SERVE_ARGS)}) in {time.perf_counter() - t0:.2f} s "
          f"(host clock): every format matches the oracle; 1 kernel #2 launch per flash "
          f"forward, {seen[2]} in the run, none of the others; Model forward per bs=1024 batch "
          f"({smi}): " + ", ".join(f"{fmt} {r['ms']:.4f} ms ({r['edges_per_s']:.4e} edges/s)"
                                   for fmt, r in serve.items()))

    phase_done("11 GAT serving twin")

    # 12. GAT training: the train_parity twin, FullGraphNet(gat), hidden 64, 2 layers
    flash_mask.reset_launch_counts()
    t0 = time.perf_counter()
    parity_both = train_parity.main(["--conv", "gat", "--steps", str(PARITY_STEPS)])
    torch.cuda.synchronize()
    seen = flash_mask.launch_counts()
    parity, parity_full = parity_both["batched"], parity_both["full"]
    steps = parity["fused_steps"]
    if len(steps) != PARITY_STEPS:
        raise AssertionError(f"{len(steps)} parity steps, expected {PARITY_STEPS}")
    for n, st in enumerate(steps):
        got = (st["fwd_launches"], st["bwd_launches"], st["layer_launches"])
        if got != (GAT_LAYERS, GAT_LAYERS, 0):
            raise AssertionError(f"parity step {n}: forward, backward and whole-layer launches "
                                 f"{got}, expected ({GAT_LAYERS}, {GAT_LAYERS}, 0)")
        if not math.isfinite(st["loss"]):
            raise AssertionError(f"parity step {n}: loss {st['loss']}")
    want = (0, 0, PARITY_STEPS * GAT_LAYERS + GAT_LAYERS, PARITY_STEPS * GAT_LAYERS, 0, 0)
    if seen != want:
        raise AssertionError(f"parity run launched #1, #3, #2, #4 {seen} times, expected {want}")
    base = parity["majority_baseline"]
    for side in ("acc_fused", "acc_unfused"):
        if not parity[side] > base + 0.1:
            raise AssertionError(f"parity {side} {parity[side]} not above the majority "
                                 f"baseline {base} + 0.1")
    if not parity["gap"] <= PARITY_GAP_BAR:
        raise AssertionError(f"parity gap {parity['gap']} above {PARITY_GAP_BAR}")
    # the twin's full-graph half (hidden 64, 200 steps at lr 1e-2) is read, not
    # held to the bar: its two trajectories agree to 1e-6 for the first steps,
    # then Adam's loss spikes make the last step's accuracy chaotic on both
    # sides (PERF.md section 6); phase 19 holds run_parity_full at the JAX defaults
    if not parity_full["acc_fused"] > parity_full["majority_baseline"] + 0.1:
        raise AssertionError(f"full-graph GAT parity: fused accuracy {parity_full['acc_fused']}")
    print(f"GAT training twin (train_parity --conv gat, {PARITY_STEPS} Adam steps each side) in "
          f"{time.perf_counter() - t0:.2f} s (host clock): {GAT_LAYERS} + {GAT_LAYERS} add-kernel "
          f"launches every fused step, {seen[2]} forward (training and the accuracy pass) and "
          f"{seen[3]} backward in the run; accuracy fused {parity['acc_fused']:.4f}, oracle "
          f"{parity['acc_unfused']:.4f}, gap {parity['gap']:.4f} (bar {PARITY_GAP_BAR}), "
          f"majority baseline {base:.4f}; its full-graph half (bucket path, SBM n=2000, no "
          f"flash kernel; a reading): accuracy fused {parity_full['acc_fused']:.4f}, oracle "
          f"{parity_full['acc_unfused']:.4f}, gap {parity_full['gap']:.4f}")
    add_fwd_rec["launches"], add_bwd_rec["launches"] = seen[2], seen[3]
    phase_done("12 GAT training twin")

    # 13. a GAT Adam step's time and peak memory: FullGraphNet(gat) on a bs=1024
    #     PATTERN-like batch with noisy one-hot features
    rng = np.random.default_rng(7)
    graphs = pattern_like_batch(rng, BATCH)
    gbatch = DenseBatch.from_graph_list([(r, c, n) for r, c, n, _ in graphs], np_pad=NP_PAD)
    xg = np.zeros((BATCH * NP_PAD, 2), dtype=np.float32)
    yg = np.zeros(BATCH * NP_PAD, dtype=np.int64)
    for b, (_, _, n, block) in enumerate(graphs):
        xg[b * NP_PAD: b * NP_PAD + n] = _noisy_onehot(rng, block, 2)
        yg[b * NP_PAD: b * NP_PAD + n] = block
    xg, yg = torch.from_numpy(xg).cuda(), torch.from_numpy(yg).cuda()
    mg = gbatch.node_mask.reshape(-1).float()
    gat = FullGraphNet("gat", num_classes=2, hidden_size=GAT_HIDDEN, num_layers=GAT_LAYERS,
                       in_size=2, generator=torch.Generator().manual_seed(5))
    gstate = TrainState.create(gat, lr=1e-2)
    gloss = make_loss_fn(gat, "node_classification", 2)
    gsteps = {"auto": lambda: train_step(gstate, gloss, gbatch, xg, yg, mg),
              "dense": lambda: train_step(gstate, lambda *a: gloss(*a, impl="dense"),
                                          gbatch, xg, yg, mg)}
    flash_mask.reset_launch_counts()
    gsteps["auto"]()
    torch.cuda.synchronize()
    seen = flash_mask.launch_counts()
    if seen != (0, 0, GAT_LAYERS, GAT_LAYERS, 0, 0):
        raise AssertionError(f"GAT auto step launched #1, #3, #2, #4, #5, #6 {seen}")
    gat_auto, gat_dense = in_turns(benchmark, gsteps["dense"], gsteps["auto"],
                                   names=("dense", "auto"))
    gpeaks = {name: step_peak_mib(fn) for name, fn in gsteps.items()}
    print(f"GAT train step (FullGraphNet gat, hidden {GAT_HIDDEN}, {GAT_LAYERS} layers, forward + "
          f"backward + Adam) per bs={BATCH} PATTERN-like batch, {gbatch.n_edges} edges ({smi}): "
          f"auto {gat_auto:.4f} ms, dense {gat_dense:.4f} ms; peak device memory allocated "
          f"during one step above its start ({gpeaks['dense'][1]:.1f} MiB at the last step's "
          f"start): auto {gpeaks['auto'][0]:.1f} MiB, dense {gpeaks['dense'][0]:.1f} MiB")
    # the step's device time by kernel group (#2 and #4 among them; #6, #2 and
    # #4 through flash_fused): host-bound steps are read here, not by their
    # host-clock wall time
    profile_train_step.main(["--model", "gat"])
    profile_train_step.main(["--model", "gat", "--impl", "flash_fused"])
    phase_done("13 GAT train step time")

    # 14. GAT serving at the fig-1 setting (Model("PATTERN", "gat", 128), bs=1024)
    #     through the whole-layer kernel #6, and GATConv's bf16 auto route
    rng = np.random.default_rng(8)
    sbatch = DenseBatch.from_graph_list(
        [(r, c, n) for r, c, n, _ in pattern_like_batch(rng, BATCH)], np_pad=NP_PAD)
    sx = torch.from_numpy(rng.integers(0, 3, size=(BATCH * NP_PAD,))).cuda()
    gmodel = Model("PATTERN", "gat", HIDDEN, generator=torch.Generator().manual_seed(6)).eval()
    conv16 = make_conv("gat", HIDDEN, HIDDEN, 1, dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(6))
    conv16.load_state_dict(gmodel.conv.state_dict())
    with torch.inference_mode():
        flash_mask.reset_launch_counts()
        fused_out = gmodel(sbatch, sx, impl="flash_fused")
        torch.cuda.synchronize()
        seen_fused = flash_mask.launch_counts()
        flash_mask.reset_launch_counts()
        out16 = conv16(sbatch, gmodel.inproj(sx))
        torch.cuda.synchronize()
        seen16 = flash_mask.launch_counts()
        for name, seen in (("flash_fused", seen_fused), ("bf16 auto", seen16)):
            if seen != (0, 0, 0, 0, 0, 1):
                raise AssertionError(f"GAT {name} forward launched #1, #3, #2, #4, #5, #6 "
                                     f"{seen}, expected one #6")
        e = max_err(fused_out, gmodel(sbatch, sx, impl="flash"), MODEL_TOL)
        if out16.dtype != torch.bfloat16 or fused_out.shape != (BATCH * NP_PAD, HIDDEN):
            raise AssertionError(f"GAT outputs {out16.dtype}, {tuple(fused_out.shape)}")
        rel16 = float((out16.float() - fused_out).abs().max() / fused_out.abs().max())
        if not rel16 < BF16_REL:
            raise AssertionError(f"bf16 GAT vs fp32: max |diff| / max |fp32| {rel16}")
        fused_ms, flash_ms = in_turns(benchmark, lambda: gmodel(sbatch, sx, impl="flash"),
                                      lambda: gmodel(sbatch, sx, impl="flash_fused"),
                                      names=("flash", "flash_fused"))
        gdense_ms = benchmark(lambda: gmodel(sbatch, sx, impl="dense"))[1]
        bf16_ms = benchmark(lambda: conv16(sbatch, gmodel.inproj(sx)))[1]
    edges = sbatch.n_edges
    print(f"GAT serving at fig-1 (Model PATTERN gat dim {HIDDEN}, bs={BATCH}, {edges} edges): "
          f"one #6 launch per flash_fused forward and per bf16 auto forward, none of the others; "
          f"flash_fused vs flash max abs err {e:.3e} (tol {MODEL_TOL}); bf16 auto vs fp32 "
          f"max |diff| / max |fp32| {rel16:.3e} (bar {BF16_REL}); forward ({smi}): flash_fused "
          f"{fused_ms:.4f} ms ({edges / fused_ms * 1e3:.4e} edges/s), flash {flash_ms:.4f} ms, "
          f"dense {gdense_ms:.4f} ms, bf16 auto {bf16_ms:.4f} ms")
    del gmodel, conv16, sbatch, sx, fused_out, out16
    phase_done("14 GAT fig-1 serving through #6 and bf16")

    # 15. GAT bf16 training: the parity harness in bf16 (the fused side through
    #     its auto route, kernel #6; the oracle fp32), at the twin's size
    flash_mask.reset_launch_counts()
    parity16 = run_parity_batched(seed=0, n_graphs=32, hidden=GAT_HIDDEN, layers=GAT_LAYERS,
                                  steps=PARITY_STEPS, conv="gat", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    seen = flash_mask.launch_counts()
    for n, st in enumerate(parity16["fused_steps"]):
        got = (st["fwd_launches"], st["bwd_launches"], st["layer_launches"])
        if got != (GAT_LAYERS,) * 3:
            raise AssertionError(f"bf16 parity step {n}: #2, #4 and #6 launches {got}, "
                                 f"expected {(GAT_LAYERS,) * 3}")
        if not math.isfinite(st["loss"]):
            raise AssertionError(f"bf16 parity step {n}: loss {st['loss']}")
    n_steps = PARITY_STEPS * GAT_LAYERS
    want = (0, 0, n_steps, n_steps, 0, n_steps + GAT_LAYERS)
    if seen != want:
        raise AssertionError(f"bf16 parity launched #1, #3, #2, #4, #5, #6 {seen}, expected {want}")
    base = parity16["majority_baseline"]
    for side in ("acc_fused", "acc_unfused"):
        if not parity16[side] > base + 0.1:
            raise AssertionError(f"bf16 parity {side} {parity16[side]} not above the majority "
                                 f"baseline {base} + 0.1")
    if not parity16["gap"] <= PARITY_BF16_GAP:
        raise AssertionError(f"bf16 parity gap {parity16['gap']} above {PARITY_BF16_GAP}")
    print(f"GAT bf16 parity ({PARITY_STEPS} Adam steps a side, hidden {GAT_HIDDEN}, "
          f"{GAT_LAYERS} layers, 32 graphs): 2 #6 + 2 #2 + 2 #4 launches every fused step, "
          f"{seen} in the run; accuracy bf16 fused {parity16['acc_fused']:.4f}, fp32 oracle "
          f"{parity16['acc_unfused']:.4f}, gap {parity16['gap']:.4f} (bar {PARITY_BF16_GAP}), "
          f"majority baseline {base:.4f}")
    layer_add_rec["launches"] = seen[5]

    gat16 = FullGraphNet("gat", num_classes=2, hidden_size=GAT_HIDDEN, num_layers=GAT_LAYERS,
                         dtype=torch.bfloat16, in_size=2,
                         generator=torch.Generator().manual_seed(5))
    gat16.load_state_dict(gat.state_dict())
    gstate16 = TrainState.create(gat16, lr=1e-2)
    gloss16 = make_loss_fn(gat16, "node_classification", 2)
    step16 = lambda: train_step(gstate16, gloss16, gbatch, xg, yg, mg)
    flash_mask.reset_launch_counts()
    step16()
    torch.cuda.synchronize()
    seen = flash_mask.launch_counts()
    if seen != (0, 0, GAT_LAYERS, GAT_LAYERS, 0, GAT_LAYERS):
        raise AssertionError(f"bf16 GAT step launched #1, #3, #2, #4, #5, #6 {seen}")
    gat_bf16, gat_fp32 = in_turns(benchmark, gsteps["auto"], step16,
                                  names=("fp32 auto", "bf16 auto"))
    peak16 = step_peak_mib(step16)
    print(f"bf16 GAT train step (FullGraphNet gat, dtype bf16, auto: #6 forward, #2 and #4 "
          f"backward) per bs={BATCH} PATTERN-like batch ({smi}): {gat_bf16:.4f} ms, fp32 auto "
          f"{gat_fp32:.4f} ms; peak device memory allocated during one step above its start "
          f"{peak16[0]:.1f} MiB ({peak16[1]:.1f} MiB at its start)")
    del gat, gat16, gstate, gstate16, gsteps
    phase_done("15 GAT bf16 training")

    # 16. the shmoo twin at three points of its grid (the full grid is
    #     `python -m dfgnn_tpu_torch.scripts.shmoo`); default_ok is a reading
    shmoo.shmoo(list(shmoo.IMPLS), dims=SHMOO_DIMS, batch_sizes=SHMOO_BATCHES,
                log=lambda line: print(line, flush=True))
    print(f"shmoo ({smi}): bf16 layer forward ms per impl, fp32 flash beside; 'auto' is the "
          f"port's bf16 route, and DEFAULT MISMATCH marks a point where it is more than 8% "
          f"behind the winner (a reading; nothing here asserts it)")
    phase_done("16 shmoo points")

    # 17. kernels #7 and #8 against their plain versions: a copy, so exactly equal
    gather_rec = {"name": "gather_rows", "route": "cuda",
                  "source": "dfgnn_tpu_torch/csrc/gather_rows.cu",
                  "replaces": "scripts/microbench_gather.py:62"}
    take_rec = {"name": "take_rows", "route": "cuda",
                "source": "dfgnn_tpu_torch/csrc/gather_rows.cu",
                "replaces": "scripts/microbench_gather.py:107"}
    gen = torch.Generator(device="cuda").manual_seed(17)
    for i, (N, shape, dtype, M, chunk, la) in enumerate(GATHER_SHAPES):
        tbl = torch.randn((N, *shape), device="cuda", generator=gen).to(dtype)
        idx = torch.randint(0, N, (M,), device="cuda", generator=gen, dtype=torch.int32)
        out = gather.gather_rows(tbl, idx, chunk=chunk, lookahead=la)
        torch.cuda.synchronize()
        want = gather.gather_rows_plain(tbl, idx)
        err = float((out.float() - want.float()).abs().max())
        if not torch.equal(out, want):
            raise AssertionError(f"gather_rows differs from index_select: max err {err}")
        print(f"#7 gather_rows vs plain: table {N} x {shape} {dtype}, {M} rows, chunk {chunk}, "
              f"lookahead {la}: equal (max abs err {err})")
        if i > 0:
            continue
        row_bytes = tbl[0].numel() * tbl.element_size()
        ms, plain_ms = in_turns(benchmark, lambda: gather.gather_rows_plain(tbl, idx),
                                lambda: gather.gather_rows(tbl, idx, chunk=chunk, lookahead=la))
        lib_ms = benchmark(lambda: torch.index_select(tbl, 0, idx))[1]
        nbytes = 2 * M * row_bytes + M * 4  # rows read and written, ids read
        bound_ms, bound_by = bound(0, nbytes)
        gather_rec.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        print(f"  at the probe's shape ({smi}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.index_select {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes / 1e9:.3f} GB)")
    tbl = torch.randn((1 << 18, 128), device="cuda", generator=gen)
    for S in TAKE_SLABS:
        slab = tbl[:S].contiguous()
        idx = torch.randint(-100, S + 100, (1 << 20,), device="cuda", generator=gen,
                            dtype=torch.int32)  # ids outside [0, S) on both sides
        out = gather.take_rows(slab, idx)
        torch.cuda.synchronize()
        want = gather.take_rows_plain(slab, idx)
        err = float((out - want).abs().max())
        if not torch.equal(out, want):
            raise AssertionError(f"take_rows differs from its plain version: max err {err}")
        ms, plain_ms = in_turns(benchmark, lambda: gather.take_rows_plain(slab, idx),
                                lambda: gather.take_rows(slab, idx))
        clipped = gather.take_ids(idx, S)
        lib_ms = benchmark(lambda: torch.index_select(slab, 0, clipped))[1]
        nbytes = idx.numel() * (4 + 512) + S * 512  # ids and the slab read, rows written
        bound_ms, bound_by = bound(0, nbytes)
        lanes, rows = gather.take_plan(S, 512)
        print(f"#8 take_rows vs plain: slab {S} x 128 fp32, 2**20 ids in [-100, {S + 100}): "
              f"equal; plan: {rows} row(s) of {lanes} lanes a warp instruction; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.index_select of the clipped ids "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) ({smi})")
        if S == TAKE_MAIN:
            take_rec.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
    del tbl, slab, idx, out, want, clipped
    phase_done("17 kernels #7 and #8")

    def no_kernel_launches(what):
        """The bucket path is torch ops: no hand-written kernel may launch."""
        seen = flash_mask.launch_counts() + gather.launch_counts()
        if any(seen):
            raise AssertionError(f"{what} launched #1, #3, #2, #4, #5, #6, #7, #8 {seen}")

    # 18. full-graph serving: the test_full_graph twin on the reddit stand-in
    for conv in ("gt", "gat"):
        flash_mask.reset_launch_counts()
        gather.reset_launch_counts()
        t0 = time.perf_counter()
        full = test_full_graph.main(FULL_SERVE_ARGS + ["--conv", conv])
        torch.cuda.synchronize()
        no_kernel_launches(f"full-graph {conv} serving")
        if full["bucket"]["ok"] is not True:
            raise AssertionError(f"full-graph {conv}: the bucket path does not match the oracle")
        print(f"full-graph {conv} serving twin ({' '.join(FULL_SERVE_ARGS)}) in "
              f"{time.perf_counter() - t0:.2f} s (host clock, data set-up included): "
              f"correctness vs oracle: OK; layer forward ({smi}): " + ", ".join(
                  f"{fmt} {r['ms']:.4f} ms on {r['n_edges']} edges ({r['edges_per_s']:.4e} "
                  f"edges/s, peak {r['peak_mib']:.1f} MiB)" for fmt, r in full.items()))
        phase_done(f"18 full-graph {conv} serving")

    # 18 (continued). the reading behind build_buckets' auto layout: the GT
    #    layer on the flat layout and on the source-blocked one
    ds = load_full_graph("reddit", quiet=True)
    g = Graph.from_coo(ds.rows, ds.cols, ds.n_nodes)
    x = torch.from_numpy(ds.features[:, :HIDDEN].astype(np.float32)).cuda()
    layer = make_conv("gt", HIDDEN, HIDDEN, 1, generator=torch.Generator().manual_seed(0)).eval()
    flat = formats.build_buckets(g, src_block_rows=None)
    blocked = formats.build_buckets(g, src_block_rows=formats._SRC_BLOCK_ROWS)
    with torch.inference_mode():
        blocked_ms, flat_ms = in_turns(benchmark, lambda: layer(flat, x),
                                       lambda: layer(blocked, x), names=("flat", "blocked"))
        e = max_err(layer(blocked, x), layer(flat, x), MODEL_TOL)
    print(f"reddit stand-in GT layer, dim {HIDDEN} ({smi}): flat layout {flat_ms:.4f} ms "
          f"({flat.padded_edges} padded lanes), source-blocked by {formats._SRC_BLOCK_ROWS} rows "
          f"{blocked_ms:.4f} ms ({blocked.padded_edges} padded lanes, "
          f"{len(blocked.blocks)} blocks); outputs within {e:.3e}")
    del ds, g, x, flat, blocked
    phase_done("18 flat and blocked layouts")

    # 19. full-graph training: the train_gatconv twin, the custom backward
    #     against autograd through the oracle, and run_parity_full
    flash_mask.reset_launch_counts()
    gather.reset_launch_counts()
    t0 = time.perf_counter()
    trained = train_gatconv.main(FULL_TRAIN_ARGS)
    torch.cuda.synchronize()
    no_kernel_launches("GATNet training")
    losses = trained["losses"]
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"GATNet losses {losses}")
    print(f"GATNet twin ({' '.join(FULL_TRAIN_ARGS)}) in {time.perf_counter() - t0:.2f} s "
          f"(host clock): losses {[round(x, 5) for x in losses]}; train step "
          f"{trained['epoch_ms']:.2f} ms an epoch, inference {trained['infer_ms']:.2f} ms "
          f"(host clock around synchronised work), test accuracy {trained['acc']:.4f}, peak "
          f"device memory {trained['peak_mib']:.1f} MiB ({smi})")

    ds = load_full_graph("arxiv", quiet=True)
    sub = np.random.default_rng(19).choice(ds.n_edges, GRAD_SUB_EDGES, replace=False)
    g_sub = Graph.from_coo(ds.rows[sub], ds.cols[sub], ds.n_nodes)
    bg_sub = formats.build_buckets(g_sub, with_transpose=True)
    h, f, n = 4, 64, ds.n_nodes
    rng = np.random.default_rng(20)
    arr = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
    heads = torch.arange(h, device="cuda")[None, :]

    def oracle(score, a, b, v, seed, rate):
        """The segment-op oracle with the bucket path's hash dropout on its
        normalised weights."""
        s = (reference.sddmm_dot(g_sub, a, b) if score == "dot"
             else reference.sddmm_add(g_sub, a, b, 0.2))
        w = reference.edge_softmax(g_sub, s)
        if rate > 0.0:
            w = w * edge_dropout.keep_scale(seed, g_sub.rows[:, None], g_sub.cols[:, None],
                                            heads, rate)
        return reference.spmm(g_sub, w, v)

    for score in ("dot", "add"):
        ab = [arr(n, h, f), arr(n, h, f)] if score == "dot" else [arr(n, h), arr(n, h)]
        v, do = arr(n, h, f), arr(n, h, f)
        for rate in DROP_RATES:
            seed = edge_dropout.seed_from_generator(torch.Generator().manual_seed(DROP_SEED))
            ins = [t.clone().requires_grad_(True) for t in (*ab, v)]
            qk = (ins[0], ins[1]) if score == "dot" else (None, None)
            kw = {} if score == "dot" else dict(e_row=ins[0], e_col=ins[1])
            out = bucket.bucket_graph_attention(
                bg_sub, *qk, ins[2], score=score, dropout_rate=rate,
                dropout_generator=torch.Generator().manual_seed(DROP_SEED), **kw)
            if type(out.grad_fn).__name__ != "_BucketFusedBackward":
                raise AssertionError(f"the bucket path took {type(out.grad_fn).__name__}")
            got = torch.autograd.grad(out, ins, do)
            refs = [t.clone().requires_grad_(True) for t in (*ab, v)]
            want_out = oracle(score, *refs, seed, rate)
            want = torch.autograd.grad(want_out, refs, do)
            errs = [max_err(out.detach(), want_out.detach(), MODEL_TOL)] + [
                max_err(g_, w_, GRAD_TOL) for g_, w_ in zip(got, want)]
            print(f"custom backward vs autograd through the oracle, {score} score, arxiv "
                  f"stand-in {GRAD_SUB_EDGES}-edge subgraph, h={h} f={f}, dropout {rate}: max "
                  f"abs err out {errs[0]:.3e}, grads " + ", ".join(f"{e:.3e}" for e in errs[1:])
                  + f" (tol {GRAD_TOL})")
    del ds, g_sub, bg_sub

    flash_mask.reset_launch_counts()
    gather.reset_launch_counts()
    pf = run_parity_full(conv="gt")
    torch.cuda.synchronize()
    no_kernel_launches("full-graph parity")
    if not (pf["gap"] <= PARITY_GAP_BAR and pf["acc_fused"] > pf["majority_baseline"] + 0.1):
        raise AssertionError(f"run_parity_full: {pf}")
    print(f"run_parity_full (conv gt, the JAX defaults: SBM n=2000, 4 blocks, hidden 32, 2 "
          f"layers, 120 Adam steps): accuracy bucket {pf['acc_fused']:.4f}, oracle "
          f"{pf['acc_unfused']:.4f}, gap {pf['gap']:.4f} (bar {PARITY_GAP_BAR}), majority "
          f"baseline {pf['majority_baseline']:.4f}")
    phase_done("19 full-graph training")

    # 20. the gather probe twin, the path of kernels #7 and #8
    flash_mask.reset_launch_counts()
    gather.reset_launch_counts()
    probe = microbench_gather.main([])
    torch.cuda.synchronize()
    seen = gather.launch_counts()
    if min(seen) == 0 or any(flash_mask.launch_counts()):
        raise AssertionError(f"the gather probe launched #7, #8 {seen} and #1-#6 "
                             f"{flash_mask.launch_counts()}")
    gather_rec["launches"], take_rec["launches"] = seen
    print(f"gather probe twin: {len(probe)} rows; {seen[0]} #7 and {seen[1]} #8 launches "
          f"({smi})")
    phase_done("20 gather probe")

    # 21. sampled training: the train_sampled twin on the arxiv stand-in, and
    #     one batch's sampled_block_attention against the segment-op oracle
    flash_mask.reset_launch_counts()
    gather.reset_launch_counts()
    t0 = time.perf_counter()
    sampled = train_sampled.main(SAMPLED_ARGS)
    torch.cuda.synchronize()
    no_kernel_launches("sampled training")
    for key in ("losses", "full_losses"):
        if not (sampled[key] and all(map(math.isfinite, sampled[key]))):
            raise AssertionError(f"train_sampled {key}: {sampled[key]}")
    for key in ("acc_sampled", "acc_full"):
        if not 0.0 <= sampled[key] <= 1.0:
            raise AssertionError(f"train_sampled {key}: {sampled[key]}")
    print(f"train_sampled twin ({' '.join(SAMPLED_ARGS)}) in {time.perf_counter() - t0:.2f} s "
          f"(host clock), {sampled['steps']} steps: sampled {sampled['steps_per_s']:.4f} "
          f"steps/s, host sampling {sampled['sample_s_per_step']:.6f} s a step, device "
          f"{sampled['device_ms_per_step']:.4f} ms a step (CUDA events), peak "
          f"{sampled['peak_mib']:.1f} MiB, test accuracy {sampled['acc_sampled']:.4f}; full "
          f"graph {sampled['full_steps_per_s']:.4f} steps/s, peak "
          f"{sampled['full_peak_mib']:.1f} MiB, test accuracy {sampled['acc_full']:.4f}; "
          f"sampled-full gap {sampled['gap']:+.4f} ({smi})")

    ds = load_full_graph("arxiv", quiet=True)
    bs = SAMPLED_BATCH
    blocks, sup = NeighborSampler(Graph.from_coo(ds.rows, ds.cols, ds.n_nodes)).sample_localized(
        np.nonzero(ds.train_mask)[0][:bs], train_sampled.FANOUTS, seed=0,
        pad_to=[bs, bs * 9], support_pad=bs * 81)
    del ds
    rng = np.random.default_rng(21)
    arr = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
    h, f = 1, SAMPLED_DIM  # the twin's GTConv: one head of the hidden width
    flash_mask.reset_launch_counts()
    gather.reset_launch_counts()
    for li, blk in enumerate(blocks):
        blk = blk.to("cuda")
        b = blk.bg.buckets[0]
        s_pad = b.row_ids.shape[0]
        n_src = blocks[li + 1].bg.n_nodes if li + 1 < len(blocks) else sup.shape[0]
        # the oracle's edge list: the block's live (row, neighbour) lanes
        r_idx, w_idx = b.emask.nonzero(as_tuple=True)
        n = max(s_pad, n_src)
        g_live = Graph.from_coo(r_idx.cpu().numpy(), b.nbr[r_idx, w_idx].cpu().numpy(), n)
        pad = lambda t: torch.cat([t, t.new_zeros((n - t.shape[0], *t.shape[1:]))])
        q_tab, k, v, e_r, e_c = arr(n_src, h, f), arr(n_src, h, f), arr(n_src, h, f), \
            arr(n_src, h), arr(n_src, h)
        q_rows, er_rows = bucket._take(q_tab, blk.seeds), bucket._take(e_r, blk.seeds)
        errs = []
        for score in ("dot", "add"):
            if score == "dot":
                got = sampled_block_attention(blk, q_tab, k, v)
                want = reference.graph_attention_reference(g_live, pad(q_rows), pad(k), pad(v))
            else:
                got = sampled_block_attention(blk, None, None, v, score="add", e_row=e_r,
                                              e_col=e_c)
                want = reference.graph_attention_reference(
                    g_live, None, None, pad(v), score="add", e_row=pad(er_rows),
                    e_col=pad(e_c))
            if got.shape != (s_pad, h, f) or not torch.isfinite(got).all():
                raise AssertionError(f"block {li} {score}: {tuple(got.shape)}")
            errs.append(max_err(got, want[:s_pad], MODEL_TOL))
        print(f"sampled block {li} of the arxiv stand-in's first batch ({blk.n_seeds} seeds of "
              f"{s_pad}, {b.emask.sum().item()} live lanes of fanout {b.width}, {n_src} source "
              f"rows): sampled_block_attention vs the segment-op oracle on its live lanes, max "
              f"abs err dot {errs[0]:.3e}, add {errs[1]:.3e} (tol {MODEL_TOL})")
    torch.cuda.synchronize()
    no_kernel_launches("sampled-block attention")
    del blocks, sup, g_live
    prof = profile_train_step.main(["--model", "sampled"])
    torch.cuda.synchronize()
    no_kernel_launches("the sampled step's profile")
    print(f"sampled train step (one batch, no sampling): forward {prof['forward_ms']:.4f} ms, "
          f"backward {prof['backward_ms']:.4f}, Adam {prof['optimizer_ms']:.4f} (CUDA events); "
          f"idle share under the profiler {prof['idle_share_profiled']:.4f}")
    phase_done("21 sampled training")

    # 22. utilities and the timing twins: a traced GT serving forward, a
    #     checkpoint round trip, the two timing twins and the GraphWorld sweep
    gt = GTModel("PATTERN", out_size=2, hidden_size=HIDDEN, num_layers=LAYERS, num_heads=1,
                 generator=torch.Generator().manual_seed(0), device="cuda").eval()
    rng = np.random.default_rng(0)
    batch = DenseBatch.from_graph_list(
        [(r, c, n) for r, c, n, _ in pattern_like_batch(rng, BATCH)], np_pad=NP_PAD)
    x = torch.from_numpy(rng.integers(0, 3, size=(BATCH * NP_PAD,))).to("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        with torch.inference_mode():
            gt(batch, x)  # warm-up outside the trace
            with profile_region("gt_serving", log_dir=tmp) as path:
                with annotate("gt_serving_forward"):
                    gt(batch, x)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        names = {e.get("name") for e in events}
        if not {"gt_serving", "gt_serving_forward"} <= names:
            raise AssertionError(f"the trace {path} lacks the annotated ranges")
        n_kernels = sum(e.get("cat") == "kernel" for e in events)
        print(f"profile_region around one GT serving forward: {len(events)} trace events, "
              f"{n_kernels} of them device kernels, the annotate range present")

        state = TrainState.create(gt.train(), lr=1e-3, device="cuda")
        loss_fn = make_loss_fn(gt, "graph_classification", 2)
        y = torch.from_numpy(rng.integers(0, 2, BATCH)).cuda()
        train_step(state, loss_fn, batch, x, y, torch.ones(BATCH, device="cuda"))
        saved = {"model": gt.state_dict(), "opt": state.opt.state_dict()}
        save_checkpoint(tmp, saved, step=1)
        restored, step = restore_checkpoint(tmp, saved)

        def tensors(tree):
            if isinstance(tree, dict):
                return [t for key in sorted(tree, key=str) for t in tensors(tree[key])]
            return [tree] if isinstance(tree, torch.Tensor) else []

        want, got = tensors(saved), tensors(restored)
        if len(want) != len(got) or not all(a.device == b.device and torch.equal(a, b)
                                            for a, b in zip(want, got)):
            raise AssertionError("the checkpoint round trip changed a tensor")
        print(f"checkpoint round trip of a TrainState's state_dicts (GTModel, Adam) on the "
              f"card: step {step}, {len(want)} tensors bitwise equal")
    del gt, state, batch, x

    flash_mask.reset_launch_counts()
    gather.reset_launch_counts()
    bt = train_batch_graph_timing.main(BATCH_TIMING_ARGS)
    torch.cuda.synchronize()
    seen = flash_mask.launch_counts()
    n_layers = int(BATCH_TIMING_ARGS[BATCH_TIMING_ARGS.index("--n-layers") + 1])
    if not (bt["ok"] and bt["launches"] == [n_layers, n_layers, 0, 0, 0, 0]
            and min(seen[:2]) > 0 and not any(seen[2:]) and not any(gather.launch_counts())):
        raise AssertionError(f"batch timing twin: {bt}, launches #1, #3, #2, #4, #5, #6 {seen}")
    print(f"batch timing twin ({' '.join(BATCH_TIMING_ARGS)}; {smi}): preprocess "
          f"{bt['preprocess_ms']:.4f} ms a batch (host), forward {bt['forward_ms']:.4f}, "
          f"backward {bt['backward_ms']:.4f}, fw+bw {bt['fwbw_ms']:.4f} ms a batch; one "
          f"fw+bw {bt['launches'][0]} #1 and {bt['launches'][1]} #3 launches; the run "
          f"{seen[0]} #1 and {seen[1]} #3")

    flash_mask.reset_launch_counts()
    gather.reset_launch_counts()
    ft = train_full_graph_timing.main(FULL_TIMING_ARGS)
    torch.cuda.synchronize()
    no_kernel_launches("full-graph timing")
    if not ft["ok"]:
        raise AssertionError(f"full-graph timing twin: {ft}")
    for name in ("fused(bucket)", "unfused(oracle)"):
        r = ft[name]
        print(f"full timing twin ({' '.join(FULL_TIMING_ARGS)}; {smi}), {name}: forward "
              f"{r['forward_ms']:.4f} ms, backward {r['backward_ms']:.4f}, update "
              f"{r['update_ms']:.4f}, epoch {r['epoch_ms']:.4f}")

    flash_mask.reset_launch_counts()
    gather.reset_launch_counts()
    gw = test_gt_graphworld.main(GRAPHWORLD_ARGS)
    torch.cuda.synchronize()
    no_kernel_launches("GraphWorld sweep")
    if not all(r["ok"] for r in gw.values()):
        raise AssertionError(f"GraphWorld sweep: {gw}")
    print(f"GraphWorld twin ({' '.join(GRAPHWORLD_ARGS)}; {smi}): " + ", ".join(
        f"deg {d}: {r['ms']:.4f} ms ({r['edges_per_s']:.4e} edges/s)" for d, r in gw.items()))
    phase_done("22 utilities and timing twins")

    # 23. the ablation twin at the JAX script's defaults, and one Timer block
    flash_mask.reset_launch_counts()
    gather.reset_launch_counts()
    abl = ablation.main([])
    torch.cuda.synchronize()
    seen = flash_mask.launch_counts()
    rows = abl["batched"] + abl["full"]
    bad = [r["label"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"ablation rows that do not match their oracle: {bad}")
    by_impl = {r["impl"]: r["launches"] for r in abl["batched"]}
    only = lambda counts, i: counts[i] > 0 and not any(counts[:i] + counts[i + 1:])
    if not (only(by_impl["flash"], 0) and only(by_impl["flash_fused"], 4)
            and not any(by_impl["reference"] + by_impl["dense"])
            and not any(c for r in abl["full"] for c in r["launches"])
            and list(seen) == [a + b for a, b in zip(by_impl["flash"], by_impl["flash_fused"])]
            and not any(gather.launch_counts())):
        raise AssertionError(f"ablation launches #1, #3, #2, #4, #5, #6: rows {by_impl}, "
                             f"run {seen}, #7 and #8 {gather.launch_counts()}")
    for r in rows:
        pad = "" if r["pad"] is None else f", pad {r['pad']:.4f}x"
        print(f"ablation row {r['label']!r}: {r['ms']:.4f} ms, {r['edges_per_s']:.4e} edges/s "
              f"over {r['n_edges']} edges{pad}, peak {r['peak_mib']:.1f} MiB above its start, "
              f"correct=OK, launches #1, #3, #2, #4, #5, #6 {r['launches']} ({smi})")

    q, k, v, adj, _ = inputs(23, *MAIN_SHAPE, False, torch.float32)
    flash_mask.flash_mask_fwd(q, k, v, adj)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with Timer() as timer:
        start.record()
        for _ in range(10):
            flash_mask.flash_mask_fwd(q, k, v, adj)
        end.record()
    event_ms = start.elapsed_time(end)
    if not (end.query() and timer.elapsed_ms >= event_ms > 0):
        raise AssertionError(f"Timer {timer.elapsed_ms} ms against CUDA events {event_ms} ms")
    print(f"utils.Timer around 10 launches of #1 at {MAIN_SHAPE}: {timer.elapsed_ms / 10:.4f} ms "
          f"a launch (host clock, the card synchronised on exit) against CUDA events "
          f"{event_ms / 10:.4f} ms ({smi})")
    del q, k, v, adj
    phase_done("23 ablation")

    # 24. the edge-partitioned plan (item 10a): the bench_partition_build
    #     twin's rows on the reddit stand-in, then every shard's local forward
    #     of three 4-device plans, one shard at a time on this card, held
    #     against the unpartitioned bucket forward
    flash_mask.reset_launch_counts()
    gather.reset_launch_counts()
    ds = load_full_graph("reddit", quiet=True)
    g = Graph.from_coo(ds.rows, ds.cols, ds.n_nodes, device="cpu")
    del ds
    print(f"plan builds on the reddit stand-in (n={g.n_nodes}, e={g.n_edges}; host clock on "
          f"the card's machine, numpy):")
    for r in bench_partition_build.plan_rows(g, PLAN_DEVICES):
        print(f"plan P={r['devices']} halo={r['halo']}: build {r['build_s']} s, padded-edge "
              f"factor {r['pad']}, max_halo {r['max_halo']} (halo fraction {r['halo_frac']} "
              f"of n_local {r['n_local']})")
    gen = torch.Generator(device="cuda").manual_seed(24)
    q, k, v = (torch.randn((g.n_nodes, 1, HIDDEN), device="cuda", generator=gen)
               for _ in range(3))
    # the unpartitioned layout on the plan's bucket ladder and segment split:
    # each row then sums the same lanes in the same order as in its shard
    # (on build_buckets' default split of 64 the sums over the stand-in's
    # rows of thousands of edges round differently, up to 1.8e-5)
    full_bg = formats.build_buckets(g.to("cuda"), min_width=8, split_width=256, ladder="x1.5")
    for kw, rate in SHARD_PLANS:
        t0 = time.perf_counter()
        pg = partition_graph(g, SHARD_DEVICES, **kw)
        build_s = time.perf_counter() - t0
        seed = edge_dropout.seed_from_generator(torch.Generator().manual_seed(DROP_SEED))
        want = bucket.bucket_graph_attention(
            full_bg, q, k, v, dropout_rate=rate,
            dropout_generator=torch.Generator().manual_seed(DROP_SEED))
        qp, kp, vp = (x[pg.node_perm.cuda()] if pg.node_perm is not None else x
                      for x in (q, k, v))
        qp, kp, vp = (partition._pad_nodes(x, pg.n_local * SHARD_DEVICES) for x in (qp, kp, vp))
        L = pg.n_local
        local = lambda x, d: x[d * L: (d + 1) * L]
        if pg.halo is None:
            tables = [(kp, vp)] * SHARD_DEVICES
        else:  # the halo exchange's two local halves around the all-to-all
            sent = [(partition._halo_send_rows(pg, e, local(kp, e)),
                     partition._halo_send_rows(pg, e, local(vp, e)))
                    for e in range(SHARD_DEVICES)]
            tables = [tuple(partition._halo_source_table(
                pg, local(x, d), torch.stack([s_[i][d] for s_ in sent]))
                for i, x in enumerate((kp, vp))) for d in range(SHARD_DEVICES)]
        outs, lines = [], []
        for d, (tk, tv) in enumerate(tables):
            bg_d = partition._local_bg(pg, d, "cuda")
            drop_d = partition._local_drop(pg, d, seed, rate, "cuda")
            q_d = local(qp, d)
            shard_fn = lambda: bucket._forward_tabs(
                bg_d, q_d, None, bucket._make_tabs(tk, tv, None, "dot", None), torch.float32,
                HIDDEN, "dot", 0.2, 2048, drop=drop_d)[0]
            out_d, ms = benchmark(shard_fn)
            outs.append(out_d)
            real = sum(int(b.emask.sum()) for b in bg_d.buckets) + (
                0 if bg_d.segments is None else int(bg_d.segments.emask.sum()))
            lines.append(f"  shard {d}: {ms:.4f} ms, {bg_d.padded_edges} padded lanes, "
                         f"{real} edges, source table {tuple(tk.shape)}")
        got = torch.cat(outs)[: pg.n_nodes]
        if pg.node_rank is not None:
            got = got[pg.node_rank.cuda()]
        e = max_err(got, want, FP32_TOL)
        if rate:  # the masks agree: a mask off by one edge moves an output by O(1)
            undropped = bucket.bucket_graph_attention(full_bg, q, k, v)
            if float((got - undropped).abs().max()) < 0.1:
                raise AssertionError("the dropout plan's outputs do not show its mask")
        no_kernel_launches(f"the shard loop of plan {kw}")
        print(f"plan {kw} at P={SHARD_DEVICES}, GT dot score, dim {HIDDEN}, h=1, fp32, dropout "
              f"{rate} (built in {build_s} s, host): shard loop within {e:.3e} of the "
              f"unpartitioned bucket forward; each shard's local forward (one card running one "
              f"shard at a time, the exchange not included; CUDA events, mean of 10 after 3 "
              f"warmups; {smi}):")
        print("\n".join(lines))
        del pg, tables, outs, got, want
    del g, q, k, v, full_bg
    phase_done("24 edge-partitioned plan")

    # 25. the multi-GPU layer (item 10b)
    dist_phase(smi)
    phase_done("25 multi-GPU layer")

    # 26. head dims past 256 (#1 to #4) and the precision switch (#1 to #6)
    wide_phase(smi)
    phase_done("26 wide heads and precision")

    # 27. the whole-layer kernels #5 and #6 past head dim 256 (item f)
    wide_layer_phase(smi)
    phase_done("27 wide whole-layer kernels")

    # 28. graphs past P = 2048 (item e)
    large_graph_phase(smi)
    phase_done("28 graphs past P = 2048")

    records = [fwd_rec, bwd_rec, add_fwd_rec, add_bwd_rec, layer_rec, layer_add_rec,
               gather_rec, take_rec]
    for rec in records:  # redesigned for this card since the first port (PERF.md section 6)
        rec["redesigned"] = rec["name"] in ("flash_mask_fwd", "flash_mask_bwd", "flash_add_fwd",
                                            "flash_add_bwd", "flash_layer_dot_fwd",
                                            "flash_layer_add_fwd", "take_rows")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "redesigned")
    for rec in records:
        if set(rec) != set(keys):
            raise AssertionError(f"kernel record {rec['name']} lacks {set(keys) - set(rec)}")
    print(json.dumps({"kernels": [{key: rec[key] for key in keys} for rec in records]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
