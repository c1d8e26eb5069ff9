"""Ablation sweep: each optimisation layer's share, with PyTorch.

The twin of the JAX package's ``scripts/ablation.py`` (the reference's
``bash/ablation_test.sh``), on one dataset per half:

batched (PATTERN-like, ``np_pad`` 128):
  reference -> dense (masked attention) -> flash (kernel #1)
  -> flash_fused (whole layer, kernel #5)
full graph (the reddit stand-in at quarter scale):
  reference -> flat buckets, pow2 ladder, no segments -> build_buckets'
  default ladder -> + segments -> + source blocking -> + packed k||v gather

The batched rows share one GT conv, its parameters drawn once from a seeded
generator (the JAX script re-initialises from ``key(0)`` for every row, so
its rows share them too).  The five layouts take exactly the JAX script's
``build_buckets`` arguments; ``packed`` is off on all but the last.  As
there, the second layout's label names the x1.5 ladder while it takes
``build_buckets``' default ladder, which is pow2.

Each row is timed with CUDA events (3 warmups, then 10 timed runs; 3 for
the full-graph oracle) and held against its oracle with ``check_correct``
at rtol 1e-3: the batched rows on the sub-batch's nodes against
``impl="reference"`` on the sub-batch's Graph, the bucket rows against the
full-graph oracle (atol 1e-4: the oracle's segment sums and the bucket
walk's chunked sums order fp32 additions differently), and each oracle
against its own evaluation in fp64.  A row prints ``correct=OK`` or
``correct=FAIL``; the JAX script checks nothing.  TF32 is off.  It runs on
the card unless ``--device cpu`` is given; on the CPU it checks but does not
time.

    python -m dfgnn_tpu_torch.scripts.ablation [--dim 128] [--batch-size 1024] [--device cpu]
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from dfgnn_tpu_torch import formats
from dfgnn_tpu_torch.data.datasets import load_full_graph
from dfgnn_tpu_torch.data.synthetic import pattern_like_batch
from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.graph import DenseBatch, Graph
from dfgnn_tpu_torch.models import make_conv
from dfgnn_tpu_torch.ops import flash_mask
from dfgnn_tpu_torch.ops.bucket import bucket_graph_attention
from dfgnn_tpu_torch.ops.dispatch import graph_attention
from dfgnn_tpu_torch.utils.benchmark import benchmark, check_correct
from dfgnn_tpu_torch.utils.config import build_parser, parse_args

NP_PAD, SUB_GRAPHS = 128, 32
BATCHED = (  # (impl, label)
    ("reference", "reference (oracle, 32-graph sub-batch)"),
    ("dense", "dense (masked attention, torch ops)"),
    ("flash", "flash (CUDA kernel #1)"),
    ("flash_fused", "flash_fused (QKV proj + attention, #5)"),
)
FULL_SCALE = 0.25
LAYOUTS = (  # (label, build_buckets arguments, packed)
    ("flat pow2 buckets, no segments",
     dict(widths=[8 << i for i in range(11)], split_width=None, src_block_rows=None), False),
    ("+ x1.5 width ladder", dict(split_width=None, src_block_rows=None), False),
    ("+ segment split of super-wide rows", dict(src_block_rows=None), False),
    ("+ source blocking (forced)", dict(src_block_rows=32768), False),
    ("+ packed k||v single gather per edge", dict(src_block_rows=32768), True),
)
FULL_ATOL = 1e-4


def _run_row(label, fn, n_edges, dev, iters, check, pad=None):
    """Times ``fn`` on the card (CUDA events) or calls it once on the CPU,
    holds its last output to ``check``, and prints the JAX script's line with
    the peak above the row's start and the check beside it.  Returns the
    row (``launches`` counts #1, #3, #2, #4, #5, #6 over the whole row) and
    the last output."""
    res = {"label": label, "n_edges": int(n_edges), "ms": None, "edges_per_s": None,
           "peak_mib": None, "pad": pad}
    before = flash_mask.launch_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.memory_allocated(dev)
        out, res["ms"] = benchmark(fn, iters=iters)
        torch.cuda.synchronize(dev)
        res["peak_mib"] = (torch.cuda.max_memory_allocated(dev) - start) / 2 ** 20
        res["edges_per_s"] = n_edges / (res["ms"] / 1e3)
    else:
        out = fn()
    res["ok"] = bool(check(out))
    res["launches"] = [a - b for a, b in zip(flash_mask.launch_counts(), before)]
    if res["ms"] is None:
        line = f"  {label:44s} time not measured (no CUDA device)"
    else:
        line = f"  {label:44s} {res['ms']:8.3f} ms  {res['edges_per_s']:.3e} edges/s"
    if pad is not None:
        line += f"  (pad {pad:.2f}x)"
    if res["peak_mib"] is not None:
        line += f"  peak {res['peak_mib']:.1f} MiB"
    print(line + f"  correct={'OK' if res['ok'] else 'FAIL'}", flush=True)
    return res, out


def batched_rows(batch_size: int, dim: int, heads: int, *, rng, device="cuda",
                 iters: int = 10) -> list:
    """The batched half: a PATTERN-like batch of ``batch_size`` graphs drawn
    from ``rng``, then features from ``rng``; one row per impl of
    :data:`BATCHED` (see :func:`_run_row`), each with its ``impl`` and its
    output on the sub-batch's nodes (``out``, fp32 numpy)."""
    dev = resolve_device(device)
    graphs = [(r, c, n) for r, c, n, _ in pattern_like_batch(rng, batch_size)]
    batch = DenseBatch.from_graph_list(graphs, np_pad=NP_PAD, device=dev)
    x = torch.from_numpy(rng.standard_normal(
        (batch.n_graphs * batch.np_pad, dim)).astype(np.float32)).to(dev)
    g_sub = DenseBatch.from_graph_list(graphs[:SUB_GRAPHS], np_pad=NP_PAD,
                                       device=dev).to_graph()
    n_sub = g_sub.n_nodes
    layer = make_conv("gt", dim, dim, heads, generator=torch.Generator().manual_seed(0),
                      device=dev).eval()
    with torch.inference_mode():
        want = layer(g_sub, x[:n_sub], impl="reference")
        exact = copy.deepcopy(layer).double()(g_sub, x[:n_sub].double(), impl="reference")
        rows = []
        for impl, label in BATCHED:
            if impl == "reference":
                gg, xx, n_e, ref = g_sub, x[:n_sub], g_sub.n_edges, exact
            else:
                gg, xx, n_e, ref = batch, x, batch.n_edges, want
            check = lambda out, ref=ref: check_correct(out[:n_sub].double().cpu().numpy(),
                                                       ref.cpu().numpy())
            row, out = _run_row(label, lambda gg=gg, xx=xx, impl=impl: layer(gg, xx, impl=impl),
                                n_e, dev, iters, check)
            rows.append({**row, "impl": impl, "out": out[:n_sub].float().cpu().numpy()})
    return rows


def full_rows(g: Graph, dim: int, heads: int, *, rng, iters: int = 10,
              oracle_iters: int = 3) -> list:
    """The full-graph half on ``g`` (on its device): q, k, v of ``[n, heads,
    dim // heads]`` drawn from ``rng``; the oracle's row, then one row per
    layout of :data:`LAYOUTS`, each layout built once before its row."""
    dev = g.rows.device
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (g.n_nodes, heads, dim // heads)).astype(np.float32)).to(dev) for _ in range(3))
    rows = []
    with torch.inference_mode():
        exact = graph_attention(g, q.double(), k.double(), v.double(), method="reference")
        row, out = _run_row(
            "reference (oracle segment ops)",
            lambda: graph_attention(g, q, k, v, method="reference"), g.n_edges, dev,
            oracle_iters,
            lambda out: check_correct(out.double().cpu().numpy(), exact.cpu().numpy(),
                                      atol=FULL_ATOL))
        rows.append(row)
        want = out.cpu().numpy()
        del exact, out
        for label, kw, packed in LAYOUTS:
            layout = formats.build_buckets(g, **kw)
            rows.append(_run_row(
                label, lambda: bucket_graph_attention(layout, q, k, v, packed=packed),
                g.n_edges, dev, iters,
                lambda out: check_correct(out.cpu().numpy(), want, atol=FULL_ATOL),
                pad=layout.padded_edges / g.n_edges)[0])
            del layout
    return rows


def main(argv=None) -> dict:
    """Returns ``{"batched": rows, "full": rows}`` (see :func:`_run_row`)."""
    p = build_parser(__doc__)
    p.add_argument("--device", type=str, default="cuda", help="torch device to run on")
    args = parse_args(p, argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)

    print("=== batched (PATTERN-like) ===", flush=True)
    batched = batched_rows(args.batch_size, args.dim, args.heads, rng=rng, device=dev)
    print("=== full graph (reddit-like, quarter scale) ===", flush=True)
    ds = load_full_graph("reddit", args.data_dir, scale=FULL_SCALE)
    g = Graph.from_coo(ds.rows, ds.cols, ds.n_nodes, device=dev)
    del ds
    return {"batched": batched, "full": full_rows(g, args.dim, args.heads, rng=rng)}


if __name__ == "__main__":
    main()
