"""Full-graph attention benchmark with correctness checks, with PyTorch.

The twin of the JAX package's ``scripts/test_full_graph.py``: one conv
layer over one large graph per format, timed with CUDA events (3 warmups,
10 timed runs), and the bucket format checked against the segment-op oracle
at rtol 1e-3, atol 1e-4.  ``--format all_fg`` (or ``all_fg_super``,
``all``) runs ``reference`` and ``bucket``.  Above ``--oracle-edge-cap``
edges the oracle runs on a random edge subsample of that size (its O(E dim)
gathered temporaries would not fit otherwise), is compared by edges/s, and
the bucket path is checked on the subsample.  ``--format dist`` (the
edge-partitioned multi-device path) is not ported.  TF32 is off for every
product, in place of the JAX script's ``default_matmul_precision("highest")``.
It runs on the card unless ``--device cpu`` is given; on the CPU it checks
but does not time.  ``--profile`` traces one call per format
(``utils/profiling.py``).

    python -m dfgnn_tpu_torch.scripts.test_full_graph --dataset reddit --dim 128 \\
        --heads 1 --conv gt --format all_fg [--device cpu]
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from dfgnn_tpu_torch.data.datasets import load_full_graph
from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.formats import build_buckets
from dfgnn_tpu_torch.graph import Graph
from dfgnn_tpu_torch.models import make_conv
from dfgnn_tpu_torch.utils.benchmark import benchmark, check_correct
from dfgnn_tpu_torch.utils.config import build_parser, parse_args, resolve_format
from dfgnn_tpu_torch.utils.profiling import profile_region


def print_graph_struct(ds):
    deg = np.bincount(ds.rows, minlength=ds.n_nodes)
    print(f"graph {ds.name}: nodes={ds.n_nodes} edges={ds.n_edges} "
          f"avg_deg={deg.mean():.1f} max_deg={deg.max()}"
          + (" [synthetic]" if ds.synthetic else ""))


def main(argv=None) -> dict:
    """Returns per format the ms and edges/s (None on the CPU), the edges it
    ran on, the peak device memory of its timed calls in MiB (None on the
    CPU), and for ``bucket`` whether it matched the oracle."""
    p = build_parser(__doc__)
    p.add_argument("--oracle-edge-cap", type=int, default=4_000_000,
                   help="edge count above which the oracle runs on a random edge subsample")
    p.add_argument("--device", type=str, default="cuda", help="torch device to run on")
    args = parse_args(p, argv)
    if args.format in ("all_fg", "all_fg_super", "all"):
        fmts = ["reference", "bucket"]
    else:
        fmts = [resolve_format(args.format)]
    if "dist" in fmts:
        raise NotImplementedError("--format dist runs the edge-partitioned multi-device path, "
                                  "which is not ported yet: ROADMAP.md queue 1 item 10")
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ds = load_full_graph(args.dataset, args.data_dir)
    print_graph_struct(ds)
    g = Graph.from_coo(ds.rows, ds.cols, ds.n_nodes, device=dev)
    feats = ds.features[:, : args.dim].astype(np.float32)
    if feats.shape[1] < args.dim:
        feats = np.pad(feats, [(0, 0), (0, args.dim - feats.shape[1])])
    x = torch.from_numpy(feats).to(dev)
    layer = make_conv(args.conv, args.dim, args.dim, args.heads,
                      generator=torch.Generator().manual_seed(args.seed), device=dev).eval()

    oracle_sub = g.n_edges > args.oracle_edge_cap
    if oracle_sub:
        sub = np.random.default_rng(0).choice(g.n_edges, args.oracle_edge_cap, replace=False)
        e = g.n_edges
        g_ref = Graph.from_coo(g.rows[:e].cpu().numpy()[sub], g.cols[:e].cpu().numpy()[sub],
                               g.n_nodes, device=dev)
        print(f"  oracle runs on a {args.oracle_edge_cap}-edge subsample; comparison is by "
              f"edges/s; correctness checked on the subsample")
    else:
        g_ref = g
    layouts = {"reference": g_ref, "bucket": build_buckets(g) if "bucket" in fmts else None}

    results = {}
    ref_out = None
    with torch.inference_mode():
        for fmt in fmts:
            gg = layouts[fmt]
            n_e = g_ref.n_edges if fmt == "reference" else g.n_edges
            res = {"n_edges": int(n_e), "ok": None, "ms": None, "edges_per_s": None,
                   "peak_mib": None}
            if args.profile:
                with profile_region(f"full_{args.dataset}_{fmt}"):
                    layer(gg, x)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                res["ms"] = benchmark(lambda: layer(gg, x), iters=10)[1]
                res["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
                res["edges_per_s"] = n_e / (res["ms"] / 1e3)
            if fmt == "reference":
                ref_out = layer(gg, x)
            elif ref_out is not None:
                cmp_gg = build_buckets(g_ref) if oracle_sub else gg
                out = layer(cmp_gg, x)
                # atol 1e-4: the oracle's segment sums and the bucket walk's
                # chunked sums order fp32 additions differently (the JAX
                # script's bar); rtol 1e-3 is the reference's
                res["ok"] = check_correct(out.float().cpu().numpy(),
                                          ref_out.float().cpu().numpy(), atol=1e-4)
                print(f"  [{fmt}] correctness vs oracle: {'OK' if res['ok'] else 'FAIL'}")
            if res["ms"] is None:
                print(f"  [{fmt}] time: not measured (no CUDA device)")
            else:
                print(f"  [{fmt}] {res['ms']:.3f} ms   {res['edges_per_s']:.3e} edges/s   "
                      f"peak {res['peak_mib']:.1f} MiB"
                      + ("  (subsampled)" if fmt == "reference" and oracle_sub else ""))
            results[fmt] = res
    if args.store_result:
        os.makedirs("results", exist_ok=True)
        out = f"results/full_torch_{args.dataset}_{args.conv}_{args.dim}.json"
        with open(out, "w") as f:
            json.dump({"args": vars(args), "device": str(dev), "results": results}, f, indent=2)
        print("stored", out)
    return results


if __name__ == "__main__":
    main()
