"""Full-graph attention benchmark with correctness checks, with PyTorch.

The twin of the JAX package's ``scripts/test_full_graph.py``: one conv
layer over one large graph per format, timed with CUDA events (3 warmups,
10 timed runs), and the bucket format checked against the segment-op oracle
at rtol 1e-3, atol 1e-4.  ``--format all_fg`` (or ``all_fg_super``,
``all``) runs ``reference`` and ``bucket``.  Above ``--oracle-edge-cap``
edges the oracle runs on a random edge subsample of that size (its O(E dim)
gathered temporaries would not fit otherwise), is compared by edges/s, and
the bucket path is checked on the subsample.  ``--format dist`` runs
``reference`` and the edge-partitioned multi-device path over
``--n-devices`` ranks (all of the world by default): each rank runs the layer
on its block of rows, the output is gathered and checked against the oracle
(on the subsample's plan above the cap), and the slowest rank's time is
reported; run it under ``torchrun``, or alone as a world of one process.
TF32 is off for every product, in place of the JAX script's
``default_matmul_precision("highest")``.  It runs on the card unless
``--device cpu`` is given; on the CPU it checks but does not time.
``--profile`` traces one call per format (``utils/profiling.py``).

    python -m dfgnn_tpu_torch.scripts.test_full_graph --dataset reddit --dim 128 \\
        --heads 1 --conv gt --format all_fg [--device cpu]
    torchrun --nproc-per-node 4 -m dfgnn_tpu_torch.scripts.test_full_graph \\
        --dataset reddit --dim 128 --heads 1 --format dist
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from dfgnn_tpu_torch.data.datasets import load_full_graph
from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.formats import build_buckets
from dfgnn_tpu_torch.graph import Graph
from dfgnn_tpu_torch.models import make_conv
from dfgnn_tpu_torch.parallel import comm, gather_nodes, make_mesh, partition_graph, shard_nodes
from dfgnn_tpu_torch.parallel.dist import mesh_group_rank
from dfgnn_tpu_torch.parallel.multihost import initialize_or_single
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
    CPU), and for ``bucket`` and ``dist`` whether it matched the oracle."""
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
        fmts = ["reference", "dist"]
    dev = resolve_device(args.device)
    started = "dist" in fmts and initialize_or_single(dev)
    try:
        return _run(args, fmts, dev)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, fmts, dev) -> dict:
    if "dist" in fmts and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    # in a world of several ranks, rank 0 prints
    say = print if not dist.is_initialized() or dist.get_rank() == 0 else (lambda *a, **k: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ds = load_full_graph(args.dataset, args.data_dir)
    if say is print:
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
        say(f"  oracle runs on a {args.oracle_edge_cap}-edge subsample; comparison is by "
            f"edges/s; correctness checked on the subsample")
    else:
        g_ref = g
    layouts = {"reference": g_ref, "bucket": build_buckets(g) if "bucket" in fmts else None}
    calls = {fmt: (lambda gg=gg: layer(gg, x)) for fmt, gg in layouts.items()}
    checks = {"bucket": lambda: layer(build_buckets(g_ref) if oracle_sub else layouts["bucket"],
                                      x)}
    mesh = None
    if "dist" in fmts:
        mesh = make_mesh(args.n_devices, device=dev.type)
        if mesh.get_coordinate() is None:  # a rank outside the mesh sits this format out
            fmts.remove("dist")
    if "dist" in fmts:
        _, rank = mesh_group_rank(mesh)

        def on_plan(gc):
            pg = partition_graph(gc.to("cpu"), mesh.size(), mesh=mesh)
            x_l = shard_nodes(pg, x, rank)
            return pg, lambda: layer(pg, x_l)
        pg, calls["dist"] = on_plan(g)
        pg_ref, call_ref = on_plan(g_ref) if oracle_sub else (pg, calls["dist"])
        checks["dist"] = lambda: gather_nodes(pg_ref, call_ref(), mesh)

    results = {}
    ref_out = None
    with torch.inference_mode():
        for fmt in fmts:
            call = calls[fmt]
            n_e = g_ref.n_edges if fmt == "reference" else g.n_edges
            res = {"n_edges": int(n_e), "ok": None, "ms": None, "edges_per_s": None,
                   "peak_mib": None}
            if args.profile:
                with profile_region(f"full_{args.dataset}_{fmt}"):
                    call()
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                res["ms"] = benchmark(call, iters=10)[1]
                res["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
                if fmt == "dist":  # the slowest rank sets the step
                    group, _ = mesh_group_rank(mesh)
                    res["ms"], res["peak_mib"] = comm.all_reduce_max(
                        torch.tensor([res["ms"], res["peak_mib"]], device=dev), group).tolist()
                res["edges_per_s"] = n_e / (res["ms"] / 1e3)
            if fmt == "reference":
                ref_out = call()
            elif ref_out is not None:
                out = checks[fmt]()
                # atol 1e-4: the oracle's segment sums and the bucket walk's
                # chunked sums order fp32 additions differently (the JAX
                # script's bar); rtol 1e-3 is the reference's
                res["ok"] = check_correct(out.float().cpu().numpy(),
                                          ref_out.float().cpu().numpy(), atol=1e-4)
                say(f"  [{fmt}] correctness vs oracle: {'OK' if res['ok'] else 'FAIL'}")
            if res["ms"] is None:
                say(f"  [{fmt}] time: not measured (no CUDA device)")
            else:
                say(f"  [{fmt}] {res['ms']:.3f} ms   {res['edges_per_s']:.3e} edges/s   "
                    f"peak {res['peak_mib']:.1f} MiB"
                    + ("  (subsampled)" if fmt == "reference" and oracle_sub else "")
                    + (f"  (slowest of {mesh.size()} ranks, {pg.n_local} rows each)"
                       if fmt == "dist" else ""))
            results[fmt] = res
    if args.store_result and say is print:
        os.makedirs("results", exist_ok=True)
        out = f"results/full_torch_{args.dataset}_{args.conv}_{args.dim}.json"
        with open(out, "w") as f:
            json.dump({"args": vars(args), "device": str(dev), "results": results}, f, indent=2)
        print("stored", out)
    return results


if __name__ == "__main__":
    main()
