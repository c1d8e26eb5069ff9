"""Multi-GPU scaling of the edge-partitioned full-graph attention, with PyTorch.

The twin of the JAX package's ``scripts/bench_scaling.py``: the distributed
attention's throughput on one graph at mesh sizes {1, 2, 4, ...} up to the
world size, and its scaling efficiency.  Run it under ``torchrun``, one
process per GPU; each mesh size is a sub-group of the first ranks, and the
others wait.  Timed with CUDA events (3 warmups, 10 timed runs, after a
barrier); a size's time is its slowest rank's.  ``DFGNN_HALO=1`` builds
halo plans (above one device) and ``DFGNN_REORDER=lpa`` or ``bfs`` reorders
nodes first, as in the JAX script.  Its ``DFGNN_SCALING_CPU`` virtual mesh
has no counterpart: without a card this raises unless ``--device cpu`` is
given, and on the CPU it runs each size once and does not time.

    torchrun --nproc-per-node 4 -m dfgnn_tpu_torch.scripts.bench_scaling \\
        --dataset reddit --dim 64 [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from dfgnn_tpu_torch.data.datasets import load_full_graph
from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.graph import Graph
from dfgnn_tpu_torch.parallel import comm, dist_graph_attention, make_mesh, partition_graph
from dfgnn_tpu_torch.parallel.dist import mesh_group_rank
from dfgnn_tpu_torch.parallel.multihost import initialize_or_single
from dfgnn_tpu_torch.utils.benchmark import benchmark
from dfgnn_tpu_torch.utils.config import build_parser, parse_args


def main(argv=None) -> list:
    """Returns one row per mesh size on rank 0 (the others return [])."""
    p = build_parser(__doc__)
    p.add_argument("--device", type=str, default="cuda", help="torch device to run on")
    args = parse_args(p, argv)
    dev = resolve_device(args.device)
    started = initialize_or_single(dev)
    try:
        return _run(args, dev)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, dev) -> list:
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    world, rank = dist.get_world_size(), dist.get_rank()
    ds = load_full_graph(args.dataset, args.data_dir, quiet=rank > 0)
    g = Graph.from_coo(ds.rows, ds.cols, ds.n_nodes, device="cpu")
    h, f = args.heads, args.dim // args.heads
    use_halo = bool(os.environ.get("DFGNN_HALO"))
    reorder = os.environ.get("DFGNN_REORDER") or None  # "lpa" | "bfs"
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= world]
    rows, base_eps = [], None
    for nd in sizes:
        mesh = make_mesh(nd, device=dev.type)  # every rank takes part in making it
        if mesh.get_coordinate() is not None:
            group, r = mesh_group_rank(mesh)
            pg = partition_graph(g, nd, mesh=mesh, halo=use_halo and nd > 1, reorder=reorder)
            # comm model: rows received per device per exchanged operand times
            # the row bytes (the dot score exchanges k and v)
            comm_mb = pg.comm_rows_per_device() * h * f * 4 * 2 / 1e6
            pad = pg.padded_edges / max(g.n_edges, 1)
            gen = torch.Generator(device=dev).manual_seed(r)
            q, k, v = (torch.randn((pg.n_local, h, f), generator=gen, device=dev)
                       for _ in range(3))
            call = lambda: dist_graph_attention(pg, mesh, q, k, v)
            dist.barrier(group)
            if dev.type == "cuda":
                ms = benchmark(call, warmup=3, iters=10)[1]
                ms = float(comm.all_reduce_max(torch.tensor([ms], device=dev), group)[0])
            else:
                call()
                ms = None
            row = dict(devices=nd, ms=ms, comm_mb=comm_mb, pad=pad, halo=pg.halo is not None,
                       reorder=reorder)
            tail = (f"comm={comm_mb:.1f} MB/dev/layer  pad={pad:.2f}x"
                    f"{'  [halo]' if pg.halo is not None else ''}"
                    f"{'  [reorder]' if reorder else ''}")
            if ms is None:
                line = f"devices={nd:3d}: time not measured (no CUDA device)  {tail}"
            else:
                eps = g.n_edges / (ms / 1e3)
                base_eps = eps if base_eps is None else base_eps
                row.update(edges_per_s=eps, efficiency=eps / (base_eps * nd) * 100)
                line = (f"devices={nd:3d}: {ms:8.2f} ms  {eps:.3e} edges/s  "
                        f"scaling-efficiency={row['efficiency']:5.1f}%  {tail}")
            if rank == 0:
                print(line, flush=True)
                rows.append(row)
            del pg, q, k, v
        dist.barrier()
    return rows


if __name__ == "__main__":
    main()
