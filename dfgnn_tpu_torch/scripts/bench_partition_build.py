"""Partitioner scalability: plan-build wall time and padding against the
device count.

The twin of the JAX package's ``scripts/bench_partition_build.py``: times
the port's ``parallel.partition_graph`` on the reddit stand-in
(``data.datasets.load_full_graph("reddit")``) at each ``--devices`` count,
with and without the halo plan, and prints the same table: build seconds
(host clock), the padded-edge factor (padded lanes over real edges, all
devices together), ``max_halo`` and the halo fraction (``max_halo`` over
the rows a device owns).  Host-side numpy: it needs no card.

    python -m dfgnn_tpu_torch.scripts.bench_partition_build [--devices 8 64 256]
        [--scale 1.0] [--no-halo]
"""

from __future__ import annotations

import argparse
import time

from dfgnn_tpu_torch.data.datasets import load_full_graph
from dfgnn_tpu_torch.graph import Graph
from dfgnn_tpu_torch.parallel import partition_graph


def plan_rows(g: Graph, devices, halos=(False, True)):
    """Times ``partition_graph(g, P, halo=halo)`` for each halo flag and
    device count; prints a table row per plan and returns the rows."""
    e = g.n_edges
    print(f"{'P':>4} {'halo':>5} {'build_s':>8} {'pad':>6} {'max_halo':>9} "
          f"{'halo_frac':>9}")
    rows = []
    for halo in halos:
        for P in devices:
            t0 = time.perf_counter()
            pg = partition_graph(g, P, halo=halo)
            dt = time.perf_counter() - t0
            pad = pg.padded_edges / e
            mh = pg.halo.max_halo if pg.halo is not None else 0
            hf = (mh / pg.n_local) if mh else 0.0
            print(f"{P:>4} {str(halo):>5} {dt:>8.2f} {pad:>6.3f} {mh:>9} "
                  f"{hf:>9.3f}", flush=True)
            rows.append(dict(devices=P, halo=halo, build_s=dt, pad=pad, max_halo=mh,
                             halo_frac=hf, n_local=pg.n_local))
            del pg
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--devices", type=int, nargs="+", default=[8, 64, 256])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--no-halo", action="store_true")
    args = ap.parse_args(argv)

    ds = load_full_graph("reddit", "data", scale=args.scale)
    g = Graph.from_coo(ds.rows, ds.cols, ds.n_nodes, device="cpu")
    print(f"graph: n={g.n_nodes} e={g.n_edges}")
    return plan_rows(g, args.devices, [False] if args.no_halo else [False, True])


if __name__ == "__main__":
    main()
