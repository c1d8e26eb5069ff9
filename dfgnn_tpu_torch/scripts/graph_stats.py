"""Dataset statistics (the reference's ``DFGNN/utils/graph_statistics.py``),
with the port's loaders.

The twin of the JAX package's ``scripts/graph_stats.py``: node and edge
counts and degree distributions of the full-graph and batched datasets, in
the same lines.  A full graph's degrees are counted on ``--device`` (the
card unless ``--device cpu`` is given); the rest is numpy on the host.
``digits`` and ``digits-func`` load through scikit-learn, so ``--dataset
all`` raises ``ImportError`` where it is missing.

    python -m dfgnn_tpu_torch.scripts.graph_stats [--dataset cora|PATTERN|all] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from dfgnn_tpu_torch.data.datasets import dataset_names, load_batched, load_full_graph
from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.utils.config import build_parser, parse_args


def full_stats(name, data_dir, device="cuda"):
    ds = load_full_graph(name, data_dir, quiet=True)
    rows = torch.from_numpy(np.asarray(ds.rows, dtype=np.int64)).to(resolve_device(device))
    deg = torch.bincount(rows, minlength=ds.n_nodes).cpu().numpy()
    print(f"{name:14s} nodes={ds.n_nodes:8d} edges={ds.n_edges:10d} "
          f"deg mean={deg.mean():8.1f} p50={np.percentile(deg,50):6.0f} "
          f"p99={np.percentile(deg,99):8.0f} max={deg.max():8d}"
          + ("  [synthetic]" if ds.synthetic else ""))


def batched_stats(name, data_dir):
    ds = load_batched(name, data_dir, n_graphs=256, quiet=True)
    nodes = np.array([g[2] for g in ds.graphs])
    edges = np.array([len(g[0]) for g in ds.graphs])
    print(f"{name:14s} graphs={len(ds):5d} nodes/graph={nodes.mean():6.1f} "
          f"edges/graph={edges.mean():8.1f} deg={edges.mean()/max(nodes.mean(),1):6.1f} "
          f"task={ds.task}" + ("  [synthetic]" if ds.synthetic else ""))


def main(argv=None):
    p = build_parser(__doc__)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device that counts a full graph's degrees")
    args = parse_args(p, argv)
    names = dataset_names()
    targets = ([args.dataset] if args.dataset != "all"
               else names["full"] + names["batched"])
    for nm in targets:
        if nm in names["full"]:
            full_stats(nm, args.data_dir, args.device)
        else:
            batched_stats(nm, args.data_dir)


if __name__ == "__main__":
    main()
