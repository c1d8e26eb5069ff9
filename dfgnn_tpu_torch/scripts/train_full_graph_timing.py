"""Full-graph training timing split: forward, backward, update, with PyTorch.

The twin of the JAX package's ``scripts/train_full_graph_timing.py`` (the
reference's ``train_full_graph_timing.py``): a ``FullGraphNet`` stack (8
GT layers by default) on one full graph; the forward, the forward plus
backward and the whole epoch (with the Adam update) are timed for the fused
bucket path (``build_buckets(g, with_transpose=True)``, its custom
backward) and the unfused oracle, and the backward and the update are
derived by subtraction, as a GitHub table.  Above 4M edges the oracle runs
on a random 4M-edge subsample; otherwise both paths' losses at the
initial weights are checked against each other first (rtol 1e-3).  Times are host-clock milliseconds
around ``--epochs`` calls that end in a device synchronisation, after one
warm-up call; the Adam steps of the epoch column update the weights.  TF32
is off.  It runs on the card unless ``--device cpu`` is given; on the CPU
it checks and runs each pass once, but does not time the device.

    python -m dfgnn_tpu_torch.scripts.train_full_graph_timing --dataset cora --dim 64 \\
        --n-layers 8 --epochs 5 [--remat] [--device cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from dfgnn_tpu_torch.data.datasets import load_full_graph
from dfgnn_tpu_torch.device import resolve_device, synchronize
from dfgnn_tpu_torch.formats import build_buckets
from dfgnn_tpu_torch.graph import Graph
from dfgnn_tpu_torch.models import FullGraphNet
from dfgnn_tpu_torch.train import TrainState
from dfgnn_tpu_torch.utils.benchmark import github_table
from dfgnn_tpu_torch.utils.config import build_parser, parse_args

ORACLE_EDGE_CAP = 4_000_000


def main(argv=None) -> dict:
    """Returns the preprocess ms; per path the forward, backward, update and
    epoch ms (None on the CPU); and whether the loss check passed (None when
    the oracle ran on a subsample)."""
    p = build_parser(__doc__)
    p.add_argument("--remat", action="store_true",
                   help="recompute each conv layer in the backward (FullGraphNet(remat=True))")
    p.add_argument("--device", type=str, default="cuda", help="torch device to run on")
    args = parse_args(p, argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ds = load_full_graph(args.dataset, args.data_dir)
    g = Graph.from_coo(ds.rows, ds.cols, ds.n_nodes, device=dev)
    g_oracle = g
    if g.n_edges > ORACLE_EDGE_CAP:
        # the oracle's O(E dim) gathered temporaries outgrow the card's memory
        sub = np.random.default_rng(0).choice(g.n_edges, ORACLE_EDGE_CAP, replace=False)
        e = g.n_edges
        g_oracle = Graph.from_coo(g.rows[:e].cpu().numpy()[sub], g.cols[:e].cpu().numpy()[sub],
                                  g.n_nodes, device=dev)
        print(f"unfused(oracle) rows use a {ORACLE_EDGE_CAP}-edge subsample ({e} edges)")

    t0 = time.perf_counter()
    bg = build_buckets(g, with_transpose=True)  # once; the transpose feeds the custom backward
    prep_ms = (time.perf_counter() - t0) * 1e3

    feats = ds.features[:, : args.dim].astype(np.float32)
    if feats.shape[1] < args.dim:
        feats = np.pad(feats, [(0, 0), (0, args.dim - feats.shape[1])])
    x = torch.from_numpy(feats).to(dev)
    y = torch.from_numpy(np.asarray(ds.labels, dtype=np.int64)).to(dev)
    model = FullGraphNet(args.conv, ds.num_classes, hidden_size=args.dim,
                         num_layers=args.n_layers, num_heads=args.heads, remat=args.remat,
                         in_size=args.dim, generator=torch.Generator().manual_seed(args.seed),
                         device=dev)
    state = TrainState.create(model, lr=args.lr, device=dev)
    params = list(model.parameters())

    def loss_fn(layout):
        lp = model(layout, x)
        return -torch.take_along_dim(lp, y[:, None], dim=1).mean()

    def fw(layout):
        with torch.no_grad():
            return loss_fn(layout)

    def fwbw(layout):
        loss = loss_fn(layout)
        return loss.detach(), torch.autograd.grad(loss, params)

    def epoch(layout):
        state.opt.zero_grad(set_to_none=True)
        loss = loss_fn(layout)
        loss.backward()
        state.opt.step()
        return loss.detach()

    def timed(fn, layout):
        fn(layout)  # warm-up
        synchronize(dev)
        if dev.type != "cuda":
            return None
        t0 = time.perf_counter()
        for _ in range(args.epochs):
            fn(layout)
        synchronize(dev)
        return (time.perf_counter() - t0) / args.epochs * 1e3

    results = {"ok": None}
    if g_oracle is g:
        a, b = float(fw(bg)), float(fw(g))
        results["ok"] = bool(np.isclose(a, b, rtol=1e-3, atol=0.0))
        print(f"fused-vs-unfused loss check: {'OK' if results['ok'] else 'FAILED'} "
              f"({a:.6f} against {b:.6f}, rtol 1e-3)")
        if not results["ok"]:
            sys.exit(1)
    cell = lambda t: "not measured" if t is None else f"{t:.2f}"
    rows = []
    for name, layout in (("fused(bucket)", bg), ("unfused(oracle)", g_oracle)):
        t_fw, t_fwbw, t_ep = timed(fw, layout), timed(fwbw, layout), timed(epoch, layout)
        res = {"forward_ms": t_fw, "fwbw_ms": t_fwbw, "epoch_ms": t_ep,
               "backward_ms": None if t_fw is None else t_fwbw - t_fw,
               "update_ms": None if t_fw is None else t_ep - t_fwbw}
        results[name] = res
        rows.append([name] + [cell(res[k]) for k in ("forward_ms", "backward_ms", "update_ms",
                                                     "epoch_ms")])
    print(f"preprocess: {prep_ms:.1f} ms (once)")
    print(github_table(["path", "forward ms", "backward ms", "update ms", "epoch ms"], rows))
    results["preprocess_ms"] = prep_ms
    return results


if __name__ == "__main__":
    main()
