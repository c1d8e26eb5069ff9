"""Fused-vs-unfused accuracy parity, with PyTorch.

The twin of the JAX package's ``scripts/train_parity.py``.  It trains
``FullGraphNet`` twice on each of two tasks, with the same init, data and
Adam, and prints both accuracies and their gap against the 0.02 bar:
- batched: a PATTERN-like batch of SBM graphs, through the flash kernels on
  a DenseBatch and through the segment-op oracle on the block-diagonal Graph;
- full graph: one SBM graph (or ``--dataset`` when its real data is found
  under ``--data-dir``), through the bucket path on its bucketed training
  layout and through the oracle on the Graph.
It runs on the card unless ``--device cpu`` is given.

    python -m dfgnn_tpu_torch.scripts.train_parity --conv gat [--steps 200] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from dfgnn_tpu_torch.train.parity import run_parity_batched, run_parity_full

GAP_BAR = 0.02


def main(argv=None) -> dict:
    """Runs both halves; returns ``{"batched": ..., "full": ...}``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--conv", default="gt")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-graphs", type=int, default=32)
    ap.add_argument("--dataset", default=None,
                    help="full-graph dataset name (real data used if found)")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--device", default="cuda", help="torch device to train on")
    ap.add_argument("--store-result", action="store_true")
    args = ap.parse_args(argv)

    ds = None
    if args.dataset:
        from dfgnn_tpu_torch.data.datasets import load_full_graph

        ds = load_full_graph(args.dataset, args.data_dir)
    kw = dict(seed=args.seed, hidden=args.hidden, layers=args.layers, steps=args.steps,
              conv=args.conv, device=args.device)
    results = {"batched": run_parity_batched(n_graphs=args.n_graphs, **kw),
               "full": run_parity_full(dataset=ds, **kw)}
    for r in results.values():
        print(f"[{r['task']}] fused={r['acc_fused']:.4f} unfused={r['acc_unfused']:.4f} "
              f"gap={r['gap']:.4f} (majority baseline {r['majority_baseline']:.3f})")
    worst = max(r["gap"] for r in results.values())
    print(f"parity: worst gap = {worst:.4f} "
          f"({'OK' if worst < GAP_BAR else 'CHECK'} at the {GAP_BAR} bar)")
    if args.store_result:
        os.makedirs("results", exist_ok=True)
        with open(f"results/parity_torch_{args.conv}.json", "w") as f:
            json.dump([{k: v for k, v in r.items() if k != "fused_steps"}
                       for r in results.values()], f, indent=2)
    return results


if __name__ == "__main__":
    main()
