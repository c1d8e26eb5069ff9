"""Fused-vs-unfused accuracy parity, with PyTorch.

The twin of the JAX package's ``scripts/train_parity.py``.  It trains
``FullGraphNet`` on a PATTERN-like batch of SBM graphs twice, through the
flash kernels on a DenseBatch and through the segment-op oracle on the
block-diagonal Graph, with the same init, data and Adam, and prints both
accuracies and their gap against the 0.02 bar.  It runs on the card unless
``--device cpu`` is given.

    python -m dfgnn_tpu_torch.scripts.train_parity --conv gat [--steps 200] [--device cpu]

The JAX script also runs a full-graph half (the bucketed layout); that half
is not ported yet (ROADMAP.md queue 1 item 7), so this script runs the
batched half only and says so.
"""

from __future__ import annotations

import argparse
import json
import os

from dfgnn_tpu_torch.train.parity import run_parity_batched

GAP_BAR = 0.02


def main(argv=None) -> dict:
    """Runs the batched half and returns its result."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--conv", default="gt")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-graphs", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="torch device to train on")
    ap.add_argument("--store-result", action="store_true")
    args = ap.parse_args(argv)

    r = run_parity_batched(seed=args.seed, n_graphs=args.n_graphs, hidden=args.hidden,
                           layers=args.layers, steps=args.steps, conv=args.conv,
                           device=args.device)
    print(f"[{r['task']}] fused={r['acc_fused']:.4f} unfused={r['acc_unfused']:.4f} "
          f"gap={r['gap']:.4f} (majority baseline {r['majority_baseline']:.3f})")
    print("[full-graph] not run: the bucketed full-graph path is not ported yet "
          "(ROADMAP.md queue 1 item 7)")
    print(f"parity: worst gap = {r['gap']:.4f} "
          f"({'OK' if r['gap'] < GAP_BAR else 'CHECK'} at the {GAP_BAR} bar)")
    if args.store_result:
        os.makedirs("results", exist_ok=True)
        with open(f"results/parity_torch_{args.conv}.json", "w") as f:
            json.dump([{k: v for k, v in r.items() if k != "fused_steps"}], f, indent=2)
    return r


if __name__ == "__main__":
    main()
