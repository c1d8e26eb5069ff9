"""Real-data accuracy parity: fused against unfused training, with PyTorch.

The twin of the JAX package's ``scripts/train_real.py`` (the reference's
``train_gtconv.py:80-103, 225-227``): the same initial weights trained
twice, through ``impl="flash"`` (kernels #1 and #3 on the card, their plain
versions on the CPU) and through ``impl="reference"``, with Adam and a
StepLR halving every ``10 * len(train batches)`` updates, on the real
handwritten digits (``digits``: 10-way accuracy; ``digits-func``: 10
binary tasks with NaN holes, mean AP).  It prints each epoch's loss and
test metric per impl and the final gap, and exits 1 when the gap is 0.03 or
more.  ``--nonlinear`` swaps ``GTModel`` for ELU between convs and a mean
pool.

The digits load through scikit-learn, which the card's machine lacks: there
the loader raises ``ImportError``, so this twin runs on the CPU
(``--device cpu``).  The mean AP is the port's own
(:func:`dfgnn_tpu_torch.train.evaluate_mean_ap`), not scikit-learn's.

    python -m dfgnn_tpu_torch.scripts.train_real --dataset digits --dim 64 --n-layers 4 \\
        --batch-size 128 --epochs 25 [--device cpu]
"""

from __future__ import annotations

import copy
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dfgnn_tpu_torch.data.collate import collate_dense
from dfgnn_tpu_torch.data.datasets import load_batched
from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.models import GTModel, choose_inproj, graph_pool, make_conv
from dfgnn_tpu_torch.models.conv import linear
from dfgnn_tpu_torch.train import TrainState, evaluate_mean_ap, train_step
from dfgnn_tpu_torch.train.loop import _task_loss
from dfgnn_tpu_torch.utils.config import build_parser, parse_args

GAP_BAR = 0.03


class PooledNet(nn.Module):
    """inproj -> ``n_layers`` x (conv, ELU) -> mean pool -> a Dense head:
    the JAX script's ``--nonlinear`` model."""

    def __init__(self, dataset: str, conv: str, dim: int, heads: int, n_layers: int,
                 num_classes: int, *, in_size: int, generator: torch.Generator, device="cuda"):
        super().__init__()
        self.inproj = choose_inproj(dataset, dim, in_size=in_size, generator=generator,
                                    device=device)
        self.layers = nn.ModuleList(make_conv(conv, dim, dim, heads, generator=generator,
                                              device=device) for _ in range(n_layers))
        self.predictor = linear(dim, num_classes, generator, device)

    def forward(self, g, x: torch.Tensor, impl=None) -> torch.Tensor:
        h = self.inproj(x)
        for layer in self.layers:
            h = F.elu(layer(g, h, impl=impl))
        return self.predictor(graph_pool(g, h, "mean"))


def _metric(ds, y, scores):
    """(metric, name): mean AP over the labelled cells of each binary task
    for the multilabel task, else accuracy."""
    if ds.task == "graph_classification_multilabel":
        return evaluate_mean_ap(y, scores), "mean-AP"
    return float((scores.argmax(-1) == y).mean()), "accuracy"


def _loss_on_logits(logits, y, m, task):
    """The JAX script's loss on logits computed with an explicit impl: the
    masked multilabel BCE for the multilabel task, else softmax
    cross-entropy, each averaged over the labelled entries."""
    if task == "graph_classification_multilabel":
        return _task_loss(task, logits.shape[-1])(logits, y, m)
    return _task_loss("node_classification", logits.shape[-1])(logits, y, m)


def main(argv=None) -> int:
    p = build_parser(__doc__)
    p.set_defaults(dataset="digits", dim=64, batch_size=128, epochs=25, n_layers=4)
    p.add_argument("--nonlinear", action="store_true",
                   help="ELU between convs and a mean pool in place of GTModel")
    p.add_argument("--device", type=str, default="cuda", help="torch device to run on")
    args = parse_args(p, argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ds = load_batched(args.dataset, args.data_dir)
    if ds.synthetic:
        p.error("train_real is for real data only")

    # deterministic 80/20 split (a plain permutation; the test slice's class
    # balance is left to the shuffle)
    order = np.random.default_rng(0).permutation(len(ds))
    n_tr = int(0.8 * len(ds)) // args.batch_size * args.batch_size
    tr_idx, te_idx = order[:n_tr], order[n_tr:]
    if args.epochs < 1:
        p.error("--epochs must be >= 1")
    if n_tr < args.batch_size:
        p.error(f"--batch-size {args.batch_size} leaves no full training "
                f"batch (train split has {int(0.8 * len(ds))} graphs)")
    if len(te_idx) < args.batch_size:
        p.error(f"--batch-size {args.batch_size} leaves no full test "
                f"batch (test split has {len(te_idx)} graphs)")

    def collate_all(idx_list):
        out = []
        for s in range(0, len(idx_list) - args.batch_size + 1, args.batch_size):
            b, x, y, m = collate_dense(ds, idx_list[s:s + args.batch_size], np_pad=64,
                                       device=dev)
            out.append((b.replace(n_edges=0, n_nodes=0), x, y, m))
        return out

    tr = collate_all(tr_idx)
    te = collate_all(te_idx)

    gen = torch.Generator().manual_seed(args.seed)
    if args.nonlinear:
        model = PooledNet(args.dataset, args.conv, args.dim, args.heads, args.n_layers,
                          ds.num_classes, in_size=ds.in_dim, generator=gen, device=dev)
    else:
        model = GTModel(args.dataset, out_size=ds.num_classes, hidden_size=args.dim,
                        num_layers=args.n_layers, num_heads=args.heads, in_size=ds.in_dim,
                        generator=gen, device=dev)
    params0 = copy.deepcopy(model.state_dict())

    results = {}
    for impl in ("flash", "reference"):
        model.load_state_dict(params0)
        state = TrainState.create(model, lr=args.lr, step_lr_every=10 * len(tr), device=dev)
        loss_fn = lambda g, x, y, m, impl=impl: _loss_on_logits(model(g, x, impl=impl), y, m,
                                                                ds.task)
        t0 = time.time()
        for epoch in range(args.epochs):
            losses = [float(train_step(state, loss_fn, b, x, y, m)[1]) for b, x, y, m in tr]
            with torch.no_grad():
                ss = [model(b, x, impl=impl).cpu().numpy() for b, x, _, _ in te]
            ys = [y.cpu().numpy() for _, _, y, _ in te]
            met, met_name = _metric(ds, np.concatenate(ys), np.concatenate(ss))
            print(f"[{impl:>9}] epoch {epoch:>2}: loss={np.mean(losses):.4f} "
                  f"test {met_name}={met:.4f}", flush=True)
        results[impl] = met
        print(f"[{impl:>9}] total {time.time() - t0:.1f}s", flush=True)

    gap = abs(results["flash"] - results["reference"])
    print(f"\nfinal test metric: fused={results['flash']:.4f} "
          f"unfused={results['reference']:.4f} gap={gap:.4f}")
    return 0 if gap < GAP_BAR else 1


if __name__ == "__main__":
    sys.exit(main())
