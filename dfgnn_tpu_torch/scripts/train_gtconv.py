"""End-to-end GT training on a graph-classification dataset, with PyTorch.

The twin of the JAX package's ``scripts/train_gtconv.py``: the 8-layer
GTModel, Adam with StepLR (the rate halves every 20 updates), the task's
loss, a metric per epoch (ROC-AUC, mean AP or accuracy), and
``--checkgrad``.  It runs on the card unless ``--device cpu`` is given.

    python -m dfgnn_tpu_torch.scripts.train_gtconv --dataset ogbg-molhiv \\
        --dim 64 --batch-size 64 --epochs 3 [--checkgrad] [--device cpu]

``--checkgrad`` compares every parameter's gradient on the first batch
through ``impl="flash"`` (the flash kernels) with the gradient through
``impl="reference"`` on the batch's block-diagonal edge-list Graph
(autograd through the segment-op oracle), as the JAX script does, at
rtol 1e-3, atol 1e-2, and exits 1 on a mismatch.

As in the JAX script, the node-level datasets (PATTERN, CLUSTER, the -SP
sets) fail: their labels are per node and GTModel's output is per graph.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from dfgnn_tpu_torch.data.collate import batch_iterator
from dfgnn_tpu_torch.data.datasets import load_batched
from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.models import GTModel
from dfgnn_tpu_torch.ops import flash_mask
from dfgnn_tpu_torch.train import (
    TrainState,
    evaluate_accuracy,
    evaluate_mean_ap,
    evaluate_rocauc,
    make_loss_fn,
    train_step,
)
from dfgnn_tpu_torch.utils.config import build_parser, parse_args

CHECKGRAD_TOL = dict(rtol=1e-3, atol=1e-2)  # the JAX script's bar


def main(argv=None):
    """Trains (or checks gradients) and returns what it saw: per step the
    loss and the flash forward and backward kernel launches, per epoch the
    mean loss, the metric and the host seconds."""
    parser = build_parser(__doc__)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on")
    args = parse_args(parser, argv)
    device = resolve_device(args.device)

    ds = load_batched(args.dataset, args.data_dir, n_graphs=args.batch_size * 8)
    model = GTModel(
        args.dataset, out_size=ds.num_classes, hidden_size=args.dim,
        num_layers=args.n_layers, num_heads=args.heads, in_size=ds.in_dim,
        generator=torch.Generator().manual_seed(0), device=device,
    )
    # The JAX script zeroes each batch's n_edges / n_nodes so that every batch
    # shares one jit trace; PyTorch runs eagerly and needs no such step.
    batches = list(batch_iterator(ds, args.batch_size, np_pad=128, device=device))
    loss_fn = make_loss_fn(model, ds.task, ds.num_classes)
    state = TrainState.create(model, lr=args.lr, step_lr_every=20, device=device)

    if args.checkgrad:
        _checkgrad(model, loss_fn, *batches[0])
        return {"checkgrad": "OK"}

    history = {"steps": [], "epochs": []}
    for epoch in range(args.epochs):
        t0 = time.time()
        losses = []
        for batch, x, y, m in batches:
            fwd0, bwd0 = flash_mask.LAUNCHES, flash_mask.BWD_LAUNCHES
            state, loss = train_step(state, loss_fn, batch, x, y, m)
            losses.append(float(loss))
            history["steps"].append({
                "loss": losses[-1],
                "fwd_launches": flash_mask.LAUNCHES - fwd0,
                "bwd_launches": flash_mask.BWD_LAUNCHES - bwd0,
            })
        # eval ROC-AUC (binary), mean AP (multilabel), or accuracy
        scores, ys, ms = [], [], []
        with torch.no_grad():
            for batch, x, y, m in batches:
                scores.append(model(batch, x).cpu().numpy())
                ys.append(y.cpu().numpy())
                ms.append(m.cpu().numpy())
        sc, yy, mm = (np.concatenate(a) for a in (scores, ys, ms))
        if ds.num_classes == 1:
            metric = evaluate_rocauc(yy, sc)
        elif ds.task == "graph_classification_multilabel":
            metric = evaluate_mean_ap(yy, sc, mask=mm)
        else:
            metric = evaluate_accuracy(yy, sc.argmax(-1), mask=mm)
        seconds = time.time() - t0
        print(f"epoch {epoch}: loss={np.mean(losses):.4f} metric={metric:.4f} "
              f"time={seconds:.2f}s")
        history["epochs"].append({"loss": float(np.mean(losses)), "metric": metric,
                                  "seconds": seconds})
    return history


def _checkgrad(model, loss_fn, batch, x, y, m):
    """Flash-vs-oracle gradient comparison on one batch, through the task's
    training loss."""
    def grads(g, impl):
        model.zero_grad(set_to_none=True)
        loss_fn(g, x, y, m, impl=impl).backward()
        return {name: p.grad.detach().cpu().numpy() for name, p in model.named_parameters()}

    g_fused = grads(batch, "flash")
    g_ref = grads(batch.to_graph(), "reference")
    model.zero_grad(set_to_none=True)
    print("checkgrad: impl='flash' (the flash kernels) against impl='reference' on the "
          "block-diagonal Graph (autograd through the segment-op oracle), rtol 1e-3, "
          "atol 1e-2")
    ok = True
    for name, a in g_fused.items():
        b = g_ref[name]
        if not np.allclose(a, b, **CHECKGRAD_TOL):
            ok = False
            print(f"  grad mismatch at {name}: max|d|={float(np.max(np.abs(a - b))):.3e}")
    print("checkgrad:", "OK" if ok else "FAIL")
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
