"""Full-graph GAT training: accuracy, timing and peak device memory, with PyTorch.

The twin of the JAX package's ``scripts/train_gatconv.py`` (the reference's
``train_gatconv.py``): a multi-layer ``GATNet`` on one full graph through
the bucket path and its custom backward
(``build_buckets(g, with_transpose=True)``), Adam on the train mask, and per
epoch the train step's time; then the inference time, the test accuracy and
the peak device memory (``torch.cuda.max_memory_allocated``).  Times are
host-clock seconds around work that ends in a device synchronisation.  It
runs on the card unless ``--device cpu`` is given; on the CPU it trains but
reads no device memory.

    python -m dfgnn_tpu_torch.scripts.train_gatconv --dataset arxiv --dim 64 --heads 4 \\
        --n-layers 2 --epochs 20 --lr 1e-2 [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dfgnn_tpu_torch.data.datasets import load_full_graph
from dfgnn_tpu_torch.device import resolve_device, synchronize
from dfgnn_tpu_torch.formats import build_buckets
from dfgnn_tpu_torch.graph import Graph
from dfgnn_tpu_torch.models import GATNet
from dfgnn_tpu_torch.train import TrainState, make_loss_fn, train_step
from dfgnn_tpu_torch.utils.config import build_parser, parse_args


def main(argv=None) -> dict:
    """Returns the per-epoch losses and train ms, the inference ms, the test
    accuracy and the peak device memory in MiB (None on the CPU)."""
    p = build_parser(__doc__)
    p.add_argument("--device", type=str, default="cuda", help="torch device to train on")
    args = parse_args(p, argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    ds = load_full_graph(args.dataset, args.data_dir)
    g = Graph.from_coo(ds.rows, ds.cols, ds.n_nodes, device=dev)
    bg = build_buckets(g, with_transpose=True)
    x = torch.from_numpy(ds.features.astype(np.float32)).to(dev)
    y = torch.from_numpy(np.asarray(ds.labels, dtype=np.int64)).to(dev)
    train_mask = torch.from_numpy(ds.train_mask.astype(np.float32)).to(dev)
    test_mask = np.asarray(ds.test_mask)

    model = GATNet(num_classes=ds.num_classes, hidden_size=args.dim, num_layers=args.n_layers,
                   num_heads=args.heads, in_size=x.shape[1],
                   generator=torch.Generator().manual_seed(args.seed), device=dev)
    state = TrainState.create(model, lr=args.lr, device=dev)
    loss_fn = make_loss_fn(model, "node_classification", ds.num_classes)

    losses, train_ms = [], []
    for epoch in range(args.epochs):
        synchronize(dev)
        t0 = time.perf_counter()
        _, loss = train_step(state, loss_fn, bg, x, y, train_mask)
        loss = float(loss)  # a value fetch: the device has finished the step
        train_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if epoch % max(1, args.epochs // 5) == 0:
            print(f"epoch {epoch}: loss={loss:.4f} time={train_ms[-1]:.1f}ms", flush=True)

    synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        pred = model(bg, x).argmax(dim=-1).cpu().numpy()
    infer_ms = (time.perf_counter() - t0) * 1e3
    labels = np.asarray(ds.labels)
    acc = (float((pred[test_mask] == labels[test_mask]).mean()) if test_mask.any()
           else float((pred == labels).mean()))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20 if dev.type == "cuda" else None
    epoch_ms = float(np.mean(train_ms[1:] if len(train_ms) > 1 else train_ms))
    print(f"train time/epoch: {epoch_ms:.1f} ms (first epoch excluded)  "
          f"inference: {infer_ms:.1f} ms")
    print(f"test accuracy: {acc:.4f}")
    print("peak device memory: " + ("not measured (no CUDA device)" if peak is None
                                    else f"{peak:.1f} MiB"))
    return {"losses": losses, "train_ms": train_ms, "epoch_ms": epoch_ms,
            "infer_ms": infer_ms, "acc": acc, "peak_mib": peak}


if __name__ == "__main__":
    main()
