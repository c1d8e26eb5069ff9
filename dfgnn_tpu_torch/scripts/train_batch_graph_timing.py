"""Batched-graph training timing split: preprocess, forward, backward, with PyTorch.

The twin of the JAX package's ``scripts/train_batch_graph_timing.py`` (the
reference's ``train_batch_graph_timing.py``): the host time of collating a
batch, the forward's and the forward plus backward's time (backward by
subtraction), as a GitHub table, after a strict check of the first batch:
a GT conv on the DenseBatch against ``impl="reference"`` on its
block-diagonal Graph, atol 0.01 over every node.  Node-level datasets
(PATTERN, CLUSTER) train ``NodeNet`` (inproj, GT layers, a node
classifier); the others ``GTModel``.  In fp32, ``method="auto"`` on a
DenseBatch runs kernel #1 forward and #3 backward on the card; the launches
of one checked forward plus backward are returned.  Times are host-clock
milliseconds around work that ends in a device synchronisation, averaged
over 5 passes of the batches.  TF32 is off.  It runs on the card unless
``--device cpu`` is given; on the CPU it checks and runs each pass once,
but does not time the device.

    python -m dfgnn_tpu_torch.scripts.train_batch_graph_timing --dataset PATTERN \\
        --batch-size 256 --dim 64 --n-layers 4 [--device cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dfgnn_tpu_torch.data.collate import batch_iterator
from dfgnn_tpu_torch.data.datasets import load_batched
from dfgnn_tpu_torch.device import resolve_device, synchronize
from dfgnn_tpu_torch.models import GTConv, GTModel, choose_inproj, make_conv
from dfgnn_tpu_torch.models.conv import linear
from dfgnn_tpu_torch.ops import flash_mask
from dfgnn_tpu_torch.train import make_loss_fn
from dfgnn_tpu_torch.utils.benchmark import github_table
from dfgnn_tpu_torch.utils.config import build_parser, parse_args


class NodeNet(nn.Module):
    """inproj -> ``n_layers`` GT layers -> a node classifier (log-softmax)."""

    def __init__(self, dataset: str, dim: int, heads: int, n_layers: int, n_classes: int, *,
                 in_size: int, generator: torch.Generator, device="cuda"):
        super().__init__()
        self.inproj = choose_inproj(dataset, dim, in_size=in_size, generator=generator,
                                    device=device)
        self.layers = nn.ModuleList(GTConv(dim, dim, heads, generator=generator, device=device)
                                    for _ in range(n_layers))
        self.head = linear(dim, n_classes, generator, device)

    def forward(self, g, x: torch.Tensor, impl=None) -> torch.Tensor:
        h = self.inproj(x)
        for layer in self.layers:
            h = layer(g, h, impl=impl)
        return F.log_softmax(self.head(h), dim=-1)


def main(argv=None) -> dict:
    """Returns the preprocess, forward, backward and fw+bw ms (the device
    columns None on the CPU), whether the strict check passed, and the
    launches of kernels #1, #3, #2, #4, #5, #6 in one checked forward plus
    backward."""
    p = build_parser(__doc__)
    p.add_argument("--device", type=str, default="cuda", help="torch device to run on")
    args = parse_args(p, argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ds = load_batched(args.dataset, args.data_dir, n_graphs=args.batch_size * 4)
    gen = torch.Generator().manual_seed(args.seed)
    if ds.task == "node_classification":
        model = NodeNet(args.dataset, args.dim, args.heads, args.n_layers, ds.num_classes,
                        in_size=ds.in_dim, generator=gen, device=dev)
    else:
        model = GTModel(args.dataset, out_size=ds.num_classes, hidden_size=args.dim,
                        num_layers=args.n_layers, num_heads=args.heads, in_size=ds.in_dim,
                        generator=gen, device=dev)
    loss_fn = make_loss_fn(model, ds.task, ds.num_classes)
    params = [q for q in model.parameters() if q.requires_grad]

    # host collation per batch (the reference's per-batch format conversion),
    # then the copies to the device outside the timed passes
    t0 = time.perf_counter()
    batches = list(batch_iterator(ds, args.batch_size, np_pad=128, device="cpu"))
    prep_ms = (time.perf_counter() - t0) / max(len(batches), 1) * 1e3
    batches = [(b.to(dev), x.to(dev), y.to(dev), m.to(dev).float()) for b, x, y, m in batches]

    # strict first-batch check: fused against the oracle, atol 0.01 over all nodes
    batch0 = batches[0][0]
    conv = make_conv("gt", args.dim, args.dim, args.heads,
                     generator=torch.Generator().manual_seed(1), device=dev)
    xf = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (batch0.n_graphs * batch0.np_pad, args.dim)).astype(np.float32)).to(dev)
    with torch.no_grad():
        out_f = conv(batch0, xf)
        out_r = conv(batch0.to_graph(), xf, impl="reference")
    ok = bool(torch.allclose(out_f, out_r, rtol=1e-5, atol=0.01))  # np.allclose, atol 0.01
    if not ok:
        print("STRICT CHECK FAILED (atol=0.01)")
        sys.exit(1)
    print("strict fused-vs-unfused check: OK")

    def fw(b, x, y, m):
        with torch.no_grad():
            return loss_fn(b, x, y, m)

    def fwbw(b, x, y, m):
        loss = loss_fn(b, x, y, m)
        return loss.detach(), torch.autograd.grad(loss, params)

    before = flash_mask.launch_counts()
    fwbw(*batches[0])
    launches = [a - b for a, b in zip(flash_mask.launch_counts(), before)]

    def timed(fn, reps=5):
        fn(*batches[0])
        synchronize(dev)
        if dev.type != "cuda":
            for b in batches:
                fn(*b)
            return None
        t0 = time.perf_counter()
        for _ in range(reps):
            for b in batches:
                fn(*b)
        synchronize(dev)
        return (time.perf_counter() - t0) / (reps * len(batches)) * 1e3

    t_fw, t_fwbw = timed(fw), timed(fwbw)
    t_bw = None if t_fw is None else t_fwbw - t_fw
    cell = lambda t: "not measured" if t is None else f"{t:.2f}"
    print(github_table(["dataset", "preprocess ms", "forward ms", "backward ms", "fw+bw ms"],
                       [[args.dataset, f"{prep_ms:.2f}", cell(t_fw), cell(t_bw),
                         cell(t_fwbw)]]))
    return {"preprocess_ms": prep_ms, "forward_ms": t_fw, "backward_ms": t_bw,
            "fwbw_ms": t_fwbw, "ok": ok, "launches": launches, "n_batches": len(batches)}


if __name__ == "__main__":
    main()
