"""Where a train step's device time goes, on the card.

    python -m dfgnn_tpu_torch.scripts.profile_train_step [--model gt|gat|sampled]
        [--impl auto|dense|flash_fused]

Builds, with random weights from a seed, the main path's GTModel
(``--model gt``: ogbg-molhiv, hidden 128, 8 layers, 1 head, one collated
bs=1024 batch), the GAT step's ``FullGraphNet("gat")`` (``--model gat``:
hidden 64, 2 layers, a bs=1024 PATTERN-like batch with noisy one-hot
features, as ``chip_smoke.py`` times it) or the sampled trainer's
``SampledNet`` (``--model sampled``: the arxiv stand-in's first bs=1024
batch of localized blocks, fanouts 8, 8, dim 64; the host sampling is not
in the step), and reports for a train step (forward, backward, Adam
update):
- phase times from CUDA events (3 warmups, mean of 10 runs): the forward
  with its loss, the backward (forward + backward less the forward) and the
  optimizer's step alone;
- device time by kernel group over 5 profiled steps (``torch.profiler``;
  its annotations on the device timeline are not kernels and are left out),
  and the device's idle share under the profiler: 1 - (union of kernel
  intervals) / (first kernel start to last kernel end).
The whole step's time and its peak memory are ``chip_smoke.py``'s.  Prints
the numbers and a JSON line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from dfgnn_tpu_torch.data.collate import collate_dense
from dfgnn_tpu_torch.data.datasets import load_batched, load_full_graph
from dfgnn_tpu_torch.data.sampling import NeighborSampler
from dfgnn_tpu_torch.data.synthetic import pattern_like_batch
from dfgnn_tpu_torch.graph import DenseBatch, Graph
from dfgnn_tpu_torch.models import FullGraphNet, GTModel
from dfgnn_tpu_torch.ops.bucket import _take
from dfgnn_tpu_torch.scripts.train_sampled import FANOUTS, SampledNet
from dfgnn_tpu_torch.train.parity import _noisy_onehot
from dfgnn_tpu_torch.train import TrainState, make_loss_fn, train_step
from dfgnn_tpu_torch.utils.benchmark import benchmark

DATASET, DIM, LAYERS, BATCH, PROFILED_STEPS = "ogbg-molhiv", 128, 8, 1024, 5
GAT_HIDDEN, GAT_LAYERS, NP_PAD = 64, 2, 128
SAMPLED_BATCH, SAMPLED_DIM = 1024, 64
GROUPS = (  # (group, substrings of kernel names), first match wins
    ("attention forward kernel #1", ("DotScore",)),  # flash_fwd_kernel<DotScore<...>, ...>
    # before #2's group: LayerAddScore contains AddScore
    ("whole-layer kernel #6", ("LayerAddScore",)),
    ("attention forward kernel #2", ("AddScore",)),
    ("attention backward kernel #4", ("flash_add_bwd",)),
    ("attention backward kernel #3", ("flash_mask_bwd_whole", "flash_mask_bwd_rows",
                                      "flash_mask_bwd_cols")),
    ("whole-layer kernel #5", ("LayerScore",)),  # flash_fwd_kernel<LayerScore<...>, ...>
    ("matrix products (cuBLAS)", ("gemm", "Gemm", "cutlass", "splitK", "dot_kernel")),
    ("Adam", ("multi_tensor_apply", "adam", "Adam")),
    ("embedding and row gathers", ("embedding", "Embedding", "indexSelect", "index_select")),
)


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(key in name for key in keys):
            return group
    return "other (elementwise, reductions, copies)"


def _busy_us(intervals) -> float:
    busy, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="gt", choices=["gt", "gat", "sampled"])
    p.add_argument("--impl", default="auto", choices=["auto", "dense", "flash_fused"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("this script profiles a CUDA card, and none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()

    if args.model == "gt":
        ds = load_batched(DATASET, n_graphs=BATCH, quiet=True)
        batch, x, y, m = collate_dense(ds, np.arange(BATCH), np_pad=NP_PAD)
        model = GTModel(DATASET, out_size=ds.num_classes, hidden_size=DIM, num_layers=LAYERS,
                        in_size=ds.in_dim, generator=torch.Generator().manual_seed(0))
        state = TrainState.create(model, lr=1e-3, step_lr_every=20)
        base = make_loss_fn(model, ds.task, ds.num_classes)
        what = f"{DATASET} bs={BATCH}, GTModel dim {DIM}, {LAYERS} layers"
    elif args.model == "sampled":
        ds = load_full_graph("arxiv", quiet=True)
        bs = SAMPLED_BATCH
        seeds = np.nonzero(ds.train_mask)[0][:bs]
        blocks, sup = NeighborSampler(Graph.from_coo(ds.rows, ds.cols, ds.n_nodes)
                                      ).sample_localized(seeds, FANOUTS, seed=0,
                                                         pad_to=[bs, bs * 9],
                                                         support_pad=bs * 81)
        batch = [b.to("cuda") for b in blocks]
        feats = np.concatenate([ds.features[:, :SAMPLED_DIM], np.zeros((1, SAMPLED_DIM))])
        x = _take(torch.from_numpy(feats.astype(np.float32)).cuda(),
                  torch.from_numpy(sup).cuda())
        y = torch.from_numpy(np.asarray(ds.labels)[seeds]).cuda()
        m = torch.ones(bs, device="cuda")
        model = SampledNet(SAMPLED_DIM, SAMPLED_DIM, ds.num_classes,
                           generator=torch.Generator().manual_seed(0))
        state = TrainState.create(model, lr=1e-3)
        base = lambda blocks, x, y, m, impl=None: F.cross_entropy(model(blocks, x)[:bs], y)
        what = (f"arxiv stand-in, SampledNet dim {SAMPLED_DIM}, fanouts {list(FANOUTS)}, "
                f"bs={bs}")
    else:
        rng = np.random.default_rng(7)
        graphs = pattern_like_batch(rng, BATCH)
        batch = DenseBatch.from_graph_list([(r, c, n) for r, c, n, _ in graphs], np_pad=NP_PAD)
        xn = np.zeros((BATCH * NP_PAD, 2), dtype=np.float32)
        yn = np.zeros(BATCH * NP_PAD, dtype=np.int64)
        for b, (_, _, n, block) in enumerate(graphs):
            xn[b * NP_PAD: b * NP_PAD + n] = _noisy_onehot(rng, block, 2)
            yn[b * NP_PAD: b * NP_PAD + n] = block
        x, y = torch.from_numpy(xn).cuda(), torch.from_numpy(yn).cuda()
        m = batch.node_mask.reshape(-1).float()
        model = FullGraphNet("gat", num_classes=2, hidden_size=GAT_HIDDEN,
                             num_layers=GAT_LAYERS, in_size=2,
                             generator=torch.Generator().manual_seed(5))
        state = TrainState.create(model, lr=1e-2)
        base = make_loss_fn(model, "node_classification", 2)
        what = (f"PATTERN-like bs={BATCH}, FullGraphNet(gat) hidden {GAT_HIDDEN}, "
                f"{GAT_LAYERS} layers")
    loss_fn = lambda *a: base(*a, impl=args.impl)  # noqa: E731

    def fwd_bwd():
        state.opt.zero_grad(set_to_none=True)
        loss_fn(batch, x, y, m).backward()

    fwd_ms = benchmark(lambda: loss_fn(batch, x, y, m))[1]
    fb_ms = benchmark(fwd_bwd)[1]
    opt_ms = benchmark(state.opt.step)[1]  # the gradients of the last fwd_bwd

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILED_STEPS):
            train_step(state, loss_fn, batch, x, y, m)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > 0
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    by_group: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_group[_group(e.name)] = by_group.get(_group(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])

    n = PROFILED_STEPS
    print(f"train step, {what}, impl={args.impl}, fp32 ({smi})")
    print(f"  CUDA events: forward + loss {fwd_ms:.4f} ms, backward {fb_ms - fwd_ms:.4f} ms, "
          f"Adam step {opt_ms:.4f} ms")
    print(f"  profiler over {n} steps, per step: device busy {busy / n / 1e3:.4f} ms of "
          f"{span / n / 1e3:.4f} ms, idle share {1 - busy / span:.4f}")
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"    {group}: {us / n / 1e3:.4f} ms ({us / busy:.1%} of busy)")
    print("  top kernels, per step:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / n / 1e3:.4f} ms  {name[:110]}")
    result = {"model": args.model, "impl": args.impl, "device": smi, "forward_ms": fwd_ms,
              "backward_ms": fb_ms - fwd_ms, "optimizer_ms": opt_ms,
              "idle_share_profiled": 1 - busy / span,
              "groups_ms": {g: us / n / 1e3 for g, us in by_group.items()}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
