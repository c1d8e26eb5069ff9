"""Mini-batch training on a large full graph by neighbourhood sampling, with PyTorch.

The twin of the JAX package's ``scripts/train_sampled.py``: GraphSAGE-style
layered sampling (fanouts 8, 8) feeds fixed-fanout sampled blocks to the
bucket attention path; every batch has the same shapes.  Features stay
block-local between layers (``sample_localized``): every tensor in a step
is O(batch * prod(fanouts)), and the full graph enters only through one
gather of the input features.  Adam at optax's defaults, softmax
cross-entropy; the test accuracy comes from sampled inference.

``--compare-full`` then trains the same two-layer model, from the same
initial weights, on the whole graph (``formats.preprocess("bucketed", g)``)
for as many steps, and prints the ``[sampled]``, ``[full]`` and
``[compare]`` lines.  The weights come from a ``torch.Generator`` seeded
with ``--seed``.  Steps/s is host-clock; the device ms per step are CUDA
events around each step, the host seconds of sampling are the host clock
around the sampler, and each run's peak is ``torch.cuda.max_memory_allocated``
above what was allocated when the run began (its data and layout
included; the full run begins after the sampled one).  It runs on the
card unless ``--device cpu`` is given; on the CPU it reads no device time
or memory.

    python -m dfgnn_tpu_torch.scripts.train_sampled --dataset arxiv --dim 64 --epochs 3 \\
        --batch-size 1024 [--compare-full] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dfgnn_tpu_torch import formats
from dfgnn_tpu_torch.data.datasets import load_full_graph
from dfgnn_tpu_torch.data.sampling import NeighborSampler
from dfgnn_tpu_torch.device import resolve_device, synchronize
from dfgnn_tpu_torch.graph import Graph
from dfgnn_tpu_torch.models.conv import GTConv, linear
from dfgnn_tpu_torch.ops.bucket import _take
from dfgnn_tpu_torch.train import TrainState
from dfgnn_tpu_torch.utils.config import build_parser, parse_args

FANOUTS = (8, 8)


class SampledNet(nn.Module):
    """Dense -> one GTConv per sampled block -> Dense.  Conv i runs on
    ``reversed(blocks)[i]``, so each layer's rows are the next frontier and
    the blocks' local ids chain the layers' outputs: no tensor of the full
    graph's size exists in a step.  The flax names map through
    :func:`dfgnn_tpu_torch.weights.sampled_net_params_from_flax`."""

    def __init__(self, in_size: int, hidden: int, n_classes: int, n_layers: int = 2, *,
                 generator: torch.Generator, device="cuda"):
        super().__init__()
        self.input_proj = linear(in_size, hidden, generator, device)
        self.convs = nn.ModuleList(GTConv(hidden, hidden, generator=generator, device=device)
                                   for _ in range(n_layers))
        self.output_proj = linear(hidden, n_classes, generator, device)

    def forward(self, blocks, x_sup: torch.Tensor) -> torch.Tensor:
        h = self.input_proj(x_sup)
        for conv, blk in zip(self.convs, reversed(blocks)):
            h = conv(blk, h)
        return self.output_proj(h)


class FullNet(SampledNet):
    """The same layers over one whole-graph layout."""

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        h = self.input_proj(x)
        for conv in self.convs:
            h = conv(g, h)
        return self.output_proj(h)


def _start_peak(dev) -> int:
    """Resets the peak and returns the bytes allocated now (0 on the CPU)."""
    if dev.type != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def _peak_mib(dev, start: int):
    """The peak since :func:`_start_peak` above ``start``, in MiB."""
    if dev.type != "cuda":
        return None
    return (torch.cuda.max_memory_allocated(dev) - start) / 2 ** 20


def _fmt(x, spec: str, unit: str = "") -> str:
    return "not measured" if x is None else f"{x:{spec}}{unit}"


def main(argv=None) -> dict:
    """Returns the sampled run's per-step losses, test accuracy, steps/s,
    host seconds of sampling per step, device ms per step (CUDA events around
    each step, so host launch gaps count) and peak MiB (the
    device numbers None on the CPU); with ``--compare-full`` the full run's
    losses, accuracy, steps/s and peak, and the accuracy gap."""
    p = build_parser(__doc__)
    p.add_argument("--compare-full", action="store_true",
                   help="also train the same 2-layer model on the whole graph (bucket path) "
                        "from the same initial weights, and print the comparison")
    p.add_argument("--device", type=str, default="cuda", help="torch device to train on")
    args = parse_args(p, argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = _start_peak(dev)

    ds = load_full_graph(args.dataset, args.data_dir)
    n = ds.n_nodes
    g = Graph.from_coo(ds.rows, ds.cols, n, device=dev)
    sampler = NeighborSampler(g)
    bs = args.batch_size
    # fixed per-layer seed caps and input-support cap: every batch has the
    # same shapes, and a step costs O(batch * fanout^2) whatever n is
    pad_to = [bs, bs * (FANOUTS[0] + 1)]
    support_pad = bs * (FANOUTS[0] + 1) * (FANOUTS[1] + 1)

    feats = ds.features[:, : args.dim].astype(np.float32)
    if feats.shape[1] < args.dim:
        feats = np.pad(feats, [(0, 0), (0, args.dim - feats.shape[1])])
    # one sentinel row, so support gathers of padded slots read zeros
    x_full = torch.from_numpy(np.concatenate([feats, np.zeros((1, args.dim), np.float32)])
                              ).to(dev)
    y_full = np.asarray(ds.labels, dtype=np.int64)
    train_ids = np.nonzero(np.asarray(ds.train_mask))[0]
    test_ids = np.nonzero(np.asarray(ds.test_mask))[0]

    def sample(seeds, seed):
        t0 = time.perf_counter()
        blocks, sup = sampler.sample_localized(seeds, FANOUTS, seed=seed, pad_to=pad_to,
                                               support_pad=support_pad)
        host_s = time.perf_counter() - t0
        return [b.to(dev) for b in blocks], torch.from_numpy(sup).to(dev), host_s

    def make(cls):
        return cls(args.dim, args.dim, ds.num_classes, len(FANOUTS),
                   generator=torch.Generator().manual_seed(args.seed), device=dev)

    model = make(SampledNet)
    state = TrainState.create(model, lr=args.lr, device=dev)

    rng = np.random.default_rng(0)
    losses, sample_s, events = [], [], []
    steps_total, t_train = 0, 0.0
    for epoch in range(args.epochs):
        synchronize(dev)
        t0 = time.perf_counter()
        ep_losses = []
        order = rng.permutation(train_ids)
        for s in range(0, len(order) - bs + 1, bs):
            seeds = order[s: s + bs]
            blocks, sup, host_s = sample(seeds, epoch * 7919 + s)
            sample_s.append(host_s)
            y = torch.from_numpy(y_full[seeds]).to(dev)
            if dev.type == "cuda":
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            state.opt.zero_grad(set_to_none=True)
            logits = model(blocks, _take(x_full, sup))[:bs]
            loss = F.cross_entropy(logits, y)
            loss.backward()
            state.opt.step()
            if dev.type == "cuda":
                ev[1].record()
                events.append(ev)
            ep_losses.append(loss.detach())
        ep_losses = [float(x) for x in ep_losses]
        synchronize(dev)
        dt = time.perf_counter() - t0
        losses += ep_losses
        steps_total += len(ep_losses)
        t_train += dt
        print(f"epoch {epoch}: loss={np.mean(ep_losses):.4f} ({len(ep_losses)} steps, "
              f"{dt:.2f}s)", flush=True)

    def eval_acc(ids):
        """Sampled inference over ``ids`` (a fresh draw per batch)."""
        hits = tot = 0
        with torch.no_grad():
            for s in range(0, len(ids) - bs + 1, bs):
                seeds = ids[s: s + bs]
                blocks, sup, _ = sample(seeds, 999_000 + s)
                pred = model(blocks, _take(x_full, sup))[:bs].argmax(-1).cpu().numpy()
                hits += int((pred == y_full[seeds]).sum())
                tot += bs
        return hits / max(tot, 1)

    acc_sampled = eval_acc(test_ids)
    res = {
        "losses": losses, "acc_sampled": acc_sampled, "steps": steps_total,
        "steps_per_s": steps_total / t_train if t_train > 0 else None,
        "sample_s_per_step": float(np.mean(sample_s)) if sample_s else None,
        "device_ms_per_step": (float(np.mean([a.elapsed_time(b) for a, b in events]))
                               if events else None),
        "peak_mib": _peak_mib(dev, start),
    }
    print(f"[sampled] test acc={acc_sampled:.4f}  steps/s={_fmt(res['steps_per_s'], '.2f')}  "
          f"host sampling={_fmt(res['sample_s_per_step'], '.4f', 's')}/step  "
          f"device={_fmt(res['device_ms_per_step'], '.3f', 'ms')}/step  "
          f"peak_mem={_fmt(res['peak_mib'], '.1f', 'MiB')}", flush=True)
    if not args.compare_full:
        return res

    # the same depth and width on the whole graph, through the bucket path
    start = _start_peak(dev)
    bg = formats.preprocess("bucketed", g)
    fmodel = make(FullNet)
    fstate = TrainState.create(fmodel, lr=args.lr, device=dev)
    xf = x_full[:n]
    yf = torch.from_numpy(y_full).to(dev)
    tr_mask = torch.from_numpy(np.asarray(ds.train_mask, dtype=np.float32)).to(dev)
    synchronize(dev)
    t0 = time.perf_counter()
    flosses = []
    for _ in range(steps_total):  # as many optimizer steps as the sampled run
        fstate.opt.zero_grad(set_to_none=True)
        loss = torch.sum(F.cross_entropy(fmodel(bg, xf), yf, reduction="none") * tr_mask
                         ) / torch.sum(tr_mask)
        loss.backward()
        fstate.opt.step()
        flosses.append(loss.detach())
    synchronize(dev)
    ft = time.perf_counter() - t0
    with torch.no_grad():
        pred = fmodel(bg, xf).argmax(-1).cpu().numpy()
    acc_full = float((pred[test_ids] == y_full[test_ids]).mean())
    res.update(full_losses=[float(x) for x in flosses], acc_full=acc_full,
               full_steps_per_s=steps_total / ft if ft > 0 else None,
               full_peak_mib=_peak_mib(dev, start), gap=acc_sampled - acc_full)
    print(f"[full]    test acc={acc_full:.4f}  steps/s={_fmt(res['full_steps_per_s'], '.2f')}  "
          f"peak_mem={_fmt(res['full_peak_mib'], '.1f', 'MiB')} (a full-graph step touches "
          f"the whole graph; a sampled one O(batch*fanout^2))", flush=True)
    print(f"[compare] sampled-full acc gap = {res['gap']:+.4f}")
    return res


if __name__ == "__main__":
    main()
