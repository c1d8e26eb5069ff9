"""Fused-vs-unfused accuracy parity harness, the twin of :mod:`dfgnn_tpu.train.parity`.

The reference trains the fused and unfused paths on the same task and
compares the end metric.  :func:`run_parity_batched` does so on a
PATTERN-like batch of SBM graphs with noisy one-hot features: the fused
side is ``FullGraphNet`` through ``impl="flash"`` on a :class:`DenseBatch`
(the flash kernels on the card), or in bf16 through its auto route (the
whole-layer kernels for GAT), the unfused side the same model in fp32
through the segment-op oracle on the block-diagonal :class:`Graph`.
:func:`run_parity_full` does so on one SBM full graph (or a real dataset),
the fused side on its bucketed training layout (the bucket path's custom
backward).  Same init, data and Adam (optax's defaults), so the gap
isolates the fused path's numerics.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dfgnn_tpu_torch import formats
from dfgnn_tpu_torch.data.synthetic import pattern_like_batch, sbm_graph
from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.graph import DenseBatch, Graph
from dfgnn_tpu_torch.models import FullGraphNet
from dfgnn_tpu_torch.ops import flash_mask
from dfgnn_tpu_torch.train.loop import TrainState, evaluate_accuracy, make_loss_fn, train_step


def _noisy_onehot(rng, block, n_classes: int, noise: float = 0.3):
    """Features = one-hot(block), each row replaced by a random class with
    probability ``noise``: the planted signal a GNN recovers from its
    neighbours, so block classification is learnable and needs attention."""
    n = len(block)
    lab = np.where(rng.random(n) < noise, rng.integers(0, n_classes, size=n), block)
    return np.eye(n_classes, dtype=np.float32)[lab]


def _train(model, g, x, y, mask, steps: int, lr: float, impl, device, n_classes: int = 2):
    """Adam steps; per step the loss and the kernel launches: the attention
    forward (#1 and #2), backward (#3 and #4) and whole-layer (#5 and #6)
    kernels, dot and add summed."""
    state = TrainState.create(model, lr=lr, device=device)
    loss_fn = functools.partial(make_loss_fn(model, "node_classification", n_classes),
                                impl=impl)
    seen = []
    for _ in range(steps):
        before = flash_mask.launch_counts()
        _, loss = train_step(state, loss_fn, g, x, y, mask)
        fwd, bwd, add_fwd, add_bwd, layer, layer_add = (
            a - b for a, b in zip(flash_mask.launch_counts(), before))
        seen.append({"loss": float(loss), "fwd_launches": fwd + add_fwd,
                     "bwd_launches": bwd + add_bwd, "layer_launches": layer + layer_add})
    return seen


def _accuracy(model, g, x, y, mask, impl) -> float:
    with torch.no_grad():
        pred = model(g, x, impl=impl).argmax(dim=-1)
    return evaluate_accuracy(y.cpu().numpy(), pred.cpu().numpy(), mask.cpu().numpy())


def batched_inputs(seed: int = 0, n_graphs: int = 32, noise: float = 0.3, device="cuda"):
    """The batched harness's task: ``(batch, x, y, mask)``, a DenseBatch of
    ``n_graphs`` PATTERN-like SBM graphs at P=128 with noisy one-hot
    features ``[B*P, 2]``, block labels and the node mask, drawn from
    ``np.random.default_rng(seed)`` in the JAX harness's order."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    graphs = pattern_like_batch(rng, n_graphs)
    P = 128
    batch = DenseBatch.from_graph_list([(r, c, n) for r, c, n, _ in graphs], np_pad=P,
                                       device=dev)
    x = np.zeros((n_graphs * P, 2), dtype=np.float32)
    y = np.zeros(n_graphs * P, dtype=np.int64)
    for b, (_, _, n, block) in enumerate(graphs):
        x[b * P: b * P + n] = _noisy_onehot(rng, block, 2, noise)
        y[b * P: b * P + n] = block
    return (batch, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
            batch.node_mask.reshape(-1).float())


def run_parity_batched(seed: int = 0, n_graphs: int = 32, hidden: int = 32, layers: int = 2,
                       steps: int = 120, lr: float = 1e-2, conv: str = "gt",
                       noise: float = 0.3, dtype=None, device="cuda") -> dict:
    """PATTERN-like node classification: flash kernels against the oracle.

    The task is :func:`batched_inputs`'s; the weights are drawn from
    ``torch.Generator().manual_seed(seed)``.  ``dtype=torch.bfloat16`` trains
    the fused side in bf16 through the auto route (for GAT the whole-layer
    kernel #6) while the oracle stays fp32, as the JAX harness does.
    Returns the accuracies, their gap, the majority baseline and, per fused
    step, the loss and kernel launches.
    """
    dev = resolve_device(device)
    batch, x, y, mask = batched_inputs(seed, n_graphs, noise, dev)
    g_ref = batch.to_graph()
    kw = dict(conv=conv, num_classes=2, hidden_size=hidden, num_layers=layers, in_size=2,
              device=dev)
    model = FullGraphNet(**kw, dtype=dtype, generator=torch.Generator().manual_seed(seed))
    model_ref = FullGraphNet(**kw, generator=torch.Generator().manual_seed(seed))
    model_ref.load_state_dict(model.state_dict())
    # bf16: the fused side takes the auto route; fp32 keeps the explicit flash kernels
    fused_impl = None if dtype is not None else "flash"
    fused_steps = _train(model, batch, x, y, mask, steps, lr, fused_impl, dev)
    _train(model_ref, g_ref, x, y, mask, steps, lr, "reference", dev)
    acc_f = _accuracy(model, batch, x, y, mask, fused_impl)
    acc_u = _accuracy(model_ref, g_ref, x, y, mask, "reference")
    frac1 = float((y * mask).sum() / mask.sum())
    return {"task": "batched-SBM", "acc_fused": acc_f, "acc_unfused": acc_u,
            "gap": abs(acc_f - acc_u), "majority_baseline": max(frac1, 1.0 - frac1),
            "fused_steps": fused_steps}


def run_parity_full(seed: int = 0, n: int = 2000, n_blocks: int = 4, avg_deg: float = 20.0,
                    hidden: int = 32, layers: int = 2, steps: int = 120, lr: float = 1e-2,
                    conv: str = "gt", noise: float = 0.3, dataset=None,
                    device="cuda") -> dict:
    """Full-graph node classification: the bucket path against the oracle.

    An SBM graph of ``n`` nodes in ``n_blocks`` blocks with noisy one-hot
    features and a random half of the nodes for training, drawn from
    ``np.random.default_rng(seed)`` in the JAX harness's order; or a real
    ``dataset`` (a non-synthetic :class:`FullGraphDataset`) with its
    features and labels.  The fused side trains on
    ``preprocess("bucketed_train", g, split_width=64)`` through ``auto``
    (the bucket path and its custom backward), the unfused side on the
    Graph through the oracle; the weights are drawn from
    ``torch.Generator().manual_seed(seed)``.  Returns the accuracies on the
    other half, their gap, the majority baseline and the fused losses.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if dataset is not None and not dataset.synthetic:
        rows, cols, n = dataset.rows, dataset.cols, dataset.n_nodes
        x = np.asarray(dataset.features, dtype=np.float32)
        y = np.asarray(dataset.labels, dtype=np.int64)
        n_classes = int(y.max()) + 1
        name = dataset.name
    else:
        rows, cols, block = sbm_graph(rng, n, n_blocks=n_blocks, avg_deg=avg_deg)
        x = _noisy_onehot(rng, block, n_blocks, noise)
        y = block.astype(np.int64)
        n_classes = n_blocks
        name = "full-SBM"
    train_mask = (rng.random(n) < 0.5).astype(np.float32)
    test_mask = 1.0 - train_mask

    g = Graph.from_coo(rows, cols, n, device=dev)
    bg = formats.preprocess("bucketed_train", g, split_width=64)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    train_m, test_m = torch.from_numpy(train_mask).to(dev), torch.from_numpy(test_mask).to(dev)
    kw = dict(conv=conv, num_classes=n_classes, hidden_size=hidden, num_layers=layers,
              in_size=x.shape[1], device=dev)
    model = FullGraphNet(**kw, generator=torch.Generator().manual_seed(seed))
    model_ref = FullGraphNet(**kw, generator=torch.Generator().manual_seed(seed))
    model_ref.load_state_dict(model.state_dict())
    fused_steps = _train(model, bg, xt, yt, train_m, steps, lr, None, dev, n_classes)
    _train(model_ref, g, xt, yt, train_m, steps, lr, "reference", dev, n_classes)
    acc_f = _accuracy(model, bg, xt, yt, test_m, None)
    acc_u = _accuracy(model_ref, g, xt, yt, test_m, "reference")
    counts = np.bincount(y[test_mask.astype(bool)], minlength=n_classes)
    base = float(counts.max() / max(counts.sum(), 1))
    return {"task": name, "acc_fused": acc_f, "acc_unfused": acc_u,
            "gap": abs(acc_f - acc_u), "majority_baseline": base,
            "fused_steps": fused_steps}
