"""One training step of each multi-device regime, and its one-process twin.

The twin of the JAX package's ``__graft_entry__.dryrun_multichip``, as an
SPMD program over ``torch.distributed``: every rank of the world calls
:func:`dryrun_multichip` at once, on tiny shapes made from numpy seeds.

- data parallel: the 2-layer ``GTModel`` (hidden 16) over a batch of
  ``2 * n`` small graphs, each rank stepping its own graphs through
  ``DistributedDataParallel`` and Adam;
- the edge-partitioned graph: one attention layer between two weight
  matrices on a ``16 * n``-node graph, the halo plan with its transpose (the
  fused distributed backward), the weight gradients summed over the ranks;
- tensor parallel (an even world): a ``(n / 2, 2)`` mesh, the q, k, v
  weights split by columns (``shard_params_tp``), the two heads split over
  the ``model`` axis (``head_sharded_attention``).

Each step runs twice and returns its losses, and the launches of kernels #1
and #3 it made on this rank (a DenseBatch step on a card launches both; the
CPU runs their plain versions and counts none); :func:`single_process` runs
the same steps in one process on the whole batch, graph and weights, so the
two agree to rounding.

    torchrun --nproc-per-node 4 -m dfgnn_tpu_torch.scripts.dryrun_multichip
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from dfgnn_tpu_torch.data.synthetic import small_graph_batch
from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.graph import DenseBatch, Graph
from dfgnn_tpu_torch.models import GTModel
from dfgnn_tpu_torch.ops import flash_mask, graph_attention
from dfgnn_tpu_torch.parallel import comm
from dfgnn_tpu_torch.parallel.dist import (
    batch_sharding, make_mesh, mesh_group_rank, replicate, shard_dense_batch,
)
from dfgnn_tpu_torch.parallel.multihost import initialize_or_single
from dfgnn_tpu_torch.parallel.partition import partition_graph, shard_nodes
from dfgnn_tpu_torch.parallel.tensor import head_sharded_attention, make_tp_mesh, shard_params_tp

STEPS = 2
HEADS, HS, TP_GRAPHS = 2, 16, 4


def _dp_data(n: int, device):
    rng = np.random.default_rng(0)
    B = 2 * n
    graphs = [(r, c, nn_) for r, c, nn_, _ in small_graph_batch(rng, B, mean_nodes=30, deg=4)]
    batch = DenseBatch.from_graph_list(graphs, np_pad=128, device=device)
    x = torch.from_numpy(rng.integers(0, 3, size=(B, batch.np_pad))).to(device)
    y = torch.from_numpy(rng.integers(0, 2, size=(B,))).to(device)
    return batch, x, y


def _dp_model(device):
    return GTModel("PATTERN", out_size=2, hidden_size=16, num_layers=2,
                   generator=torch.Generator().manual_seed(0), device=device)


def _fg_data(n_dev: int, device):
    rng = np.random.default_rng(1)
    n, deg = 16 * n_dev, 4
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=n * deg)
    feat = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, 3, size=(n,))).to(device)
    w1 = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32) * 0.1).to(device)
    w2 = torch.from_numpy(rng.standard_normal((16, 3)).astype(np.float32) * 0.1).to(device)
    return rows, cols, n, feat, labels, [w1, w2]


def _fg_loss(attend, ws, feat, labels, keep, n):
    """Summed NLL of the rows ``keep`` marks, over ``n``: the mean over the
    graph once the ranks' parts are summed (padding rows count for none)."""
    h = attend((feat @ ws[0]).reshape(-1, 1, 16))
    lp = torch.log_softmax(h.reshape(-1, 16) @ ws[1], dim=-1)
    return -lp.gather(1, labels[:, None])[keep].sum() / n


def _tp_data(device):
    rng = np.random.default_rng(2)
    graphs = [(r, c, nn_) for r, c, nn_, _ in
              small_graph_batch(rng, TP_GRAPHS, mean_nodes=20, deg=4)]
    batch = DenseBatch.from_graph_list(graphs, np_pad=128, device=device)
    xf = torch.from_numpy(rng.standard_normal(
        (TP_GRAPHS * batch.np_pad, HS)).astype(np.float32)).to(device)
    ws = {name: torch.from_numpy(rng.standard_normal((HS, HS)).astype(np.float32) * 0.1)
          .to(device) for name in ("q_proj", "k_proj", "v_proj")}
    return batch, xf, ws


def _heads_of(batch, y):
    return y.reshape(batch.n_graphs, batch.np_pad, HEADS, -1)


def _adam_steps(model, loss_of, average=None):
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = loss_of()
        loss.backward()
        opt.step()
        loss = loss.detach()
        losses.append(float(loss if average is None else average(loss)))
    return losses


def _sgd_steps(ws, loss_of, grad_reduce=None, total=None):
    """Plain SGD (lr 1e-2) on a list of leaf tensors, as the JAX step does."""
    ws = [w.clone().requires_grad_() for w in ws]
    losses = []
    for _ in range(STEPS):
        loss = loss_of(ws)
        grads = torch.autograd.grad(loss, ws)
        if grad_reduce is not None:
            grads = [grad_reduce(g) for g in grads]
        with torch.no_grad():
            for w, g in zip(ws, grads):
                w -= 1e-2 * g
        losses.append(float(loss.detach() if total is None else total(loss.detach())))
    return losses


def _counted(launches, key, fn):
    """``fn()``, with the launches of #1 and #3 it made kept in ``launches``."""
    before = flash_mask.launch_counts()[:2]
    res = fn()
    launches[key] = [a - b for a, b in zip(flash_mask.launch_counts()[:2], before)]
    return res


def dryrun_multichip(device="cuda") -> dict:
    """Every rank of the world runs the three steps; returns their losses
    (the whole step's, the same on every rank) and, under ``"launches"``,
    this rank's launches of #1 and #3 in each."""
    dev = resolve_device(device)
    n = dist.get_world_size()
    mesh = make_mesh(n, device=dev.type)
    group, rank = mesh_group_rank(mesh)
    out, launches = {}, {}

    # data parallel: this rank's graphs, gradients averaged by DDP
    batch, x, y = _dp_data(n, dev)
    model = replicate(_dp_model(dev), mesh)
    ddp = torch.nn.parallel.DistributedDataParallel(
        model, process_group=group, device_ids=[dev.index] if dev.type == "cuda" else None)
    local, cut = shard_dense_batch(batch, mesh), batch_sharding(mesh)
    out["dp"] = _counted(launches, "dp", lambda: _adam_steps(
        ddp, lambda: F.cross_entropy(ddp(local, cut(x).reshape(-1)), cut(y)),
        average=lambda loss: comm.all_reduce_sum(loss, group) / n))

    # the edge-partitioned graph: halo exchange, fused distributed backward
    rows, cols, nn_, feat, labels, ws = _fg_data(n, dev)
    g = Graph.from_coo(rows, cols, nn_, device="cpu")
    pg = partition_graph(g, n, halo=n > 1, with_transpose=True, mesh=mesh)
    feat_l, labels_l = shard_nodes(pg, feat, rank), shard_nodes(pg, labels, rank)
    keep = shard_nodes(pg, torch.ones(nn_, dtype=torch.bool, device=dev), rank)
    out["partitioned"] = _counted(launches, "partitioned", lambda: _sgd_steps(
        ws, lambda w: _fg_loss(lambda h: graph_attention(pg, h, h, h), w, feat_l, labels_l,
                               keep, nn_),
        grad_reduce=lambda gr: comm.all_reduce_sum(gr, group),
        total=lambda loss: comm.all_reduce_sum(loss, group)))

    # tensor parallel over a (n / 2, 2) mesh
    if n >= 2 and n % 2 == 0:
        tp_mesh = make_tp_mesh(n // 2, 2, device=dev.type)
        mgroup, _ = mesh_group_rank(tp_mesh, "model")
        batch, xf, full = _tp_data(dev)
        names = list(full)
        local_w = shard_params_tp(full, tp_mesh)

        def tp_loss(w):
            # the column-parallel projections, gathered into all heads
            # (backward: each rank's columns get every rank's cotangent)
            qkv = [_heads_of(batch, comm.all_gather((xf @ wi).t(), mgroup).t()) for wi in w]
            o = head_sharded_attention(tp_mesh, batch, *qkv)
            return (o.float() ** 2).sum() / (xf.shape[0] * HS)
        out["tp"] = _counted(launches, "tp", lambda: _sgd_steps(
            [local_w[k] for k in names], tp_loss,
            total=lambda loss: comm.all_reduce_sum(loss, mgroup)))
    out["launches"] = launches
    return out


def single_process(n: int, device="cuda") -> dict:
    """The same steps in one process, on the whole batch, graph and weights,
    for a world of ``n`` ranks."""
    dev = resolve_device(device)
    out = {}
    batch, x, y = _dp_data(n, dev)
    model = _dp_model(dev)
    out["dp"] = _adam_steps(model, lambda: F.cross_entropy(model(batch, x.reshape(-1)), y))

    rows, cols, nn_, feat, labels, ws = _fg_data(n, dev)
    g = Graph.from_coo(rows, cols, nn_, device=dev)
    out["partitioned"] = _sgd_steps(
        ws, lambda w: _fg_loss(lambda h: graph_attention(g, h, h, h), w, feat, labels,
                               torch.ones(nn_, dtype=torch.bool, device=dev), nn_))

    if n >= 2 and n % 2 == 0:
        batch, xf, full = _tp_data(dev)

        def tp_loss(w):
            o = graph_attention(batch, *(_heads_of(batch, xf @ wi) for wi in w))
            return (o.float() ** 2).sum() / (xf.shape[0] * HS)
        out["tp"] = _sgd_steps(list(full.values()), tp_loss)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="torch device to run on")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    started = initialize_or_single(dev)
    try:
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        got = dryrun_multichip(dev)
        want = single_process(dist.get_world_size(), dev)
        if dist.get_rank() == 0:
            print(json.dumps({"world": dist.get_world_size(), "dist": got, "single": want}))
        return {"dist": got, "single": want}
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
