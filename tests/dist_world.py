"""A world of processes on this machine for the multi-device tests, and what
each rank of it computes.  Imports torch and the port only, so the card's
tests use it too, and its processes start without JAX.

:func:`start_world` spawns the ranks over ``tcp://127.0.0.1`` on a free port,
each with one thread and a 60 s collective timeout; :meth:`World.results`
returns rank 0's result, raises a rank's traceback if one failed, and kills
the world when its deadline passes, so a hung world fails one test instead
of the run.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dfgnn_tpu_torch.formats import build_buckets
from dfgnn_tpu_torch.graph import Graph
from dfgnn_tpu_torch.ops.bucket import bucket_graph_attention
from dfgnn_tpu_torch.ops.edge_dropout import seed_from_generator
from dfgnn_tpu_torch.parallel import (
    dist_graph_attention, gather_nodes, head_sharded_attention, make_mesh, make_tp_mesh,
    partition_graph, shard_nodes,
)
from dfgnn_tpu_torch.parallel import comm
from dfgnn_tpu_torch.parallel.dist import mesh_group_rank
from dfgnn_tpu_torch.parallel.multihost import free_port
from dfgnn_tpu_torch.scripts import dryrun_multichip

TIMEOUT_S = 60


def _rank_main(rank, fn, world_size, port, backend, results, args_path):
    torch.set_num_threads(1)
    with open(args_path, "rb") as fh:
        args = pickle.load(fh)
    if torch.cuda.is_available():
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = fn(rank, world_size, *args)
        if rank == 0:
            results.put(out)
    except BaseException:
        # the parent raises the first failed rank's traceback, which may be
        # a peer's lost connection: each rank's own goes to stderr
        print(f"rank {rank} of {world_size} failed:\n{traceback.format_exc()}", file=sys.stderr,
              flush=True)
        raise
    finally:
        dist.destroy_process_group()


class World:
    """A running world; :meth:`results` waits for it, at most until the
    deadline."""

    def __init__(self, ctx, results, deadline, args_path):
        self._ctx, self._results, self._deadline = ctx, results, deadline
        self._args_path = args_path
        self._out = None

    def _kill(self):
        for p in self._ctx.processes:
            if p.is_alive():
                p.kill()
        for p in self._ctx.processes:
            p.join(5)

    def results(self):
        if self._out is not None:
            return self._out
        try:
            while True:
                # a rank's traceback is raised here as soon as it fails
                self._ctx.join(timeout=0.2)
                try:
                    self._out = self._results.get(timeout=0.2)
                    break
                except queue.Empty:
                    pass
                if time.monotonic() > self._deadline:
                    raise TimeoutError("the world passed its deadline")
            while not self._ctx.join(timeout=max(0.0, self._deadline - time.monotonic())):
                if time.monotonic() > self._deadline:
                    raise TimeoutError("the world passed its deadline while closing")
        except BaseException:
            self._kill()
            raise
        finally:
            os.unlink(self._args_path)
        return self._out


def start_world(fn, world_size: int, *args, backend: str = "gloo",
                timeout: float = 2 * TIMEOUT_S) -> World:
    """Starts ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes; rank 0's return value comes back through :meth:`World.results`."""
    # the arguments go by a file: a process's start waits until the child has
    # read its pickle, so large arguments would start the ranks one by one
    with tempfile.NamedTemporaryFile(suffix=".pkl", delete=False) as fh:
        pickle.dump(args, fh)
    results = mp.get_context("spawn").Queue()
    ctx = mp.start_processes(_rank_main, args=(fn, world_size, free_port(), backend, results,
                                               fh.name),
                             nprocs=world_size, join=False, start_method="spawn")
    return World(ctx, results, time.monotonic() + timeout, fh.name)


# ---------------------------------------------------------------------------
# What every rank computes: each plan of the cases, the head-parallel
# attention and the multi-device steps
# ---------------------------------------------------------------------------

def plan_case(rank, mesh, case, device):
    """One case on the partitioned path: the gathered output in the original
    order and, with a cotangent ``t``, the gradients of ``sum(out * t)``,
    numpy arrays."""
    g = Graph.from_coo(case["rows"], case["cols"], case["n"], device="cpu")
    pg = partition_graph(g, mesh.size(), mesh=mesh, **case["plan"])
    names = ("q", "k", "v") if case["score"] == "dot" else ("e_row", "e_col", "v")
    full = {k: torch.from_numpy(case[k]).to(device) for k in names}
    local = {k: shard_nodes(pg, x, rank).detach().requires_grad_() for k, x in full.items()}
    kw = dict(score=case["score"], dropout_rate=case.get("rate", 0.0),
              dropout_seed=case.get("seed"))
    if case["score"] == "dot":
        out = dist_graph_attention(pg, mesh, local["q"], local["k"], local["v"], **kw)
    else:
        out = dist_graph_attention(pg, mesh, None, None, local["v"], e_row=local["e_row"],
                                   e_col=local["e_col"], **kw)
    res = {"out": gather_nodes(pg, out.detach(), mesh).cpu().numpy(),
           "plan": {"halo": pg.halo is not None, "shared": pg.shared_segments is not None,
                    "segments": pg.segments is not None, "transpose": pg.transpose is not None,
                    "perm": pg.node_perm is not None,
                    "max_halo": None if pg.halo is None else pg.halo.max_halo,
                    "n_local": pg.n_local}}
    if case.get("t") is not None:
        t = shard_nodes(pg, torch.from_numpy(case["t"]).to(device), rank)
        (out * t).sum().backward()
        res["grads"] = {k: gather_nodes(pg, x.grad, mesh).cpu().numpy()
                        for k, x in local.items()}
    return res


def tp_case(mesh, case, device):
    """Head-parallel attention on one layout, the ranks' heads gathered."""
    group, _ = mesh_group_rank(mesh, "model")
    q, k, v = (torch.from_numpy(case[x]).to(device) for x in ("q", "k", "v"))
    o = head_sharded_attention(mesh, case["layout"].to(device), q, k, v)
    heads = comm.all_gather(o.movedim(-2, 0), group)
    return heads.movedim(0, -2).cpu().numpy()


def all_cases(rank, world_size, cases, tp_cases, device="cpu"):
    """Every plan case, the head-parallel cases and the multi-device steps."""
    dev = torch.device(device)
    # the first bucket call of a process may round a block of rows apart from
    # every later call on the CPU (ROADMAP.md section 3): warm it once
    rng = np.random.default_rng(0)
    rows, cols = rng.integers(0, 64, 512), rng.integers(0, 64, 512)
    x = torch.from_numpy(rng.standard_normal((64, 1, 8)).astype(np.float32)).to(dev)
    bucket_graph_attention(build_buckets(Graph.from_coo(rows, cols, 64, device=dev)), x, x, x)
    mesh = make_mesh(world_size, device=dev.type)
    out = {name: plan_case(rank, mesh, case, dev) for name, case in cases.items()}
    tp_mesh = make_tp_mesh(world_size // 2, 2, device=dev.type)
    out.update({name: tp_case(tp_mesh, case, dev) for name, case in tp_cases.items()})
    out["steps"] = dryrun_multichip.dryrun_multichip(dev)
    return out


def fail_on_rank(rank, world_size, bad):
    """Rank ``bad`` raises while the others wait in a collective."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()


# ---------------------------------------------------------------------------
# What every rank computes on the card (tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

# (name, partition_graph keywords, score, dropout rate)
CARD_PLANS = [("default", {}, "dot", 0.0), ("default_add", {}, "add", 0.0),
              ("halo", {"halo": True}, "dot", 0.0),
              ("transpose", {"with_transpose": True}, "dot", 0.0),
              ("transpose_halo_add", {"with_transpose": True, "halo": True}, "add", 0.0),
              ("bfs_halo_dropout", {"reorder": "bfs", "halo": True}, "dot", 0.3),
              ("transpose_dropout", {"with_transpose": True}, "dot", 0.3)]


def _super_graph(rng, n, deg, super_deg):
    """Random rows of about ``deg`` neighbours and row 0 with ``super_deg``."""
    rows = np.repeat(np.arange(n), rng.poisson(deg, n))
    cols = rng.integers(0, n, rows.size)
    rows = np.concatenate([rows, np.zeros(super_deg, np.int64)])
    cols = np.concatenate([cols, rng.choice(n, super_deg, replace=False)])
    key = np.unique(rows * n + cols)
    return key // n, key % n


def card_plans(rank, world_size, device="cuda"):
    """Each of CARD_PLANS on this card (every rank shares it) on a graph with a
    super row: rank 0 returns, per plan, the gathered output and gradients of
    ``sum(out ** 2)`` beside the unpartitioned bucket path's, as numpy."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    n, h, f = 600, 2, 16
    rows, cols = _super_graph(rng, n, 6, 400)
    g = Graph.from_coo(rows, cols, n, device="cpu")
    full = build_buckets(g.to(dev), min_width=8, split_width=256, ladder="x1.5",
                         with_transpose=True)
    mesh = make_mesh(world_size, device=dev.type)
    _, r = mesh_group_rank(mesh)
    out = {}
    for name, kw, score, rate in CARD_PLANS:
        pg = partition_graph(g, world_size, mesh=mesh, **kw)
        gen = torch.Generator(device=dev).manual_seed(len(out))
        xs = [torch.randn((n, h, f) if i == 2 or score == "dot" else (n, h), device=dev,
                          generator=gen) for i in range(3)]
        # the dropout seed: one draw of the same CPU generator on every rank
        seed = seed_from_generator(torch.Generator().manual_seed(7)) if rate else None
        full_in = [x.clone().requires_grad_() for x in xs]
        ab = ({} if score == "dot" else dict(e_row=full_in[0], e_col=full_in[1]))
        qk = full_in[:2] if score == "dot" else [None, None]
        want = bucket_graph_attention(full, *qk, full_in[2], score=score, **ab, dropout_rate=rate,
                                      dropout_generator=torch.Generator().manual_seed(7))
        (want ** 2).sum().backward()
        loc = [shard_nodes(pg, x, r).detach().requires_grad_() for x in xs]
        if score == "dot":
            got = dist_graph_attention(pg, mesh, *loc, dropout_rate=rate, dropout_seed=seed)
        else:
            got = dist_graph_attention(pg, mesh, None, None, loc[2], score="add", e_row=loc[0],
                                       e_col=loc[1], dropout_rate=rate, dropout_seed=seed)
        (got ** 2).sum().backward()
        out[name] = dict(
            got=[gather_nodes(pg, t, mesh).cpu().numpy()
                 for t in [got.detach()] + [x.grad for x in loc]],
            want=[t.cpu().numpy() for t in [want.detach()] + [x.grad for x in full_in]],
            shared=pg.shared_segments is not None)
    return out


def card_collectives(rank, world_size, device="cuda"):
    """Each collective of ``parallel.comm`` under gloo on CUDA tensors and on
    the same CPU tensors, forward and backward; rank 0 returns the pairs."""
    dev = torch.device(device)
    group = dist.group.WORLD
    gen = torch.Generator().manual_seed(rank)
    x = torch.randn((world_size * 3, 5), generator=gen)
    ops = {"all_to_all": lambda t: comm.all_to_all(t.reshape(world_size, 3, 5), group),
           "all_gather": lambda t: comm.all_gather(t, group),
           "all_reduce_sum": lambda t: comm.all_reduce_sum(t, group)}
    out = {}
    for name, op in ops.items():
        pair = []
        for d in (dev, torch.device("cpu")):
            t = x.to(d, copy=True).requires_grad_()
            y = op(t)
            (y * torch.arange(y.numel(), device=d).reshape(y.shape)).sum().backward()
            pair.append([y.detach().cpu().numpy(), t.grad.cpu().numpy()])
        out[name] = pair
    out["all_reduce_max"] = [comm.all_reduce_max(x.to(d), group).cpu().numpy()
                             for d in (dev, torch.device("cpu"))]
    return out
