"""The port's edge-partitioned plan against the JAX package's (CPU).

JAX runs only its host-side plan here, with ``mesh=None``:
``partition_graph``, ``balance_perm``, ``bfs_reorder``, ``lpa_reorder`` and
``reorder_graph``, all numpy.  Every array and int field of the port's plan
must equal JAX's.  The shard loop (every shard's local forward on the source
table its exchange would deliver) is held against the port's unpartitioned
bucket forward, itself held against JAX in ``tests/test_torch_full_graph.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dfgnn_tpu.graph import Graph as JaxGraph
from dfgnn_tpu.parallel import balance as jax_balance
from dfgnn_tpu.parallel import partition as jax_partition
from dfgnn_tpu.parallel import reorder as jax_reorder
from dfgnn_tpu_torch import formats
from dfgnn_tpu_torch.data.datasets import load_full_graph
from dfgnn_tpu_torch.graph import Graph
from dfgnn_tpu_torch.ops.bucket import bucket_graph_attention
from dfgnn_tpu_torch.ops.edge_dropout import seed_from_generator
from dfgnn_tpu_torch.parallel import (
    balance_perm, bfs_reorder, lpa_reorder, partition_graph, reorder_graph,
)
from dfgnn_tpu_torch.parallel.partition import _plan_widths
from dfgnn_tpu_torch.scripts import bench_partition_build
from helpers import random_graph_coo
from partition_shard_loop import shard_loop

FP32_TOL = dict(rtol=1e-4, atol=1e-5)


def _graph(n, avg_deg, seed, **kw):
    """(rows, cols, val or None) with zero-degree rows, one numpy seed."""
    return random_graph_coo(np.random.default_rng(seed), n, avg_deg, **kw)


def _assert_same(ours, theirs, path="pg"):
    """Every field of the port's dataclass equals the JAX struct's: tensors
    by value (int64 ids against JAX's int32), ints exactly, None as None."""
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        where = f"{path}.{f.name}"
        if a is None or b is None:
            assert a is None and b is None, where
        elif isinstance(a, tuple):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                _assert_same(x, y, f"{where}[{i}]")
        elif dataclasses.is_dataclass(a):
            _assert_same(a, b, where)
        elif isinstance(a, torch.Tensor):
            b = np.asarray(b)
            assert a.device.type == "cpu" and tuple(a.shape) == b.shape, where
            want = {"b": torch.bool, "f": torch.float32}.get(b.dtype.kind, torch.int64)
            assert a.dtype == want, (where, a.dtype)
            np.testing.assert_array_equal(a.numpy(), b, err_msg=where)
        else:
            assert type(a) is int and a == b, (where, a, b)


# (n, avg_deg, super_node_deg, with_val, n_devices, partition_graph keywords)
PLANS = {
    "default_shared_segments": (600, 5, 400, False, 4, {}),
    "halo": (300, 5, 0, False, 4, dict(halo=True)),
    "halo_segments": (300, 5, 150, True, 4, dict(halo=True, split_width=32)),
    "transpose": (300, 5, 150, False, 4, dict(with_transpose=True, split_width=32)),
    "bfs_halo": (300, 5, 0, False, 4, dict(reorder="bfs", halo=True)),
    "lpa": (300, 5, 0, False, 4, dict(reorder="lpa")),
    "balance_val": (300, 5, 150, True, 4, dict(balance=True, split_width=32)),
    "empty_tail": (10, 2, 0, False, 8, dict(halo=True)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_arrays_equal_jax(name):
    n, deg, sdeg, with_val, P, kw = PLANS[name]
    rows, cols, val = _graph(n, deg, 1, super_node_deg=sdeg, with_val=with_val)
    ours = partition_graph(Graph.from_coo(rows, cols, n, val=val, device="cpu"), P, **kw)
    theirs = jax_partition.partition_graph(JaxGraph.from_coo(rows, cols, n, val=val), P, **kw)
    _assert_same(ours, theirs)
    assert ours.padded_edges == theirs.padded_edges
    assert ours.comm_rows_per_device() == theirs.comm_rows_per_device()
    # the flavour builds what it is named for
    assert (ours.halo is not None) == kw.get("halo", False)
    assert (ours.shared_segments is not None) == (name in ("default_shared_segments",
                                                           "balance_val"))
    assert (ours.segments is not None) == (name in ("halo_segments", "transpose"))
    assert (ours.transpose is not None) == (name == "transpose")
    assert (ours.node_perm is not None) == (name not in ("halo", "halo_segments", "empty_tail"))
    if name == "empty_tail":
        assert ours.n_local * 5 == n  # devices 5 to 7 hold no row
    if ours.transpose is not None:
        assert torch.equal(ours.transpose.node_perm, ours.node_perm)


def test_permutations_equal_jax():
    rows, cols, _ = _graph(500, 4, 2, super_node_deg=300)
    n = 500
    for fn, jfn in ((bfs_reorder, jax_reorder.bfs_reorder),
                    (lpa_reorder, jax_reorder.lpa_reorder)):
        perm = fn(rows, cols, n)
        np.testing.assert_array_equal(perm, jfn(rows, cols, n))
        assert sorted(perm.tolist()) == list(range(n))
        for a, b in zip(reorder_graph(rows, cols, n, perm),
                        jax_reorder.reorder_graph(rows, cols, n, perm)):
            np.testing.assert_array_equal(a, b)
    deg = np.bincount(rows, minlength=n)
    for P in (3, 8):
        widths, use_seg = _plan_widths(deg, 8, 64, None)
        assert use_seg
        np.testing.assert_array_equal(
            balance_perm(deg, P, widths, 64, use_seg),
            jax_balance.balance_perm(deg, P, widths, 64, use_seg))


# (graph of PLANS, score, dropout rate, partition_graph keywords): plans
# without shared segments, whose forward needs the cross-device merge
LOOPS = {
    "allgather_dot": ("halo", "dot", 0.0, dict()),
    "allgather_dot_dropout": ("halo", "dot", 0.5, dict()),
    "halo_segments_add": ("halo_segments", "add", 0.0, dict(halo=True, split_width=32)),
    "transpose_dot": ("transpose", "dot", 0.0, dict(with_transpose=True, split_width=32)),
    "bfs_halo_dropout": ("bfs_halo", "dot", 0.5, dict(reorder="bfs", halo=True)),
    "empty_tail_add_dropout": ("empty_tail", "add", 0.5, dict(halo=True)),
}


@pytest.fixture(scope="module")
def warm_bucket_path():
    """One bucket forward before any compared one: on a loaded Xeon CPU
    (torch 2.13 with MKL 2024.2 and oneDNN 3.12) about one process in
    thirty gave, on its first call, a block of rows up to 6.8e-5 away from
    every later call on the same inputs; the port's code is the same on
    each call (ROADMAP.md section 3)."""
    rows, cols, _ = _graph(50, 3, 0)
    x = torch.ones(50, 1, 8)
    bucket_graph_attention(formats.build_buckets(Graph.from_coo(rows, cols, 50, device="cpu")),
                           x, x, x)


@pytest.mark.parametrize("name", list(LOOPS))
def test_shard_loop_equals_unpartitioned_forward(name, warm_bucket_path):
    graph, score, rate, kw = LOOPS[name]
    n, deg, sdeg, with_val, P, _ = PLANS[graph]
    rows, cols, val = _graph(n, deg, 1, super_node_deg=sdeg, with_val=with_val)
    pg = partition_graph(Graph.from_coo(rows, cols, n, val=val, device="cpu"), P, **kw)
    assert pg.shared_segments is None
    # with the transpose: the forward plan (balanced, per-device segments)
    # and the source-partitioned one, the forward over the transposed graph
    cases = [(pg, rows, cols)] + ([] if pg.transpose is None else
                                  [(pg.transpose, cols, rows)])
    rng = np.random.default_rng(5)
    h, f = 2, 8
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, k, v, er, ec = t(n, h, f), t(n, h, f), t(n, h, f), t(n, h), t(n, h)
    sc = (dict(score="dot") if score == "dot"
          else dict(score="add", e_row=er, e_col=ec))
    seed = seed_from_generator(torch.Generator().manual_seed(9))
    for plan, r, c in cases:
        bg = formats.build_buckets(Graph.from_coo(r, c, n, val=val, device="cpu"))
        want = bucket_graph_attention(bg, q, k, v, dropout_rate=rate,
                                      dropout_generator=torch.Generator().manual_seed(9), **sc)
        got = shard_loop(plan, q, k, v, seed=seed, rate=rate, **sc)
        torch.testing.assert_close(got, want, **FP32_TOL)
        if rate:
            # a mask off by one edge moves an output by O(1): the masks agree
            undropped = bucket_graph_attention(bg, q, k, v, **sc)
            assert (got - undropped).abs().max() > 0.1


def test_bench_partition_build_twin(capsys):
    rows = bench_partition_build.main(["--scale", "0.01", "--devices", "2", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("graph: n=") and out[1].split() == [
        "P", "halo", "build_s", "pad", "max_halo", "halo_frac"]
    assert [(r["devices"], r["halo"]) for r in rows] == [
        (2, False), (4, False), (2, True), (4, True)]
    assert len(out) == 2 + len(rows)
    ds = load_full_graph("reddit", scale=0.01, quiet=True)
    jg = JaxGraph.from_coo(ds.rows, ds.cols, ds.n_nodes)
    for r in rows:
        jp = jax_partition.partition_graph(jg, r["devices"], halo=r["halo"])
        assert r["pad"] == jp.padded_edges / jg.n_edges
        assert r["max_halo"] == (jp.halo.max_halo if r["halo"] else 0)
        assert r["halo_frac"] == (jp.halo.max_halo / jp.n_local if r["halo"] else 0.0)
        assert r["build_s"] > 0
