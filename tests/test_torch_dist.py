"""The port's multi-device layer in a world of 4 gloo processes on the CPU,
held against the JAX package's single-device oracle.

One module-scoped world (``dist_world.start_world``) computes every case at
once: each plan flavour of ``dist_graph_attention`` (all-gather with shared
segments, halo, transpose with the fused backward, balance, lpa reorder; dot
and add scores; with and without dropout), head-parallel attention on three
layouts and the multi-device training steps.  The JAX side never runs its
own distributed path (it compiles for seconds a case on the virtual mesh):
outputs are held against ``graph_attention_reference`` and gradients of
``sum(out * t)`` against ``jax.grad`` of it, the oracle JAX's own
``tests/test_partition.py`` holds its distributed path to.  With dropout the
oracle's normalised weights take the edge hash's keep factor
(``edge_dropout.keep_scale`` on the edge's global ids), the mask the
single-device bucket path applies for the same seed.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

from dfgnn_tpu.data.synthetic import community_graph
from dfgnn_tpu.graph import DenseBatch as JaxDenseBatch
from dfgnn_tpu.graph import Graph as JaxGraph
from dfgnn_tpu.ops import graph_attention_reference, spmm
from dfgnn_tpu.ops.dense_block import dense_graph_attention
from dfgnn_tpu.ops.edge_dropout import keep_scale
from dfgnn_tpu_torch import formats
from dfgnn_tpu_torch.graph import DenseBatch, Graph
from dfgnn_tpu_torch.parallel import partition_graph
from dfgnn_tpu_torch.scripts import dryrun_multichip
from dist_world import all_cases, fail_on_rank, start_world
from helpers import random_graph_coo

N_RANKS = 4
FP32_TOL = dict(rtol=1e-4, atol=1e-5)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _case(seed, n, avg_deg, score, h, f, plan, *, rate=0.0, coo=None, **kw):
    rng = np.random.default_rng(seed)
    rows, cols, _ = coo if coo is not None else random_graph_coo(rng, n, avg_deg, **kw)
    names = ("q", "k", "v") if score == "dot" else ("e_row", "e_col", "v")
    case = dict(rows=rows, cols=cols, n=n, score=score, plan=plan, rate=rate,
                seed=(int(rng.integers(0, 2 ** 32)) if rate else None),
                **{x: _f32(rng, n, h, f) if x in "qkv" else _f32(rng, n, h) for x in names})
    case["t"] = _f32(rng, n, h, f)
    return case


def _community(seed, n, n_comm, shuffle=None, **kw):
    rows, cols = community_graph(np.random.default_rng(seed), n, n_communities=n_comm,
                                 avg_deg=8, **kw)
    if shuffle is not None:
        perm = np.random.default_rng(shuffle).permutation(n)
        rows, cols = perm[rows], perm[cols]
    key = np.unique(rows.astype(np.int64) * n + cols)
    return key // n, key % n, None


CASES = {
    # all-gather plans (balanced by default), autodiff through the forward
    "allgather_dot": _case(1, 200, 10, "dot", 2, 16, {}),
    "allgather_add": _case(2, 150, 6, "add", 1, 8, {}),
    # a 350-wide row: the default plan deals it as shared segments
    "super_node": _case(3, 400, 4, "dot", 1, 8, {}, super_node_deg=350),
    "super_node_dropout": _case(3, 400, 4, "dot", 1, 8, {}, rate=0.3, super_node_deg=350),
    "halo_dot": _case(4, 240, 8, "dot", 2, 8, dict(halo=True), coo=_community(4, 240, 4)),
    "halo_add": _case(5, 160, 6, "add", 1, 8, dict(halo=True)),
    # the fused distributed backward; a 300-wide row gives per-device segments
    "fused_dot": _case(6, 240, 6, "dot", 2, 8, dict(with_transpose=True), super_node_deg=150),
    "fused_dot_halo_segments": _case(7, 400, 4, "dot", 1, 8,
                                     dict(halo=True, with_transpose=True), super_node_deg=300),
    "fused_add_halo": _case(8, 160, 5, "add", 1, 8, dict(halo=True, with_transpose=True)),
    "dropout_fused": _case(9, 240, 6, "dot", 2, 8, dict(with_transpose=True), rate=0.4,
                           super_node_deg=150),
    "dropout_fused_halo": _case(9, 240, 6, "dot", 2, 8, dict(halo=True, with_transpose=True),
                                rate=0.4, super_node_deg=150),
    "dropout_add_halo": _case(10, 160, 6, "add", 1, 8, dict(halo=True), rate=0.3),
    # shuffled community ids: the lpa order restores the halo's locality
    "reorder_lpa": _case(11, 256, 8, "dot", 1, 8, dict(halo=True, reorder="lpa"),
                         coo=_community(0, 256, 4, shuffle=1, intra_frac=0.95)),
}


def _tp_cases():
    rng = np.random.default_rng(12)
    out = {}
    rows, cols, _ = random_graph_coo(rng, 120, 5)
    out["tp_graph"] = dict(layout=Graph.from_coo(rows, cols, 120, device="cpu"),
                           coo=(rows, cols, 120), q=_f32(rng, 120, 4, 8),
                           k=_f32(rng, 120, 4, 8), v=_f32(rng, 120, 4, 8))
    rows, cols, _ = random_graph_coo(rng, 200, 6)
    bg = formats.preprocess("bucketed", Graph.from_coo(rows, cols, 200, device="cpu"),
                            split_width=32, src_block_rows=None)
    out["tp_bucket"] = dict(layout=bg, coo=(rows, cols, 200), q=_f32(rng, 200, 2, 8),
                            k=_f32(rng, 200, 2, 8), v=_f32(rng, 200, 2, 8))
    graphs = []
    for _ in range(4):
        n = int(rng.integers(20, 60))
        graphs.append((rng.integers(0, n, n * 4), rng.integers(0, n, n * 4), n))
    out["tp_dense"] = dict(layout=DenseBatch.from_graph_list(graphs, np_pad=64, device="cpu"),
                           graphs=graphs, q=_f32(rng, 4, 64, 4, 8), k=_f32(rng, 4, 64, 4, 8),
                           v=_f32(rng, 4, 64, 4, 8))
    return out


def _oracle(case):
    """JAX's single-device oracle: (out, grads of sum(out * t)) on numpy."""
    g = JaxGraph.from_coo(case["rows"], case["cols"], case["n"])
    dot = case["score"] == "dot"
    names = ("q", "k", "v") if dot else ("e_row", "e_col", "v")
    rate = case["rate"]

    def fwd(a, b, v):
        kw = dict(score="dot") if dot else dict(score="add", e_row=a, e_col=b)
        qk = (a, b) if dot else (None, None)
        if rate == 0.0:
            return graph_attention_reference(g, *qk, v, **kw)
        _, w = graph_attention_reference(g, *qk, v, **kw, return_weights=True)
        heads = jnp.arange(v.shape[1])[None, :]
        return spmm(g, w * keep_scale(case["seed"], g.rows[:, None], g.cols[:, None], heads,
                                      rate), v)

    def fwd_and_grads(xs, t):
        out, vjp = jax.vjp(fwd, *xs)
        return out, vjp(t)  # the gradients of sum(out * t)

    out, grads = jax.jit(fwd_and_grads)([jnp.asarray(case[x]) for x in names],
                                        jnp.asarray(case["t"]))
    return np.asarray(out), dict(zip(names, (np.asarray(x) for x in grads)))


def _tp_oracle(name, case):
    qkv = [jnp.asarray(case[x]) for x in ("q", "k", "v")]
    if name == "tp_dense":
        b = JaxDenseBatch.from_graph_list(case["graphs"], np_pad=64)
        return np.asarray(jax.jit(lambda *a: dense_graph_attention(b, *a))(*qkv))
    g = JaxGraph.from_coo(*case["coo"])
    return np.asarray(jax.jit(lambda *a: graph_attention_reference(g, *a))(*qkv))


@pytest.fixture(scope="module")
def world():
    """The world starts once; the oracles and the one-process steps run
    here while it does, and each test compares."""
    tp = _tp_cases()
    w = start_world(all_cases, N_RANKS, CASES,
                    {k: {x: c[x] for x in ("layout", "q", "k", "v")} for k, c in tp.items()})
    want = {name: _oracle(case) for name, case in CASES.items()}
    want.update({f"{name}_rate0": _oracle({**case, "rate": 0.0})
                 for name, case in CASES.items() if case["rate"]})
    want.update({name: _tp_oracle(name, case) for name, case in tp.items()})
    want["steps"] = dryrun_multichip.single_process(N_RANKS, "cpu")
    return w, want


def _check(world, name, **plan):
    want, want_grads = world[1][name]
    got = world[0].results()[name]
    for key, val in plan.items():
        assert got["plan"][key] == val, (name, key, got["plan"])
    np.testing.assert_allclose(got["out"], want, **FP32_TOL, err_msg=f"{name}: out")
    for x, g in want_grads.items():
        np.testing.assert_allclose(got["grads"][x], g, **FP32_TOL, err_msg=f"{name}: d{x}")
    return got


@pytest.mark.parametrize("score", ["dot", "add"])
def test_dist_matches_oracle(world, score):
    """The all-gather plan (balanced: a node permutation) on both scores,
    forward and autograd through the all-gather's reduce-scatter."""
    _check(world, f"allgather_{score}", halo=False, perm=True, transpose=False)


def test_dist_super_node_shared_segments(world):
    """A super row whose neighbours span every rank, dealt as shared
    segments merged across the ranks; forward, autograd through the masked
    sum all-reduce and the combine, and its dropout rows."""
    _check(world, "super_node", shared=True)
    _check(world, "super_node_dropout", shared=True)


@pytest.mark.parametrize("score", ["dot", "add"])
def test_halo_exchange(world, score):
    """The halo plan's all-to-all (and its reverse in the backward)."""
    got = _check(world, f"halo_{score}", halo=True, transpose=False)
    if score == "dot":  # a community graph: the halo is well under a peer's rows
        assert got["plan"]["max_halo"] < got["plan"]["n_local"]


@pytest.mark.parametrize("name", ["fused_dot", "fused_dot_halo_segments", "fused_add_halo"])
def test_dist_custom_backward(world, name):
    """The fused distributed backward: CSR-direction dQ (d e_row) on this
    rank's rows, CSC-direction dK (d e_col) and dV on the transposed plan."""
    plan = dict(transpose=True, halo="halo" in name)
    if name == "fused_dot_halo_segments":
        plan["segments"] = True
    _check(world, name, **plan)


@pytest.mark.parametrize("name", ["dropout_fused", "dropout_fused_halo", "dropout_add_halo"])
def test_dist_dropout_matches_hash_oracle(world, name):
    """Dropout keys on global original ids on every rank and in both
    backward directions: a mask off by one edge moves an output by O(1)."""
    got = _check(world, name, halo="halo" in name)
    assert np.abs(got["out"] - world[1][f"{name}_rate0"][0]).max() > 1e-3


def test_reorder_halo_community(world):
    """The lpa order shrinks the halo of shuffled community ids (the port's
    plan, numpy) and the reordered plan's outputs return in the original
    order."""
    case = CASES["reorder_lpa"]
    g = Graph.from_coo(case["rows"], case["cols"], case["n"], device="cpu")
    plain = partition_graph(g, N_RANKS, halo=True)
    got = _check(world, "reorder_lpa", halo=True, perm=True)
    assert got["plan"]["max_halo"] < plain.halo.max_halo * 0.6


def test_tp_heads_match_single_device(world):
    """Head-parallel attention on a (2, 2) mesh: every layout's gathered
    heads equal the single-device oracle's (Graph: the segment-op oracle;
    bucket layout; DenseBatch: the dense formulation, the CPU plain path)."""
    got = world[0].results()
    for name in ("tp_graph", "tp_bucket", "tp_dense"):
        np.testing.assert_allclose(got[name], world[1][name], **FP32_TOL, err_msg=name)


def test_multichip_steps_match_single_process(world):
    """The data-parallel (DDP), partitioned (halo, fused backward) and
    head-parallel steps of the dryrun twin give the one-process steps'
    losses, two steps each."""
    got, want = world[0].results()["steps"], world[1]["steps"]
    assert set(got) == {"dp", "partitioned", "tp", "launches"}
    assert got.pop("launches") == {"dp": [0, 0], "partitioned": [0, 0], "tp": [0, 0]}
    for key in want:
        assert np.all(np.isfinite(got[key])), key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)


def test_world_fails_rather_than_hangs(capfd):
    """A rank that raises ends the world well before its deadline, while
    the other waits in a collective; the first rank to die reports (the
    failing one, or its peer's lost connection) and each prints its own
    traceback."""
    w = start_world(fail_on_rank, 2, 1, timeout=60)
    t0 = time.monotonic()
    with pytest.raises(mp.ProcessRaisedException):
        w.results()
    assert time.monotonic() - t0 < 30
    err = capfd.readouterr().err
    assert "rank 1 of 2 failed" in err and "rank 1 fails on purpose" in err
