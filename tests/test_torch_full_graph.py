"""The port's full-graph models, parity harness and twins on the bucketed
layouts, against the JAX package's (CPU).

JAX's bucket path runs twice here, under ``jax.jit``: one ``GATNet`` Adam
step on its bucketed training layout (the custom VJP) and the
``FullGraphNet`` forwards on its bucketed layout.  The port's side runs its
bucket path on the same graph with the flax weights carried across.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfgnn_tpu import formats as jax_formats
from dfgnn_tpu.data import synthetic as jax_synthetic
from dfgnn_tpu.graph import Graph as JaxGraph
from dfgnn_tpu.models import FullGraphNet as JaxFullGraphNet
from dfgnn_tpu.models import GATNet as JaxGATNet
from dfgnn_tpu.train import parity as jax_parity
from dfgnn_tpu_torch import formats
from dfgnn_tpu_torch.graph import Graph
from dfgnn_tpu_torch.models import FullGraphNet, GATNet, graph_pool, make_conv
from dfgnn_tpu_torch.scripts import test_full_graph, train_gatconv, train_parity
from dfgnn_tpu_torch.train import TrainState, make_loss_fn, train_step
from dfgnn_tpu_torch.train.parity import run_parity_full
from dfgnn_tpu_torch.weights import fullgraphnet_params_from_flax, gatnet_params_from_flax
from helpers import random_graph_coo

MODEL_TOL = dict(rtol=1e-3, atol=1e-4)
N, IN, CLASSES = 250, 6, 3
FGN_CONVS = ("gt", "agnn", "dotgat")


@functools.cache
def _task():
    """A graph with zero-degree rows and a super node past the segment split,
    features, labels and a train mask, from one numpy seed."""
    rng = np.random.default_rng(11)
    rows, cols, _ = random_graph_coo(rng, N, 5, super_node_deg=120)
    x = rng.standard_normal((N, IN)).astype(np.float32)
    y = rng.integers(0, CLASSES, N)
    mask = (rng.random(N) < 0.6).astype(np.float32)
    return rows, cols, x, y, mask


def _layouts(**kw):
    rows, cols = _task()[:2]
    return (jax_formats.build_buckets(JaxGraph.from_coo(rows, cols, N), **kw),
            formats.build_buckets(Graph.from_coo(rows, cols, N, device="cpu"), **kw))


def _close(got, want, tol=MODEL_TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol, err_msg=msg)


@functools.cache
def _jax_gatnet_step():
    """One flax GATNet (hidden 8, 2 heads, 2 layers) Adam step on JAX's
    bucketed training layout: params, logits, loss, grads, updated params."""
    rows, cols, x, y, mask = _task()
    jbg, _ = _layouts(with_transpose=True)
    jm = JaxGATNet(num_classes=CLASSES, hidden_size=8, num_layers=2, num_heads=2)
    jg = JaxGraph.from_coo(rows, cols, N)
    params = jax.jit(lambda xx: jm.init(jax.random.key(0), jg, xx, impl="reference"))(
        jnp.asarray(x))
    opt = optax.adam(1e-2)

    @jax.jit
    def step(p, bg):
        def loss_fn(p_):
            logits = jm.apply(p_, bg, jnp.asarray(x))
            l = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y))
            return jnp.sum(l * mask) / jnp.maximum(jnp.sum(mask), 1), logits
        (l, logits), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        up, _ = opt.update(g, opt.init(p))
        return l, logits, g, optax.apply_updates(p, up)

    as_sd = lambda tree: gatnet_params_from_flax(jax.tree_util.tree_map(np.asarray, tree))
    loss, logits, grads, after = step(params, jbg)
    return as_sd(params), float(loss), np.asarray(logits), as_sd(grads), as_sd(after)


def test_gatnet_adam_step_matches_jax():
    """GATNet through the bucket path's custom backward: logits, loss, every
    gradient and every updated parameter of one Adam step."""
    _, _, x, y, mask = _task()
    params, want_loss, want_logits, grads, after = _jax_gatnet_step()
    _, bg = _layouts(with_transpose=True)
    tm = GATNet(num_classes=CLASSES, hidden_size=8, num_layers=2, num_heads=2, in_size=IN,
                generator=torch.Generator().manual_seed(0), device="cpu")
    tm.load_state_dict(params)
    xt, yt, mt = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)
    logits = tm(bg, xt)
    assert type(logits.grad_fn).__name__ == "LogSoftmaxBackward0"
    _close(logits, want_logits)
    state = TrainState.create(tm, lr=1e-2, device="cpu")
    _, loss = train_step(state, make_loss_fn(tm, "node_classification", CLASSES), bg, xt, yt,
                         mt)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-4)
    for name, p in tm.named_parameters():
        _close(p.grad, grads[name].numpy(), msg=name)
        _close(p, after[name].numpy(), msg=name)


@functools.cache
def _jax_fullgraphnet_forwards():
    """Flax FullGraphNet (hidden 8, 2 heads, 2 layers) per conv on JAX's
    bucketed layout, in one jit: (params, logits) per conv."""
    rows, cols, x, _, _ = _task()
    jbg, _ = _layouts()
    jg = JaxGraph.from_coo(rows, cols, N)
    models = {c: JaxFullGraphNet(conv=c, num_classes=CLASSES, hidden_size=8, num_layers=2,
                                 num_heads=2) for c in FGN_CONVS}
    params = {c: jax.jit(lambda xx, m=m: m.init(jax.random.key(1), jg, xx, impl="reference"))(
        jnp.asarray(x)) for c, m in models.items()}
    logits = jax.jit(lambda ps, bg: {c: models[c].apply(ps[c], bg, jnp.asarray(x))
                                     for c in FGN_CONVS})(params, jbg)
    return {c: (fullgraphnet_params_from_flax(jax.tree_util.tree_map(np.asarray, params[c])),
                np.asarray(logits[c])) for c in FGN_CONVS}


@pytest.mark.parametrize("conv", FGN_CONVS)
def test_fullgraphnet_on_bucketed_matches_jax(conv):
    params, want = _jax_fullgraphnet_forwards()[conv]
    _, bg = _layouts()
    tm = FullGraphNet(conv, num_classes=CLASSES, hidden_size=8, num_layers=2, num_heads=2,
                      in_size=IN, generator=torch.Generator().manual_seed(0), device="cpu")
    tm.load_state_dict(params)
    _close(tm(bg, torch.from_numpy(_task()[2])), want)


@pytest.mark.parametrize("conv", ["gt", "gat", "agnn", "dotgat"])
def test_convs_on_bucketed_layouts_match_the_oracle(conv):
    """Every conv runs on the flat and the blocked layouts through
    ``graph_attention`` with no other change (their DenseBatch branches leave
    these layouts alone), and matches its run on the Graph."""
    rows, cols, x, _, _ = _task()
    g = Graph.from_coo(rows, cols, N, device="cpu")
    layer = make_conv(conv, IN, 8, 2, generator=torch.Generator().manual_seed(2), device="cpu")
    xt = torch.from_numpy(x)
    want = layer(g, xt)
    for kw in ({}, {"src_block_rows": 100, "with_transpose": True}):
        torch.testing.assert_close(layer(formats.build_buckets(g, **kw), xt), want,
                                   rtol=1e-4, atol=1e-5)


def test_graph_pool_on_bucketed_layouts():
    rows, cols, x, _, _ = _task()
    gid = np.repeat(np.arange(5), N // 5)
    g = Graph.from_coo(rows, cols, N, n_graphs=5, graph_id=gid, device="cpu")
    xt = torch.from_numpy(x)
    for op in ("sum", "mean"):
        want = graph_pool(g, xt, op)
        for kw in ({}, {"src_block_rows": 100}):
            torch.testing.assert_close(graph_pool(formats.build_buckets(g, **kw), xt, op), want)


def test_run_parity_full_twin():
    """The full-graph parity harness draws the JAX harness's task (SBM graph,
    noisy one-hot features, labels, split) from the same numpy generator and
    trains the bucket path and the oracle to the same accuracy."""
    rng = np.random.default_rng(0)  # the JAX harness's draws, in its order
    _, _, block = jax_synthetic.sbm_graph(rng, 300, n_blocks=4, avg_deg=20.0)
    jax_parity._noisy_onehot(rng, block, 4, 0.3)
    split = rng.random(300) < 0.5
    got = run_parity_full(seed=0, n=300, steps=15, hidden=8, device="cpu")
    assert got["task"] == "full-SBM" and len(got["fused_steps"]) == 15
    counts = np.bincount(block[~split], minlength=4)
    assert got["majority_baseline"] == pytest.approx(counts.max() / counts.sum())
    assert got["gap"] <= 0.02, got


def test_full_graph_twins_on_cpu(capsys):
    """The test_full_graph twin checks the bucket path against the oracle (on a
    subsample above the edge cap) and runs ``--format dist`` as a world of one
    process, its gathered output against the oracle; the
    train_gatconv twin trains GATNet on the bucketed training layout; the
    train_parity twin runs its full-graph half."""
    for conv, cap in (("gt", "4000000"), ("gat", "5000")):
        res = test_full_graph.main(["--dataset", "cora", "--dim", "16", "--heads", "2",
                                    "--conv", conv, "--format", "all_fg", "--device", "cpu",
                                    "--oracle-edge-cap", cap])
        assert res["bucket"]["ok"] is True and res["bucket"]["ms"] is None
    assert "correctness vs oracle: OK" in capsys.readouterr().out
    res = test_full_graph.main(["--dataset", "cora", "--dim", "16", "--heads", "2", "--format",
                                "dist", "--device", "cpu"])
    assert res["dist"]["ok"] is True and res["dist"]["ms"] is None
    res = train_gatconv.main(["--dataset", "cora", "--dim", "8", "--heads", "2", "--n-layers",
                              "2", "--epochs", "6", "--lr", "1e-2", "--device", "cpu"])
    assert res["losses"][-1] < res["losses"][0] and res["peak_mib"] is None
    res = train_parity.main(["--conv", "gat", "--steps", "4", "--hidden", "8", "--n-graphs",
                             "2", "--device", "cpu"])
    assert res["full"]["task"] == "full-SBM" and len(res["full"]["fused_steps"]) == 4
