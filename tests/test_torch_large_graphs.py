"""Graphs past P = 2048, against the JAX package (CPU).

Kernels #1 to #6 take any node count: past P = 2048 their stream blocks walk
adj in windows of 2048 keys (#3's column pass and #4: rows), so ``auto``
takes them at every P, as JAX's dispatcher takes its Pallas kernels.  On CPU
tensors the port runs their plain versions, here at P = 2176 (one batch of
B = 1, h = 1, f = 8; din 8 for the whole-layer kernels), held against JAX's
Pallas kernels in interpret mode under ``jax.jit`` (``_flash_dot`` and
``_flash_add`` through ``flash_graph_attention``, ``flash_layer_attention``
and ``flash_layer_attention_gat``).  JAX lays features out ``[B, h, P, f]``
inside its kernels and ``[B, P, h, f]`` at its entry points, as the port
does; the same numpy inputs go to both.

Tolerances: fp32 forwards within rtol 1e-4, atol 1e-5 (the JAX package's
flash-vs-dense bar); gradients and the models' outputs within the repo's
rtol 1e-3, with an atol of 1e-5 of the largest element of all the call's
gradients, or of the output (sums of some 900 edges a row in another order
than JAX's; the key biases' gradients are 0 but for fp32 noise).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfgnn_tpu.graph import DenseBatch as JaxDenseBatch
from dfgnn_tpu.models import GTModel as JaxGTModel
from dfgnn_tpu.models import Model as JaxModel
from dfgnn_tpu.ops import dispatch as jax_dispatch
from dfgnn_tpu.ops.edge_dropout import seed_from_key
from dfgnn_tpu.ops.pallas import flash_mask as jax_flash
from dfgnn_tpu_torch.data.synthetic import attention_inputs
from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.models import GTModel, Model
from dfgnn_tpu_torch.models import conv as conv_mod
from dfgnn_tpu_torch.ops import flash_mask, graph_attention
from dfgnn_tpu_torch.weights import gtmodel_params_from_flax, model_params_from_flax
from helpers import random_graph_coo

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-5
P, F, DIN = 2176, 8, 8  # one window of 2048 keys and a second of 128
KEY = jax.random.key(17)
RATE = 0.3


def _close(got, want, scale=None):
    """got within GRAD_RTOL of want, with an atol of GRAD_ATOL_REL of
    ``scale`` (by default want's largest element)."""
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_REL * scale)


def _inputs(with_val=True):
    """attention_inputs at B = h = 1, P = 2176, f = 8, with edge values or
    without, in a JAX and a port DenseBatch, and e_row, e_col and dO from the
    same seed."""
    q, k, v, adj, val = attention_inputs(np.random.default_rng(21), 1, 1, P, F)
    rng = np.random.default_rng(22)
    e_row, e_col = (rng.standard_normal((1, P, 1)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal(q.shape).astype(np.float32)
    mask = np.ones((1, P), bool)
    jb = JaxDenseBatch(adj=jnp.asarray(adj.astype(bool)), node_mask=jnp.asarray(mask),
                       val=jnp.asarray(val) if with_val else None, n_graphs=1, np_pad=P)
    tb = DenseBatch(adj=torch.from_numpy(adj), node_mask=torch.from_numpy(mask),
                    val=torch.from_numpy(val) if with_val else None, n_graphs=1, np_pad=P)
    return (q, k, v, e_row, e_col, do), jb, tb


@functools.lru_cache(maxsize=None)
def _jax_attention():
    """JAX's flash_graph_attention on both scores (Pallas, interpreted), the
    dot score through _flash_dot with edge values, the additive one through
    _flash_add with edge values and RATE dropout, in one jit: each output and
    the gradients of (q, k, v) or (e_row, e_col, v), as numpy."""
    (q, k, v, e_row, e_col, do), jb, _ = _inputs()
    calls = {"dot": lambda g, a, b, c: jax_flash.flash_graph_attention(g, a, b, c,
                                                                       interpret=True),
             "add": lambda g, a, b, c: jax_flash.flash_graph_attention(
                 g, None, None, c, score="add", e_row=a, e_col=b, dropout_rate=RATE,
                 dropout_rng=KEY, interpret=True)}

    @jax.jit
    def run(g, dot_leaves, add_leaves):  # the batch an argument, not a constant
        res = {}
        for score, xs in (("dot", dot_leaves), ("add", add_leaves)):
            out, vjp = jax.vjp(lambda *a: calls[score](g, *a), *xs)
            res[score] = (out, vjp(jnp.asarray(do)))
        return res

    res = run(jb, tuple(map(jnp.asarray, (q, k, v))),
              tuple(map(jnp.asarray, (e_row, e_col, v))))
    return {score: (np.asarray(out), [np.asarray(g) for g in grads])
            for score, (out, grads) in res.items()}


@pytest.mark.parametrize("score", ["dot", "add"])
def test_attention_past_2048_matches_jax(score, monkeypatch):
    """The plain versions of #1 and #3 (dot score, edge values) and of #2 and
    #4 (additive score, edge values, dropout with the seed JAX draws from its
    key) at P = 2176, through the port's autograd Functions, against JAX's
    _flash_dot and _flash_add: the forward and every input's gradient.  CPU
    tensors launch no kernel."""
    (q, k, v, e_row, e_col, do), _, tb = _inputs()
    want_out, want = _jax_attention()[score]
    seed = int(seed_from_key(KEY))
    monkeypatch.setattr(flash_mask.edge_dropout, "seed_from_generator", lambda gen: seed)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in ((q, k, v) if score == "dot" else (e_row, e_col, v))]
    flash_mask.reset_launch_counts()
    if score == "dot":
        out = flash_mask.flash_graph_attention(tb, *leaves)
    else:
        out = flash_mask.flash_graph_attention(
            tb, None, None, leaves[2], score="add", e_row=leaves[0], e_col=leaves[1],
            dropout_rate=RATE, dropout_generator=torch.Generator())
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert flash_mask.launch_counts() == (0,) * 6
    assert flash_mask.flash_takes(score, P, F)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **FWD_TOL)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("layer", ["dot", "add"])
def test_whole_layer_past_2048_matches_jax(layer, monkeypatch):
    """flash_layer_attention (#5) and flash_layer_attention_gat (#6, with
    RATE dropout) at P = 2176, din 8, f = 8, on a batch without edge values,
    against JAX's whole-layer Pallas kernels (interpreted, under jax.jit):
    the forward and the gradients of x and every parameter of sum(out * t)."""
    _, jb, tb = _inputs(with_val=False)
    rng = np.random.default_rng(23)
    normal = lambda shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    x, t = normal((P, DIN)), normal((P, F))
    if layer == "dot":
        params = [a for _ in range(3)
                  for a in (normal((DIN, F), DIN ** -0.5), normal((F,), 0.1))]
        jcall = lambda g, x_, *ps: jax_flash.flash_layer_attention(
            g, x_, *ps, num_heads=1, scale=F ** -0.5, interpret=True)
        tcall = lambda x_, *ps: flash_mask.flash_layer_attention(
            tb, x_, *ps, num_heads=1, scale=F ** -0.5)
    else:
        params = [normal((DIN, F), DIN ** -0.5), normal((F,), 0.1), normal((F, 1), 0.3),
                  normal((F, 1), 0.3)]
        jcall = lambda g, x_, *ps: jax_flash.flash_layer_attention_gat(
            g, x_, *ps, num_heads=1, dropout_rate=RATE, dropout_rng=KEY, interpret=True)
        seed = int(seed_from_key(KEY))
        monkeypatch.setattr(flash_mask.edge_dropout, "seed_from_generator", lambda gen: seed)
        tcall = lambda x_, *ps: flash_mask.flash_layer_attention_gat(
            tb, x_, *ps, num_heads=1, dropout_rate=RATE, dropout_generator=torch.Generator())

    def jax_loss(g, *xs):
        out = jcall(g, *xs)
        return jnp.sum(out * t), out

    (_, want_out), want = jax.jit(jax.value_and_grad(
        jax_loss, argnums=tuple(range(1, len(params) + 2)), has_aux=True))(
            jb, *map(jnp.asarray, (x, *params)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, *params)]
    flash_mask.reset_launch_counts()
    out = tcall(*leaves)
    (out * torch.from_numpy(t)).sum().backward()
    assert flash_mask.launch_counts() == (0,) * 6
    assert flash_mask.layer_fits(layer, P, F)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **FWD_TOL)
    scale = max(float(np.abs(w).max()) for w in want)
    for leaf, w in zip(leaves, want):
        _close(leaf.grad.numpy(), w, scale)


def _graphs():
    """One graph of 2,100 nodes and one of 40: the batch pads to P = 2176."""
    rng = np.random.default_rng(24)
    graphs = []
    for n in (2100, 40):
        r, c, _ = random_graph_coo(rng, n, 6, zero_deg_frac=0.1)
        graphs.append((r, c, n))
    return graphs, rng.integers(0, 3, size=(2 * P,)), rng


@functools.lru_cache(maxsize=None)
def _jax_model(conv):
    """JAX's GTModel (hidden 16, one head, two layers, graph-level logits) or
    fig-1 Model (one GAT conv of hidden 16, node-level outputs) on the two
    graphs, by its dense formulation under jax.jit: the numpy inputs, the
    flax params, the loss weights, the output and every parameter's gradient
    of sum(out * target)."""
    graphs, x, rng = _graphs()
    jb = JaxDenseBatch.from_graph_list(graphs)
    assert jb.np_pad == P
    if conv == "gt":
        jm = JaxGTModel("PATTERN", out_size=3, hidden_size=16, num_layers=2, num_heads=1,
                        method="dense")
        target = rng.standard_normal((2, 3)).astype(np.float32)
        kw = {}
    else:
        jm = JaxModel("PATTERN", "gat", hidden_size=16, num_heads=1)
        target = rng.standard_normal((2 * P, 16)).astype(np.float32)
        kw = dict(impl="dense")
    # the parameters' shapes do not depend on the batch: init on a small one
    small = JaxDenseBatch.from_graph_list([(np.zeros(1, int), np.zeros(1, int), 1)], np_pad=16)
    params = jax.jit(lambda key: jm.init(key, small, jnp.zeros(16, jnp.int32), **kw))(
        jax.random.key(0))

    def jax_loss(p, g):  # the batch an argument, not a constant
        out = jm.apply(p, g, jnp.asarray(x), **kw)
        return jnp.sum(out * target), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params, jb)
    return graphs, x, target, params, np.asarray(want), want_grads


@pytest.mark.parametrize("impl", [None, "flash_fused"])
@pytest.mark.parametrize("conv", ["gt", "gat"])
def test_models_past_2048_match_jax(conv, impl):
    """A 2-layer GTModel (hidden 16) and the fig-1 GAT Model (hidden 16) on
    a DenseBatch of a 2,100-node and a 40-node graph (P = 2176), the flax
    weights carried across by weights.py, through the port's auto route
    (the flash kernels' plain versions: auto takes them at every P) and
    through flash_fused (#5, #6), against JAX's dense formulation: the
    output and every parameter's gradient."""
    graphs, x, target, params, want, want_grads = _jax_model(conv)
    tb = DenseBatch.from_graph_list(graphs, device="cpu")
    gen = torch.Generator().manual_seed(0)
    if conv == "gt":
        tm = GTModel("PATTERN", out_size=3, hidden_size=16, num_layers=2, num_heads=1,
                     generator=gen, device="cpu")
        convert = gtmodel_params_from_flax
    else:
        tm = Model("PATTERN", "gat", hidden_size=16, num_heads=1, generator=gen, device="cpu")
        convert = model_params_from_flax
    tm.load_state_dict(convert(params))
    out = tm(tb, torch.from_numpy(x), impl=impl)
    (out * torch.from_numpy(target)).sum().backward()
    _close(out.detach().numpy(), want)
    grads = convert(jax.tree_util.tree_map(np.asarray, want_grads))
    scale = max(float(g.abs().max()) for g in grads.values())
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), grads[name].numpy(), scale)


@pytest.mark.parametrize("n_nodes", [2049, 4096])
def test_routing_past_2048_matches_jax(n_nodes, monkeypatch):
    """Past P = 2048 the port routes as JAX's Pallas route does: both
    flash_takes rules and both layer_fits rules take the shape; fp32
    method="auto" on a DenseBatch takes the flash kernels on either score,
    where JAX's dispatcher takes its Pallas kernel (both recorded, neither
    run); the bf16 GAT auto takes a kernel route (the flash route past
    GAT_FUSED_MAX_P), where JAX's bf16 GAT takes its whole-layer Pallas
    kernel, never dense."""
    for score in ("dot", "add"):
        assert flash_mask.flash_takes(score, n_nodes, 16)
        assert flash_mask.layer_fits(score, n_nodes, 16)
    routes = []
    monkeypatch.setattr(flash_mask, "flash_graph_attention",
                        lambda *a, **kw: routes.append(("port", "flash")))
    monkeypatch.setattr(jax_flash, "flash_graph_attention",
                        lambda *a, **kw: routes.append(("jax", "flash")))
    monkeypatch.delenv("DFGNN_TPU_FORCE_METHOD", raising=False)
    adj = np.zeros((1, n_nodes, n_nodes), np.uint8)
    mask = np.ones((1, n_nodes), bool)
    tb = DenseBatch(adj=torch.from_numpy(adj), node_mask=torch.from_numpy(mask),
                    n_graphs=1, np_pad=n_nodes)
    jb = JaxDenseBatch(adj=jnp.asarray(adj.astype(bool)), node_mask=jnp.asarray(mask),
                       n_graphs=1, np_pad=n_nodes)
    v, e = np.zeros((1, n_nodes, 1, 4), np.float32), np.zeros((1, n_nodes, 1), np.float32)
    for score in ("dot", "add"):
        kw = lambda t: dict(score="add", e_row=t(e), e_col=t(e)) if score == "add" else {}
        graph_attention(tb, *[torch.from_numpy(v)] * 3, **kw(torch.from_numpy))
        jax_dispatch.graph_attention(jb, *[jnp.asarray(v)] * 3, **kw(jnp.asarray))
    assert routes == [("port", "flash"), ("jax", "flash")] * 2
    bf16_gat = conv_mod._auto_bf16_gat(tb, 16)
    assert bf16_gat == ("flash_fused" if n_nodes <= conv_mod.GAT_FUSED_MAX_P else "flash")
