"""Head dims past 256 and the ``precision`` switch of the flash entry points,
against the JAX package (CPU).

Kernels #1 to #6 take any head dim (on the card #1 to #4 past 256 in chunks
of 256 columns, the whole-layer kernels #5 and #6 in chunks of 128 or 256);
on CPU tensors the port's autograd Functions run their plain versions.
The JAX Pallas kernels run in interpret mode at P <= 32, B*h <= 8, under
``jax.jit``.  JAX on the CPU computes fp32 products whatever the precision,
so ``precision="highest"`` is held at the repo's bars and ``"default"``,
whose plain versions round every product's operands to TF32 as the card's
one-pass kernels do, at TF32_REL.
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
from dfgnn_tpu.ops.edge_dropout import seed_from_key
from dfgnn_tpu.ops.pallas import flash_mask as jax_flash
from dfgnn_tpu_torch.data.synthetic import attention_inputs
from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.models import GTModel, Model
from dfgnn_tpu_torch.ops import flash_mask
from dfgnn_tpu_torch.weights import gtmodel_params_from_flax, model_params_from_flax
from helpers import random_graph_coo

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
# The gradients: rtol 1e-3 (test_dropout_ckpt.py's gradient bar) with atol
# 1e-5 of each tensor's largest element.  With edge values and a unit-scale
# dO, dq reaches 52 here, and the fp32 sums of dO . v^T over f >= 257 terms,
# in another order than JAX's, leave absolute errors of a few 1e-5 on its
# elements near 1e-3.
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-5
MODEL_TOL = dict(rtol=1e-3, atol=1e-5)
GRAD_REL = 2e-4  # test_torch_layer.py's whole-layer gradient bar, of the largest gradient
# "default" against JAX's fp32: TF32 keeps 10 of fp32's 23 mantissa bits, so
# each rounded operand is off by up to 2**-11 of itself and each product by
# 2**-10; the errors add over a contraction (f = 520 terms in q . k^T) and
# pass through exp, so the bar is 16 TF32 steps (2**-6) of each tensor's
# largest element, against its largest error of 2**-9 to 2**-8 here.
TF32_REL = 2.0 ** -6
KEY = jax.random.key(11)
RATE = 0.3


def _batches(seed, B, h, P, f):
    """attention_inputs as numpy, with edge values, in a JAX and a port
    DenseBatch; e_row, e_col and an output gradient from the same seed."""
    q, k, v, adj, val = attention_inputs(np.random.default_rng(seed), B, h, P, f)
    rng = np.random.default_rng(seed + 1)
    e_row, e_col = (rng.standard_normal((B, P, h)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal(q.shape).astype(np.float32)
    mask = np.ones((B, P), bool)
    jb = JaxDenseBatch(adj=jnp.asarray(adj.astype(bool)), node_mask=jnp.asarray(mask),
                       val=jnp.asarray(val), n_graphs=B, np_pad=P)
    tb = DenseBatch(adj=torch.from_numpy(adj), node_mask=torch.from_numpy(mask),
                    val=torch.from_numpy(val), n_graphs=B, np_pad=P)
    return (q, k, v, e_row, e_col, do), jb, tb


@functools.lru_cache(maxsize=None)
def _jax_attention(f):
    """JAX's flash_graph_attention (Pallas, interpreted) at head dim ``f``
    with edge values and RATE dropout, both scores in one jit: for each, the
    output and the gradients of (q, k, v) or (e_row, e_col, v), as numpy."""
    (q, k, v, e_row, e_col, do), jb, _ = _batches(f, 2, 2, 16, f)
    kw = dict(dropout_rate=RATE, dropout_rng=KEY, interpret=True)
    calls = {"dot": lambda a, b, c: jax_flash.flash_graph_attention(jb, a, b, c, **kw),
             "add": lambda a, b, c: jax_flash.flash_graph_attention(
                 jb, None, None, c, score="add", e_row=a, e_col=b, **kw)}

    @jax.jit
    def run(dot_leaves, add_leaves):
        res = {}
        for score, xs in (("dot", dot_leaves), ("add", add_leaves)):
            out, vjp = jax.vjp(calls[score], *xs)
            res[score] = (out, vjp(jnp.asarray(do)))
        return res

    res = run(tuple(map(jnp.asarray, (q, k, v))), tuple(map(jnp.asarray, (e_row, e_col, v))))
    return {score: (np.asarray(out), [np.asarray(g) for g in grads])
            for score, (out, grads) in res.items()}


def _port_attention(score, f, precision=None, monkeypatch=None):
    """The port's flash_graph_attention on the same inputs with RATE dropout,
    its generator's draw replaced by the seed JAX draws from KEY, so both
    packages apply the same mask."""
    (q, k, v, e_row, e_col, do), _, tb = _batches(f, 2, 2, 16, f)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in ((q, k, v) if score == "dot" else (e_row, e_col, v))]
    seed = int(seed_from_key(KEY))
    monkeypatch.setattr(flash_mask.edge_dropout, "seed_from_generator", lambda gen: seed)
    kw = dict(dropout_rate=RATE, dropout_generator=torch.Generator(), precision=precision)
    if score == "dot":
        out = flash_mask.flash_graph_attention(tb, *leaves, **kw)
    else:
        out = flash_mask.flash_graph_attention(tb, None, None, leaves[2], score="add",
                                               e_row=leaves[0], e_col=leaves[1], **kw)
    return out, torch.autograd.grad(out, leaves, torch.from_numpy(do))


def _assert_grads(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * float(np.abs(w).max()))


def _assert_rel(got, want, rel):
    """max |got - want| within ``rel`` of want's largest element."""
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


@pytest.mark.parametrize("f", [257, 300, 520])
def test_wide_head_attention_matches_jax(f, monkeypatch):
    """flash_graph_attention past f = 256 on both scores, with edge values
    and hash dropout: the forward and the gradients against JAX's Pallas
    kernels."""
    for score, (want_out, want) in _jax_attention(f).items():
        flash_mask.reset_launch_counts()
        out, got = _port_attention(score, f, monkeypatch=monkeypatch)
        assert flash_mask.launch_counts() == (0,) * 6  # CPU tensors never launch
        np.testing.assert_allclose(out.detach().numpy(), want_out, **FWD_TOL)
        _assert_grads(got, want)


@pytest.mark.parametrize("score", ["dot", "add"])
def test_precision_on_flash_graph_attention(score, monkeypatch):
    """precision="highest" is the default on fp32 and holds the repo's bars
    against JAX; "default" rounds each product's operands to TF32 and holds
    TF32_REL; anything else raises."""
    (q, k, v, e_row, e_col, _), _, tb = _batches(520, 2, 2, 16, 520)
    want_out, want = _jax_attention(520)[score]
    runs = {p: _port_attention(score, 520, p, monkeypatch)
            for p in (None, "highest", "default")}
    for p in (None, "highest"):
        np.testing.assert_allclose(runs[p][0].detach().numpy(), want_out, **FWD_TOL)
        _assert_grads(runs[p][1], want)
    assert torch.equal(runs[None][0], runs["highest"][0])
    out, got = runs["default"]
    assert not torch.equal(out, runs["highest"][0])
    _assert_rel(out.detach().numpy(), want_out, TF32_REL)
    for g, w in zip(got, want):
        _assert_rel(g.numpy(), w, TF32_REL)
    t = lambda a: torch.from_numpy(a)
    kw = dict(score="add", e_row=t(e_row), e_col=t(e_col)) if score == "add" else {}
    with pytest.raises(ValueError, match="precision"):
        flash_mask.flash_graph_attention(tb, t(q), t(k), t(v), precision="fast", **kw)


def _layer_case(seed, din, h, f):
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(2):
        nb = int(rng.integers(8, 16))
        r, c, _ = random_graph_coo(rng, nb, 5, zero_deg_frac=0.15)
        graphs.append((r, c, nb))
    jb = JaxDenseBatch.from_graph_list(graphs, np_pad=16)
    tb = DenseBatch.from_graph_list(graphs, np_pad=16, device="cpu")
    normal = lambda shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    x, t = normal((32, din)), normal((32, h * f))
    return jb, tb, x, t, normal


def _whole_layer(layer, f, rate, monkeypatch, seed):
    """JAX's whole-layer entry point (#5's flash_layer_attention, or #6's
    flash_layer_attention_gat with ``rate`` dropout; Pallas interpreted,
    under jax.jit) at head dim ``f`` (din 24, two heads, two graphs of
    P = 16), and the port's on the same numpy inputs.  Returns the JAX
    output and gradients of x and every parameter (of sum(out * t)), and
    ``run(precision)``, the port's output and its leaves with their
    gradients.  The port's generator draw is replaced by the seed JAX draws
    from its key, so both apply the same mask."""
    din, h = 24, 2
    jb, tb, x, t, normal = _layer_case(seed, din, h, f)
    if layer == "dot":
        params = [a for _ in range(3) for a in (normal((din, h * f), din ** -0.5),
                                                 normal((h * f,), 0.1))]
        jcall = lambda x_, *ps: jax_flash.flash_layer_attention(
            jb, x_, *ps, num_heads=h, scale=f ** -0.5, interpret=True)
        tcall = lambda x_, *ps, precision: flash_mask.flash_layer_attention(
            tb, x_, *ps, num_heads=h, scale=f ** -0.5, precision=precision)
    else:
        params = [normal((din, h * f), din ** -0.5), normal((h * f,), 0.1),
                  normal((f, h), 0.3), normal((f, h), 0.3)]
        jcall = lambda x_, *ps: jax_flash.flash_layer_attention_gat(
            jb, x_, *ps, num_heads=h, dropout_rate=rate, dropout_rng=KEY, interpret=True)
        seed = int(seed_from_key(KEY))
        monkeypatch.setattr(flash_mask.edge_dropout, "seed_from_generator", lambda gen: seed)
        tcall = lambda x_, *ps, precision: flash_mask.flash_layer_attention_gat(
            tb, x_, *ps, num_heads=h, dropout_rate=rate, precision=precision,
            dropout_generator=torch.Generator())

    @jax.jit
    def jax_loss(*xs):
        out = jcall(*xs)
        return jnp.sum(out * t), out

    (_, want_out), want = jax.value_and_grad(jax_loss, argnums=tuple(range(len(params) + 1)),
                                             has_aux=True)(*map(jnp.asarray, (x, *params)))

    def run(precision):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, *params)]
        out = tcall(*leaves, precision=precision)
        (out * torch.from_numpy(t)).sum().backward()
        return out, leaves

    return np.asarray(want_out), [np.asarray(w) for w in want], run


@pytest.mark.parametrize("f", [257, 520])
@pytest.mark.parametrize("layer", ["dot", "add"])
def test_whole_layer_past_256_matches_jax(layer, f, monkeypatch):
    """flash_layer_attention (#5) and flash_layer_attention_gat (#6, with
    dropout 0.4) past head dim 256 against JAX's whole-layer Pallas kernels:
    the forward at FWD_TOL and every gradient within GRAD_REL of the largest
    JAX gradient.  CPU tensors launch no kernel."""
    want_out, want, run = _whole_layer(layer, f, 0.4, monkeypatch, f)
    flash_mask.reset_launch_counts()
    out, leaves = run(None)
    assert flash_mask.launch_counts() == (0,) * 6
    assert flash_mask.layer_fits(layer, 16, f)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **FWD_TOL)
    scale = max(float(np.abs(w).max()) for w in want)
    for leaf, w in zip(leaves, want):
        assert float(np.abs(leaf.grad.numpy() - w).max()) < GRAD_REL * scale


@pytest.mark.parametrize("layer", ["dot", "add"])
def test_precision_on_the_whole_layer_entry_points(layer, monkeypatch):
    """flash_layer_attention (#5) and flash_layer_attention_gat (#6, with
    dropout) at both precisions, at head dim 16 and past 256 (260): the
    output and the gradients of every input against JAX's, "highest" at the
    repo's bars and "default" at TF32_REL."""
    for f in (16, 260):
        want_out, want, run = _whole_layer(layer, f, RATE, monkeypatch, 24 if f == 16 else f)
        scale = max(float(np.abs(w).max()) for w in want)
        for precision in ("highest", "default"):
            out, leaves = run(precision)
            if precision == "highest":
                np.testing.assert_allclose(out.detach().numpy(), want_out, **FWD_TOL)
                for leaf, w in zip(leaves, want):
                    assert float(np.abs(leaf.grad.numpy() - w).max()) < GRAD_REL * scale
            else:
                _assert_rel(out.detach().numpy(), want_out, TF32_REL)
                for leaf, w in zip(leaves, want):
                    assert float(np.abs(leaf.grad.numpy() - w).max()) < TF32_REL * scale


def _wide_graphs():
    rng = np.random.default_rng(5)
    graphs = []
    for _ in range(2):
        nb = int(rng.integers(10, 16))
        r, c, _ = random_graph_coo(rng, nb, 5, zero_deg_frac=0.1)
        graphs.append((r, c, nb))
    x = rng.integers(0, 3, size=(32,))
    return graphs, x, rng


@functools.lru_cache(maxsize=None)
def _jax_wide_model(conv):
    """JAX's dense formulation of a wide model on two small graphs: GTModel
    (hidden 520, two heads of head dim 260, two layers, graph-level logits)
    or the fig-1 Model (one GAT conv of hidden 520, one head: head dim 520,
    node-level outputs).  Returns the numpy inputs, the flax params, the
    loss weights, the output and every parameter's gradient of
    sum(out * target)."""
    graphs, x, rng = _wide_graphs()
    jb = JaxDenseBatch.from_graph_list(graphs, np_pad=16)
    if conv == "gt":
        jm = JaxGTModel("PATTERN", out_size=3, hidden_size=520, num_layers=2, num_heads=2,
                        method="dense")
        target = rng.standard_normal((2, 3)).astype(np.float32)
        kw = {}
    else:
        jm = JaxModel("PATTERN", "gat", hidden_size=520, num_heads=1)
        target = rng.standard_normal((32, 520)).astype(np.float32)
        kw = dict(impl="dense")
    params = jax.jit(lambda key: jm.init(key, jb, jnp.asarray(x), **kw))(jax.random.key(0))

    @jax.jit
    def jax_loss(p):
        out = jm.apply(p, jb, jnp.asarray(x), **kw)
        return jnp.sum(out * target), out

    (_, want), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    return graphs, x, target, params, np.asarray(want), want_grads


def _port_wide_model(conv, impl):
    """The port's model of _jax_wide_model(conv) with the flax weights carried
    across by weights.py, through ``impl`` on the CPU: its output, gradients
    by parameter name, and JAX's output and gradients converted alike."""
    graphs, x, target, params, want, want_grads = _jax_wide_model(conv)
    tb = DenseBatch.from_graph_list(graphs, np_pad=16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    if conv == "gt":
        tm = GTModel("PATTERN", out_size=3, hidden_size=520, num_layers=2, num_heads=2,
                     generator=gen, device="cpu")
        convert = gtmodel_params_from_flax
    else:
        tm = Model("PATTERN", "gat", hidden_size=520, num_heads=1, generator=gen, device="cpu")
        convert = model_params_from_flax
    tm.load_state_dict(convert(params))
    flash_mask.reset_launch_counts()
    out = tm(tb, torch.from_numpy(x), impl=impl)
    assert flash_mask.launch_counts() == (0,) * 6  # CPU tensors never launch
    (out * torch.from_numpy(target)).sum().backward()
    grads = convert(jax.tree_util.tree_map(np.asarray, want_grads))
    return out, dict(tm.named_parameters()), want, grads


def test_wide_gtmodel_matches_jax():
    """GTModel at hidden 520, two heads (head dim 260, past 256) and two
    layers, the flax weights carried across by weights.py: the port's
    default path (auto: the flash kernels' plain versions) against JAX's
    dense formulation, logits and every parameter's gradient.  (JAX's flash
    path at these head dims is held by the tests above; interpreting it
    through two layers would double this file's time.)"""
    assert flash_mask.flash_takes("dot", 16, 260)
    logits, params, want, grads = _port_wide_model("gt", None)
    np.testing.assert_allclose(logits.detach().numpy(), want, **MODEL_TOL)
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), **MODEL_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("conv", ["gt", "gat"])
def test_wide_models_through_the_whole_layer_match_jax(conv):
    """The wide GTModel (hidden 520, two heads of 260, two layers) and the
    wide fig-1 GAT Model (hidden 520, one head of 520) through
    impl="flash_fused" (the whole-layer kernels' autograd Functions, their
    plain versions on the CPU) against JAX's dense formulation, the flax
    weights carried across: the output and every parameter's gradient."""
    assert flash_mask.layer_fits("dot", 16, 260) and flash_mask.layer_fits("add", 16, 520)
    out, params, want, grads = _port_wide_model(conv, "flash_fused")
    np.testing.assert_allclose(out.detach().numpy(), want, **MODEL_TOL)
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), **MODEL_TOL,
                                   err_msg=name)
