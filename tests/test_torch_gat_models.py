"""The port's GAT-family convs and models against the JAX package's, with the
JAX weights carried across by dfgnn_tpu_torch.weights (CPU).

Batches stay at P <= 32 and B*h <= 8, where the JAX flash kernels run in
Pallas interpret mode; JAX steps run under ``jax.jit``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfgnn_tpu.data import synthetic as jax_synthetic
from dfgnn_tpu.graph import DenseBatch as JaxDenseBatch
from dfgnn_tpu.models import FullGraphNet as JaxFullGraphNet
from dfgnn_tpu.models import GATNet as JaxGATNet
from dfgnn_tpu.models import Model as JaxModel
from dfgnn_tpu.train import parity as jax_parity
from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.models import FullGraphNet, GATNet, Model, make_conv
from dfgnn_tpu_torch.ops import flash_mask
from dfgnn_tpu_torch.train import TrainState, make_loss_fn, train_step
from dfgnn_tpu_torch.train import parity
from dfgnn_tpu_torch.weights import (
    fullgraphnet_params_from_flax,
    gatnet_params_from_flax,
    model_params_from_flax,
)
from helpers import random_graph_coo

MODEL_TOL = dict(rtol=1e-3, atol=1e-4)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _batches(rng, B=2, P=32):
    graphs = []
    for _ in range(B):
        nb = int(rng.integers(P // 2, P))
        r, c, _ = random_graph_coo(rng, nb, 5, zero_deg_frac=0.1)
        graphs.append((r, c, nb))
    return (JaxDenseBatch.from_graph_list(graphs, np_pad=P),
            DenseBatch.from_graph_list(graphs, np_pad=P, device="cpu"))


def _init(jax_model, seed, jb, x):
    """Flax params, initialised under jax.jit (eager JAX compiles every op)."""
    return jax.jit(lambda xx: jax_model.init(jax.random.key(seed), jb, xx, impl="dense"))(
        jnp.asarray(x))


def _close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("conv", ["gat", "agnn", "dotgat", "gt"])
def test_model_forward_matches_jax(rng, conv):
    """Model (Embed inproj and one conv, 2 heads) through the flash path on a
    DenseBatch and through the oracle on its block-diagonal Graph."""
    jb, tb = _batches(rng)
    x = rng.integers(0, 3, size=(jb.n_graphs * jb.np_pad,))
    jm = JaxModel("PATTERN", conv, hidden_size=16, num_heads=2)
    params = _init(jm, 0, jb, x)
    tm = Model("PATTERN", conv, hidden_size=16, num_heads=2, generator=_gen(), device="cpu")
    tm.load_state_dict(model_params_from_flax(params))
    want = jax.jit(lambda p, xx: jm.apply(p, jb, xx, impl="flash"))(params, jnp.asarray(x))
    xt = torch.from_numpy(x)
    _close(tm(tb, xt, impl="flash"), want)
    tg = tb.to_graph()
    jg = jb.to_graph()
    want_ref = jax.jit(lambda p, xx: jm.apply(p, jg, xx, impl="reference"))(
        params, jnp.asarray(x))
    _close(tm(tg, xt, impl="reference"), want_ref)


def test_gat_init_follows_flax():
    """W, a_l and a_r: a plain normal of variance 2 / fan_avg, a_l's fans
    (out_size, num_heads); zero bias."""
    conv = make_conv("gat", 64, 32, 4, generator=_gen(), device="cpu")
    assert conv.W.weight.shape == (128, 64) and conv.a_l.shape == (32, 4)
    assert not conv.W.bias.any()
    for w, fans in ((conv.W.weight, (64, 128)), (conv.a_l, (32, 4)), (conv.a_r, (32, 4))):
        std = float(w.detach().std())
        assert abs(std / np.sqrt(4.0 / sum(fans)) - 1) < 0.25, (w.shape, std)
    # untruncated: a 8192-sample normal reaches past 2.5 standard deviations
    assert float((conv.W.weight.detach().abs() / np.sqrt(4.0 / 192)).max()) > 2.5


def test_gatnet_forward_matches_jax(rng):
    jb, tb = _batches(rng)
    x = rng.standard_normal((jb.n_graphs * jb.np_pad, 5)).astype(np.float32)
    jm = JaxGATNet(num_classes=3, hidden_size=8, num_layers=2, num_heads=2)
    params = _init(jm, 1, jb, x)
    tm = GATNet(num_classes=3, hidden_size=8, num_layers=2, num_heads=2, in_size=5,
                generator=_gen(), device="cpu")
    tm.load_state_dict(gatnet_params_from_flax(params))
    want = jax.jit(lambda p, xx: jm.apply(p, jb, xx, impl="flash"))(params, jnp.asarray(x))
    _close(tm(tb, torch.from_numpy(x), impl="flash"), want)


@functools.cache
def _jax_adam_step(bf16: bool = False):
    """One flax FullGraphNet(gat, 2 heads) Adam step on a seeded task, through
    impl='flash' in fp32 or the bf16 auto route (the whole-layer kernel): its
    inputs, loss, logits, gradients and updated params."""
    rng = np.random.default_rng(3)
    jb, tb = _batches(rng)
    n = jb.n_graphs * jb.np_pad
    x = rng.standard_normal((n, 2)).astype(np.float32)
    y = rng.integers(0, 2, size=n)
    mask = np.asarray(jb.node_mask).reshape(-1).astype(np.float32)
    jm = JaxFullGraphNet(conv="gat", num_classes=2, hidden_size=8, num_layers=2, num_heads=2,
                         dtype=jnp.bfloat16 if bf16 else None)
    params = _init(jm, 2, jb, x)
    opt = optax.adam(1e-2)
    impl = None if bf16 else "flash"

    @jax.jit
    def step(p):
        def loss_fn(p_):
            logits = jm.apply(p_, jb, jnp.asarray(x), impl=impl)
            l = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y))
            return jnp.sum(l * mask) / jnp.maximum(jnp.sum(mask), 1), logits
        (l, logits), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        up, _ = opt.update(g, opt.init(p))
        return l, logits, g, optax.apply_updates(p, up)

    as_sd = lambda tree: fullgraphnet_params_from_flax(jax.tree_util.tree_map(np.asarray, tree))
    loss, logits, grads, after = step(params)
    return tb, x, y, mask, as_sd(params), float(loss), np.asarray(logits), as_sd(grads), as_sd(after)


@pytest.mark.parametrize("remat", [False, True])
def test_fullgraphnet_gat_adam_step_matches_jax(remat):
    """One Adam step of FullGraphNet(gat, 2 heads) through impl='flash': the
    forward, the loss, every gradient and the updated parameters."""
    tb, x, y, mask, params, want_loss, want_logits, grads, after = _jax_adam_step()
    tm = FullGraphNet("gat", num_classes=2, hidden_size=8, num_layers=2, num_heads=2,
                      remat=remat, in_size=2, generator=_gen(), device="cpu")
    tm.load_state_dict(params)
    xt, yt, mt = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)
    _close(tm(tb, xt, impl="flash"), want_logits)
    state = TrainState.create(tm, lr=1e-2, device="cpu")
    loss_fn = make_loss_fn(tm, "node_classification", 2)
    _, loss = train_step(state, lambda *a: loss_fn(*a, impl="flash"), tb, xt, yt, mt)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-4)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), **MODEL_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(), **MODEL_TOL,
                                   err_msg=name)


def test_fullgraphnet_gat_bf16_adam_step_matches_jax():
    """One Adam step of FullGraphNet(gat, 2 heads, dtype=bf16) through its
    auto route, the whole-layer kernel's Function (its plain versions on the
    CPU), against JAX's: the fp32 logits, the loss, every gradient and every
    updated parameter at the bf16 bar, max |port - JAX| / max |JAX| < 5e-2."""
    tb, x, y, mask, params, want_loss, want_logits, grads, after = _jax_adam_step(bf16=True)
    tm = FullGraphNet("gat", num_classes=2, hidden_size=8, num_layers=2, num_heads=2,
                      dtype=torch.bfloat16, in_size=2, generator=_gen(), device="cpu")
    tm.load_state_dict(params)
    xt, yt, mt = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)
    rel = lambda got, want: float((got - want).abs().max()) / float(want.abs().max())
    logits = tm(tb, xt)
    assert logits.dtype == torch.float32
    assert rel(logits.detach(), torch.tensor(want_logits)) < 5e-2
    state = TrainState.create(tm, lr=1e-2, device="cpu")
    flash_mask.reset_launch_counts()
    _, loss = train_step(state, make_loss_fn(tm, "node_classification", 2), tb, xt, yt, mt)
    assert flash_mask.launch_counts() == (0,) * 6  # CPU tensors: plain versions
    assert abs(float(loss) - want_loss) < 5e-2 * abs(want_loss)
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32, name  # Adam updates fp32 parameters
        assert rel(p.grad, grads[name]) < 5e-2, name
        assert rel(p.detach(), after[name]) < 5e-2, name


def test_run_parity_batched_gat_twin():
    """The parity twin trains on the JAX harness's task (graphs, noisy one-hot
    features and labels from the same numpy generator), trains both sides,
    and launches no kernel on the CPU."""
    batch, x, y, mask = parity.batched_inputs(seed=0, n_graphs=4, device="cpu")
    rng = np.random.default_rng(0)  # the JAX harness's draws, in its order
    graphs = jax_synthetic.pattern_like_batch(rng, 4)
    for b, (r, c, n, blk) in enumerate(graphs):
        assert int(batch.node_mask[b].sum()) == n
        assert batch.adj[b, r, c].all() and int(batch.adj[b].sum()) == len(set(zip(r, c)))
        np.testing.assert_array_equal(x[b * 128: b * 128 + n].numpy(),
                                      jax_parity._noisy_onehot(rng, blk, 2))
        np.testing.assert_array_equal(y[b * 128: b * 128 + n].numpy(), blk)
    flash_mask.reset_launch_counts()
    got = parity.run_parity_batched(seed=0, n_graphs=4, hidden=8, layers=2, steps=8,
                                    conv="gat", device="cpu")
    frac1 = float((y * mask).sum() / mask.sum())
    assert got["majority_baseline"] == pytest.approx(max(frac1, 1 - frac1))
    assert len(got["fused_steps"]) == 8
    assert all(np.isfinite(s["loss"]) and (s["fwd_launches"], s["bwd_launches"]) == (0, 0)
               for s in got["fused_steps"])
    assert got["fused_steps"][-1]["loss"] < got["fused_steps"][0]["loss"]
    assert got["gap"] == pytest.approx(abs(got["acc_fused"] - got["acc_unfused"]))
    assert flash_mask.launch_counts() == (0,) * 6
