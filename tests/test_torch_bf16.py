"""The port's whole-layer path and bf16 mode against the JAX package (CPU):
the convs in bf16 at each impl, the bf16 auto routing, a GTModel trained
through ``impl="flash_fused"``, and the bf16 GAT parity harness.

The JAX Pallas kernels run in interpret mode at P <= 32, B*h <= 8, under
``jax.jit``; the port runs its kernels' plain versions on CPU tensors.  bf16
results are held at max |port - JAX| / max |JAX| < 5e-2 (JAX's bf16 bar,
tests/test_flash_mask.py), and each output's dtype must be JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfgnn_tpu.graph import DenseBatch as JaxDenseBatch
from dfgnn_tpu.models import GTModel as JaxGTModel
from dfgnn_tpu.models import make_conv as jax_make_conv
from dfgnn_tpu.train import loop as jax_loop
from dfgnn_tpu_torch import weights
from dfgnn_tpu_torch.data.collate import collate_dense
from dfgnn_tpu_torch.data.datasets import load_batched
from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.models import GTModel, conv as conv_mod, make_conv
from dfgnn_tpu_torch.ops import flash_mask
from dfgnn_tpu_torch.train import loop, parity
from helpers import random_graph_coo

BF16_REL = 5e-2
MODEL_TOL = dict(rtol=1e-3, atol=1e-5)
DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}


def _batches(rng, B=2, P=32):
    graphs = []
    for _ in range(B):
        nb = int(rng.integers(P // 2, P))
        r, c, _ = random_graph_coo(rng, nb, 5, zero_deg_frac=0.1)
        graphs.append((r, c, nb))
    return (JaxDenseBatch.from_graph_list(graphs, np_pad=P),
            DenseBatch.from_graph_list(graphs, np_pad=P, device="cpu"))


def _rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got.detach().float().numpy() - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("conv,impl", [
    ("gt", "flash_fused"), ("gt", "flash"), ("gt", "dense"),
    ("gat", "flash_fused"), ("gat", "flash"), ("gat", "dense"),
    ("agnn", "flash"), ("agnn", "dense"),
])
def test_bf16_conv_matches_jax(rng, conv, impl):
    """A bf16 conv (2 heads, din != out) with the same fp32 parameters in
    both packages: the output's dtype is JAX's (bf16, or fp32 for GAT's dense
    formulation, where JAX promotes the fp32 weights against a bf16 z) and
    its values agree at the bf16 bar."""
    jb, tb = _batches(rng)
    x = rng.standard_normal((jb.n_graphs * jb.np_pad, 12)).astype(np.float32)
    jconv = jax_make_conv(conv, out_size=16, num_heads=2, dtype=jnp.bfloat16)
    params = jax.jit(lambda xx: jconv.init(jax.random.key(0), jb, xx, impl="dense"))(
        jnp.asarray(x))
    want = jax.jit(lambda p, xx: jconv.apply(p, jb, xx, impl=impl))(params, jnp.asarray(x))
    sd = {}
    weights._conv(sd, weights._top(jax.tree_util.tree_map(np.asarray, params)), conv, "c",
                  conv)
    tconv = make_conv(conv, 12, 16, 2, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    tconv.load_state_dict({k[2:]: v for k, v in sd.items()})
    assert all(p.dtype == torch.float32 for p in tconv.parameters())  # fp32 parameters
    got = tconv(tb, torch.from_numpy(x), impl=impl)
    assert got.dtype == DTYPES[want.dtype]
    assert _rel_err(got, want) < BF16_REL


def _dense_batch(n_graphs, val=False):
    adj = torch.ones(n_graphs, 128, 128, dtype=torch.uint8)
    return DenseBatch(adj=adj, node_mask=torch.ones(n_graphs, 128, dtype=torch.bool),
                      val=adj.float() if val else None, n_graphs=n_graphs, np_pad=128)


@pytest.mark.parametrize("conv,n_graphs,width,want", [
    ("gt", 64, 128, "flash_fused"), ("gt", 256, 64, "flash_fused"), ("gt", 256, 128, "flash"),
    ("gt", 512, 128, "dense"), ("gt", 2048, 128, "dense"), ("gt", 256, 256, "dense"),
    ("agnn", 64, 16, "flash"), ("agnn", 512, 128, "flash"), ("agnn", 256, 256, "dense"),
    ("agnn", 1024, 128, "dense"),
])
def test_auto_bf16_routing_follows_the_thresholds(conv, n_graphs, width, want):
    """The rule at points of the shmoo grid (PATTERN batches of n_graphs at
    P=128): what the recorded H100 thresholds pick there.  A batch with edge
    values never takes flash_fused: it takes flash."""
    assert conv_mod._auto_bf16_dense_batch(conv, _dense_batch(n_graphs), width) == want
    with_val = conv_mod._auto_bf16_dense_batch(conv, _dense_batch(n_graphs, val=True), width)
    assert with_val == ("flash" if want == "flash_fused" else want)


def test_bf16_auto_routes_and_force_method_wins(monkeypatch):
    """GAT's bf16 auto on a DenseBatch is the whole-layer path; GT's follows
    _auto_bf16_dense_batch; DFGNN_TPU_FORCE_METHOD is read before either."""
    calls = []
    monkeypatch.setattr(conv_mod, "flash_layer_attention_gat",
                        lambda *a, **kw: calls.append("gat flash_fused"))
    monkeypatch.setattr(conv_mod, "flash_layer_attention",
                        lambda *a, **kw: calls.append("gt flash_fused"))
    monkeypatch.setattr(conv_mod, "graph_attention",
                        lambda *a, method, **kw: calls.append(method) or a[3])
    monkeypatch.delenv("DFGNN_TPU_FORCE_METHOD", raising=False)
    batch, x = _dense_batch(2), torch.zeros(256, 8)
    gen = torch.Generator().manual_seed(0)
    gat = make_conv("gat", 8, 8, dtype=torch.bfloat16, generator=gen, device="cpu")
    gt = make_conv("gt", 8, 8, dtype=torch.bfloat16, generator=gen, device="cpu")
    gat(batch, x)
    gat(_dense_batch(2, val=True), x)  # edge values: the decomposed path
    gt(batch, x)
    make_conv("gat", 8, 8, generator=gen, device="cpu")(batch, x)  # fp32 auto
    monkeypatch.setenv("DFGNN_TPU_FORCE_METHOD", "dense")
    gat(batch, x)
    gt(batch, x)
    assert calls == ["gat flash_fused", "auto", "gt flash_fused", "auto", "dense", "dense"]


def test_gtmodel_flash_fused_adam_step_matches_jax():
    """GTModel (2 layers, hidden 16) through impl='flash_fused' in both
    packages from the same weights, on an ogbg-molhiv batch at P=32: the
    logits, the loss, every gradient (at JAX's bar, over the largest) and
    every parameter after one Adam step.  A bias on k shifts each score row by
    a constant, so its gradient is zero up to rounding and Adam's first step
    on it is lr times the sign of that rounding: for k_proj.bias the step is
    held through its gradient alone."""
    from dfgnn_tpu.data import collate as jax_collate
    from dfgnn_tpu.data import datasets as jax_datasets

    jds = jax_datasets.load_batched("ogbg-molhiv", n_graphs=64, quiet=True)
    tds = load_batched("ogbg-molhiv", n_graphs=64, quiet=True)
    idx = np.array([i for i, g in enumerate(tds.graphs) if g[2] <= 32])[:4]
    jb, jx, jy, jm = jax_collate.collate_dense(jds, idx, np_pad=32)
    jb = jb.replace(adj=jnp.asarray(jb.adj), node_mask=jnp.asarray(jb.node_mask))
    jbatch = (jb, *map(jnp.asarray, (jx, jy, jm)))
    jmodel = JaxGTModel("ogbg-molhiv", out_size=1, hidden_size=16, num_layers=2,
                        method="flash_fused")
    params = jax.jit(lambda *a: jmodel.init(jax.random.key(0), *a, impl="dense"))(jb, jbatch[1])
    jstate = jax_loop.TrainState.create(jmodel, params, lr=1e-3, step_lr_every=20)
    jloss = jax_loop.make_loss_fn(jmodel, tds.task, tds.num_classes)

    @jax.jit
    def jstep(p, opt_state, *batch):
        loss, grads = jax.value_and_grad(jloss)(p, *batch)
        updates, opt_state = jstate.opt.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), loss, jmodel.apply(p, *batch[:2]), grads

    after, want_loss, want_logits, grads = jstep(params, jstate.opt_state, *jbatch)
    model = GTModel("ogbg-molhiv", out_size=1, hidden_size=16, num_layers=2,
                    method="flash_fused", generator=torch.Generator().manual_seed(0),
                    device="cpu")
    model.load_state_dict(weights.gtmodel_params_from_flax(params))
    tb = collate_dense(tds, idx, np_pad=32, device="cpu")
    np.testing.assert_allclose(model(*tb[:2]).detach().numpy(), np.asarray(want_logits),
                               **MODEL_TOL)
    state = loop.TrainState.create(model, lr=1e-3, step_lr_every=20, device="cpu")
    flash_mask.reset_launch_counts()
    _, loss = loop.train_step(state, loop.make_loss_fn(model, tds.task, tds.num_classes), *tb)
    assert flash_mask.launch_counts() == (0,) * 6  # CPU tensors: plain versions
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    as_sd = lambda tree: weights.gtmodel_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                                  tree))
    want, want_grads = as_sd(after), as_sd(grads)
    scale = max(float(g.abs().max()) for g in want_grads.values())
    for name, p in model.named_parameters():
        assert float((p.grad - want_grads[name]).abs().max()) / scale < 2e-4, name
        if not name.endswith("k_proj.bias"):
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), **MODEL_TOL,
                                       err_msg=name)


def test_run_parity_batched_gat_bf16():
    """The bf16 GAT parity harness at a tiny size: the fused side trains in
    bf16 through the whole-layer path, the oracle in fp32; both learn the
    task past the majority baseline + 0.1, and their gap is JAX's bound."""
    got = parity.run_parity_batched(seed=0, n_graphs=8, hidden=16, layers=2, steps=30,
                                    conv="gat", dtype=torch.bfloat16, device="cpu")
    base = got["majority_baseline"]
    assert got["acc_fused"] > base + 0.1 and got["acc_unfused"] > base + 0.1, got
    assert got["gap"] <= 0.05, got
    assert all(np.isfinite(s["loss"]) and s["layer_launches"] == 0
               for s in got["fused_steps"])
