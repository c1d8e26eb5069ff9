"""The port's whole-layer attention (kernels #5 and #6) and the fp32-score,
bf16-value interface of kernels #2 and #4, against the JAX package (CPU).

The JAX Pallas kernels run in interpret mode at P <= 32, B*h <= 8, under
``jax.jit``; the port's autograd Functions run the kernels' plain versions on
CPU tensors, the same Functions that launch the CUDA kernels on the card.
With dropout, both packages get the uint32 seed that JAX draws from its key,
so the two masks are the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfgnn_tpu.graph import DenseBatch as JaxDenseBatch
from dfgnn_tpu.ops import edge_dropout as jax_drop
from dfgnn_tpu.ops.pallas import flash_mask as jax_flash
from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.ops import flash_mask
from helpers import random_graph_coo

FP32_TOL = dict(rtol=1e-4, atol=1e-5)
# max |port - JAX| of each gradient over the largest |JAX gradient| of all the
# parameters: tests/test_flash_mask.py's bar (d b_k is zero up to rounding,
# since a bias on k shifts each score row by a constant)
GRAD_REL = 2e-4
DROP_TOL = dict(rtol=2e-4, atol=2e-4)


def _batches(rng, B=2, P=32):
    """The same graphs, with empty rows and padded nodes, as a JAX and a port
    DenseBatch."""
    graphs = []
    for _ in range(B):
        nb = int(rng.integers(P // 2, P))
        r, c, _ = random_graph_coo(rng, nb, 5, zero_deg_frac=0.15)
        graphs.append((r, c, nb))
    return (JaxDenseBatch.from_graph_list(graphs, np_pad=P),
            DenseBatch.from_graph_list(graphs, np_pad=P, device="cpu"))


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _assert_grads(got, want):
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        err = float(np.abs(g.numpy() - np.asarray(w)).max()) / scale
        assert err < GRAD_REL, (i, err)


@pytest.mark.parametrize("din,h,f", [(16, 2, 8), (24, 1, 16), (20, 2, 12)])
def test_layer_dot_and_grads_match_jax_interpret(din, h, f):
    """flash_layer_attention (kernel #5 and its recompute backward through #1
    and #3) against JAX's, forward and the gradients of x, W and b; f = 12
    is a head dim off the powers of two, which #5 takes since it streams."""
    rng = np.random.default_rng(din)
    jb, tb = _batches(rng)
    n = jb.n_graphs * jb.np_pad
    x = _normal(rng, (n, din))
    params = [a for _ in range(3) for a in (_normal(rng, (din, h * f), din ** -0.5),
                                             _normal(rng, (h * f,), 0.1))]
    t = _normal(rng, (n, h * f))
    scale = f ** -0.5

    @jax.jit
    def jax_loss(x_, *ps):
        out = jax_flash.flash_layer_attention(jb, x_, *ps, num_heads=h, scale=scale,
                                              interpret=True)
        return jnp.sum(out * t), out

    (_, want), want_grads = jax.value_and_grad(
        jax_loss, argnums=tuple(range(7)), has_aux=True)(*map(jnp.asarray, (x, *params)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, *params)]
    flash_mask.reset_launch_counts()
    out = flash_mask.flash_layer_attention(tb, *leaves, num_heads=h, scale=scale)
    (out * torch.from_numpy(t)).sum().backward()
    assert flash_mask.launch_counts() == (0,) * 6  # CPU tensors: plain versions
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FP32_TOL)
    _assert_grads([leaf.grad for leaf in leaves], want_grads)


@pytest.mark.parametrize("rate,P,f", [
    pytest.param(0.0, 32, 8, id="0.0"),
    pytest.param(0.4, 32, 8, id="0.4"),
    # an off-grid head dim, and an np_pad off the kernels' 16-row tiles
    pytest.param(0.0, 32, 12, id="0.0-f12"),
    pytest.param(0.4, 32, 12, id="0.4-f12"),
    pytest.param(0.0, 24, 8, id="0.0-P24"),
    pytest.param(0.4, 24, 8, id="0.4-P24"),
])
def test_layer_add_and_grads_match_jax_interpret(rate, P, f):
    """flash_layer_attention_gat's inner Function (kernel #6 and its
    recompute backward through #2 and #4) against JAX's _flash_layer_add,
    with the gradients of x, W, b, a_l and a_r; dropout with the same seed."""
    rng = np.random.default_rng(5)
    jb, tb = _batches(rng, P=P)
    B, din, h = 2, 16, 2
    x = _normal(rng, (B, P, din))
    w = _normal(rng, (h, din, f), din ** -0.5)
    b, al, ar = (_normal(rng, (h, f), 0.5) for _ in range(3))
    t = _normal(rng, (B, h, P, f))
    seed = int(jax_drop.seed_from_key(jax.random.key(9))) if rate else 0
    adj8 = jb.adj.astype(jnp.uint8)
    jseed = jnp.asarray(seed, jnp.uint32)

    @jax.jit
    def jax_loss(*args):
        out = jax_flash._flash_layer_add(0.2, True, jax.lax.Precision.HIGHEST, rate, adj8,
                                         jseed, *args)
        return jnp.sum(out * t), out

    (_, want), want_grads = jax.value_and_grad(
        jax_loss, argnums=tuple(range(5)), has_aux=True)(*map(jnp.asarray, (x, w, b, al, ar)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b, al, ar)]
    out = flash_mask._FlashLayerAdd.apply(*leaves, tb.adj, 0.2, seed, rate)
    (out * torch.from_numpy(t).permute(0, 2, 1, 3)).sum().backward()
    tol = FP32_TOL if rate == 0.0 else DROP_TOL
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want).transpose(0, 2, 1, 3),
                               **tol)
    _assert_grads([leaf.grad for leaf in leaves], want_grads)


def test_layer_attention_gat_matches_jax_with_flax_layout(rng):
    """flash_layer_attention_gat takes the flax layer's parameters (W
    [din, h*f], a_l / a_r [f, h]) and node-flat features, as JAX's does."""
    jb, tb = _batches(rng)
    din, h, f = 12, 2, 8
    x = _normal(rng, (64, din))
    w, b = _normal(rng, (din, h * f), din ** -0.5), _normal(rng, (h * f,), 0.1)
    al, ar = _normal(rng, (f, h), 0.5), _normal(rng, (f, h), 0.5)
    want = jax.jit(lambda *a: jax_flash.flash_layer_attention_gat(
        jb, *a, num_heads=h, negative_slope=0.1, interpret=True))(
        *map(jnp.asarray, (x, w, b, al, ar)))
    got = flash_mask.flash_layer_attention_gat(tb, *map(torch.from_numpy, (x, w, b, al, ar)),
                                               num_heads=h, negative_slope=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


def test_add_plain_versions_take_fp32_scores_with_bf16_v(rng):
    """The bf16 GAT layer hands kernels #2 and #4 fp32 scalars with a bf16 v.
    The plain versions against JAX's _flash_add (interpret) on such inputs:
    the output in v's dtype, d e_row and d e_col in fp32, dv in bf16."""
    jb, tb = _batches(rng)
    B, P, h, f = 2, 32, 2, 8
    er, ec = _normal(rng, (B, P, h)), _normal(rng, (B, P, h))
    v = jnp.asarray(_normal(rng, (B, P, h, f))).astype(jnp.bfloat16)
    do = jnp.asarray(_normal(rng, (B, P, h, f))).astype(jnp.bfloat16)
    seed, rate = 4242, 0.3
    adj8 = jb.adj.astype(jnp.uint8)
    prec = jax.lax.Precision.DEFAULT

    @jax.jit
    def jax_fwd_bwd(er_, ec_, v_):
        out, vjp = jax.vjp(lambda a, b_, c: jax_flash._flash_add(
            adj8, jnp.asarray(seed, jnp.uint32), a, b_, c, None, 0.2, True, prec, rate),
            er_, ec_, v_)
        return out, vjp(do.transpose(0, 2, 1, 3))

    rows, hm = (lambda a: jnp.asarray(a).transpose(2, 0, 1)), (lambda a: a.transpose(0, 2, 1, 3))
    want_out, (want_der, want_dec, want_dv) = jax_fwd_bwd(rows(er), rows(ec), hm(v))
    tv = torch.tensor(np.asarray(v.astype(jnp.float32))).bfloat16()
    tdo = torch.tensor(np.asarray(do.astype(jnp.float32))).bfloat16()
    ter, tec = torch.from_numpy(er), torch.from_numpy(ec)
    kw = dict(slope=0.2, seed=seed, rate=rate)
    out, lse = flash_mask.flash_add_fwd(ter, tec, tv, tb.adj, want_lse=True, **kw)
    der, dec, dv = flash_mask.flash_add_bwd(ter, tec, tv, tb.adj, None, out, lse, tdo, **kw)
    assert (out.dtype, der.dtype, dec.dtype, dv.dtype) == (
        torch.bfloat16, torch.float32, torch.float32, torch.bfloat16)
    assert (want_out.dtype, want_der.dtype, want_dv.dtype) == (
        jnp.bfloat16, jnp.float32, jnp.bfloat16)
    pairs = [(out, hm(want_out)), (der, want_der.transpose(1, 2, 0)),
             (dec, want_dec.transpose(1, 2, 0)), (dv, hm(want_dv))]
    for got, want in pairs:
        want = np.asarray(want.astype(jnp.float32))
        err = float(np.abs(got.float().numpy() - want).max()) / float(np.abs(want).max())
        assert err < 2 ** -6, err  # a bf16 step of the largest value
