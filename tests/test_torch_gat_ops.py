"""The port's edge-dropout hash and additive-score flash attention against the
JAX package (CPU).

The JAX flash kernels run in Pallas interpret mode at P <= 32, B*h <= 8,
under ``jax.jit``; the port's wrappers run their plain versions on CPU
tensors.  With dropout, the port gets the uint32 seed that JAX draws from
its key, so the two masks are the same.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfgnn_tpu.graph import DenseBatch as JaxDenseBatch
from dfgnn_tpu.ops import edge_dropout as jax_drop
from dfgnn_tpu.ops.pallas import flash_mask as jax_flash
from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.ops import dense_block, edge_dropout, flash_mask
from helpers import random_graph_coo

FP32_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 32 - 1, 2718281828])
def test_edge_hash_is_bitwise_jax(seed):
    rng = np.random.default_rng(seed % 1000)
    dst = np.concatenate([rng.integers(0, 2 ** 31 - 1, 300), [0, 2 ** 31 - 1]]).astype(np.int32)
    src = np.concatenate([rng.integers(0, 2 ** 31 - 1, 300), [2 ** 31 - 1, 0]]).astype(np.int32)
    head = np.arange(8, dtype=np.int32)[:, None]
    want = np.asarray(jax_drop.edge_hash(np.uint32(seed), dst, src, head))
    got = edge_dropout.edge_hash(seed, torch.from_numpy(dst.astype(np.int64)),
                                 torch.from_numpy(src.astype(np.int64)), torch.from_numpy(head))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    for rate in (0.1, 0.4, 0.5, 0.999):
        assert edge_dropout.keep_threshold(rate) == int(jax_drop.keep_threshold(rate))
        want = np.asarray(jax_drop.keep_scale(np.uint32(seed), dst, src, head, rate))
        got = edge_dropout.keep_scale(seed, torch.from_numpy(dst.astype(np.int64)),
                                      torch.from_numpy(src.astype(np.int64)),
                                      torch.from_numpy(head), rate).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_seed_from_generator_draws_a_uint32_on_the_host():
    a = edge_dropout.seed_from_generator(torch.Generator().manual_seed(1))
    b = edge_dropout.seed_from_generator(torch.Generator().manual_seed(1))
    assert a == b and 0 <= a < 2 ** 32
    with pytest.raises(ValueError, match="CPU generator"):
        # a generator on the card (none can be made here): only its device is read
        edge_dropout.seed_from_generator(SimpleNamespace(device=torch.device("cuda")))


def _batches(rng, B, P, with_val):
    """The same graphs as a JAX and a port DenseBatch, with empty rows."""
    graphs = []
    for _ in range(B):
        nb = int(rng.integers(P // 2, P))
        r, c, _ = random_graph_coo(rng, nb, 6, zero_deg_frac=0.15)
        graphs.append((r, c, nb))
    jb = JaxDenseBatch.from_graph_list(graphs, np_pad=P)
    tb = DenseBatch.from_graph_list(graphs, np_pad=P, device="cpu")
    if with_val:
        adj = np.asarray(jb.adj)
        val = np.where(adj, rng.standard_normal(adj.shape), 0.0).astype(np.float32)
        jb = jb.replace(val=jnp.asarray(val))
        tb = tb.replace(val=torch.from_numpy(val))
    return jb, tb


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("with_val", [False, True])
def test_add_attention_and_vjp_match_jax_interpret(rng, with_val, rate):
    B, P, h, f = 2, 32, 2, 8
    jb, tb = _batches(rng, B, P, with_val)
    er, ec = (rng.standard_normal((B, P, h)).astype(np.float32) for _ in range(2))
    v, t = (rng.standard_normal((B, P, h, f)).astype(np.float32) for _ in range(2))
    key = jax.random.key(3)

    @jax.jit
    def jax_loss(er_, ec_, v_):
        out = jax_flash.flash_graph_attention(
            jb, None, None, v_, score="add", e_row=er_, e_col=ec_, negative_slope=0.1,
            interpret=True, dropout_rate=rate, dropout_rng=key if rate else None)
        return jnp.sum(out * t), out

    (_, want), want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (er, ec, v)))
    seed = int(jax_drop.seed_from_key(key)) if rate else 0
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (er, ec, v)]
    flash_mask.reset_launch_counts()
    out = flash_mask._FlashAdd.apply(*leaves, tb.adj, tb.val, 0.1, seed, rate)
    (out * torch.from_numpy(t)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FP32_TOL)
    for leaf, g in zip(leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), **FP32_TOL)
    assert flash_mask.launch_counts() == (0,) * 6  # CPU tensors: plain versions
    assert not out.detach()[~tb.node_mask].any()  # padded and empty rows give exactly 0


def test_add_lse_and_plain_bwd_match_jax(rng):
    """The plain versions against JAX's _fwd / _bwd directly: lse, and the
    backward's d e_row, d e_col, dv in the kernel's layout."""
    B, P, h, f = 2, 32, 2, 8
    jb, tb = _batches(rng, B, P, with_val=True)
    er, ec = (rng.standard_normal((B, P, h)).astype(np.float32) for _ in range(2))
    v, do = (rng.standard_normal((B, P, h, f)).astype(np.float32) for _ in range(2))
    seed, rate = 12345, 0.3
    hm = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    rows = lambda x: jnp.asarray(x).transpose(2, 0, 1)
    adj8, jseed = jb.adj.astype(jnp.uint8), jnp.asarray(seed, jnp.uint32)
    prec = jax.lax.Precision.HIGHEST

    @jax.jit
    def jax_fwd_bwd(er_, ec_, v_, do_):
        out, lse = jax_flash._fwd(adj8, None, None, v_, er_, ec_, "add", 0.2, True, prec,
                                  seed=jseed, rate=rate, val=jb.val)
        grads = jax_flash._bwd("add", 0.2, True, prec, rate, adj8, jseed,
                               (er_, ec_, v_, lse, out), do_, val=jb.val)
        return out, lse, grads

    want_out, want_lse, (want_der, want_dec, want_dv) = jax_fwd_bwd(
        rows(er), rows(ec), hm(v), hm(do))
    kw = dict(slope=0.2, seed=seed, rate=rate)
    tt = [torch.from_numpy(a) for a in (er, ec, v, do)]
    out, lse = flash_mask.flash_add_fwd(*tt[:3], tb.adj, tb.val, want_lse=True, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out).transpose(0, 2, 1, 3),
                               **FP32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **FP32_TOL)
    der, dec, dv = flash_mask.flash_add_bwd(*tt[:3], tb.adj, tb.val, out, lse, tt[3], **kw)
    assert der.shape == dec.shape == (B, P, h) and der.is_contiguous()
    np.testing.assert_allclose(der.numpy(), np.asarray(want_der).transpose(1, 2, 0), **FP32_TOL)
    np.testing.assert_allclose(dec.numpy(), np.asarray(want_dec).transpose(1, 2, 0), **FP32_TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv).transpose(0, 2, 1, 3),
                               **FP32_TOL)


def test_flash_add_dropout_draws_its_seed_from_the_generator(rng):
    """Through flash_graph_attention the seed comes from dropout_generator:
    the same generator state gives the same mask; without it, it raises."""
    _, tb = _batches(rng, 2, 32, with_val=False)
    er, ec = (torch.from_numpy(rng.standard_normal((2, 32, 1)).astype(np.float32))
              for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((2, 32, 1, 8)).astype(np.float32))
    add = dict(score="add", e_row=er, e_col=ec, dropout_rate=0.5)
    outs = [flash_mask.flash_graph_attention(
        tb, None, None, v, **add, dropout_generator=torch.Generator().manual_seed(4))
        for _ in range(2)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    clean = dense_block.dense_graph_attention(tb, None, None, v, score="add", e_row=er,
                                              e_col=ec)
    assert not torch.allclose(outs[0], clean)
    with pytest.raises(ValueError, match="dropout_generator"):
        flash_mask.flash_graph_attention(tb, None, None, v, **add)


def test_add_auto_takes_flash_at_an_off_grid_head_dim(rng):
    """method="auto" on a DenseBatch with the additive score at f = 12 (no
    power of two): the port takes the flash path, as JAX's auto does, and its
    forward and VJP match JAX's interpret-mode Pallas kernels."""
    from dfgnn_tpu.ops import graph_attention as jax_graph_attention
    from dfgnn_tpu_torch.ops import graph_attention

    B, P, h, f = 2, 32, 1, 12
    jb, tb = _batches(rng, B, P, with_val=False)
    er, ec = (rng.standard_normal((B, P, h)).astype(np.float32) for _ in range(2))
    v, t = (rng.standard_normal((B, P, h, f)).astype(np.float32) for _ in range(2))

    @jax.jit
    def jax_loss(er_, ec_, v_):
        out = jax_graph_attention(jb, None, None, v_, score="add", e_row=er_, e_col=ec_,
                                  method="auto")
        return jnp.sum(out * t), out

    (_, want), want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (er, ec, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (er, ec, v)]
    out = graph_attention(tb, None, None, leaves[2], score="add", e_row=leaves[0],
                          e_col=leaves[1], method="auto")
    assert type(out.grad_fn).__name__ == "_FlashAddBackward"
    (out * torch.from_numpy(t)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FP32_TOL)
    for leaf, g in zip(leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), **FP32_TOL)
