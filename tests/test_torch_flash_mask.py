"""The port's flash attention and dense oracle against the JAX package (CPU).

The JAX flash kernel runs in Pallas interpret mode, as tests/test_flash_mask.py
runs it; the port's wrapper runs its plain version on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfgnn_tpu.graph import DenseBatch as JaxDenseBatch
from dfgnn_tpu.ops import dense_block as jax_dense
from dfgnn_tpu.ops.pallas import flash_mask as jax_flash
from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.ops import dense_block, flash_mask
from helpers import random_graph_coo

FP32_TOL = dict(rtol=1e-4, atol=1e-5)


def _batches(rng, B, P, with_val=False):
    """The same graphs as a JAX and a port DenseBatch, with empty rows."""
    graphs = []
    for _ in range(B):
        nb = int(rng.integers(P // 2, P))
        r, c, _ = random_graph_coo(rng, nb, 8, zero_deg_frac=0.15)
        graphs.append((r, c, nb))
    jb = JaxDenseBatch.from_graph_list(graphs, np_pad=P)
    tb = DenseBatch.from_graph_list(graphs, np_pad=P, device="cpu")
    if with_val:
        adj = np.asarray(jb.adj)
        val = np.where(adj, rng.standard_normal(adj.shape), 0.0).astype(np.float32)
        jb = jb.replace(val=jnp.asarray(val))
        tb = tb.replace(val=torch.from_numpy(val))
    return jb, tb


def _feats(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol=FP32_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("P", [64, 128])
@pytest.mark.parametrize("h,f", [(1, 32), (2, 16)])
def test_flash_matches_jax_interpret(rng, P, h, f):
    jb, tb = _batches(rng, 3, P)
    q, k, v = (_feats(rng, 3, P, h, f) for _ in range(3))
    want = jax_flash.flash_graph_attention(jb, *map(jnp.asarray, (q, k, v)))
    got = flash_mask.flash_graph_attention(tb, *map(torch.from_numpy, (q, k, v)))
    _close(got, want)


def test_flash_edge_values_match_jax_interpret(rng):
    jb, tb = _batches(rng, 2, 64, with_val=True)
    q, k, v = (_feats(rng, 2, 64, 2, 16) for _ in range(3))
    want = jax_flash.flash_graph_attention(jb, *map(jnp.asarray, (q, k, v)))
    got = flash_mask.flash_graph_attention(tb, *map(torch.from_numpy, (q, k, v)))
    # the bar of tests/test_flash_mask.py for edge values
    _close(got, want, dict(rtol=2e-4, atol=2e-4))


@pytest.mark.parametrize("with_val", [False, True])
def test_lse_matches_jax_fwd(rng, with_val):
    jb, tb = _batches(rng, 2, 64, with_val=with_val)
    q, k, v = (_feats(rng, 2, 64, 2, 16) for _ in range(3))
    hm = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    jval = None if jb.val is None else jb.val
    want_out, want_lse = jax_flash._fwd(
        jb.adj.astype(jnp.uint8), hm(q), hm(k), hm(v), None, None, "dot", 0.2, True,
        jax.lax.Precision.HIGHEST, want_lse=True, val=jval)
    got_out, got_lse = flash_mask.flash_mask_fwd(
        *map(torch.from_numpy, (q, k, v)), tb.adj, tb.val, want_lse=True)
    assert got_lse.shape == (2, 2, 64)  # [h, B, P]
    _close(got_lse, want_lse)
    _close(got_out, np.asarray(want_out).transpose(0, 2, 1, 3))
    assert (got_lse.numpy() == flash_mask.NEG_BIG).any()  # empty rows covered


@pytest.mark.parametrize("score", ["dot", "add"])
def test_dense_matches_jax(rng, score):
    jb, tb = _batches(rng, 2, 64, with_val=score == "add")
    q, k, v = (_feats(rng, 2, 64, 2, 16) for _ in range(3))
    er, ec = (_feats(rng, 2, 64, 2) for _ in range(2))
    kw = dict(score=score, return_weights=True)
    if score == "add":
        jargs, targs = (None, None, jnp.asarray(v)), (None, None, torch.from_numpy(v))
        jkw = dict(kw, e_row=jnp.asarray(er), e_col=jnp.asarray(ec), negative_slope=0.1)
        tkw = dict(kw, e_row=torch.from_numpy(er), e_col=torch.from_numpy(ec),
                   negative_slope=0.1)
    else:
        jargs = tuple(map(jnp.asarray, (q, k, v)))
        targs = tuple(map(torch.from_numpy, (q, k, v)))
        jkw = tkw = kw
    want_out, want_w = jax_dense.dense_graph_attention(jb, *jargs, **jkw)
    got_out, got_w = dense_block.dense_graph_attention(tb, *targs, **tkw)
    _close(got_out, want_out)
    _close(got_w, want_w)


def test_dense_dropout_is_inverted_dropout(rng):
    """Dropout draws from a torch.Generator, so it is held to the JAX
    semantics in distribution: each weight is kept with probability 1 - rate
    and scaled by 1 / (1 - rate)."""
    _, tb = _batches(rng, 2, 64)
    P, rate = 64, 0.3
    q, k = (torch.from_numpy(_feats(rng, 2, P, 1, 8)) for _ in range(2))
    v = torch.eye(P).reshape(1, P, 1, P).expand(2, P, 1, P)  # out[b, r, 0, c] = w[b, 0, r, c]
    gen = torch.Generator().manual_seed(0)
    out, w = dense_block.dense_graph_attention(tb, q, k, v, dropout_rate=rate,
                                               dropout_generator=gen, return_weights=True)
    dropped, clean = out[:, :, 0, :], w[:, 0]
    live = clean > 0
    kept = dropped[live] != 0
    torch.testing.assert_close(dropped[live][kept], clean[live][kept] / (1 - rate))
    n = int(live.sum())
    frac = float(kept.float().mean())
    assert abs(frac - (1 - rate)) < 4 * np.sqrt(rate * (1 - rate) / n), (frac, n)
    assert not dropped[~live].any()
    with pytest.raises(ValueError, match="dropout_generator"):
        dense_block.dense_graph_attention(tb, q, k, v, dropout_rate=rate)


def test_plain_version_is_differentiable_on_cpu(rng):
    _, tb = _batches(rng, 2, 64)
    q, k, v = (torch.from_numpy(_feats(rng, 2, 64, 1, 16)).requires_grad_(True)
               for _ in range(3))
    t = torch.from_numpy(_feats(rng, 2, 64, 1, 16))
    (flash_mask.flash_graph_attention(tb, q, k, v) * t).sum().backward()
    got = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    (dense_block.dense_graph_attention(tb, q, k, v) * t).sum().backward()
    for a, x in zip(got, (q, k, v)):
        torch.testing.assert_close(a, x.grad, rtol=1e-3, atol=1e-4)


def test_plain_bf16_rounds_like_the_kernel(rng):
    """bf16 inputs: scores and sums in fp32, the output in bf16 near the
    fp32 result."""
    _, tb = _batches(rng, 2, 64)
    q, k, v = (torch.from_numpy(_feats(rng, 2, 64, 1, 16)) for _ in range(3))
    out16, lse16 = flash_mask.flash_mask_fwd_plain(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), tb.adj)
    out32, _ = flash_mask.flash_mask_fwd_plain(q, k, v, tb.adj)
    assert out16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    torch.testing.assert_close(out16.float(), out32, rtol=0, atol=3e-2)
