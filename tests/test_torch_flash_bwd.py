"""The port's flash-attention backward against the JAX package's (CPU).

The JAX backward runs its Pallas kernel ``_bwd_kernel_dot`` in interpret
mode; the port's ``_FlashDot`` runs the kernel's plain version on CPU
tensors, the same autograd Function that launches the CUDA kernel on the
card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfgnn_tpu.graph import DenseBatch as JaxDenseBatch
from dfgnn_tpu.ops.pallas import flash_mask as jax_flash
from dfgnn_tpu_torch.data.synthetic import attention_inputs
from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.ops import dense_block, flash_mask

FP32_TOL = dict(rtol=1e-4, atol=1e-5)


def _case(seed, B, h, P, f, with_val):
    """attention_inputs (padded nodes, empty rows, edge values) as numpy,
    a JAX and a port DenseBatch over them, and a seeded output gradient."""
    q, k, v, adj, val = attention_inputs(np.random.default_rng(seed), B, h, P, f)
    do = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(np.float32)
    mask = np.ones((B, P), bool)
    jb = JaxDenseBatch(adj=jnp.asarray(adj.astype(bool)), node_mask=jnp.asarray(mask),
                       val=jnp.asarray(val) if with_val else None, n_graphs=B, np_pad=P)
    tb = DenseBatch(adj=torch.from_numpy(adj), node_mask=torch.from_numpy(mask),
                    val=torch.from_numpy(val) if with_val else None, n_graphs=B, np_pad=P)
    return (q, k, v, do), jb, tb


def _port_grads(tb, q, k, v, do, fn=flash_mask.flash_graph_attention):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(tb, *leaves)
    return out, torch.autograd.grad(out, leaves, torch.from_numpy(do))


@pytest.mark.parametrize("with_val", [False, True])
def test_backward_matches_jax_pallas_interpret(with_val):
    (q, k, v, do), jb, tb = _case(0, 2, 2, 16, 8, with_val)
    want_out, vjp = jax.vjp(
        lambda a, b, c: jax_flash.flash_graph_attention(jb, a, b, c, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    flash_mask.LAUNCHES = flash_mask.BWD_LAUNCHES = 0
    out, got = _port_grads(tb, q, k, v, do)
    assert (flash_mask.LAUNCHES, flash_mask.BWD_LAUNCHES) == (0, 0)  # CPU: plain versions
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **FP32_TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FP32_TOL)
    assert (tb.adj.sum(-1) == 0).any()  # empty rows were covered


@pytest.mark.parametrize("with_val", [False, True])
def test_plain_backward_matches_dense_autograd(with_val):
    """At a larger shape, against autograd through the dense oracle, which
    differentiates through the softmax's division: another formula, so the
    bar is the model bar."""
    (q, k, v, do), _, tb = _case(1, 4, 2, 64, 32, with_val)
    _, got = _port_grads(tb, q, k, v, do)
    _, want = _port_grads(tb, q, k, v, do, dense_block.dense_graph_attention)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_wrapper_computes_delta_and_matches_plain():
    (q, k, v, do), _, tb = _case(2, 3, 1, 24, 16, True)
    q, k, v, do = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash_mask.flash_mask_fwd(q, k, v, tb.adj, tb.val, want_lse=True)
    delta = flash_mask.bwd_delta(do, out)
    assert delta.shape == (1, 3, 24) and delta.is_contiguous()
    torch.testing.assert_close(delta, (do * out).sum(-1).permute(2, 0, 1))
    got = flash_mask.flash_mask_bwd(q, k, v, tb.adj, tb.val, out, lse, do)
    want = flash_mask.flash_mask_bwd_plain(q, k, v, tb.adj, tb.val, lse, do, delta)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_plain_backward_rounds_ds_and_p_to_bf16():
    """bf16 inputs: gradients come back in bf16, near the fp32 ones."""
    (q, k, v, do), _, tb = _case(3, 2, 1, 32, 16, False)
    q, k, v, do = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash_mask.flash_mask_fwd_plain(q, k, v, tb.adj)
    want = flash_mask.flash_mask_bwd_plain(q, k, v, tb.adj, None, lse, do,
                                           flash_mask.bwd_delta(do, out))
    b16 = [t.bfloat16() for t in (q, k, v, do)]
    out16, lse16 = flash_mask.flash_mask_fwd_plain(*b16[:3], tb.adj)
    got = flash_mask.flash_mask_bwd_plain(*b16[:3], tb.adj, None, lse16, b16[3],
                                          flash_mask.bwd_delta(b16[3], out16))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w, rtol=0, atol=2 ** -6 * float(w.abs().max()))


def test_flash_dot_takes_expanded_gradients_and_constant_edge_values():
    """``.sum()`` hands the backward an expanded gradient; ``val`` gets none."""
    (q, k, v, _), _, tb = _case(4, 2, 2, 16, 8, True)
    val = tb.val.clone().requires_grad_(True)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    flash_mask.flash_graph_attention(tb.replace(val=val), *leaves).sum().backward()
    assert val.grad is None
    dense_leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    want = torch.autograd.grad(dense_block.dense_graph_attention(tb, *dense_leaves).sum(),
                               dense_leaves)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=1e-4, atol=1e-4)


def test_no_lse_and_nothing_saved_without_gradients():
    (q, k, v, _), _, tb = _case(5, 2, 1, 16, 8, False)
    with torch.no_grad():
        out = flash_mask.flash_graph_attention(tb, *map(torch.from_numpy, (q, k, v)))
    assert out.grad_fn is None and out.shape == (2, 16, 1, 8)


def test_backward_wrapper_raises_for_a_device_without_kernel():
    (q, k, v, do), _, tb = _case(6, 2, 1, 16, 8, False)
    meta = [torch.from_numpy(a).to("meta") for a in (q, k, v, do)]
    lse = torch.zeros(1, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no flash_mask_bwd kernel"):
        flash_mask.flash_mask_bwd(*meta[:3], tb.adj.to("meta"), None, meta[2], lse, meta[3])
