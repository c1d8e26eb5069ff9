"""The port's edge-list Graph and segment-op oracle against the JAX package's (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfgnn_tpu.graph import DenseBatch as JaxDenseBatch
from dfgnn_tpu.graph import Graph as JaxGraph
from dfgnn_tpu.models.model import graph_pool as jax_graph_pool
from dfgnn_tpu.ops import reference as jax_ref
from dfgnn_tpu_torch import graph_attention
from dfgnn_tpu_torch.graph import DenseBatch, Graph
from dfgnn_tpu_torch.models import graph_pool
from dfgnn_tpu_torch.ops import reference
from helpers import random_graph_coo

FP32_TOL = dict(rtol=1e-4, atol=1e-5)


def _graphs(rng, n=40, with_val=False):
    """One graph, as the JAX package's and the port's, with rows that have
    no edges and unsorted COO input."""
    rows, cols, _ = random_graph_coo(rng, n, 5, zero_deg_frac=0.2)
    perm = rng.permutation(len(rows))
    rows, cols = rows[perm], cols[perm]
    val = rng.standard_normal(len(rows)).astype(np.float32) if with_val else None
    jg = JaxGraph.from_coo(rows, cols, n, val=val, edge_pad_multiple=32)
    tg = Graph.from_coo(rows, cols, n, val=val, edge_pad_multiple=32, device="cpu")
    return jg, tg


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("with_val", [False, True])
def test_from_coo_matches_jax(rng, with_val):
    jg, tg = _graphs(rng, with_val=with_val)
    for name in ("indptr", "rows", "cols", "val"):
        if getattr(jg, name) is None:
            assert getattr(tg, name) is None
        else:
            _same(getattr(tg, name), getattr(jg, name))  # the same edge order
    assert (tg.n_nodes, tg.n_edges, tg.e_pad) == (jg.n_nodes, jg.n_edges, jg.e_pad)
    _same(tg.edge_mask, jg.edge_mask)
    _same(tg.degrees, jg.degrees)


def test_to_graph_matches_jax(rng):
    graphs = []
    for _ in range(3):
        n = int(rng.integers(8, 16))
        r, c, _ = random_graph_coo(rng, n, 4, zero_deg_frac=0.2)
        graphs.append((r, c, n))
    jg = JaxDenseBatch.from_graph_list(graphs, np_pad=16).to_graph()
    tg = DenseBatch.from_graph_list(graphs, np_pad=16, device="cpu").to_graph()
    for name in ("indptr", "rows", "cols", "node_mask", "graph_id"):
        _same(getattr(tg, name), getattr(jg, name))
    assert (tg.n_nodes, tg.n_edges, tg.n_graphs, tg.val) == (jg.n_nodes, jg.n_edges,
                                                              jg.n_graphs, None)
    x = rng.standard_normal((tg.n_nodes, 3)).astype(np.float32)
    for op in ("sum", "mean"):
        np.testing.assert_allclose(graph_pool(tg, torch.from_numpy(x), op).numpy(),
                                   np.asarray(jax_graph_pool(jg, jnp.asarray(x), op)),
                                   **FP32_TOL)


@pytest.mark.parametrize("score", ["dot", "add"])
@pytest.mark.parametrize("with_val", [False, True])
def test_reference_ops_and_grads_match_jax(rng, score, with_val):
    jg, tg = _graphs(rng, with_val=with_val)
    n, h, f = jg.n_nodes, 2, 8
    q, k, v, t = (rng.standard_normal((n, h, f)).astype(np.float32) for _ in range(4))
    er, ec = (rng.standard_normal((n, h)).astype(np.float32) for _ in range(2))

    def jax_loss(q_, k_, v_, er_, ec_):
        out, w = jax_ref.graph_attention_reference(
            jg, q_, k_, v_, score=score, e_row=er_, e_col=ec_, negative_slope=0.1,
            return_weights=True)
        return jnp.sum(out * t), (out, w)

    (_, (want, want_w)), want_grads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*map(jnp.asarray, (q, k, v, er, ec)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, er, ec)]
    out, w = reference.graph_attention_reference(
        tg, *leaves[:3], score=score, e_row=leaves[3], e_col=leaves[4], negative_slope=0.1,
        return_weights=True)
    (out * torch.from_numpy(t)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FP32_TOL)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(want_w), **FP32_TOL)
    used = (0, 1, 2) if score == "dot" else (2, 3, 4)
    for i in used:
        np.testing.assert_allclose(leaves[i].grad.numpy(), np.asarray(want_grads[i]),
                                   rtol=1e-4, atol=1e-4)
    assert not out.detach()[tg.degrees == 0].any()  # rows without edges give 0


def test_dispatch_on_a_graph_runs_the_oracle(rng, monkeypatch):
    monkeypatch.delenv("DFGNN_TPU_FORCE_METHOD", raising=False)
    _, tg = _graphs(rng)
    q, k, v = (torch.from_numpy(rng.standard_normal((tg.n_nodes, 1, 4)).astype(np.float32))
               for _ in range(3))
    want = reference.graph_attention_reference(tg, q, k, v)
    for method in ("auto", "reference"):
        torch.testing.assert_close(graph_attention(tg, q, k, v, method=method), want)
    for method in ("dense", "flash"):
        with pytest.raises(ValueError, match="invalid for Graph"):
            graph_attention(tg, q, k, v, method=method)
    gen = torch.Generator().manual_seed(0)
    out, w = graph_attention(tg, q, k, v, dropout_rate=0.5, dropout_generator=gen,
                             return_weights=True)
    clean = reference.graph_attention_reference(tg, q, k, v, return_weights=True)[1]
    live = clean > 0
    kept = w[live] != 0
    torch.testing.assert_close(w[live][kept], clean[live][kept] * 2)
    assert 0.3 < float(kept.float().mean()) < 0.7
