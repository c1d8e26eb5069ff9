"""The port's generators and DenseBatch against the JAX package's (CPU)."""

import numpy as np
import pytest
import torch

from dfgnn_tpu.data import synthetic as jax_synthetic
from dfgnn_tpu.graph import DenseBatch as JaxDenseBatch
from dfgnn_tpu_torch.data import synthetic
from dfgnn_tpu_torch.graph import DenseBatch


def _assert_same_tree(a, b):
    assert type(a) is type(b)
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name,args", [
    ("constant_degree_graph", (50, 6)),
    ("sbm_graph", (90,)),
    ("pattern_like_batch", (6,)),
    ("small_graph_batch", (6,)),
])
def test_generators_match_jax_package(name, args):
    got = getattr(synthetic, name)(np.random.default_rng(7), *args)
    want = getattr(jax_synthetic, name)(np.random.default_rng(7), *args)
    _assert_same_tree(got, want)


@pytest.mark.parametrize("gen,np_pad", [
    ("pattern_like_batch", 128),
    ("small_graph_batch", None),
    ("small_graph_batch", 160),
])
def test_dense_batch_matches_jax_package(gen, np_pad):
    graphs = [(r, c, n) for r, c, n, _ in
              getattr(synthetic, gen)(np.random.default_rng(3), 5)]
    got = DenseBatch.from_graph_list(graphs, np_pad=np_pad, device="cpu")
    want = JaxDenseBatch.from_graph_list(graphs, np_pad=np_pad)
    assert got.adj.dtype == torch.uint8 and got.node_mask.dtype == torch.bool
    np.testing.assert_array_equal(got.adj.numpy().astype(bool), np.asarray(want.adj))
    np.testing.assert_array_equal(got.node_mask.numpy(), np.asarray(want.node_mask))
    assert (got.n_graphs, got.np_pad, got.n_edges, got.n_nodes) == (
        want.n_graphs, want.np_pad, want.n_edges, want.n_nodes)
    assert got.val is None


def test_dense_batch_to_and_replace():
    graphs = [(np.array([0, 1]), np.array([1, 0]), 2), (np.array([2]), np.array([0]), 3)]
    batch = DenseBatch.from_graph_list(graphs, np_pad=8, device="cpu")
    val = torch.ones(2, 8, 8)
    moved = batch.replace(val=val).to("cpu")
    assert moved.adj.dtype == torch.uint8
    assert moved.val is not None and moved.n_edges == 3 and moved.n_nodes == 5
    assert batch.val is None  # replace returns a new batch
    with pytest.raises(ValueError, match="np_pad"):
        DenseBatch.from_graph_list(graphs, np_pad=2, device="cpu")
