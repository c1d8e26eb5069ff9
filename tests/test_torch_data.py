"""The port's datasets and collation against the JAX package's, and its
device defaults (CPU)."""

import numpy as np
import pytest
import torch

from dfgnn_tpu.data import collate as jax_collate
from dfgnn_tpu.data import datasets as jax_datasets
from dfgnn_tpu_torch import DenseBatch, GTModel
from dfgnn_tpu_torch.data import collate, datasets
from dfgnn_tpu_torch.train import TrainState


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)  # NaN holes compare equal


@pytest.mark.parametrize("name", ["ogbg-molhiv", "ogbg-molpcba", "MNIST", "PATTERN", "digits"])
def test_load_batched_matches_jax(name):
    got = datasets.load_batched(name, n_graphs=24, quiet=True)
    want = jax_datasets.load_batched(name, n_graphs=24, quiet=True)
    for field in ("name", "task", "num_classes", "feature_kind", "in_dim", "synthetic"):
        assert getattr(got, field) == getattr(want, field), field
    assert len(got) == len(want)
    for (r, c, n), (wr, wc, wn) in zip(got.graphs, want.graphs):
        _same(r, wr)
        _same(c, wc)
        assert n == wn
    for f, wf in zip(got.node_features, want.node_features):
        _same(f, wf)
    if got.task == "node_classification":
        for y, wy in zip(got.labels, want.labels):
            _same(y, wy)
    else:
        _same(got.labels, want.labels)


def test_dataset_registry():
    assert datasets.dataset_names()["batched"] == jax_datasets.dataset_names()["batched"]
    with pytest.raises(KeyError):
        datasets.load_batched("cora")


@pytest.mark.parametrize("name,np_pad", [("PATTERN", 128), ("ogbg-molpcba", None),
                                         ("MNIST", 96)])
def test_batch_iterator_matches_jax(name, np_pad):
    ds = datasets.load_batched(name, n_graphs=20, quiet=True)
    jds = jax_datasets.load_batched(name, n_graphs=20, quiet=True)
    kw = dict(shuffle=True, np_pad=np_pad, seed=3)
    got = list(collate.batch_iterator(ds, 6, **kw, device="cpu"))
    want = list(jax_collate.batch_iterator(jds, 6, **kw))
    assert len(got) == len(want) == 3  # drop_last
    for (b, x, y, m), (wb, wx, wy, wm) in zip(got, want):
        assert b.adj.dtype == torch.uint8 and b.adj.device.type == "cpu"
        _same(b.adj.numpy().astype(bool), wb.adj)
        _same(b.node_mask.numpy(), wb.node_mask)
        assert (b.n_graphs, b.np_pad, b.n_edges, b.n_nodes) == (
            wb.n_graphs, wb.np_pad, wb.n_edges, wb.n_nodes)
        for t, w in ((x, wx), (y, wy), (m, wm)):
            _same(t.numpy(), w)
    last = list(collate.batch_iterator(ds, 6, drop_last=False, device="cpu"))
    assert len(last) == 4 and last[-1][0].n_graphs == 2


def test_collate_dense_matches_jax():
    ds = datasets.load_batched("ogbg-molhiv", n_graphs=10, quiet=True)
    jds = jax_datasets.load_batched("ogbg-molhiv", n_graphs=10, quiet=True)
    idx = np.array([7, 2, 5])
    b, x, y, m = collate.collate_dense(ds, idx, np_pad=64, device="cpu")
    wb, wx, wy, wm = jax_collate.collate_dense(jds, idx, np_pad=64)
    _same(b.adj.numpy().astype(bool), wb.adj)
    for t, w in ((x, wx), (y, wy), (m, wm)):
        _same(t.numpy(), w)


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """Without a card, the constructors, collation and the trainer default
    to "cuda" and raise; they never hand back CPU tensors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graphs = [(np.array([0, 1]), np.array([1, 0]), 2)]
    ds = datasets.load_batched("ogbg-molhiv", n_graphs=4, quiet=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GTModel("PATTERN", out_size=2, hidden_size=8, num_layers=1,
                generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DenseBatch.from_graph_list(graphs, np_pad=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        collate.collate_dense(ds, [0, 1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(collate.batch_iterator(ds, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainState.create(torch.nn.Linear(2, 2))
    # asked for by name, the CPU works
    batch = DenseBatch.from_graph_list(graphs, np_pad=4, device="cpu")
    assert batch.adj.device.type == "cpu"
