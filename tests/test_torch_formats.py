"""The port's bucketed layouts, CSC view, full-graph stand-ins and graph
generators against the JAX package's (CPU, numpy only on both sides)."""

import dataclasses

import numpy as np
import pytest
import torch

from dfgnn_tpu import formats as jax_formats
from dfgnn_tpu.data import datasets as jax_datasets
from dfgnn_tpu.data import synthetic as jax_synthetic
from dfgnn_tpu.graph import Graph as JaxGraph
from dfgnn_tpu_torch import formats
from dfgnn_tpu_torch.data import datasets, synthetic
from dfgnn_tpu_torch.graph import Graph
from helpers import random_graph_coo


def _graphs(seed=0, n=300, with_val=False):
    """The same graph in both packages: zero-degree rows, a super-node row of
    degree 200 and a few rows wider than the default split of 64."""
    rng = np.random.default_rng(seed)
    rows, cols, val = random_graph_coo(rng, n, 6, super_node_deg=200, with_val=with_val)
    hub = np.repeat([n // 2, n - 1], [90, 70])
    rows = np.concatenate([rows, hub])
    cols = np.concatenate([cols, rng.integers(0, n, hub.size)])
    if val is not None:
        val = np.concatenate([val, rng.standard_normal(hub.size).astype(np.float32)])
    return (JaxGraph.from_coo(rows, cols, n, val=val),
            Graph.from_coo(rows, cols, n, val=val, device="cpu"))


def assert_layout_equal(got, want, path="layout"):
    """Every field of a port layout equals the JAX layout's: arrays by value,
    static fields exactly, nested layouts and bucket tuples recursively."""
    assert type(got).__name__ == type(want).__name__, path
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        where = f"{path}.{f.name}"
        if isinstance(w, tuple):
            assert len(g) == len(w), where
            for i, (gi, wi) in enumerate(zip(g, w)):
                assert_layout_equal(gi, wi, f"{where}[{i}]")
        elif dataclasses.is_dataclass(w):
            assert_layout_equal(g, w, where)
        elif w is None or isinstance(w, (int, float, str)):
            assert g == w, (where, g, w)
        else:
            assert isinstance(g, torch.Tensor), where
            w = np.asarray(w)
            assert g.dtype == (torch.bool if w.dtype == bool else
                               torch.float32 if w.dtype == np.float32 else torch.int64), where
            np.testing.assert_array_equal(g.numpy(), w, err_msg=where)


@pytest.mark.parametrize("kw", [
    {},                                           # pow2 ladder, segments past 64
    {"split_width": None},                        # one super-wide bucket, no segments
    {"ladder": "x1.5", "min_width": 8},
    {"widths": [8, 32, 64]},
    {"split_width": 32, "edge_chunk": 1024},
    {"with_transpose": True},
    {"with_edge_ids": True},
    {"src_block_rows": 150},
    {"src_block_rows": 128, "with_transpose": True, "with_edge_ids": True},
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default")
@pytest.mark.parametrize("with_val", [False, True])
def test_build_buckets_equals_jax(kw, with_val):
    jg, tg = _graphs(with_val=with_val)
    want = jax_formats.build_buckets(jg, **kw)
    got = formats.build_buckets(tg, **kw)
    assert_layout_equal(got, want)
    assert got.padded_edges == want.padded_edges


def test_preprocess_names_the_same_layouts():
    jg, tg = _graphs(1)
    for fmt in ("reference", "bucketed", "two_phase", "bucketed_train"):
        want = jax_formats.preprocess(fmt, jg, split_width=64)
        got = formats.preprocess(fmt, tg, split_width=64)
        if fmt == "reference":
            assert got is tg
        else:
            assert_layout_equal(got, want)
    with pytest.raises(KeyError, match="unknown format"):
        formats.preprocess("nope", tg)


def test_auto_blocking_follows_the_threshold(monkeypatch):
    """``src_block_rows="auto"`` blocks only above ``_AUTO_BLOCK_ABOVE`` nodes,
    never when it is None."""
    _, tg = _graphs(2)
    monkeypatch.setattr(formats, "_AUTO_BLOCK_ABOVE", None)
    assert isinstance(formats.build_buckets(tg), formats.BucketedGraph)
    monkeypatch.setattr(formats, "_AUTO_BLOCK_ABOVE", 100)
    monkeypatch.setattr(formats, "_SRC_BLOCK_ROWS", 128)
    got = formats.build_buckets(tg)
    assert isinstance(got, formats.BlockedBucketedGraph) and got.block_rows == 128
    assert_layout_equal(got, jax_formats.build_buckets(_graphs(2)[0], src_block_rows=128))


def test_layout_to_moves_every_tensor():
    _, tg = _graphs(3)
    bg = formats.build_buckets(tg, with_transpose=True, with_edge_ids=True)
    moved = bg.to("meta")
    assert all(t.device.type == "meta" for b in (*moved.buckets, *moved.transpose.buckets)
               for t in (b.row_ids, b.nbr, b.emask, b.edge_ids) if t is not None)
    assert moved.segments.seg_id.device.type == "meta"
    assert moved.n_nodes == bg.n_nodes and moved.e_pad == bg.e_pad


def test_csc_aux_equals_jax():
    jg, tg = _graphs(4)
    assert_layout_equal(tg.to_csc(), jg.to_csc())


@pytest.mark.parametrize("name,scale", [("cora", 0.1), ("arxiv", 0.002), ("reddit", 0.001)])
def test_full_graph_stand_ins_equal_jax(name, scale):
    """Graph, features, planted labels and masks of the synthetic stand-ins."""
    want = jax_datasets.load_full_graph(name, scale=scale, quiet=True)
    got = datasets.load_full_graph(name, scale=scale, quiet=True)
    assert got.synthetic and want.synthetic
    assert (got.name, got.num_classes, got.n_nodes, got.n_edges) == (
        want.name, want.num_classes, want.n_nodes, want.n_edges)
    for field in ("rows", "cols", "features", "labels", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert datasets.dataset_names() == jax_datasets.dataset_names()


def test_full_graph_generators_equal_jax():
    for fn, args in (("community_graph", (500, 7)), ("power_law_graph", (500,))):
        got = getattr(synthetic, fn)(np.random.default_rng(5), *args)
        want = getattr(jax_synthetic, fn)(np.random.default_rng(5), *args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
