"""Routing, refusals and import hygiene of the PyTorch port (CPU)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from dfgnn_tpu_torch import DenseBatch, GTConv, graph_attention
from dfgnn_tpu_torch.ops import dense_block, edge_dropout, flash_mask
from dfgnn_tpu_torch.utils.benchmark import benchmark


def _small(seed=0, B=2, P=16, h=1, f=8):
    rng = np.random.default_rng(seed)
    graphs = [(rng.integers(0, 10, 30), rng.integers(0, 10, 30), 10) for _ in range(B)]
    batch = DenseBatch.from_graph_list(graphs, np_pad=P, device="cpu")
    q, k, v = (torch.from_numpy(rng.standard_normal((B, P, h, f)).astype(np.float32))
               for _ in range(3))
    return batch, q, k, v


@pytest.fixture
def spy(monkeypatch):
    """Replaces both implementations with recorders of what was called."""
    calls = []
    monkeypatch.setattr(flash_mask, "flash_graph_attention",
                        lambda *a, **kw: calls.append("flash"))
    monkeypatch.setattr(dense_block, "dense_graph_attention",
                        lambda *a, **kw: calls.append(
                            "dense_weights" if kw.get("return_weights") else "dense"))
    monkeypatch.delenv("DFGNN_TPU_FORCE_METHOD", raising=False)
    return calls


@pytest.mark.parametrize("method,return_weights,force,want", [
    ("auto", False, None, "flash"),
    ("flash", False, None, "flash"),
    ("dense", False, None, "dense"),
    ("reference", False, None, "dense"),
    ("auto", True, None, "dense_weights"),
    ("flash", True, None, "dense_weights"),
    ("auto", False, "dense", "dense"),
    ("auto", False, "reference", "dense"),
    ("flash", False, "dense", "flash"),  # the override changes only "auto"
])
def test_method_routing(spy, monkeypatch, method, return_weights, force, want):
    if force:
        monkeypatch.setenv("DFGNN_TPU_FORCE_METHOD", force)
    batch, q, k, v = _small()
    graph_attention(batch, q, k, v, method=method, return_weights=return_weights)
    assert spy == [want]


def test_unknown_method_raises():
    batch, q, k, v = _small()
    with pytest.raises(ValueError, match="invalid for DenseBatch"):
        graph_attention(batch, q, k, v, method="bucket")


@pytest.mark.parametrize("layout", [(), {"rows": [0]}, "graph"])
def test_layouts_not_ported_raise(layout):
    _, q, k, v = _small()
    with pytest.raises(TypeError, match="unsupported graph layout"):
        graph_attention(layout, q, k, v)


def test_flash_refuses_what_is_not_ported():
    """Dot-score dropout (kernels #1 and #3) runs and applies the edge-hash
    mask of the generator's seed to the normalised weights; the add score,
    ported with kernels #2 and #4, runs and matches the dense oracle."""
    batch, q, k, v = _small()
    gen = torch.Generator().manual_seed(0)
    seed = edge_dropout.seed_from_generator(torch.Generator().manual_seed(0))
    got = graph_attention(batch, q, k, v, dropout_rate=0.1, dropout_generator=gen)
    w = dense_block.dense_graph_attention(batch, q, k, v, return_weights=True)[1]
    keep = flash_mask.dropout_factor(seed, 0.1, 2, 1, 16, "cpu")  # [B, h, P, P]
    want = torch.einsum("bhrc,bchf->brhf", w * keep, v)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    rng = np.random.default_rng(1)
    e_row, e_col = (torch.from_numpy(rng.standard_normal((2, 16, 1)).astype(np.float32))
                    for _ in range(2))
    add = dict(score="add", e_row=e_row, e_col=e_col, negative_slope=0.1)
    torch.testing.assert_close(graph_attention(batch, None, None, v, **add),
                               graph_attention(batch, None, None, v, method="dense", **add),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="score"):
        flash_mask.flash_graph_attention(batch, q, k, v, score="cosine")
    # dropout stays reachable through the dense path
    out = graph_attention(batch, q, k, v, method="dense", dropout_rate=0.1,
                          dropout_generator=gen)
    assert out.shape == v.shape


def test_gtconv_flash_fused_raises(monkeypatch):
    """The whole-layer kernel takes a DenseBatch without edge values: with
    them, or on a Graph, impl='flash_fused' raises, as flash_layer_attention
    does in the JAX package."""
    batch, *_ = _small()
    conv = GTConv(8, 8, generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.zeros(2 * 16, 8)
    assert conv(batch, x, impl="flash_fused").shape == (2 * 16, 8)
    with_val = batch.replace(val=batch.adj.float())
    with pytest.raises(NotImplementedError, match="edge values"):
        conv(with_val, x, impl="flash_fused")
    with pytest.raises(ValueError, match="DenseBatch"):
        conv(batch.to_graph(), x, impl="flash_fused")
    monkeypatch.setenv("DFGNN_TPU_FORCE_METHOD", "flash_fused")  # GTConv reads it too
    with pytest.raises(NotImplementedError, match="edge values"):
        conv(with_val, x)


def test_cpu_calls_leave_the_launch_counter_at_zero():
    batch, q, k, v = _small()
    flash_mask.LAUNCHES = 0
    out = graph_attention(batch, q, k, v)
    out2, lse = flash_mask.flash_mask_fwd(q, k, v, batch.adj, want_lse=True)
    assert flash_mask.LAUNCHES == 0
    torch.testing.assert_close(out, out2)
    assert lse.shape == (1, 2, 16)


def test_wrapper_raises_for_a_device_without_kernel():
    batch, q, k, v = _small()
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="no flash_mask_fwd kernel"):
        flash_mask.flash_mask_fwd(*meta, batch.adj.to("meta"))


def test_benchmark_needs_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark(lambda: None)


def test_package_imports_no_jax():
    code = ("import sys, dfgnn_tpu_torch, dfgnn_tpu_torch.weights, "
            "dfgnn_tpu_torch.utils.benchmark, dfgnn_tpu_torch.data.synthetic, "
            "dfgnn_tpu_torch.data.datasets, dfgnn_tpu_torch.data.collate, "
            "dfgnn_tpu_torch.train, dfgnn_tpu_torch.utils.config, "
            "dfgnn_tpu_torch.scripts.train_gtconv, dfgnn_tpu_torch.scripts.profile_train_step, "
            "dfgnn_tpu_torch.scripts.train_parity, dfgnn_tpu_torch.scripts.test_batch_graph, "
            "dfgnn_tpu_torch.ops.reference, dfgnn_tpu_torch.ops.edge_dropout, "
            "dfgnn_tpu_torch.train.parity, dfgnn_tpu_torch.scripts.shmoo, "
            "dfgnn_tpu_torch.formats, dfgnn_tpu_torch.ops.bucket, dfgnn_tpu_torch.ops.gather, "
            "dfgnn_tpu_torch.scripts.test_full_graph, dfgnn_tpu_torch.scripts.train_gatconv, "
            "dfgnn_tpu_torch.scripts.microbench_gather\n"
            "assert 'yaml' not in sys.modules and 'sklearn' not in sys.modules\n"
            "assert 'scipy' not in sys.modules\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'dfgnn_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
