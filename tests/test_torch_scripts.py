"""The port's last single-device twins on the CPU at tiny sizes: ``Timer``
and the ``utils`` exports, the ablation's rows, ``train_real``'s loss and
metric and a one-epoch run, ``graph_stats`` and ``plot_results``.

The JAX scripts are loaded by path (``scripts/`` is not a package) and their
host-side functions called on the same numpy inputs; the JAX loss runs under
``jax.jit``.  No Pallas kernel and no JAX training step runs here.
"""

import importlib.util
import json
import os
import shutil
import sys
import time
import types

import jax
import numpy as np
import pytest
import torch

from dfgnn_tpu import formats as jax_formats
from dfgnn_tpu.graph import Graph as JaxGraph
from dfgnn_tpu_torch import formats
from dfgnn_tpu_torch.data.synthetic import power_law_graph
from dfgnn_tpu_torch.graph import Graph
from dfgnn_tpu_torch.scripts import ablation, graph_stats, plot_results, train_real
from dfgnn_tpu_torch.utils import Timer, benchmark, check_correct

_ROOT = os.path.join(os.path.dirname(__file__), "..")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(_ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stand_in():
    """A power-law graph with rows wider than the segment split (64) and more
    nodes than the forced source block (32768), so every layout differs."""
    rng = np.random.default_rng(1)
    rows, cols = power_law_graph(rng, 40000, avg_deg=4.0)[:2]
    return rows, cols, 40000


def test_timer_on_the_cpu_and_its_refusal_without_a_card(monkeypatch):
    benchmark_module = sys.modules["dfgnn_tpu_torch.utils.benchmark"]
    assert (Timer, benchmark, check_correct) == (
        benchmark_module.Timer, benchmark_module.benchmark, benchmark_module.check_correct)
    with Timer(device="cpu") as t:
        time.sleep(0.02)
    assert 20.0 <= t.elapsed_ms < 2000.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("cuda", "cuda:0"):
        entered = False
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            with Timer(device=device):
                entered = True
        assert not entered


def test_ablation_batched_rows_match_the_oracle(capsys):
    rows = ablation.batched_rows(4, 16, 1, rng=np.random.default_rng(0), device="cpu")
    assert [r["impl"] for r in rows] == ["reference", "dense", "flash", "flash_fused"]
    assert all(r["ok"] for r in rows), [r["label"] for r in rows if not r["ok"]]
    # the impls on the whole batch against the oracle on the sub-batch's nodes
    for r in rows[1:]:
        np.testing.assert_allclose(r["out"], rows[0]["out"], rtol=1e-3, atol=1e-5)
        assert r["n_edges"] == rows[1]["n_edges"] >= rows[0]["n_edges"] > 0
    assert all(r["ms"] is None and not any(r["launches"]) for r in rows)  # CPU: plain versions
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and all(line.endswith("correct=OK") for line in out)


def test_ablation_full_rows_match_the_oracle(capsys):
    rows, cols, n = _stand_in()
    g = Graph.from_coo(rows, cols, n, device="cpu")
    got = ablation.full_rows(g, 8, 2, rng=np.random.default_rng(0))
    assert len(got) == 1 + len(ablation.LAYOUTS)
    assert all(r["ok"] for r in got), [r["label"] for r in got if not r["ok"]]
    assert got[0]["pad"] is None and all(r["pad"] >= 1.0 for r in got[1:])
    assert len({r["pad"] for r in got[1:]}) >= 3  # the layouts do differ here
    lines = capsys.readouterr().out.splitlines()
    assert [line.split("  ")[1].strip() for line in lines] == [r["label"] for r in got]
    assert all(line.endswith("correct=OK") for line in lines)


def test_ablation_layouts_pad_as_the_jax_layouts():
    rows, cols, n = _stand_in()
    g = Graph.from_coo(rows, cols, n, device="cpu")
    jg = JaxGraph.from_coo(rows, cols, n)
    for label, kw, _ in ablation.LAYOUTS:
        ours, theirs = formats.build_buckets(g, **kw), jax_formats.build_buckets(jg, **kw)
        assert type(ours).__name__ == type(theirs).__name__, label
        assert ours.padded_edges == theirs.padded_edges, label


@pytest.mark.parametrize("task", ["graph_classification", "graph_classification_multilabel"])
def test_loss_on_logits_matches_jax(task):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((12, 10)).astype(np.float32)
    m = rng.random(12) < 0.75
    if task == "graph_classification":
        y = rng.integers(-1, 10, size=12)
    else:
        y = (rng.random((12, 10)) < 0.4).astype(np.float32)
        y[rng.random(y.shape) < 0.2] = np.nan
    jax_loss = _jax_script("train_real")._loss_on_logits
    want = jax.jit(lambda l, y, m: jax_loss(l, y, m, task))(logits, y, m)
    got = train_real._loss_on_logits(torch.from_numpy(logits), torch.from_numpy(y),
                                     torch.from_numpy(m), task)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_metric_matches_sklearn_with_ties_and_holes():
    """The JAX script's ``_metric`` calls ``sklearn.metrics``; the twin's is
    the port's own AP."""
    jax_metric = _jax_script("train_real")._metric
    rng = np.random.default_rng(4)
    y = (rng.random((60, 6)) < 0.3).astype(np.float64)
    y[rng.random(y.shape) < 0.25] = np.nan
    y[:, 5] = np.where(np.isnan(y[:, 5]), np.nan, 1.0)  # one class only: skipped
    scores = np.round(rng.random((60, 6)), 1)  # ten levels: many tied scores
    ds = types.SimpleNamespace(task="graph_classification_multilabel")
    got, name = train_real._metric(ds, y, scores)
    want, want_name = jax_metric(ds, y, scores)
    assert name == want_name == "mean-AP"
    np.testing.assert_allclose(got, want, rtol=1e-12)
    ds = types.SimpleNamespace(task="graph_classification")
    labels, logits = rng.integers(0, 10, 60), rng.standard_normal((60, 10))
    assert train_real._metric(ds, labels, logits) == jax_metric(ds, labels, logits)


def test_train_real_one_epoch_on_digits(capsys):
    rc = train_real.main(["--dataset", "digits", "--dim", "8", "--n-layers", "2",
                          "--epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    for impl in ("    flash", "reference"):
        assert f"[{impl}] epoch  0: loss=" in out and f"[{impl}] total " in out
    assert "final test metric: fused=" in out and "gap=" in out


def test_train_real_names_scikit_learn_where_it_is_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)  # the card's machine has none
    with pytest.raises(ImportError, match="scikit-learn"):
        train_real.main(["--dataset", "digits-func", "--device", "cpu"])


@pytest.mark.parametrize("dataset", ["cora", "PATTERN"])
def test_graph_stats_prints_the_jax_lines(capsys, dataset):
    _jax_script("graph_stats").main(["--dataset", dataset])
    want = capsys.readouterr().out
    graph_stats.main(["--dataset", dataset, "--device", "cpu"])
    assert capsys.readouterr().out == want and want.startswith(dataset)


def test_plot_results_reads_only_the_port_files(tmp_path, capsys):
    res = tmp_path / "results"
    res.mkdir()

    def blob(dataset, rates):  # the batch and full twins' schema (their --store-result)
        return {"args": {"dataset": dataset}, "device": "cuda", "results": {
            f: {"ok": True, "ms": 1.0, "edges_per_s": r} for f, r in rates.items()}}

    port = {"batch_torch_PATTERN_gt_128": blob("PATTERN", {"flash": 3e9, "dense": None}),
            "full_torch_cora_gt_128": blob("cora", {"bucket": 2e9, "reference": 1e9}),
            "full_torch_reddit_gt_128": blob("reddit", {"bucket": 4e9})}
    tpu = {"batch_tpu_gt_128": blob("TPU", {"flash": 9e9}),  # JAX names: TPU times
           "full_tpu_gt_128": blob("TPU", {"bucket": 9e9})}
    for name, b in {**port, **tpu}.items():
        (res / f"{name}.json").write_text(json.dumps(b))
    # the shmoo twin's own stored rows, and a JAX shmoo file beside them
    shutil.copy(os.path.join(_ROOT, "results", "h100_shmoo_gt.json"), res)
    shutil.copy(os.path.join(_ROOT, "results", "shmoo_gat.json"), res)
    made = plot_results.main(["--results", str(res), "--out", str(tmp_path / "figs"),
                              "--device", "cpu"])
    names = sorted(os.path.basename(p) for p in made)
    assert names == ["fig1_batch.png", "fig2_full.png", "fig3_super.png", "fig4_dim_gt.png",
                     "fig5_batch_gt.png"]
    assert all(os.path.getsize(p) > 0 for p in made)
    by_name = {os.path.basename(p): d for p, d in made.items()}
    assert by_name["fig1_batch.png"] == {"PATTERN": {"flash": 3e9}}
    assert set(by_name["fig2_full.png"]) == {"cora"}
    assert set(by_name["fig3_super.png"]) == {"reddit"}
    assert set(by_name["fig4_dim_gt.png"]) == {"dense", "flash", "flash_fused", "fp32_flash"}
    assert capsys.readouterr().out.count("wrote ") == 5
