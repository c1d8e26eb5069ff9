"""The port's profiling and checkpoint utilities, its package exports, and
its timing, GraphWorld and sampled-training twins on the CPU at tiny sizes.

The checkpoint round trip mirrors ``test_dropout_ckpt.py::
test_checkpoint_roundtrip``.  The twins check against their oracles here
and time nothing (no card).
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from dfgnn_tpu.ops import reference as jax_reference
from dfgnn_tpu_torch.models import GTConv
from dfgnn_tpu_torch.scripts import (test_batch_graph, test_full_graph, test_gt_graphworld,
                                     train_batch_graph_timing, train_full_graph_timing,
                                     train_sampled)
from dfgnn_tpu_torch.train import TrainState
from dfgnn_tpu_torch.utils.benchmark import github_table
from dfgnn_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from dfgnn_tpu_torch.utils.profiling import annotate, profile_region, timed_region


def _state(seed):
    """A TrainState of one GTConv after one Adam step (moments filled)."""
    model = GTConv(6, 8, 2, generator=torch.Generator().manual_seed(seed), device="cpu")
    state = TrainState.create(model, lr=1e-2, device="cpu")
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    state.opt.step()
    return state


def _dicts(state):
    return {"model": state.model.state_dict(), "opt": state.opt.state_dict()}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for key in a:
            _assert_same(a[key], b[key])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_checkpoint_roundtrip_latest_and_explicit_step(tmp_path):
    old, new = _state(0), _state(1)
    save_checkpoint(str(tmp_path / "ck"), _dicts(old), step=3)
    target = save_checkpoint(str(tmp_path / "ck"), _dicts(new), step=12)
    assert os.path.basename(target) == "step_12"
    restored, step = restore_checkpoint(str(tmp_path / "ck"), _dicts(new))
    assert step == 12  # the latest, by number (12 sorts before 3 as text)
    _assert_same(restored, _dicts(new))
    restored, step = restore_checkpoint(str(tmp_path / "ck"), None, step=3)
    assert step == 3
    _assert_same(restored, _dicts(old))
    # the restored dicts load back into a fresh state
    fresh = _state(2)
    fresh.model.load_state_dict(restored["model"])
    fresh.opt.load_state_dict(restored["opt"])
    _assert_same(_dicts(fresh), _dicts(old))


def test_checkpoint_missing_raises(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), None)
    save_checkpoint(str(tmp_path / "ck"), {"w": torch.arange(3)}, step=1)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "ck"), None, step=2)


def test_profile_region_writes_trace_with_annotation(tmp_path):
    x = torch.randn(64, 64)
    with profile_region("region", log_dir=str(tmp_path)) as path:
        with annotate("inner_range"):
            (x @ x).sum()
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"region", "inner_range"} <= names
    with profile_region("off", log_dir=str(tmp_path), enabled=False) as path:
        assert path is None
    assert not (tmp_path / "off.trace.json").exists()


def test_timed_region_prints(capsys):
    with timed_region("work"):
        torch.randn(8).sum()
    assert capsys.readouterr().out.startswith("[work] ")


def test_exports_match_the_jax_package():
    """The JAX package's top-level and ``ops`` names, each the port's own
    counterpart (the oracle's functions come from ``ops/reference.py``)."""
    import dfgnn_tpu
    import dfgnn_tpu.ops
    import dfgnn_tpu_torch
    import dfgnn_tpu_torch.ops
    from dfgnn_tpu_torch import formats, graph
    from dfgnn_tpu_torch.ops import dispatch, reference

    for name in ("sddmm_dot", "sddmm_add", "edge_softmax", "spmm", "graph_attention_reference"):
        assert getattr(dfgnn_tpu.ops, name) is getattr(jax_reference, name)
        assert getattr(dfgnn_tpu_torch.ops, name) is getattr(reference, name)
    assert dfgnn_tpu_torch.ops.graph_attention is dispatch.graph_attention
    for name, want in (("Graph", graph.Graph), ("CSCAux", graph.CSCAux),
                       ("DenseBatch", graph.DenseBatch), ("formats", formats)):
        assert hasattr(dfgnn_tpu, name) and getattr(dfgnn_tpu_torch, name) is want


def test_new_modules_import_no_jax():
    code = ("import sys, dfgnn_tpu_torch.data.sampling, dfgnn_tpu_torch.native, "
            "dfgnn_tpu_torch.utils.profiling, "
            "dfgnn_tpu_torch.utils.checkpoint, dfgnn_tpu_torch.scripts.train_sampled, "
            "dfgnn_tpu_torch.scripts.train_batch_graph_timing, "
            "dfgnn_tpu_torch.scripts.train_full_graph_timing, "
            "dfgnn_tpu_torch.scripts.test_gt_graphworld, dfgnn_tpu_torch.scripts.ablation, "
            "dfgnn_tpu_torch.scripts.train_real, dfgnn_tpu_torch.scripts.graph_stats, "
            "dfgnn_tpu_torch.scripts.plot_results\n"
            "from dfgnn_tpu_torch import CSCAux, formats\n"
            "from dfgnn_tpu_torch.utils import Timer, benchmark, check_correct\n"
            "from dfgnn_tpu_torch.ops import sddmm_dot, sddmm_add, edge_softmax, spmm, "
            "graph_attention_reference\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'dfgnn_tpu', "
            "'tabulate', 'matplotlib', 'sklearn')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_github_table():
    assert github_table(["a", "bb"], [[1, "x"], ["long", 2.5]]).splitlines() == [
        "| a    | bb  |", "|------|-----|", "| 1    | x   |", "| long | 2.5 |"]


def test_train_sampled_twin(capsys):
    res = train_sampled.main(["--dataset", "cora", "--dim", "16", "--batch-size", "128",
                              "--epochs", "1", "--compare-full", "--device", "cpu"])
    out = capsys.readouterr().out
    for tag in ("[sampled] test acc=", "[full]    test acc=", "[compare] sampled-full acc gap"):
        assert tag in out
    assert res["steps"] == 12 and all(np.isfinite(res["losses"] + res["full_losses"]))
    assert res["device_ms_per_step"] is None and res["peak_mib"] is None
    assert res["sample_s_per_step"] > 0


@pytest.mark.parametrize("dataset", ["PATTERN", "ogbg-molhiv"])  # NodeNet, GTModel
def test_batch_timing_twin(capsys, dataset):
    res = train_batch_graph_timing.main(["--dataset", dataset, "--batch-size", "4", "--dim",
                                         "16", "--n-layers", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "strict fused-vs-unfused check: OK" in out and res["ok"]
    assert "| preprocess ms | forward ms   | backward ms  | fw+bw ms" in out
    assert res["forward_ms"] is None and res["launches"] == [0] * 6  # no kernel on the CPU


def test_full_timing_twin(capsys):
    res = train_full_graph_timing.main(["--dataset", "cora", "--dim", "16", "--n-layers", "2",
                                        "--epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "fused-vs-unfused loss check: OK" in out and res["ok"]
    assert "fused(bucket)" in out and "unfused(oracle)" in out
    assert res["fused(bucket)"]["forward_ms"] is None


def test_graphworld_twin(capsys):
    res = test_gt_graphworld.main(["--dim", "8", "--device", "cpu"])
    assert sorted(res) == [2, 4, 8, 16, 32, 64]
    assert all(r["ok"] and r["ms"] is None for r in res.values())
    assert capsys.readouterr().out.count("correct=OK") == 6


def test_profile_flag_on_the_older_twins(tmp_path, monkeypatch, capsys):
    """``--profile`` traces each format's first call into the temporary
    directory, beside the checks."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    test_batch_graph.main(["--dataset", "PATTERN", "--conv", "gt", "--dim", "8",
                           "--batch-size", "2", "--format", "flash", "--profile",
                           "--device", "cpu"])
    test_full_graph.main(["--dataset", "cora", "--dim", "8", "--format", "all_fg",
                          "--profile", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("correctness vs oracle: OK") == 2
    traces = sorted(os.listdir(tmp_path / "dfgnn_trace"))
    assert traces == ["batch_PATTERN_flash.trace.json", "full_cora_bucket.trace.json",
                      "full_cora_reference.trace.json"]
