#!/usr/bin/env python3
"""Bring-up check of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``dfgnn_tpu_torch/csrc/``, holds it
against its plain PyTorch version on the card, then serves three bs=1024
requests of the 8-layer, hidden-128 GTModel (PATTERN, random weights from a
seed) through ``method="auto"`` and checks that every layer went through the
kernel and that the logits agree with ``method="dense"``.  Prints progress,
then a ``{"kernels": [...]}`` JSON line, and last a ``{"ok": true, ...}`` line.
Exits non-zero, with no result line, when there is no CUDA device or any
check fails.  Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

FP32_TOL = dict(rtol=1e-4, atol=1e-5)  # the JAX package's flash-vs-dense bar
# bf16 outputs are O(1) values with 8 significant bits (a step of 2**-8 near
# 1); ordering and ex rounding differences stay well inside 3e-2
BF16_TOL = dict(rtol=0.0, atol=3e-2)
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)
KERNEL_SHAPES = [  # (B, h, P, f, with_val, dtype)
    (1024, 1, 128, 128, False, torch.float32),  # the serving path's shape
    (3, 2, 64, 16, True, torch.float32),
    (2, 4, 512, 32, False, torch.float32),
    (1024, 1, 128, 128, False, torch.bfloat16),
]
N_REQUESTS, BATCH, NP_PAD, HIDDEN, LAYERS = 3, 1024, 128, 128, 8


def max_err(got, want, tol):
    """Max |got - want|; raises when an element is outside atol + rtol*|want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > tol["atol"] + tol["rtol"] * want.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(f"{int(bad.sum())} elements outside {tol}; max err {float(err.max())}")
    return float(err.max())


def in_turns(bench, plain_fn, kernel_fn):
    """Times plain, kernel, kernel, plain; returns the two means (ms)."""
    p1 = bench(plain_fn)[1]
    k1 = bench(kernel_fn)[1]
    k2 = bench(kernel_fn)[1]
    p2 = bench(plain_fn)[1]
    print(f"  times in turns (ms): plain {p1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, plain {p2:.4f}")
    return (k1 + k2) / 2, (p1 + p2) / 2


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    from dfgnn_tpu_torch import DenseBatch, GTModel
    from dfgnn_tpu_torch.data.synthetic import attention_inputs, pattern_like_batch
    from dfgnn_tpu_torch.ops import flash_mask
    from dfgnn_tpu_torch.utils.benchmark import benchmark

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi name, power.limit: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN: the fp32 reference runs its products in full fp32")

    # 2. build
    t0 = time.perf_counter()
    lib, log = flash_mask.build()
    print(f"built {lib.name} with nvcc in {time.perf_counter() - t0:.2f} s")
    for line in sorted({l.strip() for l in log.splitlines() if "registers" in l or "spill" in l}):
        print(f"  ptxas, per instantiation: {line}")

    # 3. kernel against its plain version
    record = {"name": "flash_mask_fwd", "route": "cuda",
              "source": "dfgnn_tpu_torch/csrc/flash_mask_fwd.cu",
              "replaces": "dfgnn_tpu/ops/pallas/flash_mask.py:160"}
    for i, (B, h, P, f, with_val, dtype) in enumerate(KERNEL_SHAPES):
        q, k, v, adj, val = (torch.from_numpy(a).cuda() for a in
                             attention_inputs(np.random.default_rng(i), B, h, P, f))
        q, k, v, val = q.to(dtype), k.to(dtype), v.to(dtype), val if with_val else None
        out, lse = flash_mask.flash_mask_fwd(q, k, v, adj, val, want_lse=True)
        torch.cuda.synchronize()
        want_out, want_lse = flash_mask.flash_mask_fwd_plain(q, k, v, adj, val)
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        e_out = max_err(out, want_out, tol)
        e_lse = max_err(lse, want_lse, FP32_TOL)
        print(f"kernel vs plain B={B} h={h} P={P} f={f} val={with_val} {dtype}: "
              f"max abs err out {e_out:.3e} (tol {tol}), lse {e_lse:.3e} (tol {FP32_TOL})")
        if (B, h, P, f) == (1024, 1, 128, 128):
            ms, plain_ms = in_turns(
                benchmark,
                lambda: flash_mask.flash_mask_fwd_plain(q, k, v, adj),
                lambda: flash_mask.flash_mask_fwd(q, k, v, adj))
            print(f"  {dtype} at the serving shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  f"({smi})")
            if dtype == torch.float32:
                record.update(max_abs_err=e_out, ms=ms, plain_ms=plain_ms)

    # 4. the slice: GTModel serving bs=1024 requests
    model = GTModel("PATTERN", out_size=2, hidden_size=HIDDEN, num_layers=LAYERS, num_heads=1,
                    generator=torch.Generator().manual_seed(0), device="cuda").eval()
    requests = []
    for i in range(N_REQUESTS):
        rng = np.random.default_rng(i)
        graphs = [(r, c, n) for r, c, n, _ in pattern_like_batch(rng, BATCH)]
        batch = DenseBatch.from_graph_list(graphs, np_pad=NP_PAD).to("cuda")
        x = torch.from_numpy(rng.integers(0, 3, size=(BATCH * NP_PAD,))).to("cuda")
        requests.append((batch, x))
    print(f"made {N_REQUESTS} requests of {BATCH} PATTERN-like graphs, "
          f"{[b.n_edges for b, _ in requests]} edges")

    logits = []
    flash_mask.LAUNCHES = 0
    with torch.inference_mode():
        for batch, x in requests:
            before = flash_mask.LAUNCHES
            logits.append(model(batch, x))
            torch.cuda.synchronize()
            if flash_mask.LAUNCHES - before != LAYERS:
                raise AssertionError(f"{flash_mask.LAUNCHES - before} kernel launches in a "
                                     f"request, expected {LAYERS}")
    record["launches"] = flash_mask.LAUNCHES
    print(f"served {N_REQUESTS} requests through method='auto': "
          f"{record['launches']} kernel launches ({LAYERS} per request)")

    with torch.inference_mode():
        for i, ((batch, x), got) in enumerate(zip(requests, logits)):
            if got.shape != (BATCH, 2):
                raise AssertionError(f"logits shape {tuple(got.shape)}")
            e = max_err(got, model(batch, x, impl="dense"), MODEL_TOL)
            print(f"request {i}: auto vs dense logits max abs err {e:.3e} (tol {MODEL_TOL})")

        # a small input against the CPU model (the plain path) with the same weights
        rng = np.random.default_rng(100)
        small = DenseBatch.from_graph_list(
            [(r, c, n) for r, c, n, _ in pattern_like_batch(rng, 4)], np_pad=NP_PAD)
        xs = torch.from_numpy(rng.integers(0, 3, size=(4 * NP_PAD,)))
        cpu_model = GTModel("PATTERN", out_size=2, hidden_size=HIDDEN, num_layers=LAYERS,
                            generator=torch.Generator().manual_seed(1))
        cpu_model.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
        e = max_err(model(small.to("cuda"), xs.to("cuda")).cpu(), cpu_model(small, xs), MODEL_TOL)
        print(f"small batch on the card vs the CPU model: max abs err {e:.3e} (tol {MODEL_TOL})")

        batch, x = requests[0]
        auto_ms, dense_ms = in_turns(
            benchmark,
            lambda: model(batch, x, impl="dense"),
            lambda: model(batch, x))
    edges = batch.n_edges * LAYERS
    print(f"GTModel forward per bs={BATCH} request ({smi}): "
          f"auto {auto_ms:.4f} ms ({edges / auto_ms * 1e3:.4e} edges/s), "
          f"dense {dense_ms:.4f} ms ({edges / dense_ms * 1e3:.4e} edges/s); "
          f"edges/s = edges x layers / forward time")

    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
