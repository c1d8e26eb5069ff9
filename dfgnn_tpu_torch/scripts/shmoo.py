"""Shmoo sweeps on the card: feature dim and batch size, per implementation.

The twin of the JAX package's ``scripts/shmoo.py`` (the reference's fig4 and
fig5 grids: dims {16..256} at bs=256, batch sizes {64..2048} at dim 128) on
PATTERN-like batches padded to P=128.  Each point times one conv layer's
forward in every bf16 implementation (flash = projections and the flash
kernels; dense = the dense masked formulation; flash_fused = the whole-layer
kernel, gt and gat) and an fp32 flash row, with CUDA events
(``utils.benchmark``, 3 warmups and 30 timed calls).  It reports the winner
and whether the port's bf16 auto route (``models.conv._auto_bf16_dense_batch``;
GAT's is always flash_fused) is within 8% of it: the table that sets the
route's thresholds.  It needs a card and raises without one.

    python -m dfgnn_tpu_torch.scripts.shmoo [--conv gt|gat|agnn] [--heads H] [--store-result]

``--store-result`` writes ``results/h100_shmoo_{conv}.json``.  The JAX
script's ``--conv all`` is refused by its own parser; :func:`shmoo` takes a
list of convs.
"""

from __future__ import annotations

import json
import os
import subprocess

import numpy as np
import torch

from dfgnn_tpu_torch.data.synthetic import pattern_like_batch
from dfgnn_tpu_torch.graph import DenseBatch
from dfgnn_tpu_torch.models import make_conv
from dfgnn_tpu_torch.models.conv import _auto_bf16_dense_batch, _auto_bf16_gat
from dfgnn_tpu_torch.utils.benchmark import benchmark
from dfgnn_tpu_torch.utils.config import build_parser, parse_args

IMPLS = {
    "gt": ("flash", "dense", "flash_fused"),
    "gat": ("flash", "dense", "flash_fused"),
    "agnn": ("flash", "dense"),
}
DIMS, DIM_BATCH = (16, 32, 64, 128, 256), 256
BATCH_SIZES, BATCH_DIM = (64, 128, 256, 512, 1024, 2048), 128
NP_PAD = 128
ITERS = 30
DEFAULT_SLACK = 1.08  # the auto route counts as right within 8% of the winner


def run_point(conv: str, batch: DenseBatch, dim: int, heads: int, rng) -> dict:
    """Mean ms of one bf16 layer forward per impl and of the fp32 flash
    layer, the winner among the bf16 impls, the auto route and whether it is
    within 8% of the winner."""
    x = torch.from_numpy(rng.standard_normal((batch.n_graphs * NP_PAD, dim))
                         .astype(np.float32)).cuda()
    gen = torch.Generator().manual_seed(0)
    layer16 = make_conv(conv, dim, dim, heads, dtype=torch.bfloat16, generator=gen)
    layer32 = make_conv(conv, dim, dim, heads, generator=gen)
    layer32.load_state_dict(layer16.state_dict())
    row = {}
    with torch.inference_mode():
        for impl in IMPLS[conv]:
            row[impl] = benchmark(lambda: layer16(batch, x, impl=impl), iters=ITERS)[1]
        row["fp32_flash"] = benchmark(lambda: layer32(batch, x, impl="flash"), iters=ITERS)[1]
    bf16 = {impl: row[impl] for impl in IMPLS[conv]}
    row["winner"] = min(bf16, key=bf16.get)
    # the impl the port's bf16 method="auto" takes here
    row["auto"] = (_auto_bf16_gat(batch, dim) if conv == "gat"
                   else _auto_bf16_dense_batch(conv, batch, dim))
    row["default_ok"] = bool(bf16[row["auto"]] <= min(bf16.values()) * DEFAULT_SLACK)
    row["n_edges"] = batch.n_edges
    return row


def format_row(conv: str, label: str, row: dict) -> str:
    return (f"  {label}: " + "  ".join(f"{k}={row[k]:.4f}" for k in (*IMPLS[conv], "fp32_flash"))
            + f"  -> {row['winner']} (auto {row['auto']}"
            + ("" if row["default_ok"] else ", DEFAULT MISMATCH") + ")")


def shmoo(convs, dims=DIMS, batch_sizes=BATCH_SIZES, heads: int = 1, seed: int = 0,
          log=print) -> dict:
    """The grid for each conv: ``dims`` at bs=256 and ``batch_sizes`` at dim
    128.  Returns ``{conv: {"dim": {dim: row}, "batch_size": {bs: row}}}``."""
    if not torch.cuda.is_available():
        raise RuntimeError("the shmoo times the card, and no CUDA device is available")
    rng = np.random.default_rng(seed)
    batches = {}

    def get_batch(bs):
        if bs not in batches:
            graphs = [(r, c, n) for r, c, n, _ in pattern_like_batch(rng, bs)]
            batches[bs] = DenseBatch.from_graph_list(graphs, np_pad=NP_PAD)
        return batches[bs]

    results = {}
    for conv in convs:
        results[conv] = {"dim": {}, "batch_size": {}}
        log(f"== {conv}: feature-dim shmoo (bs={DIM_BATCH}) ==")
        for dim in dims:
            row = run_point(conv, get_batch(DIM_BATCH), dim, heads, rng)
            results[conv]["dim"][dim] = row
            log(format_row(conv, f"dim={dim:4d}", row))
        log(f"== {conv}: batch-size shmoo (dim={BATCH_DIM}) ==")
        for bs in batch_sizes:
            row = run_point(conv, get_batch(bs), BATCH_DIM, heads, rng)
            results[conv]["batch_size"][bs] = row
            log(format_row(conv, f"bs={bs:5d}", row))
    return results


def main(argv=None) -> dict:
    args = parse_args(build_parser(__doc__), argv)
    if args.conv not in IMPLS:
        raise SystemExit(f"the shmoo covers {sorted(IMPLS)}, not {args.conv}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = shmoo([args.conv], heads=args.heads, seed=args.seed,
                    log=lambda s: print(s, flush=True))
    if args.store_result:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
        os.makedirs("results", exist_ok=True)
        out = f"results/h100_shmoo_{args.conv}.json"
        with open(out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__, "heads": args.heads,
                       "results": results}, f, indent=2)
        print("stored", out)
    return results


if __name__ == "__main__":
    main()
