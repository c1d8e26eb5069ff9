"""Batched-graph attention benchmark with correctness checks, with PyTorch.

The twin of the JAX package's ``scripts/test_batch_graph.py``: ``Model`` (an
inproj and one conv) over batches of a batched dataset, per format, timed
with CUDA events (3 warmups, 10 timed runs), and each format but
``reference`` checked on the first batch against ``impl="reference"`` on
the batch's block-diagonal Graph (the segment-op oracle) at rtol 1e-3.  As
in the JAX script, ``reference`` on a DenseBatch is the dense formulation.
TF32 is off for every product, in place of the JAX script's
``default_matmul_precision("highest")``.  It runs on the card unless
``--device cpu`` is given; on the CPU it checks but does not time.
``--profile`` traces each format's first forward (``utils/profiling.py``).

    python -m dfgnn_tpu_torch.scripts.test_batch_graph --dataset PATTERN \\
        --batch-size 1024 --dim 128 --conv gat --format all [--device cpu]
"""

from __future__ import annotations

import json
import os

import torch

from dfgnn_tpu_torch.data.collate import batch_iterator
from dfgnn_tpu_torch.data.datasets import load_batched
from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.models import Model
from dfgnn_tpu_torch.ops import flash_mask
from dfgnn_tpu_torch.utils.benchmark import benchmark, check_correct
from dfgnn_tpu_torch.utils.config import build_parser, parse_args, resolve_format
from dfgnn_tpu_torch.utils.profiling import profile_region


def main(argv=None) -> dict:
    """Returns per format the mean ms and edges/s over the timed batches (None
    on the CPU), whether the checked batch matched the oracle (None for
    ``reference``), and the launches of each kernel (#1, #3, #2, #4, #5, #6) during
    the checked forward."""
    parser = build_parser(__doc__)
    parser.add_argument("--device", type=str, default="cuda", help="torch device to run on")
    args = parse_args(parser, argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    formats = (["reference", "dense", "flash"] if args.format == "all"
               else [resolve_format(args.format)])

    ds = load_batched(args.dataset, args.data_dir, n_graphs=args.batch_size * 2)
    print(f"dataset {args.dataset}: {len(ds)} graphs, task={ds.task}")

    results = {}
    for fmt in formats:
        if fmt in ("bucket", "dist"):
            print(f"skip {fmt}: full-graph strategy")
            continue
        # weights drawn once per format from one seed, outside the timed loop
        model = Model(args.dataset, args.conv, args.dim, args.heads, in_size=ds.in_dim,
                      generator=torch.Generator().manual_seed(0), device=dev).eval()
        times, res = [], {"ok": None, "launches": None}
        with torch.inference_mode():
            for ep, (batch, x, _, _) in enumerate(
                    batch_iterator(ds, args.batch_size, device=dev)):
                if ep == 0 and args.profile:
                    with profile_region(f"batch_{args.dataset}_{fmt}"):
                        model(batch, x, impl=fmt)
                if dev.type == "cuda":
                    ms = benchmark(lambda: model(batch, x, impl=fmt))[1]
                    times.append((ms, batch.n_edges / (ms / 1e3)))
                if ep < 1 and fmt != "reference":
                    want = model(batch.to_graph(), x, impl="reference")
                    before = flash_mask.launch_counts()
                    got = model(batch, x, impl=fmt)
                    res["launches"] = [a - b for a, b in zip(flash_mask.launch_counts(), before)]
                    res["ok"] = check_correct(got.float().cpu().numpy(),
                                              want.float().cpu().numpy())
                    print(f"  [{fmt}] correctness vs oracle: {'OK' if res['ok'] else 'FAIL'}")
                if ep >= 1:
                    break
        if times:
            res["ms"] = sum(t for t, _ in times) / len(times)
            res["edges_per_s"] = sum(e for _, e in times) / len(times)
            print(f"  [{fmt}] {res['ms']:.3f} ms/batch   {res['edges_per_s']:.3e} edges/s")
        else:
            res["ms"] = res["edges_per_s"] = None
            print(f"  [{fmt}] time: not measured (no CUDA device)")
        results[fmt] = res
    if args.store_result:
        os.makedirs("results", exist_ok=True)
        out = f"results/batch_torch_{args.dataset}_{args.conv}_{args.dim}.json"
        with open(out, "w") as f:
            json.dump({"args": vars(args), "device": str(dev), "results": results}, f, indent=2)
        print("stored", out)
    return results


if __name__ == "__main__":
    main()
