"""GT conv over a GraphWorld-style SBM average-degree sweep, with PyTorch.

The twin of the JAX package's ``scripts/test_gt_graphworld.py`` (the
reference's ``test_gt_graphworld.py``): one conv layer on the bucket path
over SBM graphs of n = 4096 nodes as the average degree runs over 2 to 64,
each point checked against the segment-op oracle (``check_correct``, rtol
1e-3) and timed with CUDA events (3 warmups, 10 timed runs;
``utils/benchmark.benchmark``).  TF32 is off.  It runs on the card unless
``--device cpu`` is given; on the CPU it checks but does not time.

    python -m dfgnn_tpu_torch.scripts.test_gt_graphworld --dim 64 [--store-result] \\
        [--device cpu]
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from dfgnn_tpu_torch.data.synthetic import sbm_graph
from dfgnn_tpu_torch.device import resolve_device
from dfgnn_tpu_torch.formats import build_buckets
from dfgnn_tpu_torch.graph import Graph
from dfgnn_tpu_torch.models import make_conv
from dfgnn_tpu_torch.utils.benchmark import benchmark, check_correct
from dfgnn_tpu_torch.utils.config import build_parser, parse_args

AVG_DEGREES = (2, 4, 8, 16, 32, 64)


def main(argv=None) -> dict:
    """Returns per average degree the ms and edges/s (None on the CPU), the
    edge count and whether the point matched the oracle."""
    p = build_parser(__doc__)
    p.add_argument("--device", type=str, default="cuda", help="torch device to run on")
    args = parse_args(p, argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    n = 4096
    layer = make_conv(args.conv, args.dim, args.dim, args.heads,
                      generator=torch.Generator().manual_seed(args.seed), device=dev).eval()

    results = {}
    with torch.inference_mode():
        for avg_deg in AVG_DEGREES:
            rows, cols, _ = sbm_graph(rng, n, avg_deg=avg_deg)
            g = Graph.from_coo(rows, cols, n, device=dev)
            bg = build_buckets(g)
            x = torch.from_numpy(rng.standard_normal((n, args.dim)).astype(np.float32)).to(dev)
            got = layer(bg, x)
            want = layer(g, x, impl="reference")
            ok = check_correct(got.float().cpu().numpy(), want.float().cpu().numpy())
            ms = benchmark(lambda: layer(bg, x), iters=10)[1] if dev.type == "cuda" else None
            eps = None if ms is None else g.n_edges / (ms / 1e3)
            results[avg_deg] = {"n_edges": int(g.n_edges), "ms": ms, "edges_per_s": eps,
                                "ok": ok}
            timing = ("time: not measured (no CUDA device)" if ms is None
                      else f"{ms:7.3f} ms  {eps:.3e} edges/s")
            print(f"avg_deg={avg_deg:3d}: {timing}  correct={'OK' if ok else 'FAIL'}")

    if args.store_result:
        os.makedirs("results", exist_ok=True)
        out = f"results/graphworld_torch_{args.conv}_{args.dim}.json"
        with open(out, "w") as f:
            json.dump({"args": vars(args), "device": str(dev), "results": results}, f, indent=2)
        print("stored", out)
    return results


if __name__ == "__main__":
    main()
