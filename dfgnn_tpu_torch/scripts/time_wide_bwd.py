"""Kernels #1 to #4 past head dim 256 (by default #3, ``flash_mask_bwd``),
each timed in turns with its plain version beside SDPA's time and its bound
(``chip_smoke.py``'s ``time_attention_kernels``), with the package imported
from ``--root``:

    python3 dfgnn_tpu_torch/scripts/time_wide_bwd.py [--root DIR] [--tag NAME] [--names #1,#2]

``--root`` (default: the checkout holding this file) is the directory whose
``dfgnn_tpu_torch`` is imported and whose kernels are built, so two versions
of the kernel compare on one card by running this script on each checkout
in the order A, B, B, A on one machine.  The shapes (B x h x P x f):
1024 x 1 x 128 x 512 (a whole graph a block), 64 x 1 x 512 x 512 and 64 x 1
x 512 x 300 (past P = 128), and 1024 x 1 x 128 x 512 on the ogbg-molhiv
bs=1024 batch's adjacency (the wide GT step's padded blocks, key
``...-molhiv``), fp32 at ``"highest"``.  ``--names`` picks the
kernels, comma-separated, of ``#1`` (``flash_mask_fwd``), ``#3``, ``#2``
(``flash_add_fwd``) and ``#4``.  Prints the card's name and power limit,
each time as ``chip_smoke.py`` does, then one JSON line: ``{"tag", "root",
"times": {"BxhxPxf": {name: [ms, plain_ms, bound_ms, bound_by,
sdpa_ms]}}}``.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
SHAPES = ((1024, 1, 128, 512, 60), (64, 1, 512, 512, 61), (64, 1, 512, 300, 62))  # + seed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose package is timed")
    ap.add_argument("--tag", default="", help="a name printed with the result")
    ap.add_argument("--names", default="#3", help="kernels to time, comma-separated (#1 to #4)")
    args = ap.parse_args(argv)
    names = tuple(n.strip() for n in args.names.split(","))
    if not set(names) <= {"#1", "#2", "#3", "#4"}:
        ap.error(f"--names takes #1 to #4, got {args.names!r}")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("time_wide_bwd: needs a CUDA card", file=sys.stderr)
        return 1
    import numpy as np

    import dfgnn_tpu_torch
    from dfgnn_tpu_torch.data.collate import collate_dense
    from dfgnn_tpu_torch.data.datasets import load_batched
    from dfgnn_tpu_torch.ops import _cuda

    if Path(dfgnn_tpu_torch.__file__).resolve().parent != root / "dfgnn_tpu_torch":
        raise RuntimeError(f"imported {dfgnn_tpu_torch.__file__}, not the one under {root}")
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py: full fp32 plain products
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi)
    _cuda.build()
    molhiv = load_batched("ogbg-molhiv", n_graphs=1024, quiet=True)
    molhiv_adj = collate_dense(molhiv, np.arange(1024), np_pad=128, device="cuda")[0].adj
    times = {}
    for B, h, P, f, seed in SHAPES:
        got = smoke.time_attention_kernels(smi, (B, h, P, f), seed, names=names)
        times[f"{B}x{h}x{P}x{f}"] = {n: list(t) for n, t in got.items()}
    got = smoke.time_attention_kernels(smi, (1024, 1, 128, 512), 63, names=names, adj=molhiv_adj)
    times["1024x1x128x512-molhiv"] = {n: list(t) for n, t in got.items()}
    print(json.dumps({"tag": args.tag, "root": str(root), "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
