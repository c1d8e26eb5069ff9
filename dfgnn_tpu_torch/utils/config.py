"""CLI and YAML configuration, a copy of :mod:`dfgnn_tpu.utils.config`.

``--config file.yaml`` merges keys the CLI did not set explicitly, like the
reference's ``parse_args`` overlay.  Format strings take both the port's
strategy names and the reference's CUDA format names:

    reference name        strategy
    --------------        ------------------------------------------
    hyper, hyper_v2,
    subgraph              flash   (dense masked flash-attention batch)
    csr, csr_gm,
    softmax, softmax_gm,
    tiling,
    hyper_recompute       bucket  (degree-bucketed padded CSR)
    pyg, dgl, cugraph,
    nofuse                reference (unfused oracle)
    dist                  dist    (edge-partitioned multi-device)

The copy exists because importing anything under ``dfgnn_tpu`` imports JAX.
PyYAML is imported only when ``--config`` is given.
"""

from __future__ import annotations

import argparse
import sys

FORMAT_ALIASES = {
    "hyper": "flash",
    "hyper_v2": "flash",
    "subgraph": "flash",
    "flash": "flash",
    "dense": "dense",
    "csr": "bucket",
    "csr_gm": "bucket",
    "softmax": "bucket",
    "softmax_gm": "bucket",
    "tiling": "bucket",
    "hyper_recompute": "bucket",
    "bucket": "bucket",
    "pyg": "reference",
    "dgl": "reference",
    "cugraph": "reference",
    "nofuse": "reference",
    "reference": "reference",
    "dist": "dist",
}


def resolve_format(fmt: str) -> str:
    try:
        return FORMAT_ALIASES[fmt]
    except KeyError:
        raise KeyError(
            f"unknown format {fmt!r}; known: {sorted(FORMAT_ALIASES)}"
        )


def build_parser(description: str = "dfgnn-tpu") -> argparse.ArgumentParser:
    """The reference's CLI surface."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", type=str, default=None, help="YAML overlay")
    p.add_argument("--conv", type=str, default="gt",
                   choices=["gt", "gat", "agnn", "dotgat"])
    p.add_argument("--format", type=str, default="hyper")
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--heads", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--data-dir", type=str, default="data")
    p.add_argument("--dataset", type=str, default="PATTERN")
    p.add_argument("--store-result", action="store_true")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--checkgrad", action="store_true")
    p.add_argument("--n-layers", type=int, default=8)
    p.add_argument("--n-devices", type=int, default=None,
                   help="device count for --format dist")
    p.add_argument("--seed", type=int, default=0)
    return p


def parse_args(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse, then merge the YAML overlay: it fills keys the CLI left at
    their defaults."""
    args = parser.parse_args(argv)
    if args.config:
        import yaml

        with open(args.config) as f:
            overlay = yaml.safe_load(f) or {}
        given = {
            a.split("=")[0].lstrip("-").replace("-", "_")
            for a in (argv if argv is not None else sys.argv[1:])
            if a.startswith("--")
        }
        for k, v in overlay.items():
            k = k.replace("-", "_")
            if k not in given and hasattr(args, k):
                setattr(args, k, v)
    return args
