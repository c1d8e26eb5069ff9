"""Timing on the CUDA device, and the row-wise correctness check.

The reference's protocol: 3 warmup runs, then the mean of 10 timed runs,
timed with CUDA events on the current stream.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def benchmark(fn: Callable, *args, warmup: int = 3, iters: int = 10):
    """Mean device milliseconds per call of ``fn(*args)``.

    Returns ``(last_result, mean_ms)``.  Raises when there is no CUDA
    device: this times the card and has no CPU fallback.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("benchmark times a CUDA device, and none is available")
    out = None
    for _ in range(warmup):
        out = fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        out = fn(*args)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / iters


def check_correct(a, b, *, rtol: float = 1e-3, atol: float = 1e-5,
                  max_report: int = 5, tolerate_per_node: int = 1) -> bool:
    """Row-wise closeness check with per-node diagnostics, a copy of the JAX
    package's: a node counts as mismatched only if more than
    ``tolerate_per_node`` of its elements violate ``isclose(rtol, atol)``;
    offending nodes are printed with both rows.  True when all nodes pass."""
    flat_a = np.asarray(a).reshape(len(a), -1)
    flat_b = np.asarray(b).reshape(len(b), -1)
    bad_counts = (~np.isclose(flat_a, flat_b, rtol=rtol, atol=atol)).sum(axis=1)
    bad_nodes = np.nonzero(bad_counts > tolerate_per_node)[0]
    for i in bad_nodes[:max_report]:
        print(f"check_correct: node {i} mismatch ({bad_counts[i]} elems)")
        print("  a:", flat_a[i][:8])
        print("  b:", flat_b[i][:8])
    if bad_nodes.size:
        print(f"check_correct: {bad_nodes.size}/{len(flat_a)} nodes mismatched")
        return False
    return True


def github_table(headers, rows) -> str:
    """A GitHub-markdown table of ``rows`` under ``headers``: what the JAX
    scripts print through ``tabulate(..., tablefmt="github")``, in plain
    string formatting (the card's machine has no ``tabulate``)."""
    cells = [[str(c) for c in r] for r in [headers, *rows]]
    widths = [max(len(r[i]) for r in cells) for i in range(len(headers))]
    line = lambda r: "| " + " | ".join(c.ljust(w) for c, w in zip(r, widths)) + " |"
    rule = "|" + "|".join("-" * (w + 2) for w in widths) + "|"
    return "\n".join([line(cells[0]), rule, *map(line, cells[1:])])
