"""Timing on the CUDA device.

The reference's protocol: 3 warmup runs, then the mean of 10 timed runs,
timed with CUDA events on the current stream.
"""

from __future__ import annotations

from typing import Callable

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
