"""Profiling hooks, the counterpart of :mod:`dfgnn_tpu.utils.profiling`.

:func:`profile_region` captures a ``torch.profiler`` trace (CPU and, with
a card, CUDA activities) of the enclosed region and writes it as a Chrome
trace (open it in Perfetto or ``chrome://tracing``): the reference's
``--profile`` bracket.  :func:`annotate` is a named range that the
profiler and, once CUDA is initialised, NVTX tools attribute kernels to.
:func:`timed_region` prints the host time of a region that ends in a
device synchronisation.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def profile_region(name: str = "dfgnn", log_dir: Optional[str] = None, enabled: bool = True):
    """Trace the enclosed region into ``<log_dir>/<name>.trace.json``
    (``log_dir`` defaults to ``dfgnn_trace`` in the temporary directory).
    Yields the trace file's path, which exists once the region has exited;
    yields None when not ``enabled``."""
    if not enabled:
        yield None
        return
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "dfgnn_trace")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name}.trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with annotate(name):
            yield path
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    print(f"[dfgnn-tpu] trace written to {path}")


@contextlib.contextmanager
def annotate(name: str):
    """A named range: ``torch.profiler.record_function``, and an NVTX range
    when CUDA is initialised."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(record_function(name))
        if torch.cuda.is_initialized():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


@contextlib.contextmanager
def timed_region(name: str):
    """Prints the region's host milliseconds, synchronising the current CUDA
    device (when initialised) before reading the clock."""
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    print(f"[{name}] {(time.perf_counter() - t0) * 1e3:.2f} ms")
