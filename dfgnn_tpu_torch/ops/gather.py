"""Row gathers by hand-written CUDA kernels: the H100's gather probe.

The counterpart of the two Pallas kernels of the JAX package's gather probe
(``scripts/microbench_gather.py``), which measure the mechanisms of the
random source-row gather of the full-graph bucket path:

    _dma_kernel   (#7)  csrc/gather_rows.cu  gather_rows  out[i] = tbl[idx[i]]
    _take_kernel  (#8)  csrc/gather_rows.cu  take_rows    out[i] = slab[take_ids(idx)[i]]

For tensors on the CPU each wrapper runs its ``*_plain`` twin, the same
function in plain PyTorch; for CUDA tensors it launches its kernel or
raises.  It never falls back.  The probe twin
(``dfgnn_tpu_torch/scripts/microbench_gather.py``) times both beside
``torch.index_select``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from dfgnn_tpu_torch.ops import _cuda

# What the kernels take (csrc/gather_rows.cu): the lookaheads #7 is
# instantiated for (the probe's), the shared memory a block may use, and the
# most rows #8's int32 ids reach.
GATHER_LOOKAHEADS = (7, 15, 31)
MAX_SMEM_BYTES = 232448
TAKE_MAX_ROWS = 2 ** 31 - 1

# Launches per wrapper call, one each; callers may reset them to 0.
GATHER_LAUNCHES = 0  # kernel #7, by gather_rows
TAKE_LAUNCHES = 0  # kernel #8, by take_rows


def launch_counts() -> tuple[int, int]:
    """Launches of kernels #7 and #8 since their counts were last reset."""
    return GATHER_LAUNCHES, TAKE_LAUNCHES


def reset_launch_counts() -> None:
    global GATHER_LAUNCHES, TAKE_LAUNCHES
    GATHER_LAUNCHES = TAKE_LAUNCHES = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library with the argument types of kernels #7 and #8."""
    lib = _cuda.library()
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dfgnn_gather_rows.argtypes = [vp, vp, vp, ll, i, i, i, vp]
    lib.dfgnn_gather_rows.restype = i
    lib.dfgnn_take_rows.argtypes = [vp, vp, vp, ll, i, i, i, vp]
    lib.dfgnn_take_rows.restype = i
    return lib


def gather_rows_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel #7's function in plain PyTorch: ``tbl[idx]`` along dim 0."""
    return torch.index_select(tbl, 0, idx)


def take_ids(idx: torch.Tensor, S: int) -> torch.Tensor:
    """The rows ``jnp.take_along_axis(mode="clip")`` reads for ids ``idx`` of an
    ``S``-row slab: a negative id counts from the end (numpy's indexing),
    then the id is clipped to ``[0, S-1]``."""
    return torch.where(idx < 0, idx + S, idx).clamp(0, S - 1)


def take_rows_plain(slab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel #8's function in plain PyTorch: ``slab[take_ids(idx, S)]``."""
    return torch.index_select(slab, 0, take_ids(idx, slab.shape[0]))


def _row_bytes(t: torch.Tensor, name: str) -> int:
    """Bytes of a row of ``t`` ``[N, ...]``, which the kernels copy as opaque
    16-byte pieces: a multiple of 16, contiguous, 16-byte aligned."""
    if t.dim() < 1 or t.shape[0] < 1:
        raise ValueError(f"{name} must be [N, ...] with N >= 1, got {tuple(t.shape)}")
    row_bytes = t[0].numel() * t.element_size()
    if row_bytes < 16 or row_bytes % 16 != 0:
        raise ValueError(f"{name}'s rows must be a multiple of 16 bytes, got {row_bytes}")
    if not t.is_contiguous() or t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return row_bytes


def _check_idx(idx: torch.Tensor, device) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 1 or idx.numel() < 1:
        raise ValueError("idx must be a non-empty 1-D int32 tensor")
    if idx.device != device or not idx.is_contiguous():
        raise ValueError("idx must be contiguous on the table's device")


def gather_rows(tbl: torch.Tensor, idx: torch.Tensor, *, chunk: int = 512,
                lookahead: int = 15) -> torch.Tensor:
    """Row gather ``out[i] = tbl[idx[i]]``, kernel #7 on CUDA tensors.

    ``tbl``: ``[N, ...]`` of any dtype whose row is a multiple of 16 bytes,
    contiguous; ``idx``: int32 ``[M]``, each in ``[0, N)``: that is the
    kernel's contract, as it was the DMA kernel's, and the kernel neither
    checks nor clamps it (an id outside reads outside the table).  A block
    copies ``chunk`` rows with ``lookahead`` rows in flight (one of
    ``GATHER_LOOKAHEADS``); any M, the last block taking the remainder.
    CPU tensors run :func:`gather_rows_plain` (which raises on an id outside).
    """
    if tbl.device.type == "cpu":
        return gather_rows_plain(tbl, idx)
    if tbl.device.type != "cuda":
        raise ValueError(f"no gather_rows kernel for device {tbl.device}")
    row_bytes = _row_bytes(tbl, "tbl")
    _check_idx(idx, tbl.device)
    if lookahead not in GATHER_LOOKAHEADS or chunk < 1:
        raise ValueError(f"gather_rows takes lookahead in {GATHER_LOOKAHEADS} and chunk >= 1, "
                         f"got {lookahead}, {chunk}")
    if (lookahead + 1) * row_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"{lookahead + 1} rows of {row_bytes} bytes exceed a block's "
                         f"{MAX_SMEM_BYTES} bytes of shared memory")
    out = torch.empty((idx.numel(), *tbl.shape[1:]), dtype=tbl.dtype, device=tbl.device)
    lib = _library()
    with torch.cuda.device(tbl.device):
        err = lib.dfgnn_gather_rows(tbl.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                    idx.numel(), row_bytes, chunk, lookahead,
                                    torch.cuda.current_stream().cuda_stream)
    _cuda.raise_on(err, "gather_rows")
    global GATHER_LAUNCHES
    GATHER_LAUNCHES += 1
    return out


def take_plan(S: int, row_bytes: int) -> Optional[tuple[int, int]]:
    """Kernel #8's plan for an ``S``-row slab of ``row_bytes``-byte rows:
    ``(lanes, rows)``, a warp instruction moving ``rows`` output rows of
    ``lanes`` 16-byte pieces each (the fewest lanes, a power of two, that
    cover a row; a row wider than 32 pieces is walked 32 at a time), or None
    outside the supported set (ROADMAP.md section 2, kernels #7 and #8):
    rows that are not a multiple of 16 bytes, or more rows than an int32 id
    reaches.  The kernel reads whole rows of the slab where it lies, so its
    size is no limit."""
    pieces = row_bytes // 16
    if not 1 <= S <= TAKE_MAX_ROWS or pieces < 1 or row_bytes % 16:
        return None
    lanes = 1 << min(5, (pieces - 1).bit_length())
    return lanes, 32 // lanes


def take_rows(slab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Clipped row gather ``out[i] = slab[take_ids(idx, S)[i]]``, kernel #8 on
    CUDA tensors: ``jnp.take_along_axis(slab, idx, axis=0, mode="clip")``.

    ``slab``: ``[S, ...]`` of any dtype whose row is a multiple of 16 bytes,
    contiguous; ``idx``: int32 ``[M]``, any values (a negative id counts from
    the end, then ids are clipped to ``[0, S-1]``).  Warps read whole rows of
    the slab (L2-resident at the probe's sizes) and write whole output rows,
    as :func:`take_plan` splits a warp's lanes; a slab without a plan raises.
    CPU tensors run :func:`take_rows_plain`.
    """
    if slab.device.type == "cpu":
        return take_rows_plain(slab, idx)
    if slab.device.type != "cuda":
        raise ValueError(f"no take_rows kernel for device {slab.device}")
    row_bytes = _row_bytes(slab, "slab")
    _check_idx(idx, slab.device)
    S = slab.shape[0]
    plan = take_plan(S, row_bytes)
    if plan is None:
        raise ValueError(
            f"take_rows: a slab of {S} rows is past what an int32 id reaches (the supported "
            "set is in ROADMAP.md section 2, kernels #7 and #8)")
    out = torch.empty((idx.numel(), *slab.shape[1:]), dtype=slab.dtype, device=slab.device)
    lib = _library()
    with torch.cuda.device(slab.device):
        err = lib.dfgnn_take_rows(slab.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                  idx.numel(), S, row_bytes, plan[0],
                                  torch.cuda.current_stream().cuda_stream)
    _cuda.raise_on(err, "take_rows")
    global TAKE_LAUNCHES
    TAKE_LAUNCHES += 1
    return out
