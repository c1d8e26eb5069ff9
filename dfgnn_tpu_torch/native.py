"""The port's host library: CSR sort, bucket fill, dense collation, sampler.

The counterpart of :mod:`dfgnn_tpu.native`.  ``csrc/host/graph_builder.cpp``
holds four plain C routines over numpy buffers; :func:`build` compiles it
with ``g++`` at first use into ``dfgnn_tpu_torch/_build/`` and
:func:`library` loads it once per process with ctypes.  The routines run on
the host, beside the numpy that builds every layout, and give the same
arrays as their numpy plain versions (``graph.csr_from_coo_plain``,
``formats._fill_rows``, ``graph.fill_dense_adj_plain``,
``data.sampling.sample_neighbors_plain``), which only the tests and
``chip_smoke.py`` call.

There is no fallback: where the compiler is missing or fails, the first
call raises ``RuntimeError`` with its message.  The C routines write where
the ids they are given point, unchecked, so every wrapper checks its ids
first and raises ``ValueError`` for one out of range.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "host" / "graph_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX = "g++"
# No -march=native: a library named by its source and flags must not depend
# on the CPU that built it, and every output is an integer copy or a byte.
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_MASK64 = (1 << 64) - 1

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Tuple[Path, str]:
    """Compile ``source`` into a shared library in ``build_dir``, unless built.

    The library's name carries a hash of the source and the flags, so a
    stale build is never loaded.  It is linked under a name of this process
    and thread, then renamed into place, so a concurrent process never
    loads a half-written file.  Returns the library's path and the
    compiler's messages ('' when already built).
    """
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + source.read_bytes())
    lib = build_dir / f"libdfgnn_host-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = build_dir / f"{lib.stem}.tmp{os.getpid()}-{threading.get_ident()}.so"
    try:
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(source)],
                                  capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run {CXX} to build {source.name}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed to build {source.name}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib, proc.stdout + proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The built library, loaded once per process, its ``argtypes`` set."""
    lib = ctypes.CDLL(str(build(SOURCE, BUILD_DIR)[0]))
    lib.csr_from_coo.argtypes = [ctypes.c_int64] * 2 + [_I64P] * 5
    lib.bucket_fill.argtypes = [ctypes.c_int64, _I64P, _I64P, _I64P, _F32P, ctypes.c_int64,
                                _I32P, _U8P, _F32P]
    lib.fill_dense_adj.argtypes = [ctypes.c_int64, ctypes.c_int64, _I64P, _I64P, _I64P, _U8P]
    lib.sample_neighbors.argtypes = [ctypes.c_int64, _I64P, _I64P, _I64P, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_uint64, _I32P, _U8P]
    for fn in (lib.csr_from_coo, lib.bucket_fill, lib.fill_dense_adj, lib.sample_neighbors):
        fn.restype = None
    return lib


def _p(a: Optional[np.ndarray], t):
    return None if a is None else a.ctypes.data_as(t)


def _ids(a, what: str) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.int64)
    if a.ndim != 1:
        raise ValueError(f"{what} must be 1-D, got shape {a.shape}")
    return a


def _in_range(ids: np.ndarray, n: int, what: str) -> None:
    """Raises ValueError unless every id lies in [0, n)."""
    if ids.size and (ids.min() < 0 or ids.max() >= n):
        raise ValueError(f"{what} out of range: ids in [{ids.min()}, {ids.max()}], "
                         f"valid [0, {n})")


def _row_spans(rows: np.ndarray, indptr: np.ndarray, n_cols: int, what: str):
    """The CSR spans [lo, hi) of ``rows``, checked to lie in [0, n_cols)."""
    _in_range(rows, indptr.size - 1, what)
    lo, hi = indptr[rows], indptr[rows + 1]
    if lo.size and (lo.min() < 0 or (hi < lo).any() or hi.max() > n_cols):
        raise ValueError(f"indptr of the {what} lies outside [0, {n_cols}] or decreases")
    return lo, hi


def csr_from_coo(rows, cols, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A stable counting sort of COO edges by row: ``(indptr [n + 1],
    cols in row order, perm)``, all int64, where ``perm[slot]`` is the
    original id of the edge in ``slot``.  Rows must lie in [0, n)."""
    rows, cols = _ids(rows, "rows"), _ids(cols, "cols")
    if rows.size != cols.size:
        raise ValueError(f"rows ({rows.size}) and cols ({cols.size}) differ in length")
    n = int(n)
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    _in_range(rows, n, "row id")
    indptr = np.empty(n + 1, np.int64)
    cols_out = np.empty(rows.size, np.int64)
    perm = np.empty(rows.size, np.int64)
    library().csr_from_coo(n, rows.size, _p(rows, _I64P), _p(cols, _I64P), _p(indptr, _I64P),
                           _p(cols_out, _I64P), _p(perm, _I64P))
    return indptr, cols_out, perm


def bucket_fill(sel, indptr, cols, val, width: int, r_pad: int, sentinel: int):
    """One degree bucket's padded neighbour block: row i < len(sel) holds
    row ``sel[i]``'s neighbours left-aligned.  Returns ``(nbr [r_pad, width]
    int32 padded with sentinel, emask bool, bval float32 or None)``.  Every
    selected row must lie in the graph and have at most ``width`` edges."""
    sel, indptr, cols = _ids(sel, "sel"), _ids(indptr, "indptr"), _ids(cols, "cols")
    width, r_pad = int(width), int(r_pad)
    if sel.size > r_pad:
        raise ValueError(f"{sel.size} rows do not fit r_pad={r_pad}")
    if val is not None:
        val = np.ascontiguousarray(val, dtype=np.float32)
    n_edges = cols.size if val is None else min(cols.size, val.size)
    lo, hi = _row_spans(sel, indptr, n_edges, "selected rows")
    if lo.size and (hi - lo).max() > width:
        raise ValueError(f"a selected row has {(hi - lo).max()} edges, more than width={width}")
    nbr = np.full((r_pad, width), sentinel, dtype=np.int32)
    emask = np.zeros((r_pad, width), dtype=bool)
    bval = None if val is None else np.zeros((r_pad, width), dtype=np.float32)
    library().bucket_fill(sel.size, _p(sel, _I64P), _p(indptr, _I64P), _p(cols, _I64P),
                          _p(val, _F32P), width, _p(nbr, _I32P), _p(emask.view(np.uint8), _U8P),
                          _p(bval, _F32P))
    return nbr, emask, bval


def fill_dense_adj(edge_offsets, rows, cols, P: int) -> np.ndarray:
    """A batch's dense adjacency ``[B, P, P]`` uint8 (1 = edge r -> c):
    graph b's edges are ``rows[edge_offsets[b]:edge_offsets[b + 1]]`` and
    the same slice of ``cols``, each id in [0, P)."""
    offs = _ids(edge_offsets, "edge_offsets")
    rows, cols = _ids(rows, "rows"), _ids(cols, "cols")
    P = int(P)
    if offs.size < 1 or rows.size != cols.size:
        raise ValueError("edge_offsets needs B + 1 entries, rows and cols one length")
    if offs[0] < 0 or (np.diff(offs) < 0).any() or offs[-1] > rows.size:
        raise ValueError(f"edge_offsets must rise within [0, {rows.size}]")
    _in_range(rows[offs[0]:offs[-1]], P, "row id")
    _in_range(cols[offs[0]:offs[-1]], P, "col id")
    adj = np.zeros((offs.size - 1, P, P), dtype=np.uint8)
    library().fill_dense_adj(offs.size - 1, P, _p(offs, _I64P), _p(rows, _I64P),
                             _p(cols, _I64P), _p(adj, _U8P))
    return adj


def sample_neighbors(seeds, indptr, cols, fanout: int, sentinel: int, seed: int):
    """The JAX package's ``sample_neighbors_native``: per seed row, its
    whole row when its degree is at most ``fanout``, else a reservoir
    sample of ``fanout`` neighbours from one xorshift64 stream over the
    call, seeded from ``seed`` modulo 2**64.  Returns ``(nbr [n_seeds,
    fanout] int32 padded with sentinel, mask bool)``."""
    seeds, indptr, cols = _ids(seeds, "seeds"), _ids(indptr, "indptr"), _ids(cols, "cols")
    fanout = int(fanout)
    if fanout < 0:
        raise ValueError(f"fanout must be >= 0, got {fanout}")
    _row_spans(seeds, indptr, cols.size, "seeds")
    nbr = np.empty((seeds.size, fanout), dtype=np.int32)
    mask = np.zeros((seeds.size, fanout), dtype=bool)
    library().sample_neighbors(seeds.size, _p(seeds, _I64P), _p(indptr, _I64P), _p(cols, _I64P),
                               fanout, int(sentinel), int(seed) & _MASK64, _p(nbr, _I32P),
                               _p(mask.view(np.uint8), _U8P))
    return nbr, mask
