"""The H100's gather probe: the mechanisms of the random source-row gather.

The twin of the JAX package's ``scripts/microbench_gather.py``, which
measured them on a TPU; these rows measure them on the card.  The row gather
is the hot loop of the full-graph bucket path (``ops/bucket.py``,
``_take_src``), and the readings set its layout constants
(``formats._SRC_BLOCK_ROWS``, ``formats._AUTO_BLOCK_ABOVE``).  Rows:

  stream           an elementwise pass over the table (the rate of streaming)
  fused / mat      ``torch.index_select`` into a contraction, and alone
                   (512 B rows, and packed 1 KB rows)
  gather_rows      kernel #7 over its (chunk, lookahead) pairs
  take_rows        kernel #8 from slabs of 512, 1024, 4096 and 20000 rows
  take cluster     kernel #8's function with the slab held in a thread-block
                   cluster's shared memory instead (the probe kernel
                   ``csrc/probes/take_cluster.cu``, built here with nvcc; not
                   part of the port), split by ``cluster_plan`` over at most
                   16 blocks and at most the portable 8, with the clusters
                   the card runs at once
  onehot           a bf16 one-hot matmul from the slabs up to 4096 rows
  sweep            ``index_select`` and kernel #7 over tables of 16 MB to
                   1 GB at 512 B and 1 KB rows, in 64 Ki-row gathers: the
                   H100's L2 holds 50 MB, where a knee would show

Each row prints ms (CUDA events, 3 warmups, mean of 10), ns per gathered row
and GB/s of gathered rows, as the JAX probe's ``report()``.  Needs the card.

    python -m dfgnn_tpu_torch.scripts.microbench_gather [--rows 1048576] [--table 262144]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import os
import subprocess

import torch

from dfgnn_tpu_torch.ops import _cuda, gather
from dfgnn_tpu_torch.utils.benchmark import benchmark

DMA_PAIRS = ((256, 7), (512, 15), (1024, 31))
SLABS = (512, 1024, 4096, 20000)
ONEHOT_MAX_SLAB = 4096
CLUSTER_LIMITS = (16, 8)  # the non-portable and the portable largest cluster
SWEEP_MB = (16, 32, 64, 128, 256, 512, 1024)
SWEEP_ROW_BYTES = (512, 1024)
ONEHOT_CHUNK = 1 << 16


def report(rows: list, name: str, ms: float, n_rows: int, row_bytes: int) -> None:
    ns = ms * 1e6 / n_rows
    gbs = n_rows * row_bytes / (ms * 1e-3) / 1e9
    print(f"{name:28s} {ms:9.4f} ms  {ns:7.3f} ns/row  {gbs:8.1f} GB/s", flush=True)
    rows.append({"name": name, "ms": ms, "ns_per_row": ns, "gb_per_s": gbs})


def onehot_gather(slab16: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``slab[idx]`` as bf16 one-hot matmuls over chunks of ``ONEHOT_CHUNK``
    ids (a [chunk, S] one-hot against the [S, f] slab)."""
    cols = torch.arange(slab16.shape[0], device=slab16.device, dtype=idx.dtype)
    return torch.cat([((ic[:, None] == cols).to(slab16.dtype)) @ slab16
                      for ic in idx.split(ONEHOT_CHUNK)])


def cluster_plan(S: int, row_bytes: int, max_cluster: int) -> tuple[int, int, int] | None:
    """How the cluster probe holds an ``S``-row slab: ``(cluster, tile,
    smem)``, a cluster of ``cluster`` blocks, ``ceil(S / cluster)`` rows a
    block, in column tiles of ``tile`` 16-byte pieces, ``smem`` bytes a
    block.  ``cluster`` is the smallest power of two up to ``max_cluster``
    whose blocks hold every whole row; ``tile`` the whole row then, else the
    widest power of two of pieces that fits; None when one piece does not."""
    pieces = row_bytes // 16
    share = lambda cluster, tile: -(-S // cluster) * tile * 16
    cluster = 1
    while cluster < max_cluster and share(cluster, pieces) > gather.MAX_SMEM_BYTES:
        cluster *= 2
    tile = pieces
    if share(cluster, tile) > gather.MAX_SMEM_BYTES:
        tile = 1 << (pieces.bit_length() - 1)
        while tile and share(cluster, tile) > gather.MAX_SMEM_BYTES:
            tile //= 2
        if not tile:
            return None
    return cluster, tile, share(cluster, tile)


@functools.cache
def _cluster_probe() -> ctypes.CDLL:
    """``csrc/probes/take_cluster.cu`` built with nvcc (once per source and
    flags) into the port's build directory, and loaded."""
    src = _cuda.CSRC / "probes" / "take_cluster.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(_cuda.NVCC_FLAGS).encode())
    lib = _cuda.BUILD_DIR / f"libtake_cluster-{digest.hexdigest()[:16]}.so"
    if not lib.exists():
        _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.tmp{os.getpid()}.so")
        run = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(tmp),
                              str(src)], capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src.name}:\n{run.stdout}{run.stderr}")
        os.replace(tmp, lib)
    cdll = ctypes.CDLL(str(lib))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cdll.probe_take_cluster.argtypes = [vp, vp, vp, ll, i, i, i, i, vp]
    cdll.probe_take_cluster.restype = i
    cdll.probe_active_clusters.argtypes = [i, i]
    cdll.probe_active_clusters.restype = i
    return cdll


def main(argv=None) -> list:
    """Prints and returns the probe's rows."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rows", type=int, default=1 << 20, help="rows gathered")
    ap.add_argument("--table", type=int, default=1 << 18, help="table rows")
    ap.add_argument("--f", type=int, default=128, help="fp32 values a row")
    ap.add_argument("--sweep-rows", type=int, default=1 << 16,
                    help="rows gathered at each table size of the sweep")
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the gather probe times the card, and no CUDA device is available")
    dev = torch.device("cuda")
    M, N, f = args.rows, args.table, args.f
    gen = torch.Generator(device=dev).manual_seed(0)
    tbl = torch.randn(N, f, device=dev, generator=gen)
    tbl2 = torch.randn(N, 2 * f, device=dev, generator=gen)
    idx = torch.randint(0, N, (M,), device=dev, generator=gen, dtype=torch.int32)
    q = torch.randn(f, device=dev, generator=gen)
    print(f"{torch.cuda.get_device_name(dev)}: table {N}x{f} fp32 = {N * f * 4 / 1e6:.0f} MB; "
          f"gathering {M} rows", flush=True)
    rows: list = []
    report(rows, "stream (x2 table)", benchmark(lambda: tbl * 2.0)[1] / 2, N, f * 4)
    report(rows, "fused 512B (gather, matvec)",
           benchmark(lambda: torch.index_select(tbl, 0, idx) @ q)[1], M, f * 4)
    report(rows, "mat 512B", benchmark(lambda: torch.index_select(tbl, 0, idx))[1], M, f * 4)
    report(rows, "mat 1KB packed", benchmark(lambda: torch.index_select(tbl2, 0, idx))[1], M,
           2 * f * 4)
    for chunk, la in DMA_PAIRS:
        report(rows, f"gather_rows c{chunk} la{la}",
               benchmark(lambda: gather.gather_rows(tbl, idx, chunk=chunk, lookahead=la))[1],
               M, f * 4)
    probe = _cluster_probe()
    for S in SLABS:
        idx_s = idx % S
        slab = tbl[:S].contiguous()
        report(rows, f"take_rows slab{S}",
               benchmark(lambda: gather.take_rows(slab, idx_s))[1], M, f * 4)
        want = gather.take_rows_plain(slab, idx_s)
        for limit in CLUSTER_LIMITS:
            cluster, tile, smem = cluster_plan(S, f * 4, limit)
            out = torch.empty_like(want)
            run = lambda: probe.probe_take_cluster(
                slab.data_ptr(), idx_s.data_ptr(), out.data_ptr(), M, S, f * 4, cluster, tile,
                torch.cuda.current_stream().cuda_stream)
            err = run()
            if err != 0 or not torch.equal(out, want):
                raise RuntimeError(f"the cluster probe at slab {S}, cluster {cluster}, tile "
                                   f"{tile}: error {err} or a result unlike take_rows_plain")
            n = probe.probe_active_clusters(cluster, smem) if cluster > 1 else 0
            report(rows, f"take cluster{cluster} tile{tile} slab{S} ({n} at once)",
                   benchmark(run)[1], M, f * 4)
        if S <= ONEHOT_MAX_SLAB:
            slab16 = slab.to(torch.bfloat16)
            report(rows, f"onehot slab{S} bf16",
                   benchmark(lambda: onehot_gather(slab16, idx_s))[1], M, f * 4)
    if not args.no_sweep:
        # one buffer for every table of the sweep: a table is its leading rows
        buf = torch.randn(max(SWEEP_MB) * 2 ** 20 // 4, device=dev, generator=gen)
        for row_bytes in SWEEP_ROW_BYTES:
            for mb in SWEEP_MB:
                n_rows = mb * 2 ** 20 // row_bytes
                t = buf[: n_rows * row_bytes // 4].view(n_rows, row_bytes // 4)
                ids = torch.randint(0, n_rows, (args.sweep_rows,), device=dev, generator=gen,
                                    dtype=torch.int32)
                report(rows, f"sweep {row_bytes}B {mb}MB index_select",
                       benchmark(lambda: torch.index_select(t, 0, ids))[1], args.sweep_rows,
                       row_bytes)
                report(rows, f"sweep {row_bytes}B {mb}MB gather_rows",
                       benchmark(lambda: gather.gather_rows(t, ids))[1], args.sweep_rows,
                       row_bytes)
    return rows


if __name__ == "__main__":
    main()
