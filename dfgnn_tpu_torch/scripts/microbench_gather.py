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
  take_rows        kernel #8 from slabs of 512, 1024 and 4096 rows
  onehot           a bf16 one-hot matmul from the same slabs
  sweep            ``index_select`` and kernel #7 over tables of 16 MB to
                   1 GB at 512 B and 1 KB rows, in 64 Ki-row gathers: the
                   H100's L2 holds 50 MB, where a knee would show

Each row prints ms (CUDA events, 3 warmups, mean of 10), ns per gathered row
and GB/s of gathered rows, as the JAX probe's ``report()``.  Needs the card.

    python -m dfgnn_tpu_torch.scripts.microbench_gather [--rows 1048576] [--table 262144]
"""

from __future__ import annotations

import argparse

import torch

from dfgnn_tpu_torch.ops import gather
from dfgnn_tpu_torch.utils.benchmark import benchmark

DMA_PAIRS = ((256, 7), (512, 15), (1024, 31))
SLABS = (512, 1024, 4096)
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
    for S in SLABS:
        idx_s = idx % S
        slab = tbl[:S].contiguous()
        slab16 = slab.to(torch.bfloat16)
        report(rows, f"take_rows slab{S}",
               benchmark(lambda: gather.take_rows(slab, idx_s))[1], M, f * 4)
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
