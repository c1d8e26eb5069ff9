// Row gathers for Hopper (sm_90a), hand-written CUDA: kernels #7 and #8.
//
// They replace the two Pallas kernels of the JAX package's gather probe,
// scripts/microbench_gather.py, which measure the mechanisms of the random
// source-row gather at the heart of the full-graph bucket path
// (dfgnn_tpu/ops/bucket.py::_take_src):
//
// #7 gather_rows: out[i] = tbl[idx[i]], replacing _dma_kernel (one async
//    row DMA per index, `lookahead` copies in flight, `chunk` rows per grid
//    step).  A block takes `chunk` rows.  Each row is one group of 16-byte
//    `cp.async` copies into a shared-memory ring of LA + 1 row slots, with at
//    most LA groups in flight (`cp.async.wait_group LA`); the slot is then
//    stored out with coalesced 16-byte stores.  A thread stores only the
//    pieces it copied itself, so it waits on its own copies and no barrier
//    is needed; the slot a copy overwrites is the one the same thread stored
//    out one iteration before.  Rows are opaque bytes (any dtype whose row
//    width is a multiple of 16 bytes); indices must lie in [0, N), the DMA
//    kernel's contract: they are not clamped.  The last block takes the
//    remainder of M, which the Pallas grid never had to.
//    What bounds it (H100 SXM data-sheet peaks): bytes only.  At the probe's
//    shape (2**20 rows of 512 B from a 2**18-row table) it must read M*512 B
//    of rows and M*4 B of ids and write M*512 B: 1.078 GB, 0.32 ms at 3.35
//    TB/s.  A random 512 B row is four 128-byte lines, so the gather can run
//    at the memory's rate if enough copies are in flight; the ring keeps LA
//    rows in flight per block.
//
// #8 take_rows: out[i] = slab[clip(idx[i] < 0 ? idx[i] + S : idx[i], 0, S-1)],
//    replacing _take_kernel (scripts/microbench_gather.py:107,
//    take_along_axis(mode="clip") from a slab held in VMEM; a negative id
//    counts from the end, as numpy's take_along_axis).
//    What bounds it: bytes only.  It must read the ids (M*4 B) and the slab
//    once and write M rows: at 2**20 ids of 512 B rows and S = 4096, 2**20 x
//    516 B + 2 MB = 0.543 GB, 0.1621 ms at 3.35 TB/s.  The writes are 97% of
//    that, so the kernel is as fast as its stores are whole.
//    The kernel it replaces staged the slab one 16-byte column sliver at a
//    time (a 2 MB slab does not fit a block's 227 KB), re-read it from L2 in
//    every block, and wrote each output row in 32 slivers of 16 bytes, half
//    a 32-byte sector each, which left L2 before their neighbours came:
//    2.63 ms at S = 4096.  This design:
//    - Each output row is written once, whole: a warp reads a row as 16-byte
//      pieces, neighbouring lanes on neighbouring pieces, and stores it the
//      same way (512 contiguous bytes per warp instruction at 128 fp32),
//      with the streaming hint (st.global.cs): the output is not read again
//      here.  Eight rows are in flight per warp, so the loads overlap.
//      Narrower rows put several rows in one warp instruction (the lanes
//      split by a shift and a mask that take_plan sets on the host); wider
//      rows are walked 32 pieces at a time.  No per-element division.
//    - The rows are read straight from the slab, with no staging: a slab the
//      probe's sizes reach (2 MB at S = 4096) stays in the 50 MB L2, and the
//      ids, read 32 at a time by a warp and passed round by shuffles, are the
//      only other reads.  Any S an int32 id reaches runs.  Holding the slab
//      on chip instead, split over a thread-block cluster's shared memory
//      and read through distributed shared memory, was slower at every slab
//      size (dfgnn_tpu_torch/scripts/probe_take_slab.py times the two side
//      by side; PERF.md section 6).
//    - Persistent blocks, four an SM, walk 32-id batches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block can use

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row i of the block (global row `row`) into its ring slot; thread t copies
// pieces t, t + T, ...
template <int LA>
__device__ __forceinline__ void issue_row(const uint4* __restrict__ tbl,
                                          const int* __restrict__ idx, uint4* ring, long row,
                                          int i, int pieces) {
  const uint4* src = tbl + long(idx[row]) * pieces;
  uint4* dst = ring + (i % (LA + 1)) * pieces;
  for (int p = threadIdx.x; p < pieces; p += blockDim.x) cp_async16(dst + p, src + p);
}

template <int LA>
__global__ void __launch_bounds__(kMaxThreads)
gather_rows_kernel(const uint4* __restrict__ tbl, const int* __restrict__ idx,
                   uint4* __restrict__ out, long M, int pieces, int chunk) {
  extern __shared__ uint4 ring[];  // [(LA + 1) * pieces]
  const long start = long(blockIdx.x) * chunk;
  const int n = int(M - start < chunk ? M - start : chunk);
  // LA groups in flight before the first wait; empty groups past the end keep
  // the count of committed groups at LA + i + 1 in iteration i
  for (int i = 0; i < LA; ++i) {
    if (i < n) issue_row<LA>(tbl, idx, ring, start + i, i, pieces);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    if (i + LA < n) issue_row<LA>(tbl, idx, ring, start + i + LA, i + LA, pieces);
    cp_async_commit();
    cp_async_wait<LA>();  // this thread's copies of row i have landed
    const uint4* slot = ring + (i % (LA + 1)) * pieces;
    uint4* dst = out + (start + i) * pieces;
    for (int p = threadIdx.x; p < pieces; p += blockDim.x) dst[p] = slot[p];
  }
}

int threads_for(int pieces) {
  const int t = (pieces + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

template <int LA>
cudaError_t launch_gather(const uint4* tbl, const int* idx, uint4* out, long M, int pieces,
                          int chunk, cudaStream_t stream) {
  const long smem = long(LA + 1) * pieces * 16;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gather_rows_kernel<LA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const long n_blocks = (M + chunk - 1) / chunk;
  if (n_blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  gather_rows_kernel<LA><<<unsigned(n_blocks), threads_for(pieces), smem, stream>>>(
      tbl, idx, out, M, pieces, chunk);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// #8
// ---------------------------------------------------------------------------

constexpr int kTakeThreads = 512;  // 16 warps
constexpr int kTakeWarps = kTakeThreads / 32;
constexpr int kTakeBlocksPerSm = 4;
constexpr int kTakeUnroll = 8;  // rows in flight per warp

__device__ __forceinline__ void store_streaming(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// A warp takes 32 ids at a time; a warp instruction moves 32 >> sh rows of
// (1 << sh) lanes each (sh = 5 for rows of 32 pieces or more, which the warp
// then walks 32 pieces at a time).
__global__ void __launch_bounds__(kTakeThreads)
take_rows_kernel(const uint4* __restrict__ slab, const int* __restrict__ idx,
                 uint4* __restrict__ out, long M, int S, int pieces, int sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long first = (long(blockIdx.x) * kTakeWarps + warp) * 32;
  const long step = long(gridDim.x) * kTakeWarps * 32;
  const int rows_per_op = 32 >> sh;
  const int sub = lane >> sh, pl = lane & ((1 << sh) - 1);
  for (long base = first; base < M; base += step) {
    int id = 0;
    if (base + lane < M) {
      id = idx[base + lane];
      if (id < 0) id += S;
      id = id < 0 ? 0 : (id >= S ? S - 1 : id);
    }
    const int n = M - base < 32 ? int(M - base) : 32;
    for (int pp = 0; pp < pieces; pp += 32) {
      const int p = pp + pl;
      for (int r0 = 0; r0 < n; r0 += rows_per_op * kTakeUnroll) {
        uint4 v[kTakeUnroll];
#pragma unroll
        for (int u = 0; u < kTakeUnroll; ++u) {
          const int r = r0 + u * rows_per_op + sub;
          const int s = __shfl_sync(0xffffffffu, id, r & 31);
          if (r < n && p < pieces) v[u] = __ldg(slab + long(s) * pieces + p);
        }
#pragma unroll
        for (int u = 0; u < kTakeUnroll; ++u) {
          const int r = r0 + u * rows_per_op + sub;
          if (r < n && p < pieces) store_streaming(out + (base + r) * pieces + p, v[u]);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// #7.  tbl: [N, row_bytes] bytes, 16-byte aligned; idx: [M] int32 in [0, N);
// out: [M, row_bytes].  row_bytes a multiple of 16; lookahead in {7, 15, 31}.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
int dfgnn_gather_rows(const void* tbl, const void* idx, void* out, long long M, int row_bytes,
                      int chunk, int lookahead, void* stream) {
  if (M < 1 || chunk < 1 || row_bytes < 16 || row_bytes % 16 != 0)
    return int(cudaErrorInvalidValue);
  const auto* t = static_cast<const uint4*>(tbl);
  const auto* i = static_cast<const int*>(idx);
  auto* o = static_cast<uint4*>(out);
  const int pieces = row_bytes / 16;
  auto s = static_cast<cudaStream_t>(stream);
  switch (lookahead) {
    case 7: return int(launch_gather<7>(t, i, o, M, pieces, chunk, s));
    case 15: return int(launch_gather<15>(t, i, o, M, pieces, chunk, s));
    case 31: return int(launch_gather<31>(t, i, o, M, pieces, chunk, s));
    default: return int(cudaErrorInvalidValue);
  }
}

// #8.  slab: [S, row_bytes] bytes, 16-byte aligned; idx: [M] int32, a
// negative id counted from the end, then clipped to [0, S-1]; out:
// [M, row_bytes].  A warp instruction takes rows of `lanes` lanes (a power
// of two up to 32; take_plan in dfgnn_tpu_torch/ops/gather.py chooses it).
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
int dfgnn_take_rows(const void* slab, const void* idx, void* out, long long M, int S,
                    int row_bytes, int lanes, void* stream) {
  int sh = 0;
  while (sh < 5 && (1 << sh) < lanes) ++sh;
  if (M < 1 || S < 1 || lanes < 1 || (1 << sh) != lanes || row_bytes < 16 ||
      row_bytes % 16 != 0)
    return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const long wanted = (M + kTakeWarps * 32 - 1) / (kTakeWarps * 32);  // blocks with work
  const long n_blocks = wanted < long(sms) * kTakeBlocksPerSm ? wanted
                                                               : long(sms) * kTakeBlocksPerSm;
  auto st = static_cast<cudaStream_t>(stream);
  take_rows_kernel<<<unsigned(n_blocks), kTakeThreads, 0, st>>>(
      static_cast<const uint4*>(slab), static_cast<const int*>(idx), static_cast<uint4*>(out),
      M, S, row_bytes / 16, sh);
  return int(cudaGetLastError());
}

}  // extern "C"
