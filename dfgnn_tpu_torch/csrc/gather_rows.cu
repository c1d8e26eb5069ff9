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
// #8 take_rows: out[i] = slab[clip(idx[i] < 0 ? idx[i] + S : idx[i], 0, S-1)],
//    replacing _take_kernel (take_along_axis(mode="clip") from a slab held in
//    VMEM; a negative id counts from the end, as numpy's take_along_axis).  Shared memory
//    is the H100's fast memory, and a block has at most 227 KB of it, which a
//    4096 x 128 fp32 slab (2 MB) does not fit.  So each block clips its
//    `chunk` ids into shared memory once, then stages the slab one column
//    tile at a time (S rows of `tile` 16-byte pieces) and gathers its rows'
//    tile from shared memory.
//
// What bounds them on an H100 SXM (data-sheet peaks): no arithmetic, only
// bytes.  #7 at the probe's shape (2**20 rows of 512 B from a 2**18-row
// table) must read M*512 B of rows and M*4 B of ids and write M*512 B: 1.078
// GB, 0.32 ms at 3.35 TB/s.  #8 reads the slab once and writes M rows: about
// half that.  A random 512 B row is four 128-byte lines, so the gather can
// run at the memory's rate if enough copies are in flight; #7's ring keeps
// LA rows in flight per warp-sized block.  #8's staged slab is re-read from
// L2 by every block and its writes are `tile` pieces wide (16 B at S=4096),
// which halves the use of each 32-byte sector written.

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

__global__ void __launch_bounds__(kMaxThreads)
take_rows_kernel(const uint4* __restrict__ slab, const int* __restrict__ idx,
                 uint4* __restrict__ out, long M, int S, int pieces, int tile, int chunk) {
  extern __shared__ uint4 buf[];  // [S * tile] slab tile, then [chunk] int ids
  int* ids = reinterpret_cast<int*>(buf + long(S) * tile);
  const long start = long(blockIdx.x) * chunk;
  const int n = int(M - start < chunk ? M - start : chunk);
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    int id = idx[start + r];
    if (id < 0) id += S;
    ids[r] = id < 0 ? 0 : (id >= S ? S - 1 : id);
  }
  const int staged = S * tile;
  for (int c0 = 0; c0 < pieces; c0 += tile) {
    __syncthreads();  // the ids are written and the last tile is read
    for (int e = threadIdx.x; e < staged; e += blockDim.x) {
      const int s = e / tile;
      buf[e] = slab[long(s) * pieces + c0 + (e - s * tile)];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n * tile; e += blockDim.x) {
      const int r = e / tile, p = e - r * tile;
      out[(start + r) * pieces + c0 + p] = buf[ids[r] * tile + p];
    }
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
// negative id counted from the end, then clipped to [0, S-1]; out: [M, row_bytes].  `tile` 16-byte pieces a column tile
// (dividing row_bytes / 16); the block's shared memory is S*tile*16 +
// chunk*4 bytes, at most 227 KB.  Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
int dfgnn_take_rows(const void* slab, const void* idx, void* out, long long M, int S,
                    int row_bytes, int chunk, int tile, void* stream) {
  if (M < 1 || S < 1 || chunk < 1 || tile < 1 || row_bytes < 16 || row_bytes % 16 != 0)
    return int(cudaErrorInvalidValue);
  const int pieces = row_bytes / 16;
  if (pieces % tile != 0) return int(cudaErrorInvalidValue);
  const long smem = long(S) * tile * 16 + long(chunk) * 4;
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(take_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long n_blocks = (M + chunk - 1) / chunk;
  if (n_blocks > 0x7fffffffL) return int(cudaErrorInvalidValue);
  take_rows_kernel<<<unsigned(n_blocks), kMaxThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(slab), static_cast<const int*>(idx), static_cast<uint4*>(out),
      M, S, pieces, tile, chunk);
  return int(cudaGetLastError());
}

}  // extern "C"
