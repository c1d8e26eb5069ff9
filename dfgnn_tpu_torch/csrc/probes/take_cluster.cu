// A probe, not a kernel of the port: kernel #8's function (take_rows,
// csrc/gather_rows.cu) with its slab held on chip, in a thread-block
// cluster's shared memory, read through distributed shared memory.  Built
// and timed beside the shipped kernel, which reads whole rows of the slab
// straight from L2, by dfgnn_tpu_torch/scripts/probe_take_slab.py: the two
// ways a fused per-bucket kernel could hold its source rows.
//
// A cluster of cs blocks (a power of two up to 16, chosen by the probe's
// cluster_plan) holds the slab split by rows: block rank r keeps rows r,
// r + cs, r + 2 cs, ... of a column tile of `tile` 16-byte pieces in its
// shared memory, so a row's owner and slot are a mask and a shift.  Each
// block loads its share once (cp.async), the cluster syncs, and then any
// block reads any row from its owner (cluster.map_shared_rank).  Clusters
// are persistent and walk 32-id batches, so the slab is loaded once per
// cluster.  Output rows are written as the shipped kernel writes them: a
// warp stores whole rows, neighbouring lanes on neighbouring 16-byte pieces,
// with eight rows in flight and the streaming hint.  A slab too large for
// the cluster's shared memory is held in column tiles, walked in turn.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

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

constexpr int kTakeThreads = 512;  // 16 warps; a share of most of 227 KB is one block an SM
constexpr int kTakeWarps = kTakeThreads / 32;
constexpr int kTakeUnroll = 8;      // rows in flight per warp
constexpr int kMaxCluster = 16;     // the non-portable limit; 8 is portable

__device__ __forceinline__ void store_streaming(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// The shape of one launch: the slab's rows of `pieces` 16-byte pieces, held
// by a cluster of 1 << lcs blocks in column tiles of `tile` pieces; a warp
// instruction takes 32 >> sh rows of (1 << sh) lanes each (sh = 5 for rows
// of 32 pieces or more, which a warp then walks 32 pieces at a time).
struct TakeShape {
  long M;
  int S, pieces, tile, lcs, sh;
};

template <bool CLUSTER>
__global__ void __launch_bounds__(kTakeThreads)
take_rows_kernel(const uint4* __restrict__ slab, const int* __restrict__ idx,
                 uint4* __restrict__ out, TakeShape sh) {
  extern __shared__ uint4 share[];  // [ceil(S / cs)][tile]: rows rank, rank + cs, ...
  const int cs = 1 << sh.lcs;
  const unsigned rank = CLUSTER ? cg::this_cluster().block_rank() : 0u;
  const int n_local = (sh.S - int(rank) + cs - 1) >> sh.lcs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long first = (long(blockIdx.x) * kTakeWarps + warp) * 32;
  const long step = long(gridDim.x) * kTakeWarps * 32;
  const int rows_per_op = 32 >> sh.sh;  // rows of one warp instruction
  const int sub = lane >> sh.sh, pl = lane & ((1 << sh.sh) - 1);
  for (int c0 = 0; c0 < sh.pieces; c0 += sh.tile) {
    const int tw = min(sh.tile, sh.pieces - c0);  // this tile's width
    if (c0 > 0) {  // every block of the cluster is done reading the last tile
      if (CLUSTER) cg::this_cluster().sync(); else __syncthreads();
    }
    for (int r = warp; r < n_local; r += kTakeWarps) {
      const uint4* src = slab + long(r * cs + int(rank)) * sh.pieces + c0;
      uint4* dst = share + long(r) * tw;
      for (int p = lane; p < tw; p += 32) cp_async16(dst + p, src + p);
    }
    cp_async_commit();
    cp_async_wait<0>();
    if (CLUSTER) cg::this_cluster().sync(); else __syncthreads();

    for (long base = first; base < sh.M; base += step) {
      int id = 0;
      if (base + lane < sh.M) {
        id = idx[base + lane];
        if (id < 0) id += sh.S;
        id = id < 0 ? 0 : (id >= sh.S ? sh.S - 1 : id);
      }
      const int n = sh.M - base < 32 ? int(sh.M - base) : 32;
      for (int pp = 0; pp < tw; pp += 32) {
        const int p = pp + pl;
        for (int r0 = 0; r0 < n; r0 += rows_per_op * kTakeUnroll) {
          uint4 v[kTakeUnroll];
#pragma unroll
          for (int u = 0; u < kTakeUnroll; ++u) {
            const int r = r0 + u * rows_per_op + sub;
            const int s = __shfl_sync(0xffffffffu, id, r & 31);
            if (r < n && p < tw) {
              const uint4* row = share + long(s >> sh.lcs) * tw;
              if (CLUSTER)
                row = cg::this_cluster().map_shared_rank(const_cast<uint4*>(row),
                                                         unsigned(s & (cs - 1)));
              v[u] = row[p];
            }
          }
#pragma unroll
          for (int u = 0; u < kTakeUnroll; ++u) {
            const int r = r0 + u * rows_per_op + sub;
            if (r < n && p < tw) store_streaming(out + (base + r) * sh.pieces + c0 + p, v[u]);
          }
        }
      }
    }
  }
  // no block may leave while another can still read its share
  if (CLUSTER) cg::this_cluster().sync();
}

int log2_exact(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return (1 << l) == x ? l : -1;
}

// Sets the kernel's attributes: the largest share (the launch asks for less)
// and, for clusters past 8 blocks, the non-portable cluster size.
template <bool CLUSTER>
cudaError_t take_attributes() {
  auto kernel = take_rows_kernel<CLUSTER>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && CLUSTER)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// Clusters of `cs` blocks of `smem` bytes the card runs at once (0: none,
// or the card refuses such a cluster).
int active_clusters(int cs, int smem) {
  static int cached[5][2] = {};  // [log2 cs] -> {smem, clusters}
  const int l = log2_exact(cs);
  if (cached[l][0] == smem && cached[l][1] > 0) return cached[l][1];
  if (take_attributes<true>() != cudaSuccess) {
    cudaGetLastError();  // the query's error is not the caller's
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(unsigned(cs));
  cfg.blockDim = dim3(kTakeThreads);
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, take_rows_kernel<true>, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cached[l][0] = smem;
  cached[l][1] = n;
  return n;
}

}  // namespace

extern "C" {

// Clusters of `cluster` blocks of `smem` bytes the card runs at once (0:
// none, or the card refuses such a cluster).
int probe_active_clusters(int cluster, int smem) { return active_clusters(cluster, smem); }

// take_rows's function.  slab: [S, row_bytes] bytes, 16-byte aligned; idx:
// [M] int32, a negative id counted from the end, then clipped to [0, S-1];
// out: [M, row_bytes].  A cluster of `cluster` blocks (a power of two up to
// 16) holds the slab in column tiles of `tile` 16-byte pieces (1 <= tile <=
// row_bytes / 16; the last tile may be narrower); a block's shared memory,
// ceil(S / cluster) * tile * 16 bytes, must fit 227 KB.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments outside this contract, including a
// cluster the card does not run).
int probe_take_cluster(const void* slab, const void* idx, void* out, long long M, int S,
                       int row_bytes, int cluster, int tile, void* stream) {
  const int lcs = cluster >= 1 && cluster <= kMaxCluster ? log2_exact(cluster) : -1;
  if (M < 1 || S < 1 || lcs < 0 || tile < 1 || row_bytes < 16 || row_bytes % 16 != 0)
    return int(cudaErrorInvalidValue);
  const int pieces = row_bytes / 16;
  if (tile > pieces) return int(cudaErrorInvalidValue);
  const long smem = long((S + cluster - 1) / cluster) * tile * 16;
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  int sh = 0;
  while ((1 << sh) < tile && sh < 5) ++sh;
  const TakeShape shape{M, S, pieces, tile, lcs, sh};
  const auto* sl = static_cast<const uint4*>(slab);
  const auto* ids = static_cast<const int*>(idx);
  auto* o = static_cast<uint4*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const long rows_per_cluster = long(cluster) * kTakeWarps * 32;
  const long wanted = (M + rows_per_cluster - 1) / rows_per_cluster;  // clusters with work
  if (cluster == 1) {
    auto kernel = take_rows_kernel<false>;
    cudaError_t err = take_attributes<false>();
    if (err != cudaSuccess) return int(err);
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return int(err);
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTakeThreads,
                                                             size_t(smem))) != cudaSuccess)
      return int(err);
    const long n_blocks = wanted < long(sms) * per_sm ? wanted : long(sms) * per_sm;
    if (n_blocks < 1) return int(cudaErrorInvalidValue);
    kernel<<<unsigned(n_blocks), kTakeThreads, smem, st>>>(sl, ids, o, shape);
    return int(cudaGetLastError());
  }
  const int fit = active_clusters(cluster, int(smem));
  if (fit < 1) return int(cudaErrorInvalidValue);
  const long n_clusters = wanted < fit ? wanted : fit;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(unsigned(n_clusters * cluster));
  cfg.blockDim = dim3(kTakeThreads);
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, take_rows_kernel<true>, sl, ids, o, shape);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // extern "C"
