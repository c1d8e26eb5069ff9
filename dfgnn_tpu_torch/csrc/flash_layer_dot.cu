// The whole graph-transformer layer in one kernel: q, k, v projections and
// masked dot-score attention, for Hopper (sm_90a), hand-written CUDA on the
// tensor cores: kernel #5.
//
// Replaces dfgnn_tpu/ops/pallas/flash_mask.py::_layer_kernel_dot (:508),
// driven there by _layer_fwd (:534).  For every graph b and head h of a
// DenseBatch, from node features x [B, P, din] and the head's weights
// W_q, W_k, W_v [H, din, f] (in x's type) and biases b_q, b_k, b_v [H, f]
// (fp32):
//   q = round_to<T>((x . W_q + b_q) * scale), k = round_to<T>(x . W_k + b_k),
//   v = round_to<T>(x . W_v + b_v)             products summed in fp32
//   then kernel #1's function: s = adj[b] ? q . k^T : -1e30,
//   m = max(rowmax(s), -0.5e30), ex = exp(s - m), l = rowsum(ex),
//   out = (round_to<T>(ex) . v) / l            an empty row gives exactly 0
// out is [B, P, H, f] in x's type (the node-major layout of kernel #1).  No
// edge values, no dropout and no lse, as in the Pallas kernel.  fp32 or bf16,
// any P >= 1, any f >= 1 (tiles zero past f up to the instantiated width
// 32, 64, 128 or 256; past 256 in chunks of that width), any din >= 1.  fp32
// products as 3xTF32, or one TF32 pass (precision "default"), the
// projections too.
//
// What bounds it on an H100 SXM (data-sheet peaks): the three projections,
// 3 * 2 * din * f operations per node and head, and the two attention
// products on the edges, 4 * f per edge and head.  At the table's shape
// (B=1024, H=1, P=128, din=f=128, about 6.0M edges) that is 12.9 + 3.1 GFLOP
// as 3xTF32 on the tensor cores (a third of 495 TFLOP/s: 0.097 ms) in fp32,
// or at 989 TFLOP/s in bf16, against 151 MB of x, the weights and adj read
// and out written (0.045 ms at 3.35 TB/s): operations bound it in fp32.
//
// Design.  The kernel this replaces did everything as fp32 FMAs on the
// CUDA cores, over every entry of the dense [P, P] block, and held K and V
// of all P nodes in one block's shared memory (so it stopped at P = 164 in
// fp32 at f = 128).  Here the attention is #1's own body (flash_fwd.cuh)
// with the LayerScore policy: where #1 copies q, k and v tiles in by
// cp.async, this kernel projects them on the tensor cores (project_tile,
// flash_mma.cuh: mma.sync, 3xTF32 in fp32 with each k-step's products summed
// apart, bf16 with fp32 sums; x and W stream through a cp.async ring, W from
// L2, where the B*H blocks share it).  Padding is skipped before any
// projection: the block scans adj first, projects q only for its 16-row
// tiles that hold an edge and k, v only for the 16-key groups some row
// attends to; a block without an edge writes zeros.  Two block shapes:
// - whole (P <= 128, f <= 128: every GT serving and training shape): 8 warps
//   over all 128 rows of one (graph, head), so k and v are projected once;
//   #1's whole body: the exact row max, V projected over K once the scores
//   are formed, ex over the Q rows (fp32 at f = 128: 212 KB, one block an
//   SM; bf16 144 KB);
// - stream (P > 128, or f > 128): #1's stream block, walking key tiles with
//   the online softmax; it projects each live key tile's K and V as it
//   reaches it, into one stage, so nothing of the graph stays resident; its
//   keys go in windows of 2048 (flash_fwd.cuh), so every P fits (fp32 at
//   f = 256: 164 KB).  K and V are
//   projected once per query block: 8 warps over 128 rows at f = 64 and
//   128, 4 warps over 64 rows at f = 32 and 256.
// Past f = 256 the head goes in chunks, so shared memory stays bounded:
// - whole (P <= 128, LayerScoreWide, FI = 128): the block forms the fp32
//   scores once, in registers, projecting each chunk of Q and K once into
//   the Q and K buffers and adding its products; after the exact softmax,
//   each chunk of out in turn projects V's chunk over K, sums ex . V_c in the
//   warp pairs and leaves through the V buffer.  q, k and v are each
//   projected once per (graph, head), as at f <= 128 (fp32 212 KB, bf16
//   144 KB);
// - past P = 128 (layer_dot_wide), two launches.  layer_project_kernel
//   projects q (pre-scaled), k and v of every live node once into a scratch
//   [3, B, Pp, H, Fp] of x's type (Pp: P rounded up to 16; Fp: f rounded up
//   to 128, the columns past f zeros), with the whole block's projection
//   (project_tile: 8 warps over 128 nodes, one of q, k, v a block; 70 KB).
//   "Live" follows adj: a node whose 16-node group has an edge as a row (q)
//   or as a key (k, v); nothing else is written or read.  Then the wide
//   attention block of flash_attend_wide.cuh (the one #1 and #2 run past f
//   = 256) reads the scratch: 16 warps take 64 query rows and up to 512
//   columns of out, every one in registers, the scores formed once per
//   (row block, key tile) for every 512 columns, so each node is projected
//   once per (graph, head) and attended without re-forming its scores (one
//   block an SM).  The projection is 3 * 2 * din * f operations a node against the
//   attention's 4 * f an edge: at 64 x 1 x 512 x 512, din 512, 51.5 GFLOP
//   against at most 34.4 on dense blocks.

#include "flash_fwd.cuh"

namespace {

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The scratch of wide #5 past P = 128: q, k, v [3, B, Pp, H, Fp] of x's
// type, Pp = round_up(P, kGroup), Fp = round_up(f, kProjCols)
constexpr int kProjRows = 128;  // nodes a projection block takes
constexpr int kProjCols = 128;  // columns a projection pass writes, zeros past f

// Launch 1 of wide #5 past P = 128: q (which 0, times the scale), k (1) or
// v (2, blockIdx.y) of kProjRows nodes of one (graph, head) into the
// scratch, for the 16-node groups with an edge as a row (q) or as a key (k,
// v); the other rows are neither projected nor written.
template <typename T, bool ONE>
__global__ void __launch_bounds__(256)
layer_project_kernel(LayerScore<T> sc, const uint8_t* __restrict__ adj, T* __restrict__ qkv, int B,
                     int P, int H, int f, int wvec) {
  constexpr int R = kProjRows, WARPS = 8, KC = 128 / int(sizeof(T));
  constexpr int NJ = 8;  // a warp's tile 32 x 64: passes of kProjCols columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* ws = xs + 2 * R * (KC + pad_rm<T>());
  uint32_t* live = reinterpret_cast<uint32_t*>(ws + 2 * KC * (kProjCols + 8));
  const int which = blockIdx.y;
  const int n_nb = (P + R - 1) / R;
  const int n0 = (blockIdx.x % n_nb) * R, hh = (blockIdx.x / n_nb) % H;
  const int b = blockIdx.x / (n_nb * H), tid = threadIdx.x;
  const int Pp = round_up(P, kGroup), Fp = round_up(f, kProjCols);
  const uint8_t* adj_b = adj + long(b) * P * P;
  if (tid == 0) *live = 0u;
  __syncthreads();
  auto none = [](int, int, uint32_t) {};
  if (which == 0)  // the groups with an edge as rows
    scan_adj(adj_b, P, n0, R, 0, (P + kGroup - 1) / kGroup, tid, WARPS * 32, live,
             [&](int r, int, int& w, uint32_t& bit) {
               w = 0;
               bit = 1u << ((r - n0) / kGroup);
             },
             none);
  else  // as keys
    scan_adj(adj_b, P, 0, P, n0, (min(R, P - n0) + kGroup - 1) / kGroup, tid, WARPS * 32, live,
             [&](int, int gk, int& w, uint32_t& bit) {
               w = 0;
               bit = 1u << gk;
             },
             none);
  __syncthreads();
  const uint32_t lv = *live;
  if (lv == 0u) return;
  const T* w = which == 0 ? sc.wq : which == 1 ? sc.wk : sc.wv;
  const float* bias = which == 0 ? sc.bq : which == 1 ? sc.bk : sc.bv;
  const long ld = long(H) * Fp;
  T* dst = qkv + long(which) * B * Pp * ld + (long(b) * Pp + n0) * ld + long(hh) * Fp;
  project_tile<T, R, NJ, WARPS, KC, ONE>(sc.x, long(b) * P * sc.din, sc.din, sc.xvec,
                                         w + long(hh) * sc.din * f, f, f, wvec,
                                         bias + long(hh) * f, which == 0 ? sc.scale : 1.f, n0, P,
                                         lv, dst, int(ld), xs, ws, tid);
}

// #5 past f = 256 and P = 128: the projection into `scratch` (the file's
// head gives its shape), then the attention.
template <typename T, bool ONE>
cudaError_t layer_dot_wide(const LayerScore<T>& sc, const uint8_t* adj, void* out, void* scratch,
                           long long scratch_elems, int B, int P, int H, int F,
                           cudaStream_t stream) {
  if (B < 1 || H < 1 || P < 1 || F < 1 || sc.din < 1 || scratch == nullptr ||
      scratch_elems < 3LL * B * round_up(P, kGroup) * H * round_up(F, kProjCols) ||
      long(B) * H * ((P + kAttRows - 1) / kAttRows) > 0x7fffffffL)
    return cudaErrorInvalidValue;
  T* qkv = static_cast<T*>(scratch);
  constexpr int KC = 128 / int(sizeof(T));
  constexpr size_t pbytes =
      sizeof(T) * (2 * kProjRows * (KC + pad_rm<T>()) + 2 * KC * (kProjCols + 8)) +
      sizeof(uint32_t);
  const long n_proj = long(B) * H * ((P + kProjRows - 1) / kProjRows);
  if (n_proj > 0x7fffffffL) return cudaErrorInvalidValue;
  auto proj = layer_project_kernel<T, ONE>;
  cudaError_t err =
      cudaFuncSetAttribute(proj, cudaFuncAttributeMaxDynamicSharedMemorySize, int(pbytes));
  if (err != cudaSuccess) return err;
  proj<<<dim3(unsigned(n_proj), 3), 256, pbytes, stream>>>(sc, adj, qkv, B, P, H, F,
                                                          fill_bytes<T>(F));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // then kernel #1's function on the scratch, in flash_attend_wide.cuh's block
  const int Pp = round_up(P, kGroup), Fp = round_up(F, kProjCols);
  const long plane = long(B) * Pp * H * Fp;
  const WideRows lay{long(Pp) * H * Fp, long(H) * Fp, Fp, Fp, 16};
  const Dropout no_drop{false, 0u, 0u, 1.f};
  return launch_attend_wide<DotScore<T>, T, ONE, true>(DotScore<T>{qkv, qkv + plane},
                                                       qkv + 2 * plane, lay, adj, nullptr,
                                                       static_cast<T*>(out), nullptr, B, P, H, F,
                                                       no_drop, stream);
}

}  // namespace

extern "C" {

// dtype (of x, the weights and out): 0 = fp32, 1 = bf16.  x: [B, P, din]
// contiguous; wq, wk, wv: [H, din, F] contiguous; bq, bk, bv: fp32 [H, F];
// adj: [B, P, P] uint8; out: [B, P, H, F]; scratch: scratch_elems elements
// of x's type, written and read as [3, B, Pp, H, Fp] (Pp = P rounded up to
// 16, Fp = F rounded up to 128) past F = 256 and P = 128, where this entry
// point alone takes the two-launch path (else unused, may be null); a
// shorter scratch there is refused.  P >= 1, F >= 1, din >= 1; one_pass !=
// 0: fp32 products as one TF32 pass.  Launches on `stream` (twice past F =
// 256 and P = 128), allocates nothing, and returns cudaGetLastError()
// (cudaErrorInvalidValue outside that set).
int dfgnn_flash_layer_dot_fwd(int dtype, const void* x, const void* wq, const void* bq,
                              const void* wk, const void* bk, const void* wv, const void* bv,
                              const void* adj, void* out, void* scratch,
                              long long scratch_elems, int B, int P, int H, int din, int F,
                              float scale, int one_pass, void* stream) {
  const auto* a = static_cast<const uint8_t*>(adj);
  const auto* fq = static_cast<const float*>(bq);
  const auto* fk = static_cast<const float*>(bk);
  const auto* fv = static_cast<const float*>(bv);
  auto s = static_cast<cudaStream_t>(stream);
  const Dropout no_drop{false, 0u, 0u, 1.f};
  if (dtype == 0) {
    const LayerScore<float> sc{static_cast<const float*>(x),  static_cast<const float*>(wq),
                               static_cast<const float*>(wk), static_cast<const float*>(wv),
                               fq, fk, fv, din, fill_bytes<float>(din), scale};
    if (F > 256 && P > 128) {
      auto wide = one_pass != 0 ? &layer_dot_wide<float, true> : &layer_dot_wide<float, false>;
      return int(wide(sc, a, out, scratch, scratch_elems, B, P, H, F, s));
    }
    if (F > 256)
      return int(layer_fwd<LayerScoreWide<float>, float>(LayerScoreWide<float>{sc}, a, out, B, P,
                                                         H, F, no_drop, one_pass != 0, s));
    return int(layer_fwd<LayerScore<float>, float>(sc, a, out, B, P, H, F, no_drop,
                                                   one_pass != 0, s));
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    const LayerScore<bf16> sc{static_cast<const bf16*>(x),  static_cast<const bf16*>(wq),
                              static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
                              fq, fk, fv, din, fill_bytes<bf16>(din), scale};
    if (F > 256 && P > 128)
      return int(layer_dot_wide<bf16, false>(sc, a, out, scratch, scratch_elems, B, P, H, F, s));
    if (F > 256)
      return int(layer_fwd<LayerScoreWide<bf16>, bf16>(LayerScoreWide<bf16>{sc}, a, out, B, P, H,
                                                       F, no_drop, false, s));
    return int(layer_fwd<LayerScore<bf16>, bf16>(sc, a, out, B, P, H, F, no_drop, false, s));
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
