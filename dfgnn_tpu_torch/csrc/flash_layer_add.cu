// The whole GAT layer in one kernel: the W projection, the a_l / a_r score
// contractions and masked additive-score attention with the per-edge
// dropout, for Hopper (sm_90a), hand-written CUDA on the tensor cores:
// kernel #6.
//
// Replaces dfgnn_tpu/ops/pallas/flash_mask.py::_layer_kernel_add (:649),
// driven there by _layer_add_fwd (:672).  For every graph b and head h of a
// DenseBatch, from node features x [B, P, din], the head's weight W
// [H, din, F] (in x's type) and fp32 b, a_l, a_r [H, F]:
//   z    = x . W + b                          fp32, products summed in fp32
//   e_l  = sum_f z * a_l, e_r = sum_f z * a_r  from the unrounded fp32 z
//   s    = adj[b] ? leaky_relu(e_l[r] + e_r[c]) : -1e30
//   m    = max(rowmax(s), -0.5e30), ex = exp(s - m), l = rowsum(ex)
//   out  = (round_to<T>(ex * keep) . round_to<T>(z)) / l   empty rows give 0
// keep is the dropout factor of flash_common.cuh, keyed as in kernel #2 on
// (b * P + r, b * P + c, h); l sums the undropped ex.  out is [B, P, H, F] in
// x's type.  No edge values and no lse, as in the Pallas kernel.  fp32 or
// bf16, any P >= 1, any F >= 1 (tiles zero past F up to the instantiated
// width 32, 64, 128 or 256; past 256 in chunks of 128), any din >= 1.  fp32
// products as 3xTF32, or one TF32 pass (precision "default"), the
// projection too.
//
// What bounds it on an H100 SXM (data-sheet peaks): the projection, 2 * din
// * F operations per node and head, the two contractions, 2 * 2 * F, and
// ex . z on the edges, 2 * F per edge and head.  At the table's shape
// (B=1024, H=1, P=128, din=F=128, fp32, about 6.0M edges) that is 4.3 +
// 0.07 + 1.5 GFLOP, 0.036 ms as 3xTF32 on the tensor cores (a third of 495
// TFLOP/s), against 151 MB of x, the weights and adj read and out written,
// 0.045 ms at 3.35 TB/s: device memory bounds the function, in bf16 too.
//
// Design.  The kernel this replaces ran the projection and ex . z as fp32
// FMAs on the CUDA cores (67 TFLOP/s), formed scores and ex . z over every
// entry of the dense [P, P] block, and held z of all P nodes in one block's
// shared memory, so it stopped where that passed 227 KB (f = 256 at P =
// 128; f = 128 at P = 318 in fp32) and took only f in 8, 16, ..., 256.
// Here the attention is #2's own body (flash_fwd.cuh) with the LayerAddScore
// policy, as #5 is #1's with LayerScore: z is projected on the tensor cores
// by project_tile_scores (flash_mma.cuh: mma.sync, 3xTF32 in fp32 with each
// k-step's products summed apart, bf16 with fp32 sums; x and W through a
// cp.async ring, W from L2, where the B*H blocks share it) into the V tile
// #2 copies in, rounded to T, and from the same fp32 accumulators, before
// rounding, each node's e_l and e_r are summed into shared memory in a fixed
// order (the quad, then the warps that share a row: no atomics, so two
// launches agree bitwise).  The scores are then formed in the C-fragment
// layout as #2 forms them.  Padding is skipped before any projection: the
// block scans adj first and projects only the 16-row tiles and 16-key groups
// that hold an edge; a block without an edge writes zeros.  Two shapes:
// - whole (P <= 128, f <= 128: every GAT serving and training shape): 8
//   warps over all 128 rows of one (graph, head), so z is projected once,
//   for the nodes live as a row or as a key, with both scalars (fp32 at f =
//   128: 212 KB, one block an SM; bf16 144 KB); the exact row max;
// - stream (P > 128, or f > 128): #5's stream block.  It projects its own
//   query rows once, for their e_l only, then, as the walk reaches each live
//   key tile, that tile's z into the one V stage with the tile's e_r: the
//   online softmax needs e_r only of the current tile's keys, so nothing of
//   the graph stays resident; its keys go in windows of 2048 (flash_fwd.cuh),
//   so every P fits.
// Past F = 256 e_l and e_r need every column of z before any score, so the
// call launches twice.  layer_scalars_kernel forms them for every node live
// as a row or a key, from the unrounded fp32 z over all F columns in passes
// of 128, and writes only the two fp32 [B, P, H] scalars (z never leaves its
// registers; 73 KB of shared memory).  Then the attention (LayerAddWide)
// reads them as #2 does and takes the head in chunks of 128 columns as a
// grid axis (blockIdx.y): each chunk's block re-forms its scores from the
// scalars (no products) and projects only its own chunk of z as V, so z is
// projected twice in all, once for the scalars and once as V.  P <= 128:
// the whole block of 8 warps (fp32 212 KB, bf16 144 KB); past it the
// stream block of 8 warps over 128 rows, z's chunk of each live key tile
// projected once per query block (fp32 150 KB, bf16 99 KB).

#include "flash_fwd.cuh"

namespace {

constexpr int kScalarRows = 128;  // nodes a block of layer_scalars_kernel takes

// Wide #6's first launch: e_l = z . a_l and e_r = z . a_r [B, P, H] fp32 of
// every node live as a row or a key (0 elsewhere), from the unrounded fp32
// z = x . W + b over all f columns.  A block of 8 warps per (graph, head,
// kScalarRows nodes) scans adj for those nodes' rows and columns, then runs
// project_tile_scores over them with no destination: z stays in registers,
// pass by pass of 128 columns, and only the two scalars leave.
template <typename T, bool ONE>
__global__ void __launch_bounds__(256)
layer_scalars_kernel(LayerAddScore<T> sc, const uint8_t* __restrict__ adj, float* e_l,
                     float* e_r, int P, int H, int f, int wvec) {
  constexpr int R = kScalarRows, WARPS = 8, KC = 128 / int(sizeof(T));
  constexpr int NJ = 8;  // a warp's tile 32 x 64: passes of 128 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* ws = xs + 2 * R * (KC + pad_rm<T>());
  float* el = reinterpret_cast<float*>(ws + 2 * KC * (128 + 8));
  float* er = el + R;
  uint32_t* live = reinterpret_cast<uint32_t*>(er + R);
  const int n_nb = (P + R - 1) / R;
  const int n0 = (blockIdx.x % n_nb) * R, hh = (blockIdx.x / n_nb) % H;
  const int b = blockIdx.x / (n_nb * H), tid = threadIdx.x;
  const uint8_t* adj_b = adj + long(b) * P * P;
  if (tid == 0) *live = 0u;
  __syncthreads();
  auto none = [](int, int, uint32_t) {};
  // the 16-node groups with an edge as rows, then as keys
  scan_adj(adj_b, P, n0, R, 0, (P + kGroup - 1) / kGroup, tid, WARPS * 32, live,
           [&](int r, int, int& w, uint32_t& bit) {
             w = 0;
             bit = 1u << ((r - n0) / kGroup);
           },
           none);
  scan_adj(adj_b, P, 0, P, n0, min(R, P - n0 + kGroup - 1) / kGroup, tid, WARPS * 32, live,
           [&](int, int gk, int& w, uint32_t& bit) {
             w = 0;
             bit = 1u << gk;
           },
           none);
  __syncthreads();
  const uint32_t lv = *live;
  const long hf = long(hh) * f;
  if (lv != 0u)
    project_tile_scores<T, R, NJ, WARPS, KC, ONE>(
        sc.x, long(b) * P * sc.din, sc.din, sc.xvec, sc.w + hf * sc.din, f, f, wvec,
        sc.bias + hf, sc.a_l + hf, sc.a_r + hf, n0, P, lv, nullptr, 0, xs, ws, el, er, tid);
  for (int r = tid; r < R && n0 + r < P; r += WARPS * 32) {
    const bool on = (lv >> (r / kGroup)) & 1u;
    const long i = (long(b) * P + n0 + r) * H + hh;
    e_l[i] = on ? el[r] : 0.f;
    e_r[i] = on ? er[r] : 0.f;
  }
}

// #6 past f = 256: layer_scalars_kernel into `scalars` (fp32 [2, B, P, H]),
// then the attention with z's chunks projected as v (LayerAddWide).
template <typename T, bool ONE>
cudaError_t layer_add_wide(const LayerAddScore<T>& sc, const uint8_t* adj, void* out,
                           float* scalars, int B, int P, int H, int F, Dropout drop,
                           cudaStream_t stream) {
  if (B < 1 || H < 1 || P < 1 || F < 1 || sc.din < 1 || scalars == nullptr)
    return cudaErrorInvalidValue;
  constexpr int KC = 128 / int(sizeof(T));
  constexpr size_t bytes = sizeof(T) * (2 * kScalarRows * (KC + pad_rm<T>()) + 2 * KC * 136) +
                           sizeof(float) * 2 * kScalarRows + sizeof(uint32_t);
  auto kernel = layer_scalars_kernel<T, ONE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const long n_blocks = long(B) * H * ((P + kScalarRows - 1) / kScalarRows);
  if (n_blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  float* e_l = scalars;
  float* e_r = scalars + long(B) * P * H;
  kernel<<<unsigned(n_blocks), 256, bytes, stream>>>(sc, adj, e_l, e_r, P, H, F,
                                                      fill_bytes<T>(F));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const LayerAddWide<T> wide{e_l, e_r, sc.slope, sc.x, sc.w, sc.bias, sc.din, sc.xvec};
  return layer_fwd<LayerAddWide<T>, T>(wide, adj, out, B, P, H, F, drop, ONE, stream);
}

}  // namespace

extern "C" {

// dtype (of x, w and out): 0 = fp32, 1 = bf16.  x: [B, P, din] contiguous;
// w: [H, din, F] contiguous; bias, a_l, a_r: fp32 [H, F]; adj: [B, P, P]
// uint8; out: [B, P, H, F]; scalars: fp32 [2, B, P, H] scratch, written
// past F = 256, where this entry point alone takes the wide path (else
// unused, may be null).  P >= 1, F >= 1, din >= 1.
// drop, seed, threshold, scale and one_pass as dfgnn_flash_add_fwd's.
// Launches on `stream` (twice past F = 256), allocates nothing, and returns
// cudaGetLastError() (cudaErrorInvalidValue outside that set).
int dfgnn_flash_layer_add_fwd(int dtype, const void* x, const void* w, const void* bias,
                              const void* a_l, const void* a_r, const void* adj, void* out,
                              void* scalars, int B, int P, int H, int din, int F, float slope,
                              int drop, unsigned seed, unsigned threshold, float scale,
                              int one_pass, void* stream) {
  const auto* a = static_cast<const uint8_t*>(adj);
  const auto* fb = static_cast<const float*>(bias);
  const auto* fl = static_cast<const float*>(a_l);
  const auto* fr = static_cast<const float*>(a_r);
  auto s = static_cast<cudaStream_t>(stream);
  const Dropout dr{drop != 0, seed, threshold, scale};
  auto* sf = static_cast<float*>(scalars);
  if (dtype == 0) {
    const LayerAddScore<float> sc{static_cast<const float*>(x), static_cast<const float*>(w),
                                  fb, fl, fr, din, fill_bytes<float>(din), slope};
    if (F > 256)
      return int(one_pass != 0
                     ? layer_add_wide<float, true>(sc, a, out, sf, B, P, H, F, dr, s)
                     : layer_add_wide<float, false>(sc, a, out, sf, B, P, H, F, dr, s));
    return int(layer_fwd<LayerAddScore<float>, float>(sc, a, out, B, P, H, F, dr,
                                                      one_pass != 0, s));
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    const LayerAddScore<bf16> sc{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                                 fb, fl, fr, din, fill_bytes<bf16>(din), slope};
    if (F > 256) return int(layer_add_wide<bf16, false>(sc, a, out, sf, B, P, H, F, dr, s));
    return int(layer_fwd<LayerAddScore<bf16>, bf16>(sc, a, out, B, P, H, F, dr, false, s));
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
