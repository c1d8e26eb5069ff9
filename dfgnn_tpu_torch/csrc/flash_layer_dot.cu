// The whole graph-transformer layer in one kernel: q, k, v projections and
// masked dot-score attention, for Hopper (sm_90a), hand-written CUDA.
//
// Replaces dfgnn_tpu/ops/pallas/flash_mask.py::_layer_kernel_dot (:508),
// driven there by _layer_fwd (:534).  For every graph b and head h of a
// DenseBatch, from node features x [B, P, din] and the head's weights
// W_q, W_k, W_v [H, din, F] (in x's type) and biases b_q, b_k, b_v [H, F]
// (fp32):
//   q = round_to<T>((x . W_q + b_q) * scale), k = round_to<T>(x . W_k + b_k),
//   v = round_to<T>(x . W_v + b_v)             products summed in fp32
//   s   = adj[b] ? q . k^T : -1e30
//   m   = max(rowmax(s), -0.5e30), ex = exp(s - m), l = rowsum(ex)
//   out = (round_to<T>(ex) . v) / l            an empty row gives exactly 0
// out is [B, P, H, F] in x's type (the node-major layout of kernel #1).  No
// edge values and no dropout, as in the Pallas kernel.  fp32 or bf16 inputs;
// fp32 arithmetic, as full fp32 FMAs (TF32 would break rtol 1e-4 against the
// plain version).
//
// What bounds it on an H100 SXM (data-sheet peaks): the three projections,
// 3 * 2 * din * F operations per node and head, and the two attention
// products on the edges, 4 * F per edge and head.  At the GT serving shape
// (B=1024, H=1, P=128, din=F=128, fp32, about 6.0M edges) that is 12.9 +
// 3.1 GFLOP, 0.24 ms at 67 TFLOP/s, against 151 MB of x, adj read and out
// written, 0.045 ms at 3.35 TB/s: operations bound the function.  This
// kernel computes the attention products over every entry of the dense
// [P, P] blocks (8.6 GFLOP), so it does 21.5 GFLOP in all.
//
// Design.  The Pallas kernel projects q, k and v once per (graph block,
// head) and keeps them in VMEM.  A Hopper block has 227 KB of shared memory,
// so one block takes one (graph, head): it projects K and V of all P nodes
// into shared memory (x and W stream through fp32 tiles; 1024 blocks share W
// in L2), rounded to T, then walks the query rows in tiles of 32: it
// projects the tile's q rows, forms their [32, P] score rows in shared
// memory, and multiplies their exponentials by V.  A block's shared memory
// grows with P and F (smem_bytes below); shapes that do not fit raise in the
// wrapper (fp32 takes F <= 128 at P = 128; bf16 F <= 256).

#include "flash_layer.cuh"

namespace {

template <typename T, int F>
size_t smem_bytes(int P) {
  return sizeof(float) * layer_staging_floats(P, F) +
         sizeof(T) * size_t(2 * P + kLayerQ) * (F + row_pad<T>());
}

template <typename T, int F>
__global__ void __launch_bounds__(kLayerThreads)
flash_layer_dot_kernel(const T* __restrict__ x, const T* __restrict__ wq,
                       const float* __restrict__ bq, const T* __restrict__ wk,
                       const float* __restrict__ bk, const T* __restrict__ wv,
                       const float* __restrict__ bv, const uint8_t* __restrict__ adj,
                       T* __restrict__ out, int P, int H, int din, float scale) {
  using L = ColLayout<F>;
  constexpr int FS = F + row_pad<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [kLayerPR][kLayerK + 1]
  float* ws = xs + kLayerPR * (kLayerK + 1);        // [kLayerK][F]
  float* ss = ws + kLayerK * F;                     // [kLayerQ][P + 1]: scores, then ex
  float* inv = ss + kLayerQ * (P + 1);              // [kLayerQ]
  T* ks = reinterpret_cast<T*>(inv + kLayerQ);      // [P][FS]
  T* vs = ks + P * FS;                              // [P][FS]
  T* qs = vs + P * FS;                              // [kLayerQ][FS]

  const int hh = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int tid = threadIdx.x;
  const int tx = tid % L::TX, ty = tid / L::TX;
  const long x_base = long(b) * P * din;
  const long w_base = long(hh) * din * F;
  const uint8_t* adj_b = adj + long(b) * P * P;
  const long row_stride = long(H) * F;              // out is [B, P, H, F]
  const long out_base = (long(b) * P * H + hh) * F;

  // K and V of all P nodes.
  constexpr int RM = kLayerPR / L::TY;
  for (int which = 0; which < 2; ++which) {
    const T* w = which == 0 ? wk : wv;
    const float* bias = (which == 0 ? bk : bv) + hh * F;
    T* dst = which == 0 ? ks : vs;
    for (int r0 = 0; r0 < P; r0 += kLayerPR) {
      float acc[RM][L::CN];
      project_rows<T, F, kLayerPR>(x, w, x_base, w_base, r0, P, din, xs, ws, acc);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = r0 + ty + i * L::TY;
        if (r < P)
#pragma unroll
          for (int j = 0; j < L::CN; ++j) {
            const int d = tx + j * L::TX;
            dst[r * FS + d] = from_f32<T>(acc[i][j] + bias[d]);
          }
      }
    }
  }

  constexpr int RQ = kLayerQ / L::TY;
  const int warp = tid / 32, lane = tid % 32;
  const Dropout no_drop{false, 0u, 0u, 1.f};
  for (int q0 = 0; q0 < P; q0 += kLayerQ) {
    // q rows of the tile (rows past P are never written out).
    {
      float acc[RQ][L::CN];
      project_rows<T, F, kLayerQ>(x, wq, x_base, w_base, q0, P, din, xs, ws, acc);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < L::CN; ++j) {
          const int d = tx + j * L::TX;
          qs[(ty + i * L::TY) * FS + d] = from_f32<T>((acc[i][j] + bq[hh * F + d]) * scale);
        }
    }
    __syncthreads();  // q of the tile, K and V are in shared memory

    // Scores: warp w takes rows w, w + 8, w + 16, w + 24; lane takes columns
    // c0 + lane + 32 j of a 128-column chunk.
    for (int c0 = 0; c0 < P; c0 += 128) {
      float acc[4][4];
      int cl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) cl[j] = min(c0 + lane + 32 * j, P - 1);  // clamped reads
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < F; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = to_f32(qs[(warp + 8 * i) * FS + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = to_f32(ks[cl[j] * FS + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp + 8 * i, row = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < P)
            ss[r * (P + 1) + c] =
                row < P && adj_b[long(row) * P + c] ? acc[i][j] : kNegBig;
        }
      }
    }
    __syncthreads();
    softmax_rows<T>(ss, inv, P, b, q0, hh, no_drop);
    __syncthreads();
    attend_rows<T, F>(ss, inv, vs, out, out_base, row_stride, P, q0);
    // the next tile's project_rows starts with a barrier before qs, ss change
  }
}

template <typename T, int F>
cudaError_t launch(const void* x, const void* wq, const float* bq, const void* wk,
                   const float* bk, const void* wv, const float* bv, const uint8_t* adj,
                   void* out, int B, int P, int H, int din, float scale, cudaStream_t stream) {
  static_assert(kLayerThreads / 32 * 4 == kLayerQ, "eight warps of four score rows");
  const size_t smem = smem_bytes<T, F>(P);
  if (smem > kLayerMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_layer_dot_kernel<T, F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const long n_blocks = long(B) * H;
  if (n_blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  flash_layer_dot_kernel<T, F><<<unsigned(n_blocks), kLayerThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wq), bq, static_cast<const T*>(wk), bk,
      static_cast<const T*>(wv), bv, adj, static_cast<T*>(out), P, H, din, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_f(const void* x, const void* wq, const float* bq, const void* wk,
                       const float* bk, const void* wv, const float* bv, const uint8_t* adj,
                       void* out, int B, int P, int H, int din, int F, float scale,
                       cudaStream_t stream) {
  switch (F) {
#define DFGNN_LAYER_DOT_CASE(FF)                                                               \
    case FF: return launch<T, FF>(x, wq, bq, wk, bk, wv, bv, adj, out, B, P, H, din, scale, \
                                  stream);
    DFGNN_LAYER_DOT_CASE(8)
    DFGNN_LAYER_DOT_CASE(16)
    DFGNN_LAYER_DOT_CASE(32)
    DFGNN_LAYER_DOT_CASE(64)
    DFGNN_LAYER_DOT_CASE(128)
    DFGNN_LAYER_DOT_CASE(256)
#undef DFGNN_LAYER_DOT_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype (of x, the weights and out): 0 = fp32, 1 = bf16.  x: [B, P, din]
// contiguous; wq, wk, wv: [H, din, F] contiguous; bq, bk, bv: fp32 [H, F];
// adj: [B, P, P] uint8; out: [B, P, H, F].  Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (cudaErrorInvalidValue for a shape
// whose shared memory does not fit).
int dfgnn_flash_layer_dot_fwd(int dtype, const void* x, const void* wq, const void* bq,
                              const void* wk, const void* bk, const void* wv, const void* bv,
                              const void* adj, void* out, int B, int P, int H, int din, int F,
                              float scale, void* stream) {
  if (B < 1 || H < 1 || din < 1 || P < 1 || P > kLayerMaxP) return int(cudaErrorInvalidValue);
  const auto* a = static_cast<const uint8_t*>(adj);
  const auto* fq = static_cast<const float*>(bq);
  const auto* fk = static_cast<const float*>(bk);
  const auto* fv = static_cast<const float*>(bv);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(dispatch_f<float>(x, wq, fq, wk, fk, wv, fv, a, out, B, P, H, din, F, scale, s));
  if (dtype == 1)
    return int(dispatch_f<__nv_bfloat16>(x, wq, fq, wk, fk, wv, fv, a, out, B, P, H, din, F,
                                         scale, s));
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
