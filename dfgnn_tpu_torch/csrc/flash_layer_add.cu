// The whole GAT layer in one kernel: the W projection, the a_l / a_r score
// contractions and masked additive-score attention with the per-edge
// dropout, for Hopper (sm_90a), hand-written CUDA.
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
// x's type.  No edge values, as in the Pallas kernel.  fp32 or bf16 inputs;
// fp32 arithmetic as full fp32 FMAs.
//
// What bounds it on an H100 SXM (data-sheet peaks): the projection,
// 2 * din * F operations per node and head, the two contractions, 2 * 2 * F,
// and ex . z on the edges, 2 * F per edge and head.  At the GAT serving shape
// (B=1024, H=1, P=128, din=F=128, fp32, about 6.0M edges) that is 4.3 + 0.07
// + 1.5 GFLOP, 0.09 ms at 67 TFLOP/s, against 151 MB of x, adj read and out
// written, 0.045 ms at 3.35 TB/s: operations bound the function.  This kernel
// computes ex . z over every entry of the dense [P, P] blocks (4.3 GFLOP).
//
// Design: kernel #5's (flash_layer_dot.cu) with one projection.  One block
// takes one (graph, head): it projects z of all P nodes, sums e_l and e_r
// from the fp32 values across the lanes that hold a row, keeps round_to<T>(z)
// [P, F] and e_l, e_r [P] in shared memory, then walks the query rows in
// tiles of 32: each score is two scalars' sum, the softmax and dropout are
// kernel #2's, and the exponentials multiply z.  Shapes whose shared memory
// does not fit raise in the wrapper (P = 128 takes F <= 256 in fp32 and bf16).

#include "flash_layer.cuh"

namespace {

template <typename T, int F>
size_t smem_bytes(int P) {
  return sizeof(float) * (layer_staging_floats(P, F) + 2 * size_t(P)) +
         sizeof(T) * size_t(P) * (F + row_pad<T>());
}

template <typename T, int F>
__global__ void __launch_bounds__(kLayerThreads)
flash_layer_add_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bias, const float* __restrict__ a_l,
                       const float* __restrict__ a_r, const uint8_t* __restrict__ adj,
                       T* __restrict__ out, int P, int H, int din, float slope, Dropout drop) {
  using L = ColLayout<F>;
  constexpr int FS = F + row_pad<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [kLayerPR][kLayerK + 1]
  float* ws = xs + kLayerPR * (kLayerK + 1);        // [kLayerK][F]
  float* ss = ws + kLayerK * F;                     // [kLayerQ][P + 1]: scores, then ex
  float* inv = ss + kLayerQ * (P + 1);              // [kLayerQ]
  float* els = inv + kLayerQ;                       // [P]: e_l
  float* ers = els + P;                             // [P]: e_r
  T* zs = reinterpret_cast<T*>(ers + P);            // [P][FS]: round_to<T>(z)

  const int hh = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int tid = threadIdx.x;
  const int tx = tid % L::TX, ty = tid / L::TX;
  const long x_base = long(b) * P * din;
  const long w_base = long(hh) * din * F;
  const uint8_t* adj_b = adj + long(b) * P * P;
  const long row_stride = long(H) * F;              // out is [B, P, H, F]
  const long out_base = (long(b) * P * H + hh) * F;

  float bb[L::CN], al[L::CN], ar[L::CN];
#pragma unroll
  for (int j = 0; j < L::CN; ++j) {
    const int d = hh * F + tx + j * L::TX;
    bb[j] = bias[d];
    al[j] = a_l[d];
    ar[j] = a_r[d];
  }

  // z, e_l and e_r of all P nodes.  The TX lanes that share a row are an
  // aligned group of one warp, so a butterfly over them sums the row.
  constexpr int RM = kLayerPR / L::TY;
  for (int r0 = 0; r0 < P; r0 += kLayerPR) {
    float acc[RM][L::CN];
    project_rows<T, F, kLayerPR>(x, w, x_base, w_base, r0, P, din, xs, ws, acc);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = r0 + ty + i * L::TY;
      float pl = 0.f, pr = 0.f;
#pragma unroll
      for (int j = 0; j < L::CN; ++j) {
        const float z = acc[i][j] + bb[j];
        pl += z * al[j];
        pr += z * ar[j];
        if (r < P) zs[r * FS + tx + j * L::TX] = from_f32<T>(z);
      }
#pragma unroll
      for (int o = L::TX / 2; o > 0; o >>= 1) {
        pl += __shfl_xor_sync(0xffffffffu, pl, o);
        pr += __shfl_xor_sync(0xffffffffu, pr, o);
      }
      if (tx == 0 && r < P) {
        els[r] = pl;
        ers[r] = pr;
      }
    }
  }

  for (int q0 = 0; q0 < P; q0 += kLayerQ) {
    __syncthreads();  // z, e_l, e_r are complete; the previous tile's ss is consumed
    for (int e = tid; e < kLayerQ * P; e += kLayerThreads) {
      const int r = e / P, c = e - r * P;
      const int row = q0 + r;
      ss[r * (P + 1) + c] =
          row < P && adj_b[long(row) * P + c] ? leaky(els[row] + ers[c], slope) : kNegBig;
    }
    __syncthreads();
    softmax_rows<T>(ss, inv, P, b, q0, hh, drop);
    __syncthreads();
    attend_rows<T, F>(ss, inv, zs, out, out_base, row_stride, P, q0);
  }
}

template <typename T, int F>
cudaError_t launch(const void* x, const void* w, const float* bias, const float* a_l,
                   const float* a_r, const uint8_t* adj, void* out, int B, int P, int H, int din,
                   float slope, Dropout drop, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, F>(P);
  if (smem > kLayerMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_layer_add_kernel<T, F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const long n_blocks = long(B) * H;
  if (n_blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  flash_layer_add_kernel<T, F><<<unsigned(n_blocks), kLayerThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, a_l, a_r, adj,
      static_cast<T*>(out), P, H, din, slope, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_f(const void* x, const void* w, const float* bias, const float* a_l,
                       const float* a_r, const uint8_t* adj, void* out, int B, int P, int H,
                       int din, int F, float slope, Dropout drop, cudaStream_t stream) {
  switch (F) {
#define DFGNN_LAYER_ADD_CASE(FF)                                                               \
    case FF: return launch<T, FF>(x, w, bias, a_l, a_r, adj, out, B, P, H, din, slope, drop, \
                                  stream);
    DFGNN_LAYER_ADD_CASE(8)
    DFGNN_LAYER_ADD_CASE(16)
    DFGNN_LAYER_ADD_CASE(32)
    DFGNN_LAYER_ADD_CASE(64)
    DFGNN_LAYER_ADD_CASE(128)
    DFGNN_LAYER_ADD_CASE(256)
#undef DFGNN_LAYER_ADD_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype (of x, w and out): 0 = fp32, 1 = bf16.  x: [B, P, din] contiguous;
// w: [H, din, F] contiguous; bias, a_l, a_r: fp32 [H, F]; adj: [B, P, P]
// uint8; out: [B, P, H, F].  drop, seed, threshold and scale as
// dfgnn_flash_add_fwd's.  Launches on `stream`, allocates nothing, and
// returns cudaGetLastError() (cudaErrorInvalidValue for a shape whose shared
// memory does not fit).
int dfgnn_flash_layer_add_fwd(int dtype, const void* x, const void* w, const void* bias,
                              const void* a_l, const void* a_r, const void* adj, void* out,
                              int B, int P, int H, int din, int F, float slope, int drop,
                              unsigned seed, unsigned threshold, float scale, void* stream) {
  if (B < 1 || H < 1 || din < 1 || P < 1 || P > kLayerMaxP) return int(cudaErrorInvalidValue);
  const auto* a = static_cast<const uint8_t*>(adj);
  const auto* fb = static_cast<const float*>(bias);
  const auto* fl = static_cast<const float*>(a_l);
  const auto* fr = static_cast<const float*>(a_r);
  auto s = static_cast<cudaStream_t>(stream);
  const Dropout dr{drop != 0, seed, threshold, scale};
  if (dtype == 0)
    return int(dispatch_f<float>(x, w, fb, fl, fr, a, out, B, P, H, din, F, slope, dr, s));
  if (dtype == 1)
    return int(dispatch_f<__nv_bfloat16>(x, w, fb, fl, fr, a, out, B, P, H, din, F, slope, dr,
                                         s));
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
