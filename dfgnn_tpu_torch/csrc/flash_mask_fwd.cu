// Masked dense graph-attention forward with the dot score for Hopper
// (sm_90a), hand-written CUDA on the tensor cores: kernel #1.
//
// Replaces dfgnn_tpu/ops/pallas/flash_mask.py::_fwd_kernel_dot (:160) and its
// body _softmax_matmul (:131).  For every graph b and head h of a DenseBatch,
// with q already scaled by head_dim**-0.5:
//   s   = q . k^T, times val[b] when edge values are given
//   s   = adj[b] ? s : -1e30
//   m   = max(rowmax(s), -0.5e30)     masked lanes then underflow to exactly 0
//   ex  = exp(s - m), l = rowsum(ex)  (the undropped ex)
//   out = (round_to<T>(ex * keep) . v) * (l > 0 ? 1 / l : 0)
//   lse = l > 0 ? m + log(l) : -1e30  optional, [h, B, P] fp32
// keep is the edge-hash dropout factor of flash_common.cuh (1 without
// dropout).  Inputs and the output keep the JAX layout [B, P, h, f], any f
// >= 1: the staged tiles are zero past f up to the instantiated width FI
// (32, 64, 128 or 256), which adds only 0 * 0 terms, and only f columns are
// stored; past 256 a grid axis takes the columns in chunks of 256
// (flash_fwd.cuh).  fp32 or bf16 inputs; fp32 softmax and sums; fp32
// products as 3xTF32, or one TF32 pass (precision "default").
//
// What bounds it on an H100 SXM (data-sheet peaks): the function needs its
// two products only on the edges.  At the table's shape (B=1024, h=1, P=128,
// f=128, fp32) the bytes of q, k, v, adj read and out, lse written take
// 0.085 ms at 3.35 TB/s, and the dense [P, P] blocks' 2 products of 4.3
// GFLOP take 0.05 ms as 3xTF32 on the tensor cores (a third of 495
// TFLOP/s): device memory bounds it, if the products run on the tensor cores
// and the padding is skipped.
//
// Design: the shared forward body of flash_fwd.cuh with its dot-score
// policy (DotScore: Q rows and K tiles staged, s = q . k^T by mma.sync),
// which also serves the additive score (#2, flash_add_fwd.cu).

#include "flash_fwd.cuh"

extern "C" {

// dtype: 0 = fp32, 1 = bf16.  q, k, v, out: [B, P, H, F] contiguous, F >= 1;
// adj: [B, P, P] uint8; val: [B, P, P] fp32 or null; lse: [H, B, P] fp32 or
// null.  drop != 0 applies dropout with the hash's seed, its keep threshold
// and the fp32 scale 1 / (1 - rate).  one_pass != 0 runs fp32 products as
// one TF32 pass (precision "default"; bf16 ignores it).  Launches on
// `stream`, allocates nothing, and returns cudaGetLastError().
int dfgnn_flash_mask_fwd(int dtype, const void* q, const void* k, const void* v,
                         const void* adj, const void* val, void* out, void* lse, int B, int P,
                         int H, int F, int drop, uint32_t seed, uint32_t threshold, float scale,
                         int one_pass, void* stream) {
  const auto* a = static_cast<const uint8_t*>(adj);
  const auto* ev = static_cast<const float*>(val);
  auto* l = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  const Dropout d{drop != 0, seed, threshold, scale};
  if (dtype == 0) {
    const DotScore<float> sc{static_cast<const float*>(q), static_cast<const float*>(k)};
    return int(flash_fwd<DotScore<float>, float>(sc, v, a, ev, out, l, B, P, H, F, d,
                                                 one_pass != 0, s));
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    const DotScore<bf16> sc{static_cast<const bf16*>(q), static_cast<const bf16*>(k)};
    return int(flash_fwd<DotScore<bf16>, bf16>(sc, v, a, ev, out, l, B, P, H, F, d, false, s));
  }
  return int(cudaErrorInvalidValue);
}

const char* dfgnn_cuda_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
