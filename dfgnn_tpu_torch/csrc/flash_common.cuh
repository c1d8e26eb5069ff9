// Helpers shared by the flash-attention kernels (flash_mask_fwd.cu,
// flash_mask_bwd.cu): fp32 <-> storage-type conversion and the tile loader.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: what a product sees of a value cast to T first.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Copies node rows [n0, n0 + kN) of one (graph, head) into a [kN, F + 1]
// fp32 tile (the +1 keeps column reads of neighbouring rows in different
// banks); rows past P read as 0.  `base` is element (b, 0, head, 0) of a
// [B, P, H, F] tensor and `row_stride` = H * F.
template <typename T, int F, int kN, int kThreads>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, long base, long row_stride,
                                          int n0, int P, float* tile) {
  for (int i = threadIdx.x; i < kN * F; i += kThreads) {
    const int c = i / F, d = i - c * F;
    const int node = n0 + c;
    tile[c * (F + 1) + d] = node < P ? to_f32(src[base + node * row_stride + d]) : 0.f;
  }
}

}  // namespace
