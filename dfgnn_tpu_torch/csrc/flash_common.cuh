// Helpers shared by the flash-attention kernels (flash_mask_fwd.cu,
// flash_mask_bwd.cu, flash_add_fwd.cu, flash_add_bwd.cu, flash_layer_*.cu):
// fp32 <-> storage-type conversion, the leaky ReLU of the additive score and
// the per-edge dropout hash.
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

// The additive (GAT) score before edge values: leaky_relu(pre), tested on
// pre >= 0 as the Pallas kernels test it.
__device__ __forceinline__ float leaky(float pre, float slope) {
  return pre >= 0.f ? pre : pre * slope;
}

// The per-edge dropout hash of dfgnn_tpu_torch/ops/edge_dropout.py (and of the
// JAX package's edge_dropout.py), in uint32: a murmur3 finaliser over seed,
// dst, src and head.  An edge is kept when its hash is >= threshold.
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t edge_hash(uint32_t seed, uint32_t dst, uint32_t src,
                                              uint32_t head) {
  uint32_t h = mix32(seed ^ (dst * 0x9E3779B1u));
  h = mix32(h ^ (src * 0x85EBCA77u));
  return mix32(h ^ (head * 0xC2B2AE3Du));
}

// Dropout as the Pallas kernels' _drop_scale applies it to a (graph, head)
// block of P nodes: ids dst = g * P + r, src = g * P + c, head = h; the
// factor is `scale` (fp32 of 1 / (1 - rate)) when kept, else 0.  The host
// passes threshold and scale, so the device computes neither from the rate.
struct Dropout {
  bool on;
  uint32_t seed, threshold;
  float scale;
  __device__ __forceinline__ float factor(int g, int P, int r, int c, int h) const {
    const uint32_t base = uint32_t(g) * uint32_t(P);
    return edge_hash(seed, base + uint32_t(r), base + uint32_t(c), uint32_t(h)) >= threshold
               ? scale : 0.f;
  }
};

}  // namespace
