// Helpers of the whole-layer GAT kernel (flash_layer_add.cu, #6): the block's
// tile sizes, its shared-memory budget, and the projection x . W of a block
// of node rows, in fp32 FMAs.  (#5, flash_layer_dot.cu, runs on the tensor
// cores on the forward body of #1, flash_fwd.cuh.)
#pragma once

#include "flash_common.cuh"

namespace {

constexpr int kLayerThreads = 256;
constexpr int kLayerQ = 32;     // query rows per attention tile
constexpr int kLayerPR = 64;    // node rows per projection pass of K, V (or z)
constexpr int kLayerK = 32;     // depth (din) of one staged x / W tile
constexpr int kLayerMaxP = 2048;
constexpr size_t kLayerMaxSmem = 232448;  // what one H100 block may use
constexpr float kLayerDead = -0.5e30f;

// Elements of padding after a row of F values of T in shared memory: the row
// then spans an odd number of 32-bit words, so 32 lanes that read one element
// of 32 different rows hit 32 different banks.
template <typename T>
__host__ __device__ constexpr int row_pad() { return sizeof(T) == 4 ? 1 : 2; }

// The fp32 staging area that both kernels lay out first: an x tile
// [kLayerPR][kLayerK + 1], a W tile [kLayerK][F], the score rows
// [kLayerQ][P + 1] and their reciprocal row sums [kLayerQ].
inline size_t layer_staging_floats(int P, int F) {
  return size_t(kLayerPR) * (kLayerK + 1) + size_t(kLayerK) * F + size_t(kLayerQ) * (P + 1) +
         kLayerQ;
}

// Thread layout of an [R, F] block of outputs: TX threads across the columns
// (column d = tx + j * TX, j < CN) and TY = kLayerThreads / TX across the rows
// (row r = ty + i * TY).  A warp then reads one broadcast row element and TX
// neighbouring column elements.
template <int F>
struct ColLayout {
  static constexpr int TX = F < 32 ? F : 32;
  static constexpr int TY = kLayerThreads / TX;
  static constexpr int CN = F / TX;
};

// acc[i][j] = sum over k < din of x[b, r0 + ty + i * TY, k] * W[h, k, tx + j * TX]
// in fp32 FMAs, k ascending.  x is [B, P, din] and W [H, din, F], both
// contiguous in T; x_base is element (b, 0, 0) and w_base element (h, 0, 0).
// Rows past P read as 0.  The x and W tiles stream through xs and ws; the
// function starts with a barrier, so the caller may have read its previous
// outputs from anywhere in shared memory except xs and ws.
template <typename T, int F, int R>
__device__ __forceinline__ void project_rows(const T* __restrict__ x, const T* __restrict__ w,
                                             long x_base, long w_base, int r0, int P, int din,
                                             float* xs, float* ws,
                                             float (&acc)[R / ColLayout<F>::TY][ColLayout<F>::CN]) {
  using L = ColLayout<F>;
  constexpr int RM = R / L::TY;
  static_assert(RM >= 1 && R % L::TY == 0, "the rows split evenly over the row groups");
  const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < L::CN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < din; k0 += kLayerK) {
    __syncthreads();  // the previous tiles are consumed
    for (int e = threadIdx.x; e < R * kLayerK; e += kLayerThreads) {
      const int r = e / kLayerK, kk = e - r * kLayerK;
      const int row = r0 + r, col = k0 + kk;
      xs[r * (kLayerK + 1) + kk] =
          row < P && col < din ? to_f32(x[x_base + long(row) * din + col]) : 0.f;
    }
    for (int e = threadIdx.x; e < kLayerK * F; e += kLayerThreads) {
      const int kk = e / F;
      ws[e] = k0 + kk < din ? to_f32(w[w_base + long(k0) * F + e]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kLayerK; ++kk) {
      float a[RM], bw[L::CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = xs[(ty + i * L::TY) * (kLayerK + 1) + kk];
#pragma unroll
      for (int j = 0; j < L::CN; ++j) bw[j] = ws[kk * F + tx + j * L::TX];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < L::CN; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
  }
}

// Softmax of the score rows ss [kLayerQ][P + 1] in place, one warp per row,
// as kernels #1 and #2 do: m = max(rowmax, -0.5e30), ex = exp(s - m),
// l = rowsum(ex) (undropped), inv = l > 0 ? 1 / l : 0; each entry becomes
// round_to<T>(ex * keep), keep the dropout factor of (graph b, row q0 + r,
// column c, head h) when drop.on.
template <typename T>
__device__ __forceinline__ void softmax_rows(float* ss, float* inv, int P, int b, int q0, int h,
                                             const Dropout& drop) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kLayerQ; r += kLayerThreads / 32) {
    float* srow = ss + r * (P + 1);
    float m = kNegBig;
    for (int c = lane; c < P; c += 32) m = fmaxf(m, srow[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    m = fmaxf(m, kLayerDead);
    float l = 0.f;
    for (int c = lane; c < P; c += 32) {
      float e = expf(srow[c] - m);
      l += e;
      if (drop.on) e *= drop.factor(b, P, q0 + r, c, h);
      srow[c] = round_to<T>(e);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) inv[r] = l > 0.f ? 1.f / l : 0.f;
  }
}

// out rows q0 .. q0 + kLayerQ - 1 of one (graph, head): (ex . V) * inv, with
// ex the rounded rows of ss and V [P][F + row_pad<T>()] in shared memory.
// out is [B, P, H, F]; out_base is element (b, 0, h, 0).
template <typename T, int F>
__device__ __forceinline__ void attend_rows(const float* ss, const float* inv, const T* vs,
                                            T* __restrict__ out, long out_base, long row_stride,
                                            int P, int q0) {
  using L = ColLayout<F>;
  constexpr int RQ = kLayerQ / L::TY;
  constexpr int FS = F + row_pad<T>();
  const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;
  float o[RQ][L::CN];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < L::CN; ++j) o[i][j] = 0.f;
  for (int c = 0; c < P; ++c) {
    float e[RQ], vv[L::CN];
#pragma unroll
    for (int i = 0; i < RQ; ++i) e[i] = ss[(ty + i * L::TY) * (P + 1) + c];
#pragma unroll
    for (int j = 0; j < L::CN; ++j) vv[j] = to_f32(vs[c * FS + tx + j * L::TX]);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < L::CN; ++j) o[i][j] = fmaf(e[i], vv[j], o[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + i * L::TY;
    if (q0 + r < P)
#pragma unroll
      for (int j = 0; j < L::CN; ++j)
        out[out_base + (q0 + r) * row_stride + tx + j * L::TX] = from_f32<T>(o[i][j] * inv[r]);
  }
}

}  // namespace
