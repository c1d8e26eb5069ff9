// Masked dense graph-attention forward with the additive (GAT) score, for
// Hopper (sm_90a), hand-written CUDA.
//
// Replaces dfgnn_tpu/ops/pallas/flash_mask.py::_fwd_kernel_add (:173) and its
// body _softmax_matmul (:131), driven there by _fwd (:239).  For every graph
// b and head h of a DenseBatch, from per-node fp32 scalars e_row, e_col
// [B, P, h] (the layer's node-major layout, read through strides: no
// [h, B, P] copy; fp32 whatever v's type, as the Pallas kernel reads them):
//   pre = e_row[r] + e_col[c]
//   s   = leaky_relu(pre) (pre >= 0 ? pre : slope * pre), times val[b]
//   s   = adj[b] ? s : -1e30
//   m   = max(rowmax(s), -0.5e30)     masked lanes then underflow to exactly 0
//   ex  = exp(s - m), l = rowsum(ex), inv = l > 0 ? 1 / l : 0
//   out = (round_to<T>(ex * keep) . v) * inv      an empty row gives exactly 0
//   lse = l > 0 ? m + log(l) : -1e30  optional, [h, B, P] fp32
// keep is the dropout factor of flash_common.cuh (1 without dropout): l sums
// the undropped ex and lse does not see dropout, as in the Pallas kernel.
// fp32 or bf16 v and out; fp32 arithmetic.
//
// What bounds it on an H100 SXM (data-sheet peaks): the function needs one
// product, ex . v, only on the edges: 2*f operations per edge and head.  At
// the serving shape (B=1024, h=1, P=128, f=128, fp32) with a fifth of the
// block entries edges, as chip_smoke.py's inputs have, that is 0.9 GFLOP,
// 0.014 ms at 67 TFLOP/s, against 153 MB of e_row, e_col, v, adj read and out,
// lse written, 0.046 ms at 3.35 TB/s: device memory bounds the function.
// This kernel computes the product over every entry of the dense [P, P]
// blocks (4.3 GFLOP, 0.064 ms), as fp32 FMAs on the CUDA cores (TF32 would
// break rtol 1e-4 against the plain version), fed from shared memory.
//
// Design: kernel #1's (flash_mask_fwd.cu) without its K stream.  A block
// takes kRows query rows of one (graph, head), keeps e_col of the graph and
// its [kRows, P] score rows in shared memory, forms each score from two
// scalars, and streams V through one [kCols, f + 1] shared-memory tile.  The
// Pallas kernel packs G graphs per grid step into 16 MB of VMEM; a Hopper
// block has 227 KB, and softmax rows need no communication between blocks.

#include "flash_common.cuh"

namespace {

constexpr int kRows = 16;      // query rows of one (graph, head) per block
constexpr int kCols = 64;      // value rows per shared-memory tile
constexpr int kThreads = 256;
constexpr int kMaxP = 2048;    // the [kRows, P] score rows must fit shared memory
constexpr float kDead = -0.5e30f;

template <int F>
size_t smem_bytes(int P) {
  return sizeof(float) * (size_t(kCols) * (F + 1) + size_t(kRows) * P + P + 2 * kRows);
}

template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
flash_add_fwd_kernel(const float* __restrict__ e_row, const float* __restrict__ e_col,
                     const T* __restrict__ v, const uint8_t* __restrict__ adj,
                     const float* __restrict__ val, T* __restrict__ out,
                     float* __restrict__ lse, int B, int P, int H, float slope, Dropout drop) {
  extern __shared__ float smem[];
  float* tile = smem;                  // [kCols][F + 1]: V tiles
  float* ss = tile + kCols * (F + 1);  // [kRows][P]: scores, then ex (* keep)
  float* ecs = ss + kRows * P;         // [P]: e_col of the graph
  float* ers = ecs + P;                // [kRows]: e_row of the block's rows
  float* inv = ers + kRows;            // [kRows]

  const int n_row_blocks = (P + kRows - 1) / kRows;
  const int rb = blockIdx.x % n_row_blocks;
  const int hh = (blockIdx.x / n_row_blocks) % H;
  const int b = blockIdx.x / (n_row_blocks * H);
  const int r0 = rb * kRows;
  const int tid = threadIdx.x;
  const long row_stride = long(H) * F;          // elements between nodes in [B, P, H, F]
  const long base = (long(b) * P * H + hh) * F; // element (b, 0, hh, 0)
  const long sbase = long(b) * P * H + hh;      // element (b, 0, hh) of [B, P, H]
  const uint8_t* adj_b = adj + long(b) * P * P;
  const float* val_b = val ? val + long(b) * P * P : nullptr;

  for (int c = tid; c < P; c += kThreads) ecs[c] = e_col[sbase + long(c) * H];
  if (tid < kRows) ers[tid] = r0 + tid < P ? e_row[sbase + long(r0 + tid) * H] : 0.f;
  __syncthreads();

  // Scores: consecutive threads take consecutive columns of a row.
  for (int i = tid; i < kRows * P; i += kThreads) {
    const int r = i / P, c = i - r * P;
    float s = kNegBig;
    if (r0 + r < P) {
      const long e = long(r0 + r) * P + c;
      if (adj_b[e]) {
        s = leaky(ers[r] + ecs[c], slope);
        if (val_b) s *= val_b[e];
      }
    }
    ss[i] = s;
  }
  __syncthreads();

  // Softmax: one warp per row.  l sums the undropped ex; the product takes
  // ex * keep rounded to v's dtype, as the Pallas kernel casts it.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float* srow = ss + r * P;
    float m = kNegBig;
    for (int c = lane; c < P; c += 32) m = fmaxf(m, srow[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    m = fmaxf(m, kDead);
    float l = 0.f;
    for (int c = lane; c < P; c += 32) {
      float e = expf(srow[c] - m);
      l += e;
      if (drop.on) e *= drop.factor(b, P, r0 + r, c, hh);
      srow[c] = round_to<T>(e);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      inv[r] = l > 0.f ? 1.f / l : 0.f;
      if (lse != nullptr && r0 + r < P)
        lse[(long(hh) * B + b) * P + r0 + r] = l > 0.f ? m + logf(l) : kNegBig;
    }
  }

  // out = ex . v.  Thread -> one feature column d and every kGroups-th row,
  // so a warp reads a contiguous V row and broadcast ex values.
  constexpr int kGroups = kThreads / F;
  constexpr int kRpt = (kRows + kGroups - 1) / kGroups;
  const int d = tid % F;
  const int rg = tid / F;
  float o[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) o[i] = 0.f;
  for (int c0 = 0; c0 < P; c0 += kCols) {
    __syncthreads();  // ex and inv are written and the previous tile is consumed
    load_tile<T, F, kCols, kThreads>(v, base, row_stride, c0, P, tile);
    __syncthreads();
    const int nc = min(kCols, P - c0);
    for (int c = 0; c < nc; ++c) {
      const float vd = tile[c * (F + 1) + d];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        const int r = rg + i * kGroups;
        if (r < kRows) o[i] = fmaf(ss[r * P + c0 + c], vd, o[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int r = rg + i * kGroups;
    if (r < kRows && r0 + r < P) out[base + (r0 + r) * row_stride + d] = from_f32<T>(o[i] * inv[r]);
  }
}

template <typename T, int F>
cudaError_t launch(const void* e_row, const void* e_col, const void* v, const uint8_t* adj,
                   const float* val, void* out, float* lse, int B, int P, int H, float slope,
                   Dropout drop, cudaStream_t stream) {
  static_assert(kThreads % F == 0, "a feature column per thread needs F | kThreads");
  const size_t smem = smem_bytes<F>(P);
  cudaError_t err = cudaFuncSetAttribute(flash_add_fwd_kernel<T, F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const long n_blocks = long(B) * H * ((P + kRows - 1) / kRows);
  if (n_blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  flash_add_fwd_kernel<T, F><<<unsigned(n_blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(e_row), static_cast<const float*>(e_col), static_cast<const T*>(v), adj,
      val, static_cast<T*>(out), lse, B, P, H, slope, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_f(const void* e_row, const void* e_col, const void* v, const uint8_t* adj,
                       const float* val, void* out, float* lse, int B, int P, int H, int F,
                       float slope, Dropout drop, cudaStream_t stream) {
  switch (F) {
#define DFGNN_ADD_FWD_CASE(FF) \
    case FF: return launch<T, FF>(e_row, e_col, v, adj, val, out, lse, B, P, H, slope, drop, stream);
    DFGNN_ADD_FWD_CASE(8)
    DFGNN_ADD_FWD_CASE(16)
    DFGNN_ADD_FWD_CASE(32)
    DFGNN_ADD_FWD_CASE(64)
    DFGNN_ADD_FWD_CASE(128)
    DFGNN_ADD_FWD_CASE(256)
#undef DFGNN_ADD_FWD_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype (of v and out): 0 = fp32, 1 = bf16.  e_row, e_col: fp32 [B, P, H]
// contiguous; v, out:
// [B, P, H, F] contiguous; adj: [B, P, P] uint8; val: [B, P, P] fp32 or null;
// lse: [H, B, P] fp32 or null.  drop != 0 applies dropout with the hash's
// seed and threshold and the fp32 scale 1 / (1 - rate).  Launches on
// `stream`, allocates nothing, and returns cudaGetLastError().
int dfgnn_flash_add_fwd(int dtype, const void* e_row, const void* e_col, const void* v,
                        const void* adj, const void* val, void* out, void* lse, int B, int P,
                        int H, int F, float slope, int drop, unsigned seed, unsigned threshold,
                        float scale, void* stream) {
  if (B < 1 || H < 1 || P < 1 || P > kMaxP) return int(cudaErrorInvalidValue);
  const auto* a = static_cast<const uint8_t*>(adj);
  const auto* ev = static_cast<const float*>(val);
  auto* l = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  const Dropout dr{drop != 0, seed, threshold, scale};
  if (dtype == 0)
    return int(dispatch_f<float>(e_row, e_col, v, a, ev, out, l, B, P, H, F, slope, dr, s));
  if (dtype == 1)
    return int(dispatch_f<__nv_bfloat16>(e_row, e_col, v, a, ev, out, l, B, P, H, F, slope, dr,
                                         s));
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
