// Masked dense graph-attention forward for Hopper (sm_90a), hand-written CUDA.
//
// Replaces dfgnn_tpu/ops/pallas/flash_mask.py::_fwd_kernel_dot and its body
// _softmax_matmul.  For every graph b and head h of a DenseBatch, with q
// already scaled by head_dim**-0.5:
//   s   = q . k^T, times val[b] when edge values are given
//   s   = adj[b] ? s : -1e30
//   m   = max(rowmax(s), -0.5e30)     masked lanes then underflow to exactly 0
//   ex  = exp(s - m), l = rowsum(ex), inv = l > 0 ? 1 / l : 0
//   out = (ex . v) * inv              an empty row gives exactly 0
//   lse = l > 0 ? m + log(l) : -1e30  optional, [h, B, P] fp32
// Inputs and the output keep the JAX layout [B, P, h, f] (node-major), so the
// wrapper makes no head-major copy.  fp32 or bf16 inputs; fp32 arithmetic.
//
// What bounds it on an H100 SXM (data-sheet peaks): the function needs its
// two products only on the edges, 4*f operations per edge and head.  At the
// main shape (B=1024, h=1, P=128, f=128, fp32) with a fifth of the block
// entries edges, as chip_smoke.py's inputs have, that is 1.8 GFLOP, 0.03 ms at
// 67 TFLOP/s, against 286 MB of q, k, v, adj read and out, lse written,
// 0.085 ms at 3.35 TB/s: device memory bounds the function.  This kernel
// computes every entry of the dense [P, P] blocks (8.6 GFLOP, 0.128 ms), so
// the work sets its pace.  fp32 parity (rtol 1e-4 against the plain version)
// rules out TF32 tensor cores, so the products run as fp32 FMAs on the CUDA
// cores, fed from shared memory; shared-memory bandwidth is the limit of
// this first design.  The Pallas kernel packs G
// graphs per grid step to fill 16 MB of VMEM; a Hopper block has 227 KB.  So
// each block takes kRows query rows of one (graph, head), keeps its [kRows, P]
// score rows in shared memory, and streams K and then V through one
// [kCols, f] shared-memory tile.  Softmax rows are independent, so splitting
// a graph's rows across blocks needs no communication between blocks.

#include "flash_common.cuh"

namespace {

constexpr int kRows = 16;      // query rows of one (graph, head) per block
constexpr int kCols = 64;      // key / value rows per shared-memory tile
constexpr int kThreads = 256;
constexpr int kMaxP = 2048;    // the [kRows, P] score rows must fit shared memory
constexpr float kDead = -0.5e30f;

template <int F>
size_t smem_bytes(int P) {
  return sizeof(float) * (size_t(kRows) * F + size_t(kCols) * (F + 1) + size_t(kRows) * P + kRows);
}

template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
flash_mask_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const uint8_t* __restrict__ adj, const float* __restrict__ val,
                      T* __restrict__ out, float* __restrict__ lse, int B, int P, int H) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [kRows][F]
  float* tile = qs + kRows * F;       // [kCols][F + 1]: K tiles, then V tiles
  float* ss = tile + kCols * (F + 1); // [kRows][P]: scores, then exp(s - m)
  float* inv = ss + kRows * P;        // [kRows]

  const int n_row_blocks = (P + kRows - 1) / kRows;
  const int rb = blockIdx.x % n_row_blocks;
  const int hh = (blockIdx.x / n_row_blocks) % H;
  const int b = blockIdx.x / (n_row_blocks * H);
  const int r0 = rb * kRows;
  const int tid = threadIdx.x;
  const long row_stride = long(H) * F;          // elements between nodes in [B, P, H, F]
  const long base = (long(b) * P * H + hh) * F; // element (b, 0, hh, 0)
  const uint8_t* adj_b = adj + long(b) * P * P;
  const float* val_b = val ? val + long(b) * P * P : nullptr;

  for (int i = tid; i < kRows * F; i += kThreads) {
    const int r = i / F, d = i - r * F;
    qs[i] = r0 + r < P ? to_f32(q[base + (r0 + r) * row_stride + d]) : 0.f;
  }

  // Scores.  Thread -> one column of the tile and kRows / kGroups1 rows, so a
  // warp reads 32 neighbouring K rows and one broadcast q row.
  constexpr int kGroups1 = kThreads / kCols;
  constexpr int kRpt1 = kRows / kGroups1;
  const int col_in_tile = tid % kCols;
  const int rg1 = tid / kCols;
  for (int c0 = 0; c0 < P; c0 += kCols) {
    __syncthreads();  // q is loaded and the previous tile is consumed
    load_tile<T, F, kCols, kThreads>(k, base, row_stride, c0, P, tile);
    __syncthreads();
    float acc[kRpt1];
#pragma unroll
    for (int i = 0; i < kRpt1; ++i) acc[i] = 0.f;
    const float* krow = tile + col_in_tile * (F + 1);
#pragma unroll 16
    for (int d = 0; d < F; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int i = 0; i < kRpt1; ++i) acc[i] = fmaf(qs[(rg1 + i * kGroups1) * F + d], kd, acc[i]);
    }
    const int col = c0 + col_in_tile;
    if (col < P) {
#pragma unroll
      for (int i = 0; i < kRpt1; ++i) {
        const int r = rg1 + i * kGroups1;
        float s = kNegBig;
        if (r0 + r < P) {
          const long e = long(r0 + r) * P + col;
          const float sv = val_b ? acc[i] * val_b[e] : acc[i];
          s = adj_b[e] ? sv : kNegBig;
        }
        ss[r * P + col] = s;
      }
    }
  }
  __syncthreads();

  // Softmax: one warp per row.
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
      const float e = expf(srow[c] - m);
      l += e;
      srow[c] = round_to<T>(e);  // the product takes ex in v's dtype, as the Pallas kernel does
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      inv[r] = l > 0.f ? 1.f / l : 0.f;
      if (lse != nullptr && r0 + r < P)
        lse[(long(hh) * B + b) * P + r0 + r] = l > 0.f ? m + logf(l) : kNegBig;
    }
  }

  // out = ex . v.  Thread -> one feature column d and every kGroups3-th row,
  // so a warp reads a contiguous V row and broadcast ex values.
  constexpr int kGroups3 = kThreads / F;
  constexpr int kRpt3 = (kRows + kGroups3 - 1) / kGroups3;
  const int d = tid % F;
  const int rg3 = tid / F;
  float o[kRpt3];
#pragma unroll
  for (int i = 0; i < kRpt3; ++i) o[i] = 0.f;
  for (int c0 = 0; c0 < P; c0 += kCols) {
    __syncthreads();  // ex and inv are written and the previous tile is consumed
    load_tile<T, F, kCols, kThreads>(v, base, row_stride, c0, P, tile);
    __syncthreads();
    const int nc = min(kCols, P - c0);
    for (int c = 0; c < nc; ++c) {
      const float vd = tile[c * (F + 1) + d];
#pragma unroll
      for (int i = 0; i < kRpt3; ++i) {
        const int r = rg3 + i * kGroups3;
        if (r < kRows) o[i] = fmaf(ss[r * P + c0 + c], vd, o[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRpt3; ++i) {
    const int r = rg3 + i * kGroups3;
    if (r < kRows && r0 + r < P) out[base + (r0 + r) * row_stride + d] = from_f32<T>(o[i] * inv[r]);
  }
}

template <typename T, int F>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* adj,
                   const float* val, void* out, float* lse, int B, int P, int H,
                   cudaStream_t stream) {
  static_assert(kThreads % F == 0, "a feature column per thread needs F | kThreads");
  const size_t smem = smem_bytes<F>(P);
  cudaError_t err = cudaFuncSetAttribute(flash_mask_fwd_kernel<T, F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const long n_blocks = long(B) * H * ((P + kRows - 1) / kRows);
  if (n_blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  flash_mask_fwd_kernel<T, F><<<unsigned(n_blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), adj, val,
      static_cast<T*>(out), lse, B, P, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_f(const void* q, const void* k, const void* v, const uint8_t* adj,
                       const float* val, void* out, float* lse, int B, int P, int H, int F,
                       cudaStream_t stream) {
  switch (F) {
    case 8: return launch<T, 8>(q, k, v, adj, val, out, lse, B, P, H, stream);
    case 16: return launch<T, 16>(q, k, v, adj, val, out, lse, B, P, H, stream);
    case 32: return launch<T, 32>(q, k, v, adj, val, out, lse, B, P, H, stream);
    case 64: return launch<T, 64>(q, k, v, adj, val, out, lse, B, P, H, stream);
    case 128: return launch<T, 128>(q, k, v, adj, val, out, lse, B, P, H, stream);
    case 256: return launch<T, 256>(q, k, v, adj, val, out, lse, B, P, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16.  q, k, v, out: [B, P, H, F] contiguous; adj:
// [B, P, P] uint8; val: [B, P, P] fp32 or null; lse: [H, B, P] fp32 or null.
// Launches on `stream`, allocates nothing, and returns cudaGetLastError().
int dfgnn_flash_mask_fwd(int dtype, const void* q, const void* k, const void* v,
                         const void* adj, const void* val, void* out, void* lse, int B, int P,
                         int H, int F, void* stream) {
  if (B < 1 || H < 1 || P < 1 || P > kMaxP) return int(cudaErrorInvalidValue);
  const auto* a = static_cast<const uint8_t*>(adj);
  const auto* ev = static_cast<const float*>(val);
  auto* l = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(dispatch_f<float>(q, k, v, a, ev, out, l, B, P, H, F, s));
  if (dtype == 1) return int(dispatch_f<__nv_bfloat16>(q, k, v, a, ev, out, l, B, P, H, F, s));
  return int(cudaErrorInvalidValue);
}

const char* dfgnn_cuda_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
