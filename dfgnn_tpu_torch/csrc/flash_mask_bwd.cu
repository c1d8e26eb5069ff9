// Masked dense graph-attention backward for Hopper (sm_90a), hand-written CUDA.
//
// Replaces dfgnn_tpu/ops/pallas/flash_mask.py::_bwd_kernel_dot (:256), driven
// there by _bwd (:317).  For every graph b and head h of a DenseBatch, from
// q (pre-scaled), k, v, dO [B, P, h, f], adj, optional val, the forward's
// lse [h, B, P] and delta = rowsum(dO * out) [h, B, P] (fp32, computed by
// the wrapper, as _bwd computes it outside its kernel):
//   s  = q . k^T, times val[b] when edge values are given
//   p  = adj[b] ? exp(s - lse) : 0        empty rows (lse = -1e30) give p = 0
//   dp = dO . v^T
//   ds = p * (dp - delta), times val[b]   (val is a constant: no d val)
//   dq = ds . k      dk = ds^T . q      dv = p^T . dO
// ds and p are rounded to the input type before the three products, as the
// Pallas kernel casts them (.astype(k.dtype) / .astype(do.dtype)).  fp32 or
// bf16 inputs and outputs, layout [B, P, h, f] read through strides; fp32
// arithmetic.
//
// What bounds it on an H100 SXM (data-sheet peaks): the function needs its 5
// products only on the edges, 10*f operations per edge and head.  At the
// main shape (B=1024, h=1, P=128, f=128, fp32) with a fifth of the block
// entries edges, as chip_smoke.py's inputs have, that is 4.5 GFLOP, 0.07 ms at
// 67 TFLOP/s of fp32 on the CUDA cores, against 554 MB of q, k, v, out (for
// delta), dO, adj, lse read and dq, dk, dv written, 0.165 ms at 3.35 TB/s:
// device memory bounds the function.  This kernel computes every entry of
// the dense [P, P] blocks, 5 products of 4.3 GFLOP (0.32 ms), so the work
// sets its pace.  fp32 parity
// (rtol 1e-4 against the plain version) rules out TF32 tensor cores, so the
// products are fp32 FMAs fed from shared memory, as in flash_mask_fwd.cu.
//
// Design.  The Pallas kernel holds G whole graphs and twelve [P, P] fp32
// temporaries in 16 MB of VMEM; one (graph, head) pair at P=128, f=128 needs
// 256 KB for q, k, v and dO alone, more than a block's 227 KB.  Blocks run in
// no order, so a sum over one axis cannot be carried from block to block.
// Two launches, deterministic, without atomics:
//   (a) flash_mask_bwd_rows: a block per kRows query rows of one (graph,
//       head).  It streams K tiles to rebuild s and p for its rows (kept in
//       shared memory as [kRows, P]), streams V tiles to rebuild dp and turn
//       p into ds in place, then streams K again for dq = ds . K.
//   (b) flash_mask_bwd_cols: a block per kKeys key rows.  It keeps those K
//       and V rows, streams Q and dO tiles of kQRows rows to rebuild s, dp,
//       p and ds for its columns, and accumulates dk = ds^T . Q and
//       dv = p^T . dO in registers.
// Both passes rebuild s and dp, so they do 7 products where the bound counts
// 5.  Both sum s and dp over f in the same order, so p and ds agree bit for
// bit between the passes.

#include "flash_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;    // (a): query rows of one (graph, head) per block
constexpr int kCols = 64;    // (a): key / value rows per streamed tile
constexpr int kKeys = 16;    // (b): key rows of one (graph, head) per block
constexpr int kQRows = 64;   // (b): query / dO rows per streamed tile
constexpr int kPS = kKeys + 1;  // (b): row stride of the p and ds tiles (no bank conflicts)
constexpr int kMaxP = 2048;  // (a)'s [kRows, P] rows must fit shared memory

template <int F>
size_t rows_smem_bytes(int P) {
  return sizeof(float) * (size_t(kRows) * F + size_t(kCols) * (F + 1) + size_t(kRows) * P +
                          2 * kRows);
}

template <int F>
size_t cols_smem_bytes() {
  return sizeof(float) * (2 * kKeys * F + 2 * kQRows * (F + 1) + 2 * kQRows * kPS + 2 * kQRows);
}

// (a) dq.  Thread layout of the two score passes as in the forward: a thread
// takes one column of the tile and kRows / kGroups1 rows, so a warp reads 32
// neighbouring K (or V) rows and one broadcast q (or dO) row.
template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
flash_mask_bwd_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const uint8_t* __restrict__ adj, const float* __restrict__ val,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const T* __restrict__ dout, T* __restrict__ dq, int B, int P, int H) {
  extern __shared__ float smem[];
  float* rows = smem;                  // [kRows][F]: q rows, then dO rows
  float* tile = rows + kRows * F;      // [kCols][F + 1]: K, V, then K tiles
  float* ss = tile + kCols * (F + 1);  // [kRows][P]: p, then ds
  float* lse_s = ss + kRows * P;       // [kRows]
  float* delta_s = lse_s + kRows;      // [kRows]

  const int n_row_blocks = (P + kRows - 1) / kRows;
  const int rb = blockIdx.x % n_row_blocks;
  const int hh = (blockIdx.x / n_row_blocks) % H;
  const int b = blockIdx.x / (n_row_blocks * H);
  const int r0 = rb * kRows;
  const int tid = threadIdx.x;
  const long row_stride = long(H) * F;
  const long base = (long(b) * P * H + hh) * F;
  const uint8_t* adj_b = adj + long(b) * P * P;
  const float* val_b = val ? val + long(b) * P * P : nullptr;
  const long row_off = (long(hh) * B + b) * P;  // element (hh, b, 0) of [H, B, P]

  for (int i = tid; i < kRows * F; i += kThreads) {
    const int r = i / F, d = i - r * F;
    rows[i] = r0 + r < P ? to_f32(q[base + (r0 + r) * row_stride + d]) : 0.f;
  }
  if (tid < kRows) {
    lse_s[tid] = r0 + tid < P ? lse[row_off + r0 + tid] : 0.f;
    delta_s[tid] = r0 + tid < P ? delta[row_off + r0 + tid] : 0.f;
  }

  constexpr int kGroups1 = kThreads / kCols;
  constexpr int kRpt1 = kRows / kGroups1;
  const int col_in_tile = tid % kCols;
  const int rg1 = tid / kCols;

  // p = adj ? exp(s - lse) : 0 into ss
  for (int c0 = 0; c0 < P; c0 += kCols) {
    __syncthreads();  // q, lse are loaded and the previous tile is consumed
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
      for (int i = 0; i < kRpt1; ++i) acc[i] = fmaf(rows[(rg1 + i * kGroups1) * F + d], kd, acc[i]);
    }
    const int col = c0 + col_in_tile;
    if (col < P) {
#pragma unroll
      for (int i = 0; i < kRpt1; ++i) {
        const int r = rg1 + i * kGroups1;
        float p = 0.f;
        if (r0 + r < P) {
          const long e = long(r0 + r) * P + col;
          if (adj_b[e]) p = expf((val_b ? acc[i] * val_b[e] : acc[i]) - lse_s[r]);
        }
        ss[r * P + col] = p;
      }
    }
  }
  __syncthreads();  // every thread is done with the q rows

  for (int i = tid; i < kRows * F; i += kThreads) {
    const int r = i / F, d = i - r * F;
    rows[i] = r0 + r < P ? to_f32(dout[base + (r0 + r) * row_stride + d]) : 0.f;
  }

  // ds = p * (dO . v - delta) (* val), rounded to T, in place of p
  for (int c0 = 0; c0 < P; c0 += kCols) {
    __syncthreads();  // dO is loaded and the previous tile is consumed
    load_tile<T, F, kCols, kThreads>(v, base, row_stride, c0, P, tile);
    __syncthreads();
    float acc[kRpt1];
#pragma unroll
    for (int i = 0; i < kRpt1; ++i) acc[i] = 0.f;
    const float* vrow = tile + col_in_tile * (F + 1);
#pragma unroll 16
    for (int d = 0; d < F; ++d) {
      const float vd = vrow[d];
#pragma unroll
      for (int i = 0; i < kRpt1; ++i) acc[i] = fmaf(rows[(rg1 + i * kGroups1) * F + d], vd, acc[i]);
    }
    const int col = c0 + col_in_tile;
    if (col < P) {
#pragma unroll
      for (int i = 0; i < kRpt1; ++i) {
        const int r = rg1 + i * kGroups1;
        float ds = 0.f;
        if (r0 + r < P) {
          const long e = long(r0 + r) * P + col;
          ds = ss[r * P + col] * (acc[i] - delta_s[r]);
          if (val_b) ds *= val_b[e];
        }
        ss[r * P + col] = round_to<T>(ds);
      }
    }
  }

  // dq = ds . K.  Thread -> one feature column d and every kGroups3-th row.
  constexpr int kGroups3 = kThreads / F;
  constexpr int kRpt3 = (kRows + kGroups3 - 1) / kGroups3;
  const int d = tid % F;
  const int rg3 = tid / F;
  float o[kRpt3];
#pragma unroll
  for (int i = 0; i < kRpt3; ++i) o[i] = 0.f;
  for (int c0 = 0; c0 < P; c0 += kCols) {
    __syncthreads();  // ds is written and the previous tile is consumed
    load_tile<T, F, kCols, kThreads>(k, base, row_stride, c0, P, tile);
    __syncthreads();
    const int nc = min(kCols, P - c0);
    for (int c = 0; c < nc; ++c) {
      const float kd = tile[c * (F + 1) + d];
#pragma unroll
      for (int i = 0; i < kRpt3; ++i) {
        const int r = rg3 + i * kGroups3;
        if (r < kRows) o[i] = fmaf(ss[r * P + c0 + c], kd, o[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRpt3; ++i) {
    const int r = rg3 + i * kGroups3;
    if (r < kRows && r0 + r < P) dq[base + (r0 + r) * row_stride + d] = from_f32<T>(o[i]);
  }
}

// (b) dk and dv.
template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
flash_mask_bwd_cols(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const uint8_t* __restrict__ adj, const float* __restrict__ val,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv, int B,
                    int P, int H) {
  extern __shared__ float smem[];
  float* ks = smem;                       // [kKeys][F]: this block's K rows
  float* vs = ks + kKeys * F;             // [kKeys][F]: its V rows
  float* qt = vs + kKeys * F;             // [kQRows][F + 1]: a Q tile
  float* dt = qt + kQRows * (F + 1);      // [kQRows][F + 1]: a dO tile
  float* pt = dt + kQRows * (F + 1);      // [kQRows][kPS]: p, rounded to T
  float* dst = pt + kQRows * kPS;         // [kQRows][kPS]: ds, rounded to T
  float* lse_t = dst + kQRows * kPS;      // [kQRows]
  float* delta_t = lse_t + kQRows;        // [kQRows]

  const int n_col_blocks = (P + kKeys - 1) / kKeys;
  const int cb = blockIdx.x % n_col_blocks;
  const int hh = (blockIdx.x / n_col_blocks) % H;
  const int b = blockIdx.x / (n_col_blocks * H);
  const int c0 = cb * kKeys;
  const int tid = threadIdx.x;
  const long row_stride = long(H) * F;
  const long base = (long(b) * P * H + hh) * F;
  const uint8_t* adj_b = adj + long(b) * P * P;
  const float* val_b = val ? val + long(b) * P * P : nullptr;
  const long row_off = (long(hh) * B + b) * P;

  for (int i = tid; i < kKeys * F; i += kThreads) {
    const int c = i / F, d = i - c * F;
    const bool live = c0 + c < P;
    ks[i] = live ? to_f32(k[base + (c0 + c) * row_stride + d]) : 0.f;
    vs[i] = live ? to_f32(v[base + (c0 + c) * row_stride + d]) : 0.f;
  }

  // Scores: thread -> one query row r of the tile and every kGroups1-th key,
  // so a warp reads 32 neighbouring Q (dO) rows and one broadcast K (V) row.
  constexpr int kGroups1 = kThreads / kQRows;
  constexpr int kCpt1 = kKeys / kGroups1;
  const int r = tid % kQRows;
  const int kg = tid / kQRows;
  // Sums: thread -> one feature column d and every kGroups3-th key.
  constexpr int kGroups3 = kThreads / F;
  constexpr int kCpt3 = (kKeys + kGroups3 - 1) / kGroups3;
  const int d3 = tid % F;
  const int cg = tid / F;
  float dk_acc[kCpt3], dv_acc[kCpt3];
#pragma unroll
  for (int j = 0; j < kCpt3; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int r0 = 0; r0 < P; r0 += kQRows) {
    __syncthreads();  // K, V are loaded and the previous tile is consumed
    load_tile<T, F, kQRows, kThreads>(q, base, row_stride, r0, P, qt);
    load_tile<T, F, kQRows, kThreads>(dout, base, row_stride, r0, P, dt);
    if (tid < kQRows) {
      lse_t[tid] = r0 + tid < P ? lse[row_off + r0 + tid] : 0.f;
      delta_t[tid] = r0 + tid < P ? delta[row_off + r0 + tid] : 0.f;
    }
    __syncthreads();

    float sacc[kCpt1], dpacc[kCpt1];
#pragma unroll
    for (int j = 0; j < kCpt1; ++j) sacc[j] = dpacc[j] = 0.f;
    const float* qrow = qt + r * (F + 1);
    const float* drow = dt + r * (F + 1);
#pragma unroll 8
    for (int d = 0; d < F; ++d) {
      const float qd = qrow[d], od = drow[d];
#pragma unroll
      for (int j = 0; j < kCpt1; ++j) {
        const int c = kg + j * kGroups1;
        sacc[j] = fmaf(qd, ks[c * F + d], sacc[j]);
        dpacc[j] = fmaf(od, vs[c * F + d], dpacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kCpt1; ++j) {
      const int c = kg + j * kGroups1;
      float p = 0.f, ds = 0.f;
      if (r0 + r < P && c0 + c < P) {
        const long e = long(r0 + r) * P + c0 + c;
        if (adj_b[e]) {
          const float vv = val_b ? val_b[e] : 1.f;
          p = expf((val_b ? sacc[j] * vv : sacc[j]) - lse_t[r]);
          ds = p * (dpacc[j] - delta_t[r]);
          if (val_b) ds *= vv;
        }
      }
      pt[r * kPS + c] = round_to<T>(p);
      dst[r * kPS + c] = round_to<T>(ds);
    }
    __syncthreads();

    const int nr = min(kQRows, P - r0);
    for (int rr = 0; rr < nr; ++rr) {
      const float qd = qt[rr * (F + 1) + d3], od = dt[rr * (F + 1) + d3];
#pragma unroll
      for (int j = 0; j < kCpt3; ++j) {
        const int c = cg + j * kGroups3;
        if (c < kKeys) {
          dk_acc[j] = fmaf(dst[rr * kPS + c], qd, dk_acc[j]);
          dv_acc[j] = fmaf(pt[rr * kPS + c], od, dv_acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kCpt3; ++j) {
    const int c = cg + j * kGroups3;
    if (c < kKeys && c0 + c < P) {
      dk[base + (c0 + c) * row_stride + d3] = from_f32<T>(dk_acc[j]);
      dv[base + (c0 + c) * row_stride + d3] = from_f32<T>(dv_acc[j]);
    }
  }
}

template <typename T, int F>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* adj,
                   const float* val, const float* lse, const float* delta, const void* dout,
                   void* dq, void* dk, void* dv, int B, int P, int H, cudaStream_t stream) {
  static_assert(kThreads % F == 0, "a feature column per thread needs F | kThreads");
  static_assert(kRows % (kThreads / kCols) == 0 && kKeys % (kThreads / kQRows) == 0,
                "score rows and keys split evenly over the thread groups");
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  const size_t smem_a = rows_smem_bytes<F>(P);
  cudaError_t err = cudaFuncSetAttribute(flash_mask_bwd_rows<T, F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_a));
  if (err != cudaSuccess) return err;
  const long blocks_a = long(B) * H * ((P + kRows - 1) / kRows);
  const long blocks_b = long(B) * H * ((P + kKeys - 1) / kKeys);
  if (blocks_a > 0x7fffffffL || blocks_b > 0x7fffffffL) return cudaErrorInvalidValue;
  flash_mask_bwd_rows<T, F><<<unsigned(blocks_a), kThreads, smem_a, stream>>>(
      qt, kt, vt, adj, val, lse, delta, dot, static_cast<T*>(dq), B, P, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_b = cols_smem_bytes<F>();
  err = cudaFuncSetAttribute(flash_mask_bwd_cols<T, F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_b));
  if (err != cudaSuccess) return err;
  flash_mask_bwd_cols<T, F><<<unsigned(blocks_b), kThreads, smem_b, stream>>>(
      qt, kt, vt, adj, val, lse, delta, dot, static_cast<T*>(dk), static_cast<T*>(dv), B, P, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_f(const void* q, const void* k, const void* v, const uint8_t* adj,
                       const float* val, const float* lse, const float* delta, const void* dout,
                       void* dq, void* dk, void* dv, int B, int P, int H, int F,
                       cudaStream_t stream) {
  switch (F) {
#define DFGNN_BWD_CASE(FF) \
    case FF: return launch<T, FF>(q, k, v, adj, val, lse, delta, dout, dq, dk, dv, B, P, H, stream);
    DFGNN_BWD_CASE(8)
    DFGNN_BWD_CASE(16)
    DFGNN_BWD_CASE(32)
    DFGNN_BWD_CASE(64)
    DFGNN_BWD_CASE(128)
    DFGNN_BWD_CASE(256)
#undef DFGNN_BWD_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16.  q, k, v, dout, dq, dk, dv: [B, P, H, F]
// contiguous; adj: [B, P, P] uint8; val: [B, P, P] fp32 or null; lse, delta:
// [H, B, P] fp32.  Launches two kernels on `stream`, allocates nothing, and
// returns the first CUDA error (0 when both launched).
int dfgnn_flash_mask_bwd(int dtype, const void* q, const void* k, const void* v,
                         const void* adj, const void* val, const void* lse, const void* delta,
                         const void* dout, void* dq, void* dk, void* dv, int B, int P, int H,
                         int F, void* stream) {
  if (B < 1 || H < 1 || P < 1 || P > kMaxP) return int(cudaErrorInvalidValue);
  const auto* a = static_cast<const uint8_t*>(adj);
  const auto* ev = static_cast<const float*>(val);
  const auto* l = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(dispatch_f<float>(q, k, v, a, ev, l, dl, dout, dq, dk, dv, B, P, H, F, s));
  if (dtype == 1)
    return int(dispatch_f<__nv_bfloat16>(q, k, v, a, ev, l, dl, dout, dq, dk, dv, B, P, H, F, s));
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
