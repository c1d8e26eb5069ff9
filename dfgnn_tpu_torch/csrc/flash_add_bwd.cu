// Masked dense graph-attention backward with the additive (GAT) score, for
// Hopper (sm_90a), hand-written CUDA.
//
// Replaces dfgnn_tpu/ops/pallas/flash_mask.py::_bwd_kernel_add (:286), driven
// there by _bwd (:317).  For every graph b and head h of a DenseBatch, from
// e_row, e_col [B, P, h], v and dO [B, P, h, f], adj, optional val, the
// forward's lse [h, B, P] and delta = rowsum(dO * out) [h, B, P] (fp32,
// computed by the wrapper from the dropped output, as _bwd computes it
// outside its kernel):
//   pre  = e_row[r] + e_col[c],  s = leaky_relu(pre), times val[b]
//   p    = adj[b] ? exp(s - lse) : 0      empty rows (lse = -1e30) give p = 0
//   dp   = (dO . v^T) * keep              keep: the forward's dropout factor
//   ds   = p * (dp - delta), times val[b] (val is a constant: no d val)
//   dpre = pre >= 0 ? ds : slope * ds     leaky' on the pre-val sum
//   d e_row[r] = sum_c dpre     d e_col[c] = sum_r dpre
//   dv   = round_to<T>(p * keep)^T . dO
// e_row, e_col and the sums d e_row, d e_col are fp32 whatever v's type, as
// the Pallas kernel reads the scalars; v, dO and dv are fp32 or bf16.  fp32
// arithmetic.
//
// What bounds it on an H100 SXM (data-sheet peaks): the function needs two
// products, dO . v^T and p^T . dO, only on the edges: 4*f operations per
// edge and head.  At the serving shape (B=1024, h=1, P=128, f=128, fp32)
// with a fifth of the block entries edges, as chip_smoke.py's inputs have,
// that is 1.8 GFLOP, 0.027 ms at 67 TFLOP/s, against 287 MB of
// e_row, e_col, v, adj, lse, dO, out (for delta) read and d e_row, d e_col,
// dv written, 0.086 ms at 3.35 TB/s: device memory bounds the function.
// This kernel computes every entry of the dense [P, P] blocks as fp32 FMAs
// fed from shared memory, as flash_mask_bwd.cu does.
//
// Design.  Blocks run in no order, so a sum over one axis cannot be carried
// from block to block.  Two launches, deterministic, without atomics:
//   (a) flash_add_bwd_rows: a block per kRows query rows of one (graph,
//       head).  It keeps those dO rows, streams V tiles to rebuild dp and
//       turn it into dpre for its rows ([kRows, P] in shared memory), then
//       sums each row: d e_row.
//   (b) flash_add_bwd_cols: a block per kKeys key rows.  It keeps those V
//       rows, streams dO tiles of kQRows rows to rebuild dp, p and dpre for
//       its columns, sums dpre down each column (d e_col) and accumulates
//       dv = (p * keep)^T . dO in registers.
// dp is rebuilt in both passes, so they do 3 products where the bound
// counts 2.

#include "flash_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;    // (a): query rows of one (graph, head) per block
constexpr int kCols = 64;    // (a): value rows per streamed tile
constexpr int kKeys = 16;    // (b): key rows of one (graph, head) per block
constexpr int kQRows = 64;   // (b): dO rows per streamed tile
constexpr int kPS = kKeys + 1;  // (b): row stride of the p and dpre tiles (no bank conflicts)
constexpr int kMaxP = 2048;  // (a)'s [kRows, P] rows must fit shared memory

template <int F>
size_t rows_smem_bytes(int P) {
  return sizeof(float) * (size_t(kRows) * F + size_t(kCols) * (F + 1) + size_t(kRows) * P + P +
                          3 * kRows);
}

template <int F>
size_t cols_smem_bytes() {
  return sizeof(float) * (kKeys * F + kQRows * (F + 1) + 2 * kQRows * kPS + 3 * kQRows + kKeys);
}

// dpre of one entry, from its dp (the sum dO[r] . v[c]); 0 off the edges.
__device__ __forceinline__ float entry_dpre(float dp, float pre, float lse, float delta,
                                            float vv, bool has_val, float slope, float keep,
                                            float* p_keep) {
  const float s = has_val ? leaky(pre, slope) * vv : leaky(pre, slope);
  const float p = expf(s - lse);
  *p_keep = p * keep;
  float ds = p * (dp * keep - delta);
  if (has_val) ds *= vv;
  return pre >= 0.f ? ds : ds * slope;
}

// (a) d e_row.  Thread -> one column of the V tile and kRows / kGroups rows,
// so a warp reads 32 neighbouring V rows and one broadcast dO row.
template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
flash_add_bwd_rows(const float* __restrict__ e_row, const float* __restrict__ e_col,
                   const T* __restrict__ v, const uint8_t* __restrict__ adj,
                   const float* __restrict__ val, const float* __restrict__ lse,
                   const float* __restrict__ delta, const T* __restrict__ dout,
                   float* __restrict__ der, int B, int P, int H, float slope, Dropout drop) {
  extern __shared__ float smem[];
  float* rows = smem;                  // [kRows][F]: dO rows
  float* tile = rows + kRows * F;      // [kCols][F + 1]: V tiles
  float* ss = tile + kCols * (F + 1);  // [kRows][P]: dpre
  float* ecs = ss + kRows * P;         // [P]
  float* ers = ecs + P;                // [kRows]
  float* lse_s = ers + kRows;          // [kRows]
  float* delta_s = lse_s + kRows;      // [kRows]

  const int n_row_blocks = (P + kRows - 1) / kRows;
  const int rb = blockIdx.x % n_row_blocks;
  const int hh = (blockIdx.x / n_row_blocks) % H;
  const int b = blockIdx.x / (n_row_blocks * H);
  const int r0 = rb * kRows;
  const int tid = threadIdx.x;
  const long row_stride = long(H) * F;
  const long base = (long(b) * P * H + hh) * F;
  const long sbase = long(b) * P * H + hh;
  const uint8_t* adj_b = adj + long(b) * P * P;
  const float* val_b = val ? val + long(b) * P * P : nullptr;
  const long row_off = (long(hh) * B + b) * P;  // element (hh, b, 0) of [H, B, P]

  for (int i = tid; i < kRows * F; i += kThreads) {
    const int r = i / F, d = i - r * F;
    rows[i] = r0 + r < P ? to_f32(dout[base + (r0 + r) * row_stride + d]) : 0.f;
  }
  for (int c = tid; c < P; c += kThreads) ecs[c] = e_col[sbase + long(c) * H];
  if (tid < kRows) {
    const bool live = r0 + tid < P;
    ers[tid] = live ? e_row[sbase + long(r0 + tid) * H] : 0.f;
    lse_s[tid] = live ? lse[row_off + r0 + tid] : 0.f;
    delta_s[tid] = live ? delta[row_off + r0 + tid] : 0.f;
  }

  constexpr int kGroups = kThreads / kCols;
  constexpr int kRpt = kRows / kGroups;
  const int col_in_tile = tid % kCols;
  const int rg = tid / kCols;
  for (int c0 = 0; c0 < P; c0 += kCols) {
    __syncthreads();  // dO, the scalars are loaded and the previous tile is consumed
    load_tile<T, F, kCols, kThreads>(v, base, row_stride, c0, P, tile);
    __syncthreads();
    float acc[kRpt];
#pragma unroll
    for (int i = 0; i < kRpt; ++i) acc[i] = 0.f;
    const float* vrow = tile + col_in_tile * (F + 1);
#pragma unroll 16
    for (int d = 0; d < F; ++d) {
      const float vd = vrow[d];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) acc[i] = fmaf(rows[(rg + i * kGroups) * F + d], vd, acc[i]);
    }
    const int col = c0 + col_in_tile;
    if (col < P) {
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        const int r = rg + i * kGroups;
        float dpre = 0.f;
        if (r0 + r < P) {
          const long e = long(r0 + r) * P + col;
          if (adj_b[e]) {
            const float keep = drop.on ? drop.factor(b, P, r0 + r, col, hh) : 1.f;
            float unused;
            dpre = entry_dpre(acc[i], ers[r] + ecs[col], lse_s[r], delta_s[r],
                              val_b ? val_b[e] : 1.f, val_b != nullptr, slope, keep, &unused);
          }
        }
        ss[r * P + col] = dpre;
      }
    }
  }
  __syncthreads();

  // d e_row: one warp per row, lane-strided sums then a butterfly, so the
  // order is fixed.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float acc = 0.f;
    for (int c = lane; c < P; c += 32) acc += ss[r * P + c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0 && r0 + r < P) der[sbase + long(r0 + r) * H] = acc;
  }
}

// (b) d e_col and dv.
template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
flash_add_bwd_cols(const float* __restrict__ e_row, const float* __restrict__ e_col,
                   const T* __restrict__ v, const uint8_t* __restrict__ adj,
                   const float* __restrict__ val, const float* __restrict__ lse,
                   const float* __restrict__ delta, const T* __restrict__ dout,
                   float* __restrict__ dec, T* __restrict__ dv, int B, int P, int H, float slope,
                   Dropout drop) {
  extern __shared__ float smem[];
  float* vs = smem;                       // [kKeys][F]: this block's V rows
  float* dt = vs + kKeys * F;             // [kQRows][F + 1]: a dO tile
  float* pt = dt + kQRows * (F + 1);      // [kQRows][kPS]: p * keep, rounded to T
  float* dpt = pt + kQRows * kPS;         // [kQRows][kPS]: dpre
  float* er_t = dpt + kQRows * kPS;       // [kQRows]
  float* lse_t = er_t + kQRows;           // [kQRows]
  float* delta_t = lse_t + kQRows;        // [kQRows]
  float* ecs = delta_t + kQRows;          // [kKeys]

  const int n_col_blocks = (P + kKeys - 1) / kKeys;
  const int cb = blockIdx.x % n_col_blocks;
  const int hh = (blockIdx.x / n_col_blocks) % H;
  const int b = blockIdx.x / (n_col_blocks * H);
  const int c0 = cb * kKeys;
  const int tid = threadIdx.x;
  const long row_stride = long(H) * F;
  const long base = (long(b) * P * H + hh) * F;
  const long sbase = long(b) * P * H + hh;
  const uint8_t* adj_b = adj + long(b) * P * P;
  const float* val_b = val ? val + long(b) * P * P : nullptr;
  const long row_off = (long(hh) * B + b) * P;

  for (int i = tid; i < kKeys * F; i += kThreads) {
    const int c = i / F, d = i - c * F;
    vs[i] = c0 + c < P ? to_f32(v[base + (c0 + c) * row_stride + d]) : 0.f;
  }
  if (tid < kKeys) ecs[tid] = c0 + tid < P ? e_col[sbase + long(c0 + tid) * H] : 0.f;

  // dp: thread -> one dO row r of the tile and every kGroups1-th key, so a
  // warp reads 32 neighbouring dO rows and one broadcast V row.
  constexpr int kGroups1 = kThreads / kQRows;
  constexpr int kCpt1 = kKeys / kGroups1;
  const int r = tid % kQRows;
  const int kg = tid / kQRows;
  // dv: thread -> one feature column d and every kGroups3-th key.
  constexpr int kGroups3 = kThreads / F;
  constexpr int kCpt3 = (kKeys + kGroups3 - 1) / kGroups3;
  const int d3 = tid % F;
  const int cg = tid / F;
  float dv_acc[kCpt3];
#pragma unroll
  for (int j = 0; j < kCpt3; ++j) dv_acc[j] = 0.f;
  float dec_acc = 0.f;  // thread tid < kKeys: d e_col of key c0 + tid

  for (int r0 = 0; r0 < P; r0 += kQRows) {
    __syncthreads();  // V, e_col are loaded and the previous tile is consumed
    load_tile<T, F, kQRows, kThreads>(dout, base, row_stride, r0, P, dt);
    if (tid < kQRows) {
      const bool live = r0 + tid < P;
      er_t[tid] = live ? e_row[sbase + long(r0 + tid) * H] : 0.f;
      lse_t[tid] = live ? lse[row_off + r0 + tid] : 0.f;
      delta_t[tid] = live ? delta[row_off + r0 + tid] : 0.f;
    }
    __syncthreads();

    float dpacc[kCpt1];
#pragma unroll
    for (int j = 0; j < kCpt1; ++j) dpacc[j] = 0.f;
    const float* drow = dt + r * (F + 1);
#pragma unroll 8
    for (int d = 0; d < F; ++d) {
      const float od = drow[d];
#pragma unroll
      for (int j = 0; j < kCpt1; ++j) dpacc[j] = fmaf(od, vs[(kg + j * kGroups1) * F + d], dpacc[j]);
    }
#pragma unroll
    for (int j = 0; j < kCpt1; ++j) {
      const int c = kg + j * kGroups1;
      float pk = 0.f, dpre = 0.f;
      if (r0 + r < P && c0 + c < P) {
        const long e = long(r0 + r) * P + c0 + c;
        if (adj_b[e]) {
          const float keep = drop.on ? drop.factor(b, P, r0 + r, c0 + c, hh) : 1.f;
          dpre = entry_dpre(dpacc[j], er_t[r] + ecs[c], lse_t[r], delta_t[r],
                            val_b ? val_b[e] : 1.f, val_b != nullptr, slope, keep, &pk);
        }
      }
      pt[r * kPS + c] = round_to<T>(pk);
      dpt[r * kPS + c] = dpre;
    }
    __syncthreads();

    const int nr = min(kQRows, P - r0);
    for (int rr = 0; rr < nr; ++rr) {
      const float od = dt[rr * (F + 1) + d3];
#pragma unroll
      for (int j = 0; j < kCpt3; ++j) {
        const int c = cg + j * kGroups3;
        if (c < kKeys) dv_acc[j] = fmaf(pt[rr * kPS + c], od, dv_acc[j]);
      }
    }
    if (tid < kKeys)
      for (int rr = 0; rr < nr; ++rr) dec_acc += dpt[rr * kPS + tid];
  }
#pragma unroll
  for (int j = 0; j < kCpt3; ++j) {
    const int c = cg + j * kGroups3;
    if (c < kKeys && c0 + c < P) dv[base + (c0 + c) * row_stride + d3] = from_f32<T>(dv_acc[j]);
  }
  if (tid < kKeys && c0 + tid < P) dec[sbase + long(c0 + tid) * H] = dec_acc;
}

template <typename T, int F>
cudaError_t launch(const void* e_row, const void* e_col, const void* v, const uint8_t* adj,
                   const float* val, const float* lse, const float* delta, const void* dout,
                   void* der, void* dec, void* dv, int B, int P, int H, float slope, Dropout drop,
                   cudaStream_t stream) {
  static_assert(kThreads % F == 0, "a feature column per thread needs F | kThreads");
  static_assert(kRows % (kThreads / kCols) == 0 && kKeys % (kThreads / kQRows) == 0,
                "rows and keys split evenly over the thread groups");
  const float* er = static_cast<const float*>(e_row);
  const float* ec = static_cast<const float*>(e_col);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  const size_t smem_a = rows_smem_bytes<F>(P);
  cudaError_t err = cudaFuncSetAttribute(flash_add_bwd_rows<T, F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_a));
  if (err != cudaSuccess) return err;
  const long blocks_a = long(B) * H * ((P + kRows - 1) / kRows);
  const long blocks_b = long(B) * H * ((P + kKeys - 1) / kKeys);
  if (blocks_a > 0x7fffffffL || blocks_b > 0x7fffffffL) return cudaErrorInvalidValue;
  flash_add_bwd_rows<T, F><<<unsigned(blocks_a), kThreads, smem_a, stream>>>(
      er, ec, vt, adj, val, lse, delta, dot, static_cast<float*>(der), B, P, H, slope, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_b = cols_smem_bytes<F>();
  err = cudaFuncSetAttribute(flash_add_bwd_cols<T, F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_b));
  if (err != cudaSuccess) return err;
  flash_add_bwd_cols<T, F><<<unsigned(blocks_b), kThreads, smem_b, stream>>>(
      er, ec, vt, adj, val, lse, delta, dot, static_cast<float*>(dec), static_cast<T*>(dv), B, P, H,
      slope, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_f(const void* e_row, const void* e_col, const void* v, const uint8_t* adj,
                       const float* val, const float* lse, const float* delta, const void* dout,
                       void* der, void* dec, void* dv, int B, int P, int H, int F, float slope,
                       Dropout drop, cudaStream_t stream) {
  switch (F) {
#define DFGNN_ADD_BWD_CASE(FF)                                                                   \
    case FF: return launch<T, FF>(e_row, e_col, v, adj, val, lse, delta, dout, der, dec, dv, B, \
                                  P, H, slope, drop, stream);
    DFGNN_ADD_BWD_CASE(8)
    DFGNN_ADD_BWD_CASE(16)
    DFGNN_ADD_BWD_CASE(32)
    DFGNN_ADD_BWD_CASE(64)
    DFGNN_ADD_BWD_CASE(128)
    DFGNN_ADD_BWD_CASE(256)
#undef DFGNN_ADD_BWD_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype (of v, dout and dv): 0 = fp32, 1 = bf16.  e_row, e_col, der, dec:
// fp32 [B, P, H] contiguous; v, dout, dv: [B, P, H, F] contiguous; adj: [B, P, P] uint8; val: [B, P, P]
// fp32 or null; lse, delta: [H, B, P] fp32.  drop, seed, threshold and scale
// as dfgnn_flash_add_fwd's.  Launches two kernels on `stream`, allocates
// nothing, and returns the first CUDA error (0 when both launched).
int dfgnn_flash_add_bwd(int dtype, const void* e_row, const void* e_col, const void* v,
                        const void* adj, const void* val, const void* lse, const void* delta,
                        const void* dout, void* der, void* dec, void* dv, int B, int P, int H,
                        int F, float slope, int drop, unsigned seed, unsigned threshold,
                        float scale, void* stream) {
  if (B < 1 || H < 1 || P < 1 || P > kMaxP) return int(cudaErrorInvalidValue);
  const auto* a = static_cast<const uint8_t*>(adj);
  const auto* ev = static_cast<const float*>(val);
  const auto* l = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  auto s = static_cast<cudaStream_t>(stream);
  const Dropout dr{drop != 0, seed, threshold, scale};
  if (dtype == 0)
    return int(dispatch_f<float>(e_row, e_col, v, a, ev, l, dl, dout, der, dec, dv, B, P, H, F,
                                 slope, dr, s));
  if (dtype == 1)
    return int(dispatch_f<__nv_bfloat16>(e_row, e_col, v, a, ev, l, dl, dout, der, dec, dv, B,
                                         P, H, F, slope, dr, s));
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
