// Masked dense graph-attention forward for Hopper (sm_90a), hand-written CUDA
// on the tensor cores.
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
// from 1 to 256: the staged tiles are zero past f up to the instantiated
// width FI (32, 64, 128 or 256), which adds only 0 * 0 terms, and only f
// columns are stored.  fp32 or bf16 inputs; fp32 softmax and sums.
//
// What bounds it on an H100 SXM (data-sheet peaks): the function needs its
// two products only on the edges.  At the table's shape (B=1024, h=1, P=128,
// f=128, fp32) the bytes of q, k, v, adj read and out, lse written take
// 0.085 ms at 3.35 TB/s, and the dense [P, P] blocks' 2 products of 4.3
// GFLOP take 0.05 ms as 3xTF32 on the tensor cores (a third of 495
// TFLOP/s): device memory bounds it, if the products run on the tensor cores
// and the padding is skipped.
//
// Design (the tile helpers are in flash_mma.cuh, which says why mma.sync):
// - Products on the tensor cores: mma.sync m16n8k8 with each fp32 operand
//   split in two TF32 parts (3xTF32: rtol 1e-4 holds against fp32), bf16
//   m16n8k16, both with fp32 accumulators.  A warp owns 16 query rows.
// - Padding skipped, exactly: the block first scans its adj rows once
//   (scan_adj) and marks each 16-key group that has an edge, per warp.  A
//   block with no edge writes out = 0, lse = -1e30 and exits; a key tile no
//   warp needs is neither loaded nor computed; a warp skips the 8-key
//   n-tiles (for q.k^T) and k-steps (for ex.v) of its dead groups.  p is 0
//   exactly off the edges, so nothing changes.
// - Two shapes of block, chosen on the host:
//   * whole (P <= 128, FI <= 128, the main path): 4 warps take 64 rows, and
//     one 128-key tile covers every key, so m is the exact row max and ex is
//     rounded relative to it, as in JAX.  Q and K load as one cp.async group;
//     once the warps have their scores, V overwrites K in the same buffer,
//     and ex the warp's own Q rows.  Shared memory in fp32 at FI = 128: Q/ex
//     33.8 KB, K/V 69.6 KB (104 KB: two blocks an SM, so one block's loads
//     overlap the other's products).  Against 8 warps over 128 rows with K
//     and V apart (205 KB, one block an SM) it ran faster on molhiv-like
//     padded blocks and slightly slower on dense ones.
//   * stream (P > 128, or FI = 256): 4 warps take 64 rows and walk key tiles
//     of 64 (32 at FI = 256) through a two-stage cp.async ring, with an
//     online softmax: m is the running max, l and the output are rescaled by
//     exp(m_old - m_new) when it grows.  In fp32 that changes only the order
//     of rounding (fp32 ulps); in bf16, ex is rounded to bf16 relative to
//     the running max and rescaled in fp32, which differs from JAX's
//     rounding relative to the final max by at most a bf16 step of ex (the
//     bf16 bar absorbs it).  fp32 at FI = 128: 189 KB; at FI = 256: 211 KB.
// - The supported set: P <= 2048, f <= 256.

#include "flash_mma.cuh"

namespace {

constexpr int kMaxP = 2048;

template <typename T, int FI, int WARPS, int KT, bool WHOLE>
struct FwdCfg {
  static constexpr int kThreads = WARPS * 32;
  static constexpr int kRows = WARPS * 16;  // query rows per block
  static constexpr int kStages = WHOLE ? 1 : 2;
  static constexpr int kMaxTiles = WHOLE ? 1 : kMaxP / KT;
  // Q rows (and, whole, ex over them); ex rows (stream); K; V: row strides
  static constexpr int ldq = (WHOLE && KT > FI ? KT : FI) + pad_rm<T>();
  static constexpr int ldp = WHOLE ? ldq : KT + pad_rm<T>();
  static constexpr int ldk = FI + pad_rm<T>();
  static constexpr int ldv = FI + 8;
  static constexpr size_t q_elems = size_t(kRows) * ldq;
  static constexpr size_t p_elems = WHOLE ? 0 : size_t(kRows) * ldp;
  // whole: V replaces K in one buffer once the scores are formed
  static constexpr size_t k_elems = size_t(kStages) * KT * (WHOLE ? ldv : ldk);
  static constexpr size_t v_elems = WHOLE ? 0 : size_t(kStages) * KT * ldv;
  // whole: adj's edge bits of the block's rows, 16 keys a word
  static constexpr int kBitWords = WHOLE ? kRows * (KT / kGroup) : 0;
  static constexpr size_t bytes =
      sizeof(T) * (q_elems + p_elems + k_elems + v_elems) +
      sizeof(uint32_t) * (size_t(WARPS) * kMaxTiles + kMaxTiles + WARPS) +
      sizeof(uint16_t) * kBitWords;
};

template <typename T, int FI, int WARPS, int KT, bool WHOLE>
__global__ void __launch_bounds__(WARPS * 32)
flash_mask_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const uint8_t* __restrict__ adj, const float* __restrict__ val,
                      T* __restrict__ out, float* __restrict__ lse, int B, int P, int H, int f,
                      int vec, Dropout drop) {
  using C = FwdCfg<T, FI, WARPS, KT, WHOLE>;
  constexpr int NTS = KT / 8;  // n-tiles of a score tile
  constexpr int NTO = FI / 8;  // n-tiles of the output rows
  constexpr int KS = kstep<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ps = WHOLE ? qs : qs + C::q_elems;
  T* ks = qs + C::q_elems + C::p_elems;
  T* vs = WHOLE ? ks : ks + C::k_elems;
  uint32_t* flags = reinterpret_cast<uint32_t*>(ks + C::k_elems + C::v_elems);  // [WARPS][n_tiles]
  uint32_t* tmask = flags + WARPS * C::kMaxTiles;                    // [n_tiles]
  uint32_t* wlive = tmask + C::kMaxTiles;                            // [WARPS]
  uint16_t* rbits = reinterpret_cast<uint16_t*>(wlive + WARPS);       // whole: [rows][groups]

  const int n_row_blocks = (P + C::kRows - 1) / C::kRows;
  const int rb = blockIdx.x % n_row_blocks;
  const int hh = (blockIdx.x / n_row_blocks) % H;
  const int b = blockIdx.x / (n_row_blocks * H);
  const int r0 = rb * C::kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long row_stride = long(H) * f;
  const long base = (long(b) * P * H + hh) * f;
  const uint8_t* adj_b = adj + long(b) * P * P;
  const float* val_b = val ? val + long(b) * P * P : nullptr;
  const int n_tiles = (P + KT - 1) / KT;
  const int n_groups = (P + kGroup - 1) / kGroup;

  for (int i = tid; i < WARPS * n_tiles; i += C::kThreads) flags[i] = 0u;
  for (int i = tid; i < C::kBitWords; i += C::kThreads) rbits[i] = 0;
  __syncthreads();
  scan_adj(adj_b, P, r0, C::kRows, 0, n_groups, tid, C::kThreads, flags,
           [&](int r, int gk, int& w, uint32_t& bit) {
             w = ((r - r0) / 16) * n_tiles + gk * kGroup / KT;
             bit = 1u << (gk % (KT / kGroup));
           },
           [&](int r, int gk, uint32_t bits) {
             if (WHOLE) rbits[(r - r0) * n_groups + gk] = uint16_t(bits);
           });
  __syncthreads();
  bool any = false;
  for (int j = tid; j < n_tiles; j += C::kThreads) {
    uint32_t m = 0;
    for (int w = 0; w < WARPS; ++w) m |= flags[w * n_tiles + j];
    tmask[j] = m;
    any |= m != 0u;
  }
  if (tid < WARPS) {
    uint32_t m = 0;
    for (int j = 0; j < n_tiles; ++j) m |= flags[tid * n_tiles + j];
    wlive[tid] = m != 0u;
  }
  if (!__syncthreads_or(any)) {  // no edge in the block's rows: out = 0, lse = -1e30
    for (int i = tid; i < C::kRows * f; i += C::kThreads) {
      const int r = r0 + i / f;
      if (r < P) out[base + long(r) * row_stride + i % f] = from_f32<T>(0.f);
    }
    if (lse != nullptr)
      for (int r = r0 + tid; r < min(P, r0 + C::kRows); r += C::kThreads)
        lse[(long(hh) * B + b) * P + r] = kNegBig;
    return;
  }

  uint32_t qlive = 0;
  for (int w = 0; w < WARPS; ++w) qlive |= wlive[w] << w;
  auto next_live = [&](int j) {
    while (j < n_tiles && tmask[j] == 0u) ++j;
    return j;
  };
  auto stage_kv = [&](int j, int st, bool with_v) {
    stage_rows<T, FI>(k, base, row_stride, j * KT, KT, P, f, vec, tmask[j],
                      ks + size_t(st) * KT * C::ldk, C::ldk, tid, C::kThreads);
    if (with_v)
      stage_rows<T, FI>(v, base, row_stride, j * KT, KT, P, f, vec, tmask[j],
                        vs + size_t(st) * KT * C::ldv, C::ldv, tid, C::kThreads);
  };

  const bool live_w = wlive[warp] != 0u;
  const int row_w = r0 + warp * 16;  // the warp's first query row
  const int kf = (f + KS - 1) / KS * KS;  // depth of q . k^T past which q, k are 0
  const uint32_t fmask = (NTO >= 32 ? 0xffffffffu : (1u << NTO) - 1u) &
                         ((f + 7) / 8 >= 32 ? 0xffffffffu : (1u << ((f + 7) / 8)) - 1u);
  float o[NTO][4];
  zero_acc(o);
  float m_run[2] = {kDead, kDead}, l_run[2] = {0.f, 0.f};

  // Q (the live warps' rows) and the first live key tile
  stage_rows<T, FI>(q, base, row_stride, r0, C::kRows, P, f, vec, qlive, qs, C::ldq, tid,
                    C::kThreads);
  int j = next_live(0);
  stage_kv(j, 0, !WHOLE);
  cp_async_commit();
  int st = 0;
  while (j < n_tiles) {
    const int jn = WHOLE ? n_tiles : next_live(j + 1);
    if (!WHOLE) {
      if (jn < n_tiles) stage_kv(jn, st ^ 1, true);
      cp_async_commit();
    }
    if (WHOLE)
      cp_async_wait<0>();  // Q and K have landed
    else
      cp_async_wait<1>();  // Q and this tile's K and V have landed
    __syncthreads();
    const uint32_t gm = live_w ? flags[warp * n_tiles + j] : 0u;
    const T* kt = ks + size_t(st) * KT * C::ldk;
    const T* vt = vs + size_t(st) * KT * C::ldv;
    T* qw = qs + size_t(warp) * 16 * C::ldq;
    T* pw = ps + size_t(warp) * 16 * C::ldp;
    if (gm != 0u) {
      float s[NTS][4];
      zero_acc(s);
      const uint32_t nm = ntile_mask(gm);
      for (int k0 = 0; k0 < kf; k0 += KS)
        mma_step<NTS, false, true>(s, qw, C::ldq, kt, C::ldk, k0, 0, nm);
      // mask, scale by val, running max of rows g and g + 8
      float mx[2] = {kNegBig, kNegBig};
#pragma unroll
      for (int jj = 0; jj < NTS; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = g + (e >> 1) * 8, row = row_w + rr;
          const int key = j * KT + jj * 8 + 2 * t + (e & 1);
          float sv = kNegBig;
          if (((nm >> jj) & 1u) && row < P && key < P) {
            const long ei = long(row) * P + key;
            const bool edge = WHOLE ? (rbits[(row - r0) * n_groups + key / kGroup] >>
                                       (key % kGroup)) & 1u
                                    : adj_b[ei] != 0;
            if (edge) sv = val_b ? s[jj][e] * val_b[ei] : s[jj][e];
          }
          s[jj][e] = sv;
          mx[e >> 1] = fmaxf(mx[e >> 1], sv);
        }
      }
      float scale[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
        const float m_new = fmaxf(m_run[h2], mx[h2]);
        scale[h2] = expf(m_run[h2] - m_new);
        m_run[h2] = m_new;
        l_run[h2] *= scale[h2];
      }
#pragma unroll
      for (int jj = 0; jj < NTO; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[jj][e] *= scale[e >> 1];
      __syncwarp();  // whole: every lane is done reading the warp's Q rows
#pragma unroll
      for (int jj = 0; jj < NTS; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = g + (e >> 1) * 8;
          const int kc = jj * 8 + 2 * t + (e & 1);
          float ex = expf(s[jj][e] - m_run[e >> 1]);
          l_run[e >> 1] += ex;
          if (drop.on && ex != 0.f) ex *= drop.factor(b, P, row_w + rr, j * KT + kc, hh);
          pw[rr * C::ldp + kc] = from_f32<T>(ex);  // rounded to v's type, as in JAX
        }
      }
    }
    if (WHOLE) {  // V over K, once every warp has its scores
      __syncthreads();
      stage_rows<T, FI>(v, base, row_stride, 0, KT, P, f, vec, tmask[j], vs, C::ldv, tid,
                        C::kThreads);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    } else {
      __syncwarp();
    }
    if (gm != 0u) {
#pragma unroll 1
      for (int gi = 0; gi < KT / kGroup; ++gi) {
        if (!((gm >> gi) & 1u)) continue;
#pragma unroll
        for (int k0 = gi * kGroup; k0 < (gi + 1) * kGroup; k0 += KS)
          mma_step<NTO, false, false>(o, pw, C::ldp, vt, C::ldv, k0, 0, fmask);
      }
    }
    __syncthreads();  // this stage's K, V and the ex tiles are free again
    j = jn;
    st ^= 1;
  }

  // rows g and g + 8 of the warp: l summed over the quad; out staged in the
  // warp's Q rows (free once the last tile is done) and stored coalesced
  T* qw = qs + size_t(warp) * 16 * C::ldq;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l_run[h2] += __shfl_xor_sync(0xffffffffu, l_run[h2], 1);
    l_run[h2] += __shfl_xor_sync(0xffffffffu, l_run[h2], 2);
    const int rr = g + 8 * h2, row = row_w + rr;
    const float l = l_run[h2];
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int jj = 0; jj < NTO; ++jj) {
      const int c = jj * 8 + 2 * t;
      qw[rr * C::ldq + c] = from_f32<T>(o[jj][2 * h2] * inv);
      qw[rr * C::ldq + c + 1] = from_f32<T>(o[jj][2 * h2 + 1] * inv);
    }
    if (lse != nullptr && t == 0 && row < P)
      lse[(long(hh) * B + b) * P + row] = l > 0.f ? m_run[h2] + logf(l) : kNegBig;
  }
  __syncwarp();
  store_tile<T>(qw, C::ldq, out, base, row_stride, row_w, 16, P, f, vec, lane, 32);
}

template <typename T, int FI, int WARPS, int KT, bool WHOLE>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* adj,
                   const float* val, void* out, float* lse, int B, int P, int H, int f,
                   Dropout drop, cudaStream_t stream) {
  using C = FwdCfg<T, FI, WARPS, KT, WHOLE>;
  static_assert(C::bytes <= 232448, "a block's shared memory must fit 227 KB");
  auto kernel = flash_mask_fwd_kernel<T, FI, WARPS, KT, WHOLE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::bytes));
  if (err != cudaSuccess) return err;
  const long n_blocks = long(B) * H * ((P + C::kRows - 1) / C::kRows);
  if (n_blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  const int vec = fill_bytes<T>(f);
  kernel<<<unsigned(n_blocks), C::kThreads, C::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), adj, val,
      static_cast<T*>(out), lse, B, P, H, f, vec, drop);
  return cudaGetLastError();
}

template <typename T, int FI>
cudaError_t launch_fi(const void* q, const void* k, const void* v, const uint8_t* adj,
                      const float* val, void* out, float* lse, int B, int P, int H, int f,
                      Dropout drop, cudaStream_t stream) {
  if constexpr (FI <= 128) {
    if (P <= 128)
      return launch<T, FI, 4, 128, true>(q, k, v, adj, val, out, lse, B, P, H, f, drop, stream);
  }
  constexpr int KT = FI == 256 ? 32 : 64;
  return launch<T, FI, 4, KT, false>(q, k, v, adj, val, out, lse, B, P, H, f, drop, stream);
}

template <typename T>
cudaError_t dispatch_f(const void* q, const void* k, const void* v, const uint8_t* adj,
                       const float* val, void* out, float* lse, int B, int P, int H, int f,
                       Dropout drop, cudaStream_t stream) {
  if (f <= 32) return launch_fi<T, 32>(q, k, v, adj, val, out, lse, B, P, H, f, drop, stream);
  if (f <= 64) return launch_fi<T, 64>(q, k, v, adj, val, out, lse, B, P, H, f, drop, stream);
  if (f <= 128) return launch_fi<T, 128>(q, k, v, adj, val, out, lse, B, P, H, f, drop, stream);
  return launch_fi<T, 256>(q, k, v, adj, val, out, lse, B, P, H, f, drop, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16.  q, k, v, out: [B, P, H, F] contiguous, 1 <= F
// <= 256; adj: [B, P, P] uint8; val: [B, P, P] fp32 or null; lse: [H, B, P]
// fp32 or null.  drop != 0 applies dropout with the hash's seed, its keep
// threshold and the fp32 scale 1 / (1 - rate).  Launches on `stream`,
// allocates nothing, and returns cudaGetLastError().
int dfgnn_flash_mask_fwd(int dtype, const void* q, const void* k, const void* v,
                         const void* adj, const void* val, void* out, void* lse, int B, int P,
                         int H, int F, int drop, uint32_t seed, uint32_t threshold, float scale,
                         void* stream) {
  if (B < 1 || H < 1 || P < 1 || P > kMaxP || F < 1 || F > 256) return int(cudaErrorInvalidValue);
  const auto* a = static_cast<const uint8_t*>(adj);
  const auto* ev = static_cast<const float*>(val);
  auto* l = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  const Dropout d{drop != 0, seed, threshold, scale};
  if (dtype == 0) return int(dispatch_f<float>(q, k, v, a, ev, out, l, B, P, H, F, d, s));
  if (dtype == 1)
    return int(dispatch_f<__nv_bfloat16>(q, k, v, a, ev, out, l, B, P, H, F, d, s));
  return int(cudaErrorInvalidValue);
}

const char* dfgnn_cuda_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
