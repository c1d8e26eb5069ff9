// Masked dense graph-attention backward with the additive (GAT) score, for
// Hopper (sm_90a), hand-written CUDA on the tensor cores: kernel #4.
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
// the Pallas kernel reads the scalars; v, dO and dv are fp32 or bf16, any f
// from 1 to 256 (tiles zero past f up to the instantiated width 32, 64, 128
// or 256), P <= 2048.  keep is regenerated from the seed with the hash of
// flash_common.cuh, bitwise the forward's.
//
// What bounds it on an H100 SXM (data-sheet peaks): the function needs two
// products, dO . v^T and p^T . dO, only on the edges: 4*f operations per
// edge and head.  At the table's shape (B=1024, h=1, P=128, f=128, fp32)
// with a fifth of the block entries edges, as chip_smoke.py's inputs have,
// that is 1.8 GFLOP, 0.011 ms as 3xTF32 on the tensor cores, against 287 MB
// of e_row, e_col, v, adj, lse, dO, out (for delta) read and d e_row,
// d e_col, dv written, 0.086 ms at 3.35 TB/s: device memory bounds it.
//
// Design (tile helpers and the reason for mma.sync in flash_mma.cuh).  The
// kernel this replaces ran two launches of fp32 FMAs over every entry of the
// dense [P, P] blocks and formed dp in both: 3 products where the function
// needs 2.  Here one launch does it with 2 products on the tensor cores,
// built on #3's whole block (flash_mask_bwd.cu): a block of 8 warps per
// (graph, head, 128 keys), warp w owning key group w (16 keys).
// - V of the block's live key groups stays resident (cp.async); dO streams
//   in 16-row tiles through a two-stage cp.async ring, only the row tiles
//   with an edge into the block's keys.
// - Per tile, warp w forms dp = dO . V_w^T (mma.sync) for its 16 keys, then
//   p, ds and dpre straight in the C-fragment layout from e_row of its two
//   fragment rows and e_col (shared memory), as #2's score policy forms
//   scores: there is no q . k^T product.  It writes p * keep, rounded to T,
//   to its own 16 columns of a [16, 128] tile, and accumulates dv of its
//   keys (pn^T . dO, mma.sync) and d e_col of its keys in registers.
// - d e_row of the tile's 16 rows: each warp's sum over its keys, summed
//   across the 8 warps in shared memory in a fixed order.  At P <= 128 one
//   block holds every key and writes d e_row; past it each of the P / 128
//   key blocks writes its partial sums and flash_add_bwd_rowsum adds them in
//   key-block order.  Deterministic, no atomics.
// - Padding skipped, exactly, from adj itself (scan_adj): a row tile with no
//   edge into the block's keys is neither loaded nor computed, a key group
//   with no edge in a tile is skipped by its warp, and keys without an edge
//   get dv = 0, d e_col = 0; a block without an edge writes zeros.
// Shared memory at f = 128 in fp32: V 67.6 KB, the dO ring 16.9 KB, the pn
// tile 8.4 KB, adj's edge bits 16 B a row (2 KB at P = 128): 97 KB, two
// blocks an SM; at f = 256, P = 2048: 208 KB.

#include "flash_mma.cuh"

namespace {

constexpr int kMaxP = 2048;
constexpr int kWarps = 8, kThreads = 256, kKeys = 128, kRT = 16;
constexpr int kKeyGroups = kKeys / kGroup;  // 8: one a warp

template <typename T, int FI>
struct BwdCfg {
  static constexpr int ld = FI + pad_rm<T>();      // V and dO rows
  static constexpr int ldd = kKeys + pad_rm<T>();  // pn rows
  static constexpr size_t v_elems = size_t(kKeys) * ld;
  static constexpr size_t ring_elems = size_t(2) * kRT * ld;
  static constexpr size_t pn_elems = size_t(kRT) * ldd;
  static constexpr int kMaxRowTiles = kMaxP / kRT;
  // then e_col of the block's keys, the warps' row sums, a key-group mask
  // per row tile, and adj's edge bits (a 16-key word per row and key group)
  static size_t bytes(int P) {
    return sizeof(T) * (v_elems + ring_elems + pn_elems) +
           sizeof(float) * (kKeys + kWarps * kRT) + sizeof(uint32_t) * kMaxRowTiles +
           sizeof(uint16_t) * size_t(P) * kKeyGroups;
  }
};

// dpre of one entry, from its dp (the sum dO[r] . v[c]); p * keep into p_keep.
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

template <typename T, int FI>
__global__ void __launch_bounds__(kThreads, FI <= 128 ? 2 : 1)
flash_add_bwd_kernel(const float* __restrict__ e_row, const float* __restrict__ e_col,
                     const T* __restrict__ v, const uint8_t* __restrict__ adj,
                     const float* __restrict__ val, const float* __restrict__ lse,
                     const float* __restrict__ delta, const T* __restrict__ dout,
                     float* __restrict__ der, float* __restrict__ der_part,
                     float* __restrict__ dec, T* __restrict__ dv, int B, int P, int H, int f,
                     int vec, float slope, Dropout drop) {
  using C = BwdCfg<T, FI>;
  constexpr int NTO = FI / 8;
  constexpr int KS = kstep<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vs = reinterpret_cast<T*>(smem_raw);                  // [128][ld]: V, at the end dv
  T* dr = vs + C::v_elems;                                 // [2][16][ld]: dO ring
  T* pns = dr + C::ring_elems;                             // [16][ldd]: p * keep
  float* ecs = reinterpret_cast<float*>(pns + C::pn_elems);  // [128]
  float* rsum = ecs + kKeys;                               // [8][16]: the warps' row sums
  uint32_t* flags = reinterpret_cast<uint32_t*>(rsum + kWarps * kRT);  // [row tile]
  uint16_t* rbits = reinterpret_cast<uint16_t*>(flags + C::kMaxRowTiles);  // [P][8]

  const int n_kb = (P + kKeys - 1) / kKeys;
  const int kb = blockIdx.x % n_kb;
  const int hh = (blockIdx.x / n_kb) % H;
  const int b = blockIdx.x / (n_kb * H);
  const int c0 = kb * kKeys;  // the block's first key
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long row_stride = long(H) * f;
  const long base = (long(b) * P * H + hh) * f;
  const long sbase = long(b) * P * H + hh;  // element (b, 0, hh) of a [B, P, H] scalar
  const uint8_t* adj_b = adj + long(b) * P * P;
  const float* val_b = val ? val + long(b) * P * P : nullptr;
  const long row_off = (long(hh) * B + b) * P;
  const int n_rt = (P + kRT - 1) / kRT;
  // d e_row, or this key block's share of it
  float* rows_out = n_kb == 1 ? der : der_part + long(kb) * B * P * H;

  for (int i = tid; i < n_rt; i += kThreads) flags[i] = 0u;
  for (int i = tid; i < P * kKeyGroups; i += kThreads) rbits[i] = 0;
  for (int c = tid; c < kKeys; c += kThreads)
    ecs[c] = c0 + c < P ? e_col[sbase + long(c0 + c) * H] : 0.f;
  __syncthreads();
  scan_adj(adj_b, P, 0, P, c0, kKeyGroups, tid, kThreads, flags,
           [&](int r, int gk, int& w, uint32_t& bit) {
             w = r / kRT;
             bit = 1u << gk;
           },
           [&](int r, int gk, uint32_t bits) { rbits[r * kKeyGroups + gk] = uint16_t(bits); });
  __syncthreads();
  uint32_t colmask = 0;  // the block's key groups with an edge
  for (int i = 0; i < n_rt; ++i) colmask |= flags[i];

  // rows without an edge into the block's keys sum to 0
  for (int r = tid; r < P; r += kThreads)
    if (flags[r / kRT] == 0u) rows_out[sbase + long(r) * H] = 0.f;
  if (colmask == 0u) {
    for (int i = tid; i < kKeys * f; i += kThreads) {
      const int key = c0 + i / f;
      if (key >= P) continue;
      dv[base + long(key) * row_stride + i % f] = from_f32<T>(0.f);
      if (i % f == 0) dec[sbase + long(key) * H] = 0.f;
    }
    return;
  }

  const int kf = (f + KS - 1) / KS * KS;
  const uint32_t fmask = ((f + 7) / 8 >= 32 ? 0xffffffffu : (1u << ((f + 7) / 8)) - 1u);
  auto next_live = [&](int i) {
    while (i < n_rt && flags[i] == 0u) ++i;
    return i;
  };
  auto stage_tile = [&](int i, int st) {
    stage_rows<T, FI>(dout, base, row_stride, i * kRT, kRT, P, f, vec, 1u,
                      dr + size_t(st) * kRT * C::ld, C::ld, tid, kThreads);
  };
  stage_rows<T, FI>(v, base, row_stride, c0, kKeys, P, f, vec, colmask, vs, C::ld, tid,
                    kThreads);
  int i = next_live(0);
  stage_tile(i, 0);
  cp_async_commit();

  float dva[NTO][4];
  zero_acc(dva);
  float dca[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // d e_col of keys kw + 8 jj + 2 t + e1
  const int kw = warp * kGroup;                // the warp's first key in the block
  int st = 0;
  while (i < n_rt) {
    const int in = next_live(i + 1);
    if (in < n_rt) stage_tile(in, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bool mine = (flags[i] >> warp) & 1u;
    const T* dt = dr + size_t(st) * kRT * C::ld;
    const int row0 = i * kRT;
    float rs[2] = {0.f, 0.f};  // rows g and g + 8: the lane's share of the warp's row sums
    if (mine) {
      float dp[2][4];
      zero_acc(dp);
      for (int k0 = 0; k0 < kf; k0 += KS)
        mma_step<2, false, true>(dp, dt, C::ld, vs + size_t(kw) * C::ld, C::ld, k0, 0);
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int rr = g + 8 * e2, row = row0 + rr;
        const bool live = row < P;
        const float er = live ? e_row[sbase + long(row) * H] : 0.f;
        const float lr = live ? lse[row_off + row] : 0.f;
        const float dl = live ? delta[row_off + row] : 0.f;
        const uint32_t bits = live ? rbits[row * kKeyGroups + warp] : 0u;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int kc = jj * 8 + 2 * t + e1, key = c0 + kw + kc;
            float dpre = 0.f, pk = 0.f;
            if ((bits >> kc) & 1u) {
              const long ei = long(row) * P + key;
              const float keep = drop.on ? drop.factor(b, P, row, key, hh) : 1.f;
              dpre = entry_dpre(dp[jj][2 * e2 + e1], er + ecs[kw + kc], lr, dl,
                                val_b ? val_b[ei] : 1.f, val_b != nullptr, slope, keep, &pk);
            }
            pns[rr * C::ldd + kw + kc] = from_f32<T>(pk);
            rs[e2] += dpre;
            dca[jj][e1] += dpre;
          }
        }
      }
      __syncwarp();  // the warp's own pn columns are written
#pragma unroll
      for (int k0 = 0; k0 < kRT; k0 += KS)
        mma_step<NTO, true, false>(dva, pns + kw, C::ldd, dt, C::ld, k0, 0, fmask);
    }
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      rs[e2] += __shfl_xor_sync(0xffffffffu, rs[e2], 1);
      rs[e2] += __shfl_xor_sync(0xffffffffu, rs[e2], 2);
      if (t == 0) rsum[warp * kRT + g + 8 * e2] = rs[e2];
    }
    __syncthreads();  // the row sums are in; this ring slot and pn are free again
    if (tid < kRT && row0 + tid < P) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += rsum[w * kRT + tid];
      rows_out[sbase + long(row0 + tid) * H] = s;
    }
    i = in;
    st ^= 1;
  }

  // d e_col: the warp's keys summed over the quads' rows (lanes of one t)
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      float s = dca[jj][e1];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      const int key = c0 + kw + jj * 8 + 2 * t + e1;
      if (g == 0 && key < P) dec[sbase + long(key) * H] = s;
    }
  // dv staged in the V rows (free after the last tile) and stored coalesced
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
    for (int jj = 0; jj < NTO; ++jj)
      store_pair<T>(vs + size_t(kw + g + 8 * e2) * C::ld + jj * 8 + 2 * t, dva[jj][2 * e2],
                    dva[jj][2 * e2 + 1]);
  __syncthreads();
  store_tile<T>(vs, C::ld, dv, base, row_stride, c0, kKeys, P, f, vec, tid, kThreads);
}

// d e_row = the key blocks' partial sums [n_kb][n], added in key-block order.
__global__ void flash_add_bwd_rowsum(const float* __restrict__ part, float* __restrict__ der,
                                     long n, int n_kb) {
  const long i = long(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int kb = 0; kb < n_kb; ++kb) s += part[long(kb) * n + i];
  der[i] = s;
}

struct Args {
  const float *e_row, *e_col;
  const void *v, *dout;
  const uint8_t* adj;
  const float *val, *lse, *delta;
  float *der, *der_part, *dec;
  void* dv;
  int B, P, H, f;
  float slope;
  Dropout drop;
  cudaStream_t stream;
};

template <typename T, int FI>
cudaError_t launch_fi(const Args& a) {
  using C = BwdCfg<T, FI>;
  const size_t bytes = C::bytes(a.P);
  if (bytes > 232448) return cudaErrorInvalidValue;
  auto kernel = flash_add_bwd_kernel<T, FI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const int n_kb = (a.P + kKeys - 1) / kKeys;
  const long n_blocks = long(a.B) * a.H * n_kb;
  if (n_blocks > 0x7fffffffL || (n_kb > 1 && a.der_part == nullptr)) return cudaErrorInvalidValue;
  kernel<<<unsigned(n_blocks), kThreads, bytes, a.stream>>>(
      a.e_row, a.e_col, static_cast<const T*>(a.v), a.adj, a.val, a.lse, a.delta,
      static_cast<const T*>(a.dout), a.der, a.der_part, a.dec, static_cast<T*>(a.dv), a.B, a.P,
      a.H, a.f, fill_bytes<T>(a.f), a.slope, a.drop);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_kb == 1) return err;
  const long n = long(a.B) * a.P * a.H;
  flash_add_bwd_rowsum<<<unsigned((n + 255) / 256), 256, 0, a.stream>>>(a.der_part, a.der, n,
                                                                         n_kb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_f(const Args& a) {
  if (a.f <= 32) return launch_fi<T, 32>(a);
  if (a.f <= 64) return launch_fi<T, 64>(a);
  if (a.f <= 128) return launch_fi<T, 128>(a);
  return launch_fi<T, 256>(a);
}

}  // namespace

extern "C" {

// dtype (of v, dout and dv): 0 = fp32, 1 = bf16.  e_row, e_col, der, dec:
// fp32 [B, P, H] contiguous; v, dout, dv: [B, P, H, F] contiguous, 1 <= F <=
// 256; adj: [B, P, P] uint8, 1 <= P <= 2048; val: [B, P, P] fp32 or null;
// lse, delta: [H, B, P] fp32; der_part: fp32 scratch of ceil(P / 128) * B * P
// * H floats when P > 128 (null otherwise).  drop, seed, threshold and scale
// as dfgnn_flash_add_fwd's.  Launches one kernel (two when P > 128) on
// `stream`, allocates nothing, and returns the first CUDA error (0 when all
// launched).
int dfgnn_flash_add_bwd(int dtype, const void* e_row, const void* e_col, const void* v,
                        const void* adj, const void* val, const void* lse, const void* delta,
                        const void* dout, void* der, void* der_part, void* dec, void* dv, int B,
                        int P, int H, int F, float slope, int drop, unsigned seed,
                        unsigned threshold, float scale, void* stream) {
  if (B < 1 || H < 1 || P < 1 || P > kMaxP || F < 1 || F > 256) return int(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(e_row), static_cast<const float*>(e_col), v, dout,
               static_cast<const uint8_t*>(adj), static_cast<const float*>(val),
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<float*>(der), static_cast<float*>(der_part), static_cast<float*>(dec),
               dv, B, P, H, F, slope, Dropout{drop != 0, seed, threshold, scale},
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return int(dispatch_f<float>(a));
  if (dtype == 1) return int(dispatch_f<__nv_bfloat16>(a));
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
