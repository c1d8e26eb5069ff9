// Masked dense graph-attention backward for Hopper (sm_90a), hand-written CUDA
// on the tensor cores: kernel #3's passes and launch code, built by
// flash_mask_bwd.cu (P <= kWinKeys, and the C entry point) and
// flash_mask_bwd_win.cu (past it), two translation units that compile in
// parallel.
//
// Replaces dfgnn_tpu/ops/pallas/flash_mask.py::_bwd_kernel_dot (:256), driven
// there by _bwd (:317).  For every graph b and head h of a DenseBatch, from
// q (pre-scaled), k, v, dO [B, P, h, f], adj, optional val, the forward's
// lse [h, B, P] and delta = rowsum(dO * out) [h, B, P] (fp32, computed by
// the wrapper, as _bwd computes it outside its kernel):
//   s  = q . k^T, times val[b] when edge values are given
//   p  = adj[b] ? exp(s - lse) : 0        empty rows (lse = -1e30) give p = 0
//   dp = (dO . v^T) * keep, pn = p * keep  (keep: the forward's dropout factor)
//   ds = p * (dp - delta), times val[b]   (val is a constant: no d val)
//   dq = ds . k      dk = ds^T . q      dv = pn^T . dO
// ds and pn are rounded to the input type before the three products, as the
// Pallas kernel casts them (.astype(k.dtype) / .astype(do.dtype)).  keep is
// regenerated from the seed with the hash of flash_common.cuh, as kernel #4
// does.  fp32 or bf16, layout [B, P, h, f] with any f >= 1 (tiles zero past
// f up to the instantiated width FI, as in flash_mask_fwd.cu); fp32
// products as 3xTF32, or one TF32 pass with `one` (precision "default").
//
// What bounds it on an H100 SXM (data-sheet peaks): at the table's shape
// (B=1024, h=1, P=128, f=128, fp32) the bytes of q, k, v, out (for delta),
// dO, adj, lse read and dq, dk, dv written take 0.165 ms at 3.35 TB/s; the
// dense blocks' 5 products of 4.3 GFLOP take 0.13 ms as 3xTF32 on the tensor
// cores: device memory bounds it, once the products run on the tensor cores
// and padding is skipped.
//
// Design (tile helpers and the reason for mma.sync in flash_mma.cuh):
// - whole (P <= 128, FI <= 128: the main path), flash_mask_bwd_whole: one
//   block of 8 warps per (graph, head) owns every row and every key, so it
//   forms s, p, dp and ds once and writes dq, dk and dv with no sum across
//   blocks: 5 products, deterministic, no atomics.  K and V stay resident
//   (cp.async, rows of live key groups only); Q and dO stream in 16-row
//   tiles through a two-stage cp.async ring.  Per tile: warp w forms s and
//   dp for key group w (16 keys) and writes ds and pn to shared memory; the
//   warps then split dq = ds . K by feature columns, and warp w accumulates
//   dk and dv of its 16 keys in registers (ds^T . Q, pn^T . dO).  Shared
//   memory in fp32 at FI = 128: K 67.6 KB, V 67.6 KB, Q and dO rings 33.8 KB,
//   ds and pn 16.9 KB, the dq tile 8.4 KB and adj's edge bits 2 KB (196 KB,
//   one block an SM).  Outputs leave through shared memory, 16 bytes a
//   thread (store_tile).
// - stream (P > 128, or FI = 256): two launches, deterministic,
//   without atomics.  flash_mask_bwd_rows: a block per 64 query rows walks
//   key tiles (64 keys; 32 at FI = 256) and accumulates dq = ds . K.
//   flash_mask_bwd_cols: a block per 64 keys walks query tiles of 32 rows,
//   forms s^T and dp^T directly (K . Q^T, V . dO^T) and accumulates dk and dv.
//   Both rebuild s and dp: 7 products.  At FI = 256 the column pass runs
//   twice, once for dk and once for dv, so each keeps one [16, 256]
//   accumulator a warp in registers.
// - wide heads (f > 256, the stream passes at FI = 256): a grid axis over
//   chunks of 256 columns, the block of chunk c writing columns [256 c,
//   256 c + 256) of dq (row pass) or of dk or dv (column passes).  Per tile
//   it sums s and dp over every chunk, each staged through the FI = 256
//   buffers (Q, dO and the K, V tile; K, V and the Q, dO tile), its own
//   chunk last, so that the operands of its outputs' products are in place
//   after the sum: shared memory stays that of FI = 256, and every chunk
//   re-forms the scores.  No sums across blocks, so no atomics.
// - Padding skipped, exactly, from adj itself (scan_adj): a 16-row query
//   tile with no edge writes dq = 0 and is never loaded; a 16-key group with
//   no edge in a tile is skipped by the warp that owns it, and keys with no
//   edge at all get dk = dv = 0.  p is exactly 0 off the edges.
// - Any P: the row pass takes its keys, and the column pass its query rows,
//   in windows of kWinKeys (as the forward does, flash_fwd.cuh): per window
//   the block scans adj, flags what is live and walks it, its sums running
//   on across windows, so shared memory does not grow with P.  At P <=
//   kWinKeys both launch their one-window instantiation (WIN false), whose
//   window loop the compiler folds away: with the loop kept, the row pass
//   at FI = 32 took 242 registers where it had taken 162, and at FI = 256
//   spilled 552 bytes (ptxas, PERF.md section 6).
#pragma once

#include "flash_mma.cuh"

namespace {

// keys (row pass) or query rows (column pass) a stream block scans and flags
// at a time
constexpr int kWinKeys = 2048;

// ds and pn of one score element from the raw products s and dp.
__device__ __forceinline__ void grad_elem(float s, float dp, bool edge, float vv, bool has_val,
                                          float lse, float delta, float keep, float& ds,
                                          float& pn) {
  ds = pn = 0.f;
  if (!edge) return;
  const float p = expf((has_val ? s * vv : s) - lse);
  ds = p * (dp * keep - delta);
  if (has_val) ds *= vv;
  pn = p * keep;
}

// ---------------------------------------------------------------------------
// whole: P <= 128, FI <= 128
// ---------------------------------------------------------------------------

template <typename T, int FI>
struct WholeCfg {
  static constexpr int kThreads = 256, kKeys = 128, kRT = 16;
  static constexpr int ld = FI + pad_rm<T>();       // K, V, Q and dO rows
  static constexpr int ldd = kKeys + pad_rm<T>();   // ds and pn rows
  static constexpr size_t kv_elems = size_t(kKeys) * ld;
  static constexpr size_t ring_elems = size_t(2) * kRT * ld;
  static constexpr size_t d_elems = size_t(kRT) * ldd;
  static constexpr size_t dq_elems = size_t(kRT) * ld;
  static constexpr int kBitWords = kKeys * (kKeys / kGroup);  // adj's edge bits
  static constexpr size_t bytes =
      sizeof(T) * (2 * kv_elems + 2 * ring_elems + 2 * d_elems + dq_elems) +
      sizeof(uint32_t) * 8 + sizeof(uint16_t) * kBitWords;
};

template <typename T, int FI, bool ONE>
__global__ void __launch_bounds__(256)
flash_mask_bwd_whole(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ adj, const float* __restrict__ val,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
                     T* __restrict__ dv, int B, int P, int H, int f, int vec, Dropout drop) {
  using C = WholeCfg<T, FI>;
  constexpr int NTO = FI / 8;
  constexpr int NPW = NTO >= 8 ? NTO / 8 : 1;  // dq n-tiles a warp
  constexpr int KS = kstep<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [128][ld]
  T* vs = ks + C::kv_elems;                // [128][ld]
  T* qr = vs + C::kv_elems;                // [2][16][ld]
  T* dr = qr + C::ring_elems;              // [2][16][ld]
  T* dss = dr + C::ring_elems;             // [16][ldd]: ds of the tile
  T* pns = dss + C::d_elems;               // [16][ldd]: pn of the tile
  T* dqs = pns + C::d_elems;               // [16][ld]: dq of the tile
  uint32_t* flags = reinterpret_cast<uint32_t*>(dqs + C::dq_elems);  // [8]: 16-key groups a row tile
  uint16_t* rbits = reinterpret_cast<uint16_t*>(flags + 8);          // [128][n_rt]: edge bits

  const int hh = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long row_stride = long(H) * f;
  const long base = (long(b) * P * H + hh) * f;
  const uint8_t* adj_b = adj + long(b) * P * P;
  const float* val_b = val ? val + long(b) * P * P : nullptr;
  const long row_off = (long(hh) * B + b) * P;
  const int n_rt = (P + C::kRT - 1) / C::kRT;

  if (tid < 8) flags[tid] = 0u;
  __syncthreads();
  scan_adj(adj_b, P, 0, C::kKeys, 0, n_rt, tid, C::kThreads, flags,
           [&](int r, int gk, int& w, uint32_t& bit) {
             w = r / C::kRT;
             bit = 1u << gk;
           },
           [&](int r, int gk, uint32_t bits) { rbits[r * n_rt + gk] = uint16_t(bits); });
  __syncthreads();
  uint32_t colmask = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) colmask |= flags[i];

  // dq of row tiles without an edge is 0; so is everything when no edge
  for (int i = tid; i < P * f; i += C::kThreads) {
    const int r = i / f;
    if (flags[r / C::kRT] == 0u) dq[base + long(r) * row_stride + i % f] = from_f32<T>(0.f);
  }
  if (colmask == 0u) {
    for (int i = tid; i < P * f; i += C::kThreads) {
      const long e = base + long(i / f) * row_stride + i % f;
      dk[e] = dv[e] = from_f32<T>(0.f);
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
    stage_rows<T, FI>(q, base, row_stride, i * C::kRT, C::kRT, P, f, vec, 1u,
                      qr + size_t(st) * C::kRT * C::ld, C::ld, tid, C::kThreads);
    stage_rows<T, FI>(dout, base, row_stride, i * C::kRT, C::kRT, P, f, vec, 1u,
                      dr + size_t(st) * C::kRT * C::ld, C::ld, tid, C::kThreads);
  };

  stage_rows<T, FI>(k, base, row_stride, 0, C::kKeys, P, f, vec, colmask, ks, C::ld, tid,
                    C::kThreads);
  stage_rows<T, FI>(v, base, row_stride, 0, C::kKeys, P, f, vec, colmask, vs, C::ld, tid,
                    C::kThreads);
  int i = next_live(0);
  stage_tile(i, 0);
  cp_async_commit();

  float dka[NTO][4], dva[NTO][4];
  zero_acc(dka);
  zero_acc(dva);
  const int key_w = warp * kGroup;  // the warp's first key
  int st = 0;
  while (i < n_rt) {
    const int in = next_live(i + 1);
    if (in < n_rt) stage_tile(in, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t gm = flags[i];
    const bool mine = (gm >> warp) & 1u;
    const T* qt = qr + size_t(st) * C::kRT * C::ld;
    const T* dt = dr + size_t(st) * C::kRT * C::ld;
    const int row0 = i * C::kRT;

    // 1. s and dp of the tile's 16 rows against the warp's 16 keys; ds, pn
    if (mine) {
      float s[2][4], dp[2][4];
      zero_acc(s);
      zero_acc(dp);
      for (int k0 = 0; k0 < kf; k0 += KS) {
        mma_step<2, false, true, ONE>(s, qt, C::ld, ks + size_t(key_w) * C::ld, C::ld, k0, 0,
                                      0xffffffffu);
        mma_step<2, false, true, ONE>(dp, dt, C::ld, vs + size_t(key_w) * C::ld, C::ld, k0, 0,
                                      0xffffffffu);
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int rr = g + 8 * e2, row = row0 + rr;
        const float lr = row < P ? lse[row_off + row] : 0.f;
        const float dl = row < P ? delta[row_off + row] : 0.f;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int kc = key_w + jj * 8 + 2 * t + e1;
            const int e = 2 * e2 + e1;
            const long ei = long(row) * P + kc;
            const bool edge = row < P && kc < P &&
                              ((rbits[row * n_rt + kc / kGroup] >> (kc % kGroup)) & 1u);
            const float keep = edge && drop.on ? drop.factor(b, P, row, kc, hh) : 1.f;
            float ds, pn;
            grad_elem(s[jj][e], dp[jj][e], edge, edge && val_b ? val_b[ei] : 1.f,
                      val_b != nullptr, lr, dl, keep, ds, pn);
            dss[rr * C::ldd + kc] = from_f32<T>(ds);
            pns[rr * C::ldd + kc] = from_f32<T>(pn);
          }
        }
      }
    }
    __syncthreads();

    // 2. dq of the tile's rows = ds . K, feature n-tiles split over the
    //    warps, staged in dqs and stored coalesced
    {
      const int n0 = warp * NPW * 8;
      if (n0 < FI && n0 < f) {
        float acc[NPW][4];
        zero_acc(acc);
#pragma unroll 1
        for (int gi = 0; gi < 8; ++gi) {
          if (!((gm >> gi) & 1u)) continue;
#pragma unroll
          for (int k0 = gi * kGroup; k0 < (gi + 1) * kGroup; k0 += KS)
            mma_step<NPW, false, false, ONE>(acc, dss, C::ldd, ks, C::ld, k0, n0, 0xffffffffu);
        }
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
#pragma unroll
          for (int jj = 0; jj < NPW; ++jj) {
            const int c = n0 + jj * 8 + 2 * t;
            dqs[(g + 8 * e2) * C::ld + c] = from_f32<T>(acc[jj][2 * e2]);
            dqs[(g + 8 * e2) * C::ld + c + 1] = from_f32<T>(acc[jj][2 * e2 + 1]);
          }
        }
      }
    }
    __syncthreads();
    store_tile<T>(dqs, C::ld, dq, base, row_stride, row0, C::kRT, P, f, vec, tid, C::kThreads);

    // 3. dk += ds^T . Q and dv += pn^T . dO over the tile's rows, for the
    //    warp's 16 keys
    if (mine) {
#pragma unroll
      for (int k0 = 0; k0 < C::kRT; k0 += KS) {
        mma_step<NTO, true, false, ONE>(dka, dss + key_w, C::ldd, qt, C::ld, k0, 0, fmask);
        mma_step<NTO, true, false, ONE>(dva, pns + key_w, C::ldd, dt, C::ld, k0, 0, fmask);
      }
    }
    __syncthreads();  // ds, pn and this ring slot are free again
    i = in;
    st ^= 1;
  }

  // dk, dv staged in the K and V rows (free after the last tile) and stored
  // coalesced
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int kr = key_w + g + 8 * e2;
#pragma unroll
    for (int jj = 0; jj < NTO; ++jj) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int c = jj * 8 + 2 * t + e1;
        ks[kr * C::ld + c] = from_f32<T>(dka[jj][2 * e2 + e1]);
        vs[kr * C::ld + c] = from_f32<T>(dva[jj][2 * e2 + e1]);
      }
    }
  }
  __syncthreads();
  store_tile<T>(ks, C::ld, dk, base, row_stride, 0, C::kKeys, P, f, vec, tid, C::kThreads);
  store_tile<T>(vs, C::ld, dv, base, row_stride, 0, C::kKeys, P, f, vec, tid, C::kThreads);
}

// ---------------------------------------------------------------------------
// stream, row pass: dq.  4 warps, 64 query rows, key tiles of KT
// ---------------------------------------------------------------------------

template <typename T, int FI, int KT>
struct RowsCfg {
  static constexpr int kWarps = 4, kThreads = 128, kRows = 64;
  static constexpr int kStages = FI == 256 ? 1 : 2;
  static constexpr int kMaxTiles = kWinKeys / KT;  // key tiles a window
  static constexpr int ld = FI + pad_rm<T>();
  static constexpr int ldd = KT + pad_rm<T>();
  static constexpr size_t row_elems = size_t(kRows) * ld;
  static constexpr size_t tile_elems = size_t(KT) * ld;
  static constexpr size_t d_elems = size_t(kRows) * ldd;
  static constexpr size_t bytes =
      sizeof(T) * (2 * row_elems + 2 * kStages * tile_elems + d_elems) +
      sizeof(uint32_t) * (size_t(kWarps) * kMaxTiles + kMaxTiles + kWarps);
};

template <typename T, int FI, int KT, bool ONE, bool WIN>
__global__ void __launch_bounds__(128)
flash_mask_bwd_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const uint8_t* __restrict__ adj, const float* __restrict__ val,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const T* __restrict__ dout, T* __restrict__ dq, int B, int P, int H, int f,
                    int vec, Dropout drop) {
  using C = RowsCfg<T, FI, KT>;
  constexpr int NTS = KT / 8, NTO = FI / 8, KS = kstep<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);            // [64][ld]
  T* dos = qs + C::row_elems;                        // [64][ld]
  T* ks = dos + C::row_elems;                        // [stages][KT][ld]
  T* vs = ks + C::kStages * C::tile_elems;           // [stages][KT][ld]
  T* dss = vs + C::kStages * C::tile_elems;          // [64][ldd]
  uint32_t* flags = reinterpret_cast<uint32_t*>(dss + C::d_elems);  // [4][window tiles]
  uint32_t* tmask = flags + C::kWarps * C::kMaxTiles;
  uint32_t* wlive = tmask + C::kMaxTiles;

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
  const long row_off = (long(hh) * B + b) * P;
  const int n_tiles = (P + KT - 1) / KT;
  // wide heads: blockIdx.y is the block's chunk of FI columns of dq, fw its
  // width
  constexpr bool kWide = FI == 256;
  const int nc = kWide ? (f + FI - 1) / FI : 1;
  const int col0 = int(blockIdx.y) * FI, fw = min(FI, f - col0);
  const long obase = base + col0;

  // The keys go in windows of kMaxTiles tiles, as in the forward
  // (flash_fwd.cuh): per window the block scans its rows over the window's
  // keys, flags the live tiles and walks them, dq summing on across
  // windows.  j0, nt: the window's first tile and tile count; qlive: the
  // warps with an edge in it; qdone: those whose Q and dO rows are in place
  int j0 = 0, nt = 1;
  uint32_t qlive = 0, qdone = 0;
  bool live_w = false;
  auto next_live = [&](int j) {
    while (j < j0 + nt && tmask[j - j0] == 0u) ++j;
    return j;
  };
  // K and V of key tile j, columns [cb - base, + fc), into stage st
  auto stage_kv = [&](int j, int st, long cb, int fc) {
    stage_rows<T, FI>(k, cb, row_stride, j * KT, KT, P, fc, vec, tmask[j - j0],
                      ks + size_t(st) * C::tile_elems, C::ld, tid, C::kThreads);
    stage_rows<T, FI>(v, cb, row_stride, j * KT, KT, P, fc, vec, tmask[j - j0],
                      vs + size_t(st) * C::tile_elems, C::ld, tid, C::kThreads);
  };
  // the Q and dO rows of the warps in `live`, the same columns
  auto stage_q = [&](long cb, int fc, uint32_t live) {
    stage_rows<T, FI>(q, cb, row_stride, r0, C::kRows, P, fc, vec, live, qs, C::ld, tid,
                      C::kThreads);
    stage_rows<T, FI>(dout, cb, row_stride, r0, C::kRows, P, fc, vec, live, dos, C::ld, tid,
                      C::kThreads);
  };

  const int kf = (f + KS - 1) / KS * KS;
  const uint32_t fmask = ((fw + 7) / 8 >= 32 ? 0xffffffffu : (1u << ((fw + 7) / 8)) - 1u);
  const int row_w = r0 + warp * 16;
  float lr[2], dl[2];
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = row_w + g + 8 * e2;
    lr[e2] = row < P ? lse[row_off + row] : 0.f;
    dl[e2] = row < P ? delta[row_off + row] : 0.f;
  }
  float acc[NTO][4];
  zero_acc(acc);
  int st = 0;
  for (int w0 = 0; w0 < (WIN ? n_tiles : 1); w0 += C::kMaxTiles) {
    if (w0 > 0) __syncthreads();  // the last window's flags are free
    j0 = w0;
    nt = WIN ? min(C::kMaxTiles, n_tiles - w0) : n_tiles;
    const int key0 = j0 * KT;
    for (int i = tid; i < C::kWarps * nt; i += C::kThreads) flags[i] = 0u;
    __syncthreads();
    scan_adj(adj_b, P, r0, C::kRows, key0, (min(nt * KT, P - key0) + kGroup - 1) / kGroup, tid,
             C::kThreads, flags,
             [&](int r, int gk, int& w, uint32_t& bit) {
               w = ((r - r0) / 16) * nt + gk * kGroup / KT;
               bit = 1u << (gk % (KT / kGroup));
             },
             [](int, int, uint32_t) {});
    __syncthreads();
    bool any = false;
    for (int j = tid; j < nt; j += C::kThreads) {
      uint32_t m = 0;
      for (int w = 0; w < C::kWarps; ++w) m |= flags[w * nt + j];
      tmask[j] = m;
      any |= m != 0u;
    }
    if (tid < C::kWarps) {
      uint32_t m = 0;
      for (int j = 0; j < nt; ++j) m |= flags[tid * nt + j];
      wlive[tid] = m != 0u;
    }
    if (!__syncthreads_or(any)) {
      if (WIN) continue;  // dq = 0 leaves with the rest
      for (int i = tid; i < C::kRows * fw; i += C::kThreads) {
        const int r = r0 + i / fw;
        if (r < P) dq[obase + long(r) * row_stride + i % fw] = from_f32<T>(0.f);
      }
      return;
    }
    qlive = 0;
    for (int w = 0; w < C::kWarps; ++w) qlive |= wlive[w] << w;
    live_w = wlive[warp] != 0u;
    const uint32_t qnew = qlive & ~qdone;
    qdone |= qnew;

    if (nc == 1) stage_q(base, f, qnew);
    int j = next_live(j0);
    if (C::kStages == 2) stage_kv(j, st, base, f);
    cp_async_commit();

    while (j < j0 + nt) {
      const int jn = next_live(j + 1);
      const uint32_t gm = live_w ? flags[warp * nt + j - j0] : 0u;
      const T* kt = ks + size_t(st) * C::tile_elems;
      const T* vt = vs + size_t(st) * C::tile_elems;
      const T* qw = qs + size_t(warp) * 16 * C::ld;
      const T* dw = dos + size_t(warp) * 16 * C::ld;
      const uint32_t nm = ntile_mask(gm);
      float s[NTS][4], dp[NTS][4];
      zero_acc(s);
      zero_acc(dp);
      if (nc > 1) {
        // wide: s and dp summed over the chunks of FI columns, the block's own
        // chunk last, so that K of its dq columns is in place for ds . K
        for (int n = 1; n <= nc; ++n) {
          const int cc = (int(blockIdx.y) + n) % nc, fc = min(FI, f - cc * FI);
          stage_q(base + long(cc) * FI, fc, qlive);
          stage_kv(j, 0, base + long(cc) * FI, fc);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          if (gm != 0u)
            for (int k0 = 0; k0 < fc; k0 += KS) {
              mma_step<NTS, false, true, ONE>(s, qw, C::ld, kt, C::ld, k0, 0, nm);
              mma_step<NTS, false, true, ONE>(dp, dw, C::ld, vt, C::ld, k0, 0, nm);
            }
          if (n < nc) __syncthreads();  // the buffers are free for the next chunk
        }
      } else {
        if (C::kStages == 2) {
          if (jn < j0 + nt) stage_kv(jn, st ^ 1, base, f);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          stage_kv(j, 0, base, f);
          cp_async_commit();
          cp_async_wait<0>();
        }
        __syncthreads();
        if (gm != 0u)
          for (int k0 = 0; k0 < kf; k0 += KS) {
            mma_step<NTS, false, true, ONE>(s, qw, C::ld, kt, C::ld, k0, 0, nm);
            mma_step<NTS, false, true, ONE>(dp, dw, C::ld, vt, C::ld, k0, 0, nm);
          }
      }
      if (gm != 0u) {
        T* dsw = dss + size_t(warp) * 16 * C::ldd;
#pragma unroll
        for (int jj = 0; jj < NTS; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = g + 8 * (e >> 1), row = row_w + rr;
            const int kc = jj * 8 + 2 * t + (e & 1), key = j * KT + kc;
            const long ei = long(row) * P + key;
            const bool edge = ((nm >> jj) & 1u) && row < P && key < P && adj_b[ei] != 0;
            const float keep = edge && drop.on ? drop.factor(b, P, row, key, hh) : 1.f;
            float ds, pn;
            grad_elem(s[jj][e], dp[jj][e], edge, edge && val_b ? val_b[ei] : 1.f,
                      val_b != nullptr, lr[e >> 1], dl[e >> 1], keep, ds, pn);
            dsw[rr * C::ldd + kc] = from_f32<T>(ds);
          }
        }
        __syncwarp();
#pragma unroll 1
        for (int gi = 0; gi < KT / kGroup; ++gi) {
          if (!((gm >> gi) & 1u)) continue;
#pragma unroll
          for (int k0 = gi * kGroup; k0 < (gi + 1) * kGroup; k0 += KS)
            mma_step<NTO, false, false, ONE>(acc, dsw, C::ldd, kt, C::ld, k0, 0, fmask);
        }
      }
      __syncthreads();
      j = jn;
      if (C::kStages == 2) st ^= 1;
    }
  }
  // dq staged in the warp's Q rows (free after the last tile), stored coalesced
  T* qw = qs + size_t(warp) * 16 * C::ld;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
#pragma unroll
    for (int jj = 0; jj < NTO; ++jj) {
      const int c = jj * 8 + 2 * t;
      qw[(g + 8 * e2) * C::ld + c] = from_f32<T>(acc[jj][2 * e2]);
      qw[(g + 8 * e2) * C::ld + c + 1] = from_f32<T>(acc[jj][2 * e2 + 1]);
    }
  }
  __syncwarp();
  store_tile<T>(qw, C::ld, dq, obase, row_stride, row_w, 16, P, fw, vec, lane, 32);
}

// ---------------------------------------------------------------------------
// stream, column pass: dk (DK) and dv (DV).  4 warps, 64 keys, query tiles
// of 32 rows
// ---------------------------------------------------------------------------

template <typename T, int FI>
struct ColsCfg {
  static constexpr int kThreads = 128, kKeys = 64, kQT = 32;
  static constexpr int kStages = FI == 256 ? 1 : 2;
  static constexpr int kMaxGroups = kWinKeys / kGroup;  // 16-row groups a window
  static constexpr int ld = FI + pad_rm<T>();
  static constexpr int ldd = kQT + pad_rm<T>();
  static constexpr size_t key_elems = size_t(kKeys) * ld;
  static constexpr size_t tile_elems = size_t(kQT) * ld;
  static constexpr size_t d_elems = size_t(kKeys) * ldd;
  static constexpr size_t bytes =
      sizeof(T) * (2 * key_elems + 2 * kStages * tile_elems + 2 * d_elems) +
      sizeof(uint32_t) * kMaxGroups;
};

template <typename T, int FI, bool DK, bool DV, bool ONE, bool WIN>
__global__ void __launch_bounds__(128)
flash_mask_bwd_cols(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const uint8_t* __restrict__ adj, const float* __restrict__ val,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv, int B,
                    int P, int H, int f, int vec, Dropout drop) {
  using C = ColsCfg<T, FI>;
  constexpr int NTQ = C::kQT / 8, NTO = FI / 8, KS = kstep<T>();
  constexpr int NA = DK ? NTO : 1, NB = DV ? NTO : 1;  // accumulator n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);            // [64][ld]
  T* vs = ks + C::key_elems;                         // [64][ld]
  T* qr = vs + C::key_elems;                         // [stages][32][ld]
  T* dr = qr + C::kStages * C::tile_elems;           // [stages][32][ld]
  T* dss = dr + C::kStages * C::tile_elems;          // [64][ldd]: ds^T, a warp's 16 keys
  T* pns = dss + C::d_elems;                         // [64][ldd]: pn^T
  uint32_t* flags = reinterpret_cast<uint32_t*>(pns + C::d_elems);  // [window group]: key groups

  const int n_col_blocks = (P + C::kKeys - 1) / C::kKeys;
  const int cb = blockIdx.x % n_col_blocks;
  const int hh = (blockIdx.x / n_col_blocks) % H;
  const int b = blockIdx.x / (n_col_blocks * H);
  const int c0 = cb * C::kKeys;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long row_stride = long(H) * f;
  const long base = (long(b) * P * H + hh) * f;
  const uint8_t* adj_b = adj + long(b) * P * P;
  const float* val_b = val ? val + long(b) * P * P : nullptr;
  const long row_off = (long(hh) * B + b) * P;
  const int n_rg = (P + kGroup - 1) / kGroup;
  // wide heads: blockIdx.y is the block's chunk of FI columns of dk or dv,
  // fw its width
  constexpr bool kWide = FI == 256;
  const int nc = kWide ? (f + FI - 1) / FI : 1;
  const int col0 = int(blockIdx.y) * FI, fw = min(FI, f - col0);
  const long obase = base + col0;

  // The query rows go in windows of kMaxGroups 16-row groups (kWinKeys
  // rows, a whole number of query tiles): per window the block scans the
  // window's rows over its keys, flags the live groups and walks the live
  // query tiles, dk and dv summing on across windows.  g0, ng: the window's
  // first group and group count; colmask: the block's key groups with an
  // edge in it; kdone: those whose K (and V) rows are in place
  int g0 = 0, ng = 1;
  uint32_t colmask = 0, kdone = 0;
  // the window's flags of 16-row group rg (0 past the graph)
  auto group = [&](int rg) { return rg < n_rg ? flags[rg - g0] : 0u; };
  // query tile i is live when one of its two 16-row groups has an edge
  auto tile_flags = [&](int i) { return group(2 * i) | group(2 * i + 1); };
  auto next_live = [&](int i) {
    while (i < (g0 + ng + 1) / 2 && tile_flags(i) == 0u) ++i;
    return i;
  };
  // Q and dO of query tile i, columns [cb - base, + fc), into stage st
  auto stage_tile = [&](int i, int st, long cb, int fc) {
    const uint32_t rows_live = (group(2 * i) ? 1u : 0u) | (group(2 * i + 1) ? 2u : 0u);
    stage_rows<T, FI>(q, cb, row_stride, i * C::kQT, C::kQT, P, fc, vec, rows_live,
                      qr + size_t(st) * C::tile_elems, C::ld, tid, C::kThreads);
    stage_rows<T, FI>(dout, cb, row_stride, i * C::kQT, C::kQT, P, fc, vec, rows_live,
                      dr + size_t(st) * C::tile_elems, C::ld, tid, C::kThreads);
  };
  // the block's K (and, for dk, V) rows of the key groups in `live`, the
  // same columns
  auto stage_keys = [&](long cb, int fc, uint32_t live) {
    stage_rows<T, FI>(k, cb, row_stride, c0, C::kKeys, P, fc, vec, live, ks, C::ld, tid,
                      C::kThreads);
    if (DK)
      stage_rows<T, FI>(v, cb, row_stride, c0, C::kKeys, P, fc, vec, live, vs, C::ld, tid,
                        C::kThreads);
  };

  const int kf = (f + KS - 1) / KS * KS;
  const uint32_t fmask = ((fw + 7) / 8 >= 32 ? 0xffffffffu : (1u << ((fw + 7) / 8)) - 1u);
  const int key_w = warp * kGroup;  // the warp's first key, within the block
  float dka[NA][4], dva[NB][4];
  zero_acc(dka);
  zero_acc(dva);
  __shared__ uint32_t warp_cols[4];
  int st = 0;
  for (int w0 = 0; w0 < (WIN ? n_rg : 1); w0 += C::kMaxGroups) {
    if (w0 > 0) __syncthreads();  // the last window's flags are free
    g0 = w0;
    ng = WIN ? min(C::kMaxGroups, n_rg - w0) : n_rg;
    for (int i = tid; i < ng; i += C::kThreads) flags[i] = 0u;
    __syncthreads();
    scan_adj(adj_b, P, g0 * kGroup, ng * kGroup, c0, C::kKeys / kGroup, tid, C::kThreads, flags,
             [&](int r, int gk, int& w, uint32_t& bit) {
               w = r / kGroup - g0;
               bit = 1u << gk;
             },
             [](int, int, uint32_t) {});
    __syncthreads();
    colmask = 0;  // the block's key groups with an edge in the window
    for (int i = tid; i < ng; i += C::kThreads) colmask |= flags[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) colmask |= __shfl_xor_sync(0xffffffffu, colmask, o);
    if (lane == 0) warp_cols[warp] = colmask;
    __syncthreads();
    colmask = warp_cols[0] | warp_cols[1] | warp_cols[2] | warp_cols[3];
    if (colmask == 0u) {
      if (WIN) continue;  // dk = dv = 0 leave with the rest
      for (int i = tid; i < C::kKeys * fw; i += C::kThreads) {
        const int key = c0 + i / fw;
        if (key >= P) continue;
        const long e = obase + long(key) * row_stride + i % fw;
        if (DK) dk[e] = from_f32<T>(0.f);
        if (DV) dv[e] = from_f32<T>(0.f);
      }
      return;
    }
    const uint32_t knew = colmask & ~kdone;  // live key groups whose rows are not yet in place
    kdone |= knew;

    if (nc == 1) stage_keys(base, f, knew);
    int i = next_live(g0 / 2);
    if (C::kStages == 2) stage_tile(i, st, base, f);
    cp_async_commit();

    while (i < (g0 + ng + 1) / 2) {
      const int in = next_live(i + 1);
      // the tile's 16-row groups in which the warp's keys have an edge
      const int rg = 2 * i;
      const uint32_t rmask =
          ((group(rg) >> warp) & 1u) | ((group(rg + 1) >> warp) & 1u) << 1;
      const T* qt = qr + size_t(st) * C::tile_elems;
      const T* dt = dr + size_t(st) * C::tile_elems;
      const uint32_t nm = ntile_mask(rmask);
      // s^T = K_w . Q^T and dp^T = V_w . dO^T: rows are keys, columns queries
      float s[NTQ][4], dp[NTQ][4];
      zero_acc(s);
      zero_acc(dp);
      auto scores = [&](int depth) {
        for (int k0 = 0; k0 < depth; k0 += KS) {
          mma_step<NTQ, false, true, ONE>(s, ks + size_t(key_w) * C::ld, C::ld, qt, C::ld, k0, 0,
                                          nm);
          if (DK)
            mma_step<NTQ, false, true, ONE>(dp, vs + size_t(key_w) * C::ld, C::ld, dt, C::ld, k0,
                                            0, nm);
        }
      };
      if (nc > 1) {
        // wide: s and dp summed over the chunks of FI columns, the block's own
        // chunk last, so that Q and dO of its dk or dv columns are in place
        for (int n = 1; n <= nc; ++n) {
          const int cc = (int(blockIdx.y) + n) % nc, fc = min(FI, f - cc * FI);
          stage_keys(base + long(cc) * FI, fc, colmask);
          stage_tile(i, 0, base + long(cc) * FI, fc);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          if (rmask != 0u) scores(fc);
          if (n < nc) __syncthreads();  // the buffers are free for the next chunk
        }
      } else {
        if (C::kStages == 2) {
          if (in < (g0 + ng + 1) / 2) stage_tile(in, st ^ 1, base, f);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          stage_tile(i, 0, base, f);
          cp_async_commit();
          cp_async_wait<0>();
        }
        __syncthreads();
        if (rmask != 0u) scores(kf);
      }
      if (rmask != 0u) {
        T* dsw = dss + size_t(warp) * 16 * C::ldd;
        T* pnw = pns + size_t(warp) * 16 * C::ldd;
#pragma unroll
        for (int jj = 0; jj < NTQ; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kr = g + 8 * (e >> 1), key = c0 + key_w + kr;
            const int rc = jj * 8 + 2 * t + (e & 1), row = i * C::kQT + rc;
            const long ei = long(row) * P + key;
            const bool edge = ((nm >> jj) & 1u) && row < P && key < P && adj_b[ei] != 0;
            const float keep = edge && drop.on ? drop.factor(b, P, row, key, hh) : 1.f;
            float ds, pn;
            grad_elem(s[jj][e], dp[jj][e], edge, edge && val_b ? val_b[ei] : 1.f,
                      val_b != nullptr, edge ? lse[row_off + row] : 0.f,
                      edge ? delta[row_off + row] : 0.f, keep, ds, pn);
            if (DK) dsw[kr * C::ldd + rc] = from_f32<T>(ds);
            if (DV) pnw[kr * C::ldd + rc] = from_f32<T>(pn);
          }
        }
        __syncwarp();
#pragma unroll
        for (int gi = 0; gi < 2; ++gi) {
          if (!((rmask >> gi) & 1u)) continue;
#pragma unroll
          for (int k0 = gi * kGroup; k0 < (gi + 1) * kGroup; k0 += KS) {
            if (DK) mma_step<NA, false, false, ONE>(dka, dsw, C::ldd, qt, C::ld, k0, 0, fmask);
            if (DV) mma_step<NB, false, false, ONE>(dva, pnw, C::ldd, dt, C::ld, k0, 0, fmask);
          }
        }
      }
      __syncthreads();
      i = in;
      if (C::kStages == 2) st ^= 1;
    }
  }
  // dk, dv staged in the K and V rows (free after the last tile), stored
  // coalesced
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int kr = key_w + g + 8 * e2;
#pragma unroll
    for (int jj = 0; jj < NTO; ++jj) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int c = jj * 8 + 2 * t + e1;
        if (DK) ks[kr * C::ld + c] = from_f32<T>(dka[DK ? jj : 0][2 * e2 + e1]);
        if (DV) vs[kr * C::ld + c] = from_f32<T>(dva[DV ? jj : 0][2 * e2 + e1]);
      }
    }
  }
  __syncthreads();
  if (DK)
    store_tile<T>(ks, C::ld, dk, obase, row_stride, c0, C::kKeys, P, fw, vec, tid, C::kThreads);
  if (DV)
    store_tile<T>(vs, C::ld, dv, obase, row_stride, c0, C::kKeys, P, fw, vec, tid, C::kThreads);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const uint8_t* adj;
  const float *val, *lse, *delta;
  void *dq, *dk, *dv;
  int B, P, H, f;
  Dropout drop;
  bool one;
  cudaStream_t stream;
};

template <typename KernelT>
cudaError_t prepare(KernelT kernel, size_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <typename T, int FI, bool ONE, bool WIN>
cudaError_t launch_fi(const Args& a) {
  const int vec = fill_bytes<T>(a.f);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  T* dq = static_cast<T*>(a.dq);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  if constexpr (FI <= 128 && !WIN) {
    if (a.P <= 128) {
      using C = WholeCfg<T, FI>;
      auto kernel = flash_mask_bwd_whole<T, FI, ONE>;
      cudaError_t err = prepare(kernel, C::bytes);
      if (err != cudaSuccess) return err;
      const long n_blocks = long(a.B) * a.H;
      if (n_blocks > 0x7fffffffL) return cudaErrorInvalidValue;
      kernel<<<unsigned(n_blocks), C::kThreads, C::bytes, a.stream>>>(
          q, k, v, a.adj, a.val, a.lse, a.delta, dout, dq, dk, dv, a.B, a.P, a.H, a.f, vec,
          a.drop);
      return cudaGetLastError();
    }
  }
  constexpr int KT = FI == 256 ? 32 : 64;
  using R = RowsCfg<T, FI, KT>;
  using CC = ColsCfg<T, FI>;
  const long blocks_r = long(a.B) * a.H * ((a.P + R::kRows - 1) / R::kRows);
  const long blocks_c = long(a.B) * a.H * ((a.P + CC::kKeys - 1) / CC::kKeys);
  const int nc = (a.f + FI - 1) / FI;  // chunks of FI columns: 1 but for wide heads
  if (blocks_r > 0x7fffffffL || blocks_c > 0x7fffffffL || nc > 65535)
    return cudaErrorInvalidValue;
  auto rows = flash_mask_bwd_rows<T, FI, KT, ONE, WIN>;
  cudaError_t err = prepare(rows, R::bytes);
  if (err != cudaSuccess) return err;
  rows<<<dim3(unsigned(blocks_r), unsigned(nc)), R::kThreads, R::bytes, a.stream>>>(
      q, k, v, a.adj, a.val, a.lse, a.delta, dout, dq, a.B, a.P, a.H, a.f, vec, a.drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto run_cols = [&](auto kernel) {
    cudaError_t e = prepare(kernel, CC::bytes);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(unsigned(blocks_c), unsigned(nc)), CC::kThreads, CC::bytes, a.stream>>>(
        q, k, v, a.adj, a.val, a.lse, a.delta, dout, dk, dv, a.B, a.P, a.H, a.f, vec, a.drop);
    return cudaGetLastError();
  };
  if constexpr (FI == 256) {
    err = run_cols(flash_mask_bwd_cols<T, FI, true, false, ONE, WIN>);
    if (err != cudaSuccess) return err;
    return run_cols(flash_mask_bwd_cols<T, FI, false, true, ONE, WIN>);
  } else {
    return run_cols(flash_mask_bwd_cols<T, FI, true, true, ONE, WIN>);
  }
}

// launch_fi with the products' precision: one TF32 pass only for fp32
template <typename T, int FI, bool WIN>
cudaError_t launch_prec(const Args& a) {
  if constexpr (sizeof(T) == 4) {
    if (a.one) return launch_fi<T, FI, true, WIN>(a);
  }
  return launch_fi<T, FI, false, WIN>(a);
}

template <typename T, bool WIN>
cudaError_t dispatch_f(const Args& a) {
  if (a.f <= 32) return launch_prec<T, 32, WIN>(a);
  if (a.f <= 64) return launch_prec<T, 64, WIN>(a);
  if (a.f <= 128) return launch_prec<T, 128, WIN>(a);
  return launch_prec<T, 256, WIN>(a);
}

// The C entry points' body (flash_mask_bwd.cu's dfgnn_flash_mask_bwd, its
// arguments documented there), on the one-window (WIN false, P <=
// kWinKeys) or the windowed instantiations.
template <bool WIN>
int bwd_entry(int dtype, const void* q, const void* k, const void* v, const void* adj,
              const void* val, const void* lse, const void* delta, const void* dout, void* dq,
              void* dk, void* dv, int B, int P, int H, int F, int drop, uint32_t seed,
              uint32_t threshold, float scale, int one_pass, void* stream) {
  if (B < 1 || H < 1 || P < 1 || F < 1 || (!WIN && P > kWinKeys))
    return int(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const uint8_t*>(adj), static_cast<const float*>(val),
               static_cast<const float*>(lse), static_cast<const float*>(delta), dq, dk, dv,
               B, P, H, F, Dropout{drop != 0, seed, threshold, scale}, one_pass != 0,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return int(dispatch_f<float, WIN>(a));
  if (dtype == 1) return int(dispatch_f<__nv_bfloat16, WIN>(a));
  return int(cudaErrorInvalidValue);
}

}  // namespace
