// Kernel #3 past head dim 256: its wide blocks, in a translation unit of
// their own so that they compile in parallel with flash_mask_bwd.cu, whose
// entry point calls this one past F = 256.  The function is
// flash_mask_bwd.cuh's; the design (what each block holds, and how often
// each product is formed) is in that header's "wide heads" paragraph.

#include "flash_mask_bwd.cuh"

namespace {

// ---------------------------------------------------------------------------
// whole wide: P <= 128, f > 256.  16 warps
// ---------------------------------------------------------------------------

constexpr int kWideThreads = 512;  // 16 warps a block

// Two consecutive output columns (c, c + 1), c even, of row `row` from an
// fp32 pair, stored to global memory in T: one store where the pair is
// aligned and whole (even f, row stride and base), else one element at a
// time; columns at or past f and rows at or past P are not stored.
template <typename T>
__device__ __forceinline__ void store_out_pair(T* __restrict__ dst, long base, long row_stride,
                                               int row, int c, int P, int f, float a, float b) {
  if (row >= P || c >= f) return;
  T* p = dst + base + long(row) * row_stride + c;
  if (((base | row_stride | f) & 1) == 0) {
    store_pair<T>(p, a, b);  // c + 1 < f
  } else {
    p[0] = from_f32<T>(a);
    if (c + 1 < f) p[1] = from_f32<T>(b);
  }
}

// sum_i a_i b_i over the 16 bytes of a and of b (4 fp32 or 8 bf16), in fp32
__device__ __forceinline__ float dot16(float, uint4 a, uint4 b) {
  return __uint_as_float(a.x) * __uint_as_float(b.x) + __uint_as_float(a.y) * __uint_as_float(b.y) +
         __uint_as_float(a.z) * __uint_as_float(b.z) + __uint_as_float(a.w) * __uint_as_float(b.w);
}
__device__ __forceinline__ float dot16(__nv_bfloat16, uint4 a, uint4 b) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s += __uint_as_float(wa[i] << 16) * __uint_as_float(wb[i] << 16) +
         __uint_as_float(wa[i] & 0xffff0000u) * __uint_as_float(wb[i] & 0xffff0000u);
  return s;
}

template <typename T>
struct WholeWideCfg {
  static constexpr int kKeys = 128;
  static constexpr int kCK = 64 / int(sizeof(T));  // step 1: columns a chunk (64 bytes)
  static constexpr int kCV = 64, kCW = 128;        // step 2: columns a dv job, a dq or dk job
  // ds, pn: [row][key], read along their rows (dq) and across them (dk,
  // dv); 8 elements of padding keep the second free of bank conflicts
  static constexpr int ldd = kKeys + 8;
  static constexpr int ldc = kCK + pad_rm<T>();  // step 1's chunks, read along their rows
  static constexpr int ldv = kCV + 8;            // step 2's chunks, read across their rows
  static constexpr int ldw = kCW + 8;
  static constexpr size_t d_elems = size_t(kKeys) * ldd;
  // step 1: two stages of Q, dO, K and V chunks (128 rows each); step 2's
  // dv jobs: two stages of dO chunks; its dq and dk jobs: two stages of K or
  // Q chunks over pn (read by then) and the area
  static constexpr size_t s1_elems = size_t(2) * 4 * kKeys * ldc;
  static constexpr size_t sv_elems = size_t(2) * kKeys * ldv;
  static constexpr size_t sw_elems = size_t(2) * kKeys * ldw - d_elems;
  static constexpr size_t stage_elems =
      s1_elems > sv_elems ? (s1_elems > sw_elems ? s1_elems : sw_elems)
                          : (sv_elems > sw_elems ? sv_elems : sw_elems);
  static constexpr int kBitWords = kKeys * (kKeys / kGroup);  // adj's edge bits
  static constexpr size_t bytes = sizeof(T) * (2 * d_elems + stage_elems) +
                                  sizeof(float) * kKeys + sizeof(uint32_t) * 8 +
                                  sizeof(uint16_t) * kBitWords;
};

// The wide block forms delta = rowsum(dO * out) itself, from `out` (the
// forward's, with dropout applied), where the narrower kernels take it from
// the wrapper (bwd_delta): its rows are the block's, and forming it here
// reads dO and out once in place of a [B, P, h, f] product and its sum.
template <typename T, bool ONE>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_mask_bwd_whole_wide(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const uint8_t* __restrict__ adj,
                          const float* __restrict__ val, const float* __restrict__ lse,
                          const T* __restrict__ out, const T* __restrict__ dout,
                          T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int B, int P,
                          int H, int f, int vec, Dropout drop) {
  using C = WholeWideCfg<T>;
  constexpr int KS = kstep<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dss = reinterpret_cast<T*>(smem_raw);  // [128][ldd]: ds
  T* pns = dss + C::d_elems;                // [128][ldd]: pn
  T* stg = pns + C::d_elems;                // the staging area
  float* dlt = reinterpret_cast<float*>(stg + C::stage_elems);  // [128]: delta
  uint32_t* flags = reinterpret_cast<uint32_t*>(dlt + C::kKeys);  // [8]: key groups a row tile
  uint16_t* rbits = reinterpret_cast<uint16_t*>(flags + 8);             // [128][n_rt]: edge bits

  const int hh = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long row_stride = long(H) * f;
  const long base = (long(b) * P * H + hh) * f;
  const uint8_t* adj_b = adj + long(b) * P * P;
  const float* val_b = val ? val + long(b) * P * P : nullptr;
  const long row_off = (long(hh) * B + b) * P;
  const int n_rt = (P + kGroup - 1) / kGroup;

  if (tid < 8) flags[tid] = 0u;
  __syncthreads();
  scan_adj(adj_b, P, 0, C::kKeys, 0, n_rt, tid, kWideThreads, flags,
           [&](int r, int gk, int& w, uint32_t& bit) {
             w = r / kGroup;
             bit = 1u << gk;
           },
           [&](int r, int gk, uint32_t bits) { rbits[r * n_rt + gk] = uint16_t(bits); });
  __syncthreads();
  uint32_t colmask = 0u, rowlive = 0u;  // key groups, row tiles with an edge
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    colmask |= flags[i];
    rowlive |= uint32_t(flags[i] != 0u) << i;
  }
  // warp (wp, wq) of the dq and dk jobs: the 32 rows (or keys) of tiles
  // 2 wp and 2 wp + 1 by columns 32 wq..
  const int wp = warp & 3, wq = warp >> 2;
  // key groups with an edge in row tile i, of the warp's pair
  const uint32_t fr0 = flags[2 * wp], fr1 = flags[2 * wp + 1];
  // row tiles with an edge in key group i, of the warp's pair
  uint32_t fk0 = 0u, fk1 = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    fk0 |= ((flags[i] >> (2 * wp)) & 1u) << i;
    fk1 |= ((flags[i] >> (2 * wp + 1)) & 1u) << i;
  }

  // 1. s and dp over chunks of Q, dO, K and V staged in turn (warp (mt,
  //    kh): row tile mt by keys 64 kh.., both products), then ds and pn of
  //    them (zeros off the edges)
  const int mt = warp & 7, kh = warp >> 3;
  const uint32_t gm = (flags[mt] >> (4 * kh)) & 0xfu;  // the warp's live key groups
  const uint32_t nm = ntile_mask(gm);
  const int nck = (f + C::kCK - 1) / C::kCK;
  float s[8][4], dp[8][4];
  zero_acc(s);
  zero_acc(dp);
  auto stage1 = [&](int c, int st) {
    const long cb = base + long(c) * C::kCK;
    const int fc = min(C::kCK, f - c * C::kCK);
    T* at = stg + size_t(st) * 4 * C::kKeys * C::ldc;
    stage_rows<T, C::kCK>(q, cb, row_stride, 0, C::kKeys, P, fc, vec, rowlive, at, C::ldc, tid,
                          kWideThreads);
    stage_rows<T, C::kCK>(dout, cb, row_stride, 0, C::kKeys, P, fc, vec, rowlive,
                          at + C::kKeys * C::ldc, C::ldc, tid, kWideThreads);
    stage_rows<T, C::kCK>(k, cb, row_stride, 0, C::kKeys, P, fc, vec, colmask,
                          at + 2 * C::kKeys * C::ldc, C::ldc, tid, kWideThreads);
    stage_rows<T, C::kCK>(v, cb, row_stride, 0, C::kKeys, P, fc, vec, colmask,
                          at + 3 * C::kKeys * C::ldc, C::ldc, tid, kWideThreads);
  };
  // 2's jobs: n < nv: dv = pn^T . dO for chunk n of kCV columns; then dq =
  // ds . K and dk = ds^T . Q for each chunk of kCW columns, the dq and dk
  // jobs staged over pn once the dv jobs are done
  const int nv = (f + C::kCV - 1) / C::kCV, nw = (f + C::kCW - 1) / C::kCW;
  const int n_jobs = nv + 2 * nw;
  auto stage2 = [&](int n, int st) {
    if (n < nv) {
      const int c0 = n * C::kCV;
      stage_rows<T, C::kCV>(dout, base + c0, row_stride, 0, C::kKeys, P, min(C::kCV, f - c0), vec,
                            rowlive, stg + size_t(st) * C::kKeys * C::ldv, C::ldv, tid,
                            kWideThreads);
    } else {
      const int p = (n - nv) / nw, c0 = (n - nv - p * nw) * C::kCW;
      stage_rows<T, C::kCW>(p == 0 ? k : q, base + c0, row_stride, 0, C::kKeys, P,
                            min(C::kCW, f - c0), vec, p == 0 ? colmask : rowlive,
                            pns + size_t(st) * C::kKeys * C::ldw, C::ldw, tid, kWideThreads);
    }
  };
  if (rowlive != 0u) {
    stage1(0, 0);
    cp_async_commit();
  }
  {  // delta of the rows with an edge, 4 threads a row, while chunk 0 lands
    const int r = tid >> 2, q4 = tid & 3;
    float d = 0.f;
    if (r < P && ((rowlive >> (r / kGroup)) & 1u)) {
      const T* po = out + base + long(r) * row_stride;
      const T* pd = dout + base + long(r) * row_stride;
      if (vec == 16) {
        constexpr int kPer = 16 / int(sizeof(T));
#pragma unroll 4
        for (int c = q4 * kPer; c < f; c += 4 * kPer)
          d += dot16(T(), *reinterpret_cast<const uint4*>(pd + c),
                     *reinterpret_cast<const uint4*>(po + c));
      } else {
        for (int c = q4; c < f; c += 4) d += to_f32(pd[c]) * to_f32(po[c]);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (q4 == 0) dlt[r] = d;
  }
  __syncthreads();
  if (rowlive != 0u) {
#pragma unroll 1
    for (int c = 0; c < nck; ++c) {
      if (c + 1 < nck) stage1(c + 1, (c + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      if (gm != 0u) {
        const T* at = stg + size_t(c & 1) * 4 * C::kKeys * C::ldc;
        const T* qa = at + size_t(mt) * 16 * C::ldc;
        const T* da = at + size_t(C::kKeys + mt * 16) * C::ldc;
        const T* kb = at + size_t(2 * C::kKeys + kh * 64) * C::ldc;
        const T* vb = at + size_t(3 * C::kKeys + kh * 64) * C::ldc;
#pragma unroll
        for (int k0 = 0; k0 < C::kCK; k0 += KS) {
          mma_step<8, false, true, ONE>(s, qa, C::ldc, kb, C::ldc, k0, 0, nm);
          mma_step<8, false, true, ONE>(dp, da, C::ldc, vb, C::ldc, k0, 0, nm);
        }
      }
      __syncthreads();  // this stage is free again
    }
  }
  stage2(0, 0);  // lands while ds and pn are formed
  cp_async_commit();
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = mt * kGroup + g + 8 * e2;
    const float lr = row < P ? lse[row_off + row] : 0.f;
    const float dl = dlt[row];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int kc = kh * 64 + jj * 8 + 2 * t + e1, e = 2 * e2 + e1;
        const long ei = long(row) * P + kc;
        const bool edge = row < P && kc < P &&
                          ((rbits[row * n_rt + kc / kGroup] >> (kc % kGroup)) & 1u);
        const float keep = edge && drop.on ? drop.factor(b, P, row, kc, hh) : 1.f;
        float ds, pn;
        grad_elem(s[jj][e], dp[jj][e], edge, edge && val_b ? val_b[ei] : 1.f, val_b != nullptr,
                  lr, dl, keep, ds, pn);
        dss[row * C::ldd + kc] = from_f32<T>(ds);
        pns[row * C::ldd + kc] = from_f32<T>(pn);
      }
  }

  // 2. the jobs, each operand's chunk staged once through a two-stage ring,
  //    over the 16-groups with an edge; each warp stores what it formed.
  //    dv jobs: warp (tt, ch) forms columns 32 ch.. of key group tt; dq and
  //    dk jobs: warp (wp, wq) columns 32 wq.. of its pair of row tiles (dq)
  //    or key groups (dk)
  const int tt = warp & 7, ch = warp >> 3;
  uint32_t gv = 0u;  // row tiles with an edge in key group tt
#pragma unroll
  for (int i = 0; i < 8; ++i) gv |= ((flags[i] >> tt) & 1u) << i;
#pragma unroll 1
  for (int n = 0; n < n_jobs; ++n) {
    if (n + 1 < n_jobs && n + 1 != nv) stage2(n + 1, n + 1 < nv ? (n + 1) & 1 : (n + 1 - nv) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // (job 0: ds and pn are in place too)
    if (n < nv) {
      const int c0 = n * C::kCV + ch * 32, cols = f - c0;
      const uint32_t nmc = cols <= 0 ? 0u : cols >= 32 ? 0xfu : (1u << ((cols + 7) / 8)) - 1u;
      float acc[4][4];
      zero_acc(acc);
      if (nmc != 0u) {
        const T* bt = stg + size_t(n & 1) * C::kKeys * C::ldv;
#pragma unroll 1
        for (int gi = 0; gi < 8; ++gi) {
          if (!((gv >> gi) & 1u)) continue;
#pragma unroll
          for (int k0 = gi * kGroup; k0 < (gi + 1) * kGroup; k0 += KS)
            mma_step<4, true, false, ONE>(acc, pns + tt * kGroup, C::ldd, bt, C::ldv, k0,
                                               ch * 32, nmc);
        }
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            store_out_pair<T>(dv, base, row_stride, tt * kGroup + g + 8 * e2, c0 + jj * 8 + 2 * t,
                              P, f, acc[jj][2 * e2], acc[jj][2 * e2 + 1]);
      }
    } else {
      const int p = (n - nv) / nw, c0 = (n - nv - p * nw) * C::kCW + wq * 32, cols = f - c0;
      const uint32_t nmc = cols <= 0 ? 0u : cols >= 32 ? 0xfu : (1u << ((cols + 7) / 8)) - 1u;
      float acc[2][4][4];
      zero_acc(acc[0]);
      zero_acc(acc[1]);
      const uint32_t u0 = p == 0 ? fr0 : fk0, u1 = p == 0 ? fr1 : fk1;
      if (nmc != 0u && (u0 | u1) != 0u) {
        const T* bt = pns + size_t((n - nv) & 1) * C::kKeys * C::ldw;
#pragma unroll 1
        for (int gi = 0; gi < 8; ++gi) {
          const uint32_t mts = ((u0 >> gi) & 1u) | (((u1 >> gi) & 1u) << 1);
          if (mts == 0u) continue;
#pragma unroll
          for (int k0 = gi * kGroup; k0 < (gi + 1) * kGroup; k0 += KS) {
            if (p == 0)
              mma_step2<4, ONE>(acc, dss + size_t(wp) * 32 * C::ldd, C::ldd,
                                                   bt, C::ldw, k0, wq * 32, nmc, mts);
            else
              mma_step2<4, ONE, true>(acc, dss + wp * 32, C::ldd, bt, C::ldw, k0,
                                                  wq * 32, nmc, mts);
          }
        }
      }
      if (nmc != 0u) {
        T* out = p == 0 ? dq : dk;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              store_out_pair<T>(out, base, row_stride, (2 * wp + mt) * kGroup + g + 8 * e2,
                                c0 + jj * 8 + 2 * t, P, f, acc[mt][jj][2 * e2],
                                acc[mt][jj][2 * e2 + 1]);
      }
    }
    __syncthreads();  // this stage is free again
    if (n + 1 == nv && n + 1 < n_jobs) {  // pn is read: the first dq job over it
      stage2(n + 1, 0);
      cp_async_commit();
    }
  }
}

// ---------------------------------------------------------------------------
// stream wide, row pass: dq.  8 warps, 64 query rows, key tiles of 64, up to
// kWideCols columns of dq a block
// ---------------------------------------------------------------------------

constexpr int kWideCols = 512;       // columns of an output a stream block accumulates
constexpr int kStreamThreads = 256;  // 8 warps (16 spilled more at 128 registers a thread)

template <typename T>
struct RowsWideCfg {
  static constexpr int kRows = 64, KT = 64;
  static constexpr int kCK = 128 / int(sizeof(T));  // columns a score chunk (128 bytes)
  static constexpr int ldc = kCK + pad_rm<T>();    // the chunks: read along their rows
  static constexpr int ldk = kWideCols + 8;        // the tile's K: read across its rows
  static constexpr int ldd = KT + pad_rm<T>();     // ds: read along its rows
  static constexpr int kMaxTiles = kWinKeys / KT;  // key tiles a window
  // two stages of Q, dO (kRows each), K and V (KT each) chunks
  static constexpr size_t c_elems = size_t(2) * (2 * kRows + 2 * KT) * ldc;
  static constexpr size_t k_elems = size_t(KT) * ldk;
  static constexpr size_t d_elems = size_t(kRows) * ldd;
  static constexpr size_t bytes =
      sizeof(T) * (c_elems + k_elems + d_elems) + sizeof(uint32_t) * 5 * kMaxTiles;
};

template <typename T, bool ONE, bool WIN>
__global__ void __launch_bounds__(kStreamThreads, 1)
flash_mask_bwd_rows_wide(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const uint8_t* __restrict__ adj,
                         const float* __restrict__ val, const float* __restrict__ lse,
                         const float* __restrict__ delta, const T* __restrict__ dout,
                         T* __restrict__ dq, int B, int P, int H, int f, int vec, Dropout drop) {
  using C = RowsWideCfg<T>;
  constexpr int KT = C::KT, NTW = kWideCols / 32, KS = kstep<T>(), NTH = kStreamThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // [2][Q, dO, K, V rows][ldc]: score chunks
  T* kres = cs + C::c_elems;               // [KT][ldk]: the tile's K, the block's columns
  T* dss = kres + C::k_elems;              // [64][ldd]: ds
  uint32_t* flags = reinterpret_cast<uint32_t*>(dss + C::d_elems);  // [4][window tiles]
  uint32_t* tmask = flags + 4 * C::kMaxTiles;                       // [window tiles]

  const int n_rb = (P + C::kRows - 1) / C::kRows;
  const int rb = blockIdx.x % n_rb, hh = (blockIdx.x / n_rb) % H, b = blockIdx.x / (n_rb * H);
  const int r0 = rb * C::kRows;
  const int col0 = int(blockIdx.y) * kWideCols, fw = min(kWideCols, f - col0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long row_stride = long(H) * f;
  const long base = (long(b) * P * H + hh) * f;
  const uint8_t* adj_b = adj + long(b) * P * P;
  const float* val_b = val ? val + long(b) * P * P : nullptr;
  const long row_off = (long(hh) * B + b) * P;
  const int n_tiles = (P + KT - 1) / KT;
  const int nck = (f + C::kCK - 1) / C::kCK;  // > KT / kGroup past f = 256
  // scores: warp (smt, skh) forms s and dp of rows 16 smt.. by keys 32 skh..
  // of a tile; dq: warp (pr, cq) accumulates rows 32 pr.. by its quarter of
  // the block's n-tiles, ntw of them from column n0
  const int smt = warp & 3, skh = warp >> 2;
  const int pr = warp & 1, cq = warp >> 1;
  const int ntg = (fw + 7) / 8, ntw = (ntg + 3) / 4, n0 = cq * ntw * 8;
  const int mine = max(0, min(ntw, ntg - cq * ntw));
  const uint32_t nmask = (1u << mine) - 1u;
  const int row_w = r0 + smt * 16;
  float lr[2], dl[2];
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = row_w + g + 8 * e2;
    lr[e2] = row < P ? lse[row_off + row] : 0.f;
    dl[e2] = row < P ? delta[row_off + row] : 0.f;
  }
  float o[2][NTW][4];
  zero_acc(o[0]);
  zero_acc(o[1]);

  for (int w0 = 0; w0 < (WIN ? n_tiles : 1); w0 += C::kMaxTiles) {
    if (w0 > 0) __syncthreads();  // the last window's flags are free
    const int nt = WIN ? min(C::kMaxTiles, n_tiles - w0) : n_tiles, key0 = w0 * KT;
    for (int i = tid; i < 4 * nt; i += NTH) flags[i] = 0u;
    __syncthreads();
    scan_adj(adj_b, P, r0, C::kRows, key0, (min(nt * KT, P - key0) + kGroup - 1) / kGroup, tid,
             NTH, flags,
             [&](int r, int gk, int& w, uint32_t& bit) {
               w = ((r - r0) / 16) * nt + gk * kGroup / KT;
               bit = 1u << (gk % (KT / kGroup));
             },
             [](int, int, uint32_t) {});
    __syncthreads();
    for (int j = tid; j < nt; j += NTH)
      tmask[j] = flags[j] | flags[nt + j] | flags[2 * nt + j] | flags[3 * nt + j];
    __syncthreads();
#pragma unroll 1
    for (int jt = 0; jt < nt; ++jt) {
      const uint32_t live = tmask[jt];  // the tile's 16-key groups with an edge
      if (live == 0u) continue;
      const int j = w0 + jt;
      uint32_t qm = 0u;  // the m-tiles with an edge in the tile
#pragma unroll
      for (int m = 0; m < 4; ++m) qm |= uint32_t(flags[m * nt + jt] != 0u) << m;
      // chunk c of Q, dO (rows) and K, V (keys) into slot st, and (c < 4)
      // K's 16-key group c of the block's columns
      auto stage = [&](int c, int st) {
        const long cb = base + long(c) * C::kCK;
        const int fc = min(C::kCK, f - c * C::kCK);
        T* at = cs + size_t(st) * (2 * C::kRows + 2 * KT) * C::ldc;
        stage_rows<T, C::kCK>(q, cb, row_stride, r0, C::kRows, P, fc, vec, qm, at, C::ldc, tid,
                              NTH);
        stage_rows<T, C::kCK>(dout, cb, row_stride, r0, C::kRows, P, fc, vec, qm,
                              at + C::kRows * C::ldc, C::ldc, tid, NTH);
        stage_rows<T, C::kCK>(k, cb, row_stride, j * KT, KT, P, fc, vec, live,
                              at + 2 * C::kRows * C::ldc, C::ldc, tid, NTH);
        stage_rows<T, C::kCK>(v, cb, row_stride, j * KT, KT, P, fc, vec, live,
                              at + (2 * C::kRows + KT) * C::ldc, C::ldc, tid, NTH);
        if (c < KT / kGroup)
          stage_rows<T, kWideCols>(k, base + col0, row_stride, j * KT + c * kGroup, kGroup, P, fw,
                                   vec, (live >> c) & 1u, kres + size_t(c) * kGroup * C::ldk,
                                   C::ldk, tid, NTH);
      };
      float s[4][4], dp[4][4];
      zero_acc(s);
      zero_acc(dp);
      const uint32_t gm = (flags[smt * nt + jt] >> (2 * skh)) & 3u;  // the warp's live groups
      const uint32_t nm = ntile_mask(gm);
      stage(0, 0);
      cp_async_commit();
#pragma unroll 1
      for (int c = 0; c < nck; ++c) {
        if (c + 1 < nck) stage(c + 1, (c + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        if (gm != 0u) {
          const T* at = cs + size_t(c & 1) * (2 * C::kRows + 2 * KT) * C::ldc;
          const T* qa = at + size_t(smt) * 16 * C::ldc;
          const T* da = at + size_t(C::kRows + smt * 16) * C::ldc;
          const T* kb = at + size_t(2 * C::kRows + skh * 32) * C::ldc;
          const T* vb = at + size_t(2 * C::kRows + KT + skh * 32) * C::ldc;
#pragma unroll
          for (int k0 = 0; k0 < C::kCK; k0 += KS) {
            mma_step<4, false, true, ONE>(s, qa, C::ldc, kb, C::ldc, k0, 0, nm);
            mma_step<4, false, true, ONE>(dp, da, C::ldc, vb, C::ldc, k0, 0, nm);
          }
        }
        __syncthreads();  // this slot is free again
      }
      // ds of the warp's rows and keys (zeros off the edges)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = smt * 16 + g + 8 * (e >> 1), row = r0 + rr;
          const int kk = skh * 32 + jj * 8 + 2 * t + (e & 1), key = j * KT + kk;
          const long ei = long(row) * P + key;
          const bool edge = ((nm >> jj) & 1u) && row < P && key < P && adj_b[ei] != 0;
          const float keep = edge && drop.on ? drop.factor(b, P, row, key, hh) : 1.f;
          float ds, pn;
          grad_elem(s[jj][e], dp[jj][e], edge, edge && val_b ? val_b[ei] : 1.f, val_b != nullptr,
                    lr[e >> 1], dl[e >> 1], keep, ds, pn);
          dss[rr * C::ldd + kk] = from_f32<T>(ds);
        }
      __syncthreads();
      // dq += ds . K over the pair's live 16-key groups
      if (nmask != 0u) {
        const uint32_t f0 = flags[2 * pr * nt + jt], f1 = flags[(2 * pr + 1) * nt + jt];
        const T* da = dss + size_t(pr) * 32 * C::ldd;
#pragma unroll 1
        for (int gi = 0; gi < KT / kGroup; ++gi) {
          const uint32_t mts = ((f0 >> gi) & 1u) | (((f1 >> gi) & 1u) << 1);
          if (mts == 0u) continue;
#pragma unroll
          for (int k0 = gi * kGroup; k0 < (gi + 1) * kGroup; k0 += KS)
            mma_step2<NTW, ONE>(o, da, C::ldd, kres, C::ldk, k0, n0, nmask, mts);
        }
      }
      __syncthreads();  // K, ds and the chunks are free again
    }
  }
  // dq staged in K's rows, stored coalesced
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int rr = pr * 32 + mt * 16 + g + 8 * h2;
#pragma unroll
      for (int jj = 0; jj < NTW; ++jj)
        if ((nmask >> jj) & 1u)
          store_pair<T>(kres + size_t(rr) * C::ldk + n0 + jj * 8 + 2 * t, o[mt][jj][2 * h2],
                        o[mt][jj][2 * h2 + 1]);
    }
  __syncthreads();
  store_tile<T>(kres, C::ldk, dq, base + col0, row_stride, r0, C::kRows, P, fw, vec, tid, NTH);
}

// ---------------------------------------------------------------------------
// stream wide, column pass: dk and dv together.  8 warps, 32 keys, query
// tiles of 32 rows, up to kWideCols columns of dk and dv a block
// ---------------------------------------------------------------------------

template <typename T>
struct ColsWideCfg {
  static constexpr int kKeys = 32, kQT = 32;
  static constexpr int kCK = 256 / int(sizeof(T));     // columns a score chunk (256 bytes)
  static constexpr int ldc = kCK + pad_rm<T>();        // the chunks: read along their rows
  static constexpr int ldr = kWideCols + 8;            // the tile's Q and dO: read across rows
  static constexpr int ldd = kQT + pad_rm<T>();        // ds^T, pn^T: [key][row], along rows
  static constexpr int kMaxGroups = kWinKeys / kGroup;  // 16-row groups a window
  // two stages of K, V (kKeys each), Q and dO (kQT each) chunks
  static constexpr size_t c_elems = size_t(2) * (2 * kKeys + 2 * kQT) * ldc;
  static constexpr size_t r_elems = size_t(2) * kQT * ldr;
  static constexpr size_t d_elems = size_t(2) * kKeys * ldd;
  static constexpr size_t bytes =
      sizeof(T) * (c_elems + r_elems + d_elems) + sizeof(uint32_t) * kMaxGroups;
};

template <typename T, bool ONE, bool WIN>
__global__ void __launch_bounds__(kStreamThreads, 1)
flash_mask_bwd_cols_wide(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const uint8_t* __restrict__ adj,
                         const float* __restrict__ val, const float* __restrict__ lse,
                         const float* __restrict__ delta, const T* __restrict__ dout,
                         T* __restrict__ dk, T* __restrict__ dv, int B, int P, int H, int f,
                         int vec, Dropout drop) {
  using C = ColsWideCfg<T>;
  constexpr int NTW = kWideCols / 64, KS = kstep<T>(), NTH = kStreamThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);    // [2][K, V, Q, dO rows][ldc]: score chunks
  T* qres = cs + C::c_elems;                 // [32][ldr]: the tile's Q, the block's columns
  T* dres = qres + size_t(C::kQT) * C::ldr;  // [32][ldr]: its dO
  T* dst = dres + size_t(C::kQT) * C::ldr;   // [32][ldd]: ds^T
  T* pnt = dst + size_t(C::kKeys) * C::ldd;  // [32][ldd]: pn^T
  uint32_t* flags = reinterpret_cast<uint32_t*>(pnt + size_t(C::kKeys) * C::ldd);  // [groups]

  const int n_cb = (P + C::kKeys - 1) / C::kKeys;
  const int cb = blockIdx.x % n_cb, hh = (blockIdx.x / n_cb) % H, b = blockIdx.x / (n_cb * H);
  const int c0 = cb * C::kKeys;
  const int col0 = int(blockIdx.y) * kWideCols, fw = min(kWideCols, f - col0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long row_stride = long(H) * f;
  const long base = (long(b) * P * H + hh) * f;
  const uint8_t* adj_b = adj + long(b) * P * P;
  const float* val_b = val ? val + long(b) * P * P : nullptr;
  const long row_off = (long(hh) * B + b) * P;
  const int n_rg = (P + kGroup - 1) / kGroup;
  const int nck = (f + C::kCK - 1) / C::kCK;  // > kQT / kGroup past f = 256
  // scores: warp (km, rq) forms s^T and dp^T of keys 16 km.. by query rows
  // 8 rq.. of a tile; dk, dv: warp w accumulates all 32 keys by its eighth
  // of the block's n-tiles, ntw of them from column n0
  const int km = warp & 1, rq = warp >> 1;
  const int ntg = (fw + 7) / 8, ntw = (ntg + 7) / 8, n0 = warp * ntw * 8;
  const int mine = max(0, min(ntw, ntg - warp * ntw));
  const uint32_t nmask = (1u << mine) - 1u;
  float ok[2][NTW][4], ov[2][NTW][4];
  zero_acc(ok[0]);
  zero_acc(ok[1]);
  zero_acc(ov[0]);
  zero_acc(ov[1]);

  // The query rows go in windows of kMaxGroups 16-row groups, as in
  // flash_mask_bwd_cols: g0, ng: the window's first group and group count
  int g0 = 0, ng = 1;
  auto group = [&](int rg) { return rg < n_rg ? flags[rg - g0] : 0u; };
  for (int w0 = 0; w0 < (WIN ? n_rg : 1); w0 += C::kMaxGroups) {
    if (w0 > 0) __syncthreads();  // the last window's flags are free
    g0 = w0;
    ng = WIN ? min(C::kMaxGroups, n_rg - w0) : n_rg;
    for (int i = tid; i < ng; i += NTH) flags[i] = 0u;
    __syncthreads();
    scan_adj(adj_b, P, g0 * kGroup, ng * kGroup, c0, C::kKeys / kGroup, tid, NTH, flags,
             [&](int r, int gk, int& w, uint32_t& bit) {
               w = r / kGroup - g0;
               bit = 1u << gk;
             },
             [](int, int, uint32_t) {});
    __syncthreads();
    uint32_t cm = 0u;  // the block's key groups with an edge in the window
    for (int i = tid; i < ng; i += NTH) cm |= flags[i];
    const uint32_t colmask =
        (__syncthreads_or(cm & 1u) ? 1u : 0u) | (__syncthreads_or(cm & 2u) ? 2u : 0u);
    if (colmask == 0u) continue;
#pragma unroll 1
    for (int i = g0 / 2; i < (g0 + ng + 1) / 2; ++i) {
      const uint32_t ga = group(2 * i), gb = group(2 * i + 1);
      if ((ga | gb) == 0u) continue;
      const uint32_t rows_live = (ga ? 1u : 0u) | (gb ? 2u : 0u);
      // chunk c of K, V (keys) and Q, dO (rows) into slot st, and (c < 2)
      // the 16-row group c of the tile's Q and dO, the block's columns
      auto stage = [&](int c, int st) {
        const long ccb = base + long(c) * C::kCK;
        const int fc = min(C::kCK, f - c * C::kCK);
        T* at = cs + size_t(st) * (2 * C::kKeys + 2 * C::kQT) * C::ldc;
        stage_rows<T, C::kCK>(k, ccb, row_stride, c0, C::kKeys, P, fc, vec, colmask, at, C::ldc,
                              tid, NTH);
        stage_rows<T, C::kCK>(v, ccb, row_stride, c0, C::kKeys, P, fc, vec, colmask,
                              at + C::kKeys * C::ldc, C::ldc, tid, NTH);
        stage_rows<T, C::kCK>(q, ccb, row_stride, i * C::kQT, C::kQT, P, fc, vec, rows_live,
                              at + 2 * C::kKeys * C::ldc, C::ldc, tid, NTH);
        stage_rows<T, C::kCK>(dout, ccb, row_stride, i * C::kQT, C::kQT, P, fc, vec, rows_live,
                              at + (2 * C::kKeys + C::kQT) * C::ldc, C::ldc, tid, NTH);
        if (c < C::kQT / kGroup) {
          const int r = i * C::kQT + c * kGroup;
          const uint32_t one = (rows_live >> c) & 1u;
          stage_rows<T, kWideCols>(q, base + col0, row_stride, r, kGroup, P, fw, vec, one,
                                   qres + size_t(c) * kGroup * C::ldr, C::ldr, tid, NTH);
          stage_rows<T, kWideCols>(dout, base + col0, row_stride, r, kGroup, P, fw, vec, one,
                                   dres + size_t(c) * kGroup * C::ldr, C::ldr, tid, NTH);
        }
      };
      // the warp's keys have an edge among its 8 rows' 16-row group
      const bool on = ((group(2 * i + (rq >> 1)) >> km) & 1u) != 0u;
      float s[1][4], dp[1][4];
      zero_acc(s);
      zero_acc(dp);
      stage(0, 0);
      cp_async_commit();
#pragma unroll 1
      for (int c = 0; c < nck; ++c) {
        if (c + 1 < nck) stage(c + 1, (c + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        if (on) {
          const T* at = cs + size_t(c & 1) * (2 * C::kKeys + 2 * C::kQT) * C::ldc;
          const T* ka = at + size_t(km) * 16 * C::ldc;
          const T* va = at + size_t(C::kKeys + km * 16) * C::ldc;
          const T* qb = at + size_t(2 * C::kKeys + rq * 8) * C::ldc;
          const T* db = at + size_t(2 * C::kKeys + C::kQT + rq * 8) * C::ldc;
#pragma unroll
          for (int k0 = 0; k0 < C::kCK; k0 += KS) {
            mma_step<1, false, true, ONE>(s, ka, C::ldc, qb, C::ldc, k0, 0, 1u);
            mma_step<1, false, true, ONE>(dp, va, C::ldc, db, C::ldc, k0, 0, 1u);
          }
        }
        __syncthreads();  // this slot is free again
      }
      // ds^T and pn^T of the warp's keys and rows (zeros off the edges)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = km * 16 + g + 8 * (e >> 1), key = c0 + kr;
        const int rc = rq * 8 + 2 * t + (e & 1), row = i * C::kQT + rc;
        const long ei = long(row) * P + key;
        const bool edge = on && row < P && key < P && adj_b[ei] != 0;
        const float keep = edge && drop.on ? drop.factor(b, P, row, key, hh) : 1.f;
        float ds, pn;
        grad_elem(s[0][e], dp[0][e], edge, edge && val_b ? val_b[ei] : 1.f, val_b != nullptr,
                  edge ? lse[row_off + row] : 0.f, edge ? delta[row_off + row] : 0.f, keep, ds,
                  pn);
        dst[kr * C::ldd + rc] = from_f32<T>(ds);
        pnt[kr * C::ldd + rc] = from_f32<T>(pn);
      }
      __syncthreads();
      // dk += ds^T . Q, dv += pn^T . dO over the tile's 16-row groups, for
      // the key m-tiles with an edge in each
      if (nmask != 0u) {
#pragma unroll 1
        for (int gi = 0; gi < C::kQT / kGroup; ++gi) {
          const uint32_t mts = (gi == 0 ? ga : gb) & 3u;
          if (mts == 0u) continue;
#pragma unroll
          for (int k0 = gi * kGroup; k0 < (gi + 1) * kGroup; k0 += KS) {
            mma_step2<NTW, ONE>(ok, dst, C::ldd, qres, C::ldr, k0, n0, nmask, mts);
            mma_step2<NTW, ONE>(ov, pnt, C::ldd, dres, C::ldr, k0, n0, nmask, mts);
          }
        }
      }
      __syncthreads();  // the tile's Q, dO, ds^T and pn^T are free again
    }
  }
  // dk, dv staged in Q's and dO's rows, stored coalesced
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int kr = mt * 16 + g + 8 * h2;
#pragma unroll
      for (int jj = 0; jj < NTW; ++jj)
        if ((nmask >> jj) & 1u) {
          const size_t at = size_t(kr) * C::ldr + n0 + jj * 8 + 2 * t;
          store_pair<T>(qres + at, ok[mt][jj][2 * h2], ok[mt][jj][2 * h2 + 1]);
          store_pair<T>(dres + at, ov[mt][jj][2 * h2], ov[mt][jj][2 * h2 + 1]);
        }
    }
  __syncthreads();
  store_tile<T>(qres, C::ldr, dk, base + col0, row_stride, c0, C::kKeys, P, fw, vec, tid, NTH);
  store_tile<T>(dres, C::ldr, dv, base + col0, row_stride, c0, C::kKeys, P, fw, vec, tid, NTH);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T, bool ONE, bool WIN>
cudaError_t launch_wide(const Args& a) {
  const int vec = fill_bytes<T>(a.f);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  T* dq = static_cast<T*>(a.dq);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  if constexpr (!WIN) {
    if (a.P <= 128) {
      using C = WholeWideCfg<T>;
      auto kernel = flash_mask_bwd_whole_wide<T, ONE>;
      cudaError_t err = prepare(kernel, C::bytes);
      if (err != cudaSuccess) return err;
      const long n_blocks = long(a.B) * a.H;
      if (n_blocks > 0x7fffffffL) return cudaErrorInvalidValue;
      if (a.out == nullptr) return cudaErrorInvalidValue;
      kernel<<<unsigned(n_blocks), kWideThreads, C::bytes, a.stream>>>(
          q, k, v, a.adj, a.val, a.lse, static_cast<const T*>(a.out), dout, dq, dk, dv, a.B, a.P,
          a.H, a.f, vec, a.drop);
      return cudaGetLastError();
    }
  }
  if (a.delta == nullptr) return cudaErrorInvalidValue;  // the passes read it
  using R = RowsWideCfg<T>;
  using CC = ColsWideCfg<T>;
  const long blocks_r = long(a.B) * a.H * ((a.P + R::kRows - 1) / R::kRows);
  const long blocks_c = long(a.B) * a.H * ((a.P + CC::kKeys - 1) / CC::kKeys);
  const int ng = (a.f + kWideCols - 1) / kWideCols;  // groups of kWideCols output columns
  if (blocks_r > 0x7fffffffL || blocks_c > 0x7fffffffL || ng > 65535)
    return cudaErrorInvalidValue;
  auto rows = flash_mask_bwd_rows_wide<T, ONE, WIN>;
  cudaError_t err = prepare(rows, R::bytes);
  if (err != cudaSuccess) return err;
  rows<<<dim3(unsigned(blocks_r), unsigned(ng)), kStreamThreads, R::bytes, a.stream>>>(
      q, k, v, a.adj, a.val, a.lse, a.delta, dout, dq, a.B, a.P, a.H, a.f, vec, a.drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto cols = flash_mask_bwd_cols_wide<T, ONE, WIN>;
  err = prepare(cols, CC::bytes);
  if (err != cudaSuccess) return err;
  cols<<<dim3(unsigned(blocks_c), unsigned(ng)), kStreamThreads, CC::bytes, a.stream>>>(
      q, k, v, a.adj, a.val, a.lse, a.delta, dout, dk, dv, a.B, a.P, a.H, a.f, vec, a.drop);
  return cudaGetLastError();
}

template <typename T, bool WIN>
cudaError_t launch_wide_prec(const Args& a) {
  if constexpr (sizeof(T) == 4) {
    if (a.one) return launch_wide<T, true, WIN>(a);
  }
  return launch_wide<T, false, WIN>(a);
}

}  // namespace

extern "C" {

// Kernel #3 past F = 256, the arguments as dfgnn_flash_mask_bwd's
// (flash_mask_bwd.cu), which calls it: one launch at P <= 128 (forming delta
// from out; delta unused), two past it (a row pass, then a column pass,
// reading delta; out unused), on `stream`; returns the first CUDA error
// (cudaErrorInvalidValue at F <= 256 or outside the set).
int dfgnn_flash_mask_bwd_wide(int dtype, const void* q, const void* k, const void* v,
                              const void* adj, const void* val, const void* lse,
                              const void* delta, const void* out, const void* dout, void* dq,
                              void* dk, void* dv, int B, int P, int H, int F, int drop,
                              uint32_t seed, uint32_t threshold, float scale, int one_pass,
                              void* stream) {
  if (B < 1 || H < 1 || P < 1 || F <= 256) return int(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, out, static_cast<const uint8_t*>(adj),
               static_cast<const float*>(val), static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, dk, dv, B, P, H, F,
               Dropout{drop != 0, seed, threshold, scale}, one_pass != 0,
               static_cast<cudaStream_t>(stream)};
  const bool win = P > kWinKeys;
  if (dtype == 0)
    return int(win ? launch_wide_prec<float, true>(a) : launch_wide_prec<float, false>(a));
  if (dtype == 1)
    return int(win ? launch_wide_prec<__nv_bfloat16, true>(a)
                   : launch_wide_prec<__nv_bfloat16, false>(a));
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
