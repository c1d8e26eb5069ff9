// The masked dense graph-attention forward on the tensor cores: one kernel
// body for the dot score (#1, flash_mask_fwd.cu), the additive score (#2,
// flash_add_fwd.cu), the whole GT layer (#5, flash_layer_dot.cu) and the
// whole GAT layer (#6, flash_layer_add.cu), templated on a score policy.
//
// For every graph b and head h of a DenseBatch:
//   s   = score(r, c), times val[b] when edge values are given
//   s   = adj[b] ? s : -1e30
//   m   = max(rowmax(s), -0.5e30)     masked lanes then underflow to exactly 0
//   ex  = exp(s - m), l = rowsum(ex)  (the undropped ex)
//   out = (round_to<T>(ex * keep) . v) * (l > 0 ? 1 / l : 0)
//   lse = l > 0 ? m + log(l) : -1e30  optional, [h, B, P] fp32
// keep is the edge-hash dropout factor of flash_common.cuh (1 without
// dropout).  v and out keep the JAX layout [B, P, h, f], any f from 1 to
// 256: the staged tiles are zero past f up to the instantiated width FI (32,
// 64, 128 or 256), which adds only 0 * 0 terms, and only f columns are
// stored.  fp32 or bf16 v; fp32 softmax and sums.
//
// The score policies:
// - DotScore (#1): s = q . k^T, q pre-scaled, q and k of v's type and shape.
//   A block stages its Q rows and a K tile, and the scores are an mma
//   product.
// - AddScore (#2): s = leaky_relu(e_row[r] + e_col[c]) from fp32 [B, P, h]
//   scalars read through their strides.  A block stages e_col of the graph
//   (P floats) and keeps e_row of a thread's two fragment rows (g, g + 8) in
//   registers; each score is formed straight in the C-fragment layout, with
//   no product and no K tile.
// - LayerScore (#5): DotScore with q, k and v projected in the kernel from
//   node features x by the tensor cores (project_tile, flash_mma.cuh), into
//   the same shared-memory tiles #1 fills by cp.async: the Q rows of the live
//   warps, K and V of the live key groups of each key tile.  The projection
//   is synchronous, so the stream block keeps one K/V stage and projects the
//   next live tile after the current one is consumed.
// - LayerAddScore (#6): AddScore with v = z projected in the kernel from x
//   (project_tile_scores), and e_row, e_col summed from the same unrounded
//   fp32 z into shared memory: the whole block projects every node live as
//   a row or a key once, with both scalars; the stream block projects its
//   query rows for e_row only, then each live key tile's z into the one V
//   stage with that tile's e_col (so e_col is kept of one tile, not the
//   graph).  The scores are then AddScore's.
// Everything after the score is shared.
//
// Design (the tile helpers are in flash_mma.cuh, which says why mma.sync):
// - Products on the tensor cores: mma.sync m16n8k8 with each fp32 operand
//   split in two TF32 parts (3xTF32: rtol 1e-4 holds against fp32), bf16
//   m16n8k16, both with fp32 accumulators.  A warp owns 16 query rows.
// - Padding skipped, exactly: the block first scans its adj rows once
//   (scan_adj) and marks each 16-key group that has an edge, per warp.  A
//   block with no edge writes out = 0, lse = -1e30 and exits; a key tile no
//   warp needs is neither loaded nor computed; a warp forms ex only in the
//   8-key n-tiles of its live groups (q . k^T too) and skips the k-steps of
//   ex.v in its dead groups.  p is 0 exactly off the edges, so nothing
//   changes.
// - Two shapes of block, chosen on the host:
//   * whole (P <= 128, FI <= 128, the main path): 4 warps take 64 rows, and
//     one 128-key tile covers every key, so m is the exact row max and ex is
//     rounded relative to it, as in JAX.  A thread keeps the edge bits of its
//     two rows in registers (four words each).  Dot: Q and K load as one
//     cp.async group; once the warps have their scores, V overwrites K in
//     the same buffer, and ex the warp's own Q rows (fp32 at FI = 128: Q/ex
//     33.8 KB, K/V 69.6 KB, 103 KB in all: two blocks an SM).  Add: V's live
//     key groups load as soon as the scan is done and land while the
//     scores, the softmax and ex are formed; ex takes a buffer of its own
//     (fp32 at FI = 128: ex 33.8 KB, V 69.6 KB, e_col 0.5 KB, 103 KB in all:
//     two blocks an SM; bf16 53 KB: four).  For ex.v the warps pair up: warp
//     2p + c computes output columns [c FI / 2, (c + 1) FI / 2) of the
//     pair's 32 rows (mma_step2), so each V fragment is loaded, and in fp32
//     split, once for two m-tiles instead of once a warp (PERF.md section
//     6 has the times before and after); the pair's l meet in shared
//     memory.  Against 8 warps over 128 rows
//     with K and V apart (205 KB, one block an SM) the dot block ran faster
//     on molhiv-like padded blocks and slightly slower on dense ones.
//   * stream (P > 128, or FI = 256): 4 warps take 64 rows and walk key tiles
//     of 64 (32 at FI = 256) through a two-stage cp.async ring (K and V, or
//     V alone), with an online softmax: m is the running max, l and the
//     output are rescaled by exp(m_old - m_new) when it grows.  In fp32 that
//     changes only the order of rounding (fp32 ulps); in bf16, ex is rounded
//     to bf16 relative to the running max and rescaled in fp32, which
//     differs from JAX's rounding relative to the final max by at most a
//     bf16 step of ex (the bf16 bar absorbs it).  A warp owns its 16 rows'
//     every output column.  Dot fp32 at FI = 128: 189 KB; at FI = 256: 211
//     KB.  Add fp32 at FI = 128: 110 KB.
// - Outputs leave through shared memory, 16 bytes a thread.
// - The supported set: P <= 2048, f <= 256.
#pragma once

#include <type_traits>

#include "flash_mma.cuh"

namespace {

constexpr int kMaxP = 2048;

template <typename T>
struct DotScore {
  static constexpr bool kDot = true, kProject = false;
  const T* q;  // [B, P, H, f], pre-scaled
  const T* k;
};

struct AddScore {
  static constexpr bool kDot = false, kProject = false;
  const float* e_row;  // [B, P, H] fp32
  const float* e_col;
  float slope;  // of the leaky ReLU
};

template <typename T>
struct LayerScore {
  static constexpr bool kDot = true, kProject = true;
  const T* x;                 // [B, P, din]
  const T *wq, *wk, *wv;      // [H, din, f]
  const float *bq, *bk, *bv;  // [H, f] fp32
  int din, xvec;              // xvec: fill_bytes of din
  float scale;                // q's
};

template <typename T>
struct LayerAddScore {
  static constexpr bool kDot = false, kProject = true;
  const T* x;                        // [B, P, din]
  const T* w;                        // [H, din, f]
  const float *bias, *a_l, *a_r;     // [H, f] fp32
  int din, xvec;                     // xvec: fill_bytes of din
  float slope;                       // of the leaky ReLU
};

template <typename Score, typename T, int FI, int WARPS, int KT, bool WHOLE>
struct FwdCfg {
  static constexpr bool kDot = Score::kDot, kProject = Score::kProject;
  static constexpr int kThreads = WARPS * 32;
  static constexpr int kRows = WARPS * 16;  // query rows per block
  static constexpr int kStages = WHOLE || kProject ? 1 : 2;
  static constexpr int kMaxTiles = WHOLE ? 1 : kMaxP / KT;
  // ex (and at the end the output rows) over the Q rows' buffer, except in
  // the dot score's stream block, whose Q rows serve every key tile
  static constexpr bool kExInQ = WHOLE || !kDot;
  // Q rows (add: ex); ex rows (dot stream); K; V: row strides
  static constexpr int ldq = (kExInQ && KT > FI ? KT : FI) + pad_rm<T>();
  static constexpr int ldp = kExInQ ? ldq : KT + pad_rm<T>();
  static constexpr int ldk = FI + pad_rm<T>();
  static constexpr int ldv = FI + 8;
  static constexpr size_t q_elems = size_t(kRows) * ldq;
  static constexpr size_t p_elems = kExInQ ? 0 : size_t(kRows) * ldp;
  // dot whole: V replaces K in one buffer once the scores are formed
  static constexpr size_t k_elems = kDot ? size_t(kStages) * KT * (WHOLE ? ldv : ldk) : 0;
  static constexpr size_t v_elems = kDot && WHOLE ? 0 : size_t(kStages) * KT * ldv;
  // add: e_col of the graph, fp32 (layer add: of the block's one key tile,
  // and e_row of its query rows)
  static constexpr int kECols = kDot ? 0 : (WHOLE || kProject ? KT : kMaxP);
  static constexpr int kERows = !kDot && kProject ? kRows : 0;
  // whole: adj's edge bits of the block's rows, 16 keys a word
  static constexpr int kBitWords = WHOLE ? kRows * (KT / kGroup) : 0;
  // whole: l of the block's rows, for the warp pair that shares them
  static constexpr int kLRows = WHOLE ? kRows : 0;
  // layer: project_tile's ring, KC = 128 bytes of din a chunk in the whole
  // block, 64 in the stream block (whose tiles leave less room); a warp's
  // tile is 32 rows by 8 kNJ columns, and the widest pass is the one over the
  // fewest rows (Q: kRows, K and V: KT)
  static constexpr int kPK = (WHOLE ? 128 : 64) / int(sizeof(T));
  static constexpr int kNJ = WHOLE ? FI / 16 : (WARPS == 8 ? FI / 32 : 2);
  static constexpr int kPRows = kRows > KT ? kRows : KT;
  static constexpr int kPCols = kThreads * 8 * kNJ / (kRows < KT ? kRows : KT);
  static constexpr size_t px_elems = kProject ? size_t(2) * kPRows * (kPK + pad_rm<T>()) : 0;
  static constexpr size_t pw_elems = kProject ? size_t(2) * kPK * (kPCols + 8) : 0;
  static constexpr size_t bytes =
      sizeof(T) * (q_elems + p_elems + k_elems + v_elems + px_elems + pw_elems) +
      sizeof(float) * (kECols + kERows) + sizeof(uint32_t) * (size_t(WARPS) * kMaxTiles + kMaxTiles + WARPS) +
      sizeof(uint16_t) * kBitWords + sizeof(float) * kLRows;
};

template <typename Score, typename T, int FI, int WARPS, int KT, bool WHOLE>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(Score sc, const T* __restrict__ v, const uint8_t* __restrict__ adj,
                 const float* __restrict__ val, T* __restrict__ out, float* __restrict__ lse,
                 int B, int P, int H, int f, int vec, Dropout drop) {
  using C = FwdCfg<Score, T, FI, WARPS, KT, WHOLE>;
  constexpr bool kDot = C::kDot;
  constexpr int NTS = KT / 8;  // n-tiles of a score tile
  constexpr int NTO = FI / 8;  // n-tiles of the output rows
  constexpr int KS = kstep<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ps = C::kExInQ ? qs : qs + C::q_elems;
  T* ks = qs + C::q_elems + C::p_elems;
  T* vs = kDot && WHOLE ? ks : ks + C::k_elems;
  T* pxs = ks + C::k_elems + C::v_elems;  // layer: the projection's x and W ring
  T* pws = pxs + C::px_elems;
  float* ecs = reinterpret_cast<float*>(pws + C::pw_elems);  // add: [P] (layer add: [KT])
  float* ers = ecs + C::kECols;  // layer add: e_row of the block's rows, [kRows]
  // whole: adj's edge bits, [rows][KT / kGroup] 16-key words, 16-byte rows
  uint16_t* rbits = reinterpret_cast<uint16_t*>(ers + C::kERows);
  uint32_t* flags = reinterpret_cast<uint32_t*>(rbits + C::kBitWords);  // [WARPS][n_tiles]
  uint32_t* tmask = flags + WARPS * C::kMaxTiles;                       // [n_tiles]
  uint32_t* wlive = tmask + C::kMaxTiles;                               // [WARPS]
  float* lrow = reinterpret_cast<float*>(wlive + WARPS);                // whole: [rows]

  const int n_row_blocks = (P + C::kRows - 1) / C::kRows;
  const int rb = blockIdx.x % n_row_blocks;
  const int hh = (blockIdx.x / n_row_blocks) % H;
  const int b = blockIdx.x / (n_row_blocks * H);
  const int r0 = rb * C::kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long row_stride = long(H) * f;
  const long base = (long(b) * P * H + hh) * f;
  const long sbase = long(b) * P * H + hh;  // element (b, 0, hh) of a [B, P, H] scalar
  const uint8_t* adj_b = adj + long(b) * P * P;
  const float* val_b = val ? val + long(b) * P * P : nullptr;
  const int n_tiles = (P + KT - 1) / KT;
  const int n_groups = (P + kGroup - 1) / kGroup;

  if constexpr (!kDot && !C::kProject)
    for (int c = tid; c < P; c += C::kThreads) ecs[c] = sc.e_col[sbase + long(c) * H];
  for (int i = tid; i < WARPS * n_tiles; i += C::kThreads) flags[i] = 0u;
  for (int i = tid; i < C::kBitWords; i += C::kThreads) rbits[i] = 0;
  __syncthreads();
  scan_adj(adj_b, P, r0, C::kRows, 0, n_groups, tid, C::kThreads, flags,
           [&](int r, int gk, int& w, uint32_t& bit) {
             w = ((r - r0) / 16) * n_tiles + gk * kGroup / KT;
             bit = 1u << (gk % (KT / kGroup));
           },
           [&](int r, int gk, uint32_t bits) {
             if (WHOLE) rbits[(r - r0) * (KT / kGroup) + gk] = uint16_t(bits);
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
  // layer: rows [n0, n0 + R) of q (which 0), k (1) or v (2) into dst
  auto project = [&](auto rows, int which, int n0, uint32_t live, T* dst, int ld) {
    if constexpr (C::kProject && kDot) {
      const long wbase = long(hh) * sc.din * f;
      const T* w = which == 0 ? sc.wq : which == 1 ? sc.wk : sc.wv;
      const float* bias = (which == 0 ? sc.bq : which == 1 ? sc.bk : sc.bv) + long(hh) * f;
      project_tile<T, decltype(rows)::value, C::kNJ, WARPS, C::kPK>(
          sc.x, long(b) * P * sc.din, sc.din, sc.xvec, w + wbase, f, vec, bias,
          which == 0 ? sc.scale : 1.f, n0, P, live, dst, ld, pxs, pws, tid);
    }
  };
  // layer add: rows [n0, n0 + R) of z into dst, and their e_row, e_col into
  // erow, ecol (either may be null)
  auto project_z = [&](auto rows, int n0, uint32_t live, T* dst, int ld, float* erow,
                       float* ecol) {
    if constexpr (C::kProject && !kDot) {
      const long hf = long(hh) * f;
      project_tile_scores<T, decltype(rows)::value, C::kNJ, WARPS, C::kPK>(
          sc.x, long(b) * P * sc.din, sc.din, sc.xvec, sc.w + hf * sc.din, f, vec,
          sc.bias + hf, sc.a_l + hf, sc.a_r + hf, n0, P, live, dst, ld, pxs, pws, erow, ecol,
          tid);
    }
  };
  using KRows = std::integral_constant<int, KT>;
  // dot: K, and V too unless whole; add: V; layer add: z as V and its e_col
  // (whole: every node live as a row or a key, with e_row too)
  auto stage_kv = [&](int j, int st, bool with_v) {
    if constexpr (C::kProject && !kDot) {
      project_z(KRows{}, j * KT, WHOLE ? tmask[j] | qlive : tmask[j], vs, C::ldv,
                WHOLE ? ers : nullptr, ecs);
    } else if constexpr (C::kProject) {
      project(KRows{}, 1, j * KT, tmask[j], ks + size_t(st) * KT * C::ldk, C::ldk);
      if (with_v) project(KRows{}, 2, j * KT, tmask[j], vs + size_t(st) * KT * C::ldv, C::ldv);
    } else {
      if constexpr (kDot)
        stage_rows<T, FI>(sc.k, base, row_stride, j * KT, KT, P, f, vec, tmask[j],
                          ks + size_t(st) * KT * C::ldk, C::ldk, tid, C::kThreads);
      if (with_v || !kDot)
        stage_rows<T, FI>(v, base, row_stride, j * KT, KT, P, f, vec, tmask[j],
                          vs + size_t(st) * KT * C::ldv, C::ldv, tid, C::kThreads);
    }
  };

  const bool live_w = wlive[warp] != 0u;
  const int row_w = r0 + warp * 16;  // the warp's first query row
  const int kf = (f + KS - 1) / KS * KS;  // dot: depth of q . k^T past which q, k are 0
  const uint32_t fmask = (NTO >= 32 ? 0xffffffffu : (1u << NTO) - 1u) &
                         ((f + 7) / 8 >= 32 ? 0xffffffffu : (1u << ((f + 7) / 8)) - 1u);
  // ex . v: a warp of the stream block owns its 16 rows and every output
  // column; in the whole block, the warp pair (2p, 2p + 1) shares its 32 rows
  // and warp 2p + c owns output columns [c FI / 2, (c + 1) FI / 2) of both
  // m-tiles, so each V fragment is loaded (and, fp32, split) once for two
  // m-tiles
  constexpr int MT = WHOLE ? 2 : 1;
  constexpr int NTW = NTO / MT;  // n-tiles of a warp's output columns
  static_assert(!WHOLE || WARPS % 2 == 0, "the whole block pairs its warps");
  float o[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) zero_acc(o[mt]);
  float m_run[2] = {kDead, kDead}, l_run[2] = {0.f, 0.f};
  float er[2] = {0.f, 0.f};  // add: e_row of rows g and g + 8 of the warp
  if constexpr (!kDot && !C::kProject) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = row_w + g + 8 * h2;
      if (live_w && row < P) er[h2] = sc.e_row[sbase + long(row) * H];
    }
  }

  // dot: Q (the live warps' rows) and the first live key tile; add: its V;
  // layer add stream: e_row of the live warps' rows (their z, projected into
  // the ex rows, is not used), then z and e_col of the first live key tile
  if constexpr (C::kProject && kDot)
    project(std::integral_constant<int, C::kRows>{}, 0, r0, qlive, qs, C::ldq);
  else if constexpr (C::kProject && !WHOLE)
    project_z(std::integral_constant<int, C::kRows>{}, r0, qlive, qs, C::ldq, ers, nullptr);
  else if constexpr (kDot)
    stage_rows<T, FI>(sc.q, base, row_stride, r0, C::kRows, P, f, vec, qlive, qs, C::ldq, tid,
                      C::kThreads);
  int j = next_live(0);
  stage_kv(j, 0, !WHOLE);
  cp_async_commit();
  int st = 0;
  while (j < n_tiles) {
    const int jn = WHOLE ? n_tiles : next_live(j + 1);
    if (!WHOLE && !C::kProject) {
      if (jn < n_tiles) stage_kv(jn, st ^ 1, true);
      cp_async_commit();
    }
    if constexpr (kDot || C::kProject) {
      if (WHOLE || C::kProject)
        cp_async_wait<0>();  // Q and K (and V: layer stream) are in place
      else
        cp_async_wait<1>();  // Q and this tile's K and V have landed
      __syncthreads();
    }
    if constexpr (!kDot && C::kProject) {  // layer add: e_row of rows g and g + 8
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = row_w + g + 8 * h2;
        er[h2] = live_w && row < P ? ers[row - r0] : 0.f;
      }
    }
    const uint32_t gm = live_w ? flags[warp * n_tiles + j] : 0u;
    const T* kt = ks + size_t(st) * KT * C::ldk;
    const T* vt = vs + size_t(st) * KT * C::ldv;
    T* qw = qs + size_t(warp) * 16 * C::ldq;
    T* pw = ps + size_t(warp) * 16 * C::ldp;
    if (gm != 0u) {
      float s[NTS][4];
      if constexpr (kDot) zero_acc(s);
      const uint32_t nm = ntile_mask(gm);
      if constexpr (kDot)
        for (int k0 = 0; k0 < kf; k0 += KS)
          mma_step<NTS, false, true>(s, qw, C::ldq, kt, C::ldk, k0, 0, nm);
      // score, mask, scale by val, running max of rows g and g + 8.  Whole: the
      // block's one tile starts at key 0, and rows g and g + 8 keep their
      // edge bits in registers, 32 keys a word (rows and keys past P have
      // none)
      uint32_t ebits[2][WHOLE ? KT / 32 : 1];
      if constexpr (WHOLE) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const uint4* w = reinterpret_cast<const uint4*>(
              rbits + (warp * 16 + g + 8 * h2) * (KT / kGroup));
#pragma unroll
          for (int q4 = 0; q4 < KT / 128; ++q4) {
            const uint4 wq = w[q4];
            ebits[h2][4 * q4] = wq.x;
            ebits[h2][4 * q4 + 1] = wq.y;
            ebits[h2][4 * q4 + 2] = wq.z;
            ebits[h2][4 * q4 + 3] = wq.w;
          }
        }
      }
      float mx[2] = {kNegBig, kNegBig};
#pragma unroll
      for (int jj = 0; jj < NTS; ++jj) {
        float2 ec2 = make_float2(0.f, 0.f);  // add: e_col of keys kc, kc + 1
        if constexpr (!kDot)
          if ((nm >> jj) & 1u)  // layer add: ecs holds this tile's keys only
            ec2 = *reinterpret_cast<const float2*>(ecs + (C::kProject ? 0 : j * KT) + jj * 8 +
                                                   2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = g + (e >> 1) * 8, row = row_w + rr;
          const int kc = jj * 8 + 2 * t + (e & 1), key = j * KT + kc;
          bool edge;
          if constexpr (WHOLE)
            edge = (ebits[e >> 1][jj >> 2] >> (kc & 31)) & 1u;
          else
            edge = ((nm >> jj) & 1u) && row < P && key < P && adj_b[long(row) * P + key] != 0;
          float sv = kNegBig;
          if (edge) {
            float raw;
            if constexpr (kDot)
              raw = s[jj][e];
            else
              raw = leaky(er[e >> 1] + ((e & 1) ? ec2.y : ec2.x), sc.slope);
            sv = val_b ? raw * val_b[long(row) * P + key] : raw;
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
      if constexpr (!WHOLE)  // whole: one tile, so o is still 0
#pragma unroll
        for (int jj = 0; jj < NTO; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[0][jj][e] *= scale[e >> 1];
      __syncwarp();  // dot whole: every lane is done reading the warp's Q rows
      // ex of the live n-tiles, two keys a store; a dead n-tile's ex is 0,
      // adds nothing to l and is never read by ex . v
#pragma unroll
      for (int jj = 0; jj < NTS; ++jj) {
        if (!((nm >> jj) & 1u)) continue;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int rr = g + 8 * h2, kc = jj * 8 + 2 * t;
          float ex[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            ex[c] = expf(s[jj][2 * h2 + c] - m_run[h2]);
            l_run[h2] += ex[c];
            if (drop.on && ex[c] != 0.f)
              ex[c] *= drop.factor(b, P, row_w + rr, j * KT + kc + c, hh);
          }
          store_pair<T>(pw + rr * C::ldp + kc, ex[0], ex[1]);  // rounded to v's type, as in JAX
        }
      }
    }
    if (WHOLE) {
      if constexpr (kDot) {  // V over K, once every warp has its scores
        __syncthreads();
        if constexpr (C::kProject)
          project(KRows{}, 2, 0, tmask[j], vs, C::ldv);
        else
          stage_rows<T, FI>(v, base, row_stride, 0, KT, P, f, vec, tmask[j], vs, C::ldv, tid,
                            C::kThreads);
        cp_async_commit();
      }
      cp_async_wait<0>();  // V has landed
      __syncthreads();
    } else if constexpr (kDot) {
      __syncwarp();
    } else {
      cp_async_wait<1>();  // this tile's V has landed
      __syncthreads();
    }
    if constexpr (WHOLE) {
      // the pair's live groups, per m-tile (a dead warp's flags are 0, and a
      // live warp wrote ex only in its live groups)
      const int pr = warp >> 1, half = warp & 1;
      const uint32_t g0 = flags[(2 * pr) * n_tiles + j], g1 = flags[(2 * pr + 1) * n_tiles + j];
      const uint32_t hmask = (fmask >> (half * NTW)) & (NTW >= 32 ? 0xffffffffu : (1u << NTW) - 1u);
      const T* pp = ps + size_t(pr) * 32 * C::ldp;
#pragma unroll 1
      for (int gi = 0; gi < KT / kGroup; ++gi) {
        const uint32_t mts = ((g0 >> gi) & 1u) | (((g1 >> gi) & 1u) << 1);
        if (mts == 0u) continue;
#pragma unroll
        for (int k0 = gi * kGroup; k0 < (gi + 1) * kGroup; k0 += KS)
          mma_step2<NTW>(o, pp, C::ldp, vt, C::ldv, k0, half * (FI / 2), hmask, mts);
      }
    } else if (gm != 0u) {
#pragma unroll 1
      for (int gi = 0; gi < KT / kGroup; ++gi) {
        if (!((gm >> gi) & 1u)) continue;
#pragma unroll
        for (int k0 = gi * kGroup; k0 < (gi + 1) * kGroup; k0 += KS)
          mma_step<NTO, false, false>(o[0], pw, C::ldp, vt, C::ldv, k0, 0, fmask);
      }
    }
    __syncthreads();  // this stage's K, V and the ex tiles are free again
    j = jn;
    if constexpr (C::kProject) {  // layer stream: the next live tile into the one stage
      if (!WHOLE && j < n_tiles) stage_kv(j, 0, true);
    } else {
      st ^= 1;
    }
  }

  // rows g and g + 8 of the warp: l summed over the quad; out staged in the
  // Q (add: ex) rows, free once the last tile is done, and each warp's rows
  // stored coalesced
  T* qw = qs + size_t(warp) * 16 * C::ldq;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l_run[h2] += __shfl_xor_sync(0xffffffffu, l_run[h2], 1);
    l_run[h2] += __shfl_xor_sync(0xffffffffu, l_run[h2], 2);
    const int rr = g + 8 * h2, row = row_w + rr;
    const float l = l_run[h2];
    if constexpr (WHOLE) {
      if (t == 0) lrow[warp * 16 + rr] = l;
    } else {
      const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
      for (int jj = 0; jj < NTO; ++jj)
        store_pair<T>(qw + rr * C::ldq + jj * 8 + 2 * t, o[0][jj][2 * h2] * inv,
                      o[0][jj][2 * h2 + 1] * inv);
    }
    if (lse != nullptr && t == 0 && row < P)
      lse[(long(hh) * B + b) * P + row] = l > 0.f ? m_run[h2] + logf(l) : kNegBig;
  }
  if constexpr (WHOLE) {  // the pair's 32 rows, this warp's half of the columns
    __syncthreads();
    const int pr = warp >> 1, half = warp & 1;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int rb2 = pr * 32 + mt * 16 + g + 8 * h2;  // the row in the block
        const float l = lrow[rb2];
        const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
        for (int jj = 0; jj < NTW; ++jj)
          store_pair<T>(qs + size_t(rb2) * C::ldq + half * (FI / 2) + jj * 8 + 2 * t,
                        o[mt][jj][2 * h2] * inv, o[mt][jj][2 * h2 + 1] * inv);
      }
    __syncthreads();
  } else {
    __syncwarp();
  }
  store_tile<T>(qw, C::ldq, out, base, row_stride, row_w, 16, P, f, vec, lane, 32);
}

template <typename Score, typename T, int FI, int WARPS, int KT, bool WHOLE>
cudaError_t launch(Score sc, const void* v, const uint8_t* adj, const float* val, void* out,
                   float* lse, int B, int P, int H, int f, Dropout drop, cudaStream_t stream) {
  using C = FwdCfg<Score, T, FI, WARPS, KT, WHOLE>;
  static_assert(C::bytes <= 232448, "a block's shared memory must fit 227 KB");
  auto kernel = flash_fwd_kernel<Score, T, FI, WARPS, KT, WHOLE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::bytes));
  if (err != cudaSuccess) return err;
  const long n_blocks = long(B) * H * ((P + C::kRows - 1) / C::kRows);
  if (n_blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  const int vec = fill_bytes<T>(f);
  kernel<<<unsigned(n_blocks), C::kThreads, C::bytes, stream>>>(
      sc, static_cast<const T*>(v), adj, val, static_cast<T*>(out), lse, B, P, H, f, vec, drop);
  return cudaGetLastError();
}

template <typename Score, typename T, int FI>
cudaError_t launch_fi(Score sc, const void* v, const uint8_t* adj, const float* val, void* out,
                      float* lse, int B, int P, int H, int f, Dropout drop,
                      cudaStream_t stream) {
  if constexpr (FI <= 128) {
    if (P <= 128)
      return launch<Score, T, FI, 4, 128, true>(sc, v, adj, val, out, lse, B, P, H, f, drop,
                                                stream);
  }
  constexpr int KT = FI == 256 ? 32 : 64;
  return launch<Score, T, FI, 4, KT, false>(sc, v, adj, val, out, lse, B, P, H, f, drop, stream);
}

// Checks the shape and launches the forward of score policy `sc` for v of
// type T: 1 <= P <= kMaxP, 1 <= f <= 256.
template <typename Score, typename T>
cudaError_t flash_fwd(Score sc, const void* v, const uint8_t* adj, const float* val, void* out,
                      float* lse, int B, int P, int H, int f, Dropout drop,
                      cudaStream_t stream) {
  if (B < 1 || H < 1 || P < 1 || P > kMaxP || f < 1 || f > 256) return cudaErrorInvalidValue;
  if (f <= 32)
    return launch_fi<Score, T, 32>(sc, v, adj, val, out, lse, B, P, H, f, drop, stream);
  if (f <= 64)
    return launch_fi<Score, T, 64>(sc, v, adj, val, out, lse, B, P, H, f, drop, stream);
  if (f <= 128)
    return launch_fi<Score, T, 128>(sc, v, adj, val, out, lse, B, P, H, f, drop, stream);
  return launch_fi<Score, T, 256>(sc, v, adj, val, out, lse, B, P, H, f, drop, stream);
}

// The whole-layer kernels #5 and #6 (policy LayerScore<T> or
// LayerAddScore<T>): P <= 128 with FI <= 128 (every GT and GAT serving and
// training shape) takes the whole block of 8 warps over all 128 rows of one
// (graph, head), so each node is projected once; larger shapes the stream
// block, 8 warps over 128 query rows where the block fits (FI = 64, 128),
// else 4 over 64, each projecting the live key tiles as it reaches them.
template <typename Score, typename T, int FI>
cudaError_t launch_layer(const Score& sc, const uint8_t* adj, void* out, int B, int P, int H,
                         int f, Dropout drop, cudaStream_t stream) {
  if constexpr (FI <= 128) {
    if (P <= 128)
      return launch<Score, T, FI, 8, 128, true>(sc, nullptr, adj, nullptr, out, nullptr, B, P,
                                                H, f, drop, stream);
  }
  constexpr int KT = FI == 256 ? 32 : 64;
  constexpr int WARPS = FI == 64 || FI == 128 ? 8 : 4;
  return launch<Score, T, FI, WARPS, KT, false>(sc, nullptr, adj, nullptr, out, nullptr, B, P,
                                                H, f, drop, stream);
}

// Checks the shape and launches a whole-layer kernel: 1 <= P <= kMaxP,
// 1 <= f <= 256, din >= 1.
template <typename Score, typename T>
cudaError_t layer_fwd(const Score& sc, const uint8_t* adj, void* out, int B, int P, int H, int f,
                      Dropout drop, cudaStream_t stream) {
  if (B < 1 || H < 1 || P < 1 || P > kMaxP || f < 1 || f > 256 || sc.din < 1)
    return cudaErrorInvalidValue;
  if (f <= 32) return launch_layer<Score, T, 32>(sc, adj, out, B, P, H, f, drop, stream);
  if (f <= 64) return launch_layer<Score, T, 64>(sc, adj, out, B, P, H, f, drop, stream);
  if (f <= 128) return launch_layer<Score, T, 128>(sc, adj, out, B, P, H, f, drop, stream);
  return launch_layer<Score, T, 256>(sc, adj, out, B, P, H, f, drop, stream);
}

}  // namespace
