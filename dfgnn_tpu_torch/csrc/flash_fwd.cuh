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
// dropout).  v and out keep the JAX layout [B, P, h, f], any f >= 1: the
// staged tiles are zero past f up to the instantiated width FI (32, 64, 128
// or 256), which adds only 0 * 0 terms, and only f columns are stored.  Past
// 256 the head dim goes in chunks of FI columns (the last zero past f), the
// dot score's q . k^T summed over every chunk, each staged (#5: projected)
// through the same Q rows and K tile, so shared memory stays that of one
// chunk.  #1, #2 (FI = 256), #5 past P = 128 (FI = 256) and #6 (FI = 128)
// take the chunks as a grid axis, the block of chunk c writing out's columns
// [FI c, FI c + FI) (chunk 0's blocks also lse): every chunk re-forms the
// scores, and the dropout keep factor, a hash of global ids, is the same in
// each.  #5 at P <= 128 loops over them in its whole block (FI = 128), its
// scores formed once.  fp32 or bf16 v; fp32 softmax and sums; fp32 products
// as 3xTF32, or one TF32 pass with `one` (precision "default").
//
// The score policies:
// - DotScore (#1): s = q . k^T, q pre-scaled, q and k of v's type and shape.
//   A block stages its Q rows and a K tile, and the scores are an mma
//   product.
// - AddScore (#2): s = leaky_relu(e_row[r] + e_col[c]) from fp32 [B, P, h]
//   scalars read through their strides.  A block stages e_col of the
//   window of keys it walks (at most kWinKeys floats) and keeps e_row of a
//   thread's two fragment rows (g, g + 8) in registers; each score is formed
//   straight in the C-fragment layout, with no product and no K tile.
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
// - Past f = 256 #5 and #6 run their wide policies, LayerScoreWide and
//   LayerAddWide (layer_fwd says how, and flash_layer_dot.cu and
//   flash_layer_add.cu why).
// - Any P: the stream block takes its keys in windows of kWinKeys, scanning
//   adj, flagging the live tiles and (#2, wide #6) staging e_col one window
//   at a time, with the online softmax running on across windows, so its
//   shared memory does not grow with P.  At P <= kWinKeys there is one
//   window, and the block runs as it did before windows.
// - The supported set: any P >= 1 and f >= 1 whose tensors fit the card.
#pragma once

#include <type_traits>

#include "flash_mma.cuh"

namespace {

// keys a stream block scans, flags and (#2, wide #6) keeps e_col of at a time
constexpr int kWinKeys = 2048;

// kChunked: the wide policies (#5 and #6 past f = 256), whose head dim goes
// in chunks of FI columns
template <typename T>
struct DotScore {
  static constexpr bool kDot = true, kProject = false, kChunked = false;
  const T* q;  // [B, P, H, f], pre-scaled
  const T* k;
};

struct AddScore {
  static constexpr bool kDot = false, kProject = false, kChunked = false;
  const float* e_row;  // [B, P, H] fp32
  const float* e_col;
  float slope;  // of the leaky ReLU
};

template <typename T>
struct LayerScore {
  static constexpr bool kDot = true, kProject = true, kChunked = false;
  const T* x;                 // [B, P, din]
  const T *wq, *wk, *wv;      // [H, din, f]
  const float *bq, *bk, *bv;  // [H, f] fp32
  int din, xvec;              // xvec: fill_bytes of din
  float scale;                // q's
};

template <typename T>
struct LayerAddScore {
  static constexpr bool kDot = false, kProject = true, kChunked = false;
  const T* x;                        // [B, P, din]
  const T* w;                        // [H, din, f]
  const float *bias, *a_l, *a_r;     // [H, f] fp32
  int din, xvec;                     // xvec: fill_bytes of din
  float slope;                       // of the leaky ReLU
};

// #5 past f = 256: LayerScore with q, k and v projected chunk by chunk
template <typename T>
struct LayerScoreWide : LayerScore<T> {
  static constexpr bool kChunked = true;
};

// #6 past f = 256: AddScore's scalars, formed by layer_scalars_kernel before
// the launch, with v = z projected in the kernel, chunk by chunk
template <typename T>
struct LayerAddWide {
  static constexpr bool kDot = false, kProject = true, kChunked = true;
  const float* e_row;  // [B, P, H] fp32: e_l
  const float* e_col;  // e_r
  float slope;
  const T* x;          // [B, P, din]
  const T* w;          // [H, din, f]
  const float* bias;   // [H, f] fp32
  int din, xvec;
};

template <typename Score, typename T, int FI, int WARPS, int KT, bool WHOLE>
struct FwdCfg {
  static constexpr bool kDot = Score::kDot, kProject = Score::kProject;
  // head dims past FI: a grid axis over chunks of FI columns (kGrid: #1 and
  // #2 in the stream block, wide #5 in the stream block, wide #6), or a loop
  // over them in the block (kLoop: wide #5's whole block)
  static constexpr bool kLoop = Score::kChunked && WHOLE && kDot;
  static constexpr bool kGrid = (!WHOLE && !kProject) || (Score::kChunked && !kLoop);
  // add: e_row and e_col read from fp32 [B, P, H] (#2, wide #6), not formed
  // in the block (#6)
  static constexpr bool kReadE = !kDot && (!kProject || Score::kChunked);
  static constexpr int kThreads = WARPS * 32;
  static constexpr int kRows = WARPS * 16;  // query rows per block
  static constexpr int kStages = WHOLE || kProject ? 1 : 2;
  static constexpr int kMaxTiles = WHOLE ? 1 : kWinKeys / KT;  // tiles a window
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
  // add: e_col of the window's keys, fp32 (layer add: of the block's one key
  // tile, and e_row of its query rows)
  static constexpr int kECols = kDot ? 0 : (WHOLE || !kReadE ? KT : kWinKeys);
  static constexpr int kERows = !kDot && !kReadE ? kRows : 0;
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
      sizeof(float) * (kECols + kERows) +
      sizeof(uint32_t) * (size_t(WARPS) * kMaxTiles + kMaxTiles + WARPS) +
      sizeof(uint16_t) * kBitWords + sizeof(float) * kLRows;
};

template <typename Score, typename T, int FI, int WARPS, int KT, bool WHOLE, bool ONE>
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
  float* ecs = reinterpret_cast<float*>(pws + C::pw_elems);  // add: [window keys] (layer add: [KT])
  float* ers = ecs + C::kECols;  // layer add: e_row of the block's rows, [kRows]
  // whole: adj's edge bits, [rows][KT / kGroup] 16-key words, 16-byte rows
  uint16_t* rbits = reinterpret_cast<uint16_t*>(ers + C::kERows);
  uint32_t* flags = reinterpret_cast<uint32_t*>(rbits + C::kBitWords);  // [WARPS][window tiles]
  uint32_t* tmask = flags + WARPS * C::kMaxTiles;                       // [window tiles]
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
  // whole: P <= KT, a constant 1, so the window loop below folds away (as a
  // runtime 1 it cost the whole block up to half again its time, PERF.md
  // section 6)
  const int n_tiles = WHOLE ? 1 : (P + KT - 1) / KT;
  // wide heads (kGrid): blockIdx.y is the block's chunk of FI columns of v
  // and out, fv its width; chunk 0's blocks write lse.  nc chunks (kLoop:
  // the block's own)
  const int nc = C::kGrid || C::kLoop ? (f + FI - 1) / FI : 1;
  const int col0 = C::kGrid ? int(blockIdx.y) * FI : 0;
  const int fv = C::kGrid ? min(FI, f - col0) : f;
  const long vbase = base + col0;
  if (col0 != 0) lse = nullptr;

  // The keys go in windows of kMaxTiles tiles (kWinKeys keys; the whole
  // block's one tile is one window): per window the block scans its adj
  // rows over the window's keys, flags the live tiles and walks them, the
  // online softmax running on across windows, so shared memory does not
  // grow with P.  j0 and nt: the window's first tile and its tile count;
  // qlive: the warps with an edge in the window; qdone: those whose Q rows
  // (add: e_row) are in place
  int j0 = 0, nt = 1;
  uint32_t qlive = 0, qdone = 0;
  bool live_w = false;
  auto next_live = [&](int j) {
    while (j < j0 + nt && tmask[j - j0] == 0u) ++j;
    return j;
  };
  // the 16-key groups of tile j in which warp w's rows have an edge
  auto flag = [&](int w, int j) { return flags[w * nt + j - j0]; };
  // layer: rows [n0, n0 + R) of q (which 0), k (1) or v (2; wide #6: z)
  // into dst, columns [c0, c0 + FI) of the head (c0 = 0 unless wide)
  auto project = [&](auto rows, int which, int n0, uint32_t live, T* dst, int ld, int c0) {
    if constexpr (C::kProject && (kDot || C::kReadE)) {
      const long wbase = long(hh) * sc.din * f + c0;
      const T* w;
      const float* bias;
      float scale = 1.f;
      if constexpr (kDot) {
        w = which == 0 ? sc.wq : which == 1 ? sc.wk : sc.wv;
        bias = which == 0 ? sc.bq : which == 1 ? sc.bk : sc.bv;
        if (which == 0) scale = sc.scale;
      } else {
        w = sc.w;
        bias = sc.bias;
      }
      project_tile<T, decltype(rows)::value, C::kNJ, WARPS, C::kPK, ONE>(
          sc.x, long(b) * P * sc.din, sc.din, sc.xvec, w + wbase, f, min(FI, f - c0), vec,
          bias + long(hh) * f + c0, scale, n0, P, live, dst, ld, pxs, pws, tid);
    }
  };
  // layer add: rows [n0, n0 + R) of z into dst, and their e_row, e_col into
  // erow, ecol (either may be null)
  auto project_z = [&](auto rows, int n0, uint32_t live, T* dst, int ld, float* erow,
                       float* ecol) {
    if constexpr (C::kProject && !kDot && !C::kReadE) {
      const long hf = long(hh) * f;
      project_tile_scores<T, decltype(rows)::value, C::kNJ, WARPS, C::kPK, ONE>(
          sc.x, long(b) * P * sc.din, sc.din, sc.xvec, sc.w + hf * sc.din, f, f, vec,
          sc.bias + hf, sc.a_l + hf, sc.a_r + hf, n0, P, live, dst, ld, pxs, pws, erow, ecol,
          tid);
    }
  };
  using KRows = std::integral_constant<int, KT>;
  using QRows = std::integral_constant<int, C::kRows>;
  // dot: K (wide: staged chunk by chunk with Q in the loop over the chunks),
  // and V too unless whole (wide: V's own chunk); add: V; layer add: z as V
  // and its e_col (whole: every node live as a row or a key, with e_row
  // too); wide layer add: z's chunk as V
  auto stage_kv = [&](int j, int st, bool with_v) {
    const uint32_t live = tmask[j - j0];
    if constexpr (C::kProject && !kDot && !C::kReadE) {
      project_z(KRows{}, j * KT, WHOLE ? live | qlive : live, vs, C::ldv, WHOLE ? ers : nullptr,
                ecs);
    } else if constexpr (C::kProject && !kDot) {
      project(KRows{}, 2, j * KT, live, vs, C::ldv, col0);
    } else if constexpr (C::kProject) {
      if constexpr (!Score::kChunked)
        project(KRows{}, 1, j * KT, live, ks + size_t(st) * KT * C::ldk, C::ldk, 0);
      if (with_v)
        project(KRows{}, 2, j * KT, live, vs + size_t(st) * KT * C::ldv, C::ldv, col0);
    } else {
      if constexpr (kDot) {
        if (nc == 1)
          stage_rows<T, FI>(sc.k, base, row_stride, j * KT, KT, P, f, vec, live,
                            ks + size_t(st) * KT * C::ldk, C::ldk, tid, C::kThreads);
      }
      if (with_v || !kDot)
        stage_rows<T, FI>(v, vbase, row_stride, j * KT, KT, P, fv, vec, live,
                          vs + size_t(st) * KT * C::ldv, C::ldv, tid, C::kThreads);
    }
  };

  const int row_w = r0 + warp * 16;  // the warp's first query row
  const int kf = (f + KS - 1) / KS * KS;  // dot: depth of q . k^T past which q, k are 0
  const uint32_t fmask = (NTO >= 32 ? 0xffffffffu : (1u << NTO) - 1u) &
                         ((fv + 7) / 8 >= 32 ? 0xffffffffu : (1u << ((fv + 7) / 8)) - 1u);
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
  if constexpr (C::kReadE) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = row_w + g + 8 * h2;
      if (row < P) er[h2] = sc.e_row[sbase + long(row) * H];
    }
  }

  int st = 0;
  for (int w0 = 0; w0 < n_tiles; w0 += C::kMaxTiles) {
    if (w0 > 0) __syncthreads();  // the last window's flags and e_col are free
    j0 = w0;
    nt = min(C::kMaxTiles, n_tiles - w0);
    const int key0 = j0 * KT;  // the window's first key
    if constexpr (C::kReadE)
      for (int c = tid; c < min(nt * KT, P - key0); c += C::kThreads)
        ecs[c] = sc.e_col[sbase + long(key0 + c) * H];
    for (int i = tid; i < WARPS * nt; i += C::kThreads) flags[i] = 0u;
    for (int i = tid; i < C::kBitWords; i += C::kThreads) rbits[i] = 0;
    __syncthreads();
    scan_adj(adj_b, P, r0, C::kRows, key0, (min(nt * KT, P - key0) + kGroup - 1) / kGroup, tid,
             C::kThreads, flags,
             [&](int r, int gk, int& w, uint32_t& bit) {
               w = ((r - r0) / 16) * nt + gk * kGroup / KT;
               bit = 1u << (gk % (KT / kGroup));
             },
             [&](int r, int gk, uint32_t bits) {
               if (WHOLE) rbits[(r - r0) * (KT / kGroup) + gk] = uint16_t(bits);
             });
    __syncthreads();
    bool any = false;
    for (int j = tid; j < nt; j += C::kThreads) {
      uint32_t m = 0;
      for (int w = 0; w < WARPS; ++w) m |= flags[w * nt + j];
      tmask[j] = m;
      any |= m != 0u;
    }
    if (tid < WARPS) {
      uint32_t m = 0;
      for (int j = 0; j < nt; ++j) m |= flags[tid * nt + j];
      wlive[tid] = m != 0u;
    }
    if (!__syncthreads_or(any)) {  // no edge in the block's rows over the window's keys
      if (n_tiles > C::kMaxTiles) continue;  // the epilogue writes out = 0, lse = -1e30
      for (int i = tid; i < C::kRows * fv; i += C::kThreads) {
        const int r = r0 + i / fv;
        if (r < P) out[vbase + long(r) * row_stride + i % fv] = from_f32<T>(0.f);
      }
      if (lse != nullptr)
        for (int r = r0 + tid; r < min(P, r0 + C::kRows); r += C::kThreads)
          lse[(long(hh) * B + b) * P + r] = kNegBig;
      return;
    }

    qlive = 0;
    for (int w = 0; w < WARPS; ++w) qlive |= wlive[w] << w;
    live_w = wlive[warp] != 0u;
    const uint32_t qnew = qlive & ~qdone;  // the live warps whose rows are not yet in place
    qdone |= qnew;
    // dot: Q (the new live warps' rows; wide: chunk by chunk with K in the
    // loop over the chunks) and the window's first live key tile; add: its
    // V; layer add stream: e_row of the new live warps' rows (their z,
    // projected into the ex rows, is not used), then z and e_col of the first
    // live key tile
    if constexpr (C::kProject && kDot) {
      if constexpr (!Score::kChunked) project(QRows{}, 0, r0, qnew, qs, C::ldq, 0);
    } else if constexpr (C::kProject && !WHOLE && !C::kReadE) {
      project_z(QRows{}, r0, qnew, qs, C::ldq, ers, nullptr);
    } else if constexpr (kDot) {
      if (nc == 1)
        stage_rows<T, FI>(sc.q, base, row_stride, r0, C::kRows, P, f, vec, qnew, qs, C::ldq,
                          tid, C::kThreads);
    }
    int j = next_live(j0);
    stage_kv(j, st, !WHOLE);
    cp_async_commit();
    while (j < j0 + nt) {
      const int jn = WHOLE ? j0 + nt : next_live(j + 1);
      if (!WHOLE && !C::kProject) {
        if (jn < j0 + nt) stage_kv(jn, st ^ 1, true);
        cp_async_commit();
      }
      if constexpr (kDot || C::kProject) {
        if (WHOLE || C::kProject)
          cp_async_wait<0>();  // Q and K (and V: layer stream) are in place
        else
          cp_async_wait<1>();  // Q and this tile's K and V have landed
        __syncthreads();
      }
      if constexpr (!kDot && !C::kReadE) {  // layer add: e_row of rows g and g + 8
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int row = row_w + g + 8 * h2;
          er[h2] = live_w && row < P ? ers[row - r0] : 0.f;
        }
      }
      const uint32_t gm = live_w ? flag(warp, j) : 0u;
      const T* kt = ks + size_t(st) * KT * C::ldk;
      const T* vt = vs + size_t(st) * KT * C::ldv;
      T* qw = qs + size_t(warp) * 16 * C::ldq;
      T* pw = ps + size_t(warp) * 16 * C::ldp;
      const uint32_t nm = ntile_mask(gm);
      float s[NTS][4];
      if constexpr (kDot) zero_acc(s);
      if constexpr (kDot && (C::kGrid || C::kLoop)) {
        // wide: q . k^T summed over the chunks of FI columns, each chunk's Q
        // rows and K tile staged (layer: projected) into the one Q buffer and
        // this stage's K tile
        for (int cc = 0; cc < (nc > 1 || Score::kChunked ? nc : 0); ++cc) {
          const int fc = min(FI, f - cc * FI);
          if constexpr (C::kProject) {
            project(QRows{}, 0, r0, qlive, qs, C::ldq, cc * FI);
            project(KRows{}, 1, j * KT, tmask[j - j0], ks + size_t(st) * KT * C::ldk, C::ldk,
                    cc * FI);
          } else {
            stage_rows<T, FI>(sc.q, base + cc * FI, row_stride, r0, C::kRows, P, fc, vec, qlive,
                              qs, C::ldq, tid, C::kThreads);
            stage_rows<T, FI>(sc.k, base + cc * FI, row_stride, j * KT, KT, P, fc, vec,
                              tmask[j - j0], ks + size_t(st) * KT * C::ldk, C::ldk, tid,
                              C::kThreads);
            cp_async_commit();
            cp_async_wait<0>();
          }
          __syncthreads();
          if (gm != 0u)
            for (int k0 = 0; k0 < fc; k0 += KS)
              mma_step<NTS, false, true, ONE>(s, qw, C::ldq, kt, C::ldk, k0, 0, nm);
          __syncthreads();  // the Q rows and the K tile are free again
        }
      }
      if (gm != 0u) {
        if constexpr (kDot && !Score::kChunked) {
          if (nc == 1)
            for (int k0 = 0; k0 < kf; k0 += KS)
              mma_step<NTS, false, true, ONE>(s, qw, C::ldq, kt, C::ldk, k0, 0, nm);
        }
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
              ec2 = *reinterpret_cast<const float2*>(
                  ecs + (C::kReadE ? (j - j0) * KT : 0) + jj * 8 + 2 * t);
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
      if constexpr (C::kLoop) {
        // wide #5's whole block: the one key tile has made l final, so each
        // chunk of FI output columns in turn projects V's chunk over K, sums
        // ex . V_c in the warp pairs and leaves through the V buffer
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float l = l_run[h2];
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          if (t == 0) lrow[warp * 16 + g + 8 * h2] = l;
        }
        const int pr = warp >> 1, half = warp & 1;
        const uint32_t g0 = flag(2 * pr, j), g1 = flag(2 * pr + 1, j);
        const T* pp = ps + size_t(pr) * 32 * C::ldp;
#pragma unroll 1
        for (int c0 = 0; c0 < f; c0 += FI) {
          const int fo = min(FI, f - c0), nt = (fo + 7) / 8;  // out's columns and n-tiles
          const uint32_t hmask = ((nt >= 32 ? 0xffffffffu : (1u << nt) - 1u) >> (half * NTW)) &
                                 (NTW >= 32 ? 0xffffffffu : (1u << NTW) - 1u);
          __syncthreads();  // ex and lrow are in place, or the last chunk's out has left
          project(KRows{}, 2, 0, tmask[0], vs, C::ldv, c0);
          __syncthreads();
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) zero_acc(o[mt]);
#pragma unroll 1
          for (int gi = 0; gi < KT / kGroup; ++gi) {
            const uint32_t mts = ((g0 >> gi) & 1u) | (((g1 >> gi) & 1u) << 1);
            if (mts == 0u) continue;
#pragma unroll
            for (int k0 = gi * kGroup; k0 < (gi + 1) * kGroup; k0 += KS)
              mma_step2<NTW, ONE>(o, pp, C::ldp, vs, C::ldv, k0, half * (FI / 2), hmask, mts);
          }
          __syncthreads();  // V is read
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int rb2 = pr * 32 + mt * 16 + g + 8 * h2;  // the row in the block
              const float l = lrow[rb2];
              const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
              for (int jj = 0; jj < NTW; ++jj)
                store_pair<T>(vs + size_t(rb2) * C::ldv + half * (FI / 2) + jj * 8 + 2 * t,
                              o[mt][jj][2 * h2] * inv, o[mt][jj][2 * h2 + 1] * inv);
            }
          __syncthreads();
          store_tile<T>(vs + size_t(warp) * 16 * C::ldv, C::ldv, out, base + c0, row_stride, row_w,
                        16, P, fo, vec, lane, 32);
        }
        return;
      }
      if (WHOLE) {
        if constexpr (kDot) {  // V over K, once every warp has its scores
          __syncthreads();
          if constexpr (C::kProject)
            project(KRows{}, 2, 0, tmask[0], vs, C::ldv, 0);
          else
            stage_rows<T, FI>(v, base, row_stride, 0, KT, P, f, vec, tmask[0], vs, C::ldv, tid,
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
        const uint32_t g0 = flag(2 * pr, j), g1 = flag(2 * pr + 1, j);
        const uint32_t hmask =
            (fmask >> (half * NTW)) & (NTW >= 32 ? 0xffffffffu : (1u << NTW) - 1u);
        const T* pp = ps + size_t(pr) * 32 * C::ldp;
#pragma unroll 1
        for (int gi = 0; gi < KT / kGroup; ++gi) {
          const uint32_t mts = ((g0 >> gi) & 1u) | (((g1 >> gi) & 1u) << 1);
          if (mts == 0u) continue;
#pragma unroll
          for (int k0 = gi * kGroup; k0 < (gi + 1) * kGroup; k0 += KS)
            mma_step2<NTW, ONE>(o, pp, C::ldp, vt, C::ldv, k0, half * (FI / 2), hmask, mts);
        }
      } else if (gm != 0u) {
#pragma unroll 1
        for (int gi = 0; gi < KT / kGroup; ++gi) {
          if (!((gm >> gi) & 1u)) continue;
#pragma unroll
          for (int k0 = gi * kGroup; k0 < (gi + 1) * kGroup; k0 += KS)
            mma_step<NTO, false, false, ONE>(o[0], pw, C::ldp, vt, C::ldv, k0, 0, fmask);
        }
      }
      __syncthreads();  // this stage's K, V and the ex tiles are free again
      j = jn;
      if constexpr (C::kProject) {  // layer stream: the next live tile into the one stage
        if (!WHOLE && j < j0 + nt) stage_kv(j, 0, true);
      } else {
        st ^= 1;
      }
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
  store_tile<T>(qw, C::ldq, out, vbase, row_stride, row_w, 16, P, fv, vec, lane, 32);
}

template <typename Score, typename T, int FI, int WARPS, int KT, bool WHOLE, bool ONE>
cudaError_t launch_as(Score sc, const void* v, const uint8_t* adj, const float* val, void* out,
                      float* lse, int B, int P, int H, int f, Dropout drop,
                      cudaStream_t stream) {
  using C = FwdCfg<Score, T, FI, WARPS, KT, WHOLE>;
  static_assert(C::bytes <= 232448, "a block's shared memory must fit 227 KB");
  auto kernel = flash_fwd_kernel<Score, T, FI, WARPS, KT, WHOLE, ONE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::bytes));
  if (err != cudaSuccess) return err;
  const long n_blocks = long(B) * H * ((P + C::kRows - 1) / C::kRows);
  const int nc = (f + FI - 1) / FI;  // chunks of FI columns: 1 but for the wide heads
  if (n_blocks > 0x7fffffffL || nc > 65535 || (!C::kGrid && !C::kLoop && nc > 1))
    return cudaErrorInvalidValue;
  const int vec = fill_bytes<T>(f);
  kernel<<<dim3(unsigned(n_blocks), unsigned(C::kGrid ? nc : 1)), C::kThreads, C::bytes,
           stream>>>(
      sc, static_cast<const T*>(v), adj, val, static_cast<T*>(out), lse, B, P, H, f, vec, drop);
  return cudaGetLastError();
}

// launch_as with the products' precision: `one` (one TF32 pass) only for fp32
template <typename Score, typename T, int FI, int WARPS, int KT, bool WHOLE>
cudaError_t launch(Score sc, const void* v, const uint8_t* adj, const float* val, void* out,
                   float* lse, int B, int P, int H, int f, Dropout drop, bool one,
                   cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float>) {
    if (one)
      return launch_as<Score, T, FI, WARPS, KT, WHOLE, true>(sc, v, adj, val, out, lse, B, P, H,
                                                             f, drop, stream);
  }
  return launch_as<Score, T, FI, WARPS, KT, WHOLE, false>(sc, v, adj, val, out, lse, B, P, H, f,
                                                          drop, stream);
}

template <typename Score, typename T, int FI>
cudaError_t launch_fi(Score sc, const void* v, const uint8_t* adj, const float* val, void* out,
                      float* lse, int B, int P, int H, int f, Dropout drop, bool one,
                      cudaStream_t stream) {
  if constexpr (FI <= 128) {
    if (P <= 128)
      return launch<Score, T, FI, 4, 128, true>(sc, v, adj, val, out, lse, B, P, H, f, drop,
                                                one, stream);
  }
  constexpr int KT = FI == 256 ? 32 : 64;
  return launch<Score, T, FI, 4, KT, false>(sc, v, adj, val, out, lse, B, P, H, f, drop, one,
                                            stream);
}

// Checks the shape and launches the forward of score policy `sc` (#1 or #2)
// for v of type T: P >= 1, f >= 1 (past 256 in chunks of 256).
template <typename Score, typename T>
cudaError_t flash_fwd(Score sc, const void* v, const uint8_t* adj, const float* val, void* out,
                      float* lse, int B, int P, int H, int f, Dropout drop, bool one,
                      cudaStream_t stream) {
  if (B < 1 || H < 1 || P < 1 || f < 1) return cudaErrorInvalidValue;
  if (f <= 32)
    return launch_fi<Score, T, 32>(sc, v, adj, val, out, lse, B, P, H, f, drop, one, stream);
  if (f <= 64)
    return launch_fi<Score, T, 64>(sc, v, adj, val, out, lse, B, P, H, f, drop, one, stream);
  if (f <= 128)
    return launch_fi<Score, T, 128>(sc, v, adj, val, out, lse, B, P, H, f, drop, one, stream);
  return launch_fi<Score, T, 256>(sc, v, adj, val, out, lse, B, P, H, f, drop, one, stream);
}

// The whole-layer kernels #5 and #6 up to f = 256 (policy LayerScore<T> or
// LayerAddScore<T>): P <= 128 with FI <= 128 (every GT and GAT serving and
// training shape at f <= 128) takes the whole block of 8 warps over all 128
// rows of one (graph, head), so each node is projected once; larger shapes
// the stream block, 8 warps over 128 query rows where the block fits (FI =
// 64, 128), else 4 over 64, each projecting the live key tiles as it
// reaches them.
template <typename Score, typename T, int FI>
cudaError_t launch_layer(const Score& sc, const uint8_t* adj, void* out, int B, int P, int H,
                         int f, Dropout drop, bool one, cudaStream_t stream) {
  if constexpr (FI <= 128) {
    if (P <= 128)
      return launch<Score, T, FI, 8, 128, true>(sc, nullptr, adj, nullptr, out, nullptr, B, P,
                                                H, f, drop, one, stream);
  }
  constexpr int KT = FI == 256 ? 32 : 64;
  constexpr int WARPS = FI == 64 || FI == 128 ? 8 : 4;
  return launch<Score, T, FI, WARPS, KT, false>(sc, nullptr, adj, nullptr, out, nullptr, B, P,
                                                H, f, drop, one, stream);
}

// Checks the shape and launches a whole-layer kernel: P >= 1, din >= 1,
// and 1 <= f <= 256, or any f >= 1 for the wide policies (LayerScoreWide,
// LayerAddWide), which go in chunks of FI columns: at
// P <= 128 in the whole block at FI = 128 (wide #5 loops over the chunks
// with the scores formed once; wide #6 takes them as a grid axis, each chunk
// re-forming its cheap scores from the scalars), past it in the stream block
// with a grid axis over the chunks (#5: #1's FI = 256 block, re-forming q .
// k^T from every chunk of each key tile; #6: FI = 128 on 8 warps).
template <typename Score, typename T>
cudaError_t layer_fwd(const Score& sc, const uint8_t* adj, void* out, int B, int P, int H, int f,
                      Dropout drop, bool one, cudaStream_t stream) {
  if (B < 1 || H < 1 || P < 1 || f < 1 || sc.din < 1 || (!Score::kChunked && f > 256))
    return cudaErrorInvalidValue;
  if constexpr (Score::kChunked) {
    if (P <= 128)
      return launch<Score, T, 128, 8, 128, true>(sc, nullptr, adj, nullptr, out, nullptr, B, P,
                                                 H, f, drop, one, stream);
    if constexpr (Score::kDot)
      return launch<Score, T, 256, 4, 32, false>(sc, nullptr, adj, nullptr, out, nullptr, B, P,
                                                 H, f, drop, one, stream);
    else
      return launch<Score, T, 128, 8, 64, false>(sc, nullptr, adj, nullptr, out, nullptr, B, P,
                                                 H, f, drop, one, stream);
  } else {
    if (f <= 32) return launch_layer<Score, T, 32>(sc, adj, out, B, P, H, f, drop, one, stream);
    if (f <= 64) return launch_layer<Score, T, 64>(sc, adj, out, B, P, H, f, drop, one, stream);
    if (f <= 128)
      return launch_layer<Score, T, 128>(sc, adj, out, B, P, H, f, drop, one, stream);
    return launch_layer<Score, T, 256>(sc, adj, out, B, P, H, f, drop, one, stream);
  }
}

}  // namespace
