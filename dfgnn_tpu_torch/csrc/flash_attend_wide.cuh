// The wide attention block of kernels #1 (flash_mask_fwd.cu), #2
// (flash_add_fwd.cu) and #5 (flash_layer_dot.cu) past head dim 256, for
// Hopper (sm_90a), hand-written CUDA on the tensor cores.  It computes, for
// every graph b and head h of a DenseBatch, kernel #1's or #2's function
// (flash_fwd.cuh's head has the formulas):
//   s   = q . k^T (DotScore) or leaky_relu(e_row[r] + e_col[c]) (AddScore),
//         times val[b] when edge values are given; adj[b] ? s : -1e30
//   ex  = exp(s - m), l = rowsum(ex) (the undropped ex), m the row max
//   out = (round_to<T>(ex * keep) . v) / l, 0 for an empty row
//   lse = l > 0 ? m + log(l) : -1e30, optional, [h, B, P] fp32
// keep is the edge-hash dropout factor of flash_common.cuh (1 without).
//
// What bounds it on an H100 SXM (data-sheet peaks): at 1024 x 1 x 128 x 512
// (B x h x P x f, fp32, chip_smoke.py's inputs) the bytes of q, k, v, adj
// read and out, lse written take 0.26 ms at 3.35 TB/s; the dot score's two
// products on the dense [P, P] blocks, 34.4 GFLOP as 3xTF32 (a third of
// 495 TFLOP/s), 0.21 ms; the additive score's one product 0.10 ms.  Device
// memory bounds both on paper; with mma.sync the products bound them here.
//
// Design.  One block of 16 warps (one block an SM, the warps hiding each
// other's latency) takes 64 query rows and up to kAttCols = 512 columns of
// out, every one in registers (64 fp32 accumulators a thread at 512
// columns), so each score is formed once for all of them; past 512 a grid
// axis over groups of 512 columns, each group's blocks forming the same
// scores in the same order, so group 0's lse (the only one written) is each
// group's normalisation bitwise.  Per live key tile of 64 keys:
// - scores (dot): s = q . k^T summed over chunks of 128 bytes of q and k
//   (a warp: 16 rows by one 16-key group; a warp whose rows and keys hold
//   no edge skips its products), staged through a two-stage cp.async ring,
//   while the tile's V rows arrive a 16-key group a chunk; the raw scores
//   go to shared memory.  (add): no q or k: V's live 16-key groups are
//   staged first and land while the softmax threads form each score from
//   e_row (a register) and e_col (staged per window);
// - the online softmax, 8 threads a row: edge mask, edge values, the running
//   max, l of the undropped ex, then ex times the dropout factor (the hash
//   runs here, outside the accumulators' registers), rounded to v's type
//   over the scores, and each row's rescale factor;
// - each warp rescales and adds ex . V: the warp pair's 32 rows by an eighth
//   of the block's columns, skipping the 16-key groups without an edge.
// Keys go in windows of kWinKeys (adj scanned, live tiles flagged, e_col
// staged a window at a time), so shared memory does not grow with P: fp32
// dot 184 KB, add 156 KB; bf16 dot 119 KB, add 91 KB; one block an SM.
// Where q, k and v lie is the caller's (WideRows): #1's and #2's own [B, P,
// h, f] tensors, rows of any alignment (staged at the widest cp.async width
// the row keeps, by f, with the columns past f zero-filled), or #5's
// projected scratch [3, B, Pp, h, Fp], zero past f and 16-byte aligned.
// fp32 products as 3xTF32 or, with ONE, one TF32 pass; bf16 with fp32 sums.
// Registers: 16 warps on one SM leave 128 a thread, 64 of them out's
// accumulators; ptxas reports the 16-byte-aligned fp32 dot block at 128
// registers with 172 bytes of spill stores (chip_smoke.py prints the rest).
#pragma once

#include "flash_mma.cuh"

namespace {

// keys a stream block scans, flags and (#2, wide #6) keeps e_col of at a time
constexpr int kWinKeys = 2048;

// The score policies of #1 and #2 (and of #5's wide attention): q . k^T, or
// leaky_relu(e_row[r] + e_col[c]).  kProject and kChunked are flash_fwd.cuh's.
template <typename T>
struct DotScore {
  static constexpr bool kDot = true, kProject = false, kChunked = false;
  const T* q;  // [B, P, H, f], pre-scaled (the wide block: laid out as WideRows says)
  const T* k;
};

struct AddScore {
  static constexpr bool kDot = false, kProject = false, kChunked = false;
  const float* e_row;  // [B, P, H] fp32
  const float* e_col;
  float slope;  // of the leaky ReLU
};

// Where the wide block reads q, k and v: element (b, r, head, c) at
// b * graph + r * row + head * head_off + c.  Columns at or past `cols` are
// not read (staged as zeros); `vec` is the cp.async width every row keeps
// (fill_bytes).  #1 and #2: [B, P, H, f], cols f; #5's scratch: [B, Pp, H,
// Fp] planes, cols Fp (zeros past f in memory), vec 16.
struct WideRows {
  long graph, row;
  int head_off, cols, vec;
};

// query rows a block, keys a tile, columns of out a block (its
// accumulators: kAttRows x kAttCols fp32 over kAttThreads threads)
constexpr int kAttRows = 64, kAttKeys = 64, kAttCols = 512;
constexpr int kAttThreads = 512;  // 16 warps

template <typename Score, typename T>
struct AttendCfg {
  static constexpr bool kDot = Score::kDot;
  static constexpr int kCK = 128 / int(sizeof(T));  // columns of q and k a chunk
  static constexpr int ldc = kCK + pad_rm<T>();     // q, k chunks: read along their rows
  static constexpr int ldv = kAttCols + 8;          // V: read across its rows
  static constexpr int lds = kAttKeys + 4;          // fp32 scores; ex (T) over them
  static constexpr int ldp = lds * 4 / int(sizeof(T));
  static constexpr int kMaxTiles = kWinKeys / kAttKeys;  // key tiles a window
  static constexpr int kStages = 2;  // dot: the q and k chunks' cp.async ring
  static constexpr size_t q_elems = kDot ? size_t(kStages) * kAttRows * ldc : 0;
  static constexpr size_t k_elems = kDot ? size_t(kStages) * kAttKeys * ldc : 0;
  static constexpr size_t v_elems = size_t(kAttKeys) * ldv;
  static constexpr int kECols = kDot ? 0 : kWinKeys;  // add: e_col of the window's keys
  static constexpr size_t bytes = sizeof(T) * (q_elems + k_elems + v_elems) +
                                  sizeof(float) * (kAttRows * lds + 2 * kAttRows + kECols) +
                                  sizeof(uint32_t) * 5 * kMaxTiles;
};

// kAttRows query rows of one (graph, head) and columns [kAttCols blockIdx.y,
// + kAttCols) of out (the file's head says how).  lse is written by the
// blocks of column group 0 only.  ALIGNED: every row of q, k and v keeps
// 16-byte alignment (lay.vec is 16), a compile-time fact, so the staging
// compiles to 16-byte copies alone (with lay.vec read at run time, the other
// widths' paths cost the block registers and spills).
template <typename Score, typename T, bool ONE, bool ALIGNED>
__global__ void __launch_bounds__(kAttThreads, 1)
attend_wide_kernel(Score sc, const T* __restrict__ v, WideRows lay,
                   const uint8_t* __restrict__ adj, const float* __restrict__ val,
                   T* __restrict__ out, float* __restrict__ lse, int B, int P, int H, int f,
                   Dropout drop) {
  using C = AttendCfg<Score, T>;
  constexpr bool kDot = C::kDot;
  constexpr int KT = kAttKeys, NTW = kAttCols / 64, KS = kstep<T>();
  constexpr int NTH = kAttThreads;
  const int vec = ALIGNED ? 16 : lay.vec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qc = reinterpret_cast<T*>(smem_raw);  // dot: [stages][rows][ldc]: q chunks
  T* kc = qc + C::q_elems;                 // dot: [stages][KT][ldc]: k chunks
  T* vt = kc + C::k_elems;                 // [KT][ldv]: V of the tile; at the end out
  float* sb = reinterpret_cast<float*>(vt + C::v_elems);  // [rows][lds]: scores
  T* ex = reinterpret_cast<T*>(sb);                        // [rows][ldp]: ex, over them
  float* rs = sb + kAttRows * C::lds;                      // [rows]: rescale factors
  float* lrow = rs + kAttRows;                             // [rows]: l
  float* ecs = lrow + kAttRows;                            // add: [window keys]: e_col
  uint32_t* flags = reinterpret_cast<uint32_t*>(ecs + C::kECols);  // [4][window tiles]
  uint32_t* tmask = flags + 4 * C::kMaxTiles;                      // [window tiles]

  const int n_rb = (P + kAttRows - 1) / kAttRows;
  const int rb = blockIdx.x % n_rb, hh = (blockIdx.x / n_rb) % H, b = blockIdx.x / (n_rb * H);
  const int r0 = rb * kAttRows;
  const int col0 = int(blockIdx.y) * kAttCols, fw = min(kAttCols, f - col0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long base = long(b) * lay.graph + long(hh) * lay.head_off;  // element (b, 0, hh, 0)
  const long ebase = long(b) * P * H + hh;  // element (b, 0, hh) of a [B, P, H] scalar
  const uint8_t* adj_b = adj + long(b) * P * P;
  const int n_tiles = (P + KT - 1) / KT;
  const int nck = (f + C::kCK - 1) / C::kCK;  // > KT / kGroup past f = 256
  // scores: warp (smt, sg) forms rows 16 smt.. by the tile's 16-key group
  // sg; ex . v: warp (pr, c8) accumulates rows 32 pr.. by its eighth of the
  // block's n-tiles, ntw of them from column n0
  const int smt = warp & 3, sg = warp >> 2;
  const int pr = warp & 1, c8 = warp >> 1;
  const int ntg = (fw + 7) / 8, ntw = (ntg + 7) / 8, n0 = c8 * ntw * 8;
  const int mine = max(0, min(ntw, ntg - c8 * ntw));
  const uint32_t nmask = (1u << mine) - 1u;  // mine <= NTW = 8
  // the softmax: thread (sr, sq) takes keys 8 sq.. of row sr of each tile
  const int sr = tid >> 3, sq = tid & 7, row = r0 + sr;
  float er = 0.f;  // add: e_row of the thread's row
  if constexpr (!kDot)
    if (row < P) er = sc.e_row[ebase + long(row) * H];
  float m_run = kDead, l_part = 0.f;
  float o[2][NTW][4];
  zero_acc(o[0]);
  zero_acc(o[1]);

  for (int w0 = 0; w0 < n_tiles; w0 += C::kMaxTiles) {
    if (w0 > 0) __syncthreads();  // the last window's flags and e_col are free
    const int nt = min(C::kMaxTiles, n_tiles - w0), key0 = w0 * KT;
    if constexpr (!kDot)
      for (int c = tid; c < min(nt * KT, P - key0); c += NTH)
        ecs[c] = sc.e_col[ebase + long(key0 + c) * H];
    for (int i = tid; i < 4 * nt; i += NTH) flags[i] = 0u;
    __syncthreads();
    scan_adj(adj_b, P, r0, kAttRows, key0, (min(nt * KT, P - key0) + kGroup - 1) / kGroup, tid,
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
    for (int jt = 0; jt < nt; ++jt) {
      const uint32_t live = tmask[jt];  // the tile's 16-key groups with an edge
      if (live == 0u) continue;
      const int j = w0 + jt;
      const T* vb = v + base + col0;  // the block's columns of V
      const int vcols = min(kAttCols, lay.cols - col0);
      if constexpr (kDot) {
        uint32_t qm = 0u;  // the m-tiles with an edge in the tile
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) qm |= uint32_t(flags[mt * nt + jt] != 0u) << mt;
        // chunk c of q's rows and k's keys into slot st, and (c < 4) V's
        // 16-key group c of the block's columns
        auto stage = [&](int c, int st) {
          const long cb = base + long(c) * C::kCK;
          const int cols = lay.cols - c * C::kCK;
          stage_rows<T, C::kCK>(sc.q, cb, lay.row, r0, kAttRows, P, cols, vec, qm,
                                qc + size_t(st) * kAttRows * C::ldc, C::ldc, tid, NTH);
          stage_rows<T, C::kCK>(sc.k, cb, lay.row, j * KT, KT, P, cols, vec, live,
                                kc + size_t(st) * KT * C::ldc, C::ldc, tid, NTH);
          if (c < KT / kGroup)
            stage_rows<T, kAttCols>(vb, 0, lay.row, j * KT + c * kGroup, kGroup, P, vcols, vec,
                                    (live >> c) & 1u, vt + size_t(c) * kGroup * C::ldv, C::ldv,
                                    tid, NTH);
        };
        float s[2][4];
        zero_acc(s);
        const bool on = (flags[smt * nt + jt] >> sg) & 1u;  // the warp's rows and keys meet
        // two slots: chunk c + 1 is in flight while chunk c is multiplied
        // (a third slot, 202 KB in fp32, left less L1 for the spills and ran
        // slower, as did one barrier a chunk with chunk c + 1 staged only
        // once chunk c had landed)
        stage(0, 0);
        cp_async_commit();
#pragma unroll 1
        for (int c = 0; c < nck; ++c) {
          if (c + 1 < nck) stage(c + 1, (c + 1) & 1);
          cp_async_commit();
          cp_async_wait<1>();
          __syncthreads();
          if (on) {
            const int sl = c & 1;
            const T* qa = qc + size_t(sl) * kAttRows * C::ldc + size_t(smt) * 16 * C::ldc;
            const T* kb = kc + size_t(sl) * KT * C::ldc + size_t(sg) * 16 * C::ldc;
#pragma unroll
            for (int k0 = 0; k0 < C::kCK; k0 += KS)
              mma_step<2, false, true, ONE>(s, qa, C::ldc, kb, C::ldc, k0, 0, 3u);
          }
          __syncthreads();  // this slot is free again
        }
        if (on)  // the warp's raw scores; the softmax threads mask them
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2)
              *reinterpret_cast<float2*>(sb + (smt * 16 + g + 8 * h2) * C::lds + sg * 16 +
                                         jj * 8 + 2 * t) =
                  make_float2(s[jj][2 * h2], s[jj][2 * h2 + 1]);
        __syncthreads();
      } else {
        // V's live 16-key groups, landing while the scores and ex are formed
        stage_rows<T, kAttCols>(vb, 0, lay.row, j * KT, KT, P, vcols, vec, live, vt, C::ldv, tid,
                                NTH);
        cp_async_commit();
      }
      {  // the online softmax of row sr over the tile: ex and the rescale factor
        const int k8 = j * KT + sq * 8;  // the thread's first key
        const long e8 = long(row) * P + k8;  // its (row, key) in adj[b] and val[b]
        // bit i: key k8 + i is an edge of the row (read only where the row's
        // m-tile has an edge in the keys' 16-key group)
        uint32_t em = 0u;
        if (row < P && ((flags[(sr >> 4) * nt + jt] >> (sq >> 1)) & 1u)) {
          if ((P & 7) == 0 && k8 < P) {  // all 8 keys below P, 8-byte aligned
            const uint2 w = *reinterpret_cast<const uint2*>(adj_b + e8);
            em = byte_bits(w.x) | byte_bits(w.y) << 4;
          } else {
            for (int i = 0; i < 8 && k8 + i < P; ++i) em |= uint32_t(adj_b[e8 + i] != 0) << i;
          }
        }
        float x[8], mx = kNegBig;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float sv = kNegBig;
          if ((em >> i) & 1u) {
            if constexpr (kDot)
              sv = sb[sr * C::lds + sq * 8 + i];
            else
              sv = leaky(er + ecs[k8 + i - key0], sc.slope);
            if (val != nullptr) sv *= val[long(b) * P * P + e8 + i];
          }
          x[i] = sv;
          mx = fmaxf(mx, sv);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m_run, mx);
        const float scale = expf(m_run - m_new);
        m_run = m_new;
        l_part *= scale;
        if constexpr (kDot && sizeof(T) != 4) __syncthreads();  // ex overlays other threads' scores
        T* ep = ex + sr * C::ldp + sq * 8;
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          float e[2] = {expf(x[i] - m_new), expf(x[i + 1] - m_new)};
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            l_part += e[c];
            if (drop.on && e[c] != 0.f) e[c] *= drop.factor(b, P, row, k8 + i + c, hh);
          }
          store_pair<T>(ep + i, e[0], e[1]);  // rounded to v's type, as in JAX
        }
        if (sq == 0) rs[sr] = scale;
      }
      if constexpr (!kDot) cp_async_wait<0>();  // V has landed
      __syncthreads();
      // o rescaled, then o += ex . V over the pair's live 16-key groups
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float f2 = rs[pr * 32 + mt * 16 + g + 8 * h2];
#pragma unroll
          for (int jj = 0; jj < NTW; ++jj) {
            o[mt][jj][2 * h2] *= f2;
            o[mt][jj][2 * h2 + 1] *= f2;
          }
        }
      if (nmask != 0u) {
        const uint32_t f0 = flags[2 * pr * nt + jt], f1 = flags[(2 * pr + 1) * nt + jt];
        const T* pp = ex + size_t(pr) * 32 * C::ldp;
#pragma unroll 1
        for (int gi = 0; gi < KT / kGroup; ++gi) {
          const uint32_t mts = ((f0 >> gi) & 1u) | (((f1 >> gi) & 1u) << 1);
          if (mts == 0u) continue;
#pragma unroll
          for (int k0 = gi * kGroup; k0 < (gi + 1) * kGroup; k0 += KS)
            mma_step2<NTW, ONE>(o, pp, C::ldp, vt, C::ldv, k0, n0, nmask, mts);
        }
      }
      __syncthreads();  // V, ex and the rescale factors are free again
    }
  }

  // l of row sr over its 8 threads (every group sums the same terms in the
  // same order, so group 0's lse is each group's); out = o / l staged in V's
  // rows, stored coalesced
  float l = l_part;
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  l += __shfl_xor_sync(0xffffffffu, l, 4);
  if (sq == 0) {
    lrow[sr] = l;
    if (lse != nullptr && blockIdx.y == 0 && row < P)
      lse[(long(hh) * B + b) * P + row] = l > 0.f ? m_run + logf(l) : kNegBig;
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int rr = pr * 32 + mt * 16 + g + 8 * h2;
      const float lr = lrow[rr];
      const float inv = lr > 0.f ? 1.f / lr : 0.f;
#pragma unroll
      for (int jj = 0; jj < NTW; ++jj)
        if ((nmask >> jj) & 1u)
          store_pair<T>(vt + size_t(rr) * C::ldv + n0 + jj * 8 + 2 * t, o[mt][jj][2 * h2] * inv,
                        o[mt][jj][2 * h2 + 1] * inv);
    }
  __syncthreads();
  store_tile<T>(vt, C::ldv, out, (long(b) * P * H + hh) * f + col0, long(H) * f, r0, kAttRows, P,
                fw, fill_bytes<T>(f), tid, NTH);
}

// Launches the wide block on q, k (sc) and v as `lay` lays them out: one
// block per 64 query rows of each (graph, head), a grid axis over groups of
// kAttCols columns of out [B, P, H, f].  P >= 1, f >= 1; ALIGNED needs
// lay.vec 16.
template <typename Score, typename T, bool ONE, bool ALIGNED>
cudaError_t launch_attend_wide(Score sc, const T* v, WideRows lay, const uint8_t* adj,
                               const float* val, T* out, float* lse, int B, int P, int H, int f,
                               Dropout drop, cudaStream_t stream) {
  using C = AttendCfg<Score, T>;
  static_assert(C::bytes <= 232448, "a block's shared memory must fit 227 KB");
  const long n_blocks = long(B) * H * ((P + kAttRows - 1) / kAttRows);
  const int n_groups = (f + kAttCols - 1) / kAttCols;
  // the dot score stages V's 16-key groups with its first KT / kGroup chunks
  const bool few = C::kDot && (f + C::kCK - 1) / C::kCK < kAttKeys / kGroup;
  if (n_blocks > 0x7fffffffL || n_groups > 65535 || few || (ALIGNED && lay.vec != 16))
    return cudaErrorInvalidValue;
  auto kernel = attend_wide_kernel<Score, T, ONE, ALIGNED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(unsigned(n_blocks), unsigned(n_groups)), kAttThreads, C::bytes, stream>>>(
      sc, v, lay, adj, val, out, lse, B, P, H, f, drop);
  return cudaGetLastError();
}

}  // namespace
