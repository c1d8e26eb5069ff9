// The whole graph-transformer layer in one kernel: q, k, v projections and
// masked dot-score attention, for Hopper (sm_90a), hand-written CUDA on the
// tensor cores: kernel #5.
//
// Replaces dfgnn_tpu/ops/pallas/flash_mask.py::_layer_kernel_dot (:508),
// driven there by _layer_fwd (:534).  For every graph b and head h of a
// DenseBatch, from node features x [B, P, din] and the head's weights
// W_q, W_k, W_v [H, din, f] (in x's type) and biases b_q, b_k, b_v [H, f]
// (fp32):
//   q = round_to<T>((x . W_q + b_q) * scale), k = round_to<T>(x . W_k + b_k),
//   v = round_to<T>(x . W_v + b_v)             products summed in fp32
//   then kernel #1's function: s = adj[b] ? q . k^T : -1e30,
//   m = max(rowmax(s), -0.5e30), ex = exp(s - m), l = rowsum(ex),
//   out = (round_to<T>(ex) . v) / l            an empty row gives exactly 0
// out is [B, P, H, f] in x's type (the node-major layout of kernel #1).  No
// edge values, no dropout and no lse, as in the Pallas kernel.  fp32 or bf16,
// any P >= 1, any f >= 1 (tiles zero past f up to the instantiated width
// 32, 64, 128 or 256; past 256 in chunks of that width), any din >= 1.  fp32
// products as 3xTF32, or one TF32 pass (precision "default"), the
// projections too.
//
// What bounds it on an H100 SXM (data-sheet peaks): the three projections,
// 3 * 2 * din * f operations per node and head, and the two attention
// products on the edges, 4 * f per edge and head.  At the table's shape
// (B=1024, H=1, P=128, din=f=128, about 6.0M edges) that is 12.9 + 3.1 GFLOP
// as 3xTF32 on the tensor cores (a third of 495 TFLOP/s: 0.097 ms) in fp32,
// or at 989 TFLOP/s in bf16, against 151 MB of x, the weights and adj read
// and out written (0.045 ms at 3.35 TB/s): operations bound it in fp32.
//
// Design.  The kernel this replaces did everything as fp32 FMAs on the
// CUDA cores, over every entry of the dense [P, P] block, and held K and V
// of all P nodes in one block's shared memory (so it stopped at P = 164 in
// fp32 at f = 128).  Here the attention is #1's own body (flash_fwd.cuh)
// with the LayerScore policy: where #1 copies q, k and v tiles in by
// cp.async, this kernel projects them on the tensor cores (project_tile,
// flash_mma.cuh: mma.sync, 3xTF32 in fp32 with each k-step's products summed
// apart, bf16 with fp32 sums; x and W stream through a cp.async ring, W from
// L2, where the B*H blocks share it).  Padding is skipped before any
// projection: the block scans adj first, projects q only for its 16-row
// tiles that hold an edge and k, v only for the 16-key groups some row
// attends to; a block without an edge writes zeros.  Two block shapes:
// - whole (P <= 128, f <= 128: every GT serving and training shape): 8 warps
//   over all 128 rows of one (graph, head), so k and v are projected once;
//   #1's whole body: the exact row max, V projected over K once the scores
//   are formed, ex over the Q rows (fp32 at f = 128: 212 KB, one block an
//   SM; bf16 144 KB);
// - stream (P > 128, or f > 128): #1's stream block, walking key tiles with
//   the online softmax; it projects each live key tile's K and V as it
//   reaches it, into one stage, so nothing of the graph stays resident; its
//   keys go in windows of 2048 (flash_fwd.cuh), so every P fits (fp32 at
//   f = 256: 164 KB).  K and V are
//   projected once per query block: 8 warps over 128 rows at f = 64 and
//   128, 4 warps over 64 rows at f = 32 and 256.
// Past f = 256 the head goes in chunks, so shared memory stays bounded:
// - whole (P <= 128, LayerScoreWide, FI = 128): the block forms the fp32
//   scores once, in registers, projecting each chunk of Q and K once into
//   the Q and K buffers and adding its products; after the exact softmax,
//   each chunk of out in turn projects V's chunk over K, sums ex . V_c in the
//   warp pairs and leaves through the V buffer.  q, k and v are each
//   projected once per (graph, head), as at f <= 128 (fp32 212 KB, bf16
//   144 KB);
// - past P = 128 (layer_dot_wide), two launches.  layer_project_kernel
//   projects q (pre-scaled), k and v of every live node once into a scratch
//   [3, B, Pp, H, Fp] of x's type (Pp: P rounded up to 16; Fp: f rounded up
//   to 128, the columns past f zeros), with the whole block's projection
//   (project_tile: 8 warps over 128 nodes, one of q, k, v a block; 70 KB).
//   "Live" follows adj: a node whose 16-node group has an edge as a row (q)
//   or as a key (k, v); nothing else is written or read.  Then
//   layer_attend_wide_kernel, 16 warps, takes 64 query rows and up to 512
//   columns of out a block (past 512 a grid axis over groups of 512
//   columns, each group's blocks forming the scores again: once per 512
//   columns).  Per live key tile of 64 keys it sums s = q . k^T over chunks
//   of 128 bytes of q and k staged in turn through a two-stage cp.async ring
//   (a warp: 16 rows by one 16-key group), while the tile's V rows of the
//   block's columns arrive a 16-key group a chunk; the masked scores go to
//   shared memory, where the online softmax runs per row (8 threads a row),
//   leaving ex (rounded to x's type) and each row's rescale factor; then each
//   warp rescales and adds ex . V into its accumulators: the warp pair's 32
//   rows by an eighth of the block's columns, every column of out in
//   registers (64 a thread at 512 columns).  Scores are formed once per (row
//   block, key tile) for every output column up to 512, and each node is
//   projected once per (graph, head) (fp32 184 KB, bf16 119 KB: one block an
//   SM).  The projection is 3 * 2 * din * f operations a node against the
//   attention's 4 * f an edge: at 64 x 1 x 512 x 512, din 512, 51.5 GFLOP
//   against at most 34.4 on dense blocks.

#include "flash_fwd.cuh"

namespace {

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The scratch of wide #5 past P = 128: q, k, v [3, B, Pp, H, Fp] of x's
// type, Pp = round_up(P, kGroup), Fp = round_up(f, kProjCols)
constexpr int kProjRows = 128;  // nodes a projection block takes
constexpr int kProjCols = 128;  // columns a projection pass writes, zeros past f
// layer_attend_wide_kernel: query rows a block, keys a tile, columns of out
// a block (its accumulators: kAttRows x kAttCols fp32 over 256 threads)
constexpr int kAttRows = 64, kAttKeys = 64, kAttCols = 512;
constexpr int kAttThreads = 512;  // 16 warps

// Launch 1 of wide #5 past P = 128: q (which 0, times the scale), k (1) or
// v (2, blockIdx.y) of kProjRows nodes of one (graph, head) into the
// scratch, for the 16-node groups with an edge as a row (q) or as a key (k,
// v); the other rows are neither projected nor written.
template <typename T, bool ONE>
__global__ void __launch_bounds__(256)
layer_project_kernel(LayerScore<T> sc, const uint8_t* __restrict__ adj, T* __restrict__ qkv, int B,
                     int P, int H, int f, int wvec) {
  constexpr int R = kProjRows, WARPS = 8, KC = 128 / int(sizeof(T));
  constexpr int NJ = 8;  // a warp's tile 32 x 64: passes of kProjCols columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* ws = xs + 2 * R * (KC + pad_rm<T>());
  uint32_t* live = reinterpret_cast<uint32_t*>(ws + 2 * KC * (kProjCols + 8));
  const int which = blockIdx.y;
  const int n_nb = (P + R - 1) / R;
  const int n0 = (blockIdx.x % n_nb) * R, hh = (blockIdx.x / n_nb) % H;
  const int b = blockIdx.x / (n_nb * H), tid = threadIdx.x;
  const int Pp = round_up(P, kGroup), Fp = round_up(f, kProjCols);
  const uint8_t* adj_b = adj + long(b) * P * P;
  if (tid == 0) *live = 0u;
  __syncthreads();
  auto none = [](int, int, uint32_t) {};
  if (which == 0)  // the groups with an edge as rows
    scan_adj(adj_b, P, n0, R, 0, (P + kGroup - 1) / kGroup, tid, WARPS * 32, live,
             [&](int r, int, int& w, uint32_t& bit) {
               w = 0;
               bit = 1u << ((r - n0) / kGroup);
             },
             none);
  else  // as keys
    scan_adj(adj_b, P, 0, P, n0, (min(R, P - n0) + kGroup - 1) / kGroup, tid, WARPS * 32, live,
             [&](int, int gk, int& w, uint32_t& bit) {
               w = 0;
               bit = 1u << gk;
             },
             none);
  __syncthreads();
  const uint32_t lv = *live;
  if (lv == 0u) return;
  const T* w = which == 0 ? sc.wq : which == 1 ? sc.wk : sc.wv;
  const float* bias = which == 0 ? sc.bq : which == 1 ? sc.bk : sc.bv;
  const long ld = long(H) * Fp;
  T* dst = qkv + long(which) * B * Pp * ld + (long(b) * Pp + n0) * ld + long(hh) * Fp;
  project_tile<T, R, NJ, WARPS, KC, ONE>(sc.x, long(b) * P * sc.din, sc.din, sc.xvec,
                                         w + long(hh) * sc.din * f, f, f, wvec,
                                         bias + long(hh) * f, which == 0 ? sc.scale : 1.f, n0, P,
                                         lv, dst, int(ld), xs, ws, tid);
}

template <typename T>
struct AttendCfg {
  static constexpr int kCK = 128 / int(sizeof(T));  // columns of q and k a chunk
  static constexpr int ldc = kCK + pad_rm<T>();     // q, k chunks: read along their rows
  static constexpr int ldv = kAttCols + 8;          // V: read across its rows
  static constexpr int lds = kAttKeys + 4;          // fp32 scores; ex (T) over them
  static constexpr int ldp = lds * 4 / int(sizeof(T));
  static constexpr int kMaxTiles = kWinKeys / kAttKeys;  // key tiles a window
  static constexpr size_t q_elems = size_t(2) * kAttRows * ldc;
  static constexpr size_t k_elems = size_t(2) * kAttKeys * ldc;
  static constexpr size_t v_elems = size_t(kAttKeys) * ldv;
  static constexpr size_t bytes = sizeof(T) * (q_elems + k_elems + v_elems) +
                                  sizeof(float) * (kAttRows * lds + 2 * kAttRows) +
                                  sizeof(uint32_t) * 5 * kMaxTiles;
};

// Launch 2 of wide #5 past P = 128: kernel #1's function on the projected
// q, k, v of the scratch, for kAttRows query rows and columns [kAttCols
// blockIdx.y, + kAttCols) of out (the file's head says how).
template <typename T, bool ONE>
__global__ void __launch_bounds__(kAttThreads, 1)
layer_attend_wide_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ adj,
                         T* __restrict__ out, int B, int P, int H, int f, int vec) {
  using C = AttendCfg<T>;
  constexpr int KT = kAttKeys, NTW = kAttCols / 64, KS = kstep<T>();
  constexpr int NTH = kAttThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qc = reinterpret_cast<T*>(smem_raw);  // [2][rows][ldc]: q chunks
  T* kc = qc + C::q_elems;                 // [2][KT][ldc]: k chunks
  T* vt = kc + C::k_elems;                 // [KT][ldv]: V of the tile; at the end out
  float* sb = reinterpret_cast<float*>(vt + C::v_elems);  // [rows][lds]: scores
  T* ex = reinterpret_cast<T*>(sb);                        // [rows][ldp]: ex, over them
  float* rs = sb + kAttRows * C::lds;                      // [rows]: rescale factors
  float* lrow = rs + kAttRows;                             // [rows]: l
  uint32_t* flags = reinterpret_cast<uint32_t*>(lrow + kAttRows);  // [4][window tiles]
  uint32_t* tmask = flags + 4 * C::kMaxTiles;                      // [window tiles]

  const int Pp = round_up(P, kGroup), Fp = round_up(f, kProjCols);
  const int n_rb = (P + kAttRows - 1) / kAttRows;
  const int rb = blockIdx.x % n_rb, hh = (blockIdx.x / n_rb) % H, b = blockIdx.x / (n_rb * H);
  const int r0 = rb * kAttRows;
  const int col0 = int(blockIdx.y) * kAttCols, fw = min(kAttCols, f - col0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long srow = long(H) * Fp;  // the scratch's row stride
  const long plane = long(B) * Pp * srow;
  const long sbase = long(b) * Pp * srow + long(hh) * Fp;  // element (b, 0, hh, 0)
  const T* q = qkv;
  const T* k = qkv + plane;
  const T* v = qkv + 2 * plane;
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
  const int sr = tid >> 3, sq = tid & 7;
  float m_run = kDead, l_part = 0.f;
  float o[2][NTW][4];
  zero_acc(o[0]);
  zero_acc(o[1]);

  for (int w0 = 0; w0 < n_tiles; w0 += C::kMaxTiles) {
    if (w0 > 0) __syncthreads();  // the last window's flags are free
    const int nt = min(C::kMaxTiles, n_tiles - w0), key0 = w0 * KT;
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
      uint32_t qm = 0u;  // the m-tiles with an edge in the tile
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) qm |= uint32_t(flags[mt * nt + jt] != 0u) << mt;
      // chunk c of q's rows and k's keys into slot st, and (c < 4) V's 16-key
      // group c of the block's columns
      auto stage = [&](int c, int st) {
        const long cb = sbase + long(c) * C::kCK;
        stage_rows<T, C::kCK>(q, cb, srow, r0, kAttRows, P, C::kCK, 16, qm,
                              qc + size_t(st) * kAttRows * C::ldc, C::ldc, tid, NTH);
        stage_rows<T, C::kCK>(k, cb, srow, j * KT, KT, P, C::kCK, 16, live,
                              kc + size_t(st) * KT * C::ldc, C::ldc, tid, NTH);
        if (c < KT / kGroup)
          stage_rows<T, kAttCols>(v, sbase + col0, srow, j * KT + c * kGroup, kGroup, P,
                                  min(kAttCols, Fp - col0), 16, (live >> c) & 1u,
                                  vt + size_t(c) * kGroup * C::ldv, C::ldv, tid, NTH);
      };
      float s[2][4];
      zero_acc(s);
      const bool on = (flags[smt * nt + jt] >> sg) & 1u;  // the warp's rows and keys meet
      stage(0, 0);
      cp_async_commit();
#pragma unroll 1
      for (int c = 0; c < nck; ++c) {
        if (c + 1 < nck) stage(c + 1, (c + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        if (on) {
          const T* qa = qc + size_t(c & 1) * kAttRows * C::ldc + size_t(smt) * 16 * C::ldc;
          const T* kb = kc + size_t(c & 1) * KT * C::ldc + size_t(sg) * 16 * C::ldc;
#pragma unroll
          for (int k0 = 0; k0 < C::kCK; k0 += KS)
            mma_step<2, false, true, ONE>(s, qa, C::ldc, kb, C::ldc, k0, 0, 3u);
        }
        __syncthreads();  // this slot is free again
      }
      // the warp's masked scores
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = smt * 16 + g + 8 * (e >> 1), row = r0 + rr;
          const int kk = sg * 16 + jj * 8 + 2 * t + (e & 1), key = j * KT + kk;
          const bool edge = on && row < P && key < P && adj_b[long(row) * P + key] != 0;
          sb[rr * C::lds + kk] = edge ? s[jj][e] : kNegBig;
        }
      __syncthreads();
      {  // the online softmax of row sr over the tile: ex and the rescale factor
        float x[8];
        const float* sp = sb + sr * C::lds + sq * 8;
        float mx = kNegBig;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          x[i] = sp[i];
          mx = fmaxf(mx, x[i]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m_run, mx);
        const float scale = expf(m_run - m_new);
        m_run = m_new;
        l_part *= scale;
        if constexpr (sizeof(T) != 4) __syncthreads();  // ex overlays other threads' scores
        T* ep = ex + sr * C::ldp + sq * 8;
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          const float e0 = expf(x[i] - m_new), e1 = expf(x[i + 1] - m_new);
          l_part += e0;
          l_part += e1;
          store_pair<T>(ep + i, e0, e1);  // rounded to x's type, as in JAX
        }
        if (sq == 0) rs[sr] = scale;
      }
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

  // l of row sr over its 8 threads; out = o / l staged in V's rows, stored
  // coalesced
  float l = l_part;
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  l += __shfl_xor_sync(0xffffffffu, l, 4);
  if (sq == 0) lrow[sr] = l;
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
                fw, vec, tid, NTH);
}

// #5 past f = 256 and P = 128: the projection into `scratch` (the file's
// head gives its shape), then the attention.
template <typename T, bool ONE>
cudaError_t layer_dot_wide(const LayerScore<T>& sc, const uint8_t* adj, void* out, void* scratch,
                           long long scratch_elems, int B, int P, int H, int F,
                           cudaStream_t stream) {
  if (B < 1 || H < 1 || P < 1 || F < 1 || sc.din < 1 || scratch == nullptr ||
      scratch_elems < 3LL * B * round_up(P, kGroup) * H * round_up(F, kProjCols))
    return cudaErrorInvalidValue;
  T* qkv = static_cast<T*>(scratch);
  constexpr int KC = 128 / int(sizeof(T));
  constexpr size_t pbytes =
      sizeof(T) * (2 * kProjRows * (KC + pad_rm<T>()) + 2 * KC * (kProjCols + 8)) +
      sizeof(uint32_t);
  using C = AttendCfg<T>;
  static_assert(C::bytes <= 232448, "a block's shared memory must fit 227 KB");
  const long n_proj = long(B) * H * ((P + kProjRows - 1) / kProjRows);
  const long n_att = long(B) * H * ((P + kAttRows - 1) / kAttRows);
  const int n_groups = (F + kAttCols - 1) / kAttCols;
  if (n_proj > 0x7fffffffL || n_att > 0x7fffffffL || n_groups > 65535)
    return cudaErrorInvalidValue;
  auto proj = layer_project_kernel<T, ONE>;
  cudaError_t err =
      cudaFuncSetAttribute(proj, cudaFuncAttributeMaxDynamicSharedMemorySize, int(pbytes));
  if (err != cudaSuccess) return err;
  proj<<<dim3(unsigned(n_proj), 3), 256, pbytes, stream>>>(sc, adj, qkv, B, P, H, F,
                                                          fill_bytes<T>(F));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto att = layer_attend_wide_kernel<T, ONE>;
  err = cudaFuncSetAttribute(att, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::bytes));
  if (err != cudaSuccess) return err;
  att<<<dim3(unsigned(n_att), unsigned(n_groups)), kAttThreads, C::bytes, stream>>>(
      qkv, adj, static_cast<T*>(out), B, P, H, F, fill_bytes<T>(F));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (of x, the weights and out): 0 = fp32, 1 = bf16.  x: [B, P, din]
// contiguous; wq, wk, wv: [H, din, F] contiguous; bq, bk, bv: fp32 [H, F];
// adj: [B, P, P] uint8; out: [B, P, H, F]; scratch: scratch_elems elements
// of x's type, written and read as [3, B, Pp, H, Fp] (Pp = P rounded up to
// 16, Fp = F rounded up to 128) past F = 256 and P = 128, where this entry
// point alone takes the two-launch path (else unused, may be null); a
// shorter scratch there is refused.  P >= 1, F >= 1, din >= 1; one_pass !=
// 0: fp32 products as one TF32 pass.  Launches on `stream` (twice past F =
// 256 and P = 128), allocates nothing, and returns cudaGetLastError()
// (cudaErrorInvalidValue outside that set).
int dfgnn_flash_layer_dot_fwd(int dtype, const void* x, const void* wq, const void* bq,
                              const void* wk, const void* bk, const void* wv, const void* bv,
                              const void* adj, void* out, void* scratch,
                              long long scratch_elems, int B, int P, int H, int din, int F,
                              float scale, int one_pass, void* stream) {
  const auto* a = static_cast<const uint8_t*>(adj);
  const auto* fq = static_cast<const float*>(bq);
  const auto* fk = static_cast<const float*>(bk);
  const auto* fv = static_cast<const float*>(bv);
  auto s = static_cast<cudaStream_t>(stream);
  const Dropout no_drop{false, 0u, 0u, 1.f};
  if (dtype == 0) {
    const LayerScore<float> sc{static_cast<const float*>(x),  static_cast<const float*>(wq),
                               static_cast<const float*>(wk), static_cast<const float*>(wv),
                               fq, fk, fv, din, fill_bytes<float>(din), scale};
    if (F > 256 && P > 128) {
      auto wide = one_pass != 0 ? &layer_dot_wide<float, true> : &layer_dot_wide<float, false>;
      return int(wide(sc, a, out, scratch, scratch_elems, B, P, H, F, s));
    }
    if (F > 256)
      return int(layer_fwd<LayerScoreWide<float>, float>(LayerScoreWide<float>{sc}, a, out, B, P,
                                                         H, F, no_drop, one_pass != 0, s));
    return int(layer_fwd<LayerScore<float>, float>(sc, a, out, B, P, H, F, no_drop,
                                                   one_pass != 0, s));
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    const LayerScore<bf16> sc{static_cast<const bf16*>(x),  static_cast<const bf16*>(wq),
                              static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
                              fq, fk, fv, din, fill_bytes<bf16>(din), scale};
    if (F > 256 && P > 128)
      return int(layer_dot_wide<bf16, false>(sc, a, out, scratch, scratch_elems, B, P, H, F, s));
    if (F > 256)
      return int(layer_fwd<LayerScoreWide<bf16>, bf16>(LayerScoreWide<bf16>{sc}, a, out, B, P, H,
                                                       F, no_drop, false, s));
    return int(layer_fwd<LayerScore<bf16>, bf16>(sc, a, out, B, P, H, F, no_drop, false, s));
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
