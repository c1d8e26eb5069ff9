// Tensor-core building blocks of the redesigned kernels #1, #2, #5 and #6
// (their shared forward body, flash_fwd.cuh), #3 (flash_mask_bwd.cu) and #4
// (flash_add_bwd.cu): warp-level mma.sync products over shared-memory tiles,
// 3xTF32 for fp32 and bf16 with fp32 accumulators, cp.async staging of
// [rows, F] tiles with zero fill, the projection of #5 and #6, and the
// adjacency scan that finds the tiles with no edge.
//
// Why mma.sync and not wgmma.  Every product of #1 to #4 has one operand
// that is produced in the kernel (p, ds, pn) and lives in a per-warp
// shared-memory tile, and three of them (p.V, ds^T.Q, pn^T.dO) read an
// operand along its rows.  wgmma's .tf32 form takes both operands K-major
// from shared memory in its core-matrix layout only, so each of those
// products would need a transposed, swizzled copy staged for it, and its
// 64-row granularity is coarser than the 16-row tiles at which these
// kernels skip padding.  mma.sync loads its fragments with ordinary
// shared-memory loads, so a transposed operand costs only other indices,
// and a warp can skip a 16-row or 16-key tile on its own.  The price is the
// issue rate: mma.sync does not reach the tensor cores' wgmma peak.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32 and mma.m16n8k16 .bf16), with
// g = lane / 4 and t = lane % 4 of the warp:
//   C (16 x 8, fp32): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
//   tf32 A (16 x 8): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   tf32 B (8 x 8):  b0 (k=t, n=g), b1 (k=t+4, n=g)
//   bf16 A (16 x 16), pairs in one register, lower k in the low half:
//        a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   bf16 B (16 x 8): b0 (k=2t..2t+1, n=g), b1 (k=2t+8..2t+9, n=g)
// 3xTF32: each fp32 operand x splits into hi = x rounded to TF32 (nearest,
// ties away from zero) and lo = x - hi (exact in fp32), itself rounded to
// TF32; a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, summed in fp32, keeps about
// 22 bits of each product: rtol 1e-4 holds against fp32 on the CUDA cores.
// The rounding is an integer add and a bitwise and on the ALUs, in place of
// cvt.rna.tf32 on the conversion unit.
// One pass (`one`, the wrappers' precision="default" on fp32 inputs, the
// counterpart of one bf16 pass on the TPU's MXU): a_hi.b_hi alone,
// accumulated straight into acc.  ONE is a template flag of the steps and of
// the kernels, set only for fp32: as a runtime argument (a uniform branch
// into a body of its own in each step) it left #3's 3xTF32 whole block
// slower than before at the table's shape (PERF.md section 6), while the
// template keeps the 3xTF32 kernels' code as it was, at the price of a
// second fp32 instantiation of every kernel in the build.
#pragma once

#include "flash_common.cuh"

namespace {

constexpr float kDead = -0.5e30f;  // row-max clamp: exp(s - m) underflows to 0 on masked lanes
constexpr int kGroup = 16;         // keys (or query rows) per skip decision

// Shared-memory row padding, in elements: 16 bytes past a row of a multiple
// of 32 words keeps the fragment loads of one warp in distinct banks for an
// operand read along its rows (A[m][k], B[n][k]); an operand read across its
// rows (B[k][n]) takes 8 elements instead.
template <typename T> __host__ __device__ constexpr int pad_rm() { return 16 / int(sizeof(T)); }

// x rounded to TF32 (10 mantissa bits), nearest with ties away from zero;
// finite inputs only (the operands here are products of finite data).
__device__ __forceinline__ uint32_t round_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(__float_as_uint(x));
  lo = round_tf32(__float_as_uint(x - __uint_as_float(hi)));
}

__device__ __forceinline__ uint32_t tf32_of(float x) { return round_tf32(__float_as_uint(x)); }

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// k-depth of one mma for T: 8 (tf32) or 16 (bf16).
template <typename T> __host__ __device__ constexpr int kstep() { return sizeof(T) == 4 ? 8 : 16; }

// A (16 x K) or B (K x N) views of a shared-memory tile.  A_T / B_NM say how
// the tile is stored: A[m][k] (A_T false) or A[k][m] (true); B[k][n]
// (B_NM false) or B[n][k] (true).
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) | (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// Two consecutive elements (p[0], p[1]) = (a, b) rounded to T, one store; p
// 8-byte (fp32) or 4-byte (bf16) aligned.
template <typename T> __device__ __forceinline__ void store_pair(T* p, float a, float b);
template <> __device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2(__float2bfloat16(a), __float2bfloat16(b));
}

template <bool TRANS>
__device__ __forceinline__ float at(const float* p, int ld, int r, int c) {
  return TRANS ? p[c * ld + r] : p[r * ld + c];
}

// Two consecutive-k bf16 values (r, k) and (r, k + 1) of an operand stored
// [r][k] (TRANS false: one 32-bit load) or [k][r] (TRANS true: two loads).
template <bool TRANS>
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p, int ld, int r, int k) {
  if (TRANS) return pack2(p[k * ld + r], p[(k + 1) * ld + r]);
  return *reinterpret_cast<const uint32_t*>(p + r * ld + k);
}

// acc[j] += A(rows 0..15, k0..k0+kstep) . B(k0.., n0 + 8j ..) for j < NT with
// bit j of `nmask` set.  A points at the warp's 16 rows (element (0, 0)).
// fp32 takes 3xTF32 (one TF32 pass with ONE; bf16 ignores it), and each
// k-step's three products sum into a fresh
// accumulator that is then added to acc with an fp32 add: the tensor core's
// own accumulation rounds coarser than an fp32 add, and here it sees only
// one k-step's partial sum.  (Accumulating into acc directly left dq of the
// backward several times further from an fp64 evaluation than cuBLAS's fp32
// product, outside rtol 1e-4 in places; with the flush it is nearer than
// cuBLAS's, as chip_smoke.py prints.)
// mma_step's one TF32 pass (fp32 operands rounded to TF32, one mma).
template <int NT, bool A_T, bool B_NM>
__device__ __forceinline__ void mma_step_one(float (&acc)[NT][4], const float* A, int lda,
                                             const float* Bm, int ldb, int k0, int n0,
                                             uint32_t nmask) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t a0 = tf32_of(at<A_T>(A, lda, g, k0 + t));
  const uint32_t a1 = tf32_of(at<A_T>(A, lda, g + 8, k0 + t));
  const uint32_t a2 = tf32_of(at<A_T>(A, lda, g, k0 + t + 4));
  const uint32_t a3 = tf32_of(at<A_T>(A, lda, g + 8, k0 + t + 4));
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (!((nmask >> j) & 1u)) continue;
    const int n = n0 + 8 * j + g;
    mma_tf32(acc[j], a0, a1, a2, a3,
             tf32_of(B_NM ? Bm[n * ldb + k0 + t] : Bm[(k0 + t) * ldb + n]),
             tf32_of(B_NM ? Bm[n * ldb + k0 + t + 4] : Bm[(k0 + t + 4) * ldb + n]));
  }
}

template <int NT, bool A_T, bool B_NM, bool ONE>
__device__ __forceinline__ void mma_step(float (&acc)[NT][4], const float* A, int lda,
                                         const float* Bm, int ldb, int k0, int n0,
                                         uint32_t nmask) {
  if constexpr (ONE) {
    mma_step_one<NT, A_T, B_NM>(acc, A, lda, Bm, ldb, k0, n0, nmask);
    return;
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[4], al[4];
  split_tf32(at<A_T>(A, lda, g, k0 + t), ah[0], al[0]);
  split_tf32(at<A_T>(A, lda, g + 8, k0 + t), ah[1], al[1]);
  split_tf32(at<A_T>(A, lda, g, k0 + t + 4), ah[2], al[2]);
  split_tf32(at<A_T>(A, lda, g + 8, k0 + t + 4), ah[3], al[3]);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (!((nmask >> j) & 1u)) continue;
    const int n = n0 + 8 * j + g;
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(B_NM ? Bm[n * ldb + k0 + t] : Bm[(k0 + t) * ldb + n], bh0, bl0);
    split_tf32(B_NM ? Bm[n * ldb + k0 + t + 4] : Bm[(k0 + t + 4) * ldb + n], bh1, bl1);
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(part, al[0], al[1], al[2], al[3], bh0, bh1);
    mma_tf32(part, ah[0], ah[1], ah[2], ah[3], bl0, bl1);
    mma_tf32(part, ah[0], ah[1], ah[2], ah[3], bh0, bh1);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
  }
}

template <int NT, bool A_T, bool B_NM, bool ONE>
__device__ __forceinline__ void mma_step(float (&acc)[NT][4], const __nv_bfloat16* A, int lda,
                                         const __nv_bfloat16* Bm, int ldb, int k0, int n0,
                                         uint32_t nmask) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t a0 = pair<A_T>(A, lda, g, k0 + 2 * t);
  const uint32_t a1 = pair<A_T>(A, lda, g + 8, k0 + 2 * t);
  const uint32_t a2 = pair<A_T>(A, lda, g, k0 + 2 * t + 8);
  const uint32_t a3 = pair<A_T>(A, lda, g + 8, k0 + 2 * t + 8);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (!((nmask >> j) & 1u)) continue;
    const int n = n0 + 8 * j + g;
    // B stored [n][k] is an A-like operand with rows n; stored [k][n], a
    // transposed one
    const uint32_t b0 = pair<!B_NM>(Bm, ldb, n, k0 + 2 * t);
    const uint32_t b1 = pair<!B_NM>(Bm, ldb, n, k0 + 2 * t + 8);
    mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
  }
}

// acc[mt][j] += A_mt(rows 0..15, k0..k0+kstep) . B(k0.., n0 + 8j ..) for the
// two m-tiles mt whose bit in `mts` is set (A_mt: rows 16 mt.. of A, stored
// A[m][k], or A[k][m] with A_T) and j < NT with bit j of `nmask` set; B
// stored B[k][n].  Each B fragment is loaded (and, fp32, split) once for
// both m-tiles; the products are mma_step's.
// mma_step2's one TF32 pass.
template <int NT, bool A_T>
__device__ __forceinline__ void mma_step2_one(float (&acc)[2][NT][4], const float* A, int lda,
                                              const float* Bm, int ldb, int k0, int n0,
                                              uint32_t nmask, uint32_t mts) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t a[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (!((mts >> mt) & 1u)) continue;
    const float* Am = A_T ? A + mt * 16 : A + mt * 16 * lda;
    a[mt][0] = tf32_of(at<A_T>(Am, lda, g, k0 + t));
    a[mt][1] = tf32_of(at<A_T>(Am, lda, g + 8, k0 + t));
    a[mt][2] = tf32_of(at<A_T>(Am, lda, g, k0 + t + 4));
    a[mt][3] = tf32_of(at<A_T>(Am, lda, g + 8, k0 + t + 4));
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (!((nmask >> j) & 1u)) continue;
    const int n = n0 + 8 * j + g;
    const uint32_t b0 = tf32_of(Bm[(k0 + t) * ldb + n]);
    const uint32_t b1 = tf32_of(Bm[(k0 + t + 4) * ldb + n]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      if ((mts >> mt) & 1u) mma_tf32(acc[mt][j], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, b1);
  }
}

template <int NT, bool ONE, bool A_T = false>
__device__ __forceinline__ void mma_step2(float (&acc)[2][NT][4], const float* A, int lda,
                                          const float* Bm, int ldb, int k0, int n0,
                                          uint32_t nmask, uint32_t mts) {
  if constexpr (ONE) {
    mma_step2_one<NT, A_T>(acc, A, lda, Bm, ldb, k0, n0, nmask, mts);
    return;
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (!((mts >> mt) & 1u)) continue;
    const float* Am = A_T ? A + mt * 16 : A + mt * 16 * lda;
    split_tf32(at<A_T>(Am, lda, g, k0 + t), ah[mt][0], al[mt][0]);
    split_tf32(at<A_T>(Am, lda, g + 8, k0 + t), ah[mt][1], al[mt][1]);
    split_tf32(at<A_T>(Am, lda, g, k0 + t + 4), ah[mt][2], al[mt][2]);
    split_tf32(at<A_T>(Am, lda, g + 8, k0 + t + 4), ah[mt][3], al[mt][3]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (!((nmask >> j) & 1u)) continue;
    const int n = n0 + 8 * j + g;
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(Bm[(k0 + t) * ldb + n], bh0, bl0);
    split_tf32(Bm[(k0 + t + 4) * ldb + n], bh1, bl1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (!((mts >> mt) & 1u)) continue;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(part, al[mt][0], al[mt][1], al[mt][2], al[mt][3], bh0, bh1);
      mma_tf32(part, ah[mt][0], ah[mt][1], ah[mt][2], ah[mt][3], bl0, bl1);
      mma_tf32(part, ah[mt][0], ah[mt][1], ah[mt][2], ah[mt][3], bh0, bh1);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[e];
    }
  }
}

template <int NT, bool ONE, bool A_T = false>
__device__ __forceinline__ void mma_step2(float (&acc)[2][NT][4], const __nv_bfloat16* A,
                                          int lda, const __nv_bfloat16* Bm, int ldb, int k0,
                                          int n0, uint32_t nmask, uint32_t mts) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t a[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (!((mts >> mt) & 1u)) continue;
    const __nv_bfloat16* Am = A_T ? A + mt * 16 : A + mt * 16 * lda;
    a[mt][0] = pair<A_T>(Am, lda, g, k0 + 2 * t);
    a[mt][1] = pair<A_T>(Am, lda, g + 8, k0 + 2 * t);
    a[mt][2] = pair<A_T>(Am, lda, g, k0 + 2 * t + 8);
    a[mt][3] = pair<A_T>(Am, lda, g + 8, k0 + 2 * t + 8);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (!((nmask >> j) & 1u)) continue;
    const int n = n0 + 8 * j + g;
    const uint32_t b0 = pair<true>(Bm, ldb, n, k0 + 2 * t);
    const uint32_t b1 = pair<true>(Bm, ldb, n, k0 + 2 * t + 8);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      if ((mts >> mt) & 1u) mma_bf16(acc[mt][j], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, b1);
  }
}

// Expands a mask of 16-key groups into the mask of their 8-key n-tiles.
__device__ __forceinline__ uint32_t ntile_mask(uint32_t groups) {
  uint32_t m = 0;
#pragma unroll
  for (int gi = 0; gi < 16; ++gi)
    if ((groups >> gi) & 1u) m |= 3u << (2 * gi);
  return m;
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = fill ? 16 : 0;  // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool fill) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = fill ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The widest cp.async copy whose alignment rows of f elements of T keep:
// 16, 4, or 0 (none: loads through registers).
template <typename T>
__host__ __device__ int fill_bytes(int f) {
  const int row = f * int(sizeof(T));
  return row % 16 == 0 ? 16 : row % 4 == 0 ? 4 : 0;
}

// Stages rows [n0, n0 + rows) of one (graph, head) of a [B, P, H, f] tensor
// into a [rows][FI] tile of row stride `ld` elements, for the 16-row groups
// of the tile whose bit in `live_groups` is set (the others are never read
// and stay as they were): columns past f and rows past P are zeros.  `base`
// is element (b, 0, head, 0), `row_stride` H * f.  Issues cp.async copies of
// `vec` bytes (fill_bytes: 16 or 4, the alignment every row keeps), else (vec
// 0) loads through registers; the caller commits and waits.
template <typename T, int FI>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, long base, long row_stride,
                                           int n0, int rows, int P, int f, int vec,
                                           uint32_t live_groups, T* tile, int ld, int tid,
                                           int nthreads) {
  constexpr int kPer = 16 / int(sizeof(T));  // elements per 16-byte piece
  constexpr int kWord = 4 / int(sizeof(T));  // elements per 4-byte word
  if (vec == 4) {
    const int words = FI / kWord;
    for (int i = tid; i < rows * words; i += nthreads) {
      const int r = i / words, c = (i - r * words) * kWord;
      if (!((live_groups >> (r / kGroup)) & 1u)) continue;
      const int node = n0 + r;
      const bool fill = node < P && c < f;
      const T* from = fill ? src + base + long(node) * row_stride + c : src;
      cp_async4(tile + r * ld + c, from, fill);
    }
  } else if (vec == 16) {
    const int pieces = FI / kPer;
    for (int i = tid; i < rows * pieces; i += nthreads) {
      const int r = i / pieces, c = (i - r * pieces) * kPer;
      if (!((live_groups >> (r / kGroup)) & 1u)) continue;
      const int node = n0 + r;
      const bool fill = node < P && c < f;
      const T* from = fill ? src + base + long(node) * row_stride + c : src;
      cp_async16(tile + r * ld + c, from, fill);
    }
  } else {
    for (int i = tid; i < rows * FI; i += nthreads) {
      const int r = i / FI, c = i - r * FI;
      if (!((live_groups >> (r / kGroup)) & 1u)) continue;
      const int node = n0 + r;
      const bool fill = node < P && c < f;
      tile[r * ld + c] = fill ? src[base + long(node) * row_stride + c] : from_f32<T>(0.f);
    }
  }
}

// The projection of the whole-layer kernels #5 (flash_layer_dot.cu) and #6
// (flash_layer_add.cu) on the tensor cores, block-collective (every thread
// of the WARPS warps calls it):
//   dst[r][c] = round_to<T>(z[r][c]),  z = (sum_k x[n0 + r][k] W[k][c] + bias[c]) * scale
// for the rows r < R of the 16-row groups whose bit in `live` is set (the
// others are neither loaded nor written) and every column c below f rounded
// up to the pass width, columns past f being exact zeros.  x is [.., din] of
// T from element `xbase` (row n0 + r of one graph, rows past P read as 0), W
// [din, f] of T with row stride wstride (past f: a chunk of a wider head's
// columns) and bias fp32 [f]; a null dst stores nothing (#6's scalar
// pre-pass).  x and W stream through a two-stage
// cp.async ring of KC-deep chunks (xs: 2 x [R][KC + pad], ws: 2 x [KC][CW +
// 8]; W from L2, where every block reads it).  A warp owns a 32 x 8 NJ tile
// of each pass of CW columns, the passes sized so that the WARPS warps cover
// it once, and sums it with mma_step2 (3xTF32 in fp32: each k-step's
// products summed apart; one TF32 pass with ONE).  Starts by writing the ring and ends after the
// last chunk's barrier with the stores to dst, so the caller waits at a
// barrier before reading dst.  xvec and wvec: the fill_bytes of din and
// wstride.
// With SCORES (#6) it also forms, from the unrounded fp32 z, the row scalars
//   el[r] = sum_c z[r][c] a_l[c],  er[r] = sum_c z[r][c] a_r[c]
// (a_l, a_r fp32 [f]; el or er may be null) for the same rows, in a fixed
// order: each thread's columns over the passes, the quad, then the TC warps
// that share a row, in warp order, through the ring (free once the last
// chunk is consumed).  No atomics, so two launches agree bitwise; it ends
// with a barrier, so the next call may refill the ring.
template <typename T, int R, int NJ, int WARPS, int KC, bool SCORES, bool ONE>
__device__ __forceinline__ void project_tile_body(
    const T* __restrict__ x, long xbase, int din, int xvec, const T* __restrict__ w, int wstride,
    int f, int wvec, const float* __restrict__ bias, float scale, int n0, int P, uint32_t live,
    T* dst, int ld, T* xs, T* ws, int tid, const float* __restrict__ a_l,
    const float* __restrict__ a_r, float* el, float* er) {
  constexpr int kThreads = WARPS * 32;
  constexpr int CW = kThreads * 8 * NJ / R;  // columns a pass
  constexpr int TC = CW / (8 * NJ);          // warp tiles across a pass
  static_assert(R % 32 == 0 && (R / 32) * TC == WARPS && TC * 8 * NJ == CW,
                "the warps cover a pass once");
  constexpr int ldx = KC + pad_rm<T>(), ldw = CW + 8;
  static_assert(!SCORES || int(sizeof(T)) * ldx >= 4 * TC,
                "the row scalars' partial sums fit the ring");
  constexpr int KS = kstep<T>();
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wr = (warp / TC) * 32, wc = (warp % TC) * 8 * NJ;  // the warp's tile
  const uint32_t mts = (live >> (wr / kGroup)) & 3u;
  const int n_chunks = (din + KC - 1) / KC;
  float sl[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, sr[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // SCORES
#pragma unroll 1
  for (int c0 = 0; c0 < f; c0 += CW) {
    const int cols = f - c0 - wc;  // the warp's columns below f
    const uint32_t nmask = cols <= 0 ? 0u : cols >= 8 * NJ ? 0xffffffffu
                                                           : (1u << ((cols + 7) / 8)) - 1u;
    float acc[2][NJ][4];
    zero_acc(acc[0]);
    zero_acc(acc[1]);
    auto stage = [&](int ch, int slot) {
      const int k0 = ch * KC;
      stage_rows<T, KC>(x + k0, xbase, din, n0, R, P, din - k0, xvec, live,
                        xs + size_t(slot) * R * ldx, ldx, tid, kThreads);
      stage_rows<T, CW>(w + c0, 0, wstride, k0, KC, din, f - c0, wvec, 0xffffffffu,
                        ws + size_t(slot) * KC * ldw, ldw, tid, kThreads);
    };
    stage(0, 0);
    cp_async_commit();
#pragma unroll 1
    for (int ch = 0; ch < n_chunks; ++ch) {
      if (ch + 1 < n_chunks) stage(ch + 1, (ch + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      if (mts != 0u && nmask != 0u) {
        const T* xa = xs + size_t(ch & 1) * R * ldx + size_t(wr) * ldx;
        const T* wb = ws + size_t(ch & 1) * KC * ldw;
#pragma unroll 1
        for (int k0 = 0; k0 < KC; k0 += KS) {
          if constexpr (SCORES && sizeof(T) == 2) {
            // #6 in bf16: each k-step's products summed apart and added to acc
            // in fp32, as the 3xTF32 products are (mma_step): accumulated on
            // the tensor core, z came out biased toward zero, one bf16 step of
            // z off an exact evaluation more often than an fp32 GEMM's z
            float part[2][NJ][4];
            zero_acc(part[0]);
            zero_acc(part[1]);
            mma_step2<NJ, ONE>(part, xa, ldx, wb, ldw, k0, wc, nmask, mts);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e];
          } else {
            mma_step2<NJ, ONE>(acc, xa, ldx, wb, ldw, k0, wc, nmask, mts);
          }
        }
      }
      __syncthreads();  // this slot is free again
    }
    // every n-tile of a live m-tile is stored: those at or past f are zeros
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (!((mts >> mt) & 1u)) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = c0 + wc + 8 * j + 2 * t;
        const float b0 = c < f ? bias[c] : 0.f, b1 = c + 1 < f ? bias[c + 1] : 0.f;
        float l0 = 0.f, l1 = 0.f, q0 = 0.f, q1 = 0.f;  // SCORES: a_l, a_r of columns c, c + 1
        if constexpr (SCORES) {
          if (c < f) l0 = a_l[c], q0 = a_r[c];
          if (c + 1 < f) l1 = a_l[c + 1], q1 = a_r[c + 1];
        }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float z0 = (acc[mt][j][2 * h2] + b0) * scale;
          const float z1 = (acc[mt][j][2 * h2 + 1] + b1) * scale;
          if (dst != nullptr)
            store_pair<T>(dst + size_t(wr + 16 * mt + g + 8 * h2) * ld + c, z0, z1);
          if constexpr (SCORES) {
            sl[mt][h2] += z0 * l0 + z1 * l1;
            sr[mt][h2] += z0 * q0 + z1 * q1;
          }
        }
      }
    }
  }
  if constexpr (SCORES) {
    float* part = reinterpret_cast<float*>(xs);  // [2][TC][R]: el's, then er's partial sums
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float l = sl[mt][h2], q = sr[mt][h2];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        q += __shfl_xor_sync(0xffffffffu, q, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        q += __shfl_xor_sync(0xffffffffu, q, 2);
        if (t == 0 && ((mts >> mt) & 1u)) {
          const int r = wr + 16 * mt + g + 8 * h2;
          part[(warp % TC) * R + r] = l;
          part[(TC + warp % TC) * R + r] = q;
        }
      }
    __syncthreads();
    for (int r = tid; r < R; r += kThreads) {
      if (!((live >> (r / kGroup)) & 1u)) continue;
      float l = 0.f, q = 0.f;
#pragma unroll
      for (int tc = 0; tc < TC; ++tc) {
        l += part[tc * R + r];
        q += part[(TC + tc) * R + r];
      }
      if (el != nullptr) el[r] = l;
      if (er != nullptr) er[r] = q;
    }
    __syncthreads();  // el and er are in place, and the ring is free again
  }
}

// #5's projection.  Not inlined: one copy of its unrolled products serves
// the q, k and v projections, where three inlined copies ran slower (the
// kernel's code outgrew the instruction cache).  (A ring of 3 or 4 stages,
// or the three TF32 products of a k-step in three independent accumulators,
// ran no faster: the products are issue-bound at one block of 8 warps an
// SM.)
template <typename T, int R, int NJ, int WARPS, int KC, bool ONE>
__device__ __noinline__ void project_tile(const T* __restrict__ x, long xbase, int din,
                                             int xvec, const T* __restrict__ w, int wstride,
                                             int f, int wvec, const float* __restrict__ bias,
                                             float scale, int n0, int P, uint32_t live, T* dst,
                                             int ld, T* xs, T* ws, int tid) {
  project_tile_body<T, R, NJ, WARPS, KC, false, ONE>(x, xbase, din, xvec, w, wstride, f, wvec,
                                                     bias, scale, n0, P, live, dst, ld, xs, ws,
                                                     tid, nullptr, nullptr, nullptr, nullptr);
}

// #6's projection: z and its row scalars el, er (project_tile_body with
// SCORES), scale 1.  Not inlined, as project_tile.
template <typename T, int R, int NJ, int WARPS, int KC, bool ONE>
__device__ __noinline__ void project_tile_scores(
    const T* __restrict__ x, long xbase, int din, int xvec, const T* __restrict__ w, int wstride,
    int f, int wvec, const float* __restrict__ bias, const float* __restrict__ a_l,
    const float* __restrict__ a_r, int n0, int P, uint32_t live, T* dst, int ld, T* xs, T* ws,
    float* el, float* er, int tid) {
  project_tile_body<T, R, NJ, WARPS, KC, true, ONE>(x, xbase, din, xvec, w, wstride, f, wvec,
                                                    bias, 1.f, n0, P, live, dst, ld, xs, ws, tid,
                                                    a_l, a_r, el, er);
}

// Bit i set iff byte i of w is not 0.
__device__ __forceinline__ uint32_t byte_bits(uint32_t w) {
  const uint32_t m = __vcmpne4(w, 0u);  // 0xff in each nonzero byte
  return ((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) | ((m >> 28) & 8u);
}

// Scans adj rows [r0, r0 + rows) below P over the 16-key groups gk in
// [0, n_groups) (keys c0 + 16 gk onwards, c0 a multiple of 16).  For every
// group it calls rec(r, gk, bits) with bit c set when key c0 + 16 gk + c is
// an edge; for every group with an edge it ORs `bit` into flags[w], where
// locate(r, gk, w, bit) names the word and bit.  A thread reads one 16-byte
// group of one row at a time; the lanes of a warp that hit one word merge
// their bits first, so each word takes one shared atomicOr per warp and
// pass.  nthreads must be a multiple of 32.
template <typename Locate, typename Rec>
__device__ __forceinline__ void scan_adj(const uint8_t* __restrict__ adj_b, int P, int r0,
                                         int rows, int c0, int n_groups, int tid, int nthreads,
                                         uint32_t* flags, Locate locate, Rec rec) {
  const bool vec = (P % 16) == 0;
  const int n = rows * n_groups, lane = tid & 31;
  for (int i0 = tid - lane; i0 < n; i0 += nthreads) {
    const int i = i0 + lane;
    int w = -1;
    uint32_t bit = 0u;
    if (i < n) {
      const int r = r0 + i / n_groups, gk = i % n_groups;
      const int key = c0 + gk * kGroup;
      if (r < P && key < P) {
        const uint8_t* p = adj_b + long(r) * P + key;
        uint32_t bits = 0u;
        if (vec) {
          const uint4 q4 = *reinterpret_cast<const uint4*>(p);
          bits = byte_bits(q4.x) | byte_bits(q4.y) << 4 | byte_bits(q4.z) << 8 |
                 byte_bits(q4.w) << 12;
        } else {
          const int m = min(kGroup, P - key);
          for (int c = 0; c < m; ++c) bits |= uint32_t(p[c] != 0) << c;
        }
        rec(r, gk, bits);
        if (bits != 0u) locate(r, gk, w, bit);
      }
    }
    const unsigned same = __match_any_sync(0xffffffffu, w);
    const uint32_t merged = __reduce_or_sync(same, bit);
    if (w >= 0 && lane == __ffs(same) - 1) atomicOr(&flags[w], merged);
  }
}

// Stores rows [row0, row0 + rows) below P of a [rows][f] tile (row stride ld)
// into a [B, P, H, f] tensor (`base` element (b, 0, head, 0), `row_stride`
// H * f), 16 bytes a thread at a time when `vec` (f * sizeof(T) a multiple
// of 16), so neighbouring threads write neighbouring bytes.
template <typename T>
__device__ __forceinline__ void store_tile(const T* tile, int ld, T* __restrict__ dst, long base,
                                           long row_stride, int row0, int rows, int P, int f,
                                           int vec, int tid, int nthreads) {
  constexpr int kPer = 16 / int(sizeof(T));
  if (vec == 16) {
    const int pieces = f / kPer;
    for (int i = tid; i < rows * pieces; i += nthreads) {
      const int r = i / pieces, c = (i - r * pieces) * kPer;
      if (row0 + r < P)
        *reinterpret_cast<uint4*>(dst + base + long(row0 + r) * row_stride + c) =
            *reinterpret_cast<const uint4*>(tile + r * ld + c);
    }
  } else {
    for (int i = tid; i < rows * f; i += nthreads) {
      const int r = i / f, c = i - r * f;
      if (row0 + r < P) dst[base + long(row0 + r) * row_stride + c] = tile[r * ld + c];
    }
  }
}

}  // namespace
