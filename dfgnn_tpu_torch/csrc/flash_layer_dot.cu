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
// Past f = 256 (LayerScoreWide) the head goes in chunks of FI columns, q .
// k^T summed over them, so shared memory stays that of one chunk:
// - whole (P <= 128, FI = 128): the block forms the fp32 scores once, in
//   registers, projecting each chunk of Q and K once into the Q and K
//   buffers and adding its products; after the exact softmax, each chunk of
//   out in turn projects V's chunk over K, sums ex . V_c in the warp pairs
//   and leaves through the V buffer.  q, k and v are each projected once per
//   (graph, head), as at f <= 128 (fp32 212 KB, bf16 144 KB);
// - stream (P > 128, FI = 256): #1's grid axis over the chunks of out
//   (blockIdx.y), each block projecting its own chunk of V and, for every
//   live key tile, every chunk of its Q rows and of the tile's K, so each
//   block re-forms the scores: the chunk blocks repeat the q and k
//   projections, and each block projects its Q rows once per key tile
//   (fp32 164 KB, bf16 93 KB).

#include "flash_fwd.cuh"

extern "C" {

// dtype (of x, the weights and out): 0 = fp32, 1 = bf16.  x: [B, P, din]
// contiguous; wq, wk, wv: [H, din, F] contiguous; bq, bk, bv: fp32 [H, F];
// adj: [B, P, P] uint8; out: [B, P, H, F].  P >= 1, F >= 1,
// din >= 1; one_pass != 0: fp32 products as one TF32 pass.  Launches on
// `stream`, allocates nothing, and returns cudaGetLastError()
// (cudaErrorInvalidValue outside that set).
int dfgnn_flash_layer_dot_fwd(int dtype, const void* x, const void* wq, const void* bq,
                              const void* wk, const void* bk, const void* wv, const void* bv,
                              const void* adj, void* out, int B, int P, int H, int din, int F,
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
    if (F > 256)
      return int(layer_fwd<LayerScoreWide<bf16>, bf16>(LayerScoreWide<bf16>{sc}, a, out, B, P, H,
                                                       F, no_drop, false, s));
    return int(layer_fwd<LayerScore<bf16>, bf16>(sc, a, out, B, P, H, F, no_drop, false, s));
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
