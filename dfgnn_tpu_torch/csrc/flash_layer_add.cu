// The whole GAT layer in one kernel: the W projection, the a_l / a_r score
// contractions and masked additive-score attention with the per-edge
// dropout, for Hopper (sm_90a), hand-written CUDA on the tensor cores:
// kernel #6.
//
// Replaces dfgnn_tpu/ops/pallas/flash_mask.py::_layer_kernel_add (:649),
// driven there by _layer_add_fwd (:672).  For every graph b and head h of a
// DenseBatch, from node features x [B, P, din], the head's weight W
// [H, din, F] (in x's type) and fp32 b, a_l, a_r [H, F]:
//   z    = x . W + b                          fp32, products summed in fp32
//   e_l  = sum_f z * a_l, e_r = sum_f z * a_r  from the unrounded fp32 z
//   s    = adj[b] ? leaky_relu(e_l[r] + e_r[c]) : -1e30
//   m    = max(rowmax(s), -0.5e30), ex = exp(s - m), l = rowsum(ex)
//   out  = (round_to<T>(ex * keep) . round_to<T>(z)) / l   empty rows give 0
// keep is the dropout factor of flash_common.cuh, keyed as in kernel #2 on
// (b * P + r, b * P + c, h); l sums the undropped ex.  out is [B, P, H, F] in
// x's type.  No edge values and no lse, as in the Pallas kernel.  fp32 or
// bf16, any P <= 2048, any F from 1 to 256 (tiles zero past F up to the
// instantiated width 32, 64, 128 or 256), any din >= 1.
//
// What bounds it on an H100 SXM (data-sheet peaks): the projection, 2 * din
// * F operations per node and head, the two contractions, 2 * 2 * F, and
// ex . z on the edges, 2 * F per edge and head.  At the table's shape
// (B=1024, H=1, P=128, din=F=128, fp32, about 6.0M edges) that is 4.3 +
// 0.07 + 1.5 GFLOP, 0.036 ms as 3xTF32 on the tensor cores (a third of 495
// TFLOP/s), against 151 MB of x, the weights and adj read and out written,
// 0.045 ms at 3.35 TB/s: device memory bounds the function, in bf16 too.
//
// Design.  The kernel this replaces ran the projection and ex . z as fp32
// FMAs on the CUDA cores (67 TFLOP/s), formed scores and ex . z over every
// entry of the dense [P, P] block, and held z of all P nodes in one block's
// shared memory, so it stopped where that passed 227 KB (f = 256 at P =
// 128; f = 128 at P = 318 in fp32) and took only f in 8, 16, ..., 256.
// Here the attention is #2's own body (flash_fwd.cuh) with the LayerAddScore
// policy, as #5 is #1's with LayerScore: z is projected on the tensor cores
// by project_tile_scores (flash_mma.cuh: mma.sync, 3xTF32 in fp32 with each
// k-step's products summed apart, bf16 with fp32 sums; x and W through a
// cp.async ring, W from L2, where the B*H blocks share it) into the V tile
// #2 copies in, rounded to T, and from the same fp32 accumulators, before
// rounding, each node's e_l and e_r are summed into shared memory in a fixed
// order (the quad, then the warps that share a row: no atomics, so two
// launches agree bitwise).  The scores are then formed in the C-fragment
// layout as #2 forms them.  Padding is skipped before any projection: the
// block scans adj first and projects only the 16-row tiles and 16-key groups
// that hold an edge; a block without an edge writes zeros.  Two shapes:
// - whole (P <= 128, f <= 128: every GAT serving and training shape): 8
//   warps over all 128 rows of one (graph, head), so z is projected once,
//   for the nodes live as a row or as a key, with both scalars (fp32 at f =
//   128: 212 KB, one block an SM; bf16 144 KB); the exact row max;
// - stream (P > 128, or f > 128): #5's stream block.  It projects its own
//   query rows once, for their e_l only, then, as the walk reaches each live
//   key tile, that tile's z into the one V stage with the tile's e_r: the
//   online softmax needs e_r only of the current tile's keys, so nothing of
//   the graph stays resident and every P up to 2048 fits.

#include "flash_fwd.cuh"

extern "C" {

// dtype (of x, w and out): 0 = fp32, 1 = bf16.  x: [B, P, din] contiguous;
// w: [H, din, F] contiguous; bias, a_l, a_r: fp32 [H, F]; adj: [B, P, P]
// uint8; out: [B, P, H, F].  1 <= P <= 2048, 1 <= F <= 256, din >= 1.  drop,
// seed, threshold and scale as dfgnn_flash_add_fwd's.  Launches on `stream`,
// allocates nothing, and returns cudaGetLastError() (cudaErrorInvalidValue
// outside that set).
int dfgnn_flash_layer_add_fwd(int dtype, const void* x, const void* w, const void* bias,
                              const void* a_l, const void* a_r, const void* adj, void* out,
                              int B, int P, int H, int din, int F, float slope, int drop,
                              unsigned seed, unsigned threshold, float scale, void* stream) {
  const auto* a = static_cast<const uint8_t*>(adj);
  const auto* fb = static_cast<const float*>(bias);
  const auto* fl = static_cast<const float*>(a_l);
  const auto* fr = static_cast<const float*>(a_r);
  auto s = static_cast<cudaStream_t>(stream);
  const Dropout dr{drop != 0, seed, threshold, scale};
  if (dtype == 0) {
    const LayerAddScore<float> sc{static_cast<const float*>(x), static_cast<const float*>(w),
                                  fb, fl, fr, din, fill_bytes<float>(din), slope};
    return int(layer_fwd<LayerAddScore<float>, float>(sc, a, out, B, P, H, F, dr, s));
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    const LayerAddScore<bf16> sc{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                                 fb, fl, fr, din, fill_bytes<bf16>(din), slope};
    return int(layer_fwd<LayerAddScore<bf16>, bf16>(sc, a, out, B, P, H, F, dr, s));
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
