// Masked dense graph-attention forward with the additive (GAT) score, for
// Hopper (sm_90a), hand-written CUDA on the tensor cores: kernel #2.
//
// Replaces dfgnn_tpu/ops/pallas/flash_mask.py::_fwd_kernel_add (:173) and its
// body _softmax_matmul (:131), driven there by _fwd (:239).  For every graph
// b and head h of a DenseBatch, from per-node fp32 scalars e_row, e_col
// [B, P, h] (the layer's node-major layout, read through strides: no
// [h, B, P] copy; fp32 whatever v's type, as the Pallas kernel reads them):
//   pre = e_row[r] + e_col[c]
//   s   = leaky_relu(pre) (pre >= 0 ? pre : slope * pre), times val[b]
//   s   = adj[b] ? s : -1e30
//   m   = max(rowmax(s), -0.5e30)     masked lanes then underflow to exactly 0
//   ex  = exp(s - m), l = rowsum(ex), inv = l > 0 ? 1 / l : 0
//   out = (round_to<T>(ex * keep) . v) * inv      an empty row gives exactly 0
//   lse = l > 0 ? m + log(l) : -1e30  optional, [h, B, P] fp32
// keep is the dropout factor of flash_common.cuh (1 without dropout): l sums
// the undropped ex and lse does not see dropout, as in the Pallas kernel.
// fp32 or bf16 v and out, any head dim f >= 1 (past 256 the wide block of
// flash_attend_wide.cuh, which forms the scores once per 512 columns and
// stages no q or k); fp32 softmax and sums; ex . v in fp32 as 3xTF32, or one
// TF32 pass (precision "default").
//
// What bounds it on an H100 SXM (data-sheet peaks): the function needs one
// product, ex . v, only on the edges: 2*f operations per edge and head.  At
// the table's shape (B=1024, h=1, P=128, f=128, fp32) with a fifth of the
// block entries edges, as chip_smoke.py's inputs have, that is 0.9 GFLOP,
// 0.014 ms at 67 TFLOP/s, against 153 MB of e_row, e_col, v, adj read and
// out, lse written, 0.0455 ms at 3.35 TB/s: device memory bounds it.
//
// Design: the shared forward body of flash_fwd.cuh with its additive-score
// policy (AddScore), the body of the dot-score kernel #1.  The kernel this
// replaces took 16 query rows a block, so each graph's V (64 KB in fp32 at
// P = f = 128) was streamed through shared memory 8 times, and it formed
// ex . v over every entry of the dense [P, P] block as fp32 FMAs on the
// CUDA cores, each paying a shared-memory load: 0.64 ms, bound by
// shared-memory instructions.  Here a block takes 64 rows (a whole P = 128
// graph in two blocks), loads V once, and only the 16-key groups that hold
// an edge, while the scores are formed; the scores are two fp32 scalars, a
// leaky ReLU and the edge mask, formed straight in the mma C-fragment
// layout; ex . v runs on the tensor cores (3xTF32 for fp32, bf16 with fp32
// sums), skipping the 16-row and 16-key tiles without an edge.

#include "flash_fwd.cuh"

extern "C" {

// dtype (of v and out): 0 = fp32, 1 = bf16.  e_row, e_col: fp32 [B, P, H]
// contiguous; v, out: [B, P, H, F] contiguous, F >= 1; adj: [B, P, P]
// uint8; val: [B, P, P] fp32 or null; lse: [H, B, P] fp32 or null.  drop != 0
// applies dropout with the hash's seed and threshold and the fp32 scale
// 1 / (1 - rate); one_pass != 0 runs fp32 products as one TF32 pass.
// Launches on `stream`, allocates nothing, and returns cudaGetLastError().
int dfgnn_flash_add_fwd(int dtype, const void* e_row, const void* e_col, const void* v,
                        const void* adj, const void* val, void* out, void* lse, int B, int P,
                        int H, int F, float slope, int drop, unsigned seed, unsigned threshold,
                        float scale, int one_pass, void* stream) {
  const AddScore sc{static_cast<const float*>(e_row), static_cast<const float*>(e_col), slope};
  const auto* a = static_cast<const uint8_t*>(adj);
  const auto* ev = static_cast<const float*>(val);
  auto* l = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  const Dropout dr{drop != 0, seed, threshold, scale};
  if (dtype == 0)
    return int(flash_fwd<AddScore, float>(sc, v, a, ev, out, l, B, P, H, F, dr, one_pass != 0,
                                          s));
  if (dtype == 1)
    return int(flash_fwd<AddScore, __nv_bfloat16>(sc, v, a, ev, out, l, B, P, H, F, dr, false,
                                                  s));
  return int(cudaErrorInvalidValue);
}

}  // extern "C"

