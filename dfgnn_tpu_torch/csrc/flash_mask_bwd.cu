// Masked dense graph-attention backward for Hopper (sm_90a), hand-written CUDA
// on the tensor cores: kernel #3.
//
// Replaces dfgnn_tpu/ops/pallas/flash_mask.py::_bwd_kernel_dot (:256), driven
// there by _bwd (:317).  The function, the design and the passes are in
// flash_mask_bwd.cuh.  This unit builds their instantiations up to P =
// kWinKeys and the C entry point; flash_mask_bwd_win.cu the windowed ones
// past it (their own unit, so that the two compile in parallel).

#include "flash_mask_bwd.cuh"

extern "C" {

// flash_mask_bwd_wide.cu: the entry point's body past F = 256
int dfgnn_flash_mask_bwd_wide(int dtype, const void* q, const void* k, const void* v,
                              const void* adj, const void* val, const void* lse,
                              const void* delta, const void* out, const void* dout, void* dq,
                              void* dk, void* dv, int B, int P, int H, int F, int drop,
                              uint32_t seed, uint32_t threshold, float scale, int one_pass,
                              void* stream);

// flash_mask_bwd_win.cu: the entry point's body past P = kWinKeys
int dfgnn_flash_mask_bwd_win(int dtype, const void* q, const void* k, const void* v,
                             const void* adj, const void* val, const void* lse,
                             const void* delta, const void* dout, void* dq, void* dk, void* dv,
                             int B, int P, int H, int F, int drop, uint32_t seed,
                             uint32_t threshold, float scale, int one_pass, void* stream);

// dtype: 0 = fp32, 1 = bf16.  q, k, v, dout, dq, dk, dv: [B, P, H, F]
// contiguous, F >= 1; adj: [B, P, P] uint8; val: [B, P, P] fp32 or null;
// lse, delta: [H, B, P] fp32; out: the forward's [B, P, H, F] (with dropout
// applied), contiguous.  At P <= 128 and F > 256 the kernel forms delta =
// rowsum(dout * out) from out itself and delta may be null; everywhere else
// it reads delta and out may be null.  A null one where it is read is
// refused (cudaErrorInvalidValue), so a caller that pairs them otherwise
// gets an error, not a launch.  drop, seed, threshold, scale: the
// forward's dropout.  one_pass: fp32 products as one TF32 pass (precision
// "default"), else 3xTF32.  Launches one kernel (P <= 128 with F <= 128 or
// F > 256), two (the stream passes) or three (F = 129 to 256 past the
// whole block) on `stream`, allocates nothing, and returns the first CUDA
// error (0 when all launched).
int dfgnn_flash_mask_bwd(int dtype, const void* q, const void* k, const void* v,
                         const void* adj, const void* val, const void* lse, const void* delta,
                         const void* out, const void* dout, void* dq, void* dk, void* dv, int B,
                         int P, int H, int F, int drop, uint32_t seed, uint32_t threshold,
                         float scale, int one_pass, void* stream) {
  if (F > 256)
    return dfgnn_flash_mask_bwd_wide(dtype, q, k, v, adj, val, lse, delta, out, dout, dq, dk, dv,
                                     B, P, H, F, drop, seed, threshold, scale, one_pass, stream);
  if (P > kWinKeys)
    return dfgnn_flash_mask_bwd_win(dtype, q, k, v, adj, val, lse, delta, dout, dq, dk, dv, B,
                                    P, H, F, drop, seed, threshold, scale, one_pass, stream);
  return bwd_entry<false>(dtype, q, k, v, adj, val, lse, delta, dout, dq, dk, dv, B, P, H, F,
                          drop, seed, threshold, scale, one_pass, stream);
}

}  // extern "C"
