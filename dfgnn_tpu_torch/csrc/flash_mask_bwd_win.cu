// Kernel #3 past P = kWinKeys: the windowed instantiations of the passes of
// flash_mask_bwd.cuh, in a translation unit of their own so that they
// compile in parallel with flash_mask_bwd.cu, whose entry point calls this.

#include "flash_mask_bwd.cuh"

extern "C" int dfgnn_flash_mask_bwd_win(int dtype, const void* q, const void* k, const void* v,
                                        const void* adj, const void* val, const void* lse,
                                        const void* delta, const void* dout, void* dq, void* dk,
                                        void* dv, int B, int P, int H, int F, int drop,
                                        uint32_t seed, uint32_t threshold, float scale,
                                        int one_pass, void* stream) {
  return bwd_entry<true>(dtype, q, k, v, adj, val, lse, delta, dout, dq, dk, dv, B, P, H, F,
                         drop, seed, threshold, scale, one_pass, stream);
}
