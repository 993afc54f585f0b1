// K6 in float16 (SnacConfig.dtype "float16"): the 16-bit body of
// vocoder16.cuh (its note says what it computes and how), instantiated for
// __half. The JAX package casts the vocoder to float16 for that dtype and
// runs the same unit in the dtype of x.

#include "vocoder16.cuh"

extern "C" int tts_fused_residual_unit_f16_max_dilation(int c) { return c > 0 ? 9 : 0; }

// float16 x, parameters and output; otherwise as tts_fused_residual_unit_bf16.
extern "C" int tts_fused_residual_unit_f16(const void* x, const void* valid, const void* alpha1,
                                           const void* dw, const void* dwb, const void* alpha2,
                                           const void* pw, const void* pwb, void* out, int b,
                                           int t_len, int c, int dil, long long sb, long long st,
                                           long long sc, int seg, int blocks, int paths,
                                           void* stream) {
  return fused_residual_unit16<__half>(x, valid, alpha1, dw, dwb, alpha2, pw, pwb, out, b, t_len,
                                       c, dil, sb, st, sc, seg, blocks, paths, stream);
}
