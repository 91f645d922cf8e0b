// Encoder self-attention with a learned relative-position bias, fused, for
// Hopper (sm_90a): the serving forward.
//
// Replaces the Pallas TPU kernel
// emg_tpu/ops/pallas/flash_attention.py::flash_attention_relpos. The kernel
// is the forward shared with training, flash_fwd_relpos.cuh (which says what
// it computes, what bounds it and how it is built), instantiated without
// the training flag: no dropout, no saved logsumexp. This file keeps only
// the C entry points.

#include "flash_fwd_relpos.cuh"

extern "C" int flash_attention_relpos_f32(const float* q, const float* k,
                                          const float* v, const float* used,
                                          const float* oob,
                                          const unsigned char* key_pad,
                                          float* out, int B, int H, int T,
                                          int Dh, cudaStream_t stream) {
  return fwd::launch<float, false>(q, k, v, used, oob, key_pad, nullptr, out, nullptr, B, H, T,
                                   Dh, kKeepAll, 1.0f, 0u, 0u, stream);
}

extern "C" int flash_attention_relpos_bf16(const __nv_bfloat16* q,
                                           const __nv_bfloat16* k,
                                           const __nv_bfloat16* v,
                                           const __nv_bfloat16* used,
                                           const float* oob,
                                           const unsigned char* key_pad,
                                           float* out, int B, int H, int T,
                                           int Dh, cudaStream_t stream) {
  return fwd::launch<__nv_bfloat16, false>(q, k, v, used, oob, key_pad, nullptr, out, nullptr, B,
                                           H, T, Dh, kKeepAll, 1.0f, 0u, 0u, stream);
}

extern "C" const char* flash_attention_relpos_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
