// Training kernels of the encoder self-attention with a learned relative-
// position bias and post-softmax dropout, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of
// emg_tpu/ops/pallas/flash_attention.py's training path:
//   K3 flash_train_fwd     <- _flash_train_fwd     (kernel _fwd_train_kernel)
//   K4 flash_train_bwd_dq  <- _flash_train_bwd, dq (kernel _bwd_dq_kernel)
//   K5 flash_train_bwd_dkv <- _flash_train_bwd, dk/dv (kernel _bwd_dkv_kernel)
//
// For each (b, h), query row i and key j (r = j - i + T - 1):
//
//   s[i,j] = (q_i . k_j) * scale + ((q_i . used[r]) + oob[r]) + kp[j]
//   l_i    = sum_j exp(s[i,j] - m_i),  lse_i = m_i + log l_i
//   p[i,j] = exp(s[i,j] - lse_i),      keep[i,j] in {0, 1}
//   o_i    = sum_j keep * exp(s - m_i) * v_j / (l_i * keep_prob)      (K3)
//   ds     = p * (keep * (dO_i . v_j) / keep_prob - delta_i)
//   dq_i   = scale * sum_j ds k_j + sum_j ds used[r]                  (K4)
//   d_used[h, r] = sum_{b, i} ds[i, i + r - T + 1] q_i                (K4)
//   dv_j   = sum_i (keep * p / keep_prob) dO_i                        (K5)
//   dk_j   = scale * sum_i ds q_i                                     (K5)
//
// delta_i = dO_i . o_i (o the dropped output) comes from the caller. The
// normalizer l stays the undropped sum, so lse is the softmax statistic the
// backward kernels recompute p from. Padded keys get -1e8 ADDED to their
// logit; padded query rows are not masked (their outputs are meaningless and
// their incoming gradient is zero), as in the TPU kernels.
//
// K3 is the forward shared with serving, flash_fwd_relpos.cuh, with its
// training flag set (saved lse, dropout, division by keep_prob): tensor
// cores, bf16 mma and float32 as 3xTF32. K4 and K5 are flash_bwd_relpos.cuh's
// tensor-core kernels over the backward recompute of p and ds, on the same
// primitives. The headers say how each is built and what bounds it; this
// file holds the C entry points of all three.
//
// The keep mask is the TPU kernels' counter-based hash (_keep_mask,
// flash_attention.py:222-242), bit for bit: a murmur3 finalizer over
// (seed, b, h, global query, global key) in uint32 arithmetic, keeping the
// low 30 bits below round((1 - rate) * 2^30) (`keep`, in the header). It
// depends only on global indices, so the three kernels, the plain PyTorch
// version and the TPU kernels all draw the same mask, whatever their tiling.
//
// dtypes: q, k, v, used and dO arrive as float32 or bfloat16; every sum is
// float32 and every output is float32 (the wrapper casts gradients to the
// input dtype). With bfloat16, p is rounded to bfloat16 before p.v, and
// ds (and keep*p/keep_prob) before the products that follow, as the TPU
// kernels' `.astype(vs.dtype)` does.
//
// d_used is a sum over b and over query tiles of every head's window. The
// TPU carried it in VMEM across a sequential grid; CUDA blocks run in no
// order, so K4 adds each block-tile's share with float32 atomics into a
// zeroed (H, 2T-1, Dh) buffer. The order of the atomic adds changes from run
// to run, so d_used differs between runs by float32 rounding (relative ~1e-6
// of its magnitude); dq, dk and dv are deterministic.

#include "flash_bwd_relpos.cuh"
#include "flash_fwd_relpos.cuh"

// Every entry point takes b_off and h_off, added to the block's batch and
// head in the keep hash: a rank that holds batch rows [b_off, b_off + B)
// and heads [h_off, h_off + H) of a mesh-sharded step draws the mask that
// the unsharded step draws for them. Offsets of 0 give the unsharded bits.

namespace {

template <typename T>
int launch_fwd(const T* q, const T* k, const T* v, const T* used,
               const float* oob, const unsigned char* key_pad, const int* seed,
               float* out, float* lse, int B, int H, int Tn, int Dh,
               int thresh, float keep_prob, int b_off, int h_off,
               cudaStream_t stream) {
  return fwd::launch<T, true>(q, k, v, used, oob, key_pad, seed, out, lse, B, H, Tn, Dh,
                              static_cast<uint32_t>(thresh), keep_prob,
                              static_cast<uint32_t>(b_off), static_cast<uint32_t>(h_off),
                              stream);
}

template <typename T>
int launch_dq(const T* q, const T* k, const T* v, const T* used,
              const float* oob, const unsigned char* key_pad, const int* seed,
              const T* dout, const float* lse, const float* delta, float* dq,
              float* dused, int B, int H, int Tn, int Dh, int thresh,
              float keep_prob, int b_off, int h_off, cudaStream_t stream) {
  return bwd::launch_dq<T>(q, k, v, used, oob, key_pad, seed, dout, lse, delta, dq, dused, B, H,
                           Tn, Dh, static_cast<uint32_t>(thresh), keep_prob,
                           static_cast<uint32_t>(b_off), static_cast<uint32_t>(h_off), stream);
}

template <typename T>
int launch_dkv(const T* q, const T* k, const T* v, const T* used,
               const float* oob, const unsigned char* key_pad, const int* seed,
               const T* dout, const float* lse, const float* delta, float* dk,
               float* dv, int B, int H, int Tn, int Dh, int thresh,
               float keep_prob, int b_off, int h_off, cudaStream_t stream) {
  return bwd::launch_dkv<T>(q, k, v, used, oob, key_pad, seed, dout, lse, delta, dk, dv, B, H,
                            Tn, Dh, static_cast<uint32_t>(thresh), keep_prob,
                            static_cast<uint32_t>(b_off), static_cast<uint32_t>(h_off), stream);
}

}  // namespace

#define FWD_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const T* q, const T* k, const T* v, const T* used,     \
                      const float* oob, const unsigned char* key_pad,         \
                      const int* seed, float* out, float* lse, int B, int H,  \
                      int Tn, int Dh, int thresh, float keep_prob, int b_off, \
                      int h_off, cudaStream_t stream) {                       \
    return launch_fwd<T>(q, k, v, used, oob, key_pad, seed, out, lse, B, H,   \
                         Tn, Dh, thresh, keep_prob, b_off, h_off, stream);    \
  }

#define BWD_ENTRY(NAME, LAUNCH, T)                                            \
  extern "C" int NAME(const T* q, const T* k, const T* v, const T* used,     \
                      const float* oob, const unsigned char* key_pad,         \
                      const int* seed, const T* dout, const float* lse,       \
                      const float* delta, float* g1, float* g2, int B, int H, \
                      int Tn, int Dh, int thresh, float keep_prob, int b_off, \
                      int h_off, cudaStream_t stream) {                       \
    return LAUNCH<T>(q, k, v, used, oob, key_pad, seed, dout, lse, delta, g1, \
                     g2, B, H, Tn, Dh, thresh, keep_prob, b_off, h_off,       \
                     stream);                                                 \
  }

FWD_ENTRY(flash_train_fwd_f32, float)
FWD_ENTRY(flash_train_fwd_bf16, __nv_bfloat16)
BWD_ENTRY(flash_train_bwd_dq_f32, launch_dq, float)
BWD_ENTRY(flash_train_bwd_dq_bf16, launch_dq, __nv_bfloat16)
BWD_ENTRY(flash_train_bwd_dkv_f32, launch_dkv, float)
BWD_ENTRY(flash_train_bwd_dkv_bf16, launch_dkv, __nv_bfloat16)

extern "C" const char* flash_attention_relpos_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
