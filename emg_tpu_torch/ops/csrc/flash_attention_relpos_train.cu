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
// The keep mask is the TPU kernels' counter-based hash (_keep_mask,
// flash_attention.py:222-242), bit for bit: a murmur3 finalizer over
// (seed, b, h, global query, global key) in uint32 arithmetic, keeping the
// low 30 bits below round((1 - rate) * 2^30). It depends only on global
// indices, so the three kernels, the plain PyTorch version and the TPU
// kernels all draw the same mask, whatever their tiling.
//
// dtypes: q, k, v, used and dO arrive as float32 or bfloat16; every sum is
// float32 and every output is float32 (the wrapper casts gradients to the
// input dtype). With bfloat16, p is rounded to bfloat16 before p.v, and
// ds (and keep*p/keep_prob) before the products that follow, as the TPU
// kernels' `.astype(vs.dtype)` does.
//
// What bounds them on an H100: operations. Per (b, h), K3 does about
// 6*T*T*Dh flops (q.k, q.used, p.v), K4 about 12*T*T*Dh (q.k, q.used, dO.v,
// ds.k, ds.used, ds^T.q) and K5 about 10*T*T*Dh (q.k, q.used, dO.v, p^T.dO,
// ds^T.q), against ~4*T*Dh values read (q, k, v, dO) plus the (2T-1, Dh)
// window per head: at T >= 128, Dh = 96 the ratio of operations to bytes is
// far above the card's. The products are scalar float32 FMAs, a simple
// design that is right; tensor cores (mma.sync / wgmma) with TMA staging are
// later work.
//
// Design, as the serving kernel (flash_attention_relpos.cu): the TPU kernels
// formed q.used over the whole window and rolled rows to meet Mosaic's lane
// alignment. Here a block stages, per tile, the band of rows of `used` that
// the tile touches (rows padded to an odd stride so a warp's diagonal reads
// hit distinct banks) and forms q.used for exactly the (i, j) it owns.
//   K3, K4: a block owns kBQ = 32 query rows of one (b, h) and walks key
//     tiles of kBK = 64; each warp owns 8 rows, a lane keys lane, lane + 32.
//   K5: a block owns kKB = 32 keys of one (b, h) and walks query tiles of
//     kQT = 64; each warp owns 8 keys, a lane queries lane, lane + 32.
// d_used is a sum over b and over query tiles of every head's window. The
// TPU carried it in VMEM across a sequential grid; CUDA blocks run in no
// order. Design chosen: float32 atomicAdd into a zeroed (H, 2T-1, Dh)
// buffer. Each block first sums its tile's contribution per band row in
// registers (over the tile's 32 query rows), then adds it with one atomic
// per (band row, d), skipping zeros (the band rows outside the learned
// window, where p = 0). The order of the atomic adds changes from run to
// run, so d_used differs between runs by float32 rounding (relative ~1e-6
// of its magnitude); dq, dk and dv are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 128;
constexpr int kDt = kMaxDh / 32;  // head dims a lane owns, at most
// K3, K4
constexpr int kBQ = 32;
constexpr int kBK = 64;
constexpr int kRowsPerWarp = kBQ / kWarps;  // 8
constexpr int kBand = kBQ + kBK - 1;
// K5
constexpr int kKB = 32;
constexpr int kQT = 64;
constexpr int kKeysPerWarp = kKB / kWarps;  // 8
constexpr int kBand5 = kKB + kQT - 1;

constexpr float kNegFill = -1e8f;
constexpr uint32_t kKeepAll = 1u << 30;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// rounds to the input type, as the TPU kernels cast before a product
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__host__ __device__ constexpr int odd_stride(int dh) { return dh | 1; }

// _keep_mask of the TPU kernels, in uint32 arithmetic
__device__ __forceinline__ bool keep(uint32_t seed, uint32_t b, uint32_t h,
                                     uint32_t i, uint32_t j, uint32_t thresh) {
  uint32_t x = seed + b * 0x9E3779B9u + h * 0xCC9E2D51u + i * 0x1B873593u +
               j * 0xC2B2AE35u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 16;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (x & (kKeepAll - 1u)) < thresh;
}

// keep * scale_kept, with no mask work when nothing is dropped
__device__ __forceinline__ float keep_scale(bool dropping, uint32_t seed,
                                            uint32_t b, uint32_t h, uint32_t i,
                                            uint32_t j, uint32_t thresh,
                                            float kept) {
  if (!dropping) return kept;
  return keep(seed, b, h, i, j, thresh) ? kept : 0.f;
}

// ---------------------------------------------------------------------------
// K3: forward with saved lse and post-softmax dropout
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t fwd_smem_floats(int dh) {
  return static_cast<size_t>(kBQ) * dh               // Q
         + static_cast<size_t>(kBK) * odd_stride(dh)   // K
         + static_cast<size_t>(kBK) * dh               // V
         + static_cast<size_t>(kBand) * odd_stride(dh) // used band
         + static_cast<size_t>(kBQ) * kBK;             // P
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_train_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ used,
                       const float* __restrict__ oob,
                       const unsigned char* __restrict__ key_pad,
                       const int* __restrict__ seed_ptr,
                       float* __restrict__ out, float* __restrict__ lse,
                       int H, int Tn, int Dh, float scale, uint32_t thresh,
                       float keep_prob) {
  extern __shared__ float smem[];
  const int ks = odd_stride(Dh);
  float* Qs = smem;
  float* Ks = Qs + kBQ * Dh;
  float* Vs = Ks + kBK * ks;
  float* Us = Vs + kBK * Dh;
  float* Ps = Us + kBand * ks;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool dropping = thresh < kKeepAll;
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);

  const size_t bh = (static_cast<size_t>(b) * H + h) * Tn * Dh;
  const T* qb = q + bh;
  const T* kb = k + bh;
  const T* vb = v + bh;
  const T* ub = used + static_cast<size_t>(h) * (2 * Tn - 1) * Dh;
  const unsigned char* kpb = key_pad + static_cast<size_t>(b) * Tn;

  for (int e = tid; e < kBQ * Dh; e += kThreads) {
    Qs[e] = to_f32(qb[static_cast<size_t>(q0) * Dh + e]);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc[kRowsPerWarp][kDt];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = __int_as_float(0xff800000);  // -inf
    l[rr] = 0.f;
#pragma unroll
    for (int t = 0; t < kDt; ++t) acc[rr][t] = 0.f;
  }

  for (int k0 = 0; k0 < Tn; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < kBK * Dh; e += kThreads) {
      const int j = e / Dh, d = e - j * Dh;
      const size_t g = static_cast<size_t>(k0 + j) * Dh + d;
      Ks[j * ks + d] = to_f32(kb[g]);
      Vs[e] = to_f32(vb[g]);
    }
    // band rows r0 .. r0 + kBand - 1 of used; inside [0, 2T - 2] because
    // the tiles lie inside [0, T)
    const int r0 = k0 - q0 - kBQ + Tn;
    for (int e = tid; e < kBand * Dh; e += kThreads) {
      const int r = e / Dh, d = e - r * Dh;
      Us[r * ks + d] = to_f32(ub[static_cast<size_t>(r0 + r) * Dh + d]);
    }
    __syncthreads();

    float sqk[kRowsPerWarp][2], squ[kRowsPerWarp][2];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      sqk[rr][0] = sqk[rr][1] = 0.f;
      squ[rr][0] = squ[rr][1] = 0.f;
    }
    for (int d = 0; d < Dh; ++d) {
      const float k_a = Ks[lane * ks + d];
      const float k_b = Ks[(lane + 32) * ks + d];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int il = warp * kRowsPerWarp + rr;
        const float qv = Qs[il * Dh + d];
        const int band = lane - il + kBQ - 1;  // column lane; lane+32 is +32
        sqk[rr][0] = fmaf(qv, k_a, sqk[rr][0]);
        sqk[rr][1] = fmaf(qv, k_b, sqk[rr][1]);
        squ[rr][0] = fmaf(qv, Us[band * ks + d], squ[rr][0]);
        squ[rr][1] = fmaf(qv, Us[(band + 32) * ks + d], squ[rr][1]);
      }
    }

    const int ja = k0 + lane, jb = ja + 32;
    const float kp_a = kpb[ja] ? kNegFill : 0.f;
    const float kp_b = kpb[jb] ? kNegFill : 0.f;
    float alpha[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int il = warp * kRowsPerWarp + rr;
      const int i = q0 + il;
      const int ra = ja - i + Tn - 1;
      const float s_a = (sqk[rr][0] * scale + (squ[rr][0] + oob[ra])) + kp_a;
      const float s_b = (sqk[rr][1] * scale + (squ[rr][1] + oob[ra + 32])) + kp_b;
      float mx = fmaxf(s_a, s_b);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[rr], mx);
      float p_a = expf(s_a - m_new);
      float p_b = expf(s_b - m_new);
      float sum = p_a + p_b;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      alpha[rr] = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha[rr] + sum;  // the undropped normalizer
      m[rr] = m_new;
      p_a *= keep_scale(dropping, seed, b, h, i, ja, thresh, 1.f);
      p_b *= keep_scale(dropping, seed, b, h, i, jb, thresh, 1.f);
      Ps[il * kBK + lane] = round_like(p_a, q);
      Ps[il * kBK + lane + 32] = round_like(p_b, q);
    }
    __syncwarp();  // a warp reads back only its own rows of Ps

#pragma unroll
    for (int t = 0; t < kDt; ++t) {
      const int dd = lane + 32 * t;
      if (dd < Dh) {
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) acc[rr][t] *= alpha[rr];
        for (int j = 0; j < kBK; ++j) {
          const float vv = Vs[j * Dh + dd];
#pragma unroll
          for (int rr = 0; rr < kRowsPerWarp; ++rr) {
            acc[rr][t] = fmaf(Ps[(warp * kRowsPerWarp + rr) * kBK + j], vv, acc[rr][t]);
          }
        }
      }
    }
  }

  float* ob = out + bh;
  float* lb = lse + (static_cast<size_t>(b) * H + h) * Tn;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = q0 + warp * kRowsPerWarp + rr;
    const float denom = l[rr] * keep_prob;
#pragma unroll
    for (int t = 0; t < kDt; ++t) {
      const int dd = lane + 32 * t;
      if (dd < Dh) ob[static_cast<size_t>(i) * Dh + dd] = acc[rr][t] / denom;
    }
    if (lane == 0) lb[i] = m[rr] + logf(l[rr]);
  }
}

// ---------------------------------------------------------------------------
// K4: dq and d_used
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t dq_smem_floats(int dh) {
  const size_t v_or_ds = static_cast<size_t>(kBK) * odd_stride(dh) > static_cast<size_t>(kBQ) * kBK
                             ? static_cast<size_t>(kBK) * odd_stride(dh)
                             : static_cast<size_t>(kBQ) * kBK;
  return 2 * static_cast<size_t>(kBQ) * dh             // Q, dO
         + static_cast<size_t>(kBK) * odd_stride(dh)   // K
         + v_or_ds                                     // V, then DS
         + static_cast<size_t>(kBand) * odd_stride(dh); // used band
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_train_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ used,
                          const float* __restrict__ oob,
                          const unsigned char* __restrict__ key_pad,
                          const int* __restrict__ seed_ptr,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq, float* __restrict__ dused,
                          int H, int Tn, int Dh, float scale, uint32_t thresh,
                          float keep_prob) {
  extern __shared__ float smem[];
  const int ks = odd_stride(Dh);
  float* Qs = smem;
  float* DOs = Qs + kBQ * Dh;
  float* Ks = DOs + kBQ * Dh;
  float* Vs = Ks + kBK * ks;
  float* DS = Vs;  // V is dead once the tile's dO.v is formed
  const size_t v_or_ds = static_cast<size_t>(kBK) * ks > static_cast<size_t>(kBQ) * kBK
                             ? static_cast<size_t>(kBK) * ks
                             : static_cast<size_t>(kBQ) * kBK;
  float* Us = Vs + v_or_ds;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool dropping = thresh < kKeepAll;
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
  const float kept = 1.0f / keep_prob;

  const size_t bh = (static_cast<size_t>(b) * H + h) * Tn * Dh;
  const size_t bhr = (static_cast<size_t>(b) * H + h) * Tn;
  const T* qb = q + bh;
  const T* kb = k + bh;
  const T* vb = v + bh;
  const T* dob = dout + bh;
  const T* ub = used + static_cast<size_t>(h) * (2 * Tn - 1) * Dh;
  float* dub = dused + static_cast<size_t>(h) * (2 * Tn - 1) * Dh;
  const unsigned char* kpb = key_pad + static_cast<size_t>(b) * Tn;

  for (int e = tid; e < kBQ * Dh; e += kThreads) {
    Qs[e] = to_f32(qb[static_cast<size_t>(q0) * Dh + e]);
    DOs[e] = to_f32(dob[static_cast<size_t>(q0) * Dh + e]);
  }
  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp];
  float acck[kRowsPerWarp][kDt], accu[kRowsPerWarp][kDt];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = q0 + warp * kRowsPerWarp + rr;
    lse_r[rr] = lse[bhr + i];
    delta_r[rr] = delta[bhr + i];
#pragma unroll
    for (int t = 0; t < kDt; ++t) acck[rr][t] = accu[rr][t] = 0.f;
  }

  for (int k0 = 0; k0 < Tn; k0 += kBK) {
    __syncthreads();  // the previous tile's K, DS and band are no longer read
    for (int e = tid; e < kBK * Dh; e += kThreads) {
      const int j = e / Dh, d = e - j * Dh;
      const size_t g = static_cast<size_t>(k0 + j) * Dh + d;
      Ks[j * ks + d] = to_f32(kb[g]);
      Vs[j * ks + d] = to_f32(vb[g]);
    }
    const int r0 = k0 - q0 - kBQ + Tn;
    for (int e = tid; e < kBand * Dh; e += kThreads) {
      const int r = e / Dh, d = e - r * Dh;
      Us[r * ks + d] = to_f32(ub[static_cast<size_t>(r0 + r) * Dh + d]);
    }
    __syncthreads();

    float sqk[kRowsPerWarp][2], squ[kRowsPerWarp][2], sdv[kRowsPerWarp][2];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      sqk[rr][0] = sqk[rr][1] = 0.f;
      squ[rr][0] = squ[rr][1] = 0.f;
      sdv[rr][0] = sdv[rr][1] = 0.f;
    }
    for (int d = 0; d < Dh; ++d) {
      const float k_a = Ks[lane * ks + d];
      const float k_b = Ks[(lane + 32) * ks + d];
      const float v_a = Vs[lane * ks + d];
      const float v_b = Vs[(lane + 32) * ks + d];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int il = warp * kRowsPerWarp + rr;
        const float qv = Qs[il * Dh + d];
        const float dov = DOs[il * Dh + d];
        const int band = lane - il + kBQ - 1;
        sqk[rr][0] = fmaf(qv, k_a, sqk[rr][0]);
        sqk[rr][1] = fmaf(qv, k_b, sqk[rr][1]);
        squ[rr][0] = fmaf(qv, Us[band * ks + d], squ[rr][0]);
        squ[rr][1] = fmaf(qv, Us[(band + 32) * ks + d], squ[rr][1]);
        sdv[rr][0] = fmaf(dov, v_a, sdv[rr][0]);
        sdv[rr][1] = fmaf(dov, v_b, sdv[rr][1]);
      }
    }
    __syncthreads();  // every warp is done with V: DS takes its place

    const int ja = k0 + lane, jb = ja + 32;
    const float kp_a = kpb[ja] ? kNegFill : 0.f;
    const float kp_b = kpb[jb] ? kNegFill : 0.f;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int il = warp * kRowsPerWarp + rr;
      const int i = q0 + il;
      const int ra = ja - i + Tn - 1;
      const float s_a = (sqk[rr][0] * scale + (squ[rr][0] + oob[ra])) + kp_a;
      const float s_b = (sqk[rr][1] * scale + (squ[rr][1] + oob[ra + 32])) + kp_b;
      const float p_a = expf(s_a - lse_r[rr]);
      const float p_b = expf(s_b - lse_r[rr]);
      const float dp_a = sdv[rr][0] * keep_scale(dropping, seed, b, h, i, ja, thresh, kept);
      const float dp_b = sdv[rr][1] * keep_scale(dropping, seed, b, h, i, jb, thresh, kept);
      DS[il * kBK + lane] = round_like(p_a * (dp_a - delta_r[rr]), q);
      DS[il * kBK + lane + 32] = round_like(p_b * (dp_b - delta_r[rr]), q);
    }
    __syncthreads();  // the d_used pass below reads every row of DS

#pragma unroll
    for (int t = 0; t < kDt; ++t) {
      const int dd = lane + 32 * t;
      if (dd < Dh) {
        for (int j = 0; j < kBK; ++j) {
          const float kv = Ks[j * ks + dd];
#pragma unroll
          for (int rr = 0; rr < kRowsPerWarp; ++rr) {
            const int il = warp * kRowsPerWarp + rr;
            const float ds = DS[il * kBK + j];
            acck[rr][t] = fmaf(ds, kv, acck[rr][t]);
            accu[rr][t] = fmaf(ds, Us[(j - il + kBQ - 1) * ks + dd], accu[rr][t]);
          }
        }
      }
    }

    // this tile's share of d_used: band row rl holds the (il, j) with
    // j - il + kBQ - 1 = rl
    for (int e = tid; e < kBand * Dh; e += kThreads) {
      const int rl = e / Dh, d = e - rl * Dh;
      const int lo = rl < kBQ - 1 ? kBQ - 1 - rl : 0;
      const int hi = rl > kBK - 1 ? kBQ - 1 - (rl - (kBK - 1)) : kBQ - 1;
      float sum = 0.f;
      for (int il = lo; il <= hi; ++il) {
        sum = fmaf(DS[il * kBK + rl + il - (kBQ - 1)], Qs[il * Dh + d], sum);
      }
      if (sum != 0.f) atomicAdd(dub + static_cast<size_t>(r0 + rl) * Dh + d, sum);
    }
  }

  float* dqb = dq + bh;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = q0 + warp * kRowsPerWarp + rr;
#pragma unroll
    for (int t = 0; t < kDt; ++t) {
      const int dd = lane + 32 * t;
      if (dd < Dh) dqb[static_cast<size_t>(i) * Dh + dd] = acck[rr][t] * scale + accu[rr][t];
    }
  }
}

// ---------------------------------------------------------------------------
// K5: dk and dv
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t dkv_smem_floats(int dh) {
  return 2 * static_cast<size_t>(kKB) * dh                 // K, V
         + 2 * static_cast<size_t>(kQT) * odd_stride(dh)   // Q, dO
         + static_cast<size_t>(kBand5) * odd_stride(dh)    // used band
         + 2 * static_cast<size_t>(kKB) * kQT              // PD, DS
         + 2 * static_cast<size_t>(kQT);                   // lse, delta
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_train_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ used,
                           const float* __restrict__ oob,
                           const unsigned char* __restrict__ key_pad,
                           const int* __restrict__ seed_ptr,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int H, int Tn, int Dh, float scale, uint32_t thresh,
                           float keep_prob) {
  extern __shared__ float smem[];
  const int qs = odd_stride(Dh);
  float* Kb = smem;
  float* Vb = Kb + kKB * Dh;
  float* Qs = Vb + kKB * Dh;
  float* DOs = Qs + kQT * qs;
  float* Us = DOs + kQT * qs;
  float* PD = Us + kBand5 * qs;
  float* DS = PD + kKB * kQT;
  float* Ls = DS + kKB * kQT;
  float* Dl = Ls + kQT;

  const int k0 = blockIdx.x * kKB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool dropping = thresh < kKeepAll;
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
  const float kept = 1.0f / keep_prob;

  const size_t bh = (static_cast<size_t>(b) * H + h) * Tn * Dh;
  const size_t bhr = (static_cast<size_t>(b) * H + h) * Tn;
  const T* qb = q + bh;
  const T* kb = k + bh;
  const T* vb = v + bh;
  const T* dob = dout + bh;
  const T* ub = used + static_cast<size_t>(h) * (2 * Tn - 1) * Dh;
  const unsigned char* kpb = key_pad + static_cast<size_t>(b) * Tn;

  for (int e = tid; e < kKB * Dh; e += kThreads) {
    Kb[e] = to_f32(kb[static_cast<size_t>(k0) * Dh + e]);
    Vb[e] = to_f32(vb[static_cast<size_t>(k0) * Dh + e]);
  }
  float kp_r[kKeysPerWarp];
  float dka[kKeysPerWarp][kDt], dva[kKeysPerWarp][kDt];
#pragma unroll
  for (int rr = 0; rr < kKeysPerWarp; ++rr) {
    kp_r[rr] = kpb[k0 + warp * kKeysPerWarp + rr] ? kNegFill : 0.f;
#pragma unroll
    for (int t = 0; t < kDt; ++t) dka[rr][t] = dva[rr][t] = 0.f;
  }

  for (int q0 = 0; q0 < Tn; q0 += kQT) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < kQT * Dh; e += kThreads) {
      const int i = e / Dh, d = e - i * Dh;
      const size_t g = static_cast<size_t>(q0 + i) * Dh + d;
      Qs[i * qs + d] = to_f32(qb[g]);
      DOs[i * qs + d] = to_f32(dob[g]);
    }
    // band rows r0 .. r0 + kBand5 - 1: r = j - i + T - 1 over keys
    // k0 .. k0 + kKB - 1 and queries q0 .. q0 + kQT - 1
    const int r0 = k0 - q0 - kQT + Tn;
    for (int e = tid; e < kBand5 * Dh; e += kThreads) {
      const int r = e / Dh, d = e - r * Dh;
      Us[r * qs + d] = to_f32(ub[static_cast<size_t>(r0 + r) * Dh + d]);
    }
    for (int e = tid; e < kQT; e += kThreads) {
      Ls[e] = lse[bhr + q0 + e];
      Dl[e] = delta[bhr + q0 + e];
    }
    __syncthreads();

    float sqk[kKeysPerWarp][2], squ[kKeysPerWarp][2], sdv[kKeysPerWarp][2];
#pragma unroll
    for (int rr = 0; rr < kKeysPerWarp; ++rr) {
      sqk[rr][0] = sqk[rr][1] = 0.f;
      squ[rr][0] = squ[rr][1] = 0.f;
      sdv[rr][0] = sdv[rr][1] = 0.f;
    }
    for (int d = 0; d < Dh; ++d) {
      const float q_a = Qs[lane * qs + d];
      const float q_b = Qs[(lane + 32) * qs + d];
      const float do_a = DOs[lane * qs + d];
      const float do_b = DOs[(lane + 32) * qs + d];
#pragma unroll
      for (int rr = 0; rr < kKeysPerWarp; ++rr) {
        const int jl = warp * kKeysPerWarp + rr;
        const float kv = Kb[jl * Dh + d];
        const float vv = Vb[jl * Dh + d];
        const int band = jl - lane + kQT - 1;  // query lane; lane+32 is -32
        sqk[rr][0] = fmaf(q_a, kv, sqk[rr][0]);
        sqk[rr][1] = fmaf(q_b, kv, sqk[rr][1]);
        squ[rr][0] = fmaf(q_a, Us[band * qs + d], squ[rr][0]);
        squ[rr][1] = fmaf(q_b, Us[(band - 32) * qs + d], squ[rr][1]);
        sdv[rr][0] = fmaf(do_a, vv, sdv[rr][0]);
        sdv[rr][1] = fmaf(do_b, vv, sdv[rr][1]);
      }
    }

    const int ia = q0 + lane, ib = ia + 32;
#pragma unroll
    for (int rr = 0; rr < kKeysPerWarp; ++rr) {
      const int jl = warp * kKeysPerWarp + rr;
      const int j = k0 + jl;
      const int ra = j - ia + Tn - 1;
      const float s_a = (sqk[rr][0] * scale + (squ[rr][0] + oob[ra])) + kp_r[rr];
      const float s_b = (sqk[rr][1] * scale + (squ[rr][1] + oob[ra - 32])) + kp_r[rr];
      const float p_a = expf(s_a - Ls[lane]);
      const float p_b = expf(s_b - Ls[lane + 32]);
      const float kk_a = keep_scale(dropping, seed, b, h, ia, j, thresh, kept);
      const float kk_b = keep_scale(dropping, seed, b, h, ib, j, thresh, kept);
      PD[jl * kQT + lane] = round_like(p_a * kk_a, q);
      PD[jl * kQT + lane + 32] = round_like(p_b * kk_b, q);
      DS[jl * kQT + lane] = round_like(p_a * (sdv[rr][0] * kk_a - Dl[lane]), q);
      DS[jl * kQT + lane + 32] = round_like(p_b * (sdv[rr][1] * kk_b - Dl[lane + 32]), q);
    }
    __syncwarp();  // a warp reads back only its own keys' rows of PD, DS

#pragma unroll
    for (int t = 0; t < kDt; ++t) {
      const int dd = lane + 32 * t;
      if (dd < Dh) {
        for (int i = 0; i < kQT; ++i) {
          const float qv = Qs[i * qs + dd];
          const float dov = DOs[i * qs + dd];
#pragma unroll
          for (int rr = 0; rr < kKeysPerWarp; ++rr) {
            const int jl = warp * kKeysPerWarp + rr;
            dva[rr][t] = fmaf(PD[jl * kQT + i], dov, dva[rr][t]);
            dka[rr][t] = fmaf(DS[jl * kQT + i], qv, dka[rr][t]);
          }
        }
      }
    }
  }

  float* dkb = dk + bh;
  float* dvb = dv + bh;
#pragma unroll
  for (int rr = 0; rr < kKeysPerWarp; ++rr) {
    const int j = k0 + warp * kKeysPerWarp + rr;
#pragma unroll
    for (int t = 0; t < kDt; ++t) {
      const int dd = lane + 32 * t;
      if (dd < Dh) {
        dkb[static_cast<size_t>(j) * Dh + dd] = dka[rr][t] * scale;
        dvb[static_cast<size_t>(j) * Dh + dd] = dva[rr][t];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool bad_shape(int B, int H, int Tn, int Dh) {
  return B <= 0 || H <= 0 || Tn <= 0 || Tn % kBK != 0 || Tn % kQT != 0 ||
         Dh <= 0 || Dh > kMaxDh;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch_fwd(const T* q, const T* k, const T* v, const T* used,
               const float* oob, const unsigned char* key_pad, const int* seed,
               float* out, float* lse, int B, int H, int Tn, int Dh,
               int thresh, float keep_prob, cudaStream_t stream) {
  if (bad_shape(B, H, Tn, Dh)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = fwd_smem_floats(Dh) * sizeof(float);
  cudaError_t err = set_smem(flash_train_fwd_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.0f / sqrtf(static_cast<float>(Dh));
  flash_train_fwd_kernel<T><<<dim3(Tn / kBQ, H, B), kThreads, bytes, stream>>>(
      q, k, v, used, oob, key_pad, seed, out, lse, H, Tn, Dh, scale,
      static_cast<uint32_t>(thresh), keep_prob);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dq(const T* q, const T* k, const T* v, const T* used,
              const float* oob, const unsigned char* key_pad, const int* seed,
              const T* dout, const float* lse, const float* delta, float* dq,
              float* dused, int B, int H, int Tn, int Dh, int thresh,
              float keep_prob, cudaStream_t stream) {
  if (bad_shape(B, H, Tn, Dh)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = dq_smem_floats(Dh) * sizeof(float);
  cudaError_t err = set_smem(flash_train_bwd_dq_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.0f / sqrtf(static_cast<float>(Dh));
  flash_train_bwd_dq_kernel<T><<<dim3(Tn / kBQ, H, B), kThreads, bytes, stream>>>(
      q, k, v, used, oob, key_pad, seed, dout, lse, delta, dq, dused, H, Tn,
      Dh, scale, static_cast<uint32_t>(thresh), keep_prob);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkv(const T* q, const T* k, const T* v, const T* used,
               const float* oob, const unsigned char* key_pad, const int* seed,
               const T* dout, const float* lse, const float* delta, float* dk,
               float* dv, int B, int H, int Tn, int Dh, int thresh,
               float keep_prob, cudaStream_t stream) {
  if (bad_shape(B, H, Tn, Dh)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = dkv_smem_floats(Dh) * sizeof(float);
  cudaError_t err = set_smem(flash_train_bwd_dkv_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.0f / sqrtf(static_cast<float>(Dh));
  flash_train_bwd_dkv_kernel<T><<<dim3(Tn / kKB, H, B), kThreads, bytes, stream>>>(
      q, k, v, used, oob, key_pad, seed, dout, lse, delta, dk, dv, H, Tn, Dh,
      scale, static_cast<uint32_t>(thresh), keep_prob);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FWD_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const T* q, const T* k, const T* v, const T* used,     \
                      const float* oob, const unsigned char* key_pad,         \
                      const int* seed, float* out, float* lse, int B, int H,  \
                      int Tn, int Dh, int thresh, float keep_prob,            \
                      cudaStream_t stream) {                                  \
    return launch_fwd<T>(q, k, v, used, oob, key_pad, seed, out, lse, B, H,   \
                         Tn, Dh, thresh, keep_prob, stream);                  \
  }

#define BWD_ENTRY(NAME, LAUNCH, T)                                            \
  extern "C" int NAME(const T* q, const T* k, const T* v, const T* used,     \
                      const float* oob, const unsigned char* key_pad,         \
                      const int* seed, const T* dout, const float* lse,       \
                      const float* delta, float* g1, float* g2, int B, int H, \
                      int Tn, int Dh, int thresh, float keep_prob,            \
                      cudaStream_t stream) {                                  \
    return LAUNCH<T>(q, k, v, used, oob, key_pad, seed, dout, lse, delta, g1, \
                     g2, B, H, Tn, Dh, thresh, keep_prob, stream);            \
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
