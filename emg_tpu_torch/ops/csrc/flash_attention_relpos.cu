// Encoder self-attention with a learned relative-position bias, fused, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// emg_tpu/ops/pallas/flash_attention.py::flash_attention_relpos (serving
// forward). For each (b, h) and query row i:
//
//   s[j]  = (q_i . k_j) * scale + ((q_i . used[r]) + oob[r]) + kp[j],
//           r = j - i + T - 1,  kp[j] = -1e8 on a padded key, else 0
//   out_i = softmax(s) . v
//
// with an online softmax, float32 accumulation and a float32 output. Like
// the TPU kernel it ADDS -1e8 on padded keys and leaves padded query rows
// unmasked: their outputs are defined but meaningless, and callers drop
// them. q, k, v and used arrive as float32 or bfloat16; with bfloat16 the
// probabilities are rounded to bfloat16 before the product with v, as the
// TPU kernel does.
//
// What bounds it on an H100: operations. Per (b, h) the kernel does
// 2*T*T*Dh multiply-adds each for q.k, q.used and p.v against ~4*T*Dh
// values read, so at the main path's shapes (T >= 128, Dh = 96) it sits far
// above the card's ratio of operations to bytes. The cost formula of the
// TPU kernel (flash_attention.py:179-183) counts 2*B*H*T*(2*T*Dh + W*Dh)
// flops, W the padded relative window.
//
// Design. The TPU kernel formed q.used over the whole relative window and
// rolled rows (a Mosaic lane-alignment workaround) so every key block's
// bias became one aligned slice. Here nothing is rolled: a block owns
// kBQ = 32 query rows of one (b, h); for each tile of kBK = 64 keys it
// stages K, V and the band of kBQ + kBK - 1 rows of `used` that the tile
// touches in shared memory (float32, rows padded to an odd stride so the
// lanes of a warp hit distinct banks), and each thread forms q.used for
// exactly the (i, j) pairs it owns, reading band row j - i + kBQ - 1. Each
// warp owns 8 query rows; a lane owns key columns lane and lane + 32 of the
// tile. Products are scalar float32 FMAs: a simple kernel that is right.
// Tensor cores (mma.sync / wgmma) with TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBQ = 32;
constexpr int kBK = 64;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBQ / kWarps;  // 8
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDh = 128;
constexpr int kBand = kBQ + kBK - 1;
constexpr float kNegFill = -1e8f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// rounds p to the input type, as the TPU kernel casts p before p @ v
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__host__ __device__ constexpr int odd_stride(int dh) { return dh | 1; }

__host__ __device__ inline size_t smem_floats(int dh) {
  return static_cast<size_t>(kBQ) * dh            // Q
         + static_cast<size_t>(kBK) * odd_stride(dh)   // K
         + static_cast<size_t>(kBK) * dh               // V
         + static_cast<size_t>(kBand) * odd_stride(dh) // used band
         + static_cast<size_t>(kBQ) * kBK;             // P
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_relpos_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ used,
                    const float* __restrict__ oob,
                    const unsigned char* __restrict__ key_pad,
                    float* __restrict__ out, int H, int Tn, int Dh,
                    float scale) {
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
  float acc[kRowsPerWarp][kMaxDh / 32];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = __int_as_float(0xff800000);  // -inf
    l[rr] = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxDh / 32; ++t) acc[rr][t] = 0.f;
  }

  for (int k0 = 0; k0 < Tn; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < kBK * Dh; e += kThreads) {
      const int j = e / Dh, d = e - j * Dh;
      const size_t g = static_cast<size_t>(k0 + j) * Dh + d;
      Ks[j * ks + d] = to_f32(kb[g]);
      Vs[e] = to_f32(vb[g]);
    }
    // band rows r0 .. r0 + kBand - 1 of used; r0 >= 0 and the last row
    // <= 2T - 2 because the tiles lie inside [0, T)
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

    const float kp_a = kpb[k0 + lane] ? kNegFill : 0.f;
    const float kp_b = kpb[k0 + lane + 32] ? kNegFill : 0.f;
    float alpha[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int il = warp * kRowsPerWarp + rr;
      const int i = q0 + il;
      const int ra = k0 + lane - i + Tn - 1;
      const float s_a = (sqk[rr][0] * scale + (squ[rr][0] + oob[ra])) + kp_a;
      const float s_b = (sqk[rr][1] * scale + (squ[rr][1] + oob[ra + 32])) + kp_b;
      float mx = fmaxf(s_a, s_b);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[rr], mx);
      const float p_a = expf(s_a - m_new);
      const float p_b = expf(s_b - m_new);
      float sum = p_a + p_b;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      alpha[rr] = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha[rr] + sum;
      m[rr] = m_new;
      Ps[il * kBK + lane] = round_like(p_a, q);
      Ps[il * kBK + lane + 32] = round_like(p_b, q);
    }
    __syncwarp();  // a warp reads back only its own rows of Ps

#pragma unroll
    for (int t = 0; t < kMaxDh / 32; ++t) {
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
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = q0 + warp * kRowsPerWarp + rr;
#pragma unroll
    for (int t = 0; t < kMaxDh / 32; ++t) {
      const int dd = lane + 32 * t;
      if (dd < Dh) ob[static_cast<size_t>(i) * Dh + dd] = acc[rr][t] / l[rr];
    }
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const T* used, const float* oob,
           const unsigned char* key_pad, float* out, int B, int H, int Tn,
           int Dh, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Tn <= 0 || Tn % kBK != 0 || Dh <= 0 || Dh > kMaxDh) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = smem_floats(Dh) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_relpos_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Tn / kBQ, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(Dh));
  flash_relpos_kernel<T><<<grid, kThreads, bytes, stream>>>(
      q, k, v, used, oob, key_pad, out, H, Tn, Dh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_relpos_f32(const float* q, const float* k,
                                          const float* v, const float* used,
                                          const float* oob,
                                          const unsigned char* key_pad,
                                          float* out, int B, int H, int T,
                                          int Dh, cudaStream_t stream) {
  return launch<float>(q, k, v, used, oob, key_pad, out, B, H, T, Dh, stream);
}

extern "C" int flash_attention_relpos_bf16(const __nv_bfloat16* q,
                                           const __nv_bfloat16* k,
                                           const __nv_bfloat16* v,
                                           const __nv_bfloat16* used,
                                           const float* oob,
                                           const unsigned char* key_pad,
                                           float* out, int B, int H, int T,
                                           int Dh, cudaStream_t stream) {
  return launch<__nv_bfloat16>(q, k, v, used, oob, key_pad, out, B, H, T, Dh,
                               stream);
}

extern "C" const char* flash_attention_relpos_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
