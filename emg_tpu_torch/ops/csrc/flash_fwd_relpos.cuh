// The forward kernel of the encoder self-attention with a learned relative-
// position bias, on Hopper's tensor cores (sm_90a). One template serves
// two libraries:
//   flash_attention_relpos.cu        serving forward (K2), kTrain = false
//   flash_attention_relpos_train.cu  training forward (K3), kTrain = true:
//                                    saved logsumexp and hash dropout
// replacing the Pallas TPU kernels of emg_tpu/ops/pallas/flash_attention.py
// flash_attention_relpos (:67-121) and _flash_train_fwd (:245-298). For
// each (b, h), query row i and key j (r = j - i + T - 1):
//
//   s[i,j] = (q_i . k_j) * scale + ((q_i . used[r]) + oob[r]) + kp[j]
//   o_i    = sum_j keep * exp(s[i,j] - m_i) v_j / (l_i * keep_prob)
//   lse_i  = m_i + log l_i                                   (training)
//
// with kp[j] = -1e8 ADDED at a padded key, padded query rows unmasked (their
// outputs are meaningless and callers drop them), l the undropped
// normalizer, and keep = 1, keep_prob = 1 when serving. float32
// accumulation and output; with bfloat16 inputs p is rounded to bfloat16
// before p.v, where the TPU kernel rounds it.
//
// What bounds it on an H100: operations. Per (b, h) it does 2*T*T*Dh
// multiply-adds for each of q.k, q.used and p.v against ~4*T*Dh values
// read: at T >= 128, Dh = 96 far above the card's ratio of operations to
// bytes. So every product runs on the tensor cores, by mma.sync:
// - bfloat16: m16n8k16 bf16 -> f32, fragments loaded by ldmatrix from
//   bfloat16 shared memory (bf16 stays bf16 from device memory to the mma);
// - float32: 3xTF32 on m16n8k8 tf32. Each operand is split in registers,
//   hi = rna_tf32(x), lo = rna_tf32(x - hi) (cvt.rna.tf32.f32's rounding,
//   done in integer instructions: see tf32()), and each product is
//   lo.hi + hi.lo + hi.hi: float32 accuracy (the dropped lo.lo is ~2^-22
//   of the product) at three tensor-core passes, which is why the float32
//   bound is taken at 495/3 TFLOP/s. A single TF32 pass (~1e-3) would not
//   hold K3 to its plain version's 1e-4.
// mma.sync was chosen over wgmma: a warp owns 16 query rows, which is what
// the relative logits' per-warp band and skew below need, and a warpgroup
// wgmma would need a 64-row tile per four warps and a shared-memory A or
// B for every product, the skew scratch included. wgmma is later work.
//
// Design.
// - A block owns kQW warps of 16 query rows of one (b, h) and walks the keys
//   in tiles of kBK = 64. K and V tiles are copied by cp.async (16 bytes a
//   thread), double-buffered: tile k+1 is in flight while tile k computes.
//   Rows are padded by 16 bytes, so ldmatrix's eight row reads and the
//   float32 V reads below hit distinct banks.
// - Relative logits on the tensor cores. The TPU formed q.used over the
//   whole window and rolled rows (a Mosaic lane-alignment trick with no
//   Hopper counterpart). Here, for a key tile, warp w's 16 rows touch
//   16 + 64 - 1 = 79 rows of `used`, padded to 80, starting at row
//   k0 - q0_w - 16 + T (inside [0, 2T - 2]). The warp computes
//   Q_w . Band_w^T (16 x 80) with the same mma as q.k (1.25x its cost),
//   adds oob per column, and writes the accumulator to its own float32
//   scratch (row stride 88 floats: conflict-free float2 writes, 2-way
//   reads). Each thread then reads, for S fragment element (i, j), column
//   j - i + 15. The block stages one band of 16 * kQW + 64 rows covering its
//   warps (the last row may lie past 2T - 2: zero-filled, never read); it
//   is single-buffered and prefetched as soon as every warp has formed its
//   relative logits, so it arrives while the tile's q.k, softmax and p.v
//   run. float32 shared memory would not hold a double-buffered band with
//   double-buffered K and V.
// - p.v takes p straight from q.k's accumulator: for bfloat16 the m16n8k16
//   A fragment is two adjacent n8 accumulator tiles; for tf32 the key order
//   inside each k8 step is permuted (A column t <-> key 2t, t + 4 <-> key
//   2t + 1), and V is read in the same order, so no shuffle is needed.
// - Q is staged once into K/V buffer 1 (free until tile 1 is fetched) and
//   held in registers as mma A fragments (Dh / 16 or Dh / 8 steps of four
//   registers).
// - Dropout (K3): keep(seed, b, h, i, j) on each fragment element's global
//   indices, the same mask as K4, K5, the plain version and JAX. b and h
//   are the block's plus b_off and h_off: a mesh rank that holds batch rows
//   and heads from those offsets on draws the unsharded step's mask.
// - Grid fill and occupancy. Blocks of kQW = 1 (16 rows, one warp), 4 (64
//   rows) or, for float32 with T a multiple of 128, 8 (128 rows); wider
//   blocks share each K, V and band tile among more warps. The launcher
//   takes the width with the fewest waves over the card (blocks over SMs x
//   the blocks an SM holds, from cudaOccupancyMaxActiveBlocksPerMultiprocessor),
//   the narrower on a tie. At serving's B = 1, H = 8, T = 128-384 64-row
//   blocks would be 16-48 for 132 SMs; 16-row blocks are 64-192, one wave.
//   Shared memory at Dh = 96: 100 KB a 64-row bfloat16 block (two blocks,
//   eight warps an SM), 74 KB a 16-row one (three an SM); a float32 64-row
//   block (172 KB) leaves an SM one block of four warps, latency-bound at
//   one warp a scheduler, so at training's shapes float32 takes 128-row
//   blocks (219 KB, eight warps), and a float32 16-row block (137 KB) holds
//   a single warp on its SM.
//   ptxas gives the float32 kernels its 255-register cap with a few spilled
//   bytes, the bfloat16 ones ~168 registers.
// - T must be a multiple of 64, Dh one of 64, 96, 128 (a template
//   argument: the accumulators are registers).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegFill = -1e8f;
constexpr uint32_t kKeepAll = 1u << 30;

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

namespace fwd {

constexpr int kBK = 64;       // keys per tile
constexpr int kBandN = 10;    // n8 tiles of a warp's band: 16 + 64 - 1 -> 80
constexpr int kKeyN = kBK / 8;
constexpr int kRS = 88;       // scratch row stride, floats

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-fills when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cvt.rna.tf32.f32 for finite x (round to nearest, ties away from zero, on
// the magnitude's bits) in two integer instructions: ptxas expands the cvt
// into four, with a check for inf and NaN that the finite operands here
// never need
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a tf32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a . b in float32 accuracy: lo.hi + hi.lo + hi.hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// acc[n] += Q_w . B^T for the 8 * kN rows of B from shared address `base`
// (row stride row_bytes), Q_w in registers as kSteps A fragments. A k-step
// spans 32 bytes of a row: 16 bfloat16 or 8 float32 values.
template <typename T, int kSteps, int kN>
__device__ __forceinline__ void gemm_qbt(float (&acc)[kN][4], const uint32_t (&qa)[kSteps][4],
                                         uint32_t base, int row_bytes, int lane) {
  // ldmatrix x4: matrices (rows 0-7, k lo), (rows 0-7, k hi), (rows 8-15,
  // k lo), (rows 8-15, k hi): b0, b1 of n8 tile 2np and of 2np + 1
  const uint32_t lane_off =
      ((lane & 7) + ((lane >> 4) << 3)) * row_bytes + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    if constexpr (std::is_same<T, float>::value) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) split(__uint_as_float(qa[kk][x]), ah[x], al[x]);
#pragma unroll
      for (int np = 0; np < kN / 2; ++np) {
        uint32_t bf[4], bh[4], bl[4];
        ldsm_x4(base + lane_off + np * 16 * row_bytes + kk * 32, bf);
#pragma unroll
        for (int x = 0; x < 4; ++x) split(__uint_as_float(bf[x]), bh[x], bl[x]);
        mma_3xtf32(acc[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma_3xtf32(acc[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
    } else {
#pragma unroll
      for (int np = 0; np < kN / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(base + lane_off + np * 16 * row_bytes + kk * 32, bf);
        mma_bf16(acc[2 * np], qa[kk], bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], qa[kk], bf[2], bf[3]);
      }
    }
  }
}

template <typename T, int kQW, int kDh>
struct Layout {
  static constexpr int kE = 16 / sizeof(T);        // values per 16-byte chunk
  static constexpr int kS = kDh + kE;              // shared row stride, values
  static constexpr int kRowBytes = kS * sizeof(T);
  static constexpr int kChunks = kDh / kE;         // 16-byte chunks per row
  static constexpr int kBQ = 16 * kQW;
  static constexpr int kBandRows = kBQ + kBK;
  static constexpr size_t kTileBytes = static_cast<size_t>(kBK) * kRowBytes;
  // K, V of buffer 0, K, V of buffer 1 (where Q is staged first), the band,
  // the scratch
  static constexpr size_t kBandOffset = 4 * kTileBytes;
  static constexpr size_t kScratchOffset = kBandOffset + static_cast<size_t>(kBandRows) * kRowBytes;
  static constexpr size_t kBytes = kScratchOffset + static_cast<size_t>(kQW) * 16 * kRS * sizeof(float);
  static_assert(kBQ * kRowBytes <= 2 * kTileBytes, "Q must fit buffer 1");
};

template <typename T, bool kTrain, int kQW, int kDh>
__global__ void __launch_bounds__(kQW * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ used, const float* __restrict__ oob,
                 const unsigned char* __restrict__ key_pad, const int* __restrict__ seed_ptr,
                 float* __restrict__ out, float* __restrict__ lse, int H, int Tn, float scale,
                 uint32_t thresh, float keep_prob, uint32_t b_off,
                 uint32_t h_off) {
  using L = Layout<T, kQW, kDh>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kThreads = kQW * 32;
  constexpr int kSteps = kDh * static_cast<int>(sizeof(T)) / 32;  // mma k-steps over Dh
  constexpr int kDn = kDh / 8;                                     // n8 tiles of the output

  extern __shared__ __align__(16) unsigned char smem[];
  auto k_tile = [&](int kt) { return reinterpret_cast<T*>(smem + (kt & 1) * 2 * L::kTileBytes); };
  auto v_tile = [&](int kt) {
    return reinterpret_cast<T*>(smem + (kt & 1) * 2 * L::kTileBytes + L::kTileBytes);
  };
  T* Qs = k_tile(1);
  T* Us = reinterpret_cast<T*>(smem + L::kBandOffset);
  float* Rs = reinterpret_cast<float*>(smem + L::kScratchOffset);

  const int q0 = blockIdx.x * L::kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment rows g and g + 8
  const int t = lane & 3;   // fragment columns 2t, 2t + 1 of each n8 tile
  const int n_tiles = Tn / kBK;
  const int last_row = 2 * Tn - 2;

  const size_t bh = (static_cast<size_t>(b) * H + h) * Tn * kDh;
  const T* kb = k + bh;
  const T* vb = v + bh;
  const T* ub = used + static_cast<size_t>(h) * (2 * Tn - 1) * kDh;
  const unsigned char* kpb = key_pad + static_cast<size_t>(b) * Tn;

  // rows [0, rows) of src (row stride Dh) into dst (row stride kS); rows at
  // or past `valid` are zero-filled
  auto stage = [&](T* dst, const T* src, int rows, int valid) {
    for (int c = tid; c < rows * L::kChunks; c += kThreads) {
      const int r = c / L::kChunks;
      const int ch = c - r * L::kChunks;
      const bool full = r < valid;
      cp_async16(dst + r * L::kS + ch * L::kE,
                 full ? src + static_cast<size_t>(r) * kDh + ch * L::kE : src, full);
    }
  };
  auto stage_kv = [&](int kt) {
    const size_t off = static_cast<size_t>(kt) * kBK * kDh;
    stage(k_tile(kt), kb + off, kBK, kBK);
    stage(v_tile(kt), vb + off, kBK, kBK);
  };
  // the block's band for tile kt: rows rb0 .. rb0 + kBandRows - 1 of used
  auto stage_band = [&](int kt) {
    const int rb0 = kt * kBK - q0 - L::kBQ + Tn;
    stage(Us, ub + static_cast<size_t>(rb0) * kDh, L::kBandRows, last_row - rb0 + 1);
  };

  stage(Qs, q + bh + static_cast<size_t>(q0) * kDh, L::kBQ, L::kBQ);
  stage_kv(0);
  stage_band(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qa[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    ldsm_x4(smem_addr(Qs) + (warp * 16 + (lane & 15)) * L::kRowBytes + kk * 32 + (lane >> 4) * 16,
            qa[kk]);
  }
  __syncthreads();  // Q is in registers: buffer 1 is free for tile 1

  const int qw = q0 + 16 * warp;          // the warp's first query row
  const int band0 = 16 * (kQW - 1 - warp);  // its first row of the block's band
  float* rs = Rs + warp * 16 * kRS;
  const uint32_t seed = kTrain ? static_cast<uint32_t>(*seed_ptr) : 0u;
  // the dropout hash's batch and head: global under a mesh (the offsets of
  // this rank's shard), the block's own (b, h) otherwise
  const uint32_t bg = b + b_off, hg = h + h_off;
  const bool dropping = kTrain && thresh < kKeepAll;

  float o[kDn][4];
#pragma unroll
  for (int n = 0; n < kDn; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = __int_as_float(0xff800000), m1 = m0;  // -inf
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the row sums

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    const T* kt_s = k_tile(kt);
    const T* vt_s = v_tile(kt);
    if (kt + 1 < n_tiles) {
      stage_kv(kt + 1);  // its buffer was last read in tile kt - 1
      cp_async_commit();
    }

    // relative logits: Q_w . Band_w^T (16 x 80) + oob, into the scratch
    {
      float r[kBandN][4];
#pragma unroll
      for (int n = 0; n < kBandN; ++n) r[n][0] = r[n][1] = r[n][2] = r[n][3] = 0.f;
      gemm_qbt<T, kSteps, kBandN>(r, qa, smem_addr(Us) + band0 * L::kRowBytes, L::kRowBytes,
                                  lane);
      const int rw0 = k0 - qw - 16 + Tn;  // global row of band column 0
#pragma unroll
      for (int n = 0; n < kBandN; ++n) {
        const int c = 8 * n + 2 * t;
        // column 79 may lie past the window: clamped, and never read
        const float oa = oob[min(rw0 + c, last_row)];
        const float ob = oob[min(rw0 + c + 1, last_row)];
        *reinterpret_cast<float2*>(rs + g * kRS + c) = make_float2(r[n][0] + oa, r[n][1] + ob);
        *reinterpret_cast<float2*>(rs + (g + 8) * kRS + c) =
            make_float2(r[n][2] + oa, r[n][3] + ob);
      }
    }
    __syncthreads();  // every warp is done with the band; the scratch is written
    if (kt + 1 < n_tiles) {
      stage_band(kt + 1);
      cp_async_commit();
    }

    float s[kKeyN][4];
#pragma unroll
    for (int n = 0; n < kKeyN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    gemm_qbt<T, kSteps, kKeyN>(s, qa, smem_addr(kt_s), L::kRowBytes, lane);

    // logits: element (row ii, key jj) reads scratch column jj - ii + 15
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kKeyN; ++n) {
      const int jj = 8 * n + 2 * t;
      const unsigned short pads = *reinterpret_cast<const unsigned short*>(kpb + k0 + jj);
      const float kp0 = (pads & 0xff) ? kNegFill : 0.f;
      const float kp1 = (pads >> 8) ? kNegFill : 0.f;
      const float* ra = rs + g * kRS + jj - g + 15;
      const float* rb = rs + (g + 8) * kRS + jj - (g + 8) + 15;
      s[n][0] = (s[n][0] * scale + ra[0]) + kp0;
      s[n][1] = (s[n][1] * scale + ra[1]) + kp1;
      s[n][2] = (s[n][2] * scale + rb[0]) + kp0;
      s[n][3] = (s[n][3] * scale + rb[1]) + kp1;
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // online softmax; a row's four threads share its max
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float alpha0 = expf(m0 - mx0);
    const float alpha1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < kKeyN; ++n) {
      s[n][0] = expf(s[n][0] - m0);
      s[n][1] = expf(s[n][1] - m0);
      s[n][2] = expf(s[n][2] - m1);
      s[n][3] = expf(s[n][3] - m1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * alpha0 + sum0;  // the undropped normalizer
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < kDn; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }
    if (dropping) {
      const int i0 = qw + g;
#pragma unroll
      for (int n = 0; n < kKeyN; ++n) {
        const int j = k0 + 8 * n + 2 * t;
        if (!keep(seed, bg, hg, i0, j, thresh)) s[n][0] = 0.f;
        if (!keep(seed, bg, hg, i0, j + 1, thresh)) s[n][1] = 0.f;
        if (!keep(seed, bg, hg, i0 + 8, j, thresh)) s[n][2] = 0.f;
        if (!keep(seed, bg, hg, i0 + 8, j + 1, thresh)) s[n][3] = 0.f;
      }
    }

    // o += p . v, p from the q.k accumulator
    if constexpr (kF32) {
#pragma unroll
      for (int kk = 0; kk < kKeyN; ++kk) {
        // A column t <-> key 2t, column t + 4 <-> key 2t + 1
        uint32_t ah[4], al[4];
        split(s[kk][0], ah[0], al[0]);
        split(s[kk][2], ah[1], al[1]);
        split(s[kk][1], ah[2], al[2]);
        split(s[kk][3], ah[3], al[3]);
        const float* v0 = vt_s + (8 * kk + 2 * t) * L::kS + g;
#pragma unroll
        for (int n = 0; n < kDn; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split(v0[8 * n], bh0, bl0);
          split(v0[L::kS + 8 * n], bh1, bl1);
          mma_3xtf32(o[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    } else {
      // ldmatrix x4 trans: matrices (keys 0-7, d lo), (keys 8-15, d lo),
      // (keys 0-7, d hi), (keys 8-15, d hi): b0, b1 of n8 tiles 2np, 2np + 1
      const uint32_t v_base = smem_addr(vt_s) +
                              ((lane & 7) + (((lane >> 3) & 1) << 3)) * L::kRowBytes +
                              ((lane >> 4) << 3) * 2;
#pragma unroll
      for (int kk = 0; kk < kKeyN / 2; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < kDn / 2; ++np) {
          uint32_t bf[4];
          ldsm_x4_trans(v_base + 16 * kk * L::kRowBytes + np * 32, bf);
          mma_bf16(o[2 * np], a, bf[0], bf[1]);
          mma_bf16(o[2 * np + 1], a, bf[2], bf[3]);
        }
      }
    }

    cp_async_wait_all();  // tile kt + 1 has landed
    __syncthreads();      // and every warp is done with tile kt's K and V
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float d0 = kTrain ? l0 * keep_prob : l0;
  const float d1 = kTrain ? l1 * keep_prob : l1;
  const int i0 = qw + g;
  float* ob = out + bh;
#pragma unroll
  for (int n = 0; n < kDn; ++n) {
    const int c = 8 * n + 2 * t;
    *reinterpret_cast<float2*>(ob + static_cast<size_t>(i0) * kDh + c) =
        make_float2(o[n][0] / d0, o[n][1] / d0);
    *reinterpret_cast<float2*>(ob + static_cast<size_t>(i0 + 8) * kDh + c) =
        make_float2(o[n][2] / d1, o[n][3] / d1);
  }
  if (kTrain && t == 0) {
    float* lb = lse + (static_cast<size_t>(b) * H + h) * Tn;
    lb[i0] = m0 + logf(l0);
    lb[i0 + 8] = m1 + logf(l1);
  }
}

template <typename T, bool kTrain, int kQW, int kDh>
cudaError_t set_smem_limit() {
  return cudaFuncSetAttribute(flash_fwd_kernel<T, kTrain, kQW, kDh>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Layout<T, kQW, kDh>::kBytes));
}

template <typename T, bool kTrain, int kQW, int kDh>
cudaError_t launch_variant(const T* q, const T* k, const T* v, const T* used, const float* oob,
                           const unsigned char* key_pad, const int* seed, float* out, float* lse,
                           int B, int H, int Tn, float scale, uint32_t thresh, float keep_prob,
                           uint32_t b_off, uint32_t h_off, cudaStream_t stream) {
  cudaError_t err = set_smem_limit<T, kTrain, kQW, kDh>();
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, kTrain, kQW, kDh>
      <<<dim3(Tn / (16 * kQW), H, B), kQW * 32, Layout<T, kQW, kDh>::kBytes, stream>>>(
          q, k, v, used, oob, key_pad, seed, out, lse, H, Tn, scale, thresh, keep_prob, b_off,
          h_off);
  return cudaGetLastError();
}

constexpr size_t kMaxSmem = 227 * 1024;  // a block's shared memory on an H100
constexpr long long kNever = 1LL << 62;

template <typename T, int kQW, int kDh>
constexpr bool kFits = Layout<T, kQW, kDh>::kBytes <= kMaxSmem;

// Waves of kQW-warp blocks over the card: blocks over (SMs x the blocks an
// SM holds, by shared memory and registers), or kNever where they do not
// fit or do not split T. Every block walks all key tiles whatever its
// width, and an SM runs its blocks side by side, so waves rank the widths.
template <typename T, bool kTrain, int kQW, int kDh>
cudaError_t waves(int B, int H, int Tn, int sms, long long* w) {
  *w = kNever;
  if constexpr (kFits<T, kQW, kDh>) {
    static int per_sm = 0;  // the same on every H100
    if (per_sm == 0) {
      cudaError_t err = set_smem_limit<T, kTrain, kQW, kDh>();
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, flash_fwd_kernel<T, kTrain, kQW, kDh>, kQW * 32,
            Layout<T, kQW, kDh>::kBytes);
      }
      if (err != cudaSuccess) return err;
    }
    if (per_sm > 0 && Tn % (16 * kQW) == 0) {
      const long long blocks = static_cast<long long>(B) * H * (Tn / (16 * kQW));
      const long long per_wave = static_cast<long long>(sms) * per_sm;
      *w = (blocks + per_wave - 1) / per_wave;
    }
  }
  return cudaSuccess;
}

// The block width with the fewest waves; on a tie the narrower, which
// spreads the work over more SMs. 128-row blocks are float32's: its 64-row
// block leaves an SM one block of four warps.
template <typename T, bool kTrain, int kDh>
cudaError_t launch_dh(const T* q, const T* k, const T* v, const T* used, const float* oob,
                      const unsigned char* key_pad, const int* seed, float* out, float* lse,
                      int B, int H, int Tn, float scale, uint32_t thresh, float keep_prob,
                      uint32_t b_off, uint32_t h_off, cudaStream_t stream) {
  static_assert(kFits<T, 1, kDh>, "a 16-row block must fit");
  constexpr bool kWide = std::is_same<T, float>::value && kFits<T, 8, kDh>;
  int dev = 0, sms = 0;
  long long w1 = kNever, w4 = kNever, w8 = kNever;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = waves<T, kTrain, 1, kDh>(B, H, Tn, sms, &w1);
  if (err == cudaSuccess) err = waves<T, kTrain, 4, kDh>(B, H, Tn, sms, &w4);
  if constexpr (kWide) {
    if (err == cudaSuccess) err = waves<T, kTrain, 8, kDh>(B, H, Tn, sms, &w8);
  }
  if (err != cudaSuccess) return err;
  if constexpr (kWide) {
    if (w8 < w4 && w8 < w1) {
      return launch_variant<T, kTrain, 8, kDh>(q, k, v, used, oob, key_pad, seed, out, lse, B, H,
                                               Tn, scale, thresh, keep_prob, b_off, h_off, stream);
    }
  }
  if constexpr (kFits<T, 4, kDh>) {
    if (w4 < w1) {
      return launch_variant<T, kTrain, 4, kDh>(q, k, v, used, oob, key_pad, seed, out, lse, B, H,
                                               Tn, scale, thresh, keep_prob, b_off, h_off, stream);
    }
  }
  return launch_variant<T, kTrain, 1, kDh>(q, k, v, used, oob, key_pad, seed, out, lse, B, H, Tn,
                                           scale, thresh, keep_prob, b_off, h_off, stream);
}

inline bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

// The forward's launcher: returns a cudaError_t as int. seed and lse may
// be null when !kTrain.
template <typename T, bool kTrain>
int launch(const T* q, const T* k, const T* v, const T* used, const float* oob,
           const unsigned char* key_pad, const int* seed, float* out, float* lse, int B, int H,
           int Tn, int Dh, uint32_t thresh, float keep_prob, uint32_t b_off, uint32_t h_off,
           cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Tn <= 0 || Tn % kBK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(used) || misaligned(out)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(Dh));
  switch (Dh) {
    case 64:
      return static_cast<int>(launch_dh<T, kTrain, 64>(q, k, v, used, oob, key_pad, seed, out, lse,
                                                       B, H, Tn, scale, thresh, keep_prob, b_off,
                                                       h_off, stream));
    case 96:
      return static_cast<int>(launch_dh<T, kTrain, 96>(q, k, v, used, oob, key_pad, seed, out, lse,
                                                       B, H, Tn, scale, thresh, keep_prob, b_off,
                                                       h_off, stream));
    case 128:
      return static_cast<int>(launch_dh<T, kTrain, 128>(q, k, v, used, oob, key_pad, seed, out,
                                                        lse, B, H, Tn, scale, thresh, keep_prob,
                                                        b_off, h_off, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace fwd

}  // namespace
