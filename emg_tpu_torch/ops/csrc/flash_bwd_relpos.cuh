// The backward of the encoder self-attention with a learned relative-
// position bias and post-softmax dropout, on Hopper's tensor cores (sm_90a):
// the recompute of p and ds that both backward kernels need, and K5, the
// kernel of dk and dv, replacing the second Pallas TPU kernel of
// emg_tpu/ops/pallas/flash_attention.py::_flash_train_bwd (_bwd_dkv_kernel,
// :381-445). For each (b, h), query row i and key j (r = j - i + T - 1):
//
//   s[i,j]  = (q_i . k_j) * scale + ((q_i . used[r]) + oob[r]) + kp[j]
//   p       = exp(s - lse_i)                 (lse saved by the forward, K3)
//   pd      = keep * p / keep_prob
//   ds      = p * (keep * (dO_i . v_j) / keep_prob - delta_i)
//   dv_j    = sum_i pd[i,j] dO_i,   dk_j = scale * sum_i ds[i,j] q_i    (K5)
//
// With bfloat16 inputs pd and ds are rounded to bfloat16 before the
// products, where the TPU kernel's `.astype(vs.dtype)` rounds them (and the
// plain version, ops/flash_attention.py, flash_train_bwd_dkv_plain).
//
// What bounds K5 on an H100: operations, about 10 * T * T * Dh flops per
// (b, h) (q.k, q.used over the band, dO.v, pd^T.dO, ds^T.q) against ~4 * T
// * Dh values read. Every product runs on the tensor cores by mma.sync,
// with the forward's primitives (flash_fwd_relpos.cuh): bfloat16 as
// m16n8k16 with ldmatrix, float32 as 3xTF32 on m16n8k8 (float32 accuracy;
// a single TF32 pass would not hold the plain version's 1e-4).
//
// The recompute, `recompute_pd_ds`, is one device function for one warp's
// 16 query rows against a tile of 8 * kN keys, everything staged in shared
// memory by the caller. It forms q.k and the relative logits as the forward
// does (Q_w . Band_w^T, 16 x 8 * (kN + 2), into the warp's skew scratch,
// read back at column j - i + 15), p = exp(s - lse) (no online softmax: lse
// is known), dp = dO_w . V^T with the same gemm as q.k, the keep mask on
// global indices, and returns pd and ds as mma accumulator fragments. It
// holds no block barrier, so a kernel that owns query rows and walks key
// tiles (K4: dq, d_used) calls it unchanged.
//
// Design of K5.
// - A block owns 64 keys of one (b, h); K and V stay in shared memory. It
//   walks the query tiles of 64 rows. Each tile's Q, dO and band of `used`
//   (128 rows: 64 queries x 64 keys touch 127) are copied by cp.async; the
//   band of the next tile is prefetched while the tile's pd^T.dO and ds^T.q
//   run (Q and dO are single-buffered: at float32, Dh = 96, a second stage
//   would pass the 227 KB a block has).
// - Four warps (kSplit = 1, bfloat16) or eight (kSplit = 2, float32; the
//   launcher says why). Warp w recomputes pd and
//   ds for query rows 16 (w % 4) .. + 15 against the block's 64 keys, or
//   against half of them (keys 32 (w / 4) .. + 31) with eight warps, and
//   writes them transposed (keys x queries) to shared memory, row stride
//   72 values. After a barrier, warp w owns keys 16 (w % 4) .. + 15 over the
//   whole Dh, or over half of it with eight warps, and accumulates
//   dV += Pd^T . dO and dK += Ds^T . Q over the tile's 64 queries; dK is
//   scaled once at the end. bfloat16: A by ldmatrix from the transposed
//   tiles, B by ldmatrix.trans from dO and Q, as the forward reads V.
//   float32: the query order inside each k8 step is permuted (A column t
//   <-> query 2t, t + 4 <-> 2t + 1), so A is two float2 reads a step
//   (conflict-free at stride 72) and B the forward's conflict-free V reads.
// - Shared memory at Dh = 96: float32 214 KB (K, V, Q, dO, band 50 KB each,
//   the eight warps' scratch 28 KB, the transposed tiles 36 KB), one block
//   of eight warps an SM; bfloat16 100 KB (the transposed tiles alias the
//   scratch, free once every warp has read it), two blocks of four warps an
//   SM. Eight warps hold half the accumulators (48 registers at Dh = 96
//   instead of 96). Where the transposed tiles fit neither the scratch nor
//   the room left (float32 at Dh = 128) they alias the band, whose next
//   tile is then staged with Q and dO instead of prefetched.
// - T must be a multiple of 64, Dh one of 64, 96, 128.

#pragma once

#include "flash_fwd_relpos.cuh"

namespace {
namespace bwd {

using fwd::kBK;

constexpr int kBQ = 64;               // query rows a tile
constexpr int kTS = kBQ + 8;          // transposed tiles' row stride, values
constexpr int kBandRows = kBQ + kBK;  // 127 rows used, padded to 128

// the skew scratch's row stride for a warp's band of 8 * (kN + 2) columns:
// 24 mod 32 words, so the accumulator's float2 writes are conflict-free
__host__ __device__ constexpr int scratch_stride(int kN) { return 8 * kN + 24; }

template <typename T, int kDh>
struct Rows {
  static constexpr int kE = 16 / sizeof(T);  // values per 16-byte chunk
  static constexpr int kS = kDh + kE;        // shared row stride, values
  static constexpr int kBytes = kS * sizeof(T);
  static constexpr int kChunks = kDh / kE;
  static constexpr int kSteps = kDh * static_cast<int>(sizeof(T)) / 32;  // mma k-steps over Dh
};

// A warp's pd and ds, 16 query rows [qw, qw + 16) x 8 * kN keys [k0, ...)
// of (b, h), as m16n8 accumulator fragments: element (g | g + 8, 8n + 2t |
// +1) in [n][0..3], g = lane / 4, t = lane % 4. Shared addresses: q_w, do_w
// the warp's 16 rows of Q and dO, k_s, v_s the 8 * kN rows of K and V from
// key k0, band_w 8 * (kN + 2) rows of `used` from row k0 - qw - 16 + T (rows
// past 2T - 2 are never read), all with Rows<T, kDh>'s stride; rs the
// warp's 16-row float scratch, row stride scratch_stride(kN). lse and delta
// hold rows qw + g, qw + g + 8; kpb is b's key-pad row; kept = 1 /
// keep_prob. bfloat16 rounds pd and ds to bfloat16.
template <typename T, int kDh, int kN>
__device__ __forceinline__ void recompute_pd_ds(
    float (&pd)[kN][4], float (&ds)[kN][4], uint32_t q_w, uint32_t do_w, uint32_t k_s,
    uint32_t v_s, uint32_t band_w, float* rs, const float* __restrict__ oob,
    const unsigned char* __restrict__ kpb, const float (&lse)[2], const float (&delta)[2], int qw,
    int k0, int b, int h, int Tn, float scale, uint32_t seed, uint32_t thresh, float kept,
    int lane) {
  using R = Rows<T, kDh>;
  constexpr int kBn = kN + 2;  // n8 tiles of the band: 16 + 8 kN - 1 columns, padded
  constexpr int kRSs = scratch_stride(kN);
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t a_off = (lane & 15) * R::kBytes + (lane >> 4) * 16;  // A rows by ldmatrix

  // q.k and the relative logits Q_w . Band_w^T, one A fragment a k-step
  float s[kN][4];
  {
    float r[kBn][4];
#pragma unroll
    for (int n = 0; n < kBn; ++n) r[n][0] = r[n][1] = r[n][2] = r[n][3] = 0.f;
#pragma unroll
    for (int n = 0; n < kN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < R::kSteps; ++kk) {
      uint32_t a[1][4];
      fwd::ldsm_x4(q_w + a_off + kk * 32, a[0]);
      fwd::gemm_qbt<T, 1, kBn>(r, a, band_w + kk * 32, R::kBytes, lane);
      fwd::gemm_qbt<T, 1, kN>(s, a, k_s + kk * 32, R::kBytes, lane);
    }
    const int last_row = 2 * Tn - 2;
    const int rw0 = k0 - qw - 16 + Tn;  // global row of band column 0
#pragma unroll
    for (int n = 0; n < kBn; ++n) {
      const int c = 8 * n + 2 * t;
      // the last column may lie past the window: clamped, and never read
      const float oa = oob[min(rw0 + c, last_row)];
      const float ob = oob[min(rw0 + c + 1, last_row)];
      *reinterpret_cast<float2*>(rs + g * kRSs + c) = make_float2(r[n][0] + oa, r[n][1] + ob);
      *reinterpret_cast<float2*>(rs + (g + 8) * kRSs + c) = make_float2(r[n][2] + oa, r[n][3] + ob);
    }
  }

  // dp = dO_w . V^T
#pragma unroll
  for (int n = 0; n < kN; ++n) pd[n][0] = pd[n][1] = pd[n][2] = pd[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < R::kSteps; ++kk) {
    uint32_t a[1][4];
    fwd::ldsm_x4(do_w + a_off + kk * 32, a[0]);
    fwd::gemm_qbt<T, 1, kN>(pd, a, v_s + kk * 32, R::kBytes, lane);
  }
  __syncwarp();  // the scratch is written

  const bool dropping = thresh < kKeepAll;
  const int i0 = qw + g;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int jj = 8 * n + 2 * t;
    const unsigned short pads = *reinterpret_cast<const unsigned short*>(kpb + k0 + jj);
    const float kp[2] = {(pads & 0xff) ? kNegFill : 0.f, (pads >> 8) ? kNegFill : 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ii = g + 8 * (e >> 1);  // row in the warp's 16
      const int c = e & 1;
      const float x = (s[n][e] * scale + rs[ii * kRSs + jj + c - ii + 15]) + kp[c];
      const float p = expf(x - lse[e >> 1]);
      const float ks =
          dropping && !keep(seed, b, h, i0 + 8 * (e >> 1), k0 + jj + c, thresh) ? 0.f : kept;
      float pv = p * ks;
      float dv = p * (pd[n][e] * ks - delta[e >> 1]);
      if constexpr (!std::is_same<T, float>::value) {
        pv = __bfloat162float(__float2bfloat16(pv));
        dv = __bfloat162float(__float2bfloat16(dv));
      }
      pd[n][e] = pv;
      ds[n][e] = dv;
    }
  }
}

template <typename T, int kDh, int kSplit>
struct Layout {
  using R = Rows<T, kDh>;
  static constexpr int kWarps = 4 * kSplit;
  static constexpr int kN = 8 / kSplit;  // n8 key tiles a warp recomputes
  static constexpr size_t kTile = static_cast<size_t>(kBK) * R::kBytes;  // 64 rows
  // K, V, Q, dO, the band, the scratch, then Pd^T and Ds^T (keys x queries)
  static constexpr size_t kBandOffset = 4 * kTile;
  static constexpr size_t kScratchOffset = kBandOffset + static_cast<size_t>(kBandRows) * R::kBytes;
  static constexpr size_t kScratchBytes =
      static_cast<size_t>(kWarps) * 16 * scratch_stride(kN) * sizeof(float);
  static constexpr size_t kTBytes = 2 * static_cast<size_t>(kBK) * kTS * sizeof(T);
  static constexpr size_t kEnd = kScratchOffset + kScratchBytes;
  // the transposed tiles alias the scratch where they fit in it, else take
  // their own room where the block still fits, else alias the band (which
  // then cannot be prefetched)
  static constexpr bool kInScratch = kTBytes <= kScratchBytes;
  static constexpr bool kPrefetchBand = kInScratch || kEnd + kTBytes <= fwd::kMaxSmem;
  static constexpr size_t kTOffset =
      kInScratch ? kScratchOffset : (kPrefetchBand ? kEnd : kBandOffset);
  static constexpr size_t kBytes = (kInScratch || !kPrefetchBand) ? kEnd : kEnd + kTBytes;
  static_assert(kPrefetchBand || kTBytes <= kScratchOffset - kBandOffset + kScratchBytes,
                "the transposed tiles must fit the band and scratch");
  static_assert(kBytes <= fwd::kMaxSmem, "the block must fit an SM's shared memory");
};

template <typename T, int kDh, int kSplit>
__global__ void __launch_bounds__(128 * kSplit)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ used, const float* __restrict__ oob,
                     const unsigned char* __restrict__ key_pad, const int* __restrict__ seed_ptr,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Tn, float scale, uint32_t thresh,
                     float kept) {
  using R = Rows<T, kDh>;
  using L = Layout<T, kDh, kSplit>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kThreads = 32 * L::kWarps;
  constexpr int kN = L::kN;
  constexpr int kDn = kDh / 8 / kSplit;  // n8 tiles of dk, dv a warp owns

  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + L::kTile);
  T* Qs = reinterpret_cast<T*>(smem + 2 * L::kTile);
  T* DOs = reinterpret_cast<T*>(smem + 3 * L::kTile);
  T* Us = reinterpret_cast<T*>(smem + L::kBandOffset);
  float* Rs = reinterpret_cast<float*>(smem + L::kScratchOffset);
  T* PdT = reinterpret_cast<T*>(smem + L::kTOffset);
  T* DsT = PdT + kBK * kTS;

  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wr = warp & 3;       // 16-row group: query rows, then keys
  const int wc = warp >> 2;      // with kSplit = 2: key half, then Dh half
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_tiles = Tn / kBQ;
  const int last_row = 2 * Tn - 2;

  const size_t bh = (static_cast<size_t>(b) * H + h) * Tn * kDh;
  const size_t bhr = (static_cast<size_t>(b) * H + h) * Tn;
  const T* ub = used + static_cast<size_t>(h) * (2 * Tn - 1) * kDh;
  const unsigned char* kpb = key_pad + static_cast<size_t>(b) * Tn;

  // rows [0, rows) of src (row stride Dh) into dst (row stride kS); rows at
  // or past `valid` are zero-filled
  auto stage = [&](T* dst, const T* src, int rows, int valid) {
    for (int c = tid; c < rows * R::kChunks; c += kThreads) {
      const int r = c / R::kChunks;
      const int ch = c - r * R::kChunks;
      const bool full = r < valid;
      fwd::cp_async16(dst + r * R::kS + ch * R::kE,
                      full ? src + static_cast<size_t>(r) * kDh + ch * R::kE : src, full);
    }
  };
  auto stage_qdo = [&](int qt) {
    const size_t off = bh + static_cast<size_t>(qt) * kBQ * kDh;
    stage(Qs, q + off, kBQ, kBQ);
    stage(DOs, dout + off, kBQ, kBQ);
  };
  // the band of query tile qt: rows rb0 .. rb0 + kBandRows - 1 of used
  auto stage_band = [&](int qt) {
    const int rb0 = k0 - qt * kBQ - kBQ + Tn;
    stage(Us, ub + static_cast<size_t>(rb0) * kDh, kBandRows, last_row - rb0 + 1);
  };

  stage(Ks, k + bh + static_cast<size_t>(k0) * kDh, kBK, kBK);
  stage(Vs, v + bh + static_cast<size_t>(k0) * kDh, kBK, kBK);
  stage_qdo(0);
  stage_band(0);
  fwd::cp_async_commit();
  fwd::cp_async_wait_all();
  __syncthreads();

  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
  // the recompute's keys: the block's 64, or half of them
  const int kw = 8 * kN * wc;
  const uint32_t row_w = wr * 16 * R::kBytes;  // the warp's 16 query rows of a tile
  const uint32_t key_w = kw * R::kBytes;
  // the band row of (key k0 + kw, query 16 wr) is 64 - 16 wr - 16 + kw past the tile's first
  const uint32_t band_w = fwd::smem_addr(Us) + (16 * (3 - wr) + kw) * R::kBytes;
  float* rs = Rs + warp * 16 * scratch_stride(kN);

  float dka[kDn][4], dva[kDn][4];
#pragma unroll
  for (int n = 0; n < kDn; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int qt = 0; qt < n_tiles; ++qt) {
    const int qw = qt * kBQ + 16 * wr;  // the warp's first query row
    const float lse_r[2] = {lse[bhr + qw + g], lse[bhr + qw + g + 8]};
    const float delta_r[2] = {delta[bhr + qw + g], delta[bhr + qw + g + 8]};
    float pd[kN][4], ds[kN][4];
    recompute_pd_ds<T, kDh, kN>(pd, ds, fwd::smem_addr(Qs) + row_w, fwd::smem_addr(DOs) + row_w,
                                fwd::smem_addr(Ks) + key_w, fwd::smem_addr(Vs) + key_w, band_w,
                                rs, oob, kpb, lse_r, delta_r, qw, k0 + kw, b, h, Tn, scale, seed,
                                thresh, kept, lane);
    __syncthreads();  // every warp is done with the band and its scratch
    if constexpr (L::kPrefetchBand) {
      if (qt + 1 < n_tiles) {
        stage_band(qt + 1);
        fwd::cp_async_commit();
      }
    }

    // Pd^T, Ds^T: key kw + 8n + 2t (+1) x query 16 wr + g (+8)
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = (kw + 8 * n + 2 * t + (e & 1)) * kTS + 16 * wr + g + 8 * (e >> 1);
        if constexpr (kF32) {
          PdT[idx] = pd[n][e];
          DsT[idx] = ds[n][e];
        } else {
          PdT[idx] = __float2bfloat16(pd[n][e]);
          DsT[idx] = __float2bfloat16(ds[n][e]);
        }
      }
    }
    __syncthreads();  // the transposed tiles are complete

    // dV += Pd^T . dO, dK += Ds^T . Q over the tile's queries; the warp
    // owns keys 16 wr .. + 15 and the n8 tiles kDn wc .. + kDn - 1 of Dh
    if constexpr (kF32) {
      const float* pa = PdT + (16 * wr + g) * kTS + 2 * t;
      const float* da = DsT + (16 * wr + g) * kTS + 2 * t;
#pragma unroll 2
      for (int kk = 0; kk < kBQ / 8; ++kk) {
        // A column t <-> query 8kk + 2t, column t + 4 <-> query 8kk + 2t + 1
        const float2 p0 = *reinterpret_cast<const float2*>(pa + 8 * kk);
        const float2 p1 = *reinterpret_cast<const float2*>(pa + 8 * kTS + 8 * kk);
        const float2 d0 = *reinterpret_cast<const float2*>(da + 8 * kk);
        const float2 d1 = *reinterpret_cast<const float2*>(da + 8 * kk + 8 * kTS);
        uint32_t ph[4], pl[4], dh[4], dl[4];
        fwd::split(p0.x, ph[0], pl[0]);
        fwd::split(p1.x, ph[1], pl[1]);
        fwd::split(p0.y, ph[2], pl[2]);
        fwd::split(p1.y, ph[3], pl[3]);
        fwd::split(d0.x, dh[0], dl[0]);
        fwd::split(d1.x, dh[1], dl[1]);
        fwd::split(d0.y, dh[2], dl[2]);
        fwd::split(d1.y, dh[3], dl[3]);
        const float* o0 = DOs + (8 * kk + 2 * t) * R::kS + 8 * kDn * wc + g;
        const float* q0 = Qs + (8 * kk + 2 * t) * R::kS + 8 * kDn * wc + g;
#pragma unroll
        for (int n = 0; n < kDn; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          fwd::split(o0[8 * n], bh0, bl0);
          fwd::split(o0[R::kS + 8 * n], bh1, bl1);
          fwd::mma_3xtf32(dva[n], ph, pl, bh0, bh1, bl0, bl1);
          fwd::split(q0[8 * n], bh0, bl0);
          fwd::split(q0[R::kS + 8 * n], bh1, bl1);
          fwd::mma_3xtf32(dka[n], dh, dl, bh0, bh1, bl0, bl1);
        }
      }
    } else {
      constexpr int kTBytesRow = kTS * sizeof(T);
      const uint32_t a_off = (16 * wr + (lane & 15)) * kTBytesRow + (lane >> 4) * 16;
      // ldmatrix x4 trans: matrices (queries 0-7, d lo), (queries 8-15, d lo),
      // (queries 0-7, d hi), (queries 8-15, d hi): b0, b1 of n8 tiles 2np, 2np + 1
      const uint32_t b_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * R::kBytes +
                             ((lane >> 4) << 3) * 2 + 16 * kDn * wc;
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        fwd::ldsm_x4(fwd::smem_addr(PdT) + a_off + kk * 32, pa);
        fwd::ldsm_x4(fwd::smem_addr(DsT) + a_off + kk * 32, da);
#pragma unroll
        for (int np = 0; np < kDn / 2; ++np) {
          uint32_t bf[4];
          fwd::ldsm_x4_trans(fwd::smem_addr(DOs) + b_off + 16 * kk * R::kBytes + np * 32, bf);
          fwd::mma_bf16(dva[2 * np], pa, bf[0], bf[1]);
          fwd::mma_bf16(dva[2 * np + 1], pa, bf[2], bf[3]);
          fwd::ldsm_x4_trans(fwd::smem_addr(Qs) + b_off + 16 * kk * R::kBytes + np * 32, bf);
          fwd::mma_bf16(dka[2 * np], da, bf[0], bf[1]);
          fwd::mma_bf16(dka[2 * np + 1], da, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with Q, dO and the transposed tiles
    if (qt + 1 < n_tiles) {
      stage_qdo(qt + 1);
      if constexpr (!L::kPrefetchBand) stage_band(qt + 1);
      fwd::cp_async_commit();
      fwd::cp_async_wait_all();
      __syncthreads();
    }
  }

  const int j0 = k0 + 16 * wr + g;
  float* dkb = dk + bh + 8 * kDn * wc;
  float* dvb = dv + bh + 8 * kDn * wc;
#pragma unroll
  for (int n = 0; n < kDn; ++n) {
    const int c = 8 * n + 2 * t;
    *reinterpret_cast<float2*>(dkb + static_cast<size_t>(j0) * kDh + c) =
        make_float2(dka[n][0] * scale, dka[n][1] * scale);
    *reinterpret_cast<float2*>(dkb + static_cast<size_t>(j0 + 8) * kDh + c) =
        make_float2(dka[n][2] * scale, dka[n][3] * scale);
    *reinterpret_cast<float2*>(dvb + static_cast<size_t>(j0) * kDh + c) =
        make_float2(dva[n][0], dva[n][1]);
    *reinterpret_cast<float2*>(dvb + static_cast<size_t>(j0 + 8) * kDh + c) =
        make_float2(dva[n][2], dva[n][3]);
  }
}

// float32 takes eight warps: twice the warps an SM holds (its block needs
// most of an SM's shared memory either way), half the accumulators, and no
// spills. bfloat16 keeps four: two blocks, eight warps an SM, where eight-
// warp blocks would hold one block an SM by registers.
template <typename T, int kDh>
cudaError_t launch_dkv_dh(const T* q, const T* k, const T* v, const T* used, const float* oob,
                          const unsigned char* key_pad, const int* seed, const T* dout,
                          const float* lse, const float* delta, float* dk, float* dv, int B,
                          int H, int Tn, uint32_t thresh, float keep_prob, cudaStream_t stream) {
  constexpr int kSplit = std::is_same<T, float>::value ? 2 : 1;
  constexpr size_t bytes = Layout<T, kDh, kSplit>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, kDh, kSplit>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(kDh));
  flash_bwd_dkv_kernel<T, kDh, kSplit><<<dim3(Tn / kBK, H, B), 128 * kSplit, bytes, stream>>>(
      q, k, v, used, oob, key_pad, seed, dout, lse, delta, dk, dv, H, Tn, scale, thresh,
      1.0f / keep_prob);
  return cudaGetLastError();
}

// K5's launcher: returns a cudaError_t as int
template <typename T>
int launch_dkv(const T* q, const T* k, const T* v, const T* used, const float* oob,
               const unsigned char* key_pad, const int* seed, const T* dout, const float* lse,
               const float* delta, float* dk, float* dv, int B, int H, int Tn, int Dh,
               uint32_t thresh, float keep_prob, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Tn <= 0 || Tn % kBQ != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (fwd::misaligned(q) || fwd::misaligned(k) || fwd::misaligned(v) || fwd::misaligned(used) ||
      fwd::misaligned(dout) || fwd::misaligned(dk) || fwd::misaligned(dv)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  switch (Dh) {
    case 64:
      return static_cast<int>(launch_dkv_dh<T, 64>(q, k, v, used, oob, key_pad, seed, dout, lse,
                                                   delta, dk, dv, B, H, Tn, thresh, keep_prob,
                                                   stream));
    case 96:
      return static_cast<int>(launch_dkv_dh<T, 96>(q, k, v, used, oob, key_pad, seed, dout, lse,
                                                   delta, dk, dv, B, H, Tn, thresh, keep_prob,
                                                   stream));
    case 128:
      return static_cast<int>(launch_dkv_dh<T, 128>(q, k, v, used, oob, key_pad, seed, dout, lse,
                                                    delta, dk, dv, B, H, Tn, thresh, keep_prob,
                                                    stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace bwd
}  // namespace
