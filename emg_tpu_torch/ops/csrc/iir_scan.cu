// Complex diagonal linear recurrence over long rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel emg_tpu/ops/pallas/iir_scan.py::iir_scan.
// For every row r (a (channel, eigen-state) pair of one IIR filter):
//
//   reverse == 0:  w[t] = lam * w[t-1] + u[t],   w[-1] = w0
//   reverse == 1:  w[t] = lam * w[t+1] + u[t],   w[T]  = w0
//
// in complex float32 with real and imaginary parts in separate arrays.
//
// What bounds it on an H100: bytes. Each element is read once (u_r, u_i)
// and written once (w_r, w_i): 16 * R * T bytes, with 8 complex flops per
// element, far below the card's ratio of operations to bytes.
//
// Design. The TPU kernel walked time blocks in order on one core and
// carried the state between grid steps in VMEM scratch. The filter chain
// gives only R = 16 or 24 rows, so one block a row would leave most of the
// card's 132 SMs idle and walk each row serially. Here each row is spread
// over one thread-block cluster of S blocks on neighbouring SMs (grid
// (S, R), cluster (S, 1, 1)), and the cluster's distributed shared memory
// carries the state between the row's segments:
//   1. stage: block s owns the logical indices [s*L, min((s+1)*L, T)) of
//      its row and issues every load of that segment (4-byte cp.async,
//      coalesced: rows of odd length are not 16-byte aligned) into shared
//      memory before waiting on any, so one HBM read serves both passes;
//   2. local scan: thread k folds its n consecutive items into one affine
//      map (P, B) = (lam^n by products, local recurrence from zero); the
//      maps are scanned across the warp with shuffles and across the
//      block's warps through shared memory (Kogge-Stone), giving each
//      thread's exclusive prefix and the segment's aggregate. n is odd, so
//      a warp's 32 reads at stride n fall in 32 distinct banks;
//   3. exchange: each block publishes its aggregate in its own shared
//      memory; after a cluster barrier, block s reads the aggregates of
//      segments 0..s-1 from its peers (one lane each) and composes them
//      with w0 in segment order: the state entering its segment;
//   4. apply: each thread turns its prefix and that state into its entry
//      state and re-runs the sequential recurrence over its items from
//      shared memory (the sequential arithmetic), in place; the block then
//      writes w coalesced. A second cluster barrier, arrived at once the
//      peers' aggregates are read and waited on before exit, keeps every
//      block's shared memory alive while a peer may read it.
// One launch, no global workspace, no spin-waiting, and the same order of
// operations on every call, so the result is bitwise repeatable. A block
// whose segment is empty (T < S*L) still reaches both barriers and writes
// nothing. The anti-causal direction reads the row from its end (logical
// index j is time T-1-j), so both directions share one code path.
//
// The layout (S, L, n and the shared memory bytes) is chosen by the Python
// wrapper (emg_tpu_torch/ops/iir_scan.py::layout) and checked here. S is 8,
// the portable cluster size, which puts the DSP's 16 rows on 128 of the 132
// SMs; rows longer than 8 segments of 4096 samples take S = 16 with the
// non-portable opt-in, which halves each thread's serial walk and, at the
// 131072 bucket, keeps a block's 65 KB segment small enough that blocks
// share SMs and 16 rows fit the card at once (with S = 8 a 131 KB block
// would hold an SM alone and 16 rows would take two waves).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;  // past 8, clusters need the non-portable opt-in
// dynamic shared memory a block may take: Hopper's 227 KB a block, less
// 1 KB for the kernel's static shared memory
constexpr int kMaxDynamicSmem = 232448 - 1024;

struct Affine {
  float pr, pi, br, bi;  // x -> P * x + B, complex
};

// The map that applies `a` first and `b` second.
__device__ __forceinline__ Affine then(const Affine& a, const Affine& b) {
  Affine r;
  r.pr = b.pr * a.pr - b.pi * a.pi;
  r.pi = b.pr * a.pi + b.pi * a.pr;
  r.br = b.pr * a.br - b.pi * a.bi + b.br;
  r.bi = b.pr * a.bi + b.pi * a.br + b.bi;
  return r;
}

__device__ __forceinline__ Affine shfl_up(const Affine& a, int delta) {
  Affine r;
  r.pr = __shfl_up_sync(0xffffffffu, a.pr, delta);
  r.pi = __shfl_up_sync(0xffffffffu, a.pi, delta);
  r.br = __shfl_up_sync(0xffffffffu, a.br, delta);
  r.bi = __shfl_up_sync(0xffffffffu, a.bi, delta);
  return r;
}

__device__ __forceinline__ Affine shfl_idx(const Affine& a, int lane) {
  Affine r;
  r.pr = __shfl_sync(0xffffffffu, a.pr, lane);
  r.pi = __shfl_sync(0xffffffffu, a.pi, lane);
  r.br = __shfl_sync(0xffffffffu, a.br, lane);
  r.bi = __shfl_sync(0xffffffffu, a.bi, lane);
  return r;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
iir_scan_kernel(const float* __restrict__ lam_r, const float* __restrict__ lam_i,
                const float* __restrict__ w0_r, const float* __restrict__ w0_i,
                const float* __restrict__ u_r, const float* __restrict__ u_i,
                float* __restrict__ w_r, float* __restrict__ w_i,
                int T, int L, int n, int reverse) {
  extern __shared__ float stage[];  // [2 * L]: the segment's u_r, u_i in logical order, then w
  __shared__ Affine warp_total[kWarps];
  __shared__ Affine warp_prefix[kWarps];
  __shared__ __align__(16) Affine segment;  // this block's aggregate, read by later peers
  __shared__ float carry_r, carry_i;          // the state entering this segment

  cg::cluster_group cluster = cg::this_cluster();
  const int s = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int a = min(s * L, T);
  const int len = min(L, T - a);              // 0 for an empty segment
  const int t_lo = reverse ? T - a - len : a;  // the segment's earliest time
  const size_t base = static_cast<size_t>(row) * T + t_lo;
  float* xr = stage;
  float* xi = stage + L;
  const float lr = lam_r[row];
  const float li = lam_i[row];
  const float w0r = w0_r[row];
  const float w0i = w0_i[row];

  // 1. stage: the q-th time of the segment is its logical item len-1-q
  // when reversed
#pragma unroll 4
  for (int q = threadIdx.x; q < len; q += kThreads) {
    const int j = reverse ? len - 1 - q : q;
    cp_async4(xr + j, u_r + base + q);
    cp_async4(xi + j, u_i + base + q);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. fold this thread's items, then scan the maps across the block
  const int i0 = min(static_cast<int>(threadIdx.x) * n, len);
  const int i1 = min(i0 + n, len);
  const Affine identity = {1.f, 0.f, 0.f, 0.f};
  Affine mine = identity;
  for (int i = i0; i < i1; ++i) {
    const Affine step = {lr, li, xr[i], xi[i]};
    mine = then(mine, step);
  }

  Affine incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Affine prev = shfl_up(incl, d);
    if (lane >= d) incl = then(prev, incl);
  }
  Affine excl = shfl_up(incl, 1);
  if (lane == 0) excl = identity;
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();

  if (warp == 0) {
    Affine t = lane < kWarps ? warp_total[lane] : identity;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const Affine prev = shfl_up(t, d);
      if (lane >= d) t = then(prev, t);
    }
    Affine e = shfl_up(t, 1);
    if (lane == 0) e = identity;
    if (lane < kWarps) warp_prefix[lane] = e;
    if (lane == kWarps - 1) segment = t;  // inclusive over every warp
  }

  // 3. exchange: publish, then compose the earlier segments' aggregates
  cluster_arrive();
  cluster_wait();
  if (warp == 0) {
    Affine agg = identity;
    if (lane < s) agg = *cluster.map_shared_rank(&segment, lane);
    float cr = w0r;
    float ci = w0i;
    for (int p = 0; p < s; ++p) {
      const Affine g = shfl_idx(agg, p);
      const float nr = g.pr * cr - g.pi * ci + g.br;
      const float ni = g.pr * ci + g.pi * cr + g.bi;
      cr = nr;
      ci = ni;
    }
    if (lane == 0) {
      carry_r = cr;
      carry_i = ci;
    }
  }
  cluster_arrive();  // done reading the peers' shared memory
  __syncthreads();

  // 4. apply: the state entering this thread's first item, then the
  // sequential recurrence over its items, in place
  const Affine pre = then(warp_prefix[warp], excl);
  const float cr = carry_r;
  const float ci = carry_i;
  float sr = pre.pr * cr - pre.pi * ci + pre.br;
  float si = pre.pr * ci + pre.pi * cr + pre.bi;
  for (int i = i0; i < i1; ++i) {
    const float nr = lr * sr - li * si + xr[i];
    const float ni = lr * si + li * sr + xi[i];
    sr = nr;
    si = ni;
    xr[i] = sr;
    xi[i] = si;
  }
  __syncthreads();

#pragma unroll 4
  for (int q = threadIdx.x; q < len; q += kThreads) {
    const int j = reverse ? len - 1 - q : q;
    w_r[base + q] = xr[j];
    w_i[base + q] = xi[j];
  }
  cluster_wait();  // no peer still reads this block's aggregate
}

// The launch configuration of a cluster of S blocks with smem_bytes of
// dynamic shared memory each; attr must outlive the configuration.
cudaLaunchConfig_t cluster_config(int S, int R, int smem_bytes, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, R, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = S;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool layout_ok(int R, int T, int S, int L, int n, int smem_bytes) {
  return R > 0 && R <= 65535 && T > 0 && S >= 1 && S <= kMaxCluster && L > 0 &&
         static_cast<long long>(S) * L >= T &&
         n > 0 && static_cast<long long>(n) * kThreads >= L &&
         smem_bytes == 2 * L * static_cast<int>(sizeof(float)) && smem_bytes <= kMaxDynamicSmem;
}

// The kernel's attributes for this layout: its dynamic shared memory and,
// for a cluster past the portable size, the non-portable opt-in.
cudaError_t set_attributes(int S, int smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(iir_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess && S > kPortableCluster)
    err = cudaFuncSetAttribute(iir_scan_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

}  // namespace

extern "C" int iir_scan_f32(const float* lam_r, const float* lam_i,
                            const float* w0_r, const float* w0_i,
                            const float* u_r, const float* u_i,
                            float* w_r, float* w_i, int R, int T,
                            int S, int L, int n, int smem_bytes, int reverse,
                            cudaStream_t stream) {
  if (!layout_ok(R, T, S, L, n, smem_bytes)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_attributes(S, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(S, R, smem_bytes, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, iir_scan_kernel, lam_r, lam_i, w0_r, w0_i, u_r, u_i, w_r, w_i,
                           T, L, n, reverse);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of this layout the card holds at once (0: a cluster
// of S such blocks cannot be co-resident), into *clusters.
extern "C" int iir_scan_max_active_clusters(int R, int S, int smem_bytes, int* clusters) {
  if (S < 1 || S > kMaxCluster || smem_bytes < 0 || smem_bytes > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = set_attributes(S, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(S, R, smem_bytes, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, iir_scan_kernel, &cfg));
}

extern "C" const char* iir_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
