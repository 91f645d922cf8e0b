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
// carried the state between grid steps in VMEM scratch, sizing blocks to a
// VMEM budget. Blocks on this card run in parallel with nothing carried
// between them, so here ONE thread block owns one row and walks it chunk by
// chunk, keeping the carry in registers:
//   1. each thread folds kItems consecutive inputs into one affine map
//      (P, B) = (lam^n, local recurrence from zero);
//   2. the maps are scanned across the warp with shuffles and across the
//      block's warps through shared memory (Kogge-Stone, inclusive);
//   3. each thread applies its exclusive prefix to the carry to get the
//      state entering its items, then re-runs the recurrence over them
//      (exactly the sequential arithmetic) and writes w;
//   4. the block total advances the carry to the next chunk.
// The anti-causal direction reads the row from its end (logical index j is
// time T-1-j), so both directions share one code path.
//
// Known limit: the filter chain gives R = 16 or 24 rows, so only R of the
// card's 132 SMs work and the kernel is far from the byte bound at long T.
// The chunked three-pass design (independent chunk scans on every SM, a
// pass over the chunk carries, a fix-up pass) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;

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

__global__ void __launch_bounds__(kThreads)
iir_scan_kernel(const float* __restrict__ lam_r, const float* __restrict__ lam_i,
                const float* __restrict__ w0_r, const float* __restrict__ w0_i,
                const float* __restrict__ u_r, const float* __restrict__ u_i,
                float* __restrict__ w_r, float* __restrict__ w_i,
                int T, int reverse) {
  __shared__ Affine warp_total[kWarps];
  __shared__ Affine warp_prefix[kWarps];

  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float lr = lam_r[row];
  const float li = lam_i[row];
  const size_t base = static_cast<size_t>(row) * T;
  const float* ur = u_r + base;
  const float* ui = u_i + base;
  float* wr = w_r + base;
  float* wi = w_i + base;

  float cr = w0_r[row];  // carry: the state before the chunk
  float ci = w0_i[row];
  const Affine identity = {1.f, 0.f, 0.f, 0.f};

  for (int c0 = 0; c0 < T; c0 += kChunk) {
    const int j0 = c0 + threadIdx.x * kItems;  // first logical index
    float xr[kItems], xi[kItems];
    Affine mine = identity;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = j0 + k;
      xr[k] = 0.f;
      xi[k] = 0.f;
      if (j < T) {
        const int t = reverse ? T - 1 - j : j;
        xr[k] = ur[t];
        xi[k] = ui[t];
        const Affine step = {lr, li, xr[k], xi[k]};
        mine = then(mine, step);
      }
    }

    // inclusive scan of the thread maps across the warp
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
    }
    __syncthreads();

    const Affine pre = then(warp_prefix[warp], excl);
    // state entering this thread's first item
    float sr = pre.pr * cr - pre.pi * ci + pre.br;
    float si = pre.pr * ci + pre.pi * cr + pre.bi;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = j0 + k;
      if (j < T) {
        const float nr = lr * sr - li * si + xr[k];
        const float ni = lr * si + li * sr + xi[k];
        sr = nr;
        si = ni;
        const int t = reverse ? T - 1 - j : j;
        wr[t] = sr;
        wi[t] = si;
      }
    }

    // advance the carry by the whole chunk: prefix of the last warp
    // followed by that warp's total
    const Affine chunk = then(warp_prefix[kWarps - 1], warp_total[kWarps - 1]);
    const float ncr = chunk.pr * cr - chunk.pi * ci + chunk.br;
    const float nci = chunk.pr * ci + chunk.pi * cr + chunk.bi;
    cr = ncr;
    ci = nci;
    __syncthreads();  // shared totals are rewritten by the next chunk
  }
}

}  // namespace

extern "C" int iir_scan_f32(const float* lam_r, const float* lam_i,
                            const float* w0_r, const float* w0_i,
                            const float* u_r, const float* u_i,
                            float* w_r, float* w_i, int R, int T, int reverse,
                            cudaStream_t stream) {
  if (R <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  iir_scan_kernel<<<R, kThreads, 0, stream>>>(lam_r, lam_i, w0_r, w0_i, u_r,
                                               u_i, w_r, w_i, T, reverse);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* iir_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
