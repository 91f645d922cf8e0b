// Connectionist temporal classification (CTC) loss, for Hopper (sm_90a).
//
// Replaces torch.nn.functional.ctc_loss on the training step. That call
// copies the input and target lengths to the host to size its work, so a
// CUDA graph cannot hold it; these kernels read the lengths from device
// memory and size their work by the batch's padded shapes alone. (The JAX
// package's CTC, optax.ctc_loss, is an XLA loop, not a Pallas kernel.)
//
// For row b of log_probs lp (B, T, C), with T_b = input_lengths[b] frames
// and L = target_lengths[b] labels, the extended label sequence
// l'[s] = blank at even s, targets[b, (s-1)/2] at odd s, s < S_b = 2L + 1:
//
//   alpha[0, s] = lp[0, l'[s]]                     for s < 2
//   alpha[t, s] = lse(alpha[t-1, s], alpha[t-1, s-1], skip(s) ? alpha[t-1, s-2])
//                 + lp[t, l'[s]]
//   nll = -lse(alpha[T_b-1, S_b-1], alpha[T_b-1, S_b-2])      (reference: inf
//         for an alignment that cannot exist; 0 for T_b = L = 0)
//   beta[T_b-1, s] = lp[T_b-1, l'[s]]              for s >= S_b - 2
//   beta[t, s]  = lse(beta[t+1, s], beta[t+1, s+1], skip(s+2) ? beta[t+1, s+2])
//                 + lp[t, l'[s]]
//   d nll / d lp[t, c] = -sum_{s: l'[s] = c} exp(alpha + beta - lp[t, c] + nll)
//
// skip(s): s odd, s >= 3 and l'[s] != l'[s-2]. lse is log-sum-exp in
// float32, as PyTorch's CUDA CTC. The gradient is the true gradient with
// respect to lp (zero at t >= T_b, and for a row whose loss is inf or that
// has no frames); after log_softmax's backward it equals PyTorch's.
//
// Three kernels, one block a row for the recursions:
//   ctc_alpha_kernel: the forward over t, the states spread over the
//     block's threads, two rows of alpha ping-ponging in shared memory and
//     every row written to global memory for the backward;
//   ctc_beta_kernel: the same recursion backwards over t;
//   ctc_grad_kernel: one block a (t, b), one thread a class, each summing
//     its states' weights in state order: deterministic, no atomics.
//
// What bounds it on an H100: neither bytes nor operations. A recursion
// step is a handful of flops a state followed by a barrier, and a row's
// T_b steps run in sequence: latency, one block a row on B of the 132 SMs.
// It moves B*T*(C + 2*(2S+1)) * 4 bytes and does ~20 flops a (t, state).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxStates = 1023;  // 2 * S + 1: one pass of a 1024-thread block covers them

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(a, fmaxf(b, c));
  if (m == -CUDART_INF_F) return -CUDART_INF_F;
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

__device__ __forceinline__ float lse2(float a, float b) {
  return lse3(a, b, -CUDART_INF_F);
}

__device__ __forceinline__ int clamp_len(int64_t v, int hi) {
  return static_cast<int>(v < 0 ? 0 : (v > hi ? hi : v));
}

// The extended labels of row b and each state's skip flag, into shared memory.
__device__ void load_labels(const int64_t* targets, int b, int S, int Sb, int blank,
                            int* lab, bool* skip) {
  for (int s = threadIdx.x; s < Sb; s += blockDim.x)
    lab[s] = (s & 1) ? static_cast<int>(targets[static_cast<int64_t>(b) * S + s / 2]) : blank;
  __syncthreads();
  for (int s = threadIdx.x; s < Sb; s += blockDim.x)
    skip[s] = (s & 1) && s >= 3 && lab[s] != lab[s - 2];
  __syncthreads();
}

__global__ void ctc_alpha_kernel(const float* __restrict__ lp, const int64_t* __restrict__ targets,
                                 const int64_t* __restrict__ input_lengths,
                                 const int64_t* __restrict__ target_lengths,
                                 float* __restrict__ alpha, float* __restrict__ nll, int T, int C,
                                 int S, int blank) {
  extern __shared__ float smem[];
  const int Sp = 2 * S + 1;
  float* buf = smem;  // 2 * Sp
  int* lab = reinterpret_cast<int*>(buf + 2 * Sp);
  bool* skip = reinterpret_cast<bool*>(lab + Sp);
  const int b = blockIdx.x;
  const int Tb = clamp_len(input_lengths[b], T);
  const int L = clamp_len(target_lengths[b], S);
  const int Sb = 2 * L + 1;
  const float* lpb = lp + static_cast<int64_t>(b) * T * C;
  float* ab = alpha + static_cast<int64_t>(b) * T * Sp;
  load_labels(targets, b, S, Sb, blank, lab, skip);
  if (Tb == 0) {
    if (threadIdx.x == 0) nll[b] = L == 0 ? 0.f : CUDART_INF_F;
    return;
  }
  for (int s = threadIdx.x; s < Sb; s += blockDim.x) {
    const float v = s < 2 ? lpb[lab[s]] : -CUDART_INF_F;
    buf[s] = v;
    ab[s] = v;
  }
  __syncthreads();
  for (int t = 1; t < Tb; ++t) {
    const float* prev = buf + ((t - 1) & 1) * Sp;
    float* cur = buf + (t & 1) * Sp;
    const float* lpt = lpb + static_cast<int64_t>(t) * C;
    for (int s = threadIdx.x; s < Sb; s += blockDim.x) {
      const float a2 = s >= 1 ? prev[s - 1] : -CUDART_INF_F;
      const float a3 = skip[s] ? prev[s - 2] : -CUDART_INF_F;
      const float v = lse3(prev[s], a2, a3) + lpt[lab[s]];
      cur[s] = v;
      ab[static_cast<int64_t>(t) * Sp + s] = v;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float* last = buf + ((Tb - 1) & 1) * Sp;
    const float ll = L > 0 ? lse2(last[Sb - 1], last[Sb - 2]) : last[0];
    nll[b] = -ll;
  }
}

__global__ void ctc_beta_kernel(const float* __restrict__ lp, const int64_t* __restrict__ targets,
                                const int64_t* __restrict__ input_lengths,
                                const int64_t* __restrict__ target_lengths,
                                float* __restrict__ beta, int T, int C, int S, int blank) {
  extern __shared__ float smem[];
  const int Sp = 2 * S + 1;
  float* buf = smem;
  int* lab = reinterpret_cast<int*>(buf + 2 * Sp);
  bool* skip = reinterpret_cast<bool*>(lab + Sp);
  const int b = blockIdx.x;
  const int Tb = clamp_len(input_lengths[b], T);
  const int L = clamp_len(target_lengths[b], S);
  const int Sb = 2 * L + 1;
  const float* lpb = lp + static_cast<int64_t>(b) * T * C;
  float* bb = beta + static_cast<int64_t>(b) * T * Sp;
  load_labels(targets, b, S, Sb, blank, lab, skip);
  if (Tb == 0) return;
  const float* lpl = lpb + static_cast<int64_t>(Tb - 1) * C;
  for (int s = threadIdx.x; s < Sb; s += blockDim.x) {
    const float v = s >= Sb - 2 ? lpl[lab[s]] : -CUDART_INF_F;
    buf[((Tb - 1) & 1) * Sp + s] = v;
    bb[static_cast<int64_t>(Tb - 1) * Sp + s] = v;
  }
  __syncthreads();
  for (int t = Tb - 2; t >= 0; --t) {
    const float* next = buf + ((t + 1) & 1) * Sp;
    float* cur = buf + (t & 1) * Sp;
    const float* lpt = lpb + static_cast<int64_t>(t) * C;
    for (int s = threadIdx.x; s < Sb; s += blockDim.x) {
      const float b2 = s + 1 < Sb ? next[s + 1] : -CUDART_INF_F;
      const float b3 = s + 2 < Sb && skip[s + 2] ? next[s + 2] : -CUDART_INF_F;
      const float v = lse3(next[s], b2, b3) + lpt[lab[s]];
      cur[s] = v;
      bb[static_cast<int64_t>(t) * Sp + s] = v;
    }
    __syncthreads();
  }
}

// grid (T, B); one thread a class. grad (B, T, C) is written whole.
__global__ void ctc_grad_kernel(const float* __restrict__ lp, const int64_t* __restrict__ targets,
                                const int64_t* __restrict__ input_lengths,
                                const int64_t* __restrict__ target_lengths,
                                const float* __restrict__ alpha, const float* __restrict__ beta,
                                const float* __restrict__ nll, const float* __restrict__ grad_nll,
                                float* __restrict__ grad, int T, int C, int S, int blank) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int Sp = 2 * S + 1;
  const int Tb = clamp_len(input_lengths[b], T);
  const int L = clamp_len(target_lengths[b], S);
  const int Sb = 2 * L + 1;
  const float n = nll[b];
  float* gt = grad + (static_cast<int64_t>(b) * T + t) * C;
  if (t >= Tb || !isfinite(n)) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) gt[c] = 0.f;
    return;
  }
  const float g = grad_nll[b];
  const float* lpt = lp + (static_cast<int64_t>(b) * T + t) * C;
  const float* at = alpha + (static_cast<int64_t>(b) * T + t) * Sp;
  const float* bt = beta + (static_cast<int64_t>(b) * T + t) * Sp;
  const int64_t* tg = targets + static_cast<int64_t>(b) * S;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float base = n - lpt[c];
    float sum = 0.f;
    if (c == blank) {
      for (int s = 0; s < Sb; s += 2) sum += expf(at[s] + bt[s] + base);
    } else {
      for (int k = 0; k < L; ++k)
        if (tg[k] == c) sum += expf(at[2 * k + 1] + bt[2 * k + 1] + base);
    }
    gt[c] = -g * sum;
  }
}

int block_threads(int S) {
  const int Sp = 2 * S + 1;
  const int t = ((Sp + 31) / 32) * 32;
  return t < 64 ? 64 : t;
}

size_t recursion_smem(int S) {
  const size_t Sp = 2 * S + 1;
  return 2 * Sp * sizeof(float) + Sp * sizeof(int) + Sp * sizeof(bool);
}

bool shape_ok(int B, int T, int C, int S, int blank) {
  return B > 0 && T > 0 && C > 0 && S > 0 && 2 * S + 1 <= kMaxStates && blank >= 0 &&
         blank < C && B <= 65535;
}

}  // namespace

extern "C" int ctc_forward_f32(const float* lp, const int64_t* targets,
                               const int64_t* input_lengths, const int64_t* target_lengths,
                               float* alpha, float* nll, int B, int T, int C, int S, int blank,
                               cudaStream_t stream) {
  if (!shape_ok(B, T, C, S, blank)) return static_cast<int>(cudaErrorInvalidValue);
  ctc_alpha_kernel<<<B, block_threads(S), recursion_smem(S), stream>>>(
      lp, targets, input_lengths, target_lengths, alpha, nll, T, C, S, blank);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ctc_backward_f32(const float* lp, const int64_t* targets,
                                const int64_t* input_lengths, const int64_t* target_lengths,
                                const float* alpha, const float* nll, const float* grad_nll,
                                float* beta, float* grad, int B, int T, int C, int S, int blank,
                                cudaStream_t stream) {
  if (!shape_ok(B, T, C, S, blank)) return static_cast<int>(cudaErrorInvalidValue);
  ctc_beta_kernel<<<B, block_threads(S), recursion_smem(S), stream>>>(
      lp, targets, input_lengths, target_lengths, beta, T, C, S, blank);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = ((C + 31) / 32) * 32;
  ctc_grad_kernel<<<dim3(T, B), threads < 1024 ? threads : 1024, 0, stream>>>(
      lp, targets, input_lengths, target_lengths, alpha, beta, nll, grad_nll, grad, T, C, S,
      blank);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ctc_loss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
