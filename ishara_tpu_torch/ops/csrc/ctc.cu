// CTC loss on Hopper (sm_90a): the alpha recursion (forward pass) and the
// beta recursion with the occupancy gradient (backward pass).
//
// Replaces the Pallas kernels _alpha_kernel and _beta_kernel of
// ishara_tpu/ops/ctc_kernel.py (behind ctc_loss_kernel), together with the
// log-softmax, the emission gather and the per-class occupancy sum that the
// reference leaves to XLA around them. Training contract only: every row
// uses all T frames, its label length is its count of non-blank labels.
//
// One block per batch row, one thread per state of the blank-extended label
// sequence (S = 2U + 1). The row's log-probabilities [T, C] are computed once
// into shared memory (a warp per frame), alpha (or beta + emit) lives in two
// shared buffers that swap every frame, and each of the T dependent steps
// costs one barrier. Same arithmetic as the reference: additive -1e30 masks
// for the skip transition, the valid states, the initial and the final
// states; a three-way log-add-exp that returns -1e30 when its inputs are;
// the carry be = beta + emit; occupancy exp(min(alpha + beta - logP, 0)).
// The gradient softmax - occupancy is written by the beta kernel itself: the
// states of one class are listed once per row (a counting sort), the blank's
// long list is summed by a warp, every other class by one thread, always in
// the same order, so the result does not change from run to run.
//
// Bound: bytes on paper (logits read, alpha [B, T, S] written then read, the
// gradient written: about 60 MB at B 256, T 176, U 64, C 60), but what binds
// it is latency: T dependent steps of a few shared-memory reads, two expf and
// a logf each, on B blocks of S threads.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float lae2(float a, float b) {
  const float m = fmaxf(a, b);
  if (m <= NEG) return NEG;
  return m + logf(expf(a - m) + expf(b - m));
}

__device__ __forceinline__ float lae3(float a, float b, float c) {
  return lae2(lae2(a, b), c);
}

// lp[t * C + c] = log_softmax(logits[t, :])[c] for one batch row, a warp a
// frame.
__device__ void row_log_softmax(const float* __restrict__ logits, float* lp,
                                int T, int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = warp; t < T; t += nwarps) {
    const float* row = logits + (size_t)t * C;
    float m = -INFINITY;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, row[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += expf(row[c] - m);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float ls = logf(s);
    for (int c = lane; c < C; c += 32) lp[t * C + c] = (row[c] - m) - ls;
  }
}

// Shared memory, alpha kernel: lp [T*C] | a [2][S+2] | ext [S] (int).
__global__ void ctc_alpha_kernel(const float* __restrict__ logits,
                                 const int* __restrict__ labels, int T, int C,
                                 int U, int blank, float* __restrict__ alpha,
                                 float* __restrict__ nll) {
  extern __shared__ float smem[];
  const int S = 2 * U + 1;
  const int b = blockIdx.x, s = threadIdx.x;
  float* lp = smem;
  float* abuf = lp + T * C;
  int* ext = reinterpret_cast<int*>(abuf + 2 * (S + 2));

  row_log_softmax(logits + (size_t)b * T * C, lp, T, C);
  const int* lab = labels + (size_t)b * U;
  // a label outside [0, C) is clamped: it can then never index past a row
  if (s < S) ext[s] = (s & 1) ? min(max(lab[s >> 1], 0), C - 1) : blank;
  const int L = __syncthreads_count(s < U && lab[s < U ? s : 0] != blank);

  float skip = NEG, valid = NEG;
  int cls = blank;
  if (s < S) {
    cls = ext[s];
    if ((s & 1) && s >= 2 && cls != ext[s - 2]) skip = 0.f;
    if (s < 2 * L + 1) valid = 0.f;
  }
  if (s < 4) abuf[(s >> 1) * (S + 2) + (s & 1)] = NEG;  // the two left pads
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    if (s < S) {
      const float e = lp[t * C + cls];
      float v;
      if (t == 0) {
        v = (s < 2 ? 0.f : NEG) + valid + e;
      } else {
        const float* prev = abuf + cur * (S + 2);
        v = lae3(prev[s + 2], prev[s + 1], prev[s] + skip) + e + valid;
      }
      abuf[(cur ^ 1) * (S + 2) + s + 2] = v;
      if (alpha != nullptr) alpha[((size_t)b * T + t) * S + s] = v;
    }
    cur ^= 1;
    __syncthreads();
  }
  if (s == 0) {
    const float* last = abuf + cur * (S + 2) + 2;
    const float a_lab = L > 0 ? last[2 * L - 1] : NEG;
    nll[b] = -lae2(a_lab, last[2 * L]);
  }
}

// Shared memory, beta kernel: lp [T*C] | be [2][S+2] | p [2][S] | ext [S] |
// order [S] | start [C+1] (ints).
__global__ void ctc_beta_kernel(const float* __restrict__ logits,
                                const int* __restrict__ labels,
                                const float* __restrict__ alpha,
                                const float* __restrict__ nll,
                                const float* __restrict__ dy, int T, int C,
                                int U, int blank, float* __restrict__ grad) {
  extern __shared__ float smem[];
  const int S = 2 * U + 1;
  const int b = blockIdx.x, s = threadIdx.x;
  const int lane = s & 31;
  float* lp = smem;
  float* bebuf = lp + T * C;
  float* pbuf = bebuf + 2 * (S + 2);
  int* ext = reinterpret_cast<int*>(pbuf + 2 * S);
  int* order = ext + S;
  int* start = order + S;

  row_log_softmax(logits + (size_t)b * T * C, lp, T, C);
  const int* lab = labels + (size_t)b * U;
  // a label outside [0, C) is clamped: it can then never index past a row
  if (s < S) ext[s] = (s & 1) ? min(max(lab[s >> 1], 0), C - 1) : blank;
  const int L = __syncthreads_count(s < U && lab[s < U ? s : 0] != blank);

  // the states of each class, in ascending order (counting sort)
  int count = 0;
  if (s < C)
    for (int i = 0; i < S; ++i) count += ext[i] == s;
  if (s < C) start[s + 1] = count;
  __syncthreads();
  if (s == 0) {
    start[0] = 0;
    for (int c = 0; c < C; ++c) start[c + 1] += start[c];
  }
  __syncthreads();
  if (s < C) {
    int at = start[s];
    for (int i = 0; i < S; ++i)
      if (ext[i] == s) order[at++] = i;
  }

  float skipf = NEG, valid = NEG, fin = NEG;
  int cls = blank;
  if (s < S) {
    cls = ext[s];
    // a skip out of s lands at s + 2
    if (s + 2 < S && ((s + 2) & 1) && ext[s + 2] != cls) skipf = 0.f;
    if (s < 2 * L + 1) valid = 0.f;
    if (s == 2 * L || (s == 2 * L - 1 && L > 0)) fin = 0.f;
  }
  if (s < 4) bebuf[(s >> 1) * (S + 2) + S + (s & 1)] = NEG;  // right pads
  const float logp = -nll[b];
  const float g = dy[b];
  __syncthreads();

  int cur = 0;
  for (int t = T - 1; t >= 0; --t) {
    if (s < S) {
      float beta;
      if (t == T - 1) {
        beta = fin;
      } else {
        const float* prev = bebuf + cur * (S + 2);
        beta = lae3(prev[s], prev[s + 1], prev[s + 2] + skipf) + valid;
      }
      bebuf[(cur ^ 1) * (S + 2) + s] = beta + lp[t * C + cls];
      const float gamma = alpha[((size_t)b * T + t) * S + s] + beta - logp;
      pbuf[(t & 1) * S + s] = expf(fminf(gamma, 0.f));
    }
    cur ^= 1;
    __syncthreads();
    // frame t's gradient row: softmax - occupancy. Warp 0 sums the blank's
    // states, thread 32 + c those of class c.
    const float* p = pbuf + (t & 1) * S;
    float* grow = grad + ((size_t)b * T + t) * C;
    if (s < 32) {
      float occ = 0.f;
      for (int i = start[blank] + lane; i < start[blank + 1]; i += 32)
        occ += p[order[i]];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        occ += __shfl_xor_sync(0xffffffffu, occ, o);
      if (lane == 0) grow[blank] = (expf(lp[t * C + blank]) - occ) * g;
    } else if (s - 32 < C && s - 32 != blank) {
      const int c = s - 32;
      float occ = 0.f;
      for (int i = start[c]; i < start[c + 1]; ++i) occ += p[order[i]];
      grow[c] = (expf(lp[t * C + c]) - occ) * g;
    }
  }
}

int threads_for(int S, int C) {
  const int a = (S + 31) / 32 * 32;
  const int b = 32 + (C + 31) / 32 * 32;
  return a > b ? a : b;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// nll[b] = -log P(labels[b] | logits[b]) for logits [B, T, C] f32 and labels
// [B, U] int32 padded with blank; alpha [B, T, S] (S = 2U + 1) is kept for
// the backward pass when the pointer is not null.
int ishara_ctc_alpha(int device, const void* logits, const void* labels,
                     int B, int T, int C, int U, int blank, void* alpha,
                     void* nll, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0) return 0;
  const int S = 2 * U + 1;
  const int threads = threads_for(S, C);
  if (threads > 1024 || blank < 0 || blank >= C)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)T * C + 2 * (S + 2) + S) * 4;
  e = allow_smem(ctc_alpha_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  ctc_alpha_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const float*)logits, (const int*)labels, T, C, U, blank, (float*)alpha,
      (float*)nll);
  return (int)cudaGetLastError();
}

// grad [B, T, C] = dy[b] * d nll[b] / d logits, from the alpha and nll of
// ishara_ctc_alpha on the same inputs.
int ishara_ctc_beta(int device, const void* logits, const void* labels,
                    const void* alpha, const void* nll, const void* dy, int B,
                    int T, int C, int U, int blank, void* grad, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0) return 0;
  const int S = 2 * U + 1;
  const int threads = threads_for(S, C);
  if (threads > 1024 || blank < 0 || blank >= C)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)T * C + 2 * (S + 2) + 2 * S + 2 * S + C + 1) * 4;
  e = allow_smem(ctc_beta_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  ctc_beta_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const float*)logits, (const int*)labels, (const float*)alpha,
      (const float*)nll, (const float*)dy, T, C, U, blank, (float*)grad);
  return (int)cudaGetLastError();
}

const char* ishara_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
