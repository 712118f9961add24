// CTC loss on Hopper (sm_90a): the alpha recursion (forward pass) and the
// beta recursion with the occupancy gradient (backward pass) (K1).
//
// Replaces the Pallas kernels _alpha_kernel and _beta_kernel of
// ishara_tpu/ops/ctc_kernel.py (behind ctc_loss_kernel), together with the
// log-softmax, the emission gather and the per-class occupancy sum that the
// reference leaves to XLA around them. Training contract only: every row
// uses all T frames, its label length is its count of non-blank labels.
//
// One block per batch row; the S = 2U + 1 states of the blank-extended label
// sequence are spread over the block's threads, K to a thread (K a power of
// two, so any S runs). A first sweep (a warp per frame) keeps each frame's
// log-softmax normaliser lse[t] in shared memory -- T floats, so T runs to
// about 50,000 frames -- and the recursions read the S emissions of a frame,
// logits[b, t, ext[s]] - lse[t], from device memory, one frame ahead into
// registers so that the loads overlap the step before. alpha (or beta +
// emit) lives in two shared buffers that swap every frame, and each of the T
// dependent steps costs one barrier. Same arithmetic as the reference:
// additive -1e30 masks for the skip transition, the valid states, the
// initial and the final states; a three-way log-add-exp that returns -1e30
// when its inputs are; the carry be = beta + emit; occupancy
// exp(min(alpha + beta - logP, 0)). The gradient softmax - occupancy is
// written by the beta kernel itself: the states of one class are listed once
// per row (a counting sort over any number of classes), the blank's long
// list is summed by a warp, every other class by one thread, always in the
// same order, so the result does not change from run to run.
//
// Bound: bytes on paper (logits read, alpha [B, T, S] written then read, the
// gradient written: about 60 MB at B 256, T 176, U 64, C 60), but what binds
// it is latency: T dependent steps of a few loads, two expf and a logf each,
// on B blocks. The design keeps one barrier a step and takes the emission
// loads off the dependent chain.

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

// lse[t] = logsumexp(logits[t, :]) of one batch row, a warp a frame.
__device__ void row_lse(const float* __restrict__ logits, float* lse, int T,
                        int C) {
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
    if (lane == 0) lse[t] = m + logf(s);
  }
}

// ext[s] for every state; returns this thread's share of the row's count of
// non-blank labels (block_sum adds the shares).
__device__ int extend(const int* lab, int U, int S, int C, int blank,
                      int* ext) {
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    // a label outside [0, C) is clamped: it can then never index past a row
    ext[s] = (s & 1) ? min(max(lab[s >> 1], 0), C - 1) : blank;
  int n = 0;
  for (int u = threadIdx.x; u < U; u += blockDim.x) n += lab[u] != blank;
  return n;
}

__device__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// Shared memory, alpha kernel: lse [T] | a [2][S+2] | ext [S] | red [32].
template <int K>
__global__ void ctc_alpha_kernel(const float* __restrict__ logits,
                                 const int* __restrict__ labels, int T, int C,
                                 int U, int blank, float* __restrict__ alpha,
                                 float* __restrict__ nll) {
  extern __shared__ float smem[];
  const int S = 2 * U + 1, nt = blockDim.x;
  const int b = blockIdx.x;
  float* lse = smem;
  float* abuf = lse + T;
  int* ext = reinterpret_cast<int*>(abuf + 2 * (S + 2));
  int* red = ext + S;
  const float* x = logits + (size_t)b * T * C;

  row_lse(x, lse, T, C);
  const int* lab = labels + (size_t)b * U;
  const int L = block_sum(extend(lab, U, S, C, blank, ext), red);

  float skip[K], valid[K], e[K];
  int cls[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = threadIdx.x + k * nt;
    skip[k] = NEG, valid[k] = NEG, cls[k] = blank;
    if (s < S) {
      cls[k] = ext[s];
      if ((s & 1) && s >= 2 && cls[k] != ext[s - 2]) skip[k] = 0.f;
      if (s < 2 * L + 1) valid[k] = 0.f;
    }
    e[k] = s < S ? x[cls[k]] : 0.f;  // frame 0's logits
  }
  if (threadIdx.x < 4) abuf[(threadIdx.x >> 1) * (S + 2) + (threadIdx.x & 1)]
      = NEG;  // the two left pads of each buffer
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    float nx[K];
#pragma unroll
    for (int k = 0; k < K; ++k)  // frame t + 1, loaded ahead
      nx[k] = (t + 1 < T && threadIdx.x + k * nt < S)
                  ? x[(size_t)(t + 1) * C + cls[k]] : 0.f;
    const float l_t = lse[t];
    const float* prev = abuf + cur * (S + 2);
    float* next = abuf + (cur ^ 1) * (S + 2);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x + k * nt;
      if (s < S) {
        const float em = e[k] - l_t;
        float v;
        if (t == 0)
          v = (s < 2 ? 0.f : NEG) + valid[k] + em;
        else
          v = lae3(prev[s + 2], prev[s + 1], prev[s] + skip[k]) + em +
              valid[k];
        next[s + 2] = v;
        if (alpha != nullptr) alpha[((size_t)b * T + t) * S + s] = v;
      }
      e[k] = nx[k];
    }
    cur ^= 1;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float* last = abuf + cur * (S + 2) + 2;
    const float a_lab = L > 0 ? last[2 * L - 1] : NEG;
    nll[b] = -lae2(a_lab, last[2 * L]);
  }
}

// Shared memory, beta kernel: lse [T] | be [2][S+2] | p [2][S] | ext [S] |
// order [S] | start [C+1] | red [32] (ints).
template <int K>
__global__ void ctc_beta_kernel(const float* __restrict__ logits,
                                const int* __restrict__ labels,
                                const float* __restrict__ alpha,
                                const float* __restrict__ nll,
                                const float* __restrict__ dy, int T, int C,
                                int U, int blank, float* __restrict__ grad) {
  extern __shared__ float smem[];
  const int S = 2 * U + 1, nt = blockDim.x;
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  float* lse = smem;
  float* bebuf = lse + T;
  float* pbuf = bebuf + 2 * (S + 2);
  int* ext = reinterpret_cast<int*>(pbuf + 2 * S);
  int* order = ext + S;
  int* start = order + S;
  int* red = start + C + 1;
  const float* x = logits + (size_t)b * T * C;

  row_lse(x, lse, T, C);
  const int* lab = labels + (size_t)b * U;
  const int L = block_sum(extend(lab, U, S, C, blank, ext), red);

  // the states of each class, in ascending order (counting sort)
  for (int c = threadIdx.x; c < C; c += nt) {
    int count = 0;
    for (int i = 0; i < S; ++i) count += ext[i] == c;
    start[c + 1] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    start[0] = 0;
    for (int c = 0; c < C; ++c) start[c + 1] += start[c];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += nt) {
    int at = start[c];
    for (int i = 0; i < S; ++i)
      if (ext[i] == c) order[at++] = i;
  }

  float skipf[K], valid[K], fin[K], e[K], a[K];
  int cls[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = threadIdx.x + k * nt;
    skipf[k] = NEG, valid[k] = NEG, fin[k] = NEG, cls[k] = blank;
    if (s < S) {
      cls[k] = ext[s];
      // a skip out of s lands at s + 2
      if (s + 2 < S && ((s + 2) & 1) && ext[s + 2] != cls[k]) skipf[k] = 0.f;
      if (s < 2 * L + 1) valid[k] = 0.f;
      if (s == 2 * L || (s == 2 * L - 1 && L > 0)) fin[k] = 0.f;
    }
    e[k] = s < S ? x[(size_t)(T - 1) * C + cls[k]] : 0.f;
    a[k] = s < S ? alpha[((size_t)b * T + T - 1) * S + s] : 0.f;
  }
  // the classes of this thread's gradient entries: c0, c0 + nt, ...; the
  // first warp sums the blank's states, so the classes start at thread 32
  const int c0 = (threadIdx.x + nt - 32) % nt;
  float xg = c0 < C ? x[(size_t)(T - 1) * C + c0] : 0.f;
  if (threadIdx.x < 4)
    bebuf[(threadIdx.x >> 1) * (S + 2) + S + (threadIdx.x & 1)] = NEG;
  const float logp = -nll[b];
  const float g = dy[b];
  __syncthreads();

  int cur = 0;
  for (int t = T - 1; t >= 0; --t) {
    float nx[K], na[K];  // frame t - 1, loaded ahead
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x + k * nt;
      const bool ok = t > 0 && s < S;
      nx[k] = ok ? x[(size_t)(t - 1) * C + cls[k]] : 0.f;
      na[k] = ok ? alpha[((size_t)b * T + t - 1) * S + s] : 0.f;
    }
    const float nxg = (t > 0 && c0 < C) ? x[(size_t)(t - 1) * C + c0] : 0.f;
    const float l_t = lse[t];
    const float* prev = bebuf + cur * (S + 2);
    float* next = bebuf + (cur ^ 1) * (S + 2);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x + k * nt;
      if (s < S) {
        float beta;
        if (t == T - 1)
          beta = fin[k];
        else
          beta = lae3(prev[s], prev[s + 1], prev[s + 2] + skipf[k]) +
                 valid[k];
        next[s] = beta + (e[k] - l_t);
        pbuf[(t & 1) * S + s] = expf(fminf(a[k] + beta - logp, 0.f));
      }
      e[k] = nx[k];
      a[k] = na[k];
    }
    cur ^= 1;
    __syncthreads();
    // frame t's gradient row: softmax - occupancy. Warp 0 sums the blank's
    // states, one thread each other class, in list order.
    const float* p = pbuf + (t & 1) * S;
    const float* xr = x + (size_t)t * C;
    float* grow = grad + ((size_t)b * T + t) * C;
    if (threadIdx.x < 32) {
      float occ = 0.f;
      for (int i = start[blank] + lane; i < start[blank + 1]; i += 32)
        occ += p[order[i]];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        occ += __shfl_xor_sync(0xffffffffu, occ, o);
      if (lane == 0) grow[blank] = (expf(xr[blank] - l_t) - occ) * g;
    }
    for (int c = c0; c < C; c += nt) {
      if (c == blank) continue;
      float occ = 0.f;
      for (int i = start[c]; i < start[c + 1]; ++i) occ += p[order[i]];
      grow[c] = (expf((c == c0 ? xg : xr[c]) - l_t) - occ) * g;
    }
    xg = nxg;
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

constexpr size_t SMEM_LIMIT = 227 * 1024;
constexpr int MAX_K = 32;  // states a thread: S up to 32768

// States a thread (a power of two) and threads a block for S states.
void geometry(int S, int* K, int* threads) {
  int k = 1;
  while (k < MAX_K && S > 1024 * k) k *= 2;
  *K = k;
  const int n = (S + k - 1) / k;
  *threads = (n + 31) / 32 * 32;
}

template <int K>
cudaError_t launch_alpha(int B, int threads, size_t smem, cudaStream_t s,
                         const float* logits, const int* labels, int T, int C,
                         int U, int blank, float* alpha, float* nll) {
  cudaError_t e = allow_smem(ctc_alpha_kernel<K>, smem);
  if (e != cudaSuccess) return e;
  ctc_alpha_kernel<K><<<B, threads, smem, s>>>(logits, labels, T, C, U,
                                               blank, alpha, nll);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_beta(int B, int threads, size_t smem, cudaStream_t s,
                        const float* logits, const int* labels,
                        const float* alpha, const float* nll,
                        const float* dy, int T, int C, int U, int blank,
                        float* grad) {
  cudaError_t e = allow_smem(ctc_beta_kernel<K>, smem);
  if (e != cudaSuccess) return e;
  ctc_beta_kernel<K><<<B, threads, smem, s>>>(logits, labels, alpha, nll, dy,
                                              T, C, U, blank, grad);
  return cudaGetLastError();
}

size_t smem_bytes(int T, int C, int U, bool backward) {
  const size_t S = 2 * (size_t)U + 1;
  return backward ? ((size_t)T + 2 * (S + 2) + 2 * S + 2 * S + C + 1 + 32) * 4
                  : ((size_t)T + 2 * (S + 2) + S + 32) * 4;
}

bool fits(int T, int C, int U) {  // the beta kernel needs the more
  return T >= 1 && 2 * U + 1 <= 1024 * MAX_K &&
         smem_bytes(T, C, U, true) <= SMEM_LIMIT;
}

}  // namespace

extern "C" {

// 1 when the kernels take a row of T frames, C classes and U labels: lse
// [T] and the states' and classes' buffers within a block's shared memory.
int ishara_ctc_fits(int T, int C, int U) { return fits(T, C, U) ? 1 : 0; }


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
  const size_t smem = smem_bytes(T, C, U, false);
  if (!fits(T, C, U) || blank < 0 || blank >= C)
    return (int)cudaErrorInvalidValue;
  int K, threads;
  geometry(S, &K, &threads);
#define ISHARA_ALPHA(k)                                                     \
  launch_alpha<k>(B, threads, smem, static_cast<cudaStream_t>(stream),       \
                  (const float*)logits, (const int*)labels, T, C, U, blank, \
                  (float*)alpha, (float*)nll)
  switch (K) {
    case 1: return (int)ISHARA_ALPHA(1);
    case 2: return (int)ISHARA_ALPHA(2);
    case 4: return (int)ISHARA_ALPHA(4);
    case 8: return (int)ISHARA_ALPHA(8);
    case 16: return (int)ISHARA_ALPHA(16);
    default: return (int)ISHARA_ALPHA(32);
  }
#undef ISHARA_ALPHA
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
  const size_t smem = smem_bytes(T, C, U, true);
  if (!fits(T, C, U) || blank < 0 || blank >= C)
    return (int)cudaErrorInvalidValue;
  int K, threads;
  geometry(S, &K, &threads);
#define ISHARA_BETA(k)                                                       \
  launch_beta<k>(B, threads, smem, static_cast<cudaStream_t>(stream),         \
                 (const float*)logits, (const int*)labels,                   \
                 (const float*)alpha, (const float*)nll, (const float*)dy, T, \
                 C, U, blank, (float*)grad)
  switch (K) {
    case 1: return (int)ISHARA_BETA(1);
    case 2: return (int)ISHARA_BETA(2);
    case 4: return (int)ISHARA_BETA(4);
    case 8: return (int)ISHARA_BETA(8);
    case 16: return (int)ISHARA_BETA(16);
    default: return (int)ISHARA_BETA(32);
  }
#undef ISHARA_BETA
}

const char* ishara_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
