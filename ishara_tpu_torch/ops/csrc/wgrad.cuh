// The weight-gradient products of the training kernels' backward passes and
// the fixed-order sum of their partials, shared by ffn.cu and
// conv_module.cu.
//
// dW = A^T . Bm summed over the rows of A [N, P] and Bm [N, Q] (row-major,
// operands bf16 or f32, accumulation f32). The rows are cut into S splits;
// split s writes its partial part[s] [P, Q] f32, and sum_parts adds the
// partials in a fixed order. No atomics, so a gradient is the same from run
// to run.
// Two product kernels:
//
// - bf16 with P and Q multiples of 8 (16-byte rows): a pipelined
//   tensor-core product. A block of 8 warps owns a 128 x 128 tile of dW and
//   one split, and walks its rows 32 at a time: each step's A and Bm rows
//   ([32][128] each) come through a 4-stage cp.async ring in shared memory,
//   so three steps are in flight while one is multiplied; both operands are
//   read with ldmatrix.trans (A^T is the A operand, Bm's rows are k-major),
//   and mma.sync m16n8k16 accumulates a 64 x 32 patch a warp in registers.
//   Rows past N, and columns past P or Q, read as zeros. Splits: enough to
//   give the card's 132 SMs two blocks each (the caller's choice of S).
// - f32 FMAs on the CUDA cores otherwise (f32, or widths off the 8-grid).
//
// sum_parts also adds the per-block column sums of the bias and norm
// gradients.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include "mma.cuh"

// Internal linkage: every source that includes this header gets its own
// copy, so no two of the port's libraries share a symbol.
namespace wgrad {
namespace {

typedef __nv_bfloat16 bf16;
constexpr int THREADS = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int TC_TILE = 128, TC_STEP = 32, TC_STAGES = 4;
constexpr int TC_LD = TC_TILE + 8;  // row stride of a staged tile (bf16)
constexpr size_t TC_SMEM = (size_t)TC_STAGES * 2 * TC_STEP * TC_LD * 2;

// Split blockIdx.z of the rows, TC_STEP at a time, into dW[p0.., q0..].
__global__ void __launch_bounds__(THREADS)
    product_tc_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
                      float* __restrict__ part, int N, int P, int Q,
                      int steps_per_split) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [stage][A | B][32][LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 1, wn = warp >> 1;          // 64 rows, 32 columns
  const int p0 = blockIdx.x * TC_TILE, q0 = blockIdx.y * TC_TILE;
  const int steps = (N + TC_STEP - 1) / TC_STEP;
  const int s0 = blockIdx.z * steps_per_split;
  const int n_steps = max(0, min(steps, s0 + steps_per_split) - s0);
  auto stage_a = [&](int st) { return ring + (size_t)st * 2 * TC_STEP * TC_LD; };
  auto issue = [&](int i) {
    const int r0 = (s0 + i) * TC_STEP, st = i % TC_STAGES;
    const int rows = min(TC_STEP, N - r0);
    tc::load_tile<bf16>(stage_a(st), TC_LD, A + (size_t)r0 * P + p0, P,
                        TC_STEP, TC_TILE, rows, P - p0, true, threadIdx.x,
                        THREADS);
    tc::load_tile<bf16>(stage_a(st) + TC_STEP * TC_LD, TC_LD,
                        Bm + (size_t)r0 * Q + q0, Q, TC_STEP, TC_TILE, rows,
                        Q - q0, true, threadIdx.x, THREADS);
  };
  float acc[4][4][4];
  tc::zero_acc(acc);
#pragma unroll
  for (int i = 0; i < TC_STAGES - 1; ++i) {
    if (i < n_steps) issue(i);
    tc::cp_async_commit();
  }
  for (int i = 0; i < n_steps; ++i) {
    tc::cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    if (i + TC_STAGES - 1 < n_steps) issue(i + TC_STAGES - 1);
    tc::cp_async_commit();
    const bf16* As = stage_a(i % TC_STAGES);
    tc::warp_mma<4, 4, true, true>(acc, As + wm * 64, TC_LD, 0,
                                   As + TC_STEP * TC_LD + wn * 32, TC_LD,
                                   TC_STEP);
  }
  float* dst = part + (size_t)blockIdx.z * P * Q;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + wm * 64 + i * 16 + g + 8 * h;
        const int q = q0 + wn * 32 + j * 8 + 2 * t;
        if (p >= P || q >= Q) continue;  // Q is even: q + 1 < Q too
        *reinterpret_cast<float2*>(dst + (size_t)p * Q + q) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

// A block of 16 x 16 threads owns a 64 x 64 tile of the result and one
// split; a thread owns a 4 x 4 patch of it and walks the rows 16 at a time
// through shared memory (rows past N read as 0).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    product_general_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                           float* __restrict__ part, int N, int P, int Q,
                           int steps_per_split) {
  __shared__ __align__(16) float As[16][64], Bs[16][64];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int p0 = blockIdx.x * 64, q0 = blockIdx.y * 64;
  const int steps = (N + 15) / 16;
  const int s0 = blockIdx.z * steps_per_split;
  const int s1 = min(steps, s0 + steps_per_split);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int s = s0; s < s1; ++s) {
    const size_t r0 = (size_t)s * 16;
    for (int e = threadIdx.x; e < 16 * 64; e += THREADS) {
      const int n = e >> 6, c = e & 63;
      const bool row = r0 + n < (size_t)N;
      As[n][c] = row && p0 + c < P ? widen(A[(r0 + n) * P + p0 + c]) : 0.f;
      Bs[n][c] = row && q0 + c < Q ? widen(Bm[(r0 + n) * Q + q0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const float4 av = *reinterpret_cast<const float4*>(&As[n][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[n][tx * 4]);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* dst = part + (size_t)blockIdx.z * P * Q;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + ty * 4 + i, q = q0 + tx * 4 + j;
      if (p < P && q < Q) dst[(size_t)p * Q + q] = acc[i][j];
    }
}

// out[i] = the sum over p of part[p][i] in a fixed order: a block owns 32
// columns; warp g sums the rows g, g + 8, g + 16, .. in that order, and the
// eight warps' sums are added in the order g = 0 .. 7. Eight row streams in
// flight a column keep the loads of a tall stack of partials (one for each
// time tile of each sequence) from queueing one behind the other.
constexpr int SUM_GROUPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
    sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                     int count, long long n) {
  __shared__ float red[SUM_GROUPS][33];
  const int c = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * 32 + c;
  float s = 0.f;
  if (i < n) {
#pragma unroll 8
    for (int p = grp; p < count; p += SUM_GROUPS) s += part[p * n + i];
  }
  red[grp][c] = s;
  __syncthreads();
  if (grp == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < SUM_GROUPS; ++g) t += red[g][c];
    out[i] = t;
  }
}

// Whether the tensor-core product takes these operands.
template <typename T>
inline bool product_on_tensor_cores(const T* A, const T* Bm, int P, int Q) {
  return sizeof(T) == 2 && P % 8 == 0 && Q % 8 == 0 &&
         reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(Bm) % 16 == 0;
}

// part [S][P][Q] = the S row splits' shares of A^T . Bm.
template <typename T>
inline cudaError_t product(const T* A, const T* Bm, float* part, int N, int P,
                           int Q, int S, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if (product_on_tensor_cores(A, Bm, P, Q)) {
      const int per_split = ((N + TC_STEP - 1) / TC_STEP + S - 1) / S;
      if (TC_SMEM > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            product_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)TC_SMEM);
        if (e != cudaSuccess) return e;
      }
      product_tc_kernel<<<dim3((P + TC_TILE - 1) / TC_TILE,
                               (Q + TC_TILE - 1) / TC_TILE, S),
                          THREADS, TC_SMEM, s>>>(A, Bm, part, N, P, Q,
                                                 per_split);
      return cudaGetLastError();
    }
  }
  const int per_split = ((N + 15) / 16 + S - 1) / S;
  product_general_kernel<T>
      <<<dim3((P + 63) / 64, (Q + 63) / 64, S), THREADS, 0, s>>>(
          A, Bm, part, N, P, Q, per_split);
  return cudaGetLastError();
}

inline cudaError_t sum_parts(const float* part, float* out, int count,
                             long long n, cudaStream_t s) {
  sum_parts_kernel<<<(int)((n + 31) / 32), THREADS, 0, s>>>(part, out, count,
                                                            n);
  return cudaGetLastError();
}

}  // namespace
}  // namespace wgrad
