// The weight-gradient products of the training kernels' backward passes and
// the fixed-order sum of their partials, shared by ffn.cu and
// conv_module.cu.
//
// dW = A^T . Bm summed over the rows of A [N, P] and Bm [N, Q] (row-major,
// operands bf16 or f32, accumulation f32). The rows are cut into S splits of
// 16-row steps; split s writes its partial part[s] [P, Q] f32, and
// sum_parts adds part[0] + part[1] + ... in that order. No atomics, so a
// gradient is the same from run to run. Two product kernels: wmma 16x16x16
// tiles where the operands are bf16, P % 64 == 0, Q % 128 == 0 and
// N % 16 == 0; f32 FMAs on the CUDA cores otherwise (any widths and rows).
// sum_parts also adds the per-block column sums of the bias and norm
// gradients.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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

// A block of 8 warps owns a 64 x 128 tile of the result and one split; warp
// w owns its columns w * 16 .. and reads its fragments straight from global
// memory.
__global__ void __launch_bounds__(THREADS)
    product_tc_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
                      float* __restrict__ part, int N, int P, int Q,
                      int steps_per_split) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int p0 = blockIdx.x * 64, q0 = blockIdx.y * 128 + warp * 16;
  const int steps = N / 16;
  const int s0 = blockIdx.z * steps_per_split;
  const int s1 = min(steps, s0 + steps_per_split);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int s = s0; s < s1; ++s) {
    const size_t r0 = (size_t)s * 16;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
    wmma::load_matrix_sync(b, Bm + r0 * Q + q0, Q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // A^T tile: element (p, row) sits at row * P + p
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, A + r0 * P + p0 + i * 16, P);
      wmma::mma_sync(acc[i], a, b, acc[i]);
    }
  }
  float* dst = part + (size_t)blockIdx.z * P * Q;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    wmma::store_matrix_sync(dst + (size_t)(p0 + i * 16) * Q + q0, acc[i], Q,
                            wmma::mem_row_major);
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

// out[i] = part[0][i] + part[1][i] + ... in that order.
__global__ void sum_parts_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int count,
                                 long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < count; ++p) s += part[p * n + i];
  out[i] = s;
}

// part [S][P][Q] = the S row splits' shares of A^T . Bm.
template <typename T>
inline cudaError_t product(const T* A, const T* Bm, float* part, int N, int P,
                           int Q, int S, cudaStream_t s) {
  const int per_split = ((N + 15) / 16 + S - 1) / S;
  if constexpr (sizeof(T) == 2) {
    if (P % 64 == 0 && Q % 128 == 0 && N % 16 == 0) {
      product_tc_kernel<<<dim3(P / 64, Q / 128, S), THREADS, 0, s>>>(
          A, Bm, part, N, P, Q, per_split);
      return cudaGetLastError();
    }
  }
  product_general_kernel<T>
      <<<dim3((P + 63) / 64, (Q + 63) / 64, S), THREADS, 0, s>>>(
          A, Bm, part, N, P, Q, per_split);
  return cudaGetLastError();
}

inline cudaError_t sum_parts(const float* part, float* out, int count,
                             long long n, cudaStream_t s) {
  sum_parts_kernel<<<(int)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      part, out, count, n);
  return cudaGetLastError();
}

}  // namespace
}  // namespace wgrad
