// The weight-gradient products of the training kernels' backward passes and
// the fixed-order sum of their partials, shared by ffn.cu and
// conv_module.cu.
//
// dW = A^T . Bm summed over the rows of A [N, P] and Bm [N, Q] (row-major,
// operands bf16 or f32, accumulation f32). The rows are cut into S splits;
// split s writes its partial part[s] [P, Q] f32, and sum_parts adds the
// partials in a fixed order. No atomics, so a gradient is the same from run
// to run.
//
// Replaces no Pallas call of its own: it is the dW products inside K4's
// and K7's Pallas backwards (ishara_tpu/ops/ffn_kernel.py:104, `dw1 =
// _dot_tn(x, dhb)` under pallas_call :177; ishara_tpu/ops/conv_kernel.py
// :331), which a Hopper block cannot carry from one grid step to the next.
//
// Bound at the flagship's shapes (N = 256 x 176 = 45056 rows, P x Q = 256 x
// 512 or 512 x 256, bf16): bytes. A call reads 45056 x 768 bf16 = 69 MB,
// 0.021 ms at 3.35 TB/s, for 11.8 GFLOP, 0.012 ms at 989 TFLOP/s; the
// partials are this design's traffic on top.
//
// Two product kernels:
//
// - bf16 with P and Q multiples of 8 and 16-byte bases (what TMA reads):
//   warpgroup products on a TMA ring (product_wg_kernel). A block owns a
//   128 x 128 tile of dW and one split and walks its rows 64 at a time:
//   one producer thread brings each step's A [64][128] and Bm [64][128] (as
//   four [64][64] boxes in the 128-byte swizzle, rows past N and columns
//   past P or Q as TMA's zeros) into a ring of WG_STAGES slots; two consumer
//   warpgroups each own 64 rows of dW (p) and all 128 columns (q), two
//   m64n64 accumulators, and run wgmma with A^T read MN-major through the
//   transpose bit and Bm MN-major as the B operand, one step's products in
//   flight while the next step's wait; setmaxnreg gives the producer 40
//   registers and the consumers 232. The products are a small share of the
//   time (the step's 32 KB at an SM's share of the memory rate take ~4x its
//   products'), so the design is about keeping every SM's loads in flight:
//   S splits are about one block an SM (wgrad_splits in ops/ffn_kernel.py:
//   16 at the flagship), which also halves the partials of the mma.sync
//   design that came before (33 splits, 17 MB written and read again a
//   call at the flagship; 8.4 MB now);
// - f32 FMAs on the CUDA cores otherwise (f32, or widths off the 8-grid).
//
// sum_parts also adds the per-block column sums of the bias and norm
// gradients.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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

constexpr int WG_TILE = 128;    // rows (p) and columns (q) of a block's dW
constexpr int WG_STEP = 64;     // rows of A and Bm a ring slot
constexpr int WG_STAGES = 6;    // ring slots
constexpr int WG_BOX = 64 * 64 * 2;  // one [64][64] bf16 box
constexpr int WG_THREADS = 384;      // the producer and two consumers
constexpr int WG_PRODUCER_REGS = 40, WG_CONSUMER_REGS = 232;
constexpr size_t WG_SMEM =
    1024 + (size_t)WG_STAGES * 4 * WG_BOX + 16 * WG_STAGES;

// Split blockIdx.z of the rows, WG_STEP at a time, into dW[p0.., q0..]
// (ta: A [N, P], tb: Bm [N, Q], boxes [64][64]). An empty split writes
// zeros.
__global__ void __launch_bounds__(WG_THREADS, 1)
    product_wg_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb,
                      float* __restrict__ part, int N, int P, int Q,
                      int steps_per_split) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) &
                                    1023u);  // [slot][A0, A1, B0, B1][BOX]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WG_STAGES * 4 * WG_BOX);
  uint64_t* empty = full + WG_STAGES;
  const int p0 = blockIdx.x * WG_TILE, q0 = blockIdx.y * WG_TILE;
  const int steps = (N + WG_STEP - 1) / WG_STEP;
  const int s0 = blockIdx.z * steps_per_split;
  const int n_steps = max(0, min(steps, s0 + steps_per_split) - s0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 2 * 4);  // a lane of each consumer warp
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    regs_dec<WG_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % WG_STAGES, r0 = (s0 + i) * WG_STEP;
        unsigned char* slot = ring + s * 4 * WG_BOX;
        bar_wait(&empty[s], ((i / WG_STAGES) & 1) ^ 1);
        bar_expect(&full[s], 4 * WG_BOX);
        tma_load(slot, &ta, &full[s], p0, r0);
        tma_load(slot + WG_BOX, &ta, &full[s], p0 + 64, r0);
        tma_load(slot + 2 * WG_BOX, &tb, &full[s], q0, r0);
        tma_load(slot + 3 * WG_BOX, &tb, &full[s], q0 + 64, r0);
      }
    }
    return;
  }
  regs_inc<WG_CONSUMER_REGS>();
  const int w = (threadIdx.x - 128) >> 7;  // the consumer: dW rows 64 w ..
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  float acc0[32], acc1[32];  // columns q0 .. + 63 and q0 + 64 .. + 127
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  constexpr uint64_t K16 = (16 * 128) >> 4;  // 16 rows on: one k16 step
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % WG_STAGES;
    unsigned char* slot = ring + s * 4 * WG_BOX;
    const uint64_t ad = desc(slot + w * WG_BOX);
    const uint64_t bd0 = desc(slot + 2 * WG_BOX);
    const uint64_t bd1 = desc(slot + 3 * WG_BOX);
    bar_wait(&full[s], (i / WG_STAGES) & 1);
    fence_regs(acc0);
    fence_regs(acc1);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      mma_ss<1, 1>(acc0, ad + ks * K16, bd0 + ks * K16, 1);
      mma_ss<1, 1>(acc1, ad + ks * K16, bd1 + ks * K16, 1);
    }
    wg_commit();
    wg_wait<1>();  // the step before is done: its slot goes back
    if (i > 0 && lane == 0) bar_arrive(&empty[(i - 1) % WG_STAGES]);
  }
  wg_wait<0>();
  fence_regs(acc0);
  fence_regs(acc1);
  // element 4 jj + e: dW row 64 w + 16 warp + g + 8 (e >> 1), column
  // 8 jj + 2 t + (e & 1) of the accumulator's 64
  float* dst = part + (size_t)blockIdx.z * P * Q;
  const int g = lane >> 2, t = lane & 3;
  auto store = [&](const float (&acc)[32], int qa) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = p0 + 64 * w + 16 * warp + g + 8 * hh;
        const int q = qa + 8 * jj + 2 * t;
        if (p >= P || q >= Q) continue;  // Q is even: q + 1 < Q too
        *reinterpret_cast<float2*>(dst + (size_t)p * Q + q) =
            make_float2(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
      }
  };
  store(acc0, q0);
  store(acc1, q0 + 64);
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

// Whether the wgmma product takes these operands: bf16, rows of 16-byte
// multiples (P, Q multiples of 8) from 16-byte bases, so that TMA reads
// them.
template <typename T>
inline bool product_on_tensor_cores(const T* A, const T* Bm, int P, int Q) {
  return sizeof(T) == 2 && P % 8 == 0 && Q % 8 == 0 &&
         reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(Bm) % 16 == 0;
}

// part [S][P][Q] = the S row splits' shares of A^T . Bm. A launch the
// chosen kernel refuses fails; nothing falls back.
template <typename T>
inline cudaError_t product(const T* A, const T* Bm, float* part, int N, int P,
                           int Q, int S, cudaStream_t s) {
  if (N < 1 || P < 1 || Q < 1 || S < 1) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    if (product_on_tensor_cores(A, Bm, P, Q)) {
      CUtensorMap ta, tb;
      cudaError_t e = hopper::tensor_map(&ta, A, N, P, 64, 64);
      if (e == cudaSuccess) e = hopper::tensor_map(&tb, Bm, N, Q, 64, 64);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(product_wg_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)WG_SMEM);
      if (e != cudaSuccess) return e;
      const int per_split = ((N + WG_STEP - 1) / WG_STEP + S - 1) / S;
      product_wg_kernel<<<dim3((P + WG_TILE - 1) / WG_TILE,
                               (Q + WG_TILE - 1) / WG_TILE, S),
                          WG_THREADS, WG_SMEM, s>>>(ta, tb, part, N, P, Q,
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
