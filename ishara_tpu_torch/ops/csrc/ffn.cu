// The feed-forward branch with its residual for training on Hopper (sm_90a):
//   out = res + drop2(drop1(swish(x . w1 + b1)) . w2 + b2)
// forward and backward, both dropout masks regenerated and never stored.
//
// Replaces the Pallas kernels _fwd_kernel and _bwd_kernel of
// ishara_tpu/ops/ffn_kernel.py (behind ffn_residual) and the mask probe
// behind debug_masks. x, res, dy, out, dx are [N, K] in the compute type,
// bf16 or f32; w1 [K, M] and w2 [M, K] are of that type too; the biases and
// every weight gradient are f32.
//
// Arithmetic and rounding points as the reference: both products take
// operands of the compute type and accumulate in f32; the hidden a =
// swish(h) * keep1' is rounded to the compute type before the second product;
// in the backward g = dy * keep2' (f32, summed into db2 unrounded) is rounded
// for its two products, dh = (g . w2^T) * keep1' * swish'(h) is f32 (summed
// into db1 unrounded) and rounded for its two. keep' = keep /
// (1 - rate) is the Philox function of philox.cuh: the hidden's mask is keyed
// by seeds[0] with flat index row * M + column, the output's by seeds[1] with
// row * K + column.
//
// Two sets of kernels. bf16 at widths that are multiples of 128 -- every
// preset's training geometry -- takes the tensor cores (wmma 16x16x16); f32,
// and bf16 at any other width, takes the general kernels further down, the
// same three steps with the row products as f32 FMAs on the CUDA cores (the
// weight products take wgrad.cuh's kernels by its own rule).
//
// Design of the tensor-core set. A block of 8 warps owns 32 rows. Forward:
// the x tile and then the 32 x M hidden stay in shared memory between the two
// products; the weights
// (K * M bf16 each, resident in L2) are read as wmma fragments straight from
// global memory; every accumulator tile passes through a per-warp f32 staging
// tile so that the epilogue knows each value's (row, column) for its bias and
// its mask. Backward, three steps: (1) a row kernel recomputes h and computes
// g . w2^T tile by tile in the same pass, so neither is ever held at f32 for
// the whole tile; it writes dx, and leaves bf16 d = a * keep1', dh and g in
// global scratch with the per-block column sums for db1 and db2; (2) the
// weight products of wgrad.cuh form dw2 = d^T . g and dw1 = x^T . dh as split
// sums over row ranges, each block keeping its accumulators in registers for
// its whole range; (3) the partial sums are added in a fixed order. No
// atomics: every gradient is the same from run to run.
//
// Bound: operations on paper (12 N K M for forward and backward together,
// 71 GFLOP at N 45056, K 256, M 512, against 115 MB of x, res, dy, out, dx),
// but this first version is bound by how it feeds the tensor cores: fragments
// loaded from L2 and shared memory with no asynchronous copies, and the
// backward's hidden-sized scratch (3 bf16 tensors written and read once).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "philox.cuh"
#include "wgrad.cuh"

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int R = 32;      // rows a block owns
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;     // bf16 elements of padding per shared-memory row

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc[rt][ct] += A[rt * 16 .., :] . Bm[:, col0 + ct * 16 ..] over kdim, for
// the two row tiles of a block's 32 rows. A is row-major in shared memory.
// Bm is in global memory: row-major [kdim, ldb] when !B_T, or given as its
// transpose, row-major [columns, ldb], when B_T.
template <int CT, bool B_T>
__device__ __forceinline__ void warp_product(FragC (&acc)[2][CT], const bf16* A,
                                             int lda, const bf16* Bm, int ldb,
                                             int col0, int kdim) {
  for (int k0 = 0; k0 < kdim; k0 += 16) {
    FragA a0, a1;
    wmma::load_matrix_sync(a0, A + k0, lda);
    wmma::load_matrix_sync(a1, A + 16 * lda + k0, lda);
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      if constexpr (B_T) {
        FragBt b;
        wmma::load_matrix_sync(b, Bm + (size_t)(col0 + ct * 16) * ldb + k0,
                               ldb);
        wmma::mma_sync(acc[0][ct], a0, b, acc[0][ct]);
        wmma::mma_sync(acc[1][ct], a1, b, acc[1][ct]);
      } else {
        FragB b;
        wmma::load_matrix_sync(b, Bm + (size_t)k0 * ldb + col0 + ct * 16, ldb);
        wmma::mma_sync(acc[0][ct], a0, b, acc[0][ct]);
        wmma::mma_sync(acc[1][ct], a1, b, acc[1][ct]);
      }
    }
  }
}

template <int CT>
__device__ __forceinline__ void zero(FragC (&acc)[2][CT]) {
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) wmma::fill_fragment(acc[rt][ct], 0.f);
}

// keep'[0..7] for the 8 consecutive elements from flat index idx (a multiple
// of 4); all 1 when threshold is 0 (no dropout).
__device__ __forceinline__ void keep8(uint32_t seed, uint64_t idx,
                                      uint32_t threshold, float scale,
                                      float* keep) {
  if (threshold == 0u) {
#pragma unroll
    for (int j = 0; j < 8; ++j) keep[j] = 1.f;
    return;
  }
  philox::keep4(seed, idx, threshold, scale, keep);
  philox::keep4(seed, idx + 4, threshold, scale, keep + 4);
}

__device__ __forceinline__ void store8(bf16* dst, const float* v) {
  __align__(16) bf16 o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16_rn(v[j]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
}

__device__ __forceinline__ void load8(const bf16* src, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const bf16* p = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(p[j]);
}

// rows [row0, row0 + R) of src [.., K] -> dst [R][K + PAD], 16 bytes a copy.
__device__ __forceinline__ void load_rows(const bf16* src, bf16* dst, int row0,
                                          int K) {
  const int per_row = K / 8;
  for (int c = threadIdx.x; c < R * per_row; c += THREADS) {
    const int r = c / per_row, k8 = c - r * per_row;
    *reinterpret_cast<uint4*>(dst + r * (K + PAD) + k8 * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * K + k8 * 8);
  }
}

// Shared memory: xs [R][K + PAD] bf16 | hs [R][M + PAD] bf16 |
// stage [WARPS][256] f32.
__global__ void __launch_bounds__(THREADS)
ffn_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
               const bf16* __restrict__ w1, const float* __restrict__ b1,
               const bf16* __restrict__ w2, const float* __restrict__ b2,
               const int* __restrict__ seeds, bf16* __restrict__ out, int K,
               int M, uint32_t thr1, float sc1, uint32_t thr2, float sc2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldx = K + PAD, ldh = M + PAD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* hs = xs + R * ldx;
  float* stage = reinterpret_cast<float*>(hs + R * ldh) + warp * 256;
  const int row0 = blockIdx.x * R;
  const uint32_t seed1 = (uint32_t)seeds[0], seed2 = (uint32_t)seeds[1];
  const int r = lane >> 1, c8 = (lane & 1) * 8;

  load_rows(x, xs, row0, K);
  __syncthreads();

  // hidden = swish(x . w1 + b1) * keep1', rounded to bf16
  for (int ct0 = warp * 4; ct0 < M / 16; ct0 += WARPS * 4) {
    FragC acc[2][4];
    zero(acc);
    warp_product<4, false>(acc, xs, ldx, w1, M, ct0 * 16, K);
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
      for (int ct = 0; ct < 4; ++ct) {
        wmma::store_matrix_sync(stage, acc[rt][ct], 16, wmma::mem_row_major);
        __syncwarp();
        const int lr = rt * 16 + r, gc = (ct0 + ct) * 16 + c8;
        float keep[8], a[8];
        keep8(seed1, (uint64_t)(row0 + lr) * M + gc, thr1, sc1, keep);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float h = stage[r * 16 + c8 + j] + b1[gc + j];
          const float sig = 1.f / (1.f + expf(-h));
          a[j] = __fmul_rn(__fmul_rn(h, sig), keep[j]);
        }
        store8(hs + lr * ldh + gc, a);
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // out = res + (hidden . w2 + b2) * keep2'
  for (int ct0 = warp * 2; ct0 < K / 16; ct0 += WARPS * 2) {
    FragC acc[2][2];
    zero(acc);
    warp_product<2, false>(acc, hs, ldh, w2, K, ct0 * 16, M);
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
      for (int ct = 0; ct < 2; ++ct) {
        wmma::store_matrix_sync(stage, acc[rt][ct], 16, wmma::mem_row_major);
        __syncwarp();
        const int gr = row0 + rt * 16 + r, gc = (ct0 + ct) * 16 + c8;
        float keep[8], rv[8], o[8];
        keep8(seed2, (uint64_t)gr * K + gc, thr2, sc2, keep);
        load8(res + (size_t)gr * K + gc, rv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float y = stage[r * 16 + c8 + j] + b2[gc + j];
          o[j] = __fadd_rn(rv[j], __fmul_rn(y, keep[j]));
        }
        store8(out + (size_t)gr * K + gc, o);
        __syncwarp();
      }
    }
  }
}

// Backward, step 1. Shared memory: xs [R][K + PAD] | gs [R][K + PAD] |
// dhs [R][M + PAD] (bf16) | stage [WARPS][2][256] f32.
__global__ void __launch_bounds__(THREADS)
ffn_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                    const bf16* __restrict__ w1, const float* __restrict__ b1,
                    const bf16* __restrict__ w2, const int* __restrict__ seeds,
                    bf16* __restrict__ dx, bf16* __restrict__ d_g,
                    bf16* __restrict__ dh_g, bf16* __restrict__ g_g,
                    float* __restrict__ db1_part, float* __restrict__ db2_part,
                    int K, int M, uint32_t thr1, float sc1, uint32_t thr2,
                    float sc2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldx = K + PAD, ldh = M + PAD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = xs + R * ldx;
  bf16* dhs = gs + R * ldx;
  float* stage_h = reinterpret_cast<float*>(dhs + R * ldh) + warp * 512;
  float* stage_d = stage_h + 256;
  const int row0 = blockIdx.x * R;
  const uint32_t seed1 = (uint32_t)seeds[0], seed2 = (uint32_t)seeds[1];
  const int r = lane >> 1, c8 = (lane & 1) * 8;

  load_rows(x, xs, row0, K);
  // g = dy * keep2': a thread owns a column, so its sum over the rows (this
  // block's share of db2) has a fixed order
  for (int c = threadIdx.x; c < K; c += THREADS) {
    float sum = 0.f;
    for (int lr = 0; lr < R; ++lr) {
      const size_t at = (size_t)(row0 + lr) * K + c;
      float g = __bfloat162float(dy[at]);
      if (thr2 != 0u)
        g = __fmul_rn(g, philox::bits(seed2, (uint64_t)at) >= thr2 ? sc2 : 0.f);
      sum += g;
      const bf16 gb = __float2bfloat16_rn(g);
      gs[lr * ldx + c] = gb;
      g_g[at] = gb;
    }
    db2_part[(size_t)blockIdx.x * K + c] = sum;
  }
  __syncthreads();

  // h = x . w1 + b1 and dd = g . w2^T, tile by tile in one pass
  for (int ct0 = warp * 2; ct0 < M / 16; ct0 += WARPS * 2) {
    FragC acc_h[2][2], acc_d[2][2];
    zero(acc_h);
    zero(acc_d);
    warp_product<2, false>(acc_h, xs, ldx, w1, M, ct0 * 16, K);
    warp_product<2, true>(acc_d, gs, ldx, w2, K, ct0 * 16, K);
#pragma unroll
    for (int ct = 0; ct < 2; ++ct) {
      const int gc = (ct0 + ct) * 16 + c8;
      float colsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
        wmma::store_matrix_sync(stage_h, acc_h[rt][ct], 16,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(stage_d, acc_d[rt][ct], 16,
                                wmma::mem_row_major);
        __syncwarp();
        const int lr = rt * 16 + r;
        const size_t at = (size_t)(row0 + lr) * M + gc;
        float keep[8], d[8], dh[8];
        keep8(seed1, (uint64_t)at, thr1, sc1, keep);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float h = stage_h[r * 16 + c8 + j] + b1[gc + j];
          const float sig = 1.f / (1.f + expf(-h));
          const float hs = __fmul_rn(h, sig);
          d[j] = __fmul_rn(hs, keep[j]);
          const float da = __fmul_rn(stage_d[r * 16 + c8 + j], keep[j]);
          dh[j] = da * (sig + hs * (1.f - sig));
          colsum[j] += dh[j];
        }
        store8(d_g + at, d);
        store8(dh_g + at, dh);
        store8(dhs + lr * ldh + gc, dh);
        __syncwarp();
      }
      // this block's share of db1: the 16 rows a lane pair covers, summed
      // across the warp in a fixed order
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = colsum[j];
#pragma unroll
        for (int o = 2; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane < 2) db1_part[(size_t)blockIdx.x * M + gc + j] = v;
      }
    }
  }
  __syncthreads();

  // dx = dh . w1^T
  for (int ct0 = warp * 2; ct0 < K / 16; ct0 += WARPS * 2) {
    FragC acc[2][2];
    zero(acc);
    warp_product<2, true>(acc, dhs, ldh, w1, M, ct0 * 16, M);
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
      for (int ct = 0; ct < 2; ++ct) {
        wmma::store_matrix_sync(stage_h, acc[rt][ct], 16, wmma::mem_row_major);
        __syncwarp();
        const int gr = row0 + rt * 16 + r, gc = (ct0 + ct) * 16 + c8;
        store8(dx + (size_t)gr * K + gc, stage_h + r * 16 + c8);
        __syncwarp();
      }
    }
  }
}

// k1 [n, m] and k2 [n, k]: 1 where the kernels keep an element, else 0.
__global__ void ffn_masks_kernel(const int* __restrict__ seeds,
                                 float* __restrict__ k1, float* __restrict__ k2,
                                 long long n1, long long n2, uint32_t thr1,
                                 uint32_t thr2) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = tid; i < n1 + n2; i += stride) {
    const bool first = i < n1;
    const long long idx = first ? i : i - n1;
    const uint32_t word =
        philox::bits((uint32_t)seeds[first ? 0 : 1], (uint64_t)idx);
    (first ? k1 : k2)[idx] = word >= (first ? thr1 : thr2) ? 1.f : 0.f;
  }
}

// ---------------------------------------------------------------------------
// The general kernels: compute type T = float or bf16, any widths. The same
// three backward steps and the same rounding points as above; the products
// are f32 FMAs. A block owns GR rows, which it holds widened to f32 in shared
// memory; a thread owns a column of the result for all GR rows, so that every
// weight it reads (coalesced across the block) is used GR times. The
// backward reads w2 and w1 through transposed copies (made by
// ffn_transpose_kernel into scratch) so that those reads coalesce as well.
// ---------------------------------------------------------------------------

constexpr int GR = 8;

using wgrad::narrow;
using wgrad::widen;

// keep' of the element at flat index idx.
__device__ __forceinline__ float keep1(uint32_t seed, uint64_t idx,
                                       uint32_t threshold, float scale) {
  if (threshold == 0u) return 1.f;
  return philox::bits(seed, idx) >= threshold ? scale : 0.f;
}

// dst [cols, rows] = src [rows, cols] transposed.
template <typename T>
__global__ void ffn_transpose_kernel(const T* __restrict__ src,
                                     T* __restrict__ dst, int rows, int cols) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * cols) return;
  const int c = i / rows, r = i - c * rows;
  dst[i] = src[(size_t)r * cols + c];
}

// Shared memory: xs [GR][K] | hs [GR][M], f32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ffn_fwd_general_kernel(const T* __restrict__ x, const T* __restrict__ res,
                       const T* __restrict__ w1, const float* __restrict__ b1,
                       const T* __restrict__ w2, const float* __restrict__ b2,
                       const int* __restrict__ seeds, T* __restrict__ out,
                       int K, int M, uint32_t thr1, float sc1, uint32_t thr2,
                       float sc2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* hs = xs + GR * K;
  const int row0 = blockIdx.x * GR;
  const uint32_t seed1 = (uint32_t)seeds[0], seed2 = (uint32_t)seeds[1];

  for (int e = threadIdx.x; e < GR * K; e += THREADS)
    xs[e] = widen(x[(size_t)row0 * K + e]);
  __syncthreads();

  // hidden = swish(x . w1 + b1) * keep1', rounded to T
  for (int c = threadIdx.x; c < M; c += THREADS) {
    float acc[GR];
#pragma unroll
    for (int r = 0; r < GR; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = widen(w1[(size_t)k * M + c]);
#pragma unroll
      for (int r = 0; r < GR; ++r) acc[r] = fmaf(xs[r * K + k], w, acc[r]);
    }
    const float bias = b1[c];
#pragma unroll
    for (int r = 0; r < GR; ++r) {
      const float h = acc[r] + bias;
      const float sig = 1.f / (1.f + expf(-h));
      const float keep =
          keep1(seed1, (uint64_t)(row0 + r) * M + c, thr1, sc1);
      hs[r * M + c] = widen(narrow<T>(__fmul_rn(__fmul_rn(h, sig), keep)));
    }
  }
  __syncthreads();

  // out = res + (hidden . w2 + b2) * keep2'
  for (int c = threadIdx.x; c < K; c += THREADS) {
    float acc[GR];
#pragma unroll
    for (int r = 0; r < GR; ++r) acc[r] = 0.f;
    for (int m = 0; m < M; ++m) {
      const float w = widen(w2[(size_t)m * K + c]);
#pragma unroll
      for (int r = 0; r < GR; ++r) acc[r] = fmaf(hs[r * M + m], w, acc[r]);
    }
    const float bias = b2[c];
#pragma unroll
    for (int r = 0; r < GR; ++r) {
      const size_t at = (size_t)(row0 + r) * K + c;
      const float y = acc[r] + bias;
      const float keep = keep1(seed2, (uint64_t)at, thr2, sc2);
      out[at] = narrow<T>(__fadd_rn(widen(res[at]), __fmul_rn(y, keep)));
    }
  }
}

// Backward, step 1. Shared memory: xs [GR][K] | gs [GR][K] | dhs [GR][M],
// f32 (gs and dhs hold values already rounded to T). w2t [K, M] and
// w1t [M, K] are the transposes of w2 and w1.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ffn_bwd_rows_general_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            const T* __restrict__ w1,
                            const float* __restrict__ b1,
                            const T* __restrict__ w2t,
                            const T* __restrict__ w1t,
                            const int* __restrict__ seeds, T* __restrict__ dx,
                            T* __restrict__ d_g, T* __restrict__ dh_g,
                            T* __restrict__ g_g, float* __restrict__ db1_part,
                            float* __restrict__ db2_part, int K, int M,
                            uint32_t thr1, float sc1, uint32_t thr2,
                            float sc2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* gs = xs + GR * K;
  float* dhs = gs + GR * K;
  const int row0 = blockIdx.x * GR;
  const uint32_t seed1 = (uint32_t)seeds[0], seed2 = (uint32_t)seeds[1];

  for (int e = threadIdx.x; e < GR * K; e += THREADS)
    xs[e] = widen(x[(size_t)row0 * K + e]);
  // g = dy * keep2'; a thread owns a column, so its sum over the rows (this
  // block's share of db2) has a fixed order
  for (int c = threadIdx.x; c < K; c += THREADS) {
    float sum = 0.f;
    for (int r = 0; r < GR; ++r) {
      const size_t at = (size_t)(row0 + r) * K + c;
      const float g =
          __fmul_rn(widen(dy[at]), keep1(seed2, (uint64_t)at, thr2, sc2));
      sum += g;
      const T gt = narrow<T>(g);
      gs[r * K + c] = widen(gt);
      g_g[at] = gt;
    }
    db2_part[(size_t)blockIdx.x * K + c] = sum;
  }
  __syncthreads();

  // h = x . w1 + b1 and dd = g . w2^T in one pass over the weights
  for (int c = threadIdx.x; c < M; c += THREADS) {
    float acc_h[GR], acc_d[GR];
#pragma unroll
    for (int r = 0; r < GR; ++r) acc_h[r] = acc_d[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float wa = widen(w1[(size_t)k * M + c]);
      const float wb = widen(w2t[(size_t)k * M + c]);
#pragma unroll
      for (int r = 0; r < GR; ++r) {
        acc_h[r] = fmaf(xs[r * K + k], wa, acc_h[r]);
        acc_d[r] = fmaf(gs[r * K + k], wb, acc_d[r]);
      }
    }
    const float bias = b1[c];
    float colsum = 0.f;
#pragma unroll
    for (int r = 0; r < GR; ++r) {
      const size_t at = (size_t)(row0 + r) * M + c;
      const float keep = keep1(seed1, (uint64_t)at, thr1, sc1);
      const float h = acc_h[r] + bias;
      const float sig = 1.f / (1.f + expf(-h));
      const float hsw = __fmul_rn(h, sig);
      const float da = __fmul_rn(acc_d[r], keep);
      const float dh = da * (sig + hsw * (1.f - sig));
      colsum += dh;
      const T dht = narrow<T>(dh);
      d_g[at] = narrow<T>(__fmul_rn(hsw, keep));
      dh_g[at] = dht;
      dhs[r * M + c] = widen(dht);
    }
    db1_part[(size_t)blockIdx.x * M + c] = colsum;
  }
  __syncthreads();

  // dx = dh . w1^T
  for (int c = threadIdx.x; c < K; c += THREADS) {
    float acc[GR];
#pragma unroll
    for (int r = 0; r < GR; ++r) acc[r] = 0.f;
    for (int m = 0; m < M; ++m) {
      const float w = widen(w1t[(size_t)m * K + c]);
#pragma unroll
      for (int r = 0; r < GR; ++r) acc[r] = fmaf(dhs[r * M + m], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < GR; ++r)
      dx[(size_t)(row0 + r) * K + c] = narrow<T>(acc[r]);
  }
}

size_t fwd_smem(int K, int M) {
  return (size_t)R * (K + PAD) * 2 + (size_t)R * (M + PAD) * 2 +
         (size_t)WARPS * 256 * 4;
}

size_t bwd_smem(int K, int M) {
  return 2 * (size_t)R * (K + PAD) * 2 + (size_t)R * (M + PAD) * 2 +
         (size_t)WARPS * 512 * 4;
}

size_t fwd_general_smem(int K, int M) { return (size_t)GR * (K + M) * 4; }

size_t bwd_general_smem(int K, int M) { return (size_t)GR * (2 * K + M) * 4; }

constexpr size_t SMEM_LIMIT = 227 * 1024;

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool shape_ok(int N, int K, int M) {
  return N > 0 && N % R == 0 && K > 0 && M > 0;
}

// bf16 at widths that are multiples of 128 takes the tensor-core kernels.
bool tensor_cores(int dtype, int K, int M) {
  return dtype == 1 && K % 128 == 0 && M % 128 == 0 &&
         bwd_smem(K, M) <= SMEM_LIMIT;
}

template <typename T>
cudaError_t fwd_general(const void* x, const void* res, const void* w1,
                        const void* b1, const void* w2, const void* b2,
                        const void* seeds, void* out, int N, int K, int M,
                        uint32_t thr1, float sc1, uint32_t thr2, float sc2,
                        cudaStream_t s) {
  const size_t smem = fwd_general_smem(K, M);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(ffn_fwd_general_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  ffn_fwd_general_kernel<T><<<N / GR, THREADS, smem, s>>>(
      (const T*)x, (const T*)res, (const T*)w1, (const float*)b1,
      (const T*)w2, (const float*)b2, (const int*)seeds, (T*)out, K, M, thr1,
      sc1, thr2, sc2);
  return cudaGetLastError();
}

// Step 1 of the backward on the general kernels; wt is scratch for the two
// transposed weights, 2 * K * M elements.
template <typename T>
cudaError_t bwd_general(const void* x, const void* dy, const void* w1,
                        const void* b1, const void* w2, const void* seeds,
                        void* dx, void* d_g, void* dh_g, void* g_g, void* wt,
                        float* db1_part, float* db2_part, int N, int K, int M,
                        uint32_t thr1, float sc1, uint32_t thr2, float sc2,
                        cudaStream_t s) {
  const size_t smem = bwd_general_smem(K, M);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(ffn_bwd_rows_general_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  T* w2t = (T*)wt;           // [K, M]
  T* w1t = w2t + (size_t)K * M;  // [M, K]
  const int cells = K * M, tblocks = (cells + 255) / 256;
  ffn_transpose_kernel<T><<<tblocks, 256, 0, s>>>((const T*)w2, w2t, M, K);
  ffn_transpose_kernel<T><<<tblocks, 256, 0, s>>>((const T*)w1, w1t, K, M);
  ffn_bwd_rows_general_kernel<T><<<N / GR, THREADS, smem, s>>>(
      (const T*)x, (const T*)dy, (const T*)w1, (const float*)b1, w2t, w1t,
      (const int*)seeds, (T*)dx, (T*)d_g, (T*)dh_g, (T*)g_g, db1_part,
      db2_part, K, M, thr1, sc1, thr2, sc2);
  return cudaGetLastError();
}

// Step 2 of the backward: dw2 [M, K] = d^T . g and dw1 [K, M] = x^T . dh as
// the partials of S row splits (wgrad.cuh).
template <typename T>
cudaError_t bwd_weights(const void* x, const void* d_g, const void* dh_g,
                        const void* g_g, float* dw1_part, float* dw2_part,
                        int N, int K, int M, int S, cudaStream_t s) {
  const cudaError_t e = wgrad::product<T>((const T*)d_g, (const T*)g_g,
                                          dw2_part, N, M, K, S, s);
  if (e != cudaSuccess) return e;
  return wgrad::product<T>((const T*)x, (const T*)dh_g, dw1_part, N, K, M, S,
                           s);
}

}  // namespace

extern "C" {

// out [N, K] = res + drop2(drop1(swish(x . w1 + b1)) . w2 + b2). dtype 0 =
// f32, 1 = bf16 (x, res, w1, w2, out). N must be a multiple of 32. seeds
// points at two int32 on the device; thr = uint32(rate * 2^32) (0: no
// dropout), sc = 1 / (1 - rate).
int ishara_ffn_fwd(int device, int dtype, const void* x, const void* res,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* seeds, void* out, int N, int K,
                   int M, unsigned int thr1, float sc1, unsigned int thr2,
                   float sc2, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!shape_ok(N, K, M) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tensor_cores(dtype, K, M)) {
    if (dtype == 0)
      return (int)fwd_general<float>(x, res, w1, b1, w2, b2, seeds, out, N, K,
                                     M, thr1, sc1, thr2, sc2, s);
    return (int)fwd_general<bf16>(x, res, w1, b1, w2, b2, seeds, out, N, K, M,
                                  thr1, sc1, thr2, sc2, s);
  }
  const size_t smem = fwd_smem(K, M);
  e = allow_smem(ffn_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  ffn_fwd_kernel<<<N / R, THREADS, smem, s>>>(
      (const bf16*)x, (const bf16*)res, (const bf16*)w1, (const float*)b1,
      (const bf16*)w2, (const float*)b2, (const int*)seeds, (bf16*)out, K, M,
      thr1, sc1, thr2, sc2);
  return (int)cudaGetLastError();
}

// Rows a block of the backward's step 1 owns at this type and these widths:
// the number of rows of db1_part and db2_part is N over this.
int ishara_ffn_bwd_rows(int dtype, int K, int M) {
  return tensor_cores(dtype, K, M) ? R : GR;
}

// dx [N, K] and dw1 [K, M], db1 [M], dw2 [M, K], db2 [K] f32 from x, dy and
// the forward's weights and seeds. Scratch, all given by the caller: d_g,
// dh_g [N, M], g_g [N, K] and wt [2, K * M] in the compute type; db1_part
// [N / rows, M] and db2_part [N / rows, K] f32, rows = ishara_ffn_bwd_rows;
// dw1_part and dw2_part [S, K * M] f32, S the number of row splits of the
// weight products.
int ishara_ffn_bwd(int device, int dtype, const void* x, const void* dy,
                   const void* w1, const void* b1, const void* w2,
                   const void* seeds, void* dx, void* d_g, void* dh_g,
                   void* g_g, void* wt, void* db1_part, void* db2_part,
                   void* dw1_part, void* dw2_part, void* dw1, void* db1,
                   void* dw2, void* db2, int N, int K, int M, int S,
                   unsigned int thr1, float sc1, unsigned int thr2, float sc2,
                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!shape_ok(N, K, M) || S < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = ishara_ffn_bwd_rows(dtype, K, M);
  if (rows == GR) {
    if (dtype == 0)
      e = bwd_general<float>(x, dy, w1, b1, w2, seeds, dx, d_g, dh_g, g_g, wt,
                             (float*)db1_part, (float*)db2_part, N, K, M, thr1,
                             sc1, thr2, sc2, s);
    else
      e = bwd_general<bf16>(x, dy, w1, b1, w2, seeds, dx, d_g, dh_g, g_g, wt,
                            (float*)db1_part, (float*)db2_part, N, K, M, thr1,
                            sc1, thr2, sc2, s);
  } else {
    const size_t smem = bwd_smem(K, M);
    e = allow_smem(ffn_bwd_rows_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    ffn_bwd_rows_kernel<<<N / R, THREADS, smem, s>>>(
        (const bf16*)x, (const bf16*)dy, (const bf16*)w1, (const float*)b1,
        (const bf16*)w2, (const int*)seeds, (bf16*)dx, (bf16*)d_g,
        (bf16*)dh_g, (bf16*)g_g, (float*)db1_part, (float*)db2_part, K, M,
        thr1, sc1, thr2, sc2);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return (int)e;
  e = dtype == 0 ? bwd_weights<float>(x, d_g, dh_g, g_g, (float*)dw1_part,
                                      (float*)dw2_part, N, K, M, S, s)
                 : bwd_weights<bf16>(x, d_g, dh_g, g_g, (float*)dw1_part,
                                     (float*)dw2_part, N, K, M, S, s);
  if (e != cudaSuccess) return (int)e;
  const long long KM = (long long)K * M;
  e = wgrad::sum_parts((const float*)dw1_part, (float*)dw1, S, KM, s);
  if (e != cudaSuccess) return (int)e;
  e = wgrad::sum_parts((const float*)dw2_part, (float*)dw2, S, KM, s);
  if (e != cudaSuccess) return (int)e;
  e = wgrad::sum_parts((const float*)db1_part, (float*)db1, N / rows, M, s);
  if (e != cudaSuccess) return (int)e;
  return (int)wgrad::sum_parts((const float*)db2_part, (float*)db2, N / rows,
                               K, s);
}

// The keep masks the kernels draw for an [n, k] input with hidden width m:
// k1 [n, m] under seeds[0], k2 [n, k] under seeds[1], as 1.0 / 0.0.
int ishara_ffn_masks(int device, const void* seeds, void* k1, void* k2, int n,
                     int m, int k, unsigned int thr1, unsigned int thr2,
                     void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long n1 = (long long)n * m, n2 = (long long)n * k;
  if (n1 + n2 <= 0) return n1 + n2 == 0 ? 0 : (int)cudaErrorInvalidValue;
  const long long want = (n1 + n2 + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  ffn_masks_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      (const int*)seeds, (float*)k1, (float*)k2, n1, n2, thr1, thr2);
  return (int)cudaGetLastError();
}

const char* ishara_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
