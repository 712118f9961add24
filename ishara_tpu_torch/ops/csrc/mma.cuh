// Tensor-core building blocks shared by the training kernels (attention_tc.cuh,
// conv_module.cu, ffn.cu, wgrad.cuh) on Hopper (sm_90a): the PTX wrappers for
// cp.async, ldmatrix and mma.sync, 3xTF32 for f32 operands, a tile loader
// from global to shared memory, and one warp-level product over tiles that
// sit in shared memory.
//
// Accumulator layout (mma.sync m16n8, either type): acc[i][j][0..3] of a
// warp hold rows i * 16 + g (elements 0, 1) and i * 16 + g + 8 (2, 3),
// columns j * 8 + 2t (0, 2) and j * 8 + 2t + 1 (1, 3), with g = lane / 4 and
// t = lane % 4.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tc {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void cp_async_wait1() { cp_async_wait<1>(); }
__device__ __forceinline__ void cp_async_wait0() { cp_async_wait<0>(); }

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The products touch registers only: not volatile, so the compiler may
// interleave them with the next step's ldmatrix loads.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = big + small, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}
// An f32 A fragment as TF32 big and small parts.
struct SplitA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ SplitA() {}
  __device__ __forceinline__ explicit SplitA(const float a[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], big[i], small[i]);
  }
};
// c += a . b in 3xTF32 (small products first), b already split
__device__ __forceinline__ void mma_3xtf32(float c[4], const SplitA& a,
                                           const uint32_t bb[2],
                                           const uint32_t bs[2]) {
  mma_tf32(c, a.big, bs[0], bs[1]);
  mma_tf32(c, a.small, bb[0], bb[1]);
  mma_tf32(c, a.big, bb[0], bb[1]);
}
__device__ __forceinline__ void mma_3xtf32(float c[4], const SplitA& a,
                                           float b0, float b1) {
  uint32_t bb[2], bs[2];
  split(b0, bb[0], bs[0]);
  split(b1, bb[1], bs[1]);
  mma_3xtf32(c, a, bb, bs);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// Tile loads: rows x cols of src (row stride ld_g elements) into dst (row
// stride ld_s), zero at rows >= rows_ok and columns >= cols_ok. With vec
// (16-byte aligned rows, cols and cols_ok multiples of 16 bytes) by
// cp.async in 16-byte copies -- the caller commits and waits -- otherwise by
// plain loads, done when the caller next synchronises.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld_s, const T* src,
                                          long long ld_g, int rows, int cols,
                                          int rows_ok, int cols_ok, bool vec,
                                          int tid, int nthreads) {
  constexpr int EPC = 16 / (int)sizeof(T);
  if (vec) {
    const int cpr = cols / EPC;
    for (int e = tid; e < rows * cpr; e += nthreads) {
      const int r = e / cpr, c = (e - r * cpr) * EPC;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async16(smem_u32(dst + r * ld_s + c),
                 ok ? src + r * ld_g + c : src, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < rows * cols; e += nthreads) {
      const int r = e / cols, c = e - r * cols;
      dst[r * ld_s + c] =
          r < rows_ok && c < cols_ok ? src[r * ld_g + c] : from_f<T>(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// Warp product over shared memory:
//   acc[i][j] += A[m-tile i] . B[:, n-tile j]   over k in [0, kdim)
// A: row-major [m][k] (stride lda) with m-tile i at rows i * mstride, or,
// with A_KM (bf16 only), stored transposed as [k][m] with m-tile i at
// columns i * 16. B: [k][n] (B_KN, stride ldb) or [n][k]; n-tile j at
// columns (or rows) j * 8. Only m-tiles i < mcount and n-tiles j < ncount
// take part (warp-uniform); kdim is a multiple of 16 (bf16) or 8 (f32).
// ---------------------------------------------------------------------------

template <int MT, int NT, bool A_KM, bool B_KN>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const bf16* A, int lda, int mstride,
                                         const bf16* B, int ldb, int kdim,
                                         int mcount = MT, int ncount = NT) {
  static_assert(NT % 2 == 0, "n-tiles go in pairs");
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
#pragma unroll 2
  for (int k0 = 0; k0 < kdim; k0 += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= mcount) break;
      if constexpr (A_KM)
        ldsm_x4_t(a[i], smem_u32(A + (k0 + (mi >> 1) * 8 + r) * lda +
                                 i * 16 + (mi & 1) * 8));
      else
        ldsm_x4(a[i], smem_u32(A + (i * mstride + (lane & 15)) * lda + k0 +
                               (lane >> 4) * 8));
    }
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j >= ncount) break;
      uint32_t b[4];
      if constexpr (B_KN)
        ldsm_x4_t(b, smem_u32(B + (k0 + (mi & 1) * 8 + r) * ldb + j * 8 +
                              (mi >> 1) * 8));
      else
        ldsm_x4(b, smem_u32(B + (j * 8 + (mi >> 1) * 8 + r) * ldb + k0 +
                            (mi & 1) * 8));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= mcount) break;
        mma_bf16(acc[i][j], a[i], b[0], b[1]);
        mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// The same in f32 operands, 3xTF32 m16n8k8 (about f32 accuracy).
template <int MT, int NT, bool A_KM, bool B_KN>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const float* A, int lda, int mstride,
                                         const float* B, int ldb, int kdim,
                                         int mcount = MT, int ncount = NT) {
  static_assert(!A_KM, "f32 A is row-major");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < kdim; k0 += 8) {
    SplitA a[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= mcount) break;
      const float* ai = A + (i * mstride + g) * lda + k0 + t;
      const float af[4] = {ai[0], ai[8 * lda], ai[4], ai[8 * lda + 4]};
      a[i] = SplitA(af);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= ncount) break;
      float b0, b1;
      if constexpr (B_KN) {
        b0 = B[(k0 + t) * ldb + j * 8 + g];
        b1 = B[(k0 + t + 4) * ldb + j * 8 + g];
      } else {
        b0 = B[(j * 8 + g) * ldb + k0 + t];
        b1 = B[(j * 8 + g) * ldb + k0 + t + 4];
      }
      uint32_t bb[2], bs[2];
      split(b0, bb[0], bs[0]);
      split(b1, bb[1], bs[1]);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= mcount) break;
        mma_3xtf32(acc[i][j], a[i], bb, bs);
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

}  // namespace tc
