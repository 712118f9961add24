// Inverted dropout, and res + dropout(x), in one pass on Hopper (sm_90a).
//
// Replaces the Pallas kernels of ishara_tpu/ops/dropout.py (_kernel behind
// tpu_dropout, _add_kernel behind tpu_dropout_add). The keep mask is never
// stored: it is the Philox function of (seed, flat index) in philox.cuh, so
// the backward pass is this same kernel on dy (dx = mask * dy / (1 - rate),
// dres = dy). Arithmetic as the reference: widen to f32, multiply by the mask
// and 1 / (1 - rate), add res in f32, round once to the tensor's type.
//
// A tensor-parallel rank holds a strided slice of the global tensor (its
// heads of [B, H, T, T], its hidden columns of [B, T, 4 dim]): with RUNS,
// value i is element offset + (i / width) * stride + i % width of the
// global tensor, so its mask is the unsharded launch's there.
//
// Bound: bytes. Each element is read once (twice with res) and written once;
// one Philox block (about 70 integer operations) serves four elements, far
// below what the memory system allows per byte. Each thread moves 16 bytes an
// access (4 f32 or 8 bf16 values); a ragged or unaligned tail goes one value
// at a time.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// V values of type T travel in 16 bytes.
template <typename T>
struct Pack {
  static constexpr int V = 16 / sizeof(T);
};

// The global flat index of local value i.
template <bool RUNS>
__device__ __forceinline__ uint64_t global_index(unsigned long long offset,
                                                 long long i, long long width,
                                                 long long stride) {
  if (!RUNS) return offset + (uint64_t)i;
  return offset + (uint64_t)((i / width) * stride + i % width);
}

template <typename T, bool ADD, bool RUNS>
__global__ void dropout_kernel(const T* __restrict__ x,
                               const T* __restrict__ res, T* __restrict__ out,
                               long long n, unsigned long long offset,
                               long long width, long long stride,
                               const int* __restrict__ seed_ptr,
                               uint32_t threshold, float scale, int aligned) {
  constexpr int V = Pack<T>::V;
  const uint32_t seed = (uint32_t)seed_ptr[0];
  const long long packs = aligned ? n / V : 0;
  const long long grid = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long p = tid; p < packs; p += grid) {
    const uint4 xr = reinterpret_cast<const uint4*>(x)[p];
    uint4 rr = xr;
    if (ADD) rr = reinterpret_cast<const uint4*>(res)[p];
    const T* xv = reinterpret_cast<const T*>(&xr);
    const T* rv = reinterpret_cast<const T*>(&rr);
    __align__(16) T ov[V];
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      float keep[4];
      // a run holds whole groups of four (the host checks width % 4)
      philox::keep4(seed, global_index<RUNS>(offset, p * V + q, width, stride),
                    threshold, scale, keep);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // separate multiply and add, each rounded: no fused multiply-add
        float y = __fmul_rn(to_f(xv[q + j]), keep[j]);
        if (ADD) y = __fadd_rn(y, to_f(rv[q + j]));
        from_f(y, &ov[q + j]);
      }
    }
    reinterpret_cast<uint4*>(out)[p] = *reinterpret_cast<const uint4*>(ov);
  }
  for (long long i = packs * V + tid; i < n; i += grid) {
    const float keep = philox::bits(seed, global_index<RUNS>(offset, i, width,
                                                             stride)) >=
                               threshold
                           ? scale
                           : 0.f;
    float y = __fmul_rn(to_f(x[i]), keep);
    if (ADD) y = __fadd_rn(y, to_f(res[i]));
    from_f(y, &out[i]);
  }
}

template <typename T, bool RUNS>
cudaError_t launch_as(const void* x, const void* res, void* out, long long n,
                      unsigned long long offset, long long width,
                      long long stride, const int* seed, uint32_t threshold,
                      float scale, cudaStream_t stream) {
  constexpr int V = Pack<T>::V;
  const uintptr_t bits = (uintptr_t)x | (uintptr_t)out | (uintptr_t)res;
  const int aligned = (bits % 16) == 0 && (!RUNS || width % 4 == 0);
  const int threads = 256;
  long long want = (n / V + threads - 1) / threads + 1;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  if (res != nullptr) {
    dropout_kernel<T, true, RUNS><<<blocks, threads, 0, stream>>>(
        (const T*)x, (const T*)res, (T*)out, n, offset, width, stride, seed,
        threshold, scale, aligned);
  } else {
    dropout_kernel<T, false, RUNS><<<blocks, threads, 0, stream>>>(
        (const T*)x, nullptr, (T*)out, n, offset, width, stride, seed,
        threshold, scale, aligned);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* res, void* out, long long n,
                   unsigned long long offset, long long width,
                   long long stride, const int* seed, uint32_t threshold,
                   float scale, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (width <= 0 || stride < width) return cudaErrorInvalidValue;
  if (width == stride)
    return launch_as<T, false>(x, res, out, n, offset, width, stride, seed,
                               threshold, scale, stream);
  return launch_as<T, true>(x, res, out, n, offset, width, stride, seed,
                            threshold, scale, stream);
}

}  // namespace

extern "C" {

// out = [res +] x * keep(seed, index) / (1 - rate) over n values of dtype
// 0 (f32) or 1 (bf16); res may be null. seed points at one int32 on the
// device; threshold = uint32(rate * 2^32), scale = 1 / (1 - rate). Value i
// takes the mask word of flat index offset + i: a process holding rows
// [r0, r1) of a batch passes r0 times the values a row, and draws what the
// whole batch's launch draws there. With width < stride the values come in
// runs of width, each stride global elements after the one before (a
// tensor-parallel rank's slice); width == stride is the contiguous case.
int ishara_dropout(int device, const void* x, const void* res, void* out,
                   long long n, unsigned long long offset, long long width,
                   long long stride, const int* seed, unsigned int threshold,
                   float scale, int dtype, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, res, out, n, offset, width, stride, seed,
                              threshold, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, res, out, n, offset, width, stride,
                                      seed, threshold, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* ishara_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
