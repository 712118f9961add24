// Tiled multi-head self-attention for long sequences on Hopper (sm_90a),
// forward and backward, no dropout.
//
// Replaces the Pallas kernels _fwd_kernel, _dq_kernel and _dkv_kernel of
// ishara_tpu/ops/attention_blocked.py (behind flash_mhsa_blocked): queries
// tiled over the grid, keys streamed through shared memory with the
// online-softmax recurrence, so nothing of size [T, T] is ever held; the
// forward saves the row logsumexp, and the backward is two passes that
// recompute the probabilities from it -- one tiled over queries for dQ, one
// tiled over keys for dK and dV -- so no sum is shared between blocks and
// no atomics are needed: the gradients are the same from run to run.
//
// Semantics as the reference: q, k, v (bf16 or f32) are widened to f32 and
// everything is f32 from there; s = q.k * scale + bias with a [B, T]
// additive key bias (0 or -1e30). T is padded to Tp (the caller's multiple,
// the reference's lcm of its block sizes), and a padded key has k = v = 0
// and the bias NEG = -1e30. That matters for one case only: a row whose keys
// are all masked has every score at NEG, so every one of the Tp keys gets
// the weight 1 / Tp, padded zeros included, exactly as in the reference.
// Forward per key chunk: m' = max(m, max s); corr = exp(m - m'); p = exp(s -
// m'); acc = acc * corr + p . v; l = l * corr + sum p; finally o = acc / l
// (rounded once to q's type) and lse = m + log l. Backward: p = exp(s - lse),
// dp = dO . v, ds = p * (dp - delta) with delta = rowsum(dO * O) given by
// the caller; dQ = scale * sum ds k, dK = scale * sum ds q, dV = sum p dO.
// Padded queries (q = dO = 0) and padded keys (k = v = 0) add exact zeros
// to the gradients the reference keeps, so the backward skips them.
//
// Design (a first, simple form: f32 FMAs on the CUDA cores). G threads own
// one row (a query in the forward and the dQ pass, a key in the dK/dV pass),
// each 16 of its head dimensions, widened to f32 in registers; G = 2, 4 or 8
// for heads up to 32, 64 or 128 wide, so a block of 256 threads owns
// 256 / G rows. The other side's rows stream through shared memory as f32
// tiles of 256 / G rows (32 KB for the two); a thread's 16 dimensions are
// four float4 that sit G float4 apart, so the G threads of a row read
// neighbouring words and the
// rows of a warp read the same ones (broadcast). A dot product is 16 FMAs
// and a butterfly of log2(G) shuffles, which leaves the whole dot on every
// thread of the row. The forward updates its softmax statistics once a
// chunk of 16 keys.
//
// Bound: at B 256, H 8, T 512, Dh 32 in bf16 the forward moves 272 MB
// (0.081 ms at 3.35 TB/s) for 69 GFLOP (0.069 ms on the tensor cores) and
// the backward 241 GFLOP: on paper the products bind on the tensor cores.
// This version does them as f32 FMAs on the CUDA cores (67 TFLOP/s peak, so
// ~1 ms forward at best), which is what it spends its time on.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 16;    // keys a softmax update of the forward
constexpr float NEG = -1e30f;

struct BParams {
  const void *q, *k, *v, *d_o;  // [B, H, T, Dh], strided over b, h, t
  long long qs[3], ks[3], vs[3], dos[3];
  const float* bias;   // [B, T]
  void* o;             // [B, H, T, Dh] contiguous
  float* lse;          // [B, H, T]
  const float* delta;  // [B, H, T]
  void *dq, *dk, *dv;  // [B, H, T, Dh] contiguous
  int B, H, Tn, Tp, Dh;
  float scale;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// The first of the 4 consecutive head dimensions of chunk c of thread lg of
// a row's G threads.
template <int G>
__device__ __forceinline__ int dim_of(int c, int lg) {
  return (c * G + lg) * 4;
}

// The 16 dimensions a thread owns of row t of src (row stride st), f32,
// zero beyond Dh or where the row is not valid.
template <typename T, int G>
__device__ __forceinline__ void load_row(const T* src, long long st, int t,
                                         bool valid, int Dh, int lg,
                                         float r[16]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int d0 = dim_of<G>(c, lg);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[4 * c + i] = (valid && d0 + i < Dh)
                         ? to_f(src[(long long)t * st + d0 + i])
                         : 0.f;
  }
}

// Rows [r0, r0 + TR) of src (row stride st) into dst [TR][DP] f32, zero
// beyond `valid` rows and beyond Dh.
template <typename T, int DP, int TR>
__device__ __forceinline__ void load_tile(const T* src, long long st, int r0,
                                          int valid, int Dh, float* dst) {
  for (int e = threadIdx.x; e < TR * DP; e += blockDim.x) {
    const int j = e / DP, d = e - j * DP;
    dst[e] = (r0 + j < valid && d < Dh)
                 ? to_f(src[(long long)(r0 + j) * st + d])
                 : 0.f;
  }
}

// Sum over the row's G threads of the thread's share of r . tile[j].
template <int G, int DP>
__device__ __forceinline__ float row_dot(const float r[16], const float* tile,
                                         int j, int lg) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 m = *reinterpret_cast<const float4*>(
        tile + j * DP + dim_of<G>(c, lg));
    acc += r[4 * c] * m.x + r[4 * c + 1] * m.y + r[4 * c + 2] * m.z +
           r[4 * c + 3] * m.w;
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

// acc += w * tile[j] over the thread's dimensions.
template <int G, int DP>
__device__ __forceinline__ void row_axpy(float acc[16], float w,
                                         const float* tile, int j, int lg) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 m = *reinterpret_cast<const float4*>(
        tile + j * DP + dim_of<G>(c, lg));
    acc[4 * c] += w * m.x;
    acc[4 * c + 1] += w * m.y;
    acc[4 * c + 2] += w * m.z;
    acc[4 * c + 3] += w * m.w;
  }
}

template <typename T, int G>
__device__ __forceinline__ void store_row(T* dst, int Dh, int lg,
                                          const float r[16], float mul) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int d0 = dim_of<G>(c, lg);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (d0 + i < Dh) from_f(r[4 * c + i] * mul, dst + d0 + i);
  }
}

// Forward. Grid (query tiles of 256 / G, H, B). Shared memory: k, v
// [TILE][DP] f32 and the tile's key bias [TILE], TILE * DP = 4096.
template <typename T, int G>
__global__ void __launch_bounds__(THREADS, 2)
    blocked_fwd_kernel(const BParams P) {
  constexpr int DP = 16 * G, RB = THREADS / G, TILE = 4096 / DP;
  __shared__ __align__(16) float ks[TILE * DP];
  __shared__ __align__(16) float vs[TILE * DP];
  __shared__ float bs[TILE];
  const int b = blockIdx.z, h = blockIdx.y;
  const int lg = threadIdx.x % G, row = blockIdx.x * RB + threadIdx.x / G;
  const bool valid = row < P.Tn;
  const T* qp = (const T*)P.q + b * P.qs[0] + h * P.qs[1];
  const T* kp = (const T*)P.k + b * P.ks[0] + h * P.ks[1];
  const T* vp = (const T*)P.v + b * P.vs[0] + h * P.vs[1];
  const float* bias = P.bias + (long long)b * P.Tn;
  float q[16], acc[16];
  load_row<T, G>(qp, P.qs[2], row, valid, P.Dh, lg, q);
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  float m = NEG, l = 0.f;
  for (int k0 = 0; k0 < P.Tp; k0 += TILE) {
    __syncthreads();
    load_tile<T, DP, TILE>(kp, P.ks[2], k0, P.Tn, P.Dh, ks);
    load_tile<T, DP, TILE>(vp, P.vs[2], k0, P.Tn, P.Dh, vs);
    for (int j = threadIdx.x; j < TILE; j += blockDim.x)
      bs[j] = k0 + j < P.Tn ? bias[k0 + j] : NEG;  // a padded key: NEG
    __syncthreads();
    const int nk = min(TILE, P.Tp - k0);
    for (int c0 = 0; c0 < nk; c0 += CHUNK) {
      float s[CHUNK];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        float v = -INFINITY;  // beyond Tp: no key at all
        if (c0 + jj < nk)
          v = row_dot<G, DP>(q, ks, c0 + jj, lg) * P.scale + bs[c0 + jj];
        s[jj] = v;
        cmax = fmaxf(cmax, v);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        if (c0 + jj < nk) {
          const float p = expf(s[jj] - m_new);
          l += p;
          row_axpy<G, DP>(acc, p, vs, c0 + jj, lg);
        }
      }
      m = m_new;
    }
  }
  if (valid) {
    const long long bh = (long long)b * P.H + h;
    store_row<T, G>((T*)P.o + (bh * P.Tn + row) * P.Dh, P.Dh, lg, acc,
                    1.f / l);
    if (lg == 0) P.lse[bh * P.Tn + row] = m + logf(l);
  }
}

// dQ. Grid (query tiles of 256 / G, H, B). Shared memory: k, v [TILE][DP]
// f32 and the tile's key bias.
template <typename T, int G>
__global__ void __launch_bounds__(THREADS, 2)
    blocked_dq_kernel(const BParams P) {
  constexpr int DP = 16 * G, RB = THREADS / G, TILE = 4096 / DP;
  __shared__ __align__(16) float ks[TILE * DP];
  __shared__ __align__(16) float vs[TILE * DP];
  __shared__ float bs[TILE];
  const int b = blockIdx.z, h = blockIdx.y;
  const int lg = threadIdx.x % G, row = blockIdx.x * RB + threadIdx.x / G;
  const bool valid = row < P.Tn;
  const long long bh = (long long)b * P.H + h;
  const T* kp = (const T*)P.k + b * P.ks[0] + h * P.ks[1];
  const T* vp = (const T*)P.v + b * P.vs[0] + h * P.vs[1];
  const float* bias = P.bias + (long long)b * P.Tn;
  float q[16], d_o[16], dq[16];
  load_row<T, G>((const T*)P.q + b * P.qs[0] + h * P.qs[1], P.qs[2], row,
                 valid, P.Dh, lg, q);
  load_row<T, G>((const T*)P.d_o + b * P.dos[0] + h * P.dos[1], P.dos[2],
                 row, valid, P.Dh, lg, d_o);
#pragma unroll
  for (int i = 0; i < 16; ++i) dq[i] = 0.f;
  const float lse = valid ? P.lse[bh * P.Tn + row] : 0.f;
  const float delta = valid ? P.delta[bh * P.Tn + row] : 0.f;
  for (int k0 = 0; k0 < P.Tn; k0 += TILE) {  // padded keys add zeros
    __syncthreads();
    load_tile<T, DP, TILE>(kp, P.ks[2], k0, P.Tn, P.Dh, ks);
    load_tile<T, DP, TILE>(vp, P.vs[2], k0, P.Tn, P.Dh, vs);
    for (int j = threadIdx.x; j < TILE; j += blockDim.x)
      bs[j] = k0 + j < P.Tn ? bias[k0 + j] : NEG;
    __syncthreads();
    const int nk = min(TILE, P.Tn - k0);
    for (int j = 0; j < nk; ++j) {
      const float s = row_dot<G, DP>(q, ks, j, lg) * P.scale + bs[j];
      const float dp = row_dot<G, DP>(d_o, vs, j, lg);
      const float ds = expf(s - lse) * (dp - delta);
      row_axpy<G, DP>(dq, ds, ks, j, lg);
    }
  }
  if (valid)
    store_row<T, G>((T*)P.dq + (bh * P.Tn + row) * P.Dh, P.Dh, lg, dq,
                    P.scale);
}

// dK and dV. Grid (key tiles of 256 / G, H, B). Shared memory: q, dO
// [TILE][DP] f32 and the tile's lse and delta.
template <typename T, int G>
__global__ void __launch_bounds__(THREADS, 2)
    blocked_dkv_kernel(const BParams P) {
  constexpr int DP = 16 * G, RB = THREADS / G, TILE = 4096 / DP;
  __shared__ __align__(16) float qsh[TILE * DP];
  __shared__ __align__(16) float dosh[TILE * DP];
  __shared__ float lsh[TILE], dsh[TILE];
  const int b = blockIdx.z, h = blockIdx.y;
  const int lg = threadIdx.x % G, key = blockIdx.x * RB + threadIdx.x / G;
  const bool valid = key < P.Tn;
  const long long bh = (long long)b * P.H + h;
  const T* qp = (const T*)P.q + b * P.qs[0] + h * P.qs[1];
  const T* dop = (const T*)P.d_o + b * P.dos[0] + h * P.dos[1];
  float k[16], v[16], dk[16], dv[16];
  load_row<T, G>((const T*)P.k + b * P.ks[0] + h * P.ks[1], P.ks[2], key,
                 valid, P.Dh, lg, k);
  load_row<T, G>((const T*)P.v + b * P.vs[0] + h * P.vs[1], P.vs[2], key,
                 valid, P.Dh, lg, v);
#pragma unroll
  for (int i = 0; i < 16; ++i) dk[i] = dv[i] = 0.f;
  const float bj = valid ? P.bias[(long long)b * P.Tn + key] : NEG;
  for (int r0 = 0; r0 < P.Tn; r0 += TILE) {  // padded queries add zeros
    __syncthreads();
    load_tile<T, DP, TILE>(qp, P.qs[2], r0, P.Tn, P.Dh, qsh);
    load_tile<T, DP, TILE>(dop, P.dos[2], r0, P.Tn, P.Dh, dosh);
    for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
      const bool in = r0 + i < P.Tn;
      lsh[i] = in ? P.lse[bh * P.Tn + r0 + i] : 0.f;
      dsh[i] = in ? P.delta[bh * P.Tn + r0 + i] : 0.f;
    }
    __syncthreads();
    const int nq = min(TILE, P.Tn - r0);
    for (int i = 0; i < nq; ++i) {
      const float s = row_dot<G, DP>(k, qsh, i, lg) * P.scale + bj;
      const float p = expf(s - lsh[i]);
      const float dp = row_dot<G, DP>(v, dosh, i, lg);
      row_axpy<G, DP>(dv, p, dosh, i, lg);
      row_axpy<G, DP>(dk, p * (dp - dsh[i]), qsh, i, lg);
    }
  }
  if (valid) {
    const long long off = (bh * P.Tn + key) * P.Dh;
    store_row<T, G>((T*)P.dk + off, P.Dh, lg, dk, P.scale);
    store_row<T, G>((T*)P.dv + off, P.Dh, lg, dv, 1.f);
  }
}

bool shape_ok(const BParams& P) {
  return P.B > 0 && P.B <= 65535 && P.H > 0 && P.H <= 65535 && P.Tn > 0 &&
         P.Tp >= P.Tn && P.Dh > 0 && P.Dh <= 128 && P.Dh % 4 == 0;
}

template <typename T, int G>
cudaError_t launch(const BParams& P, bool backward, cudaStream_t s) {
  constexpr int RB = THREADS / G;
  const dim3 grid((P.Tn + RB - 1) / RB, P.H, P.B);
  if (!backward) {
    blocked_fwd_kernel<T, G><<<grid, THREADS, 0, s>>>(P);
    return cudaGetLastError();
  }
  blocked_dq_kernel<T, G><<<grid, THREADS, 0, s>>>(P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  blocked_dkv_kernel<T, G><<<grid, THREADS, 0, s>>>(P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const BParams& P, bool backward, cudaStream_t s) {
  if (P.Dh <= 32) return launch<T, 2>(P, backward, s);
  if (P.Dh <= 64) return launch<T, 4>(P, backward, s);
  return launch<T, 8>(P, backward, s);
}

void set_strides(long long* dst, const long long* src) {
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
}

int dispatch(const BParams& P, int dtype, bool backward, void* stream) {
  if (!shape_ok(P)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run<float>(P, backward, s);
  if (dtype == 1) return (int)run<__nv_bfloat16>(P, backward, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// o [B, H, T, Dh] (contiguous, q's type) and lse [B, H, T] f32 from q, k, v
// (element strides over b, h, t in qs, ks, vs; unit stride over Dh) and
// bias [B, T] f32. Tp >= T is the padded length whose padded keys enter the
// softmax with the bias -1e30. dtype 0 = f32, 1 = bf16; Dh <= 128, a
// multiple of 4.
int ishara_blocked_attention_fwd(int device, const void* q, const void* k,
                                 const void* v, const long long* qs,
                                 const long long* ks, const long long* vs,
                                 const void* bias, void* o, void* lse, int B,
                                 int H, int T, int Tp, int Dh, float scale,
                                 int dtype, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  BParams P{};
  P.q = q, P.k = k, P.v = v;
  set_strides(P.qs, qs);
  set_strides(P.ks, ks);
  set_strides(P.vs, vs);
  P.bias = (const float*)bias;
  P.o = o;
  P.lse = (float*)lse;
  P.B = B, P.H = H, P.Tn = T, P.Tp = Tp, P.Dh = Dh;
  P.scale = scale;
  return dispatch(P, dtype, false, stream);
}

// dq, dk, dv [B, H, T, Dh] contiguous (q's type) from q, k, v, d_o (strides
// qs, ks, vs, dos), bias, the forward's lse and delta = rowsum(d_o * o),
// both f32 [B, H, T]. Two launches: the dQ pass, then the dK / dV pass.
int ishara_blocked_attention_bwd(int device, const void* q, const void* k,
                                 const void* v, const void* d_o,
                                 const long long* qs, const long long* ks,
                                 const long long* vs, const long long* dos,
                                 const void* bias, const void* lse,
                                 const void* delta, void* dq, void* dk,
                                 void* dv, int B, int H, int T, int Tp,
                                 int Dh, float scale, int dtype,
                                 void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  BParams P{};
  P.q = q, P.k = k, P.v = v, P.d_o = d_o;
  set_strides(P.qs, qs);
  set_strides(P.ks, ks);
  set_strides(P.vs, vs);
  set_strides(P.dos, dos);
  P.bias = (const float*)bias;
  P.lse = (float*)const_cast<void*>(lse);
  P.delta = (const float*)delta;
  P.dq = dq, P.dk = dk, P.dv = dv;
  P.B = B, P.H = H, P.Tn = T, P.Tp = Tp, P.Dh = Dh;
  P.scale = scale;
  return dispatch(P, dtype, true, stream);
}

const char* ishara_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
