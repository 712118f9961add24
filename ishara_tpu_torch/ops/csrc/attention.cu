// Multi-head self-attention for training on Hopper (sm_90a), forward and
// backward, with dropout on the normalised weights.
//
// Replaces the Pallas kernels _fwd_kernel and _bwd_kernel of
// ishara_tpu/ops/attention.py (behind flash_mhsa): one [T, T] score block per
// (batch, head), T <= 384, a [B, T] additive key bias (0 or -1e30), scores
// scaled by `scale`; the forward saves the row logsumexp and the backward
// recomputes the probabilities from it instead of storing them.
//
// Arithmetic as the reference: q, k, v (bf16 or f32) are widened to f32 and
// everything is f32 from there; s = q.k * scale + bias; p = exp(s - max);
// l = sum p over the UNdropped weights; o = ((p * keep / (1 - rate)) . v) / l
// rounded once to q's type; lse = max + log l. Backward: P = exp(s - lse),
// dP = dO.V^T, dV = (P * keep')^T dO, delta = sum dO * O,
// dS = P * (dP * keep' - delta), dQ = dS.K * scale, dK = dS^T.Q * scale, each
// rounded once. keep' = keep / (1 - rate) is the Philox function of
// (seed, flat index into [B, H, T, T]) of philox.cuh, so the backward
// regenerates the forward's mask. A row whose keys are all masked gives
// uniform weights and stays finite.
//
// Design: one block per (batch, head). K^T (and V^T in the backward) sit in
// shared memory as f32 [Dh][TP], TP = T rounded up to 128, so that a lane
// owns 4 consecutive keys of each 128-key pass and reads them as one
// conflict-free float4 per head dimension; one warp per query row; softmax
// statistics by warp shuffles; the p.v product with a lane per head
// dimension. The backward walks the query rows in tiles of one row a warp:
// each warp leaves its row's dS and dropped P in shared memory, then all
// threads add the tile into dK and dV, which live in shared memory with one
// owner thread per element -- no atomics, so the gradients do not change from
// run to run. Where K^T, V^T, dK and dV of a whole head outgrow a block's
// shared memory (a 64-wide head beyond T = 128), the backward splits the keys
// into tiles of a multiple of 128, one block per (batch, head, key tile):
// the saved logsumexp makes the tiles independent, each owns its keys' dK and
// dV, and their shares of dQ go to an f32 buffer that a second kernel adds in
// a fixed order.
//
// Bound: bytes (q, k, v, o and their gradients, 2-4 bytes each; at B 256,
// H 8, T 176, Dh 32 the forward moves 92 MB where its products are only
// 8 GFLOP). What it spends its time on is the f32 FMAs of the two products
// on the CUDA cores and, with dropout, one Philox block per 4 weights.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int MAX_PASSES = 3;  // T <= 384
constexpr int MAX_DPL = 4;     // head dimension <= 128: dims a lane owns

struct AttnParams {
  const void *q, *k, *v, *d_o;  // [B, H, T, Dh], strided over b, h, t
  long long qs[3], ks[3], vs[3], dos[3];
  const float* bias;  // [B, T]
  const int* seed;    // one int32
  void* o;            // [B, H, T, Dh] contiguous (an input of the backward)
  float* lse;         // [B, H, T]
  void *dq, *dk, *dv;  // [B, H, T, Dh] contiguous
  float* dq_part;      // [key tiles, B, H, T, Dh] when there are several
  int key_tile;        // keys a block of the backward owns, a multiple of 128
  int B, H, Tn, Dh;
  float scale;
  uint32_t threshold;
  float keep_scale;  // 1 / (1 - rate); dropout is off when threshold == 0
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// src [Tn, Dh] (row stride st) -> dst [Dh][TP] f32, zero beyond Tn.
template <typename T>
__device__ void load_transposed(const T* src, long long st, float* dst, int Tn,
                                int Dh, int TP) {
  for (int e = threadIdx.x; e < TP * Dh; e += blockDim.x) {
    const int j = e / Dh, d = e - j * Dh;
    dst[d * TP + j] = j < Tn ? to_f(src[(long long)j * st + d]) : 0.f;
  }
}

// acc[pass][i] = sum_d row[d] * mt[d][pass * 128 + 4 * lane + i].
__device__ __forceinline__ void row_dot(const float* row, const float* mt,
                                        int Dh, int TP, int passes, int lane,
                                        float acc[MAX_PASSES][4]) {
#pragma unroll
  for (int p = 0; p < MAX_PASSES; ++p)
    acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.f;
  for (int d = 0; d < Dh; ++d) {
    const float r = row[d];
#pragma unroll
    for (int p = 0; p < MAX_PASSES; ++p) {
      if (p < passes) {
        const float4 m = *reinterpret_cast<const float4*>(
            mt + d * TP + p * 128 + 4 * lane);
        acc[p][0] += r * m.x;
        acc[p][1] += r * m.y;
        acc[p][2] += r * m.z;
        acc[p][3] += r * m.w;
      }
    }
  }
}

// keep'[pass][i] for the keys a lane owns, from key k0 on, in query row
// `row` of (b, h).
__device__ __forceinline__ void row_keep(const AttnParams& P, uint32_t seed,
                                         long long bh, int row, int k0,
                                         int passes, int lane,
                                         float keep[MAX_PASSES][4]) {
  const uint64_t base = ((uint64_t)bh * P.Tn + row) * (uint64_t)P.Tn + k0;
#pragma unroll
  for (int p = 0; p < MAX_PASSES; ++p) {
    if (p < passes) {
      if (P.threshold == 0u) {
        keep[p][0] = keep[p][1] = keep[p][2] = keep[p][3] = 1.f;
      } else {
        philox::keep4(seed, base + p * 128 + 4 * lane, P.threshold,
                      P.keep_scale, keep[p]);
      }
    }
  }
}

// Shared memory, forward: kt [Dh][TP] | v [T][Dh] | bias [TP] |
// psh [warps][TP] | qsh [warps][Dh].
template <typename T>
__global__ void attention_fwd_kernel(const AttnParams P) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Tn = P.Tn, Dh = P.Dh;
  const int TP = (Tn + 127) / 128 * 128, passes = TP / 128;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long bh = blockIdx.x;
  const int b = (int)(bh / P.H), h = (int)(bh - (long long)b * P.H);
  float* kt = smem;
  float* vs = kt + Dh * TP;
  float* bias = vs + Tn * Dh;
  float* psh = bias + TP + warp * TP;
  float* qsh = bias + TP + nwarps * TP + warp * Dh;

  const T* qg = (const T*)P.q + b * P.qs[0] + h * P.qs[1];
  const T* kg = (const T*)P.k + b * P.ks[0] + h * P.ks[1];
  const T* vg = (const T*)P.v + b * P.vs[0] + h * P.vs[1];
  load_transposed(kg, P.ks[2], kt, Tn, Dh, TP);
  for (int e = threadIdx.x; e < Tn * Dh; e += blockDim.x) {
    const int j = e / Dh, d = e - j * Dh;
    vs[e] = to_f(vg[(long long)j * P.vs[2] + d]);
  }
  for (int j = threadIdx.x; j < TP; j += blockDim.x)
    bias[j] = j < Tn ? P.bias[(long long)b * Tn + j] : -INFINITY;
  __syncthreads();
  const uint32_t seed = (uint32_t)P.seed[0];

  for (int r = warp; r < Tn; r += nwarps) {
    for (int d = lane; d < Dh; d += 32)
      qsh[d] = to_f(qg[(long long)r * P.qs[2] + d]);
    __syncwarp();
    float s[MAX_PASSES][4], keep[MAX_PASSES][4];
    row_dot(qsh, kt, Dh, TP, passes, lane, s);
    float m = -INFINITY;
#pragma unroll
    for (int p = 0; p < MAX_PASSES; ++p) {
      if (p < passes) {
        const float4 bj =
            *reinterpret_cast<const float4*>(bias + p * 128 + 4 * lane);
        s[p][0] = s[p][0] * P.scale + bj.x;
        s[p][1] = s[p][1] * P.scale + bj.y;
        s[p][2] = s[p][2] * P.scale + bj.z;
        s[p][3] = s[p][3] * P.scale + bj.w;
        m = fmaxf(fmaxf(fmaxf(m, s[p][0]), fmaxf(s[p][1], s[p][2])), s[p][3]);
      }
    }
    m = warp_max(m);
    row_keep(P, seed, bh, r, 0, passes, lane, keep);
    float l = 0.f;
#pragma unroll
    for (int p = 0; p < MAX_PASSES; ++p) {
      if (p < passes) {
        float4 pu;
        float e0 = expf(s[p][0] - m), e1 = expf(s[p][1] - m);
        float e2 = expf(s[p][2] - m), e3 = expf(s[p][3] - m);
        l += (e0 + e1) + (e2 + e3);
        pu.x = e0 * keep[p][0];
        pu.y = e1 * keep[p][1];
        pu.z = e2 * keep[p][2];
        pu.w = e3 * keep[p][3];
        *reinterpret_cast<float4*>(psh + p * 128 + 4 * lane) = pu;
      }
    }
    l = warp_sum(l);
    __syncwarp();
    float acc[MAX_DPL] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < Tn; ++j) {
      const float pj = psh[j];
#pragma unroll
      for (int i = 0; i < MAX_DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) acc[i] += pj * vs[j * Dh + d];
      }
    }
    T* og = (T*)P.o + ((bh * Tn) + r) * Dh;
#pragma unroll
    for (int i = 0; i < MAX_DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) from_f(acc[i] / l, og + d);
    }
    if (lane == 0) P.lse[bh * Tn + r] = m + logf(l);
    __syncwarp();
  }
}

// Shared memory, backward, for the key tile [k0, k0 + KT) of one (batch,
// head), Kmax = min(KT, T): kt [Dh][KT] | vt [Dh][KT] | bias [KT] |
// dk [Kmax][Dh] | dv [Kmax][Dh] | ds [warps][KT] | pd [warps][KT] |
// qsh [warps][Dh] | dosh [warps][Dh].
template <typename T>
__global__ void attention_bwd_kernel(const AttnParams P) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Tn = P.Tn, Dh = P.Dh, KT = P.key_tile;
  const int k0 = blockIdx.y * KT;
  const int Kn = min(KT, Tn - k0);  // this tile's real keys
  const int passes = (Kn + 127) / 128;
  const int Kmax = min(KT, Tn);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long bh = blockIdx.x;
  const int b = (int)(bh / P.H), h = (int)(bh - (long long)b * P.H);
  float* kt = smem;
  float* vt = kt + Dh * KT;
  float* bias = vt + Dh * KT;
  float* dks = bias + KT;
  float* dvs = dks + Kmax * Dh;
  float* ds_all = dvs + Kmax * Dh;
  float* pd_all = ds_all + nwarps * KT;
  float* q_all = pd_all + nwarps * KT;
  float* do_all = q_all + nwarps * Dh;
  float* dsh = ds_all + warp * KT;
  float* pdh = pd_all + warp * KT;
  float* qsh = q_all + warp * Dh;
  float* dosh = do_all + warp * Dh;

  const T* qg = (const T*)P.q + b * P.qs[0] + h * P.qs[1];
  const T* kg = (const T*)P.k + b * P.ks[0] + h * P.ks[1] + k0 * P.ks[2];
  const T* vg = (const T*)P.v + b * P.vs[0] + h * P.vs[1] + k0 * P.vs[2];
  const T* dog = (const T*)P.d_o + b * P.dos[0] + h * P.dos[1];
  const T* og = (const T*)P.o + bh * Tn * Dh;
  load_transposed(kg, P.ks[2], kt, Kn, Dh, KT);
  load_transposed(vg, P.vs[2], vt, Kn, Dh, KT);
  for (int j = threadIdx.x; j < KT; j += blockDim.x)
    bias[j] = j < Kn ? P.bias[(long long)b * Tn + k0 + j] : -INFINITY;
  for (int e = threadIdx.x; e < Kn * Dh; e += blockDim.x)
    dks[e] = dvs[e] = 0.f;
  __syncthreads();
  const uint32_t seed = (uint32_t)P.seed[0];
  const bool whole = gridDim.y == 1;  // this block has all of a row's dq

  for (int r0 = 0; r0 < Tn; r0 += nwarps) {
    const int r = r0 + warp;
    if (r < Tn) {
      float dl = 0.f;
      for (int d = lane; d < Dh; d += 32) {
        const float qv = to_f(qg[(long long)r * P.qs[2] + d]);
        const float dv = to_f(dog[(long long)r * P.dos[2] + d]);
        qsh[d] = qv;
        dosh[d] = dv;
        dl += dv * to_f(og[(long long)r * Dh + d]);
      }
      const float delta = warp_sum(dl);
      const float lse = P.lse[bh * Tn + r];
      __syncwarp();
      float s[MAX_PASSES][4], dp[MAX_PASSES][4], keep[MAX_PASSES][4];
      row_dot(qsh, kt, Dh, KT, passes, lane, s);
      row_dot(dosh, vt, Dh, KT, passes, lane, dp);
      row_keep(P, seed, bh, r, k0, passes, lane, keep);
#pragma unroll
      for (int p = 0; p < MAX_PASSES; ++p) {
        if (p < passes) {
          const float4 bj =
              *reinterpret_cast<const float4*>(bias + p * 128 + 4 * lane);
          const float bjs[4] = {bj.x, bj.y, bj.z, bj.w};
          float4 dsv, pdv;
          float* dsa = reinterpret_cast<float*>(&dsv);
          float* pda = reinterpret_cast<float*>(&pdv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pn = expf(s[p][i] * P.scale + bjs[i] - lse);
            pda[i] = pn * keep[p][i];
            dsa[i] = pn * (dp[p][i] * keep[p][i] - delta);
            s[p][i] = dsa[i];  // kept for dq below
          }
          *reinterpret_cast<float4*>(dsh + p * 128 + 4 * lane) = dsv;
          *reinterpret_cast<float4*>(pdh + p * 128 + 4 * lane) = pdv;
        }
      }
      // dq[d] = scale * sum_j ds[j] * k[j][d]: partial sums over the lane's
      // keys, then across the warp; lane d & 31 keeps dimension d
      float dq[MAX_DPL] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < Dh; ++d) {
        float part = 0.f;
#pragma unroll
        for (int p = 0; p < MAX_PASSES; ++p) {
          if (p < passes) {
            const float4 m = *reinterpret_cast<const float4*>(
                kt + d * KT + p * 128 + 4 * lane);
            part += s[p][0] * m.x + s[p][1] * m.y + s[p][2] * m.z +
                    s[p][3] * m.w;
          }
        }
        part = warp_sum(part);
#pragma unroll
        for (int i = 0; i < MAX_DPL; ++i)
          if (d == lane + 32 * i) dq[i] = part;
      }
      const long long at = (bh * Tn + r) * Dh;
      T* dqg = (T*)P.dq + at;
      float* dqp = whole ? nullptr
                         : P.dq_part +
                               (long long)blockIdx.y * gridDim.x * Tn * Dh + at;
#pragma unroll
      for (int i = 0; i < MAX_DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) {
          if (whole)
            from_f(dq[i] * P.scale, dqg + d);
          else
            dqp[d] = dq[i] * P.scale;
        }
      }
    }
    __syncthreads();
    // add this tile's rows into dk and dv; element e has one owner thread
    const int rows = min(nwarps, Tn - r0);
    for (int e = threadIdx.x; e < Kn * Dh; e += blockDim.x) {
      const int j = e / Dh, d = e - j * Dh;
      float ak = dks[e], av = dvs[e];
      for (int w = 0; w < rows; ++w) {
        ak += ds_all[w * KT + j] * q_all[w * Dh + d];
        av += pd_all[w * KT + j] * do_all[w * Dh + d];
      }
      dks[e] = ak;
      dvs[e] = av;
    }
    __syncthreads();
  }
  T* dkg = (T*)P.dk + (bh * Tn + k0) * Dh;
  T* dvg = (T*)P.dv + (bh * Tn + k0) * Dh;
  for (int e = threadIdx.x; e < Kn * Dh; e += blockDim.x) {
    from_f(dks[e] * P.scale, dkg + e);
    from_f(dvs[e], dvg + e);
  }
}

// dq[e] = part[0][e] + part[1][e] + ... in that order, rounded once.
template <typename T>
__global__ void attention_dq_reduce_kernel(const float* __restrict__ part,
                                           T* __restrict__ dq, long long n,
                                           int tiles) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float sum = 0.f;
  for (int c = 0; c < tiles; ++c) sum += part[c * n + e];
  from_f(sum, dq + e);
}

size_t fwd_smem(int T, int Dh, int warps) {
  const int TP = (T + 127) / 128 * 128;
  return ((size_t)Dh * TP + (size_t)T * Dh + TP + (size_t)warps * TP +
          (size_t)warps * Dh) * 4;
}

size_t bwd_smem(int T, int Dh, int KT, int warps) {
  const int Kmax = KT < T ? KT : T;
  return (2 * (size_t)Dh * KT + KT + 2 * (size_t)Kmax * Dh +
          2 * (size_t)warps * KT + 2 * (size_t)warps * Dh) * 4;
}

constexpr size_t SMEM_LIMIT = 227 * 1024;

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool shape_ok(const AttnParams& P) {
  return P.B > 0 && P.H > 0 && P.Tn > 0 && P.Tn <= 128 * MAX_PASSES &&
         P.Dh > 0 && P.Dh <= 32 * MAX_DPL && P.Dh % 4 == 0;
}

template <typename T>
cudaError_t run_fwd(const AttnParams& P, cudaStream_t stream) {
  const int warps = 8;
  const size_t smem = fwd_smem(P.Tn, P.Dh, warps);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(attention_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  attention_fwd_kernel<T><<<P.B * P.H, warps * 32, smem, stream>>>(P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_bwd(const AttnParams& P, cudaStream_t stream) {
  const int KT = P.key_tile, TP = (P.Tn + 127) / 128 * 128;
  if (KT <= 0 || KT % 128 || KT > TP) return cudaErrorInvalidValue;
  const int tiles = (P.Tn + KT - 1) / KT;
  if (tiles > 1 && P.dq_part == nullptr) return cudaErrorInvalidValue;
  int warps = 16;
  if (bwd_smem(P.Tn, P.Dh, KT, warps) > SMEM_LIMIT) warps = 8;
  const size_t smem = bwd_smem(P.Tn, P.Dh, KT, warps);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(attention_bwd_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  attention_bwd_kernel<T>
      <<<dim3(P.B * P.H, tiles), warps * 32, smem, stream>>>(P);
  e = cudaGetLastError();
  if (e != cudaSuccess || tiles == 1) return e;
  const long long n = (long long)P.B * P.H * P.Tn * P.Dh;
  attention_dq_reduce_kernel<T>
      <<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(P.dq_part, (T*)P.dq,
                                                        n, tiles);
  return cudaGetLastError();
}

void set_strides(long long* dst, const long long* src) {
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
}

}  // namespace

extern "C" {

// o [B, H, T, Dh] and lse [B, H, T] from q, k, v (element strides over
// b, h, t in qs, ks, vs; unit stride over Dh), bias [B, T] f32, one int32
// seed on the device. dtype 0 = f32, 1 = bf16. threshold 0 means no dropout.
int ishara_attention_fwd(int device, const void* q, const void* k,
                         const void* v, const long long* qs,
                         const long long* ks, const long long* vs,
                         const void* bias, const void* seed, void* o,
                         void* lse, int B, int H, int T, int Dh, float scale,
                         unsigned int threshold, float keep_scale, int dtype,
                         void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  AttnParams P{};
  P.q = q;
  P.k = k;
  P.v = v;
  set_strides(P.qs, qs);
  set_strides(P.ks, ks);
  set_strides(P.vs, vs);
  P.bias = (const float*)bias;
  P.seed = (const int*)seed;
  P.o = o;
  P.lse = (float*)lse;
  P.B = B, P.H = H, P.Tn = T, P.Dh = Dh;
  P.scale = scale;
  P.threshold = threshold;
  P.keep_scale = keep_scale;
  if (!shape_ok(P)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_fwd<float>(P, s);
  if (dtype == 1) return (int)run_fwd<__nv_bfloat16>(P, s);
  return (int)cudaErrorInvalidValue;
}

// dq, dk, dv [B, H, T, Dh] contiguous from the forward's inputs, its o and
// lse, and d_o (strides dos). A block owns key_tile keys (a multiple of 128,
// at most T rounded up to one); with more than one tile to a head, dq_part is
// f32 scratch [tiles, B, H, T, Dh], else it may be null.
int ishara_attention_bwd(int device, const void* q, const void* k,
                         const void* v, const void* d_o, const long long* qs,
                         const long long* ks, const long long* vs,
                         const long long* dos, const void* bias,
                         const void* seed, const void* o, const void* lse,
                         void* dq, void* dk, void* dv, void* dq_part,
                         int key_tile, int B, int H, int T, int Dh,
                         float scale, unsigned int threshold,
                         float keep_scale, int dtype, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  AttnParams P{};
  P.q = q;
  P.k = k;
  P.v = v;
  P.d_o = d_o;
  set_strides(P.qs, qs);
  set_strides(P.ks, ks);
  set_strides(P.vs, vs);
  set_strides(P.dos, dos);
  P.bias = (const float*)bias;
  P.seed = (const int*)seed;
  P.o = const_cast<void*>(o);
  P.lse = (float*)const_cast<void*>(lse);
  P.dq = dq;
  P.dk = dk;
  P.dv = dv;
  P.dq_part = (float*)dq_part;
  P.key_tile = key_tile;
  P.B = B, P.H = H, P.Tn = T, P.Dh = Dh;
  P.scale = scale;
  P.threshold = threshold;
  P.keep_scale = keep_scale;
  if (!shape_ok(P)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_bwd<float>(P, s);
  if (dtype == 1) return (int)run_bwd<__nv_bfloat16>(P, s);
  return (int)cudaErrorInvalidValue;
}

const char* ishara_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
