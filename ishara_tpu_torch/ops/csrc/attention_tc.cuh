// The tensor-core attention core shared by attention.cu (K3, one [T, T]
// block, dropout) and attention_blocked.cu (K8, any T, no dropout): the
// forward, a dQ pass and a dK / dV pass, on Hopper (sm_90a). The bf16
// heads of 32 and 64 of both kernels have left it (below).
//
// Replaces the CUDA-core tiles that both kernels had before: the [T, T]
// products of ishara_tpu/ops/attention.py (_fwd_kernel, _bwd_kernel behind
// flash_mhsa) and of ishara_tpu/ops/attention_blocked.py (_fwd_kernel,
// _dq_kernel, _dkv_kernel behind flash_mhsa_blocked) run here on the tensor
// cores.
//
// Bound: at the main paths' shapes (head dimension 32, T 176 or 512, batch
// 256, 8 heads) the products are 8-69 GFLOP against 90-270 MB of q, k, v, o
// and gradients, so on paper memory binds at the tensor cores' bf16 rate
// (989 TFLOP/s) and the CUDA cores' f32 FMAs (67 TFLOP/s) would bind on the
// products. The design therefore keeps every [T, T] product on the tensor
// cores and every [T, T] intermediate in registers:
//
// - a block of 4 warps owns 64 rows (queries in the forward and the dQ
//   pass, keys in the dK / dV pass), one warp per 16 rows; the other side
//   streams through shared memory in tiles of BN rows (64; 32 for heads
//   wider than 64 and 16 for f32 heads of 256, for registers and shared
//   memory), double-buffered by cp.async (16-byte copies where rows are
//   16-byte aligned, plain loads otherwise);
// - bf16: mma.sync.m16n8k16 with f32 accumulators, operands by ldmatrix
//   from rows padded by 16 bytes (no bank conflicts); f32: the same tiling
//   with 3xTF32 m16n8k8 (big.big + big.small + small.big), which keeps the
//   products at about f32 accuracy;
// - the online softmax lives in the accumulators (row max and sum by quad
//   shuffles); P is rounded to the operand type in registers and fed as the
//   A operand of P.V: the m16n8 accumulator layout is the A-fragment layout
//   (for TF32, with the keys of each 8-key step permuted the same way on
//   both operands), so P never touches shared memory; O is rounded once;
// - the head dimension is zero-padded to DP (32, 64, 128 or 256) in shared
//   memory, so every Dh from 1 to 256 runs: zeros add nothing to a dot; a
//   wider head is cut into 256-wide chunks, one output chunk a block (the
//   "wide" kernels below), so any Dh >= 1 runs;
// - the backward is two passes with no atomics (the same bits every run):
//   the dQ pass (S, dP, dQ: 3 products, and delta = rowsum(dO * O) in its
//   prologue) and the dK / dV pass (S^T, dP^T, dV, dK: 4 products). The
//   function needs 5; the two recomputed ones cost less than the f32
//   partial-dQ traffic a one-pass split would move. The bf16 heads of 32
//   and 64 have left this core where TMA can read q, k, v: both kernels'
//   forwards run on a TMA key / value ring (attention_fwd_wg.cuh; K3's
//   writing the keep bits), K3's backward in one pass of five wgmma
//   products a head (attention_bwd.cuh) on those bits, K8's in the same
//   one pass without them (heads of 32 to T 640, of 64 to T 384). The
//   kernels here serve the rest: f32, other widths, strides TMA cannot
//   read, and K8's backward past those T.
//
// Keys: key j < T has the caller's bias, T <= j < Tc has the bias -1e30
// (K8's padded keys, k = v = 0, which count in an all-masked row's
// average), j >= Tc is excluded (weight exactly 0). K3 passes Tc = T.
// Dropout (K3): keep' = keep / (1 - rate) with keep the Philox function of
// (seed, offset + flat index into [B, H, T, T]) of philox.cuh, applied to P
// before P.V and to dP in the backward; the row sum l is the undropped one.
// A process holding rows [r0, r1) of a batch passes offset = r0 H T T. A
// tensor-parallel rank holding heads [h0, h0 + H) of a batch row's Hm
// passes Hm and offset = r0 Hm T T + h0 T T: local head (b, h) then takes the
// mask of global head b Hm + h, the unsharded launch's there.

#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"
#include "philox.cuh"

namespace tc {

constexpr int ROWS = 64;      // rows a block owns
constexpr int THREADS = 128;  // 4 warps of 16 rows
constexpr float NEG = -1e30f;

struct Params {
  const void *q, *k, *v, *d_o;  // [B, H, T, Dh], strided over b, h, t
  long long qs[3], ks[3], vs[3], dos[3];
  const float* bias;   // [B, T]
  const int* seed;     // one int32 (dropout only)
  void* o;             // [B, H, T, Dh] contiguous
  float* lse;          // [B, H, T]
  float* delta;        // [B, H, T], written by the dQ pass
  void *dq, *dk, *dv;  // [B, H, T, Dh] contiguous
  int B, H, T, Tc, Dh;
  float scale;
  uint32_t threshold;  // 0: no dropout
  float keep_scale;
  uint64_t offset;     // added to every mask index (a batch shard's rows)
  int Hm;              // heads a batch row of the mask's tensor (0: H)
  int vec;             // 1: rows 16-byte aligned, cp.async copies
};

template <typename T>
struct Op;
template <>
struct Op<__nv_bfloat16> {
  static constexpr int EPC = 8;  // elements a 16-byte chunk
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16_rn(0.f);
  }
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
};
template <>
struct Op<float> {
  static constexpr int EPC = 4;
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

// Row stride of a shared tile: DP plus 16 bytes.
template <typename T, int DP>
__host__ __device__ constexpr int ld() {
  return DP + 16 / (int)sizeof(T);
}

// ---------------------------------------------------------------------------
// Tiles
// ---------------------------------------------------------------------------

// Rows [r0, r0 + N) of src (row stride st) into dst [N][ld], zero at rows
// >= nvalid and at columns >= Dh. cp.async where P.vec (Dh a multiple of the
// chunk, 16-byte aligned rows), plain loads otherwise.
template <typename T, int DP, int N>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long st,
                                          int r0, int nvalid, int Dh,
                                          int vec) {
  constexpr int LD = ld<T, DP>(), EPC = Op<T>::EPC, CPR = DP / EPC;
  if (vec) {
    for (int e = threadIdx.x; e < N * CPR; e += THREADS) {
      const int r = e / CPR, c = e - r * CPR;
      const bool ok = r0 + r < nvalid && c * EPC < Dh;
      const T* g = ok ? src + (long long)(r0 + r) * st + c * EPC : src;
      cp_async16(smem_u32(dst + r * LD + c * EPC), g, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < N * DP; e += THREADS) {
      const int r = e / DP, d = e - r * DP;
      dst[r * LD + d] = (r0 + r < nvalid && d < Dh)
                            ? src[(long long)(r0 + r) * st + d]
                            : Op<T>::zero();
    }
  }
}

// s[n][.] = X[16 rows of the warp] . Y[BN rows]^T over DP (fresh, or added
// to s when !fresh).
template <int DP, int BN>
__device__ __forceinline__ void rows_x_tile(const __nv_bfloat16* X,
                                            const __nv_bfloat16* Y,
                                            float s[BN / 8][4],
                                            bool fresh = true) {
  constexpr int LD = ld<__nv_bfloat16, DP>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
    if (fresh) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < DP; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, smem_u32(X + (lane & 15) * LD + k0 + (lane >> 4) * 8));
#pragma unroll
    for (int n0 = 0; n0 < BN; n0 += 16) {
      const int m = lane >> 3, r = lane & 7;
      uint32_t b[4];
      ldsm_x4(b, smem_u32(Y + (n0 + (m >> 1) * 8 + r) * LD + k0 +
                          (m & 1) * 8));
      mma_bf16(s[n0 / 8], a, b[0], b[1]);
      mma_bf16(s[n0 / 8 + 1], a, b[2], b[3]);
    }
  }
}

template <int DP, int BN>
__device__ __forceinline__ void rows_x_tile(const float* X, const float* Y,
                                            float s[BN / 8][4],
                                            bool fresh = true) {
  constexpr int LD = ld<float, DP>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
    if (fresh) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
  for (int k0 = 0; k0 < DP; k0 += 8) {
    const float af[4] = {X[g * LD + k0 + t], X[(g + 8) * LD + k0 + t],
                         X[g * LD + k0 + t + 4],
                         X[(g + 8) * LD + k0 + t + 4]};
    const SplitA a(af);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const float* y = Y + (n * 8 + g) * LD + k0 + t;
      mma_3xtf32(s[n], a, y[0], y[4]);
    }
  }
}

// acc[n][.] += P[16 x BN] . Z[BN rows][DP], P in accumulator layout.
template <int DP, int BN>
__device__ __forceinline__ void acc_x_tile(const float p[BN / 8][4],
                                           const __nv_bfloat16* Z,
                                           float acc[DP / 8][4]) {
  constexpr int LD = ld<__nv_bfloat16, DP>();
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n0 = 0; n0 < DP; n0 += 16) {
      uint32_t b[4];
      ldsm_x4_t(b, smem_u32(Z + (kk * 16 + (m & 1) * 8 + r) * LD + n0 +
                            (m >> 1) * 8));
      mma_bf16(acc[n0 / 8], a, b[0], b[1]);
      mma_bf16(acc[n0 / 8 + 1], a, b[2], b[3]);
    }
  }
}

// TF32 A fragment (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) with the
// 8 keys permuted: position t is key 2t, position t + 4 key 2t + 1, so the
// accumulator's (c0, c2, c1, c3) is the fragment; Z is read the same way.
template <int DP, int BN>
__device__ __forceinline__ void acc_x_tile(const float p[BN / 8][4],
                                           const float* Z,
                                           float acc[DP / 8][4]) {
  constexpr int LD = ld<float, DP>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    const float af[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
    const SplitA a(af);
    const float* z = Z + (kk * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      mma_3xtf32(acc[n], a, z[n * 8], z[LD + n * 8]);
  }
}

// ---------------------------------------------------------------------------
// Dropout
// ---------------------------------------------------------------------------

__device__ __forceinline__ float keep_of(uint32_t w, const Params& P) {
  return w >= P.threshold ? P.keep_scale : 0.f;
}

// The mask's head index of local head bh = b H + h: b Hm + h.
__device__ __forceinline__ uint64_t mask_head(const Params& P, long long bh) {
  if (P.Hm == 0 || P.Hm == P.H) return (uint64_t)bh;
  return (uint64_t)(bh / P.H) * P.Hm + (uint64_t)(bh % P.H);
}

// keep'[n][.] in accumulator layout, rows r_g = row0 + g and r_g + 8 (the
// flat index's major coordinate), columns col0 + 8n + 2t (+1, the minor
// one): flat index offset + (mask_head(bh) * T + row) * T + col. With
// T % 4 == 0 (and offset % 4 == 0) a thread pair shares one Philox block a
// row and 4 columns (shuffled).
template <int NT>
__device__ __forceinline__ void keep_rowmajor(const Params& P, uint32_t seed,
                                              long long bh, int row0,
                                              int col0, float kp[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint64_t base0 =
      P.offset + (mask_head(P, bh) * P.T + row0 + g) * (uint64_t)P.T;
  const uint64_t base8 = base0 + 8ull * P.T;
  if ((P.T & 3) == 0 && (P.offset & 3) == 0) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint64_t c = col0 + n * 8 + 4 * (t >> 1);
      const uint4 w = philox::block(seed, ((t & 1) ? base8 + c : base0 + c)
                                              >> 2);
      const uint32_t s0 = (t & 1) ? w.x : w.z, s1 = (t & 1) ? w.y : w.w;
      const uint32_t r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      const uint32_t r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      if (t & 1) {  // keys 4u + 2, 4u + 3
        kp[n][0] = keep_of(r0, P), kp[n][1] = keep_of(r1, P);
        kp[n][2] = keep_of(w.z, P), kp[n][3] = keep_of(w.w, P);
      } else {      // keys 4u, 4u + 1
        kp[n][0] = keep_of(w.x, P), kp[n][1] = keep_of(w.y, P);
        kp[n][2] = keep_of(r0, P), kp[n][3] = keep_of(r1, P);
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint64_t c = col0 + n * 8 + 2 * t;
      kp[n][0] = keep_of(philox::bits(seed, base0 + c), P);
      kp[n][1] = keep_of(philox::bits(seed, base0 + c + 1), P);
      kp[n][2] = keep_of(philox::bits(seed, base8 + c), P);
      kp[n][3] = keep_of(philox::bits(seed, base8 + c + 1), P);
    }
  }
}

// The same in the dK / dV pass's layout: accumulator rows are keys (the
// flat index's minor coordinate) key0 + g (+8), columns are queries
// q0 + 8n + 2t (+1). With T % 4 == 0 the four lanes of one t and of
// g = 4u .. 4u + 3 each compute one of the four Philox blocks they need
// (query 2t or 2t + 1, keys 4u.. or 4u + 8..) and exchange words.
template <int NT>
__device__ __forceinline__ void keep_colmajor(const Params& P, uint32_t seed,
                                              long long bh, int key0, int q0,
                                              float kp[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint64_t head = mask_head(P, bh) * P.T;
  if ((P.T & 3) == 0 && (P.offset & 3) == 0) {
    const int i = g & 3, u4 = g & ~3;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      // block c = i: query q0 + 8n + 2t + (c & 1), keys key0 + u4 + 8(c >> 1)
      const uint64_t qc = q0 + n * 8 + 2 * t + (i & 1);
      const uint64_t idx = P.offset + (head + qc) * (uint64_t)P.T + key0 +
                           u4 + 8 * (i >> 1);
      const uint4 w = philox::block(seed, idx >> 2);
      // round r: lane i takes word i of block (i + r) & 3 from the lane
      // that computed it, which sends its word (own index - r) & 3
      uint32_t v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        v[r] = __shfl_sync(0xffffffffu, philox::word(w, (i - r) & 3),
                           (lane & ~12) | (((i + r) & 3) << 2));
      // block c: word i (key key0 + g, +8 for c >= 2) of query 2t + (c & 1)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = (c - i) & 3;
        kp[n][c] = keep_of(r == 0 ? v[0] : r == 1 ? v[1] : r == 2 ? v[2]
                                                                : v[3], P);
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint64_t qc = q0 + n * 8 + 2 * t;
      const uint64_t a = P.offset + (head + qc) * (uint64_t)P.T + key0 + g;
      const uint64_t b = a + P.T;
      kp[n][0] = keep_of(philox::bits(seed, a), P);
      kp[n][1] = keep_of(philox::bits(seed, b), P);
      kp[n][2] = keep_of(philox::bits(seed, a + 8), P);
      kp[n][3] = keep_of(philox::bits(seed, b + 8), P);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The bias of key j: the caller's below T, -1e30 below Tc, excluded beyond.
__device__ __forceinline__ float key_bias(const Params& P, int b, int j) {
  return j < P.T ? P.bias[(long long)b * P.T + j] : j < P.Tc ? NEG
                                                             : -INFINITY;
}

// Stores rows row0 + g (+8) of acc * mul into the first `width` columns of
// dst (row stride ld).
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* dst, int row0, int Tn, int ld,
                                           int width,
                                           const float acc[DP / 8][4],
                                           float mul0, float mul8) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= Tn) continue;
    const float mul = h ? mul8 : mul0;
    T* out = dst + (long long)row * ld;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < width) out[c] = Op<T>::from_f(acc[n][2 * h] * mul);
      if (c + 1 < width) out[c + 1] = Op<T>::from_f(acc[n][2 * h + 1] * mul);
    }
  }
}

template <typename T, int DP, int BN>
constexpr size_t fwd_smem() {
  return (size_t)(ROWS + 4 * BN) * ld<T, DP>() * sizeof(T) + 2 * BN * 4;
}
constexpr size_t SMEM_LIMIT = 232448;  // bytes of shared memory a block
template <typename T, int DP, int BN>
constexpr size_t bwd_smem() {  // two row tiles, two stages of two tiles
  return (size_t)(2 * ROWS + 4 * BN) * ld<T, DP>() * sizeof(T) +
         4 * BN * 4 + ROWS * 4;
}
// Whether the dQ pass also stages the O rows (for delta) in shared memory.
template <typename T, int DP, int BN>
constexpr bool o_staged() {
  return bwd_smem<T, DP, BN>() + (size_t)ROWS * ld<T, DP>() * sizeof(T) <=
         SMEM_LIMIT;
}

// ---------------------------------------------------------------------------
// Forward. Grid (query tiles of 64, H, B).
// ---------------------------------------------------------------------------

// Narrow heads: 4 blocks an SM (128 registers) hide the loads better than
// the 3 that the compiler's own register count leaves room for.
template <typename T, int DP, int BN>
__global__ void __launch_bounds__(THREADS, DP <= 64 ? 4 : 1)
    fwd_kernel(const Params P) {
  extern __shared__ uint4 smem_raw[];
  constexpr int LD = ld<T, DP>();
  T* qsh = reinterpret_cast<T*>(smem_raw);
  T* ksh = qsh + ROWS * LD;           // [2][BN][LD]
  T* vsh = ksh + 2 * BN * LD;         // [2][BN][LD]
  float* bsh = reinterpret_cast<float*>(vsh + 2 * BN * LD);  // [2][BN]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * P.H + h;
  const T* qg = (const T*)P.q + b * P.qs[0] + h * P.qs[1];
  const T* kg = (const T*)P.k + b * P.ks[0] + h * P.ks[1];
  const T* vg = (const T*)P.v + b * P.vs[0] + h * P.vs[1];
  const uint32_t seed = P.threshold ? (uint32_t)P.seed[0] : 0u;

  auto load_kv = [&](int j) {
    const int st = j & 1, k0 = j * BN;
    load_rows<T, DP, BN>(ksh + st * BN * LD, kg, P.ks[2], k0, P.T, P.Dh,
                         P.vec);
    load_rows<T, DP, BN>(vsh + st * BN * LD, vg, P.vs[2], k0, P.T, P.Dh,
                         P.vec);
    for (int i = threadIdx.x; i < BN; i += THREADS)
      bsh[st * BN + i] = key_bias(P, b, k0 + i);
  };
  load_rows<T, DP, ROWS>(qsh, qg, P.qs[2], q0, P.T, P.Dh, P.vec);
  load_kv(0);
  cp_async_commit();

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] =
      acc[n][3] = 0.f;
  float m0 = -INFINITY, m8 = -INFINITY, l0 = 0.f, l8 = 0.f;
  const int tiles = (P.Tc + BN - 1) / BN;
  const T* xq = qsh + warp * 16 * LD;
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) load_kv(j + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int st = j & 1;
    const float* bj = bsh + st * BN;
    float s[BN / 8][4];
    rows_x_tile<DP, BN>(xq, ksh + st * BN * LD, s);
    float x0 = -INFINITY, x8 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const float b0 = bj[n * 8 + 2 * t], b1 = bj[n * 8 + 2 * t + 1];
      s[n][0] = s[n][0] * P.scale + b0;
      s[n][1] = s[n][1] * P.scale + b1;
      s[n][2] = s[n][2] * P.scale + b0;
      s[n][3] = s[n][3] * P.scale + b1;
      x0 = fmaxf(x0, fmaxf(s[n][0], s[n][1]));
      x8 = fmaxf(x8, fmaxf(s[n][2], s[n][3]));
    }
    const float n0 = fmaxf(m0, quad_max(x0)), n8 = fmaxf(m8, quad_max(x8));
    const float c0 = __expf(m0 - n0), c8 = __expf(m8 - n8);
    m0 = n0, m8 = n8;
    float r0 = 0.f, r8 = 0.f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      s[n][0] = __expf(s[n][0] - n0);
      s[n][1] = __expf(s[n][1] - n0);
      s[n][2] = __expf(s[n][2] - n8);
      s[n][3] = __expf(s[n][3] - n8);
      r0 += s[n][0] + s[n][1];
      r8 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + r0;
    l8 = l8 * c8 + r8;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= c0, acc[n][1] *= c0, acc[n][2] *= c8, acc[n][3] *= c8;
    }
    if (P.threshold) {
      float kp[BN / 8][4];
      keep_rowmajor<BN / 8>(P, seed, bh, q0 + warp * 16, j * BN, kp);
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= kp[n][e];
    }
    acc_x_tile<DP, BN>(s, vsh + st * BN * LD, acc);
    __syncthreads();
  }
  l0 = quad_sum(l0);
  l8 = quad_sum(l8);
  const int row0 = q0 + warp * 16;
  store_rows<T, DP>((T*)P.o + bh * P.T * P.Dh, row0, P.T, P.Dh, P.Dh, acc,
                    1.f / l0, 1.f / l8);
  if (t == 0) {
    if (row0 + g < P.T) P.lse[bh * P.T + row0 + g] = m0 + logf(l0);
    if (row0 + g + 8 < P.T) P.lse[bh * P.T + row0 + g + 8] = m8 + logf(l8);
  }
}

// ---------------------------------------------------------------------------
// dQ pass. Grid (query tiles of 64, H, B). Keys beyond T add exact zeros
// (k = v = 0 or weight 0), so the loop stops at T.
// ---------------------------------------------------------------------------

template <typename T, int DP, int BN, bool OSH>
__global__ void __launch_bounds__(THREADS) dq_kernel(const Params P) {
  extern __shared__ uint4 smem_raw[];
  constexpr int LD = ld<T, DP>();
  T* qsh = reinterpret_cast<T*>(smem_raw);
  T* dosh = qsh + ROWS * LD;
  T* osh = dosh + ROWS * LD;          // [ROWS][LD] where OSH
  T* ksh = osh + (OSH ? ROWS * LD : 0);  // [2][BN][LD]
  T* vsh = ksh + 2 * BN * LD;         // [2][BN][LD]
  float* bsh = reinterpret_cast<float*>(vsh + 2 * BN * LD);  // [2][BN]
  float* dlt = bsh + 2 * BN;                                 // [ROWS]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * P.H + h;
  const T* qg = (const T*)P.q + b * P.qs[0] + h * P.qs[1];
  const T* kg = (const T*)P.k + b * P.ks[0] + h * P.ks[1];
  const T* vg = (const T*)P.v + b * P.vs[0] + h * P.vs[1];
  const T* dog = (const T*)P.d_o + b * P.dos[0] + h * P.dos[1];
  const T* og = (const T*)P.o + bh * P.T * P.Dh;
  const uint32_t seed = P.threshold ? (uint32_t)P.seed[0] : 0u;

  auto load_kv = [&](int j) {
    const int st = j & 1, k0 = j * BN;
    load_rows<T, DP, BN>(ksh + st * BN * LD, kg, P.ks[2], k0, P.T, P.Dh,
                         P.vec);
    load_rows<T, DP, BN>(vsh + st * BN * LD, vg, P.vs[2], k0, P.T, P.Dh,
                         P.vec);
    for (int i = threadIdx.x; i < BN; i += THREADS)
      bsh[st * BN + i] = k0 + i < P.T ? P.bias[(long long)b * P.T + k0 + i]
                                      : -INFINITY;
  };
  load_rows<T, DP, ROWS>(qsh, qg, P.qs[2], q0, P.T, P.Dh, P.vec);
  load_rows<T, DP, ROWS>(dosh, dog, P.dos[2], q0, P.T, P.Dh, P.vec);
  if (OSH) load_rows<T, DP, ROWS>(osh, og, P.Dh, q0, P.T, P.Dh, P.vec);
  load_kv(0);
  cp_async_commit();
  cp_async_wait0();
  __syncthreads();
  // delta = rowsum(dO * O), f32 from the stored types: two threads a row
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    float part = 0.f;
#pragma unroll 4
    for (int d = half * (DP / 2); d < (half + 1) * (DP / 2); ++d) {
      const T o = OSH ? osh[r * LD + d]
                      : (q0 + r < P.T && d < P.Dh
                             ? og[(long long)(q0 + r) * P.Dh + d]
                             : Op<T>::zero());
      part += Op<T>::to_f(dosh[r * LD + d]) * Op<T>::to_f(o);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (!half) {
      dlt[r] = part;
      if (q0 + r < P.T) P.delta[bh * P.T + q0 + r] = part;
    }
  }
  __syncthreads();
  const int row0 = q0 + warp * 16;
  const float d0 = dlt[warp * 16 + g], d8 = dlt[warp * 16 + g + 8];
  const float lse0 = row0 + g < P.T ? P.lse[bh * P.T + row0 + g] : 0.f;
  const float lse8 = row0 + g + 8 < P.T ? P.lse[bh * P.T + row0 + g + 8]
                                        : 0.f;

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] =
      acc[n][3] = 0.f;
  const int tiles = (P.T + BN - 1) / BN;
  const T* xq = qsh + warp * 16 * LD;
  const T* xdo = dosh + warp * 16 * LD;
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) load_kv(j + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int st = j & 1;
    const float* bj = bsh + st * BN;
    float s[BN / 8][4], dp[BN / 8][4];
    rows_x_tile<DP, BN>(xq, ksh + st * BN * LD, s);
    rows_x_tile<DP, BN>(xdo, vsh + st * BN * LD, dp);
    float kp[BN / 8][4];
    if (P.threshold) keep_rowmajor<BN / 8>(P, seed, bh, row0, j * BN, kp);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const float b0 = bj[n * 8 + 2 * t], b1 = bj[n * 8 + 2 * t + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] * P.scale + ((e & 1) ? b1 : b0) -
                             ((e & 2) ? lse8 : lse0));
        const float dpe = P.threshold ? dp[n][e] * kp[n][e] : dp[n][e];
        s[n][e] = p * (dpe - ((e & 2) ? d8 : d0));
      }
    }
    acc_x_tile<DP, BN>(s, ksh + st * BN * LD, acc);
    __syncthreads();
  }
  store_rows<T, DP>((T*)P.dq + bh * P.T * P.Dh, row0, P.T, P.Dh, P.Dh, acc,
                    P.scale, P.scale);
}

// ---------------------------------------------------------------------------
// dK / dV pass. Grid (key tiles of 64, H, B); queries stream. Launched after
// the dQ pass, whose delta it reads. Queries beyond T are skipped.
// ---------------------------------------------------------------------------

template <typename T, int DP, int BN>
__global__ void __launch_bounds__(THREADS) dkv_kernel(const Params P) {
  extern __shared__ uint4 smem_raw[];
  constexpr int LD = ld<T, DP>();
  T* ksh = reinterpret_cast<T*>(smem_raw);
  T* vsh = ksh + ROWS * LD;
  T* qsh = vsh + ROWS * LD;           // [2][BN][LD]
  T* dosh = qsh + 2 * BN * LD;        // [2][BN][LD]
  float* lsh = reinterpret_cast<float*>(dosh + 2 * BN * LD);  // [2][BN]
  float* dsh = lsh + 2 * BN;                                  // [2][BN]
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * P.H + h;
  const T* qg = (const T*)P.q + b * P.qs[0] + h * P.qs[1];
  const T* kg = (const T*)P.k + b * P.ks[0] + h * P.ks[1];
  const T* vg = (const T*)P.v + b * P.vs[0] + h * P.vs[1];
  const T* dog = (const T*)P.d_o + b * P.dos[0] + h * P.dos[1];
  const uint32_t seed = P.threshold ? (uint32_t)P.seed[0] : 0u;

  auto load_qdo = [&](int i) {
    const int st = i & 1, r0 = i * BN;
    load_rows<T, DP, BN>(qsh + st * BN * LD, qg, P.qs[2], r0, P.T, P.Dh,
                         P.vec);
    load_rows<T, DP, BN>(dosh + st * BN * LD, dog, P.dos[2], r0, P.T, P.Dh,
                         P.vec);
    for (int c = threadIdx.x; c < BN; c += THREADS) {
      const bool in = r0 + c < P.T;
      lsh[st * BN + c] = in ? P.lse[bh * P.T + r0 + c] : INFINITY;
      dsh[st * BN + c] = in ? P.delta[bh * P.T + r0 + c] : 0.f;
    }
  };
  load_rows<T, DP, ROWS>(ksh, kg, P.ks[2], k0, P.T, P.Dh, P.vec);
  load_rows<T, DP, ROWS>(vsh, vg, P.vs[2], k0, P.T, P.Dh, P.vec);
  load_qdo(0);
  cp_async_commit();
  const int key0 = k0 + warp * 16;
  const float bias0 = key0 + g < P.T
                          ? P.bias[(long long)b * P.T + key0 + g] : 0.f;
  const float bias8 = key0 + g + 8 < P.T
                          ? P.bias[(long long)b * P.T + key0 + g + 8] : 0.f;

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  const int tiles = (P.T + BN - 1) / BN;
  const T* xk = ksh + warp * 16 * LD;
  const T* xv = vsh + warp * 16 * LD;
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) load_qdo(i + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int st = i & 1;
    const float* li = lsh + st * BN;
    const float* di = dsh + st * BN;
    float p[BN / 8][4], dp[BN / 8][4];
    rows_x_tile<DP, BN>(xk, qsh + st * BN * LD, p);
    rows_x_tile<DP, BN>(xv, dosh + st * BN * LD, dp);
    float kp[BN / 8][4];
    if (P.threshold) keep_colmajor<BN / 8>(P, seed, bh, key0, i * BN, kp);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const float lc0 = li[n * 8 + 2 * t], lc1 = li[n * 8 + 2 * t + 1];
      const float dc0 = di[n * 8 + 2 * t], dc1 = di[n * 8 + 2 * t + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(p[n][e] * P.scale + ((e & 2) ? bias8 : bias0) -
                              ((e & 1) ? lc1 : lc0));
        const float kpe = P.threshold ? kp[n][e] : 1.f;
        p[n][e] = pe * kpe;                                   // for dV
        dp[n][e] = pe * (dp[n][e] * kpe - ((e & 1) ? dc1 : dc0));  // dS^T
      }
    }
    acc_x_tile<DP, BN>(p, dosh + st * BN * LD, dv);
    acc_x_tile<DP, BN>(dp, qsh + st * BN * LD, dk);
    __syncthreads();
  }
  store_rows<T, DP>((T*)P.dk + bh * P.T * P.Dh, key0, P.T, P.Dh, P.Dh, dk,
                    P.scale, P.scale);
  store_rows<T, DP>((T*)P.dv + bh * P.T * P.Dh, key0, P.T, P.Dh, P.Dh, dv, 1.f,
                    1.f);
}

// ---------------------------------------------------------------------------
// Heads wider than 256: the head is cut into WC-wide column chunks and the
// grid's x dimension runs over (row tile, output chunk). A block owns one
// chunk of the output rows: it accumulates S (and dP) over every chunk of
// the head, staging each chunk's rows through shared memory, then adds its
// own chunk of P.V (dS.K, P^T.dO, dS^T.Q). S is recomputed once per output
// chunk. The dropout mask, the lse and delta (over the whole head) are those
// of the kernels above; chunk 0's block writes lse and delta.
// ---------------------------------------------------------------------------

constexpr int WC = 256;

__host__ __device__ inline int chunks(int Dh) { return (Dh + WC - 1) / WC; }
__device__ __forceinline__ int chunk_width(int Dh, int c) {
  return min(WC, Dh - c * WC);
}

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS) fwd_wide_kernel(const Params P) {
  extern __shared__ uint4 smem_raw[];
  constexpr int DP = WC, LD = ld<T, DP>();
  T* qsh = reinterpret_cast<T*>(smem_raw);               // [ROWS][LD]
  T* ksh = qsh + ROWS * LD;                              // [BN][LD]
  T* vsh = ksh + BN * LD;                                // [BN][LD]
  float* bsh = reinterpret_cast<float*>(vsh + BN * LD);  // [BN]
  const int NC = chunks(P.Dh), oc = blockIdx.x % NC;
  const int q0 = (blockIdx.x / NC) * ROWS, b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * P.H + h;
  const T* qg = (const T*)P.q + b * P.qs[0] + h * P.qs[1];
  const T* kg = (const T*)P.k + b * P.ks[0] + h * P.ks[1];
  const T* vg = (const T*)P.v + b * P.vs[0] + h * P.vs[1];
  const uint32_t seed = P.threshold ? (uint32_t)P.seed[0] : 0u;

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] =
      acc[n][3] = 0.f;
  float m0 = -INFINITY, m8 = -INFINITY, l0 = 0.f, l8 = 0.f;
  const int tiles = (P.Tc + BN - 1) / BN;
  const T* xq = qsh + warp * 16 * LD;
  for (int j = 0; j < tiles; ++j) {
    const int k0 = j * BN;
    float s[BN / 8][4];
    for (int c = 0; c < NC; ++c) {
      __syncthreads();
      const int w = chunk_width(P.Dh, c);
      load_rows<T, DP, ROWS>(qsh, qg + c * WC, P.qs[2], q0, P.T, w, P.vec);
      load_rows<T, DP, BN>(ksh, kg + c * WC, P.ks[2], k0, P.T, w, P.vec);
      if (c == 0) {
        load_rows<T, DP, BN>(vsh, vg + oc * WC, P.vs[2], k0, P.T,
                             chunk_width(P.Dh, oc), P.vec);
        for (int i = threadIdx.x; i < BN; i += THREADS)
          bsh[i] = key_bias(P, b, k0 + i);
      }
      cp_async_commit();
      cp_async_wait0();
      __syncthreads();
      rows_x_tile<DP, BN>(xq, ksh, s, c == 0);
    }
    float x0 = -INFINITY, x8 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const float b0 = bsh[n * 8 + 2 * t], b1 = bsh[n * 8 + 2 * t + 1];
      s[n][0] = s[n][0] * P.scale + b0;
      s[n][1] = s[n][1] * P.scale + b1;
      s[n][2] = s[n][2] * P.scale + b0;
      s[n][3] = s[n][3] * P.scale + b1;
      x0 = fmaxf(x0, fmaxf(s[n][0], s[n][1]));
      x8 = fmaxf(x8, fmaxf(s[n][2], s[n][3]));
    }
    const float n0 = fmaxf(m0, quad_max(x0)), n8 = fmaxf(m8, quad_max(x8));
    const float c0 = __expf(m0 - n0), c8 = __expf(m8 - n8);
    m0 = n0, m8 = n8;
    float r0 = 0.f, r8 = 0.f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      s[n][0] = __expf(s[n][0] - n0);
      s[n][1] = __expf(s[n][1] - n0);
      s[n][2] = __expf(s[n][2] - n8);
      s[n][3] = __expf(s[n][3] - n8);
      r0 += s[n][0] + s[n][1];
      r8 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + r0;
    l8 = l8 * c8 + r8;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= c0, acc[n][1] *= c0, acc[n][2] *= c8, acc[n][3] *= c8;
    }
    if (P.threshold) {
      float kp[BN / 8][4];
      keep_rowmajor<BN / 8>(P, seed, bh, q0 + warp * 16, k0, kp);
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= kp[n][e];
    }
    acc_x_tile<DP, BN>(s, vsh, acc);
  }
  l0 = quad_sum(l0);
  l8 = quad_sum(l8);
  const int row0 = q0 + warp * 16;
  store_rows<T, DP>((T*)P.o + bh * P.T * P.Dh + oc * WC, row0, P.T, P.Dh,
                    chunk_width(P.Dh, oc), acc, 1.f / l0, 1.f / l8);
  if (oc == 0 && t == 0) {
    if (row0 + g < P.T) P.lse[bh * P.T + row0 + g] = m0 + logf(l0);
    if (row0 + g + 8 < P.T) P.lse[bh * P.T + row0 + g + 8] = m8 + logf(l8);
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS) dq_wide_kernel(const Params P) {
  extern __shared__ uint4 smem_raw[];
  constexpr int DP = WC, LD = ld<T, DP>();
  T* qsh = reinterpret_cast<T*>(smem_raw);  // [ROWS][LD]
  T* dosh = qsh + ROWS * LD;                // [ROWS][LD]
  T* ksh = dosh + ROWS * LD;                // [BN][LD], chunk c
  T* vsh = ksh + BN * LD;                   // [BN][LD], chunk c
  T* kosh = vsh + BN * LD;                  // [BN][LD], the block's chunk
  float* bsh = reinterpret_cast<float*>(kosh + BN * LD);  // [BN]
  float* dlt = bsh + BN;                                  // [ROWS]
  const int NC = chunks(P.Dh), oc = blockIdx.x % NC;
  const int q0 = (blockIdx.x / NC) * ROWS, b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * P.H + h;
  const T* qg = (const T*)P.q + b * P.qs[0] + h * P.qs[1];
  const T* kg = (const T*)P.k + b * P.ks[0] + h * P.ks[1];
  const T* vg = (const T*)P.v + b * P.vs[0] + h * P.vs[1];
  const T* dog = (const T*)P.d_o + b * P.dos[0] + h * P.dos[1];
  const T* og = (const T*)P.o + bh * P.T * P.Dh;
  const uint32_t seed = P.threshold ? (uint32_t)P.seed[0] : 0u;

  // delta = rowsum(dO * O) over the whole head: two threads a row
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    float part = 0.f;
    if (q0 + r < P.T) {
      const T* orow = og + (long long)(q0 + r) * P.Dh;
      const T* dorow = dog + (long long)(q0 + r) * P.dos[2];
      for (int d = half; d < P.Dh; d += 2)
        part += Op<T>::to_f(dorow[d]) * Op<T>::to_f(orow[d]);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (!half) {
      dlt[r] = part;
      if (oc == 0 && q0 + r < P.T) P.delta[bh * P.T + q0 + r] = part;
    }
  }
  __syncthreads();
  const int row0 = q0 + warp * 16;
  const float d0 = dlt[warp * 16 + g], d8 = dlt[warp * 16 + g + 8];
  const float lse0 = row0 + g < P.T ? P.lse[bh * P.T + row0 + g] : 0.f;
  const float lse8 = row0 + g + 8 < P.T ? P.lse[bh * P.T + row0 + g + 8]
                                        : 0.f;

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] =
      acc[n][3] = 0.f;
  const int tiles = (P.T + BN - 1) / BN;
  const T* xq = qsh + warp * 16 * LD;
  const T* xdo = dosh + warp * 16 * LD;
  for (int j = 0; j < tiles; ++j) {
    const int k0 = j * BN;
    float s[BN / 8][4], dp[BN / 8][4];
    for (int c = 0; c < NC; ++c) {
      __syncthreads();
      const int w = chunk_width(P.Dh, c);
      load_rows<T, DP, ROWS>(qsh, qg + c * WC, P.qs[2], q0, P.T, w, P.vec);
      load_rows<T, DP, ROWS>(dosh, dog + c * WC, P.dos[2], q0, P.T, w, P.vec);
      load_rows<T, DP, BN>(ksh, kg + c * WC, P.ks[2], k0, P.T, w, P.vec);
      load_rows<T, DP, BN>(vsh, vg + c * WC, P.vs[2], k0, P.T, w, P.vec);
      if (c == 0) {
        load_rows<T, DP, BN>(kosh, kg + oc * WC, P.ks[2], k0, P.T,
                             chunk_width(P.Dh, oc), P.vec);
        for (int i = threadIdx.x; i < BN; i += THREADS)
          bsh[i] = k0 + i < P.T ? P.bias[(long long)b * P.T + k0 + i]
                                : -INFINITY;
      }
      cp_async_commit();
      cp_async_wait0();
      __syncthreads();
      rows_x_tile<DP, BN>(xq, ksh, s, c == 0);
      rows_x_tile<DP, BN>(xdo, vsh, dp, c == 0);
    }
    float kp[BN / 8][4];
    if (P.threshold) keep_rowmajor<BN / 8>(P, seed, bh, row0, k0, kp);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const float b0 = bsh[n * 8 + 2 * t], b1 = bsh[n * 8 + 2 * t + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] * P.scale + ((e & 1) ? b1 : b0) -
                             ((e & 2) ? lse8 : lse0));
        const float dpe = P.threshold ? dp[n][e] * kp[n][e] : dp[n][e];
        s[n][e] = p * (dpe - ((e & 2) ? d8 : d0));
      }
    }
    acc_x_tile<DP, BN>(s, kosh, acc);
  }
  store_rows<T, DP>((T*)P.dq + bh * P.T * P.Dh + oc * WC, row0, P.T, P.Dh,
                    chunk_width(P.Dh, oc), acc, P.scale, P.scale);
}

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS) dkv_wide_kernel(const Params P) {
  extern __shared__ uint4 smem_raw[];
  constexpr int DP = WC, LD = ld<T, DP>();
  T* ksh = reinterpret_cast<T*>(smem_raw);  // [ROWS][LD], chunk c
  T* vsh = ksh + ROWS * LD;                 // [ROWS][LD], chunk c
  T* qsh = vsh + ROWS * LD;                 // [BN][LD], chunk c
  T* dosh = qsh + BN * LD;                  // [BN][LD], chunk c
  T* qosh = dosh + BN * LD;                 // [BN][LD], the block's chunk
  T* doosh = qosh + BN * LD;                // [BN][LD], the block's chunk
  float* lsh = reinterpret_cast<float*>(doosh + BN * LD);  // [BN]
  float* dsh = lsh + BN;                                   // [BN]
  const int NC = chunks(P.Dh), oc = blockIdx.x % NC;
  const int k0 = (blockIdx.x / NC) * ROWS, b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * P.H + h;
  const T* qg = (const T*)P.q + b * P.qs[0] + h * P.qs[1];
  const T* kg = (const T*)P.k + b * P.ks[0] + h * P.ks[1];
  const T* vg = (const T*)P.v + b * P.vs[0] + h * P.vs[1];
  const T* dog = (const T*)P.d_o + b * P.dos[0] + h * P.dos[1];
  const uint32_t seed = P.threshold ? (uint32_t)P.seed[0] : 0u;
  const int key0 = k0 + warp * 16;
  const float bias0 = key0 + g < P.T
                          ? P.bias[(long long)b * P.T + key0 + g] : 0.f;
  const float bias8 = key0 + g + 8 < P.T
                          ? P.bias[(long long)b * P.T + key0 + g + 8] : 0.f;

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  const int tiles = (P.T + BN - 1) / BN;
  const T* xk = ksh + warp * 16 * LD;
  const T* xv = vsh + warp * 16 * LD;
  for (int i = 0; i < tiles; ++i) {
    const int r0 = i * BN;
    float p[BN / 8][4], dp[BN / 8][4];
    for (int c = 0; c < NC; ++c) {
      __syncthreads();
      const int w = chunk_width(P.Dh, c);
      load_rows<T, DP, ROWS>(ksh, kg + c * WC, P.ks[2], k0, P.T, w, P.vec);
      load_rows<T, DP, ROWS>(vsh, vg + c * WC, P.vs[2], k0, P.T, w, P.vec);
      load_rows<T, DP, BN>(qsh, qg + c * WC, P.qs[2], r0, P.T, w, P.vec);
      load_rows<T, DP, BN>(dosh, dog + c * WC, P.dos[2], r0, P.T, w, P.vec);
      if (c == 0) {
        const int wo = chunk_width(P.Dh, oc);
        load_rows<T, DP, BN>(qosh, qg + oc * WC, P.qs[2], r0, P.T, wo,
                             P.vec);
        load_rows<T, DP, BN>(doosh, dog + oc * WC, P.dos[2], r0, P.T, wo,
                             P.vec);
        for (int cc = threadIdx.x; cc < BN; cc += THREADS) {
          const bool in = r0 + cc < P.T;
          lsh[cc] = in ? P.lse[bh * P.T + r0 + cc] : INFINITY;
          dsh[cc] = in ? P.delta[bh * P.T + r0 + cc] : 0.f;
        }
      }
      cp_async_commit();
      cp_async_wait0();
      __syncthreads();
      rows_x_tile<DP, BN>(xk, qsh, p, c == 0);
      rows_x_tile<DP, BN>(xv, dosh, dp, c == 0);
    }
    float kp[BN / 8][4];
    if (P.threshold) keep_colmajor<BN / 8>(P, seed, bh, key0, r0, kp);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const float lc0 = lsh[n * 8 + 2 * t], lc1 = lsh[n * 8 + 2 * t + 1];
      const float dc0 = dsh[n * 8 + 2 * t], dc1 = dsh[n * 8 + 2 * t + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(p[n][e] * P.scale + ((e & 2) ? bias8 : bias0) -
                              ((e & 1) ? lc1 : lc0));
        const float kpe = P.threshold ? kp[n][e] : 1.f;
        p[n][e] = pe * kpe;
        dp[n][e] = pe * (dp[n][e] * kpe - ((e & 1) ? dc1 : dc0));
      }
    }
    acc_x_tile<DP, BN>(p, doosh, dv);
    acc_x_tile<DP, BN>(dp, qosh, dk);
  }
  const int wo = chunk_width(P.Dh, oc);
  store_rows<T, DP>((T*)P.dk + bh * P.T * P.Dh + oc * WC, key0, P.T, P.Dh,
                    wo, dk, P.scale, P.scale);
  store_rows<T, DP>((T*)P.dv + bh * P.T * P.Dh + oc * WC, key0, P.T, P.Dh,
                    wo, dv, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int DP>
cudaError_t launch(const Params& P, bool backward, cudaStream_t s) {
  // 64 streamed rows; 32 for wider heads (registers), 16 for f32 heads of
  // 256 (shared memory)
  constexpr int BN = DP <= 64 ? 64 : (DP == 256 && sizeof(T) == 4) ? 16 : 32;
  const dim3 grid((P.T + ROWS - 1) / ROWS, P.H, P.B);
  cudaError_t e;
  if (!backward) {
    constexpr size_t smem = fwd_smem<T, DP, BN>();
    e = allow_smem(fwd_kernel<T, DP, BN>, smem);
    if (e != cudaSuccess) return e;
    fwd_kernel<T, DP, BN><<<grid, THREADS, smem, s>>>(P);
    return cudaGetLastError();
  }
  constexpr size_t smem = bwd_smem<T, DP, BN>();
  constexpr bool osh = o_staged<T, DP, BN>();
  constexpr size_t dq_smem = smem + (osh ? ROWS * ld<T, DP>() * sizeof(T) : 0);
  e = allow_smem(dq_kernel<T, DP, BN, osh>, dq_smem);
  if (e != cudaSuccess) return e;
  e = allow_smem(dkv_kernel<T, DP, BN>, smem);
  if (e != cudaSuccess) return e;
  dq_kernel<T, DP, BN, osh><<<grid, THREADS, dq_smem, s>>>(P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkv_kernel<T, DP, BN><<<grid, THREADS, smem, s>>>(P);
  return cudaGetLastError();
}

// Heads wider than WC: 32 streamed rows (16 for f32, for shared memory).
template <typename T>
cudaError_t launch_wide(const Params& P, bool backward, cudaStream_t s) {
  constexpr int BN = sizeof(T) == 4 ? 16 : 32;
  constexpr size_t row = (size_t)ld<T, WC>() * sizeof(T);
  const dim3 grid((P.T + ROWS - 1) / ROWS * chunks(P.Dh), P.H, P.B);
  cudaError_t e;
  if (!backward) {
    constexpr size_t smem = (ROWS + 2 * BN) * row + BN * 4;
    e = allow_smem(fwd_wide_kernel<T, BN>, smem);
    if (e != cudaSuccess) return e;
    fwd_wide_kernel<T, BN><<<grid, THREADS, smem, s>>>(P);
    return cudaGetLastError();
  }
  constexpr size_t dq_smem = (2 * ROWS + 3 * BN) * row + (BN + ROWS) * 4;
  constexpr size_t dkv_smem = (2 * ROWS + 4 * BN) * row + 2 * BN * 4;
  static_assert(dkv_smem <= SMEM_LIMIT && dq_smem <= SMEM_LIMIT, "smem");
  e = allow_smem(dq_wide_kernel<T, BN>, dq_smem);
  if (e != cudaSuccess) return e;
  e = allow_smem(dkv_wide_kernel<T, BN>, dkv_smem);
  if (e != cudaSuccess) return e;
  dq_wide_kernel<T, BN><<<grid, THREADS, dq_smem, s>>>(P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkv_wide_kernel<T, BN><<<grid, THREADS, dkv_smem, s>>>(P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const Params& P, bool backward, cudaStream_t s) {
  if (P.Dh > WC) return launch_wide<T>(P, backward, s);
  if (P.Dh <= 32) return launch<T, 32>(P, backward, s);
  if (P.Dh <= 64) return launch<T, 64>(P, backward, s);
  if (P.Dh <= 128) return launch<T, 128>(P, backward, s);
  return launch<T, 256>(P, backward, s);
}

inline bool shape_ok(const Params& P) {
  return P.B > 0 && P.B <= 65535 && P.H > 0 && P.H <= 65535 && P.T > 0 &&
         P.Tc >= P.T && P.Dh > 0 &&
         (long long)(P.T + ROWS - 1) / ROWS * chunks(P.Dh) < (1LL << 31);
}

// Whether every row of q, k, v (and dO) starts on 16 bytes, so that the
// tiles can be copied by cp.async in 16-byte chunks.
inline int rows_aligned(const Params& P, int esize, bool backward) {
  const int epc = 16 / esize;
  if (P.Dh % epc) return 0;
  const void* ptrs[4] = {P.q, P.k, P.v, P.d_o};
  const long long* strides[4] = {P.qs, P.ks, P.vs, P.dos};
  for (int i = 0; i < (backward ? 4 : 3); ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return 0;
    for (int j = 0; j < 3; ++j)
      if (strides[i][j] % epc) return 0;
  }
  return 1;
}

inline int dispatch(Params P, int dtype, bool backward, void* stream) {
  if (!shape_ok(P)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    P.vec = rows_aligned(P, 4, backward);
    return (int)run<float>(P, backward, s);
  }
  if (dtype == 1) {
    P.vec = rows_aligned(P, 2, backward);
    return (int)run<__nv_bfloat16>(P, backward, s);
  }
  return (int)cudaErrorInvalidValue;
}

inline void set_strides(long long* dst, const long long* src) {
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
}

}  // namespace tc
