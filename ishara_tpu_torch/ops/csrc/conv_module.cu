// The Squeezeformer conv-module branch with its residual for training on
// Hopper (sm_90a), forward and backward:
//   out = x + SE(pw2(swish(causal_dw(swish(pw1(LN(x)))))))
//
// Replaces the Pallas kernels _fwd_kernel and _bwd_kernel of
// ishara_tpu/ops/conv_kernel.py (behind conv_module_residual). x, out, dy,
// dx are [B, T, D] in the compute type (bf16 or f32), w1 [D, E] and w2
// [E, D] of that type; LN scale and bias, b1, the depthwise taps wdw [K, E],
// b2 and the SqueezeExcite weights wf1 [D, r], bf1, wf2 [r, D], bf2 are f32,
// and so is every weight gradient; the mask [B, T] is f32 and feeds the SE
// pool only (msum = max(sum mask, 1)).
//
// Rounding points as the reference: the two pointwise products take
// operands of the compute type and accumulate in f32; LN (eps 1e-6), both
// swishes, the causal depthwise conv, the SE gate and the residual are f32;
// xn and s are rounded to the compute type before their products, the
// output once on the way out. Backward: dp = dy * g + dpool * (m / msum)
// (f32, summed into db2 unrounded) is rounded for dw2 = s^T dp and ds = dp
// w2^T; dc = ds * swish'(c); da is the anticausal conv of dc; du = da *
// swish'(u) (f32, summed into db1) is rounded for dw1 = xn^T du and dxn =
// du w1^T; LN's backward and dx = dy + dx_ln are f32, rounded once.
//
// Three designs, the first chosen by a rule on the shape (cwg::plan,
// mirrored by conv_kernel.conv_plan; a launch it refuses fails, nothing
// falls back): bf16 with D a multiple of 64 up to 256, E a multiple of 64
// and at most 16 taps -- every preset's training geometry -- takes the
// wgmma design of conv_wg.cuh (warpgroup products fed by TMA weight rings);
// every other shape takes the tile kernels below, or the general path
// where no tile fits. The forward keeps p = pw2(...) + b2 (f32, the
// caller's tensor), and the backward takes the SE gate and its backward
// from it instead of running the forward again.
//
// Design: time tiles with a halo. The TPU kernel holds a whole [T, E] slab
// of a sequence in VMEM; an SM cannot (1 MB at T 512, E 512 in f32). Only
// the SE pool and the causal conv couple time across a sequence, and the
// depthwise conv is independent per channel, so a block owns a tile of TT
// rows of one sequence plus the conv's halo of H = K rounded up to 16 rows
// (zero rows before t = 0; the taps are front-padded with zeros to H), and
// keeps every per-channel intermediate in
// shared memory:
//   forward, 3 launches: (1) the tile kernel: LN of its TT + H rows (xn
//   rounded, in shared memory); then for each chunk of EC channels: u = xn
//   w1[:, chunk] + b1 on the tensor cores, a = swish(u) (f32, shared), c =
//   the causal conv over the tile's rows, s = swish(c) rounded, and p += s
//   w2[chunk, :] accumulated in registers across the chunks; epilogue p + b2,
//   written once (f32, kept for the backward), with its masked pool
//   partials for each (tile, channel); (2) the SE gate, one block a
//   sequence, from the partials summed in tile order; (3) out = p * g + x.
//   backward, 2 launches before the weight products: (1) the SE gate and
//   its backward per sequence (pool and dgate = the sums over the forward's
//   tiles, in order, of each tile's sums of m p and dy p over its rows, one
//   pass over the kept p; dpool, what the SE weight gradients need); (2)
//   the backward tile kernel, a halo on both sides: LN of [t0 - H, t0 + TT
//   + H), dp of [t0, t0 + TT + H) (needs no recomputed p); for each
//   chunk: u and a over all its rows, ds = dp w2^T, dc = ds swish'(c), s of
//   its own rows, da by the anticausal conv, du = da swish'(u), and dxn +=
//   du w1^T in registers; then LN's backward with dx =
//   dy + dx_ln written once, and per-tile partials of db1, db2, dwdw, dgamma
//   and dbeta. It writes xn, dp, s and du in the compute type for the weight
//   products. Then (3) dw1 = xn^T du and dw2 = s^T dp (wgrad.cuh), the SE
//   weight gradients, and five fixed-order sums of the partials: 10
//   launches in all (the wgmma design's backward the same, its tile kernel
//   conv_wg.cuh's). No atomics: every gradient is the same from run to run.
// The weight chunks stream by cp.async into shared memory while the other
// operand's products run (w1's chunks double-buffered in the backward); the
// products are mma.sync m16n8k16 bf16, or 3xTF32 m16n8k8 at f32
// (mma.cuh). Widths off the tensor-core grid are zero-padded (D to 16,
// the last channel chunk); the tile height TT (16 to 64 rows), the chunk
// width EC and the accumulator layout come from the caller's plan
// (conv_kernel.py), which takes the largest tile whose working set fits in
// shared memory. A width that fits in none (D beyond ~500 at f32, ~600 at
// bf16) takes the general path at the end of this file: the same function
// as a chain of row-tiled kernels passing sequence-sized f32 intermediates
// through device memory (6 launches forward, 19 backward, which takes the
// forward's p and so skips its second product).
// Any number of depthwise taps: a halo above 32 rows takes its u and ds
// products in passes of a warp's m-tiles and its taps 16 at a time, and a
// K whose halo no tile holds takes the general path as well.
//
// Bound: operations. At B 256, T 512, D 256, E 512, K 15 in bf16 the
// products are 69 GFLOP forward (77 with the halo recomputed) and 172
// backward. Bytes at that shape: ~0.5 GB forward (x, p written and read
// once in f32, out); ~1.6 GB backward (the kept p read once, x and dy read
// again for the halos
// and LN's backward, dx, the four compute-type operands of the weight
// products written and read once, the dwdw partials), against ~2.5 GB of
// f32 intermediates in the chain.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "conv_wg.cuh"
#include "mma.cuh"
#include "wgrad.cuh"

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr float LN_EPS = 1e-6f;
constexpr int THREADS = 256;
constexpr int BM = 64, BN = 64, BK = 32;  // product tile
constexpr int APAD = 8, BPAD = 8, CPAD = 4;
constexpr int ROWS = 64;  // rows a block of the row kernels sums over

using wgrad::narrow;
using wgrad::widen;

// The fast exponential and division (within a few ulp of f32): the swishes
// of every element cost as much as the products with the IEEE forms. A huge
// -v gives exp = inf and 1 / inf = 0, as the exact form does.
__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}
// d/dh [h * sigmoid(h)] given sig = sigmoid(h)
__device__ __forceinline__ float dswish(float h, float sig) {
  return sig + h * sig * (1.f - sig);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Time tiles with a halo (the design at the top of this file)
// ---------------------------------------------------------------------------

// Depthwise taps the register-resident conv forms hold (halos of 16 and 32
// rows) and the row kernels keep in registers at once. Wider kernels take
// their taps in chunks: 16 at a time in the tile kernels (conv_swish_n and
// friends), MAXK at a time in the row kernels. The tile kernels' taps
// buffer is K rounded up to 32 rows (taps_rows), so at K <= 32 it is the
// 32 rows it always was.
constexpr int MAXK = 32;
__host__ __device__ constexpr int taps_rows(int H) {
  return (H + 31) / 32 * 32;
}

// Everything a tile kernel reads and writes; pointers that a launch does not
// use are null.
struct TileArgs {
  const void *x, *dy, *w1, *w2;  // compute type
  const float *mask, *gamma, *beta, *b1, *wdw, *b2;
  float* p;                      // forward: p = pw2(...) + b2 [B, T, D]
  float* part_mp;                // [B, tiles, D]: sum m * p
  const float *gate, *dpool, *msum;  // [B, D], [B, D], [B]
  void *dx, *xn_g, *dp_g, *s_g, *du_g;  // compute type
  float *part_ln, *part_e, *part_db2;   // [B, tiles] x [2D], [E + KE], [D]
  int B, T, D, E, K, Dk, H, tiles, vec;
};

// Shared-memory regions start on 128 bytes.
__host__ __device__ constexpr size_t rup(size_t b) { return (b + 127) / 128 * 128; }

// The tile kernels' shared memory: forward (xn, a, s, w1 chunk, w2 chunk)
// or backward (xn, dp, a, own u, ds/dc, du, two w1 chunks, w2 chunk, LN row
// statistics), and the chunk's depthwise taps and b1. Row strides: Dk + 16 bytes, EC + 16 bytes for operands of
// the products, EC + 1 floats for the f32 per-channel buffers.
template <typename T, int MTP, int EC>
__host__ __device__ size_t tile_smem(bool backward, int Dk, int H) {
  constexpr int TT = 16 * MTP, PADT = 16 / (int)sizeof(T);
  const size_t sz = sizeof(T), LDD = Dk + PADT, ECL = EC + PADT, ECF = EC + 1;
  const size_t chunk = rup((size_t)taps_rows(H) * EC * 4) + rup(EC * 4);
  if (!backward) {
    const size_t R = TT + H;
    return rup(R * LDD * sz) + rup(R * ECF * 4) + rup(TT * ECL * sz) +
           rup(Dk * ECL * sz) + rup(EC * LDD * sz) + chunk;
  }
  const size_t RU = TT + 2 * H, RC = TT + H;
  return rup(RU * LDD * sz) + rup(RC * LDD * sz) + rup(RU * ECF * 4) +
         rup(TT * ECF * 4) + rup(RC * ECF * 4) + rup(TT * ECL * sz) +
         2 * rup(Dk * ECL * sz) + rup(EC * LDD * sz) + rup(2 * TT * 4) + chunk;
}

struct Carve2 {
  unsigned char* p;
  template <typename X>
  __device__ X* take(size_t count) {
    X* out = reinterpret_cast<X*>(p);
    p += rup(count * sizeof(X));
    return out;
  }
};

// LN of rows [tbase, tbase + R) of sequence b into xn [R][LDD] in the
// compute type, one warp a row; rows before 0 or past T, and columns past D,
// are zeros. Rows [own0, own0 + TT) also leave their mean and rstd in stats
// [2][TT] (when given).
template <typename T>
__device__ void ln_rows(const TileArgs& P, int b, int tbase, int R, T* xn,
                        int LDD, float* stats, int own0, int TT) {
  constexpr int NV = 16, W = THREADS / 32;  // rows up to 512 in registers
  constexpr int RW = 4;                      // rows a warp has in flight
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* x = (const T*)P.x;
  float gm[NV], bt[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int d = lane + 32 * i;
    gm[i] = d < P.D ? P.gamma[d] : 0.f;
    bt[i] = d < P.D ? P.beta[d] : 0.f;
  }
  for (int r0 = warp; r0 < R; r0 += RW * W) {
    float v[RW][NV];
#pragma unroll
    for (int h = 0; h < RW; ++h) {
      const int tg = tbase + r0 + h * W;
      const bool in = r0 + h * W < R && tg >= 0 && tg < P.T;
      const T* xr = x + ((long long)b * P.T + tg) * P.D;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int d = lane + 32 * i;
        v[h][i] = in && d < P.D ? widen(xr[d]) : 0.f;
      }
    }
#pragma unroll
    for (int h = 0; h < RW; ++h) {
      const int r = r0 + h * W, tg = tbase + r;
      if (r >= R) break;
      T* row = xn + r * LDD;
      if (tg < 0 || tg >= P.T) {
        for (int d = lane; d < P.Dk; d += 32) row[d] = narrow<T>(0.f);
        continue;
      }
      const T* xr = x + ((long long)b * P.T + tg) * P.D;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) s += v[h][i];
      for (int d = lane + 32 * NV; d < P.D; d += 32) s += widen(xr[d]);
      const float mu = warp_sum(s) / P.D;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float c = lane + 32 * i < P.D ? v[h][i] - mu : 0.f;
        q += c * c;
      }
      for (int d = lane + 32 * NV; d < P.D; d += 32) {
        const float c = widen(xr[d]) - mu;
        q += c * c;
      }
      const float rstd = rsqrtf(warp_sum(q) / P.D + LN_EPS);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int d = lane + 32 * i;
        if (d < P.D) row[d] = narrow<T>((v[h][i] - mu) * rstd * gm[i] + bt[i]);
      }
      for (int d = lane + 32 * NV; d < P.D; d += 32)
        row[d] = narrow<T>((widen(xr[d]) - mu) * rstd * P.gamma[d] +
                           P.beta[d]);
      for (int d = P.D + lane; d < P.Dk; d += 32) row[d] = narrow<T>(0.f);
      if (stats && lane == 0 && r >= own0 && r < own0 + TT) {
        stats[r - own0] = mu;
        stats[TT + r - own0] = rstd;
      }
    }
  }
}

// Channel chunk c of w1 [D, E] as [Dk][EC + PADT] and of w2 [E, D] as
// [EC][Dk + PADT], zero past D and E.
template <typename T, int EC>
__device__ __forceinline__ void load_w1(const TileArgs& P, int c, T* dst) {
  constexpr int ECL = EC + 16 / (int)sizeof(T);
  tc::load_tile<T>(dst, ECL, (const T*)P.w1 + c * EC, P.E, P.Dk, EC, P.D,
                   P.E - c * EC, P.vec, threadIdx.x, THREADS);
}
template <typename T, int EC>
__device__ __forceinline__ void load_w2(const TileArgs& P, int c, T* dst) {
  const int LDD = P.Dk + 16 / (int)sizeof(T);
  tc::load_tile<T>(dst, LDD, (const T*)P.w2 + (size_t)c * EC * P.D, P.D, EC,
                   P.Dk, P.E - c * EC, P.D, P.vec, threadIdx.x, THREADS);
}

// The chunk's depthwise taps and b1 [EC] into shared memory, plain loads
// (the caller synchronises). The taps are front-padded to H = K rounded up
// to 16: taps[j][e] = wdw[j - (H - K)][e] for j >= H - K, zero before (and
// past E), so every window is H taps long and its loops need no bound.
template <int EC>
__device__ __forceinline__ void load_chunk(const TileArgs& P, int c,
                                           float* taps, float* b1c) {
  for (int i = threadIdx.x; i < P.H * EC; i += THREADS) {
    const int k = i / EC - (P.H - P.K), ec = c * EC + i % EC;
    taps[i] = (k >= 0 && k < P.K && ec < P.E) ? P.wdw[k * P.E + ec] : 0.f;
  }
  for (int i = threadIdx.x; i < EC; i += THREADS)
    b1c[i] = c * EC + i < P.E ? P.b1[c * EC + i] : 0.f;
}

// Forward: s = swish(c) of the TT own rows, rounded into sch, where c[t] =
// sum_j taps[j] a[t - (KP - 1) + j] and a's row t0 + tt sits at row tt + KP
// of ach (KP = H). A thread keeps one channel.
template <typename T, int KP, int EC, int TT>
__device__ __forceinline__ void conv_swish(const float* ach,
                                           const float* taps, T* sch) {
  constexpr int ECF = EC + 1, ECL = EC + 16 / (int)sizeof(T);
  const int e = threadIdx.x % EC;
  float w[KP];
#pragma unroll
  for (int j = 0; j < KP; ++j) w[j] = taps[j * EC + e];
  for (int tt = threadIdx.x / EC; tt < TT; tt += THREADS / EC) {
    const float* a = ach + (tt + 1) * ECF + e;
    float cv = 0.f;
#pragma unroll
    for (int j = 0; j < KP; ++j) cv += w[j] * a[j * ECF];
    sch[tt * ECL + e] = narrow<T>(cv * sigmoid(cv));
  }
}

// Backward, first per-channel pass over the RC rows t0 .. of dcs: c by the
// causal conv, dc = ds swish'(c) in place, s of the own rows to s_g.
template <typename T, int KP, int EC>
__device__ __forceinline__ void conv_dc(const TileArgs& P, const float* ach,
                                        const float* taps, float* dcs, int RC,
                                        int TT, int t0, int c,
                                        long long seq) {
  constexpr int ECF = EC + 1;
  const int e = threadIdx.x % EC, ec = c * EC + e;
  float w[KP];
#pragma unroll
  for (int j = 0; j < KP; ++j) w[j] = taps[j * EC + e];
  for (int q = threadIdx.x / EC; q < RC; q += THREADS / EC) {
    const float* a = ach + (q + 1) * ECF + e;
    float cv = 0.f;
#pragma unroll
    for (int j = 0; j < KP; ++j) cv += w[j] * a[j * ECF];
    const float sg = sigmoid(cv);
    dcs[q * ECF + e] *= dswish(cv, sg);
    if (q < TT && t0 + q < P.T && ec < P.E)
      ((T*)P.s_g)[(seq + t0 + q) * P.E + ec] = narrow<T>(cv * sg);
  }
}

// Backward, second per-channel pass over the own rows: da by the anticausal
// conv, du = da swish'(u) rounded into dus, and the tile's sums of du (db1)
// and of a[t - K + 1 + k] dc[t] (dwdw[k]) into part_e. Warp w owns channels
// w, w + 8, ..; lane l the rows l, l + 32; the sums over rows are a fixed
// butterfly across the lanes.
template <typename T, int KP, int EC, int TT>
__device__ __forceinline__ void conv_du(const TileArgs& P, const float* ach,
                                        const float* uown, const float* dcs,
                                        const float* taps, T* dus, int t0,
                                        int c, long long part) {
  constexpr int ECF = EC + 1, ECL = EC + 16 / (int)sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = warp; e < EC; e += THREADS / 32) {
    const int ec = c * EC + e;
    float w[KP], dw[KP];
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      w[j] = taps[j * EC + e];
      dw[j] = 0.f;
    }
    float db = 0.f;
    for (int tt = lane; tt < TT; tt += 32) {
      const float* dc = dcs + (tt + KP - 1) * ECF + e;
      float dav = 0.f;
#pragma unroll
      for (int j = 0; j < KP; ++j) dav += w[j] * dc[-j * ECF];
      const float u = uown[tt * ECF + e];
      const float du = dav * dswish(u, sigmoid(u));
      dus[tt * ECL + e] = narrow<T>(du);
      if (t0 + tt < P.T) {
        db += du;
        const float dct = dcs[tt * ECF + e];
        const float* a = ach + (tt + 1) * ECF + e;
#pragma unroll
        for (int j = 0; j < KP; ++j) dw[j] += a[j * ECF] * dct;
      }
    }
    db = warp_sum(db);
#pragma unroll
    for (int j = 0; j < KP; ++j) dw[j] = warp_sum(dw[j]);
    if (lane == 0 && ec < P.E) {
      float* pe = P.part_e + part * (P.E + (long long)P.K * P.E);
      pe[ec] = db;
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        const int k = j - (KP - P.K);
        if (k >= 0) pe[P.E + (long long)k * P.E + ec] = dw[j];
      }
    }
  }
}

// The same three passes for a halo of any H (a multiple of 16 above 32):
// the taps are read from shared memory 16 at a time, summed in the order
// of the forms above. conv_du_n sums dwdw one chunk of 16 taps at a time,
// after the pass that writes du.
template <typename T, int EC, int TT>
__device__ void conv_swish_n(const float* ach, const float* taps, T* sch,
                             int H) {
  constexpr int ECF = EC + 1, ECL = EC + 16 / (int)sizeof(T);
  const int e = threadIdx.x % EC;
  for (int tt = threadIdx.x / EC; tt < TT; tt += THREADS / EC) {
    const float* a = ach + (tt + 1) * ECF + e;
    float cv = 0.f;
    for (int j0 = 0; j0 < H; j0 += 16)
#pragma unroll
      for (int j = j0; j < j0 + 16; ++j) cv += taps[j * EC + e] * a[j * ECF];
    sch[tt * ECL + e] = narrow<T>(cv * sigmoid(cv));
  }
}

template <typename T, int EC>
__device__ void conv_dc_n(const TileArgs& P, const float* ach,
                          const float* taps, float* dcs, int RC, int TT,
                          int t0, int c, long long seq) {
  constexpr int ECF = EC + 1;
  const int e = threadIdx.x % EC, ec = c * EC + e;
  for (int q = threadIdx.x / EC; q < RC; q += THREADS / EC) {
    const float* a = ach + (q + 1) * ECF + e;
    float cv = 0.f;
    for (int j0 = 0; j0 < P.H; j0 += 16)
#pragma unroll
      for (int j = j0; j < j0 + 16; ++j) cv += taps[j * EC + e] * a[j * ECF];
    const float sg = sigmoid(cv);
    dcs[q * ECF + e] *= dswish(cv, sg);
    if (q < TT && t0 + q < P.T && ec < P.E)
      ((T*)P.s_g)[(seq + t0 + q) * P.E + ec] = narrow<T>(cv * sg);
  }
}

template <typename T, int EC, int TT>
__device__ void conv_du_n(const TileArgs& P, const float* ach,
                          const float* uown, const float* dcs,
                          const float* taps, T* dus, int t0, int c,
                          long long part) {
  constexpr int ECF = EC + 1, ECL = EC + 16 / (int)sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, H = P.H;
  for (int e = warp; e < EC; e += THREADS / 32) {
    const int ec = c * EC + e;
    float* pe = P.part_e + part * (P.E + (long long)P.K * P.E);
    float db = 0.f;
    for (int tt = lane; tt < TT; tt += 32) {
      const float* dc = dcs + (tt + H - 1) * ECF + e;
      float dav = 0.f;
      for (int j0 = 0; j0 < H; j0 += 16)
#pragma unroll
        for (int j = j0; j < j0 + 16; ++j)
          dav += taps[j * EC + e] * dc[-j * ECF];
      const float u = uown[tt * ECF + e];
      const float du = dav * dswish(u, sigmoid(u));
      dus[tt * ECL + e] = narrow<T>(du);
      if (t0 + tt < P.T) db += du;
    }
    db = warp_sum(db);
    if (lane == 0 && ec < P.E) pe[ec] = db;
    for (int j0 = 0; j0 < H; j0 += 16) {
      float dw[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) dw[j] = 0.f;
      for (int tt = lane; tt < TT && t0 + tt < P.T; tt += 32) {
        const float dct = dcs[tt * ECF + e];
        const float* a = ach + (tt + 1 + j0) * ECF + e;
#pragma unroll
        for (int j = 0; j < 16; ++j) dw[j] += a[j * ECF] * dct;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        dw[j] = warp_sum(dw[j]);
        const int k = j0 + j - (H - P.K);
        if (lane == 0 && ec < P.E && k >= 0)
          pe[P.E + (long long)k * P.E + ec] = dw[j];
      }
    }
  }
}

// Forward tile kernel, grid (tiles, B). A tile of TT = 16 MTP rows; warp w
// accumulates p's columns [w * 8 NTP, (w + 1) * 8 NTP) for all TT rows, so
// Dk <= 64 NTP. The u product: warp (mg, ng) owns 16 channels ng * 16 .. of
// the chunk and the m-tiles mg, mg + MG, ... of the R = TT + H rows.
template <typename T, int MTP, int NTP, int EC>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_tile_kernel(const TileArgs P) {
  constexpr int TT = 16 * MTP, PADT = 16 / (int)sizeof(T);
  constexpr int ECL = EC + PADT, ECF = EC + 1;
  constexpr int NG = EC / 16, MG = (THREADS / 32) / NG;
  constexpr int MU = (MTP + 2 + MG - 1) / MG;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dk = P.Dk, H = P.H, R = TT + H, LDD = Dk + PADT;
  Carve2 cv{smem};
  T* xn = cv.take<T>((size_t)R * LDD);
  float* ach = cv.take<float>((size_t)R * ECF);
  T* sch = cv.take<T>((size_t)TT * ECL);
  T* w1c = cv.take<T>((size_t)Dk * ECL);
  T* w2c = cv.take<T>((size_t)EC * LDD);
  float* taps = cv.take<float>((size_t)taps_rows(H) * EC);
  float* b1c = cv.take<float>(EC);
  const int tile = blockIdx.x, b = blockIdx.y, t0 = tile * TT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nch = (P.E + EC - 1) / EC;
  const int mg = warp / NG, ng = warp % NG;
  const int mcount = (R / 16 - mg + MG - 1) / MG;
  const int pcount = min(NTP, max(0, (Dk - warp * NTP * 8) / 8));

  load_w1<T, EC>(P, 0, w1c);
  tc::cp_async_commit();
  load_w2<T, EC>(P, 0, w2c);
  tc::cp_async_commit();
  ln_rows<T>(P, b, t0 - H, R, xn, LDD, nullptr, 0, TT);

  float acc[MTP][NTP][4];
  tc::zero_acc(acc);
  for (int c = 0; c < nch; ++c) {
    load_chunk<EC>(P, c, taps, b1c);  // the last chunk's readers are done
    tc::cp_async_wait<1>();  // this chunk's w1 (its w2 may be in flight)
    __syncthreads();
    // a = swish(xn w1 + b1) over all R rows, 0 before t = 0, MU of a
    // warp's m-tiles a pass (one pass unless the halo is above 32 rows)
    for (int i0 = 0; i0 < mcount; i0 += MU) {
      float ua[MU][2][4];
      tc::zero_acc(ua);
      tc::warp_mma<MU, 2, false, true>(ua, xn + (mg + i0 * MG) * 16 * LDD,
                                       LDD, MG * 16, w1c + ng * 16, ECL, Dk,
                                       mcount - i0);
#pragma unroll
      for (int i = 0; i < MU; ++i) {
        if (i0 + i >= mcount) break;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = (mg + (i0 + i) * MG) * 16 + g + (e >> 1) * 8;
            const int col = ng * 16 + j * 8 + 2 * t + (e & 1);
            const float u = ua[i][j][e] + b1c[col];
            ach[row * ECF + col] = t0 - H + row >= 0 ? u * sigmoid(u) : 0.f;
          }
      }
    }
    __syncthreads();  // a is complete; w1's buffer is free
    if (c + 1 < nch) load_w1<T, EC>(P, c + 1, w1c);
    tc::cp_async_commit();
    if (H == 16)  // s = swish(causal conv of a), rounded
      conv_swish<T, 16, EC, TT>(ach, taps, sch);
    else if (H == 32)
      conv_swish<T, 32, EC, TT>(ach, taps, sch);
    else
      conv_swish_n<T, EC, TT>(ach, taps, sch, H);
    tc::cp_async_wait<1>();  // this chunk's w2
    __syncthreads();
    if (pcount > 0)
      tc::warp_mma<MTP, NTP, false, true>(acc, sch, ECL, 16,
                                          w2c + warp * NTP * 8, LDD, EC, MTP,
                                          pcount);
    __syncthreads();  // w2's buffer is free
    if (c + 1 < nch) load_w2<T, EC>(P, c + 1, w2c);
    tc::cp_async_commit();
  }

  // p = acc + b2: written, and the tile's partial sums of m p over its
  // rows, each lane's rows in order, then across g by a fixed butterfly
  const float* m = P.mask + (long long)b * P.T;
  const long long part = ((long long)b * P.tiles + tile) * P.D;
#pragma unroll
  for (int j = 0; j < NTP; ++j) {
    const int col = warp * NTP * 8 + j * 8 + 2 * t;
    float smp[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < MTP; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tg = t0 + i * 16 + g + 8 * h;
        if (tg >= P.T) continue;
        const long long at = ((long long)b * P.T + tg) * P.D;
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int d = col + e2;
          if (d >= P.D) continue;
          const float pv = acc[i][j][2 * h + e2] + P.b2[d];
          P.p[at + d] = pv;
          smp[e2] += m[tg] * pv;
        }
      }
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        smp[e2] += __shfl_xor_sync(0xffffffffu, smp[e2], o);
      if (g == 0 && col + e2 < P.D) P.part_mp[part + col + e2] = smp[e2];
    }
  }
}

// Backward tile kernel, grid (tiles, B): a tile of TT own rows with a halo
// of H rows on both sides. Shared rows: u / a / xn over RU = TT + 2H rows
// (t0 - H ..), dp / ds / dc over RC = TT + H rows (t0 ..). Warps as in the
// forward: dxn's columns [w * 8 NTP, ..) for the TT own rows; (mg, ng) for
// the chunk products; for the per-channel sums, warp w owns channels w,
// w + 8, .. of the chunk and lane l the rows l, l + 32.
template <typename T, int MTP, int NTP, int EC>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_tile_kernel(const TileArgs P) {
  constexpr int TT = 16 * MTP, PADT = 16 / (int)sizeof(T);
  constexpr int ECL = EC + PADT, ECF = EC + 1;
  constexpr int NG = EC / 16, MG = (THREADS / 32) / NG;
  constexpr int MUU = (MTP + 4 + MG - 1) / MG, MUC = (MTP + 2 + MG - 1) / MG;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dk = P.Dk, H = P.H, RU = TT + 2 * H, RC = TT + H,
            LDD = Dk + PADT;
  Carve2 cv{smem};
  T* xn = cv.take<T>((size_t)RU * LDD);
  T* dps = cv.take<T>((size_t)RC * LDD);
  float* ach = cv.take<float>((size_t)RU * ECF);
  float* uown = cv.take<float>((size_t)TT * ECF);
  float* dcs = cv.take<float>((size_t)RC * ECF);
  T* dus = cv.take<T>((size_t)TT * ECL);
  T* w1c = cv.take<T>((size_t)Dk * ECL);
  cv.take<T>((size_t)Dk * ECL);  // the second w1 buffer, right after
  T* w2c = cv.take<T>((size_t)EC * LDD);
  float* stats = cv.take<float>(2 * TT);
  float* taps = cv.take<float>((size_t)taps_rows(H) * EC);
  float* b1c = cv.take<float>(EC);
  const size_t w1_stride = rup((size_t)Dk * ECL * sizeof(T)) / sizeof(T);
  const int tile = blockIdx.x, b = blockIdx.y, t0 = tile * TT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nch = (P.E + EC - 1) / EC;
  const int mg = warp / NG, ng = warp % NG;
  const int mcu = (RU / 16 - mg + MG - 1) / MG;
  const int mcc = (RC / 16 - mg + MG - 1) / MG;
  const int pcount = min(NTP, max(0, (Dk - warp * NTP * 8) / 8));
  const long long seq = (long long)b * P.T;
  const long long part = (long long)b * P.tiles + tile;
  const T* dy = (const T*)P.dy;

  load_w1<T, EC>(P, 0, w1c);
  load_w2<T, EC>(P, 0, w2c);
  tc::cp_async_commit();
  ln_rows<T>(P, b, t0 - H, RU, xn, LDD, stats, H, TT);
  {  // dp rows t0 .. t0 + RC (zero past T), the own rows' column sums (db2)
    const float ms = P.msum[b];
    for (int d = tid; d < Dk; d += THREADS) {
      const bool in = d < P.D;
      const float gd = in ? P.gate[(long long)b * P.D + d] : 0.f;
      const float pd = in ? P.dpool[(long long)b * P.D + d] : 0.f;
      float sum = 0.f;
#pragma unroll 16
      for (int q = 0; q < RC; ++q) {
        const int tg = t0 + q;
        float v = 0.f;
        if (tg < P.T && in)
          v = widen(dy[(seq + tg) * P.D + d]) * gd +
              pd * (P.mask[seq + tg] / ms);
        const T vr = narrow<T>(v);
        dps[q * LDD + d] = vr;
        if (q < TT && tg < P.T && in) {
          ((T*)P.dp_g)[(seq + tg) * P.D + d] = vr;
          sum += v;
        }
      }
      if (in) P.part_db2[part * P.D + d] = sum;
    }
  }
  __syncthreads();  // xn complete
  for (int q = tid; q < TT * P.D; q += THREADS) {  // xn of the own rows
    const int tt = q / P.D, d = q - tt * P.D;
    if (t0 + tt < P.T)
      ((T*)P.xn_g)[(seq + t0 + tt) * P.D + d] = xn[(H + tt) * LDD + d];
  }

  float dxa[MTP][NTP][4];
  tc::zero_acc(dxa);
  for (int c = 0; c < nch; ++c) {
    load_chunk<EC>(P, c, taps, b1c);  // the last chunk's readers are done
    tc::cp_async_wait<0>();
    __syncthreads();
    const T* W1 = w1c + (c & 1) * w1_stride;
    if (c + 1 < nch) load_w1<T, EC>(P, c + 1, w1c + ((c + 1) & 1) * w1_stride);
    tc::cp_async_commit();
    // u and a = swish(u) over the RU rows (a = 0 before t = 0), MUU of a
    // warp's m-tiles a pass
    for (int i0 = 0; i0 < mcu; i0 += MUU) {
      float ua[MUU][2][4];
      tc::zero_acc(ua);
      tc::warp_mma<MUU, 2, false, true>(ua, xn + (mg + i0 * MG) * 16 * LDD,
                                        LDD, MG * 16, W1 + ng * 16, ECL, Dk,
                                        mcu - i0);
#pragma unroll
      for (int i = 0; i < MUU; ++i) {
        if (i0 + i >= mcu) break;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = (mg + (i0 + i) * MG) * 16 + g + (e >> 1) * 8;
            const int col = ng * 16 + j * 8 + 2 * t + (e & 1);
            const float u = ua[i][j][e] + b1c[col];
            ach[row * ECF + col] = t0 - H + row >= 0 ? u * sigmoid(u) : 0.f;
            if (row >= H && row < H + TT) uown[(row - H) * ECF + col] = u;
          }
      }
    }
    for (int i0 = 0; i0 < mcc; i0 += MUC) {  // ds = dp w2^T, the RC rows
      float da[MUC][2][4];
      tc::zero_acc(da);
      tc::warp_mma<MUC, 2, false, false>(da, dps + (mg + i0 * MG) * 16 * LDD,
                                         LDD, MG * 16, w2c + ng * 16 * LDD,
                                         LDD, Dk, mcc - i0);
#pragma unroll
      for (int i = 0; i < MUC; ++i) {
        if (i0 + i >= mcc) break;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = (mg + (i0 + i) * MG) * 16 + g + (e >> 1) * 8;
            const int col = ng * 16 + j * 8 + 2 * t + (e & 1);
            dcs[row * ECF + col] = da[i][j][e];
          }
      }
    }
    __syncthreads();  // a, u, ds complete; w2's buffer is free
    if (c + 1 < nch) load_w2<T, EC>(P, c + 1, w2c);
    tc::cp_async_commit();
    if (H == 16)  // c, dc = ds swish'(c) in place, s of the own rows
      conv_dc<T, 16, EC>(P, ach, taps, dcs, RC, TT, t0, c, seq);
    else if (H == 32)
      conv_dc<T, 32, EC>(P, ach, taps, dcs, RC, TT, t0, c, seq);
    else
      conv_dc_n<T, EC>(P, ach, taps, dcs, RC, TT, t0, c, seq);
    __syncthreads();
    if (H == 16)  // da, du, and the tile's sums for db1 and dwdw
      conv_du<T, 16, EC, TT>(P, ach, uown, dcs, taps, dus, t0, c, part);
    else if (H == 32)
      conv_du<T, 32, EC, TT>(P, ach, uown, dcs, taps, dus, t0, c, part);
    else
      conv_du_n<T, EC, TT>(P, ach, uown, dcs, taps, dus, t0, c, part);
    __syncthreads();  // du complete
    for (int q = tid; q < TT * EC; q += THREADS) {  // du of the own rows
      const int tt = q / EC, e = q - tt * EC, ec = c * EC + e;
      if (t0 + tt < P.T && ec < P.E)
        ((T*)P.du_g)[(seq + t0 + tt) * P.E + ec] = dus[tt * ECL + e];
    }
    if (pcount > 0)  // dxn += du w1^T
      tc::warp_mma<MTP, NTP, false, false>(dxa, dus, ECL, 16,
                                           W1 + warp * NTP * 8 * ECL, ECL, EC,
                                           MTP, pcount);
  }

  // LN's backward: dxn staged as f32 [TT][Dk + 1] over xn and dp
  __syncthreads();
  float* dxs = reinterpret_cast<float*>(xn);
  const int LDX = Dk + 1;
#pragma unroll
  for (int i = 0; i < MTP; ++i)
#pragma unroll
    for (int j = 0; j < NTP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = warp * NTP * 8 + j * 8 + 2 * t + (e & 1);
        if (col < Dk) dxs[(i * 16 + g + (e >> 1) * 8) * LDX + col] = dxa[i][j][e];
      }
  __syncthreads();
  const T* x = (const T*)P.x;
  constexpr int NV = 16;  // x values a lane keeps: rows up to 512 wide
  for (int tt = warp; tt < TT; tt += THREADS / 32) {
    const int tg = t0 + tt;
    if (tg >= P.T) continue;
    const float mu = stats[tt], rstd = stats[TT + tt];
    const T* xr = x + (seq + tg) * P.D;
    const float* gr = dxs + tt * LDX;
    float xh[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      xh[i] = d < P.D ? (widen(xr[d]) - mu) * rstd : 0.f;
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      if (d < P.D) {
        const float dxh = gr[d] * P.gamma[d];
        s1 += dxh;
        s2 += dxh * xh[i];
      }
    }
    for (int d = lane + 32 * NV; d < P.D; d += 32) {
      const float dxh = gr[d] * P.gamma[d];
      s1 += dxh;
      s2 += dxh * ((widen(xr[d]) - mu) * rstd);
    }
    const float m1 = warp_sum(s1) / P.D, m2 = warp_sum(s2) / P.D;
    T* dxr = (T*)P.dx + (seq + tg) * P.D;
    const T* dyr = dy + (seq + tg) * P.D;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      if (d < P.D)
        dxr[d] = narrow<T>(widen(dyr[d]) +
                           (gr[d] * P.gamma[d] - m1 - xh[i] * m2) * rstd);
    }
    for (int d = lane + 32 * NV; d < P.D; d += 32) {
      const float h = (widen(xr[d]) - mu) * rstd;
      dxr[d] = narrow<T>(widen(dyr[d]) + (gr[d] * P.gamma[d] - m1 - h * m2) *
                                             rstd);
    }
  }
  for (int d = tid; d < P.D; d += THREADS) {  // dgamma, dbeta of the tile
    float sg = 0.f, sb = 0.f;
#pragma unroll 8
    for (int tt = 0; tt < TT && t0 + tt < P.T; ++tt) {
      const float xh = (widen(x[(seq + t0 + tt) * P.D + d]) - stats[tt]) *
                       stats[TT + tt];
      sg += dxs[tt * LDX + d] * xh;
      sb += dxs[tt * LDX + d];
    }
    P.part_ln[part * 2 * P.D + d] = sg;
    P.part_ln[part * 2 * P.D + P.D + d] = sb;
  }
}

// The SE gate of sequence b (one block): msum = max(sum mask, 1); pool =
// (sum over the tiles of `rows` rows, in order, of each tile's sum of m p)
// / msum; z1 = pool wf1 + bf1; g1 = swish(z1); g = sigmoid(g1 wf2 + bf2)
// -> gate. Forward (dy null): the tiles' sums of m p are the tile kernel's
// partials part_mp. Backward (dy given, part_mp null): one pass over the
// forward's kept p forms each tile's sums of m p and of dy p, four tiles at
// a time, a quarter of the block on each, added in tile order; dgate = the
// sum of dy p; dz2 = dgate g (1 - g); dz1 = (dz2 wf2^T) swish'(z1); dpool =
// dz1 wf1^T -> dpool, msum, and pool, g1, dz1, dz2 for the SE weight
// gradients. SE_THREADS threads. Shared memory: pool [D], dz2 [D], z1, g1,
// dz1 [r], msum, gate [D], the four tiles' sums of m p and of dy p [8][D].
constexpr int SE_THREADS = 4 * THREADS;
template <typename T>
__global__ void __launch_bounds__(SE_THREADS)
    se_tiles_kernel(const float* __restrict__ part_mp,
                    const float* __restrict__ p, const T* __restrict__ dy,
                    int rows, const float* __restrict__ mask,
                    const float* __restrict__ wf1,
                    const float* __restrict__ bf1,
                    const float* __restrict__ wf2,
                    const float* __restrict__ bf2, float* __restrict__ gate,
                    float* __restrict__ dpool, float* __restrict__ msum_out,
                    float* __restrict__ pool_out, float* __restrict__ g1_out,
                    float* __restrict__ dz1_out, float* __restrict__ dz2_out,
                    int tiles, int Tn, int D, int r) {
  extern __shared__ float sm[];
  float* pool = sm;
  float* dz2 = pool + D;
  float* z1 = dz2 + D;
  float* g1 = z1 + r;
  float* dz1 = g1 + r;
  float* msum_s = dz1 + r;
  float* gsh = msum_s + 1;
  float* tsum = gsh + D;
  const int b = blockIdx.x;
  const float* mb = mask + (long long)b * Tn;
  if (threadIdx.x < 32) {
    float s = 0.f;
    for (int t = threadIdx.x; t < Tn; t += 32) s += mb[t];
    s = warp_sum(s);
    if (threadIdx.x == 0) *msum_s = fmaxf(s, 1.f);
  }
  __syncthreads();
  const float msum = *msum_s;
  if (dy) {
    // quarter q of the block sums tile k0 + q over its rows; the four
    // tiles' sums are then added to the running sums in tile order
    for (int d = threadIdx.x; d < D; d += SE_THREADS) pool[d] = dz2[d] = 0.f;
    const int q = threadIdx.x / THREADS;
    for (int k0 = 0; k0 < tiles; k0 += 4) {
      const int t0 = (k0 + q) * rows, t1 = min(Tn, t0 + rows);
      for (int d = threadIdx.x % THREADS; d < D; d += THREADS) {
        const long long sb = (long long)b * Tn * D + d;
        float pm = 0.f, pd = 0.f;
#pragma unroll 8
        for (int t = t0; t < t1; ++t) {
          const float v = p[sb + (long long)t * D];
          pm += mb[t] * v;
          pd += widen(dy[sb + (long long)t * D]) * v;
        }
        tsum[q * D + d] = pm;
        tsum[(4 + q) * D + d] = pd;
      }
      __syncthreads();
      for (int d = threadIdx.x; d < D; d += SE_THREADS)
        for (int i = 0; i < 4 && k0 + i < tiles; ++i) {
          pool[d] += tsum[i * D + d];
          dz2[d] += tsum[(4 + i) * D + d];
        }
      __syncthreads();
    }
    for (int d = threadIdx.x; d < D; d += SE_THREADS) pool[d] /= msum;
  } else {
    const long long pb = (long long)b * tiles * D;
    for (int d = threadIdx.x; d < D; d += SE_THREADS) {
      float s = 0.f;
      for (int i = 0; i < tiles; ++i) s += part_mp[pb + (long long)i * D + d];
      pool[d] = s / msum;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < r; j += SE_THREADS) {
    float z = bf1[j];
    for (int d = 0; d < D; ++d) z += pool[d] * wf1[d * r + j];
    z1[j] = z;
    g1[j] = z * sigmoid(z);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += SE_THREADS) {
    float z = bf2[d];
    for (int j = 0; j < r; ++j) z += g1[j] * wf2[j * D + d];
    const float g = sigmoid(z);
    gate[(long long)b * D + d] = g;
    gsh[d] = g;
  }
  if (!dy) return;
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += SE_THREADS)
    dz2[d] *= gsh[d] * (1.f - gsh[d]);
  __syncthreads();
  for (int j = threadIdx.x; j < r; j += SE_THREADS) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s += dz2[d] * wf2[j * D + d];
    dz1[j] = s * dswish(z1[j], sigmoid(z1[j]));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += SE_THREADS) {
    float s = 0.f;
    for (int j = 0; j < r; ++j) s += dz1[j] * wf1[d * r + j];
    const long long o = (long long)b * D + d;
    dpool[o] = s;
    pool_out[o] = pool[d];
    dz2_out[o] = dz2[d];
  }
  for (int j = threadIdx.x; j < r; j += SE_THREADS) {
    g1_out[(long long)b * r + j] = g1[j];
    dz1_out[(long long)b * r + j] = dz1[j];
  }
  if (threadIdx.x == 0) msum_out[b] = msum;
}

// ---------------------------------------------------------------------------
// Row products: C[m, n] = sum_k A(m, k) B(k, n), A(m, k) = A[m * sam +
// k * sak], B(k, n) = B[k * sbk + n * sbn]. Epilogue: v = C + bias[n] (when
// given) stored f32 to out0[m * ldc + n] and swish(v) to out1[m * ldc + n],
// each where given. Every A here is row-major (sak = 1), yet load_a keeps
// both strides general: with A's unit stride written into the loader, the
// bf16 kernel ran markedly slower on the H100 (PERF.md, the K7 notes).
// ---------------------------------------------------------------------------

struct Gemm {
  const void* A;
  long long sam, sak;
  const void* B;
  long long sbk, sbn;
  int M, N, K;
  const float* bias;
  float* out0;
  float* out1;
  int ldc;
};

template <typename T>
__device__ __forceinline__ void load_a(const Gemm& g, int m0, int k0, int k1,
                                       T* As) {
  const T* A = (const T*)g.A;
  for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
    int m, k;
    if (g.sak == 1) {
      m = e / BK, k = e % BK;
    } else {
      k = e / BM, m = e % BM;
    }
    const int gm = m0 + m, gk = k0 + k;
    As[m * (BK + APAD) + k] =
        (gm < g.M && gk < k1) ? A[gm * g.sam + gk * g.sak] : narrow<T>(0.f);
  }
}

template <typename T>
__device__ __forceinline__ void load_b(const Gemm& g, int n0, int k0, int k1,
                                       T* Bs) {
  const T* B = (const T*)g.B;
  for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
    int k, n;
    if (g.sbn == 1) {
      k = e / BN, n = e % BN;
    } else {
      n = e / BK, k = e % BK;
    }
    const int gk = k0 + k, gn = n0 + n;
    Bs[k * (BN + BPAD) + n] =
        (gn < g.N && gk < k1) ? B[gk * g.sbk + gn * g.sbn] : narrow<T>(0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) gemm_kernel(const Gemm g) {
  __shared__ __align__(32) T As[BM * (BK + APAD)];
  __shared__ __align__(32) T Bs[BK * (BN + BPAD)];
  __shared__ __align__(32) float Cs[BM * (BN + CPAD)];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32;
  if constexpr (sizeof(T) == 2) {
    // 8 warps: 4 along m (16 rows each) x 2 along n (32 columns each)
    const int wm = warp % 4, wn = warp / 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int k0 = 0; k0 < g.K; k0 += BK) {
      __syncthreads();
      load_a<T>(g, m0, k0, g.K, As);
      load_b<T>(g, n0, k0, g.K, Bs);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, (const bf16*)As + 16 * wm * (BK + APAD) + kk,
                               BK + APAD);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(
              b, (const bf16*)Bs + kk * (BN + BPAD) + 32 * wn + 16 * f,
              BN + BPAD);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < 2; ++f)
      wmma::store_matrix_sync(Cs + 16 * wm * (BN + CPAD) + 32 * wn + 16 * f,
                              acc[f], BN + CPAD, wmma::mem_row_major);
  } else {
    // a thread owns rows ty + 16 i and columns tx + 16 j, i, j < 4
    const int ty = tid / 16, tx = tid % 16;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < g.K; k0 += BK) {
      __syncthreads();
      load_a<T>(g, m0, k0, g.K, As);
      load_b<T>(g, n0, k0, g.K, Bs);
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = widen(As[(ty + 16 * i) * (BK + APAD) + k]);
          b[i] = widen(Bs[k * (BN + BPAD) + tx + 16 * i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Cs[(ty + 16 * i) * (BN + CPAD) + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int m = e / BN, n = e % BN, gm = m0 + m, gn = n0 + n;
    if (gm >= g.M || gn >= g.N) continue;
    float v = Cs[m * (BN + CPAD) + n];
    if (g.bias) v += g.bias[gn];
    const long long o = (long long)gm * g.ldc + gn;
    if (g.out0) g.out0[o] = v;
    if (g.out1) g.out1[o] = v * sigmoid(v);
  }
}

template <typename T>
cudaError_t gemm(const Gemm& g, cudaStream_t s) {
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  gemm_kernel<T><<<grid, THREADS, 0, s>>>(g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Row kernels
// ---------------------------------------------------------------------------

// xn = LN(x) * gamma + beta in the compute type, one warp a row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ln_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ xn, int N,
              int D) {
  const int lane = threadIdx.x % 32;
  const long long row =
      (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= N) return;
  const T* xr = x + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += widen(xr[d]);
  const float mu = warp_sum(s) / D;
  float v = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float c = widen(xr[d]) - mu;
    v += c * c;
  }
  const float rstd = rsqrtf(warp_sum(v) / D + LN_EPS);
  for (int d = lane; d < D; d += 32)
    xn[row * D + d] =
        narrow<T>((widen(xr[d]) - mu) * rstd * gamma[d] + beta[d]);
}

// c[t] = sum_k wdw[k] * a[t - (K - 1) + k] within a sequence (zero before
// its start); s = swish(c) in the compute type; c itself kept when asked.
template <typename T>
__global__ void dwconv_kernel(const float* __restrict__ a,
                              const float* __restrict__ wdw,
                              T* __restrict__ s_out, float* __restrict__ c_out,
                              long long NE, int Tn, int E, int K) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NE) return;
  const long long row = i / E;
  const int e = (int)(i - row * E), t = (int)(row % Tn);
  float c = 0.f;
  for (int k = 0; k < K; ++k) {
    const int ts = t - (K - 1) + k;
    if (ts >= 0) c += wdw[k * E + e] * a[i + (long long)(ts - t) * E];
  }
  s_out[i] = narrow<T>(c * sigmoid(c));
  if (c_out) c_out[i] = c;
}

// The SE gate of one sequence (block b), forward or, with dy, backward.
// msum = max(sum mask, 1); pool = sum_t p * m / msum; z1 = pool wf1 + bf1;
// g1 = swish(z1); g = sigmoid(g1 wf2 + bf2) -> gate[b]. Backward also:
// dgate = sum_t dy * p; dz2 = dgate g (1 - g); dz1 = (dz2 wf2^T) swish'(z1);
// dpool = dz1 wf1^T -> dpool[b], msum[b], and pool, g1, dz1, dz2 of b for
// the SE weight gradients. Shared memory: pool [D], dz2 [D], z1, g1, dz1
// [r], one float for msum.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    se_kernel(const float* __restrict__ p, const float* __restrict__ mask,
              const float* __restrict__ wf1, const float* __restrict__ bf1,
              const float* __restrict__ wf2, const float* __restrict__ bf2,
              const T* __restrict__ dy, float* __restrict__ gate,
              float* __restrict__ dpool, float* __restrict__ msum_out,
              float* __restrict__ pool_out, float* __restrict__ g1_out,
              float* __restrict__ dz1_out, float* __restrict__ dz2_out, int Tn,
              int D, int r) {
  extern __shared__ float sm[];
  float* pool = sm;
  float* dz2 = pool + D;
  float* z1 = dz2 + D;
  float* g1 = z1 + r;
  float* dz1 = g1 + r;
  float* msum_s = dz1 + r;
  const int b = blockIdx.x;
  const float* pb = p + (long long)b * Tn * D;
  const float* mb = mask + (long long)b * Tn;
  if (threadIdx.x < 32) {
    float s = 0.f;
    for (int t = threadIdx.x; t < Tn; t += 32) s += mb[t];
    s = warp_sum(s);
    if (threadIdx.x == 0) *msum_s = fmaxf(s, 1.f);
  }
  __syncthreads();
  const float msum = *msum_s;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float s = 0.f;
    for (int t = 0; t < Tn; ++t) s += pb[(long long)t * D + d] * mb[t];
    pool[d] = s / msum;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < r; j += THREADS) {
    float z = bf1[j];
    for (int d = 0; d < D; ++d) z += pool[d] * wf1[d * r + j];
    z1[j] = z;
    g1[j] = z * sigmoid(z);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float z = bf2[d];
    for (int j = 0; j < r; ++j) z += g1[j] * wf2[j * D + d];
    const float g = sigmoid(z);
    gate[(long long)b * D + d] = g;
    if (dy) {
      const T* db = dy + (long long)b * Tn * D;
      float dg = 0.f;
      for (int t = 0; t < Tn; ++t)
        dg += widen(db[(long long)t * D + d]) * pb[(long long)t * D + d];
      dz2[d] = dg * g * (1.f - g);
    }
  }
  if (!dy) return;
  __syncthreads();
  for (int j = threadIdx.x; j < r; j += THREADS) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s += dz2[d] * wf2[j * D + d];
    const float sig = sigmoid(z1[j]);
    dz1[j] = s * dswish(z1[j], sig);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float s = 0.f;
    for (int j = 0; j < r; ++j) s += dz1[j] * wf1[d * r + j];
    const long long o = (long long)b * D + d;
    dpool[o] = s;
    pool_out[o] = pool[d];
    dz2_out[o] = dz2[d];
  }
  for (int j = threadIdx.x; j < r; j += THREADS) {
    g1_out[(long long)b * r + j] = g1[j];
    dz1_out[(long long)b * r + j] = dz1[j];
  }
  if (threadIdx.x == 0) msum_out[b] = msum;
}

// out = p * g + x, rounded once; V consecutive elements a thread (V 8
// where D is a multiple of 8: 16-byte loads of x and out, two of p).
template <typename T, int V>
struct alignas(V * sizeof(T)) Vec {
  T v[V];
};
template <typename T, int V>
__global__ void apply_kernel(const float* __restrict__ p,
                             const float* __restrict__ gate,
                             const T* __restrict__ x, T* __restrict__ out,
                             long long ND, long long TD, int D) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i >= ND) return;
  const long long b = i / TD;
  const int d = (int)(i % D);
  const Vec<float, V> pv = *reinterpret_cast<const Vec<float, V>*>(p + i);
  const Vec<T, V> xv = *reinterpret_cast<const Vec<T, V>*>(x + i);
  Vec<T, V> ov;
#pragma unroll
  for (int e = 0; e < V; ++e)
    ov.v[e] = narrow<T>(pv.v[e] * gate[b * D + d + e] + widen(xv.v[e]));
  *reinterpret_cast<Vec<T, V>*>(out + i) = ov;
}

// dp = dy * g + dpool * (m / msum) in the compute type, and its column
// sums over the block's ROWS rows (f32, unrounded) into part[blockIdx.x].
template <typename T>
__global__ void __launch_bounds__(THREADS)
    dp_kernel(const T* __restrict__ dy, const float* __restrict__ gate,
              const float* __restrict__ dpool, const float* __restrict__ mask,
              const float* __restrict__ msum, T* __restrict__ dp_out,
              float* __restrict__ part, int N, int Tn, int D) {
  const int r0 = blockIdx.x * ROWS;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float s = 0.f;
    for (int r = r0; r < min(N, r0 + ROWS); ++r) {
      const int b = r / Tn;
      const long long i = (long long)r * D + d;
      const float v = widen(dy[i]) * gate[(long long)b * D + d] +
                      dpool[(long long)b * D + d] * (mask[r] / msum[b]);
      dp_out[i] = narrow<T>(v);
      s += v;
    }
    part[(long long)blockIdx.x * D + d] = s;
  }
}

// dc = ds * swish'(c), in place over ds.
__global__ void dc_kernel(float* __restrict__ ds, const float* __restrict__ c,
                          long long NE) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NE) return;
  const float cv = c[i];
  ds[i] *= dswish(cv, sigmoid(cv));
}

// One block a (column chunk of THREADS, time chunk of ROWS, sequence b),
// a thread a column e: da[t] = sum_k wdw[k] dc[t + (K - 1) - k] (zero past
// the sequence's end), du = da * swish'(u) in the compute type; the chunk's
// sums of du (db1) and of a[t - (K - 1) + k] * dc[t] (dwdw[k]) into
// db1_part / dwdw_part[chunk index]. Up to MAXK taps in one pass with the
// taps in registers; more in a pass for da and du (taps read as they are
// used, in the same order), then a pass a chunk of MAXK taps for dwdw.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    dwconv_bwd_kernel(const float* __restrict__ dc,
                      const float* __restrict__ u, const float* __restrict__ a,
                      const float* __restrict__ wdw, T* __restrict__ du_out,
                      float* __restrict__ db1_part,
                      float* __restrict__ dwdw_part, int Tn, int E, int K) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.z, t0 = blockIdx.y * ROWS;
  const long long part = (long long)b * gridDim.y + blockIdx.y;
  if (e >= E) return;
  const long long base = (long long)b * Tn * E + e;
  const int t1 = min(Tn, t0 + ROWS);
  float db1 = 0.f;
  if (K <= MAXK) {
    float w[MAXK], dw[MAXK];
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      w[k] = k < K ? wdw[k * E + e] : 0.f;
      dw[k] = 0.f;
    }
    for (int t = t0; t < t1; ++t) {
      float da = 0.f;
      const float dct = dc[base + (long long)t * E];
#pragma unroll
      for (int k = 0; k < MAXK; ++k) {
        if (k < K) {
          const int tf = t + (K - 1) - k;
          if (tf < Tn) da += w[k] * dc[base + (long long)tf * E];
          const int tb = t - (K - 1) + k;
          if (tb >= 0) dw[k] += a[base + (long long)tb * E] * dct;
        }
      }
      const float uv = u[base + (long long)t * E];
      const float d = da * dswish(uv, sigmoid(uv));
      du_out[base + (long long)t * E] = narrow<T>(d);
      db1 += d;
    }
#pragma unroll
    for (int k = 0; k < MAXK; ++k)
      if (k < K) dwdw_part[(part * K + k) * E + e] = dw[k];
  } else {
    for (int t = t0; t < t1; ++t) {
      float da = 0.f;
      for (int k = 0; k < K; ++k) {
        const int tf = t + (K - 1) - k;
        if (tf < Tn) da += wdw[k * E + e] * dc[base + (long long)tf * E];
      }
      const float uv = u[base + (long long)t * E];
      const float d = da * dswish(uv, sigmoid(uv));
      du_out[base + (long long)t * E] = narrow<T>(d);
      db1 += d;
    }
    for (int k0 = 0; k0 < K; k0 += MAXK) {
      float dw[MAXK];
#pragma unroll
      for (int k = 0; k < MAXK; ++k) dw[k] = 0.f;
      for (int t = t0; t < t1; ++t) {
        const float dct = dc[base + (long long)t * E];
#pragma unroll
        for (int k = 0; k < MAXK; ++k) {
          const int tb = t - (K - 1) + k0 + k;
          if (k0 + k < K && tb >= 0)
            dw[k] += a[base + (long long)tb * E] * dct;
        }
      }
#pragma unroll
      for (int k = 0; k < MAXK; ++k)
        if (k0 + k < K) dwdw_part[(part * K + k0 + k) * E + e] = dw[k];
    }
  }
  db1_part[part * E + e] = db1;
}

// LN backward, one warp a row: dxh = dxn * gamma; dx = dy + (dxh -
// mean(dxh) - xh * mean(dxh * xh)) * rstd, rounded once; the block's sums
// of dxn * xh (dgamma) and dxn (dbeta) over its ROWS rows into part
// [blockIdx.x][2][D]. Shared memory: [warps][2][D] f32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dxn,
                  const T* __restrict__ dy, const float* __restrict__ gamma,
                  T* __restrict__ dx, float* __restrict__ part, int N, int D) {
  extern __shared__ float sm[];
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* mine = sm + (size_t)warp * 2 * D;
  for (int d = lane; d < D; d += 32) mine[d] = mine[D + d] = 0.f;
  for (int rr = warp; rr < ROWS; rr += WARPS) {
    const long long row = (long long)blockIdx.x * ROWS + rr;
    if (row >= N) break;
    const T* xr = x + row * D;
    const float* gr = dxn + row * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += widen(xr[d]);
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float c = widen(xr[d]) - mu;
      v += c * c;
    }
    const float rstd = rsqrtf(warp_sum(v) / D + LN_EPS);
    float s1 = 0.f, s2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float xh = (widen(xr[d]) - mu) * rstd;
      const float dxh = gr[d] * gamma[d];
      s1 += dxh;
      s2 += dxh * xh;
      mine[d] += gr[d] * xh;
      mine[D + d] += gr[d];
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
    for (int d = lane; d < D; d += 32) {
      const float xh = (widen(xr[d]) - mu) * rstd;
      const float dxh = gr[d] * gamma[d];
      dx[row * D + d] =
          narrow<T>(widen(dy[row * D + d]) + (dxh - m1 - xh * m2) * rstd);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * D; i += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += sm[(size_t)w * 2 * D + i];
    part[(long long)blockIdx.x * 2 * D + i] = s;
  }
}

// The SE weight gradients, summed over sequences in order: dwf1 [D, r] =
// sum_b pool^T dz1, dbf1 [r], dwf2 [r, D] = sum_b g1^T dz2, dbf2 [D].
__global__ void se_wgrad_kernel(const float* __restrict__ pool,
                                const float* __restrict__ g1,
                                const float* __restrict__ dz1,
                                const float* __restrict__ dz2,
                                float* __restrict__ dwf1,
                                float* __restrict__ dbf1,
                                float* __restrict__ dwf2,
                                float* __restrict__ dbf2, int B, int D,
                                int r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n1 = D * r, n2 = n1 + r, n3 = n2 + r * D, n4 = n3 + D;
  if (i >= n4) return;
  float s = 0.f;
  if (i < n1) {
    const int d = i / r, j = i % r;
    for (int b = 0; b < B; ++b) s += pool[b * D + d] * dz1[b * r + j];
    dwf1[i] = s;
  } else if (i < n2) {
    const int j = i - n1;
    for (int b = 0; b < B; ++b) s += dz1[b * r + j];
    dbf1[j] = s;
  } else if (i < n3) {
    const int j = (i - n2) / D, d = (i - n2) % D;
    for (int b = 0; b < B; ++b) s += g1[b * r + j] * dz2[b * D + d];
    dwf2[i - n2] = s;
  } else {
    const int d = i - n3;
    for (int b = 0; b < B; ++b) s += dz2[b * D + d];
    dbf2[d] = s;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct Shape {
  int B, Tn, D, E, K, r, N;
};

int blocks_of(long long n, int t = THREADS) { return (int)((n + t - 1) / t); }
int row_blocks(const Shape& S) { return (S.N + ROWS - 1) / ROWS; }
int time_chunks(const Shape& S) { return (S.Tn + ROWS - 1) / ROWS; }

template <typename T>
cudaError_t apply(const float* p, const float* gate, const T* x, T* out,
                  const Shape& S, cudaStream_t s) {
  const long long ND = (long long)S.N * S.D, TD = (long long)S.Tn * S.D;
  if (S.D % 8 == 0)
    apply_kernel<T, 8><<<blocks_of(ND / 8), THREADS, 0, s>>>(p, gate, x, out,
                                                             ND, TD, S.D);
  else
    apply_kernel<T, 1><<<blocks_of(ND), THREADS, 0, s>>>(p, gate, x, out, ND,
                                                         TD, S.D);
  return cudaGetLastError();
}

// A bump allocator over the caller's workspace; sizes 256-byte aligned.
struct Carve {
  char* p;
  size_t used = 0;
  template <typename X>
  X* take(long long count) {
    X* out = p ? (X*)(p + used) : nullptr;
    used += ((size_t)count * sizeof(X) + 255) / 256 * 256;
    return out;
  }
};

template <typename T>
struct Work {
  T *xn, *s, *dp, *du;
  float *u, *a, *c, *ds, *dxn;
  float *gate, *dpool, *msum, *pool, *g1, *dz1, *dz2;
  float *db2_part, *db1_part, *dwdw_part, *ln_part, *dw1_part, *dw2_part;
};

template <typename T>
Work<T> carve(const Shape& S, int splits, bool backward, Carve& c) {
  Work<T> w{};
  const long long ND = (long long)S.N * S.D, NE = (long long)S.N * S.E;
  w.xn = c.take<T>(ND);
  w.a = c.take<float>(NE);
  w.s = c.take<T>(NE);
  w.gate = c.take<float>((long long)S.B * S.D);
  if (!backward) return w;
  w.u = c.take<float>(NE);
  w.c = c.take<float>(NE);
  w.dpool = c.take<float>((long long)S.B * S.D);
  w.msum = c.take<float>(S.B);
  w.pool = c.take<float>((long long)S.B * S.D);
  w.g1 = c.take<float>((long long)S.B * S.r);
  w.dz1 = c.take<float>((long long)S.B * S.r);
  w.dz2 = c.take<float>((long long)S.B * S.D);
  w.dp = c.take<T>(ND);
  w.db2_part = c.take<float>((long long)row_blocks(S) * S.D);
  w.ds = c.take<float>(NE);
  w.du = c.take<T>(NE);
  const long long parts = (long long)S.B * time_chunks(S);
  w.db1_part = c.take<float>(parts * S.E);
  w.dwdw_part = c.take<float>(parts * S.K * S.E);
  w.dxn = c.take<float>(ND);
  w.ln_part = c.take<float>((long long)row_blocks(S) * 2 * S.D);
  w.dw1_part = c.take<float>((long long)splits * S.D * S.E);
  w.dw2_part = c.take<float>((long long)splits * S.E * S.D);
  return w;
}

constexpr size_t SMEM_LIMIT = 227 * 1024;

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

#define TRY(x)                              \
  do {                                      \
    cudaError_t e_ = (x);                   \
    if (e_ != cudaSuccess) return e_;       \
  } while (0)

struct Args {
  const void *x, *mask, *gamma, *beta, *w1, *b1, *wdw, *w2, *b2, *wf1, *bf1,
      *wf2, *bf2;
};

// The forward up to p (and, for the backward, u and c), then the SE gate
// (with its backward when dy is given). With the forward's p given (the
// backward), the second product is not taken again.
template <typename T>
cudaError_t branch(const Args& A, const Shape& S, const Work<T>& w, float* p,
                   bool have_p, const T* dy, cudaStream_t s) {
  const long long NE = (long long)S.N * S.E;
  ln_kernel<T><<<blocks_of(S.N, THREADS / 32), THREADS, 0, s>>>(
      (const T*)A.x, (const float*)A.gamma, (const float*)A.beta, w.xn, S.N,
      S.D);
  TRY(cudaGetLastError());
  Gemm g{};
  g.A = w.xn, g.sam = S.D, g.sak = 1;
  g.B = A.w1, g.sbk = S.E, g.sbn = 1;
  g.M = S.N, g.N = S.E, g.K = S.D;
  g.bias = (const float*)A.b1;
  g.out0 = w.u;  // u is kept for the backward only
  g.out1 = w.a;
  g.ldc = S.E;
  TRY(gemm<T>(g, s));
  dwconv_kernel<T><<<blocks_of(NE), THREADS, 0, s>>>(w.a, (const float*)A.wdw,
                                                     w.s, w.c, NE, S.Tn, S.E,
                                                     S.K);
  TRY(cudaGetLastError());
  if (!have_p) {
    Gemm h{};
    h.A = w.s, h.sam = S.E, h.sak = 1;
    h.B = A.w2, h.sbk = S.D, h.sbn = 1;
    h.M = S.N, h.N = S.D, h.K = S.E;
    h.bias = (const float*)A.b2;
    h.out0 = p;
    h.ldc = S.D;
    TRY(gemm<T>(h, s));
  }
  const size_t smem = (2 * (size_t)S.D + 3 * (size_t)S.r + 1) * 4;
  TRY(allow_smem(se_kernel<T>, smem));
  se_kernel<T><<<S.B, THREADS, smem, s>>>(
      p, (const float*)A.mask, (const float*)A.wf1, (const float*)A.bf1,
      (const float*)A.wf2, (const float*)A.bf2, dy, w.gate, w.dpool, w.msum,
      w.pool, w.g1, w.dz1, w.dz2, S.Tn, S.D, S.r);
  return cudaGetLastError();
}

bool shape_ok(const Shape& S) {
  return S.B > 0 && S.B <= 65535 && S.Tn > 0 && S.D > 0 && S.E > 0 &&
         S.K > 0 && S.r > 0 &&
         (2 * (size_t)S.D + 3 * (size_t)S.r + 1) * 4 <= SMEM_LIMIT &&
         (size_t)(THREADS / 32) * 2 * S.D * 4 <= SMEM_LIMIT &&
         (long long)S.B * S.Tn < (1LL << 31) &&
         time_chunks(S) <= 65535;
}

// The gradient layout: dgamma, dbeta [D], dw1 [D, E], db1 [E], dwdw [K,
// E], dw2 [E, D], db2 [D], dwf1 [D, r], dbf1 [r], dwf2 [r, D], dbf2 [D].
struct Grads {
  float *dln, *dw1, *db1, *dwdw, *dw2, *db2, *dwf1, *dbf1, *dwf2, *dbf2;
};
Grads grads_of(float* g, const Shape& S) {
  Grads o;
  o.dln = g;
  o.dw1 = o.dln + 2 * S.D;
  o.db1 = o.dw1 + (long long)S.D * S.E;
  o.dwdw = o.db1 + S.E;
  o.dw2 = o.dwdw + (long long)S.K * S.E;
  o.db2 = o.dw2 + (long long)S.E * S.D;
  o.dwf1 = o.db2 + S.D;
  o.dbf1 = o.dwf1 + (long long)S.D * S.r;
  o.dwf2 = o.dbf1 + S.r;
  o.dbf2 = o.dwf2 + (long long)S.r * S.D;
  return o;
}

// The general path (see the top of this file): the chain of row kernels.
template <typename T>
cudaError_t chain_forward(const Args& A, void* out, float* p, void* work,
                          const Shape& S, cudaStream_t s) {
  Carve c{(char*)work};
  const Work<T> w = carve<T>(S, 1, false, c);
  TRY(branch<T>(A, S, w, p, false, nullptr, s));
  return apply<T>(p, w.gate, (const T*)A.x, (T*)out, S, s);
}

template <typename T>
cudaError_t chain_backward(const Args& A, const void* dy, const float* p,
                           void* dx, float* grads, void* work, const Shape& S,
                           int splits, cudaStream_t s) {
  Carve c{(char*)work};
  const Work<T> w = carve<T>(S, splits, true, c);
  const long long NE = (long long)S.N * S.E;
  TRY(branch<T>(A, S, w, const_cast<float*>(p), true, (const T*)dy, s));
  dp_kernel<T><<<row_blocks(S), THREADS, 0, s>>>(
      (const T*)dy, w.gate, w.dpool, (const float*)A.mask, w.msum, w.dp,
      w.db2_part, S.N, S.Tn, S.D);
  TRY(cudaGetLastError());
  Gemm g{};  // ds = dp w2^T: B(k = d, n = e) = w2[e, d]
  g.A = w.dp, g.sam = S.D, g.sak = 1;
  g.B = A.w2, g.sbk = 1, g.sbn = S.D;
  g.M = S.N, g.N = S.E, g.K = S.D;
  g.out0 = w.ds, g.ldc = S.E;
  TRY(gemm<T>(g, s));
  dc_kernel<<<blocks_of(NE), THREADS, 0, s>>>(w.ds, w.c, NE);
  TRY(cudaGetLastError());
  dwconv_bwd_kernel<T>
      <<<dim3((S.E + THREADS - 1) / THREADS, time_chunks(S), S.B), THREADS, 0,
         s>>>(w.ds, w.u, w.a, (const float*)A.wdw, w.du, w.db1_part,
              w.dwdw_part, S.Tn, S.E, S.K);
  TRY(cudaGetLastError());
  Gemm h{};  // dxn = du w1^T: B(k = e, n = d) = w1[d, e]
  h.A = w.du, h.sam = S.E, h.sak = 1;
  h.B = A.w1, h.sbk = 1, h.sbn = S.E;
  h.M = S.N, h.N = S.D, h.K = S.E;
  h.out0 = w.dxn, h.ldc = S.D;
  TRY(gemm<T>(h, s));
  const size_t lsm = (size_t)(THREADS / 32) * 2 * S.D * 4;
  TRY(allow_smem(ln_bwd_kernel<T>, lsm));
  ln_bwd_kernel<T><<<row_blocks(S), THREADS, lsm, s>>>(
      (const T*)A.x, w.dxn, (const T*)dy, (const float*)A.gamma, (T*)dx,
      w.ln_part, S.N, S.D);
  TRY(cudaGetLastError());
  const Grads o = grads_of(grads, S);
  // dw1 = xn^T du and dw2 = s^T dp, the partials of the row splits
  TRY(wgrad::product<T>(w.xn, w.du, w.dw1_part, S.N, S.D, S.E, splits, s));
  TRY(wgrad::product<T>(w.s, w.dp, w.dw2_part, S.N, S.E, S.D, splits, s));
  const int n_se = S.D * S.r * 2 + S.r + S.D;
  se_wgrad_kernel<<<blocks_of(n_se), THREADS, 0, s>>>(
      w.pool, w.g1, w.dz1, w.dz2, o.dwf1, o.dbf1, o.dwf2, o.dbf2, S.B, S.D,
      S.r);
  TRY(cudaGetLastError());
  const int parts = S.B * time_chunks(S);
  const struct {
    const float* part;
    float* out;
    int parts;
    long long n;
  } sums[] = {
      {w.ln_part, o.dln, row_blocks(S), 2LL * S.D},
      {w.dw1_part, o.dw1, splits, (long long)S.D * S.E},
      {w.db1_part, o.db1, parts, S.E},
      {w.dwdw_part, o.dwdw, parts, (long long)S.K * S.E},
      {w.dw2_part, o.dw2, splits, (long long)S.E * S.D},
      {w.db2_part, o.db2, row_blocks(S), S.D},
  };
  for (const auto& r : sums) TRY(wgrad::sum_parts(r.part, r.out, r.parts, r.n, s));
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Host side of the tiled kernels
// ---------------------------------------------------------------------------

// The plans conv_kernel.py chooses from, by index: m-tiles of the tile
// (TT = 16 MTP rows), n8-tiles a warp of the TT x D accumulator (D <= 64
// NTP), channels a chunk. Keep in step with conv_kernel._TILE_CONFIGS.
struct Cfg {
  int mtp, ntp, ec;
};
constexpr int NCFG = 2;
inline Cfg cfg_of(bool bf16_, bool backward, int cfg) {
  static const Cfg table[2][2][NCFG] = {
      {{{4, 4, 32}, {1, 8, 16}}, {{2, 4, 16}, {1, 8, 16}}},   // f32
      {{{4, 4, 64}, {1, 8, 32}}, {{4, 4, 32}, {1, 8, 32}}}};  // bf16
  return table[bf16_][backward][cfg];
}
inline int tile_rows_of(bool bf16_, bool backward, int cfg) {
  return 16 * cfg_of(bf16_, backward, cfg).mtp;
}
inline int tiles_of(const Shape& S, bool bf16_, bool backward, int cfg) {
  const int TT = tile_rows_of(bf16_, backward, cfg);
  return (S.Tn + TT - 1) / TT;
}

template <typename Kern>
cudaError_t launch_tile(Kern kernel, size_t smem, const TileArgs& P,
                        cudaStream_t s) {
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem));
  kernel<<<dim3(P.tiles, P.B), THREADS, smem, s>>>(P);
  return cudaGetLastError();
}

template <typename T, int MTP, int NTP, int EC>
cudaError_t run_tile(const TileArgs& P, bool backward, cudaStream_t s) {
  if (P.Dk > 64 * NTP) return cudaErrorInvalidValue;
  const size_t smem = tile_smem<T, MTP, EC>(backward, P.Dk, P.H);
  if (backward)
    return launch_tile(bwd_tile_kernel<T, MTP, NTP, EC>, smem, P, s);
  return launch_tile(fwd_tile_kernel<T, MTP, NTP, EC>, smem, P, s);
}

// The instantiation of each entry of cfg_of's table.
template <typename T>
cudaError_t tile_kernel(const TileArgs& P, bool backward, int cfg,
                        cudaStream_t s) {
  const int key = (int)backward * NCFG + cfg;
  if constexpr (sizeof(T) == 2) {
    switch (key) {
      case 0: return run_tile<T, 4, 4, 64>(P, false, s);
      case 1: return run_tile<T, 1, 8, 32>(P, false, s);
      case NCFG + 0: return run_tile<T, 4, 4, 32>(P, true, s);
      case NCFG + 1: return run_tile<T, 1, 8, 32>(P, true, s);
    }
  } else {
    switch (key) {
      case 0: return run_tile<T, 4, 4, 32>(P, false, s);
      case 1: return run_tile<T, 1, 8, 16>(P, false, s);
      case NCFG + 0: return run_tile<T, 2, 4, 16>(P, true, s);
      case NCFG + 1: return run_tile<T, 1, 8, 16>(P, true, s);
    }
  }
  return cudaErrorInvalidValue;
}

// The shared memory of each entry of cfg_of's table at (Dk, H).
template <typename T>
long long tile_smem_of(bool backward, int cfg, int Dk, int H) {
  const int key = (int)backward * NCFG + cfg;
  if constexpr (sizeof(T) == 2) {
    switch (key) {
      case 0: return (long long)tile_smem<T, 4, 64>(false, Dk, H);
      case 1: return (long long)tile_smem<T, 1, 32>(false, Dk, H);
      case NCFG + 0: return (long long)tile_smem<T, 4, 32>(true, Dk, H);
      case NCFG + 1: return (long long)tile_smem<T, 1, 32>(true, Dk, H);
    }
  } else {
    switch (key) {
      case 0: return (long long)tile_smem<T, 4, 32>(false, Dk, H);
      case 1: return (long long)tile_smem<T, 1, 16>(false, Dk, H);
      case NCFG + 0: return (long long)tile_smem<T, 2, 16>(true, Dk, H);
      case NCFG + 1: return (long long)tile_smem<T, 1, 16>(true, Dk, H);
    }
  }
  return -1;
}

// The workspace of the tile and wgmma designs: the SE gate (forward); the
// SE backward, the compute-type operands of the weight products and the
// per-tile partials (backward, tb tiles a sequence).
template <typename T>
struct TiledWork {
  float *gate, *part_mp, *dpool, *msum, *pool, *g1, *dz1, *dz2;
  T *xn, *dp, *s, *du;
  float *part_ln, *part_e, *part_db2, *dw1_part, *dw2_part;
};

// tb: the forward's tiles (for its pool partials), or the backward's.
template <typename T>
TiledWork<T> carve_tiled(const Shape& S, int tb, int splits, bool backward,
                         Carve& c) {
  TiledWork<T> w{};
  const long long ND = (long long)S.N * S.D, NE = (long long)S.N * S.E;
  const long long BD = (long long)S.B * S.D;
  w.gate = c.take<float>(BD);
  if (!backward) {
    w.part_mp = c.take<float>(BD * tb);
    return w;
  }
  w.dpool = c.take<float>(BD);
  w.msum = c.take<float>(S.B);
  w.pool = c.take<float>(BD);
  w.g1 = c.take<float>((long long)S.B * S.r);
  w.dz1 = c.take<float>((long long)S.B * S.r);
  w.dz2 = c.take<float>(BD);
  w.xn = c.take<T>(ND);
  w.dp = c.take<T>(ND);
  w.s = c.take<T>(NE);
  w.du = c.take<T>(NE);
  const long long parts = (long long)S.B * tb;
  w.part_ln = c.take<float>(parts * 2 * S.D);
  w.part_e = c.take<float>(parts * (S.E + (long long)S.K * S.E));
  w.part_db2 = c.take<float>(parts * S.D);
  w.dw1_part = c.take<float>((long long)splits * S.D * S.E);
  w.dw2_part = c.take<float>((long long)splits * S.E * S.D);
  return w;
}

template <typename T>
TileArgs tile_args(const Args& A, const Shape& S, int tiles) {
  constexpr int EPC = 16 / (int)sizeof(T);
  TileArgs P{};
  P.x = A.x, P.w1 = A.w1, P.w2 = A.w2;
  P.mask = (const float*)A.mask, P.gamma = (const float*)A.gamma;
  P.beta = (const float*)A.beta, P.b1 = (const float*)A.b1;
  P.wdw = (const float*)A.wdw, P.b2 = (const float*)A.b2;
  P.B = S.B, P.T = S.Tn, P.D = S.D, P.E = S.E, P.K = S.K;
  P.Dk = (S.D + 15) / 16 * 16;
  P.H = (S.K + 15) / 16 * 16;
  P.tiles = tiles;
  P.vec = S.D % EPC == 0 && S.E % EPC == 0 &&
          reinterpret_cast<uintptr_t>(A.w1) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(A.w2) % 16 == 0;
  return P;
}

cwg::Args wg_args(const Args& A, const Shape& S) {
  cwg::Args a{};
  a.x = (const bf16*)A.x;
  a.mask = (const float*)A.mask, a.gamma = (const float*)A.gamma;
  a.beta = (const float*)A.beta, a.b1 = (const float*)A.b1;
  a.wdw = (const float*)A.wdw, a.b2 = (const float*)A.b2;
  a.T = S.Tn, a.E = S.E, a.K = S.K;
  return a;
}

size_t se_smem(const Shape& S) {
  return (11 * (size_t)S.D + 3 * (size_t)S.r + 1) * 4;
}

// (2) The SE gate from the tile kernel's pool partials over tiles of `rows`
// rows (forward, dy null), or its backward from the forward's p summed over
// tiles of `rows` rows.
template <typename T>
cudaError_t se_tiles(const Args& A, const Shape& S, const float* p,
                     const T* dy, int rows, const TiledWork<T>& w,
                     cudaStream_t s) {
  TRY(allow_smem(se_tiles_kernel<T>, se_smem(S)));
  se_tiles_kernel<T><<<S.B, SE_THREADS, se_smem(S), s>>>(
      w.part_mp, p, dy, rows, (const float*)A.mask, (const float*)A.wf1,
      (const float*)A.bf1, (const float*)A.wf2, (const float*)A.bf2, w.gate,
      w.dpool, w.msum, w.pool, w.g1, w.dz1, w.dz2, (S.Tn + rows - 1) / rows,
      S.Tn, S.D, S.r);
  return cudaGetLastError();
}

// Rows of a forward tile: the wgmma design's, or tile configuration cfg's.
inline int fwd_rows(bool bf16_, int cfg, const cwg::Plan& pl) {
  return pl.wgmma ? cwg::FROWS : tile_rows_of(bf16_, false, cfg);
}

// The forward of the tile and wgmma designs: (1) the tile kernel, writing
// p and its pool partials, (2) the SE gate, (3) out = p g + x.
template <typename T>
cudaError_t tiled_forward(const Args& A, void* out, float* p, void* work,
                          const Shape& S, int cfg, const cwg::Plan& pl,
                          cudaStream_t s) {
  const int rows = fwd_rows(sizeof(T) == 2, cfg, pl);
  const int tiles = (S.Tn + rows - 1) / rows;
  Carve c{(char*)work};
  const TiledWork<T> w = carve_tiled<T>(S, tiles, 1, false, c);
  if constexpr (sizeof(T) == 2) {
    if (pl.wgmma) {
      cwg::Args a = wg_args(A, S);
      a.p = p, a.part_mp = w.part_mp;
      switch (S.D / 64) {
        case 1: TRY(cwg::forward<1>(pl, A.w1, A.w2, a, S.B, s)); break;
        case 2: TRY(cwg::forward<2>(pl, A.w1, A.w2, a, S.B, s)); break;
        case 3: TRY(cwg::forward<3>(pl, A.w1, A.w2, a, S.B, s)); break;
        case 4: TRY(cwg::forward<4>(pl, A.w1, A.w2, a, S.B, s)); break;
        default: return cudaErrorInvalidValue;
      }
    }
  }
  if (!pl.wgmma) {
    TileArgs P = tile_args<T>(A, S, tiles);
    P.p = p, P.part_mp = w.part_mp;
    TRY(tile_kernel<T>(P, false, cfg, s));
  }
  TRY(se_tiles<T>(A, S, p, nullptr, rows, w, s));
  return apply<T>(p, w.gate, (const T*)A.x, (T*)out, S, s);
}

// The backward of the tile and wgmma designs: (1) the SE backward from the
// forward's p (summed over the forward's tiles), (2) the backward tile
// kernel, (3) the weight products, the SE weight gradients and five
// fixed-order sums of the partials: 10 launches.
template <typename T>
cudaError_t tiled_backward(const Args& A, const void* dy, const float* p,
                           void* dx, float* grads, void* work, const Shape& S,
                           int splits, int cfg_f, int cfg_b,
                           const cwg::Plan& pl, cudaStream_t s) {
  const bool bf = sizeof(T) == 2;
  const int rows_f = fwd_rows(bf, cfg_f, pl);
  const int tb = pl.wgmma ? cwg::bwd_tiles(S.Tn) : tiles_of(S, bf, true, cfg_b);
  Carve c{(char*)work};
  const TiledWork<T> w = carve_tiled<T>(S, tb, splits, true, c);
  TRY(se_tiles<T>(A, S, p, (const T*)dy, rows_f, w, s));
  if constexpr (sizeof(T) == 2) {
    if (pl.wgmma) {
      cwg::Args a = wg_args(A, S);
      a.dy = (const bf16*)dy, a.gate = w.gate, a.dpool = w.dpool;
      a.msum = w.msum, a.dx = (bf16*)dx, a.xn_g = w.xn, a.dp_g = w.dp;
      a.s_g = w.s, a.du_g = w.du, a.part_ln = w.part_ln;
      a.part_e = w.part_e, a.part_db2 = w.part_db2;
      switch (S.D / 64) {
        case 1: TRY(cwg::backward<1>(pl, A.w1, A.w2, a, S.B, s)); break;
        case 2: TRY(cwg::backward<2>(pl, A.w1, A.w2, a, S.B, s)); break;
        case 3: TRY(cwg::backward<3>(pl, A.w1, A.w2, a, S.B, s)); break;
        case 4: TRY(cwg::backward<4>(pl, A.w1, A.w2, a, S.B, s)); break;
        default: return cudaErrorInvalidValue;
      }
    }
  }
  if (!pl.wgmma) {
    TileArgs P = tile_args<T>(A, S, tb);
    P.dy = dy, P.gate = w.gate, P.dpool = w.dpool, P.msum = w.msum;
    P.dx = dx, P.xn_g = w.xn, P.dp_g = w.dp, P.s_g = w.s, P.du_g = w.du;
    P.part_ln = w.part_ln, P.part_e = w.part_e, P.part_db2 = w.part_db2;
    TRY(tile_kernel<T>(P, true, cfg_b, s));
  }
  const Grads o = grads_of(grads, S);
  TRY(wgrad::product<T>(w.xn, w.du, w.dw1_part, S.N, S.D, S.E, splits, s));
  TRY(wgrad::product<T>(w.s, w.dp, w.dw2_part, S.N, S.E, S.D, splits, s));
  const int n_se = S.D * S.r * 2 + S.r + S.D;
  se_wgrad_kernel<<<blocks_of(n_se), THREADS, 0, s>>>(
      w.pool, w.g1, w.dz1, w.dz2, o.dwf1, o.dbf1, o.dwf2, o.dbf2, S.B, S.D,
      S.r);
  TRY(cudaGetLastError());
  const int parts = S.B * tb;
  const struct {
    const float* part;
    float* out;
    int parts;
    long long n;
  } sums[] = {
      {w.part_ln, o.dln, parts, 2LL * S.D},
      {w.dw1_part, o.dw1, splits, (long long)S.D * S.E},
      {w.part_e, o.db1, parts, S.E + (long long)S.K * S.E},  // db1, dwdw
      {w.dw2_part, o.dw2, splits, (long long)S.E * S.D},
      {w.part_db2, o.db2, parts, S.D},
  };
  for (const auto& r : sums)
    TRY(wgrad::sum_parts(r.part, r.out, r.parts, r.n, s));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The design of (dtype, D, E, K) into out[0..8]: design (0 tile, 1 wgmma),
// then for the wgmma design its forward and backward own rows a tile,
// channels a chunk, ring slots and shared memory (bytes), else zeros.
// ops/conv_kernel.py's conv_plan gives the same.
int ishara_conv_plan(int dtype, int D, int E, int K, long long* out) {
  const cwg::Plan p = cwg::plan(dtype, D, E, K);
  const long long v[9] = {p.wgmma,
                          p.wgmma ? cwg::FROWS : 0,
                          p.wgmma ? cwg::BROWS : 0,
                          p.wgmma ? cwg::FEC : 0,
                          p.wgmma ? cwg::BEC : 0,
                          p.fwd_slots,
                          p.bwd_slots,
                          (long long)p.fwd_smem,
                          (long long)p.bwd_smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// Bytes of workspace the forward (backward = 0) or backward (1) needs, in
// units of 256 bytes. dtype 0 = f32, 1 = bf16; splits: the row splits of
// the backward's weight products; cfg_f, cfg_b: the tile plans of the
// forward and backward tile kernels (conv_kernel.tile_plan), -1 for the
// general path; both are ignored where the plan takes the wgmma design.
int ishara_conv_workspace(int B, int T, int D, int E, int K, int r,
                          int dtype, int backward, int splits, int cfg_f,
                          int cfg_b) {
  const Shape S{B, T, D, E, K, r, B * T};
  Carve c{nullptr};
  const bool wg = cwg::plan(dtype, D, E, K).wgmma;
  const bool tiled =
      wg || (backward ? cfg_f >= 0 && cfg_b >= 0 : cfg_f >= 0);
  if (tiled) {
    const int rows_f = fwd_rows(dtype == 1, cfg_f, cwg::plan(dtype, D, E, K));
    const int tb = !backward ? (T + rows_f - 1) / rows_f
                   : wg      ? cwg::bwd_tiles(T)
                             : tiles_of(S, dtype == 1, true, cfg_b);
    if (dtype == 0)
      carve_tiled<float>(S, tb, splits, backward != 0, c);
    else
      carve_tiled<bf16>(S, tb, splits, backward != 0, c);
  } else if (dtype == 0) {
    carve<float>(S, splits, backward != 0, c);
  } else {
    carve<bf16>(S, splits, backward != 0, c);
  }
  return (int)(c.used / 256);
}

bool cfg_ok(int cfg) { return cfg >= -1 && cfg < NCFG; }

// Bytes of shared memory tile configuration cfg (0 .. NCFG - 1) of the
// forward (backward = 0) or backward tile kernel takes at width D with K
// taps, -1 for an unknown configuration; conv_kernel.tile_smem mirrors it.
int ishara_conv_tile_smem(int dtype, int backward, int cfg, int D, int K) {
  if (dtype < 0 || dtype > 1 || cfg < 0 || cfg >= NCFG || D < 1 || K < 1)
    return -1;
  const int Dk = (D + 15) / 16 * 16, H = (K + 15) / 16 * 16;
  return (int)(dtype == 0 ? tile_smem_of<float>(backward != 0, cfg, Dk, H)
                          : tile_smem_of<bf16>(backward != 0, cfg, Dk, H));
}

// out [B, T, D] = x + SE(pw2(swish(dw(swish(pw1(LN(x))))))) in x's type,
// and for the backward p = pw2(...) + b2 (f32 [B, T, D]). Operand types as
// at the top of this file; workspace of ishara_conv_workspace(.., 0, 1, cfg,
// -1) * 256 bytes. The design is the plan's (ishara_conv_plan); otherwise
// cfg picks the tile, -1 the general path.
int ishara_conv_fwd(int device, int dtype, const void* x, const void* mask,
                    const void* gamma, const void* beta, const void* w1,
                    const void* b1, const void* wdw, const void* w2,
                    const void* b2, const void* wf1, const void* bf1,
                    const void* wf2, const void* bf2, void* out, void* p,
                    void* work, int B, int T, int D, int E, int K, int r,
                    int cfg, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Shape S{B, T, D, E, K, r, B * T};
  if (!shape_ok(S) || dtype < 0 || dtype > 1 || !cfg_ok(cfg))
    return (int)cudaErrorInvalidValue;
  const Args A{x, mask, gamma, beta, w1, b1, wdw, w2, b2, wf1, bf1, wf2, bf2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cwg::Plan pl = cwg::plan(dtype, D, E, K);
  float* pf = (float*)p;
  if (pl.wgmma || cfg >= 0)
    return dtype == 0
               ? (int)tiled_forward<float>(A, out, pf, work, S, cfg, pl, s)
               : (int)tiled_forward<bf16>(A, out, pf, work, S, cfg, pl, s);
  if (dtype == 0) return (int)chain_forward<float>(A, out, pf, work, S, s);
  return (int)chain_forward<bf16>(A, out, pf, work, S, s);
}

// dx [B, T, D] in x's type and the eleven parameter gradients, f32, one
// after the other in grads: dgamma, dbeta [D], dw1 [D, E], db1 [E],
// dwdw [K, E], dw2 [E, D], db2 [D], dwf1 [D, r], dbf1 [r], dwf2 [r, D],
// dbf2 [D]; p is the forward's. Workspace of
// ishara_conv_workspace(.., 1, splits, cfg_f, cfg_b) * 256 bytes; the
// design is the plan's, otherwise cfg_f = cfg_b = -1 takes the general path.
int ishara_conv_bwd(int device, int dtype, const void* x, const void* mask,
                    const void* dy, const void* gamma, const void* beta,
                    const void* w1, const void* b1, const void* wdw,
                    const void* w2, const void* b2, const void* wf1,
                    const void* bf1, const void* wf2, const void* bf2,
                    const void* p, void* dx, void* grads,
                    void* work, int B, int T, int D, int E, int K, int r,
                    int splits, int cfg_f, int cfg_b, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Shape S{B, T, D, E, K, r, B * T};
  if (!shape_ok(S) || splits < 1 || dtype < 0 || dtype > 1 ||
      !cfg_ok(cfg_f) || !cfg_ok(cfg_b) || (cfg_f < 0) != (cfg_b < 0))
    return (int)cudaErrorInvalidValue;
  const Args A{x, mask, gamma, beta, w1, b1, wdw, w2, b2, wf1, bf1, wf2, bf2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* g = (float*)grads;
  const float* pf = (const float*)p;
  const cwg::Plan pl = cwg::plan(dtype, D, E, K);
  if (pl.wgmma || cfg_f >= 0)
    return dtype == 0 ? (int)tiled_backward<float>(A, dy, pf, dx, g, work, S,
                                                   splits, cfg_f, cfg_b, pl, s)
                      : (int)tiled_backward<bf16>(A, dy, pf, dx, g, work, S,
                                                  splits, cfg_f, cfg_b, pl, s);
  if (dtype == 0)
    return (int)chain_backward<float>(A, dy, pf, dx, g, work, S, splits, s);
  return (int)chain_backward<bf16>(A, dy, pf, dx, g, work, S, splits, s);
}

const char* ishara_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
