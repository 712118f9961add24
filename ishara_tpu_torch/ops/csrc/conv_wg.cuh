// K7's wgmma design (included by conv_module.cu): the conv-module branch's
// forward tile kernel and backward tile kernel on Hopper's warpgroup
// products, bf16, D = 64 KD (KD 1 to 4), E a multiple of 64, K <= 16 taps.
//
// Replaces, for those shapes, the mma.sync tile kernels fwd_tile_kernel and
// bwd_tile_kernel of conv_module.cu (which stay for every other shape); the
// TPU kernels are _fwd_kernel and _bwd_kernel of
// ishara_tpu/ops/conv_kernel.py. Same function, same rounding points (the
// top of conv_module.cu).
//
// What bound the old tile kernels (a clock64 timeline, PERF.md section 6):
// their products on mma.sync and the conv passes ran in series behind
// block-wide barriers, one block of 8 warps an SM. Here a block holds a
// producer warpgroup (one thread issues every TMA copy of the weights) and
// two consumer warpgroups, each owning a time tile of its own: their
// barriers are their own (named, 128 threads), so one warpgroup's conv
// passes on the CUDA cores run while the other's products are on the tensor
// cores, and within a warpgroup the next chunk's products are issued before
// this chunk's conv passes (forward).
//
// Halo: a warpgroup's products take 64 rows (wgmma's M); its own rows are
// the 48 after a 16-row causal halo (forward: rows [t0 - 16, t0 + 48) for
// u, own rows t0 ..) or the 32 between a 16-row halo on each side
// (backward: u over [t0 - 16, t0 + 48), ds over [t0, t0 + 48)). The halo's
// rows are recomputed, not carried: the tiles are independent, so the grid
// needs no order in time and every block's two tiles run side by side. The
// recompute costs 1.33x the forward's products and 2x the backward's (the
// backward's dxn product takes 64 rows for 32); carrying a's last rows
// along a walk in time would need 32 KB a sequence at E 512 beside the
// ring, which left no room for a ring of 3 weight slots (PERF.md).
//
// Forward (fwd_wg_kernel), per warpgroup: LN of its 64 rows into a
// swizzled bf16 xn tile (a warp a row, 8 columns a lane); then for each
// chunk of 64 channels: u = xn . W1[:, c] (m64n64k16, B MN-major from the
// ring), a = swish(u + b1) into f32 shared memory (0 before t = 0), c by
// the causal conv (two threads a channel, 24 rows each, a sliding window of
// 16 taps in registers), s = swish(c) rounded into a swizzled bf16 tile,
// and p += s . W2[c, :] (4 KD products m64n64k16) accumulated in registers
// (64 x D f32: D / 2 a thread). u of chunk c + 1 is issued before the conv
// of chunk c and awaited after p of chunk c is issued, so the conv runs
// under u(c + 1) and the next epilogue under p(c). Epilogue: p + b2 written
// (f32) for the own rows before T, and the masked pool partials of the
// tile, summed over its rows in a fixed order.
//
// Backward (bwd_wg_kernel), per warpgroup: LN of its 64 rows (xn tile, xn
// of the own rows to global, the own rows' statistics), dp = dy g + dpool m
// / msum of rows [t0, t0 + 48) into a swizzled bf16 tile (dp of the own
// rows to global, their column sums for db2); then for each chunk of 32
// channels: u = xn . W1[:, c] and ds = dp . W2[c, :]^T (m64n32k16) as one
// group; a = swish(u + b1), swish'(u) of the own rows and ds into f32
// shared memory; pass 1 (a warp 12 rows, a lane a channel): c by the
// causal conv, dc = ds swish'(c) in place, s of the own rows to global;
// pass 2 (a warp 8 own rows): da by the anticausal conv, du = da swish'(u)
// into a swizzled bf16 tile and to global, the partial sums of du (db1)
// and of a dc (dwdw), added across the warps in a fixed order; then dxn +=
// du . W1[:, c]^T (KD products m64n64k16, B K-major from the same slot as
// u's: one TMA copy serves both) in registers. Epilogue: LN's backward
// with dx = dy + dx_ln for the own rows, and their dgamma / dbeta
// partials. The SE backward (from the forward's p) runs before, the weight
// products and the fixed-order sums after, as in the other designs.
//
// Rows past T read zeros (x, dy not read) and are never stored. Weights
// come by TMA: W1 [D, E] in boxes of [D][64] (forward, 128-byte swizzle) or
// [D][32] (backward, 64-byte swizzle), W2 [E, D] in boxes of [64][64] or
// [32][64]; a ring slot holds one chunk of one of them, each slot under a
// full and an empty mbarrier (waits trap after ~17 s, hopper.cuh).
//
// Bound at B 256, T 512, D 256, E 512, K 15: operations (69 GFLOP of
// products forward, 206 backward with dw1 / dw2); the MUFU work of the
// swishes (4 exponentials and divisions an element of the hidden forward,
// more backward) is of the same order as the products at the tensor
// cores' rate, which is why the design overlaps the two.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace cwg {
namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 384;      // producer warpgroup + two consumers
constexpr int HALO = 16;          // conv halo rows (K <= 16)
constexpr int FROWS = 64 - HALO;  // forward: own rows of a warpgroup
constexpr int BROWS = 64 - 2 * HALO;  // backward: own rows of a warpgroup
constexpr int BDS = 64 - HALO;    // backward: rows of dp / ds / dc
constexpr int FEC = 64, BEC = 32;  // channels a chunk, forward / backward
// f32 row strides: the forward's 72 (8 banks a row) takes the epilogue's
// 8-byte stores without bank conflicts; the backward's odd 33 its 4-byte ones
// with fewer (its shared memory has no room for 40)
constexpr int LDF = FEC + 8, LDB = BEC + 1;
constexpr int BOX = 64 * 64 * 2;  // a [64][64] bf16 box
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int MAX_SLOTS = 4;
constexpr int MAX_K = 16;
constexpr size_t EXTRA = 2048;    // alignment to 1024 and the barriers
constexpr size_t SMEM_LIMIT = 232448;

__device__ __forceinline__ float sigm(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}
__device__ __forceinline__ float dswish(float h, float sig) {
  return sig + h * sig * (1.f - sig);
}
__device__ __forceinline__ float wsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// Byte offset of element (row r, column col) in a [rows][64] bf16 tile of
// 128-byte swizzled rows, and in a [rows][32] tile of 64-byte ones.
__device__ __forceinline__ int sw128(int r, int col) {
  return r * 128 + ((((col >> 3) ^ (r & 7))) << 4) + (col & 7) * 2;
}
__device__ __forceinline__ int sw64(int r, int col) {
  return r * 64 + ((((col >> 3) ^ ((r >> 1) & 3))) << 4) + (col & 7) * 2;
}

// Descriptor offsets (16-byte units) of k16 step ks of a K-major operand of
// KD boxes [rows][64] (box stride `box` bytes), and of an MN-major one.
__device__ __forceinline__ uint64_t kstep(int ks, int box) {
  return (uint64_t)(((ks >> 2) * box + (ks & 3) * 32) >> 4);
}
__device__ __forceinline__ uint64_t mnstep(int ks, int row_bytes) {
  return (uint64_t)((ks * 16 * row_bytes) >> 4);
}

struct Args {
  const bf16 *x, *dy;
  const float *mask, *gamma, *beta, *b1, *wdw, *b2;
  float* p;             // forward: p = pw2(...) + b2, f32 [B, T, D]
  float* part_mp;       // forward: [B, tiles, D]
  const float *gate, *dpool, *msum;   // backward: [B, D], [B, D], [B]
  bf16 *dx, *xn_g, *dp_g, *s_g, *du_g;  // backward
  float *part_ln, *part_e, *part_db2;   // backward: [B, tiles] x [2D], [E +
                                        // KE], [D]
  int T, E, K, tiles, slots;
};

// The ring: S slots of `slot` bytes after `fixed` bytes of tiles, then the
// f32 regions; barriers at the end. Thread 0 initialises the barriers; the
// empty barriers count the active consumer warps.
struct Ring {
  unsigned char* base;   // the fixed tiles
  unsigned char* slots;
  float* f32;            // the f32 regions
  uint64_t *full, *empty;
};

__device__ __forceinline__ Ring carve(unsigned char* raw, size_t fixed,
                                      size_t slot, int S, size_t f32_bytes,
                                      int consumer_warps) {
  Ring r;
  r.base = align1024(raw);
  r.slots = r.base + fixed;
  r.f32 = reinterpret_cast<float*>(r.slots + (size_t)S * slot);
  r.full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(r.f32) + ((f32_bytes + 15) / 16) * 16);
  r.empty = r.full + S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(&r.full[s], 1);
      bar_init(&r.empty[s], consumer_warps);
    }
    bar_init_fence();
  }
  __syncthreads();
  return r;
}

// The producer (one thread): per chunk c W1[:, c] then W2[c, :], load L
// into slot L % S at round L / S. W1's chunk is one box; W2's KD boxes of
// `w2_rows` x 64.
template <int KD>
__device__ __forceinline__ void produce(const CUtensorMap* tw1,
                                        const CUtensorMap* tw2,
                                        const Ring& r, int S, int nc, int ec,
                                        int slot_bytes) {
  const int w2_box = ec * 128;  // [ec][64] bf16
  for (int c = 0, L = 0; c < nc; ++c)
    for (int part = 0; part < 2; ++part, ++L) {
      const int s = L % S;
      bar_wait(&r.empty[s], ((L / S) & 1) ^ 1);
      bar_expect(&r.full[s], slot_bytes);
      unsigned char* dst = r.slots + (size_t)s * slot_bytes;
      if (part == 0) {
        if (ec == 64)
          tma_load(dst, tw1, &r.full[s], ec * c, 0);
        else  // a 4-D map: the 64-byte swizzle
          tma_load4(dst, tw1, &r.full[s], ec * c, 0, 0, 0);
      } else {
#pragma unroll
        for (int kb = 0; kb < KD; ++kb)
          tma_load(dst + kb * w2_box, tw2, &r.full[s], 64 * kb, ec * c);
      }
    }
}

// LN of rows [tb, tb + 64) of sequence b into the warpgroup's xn tile (KD
// boxes [64][64], 128-byte swizzle): a warp 16 rows, all in flight, lane l
// columns [8l, 8l + 8); rows outside [0, T) are zeros. The rows [own0,
// own0 + nown) also go to xn_g (when given) and leave their mean and rstd
// in stats[2][n].
template <int KD>
__device__ __forceinline__ void ln_tile(const Args& P, int b, int tb,
                                        unsigned char* xn, int warp, int lane,
                                        bf16* xn_g, float* stats, int own0,
                                        int nown) {
  constexpr int D = 64 * KD;
  const bool on = lane < D / 8;
  const int col = lane * 8;
  float gm[8], bt[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    gm[e] = on ? P.gamma[col + e] : 0.f;
    bt[e] = on ? P.beta[col + e] : 0.f;
  }
  {
    constexpr int i0 = 0;
    uint4 rows[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int tg = tb + 16 * warp + i0 + i;
      rows[i] = tg >= 0 && tg < P.T && on
                    ? *reinterpret_cast<const uint4*>(
                          P.x + ((long long)b * P.T + tg) * D + col)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = 16 * warp + i0 + i, tg = tb + r;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (tg >= 0 && tg < P.T) {
        const bf16* xv = reinterpret_cast<const bf16*>(&rows[i]);
        float v[8], s = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] = __bfloat162float(xv[e]);
          s += v[e];
        }
        const float mu = wsum(s) / D;
        float q = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float c = on ? v[e] - mu : 0.f;
          q += c * c;
        }
        const float rstd = rsqrtf(wsum(q) / D + 1e-6f);
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = (v[e] - mu) * rstd * gm[e] + bt[e];
        packed =
            make_uint4(tc::pack_bf16(o[0], o[1]), tc::pack_bf16(o[2], o[3]),
                       tc::pack_bf16(o[4], o[5]), tc::pack_bf16(o[6], o[7]));
        if (r >= own0 && r < own0 + nown) {
          if (xn_g && on)
            *reinterpret_cast<uint4*>(xn_g + ((long long)b * P.T + tg) * D +
                                      col) = packed;
          if (stats && lane == 0) {
            stats[r - own0] = mu;
            stats[nown + r - own0] = rstd;
          }
        }
      }
      if (on)
        *reinterpret_cast<uint4*>(xn + (lane >> 3) * BOX +
                                  sw128(r, (lane & 7) * 8)) = packed;
    }
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Bytes of the forward's fixed tiles (two warpgroups' xn and s) and f32
// regions (their a buffers; the pool's cross-warp sums reuse them).
__host__ __device__ constexpr size_t fwd_fixed(int KD) {
  return 2 * ((size_t)KD * BOX + BOX);
}
__host__ __device__ constexpr size_t fwd_f32(int) {
  return 2 * (size_t)64 * LDF * 4;
}

// Grid (ceil(tiles / 2), B): warpgroup w of block x owns tile 2x + w of
// sequence blockIdx.y, own rows [48 tile, 48 tile + 48).
template <int KD>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_wg_kernel(const __grid_constant__ CUtensorMap tw1,
                  const __grid_constant__ CUtensorMap tw2, const Args P) {
  constexpr int D = 64 * KD, TILE = KD * BOX;
  extern __shared__ unsigned char smem_raw[];
  const int b = blockIdx.y, S = P.slots, nc = P.E / FEC;
  const int active = min(2, P.tiles - 2 * (int)blockIdx.x);
  const Ring r = carve(smem_raw, fwd_fixed(KD), (size_t)TILE, S, fwd_f32(KD),
                       4 * active);
  if (threadIdx.x < 128) {
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) produce<KD>(&tw1, &tw2, r, S, nc, FEC, TILE);
    return;
  }
  regs_inc<CONSUMER_REGS>();
  const int w = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  if (w >= active) return;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int tile = 2 * blockIdx.x + w, t0 = FROWS * tile;
  unsigned char* xn = r.base + (size_t)w * TILE;
  unsigned char* st = r.base + 2 * (size_t)TILE + (size_t)w * BOX;
  float* abuf = r.f32 + (size_t)w * 64 * LDF;
  const uint64_t dxn = desc(xn), dst_ = desc(st);
  const long long seq = (long long)b * P.T;

  // s rows past the own rows feed only p rows that are never stored
  for (int i = tid; i < (64 - FROWS) * 64 / 8; i += 128)
    *reinterpret_cast<uint4*>(st + FROWS * 128 + i * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  ln_tile<KD>(P, b, t0 - HALO, xn, warp, lane, nullptr, nullptr, 0, 0);
  fence_async_smem();
  named_sync(1 + w, 128);

  float p[KD][32], u[32];
  auto slot = [&](int L) { return r.slots + (size_t)(L % S) * TILE; };
  auto acquire = [&](int L) { bar_wait(&r.full[L % S], (L / S) & 1); };
  auto release = [&](int L) {
    if (lane == 0) bar_arrive(&r.empty[L % S]);
  };
  auto issue_u = [&](int c) {
    acquire(2 * c);
    const uint64_t dw = desc(slot(2 * c));
    fence_regs(u);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * KD; ++ks)
      mma_ss<1>(u, dxn + kstep(ks, BOX), dw + mnstep(ks, 128), ks > 0);
    wg_commit();
  };
  auto issue_p = [&](int c) {
    acquire(2 * c + 1);
    const uint64_t dw = desc(slot(2 * c + 1));
#pragma unroll
    for (int nb = 0; nb < KD; ++nb) fence_regs(p[nb]);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int nb = 0; nb < KD; ++nb)
        mma_ss<1>(p[nb], dst_ + kstep(ks, BOX),
                  dw + (uint64_t)(nb * BOX >> 4) + mnstep(ks, 128),
                  c > 0 || ks > 0);
    wg_commit();
  };
  // The chunk's biases of a thread's columns and the taps of its conv
  // channel, loaded ahead of their use (a chunk's loads then wait under
  // other work, not at the head of the epilogue or the conv)
  float bias[16], tap[16];
  auto load_bias = [&](int c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      bias[2 * j] = P.b1[c * FEC + 8 * j + 2 * t];
      bias[2 * j + 1] = P.b1[c * FEC + 8 * j + 2 * t + 1];
    }
  };
  auto load_taps = [&](int c) {
    const int ec = c * FEC + (tid & 63);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = j - (16 - P.K);
      tap[j] = k >= 0 ? P.wdw[k * P.E + ec] : 0.f;
    }
  };
  // a = swish(u + b1) of the chunk into abuf, 0 before t = 0
  auto epilogue_u = [&]() {
    fence_regs(u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * warp + g + 8 * hh;
        float a2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float uv = u[4 * j + 2 * hh + e] + bias[2 * j + e];
          a2[e] = t0 - HALO + row >= 0 ? uv * sigm(uv) : 0.f;
        }
        *reinterpret_cast<float2*>(abuf + row * LDF + col) =
            make_float2(a2[0], a2[1]);
      }
    }
  };
  // s = swish(causal conv of a) of the own rows into the s tile; thread
  // (channel tid % 64, half tid / 64) keeps 16 taps and a window of 19
  // rows: 4 rows at a time, their sums independent chains and their loads
  // ahead of their stores (a row at a time ran at the latency of its chain)
  auto conv = [&]() {
    const int e = tid & 63, q0 = (tid >> 6) * (FROWS / 2);
    float win[19];  // a rows q0 + q + 1 + i
#pragma unroll
    for (int i = 0; i < 15; ++i) win[i + 4] = abuf[(q0 + 1 + i) * LDF + e];
#pragma unroll
    for (int q = 0; q < FROWS / 2; q += 4) {
#pragma unroll
      for (int i = 0; i < 15; ++i) win[i] = win[i + 4];
#pragma unroll
      for (int r = 0; r < 4; ++r) win[15 + r] = abuf[(q0 + q + 16 + r) * LDF + e];
      float cv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] += tap[j] * win[r + j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<bf16*>(st + sw128(q0 + q + r, e)) =
            __float2bfloat16(cv[r] * sigm(cv[r]));
    }
  };

  // a tile loop (one pass: a block owns its two tiles), as in ffn.cu: as
  // straight-line code ptxas may serialise the products
  for (int pass = 0; pass < 1; ++pass) {
    issue_u(0);
    load_bias(0);
    load_taps(0);
    wg_wait<0>();
    release(0);
    epilogue_u();
    named_sync(1 + w, 128);
    for (int c = 0; c < nc; ++c) {
      if (c > 0) {  // p(c - 1) done: s and W2(c - 1) are free
        wg_wait<0>();
        release(2 * c - 1);
      }
      if (c + 1 < nc) {
        issue_u(c + 1);
        load_bias(c + 1);
      }
      conv();
      fence_async_smem();
      named_sync(1 + w, 128);
      issue_p(c);
      if (c + 1 < nc) {
        load_taps(c + 1);
        wg_wait<1>();  // u(c + 1); p(c) may be in flight
        release(2 * c + 2);
        epilogue_u();
        named_sync(1 + w, 128);
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int nb = 0; nb < KD; ++nb) fence_regs(p[nb]);
    release(2 * nc - 1);
  }

  // p + b2 of the own rows (p rows 0 .. 47: warps 0 to 2) before T, and the
  // pool partial of each column: a thread's two rows, the warp's 16 rows
  // across g (a fixed butterfly), then warps 0, 1, 2 in order
  float* red = abuf;  // [3][D]; abuf's last reader (conv) is done
  if (warp < FROWS / 16) {
    // every load ahead of the stores (which the compiler may not pass)
    float m[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int tg = t0 + 16 * warp + g + 8 * hh;
      m[hh] = tg < P.T ? P.mask[seq + tg] : 0.f;
    }
#pragma unroll
    for (int nb = 0; nb < KD; ++nb) {
      float bb[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bb[j][0] = P.b2[nb * 64 + 8 * j + 2 * t];
        bb[j][1] = P.b2[nb * 64 + 8 * j + 2 * t + 1];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nb * 64 + 8 * j + 2 * t;
        float sm[2] = {0.f, 0.f};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int tg = t0 + 16 * warp + g + 8 * hh;
          if (tg >= P.T) continue;
          const float v0 = p[nb][4 * j + 2 * hh] + bb[j][0];
          const float v1 = p[nb][4 * j + 2 * hh + 1] + bb[j][1];
          *reinterpret_cast<float2*>(P.p + (seq + tg) * D + col) =
              make_float2(v0, v1);
          sm[0] += m[hh] * v0;
          sm[1] += m[hh] * v1;
        }
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            sm[e2] += __shfl_xor_sync(0xffffffffu, sm[e2], o);
          if (g == 0) red[warp * D + col + e2] = sm[e2];
        }
      }
    }
  }
  named_sync(1 + w, 128);
  float* part = P.part_mp + ((long long)b * P.tiles + tile) * D;
  for (int d = tid; d < D; d += 128) {
    float v = red[d];
#pragma unroll
    for (int k = 1; k < FROWS / 16; ++k) v += red[k * D + d];
    part[d] = v;
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Bytes of the backward's fixed tiles (two warpgroups' xn [64][D], dp
// [48][D], du [64][32]) and f32 regions (a [64][33], dc [48][33], swish'(u)
// [32][33], the LN statistics [2][32], each twice).
__host__ __device__ constexpr size_t bwd_fixed(int KD) {
  return 2 * ((size_t)KD * BOX + (size_t)KD * BDS * 128 + 64 * 64);
}
__host__ __device__ constexpr size_t bwd_f32(int) {
  return 2 * (size_t)(64 * LDB + BDS * LDB + BROWS * LDB + 2 * BROWS) * 4;
}

// Grid (ceil(tiles / 2), B): warpgroup w of block x owns tile 2x + w of
// sequence blockIdx.y, own rows [32 tile, 32 tile + 32).
template <int KD>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_wg_kernel(const __grid_constant__ CUtensorMap tw1,
                  const __grid_constant__ CUtensorMap tw2, const Args P) {
  constexpr int D = 64 * KD, TILE = KD * BOX, SLOT = D * BEC * 2;
  constexpr int DPBOX = BDS * 128;  // a dp box [48][64]
  extern __shared__ unsigned char smem_raw[];
  const int b = blockIdx.y, S = P.slots, nc = P.E / BEC;
  const int active = min(2, P.tiles - 2 * (int)blockIdx.x);
  const Ring r = carve(smem_raw, bwd_fixed(KD), (size_t)SLOT, S, bwd_f32(KD),
                       4 * active);
  if (threadIdx.x < 128) {
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) produce<KD>(&tw1, &tw2, r, S, nc, BEC, SLOT);
    return;
  }
  regs_inc<CONSUMER_REGS>();
  const int w = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  if (w >= active) return;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int tile = 2 * blockIdx.x + w, t0 = BROWS * tile;
  unsigned char* xn = r.base + (size_t)w * TILE;
  unsigned char* dps = r.base + 2 * (size_t)TILE + (size_t)w * KD * DPBOX;
  unsigned char* dus = r.base + 2 * (size_t)TILE + 2 * (size_t)KD * DPBOX +
                       (size_t)w * 64 * 64;
  float* abuf = r.f32 + (size_t)w * (64 + BDS + BROWS) * LDB;
  float* dcb = abuf + 64 * LDB;
  float* dsu = dcb + BDS * LDB;
  float* stats = r.f32 + (size_t)2 * (64 + BDS + BROWS) * LDB + w * 2 * BROWS;
  const uint64_t dxd = desc(xn), dpd = desc(dps), dud = desc64(dus);
  const long long seq = (long long)b * P.T;
  const long long part = (long long)b * P.tiles + tile;

  // du rows past the own rows feed only dxn rows that are never used
  for (int i = tid; i < (64 - BROWS) * 64 / 16; i += 128)
    *reinterpret_cast<uint4*>(dus + BROWS * 64 + i * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  ln_tile<KD>(P, b, t0 - HALO, xn, warp, lane, P.xn_g, stats, HALO, BROWS);
  {  // dp of rows [t0, t0 + 48) (zero past T): a warp 12 rows, a lane 8
     // columns; the own rows to dp_g and their column sums (db2), the
     // warps' sums added in order through abuf
    const bool on = lane < D / 8;
    const int col = lane * 8;
    const float ms = P.msum[b];
    float gd[8], pd[8], sum[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gd[e] = on ? P.gate[(long long)b * D + col + e] : 0.f;
      pd[e] = on ? P.dpool[(long long)b * D + col + e] : 0.f;
      sum[e] = 0.f;
    }
    uint4 rows[BDS / 4];  // the warp's 12 rows of dy in flight at once
    float mrow[BDS / 4];
#pragma unroll
    for (int i = 0; i < BDS / 4; ++i) {
      const int tg = t0 + warp * (BDS / 4) + i;
      const bool in = tg < P.T;
      rows[i] = in && on ? *reinterpret_cast<const uint4*>(
                               P.dy + (seq + tg) * D + col)
                         : make_uint4(0u, 0u, 0u, 0u);
      mrow[i] = in ? P.mask[seq + tg] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BDS / 4; ++i) {
      const int q = warp * (BDS / 4) + i, tg = t0 + q;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (tg < P.T && on) {
        const bf16* dv = reinterpret_cast<const bf16*>(&rows[i]);
        const float mq = mrow[i] / ms;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __bfloat162float(dv[e]) * gd[e] + pd[e] * mq;
      }
      const uint4 packed =
          make_uint4(tc::pack_bf16(v[0], v[1]), tc::pack_bf16(v[2], v[3]),
                     tc::pack_bf16(v[4], v[5]), tc::pack_bf16(v[6], v[7]));
      if (on) {
        *reinterpret_cast<uint4*>(dps + (lane >> 3) * DPBOX +
                                  sw128(q, (lane & 7) * 8)) = packed;
        if (q < BROWS && tg < P.T) {
          *reinterpret_cast<uint4*>(P.dp_g + (seq + tg) * D + col) = packed;
#pragma unroll
          for (int e = 0; e < 8; ++e) sum[e] += v[e];
        }
      }
    }
    if (on)
#pragma unroll
      for (int e = 0; e < 8; ++e) abuf[warp * D + col + e] = sum[e];
    named_sync(1 + w, 128);
    for (int d = tid; d < D; d += 128)
      P.part_db2[part * D + d] =
          ((abuf[d] + abuf[D + d]) + abuf[2 * D + d]) + abuf[3 * D + d];
  }
  fence_async_smem();
  named_sync(1 + w, 128);

  float dxa[KD][32], u[16], ds[16];
  auto slot = [&](int L) { return r.slots + (size_t)(L % S) * SLOT; };
  auto acquire = [&](int L) { bar_wait(&r.full[L % S], (L / S) & 1); };
  auto release = [&](int L) {
    if (lane == 0) bar_arrive(&r.empty[L % S]);
  };

  for (int pass = 0; pass < 1; ++pass) {  // one tile: see the forward
    for (int c = 0; c < nc; ++c) {
      const int ec0 = c * BEC;
      // u = xn . W1[:, c] and ds = dp . W2[c, :]^T, one group
      acquire(2 * c);
      acquire(2 * c + 1);
      {
        const uint64_t dw1 = desc64(slot(2 * c)), dw2 = desc(slot(2 * c + 1));
        fence_regs(u);
        fence_regs(ds);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4 * KD; ++ks)
          mma_ss<1>(u, dxd + kstep(ks, BOX), dw1 + mnstep(ks, 64), ks > 0);
#pragma unroll
        for (int ks = 0; ks < 4 * KD; ++ks)
          mma_ss<0>(ds, dpd + kstep(ks, DPBOX), dw2 + kstep(ks, BEC * 128),
                    ks > 0);
        wg_commit();
      }
      // the chunk's taps of a lane's channel and biases of a thread's
      // columns, loaded while the products run
      float tap[16], bias[8];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = j - (16 - P.K);
        tap[j] = k >= 0 ? P.wdw[k * P.E + ec0 + lane] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bias[2 * j] = P.b1[ec0 + 8 * j + 2 * t];
        bias[2 * j + 1] = P.b1[ec0 + 8 * j + 2 * t + 1];
      }
      wg_wait<0>();  // and dxn(c - 1): du and W1(c - 1) are free
      fence_regs(u);
      fence_regs(ds);
      release(2 * c + 1);
      if (c > 0) release(2 * c - 2);
      // a = swish(u + b1) (0 before t = 0), swish'(u) of the own rows, ds
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * j + 2 * t;
        const float bb[2] = {bias[2 * j], bias[2 * j + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * warp + g + 8 * (e >> 1), cc = col + (e & 1);
          const float uv = u[4 * j + e] + bb[e & 1];
          const float sg = sigm(uv);
          abuf[row * LDB + cc] = t0 - HALO + row >= 0 ? uv * sg : 0.f;
          if (row >= HALO && row < HALO + BROWS)
            dsu[(row - HALO) * LDB + cc] = dswish(uv, sg);
          if (row < BDS) dcb[row * LDB + cc] = ds[4 * j + e];
        }
      }
      named_sync(1 + w, 128);
      // the conv passes take 4 rows at a time: their sums independent
      // chains, their loads ahead of their stores
      {  // pass 1: c, dc = ds swish'(c) in place, s of the own rows
        constexpr int R1 = BDS / 4;
        const int q0 = warp * R1;
        float win[19];  // a rows q0 + q + 1 + i (abuf's rows: t0 - 16 + index)
#pragma unroll
        for (int i = 0; i < 15; ++i) win[i + 4] = abuf[(q0 + 1 + i) * LDB + lane];
#pragma unroll
        for (int q = 0; q < R1; q += 4) {
#pragma unroll
          for (int i = 0; i < 15; ++i) win[i] = win[i + 4];
          float dsv[4], cv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            win[15 + r] = abuf[(q0 + q + 16 + r) * LDB + lane];
            dsv[r] = dcb[(q0 + q + r) * LDB + lane];
          }
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) cv[r] += tap[j] * win[r + j];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float sg = sigm(cv[r]);
            dcb[(q0 + q + r) * LDB + lane] = dsv[r] * dswish(cv[r], sg);
            const int tg = t0 + q0 + q + r;
            if (q0 + q + r < BROWS && tg < P.T)
              P.s_g[(seq + tg) * P.E + ec0 + lane] =
                  __float2bfloat16(cv[r] * sg);
          }
        }
      }
      named_sync(1 + w, 128);
      float db = 0.f, dw[16];
      {  // pass 2: da, du, the sums for db1 and dwdw over the own rows
        constexpr int R2 = BROWS / 4;
        const int q0 = warp * R2;
#pragma unroll
        for (int j = 0; j < 16; ++j) dw[j] = 0.f;
        // dcw[i] = dc row q0 + q + i, aw[i] = a row q0 + q + 1 + i
        float dcw[19], aw[19];
#pragma unroll
        for (int i = 0; i < 15; ++i) {
          dcw[i + 4] = dcb[(q0 + i) * LDB + lane];
          aw[i + 4] = abuf[(q0 + 1 + i) * LDB + lane];
        }
#pragma unroll
        for (int q = 0; q < R2; q += 4) {
#pragma unroll
          for (int i = 0; i < 15; ++i) {
            dcw[i] = dcw[i + 4];
            aw[i] = aw[i + 4];
          }
          float dsu4[4], da[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            dcw[15 + r] = dcb[(q0 + q + 15 + r) * LDB + lane];
            aw[15 + r] = abuf[(q0 + q + 16 + r) * LDB + lane];
            dsu4[r] = dsu[(q0 + q + r) * LDB + lane];
          }
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) da[r] += tap[j] * dcw[r + 15 - j];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int tt = q0 + q + r, tg = t0 + tt;
            const float du = da[r] * dsu4[r];
            const bf16 dur = __float2bfloat16(du);
            *reinterpret_cast<bf16*>(dus + sw64(tt, lane)) = dur;
            if (tg < P.T) {
              P.du_g[(seq + tg) * P.E + ec0 + lane] = dur;
              db += du;
#pragma unroll
              for (int j = 0; j < 16; ++j) dw[j] += aw[r + j] * dcw[r];
            }
          }
        }
      }
      // the warps' sums added in a fixed order, ((0 + 1) + (2 + 3)),
      // through dcb (its last reader, pass 2, is done)
      named_sync(1 + w, 128);
      float* red = dcb;  // [2][17][32]
      if (warp & 1) {
        red[((warp >> 1) * 17) * 32 + lane] = db;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          red[((warp >> 1) * 17 + 1 + j) * 32 + lane] = dw[j];
      }
      named_sync(1 + w, 128);
      if (!(warp & 1)) {
        db += red[((warp >> 1) * 17) * 32 + lane];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dw[j] += red[((warp >> 1) * 17 + 1 + j) * 32 + lane];
      }
      named_sync(1 + w, 128);
      if (warp == 2) {
        red[lane] = db;
#pragma unroll
        for (int j = 0; j < 16; ++j) red[(1 + j) * 32 + lane] = dw[j];
      }
      named_sync(1 + w, 128);
      if (warp == 0) {
        db += red[lane];
        float* pe = P.part_e + part * (P.E + (long long)P.K * P.E);
        pe[ec0 + lane] = db;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int k = j - (16 - P.K);
          if (k >= 0)
            pe[P.E + (long long)k * P.E + ec0 + lane] =
                dw[j] + red[(1 + j) * 32 + lane];
        }
      }
      fence_async_smem();
      named_sync(1 + w, 128);
      {  // dxn += du . W1[:, c]^T (W1's slot is still held)
        const uint64_t dw1 = desc64(slot(2 * c));
#pragma unroll
        for (int nb = 0; nb < KD; ++nb) fence_regs(dxa[nb]);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int nb = 0; nb < KD; ++nb)
            mma_ss<0>(dxa[nb], dud + (uint64_t)(2 * ks),
                      dw1 + (uint64_t)((nb * 64 * 64) >> 4) + (uint64_t)(2 * ks),
                      c > 0 || ks > 0);
        wg_commit();
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int nb = 0; nb < KD; ++nb) fence_regs(dxa[nb]);
    release(2 * nc - 2);
  }

  // LN's backward for the own rows. dxn rows 0 .. 31 (warps 0 and 1's
  // accumulators) are staged as f32 [32][D] over the xn tile (its last
  // reader, u of the last chunk, is done); then a warp takes 8 rows, a lane
  // 8 columns, every row's x and dy in flight at once: dxh = dxn gamma; dx
  // = dy + (dxh - mean(dxh) - xh mean(dxh xh)) rstd; and the partials of
  // dgamma, dbeta over the rows before T, a lane's rows in order, then the
  // four warps in order.
  float* dxs = reinterpret_cast<float*>(xn);
  if (warp < BROWS / 16)
#pragma unroll
    for (int nb = 0; nb < KD; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(
              dxs + (16 * warp + g + 8 * hh) * D + nb * 64 + 8 * j + 2 * t) =
              make_float2(dxa[nb][4 * j + 2 * hh], dxa[nb][4 * j + 2 * hh + 1]);
  named_sync(1 + w, 128);
  {
    constexpr int RW = BROWS / 4;  // rows a warp
    const bool on = lane < D / 8;
    const int col = lane * 8;
    float gm[8], sgs[8], sbs[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gm[e] = on ? P.gamma[col + e] : 0.f;
      sgs[e] = sbs[e] = 0.f;
    }
    uint4 xr[RW], dr[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int tg = t0 + warp * RW + i;
      const bool in = tg < P.T && on;
      xr[i] = in ? *reinterpret_cast<const uint4*>(P.x + (seq + tg) * D + col)
                 : make_uint4(0u, 0u, 0u, 0u);
      dr[i] = in ? *reinterpret_cast<const uint4*>(P.dy + (seq + tg) * D +
                                                   col)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int tt = warp * RW + i, tg = t0 + tt;
      if (tg >= P.T) continue;
      const float mu = stats[tt], rstd = stats[BROWS + tt];
      const bf16* xv = reinterpret_cast<const bf16*>(&xr[i]);
      const bf16* dv = reinterpret_cast<const bf16*>(&dr[i]);
      float dn[8], h[8], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        dn[e] = on ? dxs[tt * D + col + e] : 0.f;
        h[e] = (__bfloat162float(xv[e]) - mu) * rstd;
        const float dxh = dn[e] * gm[e];
        s1 += dxh;
        s2 += dxh * h[e];
      }
      const float m1 = wsum(s1) / D, m2 = wsum(s2) / D;
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        o[e] = __bfloat162float(dv[e]) + (dn[e] * gm[e] - m1 - h[e] * m2) * rstd;
        sgs[e] += dn[e] * h[e];
        sbs[e] += dn[e];
      }
      if (on)
        *reinterpret_cast<uint4*>(P.dx + (seq + tg) * D + col) =
            make_uint4(tc::pack_bf16(o[0], o[1]), tc::pack_bf16(o[2], o[3]),
                       tc::pack_bf16(o[4], o[5]), tc::pack_bf16(o[6], o[7]));
    }
    float* red = abuf;  // [4][2][D]; abuf's last readers are done
    if (on)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        red[warp * 2 * D + col + e] = sgs[e];
        red[warp * 2 * D + D + col + e] = sbs[e];
      }
    named_sync(1 + w, 128);
    for (int i = tid; i < 2 * D; i += 128)
      P.part_ln[part * 2 * D + i] =
          ((red[i] + red[2 * D + i]) + red[4 * D + i]) + red[6 * D + i];
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The design's plan of (dtype, D, E, K), mirrored by conv_kernel.conv_plan:
// bf16, D a multiple of 64 up to 256, E a multiple of 64, 1 <= K <= 16, a
// ring of at least 3 slots forward and 4 backward (the backward holds W1's
// chunk across two groups).
struct Plan {
  bool wgmma;
  int fwd_slots, bwd_slots;
  size_t fwd_smem, bwd_smem;
};

inline Plan plan(int dtype, int D, int E, int K) {
  Plan p{};
  if (dtype != 1 || D % 64 || D < 64 || D > 256 || E % 64 || E <= 0 ||
      K < 1 || K > MAX_K)
    return p;
  const int KD = D / 64;
  const size_t ff = EXTRA + fwd_fixed(KD) + fwd_f32(KD);
  const size_t bf = EXTRA + bwd_fixed(KD) + bwd_f32(KD);
  const size_t fslot = (size_t)D * FEC * 2, bslot = (size_t)D * BEC * 2;
  const long long fs = ((long long)SMEM_LIMIT - (long long)ff) / (long long)fslot;
  const long long bs = ((long long)SMEM_LIMIT - (long long)bf) / (long long)bslot;
  p.fwd_slots = (int)(fs < MAX_SLOTS ? fs : MAX_SLOTS);
  p.bwd_slots = (int)(bs < MAX_SLOTS ? bs : MAX_SLOTS);
  if (p.fwd_slots < 3 || p.bwd_slots < 4) return Plan{};
  p.wgmma = true;
  p.fwd_smem = ff + p.fwd_slots * fslot;
  p.bwd_smem = bf + p.bwd_slots * bslot;
  return p;
}

inline int fwd_tiles(int T) { return (T + FROWS - 1) / FROWS; }
inline int bwd_tiles(int T) { return (T + BROWS - 1) / BROWS; }

// W1 [D, E] in boxes of [D][ec] and W2 [E, D] in boxes of [ec][64]; ec 64
// takes the 128-byte swizzle for W1, ec 32 the 64-byte one.
inline cudaError_t maps(const void* w1, const void* w2, int D, int E, int ec,
                        CUtensorMap* tw1, CUtensorMap* tw2) {
  cudaError_t e;
  if (ec == 64) {
    e = tensor_map(tw1, w1, D, E, D, 64);
  } else {
    const uint64_t dims[4] = {(uint64_t)E, (uint64_t)D, 1, 1};
    const uint64_t strides[3] = {(uint64_t)E * 2, (uint64_t)E * D * 2,
                                 (uint64_t)E * D * 2};
    e = tensor_map4(tw1, w1, dims, strides, D, ec);
  }
  if (e != cudaSuccess) return e;
  return tensor_map(tw2, w2, E, D, ec, 64);
}

template <typename Kern>
cudaError_t allow(Kern kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int KD>
cudaError_t forward(const Plan& pl, const void* w1, const void* w2, Args a,
                    int B, cudaStream_t s) {
  CUtensorMap tw1, tw2;
  cudaError_t e = maps(w1, w2, 64 * KD, a.E, FEC, &tw1, &tw2);
  if (e != cudaSuccess) return e;
  e = allow(fwd_wg_kernel<KD>, pl.fwd_smem);
  if (e != cudaSuccess) return e;
  a.tiles = fwd_tiles(a.T);
  a.slots = pl.fwd_slots;
  fwd_wg_kernel<KD><<<dim3((a.tiles + 1) / 2, B), THREADS, pl.fwd_smem, s>>>(
      tw1, tw2, a);
  return cudaGetLastError();
}

template <int KD>
cudaError_t backward(const Plan& pl, const void* w1, const void* w2, Args a,
                     int B, cudaStream_t s) {
  CUtensorMap tw1, tw2;
  cudaError_t e = maps(w1, w2, 64 * KD, a.E, BEC, &tw1, &tw2);
  if (e != cudaSuccess) return e;
  e = allow(bwd_wg_kernel<KD>, pl.bwd_smem);
  if (e != cudaSuccess) return e;
  a.tiles = bwd_tiles(a.T);
  a.slots = pl.bwd_slots;
  bwd_wg_kernel<KD><<<dim3((a.tiles + 1) / 2, B), THREADS, pl.bwd_smem, s>>>(
      tw1, tw2, a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cwg
