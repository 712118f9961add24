// The attention forward on Hopper (sm_90a), bf16 heads of 32 and 64:
// warpgroup products on a TMA key / value ring, one templated kernel for K8
// (any T, no dropout) and K3 (T <= 384, dropout on the normalised weights
// with the keep bits written for its one-pass backward), and K8's plan,
// which also sends its backward to the one-pass wgmma kernel of
// attention_bwd.cuh. Included by attention_blocked.cu and attention.cu.
//
// Replaces the Pallas kernel _fwd_kernel of ishara_tpu/ops/attention_blocked.py
// (:46, its pallas_call :145, behind flash_mhsa_blocked :159) where
// k8wg::plan below takes the call, and _fwd_kernel of
// ishara_tpu/ops/attention.py (:60, its pallas_call :131, behind flash_mhsa
// :145) where k3wg::plan (attention_bwd.cuh) takes it: bf16, a head
// dimension of 32 or 64, q, k, v rows that TMA can read (16-byte strides and
// bases), any T for K8, T <= 384 for K3. Every other call keeps the forward
// of attention_tc.cuh (mma.sync, cp.async).
//
// It computes what blocked_attention_forward_plain in
// ops/attention_blocked.py and mhsa_forward_plain in ops/attention.py write:
// s = q.k * scale + bias, the online softmax over 64-key tiles, l summed
// over the undropped weights, o = (sum (p * keep') v) / l rounded once,
// lse = m + log l in natural-log units. Keys in [T, Tc) arrive as zeros
// (TMA reads past the tensor) with the bias -1e30 and count; keys at or past
// Tc weigh exactly 0 (the 64-key tile need not divide Tc, the padded length;
// K3 passes Tc = T). keep' = keep / (1 - rate) with keep the Philox function
// of (seed, offset + flat index into [B, H, T, T]) of philox.cuh, the mask
// head of a tensor-parallel rank's local head as attention_tc.cuh's
// mask_head takes it; the bits are the same as tc::fwd_kernel's.
//
// Bound at K8's long step's shape (q, k, v [256, 8, 512, 32]): bytes on the
// table, 272 MB, 0.0815 ms at 3.35 TB/s, against 2 [T, T] products, 68.7
// GFLOP, 0.0695 ms at 989 TFLOP/s. Below both lies the floor this design is
// built around: B H T Tc = 537 M exponentials, at 16 a clock an SM (the
// multi-function unit) on 132 SMs at 1.98 GHz 0.128 ms. At K3's flagship
// shape ([256, 8, 176, 32], rate 0.4) bytes bind (94 MB, 0.028 ms); the 63.4
// M exponentials take 0.0152 ms and the Philox words, 40 integer multiplies
// a block of 4 weights, ~0.038 ms at 64 a clock an SM: the mask, not the
// exponentials, is the floor under K3's forward.
//
// What bounded the old forwards (PERF.md, section 6: clock64 timelines of
// debug copies of tc::fwd_kernel): a block of 64 queries, four warps of
// mma.sync, two __syncthreads and a cp.async double buffer a key tile, each
// head's K and V read T / 64 times, every phase of a tile in series; K3's
// Philox words took 35% of its warps' clocks at T 176 (44% at T 384), the
// loads and their waits 19%, the S product 14%.
//
// The design:
// - a persistent grid, one block an SM; a unit of work is (b, h, a group of
//   NW 64-query tiles), units in head order so that the blocks running at
//   once share a head's K and V in L2. K8 takes NW = 4 consumer warpgroups
//   with 112 registers a thread (fewer warps left the exponential unit
//   idler); K3 takes NW = 3 with 160: T 176 is three query tiles and T 384
//   six, so no warpgroup idles at the flagship or the longest T, and the
//   Philox words need the registers;
// - warpgroup 0 is the producer: one thread issues every TMA copy (each
//   unit's NW Q tiles into a double buffer, then its K_j / V_j 64-key tiles
//   into a ring of STAGES slots), one warp writes the key bias of each tile
//   beside it in the slot (the caller's bias below T, -1e30 below Tc, -inf
//   past it); setmaxnreg gives it 24 registers a thread;
// - a consumer warpgroup owns 64 query rows: S_j = Q K_j^T (mma_ss, both
//   K-major), the online softmax in registers, P rounded to bf16 A
//   fragments, O += P V_j (mma_rs, V read MN-major through the transpose
//   bit). Iteration j issues S_j and O += P_{j-1} V_{j-1} as two groups;
//   with dropout the Philox words of tile j are drawn while both are in
//   flight (integer work the products do not wait for; still ~46% of a
//   consumer warp's clocks at T 176, PERF.md section 6), then the
//   warpgroup waits for S_j alone (wg_wait<1>), so the exponentials of S_j
//   run (in S's f32 registers) while the tensor cores do P_{j-1} V_{j-1};
//   P_j * keep'_j is rounded into the A fragments once that product is
//   done. A warp whose 16 rows all lie past T draws no word (a branch
//   that also skipped a warpgroup's products there cost K8 9% and K3 3% at
//   T 512 / 176, PERF.md section 6);
// - the mask: S's accumulator layout (element 4 jj + e: row g + 8 (e >> 1)
//   of the warp's 16, key 8 jj + 2 t + (e & 1)) is mma.sync's, so the
//   words are attention_tc.cuh's keep_rowmajor's: with T and the offset
//   multiples of 4 a thread pair shares one Philox block a row and 4 keys
//   (one shuffle each way), otherwise one block a weight; keys past T draw
//   none. A thread keeps its 32 decisions of a tile as the 32 bits of one
//   register, a byte for each 32-key word of a row, and the quad ORs them
//   into attention_bwd.cuh's words (uint32 [B, H, T, ceil(T / 32)], keys
//   32 c .. 32 c + 31 in word c, zero past T), each lane storing one;
// - the exponentials: the row max is kept in natural units (an all-masked
//   row's max is -1e30 exactly, so its lse rounds to -1e30 as the plain
//   version's); the argument of ex2.approx is one FMA of the score, s L -
//   m L with L = log2(e), rounded once. For a row whose max is a masked
//   score (m < -1e20, every key masked so far) L is 2^-100 instead: s L and
//   m L are then exact, so s = m gives 2^0 = 1 at each masked key and -inf
//   gives 0, the reference's weights there (a fully masked K3 row averages
//   V over its T keys).
//
// Heads of 32 are [64][32] tiles in TMA's 64-byte swizzle, heads of 64
// [64][64] tiles in the 128-byte one (hopper.cuh), as in attention_bwd.cuh:
// S runs at m64n64k16 with K = Dh, O at m64n32k16 / m64n64k16.

#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_bwd.cuh"
#include "hopper.cuh"
#include "mma.cuh"
#include "philox.cuh"

namespace k8wg {

using namespace hopper;
using k3wg::k16;
using k3wg::mn16;
using k3wg::tile_desc;
typedef __nv_bfloat16 bf16;

constexpr int ROWS = 64;       // rows of a query or key tile
constexpr int NW = 4;          // K8's consumer warpgroups, 64 query rows each
constexpr int K3_NW = 3;       // K3's
constexpr int STAGES = 4;      // K_j / V_j ring slots
// registers a thread of a consumer and of the producer (setmaxnreg): at
// launch a block of (nw + 1) 128 threads holds 65536 / that each (96 at
// four consumers, 128 at three); an increase the block cannot cover would
// wait for ever
__host__ __device__ constexpr int consumer_regs(int nw) {
  return nw == 4 ? 112 : 160;
}
constexpr int PRODUCER_REGS = 24;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG = -1e30f;  // the padded keys' bias
constexpr size_t SMEM_LIMIT = 232448;
constexpr size_t EXTRA = 1024 + 8 * (4 + 2 * STAGES);  // alignment, barriers

// Shared memory of a block: the Q double buffer (nw tiles each), the ring
// (K, V and 64 bias floats a slot), the barriers. Independent of T.
__host__ __device__ constexpr size_t fwd_smem(int Dh, int nw) {
  return (size_t)2 * nw * ROWS * Dh * 2 +
         (size_t)STAGES * (2 * ROWS * Dh * 2 + ROWS * 4) + EXTRA;
}

struct Args {
  const float* bias;  // [B, T]
  bf16* o;            // [B, H, T, Dh] contiguous
  float* lse;         // [B, H, T]
  int H, T, Tc;       // Tc: the padded length (keys >= Tc weigh 0)
  int nq, nt, units;  // query groups a head, key tiles, B H nq
  float scale;
  // dropout (the DROP instances, K3)
  const int* seed;    // one int32 on the device
  uint32_t threshold;
  float keep_scale;
  uint64_t offset;    // added to every mask index
  int Hm;             // heads a batch row of the mask's tensor (0: H)
  uint32_t* bits;     // [B, H, T, ceil(T / 32)]: the keep decisions
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One key tile's softmax step on S (m64n64 accumulators: element 4 jj + e is
// query row g + 8 (e >> 1) of the warp's 16, key 8 jj + 2 t + (e & 1)), bt
// the tile's 64 bias floats. Updates the rows' max m and partial sums l
// (this thread's keys; summed over the quad at the end), overwrites S with
// the weights P (f32) and gives the rows' corrections c = exp(m_old -
// m_new).
__device__ __forceinline__ void softmax_tile(float (&s)[32], const float* bt,
                                             float scale, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& c0, float& c1) {
  const int t = threadIdx.x & 3;
  float a0[8], a1[8];  // the rows' maxima, then sums, as trees
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * jj + 2 * t);
    s[4 * jj] = fmaf(s[4 * jj], scale, bb.x);
    s[4 * jj + 1] = fmaf(s[4 * jj + 1], scale, bb.y);
    s[4 * jj + 2] = fmaf(s[4 * jj + 2], scale, bb.x);
    s[4 * jj + 3] = fmaf(s[4 * jj + 3], scale, bb.y);
    a0[jj] = fmaxf(s[4 * jj], s[4 * jj + 1]);
    a1[jj] = fmaxf(s[4 * jj + 2], s[4 * jj + 3]);
  }
#pragma unroll
  for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; ++i) {
      a0[i] = fmaxf(a0[i], a0[i + w]);
      a1[i] = fmaxf(a1[i], a1[i + w]);
    }
  const float x0 = fmaxf(m0, quad_max(a0[0]));
  const float x1 = fmaxf(m1, quad_max(a1[0]));
  c0 = ex2((m0 - x0) * LOG2E);
  c1 = ex2((m1 - x1) * LOG2E);
  m0 = x0;
  m1 = x1;
  const float k0 = x0 < -1e20f ? 0x1p-100f : LOG2E;
  const float k1 = x1 < -1e20f ? 0x1p-100f : LOG2E;
  const float n0 = -x0 * k0, n1 = -x1 * k1;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    s[4 * jj] = ex2(fmaf(s[4 * jj], k0, n0));
    s[4 * jj + 1] = ex2(fmaf(s[4 * jj + 1], k0, n0));
    s[4 * jj + 2] = ex2(fmaf(s[4 * jj + 2], k1, n1));
    s[4 * jj + 3] = ex2(fmaf(s[4 * jj + 3], k1, n1));
    a0[jj] = s[4 * jj] + s[4 * jj + 1];
    a1[jj] = s[4 * jj + 2] + s[4 * jj + 3];
  }
#pragma unroll
  for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; ++i) {
      a0[i] += a0[i + w];
      a1[i] += a1[i + w];
    }
  l0 = l0 * c0 + a0[0];
  l1 = l1 * c1 + a1[0];
}

// The bit of a thread's keep word kb that holds its element 4 jj + e (row
// g + 8 hh, hh = e >> 1; key 8 jj + 2 t + (e & 1)): byte 2 hh + (jj >> 2),
// pair jj & 3, so that a byte is the thread's share of one 32-key word of a
// row of the keep bits.
__host__ __device__ constexpr int kbit(int jj, int e) {
  return 16 * (e >> 1) + 8 * (jj >> 2) + 2 * (jj & 3) + (e & 1);
}

// P (f32, S's layout) times keep' (with dropout: bit kbit(jj, e) of kb
// keeps element 4 jj + e, scaled by ks; a dropped one is 0) rounded to the
// bf16 A fragments of the P.V product. Called with no product in flight: A
// registers written while one is make ptxas serialise the products (C7513).

template <bool DROP>
__device__ __forceinline__ void pack_p(const float (&s)[32], uint32_t kb,
                                       float ks, uint32_t (&p)[4][4]) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = DROP ? s[4 * jj + e] * ((kb >> kbit(jj, e)) & 1u ? ks : 0.f)
                  : s[4 * jj + e];
    p[jj >> 1][(jj & 1) * 2] = tc::pack_bf16(x[0], x[1]);
    p[jj >> 1][(jj & 1) * 2 + 1] = tc::pack_bf16(x[2], x[3]);
  }
}

// The keep decisions of a warp's 16 rows at one 64-key tile as a thread's
// keep word (bit kbit(jj, e): row r_g, whose flat mask index at key 0 is
// base0, or r_g + 8, base8's; key col0 + 8 jj + 2 t + (e & 1)); keys at or
// past `left` draw no word and stay 0. fast (T and the offset multiples of
// 4): a thread pair shares one Philox block a row and 4 keys, as
// keep_rowmajor of attention_tc.cuh; otherwise one block a weight. Keep:
// word >= thr.
__device__ __forceinline__ uint32_t keep_bits(uint32_t seed, uint64_t base0,
                                              uint64_t base8, int col0,
                                              int left, uint32_t thr,
                                              bool fast) {
  const int t = threadIdx.x & 3;
  uint32_t kb = 0u;
  if (fast) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if (8 * jj >= left) break;  // keys past T: no word drawn
      const uint64_t c = col0 + 8 * jj + 4 * (t >> 1);
      const uint4 w = philox::block(seed, ((t & 1) ? base8 + c : base0 + c)
                                              >> 2);
      const uint32_t s0 = (t & 1) ? w.x : w.z, s1 = (t & 1) ? w.y : w.w;
      const uint32_t r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      const uint32_t r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      // t odd: keys 4u + 2, 4u + 3 of row g from the partner, of g + 8 its
      // own; t even: keys 4u, 4u + 1 of row g its own, of g + 8 the
      // partner's
      const uint32_t e0 = (t & 1) ? r0 : w.x, e1 = (t & 1) ? r1 : w.y;
      const uint32_t e2 = (t & 1) ? w.z : r0, e3 = (t & 1) ? w.w : r1;
      kb |= (uint32_t)(e0 >= thr) << kbit(jj, 0) |
            (uint32_t)(e1 >= thr) << kbit(jj, 1) |
            (uint32_t)(e2 >= thr) << kbit(jj, 2) |
            (uint32_t)(e3 >= thr) << kbit(jj, 3);
    }
  } else {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if (8 * jj >= left) break;
      const uint64_t c = col0 + 8 * jj + 2 * t;
      kb |= (uint32_t)(philox::bits(seed, base0 + c) >= thr) << kbit(jj, 0) |
            (uint32_t)(philox::bits(seed, base0 + c + 1) >= thr)
                << kbit(jj, 1) |
            (uint32_t)(philox::bits(seed, base8 + c) >= thr) << kbit(jj, 2) |
            (uint32_t)(philox::bits(seed, base8 + c + 1) >= thr)
                << kbit(jj, 3);
    }
  }
  return kb;
}

// A warp's keep words kb of key tile j into the bits of rows row0 + g (+8)
// (head rows at rowbase): word 2 j + c of a row holds keys 64 j + 32 c ..
// + 31, key k at bit k % 32, keys >= T zero. A lane's keys of a word sit at
// bits 8 m + 2 t (+1) and come from byte 2 hh + c of its kb; the quad ORs
// its lanes' words and lane 2 hh + c stores word c of row g + 8 hh.
__device__ __forceinline__ void store_bits(uint32_t* rowbase, uint32_t kb,
                                           int row0, int j, int T, int W) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      // the byte of word c of row g + 8 hh: pair m to bits 8 m, 8 m + 1
      const uint32_t x = kb >> (16 * hh + 8 * c);
      uint32_t v = (x & 3u) | (x & 0xCu) << 6 | (x & 0x30u) << 12 |
                   (x & 0xC0u) << 18;
      v <<= 2 * t;
      v |= __shfl_xor_sync(0xffffffffu, v, 1);
      v |= __shfl_xor_sync(0xffffffffu, v, 2);
      const int row = row0 + g + 8 * hh, word = 2 * j + c;
      const int left = T - 32 * word;  // the word's keys below T
      if (left < 32) v &= left > 0 ? (1u << left) - 1u : 0u;
      if (t == 2 * hh + c && row < T && word < W)
        rowbase[(size_t)row * W + word] = v;
    }
}

// ---------------------------------------------------------------------------
// The kernel. Grid: min(units, SMs) blocks, each walking units u, u + grid,
// ...; NWG + 1 warpgroups. DROP: K3 with dropout (seed, threshold > 0, the
// keep bits written); otherwise no mask at all.
// ---------------------------------------------------------------------------

template <int DH, int NWG, bool DROP>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
    fwd_wg_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Args A) {
  constexpr int TILE = ROWS * DH * 2;
  constexpr int NA = DH / 2;  // accumulators of a [64][DH] product
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) &
                                    1023u);
  unsigned char* qbuf = base;                   // [2][NWG][TILE]
  unsigned char* ring = qbuf + 2 * NWG * TILE;  // [STAGES][K, V][TILE]
  float* bsh = reinterpret_cast<float*>(ring + STAGES * 2 * TILE);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(bsh + STAGES * ROWS);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + STAGES;
  const int nt = A.nt;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      bar_init(&q_full[i], 1);
      bar_init(&q_empty[i], NWG * 4);
    }
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1 + 32);  // the TMA thread and the bias warp
      bar_init(&empty[s], NWG * 4);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    regs_dec<PRODUCER_REGS>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0 && lane == 0) {
      int L = 0, n = 0;
      for (int u = blockIdx.x; u < A.units; u += gridDim.x, ++n) {
        const int qg = u % A.nq, bh = u / A.nq, h = bh % A.H, b = bh / A.H;
        const int qs = n & 1;
        bar_wait(&q_empty[qs], ((n >> 1) & 1) ^ 1);
        bar_expect(&q_full[qs], NWG * TILE);
        for (int w = 0; w < NWG; ++w)
          tma_load4(qbuf + (qs * NWG + w) * TILE, &tq, &q_full[qs], 0,
                    (qg * NWG + w) * ROWS, h, b);
        for (int j = 0; j < nt; ++j, ++L) {
          const int s = L % STAGES;
          bar_wait(&empty[s], ((L / STAGES) & 1) ^ 1);
          bar_expect(&full[s], 2 * TILE);
          tma_load4(ring + s * 2 * TILE, &tk, &full[s], 0, j * ROWS, h, b);
          tma_load4(ring + s * 2 * TILE + TILE, &tv, &full[s], 0, j * ROWS,
                    h, b);
        }
      }
    } else if (warp == 1) {
      int L = 0;
      for (int u = blockIdx.x; u < A.units; u += gridDim.x) {
        const int b = u / A.nq / A.H;
        const float* bg = A.bias + (size_t)b * A.T;
        for (int j = 0; j < nt; ++j, ++L) {
          // the tile's two keys a lane, read before the wait for the slot
          const int s = L % STAGES, k0 = j * ROWS + lane, k1 = k0 + 32;
          const float b0 = k0 < A.T ? bg[k0] : k0 < A.Tc ? NEG : -INFINITY;
          const float b1 = k1 < A.T ? bg[k1] : k1 < A.Tc ? NEG : -INFINITY;
          bar_wait(&empty[s], ((L / STAGES) & 1) ^ 1);
          bsh[s * ROWS + lane] = b0;
          bsh[s * ROWS + lane + 32] = b1;
          bar_arrive(&full[s]);
        }
      }
    }
    return;
  }
  regs_inc<consumer_regs(NWG)>();
  const int ct = threadIdx.x - 128, w = ct >> 7, tid = ct & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  uint32_t seed = 0u;
  bool fast = true;
  if constexpr (DROP) {
    seed = (uint32_t)A.seed[0];
    fast = (A.T & 3) == 0 && (A.offset & 3) == 0;
  }
  const int W = (A.T + 31) >> 5;  // keep-bit words a row

  int L = 0, n = 0;
  for (int u = blockIdx.x; u < A.units; u += gridDim.x, ++n) {
    const int qg = u % A.nq, bh = u / A.nq;
    const int qs = n & 1;
    const int roww = (qg * NWG + w) * ROWS + 16 * warp;  // the warp's row 0
    const uint64_t qd = tile_desc<DH>(qbuf + (qs * NWG + w) * TILE);
    float o[NA], s[32];
    uint32_t pa[4][4];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, c0, c1;
    // the mask: the flat indices of the warp's rows at key 0 (the mask head
    // of a tensor-parallel rank's local head, attention_tc.cuh's
    // mask_head), and whether the warp holds a row below T
    uint64_t base0 = 0, base8 = 0;
    uint32_t* rowbits = nullptr;
    const bool drawn = DROP && roww < A.T;
    if constexpr (DROP) {
      const uint64_t mh = (A.Hm == 0 || A.Hm == A.H)
                              ? (uint64_t)bh
                              : (uint64_t)(bh / A.H) * A.Hm + bh % A.H;
      base0 = A.offset + (mh * A.T + roww + g) * (uint64_t)A.T;
      base8 = base0 + 8ull * A.T;
      rowbits = A.bits + (size_t)bh * A.T * W;
    }
    uint32_t kb = 0u;
    bar_wait(&q_full[qs], (n >> 1) & 1);
    {  // key tile 0: S_0 (its mask drawn meanwhile) and its softmax
      const int sc = L % STAGES;
      const uint64_t kd = tile_desc<DH>(ring + sc * 2 * TILE);
      bar_wait(&full[sc], (L / STAGES) & 1);
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        mma_ss<0>(s, qd + k16(ks), kd + k16(ks), ks > 0);
      wg_commit();
      if (drawn) {
        kb = keep_bits(seed, base0, base8, 0, A.T, A.threshold, fast);
        store_bits(rowbits, kb, roww, 0, A.T, W);
      }
      wg_wait<0>();
      fence_regs(s);
      softmax_tile(s, bsh + sc * ROWS, A.scale, m0, m1, l0, l1, c0, c1);
      pack_p<DROP>(s, kb, A.keep_scale, pa);
    }
    for (int j = 1; j < nt; ++j) {
      // S_j and O += P_{j-1} V_{j-1} in two groups; the mask of tile j is
      // drawn while both are in flight, the softmax of S_j while the second
      // is
      const int sp = (L + j - 1) % STAGES, sc = (L + j) % STAGES;
      const uint64_t kd = tile_desc<DH>(ring + sc * 2 * TILE);
      const uint64_t vd = tile_desc<DH>(ring + sp * 2 * TILE + TILE);
      bar_wait(&full[sc], ((L + j) / STAGES) & 1);
      fence_regs(s);
      fence_regs(o);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) fence_regs(pa[ks]);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        mma_ss<0>(s, qd + k16(ks), kd + k16(ks), ks > 0);
      wg_commit();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        mma_rs<1>(o, pa[ks], vd + ks * mn16<DH>(), j > 1 || ks > 0);
      wg_commit();
      if (drawn) {
        kb = keep_bits(seed, base0, base8, j * ROWS, A.T - j * ROWS,
                       A.threshold, fast);
        store_bits(rowbits, kb, roww, j, A.T, W);
      }
      wg_wait<1>();
      fence_regs(s);
      softmax_tile(s, bsh + sc * ROWS, A.scale, m0, m1, l0, l1, c0, c1);
      wg_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) fence_regs(pa[ks]);
      fence_regs(s);
      if (lane == 0) bar_arrive(&empty[sp]);
#pragma unroll
      for (int jj = 0; jj < DH / 8; ++jj) {
        o[4 * jj] *= c0;
        o[4 * jj + 1] *= c0;
        o[4 * jj + 2] *= c1;
        o[4 * jj + 3] *= c1;
      }
      pack_p<DROP>(s, kb, A.keep_scale, pa);
    }
    if (lane == 0) bar_arrive(&q_empty[qs]);  // every S product is done
    {  // O += P_{nt-1} V_{nt-1}
      const int sp = (L + nt - 1) % STAGES;
      const uint64_t vd = tile_desc<DH>(ring + sp * 2 * TILE + TILE);
      fence_regs(o);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) fence_regs(pa[ks]);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        mma_rs<1>(o, pa[ks], vd + ks * mn16<DH>(), nt > 1 || ks > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(o);
      if (lane == 0) bar_arrive(&empty[sp]);
    }
    L += nt;

    // o = O / l (rounded once) and lse = m + log l, rows row, row + 8
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float r0 = 1.f / l0, r1 = 1.f / l1;
    const int row = roww + g;
    bf16* og = A.o + (size_t)bh * A.T * DH;
#pragma unroll
    for (int jj = 0; jj < DH / 8; ++jj) {
      const int col = 8 * jj + 2 * t;
      if (row < A.T)
        *reinterpret_cast<uint32_t*>(og + (size_t)row * DH + col) =
            tc::pack_bf16(o[4 * jj] * r0, o[4 * jj + 1] * r0);
      if (row + 8 < A.T)
        *reinterpret_cast<uint32_t*>(og + (size_t)(row + 8) * DH + col) =
            tc::pack_bf16(o[4 * jj + 2] * r1, o[4 * jj + 3] * r1);
    }
    if (t == 0) {
      if (row < A.T) A.lse[(size_t)bh * A.T + row] = m0 + logf(l0);
      if (row + 8 < A.T) A.lse[(size_t)bh * A.T + row + 8] = m1 + logf(l1);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: K8's plan for both directions, and the launch of either unit
// ---------------------------------------------------------------------------

enum { GENERAL = 0, WGMMA = 1 };

// K8's designs for (dtype, T, Dh, aligned), a rule on these alone (mirrored
// by blocked_plan in ops/attention_blocked.py; a launch the chosen design
// refuses fails, nothing falls back). dtype 1 = bf16; aligned: q, k, v
// start on 16 bytes with strides over b, h, t of 8-element multiples.
// - forward: wgmma at bf16, heads of 32 and 64, aligned, any T;
// - backward: attention_bwd.cuh's one pass, with null keep bits, at the same
//   shapes where its layout fits a block's shared memory (heads of 32 up to
//   T 640, of 64 up to T 384); the two passes of attention_tc.cuh beyond.
struct Plan {
  int fwd;             // design of the forward
  size_t fwd_smem;     // WGMMA: shared memory of a block, bytes
  k3wg::Plan bwd;      // the backward's plan (its design and layout)
};

inline Plan plan(int dtype, int T, int Dh, int aligned) {
  Plan p{};
  const bool shape = dtype == 1 && (Dh == 32 || Dh == 64) && T >= 1 &&
                     aligned;
  p.fwd = shape ? WGMMA : GENERAL;
  p.fwd_smem = shape ? fwd_smem(Dh, NW) : 0;
  p.bwd.design = k3wg::GENERAL;
  if (shape) {
    const k3wg::Layout l = k3wg::layout_of(T, Dh);
    if (l.bytes <= SMEM_LIMIT) {
      p.bwd.design = k3wg::WGMMA;
      p.bwd.consumers = k3wg::consumers_of(Dh);
      p.bwd.groups = l.groups;
      p.bwd.stages = k3wg::STAGES;
      p.bwd.ds_bufs = k3wg::DS_BUFS;
      p.bwd.smem = l.bytes;
      p.bwd.reg_limit = k3wg::consumer_regs(p.bwd.consumers);
    }
  }
  return p;
}

// Launches fwd_wg_kernel<DH, NWG, DROP> on a's units (a.nq groups of NWG
// query tiles a head); DROP needs a.seed, a.threshold > 0 and a.bits.
template <int DH, int NWG, bool DROP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const long long* qs, const long long* ks,
                       const long long* vs, const Args& a, int B,
                       cudaStream_t s) {
  constexpr size_t smem = fwd_smem(DH, NWG);
  static_assert(smem <= SMEM_LIMIT, "shared memory");
  static_assert(128 * (NWG * consumer_regs(NWG) + PRODUCER_REGS) <= 65536,
                "registers");
  if (DROP && (a.seed == nullptr || a.threshold == 0u || a.bits == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t e = k3wg::head_map(&tq, q, qs, B, a.H, a.T, DH);
  if (e == cudaSuccess) e = k3wg::head_map(&tk, k, ks, B, a.H, a.T, DH);
  if (e == cudaSuccess) e = k3wg::head_map(&tv, v, vs, B, a.H, a.T, DH);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fwd_wg_kernel<DH, NWG, DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return e;
  const int grid = a.units < sms ? a.units : sms;
  fwd_wg_kernel<DH, NWG, DROP><<<grid, (NWG + 1) * 128, smem, s>>>(tq, tk,
                                                                  tv, a);
  return cudaGetLastError();
}

}  // namespace k8wg
