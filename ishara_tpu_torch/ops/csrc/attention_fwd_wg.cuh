// K8's forward on Hopper (sm_90a), bf16 heads of 32 and 64: warpgroup
// products on a TMA key / value ring, and K8's plan, which also sends its
// backward to the one-pass wgmma kernel of attention_bwd.cuh. Included by
// attention_blocked.cu.
//
// Replaces the Pallas kernel _fwd_kernel of ishara_tpu/ops/attention_blocked.py
// (:46, its pallas_call :145, behind flash_mhsa_blocked :159) where plan()
// below takes the call: bf16, a head dimension of 32 or 64, q, k, v rows that
// TMA can read (16-byte strides and bases), any T. Every other call keeps
// the forward of attention_tc.cuh (mma.sync, cp.async).
//
// It computes what blocked_attention_forward_plain in
// ops/attention_blocked.py writes: s = q.k * scale + bias, the online
// softmax over 64-key tiles, o = (sum p v) / l rounded once, lse = m + log l
// in natural-log units. Keys in [T, Tc) arrive as zeros (TMA reads past the
// tensor) with the bias -1e30 and count; keys at or past Tc weigh exactly 0
// (the 64-key tile need not divide Tc, the padded length).
//
// Bound at the long step's shape (q, k, v [256, 8, 512, 32]): bytes on the
// table, 272 MB, 0.0815 ms at 3.35 TB/s, against 2 [T, T] products, 68.7
// GFLOP, 0.0695 ms at 989 TFLOP/s. Below both lies the floor this design is
// built around: B H T Tc = 537 M exponentials, at 16 a clock an SM (the
// multi-function unit) on 132 SMs at 1.98 GHz 0.128 ms.
//
// What bounded the old forward (PERF.md, section 6: a clock64 timeline of a
// debug copy of tc::fwd_kernel): a block of 64 queries, four warps of
// mma.sync, two __syncthreads and a cp.async double buffer a key tile; each
// head's K and V read 8 times.
//
// The design:
// - a persistent grid, one block an SM; a unit of work is (b, h, a group of
//   256 queries), units in head order so that the blocks running at once
//   share a head's K and V in L2;
// - warpgroup 0 is the producer: one thread issues every TMA copy (each
//   unit's four Q tiles into a double buffer, then its K_j / V_j 64-key tiles
//   into a ring of STAGES slots), one warp writes the key bias of each tile
//   beside it in the slot (the caller's bias below T, -1e30 below Tc, -inf
//   past it); setmaxnreg gives it 24 registers a thread and each of the
//   four consumer warpgroups 112 (16 consumer warps an SM: fewer, with
//   more registers, left the exponential unit idler);
// - a consumer warpgroup owns 64 query rows: S_j = Q K_j^T (mma_ss, both
//   K-major), the online softmax in registers, P rounded to bf16 A
//   fragments, O += P V_j (mma_rs, V read MN-major through the transpose
//   bit). Iteration j issues S_j and O += P_{j-1} V_{j-1} as two groups
//   and waits for S_j alone (wg_wait<1>), so the exponentials of S_j run
//   (in S's f32 registers) while the tensor cores do P_{j-1} V_{j-1}; P_j
//   is rounded into the A fragments once that product is done;
// - the exponentials: the row max is kept in natural units (an all-masked
//   row's max is -1e30 exactly, so its lse rounds to -1e30 as the plain
//   version's); the argument of ex2.approx is one FMA of the score, s L -
//   m L with L = log2(e), rounded once. For a row whose max is a masked
//   score (m < -1e20, every key masked so far) L is 2^-100 instead: s L and
//   m L are then exact, so s = m gives 2^0 = 1 at each masked key and -inf
//   gives 0, the reference's weights there.
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

namespace k8wg {

using namespace hopper;
using k3wg::k16;
using k3wg::mn16;
using k3wg::tile_desc;
typedef __nv_bfloat16 bf16;

constexpr int ROWS = 64;       // rows of a query or key tile
constexpr int NW = 4;          // consumer warpgroups, 64 query rows each
constexpr int STAGES = 4;      // K_j / V_j ring slots
// registers a thread of a consumer and of the producer (setmaxnreg): at
// launch a block of 640 threads holds 96 each (61440); an increase the
// block cannot cover would wait for ever
constexpr int CONSUMER_REGS = 112, PRODUCER_REGS = 24;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG = -1e30f;  // the padded keys' bias
constexpr size_t SMEM_LIMIT = 232448;
constexpr size_t EXTRA = 1024 + 8 * (4 + 2 * STAGES);  // alignment, barriers

// Shared memory of a block: the Q double buffer (NW tiles each), the ring
// (K, V and 64 bias floats a slot), the barriers. Independent of T.
__host__ __device__ constexpr size_t fwd_smem(int Dh) {
  return (size_t)2 * NW * ROWS * Dh * 2 +
         (size_t)STAGES * (2 * ROWS * Dh * 2 + ROWS * 4) + EXTRA;
}

struct Args {
  const float* bias;  // [B, T]
  bf16* o;            // [B, H, T, Dh] contiguous
  float* lse;         // [B, H, T]
  int H, T, Tc;       // Tc: the padded length (keys >= Tc weigh 0)
  int nq, nt, units;  // query groups a head, key tiles, B H nq
  float scale;
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

// P (f32, S's layout) rounded to the bf16 A fragments of the P.V product.
// Called with no product in flight: A registers written while one is make
// ptxas serialise the products (C7513).
__device__ __forceinline__ void pack_p(const float (&s)[32],
                                       uint32_t (&p)[4][4]) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    p[jj >> 1][(jj & 1) * 2] = tc::pack_bf16(s[4 * jj], s[4 * jj + 1]);
    p[jj >> 1][(jj & 1) * 2 + 1] = tc::pack_bf16(s[4 * jj + 2],
                                                 s[4 * jj + 3]);
  }
}

// ---------------------------------------------------------------------------
// The kernel. Grid: min(units, SMs) blocks, each walking units u, u + grid,
// ...; NW + 1 warpgroups.
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__((NW + 1) * 128, 1)
    fwd_wg_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Args A) {
  constexpr int TILE = ROWS * DH * 2;
  constexpr int NA = DH / 2;  // accumulators of a [64][DH] product
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) &
                                    1023u);
  unsigned char* qbuf = base;                   // [2][NW][TILE]
  unsigned char* ring = qbuf + 2 * NW * TILE;   // [STAGES][K, V][TILE]
  float* bsh = reinterpret_cast<float*>(ring + STAGES * 2 * TILE);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(bsh + STAGES * ROWS);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + STAGES;
  const int nt = A.nt;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      bar_init(&q_full[i], 1);
      bar_init(&q_empty[i], NW * 4);
    }
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1 + 32);  // the TMA thread and the bias warp
      bar_init(&empty[s], NW * 4);
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
        bar_expect(&q_full[qs], NW * TILE);
        for (int w = 0; w < NW; ++w)
          tma_load4(qbuf + (qs * NW + w) * TILE, &tq, &q_full[qs], 0,
                    (qg * NW + w) * ROWS, h, b);
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
  regs_inc<CONSUMER_REGS>();
  const int ct = threadIdx.x - 128, w = ct >> 7, tid = ct & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  int L = 0, n = 0;
  for (int u = blockIdx.x; u < A.units; u += gridDim.x, ++n) {
    const int qg = u % A.nq, bh = u / A.nq;
    const int qs = n & 1;
    const uint64_t qd = tile_desc<DH>(qbuf + (qs * NW + w) * TILE);
    float o[NA], s[32];
    uint32_t pa[4][4];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, c0, c1;
    bar_wait(&q_full[qs], (n >> 1) & 1);
    {  // key tile 0: S_0 and its softmax
      const int sc = L % STAGES;
      const uint64_t kd = tile_desc<DH>(ring + sc * 2 * TILE);
      bar_wait(&full[sc], (L / STAGES) & 1);
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        mma_ss<0>(s, qd + k16(ks), kd + k16(ks), ks > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      softmax_tile(s, bsh + sc * ROWS, A.scale, m0, m1, l0, l1, c0, c1);
      pack_p(s, pa);
    }
    for (int j = 1; j < nt; ++j) {
      // S_j and O += P_{j-1} V_{j-1} in two groups; the softmax of S_j
      // runs while the second is in flight
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
      pack_p(s, pa);
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
    const int row = (qg * NW + w) * ROWS + 16 * warp + g;
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
// Host side: K8's plan for both directions
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
  p.fwd_smem = shape ? fwd_smem(Dh) : 0;
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

template <int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const long long* qs, const long long* ks,
                       const long long* vs, const Args& a, int B,
                       cudaStream_t s) {
  constexpr size_t smem = fwd_smem(DH);
  static_assert(smem <= SMEM_LIMIT, "shared memory");
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
    e = cudaFuncSetAttribute(fwd_wg_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return e;
  const int grid = a.units < sms ? a.units : sms;
  fwd_wg_kernel<DH><<<grid, (NW + 1) * 128, smem, s>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace k8wg
