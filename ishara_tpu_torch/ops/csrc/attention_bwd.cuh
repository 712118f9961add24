// The attention backward on Hopper (sm_90a), bf16 heads of 32 and 64: one
// launch, one block a (batch, head), five wgmma products a pair of 64-row
// tiles; for K3 on the keep bits its forward saved, for K8 with no dropout
// (no bits). Included by attention.cu and attention_blocked.cu.
//
// Replaces the Pallas kernel _bwd_kernel of ishara_tpu/ops/attention.py
// (:84, its pallas_call :168, behind flash_mhsa) where plan() below takes
// the call: bf16, a head dimension of 32 or 64, T <= 384, q, k, v rows that
// TMA can read (16-byte strides and bases); and, where k8wg::plan
// (attention_fwd_wg.cuh) takes it, _dq_kernel and _dkv_kernel of
// ishara_tpu/ops/attention_blocked.py (:73, :96; pallas_call :208, :223,
// behind flash_mhsa_blocked): the same shapes at any T whose layout fits a
// block's shared memory (heads of 32 up to T 640, of 64 up to T 384).
// Every other call keeps the two passes of attention_tc.cuh (dq_kernel,
// dkv_kernel and the wide kernels).
//
// It computes what _bwd_kernel computes, as mhsa_backward_plain in
// ops/attention.py writes it: P = exp(S - lse) with S = q.k * scale + bias,
// dV = (P * keep')^T dO, delta = rowsum(dO * O), dS = P * (keep' * dP -
// delta), dQ = dS.K * scale, dK = dS^T.Q * scale; P * keep' and dS rounded
// to bf16 for their products, every sum f32, each output rounded once.
//
// Bound at the flagship shape (q, k, v [256, 8, 176, 32], rate 0.4): bytes.
// It reads q, k, v, o, dO (5 x 23.1 MB), lse and the key bias (1.6 MB) and
// writes dq, dk, dv (3 x 23.1 MB): 186 MB, 0.0556 ms at 3.35 TB/s, against
// 5 [T, T] products of 2 T^2 Dh each, 20.3 GFLOP, 0.0205 ms at 989 TFLOP/s.
// The keep bits it also reads (8.65 MB, 0.0026 ms) are this design's choice
// (the mask can be drawn again from the seed), so the bound leaves them out.
// K8 at the long step's shape ([256, 8, 512, 32], no dropout): 5 products of
// 171.8 GFLOP bind it (0.1737 ms); its B H T T = 537 M exponentials take
// 0.128 ms at 16 a clock an SM.
//
// What bounded the old design (PERF.md, section 6: a clock64 timeline of
// dq_kernel and dkv_kernel at that shape, taken in a debug copy): drawing the
// [B, H, T, T] Philox mask twice. At rate 0.4 the Philox words took 37% of
// the dQ pass's warp clocks and 61% of the dK / dV pass's (its words
// exchanged by shuffles), the waits for loads 11-16%, the four mma.sync
// products 12-14%; the two passes took 0.77 ms at rate 0.4 and 0.35 ms at
// rate 0. Besides: each pass read q, k, v and dO again and recomputed the
// exponentials (seven [T, T] products where five suffice).
//
// The design:
// - the forward writes one bit a weight, the keep decisions it draws anyway
//   (attention_tc.cuh, store_keep_bits): uint32 [B, H, T, ceil(T / 32)],
//   word c of query row r holding keys 32 c .. 32 c + 31, key k at bit
//   k % 32, keys >= T zero. This kernel reads them and draws no Philox
//   word, so the offsets and head runs of a data- or tensor-parallel rank
//   need nothing here: the forward honoured them;
// - one block owns a (b, h) head and sums dQ over all its keys itself: no
//   atomics, no partial-dQ traffic, the same bits on every run. Warpgroup 0
//   is the producer (one thread issues every TMA copy), warpgroups 1 .. NW
//   the consumers, each owning a 64-key tile j. Per 64-query tile i the
//   producer brings Q_i and dO_i through a ring of STAGES slots; K_j and V_j
//   stay for the consumers' whole pass. A consumer computes S^T_ji = K_j
//   Q_i^T and dP^T_ji = V_j dO_i^T (A and B from shared memory), then
//   P' = P * keep' and dS^T in registers, rounded to bf16 A fragments, and
//   dV_j += P'^T_ji dO_i, dK_j += dS^T_ji Q_i (A from registers, dO_i and
//   Q_i read MN-major by the transpose bit);
// - dS^T_ji also goes to shared memory (a double-buffered [64][64] tile a
//   consumer, released by mbarriers); consumer i % NW then forms dQ_i =
//   sum_j dS_ij K_j in one group of products (A = the dS^T tiles read
//   MN-major, B = the K tiles MN-major) in key-tile order, and writes it
//   once;
// - delta and lse for the whole head are staged in shared memory by the
//   consumers before the loop (delta from o and dO, f32), with the keep
//   bits (none without dropout, null bits: keep' = 1, and their room in
//   the layout stays unused): no second kernel, no scratch tensor;
// - above NW key tiles (T > 192 at heads of 32, > 128 at 64) the block
//   walks key-tile groups in turn: dK and dV of a group are final after its
//   pass, dQ_i's partial sum waits in an f32 shared tile and the next group
//   adds to it, again in a fixed order. These partial sums, T Dh 4 bytes,
//   and the keep bits' room, T^2 / 8 bytes, bound T by shared memory: at
//   heads of 32 and T 512 a block holds 189 KB (dQ sums 64, K / V tiles 24,
//   the ring 16, dS^T tiles 48, lse and delta 4, the bits 32, which K8
//   leaves unused), at T 640 224 KB; heads of 64 past T 384 would take
//   more than 227 KB;
// - rows past T arrive as zeros (TMA); keys >= T weigh exactly 0 (bias
//   -inf) and queries >= T have lse +inf, so P is 0 there; a row whose keys
//   are all masked (bias -1e30) computes P as the forward's arithmetic
//   gives it, as in the other kernels.
//
// Heads of 32 are [64][32] tiles in TMA's 64-byte swizzle, heads of 64
// [64][64] tiles in the 128-byte one (hopper.cuh): the products run at
// N = Dh (m64n32k16 / m64n64k16) and K = Dh, no padded columns. The dS^T
// tiles are [64 keys][64 queries] in the 128-byte swizzle, written by the
// consumers as TMA would.
//
// Registers: a consumer holds dK and dV (Dh / 2 each), S^T and dP^T (32
// each), the bf16 fragments of P' and dS^T (16 each) and, on its dQ tiles,
// dQ (Dh / 2). Heads of 32 take three consumer warpgroups (setmaxnreg
// 160, the producer 32: 65536 registers an SM), heads of 64 two (240 and
// 24). One block an SM.

#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace k3wg {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int ROWS = 64;        // rows of a query or key tile
constexpr int K3_T_MAX = 384;   // K3's longest T (the caller's range)
constexpr int STAGES = 2;       // Q_i / dO_i ring slots
constexpr int DS_BUFS = 2;      // dS^T tiles a consumer, in turns
constexpr int DS_TILE = ROWS * ROWS * 2;
constexpr size_t SMEM_LIMIT = 232448;
constexpr size_t EXTRA = 1024 + 16 * 8;  // alignment and the barriers

// Consumer warpgroups a block and their registers (setmaxnreg): heads of
// 32 take three, heads of 64 two (their accumulators are twice as wide).
__host__ __device__ constexpr int consumers_of(int Dh) {
  return Dh == 32 ? 3 : 2;
}
__host__ __device__ constexpr int consumer_regs(int nw) {
  return nw == 3 ? 160 : 240;
}
__host__ __device__ constexpr int producer_regs(int nw) {
  return nw == 3 ? 32 : 24;
}

struct Args {
  const bf16* o;          // [B, H, T, Dh] contiguous
  const bf16* d_o;        // strided over b, h, t (dos), 16-byte rows
  long long dos[3];
  const float* bias;      // [B, T]
  const float* lse;       // [B, H, T]
  const uint32_t* bits;   // [B, H, T, ceil(T / 32)]; null: no dropout
  bf16 *dq, *dk, *dv;     // [B, H, T, Dh] contiguous
  int H, T;
  float scale, keep_scale;
};

struct Layout {
  int nk, groups, words;  // 64-row tiles, key-tile groups, bit words a row
  size_t kv, ring, ds, acc, ld, kb, bars, bytes;  // offsets from the base
};

// Shared memory of a block for (T, Dh): the consumers' K, V tiles, the
// ring, the dS^T tiles, the dQ partial sums (groups > 1), (lse, delta) a
// row, the keep bits (2 words a key tile, zero-padded), the barriers.
__host__ __device__ inline Layout layout_of(int T, int Dh) {
  Layout l;
  const int nw = consumers_of(Dh);
  const size_t tile = (size_t)ROWS * Dh * 2;
  l.nk = (T + ROWS - 1) / ROWS;
  l.groups = (l.nk + nw - 1) / nw;
  l.words = 2 * l.nk;
  const size_t rows = (size_t)l.nk * ROWS;
  l.kv = 0;
  l.ring = l.kv + (size_t)nw * 2 * tile;
  l.ds = l.ring + (size_t)STAGES * 2 * tile;
  l.acc = l.ds + (size_t)DS_BUFS * nw * DS_TILE;
  l.ld = l.acc + (l.groups > 1 ? rows * Dh * 4 : 0);
  l.kb = l.ld + rows * 8;
  l.bars = l.kb + rows * l.words * 4;
  l.bytes = l.bars + EXTRA;
  return l;
}

// ---------------------------------------------------------------------------
// Operand descriptors and k16 steps by head width
// ---------------------------------------------------------------------------

template <int DH>
__device__ __forceinline__ uint64_t tile_desc(const void* p) {
  return DH == 64 ? desc(p) : desc64(p);
}
// 16 rows further down a [64][DH] tile (an MN-major k16 step), 16-byte units
template <int DH>
__device__ __forceinline__ uint64_t mn16() {
  return (uint64_t)((16 * DH * 2) >> 4);
}
// 16 columns along a row (a K-major k16 step): 32 bytes in either swizzle
__device__ __forceinline__ uint64_t k16(int ks) { return (uint64_t)(2 * ks); }

// ---------------------------------------------------------------------------
// The kernel. Grid: one block a (b, h); (NW + 1) warpgroups. Null bits: no
// dropout, no keep bits staged or read (K3 at rate 0, and K8: an instance
// compiled for no bits at all, its bits' room gone, had ptxas serialise its
// products, C7520).
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__((consumers_of(DH) + 1) * 128, 1)
    bwd_wg_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo, const Args A) {
  constexpr int NW = consumers_of(DH);
  constexpr int TILE = ROWS * DH * 2;
  constexpr int NA = DH / 2;  // accumulators of a [64][DH] product
  extern __shared__ unsigned char smem_raw[];
  const Layout lay = layout_of(A.T, DH);
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) &
                                    1023u);
  unsigned char* kv = base + lay.kv;      // [NW][K, V][TILE]
  unsigned char* ring = base + lay.ring;  // [STAGES][Q, dO][TILE]
  unsigned char* dst = base + lay.ds;     // [DS_BUFS][NW][DS_TILE]
  float* acc = reinterpret_cast<float*>(base + lay.acc);    // [rows][DH]
  float2* ld = reinterpret_cast<float2*>(base + lay.ld);    // [rows]
  uint32_t* kb = reinterpret_cast<uint32_t*>(base + lay.kb);  // [rows][words]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.bars);
  uint64_t* empty = full + STAGES;
  uint64_t* ds_full = empty + STAGES;
  uint64_t* ds_empty = ds_full + DS_BUFS;
  uint64_t* kv_full = ds_empty + DS_BUFS;
  uint64_t* kv_empty = kv_full + 1;
  const int T = A.T, nk = lay.nk, groups = lay.groups, words = lay.words;
  const int bh = blockIdx.x, b = bh / A.H, h = bh - b * A.H;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], NW * 4);
    }
    for (int s = 0; s < DS_BUFS; ++s) {
      bar_init(&ds_full[s], NW * 128);
      bar_init(&ds_empty[s], 4);
    }
    bar_init(kv_full, 1);
    bar_init(kv_empty, NW * 4);
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    regs_dec<producer_regs(NW)>();
    if (threadIdx.x == 0) {
      // per group its K, V tiles, then Q_i, dO_i for every query tile i
      int L = 0;
      for (int grp = 0; grp < groups; ++grp) {
        const int nact = min(NW, nk - grp * NW);
        if (grp > 0) bar_wait(kv_empty, (grp - 1) & 1);
        bar_expect(kv_full, nact * 2 * TILE);
        for (int u = 0; u < nact; ++u) {
          const int r0 = (grp * NW + u) * ROWS;
          tma_load4(kv + u * 2 * TILE, &tk, kv_full, 0, r0, h, b);
          tma_load4(kv + u * 2 * TILE + TILE, &tv, kv_full, 0, r0, h, b);
        }
        for (int i = 0; i < nk; ++i, ++L) {
          const int s = L % STAGES;
          bar_wait(&empty[s], ((L / STAGES) & 1) ^ 1);
          bar_expect(&full[s], 2 * TILE);
          tma_load4(ring + s * 2 * TILE, &tq, &full[s], 0, i * ROWS, h, b);
          tma_load4(ring + s * 2 * TILE + TILE, &tdo, &full[s], 0, i * ROWS,
                    h, b);
        }
      }
    }
    return;
  }
  regs_inc<consumer_regs(NW)>();
  const int ct = threadIdx.x - 128, w = ct >> 7, tid = ct & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool drop = A.bits != nullptr;

  // (lse, delta) a query row, a thread a row (rows past T: +inf, 0), and
  // the keep bits, zero past T and past each row's words
  {
    const bf16* og = A.o + (size_t)bh * T * DH;
    const bf16* dog = A.d_o + b * A.dos[0] + h * A.dos[1];
    for (int r = ct; r < nk * ROWS; r += NW * 128) {
      float l = INFINITY, d = 0.f;
      if (r < T) {
        l = A.lse[(size_t)bh * T + r];
        const uint4* orow = reinterpret_cast<const uint4*>(og + (size_t)r *
                                                           DH);
        const uint4* drow = reinterpret_cast<const uint4*>(dog + r *
                                                           A.dos[2]);
#pragma unroll
        for (int c = 0; c < DH / 8; ++c) {
          const uint4 ov = orow[c], dv = drow[c];
          const bf16* o8 = reinterpret_cast<const bf16*>(&ov);
          const bf16* d8 = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            d += __bfloat162float(d8[e]) * __bfloat162float(o8[e]);
        }
      }
      ld[r] = make_float2(l, d);
    }
    if (drop) {
      const int W = (T + 31) >> 5;
      const uint32_t* bg = A.bits + (size_t)bh * T * W;
      for (int e = ct; e < nk * ROWS * words; e += NW * 128) {
        const int r = e / words, c = e - r * words;
        kb[e] = r < T && c < W ? bg[(size_t)r * W + c] : 0u;
      }
    }
    named_sync(1, NW * 128);
  }

  float dk[NA], dv[NA];
  int n = 0;  // query tiles walked, over the groups: ring and dS^T turns
  for (int grp = 0; grp < groups; ++grp) {
    const int j = grp * NW + w, nact = min(NW, nk - grp * NW);
    const bool active = j < nk;
    const int key0 = j * ROWS + 16 * warp + g;  // keys key0, key0 + 8
    const float bias0 = active && key0 < T
                            ? A.bias[(size_t)b * T + key0] : -INFINITY;
    const float bias8 = active && key0 + 8 < T
                            ? A.bias[(size_t)b * T + key0 + 8] : -INFINITY;
    // the word and bit of keys key0, key0 + 8 in a query row's bits
    const int kword = 2 * j + (warp >> 1), kbit = 16 * (warp & 1) + g;
    const uint64_t kd = tile_desc<DH>(kv + w * 2 * TILE);
    const uint64_t vd = tile_desc<DH>(kv + w * 2 * TILE + TILE);
    bar_wait(kv_full, grp & 1);

    for (int i = 0; i < nk; ++i, ++n) {
      const int s = n % STAGES, d2 = n % DS_BUFS;
      unsigned char* qt = ring + s * 2 * TILE;
      const uint64_t qd = tile_desc<DH>(qt), dod = tile_desc<DH>(qt + TILE);
      bar_wait(&full[s], (n / STAGES) & 1);
      uint32_t pa[4][4], da[4][4];  // P'^T and dS^T, bf16 A fragments
      if (active) {
        // S^T = K_j . Q_i^T and dP^T = V_j . dO_i^T, one group; the
        // accumulators start at the first product (scale_d 0)
        float sa[32], pd[32];
        fence_regs(sa);
        fence_regs(pd);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks) {
          mma_ss<0>(sa, kd + k16(ks), qd + k16(ks), ks > 0);
          mma_ss<0>(pd, vd + k16(ks), dod + k16(ks), ks > 0);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(sa);
        fence_regs(pd);
        // element 4 jj + e: key key0 + 8 (e >> 1), query 64 i + 8 jj + 2 t +
        // (e & 1)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          float p[4], ds[4];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int q = i * ROWS + 8 * jj + 2 * t + c;
            const float2 lq = ld[q];
            const uint32_t word = drop ? kb[q * words + kword] : 0u;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int e = 2 * hh + c;
              const float pe = __expf(
                  fmaf(sa[4 * jj + e], A.scale, hh ? bias8 : bias0) - lq.x);
              const float kp = !drop ? 1.f
                               : (word >> (kbit + 8 * hh)) & 1u ? A.keep_scale
                                                                : 0.f;
              p[e] = pe * kp;
              ds[e] = pe * (pd[4 * jj + e] * kp - lq.y);
            }
          }
          pa[jj >> 1][(jj & 1) * 2] = tc::pack_bf16(p[0], p[1]);
          pa[jj >> 1][(jj & 1) * 2 + 1] = tc::pack_bf16(p[2], p[3]);
          da[jj >> 1][(jj & 1) * 2] = tc::pack_bf16(ds[0], ds[1]);
          da[jj >> 1][(jj & 1) * 2 + 1] = tc::pack_bf16(ds[2], ds[3]);
        }
      }
      // dS^T_ji to this consumer's tile of turn d2, as the 128-byte
      // swizzle places it: row 16 warp + g (+8), 16-byte chunk 2 ks (+1) ^
      // row % 8, 4 bytes a lane
      bar_wait(&ds_empty[d2], ((n / DS_BUFS) & 1) ^ 1);
      if (active) {
        unsigned char* tile = dst + (d2 * NW + w) * DS_TILE;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int row = 16 * warp + g + 8 * (f & 1);
            const int chunk = 2 * ks + (f >> 1);
            *reinterpret_cast<uint32_t*>(tile + row * 128 +
                                         ((chunk ^ g) << 4) + 4 * t) =
                da[ks][f];
          }
        fence_async_smem();
      }
      bar_arrive(&ds_full[d2]);
      if (active) {
        // dV_j += P'^T_ji . dO_i and dK_j += dS^T_ji . Q_i (dO_i and Q_i
        // MN-major), one group
        fence_regs(dk);
        fence_regs(dv);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          fence_regs(pa[ks]);
          fence_regs(da[ks]);
        }
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          mma_rs<1>(dv, pa[ks], dod + ks * mn16<DH>(), i > 0 || ks > 0);
          mma_rs<1>(dk, da[ks], qd + ks * mn16<DH>(), i > 0 || ks > 0);
        }
        wg_commit();
      }
      // dQ_i = sum over the group's key tiles u of dS_iu . K_u, in order
      // (A: the dS^T tiles MN-major; B: the K tiles MN-major), then added
      // to the earlier groups' sum (in registers that only products write:
      // a value loaded into an accumulator while other products are in
      // flight makes ptxas serialise them, C7515)
      const bool owner = i % NW == w;
      float dq[NA];
      const int qrow = i * ROWS + 16 * warp + g;  // rows qrow, qrow + 8
      if (owner) {
        bar_wait(&ds_full[d2], (n / DS_BUFS) & 1);
        fence_regs(dq);
        wg_fence();
        for (int u = 0; u < nact; ++u) {
          const uint64_t ad = desc(dst + (d2 * NW + u) * DS_TILE);
          const uint64_t bd = tile_desc<DH>(kv + u * 2 * TILE);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            mma_ss<1, 1>(dq, ad + ks * (uint64_t)((16 * 128) >> 4),
                         bd + ks * mn16<DH>(), u > 0 || ks > 0);
        }
        wg_commit();
      }
      wg_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      if (lane == 0) bar_arrive(&empty[s]);
      if (owner) {
        fence_regs(dq);
        if (lane == 0) bar_arrive(&ds_empty[d2]);
#pragma unroll
        for (int jj = 0; jj < DH / 8; ++jj)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = qrow + 8 * hh, col = 8 * jj + 2 * t;
            float2* part = reinterpret_cast<float2*>(acc + (size_t)row * DH +
                                                     col);
            float x = dq[4 * jj + 2 * hh], y = dq[4 * jj + 2 * hh + 1];
            if (grp > 0) {  // the earlier groups' sum first
              const float2 e = *part;
              x = e.x + x;
              y = e.y + y;
            }
            if (grp + 1 < groups) {
              *part = make_float2(x, y);
            } else if (row < T) {
              *reinterpret_cast<uint32_t*>(A.dq + ((size_t)bh * T + row) * DH +
                                           col) =
                  tc::pack_bf16(x * A.scale, y * A.scale);
            }
          }
      }
    }
    // the group's dK_j (scaled) and dV_j, rows key0, key0 + 8
    if (active) {
#pragma unroll
      for (int jj = 0; jj < DH / 8; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = key0 + 8 * hh, col = 8 * jj + 2 * t;
          if (row >= T) continue;
          const size_t at = ((size_t)bh * T + row) * DH + col;
          *reinterpret_cast<uint32_t*>(A.dk + at) =
              tc::pack_bf16(dk[4 * jj + 2 * hh] * A.scale,
                            dk[4 * jj + 2 * hh + 1] * A.scale);
          *reinterpret_cast<uint32_t*>(A.dv + at) =
              tc::pack_bf16(dv[4 * jj + 2 * hh], dv[4 * jj + 2 * hh + 1]);
        }
    }
    if (lane == 0) bar_arrive(kv_empty);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

enum { GENERAL = 0, WGMMA = 1 };

// The backward's design for (dtype, T, Dh, aligned), a rule on these alone
// (mirrored by attention_plan in ops/attention.py; a launch the chosen
// design refuses fails, nothing falls back). dtype 1 = bf16; aligned: the
// bases of q, k, v on 16 bytes and their strides over b, h, t multiples of
// 8 elements, so that TMA reads them.
struct Plan {
  int design;
  int consumers;   // WGMMA: consumer warpgroups a block
  int groups;      // WGMMA: key-tile groups a block walks
  int stages;      // WGMMA: Q_i / dO_i ring slots
  int ds_bufs;     // WGMMA: dS^T tiles a consumer
  size_t smem;     // WGMMA: shared memory of a block, bytes
  int reg_limit;   // WGMMA: registers of a consumer thread (setmaxnreg)
};

inline Plan plan(int dtype, int T, int Dh, int aligned) {
  Plan p{};
  if (dtype == 1 && (Dh == 32 || Dh == 64) && T >= 1 && T <= K3_T_MAX &&
      aligned) {
    const Layout l = layout_of(T, Dh);
    p.design = WGMMA;
    p.consumers = consumers_of(Dh);
    p.groups = l.groups;
    p.stages = STAGES;
    p.ds_bufs = DS_BUFS;
    p.smem = l.bytes;
    p.reg_limit = consumer_regs(p.consumers);
    return p;
  }
  p.design = GENERAL;
  return p;
}

inline bool tma_ok(const void* ptr, const long long* strides) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 8) return false;
  return true;
}

// The 4-D map of a [B, H, T, Dh] bf16 view (element strides st over b, h,
// t), boxes of 64 rows of one head.
inline cudaError_t head_map(CUtensorMap* map, const void* base,
                            const long long* st, int B, int H, int T,
                            int Dh) {
  const uint64_t dims[4] = {(uint64_t)Dh, (uint64_t)T, (uint64_t)H,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)st[2] * 2, (uint64_t)st[1] * 2,
                               (uint64_t)st[0] * 2};
  return tensor_map4(map, base, dims, strides, ROWS, (uint32_t)Dh);
}

template <int DH>
cudaError_t launch(const Plan& p, const void* q, const void* k,
                   const void* v, const void* d_o, const long long* qs,
                   const long long* ks, const long long* vs,
                   const long long* dos, const Args& a, int B,
                   cudaStream_t s) {
  if (p.smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e = head_map(&tq, q, qs, B, a.H, a.T, DH);
  if (e == cudaSuccess) e = head_map(&tk, k, ks, B, a.H, a.T, DH);
  if (e == cudaSuccess) e = head_map(&tv, v, vs, B, a.H, a.T, DH);
  if (e == cudaSuccess) e = head_map(&tdo, d_o, dos, B, a.H, a.T, DH);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_wg_kernel<DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)p.smem);
  if (e != cudaSuccess) return e;
  bwd_wg_kernel<DH><<<B * a.H, (consumers_of(DH) + 1) * 128, p.smem, s>>>(
      tq, tk, tv, tdo, a);
  return cudaGetLastError();
}

}  // namespace k3wg
