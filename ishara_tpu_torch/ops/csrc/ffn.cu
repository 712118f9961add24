// The feed-forward branch with its residual for training on Hopper (sm_90a):
//   out = res + drop2(drop1(swish(x . w1 + b1)) . w2 + b2)
// forward and backward, both dropout masks regenerated and never stored.
//
// Replaces the Pallas kernels _fwd_kernel and _bwd_kernel of
// ishara_tpu/ops/ffn_kernel.py (behind ffn_residual) and the mask probe
// behind debug_masks. x, res, dy, out, dx are [N, K] in the compute type,
// bf16 or f32; w1 [K, M] and w2 [M, K] are of that type too; the biases and
// every weight gradient are f32.
//
// Arithmetic and rounding points as the reference: both products take
// operands of the compute type and accumulate in f32; the hidden a =
// swish(h) * keep1' is rounded to the compute type before the second product;
// in the backward g = dy * keep2' (f32, summed into db2 unrounded) is rounded
// for its two products, dh = (g . w2^T) * keep1' * swish'(h) is f32 (summed
// into db1 unrounded) and rounded for its two. keep' = keep /
// (1 - rate) is the Philox function of philox.cuh: the hidden's mask is keyed
// by seeds[0] with flat index (roff + row) * M + column, the output's by
// seeds[1] with (roff + row) * K + column; roff is 0 unless the rows are a
// shard of a larger batch.
//
// A tensor-parallel rank holds hidden columns [mcol, mcol + M) of a hidden
// of mld (w1's columns and b1, w2's rows): its hidden mask takes flat index
// (roff + row) * mld + mcol + column, the unsharded launch's there, and it
// passes no res and no b2 (null) and rate2 0, so that out is its partial
// sum drop1(swish(x . w1 + b1)) . w2, to be summed over the ranks before the
// bias, the output's dropout and the residual.
//
// Two designs, chosen by a rule on (dtype, K, M) alone (plan() below,
// mirrored by ffn_plan in ops/ffn_kernel.py; a launch the chosen design
// refuses fails, nothing falls back):
// - wgmma: bf16, K a multiple of 64 up to 256, M a multiple of 64 -- every
//   preset's training geometry, the flagship (K 256, M 512) included.
//   Hopper's warpgroup products fed by TMA through mbarrier rings, the
//   hidden kept in registers (see "The wgmma design" below, hopper.cuh);
// - general: f32, and bf16 at any other width, the row products as f32
//   FMAs on the CUDA cores.
//
// Both take the backward in three steps: (1) a row kernel recomputes h =
// x . w1 and dd = g . w2^T chunk by chunk, writes dx = dh . w1^T and leaves
// d = a * keep1', dh and g (in the compute type) in global scratch with
// fixed-order column sums of dh and g as partial rows of db1 and db2; (2)
// the weight products of wgrad.cuh form dw2 = d^T . g and dw1 = x^T . dh as
// split sums over row ranges; (3) the partial sums are added in a fixed
// order. No atomics: every gradient is the same from run to run. Launches
// of the wgmma design: 1 forward; 1 + 2 + 6 backward (its db sums take two
// passes).
//
// Bound: operations (12 N K M for forward and backward together, 71 GFLOP
// at N 45056, K 256, M 512, against 115 MB of x, res, dy, out, dx); the
// backward's scratch (d, dh and g in bf16, ~115 MB written and read once)
// is what the split into a row kernel and weight products costs. In
// practice the wgmma design is bound by neither: its epilogues' CUDA-core
// work (a Philox block of ~40 integer operations for every 4 elements of
// the hidden and of the output, the swish's two MUFU operations an element)
// takes longer than the tensor cores' products, so its pipelines are built
// to run that work while products are in flight (PERF.md, section 6).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include "hopper.cuh"
#include "mma.cuh"
#include "philox.cuh"
#include "wgrad.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// The Philox words of the accumulator elements of rows r and r + 8,
// columns c, c + 1 (c = ... + 2t, so c and c + 1 share a Philox block): flat
// index row * ld + col0 + column, ld % 4 == col0 % 4 == 0. Lane t & 1 == 0
// computes the block of row r, its partner that of row r + 8; each sends the
// two words the other needs. k[e]: e 0, 1 row r; e 2, 3 row r + 8.
__device__ __forceinline__ void keep_words(uint32_t seed, uint64_t r, int c,
                                           uint64_t ld, uint64_t col0,
                                           uint32_t k[4]) {
  const int odd = threadIdx.x & 1;  // t & 1, t = lane % 4
  const uint64_t idx = (r + (odd ? 8 : 0)) * ld + col0 + (uint64_t)(c & ~3);
  const uint4 w = philox::block(seed, idx >> 2);
  const uint32_t s0 = odd ? w.x : w.z, s1 = odd ? w.y : w.w;
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  k[0] = odd ? r0 : w.x;
  k[1] = odd ? r1 : w.y;
  k[2] = odd ? w.z : r0;
  k[3] = odd ? w.w : r1;
}

// The keep decisions of a thread's 32 accumulator elements of a 64-column
// block from column c0 (bit 4 j + e: 8-column block j, element e as in
// keep_words), all ones when threshold is 0. Drawn while products are in
// flight, they keep the Philox rounds off the epilogue.
__device__ __forceinline__ uint32_t keep_bits(uint32_t seed, uint64_t r,
                                              int c0, uint64_t ld,
                                              uint64_t col0,
                                              uint32_t threshold) {
  if (threshold == 0u) return 0xFFFFFFFFu;
  uint32_t bits = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t k[4];
    keep_words(seed, r, c0 + 8 * j + 2 * (threadIdx.x & 3), ld, col0, k);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      bits |= (uint32_t)(k[e] >= threshold) << (4 * j + e);
  }
  return bits;
}

__device__ __forceinline__ float keep_of(uint32_t bits, int i, float scale) {
  return (bits >> i) & 1u ? scale : 0.f;
}

// The fast exponential and division (within a few ulp of f32), as in
// conv_module.cu: with the IEEE forms the epilogue's swish costs about as
// much as the products.
__device__ __forceinline__ float sigmoid(float h) {
  return __fdividef(1.f, 1.f + __expf(-h));
}

// ---------------------------------------------------------------------------
// The wgmma design: bf16, K = 64 KD (KD 1 to 4), M a multiple of 64.
//
// A block of three warpgroups owns a tile of 128 rows: warpgroup 0 is the
// producer (one thread issues every TMA copy), warpgroups 1 and 2 each
// multiply 64 of the rows, so each weight byte brought from L2 serves 128
// rows. Shared memory: the x tiles of the two consumers ([64][K] each, as
// KD boxes of [64][64]), in the backward also their g tiles, then a ring of
// S slots of K * 128 bytes. The hidden is walked in chunks of 64 columns;
// per chunk the producer fills two slots, W1[:, chunk] (one box [K][64]) and
// W2[chunk, :] (KD boxes [64][64]), each slot under a full and an empty
// mbarrier. Both slots serve both products that read them: wgmma's
// transpose bit reads a tile MN-major (forward) or K-major (backward), so
// no transposed copy of a weight is made.
//
// Forward, per chunk c of a consumer: h = x . W1[:, c] (16 products
// m64n64k16 at K 256, A = its x tile), then bias, swish and keep1' on the
// accumulators, rounded to bf16 straight into A fragments, and y += a .
// W2[c, :] with A from registers: the hidden never leaves the registers.
// The A fragments are double-buffered so that h of chunk c + 1 is issued
// ahead of y of chunk c, and the Philox keep bits of chunk c + 1 (and, at
// the first K / 64 chunks, those of one 64-column box of the output) are
// drawn while both products are in flight; the epilogue then waits only
// for h. The output's residual words are loaded a 64-column box ahead.
// Backward, per chunk: h = x . W1[:, c] and dd = g . W2[c, :]^T as one
// group, their epilogue forms d and dh in registers (d, dh to scratch for
// the weight products, the column sums of dh into db1), and dx += dh .
// W1[:, c]^T takes dh as register A; the next chunk's products and keep
// bits follow at once. g = dy * keep2' is formed in the consumer's own
// tile (four rows of dy in flight a lane) while its first h product runs.
// db1 and db2 are partial rows of 16 rows (a warp's), added later in a
// fixed order, in two passes.
//
// Registers: a consumer thread holds y (or dx), 64 x K f32 over 128
// threads: K / 2 registers; a 64 x 64 f32 chunk, 32; a chunk's bf16 A
// fragments, 16. The forward holds y, h and two sets of fragments (192 at
// K 256), the backward dx, h, dd and one set (208), which is why the
// producer warpgroup gives up its registers (setmaxnreg 24) for the
// consumers' 240.
//
// Rows past N read as zeros (TMA) and are never stored, so N needs no
// padding. The launch gives each block one tile, yet the producer and the
// consumers walk tiles blockIdx.x, + gridDim.x, ... (one pass here), as
// FlashAttention-3's single-tile scheduler does: written as straight-line
// code for one tile, the consumers' wgmma were serialised by ptxas for
// want of registers (CUDA 12.8, C7512) and up to 968 bytes spilled at
// K 256; inside the loop neither happens (PERF.md, section 6).
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int ROWS = 128;          // rows of a tile
constexpr int THREADS = 384;       // producer warpgroup + two consumers
constexpr int MC = 64;             // hidden columns of a chunk
constexpr int BOX = 64 * 64 * 2;   // bytes of a [64][64] bf16 box
constexpr int PART = 16;           // rows of a partial db row
constexpr int CONSUMER_WARPS = 8;  // arrivals that free a slot
// registers a thread (setmaxnreg) of the producer and of a consumer
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

struct Ring {
  unsigned char* tiles;   // [fixed][KD * BOX]: x (and g) tiles
  unsigned char* slots;   // [S][KD * BOX]
  uint64_t *full, *empty, *xfull, *xempty;
};

// Carves shared memory and (thread 0) initialises the barriers.
__device__ __forceinline__ Ring carve(unsigned char* raw, int fixed, int tile,
                                      int S) {
  Ring r;
  r.tiles = align1024(raw);
  r.slots = r.tiles + (size_t)fixed * tile;
  r.full = reinterpret_cast<uint64_t*>(r.slots + (size_t)S * tile);
  r.empty = r.full + S;
  r.xfull = r.empty + S;
  r.xempty = r.xfull + 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(&r.full[s], 1);
      bar_init(&r.empty[s], CONSUMER_WARPS);
    }
    for (int w = 0; w < 2; ++w) {
      bar_init(&r.xfull[w], 1);
      bar_init(&r.xempty[w], CONSUMER_WARPS / 2);
    }
    bar_init_fence();
  }
  __syncthreads();
  return r;
}

// The producer (one thread): per tile the two x tiles, then per chunk
// W1[:, c] and W2[c, :] (W2 first with W2_FIRST), load L into slot L % S at
// round L / S. The forward holds up to 4 slots at once (W2 of chunk c - 1,
// W1 and W2 of c, W1 of c + 1), the backward 3 (W1 of c, both of c + 1),
// which is why it takes W2 first: W2 of c is freed as soon as dd is formed.
template <int KD, bool W2_FIRST>
__device__ __forceinline__ void produce(const CUtensorMap* tx,
                                        const CUtensorMap* tw1,
                                        const CUtensorMap* tw2,
                                        const Ring& r, int S, int nc,
                                        int ntiles) {
  constexpr int TILE = KD * BOX;
  int L = 0, it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    for (int w = 0; w < 2; ++w) {
      bar_wait(&r.xempty[w], (it & 1) ^ 1);
      bar_expect(&r.xfull[w], TILE);
#pragma unroll
      for (int b = 0; b < KD; ++b)
        tma_load(r.tiles + w * TILE + b * BOX, tx, &r.xfull[w], 64 * b,
                 tile * ROWS + 64 * w);
    }
    for (int c = 0; c < nc; ++c)
      for (int part = 0; part < 2; ++part, ++L) {
        const int s = L % S;
        bar_wait(&r.empty[s], ((L / S) & 1) ^ 1);
        bar_expect(&r.full[s], TILE);
        unsigned char* dst = r.slots + (size_t)s * TILE;
        if ((part == 0) != W2_FIRST) {
          tma_load(dst, tw1, &r.full[s], MC * c, 0);
        } else {
#pragma unroll
          for (int b = 0; b < KD; ++b)
            tma_load(dst + b * BOX, tw2, &r.full[s], 64 * b, MC * c);
        }
      }
  }
}

// Descriptor offsets (16-byte units) of k16 step ks in a tile of KD boxes:
// K-major along the boxes' rows, MN-major down them.
__device__ __forceinline__ uint64_t kstep(int ks) {
  return (uint64_t)(((ks >> 2) * BOX + (ks & 3) * 32) >> 4);
}
__device__ __forceinline__ uint64_t mnstep(int ks) {
  return (uint64_t)((ks * 2048) >> 4);
}

template <int KD>
__global__ void __launch_bounds__(THREADS, 1)
ffn_fwd_wg_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw1,
                  const __grid_constant__ CUtensorMap tw2,
                  const bf16* __restrict__ res, const float* __restrict__ b1,
                  const float* __restrict__ b2, const int* __restrict__ seeds,
                  bf16* __restrict__ out, int N, int M, int S, uint32_t thr1,
                  float sc1, uint32_t thr2, float sc2, long long roff,
                  long long mld, long long mcol) {
  constexpr int K = 64 * KD, TILE = KD * BOX;
  extern __shared__ unsigned char smem_raw[];
  const Ring r = carve(smem_raw, 2, TILE, S);
  const int nc = M / MC, ntiles = (N + ROWS - 1) / ROWS;
  if (threadIdx.x < 128) {
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0)
      produce<KD, false>(&tx, &tw1, &tw2, r, S, nc, ntiles);
    return;
  }
  regs_inc<CONSUMER_REGS>();
  const int w = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const uint32_t seed1 = (uint32_t)seeds[0], seed2 = (uint32_t)seeds[1];
  const uint64_t dxs = desc(r.tiles + w * TILE);
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const long long row = (long long)tile * ROWS + 64 * w + 16 * warp + g;
    const int L0 = it * 2 * nc;
    // accumulators start at the first product (scale_d 0): a store of zeros
    // in flight of another product would serialise the pipeline
    float y[KD][32], h[32];
    uint32_t a0[4][4], a1[4][4];
    bar_wait(&r.xfull[w], it & 1);

    // h = x . W1[:, c], one group
    auto issue_h = [&](int c) {
      const int L = L0 + 2 * c, s = L % S;
      bar_wait(&r.full[s], (L / S) & 1);
      const uint64_t dw = desc(r.slots + (size_t)s * TILE);
      fence_regs(h);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < K / 16; ++ks)
        mma_ss<1>(h, dxs + kstep(ks), dw + mnstep(ks), ks > 0);
      wg_commit();
    };
    // h of chunk c has landed: free W1[:, c] (and x after the last chunk),
    // a = drop1(swish(h + b1)) rounded into bf16 A fragments
    auto epilogue = [&](int c, uint32_t (&a)[4][4], uint32_t bits) {
      fence_regs(h);
      if (lane == 0) {
        bar_arrive(&r.empty[(L0 + 2 * c) % S]);
        if (c == nc - 1) bar_arrive(&r.xempty[w]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * MC + 8 * j + 2 * t;
        const float bb[2] = {b1[col], b1[col + 1]};
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float hv = h[4 * j + e] + bb[e & 1];
          v[e] = __fmul_rn(__fmul_rn(hv, sigmoid(hv)),
                           keep_of(bits, 4 * j + e, sc1));
        }
        a[j >> 1][(j & 1) * 2] = tc::pack_bf16(v[0], v[1]);
        a[j >> 1][(j & 1) * 2 + 1] = tc::pack_bf16(v[2], v[3]);
      }
    };
    // y += a . W2[c, :], A from registers, one group
    auto issue_y = [&](int c, uint32_t (&a)[4][4]) {
      const int L = L0 + 2 * c + 1, s = L % S;
      bar_wait(&r.full[s], (L / S) & 1);
      const uint64_t dw = desc(r.slots + (size_t)s * TILE);
#pragma unroll
      for (int nb = 0; nb < KD; ++nb) fence_regs(y[nb]);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) fence_regs(a[ks]);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int nb = 0; nb < KD; ++nb)
          mma_rs<1>(y[nb], a[ks], dw + (uint64_t)(nb * BOX >> 4) + mnstep(ks),
                    c > 0 || ks > 0);
      wg_commit();
    };
    // the output's keep bits of columns [64 nb, 64 nb + 64), formed at
    // chunk nb (the rest, when there are fewer chunks, after the last)
    uint32_t ob[KD];
    auto out_bits = [&](int c) {
#pragma unroll
      for (int nb = 0; nb < KD; ++nb)
        if (nb == c)
          ob[nb] = keep_bits(seed2, (uint64_t)(roff + row), nb * 64, K, 0,
                             thr2);
    };
    // Chunk c's A fragments in a, the next chunk's go to b: h of c + 1 is
    // issued ahead of y of c, and the Philox words of c + 1 are drawn while
    // both are in flight, so that c + 1's epilogue waits only for h.
    auto step = [&](int c, uint32_t (&a)[4][4], uint32_t (&b)[4][4]) {
      if (c + 1 < nc) issue_h(c + 1);
      issue_y(c, a);
      out_bits(c);
      if (c + 1 < nc) {
        const uint32_t bits =
            keep_bits(seed1, (uint64_t)(roff + row), (c + 1) * MC, mld, mcol,
                      thr1);
        wg_wait<1>();  // h of c + 1, y of c - 1
        if (lane == 0 && c > 0) bar_arrive(&r.empty[(L0 + 2 * c - 1) % S]);
        epilogue(c + 1, b, bits);
      }
    };

    issue_h(0);
    {
      const uint32_t bits =
          keep_bits(seed1, (uint64_t)(roff + row), 0, mld, mcol, thr1);
      wg_wait<0>();
      epilogue(0, a0, bits);
    }
    for (int c = 0; c < nc; c += 2) {
      step(c, a0, a1);
      if (c + 1 < nc) step(c + 1, a1, a0);
    }
#pragma unroll
    for (int nb = 0; nb < KD; ++nb)
      if (nb >= nc)
        ob[nb] = keep_bits(seed2, (uint64_t)(roff + row), nb * 64, K, 0,
                           thr2);
    // out = res + (y + b2) * keep2', a box of 64 columns at a time with
    // the next box's residual words already on their way (the loads, not
    // the arithmetic, are what this epilogue waits for)
    uint32_t rv[2][8][2];
    auto load_res = [&](int nb, uint32_t (&v)[8][2]) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long rr = row + 8 * hh;
          v[j][hh] = res && rr < N
                         ? *reinterpret_cast<const uint32_t*>(
                               res + (size_t)rr * K + nb * 64 + 8 * j + 2 * t)
                         : 0u;
        }
    };
    load_res(0, rv[0]);
    wg_wait<0>();
#pragma unroll
    for (int nb = 0; nb < KD; ++nb) fence_regs(y[nb]);
    if (lane == 0) {
      if (nc > 1) bar_arrive(&r.empty[(L0 + 2 * nc - 3) % S]);
      bar_arrive(&r.empty[(L0 + 2 * nc - 1) % S]);
    }
#pragma unroll
    for (int nb = 0; nb < KD; ++nb) {
      if (nb + 1 < KD) load_res(nb + 1, rv[(nb + 1) & 1]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nb * 64 + 8 * j + 2 * t;
        const float bb[2] = {b2 ? b2[col] : 0.f, b2 ? b2[col + 1] : 0.f};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long rr = row + 8 * hh;
          if (rr >= N) continue;
          const __nv_bfloat162 r2 =
              *reinterpret_cast<const __nv_bfloat162*>(&rv[nb & 1][j][hh]);
          *reinterpret_cast<uint32_t*>(out + (size_t)rr * K + col) =
              tc::pack_bf16(
                  __fadd_rn(__low2float(r2),
                            __fmul_rn(y[nb][4 * j + 2 * hh] + bb[0],
                                      keep_of(ob[nb], 4 * j + 2 * hh, sc2))),
                  __fadd_rn(__high2float(r2),
                            __fmul_rn(y[nb][4 * j + 2 * hh + 1] + bb[1],
                                      keep_of(ob[nb], 4 * j + 2 * hh + 1,
                                              sc2))));
        }
      }
    }
  }
}

// Backward, step 1 (the weight products and the sums as the other designs).
template <int KD>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_wg_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw1,
                  const __grid_constant__ CUtensorMap tw2,
                  const bf16* __restrict__ dy, const float* __restrict__ b1,
                  const int* __restrict__ seeds, bf16* __restrict__ dx,
                  bf16* __restrict__ d_g, bf16* __restrict__ dh_g,
                  bf16* __restrict__ g_g, float* __restrict__ db1_part,
                  float* __restrict__ db2_part, int N, int M, int S,
                  uint32_t thr1, float sc1, uint32_t thr2, float sc2,
                  long long roff, long long mld, long long mcol) {
  constexpr int K = 64 * KD, TILE = KD * BOX;
  extern __shared__ unsigned char smem_raw[];
  const Ring r = carve(smem_raw, 4, TILE, S);
  const int nc = M / MC, ntiles = (N + ROWS - 1) / ROWS;
  if (threadIdx.x < 128) {
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0)
      produce<KD, true>(&tx, &tw1, &tw2, r, S, nc, ntiles);
    return;
  }
  regs_inc<CONSUMER_REGS>();
  const int w = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const uint32_t seed1 = (uint32_t)seeds[0], seed2 = (uint32_t)seeds[1];
  unsigned char* gs = r.tiles + (2 + w) * TILE;
  const uint64_t dxs = desc(r.tiles + w * TILE), dgs = desc(gs);
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const long long row0 = (long long)tile * ROWS + 64 * w;
    const long long row = row0 + 16 * warp + g;
    const size_t prow = (size_t)tile * (ROWS / PART) + 4 * w + warp;
    const int L0 = it * 2 * nc;
    float acc[KD][32], hh[32], hd[32];
    uint32_t a[4][4];
    bar_wait(&r.xfull[w], it & 1);

    // W2 of chunk c is load L0 + 2c, W1 of chunk c load L0 + 2c + 1
    auto issue_h = [&](int c) {
      const int L = L0 + 2 * c + 1, s = L % S;
      bar_wait(&r.full[s], (L / S) & 1);
      const uint64_t dw = desc(r.slots + (size_t)s * TILE);
      fence_regs(hh);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < K / 16; ++ks)
        mma_ss<1>(hh, dxs + kstep(ks), dw + mnstep(ks), ks > 0);
    };
    auto issue_dd = [&](int c) {
      const int L = L0 + 2 * c, s = L % S;
      bar_wait(&r.full[s], (L / S) & 1);
      const uint64_t dw = desc(r.slots + (size_t)s * TILE);
      fence_regs(hd);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < K / 16; ++ks)
        mma_ss<0>(hd, dgs + kstep(ks), dw + kstep(ks), ks > 0);
    };

    issue_h(0);
    wg_commit();
    // g = dy * keep2' for the warp's 16 rows, a lane 8 columns: to the g
    // tile (swizzled as TMA would), to scratch, and summed for db2
    if (lane < K / 8) {
      const int col = lane * 8;
      float sum[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[e] = 0.f;
      for (int lr0 = 16 * warp; lr0 < 16 * warp + 16; lr0 += 4) {
        uint4 raw[4];  // four rows' loads in flight at once
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long rr = row0 + lr0 + q;
          raw[q] = rr < N ? *reinterpret_cast<const uint4*>(
                                dy + (size_t)rr * K + col)
                          : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int lr = lr0 + q;
          const long long rr = row0 + lr;
          const bf16* dv = reinterpret_cast<const bf16*>(&raw[q]);
          float kp[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
          if (thr2) {
            const uint64_t idx = (uint64_t)(roff + rr) * K + col;
            philox::keep4(seed2, idx, thr2, sc2, kp);
            philox::keep4(seed2, idx + 4, thr2, sc2, kp + 4);
          }
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            v[e] = __fmul_rn(__bfloat162float(dv[e]), kp[e]);
            sum[e] += v[e];
          }
          const uint4 packed = make_uint4(
              tc::pack_bf16(v[0], v[1]), tc::pack_bf16(v[2], v[3]),
              tc::pack_bf16(v[4], v[5]), tc::pack_bf16(v[6], v[7]));
          *reinterpret_cast<uint4*>(gs + (lane >> 3) * BOX + lr * 128 +
                                    (((lane & 7) ^ (lr & 7)) << 4)) = packed;
          if (rr < N)
            *reinterpret_cast<uint4*>(g_g + (size_t)rr * K + col) = packed;
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) db2_part[prow * K + col + e] = sum[e];
    }
    fence_async_smem();
    named_sync(1 + w, 128);
    issue_dd(0);
    wg_commit();
    // the hidden's keep bits of the chunk whose products are in flight
    uint32_t bits =
        keep_bits(seed1, (uint64_t)(roff + row), 0, mld, mcol, thr1);

    for (int c = 0; c < nc; ++c) {
      wg_wait<0>();
      fence_regs(hh);
      fence_regs(hd);
      if (lane == 0) {
        bar_arrive(&r.empty[(L0 + 2 * c) % S]);
        if (c > 0) bar_arrive(&r.empty[(L0 + 2 * c - 1) % S]);
        if (c == nc - 1) bar_arrive(&r.xempty[w]);
      }
      // d = swish(h) * keep1', dh = dd * keep1' * swish'(h); the warp's 16
      // rows of db1 summed over g in a fixed order
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * MC + 8 * j + 2 * t;
        float kp[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) kp[e] = keep_of(bits, 4 * j + e, sc1);
        const float bb[2] = {b1[col], b1[col + 1]};
        float d[4], dh[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float hv = hh[4 * j + e] + bb[e & 1];
          const float sig = sigmoid(hv);
          const float hsw = __fmul_rn(hv, sig);
          d[e] = __fmul_rn(hsw, kp[e]);
          const float da = __fmul_rn(hd[4 * j + e], kp[e]);
          dh[e] = da * (sig + hsw * (1.f - sig));
        }
        a[j >> 1][(j & 1) * 2] = tc::pack_bf16(dh[0], dh[1]);
        a[j >> 1][(j & 1) * 2 + 1] = tc::pack_bf16(dh[2], dh[3]);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const long long rr = row + 8 * h2;
          if (rr >= N) continue;
          const size_t at = (size_t)rr * M + col;
          *reinterpret_cast<uint32_t*>(d_g + at) =
              tc::pack_bf16(d[2 * h2], d[2 * h2 + 1]);
          *reinterpret_cast<uint32_t*>(dh_g + at) = a[j >> 1][(j & 1) * 2 + h2];
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = dh[e] + dh[e + 2];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          if (g == 0) db1_part[prow * M + col + e] = v;
        }
      }
      // dx += dh . W1[:, c]^T (W1's slot is still held)
      const uint64_t dw1 =
          desc(r.slots + (size_t)((L0 + 2 * c + 1) % S) * TILE);
#pragma unroll
      for (int nb = 0; nb < KD; ++nb) fence_regs(acc[nb]);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) fence_regs(a[ks]);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int nb = 0; nb < KD; ++nb)
          mma_rs<0>(acc[nb], a[ks],
                    dw1 + (uint64_t)(nb * BOX >> 4) + (uint64_t)(ks * 2),
                    c > 0 || ks > 0);
      wg_commit();
      if (c + 1 < nc) {
        issue_h(c + 1);
        issue_dd(c + 1);
        wg_commit();
        bits = keep_bits(seed1, (uint64_t)(roff + row), (c + 1) * MC, mld,
                         mcol, thr1);
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int nb = 0; nb < KD; ++nb) fence_regs(acc[nb]);
    if (lane == 0) bar_arrive(&r.empty[(L0 + 2 * nc - 1) % S]);
#pragma unroll
    for (int nb = 0; nb < KD; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const long long rr = row + 8 * h2;
          if (rr >= N) continue;
          *reinterpret_cast<uint32_t*>(dx + (size_t)rr * K + nb * 64 + 8 * j +
                                       2 * t) =
              tc::pack_bf16(acc[nb][4 * j + 2 * h2],
                            acc[nb][4 * j + 2 * h2 + 1]);
        }
  }
}

}  // namespace wg

// k1 [n, m] and k2 [n, k]: 1 where the kernels keep an element, else 0.
__global__ void ffn_masks_kernel(const int* __restrict__ seeds,
                                 float* __restrict__ k1, float* __restrict__ k2,
                                 long long n1, long long n2, uint32_t thr1,
                                 uint32_t thr2, long long o1, long long o2) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = tid; i < n1 + n2; i += stride) {
    const bool first = i < n1;
    const long long idx = first ? i : i - n1;
    const uint32_t word =
        philox::bits((uint32_t)seeds[first ? 0 : 1],
                     (uint64_t)(idx + (first ? o1 : o2)));
    (first ? k1 : k2)[idx] = word >= (first ? thr1 : thr2) ? 1.f : 0.f;
  }
}

// ---------------------------------------------------------------------------
// The general kernels: compute type T = float or bf16, any widths. The
// same three backward steps and the same rounding points as above; the
// products are f32 FMAs. A block owns GR rows, which it holds widened to
// f32 in shared memory; a thread owns a column of the result for all GR
// rows, so that every weight it reads (coalesced across the block) is used
// GR times. The backward reads w2 and w1 through transposed copies (made by
// ffn_transpose_kernel into scratch) so that those reads coalesce as well.
// ---------------------------------------------------------------------------

constexpr int GR = 8;         // rows a block owns
constexpr int THREADS = 256;
constexpr int PAD_ROWS = 64;  // N is padded to a multiple of this

using wgrad::narrow;
using wgrad::widen;

// keep' of the element at flat index idx.
__device__ __forceinline__ float keep1(uint32_t seed, uint64_t idx,
                                       uint32_t threshold, float scale) {
  if (threshold == 0u) return 1.f;
  return philox::bits(seed, idx) >= threshold ? scale : 0.f;
}

// dst [cols, rows] = src [rows, cols] transposed.
template <typename T>
__global__ void ffn_transpose_kernel(const T* __restrict__ src,
                                     T* __restrict__ dst, int rows, int cols) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * cols) return;
  const int c = i / rows, r = i - c * rows;
  dst[i] = src[(size_t)r * cols + c];
}

// Shared memory: xs [GR][K] | hs [GR][M], f32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ffn_fwd_general_kernel(const T* __restrict__ x, const T* __restrict__ res,
                       const T* __restrict__ w1, const float* __restrict__ b1,
                       const T* __restrict__ w2, const float* __restrict__ b2,
                       const int* __restrict__ seeds, T* __restrict__ out,
                       int K, int M, uint32_t thr1, float sc1, uint32_t thr2,
                       float sc2, long long roff, long long mld,
                       long long mcol) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* hs = xs + GR * K;
  const int row0 = blockIdx.x * GR;
  const uint32_t seed1 = (uint32_t)seeds[0], seed2 = (uint32_t)seeds[1];

  for (int e = threadIdx.x; e < GR * K; e += THREADS)
    xs[e] = widen(x[(size_t)row0 * K + e]);
  __syncthreads();

  // hidden = swish(x . w1 + b1) * keep1', rounded to T
  for (int c = threadIdx.x; c < M; c += THREADS) {
    float acc[GR];
#pragma unroll
    for (int r = 0; r < GR; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = widen(w1[(size_t)k * M + c]);
#pragma unroll
      for (int r = 0; r < GR; ++r) acc[r] = fmaf(xs[r * K + k], w, acc[r]);
    }
    const float bias = b1[c];
#pragma unroll
    for (int r = 0; r < GR; ++r) {
      const float h = acc[r] + bias;
      const float sig = 1.f / (1.f + expf(-h));
      const float keep = keep1(
          seed1, (uint64_t)(roff + row0 + r) * mld + mcol + c, thr1, sc1);
      hs[r * M + c] = widen(narrow<T>(__fmul_rn(__fmul_rn(h, sig), keep)));
    }
  }
  __syncthreads();

  // out = res + (hidden . w2 + b2) * keep2' (no res, no b2: null)
  for (int c = threadIdx.x; c < K; c += THREADS) {
    float acc[GR];
#pragma unroll
    for (int r = 0; r < GR; ++r) acc[r] = 0.f;
    for (int m = 0; m < M; ++m) {
      const float w = widen(w2[(size_t)m * K + c]);
#pragma unroll
      for (int r = 0; r < GR; ++r) acc[r] = fmaf(hs[r * M + m], w, acc[r]);
    }
    const float bias = b2 ? b2[c] : 0.f;
#pragma unroll
    for (int r = 0; r < GR; ++r) {
      const size_t at = (size_t)(row0 + r) * K + c;
      const float y = acc[r] + bias;
      const float keep =
          keep1(seed2, (uint64_t)(at + (size_t)roff * K), thr2, sc2);
      out[at] = narrow<T>(
          __fadd_rn(res ? widen(res[at]) : 0.f, __fmul_rn(y, keep)));
    }
  }
}

// Backward, step 1. Shared memory: xs [GR][K] | gs [GR][K] | dhs [GR][M],
// f32 (gs and dhs hold values already rounded to T). w2t [K, M] and
// w1t [M, K] are the transposes of w2 and w1.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ffn_bwd_rows_general_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            const T* __restrict__ w1,
                            const float* __restrict__ b1,
                            const T* __restrict__ w2t,
                            const T* __restrict__ w1t,
                            const int* __restrict__ seeds, T* __restrict__ dx,
                            T* __restrict__ d_g, T* __restrict__ dh_g,
                            T* __restrict__ g_g, float* __restrict__ db1_part,
                            float* __restrict__ db2_part, int K, int M,
                            uint32_t thr1, float sc1, uint32_t thr2,
                            float sc2, long long roff, long long mld,
                            long long mcol) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* gs = xs + GR * K;
  float* dhs = gs + GR * K;
  const int row0 = blockIdx.x * GR;
  const uint32_t seed1 = (uint32_t)seeds[0], seed2 = (uint32_t)seeds[1];

  for (int e = threadIdx.x; e < GR * K; e += THREADS)
    xs[e] = widen(x[(size_t)row0 * K + e]);
  // g = dy * keep2'; a thread owns a column, so its sum over the rows (this
  // block's share of db2) has a fixed order
  for (int c = threadIdx.x; c < K; c += THREADS) {
    float sum = 0.f;
    for (int r = 0; r < GR; ++r) {
      const size_t at = (size_t)(row0 + r) * K + c;
      const float g =
          __fmul_rn(widen(dy[at]),
                    keep1(seed2, (uint64_t)(at + (size_t)roff * K), thr2, sc2));
      sum += g;
      const T gt = narrow<T>(g);
      gs[r * K + c] = widen(gt);
      g_g[at] = gt;
    }
    db2_part[(size_t)blockIdx.x * K + c] = sum;
  }
  __syncthreads();

  // h = x . w1 + b1 and dd = g . w2^T in one pass over the weights
  for (int c = threadIdx.x; c < M; c += THREADS) {
    float acc_h[GR], acc_d[GR];
#pragma unroll
    for (int r = 0; r < GR; ++r) acc_h[r] = acc_d[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float wa = widen(w1[(size_t)k * M + c]);
      const float wb = widen(w2t[(size_t)k * M + c]);
#pragma unroll
      for (int r = 0; r < GR; ++r) {
        acc_h[r] = fmaf(xs[r * K + k], wa, acc_h[r]);
        acc_d[r] = fmaf(gs[r * K + k], wb, acc_d[r]);
      }
    }
    const float bias = b1[c];
    float colsum = 0.f;
#pragma unroll
    for (int r = 0; r < GR; ++r) {
      const size_t at = (size_t)(row0 + r) * M + c;
      const float keep = keep1(
          seed1, (uint64_t)(roff + row0 + r) * mld + mcol + c, thr1, sc1);
      const float h = acc_h[r] + bias;
      const float sig = 1.f / (1.f + expf(-h));
      const float hsw = __fmul_rn(h, sig);
      const float da = __fmul_rn(acc_d[r], keep);
      const float dh = da * (sig + hsw * (1.f - sig));
      colsum += dh;
      const T dht = narrow<T>(dh);
      d_g[at] = narrow<T>(__fmul_rn(hsw, keep));
      dh_g[at] = dht;
      dhs[r * M + c] = widen(dht);
    }
    db1_part[(size_t)blockIdx.x * M + c] = colsum;
  }
  __syncthreads();

  // dx = dh . w1^T
  for (int c = threadIdx.x; c < K; c += THREADS) {
    float acc[GR];
#pragma unroll
    for (int r = 0; r < GR; ++r) acc[r] = 0.f;
    for (int m = 0; m < M; ++m) {
      const float w = widen(w1t[(size_t)m * K + c]);
#pragma unroll
      for (int r = 0; r < GR; ++r) acc[r] = fmaf(dhs[r * M + m], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < GR; ++r)
      dx[(size_t)(row0 + r) * K + c] = narrow<T>(acc[r]);
  }
}

size_t fwd_general_smem(int K, int M) { return (size_t)GR * (K + M) * 4; }

size_t bwd_general_smem(int K, int M) { return (size_t)GR * (2 * K + M) * 4; }

constexpr size_t SMEM_LIMIT = 227 * 1024;

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// A slice [mcol, mcol + M) of a hidden of mld; a slice (not the whole
// hidden) starts and ends on a Philox block of 4 columns, as the tensor
// cores' keep words come.
bool hidden_ok(int M, long long mld, long long mcol) {
  if (mld == M) return mcol == 0;
  return mcol >= 0 && mcol + M <= mld && mld % 4 == 0 && mcol % 4 == 0;
}

// Which kernels take a shape, a rule on (dtype, K, M) alone, mirrored by
// ffn_plan in ops/ffn_kernel.py:
// - WGMMA: bf16, K a multiple of 64 up to 256 (the output accumulators, 64
//   x K f32, fit a consumer thread's registers beside two hidden chunks),
//   M a multiple of 64;
// - GENERAL: everything else.
enum Design { GENERAL = 0, WGMMA = 1 };

struct Plan {
  int design;
  int pad_rows;    // N is padded to a multiple of this
  int tile_rows;   // rows a block tile holds
  int part_rows;   // rows a partial db row sums over
  int fwd_slots, bwd_slots;  // WGMMA: weight slots of the forward's and
                             // backward's rings
  size_t fwd_smem, bwd_smem;
  int acc_regs;    // WGMMA: the accumulator and A-fragment registers a
                   // consumer thread holds at most (the backward's dx, h,
                   // dd and one set of fragments)
  int reg_limit;   // WGMMA: the registers a consumer thread may hold
};

constexpr size_t WG_EXTRA = 2048;  // alignment to 1024 and the barriers
constexpr int WG_MAX_SLOTS = 8;

// Ring slots beside `fixed` tiles of [64][K] (2 forward: x; 4 backward: x
// and g), a slot being one such tile.
int wg_slots(int K, int fixed) {
  const size_t tile = (size_t)(K / 64) * wg::BOX;
  const long long s = ((long long)SMEM_LIMIT - (long long)WG_EXTRA -
                       (long long)(fixed * tile)) / (long long)tile;
  return (int)(s < WG_MAX_SLOTS ? s : WG_MAX_SLOTS);
}

Plan plan(int dtype, int K, int M) {
  Plan p{};
  if (dtype == 1 && K % 64 == 0 && K >= 64 && K <= 256 && M % 64 == 0 &&
      M > 0) {
    const size_t tile = (size_t)(K / 64) * wg::BOX;
    p.design = WGMMA;
    p.pad_rows = 1;
    p.tile_rows = wg::ROWS;
    p.part_rows = wg::PART;
    p.fwd_slots = wg_slots(K, 2);
    p.bwd_slots = wg_slots(K, 4);
    p.fwd_smem = WG_EXTRA + (2 + p.fwd_slots) * tile;
    p.bwd_smem = WG_EXTRA + (4 + p.bwd_slots) * tile;
    p.acc_regs = K / 2 + 2 * 32 + 16;
    p.reg_limit = wg::CONSUMER_REGS;
    return p;
  }
  p.design = GENERAL;
  p.pad_rows = PAD_ROWS;
  p.tile_rows = GR;
  p.part_rows = GR;
  p.fwd_smem = fwd_general_smem(K, M);
  p.bwd_smem = bwd_general_smem(K, M);
  return p;
}

bool shape_ok(const Plan& p, int N, int K, int M) {
  return N > 0 && N % p.pad_rows == 0 && K > 0 && M > 0;
}

// Partial db rows a backward pass writes.
long long parts_of(const Plan& p, int N) {
  return (long long)((N + p.tile_rows - 1) / p.tile_rows) *
         (p.tile_rows / p.part_rows);
}

// Blocks of a WGMMA launch: one a tile.
int wg_grid(int N) { return (N + wg::ROWS - 1) / wg::ROWS; }

// x [N, K] in boxes of [64][64], W1 [K, M] in boxes of [K][64] (a chunk's
// columns), W2 [M, K] in boxes of [64][64].
cudaError_t wg_maps(const void* x, const void* w1, const void* w2, int N,
                    int K, int M, CUtensorMap* tx, CUtensorMap* tw1,
                    CUtensorMap* tw2) {
  cudaError_t e = hopper::tensor_map(tx, x, N, K, 64, 64);
  if (e != cudaSuccess) return e;
  e = hopper::tensor_map(tw1, w1, K, M, K, 64);
  if (e != cudaSuccess) return e;
  return hopper::tensor_map(tw2, w2, M, K, 64, 64);
}

template <int KD>
cudaError_t fwd_wg(const Plan& p, const void* x, const void* res,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* seeds, void* out, int N,
                   int M, uint32_t thr1, float sc1, uint32_t thr2, float sc2,
                   long long roff, long long mld, long long mcol,
                   cudaStream_t s) {
  CUtensorMap tx, tw1, tw2;
  cudaError_t e = wg_maps(x, w1, w2, N, 64 * KD, M, &tx, &tw1, &tw2);
  if (e != cudaSuccess) return e;
  e = allow_smem(wg::ffn_fwd_wg_kernel<KD>, p.fwd_smem);
  if (e != cudaSuccess) return e;
  wg::ffn_fwd_wg_kernel<KD>
      <<<wg_grid(N), wg::THREADS, p.fwd_smem, s>>>(
          tx, tw1, tw2, (const bf16*)res, (const float*)b1,
          (const float*)b2, (const int*)seeds, (bf16*)out, N, M, p.fwd_slots,
          thr1, sc1, thr2, sc2, roff, mld, mcol);
  return cudaGetLastError();
}

template <int KD>
cudaError_t bwd_wg(const Plan& p, const void* x, const void* dy,
                   const void* w1, const void* b1, const void* w2,
                   const void* seeds, void* dx, void* d_g, void* dh_g,
                   void* g_g, float* db1_part, float* db2_part, int N, int M,
                   uint32_t thr1, float sc1, uint32_t thr2, float sc2,
                   long long roff, long long mld, long long mcol,
                   cudaStream_t s) {
  CUtensorMap tx, tw1, tw2;
  cudaError_t e = wg_maps(x, w1, w2, N, 64 * KD, M, &tx, &tw1, &tw2);
  if (e != cudaSuccess) return e;
  e = allow_smem(wg::ffn_bwd_wg_kernel<KD>, p.bwd_smem);
  if (e != cudaSuccess) return e;
  wg::ffn_bwd_wg_kernel<KD>
      <<<wg_grid(N), wg::THREADS, p.bwd_smem, s>>>(
          tx, tw1, tw2, (const bf16*)dy, (const float*)b1, (const int*)seeds,
          (bf16*)dx, (bf16*)d_g, (bf16*)dh_g, (bf16*)g_g, db1_part, db2_part,
          N, M, p.bwd_slots, thr1, sc1, thr2, sc2, roff, mld, mcol);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_general(const void* x, const void* res, const void* w1,
                        const void* b1, const void* w2, const void* b2,
                        const void* seeds, void* out, int N, int K, int M,
                        uint32_t thr1, float sc1, uint32_t thr2, float sc2,
                        long long roff, long long mld, long long mcol,
                        cudaStream_t s) {
  const size_t smem = fwd_general_smem(K, M);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(ffn_fwd_general_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  ffn_fwd_general_kernel<T><<<N / GR, THREADS, smem, s>>>(
      (const T*)x, (const T*)res, (const T*)w1, (const float*)b1,
      (const T*)w2, (const float*)b2, (const int*)seeds, (T*)out, K, M, thr1,
      sc1, thr2, sc2, roff, mld, mcol);
  return cudaGetLastError();
}

// Step 1 of the backward on the general kernels; wt is scratch for the two
// transposed weights, 2 * K * M elements.
template <typename T>
cudaError_t bwd_general(const void* x, const void* dy, const void* w1,
                        const void* b1, const void* w2, const void* seeds,
                        void* dx, void* d_g, void* dh_g, void* g_g, void* wt,
                        float* db1_part, float* db2_part, int N, int K, int M,
                        uint32_t thr1, float sc1, uint32_t thr2, float sc2,
                        long long roff, long long mld, long long mcol,
                        cudaStream_t s) {
  const size_t smem = bwd_general_smem(K, M);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(ffn_bwd_rows_general_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  T* w2t = (T*)wt;           // [K, M]
  T* w1t = w2t + (size_t)K * M;  // [M, K]
  const int cells = K * M, tblocks = (cells + 255) / 256;
  ffn_transpose_kernel<T><<<tblocks, 256, 0, s>>>((const T*)w2, w2t, M, K);
  ffn_transpose_kernel<T><<<tblocks, 256, 0, s>>>((const T*)w1, w1t, K, M);
  ffn_bwd_rows_general_kernel<T><<<N / GR, THREADS, smem, s>>>(
      (const T*)x, (const T*)dy, (const T*)w1, (const float*)b1, w2t, w1t,
      (const int*)seeds, (T*)dx, (T*)d_g, (T*)dh_g, (T*)g_g, db1_part,
      db2_part, K, M, thr1, sc1, thr2, sc2, roff, mld, mcol);
  return cudaGetLastError();
}

// Step 2 of the backward: dw2 [M, K] = d^T . g and dw1 [K, M] = x^T . dh as
// the partials of S row splits (wgrad.cuh).
template <typename T>
cudaError_t bwd_weights(const void* x, const void* d_g, const void* dh_g,
                        const void* g_g, float* dw1_part, float* dw2_part,
                        int N, int K, int M, int S, cudaStream_t s) {
  const cudaError_t e = wgrad::product<T>((const T*)d_g, (const T*)g_g,
                                          dw2_part, N, M, K, S, s);
  if (e != cudaSuccess) return e;
  return wgrad::product<T>((const T*)x, (const T*)dh_g, dw1_part, N, K, M, S,
                           s);
}

// out [n] = the sum of part's `parts` rows in a fixed order. The wgmma
// design's partial rows (8 a tile, 2816 at the flagship) would leave the
// one-pass sum to a few blocks, so it first adds them `first` at a time
// (rows r, r + parts / first, ..; first the largest of 64, 32, 16, 8 that
// divides parts) into tmp, then tmp's rows.
cudaError_t sum_db(const Plan& p, const float* part, float* tmp, float* out,
                   long long parts, int n, cudaStream_t s) {
  if (p.design != WGMMA)
    return wgrad::sum_parts(part, out, (int)parts, n, s);
  int first = 64;  // parts is a multiple of 8
  while (parts % first) first /= 2;
  const long long rows = parts / first;
  const cudaError_t e = wgrad::sum_parts(part, tmp, first, rows * n, s);
  if (e != cudaSuccess) return e;
  return wgrad::sum_parts(tmp, out, (int)rows, n, s);
}

}  // namespace

extern "C" {

// The plan of (dtype, K, M) into out[0..9]: design (0 general, 1 wgmma),
// pad_rows, tile_rows, part_rows, fwd_slots, bwd_slots, fwd_smem, bwd_smem
// (bytes), acc_regs, reg_limit. ops/ffn_kernel.py's ffn_plan gives the same.
int ishara_ffn_plan(int dtype, int K, int M, long long* out) {
  const Plan p = plan(dtype, K, M);
  const long long v[10] = {p.design,    p.pad_rows,  p.tile_rows,
                           p.part_rows, p.fwd_slots, p.bwd_slots,
                           (long long)p.fwd_smem, (long long)p.bwd_smem,
                           p.acc_regs,  p.reg_limit};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// out [N, K] = res + drop2(drop1(swish(x . w1 + b1)) . w2 + b2). dtype 0 =
// f32, 1 = bf16 (x, res, w1, w2, out). N must be a multiple of the plan's
// pad_rows. seeds points at two int32 on the device; thr = uint32(rate *
// 2^32) (0: no dropout), sc = 1 / (1 - rate). Row r takes the mask words of
// row roff + r: a process holding rows [r0, r1) of the whole batch's N rows
// passes r0. The hidden's row r, column c takes word (roff + r) * mld + mcol
// + c (mld 0: M, mcol 0); res and b2 may be null (no residual, no bias).
int ishara_ffn_fwd(int device, int dtype, const void* x, const void* res,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* seeds, void* out, int N, int K,
                   int M, unsigned int thr1, float sc1, unsigned int thr2,
                   float sc2, long long roff, long long mld, long long mcol,
                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (mld == 0) mld = M;
  if (dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  const Plan p = plan(dtype, K, M);
  if (!shape_ok(p, N, K, M) || !hidden_ok(M, mld, mcol))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.design == WGMMA) {
    switch (K / 64) {
#define FWD_WG(KD)                                                           \
  case KD:                                                                   \
    return (int)fwd_wg<KD>(p, x, res, w1, b1, w2, b2, seeds, out, N, M,      \
                           thr1, sc1, thr2, sc2, roff, mld, mcol, s);
      FWD_WG(1) FWD_WG(2) FWD_WG(3) FWD_WG(4)
#undef FWD_WG
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return (int)fwd_general<float>(x, res, w1, b1, w2, b2, seeds, out, N, K,
                                   M, thr1, sc1, thr2, sc2, roff, mld, mcol,
                                   s);
  return (int)fwd_general<bf16>(x, res, w1, b1, w2, b2, seeds, out, N, K, M,
                                thr1, sc1, thr2, sc2, roff, mld, mcol, s);
}

// dx [N, K] and dw1 [K, M], db1 [M], dw2 [M, K], db2 [K] f32 from x, dy and
// the forward's weights and seeds. Scratch, all given by the caller: d_g,
// dh_g [N, M], g_g [N, K] in the compute type; wt [2, K * M] in the compute
// type for the general design (else unused, may be null); db1_part [parts,
// M] and db2_part [parts, K] f32, parts the plan's N / part_rows (whole
// tiles); db_tmp [parts / 8, max(K, M)] f32 for the wgmma design (else may
// be null); dw1_part and dw2_part [S, K * M] f32, S the number of row splits
// of the weight products. mld and mcol as for the forward.
int ishara_ffn_bwd(int device, int dtype, const void* x, const void* dy,
                   const void* w1, const void* b1, const void* w2,
                   const void* seeds, void* dx, void* d_g, void* dh_g,
                   void* g_g, void* wt, void* db1_part, void* db2_part,
                   void* db_tmp, void* dw1_part, void* dw2_part, void* dw1,
                   void* db1,
                   void* dw2, void* db2, int N, int K, int M, int S,
                   long long parts, unsigned int thr1, float sc1,
                   unsigned int thr2, float sc2, long long roff,
                   long long mld, long long mcol, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (mld == 0) mld = M;
  if (dtype < 0 || dtype > 1 || S < 1) return (int)cudaErrorInvalidValue;
  const Plan p = plan(dtype, K, M);
  if (!shape_ok(p, N, K, M) || !hidden_ok(M, mld, mcol) ||
      parts != parts_of(p, N))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.design == WGMMA) {
    switch (K / 64) {
#define BWD_WG(KD)                                                           \
  case KD:                                                                   \
    e = bwd_wg<KD>(p, x, dy, w1, b1, w2, seeds, dx, d_g, dh_g, g_g,          \
                   (float*)db1_part, (float*)db2_part, N, M, thr1, sc1, thr2, \
                   sc2, roff, mld, mcol, s);                                 \
    break;
      BWD_WG(1) BWD_WG(2) BWD_WG(3) BWD_WG(4)
#undef BWD_WG
      default:
        e = cudaErrorInvalidValue;
    }
  } else if (dtype == 0) {
    e = bwd_general<float>(x, dy, w1, b1, w2, seeds, dx, d_g, dh_g, g_g, wt,
                           (float*)db1_part, (float*)db2_part, N, K, M, thr1,
                           sc1, thr2, sc2, roff, mld, mcol, s);
  } else {
    e = bwd_general<bf16>(x, dy, w1, b1, w2, seeds, dx, d_g, dh_g, g_g, wt,
                          (float*)db1_part, (float*)db2_part, N, K, M, thr1,
                          sc1, thr2, sc2, roff, mld, mcol, s);
  }
  if (e != cudaSuccess) return (int)e;
  e = dtype == 0 ? bwd_weights<float>(x, d_g, dh_g, g_g, (float*)dw1_part,
                                      (float*)dw2_part, N, K, M, S, s)
                 : bwd_weights<bf16>(x, d_g, dh_g, g_g, (float*)dw1_part,
                                     (float*)dw2_part, N, K, M, S, s);
  if (e != cudaSuccess) return (int)e;
  const long long KM = (long long)K * M;
  e = wgrad::sum_parts((const float*)dw1_part, (float*)dw1, S, KM, s);
  if (e != cudaSuccess) return (int)e;
  e = wgrad::sum_parts((const float*)dw2_part, (float*)dw2, S, KM, s);
  if (e != cudaSuccess) return (int)e;
  e = sum_db(p, (const float*)db1_part, (float*)db_tmp, (float*)db1, parts,
             M, s);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_db(p, (const float*)db2_part, (float*)db_tmp, (float*)db2,
                     parts, K, s);
}

// The keep masks the kernels draw for an [n, k] input with hidden width m:
// k1 [n, m] under seeds[0], k2 [n, k] under seeds[1], as 1.0 / 0.0; row r
// takes the words of row roff + r.
int ishara_ffn_masks(int device, const void* seeds, void* k1, void* k2, int n,
                     int m, int k, unsigned int thr1, unsigned int thr2,
                     long long roff, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long n1 = (long long)n * m, n2 = (long long)n * k;
  if (n1 + n2 <= 0) return n1 + n2 == 0 ? 0 : (int)cudaErrorInvalidValue;
  const long long want = (n1 + n2 + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  ffn_masks_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      (const int*)seeds, (float*)k1, (float*)k2, n1, n2, thr1, thr2,
      roff * m, roff * k);
  return (int)cudaGetLastError();
}

const char* ishara_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
