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
// Two sets of kernels. bf16 at widths that are multiples of 128 -- every
// preset's training geometry -- takes the tensor cores (mma.sync m16n8k16);
// f32, and bf16 at any other width or where shared memory is short, takes
// the general kernels further down, the same three steps with the row
// products as f32 FMAs on the CUDA cores (the weight products take
// wgrad.cuh's kernels by its own rule).
//
// Design of the tensor-core set. A block of 8 warps owns 64 rows (a warp a
// 32 x 32 patch of each 64 x 128 product tile). Forward: the x tile and
// then the 64 x M hidden stay in shared memory between the two products;
// the weights stream as [64][128] k-tiles through a 3-stage cp.async ring,
// one pipeline over the W1 tiles of every hidden chunk and then the W2 tiles
// of every output chunk, so each weight byte read from L2 serves 64 rows;
// the epilogues work on the accumulator registers: bias, swish, the Philox
// keep words (one block of 4 words a (row, 4 columns), computed by one lane
// of a pair and traded by a shuffle, as attention_tc.cuh does for K3) and
// the residual. Backward, three steps: (1) a row kernel of the same
// structure recomputes h = x . w1 and dd = g . w2^T chunk by chunk in one
// pipeline (a double-buffered stage holds a W1 k-tile and a W2^T tile), so
// neither is held at f32 for the whole row tile; it writes dx = dh . w1^T, and leaves bf16
// d = a * keep1', dh and g in global scratch with fixed-order column sums
// for db1 and db2, one partial row for each 32 rows; (2) the weight products
// of wgrad.cuh form dw2 = d^T . g and dw1 = x^T . dh as split sums over row
// ranges; (3) the partial sums are added in a fixed order. No atomics: every
// gradient is the same from run to run. Launches: 1 forward; 1 + 2 + 4
// backward.
//
// Bound: operations (12 N K M for forward and backward together, 71 GFLOP
// at N 45056, K 256, M 512, against 115 MB of x, res, dy, out, dx); the
// backward's scratch (d, dh and g in bf16, ~115 MB written and read once)
// is what the split into a row kernel and weight products costs.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include "mma.cuh"
#include "philox.cuh"
#include "wgrad.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int R = 64;      // rows a block owns
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;     // bf16 elements of padding per shared-memory row
constexpr int NCH = 128;   // columns of a product tile
constexpr int KT = 64;     // depth of a streamed weight tile
constexpr int KN_LD = NCH + PAD;   // a [KT][NCH] tile's row stride
constexpr int NK_LD = KT + PAD;    // a [NCH][KT] tile's row stride
constexpr int KN_TILE = KT * KN_LD, NK_TILE = NCH * NK_LD;
// Pipeline stages (64-deep tiles with a stage fewer ran 10-15% faster than
// 32-deep ones on the H100).
constexpr int FWD_STAGES = 3, BWD_STAGES = 2;

// keep' for the accumulator elements of rows r and r + 8, columns c, c + 1
// (c = ... + 2t, so c and c + 1 share a Philox block): flat index row * ld
// + col0 + column, ld % 4 == col0 % 4 == 0. Lane t & 1 == 0 computes the
// block of row r, its partner that of row r + 8; each sends the two words the
// other needs.
// All 1 when threshold is 0 (no dropout).
__device__ __forceinline__ void keep_pair(uint32_t seed, uint64_t r, int c,
                                          uint64_t ld, uint64_t col0,
                                          uint32_t threshold, float scale,
                                          float kp[4]) {
  if (threshold == 0u) {
    kp[0] = kp[1] = kp[2] = kp[3] = 1.f;
    return;
  }
  const int odd = threadIdx.x & 1;  // t & 1, t = lane % 4
  const uint64_t idx = (r + (odd ? 8 : 0)) * ld + col0 + (uint64_t)(c & ~3);
  const uint4 w = philox::block(seed, idx >> 2);
  const uint32_t s0 = odd ? w.x : w.z, s1 = odd ? w.y : w.w;
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  const uint32_t k[4] = {odd ? r0 : w.x, odd ? r1 : w.y, odd ? w.z : r0,
                         odd ? w.w : r1};
#pragma unroll
  for (int e = 0; e < 4; ++e) kp[e] = k[e] >= threshold ? scale : 0.f;
}

// The fast exponential and division (within a few ulp of f32), as in
// conv_module.cu: with the IEEE forms the epilogue's swish costs about as
// much as the products.
__device__ __forceinline__ float sigmoid(float h) {
  return __fdividef(1.f, 1.f + __expf(-h));
}

// rows [row0, row0 + R) of src [.., K] -> dst [R][K + PAD], by cp.async.
__device__ __forceinline__ void load_rows(const bf16* src, bf16* dst, int row0,
                                          int K) {
  tc::load_tile<bf16>(dst, K + PAD, src + (size_t)row0 * K, K, R, K, R, K,
                      true, threadIdx.x, THREADS);
}

// Forward. Shared memory: xs [R][K + PAD] | hs [R][M + PAD] | ring
// [STAGES][KT][KN_LD], all bf16. Pipeline step i < n1 = (M / NCH) (K / KT):
// W1 tile (k-tile i % (K / KT), hidden chunk i / (K / KT)); then step n1 + i
// is W2 tile (k-tile i % (M / KT), output chunk i / (M / KT)).
__global__ void __launch_bounds__(THREADS)
ffn_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
               const bf16* __restrict__ w1, const float* __restrict__ b1,
               const bf16* __restrict__ w2, const float* __restrict__ b2,
               const int* __restrict__ seeds, bf16* __restrict__ out, int K,
               int M, uint32_t thr1, float sc1, uint32_t thr2, float sc2,
               long long roff, long long mld, long long mcol) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldx = K + PAD, ldh = M + PAD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // rows 32 wm.., columns 32 wn..
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* hs = xs + R * ldx;
  bf16* ring = hs + R * ldh;
  const int row0 = blockIdx.x * R;
  const uint32_t seed1 = (uint32_t)seeds[0], seed2 = (uint32_t)seeds[1];
  const int kt1 = K / KT, kt2 = M / KT;
  const int n1 = (M / NCH) * kt1, n = n1 + (K / NCH) * kt2;

  auto issue = [&](int i) {
    bf16* dst = ring + (i % FWD_STAGES) * KN_TILE;
    if (i < n1)
      tc::load_tile<bf16>(dst, KN_LD, w1 + (size_t)(i % kt1) * KT * M +
                          (i / kt1) * NCH, M, KT, NCH, KT, NCH, true,
                          threadIdx.x, THREADS);
    else
      tc::load_tile<bf16>(dst, KN_LD, w2 + (size_t)((i - n1) % kt2) * KT * K
                          + ((i - n1) / kt2) * NCH, K, KT, NCH, KT, NCH,
                          true, threadIdx.x, THREADS);
  };
  load_rows(x, xs, row0, K);
#pragma unroll
  for (int i = 0; i < FWD_STAGES - 1; ++i) {
    if (i < n) issue(i);
    tc::cp_async_commit();
  }
  float acc[2][4][4];
  tc::zero_acc(acc);
  for (int i = 0; i < n; ++i) {
    tc::cp_async_wait<FWD_STAGES - 2>();
    __syncthreads();
    if (i + FWD_STAGES - 1 < n) issue(i + FWD_STAGES - 1);
    tc::cp_async_commit();
    const bf16* Bt = ring + (i % FWD_STAGES) * KN_TILE + wn * 32;
    const bool first = i < n1;
    const int kt = first ? i % kt1 : (i - n1) % kt2;
    const bf16* A = (first ? xs + wm * 32 * ldx : hs + wm * 32 * ldh) +
                    kt * KT;
    tc::warp_mma<2, 4, false, true>(acc, A, first ? ldx : ldh, 16, Bt, KN_LD,
                                    KT);
    if (kt + 1 < (first ? kt1 : kt2)) continue;
    // the chunk is done: epilogue on the accumulators
    const int col0 = (first ? i / kt1 : (i - n1) / kt2) * NCH + wn * 32;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = wm * 32 + a * 16 + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + j * 8 + 2 * t;
        float kp[4];
        if (first) {
          keep_pair(seed1, (uint64_t)(roff + row0 + r), c, mld, mcol, thr1,
                    sc1, kp);
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float h = acc[a][j][e] + b1[c + (e & 1)];
            v[e] = __fmul_rn(__fmul_rn(h, sigmoid(h)), kp[e]);
          }
          *reinterpret_cast<uint32_t*>(hs + r * ldh + c) =
              tc::pack_bf16(v[0], v[1]);
          *reinterpret_cast<uint32_t*>(hs + (r + 8) * ldh + c) =
              tc::pack_bf16(v[2], v[3]);
        } else {
          keep_pair(seed2, (uint64_t)(roff + row0 + r), c, K, 0, thr2, sc2,
                    kp);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const size_t at = (size_t)(row0 + r + 8 * h) * K + c;
            const __nv_bfloat162 rv =
                res ? *reinterpret_cast<const __nv_bfloat162*>(res + at)
                    : __floats2bfloat162_rn(0.f, 0.f);
            const float y0 = acc[a][j][2 * h] + (b2 ? b2[c] : 0.f);
            const float y1 = acc[a][j][2 * h + 1] + (b2 ? b2[c + 1] : 0.f);
            *reinterpret_cast<uint32_t*>(out + at) = tc::pack_bf16(
                __fadd_rn(__low2float(rv), __fmul_rn(y0, kp[2 * h])),
                __fadd_rn(__high2float(rv), __fmul_rn(y1, kp[2 * h + 1])));
          }
        }
      }
    }
    tc::zero_acc(acc);
  }
}

// Backward, step 1. Shared memory: xs [R][K + PAD] | gs [R][K + PAD] | dhs
// [R][M + PAD] | ring [STAGES][KN_TILE + NK_TILE], all bf16. Pipeline step
// i < n1 = (M / NCH) (K / KT): the W1 tile [KT][NCH] (k-tile i % (K / KT),
// hidden chunk i / (K / KT)) and the W2^T tile [NCH][KT] (W2's rows of that
// chunk, columns of that k-tile); then step n1 + i is the W1^T tile
// [NCH][KT] (W1's rows of output chunk i / (M / KT), columns of k-tile
// i % (M / KT)).
__global__ void __launch_bounds__(THREADS)
ffn_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                    const bf16* __restrict__ w1, const float* __restrict__ b1,
                    const bf16* __restrict__ w2, const int* __restrict__ seeds,
                    bf16* __restrict__ dx, bf16* __restrict__ d_g,
                    bf16* __restrict__ dh_g, bf16* __restrict__ g_g,
                    float* __restrict__ db1_part, float* __restrict__ db2_part,
                    int K, int M, uint32_t thr1, float sc1, uint32_t thr2,
                    float sc2, long long roff, long long mld,
                    long long mcol) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldx = K + PAD, ldh = M + PAD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = xs + R * ldx;
  bf16* dhs = gs + R * ldx;
  bf16* ring = dhs + R * ldh;
  float* red = reinterpret_cast<float*>(ring);  // [4][K], the prologue only
  const int row0 = blockIdx.x * R;
  const uint32_t seed1 = (uint32_t)seeds[0], seed2 = (uint32_t)seeds[1];
  const int kt1 = K / KT, kt2 = M / KT;
  const int n1 = (M / NCH) * kt1, n = n1 + (K / NCH) * kt2;
  constexpr int STAGE = KN_TILE + NK_TILE;

  // g = dy * keep2' (f32, rounded to gs and g_g): a thread owns 4 columns
  // of 16 rows; the column sums over each 32 rows (db2) in a fixed order
  for (int q = threadIdx.x; q < (K / 4) * 4; q += THREADS) {
    const int c = (q % (K / 4)) * 4, rg = q / (K / 4);
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int lr = rg * 16; lr < rg * 16 + 16; ++lr) {
      const size_t at = (size_t)(row0 + lr) * K + c;
      float kp[4] = {1.f, 1.f, 1.f, 1.f};
      if (thr2)
        philox::keep4(seed2, (uint64_t)(at + (size_t)roff * K), thr2, sc2,
                      kp);
      const uint2 raw = *reinterpret_cast<const uint2*>(dy + at);
      const bf16* dv = reinterpret_cast<const bf16*>(&raw);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = __fmul_rn(__bfloat162float(dv[e]), kp[e]);
        sum[e] += v[e];
      }
      const uint2 packed = make_uint2(tc::pack_bf16(v[0], v[1]),
                                      tc::pack_bf16(v[2], v[3]));
      *reinterpret_cast<uint2*>(gs + lr * ldx + c) = packed;
      *reinterpret_cast<uint2*>(g_g + at) = packed;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) red[rg * K + c + e] = sum[e];
  }
  load_rows(x, xs, row0, K);
  __syncthreads();
  for (int c = threadIdx.x; c < K; c += THREADS) {
    db2_part[(size_t)(2 * blockIdx.x) * K + c] = red[c] + red[K + c];
    db2_part[(size_t)(2 * blockIdx.x + 1) * K + c] =
        red[2 * K + c] + red[3 * K + c];
  }
  __syncthreads();  // red lives in the ring

  auto issue = [&](int i) {
    bf16* dst = ring + (i % BWD_STAGES) * STAGE;
    if (i < n1) {
      const int kt = i % kt1, ch = i / kt1;
      tc::load_tile<bf16>(dst, KN_LD, w1 + (size_t)kt * KT * M + ch * NCH, M,
                          KT, NCH, KT, NCH, true, threadIdx.x, THREADS);
      tc::load_tile<bf16>(dst + KN_TILE, NK_LD,
                          w2 + (size_t)ch * NCH * K + kt * KT, K, NCH, KT,
                          NCH, KT, true, threadIdx.x, THREADS);
    } else {
      const int kt = (i - n1) % kt2, ch = (i - n1) / kt2;
      tc::load_tile<bf16>(dst, NK_LD, w1 + (size_t)ch * NCH * M + kt * KT, M,
                          NCH, KT, NCH, KT, true, threadIdx.x, THREADS);
    }
  };
#pragma unroll
  for (int i = 0; i < BWD_STAGES - 1; ++i) {
    if (i < n) issue(i);
    tc::cp_async_commit();
  }
  float acc_h[2][4][4], acc_d[2][4][4];
  tc::zero_acc(acc_h);
  tc::zero_acc(acc_d);
  for (int i = 0; i < n; ++i) {
    tc::cp_async_wait<BWD_STAGES - 2>();
    __syncthreads();
    if (i + BWD_STAGES - 1 < n) issue(i + BWD_STAGES - 1);
    tc::cp_async_commit();
    const bf16* st = ring + (i % BWD_STAGES) * STAGE;
    if (i >= n1) {
      // dx = dh . w1^T
      const int kt = (i - n1) % kt2;
      tc::warp_mma<2, 4, false, false>(acc_h, dhs + wm * 32 * ldh + kt * KT,
                                       ldh, 16, st + wn * 32 * NK_LD, NK_LD,
                                       KT);
      if (kt + 1 < kt2) continue;
      const int col0 = ((i - n1) / kt2) * NCH + wn * 32;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const size_t at =
                (size_t)(row0 + wm * 32 + a * 16 + g + 8 * h) * K + col0 +
                j * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(dx + at) = tc::pack_bf16(
                acc_h[a][j][2 * h], acc_h[a][j][2 * h + 1]);
          }
      tc::zero_acc(acc_h);
      continue;
    }
    // h = x . w1 and dd = g . w2^T for one hidden chunk
    const int kt = i % kt1;
    tc::warp_mma<2, 4, false, true>(acc_h, xs + wm * 32 * ldx + kt * KT, ldx,
                                    16, st + wn * 32, KN_LD, KT);
    tc::warp_mma<2, 4, false, false>(acc_d, gs + wm * 32 * ldx + kt * KT,
                                     ldx, 16, st + KN_TILE + wn * 32 * NK_LD,
                                     NK_LD, KT);
    if (kt + 1 < kt1) continue;
    const int col0 = (i / kt1) * NCH + wn * 32;
    float colsum[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) colsum[j][0] = colsum[j][1] = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = wm * 32 + a * 16 + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + j * 8 + 2 * t;
        float kp[4], d[4], dh[4];
        keep_pair(seed1, (uint64_t)(roff + row0 + r), c, mld, mcol, thr1, sc1,
                  kp);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float h = acc_h[a][j][e] + b1[c + (e & 1)];
          const float sig = sigmoid(h);
          const float hsw = __fmul_rn(h, sig);
          d[e] = __fmul_rn(hsw, kp[e]);
          const float da = __fmul_rn(acc_d[a][j][e], kp[e]);
          dh[e] = da * (sig + hsw * (1.f - sig));
          colsum[j][e & 1] += dh[e];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t at = (size_t)(row0 + r + 8 * h) * M + c;
          *reinterpret_cast<uint32_t*>(d_g + at) =
              tc::pack_bf16(d[2 * h], d[2 * h + 1]);
          const uint32_t dhp = tc::pack_bf16(dh[2 * h], dh[2 * h + 1]);
          *reinterpret_cast<uint32_t*>(dh_g + at) = dhp;
          *reinterpret_cast<uint32_t*>(dhs + (r + 8 * h) * ldh + c) = dhp;
        }
      }
    }
    // the warp's 32 rows of db1: lanes of one t summed over g in a fixed
    // order; one partial row for each (block, wm)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = colsum[j][e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (g == 0)
          db1_part[(size_t)(2 * blockIdx.x + wm) * M + col0 + j * 8 + 2 * t +
                   e] = v;
      }
    tc::zero_acc(acc_h);
    tc::zero_acc(acc_d);
  }
}

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
// The general kernels: compute type T = float or bf16, any widths. The same
// three backward steps and the same rounding points as above; the products
// are f32 FMAs. A block owns GR rows, which it holds widened to f32 in shared
// memory; a thread owns a column of the result for all GR rows, so that every
// weight it reads (coalesced across the block) is used GR times. The
// backward reads w2 and w1 through transposed copies (made by
// ffn_transpose_kernel into scratch) so that those reads coalesce as well.
// ---------------------------------------------------------------------------

constexpr int GR = 8;

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

size_t fwd_smem(int K, int M) {
  return (size_t)R * (K + PAD) * 2 + (size_t)R * (M + PAD) * 2 +
         (size_t)FWD_STAGES * KN_TILE * 2;
}

size_t bwd_smem(int K, int M) {
  return 2 * (size_t)R * (K + PAD) * 2 + (size_t)R * (M + PAD) * 2 +
         (size_t)BWD_STAGES * (KN_TILE + NK_TILE) * 2;
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

bool shape_ok(int N, int K, int M) {
  return N > 0 && N % R == 0 && K > 0 && M > 0;
}

// A slice [mcol, mcol + M) of a hidden of mld; a slice (not the whole
// hidden) starts and ends on a Philox block of 4 columns, as the tensor
// cores' keep words come.
bool hidden_ok(int M, long long mld, long long mcol) {
  if (mld == M) return mcol == 0;
  return mcol >= 0 && mcol + M <= mld && mld % 4 == 0 && mcol % 4 == 0;
}

// bf16 at widths that are multiples of 128 takes the tensor-core kernels.
bool tensor_cores(int dtype, int K, int M) {
  return dtype == 1 && K % 128 == 0 && M % 128 == 0 &&
         bwd_smem(K, M) <= SMEM_LIMIT;
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

}  // namespace

extern "C" {

// out [N, K] = res + drop2(drop1(swish(x . w1 + b1)) . w2 + b2). dtype 0 =
// f32, 1 = bf16 (x, res, w1, w2, out). N must be a multiple of 64. seeds
// points at two int32 on the device; thr = uint32(rate * 2^32) (0: no
// dropout), sc = 1 / (1 - rate). Row r takes the mask words of row roff + r:
// a process holding rows [r0, r1) of the whole batch's N rows passes r0. The
// hidden's row r, column c takes word (roff + r) * mld + mcol + c (mld 0: M,
// mcol 0); res and b2 may be null (no residual, no bias).
int ishara_ffn_fwd(int device, int dtype, const void* x, const void* res,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* seeds, void* out, int N, int K,
                   int M, unsigned int thr1, float sc1, unsigned int thr2,
                   float sc2, long long roff, long long mld, long long mcol,
                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (mld == 0) mld = M;
  if (!shape_ok(N, K, M) || !hidden_ok(M, mld, mcol) || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tensor_cores(dtype, K, M)) {
    if (dtype == 0)
      return (int)fwd_general<float>(x, res, w1, b1, w2, b2, seeds, out, N, K,
                                     M, thr1, sc1, thr2, sc2, roff, mld,
                                     mcol, s);
    return (int)fwd_general<bf16>(x, res, w1, b1, w2, b2, seeds, out, N, K, M,
                                  thr1, sc1, thr2, sc2, roff, mld, mcol, s);
  }
  const size_t smem = fwd_smem(K, M);
  e = allow_smem(ffn_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  ffn_fwd_kernel<<<N / R, THREADS, smem, s>>>(
      (const bf16*)x, (const bf16*)res, (const bf16*)w1, (const float*)b1,
      (const bf16*)w2, (const float*)b2, (const int*)seeds, (bf16*)out, K, M,
      thr1, sc1, thr2, sc2, roff, mld, mcol);
  return (int)cudaGetLastError();
}

// Rows that one partial row of the backward's step 1 sums over at this type
// and these widths: the number of rows of db1_part and db2_part is N over
// this.
int ishara_ffn_bwd_rows(int dtype, int K, int M) {
  return tensor_cores(dtype, K, M) ? R / 2 : GR;
}

// dx [N, K] and dw1 [K, M], db1 [M], dw2 [M, K], db2 [K] f32 from x, dy and
// the forward's weights and seeds. Scratch, all given by the caller: d_g,
// dh_g [N, M], g_g [N, K] and wt [2, K * M] in the compute type; db1_part
// [N / rows, M] and db2_part [N / rows, K] f32, rows = ishara_ffn_bwd_rows;
// dw1_part and dw2_part [S, K * M] f32, S the number of row splits of the
// weight products. mld and mcol as for the forward.
int ishara_ffn_bwd(int device, int dtype, const void* x, const void* dy,
                   const void* w1, const void* b1, const void* w2,
                   const void* seeds, void* dx, void* d_g, void* dh_g,
                   void* g_g, void* wt, void* db1_part, void* db2_part,
                   void* dw1_part, void* dw2_part, void* dw1, void* db1,
                   void* dw2, void* db2, int N, int K, int M, int S,
                   unsigned int thr1, float sc1, unsigned int thr2, float sc2,
                   long long roff, long long mld, long long mcol,
                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (mld == 0) mld = M;
  if (!shape_ok(N, K, M) || !hidden_ok(M, mld, mcol) || S < 1 || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = ishara_ffn_bwd_rows(dtype, K, M);
  if (!tensor_cores(dtype, K, M)) {
    if (dtype == 0)
      e = bwd_general<float>(x, dy, w1, b1, w2, seeds, dx, d_g, dh_g, g_g, wt,
                             (float*)db1_part, (float*)db2_part, N, K, M, thr1,
                             sc1, thr2, sc2, roff, mld, mcol, s);
    else
      e = bwd_general<bf16>(x, dy, w1, b1, w2, seeds, dx, d_g, dh_g, g_g, wt,
                            (float*)db1_part, (float*)db2_part, N, K, M, thr1,
                            sc1, thr2, sc2, roff, mld, mcol, s);
  } else {
    const size_t smem = bwd_smem(K, M);
    e = allow_smem(ffn_bwd_rows_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    ffn_bwd_rows_kernel<<<N / R, THREADS, smem, s>>>(
        (const bf16*)x, (const bf16*)dy, (const bf16*)w1, (const float*)b1,
        (const bf16*)w2, (const int*)seeds, (bf16*)dx, (bf16*)d_g,
        (bf16*)dh_g, (bf16*)g_g, (float*)db1_part, (float*)db2_part, K, M,
        thr1, sc1, thr2, sc2, roff, mld, mcol);
    e = cudaGetLastError();
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
  e = wgrad::sum_parts((const float*)db1_part, (float*)db1, N / rows, M, s);
  if (e != cudaSuccess) return (int)e;
  return (int)wgrad::sum_parts((const float*)db2_part, (float*)db2, N / rows,
                               K, s);
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
