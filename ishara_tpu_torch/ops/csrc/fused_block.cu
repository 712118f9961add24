// Eval-mode encoder block stacks for batch-1 serving on Hopper (sm_90a):
// Squeezeformer, Conformer and Transformer blocks, alone or each behind a few
// Conv1DBlocks (the conv_hybrid / conv_transformer families), at f32, bf16 or
// int8 weight storage, as a sequence of launches or as one persistent kernel.
//
// Replaces the Pallas kernels fused_squeezeformer_stack, fused_conformer_stack
// and fused_conv_group_stack of ishara_tpu/ops/fused_block.py: the
// grid-pipelined _stack_call, its int8 weight mode (_mm's (q, scale) branch)
// and the manually double-buffered _stack_call_dma.
//
// A stack is a list of stages, written once (make_stage) and run two ways.
// Each stage is a grid of independent tiles of one of these device functions:
//
//   gemm_tile_tc    [T,K] @ [K,N] with an optional LayerNorm or per-column
//                   gate (ECA) prologue on A and a scale / bias / swish /
//                   residual epilogue; one 16 x 32 output tile, whose A
//                   panel and B panel are loaded into shared memory at once
//                   and whose K is split over 4 pairs of warps, products by
//                   mma.sync TF32; gemm_tile_any does the same for any
//                   widths in f32 FMA (K in chunks of 1024 where deeper)
//   attention_tile  one (head, 8-query tile); the head's K and V sit in
//                   shared memory, one warp per query row
//   dwconv_tile     depthwise conv over time: causal or 'same', optional GLU
//                   on its input, bias, BN (running stats) and swish
//   se_gate_tile    masked GAP -> SE gate, one tile
//   eca_gate_tile   masked GAP -> k-tap window over channels -> sigmoid
//   apply_tile      x += h * gate
//   layernorm_tile  the Conformer conv module's post-LN, one warp per row
//
// dma = 0 launches every stage as its own kernel, in stream order. dma = 1 is
// the counterpart of the TPU kernel that fetches block i+1's weights itself
// while block i computes: ONE cooperative launch per stack
// (stack_persistent_kernel) walks all stages of all blocks with a grid-wide
// barrier between stages, and at the start of block i every thread issues L2
// prefetches for the weight leaves of block i+1. Both ways call the same
// compiled tile functions (__noinline__), so every output element sees the
// same operations in the same order: dma = 1 equals dma = 0 bit for bit.
// Activations written by one stage and read by the next are never read
// through the read-only (ld.global.nc) path: only weight pointers are
// __restrict__ const. Thread 0 of block 0 of every stage counts it in a
// device int, so the host reads back how many stages a stack really ran.
//
// Any widths, as the reference's whole-array BlockSpecs take: D, F, E and C2
// of any size and any head width D / H. The last row and column tiles of a
// product are masked (zero-filled loads, no stores past the edge); a row that
// is not a whole number of 16-byte chunks (a width not a multiple of 4, or of
// 8 / 16 for bf16 / int8 weight rows) loads in 8- or 4-byte pieces or one
// element at a time, with the same arithmetic; attention pads q and K rows
// with zeros to a multiple of 4; a product deeper than 1024 runs its K in
// chunks. The presets' widths keep the 16-byte forms of the GEMM and
// attention tiles (gemm_tile_tc, attention_tile) and the persistent kernel
// without the general ones. A stage's shared memory is then bounded at any
// width but attention's, which holds a head's K and V for all T: the host
// refuses only a geometry whose stage does not fit a block.
//
// Numerics follow _mm / _mhsa of the reference: activations and accumulation
// are f32; matmul weights arrive at their storage type (f32, bf16 or int8)
// and are widened to f32 at the product; an int8 product is multiplied by its
// per-output-channel scale after the dot and before bias, swish and residual;
// at bf16 and int8 storage the attention q, k, v and the normalised
// probabilities are rounded to bf16 (round to nearest even) before their
// products, which accumulate in f32; a masked key adds -1e30. The matmuls
// of gemm_tile_tc run on the tensor cores without changing that arithmetic
// beyond f32 rounding: bf16 and int8 weights are exact in TF32, and the f32
// activation goes in as a big and a small TF32 part (2xTF32; 3xTF32 with f32
// weights). A bf16 mma would round the activations to bf16, which the
// reference does not do. Attention and the general tile use f32 FMA.
//
// Bound on an H100 SXM at T=176, dim 256, 8 heads: a stack must stream its
// weights once (about 2 MB a block at bf16, 1 MB at int8) and do about
// 0.4 GFLOP a block, so bytes bound it at a few microseconds. Every
// activation of a block (at most 176 x 1024 f32) stays in L2 between stages.
// What bounds the kernels in fact is latency: a block is 11-12 dependent
// stages (4 more for each Conv1DBlock), each a few microseconds of fill and
// drain, one dependent round trip to L2 a stage. Each GEMM tile has all its
// loads in flight at once (cp.async, 16 bytes each), then splits K over 4
// pairs of warps on the tensor cores; tiles are small enough that the
// widest GEMM fills 264 blocks. The persistent form trades the launches for
// grid barriers. A design that cuts a block into 3 / 2 / 1
// / 2 stages (Squeezeformer / Conformer / Transformer / Conv1DBlock) over
// thread-block clusters with tensor-core products measured 2.1-2.2x slower
// than this one on an H100 80GB HBM3 at 700 W: each of its stages became a
// chain of 25-40 dependent round trips of ~1.5-3 us (PERF.md).

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float NEG = -1e30f;
constexpr float LN_EPS = 1e-6f;          // every LayerNorm but one
constexpr float LN_EPS_DEFAULT = 1e-3f;  // Conformer conv module's LN
constexpr float BN_EPS = 1e-3f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ void set_zero(float& v) { v = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& v) {
  v = __ushort_as_bfloat16(0);
}
__device__ __forceinline__ void set_zero(int8_t& v) { v = 0; }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}
__device__ __forceinline__ float swish_f(float v) { return v * sigmoid_f(v); }

// Four consecutive values at their storage type, widened to f32 (exact).
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);  // little-endian pairs
  o[0] = __uint_as_float(u.x << 16);
  o[1] = __uint_as_float(u.x & 0xffff0000u);
  o[2] = __uint_as_float(u.y << 16);
  o[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const int8_t* p, float* o) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  o[0] = (float)v.x;
  o[1] = (float)v.y;
  o[2] = (float)v.z;
  o[3] = (float)v.w;
}

// 16 bytes from global to shared memory without passing through registers;
// with valid false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4 or 8 bytes, for rows that are not whole 16-byte chunks.
template <int BYTES>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src,
                                               bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
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

// Mean and 1/sqrt(var + eps) of one row, two-pass as the reference's _ln;
// called by a whole warp, the result is in every lane.
__device__ __forceinline__ void row_stats(const float* row, int K, float eps,
                                          float* mu, float* rs) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += row[k];
  const float m = warp_sum(s) / K;
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = row[k] - m;
    v += d * d;
  }
  *mu = m;
  *rs = rsqrtf(warp_sum(v) / K + eps);
}

// ---------------------------------------------------------------------------
// One stage of a stack: an operation and its operands. Pointers to
// activations (in, res, mask, gate, out) may have been written by an earlier
// stage of the same launch; the others are weights.
// ---------------------------------------------------------------------------
enum Op {
  OP_GEMM,
  OP_ATTENTION,
  OP_DWCONV,
  OP_SE_GATE,
  OP_ECA_GATE,
  OP_APPLY,
  OP_LAYERNORM
};

struct Stage {
  int op;
  int M, K, N;   // rows T; inner width or taps; output width or channels
  int swish, glu, pad_left, heads;
  float eps, scale;
  const float* in;
  const float* res;
  const float* mask;
  const float* gate;
  float* out;
  const void* w;         // matrix, depthwise kernel, ECA window, SE fc1
  const void* w2;        // SE fc2
  const float* wscale;   // int8 scales of w and w2
  const float* w2scale;
  const float* ln_g;
  const float* ln_b;
  const float* bias;
  const float* bias2;
  const float* bn_g;
  const float* bn_b;
  const float* bn_m;
  const float* bn_v;
  int* count;  // stages run, counted on the device (see note_stage)
  int first;   // the first stage of a stack: resets the count
};

// Block 0's thread 0 of every stage counts it: a stack's count is the number
// of stages that ran on the device. The first stage stores 1, the others add
// 1 with a reduction that returns nothing, so the thread never waits on it.
__device__ __forceinline__ void note_stage(const Stage& st) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && st.count) {
    if (st.first)
      *st.count = 1;
    else
      atomicAdd(st.count, 1);
  }
}

// Threads of every tile function but the SE and ECA gates, which take any
// multiple of 32.
constexpr int GTHREADS = 256;

// ---------------------------------------------------------------------------
// C[M,N] = epilogue(prologue(A)[M,K] @ B[K,N])
//   prologue: LayerNorm of each row of A (gamma ln_g, beta ln_b) if ln_g, or
//             A[m,k] * gate[k] if gate
//   epilogue: * wscale[n] at int8; + bias[n] if bias; swish if swish;
//             res[m,n] + . if res
// res may alias C (each element is read and then written by one thread).
// Any M, K and N: the last row and column tiles are masked (rows past M and
// columns past N load as zeros and are not written), and a K above GKC runs
// in chunks of GKC through the same panels (the sums keep their order).
// Rows that are whole 16-byte chunks (K % 4 == 0 for A, gamma, beta and the
// gate; N % 4 == 0 for the epilogue's vectors) move 16 bytes at a time, the
// others one element at a time; a B row moves in the largest of 16, 8 or 4
// bytes that divides it, else one element at a time. The arithmetic is the
// same either way. The block's GSPLIT groups of 64 threads each take one
// slice [g K / GSPLIT, (g+1) K / GSPLIT) of the products, so that a grid
// of few tiles still keeps enough warps on each SM; in a group, each thread
// owns rows ty, ty+8 and columns 4tx..4tx+3 of the tile and sums its slice
// over k in order. The slices' sums are then added in group order.
// ---------------------------------------------------------------------------
constexpr int GBM = 16, GBN = 32, GSPLIT = 4;
static_assert(GTHREADS == 64 * GSPLIT, "a GEMM tile is GSPLIT groups of 64");

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int gemm_lda(int K) { return round4(K) + 4; }

// The panels hold K in chunks of at most GKC, so that a tile fits a block's
// shared memory at any K: A panel [GBM][lda], LayerNorm gamma and beta (or
// the gate) [round4(KC)] each, the partial sums of groups 1..
// [GSPLIT-1][GBM][GBN], the rows' LayerNorm statistics [2][GBM], B panel
// [KC][GBN], KC = min(K, GKC).
constexpr int GKC = 1024;

// The B panel's row stride in the tensor-core tile: 40 bf16 or f32 values
// put the 4 rows a warp's B fragment reads on distinct banks (f32 keeps 32,
// where 40 would not fit a K of 1024 in a block), int8's 32 bytes already do.
template <typename W>
__host__ __device__ constexpr int gemm_ldb() {
  return sizeof(W) == 2 ? GBN + 8 : GBN;
}

template <typename W>
__host__ __device__ inline size_t gemm_smem_bytes(int K) {
  const int KC = K < GKC ? K : GKC;
  return ((size_t)GBM * gemm_lda(KC) + 2 * (size_t)round4(KC) +
          (size_t)(GSPLIT - 1) * GBM * GBN + 2 * GBM) * sizeof(float) +
         (size_t)KC * gemm_ldb<W>() * sizeof(W);
}

__host__ __device__ inline int gemm_tiles(int M, int N) {
  return ((N + GBN - 1) / GBN) * ((M + GBM - 1) / GBM);
}

// Whether a product takes gemm_tile_tc, the tensor-core form, or
// gemm_tile_any, whose general indexing costs 1-3% where both could run
// (H100 80GB HBM3, 700 W; PERF.md).
__host__ __device__ inline bool gemm_whole(const Stage& st) {
  return st.K <= GKC && st.K % 8 == 0 && st.N % GBN == 0;
}

// Rows k0 .. k0 + kn of B's columns n0 .. n0 + GBN into Bs [kn][GBN],
// columns past N as zeros, BYTES at a time (a B row must be a whole number
// of such pieces, so that each piece is all inside N or all past it).
template <typename W, int BYTES>
__device__ __forceinline__ void load_b_panel(W* Bs, const W* B, int N, int n0,
                                             int kn) {
  constexpr int VEC = BYTES / sizeof(W), PER_ROW = GBN / VEC;
  for (int e = threadIdx.x; e < kn * PER_ROW; e += GTHREADS) {
    const int k = e / PER_ROW, j = (e - k * PER_ROW) * VEC;
    const bool ok = n0 + j < N;
    const W* src = ok ? B + (size_t)k * N + n0 + j : B;
    if (BYTES == 16)
      cp_async16(Bs + k * GBN + j, src, ok);
    else
      cp_async_small<BYTES>(Bs + k * GBN + j, src, ok);
  }
}

// The tensor-core form, for the widths the serving presets use (K <= GKC and
// a multiple of 8, N a multiple of GBN): every load 16 bytes and in flight at
// once, then LayerNorm or the gate on the A panel as gemm_tile_any does, then
// the products by mma.sync m16n8k8 TF32. Warp w takes the K slice w / 2 (of
// GSPLIT, in whole k8 steps) and the 16 columns (w % 2) * 16; slices 1..3 add
// into slice 0 through Part in slice order. A is f32: it goes in as two TF32
// parts, big + small (2xTF32), which carries its f32 value to ~2^-22; bf16
// and int8 weights are exact in TF32, f32 weights are split too (3xTF32).
// The int8 scale, bias, swish and residual follow the sum, as in _mm.
template <typename W>
__device__ __noinline__ void gemm_tile_tc(const Stage& st, int tile) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int M = st.M, K = st.K, N = st.N;
  const float* A = st.in;
  const W* __restrict__ B = static_cast<const W*>(st.w);
  const float* __restrict__ ln_g = st.ln_g;
  const float* __restrict__ ln_b = st.ln_b;
  const float* gate = st.gate;
  constexpr int LDB = gemm_ldb<W>();
  const int lda = gemm_lda(K);  // rows 4 floats apart: distinct banks
  float* As = reinterpret_cast<float*>(dyn_smem);
  float* Gs = As + GBM * lda;
  float* Bt = Gs + K;
  float* Part = Bt + K;
  W* Bs = reinterpret_cast<W*>(Part + (GSPLIT - 1) * GBM * GBN + 2 * GBM);
  const int tid = threadIdx.x;
  const int ntn = N / GBN;
  const int m0 = (tile / ntn) * GBM, n0 = (tile % ntn) * GBN;

  const int k4 = K / 4;
  for (int e = tid; e < GBM * k4; e += GTHREADS) {
    const int i = e / k4, j = (e - i * k4) * 4;
    const bool ok = m0 + i < M;
    cp_async16(As + i * lda + j, ok ? A + (size_t)(m0 + i) * K + j : A, ok);
  }
  if (ln_g) {
    for (int j = 4 * tid; j < K; j += 4 * GTHREADS) {
      cp_async16(Gs + j, ln_g + j, true);
      cp_async16(Bt + j, ln_b + j, true);
    }
  } else if (gate) {
    for (int j = 4 * tid; j < K; j += 4 * GTHREADS)
      cp_async16(Gs + j, gate + j, true);
  }
  constexpr int VEC = 16 / sizeof(W), PER_ROW = GBN / VEC;
  for (int e = tid; e < K * PER_ROW; e += GTHREADS) {
    const int k = e / PER_ROW, j = (e - k * PER_ROW) * VEC;
    cp_async16(Bs + k * LDB + j, B + (size_t)k * N + n0 + j, true);
  }
  cp_async_wait_all();
  __syncthreads();

  if (ln_g) {  // each warp normalises its rows in place
    for (int r = tid / 32; r < GBM && m0 + r < M; r += GTHREADS / 32) {
      float* row = As + r * lda;
      float mu, rs;
      row_stats(row, K, st.eps, &mu, &rs);
      for (int k = tid & 31; k < K; k += 32)
        row[k] = (row[k] - mu) * rs * Gs[k] + Bt[k];
    }
    __syncthreads();
  } else if (gate) {
    for (int e = tid; e < GBM * K; e += GTHREADS) {
      const int i = e / K, k = e - i * K;
      As[i * lda + k] *= Gs[k];
    }
    __syncthreads();
  }

  const int warp = tid / 32, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int sl = warp >> 1, h = warp & 1, k8 = K / 8;
  const int kb = sl * k8 / GSPLIT * 8, ke = (sl + 1) * k8 / GSPLIT * 8;
  const float* a0p = As + g * lda + t;
  const float* a1p = As + (g + 8) * lda + t;
  const W* bp = Bs + t * LDB + h * 16 + g;
  float acc[2][4] = {};
#pragma unroll 2
  for (int k = kb; k < ke; k += 8) {
    const float af[4] = {a0p[k], a1p[k], a0p[k + 4], a1p[k + 4]};
    const tc::SplitA a(af);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float b0 = to_f(bp[k * LDB + j * 8]);
      const float b1 = to_f(bp[(k + 4) * LDB + j * 8]);
      if (std::is_same<W, float>::value) {
        tc::mma_3xtf32(acc[j], a, b0, b1);
      } else {  // exact in TF32
        tc::mma_tf32(acc[j], a.small, __float_as_uint(b0),
                     __float_as_uint(b1));
        tc::mma_tf32(acc[j], a.big, __float_as_uint(b0),
                     __float_as_uint(b1));
      }
    }
  }
  // accumulator element e of n-block j: row g + 8 (e / 2), column
  // h * 16 + j * 8 + 2t + e % 2
  if (sl > 0) {
    float* mine = Part + (sl - 1) * GBM * GBN;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[(g + 8 * (e >> 1)) * GBN + h * 16 + j * 8 + 2 * t + (e & 1)] =
            acc[j][e];
  }
  __syncthreads();
  if (sl == 0) {
#pragma unroll
    for (int q = 0; q < GSPLIT - 1; ++q) {
      const float* p = Part + q * GBM * GBN;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] +=
              p[(g + 8 * (e >> 1)) * GBN + h * 16 + j * 8 + 2 * t + (e & 1)];
    }
    const float* res = st.res;
    float* C = st.out;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + h * 16 + j * 8 + 2 * t;
      float2 bv = make_float2(0.f, 0.f), sv = make_float2(1.f, 1.f);
      if (st.bias) bv = *reinterpret_cast<const float2*>(st.bias + n);
      if (std::is_same<W, int8_t>::value)
        sv = *reinterpret_cast<const float2*>(st.wscale + n);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + g + 8 * r;
        if (m >= M) continue;
        const size_t o = (size_t)m * N + n;
        float v0 = acc[j][2 * r], v1 = acc[j][2 * r + 1];
        if (std::is_same<W, int8_t>::value) {
          v0 *= sv.x;
          v1 *= sv.y;
        }
        v0 += bv.x;
        v1 += bv.y;
        if (st.swish) {
          v0 = swish_f(v0);
          v1 = swish_f(v1);
        }
        if (res) {
          const float2 rv = *reinterpret_cast<const float2*>(res + o);
          v0 = rv.x + v0;
          v1 = rv.y + v1;
        }
        *reinterpret_cast<float2*>(C + o) = make_float2(v0, v1);
      }
    }
  }
  __syncthreads();  // the next tile of a persistent block reuses the panels
}

template <typename W>
__device__ __noinline__ void gemm_tile_any(const Stage& st, int tile) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int M = st.M, K = st.K, N = st.N;
  const float* A = st.in;
  const W* __restrict__ B = static_cast<const W*>(st.w);
  const float* __restrict__ ln_g = st.ln_g;
  const float* __restrict__ ln_b = st.ln_b;
  const float* gate = st.gate;
  // the panels hold K in chunks of GKC where K > GKC, else whole
  const int KC = K < GKC ? K : GKC;
  const bool chunked = K > KC;
  const int lda = gemm_lda(KC);  // rows 4 floats apart: distinct banks
  float* As = reinterpret_cast<float*>(dyn_smem);
  float* Gs = As + GBM * lda;
  float* Bt = Gs + round4(KC);
  float* Part = Bt + round4(KC);
  float* Stats = Part + (GSPLIT - 1) * GBM * GBN;  // [2][GBM]: mean, 1/std
  W* Bs = reinterpret_cast<W*>(Stats + 2 * GBM);
  const int tid = threadIdx.x;
  const int ntn = (N + GBN - 1) / GBN;
  const int m0 = (tile / ntn) * GBM, n0 = (tile % ntn) * GBN;

  // Over chunks, each row's LayerNorm statistics come first, read from
  // global memory in the order row_stats reads a whole row in shared memory.
  if (ln_g && chunked) {
    for (int r = tid / 32; r < GBM && m0 + r < M; r += GTHREADS / 32) {
      float mu, rs;
      row_stats(A + (size_t)(m0 + r) * K, K, st.eps, &mu, &rs);
      if ((tid & 31) == 0) {
        Stats[r] = mu;
        Stats[GBM + r] = rs;
      }
    }
  }

  const int grp = tid / 64, tx = tid % 8, ty = (tid % 64) / 8;
  const int k0 = grp * K / GSPLIT, k1 = (grp + 1) * K / GSPLIT;
  const float* a0p = As + ty * lda;
  const float* a1p = As + (ty + 8) * lda;
  const W* bp = Bs + 4 * tx;
  float acc[2][4] = {};
  for (int c0 = 0; c0 < K; c0 += KC) {
    const int kn = min(KC, K - c0);
    // Every load of the chunk in flight at once, 16 bytes each where the
    // rows are whole 16-byte chunks: the A panel (rows past M as zeros),
    // gamma and beta or the gate, the B panel (columns past N as zeros).
    if ((K & 3) == 0) {
      const int k4 = kn / 4;
      for (int e = tid; e < GBM * k4; e += GTHREADS) {
        const int i = e / k4, j = (e - i * k4) * 4;
        const bool ok = m0 + i < M;
        cp_async16(As + i * lda + j,
                   ok ? A + (size_t)(m0 + i) * K + c0 + j : A, ok);
      }
      if (ln_g) {
        for (int j = 4 * tid; j < kn; j += 4 * GTHREADS) {
          cp_async16(Gs + j, ln_g + c0 + j, true);
          cp_async16(Bt + j, ln_b + c0 + j, true);
        }
      } else if (gate) {
        for (int j = 4 * tid; j < kn; j += 4 * GTHREADS)
          cp_async16(Gs + j, gate + c0 + j, true);
      }
    } else {
      for (int e = tid; e < GBM * kn; e += GTHREADS) {
        const int i = e / kn, j = e - i * kn;
        As[i * lda + j] =
            m0 + i < M ? A[(size_t)(m0 + i) * K + c0 + j] : 0.f;
      }
      for (int j = tid; j < kn; j += GTHREADS) {
        if (ln_g) {
          Gs[j] = ln_g[c0 + j];
          Bt[j] = ln_b[c0 + j];
        } else if (gate) {
          Gs[j] = gate[c0 + j];
        }
      }
    }
    const W* Bc = B + (size_t)c0 * N;
    const int row_bytes = N * (int)sizeof(W);
    if (row_bytes % 16 == 0) {
      load_b_panel<W, 16>(Bs, Bc, N, n0, kn);
    } else if (row_bytes % 8 == 0 && sizeof(W) <= 8) {
      load_b_panel<W, 8>(Bs, Bc, N, n0, kn);
    } else if (row_bytes % 4 == 0 && sizeof(W) <= 4) {
      load_b_panel<W, 4>(Bs, Bc, N, n0, kn);
    } else {
      for (int e = tid; e < kn * GBN; e += GTHREADS) {
        const int k = e / GBN, j = e - k * GBN;
        if (n0 + j < N)
          Bs[e] = Bc[(size_t)k * N + n0 + j];
        else
          set_zero(Bs[e]);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    if (ln_g) {  // each warp normalises its rows in place
      for (int r = tid / 32; r < GBM && m0 + r < M; r += GTHREADS / 32) {
        float* row = As + r * lda;
        float mu, rs;
        if (chunked) {
          mu = Stats[r];
          rs = Stats[GBM + r];
        } else {
          row_stats(row, K, st.eps, &mu, &rs);
        }
        for (int k = tid & 31; k < kn; k += 32)
          row[k] = (row[k] - mu) * rs * Gs[k] + Bt[k];
      }
      __syncthreads();
    } else if (gate) {
      for (int e = tid; e < GBM * kn; e += GTHREADS) {
        const int i = e / kn, k = e - i * kn;
        As[i * lda + k] *= Gs[k];
      }
      __syncthreads();
    }

    // this group's k in [k0, k1) that fall in the chunk, in order
    const int kb = max(k0, c0) - c0, ke = min(k1, c0 + kn) - c0;
#pragma unroll 8
    for (int k = kb; k < ke; ++k) {
      float b[4];
      load4(bp + k * GBN, b);
      const float a0 = a0p[k], a1 = a1p[k];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[0][c] += a0 * b[c];
        acc[1][c] += a1 * b[c];
      }
    }
    if (!chunked) break;  // one pass: the panels hold all of K
    __syncthreads();      // the next chunk reuses the panels
  }
  if (grp > 0) {
    float* mine = Part + (grp - 1) * GBM * GBN;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        mine[(ty + 8 * r) * GBN + 4 * tx + c] = acc[r][c];
  }
  __syncthreads();
  if (grp == 0) {
    for (int g = 0; g < GSPLIT - 1; ++g) {
      const float* p = Part + g * GBM * GBN;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] += p[(ty + 8 * r) * GBN + 4 * tx + c];
    }

    // the epilogue's vectors, res and C 16 bytes at a time where N % 4 == 0
    // (then a thread's 4 columns are all in or all past N), else one
    // element at a time
    const int n = n0 + 4 * tx;
    const bool vec = (N & 3) == 0;
    const int nc = min(4, N - n);  // columns of this thread inside N
    float bv[4] = {0.f, 0.f, 0.f, 0.f};
    float sv[4] = {1.f, 1.f, 1.f, 1.f};
    if (vec && nc > 0) {
      if (st.bias) load4(st.bias + n, bv);
      if (std::is_same<W, int8_t>::value) load4(st.wscale + n, sv);
    } else {
      for (int c = 0; c < nc; ++c) {
        if (st.bias) bv[c] = st.bias[n + c];
        if (std::is_same<W, int8_t>::value) sv[c] = st.wscale[n + c];
      }
    }
    const float* res = st.res;
    float* C = st.out;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + ty + 8 * r;
      if (m >= M || nc <= 0) continue;
      const size_t o = (size_t)m * N + n;
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[c] = acc[r][c];
        if (std::is_same<W, int8_t>::value) v[c] *= sv[c];
        v[c] += bv[c];
        if (st.swish) v[c] = swish_f(v[c]);
      }
      if (vec) {
        if (res) {
          float rv[4];
          load4(res + o, rv);
#pragma unroll
          for (int c = 0; c < 4; ++c) v[c] = rv[c] + v[c];
        }
        *reinterpret_cast<float4*>(C + o) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (int c = 0; c < nc; ++c)
          C[o + c] = res ? res[o + c] + v[c] : v[c];
      }
    }
  }
  __syncthreads();  // the next tile of a persistent block reuses the panels
}

// ---------------------------------------------------------------------------
// Multi-head self-attention over a fused QKV [T, 3*D] whose columns hold, per
// head h, the blocks [q | k | v] of Dh each. out[T, D] holds head h at
// columns h*Dh .. (h+1)*Dh. s = q.k * scale + (1 - mask) * -1e30, softmax by
// max-subtract / exp / divide as the reference does. Any Dh: q and the K
// rows are held round4(Dh) wide with zeros past Dh, so the dot products run
// 4 columns at a time (a zero column adds exactly 0); where Dh % 4 != 0 the
// rows of qkv are not 16-byte aligned and K and V load one value at a time.
// ---------------------------------------------------------------------------
constexpr int AWARPS = GTHREADS / 32, AQ = AWARPS;  // one query row a warp

__host__ __device__ inline size_t attention_smem_floats(int T, int Dh) {
  // K rows padded by 4 floats: lanes reading neighbouring rows as float4
  // fall on distinct banks
  const size_t dp = round4(Dh);
  return (size_t)T * (dp + 4) + (size_t)T * dp + round4(T) +
         (size_t)AWARPS * round4(T) + (size_t)AWARPS * dp;
}

__host__ __device__ inline int attention_tiles(int T, int H) {
  return H * ((T + AQ - 1) / AQ);
}

// The form for heads a multiple of 4 wide (every load 16 bytes, no padded
// columns); attention_tile_any below takes any head width.
template <bool RB>
__device__ __noinline__ void attention_tile(const Stage& st, int tile) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  float* att_sm = reinterpret_cast<float*>(dyn_smem);
  const int T = st.M, D = st.N, H = st.heads;
  const float scale = st.scale;
  const float* qkv = st.in;
  const float* mask = st.mask;
  float* out = st.out;
  const int Dh = D / H, ks = Dh + 4, tp = round4(T);
  float* Ks = att_sm;
  float* Vs = Ks + (size_t)T * ks;
  float* bias = Vs + (size_t)T * Dh;
  float* P = bias + tp;
  float* Q = P + (size_t)AWARPS * tp;
  const int h = tile % H, q0 = (tile / H) * AQ;
  const size_t ld = 3 * (size_t)D;
  const int base = h * 3 * Dh, dh4 = Dh / 4;

#pragma unroll 4
  for (int e = threadIdx.x; e < T * dh4; e += GTHREADS) {
    const int t = e / dh4, d = (e - t * dh4) * 4;
    float4 kv = *reinterpret_cast<const float4*>(qkv + t * ld + base + Dh + d);
    float4 vv =
        *reinterpret_cast<const float4*>(qkv + t * ld + base + 2 * Dh + d);
    if (RB) {
      kv = make_float4(round_bf16(kv.x), round_bf16(kv.y), round_bf16(kv.z),
                       round_bf16(kv.w));
      vv = make_float4(round_bf16(vv.x), round_bf16(vv.y), round_bf16(vv.z),
                       round_bf16(vv.w));
    }
    *reinterpret_cast<float4*>(Ks + t * ks + d) = kv;
    *reinterpret_cast<float4*>(Vs + t * Dh + d) = vv;
  }
  for (int t = threadIdx.x; t < T; t += GTHREADS)
    bias[t] = (1.0f - mask[t]) * NEG;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* p = P + (size_t)warp * tp;
  float* q = Q + (size_t)warp * Dh;
  const int qend = min(q0 + AQ, T);
  for (int qi = q0 + warp; qi < qend; qi += AWARPS) {
    for (int d = lane; d < Dh; d += 32) {
      const float v = qkv[qi * ld + base + d];
      q[d] = RB ? round_bf16(v) : v;
    }
    __syncwarp();
    float mx = -INFINITY;
    for (int j = lane; j < T; j += 32) {
      const float* kr = Ks + j * ks;
      float s = 0.f;
      for (int d = 0; d < Dh; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(q + d);
        const float4 b = *reinterpret_cast<const float4*>(kr + d);
        s += a.x * b.x;
        s += a.y * b.y;
        s += a.z * b.z;
        s += a.w * b.w;
      }
      s = s * scale + bias[j];
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < T; j += 32) {
      const float v = p[j] / sum;
      p[j] = RB ? round_bf16(v) : v;
    }
    __syncwarp();
    for (int d = lane; d < Dh; d += 32) {
      float o = 0.f;
      int j = 0;
      for (; j + 4 <= T; j += 4) {
        const float4 pj = *reinterpret_cast<const float4*>(p + j);
        o += pj.x * Vs[j * Dh + d];
        o += pj.y * Vs[(j + 1) * Dh + d];
        o += pj.z * Vs[(j + 2) * Dh + d];
        o += pj.w * Vs[(j + 3) * Dh + d];
      }
      for (; j < T; ++j) o += p[j] * Vs[j * Dh + d];
      out[(size_t)qi * D + h * Dh + d] = o;
    }
    __syncwarp();
  }
  __syncthreads();
}

template <bool RB>
__device__ __noinline__ void attention_tile_any(const Stage& st, int tile) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  float* att_sm = reinterpret_cast<float*>(dyn_smem);
  const int T = st.M, D = st.N, H = st.heads;
  const float scale = st.scale;
  const float* qkv = st.in;
  const float* mask = st.mask;
  float* out = st.out;
  const int Dh = D / H, dp = round4(Dh), ks = dp + 4, tp = round4(T);
  float* Ks = att_sm;
  float* Vs = Ks + (size_t)T * ks;
  float* bias = Vs + (size_t)T * dp;
  float* P = bias + tp;
  float* Q = P + (size_t)AWARPS * tp;
  const int h = tile % H, q0 = (tile / H) * AQ;
  const size_t ld = 3 * (size_t)D;
  const int base = h * 3 * Dh;

  if ((Dh & 3) == 0) {
    const int dh4 = Dh / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < T * dh4; e += GTHREADS) {
      const int t = e / dh4, d = (e - t * dh4) * 4;
      float4 kv =
          *reinterpret_cast<const float4*>(qkv + t * ld + base + Dh + d);
      float4 vv =
          *reinterpret_cast<const float4*>(qkv + t * ld + base + 2 * Dh + d);
      if (RB) {
        kv = make_float4(round_bf16(kv.x), round_bf16(kv.y), round_bf16(kv.z),
                         round_bf16(kv.w));
        vv = make_float4(round_bf16(vv.x), round_bf16(vv.y), round_bf16(vv.z),
                         round_bf16(vv.w));
      }
      *reinterpret_cast<float4*>(Ks + t * ks + d) = kv;
      *reinterpret_cast<float4*>(Vs + t * dp + d) = vv;
    }
  } else {
    for (int e = threadIdx.x; e < T * dp; e += GTHREADS) {
      const int t = e / dp, d = e - t * dp;
      float kv = 0.f, vv = 0.f;
      if (d < Dh) {
        kv = qkv[t * ld + base + Dh + d];
        vv = qkv[t * ld + base + 2 * Dh + d];
        if (RB) {
          kv = round_bf16(kv);
          vv = round_bf16(vv);
        }
      }
      Ks[t * ks + d] = kv;
      Vs[t * dp + d] = vv;
    }
  }
  for (int t = threadIdx.x; t < T; t += GTHREADS)
    bias[t] = (1.0f - mask[t]) * NEG;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* p = P + (size_t)warp * tp;
  float* q = Q + (size_t)warp * dp;
  if (lane < dp - Dh) q[Dh + lane] = 0.f;  // the zero columns past Dh
  const int qend = min(q0 + AQ, T);
  for (int qi = q0 + warp; qi < qend; qi += AWARPS) {
    for (int d = lane; d < Dh; d += 32) {
      const float v = qkv[qi * ld + base + d];
      q[d] = RB ? round_bf16(v) : v;
    }
    __syncwarp();
    float mx = -INFINITY;
    for (int j = lane; j < T; j += 32) {
      const float* kr = Ks + j * ks;
      float s = 0.f;
      for (int d = 0; d < dp; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(q + d);
        const float4 b = *reinterpret_cast<const float4*>(kr + d);
        s += a.x * b.x;
        s += a.y * b.y;
        s += a.z * b.z;
        s += a.w * b.w;
      }
      s = s * scale + bias[j];
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < T; j += 32) {
      const float v = p[j] / sum;
      p[j] = RB ? round_bf16(v) : v;
    }
    __syncwarp();
    for (int d = lane; d < Dh; d += 32) {
      float o = 0.f;
      int j = 0;
      for (; j + 4 <= T; j += 4) {
        const float4 pj = *reinterpret_cast<const float4*>(p + j);
        o += pj.x * Vs[j * dp + d];
        o += pj.y * Vs[(j + 1) * dp + d];
        o += pj.z * Vs[(j + 2) * dp + d];
        o += pj.w * Vs[(j + 3) * dp + d];
      }
      for (; j < T; ++j) o += p[j] * Vs[j * dp + d];
      out[(size_t)qi * D + h * Dh + d] = o;
    }
    __syncwarp();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Depthwise conv over time, one thread per output element of [T, C]. The
// input row is [C] or, with glu, [2C] whose halves (a, b) give a *
// sigmoid(b). Zero padding of pad_left frames before and Kw-1-pad_left
// after. Then + bias, BN with running stats, swish, each if given.
// Squeezeformer: causal + swish; Conformer: 'same' + GLU + bias + BN;
// Conv1DBlock: causal + BN.
// ---------------------------------------------------------------------------
__host__ __device__ inline int elementwise_tiles(int n) {
  return (n + GTHREADS - 1) / GTHREADS;
}

__device__ __noinline__ void dwconv_tile(const Stage& st, int tile) {
  const int T = st.M, C = st.N, Kw = st.K;
  const int idx = tile * GTHREADS + threadIdx.x;
  if (idx >= T * C) return;
  const float* in = st.in;
  const float* __restrict__ w = static_cast<const float*>(st.w);
  const int t = idx / C, c = idx % C;
  const int ld = st.glu ? 2 * C : C;
  float acc = 0.f;
  for (int i = 0; i < Kw; ++i) {
    const int s = t + i - st.pad_left;
    if (s < 0 || s >= T) continue;
    float u = in[(size_t)s * ld + c];
    if (st.glu) u = u * sigmoid_f(in[(size_t)s * ld + C + c]);
    acc += u * w[i * C + c];
  }
  if (st.bias) acc += st.bias[c];
  if (st.bn_g)
    acc = (acc - st.bn_m[c]) * rsqrtf(st.bn_v[c] + BN_EPS) * st.bn_g[c] +
          st.bn_b[c];
  if (st.swish) acc = swish_f(acc);
  st.out[idx] = acc;
}

// ---------------------------------------------------------------------------
// Masked mean over time of h [T, C] into g [C] (shared memory), denominator
// max(sum mask, 1). The time sum is split over P = gap_parts(C) interleaved
// parts, added in order at the end: the order depends on C alone, not on the
// number of threads. part is [P, C] scratch, den one float. Rows of whole
// 16-byte chunks (C % 4 == 0) are read four channels at a time, the others
// one channel at a time; each channel's sum is the same either way.
// ---------------------------------------------------------------------------
constexpr int GATE_THREADS = 1024;  // of a gate launched on its own

__host__ __device__ inline int gap_parts(int C) {
  // every thread of a gate takes one part of four channels (of one channel
  // where rows are not whole 16-byte chunks)
  const int items = C % 4 == 0 ? C / 4 : C;
  return items < GATE_THREADS ? GATE_THREADS / items : 1;
}

__device__ __forceinline__ void masked_gap(const float* h, const float* mask,
                                           int T, int C, float* part,
                                           float* g, float* den) {
  const int P = gap_parts(C);
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {
    float m = 0.f;
    for (int t = lane; t < T; t += 32) m += mask[t];
    m = warp_sum(m);
    if (lane == 0) *den = fmaxf(m, 1.0f);
  }
  // one thread sums four neighbouring channels of one part, 16 bytes a
  // load: a gate's 1024 threads cover the [P, C] partial sums in one pass
  if ((C & 3) == 0) {
    const int c4 = C / 4;
    for (int e = tid; e < P * c4; e += blockDim.x) {
      const int p = e / c4, c = (e - p * c4) * 4;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int t = p; t < T; t += P) {
        const float4 v =
            *reinterpret_cast<const float4*>(h + (size_t)t * C + c);
        const float m = mask[t];
        s.x += v.x * m;
        s.y += v.y * m;
        s.z += v.z * m;
        s.w += v.w * m;
      }
      *reinterpret_cast<float4*>(part + p * C + c) = s;
    }
  } else {
    for (int e = tid; e < P * C; e += blockDim.x) {
      const int p = e / C, c = e - p * C;
      float s = 0.f;
      for (int t = p; t < T; t += P) s += h[(size_t)t * C + c] * mask[t];
      part[p * C + c] = s;
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += part[p * C + c];
    g[c] = s / *den;
  }
  __syncthreads();
}

// Squeeze-excite gate of the conv-module output h [T, D], one tile:
// gate = sigmoid(swish(gap(h) @ w1 + b1) @ w2 + b2), [D].
__host__ __device__ inline size_t se_gate_smem_bytes(int D, int R) {
  return ((size_t)gap_parts(D) * D + D + R + 4) * sizeof(float);
}

template <typename W>
__device__ __noinline__ void se_gate_tile(const Stage& st) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int T = st.M, D = st.N, R = st.K;
  const W* __restrict__ w1 = static_cast<const W*>(st.w);
  const W* __restrict__ w2 = static_cast<const W*>(st.w2);
  float* part = reinterpret_cast<float*>(dyn_smem);  // [P, D]
  float* g = part + gap_parts(D) * D;                // [D]
  float* r = g + D;                                  // [R]
  float* den = r + R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  masked_gap(st.in, st.mask, T, D, part, g, den);
  for (int j = warp; j < R; j += blockDim.x / 32) {
    float a = 0.f;
    for (int c = lane; c < D; c += 32) a += g[c] * to_f(w1[(size_t)c * R + j]);
    a = warp_sum(a);
    if (std::is_same<W, int8_t>::value) a *= st.wscale[j];
    if (lane == 0) r[j] = swish_f(a + st.bias[j]);
  }
  __syncthreads();
  for (int c = tid; c < D; c += blockDim.x) {
    float a = 0.f;
    for (int j = 0; j < R; ++j) a += r[j] * to_f(w2[(size_t)j * D + c]);
    if (std::is_same<W, int8_t>::value) a *= st.w2scale[c];
    st.out[c] = sigmoid_f(a + st.bias2[c]);
  }
  __syncthreads();
}

// Efficient-channel-attention gate of h [T, C], one tile: the masked mean
// g [C], a K-tap window slid over the CHANNEL axis (cross-correlation, zeros
// (K-1)/2 before and K/2 after), sigmoid. gate [C].
__host__ __device__ inline size_t eca_gate_smem_bytes(int C) {
  return ((size_t)gap_parts(C) * C + C + 4) * sizeof(float);
}

__device__ __noinline__ void eca_gate_tile(const Stage& st) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int T = st.M, C = st.N, Kw = st.K;
  const float* __restrict__ w = static_cast<const float*>(st.w);
  float* part = reinterpret_cast<float*>(dyn_smem);
  float* g = part + gap_parts(C) * C;
  float* den = g + C;
  masked_gap(st.in, st.mask, T, C, part, g, den);
  const int left = (Kw - 1) / 2;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < Kw; ++i) {
      const int s = c + i - left;
      if (s >= 0 && s < C) a += g[s] * w[i];
    }
    st.out[c] = sigmoid_f(a);
  }
  __syncthreads();
}

// out[T, D] += in * gate[D]
__device__ __noinline__ void apply_tile(const Stage& st, int tile) {
  const int idx = tile * GTHREADS + threadIdx.x;
  if (idx >= st.M * st.N) return;
  st.out[idx] = st.out[idx] + st.in[idx] * st.gate[idx % st.N];
}

// LayerNorm of each row of out [T, D], in place; one warp per row.
__host__ __device__ inline int layernorm_tiles(int T) {
  return (T + GTHREADS / 32 - 1) / (GTHREADS / 32);
}

__device__ __noinline__ void layernorm_tile(const Stage& st, int tile) {
  const int row = tile * (GTHREADS / 32) + threadIdx.x / 32;
  if (row >= st.M) return;
  const int D = st.N;
  float* xr = st.out + (size_t)row * D;
  float mu, rs;
  row_stats(xr, D, st.eps, &mu, &rs);
  for (int k = threadIdx.x & 31; k < D; k += 32)
    xr[k] = (xr[k] - mu) * rs * st.ln_g[k] + st.ln_b[k];
}

// ---------------------------------------------------------------------------
// A stage's grid and shared memory, and one kernel for each operation (the
// launch-by-launch form).
// ---------------------------------------------------------------------------
__host__ __device__ inline int stage_tiles(const Stage& st) {
  switch (st.op) {
    case OP_GEMM: return gemm_tiles(st.M, st.N);
    case OP_ATTENTION: return attention_tiles(st.M, st.heads);
    case OP_DWCONV:
    case OP_APPLY: return elementwise_tiles(st.M * st.N);
    case OP_LAYERNORM: return layernorm_tiles(st.M);
    default: return 1;
  }
}

template <typename W>
__host__ __device__ inline size_t stage_smem_bytes(const Stage& st) {
  switch (st.op) {
    case OP_GEMM: return gemm_smem_bytes<W>(st.K);
    case OP_ATTENTION:
      return attention_smem_floats(st.M, st.N / st.heads) * sizeof(float);
    case OP_SE_GATE: return se_gate_smem_bytes(st.N, st.K);
    case OP_ECA_GATE: return eca_gate_smem_bytes(st.N);
    default: return 0;
  }
}

template <typename W, bool WHOLE>
__global__ void __launch_bounds__(GTHREADS)
gemm_kernel(const __grid_constant__ Stage st) {
  note_stage(st);
  if (WHOLE)
    gemm_tile_tc<W>(st, blockIdx.x);
  else
    gemm_tile_any<W>(st, blockIdx.x);
}
template <bool RB, bool QUAD>
__global__ void __launch_bounds__(GTHREADS)
attention_kernel(const __grid_constant__ Stage st) {
  note_stage(st);
  if (QUAD)
    attention_tile<RB>(st, blockIdx.x);
  else
    attention_tile_any<RB>(st, blockIdx.x);
}
__global__ void __launch_bounds__(GTHREADS)
dwconv_kernel(const __grid_constant__ Stage st) {
  note_stage(st);
  dwconv_tile(st, blockIdx.x);
}
template <typename W>
__global__ void __launch_bounds__(GATE_THREADS)
se_gate_kernel(const __grid_constant__ Stage st) {
  note_stage(st);
  se_gate_tile<W>(st);
}
__global__ void __launch_bounds__(GATE_THREADS)
eca_gate_kernel(const __grid_constant__ Stage st) {
  note_stage(st);
  eca_gate_tile(st);
}
__global__ void __launch_bounds__(GTHREADS)
se_apply_kernel(const __grid_constant__ Stage st) {
  note_stage(st);
  apply_tile(st, blockIdx.x);
}
__global__ void __launch_bounds__(GTHREADS)
layernorm_kernel(const __grid_constant__ Stage st) {
  note_stage(st);
  layernorm_tile(st, blockIdx.x);
}

// Dynamic shared memory above the default 48 KB must be allowed first.
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename F>
cudaError_t launch(F* kernel, const Stage& st, int threads, size_t smem,
                   cudaStream_t stream) {
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<stage_tiles(st), threads, smem, stream>>>(st);
  return cudaGetLastError();
}

template <typename W, bool RB>
cudaError_t launch_stage(const Stage& st, cudaStream_t stream) {
  const size_t smem = stage_smem_bytes<W>(st);
  switch (st.op) {
    case OP_GEMM:
      return gemm_whole(st)
                 ? launch(gemm_kernel<W, true>, st, GTHREADS, smem, stream)
                 : launch(gemm_kernel<W, false>, st, GTHREADS, smem, stream);
    case OP_ATTENTION:
      return (st.N / st.heads) % 4 == 0
                 ? launch(attention_kernel<RB, true>, st, GTHREADS, smem,
                          stream)
                 : launch(attention_kernel<RB, false>, st, GTHREADS, smem,
                          stream);
    case OP_DWCONV: return launch(dwconv_kernel, st, GTHREADS, smem, stream);
    case OP_SE_GATE:
      return launch(se_gate_kernel<W>, st, GATE_THREADS, smem, stream);
    case OP_ECA_GATE:
      return launch(eca_gate_kernel, st, GATE_THREADS, smem, stream);
    case OP_APPLY: return launch(se_apply_kernel, st, GTHREADS, smem, stream);
    case OP_LAYERNORM:
      return launch(layernorm_kernel, st, GTHREADS, smem, stream);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The stages of a stack. A stack is nblocks groups; a group is nconv
// Conv1DBlocks (4 stages each) and one inner block of kind 0 Squeezeformer
// (12 stages), 1 Conformer (11) or 2 Transformer (5). Leaves are stacked on
// a leading group axis: leaf i of group g is leaf[i] + g * stride[i]; the
// first 10 * nconv are the Conv1DBlocks' (leaf order of _conv1d_args), the
// rest the inner block's (_squeeze_args / _conformer_args /
// _transformer_args). sleaf[i] is the int8 scale of matrix leaf i, or null.
// ---------------------------------------------------------------------------
constexpr int MAX_LEAVES = 72, MAX_CONV = 4, CONV_LEAVES = 10, CONV_STAGES = 4;

struct StackParams {
  int kind, nconv, nblocks, nleaves;
  int T, D, H, F, E, Kw, R, C2;
  int conv_k[MAX_CONV], eca_k[MAX_CONV];
  float scale;
  const float* x;
  const float* mask;
  float* out;
  float *qkv, *hid, *hid2, *att, *hb, *gate;  // scratch
  int* count;  // stages run (device), or null
  const char* leaf[MAX_LEAVES];
  long long stride[MAX_LEAVES];
  const char* sleaf[MAX_LEAVES];
  long long sstride[MAX_LEAVES];
};

__host__ __device__ inline int inner_leaves(int kind) {
  return kind == 0 ? 27 : kind == 1 ? 26 : 8;
}
__host__ __device__ inline int inner_stages(int kind) {
  return kind == 0 ? 12 : kind == 1 ? 11 : 5;
}
__host__ __device__ inline int group_stages(const StackParams& P) {
  return P.nconv * CONV_STAGES + inner_stages(P.kind);
}

// The leaves of one group, counted from base.
struct Leaves {
  const StackParams& P;
  int base, grp;
  __host__ __device__ const void* w(int i) const {
    return P.leaf[base + i] + (size_t)grp * P.stride[base + i];
  }
  __host__ __device__ const float* f(int i) const {
    return static_cast<const float*>(w(i));
  }
  __host__ __device__ const float* s(int i) const {  // int8 scale or null
    const char* p = P.sleaf[base + i];
    return p ? reinterpret_cast<const float*>(
                   p + (size_t)grp * P.sstride[base + i])
             : nullptr;
  }
};

// out[M,N] = epilogue(LN(in) @ leaf wi), see gemm_tile_tc.
__host__ __device__ inline Stage gemm_stage(const Leaves& L, const float* in,
                                            int M, int K, int ln_g, int ln_b,
                                            int wi, int N, int bias, int swish,
                                            const float* res, float* out) {
  Stage st{};
  st.op = OP_GEMM;
  st.in = in;
  st.M = M;
  st.K = K;
  st.N = N;
  if (ln_g >= 0) {
    st.ln_g = L.f(ln_g);
    st.ln_b = L.f(ln_b);
    st.eps = LN_EPS;
  }
  st.w = L.w(wi);
  st.wscale = L.s(wi);
  if (bias >= 0) st.bias = L.f(bias);
  st.swish = swish;
  st.res = res;
  st.out = out;
  return st;
}

__host__ __device__ inline Stage attention_stage(const StackParams& P) {
  Stage st{};
  st.op = OP_ATTENTION;
  st.in = P.qkv;
  st.mask = P.mask;
  st.out = P.att;
  st.M = P.T;
  st.N = P.D;
  st.heads = P.H;
  st.scale = P.scale;
  return st;
}

__host__ __device__ inline Stage dwconv_stage(const float* in, int glu,
                                              const float* w, int Kw,
                                              int pad_left, float* out, int T,
                                              int C, int swish) {
  Stage st{};
  st.op = OP_DWCONV;
  st.in = in;
  st.glu = glu;
  st.w = w;
  st.K = Kw;
  st.pad_left = pad_left;
  st.out = out;
  st.M = T;
  st.N = C;
  st.swish = swish;
  return st;
}

// Stage s of Conv1DBlock j of group grp: expand (swish) -> causal depthwise
// conv + BN -> ECA gate -> project of the gated rows + skip.
__host__ __device__ inline Stage conv_stage(const StackParams& P, int grp,
                                            int j, int s) {
  const Leaves L{P, j * CONV_LEAVES, grp};
  const float* cur = (grp == 0 && j == 0) ? P.x : P.out;
  const int T = P.T, D = P.D, C = P.C2, Kc = P.conv_k[j];
  switch (s) {
    case 0: return gemm_stage(L, cur, T, D, -1, -1, 0, C, 1, 1, nullptr, P.hid);
    case 1: {
      Stage st = dwconv_stage(P.hid, 0, L.f(2), Kc, Kc - 1, P.hid2, T, C, 0);
      st.bn_g = L.f(3);
      st.bn_b = L.f(4);
      st.bn_m = L.f(5);
      st.bn_v = L.f(6);
      return st;
    }
    case 2: {
      Stage st{};
      st.op = OP_ECA_GATE;
      st.in = P.hid2;
      st.mask = P.mask;
      st.w = L.w(7);
      st.K = P.eca_k[j];
      st.out = P.gate;
      st.M = T;
      st.N = C;
      return st;
    }
    default: {
      Stage st = gemm_stage(L, P.hid2, T, C, -1, -1, 8, D, 9, 0, cur, P.out);
      st.gate = P.gate;
      return st;
    }
  }
}

// Stage s of the inner block of group grp.
__host__ __device__ inline Stage inner_stage(const StackParams& P, int grp,
                                             int s) {
  const Leaves L{P, P.nconv * CONV_LEAVES, grp};
  const float* cur = (grp == 0 && P.nconv == 0) ? P.x : P.out;
  float* out = P.out;
  const int T = P.T, D = P.D, F = P.F, E = P.E, Kw = P.Kw;
  if (P.kind == 0) {  // Squeezeformer, leaf order of _squeeze_args
    switch (s) {
      // FFN1: x + W2 swish(W1 LN(x) + b1) + b2
      case 0: return gemm_stage(L, cur, T, D, 0, 1, 2, F, 3, 1, nullptr, P.hid);
      case 1: return gemm_stage(L, P.hid, T, F, -1, -1, 4, D, 5, 0, cur, out);
      // MHSA: x + proj(attention(qkv(LN(x))))
      case 2:
        return gemm_stage(L, out, T, D, 6, 7, 8, 3 * D, -1, 0, nullptr, P.qkv);
      case 3: return attention_stage(P);
      case 4: return gemm_stage(L, P.att, T, D, -1, -1, 9, D, -1, 0, out, out);
      // Conv module: LN -> pw1 swish -> causal dw swish -> pw2 -> SE -> +x
      case 5:
        return gemm_stage(L, out, T, D, 10, 11, 12, E, 13, 1, nullptr, P.hid);
      case 6:
        return dwconv_stage(P.hid, 0, L.f(14), Kw, Kw - 1, P.hid2, T, E, 1);
      case 7:
        return gemm_stage(L, P.hid2, T, E, -1, -1, 15, D, 16, 0, nullptr,
                          P.hb);
      case 8: {
        Stage st{};
        st.op = OP_SE_GATE;
        st.in = P.hb;
        st.mask = P.mask;
        st.w = L.w(17);
        st.wscale = L.s(17);
        st.bias = L.f(18);
        st.w2 = L.w(19);
        st.w2scale = L.s(19);
        st.bias2 = L.f(20);
        st.out = P.gate;
        st.M = T;
        st.N = D;
        st.K = P.R;
        return st;
      }
      case 9: {
        Stage st{};
        st.op = OP_APPLY;
        st.in = P.hb;
        st.gate = P.gate;
        st.out = out;
        st.M = T;
        st.N = D;
        return st;
      }
      // FFN2
      case 10:
        return gemm_stage(L, out, T, D, 21, 22, 23, F, 24, 1, nullptr, P.hid);
      default: return gemm_stage(L, P.hid, T, F, -1, -1, 25, D, 26, 0, out, out);
    }
  }
  if (P.kind == 1) {  // Conformer, leaf order of _conformer_args
    switch (s) {
      // FFN1 and MHSA share ln1
      case 0: return gemm_stage(L, cur, T, D, 0, 1, 2, F, 3, 1, nullptr, P.hid);
      case 1: return gemm_stage(L, P.hid, T, F, -1, -1, 4, D, 5, 0, cur, out);
      case 2:
        return gemm_stage(L, out, T, D, 0, 1, 6, 3 * D, -1, 0, nullptr, P.qkv);
      case 3: return attention_stage(P);
      case 4: return gemm_stage(L, P.att, T, D, -1, -1, 7, D, -1, 0, out, out);
      // Conv module: pw1 -> GLU -> 'same' dw + bias -> BN -> pw2 -> LN(h + x)
      case 5:
        return gemm_stage(L, out, T, D, -1, -1, 8, 2 * D, 9, 0, nullptr, P.hid);
      case 6: {
        Stage st = dwconv_stage(P.hid, 1, L.f(10), Kw, (Kw - 1) / 2, P.hid2, T,
                                D, 0);
        st.bias = L.f(11);
        st.bn_g = L.f(12);
        st.bn_b = L.f(13);
        st.bn_m = L.f(14);
        st.bn_v = L.f(15);
        return st;
      }
      case 7:
        return gemm_stage(L, P.hid2, T, D, -1, -1, 16, D, 17, 0, out, out);
      case 8: {
        Stage st{};
        st.op = OP_LAYERNORM;
        st.out = out;
        st.ln_g = L.f(18);
        st.ln_b = L.f(19);
        st.eps = LN_EPS_DEFAULT;
        st.M = T;
        st.N = D;
        return st;
      }
      // FFN2
      case 9:
        return gemm_stage(L, out, T, D, 20, 21, 22, F, 23, 1, nullptr, P.hid);
      default: return gemm_stage(L, P.hid, T, F, -1, -1, 24, D, 25, 0, out, out);
    }
  }
  switch (s) {  // Transformer, leaf order of _transformer_args
    // pre-LN MHSA
    case 0:
      return gemm_stage(L, cur, T, D, 0, 1, 2, 3 * D, -1, 0, nullptr, P.qkv);
    case 1: return attention_stage(P);
    case 2: return gemm_stage(L, P.att, T, D, -1, -1, 3, D, -1, 0, cur, out);
    // pre-LN swish FFN, no biases
    case 3: return gemm_stage(L, out, T, D, 4, 5, 6, F, -1, 1, nullptr, P.hid);
    default: return gemm_stage(L, P.hid, T, F, -1, -1, 7, D, -1, 0, out, out);
  }
}

__host__ __device__ inline Stage make_stage(const StackParams& P, int grp,
                                            int s) {
  const int nc = P.nconv * CONV_STAGES;
  Stage st = s < nc ? conv_stage(P, grp, s / CONV_STAGES, s % CONV_STAGES)
                    : inner_stage(P, grp, s - nc);
  st.count = P.count;
  st.first = grp == 0 && s == 0;
  return st;
}

// ---------------------------------------------------------------------------
// The persistent form: one cooperative launch walks every stage of every
// group, all blocks taking tiles of the current stage in turn and meeting at
// a grid-wide barrier before the next. At the start of group g each thread
// asks L2 for its share of the lines of group g+1's weights (and, at g = 0,
// of group 0's), so that their stream from device memory overlaps group g's
// compute, as the TPU kernel's second buffer does.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void prefetch_group(const StackParams& P, int grp) {
  if (grp >= P.nblocks) return;
  const size_t first =
      ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 128;
  const size_t step = (size_t)gridDim.x * blockDim.x * 128;
  for (int i = 0; i < P.nleaves; ++i) {
    const char* w = P.leaf[i] + (size_t)grp * P.stride[i];
    for (size_t o = first; o < (size_t)P.stride[i]; o += step)
      prefetch_l2(w + o);
    if (P.sleaf[i]) {
      const char* s = P.sleaf[i] + (size_t)grp * P.sstride[i];
      for (size_t o = first; o < (size_t)P.sstride[i]; o += step)
        prefetch_l2(s + o);
    }
  }
}

// ANY: some product or head width needs the general tiles (gemm_tile_any,
// attention_tile_any); a stack at whole widths runs a kernel without them.
template <typename W, bool RB, bool ANY>
__global__ void __launch_bounds__(GTHREADS)
stack_persistent_kernel(const __grid_constant__ StackParams P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Stage st;
  const int nst = group_stages(P);
  for (int grp = 0; grp < P.nblocks; ++grp) {
    if (grp == 0) prefetch_group(P, 0);
    prefetch_group(P, grp + 1);
    for (int s = 0; s < nst; ++s) {
      if (threadIdx.x == 0) {
        st = make_stage(P, grp, s);
        note_stage(st);
      }
      __syncthreads();
      const int nt = stage_tiles(st);
      for (int t = blockIdx.x; t < nt; t += gridDim.x) {
        switch (st.op) {
          case OP_GEMM:
            if (!ANY || gemm_whole(st))
              gemm_tile_tc<W>(st, t);
            else
              gemm_tile_any<W>(st, t);
            break;
          case OP_ATTENTION:
            if (!ANY || (st.N / st.heads) % 4 == 0)
              attention_tile<RB>(st, t);
            else
              attention_tile_any<RB>(st, t);
            break;
          case OP_DWCONV: dwconv_tile(st, t); break;
          case OP_SE_GATE: se_gate_tile<W>(st); break;
          case OP_ECA_GATE: eca_gate_tile(st); break;
          case OP_APPLY: apply_tile(st, t); break;
          case OP_LAYERNORM: layernorm_tile(st, t); break;
        }
      }
      // the stage's writes are visible to every block after the barrier
      if (grp + 1 < P.nblocks || s + 1 < nst) grid.sync();
    }
  }
}

#define TRY(call)                               \
  do {                                          \
    const cudaError_t e_ = (call);              \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

// info, if given, receives {stages issued, launches, the largest dynamic
// shared memory of a stage in bytes, grid blocks and blocks an SM holds of
// the persistent launch (0 and 0 for one launch a stage)}.
template <typename W, bool RB>
int run_stack(const StackParams& P, int persistent, int* info,
              cudaStream_t stream) {
  const int nst = group_stages(P);
  size_t smem = 0;
  int tiles = 1;
  bool any = false;
  for (int s = 0; s < nst; ++s) {
    const Stage st = make_stage(P, 0, s);
    const size_t b = stage_smem_bytes<W>(st);
    smem = b > smem ? b : smem;
    any = any || (st.op == OP_GEMM && !gemm_whole(st)) ||
          (st.op == OP_ATTENTION && (st.N / st.heads) % 4);
    // the GEMM and attention stages size the grid: their tiles are long,
    // while a block walks several elementwise tiles at little cost and
    // every block more makes each barrier slower
    const int t = (st.op == OP_GEMM || st.op == OP_ATTENTION)
                      ? stage_tiles(st) : 1;
    tiles = t > tiles ? t : tiles;
  }
  if (info) {
    info[0] = P.nblocks * nst;
    info[1] = persistent ? 1 : P.nblocks * nst;
    info[2] = (int)smem;
    info[3] = info[4] = 0;
  }
  if (!persistent) {
    for (int grp = 0; grp < P.nblocks; ++grp)
      for (int s = 0; s < nst; ++s)
        TRY((launch_stage<W, RB>(make_stage(P, grp, s), stream)));
    return 0;
  }
  auto* kernel = any ? stack_persistent_kernel<W, RB, true>
                     : stack_persistent_kernel<W, RB, false>;
  // The grid may not exceed what is resident at once, or the barrier never
  // completes: size it from the occupancy at this shared-memory size.
  int device = 0, sms = 0, per_sm = 0, cooperative = 0;
  TRY(cudaGetDevice(&device));
  TRY(cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch,
                             device));
  if (!cooperative) return (int)cudaErrorNotSupported;
  TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem));
  TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, GTHREADS,
                                                    smem));
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int blocks = tiles < per_sm * sms ? tiles : per_sm * sms;
  void* args[] = {const_cast<StackParams*>(&P)};
  TRY(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                  dim3(blocks), dim3(GTHREADS), args, smem,
                                  stream));
  if (info) {
    info[3] = blocks;
    info[4] = per_sm;
  }
  return 0;
}

}  // namespace

extern "C" {

// N groups of (nconv Conv1DBlocks, one inner block of kind 0 Squeezeformer /
// 1 Conformer / 2 Transformer) on x [T, D] f32 into out [T, D]; mask [T] f32
// of 1/0. leaves / strides: the stacked leaves (see StackParams) and their
// bytes from one group to the next; scales / scale_strides: for each leaf its
// int8 scale leaf or null. conv_k, eca_k [nconv]: the Conv1DBlocks' depthwise
// and ECA kernel sizes. storage: 0 f32, 1 bf16, 2 int8 matrices. persistent:
// 0 one launch a stage, 1 one cooperative launch for the stack. Scratch:
// qkv [T, 3D]; hid, hid2 [T, max(F, E, 2D, C2)]; att, hb [T, D];
// gate [max(D, C2)]. Every leaf and scratch pointer 16-byte aligned; any
// widths, D a multiple of H. count: one int on the device that receives the
// stages the stack ran, counted by the stages themselves; info: see
// run_stack. A stage whose shared memory exceeds a block's fails its launch.
// Returns a cudaError_t (0 on success).
int ishara_block_stack(int device, int kind, int nconv, const int* conv_k,
                       const int* eca_k, const float* x, const float* mask,
                       float* out, void* const* leaves,
                       const long long* strides, void* const* scales,
                       const long long* scale_strides, int nleaves,
                       int nblocks, int T, int D, int H, int F, int E, int Kw,
                       int R, int C2, float scale, int storage, int persistent,
                       float* qkv, float* hid, float* hid2, float* att,
                       float* hb, float* gate, int* count, void* stream,
                       int* info) {
  if (kind < 0 || kind > 2 || nconv < 0 || nconv > MAX_CONV ||
      nleaves != nconv * CONV_LEAVES + inner_leaves(kind) ||
      nleaves > MAX_LEAVES || nblocks < 1 || storage < 0 || storage > 2 ||
      T < 1 || D < 1 || H < 1 || D % H)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  StackParams P{};
  P.kind = kind;
  P.nconv = nconv;
  P.nblocks = nblocks;
  P.nleaves = nleaves;
  P.T = T;
  P.D = D;
  P.H = H;
  P.F = F;
  P.E = E;
  P.Kw = Kw;
  P.R = R;
  P.C2 = C2;
  for (int j = 0; j < nconv; ++j) {
    P.conv_k[j] = conv_k[j];
    P.eca_k[j] = eca_k[j];
  }
  P.scale = scale;
  P.x = x;
  P.mask = mask;
  P.out = out;
  P.qkv = qkv;
  P.hid = hid;
  P.hid2 = hid2;
  P.att = att;
  P.hb = hb;
  P.gate = gate;
  P.count = count;
  for (int i = 0; i < nleaves; ++i) {
    P.leaf[i] = static_cast<const char*>(leaves[i]);
    P.stride[i] = strides[i];
    P.sleaf[i] = static_cast<const char*>(scales[i]);
    P.sstride[i] = scale_strides[i];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (storage == 2) return run_stack<int8_t, true>(P, persistent, info, st);
  if (storage == 1)
    return run_stack<__nv_bfloat16, true>(P, persistent, info, st);
  return run_stack<float, false>(P, persistent, info, st);
}

const char* ishara_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
