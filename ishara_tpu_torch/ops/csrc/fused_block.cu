// Eval-mode Squeezeformer and Conformer block stacks for batch-1 serving on
// Hopper (sm_90a).
//
// Replaces the Pallas kernels fused_squeezeformer_stack and
// fused_conformer_stack of ishara_tpu/ops/fused_block.py (both grid-pipelined
// through _stack_call). The host entries below run N blocks of one type; each
// block launches, in turn, a few kernels of this file:
//
//   gemm_kernel       [T,K] @ [K,N] with an optional LayerNorm prologue on the
//                     rows of A and a bias / swish / residual epilogue; one
//                     16 x 32 output tile per block, whose whole A panel and
//                     B panel are loaded into shared memory at once and
//                     whose K is split over 4 warp groups
//   attention_kernel  one (head, 8-query tile) per block; the head's K and V
//                     sit in shared memory, one warp per query row
//   dwconv_kernel     depthwise conv over time: causal (Squeezeformer, swish
//                     epilogue) or 'same' with bias, GLU on its input and a BN
//                     epilogue (Conformer)
//   se_gate_kernel    masked GAP -> SE gate, one block
//   se_apply_kernel   x += h * gate
//   layernorm_kernel  the Conformer conv module's post-LN, one warp per row
//
// Numerics follow _mm / _mhsa of the reference: activations and accumulation
// are f32; matmul weights arrive at their storage type (bf16 or f32) and are
// widened to f32 at the product; at bf16 storage the attention q, k, v and
// the normalised probabilities are rounded to bf16 (round to nearest even)
// before their products, which accumulate in f32; a masked key adds -1e30.
// The products run on the CUDA cores in f32 FMA, not on the tensor cores: the
// bf16 mma instructions would need the activations in bf16 too, which the
// reference does not do.
//
// Bound on an H100 SXM at T=176, dim 256, 8 heads, 4 blocks: the stack must
// stream its matmul weights once (about 8.4-9.1 MB at bf16, 2.5-2.7 us at
// 3.35 TB/s) and do about 1.5-1.6 GFLOP (1.6 us at the bf16 tensor-core rate,
// 24 us at the 67 TFLOP/s f32 rate these f32 FMAs run at). Every activation
// of a block (at most 176 x 768 f32, 540 KB) stays in L2 between launches.
// What the design does about latency, which bounds it at this size: each GEMM
// block has all its loads in flight at once (cp.async, 16 bytes each, one
// memory latency per launch, not one per K step), splits K over 4 groups of
// 2 warps and does 8 FMAs for 3 shared-memory loads; tiles are small enough that the widest
// GEMM fills 264 blocks. The ~12 dependent launches per block remain; wgmma,
// TMA and a single persistent launch per stack are the levers for a later
// change.

#include <cmath>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float NEG = -1e30f;
constexpr float LN_EPS = 1e-6f;          // every LayerNorm but one
constexpr float LN_EPS_DEFAULT = 1e-3f;  // Conformer conv module's LN
constexpr float BN_EPS = 1e-3f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
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

// 16 bytes from global to shared memory without passing through registers;
// with valid false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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
// C[M,N] = epilogue(prologue(A)[M,K] @ B[K,N])
//   prologue: LayerNorm of each row of A (gamma ln_g, beta ln_b) if ln_g
//   epilogue: + bias[n] if bias; swish if swish; res[m,n] + . if res
// res may alias C (each element is read and then written by one thread).
// Needs K % (4 * GSPLIT) == 0, N % GBN == 0 and 16-byte aligned rows
// (checked by the host entries). The block's GSPLIT groups of 64 threads
// each take one K / GSPLIT slice of the products, so that a grid of few
// tiles still keeps enough warps on each SM; in a group, each thread owns
// rows ty, ty+8 and columns 4tx..4tx+3 of the tile and sums its slice over
// k in order. The slices' sums are then added in group order.
// ---------------------------------------------------------------------------
constexpr int GBM = 16, GBN = 32, GSPLIT = 4, GTHREADS = 64 * GSPLIT;

__host__ __device__ inline int gemm_lda(int K) { return K + 4; }

// A panel [GBM][lda], LayerNorm gamma and beta [K] each, the partial sums
// of groups 1.. [GSPLIT-1][GBM][GBN], B panel [K][GBN].
template <typename W>
__host__ __device__ inline size_t gemm_smem_bytes(int K) {
  return ((size_t)GBM * gemm_lda(K) + 2 * (size_t)K +
          (size_t)(GSPLIT - 1) * GBM * GBN) * sizeof(float) +
         (size_t)K * GBN * sizeof(W);
}

template <typename W>
__global__ void __launch_bounds__(GTHREADS)
gemm_kernel(const float* __restrict__ A, int M, int K,
            const float* __restrict__ ln_g, const float* __restrict__ ln_b,
            float ln_eps, const W* __restrict__ B, int N,
            const float* __restrict__ bias, int swish, const float* res,
            float* C) {
  extern __shared__ __align__(16) unsigned char gsm[];
  const int lda = gemm_lda(K);  // rows 4 floats apart: distinct banks
  float* As = reinterpret_cast<float*>(gsm);
  float* Gs = As + GBM * lda;
  float* Bt = Gs + K;
  float* Part = Bt + K;
  W* Bs = reinterpret_cast<W*>(Part + (GSPLIT - 1) * GBM * GBN);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;

  // Every load of the block in flight at once, 16 bytes each: the A panel
  // (rows past M as zeros), gamma and beta, the B panel.
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
  }
  constexpr int VEC = 16 / sizeof(W), PER_ROW = GBN / VEC;
  for (int e = tid; e < K * PER_ROW; e += GTHREADS) {
    const int k = e / PER_ROW, j = (e - k * PER_ROW) * VEC;
    cp_async16(Bs + k * GBN + j, B + (size_t)k * N + n0 + j, true);
  }
  cp_async_wait_all();
  __syncthreads();

  if (ln_g) {  // each warp normalises its rows in place
    for (int r = tid / 32; r < GBM && m0 + r < M; r += GTHREADS / 32) {
      float* row = As + r * lda;
      float mu, rs;
      row_stats(row, K, ln_eps, &mu, &rs);
      for (int k = tid & 31; k < K; k += 32)
        row[k] = (row[k] - mu) * rs * Gs[k] + Bt[k];
    }
    __syncthreads();
  }

  const int grp = tid / 64, tx = tid % 8, ty = (tid % 64) / 8;
  const int kc = K / GSPLIT, k0 = grp * kc;
  const float* a0p = As + ty * lda;
  const float* a1p = As + (ty + 8) * lda;
  const W* bp = Bs + 4 * tx;
  float acc[2][4] = {};
#pragma unroll 8
  for (int k = k0; k < k0 + kc; ++k) {
    float b[4];
    load4(bp + k * GBN, b);
    const float a0 = a0p[k], a1 = a1p[k];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[0][c] += a0 * b[c];
      acc[1][c] += a1 * b[c];
    }
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
  if (grp > 0) return;
  for (int g = 0; g < GSPLIT - 1; ++g) {
    const float* p = Part + g * GBM * GBN;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] += p[(ty + 8 * r) * GBN + 4 * tx + c];
  }

  const int n = n0 + 4 * tx;
  float bv[4] = {0.f, 0.f, 0.f, 0.f};
  if (bias) load4(bias + n, bv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + ty + 8 * r;
    if (m >= M) continue;
    const size_t o = (size_t)m * N + n;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[c] = acc[r][c] + bv[c];
      if (swish) v[c] = swish_f(v[c]);
    }
    if (res) {
      float rv[4];
      load4(res + o, rv);
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = rv[c] + v[c];
    }
    *reinterpret_cast<float4*>(C + o) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// ---------------------------------------------------------------------------
// Multi-head self-attention over a fused QKV [T, 3*D] whose columns hold, per
// head h, the blocks [q | k | v] of Dh each. out[T, D] holds head h at
// columns h*Dh .. (h+1)*Dh. s = q.k * scale + (1 - mask) * -1e30, softmax by
// max-subtract / exp / divide as the reference does. Needs Dh % 4 == 0.
// ---------------------------------------------------------------------------
constexpr int AQ = 8, ATHREADS = 128, AWARPS = ATHREADS / 32;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline size_t attention_smem_floats(int T, int Dh) {
  // K rows padded by 4 floats: lanes reading neighbouring rows as float4
  // fall on distinct banks
  return (size_t)T * (Dh + 4) + (size_t)T * Dh + round4(T) +
         (size_t)AWARPS * round4(T) + (size_t)AWARPS * Dh;
}

template <bool RB>
__global__ void __launch_bounds__(ATHREADS)
attention_kernel(const float* __restrict__ qkv,
                 const float* __restrict__ mask, float* __restrict__ out,
                 int T, int D, int H, float scale) {
  extern __shared__ __align__(16) float att_sm[];
  const int Dh = D / H, ks = Dh + 4, tp = round4(T);
  float* Ks = att_sm;
  float* Vs = Ks + (size_t)T * ks;
  float* bias = Vs + (size_t)T * Dh;
  float* P = bias + tp;
  float* Q = P + (size_t)AWARPS * tp;
  const int h = blockIdx.x, q0 = blockIdx.y * AQ;
  const size_t ld = 3 * (size_t)D;
  const int base = h * 3 * Dh, dh4 = Dh / 4;

#pragma unroll 4
  for (int e = threadIdx.x; e < T * dh4; e += ATHREADS) {
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
  for (int t = threadIdx.x; t < T; t += ATHREADS)
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
}

// ---------------------------------------------------------------------------
// Depthwise conv over time, one thread per output element. The input row is
// [C] or, with glu, [2C] whose halves (a, b) give a * sigmoid(b). Zero padding
// of pad_left frames before and Kw-1-pad_left after. Then + bias, BN with
// running stats, swish, each if given.
// ---------------------------------------------------------------------------
__global__ void dwconv_kernel(const float* __restrict__ in, int glu,
                              const float* __restrict__ w, int Kw, int pad_left,
                              const float* __restrict__ bias,
                              const float* __restrict__ bn_g,
                              const float* __restrict__ bn_b,
                              const float* __restrict__ bn_m,
                              const float* __restrict__ bn_v, int swish,
                              float* __restrict__ out, int T, int C) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= T * C) return;
  const int t = idx / C, c = idx % C;
  const int ld = glu ? 2 * C : C;
  float acc = 0.f;
  for (int i = 0; i < Kw; ++i) {
    const int s = t + i - pad_left;
    if (s < 0 || s >= T) continue;
    float u = in[(size_t)s * ld + c];
    if (glu) u = u * sigmoid_f(in[(size_t)s * ld + C + c]);
    acc += u * w[i * C + c];
  }
  if (bias) acc += bias[c];
  if (bn_g) acc = (acc - bn_m[c]) * rsqrtf(bn_v[c] + BN_EPS) * bn_g[c] + bn_b[c];
  if (swish) acc = swish_f(acc);
  out[idx] = acc;
}

// ---------------------------------------------------------------------------
// Squeeze-excite gate of the conv-module output h [T, D], one block:
// g = masked mean of h over time (denominator max(sum mask, 1)),
// gate = sigmoid(swish(g @ w1 + b1) @ w2 + b2). The time sum is split over
// P = blockDim / D interleaved parts, added at the end.
// ---------------------------------------------------------------------------
constexpr int SE_THREADS = 1024;

__host__ __device__ inline int se_parts(int D) {
  return D < SE_THREADS ? SE_THREADS / D : 1;
}

template <typename W>
__global__ void __launch_bounds__(SE_THREADS)
se_gate_kernel(const float* __restrict__ h, const float* __restrict__ mask,
               const W* __restrict__ w1, const float* __restrict__ b1,
               const W* __restrict__ w2, const float* __restrict__ b2,
               float* __restrict__ gate, int T, int D, int R) {
  extern __shared__ __align__(16) float se_sm[];
  const int P = se_parts(D);
  float* part = se_sm;        // [P, D]
  float* g = part + P * D;  // [D]
  float* r = g + D;         // [R]
  __shared__ float s_den;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  if (warp == 0) {
    float m = 0.f;
    for (int t = lane; t < T; t += 32) m += mask[t];
    m = warp_sum(m);
    if (lane == 0) s_den = fmaxf(m, 1.0f);
  }
  for (int e = tid; e < P * D; e += blockDim.x) {
    const int p = e / D, c = e - p * D;
    float s = 0.f;
#pragma unroll 4
    for (int t = p; t < T; t += P) s += h[(size_t)t * D + c] * mask[t];
    part[e] = s;
  }
  __syncthreads();
  for (int c = tid; c < D; c += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += part[p * D + c];
    g[c] = s / s_den;
  }
  __syncthreads();
  for (int j = warp; j < R; j += blockDim.x / 32) {
    float a = 0.f;
    for (int c = lane; c < D; c += 32) a += g[c] * to_f(w1[(size_t)c * R + j]);
    a = warp_sum(a);
    if (lane == 0) r[j] = swish_f(a + b1[j]);
  }
  __syncthreads();
  for (int c = tid; c < D; c += blockDim.x) {
    float a = 0.f;
    for (int j = 0; j < R; ++j) a += r[j] * to_f(w2[(size_t)j * D + c]);
    gate[c] = sigmoid_f(a + b2[c]);
  }
}

// x[T, D] += h * gate[D]
__global__ void se_apply_kernel(float* __restrict__ x,
                                const float* __restrict__ h,
                                const float* __restrict__ gate, int T, int D) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= T * D) return;
  x[idx] = x[idx] + h[idx] * gate[idx % D];
}

// LayerNorm of each row of x [T, D], in place; one warp per row.
__global__ void layernorm_kernel(float* x, const float* __restrict__ g,
                                 const float* __restrict__ b, float eps, int T,
                                 int D) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= T) return;
  float* xr = x + (size_t)row * D;
  float mu, rs;
  row_stats(xr, D, eps, &mu, &rs);
  for (int k = threadIdx.x & 31; k < D; k += 32)
    xr[k] = (xr[k] - mu) * rs * g[k] + b[k];
}

// ---------------------------------------------------------------------------
// Host-side launchers. Each returns the launch's cudaGetLastError().
// ---------------------------------------------------------------------------

// Dynamic shared memory above the default 48 KB must be allowed first.
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename W>
cudaError_t gemm(cudaStream_t st, const float* A, int M, int K,
                 const float* ln_g, const float* ln_b, float ln_eps,
                 const W* B, int N, const float* bias, int swish,
                 const float* res, float* C) {
  if (K % (4 * GSPLIT) || N % GBN) return cudaErrorInvalidValue;
  const size_t bytes = gemm_smem_bytes<W>(K);
  const cudaError_t e = allow_smem(gemm_kernel<W>, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(N / GBN, (M + GBM - 1) / GBM);
  gemm_kernel<W><<<grid, GTHREADS, bytes, st>>>(A, M, K, ln_g, ln_b, ln_eps,
                                                B, N, bias, swish, res, C);
  return cudaGetLastError();
}

template <bool RB>
cudaError_t attention(cudaStream_t st, const float* qkv, const float* mask,
                      float* out, int T, int D, int H, float scale) {
  if (D % H || (D / H) % 4) return cudaErrorInvalidValue;
  const size_t bytes = attention_smem_floats(T, D / H) * sizeof(float);
  const cudaError_t e = allow_smem(attention_kernel<RB>, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, (T + AQ - 1) / AQ);
  attention_kernel<RB><<<grid, ATHREADS, bytes, st>>>(qkv, mask, out, T, D, H,
                                                      scale);
  return cudaGetLastError();
}

cudaError_t dwconv(cudaStream_t st, const float* in, int glu, const float* w,
                   int Kw, int pad_left, const float* bias, const float* bn_g,
                   const float* bn_b, const float* bn_m, const float* bn_v,
                   int swish, float* out, int T, int C) {
  const int threads = 256, blocks = (T * C + threads - 1) / threads;
  dwconv_kernel<<<blocks, threads, 0, st>>>(in, glu, w, Kw, pad_left, bias,
                                            bn_g, bn_b, bn_m, bn_v, swish, out,
                                            T, C);
  return cudaGetLastError();
}

// x += h * SE-gate(h); gate is [D] scratch.
template <typename W>
cudaError_t squeeze_excite(cudaStream_t st, const float* h, const float* mask,
                           const W* w1, const float* b1, const W* w2,
                           const float* b2, float* gate, float* x, int T,
                           int D, int R) {
  const size_t bytes = ((size_t)se_parts(D) * D + D + R) * sizeof(float);
  cudaError_t e = allow_smem(se_gate_kernel<W>, bytes);
  if (e != cudaSuccess) return e;
  se_gate_kernel<W><<<1, SE_THREADS, bytes, st>>>(h, mask, w1, b1, w2, b2,
                                                  gate, T, D, R);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int threads = 256, blocks = (T * D + threads - 1) / threads;
  se_apply_kernel<<<blocks, threads, 0, st>>>(x, h, gate, T, D);
  return cudaGetLastError();
}

cudaError_t layernorm(cudaStream_t st, float* x, const float* g,
                      const float* b, float eps, int T, int D) {
  const int warps = 8;
  layernorm_kernel<<<(T + warps - 1) / warps, 32 * warps, 0, st>>>(x, g, b, eps,
                                                                   T, D);
  return cudaGetLastError();
}

// The i-th leaf of block blk: leaves are stacked on a leading block axis.
struct Leaves {
  void* const* ptr;
  const long long* stride;  // bytes from one block to the next
  int blk;
  template <typename P>
  const P* at(int i) const {
    return reinterpret_cast<const P*>(static_cast<const char*>(ptr[i]) +
                                      (size_t)blk * stride[i]);
  }
  const float* f(int i) const { return at<float>(i); }
};

#define TRY(call)                               \
  do {                                          \
    const cudaError_t e_ = (call);              \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

// Leaf order of _squeeze_args in the reference.
template <typename W, bool RB>
int squeeze_stack(const float* x, const float* mask, float* out,
                  void* const* leaves, const long long* strides, int nblocks,
                  int T, int D, int H, int F, int E, int Kw, int R, float scale,
                  float* qkv, float* hid, float* hid2, float* att, float* hb,
                  float* gate, cudaStream_t st) {
  for (int blk = 0; blk < nblocks; ++blk) {
    const Leaves L{leaves, strides, blk};
    const float* cur = blk == 0 ? x : out;
    // FFN1: x + W2 swish(W1 LN(x) + b1) + b2
    TRY(gemm(st, cur, T, D, L.f(0), L.f(1), LN_EPS, L.at<W>(2), F, L.f(3), 1,
             nullptr, hid));
    TRY(gemm(st, hid, T, F, nullptr, nullptr, 0.f, L.at<W>(4), D, L.f(5), 0,
             cur, out));
    // MHSA: x + proj(attention(qkv(LN(x))))
    TRY(gemm(st, out, T, D, L.f(6), L.f(7), LN_EPS, L.at<W>(8), 3 * D, nullptr,
             0, nullptr, qkv));
    TRY(attention<RB>(st, qkv, mask, att, T, D, H, scale));
    TRY(gemm(st, att, T, D, nullptr, nullptr, 0.f, L.at<W>(9), D, nullptr, 0,
             out, out));
    // Conv module: LN -> pw1 swish -> causal dw swish -> pw2 -> SE -> +x
    TRY(gemm(st, out, T, D, L.f(10), L.f(11), LN_EPS, L.at<W>(12), E, L.f(13),
             1, nullptr, hid));
    TRY(dwconv(st, hid, 0, L.f(14), Kw, Kw - 1, nullptr, nullptr, nullptr,
               nullptr, nullptr, 1, hid2, T, E));
    TRY(gemm(st, hid2, T, E, nullptr, nullptr, 0.f, L.at<W>(15), D, L.f(16), 0,
             nullptr, hb));
    TRY(squeeze_excite(st, hb, mask, L.at<W>(17), L.f(18), L.at<W>(19),
                       L.f(20), gate, out, T, D, R));
    // FFN2
    TRY(gemm(st, out, T, D, L.f(21), L.f(22), LN_EPS, L.at<W>(23), F, L.f(24),
             1, nullptr, hid));
    TRY(gemm(st, hid, T, F, nullptr, nullptr, 0.f, L.at<W>(25), D, L.f(26), 0,
             out, out));
  }
  return 0;
}

// Leaf order of _conformer_args in the reference.
template <typename W, bool RB>
int conformer_stack(const float* x, const float* mask, float* out,
                    void* const* leaves, const long long* strides, int nblocks,
                    int T, int D, int H, int F, int Kw, float scale,
                    float* qkv, float* hid, float* hid2, float* att,
                    cudaStream_t st) {
  for (int blk = 0; blk < nblocks; ++blk) {
    const Leaves L{leaves, strides, blk};
    const float* cur = blk == 0 ? x : out;
    // FFN1 and MHSA share ln1
    TRY(gemm(st, cur, T, D, L.f(0), L.f(1), LN_EPS, L.at<W>(2), F, L.f(3), 1,
             nullptr, hid));
    TRY(gemm(st, hid, T, F, nullptr, nullptr, 0.f, L.at<W>(4), D, L.f(5), 0,
             cur, out));
    TRY(gemm(st, out, T, D, L.f(0), L.f(1), LN_EPS, L.at<W>(6), 3 * D, nullptr,
             0, nullptr, qkv));
    TRY(attention<RB>(st, qkv, mask, att, T, D, H, scale));
    TRY(gemm(st, att, T, D, nullptr, nullptr, 0.f, L.at<W>(7), D, nullptr, 0,
             out, out));
    // Conv module: pw1 -> GLU -> 'same' dw + bias -> BN -> pw2 -> LN(h + x)
    TRY(gemm(st, out, T, D, nullptr, nullptr, 0.f, L.at<W>(8), 2 * D, L.f(9),
             0, nullptr, hid));
    TRY(dwconv(st, hid, 1, L.f(10), Kw, (Kw - 1) / 2, L.f(11), L.f(12),
               L.f(13), L.f(14), L.f(15), 0, hid2, T, D));
    TRY(gemm(st, hid2, T, D, nullptr, nullptr, 0.f, L.at<W>(16), D, L.f(17), 0,
             out, out));
    TRY(layernorm(st, out, L.f(18), L.f(19), LN_EPS_DEFAULT, T, D));
    // FFN2
    TRY(gemm(st, out, T, D, L.f(20), L.f(21), LN_EPS, L.at<W>(22), F, L.f(23),
             1, nullptr, hid));
    TRY(gemm(st, hid, T, F, nullptr, nullptr, 0.f, L.at<W>(24), D, L.f(25), 0,
             out, out));
  }
  return 0;
}

}  // namespace

extern "C" {

// x, out [T, D] f32; mask [T] f32 of 1/0; leaves: the 27 stacked leaves of
// _squeeze_args, matrices at bf16 (bf16 != 0) or f32; scratch: qkv [T, 3D],
// hid [T, max(F, E)], hid2 [T, E], att [T, D], hb [T, D], gate [D]. Every
// pointer and block stride 16-byte aligned; D, F and E multiples of 32,
// D / H a multiple of 4. Returns a cudaError_t (0 on success).
int ishara_squeeze_stack(int device, const float* x, const float* mask,
                         float* out, void* const* leaves,
                         const long long* strides, int nblocks, int T, int D,
                         int H, int F, int E, int Kw, int R, float scale,
                         int bf16, float* qkv, float* hid, float* hid2,
                         float* att, float* hb, float* gate, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return squeeze_stack<__nv_bfloat16, true>(x, mask, out, leaves, strides,
                                              nblocks, T, D, H, F, E, Kw, R,
                                              scale, qkv, hid, hid2, att, hb,
                                              gate, st);
  return squeeze_stack<float, false>(x, mask, out, leaves, strides, nblocks, T,
                                     D, H, F, E, Kw, R, scale, qkv, hid, hid2,
                                     att, hb, gate, st);
}

// As above for the 26 leaves of _conformer_args; scratch: qkv [T, 3D],
// hid [T, max(F, 2D)], hid2 [T, D], att [T, D].
int ishara_conformer_stack(int device, const float* x, const float* mask,
                           float* out, void* const* leaves,
                           const long long* strides, int nblocks, int T, int D,
                           int H, int F, int Kw, float scale, int bf16,
                           float* qkv, float* hid, float* hid2, float* att,
                           void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return conformer_stack<__nv_bfloat16, true>(x, mask, out, leaves, strides,
                                                nblocks, T, D, H, F, Kw, scale,
                                                qkv, hid, hid2, att, st);
  return conformer_stack<float, false>(x, mask, out, leaves, strides, nblocks,
                                       T, D, H, F, Kw, scale, qkv, hid, hid2,
                                       att, st);
}

const char* ishara_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
