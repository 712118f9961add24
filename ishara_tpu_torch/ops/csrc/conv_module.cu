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
// The TPU kernel holds a whole [T, E] slab of a sequence in VMEM. An SM
// cannot (1 MB at T 512, E 512 in f32), and two things couple time across
// a sequence: the SE pool and the causal conv. So the branch runs here as a
// chain of simple kernels that pass sequence-sized intermediates through
// device memory (and L2), each of them tiled over rows:
//   forward, 6 launches: LN rows -> xn; pw1 product with bias and swish in
//   its epilogue -> a; causal conv and swish -> s; pw2 product with bias ->
//   p; the SE gate, one block a sequence (masked pool, two tiny products);
//   out = p * g + x.
//   backward, 20 launches: the forward recomputed from x up to p (u kept
//   beside a); the SE backward, one block a sequence (dgate = sum_t dy * p,
//   then back through the gate's two products to dpool); dp and its column
//   sums; ds = dp w2^T; dc = ds * swish'(c); da by the anticausal conv, with
//   du, and per-chunk sums of db1 and of dwdw[k] = sum_t a[t - K + 1 + k] dc
//   [t]; dxn = du w1^T; LN's backward with dx and per-block sums of the LN
//   gradients; dw1 = xn^T du and dw2 = s^T dp as row-split products
//   (wgrad.cuh, shared with ffn.cu); the SE weight gradients summed over
//   sequences; the six partial sums added in a fixed order (wgrad.cuh). No
//   atomics: every gradient is the same from run to run.
// The four row products (pw1, pw2, and their transposes in the backward)
// are one tiled kernel (64 x 64 outputs a block, 32 deep a step, operands
// through shared memory): wmma 16x16x16 tiles with f32 accumulation at
// bf16, f32 FMAs at f32.
//
// Bound: operations (at B 256, T 512, D 256, E 512 in bf16 the forward's
// products are 69 GFLOP, 0.07 ms on the tensor cores, against 67 MB of x and
// out; the backward's 4 products and the recomputation 206 GFLOP). This
// first version is bound by its memory passes -- ~15 sequence-sized f32
// intermediates written and read once each -- and by feeding the tensor
// cores through shared memory without asynchronous copies. The design that
// removes those passes tiles time instead: a block recomputes the conv's
// (K - 1)-row halo of swish(pw1(LN(x))) beside its tile, writes p once with
// its masked pool partials, and the backward's second pass recomputes the
// branch with a halo on both sides.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
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

// out = p * g + x, rounded once.
template <typename T>
__global__ void apply_kernel(const float* __restrict__ p,
                             const float* __restrict__ gate,
                             const T* __restrict__ x, T* __restrict__ out,
                             long long ND, long long TD, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ND) return;
  const long long b = i / TD;
  out[i] = narrow<T>(p[i] * gate[b * D + i % D] + widen(x[i]));
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
// db1_part / dwdw_part[chunk index]. K <= MAXK.
constexpr int MAXK = 32;

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
  float w[MAXK], dw[MAXK];
#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    w[k] = k < K ? wdw[k * E + e] : 0.f;
    dw[k] = 0.f;
  }
  float db1 = 0.f;
  const long long base = (long long)b * Tn * E + e;
  for (int t = t0; t < min(Tn, t0 + ROWS); ++t) {
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
  db1_part[part * E + e] = db1;
#pragma unroll
  for (int k = 0; k < MAXK; ++k)
    if (k < K) dwdw_part[(part * K + k) * E + e] = dw[k];
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
  float *u, *a, *c, *p, *ds, *dxn;
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
  w.p = c.take<float>(ND);
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
// (with its backward when dy is given).
template <typename T>
cudaError_t branch(const Args& A, const Shape& S, const Work<T>& w,
                   const T* dy, cudaStream_t s) {
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
  Gemm h{};
  h.A = w.s, h.sam = S.E, h.sak = 1;
  h.B = A.w2, h.sbk = S.D, h.sbn = 1;
  h.M = S.N, h.N = S.D, h.K = S.E;
  h.bias = (const float*)A.b2;
  h.out0 = w.p;
  h.ldc = S.D;
  TRY(gemm<T>(h, s));
  const size_t smem = (2 * (size_t)S.D + 3 * (size_t)S.r + 1) * 4;
  TRY(allow_smem(se_kernel<T>, smem));
  se_kernel<T><<<S.B, THREADS, smem, s>>>(
      w.p, (const float*)A.mask, (const float*)A.wf1, (const float*)A.bf1,
      (const float*)A.wf2, (const float*)A.bf2, dy, w.gate, w.dpool, w.msum,
      w.pool, w.g1, w.dz1, w.dz2, S.Tn, S.D, S.r);
  return cudaGetLastError();
}

bool shape_ok(const Shape& S) {
  return S.B > 0 && S.B <= 65535 && S.Tn > 0 && S.D > 0 && S.E > 0 &&
         S.K > 0 && S.K <= MAXK && S.r > 0 &&
         (2 * (size_t)S.D + 3 * (size_t)S.r + 1) * 4 <= SMEM_LIMIT &&
         (size_t)(THREADS / 32) * 2 * S.D * 4 <= SMEM_LIMIT &&
         (long long)S.B * S.Tn < (1LL << 31) &&
         time_chunks(S) <= 65535;
}

template <typename T>
cudaError_t forward(const Args& A, void* out, void* work, const Shape& S,
                    cudaStream_t s) {
  Carve c{(char*)work};
  const Work<T> w = carve<T>(S, 1, false, c);
  TRY(branch<T>(A, S, w, nullptr, s));
  const long long ND = (long long)S.N * S.D;
  apply_kernel<T><<<blocks_of(ND), THREADS, 0, s>>>(
      w.p, w.gate, (const T*)A.x, (T*)out, ND, (long long)S.Tn * S.D, S.D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const Args& A, const void* dy, void* dx, float* grads,
                     void* work, const Shape& S, int splits, cudaStream_t s) {
  Carve c{(char*)work};
  const Work<T> w = carve<T>(S, splits, true, c);
  const long long NE = (long long)S.N * S.E;
  TRY(branch<T>(A, S, w, (const T*)dy, s));
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
  // gradient layout: dgamma, dbeta [D], dw1 [D, E], db1 [E], dwdw [K, E],
  // dw2 [E, D], db2 [D], dwf1 [D, r], dbf1 [r], dwf2 [r, D], dbf2 [D]
  float* dln = grads;
  float* dw1 = dln + 2 * S.D;
  float* db1 = dw1 + (long long)S.D * S.E;
  float* dwdw = db1 + S.E;
  float* dw2 = dwdw + (long long)S.K * S.E;
  float* db2 = dw2 + (long long)S.E * S.D;
  float* dwf1 = db2 + S.D;
  float* dbf1 = dwf1 + (long long)S.D * S.r;
  float* dwf2 = dbf1 + S.r;
  float* dbf2 = dwf2 + (long long)S.r * S.D;
  // dw1 = xn^T du and dw2 = s^T dp, the partials of the row splits
  TRY(wgrad::product<T>(w.xn, w.du, w.dw1_part, S.N, S.D, S.E, splits, s));
  TRY(wgrad::product<T>(w.s, w.dp, w.dw2_part, S.N, S.E, S.D, splits, s));
  const int n_se = S.D * S.r * 2 + S.r + S.D;
  se_wgrad_kernel<<<blocks_of(n_se), THREADS, 0, s>>>(
      w.pool, w.g1, w.dz1, w.dz2, dwf1, dbf1, dwf2, dbf2, S.B, S.D, S.r);
  TRY(cudaGetLastError());
  const int parts = S.B * time_chunks(S);
  const struct {
    const float* part;
    float* out;
    int parts;
    long long n;
  } sums[] = {
      {w.ln_part, dln, row_blocks(S), 2LL * S.D},
      {w.dw1_part, dw1, splits, (long long)S.D * S.E},
      {w.db1_part, db1, parts, S.E},
      {w.dwdw_part, dwdw, parts, (long long)S.K * S.E},
      {w.dw2_part, dw2, splits, (long long)S.E * S.D},
      {w.db2_part, db2, row_blocks(S), S.D},
  };
  for (const auto& r : sums) TRY(wgrad::sum_parts(r.part, r.out, r.parts, r.n, s));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of workspace the forward (backward = 0) or backward (1) needs, in
// units of 256 bytes. dtype 0 = f32, 1 = bf16; splits: the row splits of
// the backward's weight products.
int ishara_conv_workspace(int B, int T, int D, int E, int K, int r,
                          int dtype, int backward, int splits) {
  const Shape S{B, T, D, E, K, r, B * T};
  Carve c{nullptr};
  if (dtype == 0)
    carve<float>(S, splits, backward != 0, c);
  else
    carve<bf16>(S, splits, backward != 0, c);
  return (int)(c.used / 256);
}

// out [B, T, D] = x + SE(pw2(swish(dw(swish(pw1(LN(x))))))) in x's type.
// Operand types as at the top of this file; workspace of
// ishara_conv_workspace(.., 0, 1) * 256 bytes.
int ishara_conv_fwd(int device, int dtype, const void* x, const void* mask,
                    const void* gamma, const void* beta, const void* w1,
                    const void* b1, const void* wdw, const void* w2,
                    const void* b2, const void* wf1, const void* bf1,
                    const void* wf2, const void* bf2, void* out, void* work,
                    int B, int T, int D, int E, int K, int r, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Shape S{B, T, D, E, K, r, B * T};
  if (!shape_ok(S) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const Args A{x, mask, gamma, beta, w1, b1, wdw, w2, b2, wf1, bf1, wf2, bf2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)forward<float>(A, out, work, S, s);
  return (int)forward<bf16>(A, out, work, S, s);
}

// dx [B, T, D] in x's type and the eleven parameter gradients, f32, one
// after the other in grads: dgamma, dbeta [D], dw1 [D, E], db1 [E],
// dwdw [K, E], dw2 [E, D], db2 [D], dwf1 [D, r], dbf1 [r], dwf2 [r, D],
// dbf2 [D]. Workspace of ishara_conv_workspace(.., 1, splits) * 256 bytes.
int ishara_conv_bwd(int device, int dtype, const void* x, const void* mask,
                    const void* dy, const void* gamma, const void* beta,
                    const void* w1, const void* b1, const void* wdw,
                    const void* w2, const void* b2, const void* wf1,
                    const void* bf1, const void* wf2, const void* bf2,
                    void* dx, void* grads, void* work, int B, int T, int D,
                    int E, int K, int r, int splits, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Shape S{B, T, D, E, K, r, B * T};
  if (!shape_ok(S) || splits < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const Args A{x, mask, gamma, beta, w1, b1, wdw, w2, b2, wf1, bf1, wf2, bf2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)backward<float>(A, dy, dx, (float*)grads, work, S, splits, s);
  return (int)backward<bf16>(A, dy, dx, (float*)grads, work, S, splits, s);
}

const char* ishara_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
