// K9 on Hopper (sm_90a): the whole autoregressive decode loop of the
// translation model's decoder -- greedy, or beam search over W beams -- in
// one launch.
//
// Replaces the Pallas kernels _decode_kernel (behind fused_greedy_decode)
// and _beam_kernel (behind fused_beam_decode) of
// ishara_tpu/ops/decoder_kernel.py. Per step and beam row: for each
// decoder layer a pre-norm self-attention over the carried K/V cache (the
// row at the step's position written first), a cross-attention over the
// encoder memory's precomputed K/V with the memory mask as an additive
// -1e30, a relu FFN; then the final LayerNorm and the classifier, and the
// next token: the first maximum (greedy), or the stable top-W of the
// beams' log-softmax continuations, finished beams extending with pad at
// cost 0 (beam). The loop stops inside the kernel once the token is eos
// (greedy) or every beam's row holds an eos (beam).
//
// What bounds it. A step reads ~5 MB of f32 weights (14 d^2 a layer, the
// classifier and one embedding row) and 0.6 MB of cross K/V for ~1.2 M
// multiply-adds: the products have one row (greedy) or W (beam), so the
// tensor cores have nothing to do, and a step is ~17 dependent stages.
// The state does not fit one SM (227 KB of shared memory), so one SM
// cannot run the loop; and a grid barrier between stages costs about a
// launch boundary. The design is therefore ONE thread-block cluster: 16
// blocks (non-portable size; 8 where the card cannot place 16) of 512
// threads on neighbouring SMs, synchronised by the cluster barrier,
// which is hardware and much cheaper than a grid barrier. (512 threads,
// not 1024: at 1024 a thread has 64 registers, the products' accumulators
// spill to local memory, and every stage waits on it.)
//
// - Every product is split by output rows: block r owns rows
//   [N r / CL, N (r+1) / CL) of each weight matrix, a warp a row (lanes
//   along the input, a shuffle sum), all W beam rows at once, so a weight
//   is read once a step whatever W. Each block keeps as many of its row
//   slices as fit in its shared memory (first fit, in matrix order), and
//   reads the rest from L2, where the weights stay across steps.
// - The activations (x, the LayerNorm output, q, the attention context,
//   the FFN hidden, the logits: a few KB) live in every block's shared
//   memory. A block writes its rows of a stage's result into all the
//   blocks' copies through distributed shared memory, then the cluster
//   barrier; each LayerNorm is computed in every block from its own copy.
// - Attention: a group of a block's threads takes a (beam, head) pair, all
//   the block's pairs at once; a thread a key for the scores (K stored
//   transposed, so that neighbouring threads read neighbouring words), the
//   softmax weights once a key, threads spread over (key chunk, head dim)
//   for the context. The self-attention caches are in global memory
//   (written once a row, read through L2 with __ldcg); the beam's parent
//   reorder never copies a cache: bank w's row p is written once, at step
//   p, by whichever beam held slot w then, so a table hist[w][p] (the bank
//   holding beam w's row p) is reordered instead of the caches -- the same
//   values as the reference's reordered copies.
// - Token selection, the token rows and the next embedding (a row gather,
//   not the one-hot product) are computed in every block from the same
//   logits, so they agree without another barrier.
//
// On the H100 (chip_smoke.py; PERF.md) a greedy step at the reference
// width takes about 60 us, against about 3 us for the whole decode by its
// bound (each input read once): latency binds -- the cluster barriers, a
// few L2 round trips in each attention stage, a round of row jobs in each
// product stage. The next levers: fewer stages a step, the cross K / V of
// a block's heads and the self-attention caches in shared memory (read
// across the cluster through distributed shared memory).
//
// Arithmetic as the reference kernel: two-pass LayerNorm (flax's module is
// fast-variance: a rounding difference only), additive -1e30 masks (the
// self-attention visits only the visible rows, whose complement the
// reference masks to exp(-1e30 - max) = 0 exactly), softmax as
// exp(s - max) / sum, f32 throughout, -1e30 as the dead beams' initial
// score (needs W <= C).

#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int MAXW = 8;      // beams (the kernel is built for 1, 2, 4, 8)
constexpr int MAXDH = 128;   // head dim
constexpr float NEG = -1e30f;

struct Dims {
  int d, H, L, C, T, S, W, beam, sos, eos, pad;
  float eps, scale;
};

// Float offsets of a decoder layer's leaves in the packed weights. Matrices
// are [out, in] (torch.nn.Linear's layout). Per layer: norm1 scale / bias,
// sa_q, sa_k, sa_v, sa_out (weight, bias), norm2, ca_q, ca_out, norm3, fc1,
// fc2; after the L layers: decoder_norm scale / bias, classifier weight
// [C, d] and bias, the embedding [C, d].
struct LayerOff {
  long long n1g, n1b, wq, bq, wk, bk, wv, bv, wo, bo, n2g, n2b, wcq, bcq,
      wco, bco, n3g, n3b, w1, b1, w2, b2;
};

__host__ __device__ inline long long layer_floats(int d) {
  return 14LL * d * d + 17LL * d;
}

__host__ __device__ inline LayerOff layer_off(int d, int l) {
  const long long dd = (long long)d * d;
  long long p = layer_floats(d) * l;
  LayerOff o;
  o.n1g = p; p += d;  o.n1b = p; p += d;
  o.wq = p;  p += dd; o.bq = p;  p += d;
  o.wk = p;  p += dd; o.bk = p;  p += d;
  o.wv = p;  p += dd; o.bv = p;  p += d;
  o.wo = p;  p += dd; o.bo = p;  p += d;
  o.n2g = p; p += d;  o.n2b = p; p += d;
  o.wcq = p; p += dd; o.bcq = p; p += d;
  o.wco = p; p += dd; o.bco = p; p += d;
  o.n3g = p; p += d;  o.n3b = p; p += d;
  o.w1 = p;  p += 4 * dd; o.b1 = p; p += 4 * d;
  o.w2 = p;  p += 4 * dd; o.b2 = p;
  return o;
}

__host__ __device__ inline long long tail_off(const Dims& D) {
  return layer_floats(D.d) * D.L;   // decoder_norm scale, bias, classifier,
}                                    // its bias, the embedding

// Matrix m of the products, in the order the shared-memory cache fills:
// 8 a layer (q, k, v, out, cross q, cross out, fc1, fc2), then the
// classifier. Its float offset, rows N and inputs K.
__host__ __device__ inline void matrix_of(const Dims& D, int m, long long* off,
                                          int* N, int* K) {
  const int d = D.d;
  if (m == 8 * D.L) {
    *off = tail_off(D) + 2 * d; *N = D.C; *K = d;
    return;
  }
  const LayerOff o = layer_off(d, m / 8);
  const long long offs[8] = {o.wq, o.wk, o.wv, o.wo, o.wcq, o.wco, o.w1,
                             o.w2};
  *off = offs[m % 8];
  *N = (m % 8 == 6) ? 4 * d : d;
  *K = (m % 8 == 7) ? 4 * d : d;
}

__host__ __device__ inline int align4(int w) { return (w + 3) / 4 * 4; }

// Floats of a decoder layer's vectors (norm scales and biases, biases):
// norm1, sa_q, sa_k, sa_v, sa_out, norm2, ca_q, ca_out, norm3, fc1 (4d),
// fc2; in shared memory in this order, the layers one after the other,
// then decoder_norm and the classifier's bias.
__host__ __device__ inline int layer_vector_floats(int d) { return 17 * d; }

// 4-byte words of shared memory for everything but the weight cache: the
// weight pointer table, the activations, the attention scratch, the token
// state and the vectors. Mirrored by ops/decoder_kernel.py
// fused_decode_smem_bytes.
__host__ __device__ inline int vector_words(const Dims& D) {
  const int W = D.W, d = D.d;
  const int ptrs = align4(2 * (8 * D.L + 1));
  const int floats = 4 * W * d + 4 * W * d + W * D.C +
                     (W * D.H + 7) / 8 * (D.T > D.S ? D.T : D.S) + THREADS +
                     2 * W;
  const int ints = 3 * W * D.S + 2 * W + 4;
  const int vecs = D.L * layer_vector_floats(d) + 2 * d + D.C;
  return align4(ptrs + floats + ints + vecs);
}

// Words of weight slices a block keeps in shared memory under ``budget``
// words: first fit in matrix order, each matrix counted at its largest
// slice (ceil(N / CL) rows).
__host__ __device__ inline long long cache_words(const Dims& D, int CL,
                                                 long long budget) {
  long long used = 0;
  for (int m = 0; m <= 8 * D.L; ++m) {
    long long off; int N, K;
    matrix_of(D, m, &off, &N, &K);
    const long long cap = (long long)((N + CL - 1) / CL) * K;
    if (used + cap <= budget) used += cap;
  }
  return used;
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

// (value, index): the larger value, or the smaller index among equal ones.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

// y[w] = LayerNorm(x[w]) for the W rows, a warp a row, two-pass; all in
// shared memory.
__device__ void layer_norm_rows(const float* x, float* y, const float* g,
                                const float* b, int W, int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int w = warp; w < W; w += NWARPS) {
    const float* xr = x + w * d;
    float s = 0.f;
    for (int k = lane; k < d; k += 32) s += xr[k];
    const float mu = warp_sum(s) / d;
    float v = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float t = xr[k] - mu;
      v += t * t;
    }
    const float r = rsqrtf(warp_sum(v) / d + eps);
    for (int k = lane; k < d; k += 32)
      y[w * d + k] = (xr[k] - mu) * r * g[k] + b[k];
  }
}

enum Mode { BCAST = 0, RELU = 1, RESID = 2, GLOBAL = 3 };

// One output of a product stage. ``w`` is this block's row slice of the
// [N, K] matrix (shared or global memory); result (w, j) goes to
// dst[w ld + j js]: BCAST / RELU / RESID into that shared-memory vector of
// every block of the cluster (RESID adds the current value first, the
// residual), GLOBAL into global memory (a cache row or column).
struct Target {
  const float* w = nullptr;
  const float* bias = nullptr;
  float* dst = nullptr;
  long long ld = 0;
  int mode = BCAST;
  long long js = 1;
};

// dst[w, j] = in[w, :] . W[j, :] + bias[j] (+ mode) for this block's rows j
// of the ``nt`` targets (ta, tb, tc, passed by value: an array of them
// would live in local memory, which misses L1 here), which share N and K; W <= MW beam rows (MW known
// when compiling: with a run-time bound the beam loops cost 3-4 times as
// much).
template <int MW>
__device__ void product_stage(cg::cluster_group& cluster, int N, int K,
                              const float* in, int W, const Target ta,
                              const Target tb = Target(),
                              const Target tc = Target(), int nt = 1) {
  const int CL = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int r0 = (int)((long long)N * rank / CL);
  const int nr = (int)((long long)N * (rank + 1) / CL) - r0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int job = warp; job < nt * nr; job += NWARPS) {
    const int ti = job / nr;
    const Target t = ti == 0 ? ta : (ti == 1 ? tb : tc);
    const int jr = job % nr, j = r0 + jr;
    const float* row = t.w + (long long)jr * K;
    const float bj = t.bias[j];
    float acc[MW];
#pragma unroll
    for (int w = 0; w < MW; ++w) acc[w] = 0.f;
    // 8 of the row's loads in flight at once (the row may be in L2)
    for (int k0 = lane; k0 < K; k0 += 8 * 32) {
      float wk[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = k0 + 32 * u;
        wk[u] = k < K ? row[k] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = k0 + 32 * u;
        if (k < K) {
#pragma unroll
          for (int w = 0; w < MW; ++w)
            if (w < W) acc[w] = fmaf(in[w * K + k], wk[u], acc[w]);
        }
      }
    }
#pragma unroll
    for (int w = 0; w < MW; ++w) {
      if (w < W) {
        const float a = warp_sum(acc[w]);
        if (t.mode == RESID) {
          acc[w] = t.dst[w * t.ld + j * t.js] + a + bj;
        } else {
          acc[w] = a + bj;
          if (t.mode == RELU) acc[w] = fmaxf(acc[w], 0.f);
        }
      }
    }
    __syncwarp();   // every lane has read the residual before any stores it
    const int copies = t.mode == GLOBAL ? 1 : CL;
    for (int e = lane; e < W * copies; e += 32) {
      const int w = e % W, r = e / W;
      float v = 0.f;
#pragma unroll
      for (int u = 0; u < MW; ++u)
        if (u == w) v = acc[u];
      if (t.mode == GLOBAL)
        t.dst[w * t.ld + j * t.js] = v;
      else
        cluster.map_shared_rank(t.dst, r)[w * t.ld + j * t.js] = v;
    }
  }
}

// The block's (beam row, head) pairs of an attention, pr = rank + g CL for
// g < P = ceil(W H / 8) (8: the smallest cluster), all at once: group g of
// G = THREADS / P threads takes pair pr (if pr < W H). For pair (w, h):
// softmax over ``n`` keys of scale * q_w.k_j (+ add[j]), times V, into
// cs[w, h Dh : (h + 1) Dh] of every block. Beam w's key j lies in bank
// b = hist[w S + j] (hist null: b = 0): K is stored transposed, element
// (feature e, key j) at kb + b kbank + e ldk + j, so that a warp's threads,
// a key each, read neighbouring words; V by rows, at vb + b vbank + j d + e.
// Scores: a thread a key; context: threads over (key chunk, head dim);
// each thread's loads are issued in batches, since K and V are in L2.
__device__ void attention_stage(cg::cluster_group& cluster, const float* qs,
                                const float* kb, long long kbank, int ldk,
                                const float* vb, long long vbank,
                                const int* hist, int S, int n,
                                const float* add, int W, int H, int d,
                                float scale, float* sc, int sc_stride,
                                float* part, float* cs) {
  const int CL = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31;
  const int Dh = d / H, P = (W * H + 7) / 8;
  const int G = 32 * (NWARPS / P), g = tid / G, gt = tid % G;
  const int pr = rank + g * CL;
  const bool active = g < P && pr < W * H;
  const int w = active ? pr / H : 0, c0 = (active ? pr % H : 0) * Dh;
  const float* q = qs + w * d + c0;
  const int* hw = hist ? hist + w * S : nullptr;
  float* scg = sc + g * sc_stride;
  float* pg = part + g * G;
  if (active) {
    for (int j = gt; j < n; j += G) {
      const float* kr = kb + (hw ? hw[j] : 0) * kbank + (long long)c0 * ldk + j;
      float s = 0.f;
      for (int u0 = 0; u0 < Dh; u0 += 32) {
        float kv[32];
#pragma unroll
        for (int t = 0; t < 32; ++t)
          kv[t] = u0 + t < Dh ? __ldcg(kr + (long long)(u0 + t) * ldk) : 0.f;
#pragma unroll
        for (int t = 0; t < 32; ++t)
          if (u0 + t < Dh) s = fmaf(kv[t], q[u0 + t], s);
      }
      s = s * scale;
      if (add) s += add[j];
      scg[j] = s;
    }
  }
  __syncthreads();
  // softmax: every warp of the group takes the max and the sum itself,
  // then a thread a key turns its score into its weight, once
  float m = -INFINITY, sum = 0.f;
  if (active) {   // whole warps: G is a multiple of 32
    for (int j = lane; j < n; j += 32) m = fmaxf(m, scg[j]);
    m = warp_max(m);
    for (int j = lane; j < n; j += 32) sum += expf(scg[j] - m);
    sum = warp_sum(sum);
  }
  __syncthreads();
  if (active)
    for (int j = gt; j < n; j += G) scg[j] = expf(scg[j] - m) / sum;
  __syncthreads();
  const int chunks = G / Dh;
  const int c = gt / Dh, u = gt % Dh;
  if (active) {
    float acc = 0.f;
    for (int j0 = c; c < chunks && j0 < n; j0 += 16 * chunks) {
      float vv[16];
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const int j = j0 + b * chunks;
        vv[b] = j < n ? __ldcg(vb + (hw ? hw[j] : 0) * vbank +
                               (long long)j * d + c0 + u)
                      : 0.f;
      }
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const int j = j0 + b * chunks;
        if (j < n) acc = fmaf(scg[j], vv[b], acc);
      }
    }
    if (c < chunks) pg[c * Dh + u] = acc;
  }
  __syncthreads();
  if (active) {
    for (int e = gt; e < Dh * CL; e += G) {
      const int u = e % Dh, r = e / Dh;
      float v = 0.f;
      for (int c = 0; c < chunks; ++c) v += pg[c * Dh + u];
      cluster.map_shared_rank(cs, r)[w * d + c0 + u] = v;
    }
  }
}

template <int MW>
__global__ void __launch_bounds__(THREADS, 1)
decode_kernel(const float* __restrict__ pack, const float* __restrict__ cross,
              const float* __restrict__ memadd, float* cache,
              int* out_tokens, float* out_scores, int* out_steps, Dims D,
              long long budget) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = D.d, S = D.S, C = D.C, H = D.H, L = D.L, T = D.T;
  const int W = MW <= 2 ? MW : D.W;   // known when compiling for 1 and 2

  extern __shared__ float4 smem4[];
  const float** wtab = reinterpret_cast<const float**>(smem4);
  float* xs = reinterpret_cast<float*>(smem4) + align4(2 * (8 * L + 1));
  float* hs = xs + W * d;                 // LayerNorm output (local)
  float* qs = hs + W * d;                 // q (every block)
  float* cs = qs + W * d;                 // attention context
  float* fs = cs + W * d;                 // FFN hidden [W, 4d]
  float* ls = fs + 4 * W * d;             // logits, then beam totals
  float* sc = ls + W * C;                 // attention scores, a group's
  float* part = sc + (W * H + 7) / 8 * (T > S ? T : S);   // partials
  float* bscore = part + THREADS;         // beam scores
  float* nscore = bscore + W;
  int* toks = reinterpret_cast<int*>(nscore + W);   // [W, S]
  int* hist = toks + W * S;                         // [W, S]
  int* tmp = hist + W * S;                          // [W, S]
  int* parent = tmp + W * S;
  int* tokw = parent + W;
  int* flags = tokw + W;                  // finished, greedy's token
  float* vsm = reinterpret_cast<float*>(flags + 4);   // the vectors
  float* wcache = reinterpret_cast<float*>(smem4) + vector_words(D);

  // the vectors, every block all of them
  const int lvf = layer_vector_floats(d);
  for (int l = 0; l < L; ++l) {
    const LayerOff o = layer_off(d, l);
    const long long src[11] = {o.n1g, o.bq, o.bk, o.bv, o.bo, o.n2g, o.bcq,
                               o.bco, o.n3g, o.b1, o.b2};
    const int len[11] = {2 * d, d, d, d, d, 2 * d, d, d, 2 * d, 4 * d, d};
    float* dst = vsm + l * lvf;
    for (int a = 0; a < 11; ++a) {
      for (int e = tid; e < len[a]; e += THREADS) dst[e] = pack[src[a] + e];
      dst += len[a];
    }
  }
  {
    const long long tl = tail_off(D);
    float* dst = vsm + L * lvf;
    for (int e = tid; e < 2 * d; e += THREADS) dst[e] = pack[tl + e];
    for (int e = tid; e < C; e += THREADS)
      dst[2 * d + e] = pack[tl + 2 * d + (long long)C * d + e];
  }

  // this block's weight slices: into shared memory while they fit
  long long used = 0;
  for (int m = 0; m <= 8 * L; ++m) {
    long long off; int N, K;
    matrix_of(D, m, &off, &N, &K);
    const int r0 = (int)((long long)N * rank / CL);
    const int r1 = (int)((long long)N * (rank + 1) / CL);
    const float* src = pack + off + (long long)r0 * K;
    const long long cap = (long long)((N + CL - 1) / CL) * K;
    if (used + cap <= budget) {
      float* dst = wcache + used;
      for (long long e = tid; e < (long long)(r1 - r0) * K; e += THREADS)
        dst[e] = src[e];
      if (tid == 0) wtab[m] = dst;
      used += cap;
    } else if (tid == 0) {
      wtab[m] = src;
    }
  }

  const float* dng = vsm + L * lvf;
  const float* dnb = dng + d;
  const float* bcls = dnb + d;
  const float* embed = pack + tail_off(D) + 2 * d + (long long)C * d + C;
  for (int e = tid; e < W * d; e += THREADS)
    xs[e] = embed[(long long)D.sos * d + e % d];
  for (int e = tid; e < W * S; e += THREADS) {
    toks[e] = (e % S == 0) ? D.sos : D.pad;
    hist[e] = e / S;
  }
  if (tid < W) bscore[tid] = tid == 0 ? 0.f : NEG;
  if (tid == 0) flags[0] = 0;
  __syncthreads();
  cluster.sync();   // every block runs before any writes into its memory

  int steps = 0;
  for (int i = 0; i < S - 1; ++i) {
    for (int l = 0; l < L; ++l) {
      // this layer's vectors: norm1 (scale, bias), sa biases q k v out,
      // norm2, ca biases q out, norm3, fc1's bias, fc2's
      const float* v = vsm + l * lvf;
      const float *n1g = v, *n1b = v + d, *bq = v + 2 * d, *bk = v + 3 * d,
                  *bv = v + 4 * d, *bo = v + 5 * d, *n2g = v + 6 * d,
                  *n2b = v + 7 * d, *bcq = v + 8 * d, *bco = v + 9 * d,
                  *n3g = v + 10 * d, *n3b = v + 11 * d, *b1 = v + 12 * d,
                  *b2 = v + 16 * d;
      const float* const* wt = wtab + 8 * l;
      // caches: K banks [W][d][S] (transposed), V banks [W][S][d]
      float* kc = cache + (long long)(2 * l) * W * S * d;
      float* vc = kc + (long long)W * S * d;

      // self-attention: q to every block, k / v into cache row i
      layer_norm_rows(xs, hs, n1g, n1b, W, d, D.eps);
      __syncthreads();
      product_stage<MW>(
          cluster, d, d, hs, W, Target{wt[0], bq, qs, d, BCAST},
          Target{wt[1], bk, kc + i, (long long)d * S, GLOBAL, S},
          Target{wt[2], bv, vc + (long long)i * d, (long long)S * d, GLOBAL},
          3);
      cluster.sync();
      attention_stage(cluster, qs, kc, (long long)d * S, S, vc,
                      (long long)S * d, hist, S, i + 1, nullptr, W, H, d,
                      D.scale, sc, T > S ? T : S, part, cs);
      cluster.sync();
      product_stage<MW>(cluster, d, d, cs, W, Target{wt[3], bo, xs, d, RESID});
      cluster.sync();

      // cross-attention over the memory
      layer_norm_rows(xs, hs, n2g, n2b, W, d, D.eps);
      __syncthreads();
      product_stage<MW>(cluster, d, d, hs, W, Target{wt[4], bcq, qs, d, BCAST});
      cluster.sync();
      const float* kx = cross + (long long)(2 * l) * T * d;
      attention_stage(cluster, qs, kx, 0, T, kx + (long long)T * d, 0,
                      nullptr, S, T, memadd, W, H, d, D.scale, sc,
                      T > S ? T : S, part, cs);
      cluster.sync();
      product_stage<MW>(cluster, d, d, cs, W, Target{wt[5], bco, xs, d, RESID});
      cluster.sync();

      // FFN
      layer_norm_rows(xs, hs, n3g, n3b, W, d, D.eps);
      __syncthreads();
      product_stage<MW>(cluster, 4 * d, d, hs, W,
                        Target{wt[6], b1, fs, 4 * d, RELU});
      cluster.sync();
      product_stage<MW>(cluster, d, 4 * d, fs, W,
                        Target{wt[7], b2, xs, d, RESID});
      cluster.sync();
    }
    layer_norm_rows(xs, hs, dng, dnb, W, d, D.eps);
    __syncthreads();
    product_stage<MW>(cluster, C, d, hs, W,
                      Target{wtab[8 * L], bcls, ls, C, BCAST});
    cluster.sync();
    ++steps;

    // the next token(s): the same in every block, from the same logits
    if (!D.beam) {
      if (warp == 0) {
        float bv = -INFINITY;
        int bi = C;
        for (int c = lane; c < C; c += 32)
          if (ls[c] > bv) { bv = ls[c]; bi = c; }
        warp_argmax(bv, bi);                        // the first maximum
        if (lane == 0) {
          toks[i + 1] = bi;
          flags[0] = bi == D.eos;
          flags[1] = bi;
        }
      }
      __syncthreads();
      const int nxt = flags[1];
      for (int e = tid; e < d; e += THREADS)
        xs[e] = embed[(long long)nxt * d + e];
    } else {
      // totals[w, c] = score[w] + log_softmax(logits[w])[c]; a finished
      // beam (an eos in its row) offers only pad, at cost 0
      for (int w = warp; w < W; w += NWARPS) {
        float* row = ls + w * C;
        float m = -INFINITY;
        for (int c = lane; c < C; c += 32) m = fmaxf(m, row[c]);
        m = warp_max(m);
        float s = 0.f;
        for (int c = lane; c < C; c += 32) s += expf(row[c] - m);
        const float lse = logf(warp_sum(s));
        int fin = 0;
        for (int p = lane; p < S; p += 32) fin |= toks[w * S + p] == D.eos;
        fin = __any_sync(0xffffffffu, fin);
        for (int c = lane; c < C; c += 32) {
          float lp = (row[c] - m) - lse;
          if (fin) lp = c == D.pad ? 0.f : NEG;
          row[c] = bscore[w] + lp;
        }
      }
      __syncthreads();
      if (warp == 0) {       // stable top-W: largest, then smallest index
        for (int r = 0; r < W; ++r) {
          float bv = -INFINITY;
          int bi = W * C;
          for (int f = lane; f < W * C; f += 32)
            if (ls[f] > bv) { bv = ls[f]; bi = f; }
          warp_argmax(bv, bi);
          if (lane == 0) {
            parent[r] = bi / C;
            tokw[r] = bi % C;
            nscore[r] = bv;
            ls[bi] = -INFINITY;
          }
          __syncwarp();
        }
      }
      __syncthreads();
      for (int e = tid; e < W * S; e += THREADS) {
        const int w = e / S, p = e % S;
        tmp[e] = p == i + 1 ? tokw[w] : toks[parent[w] * S + p];
      }
      __syncthreads();
      for (int e = tid; e < W * S; e += THREADS) {
        const int w = e / S, p = e % S;
        toks[e] = tmp[e];
        tmp[e] = p <= i ? hist[parent[w] * S + p] : w;
      }
      __syncthreads();
      for (int e = tid; e < W * S; e += THREADS) hist[e] = tmp[e];
      for (int e = tid; e < W * d; e += THREADS)
        xs[e] = embed[(long long)tokw[e / d] * d + e % d];
      if (tid < W) bscore[tid] = nscore[tid];
      __syncthreads();
      if (warp == 0) {
        int all = 1;
        for (int w = 0; w < W; ++w) {
          int any = 0;
          for (int p = lane; p < S; p += 32) any |= toks[w * S + p] == D.eos;
          all &= __any_sync(0xffffffffu, any);
        }
        if (lane == 0) flags[0] = all;
      }
    }
    __syncthreads();
    if (flags[0]) break;   // the same decision in every block
  }

  if (rank == 0) {
    for (int e = tid; e < W * S; e += THREADS) out_tokens[e] = toks[e];
    if (tid < W) out_scores[tid] = bscore[tid];
    if (tid == 0) *out_steps = steps;
  }
  cluster.sync();   // no block leaves while another may write into it
}

// A launch configuration with one cluster of ``cl`` blocks; true when the
// card can place it.
template <typename Kernel>
bool configure(Kernel kernel, cudaLaunchConfig_t* cfg,
               cudaLaunchAttribute* attr, int cl, size_t smem,
               cudaStream_t stream) {
  cfg->gridDim = dim3(cl);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();   // a size the card refuses: try the next
    return false;
  }
  return n >= 1;
}

// Set the kernel up for ``D`` and launch it with the largest cluster the
// card places (16, else 8); the cluster size goes to ``cluster``.
template <int MW>
cudaError_t launch(const Dims& D, int device, const void* pack,
                   const void* cross, const void* memadd, void* cache,
                   void* tokens, void* scores, void* steps, int* cluster,
                   cudaStream_t stream) {
  auto kernel = decode_kernel<MW>;
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  const long long vec = 4LL * vector_words(D);
  if (vec > optin) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return e;
  const long long budget = (optin - vec) / 4;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  const int sizes[2] = {16, 8};
  for (int cl : sizes) {
    const size_t smem = (size_t)(vec + 4 * cache_words(D, cl, budget));
    if (!configure(kernel, &cfg, attr, cl, smem, stream)) continue;
    *cluster = cl;
    e = cudaLaunchKernelEx(&cfg, kernel, (const float*)pack,
                           (const float*)cross, (const float*)memadd,
                           (float*)cache, (int*)tokens, (float*)scores,
                           (int*)steps, D, budget);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }
  return cudaErrorInvalidConfiguration;   // no cluster fits the card
}

Dims dims_of(int d, int H, int L, int C, int T, int S, int W, int beam,
             int sos, int eos, int pad, float eps, float scale) {
  Dims D;
  D.d = d; D.H = H; D.L = L; D.C = C; D.T = T; D.S = S; D.W = W;
  D.beam = beam; D.sos = sos; D.eos = eos; D.pad = pad;
  D.eps = eps; D.scale = scale;
  return D;
}

}  // namespace

extern "C" {

// Bytes of shared memory a block needs besides its weight cache (the
// design's limit: it must fit one block's 227 KB).
int ishara_decoder_vector_bytes(int d, int H, int L, int C, int T, int S,
                                int W) {
  return 4 * vector_words(dims_of(d, H, L, C, T, S, W, 0, 0, 0, 0, 0, 0));
}

// Decode one sequence: tokens [W, S] int32 (row 0 of a greedy decode),
// the beams' raw log-probability scores [W], the steps run [1], and the
// cluster size used. ``pack`` holds the decoder's f32 weights in the order
// of LayerOff, ``cross`` each layer's cross-attention K transposed [d, T]
// and V [T, d], ``memadd`` [T] the additive memory mask, ``cache``
// [L, 2, W, S, d] scratch (K banks [W, d, S], V banks [W, S, d]).
int ishara_decoder_decode(int device, const void* pack, const void* cross,
                          const void* memadd, void* cache, void* tokens,
                          void* scores, void* steps, int d, int H, int L,
                          int C, int T, int S, int W, int beam, int sos,
                          int eos, int pad, float eps, float scale,
                          int* cluster, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (W < 1 || W > MAXW || W > C || H < 1 || d % H || d / H > MAXDH ||
      S < 2 || L < 1 || T < 1 || sos < 0 || sos >= C)
    return (int)cudaErrorInvalidValue;
  const int P = (W * H + 7) / 8;   // attention pairs a block, at most
  if (P > NWARPS || 32 * (NWARPS / P) < d / H)
    return (int)cudaErrorInvalidValue;
  const Dims D = dims_of(d, H, L, C, T, S, W, beam, sos, eos, pad, eps,
                         scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W == 1)
    return (int)launch<1>(D, device, pack, cross, memadd, cache, tokens,
                          scores, steps, cluster, st);
  if (W == 2)
    return (int)launch<2>(D, device, pack, cross, memadd, cache, tokens,
                          scores, steps, cluster, st);
  if (W <= 4)
    return (int)launch<4>(D, device, pack, cross, memadd, cache, tokens,
                          scores, steps, cluster, st);
  return (int)launch<8>(D, device, pack, cross, memadd, cache, tokens,
                        scores, steps, cluster, st);
}

const char* ishara_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
