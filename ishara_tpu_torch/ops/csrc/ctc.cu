// CTC loss on Hopper (sm_90a): the alpha recursion (forward pass) and the
// beta recursion with the occupancy gradient (backward pass) (K1).
//
// Replaces the Pallas kernels _alpha_kernel and _beta_kernel of
// ishara_tpu/ops/ctc_kernel.py (behind ctc_loss_kernel), together with the
// log-softmax, the emission gather, the final-state logP and the per-class
// occupancy sum that the reference leaves to XLA around them. Training
// contract only: every row uses all T frames, its label length L is its
// count of non-blank labels.
//
// What bounds it: not bytes (about 3 us of logits, labels and gradient at
// B 256, T 176, C 60) but the chain of T dependent steps of a row, each a
// three-way log-add-exp of a state and its two left (alpha) or right (beta)
// neighbours. The kernel's time is that of its slowest row's chain: a
// step is two shuffles and four ex2 / lg2 in a row (ctc_chain_floor_kernel
// times that alone), a lane's K states cost K times the ex2 / lg2, and the
// chain shares its SM's shared-memory and special-function queues with the
// warps that feed it (PERF.md).
//
// Design, one block a batch row, its warps in three roles:
// - The chain: one warp holds the row's own n = 2L + 1 states in registers,
//   K = ceil(n / 32) contiguous states a lane (up to 256 states), and steps
//   only those (states >= n stand for -1e30 and are never
//   stepped: in alpha no valid state reads them, in beta they read as
//   -1e30, as the reference's masks make them). A lane takes its left (or
//   right) neighbours' values from the lane beside it with two shuffles;
//   there is no block barrier in the step loop. Above 256 states the chain
//   spans W warps that pass their two edge states through shared memory
//   each step and meet at a named barrier of the chain's warps only.
// - Producer warps, one a slot of a ring of shared-memory chunks (tc
//   frames a chunk, ns chunks deep, an mbarrier a slot), copy each chunk's
//   logits ([tc, C], contiguous) in (where C is too wide for the ring, they
//   read device memory), compute each frame's log-softmax normaliser (a
//   lane a frame) and the chunk's emission table (x[t, ext[s]] - max) -
//   log-sum for the valid states, ahead of the chain, which waits once a
//   chunk and never touches device memory for an emission. Backward, they
//   walk the chunks in reverse and stage alpha's valid states of the same
//   frames beside them.
// - Backward only, gradient warps take each chunk the chain has finished --
//   the chain writes each frame's occupancies exp(min(alpha + beta - logP,
//   0)) over the staged alpha -- and write the chunk's [tc, C] gradient
//   rows, softmax - occupancy, times dy: every class's softmax first, then
//   the row's own classes again with their occupancies, summed in a fixed
//   order (the blank's even states by a warp's shuffle tree, each label
//   class along its list of positions), so that a second launch gives the
//   same bits. No atomics.
// The forward writes alpha for the valid states only (and only when the
// backward will need it); the backward reads those only.
//
// Arithmetic: the reference's, step for step -- lae(lae(a, b), c) with the
// -1e30 guard, the additive skip mask, the be = beta + emit carry, exp(min(
// gamma, 0)) -- with the chain's log-add-exp taken by the ex2 / lg2 units.
// A one-max three-way form, or a log2 domain, rounds differently at every
// step, and at T 1024 that moves the gradient away from the reference's own
// kernel by more than the tolerance the port is held to there. The
// log-softmax normaliser, the occupancies and the gradient rows are off the
// chain and take full-precision expf / logf: through ex2 / lg2 (about 2 ulp
// each) the gradient norm of a 400-frame training step on the card drifted
// 1.03e-4 from the same step's on the CPU.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

// A producer warp a ring slot (a producer that waited on a slot's mbarrier
// two phases ahead would pass at once), and six gradient warps: the chain
// outpaces fewer of either.
constexpr int GRAD_WARPS = 6;
constexpr int MAX_CHAIN_WARPS = 22;  // 16 states a lane: 11264 states
constexpr size_t SMEM_PAIR = 113 * 1024;  // two blocks an SM
constexpr size_t SMEM_LIMIT = 227 * 1024;

// States a lane K and chain warps W for a row of n states: one warp of
// ceil(n / 32) states a lane up to 256 states, then warps of 8 states a
// lane up to 9 warps, then of 16.
__host__ __device__ inline void chain_shape(int n, int* K, int* W) {
  int k = (n + 31) / 32, w = 1;
  if (k > 8) k = 8, w = (n + 255) / 256;
  if (w > 9) k = 16, w = (n + 511) / 512;
  *K = k;
  *W = w;
}

// A frame's states in the ring: every lane's K states, so that the chain
// stores without a branch.
__host__ __device__ inline int padded_states(int U) {
  int K, W;
  chain_shape(2 * U + 1, &K, &W);
  return 32 * K * W;
}

// Shared memory (bytes) of a launch: mbarriers (3 a slot) | ring [ns][tc]
// [nps] emissions | backward: ring [ns][tc][nps] alpha -> occupancy |
// staged: ring [ns][tc][C] logits | [ns][tc][2] (max, log-sum) | labels
// [U] | backward: next [U], head [U] | edges [2][32][2] | final states [4]
// | reduction [32].
__host__ __device__ inline size_t smem_bytes(int U, int C, bool bwd,
                                             bool stage, int tc, int ns) {
  const size_t slots = (size_t)ns * tc;
  const size_t ring = slots * padded_states(U);
  size_t words = (bwd ? 2 * ring : ring) + 2 * slots +
                 (stage ? slots * C : 0) + (size_t)(bwd ? 3 : 1) * U + 128 +
                 4 + 32;
  return 3 * (size_t)ns * 8 + words * 4;
}

// Frames a chunk and chunks in the ring, and whether the chunks' logits are
// staged beside them: the deepest of 16 x 4 down to 1 x 2, staged where
// possible, that leaves room for two blocks an SM, else one block an SM.
bool plan(int U, int C, bool bwd, int* tc, int* ns, int* stage) {
  const size_t limits[2] = {SMEM_PAIR, SMEM_LIMIT};
  for (size_t limit : limits)
    for (int st = 1; st >= 0; --st)
      for (int t = 16; t >= 1; t /= 2)
        for (int s = 4; s >= 2; s -= 2)
          if (smem_bytes(U, C, bwd, st, t, s) <= limit) {
            *tc = t, *ns = s, *stage = st;
            return true;
          }
  return false;
}

bool fits(int T, int C, int U) {
  int tc, ns, st;
  return T >= 1 && C >= 1 && U >= 0 &&
         2 * (size_t)U + 1 <= (size_t)MAX_CHAIN_WARPS * 512 &&
         plan(U, C, true, &tc, &ns, &st);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log(exp(a) + exp(b)), -1e30 when both are: the larger term's exp is 1.
__device__ __forceinline__ float lae2(float a, float b) {
  const float m = fmaxf(a, b);
  const float r = m + lg2(1.f + ex2((fminf(a, b) - m) * LOG2E)) * LN2;
  return m <= NEG ? NEG : r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits, a whole warp, for the phase of ``bar`` with this parity; the warp
// leaves converged (its lanes may see the phase complete at different
// tries, and a diverged warp would take the slow path of every shuffle).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred P1;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, P1;\n\t}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  __syncwarp();
}

// An asynchronous 4-byte copy from device to shared memory (cp.async);
// copy_wait waits for all of this thread's.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// The chain's warps only (named barrier 1).
__device__ __forceinline__ void chain_sync(int W) {
  if (W > 1)
    asm volatile("bar.sync 1, %0;\n" ::"r"(32 * W) : "memory");
  else
    __syncwarp();
}

struct Row {
  const float* x;  // logits of the row, [T, C]
  int T, C, S, blank, L, n, nps, tc, ns;
  uint64_t* full;   // [ns] producer -> chain
  uint64_t* empty;  // [ns] consumer -> producer
  uint64_t* ready;  // [ns] backward: chain -> gradient warps
  float* em;        // [ns][tc][nps] emissions (forward: then alpha)
  float* ap;        // [ns][tc][nps] backward: alpha, then occupancy
  float* xs;        // [ns][tc][C] the chunks' logits, or null (not staged)
  float* hdr;       // [ns][tc][2] max, log-sum
  int* lab;         // [U] clamped labels
  int* next;        // [U] backward: next position of the same class, or -1
  int* head;        // [U] backward: 1 at a class's first position
  float* edges;     // [2][32][2]
  float* fin;       // [4]
  int* red;         // [32]
  int bhead;        // backward: the first position labelled blank, or -1
};

__device__ __forceinline__ int ext(const Row& r, int s) {
  return (s & 1) ? r.lab[s >> 1] : r.blank;
}

__device__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// Carves the block's shared memory, loads the labels and counts L, inits
// the ring's mbarriers (a slot is freed by the chain forward, by the
// ``grad_warps`` gradient warps backward); backward, also the class lists.
// Ends with the block's last barrier.
__device__ __forceinline__ Row setup(const float* logits, const int* labels,
                                     int T, int C, int U, int blank, int tc,
                                     int ns, bool stage, bool bwd,
                                     int grad_warps) {
  extern __shared__ __align__(16) unsigned char smem[];
  Row r;
  const int b = blockIdx.x, nt = blockDim.x;
  r.x = logits + (size_t)b * T * C;
  r.T = T, r.C = C, r.S = 2 * U + 1, r.blank = blank;
  r.nps = padded_states(U), r.tc = tc, r.ns = ns;
  r.full = reinterpret_cast<uint64_t*>(smem);
  r.empty = r.full + ns;
  r.ready = r.empty + ns;
  float* f = reinterpret_cast<float*>(r.ready + ns);
  const size_t ring = (size_t)ns * tc * r.nps;
  r.em = f, f += ring;
  r.ap = bwd ? f : nullptr, f += bwd ? ring : 0;
  r.xs = stage ? f : nullptr, f += stage ? (size_t)ns * tc * C : 0;
  r.hdr = f, f += 2 * ns * tc;
  r.lab = reinterpret_cast<int*>(f);
  r.next = r.lab + U;
  r.head = r.next + (bwd ? U : 0);
  r.edges = reinterpret_cast<float*>(r.head + (bwd ? U : 0));
  r.fin = r.edges + 128;
  r.red = reinterpret_cast<int*>(r.fin + 4);

  const int* lb = labels + (size_t)b * U;
  int cnt = 0;
  for (int u = threadIdx.x; u < U; u += nt) {
    // a label outside [0, C) is clamped: it can then never index past a row
    r.lab[u] = min(max(lb[u], 0), C - 1);
    cnt += lb[u] != blank;
  }
  r.L = block_sum(cnt, r.red);  // its barriers also publish lab
  r.n = 2 * r.L + 1;
  int K, W;
  chain_shape(r.n, &K, &W);
  if (threadIdx.x == 0) {
    for (int i = 0; i < ns; ++i) {
      mbar_init(&r.full[i], 32);
      mbar_init(&r.empty[i], bwd ? 32 * grad_warps : 32 * W);
      mbar_init(&r.ready[i], 32 * W);
    }
    r.red[0] = -1;
  }
  if (bwd) {
    __syncthreads();  // red[0]
    for (int u = threadIdx.x; u < r.L; u += nt) {
      const int c = r.lab[u];
      int nx = -1, first = 1;
      for (int v = u + 1; v < r.L && nx < 0; ++v)
        if (r.lab[v] == c) nx = v;
      for (int v = 0; v < u && first; ++v)
        if (r.lab[v] == c) first = 0;
      r.next[u] = nx;
      r.head[u] = first && c != blank;
      if (first && c == blank) r.red[0] = u;  // one position only
    }
  }
  __syncthreads();
  r.bhead = r.red[0];
  return r;
}

// ---------------------------------------------------------------------------
// The chain: alpha forward, beta and occupancies backward
// ---------------------------------------------------------------------------

// The chain's lane holds states s0 .. s0 + K - 1; MULTI when the row's
// chain spans several warps (then K is 8 or 16), which pass their edge
// states through shared memory each step. Each step's values go over the
// emissions it read, every lane's K of them: a store under a condition
// would cost a divergent branch (and its convergence barrier) a state a
// step. The producer copies the finished chunks of alpha out.
template <int K, bool MULTI>
__device__ __forceinline__ void alpha_chain(const Row& r, int w, int W,
                                            float* nll) {
  const int lane = threadIdx.x & 31;
  const int s0 = (w * 32 + lane) * K;
  const int n = r.n, T = r.T, tc = r.tc, ns = r.ns;
  // Additive masks, as the reference's (0 or -1e30): a select would let
  // the compiler branch around the log-add-exps of a lane's dead states.
  // A dead state's emission reads as -1e30, which keeps it at -1e30 or
  // below, as the reference's valid mask does (no valid state reads it).
  bool live[K];
  float skip[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = s0 + k;  // a label state whose label differs two back
    live[k] = s < n;
    skip[k] = (s & 1) && s >= 3 && live[k] &&
                      r.lab[s >> 1] != r.lab[(s >> 1) - 1]
                  ? 0.f
                  : NEG;
  }
  const float edge = lane == 0 ? NEG : 0.f, edge2 = lane < 2 ? NEG : 0.f;
  float a[K];
  for (int kc = 0, t = 0; t < T; ++kc) {
    const int slot = kc % ns, end = min(t + tc, T);
    mbar_wait(&r.full[slot], (kc / ns) & 1);
    float* e = r.em + (size_t)slot * tc * r.nps + s0;
    for (; t < end; ++t, e += r.nps) {
      float em[K];
#pragma unroll
      for (int k = 0; k < K; ++k) em[k] = live[k] ? e[k] : NEG;
      if (t == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) a[k] = (s0 + k < 2 ? 0.f : NEG) + em[k];
      } else {
        // the lane's two left neighbours, states s0 - 1 and s0 - 2: in the
        // lane below, or none (-1e30 added) at the warp's foot
        float l1 = __shfl_up_sync(FULL, a[K - 1], 1);
        float l2 = K == 1 ? __shfl_up_sync(FULL, a[0], 2)
                          : __shfl_up_sync(FULL, a[K > 1 ? K - 2 : 0], 1);
        if (MULTI && w > 0 && lane == 0) {
          const float* ed = r.edges + (((t - 1) & 1) * 32 + w - 1) * 2;
          l1 = ed[0], l2 = ed[1];
        } else {
          l1 += edge;
          l2 += K == 1 ? edge2 : edge;
        }
        float na[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float p1 = k >= 1 ? a[k > 0 ? k - 1 : 0] : l1;
          const float p2 =
              (k >= 2 ? a[k > 1 ? k - 2 : 0] : (k == 1 ? l1 : l2)) + skip[k];
          na[k] = lae2(lae2(a[k], p1), p2) + em[k];
        }
#pragma unroll
        for (int k = 0; k < K; ++k) a[k] = na[k];
      }
#pragma unroll
      for (int k = 0; k < K; ++k) e[k] = a[k];  // alpha over the emission
      if (MULTI) {  // the warp's top two states, for the warp above
        if (lane == 31) {
          float* ed = r.edges + ((t & 1) * 32 + w) * 2;
          ed[0] = a[K - 1];
          ed[1] = a[K > 1 ? K - 2 : 0];
        }
        chain_sync(W);
      }
    }
    mbar_arrive(&r.empty[slot]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (s0 + k == n - 2) r.fin[0] = a[k];
    if (s0 + k == n - 1) r.fin[1] = a[k];
  }
  chain_sync(W);
  if (w == 0 && lane == 0)
    *nll = -lae2(r.L > 0 ? r.fin[0] : NEG, r.fin[1]);
}

template <int K, bool MULTI>
__device__ __forceinline__ void beta_chain(const Row& r, int w, int W,
                                           float logp) {
  const int lane = threadIdx.x & 31;
  const int s0 = (w * 32 + lane) * K;
  const int n = r.n, T = r.T, tc = r.tc, ns = r.ns;
  bool live[K];  // additive masks, as in alpha_chain
  float skip[K], fin[K];  // a skip out of s lands at s + 2
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = s0 + k;
    live[k] = s < n;
    skip[k] = (s & 1) && s + 2 < n && r.lab[(s >> 1) + 1] != r.lab[s >> 1]
                  ? 0.f
                  : NEG;
    fin[k] = (s == n - 1 || (s == n - 2 && r.L > 0)) ? 0.f : NEG;
  }
  const float edge = lane == 31 ? NEG : 0.f, edge2 = lane > 29 ? NEG : 0.f;
  float be[K];
  for (int kc = 0, i = 0; i < T; ++kc) {
    const int slot = kc % ns, end = min(i + tc, T);
    mbar_wait(&r.full[slot], (kc / ns) & 1);
    const size_t base = (size_t)slot * tc * r.nps + s0;
    const float* e = r.em + base;
    float* ap = r.ap + base;
    for (; i < end; ++i, e += r.nps, ap += r.nps) {
      float em[K], al[K], beta[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        em[k] = live[k] ? e[k] : NEG;
        al[k] = live[k] ? ap[k] : 0.f;
      }
      if (i == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) beta[k] = fin[k];
      } else {
        // the lane's two right neighbours, states s0 + K and s0 + K + 1
        float r1 = __shfl_down_sync(FULL, be[0], 1);
        float r2 = K == 1 ? __shfl_down_sync(FULL, be[0], 2)
                          : __shfl_down_sync(FULL, be[K > 1 ? 1 : 0], 1);
        if (MULTI && w + 1 < W && lane == 31) {
          const float* ed = r.edges + (((i - 1) & 1) * 32 + w + 1) * 2;
          r1 = ed[0], r2 = ed[1];
        } else {
          r1 += edge;
          r2 += K == 1 ? edge2 : edge;
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float n1 = k + 1 < K ? be[k + 1 < K ? k + 1 : 0] : r1;
          const float n2 = (k + 2 < K ? be[k + 2 < K ? k + 2 : 0]
                                      : (k + 1 < K ? r1 : r2)) +
                           skip[k];
          beta[k] = lae2(lae2(be[k], n1), n2);
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        be[k] = beta[k] + em[k];  // -1e30 or below at a dead state
        ap[k] = expf(fminf(al[k] + beta[k] - logp, 0.f));
      }
      if (MULTI) {  // the warp's bottom two states, for the warp below
        if (lane == 0) {
          float* ed = r.edges + ((i & 1) * 32 + w) * 2;
          ed[0] = be[0];
          ed[1] = be[K > 1 ? 1 : 0];
        }
        chain_sync(W);
      }
    }
    mbar_arrive(&r.ready[slot]);
  }
}

// ---------------------------------------------------------------------------
// Producers and gradient warps
// ---------------------------------------------------------------------------

// The frames of chunk kc in memory order (the chunk's lowest frame first):
// its staged logits, or the row's in device memory.
__device__ __forceinline__ const float* chunk_rows(const Row& r, int kc,
                                                   int slot, int nf,
                                                   bool bwd) {
  if (r.xs != nullptr) return r.xs + (size_t)slot * r.tc * r.C;
  const int first = kc * r.tc;
  return r.x + (size_t)(bwd ? r.T - first - nf : first) * r.C;
}

// Forward: the valid states of chunk kc's alpha, which the chain left in
// its slot, out to device memory.
__device__ __forceinline__ void flush_alpha(const Row& r, int kc,
                                            float* alpha) {
  const int lane = threadIdx.x & 31;
  const int first = kc * r.tc, nf = min(r.tc, r.T - first);
  const float* src = r.em + (size_t)(kc % r.ns) * r.tc * r.nps;
  for (int j = 0; j < nf; ++j) {
    float* out = alpha + (size_t)(first + j) * r.S;
    for (int s = lane; s < r.n; s += 32) out[s] = src[(size_t)j * r.nps + s];
  }
}

// Chunks pw, pw + P, ...: the chunk's logits staged (one coalesced copy),
// each frame's (max, log-sum) a lane a frame, then the chunk's emissions of
// the valid states; backward (frames in reverse), also alpha's valid states
// of the same frames (alpha_in). Forward, the alpha of each slot's last
// chunk goes out (alpha_out) before the slot takes the next.
__device__ __forceinline__ void produce(const Row& r, int pw, int P,
                                        const float* alpha_in,
                                        float* alpha_out) {
  const int lane = threadIdx.x & 31;
  const int nch = (r.T + r.tc - 1) / r.tc, C = r.C;
  const bool bwd = alpha_in != nullptr;
  const float* alpha = alpha_in;
  for (int kc = pw; kc < nch; kc += P) {
    const int slot = kc % r.ns, use = kc / r.ns;
    if (use > 0) {
      mbar_wait(&r.empty[slot], (use - 1) & 1);
      if (alpha_out != nullptr) flush_alpha(r, kc - r.ns, alpha_out);
    }
    const int first = kc * r.tc, nf = min(r.tc, r.T - first);
    const float* rows = chunk_rows(r, kc, slot, nf, bwd);
    if (bwd) {  // alpha's valid states of the chunk's frames, in flight
      for (int j = 0; j < nf; ++j) {
        const float* arow = alpha + (size_t)(r.T - 1 - (first + j)) * r.S;
        float* dst = r.ap + ((size_t)slot * r.tc + j) * r.nps;
        for (int s = lane; s < r.n; s += 32) copy4(dst + s, arow + s);
      }
    }
    if (r.xs != nullptr) {
      const float* src = r.x + (size_t)(bwd ? r.T - first - nf : first) * C;
      float* xs = r.xs + (size_t)slot * r.tc * C;
      for (int i = lane; i < nf * C; i += 32) copy4(xs + i, src + i);
      copy_wait();
      __syncwarp();
    }
    float* h = r.hdr + (size_t)slot * r.tc * 2;
    if (lane < nf) {
      const float* row = rows + (size_t)(bwd ? nf - 1 - lane : lane) * C;
      float m = -INFINITY, sum = 0.f;
#pragma unroll 4
      for (int c = 0; c < C; ++c) m = fmaxf(m, row[c]);
#pragma unroll 4
      for (int c = 0; c < C; ++c) sum += expf(row[c] - m);
      h[2 * lane] = m;
      h[2 * lane + 1] = logf(sum);
    }
    __syncwarp();
    // the emissions, a lane a state, four frames' loads before their stores
    for (int s = lane; s < r.n; s += 32) {
      const int c = ext(r, s);
      float* e = r.em + (size_t)slot * r.tc * r.nps + s;
      for (int j0 = 0; j0 < nf; j0 += 4) {
        float v[4], m[4], l[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = min(j0 + q, nf - 1);
          v[q] = rows[(size_t)(bwd ? nf - 1 - j : j) * C + c];
          m[q] = h[2 * j], l[q] = h[2 * j + 1];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j0 + q < nf) e[(size_t)(j0 + q) * r.nps] = (v[q] - m[q]) - l[q];
      }
    }
    if (bwd) copy_wait();
    mbar_arrive(&r.full[slot]);
  }
  if (alpha_out != nullptr)  // the chunks no later chunk displaces
    for (int kc = pw; kc < nch; kc += P)
      if (kc + r.ns >= nch) {
        mbar_wait(&r.empty[kc % r.ns], (kc / r.ns) & 1);
        flush_alpha(r, kc, alpha_out);
      }
}

// Every chunk, frames gw, gw + G, ...: the gradient rows softmax * dy, then
// the row's own classes (softmax - occupancy) * dy over them.
__device__ __forceinline__ void gradient(const Row& r, int gw, int G, float g,
                                         float* grad) {
  const int lane = threadIdx.x & 31;
  const int nch = (r.T + r.tc - 1) / r.tc;
  for (int kc = 0; kc < nch; ++kc) {
    const int slot = kc % r.ns;
    mbar_wait(&r.ready[slot], (kc / r.ns) & 1);
    const int first = kc * r.tc, nf = min(r.tc, r.T - first);
    const float* rows = chunk_rows(r, kc, slot, nf, true);
    for (int j = gw; j < nf; j += G) {
      const int t = r.T - 1 - (first + j);
      const float* p = r.ap + ((size_t)slot * r.tc + j) * r.nps;
      const float mx = r.hdr[(slot * r.tc + j) * 2];
      const float ls = r.hdr[(slot * r.tc + j) * 2 + 1];
      const float* row = rows + (size_t)(nf - 1 - j) * r.C;
      float* out = grad + (size_t)t * r.C;
      for (int c = lane; c < r.C; c += 32)
        out[c] = expf((row[c] - mx) - ls) * g;
      float ob = 0.f;  // the blank's even states
      for (int s = 2 * lane; s < r.n; s += 64) ob += p[s];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ob += __shfl_xor_sync(FULL, ob, o);
      __syncwarp();  // the softmax rows are written before any is replaced
      if (lane == 0) {
        for (int u = r.bhead; u >= 0; u = r.next[u]) ob += p[2 * u + 1];
        out[r.blank] =
            (expf((row[r.blank] - mx) - ls) - ob) * g;
      }
      for (int u = lane; u < r.L; u += 32) {
        if (!r.head[u]) continue;
        const int c = r.lab[u];
        float occ = 0.f;
        for (int v = u; v >= 0; v = r.next[v]) occ += p[2 * v + 1];
        out[c] = (expf((row[c] - mx) - ls) - occ) * g;
      }
    }
    mbar_arrive(&r.empty[slot]);
  }
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// KMAX: the most states a lane of the launch's widest row holds; THREADS:
// the most threads of its block (so the register budget of one-warp chains
// is not cut to that of the widest).
template <int KMAX, int THREADS>
__global__ void __launch_bounds__(THREADS)
    ctc_alpha_kernel(const float* __restrict__ logits,
                     const int* __restrict__ labels, int T, int C, int U,
                     int blank, int tc, int ns, int stage,
                     float* __restrict__ alpha, float* __restrict__ nll) {
  const Row r =
      setup(logits, labels, T, C, U, blank, tc, ns, stage, false, 0);
  const int warp = threadIdx.x >> 5;
  const int WL = (int)(blockDim.x >> 5) - ns;
  const int b = blockIdx.x;
  if (warp >= WL) {
    produce(r, warp - WL, ns, nullptr,
            alpha == nullptr ? nullptr : alpha + (size_t)b * T * r.S);
    return;
  }
  int K, W;
  chain_shape(r.n, &K, &W);
  if (warp >= W) return;
  float* y = nll + b;
  switch (W > 1 ? K + 8 : K) {
    case 1: alpha_chain<1, false>(r, warp, W, y); break;
    case 2: alpha_chain<2, false>(r, warp, W, y); break;
    case 3: alpha_chain<3, false>(r, warp, W, y); break;
    case 4: alpha_chain<4, false>(r, warp, W, y); break;
    case 5: alpha_chain<5, false>(r, warp, W, y); break;
    case 6: alpha_chain<6, false>(r, warp, W, y); break;
    case 7: alpha_chain<7, false>(r, warp, W, y); break;
    case 8: alpha_chain<8, false>(r, warp, W, y); break;
    case 16: alpha_chain<8, true>(r, warp, W, y); break;
    default:
      if (KMAX >= 16) alpha_chain<KMAX, true>(r, warp, W, y);
  }
}

template <int KMAX, int THREADS>
__global__ void __launch_bounds__(THREADS)
    ctc_beta_kernel(const float* __restrict__ logits,
                    const int* __restrict__ labels,
                    const float* __restrict__ alpha,
                    const float* __restrict__ nll,
                    const float* __restrict__ dy, int T, int C, int U,
                    int blank, int tc, int ns, int stage,
                    float* __restrict__ grad) {
  const Row r =
      setup(logits, labels, T, C, U, blank, tc, ns, stage, true, GRAD_WARPS);
  const int warp = threadIdx.x >> 5;
  const int WL = (int)(blockDim.x >> 5) - ns - GRAD_WARPS;
  const int b = blockIdx.x;
  if (warp >= WL + ns) {
    gradient(r, warp - WL - ns, GRAD_WARPS, dy[b],
             grad + (size_t)b * T * C);
    return;
  }
  if (warp >= WL) {
    produce(r, warp - WL, ns, alpha + (size_t)b * T * r.S, nullptr);
    return;
  }
  int K, W;
  chain_shape(r.n, &K, &W);
  if (warp >= W) return;
  const float logp = -nll[b];
  switch (W > 1 ? K + 8 : K) {
    case 1: beta_chain<1, false>(r, warp, W, logp); break;
    case 2: beta_chain<2, false>(r, warp, W, logp); break;
    case 3: beta_chain<3, false>(r, warp, W, logp); break;
    case 4: beta_chain<4, false>(r, warp, W, logp); break;
    case 5: beta_chain<5, false>(r, warp, W, logp); break;
    case 6: beta_chain<6, false>(r, warp, W, logp); break;
    case 7: beta_chain<7, false>(r, warp, W, logp); break;
    case 8: beta_chain<8, false>(r, warp, W, logp); break;
    case 16: beta_chain<8, true>(r, warp, W, logp); break;
    default:
      if (KMAX >= 16) beta_chain<KMAX, true>(r, warp, W, logp);
  }
}

// One warp, T steps of the chain's dependent arithmetic alone (two
// shuffles and two log-add-exps a step, no loads): the least time any
// kernel that steps this recursion frame by frame can take.
__global__ void ctc_chain_floor_kernel(int T, float* out) {
  const int lane = threadIdx.x & 31;
  float a = -0.25f * lane;
  for (int t = 0; t < T; ++t) {
    float l1 = __shfl_up_sync(FULL, a, 1), l2 = __shfl_up_sync(FULL, a, 2);
    if (lane == 0) l1 = NEG;
    if (lane < 2) l2 = NEG;
    a = lae2(lae2(a, l1), l2) - 0.5f;
  }
  out[lane] = a;
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// 1 when the kernels take a row of T frames, C classes and U labels: the
// chain's warps within a block and the ring's smallest plan (one frame a
// chunk, two chunks, logits not staged) within a block's shared memory.
// T and C do not bound shared memory.
int ishara_ctc_fits(int T, int C, int U) { return fits(T, C, U) ? 1 : 0; }

// The launch plan for U labels and C classes: out = {K, W, tc, ns, stage,
// bytes} of the widest row (2U + 1 states), forward (backward = 0) or
// backward; 0 when none fits.
int ishara_ctc_plan(int U, int C, int backward, int* out) {
  int K, W, tc, ns, st;
  chain_shape(2 * U + 1, &K, &W);
  if (!plan(U, C, backward != 0, &tc, &ns, &st)) return 0;
  out[0] = K, out[1] = W, out[2] = tc, out[3] = ns, out[4] = st;
  out[5] = (int)smem_bytes(U, C, backward != 0, st, tc, ns);
  return 1;
}

// nll[b] = -log P(labels[b] | logits[b]) for logits [B, T, C] f32 and labels
// [B, U] int32 padded with blank; alpha [B, T, S] (S = 2U + 1) is written
// at each row's valid states for the backward pass when the pointer is not
// null.
int ishara_ctc_alpha(int device, const void* logits, const void* labels,
                     int B, int T, int C, int U, int blank, void* alpha,
                     void* nll, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0) return 0;
  int tc, ns, st, K, W;
  if (!fits(T, C, U) || blank < 0 || blank >= C ||
      !plan(U, C, false, &tc, &ns, &st))
    return (int)cudaErrorInvalidValue;
  chain_shape(2 * U + 1, &K, &W);
  const size_t smem = smem_bytes(U, C, false, st, tc, ns);
  const int threads = 32 * (W + ns);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one-warp chains: 5 warps, but a bound of 256 threads compiled faster
  // than 160
  auto kernel = W == 1   ? ctc_alpha_kernel<8, 256>
                : K <= 8 ? ctc_alpha_kernel<8, 32 * (9 + 4)>
                         : ctc_alpha_kernel<16, 32 * (MAX_CHAIN_WARPS + 4)>;
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, threads, smem, s>>>((const float*)logits, (const int*)labels,
                                  T, C, U, blank, tc, ns, st, (float*)alpha,
                                  (float*)nll);
  return (int)cudaGetLastError();
}

// grad [B, T, C] = dy[b] * d nll[b] / d logits, from the alpha and nll of
// ishara_ctc_alpha on the same inputs.
int ishara_ctc_beta(int device, const void* logits, const void* labels,
                    const void* alpha, const void* nll, const void* dy, int B,
                    int T, int C, int U, int blank, void* grad, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0) return 0;
  int tc, ns, st, K, W;
  if (!fits(T, C, U) || blank < 0 || blank >= C ||
      !plan(U, C, true, &tc, &ns, &st))
    return (int)cudaErrorInvalidValue;
  chain_shape(2 * U + 1, &K, &W);
  const size_t smem = smem_bytes(U, C, true, st, tc, ns);
  const int threads = 32 * (W + ns + GRAD_WARPS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel =
      W == 1   ? ctc_beta_kernel<8, 32 * (1 + 4 + GRAD_WARPS)>
      : K <= 8 ? ctc_beta_kernel<8, 32 * (9 + 4 + GRAD_WARPS)>
               : ctc_beta_kernel<16, 32 * (MAX_CHAIN_WARPS + 4 + GRAD_WARPS)>;
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, threads, smem, s>>>((const float*)logits, (const int*)labels,
                                  (const float*)alpha, (const float*)nll,
                                  (const float*)dy, T, C, U, blank, tc, ns,
                                  st, (float*)grad);
  return (int)cudaGetLastError();
}

// One warp of T bare chain steps (see ctc_chain_floor_kernel); out [32].
int ishara_ctc_chain_floor(int device, int T, void* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  ctc_chain_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      T, (float*)out);
  return (int)cudaGetLastError();
}

const char* ishara_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
