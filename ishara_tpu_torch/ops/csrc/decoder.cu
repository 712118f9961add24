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
// tensor cores have nothing to do, and a step is a chain of dependent
// stages whose cost is latency -- shared-memory loads (~40 cycles on the
// H100), shuffles (~33), the exchanges between blocks -- not bytes or
// operations. The weights do not fit one SM (227 KB of shared memory),
// nor one cluster's 16 (3.6 MB). The design is ONE thread-block cluster of
// 16 blocks (non-portable size; 8 where the card cannot place 16) of 512
// threads, and 3 L + 1 stages a step:
//
// - The attention work comes in units. Where the cluster has at least
//   twice as many blocks as a layer has heads, a unit is a part of a head:
//   its Dh columns split over Pc = CL / H blocks (2 at 8 heads, 8 at 2),
//   every layer's heads on the same blocks, so that all of them work in
//   every attention stage; else a unit is a (layer, head) pair on block
//   (l H + h) % CL. In the self-attention stage of layer l a unit's block
//   computes its columns of the head's q / k / v, writes k and v into its
//   cache (in its shared memory), takes the dot products of its columns
//   -- partial scores, sent to the head's other blocks and added there in
//   part order, so that every block of the head holds the same scores --
//   runs the softmax and its columns of the context, and multiplies them by
//   its columns of the out projection: a partial [W, d]. The
//   cross-attention stage does the same with the cross q, its cross K / V
//   (loaded into shared memory once, at launch) and the cross out
//   projection. The FFN stage splits the 4d hidden rows over the blocks:
//   fc1's rows with relu, then the partial of fc2's matching columns. The
//   classifier stage splits the classes and sends each block's logits to
//   every block.
// - A stage ends in an exchange, not a barrier: column slice s of every
//   partial goes to block s (st.async, completing on s's mbarrier), which
//   adds the partials in rank order, the bias and the residual, and sends
//   its slice of the new x to every block. Every block then holds the same
//   x, bit for bit, and computes the next LayerNorm itself. The sums never
//   depend on timing: the same input gives the same bits on every run.
//   (A cluster barrier with release semantics costs ~1400 cycles; the
//   exchange replaced it and the pull of 16 partials a column.)
// - Shared memory, by priority: the fixed layout (x twice, the partials'
//   slots, scores, beam state, the biases and norms a block uses), a
//   staging ring of two slots (48 KB greedy, 24 KB beam), the units'
//   self-attention caches ([W, S, nc] K and V banks), the units' cross
//   K / V, then the weights that fit -- the first product of each stage
//   first (needed right after an exchange), then the others. The rest is
//   copied at launch into a global scratch, segment by segment in the
//   order a step reads it, and streams back through the ring by TMA bulk
//   copies (cp.async.bulk under mbarriers), each slot refilled as soon as
//   it is read, so the next segment is in flight while the current one is
//   used. Caches or cross K / V that do not fit stay in global memory
//   (beams 8 and 12 at the reference geometry). decode_plan in
//   ops/decoder_kernel.py mirrors this plan.
// - Products: a product's rows are laid out in tiles of 32 / g rows (g
//   lanes a row, as few as keep the block's threads busy), [Kg / g][R][g]
//   a tile, so that a warp reads 32 neighbouring words at each step; all
//   of a pass's beams at once (4 at most), so a weight is read once a pass.
// - The beam reorder never copies a cache: bank w's row p is written once,
//   at step p, by whichever beam held slot w then, so a table of (token,
//   bank) for each beam's rows is reordered instead -- the same values as
//   the reference's reordered copies. The stable top W ranks each total
//   in its row, then the W^2 row candidates among themselves.
//
// On the H100 (80GB HBM3, 700 W; chip_smoke.py, PERF.md) at the reference
// geometry (dim 208, 8 heads, 2 + 2 layers, T 176, 63 steps) a greedy step
// takes about 46 us and a beam-4 step about 86 us (the first design: 62
// and 118), against about 0.04 / 0.17 us by the bound: latency binds. A
// block keeps 53 KB (greedy) or 35 KB (beam 4) of its ~306 KB of weights
// resident and streams ~250-270 KB a step; the ring's waits are about 1 us
// a step. What a step spends (a clock split, PERF.md): every phase --
// LayerNorm, each product, the scores, the softmax, the context, each
// exchange -- is a chain of dependent loads, shuffles and block barriers
// of ~0.5-2 us whatever its size, so splitting a head's columns halves the
// q / k / v product and little else: it gains ~10% at beam 4 and nothing
// at greedy, and 3x at 2 heads of 160, where it splits real work.
//
// Tried and not kept: a release cluster barrier after each stage with the
// partials pulled from 16 blocks (~1400 + ~1200 cycles a stage, replaced
// by the exchange); weights read by plain loads from L2 (the first
// design); the products' loads batched 8 steps ahead (register spills at
// 4 beams); 8 beams a pass (spills); the softmax row held in registers
// (slower: an expf for every slot); a softmax row over several warps
// combined through shared memory (two more block barriers: slower); the
// ring's copies issued by thread 0 with a search of the piece table (its
// ~1000 cycles held up warp 0's tile; the table now holds each streamed
// piece's offsets, and an idle warp issues). One code path for every
// stage kind is kept for its size (12 k instructions against 17 k), not
// its speed.
//
// Arithmetic as the reference kernel: two-pass LayerNorm (flax's module is
// fast-variance: a rounding difference only; the means as sums times
// 1 / d), additive -1e30 masks (the
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
// The ring's producer: lane 0 of the last warp, which a product of fewer
// tiles than warps leaves idle, so that a copy is issued beside the
// product rather than after it (tid 0 holds up warp 0's tile).
constexpr int ISSUER = THREADS - 32;
// A ring slot: 48 KB greedy, 24 KB for beams (or one row, if wider). Set
// by measurement on the H100 at the reference geometry (PERF.md):
// the slot trades resident weights against segments a step, and the best
// trade differs with W (16 to 56 KB tried).
constexpr int SLOT_FLOATS_GREEDY = 12288;
constexpr int SLOT_FLOATS_BEAM = 6144;
constexpr int SLOTS = 2;   // the ring's slots, indexed by parity
constexpr int PIECE_INTS = 12;  // kind, idx, N, K, resident offset, rows
                                // a segment, lanes a row g, K padded to g;
                                // streamed: scratch offset, segments, the
                                // last one's floats, the next streamed piece
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

__host__ __device__ inline long long align4(long long w) {
  return (w + 3) / 4 * 4;
}

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The products a block runs, in the order a step consumes them ("pieces"):
// for each layer, the self-attention's q / k / v rows of each of the
// block's heads (QKV, 3 Dh rows of d) and that head's columns of the out
// projection (O, d rows of Dh), then the same for the cross-attention (CQ,
// CO), then the block's FFN rows (F1, R rows of d) and fc2's matching
// columns (F2, d rows of R); last the block's classifier rows (CLS).
enum Kind { QKV = 0, O = 1, CQ = 2, CO = 3, F1 = 4, F2 = 5, CLS = 6 };

// Which pieces are first in their stage: they are needed right after an
// exchange, the others after the stage's attention or fc1.
__host__ __device__ inline bool first_of_stage(int kind) {
  return kind == QKV || kind == CQ || kind == F1 || kind == CLS;
}

// The geometry's division over a cluster of CL blocks, and the shared-
// memory layout every block shares. Mirrored by ops/decoder_kernel.py
// decode_plan; the wrapper reads it through ishara_decoder_plan.
//
// The attention work comes in unit slots v < U: slot v is layer v / stride,
// head (v % stride) / Pc and part (v % stride) % Pc -- columns [c0, c0 + nc)
// of the head, c0 = rows_lo(Dh, part, Pc) -- on block v % CL; a slot whose
// head is H or more holds nothing. Where the cluster has at least twice as
// many blocks as a layer has heads, each head's columns are split over
// Pc blocks, up to CL / H (choose_layout; stride CL: every layer's heads
// on the same blocks, all of them busy in an attention stage); else Pc is
// 1 and stride H.
struct Plan {
  int CL, Pc, stride, U, umax, Rmax, Dh, cw, cwp, nmax, Ws, npmax, maxK, sl;
  int slots, slot;                // the staging ring: slots of slot floats
  int cache_smem, cross_smem;     // 1: in shared memory, 0: global
  // word offsets (4-byte) in shared memory
  long long o_x, o_hs, o_part, o_rs, o_ls, o_q, o_ctx, o_f, o_sc, o_pb,
      o_bsc, o_nsc, o_cv, o_ci, o_tok, o_par, o_tokw, o_fin, o_flag, o_vec,
      o_utab, o_ptab, fixed, o_ring, o_cache, o_cross, o_res;
  long long smem_words;           // the largest block's
  long long scratch_floats;       // global scratch a block: streamed, cache
  long long resident_max, streamed_max;   // weight floats, largest block
  long long budget;               // floats for resident weights
  long long o_gcache;             // the cache's offset in a block's scratch
};

// Rows [lo, hi) of ``n`` that block ``r`` of ``CL`` owns.
__host__ __device__ inline int rows_lo(int n, int r, int CL) {
  return (int)((long long)n * r / CL);
}

// Unit slot v: its layer, head, first column and columns; false when the
// slot holds no unit.
__host__ __device__ inline bool unit_of(const Dims& D, const Plan& P, int v,
                                        int* l, int* h, int* c0, int* nc) {
  const int s = v % P.stride, p = s % P.Pc;
  *l = v / P.stride;
  *h = s / P.Pc;
  *c0 = rows_lo(P.Dh, p, P.Pc);
  *nc = rows_lo(P.Dh, p + 1, P.Pc) - *c0;
  return *h < D.H;
}

// Call f(kind, idx, N, K) for each piece of block ``rank``, in the order a
// step consumes them (idx: the unit slot v for QKV..CO, the layer for F1
// and F2).
template <class F>
__host__ __device__ void for_pieces(const Dims& D, const Plan& P, int rank,
                                    F f) {
  const int d = D.d, CL = P.CL;
  const int r0 = rows_lo(4 * d, rank, CL), r1 = rows_lo(4 * d, rank + 1, CL);
  int ul, h, c0, nc;
  for (int l = 0; l < D.L; ++l) {
    for (int v = rank; v < P.U; v += CL)
      if (unit_of(D, P, v, &ul, &h, &c0, &nc) && ul == l) {
        f(QKV, v, 3 * nc, d);
        f(O, v, d, nc);
      }
    for (int v = rank; v < P.U; v += CL)
      if (unit_of(D, P, v, &ul, &h, &c0, &nc) && ul == l) {
        f(CQ, v, nc, d);
        f(CO, v, d, nc);
      }
    if (r1 > r0) { f(F1, l, r1 - r0, d); f(F2, l, d, r1 - r0); }
  }
  const int c0s = rows_lo(D.C, rank, CL), c1s = rows_lo(D.C, rank + 1, CL);
  if (c1s > c0s) f(CLS, 0, c1s - c0s, d);
}

// A product's layout: g lanes a row, tiles of R = 32 / g rows; a tile
// holds its rows' K weights (padded with zeros to Kg, a multiple of g) as
// [Kg / g][R][g], so that the 32 lanes of a warp read 32 neighbouring words
// at each step: no bank conflicts. g is the smallest power of two (at most
// 32) at which a tile fits a ring slot and 2 g times the rows of a pass
// (the whole tiles a slot holds, at most the piece's) exceeds THREADS:
// the rows run side by side, with as few lanes a row as keep the threads
// busy.
__host__ __device__ inline int lanes_of(const Plan& P, int N, int K) {
  int g = 1;
  while (g < 32) {
    const long long tile = (long long)(32 / g) * ((K + g - 1) / g * g);
    if (tile > P.slot) { g <<= 1; continue; }
    const int rows = imin(N, (int)(P.slot / tile) * (32 / g));
    if (2 * g * rows <= THREADS && g < K) g <<= 1;
    else break;
  }
  return g;
}

__host__ __device__ inline int padded_k(int K, int g) {
  return (K + g - 1) / g * g;
}

// Floats of ``N`` rows laid out in tiles of 32 / g rows.
__host__ __device__ inline long long tile_floats(int N, int Kg, int g) {
  const int R = 32 / g;
  return (long long)((N + R - 1) / R) * R * Kg;
}

// Rows of a streamed piece in one ring slot: whole tiles.
__host__ __device__ inline int seg_rows(const Plan& P, int N, int K, int g) {
  const int R = 32 / g, Kg = padded_k(K, g);
  const int tiles = imax(1, (int)(P.slot / ((long long)R * Kg)));
  return imin(tiles * R, (N + R - 1) / R * R);
}

// Floats of a streamed piece in the global scratch: its segments of
// ``rps`` rows (whole tiles) one after the other.
__host__ __device__ inline long long seg_floats(int N, int K, int g,
                                                int rps) {
  const int Kg = padded_k(K, g);
  return (long long)(N / rps) * rps * Kg + tile_floats(N % rps, Kg, g);
}

// Where block ``rank``'s pieces go under ``budget`` floats of shared
// memory: first fit, the first piece of each stage in consumption order,
// then the others in order; the rest streams. ``used`` and ``scratch``
// are padded floats (the layouts), ``res`` and ``str`` the weights' own.
// With ``tab``, the piece table: kind, idx, N, K, resident offset or -1,
// rows a segment.
struct Placed {
  long long used, scratch, res, str;
};

template <bool WRITE>
__host__ __device__ Placed place_pieces(const Dims& D, const Plan& P,
                                        int rank, long long budget,
                                        int* tab) {
  Placed o = {0, 0, 0, 0};
  for (int pass = 0; pass < 2; ++pass) {
    int n = 0;
    for_pieces(D, P, rank, [&](int kind, int idx, int N, int K) {
      const int g = lanes_of(P, N, K), Kg = padded_k(K, g);
      const long long w = tile_floats(N, Kg, g);
      if (first_of_stage(kind) == (pass == 0)) {
        const int rps = seg_rows(P, N, K, g);
        int at = -1;
        if (o.used + w <= budget) {
          at = (int)o.used;
          o.used += w;
          o.res += (long long)N * K;
        } else {
          o.scratch += seg_floats(N, K, g, rps);
          o.str += (long long)N * K;
        }
        if (WRITE) {
          int* t = tab + PIECE_INTS * n;
          t[0] = kind; t[1] = idx; t[2] = N; t[3] = K; t[4] = at; t[5] = rps;
          t[6] = g; t[7] = Kg;
        }
      }
      ++n;
    });
  }
  return o;
}

// The fixed layout at cluster size CL with each head's columns split over
// Pc blocks (make_plan's first part): the fields up to P.fixed.
__host__ __device__ void layout(const Dims& D, int CL, int Pc, Plan& P) {
  const int d = D.d, W = D.W;
  P.CL = CL;
  P.Dh = d / D.H;
  P.Pc = Pc;
  P.stride = P.Pc > 1 ? CL : D.H;
  P.U = D.L * P.stride;
  P.umax = (P.U + CL - 1) / CL;
  P.Rmax = (4 * d + CL - 1) / CL;
  P.cw = (P.Dh + P.Pc - 1) / P.Pc;        // the most columns of a part
  P.cwp = P.cw | 1;                       // odd: a thread a key, no conflicts
  P.nmax = imax(D.T, D.S);
  P.Ws = imin(W, imax(1, (W * D.H + 7) / 8));   // beams an attention pass
  P.npmax = 4 * P.umax + 2 * D.L + 1;
  P.maxK = imax(d, imax(P.Rmax, P.cw));
  P.sl = (d + CL - 1) / CL;               // the columns of x a block sums
  long long o = 20;                       // 10 mbarriers
  auto take = [&](long long w) { const long long at = o; o += align4(w); return at; };
  P.o_x = take(2LL * W * d);
  P.o_hs = take((long long)W * d);
  P.o_part = take((long long)W * d);
  P.o_rs = take(2LL * CL * W * P.sl);
  P.o_ls = take((long long)W * D.C);
  P.o_q = take((long long)W * P.cw);
  P.o_ctx = take((long long)W * P.cw);
  P.o_f = take((long long)W * P.Rmax);
  P.o_sc = take((long long)P.Ws * P.nmax);
  P.o_pb = take(2LL * (P.Pc - 1) * P.Ws * P.nmax);
  P.o_bsc = take(W);
  P.o_nsc = take(W);
  P.o_cv = take((long long)W * W);
  P.o_ci = take((long long)W * W);
  P.o_tok = take(2LL * W * D.S);
  P.o_par = take(W);
  P.o_tokw = take(W);
  P.o_fin = take(2LL * W);
  P.o_flag = take(4);
  P.o_vec = take(9LL * d * D.L + 2 * d + D.C + 4LL * P.umax * P.cw +
                 (long long)D.L * P.Rmax);
  P.o_utab = take(4LL * P.umax + D.L);
  P.o_ptab = take((long long)PIECE_INTS * P.npmax);
  P.fixed = o;
}

// The smallest staging ring: two rows of the widest product.
__host__ __device__ inline long long min_ring(const Plan& P) {
  return 2 * ((P.maxK + 31) / 32 * 32);
}

// The fixed layout of the largest split whose layout and smallest ring fit
// ``optin`` bytes a block: Pc = CL / H (at most Dh) where the cluster has
// at least twice as many blocks as heads, down to 1 (the partial scores'
// buffer grows with Pc and with T). False when not even Pc 1 fits; the
// layout of Pc 1 is left in P then.
__host__ __device__ bool choose_layout(const Dims& D, int CL,
                                       long long optin, Plan& P) {
  const int Dh = D.d / D.H;
  for (int pc = CL >= 2 * D.H ? imin(CL / D.H, Dh) : 1; pc >= 1; --pc) {
    layout(D, CL, pc, P);
    if (optin / 4 - P.fixed >= min_ring(P)) return true;
  }
  return false;
}

// The plan at cluster size CL under ``optin`` bytes a block. Returns false
// when the block's fixed layout and the smallest ring do not fit.
__host__ __device__ bool make_plan(const Dims& D, int CL, long long optin,
                                   Plan* out) {
  Plan P;
  const int W = D.W;
  if (!choose_layout(D, CL, optin, P)) return false;
  const long long avail = optin / 4 - P.fixed;
  const long long minring = min_ring(P);
  const long long cache_w = (long long)P.umax * 2 * W * D.S * P.cwp;
  const long long cross_w = (long long)P.umax * 2 * D.T * P.cwp;
  // everything resident, no ring?
  P.slots = 0;
  P.slot = imax(W == 1 ? SLOT_FLOATS_GREEDY : SLOT_FLOATS_BEAM,
                (P.maxK + 31) / 32 * 32);
  long long wmax = 0;
  for (int r = 0; r < CL; ++r) {
    const long long u = place_pieces<false>(D, P, r, 1LL << 60, nullptr).used;
    wmax = u > wmax ? u : wmax;
  }
  long long rest = avail;
  if (cache_w + cross_w + wmax <= avail) {
    P.cache_smem = P.cross_smem = 1;
    rest = avail - cache_w - cross_w;
  } else {
    P.slots = SLOTS;
    if (avail - (long long)SLOTS * P.slot < minring)
      P.slot = (P.maxK + 31) / 32 * 32;   // a tile of one row of 32 lanes
    rest = avail - (long long)P.slots * P.slot;
    P.cache_smem = cache_w <= rest;
    if (P.cache_smem) rest -= cache_w;
    P.cross_smem = cross_w <= rest;
    if (P.cross_smem) rest -= cross_w;
  }
  P.o_ring = P.fixed;
  P.o_cache = P.o_ring + (long long)P.slots * P.slot;
  P.o_cross = P.o_cache + (P.cache_smem ? cache_w : 0);
  P.o_res = P.o_cross + (P.cross_smem ? cross_w : 0);
  P.smem_words = P.o_res;
  P.resident_max = P.streamed_max = 0;
  long long scratch = 0;
  P.budget = rest;
  for (int r = 0; r < CL; ++r) {
    const Placed b = place_pieces<false>(D, P, r, rest, nullptr);
    if (P.o_res + b.used > P.smem_words) P.smem_words = P.o_res + b.used;
    P.resident_max = b.res > P.resident_max ? b.res : P.resident_max;
    P.streamed_max = b.str > P.streamed_max ? b.str : P.streamed_max;
    scratch = b.scratch > scratch ? b.scratch : scratch;
  }
  P.o_gcache = scratch;
  P.scratch_floats = align4(scratch + (P.cache_smem ? 0 : cache_w));
  *out = P;
  return true;
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\tLAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\tbra LAB_WAIT;\n\tDONE:\n\t}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// This phase of ``bar`` completes once ``bytes`` have arrived (the arrival
// of its one expected arriver, this thread).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One bulk copy (TMA, no tensor map) of ``bytes`` from global memory into
// this block's shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  mbar_expect(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// y[w] = LayerNorm(x[w]) for the W rows, a warp a row, two-pass; all in
// shared memory. A lane holds its values of the row in registers (d up to
// 32 MAXV), so that its loads go out at once: the row costs one load's
// latency and the two warp sums, not a load's latency a step. The means
// are sums times 1 / d (as PyTorch's mean), no division on the chain.
constexpr int MAXV = 16;

__device__ void layer_norm_rows(const float* x, float* y, const float* g,
                                const float* b, int W, int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv = 1.f / d;
  for (int w = warp; w < W; w += NWARPS) {
    const float* xr = x + w * d;
    if (d <= 32 * MAXV) {
      float v[MAXV];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < MAXV; ++i) {
        const int k = lane + 32 * i;
        v[i] = k < d ? xr[k] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < MAXV; ++i)
        if (lane + 32 * i < d) s += v[i];
      const float mu = warp_sum(s) * inv;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < MAXV; ++i)
        if (lane + 32 * i < d) {
          const float t = v[i] - mu;
          q += t * t;
        }
      const float r = rsqrtf(warp_sum(q) * inv + eps);
#pragma unroll
      for (int i = 0; i < MAXV; ++i) {
        const int k = lane + 32 * i;
        if (k < d) y[w * d + k] = (v[i] - mu) * r * g[k] + b[k];
      }
      continue;
    }
    float s = 0.f;
    for (int k = lane; k < d; k += 32) s += xr[k];
    const float mu = warp_sum(s) * inv;
    float v = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float t = xr[k] - mu;
      v += t * t;
    }
    const float r = rsqrtf(warp_sum(v) * inv + eps);
    for (int k = lane; k < d; k += 32)
      y[w * d + k] = (xr[k] - mu) * r * g[k] + b[k];
  }
}

// out(n, w, in[w, :] . wr[n, :]) for rows n < N of a product laid out in
// tiles (lanes_of: g lanes a row, R = 32 / g rows a tile, weights
// [Kg / g][R][g] a tile, zero beyond K) at ``wr`` in shared memory, and
// the W input rows in[w * ldin + k]: a warp a tile, two sums a lane (every
// other step) for the latency, all of a pass's MW beams at once so that a
// weight is read once a pass; beams above MW in further passes. ``row0``
// is added to n for ``out``.
template <int MW, class Out>
__device__ __forceinline__ void product(const float* wr, int N, int K, int g,
                                        int Kg, const float* in, int ldin,
                                        int W, int row0, Out out) {
  // g is a power of two: shifts, not divisions (a division by a value
  // known only at run time is a chain of some 20 instructions)
  const int lg = __ffs(g) - 1, lane = threadIdx.x & 31;
  const int gl = lane & (g - 1), R = 32 >> lg, lr = 5 - lg;
  const int tiles = (N + R - 1) >> lr;
  const int Tk = (K - gl + g - 1) >> lg;   // this lane's steps with k < K
  for (int w0 = 0; w0 < W; w0 += MW) {
    const int wn = imin(MW, W - w0);
    const float* inw = in + (long long)w0 * ldin + gl;
    for (int ti = threadIdx.x >> 5; ti < tiles; ti += NWARPS) {
      const int n = (ti << lr) + (lane >> lg);
      const bool act = n < N;
      const float* wt = wr + (long long)ti * R * Kg + lane;
      float acc[MW], acc2[MW];
#pragma unroll
      for (int w = 0; w < MW; ++w) acc[w] = acc2[w] = 0.f;
      if (act) {
        int t = 0;
#pragma unroll 2
        for (; t + 1 < Tk; t += 2) {
          const float wv = wt[t * 32], wv2 = wt[(t + 1) * 32];
#pragma unroll
          for (int w = 0; w < MW; ++w)
            if (w < wn) {
              acc[w] = fmaf(inw[w * ldin + (t << lg)], wv, acc[w]);
              acc2[w] = fmaf(inw[w * ldin + ((t + 1) << lg)], wv2, acc2[w]);
            }
        }
        if (t < Tk) {
          const float wv = wt[t * 32];
#pragma unroll
          for (int w = 0; w < MW; ++w)
            if (w < wn) acc[w] = fmaf(inw[w * ldin + (t << lg)], wv, acc[w]);
        }
#pragma unroll
        for (int w = 0; w < MW; ++w) acc[w] += acc2[w];
      }
      for (int o = g >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int w = 0; w < MW; ++w)
          acc[w] += __shfl_xor_sync(0xffffffffu, acc[w], o);
      }
      if (act && gl == 0) {
#pragma unroll
        for (int w = 0; w < MW; ++w)
          if (w < wn) out(row0 + n, w0 + w, acc[w]);
      }
    }
  }
}

// The address of ``p`` (this block's shared memory) in block ``rank`` of
// the cluster, for st.async.
__device__ __forceinline__ uint32_t mapa(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

// A store into another block's shared memory that completes 4 bytes of
// the transaction count of that block's mbarrier ``bar``: the receiver
// waits on its own barrier, with no cluster-wide fence (a release barrier
// across the cluster costs about 1400 cycles on the H100).
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// A head's columns split over ``parts`` blocks (ranks base .. base + parts
// - 1; parts 1: no split): each block's dot products over its columns are
// partial scores, kept in its score rows and sent to every other block of
// the head, into the sender's slot of buf [2][parts - 1][Ws, nmax] (the
// slots of the parts before and after the receiver's own; the two halves
// alternate with the count of exchanges ``n``, on mbarriers bars[0] and
// bars[1]); each block adds the partials in part order, so that every
// block of the head holds the same scores.
struct Split {
  int parts, part, base, n;
  float* buf;
  uint64_t* bars;
};

// One head's attention for the W beam rows, the whole block: softmax over
// ``n`` keys of scale * q_w . k_j (+ add[j]), times V, into ctx [W, Dh]
// (Dh: the block's columns of the head, q [W, Dh]). Beam w's key j is row
// j of bank hist[w S + j] >> 16 (hist null: bank 0): K at kb + (bank S +
// j) krs, V at vb + (bank S + j) krs (shared or global memory). Beams go
// in passes of Ws (the score rows held). The context: G lanes an output (G
// the largest power of two, at most 32, with outputs x G <= THREADS;
// "column chunks" of THREADS / G outputs where there are more), each lane
// every G-th key, the lanes' sums added by shuffles in a fixed order. A
// thread's indices advance by additions: a division by a value known only
// at run time costs a chain of some 20 instructions.
__device__ void attention(const float* q, const float* kb, const float* vb,
                          int krs, const int* hist, int S, int n,
                          const float* add, int W, int Ws, int Dh,
                          float scale, float* sc, int nmax, float* ctx,
                          Split& X) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int dw = THREADS / n, dj = THREADS - dw * n;
  const int pstride = Ws * nmax;
  for (int w0 = 0; w0 < W; w0 += Ws) {
    const int wn = imin(Ws, W - w0);
    const int hb = X.n & 1;
    float* pb = X.buf + (long long)hb * (X.parts - 1) * pstride;
    int wl = tid / n, j = tid - wl * n;   // score (w0 + wl, j)
    while (wl < wn) {
      const int w = w0 + wl;
      const long long bk = hist ? hist[w * S + j] >> 16 : 0;
      const float* kr = kb + (bk * S + j) * krs;
      const float* qw = q + w * Dh;
      float s0 = 0.f, s1 = 0.f;
      int u = 0;
#pragma unroll 4
      for (; u + 1 < Dh; u += 2) {
        s0 = fmaf(kr[u], qw[u], s0);
        s1 = fmaf(kr[u + 1], qw[u + 1], s1);
      }
      if (u < Dh) s0 = fmaf(kr[u], qw[u], s0);
      float sv = s0 + s1;
      if (X.parts == 1) {
        sv *= scale;
        if (add) sv += __ldg(add + j);   // the memory mask: L1 after a step
      } else {   // the partial, to every other block of the head
        for (int r = 0; r < X.parts; ++r)
          if (r != X.part) {
            float* at = pb + (X.part - (X.part > r)) * pstride + wl * nmax + j;
            st_async(mapa(at, X.base + r), sv, mapa(X.bars + hb, X.base + r));
          }
      }
      sc[wl * nmax + j] = sv;
      wl += dw;
      j += dj;
      if (j >= n) { j -= n; ++wl; }
    }
    if (X.parts > 1 && tid == 0)
      mbar_expect(X.bars + hb, 4u * (X.parts - 1) * wn * n);
    __syncthreads();
    if (X.parts > 1) {
      mbar_wait(X.bars + hb, (uint32_t)((X.n >> 1) & 1));
      ++X.n;
    }
    for (int w = warp; w < wn; w += NWARPS) {   // softmax, a warp a row
      float* row = sc + w * nmax;
      float m = -INFINITY;
      if (X.parts > 1) {   // the scores: the partials added in part order
        const float* pr = pb + w * nmax;
        for (int k = lane; k < n; k += 32) {
          float v = 0.f;
          for (int r = 0; r < X.parts; ++r)
            v += r == X.part ? row[k] : pr[(r - (r > X.part)) * pstride + k];
          v *= scale;
          if (add) v += __ldg(add + k);
          row[k] = v;
          m = fmaxf(m, v);
        }
      } else {
#pragma unroll 4
        for (int k = lane; k < n; k += 32) m = fmaxf(m, row[k]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll 4
      for (int k = lane; k < n; k += 32) {   // exp(s - max) once a key
        const float e = expf(row[k] - m);
        row[k] = e;
        sum += e;
      }
      sum = warp_sum(sum);
#pragma unroll 4
      for (int k = lane; k < n; k += 32) row[k] = row[k] / sum;
    }
    __syncthreads();
    const int O = wn * Dh;
    int lgG = 5;   // G lanes an output: as many as keep the threads busy
    while (lgG > 0 && (O << lgG) > THREADS) --lgG;
    const int G = 1 << lgG, per = THREADS >> lgG, part = tid & (G - 1);
    for (int ob = 0; ob < O; ob += per) {
      const int o = ob + (tid >> lgG);
      float a0 = 0.f, a1 = 0.f;
      if (o < O) {
        const int wl2 = o / Dh, u = o - wl2 * Dh, w = w0 + wl2;
        const float* p = sc + wl2 * nmax;
        const int* hw = hist ? hist + w * S : nullptr;
        int k = part;
#pragma unroll 2
        for (; k + G < n; k += 2 * G) {
          const long long b0 = hw ? hw[k] >> 16 : 0;
          const long long b1 = hw ? hw[k + G] >> 16 : 0;
          a0 = fmaf(p[k], vb[(b0 * S + k) * krs + u], a0);
          a1 = fmaf(p[k + G], vb[(b1 * S + k + G) * krs + u], a1);
        }
        if (k < n) {
          const long long b0 = hw ? hw[k] >> 16 : 0;
          a0 = fmaf(p[k], vb[(b0 * S + k) * krs + u], a0);
        }
      }
      a0 += a1;   // the G lanes' sums, by shuffles in a fixed order
      for (int off = G >> 1; off > 0; off >>= 1)
        a0 += __shfl_xor_sync(0xffffffffu, a0, off);
      if (o < O && part == 0) ctx[w0 * Dh + o] = a0;
    }
    __syncthreads();
  }
}

// Float offset in the pack of row n of a piece (kind, idx) of block
// ``rank``: every row of a piece is K consecutive floats there.
__device__ long long piece_row(const Dims& D, const Plan& P, int rank,
                               int kind, int idx, int n) {
  const int d = D.d, Dh = P.Dh, CL = P.CL;
  const long long dd = (long long)d * d;
  if (kind == CLS)
    return tail_off(D) + 2 * d + (long long)(rows_lo(D.C, rank, CL) + n) * d;
  if (kind == F1 || kind == F2) {
    const LayerOff o = layer_off(d, idx);
    const int r0 = rows_lo(4 * d, rank, CL);
    return kind == F1 ? o.w1 + (long long)(r0 + n) * d
                      : o.w2 + (long long)n * 4 * d + r0;
  }
  int l, h, c0, nc;
  unit_of(D, P, idx, &l, &h, &c0, &nc);
  const LayerOff o = layer_off(d, l);
  if (kind == QKV)   // wq, bq, wk, bk, wv: the matrices d^2 + d apart
    return o.wq + (n / nc) * (dd + d) + (long long)(h * Dh + c0 + n % nc) * d;
  if (kind == CQ) return o.wcq + (long long)(h * Dh + c0 + n) * d;
  return (kind == O ? o.wo : o.wco) + (long long)n * d + h * Dh + c0;
}

// The staging ring's producer, thread ISSUER of the block: the next streamed
// segment in consumption order (cyclic over the step) into the next slot,
// from the piece table's precomputed offsets (no search, no division).
struct Issuer {
  int ip, is, slot;
};

__device__ void issue_next(Issuer& it, const int* ptab, float* ring,
                           const Plan& P, const float* gscr, uint64_t* bars) {
  const int* t = ptab + PIECE_INTS * it.ip;
  const long long full = (long long)t[5] * t[7];   // whole tiles: rps Kg
  const long long fl = it.is + 1 < t[9] ? full : t[10];
  bulk_load(ring + (long long)it.slot * P.slot, gscr + t[8] + it.is * full,
            (uint32_t)(4 * fl), bars + it.slot);
  if (++it.slot == P.slots) it.slot = 0;
  if (++it.is == t[9]) {
    it.is = 0;
    it.ip = t[11];
  }
}

template <int MW>
__global__ void __launch_bounds__(THREADS, 1)
decode_kernel(const float* __restrict__ pack, const float* __restrict__ cross,
              const float* __restrict__ memadd, float* scratch,
              int* out_tokens, float* out_scores, int* out_steps, Dims D,
              Plan P) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = P.CL, rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = D.d, S = D.S, C = D.C, H = D.H, L = D.L, T = D.T;
  const int W = MW <= 2 ? MW : D.W;   // known when compiling for 1 and 2
  const int Dh = P.Dh, cw = P.cw, cwp = P.cwp;

  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);
  float* xs = sm + P.o_x;          // x [2][W, d], the same in every block
  float* hs = sm + P.o_hs;         // the LayerNorm output
  float* part = sm + P.o_part;     // this block's partial [W, d]
  float* rs = sm + P.o_rs;         // [2][CL][W, sl]: partials of its slice
  float* ls = sm + P.o_ls;         // logits [W, C], then beam totals
  float* qs = sm + P.o_q;          // a unit's q [W, nc]
  float* cs = sm + P.o_ctx;        // a unit's context [W, nc]
  float* fs = sm + P.o_f;          // the block's FFN hidden [W, Rmax]
  float* sc = sm + P.o_sc;         // attention scores [Ws, nmax]
  // a split head's partial scores; its unit table: l, h, c0, nc a slot k
  Split X = {P.Pc, P.Pc > 1 ? rank % P.Pc : 0, 0, 0, sm + P.o_pb, bars + 7};
  X.base = rank - X.part;
  int* utab = reinterpret_cast<int*>(sm + P.o_utab);
  float* bsc = sm + P.o_bsc;       // beam scores
  float* nsc = sm + P.o_nsc;
  float* cv = sm + P.o_cv;         // top-W candidates [W, W]
  int* ci = reinterpret_cast<int*>(sm + P.o_ci);
  // [2][W, S]: beam w's token p, and the bank holding its cache row p
  // (bits 16 and up); two copies, the reorder writing one from the other
  int* tok = reinterpret_cast<int*>(sm + P.o_tok);
  int* par = reinterpret_cast<int*>(sm + P.o_par);
  int* tokw = reinterpret_cast<int*>(sm + P.o_tokw);
  int* fin = reinterpret_cast<int*>(sm + P.o_fin);     // [2][W]
  int* flags = reinterpret_cast<int*>(sm + P.o_flag);
  float* vec = sm + P.o_vec;
  int* ptab = reinterpret_cast<int*>(sm + P.o_ptab);
  float* ring = sm + P.o_ring;
  float* resw = sm + P.o_res;
  float* gscr = scratch + (long long)rank * P.scratch_floats;
  const int r0 = rows_lo(4 * d, rank, CL), R = rows_lo(4 * d, rank + 1, CL) - r0;
  const int c0 = rows_lo(C, rank, CL);

  // the vectors: per layer norm1, norm2, norm3 (scale, bias), the out
  // projections' and fc2's biases; decoder_norm and the classifier's bias;
  // the block's units' q / k / v / cross-q biases; its fc1 rows' biases
  const int lvf = 9 * d;
  float* tailv = vec + L * lvf;
  float* ubias = tailv + 2 * d + C;
  float* b1s = ubias + 4 * P.umax * cw;
  for (int l = 0; l < L; ++l) {
    const LayerOff o = layer_off(d, l);
    const long long src[9] = {o.n1g, o.n1b, o.n2g, o.n2b, o.n3g, o.n3b,
                              o.bo, o.bco, o.b2};
    for (int e = tid; e < lvf; e += THREADS)
      vec[l * lvf + e] = pack[src[e / d] + e % d];
    for (int e = tid; e < R; e += THREADS) b1s[l * P.Rmax + e] = pack[o.b1 + r0 + e];
  }
  for (int e = tid; e < 2 * d; e += THREADS) tailv[e] = pack[tail_off(D) + e];
  for (int e = tid; e < C; e += THREADS)
    tailv[2 * d + e] = pack[tail_off(D) + 2 * d + (long long)C * d + e];
  for (int k = 0, v = rank; k < P.umax; ++k, v += CL) {
    int l = -1, h = 0, c0u = 0, nc = 0;
    if (v >= P.U || !unit_of(D, P, v, &l, &h, &c0u, &nc)) l = -1;
    if (tid < 4) utab[4 * k + tid] = tid == 0 ? l : tid == 1 ? h
                                     : tid == 2 ? c0u : nc;
    if (l < 0) continue;
    const LayerOff o = layer_off(d, l);
    const long long src[4] = {o.bq, o.bk, o.bv, o.bcq};
    for (int e = tid; e < 4 * nc; e += THREADS)
      ubias[k * 4 * cw + e] = pack[src[e / nc] + h * Dh + c0u + e % nc];
  }
  for (int l = tid; l < L; l += THREADS) {   // the blocks with a unit of l
    unsigned m = 0;
    int ul, h, c0u, nc;
    for (int v = l * P.stride; v < (l + 1) * P.stride; ++v)
      if (unit_of(D, P, v, &ul, &h, &c0u, &nc)) m |= 1u << (v % CL);
    utab[4 * P.umax + l] = (int)m;
  }
  if (tid == 0) {
    place_pieces<true>(D, P, rank, P.budget, ptab);
    int np = 0;
    for_pieces(D, P, rank, [&](int, int, int, int) { ++np; });
    flags[2] = np;
    // the streamed pieces' segments, and each one's successor (cyclic)
    long long off = 0;
    int first = -1, last = -1;
    for (int p = 0; p < np; ++p) {
      int* t = ptab + PIECE_INTS * p;
      if (t[4] >= 0) continue;
      const int N = t[2], rps = t[5];
      t[8] = (int)off;
      t[9] = (N + rps - 1) / rps;
      t[10] = (int)tile_floats(N - (t[9] - 1) * rps, t[7], t[6]);
      off += seg_floats(N, t[3], t[6], rps);
      if (last >= 0) ptab[PIECE_INTS * last + 11] = p;
      else first = p;
      last = p;
    }
    if (last >= 0) ptab[PIECE_INTS * last + 11] = first;
    flags[3] = first;
  }
  __syncthreads();
  const int np = flags[2];

  // the weights: resident pieces into shared memory, streamed ones into
  // this block's scratch, segment by segment, in consumption order
  bool streams = false;
  {
    long long off = 0;
    for (int p = 0; p < np; ++p) {
      const int* t = ptab + PIECE_INTS * p;
      const int kind = t[0], idx = t[1], N = t[2], K = t[3], at = t[4],
                rps = t[5], g = t[6], Kg = t[7], R = 32 / g;
      for (int n = warp; n < N; n += NWARPS) {   // a warp a row, in tiles
        const float* src = pack + piece_row(D, P, rank, kind, idx, n);
        const int m = at >= 0 ? n : n % rps;     // the row in its segment
        float* dst = (at >= 0 ? resw + at
                              : gscr + off + (long long)(n / rps) * rps * Kg) +
                     (long long)(m / R) * R * Kg + (m % R) * g;
        for (int k = lane; k < Kg; k += 32)
          dst[(k / g) * 32 + k % g] = k < K ? src[k] : 0.f;
      }
      if (at < 0) {
        off += seg_floats(N, K, g, rps);
        streams = true;
      }
    }
  }
  // the cross-attention K / V of the block's units, [T, cwp] each
  float* crs = sm + P.o_cross;
  if (P.cross_smem) {
    for (int k = 0, v = rank; v < P.U; ++k, v += CL) {
      int l, h, c0u, nc;
      if (!unit_of(D, P, v, &l, &h, &c0u, &nc)) continue;
      const float* src = cross + (long long)l * 2 * T * d + h * Dh + c0u;
      float* dst = crs + (long long)k * 2 * T * cwp;
      for (int e = tid; e < 2 * T * nc; e += THREADS) {
        const int j = e / nc, c = e % nc;   // j < 2T: K rows, then V rows
        dst[(long long)j * cwp + c] = src[(long long)j * d + c];
      }
    }
  }
  float* cache = P.cache_smem ? sm + P.o_cache : gscr + P.o_gcache;

  const float* embed = pack + tail_off(D) + 2 * d + (long long)C * d + C;
  for (int e = tid; e < W * d; e += THREADS)
    xs[e] = embed[(long long)D.sos * d + e % d];
  for (int e = tid; e < 2 * W * S; e += THREADS)
    tok[e] = ((e / S) % W) << 16 | ((e % S == 0) ? D.sos : D.pad);
  for (int e = tid; e < 2 * W; e += THREADS)
    fin[e] = D.sos == D.eos || D.pad == D.eos;
  if (tid < W) bsc[tid] = tid == 0 ? 0.f : NEG;
  if (tid == 0) flags[0] = 0;
  asm volatile("fence.proxy.async;\n" ::: "memory");
  __syncthreads();
  Issuer it = {flags[3], 0, 0};
  // mbarriers: the ring's two slots; the exchange's scatter and gather,
  // two each (stages alternate); the logits; a split head's scores, two
  if (tid == 0) {
    for (int s = 0; s < 9; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == ISSUER && streams)
    for (int s = 0; s < P.slots; ++s)
      issue_next(it, ptab, ring, P, gscr, bars);
  __syncthreads();
  cluster.sync();   // every block runs before any reads its memory

  int cons = 0;     // streamed segments consumed
  // one piece's product: from shared memory, or segment by segment
  // through the ring (each slot refilled, once read, with the segment
  // ``slots`` ahead)
  auto run = [&](int p, const float* in, int ldin, auto out) {
    const int* t = ptab + PIECE_INTS * p;
    const int N = t[2], K = t[3], at = t[4], g = t[6], Kg = t[7];
    const int rps = at >= 0 ? N : t[5];
    for (int n0 = 0; n0 < N; n0 += rps) {
      const float* wr = resw + at;
      const int slot = cons & 1;   // two slots
      if (at < 0) {
        mbar_wait(bars + slot, (uint32_t)((cons >> 1) & 1));
        wr = ring + (long long)slot * P.slot;
      }
      product<MW>(wr, imin(rps, N - n0), K, g, Kg, in, ldin, W, n0, out);
      if (at < 0) {
        __syncthreads();
        if (tid == ISSUER) issue_next(it, ptab, ring, P, gscr, bars);
        ++cons;
      }
    }
  };

  // the blocks with a unit of each layer (utab's tail)
  const int* lmask = utab + 4 * P.umax;
  unsigned ffn_mask = 0;
  for (int r = 0; r < CL; ++r)
    if (rows_lo(4 * d, r + 1, CL) > rows_lo(4 * d, r, CL)) ffn_mask |= 1u << r;
  const bool has_cls = rows_lo(C, rank + 1, CL) > c0;
  int cur = 0, xb = 0, sg = 0, steps = 0, nx = 0;   // nx: exchanges run
  const int c0s = imin(d, rank * P.sl), len = imin(d, c0s + P.sl) - c0s;
  for (int i = 0; i < S - 1; ++i) {
    int pc = 0;
    const int* hc = tok + cur * W * S;
    // the stages of a step: per layer self-attention, cross-attention and
    // the FFN (kinds 0, 1, 2), then the classifier (3); each ends in an
    // exchange. One code path for all of them, so that the step's code
    // stays small.
    for (int st = 0; st <= 3 * L; ++st) {
      const int l = st / 3, kind = st == 3 * L ? 3 : st % 3;
      const float* v = vec + l * lvf;
      // the blocks with a partial of the stage
      const unsigned mask = kind < 2 ? (unsigned)lmask[l] : ffn_mask;
      float* pw = part;
      float* xc = xs + xb * W * d;
      const bool in_stage = kind == 3 ? has_cls : (mask >> rank & 1u) != 0;
      if (in_stage) {
        const float* g = kind == 3 ? tailv : v + 2 * kind * d;
        layer_norm_rows(xc, hs, g, g + d, W, d, D.eps);
        __syncthreads();
        // the stage's operations: for each of the block's units of this
        // layer (slots k with utab's layer l) its projection, its
        // attention and its out-projection slice; or fc1 and fc2; or the
        // classifier rows
        const int nops = kind < 2 ? 3 * P.umax : kind == 2 ? 2 : 1;
        int k = 0, h = 0, cu = 0, nc = 0;
        bool first = true;
        for (int op = 0; op < nops; ++op) {
          const int sub = kind < 2 ? op % 3 : op;
          if (kind < 2) {
            k = op / 3;
            if (utab[4 * k] != l) continue;   // no unit of this layer
            h = utab[4 * k + 1];
            cu = utab[4 * k + 2];
            nc = utab[4 * k + 3];
          }
          float* kc = cache + (long long)k * 2 * W * S * cwp;
          float* vc = kc + (long long)W * S * cwp;
          if (kind < 2 && sub == 1) {
            const float *kb = kc, *vb = vc, *add = nullptr;
            int krs = cwp, n = i + 1;
            const int* hist = hc;
            if (kind == 1) {
              hist = nullptr;
              n = T;
              add = memadd;
              if (P.cross_smem) {
                kb = crs + (long long)k * 2 * T * cwp;
              } else {
                kb = cross + (long long)l * 2 * T * d + h * Dh + cu;
                krs = d;
              }
              vb = kb + (long long)T * krs;
            }
            attention(qs, kb, vb, krs, hist, S, n, add, W, P.Ws, nc, D.scale,
                      sc, P.nmax, cs, X);
            continue;
          }
          const int pk = ptab[PIECE_INTS * pc];
          const float* ub = ubias + k * 4 * cw;
          const float* in = hs;
          int ldin = d;
          if (pk == O || pk == CO) { in = cs; ldin = nc; }
          if (pk == F2) { in = fs; ldin = P.Rmax; }
          const float* b1 = b1s + l * P.Rmax;
          const float* bc = tailv + 2 * d + c0;
          const bool f = first;
          run(pc++, in, ldin, [&](int n, int w, float x) {
            switch (pk) {
              case QKV:
                x += ub[n];
                if (n < nc) qs[w * nc + n] = x;
                else if (n < 2 * nc)
                  kc[((long long)w * S + i) * cwp + n - nc] = x;
                else
                  vc[((long long)w * S + i) * cwp + n - 2 * nc] = x;
                break;
              case CQ: qs[w * nc + n] = x + ub[3 * nc + n]; break;
              case F1: fs[w * P.Rmax + n] = fmaxf(x + b1[n], 0.f); break;
              case CLS:
                x += bc[n];
                for (int r = 0; r < CL; ++r)
                  st_async(mapa(ls + w * C + c0 + n, r), x, mapa(bars + 6, r));
                break;
              default:   // O, CO, F2: this block's partial of the stage
                if (f) pw[w * d + n] = x;
                else pw[w * d + n] += x;
            }
          });
          if (pk == O || pk == CO) first = false;
          __syncthreads();
        }
      }
      if (kind == 3) {   // the logits, from every block with classifier rows
        if (tid == 0) mbar_expect(bars + 6, 4u * W * C);
        mbar_wait(bars + 6, (uint32_t)(i & 1));
        ++nx;
        continue;
      }
      // The exchange that ends a stage, with no cluster barrier: each block
      // of the stage sends column slice s of its partial to block s; block
      // s adds the partials in rank order, the bias and the residual, and
      // sends its slice of the new x to every block. Receive buffers and
      // x alternate between stages, so a block's sends of one stage never
      // meet a buffer its receiver still reads from the stage before.
      const int p = sg & 1;
      const uint32_t ph = (uint32_t)((sg >> 1) & 1);
      float* rsp = rs + p * CL * W * P.sl;
      float* xn = xs + (xb ^ 1) * W * d;
      if (in_stage) {
        for (int n = tid; n < d; n += THREADS) {
          const int s2 = n / P.sl, j = n - s2 * P.sl;
          const uint32_t rb = mapa(bars + 2 + p, s2);
          for (int w = 0; w < W; ++w)
            st_async(mapa(rsp + (rank * W + w) * P.sl + j, s2), pw[w * d + n],
                     rb);
        }
      }
      if (tid == 0) {
        mbar_expect(bars + 2 + p, 4u * __popc(mask) * W * len);
        mbar_expect(bars + 4 + p, 4u * W * d);
      }
      mbar_wait(bars + 2 + p, ph);
      const float* bias = v + (6 + kind) * d + c0s;
      for (int e = tid; e < W * len; e += THREADS) {
        const int w = e / len, j = e - w * len;
        float pv[16];   // all the loads first, then the sum in rank order
#pragma unroll
        for (int r = 0; r < 16; ++r)
          pv[r] = (r < CL && (mask >> r & 1u)) ? rsp[(r * W + w) * P.sl + j]
                                               : 0.f;
        float sum = bias[j];
#pragma unroll
        for (int r = 0; r < 16; ++r)
          if (r < CL && (mask >> r & 1u)) sum += pv[r];
        const float xv = xc[w * d + c0s + j] + sum;
        for (int r = 0; r < CL; ++r)
          st_async(mapa(xn + w * d + c0s + j, r), xv, mapa(bars + 4 + p, r));
      }
      mbar_wait(bars + 4 + p, ph);
      xb ^= 1;
      ++sg;
      ++nx;
    }
    ++steps;

    // the next token(s): the same in every block, from the same logits
    int* tc = tok + cur * W * S;
    if (!D.beam) {
      if (warp == 0) {
        float bv = -INFINITY;
        int bi = C;
        for (int c = lane; c < C; c += 32)
          if (ls[c] > bv) { bv = ls[c]; bi = c; }
        warp_argmax(bv, bi);                        // the first maximum
        if (lane == 0) {
          tc[i + 1] = bi;   // bank 0
          flags[0] = bi == D.eos;
          flags[1] = bi;
        }
      }
      __syncthreads();
      const int nxt = flags[1];
      for (int e = tid; e < d; e += THREADS)
        xs[xb * W * d + e] = embed[(long long)nxt * d + e];
    } else {
      // totals[w, c] = score[w] + log_softmax(logits[w])[c], a warp a row
      // (a finished beam offers only pad, at cost 0)
      const int* fc = fin + cur * W;
      for (int w = warp; w < W; w += NWARPS) {
        float* row = ls + w * C;
        float m = -INFINITY;
        for (int c = lane; c < C; c += 32) m = fmaxf(m, row[c]);
        m = warp_max(m);
        float s = 0.f;
        for (int c = lane; c < C; c += 32) s += expf(row[c] - m);
        const float lse = logf(warp_sum(s));
        for (int c = lane; c < C; c += 32) {
          float lp = (row[c] - m) - lse;
          if (fc[w]) lp = c == D.pad ? 0.f : NEG;
          row[c] = bsc[w] + lp;
        }
      }
      __syncthreads();
      // each total's rank in its row (the larger value first, then the
      // smaller index): those of rank < W are the row's top W, in order
      for (int e = tid; e < W * C; e += THREADS) {
        const int w = e / C, c = e - w * C;
        const float* row = ls + w * C;
        const float v = row[c];
        int rank = 0;
#pragma unroll 4
        for (int c2 = 0; c2 < C; ++c2) {
          const float o = row[c2];
          rank += (o > v) || (o == v && c2 < c);
        }
        if (rank < W) {
          cv[w * W + rank] = v;
          ci[w * W + rank] = e;
        }
      }
      __syncthreads();
      // the same ranks among the W^2 candidates (flat index w C + c): the
      // stable top W of all W C totals
      for (int e = tid; e < W * W; e += THREADS) {
        const float v = cv[e];
        const int f = ci[e];
        int rank = 0;
        for (int e2 = 0; e2 < W * W; ++e2) {
          const float o = cv[e2];
          rank += (o > v) || (o == v && ci[e2] < f);
        }
        if (rank < W) {
          par[rank] = f / C;
          tokw[rank] = f - (f / C) * C;
          nsc[rank] = v;
        }
      }
      __syncthreads();
      // the reorder, one pass over the rows so far: tokens and the cache
      // history (the parent's), the new token with bank w at row i + 1
      const int nb = cur ^ 1;
      int* tn = tok + nb * W * S;
      for (int e = tid; e < W * (i + 2); e += THREADS) {
        const int w = e / (i + 2), p = e % (i + 2);
        tn[w * S + p] = p == i + 1 ? (w << 16 | tokw[w]) : tc[par[w] * S + p];
      }
      if (tid < W) {
        fin[nb * W + tid] = fc[par[tid]] || tokw[tid] == D.eos;
        bsc[tid] = nsc[tid];
      }
      for (int e = tid; e < W * d; e += THREADS)
        xs[xb * W * d + e] = embed[(long long)tokw[e / d] * d + e % d];
      __syncthreads();
      cur = nb;
      if (tid == 0) {
        int all = 1;
        for (int w = 0; w < W; ++w) all &= fin[cur * W + w];
        flags[0] = all;
      }
    }
    __syncthreads();
    if (flags[0]) break;   // the same decision in every block
  }

  if (tid == 0 && streams)   // no copy may land after the block has left
    for (int g = cons; g < cons + 2; ++g)
      mbar_wait(bars + (g & 1), (uint32_t)((g >> 1) & 1));
  if (rank == 0) {
    const int* tc = tok + cur * W * S;
    for (int e = tid; e < W * S; e += THREADS) out_tokens[e] = tc[e] & 0xffff;
    if (tid < W) out_scores[tid] = bsc[tid];
    if (tid == 0) {   // the steps, and the exchanges block 0 took part in
      out_steps[0] = steps;
      out_steps[1] = nx;
      out_steps[2] = X.n;
    }
  }
  __syncthreads();
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

template <int MW>
cudaError_t setup(int device, int* optin) {
  auto kernel = decode_kernel<MW>;
  cudaError_t e = cudaDeviceGetAttribute(
      optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *optin);
}

// The plan of the largest cluster the card places (16 blocks, else 8) and
// its launch configuration; cudaErrorInvalidConfiguration when none fits.
template <int MW>
cudaError_t choose(const Dims& D, int device, Plan* P, cudaLaunchConfig_t* cfg,
                   cudaLaunchAttribute* attr, cudaStream_t stream) {
  int optin = 0;
  cudaError_t e = setup<MW>(device, &optin);
  if (e != cudaSuccess) return e;
  const int sizes[2] = {16, 8};
  for (int cl : sizes) {
    if (!make_plan(D, cl, optin, P)) continue;
    if (configure(decode_kernel<MW>, cfg, attr, cl,
                  (size_t)(4 * P->smem_words), stream))
      return cudaSuccess;
  }
  return cudaErrorInvalidConfiguration;
}

template <int MW>
cudaError_t launch(const Dims& D, int device, const void* pack,
                   const void* cross, const void* memadd, void* scratch,
                   long long scratch_floats, void* tokens, void* scores,
                   void* steps, cudaStream_t stream) {
  Plan P;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t e = choose<MW>(D, device, &P, &cfg, attr, stream);
  if (e != cudaSuccess) return e;
  if ((long long)P.CL * P.scratch_floats > scratch_floats)
    return cudaErrorInvalidValue;   // the wrapper's scratch is too small
  e = cudaLaunchKernelEx(&cfg, decode_kernel<MW>, (const float*)pack,
                         (const float*)cross, (const float*)memadd,
                         (float*)scratch, (int*)tokens, (float*)scores,
                         (int*)steps, D, P);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

Dims dims_of(int d, int H, int L, int C, int T, int S, int W, int beam,
             int sos, int eos, int pad, float eps, float scale) {
  Dims D;
  D.d = d; D.H = H; D.L = L; D.C = C; D.T = T; D.S = S; D.W = W;
  D.beam = beam; D.sos = sos; D.eos = eos; D.pad = pad;
  D.eps = eps; D.scale = scale;
  return D;
}

bool valid(const Dims& D) {
  return D.W >= 1 && D.W <= D.C && D.C <= 65536 && D.H >= 1 &&
         D.d % D.H == 0 && D.S >= 2 &&
         D.L >= 1 && D.T >= 1 && D.sos >= 0 && D.sos < D.C;
}

}  // namespace

extern "C" {

// Bytes of shared memory a block must hold whatever streams, at a cluster
// of 16 blocks of the H100's 227 KB: the fixed layout of the split
// choose_layout takes and the smallest staging ring (two rows of the
// widest product) -- the design's limit. Mirrored by
// ops/decoder_kernel.py fused_decode_smem_bytes.
int ishara_decoder_vector_bytes(int d, int H, int L, int C, int T, int S,
                                int W) {
  const Dims D = dims_of(d, H, L, C, T, S, W, 0, 0, 0, 0, 0, 0);
  Plan P;
  choose_layout(D, 16, 232448, P);
  return (int)(4 * (P.fixed + min_ring(P)));
}

// The plan the kernel takes on ``device`` (out: cluster size, shared
// memory a block in bytes, global scratch floats a block, the largest
// block's resident and streamed weight bytes, caches in shared memory,
// cross K / V in shared memory, ring slots, slot floats, the blocks a
// head's columns are split over).
int ishara_decoder_plan(int device, int d, int H, int L, int C, int T, int S,
                        int W, long long* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Dims D = dims_of(d, H, L, C, T, S, W, 1, 0, 0, 0, 0, 0);
  if (!valid(D)) return (int)cudaErrorInvalidValue;
  Plan P;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  if (W == 1) e = choose<1>(D, device, &P, &cfg, attr, 0);
  else if (W == 2) e = choose<2>(D, device, &P, &cfg, attr, 0);
  else e = choose<4>(D, device, &P, &cfg, attr, 0);
  if (e != cudaSuccess) return (int)e;
  const long long v[10] = {P.CL, 4 * P.smem_words, P.scratch_floats,
                           4 * P.resident_max, 4 * P.streamed_max,
                           P.cache_smem, P.cross_smem, P.slots, P.slot,
                           P.Pc};
  for (int k = 0; k < 10; ++k) out[k] = v[k];
  return 0;
}

// Decode one sequence: tokens [W, S] int32 (row 0 of a greedy decode),
// the beams' raw log-probability scores [W], and ``steps`` [3]: the steps
// run, the exchanges that end a stage and the score exchanges of a split
// head, as block 0 counted them.
// ``pack`` holds the decoder's f32 weights in the order of LayerOff,
// ``cross`` each layer's cross-attention K and V [L, 2, T, d] (head-major
// rows), ``memadd`` [T] the additive memory mask, ``scratch`` the global
// scratch of ishara_decoder_plan (``scratch_floats`` floats: each block's
// streamed weights, and its caches where they are not in shared memory).
int ishara_decoder_decode(int device, const void* pack, const void* cross,
                          const void* memadd, void* scratch,
                          long long scratch_floats, void* tokens,
                          void* scores, void* steps, int d, int H, int L,
                          int C, int T, int S, int W, int beam, int sos,
                          int eos, int pad, float eps, float scale,
                          void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Dims D = dims_of(d, H, L, C, T, S, W, beam, sos, eos, pad, eps,
                         scale);
  if (!valid(D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W == 1)
    return (int)launch<1>(D, device, pack, cross, memadd, scratch,
                          scratch_floats, tokens, scores, steps, st);
  if (W == 2)
    return (int)launch<2>(D, device, pack, cross, memadd, scratch,
                          scratch_floats, tokens, scores, steps, st);
  return (int)launch<4>(D, device, pack, cross, memadd, scratch,
                        scratch_floats, tokens, scores, steps, st);
}

const char* ishara_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
