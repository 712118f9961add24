// Multi-head self-attention for training on Hopper (sm_90a), forward and
// backward, with dropout on the normalised weights (K3).
//
// Replaces the Pallas kernels _fwd_kernel and _bwd_kernel of
// ishara_tpu/ops/attention.py (behind flash_mhsa): T <= 384 (the
// reference's routing), a [B, T] additive key bias (0 or -1e30), scores
// scaled by `scale`; the forward saves the row logsumexp and the backward
// recomputes the probabilities from it instead of storing them.
//
// Arithmetic as the reference: s = q.k * scale + bias; p = exp(s - max);
// l = sum p over the UNdropped weights; o = ((p * keep') . v) / l rounded
// once to q's type; lse = max + log l. Backward: P = exp(s - lse),
// dP = dO.V^T, dV = (P * keep')^T dO, delta = sum dO * O,
// dS = P * (dP * keep' - delta), dQ = dS.K * scale, dK = dS^T.Q * scale.
// keep' = keep / (1 - rate) is the Philox function of (seed, offset + flat
// index into [B, H, T, T]) of philox.cuh, so the backward regenerates the
// forward's mask; a process holding rows [r0, r1) of the batch passes offset
// r0 H T T and draws the whole batch's mask there; a tensor-parallel rank
// holding H of a row's mask_heads heads passes mask_heads (0: H) and draws
// the unsharded launch's mask at its heads' positions. A row whose keys are
// all masked averages V over its T keys; keys beyond T are excluded
// (Tc = T).
//
// Bound: bytes. At B 256, H 8, T 176, Dh 32 in bf16 the forward moves
// 94 MB (0.028 ms at 3.35 TB/s; 103 MB with the keep bits) for 8 GFLOP
// (0.008 ms on the tensor cores) and the backward 186 MB for 20 GFLOP.
// Both directions take one of two designs by one rule on (dtype, T, Dh,
// whether TMA can read q, k, v) alone, k3wg::plan, mirrored by
// attention_plan in ops/attention.py:
// - wgmma (bf16, heads of 32 and 64, T <= 384): the forward of
//   attention_fwd_wg.cuh (K8's persistent forward on a TMA key / value
//   ring with K3's unit of three query tiles, the Philox words drawn while
//   the products run) writes the keep bits where the rate is above 0, and
//   the one pass of attention_bwd.cuh reads them (the caller passes their
//   buffer to both launches);
// - general (everything else): the forward and the two backward passes of
//   the tensor-core core of attention_tc.cuh (mma.sync bf16 / 3xTF32),
//   which regenerate the Philox mask.
// A launch whose bits do not suit its design is refused; nothing falls
// back.

#include "attention_fwd_wg.cuh"
#include "attention_tc.cuh"

namespace {

bool qkv_tma_ok(const void* q, const void* k, const void* v,
                const long long* qs, const long long* ks,
                const long long* vs) {
  return k3wg::tma_ok(q, qs) && k3wg::tma_ok(k, ks) && k3wg::tma_ok(v, vs);
}

}  // namespace

extern "C" {

// The plan of (dtype, T, Dh, aligned) into out[0..9]: the design (0
// general, 1 wgmma; both directions), the backward's consumers, groups,
// stages, ds_bufs, smem (bytes) and reg_limit, then the forward's
// consumers, smem (bytes) and reg_limit (0 on the general design).
// ops/attention.py's attention_plan gives the same design; the layouts are
// this plan's alone.
int ishara_attention_plan(int dtype, int T, int Dh, int aligned,
                          long long* out) {
  const k3wg::Plan p = k3wg::plan(dtype, T, Dh, aligned);
  const bool wg = p.design == k3wg::WGMMA;
  const long long v[10] = {
      p.design,      p.consumers,
      p.groups,      p.stages,
      p.ds_bufs,     (long long)p.smem,
      p.reg_limit,   wg ? k8wg::K3_NW : 0,
      wg ? (long long)k8wg::fwd_smem(Dh, k8wg::K3_NW) : 0,
      wg ? k8wg::consumer_regs(k8wg::K3_NW) : 0};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// o [B, H, T, Dh] and lse [B, H, T] from q, k, v (element strides over
// b, h, t in qs, ks, vs; unit stride over Dh), bias [B, T] f32, one int32
// seed on the device, the mask's index offset and heads a batch row
// (mask_heads, 0: H). dtype 0 = f32, 1 = bf16.
// threshold 0 means no dropout. bits: null, or (exactly where the plan is
// wgmma and threshold > 0) uint32 [B, H, T, ceil(T / 32)] that receives
// the keep decisions (attention_bwd.cuh's layout).
int ishara_attention_fwd(int device, const void* q, const void* k,
                         const void* v, const long long* qs,
                         const long long* ks, const long long* vs,
                         const void* bias, const void* seed, void* o,
                         void* lse, void* bits, int B, int H, int T, int Dh,
                         float scale, unsigned int threshold,
                         float keep_scale, unsigned long long offset,
                         int mask_heads, int dtype, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (mask_heads != 0 && mask_heads < H) return (int)cudaErrorInvalidValue;
  if (T > 384) return (int)cudaErrorInvalidValue;
  const k3wg::Plan p =
      k3wg::plan(dtype, T, Dh, qkv_tma_ok(q, k, v, qs, ks, vs));
  if (p.design == k3wg::WGMMA) {
    const long long rows = (long long)k8wg::K3_NW * k8wg::ROWS;
    const long long nq = (T + rows - 1) / rows;
    if ((bits != nullptr) != (threshold != 0u) || B <= 0 || H <= 0 ||
        (long long)B * H * nq >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    k8wg::Args a{};
    a.bias = (const float*)bias;
    a.o = (__nv_bfloat16*)o;
    a.lse = (float*)lse;
    a.H = H, a.T = T, a.Tc = T;
    a.nq = (int)nq;
    a.nt = (T + k8wg::ROWS - 1) / k8wg::ROWS;
    a.units = (int)((long long)B * H * nq);
    a.scale = scale;
    a.seed = (const int*)seed;
    a.threshold = threshold;
    a.keep_scale = keep_scale;
    a.offset = offset;
    a.Hm = mask_heads;
    a.bits = (uint32_t*)bits;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    constexpr int NWG = k8wg::K3_NW;
    if (Dh == 32)
      return (int)(threshold ? k8wg::launch_fwd<32, NWG, true>(
                                   q, k, v, qs, ks, vs, a, B, s)
                             : k8wg::launch_fwd<32, NWG, false>(
                                   q, k, v, qs, ks, vs, a, B, s));
    return (int)(threshold ? k8wg::launch_fwd<64, NWG, true>(
                                 q, k, v, qs, ks, vs, a, B, s)
                           : k8wg::launch_fwd<64, NWG, false>(
                                 q, k, v, qs, ks, vs, a, B, s));
  }
  if (bits) return (int)cudaErrorInvalidValue;
  tc::Params P{};
  P.q = q, P.k = k, P.v = v;
  tc::set_strides(P.qs, qs);
  tc::set_strides(P.ks, ks);
  tc::set_strides(P.vs, vs);
  P.bias = (const float*)bias;
  P.seed = (const int*)seed;
  P.o = o;
  P.lse = (float*)lse;
  P.B = B, P.H = H, P.T = T, P.Tc = T, P.Dh = Dh;
  P.scale = scale;
  P.threshold = threshold;
  P.keep_scale = keep_scale;
  P.offset = offset;
  P.Hm = mask_heads;
  return tc::dispatch(P, dtype, false, stream);
}

// dq, dk, dv [B, H, T, Dh] contiguous from the forward's inputs, its o and
// lse, and d_o (strides dos). On the general design delta is f32 scratch
// [B, H, T] that the dQ launch fills and the dK / dV launch reads, and bits
// must be null; on the wgmma design (k3wg::plan) delta is unused, bits are
// the forward's (null exactly when threshold is 0) and d_o's rows must be
// on 16 bytes as q's.
int ishara_attention_bwd(int device, const void* q, const void* k,
                         const void* v, const void* d_o, const long long* qs,
                         const long long* ks, const long long* vs,
                         const long long* dos, const void* bias,
                         const void* seed, const void* o, const void* lse,
                         const void* bits, void* delta, void* dq, void* dk,
                         void* dv, int B, int H, int T, int Dh, float scale,
                         unsigned int threshold, float keep_scale,
                         unsigned long long offset, int mask_heads, int dtype,
                         void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const k3wg::Plan p =
      k3wg::plan(dtype, T, Dh, qkv_tma_ok(q, k, v, qs, ks, vs));
  if (p.design == k3wg::WGMMA) {
    if ((bits != nullptr) != (threshold != 0u) || !k3wg::tma_ok(d_o, dos) ||
        (long long)B * H >= (1LL << 31) || B <= 0 || H <= 0)
      return (int)cudaErrorInvalidValue;
    k3wg::Args a{};
    a.o = (const __nv_bfloat16*)o;
    a.d_o = (const __nv_bfloat16*)d_o;
    tc::set_strides(a.dos, dos);
    a.bias = (const float*)bias;
    a.lse = (const float*)lse;
    a.bits = (const uint32_t*)bits;
    a.dq = (__nv_bfloat16*)dq;
    a.dk = (__nv_bfloat16*)dk;
    a.dv = (__nv_bfloat16*)dv;
    a.H = H, a.T = T;
    a.scale = scale;
    a.keep_scale = keep_scale;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(Dh == 32 ? k3wg::launch<32>(p, q, k, v, d_o, qs, ks, vs,
                                             dos, a, B, s)
                          : k3wg::launch<64>(p, q, k, v, d_o, qs, ks, vs,
                                             dos, a, B, s));
  }
  if (bits) return (int)cudaErrorInvalidValue;
  tc::Params P{};
  P.q = q, P.k = k, P.v = v, P.d_o = d_o;
  tc::set_strides(P.qs, qs);
  tc::set_strides(P.ks, ks);
  tc::set_strides(P.vs, vs);
  tc::set_strides(P.dos, dos);
  P.bias = (const float*)bias;
  P.seed = (const int*)seed;
  P.o = const_cast<void*>(o);
  P.lse = (float*)const_cast<void*>(lse);
  P.delta = (float*)delta;
  P.dq = dq, P.dk = dk, P.dv = dv;
  P.B = B, P.H = H, P.T = T, P.Tc = T, P.Dh = Dh;
  P.scale = scale;
  P.threshold = threshold;
  P.keep_scale = keep_scale;
  P.offset = offset;
  P.Hm = mask_heads;
  if (mask_heads != 0 && mask_heads < H) return (int)cudaErrorInvalidValue;
  if (T > 384) return (int)cudaErrorInvalidValue;
  return tc::dispatch(P, dtype, true, stream);
}

const char* ishara_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
