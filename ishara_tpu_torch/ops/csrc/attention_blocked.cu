// Tiled multi-head self-attention for long sequences on Hopper (sm_90a),
// forward and backward, no dropout (K8).
//
// Replaces the Pallas kernels _fwd_kernel, _dq_kernel and _dkv_kernel of
// ishara_tpu/ops/attention_blocked.py (behind flash_mhsa_blocked): keys
// streamed with the online-softmax recurrence, so nothing of size [T, T] is
// held and any T runs; the forward saves the row logsumexp, the backward
// recomputes the probabilities from it, with no sum shared between blocks
// and no atomics: the gradients are the same from run to run.
//
// Semantics as the reference: s = q.k * scale + bias with a [B, T] additive
// key bias (0 or -1e30). T is padded to Tp (the caller's multiple, the
// reference's lcm of its block sizes); a padded key has k = v = 0 and the
// bias -1e30 and counts: a row whose keys are all masked has every score at
// -1e30, so each of the Tp keys gets the weight 1 / Tp, padded zeros
// included, and lse rounds to -1e30 exactly, as in the reference. Keys at
// or beyond Tp are excluded (a 64-key tile need not divide Tp).
// Backward: p = exp(s - lse), dp = dO . v, ds = p * (dp - delta) with
// delta = rowsum(dO * O); padded queries and keys add exact zeros to the
// gradients the reference keeps, so the backward stops at T.
//
// Bound: at B 256, H 8, T 512, Dh 32 in bf16 the forward moves 272 MB
// (0.081 ms at 3.35 TB/s) for 69 GFLOP (0.069 ms at 989 TFLOP/s), and the
// backward's five products, 172 GFLOP, bind it (0.174 ms); each direction
// also takes B H T T = 537 M exponentials, 0.128 ms at 16 a clock an SM.
// Designs, by a rule on (dtype, T, Dh, whether TMA can read q, k, v) alone,
// k8wg::plan (attention_fwd_wg.cuh), mirrored by blocked_plan in
// ops/attention_blocked.py; nothing falls back at run time:
// - wgmma (bf16, heads of 32 and 64): the forward of attention_fwd_wg.cuh
//   (a persistent grid, a TMA key / value ring, warpgroup products, the
//   exponentials overlapping the P.V product) and the one-pass backward of
//   attention_bwd.cuh with null keep bits (five products a tile pair),
//   where its layout fits shared memory (heads of 32 to T 640, of 64 to T
//   384);
// - general (everything else, and the backward past those T): the
//   tensor-core core of attention_tc.cuh (mma.sync bf16 / 3xTF32, 64-query
//   and 64-key tiles by cp.async); its backward runs 7 products, S and dP
//   twice, to keep dQ free of partial sums.

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

// K8's plan of (dtype, T, Dh, aligned) into out[0..8]: the forward's design
// (0 general, 1 wgmma) and shared memory (bytes); the backward's design,
// consumers, groups, stages, ds_bufs, smem and reg_limit (k3wg::Plan).
// ops/attention_blocked.py's blocked_plan gives the same designs.
int ishara_blocked_attention_plan(int dtype, int T, int Dh, int aligned,
                                  long long* out) {
  const k8wg::Plan p = k8wg::plan(dtype, T, Dh, aligned);
  const long long v[9] = {p.fwd,           (long long)p.fwd_smem,
                          p.bwd.design,    p.bwd.consumers,
                          p.bwd.groups,    p.bwd.stages,
                          p.bwd.ds_bufs,   (long long)p.bwd.smem,
                          p.bwd.reg_limit};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// o [B, H, T, Dh] (contiguous, q's type) and lse [B, H, T] f32 from q, k, v
// (element strides over b, h, t in qs, ks, vs; unit stride over Dh) and
// bias [B, T] f32. Tp >= T is the padded length whose padded keys enter the
// softmax with the bias -1e30. dtype 0 = f32, 1 = bf16; any Dh >= 1. The
// design is k8wg::plan's.
int ishara_blocked_attention_fwd(int device, const void* q, const void* k,
                                 const void* v, const long long* qs,
                                 const long long* ks, const long long* vs,
                                 const void* bias, void* o, void* lse, int B,
                                 int H, int T, int Tp, int Dh, float scale,
                                 int dtype, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const k8wg::Plan p =
      k8wg::plan(dtype, T, Dh, qkv_tma_ok(q, k, v, qs, ks, vs));
  if (p.fwd == k8wg::WGMMA) {
    const long long rows = (long long)k8wg::NW * k8wg::ROWS;
    const long long nq = (T + rows - 1) / rows;
    if (B <= 0 || H <= 0 || Tp < T || (long long)B * H * nq >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    k8wg::Args a{};
    a.bias = (const float*)bias;
    a.o = (__nv_bfloat16*)o;
    a.lse = (float*)lse;
    a.H = H, a.T = T, a.Tc = Tp;
    a.nq = (int)nq;
    a.nt = (Tp + k8wg::ROWS - 1) / k8wg::ROWS;
    a.units = (int)((long long)B * H * nq);
    a.scale = scale;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(Dh == 32 ? k8wg::launch_fwd<32>(q, k, v, qs, ks, vs, a, B, s)
                          : k8wg::launch_fwd<64>(q, k, v, qs, ks, vs, a, B,
                                                 s));
  }
  tc::Params P{};
  P.q = q, P.k = k, P.v = v;
  tc::set_strides(P.qs, qs);
  tc::set_strides(P.ks, ks);
  tc::set_strides(P.vs, vs);
  P.bias = (const float*)bias;
  P.o = o;
  P.lse = (float*)lse;
  P.B = B, P.H = H, P.T = T, P.Tc = Tp, P.Dh = Dh;
  P.scale = scale;
  return tc::dispatch(P, dtype, false, stream);
}

// dq, dk, dv [B, H, T, Dh] contiguous (q's type) from q, k, v, d_o (strides
// qs, ks, vs, dos), bias, the forward's o and lse. On the general design
// delta is f32 scratch [B, H, T] that the dQ launch fills and the dK / dV
// launch reads; on the wgmma design it is unused and d_o's rows must be on
// 16 bytes as q's.
int ishara_blocked_attention_bwd(int device, const void* q, const void* k,
                                 const void* v, const void* d_o,
                                 const long long* qs, const long long* ks,
                                 const long long* vs, const long long* dos,
                                 const void* bias, const void* o,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int B, int H, int T,
                                 int Dh, float scale, int dtype,
                                 void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const k8wg::Plan p =
      k8wg::plan(dtype, T, Dh, qkv_tma_ok(q, k, v, qs, ks, vs));
  if (p.bwd.design == k3wg::WGMMA) {
    if (!k3wg::tma_ok(d_o, dos) || (long long)B * H >= (1LL << 31) ||
        B <= 0 || H <= 0)
      return (int)cudaErrorInvalidValue;
    k3wg::Args a{};
    a.o = (const __nv_bfloat16*)o;
    a.d_o = (const __nv_bfloat16*)d_o;
    tc::set_strides(a.dos, dos);
    a.bias = (const float*)bias;
    a.lse = (const float*)lse;
    a.bits = nullptr;
    a.dq = (__nv_bfloat16*)dq;
    a.dk = (__nv_bfloat16*)dk;
    a.dv = (__nv_bfloat16*)dv;
    a.H = H, a.T = T;
    a.scale = scale;
    a.keep_scale = 1.f;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(Dh == 32 ? k3wg::launch<32>(p.bwd, q, k, v, d_o, qs, ks,
                                             vs, dos, a, B, s)
                          : k3wg::launch<64>(p.bwd, q, k, v, d_o, qs, ks,
                                             vs, dos, a, B, s));
  }
  tc::Params P{};
  P.q = q, P.k = k, P.v = v, P.d_o = d_o;
  tc::set_strides(P.qs, qs);
  tc::set_strides(P.ks, ks);
  tc::set_strides(P.vs, vs);
  tc::set_strides(P.dos, dos);
  P.bias = (const float*)bias;
  P.o = const_cast<void*>(o);
  P.lse = (float*)const_cast<void*>(lse);
  P.delta = (float*)delta;
  P.dq = dq, P.dk = dk, P.dv = dv;
  P.B = B, P.H = H, P.T = T, P.Tc = T, P.Dh = Dh;
  P.scale = scale;
  return tc::dispatch(P, dtype, true, stream);
}

const char* ishara_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
