// Tiled multi-head self-attention for long sequences on Hopper (sm_90a),
// forward and backward, no dropout (K8).
//
// Replaces the Pallas kernels _fwd_kernel, _dq_kernel and _dkv_kernel of
// ishara_tpu/ops/attention_blocked.py (behind flash_mhsa_blocked): keys
// streamed with the online-softmax recurrence, so nothing of size [T, T] is
// held and any T runs; the forward saves the row logsumexp, the backward is
// a dQ pass and a dK / dV pass that recompute the probabilities from it, with
// no sum shared between blocks and no atomics: the gradients are the same
// from run to run.
//
// Semantics as the reference: s = q.k * scale + bias with a [B, T] additive
// key bias (0 or -1e30). T is padded to Tp (the caller's multiple, the
// reference's lcm of its block sizes); a padded key has k = v = 0 and the
// bias -1e30 and counts: a row whose keys are all masked has every score at
// -1e30, so each of the Tp keys gets the weight 1 / Tp, padded zeros
// included, and lse rounds to -1e30 exactly, as in the reference. Keys at
// or beyond Tp are excluded (the core's tile of 64 need not divide Tp).
// Backward: p = exp(s - lse), dp = dO . v, ds = p * (dp - delta) with
// delta = rowsum(dO * O); padded queries and keys add exact zeros to the
// gradients the reference keeps, so the backward stops at T.
//
// Bound: at B 256, H 8, T 512, Dh 32 in bf16 the forward moves 272 MB
// (0.081 ms at 3.35 TB/s) for 69 GFLOP (0.069 ms at 989 TFLOP/s), and the
// backward's five products, 172 GFLOP, bind it (0.174 ms). Design: the
// tensor-core core of attention_tc.cuh (mma.sync bf16 / 3xTF32, 64-query
// and 64-key tiles by cp.async, softmax and P in registers); the backward
// runs 7 products, S and dP twice, to keep dQ free of partial sums.

#include "attention_tc.cuh"

extern "C" {

// o [B, H, T, Dh] (contiguous, q's type) and lse [B, H, T] f32 from q, k, v
// (element strides over b, h, t in qs, ks, vs; unit stride over Dh) and
// bias [B, T] f32. Tp >= T is the padded length whose padded keys enter the
// softmax with the bias -1e30. dtype 0 = f32, 1 = bf16; any Dh >= 1.
int ishara_blocked_attention_fwd(int device, const void* q, const void* k,
                                 const void* v, const long long* qs,
                                 const long long* ks, const long long* vs,
                                 const void* bias, void* o, void* lse, int B,
                                 int H, int T, int Tp, int Dh, float scale,
                                 int dtype, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
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
// qs, ks, vs, dos), bias, the forward's o and lse; delta is f32 scratch
// [B, H, T] that the dQ launch fills and the dK / dV launch reads.
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
