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
// r0 H T T and draws the whole batch's mask there. A row whose keys are all masked averages V over its T keys; keys
// beyond T are excluded (Tc = T).
//
// Bound: bytes. At B 256, H 8, T 176, Dh 32 in bf16 the forward moves
// 94 MB (0.028 ms at 3.35 TB/s) for 8 GFLOP (0.008 ms on the tensor cores)
// and the backward 186 MB for 20 GFLOP. Design: the tensor-core core of
// attention_tc.cuh (64-query tiles of 4 warps, 64-key tiles by cp.async,
// mma.sync bf16 / 3xTF32, the softmax and P in registers); the Philox words
// are computed once per 4 weights and shared by shuffles, since at T 176
// they cost about as many instructions as the products.

#include "attention_tc.cuh"

extern "C" {

// o [B, H, T, Dh] and lse [B, H, T] from q, k, v (element strides over
// b, h, t in qs, ks, vs; unit stride over Dh), bias [B, T] f32, one int32
// seed on the device, the mask's index offset. dtype 0 = f32, 1 = bf16.
// threshold 0 means no dropout.
int ishara_attention_fwd(int device, const void* q, const void* k,
                         const void* v, const long long* qs,
                         const long long* ks, const long long* vs,
                         const void* bias, const void* seed, void* o,
                         void* lse, int B, int H, int T, int Dh, float scale,
                         unsigned int threshold, float keep_scale,
                         unsigned long long offset, int dtype, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
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
  if (T > 384) return (int)cudaErrorInvalidValue;
  return tc::dispatch(P, dtype, false, stream);
}

// dq, dk, dv [B, H, T, Dh] contiguous from the forward's inputs, its o and
// lse, and d_o (strides dos); delta is f32 scratch [B, H, T] that the dQ
// launch fills and the dK / dV launch reads.
int ishara_attention_bwd(int device, const void* q, const void* k,
                         const void* v, const void* d_o, const long long* qs,
                         const long long* ks, const long long* vs,
                         const long long* dos, const void* bias,
                         const void* seed, const void* o, const void* lse,
                         void* delta, void* dq, void* dk, void* dv, int B,
                         int H, int T, int Dh, float scale,
                         unsigned int threshold, float keep_scale,
                         unsigned long long offset, int dtype, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
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
  if (T > 384) return (int)cudaErrorInvalidValue;
  return tc::dispatch(P, dtype, true, stream);
}

const char* ishara_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
