// The dropout mask function shared by the training kernels (dropout.cu,
// attention.cu, ffn.cu) and by their plain PyTorch versions
// (ishara_tpu_torch/ops/dropout.py: philox_bits, keep_mask).
//
// Philox4x32-10 (Salmon et al., SC'11), keyed by a site's seed, with the
// element's flat index as the counter: element i of a tensor takes word
// (i & 3) of the block philox(counter = (i >> 2, 0, 0, 0), key = (seed, 0)).
// The mask is a function of (seed, i) alone -- not of the grid, the tile
// shape or the launch -- so a backward kernel regenerates what its forward
// drew. keep = bits >= threshold with threshold = uint32(rate * 2^32); kept
// values are scaled by 1 / (1 - rate).
//
// Replaces pltpu.prng_seed / prng_random_bits of the TPU kernels, whose
// stream depends on the grid step and cannot be reproduced.

#pragma once

#include <cstdint>

namespace philox {

constexpr uint32_t M0 = 0xD2511F53u;
constexpr uint32_t M1 = 0xCD9E8D57u;
constexpr uint32_t W0 = 0x9E3779B9u;
constexpr uint32_t W1 = 0xBB67AE85u;

// The four 32-bit words of block `group` (= flat index >> 2) under `seed`.
__device__ __forceinline__ uint4 block(uint32_t seed, uint64_t group) {
  uint32_t c0 = (uint32_t)group, c1 = (uint32_t)(group >> 32), c2 = 0u,
           c3 = 0u;
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    const uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += W0;
    k1 += W1;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t word(const uint4& b, int i) {
  return i == 0 ? b.x : i == 1 ? b.y : i == 2 ? b.z : b.w;
}

// The random word of the element at flat index `idx`.
__device__ __forceinline__ uint32_t bits(uint32_t seed, uint64_t idx) {
  return word(block(seed, idx >> 2), (int)(idx & 3));
}

// keep[j] = scale (kept) or 0 (dropped) for the four elements idx0 .. idx0+3.
// One block when idx0 is a multiple of 4, two otherwise.
__device__ __forceinline__ void keep4(uint32_t seed, uint64_t idx0,
                                      uint32_t threshold, float scale,
                                      float* keep) {
  const uint4 a = block(seed, idx0 >> 2);
  const int off = (int)(idx0 & 3);
  if (off == 0) {
    keep[0] = a.x >= threshold ? scale : 0.f;
    keep[1] = a.y >= threshold ? scale : 0.f;
    keep[2] = a.z >= threshold ? scale : 0.f;
    keep[3] = a.w >= threshold ? scale : 0.f;
    return;
  }
  const uint4 b = block(seed, (idx0 >> 2) + 1);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int w = off + j;
    const uint32_t v = w < 4 ? word(a, w) : word(b, w - 4);
    keep[j] = v >= threshold ? scale : 0.f;
  }
}

}  // namespace philox
