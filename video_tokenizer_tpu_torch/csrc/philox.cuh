// The random bits and the Gumbel noise of the VQ bottleneck's stochastic mode,
// shared by csrc/vq_lookup.cu and csrc/vq_lookup_sm90.cu so that the two
// kernels draw the same noise. ops/vq.py::philox4x32_10 and gumbel_noise
// compute the same bits and values in PyTorch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Philox4x32-10 (Salmon et al., SC 2011): ten rounds, the key bumped by the
// Weyl constants between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// g = -log(-log(u + 1e-10) + 1e-10), u = the low 24 bits / 2^24
__device__ __forceinline__ float gumbel(uint32_t bits) {
  // explicit roundings (no contraction into FMAs), as the plain version rounds
  const float u = __fmul_rn((float)(bits & 0x00FFFFFFu), 1.0f / 16777216.0f);
  return -logf(__fadd_rn(-logf(__fadd_rn(u, 1e-10f)), 1e-10f));
}
