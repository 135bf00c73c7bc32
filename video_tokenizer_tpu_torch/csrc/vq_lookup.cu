// Nearest-code search and Gumbel-max sampling for the VQ bottleneck on
// Hopper (sm_90a), fp32 FMAs: the earlier kernel.
//
// Which paths launch it: none. csrc/vq_lookup_sm90.cu (the search on the
// tensor cores, the codebook split over a thread-block cluster) replaced it on
// every path: ops/vq.py::vq_kernel names that kernel for every code dim and
// both modes. This one stays built as the yardstick that chip_smoke.py times
// beside it, launched only through ops/vq.py::_vq_launch by name.
//
// Replaces the TPU kernel video_tokenizer_tpu/ops/vq.py::_vq_kernel in both
// of its modes:
//   * deterministic: idx[m] = argmax_k (z[m] . emb[k] + bias[k]), where the
//     bias is -|e_k|^2 / 2 for the l2 metric and absent for cos;
//   * stochastic (Gumbel-max, the training path of the flagship's VQ):
//     idx[m] = argmax_k ((z[m] . emb[k] + bias[k]) * inv_temp + g[m, k]),
//     g = -log(-log(u + 1e-10) + 1e-10), u uniform in [0, 1) from 24 random
//     bits, i.e. a sample of softmax(score * inv_temp).
// Ties resolve to the LOWEST code index, as jnp.argmax and the TPU kernel's
// strict `>` merge do. The [M, K] score matrix never exists in device memory.
//
// Random bits: the TPU kernel draws from the core's own PRNG, which has no
// CUDA counterpart. Here they come from a counter-based Philox4x32-10 keyed
// by the 64-bit seed: one call on the counter (k / 4, m, 0, 0) gives the 32
// bits of codes 4 * (k / 4) .. 4 * (k / 4) + 3 of row m, so every draw is a
// pure function of (seed, row, code) and does not depend on the tiling.
// ops/vq.py::philox4x32_10 computes the same bits in PyTorch, so the kernel
// and the plain version can be held index for index.
//
// Layout: a block of 256 threads serves 64 rows of z, four threads per row.
// Each thread keeps its row of z in registers (d <= 32) and scans every
// fourth code (every fourth group of four codes when sampling) of each
// codebook tile, which the block stages in shared memory (whole codebooks
// exceed the 227 KB a block may use: 8192 x 8 fp32 is 256 KB). Each thread
// scans its codes in ascending order; the four partial maxima of a row merge
// by warp shuffles, larger score first and lower index on ties, so the result
// does not depend on the split. Scores are fp32 FMAs: no tensor cores, so no
// TF32 rounding.
//
// What bounds it: at the flagship shape (M = K = 8192, d = 8) the search is
// about 0.5 G fused multiply-adds and reads 0.3 MB, so it is bound by the
// CUDA cores' issue rate, not by memory; z stays in registers and each code
// tile is read from shared memory as broadcasts. Sampling adds one Philox
// (ten rounds of two 32-bit multiplies) per four codes and two logf per code.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreadsPerRow = 4;
constexpr int kRowsPerBlock = 64;
constexpr int kThreads = kThreadsPerRow * kRowsPerBlock;
constexpr int kTileFloats = 8192;  // 32 KB of codebook per tile

template <int D>
__global__ void __launch_bounds__(kThreads)
vq_argmax_kernel(const float* __restrict__ z, const float* __restrict__ emb,
                 const float* __restrict__ bias, int* __restrict__ idx, int M, int K,
                 int stochastic, float inv_temp, uint32_t key0, uint32_t key1) {
  constexpr int kTileCodes = kTileFloats / D;
  __shared__ __align__(16) float sE[kTileFloats];
  __shared__ float sB[kTileCodes];

  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kThreadsPerRow;
  const int part = threadIdx.x % kThreadsPerRow;
  float zr[D];
#pragma unroll
  for (int j = 0; j < D; ++j) zr[j] = row < M ? z[(long long)row * D + j] : 0.f;

  float best = -INFINITY;
  int best_idx = 0;
  for (int c0 = 0; c0 < K; c0 += kTileCodes) {
    const int n = min(kTileCodes, K - c0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < n * D; i += kThreads) sE[i] = emb[(long long)c0 * D + i];
    for (int i = threadIdx.x; i < n; i += kThreads) sB[i] = bias != nullptr ? bias[c0 + i] : 0.f;
    __syncthreads();
    if (!stochastic) {
#pragma unroll 4
      for (int c = part; c < n; c += kThreadsPerRow) {
        const float* e = sE + c * D;
        float s = zr[0] * e[0];
#pragma unroll
        for (int j = 1; j < D; ++j) s = fmaf(zr[j], e[j], s);
        if (bias != nullptr) s += sB[c];
        if (s > best) {  // ascending scan: the first maximum is kept
          best = s;
          best_idx = c0 + c;
        }
      }
    } else {
      // groups of four codes (c0 is a multiple of 4): one Philox call each
      for (int c4 = part * 4; c4 < n; c4 += kThreadsPerRow * 4) {
        const uint4 r = philox4x32_10(make_uint4((uint32_t)((c0 + c4) / 4), (uint32_t)row, 0u, 0u),
                                      key0, key1);
        const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c4 + j;
          if (c >= n) break;
          const float* e = sE + c * D;
          float s = zr[0] * e[0];
#pragma unroll
          for (int jj = 1; jj < D; ++jj) s = fmaf(zr[jj], e[jj], s);
          if (bias != nullptr) s += sB[c];
          s = __fadd_rn(__fmul_rn(s, inv_temp), gumbel(bits[j]));
          if (s > best) {
            best = s;
            best_idx = c0 + c;
          }
        }
      }
    }
  }
  // merge the row's four partial results (lanes 4r .. 4r+3 of the warp)
#pragma unroll
  for (int off = 1; off < kThreadsPerRow; off <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_idx, off);
    if (ov > best || (ov == best && oi < best_idx)) {
      best = ov;
      best_idx = oi;
    }
  }
  if (row < M && part == 0) idx[row] = best_idx;
}

template <int D>
cudaError_t launch(const float* z, const float* emb, const float* bias, int* idx, int M, int K,
                   int stochastic, float inv_temp, uint32_t key0, uint32_t key1,
                   cudaStream_t stream) {
  const int blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  vq_argmax_kernel<D><<<blocks, kThreads, 0, stream>>>(z, emb, bias, idx, M, K, stochastic,
                                                       inv_temp, key0, key1);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vtt_vq_argmax(const float* z, const float* emb, const float* bias, int* idx,
                             int M, int K, int d, int stochastic, float inv_temp,
                             long long seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t k0 = (uint32_t)((unsigned long long)seed & 0xFFFFFFFFull);
  const uint32_t k1 = (uint32_t)((unsigned long long)seed >> 32);
  cudaError_t err;
  switch (d) {
    case 4: err = launch<4>(z, emb, bias, idx, M, K, stochastic, inv_temp, k0, k1, s); break;
    case 8: err = launch<8>(z, emb, bias, idx, M, K, stochastic, inv_temp, k0, k1, s); break;
    case 16: err = launch<16>(z, emb, bias, idx, M, K, stochastic, inv_temp, k0, k1, s); break;
    case 32: err = launch<32>(z, emb, bias, idx, M, K, stochastic, inv_temp, k0, k1, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
