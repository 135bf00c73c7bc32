// Nearest-code search for the VQ bottleneck on Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel video_tokenizer_tpu/ops/vq.py::_vq_kernel in its
// deterministic mode: idx[m] = argmax_k (z[m] . emb[k] + bias[k]), where the
// bias is -|e_k|^2 / 2 for the l2 metric and absent for cos. Ties resolve to
// the LOWEST code index, as jnp.argmax and the TPU kernel's strict `>` merge
// do. The [M, K] score matrix never exists in device memory.
//
// Layout: a block of 256 threads serves 64 rows of z, four threads per row.
// Each thread keeps its row of z in registers (d <= 32) and scans every
// fourth code of each codebook tile, which the block stages in shared memory
// (whole codebooks exceed the 227 KB a block may use: 8192 x 8 fp32 is
// 256 KB). The four partial maxima of a row merge by warp shuffles, larger
// score first and lower index on ties, so the result does not depend on the
// split. Scores are fp32 FMAs: no tensor cores, so no TF32 rounding.
//
// What bounds it: at the flagship shape (M = K = 8192, d = 8) the search is
// about 0.5 G fused multiply-adds and reads 0.3 MB, so it is bound by the
// CUDA cores' issue rate, not by memory; z stays in registers and each code
// tile is read from shared memory as broadcasts. The Gumbel-max sampling mode
// of the TPU kernel is not here yet.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kThreadsPerRow = 4;
constexpr int kRowsPerBlock = 64;
constexpr int kThreads = kThreadsPerRow * kRowsPerBlock;
constexpr int kTileFloats = 8192;  // 32 KB of codebook per tile

template <int D>
__global__ void __launch_bounds__(kThreads)
vq_argmax_kernel(const float* __restrict__ z, const float* __restrict__ emb,
                 const float* __restrict__ bias, int* __restrict__ idx, int M, int K) {
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
                   cudaStream_t stream) {
  const int blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  vq_argmax_kernel<D><<<blocks, kThreads, 0, stream>>>(z, emb, bias, idx, M, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vtt_vq_argmax(const float* z, const float* emb, const float* bias, int* idx,
                             int M, int K, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 4: err = launch<4>(z, emb, bias, idx, M, K, s); break;
    case 8: err = launch<8>(z, emb, bias, idx, M, K, s); break;
    case 16: err = launch<16>(z, emb, bias, idx, M, K, s); break;
    case 32: err = launch<32>(z, emb, bias, idx, M, K, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
