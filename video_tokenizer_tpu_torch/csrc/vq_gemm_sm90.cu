// Nearest-code search for wide codes on Hopper (sm_90a): fp32 scores as three
// TF32 products on the tensor cores, z and the codes streamed over d in
// k-chunks, the codebook split over a thread-block cluster.
//
// Replaces the TPU kernel video_tokenizer_tpu/ops/vq.py::_vq_kernel at the
// code dims csrc/vq_lookup_sm90.cu does not take (d % 32 == 0, 64 <= d <=
// 512): idx[m] = argmax_k (z[m] . emb[k] + bias[k]), the bias -|e_k|^2 / 2 for
// the l2 metric and absent for cos. Its caller is the Cosmos tokenizer's SimVQ
// (d = 256, K = 16,384, l2; M = 256 B rows a call, two calls a forward).
// Deterministic mode only: Gumbel-max sampling at these d is not ported (no
// JAX path draws it). Ties resolve to the LOWEST code index, whatever the
// split. Held against ops/vq.py::vq_lookup_reference;
// vq_argmax_gemm_tiled_reference repeats its arithmetic on the CPU.
//
// What bounds it: at d = 256 a search is a GEMM, 2 M K d = 17.2 GFLOP at
// M = 2048 (0.104 ms as three TF32 products at the dense TF32 rate, 0.256 ms
// as fp32 FMAs); the bytes (16.8 MB of codes, 2 MB of z) take 0.006 ms. The
// d = 4-32 kernel holds a row's z in registers and a split's codes whole in
// shared memory, which at d = 256 would be 32 k-steps of fragments a row and
// 2 MB of codes a split. What this design does instead:
//   * a block is 4 warps over 64 rows of z, which it copies into shared memory
//     once (64 x d fp32, rows padded by 16 bytes: the A fragments' reads hit
//     32 banks); a warp owns 16 rows. At d = 256 a block holds 94.7 KB, so
//     two blocks share an SM (one block of 8 warps over 128 rows, 162 KB,
//     ran slower at M = 2048: tools/tune_torch_kernels.py vq_gemm, PERF.md);
//   * the block walks its split's codes in tiles of 64, each tile's codes
//     streamed over d in k-chunks of 32 dims through a three-stage cp.async
//     ring (64 x 32 fp32 a stage, rows padded by 16 bytes);
//   * a k-chunk is four mma.sync m16n8k8 k-steps. Within a chunk a thread
//     (g = lane / 4, tig = lane % 4) takes dims 8 tig .. 8 tig + 7: slot tig
//     of k-step ks is dim 8 tig + ks and slot tig + 4 is dim 8 tig + 4 + ks, so
//     a row's eight values for the four k-steps are two 16-byte reads, for z
//     and for each code alike (the inner index permuted the same way on both
//     sides leaves each product's sum a sum over the same dims);
//   * each score is lo.hi + hi.lo + hi.hi of the TF32 parts (csrc/sm90.cuh).
//     How the d / 8 k-steps are accumulated: a k-chunk's twelve products (four
//     k-steps x three) go into an accumulator of its own that starts at zero
//     on the tensor core, which truncates what it adds into an accumulator;
//     the chunk's sum is then joined to the score by one round-to-nearest fp32
//     add (__fadd_rn); the score starts at the bias (-inf for a code past the
//     split or past K). So no accumulator takes more than twelve truncated
//     adds, and the d / 32 joins round to nearest;
//   * after a tile's last chunk each thread compares its 16 scores of each of
//     its two rows, in ascending code order, with the row's running best by
//     strict >, so the lowest index of a tie stays;
//   * occupancy: at M = 2048 there are only 32 row blocks, so the codebook is
//     split over a cluster of kCluster = 8 blocks (2048 codes each at
//     K = 16,384): 256 blocks for the 132 SMs' 264 places. Each block leaves
//     its rows' best (score, index) in its shared memory, and block r of the
//     cluster merges rows r, r + 8, ... over the cluster's shared memory in
//     split order, the larger score first and the lower index on ties. One
//     launch, no workspace, no atomics.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kCluster = 8;   // blocks of a cluster: the codebook's splits
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // rows of z a block
constexpr int kCodes = 64;           // codes of a tile: eight n-tiles of 8
constexpr int kNT = kCodes / 8;
constexpr int kChunk = 32;           // dims of a k-chunk: four k-steps of 8
constexpr int kStages = 3;
constexpr int kStageStride = kChunk + 4;  // floats of a code's row in a stage
constexpr int kStageFloats = kCodes * kStageStride;
constexpr int kMinDim = 64;
constexpr int kMaxDim = 512;  // the rows of z and the ring fit 227 KB

__host__ __device__ constexpr int z_stride(int d) { return d + 4; }

__host__ __device__ constexpr int smem_bytes(int d) {
  return (kRows * z_stride(d) + kStages * kStageFloats) * 4 + kRows * 8;
}

static_assert(smem_bytes(kMaxDim) <= 227 * 1024, "the largest d fits one block an SM");
static_assert(2 * smem_bytes(256) <= 227 * 1024, "two blocks an SM at SimVQ's d = 256");

struct Params {
  const float* z;     // [M, d]
  const float* emb;   // [K, d]
  const float* bias;  // [K] or null
  int* idx;           // [M]
  int M, K, d, slice;  // slice: codes of a split, a multiple of kCodes
};

__global__ void __launch_bounds__(kThreads, 2) vq_gemm_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* zs = reinterpret_cast<float*>(smem_raw);            // [kRows][d + 4]
  float* ring = zs + kRows * z_stride(p.d);                   // [kStages][kCodes][36]
  float* best_s = ring + kStages * kStageFloats;              // [kRows]
  int* best_i = reinterpret_cast<int*>(best_s + kRows);       // [kRows]

  const int split = blockIdx.x;  // the block's rank in its cluster
  const int row0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int zst = z_stride(p.d), n_chunks = p.d / kChunk;
  const int c_begin = split * p.slice, c_end = min(c_begin + p.slice, p.K);
  const int n_tiles = c_begin < c_end ? (c_end - c_begin + kCodes - 1) / kCodes : 0;
  const int total = n_tiles * n_chunks;

  // ---- the block's rows of z, once (zeros past M)
  for (int i = threadIdx.x; i < kRows * (p.d / 4); i += kThreads) {
    const int r = i / (p.d / 4), c = i % (p.d / 4);
    const bool in = row0 + r < p.M;
    const float* src = in ? p.z + (long long)(row0 + r) * p.d + 4 * c : p.z;
    cp_async16(smem_addr(zs + r * zst + 4 * c), src, in ? 16 : 0);
  }
  // stage `it` of the ring: codes of tile it / n_chunks, dims of chunk
  // it % n_chunks; zeros past the split
  auto load = [&](int it) {
    const int c0 = c_begin + (it / n_chunks) * kCodes, k0 = (it % n_chunks) * kChunk;
    float* dst = ring + (it % kStages) * kStageFloats;
#pragma unroll
    for (int f = 0; f < kCodes * kChunk / 4 / kThreads; ++f) {
      const int i = threadIdx.x + f * kThreads, r = i / (kChunk / 4), c = i % (kChunk / 4);
      const bool in = c0 + r < c_end;
      const float* src = in ? p.emb + (long long)(c0 + r) * p.d + k0 + 4 * c : p.emb;
      cp_async16(smem_addr(dst + r * kStageStride + 4 * c), src, in ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();  // the rows of z go with stage 0
  }

  float best[2] = {-INFINITY, -INFINITY};
  int best_idx[2] = {INT_MAX, INT_MAX};
  float score[kNT][4];  // element e of n-tile n: row g + 8 (e >> 1), code 8 n + 2 tig + (e & 1)
  const float* zr0 = zs + (16 * warp + g) * zst + 8 * tig;
  const float* zr1 = zr0 + 8 * zst;

#pragma unroll 1
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` is in; the stage `it - 1` read is no longer read
    if (it + kStages - 1 < total) load(it + kStages - 1);
    cp_async_commit();

    const int chunk = it % n_chunks, c0 = c_begin + (it / n_chunks) * kCodes;
    if (chunk == 0) {  // a new tile: the scores start at the bias, -inf past the split
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int code = c0 + 8 * n + 2 * tig + e;
          const float b = code < c_end ? (p.bias != nullptr ? __ldg(p.bias + code) : 0.f)
                                       : -INFINITY;
          score[n][e] = score[n][2 + e] = b;
        }
    }
    // the chunk's values: z rows g and g + 8, dims 8 tig .. 8 tig + 7, and the
    // same dims of codes 8 n + g, as two 16-byte reads each; k-step ks takes
    // dim 8 tig + ks in slot tig and 8 tig + 4 + ks in slot tig + 4 of both
    const int k0 = chunk * kChunk;
    const float4 x00 = *reinterpret_cast<const float4*>(zr0 + k0);
    const float4 x01 = *reinterpret_cast<const float4*>(zr0 + k0 + 4);
    const float4 x10 = *reinterpret_cast<const float4*>(zr1 + k0);
    const float4 x11 = *reinterpret_cast<const float4*>(zr1 + k0 + 4);
    const float a[4][4] = {{x00.x, x10.x, x01.x, x11.x}, {x00.y, x10.y, x01.y, x11.y},
                           {x00.z, x10.z, x01.z, x11.z}, {x00.w, x10.w, x01.w, x11.w}};
    const float* stage = ring + (it % kStages) * kStageFloats + g * kStageStride + 8 * tig;
    float b[kNT][2][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const float4 e0 = *reinterpret_cast<const float4*>(stage + 8 * n * kStageStride);
      const float4 e1 = *reinterpret_cast<const float4*>(stage + 8 * n * kStageStride + 4);
      b[n][0][0] = e0.x; b[n][0][1] = e0.y; b[n][0][2] = e0.z; b[n][0][3] = e0.w;
      b[n][1][0] = e1.x; b[n][1][1] = e1.y; b[n][1][2] = e1.z; b[n][1][3] = e1.w;
    }
    // per k-step, each of the three products over the eight n-tiles in turn:
    // consecutive mma.sync instructions write different accumulators, so
    // none waits for the one before it (lo.hi, hi.lo, hi.hi stay in that
    // order on each accumulator)
    float t[kNT][4];  // the chunk's own accumulators
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ahi[4], alo[4], bhi[kNT][2], blo[kNT][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[ks][i], ahi[i], alo[i]);
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) split_tf32(b[n][h][ks], bhi[n][h], blo[n][h]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) mma_m16n8k8_tf32(t[n], alo, bhi[n][0], bhi[n][1]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) mma_m16n8k8_tf32(t[n], ahi, blo[n][0], blo[n][1]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) mma_m16n8k8_tf32(t[n], ahi, bhi[n][0], bhi[n][1]);
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) score[n][e] = __fadd_rn(score[n][e], t[n][e]);
    if (chunk == n_chunks - 1) {  // the tile's scores against the running best
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (score[n][2 * r + e] > best[r]) {
              best[r] = score[n][2 * r + e];
              best_idx[r] = c0 + 8 * n + 2 * tig + e;
            }
    }
  }
  cp_async_wait<0>();

  // ---- the four threads of a row (one tig each), then the cluster's splits
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = best[r];
    int k = best_idx[r];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int ok = __shfl_xor_sync(0xffffffffu, k, off);
      if (ov > v || (ov == v && ok < k)) {
        v = ov;
        k = ok;
      }
    }
    if (tig == 0) {
      const int lr = 16 * warp + g + 8 * r;
      best_s[lr] = v;
      best_i[lr] = k;
    }
  }
  cluster_sync();  // every split's rows are in its shared memory
  for (int lr = split + kCluster * threadIdx.x; lr < kRows; lr += kCluster * kThreads) {
    float v = -INFINITY;
    int k = INT_MAX;
    for (int c = 0; c < kCluster; ++c) {
      const float ov = ld_cluster_f32(map_cluster_rank(smem_addr(best_s + lr), c));
      const int ok = ld_cluster_s32(map_cluster_rank(smem_addr(best_i + lr), c));
      if (ov > v || (ov == v && ok < k)) {
        v = ov;
        k = ok;
      }
    }
    if (row0 + lr < p.M) p.idx[row0 + lr] = k;
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

}  // namespace

// z [M, d], emb [K, d], bias [K] (or null) fp32 and contiguous, idx [M] int32;
// d % 32 == 0 with 64 <= d <= 512, M >= 1, K >= 1.
extern "C" int vtt_vq_argmax_gemm(const float* z, const float* emb, const float* bias, int* idx,
                                  int M, int K, int d, void* stream) {
  if (M < 1 || K < 1 || d % kChunk != 0 || d < kMinDim || d > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.z = z; p.emb = emb; p.bias = bias; p.idx = idx; p.M = M; p.K = K; p.d = d;
  p.slice = ((K + kCluster - 1) / kCluster + kCodes - 1) / kCodes * kCodes;
  cudaError_t err = cudaFuncSetAttribute(vq_gemm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(kMaxDim));
  if (err != cudaSuccess) return static_cast<int>(err);
  // all of the SM's unified memory as shared memory: two blocks of 94.7 KB at d = 256
  err = cudaFuncSetAttribute(vq_gemm_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, (M + kRows - 1) / kRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(d);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;  // the codebook's splits
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, vq_gemm_kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
