// Weight-only int8 matrix product for few rows (M <= 128), for Hopper
// (sm_90a): y = (x @ w8) * scale with one pass over the weights.
//
// Replaces, at M <= 128 (speculative chunks, and in a decode step the
// prior's w2: where ops/quant_matmul.py::w8_kernel names it), the same TPU
// kernel as csrc/w8_matmul.cu (which keeps M > 128, prefill and NLL, K not a
// multiple of 16, and M <= 16 at K <= 2048):
//   * video_tokenizer_tpu/ops/quant_matmul.py::_w8_kernel.
// What it computes is stated at the head of csrc/w8_matmul.cu and held against
// w8_matmul_reference in ops/quant_matmul.py: int8 weights stored [N, K] (each
// output channel's K weights contiguous) become bf16 exactly, sums are fp32, a
// bf16 x is used as it is and an fp32 x as three bf16 parts whose sum is x, and
// the epilogue rounds once (the TPU kernel's) or twice (the JAX QuantDense's).
//
// What bounds it: the weight bytes. At the 632M prior's decode shape (M = 16)
// a product does 2 M = 32 operations per weight byte against the card's ~295,
// at the speculative verify chunk (M = 80) 160: one decode step's 151
// projections read 620 MB of int8 weights, 0.185 ms at 3.35 TB/s. Each
// projection is 1.6-10.5 MB, a few microseconds of stream, so what a launch
// costs besides the stream (its start, the first bytes' latency, the tail)
// weighs as much as the stream. The earlier kernel reached ~30% of the bound:
// a block of 8 warps kept ~8 KB of loads in flight with no prefetch, wo and w2
// (N = 1280) launched 80 blocks on 132 SMs, x was reloaded (and an fp32 x
// re-split) for every k16 step of every tile, and M = 80 ran on a 64-row
// tiling that fetched every weight twice. What the design does about it:
//   * swap-AB on mma.sync m16n8k16: 16 output channels are a warp's A rows,
//     the x rows the B columns (8 per n-tile, up to 16 n-tiles). A warp's A
//     fragments, converted from int8 once per stage (the byte in the mantissa
//     of 2^23, exact), serve every n-tile, so each weight byte is read once
//     whatever M is;
//   * a block of 1-4 warps owns 16 channels per warp over one K range (a
//     split), and stages its x rows over that range once in shared memory for
//     all its warps (bf16 x), so x is read from L2 once per 64 channels and not
//     once per 16;
//   * each warp streams its channels' rows through its own ring of kStages
//     stages (16 rows x 128 K bytes) by 16-byte cp.async copies. A thread
//     copies exactly the 64 bytes that its fragments use, so the ring needs
//     no barrier;
//   * split-K across blocks where the channel groups are too few for the card
//     (the wrapper's plan, ops/quant_matmul.py::w8_plan): the splits of a
//     channel group are one thread block cluster (at most 8 blocks). Each block
//     leaves its fp32 sums in its shared memory, and block r of the cluster
//     sums share r of the outputs over the cluster's shared memory in split
//     order and runs the epilogue. No partials go through global memory, no
//     atomic count, no second launch; every sum has a fixed order, so results
//     repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kMaxWarps = 4;
constexpr int kWarpN = 16;                      // output channels of a warp: its A rows
constexpr int kStageK = 128;                    // K of one ring stage
constexpr int kStages = 8;                      // stages in a warp's ring
constexpr int kStageBytes = kWarpN * kStageK;   // 2 KB
constexpr int kMaxRows = 128;
constexpr int kMaxXBytes = 160 * 1024;          // a block's staged x rows (bf16)
constexpr int kMaxSplits = 8;                   // blocks of a cluster (the portable most)
constexpr int kMaxChains = 4;                   // accumulators per n-tile (few rows)

struct Params {
  const void* x;         // [M, K] bf16 or fp32, contiguous
  const int8_t* w;       // [N, K] int8, contiguous
  const float* scale;    // [N]
  void* out;             // [M, N] in x's dtype
  int M, N, K, splits, double_round;
};

// y for output (m, n) from its fp32 sum: the two epilogues of csrc/w8_matmul.cu
template <typename TX>
__device__ __forceinline__ void store_out(const Params& p, int m, int n, float y) {
  TX* dst = static_cast<TX*>(p.out) + (long long)m * p.N + n;
  if constexpr (sizeof(TX) == 2) {
    if (p.double_round) {
      const float yr = __bfloat162float(__float2bfloat16(y));
      const float sr = __bfloat162float(__float2bfloat16(p.scale[n]));
      *dst = __float2bfloat16(yr * sr);
    } else {
      *dst = __float2bfloat16(y * p.scale[n]);
    }
  } else {
    *dst = y * p.scale[n];  // fp32: both epilogues are one fp32 product
  }
}

// An fp32 x row m at K k .. k + 15 as the B fragments of four k16 steps, three
// bf16 parts each: part q of step s is words b[q][s][0] (elements 4 s, 4 s + 1)
// and b[q][s][1] (4 s + 2, 4 s + 3). Zero past M or K (K is a multiple of 16).
// Read through L2 (the kernel before wrote x).
__device__ __forceinline__ void load_x16_fp32(const Params& p, int m, int k, uint32_t (&b)[3][4][2]) {
  const bool in = m < p.M && k < p.K;
  const float* src = static_cast<const float*>(p.x) + (in ? (long long)m * p.K + k : 0);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float4 v = in ? __ldcg(reinterpret_cast<const float4*>(src) + s) : make_float4(0, 0, 0, 0);
    float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
      b[q][s][0] = *reinterpret_cast<const uint32_t*>(&lo);
      b[q][s][1] = *reinterpret_cast<const uint32_t*>(&hi);
      f[0] -= __low2float(lo), f[1] -= __high2float(lo);  // exact in fp32
      f[2] -= __low2float(hi), f[3] -= __high2float(hi);
    }
  }
}

// A block's K range: stages [s0, s0 + count) of the K / 128 stages, split
// `split` of `splits` (the dealing ops/quant_matmul.py::w8_slices repeats).
__host__ __device__ inline void block_stages(int stages, int split, int splits, int& s0, int& count) {
  s0 = (int)((long long)stages * split / splits);
  count = (int)((long long)stages * (split + 1) / splits) - s0;
}

// Bytes of one staged x row: the block's widest K range in bf16, and 16 bytes
// so that the rows a quarter-warp reads fall in different banks.
__host__ __device__ inline int x_row_bytes(int stages, int splits) {
  return (stages + splits - 1) / splits * kStageK * 2 + 16;
}

// Shared memory of a block: each warp's ring, then (bf16 x) the staged x rows;
// after the loop the rings hold the block's fp32 sums for the cluster's
// reduction, rows of block_n + 4 floats (so that the four row pairs a
// quarter-warp writes fall in different banks).
__host__ __device__ inline int red_row_floats(int warps) { return warps * kWarpN + 4; }

template <typename TX, int NT>
__global__ void __launch_bounds__(kMaxWarps * 32) w8_stream_kernel(const Params p) {
  constexpr bool kStageX = sizeof(TX) == 2;
  constexpr int kRows = NT * 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5, block_n = warps * kWarpN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * block_n, nw = n0 + warp * kWarpN;
  const int split = blockIdx.y;
  const int stages = (p.K + kStageK - 1) / kStageK;
  int s0, count;
  block_stages(stages, split, p.splits, s0, count);
  const int k0 = s0 * kStageK;
  const int ring_bytes = max(warps * kStages * kStageBytes, kRows * red_row_floats(warps) * 4);

  // ---- the weights: this thread copies (and alone reads) K bytes 64 j + 16
  // tig .. + 15 of each stage of channels nw + g (i = 0) and nw + g + 8 (i =
  // 1), to byte (2 i + j) 512 + 16 lane of the stage
  const uint32_t ring = smem_addr(smem_raw) + warp * kStages * kStageBytes;
  const int8_t* rows[2];
  bool in_n[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = nw + g + 8 * i;
    in_n[i] = n < p.N;
    rows[i] = p.w + (long long)min(n, p.N - 1) * p.K + tig * 16;
  }
  auto load = [&](int it) {
    const int k = k0 + it * kStageK;
    const uint32_t stage = ring + (it % kStages) * kStageBytes + lane * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool in = in_n[i] && k + 64 * j + tig * 16 < p.K;
        cp_async16(stage + (2 * i + j) * 512, in ? rows[i] + k + 64 * j : p.w, in ? 16 : 0);
      }
  };
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < count) load(it);
    cp_async_commit();
  }

  // ---- the x rows
  const int x_row = x_row_bytes(stages, p.splits);
  unsigned char* xs = smem_raw + ring_bytes;
  if constexpr (kStageX) {
    // x rows 0 .. kRows - 1 over [k0, k0 + 128 count), zero past M or K: one
    // more group of copies, after which every copy so far has landed
    const int pieces = count * kStageK / 8;  // 16-byte pieces of a row
    for (int i = threadIdx.x; i < kRows * pieces; i += blockDim.x) {
      const int m = i / pieces, k = k0 + (i % pieces) * 8;
      const bool in = m < p.M && k < p.K;
      cp_async16(smem_addr(xs + m * x_row + (i % pieces) * 16),
                 static_cast<const TX*>(p.x) + (in ? (long long)m * p.K + k : 0), in ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // k16 step s adds into chain s % kChains: with few n-tiles, several
  // independent chains of mma keep the tensor pipe busy where one chain would
  // wait out each product's latency; summed in chain order at the end
  constexpr int kChains = NT <= 2 ? kMaxChains : (NT <= 4 && kMaxChains >= 2 ? 2 : 1);
  float acc[kChains][NT][4];
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][t][e] = 0.f;

  for (int it = 0; it < count; ++it) {
    // stage `it` has landed (the x rows' group, if any, came after the first
    // kStages - 1 stages and before every later one); the stage of it - 1,
    // read by this thread alone in the last iteration, is refilled
    cp_async_wait<kStages - 2>();
    if (it + kStages - 1 < count) load(it + kStages - 1);
    cp_async_commit();
    const unsigned char* stage = smem_raw + (warp * kStages + it % kStages) * kStageBytes + lane * 16;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // A fragments of k16 steps 4 j .. 4 j + 3: step s takes word s of both
      // rows; the thread's k slots {2 tig, 2 tig + 1} hold K bytes 4 s, 4 s + 1
      // of its 16 and slots {2 tig + 8, 2 tig + 9} bytes 4 s + 2, 4 s + 3, in A
      // and B alike
      const uint4 wl = *reinterpret_cast<const uint4*>(stage + j * 512);
      const uint4 wh = *reinterpret_cast<const uint4*>(stage + (2 + j) * 512);
      const uint32_t lo_w[4] = {wl.x ^ 0x80808080u, wl.y ^ 0x80808080u, wl.z ^ 0x80808080u,
                                wl.w ^ 0x80808080u};
      const uint32_t hi_w[4] = {wh.x ^ 0x80808080u, wh.y ^ 0x80808080u, wh.z ^ 0x80808080u,
                                wh.w ^ 0x80808080u};
      uint32_t a[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        a[s][0] = int8_pair_to_bf16(lo_w[s], 0, lo_w[s], 1);
        a[s][1] = int8_pair_to_bf16(hi_w[s], 0, hi_w[s], 1);
        a[s][2] = int8_pair_to_bf16(lo_w[s], 2, lo_w[s], 3);
        a[s][3] = int8_pair_to_bf16(hi_w[s], 2, hi_w[s], 3);
      }
      const int kr = it * kStageK + 64 * j + 16 * tig;  // K of the thread's 16, from k0
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if constexpr (kStageX) {
          // x row 8 t + g, K elements kr .. kr + 15
          const unsigned char* src = xs + (8 * t + g) * x_row + kr * 2;
          const uint4 lo = *reinterpret_cast<const uint4*>(src);
          const uint4 hi = *reinterpret_cast<const uint4*>(src + 16);
          const uint32_t b[4][2] = {{lo.x, lo.y}, {lo.z, lo.w}, {hi.x, hi.y}, {hi.z, hi.w}};
#pragma unroll
          for (int s = 0; s < 4; ++s) mma_m16n8k16(acc[s % kChains][t], a[s], b[s][0], b[s][1]);
        } else {
          uint32_t b[3][4][2];
          load_x16_fp32(p, 8 * t + g, k0 + kr, b);
#pragma unroll
          for (int s = 0; s < 4; ++s)
#pragma unroll
            for (int q = 0; q < 3; ++q)
              mma_m16n8k16(acc[s % kChains][t], a[s], b[q][s][0], b[q][s][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int c = 1; c < kChains; ++c)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][t][e] += acc[c][t][e];

  // acc[0][t][e]: channel nw + g + 8 (e / 2), x row 8 t + 2 tig + e % 2
  if (p.splits == 1) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * t + 2 * tig + (e & 1), n = nw + g + 8 * (e >> 1);
        if (m < p.M && n < p.N) store_out<TX>(p, m, n, acc[0][t][e]);
      }
    return;
  }

  // ---- split K: the splits of a channel group are one cluster. Each block
  // puts its sums in its own shared memory; then block r of the cluster sums
  // share r of the outputs over the blocks' shared memory in split order, so
  // the result does not depend on which block ran first.
  __syncthreads();  // every warp is done with its ring
  const int rr = red_row_floats(warps);
  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(8 * t + 2 * tig + (e & 1)) * rr + warp * kWarpN + g + 8 * (e >> 1)] = acc[0][t][e];
  cluster_sync();  // the cluster's sums are written
  const int total = p.M * block_n;
  const int lo = total * split / p.splits, hi = total * (split + 1) / p.splits;
  uint32_t peers[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    peers[s] = map_cluster_rank(smem_addr(red), s < p.splits ? s : 0);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int m = i / block_n, nl = i % block_n;
    float v[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      v[s] = s < p.splits ? ld_cluster_f32(peers[s] + (m * rr + nl) * 4) : 0.f;
    float y = v[0];
#pragma unroll
    for (int s = 1; s < kMaxSplits; ++s)
      if (s < p.splits) y += v[s];
    if (n0 + nl < p.N) store_out<TX>(p, m, n0 + nl, y);
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

template <typename TX, int NT>
cudaError_t launch(const Params& p, int warps, cudaStream_t stream) {
  const int stages = (p.K + kStageK - 1) / kStageK;
  const int x_bytes = sizeof(TX) == 2 ? NT * 8 * x_row_bytes(stages, p.splits) : 0;
  if (x_bytes > kMaxXBytes) return cudaErrorInvalidValue;  // the plan keeps x within bounds
  const int smem =
      std::max(warps * kStages * kStageBytes, NT * 8 * red_row_floats(warps) * 4) + x_bytes;
  auto kernel = w8_stream_kernel<TX, NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + warps * kWarpN - 1) / (warps * kWarpN), p.splits);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;  // the splits of a channel group
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = p.splits;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// n-tiles of 8 x rows: the least instance that holds M
template <typename TX>
cudaError_t dispatch_rows(const Params& p, int warps, cudaStream_t stream) {
  const int nt = (p.M + 7) / 8;
  if (nt <= 1) return launch<TX, 1>(p, warps, stream);
  if (nt <= 2) return launch<TX, 2>(p, warps, stream);
  if (nt <= 4) return launch<TX, 4>(p, warps, stream);
  if (nt <= 6) return launch<TX, 6>(p, warps, stream);
  if (nt <= 8) return launch<TX, 8>(p, warps, stream);
  if (nt <= 10) return launch<TX, 10>(p, warps, stream);
  return launch<TX, 16>(p, warps, stream);
}

}  // namespace

// x [M, K] (bf16 if x_bf16, else fp32), w [N, K] int8, scale [N] fp32, out
// [M, N] in x's dtype; all contiguous and 16-byte aligned, 1 <= M <= 128, K a
// multiple of 16, 1 <= warps <= 4 (16 channels each), 1 <= splits <= min(8,
// ceil(K / 128)), and (bf16 x) a block's x rows within kMaxXBytes.
extern "C" int vtt_w8_matmul_stream(const void* x, const int8_t* w, const float* scale, void* out,
                                    int x_bf16, int M, int N, int K, int warps, int splits,
                                    int double_round, void* stream) {
  if (M < 1 || M > kMaxRows || N < 1 || K < 16 || K % 16 != 0 || warps < 1 ||
      warps > kMaxWarps || splits < 1 || splits > kMaxSplits ||
      splits > (K + kStageK - 1) / kStageK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x; p.w = w; p.scale = scale; p.out = out;
  p.M = M; p.N = N; p.K = K; p.splits = splits; p.double_round = double_round;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(x_bf16 ? dispatch_rows<__nv_bfloat16>(p, warps, s)
                                 : dispatch_rows<float>(p, warps, s));
}
