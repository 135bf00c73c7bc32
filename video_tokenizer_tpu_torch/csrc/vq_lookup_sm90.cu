// Nearest-code search and Gumbel-max sampling for the VQ bottleneck on Hopper
// (sm_90a): fp32 scores on the tensor cores as three TF32 products, the
// codebook split over a thread-block cluster.
//
// Replaces the TPU kernel video_tokenizer_tpu/ops/vq.py::_vq_kernel in both of
// its modes, as csrc/vq_lookup.cu (the earlier kernel, now on no path) did:
//   * deterministic: idx[m] = argmax_k (z[m] . emb[k] + bias[k]), the bias
//     -|e_k|^2 / 2 for the l2 metric and absent for cos;
//   * stochastic (Gumbel-max): idx[m] = argmax_k ((z[m] . emb[k] + bias[k]) *
//     inv_temp + g[m, k]), the noise g of csrc/philox.cuh on the counter
//     (k / 4, m, 0, 0), bit for bit what ops/vq.py::gumbel_noise draws.
// Ties resolve to the LOWEST code index, whatever the split. Held against
// ops/vq.py::vq_lookup_reference; vq_argmax_tf32x3_tiled_reference repeats its
// arithmetic on the CPU.
//
// What bounds it: at the flagship shape (M = K = 8192, d = 8) the scores are
// 0.5 G multiply-adds, 16 us as fp32 FMAs or 6.5 us as three TF32 products on
// the tensor cores, and 67 M compares; the bytes (0.3 MB) are nothing. The
// earlier kernel (4 threads a row, an 8-deep FMA chain and a compare per code,
// 128 blocks of 8 warps, a synchronous 32 KB codebook tile between two block
// barriers) ran at a latency-bound 0.127 ms. Sampling adds a Philox call per
// four codes and two logf per code: integer multiplies and special functions,
// where only more warps in flight help (the earlier kernel: 0.47 ms).
// What the design does about it:
//   * width: the codebook is split over a cluster of kCluster blocks, each
//     keeping its K / kCluster codes whole in shared memory, split into their
//     TF32 parts once, in the order the mma B fragments want them (one
//     16-byte load a lane gives the hi and lo parts of two dims of one code).
//     A warp takes 16-row tiles of z (two for the search at d <= 8, where a B
//     fragment then feeds two products; one when sampling: 0.264 against
//     0.314 ms with two), its fragments split into TF32 parts once, in
//     registers. A block is 8 warps; two blocks an SM. A tile's loads are
//     issued in batches before the first is used;
//   * tensor cores: a k-step of mma.sync m16n8k8 TF32 is 8 dims, so d = 8 is
//     one step, d = 4 one step with zero padding, d = 16, 24 (the Leech
//     codebook of the sq bottleneck: K = 196,560) and 32 two, three and four.
//     Each score is lo.hi + hi.lo + hi.hi (csrc/sm90.cuh); the bias is the
//     accumulator's initial value, and each further k-step has an accumulator
//     of its own, joined by a rounded add (the tensor core truncates what it
//     adds into an accumulator). Codes past K score -inf through the bias;
//   * the compare: a thread holds four codes of a row per pair of n-tiles;
//     their max is compared with the running best, and only when some lane of
//     the warp found a larger one does it pick the index (the first of the
//     four that equals the max): the scan runs in ascending code order, so
//     strict > keeps the lowest index;
//   * Gumbel-max: the columns of each pair of 8-code n-tiles are permuted so
//     that the four codes a thread holds of a row are one Philox group,
//     codes 16 p + 4 tig .. + 3 (counter 4 p + tig): one call serves four
//     codes, and no group is drawn twice;
//   * the merge: each block leaves its rows' best (score, index) in its shared
//     memory, and block r of the cluster merges rows r, r + kCluster, ... over
//     the cluster's shared memory in split order, larger score first and the
//     lower index on ties. One launch, no memset, no global atomics.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kCluster = 8;  // blocks of a cluster: the codebook's splits (the portable most)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
template <int D, bool kStochastic>
struct Geometry {
  static_assert(D == 4 || D % 8 == 0, "code dim: 4 or a multiple of 8");
  static constexpr int kSteps = D <= 8 ? 1 : D / 8;     // k-steps of 8 dims
  // 16-row tiles of a warp: two for the search at d <= 8 (one B fragment feeds
  // two products); one when sampling, whose time is the Philox and logf work
  // of each score, which more warps in flight hide better
  static constexpr int kMT = D <= 8 && !kStochastic ? 2 : 1;
  static constexpr int kRows = 16 * kMT * kWarps;       // rows of a cluster
  // codes of a tile: 64 KB of TF32 fragments (64 B a code and k-step) where
  // that divides, and 512 codes (96 KB) at d = 24, whose 65,536 / 192 = 341
  // would not; two blocks an SM fit either way
  static constexpr int kTileCodes = D == 24 ? 512 : 64 * 1024 / (64 * kSteps);
  static constexpr int kFragBytes = kTileCodes * 64 * kSteps;
  static constexpr int kSmemBytes = kFragBytes + kTileCodes * 4 + kRows * 8;
  // n-tiles go in pairs of 16 codes; each thread loads whole shares of a
  // tile's bias values and fragments
  static_assert(kTileCodes % 16 == 0 && kTileCodes % kThreads == 0, "tile of codes");
  static_assert(kFragBytes % (16 * kThreads) == 0, "tile of fragments");
  static_assert(2 * kSmemBytes <= 227 * 1024, "two blocks an SM");
};

struct Params {
  const float* z;     // [M, D]
  const float* emb;   // [K, D]
  const float* bias;  // [K] or null
  int* idx;           // [M]
  int M, K, slice;    // slice: codes of a split, a multiple of 16
  float inv_temp;
  uint32_t key0, key1;
};

// Code offset (within a tile) of column c of n-tile j: n-tiles go in pairs of
// 16 codes, and thread tig's columns 2 tig, 2 tig + 1 of both tiles of a pair
// are the four consecutive codes 16 p + 4 tig .. 16 p + 4 tig + 3.
__device__ __forceinline__ int tile_code(int j, int c) {
  return 16 * (j >> 1) + 4 * (c >> 1) + 2 * (j & 1) + (c & 1);
}

template <int D, bool kStochastic>
__global__ void __launch_bounds__(kThreads, 2) vq_tc_kernel(const Params p) {
  using Geo = Geometry<D, kStochastic>;
  constexpr int KS = Geo::kSteps, MT = Geo::kMT, TC = Geo::kTileCodes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* frag = reinterpret_cast<uint4*>(smem_raw);                // [TC / 8][KS][32 lanes]
  float* sbias = reinterpret_cast<float*>(smem_raw + Geo::kFragBytes);  // [TC] by tile position
  float* best_s = sbias + TC;                                      // [kRows]
  int* best_i = reinterpret_cast<int*>(best_s + Geo::kRows);       // [kRows]

  const int split = blockIdx.x;  // the block's rank in its cluster
  const int row0 = blockIdx.y * Geo::kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;

  // ---- this warp's rows as A fragments, split into TF32 parts once:
  // a[i] = z[row g + 8 (i & 1)][8 ks + tig + 4 (i >> 1)]
  uint32_t ahi[MT][KS][4], alo[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + 16 * (MT * warp + mt) + g + 8 * (i & 1);
        const int dim = 8 * ks + tig + 4 * (i >> 1);
        const float x = row < p.M && dim < D ? p.z[(long long)row * D + dim] : 0.f;
        split_tf32(x, ahi[mt][ks][i], alo[mt][ks][i]);
      }
    }
  }

  float best[MT][2];
  int best_idx[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      best[mt][r] = -INFINITY;
      best_idx[mt][r] = INT_MAX;
    }

  const int c_begin = split * p.slice, c_end = min(c_begin + p.slice, p.K);
  for (int c0 = c_begin; c0 < c_end; c0 += TC) {
    const int n16 = (min(TC, c_end - c0) + 15) / 16 * 16;
    __syncthreads();  // the previous tile is no longer read
    // the tile's codes as B fragments: lane (g, tig) of n-tile j and k-step
    // ks gets {hi, hi, lo, lo} of dims 8 ks + tig and 8 ks + tig + 4 of code
    // tile_code(j, g); codes past the split or past K are zeros
    // (a thread's loads issued in batches of kBatch before the first is used:
    // a tile's fragments are kFill entries a thread, its bias kFillBias values)
    constexpr int kFill = Geo::kFragBytes / 16 / kThreads, kFillBias = TC / kThreads, kBatch = 8;
    static_assert(kFill % kBatch == 0, "whole batches of loads");
    const int n_frag = n16 / 8 * KS * 32;
    float eb[kFillBias];
#pragma unroll
    for (int f = 0; f < kFillBias; ++f) {
      const int i = threadIdx.x + f * kThreads, code = c0 + tile_code(i >> 3, i & 7);
      eb[f] = code < c_end ? (p.bias != nullptr ? p.bias[code] : 0.f) : -INFINITY;
    }
#pragma unroll 1
    for (int f0 = 0; f0 < kFill; f0 += kBatch) {
      float e[kBatch][2];
#pragma unroll
      for (int f = 0; f < kBatch; ++f) {
        const int i = threadIdx.x + (f0 + f) * kThreads, ln = i & 31, ks = (i >> 5) % KS;
        const int code = c0 + tile_code((i >> 5) / KS, ln >> 2), d0 = 8 * ks + (ln & 3);
        const bool in = i < n_frag && code < c_end;
        e[f][0] = in && d0 < D ? p.emb[(long long)code * D + d0] : 0.f;
        e[f][1] = in && d0 + 4 < D ? p.emb[(long long)code * D + d0 + 4] : 0.f;
      }
#pragma unroll
      for (int f = 0; f < kBatch; ++f) {
        const int i = threadIdx.x + (f0 + f) * kThreads;
        if (i < n_frag) {
          uint4 w;
          split_tf32(e[f][0], w.x, w.z);
          split_tf32(e[f][1], w.y, w.w);
          frag[i] = w;
        }
      }
    }
#pragma unroll
    for (int f = 0; f < kFillBias; ++f) sbias[threadIdx.x + f * kThreads] = eb[f];
    __syncthreads();

    // acc[mt][h] of pair jp: n-tile 2 jp + h, the bias as the initial value
    auto products = [&](int jp, float (&acc)[MT][2][4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 bb = *reinterpret_cast<const float2*>(sbias + (2 * jp + h) * 8 + 2 * tig);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][h][0] = acc[mt][h][2] = bb.x;
          acc[mt][h][1] = acc[mt][h][3] = bb.y;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const uint4 f = frag[((2 * jp + h) * KS + ks) * 32 + lane];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (ks == 0) {
              mma_m16n8k8_tf32x3(acc[mt][h], ahi[mt][0], alo[mt][0], f.x, f.y, f.z, f.w);
            } else {
              float t[4] = {0.f, 0.f, 0.f, 0.f};
              mma_m16n8k8_tf32x3(t, ahi[mt][ks], alo[mt][ks], f.x, f.y, f.z, f.w);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mt][h][e] = __fadd_rn(acc[mt][h][e], t[e]);
            }
          }
        }
      }
    };
    // the running best of each row against pair jp's scores; row g + 8 r of
    // m-tile mt, code base + i: acc[mt][i >> 1][2 r + (i & 1)]
    auto pick = [&](int jp, const float (&acc)[MT][2][4]) {
      const int base = c0 + 16 * jp + 4 * tig;
      float s[MT][2][4], mx[MT][2];
      bool up = false;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int i = 0; i < 4; ++i) s[mt][r][i] = acc[mt][i >> 1][2 * r + (i & 1)];
          if constexpr (kStochastic) {
            const int row = row0 + 16 * (MT * warp + mt) + g + 8 * r;
            const uint4 bits =
                philox4x32_10(make_uint4((uint32_t)(base >> 2), (uint32_t)row, 0u, 0u), p.key0,
                              p.key1);
            const uint32_t b4[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
              s[mt][r][i] = __fadd_rn(__fmul_rn(s[mt][r][i], p.inv_temp), gumbel(b4[i]));
          }
          mx[mt][r] = fmaxf(fmaxf(s[mt][r][0], s[mt][r][1]), fmaxf(s[mt][r][2], s[mt][r][3]));
          up |= mx[mt][r] > best[mt][r];
        }
      }
      if (__any_sync(0xffffffffu, up)) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (mx[mt][r] > best[mt][r]) {
              const float m = mx[mt][r];
              best[mt][r] = m;
              best_idx[mt][r] = base + (s[mt][r][0] == m ? 0 : s[mt][r][1] == m ? 1
                                        : s[mt][r][2] == m ? 2 : 3);
            }
          }
        }
      }
    };
    // (issuing the next pair's products before a pair's pick, in a second set
    // of accumulators, took 0.062 ms against 0.043 on an H100: tools/tune_torch_kernels.py vq)
    float acc[MT][2][4];
#pragma unroll 2
    for (int jp = 0; jp < n16 / 16; ++jp) {
      products(jp, acc);
      pick(jp, acc);
    }
  }

  // ---- the four threads of a row (one tig each), then the cluster's splits
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = best[mt][r];
      int k = best_idx[mt][r];
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
        const int lr = 16 * (MT * warp + mt) + g + 8 * r;
        best_s[lr] = v;
        best_i[lr] = k;
      }
    }
  }
  cluster_sync();  // every split's rows are in its shared memory
  for (int lr = split + kCluster * threadIdx.x; lr < Geo::kRows; lr += kCluster * kThreads) {
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

template <int D, bool kStochastic>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using Geo = Geometry<D, kStochastic>;
  auto kernel = vq_tc_kernel<D, kStochastic>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Geo::kSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, (p.M + Geo::kRows - 1) / Geo::kRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Geo::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;  // the codebook's splits
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_mode(const Params& p, int stochastic, cudaStream_t stream) {
  return stochastic ? launch<D, true>(p, stream) : launch<D, false>(p, stream);
}

}  // namespace

// z [M, d], emb [K, d], bias [K] (or null) fp32 and contiguous, idx [M] int32;
// d in {4, 8, 16, 24, 32}, M >= 1, K >= 1; `seed` keys the noise of stochastic mode.
extern "C" int vtt_vq_argmax_sm90(const float* z, const float* emb, const float* bias, int* idx,
                                  int M, int K, int d, int stochastic, float inv_temp,
                                  long long seed, void* stream) {
  if (M < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.z = z; p.emb = emb; p.bias = bias; p.idx = idx; p.M = M; p.K = K;
  p.slice = ((K + kCluster - 1) / kCluster + 15) / 16 * 16;
  p.inv_temp = inv_temp;
  p.key0 = (uint32_t)((unsigned long long)seed & 0xFFFFFFFFull);
  p.key1 = (uint32_t)((unsigned long long)seed >> 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 4: err = dispatch_mode<4>(p, stochastic, s); break;
    case 8: err = dispatch_mode<8>(p, stochastic, s); break;
    case 16: err = dispatch_mode<16>(p, stochastic, s); break;
    case 24: err = dispatch_mode<24>(p, stochastic, s); break;
    case 32: err = dispatch_mode<32>(p, stochastic, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
