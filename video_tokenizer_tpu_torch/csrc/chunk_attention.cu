// G-token chunk attention over a KV cache with per-row positions, for Hopper
// (sm_90a): the verify forward of speculative decoding.
//
// Replaces the TPU kernel video_tokenizer_tpu/ops/decode_attention.py::
// _chunk_kernel: for cache row b, chunk token g and query head h, attention
// of that query over keys 0 .. pos[b] + g of a [B, S, Hkv*D] cache (heads
// fused in the last dim): the whole live prefix plus the chunk's own earlier
// tokens, whose K/V rows are already in the cache. `pos` is [B] int32, one
// per row, because rows accept different numbers of drafted tokens and so
// advance unevenly. GQA: query head h reads KV head h / (H / Hkv). Optional
// key-valid mask [B, S] (invalid keys score -0.7 * FLT_MAX, as
// DEFAULT_MASK_VALUE); optional int8 K/V with one fp32 scale per cache row
// ([B, S] each; the scale multiplies the score for K and the probability for
// V). Scores, softmax, probabilities and the accumulator are fp32 (P is not
// rounded to bf16 before P.V); the output has the query's dtype. Held
// against chunk_attention_reference in ops/decode_attention.py.
//
// What bounds it: the cache. At the 632M prior's verify shape (B = 16 rows
// of a CFG-doubled batch 8, G = 5, 20 heads of 64, pos = 1024) one layer's
// live K+V is 16 x 1029 x 1280 x 2 x 2 B = 84 MB against ~6.6 MFLOP per row:
// bandwidth-bound, ~25 us at 3.35 TB/s, the same bytes as a one-token step
// for five tokens' worth of work.
//
// Design: the TPU kernel feeds its matrix unit a block-diagonal [G*H, Hkv*D]
// query matrix (H times the algebraic work) and carries batch-in-lanes scale
// planes; neither is needed here. As in decode_attention.cu, S is split: one
// block per (128-key split, KV head, cache row) holds the G * rep query rows
// of its group in shared memory, so every K row is read from memory once,
// whatever G and rep are; each key's dot products with all the rows are
// taken from one 16-byte register load and summed by warp shuffles. Row
// (g, r) masks keys past pos[b] + g itself, which is the causal mask inside
// the chunk. For P.V the rows go in register tiles of kAcc / kVec rows, so
// that the verify chunk's five rows read V once. Each split writes an
// unnormalised partial (max m, sum l, acc[D]) per query row; a second small
// kernel merges the splits that are live for that row. `pos`, the mask and
// the scales are read from device memory by both kernels, and splits that
// start past pos[b] + G - 1 exit at once: no host scalar, no
// synchronisation, so an iteration can be captured in a CUDA graph. What it
// leaves on the table: no cp.async/TMA pipeline, no tensor cores (G * rep
// rows is far below an mma tile's 16 for MHA), and the partials make a round
// trip through memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 128;  // keys per split
constexpr int kAcc = 80;     // fp32 P.V accumulators per thread
constexpr float kMaskValue = -0.7f * FLT_MAX;

struct Params {
  const void* q;                // [B, G, H, D], strides (q_sb, q_sg, D, 1)
  const void* k;                // [B, S, Hkv * D], contiguous
  const void* v;                // [B, S, Hkv * D], contiguous
  const int* pos;               // [B] position of chunk token 0 of each row
  const uint8_t* key_valid;     // [B, S] or null
  const float* k_scale;         // [B, S] or null (int8 caches)
  const float* v_scale;         // [B, S] or null
  float* part_o;                // [B, G, H, n_splits, D]
  float* part_ml;               // [B, G, H, n_splits, 2]
  void* out;                    // [B, G, H, D], contiguous, q's dtype
  int B, G, H, Hkv, S, n_splits;
  long long q_sb, q_sg;
  int q_bf16;
  float sm_scale;
};

template <typename T>
struct Vec;  // one 16-byte load of a cache row, as floats
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void to_float(const uint4& raw, float* f) {
    const float* c = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = c[j];
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void to_float(const uint4& raw, float* f) {
    const __nv_bfloat16* c = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = __bfloat162float(c[j]);
  }
};
template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void to_float(const uint4& raw, float* f) {
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = static_cast<float>(c[j]);
  }
};

// Last key that chunk token g of row b may see, inclusive.
__device__ __forceinline__ int row_limit(const Params& p, int b, int g) {
  return max(min(p.pos[b] + g, p.S - 1), 0);
}

template <typename TC, int D>
struct Shape {
  static constexpr int kVec = Vec<TC>::N;
  static constexpr int kTPK = D / kVec;             // threads per key row
  static constexpr int kKPP = kThreads / kTPK;      // keys per pass
  static constexpr int kPasses = kChunk / kKPP;
  static constexpr int kUnroll = kPasses < 8 ? kPasses : 8;  // loads in flight
  static constexpr int kRowTile = kAcc / kVec;      // query rows per pass over V
};

template <typename TC, int D>
__global__ void __launch_bounds__(kThreads) chunk_split_kernel(const Params p) {
  using Sh = Shape<TC, D>;
  constexpr int kVec = Sh::kVec, kTPK = Sh::kTPK, kKPP = Sh::kKPP, kRowTile = Sh::kRowTile;
  extern __shared__ __align__(16) float smem[];
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = split * kChunk;
  const int last = row_limit(p, b, p.G - 1);  // the chunk's last token sees the most
  if (k0 > last) return;  // past every query's keys: the merge skips this split
  const int n_keys = min(kChunk, last + 1 - k0);
  const int rep = p.H / p.Hkv;
  const int R = p.G * rep;             // query rows of this block, row = g * rep + r
  float* sq = smem;                    // [R][D] queries, fp32
  float* ss = sq + R * D;              // [R][kChunk] scores, then weights
  float* sred = ss + R * kChunk;       // [kKPP][D] partial P.V sums
  int* slim = reinterpret_cast<int*>(sred + kKPP * D);  // [G] row limits

  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int row = i / D, d = i % D;
    const int g = row / rep, r = row % rep;
    const long long at = b * p.q_sb + g * p.q_sg + (long long)(hk * rep + r) * D + d;
    sq[i] = p.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[at])
                     : static_cast<const float*>(p.q)[at];
  }
  for (int g = threadIdx.x; g < p.G; g += kThreads) slim[g] = row_limit(p, b, g);
  __syncthreads();

  const int seg = threadIdx.x % kTPK;   // this thread's kVec-wide slice of D
  const int slot = threadIdx.x / kTPK;  // its key within a pass
  const long long row_elems = (long long)p.Hkv * D;
  const long long base = (long long)b * p.S * row_elems + (long long)hk * D + seg * kVec;
  const TC* kb = static_cast<const TC*>(p.k) + base;
  const TC* vb = static_cast<const TC*>(p.v) + base;
  const long long bs = (long long)b * p.S + k0;  // [B, S] planes at this split

  // ---- scores s[row][t] = (q_row . k_t) * sm_scale (* k_scale[t]), masked
  for (int p0 = 0; p0 < Sh::kPasses; p0 += Sh::kUnroll) {
    uint4 raw[Sh::kUnroll];
#pragma unroll
    for (int u = 0; u < Sh::kUnroll; ++u) {
      const int t = (p0 + u) * kKPP + slot;
      raw[u] = t < n_keys ? *reinterpret_cast<const uint4*>(kb + (k0 + t) * row_elems)
                          : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < Sh::kUnroll; ++u) {
      const int t = (p0 + u) * kKPP + slot;
      float kf[kVec];
      Vec<TC>::to_float(raw[u], kf);
      float ksc = 1.f;
      bool valid = true;
      if (seg == 0 && t < n_keys) {
        if (p.k_scale != nullptr) ksc = p.k_scale[bs + t];
        if (p.key_valid != nullptr) valid = p.key_valid[bs + t] != 0;
      }
      for (int row = 0; row < R; ++row) {
        const float* qr = sq + row * D + seg * kVec;
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc = fmaf(kf[j], qr[j], acc);
#pragma unroll
        for (int off = kTPK / 2; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (seg == 0) {
          float x = -INFINITY;  // past this query's limit: not a key at all
          if (k0 + t <= slim[row / rep]) x = valid ? acc * p.sm_scale * ksc : kMaskValue;
          ss[row * kChunk + t] = x;
        }
      }
    }
  }
  __syncthreads();

  // ---- split-local softmax: one warp per query row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row = warp; row < R; row += kThreads / 32) {
    float* sr = ss + row * kChunk;
    float m = -INFINITY;
    for (int t = lane; t < kChunk; t += 32) m = fmaxf(m, sr[t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    // an early chunk token may have no key in this split (k0 > its limit):
    // its partial is all zero and the merge does not read it
    const float base_m = m == -INFINITY ? 0.f : m;
    float l = 0.f;
    for (int t = lane; t < kChunk; t += 32) {
      const float e = expf(sr[t] - base_m);  // 0 past the limit
      l += e;
      sr[t] = (p.v_scale != nullptr && t < n_keys) ? e * p.v_scale[bs + t] : e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      const int g = row / rep, r = row % rep;
      float* ml = p.part_ml +
          ((((long long)b * p.G + g) * p.H + hk * rep + r) * p.n_splits + split) * 2;
      ml[0] = m;
      ml[1] = l;
    }
  }
  __syncthreads();

  // ---- acc[row][d] = sum_t w[row][t] * v[t][d], kRowTile rows per pass over V
  for (int r0 = 0; r0 < R; r0 += kRowTile) {
    float acc[kRowTile][kVec];
#pragma unroll
    for (int i = 0; i < kRowTile; ++i)
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[i][j] = 0.f;
    for (int p0 = 0; p0 < Sh::kPasses; p0 += Sh::kUnroll) {
      uint4 raw[Sh::kUnroll];
#pragma unroll
      for (int u = 0; u < Sh::kUnroll; ++u) {
        const int t = (p0 + u) * kKPP + slot;
        raw[u] = t < n_keys ? *reinterpret_cast<const uint4*>(vb + (k0 + t) * row_elems)
                            : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < Sh::kUnroll; ++u) {
        const int t = (p0 + u) * kKPP + slot;
        float vf[kVec];
        Vec<TC>::to_float(raw[u], vf);
#pragma unroll
        for (int i = 0; i < kRowTile; ++i) {
          if (r0 + i < R) {
            const float w = ss[(r0 + i) * kChunk + t];  // 0 past the limit; raw is 0 there
#pragma unroll
            for (int j = 0; j < kVec; ++j) acc[i][j] = fmaf(w, vf[j], acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowTile; ++i) {
      if (r0 + i < R) {  // uniform over the block
#pragma unroll
        for (int j = 0; j < kVec; ++j) sred[slot * D + seg * kVec + j] = acc[i][j];
        __syncthreads();
        const int g = (r0 + i) / rep, r = (r0 + i) % rep;
        float* po = p.part_o +
            ((((long long)b * p.G + g) * p.H + hk * rep + r) * p.n_splits + split) * D;
        for (int d = threadIdx.x; d < D; d += kThreads) {
          float o = 0.f;
          for (int s = 0; s < kKPP; ++s) o += sred[s * D + d];
          po[d] = o;
        }
        __syncthreads();  // sred is rewritten for the next row
      }
    }
  }
}

// Merges the splits that are live for one (row, chunk token, head): out =
// sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M). One thread per element.
template <typename TO, int D>
__global__ void __launch_bounds__(D) chunk_merge_kernel(const Params p) {
  const int h = blockIdx.x, g = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  // key 0 of each of these splits is within this query's limit, so every m
  // read here is finite
  const int n_live = row_limit(p, b, g) / kChunk + 1;
  const long long bgh = ((long long)b * p.G + g) * p.H + h;
  const float* ml = p.part_ml + bgh * p.n_splits * 2;
  float m = -INFINITY;
  for (int s = 0; s < n_live; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const float w = expf(ml[2 * s] - m);
    l += ml[2 * s + 1] * w;
    o += p.part_o[(bgh * p.n_splits + s) * D + d] * w;
  }
  const float y = o / l;
  TO* out = static_cast<TO*>(p.out) + bgh * D + d;
  if constexpr (sizeof(TO) == 2) {
    *out = __float2bfloat16(y);
  } else {
    *out = y;
  }
}

template <typename TC, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int R = p.G * (p.H / p.Hkv);
  const int bytes = (R * D + R * kChunk + Shape<TC, D>::kKPP * D) * (int)sizeof(float) +
                    p.G * (int)sizeof(int);
  if (bytes > 48 * 1024) return cudaErrorInvalidValue;
  chunk_split_kernel<TC, D>
      <<<dim3(p.n_splits, p.Hkv, p.B), kThreads, bytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.q_bf16) {
    chunk_merge_kernel<__nv_bfloat16, D><<<dim3(p.H, p.G, p.B), D, 0, stream>>>(p);
  } else {
    chunk_merge_kernel<float, D><<<dim3(p.H, p.G, p.B), D, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_cache(const Params& p, int cache_dtype, cudaStream_t stream) {
  switch (cache_dtype) {
    case 0: return launch<float, D>(p, stream);
    case 1: return launch<__nv_bfloat16, D>(p, stream);
    case 2: return launch<int8_t, D>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// cache_dtype: 0 fp32, 1 bf16, 2 int8 (then k_scale and v_scale are given).
extern "C" int vtt_chunk_attention(
    const void* q, const void* k, const void* v, const int* pos, const uint8_t* key_valid,
    const float* k_scale, const float* v_scale, float* part_o, float* part_ml, void* out,
    int cache_dtype, int q_bf16, int B, int G, int H, int Hkv, int S, int D, int n_splits,
    long long q_sb, long long q_sg, float sm_scale, void* stream) {
  if (G < 1 || H % Hkv != 0 || n_splits != (S + kChunk - 1) / kChunk ||
      (cache_dtype == 2) != (k_scale != nullptr && v_scale != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q; p.k = k; p.v = v; p.pos = pos; p.key_valid = key_valid;
  p.k_scale = k_scale; p.v_scale = v_scale; p.part_o = part_o; p.part_ml = part_ml;
  p.out = out; p.B = B; p.G = G; p.H = H; p.Hkv = Hkv; p.S = S; p.n_splits = n_splits;
  p.q_sb = q_sb; p.q_sg = q_sg; p.q_bf16 = q_bf16; p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 64: err = dispatch_cache<64>(p, cache_dtype, s); break;
    case 128: err = dispatch_cache<128>(p, cache_dtype, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
