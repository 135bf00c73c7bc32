// One-token decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel video_tokenizer_tpu/ops/decode_attention.py::
// _decode_kernel: for each cache row b and query head h, attention of the
// current token's query over the live prefix [0, pos] of a [B, S, Hkv*D]
// cache (heads fused in the last dim). GQA: query head h reads KV head
// h / (H / Hkv). Optional key-valid mask [B, S] (invalid keys score
// -0.7 * FLT_MAX, as DEFAULT_MASK_VALUE); optional int8 K/V with one fp32
// scale per cache row ([B, S] each; the scale multiplies the score for K and
// the probability for V). Scores, softmax and the accumulator are fp32; the
// output has the query's dtype. Held against decode_attention_reference in
// ops/decode_attention.py.
//
// What bounds it: the cache. At the 632M prior's sampling shape (B = 16 rows
// of a CFG-doubled batch 8, 20 heads of 64, pos = 1024) one layer's live K+V
// is 16 x 1025 x 1280 x 2 x 2 B = 84 MB against ~1.3 MFLOP per row: purely
// bandwidth-bound, ~25 us at 3.35 TB/s.
//
// Design (flash-decoding): the TPU kernel walks S in order inside one program
// per batch chunk, which on this card would leave most of the 132 SMs idle.
// Here S is split: one block per (128-key split, KV head, cache row) holds the
// rep query heads of its group, so every K/V row is read from memory once,
// whatever rep is. Each thread reads its keys in 16-byte vectors (8 bf16, 4
// fp32 or 16 int8 elements), int8 rows are dequantised by their row scale in
// registers, and a key's partial dot products are summed by warp shuffles.
// Each split writes an unnormalised partial (max m, sum l, acc[D]); a second
// small kernel merges the live splits. `pos` is read from device memory by
// both kernels, and splits past the live prefix exit at once: there is no
// host scalar and no synchronisation, so a decode step can be captured in a
// CUDA graph. What it leaves on the table: loads are issued in groups of 8
// per thread (no cp.async/TMA pipeline), and the partials make a round trip
// through memory (~0.7 MB at the shape above) instead of a last-block merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 128;  // keys per split
constexpr float kMaskValue = -0.7f * FLT_MAX;

struct Params {
  const void* q;                // [B, H, D], batch stride q_sb, head stride D
  const void* k;                // [B, S, Hkv * D], contiguous
  const void* v;                // [B, S, Hkv * D], contiguous
  const int* pos;               // [1] last live key, inclusive
  const uint8_t* key_valid;     // [B, S] or null
  const float* k_scale;         // [B, S] or null (int8 caches)
  const float* v_scale;         // [B, S] or null
  float* part_o;                // [B, H, n_splits, D]
  float* part_ml;               // [B, H, n_splits, 2]
  void* out;                    // [B, H, D], contiguous, q's dtype
  int B, H, Hkv, S, n_splits;
  long long q_sb;
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

__device__ __forceinline__ int live_pos(const Params& p) {
  return max(min(*p.pos, p.S - 1), 0);
}

template <typename TC, int D>
struct Shape {
  static constexpr int kVec = Vec<TC>::N;
  static constexpr int kTPK = D / kVec;             // threads per key row
  static constexpr int kKPP = kThreads / kTPK;      // keys per pass
  static constexpr int kPasses = kChunk / kKPP;
  static constexpr int kUnroll = kPasses < 8 ? kPasses : 8;  // loads in flight
};

template <typename TC, int D>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(const Params p) {
  using Sh = Shape<TC, D>;
  constexpr int kVec = Sh::kVec, kTPK = Sh::kTPK, kKPP = Sh::kKPP;
  extern __shared__ __align__(16) float smem[];
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int pos = live_pos(p);
  const int k0 = split * kChunk;
  if (k0 > pos) return;  // past the live prefix
  const int n_keys = min(kChunk, pos + 1 - k0);
  const int rep = p.H / p.Hkv;
  float* sq = smem;                  // [rep][D] queries of the group, fp32
  float* ss = sq + rep * D;          // [rep][kChunk] scores, then weights
  float* sred = ss + rep * kChunk;   // [kKPP][D] partial P.V sums

  for (int i = threadIdx.x; i < rep * D; i += kThreads) {
    const long long at = b * p.q_sb + (long long)(hk * rep) * D + i;
    sq[i] = p.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[at])
                     : static_cast<const float*>(p.q)[at];
  }
  __syncthreads();

  const int seg = threadIdx.x % kTPK;   // this thread's kVec-wide slice of D
  const int slot = threadIdx.x / kTPK;  // its key within a pass
  const long long row = (long long)p.Hkv * D;
  const long long base = (long long)b * p.S * row + (long long)hk * D + seg * kVec;
  const TC* kb = static_cast<const TC*>(p.k) + base;
  const TC* vb = static_cast<const TC*>(p.v) + base;
  const long long bs = (long long)b * p.S + k0;  // [B, S] planes at this split

  // ---- scores s[r][t] = (q_r . k_t) * sm_scale (* k_scale[t]), masked
  for (int p0 = 0; p0 < Sh::kPasses; p0 += Sh::kUnroll) {
    uint4 raw[Sh::kUnroll];
#pragma unroll
    for (int u = 0; u < Sh::kUnroll; ++u) {
      const int t = (p0 + u) * kKPP + slot;
      raw[u] = t < n_keys ? *reinterpret_cast<const uint4*>(kb + (k0 + t) * row)
                          : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < Sh::kUnroll; ++u) {
      const int t = (p0 + u) * kKPP + slot;
      float kf[kVec];
      Vec<TC>::to_float(raw[u], kf);
      for (int r = 0; r < rep; ++r) {
        const float* qr = sq + r * D + seg * kVec;
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc = fmaf(kf[j], qr[j], acc);
#pragma unroll
        for (int off = kTPK / 2; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (seg == 0) {
          float x = -INFINITY;  // past pos: not a key at all
          if (t < n_keys) {
            x = acc * p.sm_scale;
            if (p.k_scale != nullptr) x *= p.k_scale[bs + t];
            if (p.key_valid != nullptr && !p.key_valid[bs + t]) x = kMaskValue;
          }
          ss[r * kChunk + t] = x;
        }
      }
    }
  }
  __syncthreads();

  // ---- split-local softmax: one warp per query head of the group
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rep; r += kThreads / 32) {
    float* sr = ss + r * kChunk;
    float m = -INFINITY;
    for (int t = lane; t < kChunk; t += 32) m = fmaxf(m, sr[t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    // m is finite: key k0 <= pos is live in every split that runs
    float l = 0.f;
    for (int t = lane; t < kChunk; t += 32) {
      const float e = expf(sr[t] - m);  // 0 past pos
      l += e;
      sr[t] = (p.v_scale != nullptr && t < n_keys) ? e * p.v_scale[bs + t] : e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      float* ml = p.part_ml + (((long long)b * p.H + hk * rep + r) * p.n_splits + split) * 2;
      ml[0] = m;
      ml[1] = l;
    }
  }
  __syncthreads();

  // ---- acc[r][d] = sum_t w[r][t] * v[t][d]
  for (int r = 0; r < rep; ++r) {
    const float* wr = ss + r * kChunk;
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
    for (int p0 = 0; p0 < Sh::kPasses; p0 += Sh::kUnroll) {
      uint4 raw[Sh::kUnroll];
#pragma unroll
      for (int u = 0; u < Sh::kUnroll; ++u) {
        const int t = (p0 + u) * kKPP + slot;
        raw[u] = t < n_keys ? *reinterpret_cast<const uint4*>(vb + (k0 + t) * row)
                            : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < Sh::kUnroll; ++u) {
        const int t = (p0 + u) * kKPP + slot;
        float vf[kVec];
        Vec<TC>::to_float(raw[u], vf);
        const float w = wr[t];  // 0 past pos, and raw is zero there
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] = fmaf(w, vf[j], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) sred[slot * D + seg * kVec + j] = acc[j];
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float o = 0.f;
      for (int s = 0; s < kKPP; ++s) o += sred[s * D + d];
      p.part_o[(((long long)b * p.H + hk * rep + r) * p.n_splits + split) * D + d] = o;
    }
    __syncthreads();  // sred is rewritten for the next head
  }
}

// Merges the live splits of one (row, head): out = sum_s acc_s e^(m_s - M) /
// sum_s l_s e^(m_s - M). One thread per output element.
template <typename TO, int D>
__global__ void __launch_bounds__(D) decode_merge_kernel(const Params p) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int n_live = live_pos(p) / kChunk + 1;
  const long long bh = (long long)b * p.H + h;
  const float* ml = p.part_ml + bh * p.n_splits * 2;
  float m = -INFINITY;
  for (int s = 0; s < n_live; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const float w = expf(ml[2 * s] - m);
    l += ml[2 * s + 1] * w;
    o += p.part_o[(bh * p.n_splits + s) * D + d] * w;
  }
  const float y = o / l;
  TO* out = static_cast<TO*>(p.out) + bh * D + d;
  if constexpr (sizeof(TO) == 2) {
    *out = __float2bfloat16(y);
  } else {
    *out = y;
  }
}

template <typename TC, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int rep = p.H / p.Hkv;
  const int bytes = (rep * D + rep * kChunk + Shape<TC, D>::kKPP * D) * (int)sizeof(float);
  if (bytes > 48 * 1024) return cudaErrorInvalidValue;
  decode_split_kernel<TC, D>
      <<<dim3(p.n_splits, p.Hkv, p.B), kThreads, bytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.q_bf16) {
    decode_merge_kernel<__nv_bfloat16, D><<<dim3(p.H, p.B), D, 0, stream>>>(p);
  } else {
    decode_merge_kernel<float, D><<<dim3(p.H, p.B), D, 0, stream>>>(p);
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
extern "C" int vtt_decode_attention(
    const void* q, const void* k, const void* v, const int* pos, const uint8_t* key_valid,
    const float* k_scale, const float* v_scale, float* part_o, float* part_ml, void* out,
    int cache_dtype, int q_bf16, int B, int H, int Hkv, int S, int D, int n_splits,
    long long q_sb, float sm_scale, void* stream) {
  if (H % Hkv != 0 || n_splits != (S + kChunk - 1) / kChunk ||
      (cache_dtype == 2) != (k_scale != nullptr && v_scale != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q; p.k = k; p.v = v; p.pos = pos; p.key_valid = key_valid;
  p.k_scale = k_scale; p.v_scale = v_scale; p.part_o = part_o; p.part_ml = part_ml;
  p.out = out; p.B = B; p.H = H; p.Hkv = Hkv; p.S = S; p.n_splits = n_splits;
  p.q_sb = q_sb; p.q_bf16 = q_bf16; p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 64: err = dispatch_cache<64>(p, cache_dtype, s); break;
    case 128: err = dispatch_cache<128>(p, cache_dtype, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
