// One-token decode attention over a bf16 or int8 KV cache, head dim 64, for
// Hopper (sm_90a): one block per (cache row, KV head), tensor-core products,
// an asynchronous ring of K/V tiles per warp, and no second launch.
//
// Replaces, for a bf16 query over bf16 and int8 caches at D = 64, the same TPU
// kernel as csrc/decode_attention.cu (which keeps fp32 queries, fp32 caches
// and D = 128):
//   * video_tokenizer_tpu/ops/decode_attention.py::_decode_kernel.
// What it computes is stated at the head of csrc/decode_attention.cu and held
// against decode_attention_reference in ops/decode_attention.py: for cache row
// b and query head h, attention over keys 0 .. pos of a [B, S, Hkv * 64] cache,
// `pos` read on the device, GQA, an optional key-valid mask, int8 K/V with one
// fp32 scale per cache row folded into the score (K) and the probability (V),
// output in bf16. The TPU kernel keeps q, K, V and P in fp32. Here q (bf16) and
// the cache values (bf16, or int8 made bf16 exactly) are exact bf16 operands,
// so the scores are fp32 sums of exact products; P is NOT rounded to bf16 once
// (as the chunk kernel rounds it): P times the V scale is split into two bf16
// parts, hi = bf16(p) and lo = bf16(p - hi), and P.V is hi.V + lo.V with fp32
// sums, which keeps 16 of P's 24 significant bits.
//
// What bounds it: the cache's bytes. At the 632M prior's sampling shape (B =
// 16, H = Hkv = 20, D = 64, pos 1024) one layer's live K + V is 84 MB in bf16
// (25 us at 3.35 TB/s) and 42 MB + scales in int8 (12.6 us), against ~1.3
// MFLOP per cache row. The earlier kernel (csrc/decode_attention.cu) spends
// two launches per call (a split kernel and a merge through memory), blocks of
// 128 keys that read K in one burst, meet a block barrier, run the softmax in
// shared memory and only then load V, and converts every int8 value to fp32.
// What the design does about it:
//   * one block of 4 warps per (cache row, KV head): 320 blocks at the shape
//     above, so one launch and no partials. Each warp owns 16-key tiles dealt
//     round-robin over the warps (of n_splits blocks where B * Hkv < 132),
//     keeps its own online softmax in registers
//     (no block barrier in the loop), and fills its own ring of kStages tiles
//     by 16-byte cp.async copies, K and V of a tile together, so V is in
//     flight under the scores and later tiles under the current one (the
//     tile layouts and swizzles of csrc/chunk_attention_sm90.cu, sm90.cuh);
//   * the rep query heads of a KV head are the M rows of mma.sync m16n8k16,
//     padded to 16; int8 bytes become bf16 exactly in registers (the byte in
//     the mantissa of 2^23), with the head dim permuted so that a thread
//     converts what one 16- or 8-byte shared load gave it;
//   * a split cache is merged inside the kernel: every block of a (row, head)
//     writes its partial, and the last one to arrive (an atomic count that it
//     resets) merges the partials of the blocks that ran in split order, so
//     the result does not depend on which block came last.
// Blocks whose first key lies past pos exit at once; `pos`, the mask and the
// scales are read on the device: no host scalar, no synchronisation, one
// launch, so a decode step can be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kD = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileKeys = kKvTileKeys;  // keys of one warp step: one k-step of P.V
constexpr int kStages = 4;              // tiles in a warp's ring
constexpr int kBlockKeys = kWarps * kTileKeys;
constexpr int kMaxRows = 16;            // query heads per KV head
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;       // [B, H, 64], strides (q_sb, 64, 1)
  const void* k;                // [B, S, Hkv * 64], contiguous
  const void* v;                // [B, S, Hkv * 64], contiguous
  const int* pos;               // [1] last live key, inclusive
  const uint8_t* key_valid;     // [B, S] or null
  const float* k_scale;         // [B, S] or null (int8 caches)
  const float* v_scale;         // [B, S] or null
  float* part_o;                // [B, H, n_splits, 64] (n_splits > 1)
  float* part_ml;               // [B, H, n_splits, 2]: max (log2 domain), sum
  int* arrived;                 // [B * Hkv / HP] zeros, left at zero (n_splits > 1)
  __nv_bfloat16* out;           // [B, H, 64], contiguous
  int B, H, Hkv, S, n_splits;
  long long q_sb;
  float sm_scale;
};

__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));  // the differences are exact
}

// A warp's stage: the K tiles of its HP heads, their V tiles, then (int8) the
// tile's K and V row scales, which the heads of a cache row share.
template <typename TC, int HP>
struct Stage {
  using T = KvTile<TC>;
  static constexpr int kK = 0, kV = HP * T::kBytes;
  static constexpr int kScales = 2 * HP * T::kBytes;
  static constexpr int kBytes = kScales + (T::kInt8 ? 2 * kTileKeys * (int)sizeof(float) : 0);
};

// HP = 1: one KV head per block, its rep <= 16 query heads on rows 0 .. rep - 1.
// HP = 2: two adjacent KV heads per block (rep <= 8), the first's query heads on
// rows 0 .. rep - 1 and the second's on rows 8 .. 8 + rep - 1, so that a tile
// copies 2 x 64 contiguous values of each key (128 bytes of an int8 cache, in
// one run of 16-byte copies, where one head is 64 bytes).
template <typename TC, int HP>
__global__ void __launch_bounds__(kThreads) decode_attn_sm90_kernel(const Params p) {
  using T = KvTile<TC>;
  using St = Stage<TC, HP>;
  constexpr int kRingBytes = kStages * St::kBytes;  // per warp
  static_assert(kRingBytes >= kMaxRows * (kD + 2) * (int)sizeof(float),
                "a warp's partial result is staged in its own ring");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int is_last;

  const int split = blockIdx.x, hk0 = blockIdx.y * HP, b = blockIdx.z;
  const int last = max(min(*p.pos, p.S - 1), 0);
  if (split * kBlockKeys > last) return;  // past the live prefix: not counted as arrived
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int rep = p.H / p.Hkv;

  // query head of row `row`, or -1 for a padding row (it sees no key and its
  // results are never written)
  auto head_of = [&](int row) -> int {
    if (HP == 1) return row < rep ? hk0 * rep + row : -1;
    return row % 8 < rep ? (hk0 + row / 8) * rep + row % 8 : -1;
  };

  // ---- this thread's rows g and g + 8: Q fragments
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int head = head_of(g + 8 * i);
    const bool in = head >= 0;
    const long long at = b * p.q_sb + (long long)(in ? head : 0) * kD;
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        qa[ks][i + 2 * half] =
            in ? *reinterpret_cast<const uint32_t*>(p.q + at + T::q_col(ks, tig, half)) : 0u;
  }

  // ---- this warp's tiles: t0, t0 + step, ... while their first key is <= last
  const int step = kWarps * p.n_splits;
  const int t0 = split * kWarps + warp;
  const int last_tile = last / kTileKeys;
  const int count = t0 > last_tile ? 0 : (last_tile - t0) / step + 1;

  const uint32_t ring = smem_addr(smem_raw) + warp * kRingBytes;
  const long long row_bytes = (long long)p.Hkv * kD * sizeof(TC);
  const long long head_at = (long long)b * p.S * row_bytes + (long long)hk0 * kD * sizeof(TC);
  const unsigned char* kb = static_cast<const unsigned char*>(p.k) + head_at;
  const unsigned char* vb = static_cast<const unsigned char*>(p.v) + head_at;
  const long long bs = (long long)b * p.S;  // this cache row in the [B, S] planes
  // a lane copies 16-byte chunk lc of head lh's values of keys lr, lr + kRowStep, ...:
  // the HP heads' chunks of a key are contiguous in memory and in the lanes
  const int lc = lane % T::kChunks, lh = (lane / T::kChunks) % HP, lr = lane / (HP * T::kChunks);
  constexpr int kRowStep = 32 / (HP * T::kChunks);
  const uint32_t sub = lh * T::kBytes;  // this lane's head's tile within K (and V)

  auto load_tile = [&](int it) {
    const int key0 = (t0 + it * step) * kTileKeys;
    const uint32_t stage = ring + (it % kStages) * St::kBytes;
#pragma unroll
    for (int i = 0; i < kTileKeys / kRowStep; ++i) {
      const int r = lr + i * kRowStep;
      const bool in = key0 + r <= last;  // later rows are zero-filled, never read from memory
      const long long src = in ? (key0 + r) * row_bytes + (lh * T::kChunks + lc) * 16 : 0;
      cp_async16(stage + St::kK + sub + T::at(r, lc), kb + src, in ? 16 : 0);
      cp_async16(stage + St::kV + sub + T::at(r, lc), vb + src, in ? 16 : 0);
    }
    if constexpr (T::kInt8) {
      // lanes 0..15: the K scales of the tile's keys, lanes 16..31: the V scales
      const int key = key0 + (lane & 15);
      const bool in = key <= last;
      const float* src = (lane < 16 ? p.k_scale : p.v_scale) + (in ? bs + key : 0);
      cp_async4(stage + St::kScales + lane * 4, src, in ? 4 : 0);
    }
  };
  // validity of this thread's four keys of a tile (bit 2 j + e: key 8 j + 2 tig + e)
  auto load_valid = [&](int it) -> uint32_t {
    if (p.key_valid == nullptr || it >= count) return 0xFu;
    const int key0 = (t0 + it * step) * kTileKeys;
    uint32_t bits = 0u;
#pragma unroll
    for (int je = 0; je < 4; ++je) {
      const int key = key0 + 8 * (je >> 1) + 2 * tig + (je & 1);
      if (key > last || p.key_valid[bs + key] != 0) bits |= 1u << je;
    }
    return bits;
  };

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < count) load_tile(it);
    cp_async_commit();
  }
  uint32_t valid_next = load_valid(0);

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const float scale_log2 = p.sm_scale * kLog2e;
  const int lim[2] = {head_of(g) >= 0 ? last : -1, head_of(g + 8) >= 0 ? last : -1};

  for (int it = 0; it < count; ++it) {
    cp_async_wait<kStages - 2>();
    __syncwarp();
    if (it + kStages - 1 < count) load_tile(it + kStages - 1);
    cp_async_commit();
    const uint32_t valid = valid_next;
    valid_next = load_valid(it + 1);

    const int key0 = (t0 + it * step) * kTileKeys;
    const int stage_off = warp * kRingBytes + (it % kStages) * St::kBytes;
    const uint32_t sK = smem_addr(smem_raw) + stage_off + St::kK;
    const uint32_t sV = smem_addr(smem_raw) + stage_off + St::kV;

    // ---- S[16 rows x 16 keys] = Q K^T; s[j][e]: row g + 8 (e / 2), key 8 j + 2 tig + e % 2.
    // With two heads each row keeps the product with its own head's K tile.
    float s[2][4];
#pragma unroll
    for (int h = 0; h < HP; ++h) {
      float sh[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sh[j][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (T::kInt8) {
          const unsigned char* tile = smem_raw + stage_off + St::kK + h * T::kBytes;
          const uint4 w = *reinterpret_cast<const uint4*>(tile + T::at(8 * j + g, tig));
          const uint32_t words[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                                     w.w ^ 0x80808080u};
#pragma unroll
          for (int ks = 0; ks < kD / 16; ++ks) {
            const uint32_t b0 = int8_pair_to_bf16(words[ks], 0, words[ks], 1);
            const uint32_t b1 = int8_pair_to_bf16(words[ks], 2, words[ks], 3);
            mma_m16n8k16(sh[j], qa[ks], b0, b1);
          }
        } else {
#pragma unroll
          for (int q2 = 0; q2 < kD / 32; ++q2) {
            uint32_t kf[4];
            ldmatrix_x4(kf, sK + h * T::kBytes + T::at(8 * j + (lane & 7), 4 * q2 + (lane >> 3)));
            mma_m16n8k16(sh[j], qa[2 * q2], kf[0], kf[1]);
            mma_m16n8k16(sh[j], qa[2 * q2 + 1], kf[2], kf[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (HP == 1 || (e >> 1) == h) s[j][e] = sh[j][e];
    }

    // ---- scale, mask, online softmax; P (times the V scale) as two bf16 parts
    float c[2][2], vs[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        c[j][e] = scale_log2;
        vs[j][e] = 1.f;
        if constexpr (T::kInt8) {
          const float* sc = reinterpret_cast<const float*>(smem_raw + stage_off + St::kScales);
          c[j][e] *= sc[8 * j + 2 * tig + e];
          vs[j][e] = sc[kTileKeys + 8 * j + 2 * tig + e];
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * j + 2 * tig + (e & 1);
        float y = s[j][e] * c[j][e & 1];
        if (key > lim[e >> 1] || !((valid >> (2 * j + (e & 1))) & 1u)) y = kMaskValue;
        s[j][e] = y;
        mx[e >> 1] = fmaxf(mx[e >> 1], y);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);  // finite: at least the mask value
      alpha[i] = exp2_approx(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2_approx(s[j][e] - m_run[e >> 1]);
        sum[e >> 1] += pe;
        s[j][e] = pe * vs[j][e & 1];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + sum[i];
    uint32_t pa_hi[4], pa_lo[4];
    split_bf16(s[0][0], s[0][1], pa_hi[0], pa_lo[0]);
    split_bf16(s[0][2], s[0][3], pa_hi[1], pa_lo[1]);
    split_bf16(s[1][0], s[1][1], pa_hi[2], pa_lo[2]);
    split_bf16(s[1][2], s[1][3], pa_hi[3], pa_lo[3]);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // ---- O[16 rows x 64] += P_hi V + P_lo V; with two heads, each head's V
    // tile with P's rows of that head alone (the other rows' fragments zero)
#pragma unroll
    for (int h = 0; h < HP; ++h) {
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const bool mine = HP == 1 || (f & 1) == h;  // fragments 0, 2: row g; 1, 3: row g + 8
      ph[f] = mine ? pa_hi[f] : 0u;
      pl[f] = mine ? pa_lo[f] : 0u;
    }
    if constexpr (T::kInt8) {
      const unsigned char* tile = smem_raw + stage_off + St::kV + h * T::kBytes;
      uint2 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 2 * tig + (i & 1) + 8 * (i >> 1);
        w[i] = *reinterpret_cast<const uint2*>(tile + T::at(r, g >> 1) + (g & 1) * 8);
        w[i].x ^= 0x80808080u;
        w[i].y ^= 0x80808080u;
      }
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const int byte = n & 3;
        const uint32_t b0 = n < 4 ? int8_pair_to_bf16(w[0].x, byte, w[1].x, byte)
                                  : int8_pair_to_bf16(w[0].y, byte, w[1].y, byte);
        const uint32_t b1 = n < 4 ? int8_pair_to_bf16(w[2].x, byte, w[3].x, byte)
                                  : int8_pair_to_bf16(w[2].y, byte, w[3].y, byte);
        mma_m16n8k16(o[n], ph, b0, b1);
        mma_m16n8k16(o[n], pl, b0, b1);
      }
    } else {
#pragma unroll
      for (int n2 = 0; n2 < kD / 16; ++n2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sV + h * T::kBytes +
                                  T::at((lane & 7) + 8 * ((lane >> 3) & 1), 2 * n2 + (lane >> 4)));
        mma_m16n8k16(o[2 * n2], ph, vf[0], vf[1]);
        mma_m16n8k16(o[2 * n2], pl, vf[0], vf[1]);
        mma_m16n8k16(o[2 * n2 + 1], ph, vf[2], vf[3]);
        mma_m16n8k16(o[2 * n2 + 1], pl, vf[2], vf[3]);
      }
    }
    }
  }
  cp_async_wait<0>();
  __syncwarp();  // every lane has read the last tile: the ring becomes the staging area

  // ---- this warp's partial result into its ring: O [16][64], then max, sum
  float* stage_o = reinterpret_cast<float*>(smem_raw + warp * kRingBytes);
  float* stage_ml = stage_o + kMaxRows * kD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = g + 8 * i;
    if (tig == 0) {
      stage_ml[2 * row] = m_run[i];
      stage_ml[2 * row + 1] = l;
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) stage_o[row * kD + T::o_col(n, 2 * tig + e)] = o[n][2 * i + e];
  }
  __syncthreads();

  // ---- merge the block's warps (one without tiles has max -inf, sum 0); the
  // block's query rows are r = 0 .. HP rep - 1, on staged row (r / rep) 8 + r % rep
  // for two heads
  auto staged_row = [&](int r) { return HP == 1 ? r : (r / rep) * 8 + r % rep; };
  for (int idx = threadIdx.x; idx < HP * rep * kD; idx += kThreads) {
    const int row = staged_row(idx / kD), d = idx % kD;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* ml = reinterpret_cast<const float*>(smem_raw + w * kRingBytes) + kMaxRows * kD;
      m = fmaxf(m, ml[2 * row]);
    }
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* wo = reinterpret_cast<const float*>(smem_raw + w * kRingBytes);
      const float* ml = wo + kMaxRows * kD;
      const float wgt = exp2_approx(ml[2 * row] - m);
      l += ml[2 * row + 1] * wgt;
      acc += wo[row * kD + d] * wgt;
    }
    const long long bh = (long long)b * p.H + head_of(row);
    if (p.n_splits == 1) {
      p.out[bh * kD + d] = __float2bfloat16(acc / l);
    } else {
      p.part_o[(bh * p.n_splits + split) * kD + d] = acc;
      if (d == 0) {
        p.part_ml[(bh * p.n_splits + split) * 2] = m;
        p.part_ml[(bh * p.n_splits + split) * 2 + 1] = l;
      }
    }
  }
  if (p.n_splits == 1) return;

  // ---- a split cache: the last block of this (row, KV head) to arrive merges
  // the partials of the n_live blocks that ran, in split order
  const int n_live = min(p.n_splits, last / kBlockKeys + 1);
  __threadfence();  // this block's partials are visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) {
    int* counter = p.arrived + ((long long)b * p.Hkv + hk0) / HP;
    is_last = atomicAdd(counter, 1) == n_live - 1;
    if (is_last) *counter = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < HP * rep * kD; idx += kThreads) {
    const int row = staged_row(idx / kD), d = idx % kD;
    const long long bh = (long long)b * p.H + head_of(row);
    const float* ml = p.part_ml + bh * p.n_splits * 2;
    const float* po = p.part_o + bh * p.n_splits * kD + d;
    float m = -INFINITY;
    for (int s2 = 0; s2 < n_live; ++s2) m = fmaxf(m, __ldcg(ml + 2 * s2));
    float l = 0.f, acc = 0.f;
    for (int s2 = 0; s2 < n_live; ++s2) {
      const float wgt = exp2_approx(__ldcg(ml + 2 * s2) - m);
      l += __ldcg(ml + 2 * s2 + 1) * wgt;
      acc += __ldcg(po + s2 * kD) * wgt;
    }
    p.out[bh * kD + d] = __float2bfloat16(acc / l);
  }
}

template <typename TC, int HP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = decode_attn_sm90_kernel<TC, HP>;
  constexpr int kSmemBytes = kWarps * kStages * Stage<TC, HP>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.n_splits, p.Hkv / HP, p.B), kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename TC>
cudaError_t dispatch_heads(const Params& p, int heads_per_block, cudaStream_t stream) {
  if (heads_per_block == 1) return launch<TC, 1>(p, stream);
  if (heads_per_block == 2 && p.Hkv % 2 == 0 && p.H / p.Hkv <= 8) return launch<TC, 2>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// cache_dtype: 1 bf16, 2 int8 (then k_scale and v_scale are given). q and out
// are bf16. heads_per_block: 1, or 2 (Hkv even, H / Hkv <= 8). part_o, part_ml
// and arrived may be null when n_splits is 1; `arrived` holds B * Hkv /
// heads_per_block zeros and is left at zero.
extern "C" int vtt_decode_attention_sm90(
    const void* q, const void* k, const void* v, const int* pos, const uint8_t* key_valid,
    const float* k_scale, const float* v_scale, float* part_o, float* part_ml, int* arrived,
    void* out, int cache_dtype, int B, int H, int Hkv, int S, int D, int n_splits,
    int heads_per_block, long long q_sb, float sm_scale, void* stream) {
  if (H % Hkv != 0 || H / Hkv > kMaxRows || D != kD || n_splits < 1 ||
      (n_splits > 1 && (part_o == nullptr || part_ml == nullptr || arrived == nullptr)) ||
      (cache_dtype == 2) != (k_scale != nullptr && v_scale != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q); p.k = k; p.v = v; p.pos = pos;
  p.key_valid = key_valid; p.k_scale = k_scale; p.v_scale = v_scale;
  p.part_o = part_o; p.part_ml = part_ml; p.arrived = arrived;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B; p.H = H; p.Hkv = Hkv; p.S = S; p.n_splits = n_splits;
  p.q_sb = q_sb; p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (cache_dtype) {
    case 1: err = dispatch_heads<__nv_bfloat16>(p, heads_per_block, s); break;
    case 2: err = dispatch_heads<int8_t>(p, heads_per_block, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
