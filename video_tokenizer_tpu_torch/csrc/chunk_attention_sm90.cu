// G-token chunk attention over a bf16 or int8 KV cache with per-row positions,
// head dim 64, for Hopper (sm_90a): tensor-core products and an asynchronous
// ring of K/V tiles per warp.
//
// Replaces, for bf16 and int8 caches at D = 64, the same TPU kernel as
// csrc/chunk_attention.cu (which keeps fp32 caches and D = 128):
//   * video_tokenizer_tpu/ops/decode_attention.py::_chunk_kernel.
// What it computes is stated at the head of csrc/chunk_attention.cu and held
// against chunk_attention_reference in ops/decode_attention.py: for cache row
// b, chunk token g and query head h, attention over keys 0 .. pos[b] + g
// (clamped to S - 1) of a [B, S, Hkv * 64] cache, `pos` read on the device,
// GQA, an optional key-valid mask, int8 K/V with one fp32 scale per cache row
// folded into the score (K) and the probability (V), q read in place through
// strides, output in q's dtype. As in the TPU kernel both products take bf16
// operands with fp32 sums: q is rounded to bf16, int8 values become bf16
// exactly, P (times the V scale) is rounded to bf16 before P.V. Keys past a
// query's limit and invalid keys score the mask value -0.7 * FLT_MAX, as in
// the plain version; a query with no valid key has no defined answer.
//
// What bounds it: the cache's bytes (84 MB of live K+V per layer at the 632M
// prior's verify shape against ~7 MFLOP per cache row): ~25 us at 3.35 TB/s,
// half of that with an int8 cache. The earlier kernel read the same bytes in
// six times that: per (key, query row) it paid three shuffles, an integer
// division and a shared store, converted every value to fp32, started V only
// after the softmax, and took ten block barriers per block.
// What the design does about it:
//   * a warp is the unit. It owns 16-key tiles of the cache, one in every
//     kWarps * n_splits (tiles are dealt round-robin over the warps of the
//     n_splits blocks of a (cache row, KV head), so the work is even whatever
//     pos is), and keeps its own online softmax (max, sum, O[rows x 64]) in
//     registers: no block barrier inside the loop. The four warps of a block
//     are merged once through shared memory, the blocks of a split cache by a
//     second small kernel (n_splits = 1 writes the output directly);
//   * the G * rep query rows of a KV head are the M dimension of mma.sync
//     m16n8k16, padded to 16 (or 32 for GQA): S = Q.K^T and O += P.V as in a
//     flash forward, Q held as A fragments for the whole kernel, P taken from
//     the score accumulator's registers. The row loop, its shuffles and the
//     fp32 converts of a bf16 cache are gone; mask, scales and softmax touch
//     eight scores per thread and tile;
//   * each warp fills a ring of kStages tiles by 16-byte cp.async copies, K and
//     V of a tile together (and the tile's scales for an int8 cache), so V is
//     in flight under the scores and later tiles under the current one. bf16
//     tiles keep 128-byte rows with the chunk ^ (row & 7) swizzle and are read
//     by ldmatrix (transposed for V); int8 tiles keep 64-byte rows, swizzled so
//     that both reads are free of bank conflicts, and are converted to bf16 in
//     registers on the way into the B fragments: the head dim is permuted for
//     K (q's fragments take the same permutation) and for V (the output
//     columns are permuted back), so every thread converts bytes it loaded
//     with one 16- or 8-byte read;
//   * everything runs on exp2 with log2(e) folded into the score scale; the
//     mask value is never multiplied, so it cannot overflow.
// Blocks whose first key lies past pos[b] + G - 1 exit at once; `pos`, the mask
// and the scales are read on the device: no host scalar, no synchronisation.

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
constexpr int kTileKeys = 16;  // keys of one warp step: one k-step of P.V
constexpr int kStages = 4;     // tiles in a warp's ring
constexpr int kBlockKeys = kWarps * kTileKeys;  // keys a block takes per round
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;                // [B, G, H, 64], strides (q_sb, q_sg, 64, 1)
  const void* k;                // [B, S, Hkv * 64], contiguous
  const void* v;                // [B, S, Hkv * 64], contiguous
  const int* pos;               // [B] position of chunk token 0 of each row
  const uint8_t* key_valid;     // [B, S] or null
  const float* k_scale;         // [B, S] or null (int8 caches)
  const float* v_scale;         // [B, S] or null
  float* part_o;                // [B, G, H, n_splits, 64] (n_splits > 1)
  float* part_ml;               // [B, G, H, n_splits, 2]: max (log2 domain), sum
  void* out;                    // [B, G, H, 64], contiguous, q's dtype
  int B, G, H, Hkv, S, n_splits;
  long long q_sb, q_sg;
  int q_bf16;
  float sm_scale;
};

template <typename TC>
using Tile = KvTile<TC>;

template <typename TC, int MT>
__global__ void __launch_bounds__(kThreads) chunk_attn_sm90_kernel(const Params p) {
  using T = Tile<TC>;
  constexpr int kRingBytes = kStages * T::kStageBytes;  // per warp
  constexpr int kRows = 16 * MT;
  static_assert(kRingBytes >= kRows * (kD + 2) * (int)sizeof(float),
                "a warp's partial result is staged in its own ring");
  extern __shared__ __align__(128) unsigned char smem_raw[];

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int posb = p.pos[b];
  const int last = max(min(posb + p.G - 1, p.S - 1), 0);  // the chunk's last token sees the most
  if (split * kBlockKeys > last) return;  // past every query's keys: the merge skips this split
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int rep = p.H / p.Hkv;
  const int R = p.G * rep;  // query rows of this KV head, row = chunk token * rep + r

  // ---- this thread's rows 16 mt + g + 8 i: their key limits and Q fragments
  int lim[MT][2];
  uint32_t qa[MT][kD / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 16 * mt + g + 8 * i;
      const bool in = row < R;
      const int cg = in ? row / rep : 0;
      const int head = hk * rep + (in ? row - cg * rep : 0);
      lim[mt][i] = in ? max(min(posb + cg, p.S - 1), 0) : -1;  // a padding row sees nothing
      const long long at = b * p.q_sb + cg * p.q_sg + (long long)head * kD;
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int d = T::q_col(ks, tig, half);
          uint32_t pair = 0u;
          if (in) {
            if (p.q_bf16) {
              pair = *reinterpret_cast<const uint32_t*>(
                  static_cast<const __nv_bfloat16*>(p.q) + at + d);
            } else {
              const float2 x =
                  *reinterpret_cast<const float2*>(static_cast<const float*>(p.q) + at + d);
              pair = pack_bf16(x.x, x.y);
            }
          }
          qa[mt][ks][i + 2 * half] = pair;
        }
      }
    }
  }

  // ---- this warp's tiles: t0, t0 + step, ... while their first key is <= last
  const int step = kWarps * p.n_splits;
  const int t0 = split * kWarps + warp;
  const int last_tile = last / kTileKeys;
  const int count = t0 > last_tile ? 0 : (last_tile - t0) / step + 1;

  const uint32_t ring = smem_addr(smem_raw) + warp * kRingBytes;
  const long long row_bytes = (long long)p.Hkv * kD * sizeof(TC);
  const long long head_at = (long long)b * p.S * row_bytes + (long long)hk * kD * sizeof(TC);
  const unsigned char* kb = static_cast<const unsigned char*>(p.k) + head_at;
  const unsigned char* vb = static_cast<const unsigned char*>(p.v) + head_at;
  const long long bs = (long long)b * p.S;  // this cache row in the [B, S] planes
  // one lane copies the same chunk of rows lr, lr + 32 / kChunks, ... of a tile
  const int lc = lane % T::kChunks, lr = lane / T::kChunks;
  constexpr int kRowStep = 32 / T::kChunks;

  auto load_tile = [&](int it) {
    const int key0 = (t0 + it * step) * kTileKeys;
    const uint32_t stage = ring + (it % kStages) * T::kStageBytes;
#pragma unroll
    for (int i = 0; i < kTileKeys / kRowStep; ++i) {
      const int r = lr + i * kRowStep;
      const bool in = key0 + r <= last;  // later rows are zero-filled, never read from memory
      const long long src = in ? (key0 + r) * row_bytes + lc * 16 : 0;
      cp_async16(stage + T::at(r, lc), kb + src, in ? 16 : 0);
      cp_async16(stage + T::kBytes + T::at(r, lc), vb + src, in ? 16 : 0);
    }
    if constexpr (T::kInt8) {
      // lanes 0..15: the K scales of the tile's keys, lanes 16..31: the V scales
      const int key = key0 + (lane & 15);
      const bool in = key <= last;
      const float* src = (lane < 16 ? p.k_scale : p.v_scale) + (in ? bs + key : 0);
      cp_async4(stage + 2 * T::kBytes + lane * 4, src, in ? 4 : 0);
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

  float m_run[MT][2], l_run[MT][2];  // running max (log2 domain); this thread's share of the sum
  float o[MT][kD / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
  }
  const float scale_log2 = p.sm_scale * kLog2e;

  for (int it = 0; it < count; ++it) {
    // tile `it` has landed (every lane's copies, after the warp barrier), and
    // tile it - 1 is no longer read: its stage is refilled
    cp_async_wait<kStages - 2>();
    __syncwarp();
    if (it + kStages - 1 < count) load_tile(it + kStages - 1);
    cp_async_commit();
    const uint32_t valid = valid_next;
    valid_next = load_valid(it + 1);  // one tile ahead of its use

    const int key0 = (t0 + it * step) * kTileKeys;
    const int stage_off = warp * kRingBytes + (it % kStages) * T::kStageBytes;
    const uint32_t sK = smem_addr(smem_raw) + stage_off;
    const uint32_t sV = sK + T::kBytes;

    // ---- S[rows x 16 keys] = Q K^T; s[mt][j][e]: row g + 8 (e / 2), key 8 j + 2 tig + e % 2
    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if constexpr (T::kInt8) {
        const unsigned char* tile = smem_raw + stage_off;
        uint4 w = *reinterpret_cast<const uint4*>(tile + T::at(8 * j + g, tig));
        const uint32_t words[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                                   w.w ^ 0x80808080u};
#pragma unroll
        for (int ks = 0; ks < kD / 16; ++ks) {
          const uint32_t b0 = int8_pair_to_bf16(words[ks], 0, words[ks], 1);
          const uint32_t b1 = int8_pair_to_bf16(words[ks], 2, words[ks], 3);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_m16n8k16(s[mt][j], qa[mt][ks], b0, b1);
        }
      } else {
#pragma unroll
        for (int q2 = 0; q2 < kD / 32; ++q2) {
          // matrices: keys 8 j .. 8 j + 7, head-dim chunks 4 q2 .. 4 q2 + 3
          uint32_t kf[4];
          ldmatrix_x4(kf, sK + T::at(8 * j + (lane & 7), 4 * q2 + (lane >> 3)));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_m16n8k16(s[mt][j], qa[mt][2 * q2], kf[0], kf[1]);
            mma_m16n8k16(s[mt][j], qa[mt][2 * q2 + 1], kf[2], kf[3]);
          }
        }
      }
    }

    // ---- scale, mask, online softmax; P (times the V scale) as bf16 A fragments
    float c[2][2], vs[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        c[j][e] = scale_log2;
        vs[j][e] = 1.f;
        if constexpr (T::kInt8) {
          const float* sc = reinterpret_cast<const float*>(smem_raw + stage_off + 2 * T::kBytes);
          c[j][e] *= sc[8 * j + 2 * tig + e];
          vs[j][e] = sc[kTileKeys + 8 * j + 2 * tig + e];
        }
      }
    }
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * j + 2 * tig + (e & 1);
          float y = s[mt][j][e] * c[j][e & 1];
          if (key > lim[mt][e >> 1] || !((valid >> (2 * j + (e & 1))) & 1u)) y = kMaskValue;
          s[mt][j][e] = y;
          mx[e >> 1] = fmaxf(mx[e >> 1], y);
        }
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // the four threads of a quad share a row
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[mt][i], mx[i]);  // finite: at least the mask value
        alpha[i] = exp2_approx(m_run[mt][i] - m_new);
        m_run[mt][i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2_approx(s[mt][j][e] - m_run[mt][e >> 1]);
          sum[e >> 1] += pe;
          s[mt][j][e] = pe * vs[j][e & 1];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[mt][i] = l_run[mt][i] * alpha[i] + sum[i];
      pa[mt][0] = pack_bf16(s[mt][0][0], s[mt][0][1]);
      pa[mt][1] = pack_bf16(s[mt][0][2], s[mt][0][3]);
      pa[mt][2] = pack_bf16(s[mt][1][0], s[mt][1][1]);
      pa[mt][3] = pack_bf16(s[mt][1][2], s[mt][1][3]);
#pragma unroll
      for (int n = 0; n < kD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][n][e] *= alpha[e >> 1];
    }

    // ---- O[rows x 64] += P V
    if constexpr (T::kInt8) {
      // bytes 8 g .. 8 g + 7 of keys 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9
      const unsigned char* tile = smem_raw + stage_off + T::kBytes;
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
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_m16n8k16(o[mt][n], pa[mt], b0, b1);
      }
    } else {
#pragma unroll
      for (int n2 = 0; n2 < kD / 16; ++n2) {
        // matrices: keys 0..7 and 8..15 of head-dim chunk 2 n2, then of chunk 2 n2 + 1
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sV + T::at((lane & 7) + 8 * ((lane >> 3) & 1), 2 * n2 + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_m16n8k16(o[mt][2 * n2], pa[mt], vf[0], vf[1]);
          mma_m16n8k16(o[mt][2 * n2 + 1], pa[mt], vf[2], vf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncwarp();  // every lane has read the last tile: the ring becomes the staging area

  // ---- this warp's partial result into its ring: O [rows][64], then max, sum
  float* stage_o = reinterpret_cast<float*>(smem_raw + warp * kRingBytes);
  float* stage_ml = stage_o + kRows * kD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[mt][i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = 16 * mt + g + 8 * i;
      if (tig == 0) {
        stage_ml[2 * row] = m_run[mt][i];
        stage_ml[2 * row + 1] = l;
      }
#pragma unroll
      for (int n = 0; n < kD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          stage_o[row * kD + T::o_col(n, 2 * tig + e)] = o[mt][n][2 * i + e];
    }
  }
  __syncthreads();

  // ---- merge the block's warps (one without tiles has max -inf, sum 0)
  for (int idx = threadIdx.x; idx < R * kD; idx += kThreads) {
    const int row = idx / kD, d = idx % kD;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* ml = reinterpret_cast<const float*>(smem_raw + w * kRingBytes) + kRows * kD;
      m = fmaxf(m, ml[2 * row]);
    }
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* wo = reinterpret_cast<const float*>(smem_raw + w * kRingBytes);
      const float* ml = wo + kRows * kD;
      const float wgt = exp2_approx(ml[2 * row] - m);
      l += ml[2 * row + 1] * wgt;
      acc += wo[row * kD + d] * wgt;
    }
    const int cg = row / rep;
    const long long bgh = ((long long)b * p.G + cg) * p.H + hk * rep + (row - cg * rep);
    if (p.n_splits == 1) {
      const float y = acc / l;
      if (p.q_bf16) {
        static_cast<__nv_bfloat16*>(p.out)[bgh * kD + d] = __float2bfloat16(y);
      } else {
        static_cast<float*>(p.out)[bgh * kD + d] = y;
      }
    } else {
      p.part_o[(bgh * p.n_splits + split) * kD + d] = acc;
      if (d == 0) {
        float* ml = p.part_ml + (bgh * p.n_splits + split) * 2;
        ml[0] = m;
        ml[1] = l;
      }
    }
  }
}

// Merges the splits that ran for one (cache row, chunk token, head): split s
// ran iff its first key 64 s is within the chunk's last limit, and holds a key
// of this query iff 64 s is within the query's own. One thread per element.
template <typename TO>
__global__ void __launch_bounds__(kD) chunk_merge_sm90_kernel(const Params p) {
  const int h = blockIdx.x, cg = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int limit = max(min(p.pos[b] + cg, p.S - 1), 0);
  const int n_live = min(p.n_splits, limit / kBlockKeys + 1);
  const long long bgh = ((long long)b * p.G + cg) * p.H + h;
  const float* ml = p.part_ml + bgh * p.n_splits * 2;
  float m = -INFINITY;
  for (int s = 0; s < n_live; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const float wgt = exp2_approx(ml[2 * s] - m);
    l += ml[2 * s + 1] * wgt;
    acc += p.part_o[(bgh * p.n_splits + s) * kD + d] * wgt;
  }
  const float y = acc / l;
  TO* out = static_cast<TO*>(p.out) + bgh * kD + d;
  if constexpr (sizeof(TO) == 2) {
    *out = __float2bfloat16(y);
  } else {
    *out = y;
  }
}

template <typename TC, int MT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = chunk_attn_sm90_kernel<TC, MT>;
  constexpr int kSmemBytes = kWarps * kStages * Tile<TC>::kStageBytes;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.n_splits, p.Hkv, p.B), kThreads, kSmemBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_splits == 1) return err;
  if (p.q_bf16) {
    chunk_merge_sm90_kernel<__nv_bfloat16><<<dim3(p.H, p.G, p.B), kD, 0, stream>>>(p);
  } else {
    chunk_merge_sm90_kernel<float><<<dim3(p.H, p.G, p.B), kD, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename TC>
cudaError_t dispatch_rows(const Params& p, cudaStream_t stream) {
  const int R = p.G * (p.H / p.Hkv);
  if (R <= 16) return launch<TC, 1>(p, stream);
  if (R <= 32) return launch<TC, 2>(p, stream);
  return cudaErrorInvalidValue;  // no instance for more query rows per KV head
}

}  // namespace

// cache_dtype: 1 bf16, 2 int8 (then k_scale and v_scale are given). part_o and
// part_ml may be null when n_splits is 1.
extern "C" int vtt_chunk_attention_sm90(
    const void* q, const void* k, const void* v, const int* pos, const uint8_t* key_valid,
    const float* k_scale, const float* v_scale, float* part_o, float* part_ml, void* out,
    int cache_dtype, int q_bf16, int B, int G, int H, int Hkv, int S, int D, int n_splits,
    long long q_sb, long long q_sg, float sm_scale, void* stream) {
  if (G < 1 || H % Hkv != 0 || D != kD || n_splits < 1 ||
      (n_splits > 1 && (part_o == nullptr || part_ml == nullptr)) ||
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
  switch (cache_dtype) {
    case 1: err = dispatch_rows<__nv_bfloat16>(p, s); break;
    case 2: err = dispatch_rows<int8_t>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
