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
//
// The KV row write, fused (replaces, on this kernel's paths, the TPU kernel
// video_tokenizer_tpu/ops/cache_update.py::_rows_kernel, which
// csrc/cache_update.cu keeps for fp32 caches and D = 128). Given the chunk's
// new rows (`rows_k`, `rows_v`: [B, G, Hkv * 64] rows of the strided qkv view),
// the launch writes row g of cache row b at key pos[b] + g (rows past S are
// skipped) and attends over the caches so written, as csrc/cache_update.cu
// followed by this kernel would, bit for bit. It is done as in
// csrc/decode_attention_sm90.cu (see there): the block whose tile holds a new
// key writes that row's 64 columns of K and V of its KV head (an int8 cache:
// the amax over the whole row, the scale written by every owning block with
// the same bits) to the caches and to a patch area in shared memory, the
// block's K and V rows dealt over its four warps, each staged by cp.async with
// its warp's first tile, then one block barrier; tile copies stop at key
// pos[b] - 1, and the owner warp copies the patch into its staged tile once
// that tile has landed. The new keys pos[b] .. pos[b] + G - 1 lie in the last one
// or two tiles of the row, each the last tile of its warp. The staged rows
// take G x 2 x (64, or for an int8 cache Hkv x 64) values of shared memory.

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
  void* k;                      // [B, S, Hkv * 64], contiguous
  void* v;                      // [B, S, Hkv * 64], contiguous
  const int* pos;               // [B] position of chunk token 0 of each row
  const uint8_t* key_valid;     // [B, S] or null
  float* k_scale;               // [B, S] or null (int8 caches)
  float* v_scale;               // [B, S] or null
  const void* rows_k;           // [B, G, Hkv * 64] new K rows, strides (r_sb, r_sg, 1), or null
  const void* rows_v;           // [B, G, Hkv * 64] new V rows, the same strides
  float* part_o;                // [B, G, H, n_splits, 64] (n_splits > 1)
  float* part_ml;               // [B, G, H, n_splits, 2]: max (log2 domain), sum
  void* out;                    // [B, G, H, 64], contiguous, q's dtype
  int B, G, H, Hkv, S, n_splits;
  long long q_sb, q_sg, r_sb, r_sg;
  int q_bf16, rows_bf16;
  float sm_scale;
};

// After the warps' rings: the chunk's new rows of this KV head, K then V for
// token g at g * kPatchRow * 2, then their scales, two floats per token.
template <typename TC, int MT>
struct Patch {
  static constexpr int kRows = 16 * MT;  // chunk tokens: G <= G * rep <= 16 MT
  static constexpr int kRow = kD * (int)sizeof(TC);
  static constexpr int kScales = 2 * kRows * kRow;
  static constexpr int kBytes = kScales + 2 * kRows * (int)sizeof(float);
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
  // the fused row write: keys new_lo .. new_hi are new (then new_hi == last),
  // and the tile copies stop short of them
  const int new_lo = max(posb, 0), new_hi = min(posb + p.G - 1, p.S - 1);
  const bool writes = p.rows_k != nullptr && new_lo <= new_hi;
  const int load_last = writes ? new_lo - 1 : last;
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
      const bool in = key0 + r <= load_last;  // later rows are zero-filled, never read from memory
      const long long src = in ? (key0 + r) * row_bytes + lc * 16 : 0;
      cp_async16(stage + T::at(r, lc), kb + src, in ? 16 : 0);
      cp_async16(stage + T::kBytes + T::at(r, lc), vb + src, in ? 16 : 0);
    }
    if constexpr (T::kInt8) {
      // lanes 0..15: the K scales of the tile's keys, lanes 16..31: the V scales
      const int key = key0 + (lane & 15);
      const bool in = key <= load_last;
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

  // the new keys whose tiles are this block's (contiguous: the new keys span
  // at most three tiles, and a block holds four consecutive ones a round):
  // their K and V rows ("halves") are dealt round-robin over the warps, each
  // staged behind the patch area in its warp's first copy group
  using Pt = Patch<TC, MT>;
  unsigned char* patch = smem_raw + kWarps * kRingBytes;
  float* patch_scale = reinterpret_cast<float*>(patch + Pt::kScales);
  unsigned char* staged = patch + Pt::kBytes;
  const int elem = p.rows_bf16 ? 2 : 4;
  const int staged_cols = T::kInt8 ? p.Hkv * kD : kD;  // int8: the whole row, for its amax
  const int staged_bytes = staged_cols * elem;
  int mine_lo = 0, mine_hi = -1;  // this block's new keys
  if (writes) {
    for (int tt = new_lo / kTileKeys; tt <= new_hi / kTileKeys; ++tt) {
      if ((tt / kWarps) % p.n_splits != split) continue;
      if (mine_lo > mine_hi) mine_lo = max(new_lo, tt * kTileKeys);
      mine_hi = min(new_hi, tt * kTileKeys + kTileKeys - 1);
    }
  }
  const int halves = 2 * (mine_hi - mine_lo + 1);  // 0 when the block has no new key
  for (int i = warp; i < halves; i += kWarps) {
    const int gi = mine_lo + i / 2 - posb, kv = i & 1;
    const long long at = (b * p.r_sb + gi * p.r_sg + (T::kInt8 ? 0 : hk * kD)) * elem;
    kv_row_stage(smem_addr(staged) + (2 * gi + kv) * staged_bytes,
                 static_cast<const unsigned char*>(kv ? p.rows_v : p.rows_k) + at, staged_bytes,
                 lane);
  }

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < count) load_tile(it);
    cp_async_commit();
  }
  uint32_t valid_next = load_valid(0);

  // ---- the block's new rows, once staged (with the warps' first tiles): each
  // half by its warp, to the caches in device memory and to the patch area;
  // the block barrier hands the patch to the owner warps
  if (halves > 0) {
    if (warp < halves) {
      cp_async_wait<kStages - 2>();
      __syncwarp();
      for (int i = warp; i < halves; i += kWarps) {
        const int key = mine_lo + i / 2, gi = key - posb, kv = i & 1;
        const long long cache_row = ((long long)b * p.S + key) * p.Hkv * kD + hk * kD;
        const float sc = kv_row_convert<TC, kD>(
            staged + (2 * gi + kv) * staged_bytes, p.rows_bf16, staged_cols,
            T::kInt8 ? hk * kD : 0, static_cast<TC*>(kv ? p.v : p.k) + cache_row,
            T::kInt8 ? (kv ? p.v_scale : p.k_scale) + bs + key : nullptr,
            reinterpret_cast<TC*>(patch + (2 * gi + kv) * Pt::kRow), lane);
        if (lane == 0) patch_scale[2 * gi + kv] = sc;
      }
    }
    __syncthreads();
  }

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
    if (writes && key0 + kTileKeys > new_lo) {
      // a tile with new keys (its rows from new_lo on zero-filled) has landed:
      // patch rows r_lo .. r_hi
      const int r_lo = max(new_lo - key0, 0), n = min(new_hi - key0, kTileKeys - 1) - r_lo + 1;
      for (int i = lane; i < n * 2 * T::kChunks; i += 32) {
        const int r = r_lo + i / (2 * T::kChunks), kv = (i / T::kChunks) & 1, c = i % T::kChunks;
        *reinterpret_cast<uint4*>(smem_raw + stage_off + kv * T::kBytes + T::at(r, c)) =
            *reinterpret_cast<const uint4*>(patch + (2 * (key0 + r - posb) + kv) * Pt::kRow + c * 16);
      }
      if constexpr (T::kInt8) {
        // lanes 0..15 the K scales of rows 0..15, lanes 16..31 the V scales
        const int r = lane & 15;
        if (r >= r_lo && r < r_lo + n) {
          reinterpret_cast<float*>(smem_raw + stage_off + 2 * T::kBytes)[lane] =
              patch_scale[2 * (key0 + r - posb) + (lane >> 4)];
        }
      }
      __syncwarp();
    }

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
  // the rings, the patch area and (with rows) the staged K and V rows of the
  // chunk; above 48 KB only as opted-in dynamic shared memory
  const int staged = p.rows_k == nullptr ? 0
                     : 2 * p.G * (sizeof(TC) == 1 ? p.Hkv : 1) * kD * (p.rows_bf16 ? 2 : 4);
  const int smem = kWarps * kStages * Tile<TC>::kStageBytes + Patch<TC, MT>::kBytes + staged;
  // the opt-in only ever grows: a launch captured in a CUDA graph with the
  // staged rows must stay valid after a launch without them
  static int allowed = 0;
  const int opt_in = smem > allowed ? smem : allowed;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, opt_in);
  if (err != cudaSuccess) return err;
  allowed = opt_in;
  kernel<<<dim3(p.n_splits, p.Hkv, p.B), kThreads, smem, stream>>>(p);
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
// part_ml may be null when n_splits is 1. rows_k and rows_v (bf16 if
// rows_bf16, else fp32; strides r_sb, r_sg elements, unit column stride) are
// the chunk's new rows written at keys pos[b] + g first, or null: the caches
// are only read.
extern "C" int vtt_chunk_attention_sm90(
    const void* q, void* k, void* v, const int* pos, const uint8_t* key_valid, float* k_scale,
    float* v_scale, const void* rows_k, const void* rows_v, float* part_o, float* part_ml,
    void* out, int cache_dtype, int q_bf16, int rows_bf16, int B, int G, int H, int Hkv, int S,
    int D, int n_splits, long long q_sb, long long q_sg, long long r_sb, long long r_sg,
    float sm_scale, void* stream) {
  if (G < 1 || H % Hkv != 0 || D != kD || n_splits < 1 ||
      (n_splits > 1 && (part_o == nullptr || part_ml == nullptr)) ||
      (cache_dtype == 2) != (k_scale != nullptr && v_scale != nullptr) ||
      (rows_k == nullptr) != (rows_v == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q; p.k = k; p.v = v; p.pos = pos; p.key_valid = key_valid;
  p.k_scale = k_scale; p.v_scale = v_scale; p.rows_k = rows_k; p.rows_v = rows_v;
  p.part_o = part_o; p.part_ml = part_ml;
  p.out = out; p.B = B; p.G = G; p.H = H; p.Hkv = Hkv; p.S = S; p.n_splits = n_splits;
  p.q_sb = q_sb; p.q_sg = q_sg; p.r_sb = r_sb; p.r_sg = r_sg;
  p.q_bf16 = q_bf16; p.rows_bf16 = rows_bf16; p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (cache_dtype) {
    case 1: err = dispatch_rows<__nv_bfloat16>(p, s); break;
    case 2: err = dispatch_rows<int8_t>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
