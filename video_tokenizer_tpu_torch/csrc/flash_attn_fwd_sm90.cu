// Flash-attention forward for Hopper (sm_90a), bf16, head dim 32, 64 or 80,
// with warpgroup matrix products (wgmma) and an asynchronous ring of K/V tiles.
//
// Replaces, for bf16 inputs with or without segment ids, the same two TPU
// kernels as csrc/flash_attn_fwd.cu (which keeps head dim 128):
//   * video_tokenizer_tpu/ops/attention.py::_fwd_kernel_packed, and
//   * video_tokenizer_tpu/ops/attention.py::_fwd_kernel (with the fp32 LSE).
// The semantics are those stated at the head of csrc/flash_attn_fwd.cu and
// held against attention_reference in ops/attention.py: fp32 scores, masked
// pairs at -0.7 * FLT_MAX (a query that sees no key attends uniformly), keys
// past Sk are no keys, causal with an offset, segment ids (a pair attends iff
// its ids are equal), GQA, P rounded to bf16 for P.V, fp32 running max / sum /
// accumulator, strided q/k/v read in place, out [B, Sq, H, D] contiguous, LSE
// [B, H, Sq] in natural log.
//
// What bounds it: at the flagship shape (S = 2048, D = 64) attention does
// ~1000 flops per byte, so the tensor cores bound it, closely followed by the
// special-function unit: one exponential per score is 1/256 of the matmul
// flops at D = 64, and the card's exp rate is ~1/256 of its bf16 matmul rate;
// the softmax's other fp32 work per score (max, scale, sum, rounding) is of
// the same order again. A kernel is fast here only if the three overlap.
// With segment ids the bound is the operations on the key tiles a block
// visits (4 D flops a visible score pair, not 4 D Sq Sk): a packed sequence of
// clips of L_i tokens has sum L_i^2 visible pairs of (sum L_i)^2.
// What the design does about it:
//   * a block owns 128 query rows, one warpgroup per 64 rows, and two blocks
//     share an SM (at most 128 registers a thread, 65 KB of shared memory),
//     so that four warpgroups are in flight: while some wait for their
//     products the others run their softmax. Q is held in registers as wgmma
//     A fragments; K and V tiles of 64 keys pass through a ring of 4 stages
//     filled by 16-byte cp.async copies into the 128-byte swizzled layout of
//     csrc/sm90.cuh (each thread's source pointer and destination offset are
//     computed once), so a tile is loaded while earlier ones are multiplied,
//     and both warpgroups share each tile;
//   * S = Q.K^T is wgmma m64n64k16 with K read from shared memory by
//     descriptor (no load instruction, no fragment gather); P is rounded to
//     bf16 in the accumulator's registers and is the register A operand of
//     O += P.V, with V read MN-major from the same row tile (no transpose);
//   * the softmax runs on exp2 with log2(e) folded into the scale: one FMA
//     and one ex2 per score on tiles that need no mask. Tiles that do (the
//     causal diagonal, the ragged last tile, keys whose segment id differs
//     from a row's) keep the mask value in the natural-log domain, (x - max) *
//     log2(e), so that -0.7 * FLT_MAX never meets the folded scale (it would
//     overflow to -inf and turn a row that sees no key into NaN);
//   * causal blocks skip key tiles past their last visible key (each
//     warpgroup its own) and start with the longest rows.
// Head dim 80 (the V-JEPA2 ViT-H teacher's 1280 / 16, `Tiles<80>`): a 160-byte
// row is a 64-column row tile plus a 16-column panel with the 32-byte swizzle,
// so S = Q.K^T is five k16 steps over two descriptors and P.V one N = 64 and
// one N = 16 product per k16 step. Its 40 output registers a thread leave no
// room under the 128 of two blocks an SM for Q's 20 fragment registers, so Q
// comes into shared memory beside the ring (20 KB, both layouts) and every
// S = Q.K^T step reads it by descriptor (wgmma with both operands in shared
// memory): two blocks an SM and no spill, where Q in registers spilled at two
// blocks or ran one block an SM, ~1.3x slower (PERF.md).
// Segment ids (the kSeg instance; the instance without them is the kernel as
// it was before they came here): each key tile's ids come into shared memory
// with the tile, through the same ring (4-byte cp.async copies). A tile takes
// the masked path for a warpgroup unless every one of its keys has the id that
// all the warpgroup's rows share, so a sequence with one id everywhere runs
// the same tiles and the same arithmetic as without ids. Where one id tensor
// serves queries and keys (`seg_window`, set by the wrapper: every query then
// matches at least its own key), each block first reads all Sk key ids and
// visits only the key tiles from the first to the last that holds a key whose
// id lies in [min, max] of its rows' ids: the tiles it skips hold no key
// equal to any of its rows, whose terms would be exp(mask - max) = 0 exactly,
// so the result is the same bit for bit, and the ring stays a contiguous range
// of tiles. Causal composes with it (every row sees its own key). With
// distinct query and key ids (a row may match no key and then needs all Sk
// keys) every tile is visited.
// What was measured against it and lost (PERF.md has the numbers): 128-key
// tiles and four-warpgroup blocks (one block per SM: fewer independent
// warpgroups), one warpgroup per block (twice the tile traffic), Q read from
// shared memory by every product at D = 64 (there Q fits in registers), and P.V started one iteration late behind
// the next Q.K^T (no gain once four warpgroups overlap). The tiling is
// therefore fixed in the constants below. What is left: no warp-specialised
// producer (TMA), so every warp still spends issue slots on copies and all
// warps of a block meet at one barrier per tile; the output goes to memory
// from the accumulator layout in 4-byte pieces.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* q_seg;    // [B, Sq] or null
  const int* k_seg;    // [B, Sk] or null
  __nv_bfloat16* out;  // [B, Sq, H, D], contiguous
  float* lse;          // [B, H, Sq] or null
  int B, H, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, causal_offset;
  int seg_window;  // q_seg is k_seg: visit only the key tiles a block's ids can match
  float sm_scale;
};

// The tiling: kWG warpgroups of 64 query rows share kBlockN-key tiles in a
// ring of kStages stages; kMinBlocks blocks share an SM.
constexpr int kWG = 2;
constexpr int kBlockN = 64;
constexpr int kStages = 4;
constexpr int kMinBlocks = 2;
constexpr int kThreads = kWG * 128;
constexpr int kBlockM = kWG * 64;
constexpr int kAhead = kStages - 1;  // tiles in flight ahead of the one being read
constexpr int kSegBytes = (kStages * kBlockN + 4 * kThreads / 32) * 4;

// One K or V tile of kBlockN rows: the first kMain columns as a row tile
// (128-byte swizzle); at D = 80 the last 16 columns follow as a 32-byte
// panel (csrc/sm90.cuh), so that a 160-byte row costs 160 bytes of shared
// memory and not the 256 of two row tiles. With kQSmem (D = 80) the block's
// kBlockM query rows follow the ring in the same two layouts.
template <int D>
struct Tiles {
  static constexpr int kMain = D < 64 ? D : 64;  // columns in the row tile
  static constexpr int kTail = D - kMain;        // columns in the panel: 0 or 16
  static_assert(kTail == 0 || kTail == 16, "head dim 32, 64 or 80");
  static constexpr bool kQSmem = kTail != 0;     // Q read from shared memory
  static constexpr int kPanel = kBlockN * kRowBytes;  // the panel's offset in a tile
  static constexpr int kTileBytes = kPanel + kBlockN * kTail * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kQPanel = kBlockM * kRowBytes;  // Q's panel's offset in its tile
  static constexpr int kQBytes = kQSmem ? kQPanel + kBlockM * kTail * 2 : 0;
  // + kAtomBytes: the dynamic shared memory's start is aligned by hand; with
  // segment ids, each stage's kBlockN key ids and the prologue's per-warp
  // minima and maxima follow the ring and Q
  static constexpr int kRingBytes = kStages * kStageBytes + kQBytes + kAtomBytes;
  static_assert(kTileBytes % kAtomBytes == 0, "every tile and panel stays aligned");
};
template <int D, bool kSeg>
constexpr int smem_bytes() { return Tiles<D>::kRingBytes + (kSeg ? kSegBytes : 0); }

template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd_sm90_kernel(const Params p) {
  using T = Tiles<D>;
  constexpr int kSRegs = kBlockN / 2;  // score accumulator registers per thread
  constexpr int kORegs = T::kMain / 2;  // the row tile's columns
  constexpr int kTRegs = T::kTail ? T::kTail / 2 : 1;  // the panel's (unused without one)
  constexpr int kTileBytes = T::kTileBytes, kStageBytes = T::kStageBytes;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t sKV = (smem_addr(smem_raw) + kAtomBytes - 1) & ~(uint32_t)(kAtomBytes - 1);
  const uint32_t sQ = sKV + kStages * kStageBytes;  // with kQSmem
  // segment ids: [kStages][kBlockN] key ids after the ring and Q, then the prologue's scratch
  int* const sSeg = reinterpret_cast<int*>(smem_raw + T::kRingBytes);
  const uint32_t sSegAddr = smem_addr(sSeg);

  // causal: the blocks with the most visible keys start first
  const int q_tile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = q_tile * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int wg_row0 = q0 + wg * 64;  // this warpgroup's first query row
  const int qr[2] = {wg_row0 + warp * 16 + g, wg_row0 + warp * 16 + g + 8};

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;
  const int* ks = kSeg ? p.k_seg + (long long)b * p.Sk : nullptr;

  int t_begin = 0;
  int t_end = (p.Sk + kBlockN - 1) / kBlockN;
  // segment ids: this thread's rows' ids, the warpgroup's [min, max], the window
  int qseg[2] = {0, 0};
  int wg_lo = 0, wg_hi = -1;
  if constexpr (kSeg) {
    segment_prologue<kThreads / 32, 4, kBlockN>(
        p.q_seg + (long long)b * p.Sq, ks, p.Sq, p.Sk, qr, p.seg_window,
        sSeg + kStages * kBlockN, qseg, wg_lo, wg_hi, t_begin, t_end);
  }
  const bool wg_uniform = kSeg && wg_lo == wg_hi;  // one id for all the warpgroup's rows
  // Causal: skip key tiles past the block's last visible key, but only where
  // every row of the block sees a key that is kept (key 0 without segment
  // ids, its own key in a window), so that no fully masked row (which attends
  // uniformly over ALL keys) loses keys it should average over.
  const bool causal_cap = p.causal && (kSeg ? p.seg_window != 0 : q0 + p.causal_offset >= 0);
  if (causal_cap) {
    const int last_key = q0 + kBlockM - 1 + p.causal_offset;
    t_end = min(t_end, last_key / kBlockN + 1);
  }

  const RowTileLoader<T::kMain, kBlockN, kThreads> k_loader(kb, p.k_ss, p.Sk),
      v_loader(vb, p.v_ss, p.Sk);
  const PanelLoader<kBlockN, kThreads> k_panel(kb, p.k_ss, p.Sk, T::kMain),
      v_panel(vb, p.v_ss, p.Sk, T::kMain);
  auto load_kv = [&](int t) {
    const uint32_t dst = sKV + (t % kStages) * kStageBytes;
    k_loader.load(dst, t * kBlockN);
    v_loader.load(dst + kTileBytes, t * kBlockN);
    if constexpr (T::kTail != 0) {
      k_panel.load(dst + T::kPanel, t * kBlockN);
      v_panel.load(dst + kTileBytes + T::kPanel, t * kBlockN);
    }
    if constexpr (kSeg) {
      const int key = t * kBlockN + threadIdx.x;
      if (threadIdx.x < kBlockN) {
        cp_async4(sSegAddr + ((t % kStages) * kBlockN + threadIdx.x) * 4, key < p.Sk ? ks + key : ks,
                  key < p.Sk ? 4 : 0);
      }
    }
  };

  // prologue: Q, this thread's share of its warp's 16 query rows as register A
  // fragments (or, with kQSmem, the block's rows into shared memory in the
  // first tile's commit group), and the first kAhead tiles, one commit group
  // per tile
  uint32_t qf[T::kQSmem ? 1 : D / 16][4];
  if constexpr (T::kQSmem) {
    RowTileLoader<T::kMain, kBlockM, kThreads>(qb, p.q_ss, p.Sq).load(sQ, q0);
    PanelLoader<kBlockM, kThreads>(qb, p.q_ss, p.Sq, T::kMain).load(sQ + T::kQPanel, q0);
  } else {
#pragma unroll
    for (int ks_ = 0; ks_ < D / 16; ++ks_)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = qr[j & 1], col = ks_ * 16 + tig * 2 + (j >> 1) * 8;
        qf[ks_][j] = row < p.Sq
                         ? *reinterpret_cast<const uint32_t*>(qb + (long long)row * p.q_ss + col)
                         : 0u;
      }
  }
#pragma unroll
  for (int t = 0; t < kAhead; ++t) {
    if (t_begin + t < t_end) load_kv(t_begin + t);
    cp_async_commit();
  }

  float s[kSRegs];
  float o[kORegs];   // O's row-tile columns, in the accumulator layout
  float ot[kTRegs];  // O's panel columns (D = 80): columns kMain + 8 (i / 4) + 2 tig + (i & 1)
#pragma unroll
  for (int i = 0; i < kORegs; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTRegs; ++i) ot[i] = 0.f;
  uint32_t pf[kBlockN / 16][4];             // P of the last tile, bf16 A fragments
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, natural-log domain
  float l_run[2] = {0.f, 0.f};              // this thread's share of the running sum

  const float scale_log2 = p.sm_scale * kLog2e;

  // Online softmax of the score tile at key k0, in place: s becomes P (fp32),
  // m_run and l_run move on, alpha is what O must be scaled by before this
  // tile's P.V is added. d[i]: row qr[(i >> 1) & 1], key k0 + 8 (i / 4) + 2 tig + (i & 1).
  // With segment ids, `kid` holds the tile's key ids.
  auto softmax_tile = [&](int k0, const int* kid, float (&alpha)[2]) {
    bool masked_tile =
        k0 + kBlockN > p.Sk || p.sm_scale <= 0.f ||
        (p.causal && k0 + kBlockN - 1 > wg_row0 + p.causal_offset);
    if constexpr (kSeg) {
      // the fast path only where every key of the tile has the warpgroup's one
      // id (each quad reads all kBlockN ids, so the vote is the warpgroup's)
      bool same = wg_uniform;
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        const int2 id = *reinterpret_cast<const int2*>(kid + 8 * j + 2 * tig);
        same = same && id.x == wg_lo && id.y == wg_lo;
      }
      masked_tile = masked_tile || !__all_sync(0xffffffffu, same);
    }
    float mx[2] = {-INFINITY, -INFINITY};
    if (masked_tile) {
#pragma unroll
      for (int i = 0; i < kSRegs; ++i) {
        const int r = (i >> 1) & 1;
        const int key = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
        float x = s[i] * p.sm_scale;
        if (key >= p.Sk) {
          x = -INFINITY;  // past the end: not a key at all
        } else if ((p.causal && qr[r] + p.causal_offset < key) ||
                   (kSeg && qseg[r] != kid[8 * (i >> 2) + 2 * tig + (i & 1)])) {
          x = kMaskValue;
        }
        s[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kSRegs; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      mx[0] *= p.sm_scale;
      mx[1] *= p.sm_scale;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four threads of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: every tile holds a real key
      alpha[r] = exp2_approx((m_run[r] - m_new) * kLog2e);
      m_run[r] = m_new;
    }
    float rowsum[2] = {0.f, 0.f};
    if (masked_tile) {
      // the mask value stays in the natural-log domain: (mask - mask) = 0
      // for a row that has seen no key yet, -inf otherwise
#pragma unroll
      for (int i = 0; i < kSRegs; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = exp2_approx((s[i] - m_run[r]) * kLog2e);
        rowsum[r] += s[i];
      }
    } else {
      const float neg_m[2] = {-m_run[0] * kLog2e, -m_run[1] * kLog2e};
#pragma unroll
      for (int i = 0; i < kSRegs; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = exp2_approx(fmaf(s[i], scale_log2, neg_m[r]));
        rowsum[r] += s[i];
      }
    }
    l_run[0] = l_run[0] * alpha[0] + rowsum[0];
    l_run[1] = l_run[1] * alpha[1] + rowsum[1];
  };
  // O *= alpha and P (fp32 in s) -> bf16 A fragments
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < kORegs; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < kTRegs; ++i) ot[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pf[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
  };
  // the row tile's k16 steps, then the panel's one (a descriptor of its own)
  auto start_qk = [&](uint32_t sK) {
    const uint64_t desc_k = row_tile_desc(sK);
    if constexpr (T::kQSmem) {  // this warpgroup's 64 rows of Q
      const uint64_t desc_q = row_tile_desc(sQ + wg * 64 * kRowBytes);
#pragma unroll
      for (int ks_ = 0; ks_ < T::kMain / 16; ++ks_)
        wgmma_ss(s, desc_q + ks_ * kStepKMajor, desc_k + ks_ * kStepKMajor, ks_ > 0);
      wgmma_ss(s, panel_desc(sQ + T::kQPanel + wg * 64 * kPanelRowBytes),
               panel_desc(sK + T::kPanel), 1);
    } else {
#pragma unroll
      for (int ks_ = 0; ks_ < T::kMain / 16; ++ks_)
        wgmma_rs<0>(s, qf[ks_], desc_k + ks_ * kStepKMajor, ks_ > 0);
      if constexpr (T::kTail != 0) wgmma_rs<0>(s, qf[T::kMain / 16], panel_desc(sK + T::kPanel), 1);
    }
  };
  // O's row-tile columns, then its panel columns: N = kMain and N = 16
  auto start_pv = [&](uint32_t sV) {
    const uint64_t desc_v = row_tile_desc(sV);
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      wgmma_rs<1>(o, pf[kk], desc_v + kk * kStepMNMajor, 1);
    if constexpr (T::kTail != 0) {
      const uint64_t desc_p = panel_desc(sV + T::kPanel);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_rs<1>(ot, pf[kk], desc_p + kk * kStepPanelMNMajor, 1);
    }
  };

  // tiles this warpgroup multiplies: those after its last visible key give P = 0
  int wg_tiles = t_end;
  if (causal_cap) wg_tiles = min(t_end, (wg_row0 + 63 + p.causal_offset) / kBlockN + 1);

  for (int t = t_begin; t < t_end; ++t) {
    // tile t has landed (this thread's copies), is published to the wgmma
    // proxy, and after the barrier every thread's copies have; the barrier
    // also says that the tiles before t are no longer read, so the oldest
    // stage is refilled
    cp_async_wait<kAhead - 1>();
    fence_async_proxy();
    __syncthreads();
    if (t + kAhead < t_end) load_kv(t + kAhead);
    cp_async_commit();
    if (t >= wg_tiles) continue;

    const uint32_t sK = sKV + (t % kStages) * kStageBytes;
    float alpha[2];
    fence_regs(s);
    wgmma_fence();
    start_qk(sK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(t * kBlockN, sSeg + (t % kStages) * kBlockN, alpha);
    rescale_and_pack(alpha);
    fence_regs(o);
    fence_regs(ot);
    wgmma_fence();
    start_pv(sK + kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(ot);
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) fence_regs(pf[kk]);
  }
  cp_async_wait<0>();

  // ---- epilogue
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    if (l_run[r] == 0.f) l_run[r] = 1.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qr[r] >= p.Sq) continue;
    const float inv_l = 1.f / l_run[r];
    __nv_bfloat16* orow = p.out + (((long long)b * p.Sq + qr[r]) * p.H + h) * D;
#pragma unroll
    for (int n = 0; n < T::kMain / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + tig * 2) =
          pack_bf16(o[4 * n + 2 * r] * inv_l, o[4 * n + 2 * r + 1] * inv_l);
    }
#pragma unroll
    for (int n = 0; n < T::kTail / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + T::kMain + n * 8 + tig * 2) =
          pack_bf16(ot[4 * n + 2 * r] * inv_l, ot[4 * n + 2 * r + 1] * inv_l);
    }
    if (p.lse != nullptr && tig == 0) {
      p.lse[((long long)b * p.H + h) * p.Sq + qr[r]] = m_run[r] + logf(l_run[r]);
    }
  }
}

template <int D, bool kSeg>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = flash_fwd_sm90_kernel<D, kSeg>;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<D, kSeg>());
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockM - 1) / kBlockM, p.H, p.B);
  kernel<<<grid, kThreads, smem_bytes<D, kSeg>(), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vtt_flash_attn_fwd_sm90(
    const void* q, const void* k, const void* v, const int* q_seg, const int* k_seg, void* out,
    float* lse, int B, int H, int Hkv, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, int causal_offset, int seg_window, float sm_scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.q_seg = q_seg;
  p.k_seg = k_seg;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = lse;
  p.B = B; p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.causal = causal; p.causal_offset = causal_offset; p.sm_scale = sm_scale;
  p.seg_window = seg_window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool seg = q_seg != nullptr;
  if ((q_seg == nullptr) != (k_seg == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 80) err = seg ? launch<80, true>(p, s) : launch<80, false>(p, s);
  if (D == 64) err = seg ? launch<64, true>(p, s) : launch<64, false>(p, s);
  if (D == 32) err = seg ? launch<32, true>(p, s) : launch<32, false>(p, s);
  return static_cast<int>(err);
}
