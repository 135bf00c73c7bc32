// Flash-attention forward for Hopper (sm_90a), fp32, head dim 32 or 64, on the
// tensor cores: both products as three TF32 products ("3xTF32", csrc/sm90.cuh)
// with fp32 accumulation, and an asynchronous ring of K/V tiles.
//
// Replaces, for fp32 inputs with or without segment ids, the same two TPU
// kernels as csrc/flash_attn_fwd.cu (which keeps head dim 128):
//   * video_tokenizer_tpu/ops/attention.py::_fwd_kernel_packed, and
//   * video_tokenizer_tpu/ops/attention.py::_fwd_kernel (with the fp32 LSE).
// The semantics are those stated at the head of csrc/flash_attn_fwd.cu and
// held against attention_reference in ops/attention.py: fp32 scores, masked
// pairs at -0.7 * FLT_MAX (a query that sees no key attends uniformly), keys
// past Sk are no keys, causal with an offset, segment ids (a pair attends iff
// its ids are equal), GQA, fp32 running max / sum /
// accumulator, strided q/k/v read in place, out [B, Sq, H, D] contiguous, LSE
// [B, H, Sq] in natural log. fp32 stays fp32: every product is
// lo.hi + hi.lo + hi.hi of the operands' TF32 parts, within ~2^-21 of the fp32
// product (ops/attention.py::attention_tf32x3_tiled_reference repeats the
// arithmetic), where one TF32 product would keep three decimal digits.
//
// What bounds it: attention does ~1000 flops per byte at the training shape
// (S = 2048, D = 64), so operations: 3 TF32 products per fp32 product against
// 494.7 TFLOP/s of dense TF32, a bound 2.4x below the 67 TFLOP/s of fp32 FMAs
// that csrc/flash_attn_fwd.cu is held to. That kernel ran the products as
// scalar FMA chains, one block of 4 warps per 64 query rows, and stalled the
// block on every tile load. With segment ids the bound is the operations on
// the key tiles a block visits (4 D flops, as three TF32 products each, a
// visible score pair): a packed sequence of clips of L_i tokens has
// sum L_i^2 visible pairs of (sum L_i)^2.
// What the design does about it:
//   * mma.sync m16n8k8 tf32 (the instruction of PyTorch's own fp32 attention,
//     the memory-efficient kernel's OpMultiplyAddFastF32): a warp owns 16
//     query rows, a block 4 warps (64 rows); two blocks share an SM. Q stays
//     in registers for the whole kernel, split where it is used;
//   * K and V tiles of 64 keys pass through a ring of 3 stages filled by
//     16-byte cp.async copies, one block barrier per tile: a tile is loaded
//     while earlier ones are multiplied;
//   * each warp splits the K and V values it loads into their TF32 parts in
//     registers (an integer add, a mask and a subtraction a value; lo is
//     truncated by the tensor core), and P in registers. Splitting once per
//     tile into shared memory instead would double the ring (one block per
//     SM) and the fragment reads, which the warps' 16 rows already make heavy;
//   * the inner index is permuted so that every shared-memory read is 16
//     bytes: along D (Q.K^T) a thread's four slots of two k-steps are four
//     consecutive head-dim values; along the keys (P.V) slots tig and tig + 4
//     of k-step j are keys 8 j + 2 tig and 8 j + 2 tig + 1, which are the
//     score accumulator's columns, so P needs no shuffle; and V's output
//     columns are permuted (column g of n-tile n is head-dim value
//     (D / 8) g + n), so a thread reads D / 8 consecutive values of a V row
//     and writes D / 4 consecutive outputs. The K and V tiles are XOR-swizzled
//     (Tile below) so that these reads hit every bank once;
//   * the softmax is that of csrc/flash_attn_fwd_sm90.cu: exp2 with log2(e)
//     folded into the scale, and on tiles that need a mask (the causal
//     diagonal, the ragged last tile, keys whose segment id differs from a
//     row's) the mask value kept in the natural-log domain so that it never
//     meets the folded scale; causal blocks skip key tiles past their last
//     visible key (each warp its own) and start with the longest rows;
//   * segment ids (the kSeg instance; the one without them is the kernel as
//     it was before they came here) as in csrc/flash_attn_fwd_sm90.cu: each
//     tile's key ids come with the tile through the ring, a tile takes the
//     masked path for a warp unless all its keys have the id all the warp's
//     16 rows share, and where one id tensor serves queries and keys a block
//     visits only the key tiles from the first to the last that holds a key
//     whose id lies in [min, max] of its rows' ids (the skipped tiles' terms
//     are exp(mask - max) = 0 exactly: the result is the same bit for bit).

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
  const float* q;
  const float* k;
  const float* v;
  const int* q_seg;  // [B, Sq] or null
  const int* k_seg;  // [B, Sk] or null
  float* out;        // [B, Sq, H, D], contiguous
  float* lse;        // [B, H, Sq] or null
  int B, H, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, causal_offset;
  int seg_window;  // q_seg is k_seg: visit only the key tiles a block's ids can match
  float sm_scale;
};

// The tiling: kWarps warps of 16 query rows share kBlockN-key tiles in a ring
// of kStages stages; kMinBlocks blocks share an SM.
constexpr int kWarps = 4;
constexpr int kStages = 3;
constexpr int kMinBlocks = 2;
constexpr int kBlockN = 64;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = kWarps * 16;
constexpr int kAhead = kStages - 1;  // tiles in flight ahead of the one being read

// A K or V tile in shared memory: kBlockN rows of D fp32, row r at r * D * 4
// bytes, its 16-byte chunk c at chunk position c ^ swizzle(r).
template <int D>
struct Tile {
  static constexpr int kChunks = D / 4;
  static constexpr int kBytes = kBlockN * D * 4;
  static constexpr int kStageBytes = 2 * kBytes;  // K, then V
  // K: the 8 threads of a quarter warp read chunk 4 p + tig of rows g and g + 1
  // (g even): row parity picks the half of the 8 bank groups
  __device__ static int k_at(int r, int c) { return (r * kChunks + (c ^ ((r & 1) << 2))) * 16; }
  // V: they read chunk (D / 32) g (+ 1) of rows 2 tig + e: tig spreads the chunks
  // over the bank groups that g leaves free
  __device__ static int v_at(int r, int c) {
    const int s = D == 64 ? (((r >> 1) & 1) | (((r >> 2) & 1) << 2)) : (((r >> 1) & 3) << 1);
    return (r * kChunks + (c ^ s)) * 16;
  }
};

// shared memory: the ring, then with segment ids each stage's kBlockN key ids
// and the prologue's per-warp minima and maxima
template <int D, bool kSeg>
constexpr int smem_bytes() {
  return kStages * Tile<D>::kStageBytes + (kSeg ? (kStages * kBlockN + 4 * kWarps) * 4 : 0);
}

template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd_tf32x3_kernel(const Params p) {
  using T = Tile<D>;
  constexpr int kNT = D / 8;         // 8-column output tiles
  constexpr int kKP = D / 16;        // pairs of 8-deep k-steps of Q.K^T
  constexpr int kST = kBlockN / 8;   // 8-key score tiles = k-steps of P.V

  extern __shared__ __align__(128) unsigned char smem[];
  int* const sSeg = reinterpret_cast<int*>(smem + kStages * T::kStageBytes);

  // causal: the blocks with the most visible keys start first
  const int q_tile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = q_tile * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int w_row0 = q0 + warp * 16;  // this warp's first query row
  const int qr[2] = {w_row0 + g, w_row0 + g + 8};

  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vb = p.v + b * p.v_sb + hk * p.v_sh;
  const int* ks = kSeg ? p.k_seg + (long long)b * p.Sk : nullptr;

  int t_begin = 0;
  int t_end = (p.Sk + kBlockN - 1) / kBlockN;
  // segment ids: this thread's rows' ids, the warp's [min, max], the window
  int qseg[2] = {0, 0};
  int w_lo = 0, w_hi = -1;
  if constexpr (kSeg) {
    segment_prologue<kWarps, 1, kBlockN>(p.q_seg + (long long)b * p.Sq, ks, p.Sq, p.Sk, qr,
                                         p.seg_window, sSeg + kStages * kBlockN, qseg, w_lo,
                                         w_hi, t_begin, t_end);
  }
  const bool w_uniform = kSeg && w_lo == w_hi;  // one id for all the warp's rows
  // Causal: skip key tiles past the block's last visible key, but only where
  // every row of the block sees a key that is kept (key 0 without segment
  // ids, its own key in a window), so that no fully masked row (which attends
  // uniformly over ALL keys) loses keys it should average over.
  const bool causal_cap = p.causal && (kSeg ? p.seg_window != 0 : q0 + p.causal_offset >= 0);
  if (causal_cap) {
    t_end = min(t_end, (q0 + kBlockM - 1 + p.causal_offset) / kBlockN + 1);
  }
  // tiles this warp multiplies: those after its last visible key give P = 0
  int warp_tiles = t_end;
  if (causal_cap) warp_tiles = min(t_end, (w_row0 + 15 + p.causal_offset) / kBlockN + 1);

  // one thread's 16-byte copies of tile t (rows past Sk zero-filled), and
  // with segment ids the tile's key ids
  static_assert(kBlockN * T::kChunks % kThreads == 0, "every thread copies as many chunks");
  auto load_kv = [&](int t) {
    unsigned char* stage = smem + (t % kStages) * T::kStageBytes;
    const int key0 = t * kBlockN;
#pragma unroll
    for (int it = 0; it < kBlockN * T::kChunks / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / T::kChunks, c = i % T::kChunks;
      const bool in = key0 + r < p.Sk;
      const long long row = in ? key0 + r : 0;
      cp_async16(smem_addr(stage + T::k_at(r, c)), kb + row * p.k_ss + c * 4, in ? 16 : 0);
      cp_async16(smem_addr(stage + T::kBytes + T::v_at(r, c)), vb + row * p.v_ss + c * 4,
                 in ? 16 : 0);
    }
    if constexpr (kSeg) {
      const int key = key0 + threadIdx.x;
      if (threadIdx.x < kBlockN) {
        cp_async4(smem_addr(sSeg + (t % kStages) * kBlockN + threadIdx.x),
                  key < p.Sk ? ks + key : ks, key < p.Sk ? 4 : 0);
      }
    }
  };

  // prologue: the first kAhead tiles in flight, one commit group per tile
#pragma unroll
  for (int t = 0; t < kAhead; ++t) {
    if (t_begin + t < t_end) load_kv(t_begin + t);
    cp_async_commit();
  }

  // Q as A fragments in fp32, split into its TF32 parts where it is used (8
  // values a pair of k-steps and tile; the parts held for the whole kernel
  // would take 32 more registers). Slot tig (+4) of k-step 2 kp + s is
  // head-dim value 16 kp + 4 tig + 2 s (+1), so a thread's four slots of a
  // pair of k-steps are four consecutive values: one 16-byte read of Q and of K.
  float qa[kKP][2][4];
#pragma unroll
  for (int kp = 0; kp < kKP; ++kp) {
    float4 x[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      x[r] = qr[r] < p.Sq
                 ? *reinterpret_cast<const float4*>(qb + (long long)qr[r] * p.q_ss + 16 * kp + 4 * tig)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float a[2][4] = {{x[0].x, x[1].x, x[0].y, x[1].y}, {x[0].z, x[1].z, x[0].w, x[1].w}};
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) qa[kp][s][j] = a[s][j];
  }

  float sc[kST][4];  // scores, then P: row qr[e >> 1], key k0 + 8 n + 2 tig + (e & 1)
  float o[kNT][4];   // output: row qr[e >> 1], head dim kNT (2 tig + (e & 1)) + n
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, natural-log domain
  float l_run[2] = {0.f, 0.f};              // this thread's share of the running sum
  const float scale_log2 = p.sm_scale * kLog2e;

  for (int t = t_begin; t < t_end; ++t) {
    // tile t has landed (this thread's copies, then everyone's after the
    // barrier); the barrier also says that tile t - 1 is no longer read, so
    // its stage is refilled
    cp_async_wait<kAhead - 1>();
    __syncthreads();
    if (t + kAhead < t_end) load_kv(t + kAhead);
    cp_async_commit();
    if (t >= warp_tiles) continue;

    const unsigned char* sK = smem + (t % kStages) * T::kStageBytes;
    const unsigned char* sV = sK + T::kBytes;
    const int k0 = t * kBlockN;

    // ---- S = Q K^T
#pragma unroll
    for (int n = 0; n < kST; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < kKP; ++kp) {
      uint32_t qh[2][4], ql[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int j = 0; j < 4; ++j) split_tf32(qa[kp][s][j], qh[s][j], ql[s][j]);
#pragma unroll
      for (int n = 0; n < kST; ++n) {
        const float4 kv = *reinterpret_cast<const float4*>(sK + T::k_at(8 * n + g, 4 * kp + tig));
        uint32_t bh[4], bl[4];
        split_tf32(kv.x, bh[0], bl[0]);
        split_tf32(kv.y, bh[1], bl[1]);
        split_tf32(kv.z, bh[2], bl[2]);
        split_tf32(kv.w, bh[3], bl[3]);
        mma_m16n8k8_tf32x3(sc[n], qh[0], ql[0], bh[0], bh[1], bl[0], bl[1]);
        mma_m16n8k8_tf32x3(sc[n], qh[1], ql[1], bh[2], bh[3], bl[2], bl[3]);
      }
    }

    // ---- online softmax of the tile, in place: sc becomes P
    const int* kid = sSeg + (t % kStages) * kBlockN;  // the tile's key ids (kSeg)
    bool masked_tile = k0 + kBlockN > p.Sk || p.sm_scale <= 0.f ||
                       (p.causal && k0 + kBlockN - 1 > w_row0 + p.causal_offset);
    if constexpr (kSeg) {
      // the fast path only where every key of the tile has the warp's one id
      // (each quad reads all kBlockN ids)
      bool same = w_uniform;
#pragma unroll
      for (int n = 0; n < kST; ++n) {
        const int2 id = *reinterpret_cast<const int2*>(kid + 8 * n + 2 * tig);
        same = same && id.x == w_lo && id.y == w_lo;
      }
      masked_tile = masked_tile || !__all_sync(0xffffffffu, same);
    }
    float mx[2] = {-INFINITY, -INFINITY};
    if (masked_tile) {
#pragma unroll
      for (int n = 0; n < kST; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = k0 + 8 * n + 2 * tig + (e & 1);
          float x = sc[n][e] * p.sm_scale;
          if (key >= p.Sk) {
            x = -INFINITY;  // past the end: not a key at all
          } else if ((p.causal && qr[r] + p.causal_offset < key) ||
                     (kSeg && qseg[r] != kid[8 * n + 2 * tig + (e & 1)])) {
            x = kMaskValue;
          }
          sc[n][e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
    } else {
#pragma unroll
      for (int n = 0; n < kST; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      mx[0] *= p.sm_scale;
      mx[1] *= p.sm_scale;
    }
    float alpha[2];
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
      // the mask value stays in the natural-log domain: (mask - mask) = 0 for
      // a row that has seen no key yet, -inf otherwise
#pragma unroll
      for (int n = 0; n < kST; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = exp2_approx((sc[n][e] - m_run[e >> 1]) * kLog2e);
          rowsum[e >> 1] += sc[n][e];
        }
    } else {
      const float neg_m[2] = {-m_run[0] * kLog2e, -m_run[1] * kLog2e};
#pragma unroll
      for (int n = 0; n < kST; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = exp2_approx(fmaf(sc[n][e], scale_log2, neg_m[e >> 1]));
          rowsum[e >> 1] += sc[n][e];
        }
    }
    l_run[0] = l_run[0] * alpha[0] + rowsum[0];
    l_run[1] = l_run[1] * alpha[1] + rowsum[1];

    // ---- O = alpha O + P V. The tile's P.V goes to an accumulator of its own:
    // the tensor core does not round the sums it adds into an accumulator to
    // nearest, and over all the key tiles of a row in one accumulator that
    // error grows with Sk (2.2e-5 of max|out| at S = 2048 against 3e-6 of the
    // FMA kernel); the tile's sum joins O by a rounded FFMA.
    // k-step j: slots tig and tig + 4 are keys 8 j + 2 tig and 8 j + 2 tig + 1,
    // the columns this thread holds of score tile j
    float pv[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kST; ++j) {
      uint32_t ph[4], pl[4];
      split_tf32(sc[j][0], ph[0], pl[0]);
      split_tf32(sc[j][2], ph[1], pl[1]);
      split_tf32(sc[j][1], ph[2], pl[2]);
      split_tf32(sc[j][3], ph[3], pl[3]);
      // head-dim values kNT g .. kNT g + kNT - 1 of the two keys' V rows
      float vr[2][kNT];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int c = 0; c < kNT / 4; ++c) {
          const float4 x = *reinterpret_cast<const float4*>(
              sV + T::v_at(8 * j + 2 * tig + e, (kNT / 4) * g + c));
          vr[e][4 * c] = x.x;
          vr[e][4 * c + 1] = x.y;
          vr[e][4 * c + 2] = x.z;
          vr[e][4 * c + 3] = x.w;
        }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        uint32_t b0h, b0l, b1h, b1l;
        split_tf32(vr[0][n], b0h, b0l);
        split_tf32(vr[1][n], b1h, b1l);
        mma_m16n8k8_tf32x3(pv[n], ph, pl, b0h, b1h, b0l, b1l);
      }
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], alpha[e >> 1], pv[n][e]);
  }
  cp_async_wait<0>();

  // ---- epilogue: row qr[r] holds head-dim values 2 kNT tig .. 2 kNT tig + 2 kNT - 1
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
    float* orow = p.out + (((long long)b * p.Sq + qr[r]) * p.H + h) * D + 2 * kNT * tig;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int c = 0; c < kNT / 4; ++c) {
        const int e = 2 * r + half;
        *reinterpret_cast<float4*>(orow + kNT * half + 4 * c) =
            make_float4(o[4 * c][e] * inv_l, o[4 * c + 1][e] * inv_l, o[4 * c + 2][e] * inv_l,
                        o[4 * c + 3][e] * inv_l);
      }
    if (p.lse != nullptr && tig == 0) {
      p.lse[((long long)b * p.H + h) * p.Sq + qr[r]] = m_run[r] + logf(l_run[r]);
    }
  }
}

template <int D, bool kSeg>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = flash_fwd_tf32x3_kernel<D, kSeg>;
  constexpr int kSmemBytes = smem_bytes<D, kSeg>();
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockM - 1) / kBlockM, p.H, p.B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vtt_flash_attn_fwd_tf32x3(
    const float* q, const float* k, const float* v, const int* q_seg, const int* k_seg,
    float* out, float* lse, int B, int H, int Hkv, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, int causal_offset, int seg_window, float sm_scale, void* stream) {
  if ((q_seg == nullptr) != (k_seg == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.q_seg = q_seg; p.k_seg = k_seg; p.out = out; p.lse = lse;
  p.B = B; p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.causal = causal; p.causal_offset = causal_offset; p.sm_scale = sm_scale;
  p.seg_window = seg_window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool seg = q_seg != nullptr;
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64) err = seg ? launch<64, true>(p, s) : launch<64, false>(p, s);
  if (D == 32) err = seg ? launch<32, true>(p, s) : launch<32, false>(p, s);
  return static_cast<int>(err);
}
