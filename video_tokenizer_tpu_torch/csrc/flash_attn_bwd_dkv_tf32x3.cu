// Flash-attention backward, dK and dV, for Hopper (sm_90a), fp32, head dim 32
// or 64, on the tensor cores: every product as three TF32 products ("3xTF32",
// csrc/sm90.cuh) with fp32 accumulation, and an asynchronous ring of Q/dO
// tiles.
//
// Replaces, for fp32 inputs without segment ids, the same TPU kernel as
// flash_bwd_dkv_kernel in csrc/flash_attn_bwd.cu (which keeps D = 128 and
// segment ids):
//   * video_tokenizer_tpu/ops/attention.py::_bwd_dkv_kernel.
// The semantics are those stated at the head of csrc/flash_attn_bwd.cu and
// held against attention_bwd_reference in ops/attention.py: P recomputed from
// the forward's natural-log LSE, dS = P (dP - delta), dV = P^T dO,
// dK = scale dS^T Q per QUERY head ([B, Sk, H, D], the caller sums GQA
// groups), masked pairs carry nothing, except that a query row that sees no
// key (LSE = the mask value) adds dO / Sk to dV of every key; q, k, v, dO are
// read through strides, outputs are contiguous. fp32 stays fp32: every
// product is lo.hi + hi.lo + hi.hi of the operands' TF32 parts
// (ops/attention.py::attention_bwd_dkv_tf32x3_tiled_reference repeats the
// arithmetic).
//
// What bounds it: four S-sized products per tile pair (S^T, dP^T, dV, dK) over
// the bytes of q, k, v, dO: operations, as three TF32 products per product
// against 494.7 TFLOP/s (csrc/flash_attn_bwd.cu's scalar FMA chains were held
// to 67 TFLOP/s, with a block stall on every tile load). What the design does
// about it:
//   * mma.sync m16n8k8 tf32: a block of 4 warps owns 64 keys, a warp 16 of
//     them; K and V stay in shared memory for the whole kernel (their A
//     fragments are read once per tile: in registers they would take 64 more
//     a thread beside the four accumulators dK, dV, S^T, dP^T); Q and dO tiles
//     of 32 queries, with their LSE and delta, pass through a ring of kStages
//     stages filled by 16-byte cp.async copies, one block barrier per tile
//     (with 64-query tiles S^T and dP^T take 32 more registers a thread, and
//     the kernel spilled at D = 64);
//   * Q and dO are read both ways in one tile: along D for S^T = K.Q^T and
//     dP^T = V.dO^T, along the queries for dV += P^T.dO and dK += dS^T.Q. Both
//     reads are 16 bytes a thread and conflict-free in one layout
//     (csrc/sm90.cuh::Fp32Tile); each value is split into its TF32 parts where
//     it is read, once per use;
//   * the inner index is permuted as in csrc/flash_attn_fwd_tf32x3.cu, so P^T
//     and dS^T, formed in the score accumulators' registers, are the A
//     operands of the next products without a shuffle, and a thread reads
//     D / 8 consecutive values of a Q or dO row;
//   * each tile's dV and dK products go to an accumulator of their own,
//     joined to dV and dK by a rounded add: the tensor core does not round
//     the sums it adds into an accumulator to nearest, and the error of one
//     accumulator over all 64 query tiles at S = 2048 grows with Sq;
//   * P = exp2 with log2(e) folded into the scale and into the LSE; only
//     tiles that need a mask (the causal diagonal, ragged ends, rows that see
//     no key) test indices, per warp; causal blocks start at the first query
//     tile that can see them, where every row sees key 0.

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
  const float* dout;
  const float* lse;    // [B, H, Sq], natural log
  const float* delta;  // [B, H, Sq]
  float* dk;           // [B, Sk, H, D]
  float* dv;           // [B, Sk, H, D]
  int B, H, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO
  int causal, causal_offset;
  float sm_scale;
};

// The tiling: kWarps warps of 16 keys (kBlockK keys a block) take tiles of
// kBlockQ queries from a ring of kStages stages; kMinBlocks blocks share an SM.
constexpr int kWarps = 4;
constexpr int kBlockQ = 32;
constexpr int kStages = 3;
constexpr int kMinBlocks = 2;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = kWarps * 16;
constexpr int kAhead = kStages - 1;  // tiles in flight ahead of the one being read

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dkv_tf32x3_kernel(const Params p) {
  using T = Fp32Tile<D>;
  constexpr int kNT = D / 8;         // 8-column n-tiles of dK and dV
  constexpr int kST = kBlockQ / 8;   // 8-query score tiles = k-steps of P^T.dO
  constexpr int kKVBytes = kBlockK * T::kRowBytes;   // the block's K (and V)
  constexpr int kTileBytes = kBlockQ * T::kRowBytes;  // one Q or dO tile
  constexpr int kStageBytes = 2 * kTileBytes + 2 * kBlockQ * 4;  // + LSE and delta

  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned char* sK = smem;
  const unsigned char* sV = smem + kKVBytes;
  unsigned char* ring = smem + 2 * kKVBytes;

  const int kt0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int w_key0 = kt0 + warp * 16;  // this warp's first key
  const int keys[2] = {w_key0 + g, w_key0 + g + 8};

  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* ob = p.dout + b * p.o_sb + h * p.o_sh;
  const float* lse_row = p.lse + ((long long)b * p.H + h) * p.Sq;
  const float* delta_row = p.delta + ((long long)b * p.H + h) * p.Sq;

  const int num_tiles = (p.Sq + kBlockQ - 1) / kBlockQ;
  // Causal with every row seeing key 0 (offset >= 0), so that no query row is
  // fully masked (such a row adds to every key's dV): query tiles wholly
  // before this block's causal frontier contribute nothing.
  const bool rows_see_key0 = p.causal && p.causal_offset >= 0;
  const int start = rows_see_key0 ? max(0, (kt0 - p.causal_offset) / kBlockQ) : 0;
  const int count = max(0, num_tiles - start);

  static_assert(2 * kBlockQ <= kThreads, "LSE and delta of a tile, one value per thread");
  // tile `it` of the loop is query tile start + it, in stage it % kStages
  auto load_tile = [&](int it) {
    const int qs = (start + it) * kBlockQ;
    const uint32_t stage = smem_addr(ring + (it % kStages) * kStageBytes);
    fp32_tile_load<D, kBlockQ, kThreads>(stage, qb, p.q_ss, qs, p.Sq);
    fp32_tile_load<D, kBlockQ, kThreads>(stage + kTileBytes, ob, p.o_ss, qs, p.Sq);
    // one float a thread: the tile's LSE, then its delta
    if (threadIdx.x < 2 * kBlockQ) {
      const int j = threadIdx.x % kBlockQ;
      const bool in = qs + j < p.Sq;
      const float* src = (threadIdx.x < kBlockQ ? lse_row : delta_row) + (in ? qs + j : 0);
      cp_async4(stage + 2 * kTileBytes + threadIdx.x * 4, src, in ? 4 : 0);
    }
  };

  // prologue: K, V and the first kAhead tiles, one commit group per tile
  fp32_tile_load<D, kBlockK, kThreads>(smem_addr(sK), p.k + b * p.k_sb + hk * p.k_sh, p.k_ss,
                                       kt0, p.Sk);
  fp32_tile_load<D, kBlockK, kThreads>(smem_addr(sV), p.v + b * p.v_sb + hk * p.v_sh, p.v_ss,
                                       kt0, p.Sk);
#pragma unroll
  for (int it = 0; it < kAhead; ++it) {
    if (it < count) load_tile(it);
    cp_async_commit();
  }

  float dk[kNT][4], dv[kNT][4];  // key keys[e >> 1], head dim kNT (2 tig + (e & 1)) + n
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const float scale_log2 = p.sm_scale * kLog2e;
  const float inv_sk = 1.f / p.Sk;

  for (int it = 0; it < count; ++it) {
    // tile `it` has landed (this thread's copies, then everyone's after the
    // barrier); the barrier also says that tile it - 1 is no longer read, so
    // its stage is refilled
    cp_async_wait<kAhead - 1>();
    __syncthreads();
    if (it + kAhead < count) load_tile(it + kAhead);
    cp_async_commit();

    const int qs = (start + it) * kBlockQ;
    const unsigned char* sQ = ring + (it % kStages) * kStageBytes;
    const unsigned char* sO = sQ + kTileBytes;
    const float* sLse = reinterpret_cast<const float*>(sO + kTileBytes);
    const float* sDelta = sLse + kBlockQ;

    // ---- S^T = K Q^T and dP^T = V dO^T: key keys[e >> 1], query qs + 8 n + 2 tig + (e & 1)
    float s[kST][4], dp[kST][4];
    tf32x3_rows_dot_rows<D, kBlockQ>(s, sK, warp * 16, sQ, g, tig);
    tf32x3_rows_dot_rows<D, kBlockQ>(dp, sV, warp * 16, sO, g, tig);

    // ---- P^T and dS^T in place
    const bool masked_tile = w_key0 + 16 > p.Sk || qs + kBlockQ > p.Sq ||
                             (p.causal && qs + p.causal_offset < w_key0 + 15);
    if (masked_tile) {
#pragma unroll
      for (int n = 0; n < kST; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = 8 * n + 2 * tig + (e & 1);
          const int qi = qs + col;
          float pe = 0.f, ds = 0.f;
          if (qi < p.Sq && keys[r] < p.Sk) {
            const float lse = sLse[col];
            if (!p.causal || qi + p.causal_offset >= keys[r]) {
              pe = exp2_approx(fmaf(s[n][e], scale_log2, -lse * kLog2e));
              ds = pe * (dp[n][e] - sDelta[col]);
            } else if (lse < 0.5f * kMaskValue) {
              pe = inv_sk;  // a query that sees no key averages all of V
            }
          }
          s[n][e] = pe;
          dp[n][e] = ds;
        }
    } else {
#pragma unroll
      for (int n = 0; n < kST; ++n) {
        const float2 lse = *reinterpret_cast<const float2*>(sLse + 8 * n + 2 * tig);
        const float2 dl = *reinterpret_cast<const float2*>(sDelta + 8 * n + 2 * tig);
        const float neg[2] = {-lse.x * kLog2e, -lse.y * kLog2e};
        const float del[2] = {dl.x, dl.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2_approx(fmaf(s[n][e], scale_log2, neg[e & 1]));
          dp[n][e] = pe * (dp[n][e] - del[e & 1]);
          s[n][e] = pe;
        }
      }
    }

    // ---- dV += P^T dO, then dK += dS^T Q, dO and Q read along the queries
    tf32x3_probs_times_rows<D, kBlockQ>(dv, s, sO, g, tig);
    tf32x3_probs_times_rows<D, kBlockQ>(dk, dp, sQ, g, tig);
  }
  cp_async_wait<0>();

  tf32x3_store_rows<D>(p.dk, dk, p.sm_scale, b, h, p.H, p.Sk, keys, tig);
  tf32x3_store_rows<D>(p.dv, dv, 1.f, b, h, p.H, p.Sk, keys, tig);
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_tf32x3_kernel<D>;
  constexpr int kRow = Fp32Tile<D>::kRowBytes;
  constexpr int kSmemBytes =
      2 * kBlockK * kRow + kStages * (2 * kBlockQ * kRow + 2 * kBlockQ * 4);
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + kBlockK - 1) / kBlockK, p.H, p.B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vtt_flash_attn_bwd_dkv_tf32x3(
    const float* q, const float* k, const float* v, const float* dout, const float* lse,
    const float* delta, float* dk, float* dv, int B, int H, int Hkv, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int causal_offset, float sm_scale,
    void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dk = dk; p.dv = dv;
  p.B = B; p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal; p.causal_offset = causal_offset; p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64) err = launch<64>(p, s);
  if (D == 32) err = launch<32>(p, s);
  return static_cast<int>(err);
}
