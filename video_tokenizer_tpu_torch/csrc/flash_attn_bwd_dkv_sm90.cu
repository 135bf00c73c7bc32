// Flash-attention backward, dK and dV, for Hopper (sm_90a), bf16, head dim 32
// or 64, with warpgroup matrix products (wgmma) and an asynchronous ring of
// Q/dO tiles.
//
// Replaces, for bf16 inputs without segment ids, the same TPU kernel as
// flash_bwd_dkv_kernel in csrc/flash_attn_bwd.cu (which keeps fp32, D = 128
// and segment ids):
//   * video_tokenizer_tpu/ops/attention.py::_bwd_dkv_kernel.
// The semantics are those stated at the head of csrc/flash_attn_bwd.cu and
// held against attention_bwd_reference in ops/attention.py: P recomputed from
// the forward's natural-log LSE, dS = P (dP - delta), dV = P^T dO,
// dK = scale dS^T Q per QUERY head ([B, Sk, H, D], the caller sums GQA
// groups), masked pairs carry nothing, except that a query row that sees no
// key (LSE = the mask value) adds dO / Sk to dV of every key; P and dS are
// rounded to bf16 before their products, every sum is fp32; q, k, v, dO are
// read through strides, outputs are contiguous.
//
// What bounds it: four S-sized products per tile pair (S^T, dP^T, dV, dK)
// over the bytes of q, k, v, dO: the tensor cores, at every shape of the
// training path, with one exponential and a few fp32 operations per score
// beside them. What the design does about it:
//   * a block is one warpgroup that owns 64 keys, K and V resident in shared
//     memory, and two blocks share an SM (the four fp32 accumulators dK, dV,
//     S^T, dP^T take 128 of a thread's registers), so one block's products
//     run while the other is in its element-wise phase; Q and dO tiles of 64
//     queries, with their LSE and delta, pass through a ring of 4 stages
//     filled by cp.async into the 128-byte swizzled layout of csrc/sm90.cuh;
//   * S^T = K.Q^T and dP^T = V.dO^T are wgmma m64n64k16 with both operands read
//     from shared memory by descriptor, started together; P^T and dS^T are
//     formed in the accumulators' registers (exp2 with log2(e) folded into the
//     scale and into the LSE), rounded to bf16, and are the register A
//     operands of dV += P^T.dO and dK += dS^T.Q, with dO and Q read MN-major
//     from the tiles already in shared memory: nothing is transposed or
//     written back;
//   * only tiles that need a mask (the causal diagonal, ragged ends, rows
//     that see no key) pay for index tests; causal blocks start at the first
//     query tile that can see them.
// What was measured against it and lost (PERF.md has the numbers): two
// warpgroups sharing the Q/dO tiles in one block per SM, and three blocks per
// SM with a 3-stage ring (the register cap of 168 spills). The tiling is
// therefore fixed in the constants below. What is left: S and dP are still
// computed twice (here and in the dQ kernel), no warp-specialised producer
// (TMA), K and V are read from shared memory by every product.

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
// The tiling: a block is one warpgroup that owns kBlockK keys; tiles of kBlockQ
// queries pass through a ring of kStages stages; kMinBlocks blocks share an SM.
constexpr int kBlockK = 64;
constexpr int kBlockQ = 64;
constexpr int kStages = 4;
constexpr int kMinBlocks = 2;
constexpr int kThreads = 128;
constexpr int kKVBytes = kBlockK * kRowBytes;   // the block's K (and V) tile
constexpr int kTileBytes = kBlockQ * kRowBytes;  // one Q or dO tile
constexpr int kStageBytes = 2 * kTileBytes + kAtomBytes;  // + LSE and delta of the tile
// + kAtomBytes: the dynamic shared memory's start is aligned by hand
constexpr int kSmemBytes = 2 * kKVBytes + kStages * kStageBytes + kAtomBytes;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // [B, H, Sq], natural log
  const float* delta;  // [B, H, Sq]
  __nv_bfloat16* dk;   // [B, Sk, H, D]
  __nv_bfloat16* dv;   // [B, Sk, H, D]
  int B, H, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO
  int causal, causal_offset;
  float sm_scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dkv_sm90_kernel(const Params p) {
  constexpr int kSRegs = kBlockQ / 2;  // registers of a 64 x 64 accumulator
  constexpr int kDRegs = D / 2;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t smem = (raw + kAtomBytes - 1) & ~(uint32_t)(kAtomBytes - 1);
  const unsigned char* smem_ptr = smem_raw + (smem - raw);
  const uint32_t sK = smem;
  const uint32_t sV = smem + kKVBytes;
  const uint32_t sRing = smem + 2 * kKVBytes;

  const int kt0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int kr[2] = {kt0 + warp * 16 + g, kt0 + warp * 16 + g + 8};

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* ob = p.dout + b * p.o_sb + h * p.o_sh;
  const float* lse_row = p.lse + ((long long)b * p.H + h) * p.Sq;
  const float* delta_row = p.delta + ((long long)b * p.H + h) * p.Sq;

  const int num_tiles = (p.Sq + kBlockQ - 1) / kBlockQ;
  // Causal with every row seeing key 0 (offset >= 0), so that no query row is
  // fully masked (such a row adds to every key's dV): query tiles wholly
  // before this key tile's causal frontier contribute nothing.
  const bool rows_see_key0 = p.causal && p.causal_offset >= 0;
  const int start = rows_see_key0 ? max(0, (kt0 - p.causal_offset) / kBlockQ) : 0;
  const int count = max(0, num_tiles - start);

  // tile `it` of the loop is query tile start + it, in stage it % kStages
  const RowTileLoader<D, kBlockQ, kThreads> q_loader(qb, p.q_ss, p.Sq), do_loader(ob, p.o_ss, p.Sq);
  auto load_tile = [&](int it) {
    const int qs = (start + it) * kBlockQ;
    const uint32_t dst = sRing + (it % kStages) * kStageBytes;
    q_loader.load(dst, qs);
    do_loader.load(dst + kTileBytes, qs);
    // one float a thread: the tile's LSE, then its delta
    static_assert(kThreads == 2 * kBlockQ, "LSE and delta of a tile, one value per thread");
    const int j = threadIdx.x % kBlockQ;
    const bool in = qs + j < p.Sq;
    const float* src = (threadIdx.x < kBlockQ ? lse_row : delta_row) + (in ? qs + j : 0);
    cp_async4(dst + 2 * kTileBytes + threadIdx.x * 4, src, in ? 4 : 0);
  };

  // prologue: K, V and the first kStages - 1 tiles, one commit group per tile
  RowTileLoader<D, kBlockK, kThreads>(p.k + b * p.k_sb + hk * p.k_sh, p.k_ss, p.Sk).load(sK, kt0);
  RowTileLoader<D, kBlockK, kThreads>(p.v + b * p.v_sb + hk * p.v_sh, p.v_ss, p.Sk).load(sV, kt0);
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < count) load_tile(it);
    cp_async_commit();
  }

  float dk[kDRegs], dv[kDRegs];
#pragma unroll
  for (int i = 0; i < kDRegs; ++i) dk[i] = dv[i] = 0.f;

  const float scale_log2 = p.sm_scale * kLog2e;
  const float inv_sk = 1.f / p.Sk;
  const uint64_t desc_k = row_tile_desc(sK);
  const uint64_t desc_v = row_tile_desc(sV);

  for (int it = 0; it < count; ++it) {
    // tile `it` has landed and is published to the wgmma proxy; after the
    // barrier tile it - 1 is no longer read, so its stage is refilled
    cp_async_wait<kStages - 2>();
    fence_async_proxy();
    __syncthreads();
    if (it + kStages - 1 < count) load_tile(it + kStages - 1);
    cp_async_commit();

    const int qs = (start + it) * kBlockQ;
    const uint32_t stage = sRing + (it % kStages) * kStageBytes;
    const uint64_t desc_q = row_tile_desc(stage);
    const uint64_t desc_do = row_tile_desc(stage + kTileBytes);
    const float* sLse = reinterpret_cast<const float*>(smem_ptr + (stage - smem) + 2 * kTileBytes);
    const float* sDelta = sLse + kBlockQ;

    // ---- S^T = K Q^T and dP^T = V dO^T (rows: keys, columns: queries)
    float s[kSRegs], dp[kSRegs];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(s, desc_k + ks * kStepKMajor, desc_q + ks * kStepKMajor, ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(dp, desc_v + ks * kStepKMajor, desc_do + ks * kStepKMajor, ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // ---- P^T and dS^T. d[i]: key kr[(i >> 1) & 1], query qs + 8 (i / 4) + 2 tig + (i & 1)
    const bool masked_tile =
        kt0 + kBlockK > p.Sk || qs + kBlockQ > p.Sq ||
        (p.causal && qs + p.causal_offset < kt0 + kBlockK - 1);
    if (masked_tile) {
#pragma unroll
      for (int i = 0; i < kSRegs; ++i) {
        const int r = (i >> 1) & 1;
        const int col = 8 * (i >> 2) + 2 * tig + (i & 1);
        const int qi = qs + col;
        float pe = 0.f, ds = 0.f;
        if (qi < p.Sq && kr[r] < p.Sk) {
          const float lse = sLse[col];
          if (!p.causal || qi + p.causal_offset >= kr[r]) {
            pe = exp2_approx(fmaf(s[i], scale_log2, -lse * kLog2e));
            ds = pe * (dp[i] - sDelta[col]);
          } else if (lse < 0.5f * kMaskValue) {
            pe = inv_sk;  // a query that sees no key averages all of V
          }
        }
        s[i] = pe;
        dp[i] = ds;
      }
    } else {
#pragma unroll
      for (int n = 0; n < kBlockQ / 8; ++n) {
        const float2 lse = *reinterpret_cast<const float2*>(sLse + 8 * n + 2 * tig);
        const float2 dl = *reinterpret_cast<const float2*>(sDelta + 8 * n + 2 * tig);
        const float neg[2] = {-lse.x * kLog2e, -lse.y * kLog2e};
        const float del[2] = {dl.x, dl.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * n + e;
          const float pe = exp2_approx(fmaf(s[i], scale_log2, neg[e & 1]));
          dp[i] = pe * (dp[i] - del[e & 1]);
          s[i] = pe;
        }
      }
    }

    // ---- dV += P^T dO and dK += dS^T Q, P^T and dS^T from registers in bf16
    uint32_t pf[kBlockQ / 16][4], df[kBlockQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockQ / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pf[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
        df[kk][j] = pack_bf16(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);
      }
    }
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockQ / 16; ++kk)
      wgmma_rs<1>(dv, pf[kk], desc_do + kk * kStepMNMajor, 1);
#pragma unroll
    for (int kk = 0; kk < kBlockQ / 16; ++kk)
      wgmma_rs<1>(dk, df[kk], desc_q + kk * kStepMNMajor, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
#pragma unroll
    for (int kk = 0; kk < kBlockQ / 16; ++kk) {
      fence_regs(pf[kk]);
      fence_regs(df[kk]);
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: rows past Sk are not written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kr[r] >= p.Sk) continue;
    const long long at = (((long long)b * p.Sk + kr[r]) * p.H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int i = 4 * n + 2 * r;
      *reinterpret_cast<uint32_t*>(p.dk + at + n * 8 + tig * 2) =
          pack_bf16(dk[i] * p.sm_scale, dk[i + 1] * p.sm_scale);
      *reinterpret_cast<uint32_t*>(p.dv + at + n * 8 + tig * 2) = pack_bf16(dv[i], dv[i + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_sm90_kernel<D>;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + kBlockK - 1) / kBlockK, p.H, p.B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vtt_flash_attn_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int causal_offset, float sm_scale,
    void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse; p.delta = delta;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
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
