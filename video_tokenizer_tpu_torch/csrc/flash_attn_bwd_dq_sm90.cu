// Flash-attention backward, dQ, for Hopper (sm_90a), bf16, head dim 32 or 64,
// with warpgroup matrix products (wgmma) and an asynchronous ring of K/V
// tiles.
//
// Replaces, for bf16 inputs without segment ids, the same TPU kernel as
// flash_bwd_dq_kernel in csrc/flash_attn_bwd.cu (which keeps fp32, D = 128
// and segment ids):
//   * video_tokenizer_tpu/ops/attention.py::_bwd_dq_kernel.
// The semantics are those stated at the head of csrc/flash_attn_bwd.cu and
// held against attention_bwd_reference in ops/attention.py: P recomputed from
// the forward's natural-log LSE, dS = P (dP - delta), dQ = scale dS K; masked
// pairs carry nothing, also in a query row that sees no key (its forward is
// the mean of V, which does not depend on q: its dQ is 0); dS is rounded to
// bf16 before its product, every sum is fp32; q, k, v, dO are read through
// strides, dQ is contiguous [B, Sq, H, D].
//
// What bounds it: three S-sized products per tile pair (S, dP, dQ) over the
// bytes of q, k, v, dO: the tensor cores, at every shape of the training
// path, with one exponential and a few fp32 operations per score beside them.
// What the design does about it (csrc/flash_attn_bwd_dkv_sm90.cu with the
// roles turned):
//   * a block is one warpgroup that owns 64 query rows, and three blocks
//     share an SM (the three fp32 accumulators S, dP, dQ take 96 of a
//     thread's registers), so one block's products run while the others are
//     in their element-wise phase; Q and dO stay in shared memory for the
//     whole kernel, each thread keeps the LSE and delta of its two rows in
//     registers; K and V tiles of 64 keys pass through a ring of kStages
//     stages filled by cp.async into the 128-byte swizzled layout of
//     csrc/sm90.cuh, so a tile is loaded while earlier ones are multiplied;
//   * S = Q.K^T and dP = dO.V^T are wgmma m64n64k16 with both operands read
//     from shared memory by descriptor, started together; dS is formed in the
//     accumulators' registers (exp2 with log2(e) folded into the scale and
//     into the LSE), rounded to bf16, and is the register A operand of
//     dQ += dS.K with the same K tile read MN-major: nothing is transposed or
//     written back;
//   * only tiles that need a mask (the causal diagonal, ragged ends) pay for
//     index tests, and there the exponential is not taken for masked pairs,
//     so the mask value never meets the folded scale; causal blocks stop at
//     their last visible key (each warpgroup its own) and start with the
//     longest rows.
// What was measured against it and lost (PERF.md has the numbers): two
// warpgroups per block sharing the K/V tiles, two blocks per SM (the
// forward's shape; a few percent faster, but the cap of 128 registers spills),
// four blocks per SM with a 2-stage ring (spills too), two blocks of one
// warpgroup, and one block of two warpgroups per SM with a ring of 4 or 6
// (both slower). The tiling is therefore fixed in the constants below (kWG
// may be 1 or 2). What is left: S and dP are still computed twice (here and
// in the dK/dV kernel), no warp-specialised producer (TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
// The tiling: kWG warpgroups of 64 query rows share kBlockN-key tiles in a
// ring of kStages stages; kMinBlocks blocks share an SM.
constexpr int kWG = 1;
constexpr int kBlockN = 64;
constexpr int kStages = 3;
constexpr int kMinBlocks = 3;
constexpr int kThreads = kWG * 128;
constexpr int kBlockM = kWG * 64;
constexpr int kAhead = kStages - 1;  // tiles in flight ahead of the one being read
constexpr int kTileBytes = kBlockN * kRowBytes;   // one K or V tile
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kQBytes = kBlockM * kRowBytes;      // the block's Q (and dO) tile
// + kAtomBytes: the dynamic shared memory's start is aligned by hand
constexpr int kSmemBytes = 2 * kQBytes + kStages * kStageBytes + kAtomBytes;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // [B, H, Sq], natural log
  const float* delta;  // [B, H, Sq]
  __nv_bfloat16* dq;   // [B, Sq, H, D]
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
flash_bwd_dq_sm90_kernel(const Params p) {
  constexpr int kSRegs = kBlockN / 2;  // registers of a 64 x 64 accumulator
  constexpr int kDRegs = D / 2;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + kAtomBytes - 1) & ~(uint32_t)(kAtomBytes - 1);
  const uint32_t sO = sQ + kQBytes;
  const uint32_t sKV = sQ + 2 * kQBytes;

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

  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;

  int num_tiles = (p.Sk + kBlockN - 1) / kBlockN;
  int wg_tiles = num_tiles;  // tiles this warpgroup multiplies
  if (p.causal) {  // masked pairs add nothing to dQ: stop at the last visible key
    const int last_key = q0 + kBlockM - 1 + p.causal_offset;
    num_tiles = last_key < 0 ? 0 : min(num_tiles, last_key / kBlockN + 1);
    const int wg_last = wg_row0 + 63 + p.causal_offset;
    wg_tiles = wg_last < 0 ? 0 : min(num_tiles, wg_last / kBlockN + 1);
  }

  const RowTileLoader<D, kBlockN, kThreads> k_loader(kb, p.k_ss, p.Sk), v_loader(vb, p.v_ss, p.Sk);
  auto load_kv = [&](int t) {
    const uint32_t dst = sKV + (t % kStages) * kStageBytes;
    k_loader.load(dst, t * kBlockN);
    v_loader.load(dst + kTileBytes, t * kBlockN);
  };

  // prologue: Q and dO (rows past Sq zero-filled) with the first tile, then the
  // next kAhead - 1 tiles, one commit group per tile
  RowTileLoader<D, kBlockM, kThreads>(p.q + b * p.q_sb + h * p.q_sh, p.q_ss, p.Sq).load(sQ, q0);
  RowTileLoader<D, kBlockM, kThreads>(p.dout + b * p.o_sb + h * p.o_sh, p.o_ss, p.Sq).load(sO, q0);
#pragma unroll
  for (int t = 0; t < kAhead; ++t) {
    if (t < num_tiles) load_kv(t);
    cp_async_commit();
  }

  // this thread's two rows: -LSE log2(e), delta (rows past Sq: P = 1, dS = 0) and
  // the last key the row may see
  float neg_lse[2], delta[2];
  int key_lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qr[r] < p.Sq;
    const long long at = ((long long)b * p.H + h) * p.Sq + qr[r];
    neg_lse[r] = in ? -p.lse[at] * kLog2e : 0.f;
    delta[r] = in ? p.delta[at] : 0.f;
    key_lim[r] = p.causal ? min(p.Sk - 1, qr[r] + p.causal_offset) : p.Sk - 1;
  }

  float dq[kDRegs];
#pragma unroll
  for (int i = 0; i < kDRegs; ++i) dq[i] = 0.f;

  const float scale_log2 = p.sm_scale * kLog2e;
  const uint64_t desc_q = row_tile_desc(sQ + wg * 64 * kRowBytes);
  const uint64_t desc_do = row_tile_desc(sO + wg * 64 * kRowBytes);

  for (int t = 0; t < num_tiles; ++t) {
    // tile t has landed (this thread's copies), is published to the wgmma
    // proxy, and after the barrier every thread's copies have; the barrier
    // also says that the tiles before t are no longer read, so the oldest
    // stage is refilled
    cp_async_wait<kAhead - 1>();
    fence_async_proxy();
    __syncthreads();
    if (t + kAhead < num_tiles) load_kv(t + kAhead);
    cp_async_commit();
    if (t >= wg_tiles) continue;

    const int k0 = t * kBlockN;
    const uint32_t stage = sKV + (t % kStages) * kStageBytes;
    const uint64_t desc_k = row_tile_desc(stage);
    const uint64_t desc_v = row_tile_desc(stage + kTileBytes);

    // ---- S = Q K^T and dP = dO V^T (rows: queries, columns: keys)
    float s[kSRegs], dp[kSRegs];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(s, desc_q + ks * kStepKMajor, desc_k + ks * kStepKMajor, ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(dp, desc_do + ks * kStepKMajor, desc_v + ks * kStepKMajor, ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // ---- dS = P (dP - delta). d[i]: row qr[(i >> 1) & 1], key k0 + 8 (i / 4) + 2 tig + (i & 1)
    const bool masked_tile =
        k0 + kBlockN > p.Sk || (p.causal && k0 + kBlockN - 1 > wg_row0 + p.causal_offset);
    if (masked_tile) {
      const int key0 = k0 + 2 * tig;
#pragma unroll
      for (int i = 0; i < kSRegs; ++i) {
        const int r = (i >> 1) & 1;
        const bool keep = key0 + 8 * (i >> 2) + (i & 1) <= key_lim[r];
        // no exponential for a masked pair: a row that sees no key has the mask
        // value as its LSE, which overflows under the folded scale
        s[i] = keep ? exp2_approx(fmaf(s[i], scale_log2, neg_lse[r])) * (dp[i] - delta[r]) : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kSRegs; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = exp2_approx(fmaf(s[i], scale_log2, neg_lse[r])) * (dp[i] - delta[r]);
      }
    }

    // ---- dQ += dS K, dS from registers in bf16, K read MN-major
    uint32_t df[kBlockN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) df[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      wgmma_rs<1>(dq, df[kk], desc_k + kk * kStepMNMajor, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) fence_regs(df[kk]);
  }
  cp_async_wait<0>();

  // ---- epilogue: rows past Sq are not written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qr[r] >= p.Sq) continue;
    __nv_bfloat16* row = p.dq + (((long long)b * p.Sq + qr[r]) * p.H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int i = 4 * n + 2 * r;
      *reinterpret_cast<uint32_t*>(row + n * 8 + tig * 2) =
          pack_bf16(dq[i] * p.sm_scale, dq[i + 1] * p.sm_scale);
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_sm90_kernel<D>;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockM - 1) / kBlockM, p.H, p.B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vtt_flash_attn_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dq, int B, int H, int Hkv, int Sq, int Sk, int D,
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
  p.dq = static_cast<__nv_bfloat16*>(dq);
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
