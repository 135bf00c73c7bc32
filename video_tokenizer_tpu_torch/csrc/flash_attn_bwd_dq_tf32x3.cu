// Flash-attention backward, dQ, for Hopper (sm_90a), fp32, head dim 32 or 64,
// on the tensor cores: every product as three TF32 products ("3xTF32",
// csrc/sm90.cuh) with fp32 accumulation, and an asynchronous ring of K/V
// tiles.
//
// Replaces, for fp32 inputs without segment ids, the same TPU kernel as
// flash_bwd_dq_kernel in csrc/flash_attn_bwd.cu (which keeps D = 128 and
// segment ids):
//   * video_tokenizer_tpu/ops/attention.py::_bwd_dq_kernel.
// The semantics are those stated at the head of csrc/flash_attn_bwd.cu and
// held against attention_bwd_reference in ops/attention.py: P recomputed from
// the forward's natural-log LSE, dS = P (dP - delta), dQ = scale dS K; masked
// pairs carry nothing, also in a query row that sees no key (its forward is
// the mean of V, which does not depend on q: its dQ is 0); q, k, v, dO are
// read through strides, dQ is contiguous [B, Sq, H, D]. fp32 stays fp32: every
// product is lo.hi + hi.lo + hi.hi of the operands' TF32 parts
// (ops/attention.py::attention_bwd_dq_tf32x3_tiled_reference repeats the
// arithmetic), where one TF32 product would keep three decimal digits.
//
// What bounds it: three S-sized products per tile pair (S, dP, dQ) over the
// bytes of q, k, v, dO: operations, as three TF32 products per product
// against 494.7 TFLOP/s, a bound 2.5x below the 67 TFLOP/s of fp32 FMAs that
// csrc/flash_attn_bwd.cu is held to. That kernel ran the products as scalar
// FMA chains, one block of 4 warps per 64 rows, and stalled the block on every
// tile load. What the design does about it (csrc/flash_attn_fwd_tf32x3.cu
// with dP beside S and dS.K in place of P.V):
//   * mma.sync m16n8k8 tf32: a warp owns 16 query rows, a block 4 warps (64
//     rows), two blocks share an SM. The block's Q and dO tiles stay in
//     shared memory for the whole kernel (in registers, as the forward keeps
//     Q, the two would take 64 more a thread beside the accumulators dQ, S and
//     dP, and the kernel spilled at D = 64); each thread keeps the LSE and
//     delta of its two rows in registers;
//   * K and V tiles of 64 keys pass through a ring of kStages stages filled by
//     16-byte cp.async copies, one block barrier per tile;
//   * K is read both ways in one tile: along D for S = Q.K^T (V likewise for
//     dP = dO.V^T) and along the keys for dQ += dS.K. Both reads are 16 bytes
//     a thread and conflict-free in one layout (csrc/sm90.cuh::Fp32Tile), and
//     each K value is split into its parts where it is read, once per use;
//   * the inner index is permuted as in the forward: along D a thread's four
//     slots of two k-steps are four consecutive head-dim values; along the
//     keys slots tig and tig + 4 of k-step j are keys 8 j + 2 tig and
//     8 j + 2 tig + 1, the score accumulator's columns, so dS is the A operand
//     of dS.K without a shuffle; dQ's output columns are permuted (column g of
//     n-tile n is head-dim value (D / 8) g + n), so a thread reads D / 8
//     consecutive values of a K row;
//   * each tile's dS.K goes to an accumulator of its own, joined to dQ by a
//     rounded add: the tensor core does not round the sums it adds into an
//     accumulator to nearest, and over all 32 key tiles of a row at S = 2048
//     in one accumulator that error grows with Sk (the forward's P.V missed
//     the plain version by 2.2e-5 of max|out| that way, 3.4e-6 per tile);
//   * P = exp2 with log2(e) folded into the scale and into the LSE; only tiles
//     that need a mask (the causal diagonal, the ragged last tile) test
//     indices, and there masked pairs take no exponential (the mask value
//     times log2(e) overflows); causal blocks stop at their last visible key
//     (each warp its own) and start with the longest rows.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;    // [B, H, Sq], natural log
  const float* delta;  // [B, H, Sq]
  float* dq;           // [B, Sq, H, D], contiguous
  int B, H, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO
  int causal, causal_offset;
  float sm_scale;
};

// The tiling: kWarps warps of 16 query rows share kBlockN-key tiles in a ring
// of kStages stages; kMinBlocks blocks share an SM.
constexpr int kWarps = 4;
constexpr int kStages = 2;
constexpr int kMinBlocks = 2;
constexpr int kBlockN = 64;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = kWarps * 16;
constexpr int kAhead = kStages - 1;  // tiles in flight ahead of the one being read

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dq_tf32x3_kernel(const Params p) {
  using T = Fp32Tile<D>;
  constexpr int kNT = D / 8;         // 8-column n-tiles of dQ
  constexpr int kST = kBlockN / 8;   // 8-key score tiles = k-steps of dS.K
  constexpr int kQBytes = kBlockM * T::kRowBytes;    // the block's Q (and dO)
  constexpr int kTileBytes = kBlockN * T::kRowBytes;  // one K or V tile
  constexpr int kStageBytes = 2 * kTileBytes;         // K, then V

  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned char* sQ = smem;
  const unsigned char* sO = smem + kQBytes;
  unsigned char* ring = smem + 2 * kQBytes;

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

  const float* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vb = p.v + b * p.v_sb + hk * p.v_sh;

  int num_tiles = (p.Sk + kBlockN - 1) / kBlockN;
  int warp_tiles = num_tiles;  // tiles this warp multiplies
  if (p.causal) {  // masked pairs add nothing to dQ: stop at the last visible key
    const int last_key = q0 + kBlockM - 1 + p.causal_offset;
    num_tiles = last_key < 0 ? 0 : min(num_tiles, last_key / kBlockN + 1);
    const int w_last = w_row0 + 15 + p.causal_offset;
    warp_tiles = w_last < 0 ? 0 : min(num_tiles, w_last / kBlockN + 1);
  }

  auto load_kv = [&](int t) {
    const uint32_t stage = smem_addr(ring + (t % kStages) * kStageBytes);
    fp32_tile_load<D, kBlockN, kThreads>(stage, kb, p.k_ss, t * kBlockN, p.Sk);
    fp32_tile_load<D, kBlockN, kThreads>(stage + kTileBytes, vb, p.v_ss, t * kBlockN, p.Sk);
  };

  // prologue: Q, dO and the first kAhead tiles in flight, one commit group per tile
  fp32_tile_load<D, kBlockM, kThreads>(smem_addr(sQ), p.q + b * p.q_sb + h * p.q_sh, p.q_ss,
                                       q0, p.Sq);
  fp32_tile_load<D, kBlockM, kThreads>(smem_addr(sO), p.dout + b * p.o_sb + h * p.o_sh, p.o_ss,
                                       q0, p.Sq);
#pragma unroll
  for (int t = 0; t < kAhead; ++t) {
    if (t < num_tiles) load_kv(t);
    cp_async_commit();
  }

  // this thread's two rows: -LSE log2(e), delta (rows past Sq: P = 1, dS = 0)
  // and the last key the row may see
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

  float dq[kNT][4];  // row qr[e >> 1], head dim kNT (2 tig + (e & 1)) + n
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const float scale_log2 = p.sm_scale * kLog2e;

  for (int t = 0; t < num_tiles; ++t) {
    // tile t (with Q and dO before it) has landed: this thread's copies, then
    // everyone's after the barrier; the barrier also says that tile t - 1 is
    // no longer read, so its stage is refilled
    cp_async_wait<kAhead - 1>();
    __syncthreads();
    if (t + kAhead < num_tiles) load_kv(t + kAhead);
    cp_async_commit();
    if (t >= warp_tiles) continue;

    const unsigned char* sK = ring + (t % kStages) * kStageBytes;
    const unsigned char* sV = sK + kTileBytes;
    const int k0 = t * kBlockN;

    // ---- S = Q K^T and dP = dO V^T: row qr[e >> 1], key k0 + 8 n + 2 tig + (e & 1)
    float s[kST][4], dp[kST][4];
    tf32x3_rows_dot_rows<D, kBlockN>(s, sQ, warp * 16, sK, g, tig);
    tf32x3_rows_dot_rows<D, kBlockN>(dp, sO, warp * 16, sV, g, tig);

    // ---- dS = P (dP - delta), in place of S
    const bool masked_tile =
        k0 + kBlockN > p.Sk || (p.causal && k0 + kBlockN - 1 > w_row0 + p.causal_offset);
    if (masked_tile) {
      const int key0 = k0 + 2 * tig;
#pragma unroll
      for (int n = 0; n < kST; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          // no exponential for a masked pair: a row that sees no key has the
          // mask value as its LSE, which overflows under the folded scale
          s[n][e] = key0 + 8 * n + (e & 1) <= key_lim[r]
                        ? exp2_approx(fmaf(s[n][e], scale_log2, neg_lse[r])) * (dp[n][e] - delta[r])
                        : 0.f;
        }
    } else {
#pragma unroll
      for (int n = 0; n < kST; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          s[n][e] = exp2_approx(fmaf(s[n][e], scale_log2, neg_lse[r])) * (dp[n][e] - delta[r]);
        }
    }

    // ---- dQ += dS K, K read along the keys
    tf32x3_probs_times_rows<D, kBlockN>(dq, s, sK, g, tig);
  }
  cp_async_wait<0>();
  tf32x3_store_rows<D>(p.dq, dq, p.sm_scale, b, h, p.H, p.Sq, qr, tig);
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_tf32x3_kernel<D>;
  constexpr int kRow = Fp32Tile<D>::kRowBytes;
  constexpr int kSmemBytes = 2 * kBlockM * kRow + kStages * 2 * kBlockN * kRow;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockM - 1) / kBlockM, p.H, p.B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vtt_flash_attn_bwd_dq_tf32x3(
    const float* q, const float* k, const float* v, const float* dout, const float* lse,
    const float* delta, float* dq, int B, int H, int Hkv, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int causal_offset, float sm_scale,
    void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta; p.dq = dq;
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
