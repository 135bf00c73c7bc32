// Flash-attention backward for Hopper (sm_90a), bf16 and fp32: dQ and dK/dV.
// Both kernels here serve head dim 128 and segment ids, in bf16 and in fp32;
// at head dim 32 or 64 without segment ids (every shape of the training
// paths) bf16 runs csrc/flash_attn_bwd_dq_sm90.cu and
// csrc/flash_attn_bwd_dkv_sm90.cu instead, which compute the same functions
// with wgmma, and fp32 csrc/flash_attn_bwd_dq_tf32x3.cu and
// csrc/flash_attn_bwd_dkv_tf32x3.cu, on the tensor cores as three TF32
// products per product; ops/attention.py::flash_kernels chooses, by dtype,
// head dim and masks only.
//
// Replaces two TPU kernels of the JAX package:
//   * video_tokenizer_tpu/ops/attention.py::_bwd_dq_kernel  (dQ), and
//   * video_tokenizer_tpu/ops/attention.py::_bwd_dkv_kernel (dK, dV per query head).
// Both recompute the probabilities from the forward's fp32 log-sum-exp
// instead of storing them: P = exp(s * scale - lse), dP = dO V^T,
// dS = P * (dP - delta) with delta = rowsum(O * dO) (computed by the caller),
// dQ = scale * dS K, dK = scale * dS^T Q, dV = P^T dO.
//
// Semantics (held against attention_bwd_reference in ops/attention.py, which
// equals autograd through attention_reference):
//   * masked pairs (causal, segment ids) carry no gradient to q or k: dS = 0
//     there. Their probability is 0, except in a query row that matches no
//     key at all: the forward gives that row the mean of V (every logit is the
//     same mask value), so it adds dO / Sk to dV of EVERY key. Such a row is
//     recognised by its LSE, which rounds to the mask value (-0.7 * FLT_MAX)
//     in fp32; exp(s - lse) cannot be used there (it would give 1, not 1/Sk).
//   * keys past Sk and queries past Sq do not exist (the discriminator's
//     S = 1025 leaves a partial last tile in both kernels): their tiles are
//     zero-filled in shared memory and masked.
//   * causal: query i sees key j iff i + causal_offset >= j. The dQ kernel
//     stops at the block's last visible key (masked pairs add nothing to dQ).
//     The dK/dV kernel starts at the first query tile that can see the block's
//     first key, but only where no query row is fully masked (no segments and
//     causal_offset >= 0, so every row sees key 0): a fully masked row adds to
//     every key's dV.
//   * GQA: query head h reads KV head h / (H / Hkv). dK/dV leave the kernel
//     per QUERY head ([B, Sk, H, D]); the caller sums each group, as the JAX
//     package does outside its kernel.
//   * bf16: P and dS are rounded to bf16 before their products (as the TPU
//     kernels round them to the operand dtype); every sum is fp32. fp32 (head
//     dim 128 or segment ids): all products are fp32 FMAs (one TF32 product
//     on the tensor cores would keep three decimal digits).
//   Outputs are contiguous: dQ [B, Sq, H, D], dK and dV [B, Sk, H, D], in the
//   input dtype. q, k, v and dO are read through element strides, so the
//   strided q/k/v views of a fused qkv projection need no copy.
//
// Layout: one block of 4 warps per (64-row tile, query head, batch row). The
// dQ kernel's tile is 64 queries and it streams 64-key K/V tiles; the dK/dV
// kernel's tile is 64 keys and it streams 64-query Q/dO tiles (with their LSE,
// delta and segment ids). Each warp owns 16 rows of the block's tile and
// holds its accumulators (dQ, or dK and dV) in registers in the mma C layout.
// Two warp-level products cover all five matmuls:
//   rows_dot_rows:    acc[r][c]  = sum_d A[r][d] B[c][d]   (S, dP; S^T, dP^T)
//   probs_times_rows: out[r][d] += sum_c P[r][c] B[c][d]   (dQ; dV, dK)
// With bf16 they run on the tensor cores with mma.sync.m16n8k16 (fp32
// accumulate), the score accumulator's registers serving directly as the A
// operand of the second product, as in csrc/flash_attn_fwd.cu (whose
// fragment helpers are repeated below).
//
// What bounds it: the backward does 2.5x the forward's flops (five S-sized
// products instead of two) over the same bytes, so it is bound by operations
// like the forward: tensor-core operations in bf16, fp32 FMAs on the CUDA
// cores in fp32. What this simple design leaves on the table for the shapes
// it still takes (head dim 128 and segment ids, on no training path): no
// wgmma or 3xTF32 products, no asynchronous tile ring (each tile load stalls
// the block), A fragments gathered from shared memory with 32-bit loads, expf
// instead of exp2 (what the tensor-core kernels do for their shapes); and S
// and dP are computed twice, once in each kernel (a fused kernel would add dQ
// with atomics instead).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // rows of the block's own tile, 16 per warp
constexpr int kBlockN = 64;  // rows of each streamed tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kNTiles = kBlockN / 8;  // 8-column tiles of a score tile
constexpr float kMaskValue = -0.7f * FLT_MAX;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  const int* q_seg;    // [B, Sq] or null
  const int* k_seg;    // [B, Sk] or null
  void* out0;          // dQ [B, Sq, H, D]; or dK [B, Sk, H, D]
  void* out1;          // null; or dV [B, Sk, H, D]
  int B, H, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO
  int causal, causal_offset;
  float sm_scale;
};

// Shared memory: four row tiles (the block's two, the streamed two), an fp32
// tile to publish P or dS with fp32 inputs, and three per-row vectors of the
// streamed tile (LSE, delta, segment ids). A 16-byte pad per row keeps the
// fragment loads free of bank conflicts.
template <typename T, int D>
struct Smem {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int kRow = D + kPad;
  static constexpr int kPRow = kBlockN + 4;
  static constexpr bool kIsBf16 = sizeof(T) == 2;
  static constexpr int kTile = kBlockM * kRow * (int)sizeof(T);  // kBlockM == kBlockN
  static constexpr int kP = kIsBf16 ? 0 : kBlockM * kPRow * (int)sizeof(float);
  static constexpr int kVec = kBlockN * (int)sizeof(float);
  static constexpr int kBytes = 4 * kTile + kP + 3 * kVec;
};

static_assert(kBlockM == kBlockN, "the four row tiles share one size");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(16x8 fp32) += A(16x16 bf16, row) * B(16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies rows [row0, row0 + kBlockN) of one head into shared memory in
// 16-byte chunks; rows past `len` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long row_stride,
                                          int row0, int len) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int c = threadIdx.x; c < kBlockN * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < len) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + cc * kVec);
    }
    *reinterpret_cast<uint4*>(dst + r * Smem<T, D>::kRow + cc * kVec) = val;
  }
}

// The mma C layout used for every accumulator: element e of column tile n is
// row warp * 16 + g + (e >> 1) * 8, column n * 8 + tig * 2 + (e & 1).

// acc[r][c] = sum_d A[r][d] * B[c][d] over this warp's 16 rows r of sA and
// the kBlockN rows c of sB.
template <typename T, int D>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[kNTiles][4], const T* sA,
                                              const T* sB, int warp, int g, int tig) {
  using S = Smem<T, D>;
#pragma unroll
  for (int n = 0; n < kNTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  if constexpr (S::kIsBf16) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = warp * 16 + g + (i & 1) * 8;
        const int col = ks * 16 + tig * 2 + (i >> 1) * 8;
        a[i] = *reinterpret_cast<const uint32_t*>(sA + row * S::kRow + col);
      }
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        const T* br = sB + (n * 8 + g) * S::kRow + ks * 16 + tig * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(br);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(br + 8);
        mma_bf16(acc[n], a, b0, b1);
      }
    }
  } else {
    const float* a0 = reinterpret_cast<const float*>(sA) + (warp * 16 + g) * S::kRow;
    const float* a1 = a0 + 8 * S::kRow;
    const float* b = reinterpret_cast<const float*>(sB);
    for (int d = 0; d < D; d += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0 + d);
      const float4 x1 = *reinterpret_cast<const float4*>(a1 + d);
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 y = *reinterpret_cast<const float4*>(b + (n * 8 + tig * 2 + j) * S::kRow + d);
          acc[n][j] = fmaf(x0.x, y.x, fmaf(x0.y, y.y, fmaf(x0.z, y.z, fmaf(x0.w, y.w, acc[n][j]))));
          acc[n][2 + j] =
              fmaf(x1.x, y.x, fmaf(x1.y, y.y, fmaf(x1.z, y.z, fmaf(x1.w, y.w, acc[n][2 + j]))));
        }
      }
    }
  }
}

// out[r][d] += sum_c P[r][c] * B[c][d]: P is this warp's 16 x kBlockN block
// in the C layout (rounded to bf16 with bf16 inputs), B the kBlockN rows of
// sB. With fp32 inputs P is published through the warp's rows of sP.
template <typename T, int D>
__device__ __forceinline__ void probs_times_rows(float (&out)[D / 8][4],
                                                 const float (&p)[kNTiles][4], const T* sB,
                                                 float* sP, int warp, int g, int tig) {
  using S = Smem<T, D>;
  if constexpr (S::kIsBf16) {
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(sB);
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      // two 8-column score tiles form one 16-column A fragment
      const uint32_t a[4] = {
          pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
          pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
          pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
      const int c = kk * 16 + tig * 2;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int d = n * 8 + g;
        const uint32_t b0 = pack_bf16(b[c * S::kRow + d], b[(c + 1) * S::kRow + d]);
        const uint32_t b1 = pack_bf16(b[(c + 8) * S::kRow + d], b[(c + 9) * S::kRow + d]);
        mma_bf16(out[n], a, b0, b1);
      }
    }
  } else {
    const int r0 = warp * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sP[(e >> 1 ? r1 : r0) * S::kPRow + n * 8 + tig * 2 + (e & 1)] = p[n][e];
    __syncwarp();
    const float* b = reinterpret_cast<const float*>(sB);
    for (int c = 0; c < kBlockN; ++c) {
      const float p0 = sP[r0 * S::kPRow + c];
      const float p1 = sP[r1 * S::kPRow + c];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(b + c * S::kRow + n * 8 + tig * 2);
        out[n][0] = fmaf(p0, y.x, out[n][0]);
        out[n][1] = fmaf(p0, y.y, out[n][1]);
        out[n][2] = fmaf(p1, y.x, out[n][2]);
        out[n][3] = fmaf(p1, y.y, out[n][3]);
      }
    }
    __syncwarp();  // sP is rewritten by the next product
  }
}

// Writes this warp's rows of an accumulator, times `scale`, to a contiguous
// [B, S, H, D] tensor (rows past S are not written).
template <typename T, int D>
__device__ __forceinline__ void store_rows(void* dst, const float (&acc)[D / 8][4], float scale,
                                           int b, int h, int H, int S, const int (&rows)[2],
                                           int tig) {
  T* base = static_cast<T*>(dst);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= S) continue;
    T* row = base + (((long long)b * S + rows[i]) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = acc[n][2 * i] * scale, x1 = acc[n][2 * i + 1] * scale;
      if constexpr (Smem<T, D>::kIsBf16) {
        *reinterpret_cast<uint32_t*>(row + n * 8 + tig * 2) = pack_bf16(x0, x1);
      } else {
        *reinterpret_cast<float2*>(row + n * 8 + tig * 2) = make_float2(x0, x1);
      }
    }
  }
}

// ---- dQ: one block per (64-query tile, head, batch row); streams K/V tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Params p) {
  using S = Smem<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = reinterpret_cast<T*>(smem + S::kTile);
  T* sK = reinterpret_cast<T*>(smem + 2 * S::kTile);
  T* sV = reinterpret_cast<T*>(smem + 3 * S::kTile);
  float* sP = reinterpret_cast<float*>(smem + 4 * S::kTile);
  int* sSeg = reinterpret_cast<int*>(smem + 4 * S::kTile + S::kP);

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int qr[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const bool has_seg = p.q_seg != nullptr;

  load_tile<T, D>(sQ, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.Sq);
  load_tile<T, D>(sO, static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh, p.o_ss, q0, p.Sq);
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  float lse[2], delta[2];
  int qseg[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = ((long long)b * p.H + h) * p.Sq + qr[i];
    lse[i] = qr[i] < p.Sq ? p.lse[at] : 0.f;
    delta[i] = qr[i] < p.Sq ? p.delta[at] : 0.f;
    if (has_seg && qr[i] < p.Sq) qseg[i] = p.q_seg[(long long)b * p.Sq + qr[i]];
  }

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  int num_tiles = (p.Sk + kBlockN - 1) / kBlockN;
  if (p.causal) {  // masked pairs add nothing to dQ: stop at the last visible key
    const int last_key = q0 + kBlockM - 1 + p.causal_offset;
    num_tiles = last_key < 0 ? 0 : min(num_tiles, last_key / kBlockN + 1);
  }

  for (int t = 0; t < num_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // the previous tile is no longer read
    load_tile<T, D>(sK, kb, p.k_ss, k0, p.Sk);
    load_tile<T, D>(sV, vb, p.v_ss, k0, p.Sk);
    if (has_seg && threadIdx.x < kBlockN) {
      const int key = k0 + threadIdx.x;
      sSeg[threadIdx.x] = key < p.Sk ? p.k_seg[(long long)b * p.Sk + key] : 0;
    }
    __syncthreads();

    float s[kNTiles][4], dp[kNTiles][4];
    rows_dot_rows<T, D>(s, sQ, sK, warp, g, tig);
    rows_dot_rows<T, D>(dp, sO, sV, warp, g, tig);
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + tig * 2 + (e & 1);
        const int key = k0 + col, i = e >> 1;
        bool keep = key < p.Sk;
        if (p.causal) keep = keep && qr[i] + p.causal_offset >= key;
        if (has_seg) keep = keep && qseg[i] == sSeg[col];
        s[n][e] = keep ? expf(s[n][e] * p.sm_scale - lse[i]) * (dp[n][e] - delta[i]) : 0.f;
      }
    }
    probs_times_rows<T, D>(dq, s, sK, sP, warp, g, tig);
  }
  store_rows<T, D>(p.out0, dq, p.sm_scale, b, h, p.H, p.Sq, qr, tig);
}

// ---- dK, dV: one block per (64-key tile, query head, batch row); streams
// Q/dO tiles. The warp's rows are keys, the score columns are queries.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Params p) {
  using S = Smem<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = reinterpret_cast<T*>(smem + S::kTile);
  T* sQ = reinterpret_cast<T*>(smem + 2 * S::kTile);
  T* sO = reinterpret_cast<T*>(smem + 3 * S::kTile);
  float* sP = reinterpret_cast<float*>(smem + 4 * S::kTile);
  float* sLse = reinterpret_cast<float*>(smem + 4 * S::kTile + S::kP);
  float* sDelta = sLse + kBlockN;
  int* sSeg = reinterpret_cast<int*>(sDelta + kBlockN);

  const int kt0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int kr[2] = {kt0 + warp * 16 + g, kt0 + warp * 16 + g + 8};
  const bool has_seg = p.q_seg != nullptr;

  load_tile<T, D>(sK, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss, kt0, p.Sk);
  load_tile<T, D>(sV, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, kt0, p.Sk);
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* ob = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* lse_row = p.lse + ((long long)b * p.H + h) * p.Sq;
  const float* delta_row = p.delta + ((long long)b * p.H + h) * p.Sq;

  int kseg[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (kr[i] < p.Sk) kseg[i] = p.k_seg[(long long)b * p.Sk + kr[i]];
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int num_tiles = (p.Sq + kBlockN - 1) / kBlockN;
  int start = 0;
  if (p.causal && !has_seg && p.causal_offset >= 0) {
    // no row is fully masked: query tiles wholly before this key tile's
    // causal frontier contribute nothing
    start = max(0, (kt0 - p.causal_offset) / kBlockN);
  }
  const float inv_sk = 1.f / p.Sk;

  for (int t = start; t < num_tiles; ++t) {
    const int qs = t * kBlockN;
    __syncthreads();  // the previous tile is no longer read
    load_tile<T, D>(sQ, qb, p.q_ss, qs, p.Sq);
    load_tile<T, D>(sO, ob, p.o_ss, qs, p.Sq);
    if (threadIdx.x < kBlockN) {
      const int qi = qs + threadIdx.x;
      const bool in = qi < p.Sq;
      sLse[threadIdx.x] = in ? lse_row[qi] : 0.f;
      sDelta[threadIdx.x] = in ? delta_row[qi] : 0.f;
      sSeg[threadIdx.x] = has_seg && in ? p.q_seg[(long long)b * p.Sq + qi] : 0;
    }
    __syncthreads();

    float s[kNTiles][4], dp[kNTiles][4];
    rows_dot_rows<T, D>(s, sK, sQ, warp, g, tig);   // S^T
    rows_dot_rows<T, D>(dp, sV, sO, warp, g, tig);  // dP^T
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + tig * 2 + (e & 1);
        const int qi = qs + col, i = e >> 1;
        float pe = 0.f, ds = 0.f;
        if (qi < p.Sq && kr[i] < p.Sk) {
          bool keep = true;
          if (p.causal) keep = qi + p.causal_offset >= kr[i];
          if (has_seg) keep = keep && sSeg[col] == kseg[i];
          const float lse = sLse[col];
          if (keep) {
            pe = expf(s[n][e] * p.sm_scale - lse);
            ds = pe * (dp[n][e] - sDelta[col]);
          } else if (lse < 0.5f * kMaskValue) {
            pe = inv_sk;  // a query that matches no key averages all of V
          }
        }
        s[n][e] = pe;
        dp[n][e] = ds;
      }
    }
    probs_times_rows<T, D>(dv, s, sO, sP, warp, g, tig);   // dV += P^T dO
    probs_times_rows<T, D>(dk, dp, sQ, sP, warp, g, tig);  // dK += dS^T Q
  }
  store_rows<T, D>(p.out0, dk, p.sm_scale, b, h, p.H, p.Sk, kr, tig);
  store_rows<T, D>(p.out1, dv, 1.f, b, h, p.H, p.Sk, kr, tig);
}

template <typename T, int D>
cudaError_t launch(const Params& p, bool dkv, cudaStream_t stream) {
  constexpr int bytes = Smem<T, D>::kBytes;
  auto kernel = dkv ? flash_bwd_dkv_kernel<T, D> : flash_bwd_dq_kernel<T, D>;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int rows = dkv ? p.Sk : p.Sq;
  const dim3 grid((rows + kBlockM - 1) / kBlockM, p.H, p.B);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int D, bool dkv, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, dkv, stream);
    case 64: return launch<T, 64>(p, dkv, stream);
    case 128: return launch<T, 128>(p, dkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One entry for both kernels: dkv = 0 launches the dQ kernel (dq into out0,
// out1 unused), dkv = 1 the dK/dV kernel (dk into out0, dv into out1).
extern "C" int vtt_flash_attn_bwd(
    int dkv, const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, const int* q_seg, const int* k_seg, void* out0, void* out1,
    int is_bf16, int B, int H, int Hkv, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int causal_offset, float sm_scale,
    void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.q_seg = q_seg; p.k_seg = k_seg; p.out0 = out0; p.out1 = out1;
  p.B = B; p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal; p.causal_offset = causal_offset; p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch_d<__nv_bfloat16>(p, D, dkv != 0, s)
                                  : dispatch_d<float>(p, D, dkv != 0, s);
  return static_cast<int>(err);
}
