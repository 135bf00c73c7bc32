// Weight-only int8 matrix product for Hopper (sm_90a): y = (x @ w8) * scale.
//
// Replaces the TPU kernel video_tokenizer_tpu/ops/quant_matmul.py::_w8_kernel:
// each int8 weight is converted to bf16 (exact), the product accumulates in
// fp32, and the per-output-channel fp32 scale is applied in the epilogue. A
// bf16 x is used as it is (the TPU kernel's product). An fp32 x is split into
// three bf16 parts whose sum is x exactly (hi + mid + lo, 8 significant bits
// each), so its product is the fp32 one of the JAX package's QuantDense, an
// fp32 dot, and not the TPU kernel's, which rounds x to bf16. Two epilogues:
//   * single rounding (the TPU kernel's): y = dtype(acc * scale);
//   * double rounding (the JAX package's QuantDense, models/larp_ar.py:118-122):
//     y = dtype(dtype(acc) * dtype(scale)).
// The output has x's dtype (bf16 or fp32). The weight is stored [N, K]
// (torch's [out, in] layout), so each output channel's K weights are
// contiguous. Held against w8_matmul_reference in ops/quant_matmul.py.
//
// What bounds it: at the 632M prior's decode shape (M = 16 rows, K x N up to
// 1280 x 8192) the product does 2 * M = 32 flops per weight byte, so it is
// bound by streaming the int8 weights: ~0.63 GB per decode step for all 151
// projections. The point of the kernel is that those bytes are read ONCE, as
// int8, and converted in registers: eager PyTorch's `x @ w8.to(bf16)` would
// write and read a bf16 copy of every weight on every call (~5 bytes per
// weight instead of 1). At the prefill/NLL shape (M = 8192) it is a
// tensor-core GEMM.
//
// Design: mma.sync m16n8k16 bf16 with fp32 accumulation. Each warp owns an
// (MT x 16) x (NT x 8) output tile and a share of K; the block's warps split K
// and sum their tiles through shared memory at the end, so that even a
// 16-row product has enough warps in flight to stream the weights. Every
// global load is 16 bytes: a thread loads 16 consecutive int8 weights of one
// output channel, and its four k16 steps use them in a permuted K order that
// the A operand follows (a dot product does not depend on the order of its
// terms), so neither operand needs a shared-memory transpose. What it leaves
// on the table: no wgmma/TMA, no cp.async pipelining, and at M = 8192 each
// block re-reads its x and w tiles from L2 instead of sharing them through
// shared memory. An fp32 x costs three mma per tile instead of one, which the
// decode shapes, bound by the weight stream, hide.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunkK = 64;  // K per warp step: 16 int8 per thread x 4 threads

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two int8 (bytes `byte` and `byte` + 1 of word) -> a bf16 pair, exactly
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t word, int byte) {
  const int8_t lo = static_cast<int8_t>((word >> (8 * byte)) & 0xff);
  const int8_t hi = static_cast<int8_t>((word >> (8 * byte + 8)) & 0xff);
  return pack_bf16(static_cast<float>(lo), static_cast<float>(hi));
}

// D(16x8 fp32) += A(16x16 bf16, row) * B(16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// bf16 parts of x: one for a bf16 x, three (hi, mid, lo) for an fp32 x
template <typename TX>
constexpr int kParts = sizeof(TX) == 2 ? 1 : 3;

// Four consecutive elements x[r, k .. k+3] as NP parts, each two bf16 pairs,
// whose sum is x exactly: each part is the bf16 rounding of what the parts
// before it left over. Zero past M or K.
template <typename TX, int NP>
__device__ __forceinline__ void load_x4(const TX* x, int M, int K, int r, int k, bool vec,
                                        uint2 (&parts)[NP]) {
  float f[4] = {0.f, 0.f, 0.f, 0.f};
  if (r < M) {
    const TX* src = x + (long long)r * K + k;
    if (vec && k + 4 <= K) {
      if constexpr (sizeof(TX) == 2) {
        parts[0] = *reinterpret_cast<const uint2*>(src);
        return;
      } else {
        const float4 v = *reinterpret_cast<const float4*>(src);
        f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = k + j < K ? to_float(src[j]) : 0.f;
    }
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
    parts[p] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                          *reinterpret_cast<const uint32_t*>(&hi));
    f[0] -= __low2float(lo), f[1] -= __high2float(lo);  // exact in fp32
    f[2] -= __low2float(hi), f[3] -= __high2float(hi);
  }
}

// Sixteen consecutive weights w[n, k .. k+15]; zero past N or K.
__device__ __forceinline__ uint4 load_w16(const int8_t* w, int N, int K, int n, int k, bool vec) {
  if (n >= N) return make_uint4(0, 0, 0, 0);
  const int8_t* src = w + (long long)n * K + k;
  if (vec && k + 16 <= K) return *reinterpret_cast<const uint4*>(src);
  uint32_t words[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (k + j < K) words[j / 4] |= (static_cast<uint32_t>(static_cast<uint8_t>(src[j]))) << (8 * (j % 4));
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

template <typename TX, int MT, int NT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
w8_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, TX* __restrict__ out, int M, int N, int K,
                 int double_round) {
  constexpr int kTileM = MT * 16, kTileN = NT * 8, NP = kParts<TX>;
  __shared__ float red[WARPS][kTileM][kTileN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  // 16-byte weight loads need 16-byte aligned rows; x rows the same in bytes
  const bool vec = K % 16 == 0;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int kc = warp * kChunkK; kc < K; kc += WARPS * kChunkK) {
    // this thread's 16 weights of channel n0 + nt*8 + g, at k = kc + tig*16
    uint4 wv[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) wv[nt] = load_w16(w, N, K, n0 + nt * 8 + g, kc + tig * 16, vec);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // The thread's mma k slots {2 tig, 2 tig + 1} hold k = kk, kk + 1 and
      // slots {2 tig + 8, 2 tig + 9} hold k = kk + 2, kk + 3, in A and B alike.
      const int kk = kc + tig * 16 + s * 4;
      uint32_t a[MT][NP][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = m0 + mt * 16 + g;
        uint2 lo[NP], hi[NP];
        load_x4<TX, NP>(x, M, K, r0, kk, vec, lo);
        load_x4<TX, NP>(x, M, K, r0 + 8, kk, vec, hi);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          a[mt][p][0] = lo[p].x;
          a[mt][p][1] = hi[p].x;
          a[mt][p][2] = lo[p].y;
          a[mt][p][3] = hi[p].y;
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t word = s == 0 ? wv[nt].x : s == 1 ? wv[nt].y : s == 2 ? wv[nt].z : wv[nt].w;
        const uint32_t b0 = i8x2_to_bf16x2(word, 0), b1 = i8x2_to_bf16x2(word, 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int p = 0; p < NP; ++p) mma_bf16(acc[mt][nt], a[mt][p], b0, b1);
      }
    }
  }

  // sum the warps' K shares; C layout: element e of a tile is row g + 8 (e >> 1),
  // column 2 tig + (e & 1)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[warp][mt * 16 + g + (e >> 1) * 8][nt * 8 + tig * 2 + (e & 1)] = acc[mt][nt][e];
  __syncthreads();
  for (int i = threadIdx.x; i < kTileM * kTileN; i += WARPS * 32) {
    const int r = i / kTileN, c = i % kTileN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float y = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) y += red[wi][r][c];
    TX* dst = out + (long long)m * N + n;
    if constexpr (sizeof(TX) == 2) {
      if (double_round) {
        const float yr = __bfloat162float(__float2bfloat16(y));
        const float sr = __bfloat162float(__float2bfloat16(scale[n]));
        *dst = __float2bfloat16(yr * sr);
      } else {
        *dst = __float2bfloat16(y * scale[n]);
      }
    } else {
      *dst = y * scale[n];  // fp32: both epilogues are one fp32 product
    }
  }
}

template <typename TX, int MT, int NT, int WARPS>
cudaError_t launch(const void* x, const int8_t* w, const float* scale, void* out, int M, int N,
                   int K, int double_round, cudaStream_t stream) {
  const dim3 grid((N + NT * 8 - 1) / (NT * 8), (M + MT * 16 - 1) / (MT * 16));
  w8_matmul_kernel<TX, MT, NT, WARPS><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const TX*>(x), w, scale, static_cast<TX*>(out), M, N, K, double_round);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_m(const void* x, const int8_t* w, const float* scale, void* out, int M,
                       int N, int K, int double_round, cudaStream_t stream) {
  // decode rows: one m16 tile, 16 channels and 8 K-splitting warps per block;
  // prefill/NLL rows: 64 x 32 tiles over 4 warps
  if (M <= 16) return launch<TX, 1, 2, 8>(x, w, scale, out, M, N, K, double_round, stream);
  return launch<TX, 4, 4, 4>(x, w, scale, out, M, N, K, double_round, stream);
}

}  // namespace

// x [M, K] (bf16 if x_bf16, else fp32), w [N, K] int8, scale [N] fp32,
// out [M, N] in x's dtype; all contiguous.
extern "C" int vtt_w8_matmul(const void* x, const int8_t* w, const float* scale, void* out,
                             int x_bf16, int M, int N, int K, int double_round, void* stream) {
  if (M < 0 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_bf16 ? dispatch_m<__nv_bfloat16>(x, w, scale, out, M, N, K, double_round, s)
             : dispatch_m<float>(x, w, scale, out, M, N, K, double_round, s);
  return static_cast<int>(err);
}
