// Weight-only int8 matrix product for Hopper (sm_90a) at more than 128 rows of
// bf16 x: y = (x @ w8) * scale on warpgroup matrix products (wgmma), the int8
// weights converted to bf16 on chip, once per block tile.
//
// Replaces, for bf16 x with M > 128 and K a multiple of 64 (every projection
// of the 632M prior and its draft at the NLL forward and at long prefills),
// the same TPU kernel as csrc/w8_matmul.cu and csrc/w8_matmul_stream.cu:
//   * video_tokenizer_tpu/ops/quant_matmul.py::_w8_kernel.
// The function is that of csrc/w8_matmul.cu, held against
// w8_matmul_reference in ops/quant_matmul.py: each int8 weight becomes bf16
// exactly, the product accumulates in fp32, the per-output-channel fp32 scale
// is applied in the epilogue, single rounding (the TPU kernel's,
// bf16(acc * scale)) or double rounding (the JAX package's QuantDense,
// bf16(bf16(acc) * bf16(scale))). x [M, K] bf16, the weight [N, K] int8
// (torch's [out, in] layout), scale [N] fp32, y [M, N] bf16, all contiguous.
// ops/quant_matmul.py::w8_kernel chooses between the three kernels, by M, K
// and x's dtype only; w8_matmul_sm90_tiled_reference repeats this kernel's
// order of summation.
//
// What bounds it: at the NLL forward (M = 8192 rows, K x N up to 3584 x 1280
// and 1280 x 8192) a product does 2 M = 16384 flops per weight byte:
// operations, 0.081 ms for wqkv at 989 TFLOP/s. The earlier kernel
// (csrc/w8_matmul.cu) ran 64 x 32 tiles of mma.sync and re-read x and w from L2
// for every one of them (0.76 ms for wqkv); cuBLAS on a bf16 copy of the
// weights, which eager PyTorch would have to write first, took 0.27.
// The design (layout (i) of the two: both operands from shared memory):
//   * a block owns a 128 x 256 tile of y: two warpgroups of 64 rows, each
//     issuing wgmma m64n128k16 twice per 16-deep step, A (x) and B (the
//     converted weights) K-major from 128-byte-swizzled row tiles (the flash
//     kernels' layout, csrc/sm90.cuh);
//   * one thread asks the Tensor Memory Accelerator for x's [128, 64] tile
//     (128-byte swizzle: it lands as a row tile) and the weights' [256, 64]
//     int8 tile (as stored), kAhead steps ahead, into a ring of kStages
//     stages; each stage's mbarrier completes when both tiles' bytes are in.
//     Rows past M and channels past N arrive as zeros. Copied by cp.async (16
//     bytes a thread) the same tiles took 0.17 ms for wqkv with no product and
//     no conversion at all: the loads held the whole kernel (PERF.md);
//   * at each 64-deep step every thread converts 4 x 16 int8 weights of the
//     landed tile into a bf16 row tile (exactly: the byte in the mantissa of
//     2^23, int8_pair_to_bf16) while the previous step's products run, so the
//     conversion is paid once per block tile and no bf16 copy of the weights
//     ever reaches global memory. Two barriers per step: one before the
//     conversion (the stage has landed, the products two steps back are done,
//     so their stages can be refilled), one after it (the bf16 tile is
//     complete and published to wgmma);
//   * the epilogue stages the bf16 tile in shared memory (rows padded by 16
//     bytes, so the fragment writes hit every bank once) and writes it out in
//     16-byte stores along rows: written from the fragments in 4-byte pieces
//     the output took a fifth of the kernel's time;
//   * the other layout, W as the register A operand converted in registers
//     and x as B (y transposed), would save the converted tile's store, but a
//     thread's A fragment holds K indices 2 tig, 2 tig + 1, 2 tig + 8, 2 tig +
//     9 of each step, so x's K order in shared memory would have to follow in
//     4-byte pieces: a tile copy could not fill it;
//   * blocks run along N fastest, so the blocks of one x row tile are resident
//     together and the weights (at most 9.4 MB) stay in the 50 MB L2.
// K must be a multiple of 64 (the wrapper sends other K to csrc/w8_matmul.cu).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

// The tiling: kBlockM x kBlockN outputs a block, 64-deep steps, a ring of
// kStages stages of which kAhead are in flight ahead of the one converted.
constexpr int kBlockM = 128;
constexpr int kBlockN = 256;
constexpr int kStages = 4;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // two warpgroups of 64 x rows
constexpr int kAhead = kStages - 2;
constexpr int kHalves = kBlockN / 128;  // m64n128 products per warpgroup and step

constexpr int kXBytes = kBlockM * kRowBytes;  // x: one row tile of 64 bf16 a row
constexpr int kW8Bytes = kBlockN * kBlockK;   // int8 weights as stored: 64 bytes a row
constexpr int kWBytes = kBlockN * kRowBytes;  // bf16 weights: one row tile
constexpr int kOutRow = kBlockN * 2 + 16;     // a staged output row, padded
// + kAtomBytes: the dynamic shared memory's start is aligned by hand; then
// the stages' mbarriers
constexpr int kSmemBytes = kStages * (kXBytes + kW8Bytes) + 2 * kWBytes + kAtomBytes + 8 * kStages;
static_assert(kXBytes % kAtomBytes == 0 && kW8Bytes % kAtomBytes == 0, "row tiles align");
static_assert(kBlockM * kOutRow <= kStages * (kXBytes + kW8Bytes), "the output tile fits the ring");

__global__ void __launch_bounds__(kThreads, 1)
w8_sm90_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
               const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M, int N,
               int K, int double_round) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + kAtomBytes - 1) & ~(uint32_t)(kAtomBytes - 1);
  unsigned char* const smem = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t sX = base;                              // kStages x tiles
  const uint32_t sW8 = sX + kStages * kXBytes;           // kStages int8 weight tiles
  const uint32_t sW = sW8 + kStages * kW8Bytes;          // 2 bf16 weight tiles
  const uint32_t sBar = sW + 2 * kWBytes;                // kStages mbarriers
  const unsigned char* w8_tiles = smem + kStages * kXBytes;
  unsigned char* w_tiles = smem + kStages * (kXBytes + kW8Bytes);

  const int n0 = blockIdx.x * kBlockN, m0 = blockIdx.y * kBlockM;
  const int wg = threadIdx.x / 128;
  const int steps = K / kBlockK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(sBar + 8 * i, 1);
    fence_mbar_init();
  }
  __syncthreads();

  // thread 0: step s's x rows [m0, m0 + 128) and weight rows [n0, n0 + 256)
  // of K [64 s, 64 s + 64) into stage s % kStages
  auto load = [&](int s) {
    const int st = s % kStages;
    const uint32_t bar = sBar + 8 * st;
    mbar_arrive_expect_tx(bar, kXBytes + kW8Bytes);
    tma_load_2d(sX + st * kXBytes, &x_map, s * kBlockK, m0, bar);
    tma_load_2d(sW8 + st * kW8Bytes, &w_map, s * kBlockK, n0, bar);
  };

  // accumulator of half hh: row 64 wg + 16 warp + g + 8 ((i / 2) % 2),
  // column 128 hh + 8 (i / 4) + 2 tig + (i % 2) of the block's tile
  float acc[kHalves][64];
#pragma unroll
  for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[hh][i] = 0.f;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kAhead && s < steps; ++s) load(s);
  }

  for (int s = 0; s < steps; ++s) {
    // (A) step s has landed; every warpgroup has waited for its products of
    // step s - 2, the last reader of bf16 tile s % 2 and of the stage that
    // the next copies refill
    mbar_wait(sBar + 8 * (s % kStages), (s / kStages) & 1);
    __syncthreads();
    if (threadIdx.x == 0 && s + kAhead < steps) load(s + kAhead);

    // the int8 tile -> a bf16 row tile, exactly: 16 weights of one row a chunk
    const unsigned char* w8 = w8_tiles + (s % kStages) * kW8Bytes;
    unsigned char* wt = w_tiles + (s % 2) * kWBytes;
#pragma unroll
    for (int it = 0; it < kBlockN * 4 / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads, r = i / 4, c = i % 4;
      const uint4 v = *reinterpret_cast<const uint4*>(w8 + r * kBlockK + c * 16);
      const uint32_t words[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                                 v.w ^ 0x80808080u};
      uint32_t pairs[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pairs[2 * j] = int8_pair_to_bf16(words[j], 0, words[j], 1);
        pairs[2 * j + 1] = int8_pair_to_bf16(words[j], 2, words[j], 3);
      }
      *reinterpret_cast<uint4*>(wt + swizzled(r, 2 * c)) =
          make_uint4(pairs[0], pairs[1], pairs[2], pairs[3]);
      *reinterpret_cast<uint4*>(wt + swizzled(r, 2 * c + 1)) =
          make_uint4(pairs[4], pairs[5], pairs[6], pairs[7]);
    }
    // (B) the bf16 tile is complete and published to the asynchronous proxy
    // through which wgmma reads it (x's tile came through that proxy)
    fence_async_proxy();
    __syncthreads();

    const uint64_t desc_x = row_tile_desc(sX + (s % kStages) * kXBytes + wg * 64 * kRowBytes);
    const uint64_t desc_w = row_tile_desc(sW + (s % 2) * kWBytes);
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) fence_regs(acc[hh]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBlockK / 16; ++ks)
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh)
        wgmma_ss(acc[hh], desc_x + ks * kStepKMajor,
                 desc_w + hh * ((128 * kRowBytes) >> 4) + ks * kStepKMajor, 1);
    wgmma_commit();
    wgmma_wait<1>();  // the products of step s - 1 are done
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) fence_regs(acc[hh]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int hh = 0; hh < kHalves; ++hh) fence_regs(acc[hh]);

  // ---- epilogue: the scale, one or two roundings, into the staged tile (the
  // ring, free now); then out in 16-byte stores along rows, rows past M and
  // channels past N left alone
  __syncthreads();  // every thread is past its last read of the ring
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int col = 128 * hh + 8 * q + 2 * tig;
      const int n = min(n0 + col, N - 1);
      const float s0 = scale[n], s1 = scale[min(n + 1, N - 1)];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 64 * wg + 16 * warp + g + 8 * half;
        const float a0 = acc[hh][4 * q + 2 * half], a1 = acc[hh][4 * q + 2 * half + 1];
        float y0, y1;
        if (double_round) {
          y0 = __bfloat162float(__float2bfloat16(a0)) * __bfloat162float(__float2bfloat16(s0));
          y1 = __bfloat162float(__float2bfloat16(a1)) * __bfloat162float(__float2bfloat16(s1));
        } else {
          y0 = a0 * s0;
          y1 = a1 * s1;
        }
        *reinterpret_cast<uint32_t*>(smem + row * kOutRow + col * 2) = pack_bf16(y0, y1);
      }
    }
  __syncthreads();
  const bool vec = N % 8 == 0;  // 16-byte stores need 16-byte aligned rows
  constexpr int kChunks = kBlockN / 8;
  for (int i = threadIdx.x; i < kBlockM * kChunks; i += kThreads) {
    const int row = i / kChunks, c = i % kChunks;
    const int m = m0 + row, n = n0 + 8 * c;
    if (m >= M || n >= N) continue;
    const unsigned char* src = smem + row * kOutRow + c * 16;
    __nv_bfloat16* dst = out + (long long)m * N + n;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && n + j < N; ++j) dst[j] = reinterpret_cast<const __nv_bfloat16*>(src)[j];
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime (the
// library links no libcuda of its own)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A row-major [rows, K] matrix of `elem_bytes`-byte elements, in boxes of
// [box_rows, 64 elements]
bool encode(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr, int K,
            int rows, int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)kBlockK, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x [M, K] bf16, w [N, K] int8, scale [N] fp32, out [M, N] bf16; all
// contiguous, 16-byte aligned, K a multiple of 64.
extern "C" int vtt_w8_matmul_sm90(const void* x, const int8_t* w, const float* scale, void* out,
                                  int M, int N, int K, int double_round, void* stream) {
  if (M < 0 || N < 1 || K < kBlockK || K % kBlockK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  CUtensorMap x_map, w_map;
  if (!encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, kBlockM,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, N, kBlockN,
              CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(w8_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kBlockM - 1) / kBlockM);
  w8_sm90_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x_map, w_map, scale, static_cast<__nv_bfloat16*>(out), M, N, K, double_round);
  return static_cast<int>(cudaGetLastError());
}
