// Per-row KV-cache row writes for speculative decoding, for Hopper (sm_90a).
//
// Replaces the TPU kernel video_tokenizer_tpu/ops/cache_update.py::
// _rows_kernel: writes G new K rows and G new V rows of each batch row b
// into a layer's [B, S, KV] caches at rows pos[b] + g, leaving every other
// byte of the caches as it was. `pos` is [B] int32, one per row, because
// speculative decoding advances rows unevenly. For an int8 cache the kernel
// also does what the JAX package leaves to XLA before its kernel: it
// quantises each row symmetrically (scale = max(amax / 127, 1e-8), q =
// clip(rint(x / scale), +-127), a true fp32 division and round-half-even, so
// the values equal the plain version's `_quantize_rows` bit for bit) and
// writes the row's fp32 scale into the [B, S] plane in the same launch. A
// row with pos[b] + g outside [0, S) is skipped, as a dropped scatter index.
// Held against write_rows_reference in ops/cache_update.py.
//
// Which paths launch it: those whose attention kernel does not write the
// rows itself, as ops/decode_attention.py::fuses_row_write decides: fp32
// caches (the fp32 parity decode and the fp32 greedy speculative run), fp32
// decode queries over any cache, and head dim 128. On bf16 and int8 caches at
// head dim 64 (every sampling path of the port) the rows are written inside
// decode_attn_sm90_kernel (csrc/decode_attention_sm90.cu) and
// chunk_attn_sm90_kernel (csrc/chunk_attention_sm90.cu), the same bytes.
//
// What bounds it: nothing but the launch. At the 632M prior's verify shape
// (B = 16, G = 5, KV = 1280, K and V) one call moves ~0.8 MB, well under a
// microsecond at 3.35 TB/s. The TPU kernel's 32-row aligned windows, its
// all-copies-in-flight DMA schedule and its select-based overwrite answer
// that compiler's alignment rules; on this card the work is a strided
// store: one block per (chunk token, batch row, K or V), one launch for
// both buffers. The new rows are read in place from strided views of the
// fused qkv projection (row strides given in elements), each element once:
// a thread keeps its slice of the row in registers between the amax pass and
// the quantising pass. `pos` is read on the device: no host scalar, no
// synchronisation, capturable in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;  // row elements a thread holds: KV <= 2048

struct Params {
  const void* rows[2];   // K and V rows [B, G, KV], strides (r_sb, r_sg, 1)
  void* cache[2];        // K and V caches [B, S, KV], contiguous
  float* scale[2];       // K and V row scales [B, S] (int8 caches) or null
  const int* pos;        // [B] cache row of chunk token 0
  int B, G, S, KV;
  long long r_sb, r_sg;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename TR, typename TC>
__global__ void __launch_bounds__(kThreads) write_rows_kernel(const Params p) {
  const int g = blockIdx.x, b = blockIdx.y, which = blockIdx.z;
  const int at = p.pos[b] + g;
  if (at < 0 || at >= p.S) return;
  const TR* src = static_cast<const TR*>(p.rows[which]) + b * p.r_sb + g * p.r_sg;
  const long long row = (long long)b * p.S + at;
  TC* dst = static_cast<TC*>(p.cache[which]) + row * p.KV;

  float x[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    x[i] = c < p.KV ? load(src + c) : 0.f;
  }
  if constexpr (sizeof(TC) == 1) {
    __shared__ float warp_max[kThreads / 32];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) amax = fmaxf(amax, fabsf(x[i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
    const float scale = fmaxf(amax / 127.0f, 1e-8f);
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < p.KV) {
        const float q = fminf(fmaxf(rintf(x[i] / scale), -127.f), 127.f);
        dst[c] = static_cast<int8_t>(q);
      }
    }
    if (threadIdx.x == 0) p.scale[which][row] = scale;
  } else {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < p.KV) store(dst + c, x[i]);
    }
  }
}

template <typename TR>
cudaError_t dispatch_cache(const Params& p, int cache_dtype, cudaStream_t stream) {
  const dim3 grid(p.G, p.B, 2);
  switch (cache_dtype) {
    case 0: write_rows_kernel<TR, float><<<grid, kThreads, 0, stream>>>(p); break;
    case 1: write_rows_kernel<TR, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(p); break;
    case 2: write_rows_kernel<TR, int8_t><<<grid, kThreads, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// cache_dtype: 0 fp32, 1 bf16, 2 int8 (then k_scale and v_scale are given).
extern "C" int vtt_write_rows(
    const void* rows_k, const void* rows_v, void* k_cache, void* v_cache, float* k_scale,
    float* v_scale, const int* pos, int cache_dtype, int rows_bf16, int B, int G, int S, int KV,
    long long r_sb, long long r_sg, void* stream) {
  if (KV < 1 || KV > kThreads * kPerThread ||
      (cache_dtype == 2) != (k_scale != nullptr && v_scale != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || G == 0) return 0;
  Params p;
  p.rows[0] = rows_k; p.rows[1] = rows_v; p.cache[0] = k_cache; p.cache[1] = v_cache;
  p.scale[0] = k_scale; p.scale[1] = v_scale; p.pos = pos;
  p.B = B; p.G = G; p.S = S; p.KV = KV; p.r_sb = r_sb; p.r_sg = r_sg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(rows_bf16 ? dispatch_cache<__nv_bfloat16>(p, cache_dtype, s)
                                    : dispatch_cache<float>(p, cache_dtype, s));
}
