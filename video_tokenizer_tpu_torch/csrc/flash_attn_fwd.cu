// Flash-attention forward for Hopper (sm_90a), bf16 and fp32.
//
// Replaces two TPU kernels of the JAX package:
//   * video_tokenizer_tpu/ops/attention.py::_fwd_kernel_packed (the inference
//     forward on the projection's native [B, S, H*D] layout), and
//   * video_tokenizer_tpu/ops/attention.py::_fwd_kernel (the [B, H, S, D]
//     forward that also writes the fp32 log-sum-exp of every row).
// One kernel covers both: it reads q/k/v through element strides, so the
// strided q/k/v views of a [B, S, 3, H, D] qkv projection are read in place
// (no relayout copy, which is what the packed TPU kernel exists for), and it
// writes the LSE only when asked.
//
// Semantics (held against attention_reference in ops/attention.py):
//   s = (q . k) * sm_scale in fp32; masked pairs get -0.7 * FLT_MAX (not
//   -inf), so a query row that matches no key attends uniformly over all Sk
//   keys; keys past Sk do not exist. Masks: causal (q_pos + causal_offset >=
//   k_pos), segment-id equality. GQA: head h reads KV head h / (H / Hkv).
//   Online softmax with fp32 running max, sum and accumulator. With bf16
//   inputs the probabilities are rounded to bf16 for the P.V product, as the
//   TPU kernel does. Output [B, Sq, H, D] in the input dtype; LSE [B, H, Sq].
//
// Layout: one block of 4 warps per (64-row query tile, head, batch row). Each
// warp owns 16 query rows. Key/value tiles of 64 rows pass through shared
// memory. With bf16 the two products run on the tensor cores with
// mma.sync.m16n8k16 (fp32 accumulate); the score accumulator's register
// layout is reused directly as the A operand of the P.V product, so P never
// leaves registers. With fp32 the products are fp32 FMAs on the CUDA cores
// (tensor cores would round to TF32), over the same register layout.
//
// What bounds it: at the flagship shape (S = 2048, D = 64, 12 heads) attention
// does 4 * S^2 * D flops per (batch row, head) against 4 * S * D * 2 bytes of
// q/k/v/o, i.e. ~1000 flops per byte: compute-bound on this card. What this
// simple design leaves on the table: no wgmma (mma.sync reaches a fraction of
// the dense bf16 rate), no TMA or cp.async double-buffering (each tile load
// stalls the block), V fragments are gathered with 16-bit shared loads
// instead of ldmatrix.trans, expf instead of exp2f with a folded log2(e), and
// no warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // query rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kNTiles = kBlockN / 8;  // 8-key column tiles of the score tile
constexpr float kMaskValue = -0.7f * FLT_MAX;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_seg;  // [B, Sq] or null
  const int* k_seg;  // [B, Sk] or null
  void* out;         // [B, Sq, H, D], contiguous
  float* lse;        // [B, H, Sq] or null
  int B, H, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, causal_offset;
  float sm_scale;
};

// Shared-memory row strides (elements): a 16-byte pad per row keeps the
// fragment loads free of bank conflicts.
template <typename T, int D>
struct Smem {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int kRow = D + kPad;
  static constexpr int kPRow = kBlockN + 4;  // fp32 probability tile
  static constexpr bool kIsBf16 = sizeof(T) == 2;
  // bf16: K, V tiles.  fp32: Q tile, K, V tiles, P tile.
  static constexpr int kQ = kIsBf16 ? 0 : kBlockM * kRow * (int)sizeof(T);
  static constexpr int kKV = kBlockN * kRow * (int)sizeof(T);
  static constexpr int kP = kIsBf16 ? 0 : kBlockM * kPRow * (int)sizeof(float);
  static constexpr int kSeg = kBlockN * (int)sizeof(int);
  static constexpr int kBytes = kQ + 2 * kKV + kP + kSeg;
};

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

// Copies rows [row0, row0 + kBlockN) of one head of k or v into shared
// memory in 16-byte chunks; rows past `len` are zero-filled so that their
// (zero-probability) products stay finite.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long row_stride,
                                          int row0, int len, int count) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int c = threadIdx.x; c < count * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < len) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + cc * kVec);
    }
    *reinterpret_cast<uint4*>(dst + r * Smem<T, D>::kRow + cc * kVec) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  using S = Smem<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = reinterpret_cast<T*>(smem + S::kQ);
  T* sV = reinterpret_cast<T*>(smem + S::kQ + S::kKV);
  float* sP = reinterpret_cast<float*>(smem + S::kQ + 2 * S::kKV);
  int* sSeg = reinterpret_cast<int*>(smem + S::kQ + 2 * S::kKV + S::kP);

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  // this thread's two query rows within the block tile (and globally)
  const int lr[2] = {warp * 16 + g, warp * 16 + g + 8};
  const int qr[2] = {q0 + lr[0], q0 + lr[1]};

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const bool has_seg = p.q_seg != nullptr;

  int qseg[2] = {0, 0};
  if (has_seg) {
    for (int i = 0; i < 2; ++i)
      qseg[i] = qr[i] < p.Sq ? p.q_seg[(long long)b * p.Sq + qr[i]] : 0;
  }

  // bf16: this warp's 16 query rows as mma A fragments, loaded once.
  uint32_t qf[S::kIsBf16 ? D / 16 : 1][4];
  if constexpr (S::kIsBf16) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = qr[i & 1];
        const int col = ks * 16 + tig * 2 + (i >> 1) * 8;
        qf[ks][i] = row < p.Sq
                        ? *reinterpret_cast<const uint32_t*>(qb + (long long)row * p.q_ss + col)
                        : 0u;
      }
    }
  } else {
    load_tile<T, D>(sQ, qb, p.q_ss, q0, p.Sq, kBlockM);
  }

  // Score tile and output accumulator in the mma C layout: element e of
  // column tile n is row lr[e >> 1], column n * 8 + tig * 2 + (e & 1).
  float s[kNTiles][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  int num_tiles = (p.Sk + kBlockN - 1) / kBlockN;
  // Causal: skip key tiles past the block's last visible key. Only where
  // every row of the block sees key 0, so that no fully masked row (which
  // attends uniformly over ALL keys) loses keys it should average over.
  if (p.causal && !has_seg && q0 + p.causal_offset >= 0) {
    const int last_key = q0 + kBlockM - 1 + p.causal_offset;
    num_tiles = min(num_tiles, last_key / kBlockN + 1);
  }

  for (int t = 0; t < num_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // the previous tile is no longer read
    load_tile<T, D>(sK, kb, p.k_ss, k0, p.Sk, kBlockN);
    load_tile<T, D>(sV, vb, p.v_ss, k0, p.Sk, kBlockN);
    if (has_seg && threadIdx.x < kBlockN) {
      const int key = k0 + threadIdx.x;
      sSeg[threadIdx.x] = key < p.Sk ? p.k_seg[(long long)b * p.Sk + key] : 0;
    }
    __syncthreads();

    // ---- S = Q K^T
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (S::kIsBf16) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
        for (int n = 0; n < kNTiles; ++n) {
          const T* kr = sK + (n * 8 + g) * S::kRow + ks * 16 + tig * 2;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
          mma_bf16(s[n], qf[ks], b0, b1);
        }
      }
    } else {
      const float* q0p = reinterpret_cast<const float*>(sQ) + lr[0] * S::kRow;
      const float* q1p = reinterpret_cast<const float*>(sQ) + lr[1] * S::kRow;
      for (int d = 0; d < D; d += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(q0p + d);
        const float4 qc = *reinterpret_cast<const float4*>(q1p + d);
#pragma unroll
        for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float4 kv = *reinterpret_cast<const float4*>(
                reinterpret_cast<const float*>(sK) + (n * 8 + tig * 2 + j) * S::kRow + d);
            s[n][j] = fmaf(qa.x, kv.x, fmaf(qa.y, kv.y, fmaf(qa.z, kv.z, fmaf(qa.w, kv.w, s[n][j]))));
            s[n][2 + j] = fmaf(qc.x, kv.x, fmaf(qc.y, kv.y, fmaf(qc.z, kv.z, fmaf(qc.w, kv.w, s[n][2 + j]))));
          }
        }
      }
    }

    // ---- scale, mask, online softmax
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + tig * 2 + (e & 1);
        const int key = k0 + col;
        float x = s[n][e] * p.sm_scale;
        if (key >= p.Sk) {
          x = -INFINITY;  // past the end: not a key at all
        } else {
          bool keep = true;
          if (p.causal) keep = qr[e >> 1] + p.causal_offset >= key;
          if (has_seg) keep = keep && qseg[e >> 1] == sSeg[col];
          if (!keep) x = kMaskValue;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the four threads of a quad share a row
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);  // finite: every tile holds a real key
      alpha[i] = expf(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[n][e] - m_run[e >> 1]);
        s[n][e] = pe;
        rowsum[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 1);
      rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 2);
      l_run[i] = l_run[i] * alpha[i] + rowsum[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // ---- O += P V
    if constexpr (S::kIsBf16) {
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(sV);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        // two 8-key score tiles form one 16-key A fragment (rounded to bf16)
        const uint32_t a[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const int key = kk * 16 + tig * 2;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const int d = n * 8 + g;
          const uint32_t b0 = pack_bf16(v[key * S::kRow + d], v[(key + 1) * S::kRow + d]);
          const uint32_t b1 = pack_bf16(v[(key + 8) * S::kRow + d], v[(key + 9) * S::kRow + d]);
          mma_bf16(o[n], a, b0, b1);
        }
      }
    } else {
      // rows are private to the warp: publish P through shared memory
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sP[lr[e >> 1] * S::kPRow + n * 8 + tig * 2 + (e & 1)] = s[n][e];
      __syncwarp();
      const float* v = reinterpret_cast<const float*>(sV);
      for (int key = 0; key < kBlockN; ++key) {
        const float p0 = sP[lr[0] * S::kPRow + key];
        const float p1 = sP[lr[1] * S::kPRow + key];
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const float2 vv = *reinterpret_cast<const float2*>(v + key * S::kRow + n * 8 + tig * 2);
          o[n][0] = fmaf(p0, vv.x, o[n][0]);
          o[n][1] = fmaf(p0, vv.y, o[n][1]);
          o[n][2] = fmaf(p1, vv.x, o[n][2]);
          o[n][3] = fmaf(p1, vv.y, o[n][3]);
        }
      }
      __syncwarp();  // P is rewritten by the next tile
    }
  }

  // ---- epilogue
  float inv_l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv_l[i] = 1.f / (l_run[i] == 0.f ? 1.f : l_run[i]);
  T* ob = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qr[i] >= p.Sq) continue;
    T* orow = ob + (((long long)b * p.Sq + qr[i]) * p.H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = o[n][2 * i] * inv_l[i], x1 = o[n][2 * i + 1] * inv_l[i];
      if constexpr (S::kIsBf16) {
        *reinterpret_cast<uint32_t*>(orow + n * 8 + tig * 2) = pack_bf16(x0, x1);
      } else {
        *reinterpret_cast<float2*>(orow + n * 8 + tig * 2) = make_float2(x0, x1);
      }
    }
    if (p.lse != nullptr && tig == 0) {
      const float l_safe = l_run[i] == 0.f ? 1.f : l_run[i];
      p.lse[((long long)b * p.H + h) * p.Sq + qr[i]] = m_run[i] + logf(l_safe);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = Smem<T, D>::kBytes;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockM - 1) / kBlockM, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int vtt_flash_attn_fwd(
    const void* q, const void* k, const void* v, const int* q_seg, const int* k_seg,
    void* out, float* lse, int is_bf16, int B, int H, int Hkv, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, int causal_offset, float sm_scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.q_seg = q_seg; p.k_seg = k_seg; p.out = out; p.lse = lse;
  p.B = B; p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.causal = causal; p.causal_offset = causal_offset; p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch_d<__nv_bfloat16>(p, D, s) : dispatch_d<float>(p, D, s);
  return static_cast<int>(err);
}

extern "C" const char* vtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
