// Building blocks for Hopper (sm_90a) kernels: asynchronous 16-byte copies
// into 128-byte-swizzled shared-memory tiles, shared-memory matrix
// descriptors, and warpgroup matrix products (wgmma) with their fences; and,
// for the kernels whose row count is far below a warpgroup's 64, the warp
// matrix product (mma.sync) with its 8x8 matrix loads; and fp32 products on
// the tensor cores as three TF32 products ("3xTF32").
// Used by flash_attn_fwd_sm90.cu, flash_attn_bwd_dkv_sm90.cu,
// flash_attn_bwd_dq_sm90.cu, chunk_attention_sm90.cu,
// decode_attention_sm90.cu, flash_attn_fwd_tf32x3.cu,
// flash_attn_bwd_dq_tf32x3.cu, flash_attn_bwd_dkv_tf32x3.cu,
// w8_matmul_sm90.cu and vq_lookup_sm90.cu (the fp32 tiles read both ways by
// the two 3xTF32 backward kernels);
// the K/V cache tiles and the fused KV row write by the chunk and decode
// kernels, the int8 -> bf16 conversion by those two and the int8 matmul, the
// TMA copies and transaction barriers by the int8 matmul, the cluster reads
// by the int8 matmul and the VQ search.
//
// The one tile layout used everywhere ("row tile"): R rows of 128 bytes (64
// bf16), row r at byte r * 128, its 16-byte chunk c stored at chunk position
// c ^ (r & 7). That is the 128-byte swizzle of the wgmma descriptor, for which
// the tile must start at a multiple of 1024 bytes. A head dim of 32 fills
// chunks 0..3 of every row and leaves the rest unused, so one layout serves
// D = 32 and D = 64. The same tile is read
//   * K-major (the 64 values of a row are the product's inner dimension):
//     Q.K^T reads Q and K this way, rows being the M or N index; a step of 16
//     along the inner dimension is 32 bytes;
//   * MN-major (rows are the inner dimension, the row's values the N index):
//     P.V reads V this way, with no transposed copy; a step of 16 along the
//     inner dimension is 16 rows, 2048 bytes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kRowBytes = 128;   // one row of a row tile
constexpr int kAtomBytes = 1024; // 8 rows: the swizzle repeats, tiles align to it

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` of row `row` inside a row tile.
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return row * kRowBytes + ((chunk ^ (row & 7)) << 4);
}

// 16 bytes global -> shared, asynchronously, past L1; `bytes` = 0 writes zeros
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; `bytes` = 0 writes zeros.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kPending of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ---- thread block clusters: the blocks of a cluster read each other's
// shared memory. All threads of every block of the cluster arrive; a block's
// writes before it are seen by the cluster's reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address in the shared memory of the cluster's block `rank` that
// corresponds to `addr` in this block's.
__device__ __forceinline__ uint32_t map_cluster_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ int ld_cluster_s32(uint32_t addr) {
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// ---- the Tensor Memory Accelerator (TMA) and transaction barriers
// One thread asks for a whole tile; the copy lands through the asynchronous
// proxy (the one wgmma reads through: no proxy fence needed for it) and
// reports its bytes to an mbarrier in shared memory, which completes a phase
// once its expected arrivals and bytes are in.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// The barrier inits visible to the asynchronous proxy (and the cluster)
// before any copy reports to them; the block synchronises after it.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This thread's arrival, expecting `bytes` more of copies in the phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The box of a 2D tensor map (`map`: the address of a __grid_constant__
// CUtensorMap kernel parameter) at element coordinates (c0 innermost, c1)
// into shared memory at `dst`, its bytes reported to `bar`. Elements outside
// the tensor arrive as zeros and count as bytes all the same.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Makes this thread's shared-memory writes (cp.async included) visible to the
// asynchronous proxy through which wgmma reads its operands. Each writer
// runs it before the barrier that hands the tile to the readers.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One thread's share of copying kRows-row tiles of a [len, D] bf16 matrix (row
// stride `row_stride` elements) into row tiles, with kThreads threads: the
// thread always copies the same 16-byte chunk of rows r0, r0 + kStep, ..., so
// its source pointer, its swizzled destination offset and the row stride are
// computed once and a tile costs a pointer add and a bounds test per copy.
template <int D, int kRows, int kThreads>
struct RowTileLoader {
  static constexpr int kChunks = D / 8;            // 16-byte chunks in a row
  static constexpr int kStep = kThreads / kChunks;  // rows covered by one pass of all threads
  static constexpr int kPasses = (kRows + kStep - 1) / kStep;
  static_assert(kThreads % kChunks == 0 && kStep % 8 == 0, "a pass keeps each thread's swizzle");

  const __nv_bfloat16* base;  // row 0 (the source of zero-filled copies must be valid)
  const __nv_bfloat16* src;   // this thread's chunk of row r0
  long long row_stride, pass_stride;
  int len, r0;
  uint32_t dst_off;

  __device__ __forceinline__ RowTileLoader(const __nv_bfloat16* matrix, long long stride, int rows)
      : base(matrix), row_stride(stride), pass_stride(kStep * stride), len(rows) {
    const int chunk = threadIdx.x % kChunks;
    r0 = threadIdx.x / kChunks;
    src = matrix + r0 * stride + chunk * 8;
    dst_off = swizzled(r0, chunk);
  }

  // Rows [row0, row0 + kRows) into the row tile at shared address `dst`; rows at
  // or past `len` are zero-filled (len > 0).
  __device__ __forceinline__ void load(uint32_t dst, int row0) const {
    const __nv_bfloat16* from = src + row0 * row_stride;
    const int left = len - row0 - r0;  // rows from this thread's first one to the end
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      if (kRows % kStep != 0 && r0 + i * kStep >= kRows) break;
      const bool in = i * kStep < left;
      cp_async16(dst + dst_off + i * kStep * kRowBytes, in ? from : base, in ? 16 : 0);
      from += pass_stride;
    }
  }
};

// The 64-bit wgmma descriptor of a row tile (or of a part of one that starts
// at a multiple of 1024 bytes): start address, 128-byte swizzle, 1024 bytes
// from one group of 8 rows to the next. The same descriptor serves the
// K-major and the MN-major reading; the instruction's transpose flag chooses.
__device__ __forceinline__ uint64_t row_tile_desc(uint32_t addr) {
  uint64_t desc = (addr & 0x3FFFF) >> 4;            // bits 0-13: address / 16
  desc |= (uint64_t)1 << 16;                        // bits 16-29: leading offset (unused here)
  desc |= (uint64_t)(kAtomBytes >> 4) << 32;        // bits 32-45: stride between 8-row groups
  desc |= (uint64_t)1 << 62;                        // bits 62-63: 128-byte swizzle
  return desc;
}

// Descriptor steps of 16 along the inner dimension (the address field counts
// 16-byte units).
constexpr uint64_t kStepKMajor = 32 >> 4;             // 16 bf16 along a row
constexpr uint64_t kStepMNMajor = (16 * kRowBytes) >> 4;  // 16 rows

// Orders earlier register writes (accumulators, A fragments) and shared-memory
// writes of this warpgroup before the wgmma operations that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most kPending committed groups of products are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// wgmma writes its accumulators (and reads register A fragments) after the
// instruction has started; the compiler does not know. Naming the registers in
// an empty volatile asm after the wait (and before the start) keeps it from
// moving their reads and writes across.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the special-function unit: 2^-inf = +0, denormal results flushed.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Accumulator layout of every product below, for thread t of the warpgroup
// (warp w = t / 32, g = (t % 32) / 4, tig = t % 4): d[i] is row
// 16 w + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 tig + (i % 2): the
// mma.sync m16n8 C layout, repeated along N. The register A fragment of a
// 16-deep step kk is {pack(d[8kk], d[8kk+1]), pack(d[8kk+2], d[8kk+3]),
// pack(d[8kk+4], d[8kk+5]), pack(d[8kk+6], d[8kk+7])} of a previous product's
// accumulator, so a probability tile never leaves registers.

// D[64 x 64] = (scale_d ? D : 0) + A[64 x 16] B[16 x 64], A and B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] = (scale_d ? D : 0) + A[64 x 16] B[16 x 128], A and B K-major in
// shared memory (the int8 matmul: x rows by 128 output channels).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 32] = (scale_d ? D : 0) + A[64 x 16] B[16 x 32], A from registers, B
// in shared memory, K-major (kTransB = 0) or MN-major (kTransB = 1).
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(kTransB));
}

// D[64 x 64] = (scale_d ? D : 0) + A[64 x 16] B[16 x 64], A from registers, B
// in shared memory, K-major (kTransB = 0) or MN-major (kTransB = 1).
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(kTransB));
}

// ---- warp-level products, for tiles of 16 rows
// D(16 x 8 fp32) += A(16 x 16 bf16, row-major) B(16 x 8 bf16, column-major).
// Thread (g = lane / 4, tig = lane % 4) holds a = {A[g][2tig..], A[g+8][2tig..],
// A[g][2tig+8..], A[g+8][2tig+8..]}, b0 = B[2tig..][g], b1 = B[2tig+8..][g] (two
// consecutive inner indices each) and d = {D[g][2tig], D[g][2tig+1],
// D[g+8][2tig], D[g+8][2tig+1]}.
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of row
// l % 8 of matrix l / 8 (16 bytes); r[i] is this thread's pair of matrix i:
// row g, columns 2tig, 2tig+1, or, transposed, rows 2tig, 2tig+1 of column g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ---- fp32 products on the tensor cores: three TF32 products ("3xTF32")
// A TF32 value is an fp32 bit pattern of which the tensor cores read the
// upper 19 bits (11 significant bits); they ignore the low 13 mantissa bits of
// an operand, which truncates it. An fp32 x splits into hi = x rounded to
// nearest, ties away from zero, to TF32 (the bits of cvt.rna.tf32.f32, by an
// integer add and a mask) and lo = x - hi (exact in fp32), which the tensor
// core truncates to TF32 as it reads it: hi + lo is x within 2^-21 of |x| for
// a normal x. Rounding lo with cvt.rna as well took 1.7x the kernel time of
// csrc/flash_attn_fwd_tf32x3.cu at no measurable gain in accuracy (PERF.md).
// A product a.b is then lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, the small terms
// first, in fp32 accumulation: each partial product is exact (11 x 11 bits),
// lo_a.lo_b (~2^-22 of |a.b|) is left out. ops/attention.py::split_tf32 is the
// same split in PyTorch, lo as the tensor core reads it.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D(16 x 8 fp32) += A(16 x 8 tf32, row-major) B(8 x 8 tf32, column-major).
// Thread (g = lane / 4, tig = lane % 4) holds a = {A[g][tig], A[g+8][tig],
// A[g][tig+4], A[g+8][tig+4]}, b0 = B[tig][g], b1 = B[tig+4][g] and d as for
// m16n8k16: {D[g][2tig], D[g][2tig+1], D[g+8][2tig], D[g+8][2tig+1]}. The
// accumulator's columns 2tig, 2tig+1 are not A's columns tig, tig+4: a kernel
// that feeds a product's result into the next one permutes the inner index.
__device__ __forceinline__ void mma_m16n8k8_tf32(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A.B for fp32 A and B given as their TF32 parts: lo.hi + hi.lo, then hi.hi.
__device__ __forceinline__ void mma_m16n8k8_tf32x3(float (&d)[4], const uint32_t (&a_hi)[4],
                                                   const uint32_t (&a_lo)[4], uint32_t b0_hi,
                                                   uint32_t b1_hi, uint32_t b0_lo,
                                                   uint32_t b1_lo) {
  mma_m16n8k8_tf32(d, a_lo, b0_hi, b1_hi);
  mma_m16n8k8_tf32(d, a_hi, b0_lo, b1_lo);
  mma_m16n8k8_tf32(d, a_hi, b0_hi, b1_hi);
}

// ---- fp32 tiles read both ways (the 3xTF32 flash backward kernels)
// Rows of D fp32 values (D = 32 or 64), row r at byte r * D * 4, its 16-byte
// chunk c at chunk position c ^ swizzle(r). A product reads such a tile in one
// of two orientations, 16 bytes a thread, and both hit every bank group once
// in each quarter warp (lanes g = 2 q, 2 q + 1, tig = 0..3):
//   * along D, the tile's rows being the product's N index (K in Q.K^T):
//     chunk 4 p + tig of rows 8 n + g. Two rows of opposite parity: bit 2 of
//     the swizzle flips with the parity;
//   * along the rows, the rows being the inner index (K in dS.K): chunk
//     (D / 32) g + c of rows 8 j + 2 tig + e, four rows of one parity. The
//     swizzle's other bit is tig's low bit (r >> 1) and bit 2 carries its high
//     bit (r >> 2), so tig spreads the chunks over the bank groups that g
//     leaves free (bits 0 and 2 at D = 64, bits 1 and 2 at D = 32).
template <int D>
struct Fp32Tile {
  static constexpr int kChunks = D / 4;  // 16-byte chunks of a row
  static constexpr int kRowBytes = D * 4;
  __device__ static int at(int r, int c) {
    const int flip = ((r >> 2) ^ r) & 1;
    const int s = (((r >> 1) & 1) << (D == 64 ? 0 : 1)) | (flip << 2);
    return r * kRowBytes + ((c ^ s) << 4);
  }
};

// One thread's share (of kThreads) of the 16-byte asynchronous copies of kRows
// rows, from row0, of a [len, D] fp32 matrix (row stride `stride` elements)
// into an Fp32Tile<D> at dst; rows past len are zero-filled.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void fp32_tile_load(uint32_t dst, const float* src, long long stride,
                                               int row0, int len) {
  using T = Fp32Tile<D>;
  static_assert(kRows * T::kChunks % kThreads == 0, "every thread copies as many chunks");
#pragma unroll
  for (int it = 0; it < kRows * T::kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / T::kChunks, c = i % T::kChunks;
    const bool in = row0 + r < len;
    const long long row = in ? row0 + r : 0;
    cp_async16(dst + T::at(r, c), src + row * stride + c * 4, in ? 16 : 0);
  }
}

// The two warp-level products of the 3xTF32 flash backward kernels, on
// Fp32Tile<D> tiles; accumulators in the mma C layout (element e of n-tile n:
// row g + 8 (e >> 1), column 8 n + 2 tig + (e & 1)).
//
// acc = A.B^T over D for rows a_row0 .. a_row0 + 15 of sA and the kCols rows of
// sB, both read along D: slot tig (+4) of k-step 2 kp + i is head-dim value
// 16 kp + 4 tig + 2 i (+1), so a thread's four slots of a pair of k-steps are
// one 16-byte read of each tile (S = Q.K^T, dP = dO.V^T, and transposed).
template <int D, int kCols>
__device__ __forceinline__ void tf32x3_rows_dot_rows(float (&acc)[kCols / 8][4],
                                                     const unsigned char* sA, int a_row0,
                                                     const unsigned char* sB, int g, int tig) {
  using T = Fp32Tile<D>;
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kp = 0; kp < D / 16; ++kp) {
    const float4 x0 = *reinterpret_cast<const float4*>(sA + T::at(a_row0 + g, 4 * kp + tig));
    const float4 x1 = *reinterpret_cast<const float4*>(sA + T::at(a_row0 + g + 8, 4 * kp + tig));
    const float a[2][4] = {{x0.x, x1.x, x0.y, x1.y}, {x0.z, x1.z, x0.w, x1.w}};
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32(a[i][j], ah[i][j], al[i][j]);
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      const float4 y = *reinterpret_cast<const float4*>(sB + T::at(8 * n + g, 4 * kp + tig));
      uint32_t bh[4], bl[4];
      split_tf32(y.x, bh[0], bl[0]);
      split_tf32(y.y, bh[1], bl[1]);
      split_tf32(y.z, bh[2], bl[2]);
      split_tf32(y.w, bh[3], bl[3]);
      mma_m16n8k8_tf32x3(acc[n], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
      mma_m16n8k8_tf32x3(acc[n], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
    }
  }
}

// out += P.B for a warp's 16 x kCols block P in the C layout and the kCols
// rows of sB read along the rows (dQ += dS.K, dV += P^T.dO, dK += dS^T.Q).
// k-step j: slots tig and tig + 4 are rows 8 j + 2 tig and 8 j + 2 tig + 1 of
// sB, the columns this thread holds of P's n-tile j, so P is the A operand
// with no shuffle. The output's columns are permuted: column g of n-tile n is
// head-dim value (D / 8) g + n, so a thread reads D / 8 consecutive values of
// an sB row, and holds D / 8 consecutive values (D / 8) (2 tig + h) + n of its
// output rows. The tile's product goes to an accumulator of its own, joined
// to `out` by a rounded add: the tensor core does not round the sums it adds
// into an accumulator to nearest, and over all the tiles of S = 2048 in one
// accumulator that error grows with S (PERF.md: 2.2e-5 of max|out| in the
// fp32 forward, against 3.4e-6 per tile).
template <int D, int kCols>
__device__ __forceinline__ void tf32x3_probs_times_rows(float (&out)[D / 8][4],
                                                        const float (&pm)[kCols / 8][4],
                                                        const unsigned char* sB, int g, int tig) {
  using T = Fp32Tile<D>;
  constexpr int kNT = D / 8;
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(pm[j][0], ah[0], al[0]);
    split_tf32(pm[j][2], ah[1], al[1]);
    split_tf32(pm[j][1], ah[2], al[2]);
    split_tf32(pm[j][3], ah[3], al[3]);
    // head-dim values kNT g .. kNT g + kNT - 1 of the two sB rows
    float br[2][kNT];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c = 0; c < kNT / 4; ++c) {
        const float4 x =
            *reinterpret_cast<const float4*>(sB + T::at(8 * j + 2 * tig + e, (kNT / 4) * g + c));
        br[e][4 * c] = x.x;
        br[e][4 * c + 1] = x.y;
        br[e][4 * c + 2] = x.z;
        br[e][4 * c + 3] = x.w;
      }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      uint32_t b0h, b0l, b1h, b1l;
      split_tf32(br[0][n], b0h, b0l);
      split_tf32(br[1][n], b1h, b1l);
      mma_m16n8k8_tf32x3(acc[n], ah, al, b0h, b1h, b0l, b1l);
    }
  }
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] += acc[n][e];
}

// Stores a warp's 16 x D accumulator (columns permuted as
// tf32x3_probs_times_rows leaves them) times `scale` to rows rows[0], rows[1]
// of a contiguous [B, S, H, D] fp32 tensor, 16 bytes a store; rows past S
// are not written.
template <int D>
__device__ __forceinline__ void tf32x3_store_rows(float* dst, const float (&acc)[D / 8][4],
                                                  float scale, int b, int h, int H, int S,
                                                  const int (&rows)[2], int tig) {
  constexpr int kNT = D / 8;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    float* row = dst + (((long long)b * S + rows[r]) * H + h) * D + 2 * kNT * tig;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int c = 0; c < kNT / 4; ++c) {
        const int e = 2 * r + half;
        *reinterpret_cast<float4*>(row + kNT * half + 4 * c) =
            make_float4(acc[4 * c][e] * scale, acc[4 * c + 1][e] * scale,
                        acc[4 * c + 2][e] * scale, acc[4 * c + 3][e] * scale);
      }
  }
}

// ---- K/V cache tiles for the mma.sync attention kernels (chunk and decode)
// A warp's tile of 16 cache rows of one KV head at head dim 64 in shared
// memory, K and V of a tile together in one stage (and, for an int8 cache, the
// tile's 16 K and 16 V row scales after them).
constexpr int kKvTileKeys = 16;

template <typename TC>
struct KvTile;

template <>
struct KvTile<__nv_bfloat16> {
  static constexpr bool kInt8 = false;
  static constexpr int kRowBytes = 128, kChunks = 8;
  static constexpr int kBytes = kKvTileKeys * kRowBytes;
  static constexpr int kStageBytes = 2 * kBytes;
  // 16-byte chunk c of row r: the swizzle ldmatrix wants (8 rows, one chunk
  // position each)
  __device__ static uint32_t at(int r, int c) { return r * kRowBytes + ((c ^ (r & 7)) << 4); }
  // head-dim index of inner index 2 tig + 8 half of k-step ks of Q.K^T
  __device__ static int q_col(int ks, int tig, int half) { return 16 * ks + 2 * tig + 8 * half; }
  // head-dim index of column c of output n-tile n
  __device__ static int o_col(int n, int c) { return 8 * n + c; }
};

template <>
struct KvTile<int8_t> {
  static constexpr bool kInt8 = true;
  static constexpr int kRowBytes = 64, kChunks = 4;
  static constexpr int kBytes = kKvTileKeys * kRowBytes;
  static constexpr int kStageBytes = 2 * kBytes + 2 * kKvTileKeys * (int)sizeof(float);  // + scales
  // two rows share 128 bytes; the slot of a chunk is XORed with 2 * ((r / 2) % 4),
  // so that the K read (rows g of an n-tile, chunk tig, 16 bytes) and the V read
  // (rows 2 tig + const, 8 bytes at 8 g) each cover all banks once
  __device__ static uint32_t at(int r, int c) {
    return (r >> 1) * 128 + (((((r & 1) << 2) | c) ^ (((r >> 1) & 3) << 1)) << 4);
  }
  // thread tig converts bytes 16 tig .. 16 tig + 15 of a key: word ks of them is
  // the four inner indices 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 of k-step ks
  __device__ static int q_col(int ks, int tig, int half) { return 16 * tig + 4 * ks + 2 * half; }
  // thread g converts bytes 8 g .. 8 g + 7 of a V row: byte n is column g of n-tile n
  __device__ static int o_col(int n, int c) { return 8 * c + n; }
};

// ---- the KV row write fused into the chunk and decode kernels
// A new row of a layer's [B, S, KV] cache is written by the warp of the block
// that owns its key, for the block's kCols (HP x 64) columns only. The warp
// first stages the row in shared memory by cp.async, issued with its first
// tile copies (the row sits in L2: the qkv projection just wrote it), so that
// no load latency lands on its path: `cols` values of the row from column
// `col0` (the whole row for an int8 cache, whose scale needs the amax of all
// KV columns; the block's own columns for a bf16 one), bf16 or fp32 as the
// projection left them (`bytes` = cols x 2 or 4, a multiple of 16; `src` 16-byte
// aligned).
__device__ __forceinline__ void kv_row_stage(uint32_t dst, const void* src, int bytes, int lane) {
  for (int c = 16 * lane; c < bytes; c += 16 * 32)
    cp_async16(dst + c, static_cast<const unsigned char*>(src) + c, 16);
}

// Then, once the copies have landed, kv_row_convert turns the staged row
// (`raw`, `cols` values, the block's columns from value `own` on) into the
// cache's type: to the cache row in device memory (`dst`: its first own
// column) and to `patch` (shared memory, plain column order), and returns the
// row's scale. An int8 cache quantises the row as csrc/cache_update.cu and
// ops/decode_attention.py::_quantize_rows do, bit for bit: the scale is
// max(amax / 127, 1e-8) over ALL KV columns (a true division), each value
// clip(rint(x / scale), +-127); lane 0 stores the scale to `scale` (every
// block that owns the row writes the same bits). A bf16 cache takes each
// value rounded to bf16 (the identity on bf16 rows).
__device__ __forceinline__ float staged_value(const unsigned char* raw, int at, bool bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(raw)[at])
              : reinterpret_cast<const float*>(raw)[at];
}

template <typename TC, int kCols>
__device__ __forceinline__ float kv_row_convert(const unsigned char* raw, bool bf16, int cols,
                                                int own, TC* dst, float* scale, TC* patch,
                                                int lane) {
  constexpr int kPer = kCols / 32;  // consecutive columns of a lane: 2 or 4
  static_assert(kPer == 2 || kPer == 4, "a block writes 64 or 128 columns of a row");
  float x[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) x[i] = staged_value(raw, own + lane * kPer + i, bf16);
  if constexpr (sizeof(TC) == 1) {
    // the amax, 16 bytes a lane and step (8 bf16 values, as pairs: the max of
    // bf16 values is exact in bf16, and max ignores NaN as fmaxf does; or 4
    // fp32 values)
    float amax = 0.f;
    if (bf16) {
      __nv_bfloat162 m2 = __float2bfloat162_rn(0.f);
#pragma unroll 4
      for (int j = 8 * lane; j < cols; j += 256) {
        const uint4 w = *reinterpret_cast<const uint4*>(raw + 2 * j);
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          m2 = __hmax2(m2, __habs2(*reinterpret_cast<const __nv_bfloat162*>(&words[i])));
      }
      amax = fmaxf(__low2float(m2), __high2float(m2));
    } else {
#pragma unroll 4
      for (int j = 4 * lane; j < cols; j += 128) {
        const float4 w = *reinterpret_cast<const float4*>(raw + 4 * j);
        amax = fmaxf(fmaxf(amax, fabsf(w.x)), fmaxf(fabsf(w.y), fmaxf(fabsf(w.z), fabsf(w.w))));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float s = fmaxf(amax / 127.0f, 1e-8f);
    uint32_t packed = 0u;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float q = fminf(fmaxf(rintf(x[i] / s), -127.f), 127.f);
      packed |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu) << (8 * i);
    }
    if constexpr (kPer == 2) {
      *reinterpret_cast<uint16_t*>(dst + lane * kPer) = static_cast<uint16_t>(packed);
      *reinterpret_cast<uint16_t*>(patch + lane * kPer) = static_cast<uint16_t>(packed);
    } else {
      *reinterpret_cast<uint32_t*>(dst + lane * kPer) = packed;
      *reinterpret_cast<uint32_t*>(patch + lane * kPer) = packed;
    }
    if (lane == 0) *scale = s;
    return s;
  } else {
    uint32_t w[kPer / 2];
#pragma unroll
    for (int i = 0; i < kPer / 2; ++i) w[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
    if constexpr (kPer == 2) {
      *reinterpret_cast<uint32_t*>(dst + lane * kPer) = w[0];
      *reinterpret_cast<uint32_t*>(patch + lane * kPer) = w[0];
    } else {
      *reinterpret_cast<uint2*>(dst + lane * kPer) = make_uint2(w[0], w[1]);
      *reinterpret_cast<uint2*>(patch + lane * kPer) = make_uint2(w[0], w[1]);
    }
    return 1.f;
  }
}

// Two int8 values (bytes lo and hi of w ^ 0x80808080) as a bf16 pair, exactly:
// the byte lands in the mantissa of 2^23, 2^23 + 128 is subtracted, and the
// result (|x| <= 128) fits bf16's 8 significant bits, so its fp32 bits end in
// 16 zeros and the pair is the two upper halves (a byte permute, not a
// conversion).
__device__ __forceinline__ uint32_t int8_pair_to_bf16(uint32_t biased_lo, int byte_lo,
                                                      uint32_t biased_hi, int byte_hi) {
  const float lo =
      __uint_as_float(__byte_perm(biased_lo, 0x4B000000u, 0x7650 + byte_lo)) - 8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(biased_hi, 0x4B000000u, 0x7650 + byte_hi)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

}  // namespace sm90
