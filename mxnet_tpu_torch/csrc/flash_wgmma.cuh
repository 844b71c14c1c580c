// Hopper tensor-core building blocks of the bf16 flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd_dq.cu,
// flash_attention_bwd_dkv.cu).
//
// - Tiles: 64 rows x D bf16 in shared memory in the 128-byte swizzle that
//   wgmma's descriptors name.  A tile is D / 64 column blocks of 8 KB; in
//   a block, row r is one 128-byte line whose 16-byte chunk c sits at
//   chunk c ^ (r % 8).  Each block starts on a 1024-byte boundary, so the
//   swizzle repeats every 8 rows as the hardware expects.  The same bytes
//   serve as a K-major operand (rows are the product's M or N, the head
//   dim is its K) and as an MN-major B operand (rows are the product's K,
//   the head dim is its N: wgmma's transpose bit for 16-bit types).
// - Copies: cp.async 16-byte copies straight into that layout, with the
//   zero-fill form (src-size 0) for rows at or past L, committed in
//   groups so the next tile's load is in flight while this tile's
//   products run.
// - Products: wgmma.mma_async m64n64k16 (A and B from shared memory) and
//   m64nDk16 (A from registers, B MN-major from shared memory), bf16 in,
//   fp32 accumulators in registers.  An accumulator of m64n64 holds, in
//   thread t of the warpgroup (warp w, lane l), rows 16 w + l / 4 + 8 i
//   and columns 8 j + 2 (l % 4) + c in register 4 j + 2 i + c: exactly
//   the register A-operand layout of the next product, so P and dS go
//   from the accumulator to the tensor cores without touching shared
//   memory (to_a_operand).
#pragma once

#include "flash_common.cuh"

namespace mxtt {
namespace wg {

constexpr int kThreads = 128;          // one warpgroup
constexpr int kRows = 64;              // rows of a tile = wgmma's M
constexpr int kBlockBytes = 64 * 128;  // one 64-column block of a tile

template <int D> __host__ __device__ constexpr int tile_bytes() { return kRows * D * 2; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c8 (head-dim columns 8 c8 .. 8 c8 + 7) of
// row r in a swizzled tile.
__device__ __forceinline__ uint32_t swizzled(int r, int c8) {
  return (c8 >> 3) * kBlockBytes + r * 128 + (((c8 & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's completed cp.async writes visible to wgmma, which
// reads shared memory through the async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + 64) of a contiguous (L, D) bf16 matrix into a
// swizzled tile at shared address dst; rows at or past L are zero.
template <int D>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int row0, int L, int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int it = 0; it < kRows * CH / kThreads; ++it) {
    const int i = tid + it * kThreads, r = i / CH, c8 = i % CH;
    const bool ok = row0 + r < L;
    const __nv_bfloat16* g = src + (size_t)(ok ? row0 + r : 0) * D + c8 * 8;
    cp_async16(dst + swizzled(r, c8), g, ok ? 16 : 0);
  }
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle: start address, the
// leading byte offset (MN-major: between 64-column blocks) and the stride
// byte offset (between groups of 8 rows), all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand of a tile, k-step kk (head-dim columns 16 kk .. +15):
// 32 bytes further along the swizzled line, or into the next column block.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * kBlockBytes + (kk & 3) * 32, 16, 1024);
}
// MN-major B operand of a tile, k-step kk (tile rows 16 kk .. +15).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * 128, kBlockBytes, 1024);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MXTT_F8(d, i)                                                       \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),      \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d (+)= A B, M 64, N 64, K 16; A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MXTT_F8(d, 0), MXTT_F8(d, 8), MXTT_F8(d, 16), MXTT_F8(d, 24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, M 64, N 64, K 16; A in registers, B MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MXTT_F8(d, 0), MXTT_F8(d, 8), MXTT_F8(d, 16), MXTT_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The same with N 128.
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t* a,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : MXTT_F8(d, 0), MXTT_F8(d, 8), MXTT_F8(d, 16), MXTT_F8(d, 24),
        MXTT_F8(d, 32), MXTT_F8(d, 40), MXTT_F8(d, 48), MXTT_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef MXTT_F8

// A 64 x 64 fp32 accumulator, rounded to bf16, as the register A operand
// of a product whose K is the accumulator's 64 columns: k-step kk takes
// a[4 kk .. 4 kk + 3].
__device__ __forceinline__ void to_a_operand(const float (&d)[32],
                                             uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(d[2 * i], d[2 * i + 1]);
    a[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

// Shared memory of a block: `bytes` from a 1024-byte boundary.
__device__ __forceinline__ uint32_t aligned_base(const void* smem) {
  return (smem_addr(smem) + 1023u) & ~1023u;
}

}  // namespace wg
}  // namespace mxtt
