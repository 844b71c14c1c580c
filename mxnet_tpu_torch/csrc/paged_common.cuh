// Shared device helpers of the two paged-attention kernels
// (ragged_paged_attention.cu, ragged_paged_verify.cu).
//
// Both kernels keep the contract of the Pallas kernels they replace
// (mxnet_tpu/ops/pallas_kernels.py): storage-dtype inputs (fp32 or
// bf16), fp32 running max / denominator / accumulator, the mask value
// -1e30 (not -inf), output in the query dtype, and exact zeros for a
// row with no visible key.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxtt {

constexpr float kMaskValue = -1e30f;

// dtype codes passed from Python (ops/paged_attention.py _DTYPE_CODE)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// Elements per 16-byte vector: every K/V/q row is read as 16-byte loads.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// fp32 value rounded through the storage dtype (identity for fp32)
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Lane layout of one head_dim-D row: the row is CHUNKS 16-byte chunks,
// spread over a group of G lanes (a power of two <= 32), CPL chunks per
// lane; a warp holds 32 / G groups.  Lane `gl` of a group owns chunks
// gl, gl + G, gl + 2G, ...
template <typename T, int D> struct RowLayout {
  static constexpr int VEC = Vec<T>::N;
  static constexpr int CHUNKS = D / VEC;
  static constexpr int G = CHUNKS < 32 ? CHUNKS : 32;
  static constexpr int CPL = CHUNKS / G;
  static constexpr int EPL = CPL * VEC;       // elements per lane
  static constexpr int GROUPS_PER_WARP = 32 / G;
  static_assert(D % VEC == 0 && CHUNKS % G == 0, "unsupported head_dim");
};

// Sum over the G lanes of one group (groups are aligned lane ranges,
// so xor offsets below G never leave the group).  Every lane of the
// warp must call it.
template <int G> __device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// ---- asynchronous copies (used by both paged kernels), warp-level
// tensor-core products (ragged_paged_verify.cu), in their own namespace because
// flash_common.cuh includes this file.  smem_addr, cp_async16,
// cp_async_commit and cp_async_wait are copied from flash_wgmma.cuh
// (namespace wg), which the paged kernels do not include.
namespace paged {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes 16 zero bytes and
// reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  Lane i receives, of each matrix, row i / 4
// and columns 2 (i % 4), 2 (i % 4) + 1 (trans: that element pair of the
// transposed matrix).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a * b, m16n8k16, bf16 in, fp32 accumulators.  With g = lane / 4,
// t = lane % 4: a holds rows g, g + 8 and columns 2t, 2t + 1, 2t + 8,
// 2t + 9 (a[0] (g, 2t), a[1] (g + 8, 2t), a[2] (g, 2t + 8), a[3]
// (g + 8, 2t + 8), each a pair); b holds rows (the product's k) 2t, 2t + 1
// and 2t + 8, 2t + 9 of column g; c holds rows g (c[0], c[1]) and g + 8
// (c[2], c[3]) at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values as one bf16 pair (lo in the low half), rounded to
// nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace paged

}  // namespace mxtt
