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

}  // namespace mxtt
