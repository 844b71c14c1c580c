// Shared tile and masking code of the three flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd_dq.cu,
// flash_attention_bwd_dkv.cu).
//
// Contract of the Pallas kernels they replace
// (mxnet_tpu/ops/pallas_kernels.py, _fwd_kernel / _bwd_dq_kernel /
// _bwd_dkv_kernel): tensors (BH, L, D) in fp32 or bf16, per-(b, h) key
// lengths, optional causal masking with an optional causal sliding window
// (query q sees keys in [q - window + 1, q]), the mask value -1e30, fp32
// softmax statistics and accumulators, and P (and dS in the backward)
// rounded to the storage dtype before each product.  One departure: a
// query row that sees no key at all gets O = 0 and LSE = -1e30, and P is
// exactly 0 wherever the mask is false (the Pallas forward left
// block-size-dependent junk in such rows).
//
// Tiles: 64 query rows x 64 keys in every kernel.  The `needed` tile
// ranges (key_range, query_range) and the mask (visible) are shared by
// all of them.
//
// Every kernel runs its products on the tensor cores: bf16 B1, B2 and B3
// on wgmma over bf16 tiles (flash_wgmma.cuh), fp32 B1, B2 and B3 on
// mma.sync as error-compensated 3xTF32 over fp32 tiles (flash_tf32.cuh).
#pragma once

#include <atomic>

#include "paged_common.cuh"  // kMaskValue, dtype codes

namespace mxtt {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;

// Whether query row r sees key c.  kv_len is already clamped to Lk.
__device__ __forceinline__ bool visible(int r, int c, int Lq, int kv_len,
                                        int causal, int window) {
  bool ok = r < Lq && c < kv_len;
  if (causal) {
    ok = ok && c <= r;
    if (window > 0) ok = ok && c >= r - (window - 1);
  }
  return ok;
}

// The key tiles [k_begin, k_end) that a query tile starting at q0 needs:
// keys below the key length, at or left of the diagonal when causal, and
// inside the window (the Pallas `needed` rule, pallas_kernels.py:101-107).
__device__ __forceinline__ void key_range(int q0, int Lq, int kv_len,
                                          int causal, int window,
                                          int* k_begin, int* k_end) {
  const int q_last = min(q0 + kBlockQ, Lq) - 1;
  int hi = kv_len, lo = 0;
  if (causal) {
    hi = min(hi, q_last + 1);
    if (window > 0) lo = max(0, q0 - (window - 1));
  }
  *k_begin = lo / kBlockK * kBlockK;
  *k_end = hi;
}

// The query tiles [q_begin, q_end) that need a key tile starting at k0
// (the same rule seen from the key side, pallas_kernels.py:206-212).
__device__ __forceinline__ void query_range(int k0, int Lq, int causal,
                                            int window, int* q_begin,
                                            int* q_end) {
  int lo = 0, hi = Lq;
  if (causal) {
    lo = k0 / kBlockQ * kBlockQ;
    if (window > 0) hi = min(hi, k0 + kBlockK - 1 + window);
  }
  *q_begin = lo;
  *q_end = hi;
}

// Launch Kernel with Threads threads a block and smem bytes of dynamic
// shared memory; returns the launch's cudaError_t.  Above 48 KB a kernel
// may launch only after its attribute is raised: that is done once per
// kernel instantiation (each launches with one size, fixed by its
// template arguments) and device, not on every launch.
template <auto Kernel, int Threads, typename... Args>
static int launch_with_smem(dim3 grid, size_t smem, cudaStream_t stream,
                            Args... args) {
  if (smem > 48 * 1024) {
    static std::atomic<unsigned> set_on{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const unsigned bit = 1u << (dev & 31);
    if (!(set_on.load() & bit)) {
      err = cudaFuncSetAttribute(
          Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      set_on.fetch_or(bit);
    }
  }
  Kernel<<<grid, Threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace mxtt
