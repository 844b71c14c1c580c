// Flash-attention forward (B1) for Hopper (sm_90a), CUDA C++.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py, _fwd_kernel (:83) launched by
// _flash_fwd through _run (pl.pallas_call, :265).  FlashAttention-2
// forward: O = softmax(Q K^T * scale) V with an online softmax over key
// tiles, per-(b, h) key lengths, causal masking and a causal sliding
// window; it writes O in the input dtype and the fp32 row LSE that the
// backward kernels (B2, B3) recompute P from.
//
// What bounds it on an H100: operations.  At BERT-large's shape (BH = 128,
// L = 512, D = 64) a (b, h) reads 3 * L * D inputs and does 4 * L^2 * D
// flops on them, ~170 flops per fp32 byte; the simple design here runs on
// the CUDA cores (67 TFLOP/s fp32), not the tensor cores, so even bf16 is
// bound by the fp32 FMA rate and by shared-memory reads.
//
// Design (simple and right first; tensor-core tiles are later work):
// - grid (BH, ceil(Lq / 64)); one block of 256 threads per 64-row query
//   tile.  The TPU kernel's sequential k-block grid axis becomes a loop
//   inside the block over the key tiles the `needed` rule keeps
//   (key length, causal diagonal, window); the rest are never read.
// - Q, K and V tiles are staged in shared memory as fp32 (16-byte global
//   loads); each thread computes a 4 x 4 micro-tile of S, the running
//   max / denominator of its 4 rows and a 4 x D/16 slice of the output
//   accumulator, all fp32.  Head dims 16, 32, 64 and 128 in both dtypes.
//   D = 256 would fit (209 KB of shared memory) but is not offered: its
//   backward does not (flash_attention_bwd_dq.cu, _dkv.cu).  P goes through shared memory, rounded to the
//   storage dtype, for the P V product.
// - Masked entries contribute exactly 0; a row that sees no key writes
//   O = 0 and LSE = -1e30.  Rows past Lq and keys past Lk are masked
//   here, so the wrapper never pads.
#include "flash_common.cuh"

namespace mxtt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lens,
                 T* __restrict__ out, float* __restrict__ lse, int Lq, int Lk,
                 float sm_scale, int causal, int window) {
  constexpr int DP = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                  // 64 x DP
  float* sK = sQ + kBlockQ * DP;     // 64 x DP
  float* sV = sK + kBlockK * DP;     // 64 x DP
  float* sP = sV + kBlockK * DP;     // 64 x kSStride

  const int bh = blockIdx.x, q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kv_len = max(0, min(lens[bh], Lk));
  const T* qb = q + (size_t)bh * Lq * D;
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;

  load_tile<T, D>(sQ, qb, q0, Lq, tid);
  float acc[4][NJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int k_begin, k_end;
  key_range(q0, Lq, kv_len, causal, window, &k_begin, &k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's sK / sV / sP are consumed
    load_tile<T, D>(sK, kb, k0, Lk, tid);
    load_tile<T, D>(sV, vb, k0, Lk, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_abt<D>(s, sQ, sK, ty, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      bool vis[4];
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vis[j] = visible(r, k0 + tx + 16 * j, Lq, kv_len, causal, window);
        s[i][j] *= sm_scale;
        if (vis[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        sP[(ty + 16 * i) * kSStride + tx + 16 * j] = round_to<T>(p);
      }
      psum = half_warp_sum(psum);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * kSStride + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sV[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Lq) continue;
    const bool empty = l[i] == 0.f;
    T* o = out + ((size_t)bh * Lq + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      o[tx + 16 * j] = from_float<T>(empty ? 0.f : acc[i][j] / l[i]);
    if (tx == 0)
      lse[(size_t)bh * Lq + r] = empty ? kMaskValue : m[i] + logf(l[i]);
  }
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v,
                  const void* lens, void* out, void* lse, int BH, int Lq,
                  int Lk, float sm_scale, int causal, int window,
                  cudaStream_t stream) {
  const size_t smem =
      (size_t)(3 * kBlockQ * (D + 1) + kBlockQ * kSStride) * sizeof(float);
  const dim3 grid(BH, (Lq + kBlockQ - 1) / kBlockQ);
  return launch_with_smem(flash_fwd_kernel<T, D>, grid, smem, stream,
                          static_cast<const T*>(q), static_cast<const T*>(k),
                          static_cast<const T*>(v),
                          static_cast<const int*>(lens), static_cast<T*>(out),
                          static_cast<float*>(lse), Lq, Lk, sm_scale, causal,
                          window);
}

template <typename T>
static int dispatch(int D, const void* q, const void* k, const void* v,
                    const void* lens, void* out, void* lse, int BH, int Lq,
                    int Lk, float sm_scale, int causal, int window,
                    cudaStream_t stream) {
#define MXTT_ARGS \
  q, k, v, lens, out, lse, BH, Lq, Lk, sm_scale, causal, window, stream
  switch (D) {
    case 16: return launch<T, 16>(MXTT_ARGS);
    case 32: return launch<T, 32>(MXTT_ARGS);
    case 64: return launch<T, 64>(MXTT_ARGS);
    case 128: return launch<T, 128>(MXTT_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MXTT_ARGS
}

}  // namespace mxtt

// Plain C entry point (bound with ctypes).  Device pointers of contiguous
// tensors: q, out (BH, Lq, D); k, v (BH, Lk, D); lens (BH,) int32; lse
// (BH, Lq) fp32.  window <= 0 means none.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int mxtt_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, const void* lens,
                                        void* out, void* lse, int BH, int Lq,
                                        int Lk, int D, float sm_scale,
                                        int causal, int window, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || Lq == 0) return 0;
  if (dtype == mxtt::kFloat32)
    return mxtt::dispatch<float>(D, q, k, v, lens, out, lse, BH, Lq, Lk,
                                 sm_scale, causal, window, s);
  if (dtype == mxtt::kBFloat16)
    return mxtt::dispatch<__nv_bfloat16>(D, q, k, v, lens, out, lse, BH, Lq,
                                         Lk, sm_scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
