// Flash-attention backward, dQ pass (B2), for Hopper (sm_90a), CUDA C++.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py, _bwd_dq_kernel (:144)
// launched by _flash_bwd (:318) through _run (pl.pallas_call, :265).
// FlashAttention-2 dQ: for each query tile, over the key tiles it needs,
// recompute S = Q K^T * scale and P = exp(S - LSE) (exactly 0 where the
// mask is false), dP = dO V^T, dS = P * (dP - Delta) * scale, and
// accumulate dQ += dS K in fp32; dS is rounded to the storage dtype
// before its product, as the Pallas kernel does (:183).  Delta =
// rowsum(dO * O) comes from the wrapper.
//
// What bounds it on an H100: operations (6 * L^2 * D flops per (b, h)
// against 5 * L * D inputs read once); this simple design runs them on
// the CUDA cores in fp32 whatever the storage dtype.
//
// Design: grid (BH, ceil(Lq / 64)), 256 threads; the block owns one
// query tile, so dQ needs no atomics.  Q and dO stay in shared memory;
// the loop over needed key tiles (the same `needed` rule as B1) stages K
// and V, each thread computes 4 x 4 micro-tiles of S and dP in one pass
// over D, writes dS to shared memory and accumulates a 4 x D/16 slice of
// dQ.
#include "flash_common.cuh"

namespace mxtt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const int* __restrict__ lens,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Lq, int Lk, float sm_scale, int causal, int window) {
  constexpr int DP = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                  // 64 x DP
  float* sDO = sQ + kBlockQ * DP;    // 64 x DP
  float* sK = sDO + kBlockQ * DP;    // 64 x DP
  float* sV = sK + kBlockK * DP;     // 64 x DP
  float* sDS = sV + kBlockK * DP;    // 64 x kSStride

  const int bh = blockIdx.x, q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kv_len = max(0, min(lens[bh], Lk));
  const size_t qoff = (size_t)bh * Lq, koff = (size_t)bh * Lk;

  load_tile<T, D>(sQ, q + qoff * D, q0, Lq, tid);
  load_tile<T, D>(sDO, dout + qoff * D, q0, Lq, tid);
  float row_lse[4], row_delta[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    row_lse[i] = r < Lq ? lse[qoff + r] : 0.f;
    row_delta[i] = r < Lq ? delta[qoff + r] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int k_begin, k_end;
  key_range(q0, Lq, kv_len, causal, window, &k_begin, &k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();
    load_tile<T, D>(sK, k + koff * D, k0, Lk, tid);
    load_tile<T, D>(sV, v + koff * D, k0, Lk, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_abt<D>(s, sQ, sK, ty, tx);
    tile_abt<D>(dp, sDO, sV, ty, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const float p = visible(r, c, Lq, kv_len, causal, window)
                            ? expf(s[i][j] * sm_scale - row_lse[i])
                            : 0.f;
        const float ds = p * (dp[i][j] - row_delta[i]) * sm_scale;
        sDS[(ty + 16 * i) * kSStride + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sDS[(ty + 16 * i) * kSStride + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kk = sK[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += ds[i] * kk;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Lq) continue;
    T* o = dq + (qoff + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v,
                  const void* dout, const void* lens, const void* lse,
                  const void* delta, void* dq, int BH, int Lq, int Lk,
                  float sm_scale, int causal, int window,
                  cudaStream_t stream) {
  const size_t smem =
      (size_t)(4 * kBlockQ * (D + 1) + kBlockQ * kSStride) * sizeof(float);
  const dim3 grid(BH, (Lq + kBlockQ - 1) / kBlockQ);
  return launch_with_smem(
      flash_bwd_dq_kernel<T, D>, grid, smem, stream, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const int*>(lens),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Lq, Lk, sm_scale, causal, window);
}

template <typename T>
static int dispatch(int D, const void* q, const void* k, const void* v,
                    const void* dout, const void* lens, const void* lse,
                    const void* delta, void* dq, int BH, int Lq, int Lk,
                    float sm_scale, int causal, int window,
                    cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, dout, lens, lse, delta, dq, BH, Lq, Lk,
                           sm_scale, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, dout, lens, lse, delta, dq, BH, Lq, Lk,
                            sm_scale, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mxtt

// Plain C entry point (bound with ctypes).  Device pointers of contiguous
// tensors: q, dout, dq (BH, Lq, D); k, v (BH, Lk, D); lens (BH,) int32;
// lse, delta (BH, Lq) fp32.  Returns the launch's cudaError_t.
extern "C" int mxtt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lens, const void* lse, const void* delta, void* dq, int BH,
    int Lq, int Lk, int D, float sm_scale, int causal, int window, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || Lq == 0) return 0;
  if (dtype == mxtt::kFloat32)
    return mxtt::dispatch<float>(D, q, k, v, dout, lens, lse, delta, dq, BH,
                                 Lq, Lk, sm_scale, causal, window, s);
  if (dtype == mxtt::kBFloat16)
    return mxtt::dispatch<__nv_bfloat16>(D, q, k, v, dout, lens, lse, delta,
                                         dq, BH, Lq, Lk, sm_scale, causal,
                                         window, s);
  return (int)cudaErrorInvalidValue;
}
