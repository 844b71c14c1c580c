// Flash-attention backward, dK/dV pass (B3), for Hopper (sm_90a), CUDA C++.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py, _bwd_dkv_kernel (:191)
// launched by _flash_bwd (:331) through _run (pl.pallas_call, :265).
// FlashAttention-2 dK/dV: for each key tile, over the query tiles that
// see it, recompute P = exp(Q K^T * scale - LSE) (exactly 0 where the
// mask is false), dP = dO V^T and dS = P * (dP - Delta) * scale, and
// accumulate dV += P^T dO and dK += dS^T Q in fp32.  P and dS are rounded
// to the storage dtype before their products (:227, :234).
//
// What bounds it on an H100: operations (8 * L^2 * D flops per (b, h)
// against 7 * L * D words moved once), run on the CUDA cores in fp32.
//
// Design: grid (BH, ceil(Lk / 64)), 256 threads.  The block owns one key
// tile, so dK and dV need no atomics: this mirrors the TPU's split of the
// backward into a dQ pass and a dK/dV pass, with the TPU's sequential
// q-block grid axis as the loop inside the block.  K and V stay in shared
// memory; the loop stages Q, dO, LSE and Delta of each needed query tile
// (causal: at or below the diagonal; window: within reach), computes 4 x 4
// micro-tiles of S and dP, writes P and dS to shared memory and
// accumulates a 4-key x D/16 slice of dK and of dV per thread.  A key tile
// at or past the key length writes zeros.
#include "flash_common.cuh"

namespace mxtt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const int* __restrict__ lens,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Lq, int Lk, float sm_scale,
                     int causal, int window) {
  constexpr int DP = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;                  // 64 x DP
  float* sV = sK + kBlockK * DP;     // 64 x DP
  float* sQ = sV + kBlockK * DP;     // 64 x DP
  float* sDO = sQ + kBlockQ * DP;    // 64 x DP
  float* sP = sDO + kBlockQ * DP;    // 64 x kSStride (query row, key)
  float* sDS = sP + kBlockQ * kSStride;
  float* sLse = sDS + kBlockQ * kSStride;  // 64
  float* sDelta = sLse + kBlockQ;          // 64

  const int bh = blockIdx.x, k0 = blockIdx.y * kBlockK;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kv_len = max(0, min(lens[bh], Lk));
  const size_t qoff = (size_t)bh * Lq, koff = (size_t)bh * Lk;

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  if (k0 < kv_len) {
    load_tile<T, D>(sK, k + koff * D, k0, Lk, tid);
    load_tile<T, D>(sV, v + koff * D, k0, Lk, tid);
    int q_begin, q_end;
    query_range(k0, Lq, causal, window, &q_begin, &q_end);
    for (int q0 = q_begin; q0 < q_end; q0 += kBlockQ) {
      __syncthreads();
      load_tile<T, D>(sQ, q + qoff * D, q0, Lq, tid);
      load_tile<T, D>(sDO, dout + qoff * D, q0, Lq, tid);
      if (tid < kBlockQ) {
        const int r = q0 + tid;
        sLse[tid] = r < Lq ? lse[qoff + r] : 0.f;
        sDelta[tid] = r < Lq ? delta[qoff + r] : 0.f;
      }
      __syncthreads();

      // rows ty + 16 i of the query tile, keys tx + 16 j of this key tile
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      tile_abt<D>(s, sQ, sK, ty, tx);
      tile_abt<D>(dp, sDO, sV, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rl = ty + 16 * i, r = q0 + rl;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl = tx + 16 * j;
          const float p = visible(r, k0 + cl, Lq, kv_len, causal, window)
                              ? expf(s[i][j] * sm_scale - sLse[rl])
                              : 0.f;
          const float ds = p * (dp[i][j] - sDelta[rl]) * sm_scale;
          sP[rl * kSStride + cl] = round_to<T>(p);
          sDS[rl * kSStride + cl] = round_to<T>(ds);
        }
      }
      __syncthreads();

      // keys ty + 16 i, head-dim columns tx + 16 j
      const int rows = min(kBlockQ, Lq - q0);
#pragma unroll 2
      for (int r = 0; r < rows; ++r) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = sP[r * kSStride + ty + 16 * i];
          ds[i] = sDS[r * kSStride + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float o = sDO[r * DP + tx + 16 * j];
          const float qq = sQ[r * DP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][j] += p[i] * o;
            dk_acc[i][j] += ds[i] * qq;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= Lk) continue;
    T* gk = dk + (koff + c) * D;
    T* gv = dv + (koff + c) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      gk[tx + 16 * j] = from_float<T>(dk_acc[i][j]);
      gv[tx + 16 * j] = from_float<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v,
                  const void* dout, const void* lens, const void* lse,
                  const void* delta, void* dk, void* dv, int BH, int Lq,
                  int Lk, float sm_scale, int causal, int window,
                  cudaStream_t stream) {
  const size_t smem = (size_t)(4 * kBlockQ * (D + 1) +
                               2 * kBlockQ * kSStride + 2 * kBlockQ) *
                      sizeof(float);
  const dim3 grid(BH, (Lk + kBlockK - 1) / kBlockK);
  return launch_with_smem(
      flash_bwd_dkv_kernel<T, D>, grid, smem, stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const int*>(lens), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), Lq, Lk, sm_scale, causal, window);
}

template <typename T>
static int dispatch(int D, const void* q, const void* k, const void* v,
                    const void* dout, const void* lens, const void* lse,
                    const void* delta, void* dk, void* dv, int BH, int Lq,
                    int Lk, float sm_scale, int causal, int window,
                    cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, dout, lens, lse, delta, dk, dv, BH, Lq,
                           Lk, sm_scale, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, dout, lens, lse, delta, dk, dv, BH, Lq,
                            Lk, sm_scale, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mxtt

// Plain C entry point (bound with ctypes).  Device pointers of contiguous
// tensors: q, dout (BH, Lq, D); k, v, dk, dv (BH, Lk, D); lens (BH,)
// int32; lse, delta (BH, Lq) fp32.  Returns the launch's cudaError_t.
extern "C" int mxtt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lens, const void* lse, const void* delta, void* dk, void* dv,
    int BH, int Lq, int Lk, int D, float sm_scale, int causal, int window,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || Lk == 0) return 0;
  if (dtype == mxtt::kFloat32)
    return mxtt::dispatch<float>(D, q, k, v, dout, lens, lse, delta, dk, dv,
                                 BH, Lq, Lk, sm_scale, causal, window, s);
  if (dtype == mxtt::kBFloat16)
    return mxtt::dispatch<__nv_bfloat16>(D, q, k, v, dout, lens, lse, delta,
                                         dk, dv, BH, Lq, Lk, sm_scale, causal,
                                         window, s);
  return (int)cudaErrorInvalidValue;
}
