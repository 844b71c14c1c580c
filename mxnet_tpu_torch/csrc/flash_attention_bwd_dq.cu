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
// against 5 * L * D inputs read once).  Two kernels, chosen by dtype:
//
// - bf16, flash_bwd_dq_wgmma_kernel: the three products on the tensor
//   cores (flash_wgmma.cuh).  Grid (BH, ceil(Lq / 64)), one warpgroup of
//   128 threads per 64-row query tile, so dQ needs no atomics.  Q and dO
//   stay in shared memory as swizzled bf16 tiles; K and V stream through
//   a two-stage cp.async ring over the needed key tiles (the `needed`
//   rule of B1), the next tile's copy in flight while this tile's
//   products run.  S and dP are m64n64k16 products with both operands
//   K-major in shared memory; dS is built in the accumulator's registers,
//   rounded to bf16 and fed as the register A operand of dQ += dS K, whose
//   B operand is the K tile read MN-major.  What bounds it now: one
//   warpgroup waits on each product in turn (copy, S and dP, the
//   exponentials, dQ), so an SM overlaps them only across its resident
//   blocks.
// - fp32, flash_bwd_dq_kernel: tensor cores take fp32 only as TF32 (about
//   three decimal digits), so fp32 stays on the CUDA cores: 256 threads,
//   tiles staged in shared memory as fp32 with a row stride of D + 1,
//   4 x 4 micro-tiles of S and dP in one pass over D, dS through shared
//   memory, a 4 x D/16 slice of dQ per thread.  Bound by the fp32 FMA
//   rate and shared-memory reads.
#include "flash_wgmma.cuh"

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

template <int D>
__global__ void __launch_bounds__(wg::kThreads)
flash_bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const int* __restrict__ lens,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int Lq, int Lk,
                          float sm_scale, int causal, int window) {
  constexpr int TILE = wg::tile_bytes<D>();
  extern __shared__ uint8_t smem_u8[];
  const uint32_t sQ = wg::aligned_base(smem_u8), sDO = sQ + TILE;
  const uint32_t sK = sDO + TILE, sV = sK + 2 * TILE;  // two stages each

  const int bh = blockIdx.x, q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x, lane = tid % 32;
  const int kv_len = max(0, min(lens[bh], Lk));
  const size_t qoff = (size_t)bh * Lq, koff = (size_t)bh * Lk;
  const __nv_bfloat16* kb = k + koff * D;
  const __nv_bfloat16* vb = v + koff * D;
  int k_begin, k_end;
  key_range(q0, Lq, kv_len, causal, window, &k_begin, &k_end);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBlockK - 1) /
                                            kBlockK : 0;

  wg::load_tile_async<D>(sQ, q + qoff * D, q0, Lq, tid);
  wg::load_tile_async<D>(sDO, dout + qoff * D, q0, Lq, tid);
  if (n_tiles > 0) {
    wg::load_tile_async<D>(sK, kb, k_begin, Lk, tid);
    wg::load_tile_async<D>(sV, vb, k_begin, Lk, tid);
  }
  wg::cp_async_commit();

  // this thread's accumulator rows: row0 and row0 + 8 of the tile
  const int row0 = 16 * (tid / 32) + lane / 4, col0 = 2 * (lane % 4);
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  float lse_log2[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + row0 + 8 * i;
    lse_log2[i] = r < Lq ? lse[qoff + r] * 1.4426950408889634f : 0.f;
    row_delta[i] = r < Lq ? delta[qoff + r] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kBlockK;
    const uint32_t stK = sK + (t & 1) * TILE, stV = sV + (t & 1) * TILE;
    if (t + 1 < n_tiles) {
      const uint32_t nx = ((t + 1) & 1) * TILE;
      wg::load_tile_async<D>(sK + nx, kb, k0 + kBlockK, Lk, tid);
      wg::load_tile_async<D>(sV + nx, vb, k0 + kBlockK, Lk, tid);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<1>();  // everything but the tile just requested
    wg::fence_async_smem();
    __syncthreads();

    float s[32], dp[32];
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss_n64(s, wg::desc_k_major(sQ, kk), wg::desc_k_major(stK, kk),
                     kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss_n64(dp, wg::desc_k_major(sDO, kk),
                     wg::desc_k_major(stV, kk), kk > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);
    wg::fence_regs(dp);

    // dS in the accumulator layout: register 4 j + 2 i + c is row
    // row0 + 8 i, key k0 + 8 j + col0 + c
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          const bool vis = visible(q0 + row0 + 8 * i, k0 + 8 * j + col0 + c,
                                   Lq, kv_len, causal, window);
          const float p =
              vis ? exp2f(fmaf(s[e], scale_log2, -lse_log2[i])) : 0.f;
          s[e] = p * (dp[e] - row_delta[i]) * sm_scale;
        }
    uint32_t a[16];
    wg::to_a_operand(s, a);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_rs(acc, a + 4 * kk, wg::desc_mn_major(stK, kk));
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(acc);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  wg::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + row0 + 8 * i;
    if (r >= Lq) continue;
    __nv_bfloat16* o = dq + (qoff + r) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
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
  return launch_with_smem<flash_bwd_dq_kernel<T, D>>(
      grid, smem, stream, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const int*>(lens),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Lq, Lk, sm_scale, causal, window);
}

template <int D>
static int launch_wgmma(const void* q, const void* k, const void* v,
                        const void* dout, const void* lens, const void* lse,
                        const void* delta, void* dq, int BH, int Lq, int Lk,
                        float sm_scale, int causal, int window,
                        cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = 6 * wg::tile_bytes<D>() + 1024;  // + alignment slack
  const dim3 grid(BH, (Lq + kBlockQ - 1) / kBlockQ);
  return launch_with_smem<flash_bwd_dq_wgmma_kernel<D>, wg::kThreads>(
      grid, smem, stream,
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const int*>(lens), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Lq, Lk,
      sm_scale, causal, window);
}

// fp32: the CUDA-core kernel; bf16: the tensor-core kernel, whose
// 128-byte swizzled lines hold 64 columns (ops/flash_attention.py pads a
// bf16 head dim of 16 or 32 to 64 with zero columns before the launch).
static int dispatch(int dtype, int D, const void* q, const void* k,
                    const void* v, const void* dout, const void* lens,
                    const void* lse, const void* delta, void* dq, int BH,
                    int Lq, int Lk, float sm_scale, int causal, int window,
                    cudaStream_t stream) {
#define MXTT_ARGS \
  q, k, v, dout, lens, lse, delta, dq, BH, Lq, Lk, sm_scale, causal, window, \
      stream
  if (dtype == kFloat32 && D == 16) return launch<float, 16>(MXTT_ARGS);
  if (dtype == kFloat32 && D == 32) return launch<float, 32>(MXTT_ARGS);
  if (dtype == kFloat32 && D == 64) return launch<float, 64>(MXTT_ARGS);
  if (dtype == kFloat32 && D == 128) return launch<float, 128>(MXTT_ARGS);
  if (dtype == kBFloat16 && D == 64) return launch_wgmma<64>(MXTT_ARGS);
  if (dtype == kBFloat16 && D == 128) return launch_wgmma<128>(MXTT_ARGS);
#undef MXTT_ARGS
  return (int)cudaErrorInvalidValue;
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
  if (BH == 0 || Lq == 0) return 0;
  return mxtt::dispatch(dtype, D, q, k, v, dout, lens, lse, delta, dq, BH,
                        Lq, Lk, sm_scale, causal, window,
                        static_cast<cudaStream_t>(stream));
}
