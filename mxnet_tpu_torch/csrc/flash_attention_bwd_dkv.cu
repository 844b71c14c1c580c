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
// against 7 * L * D words moved once).  The block owns one key tile, so
// dK and dV need no atomics: this mirrors the TPU's split of the backward
// into a dQ pass and a dK/dV pass, with the TPU's sequential q-block grid
// axis as the loop inside the block over the query tiles that see the key
// tile (causal: at or below the diagonal; window: within reach).  A key
// tile at or past the key length writes zeros.  Two kernels, chosen by
// dtype:
//
// - bf16, flash_bwd_dkv_wgmma_kernel: the four products on the tensor
//   cores (flash_wgmma.cuh).  Grid (BH, ceil(Lk / 64)), one warpgroup of
//   128 threads.  K and V stay in shared memory as swizzled bf16 tiles;
//   Q, dO, LSE and Delta of each query tile stream through a two-stage
//   cp.async ring.  The block computes the transposed tiles S^T = K Q^T
//   and dP^T = V dO^T (both operands K-major), so the accumulator's rows
//   are keys and LSE and Delta are indexed by column; P^T and dS^T go
//   straight from registers, as bf16, into dV += P^T dO and dK += dS^T Q,
//   with dO and Q read MN-major.  Nothing round-trips through shared
//   memory.  What bounds it now: one warpgroup waits on each product in
//   turn, so an SM overlaps copies, products and exponentials only across
//   its resident blocks; at D = 128 the two 64 x 128 accumulators take
//   128 registers a thread.
// - fp32, flash_bwd_dkv_kernel: tensor cores take fp32 only as TF32, so
//   fp32 stays on the CUDA cores: 256 threads, tiles in shared memory as
//   fp32 with a row stride of D + 1, 4 x 4 micro-tiles of S and dP, P and
//   dS through shared memory, a 4-key x D/16 slice of dK and of dV per
//   thread.  Bound by the fp32 FMA rate and shared-memory reads.
#include "flash_wgmma.cuh"

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

template <int D>
__global__ void __launch_bounds__(wg::kThreads)
flash_bwd_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const int* __restrict__ lens,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int Lq, int Lk,
                           float sm_scale, int causal, int window) {
  constexpr int TILE = wg::tile_bytes<D>();
  constexpr int STATS = 2 * kBlockQ * sizeof(float);  // LSE, then Delta
  extern __shared__ uint8_t smem_u8[];
  const uint32_t sK = wg::aligned_base(smem_u8), sV = sK + TILE;
  const uint32_t sQ = sV + TILE, sDO = sQ + 2 * TILE;  // two stages each
  const uint32_t sStat = sDO + 2 * TILE;
  const float* stat = reinterpret_cast<const float*>(
      smem_u8 + (sStat - wg::smem_addr(smem_u8)));

  const int bh = blockIdx.x, k0 = blockIdx.y * kBlockK;
  const int tid = threadIdx.x, lane = tid % 32;
  const int kv_len = max(0, min(lens[bh], Lk));
  const size_t qoff = (size_t)bh * Lq, koff = (size_t)bh * Lk;
  const __nv_bfloat16* qb = q + qoff * D;
  const __nv_bfloat16* ob = dout + qoff * D;

  // this thread's accumulator rows (keys) row0 and row0 + 8 of the tile,
  // and its columns (query rows of a query tile) 8 j + col0 + c
  const int row0 = 16 * (tid / 32) + lane / 4, col0 = 2 * (lane % 4);
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // Q, dO, LSE and Delta of the query tile at q0 into stage st; each
  // thread copies one row statistic (4 bytes: rows are not 16-byte
  // aligned when Lq is odd)
  auto load_query_tile = [&](int q0, int st) {
    wg::load_tile_async<D>(sQ + st * TILE, qb, q0, Lq, tid);
    wg::load_tile_async<D>(sDO + st * TILE, ob, q0, Lq, tid);
    const int r = q0 + tid % kBlockQ;
    const float* src = (tid < kBlockQ ? lse : delta) + qoff;
    wg::cp_async4(sStat + st * STATS + tid * 4, src + (r < Lq ? r : 0),
                  r < Lq ? 4 : 0);
  };

  int q_begin = 0, n_tiles = 0;
  if (k0 < kv_len) {
    int q_end;
    query_range(k0, Lq, causal, window, &q_begin, &q_end);
    n_tiles = q_end > q_begin ? (q_end - q_begin + kBlockQ - 1) / kBlockQ
                              : 0;
  }
  if (n_tiles > 0) {
    wg::load_tile_async<D>(sK, k + koff * D, k0, Lk, tid);
    wg::load_tile_async<D>(sV, v + koff * D, k0, Lk, tid);
    load_query_tile(q_begin, 0);
  }
  wg::cp_async_commit();

  const float scale_log2 = sm_scale * 1.4426950408889634f;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = q_begin + t * kBlockQ, st = t & 1;
    const uint32_t stQ = sQ + st * TILE, stDO = sDO + st * TILE;
    if (t + 1 < n_tiles) load_query_tile(q0 + kBlockQ, st ^ 1);
    wg::cp_async_commit();
    wg::cp_async_wait<1>();  // everything but the tile just requested
    wg::fence_async_smem();
    __syncthreads();

    float s[32], dp[32];  // S^T and dP^T: rows keys, columns queries
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss_n64(s, wg::desc_k_major(sK, kk), wg::desc_k_major(stQ, kk),
                     kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss_n64(dp, wg::desc_k_major(sV, kk),
                     wg::desc_k_major(stDO, kk), kk > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);
    wg::fence_regs(dp);

    // register 4 j + 2 i + c is key k0 + row0 + 8 i, query row
    // q0 + 8 j + col0 + c: P^T into s, dS^T into dp
    const float* lse_t = stat + st * 2 * kBlockQ;
    const float* delta_t = lse_t + kBlockQ;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * j +
                                                         col0);
      const float2 d2 = *reinterpret_cast<const float2*>(delta_t + 8 * j +
                                                         col0);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float lse_log2 = (c ? l2.y : l2.x) * 1.4426950408889634f;
        const float row_delta = c ? d2.y : d2.x;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * j + 2 * i + c;
          const bool vis = visible(q0 + 8 * j + col0 + c, k0 + row0 + 8 * i,
                                   Lq, kv_len, causal, window);
          const float p =
              vis ? exp2f(fmaf(s[e], scale_log2, -lse_log2)) : 0.f;
          s[e] = p;
          dp[e] = p * (dp[e] - row_delta) * sm_scale;
        }
      }
    }
    uint32_t a_p[16], a_ds[16];
    wg::to_a_operand(s, a_p);
    wg::to_a_operand(dp, a_ds);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_rs(dv_acc, a_p + 4 * kk, wg::desc_mn_major(stDO, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_rs(dk_acc, a_ds + 4 * kk, wg::desc_mn_major(stQ, kk));
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(dv_acc);
    wg::fence_regs(dk_acc);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  wg::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = k0 + row0 + 8 * i;
    if (c >= Lk) continue;
    __nv_bfloat16* gk = dk + (koff + c) * D + col0;
    __nv_bfloat16* gv = dv + (koff + c) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int e = 4 * j + 2 * i;
      *reinterpret_cast<__nv_bfloat162*>(gk + 8 * j) =
          __floats2bfloat162_rn(dk_acc[e], dk_acc[e + 1]);
      *reinterpret_cast<__nv_bfloat162*>(gv + 8 * j) =
          __floats2bfloat162_rn(dv_acc[e], dv_acc[e + 1]);
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
  return launch_with_smem<flash_bwd_dkv_kernel<T, D>>(
      grid, smem, stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const int*>(lens), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), Lq, Lk, sm_scale, causal, window);
}

template <int D>
static int launch_wgmma(const void* q, const void* k, const void* v,
                        const void* dout, const void* lens, const void* lse,
                        const void* delta, void* dk, void* dv, int BH, int Lq,
                        int Lk, float sm_scale, int causal, int window,
                        cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  // K, V, two stages of Q and dO, two of LSE + Delta, alignment slack
  const size_t smem = 6 * wg::tile_bytes<D>() + 4 * kBlockQ * sizeof(float) +
                      1024;
  const dim3 grid(BH, (Lk + kBlockK - 1) / kBlockK);
  return launch_with_smem<flash_bwd_dkv_wgmma_kernel<D>, wg::kThreads>(
      grid, smem, stream,
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const int*>(lens), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Lq, Lk, sm_scale, causal, window);
}

// fp32: the CUDA-core kernel; bf16: the tensor-core kernel, whose
// 128-byte swizzled lines hold 64 columns (ops/flash_attention.py pads a
// bf16 head dim of 16 or 32 to 64 with zero columns before the launch).
static int dispatch(int dtype, int D, const void* q, const void* k,
                    const void* v, const void* dout, const void* lens,
                    const void* lse, const void* delta, void* dk, void* dv,
                    int BH, int Lq, int Lk, float sm_scale, int causal,
                    int window, cudaStream_t stream) {
#define MXTT_ARGS \
  q, k, v, dout, lens, lse, delta, dk, dv, BH, Lq, Lk, sm_scale, causal, \
      window, stream
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
// tensors: q, dout (BH, Lq, D); k, v, dk, dv (BH, Lk, D); lens (BH,)
// int32; lse, delta (BH, Lq) fp32.  Returns the launch's cudaError_t.
extern "C" int mxtt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lens, const void* lse, const void* delta, void* dk, void* dv,
    int BH, int Lq, int Lk, int D, float sm_scale, int causal, int window,
    int dtype, void* stream) {
  if (BH == 0 || Lk == 0) return 0;
  return mxtt::dispatch(dtype, D, q, k, v, dout, lens, lse, delta, dk, dv,
                        BH, Lq, Lk, sm_scale, causal, window,
                        static_cast<cudaStream_t>(stream));
}
