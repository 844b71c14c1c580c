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
// - fp32, flash_bwd_dkv_tf32_kernel: the four products on the tensor
//   cores as error-compensated 3xTF32 (flash_tf32.cuh), fp32-accurate at
//   a third of the TF32 rate.  Grid (BH, ceil(Lk / 64)), four warps of
//   mma.sync m16n8k8, each owning 16 keys of the tile.  K and V stay in
//   shared memory as fp32 tiles (row stride D + 4); Q, dO, LSE and Delta
//   of each query tile stream through a two-stage cp.async ring.  As in
//   the bf16 kernel a warp computes the transposed S^T = K Q^T and
//   dP^T = V dO^T (rows keys, columns queries), builds P^T and dS^T in
//   the accumulator registers and feeds them, split into TF32 halves, as
//   the A operands of dV += P^T dO and dK += dS^T Q, reading dO and Q
//   transposed.  At D >= 64 it does so for 32 query columns at a time,
//   so that S^T, dP^T and the two 16 x D accumulators fit in registers.
//   What bounds it now: as fp32 B2, instruction issue (a load and five
//   instructions to split each operand element) and latency at two
//   blocks an SM (PERF.md).
#include "flash_tf32.cuh"

namespace mxtt {

template <int D>
__global__ void __launch_bounds__(tf32::kThreads)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const int* __restrict__ lens,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int Lq, int Lk, float sm_scale, int causal,
                          int window) {
  constexpr int SD = tf32::stride<D>(), TILE = tf32::tile_floats<D>();
  constexpr int NT = D / 8;                // 8-column blocks of the head dim
  constexpr int NQ = D < 64 ? 64 : 32;     // query columns a pass
  constexpr int NJ = NQ / 8;
  constexpr int NC = NT < 4 ? NT : 4;      // blocks of dK, dV summed a pass
  extern __shared__ float4 smem_f4[];
  float* const sK = reinterpret_cast<float*>(smem_f4);
  float* const sV = sK + TILE;
  float* const sQ = sV + TILE;             // two stages
  float* const sDO = sQ + 2 * TILE;        // two stages
  float* const sStat = sDO + 2 * TILE;     // two stages of LSE, Delta
  const uint32_t aStat = wg::smem_addr(sStat);

  const int bh = blockIdx.x, k0 = blockIdx.y * kBlockK;
  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * (tid / 32);
  const int kv_len = max(0, min(lens[bh], Lk));
  const size_t qoff = (size_t)bh * Lq, koff = (size_t)bh * Lk;
  const float* qb = q + qoff * D;
  const float* ob = dout + qoff * D;

  // this lane's accumulator rows are keys k0 + r0 + g and k0 + r0 + g + 8
  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // Q, dO, LSE and Delta of the query tile at q0 into stage st; each
  // thread copies one row statistic (4 bytes: rows are not 16-byte
  // aligned when Lq is odd)
  auto load_query_tile = [&](int q0, int st) {
    tf32::load_tile_async<D>(wg::smem_addr(sQ + st * TILE), qb, q0, Lq,
                             tid);
    tf32::load_tile_async<D>(wg::smem_addr(sDO + st * TILE), ob, q0, Lq,
                             tid);
    const int r = q0 + tid % kBlockQ;
    const float* src = (tid < kBlockQ ? lse : delta) + qoff;
    wg::cp_async4(aStat + st * tf32::kStatsBytes + tid * 4,
                  src + (r < Lq ? r : 0), r < Lq ? 4 : 0);
  };

  int q_begin = 0, n_tiles = 0;
  if (k0 < kv_len) {
    int q_end;
    query_range(k0, Lq, causal, window, &q_begin, &q_end);
    n_tiles = q_end > q_begin ? (q_end - q_begin + kBlockQ - 1) / kBlockQ
                              : 0;
  }
  if (n_tiles > 0) {
    tf32::load_tile_async<D>(wg::smem_addr(sK), k + koff * D, k0, Lk, tid);
    tf32::load_tile_async<D>(wg::smem_addr(sV), v + koff * D, k0, Lk, tid);
    load_query_tile(q_begin, 0);
  }
  wg::cp_async_commit();

  const float scale_log2 = sm_scale * 1.4426950408889634f;
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * kBlockQ, st = it & 1;
    const float* tQ = sQ + st * TILE;
    const float* tDO = sDO + st * TILE;
    const float* lse_t = sStat + st * 2 * kBlockQ;
    const float* delta_t = lse_t + kBlockQ;
    if (it + 1 < n_tiles) load_query_tile(q0 + kBlockQ, st ^ 1);
    wg::cp_async_commit();
    wg::cp_async_wait<1>();  // everything but the tile just requested
    __syncthreads();
    const bool whole = tf32::tile_whole(q0, k0, Lq, kv_len, causal, window);

#pragma unroll 1
    for (int c0 = 0; c0 < kBlockQ; c0 += NQ) {
      // S^T = K Q^T over query columns c0 .. c0 + NQ - 1, then P^T in
      // place: register [j][2 i + c] is key k0 + r0 + g + 8 i, query row
      // q0 + c0 + 8 j + 2 t + c; P is exactly 0 where the mask is false
      float s[NJ][4];
      tf32::tile_abt<D, NJ>(s, sK, r0, tQ, c0, g, t);
      auto make_p = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = c0 + 8 * j + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float lse_log2 = (c ? l2.y : l2.x) * 1.4426950408889634f;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float& x = s[j][2 * i + c];
              x = exp2f(fmaf(x, scale_log2, -lse_log2));
              if (decltype(masked)::value &&
                  !visible(q0 + col + c, k0 + r0 + g + 8 * i, Lq, kv_len,
                           causal, window))
                x = 0.f;
            }
          }
        }
      };
      if (whole)
        make_p(std::false_type{});
      else
        make_p(std::true_type{});

      // dP^T = V dO^T, then dS^T = P^T (dP^T - Delta) scale in its place
      float dp[NJ][4];
      tf32::tile_abt<D, NJ>(dp, sV, r0, tDO, c0, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(delta_t + c0 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = s[j][e] * (dp[j][e] - (e % 2 ? d2.y : d2.x)) * sm_scale;
      }

      // dV += P^T dO and dK += dS^T Q: k-step j takes query rows
      // c0 + 8 j .. c0 + 8 j + 7 of the tile; the pass's products go to
      // fresh accumulators (NC column blocks at a time), added to dV and
      // dK once per pass (flash_tf32.cuh, accumulation)
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += NC) {
        float part_v[NC][4] = {}, part_k[NC][4] = {};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          tf32::FragA ap, ads;
          tf32::acc_as_a(ap, s[j]);
          tf32::acc_as_a(ads, dp[j]);
          const int o = (c0 + 8 * j + 2 * t) * SD + 8 * n0 + g;
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            tf32::mma_3xtf32(part_v[n], ap, tDO[o + 8 * n],
                             tDO[o + SD + 8 * n]);
            tf32::mma_3xtf32(part_k[n], ads, tQ[o + 8 * n],
                             tQ[o + SD + 8 * n]);
          }
        }
        tf32::add_to(dv_acc, part_v, n0);
        tf32::add_to(dk_acc, part_k, n0);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  wg::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = k0 + r0 + g + 8 * i;
    if (c >= Lk) continue;
    float* gk = dk + (koff + c) * D + 2 * t;
    float* gv = dv + (koff + c) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<float2*>(gk + 8 * n) =
          make_float2(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      *reinterpret_cast<float2*>(gv + 8 * n) =
          make_float2(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
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

template <int D>
static int launch_tf32(const void* q, const void* k, const void* v,
                       const void* dout, const void* lens, const void* lse,
                       const void* delta, void* dk, void* dv, int BH, int Lq,
                       int Lk, float sm_scale, int causal, int window,
                       cudaStream_t stream) {
  // K and V, two stages of Q, dO and LSE + Delta
  const size_t smem = 6 * tf32::tile_floats<D>() * sizeof(float) +
                      2 * tf32::kStatsBytes;
  const dim3 grid(BH, (Lk + kBlockK - 1) / kBlockK);
  return launch_with_smem<flash_bwd_dkv_tf32_kernel<D>, tf32::kThreads>(
      grid, smem, stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const int*>(lens),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), Lq, Lk, sm_scale,
      causal, window);
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

// fp32: the 3xTF32 mma.sync kernel; bf16: the wgmma kernel, whose
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
  if (dtype == kFloat32 && D == 16) return launch_tf32<16>(MXTT_ARGS);
  if (dtype == kFloat32 && D == 32) return launch_tf32<32>(MXTT_ARGS);
  if (dtype == kFloat32 && D == 64) return launch_tf32<64>(MXTT_ARGS);
  if (dtype == kFloat32 && D == 128) return launch_tf32<128>(MXTT_ARGS);
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
