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
// - fp32, flash_bwd_dq_tf32_kernel: the three products on the tensor
//   cores as error-compensated 3xTF32 (flash_tf32.cuh), fp32-accurate at
//   a third of the TF32 rate.  Grid (BH, ceil(Lq / 64)), four warps of
//   mma.sync m16n8k8, each owning 16 query rows of the tile.  Q and dO
//   stay in shared memory as fp32 tiles (row stride D + 4); K and V
//   stream through a two-stage cp.async ring over the needed key tiles.
//   A warp computes its 16 x 64 S and dP, builds dS in the accumulator
//   registers (tiles every row sees whole skip the mask) and feeds it,
//   split into TF32 halves, as the A operand of dQ += dS K, reading K
//   transposed.  Every fragment is loaded as fp32 and split where it is
//   used.  What bounds it now: instruction issue and latency together
//   (PERF.md).  Each fp32 operand element costs a shared-memory
//   load and five instructions to split, several for every mma.sync, and
//   at 255 registers a thread an SM holds two blocks (eight warps); the
//   products run at about a quarter of the TF32 peak.
#include "flash_tf32.cuh"

namespace mxtt {

template <int D>
__global__ void __launch_bounds__(tf32::kThreads)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const int* __restrict__ lens,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int Lq, int Lk,
                         float sm_scale, int causal, int window) {
  constexpr int SD = tf32::stride<D>(), TILE = tf32::tile_floats<D>();
  constexpr int NT = D / 8;  // 8-column blocks of the head dim
  constexpr int NC = NT < 8 ? NT : 8;  // blocks of dQ summed a pass
  extern __shared__ float4 smem_f4[];
  float* const sQ = reinterpret_cast<float*>(smem_f4);
  float* const sDO = sQ + TILE;
  float* const sK = sDO + TILE;     // two stages
  float* const sV = sK + 2 * TILE;  // two stages

  const int bh = blockIdx.x, q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * (tid / 32);
  const int kv_len = max(0, min(lens[bh], Lk));
  const size_t qoff = (size_t)bh * Lq, koff = (size_t)bh * Lk;
  const float* kb = k + koff * D;
  const float* vb = v + koff * D;
  int k_begin, k_end;
  key_range(q0, Lq, kv_len, causal, window, &k_begin, &k_end);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBlockK - 1) /
                                            kBlockK : 0;

  tf32::load_tile_async<D>(wg::smem_addr(sQ), q + qoff * D, q0, Lq, tid);
  tf32::load_tile_async<D>(wg::smem_addr(sDO), dout + qoff * D, q0, Lq,
                           tid);
  if (n_tiles > 0) {
    tf32::load_tile_async<D>(wg::smem_addr(sK), kb, k_begin, Lk, tid);
    tf32::load_tile_async<D>(wg::smem_addr(sV), vb, k_begin, Lk, tid);
  }
  wg::cp_async_commit();

  // this lane's rows: r0 + g and r0 + g + 8 of the tile
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  float lse_log2[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + g + 8 * i;
    lse_log2[i] = r < Lq ? lse[qoff + r] * 1.4426950408889634f : 0.f;
    row_delta[i] = r < Lq ? delta[qoff + r] : 0.f;
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kBlockK;
    const float* tK = sK + (it & 1) * TILE;
    const float* tV = sV + (it & 1) * TILE;
    if (it + 1 < n_tiles) {
      const int nx = ((it + 1) & 1) * TILE;
      tf32::load_tile_async<D>(wg::smem_addr(sK + nx), kb, k0 + kBlockK, Lk,
                               tid);
      tf32::load_tile_async<D>(wg::smem_addr(sV + nx), vb, k0 + kBlockK, Lk,
                               tid);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<1>();  // everything but the tile just requested
    __syncthreads();

    // S = Q K^T, then P in place: register [j][2 i + c] is row
    // r0 + g + 8 i, key k0 + 8 j + 2 t + c; P is exactly 0 where the mask
    // is false (tiles every row sees whole skip the mask)
    float s[8][4];
    tf32::tile_abt<D, 8>(s, sQ, r0, tK, 0, g, t);
    auto make_p = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[j][2 * i + c];
            x = exp2f(fmaf(x, scale_log2, -lse_log2[i]));
            if (decltype(masked)::value &&
                !visible(q0 + r0 + g + 8 * i, k0 + 8 * j + 2 * t + c, Lq,
                         kv_len, causal, window))
              x = 0.f;
          }
    };
    if (tf32::tile_whole(q0, k0, Lq, kv_len, causal, window))
      make_p(std::false_type{});
    else
      make_p(std::true_type{});

    // dP = dO V^T, then dS = P (dP - Delta) scale in place of P
    float dp[8][4];
    tf32::tile_abt<D, 8>(dp, sDO, r0, tV, 0, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] *= (dp[j][e] - row_delta[e / 2]) * sm_scale;

    // dQ += dS K: k-step j takes keys 8 j .. 8 j + 7 of the tile; the
    // tile's products go to a fresh accumulator (NC column blocks at a
    // time), added to dQ once per tile (flash_tf32.cuh, accumulation)
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += NC) {
      float part[NC][4] = {};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        tf32::FragA a;
        tf32::acc_as_a(a, s[j]);
        const float* pk = tK + (8 * j + 2 * t) * SD + 8 * n0 + g;
#pragma unroll
        for (int n = 0; n < NC; ++n)
          tf32::mma_3xtf32(part[n], a, pk[8 * n], pk[SD + 8 * n]);
      }
      tf32::add_to(acc, part, n0);
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  wg::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + g + 8 * i;
    if (r >= Lq) continue;
    float* o = dq + (qoff + r) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
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

template <int D>
static int launch_tf32(const void* q, const void* k, const void* v,
                       const void* dout, const void* lens, const void* lse,
                       const void* delta, void* dq, int BH, int Lq, int Lk,
                       float sm_scale, int causal, int window,
                       cudaStream_t stream) {
  // Q and dO, two stages of K and of V
  const size_t smem = 6 * tf32::tile_floats<D>() * sizeof(float);
  const dim3 grid(BH, (Lq + kBlockQ - 1) / kBlockQ);
  return launch_with_smem<flash_bwd_dq_tf32_kernel<D>, tf32::kThreads>(
      grid, smem, stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const int*>(lens),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), Lq, Lk, sm_scale, causal, window);
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

// fp32: the 3xTF32 mma.sync kernel; bf16: the wgmma kernel, whose
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
