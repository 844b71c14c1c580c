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
// flops on them, ~170 flops per fp32 byte.  Two kernels, chosen by dtype:
//
// - bf16, flash_fwd_wgmma_kernel: both products on the tensor cores
//   (flash_wgmma.cuh), B2's loop with one product fewer.  Grid
//   (BH, ceil(Lq / 64)), one warpgroup of 128 threads per 64-row query
//   tile.  Q stays in shared memory as a swizzled bf16 tile; K and V
//   stream through a two-stage cp.async ring over the key tiles the
//   `needed` rule keeps (key length, causal diagonal, window; the rest
//   are never read), the next tile's copy in flight while this tile's
//   products run.  S = Q K^T is an m64n64k16 product with both operands
//   K-major in shared memory.  The online softmax runs on the
//   accumulator's registers in the log2 domain (ex2.approx): a row's 64
//   scores sit in the four lanes of a quad, so its max takes two xor
//   shuffles, and each lane keeps its own share of the denominator until
//   the epilogue; a tile that every row sees whole skips the mask.  P is
//   rounded to bf16 in registers and is the A operand of O += P V, whose
//   B operand is the V tile read MN-major (N = D).  What bounds it now:
//   no one part.  Per 64-key tile an SM spends about three times the
//   tensor-core or exponential time of the tile; leaving out the softmax,
//   the P V product or the K/V streaming each saves only 10-17%, and
//   issuing the next tile's S beside this tile's P V (FA3's overlap), two
//   warpgroups per 128-row tile, or deeper rings were no faster (PERF.md).
// - fp32, flash_fwd_kernel: on the CUDA cores (fp32 B2 and B3 run
//   fp32-accurate 3xTF32 on the tensor cores, flash_tf32.cuh, which this
//   kernel does not use yet: ROADMAP Queue B): 256 threads
//   per 64-row query tile; Q, K and V tiles in shared memory as fp32 with
//   a row stride of D + 1; each thread computes a 4 x 4 micro-tile of S,
//   the running max / denominator of its 4 rows and a 4 x D/16 slice of
//   the output accumulator; P goes through shared memory for P V.  Bound
//   by the fp32 FMA rate and shared-memory reads.
//
// Masked entries contribute exactly 0; a row that sees no key writes
// O = 0 and LSE = -1e30.  Rows past Lq and keys past Lk are masked here,
// so the wrapper pads only a bf16 head dim under 64 (to the 64 columns of
// a swizzled line, ops/flash_attention.py).
#include "flash_wgmma.cuh"

namespace mxtt {

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ lens,
                 float* __restrict__ out, float* __restrict__ lse, int Lq,
                 int Lk, float sm_scale, int causal, int window) {
  constexpr int DP = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                  // 64 x DP
  float* sK = sQ + kBlockQ * DP;     // 64 x DP
  float* sV = sK + kBlockK * DP;     // 64 x DP
  float* sP = sV + kBlockK * DP;     // 64 x kSStride

  const int bh = blockIdx.x, q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kv_len = max(0, min(lens[bh], Lk));
  const float* qb = q + (size_t)bh * Lq * D;
  const float* kb = k + (size_t)bh * Lk * D;
  const float* vb = v + (size_t)bh * Lk * D;

  load_tile<float, D>(sQ, qb, q0, Lq, tid);
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
    load_tile<float, D>(sK, kb, k0, Lk, tid);
    load_tile<float, D>(sV, vb, k0, Lk, tid);
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
        sP[(ty + 16 * i) * kSStride + tx + 16 * j] = p;
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
    float* o = out + ((size_t)bh * Lq + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      o[tx + 16 * j] = empty ? 0.f : acc[i][j] / l[i];
    if (tx == 0)
      lse[(size_t)bh * Lq + r] = empty ? kMaskValue : m[i] + logf(l[i]);
  }
}

// ------------------------------------------------------------- bf16, wgmma
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the special-function unit, denormal results flushed to zero (a
// P under 2^-126 adds nothing a bf16 P V could keep).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One key tile's online-softmax step on the S accumulator of an m64n64
// product: register 4 j + 2 i + c is query row qr + 8 i, key kc + 8 j + c.
// Scales the visible scores into the log2 domain, updates the running max
// m (log2 domain, the same in the four lanes of a quad) and this lane's
// share of the denominator l of the thread's two rows, leaves
// P = exp2(s - m) in s (exactly 0 where the mask is false) and the factor
// corr that the O accumulator must be scaled by.  A row that sees no key
// of the tile keeps m and l (corr = exp2(0) = 1, also while m is still the
// -1e30 sentinel).  kAll: every key of the tile is visible to every row
// (no mask to test).
template <bool kAll>
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int qr, int kc, int Lq,
                                             int kv_len, int causal,
                                             int window, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t vis = 0;
    float mx = __int_as_float(0xff800000u);  // -inf
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        if (kAll || visible(qr + 8 * i, kc + 8 * j + c, Lq, kv_len, causal,
                            window)) {
          vis |= 1u << (2 * j + c);
          s[e] *= scale_log2;
          mx = fmaxf(mx, s[e]);
        }
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    corr[i] = ex2(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        s[e] = kAll || (vis >> (2 * j + c)) & 1u ? ex2(s[e] - m_new) : 0.f;
        sum += s[e];
      }
    l[i] = l[i] * corr[i] + sum;
    m[i] = m_new;
  }
}

template <int D>
__global__ void __launch_bounds__(wg::kThreads)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ lens,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int Lq, int Lk,
                       float sm_scale, int causal, int window) {
  constexpr int TILE = wg::tile_bytes<D>();
  extern __shared__ uint8_t smem_u8[];
  const uint32_t sQ = wg::aligned_base(smem_u8);
  const uint32_t sK = sQ + TILE, sV = sK + 2 * TILE;  // two stages each

  const int bh = blockIdx.x, q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x, lane = tid % 32;
  const int kv_len = max(0, min(lens[bh], Lk));
  const __nv_bfloat16* kb = k + (size_t)bh * Lk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Lk * D;
  int k_begin, k_end;
  key_range(q0, Lq, kv_len, causal, window, &k_begin, &k_end);
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kBlockK - 1) / kBlockK : 0;

  wg::load_tile_async<D>(sQ, q + (size_t)bh * Lq * D, q0, Lq, tid);
  if (n_tiles > 0) {
    wg::load_tile_async<D>(sK, kb, k_begin, Lk, tid);
    wg::load_tile_async<D>(sV, vb, k_begin, Lk, tid);
  }
  wg::cp_async_commit();

  // this thread's accumulator rows: row0 and row0 + 8 of the tile
  const int row0 = 16 * (tid / 32) + lane / 4, col0 = 2 * (lane % 4);
  const float scale_log2 = sm_scale * kLog2e;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f}, corr[2];
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

    float s[32];
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss_n64(s, wg::desc_k_major(sQ, kk), wg::desc_k_major(stK, kk),
                     kk > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);

    // no mask to test when the tile lies inside the key length, left of
    // the diagonal and inside the window for every row of the tile (rows
    // past Lq are never written)
    const bool all = k0 + kBlockK <= kv_len &&
                     (!causal || (k0 + kBlockK - 1 <= q0 &&
                                  (window <= 0 ||
                                   k0 >= q0 + kBlockQ - window)));
    if (all)
      softmax_step<true>(s, m, l, corr, q0 + row0, k0 + col0, Lq, kv_len,
                         causal, window, scale_log2);
    else
      softmax_step<false>(s, m, l, corr, q0 + row0, k0 + col0, Lq, kv_len,
                          causal, window, scale_log2);
    // the previous P V has retired (waited below), so acc may be scaled
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * j + 2 * i] *= corr[i];
        acc[4 * j + 2 * i + 1] *= corr[i];
      }
    uint32_t a[16];
    wg::to_a_operand(s, a);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_rs(acc, a + 4 * kk, wg::desc_mn_major(stV, kk));
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(acc);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  wg::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // the row's denominator: the sum of the quad's four shares
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = q0 + row0 + 8 * i;
    if (r >= Lq) continue;
    const bool empty = l[i] == 0.f;
    const float inv = empty ? 0.f : 1.f / l[i];
    __nv_bfloat16* o = out + ((size_t)bh * Lq + r) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
    if (col0 == 0)
      lse[(size_t)bh * Lq + r] =
          empty ? kMaskValue : m[i] * kLn2 + logf(l[i]);
  }
}

template <int D>
static int launch(const void* q, const void* k, const void* v,
                  const void* lens, void* out, void* lse, int BH, int Lq,
                  int Lk, float sm_scale, int causal, int window,
                  cudaStream_t stream) {
  const size_t smem =
      (size_t)(3 * kBlockQ * (D + 1) + kBlockQ * kSStride) * sizeof(float);
  const dim3 grid(BH, (Lq + kBlockQ - 1) / kBlockQ);
  return launch_with_smem<flash_fwd_kernel<D>>(
      grid, smem, stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(lens), static_cast<float*>(out),
      static_cast<float*>(lse), Lq, Lk, sm_scale, causal, window);
}

template <int D>
static int launch_wgmma(const void* q, const void* k, const void* v,
                        const void* lens, void* out, void* lse, int BH,
                        int Lq, int Lk, float sm_scale, int causal,
                        int window, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = 5 * wg::tile_bytes<D>() + 1024;  // + alignment slack
  const dim3 grid(BH, (Lq + kBlockQ - 1) / kBlockQ);
  return launch_with_smem<flash_fwd_wgmma_kernel<D>, wg::kThreads>(
      grid, smem, stream, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(lens), static_cast<bf16*>(out),
      static_cast<float*>(lse), Lq, Lk, sm_scale, causal, window);
}

// fp32: the CUDA-core kernel; bf16: the tensor-core kernel, whose
// 128-byte swizzled lines hold 64 columns (ops/flash_attention.py pads a
// bf16 head dim of 16 or 32 to 64 with zero columns before the launch).
static int dispatch(int dtype, int D, const void* q, const void* k,
                    const void* v, const void* lens, void* out, void* lse,
                    int BH, int Lq, int Lk, float sm_scale, int causal,
                    int window, cudaStream_t stream) {
#define MXTT_ARGS \
  q, k, v, lens, out, lse, BH, Lq, Lk, sm_scale, causal, window, stream
  if (dtype == kFloat32 && D == 16) return launch<16>(MXTT_ARGS);
  if (dtype == kFloat32 && D == 32) return launch<32>(MXTT_ARGS);
  if (dtype == kFloat32 && D == 64) return launch<64>(MXTT_ARGS);
  if (dtype == kFloat32 && D == 128) return launch<128>(MXTT_ARGS);
  if (dtype == kBFloat16 && D == 64) return launch_wgmma<64>(MXTT_ARGS);
  if (dtype == kBFloat16 && D == 128) return launch_wgmma<128>(MXTT_ARGS);
#undef MXTT_ARGS
  return (int)cudaErrorInvalidValue;
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
  if (BH == 0 || Lq == 0) return 0;
  return mxtt::dispatch(dtype, D, q, k, v, lens, out, lse, BH, Lq, Lk,
                        sm_scale, causal, window,
                        static_cast<cudaStream_t>(stream));
}
