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
// flops on them, ~170 flops per fp32 byte.  Two kernels, chosen by dtype,
// both on the tensor cores, with one loop: grid (BH, ceil(Lq / 64)), 128
// threads per 64-row query tile (each block owns its output tile: no
// atomics, repeated calls are bitwise equal); K and V stream through a
// two-stage cp.async ring over the key tiles the `needed` rule keeps (key
// length, causal diagonal, window; the rest are never read), the next
// tile's copy in flight while this tile's products run.  The online
// softmax (softmax_step) runs on the S accumulator's registers in the
// log2 domain: a row's 64 scores sit in the four lanes of a quad, so its
// max takes two xor shuffles, and each lane keeps its own share of the
// denominator until the epilogue; a tile that every row sees whole skips
// the mask.  P is the A operand of O += P V straight from the
// accumulator registers.
//
// - bf16, flash_fwd_wgmma_kernel: one warpgroup (flash_wgmma.cuh).  Q
//   stays in shared memory as a swizzled bf16 tile; S = Q K^T is an
//   m64n64k16 product with both operands K-major in shared memory; the
//   exponentials run on ex2.approx; P is rounded to bf16 in registers and
//   feeds O += P V, whose B operand is the V tile read MN-major (N = D).
//   What bounds it now: no one part.  Per 64-key tile an SM spends about
//   three times the tensor-core or exponential time of the tile; leaving
//   out the softmax, the P V product or the K/V streaming each saves only
//   10-17%, and issuing the next tile's S beside this tile's P V (FA3's
//   overlap), two warpgroups per 128-row tile, or deeper rings were no
//   faster (PERF.md).
// - fp32, flash_fwd_tf32_kernel: both products as error-compensated
//   3xTF32 on mma.sync.m16n8k8 (flash_tf32.cuh), fp32-accurate at a third
//   of the TF32 rate; four warps, each owning 16 query rows.  Q, K and V
//   sit in shared memory as fp32 tiles (row stride D + 4).  At D <= 64
//   each warp splits its Q fragments into TF32 halves once and keeps them
//   in registers for the whole key loop; at D = 128 they would not fit
//   beside O's 64 accumulator registers, and S reads and splits them per
//   tile.  S keeps its small terms apart and sums its hi products afresh
//   every four k-steps (tf32::tile_abt); the exponentials are exp2f, as
//   B2 and B3 recompute P from this kernel's LSE; P V is summed per tile
//   in a fresh accumulator and folded into O with one rounded
//   O * corr + part, so no accumulator carries a chain of truncations
//   over the key loop.  What bounds it: the products, issued and waited
//   on by 8 warps an SM (255 registers a thread at D = 64 and 87 KB of
//   shared memory a block hold two blocks).  One TF32 pass instead of
//   three runs in 0.59 of the time, leaving out the softmax in 0.92;
//   splitting each K and V tile once per block instead of in every warp
//   (a fourth of the split instructions, one more barrier a tile, one
//   fp32 stage) was 10% slower (PERF.md).
//
// Masked entries contribute exactly 0; a row that sees no key writes
// O = 0 and LSE = -1e30.  Rows past Lq and keys past Lk are masked here,
// so the wrapper pads only a bf16 head dim under 64 (to the 64 columns of
// a swizzled line, ops/flash_attention.py).
#include "flash_tf32.cuh"

namespace mxtt {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the special-function unit, denormal results flushed to zero (a
// P under 2^-126 adds nothing a bf16 P V could keep).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Element e = 4 j + 2 i + c of a warp's 16 x 64 score tile, held as the
// m64n64 wgmma accumulator (float[32]) or as eight m16n8 mma.sync
// accumulators (float[8][4]): both put query row qr + 8 i, key
// kc + 8 j + c there (qr and kc are the lane's own).
__device__ __forceinline__ float& elem(float (&s)[32], int e) { return s[e]; }
__device__ __forceinline__ float& elem(float (&s)[8][4], int e) {
  return s[e / 4][e % 4];
}

// One key tile's online-softmax step on the S accumulator (elem).
// Scales the visible scores into the log2 domain, updates the running max
// m (log2 domain, the same in the four lanes of a quad) and this lane's
// share of the denominator l of the thread's two rows, leaves
// P = exp2(s - m) in s (exactly 0 where the mask is false) and the factor
// corr that the O accumulator must be scaled by.  A row that sees no key
// of the tile keeps m and l (corr = exp2(0) = 1, also while m is still the
// -1e30 sentinel).  kAll: every key of the tile is visible to every row
// (no mask to test).  kExact: exp2f (fp32 accuracy) instead of ex2.
template <bool kAll, bool kExact = false, typename Tile>
__device__ __forceinline__ void softmax_step(Tile& s, float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int qr, int kc, int Lq,
                                             int kv_len, int causal,
                                             int window, float scale_log2) {
  auto exp2_ = [](float x) { return kExact ? exp2f(x) : ex2(x); };
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t vis = 0;
    float mx = __int_as_float(0xff800000u);  // -inf
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = elem(s, 4 * j + 2 * i + c);
        if (kAll || visible(qr + 8 * i, kc + 8 * j + c, Lq, kv_len, causal,
                            window)) {
          vis |= 1u << (2 * j + c);
          x *= scale_log2;
          mx = fmaxf(mx, x);
        }
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    corr[i] = exp2_(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = elem(s, 4 * j + 2 * i + c);
        x = kAll || (vis >> (2 * j + c)) & 1u ? exp2_(x - m_new) : 0.f;
        sum += x;
      }
    l[i] = l[i] * corr[i] + sum;
    m[i] = m_new;
  }
}

// ------------------------------------------------------ fp32, 3xTF32 mma.sync
template <int D>
__global__ void __launch_bounds__(tf32::kThreads)
flash_fwd_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const int* __restrict__ lens, float* __restrict__ out,
                      float* __restrict__ lse, int Lq, int Lk,
                      float sm_scale, int causal, int window) {
  constexpr int SD = tf32::stride<D>(), TILE = tf32::tile_floats<D>();
  constexpr int NT = D / 8;            // 8-column blocks of the head dim
  constexpr int NC = NT < 8 ? NT : 8;  // blocks of O summed a pass
  // Q's split fragments in registers for the whole key loop (8 a k-step;
  // at D = 128 they would not fit beside O's 64 accumulator registers)
  constexpr bool kQRegs = D <= 64;
  extern __shared__ float4 smem_f4[];
  float* const sQ = reinterpret_cast<float*>(smem_f4);
  float* const sK = sQ + TILE;      // two stages
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

  // Q in a copy group of its own, ahead of the first K / V tile
  tf32::load_tile_async<D>(wg::smem_addr(sQ), q + qoff * D, q0, Lq, tid);
  wg::cp_async_commit();
  if (n_tiles > 0) {
    tf32::load_tile_async<D>(wg::smem_addr(sK), kb, k_begin, Lk, tid);
    tf32::load_tile_async<D>(wg::smem_addr(sV), vb, k_begin, Lk, tid);
  }
  wg::cp_async_commit();
  [[maybe_unused]] tf32::FragA qf[kQRegs ? NT : 1];
  if constexpr (kQRegs) {
    wg::cp_async_wait<1>();  // Q has landed
    __syncthreads();
#pragma unroll
    for (int s = 0; s < NT; ++s) tf32::load_a<D>(qf[s], sQ, r0, 8 * s, g, t);
  }

  // this lane's rows: r0 + g and r0 + g + 8 of the tile
  const float scale_log2 = sm_scale * kLog2e;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f}, corr[2];
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

    // S = Q K^T: register [j][2 i + c] is row r0 + g + 8 i, key
    // k0 + 8 j + 2 t + c; then P in place (exactly 0 where masked)
    float s[8][4];
    if constexpr (kQRegs)
      tf32::tile_abt<D, 8>(
          s, [&](tf32::FragA& a, int ks) { a = qf[ks]; },
          [&](tf32::FragB& b, int j, int ks) {
            tf32::load_b<D>(b, tK, 8 * j, 8 * ks, g, t);
          });
    else
      tf32::tile_abt<D, 8>(s, sQ, r0, tK, 0, g, t);
    if (tf32::tile_whole(q0, k0, Lq, kv_len, causal, window))
      softmax_step<true, true>(s, m, l, corr, q0 + r0 + g, k0 + 2 * t, Lq,
                               kv_len, causal, window, scale_log2);
    else
      softmax_step<false, true>(s, m, l, corr, q0 + r0 + g, k0 + 2 * t, Lq,
                                kv_len, causal, window, scale_log2);

    // O = O corr + P V: k-step j takes keys 8 j .. 8 j + 7 of the tile (V
    // read transposed: rows 2 t and 2 t + 1 of the step, column g); the
    // tile's products go to a fresh accumulator, NC column blocks at a
    // time (flash_tf32.cuh, accumulation)
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += NC) {
      float part[NC][4] = {};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        tf32::FragA a;
        tf32::acc_as_a(a, s[j]);
        const float* pv = tV + (8 * j + 2 * t) * SD + 8 * n0 + g;
#pragma unroll
        for (int n = 0; n < NC; ++n)
          tf32::mma_3xtf32(part[n], a, pv[8 * n], pv[SD + 8 * n]);
      }
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n0 + n][e] = fmaf(acc[n0 + n][e], corr[e / 2], part[n][e]);
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  wg::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // the row's denominator: the sum of the quad's four shares
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = q0 + r0 + g + 8 * i;
    if (r >= Lq) continue;
    const bool empty = l[i] == 0.f;
    float* o = out + (qoff + r) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) =
          empty ? make_float2(0.f, 0.f)
                : make_float2(acc[n][2 * i] / l[i], acc[n][2 * i + 1] / l[i]);
    if (t == 0)
      lse[qoff + r] = empty ? kMaskValue : m[i] * kLn2 + logf(l[i]);
  }
}

// ------------------------------------------------------------- bf16, wgmma
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
static int launch_tf32(const void* q, const void* k, const void* v,
                       const void* lens, void* out, void* lse, int BH,
                       int Lq, int Lk, float sm_scale, int causal,
                       int window, cudaStream_t stream) {
  // Q, two stages of K and of V
  const size_t smem = 5 * tf32::tile_floats<D>() * sizeof(float);
  const dim3 grid(BH, (Lq + kBlockQ - 1) / kBlockQ);
  return launch_with_smem<flash_fwd_tf32_kernel<D>, tf32::kThreads>(
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

// fp32: the 3xTF32 mma.sync kernel; bf16: the wgmma kernel, whose
// 128-byte swizzled lines hold 64 columns (ops/flash_attention.py pads a
// bf16 head dim of 16 or 32 to 64 with zero columns before the launch).
static int dispatch(int dtype, int D, const void* q, const void* k,
                    const void* v, const void* lens, void* out, void* lse,
                    int BH, int Lq, int Lk, float sm_scale, int causal,
                    int window, cudaStream_t stream) {
#define MXTT_ARGS \
  q, k, v, lens, out, lse, BH, Lq, Lk, sm_scale, causal, window, stream
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
