// Ragged paged verify attention for Hopper (sm_90a), CUDA C++.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py, _paged_verify_kernel launched
// by ragged_paged_verify (the Pallas TPU kernel).  A window of W query rows
// per (sequence, head) attends causally over the paged context: row w of
// sequence b sees keys 0 .. starts[b] + w.  Rows at or past lengths[b]
// are written as exact zeros here, in the kernel (the Pallas kernel left
// junk there and masked it in its wrapper).  With W = 1 and
// starts = ctx - 1 this is decode attention.  Softmax statistics and the
// accumulator are fp32; P is rounded to the storage dtype before the P V
// product, as the Pallas kernel does; the output is in the query dtype.
//
// What bounds it on an H100: at the decode engine's windows (W = 1 on a
// full prefix-cache hit, 5 for a speculative k + 1 window, up to a few
// hundred rows for a prefix tail) bytes: the context's K and V rows, read
// once per block of rows, at 2.5 (fp32) to 5 (bf16) flops a byte.  Wide
// windows over long contexts reach the fp32 operations bound (4 D flops
// per visible (row, key) pair at 67 TFLOP/s).
//
// Design:
// - Split context (flash-decoding).  grid = (B * H, row tiles, n_split):
//   block z takes keys [z * chunk, (z + 1) * chunk) up to its rows'
//   causal horizon, so a few (b, h) still fill the card.  n_split and
//   chunk (whole pages) come from the wrapper's plan, from shapes alone.
//   With n_split > 1 each block writes unnormalised partials (acc, m, l)
//   to an fp32 workspace and verify_merge_kernel combines them (online-
//   softmax merge; l == 0 gives exact zeros); a block with no key in its
//   chunk writes m = -1e30, l = 0, acc = 0.
// - Row tiles fit the window: 16 rows (one warp's rows) for W <= 16, 64
//   rows (four warps sharing each K/V tile) above.  For 16-row tiles the
//   block's warps take different 16-key sub-tiles of each K/V tile and are
//   merged through shared memory at the end.
// - Pages in flight: the block reads its chunk's block-table entries into
//   shared memory once, then gathers K/V rows with 16-byte cp.async into a
//   three-stage ring, so two tiles load while one is used.
// - bf16: tensor cores through mma.sync m16n8k16 (bf16 in, fp32
//   accumulators), one warp per 16 rows: S = Q K^T with Q's A fragments
//   held in registers and K through ldmatrix; P goes from the S
//   accumulators to the A operand in registers; O += P V with V through
//   ldmatrix.trans.  A 64-row wgmma tile would be mostly padding at W = 1
//   or 5.  Head dim 8 is padded to the product's k of 16 with zero
//   columns in shared memory.
// - fp32: CUDA cores (tensor cores would be TF32, outside the fp32
//   tolerance), register-blocked: a lane computes 4 rows x 4 keys of a
//   warp's 16 x 32 score tile (64-row tiles) or 2 x 4 of a 16 x 16 one,
//   from Q and K in shared memory (rows padded by 16 bytes, keys
//   interleaved across lanes, so the float4 reads do not conflict), and
//   P goes through a per-warp shared tile into O += P V.
// - The C entry point picks the kernel by dtype and row tile; a refused
//   launch returns its cudaError_t.
#include <atomic>
#include <type_traits>

#include "paged_common.cuh"

namespace mxtt {

using paged::cp_async16;
using paged::cp_async_commit;
using paged::cp_async_wait;
using paged::smem_addr;

constexpr int kVerifyStages = 3;
// largest chunk of one block, in pages (its block-table entries live in
// shared memory); ops/paged_attention.py _MAX_CHUNK_PAGES
constexpr int kMaxChunkPages = 4096;
constexpr int kMaxSmem = 232448;    // what one H100 block may use

// Shared-memory tile shapes of one (dtype, head dim, row-tile) kernel.
template <typename T, int D, int RW> struct VerifyTile {
  static constexpr int ELT = sizeof(T);
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int VEC = 16 / ELT;          // elements per 16-byte copy
  static constexpr int CH = D / VEC;            // 16-byte copies per row
  // head dim in shared memory: bf16 pads 8 to the product's k of 16
  static constexpr int DP = (BF16 && D < 16) ? 16 : D;
  static constexpr int SK = DP + VEC;           // row stride, +16 bytes
  // tokens per stage, 16 to 64: about 36 KB of K and V for 16-row
  // tiles (their Q is small, and four key groups want 64 tokens), 18 KB
  // for 64-row tiles (whose fp32 Q tile takes room from more blocks)
  static constexpr int STAGE_BYTES = RW == 1 ? 36864 : 18432;
  static constexpr int TK_FIT = STAGE_BYTES / (2 * SK * ELT);
  static constexpr int TK = TK_FIT >= 64 ? 64 : TK_FIT >= 32 ? 32 : 16;
  // keys of one warp tile: 16 (bf16 mma.sync, fp32 2 x 4 per lane) or,
  // for fp32 64-row tiles whose stage holds 32 keys or more, 32 (4 x 4)
  static constexpr int KG = (!BF16 && RW == 4 && TK >= 32) ? 8 : 4;
  static constexpr int KEYS = BF16 ? 16 : 4 * KG;
  static constexpr int KW = RW == 1 ? TK / KEYS : 1;  // key groups of warps
  static constexpr int NW = RW * KW;
  static constexpr int NT = NW * 32;
  static constexpr int BW = 16 * RW;                  // rows per block
  static constexpr int STAGE = 2 * TK * SK;           // K then V, elements
  static constexpr int RING_BYTES = kVerifyStages * STAGE * ELT;
  // fp32: the Q tile and one 16 x KEYS P tile per warp (rows padded)
  static constexpr int PS = KEYS + 4;
  static constexpr int QP_BYTES = BF16 ? 0 : (BW * SK + NW * 16 * PS) * 4;
  // merge of the key groups: acc, m, l of every warp
  static constexpr int CMB_BYTES = KW > 1 ? KW * 16 * (D + 2) * 4 : 0;
  static size_t smem_bytes(int chunk_pages) {
    const size_t main = RING_BYTES + QP_BYTES + (size_t)chunk_pages * 4;
    return main > (size_t)CMB_BYTES ? main : (size_t)CMB_BYTES;
  }
};

// Where finished rows go.  A warp's rows are local rows 0..15 from row0
// of the window.  RowSink writes the normalised output (n_split == 1) or
// split z's partial (acc, m, l) to the workspace; rows >= W are dropped.
template <typename T, int D> struct RowSink {
  T* out;
  float* ws;
  int B, W, H, b, h, z, row0;
  bool split;
  __device__ __forceinline__ size_t row_index(int row) const {
    return ((size_t)b * W + row) * H + h;
  }
  // element (r, col) of a row's acc; inv = 1 / l, or 0 where l == 0
  __device__ __forceinline__ void put(int r, int col, float a,
                                      float inv) const {
    const int row = row0 + r;
    if (row >= W) return;
    if (split)
      ws[(((size_t)z * B * W * H) + row_index(row)) * (D + 2) + col] = a;
    else
      out[row_index(row) * D + col] = from_float<T>(a * inv);
  }
  __device__ __forceinline__ void stats(int r, float m, float l) const {
    const int row = row0 + r;
    if (!split || row >= W) return;
    float* p = ws + (((size_t)z * B * W * H) + row_index(row)) * (D + 2);
    p[D] = m;
    p[D + 1] = l;
  }
};

// Key group kw's (acc, m, l) of the block's 16 rows in shared memory,
// merged across the groups at the end.
template <int D> struct GroupSink {
  float* acc;                          // [KW][16][D]
  float* m;                            // [KW][16]
  float* l;                            // [KW][16]
  int kw;
  __device__ __forceinline__ void put(int r, int col, float a, float) const {
    acc[(kw * 16 + r) * D + col] = a;
  }
  __device__ __forceinline__ void stats(int r, float m_, float l_) const {
    m[kw * 16 + r] = m_;
    l[kw * 16 + r] = l_;
  }
};

// 16-byte cp.async gather of tile i (TK tokens from key c0 + i * TK) of
// one head's K and V rows into ring stage i % kVerifyStages; tokens at or
// past c1 are zero-filled.  sbt holds the block-table entries from page
// pg0 on.
template <typename T, typename TL>
__device__ __forceinline__ void gather_tile(
    T* ring, int i, int c0, int c1, int pg0, const int* sbt,
    const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    size_t row_stride, size_t head_off, int page_size, int tid) {
  constexpr int TK = TL::TK, SK = TL::SK, CH = TL::CH, VEC = TL::VEC;
  T* sk = ring + (i % kVerifyStages) * TL::STAGE;
  T* sv = sk + TK * SK;
  const int t0 = c0 + i * TK;
  for (int j = tid; j < TK * CH; j += TL::NT) {
    const int tt = j / CH, c = j % CH, t = t0 + tt;
    const bool ok = t < c1;
    size_t off = 0;
    if (ok)
      off = ((size_t)sbt[t / page_size - pg0] * page_size + t % page_size)
                * row_stride + head_off + (size_t)c * VEC;
    cp_async16(smem_addr(sk + tt * SK + c * VEC), k_pages + off,
               ok ? 16 : 0);
    cp_async16(smem_addr(sv + tt * SK + c * VEC), v_pages + off,
               ok ? 16 : 0);
  }
}

// ---------------------------------------------------------------- fp32
// A warp's 16 rows x KEYS keys score tile, KEYS = 4 KG: lane (rg, kg) =
// (lane / KG, lane % KG) owns the RPL = KG / 2 rows RPL rg + r, the keys
// kg + KG j (j < 4) and the output float4 columns kg + KG i.  KG = 8 (4 x 4
// per lane) halves the shared-memory loads per FMA of KG = 4 (2 x 4) and
// serves the 64-row tiles whose stage holds 32 keys or more.  m and l are
// per row, equal across the KG lanes of a row group (l is a per-lane
// partial sum until the end).
template <int D, int KG> struct WarpF32 {
  static constexpr int RPL = KG / 2;             // rows per lane
  static constexpr int KEYS = 4 * KG;            // keys per tile
  static constexpr int NC = D / 4;               // float4 columns
  static constexpr int CPL = (NC + KG - 1) / KG; // column slots per lane
  float acc[RPL][CPL][4];
  float m[RPL], l[RPL];
  int lim[RPL];

  __device__ __forceinline__ void init(int row0, int start, int n_valid,
                                       int lane) {
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const int row = row0 + RPL * (lane / KG) + r;
      lim[r] = row < n_valid ? start + row : -1;
      m[r] = kMaskValue;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][i][e] = 0.f;
    }
  }

  // sq: this warp's 16 Q rows (stride SK); sk, sv: KEYS keys (stride SK)
  // starting at key kb; sp: this warp's P tile; keys < c1 exist.
  template <int SK, int PS>
  __device__ __forceinline__ void tile(const float* sq, const float* sk,
                                       const float* sv, float* sp, int kb,
                                       int c1, float sm_scale, int lane) {
    const int rg = lane / KG, kg = lane % KG;
    float s[RPL][4];
#pragma unroll
    for (int r = 0; r < RPL; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
    const float* q0 = sq + RPL * rg * SK;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[RPL];
#pragma unroll
      for (int r = 0; r < RPL; ++r)
        a[r] = *reinterpret_cast<const float4*>(q0 + r * SK + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 k =
            *reinterpret_cast<const float4*>(sk + (kg + KG * j) * SK + d);
#pragma unroll
        for (int r = 0; r < RPL; ++r)
          s[r][j] += a[r].x * k.x + a[r].y * k.y + a[r].z * k.z
                     + a[r].w * k.w;
      }
    }
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kb + kg + KG * j;
        s[r][j] = (key < c1 && key <= lim[r]) ? s[r][j] * sm_scale
                                              : kMaskValue;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int off = 1; off < KG; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = __expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[r][j] == kMaskValue ? 0.f : __expf(s[r][j] - m_new);
        sum += p;
        sp[(RPL * rg + r) * PS + kg + KG * j] = p;
      }
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < CPL; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][i][e] *= corr;
    }
    __syncwarp();
#pragma unroll 2
    for (int k = 0; k < KEYS; k += 4) {
      float pr[RPL][4];
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(
            sp + (RPL * rg + r) * PS + k);
        pr[r][0] = p4.x;
        pr[r][1] = p4.y;
        pr[r][2] = p4.z;
        pr[r][3] = p4.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = kg + KG * i;
          if (NC % KG == 0 || c < NC) {
            const float4 v =
                *reinterpret_cast<const float4*>(sv + (k + kk) * SK + 4 * c);
#pragma unroll
            for (int r = 0; r < RPL; ++r) {
              acc[r][i][0] += pr[r][kk] * v.x;
              acc[r][i][1] += pr[r][kk] * v.y;
              acc[r][i][2] += pr[r][kk] * v.z;
              acc[r][i][3] += pr[r][kk] * v.w;
            }
          }
        }
      }
    }
    __syncwarp();                      // sp is rewritten by the next tile
  }

  // hands every element this lane owns to sink.put(local row, column,
  // acc, 1 / l) and each row's statistics to sink.stats(local row, m, l)
  // (l summed over the row group first)
  template <typename S>
  __device__ __forceinline__ void finish(int lane, const S& sink) {
    const int rg = lane / KG, kg = lane % KG;
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
#pragma unroll
      for (int off = 1; off < KG; off <<= 1)
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
      const int row = RPL * rg + r;
      const float inv = l[r] != 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = kg + KG * i;
        if (NC % KG == 0 || c < NC)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sink.put(row, 4 * c + e, acc[r][i][e], inv);
      }
      if (kg == 0) sink.stats(row, m[r], l[r]);
    }
  }
};

// ---------------------------------------------------------------- bf16
// mma.sync m16n8k16 layouts (paged_common.cuh): lane (g, t) =
// (lane / 4, lane % 4) owns rows g and g + 8 of the warp's 16 rows; in an
// n-tile of 8 columns, columns 2 t and 2 t + 1.
template <int D> struct WarpBF16 {
  static constexpr int DP = D < 16 ? 16 : D;
  static constexpr int KS = DP / 16;              // k-steps of Q K^T
  static constexpr int NTL = DP / 8;              // n-tiles of P V
  uint32_t qa[KS][4];
  float acc[NTL][4];
  float m[2], l[2];
  int lim[2];

  __device__ __forceinline__ void init(const __nv_bfloat16* qrow0,
                                       size_t row_stride, int row0,
                                       int start, int n_valid, int lane) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + g + 8 * hr;
      lim[hr] = row < n_valid ? start + row : -1;
      m[hr] = kMaskValue;
      l[hr] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + 8 * (e & 1);
        const int col = 16 * kk + 2 * t + 8 * (e >> 1);
        qa[kk][e] = (row < n_valid && col < D)
            ? *reinterpret_cast<const uint32_t*>(
                  qrow0 + (size_t)(g + 8 * (e & 1)) * row_stride + col)
            : 0u;
      }
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  template <int SK>
  __device__ __forceinline__ void tile(const __nv_bfloat16* sk,
                                       const __nv_bfloat16* sv, int kb,
                                       int c1, float sm_scale, int lane) {
    const int t = lane % 4;
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    {
      // ldmatrix x4: matrices (keys 0-7 | 8-15) x (k columns +0 | +8)
      const int mi = lane / 8;
      const uint32_t a = smem_addr(sk + ((lane % 8) + 8 * (mi / 2)) * SK
                                   + 8 * (mi % 2));
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t r[4];
        paged::ldmatrix_x4(r, a + kk * 32);
        paged::mma_bf16_16816(s[0], qa[kk], r[0], r[1]);
        paged::mma_bf16_16816(s[1], qa[kk], r[2], r[3]);
      }
    }
    float p[2][4];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = kb + 8 * j + 2 * t + c;
          float& v = s[j][2 * hr + c];
          v = (key < c1 && key <= lim[hr]) ? v * sm_scale : kMaskValue;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float corr = __expf(m[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v = s[j][2 * hr + c];
          const float e = v == kMaskValue ? 0.f : __expf(v - m_new);
          p[j][2 * hr + c] = e;
          sum += e;
        }
      l[hr] = l[hr] * corr + sum;
      m[hr] = m_new;
#pragma unroll
      for (int n = 0; n < NTL; ++n) {
        acc[n][2 * hr] *= corr;
        acc[n][2 * hr + 1] *= corr;
      }
    }
    // the S accumulators of key n-tiles 0 and 1 are P's A fragment
    const uint32_t pa[4] = {paged::pack_bf16(p[0][0], p[0][1]),
                            paged::pack_bf16(p[0][2], p[0][3]),
                            paged::pack_bf16(p[1][0], p[1][1]),
                            paged::pack_bf16(p[1][2], p[1][3])};
    // ldmatrix x4 trans: matrices (keys 0-7 | 8-15) x (columns +0 | +8)
    const uint32_t a = smem_addr(sv + (lane % 16) * SK + 8 * (lane / 16));
#pragma unroll
    for (int n = 0; n < NTL; n += 2) {
      uint32_t r[4];
      paged::ldmatrix_x4_trans(r, a + n * 16);
      paged::mma_bf16_16816(acc[n], pa, r[0], r[1]);
      paged::mma_bf16_16816(acc[n + 1], pa, r[2], r[3]);
    }
  }

  template <typename S>
  __device__ __forceinline__ void finish(int lane, const S& sink) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
      const float inv = l[hr] != 0.f ? 1.f / l[hr] : 0.f;
      const int row = g + 8 * hr;
#pragma unroll
      for (int n = 0; n < NTL; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * n + 2 * t + c;
          if (D >= 16 || col < D)
            sink.put(row, col, acc[n][2 * hr + c], inv);
        }
      if (t == 0) sink.stats(row, m[hr], l[hr]);
    }
  }
};

// ------------------------------------------------------------- kernel
// (the launch bounds ask for one block per SM at least: without that
// ptxas capped the fp32 kernels' registers below their need and spilled)
template <typename T, int D, int RW>
__global__ void __launch_bounds__(VerifyTile<T, D, RW>::NT, 1)
ragged_paged_verify_kernel(const T* __restrict__ q,
                           const T* __restrict__ k_pages,
                           const T* __restrict__ v_pages,
                           const int* __restrict__ block_tables,
                           const int* __restrict__ starts,
                           const int* __restrict__ lengths,
                           T* __restrict__ out, float* __restrict__ ws,
                           int B, int W, int H, int P, int page_size,
                           int chunk, float sm_scale) {
  using TL = VerifyTile<T, D, RW>;
  constexpr int SK = TL::SK, TK = TL::TK, KW = TL::KW, NT = TL::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  int* sbt = reinterpret_cast<int*>(smem + TL::RING_BYTES + TL::QP_BYTES);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int r0 = blockIdx.y * TL::BW;
  const int z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = warp / KW, kw = warp % KW;
  const int wr0 = r0 + 16 * rw;                 // this warp's first row

  const int start = starts[b];
  const int n_valid = max(0, min(lengths[b], W));
  const int n_ctx = P * page_size;
  const size_t row_stride = (size_t)H * D, head_off = (size_t)h * D;
  // keys of this block: its chunk, cut at its last valid row's horizon
  const int last_row = min(n_valid, r0 + TL::BW) - 1;
  const int horizon =
      last_row < r0 ? 0 : max(0, min(start + last_row + 1, n_ctx));
  const int c0 = z * chunk;
  const int c1 = min(c0 + chunk, horizon);
  const int n_tiles = c1 > c0 ? (c1 - c0 + TK - 1) / TK : 0;
  // this warp's last visible key (-1: none of its rows is valid)
  const int warp_last = min(n_valid, wr0 + 16) - 1;
  const int warp_lim = warp_last < wr0 ? -1 : start + warp_last;

  const int pg0 = c0 / page_size;
  if (n_tiles > 0) {
    const int n_pg = (c1 - 1) / page_size - pg0 + 1;
    for (int i = tid; i < n_pg; i += NT)
      sbt[i] = block_tables[(size_t)b * P + pg0 + i];
  }
  if constexpr (TL::BF16 && D < 16) {
    // zero the padding columns D .. 15 of every ring row once
    for (int i = tid; i < kVerifyStages * 2 * TK; i += NT)
      *reinterpret_cast<uint4*>(ring + i * SK + D) = make_uint4(0, 0, 0, 0);
  }

  using Warp = typename std::conditional<TL::BF16, WarpBF16<D>,
                                         WarpF32<D, TL::KG>>::type;
  Warp st;
  float* sq = nullptr;
  float* sp = nullptr;
  if constexpr (TL::BF16) {
    const T* qrow0 = q + ((size_t)b * W + wr0) * row_stride + (size_t)h * D;
    st.init(reinterpret_cast<const __nv_bfloat16*>(qrow0), row_stride, wr0,
            start, n_valid, lane);
  } else {
    sq = reinterpret_cast<float*>(smem + TL::RING_BYTES);
    sp = sq + TL::BW * SK + warp * 16 * TL::PS;
    constexpr int NC = D / 4;
    for (int i = tid; i < TL::BW * NC; i += NT) {
      const int r = i / NC, c = i % NC, row = r0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < n_valid)
        v = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(q)
            + ((size_t)b * W + row) * row_stride + (size_t)h * D + 4 * c);
      *reinterpret_cast<float4*>(sq + r * SK + 4 * c) = v;
    }
    st.init(wr0, start, n_valid, lane);
  }
  __syncthreads();                     // block table, padding, Q tile

#pragma unroll
  for (int s = 0; s < kVerifyStages - 1; ++s) {
    if (s < n_tiles)
      gather_tile<T, TL>(ring, s, c0, c1, pg0, sbt, k_pages, v_pages,
                         row_stride, head_off, page_size, tid);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    if (i + kVerifyStages - 1 < n_tiles)
      gather_tile<T, TL>(ring, i + kVerifyStages - 1, c0, c1, pg0, sbt,
                         k_pages, v_pages, row_stride, head_off, page_size,
                         tid);
    cp_async_commit();
    cp_async_wait<kVerifyStages - 1>();  // tile i has landed
    __syncthreads();
    const T* sk = ring + (i % kVerifyStages) * TL::STAGE;
    const T* sv = sk + TK * SK;
    const int t0 = c0 + i * TK;
    for (int j = kw; j < TK / TL::KEYS; j += KW) {
      const int kb = t0 + TL::KEYS * j;
      if (kb >= c1 || kb > warp_lim) continue;     // warp-uniform
      const T* skj = sk + TL::KEYS * j * SK;
      const T* svj = sv + TL::KEYS * j * SK;
      if constexpr (TL::BF16)
        st.template tile<SK>(skj, svj, kb, c1, sm_scale, lane);
      else
        st.template tile<SK, TL::PS>(sq + 16 * rw * SK, skj, svj, sp, kb,
                                     c1, sm_scale, lane);
    }
    __syncthreads();                   // the stage is refilled next
  }
  cp_async_wait<0>();

  const bool split = gridDim.z > 1;
  if constexpr (KW == 1) {
    st.finish(lane, RowSink<T, D>{out, ws, B, W, H, b, h, z, wr0, split});
  } else {
    // merge the key groups' (acc, m, l) through shared memory (the ring
    // is free now); one row tile of 16 rows
    const GroupSink<D> groups{reinterpret_cast<float*>(smem),
                              reinterpret_cast<float*>(smem) + KW * 16 * D,
                              reinterpret_cast<float*>(smem)
                                  + KW * 16 * (D + 1),
                              kw};
    __syncthreads();
    st.finish(lane, groups);
    __syncthreads();
    const RowSink<T, D> sink{out, ws, B, W, H, b, h, z, r0, split};
    for (int e = tid; e < 16 * D; e += NT) {
      const int r = e / D, col = e % D;
      float mx = kMaskValue;
#pragma unroll
      for (int k = 0; k < KW; ++k) mx = fmaxf(mx, groups.m[k * 16 + r]);
      float l = 0.f, a = 0.f;
#pragma unroll
      for (int k = 0; k < KW; ++k) {
        const float w = __expf(groups.m[k * 16 + r] - mx);
        l += groups.l[k * 16 + r] * w;
        a += groups.acc[(k * 16 + r) * D + col] * w;
      }
      sink.put(r, col, a, l != 0.f ? 1.f / l : 0.f);
      if (col == 0) sink.stats(r, mx, l);
    }
  }
}

// Combines the n_split partials (acc, m, l) of each (b, w, h) row of the
// workspace (n_split, B, W, H, D + 2): out = sum_s acc_s e^(m_s - M) /
// sum_s l_s e^(m_s - M), exact zeros where the sum of l is 0.  One warp
// per row: its lanes take the splits' statistics in parallel, then the
// row's columns, with the splits' loads unrolled so several are in
// flight.
template <typename T>
__global__ void __launch_bounds__(128)
verify_merge_kernel(const float* __restrict__ ws, T* __restrict__ out,
                    int rows, int D, int n_split) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                      // warp-uniform
  const size_t stride = (size_t)rows * (D + 2);
  const float* p = ws + (size_t)row * (D + 2);
  float m = kMaskValue, l = 0.f;
  for (int s = lane; s < n_split; s += 32) {
    const float ms = p[s * stride + D];
    const float mn = fmaxf(m, ms);
    l = l * __expf(m - mn) + p[s * stride + D + 1] * __expf(ms - mn);
    m = mn;
  }
  float mx = m;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  l *= __expf(m - mx);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
  const float inv = l != 0.f ? 1.f / l : 0.f;
  for (int col = lane; col < D; col += 32) {
    float a = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s)
      a += p[s * stride + col] * __expf(p[s * stride + D] - mx);
    out[(size_t)row * D + col] = from_float<T>(a * inv);
  }
}

template <typename T, int D, int RW>
static int launch(const void* q, const void* k, const void* v,
                  const void* bt, const void* st, const void* ln, void* out,
                  void* ws, int B, int W, int H, int P, int page_size,
                  int n_split, int chunk, float sm_scale,
                  cudaStream_t stream) {
  using TL = VerifyTile<T, D, RW>;
  auto kernel = ragged_paged_verify_kernel<T, D, RW>;
  const size_t smem = TL::smem_bytes(chunk / page_size);
  // The shared-memory attribute is raised once per instantiation and
  // device, to the most any plan can ask of it (kMaxChunkPages pages of
  // block table) capped at what one block may use, as B4 and
  // launch_with_smem do: set on every launch it was a host call inside
  // every captured CUDA graph.
  static std::atomic<unsigned> set_on{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = 1u << (dev & 31);
  if (!(set_on.load() & bit)) {
    const size_t most = TL::smem_bytes(kMaxChunkPages);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(most < (size_t)kMaxSmem ? most : (size_t)kMaxSmem));
    if (err != cudaSuccess) return (int)err;
    set_on.fetch_or(bit);
  }
  const dim3 grid(B * H, (W + TL::BW - 1) / TL::BW, n_split);
  kernel<<<grid, TL::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(bt),
      static_cast<const int*>(st), static_cast<const int*>(ln),
      static_cast<T*>(out), static_cast<float*>(ws), B, W, H, P, page_size,
      chunk, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const int rows = B * W * H;
  verify_merge_kernel<T><<<(rows + 3) / 4, 128, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<T*>(out), rows, D, n_split);
  return (int)cudaGetLastError();
}

template <typename T, int RW>
static int dispatch(int D, const void* q, const void* k, const void* v,
                    const void* bt, const void* st, const void* ln,
                    void* out, void* ws, int B, int W, int H, int P,
                    int page_size, int n_split, int chunk, float sm_scale,
                    cudaStream_t s) {
#define MXTT_VERIFY_D(DD)                                                  \
  case DD:                                                                 \
    return launch<T, DD, RW>(q, k, v, bt, st, ln, out, ws, B, W, H, P,     \
                             page_size, n_split, chunk, sm_scale, s);
  switch (D) {
    MXTT_VERIFY_D(8)
    MXTT_VERIFY_D(16)
    MXTT_VERIFY_D(32)
    MXTT_VERIFY_D(64)
    MXTT_VERIFY_D(128)
    MXTT_VERIFY_D(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MXTT_VERIFY_D
}

template <typename T>
static int dispatch_rows(int rows, int D, const void* q, const void* k,
                         const void* v, const void* bt, const void* st,
                         const void* ln, void* out, void* ws, int B, int W,
                         int H, int P, int page_size, int n_split, int chunk,
                         float sm_scale, cudaStream_t s) {
  if (rows == 16)
    return dispatch<T, 1>(D, q, k, v, bt, st, ln, out, ws, B, W, H, P,
                          page_size, n_split, chunk, sm_scale, s);
  if (rows == 64)
    return dispatch<T, 4>(D, q, k, v, bt, st, ln, out, ws, B, W, H, P,
                          page_size, n_split, chunk, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mxtt

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// of contiguous tensors: q, out (B, W, H, D); k_pages, v_pages
// (num_pages, page_size, H, D); block_tables (B, P) int32; starts,
// lengths (B,) int32; ws the fp32 workspace (n_split, B, W, H, D + 2),
// unused (may be null) when n_split == 1.  The plan (rows per tile, 16 or
// 64; n_split; chunk, whole pages with n_split * chunk >= P * page_size)
// comes from ops/paged_attention.py _verify_plan.  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int mxtt_ragged_paged_verify(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* starts, const void* lengths,
    void* out, void* ws, int B, int W, int H, int D, int P, int page_size,
    int rows, int n_split, int chunk, float sm_scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || W == 0 || H == 0) return 0;
  if (page_size <= 0 || chunk <= 0 || chunk % page_size != 0
      || chunk / page_size > mxtt::kMaxChunkPages || n_split < 1
      || (long long)n_split * chunk < (long long)P * page_size
      || (n_split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == mxtt::kFloat32)
    return mxtt::dispatch_rows<float>(rows, D, q, k_pages, v_pages,
                                      block_tables, starts, lengths, out, ws,
                                      B, W, H, P, page_size, n_split, chunk,
                                      sm_scale, s);
  if (dtype == mxtt::kBFloat16)
    return mxtt::dispatch_rows<__nv_bfloat16>(
        rows, D, q, k_pages, v_pages, block_tables, starts, lengths, out, ws,
        B, W, H, P, page_size, n_split, chunk, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
