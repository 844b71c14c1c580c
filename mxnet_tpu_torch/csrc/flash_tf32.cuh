// Hopper tensor-core building blocks of the fp32 flash-attention kernels
// (forward, flash_attention_fwd.cu; backward, flash_attention_bwd_dq.cu
// and flash_attention_bwd_dkv.cu): every product as error-compensated
// 3xTF32 on mma.sync.
//
// - 3xTF32: a tensor core reads an fp32 operand as TF32 (10 explicit
//   mantissa bits).  Each operand x is split in registers into
//   hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact in fp32), and a
//   product a b is issued as a_lo b_hi + a_hi b_lo + a_hi b_hi into one
//   fp32 accumulator, the two small terms first; a_lo b_lo (about 2^-22
//   of a b) is dropped.  That is fp32-level accuracy at a third of the
//   TF32 rate (CUTLASS's OpMultiplyAddFastF32, which PyTorch's fp32
//   memory-efficient attention uses).  tf32() rounds to nearest with ties
//   away from zero (cvt.rna); truncation would double the hi part's
//   error.  A masked 0 splits into (0, 0).
// - mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, not wgmma:
//   wgmma reads TF32 operands from shared memory only K-major and cannot
//   split them, while mma.sync takes fragments from registers, so a
//   fragment is loaded from shared memory as fp32 and split where it is
//   used.  With g = lane / 4 and t = lane % 4, A (16 x 8) holds a[0]
//   (row g, k t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4);
//   B (8 x 8) holds b0 (k t, column g) and b1 (k t + 4, g); the
//   accumulator holds c[0], c[1] at row g, columns 2t, 2t + 1 and c[2],
//   c[3] at row g + 8.
// - Accumulator as A operand: k is summed over, so a product may number
//   it in any order that A and B share.  Taking k = t as column 2t and
//   k = t + 4 as column 2t + 1 of the accumulator, a lane's accumulator
//   registers (c[0], c[2], c[1], c[3]) are its A fragment of the next
//   product (acc_as_a), and B's rows are read in the same order
//   (b0 from row 2t, b1 from row 2t + 1 of the k-step's 8 rows).  P and
//   dS never touch shared memory.
// - Accumulation: the tensor cores add into their fp32 accumulator
//   truncating, not rounding, so a sum carried through many products
//   drifts: over 2048 keys, dQ, dK and dV came out 2e-5 of their max
//   from fp32 sums (PERF.md).  A kernel therefore sums one tile's
//   products in a fresh accumulator and adds that to its running fp32
//   sum with a rounded add once per tile (add_to).  S and dP start
//   fresh per tile, keep their small terms in an accumulator of their
//   own and sum the hi products of every four k-steps in a fresh one
//   (tile_abt): dS cancels to noise where a row sees one key, and one
//   chain over D = 128 left that noise in dK at 1.4e-5 of max|dK| from
//   the plain version (7.8e-6 now; the plain version is itself 5.6e-6
//   from fp64).
// - Tiles: 64 rows x D fp32 in shared memory with a row stride of D + 4
//   floats (16-byte rows for cp.async, 4 mod 32 banks).  A lane's
//   fragment reads land on bank 4g + t (row g, column t) for the
//   products that read a tile by rows, and on bank 8t + g (rows 2t and
//   2t + 1, column g) for those that read it transposed: both
//   conflict-free.
#pragma once

#include <type_traits>

#include "flash_wgmma.cuh"  // cp.async helpers (namespace wg)

namespace mxtt {
namespace tf32 {

constexpr int kThreads = 128;  // four warps, each owning 16 tile rows
constexpr int kStatsBytes = 2 * kBlockQ * sizeof(float);  // LSE, Delta

template <int D> __host__ __device__ constexpr int stride() { return D + 4; }
template <int D> __host__ __device__ constexpr int tile_floats() {
  return kBlockQ * stride<D>();
}

// x rounded to TF32 (10 mantissa bits, ties away from zero), as bits:
// half a TF32 ulp added to the magnitude, the 13 dropped bits cleared.
// That is cvt.rna.tf32.f32 for finite x in two integer instructions
// (cvt.rna also tests for NaN and infinity, and the kernels ran slower
// with it: PERF.md), and ops/flash_attention.py _round_tf32 bit
// for bit.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a * b, m16n8k8, TF32 in, fp32 accumulators (layouts above).
__device__ __forceinline__ void mma_tf32_1688(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split into its TF32 halves.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float x0, float x1, float x2,
                                      float x3) {
    split(x0, hi[0], lo[0]);
    split(x1, hi[1], lo[1]);
    split(x2, hi[2], lo[2]);
    split(x3, hi[3], lo[3]);
  }
};

// A B fragment split into its TF32 halves: (b0, b1) = hi[0], hi[1] and
// lo[0], lo[1].
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
};

// c += a * b as 3xTF32, b given as fp32 (b0, b1) and split here.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a,
                                           float b0, float b1) {
  FragB b;
  b.set(b0, b1);
  mma_tf32_1688(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32_1688(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32_1688(c, a.hi, b.hi[0], b.hi[1]);
}

// A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 7 of a tile.
template <int D>
__device__ __forceinline__ void load_a(FragA& a, const float* tile, int r0,
                                       int k0, int g, int t) {
  constexpr int SD = stride<D>();
  const float* p = tile + (r0 + g) * SD + k0 + t;
  a.set(p[0], p[8 * SD], p[4], p[8 * SD + 4]);
}

// k-steps whose hi products are summed in a fresh accumulator before they
// are added to a product's running sum (tile_abt)
constexpr int kHiSteps = 4;

// out[j] = rows r0 .. r0 + 15 of an A operand times rows c0 + 8 j .. + 7
// of a B operand transposed (a 16 x 8 NJ block of A B^T over the D
// columns), as 3xTF32.  load_a(a, s) gives A's split fragment of k-step
// s (columns 8 s .. 8 s + 7), load_b(b, j, s) B's of block j and k-step
// s.  The small terms go to their own accumulator; the hi products of
// every kHiSteps k-steps to a fresh one, added to out with a rounded add,
// so that no accumulator carries a long chain of truncations.
template <int D, int NJ, typename LoadA, typename LoadB>
__device__ __forceinline__ void tile_abt(float (&out)[NJ][4], LoadA&& load_a,
                                         LoadB&& load_b) {
  constexpr int KS = kHiSteps < D / 8 ? kHiSteps : D / 8;
  float small[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[j][e] = small[j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < D / 8; k0 += KS) {
    FragA a[KS];
#pragma unroll
    for (int s = 0; s < KS; ++s) load_a(a[s], k0 + s);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float hi[4] = {};
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        FragB b;
        load_b(b, j, k0 + s);
        mma_tf32_1688(small[j], a[s].lo, b.hi[0], b.hi[1]);
        mma_tf32_1688(small[j], a[s].hi, b.lo[0], b.lo[1]);
        mma_tf32_1688(hi, a[s].hi, b.hi[0], b.hi[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) out[j][e] += hi[e];
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[j][e] += small[j][e];
}

// B fragment of rows row .. row + 7 (this lane: row + g), columns
// k0 .. k0 + 7 of a shared fp32 tile, split here.
template <int D>
__device__ __forceinline__ void load_b(FragB& b, const float* tile, int row,
                                       int k0, int g, int t) {
  const float* p = tile + (row + g) * stride<D>() + k0 + t;
  b.set(p[0], p[4]);
}

// tile_abt with A the rows r0 .. r0 + 15 of shared tile A and B the rows
// c0 .. of shared tile B, both read and split as each k-step needs them.
template <int D, int NJ>
__device__ __forceinline__ void tile_abt(float (&out)[NJ][4], const float* A,
                                         int r0, const float* B, int c0,
                                         int g, int t) {
  tile_abt<D, NJ>(
      out, [&](FragA& a, int s) { load_a<D>(a, A, r0, 8 * s, g, t); },
      [&](FragB& b, int j, int s) {
        load_b<D>(b, B, c0 + 8 * j, 8 * s, g, t);
      });
}

// The accumulator (c[0], c[1], c[2], c[3]) as the A fragment of a product
// whose k is its 8 columns, numbered as above.
__device__ __forceinline__ void acc_as_a(FragA& a, const float (&c)[4]) {
  a.set(c[0], c[2], c[1], c[3]);
}

// acc[n0 + n] += part[n]: a tile's partial sums into the running sums.
template <int N, int NC>
__device__ __forceinline__ void add_to(float (&acc)[N][4],
                                       const float (&part)[NC][4], int n0) {
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
}

// Rows [row0, row0 + 64) of a contiguous (L, D) fp32 matrix into a tile
// at shared address dst (row stride D + 4); rows at or past L are zero.
template <int D>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const float* src, int row0,
                                                int L, int tid) {
  constexpr int CH = D / 4;  // 16-byte chunks of a row
#pragma unroll
  for (int it = 0; it < kBlockQ * CH / kThreads; ++it) {
    const int i = tid + it * kThreads, r = i / CH, c = i % CH;
    const bool ok = row0 + r < L;
    const float* g = src + (size_t)(ok ? row0 + r : 0) * D + 4 * c;
    wg::cp_async16(dst + (r * stride<D>() + 4 * c) * 4, g, ok ? 16 : 0);
  }
}

// Whether every row of the query tile at q0 sees every key of the key
// tile at k0, so that the tile needs no mask.
__device__ __forceinline__ bool tile_whole(int q0, int k0, int Lq,
                                           int kv_len, int causal,
                                           int window) {
  bool ok = q0 + kBlockQ <= Lq && k0 + kBlockK <= kv_len;
  if (causal) {
    ok = ok && k0 + kBlockK - 1 <= q0;
    if (window > 0) ok = ok && k0 >= q0 + kBlockQ - 1 - (window - 1);
  }
  return ok;
}

}  // namespace tf32
}  // namespace mxtt
