// Ragged paged verify attention for Hopper (sm_90a), CUDA C++.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py, _paged_verify_kernel launched
// by ragged_paged_verify (the Pallas TPU kernel).  A window of W query rows
// per (sequence, head) attends causally over the paged context: row w of
// sequence b sees keys 0 .. starts[b] + w.  Rows at or past lengths[b]
// are written as exact zeros here, in the kernel (the Pallas kernel left
// junk there and masked it in its wrapper).  With W = 1 and
// starts = ctx - 1 this is decode attention.
//
// What bounds it on an H100: at the decode engine's windows (W = 1 on a
// full prefix-cache hit, a few to a few hundred rows for a prefix tail or
// a speculative window) it is bytes, like decode attention: the context's
// K and V rows are the traffic and each is read once per block of BW
// rows.  At wide windows over long contexts the per-row fp32 work
// (4 * D flops per visible key) grows with W and the kernel, which runs
// on the CUDA cores and not the tensor cores, turns compute bound.
//
// Design (simple and right first):
// - grid = (B * H, ceil(W / BW)), BW = 16 rows per block, 4 warps.
//   Each block loops over the context up to its own causal horizon,
//   starts[b] + min(lengths[b], row_end) - 1; the TPU kernel's sequential
//   page axis becomes this loop, and the block reads its own block-table
//   entries (no scalar prefetch).
// - The context is staged TK = 16 tokens at a time (one page at the
//   serving page size of 16) as fp32 K and V tiles in shared memory, each
//   token's page looked up in the block table, loaded with 16-byte vectors
//   by the whole block, so the tile is read from HBM once and reused by
//   all BW rows.
// - A row's head_dim vector is spread over a group of G lanes
//   (RowLayout); each group owns rows and runs a per-row fp32 online
//   softmax over the tile.  A warp stops early once every row it owns is
//   past its causal limit.
// - Known limits: the row-by-key products run as fp32 FMAs on the CUDA
//   cores; a tensor-core (wgmma / mma.sync) tile over BW rows is the
//   later fix for wide windows.
#include "paged_common.cuh"

namespace mxtt {

template <typename T, int D, int NWARPS, int BW, int TK>
__global__ void __launch_bounds__(NWARPS * 32)
ragged_paged_verify_kernel(const T* __restrict__ q,
                           const T* __restrict__ k_pages,
                           const T* __restrict__ v_pages,
                           const int* __restrict__ block_tables,
                           const int* __restrict__ starts,
                           const int* __restrict__ lengths,
                           T* __restrict__ out, int W, int H, int P,
                           int page_size, float sm_scale) {
  using L = RowLayout<T, D>;
  constexpr int VEC = L::VEC, G = L::G, CPL = L::CPL, EPL = L::EPL;
  constexpr int CHUNKS = L::CHUNKS;
  constexpr int NGROUPS = NWARPS * L::GROUPS_PER_WARP;
  constexpr int RPG = (BW + NGROUPS - 1) / NGROUPS;    // rows per group
  constexpr int NTHREADS = NWARPS * 32;

  __shared__ __align__(16) float ks[TK][D];
  __shared__ __align__(16) float vs[TK][D];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int r0 = blockIdx.y * BW;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int gl = lane % G;
  const int group = (tid / 32) * L::GROUPS_PER_WARP + lane / G;

  const int start = max(0, starts[b]);
  const int n_valid = max(0, min(lengths[b], W));
  const int n_ctx = P * page_size;
  const size_t row_stride = (size_t)H * D;      // between window rows

  // per-row state of the rows this group owns: r0 + group + i * NGROUPS
  float qv[RPG][EPL], acc[RPG][EPL], m[RPG], l[RPG];
  int lim[RPG];
  bool live[RPG];
#pragma unroll
  for (int i = 0; i < RPG; ++i) {
    const int r = r0 + group + i * NGROUPS;
    live[i] = r < r0 + BW && r < n_valid;
    lim[i] = live[i] ? start + r : -1;         // last visible key
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[i][e] = 0.f;
      qv[i][e] = 0.f;
    }
    if (live[i]) {
      const T* qp = q + ((size_t)b * W + r) * row_stride + (size_t)h * D;
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        load16(qp + (gl + j * G) * VEC, qv[i] + j * VEC);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[i][e] *= sm_scale;
    }
  }

  // the block's causal horizon: its last valid row's last visible key
  const int last_row = min(n_valid, min(r0 + BW, W)) - 1;
  const int n_tok = last_row < r0 ? 0 : min(start + last_row + 1, n_ctx);
  const int* bt = block_tables + (size_t)b * P;

  for (int tile0 = 0; tile0 < n_tok; tile0 += TK) {
    const int tcount = min(TK, n_tok - tile0);
    __syncthreads();                    // the previous tile is consumed
    for (int i = tid; i < tcount * CHUNKS; i += NTHREADS) {
      const int tt = i / CHUNKS, c = i % CHUNKS;
      const int t = tile0 + tt;
      const size_t base =
          ((size_t)bt[t / page_size] * page_size + t % page_size)
              * row_stride + (size_t)h * D + (size_t)c * VEC;
      float tmp[VEC];
      load16(k_pages + base, tmp);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ks[tt][c * VEC + e] = tmp[e];
      load16(v_pages + base, tmp);
#pragma unroll
      for (int e = 0; e < VEC; ++e) vs[tt][c * VEC + e] = tmp[e];
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPG; ++i) {
      for (int tt = 0; tt < tcount; ++tt) {
        const int t = tile0 + tt;
        const bool valid = t <= lim[i];
        // keys only grow: once no row of this warp sees t, none sees
        // any later key of the tile either
        if (!__any_sync(0xffffffffu, valid)) break;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const float4 k4 =
              *reinterpret_cast<const float4*>(&ks[tt][(gl + j * G) * VEC]);
          s += qv[i][j * VEC] * k4.x + qv[i][j * VEC + 1] * k4.y
               + qv[i][j * VEC + 2] * k4.z + qv[i][j * VEC + 3] * k4.w;
          if constexpr (VEC == 8) {
            const float4 k4b = *reinterpret_cast<const float4*>(
                &ks[tt][(gl + j * G) * VEC + 4]);
            s += qv[i][j * VEC + 4] * k4b.x + qv[i][j * VEC + 5] * k4b.y
                 + qv[i][j * VEC + 6] * k4b.z + qv[i][j * VEC + 7] * k4b.w;
          }
        }
        s = group_sum<G>(s);
        if (valid) {
          const float m_new = fmaxf(m[i], s);
          const float corr = expf(m[i] - m_new);
          const float p = expf(s - m_new);
          l[i] = l[i] * corr + p;
#pragma unroll
          for (int j = 0; j < CPL; ++j)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i][j * VEC + e] = acc[i][j * VEC + e] * corr
                                    + p * vs[tt][(gl + j * G) * VEC + e];
          m[i] = m_new;
        }
      }
    }
  }

  // rows of this block: live rows get acc / l, every other row < W zeros
#pragma unroll
  for (int i = 0; i < RPG; ++i) {
    const int r = r0 + group + i * NGROUPS;
    if (r >= r0 + BW || r >= W) continue;
    T* op = out + ((size_t)b * W + r) * row_stride + (size_t)h * D;
    const float inv = (live[i] && l[i] != 0.f) ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        op[(gl + j * G) * VEC + e] = from_float<T>(
            live[i] ? acc[i][j * VEC + e] * inv : 0.f);
  }
}

template <typename T, int D>
static void launch(const void* q, const void* k, const void* v,
                   const void* bt, const void* st, const void* ln,
                   void* out, int B, int W, int H, int P, int page_size,
                   float sm_scale, cudaStream_t stream) {
  constexpr int NWARPS = 4, BW = 16, TK = 16;
  const dim3 grid(B * H, (W + BW - 1) / BW);
  ragged_paged_verify_kernel<T, D, NWARPS, BW, TK>
      <<<grid, NWARPS * 32, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(bt),
          static_cast<const int*>(st), static_cast<const int*>(ln),
          static_cast<T*>(out), W, H, P, page_size, sm_scale);
}

template <typename T>
static int dispatch(int D, const void* q, const void* k, const void* v,
                    const void* bt, const void* st, const void* ln,
                    void* out, int B, int W, int H, int P, int page_size,
                    float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 8:
      launch<T, 8>(q, k, v, bt, st, ln, out, B, W, H, P, page_size, sm_scale, stream);
      break;
    case 16:
      launch<T, 16>(q, k, v, bt, st, ln, out, B, W, H, P, page_size, sm_scale, stream);
      break;
    case 32:
      launch<T, 32>(q, k, v, bt, st, ln, out, B, W, H, P, page_size, sm_scale, stream);
      break;
    case 64:
      launch<T, 64>(q, k, v, bt, st, ln, out, B, W, H, P, page_size, sm_scale, stream);
      break;
    case 128:
      launch<T, 128>(q, k, v, bt, st, ln, out, B, W, H, P, page_size, sm_scale, stream);
      break;
    case 256:
      launch<T, 256>(q, k, v, bt, st, ln, out, B, W, H, P, page_size, sm_scale, stream);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace mxtt

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// of contiguous tensors: q, out (B, W, H, D); k_pages, v_pages
// (num_pages, page_size, H, D); block_tables (B, P) int32; starts,
// lengths (B,) int32.  Returns the cudaError_t of the launch (0 = success).
extern "C" int mxtt_ragged_paged_verify(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* starts, const void* lengths,
    void* out, int B, int W, int H, int D, int P, int page_size,
    float sm_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || W == 0 || H == 0) return 0;
  if (dtype == mxtt::kFloat32)
    return mxtt::dispatch<float>(D, q, k_pages, v_pages, block_tables,
                                 starts, lengths, out, B, W, H, P,
                                 page_size, sm_scale, s);
  if (dtype == mxtt::kBFloat16)
    return mxtt::dispatch<__nv_bfloat16>(D, q, k_pages, v_pages,
                                         block_tables, starts, lengths, out,
                                         B, W, H, P, page_size, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
