// Ragged paged decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py, _paged_fwd_kernel launched by
// ragged_paged_attention (the Pallas TPU kernel).  One query token per
// (sequence, head) attends over that sequence's paged K/V context, read
// through its block table; pages past the context are never read, and an
// inactive slot (context length 0) yields exact zeros.
//
// What bounds it on an H100: bytes.  Each (b, h) reads its ctx K and V
// rows once (2 * ctx * D * elt bytes) and does 4 * ctx * D flops on them,
// about one flop per byte in fp32 — far below the card's ~20 flop/byte
// fp32 balance point, so the kernel can only be as fast as HBM delivers
// the context.
//
// Design (simple and right first):
// - grid = B * H, one block of 4 warps per (sequence, head).  The TPU
//   kernel's sequential page grid axis becomes a loop inside the block,
//   and the block reads its own block-table entries (no scalar prefetch).
// - A head_dim row is read as 16-byte vectors by a group of G lanes
//   (RowLayout); the warp's 32 / G groups take different tokens, so every
//   load is a full 16-byte vector and consecutive lanes touch consecutive
//   bytes of one row.
// - Each group runs its own fp32 online softmax over the tokens it owns
//   (token t goes to group t mod NGROUPS); the groups are merged through
//   shared memory at the end with the usual max/rescale.
// - Known limit: at B = 8, H = 12 the grid is 96 blocks on 132 SMs, and a
//   block streams its whole context alone.  Splitting the context of one
//   (b, h) across blocks with a second merge pass ("flash-decoding") is
//   the fix, left to a later change.
#include "paged_common.cuh"

namespace mxtt {

template <typename T, int D, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32)
ragged_paged_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ context_lens,
                              T* __restrict__ out, int H, int P,
                              int page_size, float sm_scale) {
  using L = RowLayout<T, D>;
  constexpr int VEC = L::VEC, G = L::G, CPL = L::CPL, EPL = L::EPL;
  constexpr int TOK = L::GROUPS_PER_WARP;
  constexpr int NGROUPS = NWARPS * TOK;
  constexpr int NTHREADS = NWARPS * 32;

  __shared__ float sm_m[NGROUPS];
  __shared__ float sm_l[NGROUPS];
  __shared__ float sm_acc[NGROUPS][D];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int sub = lane / G, gl = lane % G;
  const int group = warp * TOK + sub;

  T* o = out + ((size_t)b * H + h) * D;
  const int ctx = max(0, min(context_lens[b], P * page_size));
  if (ctx == 0) {
    for (int d = tid; d < D; d += NTHREADS) o[d] = from_float<T>(0.f);
    return;
  }

  float qv[EPL];
  const T* qp = q + ((size_t)b * H + h) * D;
#pragma unroll
  for (int j = 0; j < CPL; ++j) load16(qp + (gl + j * G) * VEC, qv + j * VEC);
#pragma unroll
  for (int e = 0; e < EPL; ++e) qv[e] *= sm_scale;

  float m = kMaskValue, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  const int* bt = block_tables + (size_t)b * P;
  const size_t slot_stride = (size_t)H * D;
  // warp-uniform trip count: the group shuffles need every lane
  for (int t0 = warp * TOK; t0 < ctx; t0 += NGROUPS) {
    const int t = t0 + sub;
    const bool valid = t < ctx;
    float kv[EPL];
    size_t base = 0;
    float s = 0.f;
    if (valid) {
      const int page = bt[t / page_size];
      base = ((size_t)page * page_size + t % page_size) * slot_stride
             + (size_t)h * D;
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        load16(k_pages + base + (gl + j * G) * VEC, kv + j * VEC);
#pragma unroll
      for (int e = 0; e < EPL; ++e) s += qv[e] * kv[e];
    }
    s = group_sum<G>(s);
    if (valid) {
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * corr + p;
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        load16(v_pages + base + (gl + j * G) * VEC, kv + j * VEC);
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = acc[e] * corr + p * kv[e];
      m = m_new;
    }
  }

  if (gl == 0) {
    sm_m[group] = m;
    sm_l[group] = l;
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      sm_acc[group][(gl + j * G) * VEC + e] = acc[j * VEC + e];
  __syncthreads();

  float M = kMaskValue;
#pragma unroll 4
  for (int g = 0; g < NGROUPS; ++g) M = fmaxf(M, sm_m[g]);
  for (int d = tid; d < D; d += NTHREADS) {
    float denom = 0.f, num = 0.f;
    for (int g = 0; g < NGROUPS; ++g) {
      const float w = expf(sm_m[g] - M);
      denom += sm_l[g] * w;
      num += sm_acc[g][d] * w;
    }
    o[d] = from_float<T>(denom == 0.f ? 0.f : num / denom);
  }
}

template <typename T, int D>
static void launch(const void* q, const void* k, const void* v,
                   const void* bt, const void* ctx, void* out, int B, int H,
                   int P, int page_size, float sm_scale,
                   cudaStream_t stream) {
  constexpr int NWARPS = 4;
  ragged_paged_attention_kernel<T, D, NWARPS>
      <<<B * H, NWARPS * 32, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(bt),
          static_cast<const int*>(ctx), static_cast<T*>(out), H, P,
          page_size, sm_scale);
}

template <typename T>
static int dispatch(int D, const void* q, const void* k, const void* v,
                    const void* bt, const void* ctx, void* out, int B, int H,
                    int P, int page_size, float sm_scale,
                    cudaStream_t stream) {
  switch (D) {
    case 8:
      launch<T, 8>(q, k, v, bt, ctx, out, B, H, P, page_size, sm_scale, stream);
      break;
    case 16:
      launch<T, 16>(q, k, v, bt, ctx, out, B, H, P, page_size, sm_scale, stream);
      break;
    case 32:
      launch<T, 32>(q, k, v, bt, ctx, out, B, H, P, page_size, sm_scale, stream);
      break;
    case 64:
      launch<T, 64>(q, k, v, bt, ctx, out, B, H, P, page_size, sm_scale, stream);
      break;
    case 128:
      launch<T, 128>(q, k, v, bt, ctx, out, B, H, P, page_size, sm_scale, stream);
      break;
    case 256:
      launch<T, 256>(q, k, v, bt, ctx, out, B, H, P, page_size, sm_scale, stream);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace mxtt

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// of contiguous tensors: q, out (B, H, D); k_pages, v_pages
// (num_pages, page_size, H, D); block_tables (B, P) int32; context_lens
// (B,) int32.  Returns the cudaError_t of the launch (0 = success).
extern "C" int mxtt_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* context_lens, void* out, int B,
    int H, int D, int P, int page_size, float sm_scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  if (dtype == mxtt::kFloat32)
    return mxtt::dispatch<float>(D, q, k_pages, v_pages, block_tables,
                                 context_lens, out, B, H, P, page_size,
                                 sm_scale, s);
  if (dtype == mxtt::kBFloat16)
    return mxtt::dispatch<__nv_bfloat16>(D, q, k_pages, v_pages,
                                         block_tables, context_lens, out, B,
                                         H, P, page_size, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
