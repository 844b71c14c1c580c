// Ragged paged decode attention (B4) for Hopper (sm_90a), CUDA C++.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py, _paged_fwd_kernel (:472)
// launched by ragged_paged_attention (pl.pallas_call, :586).  One query
// token per (sequence, head) attends over that sequence's paged K/V
// context, read through its block table; block-table entries past the
// context are never read, and an inactive slot (context length 0) yields
// exact zeros.
//
// What bounds it on an H100: bytes.  Each (b, h) reads its ctx K and V
// rows once (2 * ctx * D * elt bytes) and does 4 * ctx * D flops on them,
// about one flop per byte in fp32 -- far below the card's balance point,
// so tensor cores buy nothing and the kernel can at best stream the
// contexts at HBM speed.  At the serving batch (B * H = 96 rows, a few
// hundred tokens each) the whole call moves ~16 MB, 5 us at 3.35 TB/s:
// what stands in the way is latency -- too few blocks, and a chain of
// dependent loads inside each.
//
// Design:
// - Split context (flash-decoding).  ops/paged_attention.py _decode_plan
//   cuts every (b, h) context into n_split chunks of `chunk` tokens (whole
//   pages) from shapes alone, so the wrapper never reads context_lens
//   back.  Grid (B * H, n_split), one block of four warps per (b, h,
//   chunk).  A block whose chunk starts at or past its context exits at
//   once (chunk 0 of an inactive slot writes the zeros).
// - Page ring.  The chunk's block-table entries go to shared memory once.
//   K and V rows of TS tokens per stage arrive through a kStages-deep
//   cp.async ring of 16-byte copies, zero-filled past the chunk's last
//   valid token, so kStages - 1 stages are in flight while one is used.
// - One query row on CUDA cores, fp32 arithmetic.  q sits in registers,
//   pre-scaled.  A group of G lanes holds one D-row as 16-byte vectors
//   (RowLayout); the block's NGROUPS groups take a stage's tokens round
//   robin and write the scores to shared memory.  Then, per 16-token tile,
//   every thread updates the block's running max from those scores (the
//   same value in every thread), and each group adds p * v over its
//   tokens of the tile with p rounded to the storage dtype before the
//   product, as the Pallas kernel rounds it (pallas_kernels.py:514-516).
//   Groups keep their own l and acc against the shared max and are summed
//   once at the end.
// - The merge in the same launch.  When a context spans more than one
//   chunk, each of its blocks writes its partial (acc, m, l) to an fp32
//   workspace (n_split, B, H, D + 2), fences, and counts itself in the
//   (b, h) arrival counter.  The block that arrives last combines the
//   partials in chunk order (so the result does not depend on which block
//   was last), writes O, and sets the counter back to 0 for the next call:
//   the wrapper zeroes the counters once, when it makes them.  A context
//   of one chunk writes O directly and touches neither.
#include <atomic>

#include "paged_common.cuh"

namespace mxtt {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;           // tokens per update of the running max
constexpr int kStageBytes = 8192;   // K + V bytes of one ring stage
constexpr int kStages = 3;
constexpr int kMaxSmem = 232448;    // what one H100 block may use

template <typename T, int D> struct DecodeShape {
  using L = RowLayout<T, D>;
  static constexpr int NGROUPS = kWarps * L::GROUPS_PER_WARP;
  static constexpr int RAW = kStageBytes / (2 * D * (int)sizeof(T));
  // tokens per stage: whole tiles, 16..128
  static constexpr int TS =
      RAW < kTile ? kTile : (RAW > 128 ? 128 : RAW / kTile * kTile);
  static constexpr int RING_BYTES = kStages * 2 * TS * D * (int)sizeof(T);
  // ring, scores (TS), group accumulators (NGROUPS x D), group sums
  // (NGROUPS), the last-arrival flag (4 ints); the block table follows
  static constexpr int FIXED_BYTES =
      RING_BYTES + 4 * (TS + NGROUPS * D + NGROUPS + 4);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ context_lens,
                              T* __restrict__ out, float* __restrict__ ws,
                              int* __restrict__ counters, int H, int P,
                              int page_size, int chunk, float sm_scale) {
  using S = DecodeShape<T, D>;
  using L = typename S::L;
  constexpr int VEC = L::VEC, G = L::G, CPL = L::CPL, EPL = L::EPL;
  constexpr int CHUNKS = L::CHUNKS, NG = S::NGROUPS, TS = S::TS;
  constexpr int STAGE = 2 * TS * D;  // elements: K rows, then V rows

  extern __shared__ __align__(16) uint8_t smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* s_score = reinterpret_cast<float*>(smem + S::RING_BYTES);
  float* s_acc = s_score + TS;  // NG x D
  float* s_l = s_acc + NG * D;  // NG
  int* s_last = reinterpret_cast<int*>(s_l + NG);
  int* s_bt = s_last + 4;       // the chunk's pages

  const int bh = blockIdx.x, z = blockIdx.y, BH = gridDim.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane / G, gl = lane % G;
  const int group = warp * L::GROUPS_PER_WARP + sub;

  T* o = out + (size_t)bh * D;
  const int ctx = max(0, min(context_lens[b], P * page_size));
  const int c0 = z * chunk;
  if (c0 >= ctx) {
    if (z == 0)
      for (int d = tid; d < D; d += kThreads) o[d] = from_float<T>(0.f);
    return;
  }
  const int n_active = (ctx + chunk - 1) / chunk;  // blocks of this (b, h)
  const int n_tok = min(chunk, ctx - c0);
  const int n_pages = (n_tok + page_size - 1) / page_size;
  const int* bt = block_tables + (size_t)b * P + c0 / page_size;
  for (int i = tid; i < n_pages; i += kThreads) s_bt[i] = bt[i];
  __syncthreads();

  const size_t row_stride = (size_t)H * D;
  const T* kh = k_pages + (size_t)h * D;
  const T* vh = v_pages + (size_t)h * D;
  const uint32_t ring_addr = paged::smem_addr(ring);
  // tokens [st * TS, st * TS + TS) of the chunk into ring slot st % kStages
  auto issue = [&](int st) {
    const uint32_t dst = ring_addr + (st % kStages) * STAGE * sizeof(T);
    for (int i = tid; i < TS * CHUNKS; i += kThreads) {
      const int t = i / CHUNKS, c = i % CHUNKS, n = st * TS + t;
      const bool ok = n < n_tok;
      const size_t off =
          ok ? ((size_t)s_bt[n / page_size] * page_size + n % page_size) *
                       row_stride + c * VEC
             : 0;
      const uint32_t d = dst + (t * D + c * VEC) * sizeof(T);
      paged::cp_async16(d, kh + off, ok ? 16 : 0);
      paged::cp_async16(d + TS * D * sizeof(T), vh + off, ok ? 16 : 0);
    }
  };

  const int n_stages = (n_tok + TS - 1) / TS;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_stages) issue(st);
    paged::cp_async_commit();
  }

  float qv[EPL];
  const T* qp = q + (size_t)bh * D;
#pragma unroll
  for (int j = 0; j < CPL; ++j) load16(qp + (gl + j * G) * VEC, qv + j * VEC);
#pragma unroll
  for (int e = 0; e < EPL; ++e) qv[e] *= sm_scale;

  float m = kMaskValue, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  for (int st = 0; st < n_stages; ++st) {
    if (st + kStages - 1 < n_stages) issue(st + kStages - 1);
    paged::cp_async_commit();
    paged::cp_async_wait<kStages - 1>();  // stage st has landed
    __syncthreads();
    const T* sk = ring + (st % kStages) * STAGE;
    const T* sv = sk + TS * D;
    const int base = st * TS;

    // scores of the stage's tokens; the trip count is the same for every
    // group, as group_sum needs the whole warp
    for (int t0 = 0; t0 < TS; t0 += NG) {
      const int t = t0 + group;
      float s = 0.f;
      if (t < TS) {
        float kv[EPL];
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          load16(sk + t * D + (gl + j * G) * VEC, kv + j * VEC);
#pragma unroll
        for (int e = 0; e < EPL; ++e) s += qv[e] * kv[e];
      }
      s = group_sum<G>(s);
      if (t < TS && gl == 0) s_score[t] = base + t < n_tok ? s : kMaskValue;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < TS / kTile; ++j) {
      float tmax = s_score[j * kTile + (lane & (kTile - 1))];
#pragma unroll
      for (int off = kTile / 2; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m, tmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] *= corr;
      for (int t = j * kTile + group; t < (j + 1) * kTile; t += NG) {
        if (base + t >= n_tok) break;
        const float p = expf(s_score[t] - m_new);
        l += p;
        const float pr = round_to<T>(p);
        float vv[EPL];
#pragma unroll
        for (int jj = 0; jj < CPL; ++jj)
          load16(sv + t * D + (gl + jj * G) * VEC, vv + jj * VEC);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] += pr * vv[e];
      }
      m = m_new;
    }
    __syncthreads();  // the slot and the scores are used up
  }
  paged::cp_async_wait<0>();

  // the groups' sums share the block's max m: add them up
  if (gl == 0) s_l[group] = l;
#pragma unroll
  for (int j = 0; j < CPL; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      s_acc[group * D + (gl + j * G) * VEC + e] = acc[j * VEC + e];
  __syncthreads();
  float l_sum = 0.f;
  for (int g = 0; g < NG; ++g) l_sum += s_l[g];

  if (n_active == 1) {
    for (int d = tid; d < D; d += kThreads) {
      float num = 0.f;
      for (int g = 0; g < NG; ++g) num += s_acc[g * D + d];
      o[d] = from_float<T>(num / l_sum);
    }
    return;
  }

  float* part = ws + ((size_t)z * BH + bh) * (D + 2);
  for (int d = tid; d < D; d += kThreads) {
    float num = 0.f;
    for (int g = 0; g < NG; ++g) num += s_acc[g * D + d];
    part[d] = num;
  }
  if (tid == 0) {
    part[D] = m;
    part[D + 1] = l_sum;
  }
  __threadfence();  // this block's partial is visible before it is counted
  __syncthreads();
  if (tid == 0) {
    const int last = atomicAdd(counters + bh, 1) == n_active - 1;
    if (last) counters[bh] = 0;  // every block of (b, h) has been counted
    *s_last = last;
  }
  __syncthreads();
  if (!*s_last) return;
  __threadfence();

  float M = kMaskValue;
  for (int c = 0; c < n_active; ++c)
    M = fmaxf(M, __ldcg(ws + ((size_t)c * BH + bh) * (D + 2) + D));
  for (int d = tid; d < D; d += kThreads) {
    float num = 0.f, den = 0.f;
    for (int c = 0; c < n_active; ++c) {
      const float* pc = ws + ((size_t)c * BH + bh) * (D + 2);
      const float w = expf(__ldcg(pc + D) - M);
      den += __ldcg(pc + D + 1) * w;
      num += __ldcg(pc + d) * w;
    }
    o[d] = from_float<T>(den == 0.f ? 0.f : num / den);
  }
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v,
                  const void* bt, const void* ctx, void* out, void* ws,
                  void* counters, int B, int H, int P, int page_size,
                  int n_split, int chunk, float sm_scale,
                  cudaStream_t stream) {
  auto kernel = ragged_paged_attention_kernel<T, D>;
  const size_t smem = DecodeShape<T, D>::FIXED_BYTES +
                      sizeof(int) * (size_t)(chunk / page_size);
  if (smem > 48 * 1024) {
    // above 48 KB only after the attribute: set it once per device for
    // this instantiation, not on every launch
    static std::atomic<unsigned> set_on{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const unsigned bit = 1u << (dev & 31);
    if (!(set_on.load() & bit)) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return (int)err;
      set_on.fetch_or(bit);
    }
  }
  kernel<<<dim3(B * H, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(bt),
      static_cast<const int*>(ctx), static_cast<T*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), H, P, page_size,
      chunk, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(int D, const void* q, const void* k, const void* v,
                    const void* bt, const void* ctx, void* out, void* ws,
                    void* counters, int B, int H, int P, int page_size,
                    int n_split, int chunk, float sm_scale,
                    cudaStream_t stream) {
#define MXTT_ARGS                                                          \
  q, k, v, bt, ctx, out, ws, counters, B, H, P, page_size, n_split, chunk, \
      sm_scale, stream
  switch (D) {
    case 8: return launch<T, 8>(MXTT_ARGS);
    case 16: return launch<T, 16>(MXTT_ARGS);
    case 32: return launch<T, 32>(MXTT_ARGS);
    case 64: return launch<T, 64>(MXTT_ARGS);
    case 128: return launch<T, 128>(MXTT_ARGS);
    case 256: return launch<T, 256>(MXTT_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MXTT_ARGS
}

}  // namespace mxtt

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// of contiguous tensors: q, out (B, H, D); k_pages, v_pages
// (num_pages, page_size, H, D); block_tables (B, P) int32; context_lens
// (B,) int32.  The context splits into n_split chunks of `chunk` tokens
// (whole pages, n_split * chunk >= P * page_size); with n_split > 1, ws
// is an fp32 workspace of n_split * B * H * (D + 2) and counters B * H
// int32 zeros, which the kernel leaves at zero.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int mxtt_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* context_lens, void* out, void* ws,
    void* counters, int B, int H, int D, int P, int page_size, int n_split,
    int chunk, float sm_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  if (page_size <= 0 || chunk <= 0 || chunk % page_size || n_split < 1 ||
      n_split > 65535 || (long long)n_split * chunk < (long long)P * page_size ||
      (n_split > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (dtype == mxtt::kFloat32)
    return mxtt::dispatch<float>(D, q, k_pages, v_pages, block_tables,
                                 context_lens, out, ws, counters, B, H, P,
                                 page_size, n_split, chunk, sm_scale, s);
  if (dtype == mxtt::kBFloat16)
    return mxtt::dispatch<__nv_bfloat16>(
        D, q, k_pages, v_pages, block_tables, context_lens, out, ws,
        counters, B, H, P, page_size, n_split, chunk, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
