// Paged decode attention for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: hetu_tpu/ops/paged_attention.py:113 `_paged_kernel` (driven by
// `paged_attention_pallas`, reached through `paged_attention_decode`).  Same
// function: one decode token per request, q [B, nh, hd], attends to the
// first seq_lens[b] KV positions (the token just written included) gathered
// through page_tables[b] from k/v pages [P, ps, kvh, hd]; query head h reads
// KV head h / (nh / kvh).  Accumulation is fp32, the output is in q's type,
// pages past seq_len are never read, and a request with seq_len == 0 gives a
// zero row.
//
// What bounds it on an H100: every cached K and V element is used once per
// query head of its group (2 * g operations per element), far below the
// card's ~20 fp32 operations a byte: the kernel is bound by the bytes of the
// KV pages, 2 * seq_len * kvh * hd * itemsize per request.
//
// What the design does about it:
//  - The TPU grid (B, kvh, maxp) walks a request's pages in order and
//    carries the online softmax in VMEM scratch; blocks here run in no order,
//    so a block owns (request, KV head, up to 4 query heads of the group, a
//    slice of the KV axis) and loops over its positions itself.  A group of
//    more than 4 query heads takes several blocks (any g; no padding to 8).
//  - Each warp takes 4 consecutive positions at a time; a lane holds hd / 32
//    consecutive elements of q, K and V, so a position's K row is one
//    coalesced read of the warp; dots are reduced by shuffles; each warp keeps
//    its own softmax state and the four warps merge through shared memory.
//  - A batch of 8 requests x 8 KV heads is 64 blocks for 132 SMs, so the KV
//    axis is split over gridDim.z; the slices' (max, sum, unnormalized
//    output) go to an fp32 workspace and a second small kernel merges them.
//    With one slice the first kernel writes the output itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kHeads = 4;   // query heads of one KV head per block
constexpr int kUnroll = 4;  // positions a warp takes at a time
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void from_float(float* dst, float x) { *dst = x; }
__device__ __forceinline__ float load_one(const float* p) { return *p; }
__device__ __forceinline__ float load_one(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void from_float(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// dst[0 .. EPL) = the EPL elements at p (aligned to their total size) in
// fp32, read with one load instruction.
template <int EPL>
__device__ __forceinline__ void load_vec(const float* p, float* dst) {
  if constexpr (EPL == 8) {
    load_vec<4>(p, dst);
    load_vec<4>(p + 4, dst + 4);
  } else if constexpr (EPL == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  } else if constexpr (EPL == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
    dst[0] = p[0];
  }
}

// a bf16 is the high half of the fp32 with the same value
__device__ __forceinline__ void unpack_bf16x2(unsigned w, float* dst) {
  dst[0] = __uint_as_float(w << 16);
  dst[1] = __uint_as_float(w & 0xffff0000u);
}

template <int EPL>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* dst) {
  if constexpr (EPL == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    unpack_bf16x2(v.x, dst);
    unpack_bf16x2(v.y, dst + 2);
    unpack_bf16x2(v.z, dst + 4);
    unpack_bf16x2(v.w, dst + 6);
  } else if constexpr (EPL == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    unpack_bf16x2(v.x, dst);
    unpack_bf16x2(v.y, dst + 2);
  } else if constexpr (EPL == 2) {
    unpack_bf16x2(*reinterpret_cast<const unsigned*>(p), dst);
  } else {
    dst[0] = __bfloat162float(p[0]);
  }
}

// The lane's EPL elements of a row of hd values (elements lane * EPL ..):
// one vector load where hd is a multiple of EPL (the row and the lane's
// slice then start on a vector boundary), else element loads; elements
// at or past hd are 0.
template <int EPL, typename T>
__device__ __forceinline__ void load_lane(const T* row, int lane, int hd,
                                          bool vec, float* dst) {
  const int e0 = lane * EPL;
  if (vec) {
    if (e0 < hd) {
      load_vec<EPL>(row + e0, dst);
      return;
    }
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      dst[e] = e0 + e < hd ? load_one(row + e0 + e) : 0.f;
    return;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) dst[e] = 0.f;
}

// EPL: elements per lane, a head dim hd <= 32 * EPL (the template width).
template <typename T, int EPL>
__global__ void __launch_bounds__(kThreads, 1)
paged_attention_decode_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              T* __restrict__ out, float* __restrict__ ws_acc,
                              float* __restrict__ ws_ml,
                              const int* __restrict__ page_tables,
                              const int* __restrict__ seq_lens, int nh,
                              int kvh, int hd, int ps, int maxp,
                              int split_len, int n_splits, float scale) {
  constexpr int HD = 32 * EPL;
  __shared__ float sm_m[kWarps][kHeads];
  __shared__ float sm_l[kWarps][kHeads];
  __shared__ float sm_acc[kWarps][kHeads][HD];

  const int g = nh / kvh;
  const int chunks = (g + kHeads - 1) / kHeads;
  const int h = blockIdx.x / chunks;
  const int head0 = h * g + (blockIdx.x % chunks) * kHeads;
  const int n_heads = min(kHeads, (h + 1) * g - head0);
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int seq = min(seq_lens[b], maxp * ps);
  const int begin = split * split_len;
  const int end = min(seq, begin + split_len);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool vec = hd % EPL == 0;

  float qr[kHeads][EPL];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[hh][e] = 0.f;
    if (hh < n_heads)
      load_lane<EPL>(q + (static_cast<int64_t>(b) * nh + head0 + hh) * hd,
                     lane, hd, vec, qr[hh]);
  }

  float m[kHeads], l[kHeads], acc[kHeads][EPL];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    m[hh] = kMaskValue;
    l[hh] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[hh][e] = 0.f;
  }

  const int* pt = page_tables + static_cast<int64_t>(b) * maxp;
  for (int p0 = begin + warp * kUnroll; p0 < end; p0 += kWarps * kUnroll) {
    float kf[kUnroll][EPL], vf[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = p0 + u;
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[u][e] = vf[u][e] = 0.f;
      if (pos < end) {
        const int64_t page = pt[pos / ps];
        const int64_t off = ((page * ps + pos % ps) * kvh + h) * hd;
        load_lane<EPL>(k_pages + off, lane, hd, vec, kf[u]);
        load_lane<EPL>(v_pages + off, lane, hd, vec, vf[u]);
      }
    }
    float s[kHeads][kUnroll];
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qr[hh][e], kf[u][e], part);
        s[hh][u] = part;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          s[hh][u] += __shfl_xor_sync(kFull, s[hh][u], off);
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      float mx = kMaskValue;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[hh][u] = p0 + u < end ? s[hh][u] * scale : kMaskValue;
        mx = fmaxf(mx, s[hh][u]);
      }
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = expf(m[hh] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[hh][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = p0 + u < end ? expf(s[hh][u] - m_new) : 0.f;
        sum += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[hh][e] = fmaf(p, vf[u][e], acc[hh][e]);
      }
      l[hh] = l[hh] * alpha + sum;
      m[hh] = m_new;
    }
  }

  // merge the four warps' states
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    if (lane == 0) {
      sm_m[warp][hh] = m[hh];
      sm_l[warp][hh] = l[hh];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][hh][lane * EPL + e] = acc[hh][e];
  }
  __syncthreads();
  for (int idx = tid; idx < n_heads * hd; idx += kThreads) {
    const int hh = idx / hd;
    const int d = idx % hd;
    float mm = kMaskValue;
#pragma unroll
    for (int w2 = 0; w2 < kWarps; ++w2) mm = fmaxf(mm, sm_m[w2][hh]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < kWarps; ++w2) {
      const float f = expf(sm_m[w2][hh] - mm);
      ll += sm_l[w2][hh] * f;
      aa += sm_acc[w2][hh][d] * f;
    }
    const int64_t head = static_cast<int64_t>(b) * nh + head0 + hh;
    if (n_splits == 1) {
      from_float(out + head * hd + d, aa / (ll == 0.f ? 1.f : ll));
    } else {
      const int64_t slot = head * n_splits + split;
      ws_acc[slot * hd + d] = aa;
      if (d == 0) {
        ws_ml[slot * 2] = mm;
        ws_ml[slot * 2 + 1] = ll;
      }
    }
  }
}

// Merges the KV slices of one (request, query head): grid (nh, B), hd threads.
template <typename T>
__global__ void paged_attention_merge_kernel(const float* __restrict__ ws_acc,
                                             const float* __restrict__ ws_ml,
                                             T* __restrict__ out, int nh,
                                             int hd, int n_splits) {
  const int64_t head = static_cast<int64_t>(blockIdx.y) * nh + blockIdx.x;
  const int d = threadIdx.x;
  float mm = kMaskValue;
  for (int s = 0; s < n_splits; ++s)
    mm = fmaxf(mm, ws_ml[(head * n_splits + s) * 2]);
  float ll = 0.f, aa = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const int64_t slot = head * n_splits + s;
    const float f = expf(ws_ml[slot * 2] - mm);
    ll += ws_ml[slot * 2 + 1] * f;
    aa += ws_acc[slot * hd + d] * f;
  }
  from_float(out + head * hd + d, aa / (ll == 0.f ? 1.f : ll));
}

template <typename T, int EPL>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   void* out, float* ws_acc, float* ws_ml,
                   const int* page_tables, const int* seq_lens, int batch,
                   int nh, int kvh, int hd, int ps, int maxp, int n_splits,
                   float scale, cudaStream_t stream) {
  const int g = nh / kvh;
  const int chunks = (g + kHeads - 1) / kHeads;
  const int split_len = (maxp * ps + n_splits - 1) / n_splits;
  const dim3 grid(kvh * chunks, batch, n_splits);
  paged_attention_decode_kernel<T, EPL><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<T*>(out), ws_acc, ws_ml,
      page_tables, seq_lens, nh, kvh, hd, ps, maxp, split_len, n_splits,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  paged_attention_merge_kernel<T><<<dim3(nh, batch), hd, 0, stream>>>(
      ws_acc, ws_ml, static_cast<T*>(out), nh, hd, n_splits);
  return cudaGetLastError();
}

// The template width at or above head_dim: 32 * EPL for EPL 1, 2, 4, 8.
template <typename T>
cudaError_t launch_hd(int head_dim, const void* q, const void* k_pages,
                      const void* v_pages, void* out, float* ws_acc,
                      float* ws_ml, const int* page_tables,
                      const int* seq_lens, int batch, int nh, int kvh, int ps,
                      int maxp, int n_splits, float scale,
                      cudaStream_t stream) {
#define HETU_PAGED_LAUNCH(EPL)                                               \
  return launch<T, EPL>(q, k_pages, v_pages, out, ws_acc, ws_ml,             \
                        page_tables, seq_lens, batch, nh, kvh, head_dim, ps, \
                        maxp, n_splits, scale, stream)
  if (head_dim < 1 || head_dim > 256) return cudaErrorInvalidValue;
  if (head_dim <= 32) HETU_PAGED_LAUNCH(1);
  if (head_dim <= 64) HETU_PAGED_LAUNCH(2);
  if (head_dim <= 128) HETU_PAGED_LAUNCH(4);
  HETU_PAGED_LAUNCH(8);
#undef HETU_PAGED_LAUNCH
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// dtype: 0 = float32, 1 = bfloat16.  head_dim: 1 to 256.  With
// n_splits > 1 the caller gives fp32 workspaces ws_acc [B, nh, n_splits,
// head_dim] and ws_ml [B, nh, n_splits, 2]; the kernels allocate nothing.
int hetu_paged_attention_decode(const void* q, const void* k_pages,
                                const void* v_pages, void* out, void* ws_acc,
                                void* ws_ml, const void* page_tables,
                                const void* seq_lens, int batch, int nh,
                                int kvh, int head_dim, int ps, int maxp,
                                int n_splits, float scale, int dtype,
                                void* stream) {
  if (batch < 1 || batch > 65535 || kvh < 1 || nh % kvh != 0 || ps < 1 ||
      maxp < 1 || n_splits < 1 || n_splits > 65535 ||
      (n_splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* wa = static_cast<float*>(ws_acc);
  auto* wm = static_cast<float*>(ws_ml);
  const auto* ptab = static_cast<const int*>(page_tables);
  const auto* sl = static_cast<const int*>(seq_lens);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = launch_hd<float>(head_dim, q, k_pages, v_pages, out, wa, wm, ptab,
                           sl, batch, nh, kvh, ps, maxp, n_splits, scale, st);
  else if (dtype == 1)
    err = launch_hd<__nv_bfloat16>(head_dim, q, k_pages, v_pages, out, wa, wm,
                                   ptab, sl, batch, nh, kvh, ps, maxp,
                                   n_splits, scale, st);
  return static_cast<int>(err);
}

const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
