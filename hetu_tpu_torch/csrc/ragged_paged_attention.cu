// Ragged paged attention for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: hetu_tpu/ops/ragged_paged_attention.py:142 `_ragged_kernel`
// (driven by `ragged_paged_attention_pallas`, the serving engine's one
// attention kernel).  Same function: a flat token axis q [T, nh, hd] of
// prefill chunks and decode tokens, each row i owning
// q[cu_q[i] : cu_q[i] + q_lens[i]], attending causally (query j at
// position ctx_i - q_len_i + j) to the KV positions gathered through
// page_tables[i] from k/v pages [P, ps, kvh, hd]; query head h reads KV
// head h / (nh / kvh).  Masked scores take -0.7 * FLT_MAX, a row whose
// softmax sum is 0 gives 0, accumulation is fp32, the output is in q's
// type and tokens that belong to no row are left as the caller zeroed them.
//
// What bounds it on an H100: decode rows (one query token, g = nh / kvh
// query heads per KV head) do ~2 * g FLOPs per KV byte and are bound by
// the bytes of the KV pages; a 512-token prefill chunk over a context of
// thousands of tokens does hundreds of FLOPs per KV byte and is bound by
// arithmetic.
//
// What the design does about it:
//  - The TPU grid (kvh, S, maxp) carries the online-softmax state across
//    pages in VMEM scratch of max_q * g rows; at chunk 512 and g = 4 that
//    is 1 MiB, far beyond a block's 227 KB of shared memory.  Here one
//    block owns (KV head, row, a tile of 64 (token, query-head) pairs of
//    the row) and runs the page loop itself, with the softmax state of its
//    64 pairs in registers.
//  - Each block stages a K/V tile (64 positions; 32 in the fp32 kernel)
//    in shared memory once and uses it for all g query heads of its KV
//    head, so GQA's saving is kept:
//    K/V bytes are read once per KV head and query tile, not once per
//    query head.
//  - The KV loop stops at the last position any pair of the tile can see,
//    so pages past ctx, and past the tile's causal limit, are never read;
//    rows with q_len == 0 and idle tiles exit at once.
//  - Each block writes only its own tokens (no read-modify-write of the
//    output as on the TPU).  Offsets are 64-bit.
//  - bf16 inputs (the serving path) multiply on the tensor cores with
//    mma.sync m16n8k16 (fp32 accumulate), FlashAttention-2 style: each of
//    the 4 warps owns 16 pairs, keeps its Q fragments, scores and output
//    in registers, and feeds the probabilities to the second product
//    straight from the score registers (rounded to bf16).  A warp whose
//    16 pairs are all padding skips the arithmetic.
//  - fp32 inputs take a scalar-FMA kernel, so fp32 stays exact to fp32
//    rounding (no TF32).
//  - Not yet: TMA / cp.async pipelining of the K/V tiles, wgmma, and a
//    split over the KV axis for long-context decode (8 KV heads x a few
//    decode rows give fewer blocks than the card's 132 SMs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr int kRows = 64;            // (token, query head) pairs per block
constexpr int kBK = 32;              // KV positions per tile
constexpr int kThreads = 128;
constexpr int kKStride = kBK + 4;    // K^T row stride in floats
constexpr int kPStride = kRows + 4;  // P^T row stride in floats
constexpr float kMaskValue = -0.7f * FLT_MAX;

template <int HD>
constexpr int smem_floats() {
  return HD * kRows + HD * kKStride + kBK * HD + kBK * kPStride;
}

// Thread t owns score rows 4*(t/8) .. +3 of the tile, score columns
// 4*(t%8) .. +3 and output columns (HD/8)*(t%8) .. +HD/8-1.  The eight
// threads that share rows are eight neighbouring lanes of one warp, so row
// maxima and sums reduce with three shuffles.
template <int HD>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_fp32_kernel(const float* __restrict__ q,
                                   const float* __restrict__ k_pages,
                                   const float* __restrict__ v_pages,
                                   float* __restrict__ out,
                                   const int* __restrict__ q_lens,
                                   const int* __restrict__ cu_q,
                                   const int* __restrict__ page_tables,
                                   const int* __restrict__ ctx_lens,
                                   int n_tokens, int nh, int kvh, int ps,
                                   int maxp, int max_q, float scale) {
  constexpr int kDPer = HD / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_t = smem;                    // [HD][kRows]    Q^T of the tile
  float* k_t = q_t + HD * kRows;        // [HD][kKStride] K^T of the KV tile
  float* v_s = k_t + HD * kKStride;     // [kBK][HD]      V of the KV tile
  float* p_t = v_s + kBK * HD;          // [kBK][kPStride] P^T

  const int row = blockIdx.y;
  const int h = blockIdx.z;
  const int g = nh / kvh;
  const int start = cu_q[row];
  const int qlen_row = q_lens[row];
  const int qlen = min(min(qlen_row, max_q), n_tokens - start);
  const int n_pairs = qlen > 0 ? qlen * g : 0;
  const int pair0 = blockIdx.x * kRows;
  if (pair0 >= n_pairs) return;  // padding row or idle tile: whole block

  const int qpos0 = ctx_lens[row] - qlen_row;  // position of query 0
  const int last_pair = min(n_pairs, pair0 + kRows) - 1;
  const int kv_end = min(qpos0 + last_pair / g + 1, maxp * ps);

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int64_t tok_stride = static_cast<int64_t>(nh) * HD;

  for (int e = tid; e < kRows * HD; e += kThreads) {
    const int r = e / HD;
    const int d = e % HD;
    const int p = pair0 + r;
    float val = 0.f;
    if (p < n_pairs) {
      const int j = p / g;
      const int head = h * g + p % g;
      val = q[static_cast<int64_t>(start + j) * tok_stride +
              static_cast<int64_t>(head) * HD + d];
    }
    q_t[d * kRows + r] = val;
  }

  int qpos[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int p = pair0 + tr * 4 + rr;
    qpos[rr] = p < n_pairs ? qpos0 + p / g : -1;
  }
  float m[4], l[4], acc[4][kDPer];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    m[rr] = kMaskValue;
    l[rr] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDPer; ++dd) acc[rr][dd] = 0.f;
  }

  const int* pt = page_tables + static_cast<int64_t>(row) * maxp;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int c = e / HD;
      const int d = e % HD;
      const int pos = kv0 + c;
      float kval = 0.f, vval = 0.f;
      if (pos < kv_end) {
        const int64_t page = pt[pos / ps];
        const int64_t off =
            ((page * ps + pos % ps) * kvh + h) * static_cast<int64_t>(HD) + d;
        kval = k_pages[off];
        vval = v_pages[off];
      }
      k_t[d * kKStride + c] = kval;
      v_s[c * HD + d] = vval;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[rr][cc] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa =
          *reinterpret_cast<const float4*>(&q_t[d * kRows + tr * 4]);
      const float4 ka =
          *reinterpret_cast<const float4*>(&k_t[d * kKStride + tc * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          s[rr][cc] = fmaf(qv[rr], kv[cc], s[rr][cc]);
    }

#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float mx = kMaskValue;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int pos = kv0 + tc * 4 + cc;
        s[rr][cc] = (pos <= qpos[rr] && pos < kv_end) ? s[rr][cc] * scale
                                                      : kMaskValue;
        mx = fmaxf(mx, s[rr][cc]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[rr], mx);
      const float alpha = expf(m[rr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        s[rr][cc] = expf(s[rr][cc] - m_new);
        sum += s[rr][cc];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[rr] = l[rr] * alpha + sum;
      m[rr] = m_new;
#pragma unroll
      for (int dd = 0; dd < kDPer; ++dd) acc[rr][dd] *= alpha;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        p_t[(tc * 4 + cc) * kPStride + tr * 4 + rr] = s[rr][cc];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pa =
          *reinterpret_cast<const float4*>(&p_t[c * kPStride + tr * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int d4 = 0; d4 < kDPer; d4 += 4) {
        const float4 va =
            *reinterpret_cast<const float4*>(&v_s[c * HD + tc * kDPer + d4]);
        const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[rr][d4 + k] = fmaf(pv[rr], vv[k], acc[rr][d4 + k]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int p = pair0 + tr * 4 + rr;
    if (p >= n_pairs) continue;
    const float denom = l[rr] == 0.f ? 1.f : l[rr];
    const int j = p / g;
    const int head = h * g + p % g;
    float* dst = out + static_cast<int64_t>(start + j) * tok_stride +
             static_cast<int64_t>(head) * HD + tc * kDPer;
#pragma unroll
    for (int dd = 0; dd < kDPer; ++dd) dst[dd] = acc[rr][dd] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kMmaBK = 64;  // KV positions per tile

// mma.sync m16n8k16 in the layout of mma_bf16.cuh.  Warp w owns
// pairs pair0 + 16w .. +15 of the block's 64.
template <int HD>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k_pages,
                                  const __nv_bfloat16* __restrict__ v_pages,
                                  __nv_bfloat16* __restrict__ out,
                                  const int* __restrict__ q_lens,
                                  const int* __restrict__ cu_q,
                                  const int* __restrict__ page_tables,
                                  const int* __restrict__ ctx_lens,
                                  int n_tokens, int nh, int kvh, int ps,
                                  int maxp, int max_q, float scale) {
  constexpr int kStride = HD + 8;     // smem row stride (bf16), 16 B pad
  constexpr int kQSteps = HD / 16;    // k-steps of Q K^T
  constexpr int kSTiles = kMmaBK / 8; // n-tiles of S
  constexpr int kOTiles = HD / 8;     // n-tiles of O
  __shared__ __align__(16) __nv_bfloat16 ks[kMmaBK * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kMmaBK * kStride];

  const int row = blockIdx.y;
  const int h = blockIdx.z;
  const int g = nh / kvh;
  const int start = cu_q[row];
  const int qlen_row = q_lens[row];
  const int qlen = min(min(qlen_row, max_q), n_tokens - start);
  const int n_pairs = qlen > 0 ? qlen * g : 0;
  const int pair0 = blockIdx.x * kRows;
  if (pair0 >= n_pairs) return;  // padding row or idle tile: whole block

  const int qpos0 = ctx_lens[row] - qlen_row;  // position of query 0
  const int last_pair = min(n_pairs, pair0 + kRows) - 1;
  const int kv_end = min(qpos0 + last_pair / g + 1, maxp * ps);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int64_t tok_stride = static_cast<int64_t>(nh) * HD;
  const int wrow0 = pair0 + warp * 16;
  const bool warp_live = wrow0 < n_pairs;

  // the lane's two rows: lo = wrow0 + gq, hi = lo + 8
  int qpos[2];
  int64_t qbase[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int p = wrow0 + gq + 8 * hr;
    const bool ok = p < n_pairs;
    qpos[hr] = ok ? qpos0 + p / g : -1;
    qbase[hr] = ok ? static_cast<int64_t>(start + p / g) * tok_stride +
                         static_cast<int64_t>(h * g + p % g) * HD
                   : -1;
  }
  uint32_t qf[kQSteps][4];
#pragma unroll
  for (int kt = 0; kt < kQSteps; ++kt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t base = qbase[r & 1];
      const int col = kt * 16 + 2 * tq + (r & 2 ? 8 : 0);
      qf[kt][r] = base < 0 ? 0u
                           : *reinterpret_cast<const uint32_t*>(q + base + col);
    }

  float o[kOTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.f;
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.f, 0.f};

  const int* pt = page_tables + static_cast<int64_t>(row) * maxp;
  constexpr int kVecs = HD / 8;       // 16-byte vectors per position
  for (int kv0 = 0; kv0 < kv_end; kv0 += kMmaBK) {
    __syncthreads();  // the previous tile's K and V are consumed
    for (int e = tid; e < kMmaBK * kVecs; e += kThreads) {
      const int c = e / kVecs;
      const int d8 = (e % kVecs) * 8;
      const int pos = kv0 + c;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (pos < kv_end) {
        const int64_t page = pt[pos / ps];
        const int64_t off =
            ((page * ps + pos % ps) * kvh + h) * static_cast<int64_t>(HD) +
            d8;
        kv = *reinterpret_cast<const uint4*>(k_pages + off);
        vv = *reinterpret_cast<const uint4*>(v_pages + off);
      }
      *reinterpret_cast<uint4*>(&ks[c * kStride + d8]) = kv;
      *reinterpret_cast<uint4*>(&vs[c * kStride + d8]) = vv;
    }
    __syncthreads();
    if (!warp_live) continue;  // warp-uniform; the next sync is at the top

    float s[kSTiles][4];
#pragma unroll
    for (int nt = 0; nt < kSTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kt = 0; kt < kQSteps; ++kt)
#pragma unroll
      for (int nt = 0; nt < kSTiles; ++nt) {
        const __nv_bfloat16* kr = &ks[(nt * 8 + gq) * kStride + kt * 16 +
                                      2 * tq];
        mma_bf16_16816(s[nt], qf[kt], *reinterpret_cast<const uint32_t*>(kr),
                       *reinterpret_cast<const uint32_t*>(kr + 8));
      }

    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int nt = 0; nt < kSTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hr = i >> 1;
        const int pos = kv0 + nt * 8 + 2 * tq + (i & 1);
        s[nt][i] = (pos <= qpos[hr] && pos < kv_end) ? s[nt][i] * scale
                                                     : kMaskValue;
        mx[hr] = fmaxf(mx[hr], s[nt][i]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      alpha[hr] = expf(m[hr] - m_new);
      m[hr] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kSTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = expf(s[nt][i] - m[i >> 1]);
        sum[i >> 1] += s[nt][i];
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
      l[hr] = l[hr] * alpha[hr] + sum[hr];
    }
#pragma unroll
    for (int nt = 0; nt < kOTiles; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* v0 = &vs[(kk * 16 + 2 * tq) * kStride + gq];
#pragma unroll
      for (int nt = 0; nt < kOTiles; ++nt) {
        const __nv_bfloat16* vr = v0 + nt * 8;
        mma_bf16_16816(o[nt], a, pack_bf16(vr[0], vr[kStride]),
                       pack_bf16(vr[8 * kStride], vr[9 * kStride]));
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (qbase[hr] < 0) continue;
    const float denom = l[hr] == 0.f ? 1.f : l[hr];
    // out and q share the [T, nh, hd] layout, so the row's q offset is
    // its output offset
    __nv_bfloat16* dst = out + qbase[hr] + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < kOTiles; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8) =
          pack_bf16(o[nt][2 * hr] / denom, o[nt][2 * hr + 1] / denom);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k_pages,
                       const void* v_pages, void* out, const int* q_lens,
                       const int* cu_q, const int* page_tables,
                       const int* ctx_lens, int n_tokens, int nh, int kvh,
                       int ps, int n_rows, int maxp, int max_q, float scale,
                       cudaStream_t stream) {
  const int g = nh / kvh;
  const dim3 grid((max_q * g + kRows - 1) / kRows, n_rows, kvh);
  ragged_paged_attention_mma_kernel<HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages),
      static_cast<__nv_bfloat16*>(out), q_lens, cu_q, page_tables, ctx_lens,
      n_tokens, nh, kvh, ps, maxp, max_q, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_scalar(const void* q, const void* k_pages,
                          const void* v_pages, void* out, const int* q_lens,
                          const int* cu_q, const int* page_tables,
                          const int* ctx_lens, int n_tokens, int nh, int kvh,
                          int ps, int n_rows, int maxp, int max_q,
                          float scale, cudaStream_t stream) {
  auto kernel = ragged_paged_attention_fp32_kernel<HD>;
  const int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int g = nh / kvh;
  const int tiles = (max_q * g + kRows - 1) / kRows;
  const dim3 grid(tiles, n_rows, kvh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pages),
      static_cast<const float*>(v_pages), static_cast<float*>(out), q_lens,
      cu_q, page_tables, ctx_lens, n_tokens, nh, kvh, ps, maxp, max_q, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128.  The output
// must be zeroed by the caller; the kernel allocates nothing.
int hetu_ragged_paged_attention(const void* q, const void* k_pages,
                                const void* v_pages, void* out,
                                const void* q_lens, const void* cu_q,
                                const void* page_tables, const void* ctx_lens,
                                int n_tokens, int nh, int kvh, int head_dim,
                                int ps, int n_rows, int maxp, int max_q,
                                float scale, int dtype, void* stream) {
  if (kvh <= 0 || nh % kvh != 0 || max_q < 1 || ps < 1 || maxp < 1 ||
      n_rows > 65535 || kvh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* ql = static_cast<const int*>(q_lens);
  const auto* cu = static_cast<const int*>(cu_q);
  const auto* ptab = static_cast<const int*>(page_tables);
  const auto* cl = static_cast<const int*>(ctx_lens);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 128)
    err = launch_scalar<128>(q, k_pages, v_pages, out, ql, cu, ptab, cl,
                             n_tokens, nh, kvh, ps, n_rows, maxp, max_q,
                             scale, st);
  else if (dtype == 0 && head_dim == 64)
    err = launch_scalar<64>(q, k_pages, v_pages, out, ql, cu, ptab, cl,
                            n_tokens, nh, kvh, ps, n_rows, maxp, max_q,
                            scale, st);
  else if (dtype == 1 && head_dim == 128)
    err = launch_mma<128>(q, k_pages, v_pages, out, ql, cu, ptab, cl,
                          n_tokens, nh, kvh, ps, n_rows, maxp, max_q, scale,
                          st);
  else if (dtype == 1 && head_dim == 64)
    err = launch_mma<64>(q, k_pages, v_pages, out, ql, cu, ptab, cl,
                         n_tokens, nh, kvh, ps, n_rows, maxp, max_q, scale,
                         st);
  return static_cast<int>(err);
}

const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
