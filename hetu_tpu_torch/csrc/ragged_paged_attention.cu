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
// softmax sum is 0 gives 0, accumulation is fp32, the output is in q's type
// and tokens that belong to no row are left as the caller zeroed them.
//
// What bounds it on an H100: decode rows (one query token, g = nh / kvh
// query heads per KV head) do ~2 * g FLOPs per KV byte and are bound by
// the bytes of the KV pages; a 512-token prefill chunk over a context of
// thousands of tokens does hundreds of FLOPs per KV byte and is bound by
// arithmetic.
//
// What the design does about it -- one launch, one grid of two kinds of
// blocks, told apart by blockIdx.x; rows are told apart inside the kernel
// from q_lens (the host never reads them):
//  - The grid's first blocks run the decode rows (q_len 1) through the
//    split-KV decode core (paged_decode.cuh): one block per (row, KV head,
//    up to 4 query heads of its group, KV slice), the K/V page tiles
//    streamed through a 4-stage cp.async ring, the slices merged by the
//    last block of a row to finish (an atomic ticket).  The slice count
//    comes from the shapes alone (the wrapper), so that a 4096-token
//    context spreads over many SMs.  Blocks of other rows and slices past a
//    row's context exit at once.
//  - The other blocks run the longer rows (prefill chunks) unsplit.  The
//    TPU grid (kvh, S, maxp) carries the online-softmax state across pages
//    in VMEM scratch of max_q * g rows (1 MiB at chunk 512 and g = 4, far
//    beyond a block's 227 KB); here one block owns (KV head, row, a tile of
//    64 (token, query-head) pairs of the row) and runs the page loop
//    itself, with the softmax state of its pairs in registers.  Each block
//    stages a K/V tile (64 positions, 32 at head dim 256 and in fp32) in
//    shared memory once and uses it for all g query heads of its KV head,
//    so K/V bytes are read once per KV head and query tile.  The KV loop
//    stops at the last position any pair of the tile can see; each block
//    writes only its own tokens.  Offsets are 64-bit.
//  - bf16 chunk rows multiply on the tensor cores with mma.sync m16n8k16
//    (fp32 accumulate), FlashAttention-2 style: each of the 4 warps owns 16
//    pairs, keeps its Q fragments, scores and output in registers, and
//    feeds the probabilities to the second product straight from the score
//    registers (rounded to bf16); the next K/V tile is copied by cp.async
//    into a second buffer while the current one is multiplied.  fp32 chunk
//    rows take a scalar-FMA kernel, so fp32 stays exact to fp32 rounding.
//  - Head dims: the chunk blocks run at a template width of 32, 64, 128 or
//    256 at or above the head dim (columns past it zero in shared memory;
//    at 256 two column slices, out_cols); above 256 (template width 0)
//    every token of a chunk row runs through the decode core instead,
//    unsplit (a simple route, not a fast one).  The decode core reads any
//    head dim in place.
//  - Not yet: wgmma and TMA for the chunk rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"
#include "paged_decode.cuh"

namespace {

template <typename T>
struct TypeTag {
  using type = T;
};

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

// HD: the template width, at or above the true head dim hd; columns past
// hd are 0 in shared memory and never written.  Thread t owns score rows
// 4*(t/8) .. +3 of the tile, score columns 4*(t%8) .. +3 and output
// columns (HD/8)*(t%8) .. +HD/8-1.  The eight threads that share rows are
// eight neighbouring lanes of one warp, so row maxima and sums reduce with
// three shuffles.  A chunk block (tile `tile_x` of row `row`, KV head h) of
// fp32 rows with q_len > 1, in scalar FMA.
template <int HD>
__device__ void chunk_fp32_block(const float* __restrict__ q,
                                 const float* __restrict__ k_pages,
                                 const float* __restrict__ v_pages,
                                 float* __restrict__ out,
                                 const int* __restrict__ q_lens,
                                 const int* __restrict__ cu_q,
                                 const int* __restrict__ page_tables,
                                 const int* __restrict__ ctx_lens,
                                 int n_tokens, int nh, int kvh, int hd,
                                 int ps, int maxp, int max_q, float scale,
                                 int tile_x, int row, int h, float* smem) {
  // each thread's HD / 8 output columns are read from V as float4s
  static_assert(HD % 32 == 0, "HD / 8 columns a thread, in float4s");
  constexpr int kDPer = HD / 8;
  float* q_t = smem;                    // [HD][kRows]    Q^T of the tile
  float* k_t = q_t + HD * kRows;        // [HD][kKStride] K^T of the KV tile
  float* v_s = k_t + HD * kKStride;     // [kBK][HD]      V of the KV tile
  float* p_t = v_s + kBK * HD;          // [kBK][kPStride] P^T

  const int g = nh / kvh;
  const int start = cu_q[row];
  const int qlen_row = q_lens[row];
  const int qlen = min(min(qlen_row, max_q), n_tokens - start);
  if (qlen <= 1) return;  // padding rows; decode rows are the core's
  const int n_pairs = qlen * g;
  const int pair0 = tile_x * kRows;
  if (pair0 >= n_pairs) return;  // an idle tile: whole block

  const int qpos0 = ctx_lens[row] - qlen_row;  // position of query 0
  const int last_pair = min(n_pairs, pair0 + kRows) - 1;
  const int kv_end = min(qpos0 + last_pair / g + 1, maxp * ps);

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int64_t tok_stride = static_cast<int64_t>(nh) * hd;

  for (int e = tid; e < kRows * HD; e += kThreads) {
    const int r = e / HD;
    const int d = e % HD;
    const int p = pair0 + r;
    float val = 0.f;
    if (p < n_pairs && d < hd) {
      const int j = p / g;
      const int head = h * g + p % g;
      val = q[static_cast<int64_t>(start + j) * tok_stride +
              static_cast<int64_t>(head) * hd + d];
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
      if (pos < kv_end && d < hd) {
        const int64_t page = pt[pos / ps];
        const int64_t off =
            ((page * ps + pos % ps) * kvh + h) * static_cast<int64_t>(hd) + d;
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
             static_cast<int64_t>(head) * hd;
#pragma unroll
    for (int dd = 0; dd < kDPer; ++dd)
      if (tc * kDPer + dd < hd) dst[tc * kDPer + dd] = acc[rr][dd] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------

// KV positions per tile: 64, but 32 at HD 256 (two buffers of K and V
// then take 66 KB, as at HD 128)
template <int HD>
__host__ __device__ constexpr int mma_kv_tile() {
  return HD > 128 ? 32 : 64;
}

template <int HD>
__host__ __device__ constexpr int mma_smem_bytes() {
  // K and V, two buffers each, rows of HD + 8 bf16
  return 2 * 2 * mma_kv_tile<HD>() * (HD + 8) * 2;
}

// A chunk block of bf16 rows with q_len > 1 (tile `tile_x` of row `row`,
// z = KV head * col_blocks + column slice): mma.sync m16n8k16 in the layout
// of mma_bf16.cuh.  Warp w owns pairs pair0 + 16w .. +15 of the block's 64.
// The next K/V tile is copied by cp.async into the other buffer while the
// current one is multiplied (head dims off the 16-byte boundary take
// element loads into it).
template <int HD>
__device__ void chunk_mma_block(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k_pages,
                                const __nv_bfloat16* __restrict__ v_pages,
                                __nv_bfloat16* __restrict__ out,
                                const int* __restrict__ q_lens,
                                const int* __restrict__ cu_q,
                                const int* __restrict__ page_tables,
                                const int* __restrict__ ctx_lens,
                                int n_tokens, int nh, int kvh, int hd, int ps,
                                int maxp, int max_q, float scale, int tile_x,
                                int row, int z, unsigned char* smem) {
  constexpr int kMmaBK = mma_kv_tile<HD>();   // KV positions per tile
  constexpr int kDC = out_cols<HD>();         // output columns of a block
  constexpr int kStride = HD + 8;     // smem row stride (bf16), 16 B pad
  constexpr int kQSteps = HD / 16;    // k-steps of Q K^T
  constexpr int kSTiles = kMmaBK / 8; // n-tiles of S
  constexpr int kOTiles = kDC / 8;    // n-tiles of O
  constexpr int kTile = kMmaBK * kStride;
  // [2][kMmaBK][kStride] K, then the same for V
  __nv_bfloat16* ks_all = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs_all = ks_all + 2 * kTile;

  const int h = z / col_blocks<HD>();
  // the first output column of the block (its half at HD 256)
  const int c0 = (z % col_blocks<HD>()) * kDC;
  const int g = nh / kvh;
  const int start = cu_q[row];
  const int qlen_row = q_lens[row];
  const int qlen = min(min(qlen_row, max_q), n_tokens - start);
  if (qlen <= 1) return;  // padding rows; decode rows are the core's
  const int n_pairs = qlen * g;
  const int pair0 = tile_x * kRows;
  if (pair0 >= n_pairs) return;  // an idle tile: whole block
  if (c0 >= hd) return;          // a half that holds no column of hd

  const int qpos0 = ctx_lens[row] - qlen_row;  // position of query 0
  const int last_pair = min(n_pairs, pair0 + kRows) - 1;
  const int kv_end = min(qpos0 + last_pair / g + 1, maxp * ps);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int64_t tok_stride = static_cast<int64_t>(nh) * hd;
  const int wrow0 = pair0 + warp * 16;
  const bool warp_live = wrow0 < n_pairs;
  // rows of hd bf16 values start on 4-byte (hd even) and 16-byte (hd a
  // multiple of 8) boundaries; other head dims take element loads
  const bool even = hd % 2 == 0;
  const bool vec16 = hd % 8 == 0;

  // the lane's two rows: lo = wrow0 + gq, hi = lo + 8
  int qpos[2];
  int64_t qbase[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int p = wrow0 + gq + 8 * hr;
    const bool ok = p < n_pairs;
    qpos[hr] = ok ? qpos0 + p / g : -1;
    qbase[hr] = ok ? static_cast<int64_t>(start + p / g) * tok_stride +
                         static_cast<int64_t>(h * g + p % g) * hd
                   : -1;
  }
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  uint32_t qf[kQSteps][4];
#pragma unroll
  for (int kt = 0; kt < kQSteps; ++kt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t base = qbase[r & 1];
      const int col = kt * 16 + 2 * tq + (r & 2 ? 8 : 0);
      uint32_t val = 0u;
      if (base >= 0 && col < hd) {
        const __nv_bfloat16* src = q + base + col;
        val = even ? *reinterpret_cast<const uint32_t*>(src)
                   : pack_bf16(src[0], col + 1 < hd ? src[1] : zero);
      }
      qf[kt][r] = val;
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
  // K/V of positions kv0 .. kv0 + kMmaBK - 1 into buffer nb: cp.async, or
  // element loads off the 16-byte boundary; zero past kv_end and past hd
  auto fetch = [&](int kv0, int nb) {
    __nv_bfloat16* ks = ks_all + nb * kTile;
    __nv_bfloat16* vs = vs_all + nb * kTile;
    if (vec16) {
      for (int e = tid; e < kMmaBK * kVecs; e += kThreads) {
        const int c = e / kVecs;
        const int d8 = (e % kVecs) * 8;
        const int pos = kv0 + c;
        const bool live = pos < kv_end && d8 < hd;
        const int64_t off =
            live ? ((static_cast<int64_t>(pt[pos / ps]) * ps + pos % ps) *
                        kvh + h) * static_cast<int64_t>(hd) + d8
                 : 0;
        cp_async16(&ks[c * kStride + d8], k_pages + off, live);
        cp_async16(&vs[c * kStride + d8], v_pages + off, live);
      }
    } else {
      for (int e = tid; e < kMmaBK * HD; e += kThreads) {
        const int c = e / HD;
        const int d = e % HD;
        const int pos = kv0 + c;
        __nv_bfloat16 kv = zero, vv = zero;
        if (pos < kv_end && d < hd) {
          const int64_t page = pt[pos / ps];
          const int64_t off =
              ((page * ps + pos % ps) * kvh + h) * static_cast<int64_t>(hd) +
              d;
          kv = k_pages[off];
          vv = v_pages[off];
        }
        ks[c * kStride + d] = kv;
        vs[c * kStride + d] = vv;
      }
    }
  };
  const int n_kv = (kv_end + kMmaBK - 1) / kMmaBK;
  fetch(0, 0);
  cp_async_commit();
  for (int t = 0; t < n_kv; ++t) {
    const int kv0 = t * kMmaBK;
    if (t + 1 < n_kv) fetch(kv0 + kMmaBK, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile t has landed in buffer t & 1
    const __nv_bfloat16* ks = ks_all + (t & 1) * kTile;
    const __nv_bfloat16* vs = vs_all + (t & 1) * kTile;
    if (warp_live) {
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
        const __nv_bfloat16* v0 = &vs[(kk * 16 + 2 * tq) * kStride + c0 + gq];
#pragma unroll
        for (int nt = 0; nt < kOTiles; ++nt) {
          const __nv_bfloat16* vr = v0 + nt * 8;
          mma_bf16_16816(o[nt], a, pack_bf16(vr[0], vr[kStride]),
                         pack_bf16(vr[8 * kStride], vr[9 * kStride]));
        }
      }
    }
    __syncthreads();  // buffer t & 1 is consumed before tile t + 2 fills it
  }

  if (!warp_live) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (qbase[hr] < 0) continue;
    const float denom = l[hr] == 0.f ? 1.f : l[hr];
    // out and q share the [T, nh, hd] layout, so the row's q offset is
    // its output offset
    __nv_bfloat16* dst = out + qbase[hr];
#pragma unroll
    for (int nt = 0; nt < kOTiles; ++nt) {
      const int col = c0 + nt * 8 + 2 * tq;
      const float lo = o[nt][2 * hr] / denom, hi = o[nt][2 * hr + 1] / denom;
      if (even && col < hd) {
        *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(lo, hi);
      } else {
        if (col < hd) dst[col] = __float2bfloat16(lo);
        if (col + 1 < hd) dst[col + 1] = __float2bfloat16(hi);
      }
    }
  }
}

// fp32 chunk blocks: the scalar kernel's shared memory
template <int HD, typename T>
constexpr int chunk_smem_bytes() {
  if constexpr (HD == 0) {
    return 0;
  } else if constexpr (std::is_same<T, float>::value) {
    return smem_floats<HD>() * static_cast<int>(sizeof(float));
  } else {
    return mma_smem_bytes<HD>();
  }
}

// The one kernel of a call.  blockIdx.x below core_blocks: a decode row's
// block of the core, ((((row * kvh + h) * head_chunks + hc) * cslices + cs)
// * n_splits + split).  Above, with HD a template width: a chunk block,
// (z * n_rows + row) * tiles + tile_x for z = KV head (fp32) or KV head *
// col_blocks + column slice (bf16); with HD 0 (head dims above 256): a
// token of a chunk row through the core, unsplit, (((row * max_q + j) *
// kvh + h) * head_chunks + hc) * cslices + cs.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 1)
ragged_paged_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              T* __restrict__ out,
                              const int* __restrict__ q_lens,
                              const int* __restrict__ cu_q,
                              const int* __restrict__ page_tables,
                              const int* __restrict__ ctx_lens,
                              float* __restrict__ ws_acc,
                              float* __restrict__ ws_ml,
                              int* __restrict__ tickets, int n_tokens, int nh,
                              int n_rows, int max_q, int core_blocks,
                              int tiles, CoreGeom geom) {
  static_assert(kThreads == kCoreThreads, "one block size for both kinds");
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = geom.kvh;
  const int hd = geom.hd;
  const int g = nh / kvh;
  const int hcs = core_head_chunks(g);
  int bx = blockIdx.x;
  if (bx < core_blocks || HD == 0) {
    int row, j = 0, split = 0;
    const bool decode = bx < core_blocks;
    if (!decode) bx -= core_blocks;
    if (decode) {
      split = bx % geom.n_splits;
      bx /= geom.n_splits;
    }
    const int cs = bx % geom.cslices;
    bx /= geom.cslices;
    const int hc = bx % hcs;
    bx /= hcs;
    const int h = bx % kvh;
    bx /= kvh;
    if (decode) {
      row = bx;
    } else {
      j = bx % max_q;
      row = bx / max_q;
    }
    const int start = cu_q[row];
    const int qlen_row = q_lens[row];
    const int qlen = min(min(qlen_row, max_q), n_tokens - start);
    // decode blocks take the rows of one token, token blocks the others
    if (decode ? qlen != 1 : (qlen <= 1 || j >= qlen)) return;
    const int n_pos = min(ctx_lens[row] - qlen_row + j + 1,
                          geom.maxp * geom.ps);
    const int len = decode ? geom.split_len : n_pos;
    const int begin = split * len;
    if (begin >= n_pos) return;  // a slice past the context
    const int end = min(n_pos, begin + len);
    const int n_live = (n_pos + len - 1) / len;
    const int head0 = h * g + hc * kCoreHeads;
    const int nq = min(kCoreHeads, g - hc * kCoreHeads);
    const int64_t qrow = static_cast<int64_t>(start + j) * nh + head0;
    decode_core<T>(geom, q + qrow * hd, out + qrow * hd, k_pages, v_pages,
                   page_tables + static_cast<int64_t>(row) * geom.maxp, h,
                   nq, begin, end, split, n_live, cs, ws_acc, ws_ml,
                   static_cast<int64_t>(row) * nh + head0,
                   tickets + (static_cast<int64_t>(row) * kvh + h) * hcs + hc,
                   smem);
    return;
  }
  if constexpr (HD > 0) {
    bx -= core_blocks;
    const int tile_x = bx % tiles;
    bx /= tiles;
    const int row = bx % n_rows;
    const int z = bx / n_rows;
    if constexpr (std::is_same<T, float>::value)
      chunk_fp32_block<HD>(q, k_pages, v_pages, out, q_lens, cu_q,
                           page_tables, ctx_lens, n_tokens, nh, kvh, hd,
                           geom.ps, geom.maxp, max_q, geom.scale, tile_x, row,
                           z, reinterpret_cast<float*>(smem));
    else
      chunk_mma_block<HD>(q, k_pages, v_pages, out, q_lens, cu_q, page_tables,
                          ctx_lens, n_tokens, nh, kvh, hd, geom.ps, geom.maxp,
                          max_q, geom.scale, tile_x, row, z, smem);
  }
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   void* out, const int* q_lens, const int* cu_q,
                   const int* page_tables, const int* ctx_lens, float* ws_acc,
                   float* ws_ml, int* tickets, int n_tokens, int nh, int kvh,
                   int hd, int ps, int n_rows, int maxp, int max_q,
                   int n_splits, float scale, cudaStream_t stream) {
  auto kernel = ragged_paged_attention_kernel<HD, T>;
  constexpr int kItem = static_cast<int>(sizeof(T));
  const CoreGeom geom =
      core_geometry(hd, kItem, ps, kvh, maxp, n_splits, scale);
  const int core = core_smem_bytes(geom, kItem);
  const int smem = core > chunk_smem_bytes<HD, T>() ? core
                                                    : chunk_smem_bytes<HD, T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int g = nh / kvh;
  const int64_t per_item = static_cast<int64_t>(kvh) * core_head_chunks(g) *
                           geom.cslices;
  const int64_t core_blocks = n_rows * per_item * n_splits;
  int tiles = 0;
  int64_t rest;
  if constexpr (HD == 0) {
    rest = static_cast<int64_t>(n_rows) * max_q * per_item;
  } else {
    tiles = (max_q * g + kRows - 1) / kRows;
    // the scalar fp32 blocks hold every column, the bf16 ones a slice
    const int zs =
        std::is_same<T, float>::value ? kvh : kvh * col_blocks<HD>();
    rest = static_cast<int64_t>(tiles) * n_rows * zs;
  }
  if (core_blocks + rest > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(core_blocks + rest), kThreads, smem,
           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<T*>(out), q_lens, cu_q,
      page_tables, ctx_lens, ws_acc, ws_ml, tickets, n_tokens, nh, n_rows,
      max_q, static_cast<int>(core_blocks), tiles, geom);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// dtype: 0 = float32, 1 = bfloat16; any head_dim: 1 to 256 at the template
// width 32, 64, 128 or 256 at or above it, wider through the decode core.
// The caller zeroes `out` and `tickets` [n_rows, kvh, ceil(nh / kvh / 4)]
// (int32; every call leaves them 0 again) and, with n_splits > 1, gives fp32
// workspaces ws_acc [n_rows, nh, n_splits, head_dim] and ws_ml [n_rows, nh,
// n_splits, 2] for the decode rows; the kernel allocates nothing.
int hetu_ragged_paged_attention(const void* q, const void* k_pages,
                                const void* v_pages, void* out,
                                const void* q_lens, const void* cu_q,
                                const void* page_tables, const void* ctx_lens,
                                void* ws_acc, void* ws_ml, void* tickets,
                                int n_tokens, int nh, int kvh, int head_dim,
                                int ps, int n_rows, int maxp, int max_q,
                                int n_splits, float scale, int dtype,
                                void* stream) {
  if (kvh <= 0 || nh % kvh != 0 || max_q < 1 || ps < 1 || maxp < 1 ||
      n_rows < 1 || head_dim < 1 || n_splits < 1 ||
      n_splits > kCoreMaxSplits || tickets == nullptr ||
      (n_splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* ql = static_cast<const int*>(q_lens);
  const auto* cu = static_cast<const int*>(cu_q);
  const auto* ptab = static_cast<const int*>(page_tables);
  const auto* cl = static_cast<const int*>(ctx_lens);
  auto* wa = static_cast<float*>(ws_acc);
  auto* wm = static_cast<float*>(ws_ml);
  auto* tk = static_cast<int*>(tickets);
  auto st = static_cast<cudaStream_t>(stream);
  auto launch_width = [&](auto width, auto tag) {
    constexpr int HD = decltype(width)::value;
    using T = typename decltype(tag)::type;
    return launch<HD, T>(q, k_pages, v_pages, out, ql, cu, ptab, cl, wa, wm,
                         tk, n_tokens, nh, kvh, head_dim, ps, n_rows, maxp,
                         max_q, n_splits, scale, st);
  };
  auto launch_type = [&](auto tag) {
    if (head_dim <= 32)
      return launch_width(std::integral_constant<int, 32>{}, tag);
    if (head_dim <= 64)
      return launch_width(std::integral_constant<int, 64>{}, tag);
    if (head_dim <= 128)
      return launch_width(std::integral_constant<int, 128>{}, tag);
    if (head_dim <= 256)
      return launch_width(std::integral_constant<int, 256>{}, tag);
    return launch_width(std::integral_constant<int, 0>{}, tag);
  };
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = launch_type(TypeTag<float>{});
  if (dtype == 1) err = launch_type(TypeTag<__nv_bfloat16>{});
  return static_cast<int>(err);
}

const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
