// Latent (MLA) ragged paged attention for Hopper (sm_90a), CUDA C++ with a
// plain C entry.
//
// Replaces: hetu_tpu/ops/ragged_paged_attention.py:420 `_make_latent_kernel`
// (driven by `latent_ragged_paged_attention_pallas`, the MLA serving step's
// attention kernel).  Same function: a flat token axis of absorbed queries
// q [T, nh, d_c + d_r] (fp32), each row i owning q[cu_q[i] : cu_q[i] +
// q_lens[i]], attends causally (query j at position ctx_i - q_len_i + j) to
// ONE shared KV stream gathered through page_tables[i]: keys are
// concat(dequant(c_pages), r_pages) and values are dequant(c_pages), so the
// output stays latent, [T, nh, d_c] fp32.  c_pages are fp32 or bf16 latents,
// int8 codes (code / 127 * scale) or packed 4-bit codes (codebook[nibble] *
// scale, the high nibble first), the quantized ones with one fp32 absmax
// per cached token in scale_pages (a scale <= 0 reads as 1).  Every product
// is fp32 against exactly dequantized values.  Masked scores take
// -0.7 * FLT_MAX, a row whose softmax sum is 0 gives 0, and tokens that
// belong to no row are left as the caller zeroed them.
//
// What bounds it on an H100: all nh heads share the one KV stream, so the
// (token, head) pairs of a row form the M axis of both products and each
// cached token does 2 * nh * (2 d_c + d_r) operations for every query that
// sees it.  At nh 32, d_c 512, d_r 64 a decode row does ~60 operations per
// bf16 KV byte and a 512-token chunk ~30,000: with fp32 arithmetic outside
// the tensor cores (67 TFLOP/s against 3.35 TB/s, 20 operations a byte)
// both are bound by operations.
//
// What the design does about it:
//  - The TPU block holds a whole chunk's q (t_pad x gp x (d_c + d_r)) and an
//    accumulator of max_q * gp x d_c in VMEM; at the widths above one query
//    token alone is 74 KB of q and 64 KB of accumulator.  Here a block of
//    256 threads owns a tile of 32 (token, head) pairs and runs the page loop
//    itself: its q tile (32 x (d_c + d_r)) and one dequantized KV tile of 32
//    positions lie in shared memory, the 32 x d_c accumulator and the online
//    softmax state in registers.
//  - A KV tile is dequantized once into shared memory and used twice, as K
//    (all d_c + d_r columns) and as V (the first d_c): the latent is read
//    from device memory once per tile of 32 pairs.
//  - Warp w owns pairs 4w .. 4w + 3 in both products, so the probabilities
//    and rescale factors pass between them inside the warp.  Scores: lane =
//    4 * tc + ds computes a 4 x 4 tile (rows of the warp, columns 4 tc ..
//    4 tc + 3) over every fourth 16-byte chunk of the width, and a
//    reduce-scatter by shuffles leaves lane ds with one row's four sums.
//    Output: lane owns columns 128 j + 4 lane .. + 3 of the warp's 4 rows.
//  - The KV loop stops at the last position the tile's pairs can see; rows
//    with q_len == 0 and idle tiles exit at once; table slots past the
//    context are never read.  Offsets are 64-bit.
//  - A decode row is one tile (nh 32), so a batch of 8 decode rows would
//    keep 8 of 132 SMs busy, each walking up to 128 KV tiles.  Rows of at
//    most 128 pairs are therefore split over the KV axis: the grid's first
//    blocks are one per (row, tile, KV slice after the first), the slices'
//    (max, sum, unnormalized output) go to an fp32 workspace and a small
//    kernel merges them.  Longer rows (prefill chunks) have hundreds of
//    tiles already and stay unsplit.
//  - Not yet: tensor cores (they would round q to bf16 or TF32, which is
//    another function), cp.async/TMA pipelining of the tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kBM = 32;        // (token, query head) pairs per block
constexpr int kBK = 32;        // KV positions per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplitPairs = 128;  // rows of at most this many pairs are split
constexpr int kSplitTiles = kSplitPairs / kBM;
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr unsigned kFull = 0xffffffffu;

// how c_pages (and r_pages) are stored
constexpr int kFp32 = 0;
constexpr int kBf16 = 1;
constexpr int kInt8 = 2;
constexpr int kPacked4 = 3;

struct Codebook {
  float v[16];
};

// Four consecutive latent values of cached token `tok`, columns d .. d + 3,
// dequantized to fp32.
template <int KIND>
__device__ __forceinline__ float4 load_latent4(const void* c_pages,
                                               int64_t tok, int d_c, int d,
                                               float sc, const float* code) {
  if (KIND == kFp32) {
    return *reinterpret_cast<const float4*>(
        static_cast<const float*>(c_pages) + tok * d_c + d);
  } else if (KIND == kBf16) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(c_pages) + tok * d_c + d);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  } else if (KIND == kInt8) {
    const char4 raw = *reinterpret_cast<const char4*>(
        static_cast<const signed char*>(c_pages) + tok * d_c + d);
    return make_float4(static_cast<float>(raw.x) / 127.0f * sc,
                       static_cast<float>(raw.y) / 127.0f * sc,
                       static_cast<float>(raw.z) / 127.0f * sc,
                       static_cast<float>(raw.w) / 127.0f * sc);
  } else {
    const uchar2 raw = *reinterpret_cast<const uchar2*>(
        static_cast<const unsigned char*>(c_pages) + tok * (d_c / 2) + d / 2);
    // the even element of a pair is the high nibble
    const int hi0 = raw.x >> 4, lo0 = raw.x & 0xF;
    const int hi1 = raw.y >> 4, lo1 = raw.y & 0xF;
    return make_float4(code[hi0] * sc, code[lo0] * sc, code[hi1] * sc,
                       code[lo1] * sc);
  }
}

// Four consecutive rope-key values of cached token `tok` (unquantized pages
// only: quantized pools carry no rope stream).
template <int KIND>
__device__ __forceinline__ float4 load_rope4(const void* r_pages, int64_t tok,
                                             int d_r, int d) {
  if (KIND == kBf16) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(r_pages) + tok * d_r + d);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(r_pages) +
                                          tok * d_r + d);
}

// CP: accumulator columns per lane, d_c <= 32 * CP.
template <int CP, int KIND>
__global__ void __launch_bounds__(kThreads)
latent_ragged_paged_attention_kernel(
    const float* __restrict__ q, const void* __restrict__ c_pages,
    const void* __restrict__ r_pages, const float* __restrict__ scale_pages,
    const Codebook code, float* __restrict__ out,
    const int* __restrict__ q_lens, const int* __restrict__ cu_q,
    const int* __restrict__ page_tables, const int* __restrict__ ctx_lens,
    int n_tokens, int nh, int d_c, int d_r, int ps, int maxp, int max_q,
    float scale, float* __restrict__ ws_acc, float* __restrict__ ws_ml,
    int n_splits, int split_len) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int width = d_c + d_r;
  const int stride = width + 4;         // row stride of the tiles, floats
  const int n_chunks = width / 4;       // 16-byte chunks per row
  float* q_s = smem;                    // [kBM][stride]  q of the tile
  float* k_s = q_s + kBM * stride;      // [kBK][stride]  dequantized KV tile
  float* p_s = k_s + kBK * stride;      // [kWarps][4][kBK] probabilities
  float* code_s = p_s + kWarps * 4 * kBK;  // [16]

  const int row = blockIdx.y;
  const int start = cu_q[row];
  const int qlen_row = q_lens[row];
  const int qlen = min(min(qlen_row, max_q), n_tokens - start);
  const int n_pairs = qlen > 0 ? qlen * nh : 0;
  // gridDim.x: first the short rows' tiles for the KV slices 1 .. n_splits
  // - 1 (kSplitTiles blocks a slice), then every tile with slice 0
  const int extra = (n_splits - 1) * kSplitTiles;
  const int bx = blockIdx.x;
  const int split = bx < extra ? 1 + bx / kSplitTiles : 0;
  const int pair0 = (bx < extra ? bx % kSplitTiles : bx - extra) * kBM;
  if (pair0 >= n_pairs) return;  // padding row or idle tile: whole block
  const bool row_split = n_splits > 1 && n_pairs <= kSplitPairs;
  if (split > 0 && !row_split) return;  // long rows are not split

  const int qpos0 = ctx_lens[row] - qlen_row;  // position of query 0
  const int last_pair = min(n_pairs, pair0 + kBM) - 1;
  const int kv_end = min(qpos0 + last_pair / nh + 1, maxp * ps);
  // this block's slice of the KV axis (split_len is a multiple of kBK)
  const int kv_begin = row_split ? split * split_len : 0;
  const int kv_stop = row_split ? min(kv_end, kv_begin + split_len) : kv_end;

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int tc = lane >> 2;   // score columns 4 tc .. 4 tc + 3 of the tile
  const int ds = lane & 3;    // which 16-byte chunks of the width
  // q and out are [T * nh, width] and [T * nh, d_c]: the pairs of a row are
  // consecutive rows of both
  const int64_t pair_base = static_cast<int64_t>(start) * nh + pair0;
  const bool warp_live = pair0 + 4 * w < n_pairs;

  if (tid < 16) code_s[tid] = code.v[tid];
  for (int r = w; r < kBM; r += kWarps) {
    const bool ok = pair0 + r < n_pairs;
    const float* src = q + (pair_base + r) * width;
    for (int ch = lane; ch < n_chunks; ch += 32)
      *reinterpret_cast<float4*>(&q_s[r * stride + ch * 4]) =
          ok ? *reinterpret_cast<const float4*>(src + ch * 4)
             : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // after the reduce-scatter lane ds holds the sums of this row of the warp
  const int my_r = 2 * (ds & 1) + (ds >> 1);
  const int my_pair = pair0 + 4 * w + my_r;
  const int my_qpos = my_pair < n_pairs ? qpos0 + my_pair / nh : -1;
  float m = kMaskValue, l = 0.f;
  float acc[4][CP];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < CP; ++j) acc[r][j] = 0.f;

  const int* pt = page_tables + static_cast<int64_t>(row) * maxp;
  for (int kv0 = kv_begin; kv0 < kv_stop; kv0 += kBK) {
    __syncthreads();  // the previous tile's K and P are consumed
    for (int c = w; c < kBK; c += kWarps) {
      const int pos = kv0 + c;
      int64_t tok = -1;
      float sc = 1.f;
      if (pos < kv_stop) {
        tok = static_cast<int64_t>(pt[pos / ps]) * ps + pos % ps;
        if (KIND >= kInt8) {
          sc = scale_pages[tok];
          sc = sc > 0.f ? sc : 1.f;
        }
      }
      for (int ch = lane; ch < n_chunks; ch += 32) {
        const int d = ch * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (tok >= 0)
          val = d < d_c ? load_latent4<KIND>(c_pages, tok, d_c, d, sc, code_s)
                        : load_rope4<KIND>(r_pages, tok, d_r, d - d_c);
        *reinterpret_cast<float4*>(&k_s[c * stride + d]) = val;
      }
    }
    __syncthreads();
    if (!warp_live) continue;  // warp-uniform; the next sync is at the top

    // scores: a 4 x 4 tile over this lane's chunks of the width
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    const float* qw = q_s + (4 * w) * stride;
    const float* kw = k_s + (4 * tc) * stride;
#pragma unroll 2
    for (int ch = ds; ch < n_chunks; ch += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(&qw[r * stride + ch * 4]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&kw[c * stride + ch * 4]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qv[r].x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv[r].y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv[r].z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv[r].w, kv[c].w, s[r][c]);
        }
    }
    // reduce-scatter over the four ds lanes: lanes with ds odd keep rows 2
    // and 3, then lanes with ds >= 2 keep the second of their two rows
    float half[2][4];
    const bool odd = ds & 1;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float send = odd ? s[r][c] : s[r + 2][c];
        const float keep = odd ? s[r + 2][c] : s[r][c];
        half[r][c] = keep + __shfl_xor_sync(kFull, send, 1);
      }
    float sv[4];
    const bool upper = ds & 2;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float send = upper ? half[0][c] : half[1][c];
      const float keep = upper ? half[1][c] : half[0][c];
      sv[c] = keep + __shfl_xor_sync(kFull, send, 2);
    }

    // online softmax of row my_r over the tile's 32 columns (8 tc lanes)
    float mx = kMaskValue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int pos = kv0 + 4 * tc + c;
      sv[c] = (pos <= my_qpos && pos < kv_stop) ? sv[c] * scale : kMaskValue;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sv[c] = expf(sv[c] - m_new);
      sum += sv[c];
    }
    sum += __shfl_xor_sync(kFull, sum, 4);
    sum += __shfl_xor_sync(kFull, sum, 8);
    sum += __shfl_xor_sync(kFull, sum, 16);
    l = l * alpha + sum;
    m = m_new;
    float* pw = p_s + w * 4 * kBK;
    *reinterpret_cast<float4*>(&pw[my_r * kBK + 4 * tc]) =
        make_float4(sv[0], sv[1], sv[2], sv[3]);
    __syncwarp();

    // output: rescale, then acc += P V with V the tile's first d_c columns
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // row r's state lives in the lanes with ds = 2 (r & 1) + (r >> 1)
      const float a = __shfl_sync(kFull, alpha, ((r & 1) << 1) | (r >> 1));
#pragma unroll
      for (int j = 0; j < CP; ++j) acc[r][j] *= a;
    }
#pragma unroll 2
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      float pr[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(&pw[r * kBK + k4]);
        pr[r][0] = p4.x;
        pr[r][1] = p4.y;
        pr[r][2] = p4.z;
        pr[r][3] = p4.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* vrow = k_s + (k4 + kk) * stride;
#pragma unroll
        for (int j4 = 0; j4 < CP / 4; ++j4) {
          const int c = j4 * 128 + lane * 4;
          if (c < d_c) {
            const float4 v = *reinterpret_cast<const float4*>(&vrow[c]);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc[r][j4 * 4 + 0] = fmaf(pr[r][kk], v.x, acc[r][j4 * 4 + 0]);
              acc[r][j4 * 4 + 1] = fmaf(pr[r][kk], v.y, acc[r][j4 * 4 + 1]);
              acc[r][j4 * 4 + 2] = fmaf(pr[r][kk], v.z, acc[r][j4 * 4 + 2]);
              acc[r][j4 * 4 + 3] = fmaf(pr[r][kk], v.w, acc[r][j4 * 4 + 3]);
            }
          }
        }
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float lr = __shfl_sync(kFull, l, ((r & 1) << 1) | (r >> 1));
    const float mr = __shfl_sync(kFull, m, ((r & 1) << 1) | (r >> 1));
    const float denom = lr == 0.f ? 1.f : lr;
    const int pair = pair0 + 4 * w + r;
    if (pair >= n_pairs) continue;
    if (row_split) {
      // this slice's state: a slice in which the pair saw no key keeps
      // max = kMaskValue and weighs nothing in the merge
      const int64_t slot =
          (static_cast<int64_t>(row) * kSplitPairs + pair) * n_splits + split;
      if (lane == 0) {
        ws_ml[slot * 2] = mr;
        ws_ml[slot * 2 + 1] = lr;
      }
      float* dst = ws_acc + slot * d_c;
#pragma unroll
      for (int j4 = 0; j4 < CP / 4; ++j4) {
        const int c = j4 * 128 + lane * 4;
        if (c < d_c)
          *reinterpret_cast<float4*>(&dst[c]) =
              make_float4(acc[r][j4 * 4 + 0], acc[r][j4 * 4 + 1],
                          acc[r][j4 * 4 + 2], acc[r][j4 * 4 + 3]);
      }
      continue;
    }
    float* dst = out + (pair_base + 4 * w + r) * d_c;
#pragma unroll
    for (int j4 = 0; j4 < CP / 4; ++j4) {
      const int c = j4 * 128 + lane * 4;
      if (c < d_c)
        *reinterpret_cast<float4*>(&dst[c]) = make_float4(
            acc[r][j4 * 4 + 0] / denom, acc[r][j4 * 4 + 1] / denom,
            acc[r][j4 * 4 + 2] / denom, acc[r][j4 * 4 + 3] / denom);
    }
  }
}

// Merges the KV slices of the split rows: grid (kSplitPairs, n_rows), one
// block per (row, pair), a thread per four output columns.
__global__ void __launch_bounds__(128)
latent_merge_kernel(const float* __restrict__ ws_acc,
                    const float* __restrict__ ws_ml, float* __restrict__ out,
                    const int* __restrict__ q_lens,
                    const int* __restrict__ cu_q, int n_tokens, int nh,
                    int d_c, int max_q, int n_splits) {
  const int row = blockIdx.y;
  const int pair = blockIdx.x;
  const int start = cu_q[row];
  const int qlen = min(min(q_lens[row], max_q), n_tokens - start);
  const int n_pairs = qlen > 0 ? qlen * nh : 0;
  if (n_pairs > kSplitPairs || pair >= n_pairs) return;
  const int64_t slot0 =
      (static_cast<int64_t>(row) * kSplitPairs + pair) * n_splits;
  float mm = kMaskValue;
  for (int s = 0; s < n_splits; ++s) mm = fmaxf(mm, ws_ml[(slot0 + s) * 2]);
  float ll = 0.f;
  for (int s = 0; s < n_splits; ++s)
    ll += ws_ml[(slot0 + s) * 2 + 1] * expf(ws_ml[(slot0 + s) * 2] - mm);
  const float denom = ll == 0.f ? 1.f : ll;
  float* dst = out + (static_cast<int64_t>(start) * nh + pair) * d_c;
  for (int c = threadIdx.x * 4; c < d_c; c += 4 * blockDim.x) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_splits; ++s) {
      const float f = expf(ws_ml[(slot0 + s) * 2] - mm);
      const float4 v =
          *reinterpret_cast<const float4*>(&ws_acc[(slot0 + s) * d_c + c]);
      a.x = fmaf(v.x, f, a.x);
      a.y = fmaf(v.y, f, a.y);
      a.z = fmaf(v.z, f, a.z);
      a.w = fmaf(v.w, f, a.w);
    }
    *reinterpret_cast<float4*>(&dst[c]) =
        make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom);
  }
}

template <int CP, int KIND>
cudaError_t launch(const float* q, const void* c_pages, const void* r_pages,
                   const float* scale_pages, const Codebook& code, float* out,
                   const int* q_lens, const int* cu_q, const int* page_tables,
                   const int* ctx_lens, int n_tokens, int nh, int d_c, int d_r,
                   int ps, int n_rows, int maxp, int max_q, float scale,
                   float* ws_acc, float* ws_ml, int n_splits,
                   cudaStream_t stream) {
  auto kernel = latent_ragged_paged_attention_kernel<CP, KIND>;
  const int stride = d_c + d_r + 4;
  const int smem = ((kBM + kBK) * stride + kWarps * 4 * kBK + 16) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (static_cast<int64_t>(max_q) * nh + kBM - 1) / kBM;
  // KV positions per slice, a whole number of tiles
  const int split_len =
      ((maxp * ps + n_splits - 1) / n_splits + kBK - 1) / kBK * kBK;
  const dim3 grid(static_cast<unsigned>(tiles + (n_splits - 1) * kSplitTiles),
                  n_rows);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, c_pages, r_pages, scale_pages, code, out, q_lens, cu_q, page_tables,
      ctx_lens, n_tokens, nh, d_c, d_r, ps, maxp, max_q, scale, ws_acc, ws_ml,
      n_splits, split_len);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  latent_merge_kernel<<<dim3(kSplitPairs, n_rows), 128, 0, stream>>>(
      ws_acc, ws_ml, out, q_lens, cu_q, n_tokens, nh, d_c, max_q, n_splits);
  return cudaGetLastError();
}

template <int CP>
cudaError_t launch_kind(int kind, const float* q, const void* c_pages,
                        const void* r_pages, const float* scale_pages,
                        const Codebook& code, float* out, const int* q_lens,
                        const int* cu_q, const int* page_tables,
                        const int* ctx_lens, int n_tokens, int nh, int d_c,
                        int d_r, int ps, int n_rows, int maxp, int max_q,
                        float scale, float* ws_acc, float* ws_ml,
                        int n_splits, cudaStream_t stream) {
#define HETU_LATENT_LAUNCH(KIND)                                             \
  return launch<CP, KIND>(q, c_pages, r_pages, scale_pages, code, out,       \
                          q_lens, cu_q, page_tables, ctx_lens, n_tokens, nh, \
                          d_c, d_r, ps, n_rows, maxp, max_q, scale, ws_acc,  \
                          ws_ml, n_splits, stream)
  switch (kind) {
    case kFp32: HETU_LATENT_LAUNCH(kFp32);
    case kBf16: HETU_LATENT_LAUNCH(kBf16);
    case kInt8: HETU_LATENT_LAUNCH(kInt8);
    case kPacked4: HETU_LATENT_LAUNCH(kPacked4);
  }
#undef HETU_LATENT_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// kind: 0 = fp32 pages, 1 = bf16 pages, 2 = int8 codes, 3 = packed 4-bit
// codes; `codebook` points at 16 host floats (read for kind 3).  r_pages is
// null when d_r == 0, scale_pages is null for kinds 0 and 1.  d_c and d_r
// are multiples of 4, d_c <= 512, d_c + d_r <= 640.  The output must be
// zeroed by the caller; the kernels allocate nothing.  With n_splits > 1 the
// caller gives fp32 workspaces ws_acc [n_rows, 128, n_splits, d_c] and ws_ml
// [n_rows, 128, n_splits, 2] for the rows of at most 128 (token, head) pairs.
int hetu_latent_ragged_paged_attention(
    const void* q, const void* c_pages, const void* r_pages,
    const void* scale_pages, const void* codebook, void* out,
    const void* q_lens, const void* cu_q, const void* page_tables,
    const void* ctx_lens, void* ws_acc, void* ws_ml, int n_tokens, int nh,
    int d_c, int d_r, int ps, int n_rows, int maxp, int max_q, int kind,
    int n_splits, float scale, void* stream) {
  if (n_splits < 1 || n_splits > 65535 ||
      (n_splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)) ||
      nh < 1 || max_q < 1 || ps < 1 || maxp < 1 || n_rows < 1 ||
      n_rows > 65535 || d_c < 4 || d_c % 4 != 0 || d_r < 0 || d_r % 4 != 0 ||
      d_c > 512 || d_c + d_r > 640 || kind < kFp32 || kind > kPacked4 ||
      (d_r > 0 && (r_pages == nullptr || kind >= kInt8)) ||
      (kind >= kInt8 && scale_pages == nullptr) || codebook == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Codebook code;
  for (int i = 0; i < 16; ++i)
    code.v[i] = static_cast<const float*>(codebook)[i];
  const auto* qf = static_cast<const float*>(q);
  const auto* sp = static_cast<const float*>(scale_pages);
  auto* of = static_cast<float*>(out);
  const auto* ql = static_cast<const int*>(q_lens);
  const auto* cu = static_cast<const int*>(cu_q);
  const auto* ptab = static_cast<const int*>(page_tables);
  const auto* cl = static_cast<const int*>(ctx_lens);
  auto* wa = static_cast<float*>(ws_acc);
  auto* wm = static_cast<float*>(ws_ml);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d_c <= 128)
    err = launch_kind<4>(kind, qf, c_pages, r_pages, sp, code, of, ql, cu,
                         ptab, cl, n_tokens, nh, d_c, d_r, ps, n_rows, maxp,
                         max_q, scale, wa, wm, n_splits, st);
  else if (d_c <= 256)
    err = launch_kind<8>(kind, qf, c_pages, r_pages, sp, code, of, ql, cu,
                         ptab, cl, n_tokens, nh, d_c, d_r, ps, n_rows, maxp,
                         max_q, scale, wa, wm, n_splits, st);
  else
    err = launch_kind<16>(kind, qf, c_pages, r_pages, sp, code, of, ql, cu,
                          ptab, cl, n_tokens, nh, d_c, d_r, ps, n_rows, maxp,
                          max_q, scale, wa, wm, n_splits, st);
  return static_cast<int>(err);
}

const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
