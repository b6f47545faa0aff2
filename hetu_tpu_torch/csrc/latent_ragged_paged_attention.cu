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
// per cached token in scale_pages (a scale <= 0 reads as 1).  Products keep
// about 16 (bf16 terms) or 21 (TF32 terms) of fp32's 24 mantissa bits of q
// and p against exactly dequantized values, accumulated in fp32.  Masked
// scores take -0.7 * FLT_MAX (the wgmma route: no weight), a row whose
// softmax sum is 0 gives 0, and tokens that belong to no row are left as
// the caller zeroed them.
//
// What bounds it on an H100: all nh heads share the one KV stream, so the
// (token, head) pairs of a row form the M axis of both products and each
// cached token does 2 * nh * (2 d_c + d_r) operations for every query that
// sees it.  At nh 32, d_c 512, d_r 64 a decode row does ~60 operations per
// bf16 KV byte and a 512-token chunk ~30,000: with fp32 q and p in two
// terms against the pages' exact values both are bound by operations
// (two bf16 terms at 989 TFLOP/s, or two or three TF32 terms at 495,
// against 3.35 TB/s).
//
// Two routes, picked by the page kind, the widths, the page size and the
// row count alone (the wrapper's latent_route):
//
// The wgmma route (latent_ragged_paged_attention_wgmma_kernel, below):
// bf16 pages at d_c a multiple of 64 up to 512 and d_r 0 or 64, pages of a
// multiple of 8 positions and at most kWgMaxRows rows, the serving path.  q and p split into two bf16 terms each (x = hi + lo, 16
// of fp32's 24 bits), the bf16 pages and rope keys exact, every product on
// Hopper's wgmma in fp32 accumulators; the two terms are stacked as the
// rows of one 64-row product, so an item of 32 (token, head) pairs fills
// wgmma's M and a decode token at nh 32 wastes nothing.  TMA loads the KV
// tiles from the page table (one thread of a producer warpgroup, an
// mbarrier ring), two consumer warpgroups split S's k-steps and O's
// columns, and one persistent block an SM walks the items (the chunk
// rows' tiles longest first, then the decode rows' KV slices, so that
// decode rows spread over the card); the slices are merged by
// latent_merge_kernel.  The kernel's own note has the details.
//
// The mma.sync route (latent_ragged_paged_attention_kernel): every other
// kind, width, page size and batch.  What its design does:
//  - Every product runs on the tensor cores, mma.sync m16n8k8 on TF32 with
//    fp32 accumulation (mma_tf32.cuh), in split terms (x = hi + lo): fp32
//    q and p by values that are exact in TF32 -- bf16 latents and rope
//    keys, int8 codes -- take two terms (q_lo.k + q_hi.k); by nf4
//    codebook values and fp32 pages, three (3xTF32).  The per-token scale
//    of int8 (scale / 127) and nf4 pages is folded into the score column
//    after S and into P before P.V, so the products see the bare codes; a
//    scale <= 0 reads as 1.  That moves fp32 rounding only (~1e-7).
//  - The TPU block holds a whole chunk's q (t_pad x gp x (d_c + d_r)) and an
//    accumulator of max_q * gp x d_c in VMEM; at the widths above one query
//    token alone is 74 KB of q and 64 KB of accumulator.  Here a block of
//    16 warps owns a tile of 32 (token, head) pairs, two 16-row m-tiles, and
//    runs the page loop itself: its q tile (32 x (d_c + d_r), fp32) and the
//    KV tiles of 32 positions lie in shared memory (201 KB at d_c 512, d_r
//    64: one block an SM, whose 16 warps hide each other's latencies).
//  - A KV tile is read from device memory once per tile of 32 pairs and
//    used twice, as K (all d_c + d_r columns) and as V (the first d_c).
//    bf16 pages (at widths the wgmma route does not take) stay bf16 in
//    shared memory: cp.async copies the next tile into a second buffer
//    while the current one is multiplied, and ldmatrix (.trans for V)
//    hands each lane a bf16 pair
//    (k = 2 tq, 2 tq + 1) that a shift and a mask turn into exact TF32
//    operands, in the permuted k order of mma_tf32.cuh; q is read in the
//    same order by 8-byte loads.  fp32, int8 and 4-bit pages are
//    dequantized once into an fp32 tile (row stride a multiple of 8 floats
//    plus 4, as mma_tf32.cuh's loads want).
//  - The 512-wide output is the register problem (16 pairs x 512 columns
//    is 256 fp32 registers a thread), so O is split by columns,
//    FlashMLA-style: warp (mt, part) holds m-tile mt's O for columns
//    part * 8 NT .. + 8 NT (32 registers at d_c 512).  S is formed by the
//    same 8 warps split over the width: each sums every eighth k-step of
//    Q K^T (9 of 72 at d 576, a short chain in the tensor cores'
//    accumulator) and the partials are added in fp32 through shared
//    memory.  16 threads a row then run the online softmax and write P
//    (times the folded scale) already split into its TF32 hi and lo parts,
//    which every warp of the m-tile reads as the A operand of P.V; P.V
//    chains kTf32Chain k-steps and is added to O in fp32.
//  - The KV loop stops at the last position the tile's pairs can see; rows
//    with q_len == 0 and idle tiles exit at once; table slots past the
//    context are never read; the tiles of long rows run longest first.
//    Offsets are 64-bit.
//  - A decode row is one tile (nh 32), so a batch of 8 decode rows would
//    keep 8 of 132 SMs busy, each walking up to 128 KV tiles.  Rows of at
//    most 128 pairs are therefore split over the KV axis: the grid's first
//    blocks are one per (row, tile, KV slice after the first), the slices'
//    (max, sum, unnormalized output) go to an fp32 workspace and a small
//    kernel merges them.  Longer rows (prefill chunks) have hundreds of
//    tiles already and stay unsplit.
//  - Not yet: the fp32, int8 and 4-bit pages on the wgmma route; cp.async
//    for them here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kBM = 32;        // (token, query head) pairs per block
constexpr int kBK = 32;        // KV positions per tile
constexpr int kParts = 8;      // warps of an m-tile: shares of S's k-steps
                               // and of O's columns
constexpr int kThreads = 2 * kParts * 32;  // two m-tiles
constexpr int kWarps = kThreads / 32;
constexpr int kRowThreads = kThreads / kBM;  // softmax threads a row
static_assert(kBK / kRowThreads == 2, "two keys a softmax thread");
constexpr int kSLD = kBK + 8;  // row stride of the S partials and of P
constexpr int kSplitPairs = 128;  // rows of at most this many pairs are split
constexpr int kSplitTiles = kSplitPairs / kBM;
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr unsigned kFull = 0xffffffffu;
// k-steps of 8 that P.V chains in the tensor cores' accumulator before it
// is added to O in fp32 (mma_tf32.cuh: longer chains lose bits)
constexpr int kTf32Chain = 2;

// how c_pages (and r_pages) are stored
constexpr int kFp32 = 0;
constexpr int kBf16 = 1;
constexpr int kInt8 = 2;
constexpr int kPacked4 = 3;

// TF32 terms of a product with the KV values of this page kind
template <int KIND>
__host__ __device__ constexpr int terms() {
  return KIND == kBf16 || KIND == kInt8 ? 2 : 3;
}

struct Codebook {
  float v[16];
};

// c += a.b on the tensor cores in TERMS TF32 terms: three (a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi) for an fp32 b, two (a_lo.b + a_hi.b) for a b that
// is exact in TF32 (b_lo unused).  Every latent product goes through here.
template <int TERMS>
__device__ __forceinline__ void latent_mma(float* c, const uint32_t* a_hi,
                                           const uint32_t* a_lo,
                                           const uint32_t* b_hi,
                                           const uint32_t* b_lo) {
  if constexpr (TERMS == 3) {
    mma_3xtf32(c, a_hi, a_lo, b_hi, b_lo);
  } else {
    mma_tf32_1688(c, a_lo, b_hi[0], b_hi[1]);
    mma_tf32_1688(c, a_hi, b_hi[0], b_hi[1]);
  }
}

// the B operand bits of N KV values: split into TF32 parts where they are
// not exact in TF32, else as they are
template <int TERMS, int N, typename T>
__device__ __forceinline__ void kv_parts(const T (&x)[N], uint32_t (&hi)[N],
                                         uint32_t (&lo)[N]) {
  if constexpr (TERMS == 3) {
    split_tf32(x, hi, lo);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (std::is_same<T, float>::value)
        hi[i] = __float_as_uint(x[i]);
      else
        hi[i] = x[i];
    }
  }
}

// Four consecutive KV values of cached token `tok`, columns d .. d + 3, as
// the products take them: the latent in fp32, int8 codes as integers and
// 4-bit codes as codebook entries (their scale is folded in elsewhere).
template <int KIND>
__device__ __forceinline__ float4 load_latent4(const void* c_pages,
                                               int64_t tok, int d_c, int d,
                                               const float* code) {
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
    return make_float4(static_cast<float>(raw.x), static_cast<float>(raw.y),
                       static_cast<float>(raw.z), static_cast<float>(raw.w));
  } else {
    const uchar2 raw = *reinterpret_cast<const uchar2*>(
        static_cast<const unsigned char*>(c_pages) + tok * (d_c / 2) + d / 2);
    // the even element of a pair is the high nibble
    const int hi0 = raw.x >> 4, lo0 = raw.x & 0xF;
    const int hi1 = raw.y >> 4, lo1 = raw.y & 0xF;
    return make_float4(code[hi0], code[lo0], code[hi1], code[lo1]);
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

// 8 bytes global -> shared, zero-filled when !valid (no bytes are read
// then; src must still be a valid address)
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// The two TF32 values (k = 2 tq, 2 tq + 1) of a bf16 pair that ldmatrix
// gives a lane, as the B operand bits of one m16n8k8 TF32 product in the
// k order of a_from_c: exact, a bf16 is the top half of its fp32.
__device__ __forceinline__ void bf16_pair_b(uint32_t r, uint32_t (&b)[2]) {
  b[0] = r << 16;
  b[1] = r & 0xffff0000u;
}

// bf16 pages take the raw-tile path: the KV tile stays bf16 in shared
// memory, copied from the pages by cp.async into one of two buffers while
// the other is multiplied, and its TF32 operands come from ldmatrix
// (exact).  Other kinds are dequantized into an fp32 tile.
template <int KIND>
__host__ __device__ constexpr bool raw_tile() {
  return KIND == kBf16;
}

// shared memory floats of a block: q (ldq floats a row) and KV tiles (ldk
// floats a row, or two buffers of ldk bf16 a row), the S partials, P's
// TF32 parts, the rows' alpha, max and sum, the folded column scales and
// the codebook
__host__ __device__ constexpr int latent_smem_floats(int ldq, int ldk) {
  return kBM * ldq + kBK * ldk + (kParts + 2) * kBM * kSLD + 3 * kBM + kBK +
         16;
}

// NT: n-tiles of O a warp holds, d_c <= 8 kParts NT.  kw: the width d_c +
// d_r rounded up to k-steps of 8; wide = max(kw, 8 kParts NT), the columns
// a KV tile
// holds.  Strides (launch_kind): the raw-tile path reads q by 8-byte loads
// (ldq = a multiple of 32 plus 8 floats) and the bf16 tile by ldmatrix
// (ldk = a multiple of 64 plus 8 bf16); the fp32 tile path reads both by
// ldmatrix (ldq = ldk = wide + 4).  All conflict-free.
template <int NT, int KIND>
__global__ void __launch_bounds__(kThreads, 1)
latent_ragged_paged_attention_kernel(
    const float* __restrict__ q, const void* __restrict__ c_pages,
    const void* __restrict__ r_pages, const float* __restrict__ scale_pages,
    const Codebook code, float* __restrict__ out,
    const int* __restrict__ q_lens, const int* __restrict__ cu_q,
    const int* __restrict__ page_tables, const int* __restrict__ ctx_lens,
    int n_tokens, int nh, int d_c, int d_r, int ps, int maxp, int max_q,
    float scale, float* __restrict__ ws_acc, float* __restrict__ ws_ml,
    int n_splits, int split_len, int kw, int ldq, int ldk) {
  constexpr int TERMS = terms<KIND>();
  constexpr bool kRaw = raw_tile<KIND>();
  constexpr bool kScaled = KIND >= kInt8;  // a folded scale a cached token
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_s = smem;                        // [kBM][ldq]  q of the tile
  float* k_s = q_s + kBM * ldq;             // [kBK][ldk]  fp32 KV tile, or
  bf16* kv_s = reinterpret_cast<bf16*>(k_s);  // [2][kBK][ldk] bf16 tiles
  float* s_s = k_s + kBK * ldk;             // [kParts][kBM][kSLD] S partials
  uint32_t* ph_s = reinterpret_cast<uint32_t*>(s_s + kParts * kBM * kSLD);
  uint32_t* pl_s = ph_s + kBM * kSLD;       // [kBM][kSLD] P hi, lo
  float* row_s = reinterpret_cast<float*>(pl_s + kBM * kSLD);  // [3][kBM]
  float* cs_s = row_s + 3 * kBM;            // [kBK] folded scales
  float* code_s = cs_s + kBK;               // [16]

  const int row = blockIdx.y;
  const int start = cu_q[row];
  const int qlen_row = q_lens[row];
  const int qlen = min(min(qlen_row, max_q), n_tokens - start);
  const int n_pairs = qlen > 0 ? qlen * nh : 0;
  // gridDim.x: first the short rows' tiles for the KV slices 1 .. n_splits
  // - 1 (kSplitTiles blocks a slice), then every tile with slice 0, the
  // last (longest) tile first
  const int extra = (n_splits - 1) * kSplitTiles;
  const int bx = blockIdx.x;
  const int split = bx < extra ? 1 + bx / kSplitTiles : 0;
  const int tile = bx < extra ? bx % kSplitTiles
                              : static_cast<int>(gridDim.x) - 1 - bx;
  const int pair0 = tile * kBM;
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
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int mt = w / kParts;       // the warp's m-tile: pairs 16 mt ..
  const int part = w % kParts;     // its share of S's k-steps, O's columns
  const int n0 = part * 8 * NT;    // its first output column
  const int width = d_c + d_r;
  constexpr int kOCols = 8 * kParts * NT;  // output columns of a block
  const int wide = kw > kOCols ? kw : kOCols;  // columns of a KV tile
  // q and out are [T * nh, width] and [T * nh, d_c]: the pairs of a row are
  // consecutive rows of both
  const int64_t pair_base = static_cast<int64_t>(start) * nh + pair0;
  const int* pt = page_tables + static_cast<int64_t>(row) * maxp;

  // cp.async of the bf16 KV tile at positions kv0 .. kv0 + kBK - 1 into
  // buffer nb, 8 bytes (4 values) a copy; positions past the slice are 0
  auto issue_raw_tile = [&](int kv0, int nb) {
    const int n4 = width / 4;
    bf16* dst = kv_s + nb * kBK * ldk;
    for (int e = tid; e < kBK * n4; e += kThreads) {
      const int c = e / n4;
      const int d = (e % n4) * 4;
      const int pos = kv0 + c;
      const bool live = pos < kv_stop;
      const int64_t tok =
          live ? static_cast<int64_t>(pt[pos / ps]) * ps + pos % ps : 0;
      const bf16* src =
          d < d_c ? static_cast<const bf16*>(c_pages) + tok * d_c + d
                  : static_cast<const bf16*>(r_pages) + tok * d_r + d - d_c;
      cp_async8(dst + c * ldk + d, src, live);
    }
  };

  if (tid < 16) code_s[tid] = code.v[tid];
  if constexpr (kRaw) {
    // the tiles' columns past the width stay 0 (cp.async never writes
    // them); tile kv_begin is in flight while q is read
    for (int e = tid; e < 2 * kBK * (ldk - width); e += kThreads) {
      const int r = e / (ldk - width);
      kv_s[r * ldk + width + e % (ldk - width)] = __float2bfloat16(0.f);
    }
    if (kv_begin < kv_stop) issue_raw_tile(kv_begin, 0);
    cp_async_commit();
  }
  // q: rows past the row's pairs and columns past the width are 0
  const int q4 = kw / 4;
  for (int e = tid; e < kBM * q4; e += kThreads) {
    const int r = e / q4;
    const int d = (e % q4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pair0 + r < n_pairs && d < width)
      val = *reinterpret_cast<const float4*>(q + (pair_base + r) * width + d);
    *reinterpret_cast<float4*>(&q_s[r * ldq + d]) = val;
  }

  // the online softmax of row sr runs on kRowThreads threads (keys sc2 and
  // sc2 + 1 of each tile), which keep its max and sum
  const int sr = tid / kRowThreads;
  const int sc2 = (tid % kRowThreads) * 2;
  const int s_pair = pair0 + sr;
  const int s_qpos = s_pair < n_pairs ? qpos0 + s_pair / nh : -1;
  float m = kMaskValue, l = 0.f;
  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.f;

  for (int kv0 = kv_begin, it = 0; kv0 < kv_stop; kv0 += kBK, ++it) {
    const bf16* kvt = kv_s + (it & 1) * kBK * ldk;  // this tile (raw path)
    if constexpr (kRaw) {
      // this tile has landed, and every warp is done with the previous
      // one, whose buffer takes the next tile
      cp_async_wait<0>();
      __syncthreads();
      if (kv0 + kBK < kv_stop) issue_raw_tile(kv0 + kBK, (it + 1) & 1);
      cp_async_commit();
    } else {
      __syncthreads();  // the previous tile's K, P and alpha are consumed
      // the KV tile: warp w fills positions w, w + 8, ...; positions past
      // the slice and columns past the width are 0
      for (int c = w; c < kBK; c += kWarps) {
        const int pos = kv0 + c;
        int64_t tok = -1;
        float sc = 0.f;
        if (pos < kv_stop) {
          tok = static_cast<int64_t>(pt[pos / ps]) * ps + pos % ps;
          if (kScaled) {
            sc = scale_pages[tok];
            sc = sc > 0.f ? sc : 1.f;
            if (KIND == kInt8) sc /= 127.0f;
          }
        }
        if (kScaled && lane == 0) cs_s[c] = sc;
        for (int ch = lane; ch < wide / 4; ch += 32) {
          const int d = ch * 4;
          float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
          if (tok >= 0 && d < width)
            val = d < d_c ? load_latent4<KIND>(c_pages, tok, d_c, d, code_s)
                          : load_rope4<KIND>(r_pages, tok, d_r, d - d_c);
          *reinterpret_cast<float4*>(&k_s[c * ldk + d]) = val;
        }
      }
      __syncthreads();
    }

    // S partial = Q K^T of m-tile mt over k-steps part, part + kParts, ...
    {
      float s[kBK / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
      auto k_step = [&](int kk, float (&acc)[kBK / 8][4]) {
        uint32_t ahi[4], alo[4];
        if constexpr (kRaw) {
          // A in the k order of bf16_pair_b: rows gq, gq + 8; columns
          // 2 tq (k = tq) and 2 tq + 1 (k = tq + 4)
          const float* qr = q_s + (16 * mt + gq) * ldq + 8 * kk + 2 * tq;
          const float2 a0 = *reinterpret_cast<const float2*>(qr);
          const float2 a1 = *reinterpret_cast<const float2*>(qr + 8 * ldq);
          const float a[4] = {a0.x, a1.x, a0.y, a1.y};
          split_tf32(a, ahi, alo);
          // B of the 4 n-tiles (keys 8 j ..): matrix j = lane / 8
          uint32_t r[4];
          ldmatrix_x4(r, kvt + (lane & 31) * ldk + 8 * kk);
#pragma unroll
          for (int j = 0; j < kBK / 8; ++j) {
            uint32_t b[2];
            bf16_pair_b(r[j], b);
            latent_mma<TERMS>(acc[j], ahi, alo, b, b);
          }
        } else {
          uint32_t a[4];
          load_a_f32(a, q_s, ldq, 16 * mt, 8 * kk, lane);
          split_tf32(a, ahi, alo);
#pragma unroll
          for (int np = 0; np < kBK / 16; ++np) {
            uint32_t b[4], bhi[4], blo[4];
            load_b_f32(b, k_s, ldk, 16 * np, 8 * kk, lane);
            kv_parts<TERMS>(b, bhi, blo);
            latent_mma<TERMS>(acc[2 * np], ahi, alo, bhi, blo);
            latent_mma<TERMS>(acc[2 * np + 1], ahi, alo, bhi + 2, blo + 2);
          }
        }
      };
      for (int kk = part; kk < kw / 8; kk += kParts) k_step(kk, s);
      float* dst = s_s + (part * kBM + 16 * mt + gq) * kSLD + 2 * tq;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        *reinterpret_cast<float2*>(dst + 8 * nt) =
            make_float2(s[nt][0], s[nt][1]);
        *reinterpret_cast<float2*>(dst + 8 * kSLD + 8 * nt) =
            make_float2(s[nt][2], s[nt][3]);
      }
    }
    __syncthreads();

    // online softmax of row sr over the tile's keys sc2, sc2 + 1: the
    // partials added in fp32, the folded scale, the mask
    {
      float2 v2 = *reinterpret_cast<const float2*>(&s_s[sr * kSLD + sc2]);
#pragma unroll
      for (int p = 1; p < kParts; ++p) {
        const float2 w2 =
            *reinterpret_cast<const float2*>(&s_s[(p * kBM + sr) * kSLD + sc2]);
        v2.x += w2.x;
        v2.y += w2.y;
      }
      float sv[2] = {v2.x, v2.y}, cs[2] = {1.f, 1.f};
      if (kScaled) {
        const float2 c2 = *reinterpret_cast<const float2*>(&cs_s[sc2]);
        cs[0] = c2.x;
        cs[1] = c2.y;
      }
      float mx = kMaskValue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int pos = kv0 + sc2 + c;
        if (kScaled) sv[c] *= cs[c];
        sv[c] = (pos <= s_qpos && pos < kv_stop) ? sv[c] * scale : kMaskValue;
        mx = fmaxf(mx, sv[c]);
      }
#pragma unroll
      for (int off = 1; off < kRowThreads; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        sv[c] = expf(sv[c] - m_new);
        sum += sv[c];
        if (kScaled) sv[c] *= cs[c];  // P times the folded scale, for P V
      }
#pragma unroll
      for (int off = 1; off < kRowThreads; off <<= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      l = l * alpha + sum;
      m = m_new;
      uint32_t hi[2], lo[2];
      split_tf32(sv, hi, lo);
      *reinterpret_cast<uint2*>(&ph_s[sr * kSLD + sc2]) =
          make_uint2(hi[0], hi[1]);
      *reinterpret_cast<uint2*>(&pl_s[sr * kSLD + sc2]) =
          make_uint2(lo[0], lo[1]);
      if (tid % kRowThreads == 0) row_s[sr] = alpha;
    }
    __syncthreads();

    // O = alpha O + P V for m-tile mt, columns n0 .. n0 + 8 NT - 1: P's
    // parts in the k order of load_b_f32_trans and bf16_pair_b (k = tq at
    // key 2 tq, k = tq + 4 at key 2 tq + 1), kTf32Chain k-steps in a
    // zeroed accumulator added to O in fp32
    {
      const float a0 = row_s[16 * mt + gq], a1 = row_s[16 * mt + gq + 8];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][0] *= a0;
        o[nt][1] *= a0;
        o[nt][2] *= a1;
        o[nt][3] *= a1;
      }
      static_assert(kTf32Chain == 2, "the raw path reads two k-steps a load");
      // one chain of k-steps at a time: unrolled, the loads of both would
      // be hoisted and spill at the 128 registers a thread of 512 has
#pragma unroll 1
      for (int kc = 0; kc < kBK / 8; kc += kTf32Chain) {
        uint32_t phi[kTf32Chain][4], plo[kTf32Chain][4];
#pragma unroll
        for (int j = 0; j < kTf32Chain; ++j) {
          // rows gq and gq + 8 of the m-tile, keys 2 tq and 2 tq + 1
          const int at = (16 * mt + gq) * kSLD + 8 * (kc + j) + 2 * tq;
          const int at8 = at + 8 * kSLD;
          const uint2 h0 = *reinterpret_cast<const uint2*>(&ph_s[at]);
          const uint2 h1 = *reinterpret_cast<const uint2*>(&ph_s[at8]);
          const uint2 l0 = *reinterpret_cast<const uint2*>(&pl_s[at]);
          const uint2 l1 = *reinterpret_cast<const uint2*>(&pl_s[at8]);
          phi[j][0] = h0.x;
          phi[j][1] = h1.x;
          phi[j][2] = h0.y;
          phi[j][3] = h1.y;
          plo[j][0] = l0.x;
          plo[j][1] = l1.x;
          plo[j][2] = l0.y;
          plo[j][3] = l1.y;
        }
        if constexpr (kRaw) {
          // V = the tile's first columns, by ldmatrix.trans: matrix
          // (lane / 8) holds k-step kc + (lane / 8) % 2 of n-tile
          // (lane / 16) of each pair of n-tiles
          const bf16* vr = kvt + (8 * (kc + ((lane >> 3) & 1)) + (lane & 7)) *
                                     ldk + n0 + 8 * (lane >> 4);
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, vr + 16 * np);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int j = 0; j < kTf32Chain; ++j) {
                uint32_t b[2];
                bf16_pair_b(r[2 * h + j], b);
                latent_mma<TERMS>(t, phi[j], plo[j], b, b);
              }
              add_c(o[2 * np + h], t);
            }
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int j = 0; j < kTf32Chain; ++j) {
              float bv[2];
              uint32_t bhi[2], blo[2];
              load_b_f32_trans(bv, k_s, ldk, n0 + 8 * nt, 8 * (kc + j), lane);
              kv_parts<TERMS>(bv, bhi, blo);
              latent_mma<TERMS>(t, phi[j], plo[j], bhi, blo);
            }
            add_c(o[nt], t);
          }
        }
      }
    }
  }

  // the rows' max and sum, for the warps that hold their outputs (alpha's
  // slots may still be read by a slower warp: these are others)
  if (tid % kRowThreads == 0) {
    row_s[kBM + sr] = m;
    row_s[2 * kBM + sr] = l;
  }
  __syncthreads();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = 16 * mt + gq + 8 * hr;
    const int pair = pair0 + r;
    if (pair >= n_pairs) continue;
    const float mr = row_s[kBM + r], lr = row_s[2 * kBM + r];
    float* dst;
    float inv = 1.f;
    if (row_split) {
      // this slice's state: a slice in which the pair saw no key keeps
      // max = kMaskValue and weighs nothing in the merge
      const int64_t slot =
          (static_cast<int64_t>(row) * kSplitPairs + pair) * n_splits + split;
      if (part == 0 && tq == 0) {
        ws_ml[slot * 2] = mr;
        ws_ml[slot * 2 + 1] = lr;
      }
      dst = ws_acc + slot * d_c;
    } else {
      inv = 1.f / (lr == 0.f ? 1.f : lr);
      dst = out + (pair_base + r) * d_c;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = n0 + 8 * nt + 2 * tq;
      if (c < d_c)
        *reinterpret_cast<float2*>(&dst[c]) =
            make_float2(o[nt][2 * hr] * inv, o[nt][2 * hr + 1] * inv);
    }
  }
}

// A row of the batch as both routes see it: its first token, the (token,
// head) pairs it attends, the position of its query 0, and whether its
// short KV axis is split into slices.
struct LatentRow {
  int start;
  int n_pairs;
  int qpos0;
  bool split;
};

__device__ __forceinline__ LatentRow latent_row(
    int r, const int* __restrict__ q_lens, const int* __restrict__ cu_q,
    const int* __restrict__ ctx_lens, int n_tokens, int nh, int max_q,
    int n_splits) {
  LatentRow w;
  w.start = cu_q[r];
  const int qlen_row = q_lens[r];
  const int qlen = min(min(qlen_row, max_q), n_tokens - w.start);
  w.n_pairs = qlen > 0 ? qlen * nh : 0;
  w.qpos0 = ctx_lens[r] - qlen_row;
  w.split = n_splits > 1 && w.n_pairs > 0 && w.n_pairs <= kSplitPairs;
  return w;
}

// the KV positions that tile `tile` (kBM pairs) of row w sees: up to its
// last pair's query
__device__ __forceinline__ int latent_kv_end(const LatentRow& w, int tile,
                                             int nh, int cap) {
  const int last_pair = min(w.n_pairs, (tile + 1) * kBM) - 1;
  return min(w.qpos0 + last_pair / nh + 1, cap);
}

// the slices of split_len positions that hold any of kv_end positions
__device__ __forceinline__ int latent_live_slices(int kv_end, int split_len) {
  return kv_end > 0 ? (kv_end + split_len - 1) / split_len : 0;
}

// Merges the KV slices of the split rows: grid (kSplitPairs, n_rows), one
// block per (row, pair), a thread per four output columns.  Only the
// slices that hold a position the pair's tile sees are read: the wgmma
// route writes no other, and the mma.sync route's others hold max =
// kMaskValue and sum 0, which weigh nothing.
__global__ void __launch_bounds__(128)
latent_merge_kernel(const float* __restrict__ ws_acc,
                    const float* __restrict__ ws_ml, float* __restrict__ out,
                    const int* __restrict__ q_lens,
                    const int* __restrict__ cu_q,
                    const int* __restrict__ ctx_lens, int n_tokens, int nh,
                    int d_c, int max_q, int n_splits, int cap,
                    int split_len) {
  const int row = blockIdx.y;
  const int pair = blockIdx.x;
  const LatentRow w =
      latent_row(row, q_lens, cu_q, ctx_lens, n_tokens, nh, max_q, n_splits);
  if (w.n_pairs > kSplitPairs || pair >= w.n_pairs) return;
  const int n =
      latent_live_slices(latent_kv_end(w, pair / kBM, nh, cap), split_len);
  const int64_t slot0 =
      (static_cast<int64_t>(row) * kSplitPairs + pair) * n_splits;
  float mm = kMaskValue;
  for (int s = 0; s < n; ++s) mm = fmaxf(mm, ws_ml[(slot0 + s) * 2]);
  float ll = 0.f;
  for (int s = 0; s < n; ++s)
    ll += ws_ml[(slot0 + s) * 2 + 1] * expf(ws_ml[(slot0 + s) * 2] - mm);
  const float denom = ll == 0.f ? 1.f : ll;
  float* dst = out + (static_cast<int64_t>(w.start) * nh + pair) * d_c;
  for (int c = threadIdx.x * 4; c < d_c; c += 4 * blockDim.x) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n; ++s) {
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

template <int NT, int KIND>
cudaError_t launch(const float* q, const void* c_pages, const void* r_pages,
                   const float* scale_pages, const Codebook& code, float* out,
                   const int* q_lens, const int* cu_q, const int* page_tables,
                   const int* ctx_lens, int n_tokens, int nh, int d_c, int d_r,
                   int ps, int n_rows, int maxp, int max_q, float scale,
                   float* ws_acc, float* ws_ml, int n_splits,
                   cudaStream_t stream) {
  auto kernel = latent_ragged_paged_attention_kernel<NT, KIND>;
  const int kw = (d_c + d_r + 7) / 8 * 8;
  const int wide = kw > 8 * kParts * NT ? kw : 8 * kParts * NT;
  int ldq = wide + 4, ldk = wide + 4;
  if (raw_tile<KIND>()) {
    ldq = (kw + 31) / 32 * 32 + 8;
    ldk = (wide + 63) / 64 * 64 + 8;
  }
  const int smem =
      latent_smem_floats(ldq, ldk) * static_cast<int>(sizeof(float));
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
      n_splits, split_len, kw, ldq, ldk);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  latent_merge_kernel<<<dim3(kSplitPairs, n_rows), 128, 0, stream>>>(
      ws_acc, ws_ml, out, q_lens, cu_q, ctx_lens, n_tokens, nh, d_c, max_q,
      n_splits, maxp * ps, split_len);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_kind(int kind, const float* q, const void* c_pages,
                        const void* r_pages, const float* scale_pages,
                        const Codebook& code, float* out, const int* q_lens,
                        const int* cu_q, const int* page_tables,
                        const int* ctx_lens, int n_tokens, int nh, int d_c,
                        int d_r, int ps, int n_rows, int maxp, int max_q,
                        float scale, float* ws_acc, float* ws_ml,
                        int n_splits, cudaStream_t stream) {
#define HETU_LATENT_LAUNCH(KIND)                                             \
  return launch<NT, KIND>(q, c_pages, r_pages, scale_pages, code, out,       \
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

// ---------------------------------------------------------------------------
// The wgmma route: bf16 pages, d_c a multiple of 64 up to 512, d_r 0 or 64
// (wgmma_bf16.cuh)
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;              // a warpgroup
constexpr int kWgBlock = 3 * kWgThreads;     // two consumers, a producer
constexpr int kWgConsumerWarps = 8;
// registers a thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 = 64512
// of the SM's 65536
constexpr int kWgConsumerRegs = 232;
constexpr int kWgProducerRegs = 40;
constexpr int kWgBK = 32;                    // KV positions a tile
constexpr int kWgStages = 3;                 // KV tiles in flight
constexpr int kWgMaxRows = 1024;             // rows a block keeps offsets of
constexpr int kWgSV = kWgBK / 4;             // S values a thread holds
constexpr int kWgMaxSteps = 576 / 32;        // k-steps of S a group forms
constexpr int kWgQBatch = 3;                 // q loads a thread has in flight
static_assert(kBM == 32, "an item is 32 pairs: the 64 rows of a wgmma");
static_assert(2 * kWgStages * 8 % 16 == 0,
              "the S exchange follows the barriers");
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// threadIdx.x / 128, which the compiler sees to be the same across a warp
// (so that setmaxnreg's branches are warp-uniform to it)
__device__ __forceinline__ int latent_wg_index() {
  return __shfl_sync(kFull, threadIdx.x / kWgThreads, 0);
}

// x0, x1 as two bf16 terms each, packed in pairs: hi = bf16(x), lo =
// bf16(x - hi), so that hi + lo keeps about 16 of x's 24 mantissa bits.
// Every fp32 operand of the route (q, and P) goes through here.
__device__ __forceinline__ void bf16_terms(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

// Items are a row's tiles of kBM pairs and, for split rows, each live KV
// slice of a tile: first the unsplit rows' tiles (each row's last, longest
// tile first), then the split rows' slices.  u_off and s_off hold each
// row's first unsplit and split item (n_rows + 1 entries).
struct LatentItem {
  int row, tile, split;  // split -1: the whole KV axis
  LatentRow w;
};

// the row r with off[r] <= idx < off[r + 1]
__device__ __forceinline__ int item_row(const int* off, int n_rows, int idx) {
  int lo = 0, hi = n_rows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= idx)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Item idx's row, tile and slice, and the KV positions [kv_begin, kv_stop)
// it reads (slices are split_len positions, a multiple of kWgBK)
__device__ __forceinline__ LatentItem latent_item(
    int idx, int n_u, const int* u_off, const int* s_off,
    const int* __restrict__ q_lens, const int* __restrict__ cu_q,
    const int* __restrict__ ctx_lens, int n_tokens, int nh, int max_q,
    int n_splits, int n_rows, int cap, int split_len, int& kv_begin,
    int& kv_stop) {
  LatentItem it;
  const bool unsplit = idx < n_u;
  const int* off = unsplit ? u_off : s_off;
  int j = unsplit ? idx : idx - n_u;
  it.row = item_row(off, n_rows, j);
  j -= off[it.row];
  it.w = latent_row(it.row, q_lens, cu_q, ctx_lens, n_tokens, nh, max_q,
                    n_splits);
  if (unsplit) {
    it.tile = (it.w.n_pairs + kBM - 1) / kBM - 1 - j;
    it.split = -1;
    kv_begin = 0;
    kv_stop = latent_kv_end(it.w, it.tile, nh, cap);
  } else {
    int tile = 0;
    for (;; ++tile) {
      const int n = latent_live_slices(latent_kv_end(it.w, tile, nh, cap),
                                       split_len);
      if (j < n) break;
      j -= n;
    }
    it.tile = tile;
    it.split = j;
    kv_begin = j * split_len;
    kv_stop = min(latent_kv_end(it.w, tile, nh, cap), kv_begin + split_len);
  }
  return it;
}

// Kernel 6 on bf16 pages.  A persistent block an SM (grid = the SM count)
// walks the items blockIdx.x, + gridDim.x, ...; an item is 32 (token,
// head) pairs against one KV range.  Warpgroups 0 and 1 consume, each
// holding the 32 pairs' output for half of the d_c columns (NCH chunks of
// 64 at most: 128 registers at d_c 512); warpgroup 2 produces, its
// registers given to the consumers by setmaxnreg (which ptxas honours:
// without it the block of 384 threads is compiled to 168 registers a
// thread and spills at d_c 512).
//  - The A operand stacks the two bf16 terms of q: wgmma row 16 w + gq is
//    q_hi of pair 8 w + gq and row 16 w + gq + 8 its q_lo, so one wgmma
//    forms both terms of S and the thread that holds a pair's q_hi scores
//    holds its q_lo scores too (the accumulator's rows gq and gq + 8).  The
//    consumers write q so into shared memory (swizzled as TMA would), each
//    group the columns of its own k-steps.
//  - S = Q K^T over 32 positions (wgmma, both operands K-major): each group
//    forms every other k-step (2 i + wg; the descriptors of k-step wg
//    moved on by constants) and the two halves are added in fp32 through
//    shared memory (one named barrier a tile; both groups add the same two
//    numbers, so they hold the same S).  The
//    online softmax runs in base 2 on the registers, a pair over the 4
//    lanes of a quad; P is split into bf16 terms stacked as q was (rows gq:
//    P_hi, gq + 8: P_lo) into wgmma's register A operand, and O += P V
//    with V MN-major (the transpose bit) in the group's column chunks; O
//    is rescaled only where a warp's max moved.  The epilogue adds each
//    pair's two rows: O = P_hi V + P_lo V.
//  - What bounds it (H100, PERF.md §6): mostly
//    the scalar chain of a 32-position tile (the S exchange, the softmax,
//    P's terms, the waits); without S, P.V or the TMA loads the chunk row
//    keeps more than half of its time.  A second accumulator chain for S,
//    P.V in flight beside the next S, or a software pipeline over two
//    tiles made it slower (more registers and instructions a tile, or the
//    next tile's loads needed a tile earlier).
//  - The producer's first thread reads the page table and loads each KV
//    tile by TMA (boxes of box_rows positions, which divide the page size,
//    and 64 columns: the latent's d_c / 64 and the rope key's one) into a
//    ring of kWgStages stages with full and empty mbarriers; positions past
//    the range read the row past the pool, which TMA fills with zeros, so
//    no table slot past the context is read.
//  - Masks only on the tiles that reach past the range or the diagonal.
//    Split slices write (max, sum, unnormalized output) to the fp32
//    workspace for latent_merge_kernel; the rest write the output.
template <int NCH>
__global__ void __launch_bounds__(kWgBlock, 1)
latent_ragged_paged_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_c,
    const __grid_constant__ CUtensorMap tm_r, const float* __restrict__ q,
    float* __restrict__ out, const int* __restrict__ q_lens,
    const int* __restrict__ cu_q, const int* __restrict__ page_tables,
    const int* __restrict__ ctx_lens, float* __restrict__ ws_acc,
    float* __restrict__ ws_ml, int n_tokens, int nh, int d_c, int d_r,
    int ps, int box_rows, int oob_row, int n_rows, int maxp, int max_q,
    int n_splits, int split_len, float scale_log2) {
  extern __shared__ __align__(128) uint8_t smem_lat_wg[];
  const int width = d_c + d_r;
  const int halves = width / 64;
  const int q_bytes = halves * 2 * kBM * kSwizzleBytes;   // 64 rows
  const int kv_bytes = halves * kWgBK * kSwizzleBytes;    // a stage
  uint8_t* q_s = align_atom(smem_lat_wg);
  uint8_t* kv_s = q_s + q_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_s + kWgStages * kv_bytes);
  uint64_t* empty = full + kWgStages;
  // [tile parity][group][kWgSV / 4][thread] float4s: each group's share of
  // S (16-byte aligned: the barriers take 48 bytes)
  float* x_s = reinterpret_cast<float*>(empty + kWgStages);
  int* counts = reinterpret_cast<int*>(x_s + 2 * 2 * kWgSV * kWgThreads);
  int* u_off = counts + 2;
  int* s_off = u_off + n_rows + 1;
  const int cap = maxp * ps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumerWarps);
    }
    fence_barrier_init();
  }
  if (threadIdx.x < 32) {
    // each row's items, and their offsets by a scan over the warp
    const int lane = threadIdx.x;
    int u_carry = 0, s_carry = 0;
    if (lane == 0) u_off[0] = s_off[0] = 0;
    for (int base = 0; base < n_rows; base += 32) {
      const int r = base + lane;
      int u = 0, sp = 0;
      if (r < n_rows) {
        const LatentRow w = latent_row(r, q_lens, cu_q, ctx_lens, n_tokens,
                                       nh, max_q, n_splits);
        const int tiles = (w.n_pairs + kBM - 1) / kBM;
        if (w.split) {
          for (int t = 0; t < tiles; ++t)
            sp += latent_live_slices(latent_kv_end(w, t, nh, cap), split_len);
        } else {
          u = tiles;
        }
      }
      for (int o = 1; o < 32; o <<= 1) {
        const int a = __shfl_up_sync(kFull, u, o);
        const int b = __shfl_up_sync(kFull, sp, o);
        if (lane >= o) {
          u += a;
          sp += b;
        }
      }
      if (r < n_rows) {
        u_off[r + 1] = u_carry + u;
        s_off[r + 1] = s_carry + sp;
      }
      u_carry += __shfl_sync(kFull, u, 31);
      s_carry += __shfl_sync(kFull, sp, 31);
    }
    if (lane == 0) {
      counts[0] = u_carry;
      counts[1] = s_carry;
    }
  }
  __syncthreads();
  const int n_u = counts[0];
  const int n_items = n_u + counts[1];
  if (static_cast<int>(blockIdx.x) >= n_items) return;  // an idle block
  const int wg = latent_wg_index();

  if (wg == 2) {
    // producer
    warpgroup_reg_dealloc<kWgProducerRegs>();
    if (threadIdx.x == 2 * kWgThreads) {
      const int c_halves = d_c / 64;
      int g = 0;  // KV tiles so far, over all of the block's items
      for (int idx = blockIdx.x; idx < n_items; idx += gridDim.x) {
        int kv_begin, kv_stop;
        const LatentItem it = latent_item(
            idx, n_u, u_off, s_off, q_lens, cu_q, ctx_lens, n_tokens, nh,
            max_q, n_splits, n_rows, cap, split_len, kv_begin, kv_stop);
        const int* pt = page_tables + static_cast<int64_t>(it.row) * maxp;
        for (int kv0 = kv_begin; kv0 < kv_stop; kv0 += kWgBK, ++g) {
          const int s = g % kWgStages;
          mbar_wait(&empty[s], ((g / kWgStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], kv_bytes);
          uint8_t* st = kv_s + s * kv_bytes;
          for (int r0 = 0; r0 < kWgBK; r0 += box_rows) {
            const int pos = kv0 + r0;
            const int row = pos < kv_stop ? pt[pos / ps] * ps + pos % ps
                                          : oob_row;
            for (int h = 0; h < c_halves; ++h)
              tma_load_2d(st + (h * kWgBK + r0) * kSwizzleBytes, &tm_c,
                          &full[s], 64 * h, row);
            if (d_r > 0)
              tma_load_2d(st + (c_halves * kWgBK + r0) * kSwizzleBytes,
                          &tm_r, &full[s], 0, row);
          }
        }
      }
    }
  } else {
    // consumers
    warpgroup_reg_alloc<kWgConsumerRegs>();
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int gq = lane >> 2;
    const int tq = lane & 3;
    const int pr = 8 * warp + gq;  // the thread's pair of an item
    // the group's k-steps of S: 2 i + wg for i < ks (half the width)
    const int ks = width / 32;
    const int chunks = d_c / 64;       // O's column chunks of 64
    const int ch0 = wg == 0 ? 0 : (chunks + 1) / 2;
    const int nch = wg == 0 ? (chunks + 1) / 2 : chunks / 2;
    // the descriptor of q's k-step wg
    const uint64_t dq = wgmma_desc(smem_addr(q_s), 32 * wg, 16);
    int g = 0;
    for (int idx = blockIdx.x; idx < n_items; idx += gridDim.x) {
      int kv_begin, kv_stop;
      const LatentItem it = latent_item(
          idx, n_u, u_off, s_off, q_lens, cu_q, ctx_lens, n_tokens, nh,
          max_q, n_splits, n_rows, cap, split_len, kv_begin, kv_stop);
      const int pair0 = it.tile * kBM;
      const int n_pairs = it.w.n_pairs;
      // q and out are [T * nh, width] and [T * nh, d_c]: the pairs of a row
      // are consecutive rows of both
      const int64_t pair_base = static_cast<int64_t>(it.w.start) * nh + pair0;

      // q of the group's k-steps in two bf16 terms, 8 columns (a 16-byte
      // chunk) an element, kWgQBatch elements' loads in flight at once;
      // rows past the row's pairs are 0.  The group's earlier products that
      // read q have all been waited for.
      const int n8 = 2 * ks;
      for (int e0 = tid; e0 < kBM * n8; e0 += kWgQBatch * kWgThreads) {
        float4 v[kWgQBatch][2];
#pragma unroll
        for (int u = 0; u < kWgQBatch; ++u) {
          const int e = e0 + u * kWgThreads;
          const int p = e / n8, j = e % n8;
          v[u][0] = v[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (e < kBM * n8 && pair0 + p < n_pairs) {
            const float* src = q + (pair_base + p) * width +
                               16 * (2 * (j / 2) + wg) + 8 * (j % 2);
            v[u][0] = *reinterpret_cast<const float4*>(src);
            v[u][1] = *reinterpret_cast<const float4*>(src + 4);
          }
        }
#pragma unroll
        for (int u = 0; u < kWgQBatch; ++u) {
          const int e = e0 + u * kWgThreads;
          if (e >= kBM * n8) break;
          const int p = e / n8, j = e % n8;
          const int col = 16 * (2 * (j / 2) + wg) + 8 * (j % 2);
          uint4 hi, lo;
          bf16_terms(v[u][0].x, v[u][0].y, hi.x, lo.x);
          bf16_terms(v[u][0].z, v[u][0].w, hi.y, lo.y);
          bf16_terms(v[u][1].x, v[u][1].y, hi.z, lo.z);
          bf16_terms(v[u][1].z, v[u][1].w, hi.w, lo.w);
          const int rh = 16 * (p / 8) + p % 8;  // q_hi's row; q_lo's is + 8
          uint8_t* at = q_s + (col / 64) * 2 * kBM * kSwizzleBytes +
                        ((((col % 64) / 8) ^ (p % 8)) * 16);
          *reinterpret_cast<uint4*>(at + rh * kSwizzleBytes) = hi;
          *reinterpret_cast<uint4*>(at + (rh + 8) * kSwizzleBytes) = lo;
        }
      }
      fence_proxy_async();
      named_bar_sync(2 + wg, kWgThreads);

      const int pair = pair0 + pr;
      const int qp = it.w.qpos0 + pair / nh;  // the thread's query position
      // tiles that reach past this are masked: the range's end, or the
      // diagonal of the item's first query
      const int diag = min(kv_stop, it.w.qpos0 + pair0 / nh + 1);
      float o[NCH][32];
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
      float m = -INFINITY;
      float l = 0.f;  // this lane's share of the pair's sum

      for (int kv0 = kv_begin; kv0 < kv_stop; kv0 += kWgBK, ++g) {
        const int s = g % kWgStages;
        mbar_wait(&full[s], (g / kWgStages) & 1);
        const uint32_t kt = smem_addr(kv_s + s * kv_bytes);
        // S over the group's k-steps 2 i + wg: the descriptors of k-step
        // wg, moved on by constants
        const uint64_t dk = wgmma_desc(kt, 32 * wg, 16);
        float sc[kWgBK / 2];
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < kWgMaxSteps; ++i)
          if (i < ks)
            wgmma_ss<kWgBK, 0, 0>(
                sc,
                desc_plus(dq, (i / 2) * 2 * kBM * kSwizzleBytes +
                                  64 * (i % 2)),
                desc_plus(dk, (i / 2) * kWgBK * kSwizzleBytes + 64 * (i % 2)),
                i > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        // the group's share of the pair's S (its q_hi row plus its q_lo
        // row), the other group's added through shared memory
        float sv[kWgSV];
#pragma unroll
        for (int j = 0; j < kWgBK / 8; ++j) {
          sv[2 * j] = sc[4 * j] + sc[4 * j + 2];
          sv[2 * j + 1] = sc[4 * j + 1] + sc[4 * j + 3];
        }
        float4* xw = reinterpret_cast<float4*>(x_s) +
                     ((g & 1) * 2 + wg) * (kWgSV / 4) * kWgThreads + tid;
        const float4* xr = reinterpret_cast<const float4*>(x_s) +
                           ((g & 1) * 2 + 1 - wg) * (kWgSV / 4) * kWgThreads +
                           tid;
#pragma unroll
        for (int k = 0; k < kWgSV / 4; ++k)
          xw[k * kWgThreads] = make_float4(sv[4 * k], sv[4 * k + 1],
                                           sv[4 * k + 2], sv[4 * k + 3]);
        named_bar_sync(1, 2 * kWgThreads);
#pragma unroll
        for (int k = 0; k < kWgSV / 4; ++k) {
          const float4 x = xr[k * kWgThreads];
          sv[4 * k] += x.x;
          sv[4 * k + 1] += x.y;
          sv[4 * k + 2] += x.z;
          sv[4 * k + 3] += x.w;
        }

        const bool edge = kv0 + kWgBK > diag;
        float mx = m;
#pragma unroll
        for (int k = 0; k < kWgSV; ++k) {
          float v = sv[k] * scale_log2;
          if (edge) {
            const int pos = kv0 + 8 * (k / 2) + 2 * tq + (k & 1);
            if (!(pos < kv_stop && pos <= qp)) v = -INFINITY;
          }
          sv[k] = v;
          mx = fmaxf(mx, v);
        }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        // a pair that has seen no key yet keeps m = -inf, p = 0, alpha = 0
        const float m_use = mx == -INFINITY ? 0.f : mx;
        const float alpha = exp2_ftz(m - m_use);
        m = mx;
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < kWgSV; ++k) {
          sv[k] = exp2_ftz(sv[k] - m_use);
          sum += sv[k];
        }
        l = l * alpha + sum;
        // O is rescaled only where a max moved (alpha 1 leaves it as it is)
        if (__any_sync(kFull, alpha != 1.f)) {
#pragma unroll
          for (int c = 0; c < NCH; ++c)
#pragma unroll
            for (int i = 0; i < 32; ++i) o[c][i] *= alpha;
        }
        // P's terms as the A operand of k-step kk (positions 16 kk ..):
        // rows gq (P_hi) and gq + 8 (P_lo), columns 2 tq and 2 tq + 8
        uint32_t pa[kWgBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) {
          bf16_terms(sv[4 * kk], sv[4 * kk + 1], pa[kk][0], pa[kk][1]);
          bf16_terms(sv[4 * kk + 2], sv[4 * kk + 3], pa[kk][2], pa[kk][3]);
        }
        // V of the group's column chunks, MN-major
        const uint64_t dv = wgmma_desc(kt, ch0 * kWgBK * kSwizzleBytes,
                                       kWgBK * kSwizzleBytes);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NCH; ++c) fence_regs(o[c]);
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk)
#pragma unroll
          for (int c = 0; c < NCH; ++c)
            if (c < nch)
              wgmma_rs<64, 1>(o[c], pa[kk],
                              desc_plus(dv, kk * 16 * kSwizzleBytes +
                                                c * kWgBK * kSwizzleBytes),
                              1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NCH; ++c) fence_regs(o[c]);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(&empty[s]);
      }

      float lsum = l + __shfl_xor_sync(kFull, l, 1);
      lsum += __shfl_xor_sync(kFull, lsum, 2);
      if (pair < n_pairs) {
        float* dst;
        float inv = 1.f;
        if (it.split >= 0) {
          // this slice's state; a pair that saw no key in it keeps max =
          // kMaskValue and weighs nothing in the merge
          const int64_t slot =
              (static_cast<int64_t>(it.row) * kSplitPairs + pair) *
                  n_splits + it.split;
          if (wg == 0 && tq == 0) {
            ws_ml[slot * 2] = m == -INFINITY ? kMaskValue : m * kLn2;
            ws_ml[slot * 2 + 1] = lsum;
          }
          dst = ws_acc + slot * d_c;
        } else {
          // a pair whose softmax sum is 0 gives 0
          inv = lsum == 0.f ? 0.f : 1.f / lsum;
          dst = out + (pair_base + pr) * d_c;
        }
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          if (c >= nch) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = (ch0 + c) * 64 + 8 * j + 2 * tq;
            *reinterpret_cast<float2*>(&dst[col]) =
                make_float2((o[c][4 * j] + o[c][4 * j + 2]) * inv,
                            (o[c][4 * j + 1] + o[c][4 * j + 3]) * inv);
          }
        }
      }
    }
  }
}

// dynamic shared memory of the wgmma route at width d_c + d_r and n_rows
// rows: alignment, q, the KV stages, the barriers, the S exchange, the
// item counts and offsets
int wgmma_smem_bytes(int width, int n_rows) {
  return kSwizzleAtom + (width / 64) * (2 * kBM + kWgStages * kWgBK) *
                            kSwizzleBytes +
         2 * kWgStages * 8 + 2 * 2 * kWgSV * kWgThreads * 4 +
         (2 + 2 * (n_rows + 1)) * 4;
}

template <int NCH>
cudaError_t launch_wgmma(const CUtensorMap& tm_c, const CUtensorMap& tm_r,
                         const float* q, float* out, const int* q_lens,
                         const int* cu_q, const int* page_tables,
                         const int* ctx_lens, float* ws_acc, float* ws_ml,
                         int n_tokens, int nh, int d_c, int d_r, int ps,
                         int box_rows, int oob_row, int n_rows, int maxp,
                         int max_q, int n_splits, int split_len,
                         float scale_log2, int n_blocks,
                         cudaStream_t stream) {
  auto kernel = latent_ragged_paged_attention_wgmma_kernel<NCH>;
  const int smem = wgmma_smem_bytes(d_c + d_r, n_rows);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kWgBlock, smem, stream>>>(
      tm_c, tm_r, q, out, q_lens, cu_q, page_tables, ctx_lens, ws_acc, ws_ml,
      n_tokens, nh, d_c, d_r, ps, box_rows, oob_row, n_rows, maxp, max_q,
      n_splits, split_len, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  latent_merge_kernel<<<dim3(kSplitPairs, n_rows), 128, 0, stream>>>(
      ws_acc, ws_ml, out, q_lens, cu_q, ctx_lens, n_tokens, nh, d_c, max_q,
      n_splits, maxp * ps, split_len);
  return cudaGetLastError();
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
  // n-tiles of O a warp holds: the kParts warps of an m-tile cover 128,
  // 256 or 512 columns
  constexpr int kNT = 16 / kParts;
  if (d_c <= 128)
    err = launch_kind<kNT>(kind, qf, c_pages, r_pages, sp, code, of, ql, cu,
                           ptab, cl, n_tokens, nh, d_c, d_r, ps, n_rows, maxp,
                           max_q, scale, wa, wm, n_splits, st);
  else if (d_c <= 256)
    err = launch_kind<2 * kNT>(kind, qf, c_pages, r_pages, sp, code, of, ql,
                               cu, ptab, cl, n_tokens, nh, d_c, d_r, ps,
                               n_rows, maxp, max_q, scale, wa, wm, n_splits,
                               st);
  else
    err = launch_kind<4 * kNT>(kind, qf, c_pages, r_pages, sp, code, of, ql,
                               cu, ptab, cl, n_tokens, nh, d_c, d_r, ps,
                               n_rows, maxp, max_q, scale, wa, wm, n_splits,
                               st);
  return static_cast<int>(err);
}

// The wgmma route (bf16 pages): same contract as above, with d_c a
// multiple of 64 up to 512, d_r 0 or 64, the page size a multiple of 8,
// n_rows <= 1024, q and the pools 16-byte aligned.  n_pages: the pools'
// pages (c_pages [n_pages, ps, 1, d_c], r_pages [n_pages, ps, 1, d_r]);
// n_blocks: the persistent grid (the SM count).  With n_splits > 1 the
// workspaces are as above and only the live slices are written and merged.
// Tensor maps are encoded here and passed by value, so the call may be
// captured in a CUDA graph; nothing is allocated and nothing synchronises.
int hetu_latent_wgmma_attention(
    const void* q, const void* c_pages, const void* r_pages, void* out,
    const void* q_lens, const void* cu_q, const void* page_tables,
    const void* ctx_lens, void* ws_acc, void* ws_ml, int n_tokens, int nh,
    int d_c, int d_r, int ps, int n_pages, int n_rows, int maxp, int max_q,
    int n_splits, int n_blocks, float scale, void* stream) {
  const int64_t pool_rows = static_cast<int64_t>(n_pages) * ps;
  if (n_splits < 1 || n_splits > 65535 ||
      (n_splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)) || nh < 1 ||
      max_q < 1 || ps < 8 || ps % 8 != 0 || maxp < 1 || n_rows < 1 ||
      n_rows > kWgMaxRows || n_pages < 1 || pool_rows >= (1ll << 31) ||
      n_blocks < 1 || d_c < 64 || d_c % 64 != 0 || d_c > 512 ||
      (d_r != 0 && d_r != 64) || (d_r > 0 && r_pages == nullptr) ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(c_pages) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(r_pages) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // TMA boxes of whole positions of one page: the largest of 32, 16, 8
  // that divides the page size
  const int box_rows = ps % 32 == 0 ? 32 : ps % 16 == 0 ? 16 : 8;
  CUtensorMap tm_c, tm_r;
  cudaError_t err = encode_rows(&tm_c, c_pages, pool_rows, d_c, box_rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d_r > 0) {
    err = encode_rows(&tm_r, r_pages, pool_rows, d_r, box_rows);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    tm_r = tm_c;  // never read
  }
  const int cap = maxp * ps;
  const int split_len =
      ((cap + n_splits - 1) / n_splits + kWgBK - 1) / kWgBK * kWgBK;
  const auto* qf = static_cast<const float*>(q);
  auto* of = static_cast<float*>(out);
  const auto* ql = static_cast<const int*>(q_lens);
  const auto* cu = static_cast<const int*>(cu_q);
  const auto* ptab = static_cast<const int*>(page_tables);
  const auto* cl = static_cast<const int*>(ctx_lens);
  auto* wa = static_cast<float*>(ws_acc);
  auto* wm = static_cast<float*>(ws_ml);
  auto st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * kLog2e;
  const int oob_row = static_cast<int>(pool_rows);
#define HETU_LATENT_WGMMA(NCH)                                               \
  err = launch_wgmma<NCH>(tm_c, tm_r, qf, of, ql, cu, ptab, cl, wa, wm,      \
                          n_tokens, nh, d_c, d_r, ps, box_rows, oob_row,     \
                          n_rows, maxp, max_q, n_splits, split_len,          \
                          scale_log2, n_blocks, st)
  // a group's O chunks of 64 columns: half of d_c / 64, rounded up
  switch ((d_c / 64 + 1) / 2) {
    case 1: HETU_LATENT_WGMMA(1); break;
    case 2: HETU_LATENT_WGMMA(2); break;
    case 3: HETU_LATENT_WGMMA(3); break;
    default: HETU_LATENT_WGMMA(4); break;
  }
#undef HETU_LATENT_WGMMA
  return static_cast<int>(err);
}

// The wgmma route's dynamic shared memory and blocks an SM at these
// widths and rows (0 blocks where the kernel cannot run); returns
// cudaError.
int hetu_latent_wgmma_info(int d_c, int d_r, int n_rows, int* smem_bytes,
                           int* blocks_per_sm) {
  const int smem = wgmma_smem_bytes(d_c + d_r, n_rows);
  *smem_bytes = smem;
  auto kernel = latent_ragged_paged_attention_wgmma_kernel<4>;
  switch ((d_c / 64 + 1) / 2) {
    case 1: kernel = latent_ragged_paged_attention_wgmma_kernel<1>; break;
    case 2: kernel = latent_ragged_paged_attention_wgmma_kernel<2>; break;
    case 3: kernel = latent_ragged_paged_attention_wgmma_kernel<3>; break;
    default: break;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                      kWgBlock, smem);
  return static_cast<int>(err);
}

const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
