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
// about 21 of fp32's 24 mantissa bits (split TF32 terms, below) against
// exactly dequantized values, accumulated in fp32.  Masked scores take
// -0.7 * FLT_MAX, a row whose softmax sum is 0 gives 0, and tokens that
// belong to no row are left as the caller zeroed them.
//
// What bounds it on an H100: all nh heads share the one KV stream, so the
// (token, head) pairs of a row form the M axis of both products and each
// cached token does 2 * nh * (2 d_c + d_r) operations for every query that
// sees it.  At nh 32, d_c 512, d_r 64 a decode row does ~60 operations per
// bf16 KV byte and a 512-token chunk ~30,000: with fp32 q against the
// pages' values on the TF32 tensor cores (495 TFLOP/s, two or three TF32
// terms a product, against 3.35 TB/s) both are bound by operations.
//
// What the design does about it:
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
//    bf16 pages, the serving path, stay bf16 in shared memory: cp.async
//    copies the next tile into a second buffer while the current one is
//    multiplied, and ldmatrix (.trans for V) hands each lane a bf16 pair
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
//  - Not yet: wgmma and TMA; cp.async for the fp32 and quantized pages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "mma_tf32.cuh"

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
      ws_acc, ws_ml, out, q_lens, cu_q, n_tokens, nh, d_c, max_q, n_splits);
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

const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
