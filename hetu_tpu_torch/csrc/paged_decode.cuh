// The split-KV decode core shared by the ragged paged attention kernel
// (kernel 5, its decode rows and, above head dim 256, every token) and the
// paged decode kernel (kernel 7): one query token attends, for the g query
// heads of one KV head, to the first n_pos positions gathered through a
// page table from k/v pages [P, ps, kvh, hd].  Accumulation is fp32 for
// bf16 and fp32 pages alike; any head dim, read in place.
//
// What bounds it on an H100: with GQA a token does 2 g operations per K/V
// element (4 FLOP a byte at g = 4 in bf16), far below what even the CUDA
// cores sustain per byte of HBM, so the core is bound by the bytes in
// flight, not by arithmetic; the tensor cores would not help.
//
// What the design does about it:
//  - A block of 4 warps owns (item, KV head, up to kCoreHeads query heads
//    of its group, a slice of the KV axis): K/V bytes are read once per KV
//    head and slice, not once per query head.  The caller's grid holds
//    enough slices per item to spread a 4096-token context over many SMs;
//    slices past the item's context exit at once.
//  - Page tiles of K and V stream through a ring of kCoreStages stages in
//    shared memory by cp.async (16-byte copies where rows are 16-byte
//    aligned, 4-byte ones where they are 4-byte aligned, element loads
//    otherwise), kCoreStages - 1 tiles in flight while one is consumed.  A
//    tile holds core_tile() positions (32 at head dim 128 in bf16), sized
//    by the head dim so that the ring fits.  Rows are padded (core_ld) so
//    that the rows read together fall on different banks.
//  - The products, bf16 pages at head dims that are multiples of 32 up to
//    256 (the serving path): mma.sync m16n8k16 with fp32 accumulation, the
//    block's 4 query heads padded to the 16 rows of the A operand (the
//    CUDA-core loop below was bound by its instructions, about 3.5 us a
//    tile at two blocks an SM on an H100).  Warp w forms S for 8
//    positions over the whole head dim (K by ldmatrix from the ring), P
//    goes to shared memory as bf16 A fragments, and warp w accumulates O
//    for the column pairs w, w + 4, ... (V by ldmatrix.trans).
//  - Otherwise (fp32 pages, other head dims), CUDA-core FMA.  Scores: a
//    quad of lanes owns a position and reduces along d in 16-byte chunks
//    (chunk c goes to lane c % 4 of the quad); q sits in shared memory in
//    fp32 and is read as broadcast vectors; two shuffles finish each
//    (position, head) dot product, after which lane h of the quad keeps
//    head h's score.  P.V: a thread owns a 16-byte column chunk and every
//    kCoreThreads / chunks'th position of a tile, for all heads of the
//    block, so each V chunk it loads feeds every head; the position groups
//    are summed once per slice through shared memory.  Above 128 chunks
//    (head dims past 1024 in bf16, 512 in fp32) the columns split over
//    col_slices blocks.
//  - Both run the online softmax once a tile for the whole block (maxima
//    through shared memory); each thread keeps its share of the sums.
//  - Each slice writes (max, sum, unnormalized output) to an fp32
//    workspace; the last slice of an item to finish (an atomic ticket,
//    reset by that block) merges them and writes the output: the slices'
//    weights once per head in shared memory, then each output element
//    from its slices' loads, eight in flight.  An item with one live slice
//    writes its output directly.
//  - p is kept in fp32 for the softmax sum and taken in the pages' type
//    for P.V (bf16 pages: rounded to bf16, as the ragged kernel's chunk
//    rows and a TPU's default-precision dot round it).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kCoreThreads = 128;
constexpr int kCoreWarps = kCoreThreads / 32;
constexpr int kCoreHeads = 4;      // query heads of one KV head a block holds
static_assert(kCoreHeads == 4, "P is read as one float4 a position");
constexpr int kCoreStages = 4;     // ring depth
constexpr int kCoreMaxTile = kCoreThreads / 4;  // positions a tile: a quad each
constexpr int kCoreRingBytes = 96 * 1024;  // ring budget: tiles shrink to fit
// KV slices an item may take (ops/kv_split.py CORE_MAX_SPLITS): the merge
// keeps their weights in shared memory
constexpr int kCoreMaxSplits = 64;
constexpr float kCoreMask = -0.7f * FLT_MAX;

// Shapes of one decode-core launch, computed on the host by core_geometry.
struct CoreGeom {
  int hd, ps, kvh, maxp;
  int mma;        // 1: bf16 pages on mma.sync (core_uses_mma), 0: scalar FMA
  int tile;       // KV positions a ring stage
  int ld;         // bytes between two positions' rows in a stage
  int chunks;     // 16-byte chunks of a row (the last may pass hd)
  int cslices;    // column slices of the output (blocks per item and slice)
  int n_splits;   // KV slices of a splittable item
  int split_len;  // KV positions a slice, a multiple of `tile`
  int copy;       // 2: 16-byte cp.async, 1: 4-byte cp.async, 0: elements
  float scale;
};

__host__ __device__ inline int core_chunks(int hd, int item) {
  return (hd * item + 15) / 16;
}

// bf16 pages whose head dim is a multiple of 32 up to kCoreMmaMaxHd (the
// serving path) take the tensor cores: q's 4 heads padded to a 16-row A
// operand, O of kCoreMmaMaxHd / 8 n-tiles in each warp's registers
constexpr int kCoreMmaMaxHd = 128;
__host__ __device__ inline bool core_uses_mma(int hd, int item) {
  return item == 2 && hd % 32 == 0 && hd <= kCoreMmaMaxHd;
}

// The row stride at or above the row's chunks: 64 bytes past a multiple of
// 128 for the scalar loop (the two positions a quarter-warp reads fall on
// different banks), 16 past for mma (ldmatrix's eight rows do).
__host__ __device__ inline int core_ld(int hd, int item, bool mma) {
  const int bytes = core_chunks(hd, item) * 16;
  return mma ? (bytes + 111) / 128 * 128 + 16 : (bytes + 63) / 128 * 128 + 64;
}

// positions a tile: the largest power of two up to kCoreMaxTile whose K and
// V rows in kCoreStages stages fit kCoreRingBytes, at least 1 (always 32
// where mma takes the products: ld is then at most 272)
__host__ __device__ inline int core_tile(int ld) {
  int tile = kCoreMaxTile;
  while (tile > 1 && kCoreStages * 2 * tile * ld > kCoreRingBytes) tile /= 2;
  return tile;
}

inline CoreGeom core_geometry(int hd, int item, int ps, int kvh, int maxp,
                              int n_splits, float scale) {
  CoreGeom g;
  g.hd = hd;
  g.ps = ps;
  g.kvh = kvh;
  g.maxp = maxp;
  g.mma = core_uses_mma(hd, item);
  g.ld = core_ld(hd, item, g.mma);
  g.tile = core_tile(g.ld);
  g.chunks = core_chunks(hd, item);
  g.cslices = (g.chunks + kCoreThreads - 1) / kCoreThreads;
  g.n_splits = n_splits;
  const int cap = maxp * ps;
  const int len = (cap + n_splits - 1) / n_splits;
  g.split_len = (len + g.tile - 1) / g.tile * g.tile;
  g.copy = (hd * item) % 16 == 0 ? 2 : (hd * item) % 4 == 0 ? 1 : 0;
  g.scale = scale;
  return g;
}

// query heads of a group that one block holds, and the blocks a group takes
__host__ __device__ inline int core_head_chunks(int g) {
  return (g + kCoreHeads - 1) / kCoreHeads;
}

// Byte offsets of a core block's dynamic shared memory: the ring at 0 (after
// the loop it holds the outputs to sum and the merge's weights, so it takes
// at least their size), then q (fp32 [heads][chunks * vec], or bf16 [16][hd
// + 8] as mma's A operand), P (fp32 [tile][heads]; mma keeps P in
// registers), the warps' maxima and sums, the merge flag.
struct CoreSmem {
  int q, p, max, sum, flag, bytes;
};

__host__ __device__ inline int core_round16(int x) {
  return (x + 15) / 16 * 16;
}

__host__ __device__ inline CoreSmem core_smem(const CoreGeom& g, int item) {
  const int vec = 16 / item;
  const int ncs = g.chunks < kCoreThreads ? g.chunks : kCoreThreads;
  const int groups = kCoreThreads / ncs;
  int front = kCoreStages * 2 * g.tile * g.ld;
  const int after[3] = {groups * kCoreHeads * ncs * vec * 4,
                        kCoreWarps * kCoreHeads * g.hd * 4,
                        2 * kCoreHeads * kCoreMaxSplits * 4};
  for (int a : after) front = front > a ? front : a;
  CoreSmem s;
  s.q = core_round16(front);
  s.p = s.q + core_round16(g.mma ? 16 * (g.hd + 8) * 2
                                 : kCoreHeads * g.chunks * vec * 4);
  s.max = s.p + (g.mma ? 0 : kCoreMaxTile * kCoreHeads * 4);
  s.sum = s.max + kCoreWarps * kCoreHeads * 4;
  s.flag = s.sum + kCoreWarps * kCoreHeads * 4;
  s.bytes = s.flag + 16;
  return s;
}

inline int core_smem_bytes(const CoreGeom& g, int item) {
  return core_smem(g, item).bytes;
}

__device__ __forceinline__ void core_load(const unsigned char* p, float* f,
                                          const float*) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// a bf16 is the high half of the fp32 with the same value
__device__ __forceinline__ void core_load(const unsigned char* p, float* f,
                                          const __nv_bfloat16*) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// x in the precision of the pages' type
__device__ __forceinline__ float core_round(float x, const float*) {
  return x;
}
__device__ __forceinline__ float core_round(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float core_float(float x) { return x; }
__device__ __forceinline__ float core_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void core_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void core_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// x[i] for a register array indexed by a lane-dependent i (selects, no
// local memory)
__device__ __forceinline__ float core_pick(const float (&x)[kCoreHeads],
                                           int i) {
  float r = x[0];
#pragma unroll
  for (int j = 1; j < kCoreHeads; ++j)
    if (i == j) r = x[j];
  return r;
}

// One block of the core.  q and out point at the row of the block's first
// query head (heads `nq` of them, hd apart); pt at the item's page-table
// row; h is the KV head.  Positions begin .. end - 1 of the item's n_live
// slices (split is this one) are read; cs is the block's column slice.
// With n_live > 1 the slice's state goes to ws_acc / ws_ml rows
// (ws_row + hh) * n_splits + split and `ticket` counts the blocks that
// have finished the item.
template <typename T>
__device__ void decode_core(const CoreGeom& g, const T* __restrict__ q,
                            T* __restrict__ out, const T* __restrict__ kp,
                            const T* __restrict__ vp,
                            const int* __restrict__ pt, int h, int nq,
                            int begin, int end, int split, int n_live, int cs,
                            float* __restrict__ ws_acc,
                            float* __restrict__ ws_ml, int64_t ws_row,
                            int* __restrict__ ticket, unsigned char* smem) {
  constexpr int kItem = static_cast<int>(sizeof(T));
  constexpr int kVec = 16 / kItem;  // elements of a 16-byte chunk
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hd = g.hd;
  const int tile = g.tile;
  const int ld = g.ld;
  const int nc = g.chunks;
  const CoreSmem lay = core_smem(g, kItem);
  float* max_s = reinterpret_cast<float*>(smem + lay.max);  // [warps][heads]
  float* sum_s = reinterpret_cast<float*>(smem + lay.sum);  // [warps][heads]
  int* flag_s = reinterpret_cast<int*>(smem + lay.flag);

  // the ring rows' bytes past hd are read as part of their last chunk and
  // must be 0; no copy writes them
  const int row_bytes = hd * kItem;
  const int tail = nc * 16 - row_bytes;
  if (tail > 0)
    for (int e = tid; e < kCoreStages * 2 * tile * tail; e += kCoreThreads)
      smem[(e / tail) * ld + row_bytes + e % tail] = 0;

  const int64_t row_stride = static_cast<int64_t>(g.kvh) * hd;
  // 16-byte copies: kCoreThreads / tile threads a position, each every such
  // chunk of its row, so a thread looks up one page a tile; the lookup for
  // tile t is loaded a tile ahead of its copies (page_of), off their path
  const int tpp = kCoreThreads / tile;
  const int my_row = tid / tpp;
  auto page_of = [&](int t) {
    const int pos = begin + t * tile + my_row;
    return pos < end ? pt[pos / g.ps] : 0;
  };
  int next_page = g.copy == 2 ? page_of(0) : 0;
  // copies of the tile at positions begin + t * tile .. into stage t % S;
  // `page` is page_of(t) for 16-byte copies
  auto fetch = [&](int t, int page) {
    unsigned char* ks = smem + (t % kCoreStages) * 2 * tile * ld;
    unsigned char* vs = ks + tile * ld;
    const int kv0 = begin + t * tile;
    if (kv0 < end) {
      if (g.copy == 2) {
        const int r = my_row;
        const int pos = kv0 + r;
        const bool live = pos < end;
        const int64_t row =
            live ? (static_cast<int64_t>(page) * g.ps + pos % g.ps) *
                           row_stride + h * hd
                 : 0;
        for (int c = tid % tpp; c < nc; c += tpp) {
          cp_async16(ks + r * ld + c * 16, kp + row + (live ? c * kVec : 0),
                     live);
          cp_async16(vs + r * ld + c * 16, vp + row + (live ? c * kVec : 0),
                     live);
        }
      } else if (g.copy == 1) {
        const int nw = row_bytes / 4;
        for (int e = tid; e < tile * nw; e += kCoreThreads) {
          const int r = e / nw;
          const int w = e % nw;
          const int pos = kv0 + r;
          const bool live = pos < end;
          const int64_t off =
              live ? (static_cast<int64_t>(pt[pos / g.ps]) * g.ps +
                      pos % g.ps) * row_stride + h * hd
                   : 0;
          cp_async4(ks + r * ld + w * 4,
                    reinterpret_cast<const unsigned char*>(kp + off) + w * 4,
                    live);
          cp_async4(vs + r * ld + w * 4,
                    reinterpret_cast<const unsigned char*>(vp + off) + w * 4,
                    live);
        }
      } else {
        for (int e = tid; e < tile * hd; e += kCoreThreads) {
          const int r = e / hd;
          const int d = e % hd;
          const int pos = kv0 + r;
          T kv = T(0.f), vv = T(0.f);
          if (pos < end) {
            const int64_t off = (static_cast<int64_t>(pt[pos / g.ps]) * g.ps +
                                 pos % g.ps) * row_stride + h * hd + d;
            kv = kp[off];
            vv = vp[off];
          }
          reinterpret_cast<T*>(ks + r * ld)[d] = kv;
          reinterpret_cast<T*>(vs + r * ld)[d] = vv;
        }
      }
    }
  };

  // tile t + kCoreStages - 1's copies, in iteration t (t < 0: the first
  // tiles', before the loop)
  auto fetch_ahead = [&](int t) {
    const int page = next_page;
    if (g.copy == 2) next_page = page_of(t + kCoreStages);
    fetch(t + kCoreStages - 1, page);
    cp_async_commit();
  };

  // the running maxima of the block's heads, the same in every thread
  // after the loop
  float m[kCoreHeads];
#pragma unroll
  for (int hh = 0; hh < kCoreHeads; ++hh) m[hh] = kCoreMask;
  // the heads' maxima over the warps' in max_s
  auto block_max = [&](int hh) {
    float tm = max_s[hh];
#pragma unroll
    for (int w = 1; w < kCoreWarps; ++w)
      tm = fmaxf(tm, max_s[w * kCoreHeads + hh]);
    return tm;
  };
  const int n_tiles = (end - begin + tile - 1) / tile;
  // the outputs to sum after the loop: [groups][heads][width] fp32 at 0
  int groups = 1, width = hd;

  bool on_mma = false;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) on_mma = g.mma;
  for (int t = 1 - kCoreStages; t < 0; ++t) fetch_ahead(t);
  if (on_mma) {
    // q of the block's heads as mma's A operand, bf16 [16][hd + 8] (rows
    // past nq 0)
    const int lda = hd + 8;
    __nv_bfloat16* qa = reinterpret_cast<__nv_bfloat16*>(smem + lay.q);
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < 16 * lda; e += kCoreThreads) {
      const int r = e / lda;
      const int d = e % lda;
      qa[e] = r < nq && d < hd
                  ? reinterpret_cast<const __nv_bfloat16*>(q)[r * hd + d]
                  : zero;
    }
    // Warp w owns positions 8w .. 8w + 7 of every tile with its own online
    // softmax (no barrier but the ring's); lane (gq, tq) holds rows gq and
    // gq + 8 of S and O (heads gq < 4; rows 4 .. 15 are padding).  S over
    // the head dim from K by ldmatrix; P, rounded to bf16 as the ragged
    // kernel's chunk rows round it, is the A operand of an m16n8k8 P.V
    // straight from S's registers, V by ldmatrix.trans, four n-tiles a
    // load.  The sum keeps p in fp32.
    constexpr int kNT = kCoreMmaMaxHd / 8;  // n-tiles of O a warp holds
    const int gq = lane >> 2;
    const int tq = lane & 3;
    const int ldk = ld / 2;
    const int n_nt = hd / 8;
    const bool head = gq < kCoreHeads;
    float o[kNT][4] = {};
    float mw = kCoreMask;  // the warp's running max of row gq
    float lw = 0.f;        // this lane's share of the warp's sum of row gq
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kCoreStages - 2>();
      __syncthreads();  // tile t has landed; tile t - 1's stage is consumed
      fetch_ahead(t);
      const __nv_bfloat16* kr = reinterpret_cast<const __nv_bfloat16*>(
          smem + (t % kCoreStages) * 2 * tile * ld) + 8 * warp * ldk;
      const __nv_bfloat16* vr = kr + tile * ldk;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < hd; k0 += 32) {
        uint32_t a0[4], a1[4], b[4];
        load_a(a0, qa, lda, 0, k0, lane);
        load_a(a1, qa, lda, 0, k0 + 16, lane);
        // the warp's 8 K rows at k0 .. k0 + 31: two k-steps' B fragments
        ldmatrix_x4(b, kr + (lane & 7) * ldk + k0 + (lane >> 3) * 8);
        mma_bf16_16816(c, a0, b[0], b[1]);
        mma_bf16_16816(c, a1, b[2], b[3]);
      }
      const int pos0 = begin + t * tile + 8 * warp + 2 * tq;
      const bool v0 = gq < nq && pos0 < end;
      const bool v1 = gq < nq && pos0 + 1 < end;
      const float s0 = v0 ? c[0] * g.scale : kCoreMask;
      const float s1 = v1 ? c[1] * g.scale : kCoreMask;
      float mx = fmaxf(s0, s1);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(mw, mx);
      const float alpha = expf(mw - m_new);
      mw = m_new;
      const float p0 = v0 ? expf(s0 - m_new) : 0.f;
      const float p1 = v1 ? expf(s1 - m_new) : 0.f;
      lw = lw * alpha + p0 + p1;
      const uint32_t pa = pack_bf16(p0, p1);
#pragma unroll
      for (int n4 = 0; n4 < kNT / 4; ++n4) {
        if (4 * n4 >= n_nt) break;
        uint32_t b[4];
        ldmatrix_x4_trans(b, vr + (lane & 7) * ldk + 32 * n4 +
                                 (lane >> 3) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[4 * n4 + j][0] *= alpha;
          o[4 * n4 + j][1] *= alpha;
          mma_bf16_1688(o[4 * n4 + j], pa, 0u, b[j]);
        }
      }
    }
    cp_async_wait<0>();
    // the block's state: each warp's scaled by exp(its max - the block's)
    lw += __shfl_xor_sync(0xffffffffu, lw, 1);
    lw += __shfl_xor_sync(0xffffffffu, lw, 2);
    if (tq == 0 && head) max_s[warp * kCoreHeads + gq] = mw;
    __syncthreads();  // the maxima are in; the ring is free
#pragma unroll
    for (int hh = 0; hh < kCoreHeads; ++hh) m[hh] = block_max(hh);
    groups = kCoreWarps;
    float* red = reinterpret_cast<float*>(smem);  // [warps][heads][hd]
    if (head) {
      const float f = expf(mw - core_pick(m, gq));
      if (tq == 0) sum_s[warp * kCoreHeads + gq] = lw * f;
      float* dst = red + (warp * kCoreHeads + gq) * hd + 2 * tq;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        if (nt < n_nt) {
          dst[8 * nt] = o[nt][0] * f;
          dst[8 * nt + 1] = o[nt][1] * f;
        }
    }
  } else {
    // q of the block's heads in fp32, zero past hd and for heads past nq
    const int ldq = nc * kVec;
    float* q_s = reinterpret_cast<float*>(smem + lay.q);  // [heads][ldq]
    float* p_s = reinterpret_cast<float*>(smem + lay.p);  // [tile][heads]
    for (int e = tid; e < kCoreHeads * ldq; e += kCoreThreads) {
      const int hh = e / ldq;
      const int d = e % ldq;
      q_s[e] = hh < nq && d < hd ? core_float(q[hh * hd + d]) : 0.f;
    }
    // scores: quad `quad` owns a position of the tile, lane qh of it the
    // chunks qh, qh + 4, ... and, after the reduction, head qh's score.
    // P.V: thread (pg, cl) owns chunk cs * kCoreThreads + cl and every
    // groups'th position of a tile, starting at pg
    const int quad = tid >> 2;
    const int qh = tid & 3;
    const int ncs = nc < kCoreThreads ? nc : kCoreThreads;
    groups = kCoreThreads / ncs;
    width = ncs * kVec;
    const int cl = tid % ncs;
    const int pg = tid / ncs;
    const int chunk = cs * kCoreThreads + cl;
    const bool pv_live = pg < groups && chunk < nc;
    float acc[kCoreHeads][kVec];
#pragma unroll
    for (int hh = 0; hh < kCoreHeads; ++hh)
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[hh][i] = 0.f;
    float l_part = 0.f;  // this thread's share of head qh's softmax sum

    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kCoreStages - 2>();
      __syncthreads();  // tile t has landed; tile t - 1 (stage, P) consumed
      fetch_ahead(t);
      const unsigned char* ks = smem + (t % kCoreStages) * 2 * tile * ld;
      const unsigned char* vs = ks + tile * ld;
      const int kv0 = begin + t * tile;

      float s[kCoreHeads] = {};
      if (quad < tile) {
        const unsigned char* krow = ks + quad * ld;
        for (int c = qh; c < nc; c += 4) {
          float kf[kVec];
          core_load(krow + c * 16, kf, static_cast<const T*>(nullptr));
#pragma unroll
          for (int hh = 0; hh < kCoreHeads; ++hh) {
            const float* qc = q_s + hh * ldq + c * kVec;
#pragma unroll
            for (int i = 0; i < kVec; i += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qc + i);
              s[hh] = fmaf(qv.x, kf[i], s[hh]);
              s[hh] = fmaf(qv.y, kf[i + 1], s[hh]);
              s[hh] = fmaf(qv.z, kf[i + 2], s[hh]);
              s[hh] = fmaf(qv.w, kf[i + 3], s[hh]);
            }
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < kCoreHeads; ++hh) {
        s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 1);
        s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 2);
      }
      const bool valid = quad < tile && kv0 + quad < end && qh < nq;
      const float sc = valid ? core_pick(s, qh) * g.scale : kCoreMask;
      float mx = sc;
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      if (lane < kCoreHeads) max_s[warp * kCoreHeads + lane] = mx;
      __syncthreads();

      float alpha[kCoreHeads];
#pragma unroll
      for (int hh = 0; hh < kCoreHeads; ++hh) {
        const float m_new = fmaxf(m[hh], block_max(hh));
        alpha[hh] = expf(m[hh] - m_new);
        m[hh] = m_new;
      }
      const float p = valid ? expf(sc - core_pick(m, qh)) : 0.f;
      l_part = l_part * core_pick(alpha, qh) + p;
      // P.V takes p in the pages' type (bf16 pages: rounded, as the chunk
      // rows' tensor-core products take it); the sum keeps it in fp32
      if (quad < tile) p_s[quad * kCoreHeads + qh] = core_round(p, kp);
      __syncthreads();

#pragma unroll
      for (int hh = 0; hh < kCoreHeads; ++hh)
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[hh][i] *= alpha[hh];
      if (pv_live) {
        // positions past the slice have p = 0 and zero-filled V
        for (int r = pg; r < tile; r += groups) {
          float vf[kVec];
          core_load(vs + r * ld + chunk * 16, vf,
                    static_cast<const T*>(nullptr));
          const float4 p4 = *reinterpret_cast<const float4*>(p_s + r * 4);
          const float pr[kCoreHeads] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int hh = 0; hh < kCoreHeads; ++hh)
#pragma unroll
            for (int i = 0; i < kVec; ++i)
              acc[hh][i] = fmaf(pr[hh], vf[i], acc[hh][i]);
        }
      }
    }
    cp_async_wait<0>();

    // the block's softmax sums, and its position groups' outputs
    l_part += __shfl_xor_sync(0xffffffffu, l_part, 4);
    l_part += __shfl_xor_sync(0xffffffffu, l_part, 8);
    l_part += __shfl_xor_sync(0xffffffffu, l_part, 16);
    if (lane < kCoreHeads) sum_s[warp * kCoreHeads + lane] = l_part;
    __syncthreads();  // the ring is free
    float* red = reinterpret_cast<float*>(smem);  // [groups][heads][width]
    if (pv_live)
#pragma unroll
      for (int hh = 0; hh < kCoreHeads; ++hh)
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          red[(pg * kCoreHeads + hh) * width + cl * kVec + i] = acc[hh][i];
  }
  __syncthreads();

  const float* red = reinterpret_cast<const float*>(smem);
  const int col0 = cs * kCoreThreads * kVec;
  for (int e = tid; e < nq * width; e += kCoreThreads) {
    const int hh = e / width;
    const int col = col0 + e % width;
    if (col >= hd) continue;
    float a = 0.f, l = 0.f;
    for (int gi = 0; gi < groups; ++gi)
      a += red[(gi * kCoreHeads + hh) * width + e % width];
#pragma unroll
    for (int w = 0; w < kCoreWarps; ++w) l += sum_s[w * kCoreHeads + hh];
    if (n_live == 1) {
      core_store(out + hh * hd + col, a / (l == 0.f ? 1.f : l));
    } else {
      const int64_t slot = (ws_row + hh) * g.n_splits + split;
      ws_acc[slot * hd + col] = a;
      if (col == 0) {
        ws_ml[slot * 2] = m[hh];
        ws_ml[slot * 2 + 1] = l;
      }
    }
  }
  if (n_live == 1) return;

  // the last block of the item to finish merges its slices: each head's
  // slice weights exp(m_s - max) / sum once, in shared memory (the ring
  // is free), then every output element from n_live loads in flight
  __threadfence();
  __syncthreads();
  if (tid == 0)
    flag_s[0] = atomicAdd(ticket, 1) == n_live * g.cslices - 1;
  __syncthreads();
  if (!flag_s[0]) return;
  __threadfence();
  float* w_s = reinterpret_cast<float*>(smem);  // [nq][n_live][2]
  for (int e = tid; e < nq * n_live; e += kCoreThreads) {
    const int64_t slot = (ws_row + e / n_live) * g.n_splits + e % n_live;
    w_s[2 * e] = __ldcg(ws_ml + slot * 2);
    w_s[2 * e + 1] = __ldcg(ws_ml + slot * 2 + 1);
  }
  __syncthreads();
  if (tid < nq) {
    float* w = w_s + 2 * tid * n_live;
    float mm = kCoreMask, l = 0.f;
    for (int sl = 0; sl < n_live; ++sl) mm = fmaxf(mm, w[2 * sl]);
    for (int sl = 0; sl < n_live; ++sl) {
      w[2 * sl] = expf(w[2 * sl] - mm);
      l = fmaf(w[2 * sl + 1], w[2 * sl], l);
    }
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    for (int sl = 0; sl < n_live; ++sl) w[2 * sl] *= inv;
  }
  __syncthreads();
  for (int e = tid; e < nq * hd; e += kCoreThreads) {
    const int hh = e / hd;
    const int col = e % hd;
    const float* w = w_s + 2 * hh * n_live;
    const float* src = ws_acc + (ws_row + hh) * g.n_splits * hd + col;
    float a = 0.f;
#pragma unroll 8
    for (int sl = 0; sl < n_live; ++sl)
      a = fmaf(__ldcg(src + static_cast<int64_t>(sl) * hd), w[2 * sl], a);
    core_store(out + hh * hd + col, a);
  }
  if (tid == 0) *ticket = 0;
}

}  // namespace
