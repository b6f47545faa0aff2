// Flash attention forward and backward for Hopper (sm_90a), CUDA C++ with
// plain C entries.
//
// Replaces the four Pallas TPU kernels of
// hetu_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_wgmma_kernel / flash_fwd_mma_kernel  <- :178 `_fwd_kernel`
//       (`_flash_fwd`)
//   flash_bwd_dkv_wgmma_kernel<HD, true> / flash_bwd_dkv_mma_kernel<HD,
//       true> / flash_bwd_dkv_tf32_kernel<..., true>
//                                             <- :325 `_bwd_fused_kernel`
//       (`_flash_bwd_fused`)
//   flash_bwd_dq_wgmma_kernel / flash_bwd_dq_mma_kernel
//                                             <- :466 `_bwd_dq_kernel`
//       (`_flash_bwd_split`)
//   flash_bwd_dkv_wgmma_kernel<HD, false> / flash_bwd_dkv_mma_kernel<HD,
//       false> / flash_bwd_dkv_tf32_kernel<..., false>
//                                             <- :510 `_bwd_dkv_kernel`
//       (`_flash_bwd_split`)
// Same functions: q [b, sq, h, d], k/v [b, sk, h, d] (equal head counts),
// scores q.k * scale taken as base-2 logits (scale * log2(e) folded into
// q), causal with a diagonal offset (key j is visible to query i iff
// j <= i + offset), optional segment ids per token (q_ids [b, sq], kv_ids
// [b, sk]: equal ids see each other).  The forward returns out in q's
// type and lse [b, h, sq] (fp32, natural log); a row that sees no key
// gives out = 0 and lse = -inf, and in the backward p = 0 wherever the key
// is masked or the row's lse is -inf, so such rows get zero gradients.
// Rounding follows the TPU kernels: q * scale * log2(e) is rounded to q's
// type (:274, :405, :564), p to v's type before p.v (:249), to do's type
// before p^T.do (:377), and ds to q's type before ds.k and ds^T.q (:383,
// :502); every product accumulates in fp32.  Types: q/k/do/out share one
// type and v may differ: (fp32, fp32, fp32), (bf16, bf16, bf16) and (fp32,
// fp32, bf16), the last being what the bf16 LLaMA model feeds (its rotary
// tables are fp32).  Head dims 32, 64, 128, 256 on the tensor cores
// (ops/flash_attention.py pads any other head dim up to 256 with zero
// columns to the next of them), and multiples of 128 above 256 on the wide
// route at the end of this file (the wrappers pad wider head dims to one).
//
// What bounds them on an H100 (989 TFLOP/s bf16 tensor cores, 495 TF32,
// so 165 for an fp32 product in 3xTF32; 3.35 TB/s): causal attention does
// 4*b*h*sq*sk*d/2 FLOPs forward -- at the Llama-3-8B training shape (b 2,
// s 4096, h 32, d 128) 275 GFLOP, 0.28 ms on the bf16 tensor cores, 1.67
// ms in 3xTF32 -- and 2.5 times that backward, against q/k/v/o/do/lse/dq/
// dk/dv traffic of about 0.4 GB (0.13 ms).  So they are bound by
// operations.
//
// What the design does about it:
//  - Routes.  bf16 q/k/v at head dims 64 and 128: the forward, dq and
//    the dk/dv template (split and fused) on Hopper's wgmma, fed by TMA
//    through an mbarrier ring by a producer warpgroup (the "wgmma
//    kernels" section; wgmma_bf16.cuh); the other widths on bf16
//    mma.sync; fp32 q/k on 3xTF32 mma.sync; above 256 the wide route.
//  - The wgmma kernels.  A block is three warpgroups: two consumers and a
//    producer, whose registers go to the consumers by setmaxnreg (224 and
//    56 a thread).  Tiles are 64-column halves of 128-byte rows in the
//    128-byte swizzle TMA writes, read in place by TMA from [b, s, h, d]
//    through a 4-D tensor map (rows past s come back as zeros), and read
//    by wgmma from shared memory through descriptors, K-major or (V, dO,
//    Q and K as the second operand of P.V, P^T.dO, dS^T.Q, dS.K) MN-major
//    with the transpose bit.  The forward: 128 q rows a block (64 a
//    consumer), K/V tiles of 128 keys in a ring of 2 (d 128) or 3 (d 64)
//    stages; S = Q K^T, the online softmax in registers, P as the register
//    A operand of O += P V.  dq in the forward's shape: 128 q rows a
//    block, Q and dO loaded once, K/V tiles of 128 keys in the ring, taken
//    in chunks of 64 keys; S = Q K^T and dP = dO V^T on wgmma, dS as the
//    register A operand of dQ += dS K.  The dk/dv template: 128 keys a
//    block (64 a consumer, dK and dV in registers), q tiles of 64 rows
//    (Q, dO, O for the fused kernel) in a ring of 2 stages; the producer's
//    other three warps scale Q and, fused, compute delta = rowsum(dO * O)
//    in fp64 from the tiles before the consumers see them; S^T and dP^T
//    on wgmma, P^T and dS^T as register A operands of dV += P^T dO and dK
//    += dS^T Q; fused, dS^T goes to shared memory (swizzled, two buffers)
//    for dQ_part = dS K over the block's 128 keys, half the head columns
//    a consumer, added into dq_acc with 8-byte atomics.  Where a q row
//    sees one key, dP - delta cancels to the rounding of two sums, which
//    dq carries: the fused kernel's dP^T and dq's dP add the k-steps'
//    products in fp32 (wgmma_ss_sum), as a chain of wgmma keeps fewer
//    bits.
//  - The mma.sync kernels: one block owns one (batch, head) and one tile
//    of 64 rows, and loops over the other axis itself: the forward and dq
//    over KV tiles (their TPU grids carried that loop in VMEM scratch),
//    dk/dv and the fused kernel over q tiles, 4 warps of 16 rows each.
//  - Both: tiles wholly above the causal diagonal are never loaded, as
//    the TPU kernels skip them (`run`, :237): the forward and dq stop the
//    KV loop at the tile's last visible key, dk/dv start the q loop at
//    the first q row that sees the KV tile; blocks with the longest loops
//    start first.  Any sq and sk: the ragged edge is masked.  Masks are
//    applied only to tiles that cross the diagonal or an edge, or with
//    segments.  out/dq/dk/dv are written in [b, s, h, d].
//  - Fused backward: the TPU kept dk/dv for the whole sequence in VMEM per
//    (batch, head); here a block owns one KV tile's dk/dv in registers,
//    loops over the q tiles, computes delta = rowsum(do * o) itself and
//    adds its share of dq into an fp32 workspace with atomics (summed in
//    an order that changes from run to run).  The split kernels are
//    deterministic and take delta from one torch op outside.
//  - mma.sync details.  bf16 operands: m16n8k16 with fp32 accumulation
//    (mma_bf16.cuh).  fp32 operands: 3xTF32 (mma_tf32.cuh), each product
//    as three m16n8k8 TF32 products of the operands' high and low parts,
//    which keeps about 21 of fp32's 24 mantissa bits (errors near 1e-6 of
//    the values, against fp32 gates of 1e-4 forward and 1e-3 backward);
//    the mixed forward's P.V rounds p to v's bf16 as the reference does
//    and runs on bf16 m16n8k16, and the mixed dq's dO.V^T and dk/dv's
//    V.dO^T take two TF32 terms (bf16 v is exact in TF32).  Tiles sit in
//    shared memory in their own type (v in fp32 in the 3xTF32 dk/dv
//    template) with rows padded by 16 bytes, so that ldmatrix (.trans for
//    bf16 B operands stored [k][n]) and the 32-bit loads of fp32 B operands
//    stored [k][n] hit distinct banks; the next K/V (forward, dq) or
//    Q/dO/lse/delta (dk/dv) tile is copied by cp.async into a second
//    buffer while the current one is multiplied, rows past sq/sk
//    zero-filled.  S, dP and the accumulators stay in registers, and P and
//    dS feed the next product straight from the S registers.  The bf16
//    forward keeps Q's fragments in registers; the others read Q and dO
//    from shared memory for each tile.  dq (d 128) and the bf16 dk/dv (d
//    256) work through a tile in column chunks of 32 so that S and dP fit
//    beside the accumulators without spills; the fused kernels stage dS in
//    shared memory for dQ = dS.K and add dQ with 8-byte vector atomics;
//    dP is summed from products over k = 8 added in fp32.  3xTF32 sums
//    chain at most a tile (S) or two k-steps (P.V, dS.K, P^T.dO, dS^T.Q;
//    dP: one) in the tensor cores' accumulator and are added in fp32
//    (mma_tf32.cuh).  fp32 tiles are twice the bytes of bf16 ones: at d
//    128 the fp32/mixed forward takes 32-key KV tiles, the dq one 32-key
//    buffer (fwd_kv_tile, dq_kv_tile) and the dk/dv template 16-row q
//    tiles (dkv_tf32_rows), so that two blocks fit an SM.
//  - What bounds the wgmma kernels now (H100, PERF.md): the forward runs
//    at about half its bound at the Llama shape; the backward kernels
//    (dq and the dk/dv template) wait on their own wgmma groups (each
//    consumer's products of a tile depend on one another, and two
//    consumers hide little of it), the fused one also on its dQ atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <type_traits>
#include <utility>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kB = 64;           // rows of a q tile and of a KV tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the number of `tile`-key tiles that q rows [q0, q0 + rows) can see
__device__ __forceinline__ int kv_tiles_for(int q0, int sq, int sk, int causal,
                                            int offset, int tile = kB,
                                            int rows = kB) {
  int kv_end = sk;
  if (causal) kv_end = min(sk, min(q0 + rows, sq) - 1 + offset + 1);
  return kv_end > 0 ? (kv_end + tile - 1) / tile : 0;
}

// the first `rows`-row q tile that can see keys [k0, k0 + 64)
__device__ __forceinline__ int first_q_tile(int k0, int causal, int offset,
                                            int rows = kB) {
  return causal ? max(0, k0 - offset) / rows : 0;
}

// ---------------------------------------------------------------------------
// tensor-core kernels: kernels 1 and 3 in every type, the dk/dv template
// (kernels 2, 4) on bf16 and in 3xTF32
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // 4 warps, 16 rows of a 64-row tile each
// k-steps of 8 that a 3xTF32 sum of P V or dS K chains in the tensor cores'
// accumulator before it is added to O or dQ in fp32 (mma_tf32.cuh): longer
// chains lose bits, a zeroed accumulator for every k-step costs registers
constexpr int kTf32Chain = 2;

// dst[0] += a, dst[1] += b in device memory: one 8-byte vector atomic
// where the toolkit has it (sm_90, CUDA 12.1 on), else two
__device__ __forceinline__ void add2(float* dst, float a, float b) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a, b));
#else
  atomicAdd(dst, a);
  atomicAdd(dst + 1, b);
#endif
}

// Tiles in shared memory: 64 rows of HD values of type T with 16 bytes of
// pad a row (HD + 8 bf16, HD + 4 fp32), so that ldmatrix, the 16-byte
// copies and the 32-bit loads of load_b_f32_trans hit distinct banks.
template <int HD, typename T>
__host__ __device__ constexpr int tile_ld() {
  return HD + 16 / static_cast<int>(sizeof(T));
}

template <int HD, typename T>
__host__ __device__ constexpr int tile_bytes() {
  return kB * tile_ld<HD, T>() * static_cast<int>(sizeof(T));
}

template <int HD>
__host__ __device__ constexpr int mma_tile_elems() {
  return kB * tile_ld<HD, bf16>();
}

// Issues cp.async copies of rows row0 .. row0+kRows-1 of one head of a
// [b, s, h, HD] tensor (src at (batch, token 0, head, 0)) into dst
// [kRows][tile_ld]; rows at or past n_rows are zero-filled.  Thread t
// copies the 16-byte chunks t, t + 128, ... (scale_own_chunks walks the
// same ones of a 64-row tile).
template <int HD, int kRows = kB, typename T>
__device__ __forceinline__ void copy_tile_async(T* dst, const T* src,
                                                int row0, int n_rows,
                                                int64_t tok_stride) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = HD / kPer;
  for (int e = threadIdx.x; e < kRows * kChunks; e += kMmaThreads) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * kPer;
    const bool live = row0 + r < n_rows;
    cp_async16(dst + r * tile_ld<HD, T>() + c,
               src + (live ? static_cast<int64_t>(row0 + r) * tok_stride + c
                           : 0),
               live);
  }
}

// x * mul rounded to T, in place, for the chunks this thread copied with
// copy_tile_async<HD, kRows> (visible to it after its cp_async_wait).
template <int HD, int kRows = kB, typename T>
__device__ __forceinline__ void scale_own_chunks(T* tile, float mul) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = HD / kPer;
  for (int e = threadIdx.x; e < kRows * kChunks; e += kMmaThreads) {
    T* chunk = tile + (e / kChunks) * tile_ld<HD, T>() + (e % kChunks) * kPer;
    if constexpr (std::is_same<T, float>::value) {
      float4 f = *reinterpret_cast<float4*>(chunk);
      f.x *= mul;
      f.y *= mul;
      f.z *= mul;
      f.w *= mul;
      *reinterpret_cast<float4*>(chunk) = f;
    } else {
      uint4* p = reinterpret_cast<uint4*>(chunk);
      uint4 u = *p;
      uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        w[i] = pack_bf16(f.x * mul, f.y * mul);
      }
      *p = u;
    }
  }
}

// 4-byte values src[(row0 + i) * stride], i < kRows, into dst[i] by
// cp.async; zero at or past n_rows.  Threads 0 .. kRows-1 issue them.
template <int kRows = kB, typename T>
__device__ __forceinline__ void copy_row_values_async(T* dst, const T* src,
                                                      int row0, int n_rows,
                                                      int stride) {
  if (threadIdx.x < kRows) {
    const int i = row0 + threadIdx.x;
    const bool live = i < n_rows;
    cp_async4(dst + threadIdx.x,
              src + (live ? static_cast<int64_t>(i) * stride : 0), live);
  }
}

// Two values of an output row: one 4-byte bf16 pair or one 8-byte fp32 pair.
__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// Keys a KV tile of the forward: 64, but 32 for fp32 q/k at d 128, whose
// 64-key tiles would leave room for one block an SM (169 KB of shared
// memory; 102 KB with 32 keys, two blocks an SM, which the card runs
// faster; at d 64 and below two blocks fit either way and 64 keys run
// faster); at d 256 32 for bf16 q/k (85 KB, two blocks an SM) and 16 for
// fp32 q/k, whose S and P parts at 32 keys spill beside O (117 KB).
template <int HD, typename TQ>
__host__ __device__ constexpr int fwd_kv_tile() {
  if (HD > 128) return std::is_same<TQ, bf16>::value ? 32 : 16;
  return std::is_same<TQ, bf16>::value || HD <= 64 ? kB : 32;
}

template <int HD, typename TQ, typename TV>
constexpr int fwd_mma_smem_bytes() {
  // Q (64 rows); K x 2 in q's type and V x 2 in v's type (fwd_kv_tile
  // rows; V only the block's out_cols columns); kv ids x 2
  constexpr int kBK = fwd_kv_tile<HD, TQ>();
  return tile_bytes<HD, TQ>() +
         2 * kBK * (tile_ld<HD, TQ>() * static_cast<int>(sizeof(TQ)) +
                    tile_ld<out_cols<HD>(), TV>() *
                        static_cast<int>(sizeof(TV))) +
         2 * kBK * 4;
}

// Kernel 1.  One block per (batch * head, 64-row q tile), longest rows
// first; warp w owns q rows 16w .. 16w+15.  Per KV tile (fwd_kv_tile
// keys), with the next K/V tile in flight by cp.async into the other
// buffer: S = Q K^T on the tensor cores, the mask only where the tile
// crosses the diagonal or an edge or segments are given, the online
// softmax in base 2 on the accumulator registers (row max and sum over
// the 4 lanes of a row group), and O += P V with P straight from the S
// registers.
// bf16 q/k/v (head dims 32 and 256; 64 and 128 take
// flash_fwd_wgmma_kernel): m16n8k16; q * scale * log2(e) is rounded to
// bf16 once (the reference's :274) and its A fragments stay in registers;
// P is rounded to bf16 (v's type, :249).
// fp32 q/k: S in 3xTF32, with q * scale * log2(e) in fp32 (:274 rounds to
// q's type) in shared memory, its fragments split for each tile (their
// high and low parts would take 4 * HD / 8 registers); P.V in 3xTF32 for
// fp32 v, and for bf16 v on bf16 m16n8k16 with P rounded to bf16.
// At d 256 the block holds O for the columns of its blockIdx.z half
// (out_cols) and loads only those columns of V.
template <int HD, typename TQ, typename TV>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_fwd_mma_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                     const TV* __restrict__ v, TQ* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ q_seg,
                     const int* __restrict__ kv_seg, int sq, int sk, int nh,
                     float scale_log2, int causal, int offset) {
  constexpr bool kBf16 = std::is_same<TQ, bf16>::value;
  constexpr int kOC = out_cols<HD>();         // columns of O a block holds
  constexpr int LD = tile_ld<HD, TQ>();
  constexpr int LDV = tile_ld<kOC, TV>();
  constexpr int kBK = fwd_kv_tile<HD, TQ>();  // keys a KV tile
  constexpr int kTile = kBK * LD;
  constexpr int kVTile = kBK * LDV;
  constexpr int kSteps = HD / 16;   // k-steps of Q K^T on bf16
  constexpr int kOTiles = kOC / 8;  // n-tiles of O
  extern __shared__ uint4 smem_u4[];
  TQ* q_s = reinterpret_cast<TQ*>(smem_u4);                // [64][LD]
  TQ* k_s = q_s + kB * LD;                                 // [2][kBK][LD]
  TV* v_s = reinterpret_cast<TV*>(k_s + 2 * kTile);        // [2][kBK][LDV]
  int* kseg_s = reinterpret_cast<int*>(v_s + 2 * kVTile);  // [2][kBK]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // longest rows first
  const int b = blockIdx.y / nh;
  const int h = blockIdx.y % nh;
  // the block's first column of O (blockIdx.z's half at d 256)
  const int col0 = col_blocks<HD>() > 1 ? blockIdx.z * kOC : 0;
  const int64_t tok = static_cast<int64_t>(nh) * HD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int wrow0 = q0 + 16 * warp;
  const TQ* qb = q + static_cast<int64_t>(b) * sq * tok + h * HD;
  const TQ* kb = k + static_cast<int64_t>(b) * sk * tok + h * HD;
  const TV* vb = v + static_cast<int64_t>(b) * sk * tok + h * HD + col0;
  const int* ksb = kv_seg != nullptr ? kv_seg + static_cast<int64_t>(b) * sk
                                     : nullptr;

  const int n_kv = kv_tiles_for(q0, sq, sk, causal, offset, kBK);
  if (n_kv > 0) {
    if constexpr (!kBf16) copy_tile_async<HD>(q_s, qb, q0, sq, tok);
    copy_tile_async<HD, kBK>(k_s, kb, 0, sk, tok);
    copy_tile_async<kOC, kBK>(v_s, vb, 0, sk, tok);
    if (ksb != nullptr) copy_row_values_async<kBK>(kseg_s, ksb, 0, sk, 1);
  }
  cp_async_commit();

  uint32_t qf[kBf16 ? kSteps : 1][4];
  if constexpr (kBf16) {
    // q * scale * log2(e), rounded to bf16, into q_s; rows past sq are 0
    for (int e = threadIdx.x; e < kB * HD / 8; e += kMmaThreads) {
      const int r = e / (HD / 8);
      const int c = (e % (HD / 8)) * 8;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (q0 + r < sq) {
        u = *reinterpret_cast<const uint4*>(
            qb + static_cast<int64_t>(q0 + r) * tok + c);
        uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
          w[i] = pack_bf16(f.x * scale_log2, f.y * scale_log2);
        }
      }
      *reinterpret_cast<uint4*>(q_s + r * LD + c) = u;
    }
    __syncthreads();
#pragma unroll
    for (int kt = 0; kt < kSteps; ++kt)
      load_a(qf[kt], q_s, LD, 16 * warp, 16 * kt, lane);
  }

  // the lane's two rows: wrow0 + gq and wrow0 + gq + 8
  int qsg[2] = {0, 0};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = wrow0 + gq + 8 * hr;
    if (q_seg != nullptr && row < sq)
      qsg[hr] = q_seg[static_cast<int64_t>(b) * sq + row];
  }
  float o[kOTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int t = 0; t < n_kv; ++t) {
    const int buf = t & 1;
    // tile t has landed and every warp is done with tile t - 1, whose
    // buffer now takes tile t + 1
    cp_async_wait<0>();
    if constexpr (!kBf16) {
      // Q came with tile 0: q * scale * log2(e) in fp32
      if (t == 0) scale_own_chunks<HD>(q_s, scale_log2);
    }
    __syncthreads();
    if (t + 1 < n_kv) {
      const int nb = buf ^ 1;
      copy_tile_async<HD, kBK>(k_s + nb * kTile, kb, (t + 1) * kBK, sk, tok);
      copy_tile_async<kOC, kBK>(v_s + nb * kVTile, vb, (t + 1) * kBK, sk,
                                tok);
      if (ksb != nullptr)
        copy_row_values_async<kBK>(kseg_s + nb * kBK, ksb, (t + 1) * kBK,
                                   sk, 1);
    }
    cp_async_commit();

    const int k0 = t * kBK;
    // warp-uniform: rows past sq, or a tile wholly above this warp's part
    // of the diagonal, add nothing
    if (wrow0 >= sq || (causal && k0 > wrow0 + 15 + offset)) continue;
    const TQ* kt_s = k_s + buf * kTile;
    const TV* vt_s = v_s + buf * kVTile;

    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    if constexpr (kBf16) {
#pragma unroll
      for (int kt = 0; kt < kSteps; ++kt)
#pragma unroll
        for (int np = 0; np < kBK / 16; ++np) {
          uint32_t bf[4];
          load_b(bf, kt_s, LD, 16 * np, 16 * kt, lane);
          mma_bf16_16816(s[2 * np], qf[kt], bf[0], bf[1]);
          mma_bf16_16816(s[2 * np + 1], qf[kt], bf[2], bf[3]);
        }
    } else {
#pragma unroll 2
      for (int kt = 0; kt < HD / 8; ++kt) {
        uint32_t a[4], ahi[4], alo[4];
        load_a_f32(a, q_s, LD, 16 * warp, 8 * kt, lane);
        split_tf32(a, ahi, alo);
#pragma unroll
        for (int np = 0; np < kBK / 16; ++np) {
          uint32_t bf[4], bhi[4], blo[4];
          load_b_f32(bf, kt_s, LD, 16 * np, 8 * kt, lane);
          split_tf32(bf, bhi, blo);
          mma_3xtf32(s[2 * np], ahi, alo, bhi, blo);
          mma_3xtf32(s[2 * np + 1], ahi, alo, bhi + 2, blo + 2);
        }
      }
    }

    if (ksb != nullptr || k0 + kBK > sk ||
        (causal && k0 + kBK - 1 > wrow0 + offset)) {
      const int* ks = kseg_s + buf * kBK;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = wrow0 + gq + 8 * (i >> 1);
          const int col = nt * 8 + 2 * tq + (i & 1);
          const int j = k0 + col;
          bool ok = j < sk;
          if (causal) ok = ok && j <= row + offset;
          if (ksb != nullptr) ok = ok && qsg[i >> 1] == ks[col];
          s[nt][i] = ok ? s[nt][i] : -INFINITY;
        }
    }

    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = m[hr];
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * hr], s[nt][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row that has seen no key yet keeps m = -inf, p = 0, alpha = 0
      const float m_use = mx == -INFINITY ? 0.f : mx;
      alpha[hr] = exp2f(m[hr] - m_use);
      m[hr] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        s[nt][2 * hr] = exp2f(s[nt][2 * hr] - m_use);
        s[nt][2 * hr + 1] = exp2f(s[nt][2 * hr + 1] - m_use);
        sum += s[nt][2 * hr] + s[nt][2 * hr + 1];
      }
      l[hr] = l[hr] * alpha[hr] + sum;
    }
#pragma unroll
    for (int nt = 0; nt < kOTiles; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    if constexpr (std::is_same<TV, bf16>::value) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < kOC / 16; ++dp) {
          uint32_t bf[4];
          load_b_trans(bf, vt_s, LDV, 16 * dp, 16 * kk, lane);
          mma_bf16_16816(o[2 * dp], a, bf[0], bf[1]);
          mma_bf16_16816(o[2 * dp + 1], a, bf[2], bf[3]);
        }
      }
    } else {
      // P V for each 8 columns of O, kTf32Chain k-steps at a time in a
      // zeroed accumulator added to O in fp32
      uint32_t phi[kBK / 8][4], plo[kBK / 8][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        float a[4];
        a_from_c(a, s[kk]);
        split_tf32(a, phi[kk], plo[kk]);
      }
#pragma unroll
      for (int dn = 0; dn < kOTiles; ++dn)
#pragma unroll
        for (int kc = 0; kc < kBK / 8; kc += kTf32Chain) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = kc; kk < kc + kTf32Chain; ++kk) {
            float bv[2];
            uint32_t bhi[2], blo[2];
            load_b_f32_trans(bv, vt_s, LDV, 8 * dn, 8 * kk, lane);
            split_tf32(bv, bhi, blo);
            mma_3xtf32(t, phi[kk], plo[kk], bhi, blo);
          }
          add_c(o[dn], t);
        }
    }
  }

  if (wrow0 >= sq) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lsum = l[hr];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const int row = wrow0 + gq + 8 * hr;
    if (row >= sq) continue;
    const bool empty = lsum == 0.f;
    const float inv = empty ? 0.f : 1.f / lsum;
    TQ* dst = out + (static_cast<int64_t>(b) * sq + row) * tok + h * HD +
              col0 + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < kOTiles; ++nt)
      store2(dst + nt * 8, o[nt][2 * hr] * inv, o[nt][2 * hr + 1] * inv);
    if (tq == 0 && col0 == 0)
      lse[(static_cast<int64_t>(b) * nh + h) * sq + row] =
          empty ? -INFINITY : (m[hr] + log2f(lsum)) * kLn2;
  }
}

// Keys a KV tile of dq, and its buffers: 64 keys in two buffers (the next
// tile in flight while the current one is multiplied), but for fp32 q/k at
// d 128 32 keys in one buffer: Q and dO take 68 KB there, two buffers
// would leave room for one block an SM (203 KB with 64 keys, 135 KB with
// 32), one lets two blocks fit (101 KB; 93 KB mixed), each hiding the
// other's copies.  At d 256 32 keys in one buffer too (bf16 101 KB, two
// blocks an SM; fp32 195 KB, one).
template <int HD, typename TQ>
__host__ __device__ constexpr int dq_kv_tile() {
  return HD <= 128 && (std::is_same<TQ, bf16>::value || HD <= 64) ? kB : 32;
}

template <int HD, typename TQ>
__host__ __device__ constexpr int dq_kv_buffers() {
  return dq_kv_tile<HD, TQ>() == kB ? 2 : 1;
}

template <int HD, typename TQ, typename TV>
constexpr int dq_mma_smem_bytes() {
  // Q, dO (64 rows); K in q's type and V in v's type (dq_kv_buffers of
  // dq_kv_tile rows); kv ids a buffer
  constexpr int kBK = dq_kv_tile<HD, TQ>();
  constexpr int kBuf = dq_kv_buffers<HD, TQ>();
  return 2 * tile_bytes<HD, TQ>() +
         kBuf * kBK * (tile_ld<HD, TQ>() * static_cast<int>(sizeof(TQ)) +
                       tile_ld<HD, TV>() * static_cast<int>(sizeof(TV)) + 4);
}

// Kernel 3, dq of the split backward, on mma.sync (bf16 q/k/v at head dims
// 32 and 256, fp32 q/k at every head dim; bf16 at 64 and 128 runs
// flash_bwd_dq_wgmma_kernel), in the forward's shape: one block per
// (batch * head, 64-row q tile), longest rows first; warp w owns q rows
// 16w .. 16w+15 and their dQ accumulators in registers.  Q (scaled by scale
// * log2(e) in q's type, :564) and dO come with the first KV tile and stay
// in shared memory; the next K/V tile is in flight by cp.async while the
// current one is multiplied (with one buffer, dq_kv_tile, the other block
// on the SM covers the copy), and the KV loop ends at the tile's last
// visible key.  Per KV tile, in chunks of kKC keys (32 at d 128, so that S
// and dP fit beside the 64 dQ registers without spills): S = Q K^T;
// P = exp2(S - lse2), masked only where the chunk crosses the diagonal or
// an edge, or with segments, and 0 where lse is -inf; dP = dO V^T;
// dS = P (dP - delta) in q's type (:502); dQ += dS K.  dQ is multiplied by
// scale and stored in q's type.  At d 256 the block holds dQ for the
// columns of its blockIdx.z half (out_cols).
// dP is summed from the products over k = 8 added in fp32: a query row
// that sees one key has dS = P (dP - delta) = 0 exactly, and the tensor
// cores' fp32 accumulation chained over HD keeps fewer bits than an FMA
// chain.
// bf16: m16n8k16 (m16n8k8 for dP), dS rounded to bf16 when packed into A
// fragments and K read as the B operand of dS K by ldmatrix.trans.  fp32
// q/k: 3xTF32 products with dS in fp32; with bf16 v, dO V^T takes two TF32
// terms (v is exact in TF32).
template <int HD, typename TQ, typename TV>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_bwd_dq_mma_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                        const TV* __restrict__ v,
                        const TQ* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, TQ* __restrict__ dq,
                        const int* __restrict__ q_seg,
                        const int* __restrict__ kv_seg, int sq, int sk,
                        int nh, float scale, int causal, int offset) {
  constexpr bool kBf16 = std::is_same<TQ, bf16>::value;
  constexpr int LD = tile_ld<HD, TQ>();
  constexpr int LDV = tile_ld<HD, TV>();
  constexpr int kBK = dq_kv_tile<HD, TQ>();      // keys a KV tile
  constexpr int kBuf = dq_kv_buffers<HD, TQ>();  // KV tile buffers
  constexpr int kTile = kBK * LD;
  constexpr int kVTile = kBK * LDV;
  constexpr int kOC = out_cols<HD>();       // columns of dQ a block holds
  constexpr int kDTiles = kOC / 8;          // n-tiles of dQ
  constexpr int kKC = HD >= 128 ? 32 : 64;  // keys a chunk
  constexpr int kCT = kKC / 8;              // n-tiles of a chunk's S, dP
  extern __shared__ uint4 smem_u4[];
  TQ* q_s = reinterpret_cast<TQ*>(smem_u4);  // [64][LD]
  TQ* do_s = q_s + kB * LD;                  // [64][LD]
  TQ* k_s = do_s + kB * LD;                  // [kBuf][kBK][LD]
  TV* v_s = reinterpret_cast<TV*>(k_s + kBuf * kTile);        // [..][LDV]
  int* kseg_s = reinterpret_cast<int*>(v_s + kBuf * kVTile);  // [kBuf][kBK]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // longest rows first
  const int b = blockIdx.y / nh;
  const int h = blockIdx.y % nh;
  // the block's first column of dQ (blockIdx.z's half at d 256)
  const int col0 = col_blocks<HD>() > 1 ? blockIdx.z * kOC : 0;
  const int64_t tok = static_cast<int64_t>(nh) * HD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int wrow0 = q0 + 16 * warp;
  const int64_t qoff = static_cast<int64_t>(b) * sq * tok + h * HD;
  const TQ* kb = k + static_cast<int64_t>(b) * sk * tok + h * HD;
  const TV* vb = v + static_cast<int64_t>(b) * sk * tok + h * HD;
  const int* ksb = kv_seg != nullptr ? kv_seg + static_cast<int64_t>(b) * sk
                                     : nullptr;

  const int n_kv = kv_tiles_for(q0, sq, sk, causal, offset, kBK);
  auto issue_kv_tile = [&](int t, int nb) {
    copy_tile_async<HD, kBK>(k_s + nb * kTile, kb, t * kBK, sk, tok);
    copy_tile_async<HD, kBK>(v_s + nb * kVTile, vb, t * kBK, sk, tok);
    if (ksb != nullptr)
      copy_row_values_async<kBK>(kseg_s + nb * kBK, ksb, t * kBK, sk, 1);
  };
  if (n_kv > 0) {
    copy_tile_async<HD>(q_s, q + qoff, q0, sq, tok);
    copy_tile_async<HD>(do_s, dout + qoff, q0, sq, tok);
    issue_kv_tile(0, 0);
  }
  cp_async_commit();

  // the lane's two rows, wrow0 + gq and wrow0 + gq + 8: lse in base 2
  // (+inf past sq and where the row sees no key, so that exp2(s - l2) is
  // 0 there), delta and q ids
  float l2[2], dlt[2];
  int qsg[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = wrow0 + gq + 8 * hr;
    const bool live = row < sq;
    const float ls =
        live ? lse[(static_cast<int64_t>(b) * nh + h) * sq + row] : -INFINITY;
    l2[hr] = ls == -INFINITY ? INFINITY : ls * kLog2e;
    dlt[hr] = live ? delta[(static_cast<int64_t>(b) * sq + row) * nh + h]
                   : 0.f;
    qsg[hr] = (q_seg != nullptr && live)
                  ? q_seg[static_cast<int64_t>(b) * sq + row] : 0;
  }
  float acc[kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    const int buf = kBuf == 2 ? t & 1 : 0;
    if (kBuf == 1 && t > 0) {
      // one buffer: every warp is done with tile t - 1, which tile t
      // replaces
      __syncthreads();
      issue_kv_tile(t, 0);
      cp_async_commit();
    }
    cp_async_wait<0>();
    if (t == 0) scale_own_chunks<HD>(q_s, scale * kLog2e);
    // tile t (and, at t = 0, Q and dO) is in place for the block; with two
    // buffers every warp is done with tile t - 1, whose buffer takes tile
    // t + 1
    __syncthreads();
    if (kBuf == 2 && t + 1 < n_kv) issue_kv_tile(t + 1, buf ^ 1);
    cp_async_commit();

    const int k0 = t * kBK;
    if (wrow0 >= sq || (causal && k0 > wrow0 + 15 + offset)) continue;
    const TQ* kt_s = k_s + buf * kTile;
    const TV* vt_s = v_s + buf * kVTile;
    const int* ks = kseg_s + buf * kBK;

#pragma unroll 1
    for (int c0 = 0; c0 < kBK; c0 += kKC) {
      const int j0 = k0 + c0;
      if (causal && j0 > wrow0 + 15 + offset) break;
      float s[kCT][4], dp[kCT][4];
#pragma unroll
      for (int nt = 0; nt < kCT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;

      // S = Q K^T
      if constexpr (kBf16) {
#pragma unroll 2
        for (int kt = 0; kt < HD / 16; ++kt) {
          uint32_t af[4];
          load_a(af, q_s, LD, 16 * warp, 16 * kt, lane);
#pragma unroll
          for (int np = 0; np < kCT / 2; ++np) {
            uint32_t bf[4];
            load_b(bf, kt_s, LD, c0 + 16 * np, 16 * kt, lane);
            mma_bf16_16816(s[2 * np], af, bf[0], bf[1]);
            mma_bf16_16816(s[2 * np + 1], af, bf[2], bf[3]);
          }
        }
      } else {
#pragma unroll 2
        for (int kt = 0; kt < HD / 8; ++kt) {
          uint32_t a[4], ahi[4], alo[4];
          load_a_f32(a, q_s, LD, 16 * warp, 8 * kt, lane);
          split_tf32(a, ahi, alo);
#pragma unroll
          for (int np = 0; np < kCT / 2; ++np) {
            uint32_t bf[4], bhi[4], blo[4];
            load_b_f32(bf, kt_s, LD, c0 + 16 * np, 8 * kt, lane);
            split_tf32(bf, bhi, blo);
            mma_3xtf32(s[2 * np], ahi, alo, bhi, blo);
            mma_3xtf32(s[2 * np + 1], ahi, alo, bhi + 2, blo + 2);
          }
        }
      }

      // P = exp2(S - lse2), 0 where the key is masked
      const bool masked = ksb != nullptr || j0 + kKC > sk ||
                          (causal && j0 + kKC - 1 > wrow0 + offset);
#pragma unroll
      for (int nt = 0; nt < kCT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = c0 + nt * 8 + 2 * tq + (i & 1);
          bool ok = true;
          if (masked) {
            const int j = k0 + col;
            ok = j < sk;
            if (causal) ok = ok && j <= wrow0 + gq + 8 * (i >> 1) + offset;
            if (ksb != nullptr) ok = ok && qsg[i >> 1] == ks[col];
          }
          s[nt][i] = ok ? exp2f(s[nt][i] - l2[i >> 1]) : 0.f;
        }

      // dP = dO V^T
      if constexpr (kBf16) {
#pragma unroll 2
        for (int kt = 0; kt < HD / 16; ++kt) {
          uint32_t af[4];
          load_a(af, do_s, LD, 16 * warp, 16 * kt, lane);
#pragma unroll
          for (int np = 0; np < kCT / 2; ++np) {
            uint32_t bf[4];
            load_b(bf, vt_s, LDV, c0 + 16 * np, 16 * kt, lane);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16_1688(t0, af[2 * half], af[2 * half + 1], bf[half]);
              mma_bf16_1688(t1, af[2 * half], af[2 * half + 1], bf[2 + half]);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                dp[2 * np][e] += t0[e];
                dp[2 * np + 1][e] += t1[e];
              }
            }
          }
        }
      } else {
#pragma unroll 2
        for (int kt = 0; kt < HD / 8; ++kt) {
          uint32_t a[4], ahi[4], alo[4];
          load_a_f32(a, do_s, LD, 16 * warp, 8 * kt, lane);
          split_tf32(a, ahi, alo);
          if constexpr (std::is_same<TV, float>::value) {
#pragma unroll
            for (int np = 0; np < kCT / 2; ++np) {
              uint32_t bf[4], bhi[4], blo[4];
              load_b_f32(bf, vt_s, LDV, c0 + 16 * np, 8 * kt, lane);
              split_tf32(bf, bhi, blo);
              float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
              mma_3xtf32(t0, ahi, alo, bhi, blo);
              mma_3xtf32(t1, ahi, alo, bhi + 2, blo + 2);
              add_c(dp[2 * np], t0);
              add_c(dp[2 * np + 1], t1);
            }
          } else {
#pragma unroll
            for (int nt = 0; nt < kCT; ++nt) {
              const TV* vr = vt_s + (c0 + 8 * nt + gq) * LDV + 8 * kt + tq;
              const uint32_t b0 = bf16_as_tf32(vr[0]);
              const uint32_t b1 = bf16_as_tf32(vr[4]);
              float t0[4] = {0.f, 0.f, 0.f, 0.f};
              mma_tf32_1688(t0, alo, b0, b1);
              mma_tf32_1688(t0, ahi, b0, b1);
              add_c(dp[nt], t0);
            }
          }
        }
      }

      // dS = P (dP - delta), then dQ += dS K
      if constexpr (kBf16) {
#pragma unroll
        for (int kk = 0; kk < kCT / 2; ++kk) {
          uint32_t a[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float* sp = s[2 * kk + (r >> 1)];
            const float* dpp = dp[2 * kk + (r >> 1)];
            const int e = 2 * (r & 1);
            const float d = dlt[r & 1];
            a[r] = pack_bf16(sp[e] * (dpp[e] - d),
                             sp[e + 1] * (dpp[e + 1] - d));
          }
#pragma unroll
          for (int dn = 0; dn < kOC / 16; ++dn) {
            uint32_t bf[4];
            load_b_trans(bf, kt_s, LD, col0 + 16 * dn, c0 + 16 * kk, lane);
            mma_bf16_16816(acc[2 * dn], a, bf[0], bf[1]);
            mma_bf16_16816(acc[2 * dn + 1], a, bf[2], bf[3]);
          }
        }
      } else {
        // dS K for each 8 columns of dQ, kTf32Chain k-steps at a time in
        // a zeroed accumulator added to dQ in fp32
        uint32_t dhi[kCT][4], dlo[kCT][4];
#pragma unroll
        for (int kk = 0; kk < kCT; ++kk) {
          float ds[4], a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            ds[i] = s[kk][i] * (dp[kk][i] - dlt[i >> 1]);
          a_from_c(a, ds);
          split_tf32(a, dhi[kk], dlo[kk]);
        }
#pragma unroll
        for (int dn = 0; dn < kDTiles; ++dn)
#pragma unroll
          for (int kc = 0; kc < kCT; kc += kTf32Chain) {
            float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kk = kc; kk < kc + kTf32Chain; ++kk) {
              float bk[2];
              uint32_t bhi[2], blo[2];
              load_b_f32_trans(bk, kt_s, LD, col0 + 8 * dn, c0 + 8 * kk,
                               lane);
              split_tf32(bk, bhi, blo);
              mma_3xtf32(t, dhi[kk], dlo[kk], bhi, blo);
            }
            add_c(acc[dn], t);
          }
      }
    }
  }

  if (wrow0 >= sq) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = wrow0 + gq + 8 * hr;
    if (row >= sq) continue;
    TQ* dst = dq + qoff + static_cast<int64_t>(row) * tok + col0 + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt)
      store2(dst + nt * 8, acc[nt][2 * hr] * scale,
             acc[nt][2 * hr + 1] * scale);
  }
}

template <int HD, bool kFused>
constexpr int dkv_mma_smem_bytes() {
  // K, V, Q x 2, dO x 2; dS [64][72] (fused); lse, delta, q ids x 2
  return 6 * mma_tile_elems<HD>() * 2 + (kFused ? kB * (kB + 8) * 2 : 0) +
         6 * kB * 4;
}

// The dk/dv template (kernel 4, and kernel 2 with kFused) on bf16 q/k/v
// at head dims 32 and 256 (64 and 128 take flash_bwd_dkv_wgmma_kernel).
// One block per (batch * head, 64-key tile); warp w owns keys 16w .. 16w+15
// and their dK and dV accumulators in registers.  The q tiles that see the
// key tile stream through two buffers by cp.async (Q, dO, lse, delta and q
// ids; Q is scaled by scale * log2(e) and rounded to bf16 in place, the
// reference's :405).  Per q tile, in column chunks of kQC q rows:
// S^T = K Q^T, P^T = exp2(S^T - lse2) masked, rounded to bf16 (do's type,
// :377) for dV += P^T dO; dP^T = V dO^T; dS^T = P^T (dP^T - delta),
// rounded to bf16 (q's type, :383), for dK += dS^T Q.  With kFused, delta
// = rowsum(dO * O) is computed here, dS^T goes through shared memory and
// dQ_part = dS K (warp w: q rows 16w .. 16w+15) is added into the fp32
// dq_acc with atomics.  dK is divided by log2(e) and dQ multiplied by
// scale.  At d 256 the block holds dK, dV and dQ_part for the columns of
// its blockIdx.z half (out_cols), and takes one block an SM (213 KB).
template <int HD, bool kFused>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ out,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq_acc, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, const int* __restrict__ q_seg,
                         const int* __restrict__ kv_seg, int sq, int sk,
                         int nh, float scale, int causal, int offset) {
  constexpr int LD = HD + 8;
  constexpr int kTile = mma_tile_elems<HD>();
  constexpr int kSteps = HD / 16;
  constexpr int kOC = out_cols<HD>();       // columns a block holds
  constexpr int kDTiles = kOC / 8;          // n-tiles of dK and dV
  constexpr int kQC = HD >= 128 ? 32 : 64;  // q columns per chunk
  constexpr int kDsLD = kB + 8;
  extern __shared__ uint4 smem_u4[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_u4);
  bf16* v_s = k_s + kTile;
  bf16* q_s = v_s + kTile;                // [2][64][LD]
  bf16* do_s = q_s + 2 * kTile;           // [2][64][LD]
  bf16* ds_s = do_s + 2 * kTile;          // [64 keys][kDsLD] (fused)
  float* lse_s = reinterpret_cast<float*>(ds_s + (kFused ? kB * kDsLD : 0));
  float* dlt_s = lse_s + 2 * kB;          // [2][64]
  int* qseg_s = reinterpret_cast<int*>(dlt_s + 2 * kB);  // [2][64]

  const int k0 = blockIdx.x * kB;
  const int b = blockIdx.y / nh;
  const int h = blockIdx.y % nh;
  // the block's first column (blockIdx.z's half at d 256)
  const int col0 = col_blocks<HD>() > 1 ? blockIdx.z * kOC : 0;
  const int64_t tok = static_cast<int64_t>(nh) * HD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int64_t qoff = static_cast<int64_t>(b) * sq * tok + h * HD;
  const int64_t koff = static_cast<int64_t>(b) * sk * tok + h * HD;
  const float* lseb = lse + (static_cast<int64_t>(b) * nh + h) * sq;
  const float* dltb =
      kFused ? nullptr : delta + static_cast<int64_t>(b) * sq * nh + h;
  const int* qsb =
      q_seg != nullptr ? q_seg + static_cast<int64_t>(b) * sq : nullptr;

  const int first = first_q_tile(k0, causal, offset) * kB;
  const int n_q = first < sq ? (sq - first + kB - 1) / kB : 0;
  auto issue_q_tile = [&](int q0, int nb) {
    copy_tile_async<HD>(q_s + nb * kTile, q + qoff, q0, sq, tok);
    copy_tile_async<HD>(do_s + nb * kTile, dout + qoff, q0, sq, tok);
    copy_row_values_async(lse_s + nb * kB, lseb, q0, sq, 1);
    if (!kFused) copy_row_values_async(dlt_s + nb * kB, dltb, q0, sq, nh);
    if (qsb != nullptr) copy_row_values_async(qseg_s + nb * kB, qsb, q0, sq, 1);
  };
  copy_tile_async<HD>(k_s, k + koff, k0, sk, tok);
  copy_tile_async<HD>(v_s, v + koff, k0, sk, tok);
  if (n_q > 0) issue_q_tile(first, 0);
  cp_async_commit();

  // the lane's two keys: k0 + 16w + gq and k0 + 16w + gq + 8
  int kj[2], ksg[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    kj[hr] = k0 + 16 * warp + gq + 8 * hr;
    ksg[hr] = (kv_seg != nullptr && kj[hr] < sk)
                  ? kv_seg[static_cast<int64_t>(b) * sk + kj[hr]] : 0;
  }
  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[nt][i] = dv_acc[nt][i] = 0.f;

  for (int it = 0; it < n_q; ++it) {
    const int q0 = first + it * kB;
    const int buf = it & 1;
    bf16* qt_s = q_s + buf * kTile;
    const bf16* dot_s = do_s + buf * kTile;
    const float* lt_s = lse_s + buf * kB;
    float* dt_s = dlt_s + buf * kB;
    const int* st_s = qseg_s + buf * kB;
    cp_async_wait<0>();
    scale_own_chunks<HD>(qt_s, scale * kLog2e);
    // tile it is in place for the block, and tile it - 1 is consumed
    __syncthreads();
    if (it + 1 < n_q) issue_q_tile(q0 + kB, buf ^ 1);
    cp_async_commit();

    if (kFused) {
      // delta = rowsum(dO * O) for the warp's 16 q rows, two lanes a row
      // with HD / 2 columns each (all loads in flight at once), in fp64
      const int row = 16 * warp + (lane >> 1);
      const int i = q0 + row;
      const int c0 = (lane & 1) * (HD / 2);
      double part = 0.;
      if (i < sq) {
#pragma unroll 8
        for (int c = c0; c < c0 + HD / 2; c += 8) {
          const uint4 du = *reinterpret_cast<const uint4*>(dot_s + row * LD +
                                                           c);
          const uint4 ou = *reinterpret_cast<const uint4*>(
              out + qoff + static_cast<int64_t>(i) * tok + c);
          const uint32_t* dw = reinterpret_cast<const uint32_t*>(&du);
          const uint32_t* ow = reinterpret_cast<const uint32_t*>(&ou);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 a = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&dw[j]));
            const float2 c2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&ow[j]));
            part += static_cast<double>(a.x) * c2.x +
                    static_cast<double>(a.y) * c2.y;
          }
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if ((lane & 1) == 0) dt_s[row] = static_cast<float>(part);
      __syncthreads();
    }

    const bool masked = qsb != nullptr || q0 + kB > sq || k0 + kB > sk ||
                        (causal && k0 + 16 * warp + 15 > q0 + offset);
#pragma unroll 1
    for (int qc = 0; qc < kB; qc += kQC) {
      // S^T and P^T: rows are the warp's 16 keys, columns q rows qc ..
      float st[kQC / 8][4];
#pragma unroll
      for (int nt = 0; nt < kQC / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[nt][i] = 0.f;
#pragma unroll 2
      for (int kt = 0; kt < kSteps; ++kt) {
        uint32_t af[4];
        load_a(af, k_s, LD, 16 * warp, 16 * kt, lane);
#pragma unroll
        for (int np = 0; np < kQC / 16; ++np) {
          uint32_t bf[4];
          load_b(bf, qt_s, LD, qc + 16 * np, 16 * kt, lane);
          mma_bf16_16816(st[2 * np], af, bf[0], bf[1]);
          mma_bf16_16816(st[2 * np + 1], af, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kQC / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = qc + nt * 8 + 2 * tq + (i & 1);
          const int qi = q0 + col;
          const int key = kj[i >> 1];
          const float l2 = lt_s[col] * kLog2e;
          bool ok = true;
          if (masked) {
            ok = qi < sq && key < sk && l2 != -INFINITY;
            if (causal) ok = ok && key <= qi + offset;
            if (qsb != nullptr) ok = ok && st_s[col] == ksg[i >> 1];
          }
          st[nt][i] = ok ? exp2f(st[nt][i] - l2) : 0.f;
        }

      // dV += P^T dO
#pragma unroll
      for (int kk = 0; kk < kQC / 16; ++kk) {
        const uint32_t a[4] = {
            pack_bf16(st[2 * kk][0], st[2 * kk][1]),
            pack_bf16(st[2 * kk][2], st[2 * kk][3]),
            pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
            pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < kOC / 16; ++dp) {
          uint32_t bf[4];
          load_b_trans(bf, dot_s, LD, col0 + 16 * dp, qc + 16 * kk, lane);
          mma_bf16_16816(dv_acc[2 * dp], a, bf[0], bf[1]);
          mma_bf16_16816(dv_acc[2 * dp + 1], a, bf[2], bf[3]);
        }
      }

      // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) in bf16.  Where a
      // row's p is one key's (the first causal row), dP^T - delta cancels
      // exactly, and what is left is the rounding of the two sums.  The
      // tensor cores' fp32 accumulation keeps fewer bits than an FMA
      // chain, so dP^T is summed from products over k = 8 added in fp32
      // and the fused kernel's delta in fp64, which leaves that row at
      // the size of one fp32 rounding
      float dpt[kQC / 8][4];
#pragma unroll
      for (int nt = 0; nt < kQC / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) dpt[nt][i] = 0.f;
#pragma unroll 2
      for (int kt = 0; kt < kSteps; ++kt) {
        uint32_t af[4];
        load_a(af, v_s, LD, 16 * warp, 16 * kt, lane);
#pragma unroll
        for (int np = 0; np < kQC / 16; ++np) {
          uint32_t bf[4];
          load_b(bf, dot_s, LD, qc + 16 * np, 16 * kt, lane);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16_1688(t0, af[2 * half], af[2 * half + 1], bf[half]);
            mma_bf16_1688(t1, af[2 * half], af[2 * half + 1], bf[2 + half]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dpt[2 * np][e] += t0[e];
              dpt[2 * np + 1][e] += t1[e];
            }
          }
        }
      }
      uint32_t dsf[kQC / 8][2];  // dS^T packed: [n-tile][row gq, gq + 8]
#pragma unroll
      for (int nt = 0; nt < kQC / 8; ++nt) {
        const int col = qc + nt * 8 + 2 * tq;
        const float d0 = dt_s[col], d1 = dt_s[col + 1];
        dsf[nt][0] = pack_bf16(st[nt][0] * (dpt[nt][0] - d0),
                               st[nt][1] * (dpt[nt][1] - d1));
        dsf[nt][1] = pack_bf16(st[nt][2] * (dpt[nt][2] - d0),
                               st[nt][3] * (dpt[nt][3] - d1));
        if (kFused) {
          bf16* row = ds_s + (16 * warp + gq) * kDsLD + col;
          *reinterpret_cast<uint32_t*>(row) = dsf[nt][0];
          *reinterpret_cast<uint32_t*>(row + 8 * kDsLD) = dsf[nt][1];
        }
      }

      // dK += dS^T Q (Q scaled by scale * log2(e))
#pragma unroll
      for (int kk = 0; kk < kQC / 16; ++kk) {
        const uint32_t a[4] = {dsf[2 * kk][0], dsf[2 * kk][1],
                               dsf[2 * kk + 1][0], dsf[2 * kk + 1][1]};
#pragma unroll
        for (int dp = 0; dp < kOC / 16; ++dp) {
          uint32_t bf[4];
          load_b_trans(bf, qt_s, LD, col0 + 16 * dp, qc + 16 * kk, lane);
          mma_bf16_16816(dk_acc[2 * dp], a, bf[0], bf[1]);
          mma_bf16_16816(dk_acc[2 * dp + 1], a, bf[2], bf[3]);
        }
      }
    }

    if (kFused) {
      __syncthreads();  // every warp's dS^T rows are in ds_s
      // dQ_part = dS K for q rows 16w .. 16w+15, kDC columns at a time
      constexpr int kDC = HD < 64 ? HD : 64;
#pragma unroll 1
      for (int d0 = col0; d0 < col0 + kOC; d0 += kDC) {
        float acc[kDC / 8][4];
#pragma unroll
        for (int nt = 0; nt < kDC / 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kB / 16; ++kk) {
          uint32_t af[4];
          load_a_trans(af, ds_s, kDsLD, 16 * warp, 16 * kk, lane);
#pragma unroll
          for (int dp = 0; dp < kDC / 16; ++dp) {
            uint32_t bf[4];
            load_b_trans(bf, k_s, LD, d0 + 16 * dp, 16 * kk, lane);
            mma_bf16_16816(acc[2 * dp], af, bf[0], bf[1]);
            mma_bf16_16816(acc[2 * dp + 1], af, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = q0 + 16 * warp + gq + 8 * hr;
          if (i >= sq) continue;
          float* dst = dq_acc + qoff + static_cast<int64_t>(i) * tok + d0 +
                       2 * tq;
#pragma unroll
          for (int nt = 0; nt < kDC / 8; ++nt)
            add2(dst + nt * 8, acc[nt][2 * hr] * scale,
                 acc[nt][2 * hr + 1] * scale);
        }
      }
    }
  }

  // dk was accumulated against q * scale * log2(e): divide the log2(e) out
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (kj[hr] >= sk) continue;
    const int64_t row =
        koff + static_cast<int64_t>(kj[hr]) * tok + col0 + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
      *reinterpret_cast<uint32_t*>(dk + row + nt * 8) =
          pack_bf16(dk_acc[nt][2 * hr] / kLog2e,
                    dk_acc[nt][2 * hr + 1] / kLog2e);
      *reinterpret_cast<uint32_t*>(dv + row + nt * 8) =
          pack_bf16(dv_acc[nt][2 * hr], dv_acc[nt][2 * hr + 1]);
    }
  }
}

// q rows a tile of the 3xTF32 dk/dv template streams.  fp32 tiles are
// twice the bytes of bf16 ones: at d 128, K and V take 67.6 KB, and 64-row
// Q and dO tiles in two buffers another 135 KB, one block an SM.  32 rows
// at d 64 and 32; 16 at d 128, where S^T and dP^T of 32 q columns beside
// the 128 registers of the dK/dV accumulators spill, and where 16-row
// tiles in two buffers still leave room for two blocks an SM; 16 at d 256
// (K and V alone take 133 KB: one block an SM).
template <int HD>
__host__ __device__ constexpr int dkv_tf32_rows() {
  return HD >= 128 ? 16 : 32;
}
// the most dynamic shared memory a block may take for two blocks to fit an
// SM (228 KB, less the 1 KB the card reserves for each block)
constexpr int kTwoBlockSmem = 113 * 1024;

template <int HD, bool kFused>
__host__ __device__ constexpr int dkv_tf32_smem_bytes() {
  // K, V (fp32, 64 rows); Q, dO, lse, delta, q ids (two buffers of
  // dkv_tf32_rows rows); dS [dkv_tf32_rows][64 + 4] (fused)
  return 2 * tile_bytes<HD, float>() +
         2 * dkv_tf32_rows<HD>() * (2 * tile_ld<HD, float>() + 3) * 4 +
         (kFused ? dkv_tf32_rows<HD>() * (kB + 4) * 4 : 0);
}

// acc[dn] (16 rows, columns n0 + 8 dn ..) += A t over kSteps k-steps of 8
// in 3xTF32: a_of(kk, a) gives A's fragment of k-step kk in the k order of
// a_from_c, t is an fp32 tile stored [k][n] (row stride ld) read by
// load_b_f32_trans; kTf32Chain k-steps at a time in a zeroed accumulator
// added to acc in fp32.
template <int kNT, int kSteps, typename AOf>
__device__ __forceinline__ void mma_tf32_kn(float (&acc)[kNT][4], AOf&& a_of,
                                            const float* t, int ld, int n0,
                                            int lane) {
  static_assert(kSteps % kTf32Chain == 0, "whole chains");
#pragma unroll
  for (int kc = 0; kc < kSteps; kc += kTf32Chain) {
    uint32_t ahi[kTf32Chain][4], alo[kTf32Chain][4];
#pragma unroll
    for (int j = 0; j < kTf32Chain; ++j) {
      float a[4];
      a_of(kc + j, a);
      split_tf32(a, ahi[j], alo[j]);
    }
#pragma unroll
    for (int dn = 0; dn < kNT; ++dn) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kTf32Chain; ++j) {
        float bv[2];
        uint32_t bhi[2], blo[2];
        load_b_f32_trans(bv, t, ld, n0 + 8 * dn, 8 * (kc + j), lane);
        split_tf32(bv, bhi, blo);
        mma_3xtf32(s, ahi[j], alo[j], bhi, blo);
      }
      add_c(acc[dn], s);
    }
  }
}

// The dk/dv template (kernel 4, and kernel 2 with kFused) on fp32 q/k, with
// v in fp32 or bf16, in 3xTF32, in the shape of the bf16 template: one
// block per (batch * head, 64-key tile), warp w owns keys 16w .. 16w+15 and
// their dK and dV accumulators in registers.  K and V stay in shared memory
// in fp32 (bf16 v widened, exact in TF32); q tiles of dkv_tf32_rows rows (Q,
// dO, lse, delta, q ids) stream through two buffers by cp.async, the next
// in flight while the current one is multiplied, Q scaled by scale * log2(e) in fp32 in place (the reference's
// :405 rounds to q's type).  Per q tile: S^T = K Q^T, chained over the head
// dim as the forward's S; P^T = exp2(S^T - lse2) masked, in fp32 (do's
// type, :377); dV += P^T dO; dP^T = V dO^T from products over k = 8
// added in fp32 (the single-key row's cancellation, see the bf16
// template), in two TF32 terms for bf16 v; dS^T = P^T (dP^T - delta) in
// fp32 (q's type, :383); dK += dS^T Q.  P^T and dS^T are the A operands of their products
// straight from the S^T registers (a_from_c), dO and Q the B operands
// stored [k][n] (load_b_f32_trans), kTf32Chain k-steps a chain.  With
// kFused, delta = rowsum(dO * O) is computed here in fp64, dS goes through
// shared memory and dQ_part = dS K (each warp a 16-row m-tile and a share
// of the head columns) is added into the fp32 dq_acc with 8-byte atomics.
// dK is divided by log2(e) and dQ multiplied by scale.  At d 256 the block
// holds dK, dV and dQ_part for the columns of its blockIdx.z half
// (out_cols).
template <int HD, typename TV, bool kFused>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const TV* __restrict__ v,
                          const float* __restrict__ out,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq_acc, float* __restrict__ dk,
                          TV* __restrict__ dv, const int* __restrict__ q_seg,
                          const int* __restrict__ kv_seg, int sq, int sk,
                          int nh, float scale, int causal, int offset) {
  constexpr int LD = tile_ld<HD, float>();
  constexpr int kBQ = dkv_tf32_rows<HD>();  // q rows a tile
  constexpr int kQTile = kBQ * LD;
  static_assert(HD > 128 || dkv_tf32_smem_bytes<HD, kFused>() <=
                                kTwoBlockSmem,
                "two blocks an SM");
  constexpr int kOC = out_cols<HD>();  // columns a block holds
  constexpr int kDTiles = kOC / 8;     // n-tiles of dK and dV
  constexpr int kQT = kBQ / 8;         // n-tiles of S^T and dP^T
  constexpr int kDsLD = kB + 4;
  // dQ_part: warp w takes m-tile w % kMT and kDqSpan head columns
  constexpr int kMT = kBQ / 16;
  constexpr int kDqSpan = kOC * kMT / 4;
  // dQ columns a pass: 32, 16 at d 256 (a column offset more is live)
  constexpr int kDqCols = kDqSpan < 32 ? kDqSpan : HD > 128 ? 16 : 32;
  constexpr int kTpr = kMmaThreads / kBQ;  // threads a row of delta
  extern __shared__ uint4 smem_u4[];
  float* k_s = reinterpret_cast<float*>(smem_u4);   // [64][LD]
  float* v_s = k_s + kB * LD;                        // [64][LD]
  float* q_s = v_s + kB * LD;                        // [2][kBQ][LD]
  float* do_s = q_s + 2 * kQTile;                    // [2][kBQ][LD]
  float* ds_s = do_s + 2 * kQTile;                   // [kBQ][kDsLD] (fused)
  float* lse_s = ds_s + (kFused ? kBQ * kDsLD : 0);  // [2][kBQ]
  float* dlt_s = lse_s + 2 * kBQ;                    // [2][kBQ]
  int* qseg_s = reinterpret_cast<int*>(dlt_s + 2 * kBQ);  // [2][kBQ]

  const int k0 = blockIdx.x * kB;
  const int b = blockIdx.y / nh;
  const int h = blockIdx.y % nh;
  // the block's first column (blockIdx.z's half at d 256)
  const int col0 = col_blocks<HD>() > 1 ? blockIdx.z * kOC : 0;
  const int64_t tok = static_cast<int64_t>(nh) * HD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int64_t qoff = static_cast<int64_t>(b) * sq * tok + h * HD;
  const int64_t koff = static_cast<int64_t>(b) * sk * tok + h * HD;
  const float* lseb = lse + (static_cast<int64_t>(b) * nh + h) * sq;
  const float* dltb =
      kFused ? nullptr : delta + static_cast<int64_t>(b) * sq * nh + h;
  const int* qsb =
      q_seg != nullptr ? q_seg + static_cast<int64_t>(b) * sq : nullptr;

  const int first = first_q_tile(k0, causal, offset, kBQ) * kBQ;
  const int n_q = first < sq ? (sq - first + kBQ - 1) / kBQ : 0;
  auto issue_q_tile = [&](int q0, int nb) {
    copy_tile_async<HD, kBQ>(q_s + nb * kQTile, q + qoff, q0, sq, tok);
    copy_tile_async<HD, kBQ>(do_s + nb * kQTile, dout + qoff, q0, sq, tok);
    copy_row_values_async<kBQ>(lse_s + nb * kBQ, lseb, q0, sq, 1);
    if (!kFused)
      copy_row_values_async<kBQ>(dlt_s + nb * kBQ, dltb, q0, sq, nh);
    if (qsb != nullptr)
      copy_row_values_async<kBQ>(qseg_s + nb * kBQ, qsb, q0, sq, 1);
  };
  copy_tile_async<HD>(k_s, k + koff, k0, sk, tok);
  if constexpr (std::is_same<TV, float>::value) {
    copy_tile_async<HD>(v_s, v + koff, k0, sk, tok);
  } else {
    // bf16 v widened to fp32 (visible to the block after the first
    // barrier); rows past sk are 0
    for (int e = threadIdx.x; e < kB * HD / 8; e += kMmaThreads) {
      const int r = e / (HD / 8);
      const int c = (e % (HD / 8)) * 8;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (k0 + r < sk)
        u = *reinterpret_cast<const uint4*>(
            v + koff + static_cast<int64_t>(k0 + r) * tok + c);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&u);
      float f[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 p = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        f[2 * i] = p.x;
        f[2 * i + 1] = p.y;
      }
      float* dst = v_s + r * LD + c;
      *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(f[4], f[5], f[6], f[7]);
    }
  }
  if (n_q > 0) issue_q_tile(first, 0);
  cp_async_commit();

  // the lane's two keys: k0 + 16w + gq and k0 + 16w + gq + 8
  int kj[2], ksg[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    kj[hr] = k0 + 16 * warp + gq + 8 * hr;
    ksg[hr] = (kv_seg != nullptr && kj[hr] < sk)
                  ? kv_seg[static_cast<int64_t>(b) * sk + kj[hr]] : 0;
  }
  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[nt][i] = dv_acc[nt][i] = 0.f;

  for (int it = 0; it < n_q; ++it) {
    const int q0 = first + it * kBQ;
    const int buf = it & 1;
    float* qt_s = q_s + buf * kQTile;
    const float* dot_s = do_s + buf * kQTile;
    const float* lt_s = lse_s + buf * kBQ;
    float* dt_s = dlt_s + buf * kBQ;
    const int* st_s = qseg_s + buf * kBQ;
    cp_async_wait<0>();
    scale_own_chunks<HD, kBQ>(qt_s, scale * kLog2e);
    // tile it is in place for the block, and every warp is done with tile
    // it - 1, whose buffer takes tile it + 1
    __syncthreads();
    if (it + 1 < n_q) issue_q_tile(q0 + kBQ, buf ^ 1);
    cp_async_commit();

    if (kFused) {
      // delta = rowsum(dO * O), kTpr lanes a row with HD / kTpr columns
      // each, in fp64
      const int row = threadIdx.x / kTpr;
      const int i = q0 + row;
      const int c0 = (threadIdx.x % kTpr) * (HD / kTpr);
      double part = 0.;
      if (i < sq) {
#pragma unroll 4
        for (int c = c0; c < c0 + HD / kTpr; c += 4) {
          const float4 d4 =
              *reinterpret_cast<const float4*>(dot_s + row * LD + c);
          const float4 o4 = *reinterpret_cast<const float4*>(
              out + qoff + static_cast<int64_t>(i) * tok + c);
          part += static_cast<double>(d4.x) * o4.x +
                  static_cast<double>(d4.y) * o4.y +
                  static_cast<double>(d4.z) * o4.z +
                  static_cast<double>(d4.w) * o4.w;
        }
      }
#pragma unroll
      for (int o = kTpr / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (threadIdx.x % kTpr == 0) dt_s[row] = static_cast<float>(part);
      __syncthreads();
    }

    const bool masked = qsb != nullptr || q0 + kBQ > sq || k0 + kB > sk ||
                        (causal && k0 + 16 * warp + 15 > q0 + offset);
    // S^T = K Q^T: rows the warp's 16 keys, columns the tile's q rows
    float st[kQT][4];
#pragma unroll
    for (int nt = 0; nt < kQT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[nt][i] = 0.f;
#pragma unroll 2
    for (int kt = 0; kt < HD / 8; ++kt) {
      uint32_t a[4], ahi[4], alo[4];
      load_a_f32(a, k_s, LD, 16 * warp, 8 * kt, lane);
      split_tf32(a, ahi, alo);
#pragma unroll
      for (int np = 0; np < kQT / 2; ++np) {
        uint32_t bf[4], bhi[4], blo[4];
        load_b_f32(bf, qt_s, LD, 16 * np, 8 * kt, lane);
        split_tf32(bf, bhi, blo);
        mma_3xtf32(st[2 * np], ahi, alo, bhi, blo);
        mma_3xtf32(st[2 * np + 1], ahi, alo, bhi + 2, blo + 2);
      }
    }
    // P^T = exp2(S^T - lse2), 0 where the pair is masked
#pragma unroll
    for (int nt = 0; nt < kQT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + 2 * tq + (i & 1);
        const int qi = q0 + col;
        const int key = kj[i >> 1];
        const float l2 = lt_s[col] * kLog2e;
        bool ok = true;
        if (masked) {
          ok = qi < sq && key < sk && l2 != -INFINITY;
          if (causal) ok = ok && key <= qi + offset;
          if (qsb != nullptr) ok = ok && st_s[col] == ksg[i >> 1];
        }
        st[nt][i] = ok ? exp2f(st[nt][i] - l2) : 0.f;
      }

    // dV += P^T dO
    mma_tf32_kn<kDTiles, kQT>(
        dv_acc, [&](int kk, float (&a)[4]) { a_from_c(a, st[kk]); }, dot_s,
        LD, col0, lane);

    // dP^T = V dO^T, each k-step's product added in fp32
    float dpt[kQT][4];
#pragma unroll
    for (int nt = 0; nt < kQT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) dpt[nt][i] = 0.f;
#pragma unroll 2
    for (int kt = 0; kt < HD / 8; ++kt) {
      uint32_t a[4], ahi[4], alo[4];
      load_a_f32(a, v_s, LD, 16 * warp, 8 * kt, lane);
      if constexpr (std::is_same<TV, float>::value) split_tf32(a, ahi, alo);
#pragma unroll
      for (int np = 0; np < kQT / 2; ++np) {
        uint32_t bf[4], bhi[4], blo[4];
        load_b_f32(bf, dot_s, LD, 16 * np, 8 * kt, lane);
        split_tf32(bf, bhi, blo);
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (std::is_same<TV, float>::value) {
          mma_3xtf32(t0, ahi, alo, bhi, blo);
          mma_3xtf32(t1, ahi, alo, bhi + 2, blo + 2);
        } else {
          // v is exact in TF32: v.dO_lo + v.dO_hi
          mma_tf32_1688(t0, a, blo[0], blo[1]);
          mma_tf32_1688(t0, a, bhi[0], bhi[1]);
          mma_tf32_1688(t1, a, blo[2], blo[3]);
          mma_tf32_1688(t1, a, bhi[2], bhi[3]);
        }
        add_c(dpt[2 * np], t0);
        add_c(dpt[2 * np + 1], t1);
      }
    }

    // dS^T = P^T (dP^T - delta), in place of P^T
#pragma unroll
    for (int nt = 0; nt < kQT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        st[nt][i] *= dpt[nt][i] - dt_s[nt * 8 + 2 * tq + (i & 1)];
    if (kFused) {
      // dS [q][key] for dQ_part = dS K, each 8 keys in the k order of
      // load_b_f32_trans (key 2j at column j, 2j + 1 at j + 4), so that
      // load_a_f32 reads dS's A fragments in that order
      float* dst = ds_s + 16 * warp + (gq >> 1) + 4 * (gq & 1);
#pragma unroll
      for (int nt = 0; nt < kQT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dst[(nt * 8 + 2 * tq + (i & 1)) * kDsLD + 8 * (i >> 1)] = st[nt][i];
    }

    // dK += dS^T Q (Q scaled by scale * log2(e))
    mma_tf32_kn<kDTiles, kQT>(
        dk_acc, [&](int kk, float (&a)[4]) { a_from_c(a, st[kk]); }, qt_s,
        LD, col0, lane);

    if (kFused) {
      __syncthreads();  // every warp's dS rows are in ds_s
      // dQ_part = dS K: warp w takes q rows 16 (w % kMT) .. + 15 and head
      // columns (w / kMT) kDqSpan .., kDqCols at a time
      const int m0 = 16 * (warp % kMT);
      const int c0 = col0 + (warp / kMT) * kDqSpan;
#pragma unroll 1
      for (int n0 = c0; n0 < c0 + kDqSpan; n0 += kDqCols) {
        float acc[kDqCols / 8][4];
#pragma unroll
        for (int nt = 0; nt < kDqCols / 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
        mma_tf32_kn<kDqCols / 8, kB / 8>(
            acc,
            [&](int kk, float (&a)[4]) {
              uint32_t u[4];
              load_a_f32(u, ds_s, kDsLD, m0, 8 * kk, lane);
#pragma unroll
              for (int e = 0; e < 4; ++e) a[e] = __uint_as_float(u[e]);
            },
            k_s, LD, n0, lane);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = q0 + m0 + gq + 8 * hr;
          if (i >= sq) continue;
          float* dst =
              dq_acc + qoff + static_cast<int64_t>(i) * tok + n0 + 2 * tq;
#pragma unroll
          for (int nt = 0; nt < kDqCols / 8; ++nt)
            add2(dst + nt * 8, acc[nt][2 * hr] * scale,
                 acc[nt][2 * hr + 1] * scale);
        }
      }
    }
  }

  // dk was accumulated against q * scale * log2(e): divide the log2(e) out
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (kj[hr] >= sk) continue;
    const int64_t row =
        koff + static_cast<int64_t>(kj[hr]) * tok + col0 + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt) {
      store2(dk + row + nt * 8, dk_acc[nt][2 * hr] / kLog2e,
             dk_acc[nt][2 * hr + 1] / kLog2e);
      store2(dv + row + nt * 8, dv_acc[nt][2 * hr], dv_acc[nt][2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma kernels: kernels 1 and 3 and the dk/dv template (kernels 2, 4) on
// bf16 q/k/v at head dims 64 and 128 (wgmma_bf16.cuh)
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;                 // a warpgroup
constexpr int kWgmmaThreads = 3 * kWgThreads;   // two consumers, a producer
constexpr int kConsumerWarps = 8;
// registers a thread after setmaxnreg: 2 x 128 x 224 + 128 x 56 = 64512
// of the SM's 65536
constexpr int kConsumerRegs = 224;
constexpr int kProducerRegs = 56;

// threadIdx.x / 128, which the compiler sees to be the same across a warp
// (so that setmaxnreg's branches are warp-uniform to it)
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);
}

// the head dims the wgmma kernels take (bf16 q/k/v)
template <int HD, typename TQ, typename TV>
__host__ __device__ constexpr bool wgmma_route() {
  return (HD == 64 || HD == 128) && std::is_same<TQ, bf16>::value &&
         std::is_same<TV, bf16>::value;
}

// TMA boxes of rows [row0, row0 + rows) of head h of batch b into a
// swizzled [rows][HD] tile at dst (HD / 64 column halves)
template <int HD>
__device__ __forceinline__ void tma_tile(uint8_t* dst, int rows,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int row0, int h,
                                         int b) {
#pragma unroll
  for (int half = 0; half < HD / 64; ++half)
#pragma unroll
    for (int r = 0; r < rows; r += kBoxRows)
      tma_load_4d(dst + (half * rows + r) * kSwizzleBytes, map, bar,
                  64 * half, h, row0 + r, b);
}

// q * scale * log2(e) rounded to bf16, in place, for the 16-byte chunks
// first, first + step, ... below n of a swizzled tile (elementwise, so the
// swizzle does not matter)
__device__ __forceinline__ void scale_chunks(uint8_t* tile, int first,
                                             int n, int step, float mul) {
  for (int e = first; e < n; e += step) {
    uint4* p = reinterpret_cast<uint4*>(tile) + e;
    uint4 u = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      w[i] = pack_bf16(f.x * mul, f.y * mul);
    }
    *p = u;
  }
}

// the bf16 pairs of accumulator d as the A operand of k-step kk of the
// next product (columns 16 kk .. of d become that product's k)
template <int N>
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4],
                                           const float (&d)[N], int kk) {
  a[0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

template <int HD>
struct FwdWgmma {
  static constexpr int kBM = 128;  // q rows a block, 64 a consumer group
  static constexpr int kBN = 128;  // keys a KV tile
  static constexpr int kStages = HD == 64 ? 3 : 2;
  static constexpr int kQ = kBM * HD * 2;   // bytes of the Q tile
  static constexpr int kKV = kBN * HD * 2;  // of a K or a V tile
  // Q, the K and V ring, q_full + full and empty a stage, alignment
  static constexpr int kSmem =
      kQ + 2 * kStages * kKV + (1 + 2 * kStages) * 8 + kSwizzleAtom;
};

// Kernel 1 on bf16 q/k/v at head dims 64 and 128.  One block per (batch *
// head, 128-row q tile), longest rows first: warpgroups 0 and 1 consume,
// each owning 64 q rows (warp w of a group rows 16w ..), warpgroup 2
// produces.  The producer's first thread loads Q once and streams the
// K and V tiles (128 keys) by TMA into a ring of kStages stages, each with
// a "full" mbarrier (the TMA bytes) and an "empty" one (the 8 consumer
// warps); the rest of its group only gives its registers up.  A consumer
// group rounds its Q rows to bf16 after scaling them by scale * log2(e)
// (the reference's :274) in place, then per KV tile: S = Q K^T (wgmma,
// both operands K-major in shared memory), the mask only where the tile
// crosses the diagonal or an edge or segments are given, the online
// softmax in base 2 on the accumulator registers (a row over the 4 lanes
// of a quad: two shuffles), P rounded to bf16 (v's type, :249) into
// wgmma's register A operand, O += P V with V MN-major (the transpose
// bit), and the stage released.  Tiles wholly above a group's part of the
// diagonal are waited for and released without products.
template <int HD>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       bf16* __restrict__ out, float* __restrict__ lse,
                       const int* __restrict__ q_seg,
                       const int* __restrict__ kv_seg, int sq, int sk,
                       int nh, float scale_log2, int causal, int offset) {
  using C = FwdWgmma<HD>;
  constexpr int kBM = C::kBM, kBN = C::kBN, kStages = C::kStages;
  extern __shared__ __align__(128) uint8_t smem_fwd_wg[];
  uint8_t* q_s = align_atom(smem_fwd_wg);
  uint8_t* k_s = q_s + C::kQ;
  uint8_t* v_s = k_s + kStages * C::kKV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * C::kKV);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest rows first
  const int b = blockIdx.y / nh;
  const int h = blockIdx.y % nh;
  const int n_kv = kv_tiles_for(q0, sq, sk, causal, offset, kBN, kBM);
  const int wg = warpgroup_index();
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer
    warpgroup_reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 2 * kWgThreads && n_kv > 0) {
      mbar_arrive_expect_tx(q_full, C::kQ);
      tma_tile<HD>(q_s, kBM, &tm_q, q_full, q0, h, b);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * C::kKV);
        tma_tile<HD>(k_s + s * C::kKV, kBN, &tm_k, &full[s], t * kBN, h, b);
        tma_tile<HD>(v_s + s * C::kKV, kBN, &tm_v, &full[s], t * kBN, h, b);
      }
    }
  } else {
    // consumers
    warpgroup_reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int gq = lane >> 2;
    const int tq = lane & 3;
    const int row0 = q0 + 64 * wg;  // the group's first q row
    const int64_t tok = static_cast<int64_t>(nh) * HD;
    const int* ksb = kv_seg != nullptr ? kv_seg + static_cast<int64_t>(b) * sk
                                       : nullptr;
    // the lane's two rows
    int rows[2], qsg[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rows[hr] = row0 + 16 * warp + gq + 8 * hr;
      qsg[hr] = (q_seg != nullptr && rows[hr] < sq)
                    ? q_seg[static_cast<int64_t>(b) * sq + rows[hr]] : 0;
    }
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this lane's share of the row sums

    if (n_kv > 0) {
      mbar_wait(q_full, 0);
#pragma unroll
      for (int half = 0; half < HD / 64; ++half)
        scale_chunks(q_s + (half * kBM + 64 * wg) * kSwizzleBytes, tid,
                     64 * 8, kWgThreads, scale_log2);
      fence_proxy_async();
      named_bar_sync(1 + wg, kWgThreads);
    }

    for (int t = 0; t < n_kv; ++t) {
      const int s = t % kStages;
      mbar_wait(&full[s], (t / kStages) & 1);
      const int k0 = t * kBN;
      if (row0 < sq && !(causal && k0 > row0 + 63 + offset)) {
        const uint32_t q_sa = smem_addr(q_s);
        const uint32_t kt = smem_addr(k_s + s * C::kKV);
        const uint32_t vt = smem_addr(v_s + s * C::kKV);
        float sc[kBN / 2];
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<kBN, 0, 0>(sc, desc_k_major(q_sa, kBM, 64 * wg, kk),
                              desc_k_major(kt, kBN, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        if (ksb != nullptr || k0 + kBN > sk ||
            (causal && k0 + kBN - 1 > row0 + offset)) {
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int col = k0 + 8 * j + 2 * tq + (i & 1);
              bool ok = col < sk;
              if (causal) ok = ok && col <= rows[i >> 1] + offset;
              if (ksb != nullptr) ok = ok && qsg[i >> 1] == ksb[col];
              sc[4 * j + i] = ok ? sc[4 * j + i] : -INFINITY;
            }
        }

        float alpha[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float mx = m[hr];
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j)
            mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          // a row that has seen no key yet keeps m = -inf, p = 0, alpha = 0
          const float m_use = mx == -INFINITY ? 0.f : mx;
          alpha[hr] = exp2f(m[hr] - m_use);
          m[hr] = mx;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j) {
            sc[4 * j + 2 * hr] = exp2f(sc[4 * j + 2 * hr] - m_use);
            sc[4 * j + 2 * hr + 1] = exp2f(sc[4 * j + 2 * hr + 1] - m_use);
            sum += sc[4 * j + 2 * hr] + sc[4 * j + 2 * hr + 1];
          }
          l[hr] = l[hr] * alpha[hr] + sum;
        }
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
        uint32_t p[kBN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) a_from_acc(p[kk], sc, kk);
        wgmma_fence();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_rs<HD, 1>(o, p[kk], desc_mn_major(vt, kBN, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float lsum = l[hr];
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      const int row = rows[hr];
      if (row >= sq) continue;
      const bool no_key = lsum == 0.f;
      const float inv = no_key ? 0.f : 1.f / lsum;
      bf16* dst = out + (static_cast<int64_t>(b) * sq + row) * tok + h * HD +
                  2 * tq;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        store2(dst + 8 * j, o[4 * j + 2 * hr] * inv,
               o[4 * j + 2 * hr + 1] * inv);
      if (tq == 0)
        lse[(static_cast<int64_t>(b) * nh + h) * sq + row] =
            no_key ? -INFINITY : (m[hr] + log2f(lsum)) * kLn2;
    }
  }
}

template <int HD, bool kFused>
struct DkvWgmma {
  static constexpr int kBN = 128;  // keys a block, 64 a consumer group
  static constexpr int kBM = 64;   // q rows a tile
  static constexpr int kStages = 2;
  // q rows a chunk of S^T and dP^T: the whole tile, but 32 in the fused
  // kernel at d 128, whose dP^T takes two more accumulators (each
  // k-step's product apart) beside the 128 registers of dK and dV
  static constexpr int kQC = HD == 128 && kFused ? 32 : 64;
  static constexpr int kKV = kBN * HD * 2;     // bytes of K or of V
  static constexpr int kQT = kBM * HD * 2;     // of a Q, dO or O tile
  static constexpr int kTiles = kFused ? 3 : 2;  // Q, dO (and O) a stage
  static constexpr int kDs = kBN * kBM * 2;    // a dS^T buffer (fused)
  static constexpr int kRowVals = 3 * kBM * 4;  // lse2, delta, q ids
  // delta in fp64 a stage (fused)
  static constexpr int kDelta64 = kFused ? kBM * 8 : 0;
  // K, V; the stages' tiles; two dS^T buffers; the stages' row values and
  // fp64 delta; kv_full, then full, ready and empty a stage; alignment
  static constexpr int kSmem =
      2 * kKV + kStages * kTiles * kQT + (kFused ? 2 * kDs : 0) +
      kStages * (kRowVals + kDelta64) + (1 + 3 * kStages) * 8 + kSwizzleAtom;
};

// The dk/dv template (kernel 4, and kernel 2 with kFused) on bf16 q/k/v at
// head dims 64 and 128.  One block per (batch * head, 128-key tile):
// warpgroups 0 and 1 consume, each owning 64 keys (warp w of a group keys
// 16w ..) and their dK and dV accumulators in registers; warpgroup 2
// produces.  Its first warp loads K and V once and streams the q tiles
// that see the block's keys (64 rows: Q, dO, and O with kFused) by TMA into
// a ring of kStages stages, its lanes writing each tile's lse (base 2,
// +inf where a row sees no key or lies past sq, so that p = 0 there),
// delta (split) and q ids beside it; its other three warps wait for each
// tile, scale Q by scale * log2(e) and round it to bf16 in place (the
// reference's :405), with kFused compute delta = rowsum(dO * O) in fp64
// from the tiles, and release the tile to the consumers ("ready").  Per q
// tile a consumer group, all products on wgmma: S^T = K Q^T and dP^T =
// V dO^T (both operands K-major); P^T = exp2(S^T - lse2), masked only
// where the tile crosses the diagonal or an edge or segments are given,
// rounded to bf16 (do's type, :377); dS^T = P^T (dP^T - delta) in fp32,
// rounded to bf16 (q's type, :383); dV += P^T dO and dK += dS^T Q with P^T
// and dS^T as register A operands and dO, Q MN-major.  With kFused each
// group stores its dS^T rows (swizzled) in one of two buffers, fences the
// async proxy and meets the other group; then dQ_part = dS K over all 128
// keys, each group half of the head columns (dS MN-major from the buffer,
// K MN-major), is added into the fp32 dq_acc with 8-byte atomics.  dK is
// divided by log2(e) and dQ multiplied by scale.
template <int HD, bool kFused>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq_acc, bf16* __restrict__ dk,
                           bf16* __restrict__ dv,
                           const int* __restrict__ q_seg,
                           const int* __restrict__ kv_seg, int sq, int sk,
                           int nh, float scale, int causal, int offset) {
  using C = DkvWgmma<HD, kFused>;
  constexpr int kBN = C::kBN, kBM = C::kBM, kStages = C::kStages;
  constexpr int kQT = C::kQT;
  constexpr int kQC = C::kQC;
  extern __shared__ __align__(128) uint8_t smem_dkv_wg[];
  uint8_t* k_s = align_atom(smem_dkv_wg);
  uint8_t* v_s = k_s + C::kKV;
  uint8_t* st_s = v_s + C::kKV;  // stage s: Q, dO (, O) at s * kTiles * kQT
  uint8_t* ds_s = st_s + kStages * C::kTiles * kQT;  // [2][128 keys][64 q]
  float* rv_s = reinterpret_cast<float*>(ds_s + (kFused ? 2 * C::kDs : 0));
  double* dl64_s = reinterpret_cast<double*>(rv_s + kStages * 3 * kBM);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(dl64_s) + kStages * C::kDelta64);
  uint64_t* full = kv_full + 1;
  uint64_t* ready = full + kStages;
  uint64_t* empty = ready + kStages;

  const int k0 = blockIdx.x * kBN;
  const int b = blockIdx.y / nh;
  const int h = blockIdx.y % nh;
  const int first = first_q_tile(k0, causal, offset, kBM) * kBM;
  const int n_q = first < sq ? (sq - first + kBM - 1) / kBM : 0;
  const int wg = warpgroup_index();
  const int tid = threadIdx.x % kWgThreads;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&ready[s], 3 * 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer
    warpgroup_reg_dealloc<kProducerRegs>();
    if (warp == 0) {
      if (n_q > 0 && lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * C::kKV);
        tma_tile<HD>(k_s, kBN, &tm_k, kv_full, k0, h, b);
        tma_tile<HD>(v_s, kBN, &tm_v, kv_full, k0, h, b);
      }
      const float* lseb = lse + (static_cast<int64_t>(b) * nh + h) * sq;
      for (int it = 0; it < n_q; ++it) {
        const int s = it % kStages;
        const int q0 = first + it * kBM;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        float* rv = rv_s + s * 3 * kBM;
        for (int i = lane; i < kBM; i += 32) {
          const int row = q0 + i;
          const bool live = row < sq;
          const float ls = live ? lseb[row] : -INFINITY;
          rv[i] = ls == -INFINITY ? INFINITY : ls * kLog2e;
          if (!kFused)
            rv[kBM + i] = live ? delta[(static_cast<int64_t>(b) * sq + row) *
                                           nh + h]
                               : 0.f;
          if (q_seg != nullptr)
            reinterpret_cast<int*>(rv)[2 * kBM + i] =
                live ? q_seg[static_cast<int64_t>(b) * sq + row] : 0;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], C::kTiles * kQT);
          uint8_t* tile = st_s + s * C::kTiles * kQT;
          tma_tile<HD>(tile, kBM, &tm_q, &full[s], q0, h, b);
          tma_tile<HD>(tile + kQT, kBM, &tm_do, &full[s], q0, h, b);
          if (kFused)
            tma_tile<HD>(tile + 2 * kQT, kBM, &tm_o, &full[s], q0, h, b);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    } else {
      // warps 1-3: scale Q (and with kFused compute delta) a tile at a time
      const int t = tid - 32;  // 0 .. 95
      for (int it = 0; it < n_q; ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        uint8_t* tile = st_s + s * C::kTiles * kQT;
        scale_chunks(tile, t, kQT / 16, 3 * 32, scale * kLog2e);
        if (kFused && t < kBM) {
          // row t's 16-byte chunks of dO and O sit at the same places in
          // both swizzled tiles
          // four partial sums, so that the fp64 adds do not wait on
          // each other
          double part[4] = {0., 0., 0., 0.};
#pragma unroll 2
          for (int c = 0; c < HD / 8; ++c) {
            const int off = ((c / 8) * kBM + t) * kSwizzleBytes + (c % 8) * 16;
            const uint4 du = *reinterpret_cast<const uint4*>(tile + kQT + off);
            const uint4 ou =
                *reinterpret_cast<const uint4*>(tile + 2 * kQT + off);
            const uint32_t* dw = reinterpret_cast<const uint32_t*>(&du);
            const uint32_t* ow = reinterpret_cast<const uint32_t*>(&ou);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 a = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&dw[j]));
              const float2 c2 = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&ow[j]));
              part[j] += static_cast<double>(a.x) * c2.x +
                         static_cast<double>(a.y) * c2.y;
            }
          }
          dl64_s[s * kBM + t] = (part[0] + part[1]) + (part[2] + part[3]);
        }
        fence_proxy_async();
        mbar_arrive(&ready[s]);
      }
    }
  } else {
    // consumers
    warpgroup_reg_alloc<kConsumerRegs>();
    const int gq = lane >> 2;
    const int tq = lane & 3;
    const int kw0 = k0 + 64 * wg;  // the group's first key
    const int64_t tok = static_cast<int64_t>(nh) * HD;
    const int64_t qoff = static_cast<int64_t>(b) * sq * tok + h * HD;
    const int64_t koff = static_cast<int64_t>(b) * sk * tok + h * HD;
    // the lane's two keys
    int kj[2], ksg[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      kj[hr] = kw0 + 16 * warp + gq + 8 * hr;
      ksg[hr] = (kv_seg != nullptr && kj[hr] < sk)
                    ? kv_seg[static_cast<int64_t>(b) * sk + kj[hr]] : 0;
    }
    const uint32_t k_sa = smem_addr(k_s);
    const uint32_t v_sa = smem_addr(v_s);
    float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    if (n_q > 0) mbar_wait(kv_full, 0);

    for (int it = 0; it < n_q; ++it) {
      const int s = it % kStages;
      const int q0 = first + it * kBM;
      mbar_wait(&ready[s], (it / kStages) & 1);
      const uint32_t qt = smem_addr(st_s + s * C::kTiles * kQT);
      const uint32_t dot = qt + kQT;
      const float* l2s = rv_s + s * 3 * kBM;
      const float* dls = l2s + kBM;
      const double* dl64 = dl64_s + s * kBM;
      const int* qss = reinterpret_cast<const int*>(l2s + 2 * kBM);
      const bool live = kw0 < sk && !(causal && kw0 > q0 + kBM - 1 + offset);
      const bool masked = q_seg != nullptr || q0 + kBM > sq ||
                          kw0 + 64 > sk || (causal && kw0 + 63 > q0 + offset);
      uint8_t* dsb = ds_s + (it & 1) * C::kDs;
#pragma unroll
      for (int c0 = 0; c0 < kBM; c0 += kQC) {
        uint32_t ds16[kQC / 16][4];
        if (live) {
          float st[kQC / 2], dpt[kQC / 2];
#pragma unroll
          for (int i = 0; i < kQC / 2; ++i) st[i] = dpt[i] = 0.f;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss<kQC, 0, 0>(st, desc_k_major(k_sa, kBN, 64 * wg, kk),
                                desc_k_major(qt, kBM, c0, kk), kk > 0);
          if constexpr (kFused) {
            wgmma_commit();
            // where a q row sees one key, dP^T - delta cancels to the
            // rounding of two sums, which the fused kernel's dq carries
            // into that row: the k-steps' products of dP^T are added in
            // fp32 and delta comes in fp64
            wgmma_ss_sum<kQC, HD / 16>(
                dpt,
                [&](int kk) { return desc_k_major(v_sa, kBN, 64 * wg, kk); },
                [&](int kk) { return desc_k_major(dot, kBM, c0, kk); });
          } else {
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)
              wgmma_ss<kQC, 0, 0>(dpt, desc_k_major(v_sa, kBN, 64 * wg, kk),
                                  desc_k_major(dot, kBM, c0, kk), kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
          }
          fence_regs(st);
          fence_regs(dpt);
#pragma unroll
          for (int j = 0; j < kQC / 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int c = c0 + 8 * j + 2 * tq + (i & 1);  // q row
              bool ok = true;
              if (masked) {
                const int key = kj[i >> 1];
                ok = q0 + c < sq && key < sk;
                if (causal) ok = ok && key <= q0 + c + offset;
                if (q_seg != nullptr) ok = ok && qss[c] == ksg[i >> 1];
              }
              const float p = ok ? exp2f(st[4 * j + i] - l2s[c]) : 0.f;
              st[4 * j + i] = p;
              float dm;
              if constexpr (kFused)
                dm = static_cast<float>(dpt[4 * j + i] - dl64[c]);
              else
                dm = dpt[4 * j + i] - dls[c];
              dpt[4 * j + i] = p * dm;
            }
          uint32_t p16[kQC / 16][4];
#pragma unroll
          for (int kk = 0; kk < kQC / 16; ++kk) {
            a_from_acc(p16[kk], st, kk);
            a_from_acc(ds16[kk], dpt, kk);
          }
          wgmma_fence();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
#pragma unroll
          for (int kk = 0; kk < kQC / 16; ++kk)
            wgmma_rs<HD, 1>(dv_acc, p16[kk],
                            desc_mn_major(dot, kBM, c0 / 16 + kk), 1);
#pragma unroll
          for (int kk = 0; kk < kQC / 16; ++kk)
            wgmma_rs<HD, 1>(dk_acc, ds16[kk],
                            desc_mn_major(qt, kBM, c0 / 16 + kk), 1);
          wgmma_commit();
          // the fused kernel's registers hold no second chunk in flight
          if constexpr (kFused) wgmma_wait<0>();
        } else {
#pragma unroll
          for (int kk = 0; kk < kQC / 16; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) ds16[kk][r] = 0u;
        }
        if constexpr (kFused) {
          // this group's dS^T rows (keys 64 wg ..) into buffer it % 2,
          // swizzled as TMA would write a [128][64] bf16 tile
#pragma unroll
          for (int j = 0; j < kQC / 8; ++j)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int kr = 64 * wg + 16 * warp + gq + 8 * hr;
              const int cb = (c0 + 8 * j + 2 * tq) * 2;  // the q column
              *reinterpret_cast<uint32_t*>(
                  dsb + kr * kSwizzleBytes + (((cb >> 4) ^ (kr & 7)) << 4) +
                  (cb & 15)) = ds16[j >> 1][(j & 1) * 2 + hr];
            }
        }
      }

      float dq[HD / 4];
      if constexpr (kFused) {
        fence_proxy_async();
        named_bar_sync(1, 2 * kWgThreads);
#pragma unroll
        for (int i = 0; i < HD / 4; ++i) dq[i] = 0.f;
        wgmma_fence();
        // the group's head columns: a column half at d 128, 32 columns of
        // the one half at d 64
        const int col = HD == 128 ? wg * kBN * kSwizzleBytes : wg * 64;
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_ss<HD / 2, 1, 1>(dq, desc_mn_major(smem_addr(dsb), kBN, kk),
                                 desc_mn_major(k_sa, kBN, kk, col), kk > 0);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      if (lane == 0) mbar_arrive(&empty[s]);
      if constexpr (kFused) {
        fence_regs(dq);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = q0 + 16 * warp + gq + 8 * hr;
          if (i >= sq) continue;
          float* dst = dq_acc + qoff + static_cast<int64_t>(i) * tok +
                       wg * (HD / 2) + 2 * tq;
#pragma unroll
          for (int j = 0; j < HD / 16; ++j)
            add2(dst + 8 * j, dq[4 * j + 2 * hr] * scale,
                 dq[4 * j + 2 * hr + 1] * scale);
        }
      }
    }

    // dk was accumulated against q * scale * log2(e): divide the log2(e) out
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (kj[hr] >= sk) continue;
      const int64_t row = koff + static_cast<int64_t>(kj[hr]) * tok + 2 * tq;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        store2(dk + row + 8 * j, dk_acc[4 * j + 2 * hr] / kLog2e,
               dk_acc[4 * j + 2 * hr + 1] / kLog2e);
        store2(dv + row + 8 * j, dv_acc[4 * j + 2 * hr],
               dv_acc[4 * j + 2 * hr + 1]);
      }
    }
  }
}

template <int HD>
struct DqWgmma {
  static constexpr int kBM = 128;  // q rows a block, 64 a consumer group
  static constexpr int kBN = 128;  // keys a KV stage
  // keys a chunk of S and dP: S and dP's two chains take 32 registers each,
  // the dS operand of the dQ product in flight 16, beside dQ's HD / 2
  static constexpr int kKC = 64;
  static constexpr int kStages = HD == 64 ? 3 : 2;
  static constexpr int kQ = kBM * HD * 2;   // bytes of the Q or the dO tile
  static constexpr int kKV = kBN * HD * 2;  // of a K or a V stage
  // Q, dO, the K and V ring, q_full + full and empty a stage, alignment
  static constexpr int kSmem =
      2 * kQ + 2 * kStages * kKV + (1 + 2 * kStages) * 8 + kSwizzleAtom;
};

// Kernel 3, dq of the split backward, on bf16 q/k/v at head dims 64 and
// 128; replaces hetu_tpu/ops/pallas/flash_attention.py:466 `_bwd_dq_kernel`
// (`_flash_bwd_split`, :560).  Bound by operations: three products per
// visible (query, key) pair, S = Q K^T, dP = dO V^T and dQ = dS K, 0.417 ms
// on the bf16 tensor cores at the Llama-3-8B training shape (b 2, s 4096,
// h 32, d 128, causal), against about 0.3 GB of q/k/v/do/dq traffic.
// The forward's shape (flash_fwd_wgmma_kernel): one block per (batch *
// head, 128-row q tile), longest rows first; warpgroups 0 and 1 consume,
// each owning 64 q rows and their dQ accumulator in registers, warpgroup 2
// produces.  Its first thread loads Q and dO once and streams the K and V
// tiles (128 keys) by TMA into a ring of kStages stages ("full" and
// "empty" mbarriers), up to the tile's last visible key; the rest of its
// group only gives its registers up, so that no consumer spends registers
// or instructions on addresses, and a K/V tile is read from L2 once per
// 128 q rows.  A consumer group scales its Q rows by scale * log2(e) and
// rounds them to bf16 in place (the reference's :564), reads its rows'
// lse (base 2, +inf where a row sees no key or lies past sq, so that p = 0
// there), delta and q ids once, then per 64-key chunk of a stage: S = Q
// K^T and dP = dO V^T (wgmma, all operands K-major), issued together;
// P = exp2(S - lse2), masked only where the chunk crosses the diagonal or
// an edge or segments are given; dS = P (dP - delta) in fp32, rounded to
// bf16 (q's type, :502) into wgmma's register A operand; dQ += dS K with K
// MN-major (the transpose bit), as the forward's O += P V.  The dQ product
// stays in flight behind the next chunk's S and dP, so that a chunk costs
// one wait, and a stage is released once that wait has passed.  A query
// row that sees one key has dS = 0 exactly, where dP - delta cancels to
// the rounding of the two sums: one wgmma chain over the head dim keeps
// too few bits for that, so dP - delta is two chains over alternate
// k-steps, the first started at -delta, added in fp32.  Chunks wholly
// above the group's part of the diagonal or past sk are skipped.  dQ is
// multiplied by scale and stored in bf16; rows that see no key get dq = 0
// exactly.  A chunk of 64 keys keeps S, both dP chains and the dS operand
// in flight beside the 64 dQ registers of d 128 under the consumers'
// setmaxnreg budget without spills.
template <int HD>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq,
                          const int* __restrict__ q_seg,
                          const int* __restrict__ kv_seg, int sq, int sk,
                          int nh, float scale, int causal, int offset) {
  using C = DqWgmma<HD>;
  constexpr int kBM = C::kBM, kBN = C::kBN, kKC = C::kKC;
  constexpr int kStages = C::kStages;
  extern __shared__ __align__(128) uint8_t smem_dq_wg[];
  uint8_t* q_s = align_atom(smem_dq_wg);
  uint8_t* do_s = q_s + C::kQ;
  uint8_t* k_s = do_s + C::kQ;
  uint8_t* v_s = k_s + kStages * C::kKV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * C::kKV);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest rows first
  const int b = blockIdx.y / nh;
  const int h = blockIdx.y % nh;
  const int n_kv = kv_tiles_for(q0, sq, sk, causal, offset, kBN, kBM);
  const int wg = warpgroup_index();
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer
    warpgroup_reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 2 * kWgThreads && n_kv > 0) {
      mbar_arrive_expect_tx(q_full, 2 * C::kQ);
      tma_tile<HD>(q_s, kBM, &tm_q, q_full, q0, h, b);
      tma_tile<HD>(do_s, kBM, &tm_do, q_full, q0, h, b);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * C::kKV);
        tma_tile<HD>(k_s + s * C::kKV, kBN, &tm_k, &full[s], t * kBN, h, b);
        tma_tile<HD>(v_s + s * C::kKV, kBN, &tm_v, &full[s], t * kBN, h, b);
      }
    }
  } else {
    // consumers
    warpgroup_reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int gq = lane >> 2;
    const int tq = lane & 3;
    const int row0 = q0 + 64 * wg;  // the group's first q row
    const int64_t tok = static_cast<int64_t>(nh) * HD;
    const int* ksb = kv_seg != nullptr ? kv_seg + static_cast<int64_t>(b) * sk
                                       : nullptr;
    // the lane's two rows: lse in base 2, delta and q ids
    int rows[2], qsg[2];
    float l2[2], dlt[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 16 * warp + gq + 8 * hr;
      const bool live = row < sq;
      const float ls =
          live ? lse[(static_cast<int64_t>(b) * nh + h) * sq + row] : -INFINITY;
      rows[hr] = row;
      l2[hr] = ls == -INFINITY ? INFINITY : ls * kLog2e;
      dlt[hr] = live ? delta[(static_cast<int64_t>(b) * sq + row) * nh + h]
                     : 0.f;
      qsg[hr] = (q_seg != nullptr && live)
                    ? q_seg[static_cast<int64_t>(b) * sq + row] : 0;
    }
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    if (n_kv > 0) {
      mbar_wait(q_full, 0);
#pragma unroll
      for (int half = 0; half < HD / 64; ++half)
        scale_chunks(q_s + (half * kBM + 64 * wg) * kSwizzleBytes, tid,
                     64 * 8, kWgThreads, scale * kLog2e);
      fence_proxy_async();
      named_bar_sync(1 + wg, kWgThreads);
    }
    const uint32_t q_sa = smem_addr(q_s);
    const uint32_t do_sa = smem_addr(do_s);
    // dS of the chunk whose dQ product is in flight (wgmma reads its
    // register A operand until the next wait), and the stage that product
    // reads, or -1
    uint32_t ds16[kKC / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) ds16[kk][r] = 0u;
    int pending = -1;

    for (int t = 0; t < n_kv; ++t) {
      const int s = t % kStages;
      mbar_wait(&full[s], (t / kStages) & 1);
      const int k0 = t * kBN;
      // causal tiles past the group's part of the diagonal come last
      if (row0 >= sq || (causal && k0 > row0 + 63 + offset)) {
        if (pending >= 0) {
          wgmma_wait<0>();
          fence_regs(ds16);
          fence_regs(acc);
          if (lane == 0) mbar_arrive(&empty[pending]);
          pending = -1;
        }
        if (lane == 0) mbar_arrive(&empty[s]);
        continue;
      }
      const uint32_t kt = smem_addr(k_s + s * C::kKV);
      const uint32_t vt = smem_addr(v_s + s * C::kKV);
#pragma unroll
      for (int c0 = 0; c0 < kBN; c0 += kKC) {
        const int j0 = k0 + c0;
        if (j0 >= sk || (causal && j0 > row0 + 63 + offset)) continue;
        // S = Q K^T; dP - delta = dO V^T - delta in two chains of wgmma
        // over alternate k-steps, the first started at -delta, added in
        // fp32
        float sc[kKC / 2], dp[2][kKC / 2];
#pragma unroll
        for (int i = 0; i < kKC / 2; ++i) {
          sc[i] = 0.f;
          dp[0][i] = -dlt[(i >> 1) & 1];
          dp[1][i] = 0.f;
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<kKC, 0, 0>(sc, desc_k_major(q_sa, kBM, 64 * wg, kk),
                              desc_k_major(kt, kBN, c0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<kKC, 0, 0>(dp[kk & 1],
                              desc_k_major(do_sa, kBM, 64 * wg, kk),
                              desc_k_major(vt, kBN, c0, kk), 1);
        wgmma_commit();
        // also completes the previous chunk's dQ product
        wgmma_wait<0>();
        fence_regs(ds16);
        fence_regs(acc);
        fence_regs(sc);
        fence_regs(dp[0]);
        fence_regs(dp[1]);
        if (pending >= 0 && pending != s) {
          if (lane == 0) mbar_arrive(&empty[pending]);
        }

        // S = -inf where masked, then, without a branch, dS = P (dP -
        // delta) with P = exp2(S - lse2)
        if (ksb != nullptr || j0 + kKC > sk ||
            (causal && j0 + kKC - 1 > row0 + offset)) {
#pragma unroll
          for (int j = 0; j < kKC / 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int col = j0 + 8 * j + 2 * tq + (i & 1);
              bool ok = col < sk;
              if (causal) ok = ok && col <= rows[i >> 1] + offset;
              if (ksb != nullptr) ok = ok && qsg[i >> 1] == ksb[col];
              if (!ok) sc[4 * j + i] = -INFINITY;
            }
        }
#pragma unroll
        for (int i = 0; i < kKC / 2; ++i)
          dp[0][i] = exp2_ftz(sc[i] - l2[(i >> 1) & 1]) * (dp[0][i] + dp[1][i]);
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk) a_from_acc(ds16[kk], dp[0], kk);
        // dQ += dS K, left in flight behind the next chunk's S and dP
        wgmma_fence();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk)
          wgmma_rs<HD, 1>(acc, ds16[kk], desc_mn_major(kt, kBN, c0 / 16 + kk),
                          1);
        wgmma_commit();
        pending = s;
      }
    }
    if (pending >= 0) {
      wgmma_wait<0>();
      fence_regs(ds16);
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[pending]);
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = rows[hr];
      if (row >= sq) continue;
      bf16* dst = dq + (static_cast<int64_t>(b) * sq + row) * tok + h * HD +
                  2 * tq;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        store2(dst + 8 * j, acc[4 * j + 2 * hr] * scale,
               acc[4 * j + 2 * hr + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
struct Tag {
  using type = T;
};

// The C entries, as hetu_flash_uses_tensor_cores numbers them, and the
// routes their kernels take: bf16 q/k/v run every entry on wgmma at head
// dims 64 and 128 and on bf16 mma.sync at 32 and 256; fp32 q/k (fp32 or
// bf16 v) every entry in 3xTF32 (the mixed forward's P.V on bf16
// mma.sync).
constexpr int kEntryFwd = 0, kEntryDq = 1, kEntryDkv = 2;
constexpr int kRouteCudaCores = 0, kRouteBf16 = 1, kRouteTf32 = 2,
              kRouteWgmma = 3;

// the tensor maps of the wgmma kernels' bf16 [b, s, h, HD] operands
template <int HD>
cudaError_t encode_maps(std::initializer_list<std::pair<CUtensorMap*,
                                                        const void*>> q_side,
                        std::initializer_list<std::pair<CUtensorMap*,
                                                        const void*>> kv_side,
                        int b, int sq, int sk, int nh) {
  for (const auto& m : q_side) {
    const cudaError_t err = encode_bshd(m.first, m.second, b, sq, nh, HD);
    if (err != cudaSuccess) return err;
  }
  for (const auto& m : kv_side) {
    const cudaError_t err = encode_bshd(m.first, m.second, b, sk, nh, HD);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int HD>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v,
                             void* out, void* lse, const void* q_seg,
                             const void* kv_seg, int b, int sq, int sk,
                             int nh, float scale_log2, int causal,
                             int offset, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_maps<HD>({{&tq, q}}, {{&tk, k}, {&tv, v}}, b, sq,
                                    sk, nh);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_wgmma_kernel<HD>;
  constexpr int smem = FwdWgmma<HD>::kSmem;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int kBM = FwdWgmma<HD>::kBM;
  const dim3 grid((sq + kBM - 1) / kBM, b * nh);
  kernel<<<grid, kWgmmaThreads, smem, st>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), sq,
      sk, nh, scale_log2, causal, offset);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const void* lse, const void* delta,
                             void* dq_acc, void* dk, void* dv,
                             const void* q_seg, const void* kv_seg, int b,
                             int sq, int sk, int nh, float scale, int causal,
                             int offset, int fused, cudaStream_t st) {
  CUtensorMap tq, tk, tv, to, tdo;
  // the split kernel reads no O: its map repeats dO's
  cudaError_t err = encode_maps<HD>(
      {{&tq, q}, {&tdo, dout}, {&to, fused ? out : dout}},
      {{&tk, k}, {&tv, v}}, b, sq, sk, nh);
  if (err != cudaSuccess) return err;
  auto launch = [&](auto kernel, int smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    constexpr int kBN = DkvWgmma<HD, true>::kBN;
    const dim3 grid((sk + kBN - 1) / kBN, b * nh);
    kernel<<<grid, kWgmmaThreads, smem, st>>>(
        tq, tk, tv, to, tdo, static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dq_acc),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), sq,
        sk, nh, scale, causal, offset);
    return cudaGetLastError();
  };
  if (fused)
    return launch(flash_bwd_dkv_wgmma_kernel<HD, true>,
                  DkvWgmma<HD, true>::kSmem);
  return launch(flash_bwd_dkv_wgmma_kernel<HD, false>,
                DkvWgmma<HD, false>::kSmem);
}

template <int HD>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, const void* q_seg,
                            const void* kv_seg, int b, int sq, int sk, int nh,
                            float scale, int causal, int offset,
                            cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_maps<HD>({{&tq, q}, {&tdo, dout}},
                                    {{&tk, k}, {&tv, v}}, b, sq, sk, nh);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_wgmma_kernel<HD>;
  constexpr int smem = DqWgmma<HD>::kSmem;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int kBM = DqWgmma<HD>::kBM;
  const dim3 grid((sq + kBM - 1) / kBM, b * nh);
  kernel<<<grid, kWgmmaThreads, smem, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), sq,
      sk, nh, scale, causal, offset);
  return cudaGetLastError();
}

// Calls f(int_constant<HD>, Tag<TQ>, Tag<TV>) for the supported head dims and
// type codes (0: all fp32, 1: all bf16, 2: fp32 q/k with bf16 v).
template <typename F>
cudaError_t dispatch(int head_dim, int dtypes, F&& f) {
  using I32 = std::integral_constant<int, 32>;
  using I64 = std::integral_constant<int, 64>;
  using I128 = std::integral_constant<int, 128>;
  using I256 = std::integral_constant<int, 256>;
  using F32 = Tag<float>;
  using B16 = Tag<__nv_bfloat16>;
  if (head_dim == 32) {
    if (dtypes == 0) return f(I32{}, F32{}, F32{});
    if (dtypes == 1) return f(I32{}, B16{}, B16{});
    if (dtypes == 2) return f(I32{}, F32{}, B16{});
  } else if (head_dim == 64) {
    if (dtypes == 0) return f(I64{}, F32{}, F32{});
    if (dtypes == 1) return f(I64{}, B16{}, B16{});
    if (dtypes == 2) return f(I64{}, F32{}, B16{});
  } else if (head_dim == 128) {
    if (dtypes == 0) return f(I128{}, F32{}, F32{});
    if (dtypes == 1) return f(I128{}, B16{}, B16{});
    if (dtypes == 2) return f(I128{}, F32{}, B16{});
  } else if (head_dim == 256) {
    if (dtypes == 0) return f(I256{}, F32{}, F32{});
    if (dtypes == 1) return f(I256{}, B16{}, B16{});
    if (dtypes == 2) return f(I256{}, F32{}, B16{});
  }
  return cudaErrorInvalidValue;
}

bool bad_shape(int b, int sq, int sk, int nh) {
  return b < 1 || sq < 1 || sk < 1 || nh < 1 ||
         static_cast<int64_t>(b) * nh > 65535;
}

// Calls g(kernel, threads, dynamic shared memory bytes) with the dk/dv
// template that hetu_flash_bwd_dkv launches for these types (`fused` picks
// kernel 2 over 4).
template <int HD, typename TQ, typename TV, typename G>
cudaError_t with_dkv_kernel(int fused, G&& g) {
  if constexpr (wgmma_route<HD, TQ, TV>()) {
    if (fused)
      return g(flash_bwd_dkv_wgmma_kernel<HD, true>, kWgmmaThreads,
               DkvWgmma<HD, true>::kSmem);
    return g(flash_bwd_dkv_wgmma_kernel<HD, false>, kWgmmaThreads,
             DkvWgmma<HD, false>::kSmem);
  } else if constexpr (std::is_same<TQ, bf16>::value) {
    if (fused)
      return g(flash_bwd_dkv_mma_kernel<HD, true>, kMmaThreads,
               dkv_mma_smem_bytes<HD, true>());
    return g(flash_bwd_dkv_mma_kernel<HD, false>, kMmaThreads,
             dkv_mma_smem_bytes<HD, false>());
  } else {
    if (fused)
      return g(flash_bwd_dkv_tf32_kernel<HD, TV, true>, kMmaThreads,
               dkv_tf32_smem_bytes<HD, true>());
    return g(flash_bwd_dkv_tf32_kernel<HD, TV, false>, kMmaThreads,
             dkv_tf32_smem_bytes<HD, false>());
  }
}

// ---------------------------------------------------------------------------
// the wide route: head dims above 256, multiples of kColSlice (the wrappers
// zero-pad to one), in every type mix
// ---------------------------------------------------------------------------
//
// Right rather than fast: CUDA-core FMA with fp32 accumulation, the
// reference's roundings (q * scale * log2(e) to q's type, p to v's type
// before p.v and to do's type before p^T.do, ds to q's type).  One warp owns
// one query row (forward, dq) or one key row (dk/dv) with its q and dO (or
// K and V) rows in shared memory in fp32, so that no head dim is too wide
// for a block; S and dP are summed along the whole head dim, 16 bytes at a
// time, by the lane that owns the other side's row (32 keys or queries at a
// time, one a lane), and the block's blockIdx.z picks the kColSlice output
// columns it accumulates, 4 a lane (S and dP are formed again by each
// slice).

constexpr int kWideRows = kMmaThreads / 32;  // rows of a block: one a warp

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

// x rounded to T, as a float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, bf16>::value)
    return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// the 16-byte piece at p (8 bf16 or 4 fp32 values) in fp32
__device__ __forceinline__ void load_piece(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void load_piece(const bf16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// four consecutive values at p (8-byte aligned for bf16, 16 for fp32)
__device__ __forceinline__ void load4(const float* p, float* f) {
  load_piece(p, f);
}

__device__ __forceinline__ void load4(const bf16* p, float* f) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float* f) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

// sum over d of a[d] * row[d]: a in shared memory (fp32, 16-byte aligned),
// row in device memory, 16 bytes at a time
template <typename T>
__device__ __forceinline__ float dot_row(const float* a, const T* row,
                                         int d) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  float s = 0.f;
  for (int c = 0; c < d; c += kPer) {
    float f[kPer];
    load_piece(row + c, f);
#pragma unroll
    for (int i = 0; i < kPer; i += 4) {
      const float4 av = *reinterpret_cast<const float4*>(a + c + i);
      s = fmaf(av.x, f[i], s);
      s = fmaf(av.y, f[i + 1], s);
      s = fmaf(av.z, f[i + 2], s);
      s = fmaf(av.w, f[i + 3], s);
    }
  }
  return s;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Kernel 1 on the wide route: warp w owns q row blockIdx.x * 4 + w.
template <typename TQ, typename TV>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_wide_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                      const TV* __restrict__ v, TQ* __restrict__ out,
                      float* __restrict__ lse, const int* __restrict__ q_seg,
                      const int* __restrict__ kv_seg, int sq, int sk, int nh,
                      int d, float scale_log2, int causal, int offset) {
  extern __shared__ float4 wide_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWideRows + warp;
  if (row >= sq) return;  // the block shares no barrier
  const int b = blockIdx.y / nh;
  const int h = blockIdx.y % nh;
  const int col0 = blockIdx.z * kColSlice + 4 * lane;
  const int64_t tok = static_cast<int64_t>(nh) * d;
  float* q_s = reinterpret_cast<float*>(wide_smem) + warp * d;
  const TQ* qr = q + (static_cast<int64_t>(b) * sq + row) * tok +
                 static_cast<int64_t>(h) * d;
  for (int c = lane; c < d; c += 32)
    q_s[c] = round_to<TQ>(to_float(qr[c]) * scale_log2);
  __syncwarp();
  const TQ* kb = k + static_cast<int64_t>(b) * sk * tok +
                 static_cast<int64_t>(h) * d;
  const TV* vb = v + static_cast<int64_t>(b) * sk * tok +
                 static_cast<int64_t>(h) * d + col0;
  const int qid = q_seg != nullptr ? q_seg[static_cast<int64_t>(b) * sq + row]
                                   : 0;
  const int* ks = kv_seg != nullptr ? kv_seg + static_cast<int64_t>(b) * sk
                                    : nullptr;
  const int kv_end = causal ? min(sk, max(0, row + offset + 1)) : sk;
  float m = -INFINITY, l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < kv_end; j0 += 32) {
    const int j = j0 + lane;
    const bool ok = j < kv_end && (ks == nullptr || ks[j] == qid);
    const float s = ok ? dot_row(q_s, kb + j * tok, d) : -INFINITY;
    const float mx = warp_max(s);
    if (mx == -INFINITY) continue;  // no key of these 32 is visible
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    const float p = ok ? exp2f(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] *= alpha;
    const int n = min(32, kv_end - j0);
    for (int jj = 0; jj < n; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, p, jj);
      if (pj == 0.f) continue;
      const float pr = round_to<TV>(pj);
      float vv[4];
      load4(vb + (j0 + jj) * tok, vv);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = fmaf(pr, vv[c], acc[c]);
    }
  }
  const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] *= inv;
  store4(out + (static_cast<int64_t>(b) * sq + row) * tok +
             static_cast<int64_t>(h) * d + col0,
         acc);
  if (blockIdx.z == 0 && lane == 0)
    lse[(static_cast<int64_t>(b) * nh + h) * sq + row] =
        l == 0.f ? -INFINITY : (m + log2f(l)) * kLn2;
}

// Kernel 3 on the wide route: warp w owns q row blockIdx.x * 4 + w; its q
// (scaled, rounded) and dO rows sit in shared memory.
template <typename TQ, typename TV>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_wide_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                         const TV* __restrict__ v,
                         const TQ* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         TQ* __restrict__ dq, const int* __restrict__ q_seg,
                         const int* __restrict__ kv_seg, int sq, int sk,
                         int nh, int d, float scale, int causal, int offset) {
  extern __shared__ float4 wide_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWideRows + warp;
  if (row >= sq) return;
  const int b = blockIdx.y / nh;
  const int h = blockIdx.y % nh;
  const int col0 = blockIdx.z * kColSlice + 4 * lane;
  const int64_t tok = static_cast<int64_t>(nh) * d;
  const int64_t at = (static_cast<int64_t>(b) * sq + row) * tok +
                     static_cast<int64_t>(h) * d;
  const float ls = lse[(static_cast<int64_t>(b) * nh + h) * sq + row];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (ls != -INFINITY) {  // a row that sees no key has dq = 0
    float* q_s = reinterpret_cast<float*>(wide_smem) + 2 * warp * d;
    float* do_s = q_s + d;
    for (int c = lane; c < d; c += 32) {
      q_s[c] = round_to<TQ>(to_float(q[at + c]) * scale * kLog2e);
      do_s[c] = to_float(dout[at + c]);
    }
    __syncwarp();
    const float l2 = ls * kLog2e;
    const float dlt = delta[(static_cast<int64_t>(b) * sq + row) * nh + h];
    const TQ* kb = k + static_cast<int64_t>(b) * sk * tok +
                   static_cast<int64_t>(h) * d;
    const TV* vb = v + static_cast<int64_t>(b) * sk * tok +
                   static_cast<int64_t>(h) * d;
    const int qid =
        q_seg != nullptr ? q_seg[static_cast<int64_t>(b) * sq + row] : 0;
    const int* ks = kv_seg != nullptr
                        ? kv_seg + static_cast<int64_t>(b) * sk
                        : nullptr;
    const int kv_end = causal ? min(sk, max(0, row + offset + 1)) : sk;
    for (int j0 = 0; j0 < kv_end; j0 += 32) {
      const int j = j0 + lane;
      float ds = 0.f;
      if (j < kv_end && (ks == nullptr || ks[j] == qid)) {
        const float p = exp2f(dot_row(q_s, kb + j * tok, d) - l2);
        const float dp = dot_row(do_s, vb + j * tok, d);
        ds = round_to<TQ>(p * (dp - dlt));
      }
      const int n = min(32, kv_end - j0);
      for (int jj = 0; jj < n; ++jj) {
        const float dsj = __shfl_sync(0xffffffffu, ds, jj);
        if (dsj == 0.f) continue;
        float kk[4];
        load4(kb + (j0 + jj) * tok + col0, kk);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = fmaf(dsj, kk[c], acc[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] *= scale;
  store4(dq + at + col0, acc);
}

// Kernels 4 (and 2, as the wrapper runs it above 256) on the wide route:
// warp w owns key row blockIdx.x * 4 + w; its K and V rows sit in shared
// memory, and the lanes walk the q rows that can see it, 32 at a time.
template <typename TQ, typename TV>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_wide_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                          const TV* __restrict__ v,
                          const TQ* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          TQ* __restrict__ dk, TV* __restrict__ dv,
                          const int* __restrict__ q_seg,
                          const int* __restrict__ kv_seg, int sq, int sk,
                          int nh, int d, float scale, int causal,
                          int offset) {
  extern __shared__ float4 wide_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int key = blockIdx.x * kWideRows + warp;
  if (key >= sk) return;
  const int b = blockIdx.y / nh;
  const int h = blockIdx.y % nh;
  const int col0 = blockIdx.z * kColSlice + 4 * lane;
  const int64_t tok = static_cast<int64_t>(nh) * d;
  const int64_t at = (static_cast<int64_t>(b) * sk + key) * tok +
                     static_cast<int64_t>(h) * d;
  float* k_s = reinterpret_cast<float*>(wide_smem) + 2 * warp * d;
  float* v_s = k_s + d;
  for (int c = lane; c < d; c += 32) {
    k_s[c] = to_float(k[at + c]);
    v_s[c] = to_float(v[at + c]);
  }
  __syncwarp();
  const float scale_log2 = scale * kLog2e;
  const TQ* qb = q + static_cast<int64_t>(b) * sq * tok +
                 static_cast<int64_t>(h) * d;
  const TQ* db = dout + static_cast<int64_t>(b) * sq * tok +
                 static_cast<int64_t>(h) * d;
  const float* lb = lse + (static_cast<int64_t>(b) * nh + h) * sq;
  const float* tb = delta + static_cast<int64_t>(b) * sq * nh + h;
  const int kid =
      kv_seg != nullptr ? kv_seg[static_cast<int64_t>(b) * sk + key] : 0;
  const int* qs = q_seg != nullptr ? q_seg + static_cast<int64_t>(b) * sq
                                   : nullptr;
  float dk_acc[4] = {0.f, 0.f, 0.f, 0.f}, dv_acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i0 = causal ? max(0, key - offset) : 0; i0 < sq; i0 += 32) {
    const int i = i0 + lane;
    float pr = 0.f, ds = 0.f;
    if (i < sq && (qs == nullptr || qs[i] == kid) && lb[i] != -INFINITY) {
      const TQ* qr = qb + i * tok;
      float s = 0.f;
      for (int c = 0; c < d; c += 4) {
        float f[4];
        load4(qr + c, f);
        const float4 kv = *reinterpret_cast<const float4*>(k_s + c);
        s = fmaf(round_to<TQ>(f[0] * scale_log2), kv.x, s);
        s = fmaf(round_to<TQ>(f[1] * scale_log2), kv.y, s);
        s = fmaf(round_to<TQ>(f[2] * scale_log2), kv.z, s);
        s = fmaf(round_to<TQ>(f[3] * scale_log2), kv.w, s);
      }
      const float p = exp2f(s - lb[i] * kLog2e);
      const float dp = dot_row(v_s, db + i * tok, d);
      pr = round_to<TQ>(p);
      ds = round_to<TQ>(p * (dp - tb[static_cast<int64_t>(i) * nh]));
    }
    const int n = min(32, sq - i0);
    for (int ii = 0; ii < n; ++ii) {
      const float pj = __shfl_sync(0xffffffffu, pr, ii);
      const float dsj = __shfl_sync(0xffffffffu, ds, ii);
      if (pj == 0.f && dsj == 0.f) continue;
      float qq[4], dd[4];
      load4(qb + (i0 + ii) * tok + col0, qq);
      load4(db + (i0 + ii) * tok + col0, dd);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dv_acc[c] = fmaf(pj, dd[c], dv_acc[c]);
        dk_acc[c] = fmaf(dsj, round_to<TQ>(qq[c] * scale_log2), dk_acc[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) dk_acc[c] /= kLog2e;
  store4(dk + at + col0, dk_acc);
  store4(dv + at + col0, dv_acc);
}

// Calls f(Tag<TQ>, Tag<TV>) for the type codes of `dispatch`.
template <typename F>
cudaError_t dispatch_types(int dtypes, F&& f) {
  if (dtypes == 0) return f(Tag<float>{}, Tag<float>{});
  if (dtypes == 1) return f(Tag<bf16>{}, Tag<bf16>{});
  if (dtypes == 2) return f(Tag<float>{}, Tag<bf16>{});
  return cudaErrorInvalidValue;
}

// a head dim the wide route takes
bool wide_head_dim(int head_dim) {
  return head_dim > 256 && head_dim % kColSlice == 0;
}

// launches a wide kernel: 4 rows a block, rows_smem fp32 values of
// shared memory per row
template <typename K, typename... Args>
cudaError_t launch_wide(K kernel, int rows, int nbh, int head_dim,
                        int rows_smem, cudaStream_t st, Args... args) {
  const int smem = kWideRows * rows_smem * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kWideRows - 1) / kWideRows, nbh,
                  col_slices(head_dim));
  kernel<<<grid, kMmaThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream`, allocates nothing and returns
// cudaGetLastError() (0 on success).  Tensors are contiguous: q/out/do/dq
// [b, sq, h, d], k/v/dk/dv [b, sk, h, d], lse [b, h, sq] fp32, delta
// [b, sq, h] fp32; q_seg [b, sq] and kv_seg [b, sk] int32, or both null.
// dtypes: 0 = fp32 q/k/v, 1 = bf16 q/k/v, 2 = fp32 q/k with bf16 v
// (out/do/dq in q's type, dk in k's, dv in v's).  head_dim 32, 64, 128 or
// 256 on the tensor cores, or a multiple of 128 above 256 on the wide
// route.

int hetu_flash_fwd(const void* q, const void* k, const void* v, void* out,
                   void* lse, const void* q_seg, const void* kv_seg, int b,
                   int sq, int sk, int nh, int head_dim, float scale,
                   int causal, int offset, int dtypes, void* stream) {
  if (bad_shape(b, sq, sk, nh)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (wide_head_dim(head_dim))
    return static_cast<int>(dispatch_types(dtypes, [&](auto tq, auto tv) {
      using TQ = typename decltype(tq)::type;
      using TV = typename decltype(tv)::type;
      return launch_wide(flash_fwd_wide_kernel<TQ, TV>, sq, b * nh, head_dim,
                         head_dim, st, static_cast<const TQ*>(q),
                         static_cast<const TQ*>(k), static_cast<const TV*>(v),
                         static_cast<TQ*>(out), static_cast<float*>(lse),
                         static_cast<const int*>(q_seg),
                         static_cast<const int*>(kv_seg), sq, sk, nh,
                         head_dim, scale * kLog2e, causal, offset);
    }));
  return static_cast<int>(dispatch(head_dim, dtypes, [&](auto hd, auto tq,
                                                         auto tv) {
    constexpr int HD = decltype(hd)::value;
    using TQ = typename decltype(tq)::type;
    using TV = typename decltype(tv)::type;
    if constexpr (wgmma_route<HD, TQ, TV>()) {
      return launch_fwd_wgmma<HD>(q, k, v, out, lse, q_seg, kv_seg, b, sq,
                                  sk, nh, scale * kLog2e, causal, offset,
                                  st);
    } else {
      auto kernel = flash_fwd_mma_kernel<HD, TQ, TV>;
      constexpr int smem = fwd_mma_smem_bytes<HD, TQ, TV>();
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((sq + kB - 1) / kB, b * nh, col_blocks<HD>());
      kernel<<<grid, kMmaThreads, smem, st>>>(
          static_cast<const TQ*>(q), static_cast<const TQ*>(k),
          static_cast<const TV*>(v), static_cast<TQ*>(out),
          static_cast<float*>(lse), static_cast<const int*>(q_seg),
          static_cast<const int*>(kv_seg), sq, sk, nh, scale * kLog2e,
          causal, offset);
      return cudaGetLastError();
    }
  }));
}

int hetu_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, const void* q_seg, const void* kv_seg, int b,
                      int sq, int sk, int nh, int head_dim, float scale,
                      int causal, int offset, int dtypes, void* stream) {
  if (bad_shape(b, sq, sk, nh)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (wide_head_dim(head_dim))
    return static_cast<int>(dispatch_types(dtypes, [&](auto tq, auto tv) {
      using TQ = typename decltype(tq)::type;
      using TV = typename decltype(tv)::type;
      return launch_wide(
          flash_bwd_dq_wide_kernel<TQ, TV>, sq, b * nh, head_dim,
          2 * head_dim, st, static_cast<const TQ*>(q),
          static_cast<const TQ*>(k), static_cast<const TV*>(v),
          static_cast<const TQ*>(dout), static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<TQ*>(dq),
          static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
          sq, sk, nh, head_dim, scale, causal, offset);
    }));
  return static_cast<int>(dispatch(head_dim, dtypes, [&](auto hd, auto tq,
                                                         auto tv) {
    constexpr int HD = decltype(hd)::value;
    using TQ = typename decltype(tq)::type;
    using TV = typename decltype(tv)::type;
    if constexpr (wgmma_route<HD, TQ, TV>()) {
      return launch_dq_wgmma<HD>(q, k, v, dout, lse, delta, dq, q_seg,
                                 kv_seg, b, sq, sk, nh, scale, causal, offset,
                                 st);
    } else {
      auto kernel = flash_bwd_dq_mma_kernel<HD, TQ, TV>;
      constexpr int smem = dq_mma_smem_bytes<HD, TQ, TV>();
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((sq + kB - 1) / kB, b * nh, col_blocks<HD>());
      kernel<<<grid, kMmaThreads, smem, st>>>(
          static_cast<const TQ*>(q), static_cast<const TQ*>(k),
          static_cast<const TV*>(v), static_cast<const TQ*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<TQ*>(dq), static_cast<const int*>(q_seg),
          static_cast<const int*>(kv_seg), sq, sk, nh, scale, causal,
          offset);
      return cudaGetLastError();
    }
  }));
}

// The split dk/dv kernel (fused = 0: delta given, out and dq_acc unused) or
// the fused dq/dk/dv kernel (fused = 1: delta computed from out and dout,
// dq added into the zeroed fp32 workspace dq_acc [b, sq, h, d]).
int hetu_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const void* lse,
                       const void* delta, void* dq_acc, void* dk, void* dv,
                       const void* q_seg, const void* kv_seg, int b, int sq,
                       int sk, int nh, int head_dim, float scale, int causal,
                       int offset, int dtypes, int fused, void* stream) {
  if (bad_shape(b, sq, sk, nh)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (wide_head_dim(head_dim)) {
    // the wide route has no fused kernel: the wrapper runs kernel 2 there
    // as the split kernels 3 and 4, which compute the same dq, dk and dv
    if (fused) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(dispatch_types(dtypes, [&](auto tq, auto tv) {
      using TQ = typename decltype(tq)::type;
      using TV = typename decltype(tv)::type;
      return launch_wide(
          flash_bwd_dkv_wide_kernel<TQ, TV>, sk, b * nh, head_dim,
          2 * head_dim, st, static_cast<const TQ*>(q),
          static_cast<const TQ*>(k), static_cast<const TV*>(v),
          static_cast<const TQ*>(dout), static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<TQ*>(dk),
          static_cast<TV*>(dv), static_cast<const int*>(q_seg),
          static_cast<const int*>(kv_seg), sq, sk, nh, head_dim, scale,
          causal, offset);
    }));
  }
  return static_cast<int>(dispatch(head_dim, dtypes, [&](auto hd, auto tq,
                                                         auto tv) {
    constexpr int HD = decltype(hd)::value;
    using TQ = typename decltype(tq)::type;
    using TV = typename decltype(tv)::type;
    if constexpr (wgmma_route<HD, TQ, TV>()) {
      return launch_dkv_wgmma<HD>(q, k, v, out, dout, lse, delta, dq_acc, dk,
                                  dv, q_seg, kv_seg, b, sq, sk, nh, scale,
                                  causal, offset, fused, st);
    } else {
      const dim3 grid((sk + kB - 1) / kB, b * nh, col_blocks<HD>());
      return with_dkv_kernel<HD, TQ, TV>(
          fused, [&](auto kernel, int threads, int smem) {
            cudaError_t err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err != cudaSuccess) return err;
            kernel<<<grid, threads, smem, st>>>(
                static_cast<const TQ*>(q), static_cast<const TQ*>(k),
                static_cast<const TV*>(v), static_cast<const TQ*>(out),
                static_cast<const TQ*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<float*>(dq_acc),
                static_cast<TQ*>(dk), static_cast<TV*>(dv),
                static_cast<const int*>(q_seg),
                static_cast<const int*>(kv_seg), sq, sk, nh, scale, causal,
                offset);
            return cudaGetLastError();
          });
    }
  }));
}

// The route `entry` (0: hetu_flash_fwd, 1: hetu_flash_bwd_dq, 2:
// hetu_flash_bwd_dkv) takes for these type codes and head dim: 1 bf16
// mma.sync tensor cores, 2 3xTF32 tensor cores, 3 wgmma (every bf16 entry
// at head dims 64 and 128), 0 the CUDA cores (the wide route, head dims
// above 256); -1 if it takes none.
int hetu_flash_uses_tensor_cores(int entry, int head_dim, int dtypes) {
  if (entry < kEntryFwd || entry > kEntryDkv || dtypes < 0 || dtypes > 2)
    return -1;
  if (wide_head_dim(head_dim)) return kRouteCudaCores;
  if (head_dim != 32 && head_dim != 64 && head_dim != 128 && head_dim != 256)
    return -1;
  // type code 1 is the (bf16, bf16) pair of `dispatch`, 0 and 2 have fp32 q
  if (dtypes != 1) return kRouteTf32;
  return head_dim == 64 || head_dim == 128 ? kRouteWgmma : kRouteBf16;
}

// The dynamic shared memory bytes and the blocks an SM of the kernel that
// `entry` launches for these types and head dim (fused as in
// hetu_flash_bwd_dkv); returns a cudaError_t.
int hetu_flash_kernel_info(int entry, int head_dim, int dtypes, int fused,
                           int* smem_bytes, int* blocks_per_sm) {
  if (entry < kEntryFwd || entry > kEntryDkv)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(head_dim, dtypes, [&](auto hd, auto tq,
                                                         auto tv) {
    constexpr int HD = decltype(hd)::value;
    using TQ = typename decltype(tq)::type;
    using TV = typename decltype(tv)::type;
    auto info = [&](auto kernel, int threads, int smem) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      *smem_bytes = smem;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, kernel, threads, smem);
    };
    if (entry == kEntryFwd) {
      if constexpr (wgmma_route<HD, TQ, TV>())
        return info(flash_fwd_wgmma_kernel<HD>, kWgmmaThreads,
                    FwdWgmma<HD>::kSmem);
      else
        return info(flash_fwd_mma_kernel<HD, TQ, TV>, kMmaThreads,
                    fwd_mma_smem_bytes<HD, TQ, TV>());
    }
    if (entry == kEntryDq) {
      if constexpr (wgmma_route<HD, TQ, TV>())
        return info(flash_bwd_dq_wgmma_kernel<HD>, kWgmmaThreads,
                    DqWgmma<HD>::kSmem);
      else
        return info(flash_bwd_dq_mma_kernel<HD, TQ, TV>, kMmaThreads,
                    dq_mma_smem_bytes<HD, TQ, TV>());
    }
    return with_dkv_kernel<HD, TQ, TV>(fused, info);
  }));
}

const char* hetu_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
