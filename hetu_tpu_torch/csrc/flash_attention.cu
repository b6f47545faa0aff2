// Flash attention forward and backward for Hopper (sm_90a), CUDA C++ with
// plain C entries.
//
// Replaces the four Pallas TPU kernels of
// hetu_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel / flash_fwd_mma_kernel   <- :178 `_fwd_kernel`
//       (`_flash_fwd`)
//   flash_bwd_dkv_kernel<..., true> / flash_bwd_dkv_mma_kernel<..., true>
//       <- :325 `_bwd_fused_kernel` (`_flash_bwd_fused`)
//   flash_bwd_dq_kernel                       <- :466 `_bwd_dq_kernel`
//       (`_flash_bwd_split`)
//   flash_bwd_dkv_kernel<..., false> / flash_bwd_dkv_mma_kernel<..., false>
//       <- :510 `_bwd_dkv_kernel` (`_flash_bwd_split`)
// Same functions: q [b, sq, h, d], k/v [b, sk, h, d] (equal head counts),
// scores q.k * scale taken as base-2 logits (scale * log2(e) folded into
// q), causal with a diagonal offset (key j is visible to query i iff
// j <= i + offset), optional segment ids per token (q_ids [b, sq], kv_ids
// [b, sk]: equal ids see each other).  The forward returns out in q's
// type and lse [b, h, sq] (fp32, natural log); a row that sees no key
// gives out = 0 and lse = -inf, and in the backward p = 0 wherever the key
// is masked or the row's lse is -inf, so such rows get zero gradients.
// Rounding follows the TPU kernels: q * scale * log2(e) is rounded to q's
// type (:274, :405; the scalar kernels keep it in fp32), p to v's type
// before p.v (:249), to do's type before p^T.do (:377), and ds to q's
// type before ds.k and ds^T.q (:383); every product accumulates in fp32.
// Types: q/k/do/out share one type and v may differ: (fp32, fp32, fp32),
// (bf16, bf16, bf16) and (fp32, fp32, bf16), the last being what the
// bf16 LLaMA model feeds (its rotary tables are fp32).  Head dims 64, 128.
//
// What bounds them on an H100 (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s
// fp32 outside them, 3.35 TB/s): causal attention does 4*b*h*sq*sk*d/2
// FLOPs forward -- at the Llama-3-8B training shape (b 2, s 4096, h 32,
// d 128) 275 GFLOP, 0.28 ms on the tensor cores -- and 2.5 times that
// backward, against q/k/v/o/do/lse/dq/dk/dv traffic of about 0.4 GB
// (0.13 ms).  So they are bound by operations.
//
// What the design does about it:
//  - One block owns one (batch, head) and one tile of 64 rows, and loops
//    over the other axis itself: the forward and dq over KV tiles (their
//    TPU grids carried that loop in VMEM scratch), dk/dv and the fused
//    kernel over q tiles.  Tiles wholly above the causal diagonal are
//    never loaded, as the TPU kernels skip them (`run`, :237): the
//    forward and dq stop the KV loop at the tile's last visible key, dk/dv
//    start the q loop at the first q row that sees the KV tile.  Any sq
//    and sk: the ragged edge is masked.  Tiles are read in place from
//    [b, s, h, d] with a stride of h*d between tokens; out/dq/dk/dv are
//    written in that layout.
//  - Fused backward: the TPU kept dk/dv for the whole sequence in VMEM per
//    (batch, head); here a block owns one KV tile's dk/dv in registers,
//    loops over the q tiles, computes delta = rowsum(do * o) itself and
//    adds its share of dq into an fp32 workspace with atomics (summed in
//    an order that changes from run to run).  The split kernels are
//    deterministic and take delta from one torch op outside.
//  - bf16 q/k/v (the forward and the dk/dv template, split and fused) run
//    on the tensor cores: mma.sync m16n8k16 with fp32 accumulation
//    (mma_bf16.cuh), 4 warps of 16 rows each.  Tiles sit in shared memory
//    in bf16 with rows padded by 16 bytes, so that ldmatrix (.trans for
//    V, dO and Q as the B operand of P.V, P^T.dO and dS^T.Q) reads them
//    without bank conflicts; the next K/V (forward) or Q/dO/lse/delta
//    (dk/dv) tile is copied by cp.async into a second buffer while the
//    current one is multiplied, rows past sq/sk zero-filled.  The forward
//    keeps Q's fragments, S and O in registers and feeds P to P.V
//    straight from the S registers; masks are applied only to tiles that
//    cross the diagonal or an edge (or with segments).  The dk/dv kernel
//    keeps dK and dV in registers and works through each q tile in
//    column chunks (32 q rows at d = 128, so that S^T and dP^T fit beside
//    the accumulators without spills); the fused one stages dS^T in
//    shared memory for dQ = dS.K and adds dQ with 8-byte vector atomics.
//    87 KB (forward) and 106-115 KB (dk/dv) of shared memory at d = 128:
//    two blocks an SM.
//  - fp32 and (fp32, fp32, bf16) q/k/v, and dq in every type, run scalar
//    fp32 FMA on the CUDA cores (fp32 tiles, 4 x 4 register blocks): the
//    fp32 path stays exact to fp32 rounding (no TF32), at one block an SM.
//  - Not yet: wgmma with TMA and warp specialisation for the bf16 kernels;
//    the bf16 dq kernel on the tensor cores; the fp32 and mixed kernels on
//    the tensor cores (3xTF32), which would need a gate that says it
//    computes the same function.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kB = 64;           // rows of a q tile and of a KV tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kPS = kB + 4;      // row stride (floats) of a 64 x 64 tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// element access
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// x rounded to T's precision and back (the TPU kernels' `.astype`)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16(x));
  }
}

// ---------------------------------------------------------------------------
// tiles and products in shared memory
// ---------------------------------------------------------------------------

// Rows row0 .. row0+63 of one head of a [b, s, h, HD] tensor (src points at
// (batch, token 0, head, 0)) into dst [64][HD+4] as fp32 times `mul`; rows
// at or past n_rows are zero.
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n_rows, int64_t tok_stride,
                                          float mul) {
  constexpr int kPerRow = HD / 4;
  for (int e = threadIdx.x; e < kB * kPerRow; e += kThreads) {
    const int r = e / kPerRow;
    const int c = (e % kPerRow) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) {
      v = load4(src + static_cast<int64_t>(row0 + r) * tok_stride + c);
      v.x *= mul;
      v.y *= mul;
      v.z *= mul;
      v.w *= mul;
    }
    store4(dst + r * (HD + 4) + c, v);
  }
}

// s[r][c] = sum_d a[tr + 16r][d] * b[tc + 16c][d]; a and b are [64][HD+4].
template <int HD>
__device__ __forceinline__ void mm_abt(const float* a, const float* b,
                                       float (&s)[4][4]) {
  constexpr int LD = HD + 4;
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      av[r] = *reinterpret_cast<const float4*>(a + (tr + 16 * r) * LD + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = *reinterpret_cast<const float4*>(b + (tc + 16 * c) * LD + d);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(av[r].x, bv[c].x, s[r][c]);
        s[r][c] = fmaf(av[r].y, bv[c].y, s[r][c]);
        s[r][c] = fmaf(av[r].z, bv[c].z, s[r][c]);
        s[r][c] = fmaf(av[r].w, bv[c].w, s[r][c]);
      }
  }
}

// acc[r][4j + e] += sum_k p[tr + 16r][k] * v[k][4tc + 64j + e]; p is
// [64][kPS], v is [64][HD+4].
template <int HD>
__device__ __forceinline__ void mm_ab(const float* p, const float* v,
                                      float (&acc)[4][HD / 16]) {
  constexpr int LD = HD + 4;
  constexpr int kJ = HD / 64;
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
#pragma unroll 2
  for (int k = 0; k < kB; k += 4) {
    float pr[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 pv =
          *reinterpret_cast<const float4*>(p + (tr + 16 * r) * kPS + k);
      pr[r][0] = pv.x;
      pr[r][1] = pv.y;
      pr[r][2] = pv.z;
      pr[r][3] = pv.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(
            v + (k + kk) * LD + 4 * tc + 64 * j);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][4 * j + 0] = fmaf(pr[r][kk], vv.x, acc[r][4 * j + 0]);
          acc[r][4 * j + 1] = fmaf(pr[r][kk], vv.y, acc[r][4 * j + 1]);
          acc[r][4 * j + 2] = fmaf(pr[r][kk], vv.z, acc[r][4 * j + 2]);
          acc[r][4 * j + 3] = fmaf(pr[r][kk], vv.w, acc[r][4 * j + 3]);
        }
      }
  }
}

// max and sum over the 16 lanes that share a tile row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Writes the thread's 4 x HD/16 block of a 64-row output tile (rows
// row0 + tr + 16r, columns 4tc + 64j .. +3) times `mul`.
template <int HD, typename T>
__device__ __forceinline__ void store_tile(T* dst, const float (&acc)[4][HD / 16],
                                           int row0, int n_rows,
                                           int64_t tok_stride, float mul) {
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + tr + 16 * r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < HD / 64; ++j)
      store4(dst + static_cast<int64_t>(row) * tok_stride + 4 * tc + 64 * j,
             make_float4(acc[r][4 * j] * mul, acc[r][4 * j + 1] * mul,
                         acc[r][4 * j + 2] * mul, acc[r][4 * j + 3] * mul));
  }
}

// the number of 64-key tiles that q rows [q0, q0 + 64) can see
__device__ __forceinline__ int kv_tiles_for(int q0, int sq, int sk, int causal,
                                            int offset) {
  int kv_end = sk;
  if (causal) kv_end = min(sk, min(q0 + kB, sq) - 1 + offset + 1);
  return kv_end > 0 ? (kv_end + kB - 1) / kB : 0;
}

// the first 64-row q tile that can see keys [k0, k0 + 64)
__device__ __forceinline__ int first_q_tile(int k0, int causal, int offset) {
  return causal ? max(0, k0 - offset) / kB : 0;
}

// ---------------------------------------------------------------------------
// kernel 1: forward
// ---------------------------------------------------------------------------

template <int HD>
constexpr int fwd_smem_bytes() {
  return (3 * kB * (HD + 4) + kB * kPS) * 4 + kB * 4;
}

template <int HD, typename TQ, typename TV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                 const TV* __restrict__ v, TQ* __restrict__ out,
                 float* __restrict__ lse, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, int sq, int sk, int nh,
                 float scale_log2, int causal, int offset) {
  constexpr int LD = HD + 4;
  constexpr int kD = HD / 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // q * scale * log2(e)
  float* k_s = q_s + kB * LD;
  float* v_s = k_s + kB * LD;
  float* p_s = v_s + kB * LD;                    // p rounded to v's type
  int* kseg_s = reinterpret_cast<int*>(p_s + kB * kPS);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // longest rows first
  const int b = blockIdx.y / nh;
  const int h = blockIdx.y % nh;
  const int64_t tok = static_cast<int64_t>(nh) * HD;
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const TQ* qb = q + static_cast<int64_t>(b) * sq * tok + h * HD;
  const TQ* kb = k + static_cast<int64_t>(b) * sk * tok + h * HD;
  const TV* vb = v + static_cast<int64_t>(b) * sk * tok + h * HD;

  load_tile<HD>(q_s, qb, q0, sq, tok, scale_log2);
  int qi[4], qsg[4];
  float m[4], l[4], acc[4][kD];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    qi[r] = q0 + tr + 16 * r;
    qsg[r] = (q_seg != nullptr && qi[r] < sq)
                 ? q_seg[static_cast<int64_t>(b) * sq + qi[r]] : 0;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kD; ++e) acc[r][e] = 0.f;
  }

  const int n_kv = kv_tiles_for(q0, sq, sk, causal, offset);
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // the previous tile's k_s, v_s and p_s are consumed
    load_tile<HD>(k_s, kb, k0, sk, tok, 1.f);
    load_tile<HD>(v_s, vb, k0, sk, tok, 1.f);
    if (kv_seg != nullptr && threadIdx.x < kB)
      kseg_s[threadIdx.x] =
          k0 + threadIdx.x < sk
              ? kv_seg[static_cast<int64_t>(b) * sk + k0 + threadIdx.x] : 0;
    __syncthreads();

    float s[4][4];
    mm_abt<HD>(q_s, k_s, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tc + 16 * c;
        bool ok = qi[r] < sq && j < sk;
        if (causal) ok = ok && j <= qi[r] + offset;
        if (kv_seg != nullptr) ok = ok && qsg[r] == kseg_s[tc + 16 * c];
        s[r][c] = ok ? s[r][c] : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      // a row that has seen no key yet keeps m = -inf, p = 0 and alpha = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[r][c] - m_use);
        sum += p;
        p_s[(tr + 16 * r) * kPS + tc + 16 * c] = round_to<TV>(p);
      }
      l[r] = l[r] * alpha + row_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < kD; ++e) acc[r][e] *= alpha;
    }
    __syncthreads();
    mm_ab<HD>(p_s, v_s, acc);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (qi[r] >= sq) continue;
    const bool empty = l[r] == 0.f;
    const float inv = empty ? 0.f : 1.f / l[r];
    TQ* dst = out + (static_cast<int64_t>(b) * sq + qi[r]) * tok + h * HD;
#pragma unroll
    for (int j = 0; j < HD / 64; ++j)
      store4(dst + 4 * tc + 64 * j,
             make_float4(acc[r][4 * j] * inv, acc[r][4 * j + 1] * inv,
                         acc[r][4 * j + 2] * inv, acc[r][4 * j + 3] * inv));
    if (tc == 0)
      lse[(static_cast<int64_t>(b) * nh + h) * sq + qi[r]] =
          empty ? -INFINITY : (m[r] + log2f(l[r])) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// kernel 3: dq of the split backward
// ---------------------------------------------------------------------------

template <int HD>
constexpr int dq_smem_bytes() {
  return (4 * kB * (HD + 4) + kB * kPS) * 4 + kB * 4;
}

template <int HD, typename TQ, typename TV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                    const TV* __restrict__ v, const TQ* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, TQ* __restrict__ dq,
                    const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg, int sq, int sk, int nh,
                    float scale, int causal, int offset) {
  constexpr int LD = HD + 4;
  constexpr int kD = HD / 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // q * scale * log2(e)
  float* do_s = q_s + kB * LD;
  float* k_s = do_s + kB * LD;
  float* v_s = k_s + kB * LD;
  float* ds_s = v_s + kB * LD;                   // ds rounded to q's type
  int* kseg_s = reinterpret_cast<int*>(ds_s + kB * kPS);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;
  const int b = blockIdx.y / nh;
  const int h = blockIdx.y % nh;
  const int64_t tok = static_cast<int64_t>(nh) * HD;
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const int64_t qoff = static_cast<int64_t>(b) * sq * tok + h * HD;
  const int64_t koff = static_cast<int64_t>(b) * sk * tok + h * HD;

  load_tile<HD>(q_s, q + qoff, q0, sq, tok, scale * kLog2e);
  load_tile<HD>(do_s, dout + qoff, q0, sq, tok, 1.f);
  int qi[4], qsg[4];
  float lse2[4], dlt[4], acc[4][kD];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    qi[r] = q0 + tr + 16 * r;
    const bool live = qi[r] < sq;
    qsg[r] = (q_seg != nullptr && live)
                 ? q_seg[static_cast<int64_t>(b) * sq + qi[r]] : 0;
    lse2[r] = live ? lse[(static_cast<int64_t>(b) * nh + h) * sq + qi[r]] *
                         kLog2e
                   : -INFINITY;
    dlt[r] = live ? delta[(static_cast<int64_t>(b) * sq + qi[r]) * nh + h]
                  : 0.f;
#pragma unroll
    for (int e = 0; e < kD; ++e) acc[r][e] = 0.f;
  }

  const int n_kv = kv_tiles_for(q0, sq, sk, causal, offset);
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kB;
    __syncthreads();
    load_tile<HD>(k_s, k + koff, k0, sk, tok, 1.f);
    load_tile<HD>(v_s, v + koff, k0, sk, tok, 1.f);
    if (kv_seg != nullptr && threadIdx.x < kB)
      kseg_s[threadIdx.x] =
          k0 + threadIdx.x < sk
              ? kv_seg[static_cast<int64_t>(b) * sk + k0 + threadIdx.x] : 0;
    __syncthreads();

    float s[4][4], dp[4][4];
    mm_abt<HD>(q_s, k_s, s);
    mm_abt<HD>(do_s, v_s, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tc + 16 * c;
        bool ok = qi[r] < sq && j < sk && lse2[r] != -INFINITY;
        if (causal) ok = ok && j <= qi[r] + offset;
        if (kv_seg != nullptr) ok = ok && qsg[r] == kseg_s[tc + 16 * c];
        const float p = ok ? exp2f(s[r][c] - lse2[r]) : 0.f;
        ds_s[(tr + 16 * r) * kPS + tc + 16 * c] =
            round_to<TQ>(p * (dp[r][c] - dlt[r]));
      }
    __syncthreads();
    mm_ab<HD>(ds_s, k_s, acc);
  }
  store_tile<HD>(dq + qoff, acc, q0, sq, tok, scale);
}

// ---------------------------------------------------------------------------
// kernels 4 (dk/dv of the split backward) and 2 (fused dq/dk/dv)
// ---------------------------------------------------------------------------

template <int HD, bool kFused>
constexpr int dkv_smem_bytes() {
  return (4 * kB * (HD + 4) + (kFused ? 3 : 2) * kB * kPS) * 4 + 3 * kB * 4;
}

// One block per (batch, head, KV tile): dk and dv of the tile in registers,
// a loop over the q tiles that see it.  kFused also computes delta from o
// and do, and adds dq into dq_acc (fp32, [b, sq, h, d]) with atomics.
template <int HD, typename TQ, typename TV, bool kFused>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                     const TV* __restrict__ v, const TQ* __restrict__ out,
                     const TQ* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq_acc, TQ* __restrict__ dk,
                     TV* __restrict__ dv, const int* __restrict__ q_seg,
                     const int* __restrict__ kv_seg, int sq, int sk, int nh,
                     float scale, int causal, int offset) {
  constexpr int LD = HD + 4;
  constexpr int kD = HD / 16;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kB * LD;
  float* q_s = v_s + kB * LD;      // q * scale * log2(e)
  float* do_s = q_s + kB * LD;
  float* p_t = do_s + kB * LD;     // [kv][q] p rounded to do's type
  float* ds_t = p_t + kB * kPS;    // [kv][q] ds rounded to q's type
  float* ds_s = ds_t + kB * kPS;   // [q][kv] the same ds (fused only)
  float* lse_s = ds_t + (kFused ? 2 : 1) * kB * kPS;
  float* dlt_s = lse_s + kB;
  int* qseg_s = reinterpret_cast<int*>(dlt_s + kB);

  const int k0 = blockIdx.x * kB;  // the low tiles see the most q rows
  const int b = blockIdx.y / nh;
  const int h = blockIdx.y % nh;
  const int64_t tok = static_cast<int64_t>(nh) * HD;
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const int64_t qoff = static_cast<int64_t>(b) * sq * tok + h * HD;
  const int64_t koff = static_cast<int64_t>(b) * sk * tok + h * HD;
  const float sl = scale * kLog2e;

  load_tile<HD>(k_s, k + koff, k0, sk, tok, 1.f);
  load_tile<HD>(v_s, v + koff, k0, sk, tok, 1.f);
  int kj[4], ksg[4];
  float dk_acc[4][kD], dv_acc[4][kD];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    kj[r] = k0 + tr + 16 * r;
    ksg[r] = (kv_seg != nullptr && kj[r] < sk)
                 ? kv_seg[static_cast<int64_t>(b) * sk + kj[r]] : 0;
#pragma unroll
    for (int e = 0; e < kD; ++e) dk_acc[r][e] = dv_acc[r][e] = 0.f;
  }

  for (int q0 = first_q_tile(k0, causal, offset) * kB; q0 < sq; q0 += kB) {
    __syncthreads();  // the previous q tile's smem is consumed
    load_tile<HD>(q_s, q + qoff, q0, sq, tok, sl);
    load_tile<HD>(do_s, dout + qoff, q0, sq, tok, 1.f);
    if (threadIdx.x < kB) {
      const int i = q0 + threadIdx.x;
      const bool live = i < sq;
      lse_s[threadIdx.x] =
          live ? lse[(static_cast<int64_t>(b) * nh + h) * sq + i] * kLog2e
               : -INFINITY;
      if (!kFused)
        dlt_s[threadIdx.x] =
            live ? delta[(static_cast<int64_t>(b) * sq + i) * nh + h] : 0.f;
      qseg_s[threadIdx.x] = (q_seg != nullptr && live)
                                ? q_seg[static_cast<int64_t>(b) * sq + i] : 0;
    }
    __syncthreads();
    if (kFused) {
      // delta = rowsum(do * o): warp w takes rows 8w .. 8w + 7
      const int warp = threadIdx.x >> 5;
      const int lane = threadIdx.x & 31;
      for (int rr = 0; rr < kB / 8; ++rr) {
        const int row = warp * (kB / 8) + rr;
        const int i = q0 + row;
        float part = 0.f;
        if (i < sq)
          for (int d = lane; d < HD; d += 32)
            part += do_s[row * LD + d] *
                    load1(out + qoff + static_cast<int64_t>(i) * tok + d);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if (lane == 0) dlt_s[row] = part;
      }
      __syncthreads();
    }

    // transposed tiles: rows are this block's keys, columns the q rows
    float st[4][4], dpt[4][4];
    mm_abt<HD>(k_s, q_s, st);
    mm_abt<HD>(v_s, do_s, dpt);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tc + 16 * c;
        const int i = q0 + col;
        bool ok = i < sq && kj[r] < sk && lse_s[col] != -INFINITY;
        if (causal) ok = ok && kj[r] <= i + offset;
        if (q_seg != nullptr) ok = ok && qseg_s[col] == ksg[r];
        const float p = ok ? exp2f(st[r][c] - lse_s[col]) : 0.f;
        const float ds = round_to<TQ>(p * (dpt[r][c] - dlt_s[col]));
        p_t[(tr + 16 * r) * kPS + col] = round_to<TQ>(p);
        ds_t[(tr + 16 * r) * kPS + col] = ds;
        if (kFused) ds_s[col * kPS + tr + 16 * r] = ds;
      }
    __syncthreads();
    mm_ab<HD>(p_t, do_s, dv_acc);
    mm_ab<HD>(ds_t, q_s, dk_acc);
    if (kFused) {
      float dq_part[4][kD];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < kD; ++e) dq_part[r][e] = 0.f;
      mm_ab<HD>(ds_s, k_s, dq_part);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = q0 + tr + 16 * r;
        if (i >= sq) continue;
        float* dst = dq_acc + qoff + static_cast<int64_t>(i) * tok;
#pragma unroll
        for (int j = 0; j < HD / 64; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            atomicAdd(dst + 4 * tc + 64 * j + e, dq_part[r][4 * j + e] * scale);
      }
    }
  }
  // dk was accumulated against q * scale * log2(e): divide the log2(e) out
  store_tile<HD>(dk + koff, dk_acc, k0, sk, tok, 1.f / kLog2e);
  store_tile<HD>(dv + koff, dv_acc, k0, sk, tok, 1.f);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernels: kernel 1 and the dk/dv template (kernels 2, 4)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // 4 warps, 16 rows of a 64-row tile each

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

// bf16 tiles in shared memory: 64 rows of HD values, a row stride of HD + 8
// (16 bytes of pad: ldmatrix and the 16-byte copies hit distinct banks)
template <int HD>
__host__ __device__ constexpr int mma_tile_elems() {
  return kB * (HD + 8);
}

// Issues cp.async copies of rows row0 .. row0+63 of one head of a
// [b, s, h, HD] bf16 tensor (src at (batch, token 0, head, 0)) into dst
// [64][HD+8]; rows at or past n_rows are zero-filled.  Thread t copies the
// 16-byte chunks t, t + 128, ... (scale_own_chunks walks the same ones).
template <int HD>
__device__ __forceinline__ void copy_tile_async(bf16* dst, const bf16* src,
                                                int row0, int n_rows,
                                                int64_t tok_stride) {
  constexpr int kChunks = HD / 8;
  for (int e = threadIdx.x; e < kB * kChunks; e += kMmaThreads) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * 8;
    const bool live = row0 + r < n_rows;
    cp_async16(dst + r * (HD + 8) + c,
               src + (live ? static_cast<int64_t>(row0 + r) * tok_stride + c
                           : 0),
               live);
  }
}

// x * mul rounded to bf16, in place, for the chunks this thread copied
// with copy_tile_async (visible to it after its cp_async_wait).
template <int HD>
__device__ __forceinline__ void scale_own_chunks(bf16* tile, float mul) {
  constexpr int kChunks = HD / 8;
  for (int e = threadIdx.x; e < kB * kChunks; e += kMmaThreads) {
    uint4* p = reinterpret_cast<uint4*>(tile + (e / kChunks) * (HD + 8) +
                                        (e % kChunks) * 8);
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

// 4-byte values src[(row0 + i) * stride], i < 64, into dst[i] by cp.async;
// zero at or past n_rows.  Threads 0 .. 63 issue them.
template <typename T>
__device__ __forceinline__ void copy_row_values_async(T* dst, const T* src,
                                                      int row0, int n_rows,
                                                      int stride) {
  if (threadIdx.x < kB) {
    const int i = row0 + threadIdx.x;
    const bool live = i < n_rows;
    cp_async4(dst + threadIdx.x,
              src + (live ? static_cast<int64_t>(i) * stride : 0), live);
  }
}

template <int HD>
constexpr int fwd_mma_smem_bytes() {
  return 5 * mma_tile_elems<HD>() * 2 + 2 * kB * 4;
}

// Kernel 1 on bf16 q/k/v.  One block per (batch * head, 64-row q tile),
// longest rows first; warp w owns q rows 16w .. 16w+15.  q * scale *
// log2(e) is rounded to bf16 once (the reference's :274) and its A
// fragments stay in registers.  Per 64-key tile, with the next K/V tile
// in flight by cp.async into the other buffer: S = Q K^T on the tensor
// cores, the mask only where the tile crosses the diagonal or an edge or
// segments are given, the online softmax in base 2 on the accumulator
// registers (row max and sum over the 4 lanes of a row group), and
// O += P V with P rounded to bf16 (v's type, :249) straight from the S
// registers.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ q_seg,
                     const int* __restrict__ kv_seg, int sq, int sk, int nh,
                     float scale_log2, int causal, int offset) {
  constexpr int LD = HD + 8;
  constexpr int kTile = mma_tile_elems<HD>();
  constexpr int kSteps = HD / 16;  // k-steps of Q K^T
  constexpr int kOTiles = HD / 8;  // n-tiles of O
  extern __shared__ uint4 smem_u4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_u4);
  bf16* k_s = q_s + kTile;          // [2][64][LD]
  bf16* v_s = k_s + 2 * kTile;      // [2][64][LD]
  int* kseg_s = reinterpret_cast<int*>(v_s + 2 * kTile);  // [2][64]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // longest rows first
  const int b = blockIdx.y / nh;
  const int h = blockIdx.y % nh;
  const int64_t tok = static_cast<int64_t>(nh) * HD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int wrow0 = q0 + 16 * warp;
  const bf16* qb = q + static_cast<int64_t>(b) * sq * tok + h * HD;
  const bf16* kb = k + static_cast<int64_t>(b) * sk * tok + h * HD;
  const bf16* vb = v + static_cast<int64_t>(b) * sk * tok + h * HD;
  const int* ksb = kv_seg != nullptr ? kv_seg + static_cast<int64_t>(b) * sk
                                     : nullptr;

  const int n_kv = kv_tiles_for(q0, sq, sk, causal, offset);
  if (n_kv > 0) {
    copy_tile_async<HD>(k_s, kb, 0, sk, tok);
    copy_tile_async<HD>(v_s, vb, 0, sk, tok);
    if (ksb != nullptr) copy_row_values_async(kseg_s, ksb, 0, sk, 1);
  }
  cp_async_commit();

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
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int kt = 0; kt < kSteps; ++kt)
    load_a(qf[kt], q_s, LD, 16 * warp, 16 * kt, lane);

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
    __syncthreads();
    if (t + 1 < n_kv) {
      const int nb = buf ^ 1;
      copy_tile_async<HD>(k_s + nb * kTile, kb, (t + 1) * kB, sk, tok);
      copy_tile_async<HD>(v_s + nb * kTile, vb, (t + 1) * kB, sk, tok);
      if (ksb != nullptr)
        copy_row_values_async(kseg_s + nb * kB, ksb, (t + 1) * kB, sk, 1);
    }
    cp_async_commit();

    const int k0 = t * kB;
    // warp-uniform: rows past sq, or a tile wholly above this warp's part
    // of the diagonal, add nothing
    if (wrow0 >= sq || (causal && k0 > wrow0 + 15 + offset)) continue;
    const bf16* kt_s = k_s + buf * kTile;
    const bf16* vt_s = v_s + buf * kTile;

    float s[kB / 8][4];
#pragma unroll
    for (int nt = 0; nt < kB / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kt = 0; kt < kSteps; ++kt)
#pragma unroll
      for (int np = 0; np < kB / 16; ++np) {
        uint32_t bf[4];
        load_b(bf, kt_s, LD, 16 * np, 16 * kt, lane);
        mma_bf16_16816(s[2 * np], qf[kt], bf[0], bf[1]);
        mma_bf16_16816(s[2 * np + 1], qf[kt], bf[2], bf[3]);
      }

    if (ksb != nullptr || k0 + kB > sk ||
        (causal && k0 + kB - 1 > wrow0 + offset)) {
      const int* ks = kseg_s + buf * kB;
#pragma unroll
      for (int nt = 0; nt < kB / 8; ++nt)
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
      for (int nt = 0; nt < kB / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * hr], s[nt][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row that has seen no key yet keeps m = -inf, p = 0, alpha = 0
      const float m_use = mx == -INFINITY ? 0.f : mx;
      alpha[hr] = exp2f(m[hr] - m_use);
      m[hr] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kB / 8; ++nt) {
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

#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t bf[4];
        load_b_trans(bf, vt_s, LD, 16 * dp, 16 * kk, lane);
        mma_bf16_16816(o[2 * dp], a, bf[0], bf[1]);
        mma_bf16_16816(o[2 * dp + 1], a, bf[2], bf[3]);
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
    bf16* dst = out + (static_cast<int64_t>(b) * sq + row) * tok + h * HD +
                2 * tq;
#pragma unroll
    for (int nt = 0; nt < kOTiles; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8) =
          pack_bf16(o[nt][2 * hr] * inv, o[nt][2 * hr + 1] * inv);
    if (tq == 0)
      lse[(static_cast<int64_t>(b) * nh + h) * sq + row] =
          empty ? -INFINITY : (m[hr] + log2f(lsum)) * kLn2;
  }
}

template <int HD, bool kFused>
constexpr int dkv_mma_smem_bytes() {
  // K, V, Q x 2, dO x 2; dS [64][72] (fused); lse, delta, q ids x 2
  return 6 * mma_tile_elems<HD>() * 2 + (kFused ? kB * (kB + 8) * 2 : 0) +
         6 * kB * 4;
}

// The dk/dv template (kernel 4, and kernel 2 with kFused) on bf16 q/k/v.
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
// scale, as in the scalar kernel.
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
  constexpr int kDTiles = HD / 8;         // n-tiles of dK and dV
  constexpr int kQC = HD == 128 ? 32 : 64;  // q columns per chunk
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
#pragma unroll
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
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t bf[4];
          load_b_trans(bf, dot_s, LD, 16 * dp, qc + 16 * kk, lane);
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
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t bf[4];
          load_b_trans(bf, qt_s, LD, 16 * dp, qc + 16 * kk, lane);
          mma_bf16_16816(dk_acc[2 * dp], a, bf[0], bf[1]);
          mma_bf16_16816(dk_acc[2 * dp + 1], a, bf[2], bf[3]);
        }
      }
    }

    if (kFused) {
      __syncthreads();  // every warp's dS^T rows are in ds_s
      // dQ_part = dS K for q rows 16w .. 16w+15, 64 columns at a time
#pragma unroll 1
      for (int d0 = 0; d0 < HD; d0 += 64) {
        float acc[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kB / 16; ++kk) {
          uint32_t af[4];
          load_a_trans(af, ds_s, kDsLD, 16 * warp, 16 * kk, lane);
#pragma unroll
          for (int dp = 0; dp < 4; ++dp) {
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
          for (int nt = 0; nt < 8; ++nt)
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
    const int64_t row = koff + static_cast<int64_t>(kj[hr]) * tok + 2 * tq;
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

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
struct Tag {
  using type = T;
};

// bf16 q/k/v take the tensor-core forward and dk/dv kernels; every other
// type mix, and the dq kernel, the scalar ones
template <typename TQ, typename TV>
constexpr bool uses_tensor_cores() {
  return std::is_same<TQ, bf16>::value && std::is_same<TV, bf16>::value;
}

// Calls f(int_constant<HD>, Tag<TQ>, Tag<TV>) for the supported head dims and
// type codes (0: all fp32, 1: all bf16, 2: fp32 q/k with bf16 v).
template <typename F>
cudaError_t dispatch(int head_dim, int dtypes, F&& f) {
  using I64 = std::integral_constant<int, 64>;
  using I128 = std::integral_constant<int, 128>;
  using F32 = Tag<float>;
  using B16 = Tag<__nv_bfloat16>;
  if (head_dim == 64) {
    if (dtypes == 0) return f(I64{}, F32{}, F32{});
    if (dtypes == 1) return f(I64{}, B16{}, B16{});
    if (dtypes == 2) return f(I64{}, F32{}, B16{});
  } else if (head_dim == 128) {
    if (dtypes == 0) return f(I128{}, F32{}, F32{});
    if (dtypes == 1) return f(I128{}, B16{}, B16{});
    if (dtypes == 2) return f(I128{}, F32{}, B16{});
  }
  return cudaErrorInvalidValue;
}

bool bad_shape(int b, int sq, int sk, int nh) {
  return b < 1 || sq < 1 || sk < 1 || nh < 1 ||
         static_cast<int64_t>(b) * nh > 65535;
}

}  // namespace

extern "C" {

// Each entry launches on `stream`, allocates nothing and returns
// cudaGetLastError() (0 on success).  Tensors are contiguous: q/out/do/dq
// [b, sq, h, d], k/v/dk/dv [b, sk, h, d], lse [b, h, sq] fp32, delta
// [b, sq, h] fp32; q_seg [b, sq] and kv_seg [b, sk] int32, or both null.
// dtypes: 0 = fp32 q/k/v, 1 = bf16 q/k/v, 2 = fp32 q/k with bf16 v
// (out/do/dq in q's type, dk in k's, dv in v's).  head_dim 64 or 128.

int hetu_flash_fwd(const void* q, const void* k, const void* v, void* out,
                   void* lse, const void* q_seg, const void* kv_seg, int b,
                   int sq, int sk, int nh, int head_dim, float scale,
                   int causal, int offset, int dtypes, void* stream) {
  if (bad_shape(b, sq, sk, nh)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(head_dim, dtypes, [&](auto hd, auto tq,
                                                         auto tv) {
    constexpr int HD = decltype(hd)::value;
    using TQ = typename decltype(tq)::type;
    using TV = typename decltype(tv)::type;
    const dim3 grid((sq + kB - 1) / kB, b * nh);
    if constexpr (uses_tensor_cores<TQ, TV>()) {
      auto kernel = flash_fwd_mma_kernel<HD>;
      constexpr int smem = fwd_mma_smem_bytes<HD>();
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kMmaThreads, smem, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(out),
          static_cast<float*>(lse), static_cast<const int*>(q_seg),
          static_cast<const int*>(kv_seg), sq, sk, nh, scale * kLog2e,
          causal, offset);
      return cudaGetLastError();
    } else {
      auto kernel = flash_fwd_kernel<HD, TQ, TV>;
      constexpr int smem = fwd_smem_bytes<HD>();
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, smem, st>>>(
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
  return static_cast<int>(dispatch(head_dim, dtypes, [&](auto hd, auto tq,
                                                         auto tv) {
    constexpr int HD = decltype(hd)::value;
    using TQ = typename decltype(tq)::type;
    using TV = typename decltype(tv)::type;
    auto kernel = flash_bwd_dq_kernel<HD, TQ, TV>;
    constexpr int smem = dq_smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((sq + kB - 1) / kB, b * nh);
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const TQ*>(q), static_cast<const TQ*>(k),
        static_cast<const TV*>(v), static_cast<const TQ*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<TQ*>(dq), static_cast<const int*>(q_seg),
        static_cast<const int*>(kv_seg), sq, sk, nh, scale, causal, offset);
    return cudaGetLastError();
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
  return static_cast<int>(dispatch(head_dim, dtypes, [&](auto hd, auto tq,
                                                         auto tv) {
    constexpr int HD = decltype(hd)::value;
    using TQ = typename decltype(tq)::type;
    using TV = typename decltype(tv)::type;
    const dim3 grid((sk + kB - 1) / kB, b * nh);
    auto launch = [&](auto kernel, int threads, int smem) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, threads, smem, st>>>(
          static_cast<const TQ*>(q), static_cast<const TQ*>(k),
          static_cast<const TV*>(v), static_cast<const TQ*>(out),
          static_cast<const TQ*>(dout), static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<float*>(dq_acc),
          static_cast<TQ*>(dk), static_cast<TV*>(dv),
          static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
          sq, sk, nh, scale, causal, offset);
      return cudaGetLastError();
    };
    if constexpr (uses_tensor_cores<TQ, TV>()) {
      if (fused)
        return launch(flash_bwd_dkv_mma_kernel<HD, true>, kMmaThreads,
                      dkv_mma_smem_bytes<HD, true>());
      return launch(flash_bwd_dkv_mma_kernel<HD, false>, kMmaThreads,
                    dkv_mma_smem_bytes<HD, false>());
    } else {
      if (fused)
        return launch(flash_bwd_dkv_kernel<HD, TQ, TV, true>, kThreads,
                      dkv_smem_bytes<HD, true>());
      return launch(flash_bwd_dkv_kernel<HD, TQ, TV, false>, kThreads,
                    dkv_smem_bytes<HD, false>());
    }
  }));
}

// 1 if `entry` (0: hetu_flash_fwd, 1: hetu_flash_bwd_dq, 2:
// hetu_flash_bwd_dkv) launches a bf16 tensor-core kernel for these type
// codes and head dim, 0 if a scalar one, -1 if it takes neither.
int hetu_flash_uses_tensor_cores(int entry, int head_dim, int dtypes) {
  if (entry < 0 || entry > 2 || (head_dim != 64 && head_dim != 128) ||
      dtypes < 0 || dtypes > 2)
    return -1;
  // type code 1 is the (bf16, bf16) pair of `dispatch`
  return uses_tensor_cores<bf16, bf16>() && dtypes == 1 && entry != 1;
}

const char* hetu_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
