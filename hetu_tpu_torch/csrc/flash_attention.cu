// Flash attention forward and backward for Hopper (sm_90a), CUDA C++ with
// plain C entries.
//
// Replaces the four Pallas TPU kernels of
// hetu_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel        <- :178 `_fwd_kernel`       (driver `_flash_fwd`)
//   flash_bwd_fused_kernel  <- :325 `_bwd_fused_kernel` (`_flash_bwd_fused`)
//   flash_bwd_dq_kernel     <- :466 `_bwd_dq_kernel`    (`_flash_bwd_split`)
//   flash_bwd_dkv_kernel    <- :510 `_bwd_dkv_kernel`   (`_flash_bwd_split`)
// Same functions: q [b, sq, h, d], k/v [b, sk, h, d] (equal head counts),
// scores q.k * scale taken as base-2 logits (scale * log2(e) folded into
// q, here in fp32), causal with a diagonal offset (key j is visible to
// query i iff j <= i + offset), optional segment ids per token (q_ids
// [b, sq], kv_ids [b, sk]: equal ids see each other).  The forward returns
// out in q's type and lse [b, h, sq] (fp32, natural log); a row that sees
// no key gives out = 0 and lse = -inf, and in the backward p = 0 wherever
// the key is masked or the row's lse is -inf, so such rows get zero
// gradients.  Rounding follows the TPU kernels: p is rounded to v's type
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
// What the design does about it, and what it does not yet do:
//  - One block owns one (batch, head) and one tile of 64 rows, and loops
//    over the other axis itself: the forward and dq over KV tiles (their
//    TPU grids carried that loop in VMEM scratch), dk/dv and the fused
//    kernel over q tiles.  Tiles live in shared memory as fp32, 64 x (d+4)
//    floats (the pad keeps the 16-byte reads of a warp on distinct banks).
//    256 threads each hold a 4 x 4 block of the 64 x 64 score tile and a
//    4 x d/16 block of the output tile in registers.
//  - Tiles wholly above the causal diagonal are never loaded, as the TPU
//    kernels skip them (`run`, :237): the forward and dq stop the KV loop
//    at the tile's last visible key, dk/dv start the q loop at the first
//    q row that sees the KV tile.  Any sq and sk: the ragged edge is
//    masked.  Tiles are read in place from [b, s, h, d] with a stride of
//    h*d between tokens; out/dq/dk/dv are written in that layout.
//  - Fused backward: the TPU kept dk/dv for the whole sequence in VMEM per
//    (batch, head); here a block owns one KV tile's dk/dv in registers,
//    loops over the q tiles, computes delta = rowsum(do * o) itself and
//    adds its share of dq into an fp32 workspace with atomicAdd (summed
//    in an order that changes from run to run).  The split kernels are
//    deterministic and take delta from one torch op outside.
//  - Every product is scalar fp32 FMA on the CUDA cores, which keeps the
//    fp32 path exact to fp32 rounding (no TF32) and is far from the bound.
//    Not yet: mma.sync / wgmma for bf16 operands, cp.async or TMA
//    pipelining of the tiles, and more than one block per SM (the fp32
//    tiles take 119 to 188 KB of shared memory at d = 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

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
// launchers
// ---------------------------------------------------------------------------

template <typename T>
struct Tag {
  using type = T;
};

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
    auto kernel = flash_fwd_kernel<HD, TQ, TV>;
    constexpr int smem = fwd_smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((sq + kB - 1) / kB, b * nh);
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const TQ*>(q), static_cast<const TQ*>(k),
        static_cast<const TV*>(v), static_cast<TQ*>(out),
        static_cast<float*>(lse), static_cast<const int*>(q_seg),
        static_cast<const int*>(kv_seg), sq, sk, nh, scale * kLog2e, causal,
        offset);
    return cudaGetLastError();
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
    auto launch = [&](auto kernel, int smem) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((sk + kB - 1) / kB, b * nh);
      kernel<<<grid, kThreads, smem, st>>>(
          static_cast<const TQ*>(q), static_cast<const TQ*>(k),
          static_cast<const TV*>(v), static_cast<const TQ*>(out),
          static_cast<const TQ*>(dout), static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<float*>(dq_acc),
          static_cast<TQ*>(dk), static_cast<TV*>(dv),
          static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
          sq, sk, nh, scale, causal, offset);
      return cudaGetLastError();
    };
    if (fused)
      return launch(flash_bwd_dkv_kernel<HD, TQ, TV, true>,
                    dkv_smem_bytes<HD, true>());
    return launch(flash_bwd_dkv_kernel<HD, TQ, TV, false>,
                  dkv_smem_bytes<HD, false>());
  }));
}

const char* hetu_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
