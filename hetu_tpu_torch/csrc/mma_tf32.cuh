// 3xTF32 tensor-core building blocks for fp32 operands (sm_80 and later;
// built here for sm_90a): the TF32 split, mma.sync m16n8k8 on TF32 with
// fp32 accumulation, the three-term product, and fragment loads from fp32
// tiles in shared memory.
//
// 3xTF32: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi) (round to
// nearest on 10 mantissa bits, as cvt.rna.tf32.f32), and a.b ~ lo_a.hi_b +
// hi_a.lo_b + hi_a.hi_b.  The dropped lo_a.lo_b and the rounding of lo are
// near 2^-22 of the product, so a product keeps about 21 of fp32's 24
// mantissa bits; each TF32 x TF32 product is exact in fp32.  A bf16 operand
// is exact in TF32 (8 mantissa bits of 10): its lo part is 0 and the
// product takes two terms.
//
// Fragment layout of mma.m16n8k8 on TF32 (lane = 4 * gq + tq):
//   A (16 x 8, row-major) a0 = A[gq][tq], a1 = A[gq+8][tq],
//                          a2 = A[gq][tq+4], a3 = A[gq+8][tq+4];
//   B (8 x 8, "col")      b0 = B[tq][gq], b1 = B[tq+4][gq];
//   C (16 x 8, fp32)      c0, c1 = C[gq][2tq, 2tq+1], c2, c3 = C[gq+8][..].
// ldmatrix reads 8 x 8 matrices of 16-bit values, which are 8 x 4 fp32
// values: thread (gq, tq) receives row gq, fp32 column tq, exactly the A
// and B registers above for tiles stored with k contiguous.  ldmatrix has
// no transpose for 32-bit values, so a B operand stored [k][n] (V in P.V,
// K in dS.K) is read by 32-bit loads; its A operand then comes straight
// from the C registers of the previous product with the k axis permuted:
// logical k = tq is column 2tq and logical k = tq + 4 is column 2tq + 1
// (a = {c0, c2, c1, c3}), and the B loads take rows k0 + 2tq and
// k0 + 2tq + 1.  fp32 tiles use a row stride of HD + 4 floats (16 bytes
// of pad), which keeps both the ldmatrix rows and the 32-bit loads of
// rows 2tq, 2tq + 1 on distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

// x rounded to TF32 (to nearest, ties away from zero), as fp32 bits: what
// cvt.rna.tf32.f32 gives for a finite x, in two integer instructions
// (half of the 13 dropped bits added to the magnitude, then cleared);
// ptxas expands cvt.rna.tf32.f32 into compares and selects that also
// handle NaN and infinity, and the kernels split every operand they read.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi[i] = tf32(x[i]), lo[i] = tf32(x[i] - hi[i]) for N fp32 values (given
// as floats or as their bits)
template <int N, typename T>
__device__ __forceinline__ void split_tf32(const T (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float f;
    if constexpr (std::is_same<T, float>::value)
      f = x[i];
    else
      f = __uint_as_float(x[i]);
    hi[i] = to_tf32(f);
    lo[i] = to_tf32(f - __uint_as_float(hi[i]));
  }
}

__device__ __forceinline__ void mma_tf32_1688(float* c, const uint32_t* a,
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32, the small terms first, in the tensor cores' fp32
// accumulator.  That accumulation does not round to nearest: chained over
// a long sum (O over every KV tile, dQ over every key) it keeps fewer bits
// than fp32 adds, so callers chain it over one tile at most and add the
// tile's sum to their running total in fp32.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* a_hi,
                                           const uint32_t* a_lo,
                                           const uint32_t* b_hi,
                                           const uint32_t* b_lo) {
  mma_tf32_1688(c, a_lo, b_hi[0], b_hi[1]);
  mma_tf32_1688(c, a_hi, b_lo[0], b_lo[1]);
  mma_tf32_1688(c, a_hi, b_hi[0], b_hi[1]);
}

// c[i] += t[i] for the 4 registers of a C fragment, in fp32
__device__ __forceinline__ void add_c(float* c, const float* t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// A fragment of rows m0 .. m0+15, columns k0 .. k0+7 of an fp32 tile
// stored [m][k] with a row stride of `ld` floats.
__device__ __forceinline__ void load_a_f32(uint32_t (&a)[4], const float* t,
                                           int ld, int m0, int k0, int lane) {
  ldmatrix_x4(a, t + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 4);
}

// B fragments of two n-tiles (columns n0 .. n0+7 in b[0], b[1] and
// n0+8 .. n0+15 in b[2], b[3]) at k0 .. k0+7, from an fp32 tile stored
// [n][k] (K in Q.K^T, V in dO.V^T).
__device__ __forceinline__ void load_b_f32(uint32_t (&b)[4], const float* t,
                                           int ld, int n0, int k0, int lane) {
  const int mi = lane >> 3;
  ldmatrix_x4(b, t + (n0 + (mi >> 1) * 8 + (lane & 7)) * ld + k0 +
                     (mi & 1) * 4);
}

// The B fragment of n-tile n0 .. n0+7 over rows k0 .. k0+7 of an fp32 tile
// stored [k][n], with k permuted as a_from_c permutes it.
__device__ __forceinline__ void load_b_f32_trans(float (&b)[2], const float* t,
                                                 int ld, int n0, int k0,
                                                 int lane) {
  const float* p = t + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  b[0] = p[0];
  b[1] = p[ld];
}

// The A fragment (16 rows x 8 columns) held in the C registers c of the
// previous product, in the k order of load_b_f32_trans.
__device__ __forceinline__ void a_from_c(float (&a)[4], const float* c) {
  a[0] = c[0];
  a[1] = c[2];
  a[2] = c[1];
  a[3] = c[3];
}

// A bf16 value as the fp32 (and exact TF32) bits of the same number.
__device__ __forceinline__ uint32_t bf16_as_tf32(__nv_bfloat16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x)) << 16;
}

}  // namespace
