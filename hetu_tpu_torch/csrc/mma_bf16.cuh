// bf16 tensor-core building blocks shared by the port's CUDA kernels
// (sm_80 and later; built here for sm_90a): mma.sync m16n8k16 with fp32
// accumulation, ldmatrix fragment loads from shared memory and cp.async
// copies from global into shared memory.
//
// Fragment layout of mma.m16n8k16 (lane = 4 * gq + tq):
//   A (16 x 16, row-major) a0 = A[gq][2tq, 2tq+1], a1 = A[gq+8][2tq..],
//                          a2 = A[gq][2tq+8..],    a3 = A[gq+8][2tq+8..];
//   B (16 x 8, "col")      b0 = B[2tq, 2tq+1][gq], b1 = B[2tq+8..][gq];
//   C (16 x 8, fp32)       c0, c1 = C[gq][2tq, 2tq+1], c2, c3 = C[gq+8][..].
// So the C registers of a product over 16 columns are, packed to bf16,
// the A registers of the next product over those columns (FA-2's P).
//
// The ldmatrix helpers read bf16 tiles stored row-major with a row stride
// of `ld` elements; a stride of 8 past a multiple of 64 (16 bytes of pad)
// puts the eight 16-byte rows of each 8 x 8 matrix on distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same product over k = 8 (A: a0, a1 of the m16n8k16 layout, or a2,
// a3 for the upper half of k; B: b0, or b1).
__device__ __forceinline__ void mma_bf16_1688(float* c, uint32_t a0,
                                              uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A fragment of rows m0 .. m0+15, columns k0 .. k0+15 of a tile stored
// [m][k].
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* t, int ld,
                                       int m0, int k0, int lane) {
  ldmatrix_x4(a, t + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// The same A fragment from a tile stored transposed, [k][m].
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4],
                                             const __nv_bfloat16* t, int ld,
                                             int m0, int k0, int lane) {
  const int mi = lane >> 3;
  ldmatrix_x4_trans(a, t + (k0 + (mi >> 1) * 8 + (lane & 7)) * ld + m0 +
                           (mi & 1) * 8);
}

// B fragments of two n-tiles (columns n0 .. n0+7 in b[0], b[1] and
// n0+8 .. n0+15 in b[2], b[3]) at k0 .. k0+15, from a tile stored [n][k]
// (K in Q.K^T: the rows are the product's columns).
__device__ __forceinline__ void load_b(uint32_t (&b)[4],
                                       const __nv_bfloat16* t, int ld,
                                       int n0, int k0, int lane) {
  const int mi = lane >> 3;
  ldmatrix_x4(b, t + (n0 + (mi >> 1) * 8 + (lane & 7)) * ld + k0 +
                     (mi & 1) * 8);
}

// The same two B fragments from a tile stored [k][n] (V in P.V).
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                             const __nv_bfloat16* t, int ld,
                                             int n0, int k0, int lane) {
  const int mi = lane >> 3;
  ldmatrix_x4_trans(b, t + (k0 + (mi & 1) * 8 + (lane & 7)) * ld + n0 +
                           (mi >> 1) * 8);
}

// 16 bytes global -> shared, zero-filled when !valid (no bytes are read
// then; src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `kPending` of this thread's committed groups are in
// flight; the copies of the others are then visible to this thread (and,
// after a barrier, to the block).
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Output columns (of O, dQ or dK/dV) that a block of an attention kernel
// accumulates: a slice of at most kColSlice columns, picked by blockIdx.z.
// The template widths (HD 32 to 256) hold all HD up to 128 and one half at
// 256 (col_blocks() blocks along z), so that the accumulators keep the
// registers of HD 128, while S and dP are still formed over all HD columns
// from shared memory (each slice forms them again).  Wider head dims (the
// flash kernels' wide route) take col_slices(d) slices of kColSlice
// columns each.  kColSlice is csrc/build.py's COLUMN_SLICE, passed to nvcc
// as HETU_COLUMN_SLICE.
constexpr int kColSlice = HETU_COLUMN_SLICE;
static_assert(kColSlice == 128, "the register plans assume 128-column slices");

template <int HD>
__host__ __device__ constexpr int out_cols() {
  return HD > kColSlice ? kColSlice : HD;
}

template <int HD>
__host__ __device__ constexpr int col_blocks() {
  return HD / out_cols<HD>();
}

__host__ __device__ constexpr int col_slices(int d) {
  return (d + kColSlice - 1) / kColSlice;
}

}  // namespace
