// Hopper (sm_90a) building blocks of the bf16 flash kernels: warpgroup
// matrix multiply (wgmma.mma_async) with its shared-memory descriptors,
// TMA tile loads into shared memory through a tensor map, mbarrier waits
// and arrivals, named barriers and setmaxnreg, and the host's encoding of
// a tensor map.
//
// Layout of a tile in shared memory: R rows of 64 bf16 columns (128
// bytes) in the 128-byte swizzle that TMA writes (the 16-byte chunk c of
// row r lands at chunk c ^ (r % 8)), 1024-byte aligned; a tile of HD
// columns is HD / 64 such column halves, one after the other.  A wgmma
// operand in it is read through a descriptor (wgmma_desc) in either
// major-ness:
//   K-major (the reduction axis runs along a row: K of Q.K^T, Q of S^T):
//     8-row groups 1024 bytes apart (SBO), k-step kk of 16 columns at
//     byte 32 * (kk % 4) of column half kk / 4;
//   MN-major (the reduction axis runs down the rows: V of P.V, dO of
//     P^T.dO, Q of dS^T.Q, K and dS of dS.K; the "transpose" bit):
//     k-step kk at row 16 kk, 8-row groups 1024 bytes apart (SBO), the
//     next 64 columns of M or N a column half further (LBO).
// The wgmma accumulator of m64nNk16 holds, in warp w of the warpgroup and
// lane 4 gq + tq, d[4 j + i] = C[16 w + gq + 8 (i / 2)][8 j + 2 tq + i % 2]
// (mma.sync's C layout, warp w owning rows 16 w ..); the register A
// operand of a k-step is mma.sync's A fragment for the warp's 16 rows, so
// the C registers of a product over 16 columns, packed to bf16 pairs,
// are the A registers of the next product over those columns.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr int kSwizzleBytes = 128;          // a swizzled row: 64 bf16
constexpr int kSwizzleAtom = 8 * kSwizzleBytes;  // an 8-row group

// shared address p rounded up to the swizzle atom's alignment
__device__ __forceinline__ uint8_t* align_atom(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + ((kSwizzleAtom - (a % kSwizzleAtom)) % kSwizzleAtom);
}

// 2^x by the special function unit, results below 2^-126 flushed to 0 (a
// probability that small adds nothing a bf16 product can carry); exp2f
// rescales around each call for them
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// mbarriers, named barriers, fences
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// an arrival that also announces `bytes` of TMA transactions
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed
// (a fresh barrier is in phase 0: waiting on parity 1 passes at once).  A
// plain spin on try_wait: a timeout that traps here would keep ptxas from
// giving the consumer warpgroups the registers setmaxnreg grants them.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// barrier `id` (1 .. 15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// orders this thread's ordinary stores to shared memory before later reads
// of the async proxy (wgmma operands, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int kRegs>
__device__ __forceinline__ void warpgroup_reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void warpgroup_reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// One box of a 4-D tensor map at coordinates (c0 innermost .. c3) into
// shared memory at dst; completes `bar`'s transactions by the box's bytes
// (out-of-bounds elements are written as zeros and counted).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 2-D tensor map at coordinates (c0 innermost, c1): the same
// completion and zero fill as tma_load_4d.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// The descriptor of an operand at shared address base + off (128-byte
// swizzle), with leading and stride byte offsets as the layout note above
// has them.  Built inside one asm statement, where the wgmma needs it: the
// compiler would otherwise compute the descriptors of every k-step once and
// keep them all in registers beside the accumulators.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t base, uint32_t off,
                                               uint32_t lbo,
                                               uint32_t sbo = kSwizzleAtom) {
  uint64_t d;
  asm volatile(
      "{\n"
      ".reg .b32 lo;\n"
      "add.u32 lo, %1, %2;\n"
      "shr.u32 lo, lo, 4;\n"
      "and.b32 lo, lo, 0x3FFF;\n"
      "or.b32 lo, lo, %3;\n"
      "mov.b64 %0, {lo, %4};\n"
      "}\n"
      : "=l"(d)
      : "r"(base), "r"(off), "r"(((lbo >> 4) & 0x3FFF) << 16),
        "r"(((sbo >> 4) & 0x3FFF) | (1u << 30)));
  return d;
}

// K-major operand of k-step kk (columns 16 kk ..): rows r0 .. r0 + 63 (or
// all N rows) of a swizzled [rows][HD] tile at shared address `tile`
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int rows,
                                                 int r0, int kk) {
  return wgmma_desc(tile,
                    ((kk / 4) * rows + r0) * kSwizzleBytes + (kk % 4) * 32,
                    16);
}

// MN-major operand of k-step kk (tile rows 16 kk ..), its M or N axis
// along the columns from byte `col` of the first column half (the
// transpose bit: V of P.V, whose reduction axis runs down the rows)
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int rows,
                                                  int kk, int col = 0) {
  return wgmma_desc(tile, kk * 16 * kSwizzleBytes + col,
                    rows * kSwizzleBytes);
}

// descriptor d moved on by `bytes` (a multiple of 16 that keeps the
// operand inside the same 256 KB of shared memory), added where the wgmma
// needs it, as wgmma_desc is built
__device__ __forceinline__ uint64_t desc_plus(uint64_t d, uint32_t bytes) {
  uint64_t r;
  asm volatile("add.s64 %0, %1, %2;\n"
               : "=l"(r) : "l"(d), "l"(static_cast<uint64_t>(bytes >> 4)));
  return r;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// the same for register A operands, which an asynchronous wgmma reads until
// its group is waited for: fenced after the wait, they stay in place until
// then
template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[m][r]) :: "memory");
}

// D (+)= A B over k = 16: A (64 x 16) and B (16 x N) from shared memory
// (SS) or A from registers (RS); TA / TB the transpose (MN-major) bits;
// scale_d = 0 overwrites D.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32<TA, TB>(d, da, db, scale_d);
  if constexpr (N == 64) wgmma_ss_n64<TA, TB>(d, da, db, scale_d);
  if constexpr (N == 128) wgmma_ss_n128<TA, TB>(d, da, db, scale_d);
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_rs_n64<TB>(d, a, db, scale_d);
  if constexpr (N == 128) wgmma_rs_n128<TB>(d, a, db, scale_d);
}

// acc = the sum over k-steps kk < kSteps of the SS products of (da(kk),
// db(kk)) (both K-major), each product in a zeroed accumulator and added
// in fp32, two in flight: the tensor cores' own accumulation along a chain
// keeps fewer bits than round-to-nearest fp32 additions.  Waits for every
// wgmma group of the warpgroup.
template <int N, int kSteps, typename DA, typename DB>
__device__ __forceinline__ void wgmma_ss_sum(float (&acc)[N / 2], DA&& da,
                                             DB&& db) {
  float t[2][N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = t[0][i] = t[1][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    wgmma_fence();
    wgmma_ss<N, 0, 0>(t[kk & 1], da(kk), db(kk), 0);
    wgmma_commit();
    if (kk > 0) {
      wgmma_wait<1>();
      fence_regs(t[(kk - 1) & 1]);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] += t[(kk - 1) & 1][i];
    }
  }
  wgmma_wait<0>();
  fence_regs(t[(kSteps - 1) & 1]);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] += t[(kSteps - 1) & 1][i];
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded, so that the
// library links nothing beyond the runtime; null if the driver lacks it
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// how TMA writes every tile: the 128-byte swizzle that the descriptors read
constexpr CUtensorMapSwizzle kTmaSwizzle = CU_TENSOR_MAP_SWIZZLE_128B;

// rows of a TMA box: every box is 64 rows of 64 bf16 columns (8 KB)
constexpr int kBoxRows = 64;
constexpr int kBoxBytes = kBoxRows * kSwizzleBytes;

// The tensor map of a contiguous bf16 tensor [b, s, h, d] (d a multiple of
// 64), read in place: 4-D over (d, h, s, b) with byte strides, boxes of 64
// columns of one head and kBoxRows tokens, 128-byte swizzle, rows past s
// read as zeros.
cudaError_t encode_bshd(CUtensorMap* map, const void* ptr, int b, int s,
                        int h, int d) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(d) * 2;
  const cuuint64_t strides[3] = {row, row * h, row * h * s};
  const cuuint32_t box[4] = {64, 1, kBoxRows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        kTmaSwizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a bf16 pool read as rows: 2-D over (width, rows),
// `width` a multiple of 64 contiguous values a row, boxes of 64 columns
// and `box_rows` rows, 128-byte swizzle; a row coordinate at or past `rows`
// reads as zeros.  Built on the host and passed to a kernel by value
// (__grid_constant__), so a captured launch keeps its own copy.
cudaError_t encode_rows(CUtensorMap* map, const void* ptr, int64_t rows,
                        int width, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(width) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        kTmaSwizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
