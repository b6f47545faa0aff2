// Paged decode attention for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: hetu_tpu/ops/paged_attention.py:113 `_paged_kernel` (driven by
// `paged_attention_pallas`, reached through `paged_attention_decode`).  Same
// function: one decode token per request, q [B, nh, hd], attends to the
// first seq_lens[b] KV positions (the token just written included) gathered
// through page_tables[b] from k/v pages [P, ps, kvh, hd]; query head h reads
// KV head h / (nh / kvh).  Accumulation is fp32, the output is in q's type,
// pages past seq_len are never read, and a request with seq_len == 0 keeps
// the zero row the caller allocated (the TPU kernel's contract).
//
// What bounds it on an H100: every cached K and V element is used once per
// query head of its group (2 * g operations per element), far below the
// card's ~20 fp32 operations a byte: the kernel is bound by the bytes of the
// KV pages, 2 * seq_len * kvh * hd * itemsize per request.
//
// What the design does about it: the kernel is a launcher of the split-KV
// decode core (paged_decode.cuh, shared with the ragged kernel's decode
// rows): one block per (request, KV head, up to 4 query heads of its group,
// column slice, KV slice), the K/V tiles streamed through a cp.async ring,
// the slices merged by the last block of a request to finish.  The slice
// count comes from the shapes alone (the wrapper), so nothing is read back
// to the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "paged_decode.cuh"

namespace {

// blockIdx.x = (((b * kvh + h) * head_chunks + hc) * cslices + cs) * n_splits
//              + split
template <typename T>
__global__ void __launch_bounds__(kCoreThreads, 3)
paged_attention_decode_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              T* __restrict__ out, float* __restrict__ ws_acc,
                              float* __restrict__ ws_ml,
                              int* __restrict__ tickets,
                              const int* __restrict__ page_tables,
                              const int* __restrict__ seq_lens, int nh,
                              CoreGeom geom) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = nh / geom.kvh;
  const int hcs = core_head_chunks(g);
  int bx = blockIdx.x;
  const int split = bx % geom.n_splits;
  bx /= geom.n_splits;
  const int cs = bx % geom.cslices;
  bx /= geom.cslices;
  const int hc = bx % hcs;
  bx /= hcs;
  const int h = bx % geom.kvh;
  const int b = bx / geom.kvh;

  const int n_pos = min(seq_lens[b], geom.maxp * geom.ps);
  const int begin = split * geom.split_len;
  if (begin >= n_pos) return;  // a slice past the context, or seq_len 0
  const int end = min(n_pos, begin + geom.split_len);
  const int n_live = (n_pos + geom.split_len - 1) / geom.split_len;
  const int head0 = h * g + hc * kCoreHeads;
  const int nq = min(kCoreHeads, g - hc * kCoreHeads);
  const int64_t row = static_cast<int64_t>(b) * nh + head0;
  decode_core<T>(geom, q + row * geom.hd, out + row * geom.hd, k_pages,
                 v_pages, page_tables + static_cast<int64_t>(b) * geom.maxp,
                 h, nq, begin, end, split, n_live, cs, ws_acc, ws_ml, row,
                 tickets + (static_cast<int64_t>(b) * geom.kvh + h) * hcs + hc,
                 smem);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   void* out, float* ws_acc, float* ws_ml, int* tickets,
                   const int* page_tables, const int* seq_lens, int batch,
                   int nh, int kvh, int hd, int ps, int maxp, int n_splits,
                   float scale, cudaStream_t stream) {
  auto kernel = paged_attention_decode_kernel<T>;
  const CoreGeom geom = core_geometry(hd, static_cast<int>(sizeof(T)), ps,
                                      kvh, maxp, n_splits, scale);
  const int smem = core_smem_bytes(geom, static_cast<int>(sizeof(T)));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(batch) * kvh *
                         core_head_chunks(nh / kvh) * geom.cslices * n_splits;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kCoreThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<T*>(out), ws_acc, ws_ml,
      tickets, page_tables, seq_lens, nh, geom);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// dtype: 0 = float32, 1 = bfloat16; any head_dim.  The caller zeroes `out`
// and `tickets` [B, kvh, ceil(nh / kvh / 4)] (int32; every call leaves them
// 0 again) and, with n_splits > 1, gives fp32 workspaces ws_acc [B, nh,
// n_splits, head_dim] and ws_ml [B, nh, n_splits, 2]; the kernel allocates
// nothing.
int hetu_paged_attention_decode(const void* q, const void* k_pages,
                                const void* v_pages, void* out, void* ws_acc,
                                void* ws_ml, void* tickets,
                                const void* page_tables,
                                const void* seq_lens, int batch, int nh,
                                int kvh, int head_dim, int ps, int maxp,
                                int n_splits, float scale, int dtype,
                                void* stream) {
  if (batch < 1 || kvh < 1 || nh % kvh != 0 || ps < 1 || maxp < 1 ||
      head_dim < 1 || n_splits < 1 || n_splits > kCoreMaxSplits ||
      tickets == nullptr ||
      (n_splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* wa = static_cast<float*>(ws_acc);
  auto* wm = static_cast<float*>(ws_ml);
  auto* tk = static_cast<int*>(tickets);
  const auto* ptab = static_cast<const int*>(page_tables);
  const auto* sl = static_cast<const int*>(seq_lens);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = launch<float>(q, k_pages, v_pages, out, wa, wm, tk, ptab, sl, batch,
                        nh, kvh, head_dim, ps, maxp, n_splits, scale, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k_pages, v_pages, out, wa, wm, tk, ptab,
                                sl, batch, nh, kvh, head_dim, ps, maxp,
                                n_splits, scale, st);
  return static_cast<int>(err);
}

// The geometry the core takes for these shapes: positions a ring stage,
// bytes a row of a stage, KV positions a slice and the dynamic shared
// memory of a block; returns a cudaError_t.  Only chip_smoke.py prints it.
int hetu_decode_core_info(int head_dim, int dtype, int ps, int kvh, int maxp,
                          int n_splits, int* tile, int* ld, int* split_len,
                          int* smem_bytes) {
  if (head_dim < 1 || (dtype != 0 && dtype != 1) || ps < 1 || maxp < 1 ||
      n_splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int item = dtype == 0 ? 4 : 2;
  const CoreGeom g = core_geometry(head_dim, item, ps, kvh, maxp, n_splits,
                                   1.f);
  *tile = g.tile;
  *ld = g.ld;
  *split_len = g.split_len;
  *smem_bytes = core_smem_bytes(g, item);
  return 0;
}

const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
