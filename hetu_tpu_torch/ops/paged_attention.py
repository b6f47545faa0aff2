"""Paged decode attention: GQA decode against a block-paged KV pool
(PyTorch port of ``hetu_tpu.ops.paged_attention``).

One decode token per request, ``q [B, nh, hd]``, attends to the first
``seq_lens[b]`` KV positions (the token just written included) gathered
through ``page_tables [B, maxp]`` from ``k_pages``/``v_pages`` ``[P, ps,
kvh, hd]``; query head h reads KV head ``h // (nh // kvh)``.  The output
``[B, nh, hd]`` is in q's dtype.

Two implementations:

- ``paged_attention_reference``: the plain PyTorch version, a gather of
  the page table and masked dense fp32 attention (``-inf`` mask).  It
  runs wherever its tensors are and is the CPU path.
- ``paged_attention_cuda``: the CUDA kernel (``csrc/paged_attention.cu``)
  for CUDA tensors.  Where the two differ: a request with ``seq_len ==
  0`` gives a zero row from the kernel (the TPU kernel's contract) and
  NaN from the plain version's all-masked softmax.

``paged_attention_decode`` dispatches on the tensors' device: the plain
version for CPU tensors, the kernel for CUDA tensors.  A kernel that
fails to build or launch raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.device import sm_count
from ..csrc.build import KERNEL_HEAD_DIMS


def _check_shapes(q, k_pages, v_pages, page_tables, seq_lens):
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be [B, nh, hd] and pages [P, ps, kvh, hd], "
                         f"got {tuple(q.shape)} and {tuple(k_pages.shape)}")
    b, nh, hd = q.shape
    p_, ps, kvh, hd2 = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(f"k_pages {tuple(k_pages.shape)} != v_pages "
                         f"{tuple(v_pages.shape)}")
    if hd != hd2:
        raise ValueError(f"head_dim mismatch: q {hd} vs pages {hd2}")
    if nh % kvh != 0:
        raise ValueError(f"num_heads {nh} not divisible by kv_heads {kvh}")
    if page_tables.ndim != 2 or page_tables.shape[0] != b:
        raise ValueError(f"page_tables must be [B, max_pages], got "
                         f"{tuple(page_tables.shape)}")
    if tuple(seq_lens.shape) != (b,):
        raise ValueError(f"seq_lens must be [B], got "
                         f"{tuple(seq_lens.shape)}")
    return b, nh, hd, ps, kvh


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              page_tables: torch.Tensor,
                              seq_lens: torch.Tensor,
                              softmax_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version: gather each request's pages in position
    order into ``[B, maxp*ps, kvh, hd]`` and run masked dense fp32
    attention.  ``seq_lens`` counts the token just written."""
    b, nh, hd, ps, kvh = _check_shapes(q, k_pages, v_pages, page_tables,
                                       seq_lens)
    maxp = page_tables.shape[1]
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    pt = page_tables.long()
    k = k_pages[pt].reshape(b, maxp * ps, kvh, hd).float()
    v = v_pages[pt].reshape(b, maxp * ps, kvh, hd).float()
    g = nh // kvh
    qg = q.reshape(b, kvh, g, hd).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) * scale
    valid = torch.arange(maxp * ps, device=q.device)[None] \
        < seq_lens[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    out = torch.einsum("bhgs,bshd->bhgd", torch.softmax(s, dim=-1), v)
    return out.reshape(b, nh, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEADS_PER_BLOCK = 4          # kHeads of the kernel
_MIN_SPLIT_LEN = 128          # KV positions a slice holds at least


def _kernel_lib():
    from ..csrc.build import load_library
    lib = load_library("paged_attention")
    fn = lib.hetu_paged_attention_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.hetu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hetu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _kv_splits(device, blocks: int, capacity: int) -> int:
    """Slices of the KV axis: enough blocks for four per SM, none shorter
    than ``_MIN_SPLIT_LEN`` positions of the page table's capacity."""
    want = -(-4 * sm_count(device) // blocks)
    return max(1, min(want, capacity // _MIN_SPLIT_LEN))


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_tables: torch.Tensor,
                         seq_lens: torch.Tensor,
                         softmax_scale: Optional[float] = None
                         ) -> torch.Tensor:
    """The CUDA kernel (the plain version's contract, except that a
    request with ``seq_len == 0`` gives a zero row instead of NaN).
    Every tensor must lie on one CUDA device; q, k_pages and v_pages share
    a dtype (bf16 or fp32), head_dim is 1 to 256 (the pool is read in
    place, never padded), and the metadata is int32.  ``paged_attention_cuda.launches`` counts the launches."""
    b, nh, hd, ps, kvh = _check_shapes(q, k_pages, v_pages, page_tables,
                                       seq_lens)
    maxp = page_tables.shape[1]
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    tensors = (q, k_pages, v_pages, page_tables, seq_lens)
    if any(x.device != q.device or x.device.type != "cuda"
           for x in tensors):
        raise ValueError("paged_attention_cuda needs every tensor on one "
                         "CUDA device")
    if q.dtype not in _KERNEL_DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"q/k_pages/v_pages must share a dtype in "
                         f"{list(_KERNEL_DTYPES)}, got {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}")
    if not 1 <= hd <= KERNEL_HEAD_DIMS[-1]:
        raise ValueError(f"head_dim {hd} not supported; the kernel takes "
                         f"1 to {KERNEL_HEAD_DIMS[-1]}")
    for name, x in (("page_tables", page_tables), ("seq_lens", seq_lens)):
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("paged_attention_cuda needs contiguous tensors")
    # a lane reads its elements of q, K and V as one vector where the head
    # dim allows
    if any(x.data_ptr() % 16 for x in (q, k_pages, v_pages)):
        raise ValueError("paged_attention_cuda needs q, k_pages and v_pages "
                         "aligned to 16 bytes")
    lib = _kernel_lib()
    out = torch.empty_like(q)
    if b == 0:
        return out
    chunks = -(-(nh // kvh) // _HEADS_PER_BLOCK)
    n_splits = _kv_splits(q.device, b * kvh * chunks, maxp * ps)
    ws_acc = ws_ml = None
    if n_splits > 1:
        ws_acc = torch.empty((b, nh, n_splits, hd), dtype=torch.float32,
                             device=q.device)
        ws_ml = torch.empty((b, nh, n_splits, 2), dtype=torch.float32,
                            device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hetu_paged_attention_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            out.data_ptr(),
            ws_acc.data_ptr() if ws_acc is not None else None,
            ws_ml.data_ptr() if ws_ml is not None else None,
            page_tables.data_ptr(), seq_lens.data_ptr(),
            b, nh, kvh, hd, ps, maxp, n_splits, float(scale),
            _KERNEL_DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            "paged attention kernel failed: "
            f"{lib.hetu_cuda_error_string(err).decode()} (cudaError {err})")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


def paged_attention_decode(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_tables: torch.Tensor,
                           seq_lens: torch.Tensor,
                           softmax_scale: Optional[float] = None
                           ) -> torch.Tensor:
    """Dispatch on q's device: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_tables,
                                         seq_lens,
                                         softmax_scale=softmax_scale)
    if q.device.type == "cuda":
        return paged_attention_cuda(q, k_pages, v_pages, page_tables,
                                    seq_lens, softmax_scale=softmax_scale)
    raise ValueError(f"no paged attention for device {q.device}")
