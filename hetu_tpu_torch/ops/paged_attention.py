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
- ``paged_attention_cuda``: the CUDA kernel (``csrc/paged_attention.cu``,
  a launcher of the split-KV decode core ``csrc/paged_decode.cuh`` that the
  ragged kernel's decode rows share) for CUDA tensors.  Where the two
  differ: a request with ``seq_len == 0`` gives a zero row from the
  kernel (the TPU kernel's contract) and NaN from the plain version's
  all-masked softmax.

``paged_attention_decode`` dispatches on the tensors' device: the plain
version for CPU tensors, the kernel for CUDA tensors.  A kernel that
fails to build or launch raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.capture import launch_counter
from ..core.device import sm_count
from .kv_split import (CORE_HEADS, core_splits, core_workspace,
                       zeros_with_tickets)


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


def _kernel_lib():
    from ..csrc.build import load_library
    lib = load_library("paged_attention")
    fn = lib.hetu_paged_attention_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.hetu_decode_core_info.argtypes = (
            [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 4)
        lib.hetu_decode_core_info.restype = ctypes.c_int
        lib.hetu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hetu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def decode_core_info(head_dim: int, dtype: torch.dtype, page_size: int,
                     kvh: int, max_pages: int, n_splits: int) -> dict:
    """The decode core's geometry for these shapes, as the library computes
    it: positions a ring stage (``tile``), bytes a row of a stage
    (``row_bytes``), KV positions a slice (``split_len``) and a block's
    dynamic shared memory; only ``chip_smoke.py`` prints it.  Needs the
    built library (a CUDA machine)."""
    lib = _kernel_lib()
    out = [ctypes.c_int(0) for _ in range(4)]
    err = lib.hetu_decode_core_info(head_dim, _KERNEL_DTYPES[dtype],
                                    page_size, kvh, max_pages, n_splits,
                                    *map(ctypes.byref, out))
    if err != 0:
        raise RuntimeError(f"decode core info: cudaError {err}")
    return dict(zip(("tile", "row_bytes", "split_len", "smem_bytes"),
                    (x.value for x in out)))


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_tables: torch.Tensor,
                         seq_lens: torch.Tensor,
                         softmax_scale: Optional[float] = None
                         ) -> torch.Tensor:
    """The CUDA kernel (the plain version's contract, except that a
    request with ``seq_len == 0`` gives a zero row instead of NaN).
    Every tensor must lie on one CUDA device; q, k_pages and v_pages share
    a dtype (bf16 or fp32), the metadata is int32, and any head dim runs
    (the pool is read in place, never padded).  The KV axis is split into
    as many slices as the shapes and the SM count call for
    (``kv_split.core_splits``), merged in the kernel by the last slice of
    a request to finish.  ``paged_attention_cuda.launches`` counts the
    launches."""
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
    for name, x in (("page_tables", page_tables), ("seq_lens", seq_lens)):
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("paged_attention_cuda needs contiguous tensors")
    # K/V rows are copied in 16-byte (or 4-byte) pieces where the head dim
    # allows
    if any(x.data_ptr() % 16 for x in (q, k_pages, v_pages)):
        raise ValueError("paged_attention_cuda needs q, k_pages and v_pages "
                         "aligned to 16 bytes")
    lib = _kernel_lib()
    if b == 0:
        return torch.empty_like(q)
    g = nh // kvh
    n_splits = core_splits(sm_count(q.device), b, kvh, g, maxp * ps)
    out, tickets = zeros_with_tickets(q, b * kvh * -(-g // CORE_HEADS))
    # ws stays alive until the launch is enqueued
    ws, ws_acc, ws_ml = core_workspace(b, nh, n_splits, hd, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hetu_paged_attention_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            out.data_ptr(),
            ws_acc, ws_ml, tickets, page_tables.data_ptr(),
            seq_lens.data_ptr(),
            b, nh, kvh, hd, ps, maxp, n_splits, float(scale),
            _KERNEL_DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            "paged attention kernel failed: "
            f"{lib.hetu_cuda_error_string(err).decode()} (cudaError {err})")
    paged_attention_cuda.launches += 1
    return out


launch_counter(paged_attention_cuda)


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
