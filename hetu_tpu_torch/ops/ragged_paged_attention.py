"""Ragged paged attention: mixed prefill chunks + decode in ONE call
(PyTorch port of ``hetu_tpu.ops.ragged_paged_attention``).

The query side is a flat token axis ``q [T, nh, hd]``; raggedness is
described by four int32 arrays:

  ===============  =======================================================
  ``q_lens   [S]``  query tokens this step (0 = padding row)
  ``cu_q   [S+1]``  row i owns ``q[cu_q[i] : cu_q[i] + q_lens[i]]``
  ``page_tables``   ``[S, maxp]`` physical KV page ids (padding slots
                    point at the reserved trash page)
  ``ctx_lens [S]``  total KV length *including* this step's tokens
  ===============  =======================================================

Query j of row i sits at absolute position ``ctx_lens[i] - q_lens[i] +
j`` and attends every KV position at or before it.  Query head h reads
KV head ``h // (nh // kvh)``.  At most ``max_q`` tokens of a row are
attended; tokens that belong to no row are 0 in the output.

Two implementations with that contract:

- ``ragged_paged_attention_reference``: the plain PyTorch version, a
  per-row gather of the page table and masked fp32 attention.  It runs
  wherever its tensors are and is the CPU path.
- ``ragged_paged_attention_cuda``: the CUDA kernel
  (``csrc/ragged_paged_attention.cu``) for CUDA tensors: decode rows
  through the split-KV decode core (``csrc/paged_decode.cuh``), prefill
  chunks on the tensor cores (bf16) or in scalar fp32, any head dim.

``ragged_paged_attention`` dispatches on the tensors' device: the plain
version for CPU tensors, the kernel for CUDA tensors.  A kernel that
fails to build or launch raises; there is no fallback.

The MLA latent variants (``latent_*``) run the same ragged contract
against ONE compressed KV stream per layer: ``c_pages [P, ps, 1, w]``
(bf16/fp32 latents, int8 codes, or packed 4-bit codes at ``w = d_c / 2``,
the quantized ones with a per-token absmax sidecar ``scale_pages [P, ps,
1, 1]``) and an optional decoupled-rope key stream ``r_pages [P, ps, 1,
d_r]``.  The query arrives weight-absorbed, ``q [T, nh, d_c + d_r]``, so
scores are MQA dot products in latent space and the output stays latent
(``[T, nh, d_c]`` fp32); the caller folds ``v_up`` in per query token.
``latent_ragged_paged_attention`` dispatches like the full-head entry
point: the plain version for CPU tensors, the CUDA kernel
(``csrc/latent_ragged_paged_attention.cu``) for CUDA tensors, no
fallback; :func:`latent_route` names the kernel's route (wgmma for bf16
pages at the widths, page sizes and batches it covers, split TF32
``mma.sync`` otherwise).

The module also holds the serving step's on-device sampler
(``sample_rows``) and the speculative verify head beside it
(``speculative_verify_head``), plain torch ops like the JAX head.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..core.capture import launch_counter
from ..core.device import sm_count
from .kv_split import (CORE_HEADS, core_splits, core_workspace, kv_splits,
                       zeros_with_tickets)

# finite mask value of the TPU kernels (-0.7 * float32 max): masked
# scores stay finite, so a fully-masked row never produces NaN
DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def _check_ragged_shapes(q, k_pages, v_pages, q_lens, cu_q, page_tables,
                         ctx_lens, max_q):
    t, nh, hd = q.shape
    p_, ps, kvh, hd2 = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(f"k_pages {tuple(k_pages.shape)} != v_pages "
                         f"{tuple(v_pages.shape)}")
    if hd != hd2:
        raise ValueError(f"head_dim mismatch: q {hd} vs pages {hd2}")
    if nh % kvh != 0:
        raise ValueError(f"num_heads {nh} not divisible by kv_heads {kvh}")
    s = q_lens.shape[0]
    if tuple(cu_q.shape) != (s + 1,):
        raise ValueError(f"cu_q must be [S+1]={s + 1}, got "
                         f"{tuple(cu_q.shape)}")
    if page_tables.ndim != 2 or page_tables.shape[0] != s:
        raise ValueError(f"page_tables must be [S, maxp], got "
                         f"{tuple(page_tables.shape)}")
    if tuple(ctx_lens.shape) != (s,):
        raise ValueError(f"ctx_lens must be [S], got "
                         f"{tuple(ctx_lens.shape)}")
    if not 1 <= int(max_q):
        raise ValueError(f"max_q must be >= 1, got {max_q}")
    return t, nh, hd, ps, kvh, s


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def ragged_paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                                     v_pages: torch.Tensor,
                                     q_lens: torch.Tensor,
                                     cu_q: torch.Tensor,
                                     page_tables: torch.Tensor,
                                     ctx_lens: torch.Tensor, *, max_q: int,
                                     softmax_scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """Plain PyTorch version of the ragged contract: per row, gather its
    pages in position order and run masked fp32 attention for the row's
    tokens.  Returns ``[T, nh, hd]`` in q's dtype, 0 on tokens that
    belong to no row."""
    t, nh, hd, ps, kvh, s = _check_ragged_shapes(
        q, k_pages, v_pages, q_lens, cu_q, page_tables, ctx_lens, max_q)
    maxp = page_tables.shape[1]
    g = nh // kvh
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    kk = maxp * ps
    kv_pos = torch.arange(kk, device=q.device)
    out = torch.zeros_like(q)
    ql, cu, cl = q_lens.tolist(), cu_q.tolist(), ctx_lens.tolist()
    for i in range(s):
        start, ctx = int(cu[i]), int(cl[i])
        n = min(int(ql[i]), int(max_q), t - start)
        if n <= 0:
            continue
        qg = q[start:start + n].reshape(n, kvh, g, hd).float()
        pt = page_tables[i].long()
        k = k_pages[pt].reshape(kk, kvh, hd).float()
        v = v_pages[pt].reshape(kk, kvh, hd).float()
        sc = torch.einsum("qhgd,khd->qhgk", qg, k) * scale
        qpos = (ctx - int(ql[i])) + torch.arange(n, device=q.device)
        valid = kv_pos[None, :] <= qpos[:, None]
        sc = sc.masked_fill(~valid[:, None, None, :], DEFAULT_MASK_VALUE)
        pr = torch.softmax(sc, dim=-1)
        o = torch.einsum("qhgk,khd->qhgd", pr, v)
        out[start:start + n] = o.reshape(n, nh, hd).to(q.dtype)
    return out


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel_lib():
    from ..csrc.build import load_library
    lib = load_library("ragged_paged_attention")
    fn = lib.hetu_ragged_paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.hetu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hetu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def ragged_paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, q_lens: torch.Tensor,
                                cu_q: torch.Tensor, page_tables: torch.Tensor,
                                ctx_lens: torch.Tensor, *, max_q: int,
                                softmax_scale: Optional[float] = None
                                ) -> torch.Tensor:
    """The CUDA kernel (same contract as the plain version).  Every
    tensor must lie on one CUDA device; q, k_pages and v_pages share a
    dtype (bf16 or fp32), the metadata is int32, and any head dim runs
    (the pool is read in place, never padded).  One launch: the decode
    rows (q_len 1) split over the KV axis into as many slices as the
    shapes and the SM count call for (``kv_split.core_splits``, never the
    rows' values), merged in the kernel by the last slice to finish; the
    other rows unsplit.  The output is allocated zeroed here and the
    kernel writes only real tokens.
    ``ragged_paged_attention_cuda.launches`` counts the launches."""
    t, nh, hd, ps, kvh, s = _check_ragged_shapes(
        q, k_pages, v_pages, q_lens, cu_q, page_tables, ctx_lens, max_q)
    maxp = page_tables.shape[1]
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    tensors = (q, k_pages, v_pages, q_lens, cu_q, page_tables, ctx_lens)
    if any(x.device != q.device or x.device.type != "cuda"
           for x in tensors):
        raise ValueError("ragged_paged_attention_cuda needs every tensor "
                         "on one CUDA device")
    if q.dtype not in _KERNEL_DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"q/k_pages/v_pages must share a dtype in "
                         f"{list(_KERNEL_DTYPES)}, got {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}")
    for name, x in zip(("q_lens", "cu_q", "page_tables", "ctx_lens"),
                       tensors[3:]):
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("ragged_paged_attention_cuda needs contiguous "
                         "tensors")
    # K/V rows are read in 16-byte vectors (or 4-byte words) and q in 4-byte
    # words where the head dim allows; a misaligned address would fault
    # asynchronously, at a later sync
    if any(x.data_ptr() % 16 for x in (q, k_pages, v_pages)):
        raise ValueError("ragged_paged_attention_cuda needs q, k_pages and "
                         "v_pages aligned to 16 bytes")
    lib = _kernel_lib()
    if s == 0 or t == 0:
        return torch.zeros_like(q)
    g = nh // kvh
    n_splits = core_splits(sm_count(q.device), s, kvh, g, maxp * ps)
    out, tickets = zeros_with_tickets(q, s * kvh * -(-g // CORE_HEADS))
    # ws stays alive until the launch is enqueued
    ws, ws_acc, ws_ml = core_workspace(s, nh, n_splits, hd, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hetu_ragged_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            out.data_ptr(), q_lens.data_ptr(), cu_q.data_ptr(),
            page_tables.data_ptr(), ctx_lens.data_ptr(),
            ws_acc, ws_ml, tickets, t, nh, kvh, hd, ps, s, maxp, int(max_q),
            n_splits, float(scale), _KERNEL_DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            "ragged paged attention kernel failed: "
            f"{lib.hetu_cuda_error_string(err).decode()} (cudaError {err})")
    ragged_paged_attention_cuda.launches += 1
    return out


launch_counter(ragged_paged_attention_cuda)


def ragged_paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, q_lens: torch.Tensor,
                           cu_q: torch.Tensor, page_tables: torch.Tensor,
                           ctx_lens: torch.Tensor, *, max_q: int,
                           softmax_scale: Optional[float] = None
                           ) -> torch.Tensor:
    """Dispatch on q's device: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pages, v_pages, q_lens, cu_q, page_tables, ctx_lens,
            max_q=max_q, softmax_scale=softmax_scale)
    if q.device.type == "cuda":
        return ragged_paged_attention_cuda(
            q, k_pages, v_pages, q_lens, cu_q, page_tables, ctx_lens,
            max_q=max_q, softmax_scale=softmax_scale)
    raise ValueError(f"no ragged paged attention for device {q.device}")


# ---------------------------------------------------------------------------
# MLA latent path
# ---------------------------------------------------------------------------

def _dequant_latent(codes, scales, quant, latent_dim):
    """fp32 view of a gathered latent window: a cast when ``quant`` is
    None, else per-token absmax dequant (codes ``[..., w]`` + scales
    ``[..., 1]`` -> ``[..., latent_dim]``)."""
    if quant is None:
        return codes.float()
    from .quantization import dequantize_rows
    return dequantize_rows(codes, scales, quant, latent_dim)


def _check_latent_shapes(q, c_pages, r_pages, quant, latent_dim):
    nh, dq = q.shape[-2], q.shape[-1]
    p_, ps, one, wc = c_pages.shape
    if one != 1:
        raise ValueError(f"latent c_pages carry ONE shared stream, got "
                         f"{tuple(c_pages.shape)}")
    d_c = int(latent_dim) if latent_dim is not None else wc
    if quant in ("nf4", "fp4"):
        if wc * 2 != d_c:
            raise ValueError(f"{quant} codes width {wc} != latent_dim/2 "
                             f"({d_c})")
    elif wc != d_c:
        raise ValueError(f"c_pages width {wc} != latent_dim {d_c}")
    d_r = 0
    if r_pages is not None and r_pages.shape[-1] > 0:
        if tuple(r_pages.shape[:2]) != (p_, ps) or r_pages.shape[2] != 1:
            raise ValueError(f"r_pages {tuple(r_pages.shape)} incompatible "
                             f"with c_pages {tuple(c_pages.shape)}")
        d_r = r_pages.shape[-1]
    if dq != d_c + d_r:
        raise ValueError(f"absorbed q width {dq} != d_c + d_r "
                         f"({d_c}+{d_r})")
    return nh, ps, d_c, d_r


def _latent_keys(c_pages, r_pages, scale_pages, pt, quant, d_c, d_r):
    """Gather the pages ``pt [..., n]`` names in position order:
    ``(k [..., n*ps, d_c + d_r], c [..., n*ps, d_c])`` in fp32, ``c`` the
    dequantized latent and ``k`` the latent beside the rope key."""
    lead = tuple(pt.shape[:-1])
    kk = pt.shape[-1] * c_pages.shape[1]
    c = c_pages[pt].reshape(*lead, kk, c_pages.shape[-1])
    sc = None if scale_pages is None else \
        scale_pages[pt].reshape(*lead, kk, 1)
    cd = _dequant_latent(c, sc, quant, d_c)
    if not d_r:
        return cd, cd
    r = r_pages[pt].reshape(*lead, kk, d_r)
    return torch.cat([cd, r.float()], dim=-1), cd


def latent_paged_attention_reference(
        q: torch.Tensor, c_pages: torch.Tensor,
        r_pages: Optional[torch.Tensor], page_tables: torch.Tensor,
        seq_lens: torch.Tensor, *, softmax_scale: float,
        scale_pages: Optional[torch.Tensor] = None,
        quant: Optional[str] = None,
        latent_dim: Optional[int] = None) -> torch.Tensor:
    """Decode-slot version over latent pages: absorbed ``q [B, nh,
    d_c+d_r]`` (one token per request), ``seq_lens`` counting the token
    just written -> latent output ``[B, nh, d_c]`` fp32.  Gathers and
    masks with ``-inf`` like ``paged_attention_reference``."""
    nh, ps, d_c, d_r = _check_latent_shapes(q, c_pages, r_pages, quant,
                                            latent_dim)
    pt = page_tables.long()
    kk = pt.shape[1] * ps
    k, cd = _latent_keys(c_pages, r_pages, scale_pages, pt, quant, d_c, d_r)
    s = torch.einsum("bhc,bkc->bhk", q.float(), k) * softmax_scale
    valid = torch.arange(kk, device=q.device)[None] < seq_lens[:, None]
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    return torch.einsum("bhk,bkc->bhc", torch.softmax(s, dim=-1), cd)


def latent_ragged_paged_attention_reference(
        q: torch.Tensor, c_pages: torch.Tensor,
        r_pages: Optional[torch.Tensor], q_lens: torch.Tensor,
        cu_q: torch.Tensor, page_tables: torch.Tensor,
        ctx_lens: torch.Tensor, *, max_q: int, softmax_scale: float,
        scale_pages: Optional[torch.Tensor] = None,
        quant: Optional[str] = None,
        latent_dim: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the latent kernel (the ragged contract of
    :func:`ragged_paged_attention_reference`, ``DEFAULT_MASK_VALUE``
    masking): absorbed ``q [T, nh, d_c+d_r]`` -> latent ``[T, nh, d_c]``
    fp32, 0 on tokens that belong to no row."""
    nh, ps, d_c, d_r = _check_latent_shapes(q, c_pages, r_pages, quant,
                                            latent_dim)
    if quant is not None and scale_pages is None:
        raise ValueError("quantized latent pages need scale_pages")
    t = q.shape[0]
    kk = page_tables.shape[1] * ps
    kv_pos = torch.arange(kk, device=q.device)
    out = torch.zeros((t, nh, d_c), dtype=torch.float32, device=q.device)
    ql, cu, cl = q_lens.tolist(), cu_q.tolist(), ctx_lens.tolist()
    for i in range(len(ql)):
        start, ctx = int(cu[i]), int(cl[i])
        n = min(int(ql[i]), int(max_q), t - start)
        if n <= 0:
            continue
        k, cd = _latent_keys(c_pages, r_pages, scale_pages,
                             page_tables[i].long(), quant, d_c, d_r)
        s = torch.einsum("qhc,kc->qhk", q[start:start + n].float(),
                         k) * softmax_scale
        qpos = (ctx - int(ql[i])) + torch.arange(n, device=q.device)
        valid = kv_pos[None, :] <= qpos[:, None]
        s = s.masked_fill(~valid[:, None, :], DEFAULT_MASK_VALUE)
        out[start:start + n] = torch.einsum(
            "qhk,kc->qhc", torch.softmax(s, dim=-1), cd)
    return out


# page kinds of the latent kernel: how it reads c_pages (and r_pages)
_LATENT_KINDS = {(None, torch.float32): 0, (None, torch.bfloat16): 1,
                 ("int8", torch.int8): 2, ("nf4", torch.uint8): 3,
                 ("fp4", torch.uint8): 3}
_LATENT_MAX_DC = 512          # accumulator columns a block holds
_LATENT_MAX_WIDTH = 640       # d_c + d_r: q and K tiles in shared memory
_LATENT_SPLIT_PAIRS = 128     # kSplitPairs: rows this short split the KV axis
_LATENT_MIN_SPLIT_LEN = 128   # KV positions a slice holds at least
_LATENT_MAX_SPLITS = 16
# slices for two blocks per SM if every row is short
_LATENT_BLOCKS_PER_SM = 2
# the wgmma route (bf16 pages): a persistent block an SM walks items of 32
# pairs; the decode rows' slices are sized for about two items a block,
# none shorter than 8 KV tiles of 32 positions
_LATENT_WGMMA_ITEMS_PER_SM = 2
_LATENT_WGMMA_MIN_SPLIT_LEN = 256
_LATENT_WGMMA_MAX_SPLITS = 32
_LATENT_WGMMA_MAX_ROWS = 1024     # kWgMaxRows: rows a block keeps offsets of


def latent_route(quant: Optional[str], dtype: torch.dtype, d_c: int,
                 d_r: int, page_size: int, rows: int) -> str:
    """The kernel route of a latent batch: ``"wgmma"`` for bf16 pages with
    ``d_c`` a multiple of 64 up to 512 and ``d_r`` 0 or 64 (bf16 terms on
    Hopper's wgmma, TMA page loads), a page size that is a multiple of 8
    (the TMA boxes of 8, 16 or 32 positions lie inside a page) and at most
    1024 rows (the item offsets a block keeps), else ``"mma.sync"``
    (split TF32 terms).  A function of these six alone."""
    if quant is None and dtype == torch.bfloat16 and d_c % 64 == 0 and \
            64 <= d_c <= 512 and d_r in (0, 64) and page_size % 8 == 0 \
            and rows <= _LATENT_WGMMA_MAX_ROWS:
        return "wgmma"
    return "mma.sync"


@functools.lru_cache(maxsize=None)
def _latent_codebook(quant: Optional[str]):
    """The 16 codebook floats the latent kernel takes by value (kind 3
    reads them; other kinds pass nf4's): built once a kind, so a captured
    step launches with the same table as an eager one."""
    from .quantization import _CODES
    return (ctypes.c_float * 16)(*_CODES.get(quant, _CODES["nf4"]).tolist())


def _latent_kernel_lib():
    from ..csrc.build import load_library
    lib = load_library("latent_ragged_paged_attention")
    fn = lib.hetu_latent_ragged_paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        wg = lib.hetu_latent_wgmma_attention
        wg.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_void_p])
        wg.restype = ctypes.c_int
        info = lib.hetu_latent_wgmma_info
        info.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        info.restype = ctypes.c_int
        lib.hetu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hetu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def latent_wgmma_info(d_c: int, d_r: int, n_rows: int):
    """The wgmma route's dynamic shared memory (bytes) and blocks an SM at
    these widths and rows, as the kernel's launcher and the card's
    occupancy calculator give them (on the card only)."""
    lib = _latent_kernel_lib()
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    err = lib.hetu_latent_wgmma_info(d_c, d_r, n_rows, ctypes.byref(smem),
                                     ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"hetu_latent_wgmma_info: "
                           f"{lib.hetu_cuda_error_string(err).decode()}")
    return smem.value, blocks.value


def latent_ragged_paged_attention_cuda(
        q: torch.Tensor, c_pages: torch.Tensor,
        r_pages: Optional[torch.Tensor], q_lens: torch.Tensor,
        cu_q: torch.Tensor, page_tables: torch.Tensor,
        ctx_lens: torch.Tensor, *, max_q: int, softmax_scale: float,
        scale_pages: Optional[torch.Tensor] = None,
        quant: Optional[str] = None,
        latent_dim: Optional[int] = None) -> torch.Tensor:
    """The CUDA latent kernel (same contract as the plain version).  Every
    tensor must lie on one CUDA device.  ``q`` is fp32 (the absorbed
    query is fp32 by construction); unquantized ``c_pages`` and
    ``r_pages`` share a dtype (bf16 or fp32); int8 and 4-bit pages come
    with fp32 ``scale_pages`` and no rope stream.  ``d_c`` and ``d_r`` are
    multiples of 4 with ``d_c <= 512`` and ``d_c + d_r <= 640``; other
    widths raise.  :func:`latent_route` picks the kernel: bf16 pages at
    ``d_c`` a multiple of 64 and ``d_r`` 0 or 64, pages of a multiple of 8
    positions and at most 1024 rows run on wgmma in two bf16 terms of q
    and p; every other kind, width, page size and batch on the TF32
    tensor cores in split terms (two for bf16 and int8 pages,
    three for fp32 and 4-bit ones).  The output is allocated zeroed here
    and the kernel writes only real tokens; rows of at most 128 (token,
    head) pairs (decode rows) are split over the KV axis through an fp32
    workspace.  ``latent_ragged_paged_attention_cuda.launches`` counts the
    launches, ``.wgmma_launches`` those on the wgmma route."""
    nh, ps, d_c, d_r = _check_latent_shapes(q, c_pages, r_pages, quant,
                                            latent_dim)
    if q.dim() != 3:
        raise ValueError(f"q must be [T, nh, d_c+d_r], got "
                         f"{tuple(q.shape)}")
    t = q.shape[0]
    s = q_lens.shape[0]
    if tuple(cu_q.shape) != (s + 1,):
        raise ValueError(f"cu_q must be [S+1]={s + 1}, got "
                         f"{tuple(cu_q.shape)}")
    if page_tables.ndim != 2 or page_tables.shape[0] != s:
        raise ValueError(f"page_tables must be [S, maxp], got "
                         f"{tuple(page_tables.shape)}")
    if tuple(ctx_lens.shape) != (s,):
        raise ValueError(f"ctx_lens must be [S], got "
                         f"{tuple(ctx_lens.shape)}")
    if not 1 <= int(max_q):
        raise ValueError(f"max_q must be >= 1, got {max_q}")
    maxp = page_tables.shape[1]
    if not d_r:
        r_pages = None
    if quant is not None:
        if scale_pages is None:
            raise ValueError("quantized latent pages need scale_pages")
        if r_pages is not None:
            raise ValueError("quantized latent pages carry no rope stream")
        if tuple(scale_pages.shape) != (c_pages.shape[0], ps, 1, 1) or \
                scale_pages.dtype != torch.float32:
            raise ValueError(f"scale_pages must be fp32 [P, ps, 1, 1], got "
                             f"{scale_pages.dtype} "
                             f"{tuple(scale_pages.shape)}")
    else:
        scale_pages = None
    kind = _LATENT_KINDS.get((quant, c_pages.dtype))
    if kind is None:
        raise ValueError(f"no latent kernel for quant={quant!r} with "
                         f"c_pages of {c_pages.dtype}")
    if q.dtype != torch.float32:
        raise ValueError(f"the absorbed q must be float32, got {q.dtype}")
    if r_pages is not None and r_pages.dtype != c_pages.dtype:
        raise ValueError(f"r_pages {r_pages.dtype} != c_pages "
                         f"{c_pages.dtype}")
    if d_c % 4 or d_r % 4 or d_c > _LATENT_MAX_DC or \
            d_c + d_r > _LATENT_MAX_WIDTH:
        raise ValueError(
            f"latent widths (d_c={d_c}, d_r={d_r}) not covered by the "
            f"kernel: multiples of 4, d_c <= {_LATENT_MAX_DC}, d_c + d_r "
            f"<= {_LATENT_MAX_WIDTH}")
    tensors = [q, c_pages, q_lens, cu_q, page_tables, ctx_lens]
    tensors += [x for x in (r_pages, scale_pages) if x is not None]
    if any(x.device != q.device or x.device.type != "cuda"
           for x in tensors):
        raise ValueError("latent_ragged_paged_attention_cuda needs every "
                         "tensor on one CUDA device")
    for name, x in zip(("q_lens", "cu_q", "page_tables", "ctx_lens"),
                       tensors[2:6]):
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("latent_ragged_paged_attention_cuda needs "
                         "contiguous tensors")
    # the kernel reads q in 16-byte vectors and the pages in vectors of 4
    # elements; a misaligned address would fault asynchronously
    if any(x.data_ptr() % 16 for x in (q, c_pages, r_pages)
           if x is not None):
        raise ValueError("latent_ragged_paged_attention_cuda needs q, "
                         "c_pages and r_pages aligned to 16 bytes")
    wgmma = latent_route(quant, c_pages.dtype, d_c, d_r, ps, s) == "wgmma"
    lib = _latent_kernel_lib()
    out = torch.zeros((t, nh, d_c), dtype=torch.float32, device=q.device)
    if s == 0 or t == 0:
        return out
    if wgmma:
        _latent_wgmma_launch(lib, q, c_pages, r_pages, out, q_lens, cu_q,
                             page_tables, ctx_lens, max_q, softmax_scale)
        latent_ragged_paged_attention_cuda.launches += 1
        latent_ragged_paged_attention_cuda.wgmma_launches += 1
        return out
    code = _latent_codebook(quant)
    n_splits = kv_splits(sm_count(q.device), s, maxp * ps,
                         per_sm=_LATENT_BLOCKS_PER_SM,
                         min_len=_LATENT_MIN_SPLIT_LEN,
                         most=_LATENT_MAX_SPLITS)
    ws_acc = ws_ml = None
    if n_splits > 1:
        ws_acc = torch.empty((s, _LATENT_SPLIT_PAIRS, n_splits, d_c),
                             dtype=torch.float32, device=q.device)
        ws_ml = torch.empty((s, _LATENT_SPLIT_PAIRS, n_splits, 2),
                            dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hetu_latent_ragged_paged_attention(
            q.data_ptr(), c_pages.data_ptr(),
            r_pages.data_ptr() if r_pages is not None else None,
            scale_pages.data_ptr() if scale_pages is not None else None,
            ctypes.cast(code, ctypes.c_void_p), out.data_ptr(),
            q_lens.data_ptr(), cu_q.data_ptr(), page_tables.data_ptr(),
            ctx_lens.data_ptr(),
            ws_acc.data_ptr() if ws_acc is not None else None,
            ws_ml.data_ptr() if ws_ml is not None else None,
            t, nh, d_c, d_r, ps, s, maxp, int(max_q), kind, n_splits,
            float(softmax_scale), stream)
    if err != 0:
        raise RuntimeError(
            "latent ragged paged attention kernel failed: "
            f"{lib.hetu_cuda_error_string(err).decode()} (cudaError {err})")
    latent_ragged_paged_attention_cuda.launches += 1
    return out


def _latent_wgmma_launch(lib, q, c_pages, r_pages, out, q_lens, cu_q,
                         page_tables, ctx_lens, max_q, softmax_scale):
    """One launch of the wgmma route on checked tensors (a persistent
    block an SM; the split rows merged by a second kernel)."""
    s, maxp = page_tables.shape
    n_pages, ps, _, d_c = c_pages.shape
    d_r = r_pages.shape[-1] if r_pages is not None else 0
    sms = sm_count(q.device)
    n_splits = kv_splits(sms, s, maxp * ps,
                         per_sm=_LATENT_WGMMA_ITEMS_PER_SM,
                         min_len=_LATENT_WGMMA_MIN_SPLIT_LEN,
                         most=_LATENT_WGMMA_MAX_SPLITS)
    ws = ws_acc = ws_ml = None
    if n_splits > 1:
        # one buffer: ws_acc [S, 128, n_splits, d_c], then ws_ml [.., 2]
        rows = s * _LATENT_SPLIT_PAIRS * n_splits
        ws = torch.empty(rows * (d_c + 2), dtype=torch.float32,
                         device=q.device)
        ws_acc, ws_ml = ws.data_ptr(), ws.data_ptr() + rows * d_c * 4
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hetu_latent_wgmma_attention(
            q.data_ptr(), c_pages.data_ptr(),
            r_pages.data_ptr() if r_pages is not None else None,
            out.data_ptr(), q_lens.data_ptr(), cu_q.data_ptr(),
            page_tables.data_ptr(), ctx_lens.data_ptr(), ws_acc, ws_ml,
            q.shape[0], q.shape[1], d_c, d_r, ps, n_pages, s, maxp,
            int(max_q), n_splits, sms, float(softmax_scale), stream)
    if err != 0:
        raise RuntimeError(
            "latent ragged paged attention kernel (wgmma) failed: "
            f"{lib.hetu_cuda_error_string(err).decode()} (cudaError {err})")


launch_counter(latent_ragged_paged_attention_cuda, "launches",
               "wgmma_launches")


def latent_ragged_paged_attention(
        q: torch.Tensor, c_pages: torch.Tensor,
        r_pages: Optional[torch.Tensor], q_lens: torch.Tensor,
        cu_q: torch.Tensor, page_tables: torch.Tensor,
        ctx_lens: torch.Tensor, *, max_q: int, softmax_scale: float,
        scale_pages: Optional[torch.Tensor] = None,
        quant: Optional[str] = None,
        latent_dim: Optional[int] = None) -> torch.Tensor:
    """Dispatch on q's device: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    kw = dict(max_q=max_q, softmax_scale=softmax_scale,
              scale_pages=scale_pages, quant=quant, latent_dim=latent_dim)
    if q.device.type == "cpu":
        return latent_ragged_paged_attention_reference(
            q, c_pages, r_pages, q_lens, cu_q, page_tables, ctx_lens, **kw)
    if q.device.type == "cuda":
        return latent_ragged_paged_attention_cuda(
            q, c_pages, r_pages, q_lens, cu_q, page_tables, ctx_lens, **kw)
    raise ValueError(f"no latent ragged paged attention for device "
                     f"{q.device}")


# ---------------------------------------------------------------------------
# on-device sampling
# ---------------------------------------------------------------------------
#
# JAX keys each sampled draw with ``fold_in(PRNGKey(seed), ctx)``; torch
# cannot reproduce threefry's bits, so the port keeps the contract and
# not the bits.  A sampled row draws from the same temperature / top-k /
# top-p truncated distribution by Gumbel-max, with the noise of vocab
# entry v a hash of ``(seed, ctx, v)`` computed in int64 tensor ops.  The
# draw for a token index is therefore a function of the row's own
# logits and ``(seed, ctx)`` alone: batching, chunking and preemption do
# not change it, and nothing is read back to the host.

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """Integer finalizer on int64 tensors holding 32-bit values.  The
    multipliers stay below 2**31, so no product leaves int64's range."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def _gumbel_noise(seeds: torch.Tensor, ctxs: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """``[N, V]`` fp32 Gumbel noise keyed by ``(seed, ctx, vocab id)``."""
    dev = seeds.device
    s = _mix32(seeds.to(torch.int64) & _M32)
    c = _mix32((ctxs.to(torch.int64) + 0x632BE5AB) & _M32)
    row = _mix32(s ^ c)                                     # [N]
    v = torch.arange(vocab, device=dev, dtype=torch.int64)
    h = _mix32(row[:, None] ^ _mix32(v[None, :] + 0x3C6EF372))
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # (0, 1)
    return -torch.log(-torch.log(u))


def _sampled_draw(logits, temps, top_ps, top_ks, seeds, ctxs):
    """Keyed categorical draws for ``[N, V]`` fp32 logits:
    temperature-scaled, top-k/top-p truncated, keyed by ``(seed, ctx)``."""
    n, v = logits.shape
    lg = logits / torch.where(temps > 0, temps, torch.ones_like(temps)
                              )[:, None]
    order = torch.argsort(-lg, dim=-1, stable=True)        # descending
    lg_s = torch.gather(lg, 1, order)
    probs = torch.softmax(lg_s, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    idxs = torch.arange(v, device=logits.device)[None, :]
    tp, tk = top_ps[:, None], top_ks[:, None]
    # nucleus: drop tokens once the mass BEFORE them exceeds top_p (the
    # argmax token is never cut)
    cut = (csum - probs > tp) & (tp > 0.0) & (tp < 1.0)
    cut = cut | ((idxs >= tk) & (tk > 0))
    noise = torch.gather(_gumbel_noise(seeds, ctxs, v), 1, order)
    pick = torch.argmax(lg_s.masked_fill(cut, float("-inf")) + noise,
                        dim=-1)
    return torch.gather(order, 1, pick[:, None])[:, 0].to(torch.int32)


def sample_rows(logits, temps, top_ps, top_ks, seeds, ctxs,
                sampled: bool) -> torch.Tensor:
    """Next token for every row of ``[N, V]`` fp32 logits.

    Greedy rows (``temp == 0``) take ``torch.argmax`` (the first
    maximum, like ``jnp.argmax``); sampled rows draw as described above.
    ``sampled`` is the caller's host-side knowledge of whether any row
    samples: ``False`` skips the sort-based path (the common all-greedy
    step).  Deciding it here from ``temps`` would read a device tensor
    back to the host."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not sampled:
        return greedy
    samp = _sampled_draw(logits, temps, top_ps, top_ks, seeds, ctxs)
    return torch.where(temps == 0.0, greedy, samp)


def sample_row(logits, temp, top_p, top_k, seed, ctx) -> torch.Tensor:
    """:func:`sample_rows` for one row of fp32 logits ``[V]``."""
    dev = logits.device
    as1 = lambda x, dt: torch.as_tensor([x], dtype=dt, device=dev)  # noqa: E731
    return sample_rows(logits[None], as1(temp, torch.float32),
                       as1(top_p, torch.float32), as1(top_k, torch.int32),
                       as1(seed, torch.int32), as1(ctx, torch.int32),
                       sampled=temp > 0)[0]


# ---------------------------------------------------------------------------
# verify-row sampling head (speculative decoding)
# ---------------------------------------------------------------------------
#
# A verify row feeds ``[last committed token, d_1, ..., d_K]`` through the
# unified step as a chunk row.  Verify position j's logits emit the token
# at absolute sequence index ``ctx - spec_len + j``; the head draws that
# position's choice from the ONE row sampler above, keyed by that index
# exactly as a decode row at that index is, and accepts ``d_{j+1}`` iff it
# equals the choice.  At temperature 0 the choice is the argmax a decode
# step would commit; sampled, accepting iff a draw ``X ~ p`` equals the
# greedy draft is the coupled form of leftover-distribution rejection
# sampling for a point-mass draft (accept with probability ``p(d)``, and
# ``X`` given rejection follows ``p`` without ``d``).  Either way the
# emitted tokens are those non-speculative serving emits.


def speculative_verify_head(vlogits, draft_next, spec_lens, temps, top_ps,
                            top_ks, seeds, ctx_lens, sampled: bool):
    """Batched accept/reject over verify rows (R rows, K = the static
    draft length):

    - ``vlogits [R, K, V]`` fp32: logits at the row's first K query
      positions (position j verifies the draft fed at j + 1);
    - ``draft_next [R, K]`` int32: the draft token fed at j + 1;
    - ``spec_lens [R]``: staged drafts per row (0: not a verify row,
      ``accepted`` is 0);
    - ``temps``/``top_ps``/``top_ks``/``seeds`` ``[R]``: the rows'
      sampling parameters; ``ctx_lens [R]``: context including this
      step's tokens; ``sampled``: whether any row samples (as for
      :func:`sample_rows`).

    Returns ``(accepted [R], alt [R, K])`` int32: the longest accepted
    prefix (at most ``spec_len``) and each position's own choice;
    ``alt[r, accepted[r]]`` is the bonus token after a rejection, and on
    full acceptance the caller's last-position sample is the bonus."""
    r, k, v = vlogits.shape
    ar = torch.arange(k, device=vlogits.device)
    idx = ctx_lens[:, None] - spec_lens[:, None] + ar[None, :]   # [R, K]
    rep = lambda a: a.repeat_interleave(k)                      # noqa: E731
    choice = sample_rows(vlogits.reshape(r * k, v), rep(temps),
                         rep(top_ps), rep(top_ks), rep(seeds),
                         idx.reshape(-1), sampled=sampled).reshape(r, k)
    live = ar[None, :] < spec_lens[:, None]
    accepted = torch.cumprod(((choice == draft_next) & live).to(torch.int32),
                             dim=1).sum(dim=1)
    return accepted.to(torch.int32), choice
