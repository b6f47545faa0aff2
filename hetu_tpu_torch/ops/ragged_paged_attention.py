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
  (``csrc/ragged_paged_attention.cu``) for CUDA tensors.

``ragged_paged_attention`` dispatches on the tensors' device: the plain
version for CPU tensors, the kernel for CUDA tensors.  A kernel that
fails to build or launch raises; there is no fallback.

The module also holds the serving step's on-device sampler
(``sample_rows``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

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
_KERNEL_HEAD_DIMS = (64, 128)


def _kernel_lib():
    from ..csrc.build import load_library
    lib = load_library("ragged_paged_attention")
    fn = lib.hetu_ragged_paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
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
    dtype (bf16 or fp32) and the metadata is int32.  The output is
    allocated zeroed here and the kernel writes only real tokens.
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
    if hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {_KERNEL_HEAD_DIMS}")
    for name, x in zip(("q_lens", "cu_q", "page_tables", "ctx_lens"),
                       tensors[3:]):
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("ragged_paged_attention_cuda needs contiguous "
                         "tensors")
    # the bf16 kernel reads K/V in 16-byte vectors and q in 4-byte words;
    # a misaligned address would fault asynchronously, at a later sync
    if any(x.data_ptr() % 16 for x in (q, k_pages, v_pages)):
        raise ValueError("ragged_paged_attention_cuda needs q, k_pages and "
                         "v_pages aligned to 16 bytes")
    lib = _kernel_lib()
    out = torch.zeros_like(q)
    if s == 0 or t == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hetu_ragged_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            out.data_ptr(), q_lens.data_ptr(), cu_q.data_ptr(),
            page_tables.data_ptr(), ctx_lens.data_ptr(),
            t, nh, kvh, hd, ps, s, maxp, int(max_q), float(scale),
            _KERNEL_DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            "ragged paged attention kernel failed: "
            f"{lib.hetu_cuda_error_string(err).decode()} (cudaError {err})")
    ragged_paged_attention_cuda.launches += 1
    return out


ragged_paged_attention_cuda.launches = 0


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
