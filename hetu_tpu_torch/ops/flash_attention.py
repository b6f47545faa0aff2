"""Flash attention forward and backward (PyTorch port of
``hetu_tpu.ops.pallas.flash_attention``).

Layout [batch, seq, heads, head_dim], equal head counts for q and k/v
(GQA is expanded before, ``ops.functional.repeat_kv``).  Key j is visible
to query i iff ``j <= i + causal_offset`` when ``causal``, and, with
``segment_ids`` (a [b, s] array shared by q and kv, or a ``(q_ids
[b, sq], kv_ids [b, sk])`` tuple), iff their ids are equal.  The forward
returns ``out`` in q's dtype and ``lse`` [b, h, sq] (fp32, natural log);
a query that sees no key gives out = 0, lse = -inf and zero gradients.

Two implementations of each function:

- ``flash_fwd_reference`` / ``flash_bwd_reference``: the plain versions,
  the dense formulas in fp32, chunked over (batch, heads) so the score
  matrices fit at s = 4096.  They run wherever their tensors are and are
  the CPU path.
- ``flash_fwd_cuda``, ``flash_bwd_fused_cuda``, ``flash_bwd_dq_cuda`` and
  ``flash_bwd_dkv_cuda``: the CUDA kernels of ``csrc/flash_attention.cu``
  (kernels 1-4 of the JAX package).  At head dims up to 256 every kernel
  runs on the tensor cores in every type: for bf16 q/k/v every kernel
  (the forward, dq and the dk/dv template, split and fused) on Hopper's
  ``wgmma`` fed by TMA at head dims 64 and 128 and on bf16 ``mma.sync`` at
  32 and 256; 3xTF32 for fp32 q/k (the mixed forward's P.V on bf16
  ``mma.sync``), at head dims 32, 64, 128 and 256; the wrappers zero-pad
  any other head dim up to 256 to the next of those (``_pad_heads``) and
  slice the results back, which is exact.  Above 256 the wide route runs
  (CUDA-core FMA, fp32 accumulation, any multiple of ``COLUMN_SLICE``
  columns; wider head dims are zero-padded to the next multiple), where
  the fused backward runs as the split dq and dk/dv kernels.  Each wrapper
  counts its launches in ``.launches`` and, of those, the tensor-core ones
  (as the library reports them) in ``.tensor_core_launches``, the 3xTF32
  ones in ``.tf32_launches`` and the ``wgmma`` ones in
  ``.wgmma_launches``; the causal ones also in ``.causal_launches``.

``_flash_fwd`` and ``_flash_bwd`` dispatch on the tensors' device: the
plain versions for CPU tensors, the kernels for CUDA tensors, with no
fallback between them.  ``_Flash`` is the ``torch.autograd.Function``
over the two.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..core.capture import launch_counter
from ..csrc.build import COLUMN_SLICE, KERNEL_HEAD_DIMS

LOG2E = 1.4426950408889634

# The fused backward's byte budget.  On the TPU it is the VMEM that the
# fused kernel pins for dk/dv of the whole sequence (two fp32 scratch planes
# plus the two output blocks); the CUDA fused kernel keeps only one KV
# tile, but the port keeps the rule so that both packages run the
# counterpart of the same kernel for the same shapes.
_FUSED_DKV_VMEM_BYTES = 4 * 1024 * 1024

# the score matrices of the plain versions hold at most this many fp32
# elements at a time
_REFERENCE_CHUNK_ELEMS = 1 << 26


def _use_fused(sk: int, d: int, k_dtype: torch.dtype) -> bool:
    """The JAX package's choice between the fused and the split backward
    (``_flash_bwd``): fused while ``2 * sk * d * (4 + itemsize)`` fits."""
    itemsize = torch.empty((), dtype=k_dtype).element_size()
    return 2 * sk * d * (4 + itemsize) <= _FUSED_DKV_VMEM_BYTES


def _split_segments(segment_ids, sq: int, sk: int):
    """``(q_ids, kv_ids)`` from either form, or ``None``."""
    if segment_ids is None:
        return None
    if isinstance(segment_ids, (tuple, list)):
        q_ids, kv_ids = segment_ids
    else:
        if sq != sk:
            raise NotImplementedError(
                "segment_ids with sq != sk needs a (q_ids, kv_ids) tuple")
        q_ids = kv_ids = segment_ids
    return q_ids, kv_ids


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _visible(bi: int, sq: int, sk: int, causal: bool, offset: int, segs,
             device) -> Optional[torch.Tensor]:
    """[sq, sk] bool mask of batch row ``bi`` (None: everything visible)."""
    mask = None
    if causal:
        i = torch.arange(sq, device=device)[:, None]
        j = torch.arange(sk, device=device)[None, :]
        mask = j <= i + offset
    if segs is not None:
        q_ids, kv_ids = segs
        seg = q_ids[bi][:, None] == kv_ids[bi][None, :]
        mask = seg if mask is None else mask & seg
    return mask


def _head_chunks(h: int, sq: int, sk: int):
    step = max(1, _REFERENCE_CHUNK_ELEMS // max(1, sq * sk))
    return [(h0, min(h, h0 + step)) for h0 in range(0, h, step)]


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, causal: bool, segment_ids=None,
                        causal_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward: ``(out [b, sq, h, d] in q's dtype,
    lse [b, h, sq] fp32)``, dense fp32 attention per (batch, head chunk)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    segs = _split_segments(segment_ids, sq, sk)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    for bi in range(b):
        mask = _visible(bi, sq, sk, causal, causal_offset, segs, q.device)
        for h0, h1 in _head_chunks(h, sq, sk):
            qf = q[bi, :, h0:h1].float().transpose(0, 1)      # [hc, sq, d]
            kf = k[bi, :, h0:h1].float().transpose(0, 1)
            vf = v[bi, :, h0:h1].float().transpose(0, 1)
            s = torch.matmul(qf, kf.transpose(1, 2)) * scale
            if mask is not None:
                s = s.masked_fill(~mask, float("-inf"))
            ls = torch.logsumexp(s, dim=-1)                    # [hc, sq]
            live = torch.isfinite(ls)
            p = torch.exp(s - torch.where(live, ls, 0.0)[..., None])
            p = torch.where(live[..., None], p, 0.0)
            out[bi, :, h0:h1] = torch.matmul(p, vf).transpose(0, 1) \
                .to(q.dtype)
            lse[bi, h0:h1] = ls
    return out, lse


def flash_bwd_reference(q, k, v, out, lse, do, scale: float, causal: bool,
                        segment_ids=None, causal_offset: int = 0):
    """Plain version of the backward from the forward's ``out`` and
    ``lse``: ``(dq, dk, dv)`` in q's, k's and v's dtypes, dense fp32 per
    (batch, head chunk), with delta = rowsum(do * out)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    segs = _split_segments(segment_ids, sq, sk)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    for bi in range(b):
        mask = _visible(bi, sq, sk, causal, causal_offset, segs, q.device)
        for h0, h1 in _head_chunks(h, sq, sk):
            qf = q[bi, :, h0:h1].float().transpose(0, 1)      # [hc, sq, d]
            kf = k[bi, :, h0:h1].float().transpose(0, 1)
            vf = v[bi, :, h0:h1].float().transpose(0, 1)
            dof = do[bi, :, h0:h1].float().transpose(0, 1)
            of = out[bi, :, h0:h1].float().transpose(0, 1)
            ls = lse[bi, h0:h1].float()                        # [hc, sq]
            live = torch.isfinite(ls)
            s = torch.matmul(qf, kf.transpose(1, 2)) * scale
            p = torch.exp(s - torch.where(live, ls, 0.0)[..., None])
            keep = live[..., None] if mask is None else \
                live[..., None] & mask
            p = torch.where(keep, p, 0.0)
            dp = torch.matmul(dof, vf.transpose(1, 2))
            delta = (dof * of).sum(-1, keepdim=True)
            ds = p * (dp - delta)
            dq[bi, :, h0:h1] = (torch.matmul(ds, kf) * scale) \
                .transpose(0, 1).to(q.dtype)
            dk[bi, :, h0:h1] = (torch.matmul(ds.transpose(1, 2), qf)
                                * scale).transpose(0, 1).to(k.dtype)
            dv[bi, :, h0:h1] = torch.matmul(p.transpose(1, 2), dof) \
                .transpose(0, 1).to(v.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

# (q/k dtype, v dtype) -> the kernels' type code
_KERNEL_DTYPES = {(torch.float32, torch.float32): 0,
                  (torch.bfloat16, torch.bfloat16): 1,
                  (torch.float32, torch.bfloat16): 2}


def _kernel_head_dim(d: int) -> int:
    """The kernels' head dim that ``d`` is padded to: the smallest of
    ``KERNEL_HEAD_DIMS`` that holds it, and above the widest the next
    multiple of ``COLUMN_SLICE`` (the wide route)."""
    for width in KERNEL_HEAD_DIMS:
        if d <= width:
            return width
    return -(-d // COLUMN_SLICE) * COLUMN_SLICE


def _pad_heads(width: int, *xs: torch.Tensor):
    """``xs`` with the head (last) axis zero-padded to ``width``, on any
    device.  Exact for flash attention: zero columns add nothing to q.k,
    give zero columns of out, dq, dk and dv, and leave lse as it was (the
    caller keeps the scale of the true head dim)."""
    return tuple(x if x.shape[-1] == width else
                 torch.nn.functional.pad(x, (0, width - x.shape[-1]))
                 for x in xs)


def _unpad_heads(d: int, *xs: torch.Tensor):
    """``xs`` cut back to head dim ``d`` (contiguous)."""
    return tuple(x if x.shape[-1] == d else x[..., :d].contiguous()
                 for x in xs)


def _kernel_lib():
    from ..csrc.build import load_library
    lib = load_library("flash_attention")
    if lib.hetu_flash_fwd.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.hetu_flash_fwd.argtypes = ([ptr] * 7 + [i32] * 5
                                       + [f32, i32, i32, i32, ptr])
        lib.hetu_flash_bwd_dq.argtypes = ([ptr] * 9 + [i32] * 5
                                          + [f32, i32, i32, i32, ptr])
        lib.hetu_flash_bwd_dkv.argtypes = ([ptr] * 12 + [i32] * 5
                                           + [f32, i32, i32, i32, i32, ptr])
        for fn in (lib.hetu_flash_fwd, lib.hetu_flash_bwd_dq,
                   lib.hetu_flash_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.hetu_flash_uses_tensor_cores.argtypes = [i32] * 3
        lib.hetu_flash_uses_tensor_cores.restype = ctypes.c_int
        lib.hetu_flash_kernel_info.argtypes = [i32] * 4 + [
            ctypes.POINTER(ctypes.c_int)] * 2
        lib.hetu_flash_kernel_info.restype = ctypes.c_int
        lib.hetu_flash_error_string.argtypes = [ctypes.c_int]
        lib.hetu_flash_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(name: str, q, k, v, same_as_q=(), fp32=()):
    """Validates what every kernel needs and returns ``(b, sq, sk, h, d,
    the kernels' head dim d is padded to, type code)``; raises
    ``ValueError`` on anything it does not take (every head dim runs)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be [b, s, h, d]")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if tuple(k.shape) != (b, sk, h, d) or tuple(v.shape) != (b, sk, h, d):
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be [b, sk, h, d] with q's "
                         f"b, h, d {tuple(q.shape)}")
    code = _KERNEL_DTYPES.get((q.dtype, v.dtype))
    if code is None or k.dtype != q.dtype:
        raise ValueError(
            f"{name}: (q, k, v) dtypes ({q.dtype}, {k.dtype}, {v.dtype}) "
            f"not supported; the kernels take (float32, float32, float32), "
            f"(bfloat16, bfloat16, bfloat16) and (float32, float32, "
            f"bfloat16)")
    width = _kernel_head_dim(d)
    for x in same_as_q:
        if tuple(x.shape) != tuple(q.shape) or x.dtype != q.dtype:
            raise ValueError(f"{name}: out/do must match q's shape and "
                             f"dtype, got {tuple(x.shape)} {x.dtype}")
    for x in fp32:
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: lse/delta must be float32, got "
                             f"{x.dtype}")
    tensors = (q, k, v, *same_as_q, *fp32)
    if any(x.device != q.device or x.device.type != "cuda"
           for x in tensors):
        raise ValueError(f"{name} needs every tensor on one CUDA device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    # tiles are read in 8- and 16-byte vectors; a misaligned address would
    # fault asynchronously, at a later sync
    if any(x.data_ptr() % 16 for x in (q, k, v, *same_as_q)):
        raise ValueError(f"{name} needs q, k, v, out and do aligned to 16 "
                         f"bytes")
    return b, sq, sk, h, d, width, code


def _segment_pointers(name: str, segment_ids, b: int, sq: int, sk: int,
                      device):
    """``(q_ids, kv_ids)`` as contiguous int32 tensors on ``device``
    (the caller keeps them alive while the kernel may read them) and
    their pointers, or ``(None, None, None)``."""
    segs = _split_segments(segment_ids, sq, sk)
    if segs is None:
        return None, None, None
    q_ids, kv_ids = segs
    if tuple(q_ids.shape) != (b, sq) or tuple(kv_ids.shape) != (b, sk):
        raise ValueError(f"{name}: segment ids must be [b, sq] and [b, sk], "
                         f"got {tuple(q_ids.shape)}, {tuple(kv_ids.shape)}")
    if q_ids.device != device or kv_ids.device != device:
        raise ValueError(f"{name}: segment ids must lie on {device}")
    q_ids = q_ids.to(torch.int32).contiguous()
    kv_ids = kv_ids.to(torch.int32).contiguous()
    return (q_ids, kv_ids), q_ids.data_ptr(), kv_ids.data_ptr()


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel failed: "
                           f"{lib.hetu_flash_error_string(err).decode()} "
                           f"(cudaError {err})")


# the C entry each wrapper calls, as hetu_flash_uses_tensor_cores numbers
# them, and the tensor-core routes it reports (0 is the wide route's CUDA
# cores): bf16 mma.sync, 3xTF32, bf16 wgmma
_ENTRY_FWD, _ENTRY_DQ, _ENTRY_DKV = 0, 1, 2
_ROUTE_BF16, _ROUTE_TF32, _ROUTE_WGMMA = 1, 2, 3


# the launch counters of every flash wrapper
_COUNTS = ("launches", "tensor_core_launches", "tf32_launches",
           "wgmma_launches", "causal_launches")


def _count_launch(wrapper, lib, entry: int, d: int, code: int,
                  causal: bool = False) -> None:
    """Adds one launch to ``wrapper``'s counts, on the route the library
    reports for this entry, head dim and type code, and to its causal
    ones when ``causal``."""
    wrapper.launches += 1
    if causal:
        wrapper.causal_launches += 1
    route = lib.hetu_flash_uses_tensor_cores(entry, d, code)
    if route in (_ROUTE_BF16, _ROUTE_TF32, _ROUTE_WGMMA):
        wrapper.tensor_core_launches += 1
    if route == _ROUTE_TF32:
        wrapper.tf32_launches += 1
    if route == _ROUTE_WGMMA:
        wrapper.wgmma_launches += 1


def _kernel_info(entry: int, head_dim: int, code: int, fused: bool = False):
    """``(dynamic shared memory bytes, blocks an SM)`` of the kernel that
    C entry ``entry`` (0 forward, 1 dq, 2 dk/dv) launches for type code
    ``code`` (as ``_KERNEL_DTYPES``) and ``head_dim``, as the card's
    occupancy calculator reports them; only ``chip_smoke.py`` prints it.
    Needs a CUDA device."""
    lib = _kernel_lib()
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    _raise_on(lib.hetu_flash_kernel_info(entry, head_dim, code, int(fused),
                                         ctypes.byref(smem),
                                         ctypes.byref(blocks)),
              lib, "flash attention kernel info")
    return smem.value, blocks.value


def flash_fwd_cuda(q, k, v, scale: float, causal: bool, segment_ids=None,
                   causal_offset: int = 0):
    """Kernel 1, the forward (same contract as ``flash_fwd_reference``)."""
    b, sq, sk, h, d0, d, code = _check_kernel_inputs(
        "flash_fwd_cuda", q, k, v)
    segs, qs_ptr, ks_ptr = _segment_pointers("flash_fwd_cuda", segment_ids,
                                             b, sq, sk, q.device)
    q, k, v = _pad_heads(d, q, k, v)
    lib = _kernel_lib()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hetu_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), qs_ptr, ks_ptr, b, sq, sk, h, d, float(scale),
            int(bool(causal)), int(causal_offset), code, stream)
    _raise_on(err, lib, "flash attention forward")
    _count_launch(flash_fwd_cuda, lib, _ENTRY_FWD, d, code, causal)
    return _unpad_heads(d0, out)[0], lse


launch_counter(flash_fwd_cuda, *_COUNTS)


def flash_bwd_fused_cuda(q, k, v, out, lse, do, scale: float, causal: bool,
                         segment_ids=None, causal_offset: int = 0):
    """Kernel 2, the fused backward: ``(dq, dk, dv)``.  dq is summed
    across KV tiles with fp32 atomics into a zeroed workspace allocated
    here, then cast to q's dtype.  Above head dim 256 (the wide route,
    which has no fused kernel) it runs as the split kernels 3 and 4 with
    delta from one torch op: the two routes compute the same dq, dk and
    dv."""
    b, sq, sk, h, d0, d, code = _check_kernel_inputs(
        "flash_bwd_fused_cuda", q, k, v, same_as_q=(out, do), fp32=(lse,))
    segs, qs_ptr, ks_ptr = _segment_pointers(
        "flash_bwd_fused_cuda", segment_ids, b, sq, sk, q.device)
    q, k, v, out, do = _pad_heads(d, q, k, v, out, do)
    lib = _kernel_lib()
    if d > KERNEL_HEAD_DIMS[-1]:
        delta = torch.einsum("bshd,bshd->bsh", do.float(), out.float())
        dq = torch.empty_like(q)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.hetu_flash_bwd_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), qs_ptr,
                ks_ptr, b, sq, sk, h, d, float(scale), int(bool(causal)),
                int(causal_offset), code, stream)
            _raise_on(err, lib, "flash attention fused backward (dq)")
            err = lib.hetu_flash_bwd_dkv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(), None,
                dk.data_ptr(), dv.data_ptr(), qs_ptr, ks_ptr, b, sq, sk, h,
                d, float(scale), int(bool(causal)), int(causal_offset), code,
                0, stream)
        _raise_on(err, lib, "flash attention fused backward (dk/dv)")
        _count_launch(flash_bwd_fused_cuda, lib, _ENTRY_DKV, d, code,
                      causal)
        return _unpad_heads(d0, dq, dk, dv)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hetu_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), None, dq_acc.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), qs_ptr, ks_ptr, b, sq, sk, h, d,
            float(scale), int(bool(causal)), int(causal_offset), code, 1,
            stream)
    _raise_on(err, lib, "flash attention fused backward")
    _count_launch(flash_bwd_fused_cuda, lib, _ENTRY_DKV, d, code, causal)
    return _unpad_heads(d0, dq_acc.to(q.dtype), dk, dv)


launch_counter(flash_bwd_fused_cuda, *_COUNTS)


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale: float, causal: bool,
                      segment_ids=None, causal_offset: int = 0):
    """Kernel 3, dq of the split backward; ``delta`` is rowsum(do * out)
    as ``[b, sq, h]`` fp32."""
    b, sq, sk, h, d0, d, code = _check_kernel_inputs(
        "flash_bwd_dq_cuda", q, k, v, same_as_q=(do,), fp32=(lse, delta))
    if tuple(delta.shape) != (b, sq, h) or tuple(lse.shape) != (b, h, sq):
        raise ValueError("flash_bwd_dq_cuda: lse must be [b, h, sq] and "
                         "delta [b, sq, h]")
    segs, qs_ptr, ks_ptr = _segment_pointers(
        "flash_bwd_dq_cuda", segment_ids, b, sq, sk, q.device)
    q, k, v, do = _pad_heads(d, q, k, v, do)
    lib = _kernel_lib()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hetu_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), qs_ptr, ks_ptr,
            b, sq, sk, h, d, float(scale), int(bool(causal)),
            int(causal_offset), code, stream)
    _raise_on(err, lib, "flash attention dq backward")
    _count_launch(flash_bwd_dq_cuda, lib, _ENTRY_DQ, d, code, causal)
    return _unpad_heads(d0, dq)[0]


launch_counter(flash_bwd_dq_cuda, *_COUNTS)


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale: float, causal: bool,
                       segment_ids=None, causal_offset: int = 0):
    """Kernel 4, dk and dv of the split backward."""
    b, sq, sk, h, d0, d, code = _check_kernel_inputs(
        "flash_bwd_dkv_cuda", q, k, v, same_as_q=(do,), fp32=(lse, delta))
    if tuple(delta.shape) != (b, sq, h) or tuple(lse.shape) != (b, h, sq):
        raise ValueError("flash_bwd_dkv_cuda: lse must be [b, h, sq] and "
                         "delta [b, sq, h]")
    segs, qs_ptr, ks_ptr = _segment_pointers(
        "flash_bwd_dkv_cuda", segment_ids, b, sq, sk, q.device)
    q, k, v, do = _pad_heads(d, q, k, v, do)
    lib = _kernel_lib()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hetu_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), None, dk.data_ptr(),
            dv.data_ptr(), qs_ptr, ks_ptr, b, sq, sk, h, d, float(scale),
            int(bool(causal)), int(causal_offset), code, 0, stream)
    _raise_on(err, lib, "flash attention dk/dv backward")
    _count_launch(flash_bwd_dkv_cuda, lib, _ENTRY_DKV, d, code, causal)
    return _unpad_heads(d0, dk, dv)


launch_counter(flash_bwd_dkv_cuda, *_COUNTS)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _flash_fwd(q, k, v, scale, causal, segment_ids, causal_offset=0):
    """``(out, lse)``: the plain version on the CPU, kernel 1 on CUDA.
    Meta tensors (the graph's shape inference) get empty results."""
    if q.device.type == "meta":
        b, sq, h, _ = q.shape
        return (torch.empty(q.shape, dtype=q.dtype, device="meta"),
                torch.empty((b, h, sq), dtype=torch.float32, device="meta"))
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, scale, causal, segment_ids,
                                   causal_offset)
    if q.device.type == "cuda":
        return flash_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                              scale, causal, segment_ids, causal_offset)
    raise ValueError(f"no flash attention for device {q.device}")


def _flash_bwd(scale, causal, segment_ids, res, g, causal_offset=0):
    """``(dq, dk, dv)`` from the forward's residuals ``(q, k, v, out,
    lse)`` and the output cotangent ``g``.  On CUDA: the fused kernel 2
    when the JAX package's byte rule picks it (``_use_fused``), else the
    split kernels 3 and 4 with delta from one torch op; on the CPU the
    plain version.  A head dim the kernels do not take is padded here
    once, for both split kernels, and the gradients cut back."""
    do = g[0] if isinstance(g, (tuple, list)) else g
    q, k, v, out, lse = res
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, out, lse, do, scale, causal,
                                   segment_ids, causal_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    d = q.shape[-1]
    use_fused = _use_fused(k.shape[1], d, k.dtype)
    q, k, v, out, do = _pad_heads(_kernel_head_dim(d),
                                  q, k, v, out, do.to(q.dtype).contiguous())
    if use_fused:
        return _unpad_heads(d, *flash_bwd_fused_cuda(
            q, k, v, out, lse, do, scale, causal, segment_ids,
            causal_offset))
    delta = torch.einsum("bshd,bshd->bsh", do.float(), out.float())
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal,
                           segment_ids, causal_offset)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal,
                                segment_ids, causal_offset)
    return _unpad_heads(d, dq, dk, dv)


class _Flash(torch.autograd.Function):
    """Differentiable flash attention; segment ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, scale, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _flash_fwd(q, k, v, scale, causal, segment_ids)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.segment_ids, ctx.scale, ctx.causal = segment_ids, scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv = _flash_bwd(ctx.scale, ctx.causal, ctx.segment_ids,
                                ctx.saved_tensors, g)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    softmax_scale: Optional[float] = None,
                    segment_ids=None) -> torch.Tensor:
    """Flash attention on [b, s, h, d]; differentiable."""
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])
    return _Flash.apply(q, k, v, segment_ids, scale, causal)


def flash_attention_with_lse(q, k, v, causal: bool = True,
                             softmax_scale: Optional[float] = None,
                             segment_ids=None):
    """Forward-only variant returning ``(out, lse)``."""
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])
    return _flash_fwd(q, k, v, scale, causal, segment_ids)
