"""Attention entry points (counterpart of ``hetu_tpu.ops.attention``).

Layout [batch, seq, heads, head_dim].  ``sdpa_reference`` is the plain
scaled-dot-product attention of the JAX package, with its dtype flow:
scores in the inputs' dtype, softmax in fp32, -inf masking, fully-masked
rows giving 0, causal offset ``sk - sq``, and the output in v's dtype.
``sdpa`` sends CUDA tensors to ``flash_attention`` (whose output takes
q's dtype, as the JAX package's flash kernel does) and CPU tensors to
``sdpa_reference``, as the JAX package does off the TPU.  A ``bias`` goes
to ``sdpa_reference`` on any device: neither package has a kernel for it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .flash_attention import flash_attention


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True,
                   softmax_scale: Optional[float] = None,
                   bias: Optional[torch.Tensor] = None,
                   segment_ids: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Plain scaled-dot-product attention; ``segment_ids`` ([b, s])
    restricts attention to equal ids (packed sequences)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    dt = torch.promote_types(q.dtype, k.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(dt), k.to(dt)) * scale
    logits = logits.float()
    if bias is not None:
        logits = logits + bias
    mask = None
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        mask = (ki <= qi + (sk - sq))[None, None]
    if segment_ids is not None:
        seg = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
        mask = seg if mask is None else mask & seg
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(torch.isnan(probs), 0.0, probs)  # fully-masked rows
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def sdpa(q, k, v, causal: bool = True, softmax_scale: Optional[float] = None,
         bias: Optional[torch.Tensor] = None,
         segment_ids: Optional[torch.Tensor] = None,
         use_flash: Optional[bool] = None) -> torch.Tensor:
    """Dispatching attention entry point: flash attention for CUDA
    tensors (``use_flash=None``), the plain version otherwise.
    ``use_flash=True`` on the CPU runs the flash autograd function with
    its plain versions."""
    if use_flash is None:
        use_flash = q.device.type == "cuda"
    if use_flash and bias is None:
        return flash_attention(q, k, v, causal=causal,
                               softmax_scale=softmax_scale,
                               segment_ids=segment_ids)
    return sdpa_reference(q, k, v, causal=causal, softmax_scale=softmax_scale,
                          bias=bias, segment_ids=segment_ids)
