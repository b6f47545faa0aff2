"""Ulysses sequence parallelism: all-to-all head-scatter attention (port
of ``hetu_tpu.parallel.ulysses``).

DeepSpeed-Ulysses-style context parallelism (Jacobs et al., 2023), a
second CP implementation beside the ring:

1. the rank's block arrives sequence-split, ``[b, s_local, h, d]``;
2. an all-to-all over the cp group scatters the heads and gathers the
   sequence: ``[b, s_global, h/cp, d]``, the whole sequence for a slice
   of the heads, so plain flash attention applies (no cross-rank LSE
   correction, balanced by construction);
3. flash attention over the whole sequence (``ops.flash_attention``:
   kernels 1-4 on a CUDA tensor, the plain versions on a CPU one);
4. the reverse all-to-all restores ``[b, s_local, h, d]``.

The JAX package runs ``lax.all_to_all`` inside ``shard_map``; here the
all-to-alls are ``comm.all_to_all_group`` over the mesh's cp group,
whose backward is the reverse all-to-all.  Packed sequences: the
``[b, s_local]`` segment ids are all-gathered over cp, so the attention
over the whole sequence sees the global document boundaries.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import comm
from .mesh import current_mesh
from ..ops.flash_attention import flash_attention


def _check_kv_heads(q, k, v, extra: str) -> None:
    h = q.shape[2]
    for name, x in (("k", k), ("v", v)):
        if x.shape[2] != h:
            raise ValueError(
                f"ulysses needs {name} heads ({x.shape[2]}) equal to q "
                f"heads ({h}) — {extra}")


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str = "cp", causal: bool = True,
                      softmax_scale: Optional[float] = None,
                      segment_ids: Optional[torch.Tensor] = None,
                      mesh=None) -> torch.Tensor:
    """All-to-all sequence-parallel attention on the rank's
    ``[b, s_local, h, d]`` block of a sequence split over ``axis_name``
    (of ``mesh``, or the innermost ``with mesh:``); ``h`` must be
    divisible by the axis size.  ``segment_ids``: the block's
    ``[b, s_local]`` global document ids (-1 pad)."""
    mesh = mesh if mesh is not None else current_mesh()
    cp = comm.axis_size(axis_name, mesh)
    h = q.shape[2]
    if h % cp != 0:
        raise ValueError(
            f"ulysses needs heads ({h}) divisible by the {axis_name!r} "
            f"axis size ({cp}); use ring_attention for h < cp")
    _check_kv_heads(q, k, v,
                    "the flash kernel takes one head count; repeat GQA kv "
                    "heads to match q first (the model path does this)")
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])
    if cp == 1:
        return flash_attention(q, k, v, causal=causal, softmax_scale=scale,
                               segment_ids=segment_ids)
    if q.is_meta:
        return torch.empty(q.shape, dtype=q.dtype, device="meta")

    def seq_gather_head_scatter(x):
        # [b, s_local, h, d] -> [b, s_global, h/cp, d]
        return comm.all_to_all_group(x.contiguous(), axis_name, 2, 1, mesh)

    with comm.comm_tag("ulysses"):
        qg, kg, vg = (seq_gather_head_scatter(x) for x in (q, k, v))
        segs = None
        if segment_ids is not None:
            # the global ids on every rank (the whole sequence is local)
            segs = comm.all_gather(
                segment_ids.to(device=q.device, dtype=torch.int32)
                .contiguous(), axis_name, 1, mesh)
    out = flash_attention(qg, kg, vg, causal=causal, softmax_scale=scale,
                          segment_ids=segs)
    # [b, s_global, h/cp, d] -> [b, s_local, h]: heads back in rank order
    with comm.comm_tag("ulysses"):
        return comm.all_to_all_group(out.contiguous(), axis_name, 1, 2,
                                     mesh)


def ulysses_attention_sharded(q, k, v, mesh, axis_name: str = "cp",
                              causal: bool = True,
                              softmax_scale: Optional[float] = None,
                              batch_axis: Optional[str] = "dp",
                              head_axis: Optional[str] = "tp",
                              segment_ids: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """:func:`ulysses_attention` on the rank's shard of global
    ``[b, s, h, d]`` arrays (sequence over ``axis_name``; the batch over
    ``batch_axis`` and the heads over ``head_axis`` are the rank's
    already).

    A local head count that cp does not divide is zero-padded up to the
    next multiple and the pad heads sliced off the output: attention is
    per head, so pad heads never touch real ones.  The JAX function pads
    the global head count to a multiple of cp x tp before the tp split;
    the rank here holds its tp shard of the unpadded heads and pads that,
    which gives every real head the same result."""
    _check_kv_heads(q, k, v,
                    "repeat GQA kv heads to match q first (the model path "
                    "does this); padding cannot substitute for repetition")
    h = q.shape[2]
    pad = (-h) % mesh.axis_size(axis_name)
    if pad:
        def zpad(x):
            return torch.nn.functional.pad(x, (0, 0, 0, pad))
        q, k, v = zpad(q), zpad(k), zpad(v)
    out = ulysses_attention(q, k, v, axis_name, causal, softmax_scale,
                            segment_ids=segment_ids, mesh=mesh)
    return out[:, :, :h] if pad else out
