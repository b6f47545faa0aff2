"""Capacity-free MoE dispatch: the blocked group GEMM (counterpart of
``hetu_tpu.ops.moe_dispatch``).

The (token, expert) assignments are sorted by expert and each expert's
group padded to a block multiple, so that every ``[B, d]`` block of
tokens multiplies exactly one expert's weights: two batched products
over ``G = n_pad / B`` blocks, where ``n_pad`` is the static upper bound
``T*k + E*(B-1)`` rounded up, so no shape depends on the data.  The
gradient flows through the gathers, the scatter-add and the gate
weights; the integer plumbing carries none.

The serving step replays this inside a CUDA graph, so nothing here
reads a device value on the host: the per-expert counts are a
``scatter_add_`` (``torch.bincount`` reads its maximum back), and there
is no ``.item()``, ``nonzero``, boolean-mask indexing or
``repeat_interleave`` by a tensor.  The JAX package computes these
products outside any Pallas kernel; here they are ``torch.bmm``.

``capacity_tokens`` and ``pick_block_size`` are plain Python, copied
from the JAX module so that the port imports nothing of it.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def capacity_tokens(num_tokens: int, num_experts: int, k: int,
                    capacity_factor: float) -> int:
    """Tokens an expert takes under GShard's routing: ``k * ceil(T/E *
    cf)``."""
    return int(k) * math.ceil(num_tokens / num_experts
                              * float(capacity_factor))


def pick_block_size(n_assign: int, num_experts: int) -> int:
    """The group-GEMM block: the largest of 512 ... 8 whose per-expert
    padding (under ``E`` blocks) stays small beside the ``T*k``
    assignments."""
    for cand in (512, 256, 128, 64, 32, 16, 8):
        if n_assign >= num_experts * cand:
            return cand
    return 8


def _promoted(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def blocked_group_gemm(xt: torch.Tensor, topi: torch.Tensor,
                       topv: torch.Tensor, w1: torch.Tensor,
                       b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                       act: Callable[[torch.Tensor], torch.Tensor],
                       block: Optional[int] = None) -> torch.Tensor:
    """Dropless top-k expert FFN.

    xt: [T, d] tokens; topi/topv: [T, k] expert ids / gate weights;
    w1: [E, d, f], b1: [E, 1, f], w2: [E, f, d], b2: [E, 1, d].
    Returns the combined output [T, d] in fp32.  The products take the
    promoted dtype of their operands, as ``jnp.einsum`` does.
    """
    T, d = xt.shape
    E = w1.shape[0]
    k = topi.shape[-1]
    n = T * k
    B = block or pick_block_size(n, E)
    n_pad = ((n + E * (B - 1)) // B + 1) * B          # static upper bound
    G = n_pad // B
    if xt.is_meta:
        return xt.new_empty((T, d), dtype=torch.float32)
    dev = xt.device
    e_flat = topi.reshape(-1).long()
    t_flat = torch.arange(n, device=dev) // k
    w_flat = topv.reshape(-1).float()
    # a stable sort by expert keeps token order inside each group
    order = torch.sort(e_flat, stable=True).indices
    e_sorted, t_sorted, w_sorted = e_flat[order], t_flat[order], \
        w_flat[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))            # [E] tokens/expert
    padded = (counts + B - 1) // B * B
    src_off = torch.cumsum(counts, 0) - counts         # group starts, sorted
    dst_off = torch.cumsum(padded, 0) - padded         # block-aligned starts
    dst = dst_off[e_sorted] + torch.arange(n, device=dev) - src_off[e_sorted]
    slot_tok = torch.full((n_pad,), -1, dtype=torch.long,
                          device=dev).scatter(0, dst, t_sorted)
    slot_w = torch.zeros(n_pad, dtype=torch.float32, device=dev).scatter(
        0, dst, w_sorted)
    # each block lies inside one expert's padded region: its expert is
    # the first whose region ends after the block's start
    blk_start = torch.arange(G, device=dev) * B
    blk_e = torch.searchsorted(torch.cumsum(padded, 0), blk_start,
                               right=True).clamp(0, E - 1)
    live = (slot_tok >= 0)[:, None]
    tok = slot_tok.clamp(min=0)
    xg = torch.where(live, xt[tok], torch.zeros((), dtype=xt.dtype,
                                                device=dev))
    xg, w1g, b1g = _promoted(xg.reshape(G, B, d), w1[blk_e], b1[blk_e])
    h = act(torch.bmm(xg, w1g) + b1g)
    h, w2g, b2g = _promoted(h, w2[blk_e], b2[blk_e])
    y = torch.bmm(h, w2g) + b2g
    y = y.reshape(n_pad, d).float() * slot_w[:, None]
    y = torch.where(live, y, torch.zeros((), device=dev))
    return torch.zeros((T, d), dtype=torch.float32, device=dev).index_add(
        0, tok, y)


__all__ = ["capacity_tokens", "pick_block_size", "blocked_group_gemm"]
