"""Fused LM-head + cross-entropy: the logits are never whole (counterpart
of ``hetu_tpu.ops.fused_ce``).

``fused_linear_cross_entropy(x, w, labels)`` is the mean (or sum) cross
entropy of ``x @ w.T`` against ``labels``.  Its forward splits the tokens
into ``_num_chunks`` chunks and reduces each chunk's logits to its
log-sum-exp and the label's logit before the next; the backward
recomputes each chunk's logits and accumulates dx and dw chunk by chunk.
Only one chunk's ``[n / chunks, vocab]`` logits exist at a time, where
the unfused head keeps all ``[n, vocab]`` of them for the backward.

The chunk products are plain matrix products, which the JAX package
computes with ``dot_general`` outside any Pallas kernel, so they stay
cuBLAS calls here.  JAX asks for fp32 results of bf16 operands
(``preferred_element_type=jnp.float32``); a bf16 ``torch.matmul`` would
round the logits to bf16 first.  On the card a 16-bit product runs as
``torch.mm(a, b, out_dtype=torch.float32)`` where this torch has that
overload; elsewhere (the CPU, which has no such overload) its operands
are taken to fp32, whose products of 16-bit values are exact.
``product_route`` names the choice.
"""
from __future__ import annotations

import torch

_LOW = (torch.bfloat16, torch.float16)


def _num_chunks(n: int, want: int) -> int:
    want = max(1, min(want, n))
    while n % want:
        want -= 1
    return want


def product_route(dtype: torch.dtype, device) -> str:
    """How a chunk product of ``dtype`` operands gets its fp32 result on
    ``device``: ``"mm_out_dtype"``, ``"fp32_operands"`` or ``"fp32"``."""
    if dtype not in _LOW:
        return "fp32"
    if torch.device(device).type == "cuda" and \
            hasattr(torch.ops.aten.mm, "dtype"):
        return "mm_out_dtype"
    return "fp32_operands"


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an fp32 result (see the module docstring)."""
    route = product_route(a.dtype, a.device)
    if route == "mm_out_dtype":
        return torch.mm(a, b, out_dtype=torch.float32)
    if route == "fp32_operands":
        return torch.mm(a.float(), b.float())
    return torch.mm(a, b)


class _FusedLinearCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, labels, ignore_index, num_chunks, reduction):
        if reduction not in ("mean", "sum"):
            raise ValueError(
                f"fused_linear_cross_entropy supports reduction 'mean'/'sum', "
                f"got {reduction!r} (use the unfused softmax_cross_entropy "
                f"for 'none')")
        n, _ = x.shape
        c = _num_chunks(n, num_chunks)
        lbl = labels.long()
        safe = lbl.clamp(0, w.shape[0] - 1)
        valid = lbl != ignore_index
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        lses = []
        wt = w.t()
        for xc, sc, vc in zip(x.chunk(c), safe.chunk(c), valid.chunk(c)):
            logits = _mm32(xc, wt)                            # [nc, V]
            m = logits.amax(dim=-1)
            lse = m + torch.log(torch.exp(logits - m[:, None]).sum(-1))
            picked = logits.gather(1, sc[:, None])[:, 0]
            total = total + torch.where(vc, lse - picked, 0.0).sum()
            lses.append(lse)
            del logits
        n_valid = torch.clamp(valid.sum().float(), min=1.0)
        ctx.save_for_backward(x, w, safe, valid, torch.cat(lses), n_valid)
        ctx.chunks, ctx.reduction = c, reduction
        return total / n_valid if reduction == "mean" else total

    @staticmethod
    def backward(ctx, g):
        x, w, safe, valid, lse, n_valid = ctx.saved_tensors
        c = ctx.chunks
        scale = g / n_valid if ctx.reduction == "mean" else g
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dxs = []
        wt = w.t()
        for xc, sc, vc, lc in zip(x.chunk(c), safe.chunk(c), valid.chunk(c),
                                  lse.chunk(c)):
            p = torch.exp(_mm32(xc, wt) - lc[:, None])         # recompute
            p.scatter_add_(1, sc[:, None],
                           torch.full_like(lc[:, None], -1.0))
            dl = p.mul_((vc.to(p.dtype) * scale)[:, None])      # [nc, V]
            dxs.append(_mm32(dl.to(w.dtype), w))
            dw += _mm32(dl.to(xc.dtype).t(), xc)
            del p, dl
        dx = torch.cat(dxs).to(x.dtype)
        return dx, dw.to(w.dtype), None, None, None, None


def fused_linear_cross_entropy(x, w, labels, ignore_index: int = -100,
                               num_chunks: int = 8, reduction: str = "mean"):
    """Mean/sum CE of ``x @ w.T`` against ``labels`` without keeping the
    logits.  x: [N, H]; w: [V, H]; labels: [N] (``ignore_index``
    masked).  Returns an fp32 scalar."""
    return _FusedLinearCE.apply(x, w, labels, ignore_index, num_chunks,
                                reduction)
