"""The ops the model uses (counterpart of ``hetu_tpu.ops.functional``).

Each op is a torch function on tensors.  Given a graph ``Tensor`` it
records a node whose impl is that same function, as the JAX package's
``_op`` does; given torch tensors it runs at once.  The impls keep the
JAX package's numerics: dtype promotion across operands (fp32 with bf16
gives fp32, where ``torch.matmul`` alone would refuse), layer norm in x's
dtype, RMS norm in fp32 cast back, GELU with the tanh approximation, and
log-softmax in the logits' dtype.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.tensor import Tensor
from .attention import sdpa


def _graph_of(*xs):
    for x in xs:
        if isinstance(x, Tensor) and x.graph is not None:
            return x.graph
    return None


def _op(op_type: str, impl, inputs: Sequence[Any], attrs=None, name=""):
    g = _graph_of(*inputs)
    if g is None:
        dev = next((x.device for x in inputs if isinstance(x, torch.Tensor)),
                   None)
        args = [torch.as_tensor(x, device=dev) if isinstance(x, np.ndarray)
                else x for x in inputs]
        return impl(*args, **(attrs or {}))
    return g.make_op(op_type, impl, inputs, attrs or {}, name)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def add(a, b):
    return _op("add", torch.add, [a, b])


def mul(a, b):
    return _op("mul", torch.mul, [a, b])


def reduce_sum(a, axis=None, keepdims=False):
    return _op("reduce_sum",
               lambda x, axis=None, keepdims=False: x.sum() if axis is None
               else x.sum(axis, keepdim=keepdims),
               [a], {"axis": axis, "keepdims": keepdims})


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def _gelu(x, approximate=True):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def gelu(a, approximate=True):
    return _op("gelu", _gelu, [a], {"approximate": approximate})


def _swiglu(x):
    x1, x2 = x.chunk(2, dim=-1)
    return F.silu(x1) * x2


def swiglu(a):
    """out = silu(x1) * x2 for x = [x1 | x2] on the last dim."""
    return _op("swiglu", _swiglu, [a])


# ---------------------------------------------------------------------------
# matmul family
# ---------------------------------------------------------------------------

class _PromotedMatmul(torch.autograd.Function):
    """``x @ w`` for a 2-D ``w`` of another dtype, both taken to the
    promoted dtype (fp32 activations with bf16 weights).  It saves the
    operands as they came and casts again in the backward, so autograd
    keeps a bf16 weight once instead of an fp32 copy of it."""

    @staticmethod
    def forward(ctx, x, w, dt):
        ctx.save_for_backward(x, w)
        ctx.dt = dt
        return torch.matmul(x.to(dt), w.to(dt))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.matmul(g, w.to(ctx.dt).t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.matmul(x.to(ctx.dt).reshape(-1, x.shape[-1]).t(),
                              g.reshape(-1, g.shape[-1])).to(w.dtype)
        return gx, gw, None


def _matmul(x, y, trans_a=False, trans_b=False):
    if trans_a:
        x = x.transpose(-1, -2)
    if trans_b:
        y = y.transpose(-1, -2)
    dt = torch.promote_types(x.dtype, y.dtype)
    if x.dtype == y.dtype:
        return torch.matmul(x, y)
    if y.dim() == 2 and x.device.type != "meta":
        return _PromotedMatmul.apply(x, y, dt)
    return torch.matmul(x.to(dt), y.to(dt))


def matmul(a, b, trans_a=False, trans_b=False):
    return _op("matmul", _matmul, [a, b],
               {"trans_a": trans_a, "trans_b": trans_b})


def _linear(x, w, b, trans_b=True):
    # matmul, then the bias, as two roundings (the JAX package's order)
    return _matmul(x, w, trans_b=trans_b) + b


def linear(x, w, bias=None, trans_b=True):
    """y = x @ w^T + b."""
    if bias is None:
        return matmul(x, w, trans_b=trans_b)
    return _op("linear", _linear, [x, w, bias], {"trans_b": trans_b})


# ---------------------------------------------------------------------------
# shape / view ops
# ---------------------------------------------------------------------------

def reshape(a, shape):
    return _op("reshape", lambda x, shape=None: x.reshape(shape), [a],
               {"shape": tuple(shape)})


def getitem(a, idx):
    return _op("getitem", lambda x, idx=None: x[idx], [a], {"idx": idx})


def embedding_lookup(table, ids):
    """Rows of ``table`` at ``ids`` (dense gradient)."""
    return _op("embedding_lookup", lambda t, i: F.embedding(i.long(), t),
               [table, ids])


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

class _SparseNLL(torch.autograd.Function):
    """``-log_softmax(logits)[target]`` per position, the log-softmax in
    the logits' dtype.  It saves the logits alone and rebuilds the softmax
    in the backward: one [N, V] buffer there instead of the log-softmax
    output, its zeroed gradient and the logits' gradient."""

    @staticmethod
    def forward(ctx, lg, t):
        ctx.save_for_backward(lg, t)
        lp = torch.log_softmax(lg, dim=-1)
        return -torch.gather(lp, -1, t[..., None])[..., 0]

    @staticmethod
    def backward(ctx, g):
        lg, t = ctx.saved_tensors
        grad = torch.softmax(lg, dim=-1).mul_(g[..., None].to(lg.dtype))
        grad.scatter_add_(-1, t[..., None], -g[..., None].to(lg.dtype))
        return grad, None


def _softmax_ce(lg, t, reduction="mean", ignore_index=None):
    if t.is_floating_point():
        loss = -(t * torch.log_softmax(lg, dim=-1)).sum(-1)
    else:
        tl = t.long()
        safe = tl if ignore_index is None else \
            torch.where(tl == ignore_index, 0, tl)
        if lg.device.type == "meta":
            loss = torch.empty(lg.shape[:-1], dtype=lg.dtype, device="meta")
        else:
            loss = _SparseNLL.apply(lg, safe)
        if ignore_index is not None:
            mask = tl != ignore_index
            loss = loss * mask
            if reduction == "mean":
                return loss.sum() / torch.clamp_min(mask.sum(), 1)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def softmax_cross_entropy(logits, target, reduction="mean",
                          ignore_index: Optional[int] = None):
    """Sparse (integer) or dense-label softmax cross entropy; with
    ``ignore_index`` the mean runs over the kept positions."""
    return _op("softmax_cross_entropy", _softmax_ce, [logits, target],
               {"reduction": reduction, "ignore_index": ignore_index})


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def _layer_norm(x, s, b, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * s + b


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last dim, computed in x's dtype."""
    return _op("layer_norm", _layer_norm, [x, scale, bias], {"eps": eps})


def _rms_norm(x, s, eps=1e-6):
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (out * s.float()).to(x.dtype)


def rms_norm(x, scale, eps=1e-6):
    """RMSNorm, computed in fp32 and cast back to x's dtype."""
    return _op("rms_norm", _rms_norm, [x, scale], {"eps": eps})


# ---------------------------------------------------------------------------
# dropout, GQA, rotary, attention
# ---------------------------------------------------------------------------

def _dropout(x, p=0.5, generator=None):
    if x.device.type == "meta":
        return torch.empty_like(x)
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def dropout(x, p=0.5, training=True, generator=None):
    """Inverted dropout.  p = 0 (or eval) is the identity; p > 0 draws from
    ``generator`` (default: the graph's), not JAX's bits."""
    if not training or p == 0.0:
        return x
    if generator is None:
        g = _graph_of(x)
        generator = g.generator if g is not None else None
    return _op("dropout", _dropout, [x], {"p": p, "generator": generator})


def _repeat_kv(x, n=1):
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n, d).reshape(b, s, h * n, d)


def repeat_kv(x, n_rep: int):
    """[b, s, kv_heads, d] -> [b, s, kv_heads * n_rep, d]."""
    if n_rep == 1:
        return x
    return _op("repeat_kv", _repeat_kv, [x], {"n": n_rep})


def _rotary(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def rotary_embed(x, cos, sin):
    """Rotary position embedding (halves layout); fp32 tables promote
    bf16 inputs to fp32, as in the JAX package."""
    return _op("rotary", _rotary, [x, cos, sin])


def attention(q, k, v, causal=True, softmax_scale=None, use_flash=None,
              segment_ids=None):
    """Scaled-dot-product attention on [b, s, h, d] (``ops.attention.
    sdpa``).  ``use_flash=None`` is decided by the device: in a graph by
    the graph's device when the op is recorded, so shape inference follows
    the path that will run."""
    g = _graph_of(q, k, v)
    if use_flash is None and g is not None:
        use_flash = g.device.type == "cuda"
    if segment_ids is None:
        def _impl(q, k, v, causal=True, softmax_scale=None, use_flash=None):
            return sdpa(q, k, v, causal=causal, softmax_scale=softmax_scale,
                        use_flash=use_flash)
        return _op("attention", _impl, [q, k, v],
                   {"causal": causal, "softmax_scale": softmax_scale,
                    "use_flash": use_flash})

    def _impl_segs(q, k, v, segs, causal=True, softmax_scale=None,
                   use_flash=None):
        return sdpa(q, k, v, causal=causal, softmax_scale=softmax_scale,
                    use_flash=use_flash, segment_ids=segs)
    return _op("attention", _impl_segs, [q, k, v, segment_ids],
               {"causal": causal, "softmax_scale": softmax_scale,
                "use_flash": use_flash})


__all__ = ["add", "attention", "dropout", "embedding_lookup",
           "gelu", "getitem", "layer_norm", "linear", "matmul", "mul",
           "reduce_sum", "repeat_kv", "reshape", "rms_norm", "rotary_embed",
           "softmax_cross_entropy", "swiglu"]
