"""The op library (counterpart of ``hetu_tpu.ops.functional``).

Each op is a torch function on tensors.  Given a graph ``Tensor`` it
makes a node of that tensor's graph whose impl is that same function,
as the JAX package's ``_op`` does: a define-and-run or define-by-run
graph records it, an eager graph (``graph("eager")``) runs it at once
on its device and keeps the value on the output Tensor, so a module
called on a concrete batch there runs its forward eagerly (and
``BatchNorm2d`` moves its running statistics).  A torch tensor beside a
graph Tensor is a constant of the node.  Given only torch tensors an op
runs at once and returns torch tensors.  The impls keep the JAX package's
numerics: dtype promotion across operands (fp32 with bf16 gives fp32,
where ``torch.matmul`` alone would refuse), layer norm in x's dtype, RMS
norm in fp32 cast back, GELU with the tanh approximation, log-softmax in
the logits' dtype, biased batch variance, average pools over the
non-padding elements, int32 indices.  An op recorded under
``graph.amp.autocast`` gets its casts folded into its impl here, as the
JAX package's ``_op`` does.

Convolution and pooling are XLA ops in the JAX package, not Pallas
kernels, so they are ``torch.nn.functional``'s here.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtype import torch_dtype
from ..graph import amp
from ..graph.graph import _graph_stack
from ..graph.tensor import Tensor
from .attention import sdpa
from .fused_ce import fused_linear_cross_entropy


def _graph_of(*xs):
    for x in xs:
        if isinstance(x, Tensor) and x.graph is not None:
            return x.graph
    return None


# 64-bit host values narrow as in JAX without x64 (``Graph.as_tensor``)
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _host_value(x, dev):
    """A numpy array or Python number as a tensor on ``dev``."""
    if not isinstance(x, (np.ndarray, np.generic, bool, int, float)):
        return x
    t = torch.as_tensor(np.asarray(x), device=dev)
    return t.to(_NARROW.get(t.dtype, t.dtype))


def _op(op_type: str, impl, inputs: Sequence[Any], attrs=None, name="",
        num_outputs: int = 1):
    if amp._autocast_stack:
        impl = amp.wrap_impl(op_type, impl)
    g = _graph_of(*inputs)
    if g is not None:
        return g.make_op(op_type, impl, inputs, attrs or {}, name,
                         num_outputs=num_outputs)
    dev = next((x.device for x in inputs if isinstance(x, torch.Tensor)),
               None)
    args = [x.to(dev) if isinstance(x, torch.Tensor) else _host_value(x, dev)
            for x in inputs]
    out = impl(*args, **(attrs or {}))
    if num_outputs == 1 and isinstance(out, (tuple, list)) and len(out) == 1:
        return out[0]
    return out


# ---------------------------------------------------------------------------
# arithmetic / unary / binary
# ---------------------------------------------------------------------------

def add(a, b):        return _op("add", torch.add, [a, b])
def sub(a, b):        return _op("sub", torch.sub, [a, b])
def mul(a, b):        return _op("mul", torch.mul, [a, b])
def div(a, b):        return _op("div", torch.true_divide, [a, b])
def neg(a):           return _op("neg", torch.neg, [a])
def reciprocal(a):    return _op("reciprocal", torch.reciprocal, [a])
def abs(a):           return _op("abs", torch.abs, [a])  # noqa: A001
def exp(a):           return _op("exp", torch.exp, [a])
def log(a):           return _op("log", torch.log, [a])
def sqrt(a):          return _op("sqrt", torch.sqrt, [a])
def rsqrt(a):         return _op("rsqrt", torch.rsqrt, [a])
def ceil(a):          return _op("ceil", torch.ceil, [a])
def floor(a):         return _op("floor", torch.floor, [a])
def round(a):         return _op("round", torch.round, [a])  # noqa: A001
def sin(a):           return _op("sin", torch.sin, [a])
def cos(a):           return _op("cos", torch.cos, [a])
def tanh(a):          return _op("tanh", torch.tanh, [a])
def sigmoid(a):       return _op("sigmoid", torch.sigmoid, [a])
def maximum(a, b):    return _op("maximum", torch.maximum, [a, b])
def minimum(a, b):    return _op("minimum", torch.minimum, [a, b])


def pow(a, exponent):  # noqa: A001
    return _op("pow", lambda x, e=None: torch.pow(x, e), [a],
               {"e": exponent})


def clamp(a, min=None, max=None):  # noqa: A002
    return _op("clamp", lambda x, lo=None, hi=None: torch.clamp(x, lo, hi),
               [a], {"lo": min, "hi": max})


def _where(c, x, y):
    return torch.where(c if c.dtype == torch.bool else c != 0, x, y)


def where(cond, a, b):
    """``a`` where ``cond`` is true (or nonzero), else ``b``."""
    return _op("where", _where, [cond, a, b])


def cast(a, dtype):
    dt = torch_dtype(dtype)
    return _op("cast", lambda x, dt=None: x.to(dt), [a], {"dt": dt})


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def relu(a):          return _op("relu", torch.relu, [a])


def leaky_relu(a, alpha=0.01):
    return _op("leaky_relu",
               lambda x, alpha=0.01: F.leaky_relu(x, alpha), [a],
               {"alpha": alpha})


def _gelu(x, approximate=True):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def gelu(a, approximate=True):
    return _op("gelu", _gelu, [a], {"approximate": approximate})


def silu(a):          return _op("silu", F.silu, [a])


swish = silu


def elu(a):           return _op("elu", F.elu, [a])


def _softplus(x):
    # log(1 + e^x) without F.softplus's linear cut above 20
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def softplus(a):      return _op("softplus", _softplus, [a])


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


batch_matmul = matmul


def _linear(x, w, b, trans_b=True):
    # matmul, then the bias, as two roundings (the JAX package's order)
    return _matmul(x, w, trans_b=trans_b) + b


def linear(x, w, bias=None, trans_b=True):
    """y = x @ w^T + b."""
    if bias is None:
        return matmul(x, w, trans_b=trans_b)
    return _op("linear", _linear, [x, w, bias], {"trans_b": trans_b})


def _einsum(*xs, eq=None):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.einsum(eq, *[x.to(dt) for x in xs])


def einsum(equation: str, *operands):
    return _op("einsum", _einsum, list(operands), {"eq": equation})


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(axis)
    return (axis,)


def _dims(x, axis):
    return tuple(range(x.ndim)) if axis is None else axis


def _sum(x, axis=None, keepdims=False):
    # integer sums keep their type (torch widens them to int64)
    dt = None if x.is_floating_point() else x.dtype
    return x.sum(_dims(x, axis), keepdim=keepdims, dtype=dt)


def _mean(x, axis=None, keepdims=False):
    if not x.is_floating_point():
        x = x.float()
    return x.mean(_dims(x, axis), keepdim=keepdims)


def reduce_sum(a, axis=None, keepdims=False):
    return _op("reduce_sum", _sum, [a],
               {"axis": _norm_axis(axis), "keepdims": keepdims})


def reduce_mean(a, axis=None, keepdims=False):
    return _op("reduce_mean", _mean, [a],
               {"axis": _norm_axis(axis), "keepdims": keepdims})


def reduce_max(a, axis=None, keepdims=False):
    return _op("reduce_max",
               lambda x, axis=None, keepdims=False: torch.amax(
                   x, _dims(x, axis), keepdims),
               [a], {"axis": _norm_axis(axis), "keepdims": keepdims})


def reduce_min(a, axis=None, keepdims=False):
    return _op("reduce_min",
               lambda x, axis=None, keepdims=False: torch.amin(
                   x, _dims(x, axis), keepdims),
               [a], {"axis": _norm_axis(axis), "keepdims": keepdims})


def argmax(a, axis=-1):
    """int32 index of the first largest element along ``axis``."""
    return _op("argmax",
               lambda x, axis=-1: torch.argmax(x, axis).to(torch.int32),
               [a], {"axis": axis})


def cumsum(a, axis=-1):
    return _op("cumsum",
               lambda x, axis=-1: torch.cumsum(
                   x, axis, dtype=None if x.is_floating_point() else x.dtype),
               [a], {"axis": axis})


def _topk(x, k=1, axis=-1):
    vals, idx = torch.topk(x, k, dim=axis, largest=True, sorted=True)
    return vals, idx.to(torch.int32)


def topk(a, k, axis=-1):
    """``(values, int32 indices)`` of the ``k`` largest along ``axis``,
    largest first.  On equal values the order of their indices is
    torch's, which may differ from ``lax.top_k``'s lower index first."""
    return _op("topk", _topk, [a], {"k": k, "axis": axis}, num_outputs=2)


# ---------------------------------------------------------------------------
# shape / view ops
# ---------------------------------------------------------------------------

def reshape(a, shape):
    return _op("reshape", lambda x, shape=None: x.reshape(shape), [a],
               {"shape": tuple(shape)})


def _transpose(x, perm=None):
    return x.permute(perm if perm is not None
                     else tuple(reversed(range(x.ndim))))


def transpose(a, perm=None):
    """Permutes the axes (reverses them for ``perm=None``)."""
    return _op("transpose", _transpose, [a],
               {"perm": tuple(perm) if perm is not None else None})


def getitem(a, idx):
    return _op("getitem", lambda x, idx=None: x[idx], [a], {"idx": idx})


def _slice(x, begin=None, size=None):
    for d, (b, n) in enumerate(zip(begin, size)):
        x = x.narrow(d, b, n)      # raises past the end, as lax.slice
    return x


def slice(a, begin, size):  # noqa: A001
    """Static slice: ``size[d]`` elements from ``begin[d]`` on each axis."""
    return _op("slice", _slice, [a],
               {"begin": tuple(begin), "size": tuple(size)})


def _shape_of(a):
    return tuple(a.shape) if hasattr(a, "shape") else np.shape(a)


def _as_strided(x, shape=None, strides=None, offset=0):
    flat = x.reshape(-1)
    idx = torch.full((), offset, dtype=torch.int64, device=x.device)
    for dim, st in zip(shape, strides):
        idx = idx[..., None] + torch.arange(dim, device=x.device) * st
    return flat[idx.reshape(shape)]


def as_strided(a, shape, strides, storage_offset=0):
    """Strided window over ``a``'s flattened elements (element strides,
    as in torch, negative ones too).  It gathers a copy, so overlapping
    windows take summed gradients; a window past the storage raises
    ``ValueError``."""
    size = int(np.prod(_shape_of(a), dtype=np.int64))
    lo = int(storage_offset) + sum(
        (d - 1) * st for d, st in zip(shape, strides) if st < 0)
    hi = int(storage_offset) + sum(
        (d - 1) * st for d, st in zip(shape, strides) if st > 0)
    if lo < 0 or hi >= size:
        raise ValueError(
            f"as_strided window [{lo}, {hi}] exceeds storage of {size} "
            f"elements (shape={tuple(shape)}, strides={tuple(strides)}, "
            f"storage_offset={storage_offset})")
    return _op("as_strided", _as_strided, [a],
               {"shape": tuple(shape), "strides": tuple(strides),
                "offset": int(storage_offset)})


def _split(x, n=2, axis=0):
    if x.shape[axis] % n:
        raise ValueError(f"array split does not result in an equal "
                         f"division: {x.shape[axis]} into {n}")
    return tuple(torch.split(x, x.shape[axis] // n, dim=axis))


def split(a, num_chunks, axis=0):
    """``num_chunks`` equal parts along ``axis`` (an uneven division
    raises ``ValueError``)."""
    return _op("split", _split, [a], {"n": num_chunks, "axis": axis},
               num_outputs=num_chunks)


def concat(tensors, axis=0):
    return _op("concat", lambda *xs, axis=0: torch.cat(xs, dim=axis),
               list(tensors), {"axis": axis})


concatenate = concat


def stack(tensors, axis=0):
    return _op("stack", lambda *xs, axis=0: torch.stack(xs, dim=axis),
               list(tensors), {"axis": axis})


def _pad(x, paddings=None, value=0.0):
    flat = [p for lo_hi in reversed(paddings) for p in lo_hi]
    return F.pad(x, flat, value=value)


def pad(a, paddings, value=0.0):
    """Constant padding, ``paddings`` a ``(before, after)`` pair per axis."""
    return _op("pad", _pad, [a],
               {"paddings": tuple(map(tuple, paddings)), "value": value})


def broadcast_to(a, shape):
    return _op("broadcast_to",
               lambda x, shape=None: torch.broadcast_to(x, shape),
               [a], {"shape": tuple(shape)})


def triu(a, k=0):
    return _op("triu", lambda x, k=0: torch.triu(x, k), [a], {"k": k})


def tril(a, k=0):
    return _op("tril", lambda x, k=0: torch.tril(x, k), [a], {"k": k})


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------

def _wrap(idx, n):
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


def _gather(x, idx, axis=0):
    # take_along_axis: the index broadcasts against x off the axis
    ax = axis % x.ndim
    xs, ids = list(x.shape), list(idx.shape)
    for d in range(x.ndim):
        if d != ax:
            xs[d] = ids[d] = max(xs[d], ids[d])
    return torch.gather(x.expand(xs), ax, _wrap(idx, x.shape[ax]).expand(ids))


def gather(a, indices, axis=0):
    """``take_along_axis``: ``out[..., i, ...] = a[..., indices[..., i,
    ...], ...]`` along ``axis``."""
    return _op("gather", _gather, [a, indices], {"axis": axis})


def _index_select(x, idx, axis=0):
    ax = axis % x.ndim
    flat = torch.index_select(x, ax, _wrap(idx, x.shape[ax]).reshape(-1))
    return flat.reshape(x.shape[:ax] + idx.shape + x.shape[ax + 1:])


def index_select(a, indices, axis=0):
    """``take``: the slices of ``a`` at ``indices`` (any shape) along
    ``axis``."""
    return _op("index_select", _index_select, [a, indices], {"axis": axis})


def embedding_lookup(table, ids):
    """Rows of ``table`` at ``ids`` (dense gradient)."""
    return _op("embedding_lookup", lambda t, i: F.embedding(i.long(), t),
               [table, ids])


def _one_hot(i, n=None, dt=None):
    return (i[..., None] == torch.arange(n, device=i.device)).to(dt)


def one_hot(ids, num_classes, dtype=torch.float32):
    """One-hot rows; an id outside ``[0, num_classes)`` gives a zero row,
    as in JAX (``F.one_hot`` would raise)."""
    return _op("one_hot", _one_hot, [ids],
               {"n": num_classes, "dt": torch_dtype(dtype)})


# ---------------------------------------------------------------------------
# softmax and losses
# ---------------------------------------------------------------------------

def softmax(a, axis=-1):
    return _op("softmax", lambda x, axis=-1: torch.softmax(x, axis), [a],
               {"axis": axis})


def log_softmax(a, axis=-1):
    return _op("log_softmax", lambda x, axis=-1: torch.log_softmax(x, axis),
               [a], {"axis": axis})


def _reduce_loss(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _nll(lp, t, reduction="mean"):
    picked = torch.gather(lp, -1, t.long()[..., None])[..., 0]
    return _reduce_loss(-picked, reduction)


def nll_loss(log_probs, target, reduction="mean"):
    return _op("nll_loss", _nll, [log_probs, target],
               {"reduction": reduction})

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
    return _reduce_loss(loss, reduction)


def softmax_cross_entropy(logits, target, reduction="mean",
                          ignore_index: Optional[int] = None):
    """Sparse (integer) or dense-label (float) softmax cross entropy;
    with ``ignore_index`` the mean runs over the kept positions (at
    least 1)."""
    return _op("softmax_cross_entropy", _softmax_ce, [logits, target],
               {"reduction": reduction, "ignore_index": ignore_index})


sparse_softmax_cross_entropy = softmax_cross_entropy


def mse_loss(pred, target, reduction="mean"):
    return _op("mse_loss",
               lambda p, t, reduction="mean": _reduce_loss(
                   (p - t) ** 2, reduction),
               [pred, target], {"reduction": reduction})


def _bce(p, t, reduction="mean", with_logits=False):
    if with_logits:
        loss = torch.clamp_min(p, 0) - p * t + \
            torch.log1p(torch.exp(-torch.abs(p)))
    else:
        eps = 1e-12     # inside the log, where torch clamps it at -100
        loss = -(t * torch.log(p + eps) + (1 - t) * torch.log(1 - p + eps))
    return _reduce_loss(loss, reduction)


def binary_cross_entropy(pred, target, reduction="mean", with_logits=False):
    return _op("bce", _bce, [pred, target],
               {"reduction": reduction, "with_logits": with_logits})


def kl_div(log_probs, target, reduction="mean"):
    """``target * (log target - log_probs)``; ``"mean"`` over every
    element."""
    return _op("kl_div",
               lambda lp, t, reduction="mean": _reduce_loss(
                   t * (torch.log(torch.clamp_min(t, 1e-12)) - lp),
                   reduction),
               [log_probs, target], {"reduction": reduction})


def fused_lm_cross_entropy(x, weight, labels, ignore_index=-100,
                           num_chunks: int = 8, reduction: str = "mean"):
    """LM-head matmul + CE fused, the logits never whole
    (``ops.fused_ce``).  x: [b, s, h] or [n, h]; weight: [vocab, h];
    labels match x's leading dims."""
    def _impl(x, w, lbl, ignore_index=-100, num_chunks=8,
              reduction="mean"):
        n = 1
        for d in x.shape[:-1]:
            n *= d
        return fused_linear_cross_entropy(
            x.reshape(n, x.shape[-1]), w, lbl.reshape(n), ignore_index,
            num_chunks, reduction)

    return _op("fused_lm_cross_entropy", _impl, [x, weight, labels],
               {"ignore_index": ignore_index, "num_chunks": num_chunks,
                "reduction": reduction})


def check_finite(x):
    """1.0 (fp32) when every element of ``x`` is finite, else 0.0."""
    return _op("check_finite",
               lambda v: torch.isfinite(v).all().to(torch.float32), [x])


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


def _bn_axes(x):
    return (0,) + tuple(range(2, x.ndim))


def _bn_norm(x, s, b, mean, var, eps):
    shape = [1, -1] + [1] * (x.ndim - 2)
    inv = torch.rsqrt(var.reshape(shape) + eps)
    return (x - mean.reshape(shape)) * inv * s.reshape(shape) + \
        b.reshape(shape)


def _bn_batch(x, s, b, eps=1e-5):
    axes = _bn_axes(x)
    return _bn_norm(x, s, b, x.mean(axes), x.var(axes, correction=0), eps)


def _bn_running(x, s, b, rm, rv, eps=1e-5):
    return _bn_norm(x, s, b, rm, rv, eps)


def batch_norm(x, scale, bias, running_mean=None, running_var=None,
               training=True, eps=1e-5):
    """BatchNorm over NCHW/NC: batch statistics (the biased variance, as
    ``jnp.var``) in training or without running statistics, else the
    running ones.  Pure: ``nn.BatchNorm2d`` keeps the running
    statistics (``batch_norm_stats``)."""
    if training or running_mean is None:
        return _op("batch_norm", _bn_batch, [x, scale, bias], {"eps": eps})
    return _op("batch_norm", _bn_running,
               [x, scale, bias, running_mean, running_var], {"eps": eps})


def _bn_stats(x):
    axes = _bn_axes(x)
    return x.mean(axes), x.var(axes, correction=0)


def batch_norm_stats(x):
    """(mean, biased variance) over the non-channel axes of NCHW/NC."""
    return _op("batch_norm_stats", _bn_stats, [x], num_outputs=2)


def _instance_norm(x, eps=1e-7):
    axes = tuple(range(2, x.ndim))
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


def instance_norm(x, eps=1e-7):
    return _op("instance_norm", _instance_norm, [x], {"eps": eps})


# ---------------------------------------------------------------------------
# convolution and pooling
# ---------------------------------------------------------------------------

def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv2d(x, w, b=None, strides=None, pads=None):
    dt = torch.promote_types(x.dtype, w.dtype)
    (t, bo), (le, r) = pads
    if t == bo and le == r:
        out = F.conv2d(x.to(dt), w.to(dt), stride=strides, padding=(t, le))
    else:
        out = F.conv2d(F.pad(x.to(dt), (le, r, t, bo)), w.to(dt),
                       stride=strides)
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    return out


def conv2d(x, w, bias=None, stride=1, padding=0):
    """NCHW by OIHW convolution; ``padding`` an int, a pair, or a
    ``(before, after)`` pair per spatial axis.  The bias is added after
    the product, as in the JAX package."""
    if isinstance(padding, int):
        pads = ((padding, padding), (padding, padding))
    else:
        pads = tuple(tuple(p) if isinstance(p, (list, tuple)) else (p, p)
                     for p in padding)
    attrs = {"strides": _pair(stride), "pads": pads}
    if bias is None:
        return _op("conv2d",
                   lambda x, w, strides=None, pads=None: _conv2d(
                       x, w, None, strides, pads), [x, w], attrs)
    return _op("conv2d", _conv2d, [x, w, bias], attrs)


def _pool_args(kernel_size, stride, padding):
    k = _pair(kernel_size)
    return {"k": k, "s": k if stride is None else _pair(stride),
            "p": _pair(padding)}


def _max_pool(x, k=None, s=None, p=None):
    xp = F.pad(x, (p[1], p[1], p[0], p[0]), value=float("-inf"))
    return F.max_pool2d(xp, k, s)


def max_pool(x, kernel_size, stride=None, padding=0):
    """Max over windows of NCHW; the padding is -inf."""
    return _op("max_pool", _max_pool, [x],
               _pool_args(kernel_size, stride, padding))


def _avg_pool(x, k=None, s=None, p=None):
    pad = (p[1], p[1], p[0], p[0])
    sums = F.avg_pool2d(F.pad(x, pad), k, s, divisor_override=1)
    ones = torch.ones((1, 1) + x.shape[2:], dtype=x.dtype, device=x.device)
    counts = F.avg_pool2d(F.pad(ones, pad), k, s, divisor_override=1)
    return sums / counts


def avg_pool(x, kernel_size, stride=None, padding=0):
    """Mean over windows of NCHW, each over its non-padding elements
    (``count_include_pad=False``)."""
    return _op("avg_pool", _avg_pool, [x],
               _pool_args(kernel_size, stride, padding))


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


def parallel_attention(q, k, v, causal=True, softmax_scale=None,
                       cp_axis: str = "cp", batch_axis: str = "dp",
                       head_axis: str = "tp", segment_ids=None,
                       cp_impl: str = "ring"):
    """Context-parallel attention (reference ParallelAttentionOp): q, k, v
    are the rank's ``[b, s_local, h, d]`` blocks of a sequence split over
    ``cp_axis`` of the graph's mesh (contiguous blocks, as the model
    holds them); ``segment_ids`` the block's ``[b, s_local]`` document
    ids (-1 pad), which ride the KV ring.

    ``cp_impl``: "ring" (``parallel.ring_attention``: KV ring plus the
    online LSE correction) or "ulysses" (``parallel.ulysses``: all-to-all
    head scatter; a local head count cp does not divide is zero-padded).
    A cp axis of 1 is ``attention``.  The op records ``cp_axis`` on the
    graph as an axis the data is split over (``Graph.seq_axes``)."""
    g = _graph_of(q, k, v)
    mesh = getattr(g, "mesh", None) if g is not None else None
    if g is None:
        from ..parallel.mesh import current_mesh
        mesh = current_mesh()
    if mesh is None or cp_axis not in mesh.axis_names:
        raise ValueError(
            f"parallel_attention requires a graph mesh with axis "
            f"{cp_axis!r}; got mesh={mesh}. Use ops.attention for non-CP "
            f"runs instead of silently dropping context parallelism.")
    if cp_impl not in ("ring", "ulysses"):
        raise ValueError(f"cp_impl must be 'ring' or 'ulysses', "
                         f"got {cp_impl!r}")
    if mesh.shape[cp_axis] == 1:
        return attention(q, k, v, causal=causal, softmax_scale=softmax_scale,
                         segment_ids=segment_ids)
    if g is not None:
        g.seq_axes.add(cp_axis)
    from ..parallel.ring_attention import ring_attention_sharded
    from ..parallel.ulysses import ulysses_attention_sharded
    sharded_attn = ring_attention_sharded if cp_impl == "ring" \
        else ulysses_attention_sharded

    def _impl(q, k, v, segment_ids=None, causal=True, softmax_scale=None):
        return sharded_attn(q, k, v, mesh, axis_name=cp_axis, causal=causal,
                            softmax_scale=softmax_scale,
                            batch_axis=batch_axis, head_axis=head_axis,
                            segment_ids=segment_ids)
    attrs = {"causal": causal, "softmax_scale": softmax_scale}
    if segment_ids is None:
        return _op("parallel_attention",
                   lambda q, k, v, **kw: _impl(q, k, v, None, **kw),
                   [q, k, v], attrs)
    return _op("parallel_attention", _impl, [q, k, v, segment_ids], attrs)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def _constant(value):
    """``value`` as a constant of the innermost graph, or itself outside
    one."""
    return _graph_stack[-1].as_tensor(value) if _graph_stack else value


def arange(start, stop=None, step=1, dtype=torch.int32):
    if stop is None:
        start, stop = 0, start
    return _constant(torch.arange(start, stop, step, dtype=torch_dtype(dtype)))


def full(shape, fill_value, dtype=torch.float32):
    return _constant(torch.full(tuple(shape), fill_value,
                                dtype=torch_dtype(dtype)))


def zeros(shape, dtype=torch.float32):
    return full(shape, 0.0, dtype)


def ones(shape, dtype=torch.float32):
    return full(shape, 1.0, dtype)


__all__ = ["abs", "add", "arange", "argmax", "as_strided", "attention",
           "avg_pool", "batch_matmul", "batch_norm", "batch_norm_stats",
           "binary_cross_entropy", "broadcast_to", "cast", "ceil",
           "check_finite", "clamp", "concat", "concatenate", "conv2d", "cos",
           "cumsum", "div", "dropout", "einsum", "elu", "embedding_lookup",
           "exp", "floor", "full", "fused_lm_cross_entropy", "gather",
           "gelu", "getitem", "index_select", "instance_norm", "kl_div",
           "layer_norm", "leaky_relu", "linear", "log", "log_softmax",
           "matmul", "max_pool", "maximum", "minimum", "mse_loss", "mul",
           "neg", "nll_loss", "one_hot", "ones", "pad", "parallel_attention",
           "pow", "reciprocal", "reduce_max", "reduce_mean", "reduce_min",
           "reduce_sum", "relu", "repeat_kv", "reshape", "rms_norm",
           "rotary_embed", "round", "rsqrt", "sigmoid", "silu", "sin",
           "slice", "softmax", "softmax_cross_entropy", "softplus",
           "sparse_softmax_cross_entropy", "split", "sqrt", "stack", "sub",
           "swiglu", "swish", "tanh", "topk", "transpose", "tril", "triu",
           "where", "zeros"]
