"""Model-parallel layers: TP, SP and vocab-parallel (counterpart of
``hetu_tpu.nn.parallel``).

The JAX layers annotate parameters and activations with
``PartitionSpec``s and let GSPMD insert the collectives.  Here each rank
holds its shard (``parallel_parameter`` slices the global value) and the
layers issue the collectives themselves, as Megatron-LM's do, through
the autograd pairs of ``parallel.comm``:

- ``ColumnParallelLinear``: W split along out over tp.  The input enters
  by ``copy_to_group`` (its gradient summed over tp) or, with ``sp``,
  gathered over the sequence (backward reduce-scatter);
  ``gather_output`` gathers the features.
- ``RowParallelLinear``: W split along in; the partial product is
  all-reduced over tp, or with ``sp`` reduce-scattered onto sequence
  shards; the bias is added after.
- ``VocabParallelEmbedding``: a masked local lookup plus an all-reduce
  over tp; ``ParallelEmbedding`` splits the hidden dim (its output stays
  split).
- ``ParallelLayerNorm`` / ``ParallelRMSNorm`` with ``sp``: each rank
  normalizes its sequence shard, so each weight's gradient is summed over
  tp.
- ``vocab_parallel_cross_entropy``: max and sum-exp all-reduced over tp,
  the target's logit picked by its owner; the mean over the valid tokens
  (``ignore_index``) is a global one, a sum and a count reduced over dp
  and over ``seq_axis`` (context parallelism).  Every layout, one device
  included, runs the same reduction: the sum in fp32, the result in the
  logits' dtype.

Context parallelism (``seq_axis``, the model's ``cp_axis``): each rank
holds its contiguous block of the sequence, taken by :func:`seq_shard`
(no communication: ids and labels need no gradient), and every layer
acts on that block; under ``sp`` the block is split again over tp (cp
outer, tp inner, as the JAX layers declare ``P(dp, (cp, tp))``).  The
layers take ``seq_axis`` as the JAX layers do and move nothing over it
(the model passes it to the loss alone); the loss reduces over
it, and the graph records it (``Graph.seq_axes``) so that the optimizer
sums the gradients over it, each rank holding its tokens' part.

On a graph without a mesh each layer is the one-device layer, op for
op.  On a graph with a mesh the layers record their collectives and
their rank-dependent slicing whatever the axes' sizes are, and each op
reads the sizes and the rank's coordinates from the mesh it runs on (a
collective over an axis of size 1 is the identity): a strategy switch
(``DefineAndRunGraph.switch_strategy``) hands the graph a new mesh, and
the recorded ops follow it.  The checks a layout must pass are
registered with the graph (``Graph.add_strategy_check``) and run
against each new mesh before anything moves.  Parameter names and constructor arguments
are the JAX package's; ``ColumnParallelLinear`` takes ``sp`` (the JAX
layer reads it from its input's sharding) and ``blocks`` (a fused
``[q | k | v]`` or SwiGLU weight is split block by block).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import functional as ops
from ..graph.ctor import (ConstantInitializer, Initializer,
                          NormalInitializer, XavierNormalInitializer,
                          parallel_parameter)
from ..graph.graph import get_default_graph
from ..parallel import comm
from ..parallel.dstates import (DUPLICATE, NULL_HETERO_DIM,
                                DistributedStates, DistributedStatesUnion)
from ..parallel.mesh import P
from .module import Module


def sharded(t, pspec=None, tag: Optional[str] = None):
    """The identity: in the JAX package a sharding constraint that GSPMD
    reads; here each layer moves its data itself."""
    return t


def _mesh_of(x):
    g = getattr(x, "graph", None)
    mesh = getattr(g, "mesh", None) if g is not None else None
    return mesh if mesh is not None else comm.current_mesh()


def axis_size_here(axis: Optional[str]) -> int:
    """The size of ``axis`` on the mesh of the graph being built (1
    without one)."""
    mesh = getattr(get_default_graph(), "mesh", None) \
        if axis is not None else None
    return 1 if mesh is None else mesh.axis_size(axis)


def axis_index_here(axis: Optional[str]) -> int:
    """This rank's index on ``axis`` of the graph being built's mesh."""
    mesh = getattr(get_default_graph(), "mesh", None) \
        if axis is not None else None
    return 0 if mesh is None else mesh.axis_index(axis)


def seq_split_over(t, axis: Optional[str]) -> bool:
    """Whether the placeholder ``t`` is fed split over ``axis`` along its
    sequence dim (dim 1, ``P("dp", "cp")``)."""
    from ..parallel.mesh import entry_axes
    spec = getattr(t, "pspec", None)
    return bool(axis) and spec is not None and len(spec) > 1 and \
        axis in entry_axes(spec[1])


def seq_shard(x, axis: str, dim: int = 1):
    """This rank's contiguous block of ``x``'s sequence over ``axis``
    (``x`` itself at size 1, or when it is fed split over ``axis``).  A
    slice, with no communication: the model takes it of ids, labels and
    segment ids.  Records ``axis`` on the graph as one the data is split
    over (``Graph.seq_axes``)."""
    g = getattr(x, "graph", None) or get_default_graph()
    mesh = getattr(g, "mesh", None)
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    g.seq_axes.add(axis)
    if seq_split_over(x, axis):
        return x
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"sequence dim {dim} of {tuple(x.shape)} is not "
                         f"divisible by {axis}={n}")
    w = size // n
    return ops.getitem(x, (slice(None),) * dim + (slice(i * w, (i + 1) * w),))


def _active(x, axis: Optional[str]):
    """The mesh the collective over ``axis`` is recorded on: the graph's
    mesh whatever the axis' size (a switch may give it ranks), or on a
    torch tensor the ambient mesh when the axis has ranks; else None."""
    mesh = _mesh_of(x)
    if not axis or mesh is None:
        return None
    if getattr(x, "graph", None) is not None:
        return mesh
    return mesh if mesh.axis_size(axis) > 1 else None


def _check_strategy(fn) -> None:
    """Registers ``fn(mesh)`` with the graph being built: it raises when
    the layer cannot run on ``mesh`` (checked now and at each switch)."""
    g = get_default_graph()
    mesh = getattr(g, "mesh", None)
    if mesh is not None:
        fn(mesh)
        g.add_strategy_check(fn)


class _RepeatedGradSum(torch.autograd.Function):
    """The identity; the backward sums the gradient rows of the blocks
    that repeat over ``axis`` over the ranks that hold the same part."""

    @staticmethod
    def forward(ctx, w, axis, mesh, blocks, units, dim):
        ctx.args = (axis, mesh, blocks, units, dim)
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        from ..parallel.mesh import _block_split
        axis, mesh, blocks, units, dim = ctx.args
        n, i = mesh.axis_size(axis), mesh.axis_index(axis)
        g = g.clone()
        off, parts = 0, []
        for b, u in zip(blocks, units):
            w, j = _block_split(b, n, i, u)
            if u < n:
                slots = g.new_zeros((u,) + tuple(g.narrow(dim, off, w).shape))
                slots[j] = g.narrow(dim, off, w)
                parts.append((off, w, j, slots))
            off += w
        flat = torch.cat([p[3].reshape(-1) for p in parts])
        with comm.comm_tag("kv_repeat"):
            flat = comm.all_reduce(flat, axis, "sum", mesh)
        k = 0
        for off, w, j, slots in parts:
            got = flat[k:k + slots.numel()].view_as(slots)
            g.narrow(dim, off, w).copy_(got[j])
            k += slots.numel()
        return g, None, None, None, None, None


def _repeated_grad_sum(w, axis: str, blocks, units, dim: int = 0,
                       mesh=None):
    """Whether any block repeats over ``axis`` is read from the mesh the
    op runs on (the identity when none does)."""
    if w.is_meta or mesh is None:
        return w
    n = mesh.axis_size(axis)
    if not any(0 < u < n for u in units):
        return w
    return _RepeatedGradSum.apply(w, axis, mesh, tuple(blocks),
                                  tuple(units), dim)


def _comm_op(name: str, fn, x, mesh, **attrs):
    """A collective as a graph op (or at once on a torch tensor)."""
    return ops._op(name, fn, [x], {"mesh": mesh, **attrs})


def copy_to(x, axis: str):
    """Identity forward; the gradient is summed over ``axis``."""
    mesh = _active(x, axis)
    if mesh is None:
        return x
    return _comm_op("copy_to_group", lambda v, mesh, axis:
                    comm.copy_to_group(v, axis, mesh), x, mesh, axis=axis)


def reduce_from(x, axis: str, grad_scale: float = 1):
    """All-reduce (sum) forward; the gradient passes through."""
    mesh = _active(x, axis)
    if mesh is None:
        return x
    return _comm_op("reduce_from_group", lambda v, mesh, axis, grad_scale:
                    comm.reduce_from_group(v, axis, mesh, grad_scale), x,
                    mesh, axis=axis, grad_scale=grad_scale)


def gather_seq(x, axis: str, dim: int = 1):
    """All-gather along the sequence; the backward reduce-scatters."""
    mesh = _active(x, axis)
    if mesh is None:
        return x
    return _comm_op("sp_gather", lambda v, mesh, axis, dim:
                    comm.gather_from_group(v, axis, dim, mesh), x, mesh,
                    axis=axis, dim=dim)


def scatter_seq(x, axis: str, dim: int = 1):
    """Reduce-scatter onto sequence shards; the backward all-gathers."""
    mesh = _active(x, axis)
    if mesh is None:
        return x
    return _comm_op("sp_reduce_scatter", lambda v, mesh, axis, dim:
                    comm.reduce_scatter_to_group(v, axis, dim, mesh), x,
                    mesh, axis=axis, dim=dim)


def split_seq(x, axis: str, dim: int = 1):
    """This rank's sequence shard of a replicated value; the backward
    all-gathers."""
    mesh = _active(x, axis)
    if mesh is None:
        return x
    return _comm_op("sp_split", lambda v, mesh, axis, dim:
                    comm.split_to_group(v, axis, dim, mesh), x, mesh,
                    axis=axis, dim=dim)


def gather_features(x, axis: str):
    """All-gather the last dim; the backward keeps this rank's slice."""
    mesh = _active(x, axis)
    if mesh is None:
        return x
    return _comm_op("tp_gather_output", lambda v, mesh, axis:
                    comm.gather_output(v, axis, -1, mesh), x, mesh,
                    axis=axis)


def _blocks_ok(blocks, tp: int, name: str, units=None) -> None:
    from ..parallel.mesh import _block_split
    for k, b in enumerate(blocks or ()):
        try:
            _block_split(b, tp, 0, units[k] if units else None)
        except ValueError:
            raise ValueError(f"{name}: block {b} of {tuple(blocks)} is not "
                             f"divisible by tp={tp}") from None


class ColumnParallelLinear(Module):
    """Y = X W^T (+ b), W [out, in] split along out over ``tp_axis``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 gather_output: bool = False, dp_axis: str = "dp",
                 tp_axis: str = "tp", seq_axis: Optional[str] = None,
                 dtype=None, init: Optional[Initializer] = None,
                 name: str = "colp", sp: bool = False,
                 blocks: Optional[Sequence[int]] = None,
                 units: Optional[Sequence[int]] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.gather_output, self.sp = gather_output, sp
        self.dp_axis, self.tp_axis, self.seq_axis = dp_axis, tp_axis, \
            seq_axis
        self.blocks = tuple(blocks) if blocks else None
        self.units = tuple(units) if units and blocks else None
        _blocks_ok(blocks, axis_size_here(tp_axis), name, self.units)
        _check_strategy(lambda mesh: _blocks_ok(
            blocks, mesh.axis_size(tp_axis), name, self.units))
        self.weight = parallel_parameter(
            init or XavierNormalInitializer(), (out_features, in_features),
            pspec=P(tp_axis, None), dtype=dtype, name=f"{name}.weight",
            blocks=blocks, units=self.units)
        if bias:
            self.bias = parallel_parameter(
                ConstantInitializer(0.0), (out_features,), pspec=P(tp_axis),
                dtype=dtype, name=f"{name}.bias", blocks=blocks,
                units=self.units)
        else:
            self.register_parameter("bias", None)

    def _repeated(self, w):
        """``w`` through :func:`_repeated_grad_sum` where a block has
        units (GQA's kv heads): ranks holding the same repeated head sum
        its gradient."""
        mesh = _active(w, self.tp_axis) if self.units else None
        if w is None or mesh is None:
            return w
        return ops._op("repeated_grad_sum", _repeated_grad_sum, [w],
                       {"mesh": mesh, "axis": self.tp_axis,
                        "blocks": self.blocks, "units": self.units})

    def ds(self, num_devices: int, tp: int) -> DistributedStates:
        return DistributedStates(num_devices,
                                 {0: tp, DUPLICATE: num_devices // tp},
                                 order=[-1, 0])

    def forward(self, x):
        x = gather_seq(x, self.tp_axis) if self.sp \
            else copy_to(x, self.tp_axis)
        out = ops.linear(x, self._repeated(self.weight),
                         self._repeated(self.bias), trans_b=True)
        return gather_features(out, self.tp_axis) if self.gather_output \
            else out


class RowParallelLinear(Module):
    """Y = X W^T, W [out, in] split along in over ``tp_axis``; the partial
    product is all-reduced, or with ``sp`` reduce-scattered onto sequence
    shards, and the bias added after."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 sp: bool = False, dp_axis: str = "dp", tp_axis: str = "tp",
                 seq_axis: Optional[str] = None, dtype=None,
                 init: Optional[Initializer] = None, name: str = "rowp"):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.sp = sp
        self.dp_axis, self.tp_axis, self.seq_axis = dp_axis, tp_axis, \
            seq_axis
        self.weight = parallel_parameter(
            init or XavierNormalInitializer(), (out_features, in_features),
            pspec=P(None, tp_axis), dtype=dtype, name=f"{name}.weight")
        if bias:
            self.bias = parallel_parameter(
                ConstantInitializer(0.0), (out_features,), pspec=P(),
                dtype=dtype, name=f"{name}.bias")
        else:
            self.register_parameter("bias", None)

    def ds(self, num_devices: int, tp: int) -> DistributedStates:
        return DistributedStates(num_devices,
                                 {1: tp, DUPLICATE: num_devices // tp},
                                 order=[-1, 1])

    def forward(self, x):
        out = ops.linear(x, self.weight, None, trans_b=True)
        out = scatter_seq(out, self.tp_axis) if self.sp \
            else reduce_from(out, self.tp_axis)
        if self.bias is not None:
            # with sp each rank adds the bias to its own rows: its
            # gradient is summed over tp
            out = out + (copy_to(self.bias, self.tp_axis) if self.sp
                         else self.bias)
        return out


class ParallelEmbedding(Module):
    """Embedding split along the hidden dim; the output stays split on
    it."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 dp_axis: str = "dp", tp_axis: str = "tp", dtype=None,
                 init: Optional[Initializer] = None, name: str = "embed"):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.dp_axis, self.tp_axis = dp_axis, tp_axis
        self.weight = parallel_parameter(
            init or NormalInitializer(0.0, 0.02),
            (num_embeddings, embedding_dim), pspec=P(None, tp_axis),
            dtype=dtype, name=f"{name}.weight")

    def forward(self, ids):
        return ops.embedding_lookup(self.weight, ids)


def _vocab_lookup(table, ids, mesh=None, tp_axis="tp"):
    """The rows of the rank's vocab range (its index on ``tp_axis`` of
    the mesh the op runs on), zero rows elsewhere."""
    if mesh.axis_size(tp_axis) == 1:
        return torch.nn.functional.embedding(ids.long(), table)
    start = mesh.axis_index(tp_axis) * table.shape[0]
    local = ids.long() - start
    inside = (local >= 0) & (local < table.shape[0])
    rows = torch.nn.functional.embedding(
        torch.where(inside, local, torch.zeros_like(local)), table)
    return rows * inside[..., None].to(rows.dtype)


class VocabParallelEmbedding(Module):
    """Embedding split along the vocab: each rank looks up the ids in its
    range (zero rows elsewhere) and the rows are summed over tp."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 dp_axis: str = "dp", tp_axis: str = "tp",
                 seq_axis: Optional[str] = None, dtype=None,
                 init: Optional[Initializer] = None,
                 name: str = "vocab_embed"):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.dp_axis, self.tp_axis, self.seq_axis = dp_axis, tp_axis, \
            seq_axis
        self.weight = parallel_parameter(
            init or NormalInitializer(0.0, 0.02),
            (num_embeddings, embedding_dim), pspec=P(tp_axis, None),
            dtype=dtype, name=f"{name}.weight")

    def ds(self, num_devices: int, tp: int) -> DistributedStates:
        return DistributedStates(num_devices,
                                 {0: tp, DUPLICATE: num_devices // tp},
                                 order=[-1, 0])

    def forward(self, ids):
        mesh = _active(self.weight, self.tp_axis)
        if mesh is None:
            return ops.embedding_lookup(self.weight, ids)
        rows = ops._op("vocab_parallel_lookup", _vocab_lookup,
                       [self.weight, ids],
                       {"mesh": mesh, "tp_axis": self.tp_axis})
        return reduce_from(rows, self.tp_axis)


class ParallelLayerNorm(Module):
    """LayerNorm; with ``sp`` each rank normalizes its sequence shard and
    the weights' gradients are summed over tp."""

    def __init__(self, normalized_shape, sp: bool = False,
                 dp_axis: str = "dp", tp_axis: str = "tp",
                 seq_axis: Optional[str] = None, eps: float = 1e-5,
                 dtype=None, name: str = "ln"):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.sp, self.eps = sp, eps
        self.dp_axis, self.tp_axis, self.seq_axis = dp_axis, tp_axis, \
            seq_axis
        self.weight = parallel_parameter(ConstantInitializer(1.0),
                                         tuple(normalized_shape), pspec=P(),
                                         dtype=dtype, name=f"{name}.weight")
        self.bias = parallel_parameter(ConstantInitializer(0.0),
                                       tuple(normalized_shape), pspec=P(),
                                       dtype=dtype, name=f"{name}.bias")

    def forward(self, x):
        w, b = self.weight, self.bias
        if self.sp:
            w, b = copy_to(w, self.tp_axis), copy_to(b, self.tp_axis)
        return ops.layer_norm(x, w, b, self.eps)


class ParallelRMSNorm(Module):
    """RMSNorm with sequence-parallel support (as ``ParallelLayerNorm``)."""

    def __init__(self, dim: int, sp: bool = False, dp_axis: str = "dp",
                 tp_axis: str = "tp", seq_axis: Optional[str] = None,
                 eps: float = 1e-6, dtype=None, name: str = "rmsnorm"):
        super().__init__()
        self.sp, self.eps = sp, eps
        self.dp_axis, self.tp_axis, self.seq_axis = dp_axis, tp_axis, \
            seq_axis
        self.weight = parallel_parameter(ConstantInitializer(1.0), (dim,),
                                         pspec=P(), dtype=dtype,
                                         name=f"{name}.weight")

    def forward(self, x):
        w = copy_to(self.weight, self.tp_axis) if self.sp else self.weight
        return ops.rms_norm(x, w, self.eps)


def _vocab_parallel_ce(lg, target, mesh=None, tp_axis="tp",
                       ignore_index=None):
    """Per-token cross entropy of vocab-sharded logits: the log-sum-exp
    from the max and the sum of exps reduced over tp, the target's logit
    from its owner.  Computed in fp32 and returned in the logits' dtype,
    as one device's log-softmax is.  At tp 1 (of the mesh the op runs
    on) it is the one-device per-token loss."""
    if mesh.axis_size(tp_axis) == 1:
        return ops._softmax_ce(lg, target, reduction="none",
                               ignore_index=ignore_index)
    start = mesh.axis_index(tp_axis) * lg.shape[-1]
    dtype = lg.dtype
    lg = lg.float()
    if lg.is_meta:
        return lg.new_empty(lg.shape[:-1], dtype=dtype)
    m = comm.all_reduce(lg.detach().amax(-1), tp_axis, "max", mesh)
    s = comm.reduce_from_group(torch.exp(lg - m[..., None]).sum(-1),
                               tp_axis, mesh)
    t = target.long()
    local = t - start
    inside = (local >= 0) & (local < lg.shape[-1])
    picked = torch.gather(lg, -1, torch.where(inside, local, 0)[..., None])
    picked = comm.reduce_from_group(picked[..., 0] * inside, tp_axis, mesh)
    loss = (torch.log(s) + m - picked).to(dtype)
    if ignore_index is not None:
        loss = loss * (t != ignore_index)
    return loss


def _data_sizes(mesh, dp_axis, seq_axis):
    """(dp, cp): the sizes of the axes the batch and the sequence are
    split over (1 for an axis the mesh lacks)."""
    if mesh is None:
        return 1, 1
    return mesh.axis_size(dp_axis), \
        mesh.axis_size(seq_axis) if seq_axis else 1


def _sum_over_data(total, count, mesh, dp_axis, seq_axis):
    """A local sum and count summed over dp and cp.  The sum's backward
    is scaled by dp, because the optimizer averages the gradients over
    dp, and passes unscaled over cp, where it sums them."""
    dp, cp = _data_sizes(mesh, dp_axis, seq_axis)
    for axis, n, scale in ((dp_axis, dp, dp), (seq_axis, cp, 1)):
        if n > 1:
            total = comm.reduce_from_group(total, axis, mesh,
                                           grad_scale=scale)
            if count is not None:
                count = comm.all_reduce(count, axis, "sum", mesh)
    return total, count


def _global_mean(loss_sum, count, mesh, dp_axis, seq_axis=None):
    """The global mean from a local sum and count, both summed over dp
    and cp."""
    loss_sum, count = _sum_over_data(loss_sum, count, mesh, dp_axis,
                                     seq_axis)
    return loss_sum / torch.clamp_min(count, 1)


def _ce_reduce(loss, target, mesh=None, dp_axis="dp", reduction="mean",
               ignore_index=None, seq_axis=None):
    """The batch's loss from per-token losses, one path for every layout
    (``mesh`` None is dp 1): the sum accumulates in fp32 and is summed
    over dp and cp, and the result has the losses' dtype, rounded as one
    device's ``sum`` or ``mean`` rounds it.  With ``ignore_index`` the
    mean is over the valid tokens of the global batch and sequence (their
    count summed over dp and cp), never a mean of means."""
    if loss.is_meta or reduction == "none":
        return loss if reduction == "none" else loss.new_empty(())
    dp, cp = _data_sizes(mesh, dp_axis, seq_axis)
    count = None if reduction == "sum" or ignore_index is None else \
        (target != ignore_index).sum()
    total, count = _sum_over_data(loss.float().sum(), count, mesh, dp_axis,
                                  seq_axis)
    if reduction == "sum":
        return total.to(loss.dtype)
    if ignore_index is None:
        return (total / (loss.numel() * dp * cp)).to(loss.dtype)
    return total.to(loss.dtype) / torch.clamp_min(count, 1)


def vocab_parallel_cross_entropy(logits, target, dp_axis: str = "dp",
                                 tp_axis: str = "tp",
                                 seq_axis: Optional[str] = None,
                                 reduction: str = "mean",
                                 ignore_index: Optional[int] = None):
    """Softmax cross entropy over the whole vocabulary of logits split
    over ``tp_axis``; ``mean`` runs over the valid tokens of the global
    batch and sequence (the rank's rows of ``logits`` and ``target`` its
    block over ``seq_axis``).  Every layout, one device included, takes
    the per-token losses in the logits' dtype and then one reduction."""
    mesh = _active(logits, tp_axis)
    if mesh is not None:
        loss = ops._op("vocab_parallel_cross_entropy", _vocab_parallel_ce,
                       [logits, target],
                       {"mesh": mesh, "tp_axis": tp_axis,
                        "ignore_index": ignore_index})
    else:
        loss = ops.softmax_cross_entropy(logits, target, reduction="none",
                                         ignore_index=ignore_index)
    return ops._op("dp_loss_reduce", _ce_reduce, [loss, target],
                   {"mesh": _mesh_of(logits), "dp_axis": dp_axis, "reduction": reduction,
                    "ignore_index": ignore_index, "seq_axis": seq_axis})


def dp_mean_loss(loss, target, ignore_index: Optional[int],
                 dp_axis: str = "dp", seq_axis: Optional[str] = None):
    """A loss that is the mean over the rank's valid tokens, made the
    mean over the global batch's and sequence's (a sum and a count over
    dp and ``seq_axis``)."""
    mesh = _mesh_of(loss)
    dp, cp = _data_sizes(mesh, dp_axis, seq_axis)
    if mesh is None or (dp * cp == 1 and
                        getattr(loss, "graph", None) is None):
        return loss

    def _impl(l, t, mesh=None, dp_axis="dp", ignore_index=None,
              seq_axis=None):
        dp, cp = _data_sizes(mesh, dp_axis, seq_axis)
        if l.is_meta or dp * cp == 1:
            return l
        count = (t != ignore_index).sum().to(l.dtype) \
            if ignore_index is not None else \
            torch.tensor(float(t.numel()), device=l.device)
        return _global_mean(l * torch.clamp_min(count, 1), count, mesh,
                            dp_axis, seq_axis)
    return ops._op("dp_loss_mean", _impl, [loss, target],
                   {"mesh": mesh, "dp_axis": dp_axis,
                    "ignore_index": ignore_index, "seq_axis": seq_axis})


# ---------------------------------------------------------------------------
# host-side data slicing and the JSON ds config IR (reference config2ds)
# ---------------------------------------------------------------------------

def parallel_data_provider(global_data: np.ndarray, ds: DistributedStates,
                           device_index: int) -> np.ndarray:
    """The local shard of a global host array."""
    return global_data[ds.local_slice(global_data.shape, device_index)]


def config2ds(config: Dict) -> Tuple[DistributedStatesUnion, List[List[int]]]:
    """One JSON ds config entry as a DS union and its device-id groups.
    Keys: ``type`` (placeholder|variable), ``split`` {dim: [counts a
    union]}, ``dup`` [counts], ``device_group_union`` [[ids...]],
    ``zero``."""
    ds_list, dg_list = [], []
    if config["type"] == "placeholder":
        hetero_dim = 0
    elif config["type"] == "variable":
        hetero_dim = -1
    else:
        raise ValueError(f"unsupported type {config['type']!r}")
    hetero_sum = len(config["device_group_union"])
    if hetero_sum == 1:
        hetero_dim = NULL_HETERO_DIM
    for i in range(hetero_sum):
        num_devices = len(config["device_group_union"][i]) * hetero_sum
        split = {int(k): v[i] for k, v in config.get("split", {}).items()}
        states = {DUPLICATE: config["dup"][i], **split}
        zero = False
        if config["type"] == "placeholder":
            order = sorted(split.keys()) + [-1]
        else:
            order = [-1] + sorted(split.keys())
            zero = bool(config.get("zero", False))
        ds_list.append(DistributedStates(num_devices, states, order, zero))
        dg_list.append(list(config["device_group_union"][i]))
    return DistributedStatesUnion(ds_list, hetero_dim), dg_list
