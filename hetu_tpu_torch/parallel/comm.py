"""Collectives over a mesh axis (counterpart of ``hetu_tpu.parallel.comm``).

The JAX package emits XLA collectives inside ``shard_map`` over a named
axis.  SPMD here is by process, so every function takes the axis name
and runs ``torch.distributed`` on that axis's process group of the mesh
(``mesh=``, or the innermost ``with mesh:`` block's); ``shard_map`` has
no twin.  At axis size 1 each is the identity.

==============================  =====================================
``AllReduce``                   :func:`all_reduce`
``AllGather(gather_dim)``       :func:`all_gather`
``ReduceScatter(scatter_dim)``  :func:`reduce_scatter`
``AlltoAll``                    :func:`all_to_all`
``Broadcast/Reduce``            :func:`broadcast` / :func:`reduce`
``Send/Recv``                   :func:`ppermute`, :func:`ring_shift`
``AllReduceCoalesce``           :func:`all_reduce_coalesced` (size-capped
                                buckets, optional bf16/int8 transport)
``Barrier``                     :func:`barrier` (through the coordinator)
==============================  =====================================

Inside a forward the layers use the autograd pairs of Megatron-LM:
:func:`copy_to_group` (identity, its backward all-reduces),
:func:`reduce_from_group` (all-reduce, backward identity),
:func:`gather_from_group` (all-gather, backward reduce-scatter),
:func:`reduce_scatter_to_group` (reduce-scatter, backward all-gather),
:func:`split_to_group` (this rank's slice, backward all-gather),
:func:`gather_output` (all-gather, backward this rank's slice),
:func:`permute_group` (a ``ppermute`` whose backward is the inverse
permutation: the pipeline's stage hop and the sym layout's exchange) and
:func:`all_to_all_group` (an all-to-all whose backward swaps its two
dims: Ulysses' head scatter).  On
``meta`` tensors (the graph's shape pass) they return the shapes alone.

Accounting: while a :func:`comm_stats` scope is open, every collective
the port issues is recorded (kind, axis, payload bytes, wire bytes by
the ring rule, dtype, the :func:`comm_tag` scope, and whether it was
staged).  The JAX package records at trace time, once a compiled
program; the port records what runs, and a captured CUDA step records
at its capture, once a graph.

Staging: gloo takes CUDA tensors for all-reduce, all-gather,
reduce-scatter, all-to-all and broadcast, and its send/recv refuses them
(``tools/mesh_probe.py`` on the H100 machine, torch 2.11).  Where a mesh
runs gloo with its tensors on the card, the kinds in
``GLOO_CUDA_STAGED`` go through host memory (a copy to the CPU, the
collective there, a copy back), and their records say ``staged``.  On
NCCL nothing is staged.
"""
from __future__ import annotations

import contextlib
from typing import (Dict, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from .mesh import current_mesh

#: collectives that gloo takes only on CPU tensors: on a gloo mesh whose
#: tensors live on the card they are staged through host memory
GLOO_CUDA_STAGED = frozenset({"ppermute"})

GRAD_COMM_TRANSPORTS = ("fp32", "bf16", "int8")

#: default blockwise-absmax block for the int8 transport (elements a
#: block; the scale sidecar costs 4 bytes a block)
INT8_BLOCK = 256


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

class CommRecord(NamedTuple):
    kind: str               # all_reduce | reduce_scatter | all_gather | ...
    payload_bytes: int      # logical payload (global, before sharding)
    wire_bytes: float       # bytes a rank sends by the ring algorithm
    dtype: str
    axis: str
    tag: str = ""           # the ambient comm_tag scope
    staged: bool = False    # went through host memory (gloo, CUDA)


class CommStats:
    """The collectives issued while a :func:`comm_stats` scope was open."""

    def __init__(self):
        self.records: List[CommRecord] = []

    @property
    def num_collectives(self) -> int:
        return len(self.records)

    @property
    def total_wire_bytes(self) -> float:
        return sum(r.wire_bytes for r in self.records)

    @property
    def total_payload_bytes(self) -> int:
        return sum(r.payload_bytes for r in self.records)

    def by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            out[r.kind] = out.get(r.kind, 0) + 1
        return out

    def summary(self) -> dict:
        return {"num_collectives": self.num_collectives,
                "wire_bytes_per_rank": round(self.total_wire_bytes, 1),
                "payload_bytes": self.total_payload_bytes,
                "by_kind": self.by_kind(),
                "staged": sum(1 for r in self.records if r.staged)}


_STATS_STACK: List[CommStats] = []
_TAG_STACK: List[str] = []


@contextlib.contextmanager
def comm_stats():
    """``with comm_stats() as s:``: record the collectives issued inside."""
    s = CommStats()
    _STATS_STACK.append(s)
    try:
        yield s
    finally:
        _STATS_STACK.remove(s)


@contextlib.contextmanager
def comm_tag(tag: str):
    """Attribute the collectives issued inside to ``tag`` (nested tags
    join with ``/``)."""
    _TAG_STACK.append(tag)
    try:
        yield
    finally:
        _TAG_STACK.pop()


def current_comm_tag() -> str:
    return "/".join(_TAG_STACK)


def ring_wire_bytes(kind: str, payload_bytes: float, n: int) -> float:
    """Bytes a rank sends by the ring algorithm for a collective moving
    ``payload_bytes`` across ``n`` ranks (an all-reduce is a
    reduce-scatter and an all-gather)."""
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if kind == "all_reduce":
        return 2.0 * payload_bytes * frac
    if kind in ("reduce_scatter", "all_gather", "all_to_all"):
        return payload_bytes * frac
    if kind in ("ppermute", "broadcast"):
        return float(payload_bytes)
    raise ValueError(f"unknown collective kind {kind!r}")


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _record(kind: str, payload_bytes: int, dtype, n: int, axis: str,
            staged: bool = False) -> None:
    if not _STATS_STACK:
        return
    rec = CommRecord(kind, int(payload_bytes),
                     ring_wire_bytes(kind, payload_bytes, n),
                     _dtype_name(dtype), axis, current_comm_tag(), staged)
    for s in _STATS_STACK:
        s.records.append(rec)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# ---------------------------------------------------------------------------
# the plain collectives
# ---------------------------------------------------------------------------

def _mesh(mesh):
    m = mesh if mesh is not None else current_mesh()
    if m is None:
        raise ValueError("no mesh: pass mesh= or call inside `with mesh:`")
    return m


def axis_size(axis: str, mesh=None) -> int:
    m = mesh if mesh is not None else current_mesh()
    return 1 if m is None else m.axis_size(axis)


def axis_index(axis: str, mesh=None) -> int:
    m = mesh if mesh is not None else current_mesh()
    return 0 if m is None else m.axis_index(axis)


def _staged(mesh, kind: str, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.is_cuda and kind in GLOO_CUDA_STAGED


def _group_order(m, axis: str):
    """For each index along ``axis``, the process-group rank of the rank
    there, or None where they coincide (a mesh over permuted ranks: a
    process group orders its ranks by number)."""
    fn = getattr(m, "group_order", None)
    return fn(axis) if fn is not None else None


def _host(x: torch.Tensor, staged: bool) -> torch.Tensor:
    return x.cpu() if staged else x


_REDUCE_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN", "mean": "SUM"}


def all_reduce(x: torch.Tensor, axis: str, op: str = "sum",
               mesh=None) -> torch.Tensor:
    """Sum (or mean, max, min) of ``x`` over the axis, on every rank."""
    import torch.distributed as dist
    if op not in _REDUCE_OPS:
        raise ValueError(f"unsupported reduce op {op!r}")
    m = _mesh(mesh)
    n = m.axis_size(axis)
    if x.is_meta or n == 1:
        return x if x.is_meta else x.clone()
    staged = _staged(m, "all_reduce", x)
    _record("all_reduce", _nbytes(x), x.dtype, n, axis, staged)
    out = _host(x, staged).clone().contiguous()
    dist.all_reduce(out, getattr(dist.ReduceOp, _REDUCE_OPS[op]),
                    group=m.group(axis))
    if op == "mean":
        out = out / n
    return out.to(x.device) if staged else out


def all_gather(x: torch.Tensor, axis: str, gather_dim: int = 0,
               mesh=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``gather_dim``, in axis
    order."""
    import torch.distributed as dist
    m = _mesh(mesh)
    n = m.axis_size(axis)
    d = gather_dim % max(x.ndim, 1)
    if x.is_meta:
        shape = list(x.shape)
        shape[d] *= n
        return x.new_empty(shape)
    if n == 1:
        return x.clone()
    staged = _staged(m, "all_gather", x)
    _record("all_gather", _nbytes(x) * n, x.dtype, n, axis, staged)
    src = _host(x, staged).movedim(d, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=m.group(axis))
    order = _group_order(m, axis)
    if order is not None:           # the group's order into the axis'
        out = out.view((n, -1) + tuple(out.shape[1:]))[order].flatten(0, 1)
    out = out.movedim(0, d)
    return out.to(x.device) if staged else out


def reduce_scatter(x: torch.Tensor, axis: str, scatter_dim: int = 0,
                   op: str = "sum", mesh=None) -> torch.Tensor:
    """The sum (or mean) over the axis, scattered along ``scatter_dim``:
    rank ``i`` keeps chunk ``i``."""
    import torch.distributed as dist
    m = _mesh(mesh)
    n = m.axis_size(axis)
    d = scatter_dim % max(x.ndim, 1)
    if x.shape[d] % n:
        raise ValueError(f"reduce_scatter: dim {d} of {tuple(x.shape)} is "
                         f"not divisible by {n}")
    if x.is_meta:
        shape = list(x.shape)
        shape[d] //= n
        return x.new_empty(shape)
    if n == 1:
        return x.clone()
    staged = _staged(m, "reduce_scatter", x)
    _record("reduce_scatter", _nbytes(x), x.dtype, n, axis, staged)
    src = _host(x, staged).movedim(d, 0).contiguous()
    order = _group_order(m, axis)
    if order is not None:           # chunk i to the group rank at index i
        inv = [order.index(j) for j in range(n)]
        src = src.view((n, -1) + tuple(src.shape[1:]))[inv].flatten(0, 1)
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=m.group(axis))
    if op == "mean":
        out = out / n
    elif op != "sum":
        raise ValueError(f"unsupported reduce_scatter op {op!r}")
    out = out.movedim(0, d)
    return out.to(x.device) if staged else out


def all_to_all(x: torch.Tensor, axis: str, split_dim: int,
               concat_dim: int, mesh=None) -> torch.Tensor:
    """``x`` split into n chunks along ``split_dim``; chunk ``j`` goes to
    rank ``j``, and the received chunks are concatenated along
    ``concat_dim`` in rank order."""
    import torch.distributed as dist
    m = _mesh(mesh)
    n = m.axis_size(axis)
    sd, cd = split_dim % x.ndim, concat_dim % x.ndim
    if x.is_meta:
        shape = list(x.shape)
        shape[sd] //= n
        shape[cd] *= n
        return x.new_empty(shape)
    if n == 1:
        return x.clone()
    staged = _staged(m, "all_to_all", x)
    _record("all_to_all", _nbytes(x), x.dtype, n, axis, staged)
    src = _host(x, staged)
    chunks = src.chunk(n, sd)
    stacked = torch.stack(chunks, 0).contiguous()     # [n, ...chunk]
    order = _group_order(m, axis)
    if order is not None:
        stacked = stacked[[order.index(j) for j in range(n)]].contiguous()
    out = torch.empty_like(stacked)
    dist.all_to_all_single(out, stacked, group=m.group(axis))
    if order is not None:
        out = out[order]
    out = torch.cat(list(out.unbind(0)), cd)
    return out.to(x.device) if staged else out


def broadcast(x: torch.Tensor, axis: str, root: int = 0,
              mesh=None) -> torch.Tensor:
    """``root``'s ``x`` on every rank of the axis."""
    import torch.distributed as dist
    m = _mesh(mesh)
    n = m.axis_size(axis)
    if x.is_meta or n == 1:
        return x if x.is_meta else x.clone()
    staged = _staged(m, "broadcast", x)
    _record("broadcast", _nbytes(x), x.dtype, n, axis, staged)
    out = _host(x, staged).clone().contiguous()
    dist.broadcast(out, src=m.group_ranks(axis)[root], group=m.group(axis))
    return out.to(x.device) if staged else out


def reduce(x: torch.Tensor, axis: str, root: int = 0,
           mesh=None) -> torch.Tensor:
    """The sum on ``root``; the other ranks receive zeros."""
    s = all_reduce(x, axis, "sum", mesh)
    return s if axis_index(axis, mesh) == root else torch.zeros_like(s)


def ppermute(x: torch.Tensor, axis: str,
             perm: Sequence[Tuple[int, int]], mesh=None) -> torch.Tensor:
    """Point-to-point exchange: for each ``(src, dst)`` pair, ``src``'s
    ``x`` arrives at ``dst``; a rank no pair sends to receives zeros."""
    import torch.distributed as dist
    m = _mesh(mesh)
    n = m.axis_size(axis)
    if x.is_meta:
        return x
    me = m.axis_index(axis)
    if n == 1:
        return x.clone() if (0, 0) in [tuple(p) for p in perm] \
            else torch.zeros_like(x)
    staged = _staged(m, "ppermute", x)
    _record("ppermute", _nbytes(x), x.dtype, n, axis, staged)
    ranks = m.group_ranks(axis)
    src_buf = _host(x, staged).contiguous()
    out = torch.zeros_like(src_buf)
    ops = []
    for s, d in perm:
        if s == me and d != me:
            ops.append(dist.P2POp(dist.isend, src_buf, ranks[d],
                                  group=m.group(axis)))
        if d == me and s != me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s],
                                  group=m.group(axis)))
        if s == me and d == me:
            out.copy_(src_buf)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device) if staged else out


def ring_shift(x: torch.Tensor, axis: str, shift: int = 1,
               mesh=None) -> torch.Tensor:
    """Each rank's ``x`` moves ``shift`` places round the axis's ring."""
    n = axis_size(axis, mesh)
    return ppermute(x, axis, [(i, (i + shift) % n) for i in range(n)], mesh)


def partial_reduce(x: torch.Tensor, axis: str, participating,
                   op: str = "mean", mesh=None) -> torch.Tensor:
    """The sum (or mean) over the ranks whose ``participating`` is true;
    every rank receives it (v1's ``PartialReduce``)."""
    p = torch.as_tensor(participating, dtype=x.dtype, device=x.device)
    total = all_reduce(x * p, axis, "sum", mesh)
    if op == "sum":
        return total
    if op == "mean":
        count = all_reduce(p.reshape(1), axis, "sum", mesh)[0]
        return total / torch.clamp(count, min=1)
    raise ValueError(f"unsupported partial_reduce op {op!r}")


_COORDINATOR: list = [None]


def set_coordinator(client) -> None:
    """Register the process's ``CoordinatorClient``: :func:`barrier`
    then goes through it."""
    _COORDINATOR[0] = client


def barrier(coordinator=None, name: str = "default",
            world_size: Optional[int] = None,
            timeout: float = 60.0) -> None:
    """Host-level barrier through the coordinator (``coordinator``, or
    the one :func:`set_coordinator` registered); without one, a
    ``torch.distributed`` barrier when the process group is up."""
    coord = coordinator if coordinator is not None else _COORDINATOR[0]
    if coord is not None:
        ws = world_size if world_size is not None \
            else getattr(coord, "world_size", None)
        if not ws:
            raise ValueError(
                "coordinator barrier needs a world_size (pass it here or "
                "start the CoordinatorServer with world_size=N)")
        coord.barrier(name=name, world_size=ws, timeout=timeout)
        return
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


# -- split collectives over subgroups of an axis ------------------------------
#
# ``groups`` is a static partition of the axis indices, e.g. [[0, 1, 2],
# [3, 4, 5, 6, 7]]; sizes may differ.  Each runs as one full-axis
# all-gather and a local selection, with the padded shapes of the JAX
# package's versions.


def _norm_groups(groups, n: int):
    gs = [list(map(int, g)) for g in groups]
    if sorted(i for g in gs for i in g) != list(range(n)):
        raise ValueError(
            f"groups {gs} must partition the {n} axis indices exactly")
    return gs


def _own_group(groups, axis, mesh):
    n = axis_size(axis, mesh)
    gs = _norm_groups(groups, n)
    me = axis_index(axis, mesh)
    return gs, next(g for g in gs if me in g), me


def split_all_reduce(x: torch.Tensor, subgroup_axis: str, groups=None,
                     mesh=None) -> torch.Tensor:
    """All-reduce within each subgroup."""
    if groups is None:
        return all_reduce(x, subgroup_axis, "sum", mesh)
    _, own, _ = _own_group(groups, subgroup_axis, mesh)
    allx = all_gather(x.unsqueeze(0), subgroup_axis, 0, mesh)
    return allx[own].sum(0)


def split_all_gather(x: torch.Tensor, subgroup_axis: str,
                     gather_dim: int = 0, groups=None,
                     mesh=None) -> torch.Tensor:
    """All-gather within each subgroup, padded to the largest group:
    ``shape[gather_dim] == max_g * x.shape[gather_dim]``, the rows past
    the own group's shards zero."""
    if groups is None:
        return all_gather(x, subgroup_axis, gather_dim, mesh)
    gs, own, _ = _own_group(groups, subgroup_axis, mesh)
    max_g = max(len(g) for g in gs)
    allx = all_gather(x.unsqueeze(0), subgroup_axis, 0, mesh)
    picked = torch.zeros((max_g,) + tuple(x.shape), dtype=x.dtype,
                         device=x.device)
    picked[:len(own)] = allx[own]
    d = gather_dim % x.ndim
    return torch.cat(list(picked.unbind(0)), d)


def split_reduce_scatter(x: torch.Tensor, subgroup_axis: str,
                         scatter_dim: int = 0, groups=None,
                         mesh=None) -> torch.Tensor:
    """Reduce-scatter within each subgroup, padded to the largest chunk
    (``L // min group size``): the rows past this rank's ``L //
    own_group_size`` chunk are zero."""
    if groups is None:
        return reduce_scatter(x, subgroup_axis, scatter_dim, "sum", mesh)
    gs, own, me = _own_group(groups, subgroup_axis, mesh)
    d = scatter_dim % x.ndim
    L = x.shape[d]
    for g in gs:
        if L % len(g):
            raise ValueError(
                f"scatter dim {L} not divisible by subgroup size {len(g)}")
    red = split_all_reduce(x, subgroup_axis, groups, mesh)
    chunk = L // len(own)
    max_chunk = L // min(len(g) for g in gs)
    mine = red.narrow(d, own.index(me) * chunk, chunk)
    pad = [0, 0] * (x.ndim - 1 - d) + [0, max_chunk - chunk]
    return torch.nn.functional.pad(mine, pad)


# ---------------------------------------------------------------------------
# autograd pairs (Megatron-LM's f, g and the sequence-parallel pair)
# ---------------------------------------------------------------------------

class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis, "sum", ctx.mesh), None, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, grad_scale):
        ctx.grad_scale = grad_scale
        return all_reduce(x, axis, "sum", mesh)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.grad_scale == 1 else g * ctx.grad_scale), None, \
            None, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim, grad_op):
        ctx.axis, ctx.mesh, ctx.dim, ctx.grad_op = axis, mesh, dim, grad_op
        return all_gather(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_op == "slice":
            n = axis_size(ctx.axis, ctx.mesh)
            i = axis_index(ctx.axis, ctx.mesh)
            return g.chunk(n, ctx.dim)[i].contiguous(), None, None, None, \
                None
        return reduce_scatter(g, ctx.axis, ctx.dim, ctx.grad_op,
                              ctx.mesh), None, None, None, None


class _ReduceScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.axis, ctx.mesh, ctx.dim = axis, mesh, dim
        return reduce_scatter(x, axis, dim, "sum", mesh)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axis, ctx.dim, ctx.mesh), None, None, None


class _SplitToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.axis, ctx.mesh, ctx.dim = axis, mesh, dim
        n = axis_size(axis, mesh)
        i = axis_index(axis, mesh)
        return x.chunk(n, dim)[i].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axis, ctx.dim, ctx.mesh), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, perm):
        ctx.axis, ctx.mesh = axis, mesh
        ctx.inverse = [(d, s) for s, d in perm]
        ctx.tag = current_comm_tag()
        return ppermute(x, axis, perm, mesh)

    @staticmethod
    def backward(ctx, g):
        # recorded under the forward's tag: the reverse hop of a
        # ``pipeline/hop`` is one too
        with _tag_of_forward(ctx.tag):
            out = ppermute(g.contiguous(), ctx.axis, ctx.inverse, ctx.mesh)
        return out, None, None, None


@contextlib.contextmanager
def _tag_of_forward(tag: str):
    """The tag stack as a forward left it, for its backward's
    collectives."""
    saved = list(_TAG_STACK)
    _TAG_STACK[:] = [tag] if tag else []
    try:
        yield
    finally:
        _TAG_STACK[:] = saved


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, split_dim, concat_dim):
        ctx.axis, ctx.mesh, ctx.dims = axis, mesh, (split_dim, concat_dim)
        ctx.tag = current_comm_tag()
        return all_to_all(x, axis, split_dim, concat_dim, mesh)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        with _tag_of_forward(ctx.tag):
            out = all_to_all(g.contiguous(), ctx.axis, concat_dim,
                             split_dim, ctx.mesh)
        return out, None, None, None, None


def _active(axis: str, mesh) -> bool:
    return mesh is not None and mesh.axis_size(axis) > 1


def copy_to_group(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """The identity; its backward sums the gradient over the axis."""
    mesh = mesh if mesh is not None else current_mesh()
    return _CopyToGroup.apply(x, axis, mesh) if _active(axis, mesh) else x


def reduce_from_group(x: torch.Tensor, axis: str, mesh=None,
                      grad_scale: float = 1) -> torch.Tensor:
    """The sum over the axis; its backward passes the gradient on times
    ``grad_scale`` (the axis size where gradients are later averaged
    over the axis, as a loss's data-parallel sum is)."""
    mesh = mesh if mesh is not None else current_mesh()
    if not _active(axis, mesh):
        return x
    return _ReduceFromGroup.apply(x, axis, mesh, grad_scale)


def gather_from_group(x: torch.Tensor, axis: str, dim: int, mesh=None,
                      grad_op: str = "sum") -> torch.Tensor:
    """All-gather along ``dim``; the backward reduce-scatters the
    gradient (``grad_op`` "sum" or "mean")."""
    mesh = mesh if mesh is not None else current_mesh()
    if not _active(axis, mesh):
        return x
    return _GatherFromGroup.apply(x, axis, mesh, dim % x.ndim, grad_op)


def gather_output(x: torch.Tensor, axis: str, dim: int,
                  mesh=None) -> torch.Tensor:
    """All-gather along ``dim``; the backward keeps this rank's slice of
    the gradient (the input was replicated upstream)."""
    mesh = mesh if mesh is not None else current_mesh()
    if not _active(axis, mesh):
        return x
    return _GatherFromGroup.apply(x, axis, mesh, dim % x.ndim, "slice")


def reduce_scatter_to_group(x: torch.Tensor, axis: str, dim: int,
                            mesh=None) -> torch.Tensor:
    """Reduce-scatter along ``dim``; the backward all-gathers."""
    mesh = mesh if mesh is not None else current_mesh()
    if not _active(axis, mesh):
        return x
    return _ReduceScatterToGroup.apply(x, axis, mesh, dim % x.ndim)


def permute_group(x: torch.Tensor, axis: str,
                  perm: Sequence[Tuple[int, int]],
                  mesh=None) -> torch.Tensor:
    """:func:`ppermute` with a backward: the gradient travels the
    inverse permutation (the transpose XLA derives for the JAX package's
    ``lax.ppermute``), recorded as a ``ppermute`` under the forward's
    :func:`comm_tag`.  Staged through host memory on a gloo mesh of CUDA
    tensors, both ways (``GLOO_CUDA_STAGED``)."""
    mesh = mesh if mesh is not None else current_mesh()
    if x.is_meta or not _active(axis, mesh):
        return ppermute(x, axis, perm, mesh)
    return _PPermute.apply(x, axis, mesh, [tuple(p) for p in perm])


def all_to_all_group(x: torch.Tensor, axis: str, split_dim: int,
                     concat_dim: int, mesh=None) -> torch.Tensor:
    """:func:`all_to_all` with a backward: the gradient goes back by the
    all-to-all that splits ``concat_dim`` and concatenates ``split_dim``
    (its inverse)."""
    mesh = mesh if mesh is not None else current_mesh()
    if x.is_meta or not _active(axis, mesh):
        return all_to_all(x, axis, split_dim, concat_dim, mesh)
    return _AllToAll.apply(x, axis, mesh, split_dim % x.ndim,
                           concat_dim % x.ndim)


def split_to_group(x: torch.Tensor, axis: str, dim: int,
                   mesh=None) -> torch.Tensor:
    """This rank's chunk along ``dim``; the backward all-gathers."""
    mesh = mesh if mesh is not None else current_mesh()
    if not _active(axis, mesh):
        return x
    if x.is_meta:
        shape = list(x.shape)
        shape[dim % x.ndim] //= mesh.axis_size(axis)
        return x.new_empty(shape)
    return _SplitToGroup.apply(x, axis, mesh, dim % x.ndim)


# ---------------------------------------------------------------------------
# coalesced and quantized gradient collectives
# ---------------------------------------------------------------------------
#
# Same-dtype gradients are flattened into size-capped buckets and synced
# with one collective chain a bucket.  The bf16 and int8 transports cross
# the wire quantized while the reduction accumulates in fp32 (EQuARX):
#
#   quantize -> all_to_all -> dequantize -> accumulate fp32 -> [mean]
#   -> quantize -> all_gather -> dequantize
#
# so each element is quantized twice whatever the group size.  fp32 is one
# all-reduce a bucket, elementwise the same as one a tensor.


class Bucket(NamedTuple):
    """One fused bucket: same-dtype tensors flattened back to back."""
    keys: Tuple
    shapes: Tuple
    numels: Tuple[int, ...]
    dtype: str              # numpy dtype name ("bfloat16" for bf16)
    nbytes: int


class CoalescedLayout(NamedTuple):
    """Static layout of a reduce-scattered coalesced gradient set."""
    buckets: Tuple[Bucket, ...]
    chunks: Tuple[int, ...]
    list_input: bool = False
    groups: Optional[Tuple[Tuple[int, ...], ...]] = None


_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8}


def _entry_dtype(dtype) -> Tuple[str, int]:
    name = _dtype_name(dtype)
    size = _ITEMSIZE.get(name)
    if size is None:
        size = np.dtype(name).itemsize
    return name, size


def plan_buckets(entries: Sequence[Tuple],
                 bucket_mb: float = 4.0) -> List[Bucket]:
    """Greedy size-capped bucketing of ``(key, shape, dtype)`` entries,
    order-preserving within each dtype; a tensor larger than the cap gets
    a bucket of its own."""
    cap = max(1, int(float(bucket_mb) * (1 << 20)))
    buckets: List[Bucket] = []
    open_idx: Dict[str, int] = {}
    for key, shape, dtype in entries:
        name, itemsize = _entry_dtype(dtype)
        numel = int(np.prod(shape)) if len(tuple(shape)) else 1
        nbytes = numel * itemsize
        i = open_idx.get(name)
        if i is not None and buckets[i].nbytes + nbytes <= cap:
            b = buckets[i]
            buckets[i] = Bucket(b.keys + (key,), b.shapes + (tuple(shape),),
                                b.numels + (numel,), b.dtype,
                                b.nbytes + nbytes)
        else:
            buckets.append(Bucket((key,), (tuple(shape),), (numel,), name,
                                  nbytes))
            open_idx[name] = len(buckets) - 1
    return buckets


def quantized_chunk(numel: int, n: int, block: int = INT8_BLOCK) -> int:
    """A rank's chunk of a bucket: the padded flat buffer is ``n *
    chunk`` long, ``chunk`` a block multiple, so that no int8 block
    straddles two ranks."""
    per = -(-numel // n)
    return -(-per // block) * block


def _normalize_tree(xs):
    if isinstance(xs, Mapping):
        items = list(xs.items())
        return items, (lambda vals: dict(zip([k for k, _ in items], vals)))
    items = list(enumerate(xs))
    return items, (lambda vals: list(vals))


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _flatten_bucket(bucket: Bucket, lookup) -> torch.Tensor:
    return torch.cat([lookup[k].reshape(-1) for k in bucket.keys])


def _unflatten_bucket(flat: torch.Tensor, bucket: Bucket
                      ) -> List[torch.Tensor]:
    out, off = [], 0
    for shape, numel in zip(bucket.shapes, bucket.numels):
        out.append(flat[off:off + numel].reshape(shape))
        off += numel
    return out


def _quantize_rows(rows: torch.Tensor, block: int):
    """Blockwise int8 absmax codes and scales of ``[r, chunk]`` rows
    (``chunk % block == 0``), by the checkpoint quantizer."""
    from ..ops.quantization import quantize_int8
    r, chunk = rows.shape
    q, scales = quantize_int8(rows, blocksize=block)
    return q.reshape(r, chunk), scales.reshape(r, chunk // block)


def _dequantize_rows(codes: torch.Tensor, scales: torch.Tensor,
                     block: int) -> torch.Tensor:
    from ..ops.quantization import dequantize_int8
    return dequantize_int8(codes.reshape(-1), scales.reshape(-1),
                           tuple(codes.shape), blocksize=block)


def _qreduce_scatter_flat(flat: torch.Tensor, axis: str, op: str,
                          transport: str, block: int,
                          mesh) -> torch.Tensor:
    """Phase 1 of the two-phase reduction: this rank's fp32-accumulated
    ``[chunk]`` of the flat buffer."""
    n = axis_size(axis, mesh)
    N = flat.shape[0]
    chunk = quantized_chunk(N, n, block)
    rows = torch.nn.functional.pad(flat.float(),
                                   (0, n * chunk - N)).reshape(n, chunk)
    if transport == "bf16":
        ex = all_to_all(rows.to(torch.bfloat16), axis, 0, 0, mesh)
        acc = ex.float().sum(0)
    elif transport == "int8":
        codes, scales = _quantize_rows(rows, block)
        exc = all_to_all(codes, axis, 0, 0, mesh)
        with comm_tag("scales"):
            exs = all_to_all(scales, axis, 0, 0, mesh)
        acc = _dequantize_rows(exc, exs, block).sum(0)
    else:
        raise ValueError(f"unknown quantized transport {transport!r}")
    if op == "mean":
        acc = acc / n
    elif op != "sum":
        raise ValueError(f"unsupported op {op!r} for quantized transport")
    return acc


def _qall_gather_flat(chunk_arr: torch.Tensor, axis: str, transport: str,
                      block: int, numel: int, mesh) -> torch.Tensor:
    """Phase 2: every rank's reduced chunk through the quantized
    transport; the flat fp32 buffer of ``numel``."""
    chunk = chunk_arr.shape[0]
    if transport == "bf16":
        full = all_gather(chunk_arr.to(torch.bfloat16), axis, 0,
                          mesh).float()
    elif transport == "int8":
        codes, scales = _quantize_rows(chunk_arr.reshape(1, chunk), block)
        gc = all_gather(codes, axis, 0, mesh)
        with comm_tag("scales"):
            gs = all_gather(scales, axis, 0, mesh)
        full = _dequantize_rows(gc, gs, block)
    else:
        raise ValueError(f"unknown quantized transport {transport!r}")
    return full.reshape(-1)[:numel]


def _reduce_flat(flat: torch.Tensor, axis: str, op: str, transport: str,
                 block: int, groups, mesh) -> torch.Tensor:
    if transport == "fp32":
        if groups is not None:
            if op not in ("sum", "mean"):
                raise ValueError(f"unsupported coalesced op {op!r}")
            _, own, _ = _own_group(groups, axis, mesh)
            red = split_all_reduce(flat, axis, groups, mesh)
            return red / len(own) if op == "mean" else red
        if op not in ("sum", "mean"):
            raise ValueError(f"unsupported coalesced op {op!r}")
        return all_reduce(flat, axis, op, mesh)
    if groups is not None:
        raise ValueError("quantized transports run over the whole axis; "
                         "use transport='fp32' for subgroups")
    shard = _qreduce_scatter_flat(flat, axis, op, transport, block, mesh)
    full = _qall_gather_flat(shard, axis, transport, block, flat.shape[0],
                             mesh)
    return full.to(flat.dtype)


def _check_transport(transport: str) -> None:
    if transport not in GRAD_COMM_TRANSPORTS:
        raise ValueError(f"transport must be one of {GRAD_COMM_TRANSPORTS}, "
                         f"got {transport!r}")


def _buckets_of(items, bucket_mb):
    return plan_buckets([(k, tuple(v.shape), v.dtype) for k, v in items],
                        bucket_mb)


def all_reduce_coalesced(xs, axis: str, op: str = "sum",
                         bucket_mb: float = 4.0, transport: str = "fp32",
                         block: int = INT8_BLOCK, groups=None, mesh=None):
    """Bucketed (optionally quantized) all-reduce of a dict or list of
    tensors; returns the same structure.  ``groups``: a partition of the
    axis into subgroups, each reduced on its own (fp32 only)."""
    _check_transport(transport)
    items, rebuild = _normalize_tree(xs)
    lookup = dict(items)
    out: Dict = {}
    for bi, b in enumerate(_buckets_of(items, bucket_mb)):
        with comm_tag(f"grad_comm/bucket{bi}"):
            red = _reduce_flat(_flatten_bucket(b, lookup), axis, op,
                               transport, block, groups, mesh)
        for k, arr in zip(b.keys, _unflatten_bucket(red, b)):
            out[k] = arr.to(lookup[k].dtype)
    return rebuild([out[k] for k, _ in items])


def reduce_scatter_coalesced(xs, axis: str, op: str = "sum",
                             bucket_mb: float = 4.0,
                             transport: str = "fp32",
                             block: int = INT8_BLOCK, mesh=None):
    """Bucketed reduce-scatter: this rank's fp32 chunk of every reduced
    bucket, and the layout that :func:`all_gather_coalesced` completes."""
    _check_transport(transport)
    items, _ = _normalize_tree(xs)
    lookup = dict(items)
    buckets = _buckets_of(items, bucket_mb)
    n = axis_size(axis, mesh)
    chunks, lens = [], []
    for bi, b in enumerate(buckets):
        with comm_tag(f"grad_comm/bucket{bi}"):
            flat = _flatten_bucket(b, lookup)
            chunk = quantized_chunk(flat.shape[0], n, block)
            if transport == "fp32":
                padded = torch.nn.functional.pad(
                    flat.float(), (0, n * chunk - flat.shape[0]))
                shard = reduce_scatter(padded, axis, 0, op, mesh)
            else:
                shard = _qreduce_scatter_flat(flat, axis, op, transport,
                                              block, mesh)
        chunks.append(shard)
        lens.append(chunk)
    return chunks, CoalescedLayout(tuple(buckets), tuple(lens),
                                   not isinstance(xs, Mapping))


def all_gather_coalesced(chunks, layout: CoalescedLayout, axis: str,
                         transport: str = "fp32", block: int = INT8_BLOCK,
                         tag: str = "grad_comm", mesh=None):
    """Inverse of :func:`reduce_scatter_coalesced`: every rank's chunks,
    unflattened into the original container.  The fp32 path gathers in
    the bucket's dtype (a bf16 parameter set crosses as bf16)."""
    if layout.groups is not None:
        raise NotImplementedError(
            "all_gather_coalesced does not take grouped layouts (from "
            "split_reduce_scatter_coalesced)")
    out: Dict = {}
    for bi, (shard, b, chunk) in enumerate(zip(chunks, layout.buckets,
                                               layout.chunks)):
        numel = sum(b.numels)
        with comm_tag(f"{tag}/bucket{bi}"):
            if transport == "fp32":
                full = all_gather(shard.to(_torch_dtype(b.dtype)), axis, 0,
                                  mesh)[:numel]
            else:
                full = _qall_gather_flat(shard, axis, transport, block,
                                         numel, mesh)
        for k, arr in zip(b.keys, _unflatten_bucket(full, b)):
            out[k] = arr.to(_torch_dtype(b.dtype))
    if layout.list_input:
        return [out[i] for i in range(len(out))]
    return out


def split_all_reduce_coalesced(xs, subgroup_axis: str, groups=None,
                               op: str = "sum", bucket_mb: float = 4.0,
                               transport: str = "fp32",
                               block: int = INT8_BLOCK, mesh=None):
    """Coalesced all-reduce within each subgroup (fp32 takes unequal
    groups)."""
    return all_reduce_coalesced(xs, subgroup_axis, op=op,
                                bucket_mb=bucket_mb, transport=transport,
                                block=block, groups=groups, mesh=mesh)


def split_reduce_scatter_coalesced(xs, subgroup_axis: str, groups=None,
                                   bucket_mb: float = 4.0, mesh=None):
    """Coalesced reduce-scatter within each subgroup, each bucket padded to
    a multiple of every subgroup size, with :func:`split_reduce_scatter`'s
    padded-chunk contract."""
    items, _ = _normalize_tree(xs)
    lookup = dict(items)
    buckets = _buckets_of(items, bucket_mb)
    n = axis_size(subgroup_axis, mesh)
    sizes = [len(g) for g in groups] if groups is not None else [n]
    lcm = int(np.lcm.reduce(np.asarray(sizes, np.int64)))
    shards, lens = [], []
    for b in buckets:
        flat = _flatten_bucket(b, lookup)
        padded = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % lcm))
        shards.append(split_reduce_scatter(padded, subgroup_axis, 0, groups,
                                           mesh))
        lens.append(padded.shape[0] // min(sizes))
    gtuple = tuple(tuple(int(i) for i in g) for g in groups) \
        if groups is not None else None
    return shards, CoalescedLayout(tuple(buckets), tuple(lens),
                                   not isinstance(xs, Mapping), gtuple)
