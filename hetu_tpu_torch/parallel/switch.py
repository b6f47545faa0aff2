"""Hot switching between parallel strategies (counterpart of
``hetu_tpu.parallel.switch``).

The reference Hetu's ``SwitchExecGraph`` (``hetu/graph/
switch_exec_graph.{h,cc}``) moves the parameters, the gradients and the
optimizer's state of a running graph onto a new layout: it intersects
each tensor's source and destination ``ParamSlice``s and moves the
intersections as one ``BufferBatchedIsendIrecv``.  The JAX package
computes the same intersection from ``jax.sharding`` index maps
(``SwitchPlan``) and lets ``jax.device_put`` move the data.  SPMD here is
by process, so the port does what the reference does:

- :class:`Layout` says where the pieces of one tensor live: a mesh shape,
  the ranks at its positions, the spec, the blocks of a fused dim
  (``parallel.mesh.shard_pieces``) and a ZeRO chunk of dim 0.  It needs
  no process group, so a plan can be computed (and tested) in one
  process.
- :class:`SwitchPlan` intersects the source and destination pieces of a
  tensor: ``(dst rank, src rank, global box, dst local box, src local
  box)`` transfers.  Each destination takes a slice from the replica on
  its own rank, else from the nearest rank (the JAX package's choice).
- :func:`switch_state` runs the plans of a set of tensors as batches of
  ``torch.distributed.batch_isend_irecv`` over the world group: a box
  whose source and destination rank are one is a local copy.  On gloo
  with the tensors on the card the boxes go through host memory (gloo
  refuses CUDA send/recv), as ``parallel.comm`` stages ``ppermute``.  Each
  send is recorded in ``comm.comm_stats()`` (kind ``ppermute``, axis
  ``world``, tag ``switch``).  A batch is cut at ``batch_bytes``, and the
  sources of a batch are released once it is done, so that the switch
  holds at most one batch of both layouts at once.
- :class:`SwitchExecGraph` switches a ``DefineAndRunGraph``: the
  variables, the optimizer's state (per parameter, Adafactor's factored
  statistics included; the flat ZeRO buffers re-packed for the new dp
  through ``optim.flat_state``) and the pending gradient sums, which
  always follow the parameters.

The modes are the reference's (``switch_exec_graph.h:42-48``).
"""
from __future__ import annotations

import enum
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import P, entry_axes, layout_shape, pieces_shape, shard_pieces

Box = Tuple[Tuple[int, int], ...]


class SwitchMode(enum.Enum):
    """What to migrate (reference SWITCH_ORIGIN_PARAM / TRANSFER_PARAM /
    ..._AND_OPTIMIZER / CURRENT_GRAD / ACCUMULATE_GRAD)."""
    ORIGIN_PARAM = "origin_param"
    TRANSFER_PARAM = "transfer_param"              # + dtype transfer
    ORIGIN_PARAM_AND_OPTIMIZER = "origin_param_and_optimizer"
    TRANSFER_PARAM_AND_OPTIMIZER = "transfer_param_and_optimizer"
    CURRENT_GRAD = "current_grad"
    ACCUMULATE_GRAD = "accumulate_grad"


PARAM_MODES = (SwitchMode.ORIGIN_PARAM, SwitchMode.TRANSFER_PARAM,
               SwitchMode.ORIGIN_PARAM_AND_OPTIMIZER,
               SwitchMode.TRANSFER_PARAM_AND_OPTIMIZER)
OPT_MODES = (SwitchMode.ORIGIN_PARAM_AND_OPTIMIZER,
             SwitchMode.TRANSFER_PARAM_AND_OPTIMIZER)
TRANSFER_MODES = (SwitchMode.TRANSFER_PARAM,
                  SwitchMode.TRANSFER_PARAM_AND_OPTIMIZER)


def symbolic_repack_transfers(numel: int, itemsize: int,
                              src_ranges: Dict[int, Tuple[int, int]],
                              dst_ranges: Dict[int, Tuple[int, int]]
                              ) -> List[Tuple[int, int, Tuple[int, int],
                                              int]]:
    """The transfers of a 1-D flat-state repack (a dp resize of the
    per-bucket dp-sharded optimizer buffers): ``src_ranges`` /
    ``dst_ranges`` map rank -> the half-open ``(lo, hi)`` of the flat
    buffer it owns before / after.  Returns ``(dst_rank, src_rank, (lo,
    hi), nbytes)`` sorted, the same list on every rank that derives it."""
    transfers: List[Tuple[int, int, Tuple[int, int], int]] = []
    for dst, (dlo, dhi) in sorted(dst_ranges.items()):
        for src, (slo, shi) in sorted(src_ranges.items()):
            lo, hi = max(dlo, slo), min(dhi, shi, numel)
            if lo >= hi:
                continue
            transfers.append((dst, src, (lo, hi), (hi - lo) * itemsize))
    transfers.sort()
    return transfers


class _Position:
    """A mesh position: what the shard helpers read of a mesh."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int]):
        self.axis_names = tuple(shape)
        self.shape, self.coords = dict(shape), dict(coords)


class Layout:
    """Where the pieces of one tensor live.

    ``mesh_shape`` (axis -> size) with rank ``ranks[i]`` at position
    ``i``, the spec, the blocks of a fused dim (``blocks``, ``blocks_dim``,
    ``units``: ``parallel.mesh.shard_pieces``), and ``chunk_axis``: the
    rank keeps the dim-0 chunk of its shard over that axis (ZeRO).
    ``shape`` fixes the global shape this layout cuts (a flat buffer whose
    padding differs from the other layout's); by default the plan's."""

    def __init__(self, mesh_shape: Dict[str, int], ranks: Sequence[int],
                 pspec=None, blocks: Optional[Sequence[int]] = None,
                 blocks_dim: int = 0, units: Optional[Sequence[int]] = None,
                 chunk_axis: Optional[str] = None,
                 shape: Optional[Sequence[int]] = None):
        self.mesh_shape = {a: int(n) for a, n in mesh_shape.items()}
        self.ranks = tuple(int(r) for r in ranks)
        self.pspec = P(*pspec) if pspec is not None else P()
        self.blocks = tuple(blocks) if blocks else None
        self.blocks_dim = int(blocks_dim)
        self.units = tuple(units) if units and blocks else None
        self.chunk_axis = chunk_axis
        self.shape = tuple(int(d) for d in shape) if shape is not None \
            else None

    @classmethod
    def on(cls, mesh, pspec=None, **kw) -> "Layout":
        """The layout over a ``parallel.mesh.Mesh``."""
        return cls(mesh.shape, mesh.ranks, pspec, **kw)

    def __repr__(self) -> str:
        return (f"Layout({self.mesh_shape}, ranks={list(self.ranks)}, "
                f"{self.pspec!r}, blocks={self.blocks}, "
                f"chunk={self.chunk_axis})")

    def position(self, rank: int) -> Optional[_Position]:
        if rank not in self.ranks:
            return None
        sizes = tuple(self.mesh_shape.values())
        coords = np.unravel_index(self.ranks.index(rank), sizes) \
            if sizes else ()
        return _Position(self.mesh_shape,
                         dict(zip(self.mesh_shape, (int(c) for c in coords))))

    def pieces(self, shape: Sequence[int], rank: int
               ) -> List[Tuple[Box, Box]]:
        """``rank``'s pieces: ``(global box, local box)`` pairs, none
        when the rank is not in the layout."""
        pos = self.position(rank)
        if pos is None:
            return []
        shape = self.shape or tuple(shape)
        if not shape:
            return [((), ())]
        raw = shard_pieces(shape, self.pspec, pos, self.blocks,
                           self.blocks_dim, self.units)
        out = [(tuple((s.start, s.stop) for s in g),
                tuple((s.start, s.stop) for s in l)) for g, l in raw]
        if self.chunk_axis is None:
            return out
        n = self.mesh_shape.get(self.chunk_axis, 1)
        rows = pieces_shape(raw, len(shape))[0]
        if n == 1:
            return out
        if rows % n:
            raise ValueError(f"dim 0 of the local {rows} rows is not "
                             f"divisible by {self.chunk_axis}={n}")
        c = rows // n
        lo = pos.coords[self.chunk_axis] * c
        chunked = []
        for g, l in out:
            a, b = max(l[0][0], lo), min(l[0][1], lo + c)
            if a >= b:
                continue
            shift = a - l[0][0]
            chunked.append((((g[0][0] + shift, g[0][0] + shift + b - a),)
                            + g[1:], ((a - lo, b - lo),) + l[1:]))
        return chunked

    def local_shape(self, shape: Sequence[int], rank: int
                    ) -> Optional[Tuple[int, ...]]:
        """The shape of ``rank``'s local tensor (None outside)."""
        pos = self.position(rank)
        if pos is None:
            return None
        shape = self.shape or tuple(shape)
        loc = layout_shape(shape, self.pspec, pos, self.blocks,
                           self.blocks_dim, self.units)
        if self.chunk_axis is not None and loc:
            n = self.mesh_shape.get(self.chunk_axis, 1)
            loc = (loc[0] // n,) + tuple(loc[1:])
        return tuple(loc)


def _overlap(a: Box, b: Box, shape) -> Optional[Box]:
    out = []
    for (alo, ahi), (blo, bhi), dim in zip(a, b, shape):
        lo, hi = max(alo, blo), min(ahi, bhi, dim)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def _local_box(ov: Box, g: Box, l: Box) -> Box:
    """``ov`` (global, inside the piece whose global box is ``g``) in the
    piece's local coordinates ``l``."""
    return tuple((lo - ga + la, hi - ga + la)
                 for (lo, hi), (ga, _), (la, _) in zip(ov, g, l))


class Transfer(NamedTuple):
    dst: int
    src: int
    box: Box            # global
    dst_box: Box        # in the destination's local tensor
    src_box: Box        # in the source's local tensor


class SwitchPlan:
    """The ParamSlice/ParamBlock intersection of two layouts of one
    tensor of global ``shape``: ``transfers`` holds a
    :class:`Transfer` for every box a destination rank needs, each taken
    from one replica of the source: the one on the destination's rank,
    else the nearest rank (the JAX package's choice, which is round
    robin on its meshes).  ``local_bytes`` and ``moved_bytes`` count the
    boxes that stay on their rank and the boxes that travel."""

    def __init__(self, shape: Sequence[int], itemsize: int, src: Layout,
                 dst: Layout):
        self.shape = tuple(int(d) for d in shape)
        self.src, self.dst = src, dst
        src_pieces = {r: src.pieces(self.shape, r) for r in src.ranks}
        owners: Dict[Tuple, List[int]] = {}
        for r in src.ranks:
            key = tuple(g for g, _ in src_pieces[r])
            owners.setdefault(key, []).append(r)
        self.transfers: List[Transfer] = []
        self.local_bytes = self.moved_bytes = 0
        for d in dst.ranks:
            for dg, dl in dst.pieces(self.shape, d):
                for ranks in owners.values():
                    s = d if d in ranks else min(ranks,
                                                 key=lambda r: abs(r - d))
                    for sg, sl in src_pieces[s]:
                        ov = _overlap(dg, sg, self.shape)
                        if ov is None:
                            continue
                        n = int(np.prod([hi - lo for lo, hi in ov])) * \
                            int(itemsize)
                        if s == d:
                            self.local_bytes += n
                        else:
                            self.moved_bytes += n
                        self.transfers.append(Transfer(
                            d, s, ov, _local_box(ov, dg, dl),
                            _local_box(ov, sg, sl)))


class SwitchProfile:
    """Per-switch accounting (reference SWITCH_PROFILE_LEVEL TIME/MEMORY):
    the JAX package's keys in ``as_dict``, and this rank's own traffic
    (``sent_bytes``, ``recv_bytes``, ``staged_bytes`` through host
    memory, ``local_copy_bytes``)."""

    def __init__(self):
        self.num_tensors = 0
        self.total_bytes = 0
        self.moved_bytes = 0
        # bytes routed through a flat-state unpack -> migrate -> repack
        # (dp resize of per-bucket dp-sharded optimizer buffers)
        self.repack_bytes = 0
        self.seconds = 0.0
        self.sent_bytes = 0
        self.recv_bytes = 0
        self.staged_bytes = 0
        self.local_copy_bytes = 0

    def as_dict(self) -> Dict[str, float]:
        return {"num_tensors": self.num_tensors,
                "total_bytes": self.total_bytes,
                "moved_bytes": self.moved_bytes,
                "repack_bytes": self.repack_bytes,
                "seconds": self.seconds}


class Entry(NamedTuple):
    """One tensor of a switch: its global shape, the dtype it has, and
    its two layouts."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    src: Layout
    dst: Layout


def _world():
    import torch.distributed as dist
    live = dist.is_available() and dist.is_initialized()
    return (dist.get_rank(), dist.get_backend()) if live else (0, None)


def _slices(box: Box):
    return tuple(slice(lo, hi) for lo, hi in box)


#: bytes a rank sends and receives in one batch of a switch
BATCH_BYTES = 256 << 20


def switch_state(state: Dict[Any, Optional[torch.Tensor]],
                 entries: Dict[Any, Entry],
                 dtype: Optional[torch.dtype] = None,
                 profile: Optional[SwitchProfile] = None,
                 device=None, batch_bytes: int = BATCH_BYTES
                 ) -> Dict[Any, Optional[torch.Tensor]]:
    """Moves every tensor of ``entries`` (key -> :class:`Entry`) from its
    source layout to its destination layout; ``state`` holds this rank's
    source tensors (absent where it holds none) and is consumed: each
    source leaves it once its batch is done.  Floating tensors are cast to
    ``dtype`` where given (before they travel).  Every rank of the world
    calls it with the same entries in the same order.  Returns this
    rank's destination tensors (None where it holds none)."""
    import torch.distributed as dist

    from . import comm
    me, backend = _world()
    t0 = time.perf_counter()
    out: Dict[Any, Optional[torch.Tensor]] = {}
    ops: list = []
    recvs: list = []
    done: list = []
    pending = [0]

    def flush():
        if ops:
            for req in dist.batch_isend_irecv(list(ops)):
                req.wait()
        for o, box, buf in recvs:
            o[_slices(box)].copy_(buf)
        for key in done:
            state.pop(key, None)
        ops.clear()
        recvs.clear()
        done.clear()
        pending[0] = 0

    with comm.comm_tag("switch"):
        for key, e in entries.items():
            x = state.get(key)
            src_dt = e.dtype
            cast = dtype is not None and src_dt.is_floating_point and \
                src_dt != dtype
            dt = dtype if cast else src_dt
            dev = x.device if x is not None else torch.device(
                device if device is not None else "cpu")
            staged = backend == "gloo" and dev.type == "cuda"
            itemsize = torch.empty((), dtype=src_dt).element_size()
            plan = SwitchPlan(e.shape, itemsize, e.src, e.dst)
            if profile is not None:
                profile.num_tensors += 1
                profile.total_bytes += int(np.prod(e.shape)) * itemsize
                profile.moved_bytes += plan.moved_bytes
            shape = e.dst.local_shape(e.shape, me)
            o = torch.zeros(shape, dtype=dt, device=dev) \
                if shape is not None else None
            if o is not None and x is None and \
                    any(t.dst == me for t in plan.transfers) and \
                    e.src.position(me) is not None:
                raise ValueError(f"rank {me} has no value of {key!r}")
            for t in plan.transfers:
                if t.src != me and t.dst != me:
                    continue
                n = int(np.prod([hi - lo for lo, hi in t.box])) \
                    * torch.empty((), dtype=dt).element_size()
                if t.src == me and t.dst == me:
                    o[_slices(t.dst_box)].copy_(x[_slices(t.src_box)])
                    if profile is not None:
                        profile.local_copy_bytes += n
                    continue
                if t.src == me:
                    buf = x[_slices(t.src_box)].to(dt).contiguous()
                    if staged:
                        buf = buf.cpu()
                    ops.append(dist.P2POp(dist.isend, buf, t.dst))
                    comm._record("ppermute", n, dt, 2, "world", staged)
                    if profile is not None:
                        profile.sent_bytes += n
                else:
                    shp = tuple(hi - lo for lo, hi in t.box)
                    buf = torch.empty(shp, dtype=dt,
                                      device="cpu" if staged else dev)
                    ops.append(dist.P2POp(dist.irecv, buf, t.src))
                    recvs.append((o, t.dst_box, buf))
                    if profile is not None:
                        profile.recv_bytes += n
                if profile is not None and staged:
                    profile.staged_bytes += n
                pending[0] += n
            out[key] = o
            done.append(key)
            if pending[0] >= batch_bytes:
                flush()
        flush()
    if profile is not None:
        profile.seconds += time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# the graph's switch
# ---------------------------------------------------------------------------

def _fix_spec(spec, mesh):
    """``spec`` without the axes ``mesh`` lacks (``pp`` removed, say)."""
    def fix(entry):
        kept = tuple(a for a in entry_axes(entry) if a in mesh.axis_names)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return P(*[fix(e) for e in (spec or ())])


def _drop_dim(spec, d: int):
    spec = tuple(spec or ())
    return P(*(spec[:d] + spec[d + 1:]))


class SwitchExecGraph:
    """Migrates a ``DefineAndRunGraph`` (and an optimizer) to a new mesh
    and specs.  ``pspec_overrides`` maps a variable to its new spec; the
    others keep theirs, without the axes the new mesh lacks.  The graph's
    plans stay in its pool keyed by their strategy id; the caller
    (``DefineAndRunGraph.switch_strategy``) activates the new id (the
    reference's ExecGraphPlan pool and ``SwitchParams``,
    ``define_and_run_graph.cc:1073-1129``)."""

    def __init__(self, graph, new_mesh,
                 pspec_overrides: Optional[Dict[Any, Any]] = None,
                 mode: SwitchMode = SwitchMode.ORIGIN_PARAM_AND_OPTIMIZER,
                 dtype=None):
        from ..core.dtype import torch_dtype
        self.graph = graph
        self.new_mesh = new_mesh
        self.pspec_overrides = dict(pspec_overrides or {})
        self.mode = SwitchMode(mode)
        self.dtype = torch_dtype(dtype) if dtype is not None else None
        self.profile = SwitchProfile()

    def _dst_spec(self, t):
        spec = self.pspec_overrides.get(t)
        if spec is None:
            spec = t.pspec
        return _fix_spec(spec, self.new_mesh)

    @staticmethod
    def _layout(mesh, t, spec, chunk_axis=None) -> Layout:
        return Layout.on(mesh, spec, blocks=t.shard_blocks,
                         blocks_dim=t.shard_blocks_dim, units=t.shard_units,
                         chunk_axis=chunk_axis)

    @staticmethod
    def _gshape(t) -> Tuple[int, ...]:
        return tuple(t.global_shape) if t.global_shape is not None \
            else tuple(t.concrete_shape())

    def _skeleton(self, optimizer) -> Dict[str, Any]:
        """What every rank needs to know of the state it may not hold:
        the variables' and gradient sums' dtypes and the optimizer's
        slots, broadcast from the first rank of the old mesh."""
        import torch.distributed as dist
        g = self.graph
        sk = None
        if g.mesh.in_mesh:
            sk = {"vars": {tid: v.dtype for tid, v in g._var_data.items()},
                  "accum": {tid: v.dtype for tid, v in g._grad_accum.items()},
                  "opt": None}
            if optimizer is not None and self.mode in OPT_MODES:
                sk["opt"] = self._opt_skeleton(optimizer)
        if dist.is_available() and dist.is_initialized() and \
                dist.get_world_size() > 1:
            box = [sk]
            dist.broadcast_object_list(box, src=g.mesh.ranks[0])
            sk = box[0]
        return sk

    def _opt_skeleton(self, optimizer) -> Dict[str, Any]:
        """slot -> ("flat", [dtype a bucket]) | ("params", {tid: (kind,
        dim, dtype)}) | ("tensor", shape, dtype); ``kind`` is "param"
        (laid out as the parameter), "factored" (the parameter's layout
        without dim ``dim``) or "replicated"."""
        g = self.graph
        st = optimizer._state
        if "pending" in st:
            raise NotImplementedError(
                "a switch right after load_checkpoint_state: run a step "
                "first, so that the flat buffers are packed again")
        out: Dict[str, Any] = {}
        for key, val in st.items():
            if key.startswith("flat_"):
                out[key] = ("flat", [v.dtype for v in val])
            elif isinstance(val, dict):
                ent = {}
                for tid, v in val.items():
                    p = g._var_data[tid]
                    t = g._var_tensors[tid]
                    chunk = optimizer._piece_chunked(g, t) and \
                        not optimizer.flat_state
                    want = tuple(p.chunk(g.mesh.axis_size(
                        optimizer.dp_axis), 0)[0].shape) if chunk \
                        and tid not in g._storage_axis else tuple(p.shape)
                    if tuple(v.shape) == want:
                        ent[tid] = ("param", None, v.dtype)
                        continue
                    dims = optimizer._factored_dims(self._gshape(t)) \
                        if key in ("v_row", "v_col") else None
                    dim = None if dims is None else \
                        dims[1] if key == "v_row" else dims[0]
                    if dim is not None and len(want) > 1:
                        ent[tid] = ("factored", dim, v.dtype)
                    else:
                        ent[tid] = ("replicated", tuple(v.shape), v.dtype)
                out[key] = ("params", ent)
            elif isinstance(val, torch.Tensor):
                out[key] = ("tensor", tuple(val.shape), val.dtype)
            else:
                raise TypeError(f"optimizer state {key!r} of type "
                                f"{type(val).__name__} cannot be switched")
        return out

    def switch(self, optimizer=None) -> SwitchProfile:
        g = self.graph
        old, new = g.mesh, self.new_mesh
        self._old_mesh = old
        if optimizer is None and self.mode in OPT_MODES:
            raise ValueError(f"mode {self.mode} migrates optimizer states "
                             "but no optimizer was passed")
        sk = self._skeleton(optimizer)
        tensors = g._var_tensors
        dtype = self.dtype if self.mode in TRANSFER_MODES else None
        storage = dict(g._storage_axis)
        src_var = {tid: self._layout(old, t, t.pspec, storage.get(tid))
                   for tid, t in tensors.items()}
        opt_src = self._opt_layouts(optimizer, sk["opt"]) \
            if sk["opt"] is not None else None
        # the new mesh: specs without its missing axes, local shapes
        # derived again, the captured steps dropped
        specs = {tid: self._dst_spec(t) for tid, t in tensors.items()}
        for tid, t in tensors.items():
            if t.pspec is not None or t in self.pspec_overrides:
                t.pspec = specs[tid]
        g._adopt_mesh(new)
        if sk["opt"] is not None:
            self._restore_sharded(optimizer)
        dst_var = {tid: self._layout(new, t, specs[tid],
                                     g._storage_axis.get(tid))
                   for tid, t in tensors.items()}
        dev = g.device
        if self.mode in PARAM_MODES:
            ent = {tid: Entry(self._gshape(tensors[tid]), sk["vars"][tid],
                              src_var[tid], dst_var[tid])
                   for tid in tensors if tid in sk["vars"]}
            moved = switch_state(g._var_data, ent, dtype=dtype,
                                 profile=self.profile, device=dev)
            g._var_data = {k: v for k, v in moved.items() if v is not None}
            if dtype is not None:
                for tid in ent:
                    if tensors[tid].dtype.is_floating_point:
                        tensors[tid].dtype = dtype
        if opt_src is not None:
            self._switch_optimizer(optimizer, sk["opt"], opt_src)
        # pending gradient sums follow the parameters: they share the
        # parameters' layouts, once each holds the mean over dp (a GRAD
        # run sums the rank's own gradients; the update averages them over
        # dp, and a ZeRO-3 chunk is averaged already)
        if sk["accum"] and old.in_mesh:
            from . import comm
            dp_axis = next((n.attrs["optimizer"].dp_axis for n in g.ops
                            if n.op_type == "update"), "dp")
            with comm.comm_tag("switch"):
                for tid, acc in g._grad_accum.items():
                    if tid not in storage:
                        g._grad_accum[tid] = comm.all_reduce(
                            acc, dp_axis, "mean", old)
        if sk["accum"]:
            ent = {tid: Entry(self._gshape(tensors[tid]), dt, src_var[tid],
                              dst_var[tid])
                   for tid, dt in sk["accum"].items()}
            moved = switch_state(g._grad_accum, ent, profile=self.profile,
                                 device=dev)
            g._grad_accum = {k: v for k, v in moved.items()
                             if v is not None}
        return self.profile

    # -- the optimizer --------------------------------------------------------

    def _restore_sharded(self, optimizer) -> None:
        """ZeRO-3 (per parameter) stores a parameter as its dp chunk where
        the optimizer's rule chunks it: the rule is taken again on the new
        mesh (a parameter that tp now splits on dim 0 is stored whole)."""
        g = self.graph
        if optimizer.zero < 3 or optimizer.flat_state or \
                not optimizer._shards_state:
            return
        xs = next((n.attrs["xs"] for n in g.ops if n.op_type == "update"
                   and n.attrs["optimizer"] is optimizer), [])
        for t in xs:
            g._storage_axis.pop(t.id, None)
            if optimizer._chunked(g, t):
                g._storage_axis[t.id] = optimizer.dp_axis

    def _opt_layouts(self, optimizer, osk) -> Dict[str, Any]:
        """slot -> {tid: (global shape, layout)} or (shape, layout), the
        layouts on the graph's current mesh (taken before and after the
        mesh changes)."""
        g = self.graph
        mesh = g.mesh
        out: Dict[str, Any] = {}
        for key, desc in osk.items():
            if desc[0] == "flat":
                continue
            if desc[0] == "tensor":
                out[key] = (desc[1], Layout.on(mesh, P()))
                continue
            ent = {}
            for tid, (kind, dim, _) in desc[1].items():
                t = g._var_tensors[tid]
                gshape = self._gshape(t)
                if kind == "replicated":
                    ent[tid] = (dim, Layout.on(mesh, P()))
                elif kind == "factored":
                    if t.shard_blocks and dim == t.shard_blocks_dim:
                        raise NotImplementedError(
                            f"a factored statistic of {t.name} over its "
                            f"fused dim")
                    bd = t.shard_blocks_dim - (dim < t.shard_blocks_dim)
                    ent[tid] = (gshape[:dim] + gshape[dim + 1:], Layout.on(
                        mesh, _drop_dim(t.pspec, dim), blocks=t.shard_blocks,
                        blocks_dim=bd, units=t.shard_units))
                else:
                    chunk = optimizer.dp_axis if (
                        optimizer._piece_chunked(g, t) and
                        not optimizer.flat_state) else None
                    ent[tid] = (gshape, self._layout(mesh, t, t.pspec, chunk))
            out[key] = ent
        return out

    def _switch_optimizer(self, optimizer, osk, src) -> None:
        g = self.graph
        dst = self._opt_layouts(optimizer, osk)
        st = optimizer._state
        new_state: Dict[str, Any] = {}
        flat = [k for k, d in osk.items() if d[0] == "flat"]
        for key, desc in osk.items():
            if desc[0] == "flat":
                continue
            if desc[0] == "tensor":
                shape, lay = src[key]
                box = {key: st.pop(key)} if key in st else {}
                moved = switch_state(
                    box, {key: Entry(shape, desc[2], lay, dst[key][1])},
                    profile=self.profile, device=g.device)
                if moved[key] is not None:
                    new_state[key] = moved[key]
                continue
            ent = {tid: Entry(src[key][tid][0], dt, src[key][tid][1],
                              dst[key][tid][1])
                   for tid, (_, _, dt) in desc[1].items()}
            moved = switch_state(st.pop(key, {}), ent, profile=self.profile,
                                 device=g.device)
            new_state[key] = {k: v for k, v in moved.items()
                              if v is not None}
        if flat:
            new_state.update(self._switch_flat(optimizer, osk, flat))
        optimizer._state = new_state if g.mesh.in_mesh else {}

    def _switch_flat(self, optimizer, osk, keys) -> Dict[str, Any]:
        """The flat dp-sharded buffers across a mesh change.  A dp resize
        changes each bucket's chunk (``quantized_chunk``), but not the
        order or the offsets of the parameters in it (bucket planning does
        not depend on dp): so each bucket is one 1-D tensor whose source
        and destination layouts are its old and new chunks over dp, its
        padding left zero.  The flat state never leaves the flat regime,
        and the next step's reduce-scatter geometry holds at once."""
        from ..optim.flat_state import FlatStateLayout
        g = self.graph
        old_lay = optimizer._flat
        dp_axis = optimizer.dp_axis
        if dp_axis not in self.new_mesh.axis_names:
            raise ValueError(
                f"flat_state optimizer needs axis {dp_axis!r} on the new "
                f"mesh; got {self.new_mesh.axis_names}")
        if old_lay is None:
            raise ValueError("flat optimizer state without its layout")
        dp = self.new_mesh.axis_size(dp_axis)
        new_lay = FlatStateLayout(old_lay.entries, dp,
                                  bucket_mb=old_lay.bucket_mb,
                                  block=old_lay.block)
        old_mesh = self._old_mesh
        st = optimizer._state
        out: Dict[str, Any] = {}
        for key in keys:
            dts = osk[key][1]
            ents, vals = {}, {}
            for bi, b in enumerate(old_lay.buckets):
                numel = sum(b.numels)
                ents[bi] = Entry(
                    (numel,), dts[bi],
                    Layout.on(old_mesh, P(dp_axis),
                              shape=(old_lay.padded_sizes[bi],)),
                    Layout.on(self.new_mesh, P(dp_axis),
                              shape=(new_lay.padded_sizes[bi],)))
                self.profile.repack_bytes += numel * 4
                if key in st:
                    vals[bi] = st[key][bi]
            st.pop(key, None)
            moved = switch_state(vals, ents, profile=self.profile,
                                 device=g.device)
            if g.mesh.in_mesh:
                out[key] = [moved[bi] for bi in range(len(old_lay.buckets))]
        optimizer._flat = new_lay
        optimizer._params_stale = False
        return out
