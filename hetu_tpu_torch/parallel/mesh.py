"""Process-group meshes (counterpart of ``hetu_tpu.parallel.mesh``).

The JAX package's mesh is a ``jax.sharding.Mesh`` of devices, and GSPMD
derives the collective groups from it.  SPMD here is by process: one
``torch.distributed`` rank per mesh position, and a ``Mesh`` holds the
process group of each axis slice it belongs to.  ``create_mesh({"dp":
2, "tp": 2})`` lays the ranks out as the JAX package lays out devices:
later axes are innermost, so rank ``r`` sits at
``np.unravel_index(r, (2, 2))`` and ``tp`` varies fastest.

The backend is chosen once, when the processes join
(:func:`init_process_group`), and stated on the mesh (``mesh.backend``):
NCCL when every rank has a GPU of its own, that is when every host has
at least as many cards as ranks, gloo otherwise (CPU tensors, or several
ranks on one card, which NCCL refuses).  A failing NCCL init raises; it
never turns into gloo.  A rank runs on ``cuda:{local_rank %
device_count}``, its local rank being its place among the ranks of its
host, unless the caller passes ``device="cpu"``.

``PartitionSpec`` (``P``) is the port's own: a tuple of mesh-axis names
(or tuples of them, outer first), one entry a dim.  An axis the mesh
lacks counts as replication, as the JAX graph drops it
(``Graph._pspec_for``).  :func:`take_shard` and :func:`shard_pieces`
slice a global value into a rank's shard; ``blocks`` splits a fused dim
(``[q | k | v]``, SwiGLU's two halves) block by block, so that a rank
holds its part of every block rather than one contiguous run of the
fused dim (dim 0 of a layer's weight, ``blocks_dim`` 2 of the pipeline's
stacked ``[stages, layers, rows, h]`` weights).
"""
from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .dstates import DUPLICATE, PARTIAL, DistributedStates

AXIS_DP = "dp"      # data parallel
AXIS_CP = "cp"      # context (sequence) parallel
AXIS_TP = "tp"      # tensor/model parallel
AXIS_PP = "pp"      # pipeline parallel
AXIS_EP = "ep"      # expert parallel


class PartitionSpec(tuple):
    """``P("dp", None)``: the mesh axes each dim is split over."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

_CURRENT: List["Mesh"] = []


def current_mesh() -> Optional["Mesh"]:
    """The innermost ``with mesh:`` block's mesh, or ``None``."""
    return _CURRENT[-1] if _CURRENT else None


def choose_backend(hosts: Sequence[Tuple[str, int]], device="cuda"
                   ) -> str:
    """``"nccl"`` when every rank has a GPU of its own, else ``"gloo"``
    (CPU tensors, or ranks sharing a card: NCCL refuses two ranks of one
    communicator on one device).  ``hosts`` holds each rank's
    ``(host name, cards on that host)``, in rank order."""
    if torch.device(device).type != "cuda":
        return "gloo"
    ranks: Dict[str, int] = {}
    for h, _ in hosts:
        ranks[h] = ranks.get(h, 0) + 1
    cards = {h: int(n) for h, n in hosts}
    return "nccl" if all(cards[h] >= n for h, n in ranks.items()) \
        else "gloo"


def local_rank(hosts: Sequence[Tuple[str, int]], rank: int) -> int:
    """``rank``'s place among the ranks on its own host."""
    h = hosts[rank][0]
    return sum(1 for g, _ in hosts[:rank] if g == h)


def rank_device(local: int, device="cuda") -> torch.device:
    """The device of the rank with local rank ``local``:
    ``cuda:{local % device_count}``, or the CPU when asked for."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass device='cpu'")
    return torch.device("cuda", int(local) % n)


# the local rank :func:`init_process_group` gave this process
_LOCAL_RANK: List[int] = []


def init_process_group(rank: int, world_size: int, init_method: str,
                       device="cuda", timeout: float = 60.0,
                       hosts: Optional[Sequence[Tuple[str, int]]] = None
                       ) -> str:
    """Joins this process to the group as ``rank`` of ``world_size``
    (``init_method``: ``tcp://host:port`` or ``file://path``), on the
    backend :func:`choose_backend` picks.  ``hosts`` is each rank's
    ``(host name, cards)`` (:func:`rpc.distributed_init` gathers it
    through the coordinator); without it every rank is on this host.
    ``timeout`` bounds every collective, so a mismatched one fails
    instead of hanging.  Returns the backend."""
    import socket

    import torch.distributed as dist
    if hosts is None:
        n = torch.cuda.device_count() \
            if torch.device(device).type == "cuda" else 0
        hosts = [(socket.gethostname(), n)] * int(world_size)
    if len(hosts) != int(world_size):
        raise ValueError(f"{len(hosts)} host records for {world_size} ranks")
    backend = choose_backend(hosts, device)
    local = local_rank(hosts, int(rank))
    dev = rank_device(local, device)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=init_method, rank=int(rank),
        world_size=int(world_size),
        timeout=datetime.timedelta(seconds=float(timeout)), **kw)
    _LOCAL_RANK[:] = [local]
    return backend


class Mesh:
    """A named mesh over the ranks of ``torch.distributed`` (or over one
    process, where every axis has size 1 and no group is made).

    ``ranks`` (a permutation of the world's ranks, or of some of them)
    puts rank ``ranks[i]`` at mesh position ``i``; by default rank ``r``
    sits at position ``r`` and the mesh spans the world.  A rank outside
    ``ranks`` gets a mesh that holds no position (``in_mesh`` false,
    ``position`` None): it makes every group with the others and takes
    part in no step."""

    def __init__(self, shape: Dict[str, int], device=None,
                 ranks: Optional[Sequence[int]] = None):
        import torch.distributed as dist
        self.axis_names: Tuple[str, ...] = tuple(shape.keys())
        self.shape: Dict[str, int] = {a: int(shape[a])
                                      for a in self.axis_names}
        self.size = int(np.prod(list(self.shape.values()))) \
            if self.shape else 1
        live = dist.is_available() and dist.is_initialized()
        if self.size > 1 and not live:
            raise ValueError(
                f"a mesh of {self.size} ranks needs torch.distributed: call "
                f"rpc.distributed_init or parallel.init_process_group first")
        world = dist.get_world_size() if live else 1
        self.rank = dist.get_rank() if live else 0
        if ranks is None:
            if live and world != self.size:
                raise ValueError(f"mesh {self.shape} has {self.size} "
                                 f"positions, the process group {world} "
                                 f"ranks")
            ranks = range(self.size)
        self.ranks: Tuple[int, ...] = tuple(int(r) for r in ranks)
        if len(self.ranks) != self.size or \
                len(set(self.ranks)) != self.size or \
                any(not 0 <= r < world for r in self.ranks):
            raise ValueError(f"ranks {list(self.ranks)} must be {self.size} "
                             f"distinct ranks of the world's {world} for "
                             f"mesh {self.shape}")
        self.position: Optional[int] = self.ranks.index(self.rank) \
            if self.rank in self.ranks else None
        self.backend: Optional[str] = dist.get_backend() if live else None
        sizes = tuple(self.shape.values())
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names,
            (int(c) for c in np.unravel_index(self.position, sizes)))) \
            if sizes and self.position is not None else {}
        self.device = rank_device(
            _LOCAL_RANK[0] if live and _LOCAL_RANK else self.rank,
            "cuda" if device is None else device)
        self._groups: Dict[str, object] = {}
        self._group_ranks: Dict[str, List[int]] = {}
        self._group_order: Dict[str, List[int]] = {}
        grid = np.asarray(self.ranks).reshape(sizes) if sizes else None
        for i, a in enumerate(self.axis_names):
            if self.shape[a] == 1:
                self._group_ranks[a] = [self.rank]
                continue
            # every rank makes every group, in one order
            lines = np.moveaxis(grid, i, -1).reshape(-1, self.shape[a])
            for line in lines:
                ranks = [int(r) for r in line]
                grp = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[a] = grp
                    self._group_ranks[a] = ranks
                    if ranks != sorted(ranks):
                        # a process group orders its ranks by number:
                        # ``comm`` maps its order to the axis' order
                        self._group_order[a] = [sorted(ranks).index(r)
                                                for r in ranks]

    @property
    def in_mesh(self) -> bool:
        """Whether this rank holds a position of the mesh."""
        return self.position is not None

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """This rank's process group along ``axis`` (``None`` at size 1)."""
        return self._groups.get(axis)

    def group_order(self, axis: str) -> Optional[List[int]]:
        """For each index along ``axis``, the process-group rank of the
        rank there; None where they coincide (the line's ranks ascend)."""
        return self._group_order.get(axis)

    def group_ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's group along ``axis``, in axis
        order."""
        return list(self._group_ranks.get(axis, [self.rank]))

    def __enter__(self) -> "Mesh":
        _CURRENT.append(self)
        return self

    def __exit__(self, *exc):
        _CURRENT.remove(self)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"backend={self.backend}, device={self.device})")


def create_mesh(shape: Dict[str, int], device=None,
                ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh with named axes over the processes of ``torch.distributed``
    (``{"dp": 2, "tp": 2}``; later axes innermost).  ``ranks`` lays
    the mesh over those ranks, ``ranks[i]`` at position ``i`` (every
    rank of the world calls it, those outside too)."""
    return Mesh(shape, device, ranks)


def single_device_mesh(device=None) -> Mesh:
    return Mesh({AXIS_DP: 1}, device)


def mesh_axis_size(mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1) if axis in mesh.axis_names else 1


# ---------------------------------------------------------------------------
# shards of a global value
# ---------------------------------------------------------------------------

def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_axes(pspec) -> set:
    """Every mesh axis a spec names."""
    return {a for e in (pspec or ()) for a in entry_axes(e)}


def dim_split(entry, mesh) -> Tuple[int, int]:
    """(ways, this rank's index) of one spec entry: the product of its
    axes' sizes and their coordinates in mixed radix, outer first; axes
    the mesh lacks are ignored."""
    n, i = 1, 0
    for a in entry_axes(entry):
        if mesh is None or a not in mesh.axis_names:
            continue
        s = mesh.shape[a]
        n, i = n * s, i * s + mesh.coords.get(a, 0)
    return n, i


def local_shape(global_shape: Sequence[int], pspec, mesh) -> Tuple[int, ...]:
    out = []
    for d, size in enumerate(global_shape):
        entry = pspec[d] if pspec is not None and d < len(pspec) else None
        n, _ = dim_split(entry, mesh)
        if size % n:
            raise ValueError(f"dim {d} of {tuple(global_shape)} is not "
                             f"divisible by {n} shards ({pspec!r})")
        out.append(size // n)
    return tuple(out)


def _block_split(b: int, n: int, i: int, unit: Optional[int]
                 ) -> Tuple[int, int]:
    """(width, index) of a rank's part of a block of ``b`` rows split
    over ``n`` shards, ``i`` being the rank's shard.  A block of ``unit``
    heads fewer than ``n`` is split over ``unit`` ways and each part held
    by ``n // unit`` consecutive shards (GQA's kv heads under a tp above
    their count: the heads repeated, then sharded)."""
    if unit is not None and 0 < unit < n:
        if n % unit:
            raise ValueError(f"{n} shards do not divide into {unit} heads")
        return b // unit, i // (n // unit)
    if b % n:
        raise ValueError(f"block {b} is not divisible by {n} shards")
    return b // n, i


def shard_pieces(global_shape: Sequence[int], pspec, mesh,
                 blocks: Optional[Sequence[int]] = None,
                 blocks_dim: int = 0,
                 units: Optional[Sequence[int]] = None):
    """The rank's shard as pieces of the global value: a list of
    ``(global slices, local slices)``.  ``blocks`` (sizes summing to dim
    ``blocks_dim``) splits that dim block by block: one piece a block;
    ``units`` (heads a block) lets a block of fewer heads than shards
    repeat over the shards (:func:`_block_split`)."""
    shape = tuple(int(s) for s in global_shape)
    bd = blocks_dim
    entry = pspec[bd] if blocks and pspec is not None and bd < len(pspec) \
        else None
    n, i = dim_split(entry, mesh)
    if not blocks or not shape or n == 1:
        loc = local_shape(shape, pspec, mesh)
        base_g, base_l = [], []
        for d, size in enumerate(shape):
            e = pspec[d] if pspec is not None and d < len(pspec) else None
            m, j = dim_split(e, mesh)
            base_g.append(slice(j * (size // m), (j + 1) * (size // m)))
            base_l.append(slice(0, loc[d]))
        return [(tuple(base_g), tuple(base_l))]
    if sum(blocks) != shape[bd]:
        raise ValueError(f"blocks {tuple(blocks)} do not sum to dim {bd} "
                         f"of {shape}")
    rest = tuple(pspec[d] if d != bd and pspec is not None and d < len(pspec)
                 else None for d in range(len(shape)))
    base = shard_pieces(shape, rest, mesh)[0]
    pieces, g0, l0 = [], 0, 0
    for k, b in enumerate(blocks):
        try:
            w, j = _block_split(b, n, i, units[k] if units else None)
        except ValueError as e:
            raise ValueError(f"blocks {tuple(blocks)}: {e}") from None
        gs, ls = list(base[0]), list(base[1])
        gs[bd] = slice(g0 + j * w, g0 + (j + 1) * w)
        ls[bd] = slice(l0, l0 + w)
        pieces.append((tuple(gs), tuple(ls)))
        g0, l0 = g0 + b, l0 + w
    return pieces


def pieces_shape(pieces, ndim: int) -> Tuple[int, ...]:
    """The local shape the pieces of :func:`shard_pieces` fill."""
    return tuple(max(p[1][d].stop for p in pieces) for d in range(ndim))


def take_shard(x, pspec, mesh, blocks: Optional[Sequence[int]] = None,
               blocks_dim: int = 0, units: Optional[Sequence[int]] = None):
    """The rank's shard of the global value ``x`` (numpy or torch)."""
    if all(dim_split(e, mesh)[0] == 1 for e in (pspec or ())):
        return x
    pieces = shard_pieces(tuple(x.shape), pspec, mesh, blocks, blocks_dim,
                          units)
    if len(pieces) == 1:
        return x[pieces[0][0]]
    parts = [x[g] for g, _ in pieces]
    if isinstance(x, torch.Tensor):
        return torch.cat(parts, blocks_dim)
    return np.concatenate(parts, blocks_dim)


def unblock(gathered: torch.Tensor, n: int, blocks: Sequence[int],
            dim: int = 0, units: Optional[Sequence[int]] = None
            ) -> torch.Tensor:
    """Dim ``dim`` gathered over ``n`` shards of a blocked layout (each
    shard's part of every block, shard after shard) back into the global
    order (every shard's part of block 0, then of block 1, ...).  A block
    that ``units`` repeats over the shards is taken once a part."""
    per = gathered.shape[dim] // n
    shards = gathered.split(per, dim)
    parts = []
    for k, b in enumerate(blocks):
        unit = units[k] if units else None
        w, _ = _block_split(b, n, 0, unit)
        off = sum(_block_split(blocks[q], n, 0, units[q] if units else None)
                  [0] for q in range(k))
        step = n // unit if unit is not None and 0 < unit < n else 1
        parts += [shards[i].narrow(dim, off, w) for i in range(0, n, step)]
    return torch.cat(parts, dim)


def layout_shape(global_shape: Sequence[int], pspec, mesh,
                 blocks: Optional[Sequence[int]] = None, blocks_dim: int = 0,
                 units: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """The rank's local shape of a value laid out by ``pspec`` and its
    blocks (a block that repeats over the shards keeps more rows)."""
    if not units:
        return local_shape(global_shape, pspec, mesh)
    return pieces_shape(shard_pieces(global_shape, pspec, mesh, blocks,
                                     blocks_dim, units), len(global_shape))


# ---------------------------------------------------------------------------
# DS <-> PartitionSpec
# ---------------------------------------------------------------------------

def _axis_name_for(dim: int) -> str:
    if dim == DUPLICATE:
        return "_dup"
    if dim == PARTIAL:
        return "_partial"
    return f"_s{dim}"


def ds_to_mesh_and_spec(ds: DistributedStates
                        ) -> Tuple[Dict[str, int], PartitionSpec]:
    """Lower a DS to (mesh axes, PartitionSpec).  The axes are the DS
    ``order`` dims, outermost first, so that rank order over the mesh
    equals the DS device numbering; duplicate and partial dims become
    axes no entry names.  The port's meshes are made of processes, so
    this returns the axes (name -> size) for :func:`create_mesh`."""
    order = ds.order
    if not order:
        return {"_dup": 1}, P()
    axes = {_axis_name_for(o): ds.get_dim(o) for o in order}
    ndim = max((o for o in order if o >= 0), default=-1) + 1
    spec = [None] * ndim
    for o in order:
        if o >= 0:
            spec[o] = _axis_name_for(o)
    return axes, P(*spec)


def ds_from_partition_spec(mesh, spec, partial_axes: Sequence[str] = (),
                           zero: bool = False) -> DistributedStates:
    """Inverse lowering: a (mesh, pspec) pair back to a DistributedStates.
    ``mesh`` is a :class:`Mesh` or a dict of axis sizes; ``partial_axes``
    marks axes over which the value holds partial sums."""
    shape = dict(mesh) if isinstance(mesh, dict) else dict(mesh.shape)
    names = list(shape)
    device_num = int(np.prod([shape[a] for a in names])) if names else 1
    states: Dict[int, int] = {}
    dim_of_axis: Dict[str, int] = {}
    for d, entry in enumerate(tuple(spec) if spec is not None else ()):
        axes = entry_axes(entry)
        if not axes:
            continue
        n = 1
        for a in axes:
            n *= shape[a]
            dim_of_axis[a] = d
        if n > 1:
            states[d] = states.get(d, 1) * n
    partial = 1
    for a in partial_axes:
        partial *= shape[a]
        dim_of_axis[a] = PARTIAL
    if partial > 1:
        states[PARTIAL] = partial
    dup = device_num // int(np.prod(list(states.values()))) if states \
        else device_num
    if dup > 1:
        states[DUPLICATE] = dup
    order: List[int] = []
    for a in names:
        d = dim_of_axis.get(a, DUPLICATE)
        if d not in order:
            order.append(d)
    order = [o for o in order if states.get(o, 1) > 1]
    return DistributedStates(device_num, states, order, zero=zero)
