"""DistributedStates: the sharding spec of a tensor over a device group
(copy of ``hetu_tpu.parallel.dstates``; pure Python).

A tensor's layout over a device group is a map ``{dim -> split_count}``
with two special dims,

* ``-1``: duplicate (replicated copies),
* ``-2``: partial (pending-reduce partial sums),

plus an ``order`` list giving the significance of each split dim in the
mixed-radix device numbering, and a ``zero`` flag marking optimizer-state
sharding (ZeRO).  ``deduce_comm_kind`` names the collective that turns
one layout into another.

In the port a mesh is a set of ``torch.distributed`` process groups
(``parallel.mesh``) and the layers issue their collectives themselves
(``parallel.comm``, ``nn.parallel``).  ``predict_grad_comm_collectives``
and ``predict_flat_update_collectives`` predict the collectives of one
coalesced gradient sync; the JAX package checks them against the lowered
XLA text, the port against the records of ``comm.comm_stats()``, which
log every collective it issues.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Special dims.
DUPLICATE = -1
PARTIAL = -2
NULL_HETERO_DIM = -3  # DistributedStatesUnion sentinel (distributed_states.h:155)


class DistributedStates:
    """Sharding layout over an ordered device group of ``device_num`` devices."""

    __slots__ = ("_device_num", "_states", "_order", "_zero")

    def __init__(self, device_num: int,
                 states: Optional[Dict[int, int]] = None,
                 order: Optional[Sequence[int]] = None,
                 zero: bool = False):
        if device_num < 1:
            raise ValueError("device_num must be >= 1")
        self._device_num = int(device_num)
        self._zero = bool(zero)
        self._set_states(states or {})
        self._set_order(list(order) if order is not None else [])

    # -- construction helpers -------------------------------------------------

    @staticmethod
    def pure_duplicate(device_num: int) -> "DistributedStates":
        return DistributedStates(device_num, {DUPLICATE: device_num})

    @staticmethod
    def split(device_num: int, dim: int) -> "DistributedStates":
        return DistributedStates(device_num, {dim: device_num})

    def _set_states(self, states: Dict[int, int]) -> None:
        res = {k: v for k, v in states.items() if v > 1}
        prod = 1
        for v in res.values():
            prod *= v
        if prod != self._device_num:
            raise ValueError(
                f"states {states} imply {prod} devices, expected {self._device_num}")
        res.setdefault(PARTIAL, 1)
        res.setdefault(DUPLICATE, 1)
        self._states = res

    def _set_order(self, order: List[int]) -> None:
        active = sorted(k for k, v in self._states.items() if v > 1)
        if not order:
            self._order = active
        else:
            missing = [k for k in active if k not in order]
            if missing:
                raise ValueError(f"order {order} missing split dims {missing}")
            self._order = [o for o in order if self._states.get(o, 1) > 1]

    # -- accessors ------------------------------------------------------------

    @property
    def device_num(self) -> int:
        return self._device_num

    @property
    def states(self) -> Dict[int, int]:
        return dict(self._states)

    @property
    def order(self) -> List[int]:
        return list(self._order)

    @property
    def zero(self) -> bool:
        return self._zero

    def with_zero(self, zero: bool) -> "DistributedStates":
        return DistributedStates(self._device_num, self._states, self._order, zero)

    def get_dim(self, dim: int) -> int:
        return self._states.get(dim, 1)

    # -- basic predicates (distributed_states.cc:221-266) ---------------------

    def check_equal(self, other: "DistributedStates") -> bool:
        return (self._device_num == other._device_num
                and self._states == other._states
                and self._order == other._order)

    def check_max_dim(self, max_dim: int) -> bool:
        return all(o < max_dim for o in self._order)

    def check_pure_duplicate(self) -> bool:
        return self._device_num == self.get_dim(DUPLICATE)

    # -- combine/reduce machinery (distributed_states.cc:102-293) -------------

    def _combine_states(self, src: Sequence[int], dst: int) -> Dict[int, int]:
        """Merge split dims ``src`` into ``dst`` (renumbering positives)."""
        states = dict(self._states)
        value = 1
        for s in src:
            if s == dst:
                raise ValueError("cannot combine a dim into itself")
            if s in (PARTIAL, DUPLICATE):
                value *= states.get(s, 1)
                states[s] = 1
            else:
                if s in states:
                    value *= states.pop(s)
                # dims after s shift forward by one
                for key in sorted(k for k in states if k >= 0 and k > s):
                    states[key - 1] = states.pop(key)
        if dst in (PARTIAL, DUPLICATE):
            states[dst] = states.get(dst, 1) * value
        else:
            for s in src:
                if s >= 0 and dst > s:
                    dst -= 1
            states[dst] = states.get(dst, 1) * value
        return states

    def _combine_order(self, src: Sequence[int], dst: int) -> List[int]:
        order = list(self._order)
        inds = sorted(order.index(d) for d in (*src, dst) if d in order)
        if inds:
            if any(inds[i] != inds[0] + i for i in range(len(inds))):
                raise ValueError("cannot combine non-adjacent dims in order")
            order[inds[0]] = dst
            del order[inds[0] + 1:inds[0] + len(inds)]
            for i, o in enumerate(order):
                if o > 0:
                    shift = sum(1 for s in src if 0 <= s < o)
                    order[i] = o - shift
        return order

    @staticmethod
    def _norm(states: Dict[int, int], order: List[int]) -> Tuple[Dict[int, int], List[int]]:
        s = {k: v for k, v in states.items() if v > 1}
        o = [d for d in order if s.get(d, 1) > 1]
        return s, o

    def check_combine(self, dst_ds: "DistributedStates",
                      src: Sequence[int], dst: int) -> bool:
        try:
            states = self._combine_states(src, dst)
            order = self._combine_order(src, dst)
        except ValueError:
            return False
        return (self._norm(states, order)
                == self._norm(dst_ds._states, dst_ds._order))

    def _reduce_states(self, dim: int) -> Dict[int, int]:
        states = dict(self._states)
        if dim in (PARTIAL, DUPLICATE):
            states[dim] = 1
        else:
            states.pop(dim, None)
        return states

    def check_reduce_dim(self, dst_ds: "DistributedStates", dim: int) -> bool:
        states = self._reduce_states(dim)
        order = [o for o in self._order if o != dim]
        return (self._norm(states, order)
                == self._norm(dst_ds._states, dst_ds._order))

    def get_split_dim(self, merged_ds: "DistributedStates") -> int:
        """The (single) positive dim on which self is more split than merged."""
        split_dim = NULL_HETERO_DIM
        merged = merged_ds._states
        for k, v in self._states.items():
            if k >= 0 and v > 1 and merged.get(k, 1) < v:
                if split_dim != NULL_HETERO_DIM:
                    raise ValueError(
                        f"only one gather dim supported: {self._states} vs {merged}")
                split_dim = k
        return split_dim

    # -- collective deduction predicates (distributed_states.h:110-115) -------

    def check_allreduce(self, dst_ds: "DistributedStates") -> bool:
        return self.get_dim(PARTIAL) > 1 and self.check_combine(
            dst_ds, [PARTIAL], DUPLICATE)

    def check_scatter(self, dst_ds: "DistributedStates") -> bool:
        try:
            scatter_dim = dst_ds.get_split_dim(self)
        except ValueError:
            return False
        return self.get_dim(DUPLICATE) > 1 and self.check_combine(
            dst_ds, [DUPLICATE], scatter_dim)

    def check_allgather(self, dst_ds: "DistributedStates") -> bool:
        try:
            gather_dim = self.get_split_dim(dst_ds)
        except ValueError:
            return False
        if gather_dim == NULL_HETERO_DIM:
            return False
        return (self.get_dim(gather_dim) > 1 and dst_ds.get_dim(DUPLICATE) > 1
                and dst_ds.check_combine(self, [DUPLICATE], gather_dim))

    def check_reducescatter(self, dst_ds: "DistributedStates") -> bool:
        try:
            scatter_dim = dst_ds.get_split_dim(self)
        except ValueError:
            return False
        return self.get_dim(PARTIAL) > 1 and self.check_combine(
            dst_ds, [PARTIAL], scatter_dim)

    def check_broadcast(self, dst_ds: "DistributedStates") -> bool:
        return dst_ds.get_dim(DUPLICATE) > 1 and dst_ds.check_reduce_dim(
            self, DUPLICATE)

    def check_reduce(self, dst_ds: "DistributedStates") -> bool:
        return self.get_dim(PARTIAL) > 1 and self.check_reduce_dim(
            dst_ds, PARTIAL)

    # -- device <-> shard mapping (distributed_states.cc:360-420) -------------

    def get_loop_sizes(self) -> List[int]:
        """Stride (in device indices) of each order dim."""
        sizes = [1]
        for o in reversed(self._order):
            sizes.insert(0, sizes[0] * self.get_dim(o))
        return sizes[1:] if len(sizes) > 1 else [1]

    def map_device_to_state_index(self, device_index: int) -> Dict[int, int]:
        """Which slice of each dim device ``device_index`` owns."""
        state_index: Dict[int, int] = {}
        for o in reversed(self._order):
            n = self._states[o]
            state_index[o] = device_index % n
            device_index //= n
        return state_index

    def get_dup_group_index(self, device_index: int) -> int:
        idx = self.map_device_to_state_index(device_index)
        dup_group, interval = 0, 1
        for dim in sorted(self._order, reverse=True):
            if dim < 0:
                break
            dup_group += idx[dim] * interval
            interval *= self.get_dim(dim)
        return dup_group

    def get_group_indices_by_dim(self, dim: int, device_index: int) -> List[int]:
        """Device indices of the collective group along ``dim`` that contains
        ``device_index`` (reference ``get_devices_by_dim``)."""
        pos = self._order.index(dim)
        interval = 1
        for o in self._order[pos + 1:]:
            interval *= self._states[o]
        macro = interval * self.get_dim(dim)
        start = device_index - device_index % macro + device_index % interval
        return list(range(start, start + macro, interval))

    def local_slice(self, global_shape: Sequence[int],
                    device_index: int) -> Tuple[slice, ...]:
        """The slice of the global tensor owned by ``device_index``.

        Host-side data slicing; equivalent of the reference's
        ``parallel_data_provider`` (``parallel_multi_ds.py:16``).
        """
        idx = self.map_device_to_state_index(device_index)
        slices = []
        for d, size in enumerate(global_shape):
            n = self.get_dim(d)
            if size % n != 0:
                raise ValueError(f"dim {d} size {size} not divisible by {n}")
            chunk = size // n
            i = idx.get(d, 0)
            slices.append(slice(i * chunk, (i + 1) * chunk))
        return tuple(slices)

    def local_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(s // self.get_dim(d) for d, s in enumerate(global_shape))

    # -- misc -----------------------------------------------------------------

    def __eq__(self, other) -> bool:
        return isinstance(other, DistributedStates) and self.check_equal(other)

    def __hash__(self) -> int:
        return hash((self._device_num, tuple(sorted(self._states.items())),
                     tuple(self._order)))

    def __repr__(self) -> str:
        states = {k: v for k, v in sorted(self._states.items()) if v > 1}
        z = ", zero" if self._zero else ""
        return f"DS(n={self._device_num}, states={states}, order={self._order}{z})"


def deduce_comm_kind(src: DistributedStates, dst: DistributedStates) -> str:
    """Which collective converts ``src`` into ``dst``.

    Mirrors the decision procedure of the reference's ``SubstituteCommOp``
    (``executable_graph.cc:1006``): try the cheap structured collectives
    first, fall back to a general resharding (batched point-to-point in the
    reference; a generic GSPMD reshard for us).
    """
    if src.check_equal(dst):
        return "identity"
    if src.check_allreduce(dst):
        return "all_reduce"
    if src.check_allgather(dst):
        return "all_gather"
    if src.check_reducescatter(dst):
        return "reduce_scatter"
    if src.check_scatter(dst):
        return "scatter"
    if src.check_broadcast(dst):
        return "broadcast"
    if src.check_reduce(dst):
        return "reduce"
    return "reshard"  # generic (BatchedISendIRecv in the reference)


# -- pspec edges: PartitionSpec -> DS, and per-edge comm deduction ------------
#
# A PartitionSpec over named mesh axes is the other spelling of a
# DistributedStates, so an edge between two annotations maps back into DS
# space and the comm-op deduction (`deduce_comm_kind` above) names the
# collective the transition needs.


def _ds_from_splits(device_num: int,
                    splits: Dict[int, int]) -> DistributedStates:
    """Assemble a DS from per-dim split counts over ``device_num``
    devices, leftover factor as duplicate(-1), with POSITIVES-FIRST
    order (duplicate least significant): a gathered / scattered dim
    then trades places with the duplicate factor exactly as
    ``check_combine`` expects, so allgather/scatter/reducescatter
    deduction works on pspec-derived states (the canonical sorted order
    would put -1 first and spuriously fail the order check)."""
    states = dict(splits)
    split_total = 1
    for v in states.values():
        split_total *= v
    states[DUPLICATE] = device_num // split_total
    order = sorted(k for k, v in states.items() if k >= 0 and v > 1)
    if states[DUPLICATE] > 1:
        order.append(DUPLICATE)
    return DistributedStates(device_num, states, order)


def pspec_shard_divisor(pspec, mesh_axes: Dict[str, int]) -> int:
    """How many ways a ``PartitionSpec`` shards a value over the mesh:
    the product of the named-axis sizes it mentions (tuple entries
    flattened, unknown axes size 1).  ``None`` pspec = replicated = 1.
    Shared by graph registration (``_arg_memory_facts``) and the static
    memory pass (``analysis.memory.classify_args``) so registered and
    fallback divisors can never disagree on pspec semantics."""
    if pspec is None:
        return 1
    d = 1
    for entry in pspec:
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            d *= int(mesh_axes.get(str(a), 1))
    return d


def pspec_to_ds(pspec, ndim: int, mesh_axes: Dict[str, int]
                ) -> DistributedStates:
    """Lower a ``PartitionSpec`` over a named mesh into a
    :class:`DistributedStates`: each sharded tensor dim becomes a split
    dim with the product of its mesh-axis sizes, the leftover device
    factor becomes duplicate(-1).  ``pspec=None`` means fully replicated
    (GSPMD's default for unannotated values)."""
    device_num = 1
    for s in mesh_axes.values():
        device_num *= int(s)
    splits: Dict[int, int] = {}
    if pspec is not None:
        for d, entry in enumerate(pspec):
            if entry is None:
                continue
            ents = entry if isinstance(entry, tuple) else (entry,)
            split = 1
            for a in ents:
                if a is not None:
                    split *= int(mesh_axes.get(a, 1))
            if split > 1:
                if d >= ndim:
                    raise ValueError(
                        f"pspec {pspec} has more sharded entries than "
                        f"tensor dims ({ndim})")
                splits[d] = splits.get(d, 1) * split
    return _ds_from_splits(device_num, splits)


def _spec_pairs(pspec) -> set:
    """{(dim, axis)} placements of a PartitionSpec (None -> empty)."""
    pairs = set()
    if pspec is None:
        return pairs
    for d, entry in enumerate(pspec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                pairs.add((d, str(a)))
    return pairs


def deduce_pspec_transition(src_spec, src_shape: Sequence[int],
                            dst_spec, dst_shape: Sequence[int],
                            mesh_axes: Dict[str, int]) -> str:
    """Collective kind implied by a producer -> consumer pspec edge.

    Same-shape edges are pure layout transitions: lower both specs to DS
    and run the reference deduction (:func:`deduce_comm_kind`).  When the
    op between the two annotations changes the shape (a matmul, an
    einsum dispatch, an embedding lookup) there is no dim correspondence,
    so the edge is classified by how the mesh-axis placements moved:

    * axes *lost* entirely (sharded input contracted away) — the result
      is partial over those axes: ``all_reduce``;
    * axes *gained* (a sharded weight splits the output) — a local
      slice: ``scatter`` (no forward comm; its autodiff dual is not);
    * placements *moved* or mixed — a generic ``reshard`` (GSPMD lowers
      these to all-to-all / all-gather / collective-permute chains).
    """
    src_pairs, dst_pairs = _spec_pairs(src_spec), _spec_pairs(dst_spec)
    live = {a for a, s in mesh_axes.items() if int(s) > 1}
    src_pairs = {(d, a) for d, a in src_pairs if a in live}
    dst_pairs = {(d, a) for d, a in dst_pairs if a in live}
    if src_pairs == dst_pairs:
        return "identity"
    if tuple(src_shape) == tuple(dst_shape):
        # project onto the CHANGED mesh axes only: axes that keep their
        # dim placement are spectators (their device subgroups never
        # communicate), and the DS predicates are all-or-nothing over
        # the device group, so the deduction runs on the subgroup the
        # transition actually moves data across.
        moved = {a for _d, a in src_pairs ^ dst_pairs}
        n_sub = 1
        for a in moved:
            n_sub *= int(mesh_axes[a])

        def _sub_ds(pairs):
            splits: Dict[int, int] = {}
            for d, a in pairs:
                if a in moved:
                    splits[d] = splits.get(d, 1) * int(mesh_axes[a])
            return _ds_from_splits(n_sub, splits)

        try:
            return deduce_comm_kind(_sub_ds(src_pairs),
                                    _sub_ds(dst_pairs))
        except ValueError:
            pass
    src_axes = {a for _, a in src_pairs}
    dst_axes = {a for _, a in dst_pairs}
    lost = src_axes - dst_axes
    gained = dst_axes - src_axes
    if lost and not gained:
        return "all_reduce"    # contraction over the sharded dim: partial
    if gained and not lost:
        return "scatter"       # sharded weight slices the output locally
    return "reshard"


# -- coalesced gradient-comm predictions -------------------------------------
#
# The comm-op deduction above predicts WHICH collective converts one DS into
# another; the functions below extend the prediction to the coalesced
# gradient-sync layer (comm.py all_reduce_coalesced): given the gradient
# set and transport they enumerate the exact collective sequence one sync
# issues, which the port's tests hold against the records of
# `comm.comm_stats()`.


def predict_grad_comm_collectives(entries, device_num: int,
                                  bucket_mb: float = 4.0,
                                  transport: str = "fp32",
                                  block: Optional[int] = None) -> List[dict]:
    """Predict the collectives one coalesced gradient sync emits.

    ``entries``: [(key, shape, dtype)] of the gradient set, in sync
    order.  Returns one dict per collective: {kind, payload_bytes,
    wire_bytes, dtype} — fp32 emits one all_reduce per bucket; bf16 one
    all_to_all + one all_gather per bucket; int8 adds the fp32 absmax
    sidecar exchange (2 all_to_all + 2 all_gather per bucket).
    """
    from .comm import (INT8_BLOCK, plan_buckets, quantized_chunk,
                       ring_wire_bytes)
    block = block or INT8_BLOCK
    n = device_num
    preds: List[dict] = []

    def _emit(kind, payload, dtype):
        preds.append({"kind": kind, "payload_bytes": int(payload),
                      "wire_bytes": ring_wire_bytes(kind, payload, n),
                      "dtype": dtype})

    for b in plan_buckets(entries, bucket_mb):
        numel = sum(b.numels)
        if transport == "fp32":
            _emit("all_reduce", b.nbytes, b.dtype)
            continue
        chunk = quantized_chunk(numel, n, block)
        if transport == "bf16":
            _emit("all_to_all", n * chunk * 2, "bfloat16")
            _emit("all_gather", n * chunk * 2, "bfloat16")
        elif transport == "int8":
            _emit("all_to_all", n * chunk, "int8")
            _emit("all_to_all", n * (chunk // block) * 4, "float32")
            _emit("all_gather", n * chunk, "int8")
            _emit("all_gather", n * (chunk // block) * 4, "float32")
        else:
            raise ValueError(f"unknown transport {transport!r}")
    return preds


def predict_flat_update_collectives(entries, device_num: int,
                                    bucket_mb: float = 4.0,
                                    transport: str = "fp32",
                                    block: Optional[int] = None,
                                    zero: int = 2) -> List[dict]:
    """Predict the collectives of one reduce-scatter-only flat sync
    (flat dp-sharded optimizer state, ``Optimizer(flat_state=True)``).

    ``zero <= 2`` (params replicated at rest): per bucket, ONE
    reduce-scatter chain carrying the gradients (fp32: a single
    ``psum_scatter``; bf16/int8: the phase-1 quantized exchange only —
    the phase-2 regather of the all-reduce path is gone) plus ONE
    all-gather of the UPDATED parameters riding the bucket's WEIGHT
    dtype (tag ``param_comm``).  Zero gradient all-gathers, ever —
    exactly half the gradient wire bytes of the all-reduce path at the
    same transport.

    ``zero >= 3`` (params sharded at rest): the per-bucket all-gather
    moves to the FRONT of the step — the just-in-time ``param_gather``
    that materializes the working weights from the flat fp32 master
    before the forward — and the post-update gather disappears (only
    the 1/dp shard stays resident).  Same collective kinds, counts and
    wire bytes as ``zero=2``; only the tag/position differ.
    """
    from .comm import (INT8_BLOCK, plan_buckets, quantized_chunk,
                       ring_wire_bytes)
    block = block or INT8_BLOCK
    n = device_num
    preds: List[dict] = []

    def _emit(kind, payload, dtype, tag=None):
        p = {"kind": kind, "payload_bytes": int(payload),
             "wire_bytes": ring_wire_bytes(kind, payload, n),
             "dtype": dtype}
        if tag is not None:
            p["tag"] = tag
        preds.append(p)

    for b in plan_buckets(entries, bucket_mb):
        numel = sum(b.numels)
        chunk = quantized_chunk(numel, n, block)
        itemsize = np.dtype(b.dtype).itemsize
        if zero >= 3:
            # just-in-time weight gather from the flat master, before
            # any gradient exchange this step
            _emit("all_gather", n * chunk * itemsize, b.dtype,
                  tag="param_gather")
        if transport == "fp32":
            _emit("reduce_scatter", n * chunk * 4, "float32")
        elif transport == "bf16":
            _emit("all_to_all", n * chunk * 2, "bfloat16")
        elif transport == "int8":
            _emit("all_to_all", n * chunk, "int8")
            _emit("all_to_all", n * (chunk // block) * 4, "float32")
        else:
            raise ValueError(f"unknown transport {transport!r}")
        if zero < 3:
            # updated-param gather in the weight dtype (tag param_comm)
            _emit("all_gather", n * chunk * itemsize, b.dtype,
                  tag="param_comm")
    return preds


def predict_update_step_collectives(entries, device_num: int,
                                    transport: str = "fp32",
                                    bucket_mb: float = 4.0,
                                    block: Optional[int] = None,
                                    scalar_fetches: int = 1,
                                    flat: bool = False,
                                    clip: bool = False,
                                    zero: int = 2,
                                    opt_extra: Optional[Dict[str, int]]
                                    = None):
    """Step-level prediction for an explicit-grad-comm training
    executable: the coalesced gradient-sync collectives
    (:func:`predict_grad_comm_collectives`, or
    :func:`predict_flat_update_collectives` when ``flat`` — the
    reduce-scatter-only ZeRO-2/3 path, ``zero`` selecting whether the
    per-bucket weight gather is the post-update ``param_comm`` or the
    just-in-time ``param_gather`` of params-sharded-at-rest) plus one
    all_reduce (the scalar pmean) per scalar fetch, plus the
    global-norm-clip psum when the flat path clips (``clip``; the
    all-reduce path clips on full local grads with no collective).
    Returns ``(prediction, extra)``: the bucket chains and the count of
    further collectives by kind."""
    if flat:
        preds = predict_flat_update_collectives(
            entries, device_num, bucket_mb=bucket_mb,
            transport=transport, block=block, zero=zero)
    else:
        preds = predict_grad_comm_collectives(
            entries, device_num, bucket_mb=bucket_mb,
            transport=transport, block=block)
    n_ar = int(scalar_fetches) + (1 if (flat and clip) else 0)
    extra = {"all_reduce": n_ar} if n_ar else {}
    # optimizer-declared in-region collectives beyond the grad/param
    # chains (e.g. Adafactor's factored-stat psums)
    for k, v in (opt_extra or {}).items():
        extra[k] = extra.get(k, 0) + int(v)
    return preds, extra


class SplitPattern:
    """Contiguous vs. non-contiguous split (distributed_states.h:139)."""

    def __init__(self, contiguous: bool = True):
        self._contiguous = bool(contiguous)

    @property
    def is_contiguous(self) -> bool:
        return self._contiguous

    def check_equal(self, other: "SplitPattern") -> bool:
        return self._contiguous == other._contiguous

    def __repr__(self) -> str:
        return f"SplitPattern({'contig' if self._contiguous else 'noncontig'})"


class DistributedStatesUnion:
    """Per-pipeline list of DS for heterogeneous strategies.

    ``hetero_dim`` is the tensor dim along which the union members differ
    (-3/NULL when homogeneous); mirrors ``distributed_states.h:157-240``.
    """

    def __init__(self, ds_list: Sequence[DistributedStates],
                 hetero_dim: int = NULL_HETERO_DIM,
                 split_pattern: Optional[SplitPattern] = None):
        self._ds_list = list(ds_list)
        self._hetero_dim = hetero_dim
        self._split_pattern = split_pattern or SplitPattern(True)

    @property
    def ds_list(self) -> List[DistributedStates]:
        return list(self._ds_list)

    @property
    def hetero_dim(self) -> int:
        return self._hetero_dim

    @property
    def split_pattern(self) -> SplitPattern:
        return self._split_pattern

    def is_hetero(self) -> bool:
        return self._hetero_dim != NULL_HETERO_DIM

    def size(self) -> int:
        return len(self._ds_list)

    def get(self, i: int) -> DistributedStates:
        return self._ds_list[i]

    def get_default_ds(self) -> DistributedStates:
        if not self._ds_list:
            raise ValueError("empty DS union")
        return self._ds_list[0]

    def check_equal(self, other: "DistributedStatesUnion") -> bool:
        return (self._hetero_dim == other._hetero_dim
                and len(self._ds_list) == len(other._ds_list)
                and all(a.check_equal(b)
                        for a, b in zip(self._ds_list, other._ds_list)))

    def __repr__(self) -> str:
        h = f", hetero_dim={self._hetero_dim}" if self.is_hetero() else ""
        return f"DSUnion({self._ds_list!r}{h})"


class DistributedStatesHierarchy:
    """Per-strategy list of DS unions (``tensor.h:255`` ds_hierarchy)."""

    def __init__(self, unions: Sequence[DistributedStatesUnion] = ()):
        self._unions = list(unions)

    def add(self, union: DistributedStatesUnion) -> None:
        self._unions.append(union)

    def get(self, strategy_id: int) -> DistributedStatesUnion:
        return self._unions[strategy_id]

    def size(self) -> int:
        return len(self._unions)

    def __repr__(self) -> str:
        return f"DSHierarchy({self._unions!r})"
