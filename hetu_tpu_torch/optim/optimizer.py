"""Optimizers (counterpart of ``hetu_tpu.optim.optimizer``).

``minimize(loss)`` records an update node; ``DefineAndRunGraph.run``
executes it after the micro-batch loop with the 1/M-normalised
gradients, updating the parameters in place (the JAX package returns
new arrays; the update math is the same).  ``max_grad_norm`` clips by the
global fp32 norm first.

- ``SGDOptimizer``: plain, momentum or Nesterov; the velocity keeps the
  parameter's dtype and the update is taken in fp32 and cast back.
- ``AdamOptimizer`` / ``AdamWOptimizer``: fp32 moments, bias correction,
  the update in fp32 cast to the parameter's dtype; Adam adds an L2
  weight decay to the gradient, AdamW a decoupled one.
- ``AdafactorOptimizer``: optax's ``adafactor`` chain, which the JAX
  package delegates to, re-implemented in torch on the per-parameter
  path: factored second moments (row/col EMAs of the squared gradient for
  parameters with two dims of at least ``min_dim_size_to_factor``), the
  block-RMS clip, the lr, the parameter-scale factor, momentum, weight
  decay and the sign.

The whole update runs on the device, the step counts included (tensors
that the update increments in place), so a captured training step
replays it right every time: a scheduled ``lr`` (``optim.schedules``) is
computed from the step tensor on the device, 1-based as in the JAX
package.  A ``GradScaler`` passes ``keep``, a device bool: the update is
computed and then selected against the old values (``torch.where``), so a
step with a non-finite gradient leaves parameters, moments and step
counts bitwise unchanged without a host branch.

Checkpoints carry the JAX package's state keys: ``checkpoint_state`` and
``load_checkpoint_state`` map between them and this optimizer's tensors
(``opt.step`` int32 for Adam's fp32 step count, no ``opt.betas``;
Adafactor's optax leaves by index, ``opt.optax@@leafNNNN``, in the order
of optax's state tree).  On a mesh they hold global values (every rank
calls them).

On a graph with a mesh whose ``dp_axis`` has more than one rank, the
update syncs the gradients over dp, a mean (the loss's own dp sum is
scaled to match, ``nn.parallel``):

- ``zero=0``: coalesced all-reduce in size-capped buckets
  (``comm.all_reduce_coalesced``, tag ``grad_sync``), over the transport
  ``grad_comm`` names (``None`` is ``"fp32"``: one all-reduce a bucket,
  elementwise the same as one a tensor).
- ``zero=1``: the same sync; the states hold the rank's dim-0 chunk of
  each parameter whose dim 0 is free of other axes and divisible by dp
  (the JAX package's rule); the rank updates that chunk and the
  parameter is all-gathered over dp (tag ``param_comm``).
- ``zero=2``: those parameters' gradients are reduce-scattered instead.
- ``zero=3``: those parameters are stored dp-sharded at rest
  (``Graph.store_sharded``) and gathered at each use by an all-gather
  whose backward reduce-scatters; nothing is gathered after the update.
- ``flat_state=True`` (with ``grad_comm`` and ``zero`` 1-3, no parameter
  split by a mesh axis): the fp32 master and the moments live in flat per-bucket
  buffers of the coalesced reduce-scatter's geometry
  (``optim.flat_state``): a reduce-scatter chain a bucket, the local
  chunk's update, and a gather of the updated parameters in their dtype
  (``param_comm``), or under ZeRO-3 a gather of the working parameters
  from the master before the step (``param_gather``).

On a graph whose data is also split over a sequence axis (context
parallelism, ``Graph.seq_axes``) each rank holds its tokens' part of
every parameter's gradient: after the dp sync, the piece the rank
updates (the whole gradient, or its dp chunk under ZeRO) is summed over
that axis (coalesced all-reduces in the gradients' dtype, tag
``grad_sync``), so that cp
carries 1/dp of each chunked gradient under ZeRO.  ZeRO still
chunks over dp alone, and the clip counts every parameter once (nothing
is split over cp).

``max_grad_norm`` clips by the global norm: each piece's squares summed
over the axes it is split over (tp for a tp-sharded parameter, dp for a
chunk), so that every parameter counts once.  Adafactor's factored
statistics are not sharded: under ZeRO it syncs the whole gradient and
updates whole parameters, and it refuses ``flat_state`` (ROADMAP queue
1 item 10b).

``sentry=`` (``True``, a ``SentryConfig`` or a ``NumericSentry``,
``resilience.sentry``) checks every UPDATE step on the device: it reads
the same fp32 pre-clip global sum of squares the clip reads (computed
when either is on) and the dp-reduced loss, and its ``ok`` is ANDed into
``keep``, so an anomalous step leaves parameters, moments, flat buffers,
Adafactor's statistics, SGD's velocity and the step counter bitwise
unchanged.  Its state lives on the sentry, beside the optimizer's.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graph.graph import OpNode, get_default_graph
from ..graph.tensor import Tensor


class Optimizer:
    def __init__(self, params: Optional[Sequence[Tensor]] = None,
                 lr=0.01, zero: int = 0, dp_axis: str = "dp",
                 max_grad_norm: Optional[float] = None,
                 grad_comm: Optional[str] = None, bucket_mb: float = 4.0,
                 flat_state: bool = False, sentry=None):
        # a float, or a schedule step -> lr (optim.schedules)
        self.lr = lr if callable(lr) or lr is None else float(lr)
        self.params = list(params) if params is not None else None
        self.zero = int(zero)
        if not 0 <= self.zero <= 3:
            raise ValueError(f"zero level must be 0..3, got {zero}")
        from ..parallel.comm import GRAD_COMM_TRANSPORTS
        if grad_comm is not None and grad_comm not in GRAD_COMM_TRANSPORTS:
            raise ValueError(f"grad_comm must be None or one of "
                             f"{GRAD_COMM_TRANSPORTS}, got {grad_comm!r}")
        self.grad_comm = grad_comm
        self.bucket_mb = float(bucket_mb)
        if self.bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be > 0, got {bucket_mb}")
        self.flat_state = bool(flat_state)
        if self.flat_state:
            if grad_comm is None:
                raise ValueError(
                    "flat_state=True needs the explicit grad-comm path: "
                    "pass grad_comm='fp32'|'bf16'|'int8'")
            if self.zero not in (1, 2, 3):
                raise ValueError(
                    f"flat_state=True needs dp-sharded state (ZeRO 1/2) or "
                    f"fully sharded params (ZeRO 3); got zero={self.zero}")
        self._flat = None          # the FlatStateLayout in use
        # numeric sentry (resilience/sentry.py): True, a SentryConfig or a
        # NumericSentry; its verdict is ANDed into the update's ``keep``
        from ..resilience.sentry import as_sentry
        self.sentry = as_sentry(sentry)
        self.dp_axis = dp_axis
        self.max_grad_norm = max_grad_norm
        self._state: Dict[str, Any] = {}

    def minimize(self, loss: Tensor,
                 var_list: Optional[Sequence[Tensor]] = None,
                 grad_scaler=None) -> Tensor:
        """The update op for ``loss``: fetch it in ``run`` to train.  With
        ``grad_scaler`` (``graph.amp.GradScaler``) the loss is scaled, the
        gradients unscaled, and a step whose gradients are not finite
        is skipped on the device."""
        g = loss.graph or get_default_graph()
        xs = list(var_list or self.params or g.trainable_variables)
        if not xs:
            raise ValueError("no trainable variables to optimize")
        self._graph = g
        if self.flat_state and self.zero >= 3:
            g._materializers.append(self.materialize_flat_params)
        if self.zero >= 3 and not self.flat_state and self._shards_state:
            for t in xs:
                if self._chunked(g, t):
                    g.store_sharded(t, self.dp_axis)
        grads = g.make_gradients(loss, xs)
        node = OpNode("update", None, grads,
                      {"optimizer": self, "grad_node": grads[0].producer,
                       "xs": xs, "grad_scaler": grad_scaler},
                      f"update_{loss.name}")
        t = Tensor((), "float32", producer=node, name=node.name, graph=g)
        node.outputs = [t]
        g.ops.append(node)
        return t

    def _lr_at(self, step: torch.Tensor):
        """The lr of the step being applied: the float, or the schedule
        at ``step`` (1-based, a device tensor)."""
        return self.lr(step) if callable(self.lr) else self.lr

    @staticmethod
    def _commit(dst: torch.Tensor, new: torch.Tensor,
                keep: Optional[torch.Tensor]) -> None:
        """``dst = new``, or with ``keep`` (a device bool) ``dst = keep ?
        new : dst``: a skipped step leaves ``dst`` bitwise unchanged.
        ``new`` may be ``dst`` itself, updated in place (no ``keep``)."""
        if new is dst:
            return
        new = new.to(dst.dtype)
        dst.copy_(new if keep is None else torch.where(keep, new, dst))

    # -- the data-parallel sync (ZeRO) ----------------------------------------

    # whether ZeRO shards this optimizer's state (Adafactor's factored
    # statistics are not sharded)
    _shards_state = True

    def _dp(self, graph) -> int:
        mesh = getattr(graph, "mesh", None)
        return mesh.axis_size(self.dp_axis) if mesh is not None else 1

    def _chunked(self, graph, t: Tensor) -> bool:
        """Whether ZeRO splits ``t`` over dp along dim 0: the JAX
        package's rule (dim 0 free of other axes, divisible by dp)."""
        from ..parallel.mesh import entry_axes, spec_axes
        dp = self._dp(graph)
        if dp == 1 or not t.shape:
            return False
        mesh = graph.mesh
        spec = t.pspec or ()
        if self.dp_axis in spec_axes(spec):
            return False
        if spec and any(mesh.axis_size(a) > 1 for a in entry_axes(spec[0])):
            return False
        return int(t.shape[0]) % dp == 0

    def _split_axes(self, graph, t: Tensor) -> frozenset:
        from ..parallel.mesh import spec_axes
        mesh = graph.mesh
        if mesh is None:
            return frozenset()
        return frozenset(a for a in spec_axes(t.pspec)
                         if mesh.axis_size(a) > 1)

    def _sync(self, graph, xs: Sequence[Tensor], grads: List[torch.Tensor]):
        """The gradients synced over dp and then over the sequence axes,
        as the pieces this rank updates: ``(tensor, parameter or its dim-0
        chunk, gradient, axes the piece is split over, gathered after the
        update)``."""
        from ..parallel import comm
        dp = self._dp(graph)
        if dp == 1:
            grads = self._sum_over_seq(graph, grads)
            return [(t, graph._var_data[t.id], g, self._split_axes(graph, t),
                     False) for t, g in zip(xs, grads)]
        mesh, axis = graph.mesh, self.dp_axis
        zero = self.zero if self._shards_state else 0
        stored = graph._storage_axis
        chunked = [t.id not in stored and zero >= 1 and
                   self._chunked(graph, t) for t in xs]
        scatter = [c and zero >= 2 for c in chunked]
        out = list(grads)
        with comm.comm_tag("grad_sync"):
            idx = [i for i, t in enumerate(xs)
                   if t.id not in stored and not scatter[i]]
            if idx:
                red = comm.all_reduce_coalesced(
                    [grads[i] for i in idx], axis, op="mean",
                    bucket_mb=self.bucket_mb,
                    transport=self.grad_comm or "fp32", mesh=mesh)
                for i, r in zip(idx, red):
                    out[i] = r
            for i in range(len(xs)):
                if scatter[i]:
                    out[i] = comm.reduce_scatter(grads[i], axis, 0, "mean",
                                                 mesh)
        k = mesh.axis_index(axis)
        pieces = []
        for i, (t, g) in enumerate(zip(xs, out)):
            p = graph._var_data[t.id]
            axes = self._split_axes(graph, t)
            if t.id in stored:
                pieces.append((t, p, g, axes | {axis}, False))
            elif chunked[i]:
                if not scatter[i]:
                    g = g.chunk(dp, 0)[k]
                pieces.append((t, p.chunk(dp, 0)[k], g, axes | {axis}, True))
            else:
                pieces.append((t, p, g, axes, False))
        summed = self._sum_over_seq(graph, [g for _, _, g, _, _ in pieces])
        return [(t, p, g, axes, gather) for (t, p, _, axes, gather), g
                in zip(pieces, summed)]

    def _sum_over_seq(self, graph, grads: List[torch.Tensor]
                      ) -> List[torch.Tensor]:
        """The rank's gradient pieces summed over the axes the sequence
        is split over (coalesced all-reduces in their dtype, tag
        ``grad_sync``)."""
        from ..parallel import comm
        mesh = graph.mesh
        for axis in sorted(graph.seq_axes):
            if mesh is None or mesh.axis_size(axis) == 1:
                continue
            with comm.comm_tag("grad_sync"):
                grads = comm.all_reduce_coalesced(
                    list(grads), axis, op="sum", bucket_mb=self.bucket_mb,
                    mesh=mesh)
        return list(grads)

    def _regather(self, graph, pieces) -> None:
        """ZeRO-1/2: every rank's updated chunk back into the parameter."""
        from ..parallel import comm
        with comm.comm_tag("param_comm"):
            for t, view, _, _, gather in pieces:
                if gather:
                    graph._var_data[t.id].copy_(comm.all_gather(
                        view.contiguous(), self.dp_axis, 0, graph.mesh))

    def _grad_sq(self, graph, pieces) -> torch.Tensor:
        """The fp32 global sum of squared gradients that the clip and the
        sentry read: each piece's squares summed over the axes it is split
        over, so that every parameter counts once."""
        from ..parallel import comm
        sums: Dict[frozenset, Any] = {}
        for t, _, g, axes, _ in pieces:
            sums[axes] = sums.get(axes, 0) + self._square_sum(graph, t, g)
        total = 0
        with comm.comm_tag("clip"):
            for axes in sorted(sums, key=sorted):
                v = sums[axes]
                for a in sorted(axes):
                    v = comm.all_reduce(v, a, "sum", graph.mesh)
                total = total + v
        return total

    def _clip(self, pieces, sq):
        """Global-norm clip (fp32 norm) by the sum of squares ``sq``."""
        if self.max_grad_norm is None:
            return pieces
        scale = torch.clamp(self.max_grad_norm / (torch.sqrt(sq) + 1e-6),
                            max=1.0)
        return [(t, p, (g.float() * scale).to(g.dtype), axes, gather)
                for t, p, g, axes, gather in pieces]

    @staticmethod
    def _checked(keep, check, sq):
        """``keep`` ANDed with the sentry's verdict on ``sq``."""
        if check is None:
            return keep
        ok = check(sq)
        return ok if keep is None else keep & ok

    @staticmethod
    def _square_sum(graph, t: Tensor, g: torch.Tensor):
        """The fp32 sum of squares of the rank's gradient piece, a block
        that repeats over the ranks of its axis (GQA's kv heads under a tp
        above their count) divided by its repeats, so that it counts
        once when the sums are reduced over the axis."""
        from ..parallel.mesh import _block_split, dim_split
        sq = torch.square(g.float())
        units = t.shard_units
        if not units or graph.mesh is None:
            return torch.sum(sq)
        bd = t.shard_blocks_dim
        n, i = dim_split((t.pspec or ())[bd] if len(t.pspec or ()) > bd
                         else None, graph.mesh)
        if not any(0 < u < n for u in units):
            return torch.sum(sq)
        total, off = 0, 0
        for b, u in zip(t.shard_blocks, units):
            w, _ = _block_split(b, n, i, u)
            part = torch.sum(sq.narrow(bd, off, w))
            total = total + (part / (n // u) if 0 < u < n else part)
            off += w
        return total

    def dp_local_tokens(self, graph, fetches: Sequence[Tensor],
                        loss: Optional[Tensor], scaler=None) -> bool:
        """Whether this optimizer's step runs the model on each rank's own
        tokens, as the JAX package's explicit grad-comm region does: a
        layer that routes over the batch (MoE's gates) then routes the
        rank's tokens alone.  The region's conditions are the JAX graph's
        (``_plan_explicit_grad_comm``): ``grad_comm`` set, no active loss
        scaler, a mesh of the dp axis alone of more than one rank, ZeRO
        below 3 or the flat layout, no variable split over dp, a loss that
        is not a top-level ``reduce_sum``, no scalar fetch but the loss and
        every other fetch split over dp.  Elsewhere the gate routes the
        global batch, as the JAX package's GSPMD step does."""
        mesh = getattr(graph, "mesh", None)
        dpa = self.dp_axis

        def refs_dp(spec) -> bool:
            return any(dpa in (e if isinstance(e, tuple) else (e,))
                       for e in (spec or ()) if e is not None)

        if getattr(self, "grad_comm", None) is None or scaler is not None \
                or mesh is None or tuple(mesh.axis_names) != (dpa,) or \
                mesh.axis_size(dpa) <= 1 or \
                (self.zero >= 3 and not getattr(self, "flat_state", False)):
            return False
        if any(refs_dp(t.pspec) for t in graph._var_tensors.values()):
            return False
        if loss is not None and loss.producer is not None and \
                loss.producer.op_type == "reduce_sum":
            return False
        for t in fetches:
            if len(t.shape) == 0:
                if loss is not None and t.id != loss.id:
                    return False
            elif not refs_dp(t.pspec):
                return False
        return True

    @torch.no_grad()
    def _apply_updates(self, graph, xs: Sequence[Tensor],
                       grads: List[torch.Tensor],
                       keep: Optional[torch.Tensor] = None,
                       check=None) -> None:
        """Sync over dp and the sequence axes, clip, update the rank's
        pieces, regather.  ``check`` (the sentry's verdict: the global
        sum of squares -> a device bool) is ANDed into ``keep``."""
        if self.flat_state and self._dp(graph) > 1:
            return self._flat_apply(graph, xs, grads, keep, check)
        pieces = self._sync(graph, xs, grads)
        sq = self._grad_sq(graph, pieces) \
            if self.max_grad_norm is not None or check is not None else None
        keep = self._checked(keep, check, sq)
        pieces = self._clip(pieces, sq)
        self._update(graph, [(t, p, g) for t, p, g, _, _ in pieces], keep)
        self._regather(graph, pieces)

    def _update(self, graph, pieces, keep: Optional[torch.Tensor]) -> None:
        """The update of ``(tensor, parameter piece, gradient)`` pieces,
        state keyed by tensor id and shaped as the piece."""
        raise NotImplementedError

    def _before_step(self, graph, xs: Sequence[Tensor]) -> None:
        """Runs before a step's forward: flat ZeRO-3 gathers the working
        parameters from the fp32 master chunks."""
        if self.flat_state and self.zero >= 3 and self._dp(graph) > 1:
            self._flat_init(graph, xs)
            self.materialize_flat_params(graph)

    def materialize_flat_params(self, graph) -> None:
        """Flat ZeRO-3: the working parameters gathered from the master
        chunks when an update has made them stale (``Graph.global_value``
        calls it before reading; every rank calls it)."""
        if not getattr(self, "_params_stale", True) or \
                "flat_master" not in self._state:
            return
        from ..parallel import comm
        full = comm.all_gather_coalesced(
            self._state["flat_master"], self._flat.comm_layout(),
            self.dp_axis, tag="param_gather", mesh=graph.mesh)
        with torch.no_grad():
            for tid, v in full.items():
                graph._var_data[tid].copy_(v)
        self._params_stale = False

    # -- flat dp-sharded state -----------------------------------------------

    def _flat_slots(self) -> Sequence[str]:
        raise NotImplementedError(
            f"{type(self).__name__} does not take flat_state=True (ROADMAP "
            f"queue 1 item 10b)")

    def _flat_update(self, p, slots, g, step, lr):
        """Elementwise update of fp32 chunks: (master, {slot: chunk},
        gradient, step, lr) -> (new master, {slot: new chunk})."""
        raise NotImplementedError

    def _flat_init(self, graph, xs):
        """The flat layout, and the master and slot chunks of this rank
        (from the parameters, or a checkpoint's per-parameter state)."""
        from .flat_state import FlatStateLayout, sync_order
        mesh = graph.mesh
        split = [t.name for t in xs if self._split_axes(graph, t)]
        if split:
            raise ValueError(f"flat_state needs parameters that no mesh "
                             f"axis splits (the JAX package's pure-dp "
                             f"rule); split: {split[:3]}")
        dp, k = mesh.axis_size(self.dp_axis), mesh.axis_index(self.dp_axis)
        if self._flat is None:
            self._flat = FlatStateLayout(
                [(t.id, tuple(graph._var_data[t.id].shape),
                  graph._var_data[t.id].dtype) for t in sync_order(xs)],
                dp, self.bucket_mb)
        lay, st = self._flat, self._state
        if "flat_master" not in st:
            dev = graph.device
            pending = st.pop("pending", {})
            # the checkpoint's fp32 master where it has one, else the
            # parameters
            master = pending.get("master", {})
            vals = {t.id: master.get(t.id, graph._var_data[t.id])
                    for t in xs}
            st["flat_master"] = [f.chunk(dp)[k].clone()
                                 for f in lay.pack(vals)]
            for slot in self._flat_slots():
                given = pending.get(slot, {})
                full = {t.id: given.get(t.id, torch.zeros(
                    graph._var_data[t.id].shape, device=dev)) for t in xs}
                st[f"flat_{slot}"] = [f.chunk(dp)[k].clone()
                                      for f in lay.pack(full)]
            st.setdefault("step", self._zeros_step(dev))
            for key, val in self._fixed_state(dev).items():
                st.setdefault(key, val)
        return lay

    def _flat_apply(self, graph, xs, grads, keep, check=None) -> None:
        """The reduce-scatter-only sync: a reduce-scatter chain a bucket
        (its chunk then summed over the sequence axes), the local chunk's
        update, and (ZeRO-1/2) the updated parameters
        gathered in their dtype."""
        from ..parallel import comm
        from .flat_state import sync_order
        lay = self._flat_init(graph, xs)
        mesh, axis, st = graph.mesh, self.dp_axis, self._state
        gmap = {t.id: g for t, g in zip(xs, grads)}
        chunks, clay = comm.reduce_scatter_coalesced(
            {t.id: gmap[t.id] for t in sync_order(xs)}, axis, op="mean",
            bucket_mb=self.bucket_mb, transport=self.grad_comm, mesh=mesh)
        chunks = self._sum_over_seq(graph, chunks)
        if self.max_grad_norm is not None or check is not None:
            # the global sum of squares over the scattered chunks (padding
            # lanes add exact zeros), before the clip: clip and sentry
            sq = sum(torch.sum(torch.square(c)) for c in chunks)
            with comm.comm_tag("clip"):
                sq = comm.all_reduce(sq, axis, "sum", mesh)
            keep = self._checked(keep, check, sq)
        if self.max_grad_norm is not None:
            scale = torch.clamp(self.max_grad_norm / (torch.sqrt(sq) + 1e-6),
                                max=1.0)
            chunks = [c * scale for c in chunks]
        step = st["step"] + 1.0
        lr = self._lr_at(step)
        slots = self._flat_slots()
        for bi, g in enumerate(chunks):
            master = st["flat_master"][bi]
            new_p, new_slots = self._flat_update(
                master, {s_: st[f"flat_{s_}"][bi] for s_ in slots}, g, step,
                lr)
            for s_ in slots:
                self._commit(st[f"flat_{s_}"][bi], new_slots[s_], keep)
            self._commit(master, new_p, keep)
        self._commit(st["step"], step, keep)
        if self.zero < 3:
            full = comm.all_gather_coalesced(st["flat_master"], clay, axis,
                                             tag="param_comm", mesh=mesh)
            for tid, v in full.items():
                graph._var_data[tid].copy_(v)
        else:
            self._params_stale = True

    def _zeros_step(self, device) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=device)

    def state_dict(self) -> Dict[str, Any]:
        """A copy of the optimizer's state: its tensors (the step count,
        per-variable moments keyed by variable id) cloned."""
        def copy(v):
            if isinstance(v, dict):
                return {k: copy(x) for k, x in v.items()}
            return v.clone() if isinstance(v, torch.Tensor) else v
        return copy(self._state)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Resume from :meth:`state_dict`.  Values are copied into the
        tensors this optimizer already holds, so a captured step keeps
        reading them; new entries are taken as clones."""
        def load(dst, src):
            for k, v in src.items():
                cur = dst.get(k)
                if isinstance(v, dict):
                    load(dst.setdefault(k, {}), v)
                elif isinstance(cur, torch.Tensor) and \
                        cur.shape == v.shape and cur.dtype == v.dtype:
                    cur.copy_(v)
                else:
                    dst[k] = v.clone() if isinstance(v, torch.Tensor) else v
        with torch.no_grad():
            load(self._state, state)

    # -- checkpoints (the JAX package's keys) -------------------------------

    # per-parameter state slots and their dtype (None: the parameter's)
    _SLOTS: Dict[str, Optional[torch.dtype]] = {}

    def _piece_chunked(self, graph, t: Tensor) -> bool:
        """Whether ``t``'s state holds the rank's dp chunk (ZeRO >= 1)."""
        return self.zero >= 1 and self._shards_state and \
            self._chunked(graph, t)

    def _mesh_graph(self):
        g = getattr(self, "_graph", None)
        mesh = getattr(g, "mesh", None)
        return g if mesh is not None and mesh.size > 1 else None

    def checkpoint_state(self, tid_to_name: Dict[int, str]
                         ) -> Dict[str, torch.Tensor]:
        """The state under the JAX package's checkpoint keys (without the
        ``opt.`` prefix): ``step`` as int32, ``<slot>.<param name>``.  On a
        mesh the values are global (gathered: every rank calls it)."""
        st = self._state
        if not st:
            return {}
        out = {"step": st["step"].to(torch.int32)}
        g = self._mesh_graph()
        if g is not None and "flat_master" in st:
            # per parameter, so the state loads at any dp size; the fp32
            # master rides as ``master.<param>``, as in the JAX package
            from ..parallel import comm
            for slot in ("master",) + tuple(self._flat_slots()):
                full = [comm.all_gather(c, self.dp_axis, 0, g.mesh)
                        for c in st[f"flat_{slot}"]]
                for tid, val in self._flat.unpack(full).items():
                    out[f"{slot}.{tid_to_name.get(tid, str(tid))}"] = val
            return out
        for slot in self._SLOTS:
            for tid, val in st.get(slot, {}).items():
                if g is not None:
                    t = g._var_tensors[tid]
                    val = g.gather_global(
                        t, val, self.dp_axis
                        if self._piece_chunked(g, t) else None)
                out[f"{slot}.{tid_to_name.get(tid, str(tid))}"] = val
        return out

    def load_checkpoint_state(self, entries: Dict[str, torch.Tensor],
                              name_to_param: Dict[str, Tensor],
                              device) -> None:
        """Loads ``entries`` (keys as :meth:`checkpoint_state` writes them)
        into this optimizer's tensors, in place where they exist."""
        state: Dict[str, Any] = {}
        g = self._mesh_graph()
        for key, val in entries.items():
            slot, _, pname = key.partition(".")
            if key == "step":
                state["step"] = val.to(device=device, dtype=torch.float32)
            elif pname in name_to_param and (
                    slot in self._SLOTS or
                    (slot == "master" and self.flat_state and g is not None)):
                p = name_to_param[pname]
                dt = torch.float32 if slot == "master" \
                    else self._SLOTS[slot] or p.dtype
                if g is not None:
                    val = self._state_piece(g, p, val)
                state.setdefault(slot, {})[p.id] = val.to(device=device,
                                                          dtype=dt)
        state.update(self._fixed_state(device))
        if self.flat_state and g is not None:
            # the flat buffers are packed again at the next step, from the
            # loaded parameters and these per-parameter slots
            for key in [k for k in self._state if k.startswith("flat_")]:
                del self._state[key]
            state["pending"] = {slot: state.pop(slot) for slot in
                                list(self._SLOTS) + ["master"]
                                if slot in state}
            self._state.pop("pending", None)
            g._storage_replaced()
        self.load_state_dict(state)

    def _state_piece(self, graph, t: Tensor, val: torch.Tensor):
        """The rank's part of a state's global value, laid out as the
        parameter's (and under ZeRO its dp chunk)."""
        from ..parallel.mesh import take_shard
        val = take_shard(val, t.pspec, graph.mesh, t.shard_blocks,
                         t.shard_blocks_dim, t.shard_units)
        if self._piece_chunked(graph, t) and not self.flat_state:
            mesh = graph.mesh
            val = val.chunk(mesh.axis_size(self.dp_axis), 0)[
                mesh.axis_index(self.dp_axis)]
        return val

    def _fixed_state(self, device) -> Dict[str, torch.Tensor]:
        """State tensors that hold hyper-parameters, not training
        progress (checkpoints leave them out)."""
        return {}


class SGDOptimizer(Optimizer):
    """SGD, with momentum and Nesterov (``torch.optim.SGD`` semantics)."""

    def __init__(self, params=None, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, **kw):
        super().__init__(params, lr, **kw)
        self.momentum = momentum
        self.nesterov = nesterov
        self._SLOTS = {"velocity": None} if momentum != 0.0 else {}

    def _flat_slots(self):
        return ("velocity",) if self.momentum != 0.0 else ()

    def _flat_update(self, p, slots, g, step, lr):
        if self.momentum == 0.0:
            return p - lr * g, {}
        v = self.momentum * slots["velocity"] + g
        upd = g + self.momentum * v if self.nesterov else v
        return p - lr * upd, {"velocity": v}

    def _update(self, graph, pieces, keep=None):
        st = self._state
        if "step" not in st:
            st["step"] = self._zeros_step(graph.device)
        step = st["step"] + 1.0
        lr = self._lr_at(step)
        for t, p, grad in pieces:
            g = grad.to(p.dtype)
            if self.momentum == 0.0:
                upd = g
            else:
                vel = st.setdefault("velocity", {})
                v = vel.get(t.id)
                if v is None:
                    v = vel[t.id] = torch.zeros_like(p)
                v_new = self.momentum * v + g
                upd = g + self.momentum * v_new if self.nesterov else v_new
                self._commit(v, v_new, keep)
            self._commit(p, p.float() - lr * upd.float(), keep)
        self._commit(st["step"], step, keep)


class AdamOptimizer(Optimizer):
    """Adam with fp32 moments (L2 weight decay on the gradient)."""

    decoupled_weight_decay = False     # True in AdamW
    _SLOTS = {"m": torch.float32, "v": torch.float32}

    def __init__(self, params=None, lr: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, **kw):
        super().__init__(params, lr, **kw)
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.weight_decay = weight_decay

    def _fixed_state(self, device):
        return {"betas": torch.tensor([self.beta1, self.beta2],
                                      dtype=torch.float32, device=device)}

    def _flat_slots(self):
        return ("m", "v")

    def _flat_update(self, p, slots, g, step, lr):
        # the per-piece math on fp32 chunks; padding lanes have g == 0 and
        # p == 0, so every term stays 0 there
        b1, b2, wd = self.beta1, self.beta2, self.weight_decay
        bc1, bc2 = 1.0 - self._state["betas"] ** step
        if wd and not self.decoupled_weight_decay:
            g = g + wd * p
        m = slots["m"] * b1 + g * (1 - b1)
        v = slots["v"] * b2 + (g * g) * (1 - b2)
        upd = (m / bc1).mul_(lr).div_((v / bc2).sqrt_().add_(self.eps))
        if wd and self.decoupled_weight_decay:
            upd.add_(p * (lr * wd))
        return p - upd, {"m": m, "v": v}

    def _update(self, graph, pieces, keep=None):
        st = self._state
        if "step" not in st:
            dev = graph.device
            st.update(step=self._zeros_step(dev), **self._fixed_state(dev))
        st.setdefault("m", {})
        st.setdefault("v", {})
        b1, b2, wd = self.beta1, self.beta2, self.weight_decay
        step = st["step"] + 1.0
        lr = self._lr_at(step)
        # bias corrections in fp32 on the device, from the step tensor
        bc1, bc2 = 1.0 - st["betas"] ** step
        for t, p, grad in pieces:
            m = st["m"].get(t.id)
            if m is None:
                m = st["m"][t.id] = torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device)
                st["v"][t.id] = torch.zeros_like(m)
            v = st["v"][t.id]
            g = grad.float()
            if wd and not self.decoupled_weight_decay:
                g = g + wd * p.float()
            # in place unless a skip may have to keep the old moments
            if keep is None:
                m_new = m.mul_(b1).add_(g * (1 - b1))
                v_new = v.mul_(b2).add_((g * g) * (1 - b2))
            else:
                m_new = m * b1 + g * (1 - b1)
                v_new = v * b2 + (g * g) * (1 - b2)
            upd = (m_new / bc1).mul_(lr).div_(
                (v_new / bc2).sqrt_().add_(self.eps))
            if wd and self.decoupled_weight_decay:
                upd.add_(p.float() * (lr * wd))
            self._commit(m, m_new, keep)
            self._commit(v, v_new, keep)
            self._commit(p, p.float() - upd, keep)
        self._commit(st["step"], step, keep)


class AdamWOptimizer(AdamOptimizer):
    """AdamW: decoupled weight decay (torch.optim.AdamW semantics)."""
    decoupled_weight_decay = True


class AdafactorOptimizer(Optimizer):
    """Adafactor (Shazeer & Stern 2018) with optax's defaults and
    semantics, on the per-parameter path (``flat_state`` is refused, and
    under ZeRO the state stays whole).  ``lr=None`` (the default) leaves the
    lr out of the chain, as optax does; a schedule sees the 1-based
    step.  On a mesh the factored dims come from the parameter's global
    shape, and every mean (the factored row and column statistics, the
    update clip's and the parameter scale's RMS) is taken over the whole
    parameter: summed over the mesh axes that split the dims it reduces,
    as the JAX package's global arrays give it."""

    def __init__(self, params=None, lr=None, min_dim_size_to_factor=128,
                 decay_rate: float = 0.8, clipping_threshold: float = 1.0,
                 momentum: Optional[float] = None,
                 weight_decay_rate: Optional[float] = None,
                 multiply_by_parameter_scale: bool = True,
                 max_grad_norm: Optional[float] = None, **kw):
        super().__init__(params, lr, max_grad_norm=max_grad_norm, **kw)
        if self.flat_state:
            self._flat_slots()          # refused by name
        self.min_dim_size_to_factor = int(min_dim_size_to_factor)
        self.decay_rate = float(decay_rate)
        self.clipping_threshold = clipping_threshold
        self.momentum = momentum
        self.weight_decay_rate = weight_decay_rate
        self.multiply_by_parameter_scale = multiply_by_parameter_scale
        self.eps = 1e-30            # optax factorized epsilon

    def _factored_dims(self, shape):
        """optax's rule: the two largest dims, when the smaller of them
        has at least ``min_dim_size_to_factor`` entries."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < self.min_dim_size_to_factor:
            return None
        return int(order[-2]), int(order[-1])

    @staticmethod
    def _global_shape(t: Tensor, p: torch.Tensor) -> Tuple[int, ...]:
        return tuple(t.global_shape) if t.global_shape is not None \
            else tuple(p.shape)

    @staticmethod
    def _split(graph, t: Tensor, ndim: int) -> List[Tuple[str, ...]]:
        """For each dim of ``t``, the mesh axes of more than one rank that
        split it."""
        from ..parallel.mesh import entry_axes
        mesh, spec = graph.mesh, tuple(t.pspec or ())
        if mesh is None:
            return [()] * ndim
        return [tuple(a for a in entry_axes(spec[d])
                      if mesh.axis_size(a) > 1) if d < len(spec) else ()
                for d in range(ndim)]

    @staticmethod
    def _mean(x: torch.Tensor, dims, split, mesh, keepdim=False):
        """The mean of ``x`` over ``dims`` (all dims for None) of the whole
        tensor it is a shard of: summed over the axes ``split[d]`` that
        split each reduced dim."""
        dims = tuple(range(x.ndim)) if dims is None else tuple(dims)
        axes = [a for d in dims for a in split[d]]
        if not axes:
            return x.mean(dim=dims, keepdim=keepdim) if len(dims) < x.ndim \
                or keepdim else torch.mean(x)
        from ..parallel import comm
        total = x.sum(dim=dims, keepdim=keepdim)
        n = int(np.prod([x.shape[d] for d in dims]))
        with comm.comm_tag("adafactor_stats"):
            for a in axes:
                total = comm.all_reduce(total, a, "sum", mesh)
                n *= mesh.axis_size(a)
        return total / n

    def _init_param_state(self, p: torch.Tensor, shape=None):
        """(v_row, v_col, v) of one parameter, fp32, as optax's init; the
        factored dims from ``shape`` (the global one; ``p``'s by
        default)."""
        z1 = torch.zeros((1,), dtype=torch.float32, device=p.device)
        dims = self._factored_dims(tuple(shape or p.shape))
        if dims is None:
            return z1, z1.clone(), torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device)
        d1, d0 = dims
        return (torch.zeros(np.delete(p.shape, d0).tolist(),
                            dtype=torch.float32, device=p.device),
                torch.zeros(np.delete(p.shape, d1).tolist(),
                            dtype=torch.float32, device=p.device),
                z1)

    def _ensure(self, graph, xs):
        st = self._state
        if "count" in st:
            return st
        dev = graph.device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        st.update(count=zero.clone(), v_row={}, v_col={}, v={})
        if callable(self.lr):
            st["sched_count"] = zero.clone()
        if self.momentum is not None:
            st.update(ema_count=zero.clone(), ema={})
        for t in xs:
            p = graph._var_data[t.id]
            st["v_row"][t.id], st["v_col"][t.id], st["v"][t.id] = \
                self._init_param_state(p, self._global_shape(t, p))
            if self.momentum is not None:
                st["ema"][t.id] = torch.zeros(p.shape, dtype=torch.float32,
                                              device=dev)
        return st

    _shards_state = False

    def _update(self, graph, pieces, keep=None):
        xs = [t for t, _, _ in pieces]
        st = self._ensure(graph, xs)
        t_ = (st["count"] + 1).float()
        decay_t = 1.0 - t_ ** (-self.decay_rate)
        lr = None
        if callable(self.lr):
            # optax counts from 0; the JAX package's schedule sees count+1
            lr = self.lr(st["sched_count"] + 1)
        elif self.lr is not None:
            lr = self.lr
        mesh = graph.mesh
        for t, p_store, grad in pieces:
            p = p_store.float()
            g = grad.float()
            v_row, v_col, v = (st["v_row"][t.id], st["v_col"][t.id],
                               st["v"][t.id])
            split = self._split(graph, t, p.ndim)
            if t.shard_units and any(split):
                from ..parallel.mesh import dim_split
                n = dim_split(t.pspec[t.shard_blocks_dim], mesh)[0]
                if any(0 < u < n for u in t.shard_units):
                    raise NotImplementedError(
                        f"Adafactor on {t.name}, whose kv heads repeat over "
                        f"the ranks of tp (kv_heads < tp)")
            grad_sqr = g * g + self.eps
            dims = self._factored_dims(self._global_shape(t, p))
            if dims is not None:
                d1, d0 = dims
                new_row = decay_t * v_row + (1.0 - decay_t) * \
                    self._mean(grad_sqr, (d0,), split, mesh)
                new_col = decay_t * v_col + (1.0 - decay_t) * \
                    self._mean(grad_sqr, (d1,), split, mesh)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = self._mean(
                    new_row, (reduced_d1,), split[:d0] + split[d0 + 1:],
                    mesh, keepdim=True)
                row_factor = (new_row / row_col_mean) ** -0.5
                col_factor = new_col ** -0.5
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                self._commit(v_row, new_row, keep)
                self._commit(v_col, new_col, keep)
            else:
                new_v = decay_t * v + (1.0 - decay_t) * grad_sqr
                u = g * new_v ** -0.5
                self._commit(v, new_v, keep)
            if self.clipping_threshold is not None:
                rms = torch.sqrt(self._mean(u * u, None, split, mesh))
                u = u / torch.clamp(rms / self.clipping_threshold, min=1.0)
            if lr is not None:
                u = u * lr
            if self.multiply_by_parameter_scale:
                rms = torch.sqrt(self._mean(p * p, None, split, mesh))
                u = u * torch.clamp(rms, min=1e-3)
            if self.momentum is not None:
                ema = st["ema"][t.id]
                u = (1.0 - self.momentum) * u + self.momentum * ema
                self._commit(ema, u, keep)
            if self.weight_decay_rate is not None:
                u = u + self.weight_decay_rate * p
            self._commit(p_store, p - u, keep)
        for key in ("count", "sched_count", "ema_count"):
            if key in st:
                self._commit(st[key], st[key] + 1, keep)

    # optax's state tree, flattened: the chain's states in order, each
    # NamedTuple's fields in order, a dict of parameters by variable id
    def _leaves(self) -> List[torch.Tensor]:
        st = self._state
        tids = sorted(st["v"])
        leaves = [st["count"]]
        for slot in ("v_row", "v_col", "v"):
            leaves += [st[slot][tid] for tid in tids]
        if "sched_count" in st:
            leaves.append(st["sched_count"])
        if "ema_count" in st:
            leaves.append(st["ema_count"])
            leaves += [st["ema"][tid] for tid in tids]
        return leaves

    def checkpoint_state(self, tid_to_name):
        if "count" not in self._state:
            return {}
        return {f"optax@@leaf{i:04d}": leaf
                for i, leaf in enumerate(self._leaves())}

    def load_checkpoint_state(self, entries, name_to_param, device):
        leaves = [entries[k] for k in sorted(entries)
                  if k.startswith("optax@@leaf")]
        if not leaves:
            return
        graph = next(iter(name_to_param.values())).graph
        xs = sorted(name_to_param.values(), key=lambda t: t.id)
        for t in xs:
            graph._materialize_var(t)
        self._ensure(graph, xs)
        ref = self._leaves()
        if len(ref) != len(leaves) or any(
                tuple(a.shape) != tuple(b.shape)
                for a, b in zip(ref, leaves)):
            raise ValueError("checkpointed optimizer state 'optax' does not "
                             "match this optimizer/model (leaf count/shapes)")
        with torch.no_grad():
            for dst, src in zip(ref, leaves):
                dst.copy_(src.to(device=dst.device, dtype=dst.dtype))


# torch-style aliases
SGD = SGDOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
