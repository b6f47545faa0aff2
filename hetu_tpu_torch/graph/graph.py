"""Graphs of the port (counterpart of ``hetu_tpu.graph.graph``).

Three kinds, as in the JAX package, opened with ``with graph(kind,
device=...)``:

- ``EagerGraph`` (``"eager"``): every op runs on the graph's device as
  it is made, and its output Tensors keep their values
  (``get_tensor_value``); the values give the shapes, with no meta-tensor
  pass.  Outside any ``graph(...)`` block
  ``get_default_graph()`` is a default eager graph on ``"cuda"``.
- ``DefineByRunGraph`` (``"define_by_run"``): ops record; values come
  on demand from ``get_or_compute``, which caches every intermediate it
  computes (never a variable's value: updates stay visible); ``feed``
  binds a placeholder and ``invalidate`` drops the cache.
- ``DefineAndRunGraph`` (``"define_and_run"``): the ops of
  ``hetu_tpu_torch.ops.functional`` record ``OpNode``s whose impls are
  plain torch functions; shapes and dtypes come from running each impl
  on ``device="meta"`` tensors (the counterpart of ``jax.eval_shape``;
  an unbound symbolic dim of an input is first bound to 16, as there).
  ``run(loss, fetches, feed_dict, num_micro_batches)`` then executes
  the recorded DAG on the graph's device, with the JAX package's
  semantics:

  - the feeds are split into ``num_micro_batches`` along dim 0 (0-d
    feeds are replicated); gradients of the (summed) loss accumulate
    over the micro-batches in the parameters' dtype and are divided by M;
  - scalar fetches are averaged over the micro-batches, others keep the
    last micro-batch's value;
  - the optimizer updates once, and the update op's position in the
    fetch list returns ``None`` (fetch arity is preserved).

Shape plans: a placeholder's shape may hold ``SymbolicDim``s.  Each run
binds them from the fed shapes (a derived dim is checked against its
expression when its leaves were bound by the same feeds) and keys its
plan by the fed shapes.  ``set_shape_buckets`` pads the feeds on the host
along every symbolic dim up to a bucket (a sorted list of sizes, or an
int alignment), with ``pad_values`` per placeholder (the loss's ignore
index for labels), so that the plan pool holds one plan a bucket.

The plan (the topological order for one set of fetches, fed shapes,
micro-batch count and run level) is cached in ``_plan_pool``.  Autodiff
is ``torch.autograd.grad`` over the executed forward.  Run levels
(``run_level=``, or the ambient ``with run_level(...)``): ``TOPO``
returns the plan's ops in order, ``ALLOC`` materializes the variables
and returns ``[]``, ``COMPUTE_ONLY`` runs the fetches without the
update, ``GRAD`` adds this run's gradients (the mean over its
micro-batches) into the graph's persistent accumulator
(``_grad_accum``) and does not update, and ``UPDATE`` (the default)
applies its own gradients plus the accumulated sum -- a sum over runs,
not a mean -- and zeroes the accumulator.

On the card the step is compiled, as the JAX package jits it once per
plan: each plan keeps static feed buffers at its fed (bucketed) shapes
that ``run`` copies the feeds into, and a ``core.capture.CapturedStep``
whose first call runs the whole step (every micro-batch's forward and
``torch.autograd.grad``, the accumulation and the optimizer update)
eagerly and captures it in one CUDA graph; later calls replay it and
return clones of its fetches.  So each bucket is one captured graph.
The gradient accumulator is static storage that the GRAD and UPDATE
plans read and write in place; it is allocated at the first GRAD run,
and the update plans key on it.  The graph's dropout generator is
registered with each graph, so every replay draws fresh masks.  On the
CPU the step runs eagerly.

Seeds: a graph built with ``seed=`` seeds its initializers' stream and
its dropout generator with it; one built without draws its dropout seed
from a process-wide stream, and its initializers draw from the
process-wide init stream (``graph.ctor``), both reset by ``set_seed``.

The recipe around the step: a ``GradScaler`` passed to ``minimize``
scales the loss, unscales the gradients and skips a non-finite step on
the device (``graph.amp``); ``recompute`` runs the forward as checkpointed
regions and ``cpu_offload`` under ``save_on_cpu`` (``graph.recompute``).
The plan key holds the recompute policy and the offload flag, as the JAX
package's does; an offloaded plan runs uncaptured.  ``run(...,
save_checkpoint=True)`` is accepted and, as in the JAX package, does
nothing: checkpoints are written by ``utils.checkpoint``.

Meshes (``graph(mesh=...)``, ``parallel.create_mesh``): SPMD by process.
Every rank builds the same graph over its local shapes: a
``parallel_placeholder`` has the rank's shard of its global shape, and
``run`` takes the global feed and slices it (dim 0 micro-batch first: the
feed splits into the micro-batches, and each is sharded over its axis,
as the JAX package feeds a dp-sharded batch); a ``parallel_parameter``
holds the rank's shard and ``reset_variable`` takes the global value.
The layers issue their collectives as ops (``nn.parallel``); the
optimizer syncs the gradients over the data-parallel axis (a mean) and
sums them over the axes the sequence is split over (``seq_axes``, context
parallelism: each rank holds its tokens' part), and scalar fetches are
averaged over dp and those axes, so that a fetched loss is the global
one.  ``global_value(t)`` gathers a variable (every rank calls
it).  Variables a ZeRO-3 optimizer shards over dp are stored as the
rank's dim-0 chunk and gathered at the start of each micro-batch by an
all-gather whose backward reduce-scatters.  On NCCL the step is captured
as the one-device step is; no collective of gloo can enter a CUDA graph,
so under gloo the step runs eagerly (``last_run_captured``).

Strategies (hot switching): ``switch_strategy(new_mesh, ...)`` moves the
variables, the optimizer's state and any pending gradient sums onto a
new mesh (``parallel.switch.SwitchExecGraph``) and activates a new
strategy id (``cur_strategy_id``; ``num_strategy`` grows).  The recorded
ops read the mesh they run on (``nn.parallel``), the placeholders' and
variables' local shapes are derived again from their global shapes and
specs, and every captured step of the old strategy is dropped: the next
run of each plan captures again.  ``run(cur_strategy_id=k)`` selects a
strategy whose mesh is the graph's current one.  A rank outside the new
mesh holds nothing and takes no step (``mesh.in_mesh``); it still joins
the next switch.

The numeric sentry (``Optimizer(sentry=...)``, ``resilience.sentry``):
an UPDATE plan of a sentried optimizer takes one more feed, an int32
injection code (0 clean; ``inject_numeric_fault(kind)`` arms the next
step's), fed through the plan's static buffers, so poisoned and clean
steps replay one captured graph.  The step poisons the rank's loss and
gradients by the code's factor (1.0 when clean), ANDs the verdict into
the update's ``keep`` and returns the loss and the verdict as one vector;
``run`` copies it to the host once and returns the loss as a host
tensor, the verdict's copy beside it (``NumericSentry.last_verdict``).
So a step makes one device-to-host copy with the sentry on, as the
caller's read of the loss makes one with it off.

Under a tracer (``obs.install_tracer``) ``run`` records a ``train_step``
(or ``forward``) span on the ``train`` track with ``feed``,
``executable`` and ``commit`` children, as the JAX package's does; the
``executable`` span synchronizes the card when it is recorded, so its
wall covers the step's device work.
"""
from __future__ import annotations

import contextlib
import enum
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import capture
from ..core.device import resolve_device
from .tensor import DerivedDim, SymbolicDim, Tensor

_op_ids = itertools.count()

# the stream a graph built without a seed draws its dropout seed from:
# ``set_seed`` reseeds this one, never numpy's process-global RNG
_GRAPH_SEED_STREAM = [np.random.RandomState()]


class RunLevel(enum.Enum):
    TOPO = "topo"
    ALLOC = "alloc"
    COMPUTE_ONLY = "compute_only"
    GRAD = "grad"
    UPDATE = "update"


class OpNode:
    """A graph node: op type, torch impl, input tensors, attrs, outputs."""

    __slots__ = ("id", "op_type", "impl", "inputs", "outputs", "attrs",
                 "name")

    def __init__(self, op_type: str, impl: Optional[Callable],
                 inputs: List[Tensor], attrs: Dict[str, Any], name: str):
        self.id = next(_op_ids)
        self.op_type = op_type
        self.impl = impl
        self.inputs = inputs
        self.outputs: List[Tensor] = []
        self.attrs = attrs
        self.name = name or f"{op_type}_{self.id}"

    def __repr__(self):
        return f"OpNode({self.name}, inputs={[t.name for t in self.inputs]})"


class Graph:
    """Op/tensor registry, variable storage and the evaluator."""

    def __init__(self, name: str = "graph", device="cuda",
                 seed: Optional[int] = None, mesh=None):
        self.name = name
        self.mesh = mesh
        self.device = resolve_device(device)
        self.ops: List[OpNode] = []
        self._var_data: Dict[int, torch.Tensor] = {}
        self._var_tensors: Dict[int, Tensor] = {}
        self._placeholders: Dict[int, Tensor] = {}
        self._consts: Dict[int, Tuple[Any, Tensor]] = {}
        # the persistent gradient sums of GRAD runs, by variable id
        self._grad_accum: Dict[int, torch.Tensor] = {}
        # variables stored as their rank's dim-0 chunk over a mesh axis
        # (ZeRO-3): variable id -> axis
        self._storage_axis: Dict[int, str] = {}
        # mesh axes besides dp that the step's data is split over (the
        # sequence under context parallelism, ``nn.parallel.seq_shard``):
        # the optimizer sums the gradients over them, scalar fetches
        # average over them
        self.seq_axes: set = set()
        # whether the running step routes each rank's own tokens alone
        # (``Optimizer.dp_local_tokens``)
        self.dp_local_tokens = False
        # the MoE layers' dispatch bounds (``nn.moe.MoELayer``), for the
        # static analysis of a later slice
        self._moe_meta: List[Dict[str, Any]] = []
        # optimizers whose working parameters may lag their state (flat
        # ZeRO-3): called before a variable's global value is read
        self._materializers: List[Callable] = []
        # symbolic dims a model baked at build time: id -> (dim, value,
        # who baked it)
        self._baked_dims: Dict[int, Tuple[SymbolicDim, int, str]] = {}
        # strategies (hot switching): the active id, how many the graph
        # holds, the mesh of each, and the layers' checks of a new mesh
        self.cur_strategy_id = 0
        self.num_strategy = 1
        self._strategy_meshes: Dict[int, Any] = {0: mesh}
        self._strategy_checks: List[Callable] = []
        # dropout draws from ``generator``; initializers without a seed of
        # their own from ``init_generator``, or with no graph seed from the
        # process-wide init stream (``ctor``)
        if seed is None:
            self._rng_seed = int(_GRAPH_SEED_STREAM[0].randint(0, 2**31 - 1))
            self.init_generator: Optional[torch.Generator] = None
        else:
            self._rng_seed = int(seed)
            self.init_generator = torch.Generator(device=self.device)
            self.init_generator.manual_seed(int(seed))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self._rng_seed)

    # -- construction -----------------------------------------------------------

    def as_tensor(self, value) -> Tensor:
        """A graph Tensor for ``value``; arrays and scalars become
        constants on the graph's device (one per distinct array object)."""
        if isinstance(value, Tensor):
            return value
        hit = self._consts.get(id(value))
        if hit is not None and hit[0] is value:
            return hit[1]
        data = torch.as_tensor(np.asarray(value) if not isinstance(
            value, torch.Tensor) else value, device=self.device)
        # 64-bit host values narrow as in JAX without x64
        narrow = {torch.float64: torch.float32, torch.int64: torch.int32}
        data = data.to(narrow.get(data.dtype, data.dtype))
        t = Tensor(data.shape, data.dtype, name="const", graph=self)
        node = OpNode("constant", None, [], {"value": data}, t.name)
        node.outputs = [t]
        t.producer = node
        self.ops.append(node)
        self._consts[id(value)] = (value, t)    # the ref keeps id() unique
        return t

    def make_op(self, op_type: str, impl: Callable, inputs: Sequence[Any],
                attrs: Optional[Dict[str, Any]] = None, name: str = "",
                num_outputs: int = 1) -> Union[Tensor, List[Tensor]]:
        """Records ``impl`` over ``inputs``; its outputs' shapes and dtypes
        come from running it on ``meta`` tensors (an eager graph runs it
        on the values instead).  One output Tensor, or the list of them
        where ``num_outputs`` > 1 (or the impl returns several)."""
        attrs = dict(attrs or {})
        in_tensors = [self.as_tensor(x) for x in inputs]
        node = OpNode(op_type, impl, in_tensors, attrs, name)
        # an unbound symbolic dim gets a provisional 16: recorded shapes
        # are advisory, the run's come from the feeds (shape plans)
        for t in in_tensors:
            for d in t.shape:
                if isinstance(d, SymbolicDim) and not d.is_bound:
                    d.set(16)
        flat = self._shape_pass(node)
        node.outputs = [
            Tensor(o.shape, o.dtype, producer=node,
                   name=f"{node.name}:{i}" if len(flat) > 1 else node.name,
                   graph=self)
            for i, o in enumerate(flat)]
        self.ops.append(node)
        self._post_make_op(node, flat)
        if num_outputs == 1 and len(node.outputs) == 1:
            return node.outputs[0]
        return node.outputs

    def _shape_pass(self, node: OpNode) -> List[torch.Tensor]:
        """The op's outputs on ``meta`` tensors (shapes and dtypes only)."""
        metas = [torch.empty(t.concrete_shape(), dtype=t.dtype,
                             device="meta") for t in node.inputs]
        with torch.no_grad():
            out = node.impl(*metas, **node.attrs)
        return list(out) if isinstance(out, (tuple, list)) else [out]

    def _post_make_op(self, node: OpNode,
                      outputs: List[torch.Tensor]) -> None:
        """Called with each op made and what ``_shape_pass`` gave."""

    def set_num_strategy(self, n: int) -> None:
        self.num_strategy = int(n)

    def add_strategy_check(self, fn: Callable) -> None:
        """``fn(mesh)`` raises when the graph's model cannot run on
        ``mesh``; ``switch_strategy`` calls every check before anything
        moves."""
        self._strategy_checks.append(fn)

    def bake_dim(self, dim: SymbolicDim, value: int, by: str) -> None:
        """Records that ``by`` (a model) built its ops for ``dim`` =
        ``value``: a run whose feeds bind ``dim`` otherwise raises."""
        self._baked_dims[id(dim)] = (dim, int(value), by)

    # -- variables / placeholders --------------------------------------------

    def add_variable(self, t: Tensor,
                     init_fn: Callable[[], torch.Tensor]) -> None:
        node = OpNode("variable", None, [], {"init_fn": init_fn}, t.name)
        node.outputs = [t]
        t.producer = node
        t.graph = self
        self.ops.append(node)
        self._var_tensors[t.id] = t

    def add_placeholder(self, t: Tensor) -> None:
        node = OpNode("placeholder", None, [], {}, t.name)
        node.outputs = [t]
        t.producer = node
        t.graph = self
        self.ops.append(node)
        self._placeholders[t.id] = t

    def _materialize_var(self, t: Tensor) -> torch.Tensor:
        if t.id not in self._var_data:
            val = self._stored_chunk(t, t.producer.attrs["init_fn"]())
            self._var_data[t.id] = val.to(device=self.device,
                                          dtype=t.dtype).contiguous()
        return self._var_data[t.id]

    # -- values over a mesh ---------------------------------------------------

    def _stored_chunk(self, t: Tensor, local: torch.Tensor) -> torch.Tensor:
        """The part of the rank's shard that the rank stores: all of it,
        or under ZeRO-3 its dim-0 chunk over the storage axis."""
        axis = self._storage_axis.get(t.id)
        if axis is None:
            return local
        n, i = self.mesh.axis_size(axis), self.mesh.axis_index(axis)
        return local.chunk(n, 0)[i]

    def _local_of_global(self, t: Tensor, value):
        """The rank's stored part of a variable's global value."""
        if self.mesh is not None and t.global_shape is not None and \
                tuple(value.shape) == tuple(t.global_shape):
            from ..parallel.mesh import take_shard
            value = take_shard(value, t.pspec, self.mesh, t.shard_blocks,
                               t.shard_blocks_dim, t.shard_units)
        elif tuple(value.shape) != t.concrete_shape():
            raise ValueError(f"value for {t.name} has shape "
                             f"{tuple(value.shape)}, expected "
                             f"{t.global_shape or t.shape}")
        return self._stored_chunk(t, value)

    def store_sharded(self, t: Tensor, axis: str) -> None:
        """Stores ``t`` as the rank's dim-0 chunk over ``axis`` from now
        on (ZeRO-3; ``run`` gathers it at each use)."""
        if t.id in self._storage_axis:
            return
        cur = self._var_data.get(t.id)
        self._storage_axis[t.id] = axis
        if cur is not None:
            self._var_data[t.id] = self._stored_chunk(t, cur).clone()
            self._storage_replaced()

    def global_value(self, t: Tensor) -> torch.Tensor:
        """A variable's global value on every rank: its stored part
        gathered over the storage axis (ZeRO-3), then over each axis of its
        spec (a stacked weight's ``pp`` stages among them), fused blocks
        put back in order.  Every rank of the mesh must
        call it (the gathers are collectives)."""
        for fn in self._materializers:
            fn(self)
        return self.gather_global(t, self.get_tensor_value(t).detach(),
                                  self._storage_axis.get(t.id))

    def gather_global(self, t: Tensor, val: torch.Tensor,
                      chunk_axis: Optional[str] = None) -> torch.Tensor:
        """The global value of ``t``'s layout from the rank's part ``val``
        (its shard, or under ``chunk_axis`` that shard's dim-0 chunk): an
        optimizer state is laid out as its parameter.  A collective."""
        from ..parallel import comm
        from ..parallel.mesh import entry_axes, unblock
        mesh = self.mesh
        if mesh is None:
            return val
        if chunk_axis is not None:
            val = comm.all_gather(val, chunk_axis, 0, mesh)
        for d, entry in enumerate(t.pspec or ()):
            axes = [a for a in entry_axes(entry) if mesh.axis_size(a) > 1]
            for a in reversed(axes):     # the inner axis first
                val = comm.all_gather(val, a, d, mesh)
            n = int(np.prod([mesh.axis_size(a) for a in axes])) if axes \
                else 1
            if d == t.shard_blocks_dim and t.shard_blocks and n > 1:
                val = unblock(val, n, t.shard_blocks, d, t.shard_units)
        return val

    def get_tensor_value(self, t: Tensor) -> torch.Tensor:
        if t.id in self._var_tensors:
            return self._materialize_var(t)
        raise ValueError(f"{t.name} has no stored value; fetch it via run()")

    def reset_variable(self, t: Tensor, value) -> None:
        """Overwrite a variable's value (cast to its dtype and device),
        in place where the variable has storage of its shape and dtype,
        so that captured steps keep reading it.  On a mesh ``value`` is the
        global value (the rank keeps its shard), as in the JAX package."""
        data = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.array(value))
        data = self._local_of_global(t, data)
        cur = self._var_data.get(t.id)
        if cur is not None and cur.dtype == t.dtype and \
                tuple(cur.shape) == tuple(data.shape):
            with torch.no_grad():
                cur.copy_(data.detach())
            return
        self._var_data[t.id] = data.detach().to(
            device=self.device, dtype=t.dtype).clone()
        self._storage_replaced()

    def _storage_replaced(self) -> None:
        """A variable's storage was replaced: steps captured over the old
        one are dropped (``DefineAndRunGraph`` holds them)."""

    @property
    def trainable_variables(self) -> List[Tensor]:
        return [t for t in self._var_tensors.values() if t.trainable]

    # -- autodiff -------------------------------------------------------------

    def make_gradients(self, loss: Tensor,
                       xs: Sequence[Tensor]) -> List[Tensor]:
        """Gradient tensors of the (summed) ``loss`` with respect to
        ``xs``, computed by ``torch.autograd.grad`` when evaluated."""
        node = OpNode("gradients", None, [loss] + list(xs),
                      {"loss": loss, "xs": list(xs)}, f"grad_{loss.name}")
        node.outputs = [Tensor(x.shape, x.dtype, producer=node,
                               name=f"grad_{x.name}", graph=self)
                        for x in xs]
        self.ops.append(node)
        return node.outputs

    # -- evaluation -------------------------------------------------------------

    @staticmethod
    def _topo_from(targets: Sequence[Tensor]) -> List[OpNode]:
        """Post-order DFS over producers (iterative: deep models exceed
        Python's recursion limit)."""
        order: List[OpNode] = []
        seen = set()
        for t in targets:
            if t.producer is None or t.producer.id in seen:
                continue
            stack = [(t.producer, iter(t.producer.inputs))]
            seen.add(t.producer.id)
            while stack:
                node, it = stack[-1]
                nxt = next((x.producer for x in it if x.producer is not None
                            and x.producer.id not in seen), None)
                if nxt is None:
                    order.append(node)
                    stack.pop()
                else:
                    seen.add(nxt.id)
                    stack.append((nxt, iter(nxt.inputs)))
        return order

    @staticmethod
    def _frees(plan: List[OpNode], keep: Sequence[int]) -> List[List[int]]:
        """For each node of ``plan``, the tensor ids whose last use it is
        (and so can leave the environment after it), ``keep`` excepted:
        autograd then holds only what the backward needs."""
        last: Dict[int, int] = {}
        for i, node in enumerate(plan):
            for t in node.outputs:
                last.setdefault(t.id, i)
            for t in node.inputs:
                last[t.id] = i
        frees: List[List[int]] = [[] for _ in plan]
        for tid, i in last.items():
            if tid not in keep:
                frees[i].append(tid)
        return frees

    @staticmethod
    def _eval(plan: List[OpNode], env: Dict[int, torch.Tensor],
              frees: Optional[List[List[int]]] = None) -> None:
        """Runs ``plan`` in order, filling ``env`` (tensor id -> value) and
        dropping each value after its last use when ``frees`` is given."""
        for i, node in enumerate(plan):
            if all(t.id in env for t in node.outputs):
                continue
            if node.op_type == "constant":
                env[node.outputs[0].id] = node.attrs["value"]
            elif node.op_type in ("variable", "placeholder"):
                raise ValueError(f"{node.op_type} {node.name} not fed")
            elif node.op_type == "gradients":
                loss = env[node.attrs["loss"].id]
                xs = [env[x.id] for x in node.attrs["xs"]]
                grads = torch.autograd.grad(
                    loss.sum() if loss.ndim else loss, xs,
                    retain_graph=True, allow_unused=True)
                for t, x, g in zip(node.outputs, xs, grads):
                    env[t.id] = torch.zeros_like(x) if g is None else g
            else:
                out = node.impl(*[env[t.id] for t in node.inputs],
                                **node.attrs)
                flat = out if isinstance(out, (tuple, list)) else [out]
                for t, v in zip(node.outputs, flat):
                    env[t.id] = v
            if frees is not None:
                for tid in frees[i]:
                    env.pop(tid, None)


class EagerGraph(Graph):
    """Immediate execution: each op runs on the graph's device as it is
    made, and its outputs keep their values."""

    def as_tensor(self, value) -> Tensor:
        t = super().as_tensor(value)
        if t._data is None and t.producer is not None and \
                t.producer.op_type == "constant":
            t.set_data(t.producer.attrs["value"])
        return t

    def _value_of(self, t: Tensor) -> torch.Tensor:
        if t._data is not None:
            return t._data
        if t.id in self._var_tensors:
            return self._materialize_var(t)
        env: Dict[int, torch.Tensor] = {}
        for vt in self._var_tensors.values():
            env[vt.id] = self._materialize_var(vt)
        plan = self._topo_from([t])
        for node in plan:
            for o in node.outputs:
                if o._data is not None:
                    env[o.id] = o._data
        self._eval(plan, env)
        return env[t.id]

    def _shape_pass(self, node: OpNode) -> List[torch.Tensor]:
        """The op itself, on the inputs' values: its results give the
        shapes (a meta-tensor pass would cost more host time than the
        op)."""
        out = node.impl(*[self._value_of(t) for t in node.inputs],
                        **node.attrs)
        return list(out) if isinstance(out, (tuple, list)) else [out]

    def _post_make_op(self, node: OpNode,
                      outputs: List[torch.Tensor]) -> None:
        for t, v in zip(node.outputs, outputs):
            t.set_data(v)

    def get_tensor_value(self, t: Tensor) -> torch.Tensor:
        if t._data is not None:
            return t._data
        return super().get_tensor_value(t)

    def next_rng_tensor(self) -> Tensor:
        """A fresh (2,) int32 key from the graph's generator each call."""
        key = torch.randint(0, 2**31 - 1, (2,), generator=self.generator,
                            device=self.device, dtype=torch.int32)
        return self.as_tensor(key)


class DefineByRunGraph(Graph):
    """Ops record as in a define-and-run graph; values materialize on
    demand (:meth:`get_or_compute`), each computed intermediate cached, so
    that later fetches reuse them instead of running upstream again."""

    def __init__(self, name: str = "define_by_run", device="cuda",
                 seed: Optional[int] = None, mesh=None):
        super().__init__(name, device, seed, mesh)
        self._computed: Dict[int, torch.Tensor] = {}

    def get_or_compute(self, t: Tensor) -> torch.Tensor:
        if t.id in self._computed:
            return self._computed[t.id]
        env: Dict[int, torch.Tensor] = dict(self._computed)
        for vt in self._var_tensors.values():
            env.setdefault(vt.id, self._materialize_var(vt))
        with torch.no_grad():
            self._eval(self._topo_from([t]), env)
        # variable values stay out of the cache: updates and
        # reset_variable must reach later fetches
        self._computed.update({k: v for k, v in env.items()
                               if k not in self._var_tensors})
        return env[t.id]

    def feed(self, t: Tensor, value) -> None:
        """Binds a placeholder's value for later ``get_or_compute``."""
        self._computed[t.id] = torch.as_tensor(
            value if isinstance(value, torch.Tensor) else np.asarray(value),
            dtype=t.dtype, device=self.device)

    def invalidate(self) -> None:
        """Drops every cached value (the variables stay)."""
        self._computed.clear()

    def get_tensor_value(self, t: Tensor) -> torch.Tensor:
        if t.id in self._computed:
            return self._computed[t.id]
        if t.id in self._var_tensors:
            return super().get_tensor_value(t)
        return self.get_or_compute(t)


class _Plan:
    """A plan-pool entry: the topological order, the frees, the run level,
    the recompute regions and the ops they keep (``None``: no recompute),
    whether the forward offloads what it saves, on the card the static
    feed buffers and the captured step, and under a numeric sentry the
    loss's dtype (the step returns it packed with the verdict in fp32)."""

    __slots__ = ("order", "frees", "level", "regions", "saved", "offload",
                 "feeds", "step", "loss_dtype")

    def __init__(self, order: List[OpNode], frees: List[List[int]],
                 level: "RunLevel", regions=None, saved=None,
                 offload: bool = False):
        self.order, self.frees, self.level = order, frees, level
        self.regions, self.saved, self.offload = regions, saved, offload
        self.feeds: Dict[int, torch.Tensor] = {}
        self.step: Optional[capture.CapturedStep] = None
        self.loss_dtype: Optional[torch.dtype] = None


class DefineAndRunGraph(Graph):
    """Symbolic graph with a plan pool."""

    def __init__(self, name: str = "define_and_run", device="cuda",
                 seed: Optional[int] = None, mesh=None):
        super().__init__(name, device, seed, mesh)
        self._plan_pool: Dict[Tuple, _Plan] = {}
        self._captures = capture.StepCache("training step")
        self._captures_dropped = 0
        self._recompute_policy: Optional[str] = None
        self._offload = False
        self._shape_buckets: Union[None, int, List[int]] = None
        self._bucket_pad_values: Dict[int, Any] = {}
        # every derived dim seen in a fed or placeholder shape: stale
        # provisional overrides are cleared on all of them at each bind
        self._derived_dims: Dict[int, DerivedDim] = {}
        self.last_run_captured = False
        # the numeric sentry's injection code: a scalar placeholder fed
        # to UPDATE plans of a sentried optimizer, and the next value
        self._sentry_tensor: Optional[Tensor] = None
        self._sentry_next_code = 0

    def _storage_replaced(self) -> None:
        for entry in self._plan_pool.values():
            entry.step = None
        self._captures_dropped += self._captures.captured
        self._captures.clear()

    @property
    def compile_count(self) -> int:
        """CUDA graphs captured (one a plan) and held; 0 on the CPU."""
        return self._captures.captured

    @property
    def captures_total(self) -> int:
        """CUDA graphs captured so far, those dropped since (a strategy
        switch, replaced storage) included."""
        return self._captures_dropped + self._captures.captured

    def switch_strategy(self, new_mesh=None, pspec_overrides=None,
                        optimizer=None, mode=None, dtype=None):
        """Hot-switches the variables, ``optimizer``'s state and the
        pending gradient sums to ``new_mesh`` (and ``pspec_overrides``:
        variable -> new spec), and activates a new strategy id (the
        reference's ``SwitchExecGraph::SwitchParams``).  Every rank of the
        world calls it, those outside either mesh too.  Returns the
        ``SwitchProfile``."""
        from ..obs.tracer import get_tracer
        from ..parallel.switch import SwitchExecGraph, SwitchMode
        if new_mesh is None:
            raise ValueError("switch_strategy needs the new mesh "
                             "(parallel.create_mesh)")
        if self.mesh is None:
            raise ValueError("switch_strategy needs a graph built with a "
                             "mesh (graph(mesh=...))")
        for axis in sorted(self.seq_axes | {"cp"}):
            if self.mesh.axis_size(axis) != new_mesh.axis_size(axis):
                raise NotImplementedError(
                    f"a switch that changes the sequence axis {axis!r} "
                    f"({self.mesh.axis_size(axis)} -> "
                    f"{new_mesh.axis_size(axis)}) is not ported: the model "
                    f"takes its sequence block when it is built")
        for check in self._strategy_checks:
            check(new_mesh)
        if self.mesh.in_mesh:
            # ZeRO-3 flat keeps the working parameters stale between
            # updates, and lazily made variables have no value yet
            for fn in self._materializers:
                fn(self)
            for t in self._var_tensors.values():
                self._materialize_var(t)
        if mode is None:
            mode = SwitchMode.ORIGIN_PARAM if optimizer is None \
                else SwitchMode.ORIGIN_PARAM_AND_OPTIMIZER
        tr = get_tracer()
        sp = tr.begin("switch_strategy", track="train",
                      from_strategy=self.cur_strategy_id) if tr.enabled \
            else None
        try:
            prof = SwitchExecGraph(self, new_mesh, pspec_overrides, mode,
                                   dtype).switch(optimizer)
            self.cur_strategy_id = max(self._strategy_meshes) + 1
            self._strategy_meshes[self.cur_strategy_id] = new_mesh
            self.num_strategy = max(self.num_strategy,
                                    self.cur_strategy_id + 1)
            if sp is not None:
                tr.end(sp, to_strategy=self.cur_strategy_id,
                       **prof.as_dict())
            return prof
        finally:
            if sp is not None:
                tr.end(sp)

    def _adopt_mesh(self, new_mesh) -> None:
        """Points the graph and its recorded ops at ``new_mesh`` and
        derives the placeholders' and variables' local shapes again; the
        captured steps of the old mesh are dropped."""
        from ..parallel import mesh as mesh_mod
        from .ctor import _local_shape
        old = self.mesh
        for node in self.ops:
            if node.attrs.get("mesh") is old and old is not None:
                node.attrs["mesh"] = new_mesh
        stack = mesh_mod._CURRENT
        for i, m in enumerate(stack):
            if m is old:
                stack[i] = new_mesh
        self.mesh = new_mesh
        for t in itertools.chain(self._placeholders.values(),
                                 self._var_tensors.values()):
            if t.global_shape is None:
                continue
            if t.id in self._var_tensors:
                t.shape = mesh_mod.layout_shape(
                    t.global_shape, t.pspec, new_mesh, t.shard_blocks,
                    t.shard_blocks_dim, t.shard_units)
            else:
                t.shape = tuple(_local_shape(self, t.global_shape, t.pspec))
        # the old strategy's plans stay in the pool (keyed by its id), their
        # feed buffers and captured steps released
        for entry in self._plan_pool.values():
            entry.feeds = {}
        self._storage_replaced()

    # -- numeric sentry ---------------------------------------------------

    def _sentry_code_tensor(self) -> Tensor:
        if self._sentry_tensor is None:
            t = Tensor((), "int32", name="_sentry_code", graph=self)
            self.add_placeholder(t)
            self._sentry_tensor = t
        return self._sentry_tensor

    def inject_numeric_fault(self, kind: str) -> None:
        """Arm a one-shot numeric fault for the NEXT UPDATE run
        (``grad_nan``, ``grad_spike``, ``loss_spike``): the fed code makes
        the step poison its own gradients or loss at the sentry's seam."""
        from ..resilience.sentry import INJECT_CODES
        if kind not in INJECT_CODES:
            raise ValueError(f"unknown numeric fault {kind!r}; have "
                             f"{sorted(INJECT_CODES)}")
        self._sentry_next_code = INJECT_CODES[kind]

    @staticmethod
    def _sentry_for(update_node, run_level) -> Optional[Any]:
        """The sentry of an UPDATE plan's optimizer, or None: one rule
        for the feed, the plan and the step."""
        if update_node is None or run_level != RunLevel.UPDATE:
            return None
        return getattr(update_node.attrs["optimizer"], "sentry", None)

    # -- shape buckets ----------------------------------------------------

    def set_shape_buckets(self, buckets, pad_values=None) -> None:
        """Pads the feeds along every symbolic dim up to a bucket, so that
        varying shapes reuse plans (and on the card captured graphs).

        ``buckets``: a sorted list of sizes, or an int alignment (round up
        to a multiple).  ``pad_values`` maps placeholders to their fill
        (default 0; the loss's ignore index for labels, so that the pad
        positions drop out of the loss)."""
        if isinstance(buckets, int):
            self._shape_buckets = buckets
        else:
            self._shape_buckets = sorted(int(b) for b in buckets)
            if not self._shape_buckets:
                raise ValueError("shape bucket list must be non-empty")
        self._bucket_pad_values = {
            (t.id if isinstance(t, Tensor) else t): v
            for t, v in (pad_values or {}).items()}

    def _bucket_dim(self, size: int) -> int:
        b = self._shape_buckets
        if isinstance(b, int):
            return ((size + b - 1) // b) * b
        for cand in b:
            if cand >= size:
                return cand
        raise ValueError(
            f"feed dim {size} exceeds the largest shape bucket {b[-1]}")

    def _bucket_feeds(self, feeds: Dict[Tensor, Any]) -> Dict[Tensor, Any]:
        """The feeds padded up to their buckets along symbolic dims (numpy
        feeds on the host, as the JAX package pads them)."""
        out = {}
        for t, v in feeds.items():
            shape = tuple(v.shape)
            pads = [(0, self._bucket_dim(shape[i]) - shape[i])
                    if isinstance(d, SymbolicDim) and i < len(shape)
                    else (0, 0) for i, d in enumerate(t.shape)]
            if any(p[1] for p in pads):
                fill = self._bucket_pad_values.get(t.id, 0)
                if isinstance(v, torch.Tensor):
                    flat = [n for p in reversed(pads) for n in p]
                    v = torch.nn.functional.pad(v, flat, value=fill)
                else:
                    v = np.pad(v, pads, constant_values=fill)
            out[t] = v
        return out

    # -- symbolic dims ------------------------------------------------------

    @staticmethod
    def _leaf_dims(dim) -> List[SymbolicDim]:
        out, stack = [], [dim]
        while stack:
            d = stack.pop()
            if isinstance(d, DerivedDim):
                stack.extend(p for p in d._parents
                             if isinstance(p, SymbolicDim))
            elif isinstance(d, SymbolicDim):
                out.append(d)
        return out

    @staticmethod
    def _derived_nodes(dim) -> List[DerivedDim]:
        """Every derived dim on the expression DAG rooted at ``dim``: an
        override must clear along the whole path, or a nested dim reads a
        stale intermediate."""
        out, stack = [], [dim]
        while stack:
            d = stack.pop()
            if isinstance(d, DerivedDim):
                out.append(d)
                stack.extend(p for p in d._parents
                             if isinstance(p, SymbolicDim))
        return out

    def _bind_symbolic_dims(self, feeds: Dict[Tensor, Any]) -> None:
        """Checks each feed's rank and static dims and binds the symbolic
        ones.  Leaves bind first; a derived dim is then checked against
        its expression where every leaf was bound by these feeds and no
        buckets pad them, else bound provisionally."""
        derived, fresh = [], set()
        for t, v in feeds.items():
            shape = tuple(np.shape(v)) if not isinstance(v, torch.Tensor) \
                else tuple(v.shape)
            if len(shape) != len(t.shape):
                raise ValueError(f"feed for {t.name} has rank {len(shape)}, "
                                 f"expected {len(t.shape)} ({t.shape})")
            for dim, d in zip(t.shape, shape):
                if isinstance(dim, DerivedDim):
                    derived.append((t, dim, d))
                elif isinstance(dim, SymbolicDim):
                    dim.set(d)
                    fresh.add(id(dim))
                elif int(dim) != d:
                    raise ValueError(f"feed for {t.name} has shape {shape}, "
                                     f"expected {t.shape}")
        # clear the provisional overrides of every derived dim reachable
        # from these feeds and the placeholders: a stale one must not
        # shadow the expression once its leaves are rebound
        for t in itertools.chain(feeds, self._placeholders.values()):
            for dim in t.shape:
                if isinstance(dim, DerivedDim):
                    for node in self._derived_nodes(dim):
                        self._derived_dims[id(node)] = node
        for node in self._derived_dims.values():
            node.clear_override()
        seen: Dict[int, int] = {}
        for t, dim, d in derived:
            prev = seen.get(id(dim))
            if prev is not None and prev != d:
                raise ValueError(f"conflicting feeds for derived dim "
                                 f"{dim.name}: {prev} vs {d} (tensor "
                                 f"{t.name})")
            seen[id(dim)] = d
            if self._shape_buckets is None and dim.is_bound and all(
                    id(leaf) in fresh for leaf in self._leaf_dims(dim)):
                if dim.get() != d:
                    raise ValueError(
                        f"feed for {t.name} gives derived dim {dim.name} "
                        f"= {d}, but its expression evaluates to "
                        f"{dim.get()}")
            else:
                dim.set(d)      # provisional (unbound leaves, buckets)
        for dim, value, by in self._baked_dims.values():
            if dim.is_bound and dim.get() != value:
                raise ValueError(
                    f"{by} was built for {dim.name} = {value} and bakes "
                    f"that length into its ops, as the JAX package's "
                    f"does; the feeds give {dim.get()}")

    # -- feeds and plans ----------------------------------------------------

    def _check_feeds(self, feed_dict: Dict[Tensor, Any]
                     ) -> Dict[Tensor, Any]:
        """The feeds by placeholder: torch tensors as they are, anything
        else as a numpy array."""
        feeds = {}
        for t, v in feed_dict.items():
            if not isinstance(t, Tensor) or t.id not in self._placeholders:
                raise ValueError(f"feed key {t!r} is not a placeholder of "
                                 f"this graph")
            feeds[t] = v if isinstance(v, torch.Tensor) else np.asarray(v)
        return feeds

    def _feed_tensors(self, feeds: Dict[Tensor, Any], entry: _Plan,
                      static: bool) -> Dict[Tensor, torch.Tensor]:
        """The feeds as tensors of their placeholders' dtypes on the
        graph's device: new tensors, or with ``static`` copied into the
        plan's static buffers (allocated at its first run, at the fed
        shapes its key holds)."""
        if not static:
            return {t: torch.as_tensor(v, dtype=t.dtype, device=self.device)
                    for t, v in feeds.items()}
        out = {}
        for t, v in feeds.items():
            buf = entry.feeds.get(t.id)
            if buf is None:
                buf = entry.feeds[t.id] = torch.empty(
                    tuple(v.shape), dtype=t.dtype, device=self.device)
            buf.copy_(torch.as_tensor(v, dtype=t.dtype))
            out[t] = buf
        return out

    def _plan(self, fetches: List[Tensor], feeds: Dict[Tensor, Any],
              num_micro_batches: int, run_level: RunLevel,
              update_node: Optional[OpNode]) -> _Plan:
        from .recompute import regions, resolve_policy
        feed_sig = tuple(sorted((t.id, tuple(v.shape))
                                for t, v in feeds.items()))
        # the accumulator entries an update plan reads (GRAD runs create
        # them): a plan captured before they existed does not read them
        accum = tuple(x.id for x in update_node.attrs["xs"]
                      if x.id in self._grad_accum) \
            if update_node is not None else ()
        key = (tuple(t.id for t in fetches), feed_sig, num_micro_batches,
               run_level, update_node.id if update_node is not None else None,
               accum,
               # recompute/offload change the step that is captured
               self._recompute_policy, self._offload,
               # plans of a strategy stay in the pool after a switch
               self.cur_strategy_id)
        plan = self._plan_pool.get(key)
        if plan is None:
            targets = list(fetches)
            if update_node is not None:
                targets.append(update_node.attrs["grad_node"].attrs["loss"])
            order = self._topo_from(targets)
            fed = {t.id for t in feeds}
            for node in order:
                if node.op_type == "placeholder" and \
                        node.outputs[0].id not in fed:
                    raise ValueError(f"placeholder {node.name} not fed")
            keep = [t.id for t in targets]
            saved = None if self._offload else \
                resolve_policy(self._recompute_policy)
            plan = _Plan(order, self._frees(order, keep), run_level,
                         None if saved is None else regions(order, keep),
                         saved, self._offload)
            self._plan_pool[key] = plan
        return plan

    def run(self, loss_or_fetches, fetches=None, feed_dict=None,
            num_micro_batches: int = 1, cur_strategy_id: Optional[int] = None,
            run_level: Union[str, RunLevel, None] = None,
            save_checkpoint: bool = False):
        """``run(loss, fetches, feed_dict, num_micro_batches)`` or
        ``run(fetches, feed_dict=...)``: values of ``fetches`` (torch
        tensors), ``None`` at the position of an optimizer update.
        ``run_level`` defaults to the ambient :class:`run_level`.  On the
        card the step of each plan is captured at its first run and
        replayed after that (the fetches are clones of the graph's
        outputs); on the CPU, and on the card under ``capture.eager()``,
        it runs eagerly."""
        if cur_strategy_id is not None and \
                cur_strategy_id != self.cur_strategy_id:
            m = self._strategy_meshes.get(cur_strategy_id, False)
            if m is False and not 0 <= cur_strategy_id < self.num_strategy:
                raise ValueError(f"no strategy {cur_strategy_id}: the graph "
                                 f"holds {self.num_strategy}")
            if m is not False and m is not self.mesh:
                raise ValueError(
                    f"strategy {cur_strategy_id} runs on {m}, the values "
                    f"live on {self.mesh}: switch_strategy moves them")
            self.cur_strategy_id = cur_strategy_id
        if self.mesh is not None and not getattr(self.mesh, "in_mesh", True):
            raise ValueError(f"rank {self.mesh.rank} holds no position of "
                             f"the graph's mesh {self.mesh.shape}: it takes "
                             f"no step (mesh.in_mesh)")
        if fetches is None:
            fetches = loss_or_fetches
        return self._run(fetches, feed_dict, num_micro_batches, run_level,
                         static=self.device.type == "cuda")

    def _run(self, fetches, feed_dict, num_micro_batches, run_level,
             static: bool):
        """``run`` with the choice of feed buffers: ``static`` copies the
        feeds into the plan's static buffers and runs the step body over
        them, captured on the card unless ``capture.eager()`` is open,
        eagerly on the CPU."""
        from ..obs.tracer import get_tracer
        if not isinstance(fetches, (list, tuple)):
            fetches = [fetches]
        fetches = list(fetches)
        if run_level is None:
            run_level = _run_level_ctx._current
        run_level = RunLevel(run_level)
        if run_level == RunLevel.TOPO:
            return self._topo_from([f for f in fetches
                                    if isinstance(f, Tensor)])
        tr = get_tracer()
        has_update = any(isinstance(f, Tensor) and f.producer is not None
                         and f.producer.op_type == "update" for f in fetches)
        step_sp = tr.begin(
            "train_step" if has_update else "forward", track="train",
            run_level=run_level.value, strategy=self.cur_strategy_id) \
            if tr.enabled else None
        try:
            return self._run_plan(tr, fetches, feed_dict, num_micro_batches,
                                  run_level, static)
        finally:
            if step_sp is not None:
                tr.end(step_sp)

    def _run_plan(self, tr, fetches, feed_dict, num_micro_batches,
                  run_level, static: bool):
        """The body of :meth:`_run`: the feeds, the plan, the step (or
        its replay) and the fetches, each phase a span under a tracer."""
        feed_sp = tr.begin("feed", track="train") if tr.enabled else None
        M = int(num_micro_batches)
        if M < 1:
            raise ValueError(f"num_micro_batches must be >= 1, got {M}")
        feeds = self._check_feeds(dict(feed_dict or {}))
        if self._shape_buckets is not None:
            feeds = self._bucket_feeds(feeds)
        if self.mesh is not None:
            feeds = {t: self._shard_feed(t, v, M) for t, v in feeds.items()}
        self._bind_symbolic_dims(feeds)
        for t, v in feeds.items():
            if t.ndim and v.shape[0] % M:
                raise ValueError(
                    f"batch {v.shape[0]} of {t.name} not divisible by "
                    f"{M} micro-batches")

        update_node, real_fetches, update_positions = None, [], []
        for i, f in enumerate(fetches):
            if f.producer is not None and f.producer.op_type == "update":
                update_node = f.producer
                update_positions.append(i)
            else:
                real_fetches.append(f)
        if run_level in (RunLevel.COMPUTE_ONLY, RunLevel.ALLOC):
            update_node = None
        for t in self._var_tensors.values():
            self._materialize_var(t)
        if run_level == RunLevel.ALLOC:
            if feed_sp is not None:
                tr.end(feed_sp)
            return []
        if run_level == RunLevel.GRAD and update_node is not None:
            for x in update_node.attrs["xs"]:
                if x.id not in self._grad_accum:
                    self._grad_accum[x.id] = torch.zeros_like(
                        self._var_data[x.id])
        sentry = self._sentry_for(update_node, run_level)
        loss_pos = None
        if sentry is not None:
            loss_t = update_node.attrs["grad_node"].attrs["loss"]
            loss_pos = next((i for i, f in enumerate(real_fetches)
                             if f.id == loss_t.id), None)
            if loss_pos is None:
                raise ValueError(
                    "numeric sentry needs the loss among the fetches (the "
                    "verdict rides the loss's host copy): fetch "
                    f"{loss_t.name} beside the update")
            # a value, never a shape: an injection replays the same plan
            feeds[self._sentry_code_tensor()] = np.asarray(
                self._sentry_next_code, dtype=np.int32)
            self._sentry_next_code = 0
        entry = self._plan(real_fetches, feeds, M, run_level, update_node)
        feeds = self._feed_tensors(feeds, entry, static)
        if feed_sp is not None:
            tr.end(feed_sp, n_feeds=len(feeds), micro_batches=M)

        def body():
            return self._step(entry, feeds, M, real_fetches, update_node)

        self.last_run_captured = static and self.device.type == "cuda" \
            and not capture.is_eager() and not entry.offload \
            and not self._gloo_mesh()
        exec_sp = tr.begin("executable", track="train",
                           captured=self.last_run_captured) \
            if tr.enabled else None
        if self.last_run_captured:
            if entry.step is None:
                entry.step = self._captures.get(
                    id(entry), body, self._generators(entry))
            fetch_vals = [v.clone() for v in entry.step()]
        else:
            fetch_vals = body()
        if exec_sp is not None:
            # the replay returns once it is launched: a recorded span
            # waits for the device, so its wall is the step's
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            tr.end(exec_sp)
        commit_sp = tr.begin("commit", track="train") if tr.enabled \
            else None
        out: List[Optional[torch.Tensor]] = list(fetch_vals)
        if loss_pos is not None:
            # the step's one device-to-host copy: the loss and the verdict
            host = out[loss_pos].cpu()
            sentry._host_packet = host
            out[loss_pos] = host[0].to(entry.loss_dtype)
        for i in update_positions:
            out.insert(i, None)
        if commit_sp is not None:
            tr.end(commit_sp)
        return out

    def _gloo_mesh(self) -> bool:
        """No gloo collective can enter a CUDA graph: a step over a gloo
        mesh of several ranks runs eagerly."""
        return self.mesh is not None and self.mesh.size > 1 and \
            self.mesh.backend == "gloo"

    def _shard_feed(self, t: Tensor, v, M: int):
        """The rank's part of the global feed ``v`` of ``t`` under its
        spec.  A sharded dim 0 splits into the ``M`` micro-batches first
        and each is sharded, so that micro-batch ``mb`` of the rank is its
        shard of the global micro-batch ``mb``; a placeholder whose
        ``feed_groups`` is ``n`` (fed to a model that splits each
        micro-batch into ``n`` again, the SPMD pipeline) splits into ``M *
        n``."""
        from ..parallel.mesh import dim_split
        if t.pspec is None:
            return v
        shape = tuple(v.shape)
        if t.global_shape is not None:
            want = [d for d in t.global_shape]
            if len(shape) != len(want) or any(
                    not isinstance(w, SymbolicDim) and int(w) != g
                    for w, g in zip(want, shape)):
                raise ValueError(f"feed for {t.name} has shape {shape}, "
                                 f"expected the global shape "
                                 f"{tuple(t.global_shape)}")
        M = M * t.feed_groups
        for d, entry in enumerate(t.pspec):
            n, i = dim_split(entry, self.mesh)
            if n == 1:
                continue
            size = shape[d]
            if d == 0 and M > 1:
                if size % (M * n):
                    raise ValueError(
                        f"batch {size} of {t.name} not divisible by {M} "
                        f"micro-batches of {n} shards")
                w = size // M // n
                v = v.reshape((M, size // M) + tuple(shape[1:]))
                v = v[:, i * w:(i + 1) * w].reshape(
                    (M * w,) + tuple(shape[1:]))
            else:
                if size % n:
                    raise ValueError(f"dim {d} of the feed for {t.name} "
                                     f"({size}) not divisible by {n}")
                w = size // n
                idx = (slice(None),) * d + (slice(i * w, (i + 1) * w),)
                v = v[idx]
            shape = tuple(v.shape)
        return v

    def _gather_stored(self, needs_grad: bool) -> Dict[int, Tuple]:
        """Variables stored as dp chunks (ZeRO-3) gathered once a step:
        variable id -> (chunk leaf, the gathered value, a leaf of it that
        every micro-batch reads).  The gather is an autograd all-gather
        whose backward reduce-scatters (a mean over the axis, as the
        gradient sync is); ``_scatter_stored`` runs that backward once on
        the gradient accumulated over the micro-batches."""
        if not self._storage_axis:
            return {}
        from ..parallel import comm
        out = {}
        with comm.comm_tag("param_gather"), torch.set_grad_enabled(
                needs_grad):
            for tid, axis in self._storage_axis.items():
                chunk = self._var_data[tid]
                if needs_grad:
                    chunk = chunk.detach().requires_grad_(True)
                    full = comm.gather_from_group(chunk, axis, 0, self.mesh,
                                                  grad_op="mean")
                    out[tid] = (chunk, full,
                                full.detach().requires_grad_(True))
                else:
                    full = comm.all_gather(chunk, axis, 0, self.mesh)
                    out[tid] = (chunk, full, full)
        return out

    def _scatter_stored(self, xs: Sequence[Tensor],
                        grads: List[torch.Tensor], stored) -> List:
        """Gradients of the gathered ZeRO-3 variables carried back onto
        their chunks through the gathers' backward (a reduce-scatter)."""
        if not stored:
            return grads
        from ..parallel import comm
        out = []
        with comm.comm_tag("grad_sync"):
            for t, g in zip(xs, grads):
                if t.id in stored:
                    chunk, full, _ = stored[t.id]
                    g = torch.autograd.grad(full, chunk, grad_outputs=g)[0]
                out.append(g)
        return out

    def _all_finite(self, finite: torch.Tensor) -> torch.Tensor:
        """A device bool true on every rank only when it is true on all."""
        from ..parallel import comm
        f = finite.to(torch.float32).reshape(1)
        for a in self.mesh.axis_names:
            f = comm.all_reduce(f, a, "min", self.mesh)
        return f[0] > 0

    def _generators(self, entry: _Plan) -> List[torch.Generator]:
        """The generators the plan's dropout ops draw from, which its
        captured graph must advance on every replay."""
        gens = {id(n.attrs["generator"]): n.attrs["generator"]
                for n in entry.order if n.op_type == "dropout"
                and n.attrs.get("generator") is not None}
        if gens and not capture.can_capture_generators():
            raise RuntimeError(
                "dropout > 0 in a captured training step needs "
                "torch.cuda.CUDAGraph.register_generator_state, which this "
                "torch lacks: a captured graph would replay one frozen mask")
        return list(gens.values())

    def _step(self, entry: _Plan, feeds: Dict[Tensor, torch.Tensor],
              M: int, real_fetches: List[Tensor],
              update_node: Optional[OpNode]) -> List[torch.Tensor]:
        """One step over ``feeds``: every micro-batch's forward and
        gradients, the accumulation and the update; the fetch values."""
        from .amp import check_finite
        from .recompute import offload_context
        plan, frees = entry.order, entry.frees
        xs = update_node.attrs["xs"] if update_node is not None else []
        loss_t = update_node.attrs["grad_node"].attrs["loss"] \
            if update_node is not None else None
        scaler = update_node.attrs.get("grad_scaler") \
            if update_node is not None else None
        if scaler is not None and not scaler.enabled:
            scaler = None
        sst = scaler.init_state(self.device) if scaler is not None else None
        if update_node is not None:
            update_node.attrs["optimizer"]._before_step(self, xs)
        # the JAX package's explicit grad-comm region runs the model on
        # each rank's tokens (nn.moe's gates read this)
        self.dp_local_tokens = update_node is not None and \
            update_node.attrs["optimizer"].dp_local_tokens(
                self, real_fetches, loss_t, scaler)
        needs_grad = update_node is not None or any(
            n.op_type == "gradients" for n in plan)
        offload = (lambda: offload_context(self.device)) \
            if entry.offload and needs_grad else contextlib.nullcontext
        fetch_vals: List[Optional[torch.Tensor]] = [None] * len(real_fetches)
        grads: Optional[List[torch.Tensor]] = None
        stored = self._gather_stored(needs_grad)
        for mb in range(M):
            env: Dict[int, torch.Tensor] = {}
            for tid, val in self._var_data.items():
                env[tid] = val.detach().requires_grad_(True) \
                    if needs_grad and self._var_tensors[tid].trainable \
                    else val
            for tid, (_, _, full) in stored.items():
                env[tid] = full
            leaves = [env[t.id] for t in xs]
            for t, val in feeds.items():
                env[t.id] = val.chunk(M)[mb] if t.ndim else val
            with torch.set_grad_enabled(needs_grad), offload():
                if entry.regions is not None and needs_grad:
                    self._eval_regions(entry, env)
                else:
                    self._eval(plan, env, frees)
                if update_node is not None:
                    lv = env.pop(loss_t.id)
                    obj = lv.sum() if lv.ndim else lv
                    if scaler is not None:
                        obj = scaler.scale_loss(obj, sst)
                        lv = scaler.unscale_loss(obj, sst)
                    g = torch.autograd.grad(obj, leaves, allow_unused=True)
                    g = [torch.zeros_like(x) if gi is None else gi
                         for x, gi in zip(leaves, g)]
                    if scaler is not None:
                        g = scaler.unscale_grads(g, sst)
                    if grads is None:
                        grads = _owned(g) if M > 1 else g
                    else:
                        for a, b in zip(grads, g):
                            a.add_(b)
                    del g
                    if loss_t in real_fetches:
                        env[loss_t.id] = lv
                    del lv
            for i, f in enumerate(real_fetches):
                v = env[f.id].detach()
                if v.ndim == 0 and fetch_vals[i] is not None:
                    v = fetch_vals[i] + v
                fetch_vals[i] = v
            del env, leaves
        if M > 1:
            fetch_vals = [v / M if v.ndim == 0 else v for v in fetch_vals]
        sentry = self._sentry_for(update_node, entry.level)
        if sentry is not None:
            # the chaos seam: the rank's own loss and gradients times the
            # fed code's factor (1.0 when clean), before they are reduced,
            # where a real silent fault would surface
            code = feeds[self._sentry_tensor]
            li = next(i for i, f in enumerate(real_fetches)
                      if f.id == loss_t.id)
            fetch_vals[li] = sentry.inject_loss(fetch_vals[li], code)
            grads = sentry.inject_grads(grads, code)
        dp_axis = update_node.attrs["optimizer"].dp_axis \
            if update_node is not None else "dp"
        from ..parallel import comm
        for axis in [dp_axis] + sorted(self.seq_axes):
            if self.mesh is not None and self.mesh.axis_size(axis) > 1:
                with comm.comm_tag("scalar_fetch"):
                    fetch_vals = [comm.all_reduce(v, axis, "mean", self.mesh)
                                  if v.ndim == 0 else v for v in fetch_vals]
        if update_node is not None:
            if M > 1:
                for g in grads:
                    g.div_(M)
            grads = self._scatter_stored(xs, grads, stored)
            accum = [self._grad_accum.get(x.id) for x in xs]
            if entry.level == RunLevel.GRAD:
                # GRAD: add to the persistent sums, update nothing
                for a, g in zip(accum, grads):
                    a.add_(g)
                return fetch_vals
            # UPDATE: this run's gradients plus the sums of the GRAD runs
            # before it, which it then zeroes
            grads = [g if a is None else g + a for g, a in zip(grads, accum)]
            # a scaler skips the update (parameters and optimizer state)
            # on overflow, then grows or backs off its scale
            finite = check_finite(grads) if scaler is not None else None
            if finite is not None and self.mesh is not None:
                finite = self._all_finite(finite)
            # the sentry's verdict reads the reduced loss and the
            # optimizer's global sum of squares; its ok is ANDed into keep
            check = None
            if sentry is not None:
                loss_v = fetch_vals[li]
                check = lambda sq: sentry.update(loss_v, sq)  # noqa: E731
            update_node.attrs["optimizer"]._apply_updates(
                self, xs, grads, keep=finite, check=check)
            if scaler is not None:
                scaler.update_state(sst, finite)
            for a in accum:
                if a is not None:
                    a.zero_()
            if sentry is not None:
                entry.loss_dtype = fetch_vals[li].dtype
                fetch_vals[li] = sentry.packet(fetch_vals[li])
        return fetch_vals

    def _eval_regions(self, entry: _Plan, env: Dict[int, torch.Tensor]
                      ) -> None:
        """``_eval`` of the plan region by region, each under
        ``torch.utils.checkpoint`` (``graph.recompute``)."""
        from .recompute import run_region
        plan, frees = entry.order, entry.frees
        for r in entry.regions:
            run_region(r, lambda local, r=r: self._eval(
                plan[r.start:r.end], local, frees[r.start:r.end]),
                env, entry.saved)
            for i in range(r.start, r.end):
                for tid in frees[i]:
                    env.pop(tid, None)


def _owned(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Gradients that can be accumulated into in place: a tensor that
    autograd hands to two leaves, or a view (an expanded one, say), is
    copied first."""
    seen, out = set(), []
    for g in grads:
        if id(g) in seen or g._base is not None or not g.is_contiguous():
            g = g.clone()
        seen.add(id(g))
        out.append(g)
    return out


# ---------------------------------------------------------------------------
# graph context (``with ht.graph("define_and_run", device=...)``)
# ---------------------------------------------------------------------------

_graph_stack: List[Graph] = []
_default_graphs: Dict[str, Graph] = {}

_KINDS = {"eager": EagerGraph, "define_by_run": DefineByRunGraph,
          "define_and_run": DefineAndRunGraph}


def get_default_graph() -> Graph:
    """The innermost graph of the ``graph(...)`` contexts; outside them a
    default eager graph on ``"cuda"`` (which raises without a card)."""
    if _graph_stack:
        return _graph_stack[-1]
    if "eager" not in _default_graphs:
        _default_graphs["eager"] = EagerGraph("default_eager", "cuda")
    return _default_graphs["eager"]


class graph:
    """``with graph("define_and_run", device="cuda") as g:`` context;
    ``kind`` is ``"eager"``, ``"define_by_run"`` or ``"define_and_run"``.

    ``device`` (default ``"cuda"``, or the mesh's device) holds the
    variables and feeds and raises without a card unless ``"cpu"`` is
    asked for.  ``mesh`` (``parallel.create_mesh``) makes the graph SPMD
    over its ranks.  ``seed`` seeds
    the graph's initializers and dropout (default: the process-wide
    streams of ``set_seed``).  Without ``create_new`` the graph is cached
    per (prefix, kind, device), as the JAX package caches per (prefix,
    kind)."""

    def __init__(self, kind: Union[str, Graph] = "define_and_run",
                 create_new: bool = False, prefix: str = "default",
                 num_strategy: int = -1, mesh=None, device=None,
                 seed: Optional[int] = None):
        if isinstance(kind, Graph):
            self.g = kind
            if num_strategy >= 1:
                self.g.set_num_strategy(num_strategy)
            return
        if kind not in _KINDS:
            raise ValueError(f"unknown graph kind {kind!r}; have "
                             f"{sorted(_KINDS)}")
        if device is None:
            device = mesh.device if mesh is not None else "cuda"
        dev = resolve_device(device)
        key = f"{prefix}_{kind}_{dev}" + \
            (f"_mesh{id(mesh)}" if mesh is not None else "")
        if create_new or key not in _default_graphs:
            g = _KINDS[kind](key, dev, seed, mesh)
            if not create_new:
                _default_graphs[key] = g
            self.g = g
        else:
            self.g = _default_graphs[key]
        if num_strategy >= 1:
            self.g.set_num_strategy(num_strategy)

    def __enter__(self) -> Graph:
        _graph_stack.append(self.g)
        if self.g.mesh is not None:
            self.g.mesh.__enter__()
        return self.g

    def __exit__(self, *exc):
        if self.g.mesh is not None:
            self.g.mesh.__exit__(*exc)
        _graph_stack.pop()


class run_level:
    """``with run_level("grad"):`` sets the run level that
    ``DefineAndRunGraph.run`` takes when it is given none."""
    _current = RunLevel.UPDATE

    def __init__(self, level: Union[str, RunLevel]):
        self.level = RunLevel(level)

    def __enter__(self):
        self.prev = run_level._current
        run_level._current = self.level
        return self

    def __exit__(self, *exc):
        run_level._current = self.prev


_run_level_ctx = run_level
