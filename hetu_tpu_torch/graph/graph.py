"""Define-and-run graph (counterpart of ``hetu_tpu.graph.graph``).

Under ``with graph("define_and_run", device=...)`` the ops of
``hetu_tpu_torch.ops.functional`` record ``OpNode``s whose impls are
plain torch functions; shapes and dtypes come from running each impl on
``device="meta"`` tensors (the counterpart of ``jax.eval_shape``).
``DefineAndRunGraph.run(loss, fetches, feed_dict, num_micro_batches)``
then executes the recorded DAG eagerly on the graph's device, with the
JAX package's semantics:

- the feeds are split into ``num_micro_batches`` along dim 0 (0-d feeds
  are replicated); gradients of the (summed) loss accumulate over the
  micro-batches in the parameters' dtype and are divided by M;
- scalar fetches are averaged over the micro-batches, others keep the
  last micro-batch's value;
- the optimizer updates once, and the update op's position in the fetch
  list returns ``None`` (fetch arity is preserved).

The plan (the topological order for one set of fetches, feed shapes,
micro-batch count and run level) is cached in ``_plan_pool``.  Autodiff
is ``torch.autograd.grad`` over the executed forward.

On the card the step is compiled, as the JAX package jits it once per
plan: each plan keeps static feed buffers that ``run`` copies the feeds
into, and a ``core.capture.CapturedStep`` whose first call runs the
whole step (every micro-batch's forward and ``torch.autograd.grad``, the
accumulation and the optimizer update) eagerly and captures it in one
CUDA graph; later calls replay it and return clones of its fetches.  The
graph's dropout generator is registered with each graph, so every replay
draws fresh masks.  On the CPU the step runs eagerly.

The recipe around the step: a ``GradScaler`` passed to ``minimize``
scales the loss, unscales the gradients and skips a non-finite step on
the device (``graph.amp``); ``recompute`` runs the forward as checkpointed
regions and ``cpu_offload`` under ``save_on_cpu`` (``graph.recompute``).
The plan key holds the recompute policy and the offload flag, as the JAX
package's does; an offloaded plan runs uncaptured.  ``run(...,
save_checkpoint=True)`` is accepted and, as in the JAX package, does
nothing: checkpoints are written by ``utils.checkpoint``.  Meshes,
strategy switching, shape buckets, the numeric sentry and the run levels
other than the default (update) and ``COMPUTE_ONLY`` are ported in later
slices and raise ``NotImplementedError``.
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
from .tensor import Tensor

_op_ids = itertools.count()


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

    def __init__(self, name: str = "graph", device="cuda", seed: int = 0):
        self.name = name
        self.device = resolve_device(device)
        self.ops: List[OpNode] = []
        self._var_data: Dict[int, torch.Tensor] = {}
        self._var_tensors: Dict[int, Tensor] = {}
        self._placeholders: Dict[int, Tensor] = {}
        self._consts: Dict[int, Tuple[Any, Tensor]] = {}
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

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
        come from running it on ``meta`` tensors.  One output Tensor, or
        the list of them where ``num_outputs`` > 1 (or the impl returns
        several)."""
        attrs = dict(attrs or {})
        in_tensors = [self.as_tensor(x) for x in inputs]
        node = OpNode(op_type, impl, in_tensors, attrs, name)
        metas = [torch.empty(t.shape, dtype=t.dtype, device="meta")
                 for t in in_tensors]
        with torch.no_grad():
            out = impl(*metas, **attrs)
        flat = list(out) if isinstance(out, (tuple, list)) else [out]
        node.outputs = [
            Tensor(o.shape, o.dtype, producer=node,
                   name=f"{node.name}:{i}" if len(flat) > 1 else node.name,
                   graph=self)
            for i, o in enumerate(flat)]
        self.ops.append(node)
        if num_outputs == 1 and len(node.outputs) == 1:
            return node.outputs[0]
        return node.outputs

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
            val = t.producer.attrs["init_fn"]()
            self._var_data[t.id] = val.to(device=self.device, dtype=t.dtype)
        return self._var_data[t.id]

    def get_tensor_value(self, t: Tensor) -> torch.Tensor:
        if t.id in self._var_tensors:
            return self._materialize_var(t)
        raise ValueError(f"{t.name} has no stored value; fetch it via run()")

    def reset_variable(self, t: Tensor, value) -> None:
        """Overwrite a variable's value (cast to its dtype and device),
        in place where the variable has storage of its shape and dtype,
        so that captured steps keep reading it."""
        data = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.array(value))
        if tuple(data.shape) != t.shape:
            raise ValueError(f"value for {t.name} has shape "
                             f"{tuple(data.shape)}, expected {t.shape}")
        cur = self._var_data.get(t.id)
        if cur is not None and cur.dtype == t.dtype and \
                tuple(cur.shape) == t.shape:
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


class _Plan:
    """A plan-pool entry: the topological order, the frees, the recompute
    regions and the ops they keep (``None``: no recompute), whether the
    forward offloads what it saves, and on the card the static feed
    buffers and the captured step."""

    __slots__ = ("order", "frees", "regions", "saved", "offload", "feeds",
                 "step")

    def __init__(self, order: List[OpNode], frees: List[List[int]],
                 regions=None, saved=None, offload: bool = False):
        self.order, self.frees = order, frees
        self.regions, self.saved, self.offload = regions, saved, offload
        self.feeds: Dict[int, torch.Tensor] = {}
        self.step: Optional[capture.CapturedStep] = None


class DefineAndRunGraph(Graph):
    """Symbolic graph with a plan pool."""

    def __init__(self, name: str = "define_and_run", device="cuda",
                 seed: int = 0):
        super().__init__(name, device, seed)
        self._plan_pool: Dict[Tuple, _Plan] = {}
        self._captures = capture.StepCache("training step")
        self._recompute_policy: Optional[str] = None
        self._offload = False
        self.last_run_captured = False

    def _storage_replaced(self) -> None:
        for entry in self._plan_pool.values():
            entry.step = None
        self._captures.clear()

    @property
    def compile_count(self) -> int:
        """CUDA graphs captured (one a plan); 0 on the CPU."""
        return self._captures.captured

    def switch_strategy(self, *args, **kwargs):
        raise NotImplementedError("switch_strategy (hot switching) is ported "
                                  "with the multi-GPU mesh (ROADMAP queue "
                                  "1, items 10-14)")

    def set_shape_buckets(self, *args, **kwargs):
        raise NotImplementedError("shape buckets come with symbolic dims, "
                                  "in a later slice")

    def inject_numeric_fault(self, *args, **kwargs):
        raise NotImplementedError("the numeric sentry is ported in a later "
                                  "slice (resilience)")

    def _check_feeds(self, feed_dict: Dict[Tensor, Any],
                     num_micro_batches: int) -> Dict[Tensor, torch.Tensor]:
        feeds = {}
        for t, v in feed_dict.items():
            if not isinstance(t, Tensor) or t.id not in self._placeholders:
                raise ValueError(f"feed key {t!r} is not a placeholder of "
                                 f"this graph")
            shape = tuple(v.shape) if isinstance(v, torch.Tensor) \
                else np.shape(v)
            if len(shape) != t.ndim:
                raise ValueError(f"feed for {t.name} has rank {len(shape)}, "
                                 f"expected {t.ndim} ({t.shape})")
            if tuple(shape) != t.shape:
                raise ValueError(f"feed for {t.name} has shape "
                                 f"{tuple(shape)}, expected {t.shape}")
            if t.ndim and t.shape[0] % num_micro_batches:
                raise ValueError(
                    f"batch {t.shape[0]} of {t.name} not divisible by "
                    f"{num_micro_batches} micro-batches")
            feeds[t] = v if isinstance(v, torch.Tensor) else np.asarray(v)
        return feeds

    def _feed_tensors(self, feeds: Dict[Tensor, Any], entry: _Plan,
                      static: bool) -> Dict[Tensor, torch.Tensor]:
        """The feeds as tensors of their placeholders' dtypes on the
        graph's device: new tensors, or with ``static`` copied into the
        plan's static buffers (allocated at its first run)."""
        if not static:
            return {t: torch.as_tensor(v, dtype=t.dtype, device=self.device)
                    for t, v in feeds.items()}
        out = {}
        for t, v in feeds.items():
            buf = entry.feeds.get(t.id)
            if buf is None:
                buf = entry.feeds[t.id] = torch.empty(
                    t.shape, dtype=t.dtype, device=self.device)
            buf.copy_(torch.as_tensor(v, dtype=t.dtype))
            out[t] = buf
        return out

    def _plan(self, fetches: List[Tensor], feeds: Dict[Tensor, Any],
              num_micro_batches: int, run_level: RunLevel,
              update_node: Optional[OpNode]) -> _Plan:
        from .recompute import regions, resolve_policy
        feed_sig = tuple(sorted((t.id, t.shape) for t in feeds))
        key = (tuple(t.id for t in fetches), feed_sig, num_micro_batches,
               run_level, update_node.id if update_node is not None else None,
               # recompute/offload change the step that is captured
               self._recompute_policy, self._offload)
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
            plan = _Plan(order, self._frees(order, keep),
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
        tensors), ``None`` at the position of an optimizer update.  On
        the card the step of each plan is captured at its first run and
        replayed after that (the fetches are clones of the graph's
        outputs); on the CPU, and on the card under ``capture.eager()``,
        it runs eagerly."""
        if cur_strategy_id not in (None, 0):
            raise NotImplementedError(
                "strategy switching (cur_strategy_id) is ported with the "
                "multi-GPU mesh (ROADMAP queue 1, items 10-14)")
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
        if not isinstance(fetches, (list, tuple)):
            fetches = [fetches]
        fetches = list(fetches)
        run_level = RunLevel(run_level) if isinstance(run_level, str) \
            else (run_level or RunLevel.UPDATE)
        if run_level not in (RunLevel.UPDATE, RunLevel.COMPUTE_ONLY):
            raise NotImplementedError(
                f"run level {run_level.value!r} is ported with the "
                f"persistent-gradient slice; this slice runs 'update' and "
                f"'compute_only'")
        M = int(num_micro_batches)
        if M < 1:
            raise ValueError(f"num_micro_batches must be >= 1, got {M}")
        feeds = self._check_feeds(dict(feed_dict or {}), M)

        update_node, real_fetches, update_positions = None, [], []
        for i, f in enumerate(fetches):
            if f.producer is not None and f.producer.op_type == "update":
                update_node = f.producer
                update_positions.append(i)
            else:
                real_fetches.append(f)
        if run_level == RunLevel.COMPUTE_ONLY:
            update_node = None
        entry = self._plan(real_fetches, feeds, M, run_level, update_node)
        for t in self._var_tensors.values():
            self._materialize_var(t)
        feeds = self._feed_tensors(feeds, entry, static)

        def body():
            return self._step(entry, feeds, M, real_fetches, update_node)

        self.last_run_captured = static and self.device.type == "cuda" \
            and not capture.is_eager() and not entry.offload
        if self.last_run_captured:
            if entry.step is None:
                entry.step = self._captures.get(
                    id(entry), body, self._generators(entry))
            fetch_vals = [v.clone() for v in entry.step()]
        else:
            fetch_vals = body()
        out: List[Optional[torch.Tensor]] = list(fetch_vals)
        for i in update_positions:
            out.insert(i, None)
        return out

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
        needs_grad = update_node is not None or any(
            n.op_type == "gradients" for n in plan)
        offload = (lambda: offload_context(self.device)) \
            if entry.offload and needs_grad else contextlib.nullcontext
        fetch_vals: List[Optional[torch.Tensor]] = [None] * len(real_fetches)
        grads: Optional[List[torch.Tensor]] = None
        for mb in range(M):
            env: Dict[int, torch.Tensor] = {}
            for tid, val in self._var_data.items():
                env[tid] = val.detach().requires_grad_(True) \
                    if needs_grad and self._var_tensors[tid].trainable \
                    else val
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
        if update_node is not None:
            if M > 1:
                for g in grads:
                    g.div_(M)
            # a scaler skips the update (parameters and optimizer state)
            # on overflow, then grows or backs off its scale
            finite = check_finite(grads) if scaler is not None else None
            update_node.attrs["optimizer"]._apply_updates(self, xs, grads,
                                                          keep=finite)
            if scaler is not None:
                scaler.update_state(sst, finite)
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


def get_default_graph() -> Graph:
    """The innermost graph of the ``graph(...)`` contexts."""
    if not _graph_stack:
        raise RuntimeError("no graph is active; build under "
                           "`with graph('define_and_run', device=...)`")
    return _graph_stack[-1]


class graph:
    """``with graph("define_and_run", device="cuda") as g:`` context.

    ``device`` (default ``"cuda"``) holds the variables and feeds and
    raises without a card unless ``"cpu"`` is asked for.  Without
    ``create_new`` the graph is cached per (prefix, kind, device), as the
    JAX package caches per (prefix, kind)."""

    def __init__(self, kind: Union[str, Graph] = "define_and_run",
                 create_new: bool = False, prefix: str = "default",
                 num_strategy: int = -1, mesh=None, device="cuda",
                 seed: int = 0):
        if mesh is not None or num_strategy > 1:
            raise NotImplementedError(
                "meshes and multiple strategies are ported with the "
                "multi-GPU mesh (ROADMAP queue 1, items 10-14)")
        if isinstance(kind, Graph):
            self.g = kind
            return
        if kind != "define_and_run":
            raise NotImplementedError(
                f"{kind!r} graphs are ported in a later slice; this slice "
                f"has 'define_and_run'")
        dev = resolve_device(device)
        key = f"{prefix}_{kind}_{dev}"
        if create_new or key not in _default_graphs:
            g = DefineAndRunGraph(key, dev, seed)
            if not create_new:
                _default_graphs[key] = g
            self.g = g
        else:
            self.g = _default_graphs[key]

    def __enter__(self) -> Graph:
        _graph_stack.append(self.g)
        return self.g

    def __exit__(self, *exc):
        _graph_stack.pop()
