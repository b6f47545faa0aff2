"""MPMD pipeline runtime: one program a stage, driven by one controller
(counterpart of ``hetu_tpu.parallel.pipeline_mpmd``).

Heterogeneous pipelines (Malleus: unequal layers a stage, unequal
micro-batch counts a pipeline) give stages different amounts of work,
which one SPMD program cannot.  As in the JAX package, every stage here
is its own forward function on its own device, and a controller walks
the 1F1B (or GPipe, or interleaved) schedule of
:mod:`hetu_tpu_torch.parallel.schedule`, running each stage's next task
as soon as its input is there:

- a stage's parameters live on its ``device`` (a ``torch.device``; on
  the one card every stage is ``cuda:0``), and the stage-boundary
  activations and gradients move with ``.to(device, non_blocking=True)``
  (the JAX package's ``jax.device_put`` between submeshes);
- a non-last stage stashes only its input and recomputes its forward
  inside the backward, so the live stash follows the schedule's
  in-flight bound (``S - s`` for 1F1B, ``M`` for GPipe); the last stage
  fuses its forward and backward (its B follows its F in every
  schedule);
- :class:`StepStats` keeps the stash peaks (count and bytes), the
  controller's and the final sync's seconds, and ``p2p_log`` records
  every boundary transfer in execution order, which must equal
  :func:`schedule.p2p_events` of the schedule.

A stage with dp or tp inside it (the JAX package's device submeshes)
needs a rank process a stage: ROADMAP queue 1 item 11b.  Registering the
stage programs with the static analyzer is item 18.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..obs.tracer import get_tracer
from .schedule import (Task, generate_gpipe_schedule,
                       generate_interleaved_1f1b_schedule,
                       generate_pipedream_flush_schedule, validate_schedule)

SUBMESH_ITEM = ("a stage with dp or tp inside it needs a rank process a "
                "stage: ROADMAP queue 1 item 11b")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it) if isinstance(tree, torch.Tensor) else tree


def _put(tree, device: Optional[torch.device]):
    """A tree's tensors on ``device`` (the stage-boundary transfer)."""
    if device is None:
        return tree
    return _tree_map(lambda a: a.to(device, non_blocking=True)
                     if isinstance(a, torch.Tensor) else a, tree)


def _tree_bytes(tree) -> int:
    return sum(a.numel() * a.element_size() for a in _leaves(tree))


def _scale_grads(dp, w: float):
    """``dp * w`` with each gradient's dtype kept (a bf16 gradient is not
    promoted by the fp32 weight)."""
    return _tree_map(lambda a: a * w, dp)


def _accum_grads(acc, dp, w: float):
    """``acc += dp * w`` in place, each in its own dtype."""
    for a, b in zip(_leaves(acc), _leaves(dp)):
        a.add_(b, alpha=w)
    return acc


def _check_device(device) -> Optional[torch.device]:
    """A stage's device: ``None`` (where its parameters are) or a
    device; a submesh with dp or tp inside it is refused."""
    if device is None or isinstance(device, (torch.device, str)):
        return None if device is None else torch.device(device)
    shape = getattr(device, "shape", None)
    if isinstance(shape, dict):
        if any(int(n) > 1 for n in shape.values()):
            raise NotImplementedError(SUBMESH_ITEM)
        return torch.device(device.device)
    raise TypeError(f"a stage's device must be a torch.device, got "
                    f"{device!r}")


class Stage:
    """One pipeline stage: a forward function on its device, with the
    backward derived by autograd.

    ``fwd(params, x, seed) -> y`` for a non-last stage; ``fwd(params, x,
    target, seed) -> scalar mean loss`` on the last stage (the loss lives
    with it).  ``params`` is a tree (dicts, lists) of tensors; ``seed``
    (an int) seeds the stage's dropout for the micro-batch, so the
    recompute in the backward draws the forward's masks.  ``device``
    defaults to the device of the parameters.
    """

    def __init__(self, fwd: Callable, params: Any, device=None,
                 is_last: bool = False):
        leaves = _leaves(params)
        dev = _check_device(device)
        self.device = dev if dev is not None else (
            leaves[0].device if leaves else torch.device("cpu"))
        self.params = _put(params, self.device)
        self.is_last = is_last
        self._fwd = fwd

    def _leaf_params(self):
        return _rebuild(self.params, iter(
            [p.detach().requires_grad_(True) for p in _leaves(self.params)]))

    def forward(self, x, seed):
        with torch.no_grad():
            return self._fwd(self.params, x, seed)

    def backward(self, x, seed, dy):
        """Recomputes the forward on the stashed input: (param grads,
        input grad)."""
        params = self._leaf_params()
        xx = x.detach().requires_grad_(x.is_floating_point())
        with torch.enable_grad():
            y = self._fwd(params, xx, seed)
            return self._grads_of(params, y, xx, dy)

    def step_last(self, x, target, seed):
        """The last stage's fused forward and backward: (loss, param
        grads, input grad)."""
        params = self._leaf_params()
        xx = x.detach().requires_grad_(x.is_floating_point())
        with torch.enable_grad():
            loss = self._fwd(params, xx, target, seed)
            dp, dx = self._grads_of(params, loss, xx, None)
        return loss.detach(), dp, dx

    @staticmethod
    def _grads_of(params, out, x, dout):
        leaves = _leaves(params)
        wrt = leaves + ([x] if x.requires_grad else [])
        grads = torch.autograd.grad(out, wrt, grad_outputs=dout,
                                    allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(wrt, grads)]
        dp = _rebuild(params, iter(grads[:len(leaves)]))
        dx = grads[len(leaves)] if x.requires_grad else None
        return dp, dx


@dataclass
class StepStats:
    """One step's accounting."""
    loss: float = 0.0
    # per (pipe, stage)
    stash_peak: List[int] = field(default_factory=list)
    stash_peak_bytes: List[int] = field(default_factory=list)
    schedule: str = ""
    # the controller's host seconds over the task loop (the device works
    # asynchronously under it) and the final loss fetch's, which waits
    # for the device
    controller_seconds: float = 0.0
    sync_seconds: float = 0.0
    num_tasks: int = 0

    @property
    def max_stash(self) -> int:
        return max(self.stash_peak) if self.stash_peak else 0


def _mb_seed(seed: int, p: int, m: int) -> int:
    """The dropout seed of pipeline ``p``'s micro-batch ``m``."""
    return (int(seed) * 1_000_003 + p * 10_007 + m) % (2 ** 62)


class MPMDPipelineRuntime:
    """Drives P pipelines of S stages through a pipeline schedule.

    ``pipes[p]`` is pipeline ``p``'s list of :class:`Stage` (pipelines
    may have different layer counts a stage).  ``train_step`` takes a
    list a pipeline of ``(x_mb, target_mb)`` micro-batches (the lists may
    differ in length: Malleus' micro-batch apportionment) and returns the
    sample-weighted mean loss and each stage's parameter gradients.
    ``schedule``: ``"1f1b"``, ``"gpipe"`` or ``"interleaved"`` (with
    ``num_chunks`` > 1: each pipeline lists ``S * C`` virtual stages,
    chunk ``c`` of physical stage ``s`` at ``c * S + s``).
    """

    def __init__(self, pipes: Sequence[Sequence[Stage]],
                 schedule: str = "1f1b", num_chunks: int = 1):
        if not pipes or any(len(p) != len(pipes[0]) for p in pipes):
            raise ValueError("every pipeline must have the same number of "
                             "stages")
        self.pipes = [list(p) for p in pipes]
        self.num_stages = len(self.pipes[0])
        if schedule not in ("1f1b", "gpipe", "interleaved"):
            raise ValueError(f"unknown schedule {schedule!r}; pick 1f1b | "
                             f"gpipe | interleaved")
        self.schedule_name = schedule
        self.num_chunks = int(num_chunks)
        if schedule == "interleaved" and (
                self.num_chunks < 2 or self.num_stages % self.num_chunks):
            raise ValueError(f"schedule='interleaved' needs num_chunks > 1 "
                             f"dividing the {self.num_stages} stages")
        for p in self.pipes:
            if not p[-1].is_last or any(st.is_last for st in p[:-1]):
                raise ValueError("each pipeline's last stage, and only "
                                 "it, must be is_last")
        # snapshots per (pipe, stage, task) when HETU_MEMORY_PROFILE is set
        from ..utils.profiler import MemoryProfiler
        self.memory_profiler = MemoryProfiler()
        # ("send"|"recv", "F"|"B", pipe, stage, micro_batch, peer stage)
        # for every boundary transfer, in execution order (reset each step)
        self.p2p_log: List[Tuple[str, str, int, int, int, int]] = []

    def _schedule(self, M: int) -> List[List[Task]]:
        if self.schedule_name == "interleaved":
            sched = generate_interleaved_1f1b_schedule(
                self.num_stages // self.num_chunks, M, self.num_chunks)
        else:
            gen = generate_pipedream_flush_schedule \
                if self.schedule_name == "1f1b" else generate_gpipe_schedule
            sched = gen(self.num_stages, M)
        validate_schedule(sched, M)
        return sched

    def train_step(self, data: Sequence[Sequence[Tuple[Any, Any]]],
                   seed: int = 0) -> Tuple[Any, List[List[Any]], StepStats]:
        """One step: ``(mean loss, grads[p][s], stats)``.  ``grads[p][s]``
        matches ``pipes[p][s].params``; each micro-batch's loss is a mean
        over its samples, so the gradients are scaled by ``1 / M_total``:
        the step is one global-batch mean whatever the apportionment."""
        P_n = len(self.pipes)
        counts = [len(d) for d in data]
        if len(data) != P_n or not all(counts):
            raise ValueError(f"micro-batch lists {counts} for {P_n} "
                             f"pipelines")
        M_total = sum(counts)
        S = self.num_stages
        stats = StepStats(schedule=self.schedule_name)
        scheds = [self._schedule(m) for m in counts]
        ptr = [[0] * S for _ in range(P_n)]
        acts: Dict[Tuple[int, int, int], Any] = {}
        stash: Dict[Tuple[int, int, int], Any] = {}
        gin: Dict[Tuple[int, int, int], Any] = {}
        live = [[0] * S for _ in range(P_n)]
        peak = [[0] * S for _ in range(P_n)]
        peak_bytes = [[0] * S for _ in range(P_n)]
        grads: List[List[Any]] = [[None] * S for _ in range(P_n)]
        losses: List[List[torch.Tensor]] = [[] for _ in range(P_n)]
        w = 1.0 / M_total
        self.p2p_log = []
        for p in range(P_n):
            for m, (x_mb, _) in enumerate(data[p]):
                acts[(p, 0, m)] = _put(x_mb, self.pipes[p][0].device)

        def ready(p, s, t: Task) -> bool:
            if t.kind == "F" or s == S - 1:
                return (p, s, t.micro_batch) in acts
            return (p, s, t.micro_batch) in gin

        def run_task(p, s, t: Task) -> None:
            stage = self.pipes[p][s]
            m = t.micro_batch
            seed_pm = _mb_seed(seed, p, m)
            if t.kind == "F":
                if s > 0:
                    self.p2p_log.append(("recv", "F", p, s, m, s - 1))
                x = acts.pop((p, s, m))
                if stage.is_last:
                    acts[(p, s, m)] = x     # F and B fused in the B task
                    return
                y = stage.forward(x, seed_pm)
                stash[(p, s, m)] = x
                live[p][s] += 1
                peak[p][s] = max(peak[p][s], live[p][s])
                peak_bytes[p][s] = max(peak_bytes[p][s],
                                       live[p][s] * _tree_bytes(x))
                acts[(p, s + 1, m)] = _put(y, self.pipes[p][s + 1].device)
                self.p2p_log.append(("send", "F", p, s, m, s + 1))
                return
            if stage.is_last:
                x = acts.pop((p, s, m))
                tgt = _put(data[p][m][1], stage.device)
                loss, dp, dx = stage.step_last(x, tgt, seed_pm)
                losses[p].append(loss)
            else:
                x = stash.pop((p, s, m))
                live[p][s] -= 1
                self.p2p_log.append(("recv", "B", p, s, m, s + 1))
                dp, dx = stage.backward(x, seed_pm, gin.pop((p, s, m)))
            grads[p][s] = _scale_grads(dp, w) if grads[p][s] is None \
                else _accum_grads(grads[p][s], dp, w)
            if s > 0:
                gin[(p, s - 1, m)] = _put(dx, self.pipes[p][s - 1].device)
                self.p2p_log.append(("send", "B", p, s, m, s - 1))

        # round-robin over (pipe, stage): each runs its next task once its
        # input is there (the reference's task loop, one controller)
        remaining = sum(len(s) for sch in scheds for s in sch)
        stats.num_tasks = remaining
        tracer = get_tracer()
        t_ctrl = time.perf_counter()
        while remaining:
            progress = False
            for p in range(P_n):
                for s in range(S):
                    i = ptr[p][s]
                    if i >= len(scheds[p][s]):
                        continue
                    t = scheds[p][s][i]
                    if not ready(p, s, t):
                        continue
                    if tracer.enabled:
                        # the schedule's shape on the host: the device
                        # runs asynchronously under these spans
                        ts = tracer.now()
                        run_task(p, s, t)
                        tracer.complete(f"{t.kind} mb{t.micro_batch}", ts,
                                        tracer.now() - ts,
                                        track=f"pipe{p}/stage{s}", pipe=p,
                                        stage=s, micro_batch=t.micro_batch,
                                        kind=t.kind)
                    else:
                        run_task(p, s, t)
                    if self.memory_profiler.enabled:
                        self.memory_profiler.snapshot(
                            f"pipe{p}.stage{s}.{t.kind}",
                            micro_batch_id=t.micro_batch)
                    ptr[p][s] = i + 1
                    remaining -= 1
                    progress = True
            if not progress:
                raise RuntimeError("pipeline schedule deadlocked")
        stats.controller_seconds = time.perf_counter() - t_ctrl
        # one stacked fetch a pipeline, at the step's end
        t_sync = time.perf_counter()
        loss = sum(float(torch.stack(l).float().sum().cpu())
                   for l in losses if l) / M_total
        stats.sync_seconds = time.perf_counter() - t_sync
        for p in range(P_n):
            stats.stash_peak.extend(peak[p])
            stats.stash_peak_bytes.extend(peak_bytes[p])
        stats.loss = float(loss)
        return loss, grads, stats


def register_stage_executables(*args, **kwargs):
    """The static analyzer's registry is ROADMAP queue 1 item 18."""
    raise NotImplementedError("registering stage programs with the static "
                              "analyzer is ported in ROADMAP queue 1 "
                              "item 18")


def reduce_layer_grads(runtime: MPMDPipelineRuntime, grads: List[List[Any]],
                       layer_keys: List[List[Dict[str, Any]]]
                       ) -> List[List[Any]]:
    """Sums the gradients of entries with one key across pipelines and
    stages (the same logical parameter: a layer of several pipelines, the
    tied ``wte`` of the first and last stage), on the first holder's
    device, and gives every holder the sum.  Entries keyed ``None`` are a
    pipeline's own."""
    locations: Dict[Any, List[Tuple[int, int, Any]]] = {}
    for p in range(len(runtime.pipes)):
        for s, keys in enumerate(layer_keys[p]):
            for name, key in keys.items():
                if key is not None:
                    locations.setdefault(key, []).append((p, s, name))
    for key, locs in locations.items():
        if len(locs) < 2:
            continue
        p0, s0, n0 = locs[0]
        home = runtime.pipes[p0][s0].device
        total = grads[p0][s0][n0]
        for p, s, n in locs[1:]:
            other = _leaves(_put(grads[p][s][n], home))
            total = _rebuild(total, iter(
                [a + b for a, b in zip(_leaves(total), other)]))
        for p, s, n in locs:
            grads[p][s][n] = _put(total, runtime.pipes[p][s].device) \
                if (p, s) != (p0, s0) else total
    return grads


class MPMDAdam:
    """Adam over the stages' parameters, its moments on each stage's
    device.  After :func:`reduce_layer_grads` every copy of a shared
    parameter gets the same gradient, so the same update keeps the copies
    equal without a broadcast."""

    def __init__(self, runtime: MPMDPipelineRuntime, lr: float = 1e-3,
                 beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.runtime = runtime
        self.hp = (lr, beta1, beta2, eps, weight_decay)
        self.t = 0
        self.m = [[_tree_map(torch.zeros_like, st.params) for st in pipe]
                  for pipe in runtime.pipes]
        self.v = [[_tree_map(torch.zeros_like, st.params) for st in pipe]
                  for pipe in runtime.pipes]

    @torch.no_grad()
    def apply(self, grads: List[List[Any]]) -> None:
        self.t += 1
        lr, b1, b2, eps, wd = self.hp
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, pipe in enumerate(self.runtime.pipes):
            for s, stage in enumerate(pipe):
                if grads[p][s] is None:
                    continue
                for w, g, m, v in zip(_leaves(stage.params),
                                      _leaves(grads[p][s]),
                                      _leaves(self.m[p][s]),
                                      _leaves(self.v[p][s])):
                    m.mul_(b1).add_(g, alpha=1 - b1)
                    v.mul_(b2).addcmul_(g, g, value=1 - b2)
                    step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
                    if wd:
                        step = step + lr * wd * w
                    w.sub_(step)


__all__ = ["Stage", "StepStats", "MPMDPipelineRuntime", "MPMDAdam",
           "reduce_layer_grads", "register_stage_executables",
           "SUBMESH_ITEM"]
