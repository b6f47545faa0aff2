"""Activation recompute and host offload (counterpart of
``hetu_tpu.graph.recompute``).

``with ht.recompute(policy, graph=g):`` and ``with ht.cpu_offload(graph=
g):`` set the graph's policy for the runs made inside them, as in the JAX
package; the plan key holds both, so a step captured without recompute
never replays under it.

Recompute runs on ``torch.utils.checkpoint`` (non-reentrant).  The JAX
package checkpoints the whole loss function and leaves the schedule to
XLA; eager torch would then hold every recomputed activation at once, so
the port cuts the plan into regions (``regions``): a cut falls where at
most one activation is live across it (after each residual add of a
transformer, before and after the loss), and a region that holds no
matrix product or attention joins the next.  Each region runs under
``checkpoint``: its forward keeps only its inputs, and the backward
recomputes one region at a time.  The policies map to
``create_selective_checkpoint_contexts``:

- ``"nothing_saveable"`` (default): recompute everything in the region;
- ``"dots_saveable"``: keep the outputs of the matrix products
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``); recompute the rest;
- ``"dots_with_no_batch_dims_saveable"``: keep ``mm``/``addmm`` outputs;
- ``"everything_saveable"``: keep everything (no recompute).

A region's random draws (dropout masks, drawn from the graph's
``torch.Generator``) are always kept: the recomputation reuses the
forward's draw instead of drawing again, so the masks and gradients
equal those of the plain step.  Rewinding the generator instead would
need its state read inside a captured CUDA graph, which CUDA generators
refuse during capture.

``cpu_offload`` runs the forward under ``torch.autograd.graph.
save_on_cpu(pin_memory=True)``: every tensor autograd saves moves to
pinned host memory and back for the backward.  It allocates those host
buffers as it goes, which a CUDA graph cannot replay, so an offloaded
plan runs uncaptured on the card (``DefineAndRunGraph.last_run_captured``
is False).  It replaces the recompute policy, as the JAX package's
offload policy does.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .graph import get_default_graph

_aten = torch.ops.aten
_DOTS = frozenset({_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm})
_POLICIES = {
    "nothing_saveable": frozenset(),
    "dots_saveable": _DOTS,
    "dots_with_no_batch_dims_saveable": frozenset({_aten.mm, _aten.addmm}),
    "everything_saveable": None,
}
# random draws a region keeps rather than redraws
_RANDOM = frozenset({_aten.rand, _aten.rand_like, _aten.randn,
                     _aten.randn_like, _aten.bernoulli, _aten.uniform_,
                     _aten.normal_})
# op types whose work makes a region worth its own checkpoint
_HEAVY = frozenset({"matmul", "linear", "attention",
                    "fused_lm_cross_entropy"})
_STRUCTURAL = ("variable", "placeholder", "constant")


def resolve_policy(name: Optional[str]):
    """The set of aten ops a policy keeps (``None``: no recompute)."""
    if name is None:
        return None
    if name not in _POLICIES:
        raise ValueError(f"unknown recompute policy {name!r}; have "
                         f"{sorted(_POLICIES)}")
    return _POLICIES[name]


class recompute:
    """``with ht.recompute():`` -- recompute activations in the backward
    for the steps run inside it (reference ``python/hetu/__init__.py:232``).

    ``policy``: ``"nothing_saveable"`` (default) | ``"dots_saveable"`` |
    ``"dots_with_no_batch_dims_saveable"`` | ``"everything_saveable"``.
    A falsy ``multi_recompute`` (per-strategy flags) disables it."""

    def __init__(self, policy: str = "nothing_saveable", graph=None,
                 multi_recompute=None):
        if multi_recompute is not None and not any(
                bool(x) for x in _flat(multi_recompute)):
            policy = None
        resolve_policy(policy)
        self.policy_name = policy
        self.graph = graph

    def __enter__(self):
        g = self.graph or get_default_graph()
        self._g = g
        self._prev = getattr(g, "_recompute_policy", None)
        g._recompute_policy = self.policy_name
        return self

    def __exit__(self, *exc):
        self._g._recompute_policy = self._prev


class cpu_offload:
    """``with ht.cpu_offload():`` -- keep saved activations in pinned host
    memory instead of on the device (reference
    ``python/hetu/__init__.py:243``)."""

    def __init__(self, graph=None, multi_cpu_offload=None):
        self.enabled = multi_cpu_offload is None or any(
            bool(x) for x in _flat(multi_cpu_offload))
        self.graph = graph

    def __enter__(self):
        g = self.graph or get_default_graph()
        self._g = g
        self._prev = getattr(g, "_offload", False)
        g._offload = self.enabled
        return self

    def __exit__(self, *exc):
        self._g._offload = self._prev


def _flat(x):
    if isinstance(x, (list, tuple)):
        for y in x:
            yield from _flat(y)
    else:
        yield x


def offload_context(device):
    """The context a step's forward runs under with ``cpu_offload``
    (pinned host buffers for a step on the card)."""
    return torch.autograd.graph.save_on_cpu(
        pin_memory=torch.device(device).type == "cuda")


# ---------------------------------------------------------------------------
# regions of a plan
# ---------------------------------------------------------------------------

class Region:
    """Plan nodes ``[start, end)`` run as one checkpoint: ``inputs`` are
    the tensor ids it reads from before it, ``outputs`` the ids it
    produces that are used after it or fetched."""

    __slots__ = ("start", "end", "inputs", "outputs", "random")

    def __init__(self, start, end, inputs, outputs, random):
        self.start, self.end = start, end
        self.inputs, self.outputs, self.random = inputs, outputs, random


def regions(plan, keep: Sequence[int]) -> List[Region]:
    """The recompute regions of ``plan`` (see the module docstring).
    Raises ``NotImplementedError`` when the plan fetches explicit
    gradients: a ``gradients`` node cannot run inside a checkpoint, and a
    recompute request is never dropped without notice."""
    if any(n.op_type == "gradients" for n in plan):
        raise NotImplementedError(
            "ht.recompute does not cover a plan that fetches explicit "
            "gradients (make_gradients); train through an optimizer's "
            "minimize, or fetch the gradients outside ht.recompute")
    keep = set(keep)
    produced_at: Dict[int, int] = {}
    last_use: Dict[int, int] = {}
    for i, node in enumerate(plan):
        for t in node.inputs:
            last_use[t.id] = i
        if node.op_type not in _STRUCTURAL:
            for t in node.outputs:
                produced_at[t.id] = i
    end = len(plan)
    live_after = [0] * (end + 1)
    for tid, i in produced_at.items():
        last = end if tid in keep else last_use.get(tid, i)
        for c in range(i + 1, last + 1):
            live_after[c] += 1
    cuts = [c for c in range(1, end) if live_after[c] <= 1]
    # a region ends at the first cut after a heavy op; a tail without one
    # joins the last region
    bounds, s = [], 0
    for a, b in zip([0] + cuts, cuts + [end]):
        if any(n.op_type in _HEAVY for n in plan[a:b]):
            bounds.append((s, b))
            s = b
    if s < end:
        bounds[-1:] = [(bounds[-1][0] if bounds else 0, end)]
    out = []
    for s, e in bounds:
        # variables and feeds come from the step's env, as inputs
        inside = {t.id for n in plan[s:e] for t in n.outputs
                  if n.op_type not in ("variable", "placeholder")}
        inputs = list(dict.fromkeys(
            t.id for n in plan[s:e] for t in n.inputs if t.id not in inside))
        outputs = [tid for n in plan[s:e] for tid in (t.id for t in n.outputs)
                   if tid in keep or last_use.get(tid, -1) >= e]
        random = any(n.op_type == "dropout" for n in plan[s:e])
        out.append(Region(s, e, inputs, list(dict.fromkeys(outputs)),
                          random))
    return out


def _policy_fn(saved: frozenset, ctx, op, *args, **kwargs):
    if op.overloadpacket in _RANDOM or op.overloadpacket in saved:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def run_region(region: Region, run, env: Dict[int, torch.Tensor],
               saved: frozenset) -> None:
    """Runs ``run(local_env)`` (the region's nodes) under ``checkpoint``
    on the region's inputs from ``env`` and puts its outputs in
    ``env``."""
    ins = region.inputs

    def fn(*vals):
        local = dict(zip(ins, vals))
        run(local)
        return tuple(local[o] for o in region.outputs)

    kw = {}
    if saved or region.random:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_policy_fn, saved))
    outs = checkpoint(fn, *[env[i] for i in ins], use_reentrant=False,
                      preserve_rng_state=False, **kw)
    env.update(zip(region.outputs, outs))


__all__ = ["cpu_offload", "offload_context", "recompute", "regions",
           "resolve_policy", "run_region"]
