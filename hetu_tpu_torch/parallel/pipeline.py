"""Pipeline parallelism: the SPMD stage-hop pipeline (counterpart of
``hetu_tpu.parallel.pipeline``).

The JAX package runs the pipeline as one program on every pp rank: the
blocks' parameters are stacked ``[S, ...]`` and sharded over the ``pp``
mesh axis, and a ``lax.scan`` over ``M + S - 1`` ticks moves the
activations one stage along a ring ``lax.ppermute`` each tick.  SPMD
here is by process, and the same design holds rank by rank: every pp
rank runs the same tick loop on its own stage's parameters, stage 0
reads micro-batch ``clip(t, 0, M - 1)``, each tick but the last ends
with a hop (:func:`comm.permute_group`, tagged ``pipeline/hop``), and
the last stage's outputs are summed over pp (``pipeline/collect``) so
that every pp rank holds them.  The last tick's hop, which the JAX
scan issues, carries nothing any stage reads; the tick index is the
same on every rank, so leaving it out on all of them keeps the ranks'
sequences equal (``M + S - 2`` hops each way).

The backward is autograd through the loop: each hop's backward is the
reverse hop, and the stage body is recomputed in the backward
(``torch.utils.checkpoint``, non-reentrant) around the body alone, so
that the recompute issues no hop.  Every choice that depends on the
rank's stage is a ``torch.where`` on a mask, never a Python branch: each
rank builds the same autograd graph, so each runs every reverse hop in
the same order (a rank that skipped one would leave its peer waiting).
Bubble ticks compute on zeros or on the re-fed last micro-batch; their
outputs are masked out by ``where``, whose backward gives them a zero
gradient exactly (no ``0 * inf``).

The input enters through :func:`comm.copy_to_group` over pp: only stage
0 reads it, and its gradient is summed over pp (the transpose of the
JAX shard_map's pp-replicated input).  The collect is
:func:`comm.reduce_from_group`, whose backward is the identity: what
follows the pipeline (final norm, head, loss) runs on every pp rank
alike.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch

from . import comm
from .comm import comm_tag

PP = "pp"       # the mesh axis the stages lie on


def pipeline_spmd(stage_fn: Callable[[Any, torch.Tensor], Any],
                  stage_params: Any,
                  x: torch.Tensor,
                  num_micro_batches: int,
                  mesh,
                  with_aux: bool = False):
    """Run ``x`` through the ``S`` stages of the mesh's ``pp`` axis.

    ``stage_params``: a dict of this rank's stage's tensors,
    each with a leading stage dim of size 1 (the rank's shard of the
    stacked ``[S, ...]`` value); ``stage_fn(local_params, x_mb)`` applies
    one stage (leaves with the stage dim stripped) and keeps the
    activation's shape.  ``x``: ``[batch, ...]``, split into
    ``num_micro_batches`` along dim 0.  Returns the last stage's outputs
    ``[batch, ...]`` on every pp rank.

    ``with_aux=True``: ``stage_fn`` returns ``(y, aux_scalar)``; the
    result is ``(out, aux)``, aux the micro-batch mean of the stages'
    sums with the bubble ticks masked out (MoE's balance loss).
    """
    S = mesh.axis_size(PP) if mesh is not None else 1
    M = int(num_micro_batches)
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} not divisible by {M} "
                         f"micro-batches")
    if x.is_meta:
        out = x.new_empty(x.shape)
        return (out, x.new_empty((), dtype=torch.float32)) if with_aux \
            else out
    params = {k: p[0] for k, p in stage_params.items()}
    if S == 1:
        outs = [stage_fn(params, mb) for mb in x.chunk(M, 0)]
        if with_aux:
            aux = sum(o[1] for o in outs) / M
            return torch.cat([o[0] for o in outs], 0), aux
        return torch.cat(outs, 0)

    mb = x.shape[0] // M
    stage = mesh.axis_index(PP)
    dev = x.device
    T = M + S - 1
    fwd_perm = [(i, (i + 1) % S) for i in range(S)]

    def uniform(v):
        out = stage_fn(params, v)
        return out if with_aux else (out, torch.zeros((), device=dev))

    def body(v):
        return torch.utils.checkpoint.checkpoint(uniform, v,
                                                 use_reentrant=False)

    def mask(flag: bool) -> torch.Tensor:
        # a fill, not a host copy: a captured step may hold it
        return torch.full((), bool(flag), device=dev)

    is_first, is_last = mask(stage == 0), mask(stage == S - 1)
    # the input's gradient, nonzero on stage 0 alone, summed over pp
    x_mb = comm.copy_to_group(x, PP, mesh).reshape(
        (M, mb) + tuple(x.shape[1:]))
    recv = torch.zeros_like(x_mb[0])
    outs: List[torch.Tensor] = []
    aux_sum = torch.zeros((), device=dev)
    for t in range(T):
        x_in = torch.where(is_first, x_mb[min(t, M - 1)], recv)
        y, aux = body(x_in)
        if not outs:
            outs = [torch.zeros_like(y)] * M
        # this stage holds micro-batch t - stage at this tick
        live = mask(0 <= t - stage < M)
        aux_sum = aux_sum + torch.where(live, aux.float(),
                                        torch.zeros_like(aux_sum))
        # the last stage finishes micro-batch t - (S - 1) at this tick
        out_idx = t - (S - 1)
        safe = min(max(out_idx, 0), M - 1)
        valid = is_last & mask(0 <= out_idx < M)
        outs[safe] = torch.where(valid, y, outs[safe])
        if t < T - 1:
            with comm_tag("pipeline/hop"):
                recv = comm.permute_group(y, PP, fwd_perm, mesh)
    out_buf = torch.stack(outs, 0)
    with comm_tag("pipeline/collect"):
        out = comm.reduce_from_group(out_buf, PP, mesh)
        aux = comm.reduce_from_group(aux_sum, PP, mesh) / M \
            if with_aux else None
    out = out.reshape((M * mb,) + tuple(out.shape[2:]))
    return (out, aux) if with_aux else out


def spmd_hop_schedule(num_micro_batches: int, num_stages: int,
                      with_aux: bool = False):
    """The collectives one SPMD pipeline step issues per rank in its
    forward: ``M + S - 2`` hops (``pipeline/hop``; the JAX package's
    sequence also holds the last tick's, which the port leaves out),
    then the collects (``pipeline/collect``): the outputs, and with
    ``with_aux`` the aux scalar (the JAX package reduces both always;
    the port reduces the aux only when a stage has one).  The backward
    issues the same number of reverse hops and one all-reduce of the
    input's gradient over pp.  Every pp rank issues the same sequence."""
    hops = num_micro_batches + num_stages - 2
    return [("ppermute", "pipeline/hop")] * hops \
        + [("all_reduce", "pipeline/collect")] * (2 if with_aux else 1)


def stack_stage_params(per_layer_params: Sequence[Dict[str, Any]],
                       num_stages: int) -> Dict[str, torch.Tensor]:
    """Stacks ``L`` homogeneous per-layer dicts of tensors into ``[S,
    L/S, ...]`` leaves (dim 0 to be split over pp): equal layer ranges,
    stage after stage."""
    L = len(per_layer_params)
    if L % num_stages:
        raise ValueError(f"{L} layers not divisible into {num_stages} "
                         f"stages")
    keys = list(per_layer_params[0])
    out = {}
    for k in keys:
        st = torch.stack([torch.as_tensor(p[k]) for p in per_layer_params],
                         0)
        out[k] = st.reshape((num_stages, L // num_stages) +
                            tuple(st.shape[1:]))
    return out


__all__ = ["pipeline_spmd", "spmd_hop_schedule", "stack_stage_params"]
