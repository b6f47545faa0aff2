"""Mixture of experts with expert parallelism (counterpart of
``hetu_tpu.nn.moe``).

Dispatch is the GShard form, as in the JAX package: a gate builds
``dispatch`` and ``combine`` ``[T, E, C]`` tensors from its top choices
and the per-expert capacity ``C``, the tokens go to the experts by one
einsum, the stacked experts ``[E, ...]`` run as two batched products,
and the outputs come back by another einsum.  ``dispatch_mode=
"dropless"`` routes through the blocked group GEMM
(``ops.moe_dispatch``) instead, dropping no token.

Gates (the reference's v1 gates): :class:`TopKGate`, :class:`KTop1Gate`,
:class:`HashGate`, :class:`SAMGate`, :class:`BalanceGate`.  Top-k
choices break ties toward the lower expert index, as ``lax.top_k``
does (a stable descending sort); ``argmax`` takes the first maximum.

The JAX layer is written in the global view: with a data-parallel mesh
the gate routes the global batch (the capacity from the global token
count, a token's slot counting the tokens of lower dp shards first,
choice by choice, and the balance loss over global means), and GSPMD
moves the data.  Here each rank holds its dp shard's tokens, and the
gate gives the same numbers: it gathers the per-expert counts of every
choice over dp for the slot offsets, and reduces the balance loss's
token means over dp (their backward scaled by dp, as the loss's own dp
sum is, since the optimizer averages the gradients over dp).  The
slots of different dp shards are disjoint and each rank combines only
its own tokens, so a rank runs the experts on its own dispatched
tensor: nothing of it needs summing over dp.

Expert parallelism (``ep_axis``): tokens repeat over ep, and the
experts' weights ``[E, ...]`` are split over it on dim 0.  A rank takes
its experts' part of the dispatched ``[E, C, d]`` (``comm.
split_to_group``: no communication; its backward all-gathers the
gradient over ep, each rank having computed its experts' share), runs
them, and gathers the outputs over ep for the combine (``comm.
gather_output``: an all-gather whose backward keeps the rank's slice,
since every ep rank combines the same tokens).  Every collective is
recorded by ``comm.comm_stats()``.

Where the JAX package runs the model inside its explicit grad-comm
region (a mesh of dp alone, an optimizer with ``grad_comm`` and ZeRO
below 3 or the flat layout), the layer sees each rank's own tokens:
the gate then routes them alone (``Graph.dp_local_tokens``, set for the
step by the optimizer).  Dropless dispatch with ``ep_axis`` is refused
with the JAX package's words.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..graph.ctor import (ConstantInitializer, Initializer,
                          NormalInitializer, XavierNormalInitializer,
                          parallel_parameter)
from ..ops import functional as ops
from ..ops.moe_dispatch import blocked_group_gemm, capacity_tokens
from ..parallel import comm
from ..parallel.mesh import P
from .module import Module
from .parallel import _active, _comm_op, _mesh_of

ACTIVATIONS = {"relu": torch.relu,
               "gelu": lambda x: F.gelu(x, approximate="tanh"),
               "silu": F.silu}


def _one_hot(idx: torch.Tensor, n: int, dtype=torch.float32):
    """One-hot rows (an index outside ``[0, n)`` gives a zero row, as
    ``jax.nn.one_hot``), by comparison: no host read-back."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k``: the ``k`` largest values and their indices along the
    last dim, ties toward the lower index (a stable descending sort)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


# ---------------------------------------------------------------------------
# the tokens a gate routes over
# ---------------------------------------------------------------------------

class _Tokens:
    """The tokens a gate routes: this rank's ``n_local``, and under data
    parallelism the global batch's (``n`` dp shards, this rank's the
    ``index``-th block of the global order)."""

    def __init__(self, n_local: int, mesh=None, dp_axis: Optional[str] = None,
                 graph=None):
        self.mesh, self.axis = mesh, dp_axis
        local = graph is not None and getattr(graph, "dp_local_tokens",
                                              False)
        self.n = mesh.axis_size(dp_axis) if mesh is not None and dp_axis \
            and not local else 1
        self.index = mesh.axis_index(dp_axis) if self.n > 1 else 0
        self.T = int(n_local) * self.n

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the global tokens of ``x [T, ...]``; its backward
        to this rank's rows scaled by the dp size (the optimizer averages
        over dp)."""
        if self.n == 1:
            return x.mean(0)
        return comm.reduce_from_group(x.sum(0), self.axis, self.mesh,
                                      grad_scale=self.n) / self.T

    def offsets(self, counts: torch.Tensor) -> torch.Tensor:
        """Each choice's slot offset ``[k, E]`` from this rank's per-choice
        counts ``[k, E]``: every rank's tokens of the earlier choices, then
        the lower dp shards' of this choice."""
        if self.n == 1:
            return torch.cumsum(counts, 0) - counts
        every = comm.all_gather(counts[None], self.axis, 0, self.mesh)
        total = every.sum(0)
        return torch.cumsum(total, 0) - total + every[:self.index].sum(0)

    def logsumexp(self, x: torch.Tensor) -> torch.Tensor:
        """``logsumexp`` over the global tokens (dim 0), kept dims; no
        gradient (Sinkhorn's balancing picks indices)."""
        if self.n == 1:
            return torch.logsumexp(x, 0, keepdim=True)
        m = comm.all_reduce(x.amax(0, keepdim=True), self.axis, "max",
                            self.mesh)
        s = comm.all_reduce(torch.exp(x - m).sum(0, keepdim=True), self.axis,
                            "sum", self.mesh)
        return m + torch.log(s)


# ---------------------------------------------------------------------------
# gating maths (static shapes, no host read-back)
# ---------------------------------------------------------------------------

def _balance_loss(gates, mask, tok: _Tokens):
    """l_aux = E * sum_e mean_t(gates) * mean_t(mask) (TopGate.py
    balance_loss), the means over the routed tokens."""
    num_experts = gates.shape[-1]
    return torch.sum(tok.mean(gates) * tok.mean(mask.to(gates.dtype))) \
        * num_experts


def _positions_in_expert(mask, offset=None):
    """Per-token slot index within its expert: the running count of
    earlier tokens routed to the same expert. [T, E] -> [T]."""
    pos = torch.cumsum(mask, 0) - 1
    if offset is not None:
        pos = pos + offset
    return torch.sum(pos * mask, 1)


def _dispatch_combine(masks, gate_vals, capacity: int, tok: _Tokens):
    """Dispatch [T, E, C] (0/1) and combine [T, E, C] (gate-weighted) from
    per-choice expert masks (choice order is priority order) and gate
    values; a choice's slots start after every earlier choice's."""
    offsets = tok.offsets(torch.stack([m.sum(0) for m in masks]))
    dispatch = combine = None
    for i, (mask, gv) in enumerate(zip(masks, gate_vals)):
        loc = _positions_in_expert(mask, offsets[i][None])       # [T]
        keep = (loc < capacity).to(mask.dtype)                   # drop
        slot = _one_hot(loc.long(), capacity, mask.dtype)        # [T, C]
        d = (mask * keep[:, None])[:, :, None] * slot[:, None, :]
        c = gv[:, None, None] * d.to(gv.dtype)
        dispatch = d if dispatch is None else dispatch + d
        combine = c if combine is None else combine + c
    return dispatch, combine


def topk_gating_impl(logits, k, capacity_factor, tok=None):
    """GShard top-k gating (TopGate.py topkgating): (l_aux, combine,
    dispatch)."""
    T, E = logits.shape
    tok = tok or _Tokens(T)
    gates = torch.softmax(logits.float(), -1)
    capacity = capacity_tokens(tok.T, E, k, capacity_factor)
    _, idx = top_k(gates, k)
    masks, gate_vals, l_aux = [], [], 0.0
    for i in range(k):
        m = _one_hot(idx[:, i], E)
        masks.append(m)
        gate_vals.append(torch.sum(gates * m, 1))
        l_aux = l_aux + _balance_loss(gates, m, tok)
    dispatch, combine = _dispatch_combine(masks, gate_vals, capacity, tok)
    return l_aux, combine, dispatch


def ktop1_gating_impl(logits, k, capacity_factor, tok=None):
    """k prototypes, each routing top-1 over E/k experts (KTop1Gate.py)."""
    T, E = logits.shape
    assert E % k == 0, "num_experts must divide into k prototypes"
    tok = tok or _Tokens(T)
    Ep = E // k
    proto = torch.softmax(logits.float().reshape(T, k, Ep), -1)
    capacity = capacity_tokens(tok.T, E, k, capacity_factor)
    masks, gate_vals, l_aux = [], [], 0.0
    for i in range(k):
        g = proto[:, i, :]
        best, idx = g.max(-1)
        m = _one_hot(idx + i * Ep, E)
        masks.append(m)
        gate_vals.append(best)
        l_aux = l_aux + _balance_loss(g, m[:, i * Ep:(i + 1) * Ep], tok)
    dispatch, combine = _dispatch_combine(masks, gate_vals, capacity, tok)
    return l_aux, combine, dispatch


def hash_gating_impl(indices, num_experts, capacity_factor, tok=None):
    """Static hash routing (HashGate.py): each token's expert is given
    (``token_id % E``), its gate weight 1."""
    T = indices.shape[0]
    tok = tok or _Tokens(T)
    capacity = capacity_tokens(tok.T, num_experts, 1, capacity_factor)
    m = _one_hot(indices.long(), num_experts)
    dispatch, combine = _dispatch_combine(
        [m], [torch.ones(T, device=m.device)], capacity, tok)
    return torch.zeros((), device=m.device), combine, dispatch


def sam_gating_impl(logits, k, capacity_factor, num_groups, tok=None):
    """Switch-aware gating (SAMGate.py): the top-1 expert group, then the
    top-k experts inside it; balance loss minus the alignment on the
    chosen group."""
    T, E = logits.shape
    assert E % num_groups == 0
    tok = tok or _Tokens(T)
    Eg = E // num_groups
    gates = torch.softmax(logits.float(), -1)
    grouped = gates.reshape(T, num_groups, Eg)
    group_sum = grouped.sum(-1)                                 # [T, G]
    top_group = torch.argmax(group_sum, -1)                     # [T]
    group_mask = _one_hot(top_group, num_groups)                # [T, G]
    local = torch.einsum("tge,tg->te", grouped, group_mask)    # [T, Eg]
    capacity = capacity_tokens(tok.T, E, k, capacity_factor)
    _, topk_local = top_k(local, k)
    base = top_group * Eg
    masks, gate_vals, l_aux = [], [], 0.0
    for i in range(k):
        m = _one_hot(base + topk_local[:, i], E)
        masks.append(m)
        gate_vals.append(torch.sum(gates * m, 1))
        l_aux = l_aux + _balance_loss(gates, m, tok)
    # alignment: reward concentration on the selected group
    l_align = torch.sum(tok.mean(group_sum * group_mask))
    l_aux = l_aux - l_align
    dispatch, combine = _dispatch_combine(masks, gate_vals, capacity, tok)
    return l_aux, combine, dispatch


def balance_gating_impl(scores, capacity_factor, n_iters=10, tok=None):
    """BASE-layer balanced assignment (BalanceGate.py): Sinkhorn-balance
    the token-expert scores so every expert receives about T/E tokens,
    then the greedy pick; gate weight sigmoid(score)."""
    T, E = scores.shape
    tok = tok or _Tokens(T)
    s = scores.float()
    with torch.no_grad():
        logp = torch.log_softmax(s, -1)
        for _ in range(n_iters):
            logp = logp - tok.logsumexp(logp)                    # columns
            logp = logp - torch.logsumexp(logp, 1, keepdim=True)  # rows
        m = _one_hot(torch.argmax(logp, -1), E)
    capacity = capacity_tokens(tok.T, E, 1, capacity_factor)
    gv = torch.sigmoid(torch.sum(s * m, 1))
    dispatch, combine = _dispatch_combine([m], [gv], capacity, tok)
    return torch.zeros((), device=s.device), combine, dispatch


def _gate_op(x, *, fn, capacity_k, num_experts, capacity_factor, mesh=None,
             dp_axis=None, graph=None, **kw):
    """A gating impl as one graph op over ``x`` (the logits, or the hash
    gate's expert ids), routed over the tokens of :class:`_Tokens`."""
    tok = _Tokens(x.shape[0], mesh, dp_axis, graph)
    if x.is_meta:
        C = capacity_tokens(tok.T, num_experts, capacity_k, capacity_factor)
        full = x.new_empty((x.shape[0], num_experts, C), dtype=torch.float32)
        return x.new_empty((), dtype=torch.float32), full, full
    return fn(x, tok=tok, num_experts=num_experts,
              capacity_factor=capacity_factor, **kw)


# ---------------------------------------------------------------------------
# gate modules
# ---------------------------------------------------------------------------

class _GateBase(Module):
    """Learned router: Linear(d_model -> num_experts) and a gating impl."""

    def __init__(self, embed_dim: int, num_experts: int,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0,
                 init: Optional[Initializer] = None, dtype=None,
                 name: str = "gate"):
        super().__init__()
        self.embed_dim, self.num_experts = embed_dim, num_experts
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.wg = parallel_parameter(
            init or XavierNormalInitializer(), (num_experts, embed_dim),
            pspec=P(), dtype=dtype, name=f"{name}.wg")

    def _cf(self):
        return self.capacity_factor if self.training \
            else self.eval_capacity_factor

    def logits(self, x):
        return ops.linear(x, self.wg, None, trans_b=True)

    def _route(self, op_type, fn, x, capacity_k, dp_axis, **kw):
        mesh = _mesh_of(x)
        return ops._op(op_type, _gate_op, [x],
                       {"fn": fn, "capacity_k": capacity_k,
                        "num_experts": self.num_experts,
                        "capacity_factor": self._cf(), "mesh": mesh,
                        "dp_axis": dp_axis, "graph": getattr(x, "graph", None),
                        **kw}, num_outputs=3)


class TopKGate(_GateBase):
    """GShard top-k gate with capacity and the balance loss (TopGate.py)."""

    def __init__(self, embed_dim, num_experts, k: int = 1, **kw):
        super().__init__(embed_dim, num_experts, **kw)
        self.k = k

    def forward(self, x, dp_axis: Optional[str] = "dp"):
        return self._route("topk_gate", _topk_fn, self.logits(x), self.k,
                           dp_axis, k=self.k)


class KTop1Gate(_GateBase):
    """k prototypes x top-1 gate (KTop1Gate.py)."""

    def __init__(self, embed_dim, num_experts, k: int = 2, **kw):
        super().__init__(embed_dim, num_experts, **kw)
        self.k = k

    def forward(self, x, dp_axis: Optional[str] = "dp"):
        return self._route("ktop1_gate", _ktop1_fn, self.logits(x), self.k,
                           dp_axis, k=self.k)


class HashGate(Module):
    """Static hash routing (HashGate.py): no learned parameters."""

    def __init__(self, num_experts: int, capacity_factor: float = 1.0):
        super().__init__()
        self.num_experts, self.capacity_factor = num_experts, capacity_factor

    def forward(self, x, token_ids, dp_axis: Optional[str] = "dp"):
        E = self.num_experts
        ids = ops.reshape(token_ids, (-1,))
        return ops._op("hash_gate", _gate_op, [ids],
                       {"fn": _hash_fn, "capacity_k": 1, "num_experts": E,
                        "capacity_factor": self.capacity_factor,
                        "mesh": _mesh_of(ids), "dp_axis": dp_axis,
                        "graph": getattr(ids, "graph", None)},
                       num_outputs=3)


class SAMGate(_GateBase):
    """Switch-aware top-group-then-top-k gate (SAMGate.py)."""

    def __init__(self, embed_dim, num_experts, k: int = 2,
                 num_groups: int = 1, **kw):
        super().__init__(embed_dim, num_experts, **kw)
        self.k, self.num_groups = k, num_groups

    def forward(self, x, dp_axis: Optional[str] = "dp"):
        return self._route("sam_gate", _sam_fn, self.logits(x), self.k,
                           dp_axis, k=self.k, num_groups=self.num_groups)


class BalanceGate(_GateBase):
    """BASE-layer balanced-assignment gate (BalanceGate.py); the router
    weights act as expert centroids."""

    def __init__(self, embed_dim, num_experts, n_iters: int = 10, **kw):
        super().__init__(embed_dim, num_experts, **kw)
        self.n_iters = n_iters

    def forward(self, x, dp_axis: Optional[str] = "dp"):
        return self._route("balance_gate", _balance_fn, self.logits(x), 1,
                           dp_axis, n_iters=self.n_iters)


def _topk_fn(lg, tok, k, capacity_factor, **_):
    return topk_gating_impl(lg, k, capacity_factor, tok)


def _ktop1_fn(lg, tok, k, capacity_factor, **_):
    return ktop1_gating_impl(lg, k, capacity_factor, tok)


def _hash_fn(ids, tok, num_experts, capacity_factor, **_):
    return hash_gating_impl(ids % num_experts, num_experts, capacity_factor,
                            tok)


def _sam_fn(lg, tok, k, num_groups, capacity_factor, **_):
    return sam_gating_impl(lg, k, capacity_factor, num_groups, tok)


def _balance_fn(lg, tok, n_iters, capacity_factor, **_):
    return balance_gating_impl(lg, capacity_factor, n_iters, tok)


# ---------------------------------------------------------------------------
# experts and the MoE layer
# ---------------------------------------------------------------------------

def _experts_ffn(x, w1, b1, w2, b2, act="relu"):
    """``[E, C, d] -> [E, C, d]`` through the stacked experts, each product
    in its operands' promoted dtype (``jnp.einsum``'s)."""
    dt = torch.promote_types(x.dtype, w1.dtype)
    h = ACTIVATIONS[act](torch.bmm(x.to(dt), w1.to(dt)) + b1)
    dt = torch.promote_types(h.dtype, w2.dtype)
    return torch.bmm(h.to(dt), w2.to(dt)) + b2


class Experts(Module):
    """E feed-forward experts with stacked weights ``[E, ...]``, run as
    batched products (reference Expert, moe_layer.py:7), split over
    ``ep_axis`` on dim 0."""

    def __init__(self, num_experts: int, embed_dim: int, ffn_dim: int,
                 activation: str = "relu", ep_axis: Optional[str] = None,
                 dtype=None, init: Optional[Initializer] = None,
                 name: str = "experts"):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise KeyError(activation)
        self.num_experts = num_experts
        self.activation = activation
        self.ep_axis = ep_axis
        espec = P(ep_axis, None, None) if ep_axis else P()
        self.w1 = parallel_parameter(
            init or NormalInitializer(0.0, 0.02),
            (num_experts, embed_dim, ffn_dim), pspec=espec,
            dtype=dtype, name=f"{name}.w1")
        self.w2 = parallel_parameter(
            init or NormalInitializer(0.0, 0.02),
            (num_experts, ffn_dim, embed_dim), pspec=espec,
            dtype=dtype, name=f"{name}.w2")
        self.b1 = parallel_parameter(
            ConstantInitializer(0.0), (num_experts, 1, ffn_dim),
            pspec=espec, dtype=dtype, name=f"{name}.b1")
        self.b2 = parallel_parameter(
            ConstantInitializer(0.0), (num_experts, 1, embed_dim),
            pspec=espec, dtype=dtype, name=f"{name}.b2")

    def forward(self, dispatched):
        """dispatched: [E (this rank's experts), C, d] -> [E, C, d]."""
        return ops._op("experts_ffn", _experts_ffn,
                       [dispatched, self.w1, self.b1, self.w2, self.b2],
                       {"act": self.activation})


def _dropless_impl(xt, logits, w1, b1, w2, b2, *, k, act_name, mesh=None,
                   dp_axis=None, graph=None):
    """Capacity-free top-k dispatch through the blocked group GEMM: no
    token dropped.  The balance loss's means are over the routed
    tokens."""
    if xt.is_meta:
        return xt.new_empty(xt.shape), xt.new_empty((), dtype=torch.float32)
    tok = _Tokens(xt.shape[0], mesh, dp_axis, graph)
    gates = torch.softmax(logits.float(), -1)
    topv, topi = top_k(gates, k)
    out = blocked_group_gemm(xt.float(), topi, topv, w1, b1, w2, b2,
                             ACTIVATIONS[act_name])
    l_aux = torch.zeros((), device=xt.device)
    for i in range(k):
        l_aux = l_aux + _balance_loss(gates, _one_hot(topi[:, i],
                                                      gates.shape[-1]), tok)
    return out.to(xt.dtype), l_aux


class MoELayer(Module):
    """Gated mixture-of-experts layer (reference MoELayer, moe_layer.py:45).

    Dataflow (T tokens, E experts, C capacity, d embed):
      gate(x)              -> l_aux, combine [T,E,C], dispatch [T,E,C]
      dispatch^T . x       -> [E, C, d]     (the rank's E/ep over ``ep_axis``)
      experts              -> [E, C, d]     (batched products)
      combine . expert_out -> [T, d]        (outputs gathered over ep)

    ``dispatch_mode``: ``"capacity"`` (default; tokens beyond an expert's
    capacity are dropped) or ``"dropless"`` (the blocked group GEMM; needs
    a :class:`TopKGate`, runs the experts locally, takes no ``ep_axis``).
    """

    def __init__(self, gate: Module, experts: Experts,
                 ep_axis: Optional[str] = None,
                 dp_axis: Optional[str] = "dp",
                 dispatch_mode: str = "capacity"):
        super().__init__()
        if dispatch_mode not in ("capacity", "dropless"):
            raise ValueError(f"dispatch_mode must be 'capacity' or "
                             f"'dropless', got {dispatch_mode!r}")
        if dispatch_mode == "dropless":
            if not isinstance(gate, TopKGate):
                raise ValueError("dropless dispatch needs a TopKGate "
                                 "(top-k ids/weights feed the group-GEMM)")
            if ep_axis:
                raise ValueError("dropless dispatch is a local expert "
                                 "compute; ep_axis sharding is not "
                                 "supported (use dispatch_mode='capacity')")
        self.gate = gate
        self.experts = experts
        self.ep_axis, self.dp_axis = ep_axis, dp_axis
        self.dispatch_mode = dispatch_mode

    def _record_analysis_meta(self, xt, capacity: Optional[int],
                              dtype) -> None:
        """The layer's dispatch bounds as a plain record on the graph's
        ``_moe_meta`` list (its reader, the static analyzer, comes with a
        later slice); none while the token count is symbolic."""
        g = getattr(xt, "graph", None)
        if g is None or not hasattr(g, "_moe_meta"):
            return
        try:
            T, d = (int(s) for s in xt.shape)
        except (TypeError, ValueError):         # a symbolic batch dim
            return
        gate = self.gate
        g._moe_meta.append({
            "name": getattr(self.experts.w1, "name", "moe"),
            "tokens": T, "embed_dim": d,
            "num_experts": self.experts.num_experts,
            "k": getattr(gate, "k", 1),
            "capacity_factor": getattr(gate, "capacity_factor", 1.0)
            if getattr(gate, "training", True)
            else getattr(gate, "eval_capacity_factor", 1.0),
            "capacity": capacity, "dispatch_mode": self.dispatch_mode,
            "ep_axis": self.ep_axis,
            "dtype": str(dtype).replace("torch.", "")})

    def forward(self, x, token_ids=None):
        """x: [..., d] -> (out [..., d], l_aux)."""
        orig_shape = tuple(x.shape)
        d = orig_shape[-1]
        xt = ops.reshape(x, (-1, d))                              # [T, d]
        mesh = _mesh_of(xt)
        if self.dispatch_mode == "dropless":
            self._record_analysis_meta(xt, None, xt.dtype)
            out, l_aux = ops._op(
                "moe_dropless", _dropless_impl,
                [xt, self.gate.logits(xt), self.experts.w1,
                 self.experts.b1, self.experts.w2, self.experts.b2],
                {"k": self.gate.k, "act_name": self.experts.activation,
                 "mesh": mesh, "dp_axis": self.dp_axis,
                 "graph": getattr(xt, "graph", None)}, num_outputs=2)
            return ops.reshape(out, (-1,) + orig_shape[1:]), l_aux
        if isinstance(self.gate, HashGate):
            if token_ids is None:
                raise ValueError("HashGate needs token_ids")
            l_aux, combine, dispatch = self.gate(xt, token_ids,
                                                 dp_axis=self.dp_axis)
        else:
            l_aux, combine, dispatch = self.gate(xt, dp_axis=self.dp_axis)
        dispatched = ops.einsum("tec,td->ecd", dispatch, xt)      # [E, C, d]
        self._record_analysis_meta(xt, int(dispatch.shape[-1]),
                                   dispatched.dtype)
        ep = _active(dispatched, self.ep_axis)
        if ep is not None:
            dispatched = _comm_op(
                "moe_ep_split", lambda v, mesh, axis: comm.split_to_group(
                    v, axis, 0, mesh), dispatched, ep, axis=self.ep_axis)
        eout = self.experts(dispatched)
        if ep is not None:
            eout = _comm_op(
                "moe_ep_gather", lambda v, mesh, axis: comm.gather_output(
                    v, axis, 0, mesh), eout, ep, axis=self.ep_axis)
        out = ops.einsum("tec,ecd->td", combine, eout)            # [T, d]
        return ops.reshape(out, (-1,) + orig_shape[1:]), l_aux


def make_moe_layer(embed_dim: int, ffn_dim: int, num_experts: int,
                   gate_type: str = "topk", k: int = 2,
                   capacity_factor: float = 1.0,
                   eval_capacity_factor: Optional[float] = None,
                   activation: str = "gelu",
                   ep_axis: Optional[str] = None,
                   num_groups: int = 1, dtype=None,
                   dispatch_mode: str = "capacity",
                   name: str = "moe", dp_axis: Optional[str] = "dp"
                   ) -> MoELayer:
    """The reference example's wiring (``v1/examples/moe/``)."""
    if eval_capacity_factor is None:
        eval_capacity_factor = capacity_factor
    kw = dict(capacity_factor=capacity_factor,
              eval_capacity_factor=eval_capacity_factor, dtype=dtype,
              name=f"{name}.gate")
    if gate_type == "topk":
        gate = TopKGate(embed_dim, num_experts, k=k, **kw)
    elif gate_type == "ktop1":
        gate = KTop1Gate(embed_dim, num_experts, k=k, **kw)
    elif gate_type == "hash":
        gate = HashGate(num_experts, capacity_factor)
    elif gate_type == "sam":
        gate = SAMGate(embed_dim, num_experts, k=k, num_groups=num_groups,
                       **kw)
    elif gate_type == "balance":
        gate = BalanceGate(embed_dim, num_experts, **kw)
    else:
        raise ValueError(f"unknown gate_type {gate_type!r}")
    experts = Experts(num_experts, embed_dim, ffn_dim,
                      activation=activation, ep_axis=ep_axis, dtype=dtype,
                      name=f"{name}.experts")
    return MoELayer(gate, experts, ep_axis=ep_axis, dp_axis=dp_axis,
                    dispatch_mode=dispatch_mode)


__all__ = ["TopKGate", "KTop1Gate", "HashGate", "SAMGate", "BalanceGate",
           "Experts", "MoELayer", "make_moe_layer", "topk_gating_impl",
           "ktop1_gating_impl", "hash_gating_impl", "sam_gating_impl",
           "balance_gating_impl", "top_k"]
