"""Pipeline-parallel GPT: the transformer blocks as stacked pp stages
(counterpart of ``hetu_tpu.models.gpt_pipeline``).

Embedding, final norm and LM head live outside the pipeline, on every
pp rank alike; the homogeneous block stack runs through
:func:`parallel.pipeline.pipeline_spmd` as one graph op.  The blocks'
weights are stacked ``[S, L/S, ...]`` under ``P("pp", None, ...)``, so
each rank holds its stage's layers; the fused ``[q|k|v]`` and SwiGLU
``mlp_up`` weights are split over tp block by block along their dim 2.

:func:`block_fn` is a function on tensors that follows the JAX
package's own arithmetic: RMSNorm in fp32 then a cast, LayerNorm in the
input's dtype, rotary tables cast to the activations' dtype, kv heads
repeated before the head split, tanh-GELU, and causal attention through
``ops.attention.sdpa`` (the flash kernels on the card).  Tensor
parallelism inside a stage issues the collectives of ``nn.parallel``'s
layers (Megatron-LM's column and row pairs, and with ``sp`` the
sequence gather and reduce-scatter), as ``models.gpt`` does.

An MoE config (``num_experts > 0``, every layer MoE as in the JAX
package) stacks ``moe_gate``, ``moe_w1``, ``moe_b1``, ``moe_w2`` and
``moe_b2`` in place of the MLP's weights, the experts split over
``cfg.ep_axis`` on their dim 2; :func:`_moe_mlp` is the JAX pipeline's
GShard block (the dispatch and combine tensors cast to the activations'
dtype), routed over the global micro-batch as ``nn.moe``'s gates route
(the ids and labels are fed micro-batch by micro-batch, so that each
rank's pipeline micro-batch is its shard of the global one), with the
experts' outputs gathered over ep.  The balance loss comes out of
``pipeline_spmd(with_aux=True)`` and joins the loss.

Refused as in the JAX package: ``dropout``, a layer count the stages
do not divide and an MoE stack with dense layers in it.  GQA with
``kv_heads < tp`` is ROADMAP queue 1 item 10b, as in ``models.gpt``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch

from .. import nn
from ..graph.ctor import (ConstantInitializer, NormalInitializer,
                          parallel_parameter)
from ..graph.tensor import SymbolicDim
from ..ops import functional as ops
from ..ops.attention import sdpa
from ..parallel import comm
from ..parallel.mesh import P
from ..parallel.pipeline import pipeline_spmd
from .gpt import (GPTConfig, _bake_seq_len, _check_tp, check_training_config,
                  moe_activation)


@functools.lru_cache(maxsize=32)
def _rotary(seq_len: int, d: int, dtype: torch.dtype, device: torch.device):
    """The rotary tables ``[1, s, 1, d]`` in fp32, cast to ``dtype`` (the
    JAX model casts them to the activations' dtype), kept on ``device``:
    a step's first, eager run makes them, and a captured replay reads
    them."""
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d))
    ang = np.outer(np.arange(seq_len, dtype=np.float32), inv)
    emb = np.concatenate([ang, ang], axis=-1)
    return tuple(torch.from_numpy(t[None, :, None, :]).to(device=device,
                                                          dtype=dtype)
                 for t in (np.cos(emb), np.sin(emb)))


def _apply_rotary(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def _norm(x, w, b=None, dtype=None):
    """RMSNorm (``b`` None, eps 1e-6) or LayerNorm (eps 1e-5) over the
    last dim, computed in ``dtype`` (None: ``x``'s) and cast back to
    ``x``'s dtype."""
    xf = x if dtype is None else x.to(dtype)
    w = w.to(xf.dtype)
    if b is None:
        out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
        return (out * w).to(x.dtype)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + 1e-5) * w + b.to(xf.dtype)
    return out.to(x.dtype)


def _dropout(x, rate: float, gen: Optional[torch.Generator]):
    if not rate or gen is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _moe_mlp(params, h, *, cfg: GPTConfig, mesh=None, tokens=None):
    """The MoE feed-forward block on ``h [b, s, H]`` (the JAX pipeline's:
    the top-k gate, the dispatch and combine tensors cast to the
    activations' dtype, the stacked experts): ``(out, l_aux)``.  The
    gate routes the tokens of ``tokens`` (``nn.moe._Tokens``: the global
    micro-batch under dp); under ``cfg.ep_axis`` the rank runs its
    experts and the outputs are gathered over ep."""
    from ..nn.moe import _experts_ffn, _Tokens, topk_gating_impl
    c = cfg
    b, s, hdim = h.shape
    xt = h.reshape(-1, hdim)                                     # [T, d]
    wg = params["moe_gate"]
    dt = torch.promote_types(xt.dtype, wg.dtype)
    logits = torch.matmul(xt.to(dt), wg.to(dt).t())
    l_aux, combine, dispatch = topk_gating_impl(
        logits, c.moe_top_k, c.moe_capacity_factor,
        tokens(xt.shape[0]) if tokens is not None else _Tokens(xt.shape[0]))
    dispatched = torch.einsum("tec,td->ecd", dispatch.to(xt.dtype), xt)
    ep = c.ep_axis if c.ep_axis and mesh is not None and \
        mesh.axis_size(c.ep_axis) > 1 else None
    if ep:
        dispatched = comm.split_to_group(dispatched, ep, 0, mesh)
    eout = _experts_ffn(dispatched, params["moe_w1"], params["moe_b1"],
                        params["moe_w2"], params["moe_b2"],
                        moe_activation(c))
    if ep:
        eout = comm.gather_output(eout, ep, 0, mesh)
    out = torch.einsum("tec,ecd->td", combine.to(eout.dtype), eout)
    return out.reshape(b, s, hdim).to(h.dtype), l_aux


def block_fn(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
             cfg: GPTConfig, mesh=None, gen: Optional[torch.Generator] = None,
             ln_fp32: bool = False, tokens=None):
    """One transformer block on tensors: LLaMA-style (rmsnorm, rotary,
    swiglu, no biases) or GPT-2-style (layernorm, learned positions,
    gelu, biases) by ``cfg``, GQA by ``cfg.num_kv_heads``.  ``params``:
    this layer's local weights (the rank's tp shard); ``x``: ``[b, s,
    h]``, split over tp along the sequence with ``cfg.sp``.  Returns
    ``(x, aux)``: aux the MoE balance loss (0 for a dense block), whose
    gate routes ``tokens(n)`` (``nn.moe._Tokens``; None: the block's
    own).

    RMSNorm runs in fp32, LayerNorm in ``x``'s dtype or, with
    ``ln_fp32`` (the MPMD model's arithmetic), in fp32.  ``gen`` draws
    ``cfg.dropout``'s masks (the MPMD model's; the SPMD pipeline refuses
    dropout): attention-probability dropout needs the probabilities, so
    attention then runs plainly, as the JAX MPMD model computes it."""
    c = cfg
    ax = c.tp_axis
    tp = mesh.axis_size(ax) if mesh is not None else 1
    sp = c.sp and tp > 1

    def col_in(v):      # the input of a column-parallel product
        if tp == 1:
            return v
        return comm.gather_from_group(v, ax, 1, mesh) if sp \
            else comm.copy_to_group(v, ax, mesh)

    def row_out(v):     # the partial output of a row-parallel product
        if tp == 1:
            return v
        return comm.reduce_scatter_to_group(v, ax, 1, mesh) if sp \
            else comm.reduce_from_group(v, ax, mesh)

    def shared(w):      # a weight each rank applies to its own rows
        return comm.copy_to_group(w, ax, mesh) if sp else w

    def norm(v, which):
        if c.norm == "rmsnorm":
            return _norm(v, shared(params[which]), dtype=torch.float32)
        return _norm(v, shared(params[which]), shared(params[which + "_b"]),
                     dtype=torch.float32 if ln_fp32 else None)

    def proj(v, w, b=None):
        out = torch.matmul(v, w.t())
        return out if b is None else out + b

    nh, kvh, hd = c.num_heads // tp, c.kv_heads // tp, c.head_dim
    q_size, kv_size = nh * hd, kvh * hd

    h = col_in(norm(x, "ln1"))
    b, s = h.shape[0], h.shape[1]
    qkv = proj(h, params["qkv"], params.get("qkv_b"))
    q = qkv[..., :q_size].reshape(b, s, nh, hd)
    k = qkv[..., q_size:q_size + kv_size].reshape(b, s, kvh, hd)
    v = qkv[..., q_size + kv_size:].reshape(b, s, kvh, hd)
    if c.position == "rotary":
        cos, sin = _rotary(s, hd, x.dtype, x.device)
        q = _apply_rotary(q, cos, sin)
        k = _apply_rotary(k, cos, sin)
    if kvh != nh:
        # repeat before the head split (each kv head serves nh // kvh
        # consecutive query heads)
        k = k.repeat_interleave(nh // kvh, dim=2)
        v = v.repeat_interleave(nh // kvh, dim=2)
    if c.dropout and gen is not None:
        logits = torch.einsum("bqnd,bknd->bnqk", q, k).float() / \
            math.sqrt(hd)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~causal, -1e30)
        probs = _dropout(torch.softmax(logits, -1).to(x.dtype), c.dropout,
                         gen)
        attn = torch.einsum("bnqk,bknd->bqnd", probs, v)
    else:
        attn = sdpa(q, k, v, causal=True)
    out = row_out(proj(attn.reshape(b, s, q_size), params["attn_out"]))
    if "attn_out_b" in params:
        out = out + shared(params["attn_out_b"])
    x = x + _dropout(out, c.dropout, gen)

    if "moe_w1" in params:
        # the gate routes the whole sequence of the rank's micro-batch
        h = norm(x, "ln2")
        if sp:
            h = comm.gather_output(h, ax, 1, mesh)
        down, aux = _moe_mlp(params, h, cfg=c, mesh=mesh, tokens=tokens)
        if sp:
            down = comm.split_to_group(down, ax, 1, mesh)
        return x + down, aux
    h = col_in(norm(x, "ln2"))
    up = proj(h, params["mlp_up"], params.get("mlp_up_b"))
    if c.activation == "swiglu":
        u1, u2 = up.chunk(2, -1)
        act = torch.nn.functional.silu(u1) * u2
    elif c.activation == "relu":
        act = torch.relu(up)
    elif c.activation == "silu":
        act = torch.nn.functional.silu(up)
    else:
        act = torch.nn.functional.gelu(up, approximate="tanh")
    down = row_out(proj(act, params["mlp_down"]))
    if "mlp_down_b" in params:
        down = down + shared(params["mlp_down_b"])
    return x + _dropout(down, c.dropout, gen), torch.zeros((),
                                                         device=x.device)


def check_pipeline_config(cfg: GPTConfig, num_stages: int) -> None:
    """The JAX model's refusals, and the port's by ROADMAP item."""
    check_training_config(cfg)
    if num_stages < 1 or cfg.num_layers % num_stages:
        raise ValueError(f"{cfg.num_layers} layers are not divisible into "
                         f"{num_stages} pipeline stages")
    if cfg.dropout:
        raise NotImplementedError("pipelined blocks do not support dropout")
    if cfg.num_experts > 0 and any(not cfg.is_moe_layer(i)
                                   for i in range(cfg.num_layers)):
        # the stages stack homogeneous layers: every block must be MoE
        raise NotImplementedError(
            "pipelined MoE needs every layer MoE (moe_every=1); mixed "
            "dense/MoE stacks use the MPMD path")
    if cfg.cp_axis:
        raise NotImplementedError(
            "GPTPipelineModel does not take cp_axis: its stages attend over "
            "the whole sequence (the JAX pipeline model reads no cp_axis); "
            "train context parallel with GPTLMHeadModel")


class GPTPipelineModel(nn.Module):
    """GPT/LLaMA LM with pp-stacked blocks and dp/tp inside the stages.

    ``num_stages`` must equal the mesh's pp size (1 without a pp axis);
    the layers split into equal ranges, stage after stage.  The parameter
    names are the JAX model's (``wte.weight``, ``wpe``, ``ln_f.*``,
    ``lm_head``, ``blk_<name>`` holding ``blocks.<name>``), so its
    ``state_dict()`` loads through ``models.convert.load_module_state``;
    ``models.convert.pipeline_state`` and ``plain_state`` carry weights
    to and from ``GPTLMHeadModel``.
    """

    def __init__(self, config: GPTConfig, num_stages: int):
        super().__init__()
        check_pipeline_config(config, num_stages)
        c = self.config = config
        tp = nn.parallel.axis_size_here(c.tp_axis)
        pp = nn.parallel.axis_size_here("pp")
        if pp != num_stages:
            raise ValueError(f"num_stages={num_stages}, but the mesh's "
                             f"'pp' axis has {pp} ranks")
        _check_tp(c, tp)
        self.num_stages = num_stages
        self.layers_per_stage = L = c.num_layers // num_stages
        S, h, f = num_stages, c.hidden_size, c.ffn_size
        biased = c.activation == "gelu"

        self.wte = nn.VocabParallelEmbedding(
            c.vocab_size, h, dp_axis=c.dp_axis, tp_axis=c.tp_axis,
            dtype=c.dtype, init=NormalInitializer(0.0, c.init_std),
            name="wte")
        self.wpe = parallel_parameter(
            NormalInitializer(0.0, c.init_std), (c.max_seq_len, h),
            pspec=P(None, None), dtype=c.dtype, name="wpe") \
            if c.position == "learned" else None
        norm_cls = nn.ParallelRMSNorm if c.norm == "rmsnorm" \
            else nn.ParallelLayerNorm
        self.ln_f = norm_cls(h, sp=c.sp, dp_axis=c.dp_axis,
                             tp_axis=c.tp_axis, dtype=c.dtype, name="ln_f")
        self.lm_head = parallel_parameter(
            NormalInitializer(0.0, c.init_std), (c.vocab_size, h),
            pspec=P(c.tp_axis, None), dtype=c.dtype, name="lm_head")

        self._stacked: Dict[str, object] = {}

        def stacked(name, shape, tail, init, blocks=None):
            t = parallel_parameter(
                init, (S, L) + tuple(shape), pspec=P("pp", None, *tail),
                dtype=c.dtype, name=f"blocks.{name}", blocks=blocks,
                blocks_dim=2)
            self._stacked[name] = t
            setattr(self, f"blk_{name}", t)

        normal = functools.partial(NormalInitializer, 0.0)
        ones, zeros = ConstantInitializer(1.0), ConstantInitializer(0.0)
        depth_std = c.init_std / math.sqrt(2 * c.num_layers)
        q_size = c.num_heads * c.head_dim
        kv_size = c.kv_heads * c.head_dim
        qkv_blocks = (q_size, kv_size, kv_size)
        up_rows = (2 if c.activation == "swiglu" else 1) * f
        up_blocks = (f, f) if c.activation == "swiglu" else None
        stacked("ln1", (h,), (None,), ones)
        if c.norm == "layernorm":
            stacked("ln1_b", (h,), (None,), zeros)
        stacked("qkv", (q_size + 2 * kv_size, h), (c.tp_axis, None),
                normal(c.init_std), qkv_blocks)
        if biased:
            stacked("qkv_b", (q_size + 2 * kv_size,), (c.tp_axis,), zeros,
                    qkv_blocks)
        stacked("attn_out", (h, q_size), (None, c.tp_axis),
                normal(depth_std))
        if biased:
            stacked("attn_out_b", (h,), (None,), zeros)
        stacked("ln2", (h,), (None,), ones)
        if c.norm == "layernorm":
            stacked("ln2_b", (h,), (None,), zeros)
        if c.num_experts > 0:
            E, ep = c.num_experts, c.ep_axis
            stacked("moe_gate", (E, h), (None, None), normal(c.init_std))
            stacked("moe_w1", (E, h, f), (ep, None, None),
                    normal(c.init_std))
            stacked("moe_b1", (E, 1, f), (ep, None, None), zeros)
            stacked("moe_w2", (E, f, h), (ep, None, None), normal(depth_std))
            stacked("moe_b2", (E, 1, h), (ep, None, None), zeros)
        else:
            stacked("mlp_up", (up_rows, h), (c.tp_axis, None),
                    normal(c.init_std), up_blocks)
            if biased:
                stacked("mlp_up_b", (up_rows,), (c.tp_axis,), zeros,
                        up_blocks)
            stacked("mlp_down", (h, f), (None, c.tp_axis),
                    normal(depth_std))
            if biased:
                stacked("mlp_down_b", (h,), (None,), zeros)

    def _pipeline(self, x, *stacked, num_micro_batches=1, mesh=None):
        from ..nn.moe import _Tokens
        c = self.config
        params = dict(zip(self._stacked, stacked))
        moe = c.num_experts > 0
        graph = self.lm_head.graph

        def tokens(n):
            return _Tokens(n, mesh, c.dp_axis, graph)

        def stage_fn(p, v):
            aux = 0.0
            for i in range(self.layers_per_stage):
                v, a = block_fn({k: w[i] for k, w in p.items()}, v,
                                cfg=c, mesh=mesh, tokens=tokens)
                if moe:
                    aux = aux + a
            return (v, aux) if moe else v

        return pipeline_spmd(stage_fn, params, x, num_micro_batches, mesh,
                             with_aux=moe)

    def forward(self, input_ids, labels=None, num_micro_batches: int = 1):
        c = self.config
        seq_len = input_ids.shape[-1]
        if isinstance(seq_len, SymbolicDim):
            seq_len = _bake_seq_len(input_ids, seq_len)
        mesh = self.lm_head.graph.mesh
        x = self.wte(input_ids)
        if self.wpe is not None:
            x = x + ops.getitem(self.wpe, slice(0, seq_len))
        if c.sp:
            x = nn.parallel.split_seq(x, c.tp_axis)
        moe = c.num_experts > 0
        # each rank's pipeline micro-batch is its shard of the global one,
        # as in the JAX package's global view (the MoE gate routes it)
        for t in (input_ids, labels):
            if t is None:
                continue
            if t.producer is not None and \
                    t.producer.op_type == "placeholder":
                t.feed_groups = int(num_micro_batches)
            elif moe and mesh is not None and \
                    mesh.axis_size(c.dp_axis) > 1:
                raise NotImplementedError(
                    f"the MoE pipeline under {c.dp_axis!r} reads its ids "
                    f"and labels from placeholders (their feeds split "
                    f"micro-batch by micro-batch, so that the gate routes "
                    f"the global micro-batch); {t.name} comes from "
                    f"{t.producer.op_type!r}")
        x = ops._op("pipeline_transformer", self._pipeline,
                    [x, *self._stacked.values()],
                    {"num_micro_batches": int(num_micro_batches),
                     "mesh": mesh}, num_outputs=2 if moe else 1)
        if moe:
            x, aux = x
        x = self.ln_f(x)
        x = nn.parallel.gather_seq(x, c.tp_axis) if c.sp \
            else nn.parallel.copy_to(x, c.tp_axis)
        logits = ops.matmul(x, self.lm_head, trans_b=True)
        if labels is None:
            return logits
        loss = nn.vocab_parallel_cross_entropy(
            logits, labels, dp_axis=c.dp_axis, tp_axis=c.tp_axis,
            ignore_index=-100)
        if moe and c.moe_aux_coef:
            loss = loss + c.moe_aux_coef * aux
        return loss


__all__ = ["GPTPipelineModel", "block_fn", "check_pipeline_config"]
