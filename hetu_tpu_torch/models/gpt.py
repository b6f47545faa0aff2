"""GPT-2 / LLaMA model configuration.

``GPTConfig`` is a field-for-field copy of ``hetu_tpu.models.gpt``'s, so
one set of keyword arguments describes a model to both packages and a
state dict carries across unchanged.  Serving and ``generate`` need only
the config; ``GPTLMHeadModel`` and its blocks are the training model,
built from ``hetu_tpu_torch.nn`` modules on a define-and-run graph, with
the JAX package's parameter names.

On a graph with a mesh the model is tensor parallel over ``tp_axis``
(Megatron-LM's layout): attention runs on ``num_heads // tp`` local
heads, and the fused ``attn.qkv`` weight is split block by block, so
that each rank holds its q heads, its k heads and its v heads (a
contiguous shard of the fused dim would hand rank 0 all of q and part of
k); SwiGLU's fused ``mlp.up`` is split by its two halves the same way.
With ``sp`` the residual stream between the blocks is split over the
sequence.  GQA with ``kv_heads < tp`` repeats the kv heads before they
are sharded, as the JAX package does: each rank holds the kv head its q
heads read (``kv_heads`` parts of the k and v blocks, each held by ``tp
// kv_heads`` ranks, whose gradients are summed over them).  The local
head counts are read from the mesh each op runs on, never fixed when
the model is built, so that a strategy switch keeps the recorded model
(``DefineAndRunGraph.switch_strategy``).

With ``cp_axis`` on a mesh whose cp axis has more than one rank the
model is context parallel: each rank keeps its contiguous block of the
sequence (cp outer, tp inner under ``sp``).  The JAX model is written in
the global view (one rotary table and one ``wpe`` slice for the whole
sequence, GSPMD splitting the activations); here the model takes the
rank's block of the ids, the labels and the segment ids
(``nn.parallel.seq_shard``; a placeholder fed with ``P("dp", "cp")``
holds it already), the position rows and the rotary angles at the
block's global positions, and attention through
``ops.parallel_attention`` (the ring or Ulysses, ``cp_impl``).  The loss
is the mean over the valid tokens of the global batch and sequence (its
sum and count reduced over dp and cp), and the optimizer sums the
gradients over cp (``Graph.seq_axes``).

With ``num_experts > 0`` every ``moe_every``-th block's MLP is
``MoEMLP`` (``nn.moe``: a top-k gate and stacked experts, split over
``ep_axis`` on a mesh that has it), and the loss adds ``moe_aux_coef``
times each MoE block's balance loss, as the JAX model does; the fused
LM-head cross entropy is then not taken.  MoE under context parallelism
is refused (ROADMAP queue 1 item 14b).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .. import nn
from ..ops import functional as ops
from ..graph.ctor import NormalInitializer, parallel_parameter
from ..graph.tensor import SymbolicDim
from ..parallel import comm


@dataclass
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None      # GQA; None -> = num_heads
    ffn_hidden_size: Optional[int] = None   # None -> 4h (gelu) or 8h/3 (swiglu)
    max_seq_len: int = 1024
    activation: str = "gelu"                # gelu (GPT) | swiglu (LLaMA)
    norm: str = "layernorm"                 # layernorm (GPT) | rmsnorm (LLaMA)
    position: str = "learned"               # learned (GPT) | rotary (LLaMA)
    dropout: float = 0.0
    sp: bool = True                         # Megatron sequence parallel
    tie_embeddings: bool = False
    init_std: float = 0.02
    dtype: str = "float32"
    dp_axis: str = "dp"
    tp_axis: str = "tp"
    cp_axis: Optional[str] = None   # context parallel axis
    cp_impl: str = "ring"           # "ring" | "ulysses"
    fused_lm_ce: bool = False
    # MoE: >0 replaces the dense MLP with a mixture of experts every
    # `moe_every` blocks
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_every: int = 1
    moe_aux_coef: float = 0.01
    ep_axis: Optional[str] = None   # expert-parallel mesh axis
    # MLA (multi-head latent attention): one compressed KV stream per
    # layer; kv_rope_dim is the decoupled-RoPE key width
    kv_latent_dim: Optional[int] = None
    kv_rope_dim: Optional[int] = None

    def __post_init__(self):
        assert self.hidden_size % self.num_heads == 0, \
            f"hidden {self.hidden_size} not divisible by heads {self.num_heads}"
        kv = self.num_kv_heads or self.num_heads
        assert self.num_heads % kv == 0, \
            f"num_heads {self.num_heads} not divisible by kv_heads {kv}"
        if self.kv_latent_dim is not None:
            assert self.kv_latent_dim >= 1, \
                f"kv_latent_dim must be >= 1, got {self.kv_latent_dim}"
            if self.position == "rotary":
                r = self.rope_dim
                assert r > 0 and r % 2 == 0, \
                    f"MLA decoupled rope dim must be positive even, got {r}"
        elif self.kv_rope_dim is not None:
            raise ValueError("kv_rope_dim requires kv_latent_dim (MLA mode)")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def is_mla(self) -> bool:
        return self.kv_latent_dim is not None

    @property
    def rope_dim(self) -> int:
        """Decoupled-RoPE key width d_r: 0 for non-MLA and for
        learned-position MLA (no positional content in the cache)."""
        if self.kv_latent_dim is None or self.position != "rotary":
            return 0
        return self.kv_rope_dim if self.kv_rope_dim is not None \
            else self.head_dim

    def is_moe_layer(self, layer_idx: int) -> bool:
        return self.num_experts > 0 and \
            layer_idx % max(1, self.moe_every) == 0

    @property
    def ffn_size(self) -> int:
        if self.ffn_hidden_size:
            return self.ffn_hidden_size
        if self.activation == "swiglu":
            return int(8 * self.hidden_size / 3 / 64) * 64 or 64
        return 4 * self.hidden_size


def llama_config(**kw) -> GPTConfig:
    kw.setdefault("activation", "swiglu")
    kw.setdefault("norm", "rmsnorm")
    kw.setdefault("position", "rotary")
    return GPTConfig(**kw)


def llama3_8b_config(**kw) -> GPTConfig:
    """Meta-Llama-3-8B's published widths (vocab 128256, hidden 4096,
    32 layers, 32 heads, 8 KV heads, FFN 14336, untied head, bf16).
    The rope base and RMSNorm epsilon are those of this package
    (10000, 1e-6), as in the JAX package.  ``kw`` overrides fields, e.g.
    ``num_layers`` to cut depth."""
    base = dict(vocab_size=128256, hidden_size=4096, num_layers=32,
                num_heads=32, num_kv_heads=8, ffn_hidden_size=14336,
                max_seq_len=8192, sp=False, dtype="bfloat16")
    base.update(kw)
    return llama_config(**base)


def draft_config(cfg: GPTConfig, num_layers: int) -> GPTConfig:
    """A shallow draft-model config for speculative decoding
    (``serving/spec.py``): the target's vocab, embedding and head
    geometry, with only the layer count reduced."""
    if not 1 <= num_layers <= cfg.num_layers:
        raise ValueError(
            f"draft num_layers must be in [1, {cfg.num_layers}] (the "
            f"target's layer count), got {num_layers}")
    import dataclasses
    return dataclasses.replace(cfg, num_layers=int(num_layers))


def draft_state_from(state, cfg: GPTConfig, num_layers: int):
    """A truncated draft ``(state, config)`` from a target checkpoint:
    the first ``num_layers`` blocks plus the shared embeddings, final
    norm and head.  The draft's state holds the target's own arrays or
    tensors (references, not copies), so an engine serving both uploads
    them once."""
    from .generate import _Params
    dcfg = draft_config(cfg, num_layers)
    keep = {}
    for k, v in state.items():
        nk = _Params._norm(k)
        if nk.startswith("h"):
            idx = nk[1:].split(".", 1)[0]
            if idx.isdigit() and int(idx) >= num_layers:
                continue
        keep[k] = v
    return keep, dcfg


def mla_config(cfg: GPTConfig, kv_latent_dim: int,
               kv_rope_dim: Optional[int] = None) -> GPTConfig:
    """The MLA twin of a full-head config: identical everywhere except
    the cache layout fields."""
    import dataclasses
    return dataclasses.replace(cfg, kv_latent_dim=int(kv_latent_dim),
                               kv_rope_dim=kv_rope_dim)


def mla_state_from(state, cfg: GPTConfig, kv_latent_dim: int,
                   kv_rope_dim: Optional[int] = None, seed: int = 0):
    """Convert a full-head checkpoint (numpy arrays or tensors on the
    CPU) into an MLA ``(state, config)``; the state is numpy under the
    normalised names.

    Per layer, the fused ``attn.qkv`` projection is split and re-factored
    into the weight-absorbed MLA schema:

    - ``attn.q.weight``  [nh*(hd+d_r), H]: per-head ``[q_nope | q_rope]``
      rows; the nope rows are the source query projection verbatim.
    - ``attn.kv_a.weight`` [d_c+d_r, H]: shared latent down-projection
      (plus the decoupled rope key rows when d_r > 0).
    - ``attn.k_up.weight`` / ``attn.v_up.weight`` [nh, hd, d_c]: the
      up-projections that decode ABSORBS into q / out: ``score_h = (q_h @
      k_up_h) . c`` and ``out_h = (probs @ C) @ v_up_h.T``, so no cached
      token is ever decompressed.

    The factorization is the truncated SVD of the stacked per-head
    ``[W_k; W_v]``, exact (up to fp rounding) whenever that stack has
    rank <= d_c.  Learned-position configs convert losslessly; rotary
    sources are approximate by construction (the decoupled rope rows are
    freshly drawn from ``np.random.RandomState(seed)``, as the JAX
    package draws them).  K/V projection biases are least-squares-folded
    into ``kv_a.bias``.
    """
    from .generate import _Params
    d_c = int(kv_latent_dim)
    ncfg = mla_config(cfg, d_c, kv_rope_dim)
    d_r = ncfg.rope_dim
    nh, kvh, hd, H = (cfg.num_heads, cfg.kv_heads, cfg.head_dim,
                      cfg.hidden_size)
    g = nh // kvh
    q_size, kv_size = nh * hd, kvh * hd
    rng = np.random.RandomState(seed)

    def as_np(v):
        return v.detach().float().cpu().numpy() if hasattr(v, "detach") \
            else np.asarray(v)

    flat = {_Params._norm(k): as_np(v) for k, v in state.items()}
    out = {k: v for k, v in flat.items() if ".attn.qkv." not in k}
    for i in range(cfg.num_layers):
        w = np.asarray(flat[f"h{i}.attn.qkv.weight"], np.float32)
        b = flat.get(f"h{i}.attn.qkv.bias")
        b = None if b is None else np.asarray(b, np.float32)
        wq, wk, wv = (w[:q_size], w[q_size:q_size + kv_size],
                      w[q_size + kv_size:])
        # latent factorization: [W_k; W_v] = U @ (S Vt), keep d_c
        m = np.concatenate([wk, wv], axis=0)          # [2*kv_size, H]
        u, s, vt = np.linalg.svd(m, full_matrices=False)
        r = min(d_c, s.shape[0])
        kv_a = np.zeros((d_c + d_r, H), np.float32)
        kv_a[:r] = s[:r, None] * vt[:r]
        up = np.zeros((2 * kv_size, d_c), np.float32)
        up[:, :r] = u[:, :r]
        k_up = up[:kv_size].reshape(kvh, hd, d_c)
        v_up = up[kv_size:].reshape(kvh, hd, d_c)
        # GQA: expand kv-head up-projections to query heads so decode
        # absorbs per query head against the single shared latent
        k_up = np.repeat(k_up, g, axis=0)
        v_up = np.repeat(v_up, g, axis=0)
        # query: source nope rows + fresh decoupled-rope rows
        q_w = np.zeros((nh, hd + d_r, H), np.float32)
        q_w[:, :hd] = wq.reshape(nh, hd, H)
        if d_r:
            q_w[:, hd:] = rng.normal(
                0.0, cfg.init_std, (nh, d_r, H)).astype(np.float32)
            kv_a[d_c:] = rng.normal(
                0.0, cfg.init_std, (d_r, H)).astype(np.float32)
        out[f"h{i}.attn.q.weight"] = q_w.reshape(nh * (hd + d_r), H)
        out[f"h{i}.attn.kv_a.weight"] = kv_a
        out[f"h{i}.attn.k_up.weight"] = k_up
        out[f"h{i}.attn.v_up.weight"] = v_up
        if b is not None:
            q_b = np.zeros((nh, hd + d_r), np.float32)
            q_b[:, :hd] = b[:q_size].reshape(nh, hd)
            out[f"h{i}.attn.q.bias"] = q_b.reshape(-1)
            kv_b = np.zeros((d_c + d_r,), np.float32)
            kv_b[:d_c] = up.T @ b[q_size:]   # least-squares fold
            out[f"h{i}.attn.kv_a.bias"] = kv_b
    return out, ncfg


def moe_activation(cfg: GPTConfig) -> str:
    """The experts' activation: the config's, with SwiGLU mapped to its
    SiLU (the stacked experts are not gated, as in the JAX package)."""
    act = "silu" if cfg.activation == "swiglu" else cfg.activation
    if act not in ("relu", "gelu", "silu"):
        raise ValueError(
            f"MoE experts do not support activation {cfg.activation!r}")
    return act


def check_serving_config(cfg: GPTConfig) -> None:
    """The port serves dense and MoE configurations, full-head or MLA; an
    MoE config's experts need an activation they take."""
    if cfg.num_experts > 0:
        moe_activation(cfg)


# ---------------------------------------------------------------------------
# the training model (``hetu_tpu.models.gpt`` GPTLMHeadModel and its blocks)
# ---------------------------------------------------------------------------

def check_training_config(cfg: GPTConfig) -> None:
    """MLA is a serving layout that no package trains (``ValueError``);
    an MoE config's experts need an activation they take."""
    if cfg.is_mla:
        raise ValueError(
            "MLA (kv_latent_dim) is a decode/serving cache layout; "
            "train full-head and convert with models.gpt.mla_state_from")
    if cfg.num_experts > 0:
        moe_activation(cfg)
    if cfg.cp_impl not in ("ring", "ulysses"):
        raise ValueError(f"cp_impl must be 'ring' or 'ulysses', "
                         f"got {cfg.cp_impl!r}")


def _check_tp(c: GPTConfig, tp: int) -> None:
    """The widths a tensor-parallel degree must divide (``kv_heads``
    below tp must divide it: the heads repeat over the ranks)."""
    if tp == 1:
        return
    if c.kv_heads < tp and tp % c.kv_heads:
        raise ValueError(f"tp={tp} is not a multiple of kv_heads "
                         f"{c.kv_heads}")
    for what, n in (("num_heads", c.num_heads),
                    ("kv_heads", c.kv_heads if c.kv_heads >= tp else tp),
                    ("ffn size", c.ffn_size), ("vocab_size", c.vocab_size)):
        if n % tp:
            raise ValueError(f"{what} {n} is not divisible by tp={tp}")


def _check_layout(c: GPTConfig) -> None:
    """``_check_tp`` now and against every mesh the graph switches to."""
    _check_tp(c, nn.parallel.axis_size_here(c.tp_axis))
    nn.parallel._check_strategy(
        lambda mesh: _check_tp(c, mesh.axis_size(c.tp_axis)))


def _qkv_heads(qkv, mesh=None, tp_axis="tp", heads=(1, 1), head_dim=1):
    """q, k, v ``[b, s, h, d]`` of the rank's fused projection: its q
    heads and the kv heads they read, the counts from the mesh the op
    runs on."""
    nh, kvh = heads
    tp = mesh.axis_size(tp_axis) if mesh is not None else 1
    hq, hk = nh // tp, max(kvh // tp, 1)
    q, k, v = qkv.split([hq * head_dim, hk * head_dim, hk * head_dim], -1)
    return tuple(x.unflatten(-1, (-1, head_dim)) for x in (q, k, v))


def _repeat_like(kv, q):
    """``kv``'s heads repeated up to ``q``'s count."""
    n = q.shape[-2] // kv.shape[-2]
    return kv if n == 1 else ops._repeat_kv(kv, n)


def _cp(c: GPTConfig) -> int:
    """The context-parallel degree of the graph being built (1 without
    ``cp_axis`` or a mesh naming it)."""
    return nn.parallel.axis_size_here(c.cp_axis) if c.cp_axis else 1


def _norm(config: GPTConfig, name: str):
    kw = dict(sp=config.sp, dp_axis=config.dp_axis, tp_axis=config.tp_axis,
              dtype=config.dtype, name=name)
    if config.norm == "rmsnorm":
        return nn.ParallelRMSNorm(config.hidden_size, **kw)
    return nn.ParallelLayerNorm(config.hidden_size, **kw)


class ParallelAttentionBlock(nn.Module):
    """Self-attention: fused QKV projection, rotary (LLaMA), GQA
    expansion, attention and the output projection, on the rank's
    ``num_heads // tp`` heads."""

    def __init__(self, config: GPTConfig, layer_idx: int = 0):
        super().__init__()
        check_training_config(config)
        c = self.config = config
        _check_layout(c)
        q_size = c.num_heads * c.head_dim
        kv_size = c.kv_heads * c.head_dim
        self.qkv = nn.ColumnParallelLinear(
            c.hidden_size, q_size + 2 * kv_size, bias=(c.activation == "gelu"),
            dp_axis=c.dp_axis, tp_axis=c.tp_axis, sp=c.sp,
            blocks=(q_size, kv_size, kv_size),
            units=(c.num_heads, c.kv_heads, c.kv_heads),
            dtype=c.dtype, init=NormalInitializer(0.0, c.init_std),
            name=f"h{layer_idx}.attn.qkv")
        self.out = nn.RowParallelLinear(
            q_size, c.hidden_size, bias=(c.activation == "gelu"), sp=c.sp,
            dp_axis=c.dp_axis, tp_axis=c.tp_axis, dtype=c.dtype,
            init=NormalInitializer(0.0, c.init_std / math.sqrt(2 * c.num_layers)),
            name=f"h{layer_idx}.attn.out")
        self.dropout = nn.Dropout(c.dropout) if c.dropout else None
        self._rotary_cache = {}

    def _rotary(self, seq_len: int, offset: int = 0):
        """fp32 numpy tables [1, s, 1, d] of positions ``offset`` to
        ``offset + seq_len - 1`` (the rank's block under cp), as the JAX
        package keeps them: they promote bf16 q/k to fp32."""
        key = (seq_len, offset)
        if key not in self._rotary_cache:
            d = self.config.head_dim
            inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d))
            pos = np.arange(offset, offset + seq_len, dtype=np.float32)
            ang = np.outer(pos, inv)
            emb = np.concatenate([ang, ang], axis=-1)
            self._rotary_cache[key] = (
                np.cos(emb)[None, :, None, :].astype(np.float32),
                np.sin(emb)[None, :, None, :].astype(np.float32))
        return self._rotary_cache[key]

    def forward(self, x, seq_len: int, segment_ids=None, pos_offset: int = 0):
        """``seq_len`` is the length this rank holds (its block under cp),
        ``pos_offset`` the global position of its first token."""
        c = self.config
        qkv = self.qkv(x)
        q, k, v = ops._op("qkv_heads", _qkv_heads, [qkv],
                          {"mesh": nn.parallel._mesh_of(qkv),
                           "tp_axis": c.tp_axis,
                           "heads": (c.num_heads, c.kv_heads),
                           "head_dim": c.head_dim}, num_outputs=3)
        if c.position == "rotary":
            cos, sin = self._rotary(seq_len, pos_offset)
            q = ops.rotary_embed(q, cos, sin)
            k = ops.rotary_embed(k, cos, sin)
        if c.kv_heads != c.num_heads:
            k = ops._op("repeat_kv", _repeat_like, [k, q])
            v = ops._op("repeat_kv", _repeat_like, [v, q])
        if c.cp_axis:
            attn = ops.parallel_attention(
                q, k, v, causal=True, cp_axis=c.cp_axis,
                batch_axis=c.dp_axis, head_axis=c.tp_axis,
                segment_ids=segment_ids, cp_impl=c.cp_impl)
        else:
            attn = ops.attention(q, k, v, causal=True,
                                 segment_ids=segment_ids)
        out = self.out(ops._op("merge_heads", lambda a: a.flatten(-2),
                               [attn]))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class ParallelMLP(nn.Module):
    def __init__(self, config: GPTConfig, layer_idx: int = 0):
        super().__init__()
        c = config
        mult = 2 if c.activation == "swiglu" else 1
        # SwiGLU's halves split one by one: each rank keeps its part of
        # both, which ``ops.swiglu`` pairs up
        self.up = nn.ColumnParallelLinear(
            c.hidden_size, c.ffn_size * mult, bias=(c.activation == "gelu"),
            dp_axis=c.dp_axis, tp_axis=c.tp_axis, sp=c.sp,
            blocks=(c.ffn_size,) * mult if mult > 1 else None,
            dtype=c.dtype, init=NormalInitializer(0.0, c.init_std),
            name=f"h{layer_idx}.mlp.up")
        self.down = nn.RowParallelLinear(
            c.ffn_size, c.hidden_size, bias=(c.activation == "gelu"),
            sp=c.sp, dp_axis=c.dp_axis, tp_axis=c.tp_axis, dtype=c.dtype,
            init=NormalInitializer(0.0, c.init_std / math.sqrt(2 * c.num_layers)),
            name=f"h{layer_idx}.mlp.down")
        self.activation = c.activation
        self.dropout = nn.Dropout(c.dropout) if c.dropout else None

    def forward(self, x):
        h = self.up(x)
        if self.activation == "swiglu":
            h = ops.swiglu(h)
        elif self.activation == "silu":
            h = ops.silu(h)
        elif self.activation == "relu":
            h = ops.relu(h)
        else:
            h = ops.gelu(h)
        out = self.down(h)
        if self.dropout is not None:
            out = self.dropout(out)
        return out


def _gather_tokens(x, mesh=None, axis="tp"):
    """The whole sequence of a block split over ``axis`` (dim 1); the
    backward keeps this rank's block (every rank computes the same)."""
    return comm.gather_output(x, axis, 1, mesh)


def _no_moe_cp(c: GPTConfig):
    def check(mesh):
        if c.cp_axis and mesh.axis_size(c.cp_axis) > 1:
            raise NotImplementedError(
                "MoE layers under context parallelism (cp_axis over more "
                "than one rank) are not ported: the gate routes the whole "
                "sequence (ROADMAP queue 1 item 14b)")
    return check


class MoEMLP(nn.Module):
    """The MoE feed-forward block (``nn.moe``'s layer, top-k gate): the
    balance loss of the last forward stays on the module for the LM head.
    Under ``sp`` the layer takes the whole sequence of the rank's batch
    (gathered over tp, as the JAX layer reads the global view) and the
    block keeps its own part of the output."""

    def __init__(self, config: GPTConfig, layer_idx: int = 0):
        super().__init__()
        c = self.config = config
        nn.parallel._check_strategy(_no_moe_cp(c))
        self.moe = nn.make_moe_layer(
            c.hidden_size, c.ffn_size, num_experts=c.num_experts,
            gate_type="topk", k=c.moe_top_k,
            capacity_factor=c.moe_capacity_factor,
            activation=moe_activation(c), ep_axis=c.ep_axis, dtype=c.dtype,
            name=f"h{layer_idx}.moe", dp_axis=c.dp_axis)
        self.last_aux = None

    def forward(self, x):
        c = self.config
        mesh = nn.parallel._active(x, c.tp_axis) if c.sp else None
        if mesh is not None:
            x = ops._op("moe_sp_gather", _gather_tokens, [x],
                        {"mesh": mesh, "axis": c.tp_axis})
        out, aux = self.moe(x)
        if mesh is not None:
            out = nn.parallel.split_seq(out, c.tp_axis)
        self.last_aux = aux
        return out


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, layer_idx: int):
        super().__init__()
        self.ln_1 = _norm(config, f"h{layer_idx}.ln_1")
        self.attn = ParallelAttentionBlock(config, layer_idx)
        self.ln_2 = _norm(config, f"h{layer_idx}.ln_2")
        self.mlp = MoEMLP(config, layer_idx) \
            if config.is_moe_layer(layer_idx) \
            else ParallelMLP(config, layer_idx)

    def forward(self, x, seq_len: int, segment_ids=None, pos_offset: int = 0):
        x = x + self.attn(self.ln_1(x), seq_len, segment_ids=segment_ids,
                          pos_offset=pos_offset)
        return x + self.mlp(self.ln_2(x))


def _bake_seq_len(input_ids, dim: SymbolicDim) -> int:
    """The length a symbolic sequence dim binds now.  The model bakes it
    into its reshapes and its position and rotary tables, as the JAX
    package's ``GPTModel.forward`` does (``seq_len.get()`` at build
    time): an unbound dim raises here, and a run whose feeds bind the
    dim to another length raises in the graph (``Graph.bake_dim``).  A
    symbolic batch dim stays free."""
    if not dim.is_bound:
        raise ValueError(
            f"GPTModel bakes the sequence length into its reshapes and its "
            f"position and rotary tables when it is built, as the JAX "
            f"package's does, but symbolic dim {dim.name!r} is unbound: "
            f"give the placeholder a static length or a bound dim "
            f"(SymbolicDim({dim.name!r}, length))")
    n = dim.get()
    if input_ids.graph is not None:
        input_ids.graph.bake_dim(dim, n, "GPTModel")
    return n


class GPTModel(nn.Module):
    """Embeddings, blocks and the final norm."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        check_training_config(config)
        c = self.config = config
        _check_layout(c)
        self.wte = nn.VocabParallelEmbedding(
            c.vocab_size, c.hidden_size, dp_axis=c.dp_axis, tp_axis=c.tp_axis,
            dtype=c.dtype, init=NormalInitializer(0.0, c.init_std),
            name="wte")
        if c.position == "learned":
            self.wpe = parallel_parameter(
                NormalInitializer(0.0, c.init_std),
                (c.max_seq_len, c.hidden_size), dtype=c.dtype, name="wpe")
        self.drop = nn.Dropout(c.dropout) if c.dropout else None
        self.h = nn.ModuleList([GPTBlock(c, i) for i in range(c.num_layers)])
        self.ln_f = _norm(config, "ln_f")

    def _block(self, input_ids, seq_len: Optional[int]):
        """``(the length of this rank's block of the sequence, the global
        position of its first token)``: the whole sequence and 0 without
        cp.  ``seq_len`` is global, as in the JAX package."""
        c = self.config
        cp = _cp(c)
        if seq_len is None:
            seq_len = input_ids.shape[-1]
            if isinstance(seq_len, SymbolicDim):
                seq_len = _bake_seq_len(input_ids, seq_len)
            if nn.parallel.seq_split_over(input_ids, c.cp_axis):
                seq_len *= cp
        if seq_len % cp:
            raise ValueError(f"sequence length {seq_len} is not divisible "
                             f"by cp={cp}")
        local = seq_len // cp
        return local, nn.parallel.axis_index_here(c.cp_axis) * local \
            if cp > 1 else 0

    def seq_local(self, t):
        """This rank's block of a ``[b, s]`` input (ids, labels, segment
        ids) under cp: ``t`` itself without cp or when it is fed split."""
        cp_axis = self.config.cp_axis
        return t if t is None or not cp_axis else \
            nn.parallel.seq_shard(t, cp_axis)

    def forward(self, input_ids, seq_len: Optional[int] = None,
                segment_ids=None):
        local, offset = self._block(input_ids, seq_len)
        x = self.wte(self.seq_local(input_ids))
        segment_ids = self.seq_local(segment_ids)
        if self.config.position == "learned":
            x = x + ops.getitem(self.wpe, slice(offset, offset + local))
        if self.drop is not None:
            x = self.drop(x)
        if self.config.sp:
            # sequence parallel: the residual stream is split over tp
            # (inside the rank's cp block)
            x = nn.parallel.split_seq(x, self.config.tp_axis)
        for block in self.h:
            x = block(x, local, segment_ids=segment_ids, pos_offset=offset)
        return self.ln_f(x)


class GPTLMHeadModel(nn.Module):
    """LM head and cross-entropy loss (``ignore_index=-100``)."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        check_training_config(config)
        c = self.config = config
        self.transformer = GPTModel(config)
        if c.tie_embeddings:
            self.lm_head = None
        else:
            self.lm_head = nn.ColumnParallelLinear(
                c.hidden_size, c.vocab_size, bias=False, dp_axis=c.dp_axis,
                tp_axis=c.tp_axis, sp=c.sp, dtype=c.dtype,
                init=NormalInitializer(0.0, c.init_std), name="lm_head")

    def logits(self, input_ids, seq_len: Optional[int] = None,
               segment_ids=None):
        """The logits, split over tp on the vocab (whole without tp), of
        the rank's block of the sequence under cp."""
        c = self.config
        x = self.transformer(input_ids, seq_len, segment_ids=segment_ids)
        if self.lm_head is None:
            x = nn.parallel.gather_seq(x, c.tp_axis) if c.sp \
                else nn.parallel.copy_to(x, c.tp_axis)
            return ops.matmul(x, self.transformer.wte.weight, trans_b=True)
        return self.lm_head(x)

    def forward(self, input_ids, labels=None, seq_len: Optional[int] = None,
                segment_ids=None):
        """``segment_ids``: [b, s] packed document ids.  With
        ``fused_lm_ce`` the head and the loss are one chunked op
        (``ops.fused_lm_cross_entropy``), the tied head included."""
        c = self.config
        if labels is not None and c.fused_lm_ce and c.num_experts == 0:
            def no_tp(mesh):
                if mesh.axis_size(c.tp_axis) > 1:
                    raise NotImplementedError(
                        "fused_lm_ce over a vocab split by tp is not ported "
                        "(ROADMAP queue 1 item 10b)")
            nn.parallel._check_strategy(no_tp)
            x = self.transformer(input_ids, seq_len,
                                 segment_ids=segment_ids)
            w = self.lm_head.weight if self.lm_head is not None \
                else self.transformer.wte.weight
            labels = self.transformer.seq_local(labels)
            loss = ops.fused_lm_cross_entropy(x, w, labels,
                                              ignore_index=-100)
            return nn.parallel.dp_mean_loss(loss, labels, -100, c.dp_axis,
                                            seq_axis=c.cp_axis)
        logits = self.logits(input_ids, seq_len, segment_ids=segment_ids)
        if labels is None:
            return logits
        loss = nn.vocab_parallel_cross_entropy(
            logits, self.transformer.seq_local(labels),
            dp_axis=c.dp_axis, tp_axis=c.tp_axis, seq_axis=c.cp_axis,
            ignore_index=-100)
        if c.num_experts > 0 and c.moe_aux_coef:
            for block in self.transformer.h:
                if isinstance(block.mlp, MoEMLP) and \
                        block.mlp.last_aux is not None:
                    loss = loss + c.moe_aux_coef * block.mlp.last_aux
        return loss

