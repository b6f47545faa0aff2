"""GPT-2 / LLaMA model configuration.

``GPTConfig`` is a field-for-field copy of ``hetu_tpu.models.gpt``'s, so
one set of keyword arguments describes a model to both packages and a
state dict carries across unchanged.  Serving and ``generate`` need only
the config; ``GPTLMHeadModel`` and its blocks are the training model,
built from ``hetu_tpu_torch.nn`` modules on a define-and-run graph, with
the JAX package's parameter names.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .. import nn
from ..ops import functional as ops
from ..graph.ctor import NormalInitializer, parallel_parameter


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


def check_serving_config(cfg: GPTConfig) -> None:
    """The port serves the plain (non-MLA), dense configuration; the
    other layouts come with later slices and are refused by name."""
    if cfg.is_mla:
        raise NotImplementedError(
            "MLA (kv_latent_dim) serving is ported in the MLA serving "
            "slice (latent ragged paged attention)")
    if cfg.num_experts > 0:
        raise NotImplementedError(
            "MoE layers (num_experts > 0) are ported in the MoE slice")


# ---------------------------------------------------------------------------
# the training model (``hetu_tpu.models.gpt`` GPTLMHeadModel and its blocks)
# ---------------------------------------------------------------------------

def check_training_config(cfg: GPTConfig) -> None:
    """The training model of this slice is the dense, single-device one;
    the other layouts are refused by name."""
    if cfg.is_mla:
        raise NotImplementedError(
            "MLA (kv_latent_dim) is a serving cache layout, ported with the "
            "MLA serving slice")
    if cfg.num_experts > 0:
        raise NotImplementedError(
            "MoE layers (num_experts > 0) are ported in the MoE slice")
    if cfg.cp_axis:
        raise NotImplementedError(
            "context parallelism (cp_axis) is ported in slice 3 (the "
            "multi-GPU mesh)")
    if cfg.fused_lm_ce:
        raise NotImplementedError(
            "fused_lm_ce is ported in a later slice (fused cross entropy)")


def _norm(config: GPTConfig, name: str):
    if config.norm == "rmsnorm":
        return nn.ParallelRMSNorm(config.hidden_size, dtype=config.dtype,
                               name=name)
    return nn.ParallelLayerNorm(config.hidden_size, dtype=config.dtype,
                                name=name)


class ParallelAttentionBlock(nn.Module):
    """Self-attention: fused QKV projection, rotary (LLaMA), GQA
    expansion, attention and the output projection."""

    def __init__(self, config: GPTConfig, layer_idx: int = 0):
        super().__init__()
        check_training_config(config)
        c = self.config = config
        q_size = c.num_heads * c.head_dim
        kv_size = c.kv_heads * c.head_dim
        self.qkv = nn.ColumnParallelLinear(
            c.hidden_size, q_size + 2 * kv_size, bias=(c.activation == "gelu"),
            dtype=c.dtype, init=NormalInitializer(0.0, c.init_std),
            name=f"h{layer_idx}.attn.qkv")
        self.out = nn.RowParallelLinear(
            q_size, c.hidden_size, bias=(c.activation == "gelu"),
            dtype=c.dtype,
            init=NormalInitializer(0.0, c.init_std / math.sqrt(2 * c.num_layers)),
            name=f"h{layer_idx}.attn.out")
        self.dropout = nn.Dropout(c.dropout) if c.dropout else None
        self._rotary_cache = {}

    def _rotary(self, seq_len: int):
        """fp32 numpy tables [1, s, 1, d], as the JAX package keeps them:
        they promote bf16 q/k to fp32."""
        if seq_len not in self._rotary_cache:
            d = self.config.head_dim
            inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d))
            ang = np.outer(np.arange(seq_len, dtype=np.float32), inv)
            emb = np.concatenate([ang, ang], axis=-1)
            self._rotary_cache[seq_len] = (
                np.cos(emb)[None, :, None, :].astype(np.float32),
                np.sin(emb)[None, :, None, :].astype(np.float32))
        return self._rotary_cache[seq_len]

    def forward(self, x, seq_len: int, segment_ids=None):
        c = self.config
        qkv = self.qkv(x)
        q_size = c.num_heads * c.head_dim
        kv_size = c.kv_heads * c.head_dim
        q = ops.getitem(qkv, (Ellipsis, slice(0, q_size)))
        k = ops.getitem(qkv, (Ellipsis, slice(q_size, q_size + kv_size)))
        v = ops.getitem(qkv, (Ellipsis, slice(q_size + kv_size, None)))
        q = q.reshape((-1, seq_len, c.num_heads, c.head_dim))
        k = k.reshape((-1, seq_len, c.kv_heads, c.head_dim))
        v = v.reshape((-1, seq_len, c.kv_heads, c.head_dim))
        if c.position == "rotary":
            cos, sin = self._rotary(seq_len)
            q = ops.rotary_embed(q, cos, sin)
            k = ops.rotary_embed(k, cos, sin)
        if c.kv_heads != c.num_heads:
            k = ops.repeat_kv(k, c.num_heads // c.kv_heads)
            v = ops.repeat_kv(v, c.num_heads // c.kv_heads)
        attn = ops.attention(q, k, v, causal=True, segment_ids=segment_ids)
        out = self.out(attn.reshape((-1, seq_len, q_size)))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class ParallelMLP(nn.Module):
    def __init__(self, config: GPTConfig, layer_idx: int = 0):
        super().__init__()
        c = config
        mult = 2 if c.activation == "swiglu" else 1
        self.up = nn.ColumnParallelLinear(
            c.hidden_size, c.ffn_size * mult, bias=(c.activation == "gelu"),
            dtype=c.dtype, init=NormalInitializer(0.0, c.init_std),
            name=f"h{layer_idx}.mlp.up")
        self.down = nn.RowParallelLinear(
            c.ffn_size, c.hidden_size, bias=(c.activation == "gelu"),
            dtype=c.dtype,
            init=NormalInitializer(0.0, c.init_std / math.sqrt(2 * c.num_layers)),
            name=f"h{layer_idx}.mlp.down")
        self.activation = c.activation
        self.dropout = nn.Dropout(c.dropout) if c.dropout else None

    def forward(self, x):
        h = self.up(x)
        if self.activation == "swiglu":
            h = ops.swiglu(h)
        elif self.activation == "gelu":
            h = ops.gelu(h)
        else:
            raise NotImplementedError(
                f"activation {self.activation!r}: this slice has gelu and "
                f"swiglu")
        out = self.down(h)
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, layer_idx: int):
        super().__init__()
        self.ln_1 = _norm(config, f"h{layer_idx}.ln_1")
        self.attn = ParallelAttentionBlock(config, layer_idx)
        self.ln_2 = _norm(config, f"h{layer_idx}.ln_2")
        self.mlp = ParallelMLP(config, layer_idx)

    def forward(self, x, seq_len: int, segment_ids=None):
        x = x + self.attn(self.ln_1(x), seq_len, segment_ids=segment_ids)
        return x + self.mlp(self.ln_2(x))


class GPTModel(nn.Module):
    """Embeddings, blocks and the final norm."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        check_training_config(config)
        c = self.config = config
        self.wte = nn.VocabParallelEmbedding(
            c.vocab_size, c.hidden_size, dtype=c.dtype,
            init=NormalInitializer(0.0, c.init_std), name="wte")
        if c.position == "learned":
            self.wpe = parallel_parameter(
                NormalInitializer(0.0, c.init_std),
                (c.max_seq_len, c.hidden_size), dtype=c.dtype, name="wpe")
        self.drop = nn.Dropout(c.dropout) if c.dropout else None
        self.h = nn.ModuleList([GPTBlock(c, i) for i in range(c.num_layers)])
        self.ln_f = _norm(config, "ln_f")

    def forward(self, input_ids, seq_len: Optional[int] = None,
                segment_ids=None):
        if seq_len is None:
            seq_len = input_ids.shape[-1]
        x = self.wte(input_ids)
        if self.config.position == "learned":
            x = x + ops.getitem(self.wpe, slice(0, seq_len))
        if self.drop is not None:
            x = self.drop(x)
        for block in self.h:
            x = block(x, seq_len, segment_ids=segment_ids)
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
                c.hidden_size, c.vocab_size, bias=False, dtype=c.dtype,
                init=NormalInitializer(0.0, c.init_std), name="lm_head")

    def logits(self, input_ids, seq_len: Optional[int] = None,
               segment_ids=None):
        x = self.transformer(input_ids, seq_len, segment_ids=segment_ids)
        if self.lm_head is None:
            return ops.matmul(x, self.transformer.wte.weight, trans_b=True)
        return self.lm_head(x)

    def forward(self, input_ids, labels=None, seq_len: Optional[int] = None,
                segment_ids=None):
        """``segment_ids``: [b, s] packed document ids."""
        logits = self.logits(input_ids, seq_len, segment_ids=segment_ids)
        if labels is None:
            return logits
        return nn.vocab_parallel_cross_entropy(
            logits, labels, ignore_index=-100)

