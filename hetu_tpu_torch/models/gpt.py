"""GPT-2 / LLaMA model configuration.

``GPTConfig`` is a field-for-field copy of ``hetu_tpu.models.gpt``'s, so
one set of keyword arguments describes a model to both packages and a
state dict carries across unchanged.  The training model comes with the
training slice of the port; serving and ``generate`` need only the
config.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


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
