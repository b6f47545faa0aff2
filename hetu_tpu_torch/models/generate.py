"""Autoregressive generation with a dense KV cache (PyTorch port of
``hetu_tpu.models.generate``).

``generate`` is the port's own oracle: it runs plain tensor code and no
kernel, so the serving engine's output at temperature 0 is held against
it.  The cache is a preallocated ``[b, max_len, kvh, hd]`` tensor per
layer, written in place at the step's position (the JAX version
returns updated caches from ``lax.dynamic_update_slice``).

Weight layouts are the training layouts (``W [out, in]``,
``y = x @ W.T``).  Matrix products follow JAX's type promotion: a bf16
activation against fp32 weights computes in fp32.

Supported configs: learned or rotary positions, layernorm/rmsnorm,
gelu/swiglu/silu/relu MLPs, GQA, tied or untied lm_head.  MLA and MoE
configs come with later slices of the port and raise.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.dtype import torch_dtype
from .gpt import GPTConfig, check_serving_config


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` in the promoted dtype of the two operands."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt).T


def _norm_apply(cfg: GPTConfig, w, b, x):
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-6)
        return (xf * w).to(x.dtype)
    m = torch.mean(xf, -1, keepdim=True)
    v = torch.var(xf, -1, keepdim=True, unbiased=False)
    out = (xf - m) * torch.rsqrt(v + 1e-5) * w
    if b is not None:
        out = out + b
    return out.to(x.dtype)


def _act(cfg: GPTConfig, h):
    if cfg.activation == "swiglu":
        x1, x2 = torch.chunk(h, 2, dim=-1)  # silu(x1) * x2
        return F.silu(x1) * x2
    if cfg.activation == "gelu":
        return F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    if cfg.activation == "silu":
        return F.silu(h)
    return F.relu(h)


def _rotary_tables(cfg: GPTConfig, max_len: int, device=None):
    """fp32 ``(cos, sin)`` tables ``[max_len, head_dim]`` (base 10000)."""
    d = cfg.head_dim
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d))
    ang = np.outer(np.arange(max_len, dtype=np.float32), inv)
    emb = np.concatenate([ang, ang], axis=-1)
    return (torch.from_numpy(np.cos(emb)).to(device),
            torch.from_numpy(np.sin(emb)).to(device))


def _rope(x, cos, sin):
    # x: [b, s, h, d]; cos/sin: [s, d] (already position-gathered)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([-x2, x1], dim=-1)
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    return x * c + rot * s


def _as_tensor(v, device) -> torch.Tensor:
    t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
    return t.to(device)


class _Params:
    """state_dict view normalizing the two naming conventions: module
    paths (``transformer.h.0.attn.qkv.weight``) and tensor names
    (``h0.attn.qkv.weight``).  Values become tensors on ``device``;
    their dtype is kept."""

    @staticmethod
    def _norm(key: str) -> str:
        if key.startswith("transformer."):
            key = key[len("transformer."):]
        if key.startswith("h."):                    # h.0.attn -> h0.attn
            rest = key[2:]
            idx, _, tail = rest.partition(".")
            key = f"h{idx}.{tail}"
        return key

    def __init__(self, state: Dict[str, Any], cfg: GPTConfig,
                 device: Optional[torch.device] = None):
        self.s = {self._norm(k): _as_tensor(v, device)
                  for k, v in state.items()}
        self.cfg = cfg

    def __call__(self, name: str):
        return self.s.get(name)

    def layer(self, i: int, part: str):
        return self.s.get(f"h{i}.{part}")


def _linear(p: _Params, i: int, part: str, x):
    out = _mm(x, p.layer(i, f"{part}.weight"))
    b = p.layer(i, f"{part}.bias")
    return out + b if b is not None else out


def _mlp(cfg: GPTConfig, p: _Params, i: int, h):
    return _linear(p, i, "mlp.down", _act(cfg, _linear(p, i, "mlp.up", h)))


def _attn_step(cfg: GPTConfig, p: _Params, i: int, x, k_cache, v_cache,
               pos: int, cos, sin):
    """One attention pass for ``s_new`` tokens starting at position
    ``pos`` against caches holding everything before them.  The caches
    are updated in place.  Returns ``out [b, s_new, H]``."""
    b, s_new, _ = x.shape
    c = cfg
    hd, nh, nkv = c.head_dim, c.num_heads, c.kv_heads
    qkv = _linear(p, i, "attn.qkv", x)
    q_size, kv_size = nh * hd, nkv * hd
    q = qkv[..., :q_size].reshape(b, s_new, nh, hd)
    k = qkv[..., q_size:q_size + kv_size].reshape(b, s_new, nkv, hd)
    v = qkv[..., q_size + kv_size:].reshape(b, s_new, nkv, hd)
    if c.position == "rotary":
        idx = torch.arange(pos, pos + s_new, device=x.device)
        q = _rope(q, cos[idx], sin[idx])
        k = _rope(k, cos[idx], sin[idx])
    k_cache[:, pos:pos + s_new] = k.to(k_cache.dtype)
    v_cache[:, pos:pos + s_new] = v.to(v_cache.dtype)
    L = k_cache.shape[1]
    g = nh // nkv
    kk = k_cache.repeat_interleave(g, dim=2) if g > 1 else k_cache
    vv = v_cache.repeat_interleave(g, dim=2) if g > 1 else v_cache
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          kk.float()) / math.sqrt(hd)
    kpos = torch.arange(L, device=x.device)[None, None, None, :]
    qpos = (pos + torch.arange(s_new, device=x.device))[None, None, :, None]
    scores = scores.masked_fill(kpos > qpos, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs,
                        vv.float()).to(x.dtype)
    attn = attn.reshape(b, s_new, nh * hd)
    return _linear(p, i, "attn.out", attn)


def _lm_head(p: _Params, x):
    """LM-head projection for already-normed hidden states ``x [b, H]``
    -> fp32 logits ``[b, V]``."""
    head = p("lm_head.weight")
    w = head if head is not None else p("wte.weight")
    return x.float() @ w.float().T


def _forward(cfg: GPTConfig, p: _Params, ids, caches, pos: int, cos, sin):
    """Stack forward for ``ids [b, s_new]`` at absolute position
    ``pos``: last-position logits ``[b, V]`` (caches written in place)."""
    c = cfg
    x = p("wte.weight")[ids.long()].to(
        torch.bfloat16 if c.dtype == "bfloat16" else torch.float32)
    if c.position == "learned":
        idx = torch.arange(pos, pos + ids.shape[1], device=ids.device)
        x = x + p("wpe")[idx].to(x.dtype)
    for i in range(c.num_layers):
        k_cache, v_cache = caches[i]
        h = _norm_apply(c, p.layer(i, "ln_1.weight"),
                        p.layer(i, "ln_1.bias"), x)
        x = x + _attn_step(c, p, i, h, k_cache, v_cache, pos, cos, sin)
        h = _norm_apply(c, p.layer(i, "ln_2.weight"),
                        p.layer(i, "ln_2.bias"), x)
        x = x + _mlp(c, p, i, h)
    x = _norm_apply(c, p("ln_f.weight"), p("ln_f.bias"), x)
    return _lm_head(p, x[:, -1])


def decode_step(cfg: GPTConfig, p: _Params, tokens, caches, pos: int, cos,
                sin):
    """Single decode step against dense ``[b, max_len, kvh, hd]``
    caches: ``tokens [b, s_new]`` at absolute position ``pos`` ->
    last-position logits ``[b, V]``; the caches are written in place."""
    return _forward(cfg, p, tokens, caches, pos, cos, sin)


@torch.no_grad()
def generate(state: Dict[str, Any], cfg: GPTConfig, prompt_ids,
             max_new_tokens: int, temperature: float = 0.0,
             top_k: int = 0, seed: int = 0,
             device="cuda") -> torch.Tensor:
    """Decode ``max_new_tokens`` tokens after ``prompt_ids [b, s0]``.

    ``temperature == 0`` -> greedy (``torch.argmax``, the first
    maximum, as ``jnp.argmax``); otherwise softmax sampling with
    optional ``top_k`` truncation, drawn from a ``torch.Generator``
    seeded with ``seed``.  Returns ``[b, s0 + max_new_tokens]`` int32
    on ``device``.
    """
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    check_serving_config(cfg)
    dev = resolve_device(device)
    prompt_ids = torch.as_tensor(np.asarray(prompt_ids, np.int32)).to(dev)
    if max_new_tokens == 0:
        return prompt_ids
    p = _Params(state, cfg, dev)
    b, s0 = prompt_ids.shape
    max_len = s0 + max_new_tokens
    if cfg.position == "learned" and max_len > cfg.max_seq_len:
        raise ValueError(f"max_len {max_len} exceeds learned-position "
                         f"table {cfg.max_seq_len}")
    cdt = torch_dtype("bfloat16" if cfg.dtype == "bfloat16" else "float32")
    cos, sin = (_rotary_tables(cfg, max_len, dev)
                if cfg.position == "rotary" else (None, None))
    caches = [(torch.zeros(b, max_len, cfg.kv_heads, cfg.head_dim,
                           dtype=cdt, device=dev),
               torch.zeros(b, max_len, cfg.kv_heads, cfg.head_dim,
                           dtype=cdt, device=dev))
              for _ in range(cfg.num_layers)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def pick(logits):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        lg = logits / temperature
        if top_k > 0:
            kth = torch.sort(lg, dim=-1).values[:, -top_k][:, None]
            lg = lg.masked_fill(lg < kth, float("-inf"))
        return torch.multinomial(torch.softmax(lg, -1), 1,
                                 generator=gen)[:, 0].to(torch.int32)

    out = [prompt_ids]
    tok = pick(decode_step(cfg, p, prompt_ids, caches, 0, cos, sin))
    out.append(tok[:, None])
    for pos in range(s0, max_len - 1):
        tok = pick(decode_step(cfg, p, tok[:, None], caches, pos, cos, sin))
        out.append(tok[:, None])
    return torch.cat(out, dim=1)
