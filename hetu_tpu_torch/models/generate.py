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
gelu/swiglu/silu/relu MLPs, GQA, tied or untied lm_head, MLA (one
latent cache ``[b, max_len, 1, d_c]`` plus the decoupled rope key
``[b, max_len, 1, d_r]`` per layer) and MoE layers.  An MoE layer routes
each token to its top-k experts (gate logits in the model dtype, the
softmax in fp32, ties toward the lower expert): a single new token (a
decode step) takes the dense mix of every expert weighted by its gate
(zero off the top k), a longer span (a prefill) the blocked group GEMM
(``ops.moe_dispatch``), which drops no token.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.dtype import torch_dtype
from ..ops.moe_dispatch import blocked_group_gemm
from .gpt import GPTConfig, check_serving_config, moe_activation


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
    """fp32 ``(cos, sin)`` tables ``[max_len, d]`` (base 10000).  MLA
    rotates only the decoupled rope slice (``d = cfg.rope_dim``);
    full-head rotates the whole head."""
    d = cfg.rope_dim if cfg.is_mla else cfg.head_dim
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
    """Layer ``i``'s feed-forward block: the dense MLP or the MoE layer."""
    if cfg.is_moe_layer(i):
        return _moe_mlp(cfg, p, i, h)
    return _linear(p, i, "mlp.down", _act(cfg, _linear(p, i, "mlp.up", h)))


def _moe_params(p: _Params, i: int):
    """Layer ``i``'s gate and experts: ``mlp.moe.*`` (module paths) or
    ``moe.*`` (tensor names)."""
    def moe_p(part):
        v = p.layer(i, f"mlp.moe.{part}")
        return v if v is not None else p.layer(i, f"moe.{part}")
    return (moe_p("gate.wg"), moe_p("experts.w1"), moe_p("experts.b1"),
            moe_p("experts.w2"), moe_p("experts.b2"))


def _moe_route(cfg: GPTConfig, wg, x):
    """Top-k routing shared by the dense and dispatched paths: the gate
    logits in the model dtype, the softmax in fp32."""
    from ..nn.moe import top_k
    gates = torch.softmax((x @ wg.to(x.dtype).T).float(), -1)
    topv, topi = top_k(gates, cfg.moe_top_k)               # [..., k]
    return gates, topv, topi


def _moe_act(cfg: GPTConfig):
    from ..nn.moe import ACTIVATIONS
    return ACTIVATIONS[moe_activation(cfg)]


def _moe_mlp(cfg: GPTConfig, p: _Params, i: int, x):
    """The MoE layer on ``x [b, s, H]``: for ``s == 1`` the dense mix of
    all experts (each run on every token, its output weighted by the
    token's gate, zero off the top k); for ``s > 1``
    :func:`_moe_mlp_dispatched`."""
    wg, w1, b1, w2, b2 = _moe_params(p, i)
    if x.shape[1] > 1:
        return _moe_mlp_dispatched(cfg, x, wg, w1, b1, w2, b2)
    return _moe_dense_mix(cfg, x, wg, w1, b1, w2, b2)


def _moe_dense_mix(cfg: GPTConfig, x, wg, w1, b1, w2, b2):
    """Every expert on every token of ``x [..., H]``, mixed by the gates
    of each token's top k."""
    from ..nn.moe import _one_hot
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    gates, topv, topi = _moe_route(cfg, wg, xt)
    weights = torch.zeros_like(gates)
    for j in range(cfg.moe_top_k):
        weights = weights + topv[:, j:j + 1] * _one_hot(
            topi[:, j], gates.shape[-1], gates.dtype)
    dt = torch.promote_types(xt.dtype, w1.dtype)
    h = _moe_act(cfg)(torch.matmul(xt.to(dt)[None], w1.to(dt)) + b1)
    dt = torch.promote_types(h.dtype, w2.dtype)
    y = torch.matmul(h.to(dt), w2.to(dt)) + b2             # [E, T, H]
    out = torch.einsum("te,etd->td", weights, y.float())
    return out.to(x.dtype).reshape(shape)


def _moe_mlp_dispatched(cfg: GPTConfig, x, wg, w1, b1, w2, b2):
    """The capacity-free dispatched MoE layer (a prefill): the blocked
    group GEMM over the tokens of ``x [b, s, H]``, none dropped."""
    b, s, d = x.shape
    _, topv, topi = _moe_route(cfg, wg, x.reshape(b * s, d))
    out = blocked_group_gemm(x.reshape(b * s, d), topi, topv, w1, b1, w2,
                             b2, _moe_act(cfg))
    return out.reshape(b, s, d).to(x.dtype)


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


def _mla_attn_step(cfg: GPTConfig, p: _Params, i: int, x, c_cache, r_cache,
                   pos: int, cos, sin):
    """MLA twin of :func:`_attn_step` over LATENT caches: ``c_cache``
    [b, max_len, 1, d_c] holds the shared compressed KV stream,
    ``r_cache`` [b, max_len, 1, d_r] the decoupled rotated key (width 0
    for learned positions).  Weight absorption: scores are ``(q_nope @
    k_up) . c`` per query head and the attention output stays latent
    until one ``v_up`` product per QUERY token, so no cached token is
    ever decompressed.  The serving step computes the same
    contractions.  The caches are updated in place."""
    b, s_new, _ = x.shape
    c = cfg
    hd, nh = c.head_dim, c.num_heads
    d_c, d_r = c.kv_latent_dim, c.rope_dim
    q = _linear(p, i, "attn.q", x).reshape(b, s_new, nh, hd + d_r)
    kv = _linear(p, i, "attn.kv_a", x)
    k_up = p.layer(i, "attn.k_up.weight")                 # [nh, hd, d_c]
    v_up = p.layer(i, "attn.v_up.weight")
    q_abs = torch.einsum("bshd,hdc->bshc", q[..., :hd].float(), k_up.float())
    c_cache[:, pos:pos + s_new] = kv[..., None, :d_c].to(c_cache.dtype)
    if d_r:
        idx = torch.arange(pos, pos + s_new, device=x.device)
        q_rope = _rope(q[..., hd:], cos[idx], sin[idx])
        k_rope = _rope(kv[..., None, d_c:], cos[idx], sin[idx])
        r_cache[:, pos:pos + s_new] = k_rope.to(r_cache.dtype)
        q_cat = torch.cat([q_abs, q_rope.float()], dim=-1)
        k_cat = torch.cat([c_cache, r_cache], dim=-1)[:, :, 0]
    else:
        q_cat, k_cat = q_abs, c_cache[:, :, 0]            # [b, L, d_c]
    L = c_cache.shape[1]
    scores = torch.einsum("bshc,bkc->bhsk", q_cat,
                          k_cat.float()) / math.sqrt(hd + d_r)
    kpos = torch.arange(L, device=x.device)[None, None, None, :]
    qpos = (pos + torch.arange(s_new, device=x.device))[None, None, :, None]
    scores = scores.masked_fill(kpos > qpos, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhsk,bkc->bshc", probs, c_cache[:, :, 0].float())
    attn = torch.einsum("bshc,hdc->bshd", o_lat, v_up.float()).to(x.dtype)
    return _linear(p, i, "attn.out", attn.reshape(b, s_new, nh * hd))


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
        step = _mla_attn_step if c.is_mla else _attn_step
        x = x + step(c, p, i, h, k_cache, v_cache, pos, cos, sin)
        h = _norm_apply(c, p.layer(i, "ln_2.weight"),
                        p.layer(i, "ln_2.bias"), x)
        x = x + _mlp(c, p, i, h)
    x = _norm_apply(c, p("ln_f.weight"), p("ln_f.bias"), x)
    return _lm_head(p, x[:, -1])


def decode_step(cfg: GPTConfig, p: _Params, tokens, caches, pos: int, cos,
                sin):
    """Single decode step against dense ``[b, max_len, kvh, hd]``
    caches (MLA: the latent and rope caches): ``tokens [b, s_new]`` at absolute position ``pos`` ->
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
    if cfg.is_mla:
        # one shared latent stream and the (optional) decoupled rope key,
        # as the paged pool's latent k/v pages
        shapes = ((b, max_len, 1, cfg.kv_latent_dim),
                  (b, max_len, 1, cfg.rope_dim))
    else:
        shapes = ((b, max_len, cfg.kv_heads, cfg.head_dim),) * 2
    caches = [tuple(torch.zeros(s, dtype=cdt, device=dev) for s in shapes)
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
