"""The unified serving step: ragged prefill + decode in one call (port
of ``hetu_tpu.serving.decode.build_unified_step_fn`` for the dense,
non-speculative configurations: full-head and MLA).

Token-axis layout (fixed by the engine)::

    [0 .. max_seqs)                    decode slots, 1 token each
    [max_seqs .. max_seqs + R*chunk)   R = prefill_rows chunk slots

Every layer runs the projections and the MLP over the token axis,
scatters each token's k/v into its page at ``(token_page, token_off)``
(padding tokens land in the trash page), and attends raggedly through
:func:`~hetu_tpu_torch.ops.ragged_paged_attention.ragged_paged_attention`,
which launches the CUDA kernel for CUDA tensors and runs the plain
version for CPU tensors.  Sampling is on the device (``sample_rows``);
the engine reads back ``[rows]`` int32 token ids, never logits.

An MLA config (``cfg.is_mla``) stores ONE latent stream per layer: the
``q`` and ``kv_a`` projections run over the token axis, ``k_up`` is
absorbed into the query in fp32, the decoupled slices are rotated, each
token's latent goes into ``k_pages`` (its ``quantize_rows`` codes under
``page_quant``, with the absmax in ``v_pages``) and its rope key into
``v_pages``, attention runs through
:func:`~hetu_tpu_torch.ops.ragged_paged_attention.latent_ragged_paged_attention`
and ``v_up`` is folded in per query token.  Where the JAX step without a
kernel splits the rows over a ladder of page-window sizes
(``_split_latent_ragged_attention``, ``-inf`` masking), the port's CPU
path runs the ragged plain version over all rows, as it does for the
full-head layout.

Where JAX skips an idle chunk slot with ``lax.cond`` on a device value,
the port decides on the host: the step receives its metadata as numpy
arrays, uploads them in one copy, and skips a chunk slot whose host-side
``q_len`` is 0 (and the padding tail of a live one) in Python.  Nothing
branches on a device tensor's value.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.dtype import torch_dtype
from ..models.generate import (_act, _lm_head, _linear, _norm_apply,
                               _Params, _rotary_tables)
from ..models.gpt import GPTConfig, check_serving_config
from ..ops.quantization import quantize_rows
from ..ops.ragged_paged_attention import (latent_ragged_paged_attention,
                                          ragged_paged_attention,
                                          sample_rows)


class _StepMeta(NamedTuple):
    """One step's metadata on the device, as the attention paths read it."""
    token_page: torch.Tensor            # [T] int64, KV write plan
    token_off: torch.Tensor             # [T] int64
    q_lens: torch.Tensor                # [rows] int32
    cu_q: torch.Tensor                  # [rows + 1] int32
    page_tables: torch.Tensor           # [rows, max_pages] int32
    ctx_lens: torch.Tensor              # [rows] int32
    cos: Optional[torch.Tensor]         # [T, d] rotary tables at the
    sin: Optional[torch.Tensor]         # tokens' positions, or None


def _params_view(cfg: GPTConfig, params) -> _Params:
    p = _Params.__new__(_Params)
    p.s, p.cfg = params, cfg
    return p


def _rope_tok(x, cos_g, sin_g):
    """Rotary embedding at per-token positions: x [T, h, d], cos_g/sin_g
    [T, d] (already position-gathered); same arithmetic as
    ``generate._rope``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([-x2, x1], dim=-1)
    return x * cos_g[:, None, :].to(x.dtype) + rot * sin_g[:, None, :].to(
        x.dtype)


def build_unified_step_fn(cfg: GPTConfig, max_seqs: int, chunk: int,
                          prefill_rows: int, max_pages: int,
                          page_size: int, device=None, page_quant=None):
    """Build THE serving step: one ragged prefill+decode call.

    fn(params,
       tokens [T], token_pos [T], token_page [T], token_off [T],
       q_lens [rows], cu_q [rows+1], page_tables [rows, max_pages],
       ctx_lens [rows], temps [rows], top_ps [rows], top_ks [rows],
       seeds [rows],                      # numpy (int32 / float32)
       k_pages, v_pages)                  # per-layer page tensors
      -> next_tokens [rows] int32 on the device

    where ``rows = max_seqs + prefill_rows`` and ``T = max_seqs +
    prefill_rows * chunk``.  Every row gets a next-token sample at its
    last query token.  ``k_pages``/``v_pages`` are updated in place.
    ``page_quant`` ("int8" or "nf4") stores an MLA config's latents as
    per-token absmax codes.
    """
    if prefill_rows < 1:
        raise ValueError(f"prefill_rows must be >= 1, got {prefill_rows}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    check_serving_config(cfg)
    c = cfg
    if page_quant is not None and (not c.is_mla or c.rope_dim):
        raise ValueError("page_quant requires the latent (MLA) layout "
                         "with rope_dim == 0")
    t_tokens = max_seqs + prefill_rows * chunk
    n_rows = max_seqs + prefill_rows
    cdt = torch_dtype("bfloat16" if c.dtype == "bfloat16" else "float32")
    cos, sin = (_rotary_tables(c, max_pages * page_size, device)
                if c.position == "rotary" else (None, None))
    hd, nh, nkv = c.head_dim, c.num_heads, c.kv_heads
    chunk_starts = [(max_seqs + r, max_seqs + r * chunk)
                    for r in range(prefill_rows)]

    def region_map(f, h, q_lens):
        """Apply the row-wise map ``f`` over the decode slots and over
        the live tokens of each chunk slot; idle tokens stay 0."""
        dec = f(h[:max_seqs])
        out = dec.new_zeros((t_tokens, dec.shape[-1]))
        out[:max_seqs] = dec
        for row, start in chunk_starts:
            n = int(q_lens[row])
            if n:
                out[start:start + n] = f(h[start:start + n])
        return out

    def full_head_attention(p, i, h, q_lens, kp, vp, m: _StepMeta):
        qkv = region_map(lambda hh: _linear(p, i, "attn.qkv", hh), h, q_lens)
        q_size, kv_size = nh * hd, nkv * hd
        q = qkv[:, :q_size].reshape(t_tokens, nh, hd)
        k = qkv[:, q_size:q_size + kv_size].reshape(t_tokens, nkv, hd)
        v = qkv[:, q_size + kv_size:].reshape(t_tokens, nkv, hd)
        if c.position == "rotary":
            q = _rope_tok(q, m.cos, m.sin)
            k = _rope_tok(k, m.cos, m.sin)
        # KV page scatter, in place: JAX donates the page buffers and
        # scatters into the returned arrays instead
        kp.index_put_((m.token_page, m.token_off), k.to(cdt))
        vp.index_put_((m.token_page, m.token_off), v.to(cdt))
        attn = ragged_paged_attention(
            q.to(kp.dtype).contiguous(), kp, vp, m.q_lens, m.cu_q,
            m.page_tables, m.ctx_lens, max_q=chunk)
        return attn.reshape(t_tokens, nh * hd)

    def mla_attention(p, i, h, q_lens, kp, vp, m: _StepMeta):
        d_c, d_r = c.kv_latent_dim, c.rope_dim
        qh = region_map(lambda hh: _linear(p, i, "attn.q", hh), h,
                        q_lens).reshape(t_tokens, nh, hd + d_r)
        kv = region_map(lambda hh: _linear(p, i, "attn.kv_a", hh), h,
                        q_lens)                           # [T, d_c + d_r]
        c_kv = kv[:, :d_c]
        # absorption: fold k_up into q, so scores are MQA dot products
        # against the latent stream
        q_cat = torch.einsum("thd,hdc->thc", qh[..., :hd].float(),
                             p.layer(i, "attn.k_up.weight").float())
        if d_r:
            q_rope = _rope_tok(qh[..., hd:], m.cos, m.sin)
            k_rope = _rope_tok(kv[:, None, d_c:], m.cos, m.sin)
            q_cat = torch.cat([q_cat, q_rope.float()], dim=-1)
        # KV page scatter, in place
        where = (m.token_page, m.token_off)
        if page_quant:
            codes, absmax = quantize_rows(c_kv, page_quant)
            kp.index_put_(where, codes[:, None, :])
            vp.index_put_(where, absmax[:, None, :])
        else:
            kp.index_put_(where, c_kv[:, None, :].to(cdt))
            if d_r:
                vp.index_put_(where, k_rope.to(cdt))
        o_lat = latent_ragged_paged_attention(
            q_cat.contiguous(), kp,
            None if (page_quant or not d_r) else vp, m.q_lens, m.cu_q,
            m.page_tables, m.ctx_lens, max_q=chunk, softmax_scale=(hd + d_r) ** -0.5,
            scale_pages=vp if page_quant else None, quant=page_quant,
            latent_dim=d_c)
        # the v_up fold: one up-projection per QUERY token; cached tokens
        # are never decompressed
        attn = torch.einsum("thc,hdc->thd", o_lat,
                            p.layer(i, "attn.v_up.weight").float())
        return attn.reshape(t_tokens, nh * hd)

    attention = mla_attention if c.is_mla else full_head_attention

    @torch.no_grad()
    def run(params, tokens, token_pos, token_page, token_off, q_lens,
            cu_q, page_tables, ctx_lens, temps, top_ps, top_ks, seeds,
            k_pages, v_pages):
        p = _params_view(c, params)
        dev = k_pages[0].device
        # per-row last TRUE query token (the row's sampling position)
        last = np.clip(cu_q[:n_rows] + np.maximum(q_lens, 1) - 1, 0,
                       t_tokens - 1).astype(np.int32)
        host = [tokens, token_pos, token_page, token_off, q_lens, cu_q,
                page_tables, ctx_lens, top_ks, seeds, last,
                temps.view(np.int32), top_ps.view(np.int32)]
        buf = torch.from_numpy(np.concatenate(
            [np.ascontiguousarray(a, np.int32).ravel() for a in host]))
        buf = buf.to(dev)                      # one host-to-device copy
        views, off = [], 0
        for a in host:
            views.append(buf[off:off + a.size].view(a.shape))
            off += a.size
        (tok_d, pos_d, page_d, off_d, ql_d, cu_d, pt_d, cl_d, tk_d,
         sd_d, last_d, temps_d, tps_d) = views
        temps_d = temps_d.view(torch.float32)
        tps_d = tps_d.view(torch.float32)
        pos_l = pos_d.long()
        meta = _StepMeta(page_d.long(), off_d.long(), ql_d, cu_d, pt_d, cl_d,
                         *((cos[pos_l], sin[pos_l])
                           if c.position == "rotary" else (None, None)))

        x = p("wte.weight")[tok_d.long()].to(cdt)            # [T, H]
        if c.position == "learned":
            x = x + p("wpe")[pos_l].to(x.dtype)
        for i in range(c.num_layers):
            h = _norm_apply(c, p.layer(i, "ln_1.weight"),
                            p.layer(i, "ln_1.bias"), x)
            attn = attention(p, i, h, q_lens, k_pages[i], v_pages[i],
                             meta).to(x.dtype)
            x = x + region_map(
                lambda aa, i=i: _linear(p, i, "attn.out", aa), attn, q_lens)
            h = _norm_apply(c, p.layer(i, "ln_2.weight"),
                            p.layer(i, "ln_2.bias"), x)
            x = x + region_map(
                lambda hh, i=i: _linear(
                    p, i, "mlp.down", _act(c, _linear(p, i, "mlp.up", hh))),
                h, q_lens)
        # the final norm is row-wise: norm only the rows' last tokens
        xl = _norm_apply(c, p("ln_f.weight"), p("ln_f.bias"),
                         x[last_d.long()])
        logits = _lm_head(p, xl)                             # [rows, V]
        return sample_rows(logits, temps_d, tps_d, tk_d, sd_d, cl_d,
                           sampled=bool((temps > 0).any()))

    return run
