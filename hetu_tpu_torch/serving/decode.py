"""The unified serving step: ragged prefill + decode in one call (port
of ``hetu_tpu.serving.decode.build_unified_step_fn`` for the plain,
dense, non-speculative configuration).

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

Where JAX skips an idle chunk slot with ``lax.cond`` on a device value,
the port decides on the host: the step receives its metadata as numpy
arrays, uploads them in one copy, and skips a chunk slot whose host-side
``q_len`` is 0 (and the padding tail of a live one) in Python.  Nothing
branches on a device tensor's value.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import torch_dtype
from ..models.generate import (_act, _lm_head, _linear, _norm_apply,
                               _Params, _rotary_tables)
from ..models.gpt import GPTConfig, check_serving_config
from ..ops.ragged_paged_attention import ragged_paged_attention, sample_rows


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
                          page_size: int, device=None):
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
    """
    if prefill_rows < 1:
        raise ValueError(f"prefill_rows must be >= 1, got {prefill_rows}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    check_serving_config(cfg)
    c = cfg
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
        pos_l, page_l, off_l = pos_d.long(), page_d.long(), off_d.long()

        x = p("wte.weight")[tok_d.long()].to(cdt)            # [T, H]
        if c.position == "learned":
            x = x + p("wpe")[pos_l].to(x.dtype)
        if c.position == "rotary":
            cos_g, sin_g = cos[pos_l], sin[pos_l]
        for i in range(c.num_layers):
            h = _norm_apply(c, p.layer(i, "ln_1.weight"),
                            p.layer(i, "ln_1.bias"), x)
            qkv = region_map(lambda hh, i=i: _linear(p, i, "attn.qkv", hh),
                             h, q_lens)
            q_size, kv_size = nh * hd, nkv * hd
            q = qkv[:, :q_size].reshape(t_tokens, nh, hd)
            k = qkv[:, q_size:q_size + kv_size].reshape(t_tokens, nkv, hd)
            v = qkv[:, q_size + kv_size:].reshape(t_tokens, nkv, hd)
            if c.position == "rotary":
                q = _rope_tok(q, cos_g, sin_g)
                k = _rope_tok(k, cos_g, sin_g)
            # KV page scatter, in place: JAX donates the page buffers
            # and scatters into the returned arrays instead
            k_pages[i].index_put_((page_l, off_l), k.to(cdt))
            v_pages[i].index_put_((page_l, off_l), v.to(cdt))
            attn = ragged_paged_attention(
                q.to(k_pages[i].dtype).contiguous(), k_pages[i],
                v_pages[i], ql_d, cu_d, pt_d, cl_d, max_q=chunk)
            attn = attn.reshape(t_tokens, nh * hd).to(x.dtype)
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
