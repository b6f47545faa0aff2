"""The unified serving step: ragged prefill + decode in one call (port
of ``hetu_tpu.serving.decode.build_unified_step_fn``: dense and MoE
configurations, full-head and MLA, speculative or not).

Token-axis layout (fixed by the engine)::

    [0 .. max_seqs)                    decode slots, 1 token each
    [max_seqs .. max_seqs + R*chunk)   R = prefill_rows chunk slots
    [.. + max_seqs*(spec_k+1))         spec mode: one verify slot of
                                       spec_k + 1 tokens per sequence

Every layer runs the projections and the MLP over the token axis,
scatters each token's k/v into its page at ``(token_page, token_off)``
(padding tokens land in the trash page), and attends raggedly through
:func:`~hetu_tpu_torch.ops.ragged_paged_attention.ragged_paged_attention`,
which launches the CUDA kernel for CUDA tensors and runs the plain
version for CPU tensors.  Sampling is on the device (``sample_rows``);
the engine reads back ``[rows]`` int32 token ids, never logits.

In spec mode (``spec_k > 0``) a verify row feeds the last committed
token and its drafts; it is a chunk row to the attention, which attends
``max(chunk, spec_k + 1)`` tokens a row (``max_q``), so a verify row
wider than a chunk is attended whole.  The verify head
(``speculative_verify_head``) reads the logits at the row's first
``spec_k`` positions and returns the accepted prefix length; its logits
come from the same LM-head call as the rows' own samples.  A row with no
drafts gets ``accepted`` 0 and its own sample, as in the non-spec step.

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

The step receives its metadata as numpy arrays and packs them into one
static host buffer (pinned on the card), copied into one static device
buffer of the same layout; nothing branches on a device tensor's value.
Where JAX skips an idle chunk slot with ``lax.cond`` on a device value,
the port decides on the host, in two ways:

- On the card the step is compiled (``core/capture.py``): a body of
  fixed shapes, captured in one CUDA graph per **live chunk-slot mask**
  and, in spec mode, whether the verify region is live (at most
  ``2**prefill_rows`` graphs, ``2**(prefill_rows + 1)`` in spec mode),
  for each engine's pool that the step serves, and replayed after
  that.  A live chunk slot is computed at its full
  ``chunk`` width, as JAX's ``lax.cond`` branch is, and a live verify
  region whole, as JAX computes it unconditionally; an idle one is not
  computed and its tokens stay 0, and an idle verify region skips the
  verify head.  Sampling always takes the sampled path, whose
  ``torch.where`` gives temperature-0 rows exactly the greedy token.
- On the CPU the step stays eager: it computes only the live tokens of
  a live chunk slot or verify row and skips the sort of
  ``sample_rows`` when no row samples.

Padding tokens write to the trash page either way.

An MoE layer takes the dense mix of every expert for the decode slots
and the verify region, and the dispatched group GEMM for each chunk
slot's tokens, one call a slot (``_region_map``'s ``f_chunk``), as the
JAX step does; neither reads a device value on the host, so the step
stays one captured graph a live mask.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import capture
from ..core.device import resolve_device
from ..core.dtype import torch_dtype
from ..models.generate import (_act, _lm_head, _linear, _moe_dense_mix,
                               _moe_mlp_dispatched, _moe_params,
                               _norm_apply, _Params, _rotary_tables)
from ..models.gpt import GPTConfig, check_serving_config
from ..ops.quantization import quantize_rows
from ..ops.ragged_paged_attention import (latent_ragged_paged_attention,
                                          ragged_paged_attention,
                                          sample_rows,
                                          speculative_verify_head)


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




# the packed metadata, in the order of the static buffers: name, rows
# (None: the token axis), and whether it holds float32 bits
_PACKED = (("tokens", None), ("token_pos", None), ("token_page", None),
           ("token_off", None), ("q_lens", 0), ("cu_q", 1),
           ("page_tables", 0), ("ctx_lens", 0), ("top_ks", 0),
           ("seeds", 0), ("spec_lens", 0), ("last", 0), ("temps", 0),
           ("top_ps", 0))
_FLOAT_FIELDS = ("temps", "top_ps")


class UnifiedStep:
    """THE serving step: one ragged prefill+decode call.

    step(params,
         tokens [T], token_pos [T], token_page [T], token_off [T],
         q_lens [rows], cu_q [rows+1], page_tables [rows, max_pages],
         ctx_lens [rows], temps [rows], top_ps [rows], top_ks [rows],
         seeds [rows],                      # numpy (int32 / float32)
         [spec_lens [rows],]                # spec mode only
         k_pages, v_pages)                  # per-layer page tensors
      -> next_tokens [rows] int32 on the device
         (spec mode: (next_tokens, accepted [rows] int32))

    where ``rows = max_seqs + prefill_rows (+ max_seqs)`` and ``T =
    max_seqs + prefill_rows * chunk (+ max_seqs * (spec_k + 1))``.
    Every row gets a next-token sample at its last query token; a live
    verify row's token is the bonus token (the first rejection's
    alternative, or its last position's sample on full acceptance).
    ``k_pages``/``v_pages`` are updated in place.  ``page_quant``
    ("int8" or "nf4") stores an MLA config's latents as per-token absmax
    codes.

    On the card the step replays the CUDA graph of its binding and live
    mask, captured at the first step with that pair; the returned
    tensors are the graph's outputs, which the next step of that graph
    overwrites.  A binding is the params and page tensors of a call (by
    identity): identically shaped engines (cluster replicas) share one
    step object, with its static buffers, rotary tables and body, and
    each engine's pool gets its own graphs.  All the graphs share one
    memory pool and one side stream, and replay one at a time, so N
    replicas do not reserve N activation pools.  ``fixed`` runs the same
    fixed-shape body eagerly on any device.
    """

    def __init__(self, cfg: GPTConfig, max_seqs: int, chunk: int,
                 prefill_rows: int, max_pages: int, page_size: int,
                 device=None, page_quant=None, spec_k: int = 0):
        if prefill_rows < 1:
            raise ValueError(f"prefill_rows must be >= 1, got {prefill_rows}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        check_serving_config(cfg)
        if page_quant is not None and (not cfg.is_mla or cfg.rope_dim):
            raise ValueError("page_quant requires the latent (MLA) layout "
                             "with rope_dim == 0")
        self.cfg, self.page_quant = cfg, page_quant
        self.max_seqs, self.chunk, self.spec_k = max_seqs, chunk, spec_k
        self.device = resolve_device(device)
        # what an engine sharing this step must match
        self.layout = (cfg, max_seqs, chunk, prefill_rows, max_pages,
                       page_size, page_quant, spec_k, self.device)
        # a verify row is attended whole even when wider than a chunk
        self.max_q = max(chunk, spec_k + 1)
        verify_rows = max_seqs if spec_k else 0
        self.n_tokens = max_seqs + prefill_rows * chunk \
            + verify_rows * (spec_k + 1)
        self.n_rows = max_seqs + prefill_rows + verify_rows
        # first verify row and first verify token
        self._v0 = max_seqs + prefill_rows
        self._vstart = max_seqs + prefill_rows * chunk
        self._cdt = torch_dtype("bfloat16" if cfg.dtype == "bfloat16"
                                else "float32")
        self._cos, self._sin = (
            _rotary_tables(cfg, max_pages * page_size, self.device)
            if cfg.position == "rotary" else (None, None))
        # (row, first token) of each chunk slot
        self._chunk_starts = [(max_seqs + r, max_seqs + r * chunk)
                              for r in range(prefill_rows)]
        shapes = {None: (self.n_tokens,), 0: (self.n_rows,),
                  1: (self.n_rows + 1,)}
        shapes = {name: ((self.n_rows, max_pages) if name == "page_tables"
                         else shapes[rows]) for name, rows in _PACKED}
        size = sum(int(np.prod(s)) for s in shapes.values())
        on_card = self.device.type == "cuda"
        # the static buffers: numpy writes into the host one, one copy
        # moves it, and the body reads views of the device one
        self._host = torch.zeros(size, dtype=torch.int32,
                                 pin_memory=on_card)
        self._host_np = self._host.numpy()
        self._buf = torch.zeros(size, dtype=torch.int32, device=self.device)
        self._slices, self._views, off = [], {}, 0
        for name, _ in _PACKED:
            n = int(np.prod(shapes[name]))
            view = self._buf[off:off + n].view(shapes[name])
            self._views[name] = view.view(torch.float32) \
                if name in _FLOAT_FIELDS else view
            self._slices.append(slice(off, off + n))
            off += n
        self._copied = None           # the event after the last upload
        self._graphs = capture.StepCache("unified serving step")
        # the bindings seen so far: (params, k_pages, v_pages)
        self._bindings = []

    # -- host packing ----------------------------------------------------

    def _pack(self, tokens, token_pos, token_page, token_off, q_lens, cu_q,
              page_tables, ctx_lens, temps, top_ps, top_ks, seeds,
              spec_lens=None):
        """Writes the step's metadata into the static host buffer and
        copies it to the device buffer (``non_blocking`` from pinned
        memory on the card)."""
        # per-row last TRUE query token (the row's sampling position)
        last = np.clip(cu_q[:self.n_rows] + np.maximum(q_lens, 1) - 1, 0,
                       self.n_tokens - 1)
        arrays = {"tokens": tokens, "token_pos": token_pos,
                  "token_page": token_page, "token_off": token_off,
                  "q_lens": q_lens, "cu_q": cu_q,
                  "page_tables": page_tables, "ctx_lens": ctx_lens,
                  "top_ks": top_ks, "seeds": seeds,
                  "spec_lens": np.zeros(self.n_rows, np.int32)
                  if spec_lens is None else spec_lens, "last": last,
                  "temps": temps, "top_ps": top_ps}
        if self._copied is not None:
            self._copied.synchronize()     # the last upload has read it
        for (name, _), where in zip(_PACKED, self._slices):
            a = arrays[name]
            a = np.ascontiguousarray(a, np.float32).view(np.int32) \
                if name in _FLOAT_FIELDS else np.asarray(a)
            self._host_np[where] = a.reshape(-1)
        self._buf.copy_(self._host, non_blocking=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()

    # -- the device body -------------------------------------------------

    def _region_map(self, f, h, spans, f_chunk=None):
        """Apply the row-wise map ``f`` over the token ``spans`` [(start,
        length)] (``None``: every token); other tokens stay 0.
        ``f_chunk`` takes each chunk slot's part of a span instead, one
        call a slot (MoE: the dense mix for decode and verify tokens, the
        dispatched group GEMM for a prefill chunk, as in the JAX step)."""
        if spans is None:
            if f_chunk is None:
                return f(h)
            spans = [(0, self.n_tokens)]
        if f_chunk is not None:
            spans = self._cut_at_chunks(spans)
        out = None
        for start, n, *chunk in spans:
            y = (f_chunk if chunk and chunk[0] else f)(h[start:start + n])
            if out is None:
                out = y.new_zeros((self.n_tokens, y.shape[-1]))
            out[start:start + n] = y
        return out

    def _cut_at_chunks(self, spans):
        """``spans`` cut at the chunk slots' bounds: ``(start, length,
        in a chunk slot)``."""
        bounds = [(start, start + self.chunk)
                  for _, start in self._chunk_starts]
        out = []
        for start, n in spans:
            end = start + n
            while start < end:
                slot = next((b for b in bounds if b[0] <= start < b[1]),
                            None)
                if slot is not None:
                    stop = min(end, slot[1])
                else:
                    stop = min([end] + [b[0] for b in bounds
                                        if start < b[0] < end])
                out.append((start, stop - start, slot is not None))
                start = stop
        return out

    def _full_head_attention(self, p, i, h, spans, kp, vp, m: _StepMeta):
        c, t = self.cfg, self.n_tokens
        hd, nh, nkv = c.head_dim, c.num_heads, c.kv_heads
        qkv = self._region_map(lambda hh: _linear(p, i, "attn.qkv", hh), h,
                               spans)
        q_size, kv_size = nh * hd, nkv * hd
        q = qkv[:, :q_size].reshape(t, nh, hd)
        k = qkv[:, q_size:q_size + kv_size].reshape(t, nkv, hd)
        v = qkv[:, q_size + kv_size:].reshape(t, nkv, hd)
        if c.position == "rotary":
            q = _rope_tok(q, m.cos, m.sin)
            k = _rope_tok(k, m.cos, m.sin)
        # KV page scatter, in place: JAX donates the page buffers and
        # scatters into the returned arrays instead
        kp.index_put_((m.token_page, m.token_off), k.to(self._cdt))
        vp.index_put_((m.token_page, m.token_off), v.to(self._cdt))
        attn = ragged_paged_attention(
            q.to(kp.dtype).contiguous(), kp, vp, m.q_lens, m.cu_q,
            m.page_tables, m.ctx_lens, max_q=self.max_q)
        return attn.reshape(t, nh * hd)

    def _mla_attention(self, p, i, h, spans, kp, vp, m: _StepMeta):
        c, t, page_quant = self.cfg, self.n_tokens, self.page_quant
        hd, nh = c.head_dim, c.num_heads
        d_c, d_r = c.kv_latent_dim, c.rope_dim
        qh = self._region_map(lambda hh: _linear(p, i, "attn.q", hh), h,
                              spans).reshape(t, nh, hd + d_r)
        kv = self._region_map(lambda hh: _linear(p, i, "attn.kv_a", hh), h,
                              spans)                      # [T, d_c + d_r]
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
            kp.index_put_(where, c_kv[:, None, :].to(self._cdt))
            if d_r:
                vp.index_put_(where, k_rope.to(self._cdt))
        o_lat = latent_ragged_paged_attention(
            q_cat.contiguous(), kp,
            None if (page_quant or not d_r) else vp, m.q_lens, m.cu_q,
            m.page_tables, m.ctx_lens, max_q=self.max_q,
            softmax_scale=(hd + d_r) ** -0.5,
            scale_pages=vp if page_quant else None, quant=page_quant,
            latent_dim=d_c)
        # the v_up fold: one up-projection per QUERY token; cached tokens
        # are never decompressed
        attn = torch.einsum("thc,hdc->thd", o_lat,
                            p.layer(i, "attn.v_up.weight").float())
        return attn.reshape(t, nh * hd)

    @torch.no_grad()
    def _forward(self, params, k_pages, v_pages, spans, sampled: bool,
                 verify: bool = False):
        """The step over the packed device buffer: the layers over the
        token ``spans`` (``_region_map``), then one sample a row, and
        with ``verify`` the verify head over the verify rows."""
        c, b = self.cfg, self._views
        p = _params_view(c, params)
        cdt = self._cdt
        pos_l = b["token_pos"].long()
        meta = _StepMeta(b["token_page"].long(), b["token_off"].long(),
                         b["q_lens"], b["cu_q"], b["page_tables"],
                         b["ctx_lens"],
                         *((self._cos[pos_l], self._sin[pos_l])
                           if c.position == "rotary" else (None, None)))
        attention = self._mla_attention if c.is_mla \
            else self._full_head_attention
        x = p("wte.weight")[b["tokens"].long()].to(cdt)         # [T, H]
        if c.position == "learned":
            x = x + p("wpe")[pos_l].to(x.dtype)
        for i in range(c.num_layers):
            h = _norm_apply(c, p.layer(i, "ln_1.weight"),
                            p.layer(i, "ln_1.bias"), x)
            attn = attention(p, i, h, spans, k_pages[i], v_pages[i],
                             meta).to(x.dtype)
            x = x + self._region_map(
                lambda aa, i=i: _linear(p, i, "attn.out", aa), attn, spans)
            h = _norm_apply(c, p.layer(i, "ln_2.weight"),
                            p.layer(i, "ln_2.bias"), x)
            if c.is_moe_layer(i):
                wts = _moe_params(p, i)
                x = x + self._region_map(
                    lambda hh, w=wts: _moe_dense_mix(c, hh, *w), h, spans,
                    f_chunk=lambda hh, w=wts: _moe_mlp_dispatched(
                        c, hh[None], *w)[0])
            else:
                x = x + self._region_map(
                    lambda hh, i=i: _linear(p, i, "mlp.down",
                                            _act(c, _linear(p, i, "mlp.up",
                                                            hh))),
                    h, spans)
        # the final norm is row-wise: norm only the rows' last tokens
        # (and the verify rows' first spec_k tokens: one LM-head call)
        picks = b["last"].long()
        if verify:
            k, nv = self.spec_k, self.n_rows - self._v0
            starts = b["cu_q"][self._v0:self.n_rows].long()
            widx = (starts[:, None] + torch.arange(
                k, device=starts.device)[None, :]).clamp(
                0, self.n_tokens - 1)                            # [R, K]
            picks = torch.cat([picks, widx.reshape(-1)])
        xl = _norm_apply(c, p("ln_f.weight"), p("ln_f.bias"), x[picks])
        logits = _lm_head(p, xl)                       # [rows (+ R*K), V]
        nr = self.n_rows
        next_tokens = sample_rows(logits[:nr], b["temps"], b["top_ps"],
                                  b["top_ks"], b["seeds"], b["ctx_lens"],
                                  sampled=sampled)
        if not self.spec_k:
            return next_tokens
        accepted = torch.zeros_like(next_tokens)
        if not verify:
            return next_tokens, accepted
        v0, sl = self._v0, slice(self._v0, nr)
        # verify position j's logits check the draft fed at j + 1
        draft_next = b["tokens"][(widx + 1).clamp(0, self.n_tokens - 1)]
        spec_lens = b["spec_lens"][sl]
        acc, alt = speculative_verify_head(
            logits[nr:].reshape(nv, k, -1), draft_next, spec_lens,
            b["temps"][sl], b["top_ps"][sl], b["top_ks"][sl],
            b["seeds"][sl], b["ctx_lens"][sl], sampled=sampled)
        # the bonus token: the first rejection's alternative, or on full
        # acceptance the row's own last-position sample, whose sampling
        # index ctx_lens is the emitted token's index
        bonus = alt.gather(1, acc.clamp(max=k - 1).long()[:, None])[:, 0]
        next_tokens = torch.cat([next_tokens[:v0], torch.where(
            acc < spec_lens, bonus, next_tokens[sl])])
        accepted = torch.cat([accepted[:v0], acc])
        return next_tokens, accepted

    def _fixed_spans(self, live):
        """The spans of the fixed-shape body for the live mask ``live``
        (one flag a chunk slot, then in spec mode one for the verify
        region): the decode slots and every live slot or region at full
        width, adjacent spans merged; ``None`` when that is every
        token."""
        regions = [(start, self.chunk) for _, start in self._chunk_starts]
        if self.spec_k:
            regions.append((self._vstart, self.n_tokens - self._vstart))
        spans = [[0, self.max_seqs]]
        for on, (start, width) in zip(live, regions):
            if not on:
                continue
            if spans[-1][0] + spans[-1][1] == start:
                spans[-1][1] += width
            else:
                spans.append([start, width])
        if spans == [[0, self.n_tokens]]:
            return None
        return [tuple(s) for s in spans]

    def _live(self, q_lens):
        live = tuple(bool(q_lens[row]) for row, _ in self._chunk_starts)
        if self.spec_k:
            live += (bool(np.any(q_lens[self._v0:])),)
        return live

    def _body(self, params, k_pages, v_pages, live):
        return self._forward(params, k_pages, v_pages,
                             self._fixed_spans(live), sampled=True,
                             verify=bool(self.spec_k and live[-1]))

    def _meta_len(self, meta):
        want = 13 if self.spec_k else 12
        if len(meta) != want:
            raise TypeError(f"the unified step takes {want} metadata "
                            f"arrays and the pages, got {len(meta)}")

    # -- entry points ----------------------------------------------------

    def fixed(self, params, *arrays):
        """The fixed-shape body run eagerly, on any device: ``arrays``
        are the metadata arrays (twelve, thirteen in spec mode) and the
        page tensors, as for a call.  The captured graphs record this
        body."""
        *meta, k_pages, v_pages = arrays
        self._meta_len(meta)
        self._pack(*meta)
        return self._body(params, k_pages, v_pages, self._live(meta[4]))

    def __call__(self, params, *arrays):
        *meta, k_pages, v_pages = arrays
        self._meta_len(meta)
        q_lens, cu_q, temps = meta[4], meta[5], meta[8]
        if self.device.type == "cpu":
            self._pack(*meta)
            rows = list(self._chunk_starts)
            if self.spec_k:
                rows += [(row, int(cu_q[row]))
                         for row in range(self._v0, self.n_rows)]
            spans = [(0, self.max_seqs)] + [
                (start, int(q_lens[row])) for row, start in rows
                if q_lens[row]]
            return self._forward(
                params, k_pages, v_pages, spans,
                sampled=bool((temps > 0).any()),
                verify=bool(self.spec_k and np.any(q_lens[self._v0:])))
        if capture.is_eager():
            return self.fixed(params, *arrays)
        bound = self._binding(params, k_pages, v_pages)
        self._pack(*meta)
        live = self._live(q_lens)
        step = self._graphs.get((bound, live), lambda: self._body(
            params, k_pages, v_pages, live))
        return step()

    def _binding(self, params, k_pages, v_pages) -> int:
        """The index of the binding ``(params, k_pages, v_pages)``, by
        identity, added at its first call."""
        for i, b in enumerate(self._bindings):
            if b[0] is params and b[1] is k_pages and b[2] is v_pages:
                return i
        self._bindings.append((params, k_pages, v_pages))
        return len(self._bindings) - 1

    def graphs_for(self, k_pages) -> int:
        """Graphs captured for the pool whose per-layer k page tensors
        are ``k_pages`` (one engine's share of the step's graphs)."""
        ids = {i for i, b in enumerate(self._bindings) if b[1] is k_pages}
        return sum(s.captured for (i, _), s in self._graphs.steps.items()
                   if i in ids)

    @property
    def compile_count(self) -> int:
        """Graphs captured on the card over every binding (at most
        ``2**prefill_rows`` a binding, one a live chunk-slot mask;
        ``2**(prefill_rows + 1)`` in spec mode); 1 on the CPU, where the
        step is not compiled."""
        if self.device.type == "cpu":
            return 1
        return self._graphs.captured


def build_unified_step_fn(cfg: GPTConfig, max_seqs: int, chunk: int,
                          prefill_rows: int, max_pages: int,
                          page_size: int, device=None, page_quant=None,
                          spec_k: int = 0) -> UnifiedStep:
    """Build THE serving step (:class:`UnifiedStep`)."""
    return UnifiedStep(cfg, max_seqs, chunk, prefill_rows, max_pages,
                       page_size, device=device, page_quant=page_quant,
                       spec_k=spec_k)
