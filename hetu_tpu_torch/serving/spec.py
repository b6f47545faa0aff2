"""Draft-model speculative decoding for the unified serving step (port of
``hetu_tpu.serving.spec``).

A small **draft model** proposes ``k`` greedy tokens for each
decode-ready request, and the target verifies all of them in ONE unified
step: a verify row is a prefill chunk of ``k + 1`` tokens (the last
committed token plus the proposals), and the step's verify head
(``ops.ragged_paged_attention.speculative_verify_head``) returns the
accepted prefix length and a bonus token a row.  A verify step emits
``accepted + 1`` tokens for one call of the step.

This module is the DRAFT half:

* :class:`SpecConfig`: the engine's knob, a draft ``state`` and shallow
  :class:`~hetu_tpu_torch.models.gpt.GPTConfig` with the target's vocab
  (``models.gpt.draft_state_from`` builds the truncated self-draft) and
  the proposal length ``k``;
* :class:`SpecDecoder`: slotted dense KV caches for up to ``max_batch``
  speculating requests and three programs of fixed shapes:

  - ``draft_prefill``: one ``[1, max_model_len]`` padded causal forward
    that rebuilds a slot's cache, paid when a request starts speculating
    or resumes after a preemption;
  - ``draft_insert``: copies a prefilled cache into its slot;
  - ``draft_propose``: ``k`` greedy decode micro-steps batched over every
    speculating slot at once, after one warm-up feed (idle rows write a
    trash position and are ignored).

The draft's attention is plain torch ops, as the JAX draft's is plain
XLA einsums.  On the card ``draft_propose`` is captured in one CUDA graph
(``core/capture.py``), as JAX jits it, and replayed at every engine step
that drafts.  ``draft_prefill`` and ``draft_insert`` run eagerly: the
prefill's fp32 score tensors are ``num_heads x max_model_len**2`` a layer
(2.1 GB at 32 heads and 4096 positions, with the mask and softmax beside
them), and a captured graph would keep that working set reserved in its
private memory pool for the engine's life, to save the launches of a
program that runs once per request start.

**Why the draft needs no catch-up.**  A propose call feeds the
second-to-last committed token, then the last, then its own proposals,
writing draft KV at ``[n - 2, n + k - 2]``.  The verify commits the
accepted prefix ``d_1..d_a``, exactly the tokens whose draft KV was just
written, plus a bonus token the draft never saw.  The next propose feeds
from position ``n + a - 1`` and overwrites stale slots before anything
reads them (a query at position p attends ``[0, p]``, and its write
lands before its attention).  The warm-up feed rewrites the one slot
this misses: after a FULLY accepted burst ``d_k`` is committed but its
KV was never written; re-feeding a committed token is an identical
rewrite whenever the slot was already valid.

Determinism: proposals are greedy and every draft op is row-wise, so a
request's drafts do not depend on the other rows of the batch.  At
temperature 0 the drafts cannot change the output at all (acceptance
against the target's argmax emits the non-speculative sequence); they
only decide how many tokens each step commits.

**Weights.**  The draft's state is normally the target's own tensors
(``draft_state_from`` keeps references): the engine hands the decoder its
uploaded tensors by the identity of the state's values, and tensors
already on the device are used as they are, so the draft uploads none
of the target's weights a second time (``own_bytes`` counts what it did
upload).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import capture
from ..core.device import resolve_device
from ..core.dtype import torch_dtype
from ..models.generate import (_as_tensor, _lm_head, _linear, _mlp,
                               _norm_apply, _Params, _rotary_tables,
                               decode_step)
from ..models.gpt import GPTConfig, check_serving_config
from .decode import _params_view, _rope_tok


@dataclass
class SpecConfig:
    """Speculative-decoding knob for ``Engine(spec=...)``.

    ``draft_state``/``draft_cfg``: the proposal model, any model with the
    TARGET's vocab (``models.gpt.draft_state_from`` builds the truncated
    self-draft).  ``k``: proposals per verify burst; each verify row gets
    its own ``k + 1``-wide slot in the token layout, and the engine caps
    a request's burst at its remaining emission budget.
    """
    draft_state: Dict[str, Any]
    draft_cfg: GPTConfig
    k: int = 4

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")


# the propose program's inputs, one [S] int32 row each, in the order of
# its static buffers
_PROPOSE_FIELDS = ("pre", "last", "pre_pos", "pos", "active")


class SpecDecoder:
    """Slotted draft-model runtime behind a speculative Engine.

    ``uploaded`` maps ``id(value)`` of a state value to the tensor the
    engine already made of it on ``device``: draft state entries that are
    the target's own values reuse those tensors."""

    def __init__(self, spec: SpecConfig, target_cfg: GPTConfig,
                 max_batch: int, max_model_len: int, k: int, device=None,
                 uploaded: Optional[Dict[int, torch.Tensor]] = None):
        dcfg = spec.draft_cfg
        if dcfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"draft vocab {dcfg.vocab_size} != target vocab "
                f"{target_cfg.vocab_size}: proposals must be target "
                f"token ids")
        if dcfg.position == "learned" and max_model_len > dcfg.max_seq_len:
            raise ValueError(
                f"draft learned-position table {dcfg.max_seq_len} "
                f"shorter than max_model_len {max_model_len}")
        check_serving_config(dcfg)
        self.cfg = dcfg
        self.k = int(k)
        self.device = resolve_device(device)
        uploaded = uploaded or {}
        self.params: Dict[str, torch.Tensor] = {}
        for key, v in spec.draft_state.items():
            t = uploaded.get(id(v))
            self.params[_Params._norm(key)] = t if t is not None \
                else _as_tensor(v, self.device)
        target = {t.data_ptr() for t in uploaded.values()}
        # bytes of draft weights that are not the target's tensors
        self.own_bytes = sum(t.numel() * t.element_size()
                             for t in self.params.values()
                             if t.data_ptr() not in target)
        self._p = _params_view(dcfg, self.params)
        self.S = int(max_batch)
        self.Lmax = int(max_model_len)
        cdt = torch_dtype("bfloat16" if dcfg.dtype == "bfloat16"
                          else "float32")
        self._cdt = cdt
        dev = self.device
        # +1 position a slot: index Lmax is the TRASH position idle rows
        # write into.  Layout [slot, kv_head, position, head_dim], the
        # position inside the head, so the micro-steps' attention
        # contractions need no transpose of the cache.
        if dcfg.is_mla:
            # the latent stream and the rope stream (width 0 for learned
            # positions), laid out the same way
            k_shape = (self.S, 1, self.Lmax + 1, dcfg.kv_latent_dim)
            v_shape = (self.S, 1, self.Lmax + 1, dcfg.rope_dim)
        else:
            k_shape = v_shape = (self.S, dcfg.kv_heads, self.Lmax + 1,
                                 dcfg.head_dim)
        self._kc = [torch.zeros(k_shape, dtype=cdt, device=dev)
                    for _ in range(dcfg.num_layers)]
        self._vc = [torch.zeros(v_shape, dtype=cdt, device=dev)
                    for _ in range(dcfg.num_layers)]
        self._cos, self._sin = (
            _rotary_tables(dcfg, self.Lmax + 1, dev)
            if dcfg.position == "rotary" else (None, None))
        self._rows = torch.arange(self.S, device=dev)
        self._positions = torch.arange(self.Lmax + 1, device=dev)
        self._free: List[int] = list(range(self.S - 1, -1, -1))
        self._slot: Dict[int, int] = {}       # req_id -> slot
        self._valid: Dict[int, bool] = {}     # draft cache usable?
        # how often a slot was (re)prefilled, and propose calls
        self.prefills = 0
        self.proposals = 0
        # the propose inputs: numpy writes the pinned host buffer, one
        # copy moves it, and the (captured) body reads the device one
        n = len(_PROPOSE_FIELDS) * self.S
        self._host = torch.zeros(n, dtype=torch.int32,
                                 pin_memory=dev.type == "cuda")
        self._host_np = self._host.numpy().reshape(len(_PROPOSE_FIELDS),
                                                   self.S)
        self._buf = torch.zeros(n, dtype=torch.int32, device=dev)
        self._views = {name: self._buf[i * self.S:(i + 1) * self.S]
                       for i, name in enumerate(_PROPOSE_FIELDS)}
        self._graphs = capture.StepCache("draft propose")
        self.compiled: Dict[str, Any] = {
            "draft_prefill": self._prefill,
            "draft_propose": self._propose,
            "draft_insert": self._insert,
        }

    # -- the three programs --------------------------------------------------

    @torch.no_grad()
    def _prefill(self, tokens: torch.Tensor):
        """``tokens [1, Lmax]`` -> per-layer caches ``[1, Lmax, kvh, hd]``
        (MLA: the latent and rope caches) of a causal forward."""
        c, cdt = self.cfg, self._cdt
        if c.is_mla:
            shapes = ((1, self.Lmax, 1, c.kv_latent_dim),
                      (1, self.Lmax, 1, c.rope_dim))
        else:
            shapes = ((1, self.Lmax, c.kv_heads, c.head_dim),) * 2
        caches = [tuple(torch.zeros(s, dtype=cdt, device=self.device)
                        for s in shapes) for _ in range(c.num_layers)]
        decode_step(c, self._p, tokens, caches, 0, self._cos, self._sin)
        return tuple(k for k, _ in caches), tuple(v for _, v in caches)

    @torch.no_grad()
    def _insert(self, pk, pv, slot: int) -> None:
        """Copy prefilled ``[1, L, h, d]`` caches into ``slot``'s
        ``[h, L + 1, d]`` store (one transpose a resume saves one a
        micro-step)."""
        for store, new in zip(self._kc + self._vc, pk + pv):
            store[slot, :, :self.Lmax] = new[0].transpose(0, 1)

    def _attend_full_head(self, i, h, wpos, mask, cos_g, sin_g):
        c, p, S = self.cfg, self._p, self.S
        hd, nh, kvh = c.head_dim, c.num_heads, c.kv_heads
        qkv = _linear(p, i, "attn.qkv", h)
        qs, ks = nh * hd, kvh * hd
        q = qkv[:, :qs].reshape(S, nh, hd)
        kk = qkv[:, qs:qs + ks].reshape(S, kvh, hd)
        vv = qkv[:, qs + ks:].reshape(S, kvh, hd)
        if c.position == "rotary":
            q = _rope_tok(q, cos_g, sin_g)
            kk = _rope_tok(kk, cos_g, sin_g)
        kc, vc = self._kc[i], self._vc[i]
        kc[self._rows, :, wpos] = kk.to(self._cdt)
        vc[self._rows, :, wpos] = vv.to(self._cdt)
        qg = q.reshape(S, kvh, nh // kvh, hd).float()
        s = torch.einsum("skgd,skld->skgl", qg, kc.float()) * hd ** -0.5
        s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
        o = torch.einsum("skgl,skld->skgd", torch.softmax(s, dim=-1),
                         vc.float())
        return o.reshape(S, nh * hd)

    def _attend_mla(self, i, h, wpos, mask, cos_g, sin_g):
        """The weight-absorbed latent path: q folded through ``k_up``
        scores against the latent cache, the output latent until the
        ``v_up`` fold (the unified step's contractions)."""
        c, p, S = self.cfg, self._p, self.S
        hd, nh = c.head_dim, c.num_heads
        d_c, d_r = c.kv_latent_dim, c.rope_dim
        q = _linear(p, i, "attn.q", h).reshape(S, nh, hd + d_r)
        kv = _linear(p, i, "attn.kv_a", h)
        q_cat = torch.einsum("shd,hdc->shc", q[..., :hd].float(),
                             p.layer(i, "attn.k_up.weight").float())
        kc, vc = self._kc[i], self._vc[i]
        kc[self._rows, 0, wpos] = kv[:, :d_c].to(self._cdt)
        lat = kc[:, 0].float()                             # [S, L+1, d_c]
        kall = lat
        if d_r:
            q_rope = _rope_tok(q[..., hd:], cos_g, sin_g)
            k_rope = _rope_tok(kv[:, None, d_c:], cos_g, sin_g)[:, 0]
            q_cat = torch.cat([q_cat, q_rope.float()], dim=-1)
            vc[self._rows, 0, wpos] = k_rope.to(self._cdt)
            kall = torch.cat([lat, vc[:, 0].float()], dim=-1)
        s = torch.einsum("shc,slc->shl", q_cat, kall) * (hd + d_r) ** -0.5
        s = s.masked_fill(~mask[:, None, :], float("-inf"))
        o_lat = torch.einsum("shl,slc->shc", torch.softmax(s, dim=-1), lat)
        o = torch.einsum("shc,hdc->shd", o_lat,
                         p.layer(i, "attn.v_up.weight").float())
        return o.reshape(S, nh * hd)

    @torch.no_grad()
    def _propose_body(self) -> torch.Tensor:
        """``K + 1`` micro-steps over the static inputs: a warm-up feed
        of the second-to-last committed token at ``pre_pos`` (logits
        discarded), then the ``K`` proposal steps.  Returns the drafts
        ``[S, K]`` int32."""
        c, p, b, L = self.cfg, self._p, self._views, self.Lmax
        active = b["active"] != 0
        cur, cur_pos = b["pre"].long(), b["pre_pos"].long()
        attend = self._attend_mla if c.is_mla else self._attend_full_head
        out = []
        for step in range(self.k + 1):
            x = p("wte.weight")[cur].to(self._cdt)              # [S, H]
            if c.position == "learned":
                x = x + p("wpe")[cur_pos.clamp(0, c.max_seq_len - 1)].to(
                    x.dtype)
            # idle rows (and rows proposed past the model budget) write
            # the trash position Lmax
            wpos = torch.where(active, cur_pos.clamp(max=L),
                               torch.full_like(cur_pos, L))
            cos_g = sin_g = None
            if self._cos is not None:
                ridx = cur_pos.clamp(0, L)
                cos_g, sin_g = self._cos[ridx], self._sin[ridx]
            mask = self._positions[None, :] <= cur_pos[:, None]
            for i in range(c.num_layers):
                h = _norm_apply(c, p.layer(i, "ln_1.weight"),
                                p.layer(i, "ln_1.bias"), x)
                o = attend(i, h, wpos, mask, cos_g, sin_g).to(x.dtype)
                x = x + _linear(p, i, "attn.out", o)
                h = _norm_apply(c, p.layer(i, "ln_2.weight"),
                                p.layer(i, "ln_2.bias"), x)
                x = x + _mlp(c, p, i, h[:, None, :])[:, 0]
            xf = _norm_apply(c, p("ln_f.weight"), p("ln_f.bias"), x)
            nxt = torch.argmax(_lm_head(p, xf), dim=-1)
            if step == 0:                  # warm-up: discard, rewind
                cur, cur_pos = b["last"].long(), b["pos"].long()
            else:
                out.append(nxt.to(torch.int32))
                cur = nxt
                cur_pos = cur_pos + active.long()
        return torch.stack(out, dim=1)

    def _propose(self, pre, last, pre_pos, pos, active) -> torch.Tensor:
        """One batched propose over ``[S]`` numpy inputs; on the card the
        replay of the captured body (its output is overwritten by the
        next call)."""
        for i, a in enumerate((pre, last, pre_pos, pos, active)):
            self._host_np[i] = a
        self._buf.copy_(self._host, non_blocking=True)
        if self.device.type == "cpu" or capture.is_eager():
            return self._propose_body()
        return self._graphs.get("propose", self._propose_body)()

    # -- lifecycle -----------------------------------------------------------

    def _ensure_slot(self, req) -> Optional[int]:
        """The request's draft slot, assigned on first use; ``None`` when
        the slot pool is dry (the caller skips the candidate this step).
        Slots are released on preemption, finish and abort, so holders
        are running requests and the pool cannot run dry in practice."""
        slot = self._slot.get(req.req_id)
        if slot is None:
            if not self._free:
                return None
            slot = self._free.pop()
            self._slot[req.req_id] = slot
            self._valid[req.req_id] = False
        return slot

    def release(self, req) -> None:
        """The request left the running set: free its slot."""
        slot = self._slot.pop(req.req_id, None)
        if slot is not None:
            self._free.append(slot)
            self._valid.pop(req.req_id, None)

    def stage(self, cands, k_effs: Dict[int, int], tracer=None,
              now: float = 0.0) -> Dict[int, List[int]]:
        """Prefill stale slots, then ONE batched propose over every
        candidate: ``{req_id: drafts}``, each truncated to its
        ``k_eff``.  ``cands`` are decode-ready requests (``len(tokens) -
        pos == 1``).  Under an enabled ``tracer`` each draft prefill is a
        ``draft_prefill`` instant at ``now`` on the request's track."""
        staged = []
        for req in cands:
            slot = self._ensure_slot(req)
            if slot is None:
                continue               # slot pool dry: plain decode
            staged.append(req)
            if not self._valid[req.req_id]:
                n = len(req.tokens)
                if n > 1:
                    toks = np.zeros((1, self.Lmax), np.int32)
                    toks[0, :n - 1] = req.tokens[:n - 1]
                    pk, pv = self.compiled["draft_prefill"](
                        torch.from_numpy(toks).to(self.device))
                    self.compiled["draft_insert"](pk, pv, slot)
                    self.prefills += 1
                    if tracer is not None and tracer.enabled:
                        tracer.instant("draft_prefill",
                                       track=f"req {req.req_id}", ts=now,
                                       req=req.req_id, tokens=n - 1)
                self._valid[req.req_id] = True
        if not staged:
            return {}
        a = np.zeros((len(_PROPOSE_FIELDS), self.S), np.int32)
        for req in staged:
            s, n = self._slot[req.req_id], len(req.tokens)
            a[:, s] = (req.tokens[-2] if n > 1 else req.tokens[-1],
                       req.tokens[-1], max(n - 2, 0), n - 1, 1)
        drafts = self.compiled["draft_propose"](*a).cpu().numpy()
        self.proposals += 1
        return {req.req_id: [int(t) for t in
                             drafts[self._slot[req.req_id],
                                    :int(k_effs[req.req_id])]]
                for req in staged}

    @property
    def compile_count(self) -> int:
        """The draft's compiled programs: on the CPU its three programs
        (as the JAX decoder counts them), on the card the captured
        propose graph."""
        if self.device.type == "cpu":
            return len(self.compiled)
        return self._graphs.captured
