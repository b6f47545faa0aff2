"""Continuous-batching inference engine over the paged KV pool (port of
``hetu_tpu.serving.engine`` for the dense configurations: full-head and
MLA latent pages, speculative or not).

Every ``step()`` admits arrived requests, packs ALL live work (prefill
chunks + decode tokens) into one ragged token batch, runs the unified
step (``serving/decode.build_unified_step_fn``) and streams each emitted
token to its request, retiring and evicting under the page budget.
Late arrivals join mid-flight; long prompts prefill in ``chunk_size``
slices so they never stall running decodes.

Determinism contract: at temperature 0 every request's output equals a
solo ``generate()`` run — batching, paging, chunked prefill, admission
order and preemption change WHEN a token is computed, never WHAT it is
(up to the floating-point order of the two paths' products).  Sampled
rows are keyed by ``(seed, position)``, so replays are deterministic
too, and the engine only ever reads back ``[rows]`` int32 token ids.

The engine runs on ``device`` (default ``"cuda"``; it raises when no
card is present unless ``device="cpu"`` is asked for).  The tensors'
device decides the attention path: the CUDA kernel on the card, the
plain version on the CPU.  On the card the unified step is compiled, as
the JAX engine jits it: each step fills the step's static buffers and
replays the CUDA graph of its live chunk-slot mask (``compile_count``
graphs, captured at first use); on the CPU it runs eagerly.

Prefix reuse (``serving/prefix_cache.py``, on by default) and the
metrics (``utils/metrics.py``) are as in the JAX engine.  An MLA config
(``cfg.is_mla``) gets latent pages, with a decoupled rope stream for
rotary configs and, under ``page_quant="int8"|"nf4"`` (learned-position
configs), per-token absmax codes.

Speculative decoding (``serving/spec.py``, ``Engine(spec=SpecConfig(
...))``): a shallow draft model proposes ``k`` greedy tokens for each
decode-ready request every step; the scheduler packs them as dedicated
``k + 1``-token verify rows and the step's verify head returns the
accepted prefix length and a bonus token a row, so up to ``k + 1``
tokens commit a call; temperature-0 output equals the non-speculative
engine's, and a sampled row draws what it would draw without drafts.
Rejected positions leave stale KV past the rewound ``pos``; the next
burst or re-prefill writes them before anything reads them (a row's
``ctx_len`` never reaches past its written extent).

The tensors' device picks the attention: the kernels on the card, their
plain versions on the CPU.  ``use_kernel`` may be left out, or name what
the device runs (``True`` on the card, ``False`` on the CPU); any other
value raises ``ValueError``, so no option sends the card to the plain
version or asks the CPU for a kernel it has not got.

``step_fn`` lets identically shaped engines (cluster replicas) share ONE
built step (``decode.UnifiedStep``): its static buffers and body, and on
the card one graph memory pool, each engine's pool replaying graphs of
its own (``compile_count`` counts this engine's).  ``host_tier`` (a
``serving.slo.HostTier``, ``True`` or a page capacity) stages evicted
cached pages to host RAM and refetches them, priced, when a prompt
chains onto them.  Under a tracer (``tracer=`` or the ambient one of
``obs.install_tracer``) every request gets a lifecycle timeline on its
own track (``enqueue``/``adopt``, ``queued``/``running`` segments that
tile submit to finish across preemptions, ``admit``,
``prefix_cache_hit``, ``prefill_chunk`` spans, ``token`` instants,
``preempt``, ``finish``), beside the scheduler's ``pack`` decision and a
``unified_step`` span per call, under the JAX engine's names.  A
tensor-parallel engine (a mesh) and the analysis tap come with later
slices of the port (ROADMAP queue 1 items 19 and 18); the options that
select them raise ``NotImplementedError`` naming the item.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.device import resolve_device
from ..core.dtype import torch_dtype
from ..models.generate import _Params
from ..models.gpt import GPTConfig, check_serving_config
from ..obs.tracer import get_tracer
from ..utils.metrics import make_instrument, render_prometheus
from .decode import UnifiedStep, build_unified_step_fn
from .kv_pool import TRASH_PAGE, PagedKVPool
from .prefix_cache import PrefixCache
from .request import FINISHED, RUNNING, Request, RequestQueue
from .scheduler import Scheduler
from .spec import SpecConfig, SpecDecoder

# default Prometheus-style latency bounds (seconds) for ttft/tbt
DEFAULT_LATENCY_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                           10.0)

# options of later slices: what each selects, and its ROADMAP item
_LATER_SLICES = {
    "mesh": "a tensor-parallel engine with a sharded KV pool comes with "
            "ROADMAP queue 1 item 19 (tensor-parallel serving)",
    "analysis_tap": "the analysis tap comes with the analysis plane "
                    "(ROADMAP queue 1 item 18)"}


class Engine:
    def __init__(self, state: Dict[str, Any], cfg: GPTConfig,
                 num_pages: int = 64, page_size: int = 64,
                 max_batch: int = 8, max_model_len: Optional[int] = None,
                 chunk_size: Optional[int] = 64, prefill_rows: int = 1,
                 mesh=None, use_kernel: Optional[bool] = None,
                 metrics: bool = True,
                 latency_buckets: Optional[Sequence[float]] = None,
                 time_fn: Optional[Callable[[], float]] = None,
                 name: str = "serving", analysis_tap: bool = False,
                 prefix_cache: bool = True, debug: bool = False,
                 tracer=None, step_fn: Optional[Callable] = None,
                 spec: Optional[SpecConfig] = None, page_quant=None,
                 host_tier=None, device="cuda"):
        for opt, val in (("mesh", mesh), ("analysis_tap", analysis_tap)):
            if val is not None and val is not False:
                raise NotImplementedError(
                    f"Engine({opt}=...): {_LATER_SLICES[opt]}")
        if spec is not None and not isinstance(spec, SpecConfig):
            raise TypeError(f"spec must be a SpecConfig, got "
                            f"{type(spec).__name__}")
        check_serving_config(cfg)
        if page_quant is not None and not cfg.is_mla:
            raise ValueError("page_quant requires an MLA config "
                             "(kv_latent_dim set)")
        self.cfg = cfg
        self.name = name
        # None follows the ambient tracer (obs.install_tracer), the shared
        # no-op by default; every emission site guards on ``enabled``
        self._tracer = tracer
        self.page_quant = page_quant
        self.device = resolve_device(device)
        # the tensors' device picks kernel or plain version
        self.use_kernel = self.device.type == "cuda"
        if use_kernel is not None and bool(use_kernel) != self.use_kernel:
            raise ValueError(
                f"Engine(use_kernel={use_kernel!r}) on a {self.device.type} "
                f"device: the device picks the attention (the CUDA kernels "
                f"on the card, their plain versions on the CPU)")
        self.params = _Params(state, cfg, self.device).s
        if max_model_len is None:
            max_model_len = (num_pages - 1) * page_size
            if cfg.position == "learned":
                max_model_len = min(max_model_len, cfg.max_seq_len)
        self.max_model_len = int(max_model_len)
        self.max_pages_per_seq = -(-self.max_model_len // page_size)
        self.debug = bool(debug)
        self.pool = PagedKVPool(
            cfg.num_layers, num_pages, page_size, cfg.kv_heads,
            cfg.head_dim,
            torch_dtype("bfloat16" if cfg.dtype == "bfloat16"
                        else "float32"),
            device=self.device, debug=debug, latent_dim=cfg.kv_latent_dim,
            rope_dim=cfg.rope_dim, quant=page_quant)
        self.prefix_cache: Optional[PrefixCache] = \
            PrefixCache(self.pool) if prefix_cache else None
        if self.prefix_cache is not None:
            self.pool.set_reclaim(self._reclaim_cached_pages)
        # chunk_size=None: whole-prompt chunks
        chunk = self.max_model_len if chunk_size is None \
            else min(int(chunk_size), self.max_model_len)
        self.scheduler = Scheduler(self.pool, max_batch=max_batch,
                                   chunk=chunk, prefill_rows=prefill_rows,
                                   prefix_cache=self.prefix_cache)
        self.queue = RequestQueue()
        self.running: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self._time_fn = time_fn or time.monotonic
        self._next_id = 0
        self.steps = 0
        self._calls = 0
        m = metrics
        self.counters = {k: make_instrument("counter", k, m) for k in
                         ("tokens_generated", "prefill_tokens",
                          "requests_completed", "preemptions",
                          "decode_steps", "prefill_chunks", "step_calls",
                          "prefix_cache_hits", "prefix_cache_misses",
                          "prefix_cache_tokens_saved",
                          "prefix_cache_evictions",
                          # speculative decoding: draft tokens proposed
                          # and accepted (committed), bonus tokens of
                          # verify rows (zero on non-spec engines)
                          "spec_proposed", "spec_accepted",
                          "spec_bonus_tokens",
                          "admitted_interactive", "admitted_standard",
                          "admitted_batch", "preempted_interactive",
                          "preempted_standard", "preempted_batch",
                          # the host KV tier's page moves (zero without
                          # one, so the cluster's merged view is uniform)
                          "host_evictions", "host_hits",
                          "host_refetch_bytes")}
        self.gauges = {k: make_instrument("gauge", k, m) for k in
                       ("batch_occupancy", "page_utilization",
                        "queue_depth", "kv_bytes_per_token",
                        "kv_bytes_in_use", "host_pages")}
        self.gauges["kv_bytes_per_token"].set(self.pool.kv_bytes_per_token)
        lb = list(latency_buckets if latency_buckets is not None
                  else DEFAULT_LATENCY_BUCKETS)
        self.histograms = {
            "ttft": make_instrument("histogram", "ttft", m, buckets=lb),
            "tbt": make_instrument("histogram", "tbt", m, buckets=lb),
            "tpot": make_instrument("histogram", "tpot", m),
            "request_latency": make_instrument("histogram",
                                               "request_latency", m),
        }
        # the host-RAM tier for cold cached pages: a HostTier, True
        # (defaults) or an int page capacity
        self.host_tier = None
        if host_tier:
            if self.prefix_cache is None:
                raise ValueError("host_tier requires prefix_cache=True")
            from .slo.host_tier import HostTier
            ht = host_tier if isinstance(host_tier, HostTier) else (
                HostTier() if host_tier is True
                else HostTier(int(host_tier)))
            ht.bind(self.pool, self.prefix_cache,
                    counters=self.counters, gauges=self.gauges,
                    tracer_fn=lambda: self.tracer,
                    time_fn=self._time_fn)
            self.host_tier = ht
        # speculative decoding: the draft proposes spec_k greedy tokens
        # a decode-ready request; the scheduler packs them as verify rows
        self.spec: Optional[SpecDecoder] = None
        self.spec_k = 0
        if spec is not None:
            self.spec_k = int(spec.k)
            # the draft's state holds the target's own values: hand it
            # the tensors already made of them
            uploaded = {id(v): self.params[_Params._norm(k)]
                        for k, v in state.items()}
            self.spec = SpecDecoder(spec, cfg, self.scheduler.max_batch,
                                    self.max_model_len, self.spec_k,
                                    device=self.device, uploaded=uploaded)
            self.scheduler.verify_slots = self.scheduler.max_batch
            self.scheduler.spec_width = self.spec_k + 1
        s, r, ck = (self.scheduler.max_batch, self.scheduler.prefill_rows,
                    self.scheduler.chunk)
        # the layout: decode slots, chunk slots, then (spec mode) one
        # (k+1)-wide verify slot a sequence
        vr = s if self.spec is not None else 0
        vk = self.spec_k + 1
        self.n_rows = s + r + vr
        self.n_tokens = s + r * ck + vr * vk
        layout = (cfg, s, ck, r, self.max_pages_per_seq, page_size,
                  page_quant, self.spec_k, self.device)
        if step_fn is None:
            step_fn = build_unified_step_fn(*layout[:6], device=self.device,
                                            page_quant=page_quant,
                                            spec_k=self.spec_k)
        elif not isinstance(step_fn, UnifiedStep) or \
                step_fn.layout != layout:
            raise ValueError(
                f"step_fn: {type(step_fn).__name__} is not a unified step "
                f"built for this engine's layout ({self.n_rows} rows, "
                f"{self.n_tokens} tokens)")
        self._step_fn = step_fn
        cu = np.concatenate([np.arange(s, dtype=np.int32),
                             s + ck * np.arange(r + 1, dtype=np.int32)])
        if vr:
            cu = np.concatenate([cu[:-1], s + r * ck + vk * np.arange(
                vr + 1, dtype=np.int32)])
        self._cu_q = cu                       # [rows + 1], layout-fixed

    # -- submission ----------------------------------------------------------

    def add_request(self, prompt_ids: Sequence[int], max_new_tokens: int,
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 0.0, seed: int = 0,
                    eos_token_id: Optional[int] = None,
                    arrival_time: Optional[float] = None,
                    stream_cb: Optional[Callable] = None,
                    slo_class: str = "standard") -> Request:
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = len(prompt) + int(max_new_tokens)
        if total > self.max_model_len:
            raise ValueError(
                f"prompt+max_new_tokens = {total} exceeds max_model_len "
                f"{self.max_model_len}")
        if self.pool.pages_for(total) > self.pool.num_usable:
            raise ValueError(
                f"request needs {self.pool.pages_for(total)} pages; pool "
                f"has {self.pool.num_usable} — it could never run")
        now = self._now()
        req = Request(req_id=self._next_id, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature), top_k=int(top_k),
                      top_p=float(top_p), seed=int(seed),
                      eos_token_id=eos_token_id,
                      arrival_time=now if arrival_time is None
                      else float(arrival_time), stream_cb=stream_cb,
                      slo_class=slo_class)
        req.submit_time = max(now, req.arrival_time)
        req.trace_t0 = req.submit_time      # queued segment opens here
        self._next_id += 1
        self.queue.push(req)
        tr = self.tracer
        if tr.enabled:
            tr.instant("enqueue", track=f"req {req.req_id}",
                       ts=req.submit_time, req=req.req_id,
                       prompt_tokens=len(prompt),
                       max_new_tokens=int(max_new_tokens),
                       slo_class=req.slo_class,
                       queue_depth=len(self.queue))
        return req

    def adopt_request(self, prompt: Sequence[int],
                      generated: Sequence[int], max_new_tokens: int,
                      pages: Optional[Sequence[int]] = None,
                      pos: int = 0, temperature: float = 0.0,
                      top_k: int = 0, top_p: float = 0.0, seed: int = 0,
                      eos_token_id: Optional[int] = None,
                      arrival_time: Optional[float] = None,
                      stream_cb: Optional[Callable] = None,
                      slo_class: str = "standard") -> Request:
        """Admit a MID-FLIGHT request: ``generated`` tokens already
        sampled elsewhere and, optionally, ``pages`` of THIS engine's pool
        already holding KV for positions ``[0, pos)`` (a prefill handed
        over by another engine).  It rides the normal admission path;
        a preemption re-prefills the whole accumulated sequence, which
        gives the same continuation.  Sampling parameters must be the
        original request's."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        generated = [int(t) for t in
                     np.asarray(generated, np.int64).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if len(generated) >= max_new_tokens:
            raise ValueError("request already finished: "
                             f"{len(generated)} >= {max_new_tokens}")
        total = len(prompt) + int(max_new_tokens)
        if total > self.max_model_len:
            raise ValueError(
                f"prompt+max_new_tokens = {total} exceeds max_model_len "
                f"{self.max_model_len}")
        if self.pool.pages_for(total) > self.pool.num_usable:
            raise ValueError(
                f"request needs {self.pool.pages_for(total)} pages; pool "
                f"has {self.pool.num_usable} — it could never run")
        pages = list(pages or ())
        pos = int(pos)
        if pos > len(prompt) + len(generated):
            raise ValueError(f"pos {pos} past the accumulated tokens")
        if pos and len(pages) < self.pool.pages_for(pos):
            raise ValueError(
                f"pages cover {len(pages) * self.pool.page_size} tokens "
                f"but pos is {pos}")
        now = self._now()
        req = Request(req_id=self._next_id, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature), top_k=int(top_k),
                      top_p=float(top_p), seed=int(seed),
                      eos_token_id=eos_token_id,
                      arrival_time=now if arrival_time is None
                      else float(arrival_time), stream_cb=stream_cb,
                      slo_class=slo_class)
        req.tokens = prompt + generated
        req.out_tokens = list(generated)
        req.pages = pages
        req.peak_pages = len(pages)
        req.pos = pos
        req.submit_time = max(now, req.arrival_time)
        req.trace_t0 = req.submit_time
        self._next_id += 1
        self.queue.push(req)
        tr = self.tracer
        if tr.enabled:
            tr.instant("adopt", track=f"req {req.req_id}",
                       ts=req.submit_time, req=req.req_id,
                       prompt_tokens=len(prompt),
                       generated_tokens=len(generated), pos=pos,
                       handoff_pages=len(pages),
                       queue_depth=len(self.queue))
        return req

    # -- loop ----------------------------------------------------------------

    def _now(self) -> float:
        return self._time_fn()

    @property
    def tracer(self):
        """The effective tracer: the injected one, else the ambient
        global (``obs.NULL_TRACER``, the no-op, unless one is
        installed)."""
        return self._tracer if self._tracer is not None else get_tracer()

    def set_tracer(self, tracer) -> None:
        """Swap the engine's tracer live (None follows the ambient one
        again)."""
        self._tracer = tracer

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.running)

    def step(self) -> int:
        """One engine iteration: admit, pack prefill chunks + decodes
        into ONE ragged batch, run the unified step.  Returns the number
        of tokens emitted."""
        now = self._now()
        tr = self.tracer
        for req in self.scheduler.admit(self.queue, self.running, now):
            self._start(req)
        live = [r for r in self.running if r.state == RUNNING]
        if self.spec is not None:
            self._stage_spec(live)
        kept, evicted = self.scheduler.ensure_decode_pages(live)
        for req in evicted:
            self.running.remove(req)
            self.queue.push(req)
            self.counters["preemptions"].inc()
            self.counters[f"preempted_{req.slo_class}"].inc()
            if self.spec is not None:
                # the draft cache is stale: resuming re-prefills a fresh
                # slot, and slot holders stay a subset of the running
                self.spec.release(req)
            t = self._now()
            if tr.enabled:
                # the running segment ends here; a queued one opens at
                # the same instant (gapless state tiling)
                tr.complete("running", req.trace_t0, t - req.trace_t0,
                            track=f"req {req.req_id}", req=req.req_id)
                tr.instant("preempt", track=f"req {req.req_id}", ts=t,
                           req=req.req_id,
                           n_preemptions=req.n_preemptions,
                           pos_lost=len(req.tokens))
            req.trace_t0 = t
        rows = self.scheduler.pack(kept)
        if tr.enabled and rows:
            tr.instant("pack", track="scheduler", ts=self._now(),
                       running=len(self.running),
                       queue_depth=len(self.queue),
                       free_pages=self.pool.free_pages,
                       **self.scheduler.slot_mix(rows))
        produced = self._run_unified(rows) if rows else 0
        if self.debug:
            self.pool.check_invariants()
            if self.prefix_cache is not None:
                self.prefix_cache.check_invariants()
        self.steps += 1
        self.gauges["batch_occupancy"].set(
            len(self.running) / self.scheduler.max_batch)
        self.gauges["page_utilization"].set(self.pool.utilization)
        self.gauges["queue_depth"].set(len(self.queue))
        self.gauges["kv_bytes_in_use"].set(
            (self.pool.num_usable - self.pool.free_pages)
            * self.pool.page_bytes)
        if self.host_tier is not None:
            self.gauges["host_pages"].set(self.host_tier.host_pages)
        return produced

    def run(self, max_steps: Optional[int] = None
            ) -> Dict[int, List[int]]:
        """Drive until idle (or ``max_steps``); returns
        {req_id: generated tokens} for everything finished so far."""
        while self.has_work:
            if max_steps is not None and self.steps >= max_steps:
                break
            self.step()
        return {rid: list(r.out_tokens)
                for rid, r in self.finished.items()}

    @property
    def executable_calls(self) -> int:
        """Unified-step invocations, replayed or eager (a plain counter,
        so it stays right under ``metrics=False``)."""
        return self._calls

    @property
    def compile_count(self) -> int:
        """Compiled programs: on the card the CUDA graphs captured so far,
        on the CPU one per built program (the steps run eagerly, and the
        JAX engine's fallback counts one per built executable): 1, or 4
        in spec mode (the unified step and the draft's three programs).
        A capture beyond the expected ones (a silent recompile) shows up
        here.  Replicas sharing one step each count the graphs of their
        own pool.  The JAX engine compiles ONE unified program, whose
        ``lax.cond`` skips an idle chunk slot on the device; a CUDA graph
        cannot branch, so the port captures one graph per live chunk-slot
        mask (and, in spec mode, live verify region) and chooses it on
        the host: at most ``2**prefill_rows`` (2 at ``prefill_rows=1``:
        decode only, and decode beside a chunk), in spec mode
        ``2**(prefill_rows + 1)`` plus the draft's propose graph."""
        n = self._step_fn.graphs_for(self.pool.k_pages) \
            if self.device.type == "cuda" else 1
        if self.spec is not None:
            n += self.spec.compile_count
        return n

    # -- admission / lifecycle -----------------------------------------------

    def _reclaim_cached_pages(self, n: int) -> int:
        """The pool's reclaim hook: LRU-sweep refcount-0 cached pages
        when the free list runs dry, before recompute preemption."""
        freed = self.prefix_cache.evict(n)
        if freed:
            self.counters["prefix_cache_evictions"].inc(freed)
            tr = self.tracer
            if tr.enabled:
                tr.instant("prefix_cache_evict", track="engine",
                           ts=self._now(), pages_freed=freed,
                           pages_wanted=n)
        return freed

    def _start(self, req: Request) -> None:
        """Move an admitted request to RUNNING: attach the longest
        cached prefix (copy-on-write: ``pos`` starts at the cached
        boundary), then grant the pages the rest of its tokens need."""
        looked_up = self.prefix_cache is not None and req.pos == 0 \
            and not req.pages
        if looked_up:
            if self.host_tier is not None:
                # extend the device cache's match with host-tier pages
                # first: restored pages join the index, so the acquire
                # below attaches the deeper chain (a dry pool stops the
                # restore; the suffix recomputes like any miss)
                self.host_tier.refetch(req.tokens)
            entries = self.prefix_cache.acquire(req)
            if entries:
                req.pages = [e.page for e in entries]
                req.shared_pages = len(entries)
                req.pos = len(entries) * self.pool.page_size
                req.cached_tokens = req.pos
        need = self.pool.pages_for(len(req.tokens)) - len(req.pages)
        pages = self.pool.alloc(need)
        tr = self.tracer
        if pages is None:
            if tr.enabled:
                # stays queued: the open queued segment keeps running
                tr.instant("admit_defer", track=f"req {req.req_id}",
                           ts=self._now(), req=req.req_id,
                           pages_needed=need,
                           free_pages=self.pool.free_pages)
            # admission over-committed: roll back the cache attach and
            # retry next step (counters untouched: the same start)
            if looked_up:
                if req.shared_pages:
                    self.prefix_cache.release(req)
                req.pages = []
                req.shared_pages = 0
                req.cached_tokens = 0
                req.pos = 0
            self.queue.push(req)
            return
        if looked_up:
            if req.shared_pages:
                self.counters["prefix_cache_hits"].inc()
                self.counters["prefix_cache_tokens_saved"].inc(
                    req.cached_tokens)
            else:
                self.counters["prefix_cache_misses"].inc()
        req.pages = req.pages + pages
        req.peak_pages = max(req.peak_pages, len(req.pages))
        req.state = RUNNING
        self.counters[f"admitted_{req.slo_class}"].inc()
        self.running.append(req)
        t = self._now()
        if tr.enabled:
            # close the queued segment and open running at the same
            # instant; the admission carries its page math
            tr.complete("queued", req.trace_t0, t - req.trace_t0,
                        track=f"req {req.req_id}", req=req.req_id,
                        preemptions=req.n_preemptions)
            tr.instant("admit", track=f"req {req.req_id}", ts=t,
                       req=req.req_id, pages_granted=need,
                       pages_total=len(req.pages),
                       cached_pages=req.shared_pages,
                       free_pages=self.pool.free_pages,
                       batch=len(self.running))
            if looked_up and req.shared_pages:
                tr.instant("prefix_cache_hit", track=f"req {req.req_id}",
                           ts=t, req=req.req_id,
                           cached_tokens=req.cached_tokens,
                           shared_pages=req.shared_pages)
        req.trace_t0 = t

    def abort_all(self) -> List[int]:
        """Abort every queued + running request: owned pages return to
        the free list, shared prefix-cache references are released,
        nothing enters ``finished``.  Returns the aborted request ids."""
        victims = list(self.queue.requests())
        victims.extend(self.running)
        for req in victims:
            self.pool.free(req.pages[req.shared_pages:])
            if self.prefix_cache is not None and req.shared_pages:
                self.prefix_cache.release(req)
            if self.spec is not None:
                self.spec.release(req)
            req.pages = []
            req.shared_pages = 0
            req.cached_tokens = 0
            req.spec_drafts = []
            req.pos = 0
            req.state = FINISHED          # terminal, but never collected
        self.queue.clear()
        self.running.clear()
        if self.debug:
            self.pool.check_invariants()
            if self.prefix_cache is not None:
                self.prefix_cache.check_invariants()
        return [r.req_id for r in victims]

    def _stage_spec(self, live: List[Request]) -> None:
        """Draft-propose for every decode-ready request with at least 2
        tokens left to emit: ONE batched draft call a step, the drafts
        staged on the requests for the scheduler to pack as verify
        rows."""
        cands = []
        k_effs: Dict[int, int] = {}
        for r in sorted(live, key=lambda r: (r.arrival_time, r.req_id)):
            if r.state != RUNNING or r.spec_drafts or r.done:
                continue
            if len(r.tokens) - r.pos != 1:
                continue               # mid-prefill: nothing to draft
            k_eff = min(self.spec_k, r.max_new_tokens - r.n_generated - 1)
            if k_eff < 1:
                continue               # last token: a plain decode
            cands.append(r)
            k_effs[r.req_id] = k_eff
        if not cands:
            return
        tr = self.tracer
        t0 = self._now()
        drafts = self.spec.stage(cands, k_effs, tracer=tr, now=t0)
        dt = self._now() - t0
        total = 0
        for r in cands:
            r.spec_drafts = drafts.get(r.req_id, [])
            total += len(r.spec_drafts)
        self.counters["spec_proposed"].inc(total)
        if tr.enabled and total:
            tr.complete("draft", t0, dt, track="engine",
                        requests=len(cands), proposed=total,
                        k=self.spec_k)

    # -- the unified step ----------------------------------------------------

    def _pack_arrays(self, rows: List[Tuple[Request, int, int]]):
        """Host-side marshalling of the packed step: flat token arrays +
        per-row ragged descriptors + per-row sampling params.  A verify
        row's fed tokens are the committed tail plus its staged drafts
        (``qlen = 1 + spec_len``), written through the same per-token KV
        write plan as any prefill chunk."""
        t, nr = self.n_tokens, self.n_rows
        ps = self.pool.page_size
        vbase = self.scheduler.max_batch + self.scheduler.prefill_rows
        tokens = np.zeros(t, np.int32)
        token_pos = np.zeros(t, np.int32)
        token_page = np.full(t, TRASH_PAGE, np.int32)
        token_off = np.zeros(t, np.int32)
        q_lens = np.zeros(nr, np.int32)
        page_tables = np.full((nr, self.max_pages_per_seq), TRASH_PAGE,
                              np.int32)
        ctx_lens = np.zeros(nr, np.int32)
        temps = np.zeros(nr, np.float32)
        top_ps = np.zeros(nr, np.float32)
        top_ks = np.zeros(nr, np.int32)
        seeds = np.zeros(nr, np.int32)
        spec_lens = np.zeros(nr, np.int32)
        for req, qlen, row in rows:
            start = int(self._cu_q[row])
            pos = np.arange(req.pos, req.pos + qlen)
            verify = row >= vbase and bool(req.spec_drafts)
            seq = req.tokens + req.spec_drafts if verify else req.tokens
            tokens[start:start + qlen] = seq[req.pos:req.pos + qlen]
            token_pos[start:start + qlen] = pos
            pages = np.asarray(req.pages, np.int32)
            token_page[start:start + qlen] = pages[pos // ps]
            token_off[start:start + qlen] = pos % ps
            q_lens[row] = qlen
            page_tables[row, :len(req.pages)] = req.pages
            ctx_lens[row] = req.pos + qlen
            temps[row] = req.temperature
            top_ps[row] = req.top_p
            top_ks[row] = req.top_k
            seeds[row] = req.seed
            if verify:
                spec_lens[row] = len(req.spec_drafts)
        arrays = (tokens, token_pos, token_page, token_off, q_lens,
                  self._cu_q, page_tables, ctx_lens, temps, top_ps, top_ks,
                  seeds)
        return arrays + (spec_lens,) if self.spec is not None else arrays

    def _run_unified(self, rows: List[Tuple[Request, int, int]]) -> int:
        s = self.scheduler.max_batch
        vbase = s + self.scheduler.prefill_rows
        for req, qlen, row in rows:
            if row < vbase and req.spec_drafts:
                # packed outside a verify slot: this row commits a token
                # the drafts never saw, so they are stale
                req.spec_drafts = []
        t0 = self._now()
        out = self._step_fn(self.params, *self._pack_arrays(rows),
                            self.pool.k_pages, self.pool.v_pages)
        if self.spec is not None:
            next_tokens, accepted = out
            accs = accepted.cpu().numpy()
        else:
            next_tokens = out
        toks = next_tokens.cpu().numpy()        # [rows] int32, ever
        dt = self._now() - t0
        self._calls += 1
        self.counters["step_calls"].inc()
        tr = self.tracer
        if tr.enabled:
            tr.complete("unified_step", t0, dt, track="engine",
                        exec=f"{self.name}/unified", rows=len(rows),
                        tokens=int(sum(q for _, q, _ in rows)))
        # classify by slot, not q_len: a verify row is neither
        n_decode = sum(1 for _, _, row in rows if row < s)
        if n_decode:
            self.counters["decode_steps"].inc()
        self.counters["prefill_chunks"].inc(
            sum(1 for _, _, row in rows if s <= row < vbase))
        produced = 0
        for req, qlen, row in rows:
            pre = max(0, min(qlen, req.prompt_len - req.pos))
            if pre:
                self.counters["prefill_tokens"].inc(pre)
                if tr.enabled:
                    tr.complete("prefill_chunk", t0, dt,
                                track=f"req {req.req_id}",
                                req=req.req_id, q_len=qlen,
                                prefill_tokens=pre, pos=req.pos,
                                budget_slice=qlen,
                                cached_skip=req.cached_tokens)
            if row >= vbase and req.spec_drafts:
                produced += self._commit_verify(req, int(accs[row]),
                                                int(toks[row]), t0, dt)
                continue
            req.pos += qlen
            if req.pos == len(req.tokens):      # row reached its tip:
                self._emit(req, int(toks[row]))  # commit the sample
                produced += 1
                self._observe_token(req, row < s, dt)
                self._maybe_finish(req)
        return produced

    def _commit_verify(self, req: Request, accepted: int, bonus: int,
                       t0: float, dt: float) -> int:
        """Commit a verify row: the accepted draft prefix plus the bonus
        token, capped by ``max_new_tokens`` and EOS, then rewind ``pos``
        to the accepted boundary.  The fed positions past it hold stale
        KV, which the next burst (or a re-prefill) writes before anything
        reads it.  Returns 1 if the request emitted, else 0."""
        drafts = req.spec_drafts
        n0 = len(req.tokens)
        committed = emitted = 0
        for i, tok in enumerate(drafts[:accepted] + [bonus]):
            if req.n_generated >= req.max_new_tokens:
                break
            self._emit(req, tok)
            emitted += 1
            committed += i < accepted
            self._observe_token(req, False, dt)
            if req.eos_token_id is not None and tok == req.eos_token_id:
                break
        req.pos = n0 + committed
        req.spec_drafts = []
        self.counters["spec_accepted"].inc(committed)
        if emitted > committed:
            self.counters["spec_bonus_tokens"].inc()
        tr = self.tracer
        if tr.enabled:
            tr.complete("verify", t0, dt, track=f"req {req.req_id}",
                        req=req.req_id, proposed=len(drafts),
                        accepted=accepted, committed=emitted)
            tr.instant("spec_accept", track=f"req {req.req_id}",
                       ts=self._now(), req=req.req_id, n=committed,
                       bonus=int(emitted > committed))
        self._maybe_finish(req)
        return 1 if emitted else 0

    def _observe_token(self, req: Request, decode_slot: bool,
                       dt: float) -> None:
        """Latency bookkeeping and the trace instant of ONE emitted
        token."""
        tr = self.tracer
        now = self._now()
        if tr.enabled:
            tr.instant("token", track=f"req {req.req_id}", ts=now,
                       req=req.req_id, n=req.n_generated,
                       decode_slot=bool(decode_slot))
        if req.first_token_time is None:
            req.first_token_time = now
            self.histograms["ttft"].observe(now - req.submit_time)
        else:
            self.histograms["tbt"].observe(
                now - (req.last_token_time or now))
            self.histograms["tpot"].observe(dt)
        req.last_token_time = now

    # -- sampling / retirement ----------------------------------------------

    def _emit(self, req: Request, token: int) -> None:
        tok = int(token)
        req.tokens.append(tok)
        req.out_tokens.append(tok)
        self.counters["tokens_generated"].inc()
        if req.stream_cb is not None:
            req.stream_cb(req, tok)

    def _maybe_finish(self, req: Request) -> None:
        if not req.done:
            return
        if self.spec is not None:
            self.spec.release(req)
            req.spec_drafts = []
        if self.prefix_cache is not None:
            self.prefix_cache.on_finish(req)
        else:
            self.pool.free(req.pages)
        req.pages = []
        req.state = FINISHED
        req.finish_time = self._now()
        tr = self.tracer
        if tr.enabled:
            tr.complete("running", req.trace_t0,
                        req.finish_time - req.trace_t0,
                        track=f"req {req.req_id}", req=req.req_id)
            tr.instant("finish", track=f"req {req.req_id}",
                       ts=req.finish_time, req=req.req_id,
                       new_tokens=req.n_generated,
                       preemptions=req.n_preemptions,
                       peak_pages=req.peak_pages)
        req.trace_t0 = req.finish_time
        if req in self.running:
            self.running.remove(req)
        self.finished[req.req_id] = req
        self.counters["requests_completed"].inc()
        self.histograms["request_latency"].observe(
            req.finish_time - req.submit_time)

    # -- observability -------------------------------------------------------

    def metrics_text(self) -> str:
        """Prometheus text exposition of every engine instrument."""
        insts: Dict[str, Any] = {}
        insts.update(self.counters)
        insts.update(self.gauges)
        insts.update(self.histograms)
        return render_prometheus(insts)

    def reset_metrics(self) -> None:
        """Zero every counter, gauge and histogram, and the step and call
        counts (the compiled steps and all request state stay), so a
        reading can leave out the first, capturing steps.
        ``compile_count`` does not reset: compiles are lifetime state."""
        self.steps = 0
        self._calls = 0
        for d in (self.counters, self.gauges, self.histograms):
            for k, inst in list(d.items()):
                if inst.__class__.__name__ == "_NullInstrument":
                    continue
                kw = {"buckets": list(inst.buckets)} \
                    if getattr(inst, "buckets", None) else {}
                d[k] = make_instrument(inst.__class__.__name__.lower(), k,
                                       True, **kw)
        if self.gauges["kv_bytes_per_token"].__class__.__name__ \
                != "_NullInstrument":
            # layout-static: re-seed rather than read 0 until a step
            self.gauges["kv_bytes_per_token"].set(
                self.pool.kv_bytes_per_token)

    def metrics_summary(self) -> Dict[str, Any]:
        out = {k: c.value for k, c in self.counters.items()}
        out.update({k: g.value for k, g in self.gauges.items()})
        for k, h in self.histograms.items():
            out[k] = h.summary()
        out["ttft_buckets"] = self.histograms["ttft"].bucket_counts()
        out["tbt_buckets"] = self.histograms["tbt"].bucket_counts()
        out["compile_count"] = self.compile_count
        out["executable_calls"] = self.executable_calls
        hits = self.counters["prefix_cache_hits"].value
        miss = self.counters["prefix_cache_misses"].value
        out["prefix_cache_hit_rate"] = hits / max(hits + miss, 1.0)
        out["prefix_cache_pages"] = self.pool.cached_pages
        # speculative decoding since the last reset: the draft hit rate,
        # and drafts plus bonus tokens committed a call of the step
        prop = self.counters["spec_proposed"].value
        acc = self.counters["spec_accepted"].value
        out["spec_accept_rate"] = acc / max(prop, 1.0)
        out["accepted_per_step"] = (
            (acc + self.counters["spec_bonus_tokens"].value) /
            max(self.counters["step_calls"].value, 1.0))
        return out
