"""Continuous-batching inference engine over the paged KV pool (port of
``hetu_tpu.serving.engine`` for the plain, dense, non-speculative
configuration).

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
plain version on the CPU.

Prefix reuse (``serving/prefix_cache.py``, on by default) and the
metrics (``utils/metrics.py``) are as in the JAX engine.  Speculative
decoding, MLA page layouts, the host KV tier, meshes, the tracer and the
analysis tap come with later slices of the port; the options that select
them raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.device import resolve_device
from ..core.dtype import torch_dtype
from ..models.generate import _Params
from ..models.gpt import GPTConfig, check_serving_config
from ..utils.metrics import make_instrument, render_prometheus
from .decode import build_unified_step_fn
from .kv_pool import TRASH_PAGE, PagedKVPool
from .prefix_cache import PrefixCache
from .request import FINISHED, RUNNING, Request, RequestQueue
from .scheduler import Scheduler

# default Prometheus-style latency bounds (seconds) for ttft/tbt
DEFAULT_LATENCY_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                           10.0)

_LATER_SLICES = {"spec": "speculative decoding",
                 "page_quant": "MLA serving (quantized latent pages)",
                 "host_tier": "SLO traffic plane (host KV tier)",
                 "mesh": "parallelism (sharded KV pool)"}


class Engine:
    def __init__(self, state: Dict[str, Any], cfg: GPTConfig,
                 num_pages: int = 64, page_size: int = 64,
                 max_batch: int = 8, max_model_len: Optional[int] = None,
                 chunk_size: Optional[int] = 64, prefill_rows: int = 1,
                 metrics: bool = True,
                 latency_buckets: Optional[Sequence[float]] = None,
                 time_fn: Optional[Callable[[], float]] = None,
                 prefix_cache: bool = True, debug: bool = False,
                 device="cuda", spec=None, page_quant=None,
                 host_tier=None, mesh=None):
        for name, val in (("spec", spec), ("page_quant", page_quant),
                          ("host_tier", host_tier), ("mesh", mesh)):
            if val is not None and val is not False:
                raise NotImplementedError(
                    f"Engine({name}=...) is ported with the "
                    f"{_LATER_SLICES[name]} slice")
        check_serving_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
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
            device=self.device, debug=debug)
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
                          "admitted_interactive", "admitted_standard",
                          "admitted_batch", "preempted_interactive",
                          "preempted_standard", "preempted_batch")}
        self.gauges = {k: make_instrument("gauge", k, m) for k in
                       ("batch_occupancy", "page_utilization",
                        "queue_depth", "kv_bytes_per_token",
                        "kv_bytes_in_use")}
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
        s, r, ck = (self.scheduler.max_batch, self.scheduler.prefill_rows,
                    self.scheduler.chunk)
        self._step_fn = build_unified_step_fn(
            cfg, s, ck, r, self.max_pages_per_seq, page_size,
            device=self.device)
        self.n_rows = s + r
        self.n_tokens = s + r * ck
        self._cu_q = np.concatenate([np.arange(s, dtype=np.int32),
                                     s + ck * np.arange(r + 1,
                                                        dtype=np.int32)])

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
        self._next_id += 1
        self.queue.push(req)
        return req

    # -- loop ----------------------------------------------------------------

    def _now(self) -> float:
        return self._time_fn()

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.running)

    def step(self) -> int:
        """One engine iteration: admit, pack prefill chunks + decodes
        into ONE ragged batch, run the unified step.  Returns the number
        of tokens emitted."""
        now = self._now()
        for req in self.scheduler.admit(self.queue, self.running, now):
            self._start(req)
        live = [r for r in self.running if r.state == RUNNING]
        kept, evicted = self.scheduler.ensure_decode_pages(live)
        for req in evicted:
            self.running.remove(req)
            self.queue.push(req)
            self.counters["preemptions"].inc()
            self.counters[f"preempted_{req.slo_class}"].inc()
        rows = self.scheduler.pack(kept)
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
        """Unified-step invocations (a plain counter, so it stays right
        under ``metrics=False``)."""
        return self._calls

    # -- admission / lifecycle -----------------------------------------------

    def _reclaim_cached_pages(self, n: int) -> int:
        """The pool's reclaim hook: LRU-sweep refcount-0 cached pages
        when the free list runs dry, before recompute preemption."""
        freed = self.prefix_cache.evict(n)
        if freed:
            self.counters["prefix_cache_evictions"].inc(freed)
        return freed

    def _start(self, req: Request) -> None:
        """Move an admitted request to RUNNING: attach the longest
        cached prefix (copy-on-write: ``pos`` starts at the cached
        boundary), then grant the pages the rest of its tokens need."""
        looked_up = self.prefix_cache is not None and req.pos == 0 \
            and not req.pages
        if looked_up:
            entries = self.prefix_cache.acquire(req)
            if entries:
                req.pages = [e.page for e in entries]
                req.shared_pages = len(entries)
                req.pos = len(entries) * self.pool.page_size
                req.cached_tokens = req.pos
        need = self.pool.pages_for(len(req.tokens)) - len(req.pages)
        pages = self.pool.alloc(need)
        if pages is None:
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
        req.state = RUNNING
        self.counters[f"admitted_{req.slo_class}"].inc()
        self.running.append(req)

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
            req.pages = []
            req.shared_pages = 0
            req.cached_tokens = 0
            req.pos = 0
            req.state = FINISHED          # terminal, but never collected
        self.queue.clear()
        self.running.clear()
        if self.debug:
            self.pool.check_invariants()
            if self.prefix_cache is not None:
                self.prefix_cache.check_invariants()
        return [r.req_id for r in victims]

    # -- the unified step ----------------------------------------------------

    def _pack_arrays(self, rows: List[Tuple[Request, int, int]]):
        """Host-side marshalling of the packed step: flat token arrays +
        per-row ragged descriptors + per-row sampling params."""
        t, nr = self.n_tokens, self.n_rows
        ps = self.pool.page_size
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
        for req, qlen, row in rows:
            start = int(self._cu_q[row])
            pos = np.arange(req.pos, req.pos + qlen)
            tokens[start:start + qlen] = req.tokens[req.pos:req.pos + qlen]
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
        return (tokens, token_pos, token_page, token_off, q_lens,
                self._cu_q, page_tables, ctx_lens, temps, top_ps, top_ks,
                seeds)

    def _run_unified(self, rows: List[Tuple[Request, int, int]]) -> int:
        s = self.scheduler.max_batch
        t0 = self._now()
        next_tokens = self._step_fn(self.params, *self._pack_arrays(rows),
                                    self.pool.k_pages, self.pool.v_pages)
        toks = next_tokens.cpu().numpy()        # [rows] int32, ever
        dt = self._now() - t0
        self._calls += 1
        self.counters["step_calls"].inc()
        n_decode = sum(1 for _, _, row in rows if row < s)
        if n_decode:
            self.counters["decode_steps"].inc()
        self.counters["prefill_chunks"].inc(len(rows) - n_decode)
        produced = 0
        for req, qlen, row in rows:
            pre = max(0, min(qlen, req.prompt_len - req.pos))
            if pre:
                self.counters["prefill_tokens"].inc(pre)
            req.pos += qlen
            if req.pos == len(req.tokens):      # row reached its tip:
                self._emit(req, int(toks[row]))  # commit the sample
                produced += 1
                self._observe_token(req, dt)
                self._maybe_finish(req)
        return produced

    def _observe_token(self, req: Request, dt: float) -> None:
        now = self._now()
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
        if self.prefix_cache is not None:
            self.prefix_cache.on_finish(req)
        else:
            self.pool.free(req.pages)
        req.pages = []
        req.state = FINISHED
        req.finish_time = self._now()
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

    def metrics_summary(self) -> Dict[str, Any]:
        out = {k: c.value for k, c in self.counters.items()}
        out.update({k: g.value for k, g in self.gauges.items()})
        for k, h in self.histograms.items():
            out[k] = h.summary()
        out["ttft_buckets"] = self.histograms["ttft"].bucket_counts()
        out["tbt_buckets"] = self.histograms["tbt"].bucket_counts()
        out["executable_calls"] = self.executable_calls
        hits = self.counters["prefix_cache_hits"].value
        miss = self.counters["prefix_cache_misses"].value
        out["prefix_cache_hit_rate"] = hits / max(hits + miss, 1.0)
        out["prefix_cache_pages"] = self.pool.cached_pages
        return out
