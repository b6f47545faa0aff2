"""Continuous-batching scheduler: admission, token-budget packing,
page budget, preemption (port of ``hetu_tpu.serving.scheduler``).

Every engine step the scheduler (1) admits arrived requests while the
page budget and sequence-slot budget allow, (2) guarantees every
running request a page for its next KV write (preempting the
lowest-class, latest-arrived request — recompute-style eviction — when
the pool runs dry), and (3) **packs** the step's ragged token batch:

- every request one token from emitting (a decode, or the 1-token tail
  of a chunked prefill) takes a single-token slot; there are
  ``max_batch`` of them, so every decode advances every step;
- the earliest-arrived requests still mid-prompt each get one ``chunk``
  slot (``prefill_rows`` of them per step), Sarathi-style;
- in speculative mode every decode-ready request with staged drafts
  takes a dedicated verify slot of ``spec_width`` tokens instead (one
  per sequence slot, after the chunk slots).
"""
from __future__ import annotations

from typing import List, Tuple

from .kv_pool import PagedKVPool
from .request import RUNNING, WAITING, Request, RequestQueue


class Scheduler:
    def __init__(self, pool: PagedKVPool, max_batch: int = 8,
                 chunk: int = 64, prefill_rows: int = 1,
                 prefix_cache=None):
        if prefill_rows < 1:
            raise ValueError(f"prefill_rows must be >= 1, got "
                             f"{prefill_rows}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.pool = pool
        self.max_batch = int(max_batch)
        self.chunk = int(chunk)
        self.prefill_rows = int(prefill_rows)
        # speculative mode (set by the engine): verify_slots dedicated
        # spec_width-wide rows after the chunk slots, one per sequence
        # slot, so verify bursts never compete with prompt prefills
        self.verify_slots = 0
        self.spec_width = 0
        # optional PrefixCache: admission charges only the UNCACHED
        # suffix (refcount-0 cached pages count as reclaimable budget);
        # preemption releases shared pages instead of freeing them
        self.cache = prefix_cache

    @property
    def token_budget(self) -> int:
        """Tokens one packed step can carry (the step's T)."""
        return self.max_batch + self.prefill_rows * self.chunk \
            + self.verify_slots * self.spec_width

    # -- admission -----------------------------------------------------------

    def admit(self, queue: RequestQueue, running: List[Request],
              now: float) -> List[Request]:
        """Pop arrived requests while a sequence slot AND the pages for
        prompt+first-token fit.  Fresh requests stop at the first that
        doesn't fit (FIFO within the class order); a page-holding
        request may overtake a blocked head."""
        admitted: List[Request] = []
        deferred: List[Request] = []
        budget = self.pool.free_pages
        if self.cache is not None:
            budget += self.cache.evictable_pages
        pinned = set()
        while len(running) + len(admitted) < self.max_batch:
            req = queue.pop_ready(now)
            if req is None:
                break
            if deferred and not req.pages:
                deferred.append(req)
                continue
            need = self.pool.pages_for(len(req.tokens) + 1) \
                - len(req.pages)
            new_pins = []
            if self.cache is not None and req.pos == 0 and not req.pages:
                for e in self.cache.match(req.tokens):
                    need -= 1          # cached page: nothing to allocate
                    if e.refs == 0 and e.eid not in pinned:
                        budget -= 1    # ...but it is no longer evictable
                        pinned.add(e.eid)
                        new_pins.append(e.eid)
            need = max(0, need)
            if need > budget:
                # blocked: roll back this candidate's pins so page
                # holders further back still see the budget
                for eid in new_pins:
                    pinned.discard(eid)
                    budget += 1
                deferred.append(req)
                continue
            budget -= need
            admitted.append(req)
        for req in deferred:
            queue.push(req)            # heap order restores FIFO
        return admitted

    # -- token-budget packing ------------------------------------------------

    def pack(self, running: List[Request]
             ) -> List[Tuple[Request, int, int]]:
        """Assign the step's rows: ``[(request, q_len, row_index)]``.
        Single-token rows fill slots ``[0, max_batch)``; mid-prompt
        requests fill chunk slots ``[max_batch, max_batch +
        prefill_rows)`` in class-then-arrival order with ``q_len =
        min(remaining, chunk)``.  In spec mode a decode-ready request with
        staged drafts takes a verify slot (``[max_batch + prefill_rows,
        ... + verify_slots)``) with ``q_len = 1 + len(spec_drafts)``
        instead of its decode slot."""
        live = sorted((r for r in running if r.state == RUNNING),
                      key=lambda r: (r.rank, r.arrival_time, r.req_id))
        rows: List[Tuple[Request, int, int]] = []
        verified = set()
        vbase = self.max_batch + self.prefill_rows
        for r in live:
            staged = len(r.spec_drafts)
            if len(r.tokens) - r.pos == 1 and staged \
                    and len(verified) < self.verify_slots \
                    and 1 + staged <= self.spec_width:
                rows.append((r, 1 + staged, vbase + len(verified)))
                verified.add(r.req_id)
        slot = 0
        for r in live:
            if len(r.tokens) - r.pos == 1 and r.req_id not in verified \
                    and slot < self.max_batch:
                rows.append((r, 1, slot))
                slot += 1
        chunk_row = 0
        for r in live:
            remaining = len(r.tokens) - r.pos
            if remaining > 1 and chunk_row < self.prefill_rows:
                rows.append((r, min(remaining, self.chunk),
                             self.max_batch + chunk_row))
                chunk_row += 1
        return rows

    def slot_mix(self, rows: List[Tuple[Request, int, int]]) -> dict:
        """The step's packing decision as a flat dict: how the token
        budget was split between decode slots, chunk slots and verify
        slots."""
        vbase = self.max_batch + self.prefill_rows
        n_decode = sum(1 for _, _, row in rows if row < self.max_batch)
        n_verify = sum(1 for _, _, row in rows if row >= vbase)
        return {"decode_slots": n_decode,
                "chunk_slots": len(rows) - n_decode - n_verify,
                "verify_slots": n_verify,
                "spec_tokens": int(sum(len(r.spec_drafts)
                                       for r, _, row in rows
                                       if row >= vbase)),
                "tokens": int(sum(q for _, q, _ in rows)),
                "token_budget": self.token_budget,
                "chunk": self.chunk,
                "prefill_rows": self.prefill_rows}

    # -- decode page budget --------------------------------------------------

    def ensure_decode_pages(self, running: List[Request]
                            ) -> Tuple[List[Request], List[Request]]:
        """Give every running request the pages its next KV writes need
        (one token, or ``1 + len(spec_drafts)`` for a verify burst, which
        may cross a page boundary), evicting lowest-class latest-arrived
        requests on exhaustion.  A page squeeze sheds the requester's
        staged drafts first: a burst degraded to a plain decode costs
        nothing, an eviction a whole re-prefill.  Returns (kept,
        evicted); evicted requests are already reset to WAITING with
        their pages freed."""
        evicted: List[Request] = []
        kept = sorted(running,
                      key=lambda r: (r.rank, r.arrival_time, r.req_id))
        for req in list(kept):
            if req in evicted:
                continue
            while True:
                need_tokens = req.pos + 1 + len(req.spec_drafts)
                if len(req.pages) * self.pool.page_size >= need_tokens:
                    break              # current pages still have room
                got = self.pool.alloc(self.pool.pages_for(need_tokens)
                                      - len(req.pages))
                if got is not None:
                    req.pages.extend(got)
                    req.peak_pages = max(req.peak_pages, len(req.pages))
                    break
                if req.spec_drafts:
                    req.spec_drafts = []   # shed the burst, keep running
                    continue
                # lowest class first, then latest arrival; the requester
                # itself is a candidate
                victims = [r for r in kept if r not in evicted]
                victim = max(victims,
                             key=lambda r: (r.rank, r.arrival_time,
                                            r.req_id))
                self.preempt(victim)
                evicted.append(victim)
                if victim is req:
                    break
        return [r for r in kept if r not in evicted], evicted

    def preempt(self, req: Request) -> None:
        """Recompute-style eviction: drop KV state, keep the token
        history.  Shared prefix-cache pages are released, never freed."""
        self.pool.free(req.pages[req.shared_pages:])
        if self.cache is not None and req.shared_pages:
            self.cache.release(req)
        req.pages = []
        req.shared_pages = 0
        req.cached_tokens = 0
        req.spec_drafts = []
        req.pos = 0
        req.state = WAITING
        req.n_preemptions += 1
