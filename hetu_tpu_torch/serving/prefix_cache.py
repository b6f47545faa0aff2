"""Copy-on-write prefix caching over the paged KV pool (port of
``hetu_tpu.serving.prefix_cache``).

**Chained page keys.**  A full page of KV at page index ``i`` is
determined by exactly ``tokens[0 : (i+1)*page_size]`` (causality), so
the index keys each cached page by ``(parent_entry_id, page_tokens)``:
the parent link chains the whole prefix into the key and equal keys
imply equal full token prefixes.  Lookups walk the chain page by page
and stop at the first divergence: the longest cached page-aligned
prefix.

**Copy-on-write rules.**  Cached pages are READ-ONLY.  A request that
attaches a cached prefix starts its KV cursor (``pos``) at the cached
boundary, so its KV write plan only ever targets freshly allocated
pages.  The pool tracks a refcount per cached page (``1 +`` live
sharers).

**Lookup cap.**  A match is capped at ``(len(tokens) - 1) // page_size``
pages: at least one token always remains uncached, because the engine
must still run the final prompt position to sample the first new token.

**Insertion** happens when a request FINISHES: every fully-written page
moves into the index at refcount 0; pages whose content is already
cached are freed as duplicates; the partial tail page is freed.

**Eviction** is LRU over refcount-0 entries, leaves first.  The pool
calls :meth:`evict` through its reclaim hook when the free list runs
dry, so cache reclamation happens before recompute preemption.

**Content-chained digest.**  Entry ids are private to one cache, so
the prefix key two caches compute alike from token content alone is a
chain of 64-bit blake2b hashes (:func:`chain_hash`), its root salted
with the pool's ``layout_tag``: :meth:`PrefixCache.digest` exports
``{chain_hash: depth + 1}`` and :func:`token_chain_hashes` computes the
same keys for a prompt.  The hashes are pure Python over token ids, so
they are the JAX package's bit for bit.  :meth:`PrefixCache.restore`
re-inserts a page refetched from a host tier (the engine's host tier
comes with the SLO slice of the port).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .kv_pool import PagedKVPool

ROOT = -1                       # parent id of a first-page entry

#: seed of the content-chained digest hashes (the "hash of the empty
#: prefix")
ROOT_HASH = 0x9E3779B97F4A7C15


def chain_hash(parent_hash: int, page_tokens: Sequence[int]) -> int:
    """Content-chained 64-bit page hash ``H(parent_hash, tokens)``:
    blake2b over the parent hash (8 bytes, little-endian) and the page's
    token ids as int64.  Equal chain hashes imply equal full token
    prefixes up to 64-bit collision odds."""
    h = hashlib.blake2b(digest_size=8)
    h.update(int(parent_hash).to_bytes(8, "little", signed=False))
    h.update(np.asarray(list(page_tokens), np.int64).tobytes())
    return int.from_bytes(h.digest(), "little")


def token_chain_hashes(tokens: Sequence[int], page_size: int,
                       max_pages: Optional[int] = None,
                       layout: Sequence[int] = ()) -> List[int]:
    """The chain hashes of every FULL page prefix of ``tokens`` (at most
    ``max_pages``; by default capped at ``(len - 1) // page_size`` like
    :meth:`PrefixCache.match`).  ``result[i]`` keys the prefix
    ``tokens[:(i+1)*page_size]``.  ``layout`` (a pool's ``layout_tag``)
    salts the root, so caches of different page layouts share no keys;
    an empty layout keeps the unsalted chain."""
    ps = int(page_size)
    n = max(0, len(tokens) - 1) // ps
    if max_pages is not None:
        n = min(n, int(max_pages))
    out: List[int] = []
    h = chain_hash(ROOT_HASH, layout) if len(layout) else ROOT_HASH
    for i in range(n):
        h = chain_hash(h, tokens[i * ps:(i + 1) * ps])
        out.append(h)
    return out


@dataclass
class CacheEntry:
    """One cached read-only page: a node in the prefix tree."""
    eid: int                    # unique entry id (the chain link)
    parent: int                 # parent entry id, ROOT for page 0
    tokens: Tuple[int, ...]     # this page's token content
    page: int                   # physical page in the pool
    depth: int                  # page index within its prefix
    last_use: int = 0           # LRU clock (monotonic ticks)
    refs: int = 0               # live requests sharing this page
    children: int = 0           # child entries extending this prefix


def cache_index_problems(cache: "PrefixCache", pool: PagedKVPool
                         ) -> List[str]:
    """Prefix-cache bookkeeping invariants: index and id map agree,
    refcounts non-negative, parent refcounts dominate children's, child
    counts exact, per-page refcounts mirror the pool's cached partition,
    attached references accounted.  Copy of
    ``hetu_tpu.analysis.protocol.cache_index_problems`` (same
    messages)."""
    problems: List[str] = []
    if len(cache._index) != len(cache._by_id):
        problems.append("cache index and id map disagree")
    per_page_refs: Dict[int, int] = {}
    children: Dict[int, int] = {}
    for e in cache._index.values():
        if cache._by_id.get(e.eid) is not e:
            problems.append(f"entry {e.eid} missing from the id map")
        if e.refs < 0:
            problems.append(f"negative refcount on entry {e.eid}")
        per_page_refs[e.page] = e.refs
        if e.parent != ROOT:
            parent = cache._by_id.get(e.parent)
            if parent is None:
                problems.append(f"entry {e.eid} orphaned: parent "
                                f"{e.parent} evicted")
                continue
            if parent.depth != e.depth - 1:
                problems.append(f"entry {e.eid} at depth {e.depth} "
                                f"does not extend its parent at depth "
                                f"{parent.depth}")
            if parent.refs < e.refs:
                problems.append("child page outlives its parent's "
                                "sharers")
            children[e.parent] = children.get(e.parent, 0) + 1
    for e in cache._index.values():
        if e.children != children.get(e.eid, 0):
            problems.append(f"entry {e.eid} claims {e.children} "
                            f"children, counted "
                            f"{children.get(e.eid, 0)}")
    if per_page_refs != dict(pool._cached):
        problems.append("cache index and pool cached-page partition "
                        "diverged")
    attached_refs: Dict[int, int] = {}
    for entries in cache._attached.values():
        for e in entries:
            attached_refs[e.eid] = attached_refs.get(e.eid, 0) + 1
    for e in cache._index.values():
        if e.refs != attached_refs.get(e.eid, 0):
            problems.append(f"entry {e.eid} refcount {e.refs} != "
                            f"attached references")
    return problems


class PrefixCache:
    """Refcounted index of read-only cached pages in a PagedKVPool."""

    def __init__(self, pool: PagedKVPool):
        self.pool = pool
        self.page_size = pool.page_size
        self._index: Dict[Tuple[int, Tuple[int, ...]], CacheEntry] = {}
        self._by_id: Dict[int, CacheEntry] = {}
        # req_id -> the entries it holds references on
        self._attached: Dict[int, List[CacheEntry]] = {}
        self._next_id = 0
        self._tick = 0
        # host-tier hook (serving/slo/host_tier.py): called with
        # (entry, chain_hash) just BEFORE an evicted page returns to the
        # free list, while the page is still cached and its parent chain
        # still indexed (leaf-first eviction), so the hook can stage its
        # bytes to host RAM under its chain hash
        self.on_evict = None

    def __len__(self) -> int:
        return len(self._index)

    @property
    def evictable_pages(self) -> int:
        """Pages an eviction sweep could reclaim right now: exactly the
        refcount-0 entries."""
        return sum(1 for e in self._index.values() if e.refs == 0)

    @property
    def version(self) -> Tuple[int, int]:
        """Change stamp for digest memoization: ``_next_id`` moves on
        every insertion and the index size on every eviction (a dedup'd
        re-insert changes neither, and the digest stays the same)."""
        return (self._next_id, len(self._index))

    def digest(self) -> Dict[int, int]:
        """``{chain_hash: depth + 1}`` for every cached page, the chain
        rooted at the pool's ``layout_tag`` (as ``token_chain_hashes(...,
        layout=pool.layout_tag)``).  Computed parents first, so each hash
        extends its parent's."""
        hashes: Dict[int, int] = {}        # eid -> chain hash
        out: Dict[int, int] = {}
        root = chain_hash(ROOT_HASH, self.pool.layout_tag)
        for e in sorted(self._index.values(), key=lambda e: e.depth):
            h = chain_hash(root if e.parent == ROOT else hashes[e.parent],
                           e.tokens)
            hashes[e.eid] = h
            out[h] = e.depth + 1
        return out

    def chain_hash_of(self, e: CacheEntry) -> int:
        """The entry's layout-salted chain hash (the key :meth:`digest`
        exports), from its parent links."""
        chain: List[Tuple[int, ...]] = []
        cur: Optional[CacheEntry] = e
        while cur is not None:
            chain.append(cur.tokens)
            cur = self._by_id.get(cur.parent) if cur.parent != ROOT \
                else None
        h = chain_hash(ROOT_HASH, self.pool.layout_tag)
        for tokens in reversed(chain):
            h = chain_hash(h, tokens)
        return h

    # -- lookup / attach -----------------------------------------------------

    def _max_match_pages(self, tokens: Sequence[int]) -> int:
        return max(0, len(tokens) - 1) // self.page_size

    def match(self, tokens: Sequence[int]) -> List[CacheEntry]:
        """Longest chain of cached full pages covering ``tokens`` — no
        side effects."""
        ps = self.page_size
        out: List[CacheEntry] = []
        parent = ROOT
        for i in range(self._max_match_pages(tokens)):
            e = self._index.get((parent, tuple(tokens[i * ps:(i + 1) * ps])))
            if e is None:
                break
            out.append(e)
            parent = e.eid
        return out

    def acquire(self, req) -> List[CacheEntry]:
        """Attach the longest cached prefix to ``req``: refcount every
        matched page and touch the LRU clock."""
        entries = self.match(req.tokens)
        if not entries:
            return entries
        self._tick += 1
        for e in entries:
            e.refs += 1
            e.last_use = self._tick
            self.pool.share_page(e.page)
        self._attached[req.req_id] = entries
        return entries

    def release(self, req) -> int:
        """Drop ``req``'s shared references (preemption, admission
        rollback, or the tail of :meth:`on_finish`)."""
        entries = self._attached.pop(req.req_id, [])
        for e in entries:
            e.refs -= 1
            self.pool.unshare_page(e.page)
        return len(entries)

    # -- insertion (request finish) ------------------------------------------

    def on_finish(self, req) -> Tuple[int, int]:
        """Retire a finished request's pages through the cache.  Returns
        ``(pages_inserted, pages_freed)``."""
        ps = self.page_size
        shared = self._attached.get(req.req_id, [])
        full = min(len(req.pages), req.pos // ps)
        parent = shared[-1].eid if shared else ROOT
        inserted = 0
        for i in range(len(shared), full):
            key = (parent, tuple(req.tokens[i * ps:(i + 1) * ps]))
            page = req.pages[i]
            have = self._index.get(key)
            if have is not None:
                self.pool.free([page])      # duplicate content
                parent = have.eid
                continue
            parent = self._insert(key, page, i).eid
            inserted += 1
        tail = req.pages[full:]
        if tail:
            self.pool.free(tail)
        self.release(req)
        freed = (full - len(shared) - inserted) + len(tail)
        req.pages = []
        req.shared_pages = 0
        return inserted, freed

    # -- eviction ------------------------------------------------------------

    def evict(self, n: int) -> int:
        """Reclaim up to ``n`` pages: LRU refcount-0 leaves first."""
        freed = 0
        while freed < n:
            cands = [e for e in self._index.values()
                     if e.refs == 0 and e.children == 0]
            if not cands:
                break
            self._remove(min(cands, key=lambda e: (e.last_use, e.eid)))
            freed += 1
        return freed

    def _remove(self, e: CacheEntry) -> None:
        if self.on_evict is not None:
            self.on_evict(e, self.chain_hash_of(e))
        del self._index[(e.parent, e.tokens)]
        del self._by_id[e.eid]
        if e.parent != ROOT:
            self._by_id[e.parent].children -= 1
        self.pool.uncache_page(e.page)

    # -- host-tier restore ---------------------------------------------------

    def _insert(self, key: Tuple[int, Tuple[int, ...]], page: int,
                depth: int) -> CacheEntry:
        """A new refcount-0 entry for ``page`` under ``key``."""
        parent = key[0]
        self.pool.cache_page(page)
        self._tick += 1
        e = CacheEntry(eid=self._next_id, parent=parent, tokens=key[1],
                       page=page, depth=depth, last_use=self._tick)
        self._next_id += 1
        self._index[key] = e
        self._by_id[e.eid] = e
        if parent != ROOT:
            self._by_id[parent].children += 1
        return e

    def restore(self, parent: int, tokens: Sequence[int], page: int,
                depth: int) -> CacheEntry:
        """Re-insert a page refetched from a host tier: ``page`` is
        allocated and already holds the bytes; it becomes a refcount-0
        entry under ``parent`` as if :meth:`on_finish` had inserted it.
        The key must be absent."""
        key = (parent, tuple(tokens))
        if key in self._index:
            raise ValueError(f"restore of already-cached page at "
                             f"depth {depth}")
        return self._insert(key, page, depth)

    def clear(self) -> None:
        """Evict everything evictable (attached entries survive: live
        requests still read their pages)."""
        self.evict(len(self._index))

    # -- invariants ----------------------------------------------------------

    def check_invariants(self, force: bool = False) -> None:
        """Cache-side bookkeeping invariants; runs only under
        ``pool.debug`` or ``force``."""
        if not (self.pool.debug or force):
            return
        problems = cache_index_problems(self, self.pool)
        if problems:
            raise AssertionError("; ".join(problems))
