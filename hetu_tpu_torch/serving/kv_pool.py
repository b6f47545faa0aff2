"""Paged KV-cache pool: preallocated page storage + free-list allocator
(port of ``hetu_tpu.serving.kv_pool``).

The pool preallocates ``num_pages`` fixed ``page_size``-token pages per
layer on the engine's device and hands them out on demand: a request
holds ``ceil(len / page_size)`` pages, so mixed-length traffic shares
device memory in proportion to what it uses.  Full-head pages are
``[num_pages, page_size, kv_heads, head_dim]`` for k and v; the latent
(MLA) layouts are described at :class:`PagedKVPool`.

Page 0 is the reserved **trash page**: every padded page-table slot and
every padding token's KV write points at it, so the serving step can
scatter unconditionally with fixed shapes — writes land in the trash
page, reads past ``ctx_len`` are masked by the attention.  It is never
allocated.

Pages live in one of three states: **free** (on the free list),
**allocated** (owned by exactly one request, writable) or **cached**
(owned by the prefix cache, read-only, refcounted by live sharers;
refcount 0 = evictable).  ``alloc`` consults an optional reclaim hook —
the prefix cache's LRU sweep — before failing.

The page tensors are updated in place by the serving step (JAX's
version returns new arrays from a donated buffer instead).
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

TRASH_PAGE = 0

# Process-global protocol sequence counter: every record the pool and
# engine log is stamped with the next value, so records of different
# planes interleave in causal order.
_PROTOCOL_SEQ = itertools.count(1)


def protocol_seq() -> int:
    """Next value of the process-global event sequence counter."""
    return next(_PROTOCOL_SEQ)


# page_quant codes for the layout tag (order is part of the tag)
_QUANT_CODES = {None: 0, "int8": 1, "nf4": 2}


def page_shape_bytes(shape: Sequence[int], dtype: torch.dtype) -> int:
    """Bytes ONE page of a per-layer page array ``[P, ps, h, w]``
    occupies (everything but the leading page axis)."""
    n = 1
    for d in shape[1:]:
        n *= int(d)
    return n * dtype.itemsize


def page_partition_problems(num_pages: int, free_list, allocated,
                            cached, trash: int = TRASH_PAGE) -> List[str]:
    """Allocator bookkeeping invariants: free/allocated/cached PARTITION
    the usable pages (pairwise disjoint, nothing leaked or invented),
    trash page never issued, cached refcounts non-negative.  Copy of
    ``hetu_tpu.analysis.protocol.page_partition_problems``; the message
    strings are the contract."""
    problems: List[str] = []
    free = set(free_list)
    allocated = set(allocated)
    cached_map = dict(cached)
    cached_set = set(cached_map)
    if len(free) != len(list(free_list)):
        problems.append("free list holds duplicates")
    if free & allocated:
        problems.append("page both free and allocated")
    if free & cached_set:
        problems.append("page both free and cached")
    if allocated & cached_set:
        problems.append("page both allocated and cached")
    if free | allocated | cached_set != set(range(1, num_pages)):
        problems.append("pages leaked or invented")
    if trash in free or trash in allocated:
        problems.append("reserved trash page was issued")
    if trash in cached_set:
        problems.append("trash page entered the cache")
    if any(rc < 0 for rc in cached_map.values()):
        problems.append("negative cached-page refcount")
    return problems


class PagedKVPool:
    """Free-list page allocator over per-layer k/v page tensors.

    Two layouts share every allocator and bookkeeping path:

    - **full-head** (default): k and v pages are both
      ``[P, ps, kv_heads, head_dim]``.
    - **latent** (MLA, ``latent_dim`` set): k_pages hold ONE compressed
      stream ``[P, ps, 1, latent_dim]`` and v_pages carry the decoupled
      rotated key ``[P, ps, 1, rope_dim]`` (width 0 for learned
      positions).  With ``quant`` set (int8/nf4, learned-position MLA
      only), k_pages store codes (int8, or packed uint8 at
      ``latent_dim // 2``) and v_pages become the per-token fp32 absmax
      sidecar ``[P, ps, 1, 1]``.

    Page-table math, the allocator, the refcounts and the prefix cache
    never look inside a page; only ``page_bytes`` and ``layout_tag``
    observe the difference.
    """

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 kv_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 debug: bool = False, latent_dim: Optional[int] = None,
                 rope_dim: int = 0, quant: Optional[str] = None):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is the "
                             f"reserved trash page), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if quant is not None:
            if quant not in ("int8", "nf4"):
                raise ValueError(f"page quant must be int8|nf4, "
                                 f"got {quant!r}")
            if latent_dim is None or rope_dim:
                raise ValueError("page quantization requires the latent "
                                 "(MLA) layout with rope_dim == 0 — the "
                                 "v-page slot carries the absmax sidecar")
            if quant == "nf4" and latent_dim % 2:
                raise ValueError(f"nf4 pages need even latent_dim, got "
                                 f"{latent_dim}")
        self.num_layers = int(num_layers)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.kv_heads = int(kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.latent_dim = None if latent_dim is None else int(latent_dim)
        self.rope_dim = int(rope_dim)
        self.quant = quant
        if latent_dim is not None:
            if quant == "int8":
                k_shape = (num_pages, page_size, 1, self.latent_dim)
                k_dtype = torch.int8
            elif quant == "nf4":
                k_shape = (num_pages, page_size, 1, self.latent_dim // 2)
                k_dtype = torch.uint8
            else:
                k_shape = (num_pages, page_size, 1, self.latent_dim)
                k_dtype = dtype
            # rope stream, or the per-token absmax sidecar when quantized
            v_shape = (num_pages, page_size, 1, 1 if quant else self.rope_dim)
            v_dtype = torch.float32 if quant else dtype
        else:
            k_shape = v_shape = (num_pages, page_size, kv_heads, head_dim)
            k_dtype = v_dtype = dtype
        self.k_pages: Tuple[torch.Tensor, ...] = tuple(
            torch.zeros(k_shape, dtype=k_dtype, device=device)
            for _ in range(num_layers))
        self.v_pages: Tuple[torch.Tensor, ...] = tuple(
            torch.zeros(v_shape, dtype=v_dtype, device=device)
            for _ in range(num_layers))
        # LIFO free list: recently-freed pages are re-issued first;
        # page 0 reserved
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._allocated = set()
        # read-only pages owned by the prefix cache: page -> live sharers
        self._cached: Dict[int, int] = {}
        # invoked by alloc() when the free list can't cover a request:
        # fn(n_short) reclaims up to n_short cached pages (LRU sweep)
        self._reclaim: Optional[Callable[[int], int]] = None
        # times a reclaim hook claimed more/fewer pages than landed on
        # the free list (a lying hook falls through to preemption)
        self.reclaim_shortfalls = 0
        # O(num_pages) invariant rebuilds are opt-in (debug / force)
        self.debug = bool(debug)
        # append-only op log ``(seq, op, pages)``
        self.event_log: List[Tuple[int, str, List[int]]] = []

    # -- allocator -----------------------------------------------------------

    @property
    def num_usable(self) -> int:
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._allocated)

    @property
    def utilization(self) -> float:
        return self.used_pages / self.num_usable

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` KV entries."""
        return -(-int(n_tokens) // self.page_size)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages; None (no partial grant) when the pool
        can't satisfy the request — the scheduler's eviction signal.  A
        dry free list first triggers the reclaim hook; only pages that
        actually landed on the free list satisfy the request."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free) and self._reclaim is not None:
            before = len(self._free)
            claimed = self._reclaim(n - before)
            delivered = len(self._free) - before
            if claimed is not None and int(claimed) != delivered:
                self.reclaim_shortfalls += 1
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._allocated.update(pages)
        if pages:
            self.event_log.append((protocol_seq(), "alloc", list(pages)))
        return pages

    def free(self, pages: Sequence[int]) -> None:
        for pg in pages:
            if pg not in self._allocated:
                raise ValueError(f"double free / foreign page {pg}")
            self._allocated.remove(pg)
            self._free.append(pg)
        pages = list(pages)
        if pages:
            self.event_log.append((protocol_seq(), "free", pages))

    # -- cached (read-only, refcounted) pages --------------------------------

    def set_reclaim(self, fn: Optional[Callable[[int], int]]) -> None:
        """Install the cache's LRU sweep: ``fn(n)`` frees up to ``n``
        refcount-0 cached pages; ``alloc`` calls it before failing."""
        self._reclaim = fn

    @property
    def cached_pages(self) -> int:
        return len(self._cached)

    def refcount(self, pg: int) -> int:
        """0 = free, 1 = exclusively owned (allocated, or cached with no
        sharer), 1+n = cached and shared by n live requests.  A KV write
        plan may only target refcount-1 ALLOCATED pages."""
        if pg in self._cached:
            return 1 + self._cached[pg]
        return 1 if pg in self._allocated else 0

    def cache_page(self, pg: int) -> None:
        """allocated -> cached (refcount 0), read-only from here."""
        if pg not in self._allocated:
            raise ValueError(f"cannot cache non-allocated page {pg}")
        self._allocated.remove(pg)
        self._cached[pg] = 0
        self.event_log.append((protocol_seq(), "cache", [pg]))

    def share_page(self, pg: int) -> None:
        """A live request attached this cached page to its page table."""
        if pg not in self._cached:
            raise ValueError(f"cannot share non-cached page {pg}")
        self._cached[pg] += 1
        self.event_log.append((protocol_seq(), "share", [pg]))

    def unshare_page(self, pg: int) -> None:
        if self._cached.get(pg, 0) < 1:
            raise ValueError(f"unshare of page {pg} with no sharers")
        self._cached[pg] -= 1
        self.event_log.append((protocol_seq(), "unshare", [pg]))

    def uncache_page(self, pg: int) -> None:
        """cached (refcount 0) -> free: the cache evicted the entry."""
        if pg not in self._cached:
            raise ValueError(f"cannot uncache non-cached page {pg}")
        if self._cached[pg] != 0:
            raise ValueError(f"evicting cached page {pg} with "
                             f"{self._cached[pg]} live sharers")
        del self._cached[pg]
        self._free.append(pg)
        self.event_log.append((protocol_seq(), "uncache", [pg]))

    def reset(self, clear_pages: bool = False) -> None:
        """Return the pool to its post-construction allocator state.  The
        rebuilt free list excludes the reserved trash page 0.
        ``clear_pages`` also zeroes the page storage, in place, so a
        captured step bound to these tensors stays valid (the JAX pool
        installs fresh zero arrays instead)."""
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._allocated = set()
        self._cached = {}
        self.event_log = [(protocol_seq(), "reset", [])]
        if clear_pages:
            for p in self.k_pages + self.v_pages:
                p.zero_()

    def check_invariants(self, force: bool = False) -> None:
        """Allocator bookkeeping invariants (see
        :func:`page_partition_problems`).  A no-op unless the pool was
        built with ``debug=True`` or ``force=True`` is passed."""
        if not (self.debug or force):
            return
        problems = page_partition_problems(
            self.num_pages, self._free, self._allocated, self._cached)
        if problems:
            raise AssertionError("; ".join(problems))

    # -- accounting ----------------------------------------------------------

    @property
    def is_latent(self) -> bool:
        return self.latent_dim is not None

    def page_array_shapes(self):
        """Per-layer (k, v) page-tensor shapes, read from the live
        tensors, so they are right for every layout."""
        return (tuple(tuple(p.shape) for p in self.k_pages),
                tuple(tuple(p.shape) for p in self.v_pages))

    @property
    def page_bytes(self) -> int:
        """Device bytes one page holds across k+v and all layers, summed
        from the live page tensors."""
        return sum(page_shape_bytes(p.shape, p.dtype)
                   for p in self.k_pages + self.v_pages)

    @property
    def kv_bytes_per_token(self) -> int:
        """KV bytes ONE cached token costs across all layers."""
        return self.page_bytes // self.page_size

    @property
    def layout_tag(self) -> Tuple[int, ...]:
        """Compact int tuple identifying the page LAYOUT (not contents):
        two pools agree on it iff a page of one can be placed in the
        other and read back identically."""
        if self.is_latent:
            return (1, self.latent_dim, self.rope_dim,
                    _QUANT_CODES[self.quant], self.dtype.itemsize)
        return (0, self.kv_heads, self.head_dim, 0, self.dtype.itemsize)

    def set_pages(self, k_pages, v_pages) -> None:
        """Install new per-layer page contents.  They are copied into the
        pool's own tensors, which keep their identity: a captured serving
        step stays bound to the tensors of its first call, so it reads the
        new contents at its next replay.  Raises ``ValueError`` unless
        every tensor matches its page tensor's shape and dtype."""
        new = (tuple(k_pages), tuple(v_pages))
        for have, got in zip((self.k_pages, self.v_pages), new):
            if len(got) != len(have) or any(
                    g.shape != h.shape or g.dtype != h.dtype
                    for g, h in zip(got, have)):
                raise ValueError(
                    "set_pages: the new pages must match the pool's "
                    f"{len(have)} tensors of shape "
                    f"{tuple(have[0].shape)} and dtype {have[0].dtype}")
        for have, got in zip((self.k_pages, self.v_pages), new):
            for h, g in zip(have, got):
                h.copy_(g)
