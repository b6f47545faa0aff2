"""The port's prefix cache and pool surface against the JAX package, on
the CPU.

- ``chain_hash`` and ``token_chain_hashes``: bit-equal to JAX's, with and
  without a layout salt (pure Python over token ids in both);
- ``digest``: the same operations on both packages' pools and caches give
  equal digests; its keys are ``token_chain_hashes(..., layout=
  pool.layout_tag)`` and ``chain_hash_of``; layouts never cross-match;
- ``version``, ``__len__``, ``restore`` (the host tier's entry point,
  tested directly), ``clear``;
- the pool's ``refcount``, ``reset`` (the trash page is never issued
  again; ``clear_pages`` zeroes the tensors in place) and ``set_pages``;
- the randomized alloc/free/share/evict trace of ``tests/test_prefix_cache
  .py``, with the invariants checked after every operation.

The cases of ``tests/test_prefix_cache.py`` that need the cluster or the
host tier wait for those slices (ROADMAP queue 1 item 9).
"""
import numpy as np
import pytest
import torch

from hetu_tpu.serving import PagedKVPool as JaxPool
from hetu_tpu.serving import PrefixCache as JaxCache
from hetu_tpu.serving import Request as JaxRequest
from hetu_tpu.serving import prefix_cache as jax_pc
from hetu_tpu_torch.serving import PagedKVPool, PrefixCache, Request
from hetu_tpu_torch.serving import prefix_cache as pc
from hetu_tpu_torch.serving.kv_pool import TRASH_PAGE


def _pool(num_pages=10, page_size=4, **kw):
    return PagedKVPool(1, num_pages, page_size, 1, 4, device="cpu",
                       debug=True, **kw)


def _finish(pool, cache, rid, tokens, request=Request):
    """A fake request through alloc -> write -> on_finish, so its full
    pages land in the index (no model involved)."""
    req = request(req_id=rid, prompt=list(tokens), max_new_tokens=1)
    req.pages = pool.alloc(pool.pages_for(len(tokens)))
    req.pos = len(tokens)
    cache.on_finish(req)
    pool.check_invariants()
    cache.check_invariants()
    return req


# ---------------------------------------------------------------------------
# chain hashes and the digest, against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", [(), (0, 1, 4, 0, 4), (1, 16, 4, 0, 2)])
def test_chain_hashes_bit_equal_to_jax(layout):
    rng = np.random.RandomState(0)
    tokens = [int(t) for t in rng.randint(0, 128256, size=77)]
    assert pc.ROOT_HASH == jax_pc.ROOT_HASH
    assert pc.chain_hash(pc.ROOT_HASH, tokens[:8]) == \
        jax_pc.chain_hash(jax_pc.ROOT_HASH, tokens[:8])
    for ps, max_pages in ((8, None), (16, None), (8, 3), (64, None)):
        got = pc.token_chain_hashes(tokens, ps, max_pages, layout=layout)
        want = jax_pc.token_chain_hashes(tokens, ps, max_pages,
                                         layout=layout)
        assert got == want
        assert len(got) == min(76 // ps, max_pages or 99)
    # a salt changes every hash; the chain is deterministic
    if layout:
        assert not set(pc.token_chain_hashes(tokens, 8, layout=layout)) & \
            set(pc.token_chain_hashes(tokens, 8))


def _trace(pool, cache, request):
    """The same operations on either package: two finished requests
    sharing two pages (4 entries), a duplicate, an eviction of the
    oldest leaf (3 entries)."""
    _finish(pool, cache, 0, list(range(13)), request)      # 3 full pages
    _finish(pool, cache, 1, list(range(8)) + [50, 51, 52, 53, 54],
            request)                                       # branch at 2
    _finish(pool, cache, 2, list(range(9)), request)       # duplicate
    cache.evict(1)


def test_digest_equals_jax_and_token_chain_hashes():
    pool = _pool(num_pages=12)
    cache = PrefixCache(pool)
    jpool = JaxPool(num_layers=1, num_pages=12, page_size=4, kv_heads=1,
                    head_dim=4, debug=True)
    jcache = JaxCache(jpool)
    assert pool.layout_tag == jpool.layout_tag
    _trace(pool, cache, Request)
    _trace(jpool, jcache, JaxRequest)
    digest = cache.digest()
    assert digest == jcache.digest()
    assert len(digest) == len(cache) == len(jcache) == 3
    tag = pool.layout_tag
    hs = pc.token_chain_hashes(list(range(8)) + [50, 51, 52, 53, 54], 4,
                               layout=tag)
    assert [digest.get(h) for h in hs] == [1, 2, 3]
    assert sorted(cache.chain_hash_of(e) for e in cache._index.values()) \
        == sorted(digest)
    # an unsalted chain, or another layout's, shares no key
    assert not set(pc.token_chain_hashes(list(range(13)), 4)) & set(digest)
    latent = _pool(num_pages=12, latent_dim=16)
    assert latent.layout_tag != tag
    lcache = PrefixCache(latent)
    _finish(latent, lcache, 0, list(range(13)))
    assert not set(lcache.digest()) & set(digest)


def test_version_len_restore_and_clear():
    pool = _pool(num_pages=10)
    cache = PrefixCache(pool)
    v0 = cache.version
    assert len(cache) == 0 and v0 == (0, 0)
    _finish(pool, cache, 0, list(range(9)))                 # 2 pages
    v1 = cache.version
    assert len(cache) == 2 and v1 != v0
    _finish(pool, cache, 1, list(range(9)))                 # duplicate
    assert cache.version == v1                              # no change
    digest = cache.digest()
    # evict the leaf, then restore it from "host" bytes into a new page
    leaf = max(cache._index.values(), key=lambda e: e.depth)
    parent, tokens, depth = leaf.parent, leaf.tokens, leaf.depth
    assert cache.evict(1) == 1 and len(cache) == 1
    assert cache.version != v1
    (page,) = pool.alloc(1)
    e = cache.restore(parent, tokens, page, depth)
    assert e.refs == 0 and e.page == page and len(cache) == 2
    assert pool.refcount(page) == 1                 # cached, no sharer
    assert cache.digest() == digest                 # same content keys
    assert len(cache.match(list(range(9)))) == 2
    pool.check_invariants()
    cache.check_invariants()
    (other,) = pool.alloc(1)
    with pytest.raises(ValueError, match="already-cached"):
        cache.restore(parent, tokens, other, depth)
    pool.free([other])
    # clear evicts the evictable; an attached prefix survives it
    holder = Request(req_id=9, prompt=list(range(9)), max_new_tokens=1)
    assert len(cache.acquire(holder)) == 2
    cache.clear()
    assert len(cache) == 2
    cache.release(holder)
    cache.clear()
    assert len(cache) == 0 and pool.cached_pages == 0
    assert pool.free_pages == pool.num_usable
    pool.check_invariants()
    cache.check_invariants()


# ---------------------------------------------------------------------------
# the pool's refcount, reset and set_pages
# ---------------------------------------------------------------------------

def test_pool_refcount_reset_and_set_pages():
    pool = _pool(num_pages=6)
    a, _ = pool.alloc(2)
    assert pool.refcount(a) == 1 and pool.refcount(pool._free[-1]) == 0
    pool.cache_page(a)
    pool.share_page(a)
    pool.share_page(a)
    assert pool.refcount(a) == 3 and pool.refcount(TRASH_PAGE) == 0
    k0 = pool.k_pages[0]
    k0.fill_(1.0)
    pool.reset(clear_pages=True)
    assert pool.k_pages[0] is k0 and not k0.any()   # zeroed in place
    assert pool.cached_pages == 0 and pool.free_pages == pool.num_usable
    got = pool.alloc(pool.num_usable)
    assert TRASH_PAGE not in got and sorted(got) == list(range(1, 6))
    pool.check_invariants()
    pool.reset()
    new_k = tuple(torch.ones_like(p) for p in pool.k_pages)
    new_v = tuple(torch.ones_like(p) for p in pool.v_pages)
    pool.set_pages(new_k, new_v)
    # copied into the pool's own tensors, which a captured step is bound to
    assert pool.k_pages[0] is k0 and all(
        torch.equal(h, g) for h, g in zip(pool.k_pages + pool.v_pages,
                                          new_k + new_v))
    with pytest.raises(ValueError, match="set_pages"):
        pool.set_pages(new_k[:-1], new_v)
    with pytest.raises(ValueError, match="set_pages"):
        pool.set_pages(tuple(p.double() for p in new_k), new_v)


def test_fuzz_alloc_free_share_evict_invariants_hold():
    """Randomized alloc/free/finish/acquire/release/evict over the pool
    and the cache: the invariants hold after every operation, and at
    the end every reference is released and ``clear`` empties the
    cache."""
    rng = np.random.RandomState(7)
    pool = _pool(num_pages=17, page_size=4)
    cache = PrefixCache(pool)
    pool.set_reclaim(cache.evict)
    live, holders, next_rid = {}, {}, 0
    for _ in range(400):
        op = rng.randint(5)
        if op == 0:                            # start a request
            toks = [int(t) for t in rng.randint(0, 6,
                                                size=rng.randint(1, 14))]
            req = Request(req_id=next_rid, prompt=toks, max_new_tokens=1)
            next_rid += 1
            entries = cache.acquire(req)
            if entries:
                req.pages = [e.page for e in entries]
                req.shared_pages = len(entries)
                req.pos = len(entries) * pool.page_size
            got = pool.alloc(pool.pages_for(len(toks)) - len(req.pages))
            if got is None:                    # roll back, as _start does
                cache.release(req)
            else:
                req.pages = req.pages + got
                live[req.req_id] = req
        elif op == 1 and live:                 # finish into the cache
            req = live.pop(list(live)[rng.randint(len(live))])
            req.pos = int(rng.randint(req.pos,
                                      len(req.pages) * pool.page_size + 1))
            cache.on_finish(req)
        elif op == 2 and live:                 # preempt
            req = live.pop(list(live)[rng.randint(len(live))])
            pool.free(req.pages[req.shared_pages:])
            cache.release(req)
        elif op == 3:                          # a reader acquires
            toks = [int(t) for t in rng.randint(0, 6,
                                                size=rng.randint(1, 14))]
            req = Request(req_id=next_rid, prompt=toks, max_new_tokens=1)
            next_rid += 1
            if cache.acquire(req):
                holders[req.req_id] = req
        elif op == 4:
            if holders and rng.randint(2):     # a reader leaves
                cache.release(holders.pop(
                    list(holders)[rng.randint(len(holders))]))
            else:
                cache.evict(int(rng.randint(1, 4)))
        pool.check_invariants()
        cache.check_invariants()
    for req in live.values():
        pool.free(req.pages[req.shared_pages:])
        cache.release(req)
    for req in holders.values():
        cache.release(req)
    assert cache.evictable_pages == len(cache)
    cache.clear()
    assert len(cache) == 0 and pool.cached_pages == 0
    assert pool.free_pages == pool.num_usable
    pool.check_invariants()
    cache.check_invariants()
